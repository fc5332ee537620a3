"""Closed-shell spatial-orbital RCCSD tests.

Three-layer verification of the production CCSD kernel:
1. the spin-summed einsum update reproduces the spin-orbital SGWB update
   (``solvers/ccsd.py:_ccsd_update``) exactly on random amplitudes,
2. the fused-matrix layout (``solvers/rccsd_mat.py``) reproduces the
   einsum form exactly,
3. the converged solver matches the spin-orbital kernel and FCI on small
   molecules (reference parity target: pyscf.cc.CCSD, used by
   molbe/solver.py:829 solve_ccsd).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from quemb_tpu.chem.mole import Mole
from quemb_tpu.chem.scf import RHF
from quemb_tpu.solvers.ccsd import _ccsd_update, solve_ccsd_so
from quemb_tpu.solvers.rccsd import rccsd_update, solve_rccsd
from quemb_tpu.solvers.rccsd_mat import (
    rccsd_fused_blocks,
    rccsd_update_mat,
)


def _random_system(seed, nmo, no, naux=11):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((nmo, nmo, naux))
    L = L + L.transpose(1, 0, 2)
    eri_chem = np.einsum("pqx,rsx->pqrs", L, L)
    moe = np.sort(rng.standard_normal(nmo)) * 2.0
    moe[no:] += 4.0
    nv = nmo - no
    t1 = 0.1 * rng.standard_normal((no, nv))
    t2 = 0.1 * rng.standard_normal((no, no, nv, nv))
    t2 = t2 + t2.transpose(1, 0, 3, 2)
    return eri_chem, moe, t1, t2


def _so_embed(eri_chem, moe, t1, t2, no):
    """Embed spatial amplitudes/integrals into the spin-orbital layout
    used by ``_ccsd_update`` ([a-occ, b-occ | a-vir, b-vir])."""
    nmo = eri_chem.shape[0]
    nv = nmo - no
    g = eri_chem.transpose(0, 2, 1, 3)
    spin = np.array([0] * no + [1] * no + [0] * nv + [1] * nv)
    sp = np.array(
        list(range(no)) * 2 + list(range(no, nmo)) * 2
    )
    d = (spin[:, None] == spin[None, :]).astype(float)
    gf = g[np.ix_(sp, sp, sp, sp)]
    g_so = (
        gf * d[:, None, :, None] * d[None, :, None, :]
        - gf.transpose(0, 1, 3, 2)
        * d[:, None, None, :] * d[None, :, :, None]
    )
    no2, n2 = 2 * no, 2 * nmo
    o, v = slice(0, no2), slice(no2, n2)
    blocks = [
        g_so[o, o, v, v], g_so[o, v, v, v], g_so[o, o, o, v],
        g_so[o, o, o, o], g_so[v, v, v, v], g_so[o, v, o, v],
        g_so[o, v, v, o], g_so[o, v, o, o], g_so[v, v, v, o],
    ]
    osp, ospin = sp[:no2], spin[:no2]
    vsp, vspin = sp[no2:] - no, spin[no2:]
    t1_so = np.where(
        ospin[:, None] == vspin[None, :], t1[np.ix_(osp, vsp)], 0.0
    )
    dIA = (ospin[:, None, None, None] == vspin[None, None, :, None])
    dJB = (ospin[None, :, None, None] == vspin[None, None, None, :])
    dIB = (ospin[:, None, None, None] == vspin[None, None, None, :])
    dJA = (ospin[None, :, None, None] == vspin[None, None, :, None])
    T = t2[np.ix_(osp, osp, vsp, vsp)]
    t2_so = T * (dIA & dJB) - T.transpose(0, 1, 3, 2) * (dIB & dJA)
    moe_o = np.concatenate([moe[:no], moe[:no]])
    moe_v = np.concatenate([moe[no:], moe[no:]])
    return blocks, t1_so, t2_so, moe_o, moe_v


def test_rccsd_update_matches_spin_orbital_oracle():
    no, nmo = 3, 7
    nv = nmo - no
    eri_chem, moe, t1, t2 = _random_system(7, nmo, no)
    g = eri_chem.transpose(0, 2, 1, 3)

    blocks, t1_so, t2_so, moe_o, moe_v = _so_embed(
        eri_chem, moe, t1, t2, no
    )
    t1n_so, t2n_so, e_so = _ccsd_update(
        jnp.asarray(t1_so), jnp.asarray(t2_so), jnp.asarray(moe_o),
        jnp.asarray(moe_v), *[jnp.asarray(b) for b in blocks],
    )
    t1n, t2n, e_sp = rccsd_update(
        jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(moe[:no]),
        jnp.asarray(moe[no:]), jnp.asarray(g), no,
    )
    # alpha block of T1, mixed-spin block of T2
    assert np.abs(np.asarray(t1n) - np.asarray(t1n_so)[:no, :nv]).max() \
        < 1e-11
    assert np.abs(
        np.asarray(t2n) - np.asarray(t2n_so)[:no, no:, :nv, nv:]
    ).max() < 1e-11
    assert abs(float(e_so) - float(e_sp)) < 1e-11


def test_rccsd_mat_matches_einsum():
    no, nmo = 4, 9
    nv = nmo - no
    eri_chem, moe, t1, t2 = _random_system(11, nmo, no, naux=13)
    g = eri_chem.transpose(0, 2, 1, 3)
    t1r, t2r, er = rccsd_update(
        jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(moe[:no]),
        jnp.asarray(moe[no:]), jnp.asarray(g), no,
    )
    fb = rccsd_fused_blocks(jnp.asarray(eri_chem), no)
    t1m, T2m, em = rccsd_update_mat(
        jnp.asarray(t1), jnp.asarray(t2).reshape(no * no, nv * nv),
        jnp.asarray(moe[:no]), jnp.asarray(moe[no:]), fb,
    )
    assert np.abs(np.asarray(t1r) - np.asarray(t1m)).max() < 1e-11
    assert np.abs(
        np.asarray(t2r) - np.asarray(T2m).reshape(no, no, nv, nv)
    ).max() < 1e-11
    assert abs(float(er) - float(em)) < 1e-11


@pytest.fixture(scope="module")
def h4():
    mol = Mole(atom="H 0 0 0; H 0 0 1; H 0 0 2; H 0 0 3", basis="sto-3g")
    mf = RHF(mol)
    mf.kernel()
    C = mf.mo_coeff
    eri = np.einsum("pqrs,pi,qj,rk,sl->ijkl", mf.get_eri(), C, C, C, C)
    return mf, eri


def test_rccsd_converged_matches_spin_orbital(h4):
    mf, eri = h4
    t1_r, t2_r, e_r = solve_rccsd(eri, mf.mo_energy, 2)
    t1_s, t2_s, e_s = solve_ccsd_so(eri, mf.mo_energy, 2)
    assert abs(e_r - e_s) < 1e-8
    assert np.abs(t1_r - t1_s).max() < 1e-6
    assert np.abs(t2_r - t2_s).max() < 1e-6
