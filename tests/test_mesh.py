"""Multi-chip fragment sharding: sharded == unsharded on a virtual mesh.

The conftest pins the suite to 8 virtual CPU devices, so the fragment
mesh of parallel/mesh.py runs genuinely SPMD here (the same path the
driver's dryrun exercises)."""

import numpy as np

import jax

from quemb_tpu import BE, fragmentate
from quemb_tpu.chem.mole import Mole
from quemb_tpu.chem.scf import RHF
from quemb_tpu.parallel.mesh import make_fragment_mesh, set_mesh


def test_sharded_matches_unsharded():
    assert len(jax.devices()) >= 2, "conftest should provide 8 CPU devices"
    mol = Mole(
        atom="; ".join(f"H 0 0 {i * 1.0}" for i in range(8)),
        basis="sto-3g",
    )
    mf = RHF(mol, conv_tol=1e-12)
    mf.kernel()
    fobj = fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                       print_frags=False)

    be0 = BE(mf, fobj)
    be0.oneshot(solver="CCSD")
    e_unsharded = be0.ebe_tot

    set_mesh(make_fragment_mesh(jax.devices()))
    try:
        be1 = BE(mf, fobj)
        be1.oneshot(solver="CCSD")
        e_sharded = be1.ebe_tot
    finally:
        set_mesh(None)
    assert np.isclose(e_sharded, e_unsharded, atol=1e-10)


def test_sharded_matching_loop():
    """The full QN matching loop under the fragment mesh."""
    mol = Mole(
        atom="; ".join(f"H 0 0 {i * 1.0}" for i in range(8)),
        basis="sto-3g",
    )
    mf = RHF(mol, conv_tol=1e-12)
    mf.kernel()
    fobj = fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                       print_frags=False)
    be0 = BE(mf, fobj)
    be0.optimize(solver="MP2")
    e0 = be0.ebe_tot
    set_mesh(make_fragment_mesh(jax.devices()))
    try:
        be1 = BE(mf, fobj)
        be1.optimize(solver="MP2")
        e1 = be1.ebe_tot
    finally:
        set_mesh(None)
    assert np.isclose(e1, e0, atol=1e-8)


def test_same_fragments_with_and_without_mesh(monkeypatch):
    """One objective evaluation of the SAME fragments on one device and
    then over the mesh (the four-card smoke phase): the device operand
    cache is keyed by the mesh, so the mesh run really is sharded, and
    device-resident fragment ERIs are resharded without a host copy."""
    from quemb_tpu.solvers import dispatch
    from quemb_tpu.solvers.dispatch import be_func

    monkeypatch.setenv("QUEMB_TPU_INCORE_CD", "1")  # device-resident ERIs
    mol = Mole(
        atom="; ".join(f"H 0 0 {i * 1.0}" for i in range(8)),
        basis="sto-3g",
    )
    mf = RHF(mol, conv_tol=1e-12)
    mf.kernel()
    fobj = fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                       print_frags=False)
    be = BE(mf, fobj)
    assert all(isinstance(fr.eri, jax.Array) for fr in be.fragments)
    pot = 1e-3 * np.random.default_rng(0).standard_normal(len(be.pot))

    def run():
        _, ervec, (ecorr, _) = be_func(
            pot, be.fragments, be.Nocc, "CCSD", eeval=True, return_vec=True
        )
        return ecorr, np.asarray(ervec)

    e1, v1 = run()
    mesh = make_fragment_mesh(jax.devices()[:4])
    set_mesh(mesh)
    try:
        e4, v4 = run()
    finally:
        set_mesh(None)
    spread = {
        len(v.sharding.device_set)
        for key, entry in dispatch._BUCKET_DEV_CACHE.items()
        if key[-1] is mesh
        for k, v in entry.items() if k != "eri_ref"
    }
    assert spread == {4}
    assert abs(e4 - e1) < 1e-10
    assert np.abs(v4 - v1).max() < 1e-10
