"""Relaxed (lambda / linear-response) CCSD density matrices via adjoint
implicit differentiation.

Replacement for the reference's ``relax_density=True`` path
(molbe/solver.py:829 solve_ccsd -> pyscf ``mc.make_rdm1/make_rdm2`` with
Lambda amplitudes).  Instead of hand-deriving the Lambda equations, the
response densities are obtained by automatic differentiation from the
defining property:

    gamma1 = dE_elec / dh,     gamma2 = 2 dE_elec / d(eri)

with the amplitudes an implicit function of (h, eri) through the CCSD
fixed point t = U(t; h, eri).  The adjoint (Lambda) system
w = (dE/dt) + (dU/dt)^T w is solved by the transpose fixed-point
iteration using jax.vjp of the same fused-matrix update that drives the
forward solve -- the Lambda equations are exactly this transpose
iteration.  The resulting RDMs satisfy the Gauss-Stanton energy trace
identity  E_elec = tr(h g1) + 0.5 eri : g2  to convergence tolerance
(tested), which is the property the BE fragment energies consume.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from quemb_tpu.solvers.ccsd import so_blocks_jax
from quemb_tpu.solvers.ccsd_mat import BLOCK_KEYS, ccsd_update_mat


def _fock_mo(h_mo, eri_mo, nsocc):
    """MO-basis Fock with the frozen HF density (2 on occupied diag)."""
    occ = jnp.concatenate(
        [2.0 * jnp.ones(nsocc), jnp.zeros(h_mo.shape[0] - nsocc)]
    )
    vj = jnp.einsum("pqrr,r->pq", eri_mo, occ)
    vk = jnp.einsum("prrq,r->pq", eri_mo, occ)
    return h_mo + vj - 0.5 * vk


def _hbar_pieces(h_mo, eri_mo, nsocc):
    """Fused blocks + Fock splittings as functions of (h, eri)."""
    fock = _fock_mo(h_mo, eri_mo, nsocc)
    fb_t, moe_o, moe_v = so_blocks_jax(eri_mo, jnp.diag(fock), nsocc)
    nmo = h_mo.shape[0]
    no = 2 * nsocc
    # spin-orbital off-diagonal Fock blocks (spin-major layout)
    f_so = jnp.kron(jnp.eye(2), fock)
    order = (
        list(range(nsocc)) + list(range(nmo, nmo + nsocc))
        + list(range(nsocc, nmo)) + list(range(nmo + nsocc, 2 * nmo))
    )
    f_so = f_so[jnp.ix_(jnp.array(order), jnp.array(order))]
    f_oo = f_so[:no, :no]
    f_vv = f_so[no:, no:]
    f_ov = f_so[:no, no:]
    f_oo_off = f_oo - jnp.diag(jnp.diag(f_oo))
    f_vv_off = f_vv - jnp.diag(jnp.diag(f_vv))
    return dict(zip(BLOCK_KEYS, fb_t)), moe_o, moe_v, f_oo_off, f_ov, \
        f_vv_off


def _update(t1, T2p, x, nsocc):
    h_mo, eri_mo = x
    fb, moe_o, moe_v, f_oo_off, f_ov, f_vv_off = _hbar_pieces(
        h_mo, eri_mo, nsocc
    )
    t1n, T2n, _ = ccsd_update_mat(
        t1, T2p, moe_o, moe_v, fb,
        f_oo_off=f_oo_off, f_ov=f_ov, f_vv_off=f_vv_off,
    )
    return t1n, T2n


def _e_elec(t1, T2p, x, nsocc):
    h_mo, eri_mo = x
    nmo = h_mo.shape[0]
    occ = jnp.concatenate([jnp.ones(nsocc), jnp.zeros(nmo - nsocc)])
    dm = 2.0 * jnp.diag(occ)
    e_hf = jnp.einsum("pq,qp->", h_mo, dm) + 0.5 * (
        jnp.einsum("pqrs,pq,rs->", eri_mo, dm, dm)
        - 0.5 * jnp.einsum("pqrs,ps,qr->", eri_mo, dm, dm)
    )
    fb, moe_o, moe_v, f_oo_off, f_ov, _ = _hbar_pieces(h_mo, eri_mo, nsocc)
    no, nv = t1.shape
    Kk = jnp.kron(t1, t1)
    Kswap = Kk.reshape(no, no, nv, nv).transpose(0, 1, 3, 2).reshape(
        no * no, nv * nv
    )
    tau = T2p + Kk - Kswap
    e_corr = 0.25 * jnp.sum(fb["Vp"] * tau) + jnp.sum(f_ov * t1)
    return e_hf + e_corr


@partial(jax.jit, static_argnames=("nsocc", "max_cycle"))
def _relaxed_rdm_grads(h_mo, eri_mo, nsocc, max_cycle=150):
    x = (h_mo, eri_mo)
    fb, moe_o, moe_v, f_oo_off, f_ov, f_vv_off = _hbar_pieces(
        h_mo, eri_mo, nsocc
    )
    from quemb_tpu.solvers.ccsd import _diis_stage

    no = moe_o.shape[0]
    nv = moe_v.shape[0]
    Doovv = (
        (moe_o[:, None] + moe_o[None, :]).reshape(-1)[:, None]
        - (moe_v[:, None] + moe_v[None, :]).reshape(-1)[None, :]
    )
    t1, T2p, it, delta = _diis_stage(
        fb, moe_o, moe_v,
        jnp.zeros((no, nv)), fb["Vp"] / Doovv, 1e-10, max_cycle,
        f_blocks=(f_oo_off, f_ov, f_vv_off),
    )
    t1 = jax.lax.stop_gradient(t1)
    T2p = jax.lax.stop_gradient(T2p)

    # adjoint (Lambda) fixed point: w = dE/dt + (dU/dt)^T w
    e_t = jax.grad(lambda tt: _e_elec(tt[0], tt[1], x, nsocc))((t1, T2p))
    _, u_vjp = jax.vjp(lambda tt: _update(tt[0], tt[1], x, nsocc),
                       (t1, T2p))

    def body(s):
        (w1, w2), it_, _ = s
        (d1, d2), = u_vjp((w1, w2))
        w1n = e_t[0] + d1
        w2n = e_t[1] + d2
        dl = jnp.sqrt(
            jnp.sum((w1n - w1) ** 2) + jnp.sum((w2n - w2) ** 2)
        )
        return (w1n, w2n), it_ + 1, dl

    def cond(s):
        return (s[2] > 1e-9) & (s[1] < max_cycle)

    (w1, w2), _, _ = jax.lax.while_loop(
        cond, body, (e_t, 0, jnp.asarray(jnp.inf))
    )

    # total derivative dE/dx = E_x + w^T U_x
    e_x = jax.grad(lambda xx: _e_elec(t1, T2p, xx, nsocc))(x)
    _, ux_vjp = jax.vjp(lambda xx: _update(t1, T2p, xx, nsocc), x)
    (gx_h, gx_eri), = ux_vjp((w1, w2))
    g_h = e_x[0] + gx_h
    g_eri = e_x[1] + gx_eri
    e_val = _e_elec(t1, T2p, x, nsocc)
    return g_h, g_eri, e_val


def ccsd_relaxed_rdms(h_mo, eri_mo, nsocc: int):
    """Relaxed CCSD 1-/2-RDMs in the MO basis (pyscf conventions:
    E_elec = tr(h g1) + 0.5 sum (pq|rs) g2[p,q,r,s])."""
    g_h, g_eri, e_val = _relaxed_rdm_grads(
        jnp.asarray(h_mo), jnp.asarray(eri_mo), nsocc
    )
    rdm1 = np.asarray(g_h)
    rdm1 = 0.5 * (rdm1 + rdm1.T)
    rdm2 = 2.0 * np.asarray(g_eri)
    # restore the full 8-fold symmetry the gradient spreads arbitrarily
    rdm2 = 0.5 * (rdm2 + rdm2.transpose(1, 0, 3, 2))
    rdm2 = 0.5 * (rdm2 + rdm2.transpose(2, 3, 0, 1))
    return rdm1, rdm2, float(e_val)
