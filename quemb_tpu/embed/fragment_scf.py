"""Batched fragment SCF: dense RHF in an orthonormal embedding basis.

Replaces the reference's fake-``Mole`` PySCF RHF per fragment
(``molbe/helper.py:get_scfObj``).  The Schmidt basis is orthonormal, so the
Roothaan step is a plain ``eigh``; DIIS runs with fixed-size buffers inside a
``lax.while_loop`` so the whole SCF jits and vmaps across a bucket of
same-shaped fragments (this is the device replacement for the per-fragment
process pool of ``molbe/be_parallel.py``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from quemb_tpu.ops.linalg import eigh as _eigh

DIIS_SPACE = 8

#: detection threshold for bucket-merge pad sentinels on the Fock diagonal
#: (solvers.dispatch._PAD_SHIFT = 1e6; physical Fock diagonals are O(10) Ha)
_PAD_DETECT = 5.0e5


def _eigh_deflated(F):
    """eigh of a Fock matrix that may carry bucket-merge pad sentinels.

    Merged-bucket padding (solvers.dispatch._PAD_SHIFT) puts exactly
    decoupled rows with diagonal +-1e6 on the Fock.  A backend eigh of
    ~1e-7 RELATIVE accuracy (see ops/linalg.py) would let those sentinels inflate ``||F||`` by
    ~1e5x and turn the physical block's eigenvectors to mush (~0.1
    absolute error that the Jacobi refinement's gap-suppression then
    refuses to rotate away).  Because the pad rows are exactly decoupled,
    replacing their diagonal by values just outside the physical
    spectrum's Gershgorin bounds yields the SAME eigenvectors and the
    same sort order (occupied pads below every physical orbital, virtual
    pads above) while keeping ``||F||`` at the physical scale.  With no
    pads present this is exactly ``eigh(F)``.
    """
    d = jnp.diagonal(F)
    occpad = d <= -_PAD_DETECT
    virpad = d >= _PAD_DETECT
    pad = occpad | virpad
    off = jnp.sum(jnp.abs(F), axis=-1) - jnp.abs(d)
    lo = jnp.min(jnp.where(pad, jnp.inf, d - off))
    hi = jnp.max(jnp.where(pad, -jnp.inf, d + off))
    deff = jnp.where(occpad, lo - 1.0, jnp.where(virpad, hi + 1.0, d))
    return _eigh(F + jnp.diag(deff - d))


def _fock(h, eri, dm):
    vj = jnp.einsum("pqrs,rs->pq", eri, dm)
    vk = jnp.einsum("prqs,rs->pq", eri, dm)
    return h + vj - 0.5 * vk


def _diis_solve(err_flat, fock_flat, nvalid):
    """DIIS extrapolation with a fixed-size buffer and validity masking."""
    m = err_flat.shape[0]
    valid = jnp.arange(m) < nvalid
    B = err_flat @ err_flat.T  # [m, m]
    # invalid slots: identity row/col -> coefficient forced to 0
    B = jnp.where(valid[:, None] & valid[None, :], B, 0.0)
    B = B + jnp.where(
        ~valid, 1.0, 0.0
    ) * jnp.eye(m) + 1e-14 * jnp.eye(m)
    Bfull = jnp.zeros((m + 1, m + 1))
    Bfull = Bfull.at[:m, :m].set(B)
    Bfull = Bfull.at[m, :m].set(jnp.where(valid, -1.0, 0.0))
    Bfull = Bfull.at[:m, m].set(jnp.where(valid, -1.0, 0.0))
    rhs = jnp.zeros(m + 1).at[m].set(-1.0)
    # solve via eigendecomposition: Bfull is symmetric, and this keeps
    # the loop body free of LU custom calls
    w, V = _eigh(Bfull)
    w_safe = jnp.where(jnp.abs(w) < 1e-14, jnp.inf, w)
    c = (V @ ((V.T @ rhs) / w_safe))[:m]
    return jnp.einsum("i,ix->x", c, fock_flat)


@partial(jax.jit, static_argnames=("nocc", "max_cycle"))
def rhf_orthonormal(
    h, eri, nocc: int, dm0, tol: float = 1e-12, max_cycle: int = 100
):
    """RHF with S = identity. Returns (mo_energy, mo_coeff, e_el, n_iter).

    All arguments may carry leading batch dimensions via ``jax.vmap``.
    """
    n = h.shape[-1]

    def energy(dm, F):
        return 0.5 * jnp.sum((h + F) * dm)

    def cond(state):
        dm, _, _, it, delta = state
        return (delta > tol) & (it < max_cycle)

    def body(state):
        dm, err_buf, fock_buf, it, _ = state
        F = _fock(h, eri, dm)
        err = (F @ dm - dm @ F).reshape(-1)
        slot = it % DIIS_SPACE
        err_buf = err_buf.at[slot].set(err)
        fock_buf = fock_buf.at[slot].set(F.reshape(-1))
        nvalid = jnp.minimum(it + 1, DIIS_SPACE)
        F_x = lax.cond(
            it > 0,
            lambda: _diis_solve(err_buf, fock_buf, nvalid).reshape(n, n),
            lambda: F,
        )
        e, C = _eigh_deflated(F_x)
        dm_new = 2.0 * C[:, :nocc] @ C[:, :nocc].T
        delta = jnp.max(jnp.abs(dm_new - dm))
        return dm_new, err_buf, fock_buf, it + 1, delta

    err_buf = jnp.zeros((DIIS_SPACE, n * n))
    fock_buf = jnp.zeros((DIIS_SPACE, n * n))
    state = (dm0, err_buf, fock_buf, 0, jnp.inf)
    dm, _, _, it, _ = lax.while_loop(cond, body, state)
    F = _fock(h, eri, dm)
    e, C = _eigh_deflated(F)
    e_el = energy(dm, F)
    return e, C, e_el, it


def rhf_orthonormal_batched(h_b, eri_b, nocc: int, dm0_b):
    """vmapped fragment SCF over a bucket of same-shaped fragments."""
    return jax.vmap(
        lambda h, eri, dm0: rhf_orthonormal(h, eri, nocc, dm0)
    )(h_b, eri_b, dm0_b)
