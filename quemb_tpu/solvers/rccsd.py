"""Closed-shell spatial-orbital (restricted) CCSD.

Spin-summed form of the SGWB spin-orbital equations in ``solvers/ccsd.py``
(Stanton, Gauss, Watts, Bartlett, JCP 94, 4334 (1991)), derived for the
closed-shell case so every contraction runs over spatial dimensions
(no = nsocc, nv = nmo - nsocc) instead of the 2x larger spin-orbital ones
-- an ~8-16x FLOP/memory saving on the dominant terms.  This replaces the
reference's use of the (closed-shell, spatial) PySCF CCSD kernel
(molbe/solver.py:829 solve_ccsd), matching its amplitude conventions:
t2[i,j,a,b] is the alpha-beta mixed-spin block, i.e. exactly the PySCF
spatial t2 consumed by shared/external/ccsd_rdm.py.

Integrals enter in physicist notation over spatial MOs,
g[p,q,r,s] = <pq|rs> (= chemist (pr|qs)); the driver converts from the
chemist eri_mo produced by the MO transform.

This module holds the plain-einsum form; :mod:`solvers.rccsd_mat` carries
the fused-matrix layout that the production path uses (2-D GEMM operands
instead of 4-D einsums with small trailing dimensions).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from quemb_tpu.solvers.ccsd import _f32_only, _use_mixed

_PH = _HIGHEST = jax.lax.Precision.HIGHEST


def _es(expr, *ops):
    return jnp.einsum(expr, *ops, precision=_PH)


def rccsd_update(t1, t2, moe_o, moe_v, g, no: int):
    """One closed-shell CCSD amplitude update (canonical orbitals).

    t1: [no, nv]; t2: [no, no, nv, nv] (mixed-spin / PySCF convention,
    t2[i,j,a,b] = t2[j,i,b,a]); g: full [nmo]^4 physicist <pq|rs>.
    Returns (t1new, t2new, e_corr) with the new amplitudes already divided
    by the canonical denominators.
    """
    o = slice(0, no)
    v = slice(no, None)
    goovv = g[o, o, v, v]
    govvv = g[o, v, v, v]
    gooov = g[o, o, o, v]
    goooo = g[o, o, o, o]
    gvvvv = g[v, v, v, v]
    govov = g[o, v, o, v]
    govvo = g[o, v, v, o]
    # <mn|ej> = <nm|je>
    goovo = jnp.transpose(gooov, (1, 0, 3, 2))

    # 2<mn|ef> - <mn|fe>
    gt = 2.0 * goovv - jnp.transpose(goovv, (0, 1, 3, 2))

    t1t1 = _es("ia,jb->ijab", t1, t1)
    tau_h = t2 + 0.5 * t1t1
    tau = t2 + t1t1
    tA = t2 - jnp.transpose(t2, (0, 1, 3, 2))  # same-spin combination

    # ---- F intermediates (spin-summed SGWB F; canonical -> no fock terms)
    Fvv = (
        2.0 * _es("mf,mafe->ae", t1, govvv)
        - _es("mf,maef->ae", t1, govvv)
        - _es("mnaf,mnef->ae", tau_h, gt)
    )
    Foo = (
        2.0 * _es("ne,mnie->mi", t1, gooov)
        - _es("ne,nmie->mi", t1, gooov)
        + _es("inef,mnef->mi", tau_h, gt)
    )
    Fov = _es("nf,mnef->me", t1, gt)

    # ---- T1
    t1new = (
        _es("ie,ae->ia", t1, Fvv)
        - _es("ma,mi->ia", t1, Foo)
        + _es("imae,me->ia", 2.0 * t2 - jnp.transpose(t2, (0, 1, 3, 2)),
              Fov)
        - _es("nf,naif->ia", t1, govov)
        + 2.0 * _es("nf,nafi->ia", t1, govvo)
        + 2.0 * _es("imef,mafe->ia", t2, govvv)
        - _es("imef,maef->ia", t2, govvv)
        + _es("mnae,nmie->ia", t2, gooov)
        - 2.0 * _es("mnae,mnie->ia", t2, gooov)
    )

    # ---- W intermediates (mixed-spin blocks of the SGWB W's)
    Woooo = (
        goooo
        + _es("je,mnie->mnij", t1, gooov)
        + _es("ie,mnej->mnij", t1, goovo)
        + 0.5 * _es("ijef,mnef->mnij", tau, goovv)
    )
    Wvvvv = (
        gvvvv
        - _es("mb,mafe->abef", t1, govvv)
        - _es("ma,mbef->abef", t1, govvv)
        + 0.5 * _es("mnab,mnef->abef", tau, goovv)
    )
    # W1[m,b,e,j]: <m_a b_b||e_a j_b> ring (alpha-beta "direct")
    W1 = (
        govvo
        + _es("jf,mbef->mbej", t1, govvv)
        - _es("nb,mnej->mbej", t1, goovo)
        - _es("jf,nb,mnef->mbej", t1, t1, goovv)
        - 0.5 * _es("jnfb,mnef->mbej", t2, goovv)
        + _es("jnbf,mnef->mbej", t2, goovv)
        - 0.5 * _es("jnbf,mnfe->mbej", t2, goovv)
    )
    # W2[m,b,e,j]: same-spin ring block
    W2 = (
        govvo
        - jnp.transpose(govov, (0, 1, 3, 2))
        + _es("jf,mbef->mbej", t1, govvv)
        - _es("jf,mbfe->mbej", t1, govvv)
        + _es("nb,mnje->mbej", t1, gooov)
        - _es("nb,mnej->mbej", t1, goovo)
        - _es("jnfb,mnef->mbej", 0.5 * tA + t1t1,
              goovv - jnp.transpose(goovv, (0, 1, 3, 2)))
        + 0.5 * _es("jnbf,mnef->mbej", t2, goovv)
    )
    # W3[m,b,e,i]: <m_a b_b||e_b i_a> cross ring (alpha-beta "exchange")
    W3 = (
        -jnp.transpose(govov, (0, 1, 3, 2))
        - _es("if,mbfe->mbei", t1, govvv)
        + _es("nb,mnie->mbei", t1, gooov)
        + 0.5 * _es("infb,mnfe->mbei", t2, goovv)
        + _es("if,nb,mnfe->mbei", t1, t1, goovv)
    )

    # ---- T2
    FF = Fvv - 0.5 * _es("mb,me->be", t1, Fov)
    FFo = Foo + 0.5 * _es("je,me->mj", t1, Fov)

    S = _es("ijae,be->ijab", t2, FF)
    S = S - _es("imab,mj->ijab", t2, FFo)
    # rings
    S = S + _es("imae,mbej->ijab", tA, W1)
    S = S + _es("imae,mbej->ijab", t2, W2)
    S = S + _es("mjae,mbei->ijab", t2, W3)
    # -P(t1 t1 <||>) pieces
    S = S - _es("ie,ma,mbej->ijab", t1, t1, govvo)
    S = S - _es("je,ma,mbie->ijab", t1, t1, govov)
    # one-particle dressed integrals: <ab|ej> = g[j,e,b,a]; <mb|ij> = g[i,j,m,b]
    S = S + _es("ie,jeba->ijab", t1, govvv)
    S = S - _es("ma,ijmb->ijab", t1, gooov)

    t2new = (
        goovv
        + S
        + jnp.transpose(S, (1, 0, 3, 2))
        + _es("mnab,mnij->ijab", tau, Woooo)
        + _es("ijef,abef->ijab", tau, Wvvvv)
    )

    # denominators (canonical)
    Dov = moe_o[:, None] - moe_v[None, :]
    Doovv = (
        moe_o[:, None, None, None]
        + moe_o[None, :, None, None]
        - moe_v[None, None, :, None]
        - moe_v[None, None, None, :]
    )
    t1new = t1new / Dov
    t2new = t2new / Doovv

    e_corr = _es("ijab,ijab->", tau, gt)
    return t1new, t2new, e_corr


def rccsd_energy(t1, t2, goovv):
    """Closed-shell correlation energy from amplitudes and <ij|ab>."""
    tau = t2 + _es("ia,jb->ijab", t1, t1)
    gt = 2.0 * goovv - jnp.transpose(goovv, (0, 1, 3, 2))
    return _es("ijab,ijab->", tau, gt)


# ------------------------------------------------------------ DIIS driver
from functools import partial  # noqa: E402


def _rdiis_stage(fb, moe_o, moe_v, t1_0, T2p_0, conv_tol, max_cycle):
    """DIIS-accelerated RCCSD amplitude iteration at the input dtype.

    Same ring-buffer design as :func:`solvers.ccsd._diis_stage` (shift-
    append history, f32 error Gram at HIGHEST precision, unrolled
    bordered solve), driving the
    fused-matrix closed-shell update.  Returns (t1, T2p, n_it, delta).
    """
    from jax import lax

    from quemb_tpu.solvers.ccsd import DIIS_SPACE, _diis_coeffs
    from quemb_tpu.solvers.rccsd_mat import rccsd_update_mat

    dtype = T2p_0.dtype
    no, nv = t1_0.shape
    m = DIIS_SPACE
    state = (
        t1_0,
        T2p_0,
        jnp.zeros((m, no, nv), jnp.float32),
        jnp.zeros((m, no * no, nv * nv), jnp.float32),
        jnp.zeros((m, no, nv), dtype),
        jnp.zeros((m, no * no, nv * nv), dtype),
        0,
        jnp.asarray(jnp.inf, jnp.float64),
    )

    def cond(s):
        return (s[7] > conv_tol) & (s[6] < max_cycle)

    def body(s):
        t1, T2p, err1, err2, amp1, amp2, it, _ = s
        t1n, T2n, _ = rccsd_update_mat(t1, T2p, moe_o, moe_v, fb)
        e1 = t1n - t1
        e2 = T2n - T2p
        delta = jnp.sqrt(
            jnp.sum(e1.astype(jnp.float64) ** 2)
            + jnp.sum(e2.astype(jnp.float64) ** 2)
        )
        err1 = jnp.concatenate([err1[1:], e1.astype(jnp.float32)[None]])
        err2 = jnp.concatenate([err2[1:], e2.astype(jnp.float32)[None]])
        amp1 = jnp.concatenate([amp1[1:], t1n[None]])
        amp2 = jnp.concatenate([amp2[1:], T2n[None]])
        B = (
            jnp.einsum("mij,nij->mn", err1, err1, precision=_HIGHEST)
            + jnp.einsum("mpq,npq->mn", err2, err2, precision=_HIGHEST)
        ).astype(jnp.float64)
        c = _diis_coeffs(B, jnp.minimum(it + 1, m), newest_last=True)
        t1x = jnp.einsum("m,mij->ij", c.astype(dtype), amp1)
        T2x = jnp.einsum("m,mpq->pq", c.astype(dtype), amp2)
        use = it > 0
        return (
            jnp.where(use, t1x, t1n),
            jnp.where(use, T2x, T2n),
            err1, err2, amp1, amp2, it + 1, delta,
        )

    t1f, T2pf, _, _, _, _, it, delta = lax.while_loop(cond, body, state)
    return t1f, T2pf, it, delta


@partial(jax.jit, static_argnames=("max_cycle", "mixed"))
def _rccsd_iterate(moe_o, moe_v, *fb_arrays, conv_tol=None, max_cycle=150,
                   mixed=False):
    """Jitted closed-shell CCSD iteration; vmappable.

    With ``mixed=True`` a f32 stage runs to ~1e-5 first, then f64 refines
    (the fixed point is dtype-exact, so final amplitudes are full f64).
    Every product runs at HIGHEST precision: an f32 stage means f32, not
    TF32.
    """
    with jax.default_matmul_precision("highest"):
        return _rccsd_iterate_impl(moe_o, moe_v, fb_arrays, conv_tol,
                                   max_cycle, mixed)


def _rccsd_iterate_impl(moe_o, moe_v, fb_arrays, conv_tol, max_cycle,
                        mixed):
    import os as _os

    from quemb_tpu.solvers.ccsd import _default_conv_tol
    from quemb_tpu.solvers.rccsd_mat import RBLOCK_KEYS

    if conv_tol is None:
        conv_tol = _default_conv_tol()
    fb = dict(zip(RBLOCK_KEYS, fb_arrays))
    no = moe_o.shape[0]
    nv = moe_v.shape[0]
    Doovv = (
        (moe_o[:, None] + moe_o[None, :]).reshape(-1)[:, None]
        - (moe_v[:, None] + moe_v[None, :]).reshape(-1)[None, :]
    )
    t1_0 = jnp.zeros((no, nv), dtype=fb["Vp"].dtype)
    Doovv = Doovv.astype(fb["Vp"].dtype)
    T2p_0 = fb["Vp"] / Doovv
    it0 = 0
    if mixed:
        f32_tol = float(_os.environ.get("QUEMB_TPU_CCSD_F32_TOL", "1e-5"))
        f32_max = int(_os.environ.get("QUEMB_TPU_CCSD_F32_MAX", "45"))
        fb32 = {k: v.astype(jnp.float32) for k, v in fb.items()}
        t1_32, T2p_32, it0, _ = _rdiis_stage(
            fb32,
            moe_o.astype(jnp.float32),
            moe_v.astype(jnp.float32),
            t1_0.astype(jnp.float32),
            T2p_0.astype(jnp.float32),
            f32_tol,
            min(f32_max, max_cycle),
        )
        t1_0 = t1_32.astype(jnp.float64)
        T2p_0 = T2p_32.astype(jnp.float64)
    t1f, T2pf, it, delta = _rdiis_stage(
        fb, moe_o, moe_v, t1_0, T2p_0, conv_tol, max_cycle
    )
    return t1f, T2pf.reshape(no, no, nv, nv), it0 + it, delta


@partial(jax.jit, static_argnames=("nsocc", "max_cycle", "mixed",
                                   "f32_only", "conv_tol"))
def _rccsd_from_mo_batched(eri_mo_b, moe_b, nsocc: int,
                           max_cycle: int = 150, mixed: bool = False,
                           f32_only: bool = False,
                           conv_tol: float | None = None):
    """Fused device program: fused-block build + RCCSD iterate, vmapped.

    Block prep is transposes/reshapes only (no gathers), so it fuses into
    one program per bucket.  ``conv_tol`` (static; None reads
    :func:`solvers.ccsd._default_conv_tol` while tracing) is the f64
    amplitude target.  Returns spatial (t1_b, t2_b, it, delta).
    """
    import os as _os

    from quemb_tpu.solvers.rccsd_mat import RBLOCK_KEYS, rccsd_fused_blocks

    def one(eri_mo, moe):
        if f32_only:
            fb = rccsd_fused_blocks(eri_mo.astype(jnp.float32), nsocc)
            f32_tol = float(
                _os.environ.get("QUEMB_TPU_CCSD_F32_TOL", "1e-5")
            )
            t1f, t2f, it, delta = _rccsd_iterate(
                moe[:nsocc].astype(jnp.float32),
                moe[nsocc:].astype(jnp.float32),
                *[fb[k] for k in RBLOCK_KEYS],
                conv_tol=f32_tol, max_cycle=max_cycle, mixed=False,
            )
            return (t1f.astype(jnp.float64), t2f.astype(jnp.float64),
                    it, delta.astype(jnp.float64))
        fb = rccsd_fused_blocks(eri_mo, nsocc)
        return _rccsd_iterate(
            moe[:nsocc], moe[nsocc:], *[fb[k] for k in RBLOCK_KEYS],
            conv_tol=conv_tol, max_cycle=max_cycle, mixed=mixed,
        )

    return jax.vmap(one)(eri_mo_b, moe_b)


def rccsd_batched(eri_mo_b, moe_b, nsocc: int):
    """Batched closed-shell CCSD over a bucket (fragment axis sharded
    over the active mesh).  Returns spatial (t1_b, t2_b, it, delta)."""
    from quemb_tpu.parallel.mesh import shard_batch
    from quemb_tpu.solvers.ccsd import _default_conv_tol

    eri_sh, _ = shard_batch(np.asarray(eri_mo_b))
    moe_sh, _ = shard_batch(np.asarray(moe_b))
    return _rccsd_from_mo_batched(
        eri_sh, moe_sh, nsocc, mixed=_use_mixed(), f32_only=_f32_only(),
        conv_tol=_default_conv_tol(),
    )


def rccsd_large(eri_mo, moe, nsocc: int, max_cycle: int = 150):
    """Single large-fragment closed-shell CCSD (no batch axis).

    Unlike the spin-orbital path there is no host-side block build: the
    fused spatial blocks are ~16x smaller, so the whole program runs
    on-device even for nemb ~ 100.  Returns (t1, t2, n_iter, delta).
    """
    from quemb_tpu.solvers.ccsd import _default_conv_tol

    t1f, t2f, it, delta = _rccsd_from_mo_batched(
        jnp.asarray(eri_mo)[None], jnp.asarray(moe)[None], nsocc,
        max_cycle=max_cycle, mixed=_use_mixed(), f32_only=_f32_only(),
        conv_tol=_default_conv_tol(),
    )
    return (np.asarray(t1f[0], np.float64),
            np.asarray(t2f[0], np.float64), int(it[0]), float(delta[0]))


def solve_rccsd(eri_mo, moe, nsocc: int, conv_tol=1e-9, max_cycle=150):
    """Single-fragment closed-shell CCSD.  Returns (t1, t2, e_corr)."""
    import warnings

    t1f, t2f, it, delta = _rccsd_from_mo_batched(
        jnp.asarray(eri_mo)[None], jnp.asarray(moe)[None], nsocc,
        max_cycle=max_cycle,
    )
    if float(delta[0]) > conv_tol:
        warnings.warn(
            f"RCCSD did not converge: |dt| = {float(delta[0]):.2e}"
        )
    no = nsocc
    t1 = np.asarray(t1f[0])
    t2 = np.asarray(t2f[0])
    ovov = np.asarray(eri_mo)[:no, no:, :no, no:]
    tf = t2 + np.einsum("ia,jb->ijab", t1, t1)
    e_corr = np.einsum("ijab,iajb->", tf, 2.0 * ovov) - np.einsum(
        "ijab,ibja->", tf, ovov
    )
    return t1, t2, float(e_corr)
