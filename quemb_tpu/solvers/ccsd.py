"""CCSD for embedded fragments, with unrelaxed 1/2-RDMs.

From-scratch replacement for the reference's use of ``pyscf.cc.CCSD`` +
``shared/external/ccsd_rdm.py`` (molbe/solver.py:829 solve_ccsd).  The
amplitude equations are the standard spin-orbital CCSD equations (Stanton,
Gauss, Watts, Bartlett, J. Chem. Phys. 94, 4334 (1991)) evaluated as jitted
jax contractions; DIIS acceleration runs with a host-side coefficient solve.

The density matrices follow the reference semantics exactly:
- rdm1: the lambda=0 CCSD 1-RDM (t1-based; ccsd_rdm.py:make_rdm1_ccsd_t1)
- rdm2: the "urlx" unrelaxed 2-RDM from t1/t2 only
  (ccsd_rdm.py:make_rdm2_urlx), with the mean-field part included or not
  depending on use_cumulant.
"""

from __future__ import annotations

import warnings

import numpy as np

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


# --------------------------------------------------- spin-orbital machinery
def _spin_antisym(eri_mo, nmo: int):
    """Antisymmetrized spin-orbital integrals <pq||rs> (physicist notation).

    Spin layout: [0, nmo) alpha, [nmo, 2 nmo) beta.
    """
    phys = jnp.transpose(jnp.asarray(eri_mo), (0, 2, 1, 3))  # <pq|rs>
    n = 2 * nmo
    spin = np.arange(n) // nmo
    sp = np.arange(n) % nmo
    same = jnp.asarray(
        (spin[:, None] == spin[None, :]).astype(np.float64)
    )
    g = (
        phys[jnp.ix_(jnp.asarray(sp), jnp.asarray(sp), jnp.asarray(sp),
                     jnp.asarray(sp))]
        * same[:, None, :, None]
        * same[None, :, None, :]
    )
    return g - jnp.transpose(g, (0, 1, 3, 2))


@jax.jit
def _ccsd_update(t1, t2, moe_o, moe_v, oovv, ovvv, ooov, oooo, vvvv,
                 ovov, ovvo, ovoo, vvvo, f_oo_off=None, f_ov=None,
                 f_vv_off=None):
    """One CCSD amplitude update (SGWB intermediates).

    Integral blocks are antisymmetrized physicist <pq||rs> slices:
    oovv=<mn||ef>, ovvv=<ma||ef>, ooov=<mn||ie>, oooo=<mn||ij>,
    vvvv=<ab||ef>, ovov=<na||if>, ovvo=<mb||ej>, ovoo=<mb||ij>,
    vvvo=<ab||ej>.

    ``f_*`` are the one-particle Fock blocks (off-diagonal parts for oo/vv,
    full ov block); pass None for canonical orbitals (diagonal Fock).
    """
    Dov = moe_o[:, None] - moe_v[None, :]
    Doovv = (
        moe_o[:, None, None, None]
        + moe_o[None, :, None, None]
        - moe_v[None, None, :, None]
        - moe_v[None, None, None, :]
    )

    t1t1 = jnp.einsum("ia,jb->ijab", t1, t1)
    t1t1 = t1t1 - jnp.transpose(t1t1, (0, 1, 3, 2))
    tau_t = t2 + 0.5 * t1t1
    tau = t2 + t1t1

    # F intermediates (SGWB eqs. 3-5; for canonical fragment MOs the
    # one-particle pieces vanish)
    Fae = jnp.einsum("mf,mafe->ae", t1, ovvv) - 0.5 * jnp.einsum(
        "mnaf,mnef->ae", tau_t, oovv
    )
    Fmi = jnp.einsum("ne,mnie->mi", t1, ooov) + 0.5 * jnp.einsum(
        "inef,mnef->mi", tau_t, oovv
    )
    Fme = jnp.einsum("nf,mnef->me", t1, oovv)
    if f_ov is not None:
        Fae = Fae + f_vv_off.T - 0.5 * jnp.einsum("me,ma->ae", f_ov, t1)
        Fmi = Fmi + f_oo_off + 0.5 * jnp.einsum("me,ie->mi", f_ov, t1)
        Fme = Fme + f_ov

    # W intermediates
    Wmnij = (
        oooo
        + jnp.einsum("je,mnie->mnij", t1, ooov)
        - jnp.einsum("ie,mnje->mnij", t1, ooov)
        + 0.25 * jnp.einsum("ijef,mnef->mnij", tau, oovv)
    )
    Wabef = (
        vvvv
        + jnp.einsum("mb,maef->abef", t1, ovvv)
        - jnp.einsum("ma,mbef->abef", t1, ovvv)
        + 0.25 * jnp.einsum("mnab,mnef->abef", tau, oovv)
    )
    # oovo[m,n,e,j] = <mn||ej> = -<mn||je> = -ooov[m,n,j,e]
    Wmbej = (
        ovvo
        + jnp.einsum("jf,mbef->mbej", t1, ovvv)
        + jnp.einsum("nb,mnje->mbej", t1, ooov)
        - jnp.einsum(
            "jnfb,mnef->mbej",
            0.5 * t2 + jnp.einsum("jf,nb->jnfb", t1, t1),
            oovv,
        )
    )

    # T1
    t1new = (
        jnp.einsum("ie,ae->ia", t1, Fae)
        + (f_ov if f_ov is not None else 0.0)
        - jnp.einsum("ma,mi->ia", t1, Fmi)
        + jnp.einsum("imae,me->ia", t2, Fme)
        - jnp.einsum("nf,naif->ia", t1, ovov)
        - 0.5 * jnp.einsum("imef,maef->ia", t2, ovvv)
        + 0.5 * jnp.einsum("mnae,nmie->ia", t2, ooov)
    )

    # T2
    def P_ab(x):
        return x - jnp.transpose(x, (0, 1, 3, 2))

    def P_ij(x):
        return x - jnp.transpose(x, (1, 0, 2, 3))

    t2new = oovv
    t2new = t2new + P_ab(
        jnp.einsum(
            "ijae,be->ijab",
            t2,
            Fae - 0.5 * jnp.einsum("mb,me->be", t1, Fme),
        )
    )
    t2new = t2new - P_ij(
        jnp.einsum(
            "imab,mj->ijab",
            t2,
            Fmi + 0.5 * jnp.einsum("je,me->mj", t1, Fme),
        )
    )
    t2new = t2new + 0.5 * jnp.einsum("mnab,mnij->ijab", tau, Wmnij)
    t2new = t2new + 0.5 * jnp.einsum("ijef,abef->ijab", tau, Wabef)
    tmp = jnp.einsum("imae,mbej->ijab", t2, Wmbej) - jnp.einsum(
        "ie,ma,mbej->ijab", t1, t1, ovvo
    )
    t2new = t2new + P_ij(P_ab(tmp))
    t2new = t2new + P_ij(jnp.einsum("ie,abej->ijab", t1, vvvo))
    t2new = t2new - P_ab(jnp.einsum("ma,mbij->ijab", t1, ovoo))

    t1new = t1new / Dov
    t2new = t2new / Doovv

    e_corr = 0.25 * jnp.einsum("ijab,ijab->", oovv, tau)
    if f_ov is not None:
        e_corr = e_corr + jnp.einsum("ia,ia->", f_ov, t1)
    return t1new, t2new, e_corr


DIIS_SPACE = int(__import__("os").environ.get("QUEMB_TPU_DIIS_SPACE", "6"))


def _solve_small_unrolled(A, b):
    """Fixed-size dense solve: fully unrolled Gauss elimination with
    partial pivoting, pure elementwise jax ops.

    Safe inside lax.while_loop bodies on every backend: no LAPACK-style
    custom call, and no iteratively-refined eigh (a ~10^3-op serial
    chain) in the loop body.
    """
    n = A.shape[0]
    M = jnp.concatenate([A, b[:, None]], axis=1)
    for k in range(n):
        masked = jnp.abs(M[:, k]) * (jnp.arange(n) >= k)
        # On a singular column (all eligible entries 0), argmax returns
        # row 0 and would swap an already-eliminated row above k; pivot
        # on the diagonal instead so the clamp below degrades gracefully.
        p = jnp.where(jnp.max(masked) > 0.0, jnp.argmax(masked), k)
        rowk, rowp = M[k], M[p]
        M = M.at[k].set(rowp).at[p].set(rowk)
        piv = M[k, k]
        piv = jnp.where(jnp.abs(piv) < 1e-300, 1e-300, piv)
        fac = (M[:, k] / piv).at[k].set(0.0)
        M = M - fac[:, None] * M[k][None, :]
    x = jnp.zeros(n)
    for k in range(n - 1, -1, -1):
        piv = M[k, k]
        piv = jnp.where(jnp.abs(piv) < 1e-300, 1e-300, piv)
        x = x.at[k].set((M[k, n] - M[k, k + 1 : n] @ x[k + 1 :]) / piv)
    return x


def _diis_coeffs(B, nvalid, newest_last: bool = False):
    """DIIS coefficients from the error Gram matrix (masked fixed buffer).

    Solves the usual bordered system with the unrolled small solve;
    invalid slots are masked to identity rows and the Gram block is
    scale-normalized for conditioning.  ``newest_last``: valid entries
    occupy the LAST nvalid slots (shift-append ring buffer).
    """
    m = B.shape[0]
    if newest_last:
        valid = jnp.arange(m) >= m - nvalid
    else:
        valid = jnp.arange(m) < nvalid
    B = jnp.where(valid[:, None] & valid[None, :], B, 0.0)
    scale = jnp.maximum(jnp.max(jnp.abs(B)), 1e-280)
    B = B / scale
    B = B + jnp.where(~valid, 1.0, 0.0) * jnp.eye(m) + 1e-14 * jnp.eye(m)
    # scaling B -> B/s leaves the coefficient part of the bordered
    # solution unchanged (only the multiplier rescales)
    Bfull = jnp.zeros((m + 1, m + 1))
    Bfull = Bfull.at[:m, :m].set(B)
    Bfull = Bfull.at[m, :m].set(jnp.where(valid, -1.0, 0.0))
    Bfull = Bfull.at[:m, m].set(jnp.where(valid, -1.0, 0.0))
    rhs = jnp.zeros(m + 1).at[m].set(-1.0)
    return _solve_small_unrolled(Bfull, rhs)[:m]


from functools import partial  # noqa: E402


def _so_blocks_host(eri_mo, moe, nsocc: int):
    """Antisymmetrized spin-orbital integral blocks, built host-side and
    fused into the 2-D matrix layouts of :mod:`solvers.ccsd_mat`.

    Keeping the block construction out of the jitted iteration keeps the XLA
    graph small (an in-graph [2n]^4 gather dominates compile time), and the
    fused 2-D layouts avoid 4-D operands with small trailing dimensions.
    Returns (fused blocks dict, moe_o, moe_v).
    """
    eri_mo = np.asarray(eri_mo)
    moe = np.asarray(moe)
    nmo = eri_mo.shape[0]
    no = 2 * nsocc
    phys = eri_mo.transpose(0, 2, 1, 3)
    n = 2 * nmo
    sp = np.arange(n) % nmo
    spin = np.arange(n) // nmo
    same = (spin[:, None] == spin[None, :]).astype(np.float64)
    g = (
        phys[np.ix_(sp, sp, sp, sp)]
        * same[:, None, :, None]
        * same[None, :, None, :]
    )
    g = g - g.transpose(0, 1, 3, 2)
    occ = list(range(nsocc)) + list(range(nmo, nmo + nsocc))
    vir = [p for p in range(n) if p not in set(occ)]
    order = np.array(occ + vir)
    g = g[np.ix_(order, order, order, order)]
    moe_so = np.concatenate([moe, moe])[order]
    o = slice(0, no)
    v = slice(no, n)
    blocks = dict(
        oovv=g[o, o, v, v], ovvv=g[o, v, v, v], ooov=g[o, o, o, v],
        oooo=g[o, o, o, o], vvvv=g[v, v, v, v], ovov=g[o, v, o, v],
        ovvo=g[o, v, v, o], ovoo=g[o, v, o, o], vvvo=g[v, v, v, o],
    )
    from quemb_tpu.solvers.ccsd_mat import fused_blocks

    nv = n - no
    return fused_blocks(blocks, no, nv), moe_so[:no], moe_so[no:]


def _diis_stage(fb, moe_o, moe_v, t1_0, T2p_0, conv_tol, max_cycle,
                f_blocks=None):
    """DIIS-accelerated amplitude iteration at the dtype of the inputs.

    DIIS history lives in 2-D buffers ([m, no, nv] + [m, no^2, nv^2],
    error history in f32, its Gram matrix at HIGHEST precision so that it
    is never formed in TF32).  Returns (t1, T2p, n_it, delta).
    """
    from jax import lax

    from quemb_tpu.solvers.ccsd_mat import ccsd_update_mat

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
        if f_blocks is None:
            t1n, T2n, _ = ccsd_update_mat(t1, T2p, moe_o, moe_v, fb)
        else:
            t1n, T2n, _ = ccsd_update_mat(
                t1, T2p, moe_o, moe_v, fb,
                f_oo_off=f_blocks[0], f_ov=f_blocks[1],
                f_vv_off=f_blocks[2],
            )
        e1 = t1n - t1
        e2 = T2n - T2p
        delta = jnp.sqrt(
            jnp.sum(e1.astype(jnp.float64) ** 2)
            + jnp.sum(e2.astype(jnp.float64) ** 2)
        )
        # shift-append ring buffer (newest entry last): static slicing
        # lowers to plain copies, where the dynamic-index scatter of
        # buf.at[it % m] becomes a batched scatter once vmapped over
        # fragments
        err1 = jnp.concatenate(
            [err1[1:], e1.astype(jnp.float32)[None]]
        )
        err2 = jnp.concatenate(
            [err2[1:], e2.astype(jnp.float32)[None]]
        )
        amp1 = jnp.concatenate([amp1[1:], t1n[None]])
        amp2 = jnp.concatenate([amp2[1:], T2n[None]])
        # f32 error Gram matrix is plenty for acceleration coefficients;
        # the fixed-point update itself stays at the stage dtype.
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


def _default_conv_tol() -> float:
    """Amplitude-norm convergence target (env QUEMB_TPU_CCSD_CONV_TOL).

    1e-9 is far tighter than the reference's effective setting (PySCF
    CCSD converges to conv_tol_normt=1e-5 amplitudes, cc/ccsd.py
    defaults); 1e-7 keeps E_corr parity well below 1e-7 Ha with fewer
    iterations.  Read at call time and passed to the jitted programs as
    a static argument, so a changed setting compiles a new program.
    """
    import os as _os

    return float(_os.environ.get("QUEMB_TPU_CCSD_CONV_TOL", "1e-9"))


@partial(jax.jit, static_argnames=("max_cycle", "mixed"))
def _ccsd_iterate(moe_o, moe_v, *fb_arrays, conv_tol=None, max_cycle=150,
                  mixed=False):
    """Jitted CCSD iteration (DIIS inside lax.while_loop); vmappable.

    Uses the fused-matrix update of :mod:`solvers.ccsd_mat`.  With
    ``mixed=True``, iterates in f32 to 1e-5 first, then refines in f64 --
    the fixed point is dtype-exact, so the final amplitudes are full f64.
    Every product runs at HIGHEST precision: an f32 stage means f32, not
    TF32.
    """
    with jax.default_matmul_precision("highest"):
        return _ccsd_iterate_impl(moe_o, moe_v, fb_arrays, conv_tol,
                                  max_cycle, mixed)


def _ccsd_iterate_impl(moe_o, moe_v, fb_arrays, conv_tol, max_cycle, mixed):
    from quemb_tpu.solvers.ccsd_mat import BLOCK_KEYS

    if conv_tol is None:
        conv_tol = _default_conv_tol()
    fb = dict(zip(BLOCK_KEYS, fb_arrays))
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
        import os as _os

        # looser f32 stages waste f64 steps, tighter ones stall at the
        # f32 floor
        f32_tol = float(_os.environ.get("QUEMB_TPU_CCSD_F32_TOL", "1e-5"))
        f32_max = int(_os.environ.get("QUEMB_TPU_CCSD_F32_MAX", "45"))
        fb32 = {k: v.astype(jnp.float32) for k, v in fb.items()}
        # drive f32 close to its precision floor (stall-guarded by the
        # cycle cap) so the expensive f64 stage only needs a few steps
        t1_32, T2p_32, it0, _ = _diis_stage(
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
    t1f, T2pf, it, delta = _diis_stage(
        fb, moe_o, moe_v, t1_0, T2p_0, conv_tol, max_cycle
    )
    return t1f, T2pf.reshape(no, no, nv, nv), it0 + it, delta


def _split_spatial(t1f, t2f, nsocc: int, nmo: int):
    nv_sp = nmo - nsocc
    t1_sp = np.asarray(t1f)[:nsocc, :nv_sp]
    t2_sp = np.asarray(t2f)[:nsocc, nsocc:, :nv_sp, nv_sp:]
    return t1_sp, t2_sp


def ccsd_so_kernel(eri_mo, moe, nsocc: int, conv_tol=1e-9, max_cycle=150):
    """Spin-orbital CCSD: fused device block build + jitted iteration.

    Returns spatial (t1, t2, n_iter, norm_dt).
    """
    nmo = np.asarray(eri_mo).shape[0]
    t1f, t2f, it, delta = _ccsd_from_mo_batched(
        jnp.asarray(eri_mo)[None], jnp.asarray(moe)[None], nsocc,
        max_cycle=max_cycle,
    )
    t1_sp, t2_sp = _split_spatial(t1f[0], t2f[0], nsocc, nmo)
    return t1_sp, t2_sp, it[0], delta[0]


def _anti_block(A, Ax):
    """Antisymmetrized spin-orbital block from spatial physicist slices.

    A: [p,q,r,s] spatial <pq|rs> slice; Ax: the slice with the 3rd/4th
    orbital SPACES swapped (equal to A when both live in the same space),
    so the exchange <pq|sr> at [p,q,r,s] is Ax[p,q,s,r].  Returns the
    [2p,2q,2r,2s] spin-orbital <pq||rs> block in spin-major per-axis
    layout, built by broadcast spin-delta expansion (NO gathers -- the
    in-graph [2n]^4 index gather dominated both compile time and the
    host fallback).
    """
    I2 = jnp.eye(2)
    d = jnp.einsum("wy,xz,pqrs->wpxqyrzs", I2, I2, A)
    x = jnp.einsum(
        "wz,xy,pqrs->wpxqyrzs", I2, I2, jnp.transpose(Ax, (0, 1, 3, 2))
    )
    out = d - x
    return out.reshape(
        [2 * A.shape[0], 2 * A.shape[1], 2 * A.shape[2], 2 * A.shape[3]]
    )


def so_blocks_jax(eri_mo, moe, nsocc: int):
    """Pure-jax spin-orbital fused-block build (device-side, gather-free).

    Spin layout per axis: (spin, spatial) major -- occupied indices are
    [alpha occ, beta occ], matching _so_blocks_host's ordering.
    """
    from quemb_tpu.solvers.ccsd_mat import BLOCK_KEYS, fused_blocks

    nmo = eri_mo.shape[0]
    no_sp = nsocc
    no = 2 * nsocc
    nv = 2 * (nmo - nsocc)
    phys = jnp.transpose(jnp.asarray(eri_mo), (0, 2, 1, 3))  # <pq|rs>
    o = slice(0, no_sp)
    v = slice(no_sp, nmo)
    blocks = dict(
        oovv=_anti_block(phys[o, o, v, v], phys[o, o, v, v]),
        ovvv=_anti_block(phys[o, v, v, v], phys[o, v, v, v]),
        ooov=_anti_block(phys[o, o, o, v], phys[o, o, v, o]),
        oooo=_anti_block(phys[o, o, o, o], phys[o, o, o, o]),
        vvvv=_anti_block(phys[v, v, v, v], phys[v, v, v, v]),
        ovov=_anti_block(phys[o, v, o, v], phys[o, v, v, o]),
        ovvo=_anti_block(phys[o, v, v, o], phys[o, v, o, v]),
        ovoo=_anti_block(phys[o, v, o, o], phys[o, v, o, o]),
        vvvo=_anti_block(phys[v, v, v, o], phys[v, v, o, v]),
    )
    moe = jnp.asarray(moe)
    moe_o = jnp.concatenate([moe[:no_sp], moe[:no_sp]])
    moe_v = jnp.concatenate([moe[no_sp:], moe[no_sp:]])
    fb = fused_blocks(blocks, no, nv)
    return tuple(fb[k] for k in BLOCK_KEYS), moe_o, moe_v


def _use_mixed() -> bool:
    """Mixed f32/f64 CCSD iterations: off unless QUEMB_TPU_CCSD_MIXED=1.

    Every backend runs pure f64 by default; the f32 stage is kept as an
    option until a measurement shows where it pays."""
    import os as _os

    return _os.environ.get("QUEMB_TPU_CCSD_MIXED", "").lower() in (
        "1", "true", "yes",
    )


def _f32_only() -> bool:
    """Capacity tier: run the whole CCSD in f32 (env
    QUEMB_TPU_CCSD_F32_ONLY=1).  The spin-orbital blocks are BUILT in
    f32, halving peak device memory — the difference between fitting and
    running out for ~100-orbital embedding spaces (the vvvv block alone
    is 6 GB in f64 at nemb=101).  E_corr accuracy ~1e-5 relative, adequate for loose
    parity targets and survey scans; leave off for production matching.
    """
    import os as _os

    return _os.environ.get("QUEMB_TPU_CCSD_F32_ONLY", "") in (
        "1", "true", "yes",
    )


@partial(jax.jit, static_argnames=("nsocc", "max_cycle", "mixed",
                                   "f32_only", "conv_tol"))
def _ccsd_from_mo_batched(eri_mo_b, moe_b, nsocc: int, max_cycle: int = 150,
                          mixed: bool = False, f32_only: bool = False,
                          conv_tol: float | None = None):
    """Fused device program: spin-block build + CCSD iterate, vmapped."""

    def one(eri_mo, moe):
        if f32_only:
            fb, mo, mv = so_blocks_jax(
                eri_mo.astype(jnp.float32), moe.astype(jnp.float32), nsocc
            )
            f32_tol = float(
                __import__("os").environ.get("QUEMB_TPU_CCSD_F32_TOL",
                                             "1e-5")
            )
            t1f, T2pf, it, delta = _ccsd_iterate(
                mo, mv, *fb, conv_tol=f32_tol, max_cycle=max_cycle,
                mixed=False,
            )
            return (t1f.astype(jnp.float64), T2pf.astype(jnp.float64),
                    it, delta.astype(jnp.float64))
        fb, mo, mv = so_blocks_jax(eri_mo, moe, nsocc)
        return _ccsd_iterate(mo, mv, *fb, conv_tol=conv_tol,
                             max_cycle=max_cycle, mixed=mixed)

    return jax.vmap(one)(eri_mo_b, moe_b)


def ccsd_so_large(eri_mo, moe, nsocc: int, max_cycle: int = 150):
    """Large-fragment CCSD: host-side spin-orbital block build + jitted
    iteration only.

    The in-graph block build materializes broadcast intermediates that
    exhaust device memory beyond nemb ~ 90 (the [2,nv,2,nv,2,nv,2,nv]
    expansion alone is several copies); building the fused blocks on
    the host and streaming them to the device caps device memory at the
    iteration working set.  Honors QUEMB_TPU_CCSD_F32_ONLY.
    Returns spatial (t1, t2, n_iter, delta).
    """
    fb, mo, mv = _so_blocks_host(eri_mo, moe, nsocc)
    from quemb_tpu.solvers.ccsd_mat import BLOCK_KEYS

    if _f32_only():
        arrays = [jnp.asarray(fb[k], jnp.float32) for k in BLOCK_KEYS]
        mo_d = jnp.asarray(mo, jnp.float32)
        mv_d = jnp.asarray(mv, jnp.float32)
        conv = float(
            __import__("os").environ.get("QUEMB_TPU_CCSD_F32_TOL", "1e-5")
        )
    else:
        arrays = [jnp.asarray(fb[k]) for k in BLOCK_KEYS]
        mo_d = jnp.asarray(mo)
        mv_d = jnp.asarray(mv)
        conv = _default_conv_tol()
    t1f, t2f, it, delta = _ccsd_iterate(
        mo_d, mv_d, *arrays, conv_tol=conv, max_cycle=max_cycle,
        mixed=False,
    )
    nmo = np.asarray(eri_mo).shape[0]
    t1_sp, t2_sp = _split_spatial(
        np.asarray(t1f, np.float64), np.asarray(t2f, np.float64),
        nsocc, nmo,
    )
    return t1_sp, t2_sp, int(it), float(delta)


def ccsd_so_batched(eri_mo_b, moe_b, nsocc: int):
    """Batched CCSD over a bucket: one fused device program per bucket
    (gather-free spin-block build -> fused-matrix DIIS iterate).

    The stacked MO integrals are placed with the fragment axis sharded
    over the active mesh (if any), so the program runs SPMD across chips.
    """
    from quemb_tpu.parallel.mesh import shard_batch

    eri_mo_b = np.asarray(eri_mo_b)
    moe_b = np.asarray(moe_b)
    nmo = eri_mo_b.shape[1]
    eri_sh, _ = shard_batch(eri_mo_b)
    moe_sh, _ = shard_batch(moe_b)
    t1f, t2f, it, delta = _ccsd_from_mo_batched(
        eri_sh, moe_sh, nsocc, mixed=_use_mixed(), f32_only=_f32_only()
    )
    t1f = np.asarray(t1f)
    t2f = np.asarray(t2f)
    t1_b = np.stack(
        [_split_spatial(a, b, nsocc, nmo)[0] for a, b in zip(t1f, t2f)]
    )
    t2_b = np.stack(
        [_split_spatial(a, b, nsocc, nmo)[1] for a, b in zip(t1f, t2f)]
    )
    return t1_b, t2_b, it, delta


def solve_ccsd_so(eri_mo, moe, nsocc: int, conv_tol=1e-9, max_cycle=150):
    """Single-fragment CCSD. Returns spatial (t1, t2, e_corr)."""
    t1, t2, it, delta = ccsd_so_kernel(
        jnp.asarray(eri_mo), jnp.asarray(moe), nsocc, max_cycle=max_cycle
    )
    if float(delta) > conv_tol:
        warnings.warn(f"CCSD did not converge: |dt| = {float(delta):.2e}")
    # recompute the closed-shell correlation energy from spatial amplitudes
    no = nsocc
    ovov = np.asarray(eri_mo)[:no, no:, :no, no:]
    t2f = np.asarray(t2) + np.einsum(
        "ia,jb->ijab", np.asarray(t1), np.asarray(t1)
    )
    e_corr = np.einsum("ijab,iajb->", t2f, 2.0 * ovov) - np.einsum(
        "ijab,ibja->", t2f, ovov
    )
    return np.asarray(t1), np.asarray(t2), float(e_corr)


# ----------------------------------------------------- unrelaxed CCSD RDMs
def make_rdm1_ccsd_t1(t1):
    """lambda=0 CCSD 1-RDM (reference ccsd_rdm.py:make_rdm1_ccsd_t1)."""
    nocc, nvir = t1.shape
    nmo = nocc + nvir
    dm = np.zeros((nmo, nmo))
    dm[:nocc, nocc:] = t1
    dm[nocc:, :nocc] = t1.T
    dm[np.diag_indices(nocc)] += 2.0
    return dm


def make_rdm2_urlx(t1, t2, with_dm1=True):
    """Unrelaxed 2-RDM from t1/t2 (reference ccsd_rdm.py:make_rdm2_urlx)."""
    nocc, nvir = t1.shape
    nmo = nocc + nvir
    goovv = (np.einsum("ia,jb->ijab", t1, t1) + t2) * 0.5
    dovov = goovv.transpose(0, 2, 1, 3) * 2 - goovv.transpose(1, 2, 0, 3)
    dm2 = np.zeros([nmo, nmo, nmo, nmo])
    dm2[:nocc, nocc:, :nocc, nocc:] = dovov + dovov.transpose(2, 3, 0, 1)
    dm2[nocc:, :nocc, nocc:, :nocc] = dm2[
        :nocc, nocc:, :nocc, nocc:
    ].transpose(1, 0, 3, 2)
    if with_dm1:
        dm1 = make_rdm1_ccsd_t1(t1)
        dm1[np.diag_indices(nocc)] -= 2.0
        for i in range(nocc):
            dm2[i, i, :, :] += dm1 * 2
            dm2[:, :, i, i] += dm1 * 2
            dm2[:, i, i, :] -= dm1
            dm2[i, :, :, i] -= dm1.T
        for i in range(nocc):
            for j in range(nocc):
                dm2[i, i, j, j] += 4
                dm2[i, j, j, i] -= 2
    return dm2


def solve_ccsd(fr, C, moe, with_dm2=True, use_cumulant=True, relax=False):
    """Fragment CCSD entry used by the dispatcher.

    Returns (rdm1_mo, rdm2_mo) in the fragment-MO basis.
    """
    if relax:
        raise NotImplementedError("relaxed CCSD density lands later")
    eri_mo = np.asarray(
        jnp.einsum(
            "pqrs,pi,qj,rk,sl->ijkl",
            jnp.asarray(fr.eri),
            *([jnp.asarray(C)] * 4),
        )
    )
    t1, t2, _ = solve_ccsd_so(eri_mo, np.asarray(moe), fr.nsocc)
    fr.t1, fr.t2 = t1, t2
    rdm1 = make_rdm1_ccsd_t1(t1)
    rdm2 = (
        make_rdm2_urlx(t1, t2, with_dm1=not use_cumulant)
        if with_dm2
        else None
    )
    return rdm1, rdm2
