"""Fused-matrix closed-shell RCCSD update (the production layout).

Mathematically identical to :func:`solvers.rccsd.rccsd_update` (verified to
1e-12 in tests/test_rccsd.py), but every contraction runs over fused
composite indices -- [no^2, nv^2] pair layouts and [no*nv, no*nv] ring
layouts -- so the XLA program is a chain of 2-D GEMMs instead of 4-D
einsums with small trailing dimensions.  Same design as :mod:`solvers.ccsd_mat` for
the spin-orbital path, at 1/4 the operand sizes and ~1/8-1/16 the FLOPs
(reference runs the analogous closed-shell kernel via PySCF,
molbe/solver.py:829).

Block preparation is pure jax (transposes/reshapes of the MO ERI, no
gathers) so it fuses into the per-fragment device program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_PH = jax.lax.Precision.HIGHEST

RBLOCK_KEYS = (
    "Vp", "VpX", "G_me_nf", "G_me_fn", "GT_me_nf", "GTmnf_e", "GTm_nef",
    "A1_mf_ae", "E1_mef_a", "F1_mne_i", "OO12_mi_ne", "D12_ia_nf",
    "OOOV_mni_e", "OONV_mnj_e", "Op", "Wp", "G1_m_aef", "G2_m_bef",
    "OVVV_mbe_f", "OVVVx_mbe_f", "OONJ_mej_n", "OOJE_mej_n",
    "GOVVO_me_jb", "GOVOV_me_jb", "GV_e_jba", "OO_m_ijb",
)


def rccsd_fused_blocks(eri_mo, no: int) -> dict:
    """Fused 2-D operand layouts from the chemist MO ERI (pq|rs).

    Convention: g[p,q,r,s] = <pq|rs> physicist.  Perm rule used throughout:
    ``x.transpose(p)`` places source axis ``p[k]`` at target axis ``k``.
    """
    nmo = eri_mo.shape[0]
    nv = nmo - no
    g = jnp.transpose(eri_mo, (0, 2, 1, 3))
    o = slice(0, no)
    v = slice(no, None)
    goovv = g[o, o, v, v]
    govvv = g[o, v, v, v]
    gooov = g[o, o, o, v]
    goooo = g[o, o, o, o]
    gvvvv = g[v, v, v, v]
    govov = g[o, v, o, v]
    govvo = g[o, v, v, o]

    Vp = goovv.reshape(no * no, nv * nv)
    VpX = jnp.transpose(goovv, (0, 1, 3, 2)).reshape(no * no, nv * nv)
    G_me_nf = jnp.transpose(goovv, (0, 2, 1, 3)).reshape(no * nv, no * nv)
    G_me_fn = jnp.transpose(goovv, (0, 3, 1, 2)).reshape(no * nv, no * nv)
    gt = 2.0 * goovv - jnp.transpose(goovv, (0, 1, 3, 2))

    # [(m,e),(j,b)] ring operands: g[m,b,e,j] / g[m,b,j,e]
    GOVVO_me_jb = jnp.transpose(govvo, (0, 2, 3, 1)).reshape(
        no * nv, no * nv
    )
    GOVOV_me_jb = jnp.transpose(govov, (0, 3, 2, 1)).reshape(
        no * nv, no * nv
    )

    return dict(
        Vp=Vp,
        VpX=VpX,
        G_me_nf=G_me_nf,
        G_me_fn=G_me_fn,
        GT_me_nf=2.0 * G_me_nf - G_me_fn,
        # [(m,n,f),e] = 2 g[m,n,e,f] - g[m,n,f,e]
        GTmnf_e=jnp.transpose(gt, (0, 1, 3, 2)).reshape(no * no * nv, nv),
        GTm_nef=gt.reshape(no, no * nv * nv),
        # [(m,f),(a,e)] = 2 g[m,a,f,e] - g[m,a,e,f]
        A1_mf_ae=(
            2.0 * jnp.transpose(govvv, (0, 2, 1, 3))
            - jnp.transpose(govvv, (0, 3, 1, 2))
        ).reshape(no * nv, nv * nv),
        # [(m,e,f),a] = 2 g[m,a,f,e] - g[m,a,e,f]
        E1_mef_a=(
            2.0 * jnp.transpose(govvv, (0, 3, 2, 1))
            - jnp.transpose(govvv, (0, 2, 3, 1))
        ).reshape(no * nv * nv, nv),
        # [(m,n,e),i] = g[m,n,e,i] - 2 g[m,n,i,e]; g[m,n,e,i]=gooov[n,m,i,e]
        F1_mne_i=(
            jnp.transpose(gooov, (1, 0, 3, 2))
            - 2.0 * jnp.transpose(gooov, (0, 1, 3, 2))
        ).reshape(no * no * nv, no),
        # [(m,i),(n,e)] = 2 g[m,n,i,e] - g[n,m,i,e]
        OO12_mi_ne=(
            2.0 * jnp.transpose(gooov, (0, 2, 1, 3))
            - jnp.transpose(gooov, (1, 2, 0, 3))
        ).reshape(no * no, no * nv),
        # [(i,a),(n,f)] = -g[n,a,i,f] + 2 g[n,a,f,i]
        D12_ia_nf=(
            -jnp.transpose(govov, (2, 1, 0, 3))
            + 2.0 * jnp.transpose(govvo, (3, 1, 0, 2))
        ).reshape(no * nv, no * nv),
        OOOV_mni_e=gooov.reshape(no * no * no, nv),
        # [(m,n,j),e] = g[m,n,e,j] = gooov[n,m,j,e]
        OONV_mnj_e=jnp.transpose(gooov, (1, 0, 2, 3)).reshape(
            no * no * no, nv
        ),
        Op=goooo.reshape(no * no, no * no),
        Wp=gvvvv.reshape(nv * nv, nv * nv),
        # [m,(a,e,f)] = g[a,m,e,f] = g[m,a,f,e]
        G1_m_aef=jnp.transpose(govvv, (0, 1, 3, 2)).reshape(
            no, nv * nv * nv
        ),
        G2_m_bef=govvv.reshape(no, nv * nv * nv),
        OVVV_mbe_f=govvv.reshape(no * nv * nv, nv),
        # [(m,b,e),f] = g[m,b,f,e]
        OVVVx_mbe_f=jnp.transpose(govvv, (0, 1, 3, 2)).reshape(
            no * nv * nv, nv
        ),
        # [(m,e,j),n] = g[m,n,e,j] (src gooov[n,m,j,e])
        OONJ_mej_n=jnp.transpose(gooov, (1, 3, 2, 0)).reshape(
            no * nv * no, no
        ),
        # [(m,e,j),n] = g[m,n,j,e]
        OOJE_mej_n=jnp.transpose(gooov, (0, 3, 2, 1)).reshape(
            no * nv * no, no
        ),
        GOVVO_me_jb=GOVVO_me_jb,
        GOVOV_me_jb=GOVOV_me_jb,
        # [e,(j,b,a)] = g[a,b,e,j] = govvv[j,e,b,a]
        GV_e_jba=jnp.transpose(govvv, (1, 0, 2, 3)).reshape(
            nv, no * nv * nv
        ),
        # [m,(i,j,b)] = g[m,b,i,j] = gooov[i,j,m,b]
        OO_m_ijb=jnp.transpose(gooov, (2, 0, 1, 3)).reshape(
            no, no * no * nv
        ),
    )


def _r_to_p(Xr, no, nv):
    """[(i,a),(j,b)] ring -> [(i,j),(a,b)] pair layout."""
    return (
        Xr.reshape(no, nv, no, nv)
        .transpose(0, 2, 1, 3)
        .reshape(no * no, nv * nv)
    )


def _cross_to_p(Xc, no, nv):
    """[(j,a),(i,b)] cross layout -> [(i,j),(a,b)] pair layout."""
    return (
        Xc.reshape(no, nv, no, nv)
        .transpose(2, 0, 1, 3)
        .reshape(no * no, nv * nv)
    )


def rccsd_update_mat(t1, T2p, moe_o, moe_v, fb: dict):
    """One closed-shell CCSD update in fused-matrix form (canonical MOs).

    t1: [no, nv]; T2p: [no^2, nv^2] pair layout of the mixed-spin t2.
    Returns (t1new, T2p_new, e_corr).
    """
    no, nv = t1.shape
    dot = lambda a, b: jnp.matmul(a, b, precision=_PH)
    t1f = t1.reshape(-1)
    T4 = T2p.reshape(no, no, nv, nv)

    # tau in P layout: Kk[(ij),(ab)] = t1[i,a] t1[j,b]
    Kk = jnp.kron(t1, t1)
    tau_h = T2p + 0.5 * Kk
    tau = T2p + Kk
    tau_h4 = tau_h.reshape(no, no, nv, nv)

    # ---- F intermediates
    Fvv = (t1f @ fb["A1_mf_ae"]).reshape(nv, nv) - dot(
        jnp.transpose(tau_h4, (0, 1, 3, 2)).reshape(no * no * nv, nv).T,
        fb["GTmnf_e"],
    )
    Foo = (fb["OO12_mi_ne"] @ t1f).reshape(no, no) + dot(
        fb["GTm_nef"], tau_h.reshape(no, no * nv * nv).T
    )
    Fov = (fb["GT_me_nf"] @ t1f).reshape(no, nv)

    # ---- T1
    T2r = jnp.transpose(T4, (0, 2, 1, 3)).reshape(no * nv, no * nv)
    T2c = jnp.transpose(T4, (0, 3, 1, 2)).reshape(no * nv, no * nv)
    t1new = (
        t1 @ Fvv.T
        - Foo.T @ t1
        + ((2.0 * T2r - T2c) @ Fov.reshape(-1)).reshape(no, nv)
        + (fb["D12_ia_nf"] @ t1f).reshape(no, nv)
        + dot(T2p.reshape(no, no * nv * nv), fb["E1_mef_a"])
        + dot(
            jnp.transpose(T4, (0, 1, 3, 2)).reshape(no * no * nv, nv).T,
            fb["F1_mne_i"],
        ).T
    )

    # ---- W intermediates
    # Wmix [(mn),(ij)]
    H1 = (fb["OOOV_mni_e"] @ t1.T).reshape(no * no, no * no)
    H2 = (
        (fb["OONV_mnj_e"] @ t1.T)
        .reshape(no * no, no, no)
        .transpose(0, 2, 1)
        .reshape(no * no, no * no)
    )
    Wmix = fb["Op"] + H1 + H2 + 0.5 * dot(tau, fb["Vp"].T).T

    # Wvmix [(ab),(ef)]
    E1t = (
        (t1.T @ fb["G1_m_aef"])
        .reshape(nv, nv, nv * nv)
        .transpose(1, 0, 2)
        .reshape(nv * nv, nv * nv)
    )
    E2t = (t1.T @ fb["G2_m_bef"]).reshape(nv * nv, nv * nv)
    Wvmix = fb["Wp"] - E1t - E2t + 0.5 * dot(tau.T, fb["Vp"])

    # ring quadratic amplitude layouts [(n,f),(j,b)]
    T2q1 = jnp.transpose(T4, (1, 2, 0, 3)).reshape(no * nv, no * nv)
    T2q2 = jnp.transpose(T4, (1, 3, 0, 2)).reshape(no * nv, no * nv)
    # X2p[(n,f),(j,b)] = t1[j,f] t1[n,b]
    X2p = jnp.einsum(
        "nb,jf->nfjb", t1, t1, precision=_PH
    ).reshape(no * nv, no * nv)

    # W1 [(m,e),(j,b)]
    d1 = (
        (fb["OVVV_mbe_f"] @ t1.T)
        .reshape(no, nv, nv, no)
        .transpose(0, 2, 3, 1)
        .reshape(no * nv, no * nv)
    )
    d2 = (fb["OONJ_mej_n"] @ t1).reshape(no * nv, no * nv)
    W1 = (
        fb["GOVVO_me_jb"]
        + d1
        - d2
        + dot(fb["G_me_nf"], -0.5 * T2q1 + T2q2 - X2p)
        - 0.5 * dot(fb["G_me_fn"], T2q2)
    )

    # W2 [(m,e),(j,b)]
    d1b = (
        ((fb["OVVV_mbe_f"] - fb["OVVVx_mbe_f"]) @ t1.T)
        .reshape(no, nv, nv, no)
        .transpose(0, 2, 3, 1)
        .reshape(no * nv, no * nv)
    )
    d2b = ((fb["OOJE_mej_n"] - fb["OONJ_mej_n"]) @ t1).reshape(
        no * nv, no * nv
    )
    W2 = (
        fb["GOVVO_me_jb"]
        - fb["GOVOV_me_jb"]
        + d1b
        + d2b
        - dot(
            fb["G_me_nf"] - fb["G_me_fn"],
            0.5 * (T2q1 - T2q2) + X2p,
        )
        + 0.5 * dot(fb["G_me_nf"], T2q2)
    )

    # W3 [(m,e),(i,b)]
    d1c = (
        (fb["OVVVx_mbe_f"] @ t1.T)
        .reshape(no, nv, nv, no)
        .transpose(0, 2, 3, 1)
        .reshape(no * nv, no * nv)
    )
    d2c = (fb["OOJE_mej_n"] @ t1).reshape(no * nv, no * nv)
    W3 = (
        -fb["GOVOV_me_jb"]
        - d1c
        + d2c
        + dot(fb["G_me_fn"], 0.5 * T2q1 + X2p)
    )

    # ---- T2
    FF = Fvv - 0.5 * (t1.T @ Fov)
    FFo = Foo + 0.5 * Fov @ t1.T
    S = dot(T2p.reshape(no * no * nv, nv), FF.T).reshape(
        no * no, nv * nv
    )
    S = S - jnp.einsum(
        "imx,mj->ijx", T4.reshape(no, no, nv * nv), FFo, precision=_PH
    ).reshape(no * no, nv * nv)
    # rings
    A_r = T2r - T2c
    S = S + _r_to_p(dot(A_r, W1) + dot(T2r, W2), no, nv)
    S = S + _cross_to_p(dot(T2c, W3), no, nv)
    # -(t1 t1 <|>) ring pieces
    X2r = jnp.einsum(
        "ie,ma->iame", t1, t1, precision=_PH
    ).reshape(no * nv, no * nv)
    S = S - _r_to_p(dot(X2r, fb["GOVVO_me_jb"]), no, nv)
    S = S - _cross_to_p(dot(X2r, fb["GOVOV_me_jb"]), no, nv)
    # one-particle dressed: +t1[i,e] g[a,b,e,j]  and  -t1[m,a] g[m,b,i,j]
    S = S + (
        (t1 @ fb["GV_e_jba"])
        .reshape(no, no, nv, nv)
        .transpose(0, 1, 3, 2)
        .reshape(no * no, nv * nv)
    )
    S = S - (
        (t1.T @ fb["OO_m_ijb"])
        .reshape(nv, no, no, nv)
        .transpose(1, 2, 0, 3)
        .reshape(no * no, nv * nv)
    )

    Ssym = (
        S.reshape(no, no, nv, nv)
        .transpose(1, 0, 3, 2)
        .reshape(no * no, nv * nv)
    )
    T2new = fb["Vp"] + S + Ssym + dot(Wmix.T, tau) + dot(tau, Wvmix.T)

    # ---- denominators
    Dov = moe_o[:, None] - moe_v[None, :]
    Doo = (moe_o[:, None] + moe_o[None, :]).reshape(-1)
    Dvv = (moe_v[:, None] + moe_v[None, :]).reshape(-1)
    t1new = t1new / Dov
    T2new = T2new / (Doo[:, None] - Dvv[None, :])

    e_corr = jnp.sum(tau * (2.0 * fb["Vp"] - fb["VpX"]))
    return t1new, T2new, e_corr
