"""Matrix-form spin-orbital CCSD update.

Mathematically identical to ``solvers/ccsd.py:_ccsd_update`` (SGWB
equations), but every large contraction is expressed over fused composite
indices - [no^2, nv^2] pair layouts and [no*nv, no*nv] ring layouts - so the
XLA program is a short chain of 2-D GEMMs instead of ~35 4-D einsums
with small trailing dimensions, which also cuts compile time.

Block preparation (host side) fuses the antisymmetrized <pq||rs> slices into
the exact 2-D operand layouts the update consumes.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

BLOCK_KEYS = (
    "Vp", "M_me_nf", "V_mnf_e", "V_m_nef", "A_mf_ae", "B_mef_a",
    "C_mbe_f", "D_m_bef", "G2_mni_e", "K_mi_ne", "Q_i_mne", "R1_mje_n",
    "O_mn_ij", "V4_ab_ef", "S1_ia_nf", "ovvo_r", "ovoo_m_bij", "V2_e_abj",
)


def fused_blocks(blocks: dict, no: int, nv: int) -> dict:
    """Fuse the 9 antisymmetrized 4-D blocks into 2-D operand layouts."""
    oovv = blocks["oovv"]
    ovvv = blocks["ovvv"]
    ooov = blocks["ooov"]
    return dict(
        Vp=oovv.reshape(no * no, nv * nv),
        M_me_nf=oovv.transpose(0, 2, 1, 3).reshape(no * nv, no * nv),
        V_mnf_e=oovv.transpose(0, 1, 3, 2).reshape(no * no * nv, nv),
        V_m_nef=oovv.reshape(no, no * nv * nv),
        A_mf_ae=ovvv.transpose(0, 2, 1, 3).reshape(no * nv, nv * nv),
        B_mef_a=ovvv.transpose(0, 2, 3, 1).reshape(no * nv * nv, nv),
        C_mbe_f=ovvv.reshape(no * nv * nv, nv),
        D_m_bef=ovvv.reshape(no, nv * nv * nv),
        G2_mni_e=ooov.reshape(no * no * no, nv),
        K_mi_ne=ooov.transpose(0, 2, 1, 3).reshape(no * no, no * nv),
        Q_i_mne=ooov.transpose(2, 1, 0, 3).reshape(no, no * no * nv),
        R1_mje_n=ooov.transpose(0, 2, 3, 1).reshape(no * no * nv, no),
        O_mn_ij=blocks["oooo"].reshape(no * no, no * no),
        V4_ab_ef=blocks["vvvv"].reshape(nv * nv, nv * nv),
        S1_ia_nf=blocks["ovov"].transpose(2, 1, 0, 3).reshape(
            no * nv, no * nv
        ),
        ovvo_r=blocks["ovvo"].transpose(0, 2, 3, 1).reshape(
            no * nv, no * nv
        ),
        ovoo_m_bij=blocks["ovoo"].reshape(no, nv * no * no),
        V2_e_abj=blocks["vvvo"].transpose(2, 0, 1, 3).reshape(
            nv, nv * nv * no
        ),
    )


def _p_to_r(Xp, no, nv):
    """[no^2, nv^2] (ij),(ab) -> [no*nv, no*nv] (ia),(jb)."""
    return (
        Xp.reshape(no, no, nv, nv)
        .transpose(0, 2, 1, 3)
        .reshape(no * nv, no * nv)
    )


def _r_to_p(Xr, no, nv):
    return (
        Xr.reshape(no, nv, no, nv)
        .transpose(0, 2, 1, 3)
        .reshape(no * no, nv * nv)
    )


def _P_ab(Xp, no, nv):
    """Antisymmetrize the (a,b) pair of a P-layout matrix."""
    X4 = Xp.reshape(no * no, nv, nv)
    return (X4 - X4.transpose(0, 2, 1)).reshape(no * no, nv * nv)


def _P_ij(Xp, no, nv):
    X4 = Xp.reshape(no, no, nv * nv)
    return (X4 - X4.transpose(1, 0, 2)).reshape(no * no, nv * nv)


def ccsd_update_mat(t1, T2p, moe_o, moe_v, fb: dict, f_oo_off=None,
                    f_ov=None, f_vv_off=None):
    """One CCSD amplitude update in fused-matrix form.

    t1: [no, nv]; T2p: [no^2, nv^2] pair layout.  Returns (t1new, T2p_new,
    e_corr).
    """
    no, nv = t1.shape
    dot = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    t1f = t1.reshape(-1)

    # tau matrices (P layout)
    Kk = jnp.kron(t1, t1)  # [(ij),(ab)] = t1[i,a] t1[j,b]
    Kswap = (
        Kk.reshape(no, no, nv, nv).transpose(0, 1, 3, 2).reshape(
            no * no, nv * nv
        )
    )
    t1t1 = Kk - Kswap
    tau_t = T2p + 0.5 * t1t1
    tau = T2p + t1t1

    # --- F intermediates
    Fae = (t1f @ fb["A_mf_ae"]).reshape(nv, nv) - 0.5 * dot(
        tau_t.reshape(no, no, nv, nv)
        .transpose(0, 1, 3, 2)
        .reshape(no * no * nv, nv)
        .T,
        fb["V_mnf_e"],
    )
    Fmi = (fb["K_mi_ne"] @ t1f).reshape(no, no) + 0.5 * dot(
        fb["V_m_nef"], tau_t.reshape(no, no * nv * nv).T
    )
    Fme = (fb["M_me_nf"] @ t1f).reshape(no, nv)
    if f_ov is not None:
        Fae = Fae + f_vv_off.T - 0.5 * (f_ov.T @ t1).T
        Fmi = Fmi + f_oo_off + 0.5 * (t1 @ f_ov.T).T
        Fme = Fme + f_ov

    # --- W intermediates
    # Wmnij [(mn),(ij)]
    H1 = (fb["G2_mni_e"] @ t1.T).reshape(no * no, no * no)  # [(mni),j]->(mn)(ij)
    H2 = (
        (fb["G2_mni_e"] @ t1.T)
        .reshape(no * no, no, no)
        .transpose(0, 2, 1)
        .reshape(no * no, no * no)
    )
    Wmnij = fb["O_mn_ij"] + H1 - H2 + 0.25 * dot(tau, fb["Vp"].T).T
    # Wabef [(ab),(ef)]
    E1 = (t1.T @ fb["D_m_bef"]).reshape(nv, nv, nv * nv)  # [b,a,(ef)]
    Wabef = (
        fb["V4_ab_ef"]
        + E1.transpose(1, 0, 2).reshape(nv * nv, nv * nv)
        - E1.reshape(nv * nv, nv * nv)
        + 0.25 * dot(tau.T, fb["Vp"])
    )
    # Wmbej ring [(me),(jb)]
    W1b = (
        (fb["C_mbe_f"] @ t1.T)
        .reshape(no, nv, nv, no)  # [m,b,e,j]
        .transpose(0, 2, 3, 1)
        .reshape(no * nv, no * nv)
    )
    W2 = (
        (fb["R1_mje_n"] @ t1)
        .reshape(no, no, nv, nv)  # [m,j,e,b]
        .transpose(0, 2, 1, 3)
        .reshape(no * nv, no * nv)
    )
    # tt[(nf),(jb)] with tt = 0.5 t2 + t1 x t1 (plain outer)
    T2_r2 = (
        T2p.reshape(no, no, nv, nv)
        .transpose(1, 2, 0, 3)  # [n,f,j,b]
        .reshape(no * nv, no * nv)
    )
    t1o_r2 = jnp.einsum("jf,nb->nfjb", t1, t1).reshape(
        no * nv, no * nv
    )
    Wmbej = fb["ovvo_r"] + W1b + W2 - dot(
        fb["M_me_nf"], 0.5 * T2_r2 + t1o_r2
    )

    # --- T1 equation
    T2r = _p_to_r(T2p, no, nv)  # [(ia),(me)] via (i a),(m e)
    t1new = (
        t1 @ Fae.T
        - Fmi.T @ t1
        + (T2r @ Fme.reshape(-1)).reshape(no, nv)
        - (fb["S1_ia_nf"] @ t1f).reshape(no, nv)
        - 0.5 * dot(
            T2p.reshape(no, no * nv * nv), fb["B_mef_a"]
        )
        + 0.5 * dot(
            fb["Q_i_mne"],
            T2p.reshape(no, no, nv, nv)
            .transpose(0, 1, 3, 2)
            .reshape(no * no * nv, nv),
        )
    )
    if f_ov is not None:
        t1new = t1new + f_ov

    # --- T2 equation
    FF_b = Fae - 0.5 * t1.T @ Fme  # [b?,e] -> used as [x,e] with x=b
    T2new = fb["Vp"] + _P_ab(
        dot(T2p.reshape(no * no * nv, nv), FF_b.T).reshape(
            no * no, nv * nv
        ),
        no, nv,
    )
    FF_m = Fmi + 0.5 * Fme @ t1.T  # [m,j]
    T2new = T2new - _P_ij(
        jnp.einsum(
            "imx,mj->ijx",
            T2p.reshape(no, no, nv * nv),
            FF_m,
        ).reshape(no * no, nv * nv),
        no, nv,
    )
    T2new = T2new + 0.5 * dot(Wmnij.T, tau)
    T2new = T2new + 0.5 * dot(tau, Wabef.T)
    # ring contributions
    X2 = jnp.einsum("ie,ma->iame", t1, t1).reshape(no * nv, no * nv)
    Rring = dot(T2r, Wmbej) - dot(X2, fb["ovvo_r"])
    T2new = T2new + _P_ij(_P_ab(_r_to_p(Rring, no, nv), no, nv), no, nv)
    # one-particle dressed integrals
    W3 = (
        (t1 @ fb["V2_e_abj"])
        .reshape(no, nv, nv, no)  # [i,a,b,j]
        .transpose(0, 3, 1, 2)
        .reshape(no * no, nv * nv)
    )
    T2new = T2new + _P_ij(W3, no, nv)
    U = (
        (t1.T @ fb["ovoo_m_bij"])
        .reshape(nv, nv, no, no)  # [a,b,i,j]
        .transpose(2, 3, 0, 1)
        .reshape(no * no, nv * nv)
    )
    T2new = T2new - _P_ab(U, no, nv)

    # denominators
    Dov = moe_o[:, None] - moe_v[None, :]
    Doo = (moe_o[:, None] + moe_o[None, :]).reshape(-1)
    Dvv = (moe_v[:, None] + moe_v[None, :]).reshape(-1)
    Doovv = Doo[:, None] - Dvv[None, :]
    t1new = t1new / Dov
    T2new = T2new / Doovv

    e_corr = 0.25 * jnp.sum(fb["Vp"] * tau)
    if f_ov is not None:
        e_corr = e_corr + jnp.sum(f_ov * t1)
    return t1new, T2new, e_corr
