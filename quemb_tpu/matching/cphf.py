"""Coupled-perturbed HF response + analytic BE Jacobian assembly.

Reimplements the reference's ``shared/external/cphf_utils.py`` (batched CPHF
kernel) and ``shared/external/optqn.py:250-491`` (block Jacobian of the
matching conditions).  The CPHF solve for all matching potentials at once is
one batched dense linear solve.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from quemb_tpu.embed.fragment import Fragment
from quemb_tpu.solvers.dispatch import run_fragment_scf


def cphf_kernel_batch(C, moe, eri, no, vs):
    """Solve the CPHF equations A u = b for many perturbations v at once.

    C: [n, n] MOs; moe: orbital energies; eri: dense [n]*4 chemist ERIs in
    the same basis as C; no: number of occupied; vs: [npot, n, n].
    Returns us: [npot, no*nv].
    """
    C = jnp.asarray(C)
    eri = jnp.asarray(eri)
    moe = jnp.asarray(moe)
    n = C.shape[0]
    nv = n - no
    Co, Cv = C[:, :no], C[:, no:]
    Vovov = jnp.einsum("pqrs,pi,qa,rj,sb->iajb", eri, Co, Cv, Co, Cv)
    Voovv = jnp.einsum("pqrs,pi,qj,ra,sb->ijab", eri, Co, Co, Cv, Cv)
    A = (
        4.0 * Vovov
        - Vovov.transpose(0, 3, 2, 1)
        - Voovv.transpose(0, 2, 1, 3)
    ).reshape(no * nv, no * nv)
    denom = (moe[:no, None] - moe[None, no:]).ravel()
    A = A - jnp.diag(denom)
    B0s = jnp.einsum("xpq,pi,qa->iax", jnp.asarray(np.array(vs)), Co, Cv)
    B0s = B0s.reshape(no * nv, len(vs))
    # host solve: A is non-symmetric and small
    us = np.linalg.solve(np.asarray(A), np.asarray(B0s)).T
    return us


def cphf_kernel_batch_u(C, moe, eri, no, vs):
    """Coupled-perturbed UHF: alpha/beta responses for many perturbations.

    Own formulation of the reference's CP-UHF surface
    (``shared/external/cphf_utils.py:272-433``): the two spin channels'
    occupied-virtual rotations couple through the total-density Coulomb
    response (factor 2, both spins) while exchange stays same-spin, so
    the linear system is one 2x2 spin-blocked matrix solved for all
    perturbations at once.

    C = (Ca, Cb), moe = (ea, eb), no = (no_a, no_b); ``eri`` is either
    one spinless AO ERI or the (aa, bb, ab) spin triplet; ``vs`` is
    [npot, n, n] (spinless) or [npot, 2, n, n].  Returns
    us: [npot, no_a*nv_a + no_b*nv_b].
    """
    spin_eri = isinstance(eri, (list, tuple))
    Vs = (
        tuple(jnp.asarray(v) for v in eri)
        if spin_eri
        else (jnp.asarray(eri),) * 3
    )
    Co = [jnp.asarray(C[s])[:, : no[s]] for s in (0, 1)]
    Cv = [jnp.asarray(C[s])[:, no[s] :] for s in (0, 1)]
    nov = [Co[s].shape[1] * Cv[s].shape[1] for s in (0, 1)]

    def ovov(V, s, t):
        return jnp.einsum(
            "pqrs,pi,qa,rj,sb->iajb", V, Co[s], Cv[s], Co[t], Cv[t],
            optimize=True,
        )

    blocks = []
    for s in (0, 1):
        Voo = ovov(Vs[s], s, s)
        Vexch = jnp.einsum(
            "pqrs,pi,qj,ra,sb->ijab", Vs[s], Co[s], Co[s], Cv[s], Cv[s],
            optimize=True,
        )
        Ass = (
            2.0 * Voo
            - Voo.transpose(0, 3, 2, 1)
            - Vexch.transpose(0, 2, 1, 3)
        ).reshape(nov[s], nov[s])
        D = (
            jnp.asarray(moe[s])[: no[s], None]
            - jnp.asarray(moe[s])[None, no[s] :]
        ).reshape(-1)
        blocks.append(Ass - jnp.diag(D))
    Vab = 2.0 * jnp.einsum(
        "pqrs,pi,qa,rj,sb->iajb", Vs[2], Co[0], Cv[0], Co[1], Cv[1],
        optimize=True,
    ).reshape(nov[0], nov[1])
    A = jnp.block([[blocks[0], Vab], [Vab.T, blocks[1]]])

    vs = np.asarray(vs)
    if vs.ndim == 3:  # spinless potentials act on both spins
        vs = np.repeat(vs[:, None], 2, axis=1)
    b = np.concatenate(
        [
            np.einsum(
                "xpq,pi,qa->xia", vs[:, s], np.asarray(Co[s]),
                np.asarray(Cv[s]),
            ).reshape(len(vs), nov[s])
            for s in (0, 1)
        ],
        axis=1,
    )
    return np.linalg.solve(np.asarray(A), b.T).T


def get_uhf_dP_from_u(C, no, u):
    """Per-spin AO density responses from a stacked CP-UHF solution."""
    nov0 = no[0] * (C[0].shape[1] - no[0])
    out = []
    for s, u_s in ((0, u[:nov0]), (1, u[nov0:])):
        Co, Cv = C[s][:, : no[s]], C[s][:, no[s] :]
        dP = -Co @ u_s.reshape(no[s], -1) @ Cv.T
        out.append(dP + dP.T)
    return out


def get_rhf_dP_from_u(C, no, u):
    n = C.shape[0]
    nv = n - no
    dP = -C[:, :no] @ u.reshape(no, nv) @ C[:, no:].T
    return dP + dP.T


def get_vpots_frag(nao, relAO_per_edge, AO_in_frag):
    """Unit perturbation per matching condition + chem-pot (optqn.py:464)."""
    vpots = []
    for edge in relAO_per_edge:
        for j in range(len(edge)):
            for k in range(j, len(edge)):
                v = np.zeros((nao, nao))
                v[edge[j], edge[k]] = v[edge[k], edge[j]] = 1.0
                vpots.append(v)
    v = np.zeros((nao, nao))
    edge_set = {i for sub in relAO_per_edge for i in sub}
    for i in range(len(AO_in_frag)):
        if i not in edge_set:
            v[i, i] = -1.0
    vpots.append(v)
    return vpots


def hf_response(fr: Fragment):
    """HF CPHF responses dP per matching condition (optqn.py hfres_func)."""
    vpots = get_vpots_frag(fr.nao, fr.relAO_per_edge, fr.AO_in_frag)
    moe, C = run_fragment_scf(fr)
    us = cphf_kernel_batch(C, moe, fr.eri, fr.nsocc, vpots)
    dPs = [
        get_rhf_dP_from_u(C, fr.nsocc, us[i]) for i in range(len(vpots) - 1)
    ]
    dP_mu = get_rhf_dP_from_u(C, fr.nsocc, us[-1])
    return dPs, dP_mu


def _dPmp2_batch(C, moe, eri, no, vs):
    """Analytic MP2 density response dP/dlambda for many perturbations.

    Own formulation of the reference's ``get_dPmp2_batch_r``
    (shared/external/cpmp2_utils.py:94): CPHF orbital response + Fock
    derivative + amplitude derivative, assembled as one vmapped jax program
    over the perturbations.  Returns dPs in the AO(embedding) basis,
    [npot, n, n], with the reference's normalization (x2, before the 0.5
    of optqn.py:446 mp2res_func).
    """
    import jax

    n = C.shape[0]
    nv = n - no
    C = jnp.asarray(C)
    eri = jnp.asarray(eri)
    moe = jnp.asarray(moe)
    Co, Cv = C[:, :no], C[:, no:]
    Vovov = jnp.einsum(
        "pqrs,pi,qa,rj,sb->iajb", eri, Co, Cv, Co, Cv, optimize=True
    )
    Dia = moe[:no, None] - moe[None, no:]
    Diajb = (
        Dia[:, :, None, None] + Dia[None, None, :, :]
    )
    t2 = Vovov / Diajb

    def pmp2(t2l, t2r):
        k = 2.0 * t2r - jnp.transpose(t2r, (0, 3, 2, 1))
        Poo = -jnp.einsum("iajb,majb->im", t2l, k, optimize=True)
        Pvv = jnp.einsum("iajb,icjb->ac", t2l, k, optimize=True)
        Z = jnp.zeros((no, nv))
        return jnp.block([[Poo, Z], [Z.T, Pvv]])

    P = pmp2(t2, t2) + jnp.diag(
        jnp.concatenate([jnp.ones(no), jnp.zeros(nv)])
    )

    us = cphf_kernel_batch(C, moe, eri, no, vs)  # [npot, no*nv]

    def one(u, Q):
        uov = u.reshape(no, nv)
        dP_hf = -Co @ uov @ Cv.T
        dP_hf = dP_hf + dP_hf.T
        vj = jnp.einsum("pqrs,rs->pq", eri, 2.0 * dP_hf)
        vk = jnp.einsum("prqs,rs->pq", eri, 2.0 * dP_hf)
        dF = Q + vj - 0.5 * vk
        dmoe = jnp.einsum("pi,qi,pq->i", C, C, dF)
        dDia = dmoe[:no, None] - dmoe[None, no:]
        dDiajb = dDia[:, :, None, None] + dDia[None, None, :, :]
        # full orbital-rotation matrix (oo/vv from dF, ov from CPHF u)
        eo, ev = moe[:no], moe[no:]
        Dij = -eo[:, None] + eo[None, :] + jnp.eye(no)
        dUoo = (Co.T @ dF @ Co) / Dij * (1.0 - jnp.eye(no))
        Dab = -ev[:, None] + ev[None, :] + jnp.eye(nv)
        dUvv = (Cv.T @ dF @ Cv) / Dab * (1.0 - jnp.eye(nv))
        U = jnp.block([[dUoo, uov], [-uov.T, dUvv]])
        dC = C @ U
        dCo, dCv = dC[:, :no], dC[:, no:]
        V1 = jnp.einsum(
            "pqrs,pi,qa,rj,sb->iajb", eri, Co, Cv, Co, dCv, optimize=True
        )
        V2 = jnp.einsum(
            "pqrs,pi,qa,rj,sb->iajb", eri, Co, Cv, dCo, Cv, optimize=True
        )
        dVovov = (
            V1
            + jnp.transpose(V1, (2, 3, 0, 1))
            + V2
            + jnp.transpose(V2, (2, 3, 0, 1))
        )
        dt2 = (dVovov - t2 * dDiajb) / Diajb
        dP_rot = U @ P - P @ U
        dP2 = pmp2(dt2, t2)
        dP2 = dP2 + dP2.T
        dP_mo = (dP_rot + dP2) * 2.0
        return C @ dP_mo @ C.T

    dPs = jax.vmap(one)(jnp.asarray(us), jnp.asarray(np.array(vs)))
    return np.asarray(dPs)


def _dPmp2_batch_u(C, moe, eri, no, vs):
    """Analytic UMP2 density response per spin for many perturbations.

    Unrestricted analog of :func:`_dPmp2_batch` (the reference surface
    ``shared/external/cpmp2_utils.py:278 get_dPmp2_batch_u``): CP-UHF
    orbital response + per-spin Fock derivatives + same-/opposite-spin
    amplitude derivatives, assembled per perturbation.  ``eri`` is one
    spinless AO ERI; occupations are 1, so there is no restricted x2.
    Returns [npot, 2, n, n] AO-basis densities dP^sigma/dlambda of
    P^sigma = C^sigma (P_HF + P_MP2)^sigma C^sigma^T.
    """
    import jax

    eri = jnp.asarray(eri)
    Cs = [jnp.asarray(C[s]) for s in (0, 1)]
    moes = [jnp.asarray(moe[s]) for s in (0, 1)]
    n = Cs[0].shape[0]
    nv = [n - no[s] for s in (0, 1)]
    Co = [Cs[s][:, : no[s]] for s in (0, 1)]
    Cv = [Cs[s][:, no[s] :] for s in (0, 1)]

    def ovov(s, t, c1=None, c2=None, c3=None, c4=None):
        return jnp.einsum(
            "pqrs,pi,qa,rj,sb->iajb", eri,
            c1 if c1 is not None else Co[s],
            c2 if c2 is not None else Cv[s],
            c3 if c3 is not None else Co[t],
            c4 if c4 is not None else Cv[t],
            optimize=True,
        )

    eia = [moes[s][: no[s], None] - moes[s][None, no[s] :] for s in (0, 1)]

    def Dpair(s, t):
        return (
            eia[s][:, :, None, None] + eia[t][None, None, :, :]
        )

    V = {(s, t): ovov(s, t) for s in (0, 1) for t in (0, 1) if s <= t}
    # amplitudes: same-spin antisymmetrized, opposite-spin plain
    T = {}
    for s in (0, 1):
        T[(s, s)] = (
            V[(s, s)] - jnp.transpose(V[(s, s)], (0, 3, 2, 1))
        ) / Dpair(s, s)
    T[(0, 1)] = V[(0, 1)] / Dpair(0, 1)

    def pcorr_blocks(s, Tss_l, Tss_r, Tos_l, Tos_r):
        """A[i,m]/A[a,c] halves of the MP2 density quadratics for spin s
        (caller adds the transpose to complete the product rule)."""
        Poo = -(
            0.5 * jnp.einsum("iajb,majb->im", Tss_l, Tss_r, optimize=True)
            + (
                jnp.einsum("iajb,majb->im", Tos_l, Tos_r, optimize=True)
                if s == 0
                else jnp.einsum("jbia,jbma->im", Tos_l, Tos_r,
                                optimize=True)
            )
        )
        Pvv = (
            0.5 * jnp.einsum("iajb,icjb->ac", Tss_l, Tss_r, optimize=True)
            + (
                jnp.einsum("iajb,icjb->ac", Tos_l, Tos_r, optimize=True)
                if s == 0
                else jnp.einsum("jbia,jbic->ac", Tos_l, Tos_r,
                                optimize=True)
            )
        )
        Z = jnp.zeros((no[s], nv[s]))
        return jnp.block([[Poo, Z], [Z.T, Pvv]])

    P = []
    for s in (0, 1):
        # for l == r the quadratic is already the full (symmetric) value
        full = pcorr_blocks(s, T[(s, s)], T[(s, s)], T[(0, 1)], T[(0, 1)])
        occ = jnp.concatenate([jnp.ones(no[s]), jnp.zeros(nv[s])])
        P.append(full + jnp.diag(occ))

    us = cphf_kernel_batch_u(C, moe, eri, no, vs)
    nov0 = no[0] * nv[0]

    def one(u, Q):
        uov = [
            u[:nov0].reshape(no[0], nv[0]),
            u[nov0:].reshape(no[1], nv[1]),
        ]
        dP_hf = []
        for s in (0, 1):
            d = -Co[s] @ uov[s] @ Cv[s].T
            dP_hf.append(d + d.T)
        vj = jnp.einsum("pqrs,rs->pq", eri, dP_hf[0] + dP_hf[1])
        dF, U, dC = [], [], []
        for s in (0, 1):
            vk = jnp.einsum("prqs,rs->pq", eri, dP_hf[s])
            dFs = Q + vj - vk
            dF.append(dFs)
            eo, ev = moes[s][: no[s]], moes[s][no[s] :]
            Dij = -eo[:, None] + eo[None, :] + jnp.eye(no[s])
            dUoo = (Co[s].T @ dFs @ Co[s]) / Dij * (1.0 - jnp.eye(no[s]))
            Dab = -ev[:, None] + ev[None, :] + jnp.eye(nv[s])
            dUvv = (Cv[s].T @ dFs @ Cv[s]) / Dab * (1.0 - jnp.eye(nv[s]))
            U.append(
                jnp.block([[dUoo, uov[s]], [-uov[s].T, dUvv]])
            )
            dC.append(Cs[s] @ U[s])
        dmoe = [
            jnp.einsum("pi,qi,pq->i", Cs[s], Cs[s], dF[s]) for s in (0, 1)
        ]
        deia = [
            dmoe[s][: no[s], None] - dmoe[s][None, no[s] :]
            for s in (0, 1)
        ]

        def dV(s, t):
            dCo = [dC[x][:, : no[x]] for x in (0, 1)]
            dCv = [dC[x][:, no[x] :] for x in (0, 1)]
            return (
                ovov(s, t, c1=dCo[s])
                + ovov(s, t, c2=dCv[s])
                + ovov(s, t, c3=dCo[t])
                + ovov(s, t, c4=dCv[t])
            )

        dT = {}
        for s in (0, 1):
            dVss = dV(s, s)
            dD = (
                deia[s][:, :, None, None] + deia[s][None, None, :, :]
            )
            dT[(s, s)] = (
                (dVss - jnp.transpose(dVss, (0, 3, 2, 1)))
                - T[(s, s)] * dD
            ) / Dpair(s, s)
        dDos = (
            deia[0][:, :, None, None] + deia[1][None, None, :, :]
        )
        dT[(0, 1)] = (dV(0, 1) - T[(0, 1)] * dDos) / Dpair(0, 1)

        out = []
        for s in (0, 1):
            half = pcorr_blocks(
                s, dT[(s, s)], T[(s, s)], dT[(0, 1)], T[(0, 1)]
            )
            dP2 = half + half.T
            dP_rot = U[s] @ P[s] - P[s] @ U[s]
            out.append(Cs[s] @ (dP_rot + dP2) @ Cs[s].T)
        return jnp.stack(out)

    dPs = jax.vmap(one)(
        jnp.asarray(us), jnp.asarray(np.array(vs))
    )
    return np.asarray(dPs)


def mp2_response(fr: Fragment):
    """CP-MP2 responses per matching condition (ref optqn.py:441)."""
    vpots = get_vpots_frag(fr.nao, fr.relAO_per_edge, fr.AO_in_frag)
    moe, C = run_fragment_scf(fr)
    dPs_all = 0.5 * _dPmp2_batch(C, moe, fr.eri, fr.nsocc, vpots)
    return list(dPs_all[:-1]), dPs_all[-1]


def _dPccsd_urlx_batch(C, moe, eri, no, vs):
    """Approximate CCSD (t1-urlx) density response per perturbation.

    Own formulation of the reference's ``get_dPccsdurlx_batch_u``
    (shared/external/jac_utils.py:162): the matched density is
    P = P_HF + [Co t1 Cv^T + h.c.] with the one-cycle t1 from MP2 t2;
    its derivative combines CPHF orbital response, the Fock derivative
    through the t2 denominators, and differentiated integrals.  All
    per-perturbation work is one vmapped jax program.
    """
    import jax

    n = C.shape[0]
    nv = n - no
    C = jnp.asarray(C)
    eri = jnp.asarray(eri)
    moe = jnp.asarray(moe)
    Co, Cv = C[:, :no], C[:, no:]
    eia = moe[:no, None] - moe[None, no:]
    eovov = (
        eia[:, :, None, None] + eia[None, None, :, :]
    )

    def mo4(c1, c2, c3, c4, pattern_unused=None):
        return jnp.einsum(
            "pqrs,pi,qa,rj,sb->iajb", eri, c1, c2, c3, c4, optimize=True
        )

    Vovov = mo4(Co, Cv, Co, Cv)
    Vvovv = jnp.einsum(
        "pqrs,pa,qi,rb,sc->aibc", eri, Cv, Co, Cv, Cv, optimize=True
    )
    Voovo = jnp.einsum(
        "pqrs,pi,qk,rb,sj->ikbj", eri, Co, Co, Cv, Co, optimize=True
    )
    t2 = Vovov / eovov

    def t1_of(Vov_ov, Voovo_, Vvovv_):
        tt = Vov_ov / eovov
        return (
            2.0 * jnp.einsum("ibjc,cjba->ia", tt, Vvovv_, optimize=True)
            - jnp.einsum("jbic,cjba->ia", tt, Vvovv_, optimize=True)
            - 2.0 * jnp.einsum("ikbj,jbka->ia", Voovo_, tt, optimize=True)
            + jnp.einsum("ikbj,kbja->ia", Voovo_, tt, optimize=True)
        ) / eia

    t1 = t1_of(Vovov, Voovo, Vvovv)
    us = cphf_kernel_batch(C, moe, eri, no, vs)

    def one(u, Q):
        uov = u.reshape(no, nv)
        dP_hf = -Co @ uov @ Cv.T
        dP_hf = dP_hf + dP_hf.T
        vj = jnp.einsum("pqrs,rs->pq", eri, 2.0 * dP_hf)
        vk = jnp.einsum("prqs,rs->pq", eri, 2.0 * dP_hf)
        A = -(Q + vj - 0.5 * vk)  # -dF
        Aoo = Co.T @ A @ Co
        Avv = Cv.T @ A @ Cv
        tA = jnp.einsum("lajb,li->iajb", t2, Aoo, optimize=True) - \
            jnp.einsum("idjb,da->iajb", t2, Avv, optimize=True)
        tA = tA + jnp.transpose(tA, (2, 3, 0, 1))

        dCo = -Cv @ uov.T
        dCv = Co @ uov

        def d_mo4(cs, dcs, pattern):
            out = 0.0
            for k in range(4):
                ops = [dcs[k] if j == k else cs[j] for j in range(4)]
                out = out + jnp.einsum(
                    pattern, eri, *ops, optimize=True
                )
            return out

        dVovov = d_mo4(
            (Co, Cv, Co, Cv), (dCo, dCv, dCo, dCv),
            "pqrs,pi,qa,rj,sb->iajb",
        )
        dVvovv = d_mo4(
            (Cv, Co, Cv, Cv), (dCv, dCo, dCv, dCv),
            "pqrs,pa,qi,rb,sc->aibc",
        )
        dVoovo = d_mo4(
            (Co, Co, Cv, Co), (dCo, dCo, dCv, dCo),
            "pqrs,pi,qk,rb,sj->ikbj",
        )

        # t1_of is linear in its first argument and jointly linear in the
        # (Voovo, Vvovv) pair, so the derivative splits into three calls
        dt1_mo = (
            t1_of(tA, Voovo, Vvovv)
            + t1_of(dVovov, Voovo, Vvovv)
            + t1_of(Vovov, dVoovo, dVvovv)
            + (Aoo @ t1 - t1 @ Avv) / eia
        )
        dt1 = Co @ dt1_mo @ Cv.T
        dt1 = dt1 + dCo @ t1 @ Cv.T + Co @ t1 @ dCv.T
        dt1 = dt1 + dt1.T
        dPhf = 2.0 * dCo @ Co.T
        dPhf = dPhf + dPhf.T
        return dt1 + dPhf

    dPs = jax.vmap(one)(jnp.asarray(us), jnp.asarray(np.array(vs)))
    return np.asarray(dPs)


def ccsd_response(fr: Fragment):
    """CP-CCSD(urlx) responses per matching condition (ref optqn.py:452)."""
    vpots = get_vpots_frag(fr.nao, fr.relAO_per_edge, fr.AO_in_frag)
    moe, C = run_fragment_scf(fr)
    dPs_all = 0.5 * _dPccsd_urlx_batch(C, moe, fr.eri, fr.nsocc, vpots)
    return list(dPs_all[:-1]), dPs_all[-1]


def _pair_indices(groups) -> tuple[np.ndarray, np.ndarray]:
    """Upper-triangular (row, col) AO pairs for a list of AO-index groups.

    One pair per matching condition, in condition order: groups in the
    given order, and within a group all pairs (a, b) with a appearing at
    or before b.  Matches the ordering of :func:`get_vpots_frag` (and of
    ``solve_error``'s error vector).
    """
    rows: list[int] = []
    cols: list[int] = []
    for g in groups:
        for j, a in enumerate(g):
            rows.extend([a] * (len(g) - j))
            cols.extend(g[j:])
    return np.asarray(rows, dtype=np.intp), np.asarray(cols, dtype=np.intp)


def frag_jacobian_blocks(fr: Fragment, res_func=hf_response):
    """All Jacobian data of one fragment, read off the stacked responses.

    Computes the fragment's density responses dP for every one of its
    matching potentials (plus the chemical potential) and gathers each
    kind of Jacobian entry with one vectorized index map (the quantities
    the reference assembles entry-by-entry, optqn.py:314):

    - ``edge``  [n_pairs, n_cond]: response of the fragment's own edge
      RDM entries to its own potentials (the diagonal block),
    - ``center`` [n_center_pairs, n_cond]: MINUS the response of the
      origin/center RDM entries -- added to the rows of every fragment
      whose edge refers here,
    - ``trace`` [n_cond]: response of the center-site electron count
      (the chemical-potential row),
    - ``*_mu``: the same three gathers off the chem-pot response.
    """
    dPs, dP_mu = res_func(fr)
    D = np.stack([np.asarray(p) for p in dPs] + [np.asarray(dP_mu)])
    er, ec = _pair_indices(fr.relAO_per_edge)
    n_cond = er.size
    assert n_cond + 1 == D.shape[0]
    origin = sorted(fr.relAO_per_origin)
    cr, cc = _pair_indices([origin])
    edge_aos = {a for e in fr.relAO_per_edge for a in e}
    sites = np.asarray(
        [i for i in range(fr.n_frag) if i not in edge_aos], dtype=np.intp
    )
    E = D[:, er, ec]  # [n_cond + 1, n_pairs]
    Cm = -D[:, cr, cc]  # [n_cond + 1, n_center_pairs]
    tr = (
        D[:, sites, sites].sum(axis=1)
        if sites.size
        else np.zeros(n_cond + 1)
    )
    return {
        "edge": E[:-1].T,
        "edge_mu": E[-1],
        "center": Cm[:-1].T,
        "center_mu": Cm[-1],
        "trace": tr[:-1],
        "trace_mu": tr[-1],
        "n_cond": n_cond,
    }


def get_be_error_jacobian(fragments: list[Fragment], jac_solver="HF"):
    """Analytic Jacobian of the BE matching conditions (optqn.py:250).

    Row/column layout matches the error vector of ``solve_error``: one
    row per edge-pair condition, fragment by fragment, then the
    chemical-potential row; columns are the matching potentials in the
    same order plus the chemical potential.  Each fragment contributes
    its diagonal ``edge`` block, and -- through every fragment whose
    edge points at it -- its ``center`` block on those rows.
    """
    res_funcs = {"HF": hf_response, "MP2": mp2_response,
                 "CCSD": ccsd_response}
    if jac_solver.upper() not in res_funcs:
        raise NotImplementedError(
            f"jac_solver={jac_solver}; available: {sorted(res_funcs)}"
        )
    res_func = res_funcs[jac_solver.upper()]
    blocks = [frag_jacobian_blocks(fr, res_func) for fr in fragments]

    off = np.concatenate(
        [[0], np.cumsum([b["n_cond"] for b in blocks])]
    ).astype(int)
    n = int(off[-1])
    J = np.zeros((n + 1, n + 1))
    for f, (fr, b) in enumerate(zip(fragments, blocks)):
        rows = slice(off[f], off[f + 1])
        J[rows, rows] = b["edge"]
        J[rows, n] = b["edge_mu"]
        J[n, rows] = b["trace"]
        # each edge of this fragment is matched against the center block
        # of the fragment it references; the edge's rows are a contiguous
        # run whose length is that center block's pair count
        r0 = off[f]
        for ref in fr.ref_frag_idx_per_edge:
            rb = blocks[ref]
            m = rb["center"].shape[0]
            J[r0 : r0 + m, off[ref] : off[ref + 1]] += rb["center"]
            J[r0 : r0 + m, n] += rb["center_mu"]
            r0 += m
    J[n, n] = sum(b["trace_mu"] for b in blocks)
    return J
