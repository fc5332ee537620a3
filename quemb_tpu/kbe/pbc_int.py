"""Periodic Gaussian AO integrals: lattice sums + range-separated Coulomb.

Self-contained replacement for the periodic integral machinery the reference
reaches through PySCF-PBC and libdmet (reference kbe/pbe.py:181-183 caches
``mf.get_hcore()``/``get_ovlp()``; kbe/eri_onthefly.py:48 evaluates DF
integrals with real-space + Fourier-space splitting and charge compensation).

Scheme: every Coulomb object is evaluated with the G=0-regularized kernel
(uniform neutralizing background; pyscf ``exxdiv=None`` convention) through
an erf/erfc range separation at splitting parameter ``omega``:

  (A|B)_reg = (A|erfc(w r)/r|B)_realspace
              - pi/(Omega w^2) * A~(0) * B~(0)        <- G=0 of the erfc part
              + (1/Omega) sum_{G+q != 0} 4 pi e^{-|G+q|^2/4w^2}/|G+q|^2
                          * A~(G+q) * B~(-G-q)

The short-range part reuses the molecular McMurchie-Davidson machinery with
erfc-attenuated Boys functions; the long-range part needs only analytic
Gaussian Fourier transforms (pair FTs below) and is a dense batched
contraction.
"""

from __future__ import annotations

import numpy as np

from quemb_tpu.chem.integrals import (
    _E_coeffs,
    _PairClass,
    _R_sparse,
    boys,
    hermite_index_list,
)
from quemb_tpu.chem.mole import Shell, cart_components
from quemb_tpu.kbe.cell import Cell

__all__ = [
    "s_t_kpts",
    "vnuc_kpts",
    "ft_aopair_kpts",
    "ft_single",
    "pair_images",
    "boys_erfc",
]


# ------------------------------------------------------- erfc-attenuated Boys
def boys_erfc(m_max: int, theta: np.ndarray, R2: np.ndarray, omega: float):
    """F^{erfc}_m(theta, R2) for the erfc(w r)/r kernel, m = 0..m_max.

    F^{erfc}_m = F_m(theta R2) - s^{m+1/2} F_m(s theta R2),
    s = w^2 / (w^2 + theta).
    """
    T = theta * R2
    F = boys(m_max, T)
    s = omega**2 / (omega**2 + theta)
    Fl = boys(m_max, s * T)
    for m in range(m_max + 1):
        F[m] = F[m] - s ** (m + 0.5) * Fl[m]
    return F


def _R_sparse_kernel(idx_list, L, theta, PQ, omega=None):
    """Hermite Coulomb R_{tuv} like integrals._R_sparse, kernel-switchable.

    omega=None: full 1/r kernel.  omega=w: erfc(w r)/r kernel.
    """
    if omega is None:
        return _R_sparse(idx_list, L, theta, PQ)
    R2 = np.einsum("...i,...i->...", PQ, PQ)
    F = boys_erfc(L, theta, R2, omega)
    base = np.empty_like(F)
    pref = np.ones_like(theta)
    for n in range(L + 1):
        base[n] = pref * F[n]
        pref = pref * (-2.0 * theta)
    X, Y, Z = PQ[..., 0], PQ[..., 1], PQ[..., 2]
    cache: dict = {}

    def R(n, t, u, v):
        if t < 0 or u < 0 or v < 0:
            return 0.0
        if t == u == v == 0:
            return base[n]
        key = (n, t, u, v)
        if key in cache:
            return cache[key]
        if t > 0:
            val = X * R(n + 1, t - 1, u, v)
            if t > 1:
                val = val + (t - 1) * R(n + 1, t - 2, u, v)
        elif u > 0:
            val = Y * R(n + 1, t, u - 1, v)
            if u > 1:
                val = val + (u - 1) * R(n + 1, t, u - 2, v)
        else:
            val = Z * R(n + 1, t, u, v - 1)
            if v > 1:
                val = val + (v - 1) * R(n + 1, t, u, v - 2)
        cache[key] = val
        return val

    bshape = np.broadcast_shapes(theta.shape, R2.shape)
    out = np.empty(bshape + (len(idx_list),))
    for i, (t, u, v) in enumerate(idx_list):
        out[..., i] = np.broadcast_to(R(0, t, u, v), bshape)
    return out


# ----------------------------------------------------- shell-pair image setup
def _min_pair_exp(sh_i: Shell, sh_j: Shell) -> float:
    a = float(np.min(sh_i.exps))
    b = float(np.min(sh_j.exps))
    return a * b / (a + b)


def pair_images(cell: Cell, cut: float = 1e-12):
    """Pair classes of (mu in cell 0, nu shifted by lattice image T).

    Returns a list of (_PairClass, Tvecs[n, 3]) grouped by (la,ka,lb,kb)
    signature; only images whose Gaussian-overlap estimate survives ``cut``
    are kept.  All ordered (i, j) shell pairs are enumerated (the k-phase
    breaks bra/ket symmetry).
    """
    shells = cell.shells
    # image cutoff from the most diffuse pair in the basis
    mu_min = min(
        _min_pair_exp(si, sj) for si in shells for sj in shells
    )
    ext = float(
        np.max(np.linalg.norm(cell.atom_coords(), axis=1), initial=0.0)
    )
    rcut = np.sqrt(np.log(1.0 / cut) / mu_min) + 2.0 * ext + 1.0
    Ls = cell.lattice_Ls(rcut)

    from collections import defaultdict

    groups: dict = defaultdict(lambda: ([], []))
    for i, si in enumerate(shells):
        for j, sj in enumerate(shells):
            mu = _min_pair_exp(si, sj)
            d2 = np.sum(
                (si.center[None, :] - sj.center[None, :] - Ls) ** 2, axis=1
            )
            keep = mu * d2 < np.log(1.0 / cut)
            sig = (si.l, len(si.exps), sj.l, len(sj.exps))
            lst, tv = groups[sig]
            for T in Ls[keep]:
                lst.append((i, j, T))
            tv.extend(list(Ls[keep]))
    out = []
    for sig, (pairs, tvecs) in groups.items():
        if not pairs:
            continue
        flat_shells = []
        idx_pairs = []
        for (i, j, T) in pairs:
            sj = shells[j]
            flat_shells.append(shells[i])
            flat_shells.append(
                Shell(
                    sj.l, sj.exps, sj.coefs, sj.center + T, sj.atom_idx,
                    sj.ao_offset,
                )
            )
            idx_pairs.append((len(flat_shells) - 2, len(flat_shells) - 1))
        pc = _PairClass(flat_shells, idx_pairs)
        out.append((pc, np.asarray(tvecs)))
    return out


def _scatter_accum_k(out_k, pc, val, phases):
    """out_k[k, mu, nu] += phases[k, n] * val[n, ia, ib] (duplicate-safe)."""
    nk = out_k.shape[0]
    nao = out_k.shape[1]
    na, nb = len(pc.comps_a), len(pc.comps_b)
    for ia in range(na):
        rows = pc.ao_a + ia
        for ib in range(nb):
            cols = pc.ao_b + ib
            flat = rows * nao + cols
            for k in range(nk):
                np.add.at(
                    out_k[k].reshape(-1), flat, phases[k] * val[:, ia, ib]
                )


# ------------------------------------------------------------ S_k / T_k
def s_t_kpts(cell: Cell, kpts: np.ndarray, cut: float = 1e-12):
    """Lattice-sum overlap and kinetic matrices per k-point.

    S_k[mu,nu] = sum_T e^{i k.T} (mu_0 | nu_T); analogously for T_k.
    """
    from quemb_tpu.chem.integrals import _pair_kinetic, _pair_overlap

    kpts = np.asarray(kpts).reshape(-1, 3)
    nk = len(kpts)
    nao = cell.nao
    S = np.zeros((nk, nao, nao), dtype=np.complex128)
    T = np.zeros((nk, nao, nao), dtype=np.complex128)
    for pc, Tv in pair_images(cell, cut):
        phases = np.exp(1j * (kpts @ Tv.T))  # [nk, n]
        _scatter_accum_k(S, pc, _pair_overlap(pc), phases)
        _scatter_accum_k(T, pc, _pair_kinetic(pc), phases)
    return S, T


# ---------------------------------------------------------------- pair FTs
def _ft_pair_class(pc: _PairClass, Gq: np.ndarray, chunk: int = 512):
    """FT of the contracted pair functions of a class at wavevectors Gq.

    Returns val[n, nab, nG] complex with
    val = sum_prims cc (pi/p)^{3/2} e^{-G^2/4p} e^{-i G.P}
          sum_tuv H_tuv (-i G)^{tuv}.
    """
    idx_list = hermite_index_list(pc.Lx)
    H = pc.hermite_coefs()  # [n, K, nab, nT]
    n, K = pc.p.shape
    nG = Gq.shape[0]
    out = np.zeros((n, pc.nab, nG), dtype=np.complex128)
    G2 = np.einsum("gi,gi->g", Gq, Gq)
    for s in range(0, nG, chunk):
        sl = slice(s, min(s + chunk, nG))
        g = Gq[sl]
        W = np.empty((len(idx_list), g.shape[0]), dtype=np.complex128)
        for t_i, (t, u, v) in enumerate(idx_list):
            W[t_i] = (
                (-1j * g[:, 0]) ** t
                * (-1j * g[:, 1]) ** u
                * (-1j * g[:, 2]) ** v
            )
        for kprim in range(K):
            p = pc.p[:, kprim]  # [n]
            P = pc.P[:, kprim]  # [n,3]
            rad = (
                (np.pi / p[:, None]) ** 1.5
                * np.exp(-G2[None, sl] / (4.0 * p[:, None]))
                * pc.cc[:, kprim][:, None]
                * np.exp(-1j * (P @ g.T))
            )  # [n, nGc]
            out[:, :, sl] += np.einsum(
                "nat,tg,ng->nag", H[:, kprim], W, rad, optimize=True
            )
    return out


def ft_aopair_kpts(
    cell: Cell,
    Gq: np.ndarray,
    kpts_T: np.ndarray,
    cut: float = 1e-12,
    pairs=None,
):
    """Motif pair FT rho[kT, mu, nu, G] = sum_T e^{i kT.T} FT(mu_0 nu_T)(Gq).

    ``kpts_T`` are the phases applied to the ket lattice image (for the
    (k1, k2) Bloch pair with momentum q = k2 - k1 evaluate at kT = k2 and
    wavevectors Gq = G + q).  ``pairs`` can carry a precomputed
    :func:`pair_images` result.
    """
    kpts_T = np.asarray(kpts_T).reshape(-1, 3)
    nkT = len(kpts_T)
    nao = cell.nao
    nG = Gq.shape[0]
    out = np.zeros((nkT, nao, nao, nG), dtype=np.complex128)
    for pc, Tv in pairs if pairs is not None else pair_images(cell, cut):
        val = _ft_pair_class(pc, Gq)  # [n, nab, nG]
        phases = np.exp(1j * (kpts_T @ Tv.T))  # [nkT, n]
        na, nb = len(pc.comps_a), len(pc.comps_b)
        for ia in range(na):
            rows = pc.ao_a + ia
            for ib in range(nb):
                cols = pc.ao_b + ib
                flat = rows * nao + cols
                for k in range(nkT):
                    np.add.at(
                        out[k].reshape(nao * nao, nG),
                        flat,
                        phases[k][:, None] * val[:, ia * nb + ib],
                    )
    return out


def ft_single(mol_like, Gq: np.ndarray) -> np.ndarray:
    """FT of single (contracted) AO functions chi_P at wavevectors Gq.

    Returns [naux, nG] complex.  Used for the auxiliary basis.
    """
    nG = Gq.shape[0]
    out = np.zeros((mol_like.nao, nG), dtype=np.complex128)
    G2 = np.einsum("gi,gi->g", Gq, Gq)
    for sh in mol_like.shells:
        comps = cart_components(sh.l)
        E = [
            _E_coeffs(
                sh.l, 0,
                sh.exps[None, :], np.zeros((1, len(sh.exps))),
                np.zeros((1, 1)),
            )
            for _ in range(3)
        ]
        # single-center: AB = 0, so E[l][0][t] are scalars per primitive
        idx_list = hermite_index_list(sh.l)
        pos = {tuv: i for i, tuv in enumerate(idx_list)}
        H = np.zeros((len(sh.exps), len(comps), len(idx_list)))
        for ic, (ax, ay, az) in enumerate(comps):
            for t in range(ax + 1):
                for u in range(ay + 1):
                    for v in range(az + 1):
                        if (t, u, v) not in pos:
                            continue
                        H[:, ic, pos[(t, u, v)]] = (
                            E[0][ax][0][t][0] * E[1][ay][0][u][0]
                            * E[2][az][0][v][0]
                        )
        W = np.empty((len(idx_list), nG), dtype=np.complex128)
        for t_i, (t, u, v) in enumerate(idx_list):
            W[t_i] = (
                (-1j * Gq[:, 0]) ** t
                * (-1j * Gq[:, 1]) ** u
                * (-1j * Gq[:, 2]) ** v
            )
        rad = (
            (np.pi / sh.exps[:, None]) ** 1.5
            * np.exp(-G2[None, :] / (4.0 * sh.exps[:, None]))
            * sh.coefs[:, None]
        ) * np.exp(-1j * (Gq @ sh.center))[None, :]
        val = np.einsum("kct,tg,kg->cg", H, W, rad, optimize=True)
        out[sh.ao_offset : sh.ao_offset + len(comps)] = val
    return out


# --------------------------------------------------------------- V_nuc (k)
def vnuc_kpts(
    cell: Cell,
    kpts: np.ndarray,
    omega: float = 0.3,
    cut: float = 1e-12,
    S_k: np.ndarray | None = None,
    pairs=None,
    gmax_fac: float = 1.0,
) -> np.ndarray:
    """Periodic nuclear attraction per k-point (background-regularized).

    SR: erfc real-space double lattice sum.  LR: G-space with the G=0 term
    replaced by the analytic + pi Z_tot S_k / (Omega w^2) correction.
    """
    kpts = np.asarray(kpts).reshape(-1, 3)
    nk = len(kpts)
    nao = cell.nao
    Z = cell.atom_charges().astype(np.float64)
    coords = cell.atom_coords()
    Om = cell.vol

    if pairs is None:
        pairs = pair_images(cell, cut)

    # ---- SR: nuclear images within erfc range of the cell
    rsr = 6.0 / omega + float(np.max(np.abs(coords), initial=0.0)) + 3.0
    Lnuc = cell.lattice_Ls(rsr)
    sites = (coords[None, :, :] + Lnuc[:, None, :]).reshape(-1, 3)
    charges = np.tile(Z, len(Lnuc))

    V = np.zeros((nk, nao, nao), dtype=np.complex128)
    for pc, Tv in pairs:
        L = pc.Lx
        idx_list = hermite_index_list(L)
        H = pc.hermite_coefs()
        acc = np.zeros((pc.n, pc.K, len(idx_list)))
        chunk = max(1, int(2e7 / (pc.n * pc.K * (L + 1) + 1)))
        for s in range(0, len(sites), chunk):
            Cs = sites[s : s + chunk]
            Zs = charges[s : s + chunk]
            PC = pc.P[:, :, None, :] - Cs[None, None, :, :]
            R = _R_sparse_kernel(
                idx_list, L, pc.p[:, :, None], PC, omega=omega
            )  # [n,K,nC,nT]
            acc -= np.einsum("c,nkct->nkt", Zs, R)
        pref = 2.0 * np.pi / pc.p * pc.cc
        val = np.einsum("nkat,nkt,nk->na", H, acc, pref, optimize=True)
        val = val.reshape(pc.n, len(pc.comps_a), len(pc.comps_b))
        phases = np.exp(1j * (kpts @ Tv.T))
        _scatter_accum_k(V, pc, val, phases)

    # ---- LR: G-space
    gmax = 2.0 * omega * np.sqrt(np.log(1.0 / cell.precision) + 8.0) * gmax_fac
    Gv = cell.get_Gv(gmax)
    G2 = np.einsum("gi,gi->g", Gv, Gv)
    nz = G2 > 1e-12
    Gv, G2 = Gv[nz], G2[nz]
    vG = 4.0 * np.pi * np.exp(-G2 / (4.0 * omega**2)) / G2  # [nG]
    bG = -(Z @ np.exp(-1j * (coords @ Gv.T)))  # b~(G) = -sum Z e^{-iG.C}
    rho = ft_aopair_kpts(cell, Gv, kpts, cut, pairs=pairs)  # [nk,nao,nao,nG]
    # (1/Om) sum_G v(G) rho(G) b~(-G);  b~(-G) = conj(b~(G)) for real charges
    V += np.einsum("g,kuvg,g->kuv", vG, rho, np.conj(bG)) / Om

    # ---- G=0 correction: -(pi/(Om w^2)) S_k * b~(0), b~(0) = -Z_tot
    if S_k is None:
        S_k, _ = s_t_kpts(cell, kpts, cut)
    V += (np.pi / (Om * omega**2)) * np.sum(Z) * S_k
    return V
