"""Gaussian AO integrals via McMurchie-Davidson, batched over shell classes.

Self-contained replacement for the AO integrals the reference obtains from
PySCF's C library (``mol.intor("int1e_ovlp")``, ``int1e_kin``, ``int1e_nuc``,
``mol.intor("int2e")``, and the DF variants ``int2c2e``/``int3c2e``).

Design: shells are grouped into *classes* of identical angular momenta and
contraction lengths; all pairs/quartets of a class combination are evaluated
as batched numpy tensor ops (one vectorized sweep per class combination
instead of per-integral Python loops).  The same per-class static-shape
structure is what allows a later jit/device offload of the hot ERI classes.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
from scipy.special import gammainc, gammaln

from quemb_tpu.chem.mole import Mole, Shell, cart_components, ncart

__all__ = [
    "overlap",
    "kinetic",
    "nuclear_attraction",
    "eri_full",
    "int2c2e",
    "int3c2e",
    "core_hamiltonian",
]


# ----------------------------------------------------------------- Boys func
def boys(m_max: int, T: np.ndarray) -> np.ndarray:
    """F_m(T) for m = 0..m_max. T: any shape. Returns [m_max+1, *T.shape].

    Uses the native C kernel when available (quemb_tpu/native/boys.c,
    series + asymptotic + downward recursion); falls back to the
    incomplete-gamma formulation below.
    """
    T = np.asarray(T, dtype=np.float64)
    from quemb_tpu.native import get_lib

    lib = get_lib()
    if lib is not None:
        import ctypes

        flat = np.ascontiguousarray(T.reshape(-1))
        out = np.empty((m_max + 1, flat.size))
        lib.boys_batch(
            m_max,
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            flat.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return out.reshape((m_max + 1,) + T.shape)
    out = np.empty((m_max + 1,) + T.shape)
    small = T < 1e-13
    Ts = np.where(small, 1.0, T)  # avoid 0-division; overwritten below
    a = m_max + 0.5
    top = np.exp(gammaln(a)) * gammainc(a, Ts) / (2.0 * Ts**a)
    out[m_max] = np.where(
        small, 1.0 / (2 * m_max + 1) - T / (2 * m_max + 3), top
    )
    expT = np.exp(-Ts)
    for m in range(m_max, 0, -1):
        low = (2.0 * T * out[m] + expT) / (2 * m - 1)
        out[m - 1] = np.where(
            small, 1.0 / (2 * m - 1) - T / (2 * m + 1), low
        )
    return out


def hermite_index_list(L: int) -> list[tuple[int, int, int]]:
    """All (t, u, v) with t+u+v <= L, in a fixed deterministic order."""
    return [
        (t, u, v)
        for t in range(L + 1)
        for u in range(L + 1 - t)
        for v in range(L + 1 - t - u)
    ]


# ------------------------------------------------- Hermite expansion (E) 1D
def _E_coeffs(la: int, lb: int, a, b, AB):
    """Hermite expansion coefficients E_t^{ij} for one cartesian dimension.

    a, b: exponent arrays broadcastable together; AB: A_x - B_x same shape.
    Returns nested list E[i][j][t] of arrays (same shape as a*b).
    """
    p = a + b
    mu = a * b / p
    # X_PA = P - A = (aA + bB)/p - A = -b/p * AB;  X_PB = a/p * AB
    XPA = -b / p * AB
    XPB = a / p * AB
    inv2p = 0.5 / p
    E = [[None] * (lb + 1) for _ in range(la + 1)]
    E[0][0] = [np.exp(-mu * AB * AB)]

    def get(i, j, t):
        if t < 0 or t > i + j:
            return 0.0
        return E[i][j][t]

    for i in range(la + 1):
        for j in range(lb + 1):
            if i == 0 and j == 0:
                continue
            terms = []
            for t in range(i + j + 1):
                if i > 0:
                    val = (
                        inv2p * get(i - 1, j, t - 1)
                        + XPA * get(i - 1, j, t)
                        + (t + 1) * get(i - 1, j, t + 1)
                    )
                else:
                    val = (
                        inv2p * get(i, j - 1, t - 1)
                        + XPB * get(i, j - 1, t)
                        + (t + 1) * get(i, j - 1, t + 1)
                    )
                terms.append(val)
            E[i][j] = terms
    return E


# ------------------------------------------------- Hermite Coulomb (R) terms
def _R_tensor(tmax: int, umax: int, vmax: int, alpha, PQ):
    """R_{tuv}(alpha, PQ) for the full box t<=tmax, u<=umax, v<=vmax.

    alpha: [...], PQ: [..., 3].  Returns array [tmax+1, umax+1, vmax+1, ...].
    """
    L = tmax + umax + vmax
    T = alpha * np.einsum("...i,...i->...", PQ, PQ)
    F = boys(L, T)  # [L+1, ...]
    base = np.empty_like(F)
    pref = np.ones_like(alpha)
    for n in range(L + 1):
        base[n] = pref * F[n]
        pref = pref * (-2.0 * alpha)
    # R^n_{tuv} recursion; store dict keyed by (t,u,v) of arrays over n-layers
    # computed lazily: R^n_{t+1,u,v} = t*R^{n+1}_{t-1,u,v} + X*R^{n+1}_{t,u,v}
    X, Y, Z = PQ[..., 0], PQ[..., 1], PQ[..., 2]
    cache: dict[tuple[int, int, int, int], np.ndarray] = {}

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

    out = np.empty((tmax + 1, umax + 1, vmax + 1) + alpha.shape)
    for t in range(tmax + 1):
        for u in range(umax + 1):
            for v in range(vmax + 1):
                out[t, u, v] = R(0, t, u, v)
    return out


def _R_sparse(idx_list, L: int, alpha, PQ):
    """R_{tuv}(alpha, PQ) at the given (t,u,v) indices only.

    Returns array [..., len(idx_list)] over the broadcast shape of alpha.
    """
    T = alpha * np.einsum("...i,...i->...", PQ, PQ)
    F = boys(L, T)
    base = np.empty_like(F)
    pref = np.ones_like(alpha)
    for n in range(L + 1):
        base[n] = pref * F[n]
        pref = pref * (-2.0 * alpha)
    X, Y, Z = PQ[..., 0], PQ[..., 1], PQ[..., 2]
    cache: dict[tuple[int, int, int, int], np.ndarray] = {}

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

    out = np.empty(alpha.shape + (len(idx_list),))
    for i, (t, u, v) in enumerate(idx_list):
        out[..., i] = R(0, t, u, v)
    return out


# -------------------------------------------------------- shell-pair classes
class _PairClass:
    """All shell pairs with identical (la, ka, lb, kb) signature, batched."""

    def __init__(self, shells: list[Shell], pairs: list[tuple[int, int]]):
        i0 = [p[0] for p in pairs]
        j0 = [p[1] for p in pairs]
        sa, sb = shells[i0[0]], shells[j0[0]]
        self.la, self.lb = sa.l, sb.l
        self.ka, self.kb = len(sa.exps), len(sb.exps)
        self.pairs = pairs
        self.n = len(pairs)
        self.ao_a = np.array([shells[i].ao_offset for i in i0])
        self.ao_b = np.array([shells[j].ao_offset for j in j0])
        A = np.array([shells[i].center for i in i0])  # [n,3]
        B = np.array([shells[j].center for j in j0])
        a = np.array([shells[i].exps for i in i0])  # [n,ka]
        b = np.array([shells[j].exps for j in j0])
        ca = np.array([shells[i].coefs for i in i0])
        cb = np.array([shells[j].coefs for j in j0])
        # flattened primitive pairs  [n, K]
        K = self.ka * self.kb
        self.K = K
        self.a = np.repeat(a, self.kb, axis=1)  # [n,K]
        self.b = np.tile(b, (1, self.ka))
        self.cc = (np.repeat(ca, self.kb, axis=1) * np.tile(cb, (1, self.ka)))
        self.p = self.a + self.b
        self.P = (
            self.a[..., None] * A[:, None, :] + self.b[..., None] * B[:, None, :]
        ) / self.p[..., None]  # [n,K,3]
        self.A, self.B = A, B
        AB = A - B  # [n,3]
        self.AB = AB
        # per-dimension E tables: Ed[d][i][j][t] arrays [n,K]
        self.E = [
            _E_coeffs(
                self.la, self.lb, self.a, self.b, AB[:, d : d + 1]
            )
            for d in range(3)
        ]
        self.comps_a = cart_components(self.la)
        self.comps_b = cart_components(self.lb)
        self.nab = len(self.comps_a) * len(self.comps_b)
        self.Lx = self.la + self.lb

    def hermite_coefs(self):
        """H[n, K, nab, nT] combined Hermite coefficients over the sparse
        index list :func:`hermite_index_list(la+lb)`."""
        idx_list = hermite_index_list(self.Lx)
        pos = {tuv: i for i, tuv in enumerate(idx_list)}
        H = np.zeros((self.n, self.K, self.nab, len(idx_list)))
        for ia, (ax, ay, az) in enumerate(self.comps_a):
            for ib, (bx, by, bz) in enumerate(self.comps_b):
                ab = ia * len(self.comps_b) + ib
                for t in range(ax + bx + 1):
                    Ext = self.E[0][ax][bx][t]
                    for u in range(ay + by + 1):
                        Eyu = self.E[1][ay][by][u]
                        for v in range(az + bz + 1):
                            Ezv = self.E[2][az][bz][v]
                            H[:, :, ab, pos[(t, u, v)]] = Ext * Eyu * Ezv
        return H


def _group_pairs(shells: list[Shell], symmetric: bool = True):
    """Group (i,j) shell pairs (i>=j if symmetric) into classes."""
    sig = lambda s: (s.l, len(s.exps))
    groups: dict[tuple, list[tuple[int, int]]] = defaultdict(list)
    ns = len(shells)
    for i in range(ns):
        jrange = range(i + 1) if symmetric else range(ns)
        for j in jrange:
            groups[(sig(shells[i]), sig(shells[j]))].append((i, j))
    return [_PairClass(shells, prs) for prs in groups.values()]


def _sph2(mol, M):
    """Apply the spherical transform on both indices (identity if cart)."""
    T = getattr(mol, "c2s", None)
    return M if T is None else T @ M @ T.T


def _sph_eri(mol, eri):
    T = getattr(mol, "c2s", None)
    if T is None:
        return eri
    # Four single-index transforms as large dgemms: transform the LAST
    # axis (contiguous, no copy needed), then roll axes so each index
    # takes its turn last.  ~10x faster than a fused einsum at
    # 100+-AO scale and never materializes more than one intermediate.
    out = eri
    for _ in range(4):
        shp = out.shape[:-1]
        out = (out.reshape(-1, out.shape[-1]) @ T.T).reshape(
            shp + (T.shape[0],)
        )
        out = np.ascontiguousarray(np.moveaxis(out, -1, 0))
    return out


def cross_overlap(mol1: Mole, mol2: Mole) -> np.ndarray:
    """Overlap between the AO bases of two molecules (same geometry allowed).

    Replacement for pyscf's intor_cross("int1e_ovlp", mol1, mol2) as used by
    the IAO construction (reference molbe/lo.py:get_xovlp).
    """
    out = np.zeros((mol1.nao_cart, mol2.nao_cart))
    for s1 in mol1.shells:
        for s2 in mol2.shells:
            pc = _PairClass([s1, s2], [(0, 1)])
            val = _pair_overlap(pc)[0]
            n1, n2 = val.shape
            out[
                s1.ao_offset : s1.ao_offset + n1,
                s2.ao_offset : s2.ao_offset + n2,
            ] = val
    T1 = getattr(mol1, "c2s", None)
    T2 = getattr(mol2, "c2s", None)
    if T1 is not None:
        out = T1 @ out
    if T2 is not None:
        out = out @ T2.T
    return out


# ------------------------------------------------------------- 1e integrals
def overlap(mol: Mole) -> np.ndarray:
    S = np.zeros((mol.nao_cart, mol.nao_cart))
    for pc in _group_pairs(mol.shells):
        val = _pair_overlap(pc)
        _scatter_2idx(S, pc, val, hermitian=True)
    return _sph2(mol, S)


def _pair_overlap(pc: _PairClass) -> np.ndarray:
    """[n, na, nb] contracted overlap for a pair class."""
    pref = (np.pi / pc.p) ** 1.5 * pc.cc  # [n,K]
    out = np.zeros((pc.n, len(pc.comps_a), len(pc.comps_b)))
    for ia, (ax, ay, az) in enumerate(pc.comps_a):
        for ib, (bx, by, bz) in enumerate(pc.comps_b):
            val = (
                pc.E[0][ax][bx][0] * pc.E[1][ay][by][0] * pc.E[2][az][bz][0]
            )
            out[:, ia, ib] = np.sum(pref * val, axis=1)
    return out


def kinetic(mol: Mole) -> np.ndarray:
    T = np.zeros((mol.nao_cart, mol.nao_cart))
    for pc in _group_pairs(mol.shells):
        val = _pair_kinetic(pc)
        _scatter_2idx(T, pc, val, hermitian=True)
    return _sph2(mol, T)


def _pair_kinetic(pc: _PairClass) -> np.ndarray:
    # 1D kinetic: T(i,j) = -2b^2 S(i,j+2) + b(2j+1) S(i,j) - j(j-1)/2 S(i,j-2)
    # Build extended E tables with lb+2.
    Eext = [
        _E_coeffs(pc.la, pc.lb + 2, pc.a, pc.b, pc.AB[:, d : d + 1])
        for d in range(3)
    ]
    b = pc.b
    pref = (np.pi / pc.p) ** 1.5 * pc.cc

    def S1(d, i, j):
        if j < 0 or i < 0:
            return 0.0
        return Eext[d][i][j][0]

    def T1(d, i, j):
        val = -2.0 * b * b * S1(d, i, j + 2) + b * (2 * j + 1) * S1(d, i, j)
        if j >= 2:
            val = val - 0.5 * j * (j - 1) * S1(d, i, j - 2)
        return val

    out = np.zeros((pc.n, len(pc.comps_a), len(pc.comps_b)))
    for ia, (ax, ay, az) in enumerate(pc.comps_a):
        for ib, (bx, by, bz) in enumerate(pc.comps_b):
            val = (
                T1(0, ax, bx) * S1(1, ay, by) * S1(2, az, bz)
                + S1(0, ax, bx) * T1(1, ay, by) * S1(2, az, bz)
                + S1(0, ax, bx) * S1(1, ay, by) * T1(2, az, bz)
            )
            out[:, ia, ib] = np.sum(pref * val, axis=1)
    return out


def nuclear_attraction(mol: Mole) -> np.ndarray:
    V = np.zeros((mol.nao_cart, mol.nao_cart))
    coords = mol.atom_coords()
    Z = mol.atom_charges().astype(np.float64)
    for pc in _group_pairs(mol.shells):
        L = pc.Lx
        idx_list = hermite_index_list(L)
        H = pc.hermite_coefs()  # [n,K,nab,nT]
        acc = np.zeros((pc.n, pc.K, len(idx_list)))
        for C, Zc in zip(coords, Z):
            PC = pc.P - C  # [n,K,3]
            acc -= Zc * _R_sparse(idx_list, L, pc.p, PC)  # [n,K,nT]
        pref = 2.0 * np.pi / pc.p * pc.cc  # [n,K]
        val = np.einsum("nkat,nkt,nk->na", H, acc, pref, optimize=True)
        val = val.reshape(pc.n, len(pc.comps_a), len(pc.comps_b))
        _scatter_2idx(V, pc, val, hermitian=True)
    return _sph2(mol, V)


def core_hamiltonian(mol: Mole) -> np.ndarray:
    h = kinetic(mol) + nuclear_attraction(mol)
    if getattr(mol, "ecp", None):
        from quemb_tpu.chem.ecp import ecp_matrix

        h = h + ecp_matrix(mol)
    return h


def dipole(mol: Mole) -> np.ndarray:
    """Dipole (position) integrals <mu| r |nu> about the origin, [3, nao, nao]."""
    out = np.zeros((3, mol.nao, mol.nao))
    for pc in _group_pairs(mol.shells):
        pref = (np.pi / pc.p) ** 1.5 * pc.cc  # [n,K]
        P = pc.P  # [n,K,3]
        for d in range(3):
            val = np.zeros((pc.n, len(pc.comps_a), len(pc.comps_b)))
            for ia, ca in enumerate(pc.comps_a):
                for ib, cb in enumerate(pc.comps_b):
                    e0 = [pc.E[k][ca[k]][cb[k]][0] for k in range(3)]
                    # <x> factor in dimension d: E_1 + P_d E_0
                    i, j = ca[d], cb[d]
                    E1 = (
                        pc.E[d][i][j][1]
                        if i + j >= 1
                        else np.zeros_like(e0[d])
                    )
                    mom = E1 + P[:, :, d] * pc.E[d][i][j][0]
                    prod = mom
                    for k in range(3):
                        if k != d:
                            prod = prod * e0[k]
                    val[:, ia, ib] = np.sum(pref * prod, axis=1)
            _scatter_2idx(out[d], pc, val, hermitian=True)
    return out


def _scatter_2idx(M, pc: _PairClass, val, hermitian=True):
    na, nb = len(pc.comps_a), len(pc.comps_b)
    for ia in range(na):
        for ib in range(nb):
            M[pc.ao_a + ia, pc.ao_b + ib] = val[:, ia, ib]
            if hermitian:
                M[pc.ao_b + ib, pc.ao_a + ia] = val[:, ia, ib]


# ------------------------------------------------------------- 2e integrals
def eri_full(
    mol: Mole, chunk: int = 4096, screen_thresh: float = 1e-14
) -> np.ndarray:
    """Full dense (mu nu | la si) ERI tensor, chemist's notation.

    Uses Schwarz screening ``|(ab|cd)| <= sqrt((ab|ab)(cd|cd))`` to skip
    negligible shell quartets.
    """
    from quemb_tpu.native import eri_native

    if eri_native.available():
        return _sph_eri(mol, eri_native.eri_full_cart(mol, screen_thresh))
    shells = mol.shells
    classes = _group_pairs(shells)
    nao = mol.nao_cart
    eri = np.zeros((nao, nao, nao, nao))
    # global pair index for symmetry-unique quartet selection
    offset = 0
    for pc in classes:
        pc._gidx = np.arange(offset, offset + pc.n)
        offset += pc.n
        pc._H = pc.hermite_coefs()
    for pc in classes:
        diag = _eri_quartets(pc, pc, np.arange(pc.n), np.arange(pc.n))
        pc._schwarz = np.sqrt(np.abs(diag).max(axis=(1, 2)))  # [n]
    for ic, pc1 in enumerate(classes):
        for pc2 in classes[: ic + 1]:
            _eri_class_pair(eri, pc1, pc2, chunk, screen_thresh)
    return _sph_eri(mol, eri)


def _eri_class_pair(
    eri, pc1: _PairClass, pc2: _PairClass, chunk: int, screen_thresh: float
):
    # unique quartets: global bra pair >= global ket pair, Schwarz-screened
    gi = pc1._gidx
    gj = pc2._gidx
    bi, ki = np.meshgrid(np.arange(pc1.n), np.arange(pc2.n), indexing="ij")
    mask = gi[bi] >= gj[ki]
    mask &= pc1._schwarz[bi] * pc2._schwarz[ki] > screen_thresh
    bi, ki = bi[mask], ki[mask]
    for s in range(0, bi.size, chunk):
        sl = slice(s, min(s + chunk, bi.size))
        val = _eri_quartets(pc1, pc2, bi[sl], ki[sl])
        _scatter_eri(eri, pc1, pc2, bi[sl], ki[sl], val)


def _combined_hermite_map(L1: int, L2: int):
    """Positions of idx1+idx2 in hermite_index_list(L1+L2) and ket signs."""
    i1 = hermite_index_list(L1)
    i2 = hermite_index_list(L2)
    pos = {tuv: i for i, tuv in enumerate(hermite_index_list(L1 + L2))}
    cmap = np.empty((len(i1), len(i2)), dtype=np.int64)
    for a, t1 in enumerate(i1):
        for b, t2 in enumerate(i2):
            cmap[a, b] = pos[(t1[0] + t2[0], t1[1] + t2[1], t1[2] + t2[2])]
    sgn = np.array([(-1.0) ** sum(tuv) for tuv in i2])
    return cmap, sgn


def _eri_quartets(pc1: _PairClass, pc2: _PairClass, b, k) -> np.ndarray:
    """Contracted ERIs for the given (bra-pair, ket-pair) index arrays.

    Returns [nq, nab, ncd].
    """
    L1, L2 = pc1.Lx, pc2.Lx
    cmap, sgn = _combined_hermite_map(L1, L2)
    p = pc1.p[b]  # [nq,K1]
    q = pc2.p[k]  # [nq,K2]
    P = pc1.P[b]  # [nq,K1,3]
    Q = pc2.P[k]  # [nq,K2,3]
    psum = p[:, :, None] + q[:, None, :]
    alpha = p[:, :, None] * q[:, None, :] / psum  # [nq,K1,K2]
    PQ = P[:, :, None, :] - Q[:, None, :, :]  # [nq,K1,K2,3]
    pref = (
        2.0
        * np.pi**2.5
        / (p[:, :, None] * q[:, None, :] * np.sqrt(psum))
        * pc1.cc[b][:, :, None]
        * pc2.cc[k][:, None, :]
    )  # [nq,K1,K2]
    Rsp = _R_sparse(hermite_index_list(L1 + L2), L1 + L2, alpha, PQ)
    Rsp *= pref[..., None]  # [nq,K1,K2,nTall]
    Rg = Rsp[..., cmap]  # [nq,K1,K2,T1,T2]
    H1 = pc1._H[b]  # [nq,K1,nab,T1]
    H2 = pc2._H[k] * sgn[None, None, None, :]  # [nq,K2,ncd,T2]
    tmp = np.einsum("qlcs,qklts->qktc", H2, Rg, optimize=True)
    return np.einsum("qkat,qktc->qac", H1, tmp, optimize=True)


def _scatter_eri(eri, pc1, pc2, b, k, val):
    na, nb = len(pc1.comps_a), len(pc1.comps_b)
    nc, nd = len(pc2.comps_a), len(pc2.comps_b)
    val = val.reshape(-1, na, nb, nc, nd)
    ia = pc1.ao_a[b]
    jb = pc1.ao_b[b]
    kc = pc2.ao_a[k]
    ld = pc2.ao_b[k]
    for a in range(na):
        for bb_ in range(nb):
            for c in range(nc):
                for d in range(nd):
                    v = val[:, a, bb_, c, d]
                    i_, j_, k_, l_ = ia + a, jb + bb_, kc + c, ld + d
                    eri[i_, j_, k_, l_] = v
                    eri[j_, i_, k_, l_] = v
                    eri[i_, j_, l_, k_] = v
                    eri[j_, i_, l_, k_] = v
                    eri[k_, l_, i_, j_] = v
                    eri[l_, k_, i_, j_] = v
                    eri[k_, l_, j_, i_] = v
                    eri[l_, k_, j_, i_] = v


# ----------------------------------------------------- DF integrals (2c/3c)
def _single_shell_pairs(shells: list[Shell]):
    """Pair classes of (shell, dummy) - a unit s-gaussian with exponent 0.

    With the dummy partner the Hermite machinery reduces to the single-shell
    expansion, so 2c/3c Coulomb integrals reuse the 4c code path.
    """
    from collections import defaultdict

    groups = defaultdict(list)
    for i, sh in enumerate(shells):
        groups[(sh.l, len(sh.exps))].append(i)
    classes = []
    for idxs in groups.values():
        sh0 = shells[idxs[0]]
        aug = []
        for i in idxs:
            sh = shells[i]
            dummy = Shell(
                l=0,
                exps=np.array([0.0]),
                coefs=np.array([1.0]),
                center=sh.center,
                atom_idx=sh.atom_idx,
                ao_offset=0,
            )
            aug.append((sh, dummy))
        flat = [s for pair in aug for s in pair]
        pc = _PairClass(flat, [(2 * k, 2 * k + 1) for k in range(len(aug))])
        classes.append(pc)
    return classes


def int2c2e(mol_aux: Mole) -> np.ndarray:
    """(P|Q) Coulomb metric over the auxiliary basis."""
    from quemb_tpu.native import eri_native

    if eri_native.available():
        return _sph2(mol_aux, eri_native.int2c2e_cart(mol_aux))
    classes = _single_shell_pairs(mol_aux.shells)
    offset = 0
    for pc in classes:
        pc._gidx = np.arange(offset, offset + pc.n)
        offset += pc.n
        pc._H = pc.hermite_coefs()
    naux = getattr(mol_aux, "nao_cart", mol_aux.nao)
    out = np.zeros((naux, naux))
    for pc1 in classes:
        for pc2 in classes:
            b, k = np.meshgrid(
                np.arange(pc1.n), np.arange(pc2.n), indexing="ij"
            )
            val = _eri_quartets(pc1, pc2, b.ravel(), k.ravel())
            na, nc = len(pc1.comps_a), len(pc2.comps_a)
            val = val.reshape(pc1.n, pc2.n, na, 1, nc, 1)
            for ia in range(na):
                for ic in range(nc):
                    out[
                        pc1.ao_a[:, None] + ia, pc2.ao_a[None, :] + ic
                    ] = val[:, :, ia, 0, ic, 0]
    return _sph2(mol_aux, out)


def int3c2e(mol: Mole, mol_aux: Mole, chunk: int = 4096) -> np.ndarray:
    """(mu nu | P) three-center two-electron integrals, [nao, nao, naux]."""
    from quemb_tpu.native import eri_native

    if eri_native.available():
        out = eri_native.int3c2e_cart(mol, mol_aux)
        T = getattr(mol, "c2s", None)
        if T is not None:
            out = np.einsum("mnp,im,jn->ijp", out, T, T, optimize=True)
        Ta = getattr(mol_aux, "c2s", None)
        if Ta is not None:
            out = out @ Ta.T
        return out
    pair_classes = _group_pairs(mol.shells)
    aux_classes = _single_shell_pairs(mol_aux.shells)
    for pc in pair_classes + aux_classes:
        pc._H = pc.hermite_coefs()
    nao, naux = mol.nao_cart, getattr(mol_aux, "nao_cart", mol_aux.nao)
    out = np.zeros((nao, nao, naux))
    for pc1 in pair_classes:
        for pc2 in aux_classes:
            bi, ki = np.meshgrid(
                np.arange(pc1.n), np.arange(pc2.n), indexing="ij"
            )
            bi, ki = bi.ravel(), ki.ravel()
            for s in range(0, bi.size, chunk):
                sl = slice(s, min(s + chunk, bi.size))
                val = _eri_quartets(pc1, pc2, bi[sl], ki[sl])
                na, nb = len(pc1.comps_a), len(pc1.comps_b)
                nc = len(pc2.comps_a)
                val = val.reshape(-1, na, nb, nc)
                ia = pc1.ao_a[bi[sl]]
                jb = pc1.ao_b[bi[sl]]
                kc = pc2.ao_a[ki[sl]]
                for a in range(na):
                    for b_ in range(nb):
                        for c in range(nc):
                            v = val[:, a, b_, c]
                            out[ia + a, jb + b_, kc + c] = v
                            out[jb + b_, ia + a, kc + c] = v
    T = getattr(mol, "c2s", None)
    if T is not None:
        out = np.einsum("mnp,im,jn->ijp", out, T, T, optimize=True)
    Ta = getattr(mol_aux, "c2s", None)
    if Ta is not None:
        out = out @ Ta.T
    return out
