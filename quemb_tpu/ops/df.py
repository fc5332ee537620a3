"""Density-fitted integral machinery (reference L4: eri_onthefly.py,
eri_sparse_DF.py + _cpp/eri_sparse_DF.cpp).

The device formulation: the 3-center factor ``B[P, mu, nu]`` lives in
device memory; each fragment's (ij|kl) is two GEMM quarter-transforms
``(P|ij) = TA^T (P|mu nu) TA`` followed by a triangular solve against the
Cholesky factor of the metric and one Gram matmul - the direct analog of the
reference's C++ ``transform_integral`` (eri_sparse_DF.cpp:739) with dense
blocked tensors instead of CPU sparse maps.

The auxiliary basis can be a tabulated set or generated even-tempered
("autoaux") from the orbital basis.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
import scipy.linalg

from quemb_tpu.chem import integrals
from quemb_tpu.chem.mole import Mole


def make_even_tempered_auxbasis(mol: Mole, beta: float = 1.8) -> Mole:
    """Even-tempered auxiliary basis generated from the orbital basis
    (the pyscf ``aug_etb`` recipe).

    Per atom: collect min/max orbital exponents PER angular momentum,
    then for each auxiliary l up to 2*l_max span the geometric-mean
    range over (l1, l2) pairs with l1+l2 == l (max doubled: alpha+alpha
    products on one center) with ratio ``beta``.  Per-l ranges keep the
    set compact for polarized bases (a flat [2min, 2max] range for every
    l explodes for cc-pVDZ-class sets) while covering the actual density
    products.
    """
    aux = Mole.__new__(Mole)
    aux.basis = "autoaux"
    aux.charge = mol.charge
    aux.spin = mol.spin
    aux._atoms = list(mol._atoms)
    from quemb_tpu.chem.mole import Shell, _normalize_contraction, ncart

    shells = []
    offset = 0
    aux._aoslice = []
    for ia in range(mol.natm):
        start = offset
        at_shells = [sh for sh in mol.shells if sh.atom_idx == ia]
        lmax = max(sh.l for sh in at_shells)
        emin_l = np.full(lmax + 1, np.inf)
        emax_l = np.zeros(lmax + 1)
        for sh in at_shells:
            emin_l[sh.l] = min(emin_l[sh.l], float(np.min(sh.exps)))
            emax_l[sh.l] = max(emax_l[sh.l], float(np.max(sh.exps)))
        # floor of l_aux = 2 so even s-only atoms (H) get p/d fitting
        # functions (pure 2*l_max starves hydrogen-rich systems)
        for laux in range(max(2 * lmax, 2) + 1):
            pairs = [
                (l1, l2)
                for l1 in range(lmax + 1)
                for l2 in range(lmax + 1)
                if l1 + l2 == laux
            ] or [
                (l1, l2)
                for l1 in range(lmax + 1)
                for l2 in range(lmax + 1)
            ]
            emin = min(
                np.sqrt(emin_l[l1] * emin_l[l2]) for l1, l2 in pairs
            )
            emax = max(
                np.sqrt(emax_l[l1] * emax_l[l2]) for l1, l2 in pairs
            ) * 2.0
            n = max(1, int(np.ceil(np.log(emax / emin) / np.log(beta))))
            for a in emin * beta ** np.arange(n):
                coefs = _normalize_contraction(laux, [a], [1.0])
                shells.append(
                    Shell(
                        laux, np.array([a]), coefs,
                        np.asarray(mol._atoms[ia][1]), ia, offset,
                    )
                )
                offset += ncart(laux)
        aux._aoslice.append((start, offset))
    aux.shells = shells
    aux.nao = offset
    return aux


def cholesky_df_factor(
    mol: Mole, tol: float = 1.0e-10, eri: np.ndarray | None = None
) -> np.ndarray:
    """Pivoted-Cholesky (Beebe-Linderberg) three-index factor.

    Decomposes the ERI supermatrix M[(mu nu),(la si)] = (mu nu|la si) as
    M ~ L L^T by diagonal-pivoted Cholesky, stopping when the largest
    residual diagonal falls below ``tol`` -- so the factorization error
    of EVERY ERI element is bounded by ``tol`` (the residual is PSD, so
    |R_ij| <= sqrt(R_ii R_jj) <= tol).  Returns B [rank, nao, nao],
    drop-in compatible with the aux-basis whitened factor of
    :class:`DFTensor`.

    This is the high-accuracy alternative to tabulated Coulomb-fitting
    sets (reference: ``auxbasis="weigend"``, asserted at atol 1e-10 in
    tests/test_eri_sparse_DF.py:28-44): no published JFIT tables ship in
    this environment, and a threshold-controlled CD meets or exceeds
    their fitting accuracy by construction.  Needs the in-core ERI (or
    one computed here), so it is a *compression*, not a memory-bounded
    generation path; use the even-tempered aux sets when the 4-index ERI
    cannot be held.
    """
    if eri is None:
        eri = integrals.eri_full(mol)
    n = eri.shape[0]
    M = np.ascontiguousarray(np.asarray(eri, np.float64).reshape(
        n * n, n * n
    ))
    d = np.diagonal(M).copy()
    max_rank = n * n
    L = np.zeros((max_rank, n * n))
    piv_mask = np.ones(n * n, bool)
    rank = 0
    while rank < max_rank:
        dm = np.where(piv_mask, d, -np.inf)
        p = int(np.argmax(dm))
        dp = dm[p]
        if dp < tol:
            break
        col = M[:, p] - L[:rank].T @ L[:rank, p]
        ell = col / np.sqrt(dp)
        L[rank] = ell
        d = d - ell * ell
        piv_mask[p] = False
        rank += 1
    return L[:rank].reshape(rank, n, n)


def resolve_auxbasis(mol: Mole, spec):
    """Resolve an ``auxbasis`` argument to a concrete factorization recipe.

    Returns ("mol", auxmol) for metric-whitened aux-basis DF or
    ("cholesky", tol) for the pivoted-CD factor.  Accepted specs:

    - None / Mole        : even-tempered autoaux / explicit aux molecule
    - "autoaux"/"etb"    : even-tempered recipe (optionally "etb:<beta>")
    - "cholesky"         : pivoted CD at 1e-10 (or "cholesky:<tol>")
    - "weigend", "def2-universal-jfit": the reference's Coulomb-fitting
      tables are not shipped in this environment; resolves to the CD
      factor at 1e-10 -- which bounds every ERI element error at 1e-10,
      meeting the accuracy the reference asserts for these sets
      (tests/test_eri_sparse_DF.py:28-44) -- with a loud notice.
    """
    if spec is None:
        return "mol", make_even_tempered_auxbasis(mol)
    if isinstance(spec, Mole):
        return "mol", spec
    s = str(spec).lower()
    if s.startswith(("etb", "autoaux")):
        beta = float(s.split(":", 1)[1]) if ":" in s else 1.8
        return "mol", make_even_tempered_auxbasis(mol, beta=beta)
    if s.startswith("cholesky"):
        tol = float(s.split(":", 1)[1]) if ":" in s else 1.0e-10
        return "cholesky", tol
    if s in ("weigend", "weigend+etb", "def2-universal-jfit", "jfit"):
        import logging

        logging.getLogger(__name__).warning(
            "auxbasis=%r: tabulated Coulomb-fitting sets are not available"
            " in this environment; using the pivoted-Cholesky factor at"
            " tol=1e-10, which bounds every fitted ERI element error by"
            " 1e-10 (at least the tabulated sets' accuracy).", spec,
        )
        return "cholesky", 1.0e-10
    raise ValueError(f"unknown auxbasis spec: {spec!r}")


class DFTensor:
    """Cholesky-whitened 3-center factor: eri ~ sum_P B[P,mu,nu] B[P,la,si].

    ``auxmol`` accepts anything :func:`resolve_auxbasis` does: an aux
    Mole, None (even-tempered autoaux), "etb:<beta>", "cholesky[:tol]",
    or "weigend" (CD-backed, see resolve_auxbasis).
    """

    def __init__(self, mol: Mole, auxmol: Mole | str | None = None):
        self.mol = mol
        kind, arg = resolve_auxbasis(mol, auxmol)
        if kind == "cholesky":
            self.auxmol = None
            self.B = cholesky_df_factor(mol, tol=arg)
            self.naux = self.B.shape[0]
            return
        self.auxmol = arg
        J = integrals.int2c2e(self.auxmol)  # (P|Q)
        P3 = integrals.int3c2e(mol, self.auxmol)  # [nao, nao, naux]
        naux = self.auxmol.nao
        rhs = P3.reshape(-1, naux).T  # [naux, nao*nao]
        # Whiten against the metric; ETB sets can be near-linearly-dependent,
        # so use the eigh pseudo-inverse square root (the reference's
        # cholesky-or-eig fallback, kbe/eri_onthefly.py:18).
        try:
            L = scipy.linalg.cholesky(J, lower=True)
            B = scipy.linalg.solve_triangular(L, rhs, lower=True)
        except np.linalg.LinAlgError:
            w, V = np.linalg.eigh(J)
            keep = w > 1e-10 * w.max()
            B = (V[:, keep] / np.sqrt(w[keep])).T @ rhs
            naux = int(keep.sum())
        self.B = B.reshape(naux, mol.nao, mol.nao)
        self.naux = naux

    def eri_full(self) -> np.ndarray:
        """Dense 4-center ERI reconstructed from the DF factors."""
        B = self.B.reshape(self.naux, -1)
        eri = B.T @ B
        n = self.mol.nao
        return eri.reshape(n, n, n, n)


# Byte budget for the [chunk, nemb, nao] quarter-transform intermediate:
# above it the aux axis is scanned in chunks (hundreds of aux rows at
# C40/etb scale, naux=3460, nao=282), which bounds the live footprint of
# a vmapped bucket.  The value is kept until it is derived from the
# device's memory and the operand shapes.
_DF_CHUNK_BYTES = 64e6


@jax.jit
def df_fragment_eri(B, TA):
    """(ij|kl) for one fragment from the whitened DF factor.

    B: [naux, nao, nao]; TA: [nao, nemb].  Two GEMM quarter
    transforms + one Gram matmul (the dense analog of the reference's
    eri_sparse_DF.cpp:739 ``transform_integral``), aux-chunked with a
    ``lax.scan`` accumulation when the [naux, nemb, nao] intermediate
    would exceed ``_DF_CHUNK_BYTES``.
    """
    naux, nao, _ = B.shape
    nemb = TA.shape[1]
    if naux * nemb * nao * 8 <= _DF_CHUNK_BYTES:
        Bi = jnp.einsum("pmn,mi->pin", B, TA)
        Bij = jnp.einsum("pin,nj->pij", Bi, TA)
        Bf = Bij.reshape(naux, nemb * nemb)
        eri = Bf.T @ Bf
        return eri.reshape(nemb, nemb, nemb, nemb)
    chunk = max(1, int(_DF_CHUNK_BYTES / (nemb * nao * 8)))
    nfull = (naux // chunk) * chunk

    def quarter_gram(Bc):
        Bij = jnp.einsum("pin,nj->pij", jnp.einsum("pmn,mi->pin", Bc, TA), TA)
        Bf = Bij.reshape(Bc.shape[0], nemb * nemb)
        return Bf.T @ Bf

    eri = jnp.zeros((nemb * nemb, nemb * nemb), B.dtype)
    if nfull:
        # reshape of the leading axis is free (no padded copy of B)
        Bchunks = B[:nfull].reshape(nfull // chunk, chunk, nao, nao)
        eri, _ = jax.lax.scan(
            lambda acc, Bc: (acc + quarter_gram(Bc), None), eri, Bchunks
        )
    if nfull < naux:
        eri = eri + quarter_gram(B[nfull:])
    return eri.reshape(nemb, nemb, nemb, nemb)


def df_transform_batched(B, TA_b):
    """vmapped fragment DF transforms for a bucket of TAs [nf, nao, nemb]."""
    B = jnp.asarray(B)
    return jax.vmap(lambda TA: df_fragment_eri(B, TA))(jnp.asarray(TA_b))


def block_step_size(nao: int, naux: int, max_memory_gb: float) -> int:
    """AO-row block size for streamed DF generation under a memory budget
    (reference eri_onthefly.py:18 block_step_size): the held block is
    B_blk [naux, blk*nao] f64 plus an equally-sized integral workspace.
    """
    bytes_per_row = 2 * naux * nao * 8
    blk = int(max_memory_gb * 1e9 / max(bytes_per_row, 1))
    return max(1, min(nao, blk))


def _int3c2e_rows(mol: Mole, auxmol, row_shells: list[int]) -> np.ndarray:
    """(mu nu | P) for bra shells restricted to ``row_shells`` (all nu).

    Returns [nao_rows, nao, naux] with nao_rows = AOs of the row shells.
    """
    from quemb_tpu.chem.integrals import (
        _eri_quartets,
        _PairClass,
        _single_shell_pairs,
    )
    from collections import defaultdict

    shells = mol.shells
    row_set = list(row_shells)
    row_offsets = {}
    off = 0
    for i in row_set:
        row_offsets[i] = off
        off += shells[i].nfunc
    nao_rows = off
    nao = getattr(mol, "nao_cart", mol.nao)
    naux = getattr(auxmol, "nao_cart", auxmol.nao)

    groups = defaultdict(list)
    for i in row_set:
        for j in range(len(shells)):
            si, sj = shells[i], shells[j]
            groups[(si.l, len(si.exps), sj.l, len(sj.exps))].append((i, j))
    aux_classes = _single_shell_pairs(auxmol.shells)
    for pc2 in aux_classes:
        pc2._H = pc2.hermite_coefs()

    out = np.zeros((nao_rows, nao, naux))
    for pairs in groups.values():
        flat, prs = [], []
        for (i, j) in pairs:
            flat += [shells[i], shells[j]]
            prs.append((len(flat) - 2, len(flat) - 1))
        pc1 = _PairClass(flat, prs)
        pc1._H = pc1.hermite_coefs()
        row_off = np.array([row_offsets[i] for (i, j) in pairs])
        col_off = np.array([shells[j].ao_offset for (i, j) in pairs])
        for pc2 in aux_classes:
            bi, ki = np.meshgrid(
                np.arange(pc1.n), np.arange(pc2.n), indexing="ij"
            )
            bi, ki = bi.ravel(), ki.ravel()
            for s in range(0, bi.size, 4096):
                sl = slice(s, min(s + 4096, bi.size))
                val = _eri_quartets(pc1, pc2, bi[sl], ki[sl])
                na, nb = len(pc1.comps_a), len(pc1.comps_b)
                nc = len(pc2.comps_a)
                val = val.reshape(-1, na, nb, nc)
                ra = row_off[bi[sl]]
                cb = col_off[bi[sl]]
                kc = pc2.ao_a[ki[sl]]
                for a in range(na):
                    for b_ in range(nb):
                        for c in range(nc):
                            out[ra + a, cb + b_, kc + c] = val[:, a, b_, c]
    T = getattr(mol, "c2s", None)
    if T is not None:
        from quemb_tpu.chem.sph import c2s_matrix
        from scipy.linalg import block_diag

        Tr = block_diag(*[c2s_matrix(shells[i].l) for i in row_set])
        out = np.einsum(
            "mnp,am,bn->abp", out, Tr, T, optimize=True
        )
    Ta = getattr(auxmol, "c2s", None)
    if Ta is not None:
        out = out @ Ta.T
    return out


class StreamedDF:
    """Blocked/streamed DF factors under a memory budget.

    The whitened factor B is never materialized in full: AO-row blocks
    stream through :meth:`iter_blocks`, bounded by
    ``settings.INTEGRAL_TRANSFORM_MAX_MEMORY`` (reference
    eri_onthefly.py:18-45 blocked generation with prefetch).
    """

    def __init__(self, mol: Mole, auxmol=None, max_memory_gb=None):
        from quemb_tpu.config import settings

        self.mol = mol
        kind, arg = resolve_auxbasis(mol, auxmol)
        if kind == "cholesky":
            raise ValueError(
                "StreamedDF generates blocks from an auxiliary basis; the"
                " pivoted-Cholesky factor needs the in-core ERI and is"
                " not memory-bounded -- use DFTensor or an etb auxbasis."
            )
        self.auxmol = arg
        self.max_memory_gb = (
            max_memory_gb
            if max_memory_gb is not None
            else settings.INTEGRAL_TRANSFORM_MAX_MEMORY
        )
        J = integrals.int2c2e(self.auxmol)
        w, V = np.linalg.eigh(J)
        keep = w > 1e-10 * w.max()
        self._M = (V[:, keep] / np.sqrt(w[keep])).T  # whitener [nfit, naux]
        self.naux = int(keep.sum())

    def iter_blocks(self):
        """Yield (ao_row_indices, B_blk [naux, n_rows, nao])."""
        shells = self.mol.shells
        nao = self.mol.nao
        sph = getattr(self.mol, "c2s", None) is not None
        # per-shell AO count and offset in the PUBLIC basis (sph or cart)
        nfunc = [
            (2 * sh.l + 1) if sph else sh.nfunc for sh in shells
        ]
        offs = np.concatenate([[0], np.cumsum(nfunc)])[:-1]
        blk_rows = block_step_size(nao, self.naux, self.max_memory_gb)
        i = 0
        while i < len(shells):
            row_shells = []
            n_rows = 0
            while i < len(shells) and n_rows + nfunc[i] <= max(
                blk_rows, nfunc[i]
            ):
                row_shells.append(i)
                n_rows += nfunc[i]
                i += 1
            p3 = _int3c2e_rows(self.mol, self.auxmol, row_shells)
            B_blk = (self._M @ p3.reshape(-1, p3.shape[-1]).T).reshape(
                self.naux, n_rows, nao
            )
            rows = np.concatenate(
                [
                    np.arange(offs[s], offs[s] + nfunc[s])
                    for s in row_shells
                ]
            )
            yield rows, B_blk

    def fragment_eri(self, TA: np.ndarray) -> np.ndarray:
        """(ij|kl) accumulated over streamed row blocks (two GEMM quarter
        transforms per block + one Gram matmul at the end)."""
        TA_j = jnp.asarray(TA)
        nemb = TA.shape[1]
        Bij = jnp.zeros((self.naux, nemb, nemb))
        for rows, B_blk in self.iter_blocks():
            Bij = Bij + jnp.einsum(
                "pmn,mi,nj->pij",
                jnp.asarray(B_blk),
                TA_j[rows],
                TA_j,
                optimize=True,
            )
        Bf = Bij.reshape(self.naux, nemb * nemb)
        return np.asarray(Bf.T @ Bf).reshape(nemb, nemb, nemb, nemb)
