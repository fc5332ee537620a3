"""Production sparse-DF fragment-ERI transform (f64, screened).

Device analog of the reference's flagship performance path
(``molbe/eri_sparse_DF.py:535`` ``_run_sparse_df_driver`` +
``_cpp/eri_sparse_DF.cpp:739`` ``transform_integral``), selectable as
``BE(int_transform="sparse-DF")`` (reference ``molbe/mbe.py:1056``).

Where the reference stores (P|mu nu) as a CPU semi-sparse pair map and
runs OpenMP loops over reachable pairs, the device formulation
*compresses* instead of enumerating: the S_abs reachability screen
(:mod:`quemb_tpu.ops.screening`) selects the reachable AO subset of each
fragment, the whitened DF factor is gathered down to that subset on
device, and the transform proceeds as dense f64 GEMMs over the reduced
index — compiler-friendly static shapes, no scalar sparse bookkeeping.
FLOPs and device-memory traffic scale with (n_reach/nao)^2 of the dense
path.  Energies match in-core to the screening tolerance (reference
oracle: tests/test_eri_sparse_DF.py:31-52 at atol 1e-10 with exact
screens).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from quemb_tpu.chem.mole import Mole
from quemb_tpu.ops.df import DFTensor
from quemb_tpu.ops.screening import ao_reach_per_fragment, approx_S_abs


@partial(jax.jit, donate_argnums=())
def _screened_eri_device_2ta(Bg, TA_first, TA_second):
    """(ij|kl) from the gathered factor Bg [naux, nr, nr]: two GEMM
    quarter transforms + one Gram matmul (eri_sparse_DF.cpp:484,560,611).
    The first transform uses the per-MO-screened TA, the second the
    exact TA rows.  The result is symmetrized in (ij) so the one-sided
    screening error keeps the ERI's permutational symmetry."""
    Bi = jnp.einsum("pmn,ni->pmi", Bg, TA_first)
    Bij = jnp.einsum("pmi,mj->pij", Bi, TA_second)
    Bij = 0.5 * (Bij + jnp.swapaxes(Bij, 1, 2))
    naux, nemb, _ = Bij.shape
    Bf = Bij.reshape(naux, nemb * nemb)
    eri = Bf.T @ Bf
    return eri.reshape(nemb, nemb, nemb, nemb)


@jax.jit
def _gather_B(B, idx):
    """B[:, idx, :][:, :, idx] as a device gather (static idx length)."""
    return jnp.take(jnp.take(B, idx, axis=1), idx, axis=2)


@jax.jit
def _screened_eri_device_batched(B, idxs, TA_firsts, TA_seconds):
    """One device program for a whole (reach-size, nemb) bucket.

    The gather indices are a *batched operand* (not static), so every
    fragment whose padded reach set has the same size shares this one
    compiled program and the bucket runs as a single dispatch.
    """
    return jax.vmap(
        lambda idx, TAf, TAs: _screened_eri_device_2ta.__wrapped__(
            _gather_B.__wrapped__(B, idx), TAf, TAs
        )
    )(idxs, TA_firsts, TA_seconds)


@jax.jit
def _widen_f64(B32):
    return B32.astype(jnp.float64)


@partial(jax.jit, static_argnums=(3,))
def _band_gather_device(B, perm, col_idx, b):
    """Permute, block, and band-gather the factor ON DEVICE.

    [naux, nao, nao] (any float dtype) -> [nblk, b*naux, W] f64, the
    layout :func:`_banded_eri_bucket` consumes.  A host formulation
    makes four full passes of numpy fancy indexing over a multi-GB
    factor; on device the same gathers are memory-bound copies, and the
    factor upload can ride a compact f32 representation (see
    ``SparseDF.from_factor``).
    """
    B = B.astype(jnp.float64)
    naux, nao, _ = B.shape
    nblk, W = col_idx.shape
    Bp = jnp.take(jnp.take(B, perm, axis=1), perm, axis=2)
    pad = nblk * b - nao
    Bp = jnp.pad(Bp, ((0, 0), (0, pad), (0, 0)))
    Bp4 = Bp.reshape(naux, nblk, b, nao)
    Bb = jnp.take_along_axis(Bp4, col_idx[None, :, None, :], axis=3)
    return Bb.transpose(1, 2, 0, 3).reshape(nblk, b * naux, W)


@jax.jit
def _banded_first(Bk, TAb_all):
    """Banded first quarter transform, fragments folded into N.

    [k, (b p), W] x [k, W, (f i)] -> [k, b, p, f, i].  FLOPs
    naux*nao*W*nemb*F instead of naux*nao^2*nemb*F, and the folded
    N = F*nemb gives the GEMM a wide N where a per-fragment N = nemb
    GEMM is skinny.
    """
    nblk, xdim, W = Bk.shape
    _, _, FN = TAb_all.shape
    T = jnp.einsum("kxw,kwn->kxn", Bk, TAb_all)
    return T  # [k, (b p), (f i)]


@partial(jax.jit, static_argnums=(3,))
def _banded_second(T, TAp_f, f, nemb):
    """Second quarter transform + symmetrize + Gram for ONE fragment.

    ``f`` is a traced index (lax.dynamic_slice under jit), so every
    fragment of a bucket shares one compiled program.  Fusing the whole
    bucket (first GEMM + F unrolled seconds) into a single jit makes
    XLA compile for minutes at C40 scale; split, the two programs
    compile in seconds and the half-transformed factor T stays on
    device between them.
    """
    nblk, xdim, _FN = T.shape
    b = TAp_f.shape[0] // nblk
    naux = xdim // b
    # T columns for fragment f: [k, (b p), nemb] ((f i) layout, f outer)
    Tf = jax.lax.dynamic_slice_in_dim(T, f * nemb, nemb, axis=2)
    # [(k b), (p i)] is a pure reshape (b outer of p in x; i inner):
    # the contraction index (k b) then meets TAp_f rows as a transposed
    # GEMM -- no materialized transpose
    Tf = Tf.reshape(nblk * b, naux * nemb)
    Bij = (Tf.T @ TAp_f).reshape(naux, nemb, nemb)  # [p, i, j]
    Bij = 0.5 * (Bij + jnp.swapaxes(Bij, 1, 2))
    Bf = Bij.reshape(naux, nemb * nemb)
    return (Bf.T @ Bf).reshape(nemb, nemb, nemb, nemb)


def _banded_eri_bucket(Bk, TAb_all, TAps_pad):
    """Pair-screened fragment ERIs via the banded first quarter transform.

    ``Bk`` is the RCM-permuted whitened DF factor pre-gathered down to
    each b-row block's reachable column band and laid out
    [nblk, b*naux, W] with the block-row index OUTSIDE the aux index
    (built once per molecule in :meth:`SparseDF._ensure_banded_factor`).
    ``TAb_all[k, w, f*nemb+i]`` holds the band rows of every fragment's
    RCM-permuted basis, gathered ON THE HOST (the gather moves only the
    tiny TA matrices, and a device ``take`` here both bloated XLA
    compile to minutes and broke GEMM fusion); ``TAps_pad`` is the
    zero-padded permuted basis stack [F, nblk*b, nemb].

    The program is pure GEMMs with no gathers and no transpose copies:

    - first (banded, fragments FOLDED into the N axis):  bmm over row
      blocks k, [b*naux, W] x [W, F*nemb] — FLOPs
      naux*nao*W*nemb*F instead of naux*nao^2*nemb*F, and the folded
      N = F*nemb gives the GEMM a wide N where a per-fragment
      N = nemb GEMM is skinny.  Output [k, (b p), (f i)].
    - second (exact, per fragment):  slice fragment f (a cheap strided
      copy, ~nao*naux*nemb doubles), flatten to [(k b), (p i)] — free,
      k,b and p,i are already adjacent — and contract the padded AO
      index against TAp rows: [(p i), (k b)] x [(k b), j].

    Rejected formulations, for the record: a ``lax.scan`` over row
    blocks kept the intermediate tiny but serialized nblk dependent
    skinny GEMMs (eating the band_fraction FLOP win, plus minutes of
    XLA compile); vmapping fragments over the whole program made XLA
    materialize a fragment-major transpose copy of the half-transformed
    factor (tens of GB at C40); fusing first + unrolled seconds into
    ONE jit took minutes of XLA compile at C40.
    Split as :func:`_banded_first` + :func:`_banded_second` (fragment
    index traced), the two programs compile in seconds, the live
    footprint is Bk + one [nblk*b, naux*F*nemb] half transform, and
    the composition here stays on device between the calls.

    ``TAp`` rows beyond the band only ever ADD pairs vs the
    S_abs >= eps screen (band clipping), so accuracy is bounded by the
    same screen.  Symmetrization + Gram as in
    :func:`_screened_eri_device_2ta`.

    Returns a LIST of device arrays (one [nemb^4] ERI per fragment) —
    callers fetch or keep on device as they need.
    """
    F, nao_pad, nemb = TAps_pad.shape
    T = _banded_first(Bk, TAb_all)
    return [
        _banded_second(T, TAps_pad[f], f, nemb) for f in range(F)
    ]


class SparseDF:
    """Screened DF transformer: S_abs screen + reachable-subset gather.

    Two independent screens, with the reference's production defaults
    (``molbe/mbe.py:191-192``):

    - ``mo_eps`` (reference ``MO_coeff_epsilon = 1e-5``): the per-MO
      reachability threshold of :func:`ao_reach_per_fragment` (the C++
      ``get_AO_per_MO`` epsilon, eri_sparse_DF.cpp:443).  AO nu feeds
      MO i only if (S_abs |TA|)[nu, i] >= mo_eps.
    - ``ao_eps`` (reference ``AO_coeff_epsilon = 1e-10``): the geometric
      AO-pair screen S_abs[mu, nu] >= ao_eps (``_get_AO_per_AO``,
      eri_sparse_DF.py:227) that the banded first transform's RCM band
      is built from.

    ``screen_eps`` (legacy single knob) overrides both when given —
    the pre-split behavior, kept for the tight-screen exactness tests.
    Smaller eps keeps more AOs (tighter energies, more FLOPs).
    """

    def __init__(
        self,
        mol: Mole,
        auxmol: Mole | None = None,
        screen_eps: float | None = None,
        *,
        mo_eps: float = 1.0e-5,
        ao_eps: float = 1.0e-10,
    ):
        if screen_eps is not None:
            mo_eps = ao_eps = screen_eps
        self.mol = mol
        self.mo_eps = mo_eps
        self.ao_eps = ao_eps
        # legacy alias (bench/tests read it); the MO screen is the one
        # that bounds the union-gather accuracy
        self.screen_eps = mo_eps
        self.dft = DFTensor(mol, auxmol)
        self._init_common()

    @classmethod
    def from_factor(
        cls,
        mol: Mole,
        B: np.ndarray,
        *,
        mo_eps: float = 1.0e-5,
        ao_eps: float = 1.0e-10,
        device_upload: str | None = None,
    ) -> "SparseDF":
        """Screened transforms over a precomputed whitened factor.

        ``B`` is a [naux, nao, nao] factor with eri ~ B^T B (e.g. a
        :class:`DFTensor` factor saved to disk), so callers that amortize
        integral generation + metric whitening across runs skip both.
        The screen plans are rebuilt from the molecule as usual.
        """
        self = cls.__new__(cls)
        self.mol = mol
        self.mo_eps = mo_eps
        self.ao_eps = ao_eps
        self.screen_eps = mo_eps

        class _Factor:
            pass

        self.dft = _Factor()
        if device_upload == "f32-widen":
            # Quantize the factor to the f32 mantissa and copy THAT to
            # the device, widening to f64 there: the host-to-device
            # copy moves half the bytes, and the host copy is widened
            # identically so host and device see bit-equal factors.  The quantization perturbs the FIT by ~1e-7
            # relative -- below any auxiliary-basis fit error -- and the
            # screened-vs-dense transform agreement is exact either way
            # (both sides consume the same factor).
            B32 = np.ascontiguousarray(np.asarray(B, np.float32))
            self.dft.B = B32.astype(np.float64)
            self._B32_dev = jnp.asarray(B32)
        elif device_upload not in (None, "f64"):
            raise ValueError(f"device_upload={device_upload}")
        else:
            self.dft.B = np.ascontiguousarray(B)
        self.dft.naux = B.shape[0]
        self._init_common()
        return self

    def _init_common(self):
        self.naux = self.dft.naux
        self.S_abs = approx_S_abs(self.mol)
        # diagnostics for bench/logging
        self.last_reach_fraction: float | None = None
        self.band_fraction: float | None = None

    @property
    def _B_dev(self):
        """Dense whitened factor on device — created lazily, ONLY for
        the union-gather path.  In the banded regime the factor lives in
        device memory only in its banded layout (band_fraction of the
        dense size), so a dense copy is never kept beside it."""
        if not hasattr(self, "_B_dev_cache"):
            if hasattr(self, "_B32_dev"):
                # widen the resident compact factor on device: no second
                # host->device transfer, bit-equal to the host f64 copy
                self._B_dev_cache = _widen_f64(self._B32_dev)
            else:
                self._B_dev_cache = jnp.asarray(self.dft.B)
        return self._B_dev_cache

    def reach(self, TA: np.ndarray) -> np.ndarray:
        return ao_reach_per_fragment(self.S_abs, TA, eps=self.mo_eps)

    def _band_plan(self):
        """Banded pair-screen plan (computed once per molecule).

        The reference's effective sparse-DF screen is the *geometric*
        AO-pair screen S_abs[mu, nu] >= eps (``_get_AO_per_AO``,
        eri_sparse_DF.py:227 -- no MO coefficients involved), which on
        extended systems keeps O(N) pairs.  The device formulation makes
        that pair set a *band*: reverse-Cuthill-McKee orders the AOs so
        every significant pair sits within a fixed bandwidth W (set by
        the screen's physical range, independent of system size), and
        the first quarter transform becomes a static-shape batched GEMM
        over row blocks x their column bands.

        Returns (perm, col_idx[nblk, W], b, W) or None when banding
        cannot beat the dense path (W ~ nao on compact molecules).
        """
        if hasattr(self, "_band_cache"):
            return self._band_cache
        import scipy.sparse as _sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        nao = self.mol.nao
        b = 8
        A = self.S_abs >= self.ao_eps
        perm = np.asarray(
            reverse_cuthill_mckee(_sp.csr_matrix(A), symmetric_mode=True)
        )
        Ap = A[np.ix_(perm, perm)]
        nblk = -(-nao // b)
        lo = np.zeros(nblk, dtype=np.int64)
        hi = np.zeros(nblk, dtype=np.int64)
        for k in range(nblk):
            rows = Ap[k * b : (k + 1) * b]
            nz = np.nonzero(rows.any(axis=0))[0]
            lo[k], hi[k] = (nz[0], nz[-1] + 1) if nz.size else (0, 1)
        W = int((hi - lo).max())
        W = min(nao, -(-W // 32) * 32)  # pad: share shapes across runs
        self.band_fraction = W / nao
        if W >= nao:
            self._band_cache = None
            return None
        start = np.clip(lo, 0, nao - W)
        col_idx = start[:, None] + np.arange(W)[None, :]
        self._band_cache = (perm, col_idx, b, W)
        return self._band_cache

    def _ensure_banded_factor(self):
        """Permute, block, and band-gather the whitened factor (once).

        The stored factor is reduced to the band -- band_fraction of the
        dense size -- and laid out [nblk, b*naux, W] with the block-row
        index outermost and the intra-block row index OUTSIDE the aux
        index (see :func:`_banded_eri_bucket` for why), so the
        per-fragment device programs run pure GEMMs with no gathers or
        large transposes and device memory holds no dense copy of B in
        the banded regime.
        """
        if hasattr(self, "_Bk_dev"):
            return
        perm, col_idx, b, W = self._band_plan()
        # band-gather on device (see _band_gather_device): the compact
        # f32 upload rides if present; otherwise the f64 factor goes up
        # once and only the banded layout stays resident (the dense
        # temporary frees when this method returns unless _B_dev was
        # already cached by the union-gather path)
        if hasattr(self, "_B32_dev"):
            B_src = self._B32_dev
        elif hasattr(self, "_B_dev_cache"):
            B_src = self._B_dev_cache
        else:
            # deliberately NOT cached as _B_dev: in the banded regime
            # the device must not keep a dense copy beside the banded one
            B_src = jnp.asarray(self.dft.B)
        self._Bk_dev = jax.block_until_ready(_band_gather_device(
            B_src, jnp.asarray(perm), jnp.asarray(col_idx), b
        ))

    def _banded_host_prep(self, TAs: list[np.ndarray]):
        """Host-side band gather + padding for a same-nemb fragment list.

        Returns (TAb_all [nblk, W, F*nemb], TAps_pad [F, nblk*b, nemb])
        ready for :func:`_banded_eri_bucket`.  Moves only the tiny TA
        matrices — the multi-GB factor gather happened once in
        :meth:`_ensure_banded_factor`.
        """
        perm, col_idx, b, W = self._band_plan()
        nao = self.mol.nao
        nblk = col_idx.shape[0]
        pad = nblk * b - nao
        TAps = [TA[perm] for TA in TAs]
        TAb_all = np.concatenate(
            [TAp[col_idx] for TAp in TAps], axis=2
        )  # [nblk, W, F*nemb]
        TAps_pad = np.stack([
            np.concatenate([TAp, np.zeros((pad, TAp.shape[1]))])
            if pad else TAp
            for TAp in TAps
        ])
        return jnp.asarray(TAb_all), jnp.asarray(TAps_pad)

    def fragment_eri_banded(self, TA: np.ndarray) -> np.ndarray:
        """f64 pair-screened fragment ERI via the banded first transform.

        Falls back to :meth:`fragment_eri` when the band plan reports no
        win (band_fraction ~ 1 on compact molecules).
        """
        plan = self._band_plan()
        if plan is None:
            return self.fragment_eri(TA)
        self.last_reach_fraction = self.band_fraction
        self._ensure_banded_factor()
        TAb_all, TAps_pad = self._banded_host_prep([TA])
        return np.asarray(
            _banded_eri_bucket(self._Bk_dev, TAb_all, TAps_pad)[0]
        )

    def _screen_pad(self, TA: np.ndarray):
        """Per-MO screen + union gather set, padded to a shared size.

        Reference semantics (``_get_AO_per_MO``, eri_sparse_DF.py:211):
        AO nu contributes to MO i only if (S_abs |TA|)[nu, i] >= eps.
        Entries of TA outside each orbital's reachable set are zeroed
        for the first quarter transform — in the GEMM that is exactly
        the reference's skipped sparse-pair contributions — and the
        reach set is padded to a multiple of QUEMB_TPU_SDF_PAD so
        fragments with nearby reach sizes share one compiled program
        (jit caches per static shape).  Padding rows gather AO 0 of the
        factor but carry zero TA rows, so they contribute nothing.

        Returns (idx, TA_eff, TA_ex, reach_fraction).
        """
        import os as _os

        X = self.S_abs @ np.abs(TA)
        M = X >= self.mo_eps
        union = M.any(axis=1)
        idx = np.nonzero(union)[0]
        frac = idx.size / self.mol.nao
        TA_eff = np.where(M, TA, 0.0)[idx]
        TA_ex = TA[idx]
        pad = int(_os.environ.get("QUEMB_TPU_SDF_PAD", "32"))
        n_pad = -idx.size % pad
        if n_pad:
            idx = np.concatenate([idx, np.zeros(n_pad, idx.dtype)])
            z = np.zeros((n_pad, TA.shape[1]))
            TA_eff = np.vstack([TA_eff, z])
            TA_ex = np.vstack([TA_ex, z])
        return idx, TA_eff, TA_ex, frac

    def fragment_eri(self, TA: np.ndarray) -> np.ndarray:
        """f64 screened fragment ERI for one fragment basis TA.

        The factor is gathered down to the union of reachable AOs
        (:meth:`_screen_pad`) so FLOPs and bytes scale with the union
        size;
        the second transform uses the exact (unscreened) TA rows.
        """
        idx, TA_eff, TA_ex, frac = self._screen_pad(TA)
        self.last_reach_fraction = frac
        Bg = _gather_B(self._B_dev, jnp.asarray(idx))
        return np.asarray(
            _screened_eri_device_2ta(Bg, jnp.asarray(TA_eff),
                                     jnp.asarray(TA_ex))
        )

    def transform_all(
        self, TAs: list[np.ndarray], fetch: bool = True
    ) -> list[np.ndarray]:
        """Screened transforms for every fragment.

        Fragments whose reachable sets have equal size share one compiled
        program (jit caches per static shape); within a size class the
        gather indices differ, so this loops rather than vmaps — the
        per-fragment work is already one large fused device program.

        ``fetch=False`` leaves the per-fragment ERIs on the device (the
        solver consumes them there, so the F × nemb⁴ doubles need not
        make a round trip through the host).
        """
        if self._band_plan() is not None:
            # extended system: the pair screen is a band narrower than
            # the AO dimension -> banded first transform wins.  Equal-nemb
            # fragments run as ONE device program with the fragments
            # FOLDED into the first GEMM's N axis (N = F*nemb, where a
            # per-fragment N = nemb GEMM is skinny); the second
            # transforms run per fragment so only one fragment's half
            # transform is ever live (see _banded_eri_bucket docstring).
            import os as _os

            self._ensure_banded_factor()
            out = [None] * len(TAs)
            buckets: dict[int, list[int]] = {}
            for i, TA in enumerate(TAs):
                buckets.setdefault(TA.shape[1], []).append(i)
            # chunk each bucket: the folded half transform is
            # [nao_pad, naux * chunk * nemb] doubles (~0.3 GB per
            # fragment at C40).  The chunk of 2 is kept until it is
            # derived from the device's memory and the operand shapes.
            chunk = int(_os.environ.get("QUEMB_TPU_SDF_CHUNK", "2"))
            for nemb, idxs in buckets.items():
                for c0 in range(0, len(idxs), chunk):
                    part = idxs[c0 : c0 + chunk]
                    TAb_all, TAps_pad = self._banded_host_prep(
                        [TAs[i] for i in part]
                    )
                    eb = _banded_eri_bucket(
                        self._Bk_dev, TAb_all, TAps_pad
                    )
                    for j, i in enumerate(part):
                        out[i] = np.asarray(eb[j]) if fetch else eb[j]
            self.last_reach_fraction = self.band_fraction
            if not fetch:
                for e in out:
                    e.block_until_ready()
            return out
        # union-gather path: fragments whose padded reach size and nemb
        # agree run as ONE vmapped dispatch (gather indices are a batched
        # operand, so the program is shared across the whole bucket)
        screened = [self._screen_pad(TA) for TA in TAs]
        out = [None] * len(TAs)
        buckets: dict[tuple[int, int], list[int]] = {}
        for i, (idx, _, _, _) in enumerate(screened):
            buckets.setdefault((idx.size, TAs[i].shape[1]), []).append(i)
        for (_, _), idxs in buckets.items():
            eb = _screened_eri_device_batched(
                self._B_dev,
                jnp.asarray(np.stack([screened[i][0] for i in idxs])),
                jnp.asarray(np.stack([screened[i][1] for i in idxs])),
                jnp.asarray(np.stack([screened[i][2] for i in idxs])),
            )
            if fetch:
                eb = np.asarray(eb)
            for j, i in enumerate(idxs):
                out[i] = eb[j]
        self.last_reach_fraction = (
            float(np.mean([s[3] for s in screened])) if screened else None
        )
        if not fetch:
            for e in out:
                e.block_until_ready()
        return out


class OnFlySparseDF:
    """Memory-bounded sparse-DF: (P|mu nu) recomputed per fragment.

    The reference's ``on-fly-sparse-DF`` transform (molbe/mbe.py:63-71;
    eri_sparse_DF.py ``precompute_P_mu_nu=False``) never holds the full
    3-center tensor: for each fragment only the reachable-AO rows of
    (P|mu nu) are generated, in shell blocks bounded by
    ``max_memory_gb`` (default
    ``settings.INTEGRAL_TRANSFORM_MAX_MEMORY``), quarter-transformed,
    and discarded.  Peak host memory is ~2 * naux * blk * nao doubles
    regardless of system size; FLOPs match :class:`SparseDF` (the same
    S_abs screen selects the rows).

    Requires an auxiliary-basis fit (the pivoted-Cholesky factor needs
    the in-core ERI and defeats the purpose here).
    """

    def __init__(
        self,
        mol: Mole,
        auxmol=None,
        screen_eps: float | None = None,
        max_memory_gb: float | None = None,
        *,
        mo_eps: float = 1.0e-5,
    ):
        from quemb_tpu.chem import integrals
        from quemb_tpu.config import settings
        from quemb_tpu.ops.df import resolve_auxbasis

        kind, arg = resolve_auxbasis(mol, auxmol)
        if kind == "cholesky":
            raise ValueError(
                "on-fly-sparse-DF generates (P|mu nu) blocks from an"
                " auxiliary basis; the pivoted-Cholesky factor needs the"
                " in-core ERI -- use int_transform='sparse-DF' for it."
            )
        if screen_eps is not None:
            mo_eps = screen_eps
        self.mol = mol
        self.auxmol = arg
        self.mo_eps = mo_eps
        self.screen_eps = mo_eps  # legacy alias
        self.max_memory_gb = (
            max_memory_gb
            if max_memory_gb is not None
            else settings.INTEGRAL_TRANSFORM_MAX_MEMORY
        )
        J = integrals.int2c2e(self.auxmol)
        w, V = np.linalg.eigh(J)
        keep = w > 1e-10 * w.max()
        self._M = (V[:, keep] / np.sqrt(w[keep])).T  # [nfit, naux]
        self.naux = int(keep.sum())
        self.S_abs = approx_S_abs(mol)
        self.last_reach_fraction: float | None = None

    def fragment_eri(self, TA: np.ndarray) -> np.ndarray:
        from quemb_tpu.ops.df import _int3c2e_rows, block_step_size

        mol = self.mol
        nao = mol.nao
        nemb = TA.shape[1]
        X = self.S_abs @ np.abs(TA)
        Mmask = X >= self.mo_eps
        union = Mmask.any(axis=1)
        self.last_reach_fraction = float(union.sum()) / nao
        TA_eff = np.where(Mmask, TA, 0.0)

        # shell bookkeeping in the public (sph or cart) basis
        shells = mol.shells
        sph = getattr(mol, "c2s", None) is not None
        nfunc = [(2 * sh.l + 1) if sph else sh.nfunc for sh in shells]
        offs = np.concatenate([[0], np.cumsum(nfunc)])[:-1].astype(int)
        reach_shells = [
            s for s in range(len(shells))
            if union[offs[s] : offs[s] + nfunc[s]].any()
        ]

        blk_rows = block_step_size(nao, self.naux, self.max_memory_gb)
        TA_j = jnp.asarray(TA)
        Bij = jnp.zeros((self.naux, nemb, nemb))
        i = 0
        while i < len(reach_shells):
            row_shells = []
            n_rows = 0
            while i < len(reach_shells) and n_rows + nfunc[
                reach_shells[i]
            ] <= max(blk_rows, nfunc[reach_shells[i]]):
                row_shells.append(reach_shells[i])
                n_rows += nfunc[reach_shells[i]]
                i += 1
            p3 = _int3c2e_rows(mol, self.auxmol, row_shells)
            B_blk = (self._M @ p3.reshape(-1, p3.shape[-1]).T).reshape(
                self.naux, n_rows, nao
            )
            rows = np.concatenate(
                [np.arange(offs[s], offs[s] + nfunc[s])
                 for s in row_shells]
            )
            Bij = Bij + jnp.einsum(
                "pmn,mi,nj->pij",
                jnp.asarray(B_blk),
                jnp.asarray(TA_eff[rows]),
                TA_j,
                optimize=True,
            )
        # symmetrize: the row side is screened, the column side exact
        Bij = 0.5 * (Bij + jnp.swapaxes(Bij, 1, 2))
        Bf = Bij.reshape(self.naux, nemb * nemb)
        return np.asarray(Bf.T @ Bf).reshape(nemb, nemb, nemb, nemb)

    def transform_all(
        self, TAs: list[np.ndarray], fetch: bool = True
    ) -> list[np.ndarray]:
        # fetch accepted for SparseDF API parity; the on-fly path builds
        # each ERI from host-generated integral blocks, so its outputs
        # are host arrays either way
        out = []
        fracs = []
        for TA in TAs:
            out.append(self.fragment_eri(TA))
            fracs.append(self.last_reach_fraction)
        self.last_reach_fraction = float(np.mean(fracs)) if fracs else None
        return out
