"""Per-objective-evaluation fragment solve pass + error vector.

Device-batched replacement for the reference's ``molbe/solver.py:be_func`` and
``be_parallel.py``: fragments are bucketed by embedding-space signature
(nemb, nsocc) and each bucket runs as ONE batched device program
(vmapped SCF -> vmapped MO transform -> vmapped CCSD -> batched energy
contraction) instead of a forked process pool.  FCI fragments run through
the host Davidson solver.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from quemb_tpu.embed.energy import fragment_energy
from quemb_tpu.embed.fragment import Fragment
from quemb_tpu.embed.fragment_scf import rhf_orthonormal
from quemb_tpu.solvers.fci import remove_mf_part, solve_fci


def _mo_transform(C, h, eri):
    C = jnp.asarray(C)
    h_mo = C.T @ jnp.asarray(h) @ C
    eri_mo = jnp.einsum(
        "pqrs,pi,qj,rk,sl->ijkl", jnp.asarray(eri), C, C, C, C
    )
    return np.asarray(h_mo), np.asarray(eri_mo)


def run_fragment_scf(fr: Fragment, heff=None):
    """Fragment RHF on (fock + heff, eri) from the initial density guess."""
    h = fr.fock + (fr.heff if heff is None else heff)
    e, C, e_el, n_it = rhf_orthonormal(
        jnp.asarray(h), jnp.asarray(fr.eri), fr.nsocc, jnp.asarray(fr.dm0)
    )
    return np.asarray(e), np.asarray(C)


# ------------------------------------------------- batched bucket pipeline
def _mo_eri_one(eri, C):
    """Four sequential single-index transforms (axis-rolling dgemms):
    ~4x lower peak memory than the fused 4-index einsum, whose
    intermediates exhaust device memory at nemb ~ 90+."""
    out = eri
    for _ in range(4):
        shp = out.shape[:-1]
        out = (out.reshape(-1, out.shape[-1]) @ C).reshape(
            shp + (C.shape[1],)
        )
        out = jnp.moveaxis(out, -1, 0)
    return out


@jax.jit
def _batched_mo_eri(eri_b, C_b):
    if eri_b.shape[1] <= 48:
        # small fragments: one fused batched program (fastest)
        return jax.vmap(_mo_eri_one)(eri_b, C_b)
    # large fragments: sequential map caps peak device memory at one
    # fragment
    return jax.lax.map(lambda ec: _mo_eri_one(*ec), (eri_b, C_b))


@jax.jit
def _batched_energy_rows(mo_b, h1_b, veff0_b, eri_b, rdm1_b, rdm2_b,
                         occ_mask_b, center_w_b):
    """Cumulant fragment energies for a bucket.

    center_w_b: [nf, nemb] weight per embedding row (w on center rows,
    0 elsewhere).  Returns (e1, e2, ec) per fragment.
    """

    def one(mo, h1, veff0, eri, rdm1, rdm2, occ_mask, w):
        rdm1_emb = mo @ (0.5 * rdm1) @ mo.T
        hf_1rdm = (mo * occ_mask[None, :]) @ mo.T
        delta = 2.0 * (rdm1_emb - hf_1rdm)
        e1 = jnp.einsum("ij,ij->i", h1, delta)
        ec = jnp.einsum("ij,ij->i", veff0, delta)
        # axis-rolling transform (see _mo_eri_one): the fused 4-index
        # einsum exhausts device memory for nemb ~ 90+
        rdm2_emb = _mo_eri_one(0.5 * rdm2, mo.T)
        e2 = jnp.einsum("ijkl,ijkl->i", rdm2_emb, eri)
        return w @ e1, w @ e2, w @ ec

    if mo_b.shape[1] > 48:
        return jax.lax.map(lambda a: one(*a), (
            mo_b, h1_b, veff0_b, eri_b, rdm1_b, rdm2_b, occ_mask_b,
            center_w_b,
        ))
    return jax.vmap(one)(
        mo_b, h1_b, veff0_b, eri_b, rdm1_b, rdm2_b, occ_mask_b, center_w_b
    )


@jax.jit
def _batched_energy_rows_nc(mo_b, h1_b, veff_b, eri_b, rdm1_b, rdm2_b,
                            center_w_b):
    """Non-cumulant fragment energies for a bucket (ref helper.py:295):
    full 1-RDM against h1/veff(env), full 2-RDM against the ERI."""

    def one(mo, h1, veff, eri, rdm1, rdm2, w):
        rdm1_emb = mo @ (0.5 * rdm1) @ mo.T
        e1 = 2.0 * jnp.einsum("ij,ij->i", h1, rdm1_emb)
        ec = jnp.einsum("ij,ij->i", veff, rdm1_emb)
        rdm2_emb = _mo_eri_one(0.5 * rdm2, mo.T)
        e2 = jnp.einsum("ijkl,ijkl->i", rdm2_emb, eri)
        return w @ e1, w @ e2, w @ ec

    if mo_b.shape[1] > 48:
        return jax.lax.map(lambda a: one(*a), (
            mo_b, h1_b, veff_b, eri_b, rdm1_b, rdm2_b, center_w_b,
        ))
    return jax.vmap(one)(
        mo_b, h1_b, veff_b, eri_b, rdm1_b, rdm2_b, center_w_b
    )


@jax.jit
def _batched_rdm1_emb(C_b, rdm1_b):
    return jax.vmap(lambda C, d: (C @ d @ C.T) * 0.5)(C_b, rdm1_b)


from functools import partial


@partial(jax.jit, static_argnames=("with_dm1",))
def _rdm12_urlx_batched(t1_b, t2_b, with_dm1: bool):
    """Batched urlx RDMs on device (broadcast form of the reference's
    per-occupied-index loops, ccsd_rdm.py:make_rdm2_urlx)."""

    def one(t1, t2):
        nocc, nvir = t1.shape
        nmo = nocc + nvir
        goovv = (jnp.einsum("ia,jb->ijab", t1, t1) + t2) * 0.5
        dovov = (
            goovv.transpose(0, 2, 1, 3) * 2 - goovv.transpose(1, 2, 0, 3)
        )
        blk = dovov + dovov.transpose(2, 3, 0, 1)
        dm2 = jnp.zeros((nmo, nmo, nmo, nmo))
        dm2 = dm2.at[:nocc, nocc:, :nocc, nocc:].set(blk)
        dm2 = dm2.at[nocc:, :nocc, nocc:, :nocc].set(
            blk.transpose(1, 0, 3, 2)
        )
        dm1 = jnp.zeros((nmo, nmo))
        dm1 = dm1.at[:nocc, nocc:].set(t1)
        dm1 = dm1.at[nocc:, :nocc].set(t1.T)
        occd = jnp.concatenate([jnp.ones(nocc), jnp.zeros(nvir)])
        dm1 = dm1 + 2.0 * jnp.diag(occd)
        if with_dm1:
            d1c = dm1 - 2.0 * jnp.diag(occd)  # correlation part
            Ieye = jnp.eye(nmo)
            Iocc = Ieye * occd[:, None]
            dm2 = dm2 + 2.0 * jnp.einsum("pq,rs->pqrs", Iocc, d1c)
            dm2 = dm2 + 2.0 * jnp.einsum("pq,rs->rspq", Iocc, d1c)
            dm2 = dm2 - jnp.einsum("qr,ps->pqrs", Iocc, d1c)
            dm2 = dm2 - jnp.einsum("ps,rq->pqrs", Iocc, d1c)
            dm2 = dm2 + 4.0 * jnp.einsum("pq,rs->pqrs", Iocc, Iocc)
            dm2 = dm2 - 2.0 * jnp.einsum("ps,qr->pqrs", Iocc, Iocc)
        return dm1, dm2

    return jax.vmap(one)(t1_b, t2_b)


@partial(
    jax.jit,
    static_argnames=("nsocc", "mixed", "f32_only", "eeval", "conv_tol"),
)
def _fused_objective_bucket(
    fock_b, heff_b, eri_b, dm0_b, h1_b, veff0_b, occ_mask_b, center_w_b,
    nsocc: int, mixed: bool, f32_only: bool, eeval: bool,
    conv_tol: float | None = None,
):
    """One device program for a whole CCSD objective evaluation.

    Fragment SCF -> MO-ERI transform -> RCCSD -> urlx RDMs ->
    embedding-basis 1-RDM -> cumulant energy rows, fused into a single
    dispatch per bucket, so no stage waits on a host round trip; only
    the scalars, the [nf, nemb, nemb] RDM, and the amplitudes leave the
    device, in one readback.  With
    ``eeval=False`` (error-only line-search evaluations) the 2-RDM and
    energy-row graphs are unused outputs that XLA eliminates.
    """
    from quemb_tpu.solvers.rccsd import _rccsd_from_mo_batched

    h_b = fock_b + heff_b
    moe_b, C_b, _, _ = jax.vmap(
        lambda h, eri, dm0: rhf_orthonormal(h, eri, nsocc, dm0)
    )(h_b, eri_b, dm0_b)
    eri_mo_b = _batched_mo_eri(eri_b, C_b)
    t1_b, t2_b, _, delta = _rccsd_from_mo_batched(
        eri_mo_b, moe_b, nsocc, mixed=mixed, f32_only=f32_only,
        conv_tol=conv_tol,
    )
    rdm1_b, rdm2_b = _rdm12_urlx_batched(t1_b, t2_b, with_dm1=False)
    rdm1_emb_b = _batched_rdm1_emb(C_b, rdm1_b)
    if eeval:
        e1, e2, ec = _batched_energy_rows(
            C_b, h1_b, veff0_b, eri_b, rdm1_b, rdm2_b, occ_mask_b,
            center_w_b,
        )
    else:
        nf = fock_b.shape[0]
        e1 = e2 = ec = jnp.zeros(nf)
        rdm2_b = jnp.zeros(0)
    return (
        e1, e2, ec, rdm1_emb_b, rdm1_b, rdm2_b, moe_b, C_b, t1_b, t2_b,
        delta,
    )


# per-bucket device-resident operand cache: fock/eri/dm0/h1/veff0 are set
# once at BE initialization; only heff changes between objective
# evaluations, so everything big stays in device memory across the QN
# loop.
_BUCKET_DEV_CACHE: dict = {}

# Orbital energy magnitude assigned to bucket-merge padding dimensions:
# pad VIRTUALS carry +_PAD_SHIFT on the h diagonal (sort above every
# physical orbital, never occupied), pad OCCUPIEDS carry -_PAD_SHIFT and
# dm0 occupation 2 (sort below everything, always filled).  Both are
# exactly decoupled (zero integrals/off-diagonals), so amplitudes and
# correlated RDMs on them vanish identically, the occupied pads' HF
# density cancels in every energy row (delta = rdm1 - hf_1rdm = 0 there,
# eri rows are zero), and merged-bucket results equal unpadded ones.
_PAD_SHIFT = 1.0e6


def _pad_frag_op(
    a: np.ndarray, p_occ: int, p_vir: int,
    diag_occ: float = 0.0, diag_vir: float = 0.0,
) -> np.ndarray:
    """Pad every embedding axis of a per-fragment operand with trailing
    zeros (occupied pads first, then virtual pads; 2-D operands get
    ``diag_occ``/``diag_vir`` on the respective new diagonal entries).

    Device arrays are padded on device (``jnp.pad`` + ``.at`` diagonal
    writes): a device-resident fragment ERI must not round-trip through
    the host just to gain zero padding rows.
    """
    pad = p_occ + p_vir
    if pad == 0:
        return a
    n = a.shape[0]
    if isinstance(a, jax.Array):
        out = jnp.pad(a, tuple((0, pad) for _ in a.shape))
        if a.ndim == 2:
            idx_o = jnp.arange(n, n + p_occ)
            idx_v = jnp.arange(n + p_occ, n + pad)
            out = out.at[idx_o, idx_o].set(diag_occ)
            out = out.at[idx_v, idx_v].set(diag_vir)
        return out
    out = np.zeros(tuple(d + pad for d in a.shape), a.dtype)
    out[tuple(slice(0, n) for _ in a.shape)] = a
    if a.ndim == 2:
        for i in range(n, n + p_occ):
            out[i, i] = diag_occ
        for i in range(n + p_occ, n + pad):
            out[i, i] = diag_vir
    return out


def _bucket_dev(frs: list[Fragment], pads: tuple[tuple[int, int], ...]):
    import weakref

    from quemb_tpu.parallel.mesh import get_mesh, shard_batch

    # Key on monotonic per-Fragment tokens (never reused, unlike id()) and
    # on the mesh the operands are laid out for, and validate with a
    # weakref identity check on the ERI array so that replacing fr.eri on
    # the same Fragment objects invalidates the entry.
    key = tuple(fr._cache_token for fr in frs) + pads + (get_mesh(),)
    if len(_BUCKET_DEV_CACHE) > 16:  # bound memory held by stale BEs
        _BUCKET_DEV_CACHE.clear()
    hit = _BUCKET_DEV_CACHE.get(key)
    if hit is None or hit["eri_ref"]() is not frs[0].eri:
        if any(isinstance(fr.eri, jax.Array) for fr in frs):
            # device-resident fragment ERIs (the accelerator in-core-CD
            # init path): pad + stack on device, no host round trip
            eri_stack = jnp.stack([
                _pad_frag_op(jnp.asarray(fr.eri), po, pv)
                for fr, (po, pv) in zip(frs, pads)
            ])
        else:
            eri_stack = np.stack([
                _pad_frag_op(fr.eri, po, pv)
                for fr, (po, pv) in zip(frs, pads)
            ])
        hit = dict(
            eri_ref=weakref.ref(frs[0].eri),
            fock=shard_batch(np.stack([
                _pad_frag_op(fr.fock, po, pv,
                             diag_occ=-_PAD_SHIFT, diag_vir=_PAD_SHIFT)
                for fr, (po, pv) in zip(frs, pads)
            ]))[0],
            eri=shard_batch(eri_stack)[0],
            dm0=shard_batch(np.stack([
                _pad_frag_op(fr.dm0, po, pv, diag_occ=2.0)
                for fr, (po, pv) in zip(frs, pads)
            ]))[0],
            h1=shard_batch(np.stack([
                _pad_frag_op(fr.h1, po, pv)
                for fr, (po, pv) in zip(frs, pads)
            ]))[0],
            veff0=shard_batch(np.stack([
                _pad_frag_op(fr.veff0, po, pv)
                for fr, (po, pv) in zip(frs, pads)
            ]))[0],
        )
        _BUCKET_DEV_CACHE[key] = hit
    return hit


def _maybe_fused_objective(
    frs, pads, dev, heff_b, nsocc, nemb, solver, eeval, use_cumulant,
    relax_density,
):
    """Run the bucket through the single fused device program if eligible.

    Eligible: batched closed-shell CCSD with cumulant energies (the
    production matching path).  Returns ``(True, result)`` when handled
    (result is the ``_solve_bucket_batched`` return value), or
    ``(False, None)`` to fall through to the staged path.
    """
    import os as _os

    from quemb_tpu.solvers.ccsd import _default_conv_tol, _f32_only, \
        _use_mixed

    if (
        solver != "CCSD"
        or relax_density
        or not use_cumulant
        or _os.environ.get("QUEMB_TPU_FUSED", "1") == "0"
        or _os.environ.get("QUEMB_TPU_CCSD_SPINORB", "") in
        ("1", "true", "yes")
        or _os.environ.get("QUEMB_TPU_CCSD_LANES", "")
    ):
        return False, None
    from quemb_tpu.parallel.mesh import shard_batch

    # operands are padded to the mesh size by shard_batch (pad lanes
    # repeat the last fragment); pad the masks the same way and slice
    # every output back to the true fragment count
    nf_true = len(frs)
    occ_mask = np.zeros((nf_true, nemb))
    occ_mask[:, :nsocc] = 1.0
    center_w = np.zeros((nf_true, nemb))
    for i, fr in enumerate(frs):
        w, idx = fr.weight_and_relAO_per_center
        center_w[i, list(idx)] = w
    fused_args = (
        dev["fock"], heff_b, dev["eri"], dev["dm0"], dev["h1"],
        dev["veff0"], shard_batch(occ_mask)[0], shard_batch(center_w)[0],
    )
    fused_kw = dict(
        nsocc=nsocc, mixed=_use_mixed(), f32_only=_f32_only(),
        eeval=bool(eeval), conv_tol=_default_conv_tol(),
    )
    (e1, e2, ec, rdm1_emb_b, rdm1_b, rdm2_b, moe_b, C_b, t1_b, t2_b,
     delta) = _fused_objective_bucket(*fused_args, **fused_kw)
    # ONE host round trip for every small output (these total < 100 KB):
    # each np.asarray would be a separate device->host transfer, each
    # with its own synchronization
    (delta_h, rdm1_emb_host, C_host, moe_host, e1h, e2h, ech) = \
        jax.device_get((delta, rdm1_emb_b, C_b, moe_b, e1, e2, ec))
    if not _f32_only() and float(np.max(delta_h)) > \
            10 * _default_conv_tol():
        import warnings

        warnings.warn(
            f"CCSD bucket not fully converged: "
            f"max|dt| = {float(np.max(delta_h)):.2e}"
        )
    for k, fr in enumerate(frs):
        n = fr.nao
        po = pads[k][0]
        sl = slice(po, po + n)
        nv_k = n - fr.nsocc
        fr.mo_coeffs = C_host[k][:n, po : po + n]
        fr.mo_energy = moe_host[k][po : po + n]
        fr._rdm1 = rdm1_emb_host[k][:n, :n]
        fr.rdm1__ = rdm1_b[k][sl, sl]  # device
        fr.t1 = t1_b[k][po:, :nv_k]  # device (converted lazily)
        fr.t2 = t2_b[k][po:, po:, :nv_k, :nv_k]
        if eeval:
            fr.rdm2__ = rdm2_b[k][sl, sl, sl, sl]  # device-resident
    if not eeval:
        return True, None
    e1h = e1h[:nf_true]
    e2h = e2h[:nf_true]
    ech = ech[:nf_true]
    for fr, a, b, c in zip(frs, e1h, e2h, ech):
        fr.ebe = float(a + b + c)
    return True, [float(e1h.sum()), float(e2h.sum()), float(ech.sum())]


def _solve_bucket_large(
    frs: list[Fragment],
    solver: str,
    eeval: bool,
    use_cumulant: bool,
):
    """Fragment-at-a-time pipeline for large embedding spaces.

    For nemb ~ 100 a single fragment's ERI/rdm2 is ~1 GB f64; holding a
    whole bucket (plus the device-resident operand cache and the CCSD
    working set) can exhaust device memory.  This path streams one
    fragment end-to-end (fragment SCF -> MO transform -> CCSD with
    host-built spin blocks -> RDMs -> energy rows), keeps RDMs on the
    host, and lets each fragment's device buffers be freed before the
    next one starts.  Handles mixed shapes (merged buckets reroute here
    unpadded)."""
    e1s, e2s, ecs = [], [], []
    for fr in frs:
        nsocc = fr.nsocc
        h = jnp.asarray(fr.fock + fr.heff)
        eri = jnp.asarray(fr.eri)
        moe, C, _, _ = rhf_orthonormal(h, eri, nsocc, jnp.asarray(fr.dm0))
        eri_mo_host = np.asarray(_mo_eri_one(eri, C))
        moe_host = np.asarray(moe)
        C = np.asarray(C)
        # free the device ERI copies before the CCSD working set claims
        # device memory (each is ~1 GB f64 at nemb ~ 100)
        del eri, h, moe
        if solver == "CCSD":
            import os as _os

            if _os.environ.get("QUEMB_TPU_CCSD_SPINORB", "") in (
                "1", "true", "yes",
            ):
                from quemb_tpu.solvers.ccsd import ccsd_so_large

                t1, t2, _, _ = ccsd_so_large(eri_mo_host, moe_host, nsocc)
            else:
                from quemb_tpu.solvers.rccsd import rccsd_large

                t1, t2, _, _ = rccsd_large(eri_mo_host, moe_host, nsocc)
        elif solver == "MP2":
            from quemb_tpu.solvers.mp2 import mp2_amplitudes

            t2, _ = mp2_amplitudes(eri_mo_host, moe_host, nsocc)
            t1 = np.zeros((nsocc, fr.nao - nsocc))
        else:
            raise NotImplementedError(
                f"large-fragment path supports CCSD/MP2, not {solver}"
            )
        rdm1_1, rdm2_1 = _rdm12_urlx_batched(
            jnp.asarray(t1)[None], jnp.asarray(t2)[None],
            with_dm1=not use_cumulant,
        )
        fr.t1, fr.t2 = np.asarray(t1), np.asarray(t2)
        fr.mo_coeffs = np.asarray(C)
        fr.mo_energy = moe_host
        rdm1 = np.asarray(rdm1_1[0])
        fr._rdm1 = np.asarray(C @ (0.5 * jnp.asarray(rdm1)) @ C.T)
        fr.rdm1__ = rdm1
        if not eeval:
            continue
        fr.rdm2__ = np.asarray(rdm2_1[0])
        occ_mask = np.zeros((1, fr.nao))
        occ_mask[0, :nsocc] = 1.0
        center_w = np.zeros((1, fr.nao))
        w, idx = fr.weight_and_relAO_per_center
        center_w[0, list(idx)] = w
        eri_dev = jnp.asarray(fr.eri)
        if use_cumulant:
            e1, e2, ec = _batched_energy_rows(
                jnp.asarray(C)[None], jnp.asarray(fr.h1)[None],
                jnp.asarray(fr.veff0)[None], eri_dev[None],
                rdm1_1, rdm2_1,
                jnp.asarray(occ_mask), jnp.asarray(center_w),
            )
        else:
            e1, e2, ec = _batched_energy_rows_nc(
                jnp.asarray(C)[None], jnp.asarray(fr.h1)[None],
                jnp.asarray(fr.veff)[None], eri_dev[None],
                rdm1_1, rdm2_1, jnp.asarray(center_w),
            )
        del eri_dev, rdm1_1, rdm2_1
        fr.ebe = float(np.asarray(e1)[0] + np.asarray(e2)[0]
                       + np.asarray(ec)[0])
        e1s.append(float(np.asarray(e1)[0]))
        e2s.append(float(np.asarray(e2)[0]))
        ecs.append(float(np.asarray(ec)[0]))
    if not eeval:
        return None
    return [sum(e1s), sum(e2s), sum(ecs)]


def _solve_bucket_batched(
    frs: list[Fragment],
    solver: str,
    eeval: bool,
    use_cumulant: bool,
    relax_density: bool,
    pads: tuple[tuple[int, int], ...] | None = None,
):
    """Solve a bucket of same-shaped fragments as batched device programs.

    ``pads`` (from the be_func bucket merge) zero-pads each fragment's
    occupied/virtual embedding dimensions up to a shared (nsocc, nemb)
    target so near-same-shaped buckets run as ONE device program --
    exactly (see _PAD_SHIFT); per-fragment results are sliced back to
    true shapes before they are stored.
    """
    from quemb_tpu.parallel.mesh import shard_batch

    if pads is None:
        pads = ((0, 0),) * len(frs)
    padded = any(po or pv for po, pv in pads)
    if padded and (relax_density or solver not in ("CCSD", "MP2")):
        raise ValueError(
            "bucket-merge padding supports batched CCSD/MP2 only"
        )
    nsocc = frs[0].nsocc + pads[0][0]
    nemb = frs[0].nao + pads[0][0] + pads[0][1]
    nf_true = len(frs)
    # nemb > 48 on an accelerator streams fragment by fragment to bound
    # device memory; the threshold is kept until it is derived from the
    # device's memory and the operand shapes
    if (
        nemb > 48
        and jax.default_backend() != "cpu"
        and not relax_density
        and solver in ("CCSD", "MP2")
    ):
        # fragment-at-a-time path handles mixed shapes natively
        return _solve_bucket_large(frs, solver, eeval, use_cumulant)
    dev = _bucket_dev(frs, pads)
    heff_b, _ = shard_batch(np.stack([
        _pad_frag_op(fr.heff, po, pv) for fr, (po, pv) in zip(frs, pads)
    ]))
    h_b = dev["fock"] + heff_b
    eri_b = dev["eri"]
    dm0_b = dev["dm0"]

    handled, fused = _maybe_fused_objective(
        frs, pads, dev, heff_b, nsocc, nemb, solver, eeval,
        use_cumulant, relax_density,
    )
    if handled:
        return fused

    moe_b, C_b, _, _ = jax.vmap(
        lambda h, eri, dm0: rhf_orthonormal(h, eri, nsocc, dm0)
    )(h_b, eri_b, dm0_b)
    eri_mo_b = _batched_mo_eri(eri_b, C_b)

    if solver == "CCSD" and relax_density:
        # lambda/response densities via adjoint implicit differentiation
        # (reference solver.py:920-940 relax=True -> pyscf make_rdm1/2
        # with Lambda amplitudes)
        from quemb_tpu.solvers.ccsd_relaxed import ccsd_relaxed_rdms

        h_mo_b = jax.vmap(lambda C, h: C.T @ h @ C)(C_b, h_b)
        rdm1_l, rdm2_l = [], []
        for h_mo, eri_mo in zip(np.asarray(h_mo_b)[:nf_true],
                                np.asarray(eri_mo_b)[:nf_true]):
            rdm1, rdm2, _ = ccsd_relaxed_rdms(h_mo, eri_mo, nsocc)
            if use_cumulant:
                rdm2 = remove_mf_part(rdm1, rdm2, nsocc)
            rdm1_l.append(rdm1)
            rdm2_l.append(rdm2)
        rdm1_b, rdm2_b = np.stack(rdm1_l), np.stack(rdm2_l)
    elif solver == "CCSD":
        # memory-aware vmap width: per-lane footprint is dominated by the
        # DIIS amplitude/error history + while-loop double buffering +
        # the fused blocks (all ~ no^2*nv^2 doubles).  0 = full batch.
        import os as _os

        from quemb_tpu.solvers.ccsd import _default_conv_tol, \
            _f32_only, _use_mixed
        from quemb_tpu.utils.helper import device_memory_budget

        spinorb = _os.environ.get("QUEMB_TPU_CCSD_SPINORB", "") in (
            "1", "true", "yes",
        )
        if spinorb and padded:
            raise ValueError(
                "bucket-merge padding is not supported with the legacy"
                " spin-orbital kernel (QUEMB_TPU_CCSD_SPINORB); set"
                " QUEMB_TPU_MERGE_BUCKETS=0"
            )
        mixed = _use_mixed()
        f32_only = _f32_only()
        if spinorb:
            # legacy spin-orbital kernel (kept for cross-checks)
            from quemb_tpu.solvers.ccsd import _ccsd_from_mo_batched \
                as _amps_batched
            n2 = (2 * nsocc) ** 2 * (2 * (nemb - nsocc)) ** 2
        else:
            # production closed-shell spatial kernel: ~1/16 the per-lane
            # working set and ~1/8-1/16 the FLOPs of the spin-orbital one
            from quemb_tpu.solvers.rccsd import _rccsd_from_mo_batched \
                as _amps_batched
            n2 = nsocc ** 2 * (nemb - nsocc) ** 2
        env = _os.environ.get("QUEMB_TPU_CCSD_LANES", "")
        if env:
            max_lanes = int(env)
        elif jax.default_backend() == "cpu":
            max_lanes = 0
        else:
            per_lane = 8 * n2 * 50  # empirical copies of T2p incl. carry
            max_lanes = max(
                1, int(device_memory_budget(12e9) / max(per_lane, 1))
            )
        if max_lanes and nf_true > max_lanes:
            t1f_parts, t2f_parts, deltas = [], [], []
            for s in range(0, nf_true, max_lanes):
                t1f_c, t2f_c, _, d_c = _amps_batched(
                    eri_mo_b[s : s + max_lanes],
                    moe_b[s : s + max_lanes],
                    nsocc, mixed=mixed, f32_only=f32_only,
                    conv_tol=_default_conv_tol(),
                )
                t1f_parts.append(t1f_c)
                t2f_parts.append(t2f_c)
                deltas.append(np.asarray(d_c))
            t1f_b = jnp.concatenate(t1f_parts)
            t2f_b = jnp.concatenate(t2f_parts)
            delta = np.concatenate(deltas)
        else:
            t1f_b, t2f_b, n_it, delta = _amps_batched(
                eri_mo_b, moe_b, nsocc, mixed=mixed,
                f32_only=f32_only, conv_tol=_default_conv_tol(),
            )
        if not f32_only and float(np.max(np.asarray(delta))) > \
                10 * _default_conv_tol():
            import warnings

            warnings.warn(
                f"CCSD bucket not fully converged: "
                f"max|dt| = {float(np.max(np.asarray(delta))):.2e}"
            )
        # spatial amplitudes (device slice, stays on the device)
        if spinorb:
            nv_sp = nemb - nsocc
            t1_b = t1f_b[:, :nsocc, :nv_sp]
            t2_b = t2f_b[:, :nsocc, nsocc : 2 * nsocc, :nv_sp, nv_sp:]
        else:
            t1_b, t2_b = t1f_b, t2f_b
        rdm1_b, rdm2_b = _rdm12_urlx_batched(
            t1_b, t2_b, with_dm1=not use_cumulant
        )
        t1_host = np.asarray(t1_b)
        t2_host = np.asarray(t2_b)
        for k, fr in enumerate(frs):
            po = pads[k][0]  # pad occupieds sort first, pad virtuals last
            nv_k = fr.nao - fr.nsocc
            fr.t1 = t1_host[k][po:, :nv_k]
            fr.t2 = t2_host[k][po:, po:, :nv_k, :nv_k]
    elif solver == "MP2":
        from quemb_tpu.solvers.mp2 import make_rdm1_mp2, make_rdm2_mp2, \
            mp2_amplitudes

        rdm1_l, rdm2_l = [], []
        for eri_mo, moe in zip(np.asarray(eri_mo_b)[:nf_true],
                               np.asarray(moe_b)[:nf_true]):
            t2, _ = mp2_amplitudes(eri_mo, moe, nsocc)
            rdm1_l.append(make_rdm1_mp2(t2, nemb))
            rdm2_l.append(make_rdm2_mp2(t2, nemb))
        rdm1_b, rdm2_b = np.stack(rdm1_l), np.stack(rdm2_l)
    elif solver == "FCI":
        rdm1_l, rdm2_l = [], []
        h_mo_b = jax.vmap(lambda C, h: C.T @ h @ C)(C_b, h_b)
        for h_mo, eri_mo in zip(np.asarray(h_mo_b)[:nf_true],
                                np.asarray(eri_mo_b)[:nf_true]):
            _, rdm1, rdm2 = solve_fci(h_mo, eri_mo, nsocc)
            if eeval and use_cumulant:
                rdm2 = remove_mf_part(rdm1, rdm2, nsocc)
            rdm1_l.append(rdm1)
            rdm2_l.append(rdm2)
        rdm1_b, rdm2_b = np.stack(rdm1_l), np.stack(rdm2_l)
    elif solver == "DMRG":
        # optional block2 adapter (reference solve_block2,
        # molbe/solver.py:949); raises with the install hint when the
        # optional dependency is absent
        from quemb_tpu.solvers.dmrg import solve_dmrg

        rdm1_l, rdm2_l = [], []
        h_mo_b = jax.vmap(lambda C, h: C.T @ h @ C)(C_b, h_b)
        for h_mo, eri_mo in zip(np.asarray(h_mo_b)[:nf_true],
                                np.asarray(eri_mo_b)[:nf_true]):
            _, rdm1, rdm2 = solve_dmrg(h_mo, eri_mo, nsocc)
            if eeval and use_cumulant:
                rdm2 = remove_mf_part(rdm1, rdm2, nsocc)
            rdm1_l.append(rdm1)
            rdm2_l.append(rdm2)
        rdm1_b, rdm2_b = np.stack(rdm1_l), np.stack(rdm2_l)
    elif solver in ("SHCI", "HCI"):
        # Reference enum parity (molbe/solver.py:42 Solvers literal).
        # SHCI needs cornell_shci -- an external C++ package the
        # reference shells out to (solver.py:346); HCI raises upstream
        # as well.  The own heat-bath SCI ("SCI") covers selected CI.
        raise NotImplementedError(
            f"Solver {solver!r} requires the external cornell_shci"
            " package; the reference gates these behind optional"
            " dependencies too (use solver='SCI' for the built-in"
            " heat-bath selected CI)."
        )
    elif solver == "SCI":
        from quemb_tpu.solvers.sci import solve_sci

        rdm1_l, rdm2_l = [], []
        h_mo_b = jax.vmap(lambda C, h: C.T @ h @ C)(C_b, h_b)
        for h_mo, eri_mo in zip(np.asarray(h_mo_b)[:nf_true],
                                np.asarray(eri_mo_b)[:nf_true]):
            _, rdm1, rdm2 = solve_sci(h_mo, eri_mo, nsocc)
            if eeval and use_cumulant:
                rdm2 = remove_mf_part(rdm1, rdm2, nsocc)
            rdm1_l.append(rdm1)
            rdm2_l.append(rdm2)
        rdm1_b, rdm2_b = np.stack(rdm1_l), np.stack(rdm2_l)
    else:
        raise NotImplementedError(f"Solver {solver} not implemented")

    # correlated 1-RDM in the embedding basis (for the error vector);
    # all big operands stay on device, only per-fragment scalars and
    # [nemb, nemb] matrices come back to the host
    rdm1_dev = jnp.asarray(rdm1_b)[:nf_true]
    rdm2_dev = jnp.asarray(rdm2_b)[:nf_true]
    C_dev = C_b[:nf_true]
    _rdm1_b = np.asarray(_batched_rdm1_emb(C_dev, rdm1_dev))
    C_np = np.asarray(C_dev)
    for k, fr in enumerate(frs):
        # pad orbitals are exactly decoupled: occupied pads (-_PAD_SHIFT)
        # sort first, virtual pads (+_PAD_SHIFT) last, so the real MOs
        # are columns [po, po + n) and the real embedding rows are [0, n)
        n = fr.nao
        po = pads[k][0]
        fr.mo_coeffs = C_np[k][:n, po : po + n]
        fr.mo_energy = np.asarray(moe_b[k])[po : po + n]
        fr._rdm1 = _rdm1_b[k][:n, :n]
        fr.rdm1__ = rdm1_dev[k][po : po + n, po : po + n]  # device

    if not eeval:
        return None

    for k, fr in enumerate(frs):
        n = fr.nao
        po = pads[k][0]
        sl = slice(po, po + n)
        fr.rdm2__ = rdm2_dev[k][sl, sl, sl, sl]  # device-resident

    occ_mask = np.zeros((len(frs), nemb))
    occ_mask[:, :nsocc] = 1.0
    center_w = np.zeros((len(frs), nemb))
    for i, fr in enumerate(frs):
        w, idx = fr.weight_and_relAO_per_center
        center_w[i, list(idx)] = w
    h1_b = dev["h1"][:nf_true]
    eri_true_b = dev["eri"][:nf_true]
    if use_cumulant:
        e1, e2, ec = _batched_energy_rows(
            C_dev, h1_b, dev["veff0"][:nf_true], eri_true_b,
            rdm1_dev, rdm2_dev,
            jnp.asarray(occ_mask), jnp.asarray(center_w),
        )
    else:
        veff_b = jnp.asarray(np.stack([
            _pad_frag_op(fr.veff, po, pv) for fr, (po, pv) in zip(frs, pads)
        ]))
        e1, e2, ec = _batched_energy_rows_nc(
            C_dev, h1_b, veff_b, eri_true_b,
            rdm1_dev, rdm2_dev,
            jnp.asarray(center_w),
        )
    for fr, a, b, c in zip(frs, np.asarray(e1), np.asarray(e2),
                           np.asarray(ec)):
        fr.ebe = float(a + b + c)
    return [
        float(np.asarray(e1).sum()),
        float(np.asarray(e2).sum()),
        float(np.asarray(ec).sum()),
    ]


def solve_one_fragment(
    fr: Fragment,
    solver: str,
    eeval: bool,
    use_cumulant: bool = True,
    relax_density: bool = False,
):
    """Single-fragment solve (kept for probing/tests); updates fr in place."""
    res = _solve_bucket_batched([fr], solver, eeval, use_cumulant,
                                relax_density)
    if eeval:
        return res
    return None


def form_merge_classes(
    fragments: list[Fragment],
    solver: str = "CCSD",
    relax_density: bool = False,
) -> list[list[tuple[Fragment, tuple[int, int]]]]:
    """Group fragments into merged padded buckets (the production plan).

    Merges near-same-shaped buckets by zero-padding occupied/virtual
    embedding dimensions to a shared (nsocc, nvir) target (exact -- see
    ``_PAD_SHIFT``): fewer distinct shapes means fewer XLA compiles at
    warmup and fewer dispatches per objective evaluation (octane BE2's
    (41,21)x4 + (40,22)x2 buckets become ONE (22,20) program).  Each
    class is a list of ``(fragment, (pad_occ, pad_vir))`` pairs.
    Exposed so diagnostics (bench stage split) can reuse the exact
    bucketing the solve compiled.
    """
    import os as _os

    buckets: dict[tuple[int, int], list[Fragment]] = {}
    for fr in fragments:
        buckets.setdefault((fr.nao, fr.nsocc), []).append(fr)

    merge_classes: list[list[tuple[Fragment, tuple[int, int]]]] = []
    if (
        solver in ("CCSD", "MP2")
        and not relax_density
        and _os.environ.get("QUEMB_TPU_MERGE_BUCKETS", "1") != "0"
    ):
        # greedy: largest-nao key seeds a class; a key joins if the
        # class target it induces keeps every member's padding <= 25%
        # and the padded shape stays on the batched path (nemb <= 48)
        keys = sorted(buckets, reverse=True)
        classes: list[list[tuple[int, int]]] = []
        for key in keys:
            placed = False
            for cls in classes:
                cand = cls + [key]
                so_t = max(k[1] for k in cand)
                nv_t = max(k[0] - k[1] for k in cand)
                nemb_t = so_t + nv_t
                if nemb_t <= 48 and all(
                    (nemb_t - k[0]) / nemb_t <= 0.25 for k in cand
                ):
                    cls.append(key)
                    placed = True
                    break
            if not placed:
                classes.append([key])
        for cls in classes:
            so_t = max(k[1] for k in cls)
            nv_t = max(k[0] - k[1] for k in cls)
            pairs = []
            for nao, nsocc in cls:
                po, pv = so_t - nsocc, nv_t - (nao - nsocc)
                pairs.extend(
                    (fr, (po, pv)) for fr in buckets[(nao, nsocc)]
                )
            merge_classes.append(pairs)
    else:
        for frs in buckets.values():
            merge_classes.append([(fr, (0, 0)) for fr in frs])
    return merge_classes


def be_func(
    pot,
    fragments: list[Fragment],
    Nocc: int,
    solver: str,
    only_chem: bool = False,
    eeval: bool = False,
    return_vec: bool = False,
    use_cumulant: bool = True,
    relax_density: bool = False,
):
    """Solve all fragments; return error norm / vector / energies.

    Same return contract as reference ``molbe/solver.py:be_func``.
    """
    for fr in fragments:
        if pot is not None:
            fr.update_heff(pot, only_chem=only_chem)

    merge_classes = form_merge_classes(fragments, solver, relax_density)

    total_e = [0.0, 0.0, 0.0]
    for pairs in merge_classes:
        frs = [fr for fr, _ in pairs]
        pads = tuple(p for _, p in pairs)
        e_b = _solve_bucket_batched(
            frs, solver, eeval, use_cumulant, relax_density, pads=pads
        )
        if eeval:
            total_e = [a + b for a, b in zip(total_e, e_b)]

    Ecorr = sum(total_e)
    if eeval and not return_vec:
        return (Ecorr, total_e)
    ernorm, ervec = solve_error(fragments, Nocc, only_chem=only_chem)
    if eeval:
        return (ernorm, ervec, [Ecorr, total_e])
    if return_vec:
        return (ernorm, ervec, None)
    return ernorm


def solve_error(fragments: list[Fragment], Nocc, only_chem: bool = False):
    """Edge-center 1-RDM matching error vector (reference solver.py:683)."""
    err_chempot = 0.0
    if only_chem:
        for fr in fragments:
            for i in fr.weight_and_relAO_per_center[1]:
                err_chempot += fr._rdm1[i, i]
        err_chempot /= fragments[0].unitcell_nkpt
        err = err_chempot - Nocc
        return abs(err), np.asarray([err])

    err_edge = []
    for fr in fragments:
        for edge in fr.relAO_per_edge:
            for j in range(len(edge)):
                for k in range(j, len(edge)):
                    err_edge.append(fr._rdm1[edge[j], edge[k]])
        for i in fr.weight_and_relAO_per_center[1]:
            err_chempot += fr._rdm1[i, i]
    err_chempot /= fragments[0].unitcell_nkpt
    err_edge.append(err_chempot)

    err_cen = []
    for fr in fragments:
        for cidx, cens in enumerate(fr.relAO_in_ref_per_edge):
            ref = fragments[fr.ref_frag_idx_per_edge[cidx]]
            for j in range(len(cens)):
                for k in range(j, len(cens)):
                    err_cen.append(ref._rdm1[cens[j], cens[k]])
    err_cen.append(Nocc)

    err_vec = np.asarray(err_edge) - np.asarray(err_cen)
    norm_ = float(np.mean(err_vec * err_vec) ** 0.5)
    return norm_, err_vec
