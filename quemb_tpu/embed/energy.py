"""Fragment energy assembly (cumulant expression).

Dense-tensor reformulation of the reference ``molbe/helper.py:get_frag_energy``
and ``molbe/pfrag.py:update_ebe_hf``: the packed lower-triangular ERI loops of
the reference reduce, for a dense chemist-notation ERI, to plain contractions
over the first ``n_frag`` rows — three einsums.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


@jax.jit
def _hf_energy_rows(h1, veff, eri, rdm_hf):
    """Per-row HF energy contributions (e1, ec, e2) over all rows."""
    e1 = 2.0 * jnp.einsum("ij,ij->i", h1, rdm_hf)
    ec = jnp.einsum("ij,ij->i", veff, rdm_hf)
    e2 = jnp.einsum(
        "ijkl,ij,kl->i", eri, rdm_hf, rdm_hf
    ) * 2.0 - jnp.einsum("ijkl,ik,jl->i", eri, rdm_hf, rdm_hf)
    return e1, ec, e2


def fragment_hf_energy(fr) -> float:
    """HF-in-HF energy contribution of one fragment (update_ebe_hf)."""
    C = fr._mo_coeffs[:, : fr.nsocc]
    rdm_hf = C @ C.T
    e1, ec, e2 = _hf_energy_rows(
        jnp.asarray(fr.h1), jnp.asarray(fr.veff), jnp.asarray(fr.eri),
        jnp.asarray(rdm_hf),
    )
    e_ = np.asarray(e1 + ec + e2)
    w, idx = fr.weight_and_relAO_per_center
    return float(w * e_[list(idx)].sum())


@jax.jit
def _frag_energy_rows(mo, h1, veff0, eri, rdm1_mo, rdm2_mo, nsocc_mask):
    """Cumulant per-row energies (e1, ec, e2) over all embedding rows.

    rdm1_mo: correlated 1-RDM in the fragment-MO basis (trace = 2*nsocc).
    rdm2_mo: cumulant-only 2-RDM in the fragment-MO basis (pyscf convention,
        E2 = 0.5 * sum((ij|kl) * Gamma[ijkl])).
    nsocc_mask: [nmo] 1.0 for occupied fragment MOs.
    """
    rdm1_emb = mo @ (0.5 * rdm1_mo) @ mo.T
    hf_1rdm = (mo * nsocc_mask[None, :]) @ mo.T
    delta = 2.0 * (rdm1_emb - hf_1rdm)
    e1 = jnp.einsum("ij,ij->i", h1, delta)
    ec = jnp.einsum("ij,ij->i", veff0, delta)
    rdm2_emb = jnp.einsum(
        "ijkl,pi,qj,rk,sl->pqrs", 0.5 * rdm2_mo, mo, mo, mo, mo
    )
    e2 = jnp.einsum("ijkl,ijkl->i", rdm2_emb, eri)
    return e1, ec, e2


@jax.jit
def _frag_energy_rows_noncumulant(mo, h1, veff, eri, rdm1_mo, rdm2_mo):
    """Non-cumulant per-row energies (reference helper.py:295-299):
    full 1-RDM against h1 and the environment veff, full 2-RDM against
    the fragment ERI."""
    rdm1_emb = mo @ (0.5 * rdm1_mo) @ mo.T
    e1 = 2.0 * jnp.einsum("ij,ij->i", h1, rdm1_emb)
    ec = jnp.einsum("ij,ij->i", veff, rdm1_emb)
    rdm2_emb = jnp.einsum(
        "ijkl,pi,qj,rk,sl->pqrs", 0.5 * rdm2_mo, mo, mo, mo, mo
    )
    e2 = jnp.einsum("ijkl,ijkl->i", rdm2_emb, eri)
    return e1, ec, e2


def fragment_energy(fr, rdm1_mo, rdm2_mo, use_cumulant: bool = True):
    """Correlated fragment energy triple [e1, e2, ec] (get_frag_energy)."""
    if not use_cumulant:
        e1, ec, e2 = _frag_energy_rows_noncumulant(
            jnp.asarray(fr.mo_coeffs),
            jnp.asarray(fr.h1),
            jnp.asarray(fr.veff),
            jnp.asarray(fr.eri),
            jnp.asarray(rdm1_mo),
            jnp.asarray(rdm2_mo),
        )
        w, idx = fr.weight_and_relAO_per_center
        idx = list(idx)
        return [
            float(w * np.asarray(x)[idx].sum()) for x in (e1, e2, ec)
        ]
    nmo = fr.mo_coeffs.shape[1]
    mask = np.zeros(nmo)
    mask[: fr.nsocc] = 1.0
    e1, ec, e2 = _frag_energy_rows(
        jnp.asarray(fr.mo_coeffs),
        jnp.asarray(fr.h1),
        jnp.asarray(fr.veff0),
        jnp.asarray(fr.eri),
        jnp.asarray(rdm1_mo),
        jnp.asarray(rdm2_mo),
        jnp.asarray(mask),
    )
    w, idx = fr.weight_and_relAO_per_center
    idx = list(idx)
    e1s = float(w * np.asarray(e1)[idx].sum())
    e2s = float(w * np.asarray(e2)[idx].sum())
    ecs = float(w * np.asarray(ec)[idx].sum())
    return [e1s, e2s, ecs]
