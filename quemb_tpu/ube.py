"""Unrestricted bootstrap embedding (one-shot UBE-UCCSD).

Mirror of the reference ``molbe/ube.py`` (UBE class) on the device-batched
stack: spin-separated Schmidt spaces, three spin ERI blocks per fragment,
per-spin-channel fragment SCFs, and a generalized spin-orbital UCCSD.
"""

from __future__ import annotations

import logging
import warnings

import numpy as np

import jax
import jax.numpy as jnp

from quemb_tpu.chem.scf import UHF
from quemb_tpu.embed.fragment import Fragment
from quemb_tpu.fragment.frag_part import FragPart
from quemb_tpu.lo.lowdin import lowdin_orth
from quemb_tpu.solvers.dispatch import run_fragment_scf
from quemb_tpu.solvers.uccsd import solve_uccsd

logger = logging.getLogger(__name__)


@jax.jit
def _transform_ab(eri_ao, TA_a, TA_b):
    t = jnp.einsum("pqrs,pi->iqrs", eri_ao, TA_a)
    t = jnp.einsum("iqrs,qj->ijrs", t, TA_a)
    t = jnp.einsum("ijrs,rk->ijks", t, TA_b)
    return jnp.einsum("ijks,sl->ijkl", t, TA_b)


class UBE:
    """Unrestricted BE driver (one-shot only, like the reference)."""

    def __init__(
        self,
        mf: UHF,
        fobj: FragPart,
        *,
        lo_method: str = "lowdin",
        thr_bath: float = 1.0e-10,
    ):
        self.mf = mf
        self.fobj = fobj
        self.mol = mf.mol
        self.thr_bath = thr_bath
        self.unrestricted = True

        na, nb = mf.nelec
        self.Nocc = [na, nb]
        self.enuc = mf.energy_nuc()
        self.hcore = np.asarray(mf.get_hcore())
        self.S = np.asarray(mf.get_ovlp())
        self.C_a = np.asarray(mf.mo_coeff[0])
        self.C_b = np.asarray(mf.mo_coeff[1])
        dm = mf.make_rdm1()
        self.hf_dm = [dm[0], dm[1]]  # occupancy 1 per spin
        veff = mf.get_veff()
        self.hf_veff = [veff[0], veff[1]]
        self.hf_etot = mf.e_tot
        self.uhf_full_e = mf.e_tot
        self.ebe_hf = 0.0
        self.ebe_tot = 0.0

        self.frozen_core = fobj.frozen_core
        self.ncore = 0
        self.E_core = 0.0
        self.core_veff = None
        if self.frozen_core:
            self.ncore = fobj.ncore
            self.Nocc = [na - self.ncore, nb - self.ncore]
            self.hf_dm = [
                self.C_a[:, self.ncore : self.ncore + self.Nocc[0]]
                @ self.C_a[:, self.ncore : self.ncore + self.Nocc[0]].T,
                self.C_b[:, self.ncore : self.ncore + self.Nocc[1]]
                @ self.C_b[:, self.ncore : self.ncore + self.Nocc[1]].T,
            ]
            P_core = [
                self.C_a[:, : self.ncore] @ self.C_a[:, : self.ncore].T,
                self.C_b[:, : self.ncore] @ self.C_b[:, : self.ncore].T,
            ]
            self.P_core = P_core
            self.core_veff = mf.get_veff(dm=np.stack(P_core))
            self.E_core = 0.5 * sum(
                np.einsum(
                    "ji,ji->", 2 * self.hcore + self.core_veff[s], P_core[s]
                )
                for s in (0, 1)
            )
            # fold the per-spin core potential into the valence one-body
            # Hamiltonian and remove it from the mean-field veff, like the
            # restricted driver (mbe.py:417).  The reference's UBE omits
            # this (its hexene frozen-core tests are gated known-to-fail
            # with an ~60 Ha HF-in-HF inconsistency); our invariant holds.
            self.hf_veff = [
                self.hf_veff[0] - self.core_veff[0],
                self.hf_veff[1] - self.core_veff[1],
            ]
            self.hcore_s = [
                self.hcore + np.asarray(self.core_veff[0]),
                self.hcore + np.asarray(self.core_veff[1]),
            ]

        if not self.frozen_core:
            self.hcore_s = [self.hcore, self.hcore]
        self._localize(lo_method)
        self.Fobjs_a: list[Fragment] = []
        self.Fobjs_b: list[Fragment] = []
        self._initialize()

    # ------------------------------------------------------------- localize
    def _localize(self, lo_method: str) -> None:
        if lo_method != "lowdin":
            raise NotImplementedError("UBE supports lowdin localization")
        W = np.asarray(lowdin_orth(jnp.asarray(self.S)))
        if self.frozen_core:
            # per-spin core projection (reference mbe.py:1408 unrestricted)
            Ws = []
            lmos = []
            for s, C in enumerate((self.C_a, self.C_b)):
                P_core = np.eye(W.shape[0]) - self.P_core[s] @ self.S
                C_ = P_core @ W
                Cpop = np.diag(C_.T @ self.S @ C_)
                idx = np.where(Cpop > 0.7)[0]
                C_ = C_[:, idx]
                S_ = C_.T @ self.S @ C_
                es_, vs_ = np.linalg.eigh(S_)
                W_ = (vs_ / np.sqrt(es_)) @ vs_.T
                Ws.append(C_ @ W_)
                lmos.append(Ws[s].T @ self.S @ C[:, self.ncore :])
            self.W = Ws
            self.lmo_coeff_a, self.lmo_coeff_b = lmos
        else:
            self.W = W
            self.lmo_coeff_a = W.T @ self.S @ self.C_a
            self.lmo_coeff_b = W.T @ self.S @ self.C_b

    # ----------------------------------------------------------- initialize
    def _initialize(self) -> None:
        fobj = self.fobj
        eri_ao = jnp.asarray(self.mf.get_eri())
        E_hf = 0.0
        self.Vab = []
        for I in range(fobj.n_frag):
            fr_a = Fragment.from_frag_part(fobj, I)
            fr_b = Fragment.from_frag_part(fobj, I)
            Wa = self.W[0] if self.frozen_core else self.W
            Wb = self.W[1] if self.frozen_core else self.W
            fr_a.sd(Wa, self.lmo_coeff_a, self.Nocc[0], self.thr_bath)
            fr_b.sd(Wb, self.lmo_coeff_b, self.Nocc[1], self.thr_bath)

            from quemb_tpu.ops.eri_transform import incore_transform

            fr_a.eri = np.asarray(
                incore_transform(eri_ao, jnp.asarray(fr_a.TA))
            )
            fr_b.eri = np.asarray(
                incore_transform(eri_ao, jnp.asarray(fr_b.TA))
            )
            Vab = np.asarray(
                _transform_ab(
                    eri_ao, jnp.asarray(fr_a.TA), jnp.asarray(fr_b.TA)
                )
            )
            self.Vab.append(Vab)

            for s, (fr, C, dm_s, veff_s) in enumerate(
                (
                    (fr_a, self.C_a, self.hf_dm[0], self.hf_veff[0]),
                    (fr_b, self.C_b, self.hf_dm[1], self.hf_veff[1]),
                )
            ):
                C_occ = C[:, self.ncore : self.ncore + self.Nocc[s]]
                C_ = fr.TA.T @ self.S @ C_occ
                fr.nsocc = int(round(np.trace(C_ @ C_.T)))
                fr._mo_coeffs = np.linalg.svd(C_)[0]
                fr.h1 = fr.TA.T @ self.hcore_s[s] @ fr.TA
                # cons_fock with dm = 2 * spin density (reference ube.py:262)
                ST = self.S @ fr.TA
                P_emb = ST.T @ (dm_s * 2.0) @ ST
                eri = jnp.asarray(fr.eri)
                vj = np.asarray(
                    jnp.einsum("pqrs,rs->pq", eri, jnp.asarray(P_emb))
                )
                vk = np.asarray(
                    jnp.einsum("prqs,rs->pq", eri, jnp.asarray(P_emb))
                )
                fr.veff0 = fr.TA.T @ veff_s @ fr.TA
                fr.veff = fr.veff0 - (vj - 0.5 * vk)
                fr.fock = fr.h1 + fr.veff
                fr.heff = np.zeros_like(fr.h1)
                fr.dm0 = 2.0 * (
                    fr._mo_coeffs[:, : fr.nsocc]
                    @ fr._mo_coeffs[:, : fr.nsocc].T
                )
                moe, C_frag = run_fragment_scf(fr)
                fr._mo_coeffs = C_frag
                fr.mo_energy = moe
                fr.dm0 = 2.0 * (
                    C_frag[:, : fr.nsocc] @ C_frag[:, : fr.nsocc].T
                )
                E_hf += self._frag_hf_energy(fr)

            self.Fobjs_a.append(fr_a)
            self.Fobjs_b.append(fr_b)

        self.ebe_hf = E_hf + self.enuc + self.E_core
        hf_err = self.hf_etot - self.ebe_hf
        print(f"HF-in-HF error                 :  {hf_err:>.4e} Ha")
        if abs(hf_err) > 1.0e-5:
            warnings.warn("Large HF-in-HF energy error")

    def _frag_hf_energy(self, fr: Fragment) -> float:
        """update_ebe_hf with unrestricted_fac = 1 (reference pfrag.py:327)."""
        C = fr._mo_coeffs[:, : fr.nsocc]
        rho = C @ C.T
        h1 = jnp.asarray(fr.h1)
        veff = jnp.asarray(fr.veff)
        eri = jnp.asarray(fr.eri)
        rho_j = jnp.asarray(rho)
        e1 = jnp.einsum("ij,ij->i", h1, rho_j)
        ec = 0.5 * jnp.einsum("ij,ij->i", veff, rho_j)
        e2 = 0.5 * (
            jnp.einsum("ijkl,ij,kl->i", eri, rho_j, rho_j) * 2.0
            - jnp.einsum("ijkl,ik,jl->i", eri, rho_j, rho_j)
        )
        e_ = np.asarray(e1 + ec + e2)
        w, idx = fr.weight_and_relAO_per_center
        return float(w * e_[list(idx)].sum())

    # --------------------------------------------------------------- oneshot
    def oneshot(self, solver: str = "UCCSD") -> None:
        if solver != "UCCSD":
            raise NotImplementedError("UBE supports the UCCSD solver")
        total_e = [0.0, 0.0, 0.0]
        for fr_a, fr_b, Vab in zip(self.Fobjs_a, self.Fobjs_b, self.Vab):
            # spin-channel fragment SCFs (reference Frags.scf unrestricted)
            _, Ca = run_fragment_scf(fr_a)
            _, Cb = run_fragment_scf(fr_b)
            fr_a.mo_coeffs, fr_b.mo_coeffs = Ca, Cb
            rdm1s, rdm2s, _ = solve_uccsd(
                fr_a, fr_b, Vab, use_cumulant=True
            )
            e_f = self._frag_energy_u(fr_a, fr_b, Vab, rdm1s, rdm2s)
            total_e = [a + b for a, b in zip(total_e, e_f)]
        E = sum(total_e)
        self.ebe_tot = E + self.uhf_full_e
        print(
            f"One-shot UBE ({solver}): E_corr = {E:.10f} Ha, "
            f"E_tot = {self.ebe_tot:.10f} Ha"
        )

    def _frag_energy_u(self, fr_a, fr_b, Vab, rdm1s, rdm2s):
        """Cumulant fragment energy (reference helper.py:get_frag_energy_u)."""
        frs = (fr_a, fr_b)
        if self.frozen_core:
            # vhf from the fragment-SCF densities (uccsd_eri.frank_get_veff)
            rho = [
                fr.mo_coeffs[:, : fr.nsocc] @ fr.mo_coeffs[:, : fr.nsocc].T
                for fr in frs
            ]
            vhf = [
                np.einsum("pqrs,sr->pq", frs[s].eri, rho[s])
                - np.einsum("psrq,sr->pq", frs[s].eri, rho[s])
                for s in (0, 1)
            ]
            vhf[0] = vhf[0] + np.einsum("pqrs,sr->pq", Vab, rho[1])
            vhf[1] = vhf[1] + np.einsum("pqrs,qp->rs", Vab, rho[0])
            core_veffs = [
                fr.TA.T @ self.core_veff[s] @ fr.TA
                for s, fr in enumerate(frs)
            ]
            # effective h1/veff0 after the reference's gcore shuffling
            h1s = [frs[s].h1 + core_veffs[s] for s in (0, 1)]
            veff0s = [core_veffs[s] + vhf[s] for s in (0, 1)]
        else:
            h1s = [fr.h1 for fr in frs]
            veff0s = [fr.veff0 for fr in frs]

        e1 = np.zeros(2)
        ec = np.zeros(2)
        rdm1_embs = []
        for s, fr in enumerate(frs):
            mo = fr.mo_coeffs
            rdm1_emb = mo @ rdm1s[s] @ mo.T
            rdm1_embs.append(rdm1_emb)
            hf_1rdm = (
                mo[:, : fr.nsocc] @ mo[:, : fr.nsocc].T
            )
            delta = 2.0 * (rdm1_emb - hf_1rdm)
            w, idx = fr.weight_and_relAO_per_center
            idx = list(idx)
            e1[s] = w * np.einsum(
                "ij,ij->i", h1s[s], delta
            )[idx].sum()
            ec[s] = w * np.einsum(
                "ij,ij->i", veff0s[s], delta
            )[idx].sum()

        # two-electron cumulant energy
        moa = jnp.asarray(fr_a.mo_coeffs)
        mob = jnp.asarray(fr_b.mo_coeffs)
        G_aa = np.asarray(
            jnp.einsum("ijkl,pi,qj,rk,sl->pqrs", jnp.asarray(rdm2s[0]),
                       moa, moa, moa, moa)
        )
        G_ab = np.asarray(
            jnp.einsum("ijkl,pi,qj,rk,sl->pqrs", jnp.asarray(rdm2s[1]),
                       moa, moa, mob, mob)
        )
        G_bb = np.asarray(
            jnp.einsum("ijkl,pi,qj,rk,sl->pqrs", jnp.asarray(rdm2s[2]),
                       mob, mob, mob, mob)
        )
        w, idx = fr_a.weight_and_relAO_per_center
        idx = list(idx)
        e2_aa = 0.5 * np.einsum(
            "ijkl,ijkl->i", G_aa, fr_a.eri
        )[idx].sum()
        e2_bb = 0.5 * np.einsum(
            "ijkl,ijkl->i", G_bb, fr_b.eri
        )[idx].sum()
        e2_ab = 0.5 * np.einsum("ijkl,ijkl->i", G_ab, Vab)[idx].sum()
        e2_ba = 0.5 * np.einsum("klij,klij->i", G_ab, Vab)[idx].sum()
        e2 = w * (e2_aa + e2_bb + e2_ab + e2_ba)
        return [float(e1.sum()), float(e2), float(ec.sum())]
