"""Restricted Hartree-Fock in JAX (float64), with DIIS.

Self-contained replacement for ``pyscf.scf.RHF`` as consumed by the reference
driver (``molbe/mbe.py:361-376`` caches ``get_hcore``, ``get_ovlp``,
``mo_coeff``, ``make_rdm1``, ``get_veff``, ``e_tot`` from the mean-field
object).  The SCF iteration runs as dense jax linear algebra; the J/K build
is two dense tensor contractions.
"""

from __future__ import annotations

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from quemb_tpu.chem import integrals  # noqa: E402
from quemb_tpu.chem.mole import Mole  # noqa: E402


def _eigh_gen(F, S):
    """Generalized symmetric eigenproblem F C = S C e via symmetric orthogonalization."""
    from quemb_tpu.ops.linalg import eigh as _eigh

    s, U = _eigh(S)
    X = (U / jnp.sqrt(s)) @ U.T
    e, Cp = _eigh(X.T @ F @ X)
    return e, X @ Cp


def get_jk(eri, dm):
    """Coulomb and exchange matrices from a dense AO ERI (chemist notation)."""
    vj = jnp.einsum("pqrs,rs->pq", eri, dm)
    vk = jnp.einsum("prqs,rs->pq", eri, dm)
    return vj, vk


@jax.jit
def get_jk_df(B, dm):
    """J/K from the whitened DF factor B [naux, nao, nao]:
    J = sum_P B_P tr(B_P dm),  K = sum_P B_P dm B_P (three batched
    matmuls; the molecular analog of kbe/df.py get_jk)."""
    c = jnp.einsum("pmn,mn->p", B, dm)
    vj = jnp.einsum("p,pmn->mn", c, B)
    vk = jnp.einsum("pmr,prn->mn", B @ dm, B)
    return vj, vk


class RHF:
    """Restricted Hartree-Fock on a :class:`Mole`.

    After :meth:`kernel`: ``mo_coeff``, ``mo_energy``, ``mo_occ``, ``e_tot``,
    and cached AO matrices ``hcore``/``S``/``_eri`` are available.
    """

    def __init__(
        self,
        mol: Mole,
        conv_tol: float = 1e-12,
        max_cycle: int = 200,
        with_df: bool = False,
        auxbasis=None,
    ):
        """with_df=True builds J/K from density-fitted 3-center factors
        (reference be2puffin(use_df=True) -> pyscf density_fit; here the
        own DFTensor): O(naux nao^2) memory instead of the dense nao^4
        ERI, J/K as batched contractions."""
        self.mol = mol
        self.conv_tol = conv_tol
        self.max_cycle = max_cycle
        self.with_df = with_df
        self.auxbasis = auxbasis
        self._df_B = None
        self.converged = False
        self.mo_coeff: np.ndarray | None = None
        self.mo_energy: np.ndarray | None = None
        self.e_tot = 0.0
        self._hcore: np.ndarray | None = None
        self._S: np.ndarray | None = None
        self._eri: np.ndarray | None = None

    # --- pyscf-compatible accessors used by the BE driver -------------------
    def get_hcore(self) -> np.ndarray:
        if self._hcore is None:
            self._hcore = integrals.core_hamiltonian(self.mol)
        return self._hcore

    def get_ovlp(self) -> np.ndarray:
        if self._S is None:
            self._S = integrals.overlap(self.mol)
        return self._S

    def get_eri(self) -> np.ndarray:
        if self._eri is None:
            self._eri = integrals.eri_full(self.mol)
        return self._eri

    def get_eri_dev(self):
        """Device copy of the dense AO ERI, uploaded once per mf object.

        BE construction consumes the AO ERI from several device programs
        (veff, the in-core fragment transforms); they all share this one
        copy instead of each copying the [nao^4] tensor again.
        """
        if getattr(self, "_eri_dev", None) is None:
            self._eri_dev = jnp.asarray(self.get_eri())
        return self._eri_dev

    def get_df_B(self):
        """Whitened DF 3-center factor [naux, nao, nao] (with_df path)."""
        if self._df_B is None:
            from quemb_tpu.ops.df import DFTensor

            self._df_B = jnp.asarray(
                DFTensor(self.mol, self.auxbasis).B
            )
        return self._df_B

    def _jk(self, dm):
        if self.with_df:
            B = self.get_df_B()
            return get_jk_df(B, jnp.asarray(dm))
        return get_jk(self.get_eri_dev(), jnp.asarray(dm))

    @property
    def nocc(self) -> int:
        assert self.mol.nelectron % 2 == 0, "RHF needs an even electron count"
        return self.mol.nelectron // 2

    def make_rdm1(self) -> np.ndarray:
        C = self.mo_coeff[:, : self.nocc]
        return 2.0 * C @ C.T

    def get_veff(self, dm: np.ndarray | None = None) -> np.ndarray:
        if dm is None:
            dm = self.make_rdm1()
        vj, vk = self._jk(dm)
        return np.asarray(vj - 0.5 * vk)

    def energy_nuc(self) -> float:
        return self.mol.energy_nuc()

    def energy_tot(self, dm: np.ndarray | None = None) -> float:
        """HF total energy of a given (default: current) 1-RDM."""
        if dm is None:
            dm = self.make_rdm1()
        h = self.get_hcore()
        veff = self.get_veff(dm)
        e_el = float(
            np.einsum("ij,ji->", dm, h)
            + 0.5 * np.einsum("ij,ji->", dm, veff)
        )
        return e_el + self.energy_nuc()

    @property
    def mo_occ(self) -> np.ndarray:
        occ = np.zeros(self.mol.nao)
        occ[: self.nocc] = 2.0
        return occ

    # --- driver -------------------------------------------------------------
    def kernel(self, dm0: np.ndarray | None = None) -> float:
        hcore = jnp.asarray(self.get_hcore())
        S = jnp.asarray(self.get_ovlp())
        nocc = self.nocc
        e, C, e_el, converged = _scf_loop(
            hcore, S, self._jk, nocc, dm0, self.conv_tol, self.max_cycle
        )
        self.mo_energy = np.asarray(e)
        self.mo_coeff = np.asarray(C)
        self.converged = bool(converged)
        self.e_tot = float(e_el) + self.energy_nuc()
        return self.e_tot


def _scf_loop(hcore, S, jk, nocc, dm0, conv_tol, max_cycle, diis_size=8):
    """Roothaan + DIIS iteration (host loop; each step is jax compute).

    Robustness: the density is damped until the DIIS error is small
    (the bare hcore guess oscillates for chains like octane and undamped
    DIIS then diverges), and a divergence triggers one restart with
    heavy damping.
    """
    # GWH (generalized Wolfsberg-Helmholz) guess: far more reliable than
    # bare hcore for extended molecules (hcore mislocates the valence
    # occupations of e.g. alkane chains).
    hd = jnp.diag(hcore)
    F0 = 0.5 * 1.75 * (hd[:, None] + hd[None, :]) * S
    F0 = F0 - jnp.diag(jnp.diag(F0)) + jnp.diag(hd)
    if dm0 is None:
        e, C = _eigh_gen(F0, S)
        dm = 2.0 * C[:, :nocc] @ C[:, :nocc].T
    else:
        dm = jnp.asarray(dm0)
    errs: list = []
    focks: list = []
    e_last = 0.0
    e, C = None, None
    converged = False
    damp = 0.30  # fraction of the OLD density kept while far from SCF
    restarted = False
    cycle = 0
    while cycle < max_cycle:
        cycle += 1
        vj, vk = jk(dm)
        F = hcore + vj - 0.5 * vk
        e_el = jnp.sum((hcore + 0.5 * (vj - 0.5 * vk)) * dm)
        if not np.isfinite(float(e_el)):
            if restarted:
                break
            # diverged: restart from the GWH guess with heavy damping
            restarted = True
            damp = 0.7
            e, C = _eigh_gen(F0, S)
            dm = 2.0 * C[:, :nocc] @ C[:, :nocc].T
            errs.clear()
            focks.clear()
            e_last = 0.0
            continue
        # DIIS on the commutator FDS - SDF
        err = F @ dm @ S - S @ dm @ F
        err_norm = float(jnp.max(jnp.abs(err)))
        errs.append(err)
        focks.append(F)
        if len(errs) > diis_size:
            errs.pop(0)
            focks.pop(0)
        if len(errs) > 1 and err_norm < 2.0:
            F = _diis_extrapolate(errs, focks)
        e, C = _eigh_gen(F, S)
        dm_new = 2.0 * C[:, :nocc] @ C[:, :nocc].T
        if err_norm > 0.05:
            dm_new = (1.0 - damp) * dm_new + damp * dm
        dm_change = float(jnp.max(jnp.abs(dm_new - dm)))
        dm = dm_new
        if (
            abs(float(e_el) - e_last) < conv_tol
            and dm_change < np.sqrt(conv_tol) * 10
            and cycle > 1
        ):
            converged = True
            e_last = float(e_el)
            break
        e_last = float(e_el)
    # final energy with converged density
    vj, vk = jk(dm)
    e_el = jnp.sum((hcore + 0.5 * (vj - 0.5 * vk)) * dm)
    return e, C, float(e_el), converged


class UHF(RHF):
    """Unrestricted Hartree-Fock; spin = Nalpha - Nbeta from the Mole."""

    @property
    def nelec(self) -> tuple[int, int]:
        n = self.mol.nelectron
        s = self.mol.spin
        assert (n + s) % 2 == 0, "inconsistent charge/spin"
        return ((n + s) // 2, (n - s) // 2)

    def make_rdm1(self):
        na, nb = self.nelec
        Ca = self.mo_coeff[0][:, :na]
        Cb = self.mo_coeff[1][:, :nb]
        return np.stack([Ca @ Ca.T, Cb @ Cb.T])

    @property
    def mo_occ(self):
        na, nb = self.nelec
        occ = np.zeros((2, self.mol.nao))
        occ[0, :na] = 1.0
        occ[1, :nb] = 1.0
        return occ

    def get_veff(self, dm=None):
        """[2, nao, nao] spin potentials: J(total) - K(sigma)."""
        if dm is None:
            dm = self.make_rdm1()
        eri = jnp.asarray(self.get_eri())
        dm = jnp.asarray(dm)
        vj = jnp.einsum("pqrs,xrs->pq", eri, dm)
        vka = jnp.einsum("prqs,rs->pq", eri, dm[0])
        vkb = jnp.einsum("prqs,rs->pq", eri, dm[1])
        return np.asarray(jnp.stack([vj - vka, vj - vkb]))

    def kernel(self, dm0=None) -> float:
        hcore = jnp.asarray(self.get_hcore())
        S = jnp.asarray(self.get_ovlp())
        eri = jnp.asarray(self.get_eri())
        na, nb = self.nelec
        if dm0 is None:
            e, C = _eigh_gen(hcore, S)
            dma = C[:, :na] @ C[:, :na].T
            dmb = C[:, :nb] @ C[:, :nb].T
            # break alpha/beta symmetry for open shells
            if na != nb:
                pass
        else:
            dma, dmb = jnp.asarray(dm0[0]), jnp.asarray(dm0[1])
        e_last = 0.0
        errs: list = []
        focks: list = []
        self.converged = False
        for cycle in range(self.max_cycle):
            vj = jnp.einsum("pqrs,rs->pq", eri, dma + dmb)
            vka = jnp.einsum("prqs,rs->pq", eri, dma)
            vkb = jnp.einsum("prqs,rs->pq", eri, dmb)
            Fa = hcore + vj - vka
            Fb = hcore + vj - vkb
            e_el = 0.5 * (
                jnp.sum((hcore + Fa) * dma) + jnp.sum((hcore + Fb) * dmb)
            )
            err = jnp.concatenate(
                [
                    (Fa @ dma @ S - S @ dma @ Fa).ravel(),
                    (Fb @ dmb @ S - S @ dmb @ Fb).ravel(),
                ]
            )
            errs.append(err)
            focks.append(jnp.concatenate([Fa.ravel(), Fb.ravel()]))
            if len(errs) > 8:
                errs.pop(0)
                focks.pop(0)
            if len(errs) > 1:
                Fx = _diis_extrapolate(errs, focks)
                n = hcore.shape[0]
                Fa = Fx[: n * n].reshape(n, n)
                Fb = Fx[n * n :].reshape(n, n)
            ea, Ca = _eigh_gen(Fa, S)
            eb, Cb = _eigh_gen(Fb, S)
            dma_new = Ca[:, :na] @ Ca[:, :na].T
            dmb_new = Cb[:, :nb] @ Cb[:, :nb].T
            delta = float(
                jnp.maximum(
                    jnp.max(jnp.abs(dma_new - dma)),
                    jnp.max(jnp.abs(dmb_new - dmb)),
                )
            )
            dma, dmb = dma_new, dmb_new
            if (
                abs(float(e_el) - e_last) < self.conv_tol
                and delta < np.sqrt(self.conv_tol) * 10
                and cycle > 1
            ):
                self.converged = True
                break
            e_last = float(e_el)
        self.mo_energy = np.stack([np.asarray(ea), np.asarray(eb)])
        self.mo_coeff = np.stack([np.asarray(Ca), np.asarray(Cb)])
        vj = jnp.einsum("pqrs,rs->pq", eri, dma + dmb)
        vka = jnp.einsum("prqs,rs->pq", eri, dma)
        vkb = jnp.einsum("prqs,rs->pq", eri, dmb)
        Fa = hcore + vj - vka
        Fb = hcore + vj - vkb
        e_el = 0.5 * (
            jnp.sum((hcore + Fa) * dma) + jnp.sum((hcore + Fb) * dmb)
        )
        self.e_tot = float(e_el) + self.energy_nuc()
        return self.e_tot


def _diis_extrapolate(errs, focks):
    n = len(errs)
    B = np.empty((n + 1, n + 1))
    B[-1, :] = -1.0
    B[:, -1] = -1.0
    B[-1, -1] = 0.0
    for i in range(n):
        for j in range(n):
            B[i, j] = float(jnp.sum(errs[i] * errs[j]))
    # scale-normalize the Gram block for conditioning (coefficients are
    # invariant; only the Lagrange multiplier rescales)
    scale = max(abs(B[:n, :n]).max(), 1e-280)
    B[:n, :n] /= scale
    rhs = np.zeros(n + 1)
    rhs[-1] = -1.0
    try:
        c = np.linalg.lstsq(B, rhs, rcond=1e-12)[0][:n]
    except np.linalg.LinAlgError:
        return focks[-1]
    if not np.all(np.isfinite(c)) or np.abs(c).sum() > 1e4:
        return focks[-1]
    F = jnp.zeros_like(focks[-1])
    for ci, Fi in zip(c, focks):
        F = F + ci * Fi
    return F
