"""Optional DMRG fragment solver via block2 (reference solve_block2,
molbe/solver.py:949).

block2 is a CPU C++ package; like the reference (import inside the
solver, gated by availability) this adapter activates only when
``pyblock2`` is importable and otherwise reports the optional
dependency.  The framework treats DMRG as a host-side specialty
solver — the embedded Hamiltonians are small, so the cost model of the
reference (one block2 run per fragment) carries over unchanged.
"""

from __future__ import annotations

import numpy as np


def block2_available() -> bool:
    try:
        import pyblock2.driver.core  # noqa: F401

        return True
    except Exception:
        return False


def solve_dmrg(
    h_mo: np.ndarray,
    eri_mo: np.ndarray,
    nsocc: int,
    max_m: int = 100,
    n_sweeps: int = 20,
    tol: float = 1e-9,
    scratch: str | None = None,
):
    """(energy, rdm1, rdm2) of the embedded Hamiltonian via block2 DMRG.

    Mirrors the reference's sweep schedule defaults (solver.py:51
    DMRG_ArgsUser: startM..maxM bond-dimension ramp, noise schedule) in
    the modern DMRGDriver API.  RDMs are returned in the same
    (chemist, spatial-orbital, spin-summed) convention as solve_fci.
    """
    if not block2_available():
        raise NotImplementedError(
            "Solver 'DMRG' needs the optional block2 package "
            "(pip install block2); the reference gates solve_block2 "
            "behind the same optional dependency (molbe/solver.py:949)."
        )
    import tempfile

    from pyblock2.driver.core import DMRGDriver, SymmetryTypes

    norb = h_mo.shape[0]
    n_elec = 2 * nsocc
    workdir = scratch or tempfile.mkdtemp(prefix="quemb_tpu_dmrg_")
    driver = DMRGDriver(
        scratch=workdir, symm_type=SymmetryTypes.SU2, n_threads=1
    )
    driver.initialize_system(n_sites=norb, n_elec=n_elec, spin=0)
    mpo = driver.get_qc_mpo(fcidump=None, h1e=h_mo, g2e=eri_mo, ecore=0.0)
    ket = driver.get_random_mps(tag="KET", bond_dim=min(max_m, 50), nroots=1)
    bond_dims = [max(25, max_m // 4)] * 4 + [max_m // 2] * 4 + [max_m] * 8
    noises = [1e-4] * 4 + [1e-5] * 4 + [0.0]
    energy = driver.dmrg(
        mpo,
        ket,
        n_sweeps=n_sweeps,
        bond_dims=bond_dims,
        noises=noises,
        thrds=[tol] * n_sweeps,
    )
    rdm1 = np.asarray(driver.get_1pdm(ket))
    # block2 2pdm is <a+_i a+_j a_k a_l> in physicist order; convert to
    # the chemist (ij|kl) spin-summed convention used by solve_fci
    pdm2 = np.asarray(driver.get_2pdm(ket))
    rdm2 = pdm2.transpose(0, 3, 1, 2)
    return float(energy), rdm1, rdm2
