"""Committed mean-field fixtures of the checkout (``fixtures/``).

The octane/STO-3G RHF solution ships s8-packed, so the north-star drive
(``chip_smoke.py``, ``bench.py``, the multi-device dryrun) starts from a
converged mean field with no integral generation or SCF.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parents[2]
FIXTURE_DIR = CHECKOUT / "fixtures"


def octane_sto3g_rhf():
    """(mol, mf) for octane in STO-3G with the committed converged RHF."""
    from quemb_tpu.chem.mole import Mole
    from quemb_tpu.chem.scf import RHF
    from quemb_tpu.utils.eri_pack import unpack_eri_s8

    mol = Mole.from_xyz_file(
        str(CHECKOUT / "tests" / "data" / "xyz" / "octane.xyz"),
        basis="sto-3g",
    )
    mf = RHF(mol, conv_tol=1e-12)
    d = np.load(FIXTURE_DIR / "octane_sto3g_hf.npz")
    mf._hcore, mf._S = d["hcore"], d["S"]
    mf._eri = unpack_eri_s8(d["eri_s8"], int(d["nao"]))
    mf.mo_coeff, mf.mo_energy = d["C"], d["moe"]
    mf.e_tot = float(d["e_tot"])
    mf.converged = True
    return mol, mf
