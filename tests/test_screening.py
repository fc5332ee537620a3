"""Screening layer: absolute overlap bound + the screened sparse-DF path.

Mirrors the reference's sparse-DF screening contract
(eri_sparse_DF.py:929 approx_S_abs, _cpp get_AO_per_MO + screened first
transform): S_abs bounds |S|, unreachable AO blocks can be skipped
without changing the transform."""

import numpy as np

from quemb_tpu.chem.integrals import overlap
from quemb_tpu.chem.mole import Mole
from quemb_tpu.ops.screening import approx_S_abs


def _mol():
    return Mole(
        atom="; ".join(f"H 0 0 {i * 1.0}" for i in range(8)), basis="sto-3g"
    )


def test_s_abs_bounds_overlap():
    mol = _mol()
    S_abs = approx_S_abs(mol)
    S = overlap(mol)
    assert (S_abs + 1e-10 >= np.abs(S)).all()
    assert np.allclose(np.diag(S_abs), 1.0, atol=1e-8)
    # distant pairs screen to ~0
    assert S_abs[0, -1] < 1e-4


def test_sparse_df_f32_pallas_tier_matches_f64(monkeypatch):
    """Under the f32-only CCSD capacity flag (QUEMB_TPU_CCSD_F32_ONLY=1)
    BE(int_transform="sparse-DF") still runs the f64 screened transform,
    and its one-shot MP2 energy stays within 5e-5 Ha of the flagless
    run."""
    from quemb_tpu.chem.scf import RHF
    from quemb_tpu import BE, fragmentate

    mol = _mol()
    mf = RHF(mol, conv_tol=1e-12)
    mf.kernel()
    fobj = fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                       print_frags=False)
    be_ref = BE(mf, fobj, int_transform="sparse-DF")
    be_ref.oneshot(solver="MP2")
    monkeypatch.setenv("QUEMB_TPU_CCSD_F32_ONLY", "1")
    be_f32 = BE(mf, fobj, int_transform="sparse-DF")
    for a, b in zip(be_ref.fragments, be_f32.fragments):
        assert np.asarray(b.eri).dtype == np.float64
        assert np.abs(np.asarray(a.eri) - np.asarray(b.eri)).max() < 1e-12
    be_f32.oneshot(solver="MP2")
    assert abs(be_ref.ebe_tot - be_f32.ebe_tot) < 5e-5
