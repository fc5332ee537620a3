"""Molecular density-fitting path: DF-vs-in-core parity.

Mirrors the reference's eri_onthefly_test.py (octane BE2 int-direct-DF vs
in-core, dE ~ -6.08e-05 with the weigend aux) at H8 scale with the own
even-tempered auxiliary basis.
"""

import numpy as np

from quemb_tpu import BE, fragmentate
from quemb_tpu.chem.mole import Mole
from quemb_tpu.chem.scf import RHF
from quemb_tpu.ops.df import DFTensor


def _h8_mf():
    mol = Mole(
        atom="; ".join(f"H 0 0 {i * 1.0}" for i in range(8)), basis="sto-3g"
    )
    mf = RHF(mol, conv_tol=1e-12)
    mf.kernel()
    return mol, mf


def test_df_eri_reconstruction():
    mol, mf = _h8_mf()
    dft = DFTensor(mol)
    assert np.abs(dft.eri_full() - mf.get_eri()).max() < 1e-5


def test_df_be2_vs_incore():
    mol, mf = _h8_mf()
    fobj = fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                       print_frags=False)
    be_inc = BE(mf, fobj)
    be_inc.oneshot(solver="CCSD")
    be_df = BE(mf, fobj, int_transform="int-direct-DF")
    be_df.oneshot(solver="CCSD")
    # ETB fit error on the one-shot total (ref eri_onthefly_test.py:66
    # records -6.08e-05 for octane with the weigend aux)
    assert abs(be_df.ebe_tot - be_inc.ebe_tot) < 1e-5


def test_sparse_df_be2_vs_dense_df():
    """sparse-DF (S_abs-screened, reference eri_sparse_DF.py:535) with a
    tight screen reproduces int-direct-DF on H8 at numerical
    precision, and in-core to the fit error."""
    mol, mf = _h8_mf()
    fobj = fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                       print_frags=False)
    be_df = BE(mf, fobj, int_transform="int-direct-DF")
    be_sp = BE(mf, fobj, int_transform="sparse-DF", screen_eps=1e-8)
    for fr_d, fr_s in zip(be_df.fragments, be_sp.fragments):
        assert np.abs(fr_d.eri - fr_s.eri).max() < 1e-9
    be_df.oneshot(solver="MP2")
    be_sp.oneshot(solver="MP2")
    assert abs(be_sp.ebe_tot - be_df.ebe_tot) < 1e-8


def test_sparse_df_reference_production_epsilons():
    """The default screens are the reference's production values
    (MO_coeff_epsilon=1e-5, AO_coeff_epsilon=1e-10; molbe/mbe.py:191-192)
    and their screening error on H8 BE2 stays within the reference's own
    accuracy envelope (its octane sparse-vs-in-core offset is ~2e-5 Ha).
    The legacy single knob still overrides both."""
    from quemb_tpu.ops.sparse_df import SparseDF

    mol, mf = _h8_mf()
    sdf = SparseDF(mol)
    assert sdf.mo_eps == 1e-5 and sdf.ao_eps == 1e-10
    sdf_legacy = SparseDF(mol, screen_eps=1e-7)
    assert sdf_legacy.mo_eps == 1e-7 and sdf_legacy.ao_eps == 1e-7
    fobj = fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                       print_frags=False)
    be_df = BE(mf, fobj, int_transform="int-direct-DF")
    be_sp = BE(mf, fobj, int_transform="sparse-DF")
    assert be_sp.MO_coeff_epsilon == 1e-5
    assert be_sp.AO_coeff_epsilon == 1e-10
    be_df.oneshot(solver="MP2")
    be_sp.oneshot(solver="MP2")
    assert abs(be_sp.ebe_tot - be_df.ebe_tot) < 5e-5


def test_sparse_df_screen_bites():
    """With a loose screen and a fragment-localized TA the reachable-AO
    union is a strict subset, and the screened ERI stays within the
    documented tolerance of the dense transform."""
    from quemb_tpu.ops.df import df_fragment_eri
    from quemb_tpu.ops.sparse_df import SparseDF

    mol = Mole(
        atom="; ".join(f"H 0 0 {i * 1.0}" for i in range(12)),
        basis="sto-3g",
    )
    sdf = SparseDF(mol, screen_eps=1e-3)
    rng = np.random.default_rng(1)
    TA = np.zeros((mol.nao, 3))
    TA[:3] = rng.standard_normal((3, 3))
    eri_s = sdf.fragment_eri(TA)
    assert sdf.last_reach_fraction < 1.0  # screening actually bit
    eri_d = np.asarray(df_fragment_eri(sdf.dft.B, TA))
    assert np.abs(eri_s - eri_d).max() < 1e-2 * np.abs(eri_d).max()
    # tight screen: exact
    sdf2 = SparseDF(mol, screen_eps=1e-12)
    eri_t = sdf2.fragment_eri(TA)
    assert np.abs(eri_t - eri_d).max() < 1e-10


def test_be_out_core_df_matches_direct():
    """int_transform='out-core-DF' (memory-budgeted streamed factors)
    equals int-direct-DF on the same auxiliary basis."""
    mol, mf = _h8_mf()
    fobj = fragmentate(mol=mol, n_BE=1, frag_type="chemgen",
                       print_frags=False)
    from quemb_tpu.ops.df import make_even_tempered_auxbasis

    aux = make_even_tempered_auxbasis(mol)
    be_df = BE(mf, fobj, int_transform="int-direct-DF", auxbasis=aux)
    be_oc = BE(mf, fobj, int_transform="out-core-DF", auxbasis=aux)
    for fr_d, fr_o in zip(be_df.fragments, be_oc.fragments):
        # the near-degenerate ETB metric amplifies ~1e-15 integral
        # differences (native vs python 3c path) through the whitening
        assert np.abs(fr_d.eri - fr_o.eri).max() < 1e-7


def test_streamed_df_matches_dense():
    """Blocked/streamed DF under a tiny memory budget reproduces the
    in-memory DF fragment ERI exactly (reference eri_onthefly.py:18-45
    blocked generation)."""
    from quemb_tpu.ops.df import DFTensor, StreamedDF, df_fragment_eri

    mol, mf = _h8_mf()
    dft = DFTensor(mol)
    sdf = StreamedDF(mol, auxmol=dft.auxmol, max_memory_gb=1e-4)
    rng = np.random.default_rng(0)
    TA = rng.standard_normal((mol.nao, 5))
    eri_dense = np.asarray(df_fragment_eri(dft.B, TA))
    eri_stream = sdf.fragment_eri(TA)
    # block accumulation itself is exact; the residual comes from the
    # whitener (cholesky vs eig pseudo-inverse) acting on the
    # near-degenerate ETB metric, which amplifies ~1e-14 differences in
    # the integral source (native vs python) by the metric condition
    assert np.abs(eri_dense - eri_stream).max() < 1e-6
    # the budget actually forces multiple blocks
    assert sum(1 for _ in sdf.iter_blocks()) > 1


import os  # noqa: E402

import pytest  # noqa: E402


@pytest.mark.skipif(
    os.getenv("QUEMB_TPU_EXPENSIVE_TESTS") != "true",
    reason="expensive: polypropylene DF + CCSD",
)
def test_sparse_df_polypropylene_vs_incore():
    """Beyond-H8 scale: short_polypropylene (28 atoms, the shipped xyz the
    reference uses for sparse-DF development) BE2-CCSD with
    int_transform='sparse-DF' agrees with same-aux dense DF to <= 1e-6 Ha
    (isolating the screen) and with in-core to <= 1e-5 Ha (ETB-fit
    limited; the CD-aux path asserts 1e-8 vs in-core below).  Reference
    oracle analog: tests/test_eri_sparse_DF.py:31-52."""
    import os.path

    mol = Mole.from_xyz_file(
        os.path.join(os.path.dirname(__file__), "data", "xyz",
                     "short_polypropylene.xyz"),
        basis="sto-3g",
    )
    mf = RHF(mol, conv_tol=1e-11)
    mf.kernel()
    fobj = fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                       print_frags=False)
    be_inc = BE(mf, fobj)
    be_inc.oneshot(solver="CCSD")
    be_sp = BE(mf, fobj, int_transform="sparse-DF", screen_eps=1e-7)
    be_sp.oneshot(solver="CCSD")
    assert abs(be_sp.ebe_tot - be_inc.ebe_tot) < 1e-5  # ETB fit + screen
    be_df = BE(mf, fobj, int_transform="int-direct-DF")
    be_df.oneshot(solver="CCSD")
    # screened-vs-dense on the same aux isolates the screening error
    assert abs(be_sp.ebe_tot - be_df.ebe_tot) < 1e-6


def test_df_jk_mean_field():
    """RHF(with_df=True): J/K from DF factors (reference
    be2puffin(use_df=True) -> pyscf density_fit).  Octane measured
    offset vs dense: 9.4e-5 Ha with the ETB aux; H8 here."""
    mol = Mole(
        atom="; ".join(f"H 0 0 {i * 1.0}" for i in range(8)), basis="sto-3g"
    )
    mf_d = RHF(mol, conv_tol=1e-11)
    mf_d.kernel()
    mf_df = RHF(mol, conv_tol=1e-11, with_df=True)
    mf_df.kernel()
    assert mf_df.converged
    assert abs(mf_df.e_tot - mf_d.e_tot) < 2e-5


def test_be2puffin_use_df(tmp_path):
    """be2puffin(use_df=True) no longer raises (reference misc.py:247)."""
    from quemb_tpu.misc import be2puffin

    xyz = tmp_path / "h4.xyz"
    xyz.write_text(
        "4\n\n" + "\n".join(f"H 0 0 {i:.1f}" for i in range(4))
    )
    e_df = be2puffin(str(xyz), "sto-3g", use_df=True, n_BE=1,
                     frozen_core=False)
    e = be2puffin(str(xyz), "sto-3g", n_BE=1, frozen_core=False)
    assert abs(e_df - e) < 5e-5


def test_cholesky_df_exact_and_compact():
    """Pivoted-CD factor (ops/df.py:cholesky_df_factor): every ERI element
    reproduced to the 1e-10 threshold, with a much smaller rank than the
    etb aux set -- the high-accuracy stand-in for the reference's
    tabulated weigend fitting sets (test_eri_sparse_DF.py:28-44)."""
    mol, mf = _h8_mf()
    dft = DFTensor(mol, "cholesky")
    assert np.abs(dft.eri_full() - mf.get_eri()).max() < 1e-9
    assert dft.naux < DFTensor(mol).naux


def test_sparse_df_weigend_alias_vs_incore():
    """BE(int_transform="sparse-DF", auxbasis="weigend") matches the
    in-core one-shot energy to <=1e-8 Ha (reference asserts the weigend
    sparse-DF oracle at atol 1e-10 on total energies,
    tests/test_eri_sparse_DF.py:31; here the CD-backed resolution of
    "weigend" gives a strictly bounded <=1e-10 per-element fit)."""
    mol, mf = _h8_mf()
    fobj = fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                       print_frags=False)
    be_inc = BE(mf, fobj)
    be_inc.oneshot(solver="CCSD")
    be_sp = BE(mf, fobj, int_transform="sparse-DF", auxbasis="weigend",
               screen_eps=1e-10)
    be_sp.oneshot(solver="CCSD")
    assert abs(be_sp.ebe_tot - be_inc.ebe_tot) < 1e-8


def test_on_fly_sparse_df_matches_sparse_df():
    """on-fly-sparse-DF (per-fragment streamed (P|mu nu) recompute,
    reference mbe.py:63-71 enum member) equals precomputed sparse-DF to
    the screening tolerance and in-core to the fit error, with blocks
    bounded by a deliberately tiny memory budget."""
    from quemb_tpu.config import settings
    from quemb_tpu.ops.sparse_df import OnFlySparseDF, SparseDF

    mol, mf = _h8_mf()
    fobj = fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                       print_frags=False)
    be_sp = BE(mf, fobj, int_transform="sparse-DF")
    old = settings.INTEGRAL_TRANSFORM_MAX_MEMORY
    settings.INTEGRAL_TRANSFORM_MAX_MEMORY = 1e-5  # ~few AO rows/block
    try:
        be_of = BE(mf, fobj, int_transform="on-fly-sparse-DF")
    finally:
        settings.INTEGRAL_TRANSFORM_MAX_MEMORY = old
    for fr_s, fr_o in zip(be_sp.fragments, be_of.fragments):
        assert np.abs(fr_s.eri - fr_o.eri).max() < 1e-8
    be_sp.oneshot(solver="MP2")
    be_of.oneshot(solver="MP2")
    assert abs(be_of.ebe_tot - be_sp.ebe_tot) < 1e-8


def test_sparse_df_banded_pair_screen():
    """Banded pair-screened transform == dense DF within the screen bound.

    The geometric AO-pair screen (reference _get_AO_per_AO,
    eri_sparse_DF.py:227) keeps O(N) pairs on extended systems; the device
    formulation RCM-orders the AOs into a fixed-width band and runs the
    first quarter transform as a batched band GEMM
    (sparse_df._banded_eri_bucket).  On an H64 chain the band is half
    the AO dimension and the dropped pairs perturb fragment ERIs by
    less than the S_abs >= 1e-8 screen bound."""
    from quemb_tpu.ops.df import df_transform_batched
    from quemb_tpu.ops.sparse_df import SparseDF

    mol = Mole(
        atom=[("H", [0.0, 0.0, 2.0 * i]) for i in range(64)],
        basis="sto-3g", unit="angstrom",
    )
    sdf = SparseDF(mol)
    plan = sdf._band_plan()
    assert plan is not None
    assert sdf.band_fraction <= 0.6
    rng = np.random.default_rng(7)
    TA = np.linalg.qr(rng.standard_normal((mol.nao, 12)))[0]
    eri_band = sdf.fragment_eri_banded(TA)
    eri_dense = np.asarray(df_transform_batched(sdf.dft.B, TA[None]))[0]
    assert np.abs(eri_band - eri_dense).max() < 1e-8
    # transform_all routes extended systems through the vmapped banded
    # bucket program (the plan is fragment-independent)
    TA2 = np.linalg.qr(rng.standard_normal((mol.nao, 12)))[0]
    outs = sdf.transform_all([TA, TA2])
    assert np.abs(outs[0] - eri_band).max() < 1e-10
    eri2_dense = np.asarray(df_transform_batched(sdf.dft.B, TA2[None]))[0]
    assert np.abs(outs[1] - eri2_dense).max() < 1e-8
    # compact-molecule fallback: no band narrower than nao exists
    mol2 = Mole(atom="O 0 0 0.1; H 0 0.75 -0.45; H 0 -0.7 -0.46",
                basis="sto-3g")
    sdf2 = SparseDF(mol2)
    assert sdf2._band_plan() is None


def test_sparse_df_from_factor_matches_constructor():
    """SparseDF.from_factor over a saved whitened factor reproduces the
    normal constructor's transforms exactly (both the union-gather and
    the banded bucket path route through the same injected B)."""
    from quemb_tpu.ops.sparse_df import SparseDF

    mol = Mole(
        atom=[("H", [0.0, 0.0, 2.0 * i]) for i in range(64)],
        basis="sto-3g", unit="angstrom",
    )
    sdf = SparseDF(mol)
    sdf2 = SparseDF.from_factor(mol, np.array(sdf.dft.B))
    assert sdf2.naux == sdf.naux
    rng = np.random.default_rng(3)
    TA = np.linalg.qr(rng.standard_normal((mol.nao, 10)))[0]
    assert np.array_equal(
        np.asarray(sdf2.fragment_eri_banded(TA)),
        np.asarray(sdf.fragment_eri_banded(TA)),
    )
    assert np.array_equal(
        np.asarray(sdf2.fragment_eri(TA)), np.asarray(sdf.fragment_eri(TA))
    )


def test_sparse_df_from_factor_f32_widen_device_upload():
    """device_upload="f32-widen" ships the factor to the device as f32
    and widens it there; host and device copies must stay bit-equal
    (self.dft.B is widened identically) so the banded and union paths
    agree with a host-side reference transform of the SAME quantized
    factor to f64 machine precision."""
    from quemb_tpu.ops.sparse_df import SparseDF

    mol = Mole(
        atom=[("H", [0.0, 0.0, 2.0 * i]) for i in range(64)],
        basis="sto-3g", unit="angstrom",
    )
    sdf = SparseDF(mol)
    B = np.array(sdf.dft.B)
    sdfc = SparseDF.from_factor(mol, B, device_upload="f32-widen")
    assert sdfc.dft.B.dtype == np.float64
    assert np.array_equal(sdfc.dft.B, B.astype(np.float32).astype(np.float64))
    rng = np.random.default_rng(7)
    TA = np.linalg.qr(rng.standard_normal((mol.nao, 10)))[0]
    eri_band = np.asarray(sdfc.fragment_eri_banded(TA))
    # host reference over the same quantized factor
    Bq = sdfc.dft.B
    Bi = np.einsum("pmn,ni->pmi", Bq, TA)
    Bij = np.einsum("pmi,mj->pij", Bi, TA)
    ref = np.einsum("pij,pkl->ijkl", Bij, Bij)
    assert np.abs(eri_band - ref).max() < 1e-10
    # union-gather path rides the widened device factor too
    eri_u = np.asarray(sdfc.fragment_eri(TA))
    assert np.abs(eri_u - ref).max() < 1e-10


def test_df_fragment_eri_aux_chunked_matches_whole():
    """The aux-chunked scan path (taken when the [naux, nemb, nao]
    intermediate exceeds _DF_CHUNK_BYTES -- the C40 chain regime) is
    bit-identical to the whole-factor quarter transform."""
    import jax

    from quemb_tpu.ops import df

    rng = np.random.default_rng(0)
    B = rng.standard_normal((37, 12, 12))  # 37 % chunk != 0: remainder path
    TA = rng.standard_normal((12, 5))
    ref = np.asarray(df.df_fragment_eri(B, TA))
    orig = df._DF_CHUNK_BYTES
    try:
        df._DF_CHUNK_BYTES = 1e3
        out = np.asarray(jax.jit(df.df_fragment_eri.__wrapped__)(B, TA))
    finally:
        df._DF_CHUNK_BYTES = orig
    assert np.abs(out - ref).max() < 1e-13
