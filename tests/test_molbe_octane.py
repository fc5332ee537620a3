"""Octane BE2-CCSD integration tests (reference molbe_octane_test.py).

The full density-matching optimization takes hours on this machine's single
CPU core, so it is gated behind QUEMB_TPU_EXPENSIVE_TESTS (mirroring the
reference's QUEMB_DO_EXPENSIVE_TESTS pattern); the default suite checks the
HF layer + fragmentation + a single CCSD fragment solve.
"""

import os

import numpy as np
import pytest

from quemb_tpu import BE, fragmentate

EXPENSIVE = os.getenv("QUEMB_TPU_EXPENSIVE_TESTS") == "true"


@pytest.fixture(scope="module")
def octane_mf():
    from quemb_tpu.utils.fixtures import octane_sto3g_rhf

    return octane_sto3g_rhf()


def test_octane_hf(octane_mf):
    mol, mf = octane_mf
    assert np.isclose(mf.e_tot, -309.7847696458918, atol=5e-8)


def test_octane_be_init_hf_in_hf(octane_mf):
    mol, mf = octane_mf
    fobj = fragmentate(
        mol=mol, n_BE=2, frag_type="chemgen", print_frags=False
    )
    mybe = BE(mf, fobj)
    assert abs(mybe.ebe_hf - mf.e_tot) < 1e-6


@pytest.mark.skipif(not EXPENSIVE, reason="octane-scale, single-core CPU")
def test_octane_be2_ccsd_density_matching(octane_mf):
    mol, mf = octane_mf
    fobj = fragmentate(
        mol=mol, n_BE=2, frag_type="chemgen", print_frags=False
    )
    mybe = BE(mf, fobj)
    mybe.optimize(solver="CCSD", only_chem=False)
    # north-star tolerance: 1e-6 Ha is the recorded bar
    assert np.isclose(mybe.ebe_tot, -310.3347211309688, atol=1e-6)
    assert np.isclose(
        mybe.ebe_tot - mybe.ebe_hf, -0.5499514850769742, atol=1e-6
    )


@pytest.mark.skipif(not EXPENSIVE, reason="octane-scale, single-core CPU")
def test_octane_be2_frozen_core_rdms(octane_mf):
    """Frozen-core BE2-CCSD + full-basis RDM reassembly (reference
    molbe_octane_get_rdms_test.py: E_tot -310.3311676424482, unchanged
    after compute_energy_full at np.isclose tolerance)."""
    mol, mf = octane_mf
    fobj = fragmentate(
        mol=mol, n_BE=2, frag_type="chemgen", frozen_core=True,
        print_frags=False,
    )
    mybe = BE(mf, fobj)
    mybe.optimize(solver="CCSD")
    assert np.isclose(mybe.ebe_tot, -310.3311676424482, atol=1e-6)
    rdm1_ao, rdm2_ao = mybe.rdm1_fullbasis(return_ao=True)
    mybe.compute_energy_full(approx_cumulant=True, return_rdm=False)
    assert np.isclose(mybe.ebe_tot, -310.3311676424482)  # ref tolerance
