"""Octane BE2-CCSD with density matching (ref example/molbe_octane.py).

The flagship molecular benchmark (BASELINE.md): E_corr = -0.5549 Ha.
Runtime: minutes on CPU; BE construction and the fragment solves run on
the GPU when JAX_PLATFORMS is left at its default.
"""

from quemb_tpu import BE, fragmentate
from quemb_tpu.chem.mole import Mole
from quemb_tpu.chem.scf import RHF

mol = Mole.from_xyz_file("tests/data/xyz/octane.xyz", basis="sto-3g")
mf = RHF(mol, conv_tol=1e-12)
mf.kernel()

fobj = fragmentate(mol=mol, n_BE=2, frag_type="chemgen")
mybe = BE(mf, fobj)
mybe.optimize(solver="CCSD")
print(f"octane BE2-CCSD: E_corr = {mybe.ebe_tot - mybe.ebe_hf:.10f} Ha")
