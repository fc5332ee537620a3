"""Schmidt decomposition of the HF 1-RDM into fragment + bath orbitals.

Batched form of the reference ``molbe/pfrag.py:schmidt_decomposition``:
an eigendecomposition of the environment block of the localized-orbital 1-RDM.
The bath count is data dependent (eigenvalues in (thr, 1-thr)), so the eigh
runs batched in jax and the thresholding/column selection happens host-side
(it determines array *shapes*, which must be static for everything downstream).
"""

from __future__ import annotations

import numpy as np



def schmidt_decomposition(
    lmo_occ: np.ndarray,
    AO_in_frag: list[int],
    thr_bath: float = 1.0e-10,
    norb: int | None = None,
) -> tuple[np.ndarray, int, int]:
    """Return (TA_lo_eo, n_frag_orb, n_bath) for one fragment.

    Parameters
    ----------
    lmo_occ : [nlo, nocc] occupied orbitals in the localized (orthonormal) basis.
    AO_in_frag : LO indices belonging to the fragment.
    thr_bath : eigenvalue window (thr, 1-thr) selects entangled bath orbitals.
    norb : fix the total orbital count (used by UBE to equalize spin channels).
    """
    nlo = lmo_occ.shape[0]
    Dhf = lmo_occ @ lmo_occ.T
    frag = np.asarray(AO_in_frag, dtype=int)
    env = np.array([i for i in range(nlo) if i not in set(AO_in_frag)], dtype=int)
    Denv = Dhf[np.ix_(env, env)]
    eval_, evec = np.linalg.eigh(Denv)

    if norb is not None:
        n_bath_target = norb - len(frag)
        order = np.argsort(np.abs(eval_))
        below = [x for x in order if np.abs(eval_[x]) < 1.0 - thr_bath]
        first_el = np.abs(eval_[below[-n_bath_target]])
        Bidx = [i for i in range(len(eval_)) if np.abs(eval_[i]) >= first_el]
    else:
        Bidx = [
            i
            for i in range(len(eval_))
            if thr_bath < np.abs(eval_[i]) < 1.0 - thr_bath
        ]

    TA = np.zeros((nlo, len(frag) + len(Bidx)))
    TA[frag, : len(frag)] = np.eye(len(frag))
    TA[env[:, None], len(frag) + np.arange(len(Bidx))[None, :]] = evec[:, Bidx]
    return TA, len(frag), len(Bidx)
