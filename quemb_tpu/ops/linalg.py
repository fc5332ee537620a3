"""Refined dense symmetric linear algebra for every backend.

A backend f64 ``eigh`` can be accurate to only ~1e-7 while f64 matmuls are
accurate to ~1e-13.  ``eigh`` here wraps the backend solver with an
iterative refinement built purely from matmuls:

1. Newton-Schulz re-orthonormalization  V <- V (3I - V^T V)/2
2. Rayleigh-Ritz residual  B = V^T A V;  first-order simultaneous Jacobi
   rotation  V <- V (I + E/(w_j - w_i))

Each pass squares the eigenpair error, so two passes push 1e-7 backend error
to f64 roundoff.  On backends with accurate eigh (CPU, cuSOLVER) the
refinement is a cheap no-op; whether it still pays on the GPU is an open
measurement.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: gap threshold below which rotation corrections are suppressed
#: (degenerate subspaces: any orthonormal basis is acceptable)
_GAP_EPS = 1e-8


def _refine_once(A, w, V):
    # re-orthonormalize (V^T V ~ I): one Newton-Schulz step
    G = V.T @ V
    V = V @ (1.5 * jnp.eye(G.shape[0], dtype=A.dtype) - 0.5 * G)
    B = V.T @ A @ V
    w = jnp.diagonal(B)
    E = B - jnp.diag(w)
    denom = w[None, :] - w[:, None]
    # The first-order rotation E/(w_j - w_i) is only valid in the
    # perturbative regime |E| << gap.  Backend eigh error (up to ~1e-7)
    # can exceed a physical near-degeneracy gap, in which case
    # the correction explodes and each pass SQUARES the blow-up.  Suppress
    # pairs whose gap is within 30x of the residual coupling: inside such
    # a cluster any orthonormal basis is equally acceptable.
    unsafe = jnp.abs(denom) < jnp.maximum(_GAP_EPS, 30.0 * jnp.abs(E))
    theta = jnp.where(unsafe, 0.0, E / jnp.where(unsafe, 1.0, denom))
    V = V @ (jnp.eye(A.shape[-1], dtype=A.dtype) + theta)
    return jnp.diagonal(V.T @ A @ V), V


def eigh(A, refine: int = 2):
    """Accurate symmetric eigendecomposition on any backend.

    Returns eigenvalues ascending and the corresponding eigenvectors.
    """
    w, V = jnp.linalg.eigh(A)
    for _ in range(refine):
        w, V = _refine_once(A, w, V)
    # final cleanup: exact ordering + one more orthonormalization step
    order = jnp.argsort(w)
    w = w[order]
    V = V[:, order]
    G = V.T @ V
    V = V @ (1.5 * jnp.eye(G.shape[0], dtype=A.dtype) - 0.5 * G)
    return w, V


def solve_sym(A, b):
    """Solve A x = b for symmetric A via the refined eigh (no LU call)."""
    w, V = eigh(A)
    w_safe = jnp.where(jnp.abs(w) < 1e-14, jnp.inf, w)
    return V @ ((V.T @ b) / w_safe)


def lowdin_inv_sqrt(S, tol: float = 1e-15):
    """S^{-1/2} over the non-singular eigenspace."""
    s, V = eigh(S)
    keep = s > tol
    inv_sqrt = jnp.where(keep, 1.0 / jnp.sqrt(jnp.where(keep, s, 1.0)), 0.0)
    return (V * inv_sqrt) @ V.T


jit_eigh = jax.jit(eigh, static_argnames=("refine",))
