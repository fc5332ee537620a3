"""AO -> embedding-basis integral transforms (reference mbe.py:1004 L4 layer).

The in-core path is four successive GEMMs (quarter transforms) per
fragment, vmapped across buckets of fragments with equal embedding dimension.
The DF path (P|mu nu) -> (P|ij) -> Cholesky Gram product lands in ops/df.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@jax.jit
def incore_transform(eri_ao, TA):
    """(mu nu|la si) -> (ij|kl) in the embedding basis defined by TA.

    eri_ao: [nao]*4 chemist notation; TA: [nao, nemb].
    """
    t = jnp.einsum("pqrs,pi->iqrs", eri_ao, TA)
    t = jnp.einsum("iqrs,qj->ijrs", t, TA)
    t = jnp.einsum("ijrs,rk->ijks", t, TA)
    return jnp.einsum("ijks,sl->ijkl", t, TA)


@partial(jax.jit, static_argnames=())
def incore_transform_batched(eri_ao, TA_b):
    """Batched transform for a stack of TAs [nf, nao, nemb]."""
    return jax.vmap(lambda TA: incore_transform(eri_ao, TA))(TA_b)
