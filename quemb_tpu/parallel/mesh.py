"""Device-mesh fragment parallelism.

The device replacement for the reference's process-pool fragment
parallelism (``molbe/be_parallel.py``): fragments are pure data-parallel work
items, so a bucket's batch axis is sharded over a 1-D ``jax.sharding.Mesh``
("frag" axis) and the same jitted batched kernels run SPMD across devices.
The only cross-device traffic is the tiny gather of per-fragment results
(error-vector entries and energy scalars), which XLA's partitioner inserts.
Every device reaches every other at the same rate, so the mesh follows the
algorithm alone: one axis over fragments.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_MESH: Mesh | None = None


def set_mesh(mesh: Mesh | None) -> None:
    """Install a global fragment mesh (None disables sharding)."""
    global _MESH
    _MESH = mesh


def get_mesh() -> Mesh | None:
    return _MESH


def make_fragment_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices with axis name 'frag'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), axis_names=("frag",))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_batch(arr, mesh: Mesh | None = None):
    """Place a [nf, ...] batch with the leading axis sharded over 'frag'.

    Pads the batch axis (repeating the last element) to a multiple of the
    mesh size; callers slice results back to the true count.  A
    ``jax.Array`` is padded and resharded on the device (device-resident
    fragment ERIs never round-trip through the host); host arrays are
    padded in numpy and placed once.
    """
    mesh = mesh or _MESH
    if mesh is None:
        # no mesh: single-device placement; device arrays pass through
        return jnp.asarray(arr), arr.shape[0]
    xp = jnp if isinstance(arr, jax.Array) else np
    if xp is np:
        arr = np.asarray(arr)
    ndev = mesh.devices.size
    nf = arr.shape[0]
    n_pad = pad_to_multiple(nf, ndev) - nf
    if n_pad:
        arr = xp.concatenate([arr, xp.repeat(arr[-1:], n_pad, axis=0)])
    sharding = NamedSharding(mesh, P("frag", *([None] * (arr.ndim - 1))))
    return jax.device_put(arr, sharding), nf
