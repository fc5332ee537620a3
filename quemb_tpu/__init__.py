"""quemb_tpu: accelerator-native bootstrap-embedding quantum chemistry.

From-scratch reimplementation of the capabilities of quemb
(github.com/troyvvgroup/quemb): JAX/XLA for all dense linear algebra,
batched/vmapped fragment pipelines instead of process pools, and a
self-contained Gaussian-integral + HF ingestion layer (no PySCF).
"""

import os as _os
from pathlib import Path as _Path

import jax as _jax

_jax.config.update("jax_enable_x64", True)
# Persistent XLA compilation cache.  JAX itself honours
# JAX_COMPILATION_CACHE_DIR; without it the cache sits at a fixed path in
# the checkout, since the path is part of the cache key and a moving
# directory never hits.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        str(_Path(__file__).resolve().parent.parent / ".jax_cache"),
    )
# cache even sub-second compiles: BE construction is ~40 small programs
# whose compiles are individually cheap but sum to seconds per process
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)

from quemb_tpu.api import BE, fragmentate
from quemb_tpu.fragment.chemgen import ChemGenArgs

__all__ = ["BE", "fragmentate", "ChemGenArgs"]
__version__ = "0.1.0"
