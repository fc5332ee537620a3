"""Timers, assertions, and jittable index algebra.

Covers reference ``shared/helper.py``: the FunctionTimer profiling registry,
``@timeit`` decorator, ``ensure`` (always-on check), and the
``ravel_symmetric``-family index algebra (jax-jittable replacements for the
numba-jitted originals and for ``_cpp/indexers.hpp``).
"""

from __future__ import annotations

import time
from collections import defaultdict
from functools import wraps

import jax.numpy as jnp


class EnsureError(RuntimeError):
    pass


def ensure(condition: bool, message: str = "") -> None:
    """Assertion that is never stripped by -O (reference helper.py:62)."""
    if not condition:
        raise EnsureError(message or "Condition not fulfilled")


class FunctionTimer:
    """Accumulates wall time + call counts per decorated function."""

    def __init__(self):
        self.times: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def timeit(self, f):
        @wraps(f)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return f(*args, **kwargs)
            finally:
                self.times[f.__qualname__] += time.perf_counter() - t0
                self.counts[f.__qualname__] += 1

        return wrapper

    def print_top(self, n: int = 10) -> None:
        rows = sorted(self.times.items(), key=lambda kv: -kv[1])[:n]
        width = max((len(k) for k, _ in rows), default=10)
        print(f"{'function':<{width}}  {'calls':>6}  {'total s':>10}")
        for k, v in rows:
            print(f"{k:<{width}}  {self.counts[k]:>6}  {v:>10.3f}")


timer = FunctionTimer()


class Timer:
    """One-shot wall timer (reference helper.py:174)."""

    def __init__(self, message: str = "elapsed"):
        self.message = message
        self.start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def str_elapsed(self, message: str | None = None) -> str:
        return f"{message or self.message}: {self.elapsed():.3f} s"


# ------------------------------------------------- jittable index algebra
def gauss_sum(n):
    return n * (n + 1) // 2


def ravel_symmetric(i, j):
    """Composite index for a symmetric matrix (i >= j assumed-free)."""
    a = jnp.maximum(i, j)
    b = jnp.minimum(i, j)
    return gauss_sum(a) + b


def unravel_symmetric(idx):
    i = ((jnp.sqrt(8.0 * idx + 1.0) - 1.0) // 2).astype(idx.dtype)
    j = idx - gauss_sum(i)
    return i, j


def ravel_eri_idx(i, j, k, l):  # noqa: E741
    """Composite index into an 8-fold symmetric ERI."""
    return ravel_symmetric(ravel_symmetric(i, j), ravel_symmetric(k, l))


def unravel_eri_idx(idx):
    ij, kl = unravel_symmetric(idx)
    i, j = unravel_symmetric(ij)
    k, l = unravel_symmetric(kl)  # noqa: E741
    return i, j, k, l


def ravel_fortran(idx, shape):
    """Column-major ravel (mirrors indexers.hpp ravel_Fortran)."""
    out = 0
    stride = 1
    for i, n in zip(idx, shape):
        out = out + i * stride
        stride = stride * n
    return out


def clean_overlap(M, epsilon: float = 1e-10):
    """Snap near-0/±1 entries of an overlap-like matrix (helper.py:431)."""
    import numpy as np

    M = np.asarray(M).copy()
    M[np.abs(M) < epsilon] = 0.0
    M[np.abs(M - 1.0) < epsilon] = 1.0
    M[np.abs(M + 1.0) < epsilon] = -1.0
    return M


def normalize_column_signs(M):
    """Flip columns so the largest-magnitude entry is positive."""
    import numpy as np

    M = np.asarray(M).copy()
    idx = np.argmax(np.abs(M), axis=0)
    signs = np.sign(M[idx, np.arange(M.shape[1])])
    signs[signs == 0] = 1.0
    return M * signs


def device_memory_budget(nbytes: float) -> float:
    """Byte budget for one device program, given as its size on a 16 GB
    device.

    The budgets of BE construction and of the CCSD lanes were sized for a
    16 GB device.  On the CPU the constant is returned as it stands; on an
    accelerator the budget is the same share of the first device's
    ``memory_stats()["bytes_limit"]``.  A device that reports no memory
    statistics is an error: its size is never assumed.
    """
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return float(nbytes)
    stats = dev.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError(
            f"{dev.device_kind} reports no memory_stats()['bytes_limit'];"
            " cannot size device programs"
        )
    return float(nbytes) / 16e9 * float(stats["bytes_limit"])
