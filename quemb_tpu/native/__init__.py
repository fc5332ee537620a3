"""Native (C) host kernels, built on demand with the system compiler.

The reference's native layer is its C++/OpenMP sparse-DF extension
(_cpp/eri_sparse_DF.cpp); this package holds the equivalent host-side
kernels (the device side is XLA).  Compilation is lazy and cached; every
consumer has a pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
from pathlib import Path

_HERE = Path(__file__).parent
_LIB = None
_TRIED = False
#: why the last build or load failed (None after a success)
BUILD_ERROR: str | None = None


def _build() -> Path | None:
    srcs = [_HERE / "boys.c", _HERE / "eri.cpp"]
    so = _HERE / "_native.so"
    if so.exists() and all(
        so.stat().st_mtime >= s.stat().st_mtime for s in srcs
    ):
        return so
    global BUILD_ERROR
    # $CXX first, then the system compilers: a toolchain named by $CXX
    # may lack OpenMP (its libgomp), which the kernels need.
    compilers = list(dict.fromkeys(
        c for c in (os.environ.get("CXX"), "g++", "c++") if c
    ))
    # Compile to a per-process temp name and os.rename() it into place:
    # rename is atomic, so concurrent processes can never load a
    # half-written library (they either see the old complete one or the
    # new complete one).
    tmp = _HERE / f"_native.{os.getpid()}.tmp.so"
    errors = []
    for cxx in compilers:
        cmd = [cxx, "-O3", "-march=native", "-fopenmp", "-std=c++17",
               "-fPIC", "-shared",
               *[str(s) for s in srcs], "-o", str(tmp), "-lm"]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=300, text=True)
            os.rename(tmp, so)
            return so
        except subprocess.CalledProcessError as exc:
            errors.append(f"{cxx}: {exc.stderr.strip()[-300:]}")
        except Exception as exc:
            errors.append(f"{cxx}: {exc!r}")
        tmp.unlink(missing_ok=True)
    BUILD_ERROR = "; ".join(errors)
    return None


def _validate(lib) -> bool:
    """Cross-check boys_batch against the pure-numpy formulation.

    The .so is always rebuilt locally, but a stale or miscompiled binary
    (or one built for another ISA that still loads) must never silently
    poison integrals — reject it unless it reproduces the incomplete-gamma
    reference on a spread of T values.
    """
    import numpy as np
    from scipy.special import gammainc, gammaln

    mmax = 12
    T = np.array([0.0, 1e-14, 0.3, 3.0, 11.0, 16.9, 17.1, 40.0, 300.0])
    out = np.empty((mmax + 1, T.size))
    lib.boys_batch(
        mmax,
        np.ascontiguousarray(T).ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)
        ),
        T.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    a = np.arange(mmax + 1)[:, None] + 0.5
    Ts = np.where(T < 1e-13, 1.0, T)[None, :]
    ref = np.exp(gammaln(a)) * gammainc(a, Ts) / (2.0 * Ts**a)
    ref = np.where(
        T[None, :] < 1e-13,
        1.0 / (2 * a) - T[None, :] / (2 * a + 2.0),
        ref,
    )
    return bool(np.all(np.abs(out - ref) < 1e-12 * (1.0 + np.abs(ref))))


def get_lib():
    """ctypes handle of the native library, or None if unavailable.

    The library is rebuilt from source on first use on every machine
    (the .so is never shipped in-tree) and validated against the
    pure-Python fallback before being trusted.
    """
    global _LIB, _TRIED, BUILD_ERROR
    if _LIB is None and not _TRIED:
        _TRIED = True
        so = _build()
        if so is not None:
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as exc:
                BUILD_ERROR = f"load: {exc}"
                return None
            lib.boys_batch.argtypes = [
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_ssize_t,
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.boys_batch.restype = None
            if _validate(lib):
                _LIB = lib
                BUILD_ERROR = None
            else:
                BUILD_ERROR = "boys_batch failed validation"
    return _LIB
