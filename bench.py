"""Benchmark: octane BE2-CCSD objective evaluations on the GPU.

Times on the default JAX device, after compile warm-up:

- BE construction (fragmentation, Schmidt, ERI transform, fragment
  init), cold and then warm;
- one full all-fragment objective evaluation (fragment SCF + CCSD +
  unrelaxed RDMs + cumulant energies), the median of QUEMB_BENCH_REPS;
- one error-only evaluation (the line-search kind);
- the sparse-DF transform of the octane fragments, checked against the
  fragment ERIs of BE construction.

The mean field comes from the committed RHF fixture, so no integral
generation or SCF runs here.  The amplitude tolerance is 1e-6.

Fails when the default backend is not the GPU.  Prints ONE JSON line
with the walls, the device (platform, device_kind, count) and the card's
name and power limit.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

import jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

os.environ.setdefault("QUEMB_TPU_CCSD_CONV_TOL", "1e-6")


def _wall(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def main():
    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench.py needs the GPU; the default backend is "
            f"{jax.default_backend()!r}"
        )
    from quemb_tpu import BE, fragmentate
    from quemb_tpu.ops.sparse_df import SparseDF
    from quemb_tpu.solvers.dispatch import be_func
    from quemb_tpu.utils.fixtures import octane_sto3g_rhf

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    stages = {}
    (mol, mf), stages["load_fixture"] = _wall(octane_sto3g_rhf)

    def construct():
        fobj = fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                           print_frags=False)
        return BE(mf, fobj)

    be, stages["be_init"] = _wall(construct)
    _, stages["be_init_warm"] = _wall(construct)

    def evaluate(eeval):
        return be_func(be.pot, be.fragments, be.Nocc, "CCSD", eeval=eeval,
                       return_vec=True)

    r, stages["warmup_eval"] = _wall(lambda: evaluate(True))
    ecorr = float(r[2][0])
    reps = int(os.environ.get("QUEMB_BENCH_REPS", "3"))
    times = [_wall(lambda: evaluate(True))[1] for _ in range(reps)]
    wall = float(np.median(times))
    evaluate(False)  # compile the error-only variant
    _, stages["error_only_eval"] = _wall(lambda: evaluate(False))

    def sparse_df():
        sdf = SparseDF(mol)
        return sdf, sdf.transform_all(
            [fr.TA for fr in be.fragments], fetch=False
        )

    (sdf, eris), stages["sparse_df_factor_and_transform"] = _wall(sparse_df)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "octane_be2_ccsd_objective_eval_wall",
        "value": wall,
        "unit": "s",
        "eval_walls": times,
        "oneshot_ecorr": ecorr,
        "n_fragments": len(be.fragments),
        "stages": stages,
        "sparse_df": {
            "mean_reach_fraction": sdf.last_reach_fraction,
            "max_dev_vs_incore_eri": float(max(
                np.abs(np.asarray(e) - np.asarray(fr.eri)).max()
                for e, fr in zip(eris, be.fragments)
            )),
        },
        "peak_bytes_in_use": dev.memory_stats()["peak_bytes_in_use"],
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)


if __name__ == "__main__":
    main()
