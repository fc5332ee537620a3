"""Smoke test of the main path on one GPU: octane BE2-CCSD density matching.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python chip_smoke.py                # one card: phases 1-4
    python chip_smoke.py --four-cards   # four cards: the fragment mesh only

Phases, each printing its wall time and the numbers it checks:

1. device: JAX devices, the card's name and power limit, jax/jaxlib
   versions, and the native integral library.  A default backend other
   than ``gpu`` ends the run with a non-zero exit code.
2. main path: octane/STO-3G from the committed RHF fixture,
   ``fragmentate(n_BE=2, frag_type="chemgen")``, ``BE(mf, fobj)``,
   ``optimize(solver="CCSD")`` at amplitude tolerance 1e-6.  Checks the
   HF-in-HF error, E_corr against the reference regression value, and that
   the fragment ERIs and fused objective operands live on the GPU.
3. GPU against CPU: one full objective evaluation (``be_func``,
   ``eeval=True``, amplitude tolerance 1e-9) on the GPU and the same
   evaluation in the same process on the CPU backend.
4. sparse-DF at chain width: C40H82/STO-3G, the banded f64 sparse-DF
   transform over all BE2 fragments against the dense DF transform over
   the same whitened factor.

``--four-cards`` builds a fragment mesh over four devices and compares one
octane objective evaluation sharded over the fragment axis with the same
evaluation on one card; it runs no other phase.

Any failed check exits non-zero before the result line.  The last line of
standard output is one JSON object with the device as JAX reports it.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

REF_ECORR = -0.5499514850769742  # octane BE2-CCSD density matching (BASELINE.md)


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(f"  check {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise CheckFailed(what)


def platform_of(x) -> str:
    return {d.platform for d in x.devices()}.pop()


def peak_bytes(dev=None) -> int:
    return int((dev or jax.devices()[0]).memory_stats()["peak_bytes_in_use"])


def phase(name):
    def wrap(fn):
        def run(*args, **kw):
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            print(f"  wall {time.perf_counter() - t0:.3f} s", flush=True)
            return out
        return run
    return wrap


@phase("device")
def phase_device():
    print(f"  devices: {jax.devices()}")
    backend = jax.default_backend()
    if backend != "gpu":
        raise CheckFailed(
            f"default backend is {backend!r}; this smoke test needs the GPU"
        )
    print(f"  device_kind: {sorted({d.device_kind for d in jax.devices()})}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        print(f"  card: {line.strip()}")
    import jaxlib

    print(f"  jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    from quemb_tpu import native

    lib = native.get_lib()
    if lib is None:
        print(f"  native library: {native.BUILD_ERROR}")
    check(lib is not None, "native integral library built and loaded")


def octane_be():
    from quemb_tpu import BE, fragmentate
    from quemb_tpu.utils.fixtures import octane_sto3g_rhf

    mol, mf = octane_sto3g_rhf()
    fobj = fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                       print_frags=False)
    return BE(mf, fobj)


@phase("main path: octane BE2-CCSD optimize()")
def phase_main_path(make_be, ref_ecorr):
    from quemb_tpu.solvers import dispatch

    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = "1e-6"
    t0 = time.perf_counter()
    be = make_be()
    print(f"  BE construction wall {time.perf_counter() - t0:.3f} s")
    hf_err = be.hf_etot - be.ebe_hf
    print(f"  HF-in-HF error {hf_err:.3e} Ha")
    check(abs(hf_err) < 1e-6, "|HF-in-HF error| < 1e-6 Ha")
    eri_platforms = {
        platform_of(fr.eri) if isinstance(fr.eri, jax.Array) else "host"
        for fr in be.fragments
    }
    print(f"  fragment ERIs on: {sorted(eri_platforms)}")
    check(eri_platforms == {"gpu"}, "fragment ERIs live on the GPU")
    t0 = time.perf_counter()
    be.optimize(solver="CCSD")
    print(f"  optimize wall {time.perf_counter() - t0:.3f} s")
    ecorr = be.ebe_tot - be.ebe_hf
    print(f"  E_corr {ecorr:.10f} Ha, reference {ref_ecorr:.10f} Ha, "
          f"diff {ecorr - ref_ecorr:.3e} Ha")
    check(abs(ecorr - ref_ecorr) <= 1e-6, "|E_corr - reference| <= 1e-6 Ha")
    operand_platforms = {
        platform_of(v)
        for entry in dispatch._BUCKET_DEV_CACHE.values()
        for k, v in entry.items() if k != "eri_ref"
    }
    print(f"  fused objective operands on: {sorted(operand_platforms)}")
    check(operand_platforms == {"gpu"},
          "fused objective operands live on the GPU")
    print(f"  peak_bytes_in_use {peak_bytes()}")
    return be


def evaluate(be, frs):
    from quemb_tpu.solvers.dispatch import be_func

    _, ervec, (ecorr, _) = be_func(
        None, frs, be.Nocc, "CCSD", eeval=True, return_vec=True
    )
    return float(ecorr), np.asarray(ervec)


def host_copy(frs):
    """The fragments with every array on the host (fresh device caches)."""
    return [
        dataclasses.replace(
            fr, eri=np.asarray(fr.eri), rdm1__=None, rdm2__=None
        )
        for fr in frs
    ]


@phase("GPU against the CPU reference: one full objective evaluation")
def phase_reference(be):
    from quemb_tpu.solvers import dispatch

    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = "1e-9"
    t0 = time.perf_counter()
    e_gpu, v_gpu = evaluate(be, be.fragments)
    print(f"  GPU evaluation wall {time.perf_counter() - t0:.3f} s")
    frs_cpu = host_copy(be.fragments)
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        e_cpu, v_cpu = evaluate(be, frs_cpu)
    print(f"  CPU evaluation wall {time.perf_counter() - t0:.3f} s")
    tokens = {fr._cache_token for fr in frs_cpu}
    cpu_platforms = {
        platform_of(v)
        for key, entry in dispatch._BUCKET_DEV_CACHE.items()
        if tokens & set(key)
        for k, v in entry.items() if k != "eri_ref"
    }
    check(cpu_platforms == {"cpu"}, "reference operands live on the CPU")
    d_e = abs(e_gpu - e_cpu)
    d_v = float(np.max(np.abs(v_gpu - v_cpu)))
    print(f"  E_corr GPU {e_gpu:.12f} CPU {e_cpu:.12f} |diff| {d_e:.3e} Ha")
    print(f"  error vector max |diff| {d_v:.3e}")
    check(d_e <= 1e-8, "|dE_corr| <= 1e-8 Ha")
    check(d_v <= 1e-7, "max |d error vector| <= 1e-7")


def chain_fragments(fixture):
    """(mol, fragment bases TA) for the alkane chain of a DF-HF fixture."""
    from quemb_tpu import fragmentate
    from quemb_tpu.chem.mole import Mole
    from quemb_tpu.embed.fragment import Fragment
    from quemb_tpu.utils.geometry import alkane_atoms

    d = np.load(fixture)
    mol = Mole(atom=alkane_atoms(int(d["n_carbons"])), basis="sto-3g")
    es, vs = np.linalg.eigh(d["S"])
    W = (vs / np.sqrt(es)) @ vs.T
    lmo = W.T @ d["S"] @ d["C"]
    fobj = fragmentate(mol=mol, n_BE=2, frag_type="chemgen",
                       print_frags=False)
    TAs = []
    for i in range(fobj.n_frag):
        fr = Fragment.from_frag_part(fobj, i)
        fr.sd(W, lmo, mol.nelectron // 2, thr_bath=1.0e-10)
        TAs.append(fr.TA)
    return mol, TAs


def dense_transform(B_dev, TAs, chunk=4):
    from quemb_tpu.ops.df import df_transform_batched

    out = [None] * len(TAs)
    buckets = {}
    for i, TA in enumerate(TAs):
        buckets.setdefault(TA.shape[1], []).append(i)
    for idxs in buckets.values():
        for c0 in range(0, len(idxs), chunk):
            part = idxs[c0 : c0 + chunk]
            eb = df_transform_batched(B_dev, np.stack([TAs[i] for i in part]))
            for j, i in enumerate(part):
                out[i] = eb[j]
    return jax.block_until_ready(out)


@phase("sparse-DF against dense DF at chain width")
def phase_chain(fixture, auxbasis="etb:6.0"):
    from quemb_tpu.ops.sparse_df import SparseDF

    mol, TAs = chain_fragments(fixture)
    print(f"  {os.path.basename(fixture)}: nao {mol.nao}, "
          f"{len(TAs)} BE2 fragments, nemb {sorted({t.shape[1] for t in TAs})}")
    t0 = time.perf_counter()
    sdf = SparseDF(mol, auxbasis)
    print(f"  host factor build wall {time.perf_counter() - t0:.3f} s "
          f"(naux {sdf.naux}, aux {auxbasis})")
    check(sdf._band_plan() is not None, "the pair screen forms a band")
    print(f"  band fraction {sdf.band_fraction:.4f}")
    t0 = time.perf_counter()
    eris_s = jax.block_until_ready(sdf.transform_all(TAs, fetch=False))
    print(f"  sparse transform wall {time.perf_counter() - t0:.3f} s "
          "(band gather and compiles included)")
    t0 = time.perf_counter()
    B_dev = jax.block_until_ready(jnp.asarray(sdf.dft.B))
    eris_d = dense_transform(B_dev, TAs)
    print(f"  dense transform wall {time.perf_counter() - t0:.3f} s "
          "(factor copy and compiles included)")
    on = {platform_of(e) for e in eris_s + eris_d}
    print(f"  fragment ERIs on: {sorted(on)}")
    dev = max(
        float(jnp.max(jnp.abs(a - b))) for a, b in zip(eris_s, eris_d)
    )
    print(f"  max |sparse - dense| over {len(TAs)} fragments {dev:.3e}")
    check(len(eris_s) == len(TAs) and all(
        e.shape == (t.shape[1],) * 4 for e, t in zip(eris_s, TAs)
    ), "one [nemb]^4 ERI per fragment")
    check(dev <= 1e-10, "max |sparse - dense| <= 1e-10")
    print(f"  peak_bytes_in_use {peak_bytes()}")


@phase("fragment mesh over four devices against one device")
def phase_four_cards(make_be, n=4, seed=0):
    from quemb_tpu.parallel.mesh import make_fragment_mesh, set_mesh
    from quemb_tpu.solvers import dispatch
    from quemb_tpu.solvers.dispatch import be_func

    devs = jax.devices()
    print(f"  devices: {devs}")
    if len(devs) < n:
        raise CheckFailed(f"{n} devices needed, {len(devs)} found")
    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = "1e-9"
    be = make_be()
    pot = 1e-3 * np.random.default_rng(seed).standard_normal(len(be.pot))

    def run():
        t0 = time.perf_counter()
        _, ervec, (ecorr, _) = be_func(
            pot, be.fragments, be.Nocc, "CCSD", eeval=True, return_vec=True
        )
        return float(ecorr), np.asarray(ervec), time.perf_counter() - t0

    e1, v1, w1 = run()
    print(f"  one device: E_corr {e1:.12f} Ha, wall {w1:.3f} s")
    mesh = make_fragment_mesh(devs[:n])
    set_mesh(mesh)
    try:
        en, vn, wn = run()
    finally:
        set_mesh(None)
    print(f"  {n}-device mesh: E_corr {en:.12f} Ha, wall {wn:.3f} s")
    spread = {
        len(v.sharding.device_set)
        for key, entry in dispatch._BUCKET_DEV_CACHE.items()
        if key[-1] is mesh
        for k, v in entry.items() if k != "eri_ref"
    }
    check(spread == {n}, f"mesh operands sharded over {n} devices")
    d_e = abs(en - e1)
    print(f"  |dE_corr| {d_e:.3e} Ha, error vector max |diff| "
          f"{float(np.max(np.abs(vn - v1))):.3e}")
    check(d_e <= 1e-10, "|dE_corr(mesh) - E_corr(one device)| <= 1e-10 Ha")
    for d in devs[:n]:
        print(f"  {d}: peak_bytes_in_use {peak_bytes(d)}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the four-device fragment-mesh phase",
    )
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    phase_device()
    if args.four_cards:
        phase_four_cards(octane_be)
    else:
        be = phase_main_path(octane_be, REF_ECORR)
        phase_reference(be)
        from quemb_tpu.utils.fixtures import FIXTURE_DIR

        phase_chain(str(FIXTURE_DIR / "c40_sto3g_dfhf.npz"))
    print(f"== total wall {time.perf_counter() - t0:.3f} s", flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
