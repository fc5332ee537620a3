"""Device plumbing that runs without a card: compile-cache location, the
GPU smoke test's refusal on a CPU-only host, mesh resharding of device
arrays, f32 precision of the CCSD stages, and the memory budgets."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

REPO = Path(__file__).resolve().parents[1]


def _run(code_or_args, env_extra=None, cwd=REPO, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    args = code_or_args if isinstance(code_or_args, list) else [
        "-c", code_or_args
    ]
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


_CACHE_DIR = (
    "import quemb_tpu, jax; print(jax.config.jax_compilation_cache_dir)"
)


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the package uses
    the fixed path <checkout>/.jax_cache."""
    if env_dir is None:
        r = _run(_CACHE_DIR, drop=("JAX_COMPILATION_CACHE_DIR",))
        want = str(REPO / ".jax_cache")
    else:
        want = str(tmp_path / "cache")
        r = _run(_CACHE_DIR, {"JAX_COMPILATION_CACHE_DIR": want})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == want


def test_jax_cache_is_gitignored():
    lines = (REPO / ".gitignore").read_text().splitlines()
    assert ".jax_cache/" in lines


def _assert_no_ok_line(r):
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_cpu_only_host():
    r = _run([str(REPO / "chip_smoke.py")])
    _assert_no_ok_line(r)
    assert "needs the GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    _assert_no_ok_line(r)


def test_bench_refuses_cpu_only_host():
    r = _run([str(REPO / "bench.py")])
    assert r.returncode != 0
    assert "needs the GPU" in r.stderr
    assert r.stdout.strip() == ""


@pytest.mark.parametrize("nf", [8, 5, 3])
def test_shard_batch_reshards_device_arrays(nf):
    from quemb_tpu.parallel.mesh import make_fragment_mesh, shard_batch

    mesh = make_fragment_mesh(jax.devices())
    ndev = len(jax.devices())
    x = jnp.arange(nf * 6, dtype=jnp.float64).reshape(nf, 2, 3)
    out, n = shard_batch(x, mesh)
    assert n == nf
    assert isinstance(out, jax.Array)
    assert isinstance(out.sharding, NamedSharding)
    assert out.shape[0] % ndev == 0 and out.shape[0] >= nf
    assert len(out.sharding.device_set) == ndev
    host = np.asarray(out)
    np.testing.assert_array_equal(host[:nf], np.asarray(x))
    # pad lanes repeat the last fragment
    np.testing.assert_array_equal(
        host[nf:], np.repeat(np.asarray(x)[-1:], len(host) - nf, axis=0)
    )


def test_shard_batch_host_array_matches_device_array():
    from quemb_tpu.parallel.mesh import make_fragment_mesh, shard_batch

    mesh = make_fragment_mesh(jax.devices())
    x = np.random.default_rng(0).standard_normal((5, 4))
    a, _ = shard_batch(x, mesh)
    b, _ = shard_batch(jnp.asarray(x), mesh)
    assert a.sharding == b.sharding
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _dot_generals(jaxpr):
    """Every dot_general of a jaxpr, nested jaxprs (jit, while, cond,
    vmap bodies) included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for j in v if isinstance(v, (list, tuple)) else [v]:
                j = getattr(j, "jaxpr", j)  # ClosedJaxpr -> Jaxpr
                if hasattr(j, "eqns"):
                    yield from _dot_generals(j)


@pytest.mark.parametrize("mode", ["mixed", "f32_only"])
def test_f32_ccsd_products_run_at_highest_precision(mode):
    """Every f32 product of the CCSD stages states HIGHEST precision, so a
    GPU runs them in f32 and not TF32."""
    from quemb_tpu.solvers.rccsd import _rccsd_from_mo_batched

    nsocc, nmo = 2, 6
    eri = jnp.zeros((1, nmo, nmo, nmo, nmo))
    moe = jnp.zeros((1, nmo))
    jaxpr = jax.make_jaxpr(
        lambda e, m: _rccsd_from_mo_batched(
            e, m, nsocc, mixed=(mode == "mixed"),
            f32_only=(mode == "f32_only"),
        )
    )(eri, moe)
    f32 = [
        eqn for eqn in _dot_generals(jaxpr.jaxpr)
        if any(v.aval.dtype == jnp.float32 for v in eqn.invars)
    ]
    assert f32, "the f32 stage should contain products"
    H = jax.lax.Precision.HIGHEST
    for eqn in f32:
        assert eqn.params["precision"] == (H, H), eqn


def test_mixed_ccsd_off_on_gpu(monkeypatch):
    from quemb_tpu.solvers import ccsd

    monkeypatch.delenv("QUEMB_TPU_CCSD_MIXED", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert ccsd._use_mixed() is False


def test_mixed_ccsd_opt_in(monkeypatch):
    from quemb_tpu.solvers import ccsd

    monkeypatch.setenv("QUEMB_TPU_CCSD_MIXED", "1")
    assert ccsd._use_mixed() is True


class _FakeDevice:
    platform = "gpu"
    device_kind = "fake"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_memory_budget_cpu_constant():
    from quemb_tpu.utils.helper import device_memory_budget

    assert device_memory_budget(6e9) == 6e9


def test_memory_budget_scales_with_device(monkeypatch):
    from quemb_tpu.utils.helper import device_memory_budget

    dev = _FakeDevice({"bytes_limit": 64e9})
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])
    assert device_memory_budget(6e9) == pytest.approx(24e9)
    assert device_memory_budget(12e9) == pytest.approx(48e9)


@pytest.mark.parametrize("stats", [None, {}])
def test_memory_budget_needs_memory_stats(monkeypatch, stats):
    from quemb_tpu.utils.helper import device_memory_budget

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(stats)])
    with pytest.raises(RuntimeError, match="memory_stats"):
        device_memory_budget(6e9)


def test_ccsd_tolerance_read_per_call(monkeypatch):
    """A changed QUEMB_TPU_CCSD_CONV_TOL takes effect in the same process
    (it is a static argument of the compiled program, not a trace-time
    constant)."""
    from quemb_tpu.chem.mole import Mole
    from quemb_tpu.chem.scf import RHF
    from quemb_tpu.solvers.rccsd import rccsd_large

    mol = Mole(atom="H 0 0 0; H 0 0 1.0; H 0 0 2.0; H 0 0 3.0",
               basis="sto-3g")
    mf = RHF(mol)
    mf.kernel()
    C = mf.mo_coeff
    eri_mo = np.einsum("pqrs,pi,qj,rk,sl->ijkl", mf.get_eri(), C, C, C, C)
    monkeypatch.setenv("QUEMB_TPU_CCSD_CONV_TOL", "1e-3")
    _, _, it_loose, d_loose = rccsd_large(eri_mo, mf.mo_energy, 2)
    monkeypatch.setenv("QUEMB_TPU_CCSD_CONV_TOL", "1e-11")
    _, _, it_tight, d_tight = rccsd_large(eri_mo, mf.mo_energy, 2)
    assert d_loose <= 1e-3 and d_tight <= 1e-11
    assert it_tight > it_loose
