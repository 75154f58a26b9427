"""The port's public API: option defaults, the backend registry, the
device contract, and the port's isolation from JAX and the JAX package."""
from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import disc_torch
from repro_torch.api import CompileOptions, Dim, get_backend, list_backends
from repro_torch.api import backends
from repro_torch.api.backends import Backend, register_backend
from repro_torch.core.bucketing import POW2
from repro_torch.core.codegen import ClusterKernel

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_options_defaults():
    o = CompileOptions()
    assert o.backend == "eager"
    assert o.device == "cuda"
    assert o.policy == POW2
    assert o.escalation_threshold is None
    assert o.promote_on_change and o.memory_planning and o.plan_donation
    assert o.max_cache_entries == 256
    assert o.name == "disc"
    assert o.replace(backend="hopper").backend == "hopper"


def test_dim_contract_layers_onto_policy():
    pol = CompileOptions().policy_with_dims(
        [Dim("S", max=2048, multiple_of=8)])
    assert pol.cap("S") == 2048
    assert pol.rule("S") == ("pow2", 8)
    with pytest.raises(ValueError):
        Dim("S", bucket="weird")


def test_registry_lists_and_rejects():
    assert list_backends() == ["eager", "hopper"]
    assert set(get_backend("hopper").cluster_kernels) == {"kLoop", "kInput",
                                                          "kDot"}
    assert get_backend("eager").cluster_kernels == {}
    with pytest.raises(disc_torch.UnknownBackendError, match="registered"):
        get_backend("pallas")
    with pytest.raises(ValueError, match="already registered"):
        register_backend("eager", get_backend("eager"))
    b = register_backend("eager", get_backend("eager"), overwrite=True)
    assert isinstance(b, Backend)


def test_unknown_backend_fails_at_compile():
    with pytest.raises(disc_torch.UnknownBackendError):
        disc_torch.compile(lambda x: x * 2.0, [("S",)], backend="nope",
                           device="cpu")


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(disc_torch.NoDeviceError, match="device='cpu'"):
        disc_torch.compile(lambda x: x * 2.0, [("S",)])
    with pytest.raises(disc_torch.NoDeviceError):
        disc_torch.compile(lambda x: x * 2.0)  # before any call
    f = disc_torch.compile(lambda x: x * 2.0, [("S",)], device="cpu")
    assert torch.equal(f(torch.ones(5)), torch.full((5,), 2.0))


def test_params_from_numpy_defaults_to_the_card():
    """The weight-carrying entry points put tensors on the card unless
    asked for the CPU, through the same check as ``compile``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.convert import (params_from_numpy,
                                            tensor_from_numpy)

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg = get_config("tinyllama_11b")
    tree = {"ln_f": {"scale": np.ones((4,), np.float32)}}
    with pytest.raises(disc_torch.NoDeviceError, match="device='cpu'"):
        params_from_numpy(tree, cfg)
    with pytest.raises(disc_torch.NoDeviceError):
        tensor_from_numpy(np.ones((2,), np.float32))
    got = params_from_numpy(tree, cfg, device="cpu")
    assert got["ln_f"]["scale"].device.type == "cpu"


def test_failing_cluster_kernel_raises_instead_of_running_per_op(
        monkeypatch):
    """A registered kernel that fails surfaces its error on every call: the
    cluster never runs per op in its place, and nothing demotes it."""
    class Broken(ClusterKernel):
        template = "kLoop"

        def run(self, graph, cluster, read, env, masked):
            raise RuntimeError("kLoop kernel failed to launch")

    kern = Broken()
    monkeypatch.setitem(backends._REGISTRY, "broken",
                        backends._make_executor_backend(
                            "broken", "", {"kLoop": kern}))
    f = disc_torch.compile(lambda x: torch.tanh(x) * 2.0 + 1.0, [("S",)],
                           backend="broken", device="cpu")
    for s in (5, 9, 40):
        with pytest.raises(RuntimeError, match="failed to launch"):
            f(torch.ones(s))
    assert kern.runs == 0
    assert f.backend.name == "broken"


def test_eager_backend_escalation_and_inference():
    def f(x, y):
        return (x * y).sum(-1)

    g = disc_torch.compile(f, backend="eager", device="cpu",
                           escalation_threshold=2)
    for s in (5, 9, 9, 9):
        x, y = torch.randn(3, s), torch.randn(3, s)
        torch.testing.assert_close(g(x, y), f(x, y))
    counts = g.compile_counts()
    assert counts["exact"] == 1 and counts["bucket"] == 1
    assert "def _dispatch" in g.dispatch_source


# ------------------------------------------------------------ isolation --

def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, disc_torch, repro_torch.api, repro_torch.models."
            "transformer, repro_torch.kernels.fused_elementwise.ops, "
            "repro_torch.kernels.fused_reduce.ops\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m in ('repro', 'disc'))\n"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stdout + out.stderr


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        sorted((ROOT / "src" / "disc_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "disc", "flax"), \
                f"{path.relative_to(ROOT)} imports {mod}"
