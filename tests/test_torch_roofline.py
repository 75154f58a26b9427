"""The port's roofline walks (``repro_torch.roofline``) on known programs:
the twins of ``tests/test_roofline_tools.py``'s five cases, the terms on
the H100's constants, and the walk's bound at the kernel rows' shapes.

* The five cases are written in torch and walked by ``analyze_lowered``
  on a ``"dhlo"`` artifact at its shapes and, where the program has no
  fusion, also by ``analyze_graph`` on its ``make_fx`` trace; each case's
  flops are also held within 1.2x of the reference's ``analyze_hlo_text``
  on the same program compiled by XLA.
* The collectives case runs: a fake process group of two ranks in a
  subprocess (so the group never outlives it), a row-sharded matmul's
  all-reduce counted with its bytes, and an all-reduce inside a scan of
  5 trips counted 5 times.
* ``RooflineTerms`` has the reference's keys, each term the reference's
  scaled by the ratio of the two packages' constants.
* At the shapes of ``PERF.md`` §6 rows 1-4 (the kDot epilogues of
  TinyLlama's MLP, the five library GEMMs, the kLoop and kInput programs)
  the walk's bound equals ``chip_smoke.py``'s ``gemm_bound`` and its
  bytes bound to 1 %.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._higher_order_ops.scan import scan
from torch.fx.experimental.proxy_tensor import make_fx

import disc_torch
from repro.roofline import analysis as ref_analysis
from repro.roofline.hlo_cost import analyze_hlo_text
from repro_torch.roofline import analysis
from repro_torch.roofline.cost import (analyze_graph, analyze_lowered,
                                       cluster_costs)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the kernel rows' bound formulas)

REF_RATIO = 1.2   # the port's walk against the reference's, either way


def _ref_flops(fn, *sds) -> float:
    text = jax.jit(fn).lower(*sds).compile().as_text()
    return analyze_hlo_text(text).flops


def _lowered(fn, specs):
    return disc_torch.compile(fn, specs, pipeline="dhlo",
                              device="cpu").lower()


def _traced(fn, *shapes):
    return make_fx(fn, tracing_mode="fake")(
        *[torch.empty(s) for s in shapes])


def _near_ref(got: float, ref: float) -> bool:
    return max(got, ref) <= REF_RATIO * min(got, ref)


# ------------------------------------------------------------ programs --
def scan10(x):
    def body(c, i):
        return c @ c, []
    return scan(body, x, torch.zeros(10, dtype=x.dtype, device=x.device))[0]


def j_scan10(x):
    def body(c, _):
        return c @ c, None
    return jax.lax.scan(body, x, None, length=10)[0]


def dot(a, b):
    return a @ b


def nested(x):
    def inner(c, i):
        return torch.tanh(c), []

    def outer(c, i):
        z = torch.zeros(4, dtype=c.dtype, device=c.device)
        return scan(inner, c, z)[0], []
    return scan(outer, x, torch.zeros(3, dtype=x.dtype, device=x.device))[0]


def j_nested(x):
    def inner(c, _):
        return jnp.tanh(c), None

    def outer(c, _):
        return jax.lax.scan(inner, c, None, length=4)[0], None
    return jax.lax.scan(outer, x, None, length=3)[0]


def fused(x):
    return torch.exp(x) * 2.0 + 1.0


def j_fused(x):
    return jnp.exp(x) * 2.0 + 1.0


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


# -------------------------------------------------------------- twins --
class TestCostWalks:
    def test_scan_trip_count_multiplies_flops(self):
        expected = 10 * 2 * 256 ** 3
        ref = _ref_flops(j_scan10, _sds(256, 256))
        walked = analyze_lowered(_lowered(scan10, [(256, 256)]), {})
        gm = _traced(scan10, (256, 256))
        traced = analyze_graph(gm)
        for c in (walked, traced):
            assert expected <= c.flops <= expected * 1.2
            assert _near_ref(c.flops, ref), (c.flops, ref)
        # the body counted once (what XLA's own analysis reports) is under
        # a fifth of the total: the trip count multiplied it
        body = next(n for n in gm.graph.nodes
                    if n.target is torch.ops.higher_order.scan).args[0]
        once = analyze_graph(getattr(gm, body.target))
        assert traced.flops > 5 * once.flops

    def test_dot_flops_formula(self):
        expected = 2 * 64 * 32 * 128
        ref = _ref_flops(lambda a, b: a @ b, _sds(64, 128), _sds(128, 32))
        walked = analyze_lowered(_lowered(dot, [(64, 128), (128, 32)]), {})
        traced = analyze_graph(_traced(dot, (64, 128), (128, 32)))
        for c in (walked, traced):
            assert expected <= c.flops <= expected * 1.1
            assert _near_ref(c.flops, ref), (c.flops, ref)

    def test_nested_scans_multiply(self):
        ref = _ref_flops(j_nested, _sds(1024))
        walked = analyze_lowered(_lowered(nested, [(1024,)]), {})
        traced = analyze_graph(_traced(nested, (1024,)))
        for c in (walked, traced):
            assert c.flops >= 3 * 4 * 1024
            assert _near_ref(c.flops, ref), (c.flops, ref)

    def test_collectives_counted_with_loop_multiplier(self):
        """On a fake process group of 2 ranks (a subprocess): a
        row-sharded matmul's all-reduce is its (64, 32) f32 output a rank,
        and an all-reduce of a (16, 16) f32 carry inside a scan of 5 trips
        counts 5 times."""
        script = textwrap.dedent("""
            import json
            import torch
            import torch.distributed._functional_collectives as funcol
            from torch._higher_order_ops.scan import scan
            from torch._subclasses.fake_tensor import FakeTensorMode
            from torch.distributed.tensor import DTensor, Replicate, Shard
            from torch.fx.experimental.proxy_tensor import make_fx
            from repro_torch.launch.dryrun import fake_group
            from repro_torch.launch.mesh import make_mesh
            from repro_torch.roofline.analysis import collective_bytes

            out = {}
            with fake_group(2):
                mesh = make_mesh((2,), ("model",), device_type="cpu")
                mode = FakeTensorMode()
                with mode:
                    a = torch.empty(64, 64)   # (64, 128) split on K
                    b = torch.empty(64, 32)   # (128, 32) split on K
                    x = torch.empty(16, 16)

                def matmul(a, b):
                    A = DTensor.from_local(a, mesh, (Shard(1),),
                                           run_check=False)
                    B = DTensor.from_local(b, mesh, (Shard(0),),
                                           run_check=False)
                    y = (A @ B).redistribute(mesh, (Replicate(),))
                    return y.to_local()

                def looped(x):
                    def body(c, i):
                        y = funcol.all_reduce(c * 2.0, "sum", (mesh, 0))
                        return funcol.wait_tensor(y), []
                    return scan(body, x, torch.zeros(5))[0]

                for name, fn, arg in (("matmul", matmul, (a, b)),
                                      ("scan", looped, (x,))):
                    gm = make_fx(fn, tracing_mode="fake")(*arg)
                    out[name] = collective_bytes(gm)
            print(json.dumps(out))
        """)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run([sys.executable, "-c", script], env=env,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-3000:]
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        mm, sc = got["matmul"], got["scan"]
        assert mm["all-reduce"] == 64 * 32 * 4 and mm["count"] == 1
        assert sum(v for k, v in mm.items() if k != "count") == 64 * 32 * 4
        assert sc["all-reduce"] == 5 * 16 * 16 * 4 and sc["count"] == 5

    def test_bytes_exclude_fused_internals(self):
        ref = _ref_flops(j_fused, _sds(4096))
        low = _lowered(fused, [(4096,)])
        rows = cluster_costs(low, {})
        assert [r["template"] for r in rows] == ["kLoop"]
        c = analyze_lowered(low, {})
        # boundary traffic ~ in + out (not 4 tensors worth)
        assert c.bytes <= 4 * 4096 * 4
        assert c.bytes == 2 * 4096 * 4
        assert _near_ref(c.flops, ref), (c.flops, ref)


# ------------------------------------------------------------- terms --
def _terms(mod, **kw):
    return mod.RooflineTerms(
        arch="a", cell="c", mesh="16x16", chips=256, hlo_flops=3.1e18,
        hlo_bytes=7.7e15, coll_bytes=2.9e13,
        coll_breakdown={"all-reduce": 2.9e13, "count": 4},
        model_flops=2.7e18, bytes_per_device=4e10,
        peak_memory_per_device=4e10, **kw)


@pytest.mark.parametrize("dtype,peak", [
    ("bf16", analysis.H100.PEAK_FLOPS_BF16),
    ("f32", analysis.H100.PEAK_FLOPS_F32)])
def test_roofline_terms_scale_with_constants(dtype, peak):
    port = _terms(analysis, compute_dtype=dtype)
    ref = _terms(ref_analysis)
    got, want = port.as_dict(), ref.as_dict()
    assert set(got) == set(want)
    ref_hw = ref_analysis.HW
    scale = {"t_compute_s": ref_hw.PEAK_FLOPS_BF16 / peak,
             "t_memory_s": ref_hw.HBM_BW / analysis.H100.HBM_BW,
             "t_collective_s": ref_hw.ICI_LINK_BW / analysis.H100.LINK_BW}
    for k, s in scale.items():
        assert got[k] == pytest.approx(want[k] * s, rel=1e-12), k
    same = ["arch", "cell", "mesh", "chips", "hlo_flops", "hlo_bytes",
            "coll_bytes", "coll_breakdown", "model_flops",
            "useful_flops_ratio", "bytes_per_device",
            "peak_memory_per_device"]
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    terms = {"compute": got["t_compute_s"], "memory": got["t_memory_s"],
             "collective": got["t_collective_s"]}
    assert got["dominant"] == max(terms, key=terms.get)
    t_model = port.model_flops / (port.chips * peak)
    assert got["roofline_fraction"] == pytest.approx(
        t_model / max(terms.values()), rel=1e-12)


# ----------------------------------------------------- kernel shapes --
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
T = 2048            # the bucket of path 2's recorded requests
D, F = 2048, 5632   # TinyLlama's widths


def _silu_h(x, wg, h):
    g = x @ wg
    return g * torch.sigmoid(g) * h


def _res(h, wd, r):
    return h @ wd + r


def _cluster(low, sizes, template):
    rows = [r for r in cluster_costs(low, sizes) if r["template"] == template]
    assert len(rows) == 1, [(r["template"], r["opcodes"])
                            for r in cluster_costs(low, sizes)]
    return rows[0]["cost"]


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= 0.01 * max(a, b)


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["silu_h", "res"])
def test_kdot_bound_equals_gemm_bound(form, dname):
    dt = DTYPES[dname]
    elt = torch.empty((), dtype=dt).element_size()
    s = disc_torch.Dim("S", max=T)
    if form == "silu_h":
        fn, k, n = _silu_h, D, F
    else:
        fn, k, n = _res, F, D
    low = _lowered(fn, [((s, k), dt), ((k, n), dt), ((s, n), dt)])
    c = _cluster(low, {"S": T}, "kDot")
    want, by = chip_smoke.gemm_bound(T * k * elt, k * n * elt,
                                     2 * T * n * elt, 2 * T * n * k, dname)
    got, got_by = analysis.bound(c, dname)
    assert _close(got * 1e3, want), (got * 1e3, want)
    assert got_by == by


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("version", sorted(
    k for k in chip_smoke.LIBRARY_SHAPES if k.startswith("library:")))
def test_library_gemm_bound_equals_gemm_bound(version, dname):
    m, k, n = chip_smoke.LIBRARY_SHAPES[version]
    dt = DTYPES[dname]
    elt = torch.empty((), dtype=dt).element_size()
    c = analyze_lowered(_lowered(dot, [((m, k), dt), ((k, n), dt)]), {})
    want, by = chip_smoke.gemm_bound(m * k * elt, k * n * elt, m * n * elt,
                                     2 * m * n * k, dname)
    got, got_by = analysis.bound(c, dname)
    assert _close(got * 1e3, want), (got * 1e3, want)
    assert got_by == by


def _bytes_bound_ms(nbytes: int) -> float:
    return nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["rmsnorm_apply", "softmax_div"])
def test_kloop_bound_equals_bytes_bound(case, dname):
    """The kernel rows' kLoop bound: the inputs as the kernel reads them
    (a broadcast operand once) and the output, over the HBM rate (the
    rows' bound is by bytes)."""
    dt = DTYPES[dname]
    elt = torch.empty((), dtype=dt).element_size()
    s = disc_torch.Dim("S", max=T)
    if case == "rmsnorm_apply":
        low = _lowered(lambda x, r, w: x * r * w,
                       [((1, s, D), dt), ((1, s, 1), dt), ((D,), dt)])
        nbytes = (2 * T * D + T + D) * elt
    else:
        low = _lowered(lambda e, z: e / z[..., None],
                       [((1, 32, s, s), dt), ((1, 32, s), dt)])
        nbytes = (2 * 32 * T * T + 32 * T) * elt
    c = _cluster(low, {"S": T}, "kLoop")
    assert c.bytes == nbytes
    got, by = analysis.bound(c, "f32")
    assert by == "bytes" and _close(got * 1e3, _bytes_bound_ms(nbytes))


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["rows", "one_row", "axis0"])
def test_kinput_bound_equals_bytes_bound(case, dname):
    """The kernel rows' kInput bound: the input read once and one value
    a row written, over the HBM rate."""
    dt = DTYPES[dname]
    elt = torch.empty((), dtype=dt).element_size()
    shape, axis = {"rows": ((2048, 2048), -1), "one_row": ((1, 1 << 22), -1),
                   "axis0": ((2048, 2048), 0)}[case]
    low = _lowered(lambda x: (x * x).sum(axis), [(shape, dt)])
    c = _cluster(low, {}, "kInput")
    n_in = shape[0] * shape[1]
    n_out = n_in // shape[axis]
    nbytes = (n_in + n_out) * elt
    assert c.bytes == nbytes
    got, by = analysis.bound(c, "f32")
    assert by == "bytes" and _close(got * 1e3, _bytes_bound_ms(nbytes))
