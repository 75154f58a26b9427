"""Twins of the ``pipeline="jit"`` cases of ``tests/test_api.py`` and
``tests/test_dispatch_unification.py``, on the port.

The port's jit pipeline buckets a plain PyTorch function through the same
generated dispatch as the DHLO pipeline; each bucket entry runs the
function eagerly, so "compiles" count entries.  These cases hold it to the
reference's contract: shared caches never collide, pytrees pass through,
§4.4 escalation calls the function at unpadded shapes with one entry per
signature, and both pipelines emit the same extraction, bucket-key and
pad-plan source.  Everything runs on the CPU (``device="cpu"``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import disc_torch
from repro_torch.api import ArgSpec
from repro_torch.core.bucketing import BucketPolicy
from repro_torch.core.cache import CompileCache
from repro_torch.core.dispatcher import (ArgPlan, DynAxis, generate_dispatch,
                                         jit_lens)

F32 = torch.float32


def _jit(**kw):
    return disc_torch.CompileOptions(pipeline="jit", device="cpu", **kw)


def _lines(src, needle):
    return [ln for ln in src.splitlines() if needle in ln]


class TestSharedCache:
    def test_jit_artifacts_never_collide(self):
        shared = disc_torch.CompileCache("shared-jit", max_entries=16)
        opts = _jit(cache=shared)
        f1 = disc_torch.compile(lambda x: x + 1.0, options=opts)
        f2 = disc_torch.compile(lambda x: x * 100.0, options=opts)
        x = torch.ones((2, 2))
        torch.testing.assert_close(f1(x), x + 1.0)
        torch.testing.assert_close(f2(x), x * 100.0)
        assert len(shared) == 2

    def test_jit_bound_methods_of_distinct_instances(self):
        class Eng:
            def __init__(self, scale):
                self.scale = scale

            def step(self, x):
                return x * self.scale

        shared = disc_torch.CompileCache("shared-bound", max_entries=16)
        opts = _jit(cache=shared)
        a = disc_torch.compile(Eng(2.0).step, options=opts)
        b = disc_torch.compile(Eng(100.0).step, options=opts)
        x = torch.ones((2,))
        torch.testing.assert_close(a(x), x * 2.0)
        torch.testing.assert_close(b(x), x * 100.0)
        assert len(shared) == 2


class TestJitPipeline:
    def test_pytree_passthrough_with_bucketed_arg(self):
        def fn(params, tokens, lens):
            emb = params["w"][tokens]            # (1, S, D)
            return emb.sum(dim=1) * lens[0]

        cf = disc_torch.compile(
            fn, specs=[None, ArgSpec((1, "S"), torch.int32), None],
            options=_jit(name="jp"))
        params = {"w": torch.randn(11, 4)}
        for s in (3, 7, 9, 21):
            toks = torch.randint(0, 11, (1, s), dtype=torch.int32)
            out = cf(params, toks, torch.tensor([s], dtype=torch.int32))
            assert out.shape == (1, 4)
        # 3, 7, 9 -> bucket 16; 21 -> 32 (pow2/16): 2 compiles
        assert cf.compile_counts()["bucket"] == 2
        assert "def _dispatch" in cf.dispatch_source

    def test_lowered_text_and_report(self):
        cf = disc_torch.compile(lambda x: x * 2.0, specs=[("S", 4)],
                                options=_jit(name="t"))
        cf(torch.zeros((3, 4)))
        assert "pipeline='jit'" in cf.lower().as_text()
        rep = cf.report()
        assert rep["pipeline"] == "jit" and rep["compiles"]["total"] == 1

    def test_dhlo_rejects_passthrough_specs(self):
        with pytest.raises(ValueError, match="needs an ArgSpec"):
            disc_torch.compile(lambda t, x: x, specs=[None, ("S", 4)],
                               device="cpu")


class TestEmitterParity:
    def test_same_key_and_pad_logic_across_pipelines(self):
        """For an equivalent function/spec, both pipelines emit the
        identical extraction, bucket-key and pad-plan source."""
        specs = [ArgSpec(("S", 4), F32)]
        d = disc_torch.compile(lambda x: torch.tanh(x), specs, device="cpu")
        j = disc_torch.compile(lambda x: torch.tanh(x), specs=specs,
                               options=_jit())
        j(torch.zeros((3, 4)))
        d_src, j_src = d.dispatch_source, j.dispatch_source
        assert _lines(d_src, "s_0 = arrays[0].shape[0]") == \
            _lines(j_src, "s_0 = arrays[0].shape[0]")
        assert _lines(d_src, "key = ") == _lines(j_src, "key = ")
        for needle in ("x0 = arrays[0]", "if tuple(x0.shape) != (key[0], 4):",
                       "_buf[:x0.shape[0], :]",
                       "x0 = None  # plan: free staging"):
            assert _lines(d_src, needle) == _lines(j_src, needle) != []
        # the two pipelines differ only in lens threading + recovery
        assert "lens = " in d_src and "lens = " not in j_src
        assert "outs[0][" in d_src and "outs[0][" not in j_src

    def test_jit_lens_direct(self):
        lens = jit_lens([None, ArgSpec(("S", 4), F32)], ["S"], name="t")
        assert lens.outputs is None and lens.pass_lens is False
        assert lens.args[0] == ArgPlan()            # pytree passthrough
        assert lens.args[1].shape == (DynAxis(0), 4)
        assert lens.sym_sites == (((1, 0),),)

    def test_tie_break_handler_is_pipeline_agnostic(self):
        specs = [ArgSpec(("S", 1), F32), ArgSpec(("S", 1), F32)]
        seen = []
        dispatch, src = generate_dispatch(
            jit_lens(specs, ["S"]), BucketPolicy(kind="exact"),
            CompileCache("t"),
            lambda key: (lambda *a: sum(x.sum() for x in a)),
            on_tie_break=lambda arrays: seen.append(
                tuple(tuple(a.shape) for a in arrays)) or "promoted")
        a = torch.ones((2, 1))
        assert float(dispatch([a, a])) == pytest.approx(4.0)
        assert dispatch([a, torch.ones((3, 1))]) == "promoted"
        assert seen == [((2, 1), (3, 1))]
        assert "_tie_break(arrays)" in src

    def test_cap_enforced_inline(self):
        lens = jit_lens([ArgSpec(("S", 1), F32)], ["S"])
        pol = BucketPolicy(kind="pow2", granule=4, caps=(("S", 8),))
        dispatch, src = generate_dispatch(
            lens, pol, CompileCache("cap"), lambda key: (lambda x: x))
        assert dispatch([torch.ones((5, 1))]).shape == (8, 1)
        with pytest.raises(ValueError, match="max"):
            dispatch([torch.ones((9, 1))])
        assert "min(" in src


class TestJitEscalation:
    def test_hot_exact_shape_escalates_unpadded(self):
        calls = []

        def f(x):
            calls.append(tuple(x.shape))
            return x * 2.0

        cf = disc_torch.compile(f, specs=[ArgSpec(("S", 4))],
                                options=_jit(escalation_threshold=3))
        x = torch.arange(20, dtype=F32).reshape(5, 4)
        outs = [cf(x) for _ in range(5)]
        st = cf.cache_stats()
        assert st["escalations"] == 1
        assert cf.compile_counts() == {"bucket": 1, "exact": 1, "total": 2}
        # pre-escalation calls are bucket-padded (pow2/16), the escalated
        # path runs at the unpadded shape
        assert (16, 4) in calls and (5, 4) in calls
        assert tuple(outs[-1].shape) == (5, 4)
        torch.testing.assert_close(outs[-1], x * 2.0)
        torch.testing.assert_close(outs[0][:5], outs[-1])

    def test_escalated_entries_are_independent(self):
        cf = disc_torch.compile(lambda x: x * 2.0, specs=[ArgSpec(("S", 2))],
                                options=_jit(escalation_threshold=2))
        a, b = torch.ones((3, 2)), torch.ones((5, 2))
        for _ in range(3):
            cf(a)
            cf(b)
        exact = [v for k, v in cf.cache._entries.items() if k[0] == "exact"]
        assert len(exact) == 2 and exact[0] is not exact[1]
        assert cf.compile_counts()["exact"] == 2

    def test_escalation_disabled_by_default_in_jit(self):
        cf = disc_torch.compile(lambda x: x + 1.0, specs=[ArgSpec(("S", 2))],
                                options=_jit())
        x = torch.zeros((3, 2))
        for _ in range(10):
            cf(x)
        assert cf.cache_stats()["escalations"] == 0
        assert "should_escalate" not in cf.dispatch_source

    def test_dhlo_and_jit_escalate_identically(self):
        def f(x):
            return torch.exp(x) + 1.0

        d = disc_torch.compile(f, [ArgSpec(("S", 4))], device="cpu",
                               escalation_threshold=3)
        j = disc_torch.compile(f, specs=[ArgSpec(("S", 4))],
                               options=_jit(escalation_threshold=3))
        x = torch.from_numpy(np.random.randn(5, 4).astype(np.float32))
        for _ in range(4):
            d_out, j_out = d(x), j(x)
        assert d.cache_stats()["escalations"] == 1
        assert j.cache_stats()["escalations"] == 1
        torch.testing.assert_close(d_out, j_out[:5])


class TestDeviceRepairs:
    def test_bridge_defaults_to_the_card(self, monkeypatch):
        """``disc_torch.bridge`` resolves its device like ``compile``: the
        card by default, ``NoDeviceError`` without one."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(disc_torch.NoDeviceError):
            disc_torch.bridge(lambda x: x * 2.0, [ArgSpec(("S", 4))])
        g, _ = disc_torch.bridge(lambda x: x * 2.0, [ArgSpec(("S", 4))],
                                 device="cpu")
        assert [op.opcode for op in g.ops] == ["mul"]

    @pytest.mark.parametrize("name", ["build_exact_executor",
                                      "build_padded_executor"])
    def test_executor_builders_require_a_device(self, name):
        import inspect

        from repro_torch.core import codegen

        param = inspect.signature(getattr(codegen, name)).parameters["device"]
        assert param.kind is inspect.Parameter.KEYWORD_ONLY
        assert param.default is inspect.Parameter.empty
