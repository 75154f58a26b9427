"""Roofline terms of a traced dry-run cell on the H100, the counterpart of
the JAX package's ``roofline/analysis.py``.

    compute term    = FLOPs / (chips x peak_FLOP/s of the compute dtype)
    memory term     = bytes / (chips x HBM_bw)
    collective term = collective_bytes / (chips x link_bw)

Sources: the cost walk over the traced per-rank graph
(:func:`repro_torch.roofline.cost.analyze_graph`) for FLOPs, bytes and
the collectives' operand bytes by kind; a liveness walk over the same
graph for the memory a rank holds.

Hardware constants: the H100 SXM's data-sheet values at 700 W (the same
that ``chip_smoke.py`` reads from :class:`H100`).  The compute term
divides by the peak of the cell's compute dtype: the dense bf16
tensor-core rate for a bf16 config, the f32 non-tensor (FFMA) rate for
an f32 one, since the port's f32 work is IEEE f32.  The link rate is the
50 GB/s a card each way of the one 400 Gb/s NIC that the collectives of
a 16-rank mesh axis cross once eight cards fill a node; within a node
NVLink gives 450 GB/s a card each way (:attr:`H100.NVLINK_BW`), which
the terms do not use.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from .cost import COLLECTIVES, Cost, analyze_graph, node_bytes

__all__ = ["H100", "HW", "RooflineTerms", "analyze_traced", "bound",
           "collective_bytes", "peak_flops", "liveness"]


class H100:
    """H100 SXM data-sheet rates (700 W), per card."""

    HBM_BW = 3.35e12              # bytes/s
    PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor-core flop/s
    PEAK_FLOPS_F32 = 67e12        # f32 non-tensor (FFMA) flop/s
    PEAK_FLOPS_TF32 = 495e12      # dense TF32 tensor-core flop/s
    LINK_BW = 50e9                # bytes/s each way: one 400 Gb/s NIC
    NVLINK_BW = 450e9             # bytes/s each way within a node


#: the reference's name for its hardware class
HW = H100


def peak_flops(compute_dtype: str) -> float:
    """The peak flop/s the compute term divides by: ``"bf16"`` the
    tensor-core rate, ``"f32"`` the FFMA rate."""
    return {"bf16": H100.PEAK_FLOPS_BF16,
            "f32": H100.PEAK_FLOPS_F32}[compute_dtype]


def bound(cost: Cost, compute_dtype: str) -> Tuple[float, str]:
    """``(seconds, "bytes" | "operations")``: the larger of ``cost``'s
    bytes over the HBM rate and its flops over ``compute_dtype``'s peak
    (one rank's least time for the work; ``chip_smoke.py``'s kernel-row
    bound)."""
    t_bytes = cost.bytes / H100.HBM_BW
    t_ops = cost.flops / peak_flops(compute_dtype)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def collective_bytes(gm) -> Dict[str, float]:
    """Operand bytes per collective kind of a traced per-rank graph (the
    reference's five HLO names) and their ``count``, loops multiplied."""
    c = analyze_graph(gm)
    out: Dict[str, float] = {k: c.coll[k] for k in COLLECTIVES}
    out["count"] = c.coll_count
    return out


@dataclass
class RooflineTerms:
    arch: str
    cell: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, float]
    model_flops: float
    bytes_per_device: float = 0.0
    peak_memory_per_device: float = 0.0
    #: "bf16" | "f32": the peak the compute term divides by
    compute_dtype: str = "bf16"

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * peak_flops(self.compute_dtype))

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * H100.HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * H100.LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the binding roofline the useful work achieves:
        t_model_compute / max(all terms) — 1.0 means the dominant term is
        exactly the useful compute."""
        t_model = self.model_flops / (self.chips
                                      * peak_flops(self.compute_dtype))
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_model / bound if bound else 0.0

    def as_dict(self) -> Dict:
        return {
            "arch": self.arch, "cell": self.cell, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "bytes_per_device": self.bytes_per_device,
            "peak_memory_per_device": self.peak_memory_per_device,
        }


def liveness(gm) -> Dict[str, int]:
    """Memory of one rank over a traced graph run in execution order:
    ``argument`` (the placeholders' bytes: the local shards), ``output``
    (the returned values' bytes) and ``temp`` (the peak bytes of live
    intermediates).  A value is born at its node and dies after its last
    user (a returned value lives to the end); a node whose output aliases
    its first input (a view, an in-place op, ``wait_tensor``, ``getitem``
    of a node returning several values) allocates nothing and keeps that
    input alive."""
    nodes = list(gm.graph.nodes)
    owner: Dict[Any, Any] = {}
    for n in nodes:
        src = n.all_input_nodes[0] if n.all_input_nodes else None
        owner[n] = owner[src] if (src is not None and n.op == "call_function"
                                  and _aliases(n)) else n
    last: Dict[Any, int] = {}
    for i, n in enumerate(nodes):
        for a in n.all_input_nodes:
            last[owner[a]] = i
    keep, outs = set(), 0
    for n in nodes:
        if n.op == "output":
            for a in n.all_input_nodes:
                keep.add(owner[a])
                outs += node_bytes(a)
    dies: Dict[int, list] = {}
    for r, i in last.items():
        if r not in keep:
            dies.setdefault(i, []).append(r)
    live = peak = 0
    for i, n in enumerate(nodes):
        if n.op == "call_function" and owner[n] is n:
            live += node_bytes(n)
            peak = max(peak, live)
            if n not in last and n not in keep:
                live -= node_bytes(n)            # never read
        for r in dies.get(i, ()):
            if r.op == "call_function":
                live -= node_bytes(r)
    args = sum(node_bytes(n) for n in nodes if n.op == "placeholder")
    return {"argument": args, "output": outs, "temp": peak}


def _aliases(node) -> bool:
    """True where the node's output is (part of) its first input's
    storage."""
    t = node.target
    if t is operator.getitem:
        return True
    schema = getattr(t, "_schema", None)
    return schema is not None and any(r.alias_info is not None
                                      for r in schema.returns)


def analyze_traced(gm, *, arch: str, cell: str, mesh_name: str, chips: int,
                   model_flops: float, compute_dtype: str = "bf16",
                   cost: Optional[Cost] = None,
                   memory: Optional[Dict[str, int]] = None) -> RooflineTerms:
    """Roofline terms from a traced per-rank graph (the counterpart of the
    reference's ``analyze_compiled``).

    The per-rank totals of :func:`~repro_torch.roofline.cost.analyze_graph`
    are scaled to global by the chip count so the formulas (X / (chips ·
    peak)) apply.  ``bytes_per_device`` (and ``peak_memory_per_device``,
    the same number, as in the reference) is the argument bytes (the
    rank's local shards) plus the peak bytes of live intermediates from
    :func:`liveness`."""
    c = cost if cost is not None else analyze_graph(gm)
    mem = memory if memory is not None else liveness(gm)
    coll: Dict[str, float] = {k: v * chips for k, v in c.coll.items()}
    coll["count"] = c.coll_count
    per_dev = float(mem["argument"] + mem["temp"])
    return RooflineTerms(
        arch=arch, cell=cell, mesh=mesh_name, chips=chips,
        hlo_flops=c.flops * chips, hlo_bytes=c.bytes * chips,
        coll_bytes=float(c.coll_bytes * chips), coll_breakdown=coll,
        model_flops=model_flops, bytes_per_device=per_dev,
        peak_memory_per_device=per_dev, compute_dtype=compute_dtype)
