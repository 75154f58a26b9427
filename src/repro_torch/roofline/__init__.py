"""``repro_torch.roofline`` — roofline terms on the H100 from the port's
traced programs (:mod:`.cost` walks them, :mod:`.analysis` turns the
counts into terms)."""
from .analysis import H100, HW, RooflineTerms, analyze_traced  # noqa: F401
from .cost import Cost, analyze_graph, analyze_lowered  # noqa: F401
