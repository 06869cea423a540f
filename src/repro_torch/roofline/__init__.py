"""Roofline model of the card: its constants and the three-term arithmetic
(the JAX package's HLO analysis has no counterpart here; see analysis.py)."""
from repro_torch.roofline.analysis import Roofline, roofline_terms
from repro_torch.roofline.hw import H100_SXM, HwSpec

__all__ = ["H100_SXM", "HwSpec", "Roofline", "roofline_terms"]
