"""Deterministic data pipelines (counterpart of ``repro.data.pipeline``):
the synthetic LM corpus ``TokenStream`` and the GP regression generator
``RegressionStream``, both numpy from a seed (the port imports nothing of
``repro``)."""

from .pipeline import RegressionStream, TokenStream

__all__ = ["RegressionStream", "TokenStream"]
