"""Synthetic regression data (counterpart of ``repro.data.pipeline``'s
``RegressionStream``, its numpy generator copied: the port imports nothing
of ``repro``)."""

from .pipeline import RegressionStream

__all__ = ["RegressionStream"]
