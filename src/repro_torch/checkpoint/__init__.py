"""Atomic, async checkpointing in the reference's on-disk layout
(counterpart of ``repro.checkpoint``)."""

from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
