"""Checkpoints of the trainer's state (counterpart of ``repro/checkpoint``)."""
from .checkpointer import Checkpointer, Layout, ShardTree

__all__ = ["Checkpointer", "Layout", "ShardTree"]
