"""Checkpoints of the trainer's state (counterpart of ``repro/checkpoint``)."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
