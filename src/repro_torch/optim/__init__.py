"""Optimizers and LR schedules of the port."""
