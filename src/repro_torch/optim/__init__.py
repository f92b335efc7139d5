"""Optimizers, as ``repro.optim``."""
