"""Datasets and client partitions (numpy), as in ``repro.data``."""
