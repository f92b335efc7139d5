"""Datasets, the synthetic LM corpus and client partitions (numpy), as in
``repro.data``."""
