"""The paper's CNN, as ``repro.models.cnn``."""
