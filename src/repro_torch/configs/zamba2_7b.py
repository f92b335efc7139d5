"""Zamba2 7B [arXiv:2411.15242] — hybrid: Mamba2 backbone with a *shared*
attention+MLP block applied every 6th layer (weights reused across
occurrences; the per-occurrence LoRA of the real model is simplified
away).  ssm_state=64."""
from repro_torch.configs.base import ArchConfig, AttnConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab=32_000,
    period=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    attn=AttnConfig(n_heads=32, n_kv_heads=32, d_head=112,
                    rope_theta=10_000.0, window=4096),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    citation="arXiv:2411.15242",
    skip_shapes=(),                  # SSM-dominated => long_500k runs
)
