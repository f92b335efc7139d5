"""Mamba2-780m [hf:state-spaces/mamba2-780m, arXiv:2405.21060] —
attention-free SSM using the SSD (state-space duality) chunked algorithm.
48L, d_model 1536, expand 2 (d_inner 3072, 48 heads of 64), d_state 128,
chunk 256; O(1) decode state."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    d_ff=0,                          # attention-free, no MLP blocks
    vocab=50_280,
    period=("mamba",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    citation="arXiv:2405.21060",
    skip_shapes=(),
)
