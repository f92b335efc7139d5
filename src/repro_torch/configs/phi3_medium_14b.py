"""Phi-3-medium 14B [arXiv:2404.14219] — dense decoder, RoPE + SwiGLU +
GQA (40 heads, 10 kv).  Pure full attention => long_500k skipped."""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    d_ff=17920,
    vocab=100_352,
    period=("attn",),
    attn=AttnConfig(n_heads=40, n_kv_heads=10, d_head=128,
                    rope_theta=10_000.0),
    citation="arXiv:2404.14219",
    skip_shapes=("long_500k",),
)
