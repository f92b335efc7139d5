"""demo-100m — a ~116M-parameter dense decoder used by the end-to-end
training driver (``launch.train``): the reference's own demo config,
big enough to exercise the full production path (stacked layers, GQA,
SwiGLU, AdamW, FL cohort weighting)."""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="demo-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    d_ff=3072,
    vocab=16_384,
    period=("attn",),
    attn=AttnConfig(n_heads=12, n_kv_heads=4, d_head=64,
                    rope_theta=10_000.0),
    citation="(framework demo config)",
    skip_shapes=("long_500k",),
)
