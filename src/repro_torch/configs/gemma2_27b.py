"""Gemma-2 27B [arXiv:2408.00118] — dense decoder with alternating
local(4096-window)/global attention, attention- and final-logit softcaps,
GeGLU.  Sliding-window layers make long_500k decode viable."""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    d_ff=36864,
    vocab=256_000,
    period=("attn", "gattn"),        # local, global, local, ...
    attn=AttnConfig(n_heads=32, n_kv_heads=16, d_head=128,
                    rope_theta=10_000.0, window=4096, logit_softcap=50.0),
    final_logit_softcap=30.0,
    mlp_act="gelu",
    citation="arXiv:2408.00118",
    skip_shapes=(),
)
