"""Gemma-3 1B [hf:google/gemma-3-1b-pt] — dense decoder, 5:1
local(512-window):global layer pattern, MQA (kv=1), qk-norm, dual RoPE
bases (10k local / 1M global), 262k vocab, 128k context."""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    d_ff=6912,
    vocab=262_144,
    period=("attn", "attn", "attn", "attn", "attn", "gattn"),
    attn=AttnConfig(n_heads=4, n_kv_heads=1, d_head=256,
                    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
                    window=512, qk_norm=True),
    mlp_act="gelu",
    citation="hf:google/gemma-3-1b-pt",
    skip_shapes=(),
)
