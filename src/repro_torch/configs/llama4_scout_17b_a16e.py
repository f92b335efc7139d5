"""Llama-4-Scout 17B-A16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE
(16 experts, top-1, + shared expert every layer) with iRoPE-style
attention: 3 chunked-local RoPE layers then 1 global NoPE layer per
period.  The chunked-local layers bound the KV cache => long_500k runs."""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab=202_048,
    period=("attn", "attn", "attn", "gattn"),
    attn=AttnConfig(n_heads=40, n_kv_heads=8, d_head=128,
                    rope_theta=500_000.0, window=8192, nope_on_global=True),
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                  n_shared=1, d_ff_shared=8192),
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    skip_shapes=(),
)
