"""DeepSeek-V2-Lite 16B [arXiv:2405.04434] — MoE with multi-head latent
attention (MLA).  27L, d_model 2048, 16 heads, MLA kv_lora=512, MoE:
64 routed experts top-6 + 2 shared, expert d_ff 1408; first layer dense
(d_ff 10944 per the model card); vocab 102400."""
from repro_torch.configs.base import ArchConfig, AttnConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    d_ff=10944,                      # dense MLP of layer 0
    vocab=102_400,
    period=("mla",),
    attn=AttnConfig(n_heads=16, n_kv_heads=16, d_head=128,
                    rope_theta=10_000.0),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared=2, d_ff_shared=2816, first_dense=1),
    citation="arXiv:2405.04434",
    # MLA's latent cache is 576 B-elements/token: 500k-token decode is
    # shardable (DESIGN.md §4) => long_500k runs.
    skip_shapes=(),
)
