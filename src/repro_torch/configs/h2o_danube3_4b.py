"""H2O-Danube3 4B [arXiv:2401.16818] — llama/mistral-style dense decoder
with sliding-window attention (all layers, window 4096), GQA kv=8."""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    d_ff=10240,
    vocab=32_000,
    period=("attn",),
    attn=AttnConfig(n_heads=32, n_kv_heads=8, d_head=120,
                    rope_theta=10_000.0, window=4096),
    citation="arXiv:2401.16818",
    skip_shapes=(),                  # SWA everywhere => long_500k decodes
)
