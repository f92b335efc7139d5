"""Architecture configuration schema for the model zoo, as
``repro.configs.base``.

Every architecture is an ``ArchConfig`` composed of per-layer *block
kinds* arranged in a repeating ``period``: the layer stack is one loop over
stacked period parameters, plus an unrolled prefix and tail.  Block kinds:

  "attn"    — GQA self-attention (RoPE, optional sliding window / softcap)
  "gattn"   — global (full-context) variant in local/global patterns
  "mla"     — DeepSeek multi-head latent attention
  "mamba"   — Mamba2 SSD block
  "shared_attn" — zamba2-style attention whose params are *shared* across
                  all its occurrences

Each non-mamba layer carries an MLP ("dense" SwiGLU/GeGLU or "moe").  The
port runs every decoder-only block; the whisper encoder and the vision
prefix wait for their slices (``models/transformer.py`` says which).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10_000.0
    rope_theta_global: Optional[float] = None   # gemma3: 1e6 on global layers
    window: Optional[int] = None                # sliding-window size (local layers)
    logit_softcap: Optional[float] = None       # gemma2: 50.0
    qk_norm: bool = False                       # gemma3
    nope_on_global: bool = False                # llama4 iRoPE: no RoPE on global layers


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    first_dense: int = 0       # deepseek: first layer uses a dense MLP


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None   # v2-lite: no q compression
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend stub: precomputed embeddings enter the backbone.

    kind="vision": `n_prefix` patch embeddings are projected and prepended
    to the text sequence.  kind="audio": `n_frames` frame embeddings feed
    the encoder (whisper)."""
    kind: str                    # "vision" | "audio"
    n_prefix: int = 0            # vision tokens prepended
    n_frames: int = 0            # audio encoder frames
    d_frontend: int = 1024       # raw embedding dim before projection


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    period: tuple[str, ...]      # block kinds, cycled over layers
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[FrontendConfig] = None
    enc_layers: int = 0          # whisper encoder depth (0 = decoder-only)
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    mlp_act: str = "silu"        # "silu" (SwiGLU) | "gelu" (GeGLU)
    citation: str = ""
    # shapes this arch cannot serve
    skip_shapes: tuple[str, ...] = ()

    # ------------------------------------------------------------- helpers
    def layer_kinds(self) -> list[str]:
        reps = math.ceil(self.n_layers / len(self.period))
        return list((self.period * reps)[: self.n_layers])

    @property
    def d_head(self) -> int:
        return self.attn.d_head if self.attn else 0

    def n_params(self) -> int:
        """Parameter count (embedding + blocks), from the parameter tree's
        shapes."""
        from repro_torch.models.zoo import param_count   # lazy: avoids cycle
        return param_count(self)

    def n_active_params(self) -> int:
        """Parameters a token reads: the routed experts at top_k /
        n_experts, everything else whole."""
        from repro_torch.models.zoo import param_count
        return param_count(self, active_only=True)

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ArchConfig":
        """Smoke-test variant of the same family: <=2 layers, d_model<=512,
        <=4 experts — runs a real forward and decode step on the CPU."""
        attn = self.attn
        if attn is not None:
            n_h = max(2, min(4, attn.n_heads))
            n_kv = max(1, min(attn.n_kv_heads, n_h))
            attn = dataclasses.replace(
                attn, n_heads=n_h, n_kv_heads=n_kv,
                d_head=d_model // n_h,
                window=min(attn.window, 64) if attn.window else None)
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, n_experts=min(4, moe.n_experts),
                top_k=min(2, moe.top_k), d_ff_expert=d_model * 2,
                d_ff_shared=d_model * 2 if moe.n_shared else 0,
                first_dense=min(1, moe.first_dense),
                # capacity_factor 8: no token is dropped, so decode (T = B)
                # and forward route alike; drops have their own tests
                capacity_factor=8.0)
        mla = self.mla
        if mla is not None:
            mla = dataclasses.replace(mla, kv_lora_rank=64, rope_head_dim=16,
                                      nope_head_dim=32, v_head_dim=32)
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, d_state=16, head_dim=32, chunk=32)
        fe = self.frontend
        if fe is not None:
            fe = dataclasses.replace(fe, n_prefix=min(fe.n_prefix, 8),
                                     n_frames=min(fe.n_frames, 16),
                                     d_frontend=64)
        return dataclasses.replace(
            self, name=self.name + "-reduced", n_layers=n_layers,
            d_model=d_model, d_ff=d_model * 4, vocab=vocab, attn=attn,
            moe=moe, mla=mla, ssm=ssm, frontend=fe,
            enc_layers=min(self.enc_layers, 2))


# ------------------------------------------------------------ input shapes

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
