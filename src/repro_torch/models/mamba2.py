"""Mamba2 block via SSD — state-space duality (arXiv:2405.21060, Alg. 1),
as ``repro.models.mamba2``.

The sequence is split into chunks of length ``cs``; within a chunk the dual
quadratic ("attention-like") form, across chunks a sequential recurrence
over the [H, P, N] SSM state.  ``ssd_chunked`` goes through
``kernels.ssd_scan.ops.ssd_apply``, one autograd node (``SSDScanFn``): the
hand-written kernels on the card, forward and backward, and the plain
chunked dual form and its plain backward passes (``kernels/ssd_scan/ref.py``)
on the CPU, so mamba2 trains on both.

Decode is the O(1) recurrent step: state <- exp(dt A) state + dt B x.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan.ops import ssd_apply
from repro_torch.models.layers import Params, _normal, dot, rmsnorm, rmsnorm_init


def _dims(d_model: int, cfg: SSMConfig):
    d_inner = cfg.d_inner(d_model)
    n_heads = cfg.n_heads(d_model)
    conv_dim = d_inner + 2 * cfg.d_state
    return d_inner, n_heads, conv_dim


def mamba_init(gen, d_model: int, cfg: SSMConfig, device=None) -> Params:
    """The reference's tree of one projection per role (``in_z``, ``in_x``,
    ``in_b``, ``in_c``, ``in_dt``): numerically the fused ``in_proj``,
    drawn from ``gen`` at the reference's scales and forms."""
    d_inner, n_heads, _ = _dims(d_model, cfg)
    s = d_model ** -0.5

    def zeros(d):
        return torch.zeros((d,), dtype=torch.float32, device=device)

    # dt_bias = softplus^-1(dt) for dt log-uniform on [1e-3, 1e-1]
    u = torch.rand((n_heads,), generator=gen, dtype=torch.float32, device=device)
    log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
    return {
        "in_z": _normal(gen, (d_model, d_inner), s, device),
        "in_x": _normal(gen, (d_model, d_inner), s, device),
        "in_b": _normal(gen, (d_model, cfg.d_state), s, device),
        "in_c": _normal(gen, (d_model, cfg.d_state), s, device),
        "in_dt": _normal(gen, (d_model, n_heads), s, device),
        "conv_x": _normal(gen, (cfg.d_conv, d_inner), 0.2, device),
        "conv_b_": _normal(gen, (cfg.d_conv, cfg.d_state), 0.2, device),
        "conv_c_": _normal(gen, (cfg.d_conv, cfg.d_state), 0.2, device),
        "conv_bias_x": zeros(d_inner),
        "conv_bias_b": zeros(cfg.d_state),
        "conv_bias_c": zeros(cfg.d_state),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=torch.float32,
                                          device=device)),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
        "norm": rmsnorm_init(d_inner, device),
        "out_proj": _normal(gen, (d_inner, d_model), d_inner ** -0.5, device),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: xbc [B,S,Cd], w [K,Cd]."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(out + b)


def ssd_chunked(x, dt, a, b_mat, c_mat, d_skip, chunk: int, init_state=None):
    """SSD dual form.

    x  [B,S,H,P]; dt [B,S,H] (already softplus'd); a [H] (negative);
    b_mat/c_mat [B,S,N]; d_skip [H].
    Returns (y [B,S,H,P], final_state [B,H,P,N]).
    """
    return ssd_apply(x, dt, a, b_mat, c_mat, d_skip, chunk=chunk,
                     init_state=init_state, return_state=True)


def ssd_inputs(params: Params, x: torch.Tensor, cfg: SSMConfig):
    """The gate z [B,S,d_inner] and the SSD scan's operands (x [B,S,H,P],
    dt, a, B, C, D) of a Mamba2 block on x [B,S,d_model]."""
    d_model = x.shape[-1]
    _, n_heads, _ = _dims(d_model, cfg)
    z = dot(x, params["in_z"])
    xs = _causal_conv(dot(x, params["in_x"]), params["conv_x"], params["conv_bias_x"])
    b_mat = _causal_conv(dot(x, params["in_b"]), params["conv_b_"], params["conv_bias_b"])
    c_mat = _causal_conv(dot(x, params["in_c"]), params["conv_c_"], params["conv_bias_c"])
    dt = F.softplus(dot(x, params["in_dt"]) + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    bsz, s = x.shape[:2]
    xs = xs.reshape(bsz, s, n_heads, cfg.head_dim)
    # a and D enter the scan in the activations' dtype, float32 also under
    # cast_bf16 (the residual stream is promoted to float32, as the
    # reference's is): there only their values are bfloat16-rounded
    return z, (xs, dt, a.to(xs.dtype), b_mat, c_mat, params["D"].to(xs.dtype))


def mamba_apply(params: Params, x: torch.Tensor, cfg: SSMConfig,
                init_state=None, return_state: bool = False):
    """Full-sequence Mamba2 block. x [B,S,d_model]."""
    bsz, s, d_model = x.shape
    z, operands = ssd_inputs(params, x, cfg)
    y, state = ssd_chunked(*operands, cfg.chunk, init_state)
    y = y.reshape(bsz, s, cfg.d_inner(d_model))
    y = rmsnorm(params["norm"], y * F.silu(z))
    out = dot(y, params["out_proj"])
    if return_state:
        return out, state
    return out


# ------------------------------------------------------------------ decode

class MambaCache(NamedTuple):
    conv: torch.Tensor    # [B, d_conv-1, d_inner + 2*d_state]
    state: torch.Tensor   # [B, H, P, N]


def mamba_cache_init(batch: int, d_model: int, cfg: SSMConfig,
                     dtype=torch.float32, device=None) -> MambaCache:
    d_inner, n_heads, conv_dim = _dims(d_model, cfg)
    return MambaCache(
        conv=torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, n_heads, cfg.head_dim, cfg.d_state),
                          dtype=dtype, device=device))


def mamba_decode_step(params: Params, x: torch.Tensor, cache: MambaCache,
                      cfg: SSMConfig) -> tuple[torch.Tensor, MambaCache]:
    """x [B,1,d_model] -> (y [B,1,d_model], cache).

    The cache's conv window and state are written in place and the same
    cache is returned (the reference returns a new one): a stacked layer's
    entry is a view into the stacked cache, which ``decode_step`` keeps."""
    d_model = x.shape[-1]
    d_inner, n_heads, conv_dim = _dims(d_model, cfg)
    xt = x[:, 0]
    z = xt @ params["in_z"]
    xbc = torch.cat(
        [xt @ params["in_x"], xt @ params["in_b"], xt @ params["in_c"]], -1)
    conv_w = torch.cat(
        [params["conv_x"], params["conv_b_"], params["conv_c_"]], -1)
    conv_bias = torch.cat(
        [params["conv_bias_x"], params["conv_bias_b"], params["conv_bias_c"]])

    # products written out rather than as einsums: the step is host-bound
    # (a few dozen small operations per layer), and each einsum costs the
    # host several times what its device work does
    window = torch.cat([cache.conv, xbc[:, None].to(cache.conv.dtype)], dim=1)
    conv_out = F.silu((window.to(torch.float32) * conv_w).sum(1) + conv_bias)

    xs = conv_out[:, :d_inner].reshape(-1, n_heads, cfg.head_dim)
    b_t = conv_out[:, d_inner:d_inner + cfg.d_state]
    c_t = conv_out[:, d_inner + cfg.d_state:]
    dt = F.softplus(xt @ params["in_dt"] + params["dt_bias"])   # [B,H]
    da = torch.exp(dt * -torch.exp(params["A_log"]))           # [B,H]

    state = cache.state.to(torch.float32) * da[..., None, None] \
        + (dt[..., None] * xs)[..., None] * b_t[:, None, None, :]
    y = (state @ c_t[:, None, :, None])[..., 0] + params["D"][None, :, None] * xs
    y = y.reshape(-1, d_inner)
    y = rmsnorm(params["norm"], y * F.silu(z))
    out = (y @ params["out_proj"])[:, None]
    cache.conv.copy_(window[:, 1:])
    cache.state.copy_(state)
    return out.to(x.dtype), cache
