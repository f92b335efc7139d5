"""Plain PyTorch versions of the ssd_scan kernel.

``ssd_scan_ref`` is the sequential SSM recurrence, as
``repro.kernels.ssd_scan.ref``: the definitionally correct O(S) form,
independent of the chunked algorithm, in the reference kernel's folded
[BH, S, ·] layout.  ``ssd_chunked_ref`` is the chunked dual form of
``repro.models.mamba2.ssd_chunked`` in the model's [B, S, H, ·] layout:
what the CPU path runs and what the kernel is held against on the card
(at S = 32,768 the sequential form costs 32,768 host steps).
``ssd_passes_ref`` writes out the kernel's own decomposition, the four
passes of ``csrc/ssd_scan.cu``, for the tests; nothing on the main path
calls it.
"""
from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, a, b_mat, c_mat, d_skip) -> torch.Tensor:
    """x [BH,S,P]; dt [BH,S]; a [BH]; b/c [BH,S,N]; d_skip [BH] -> [BH,S,P].

    state_t = exp(dt_t a) state_{t-1} + dt_t x_t B_t^T;  y = C_t state + D x.
    """
    x32, dt32, b32, c32 = (t.to(torch.float32) for t in (x, dt, b_mat, c_mat))
    a32, d32 = a.to(torch.float32), d_skip.to(torch.float32)
    bh, s, p = x.shape
    state = torch.zeros((bh, p, b_mat.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        xt, dtt = x32[:, t], dt32[:, t]
        state = (torch.exp(dtt * a32)[:, None, None] * state
                 + (dtt[:, None] * xt)[:, :, None] * b32[:, t, None, :])
        ys.append(torch.einsum("bpn,bn->bp", state, c32[:, t])
                  + d32[:, None] * xt)
    return torch.stack(ys, dim=1).to(x.dtype)


def _pairwise_diff(xc: torch.Tensor) -> torch.Tensor:
    """xc [..., cs] -> [..., cs, cs]: T[i,j] = xc_i - xc_j, -inf above diag."""
    cs = xc.shape[-1]
    diff = xc[..., :, None] - xc[..., None, :]
    mask = torch.tril(torch.ones((cs, cs), dtype=torch.bool, device=xc.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked_ref(x, dt, a, b_mat, c_mat, d_skip, chunk: int,
                    init_state=None):
    """SSD dual form.

    x  [B,S,H,P]; dt [B,S,H] (already softplus'd); a [H] (negative);
    b_mat/c_mat [B,S,N]; d_skip [H]; init_state [B,H,P,N] or None.
    Returns (y [B,S,H,P], final_state [B,H,P,N]).
    """
    return ssd_chunked_saved(x, dt, a, b_mat, c_mat, d_skip, chunk,
                             init_state)[:2]


def ssd_chunked_saved(x, dt, a, b_mat, c_mat, d_skip, chunk: int,
                      init_state=None):
    """``ssd_chunked_ref``'s (y, final_state), then what the backward
    reads, in the kernel's scratch layouts: the decays' cumsum [B,nc,H,cs],
    the states entering each chunk [B,nc,H,P,N] and C.B^T [B,nc,cs,cs]."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    nc, cs = s // chunk, chunk

    xb = x.reshape(bsz, nc, cs, h, p)
    dtb = dt.reshape(bsz, nc, cs, h)
    bb = b_mat.reshape(bsz, nc, cs, n)
    cb = c_mat.reshape(bsz, nc, cs, n)

    da = dtb * a                                   # [B,nc,cs,H]
    da_cum = torch.cumsum(da, dim=2)               # inclusive
    da_total = da_cum[:, :, -1]                    # [B,nc,H]

    # ---- intra-chunk (quadratic dual form) -------------------------------
    # L = exp(segsum(da)) from the decays' own cumsum (a scan in order along
    # a non-innermost dim, as the kernel's), not a second one: cum[l] -
    # cum[s] cancels digits when |cum| is large, the same ones in both
    l_mat = torch.exp(_pairwise_diff(da_cum.transpose(2, 3)))  # [B,nc,H,cs,cs]
    scores = torch.einsum("bcln,bcsn->bcls", cb, bb)  # [B,nc,cs,cs]
    m = scores[:, :, None] * l_mat                   # [B,nc,H,l,s]
    m = m * dtb.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.einsum("bchls,bcshp->bclhp", m, xb)
    del l_mat, m

    # ---- chunk states -----------------------------------------------------
    decay_states = torch.exp(da_total[:, :, None] - da_cum)   # [B,nc,cs,H]
    states = torch.einsum("bcsn,bcshp->bchpn", bb,
                          (decay_states * dtb)[..., None] * xb)  # [B,nc,H,P,N]

    # ---- inter-chunk recurrence (sequential over chunks) ------------------
    carry = (torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
             if init_state is None else init_state)
    entering = []
    for c in range(nc):
        entering.append(carry)                     # state *entering* chunk c
        carry = carry * torch.exp(da_total[:, c])[:, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)        # [B,nc,H,P,N]

    decay_out = torch.exp(da_cum)                  # [B,nc,cs,H]
    y_inter = torch.einsum("bcln,bchpn->bclhp", cb, entering) \
        * decay_out[..., None]
    y = y_intra + y_inter + d_skip[None, None, :, None] * xb
    return (y.reshape(bsz, s, h, p), carry, da_cum.transpose(2, 3), entering,
            scores)


def ssd_passes_ref(x, dt, a, b_mat, c_mat, d_skip, chunk: int,
                   init_state=None):
    """The chunk-parallel passes of the CUDA kernel, in the shapes of its
    scratch; the arguments and results of ``ssd_chunked_ref``.

    1. the decays' inclusive cumsum along each chunk, and C.B^T once per
       (batch row, chunk), shared by the heads;
    2. the chunk states S_c = sum_s x[s] (w[s] B[s])^T, w[s] = exp(total -
       cum[s]) dt[s];
    3. the state passing, in order over the chunks: the state entering
       chunk c takes S_c's place, and the last carry is the final state;
    4. the outputs: exp(cum[l]) (C[l] . S_in) + D x[l], then the intra term,
       pass 1's scores masked (the exponent selected to 0 above the
       diagonal, never a product with the mask), decayed and weighted by
       dt, times x.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    nc, cs = s // chunk, chunk
    xb = x.reshape(bsz, nc, cs, h, p)
    dtb = dt.reshape(bsz, nc, cs, h)
    bb = b_mat.reshape(bsz, nc, cs, n)
    cb = c_mat.reshape(bsz, nc, cs, n)

    # pass 1
    cum = torch.cumsum(dtb * a, dim=2)                     # [B,nc,cs,H]
    scores = torch.einsum("bcln,bcsn->bcls", cb, bb)       # [B,nc,cs,cs]
    # pass 2
    total = cum[:, :, -1]                                  # [B,nc,H]
    w = torch.exp(total[:, :, None] - cum) * dtb           # [B,nc,cs,H]
    states = torch.einsum("bcshp,bcsn->bchpn", w[..., None] * xb, bb)
    # pass 3
    carry = (torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
             if init_state is None else init_state)
    for c in range(nc):
        s_c = states[:, c].clone()
        states[:, c] = carry
        carry = carry * torch.exp(total[:, c])[:, :, None, None] + s_c
    # pass 4
    cum_h = cum.transpose(2, 3)                            # [B,nc,H,cs]
    causal = torch.tril(torch.ones((cs, cs), dtype=torch.bool, device=x.device))
    expo = torch.where(causal, cum_h[..., :, None] - cum_h[..., None, :], 0.0)
    m = torch.where(causal, scores[:, :, None] * torch.exp(expo)
                    * dtb.transpose(2, 3)[:, :, :, None, :], 0.0)
    y = (torch.einsum("bcln,bchpn->bclhp", cb, states) * torch.exp(cum)[..., None]
         + d_skip[None, None, :, None] * xb)
    y = y + torch.einsum("bchls,bcshp->bclhp", m, xb)
    return y.reshape(bsz, s, h, p), carry


def ssd_bwd_passes_ref(dy, d_final, x, dt, a, b_mat, c_mat, d_skip,
                       chunk: int, cum, states, scores):
    """The backward of ``ssd_chunked_ref``, as the passes of
    ``csrc/ssd_scan_bwd.cu``: what the wrapper runs for CPU tensors and
    what the kernel is held against on the card.

    dy [B,S,H,P] and d_final [B,H,P,N] (or None: zeros) are the
    cotangents of y and the final state; cum [B,nc,H,cs], states (the
    states entering each chunk) [B,nc,H,P,N] and scores (C.B^T)
    [B,nc,cs,cs] are the forward's scratch.  Returns (dx, ddt, da, dB,
    dC, dD, d_init_state).  Per (batch row, chunk, head), with e = exp(cum),
    w = exp(total - cum) dt, L = exp(cum[l] - cum[s]) on s <= l and M =
    (C.B^T) L dt:

    1. dS_inter = sum_l e[l] dy[l] C[l]^T, the gradient of the state
       entering the chunk through its own outputs;
    2. in reverse over the chunks, the transpose of the forward's state
       passing: the gradient of each chunk's state S_c takes dS_inter's
       place, g = exp(total) g + dS_inter, and the last g is d_init_state;
    3. per head: dx = w (B dS^T) + D dy + M^T dy; dM = dy x^T on the
       causal triangle, whose products with G L and M give dt's intra term
       and the decays' (row and column sums); the inter term's decays
       e[l] (dy . C S_in^T), the state term's dw = x . (B dS^T), the
       carry's exp(total) (dS . S_in); the decays' gradient summed in
       reverse along the chunk gives dt's and a's terms;
    4. summed over the heads: dG = sum_h dM L dt, then dC = sum_h (e dy)
       S_in + dG B and dB = sum_h (w x) dS + dG^T C;
    5. a's and D's gradients summed over batch rows and chunks.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc, cs = s // chunk, chunk
    xh = x.reshape(bsz, nc, cs, h, p).transpose(2, 3)       # [B,nc,H,cs,P]
    dyh = dy.reshape(bsz, nc, cs, h, p).transpose(2, 3)
    dth = dt.reshape(bsz, nc, cs, h).transpose(2, 3)         # [B,nc,H,cs]
    bb = b_mat.reshape(bsz, nc, cs, n)
    cb = c_mat.reshape(bsz, nc, cs, n)
    e = torch.exp(cum)
    total = cum[..., -1]                                     # [B,nc,H]
    # pass 1
    ds_inter = torch.einsum("bchlp,bcln->bchpn", e[..., None] * dyh, cb)
    # pass 2
    g = torch.zeros_like(ds_inter[:, 0]) if d_final is None else d_final
    ds = torch.empty_like(ds_inter)
    for c in reversed(range(nc)):
        ds[:, c] = g
        g = g * torch.exp(total[:, c])[..., None, None] + ds_inter[:, c]
    # pass 3
    causal = torch.tril(torch.ones((cs, cs), dtype=torch.bool, device=x.device))
    decay = torch.exp(total[..., None] - cum)
    w = decay * dth
    y1 = torch.einsum("bcln,bchpn->bchlp", cb, states)
    dcum = e * (dyh * y1).sum(-1)
    u = torch.einsum("bcsn,bchpn->bchsp", bb, ds)
    dw = (xh * u).sum(-1)
    dx = w[..., None] * u + d_skip[:, None, None] * dyh
    expo = torch.where(causal, cum[..., :, None] - cum[..., None, :], 0.0)
    gl = torch.where(causal, scores[:, :, None] * torch.exp(expo), 0.0)
    m = gl * dth[..., None, :]
    dx = dx + torch.einsum("bchls,bchlp->bchsp", m, dyh)
    dm = torch.where(causal, torch.einsum("bchlp,bchsp->bchls", dyh, xh), 0.0)
    # the diagonal's decay exp(cum[l] - cum[l]) and the last step's weight
    # exp(total - cum[cs-1]) hold no decay: their terms, which cancel
    # exactly, are left out of the decays' gradient rather than summed
    # and subtracted (which leaves their rounding, large where dt is)
    below = torch.tril(causal, -1)
    diag_t = torch.diagonal(dm * gl, dim1=-2, dim2=-1)
    col_t = torch.where(below, dm * gl, 0.0).sum(-2)
    r = (dw * w)[..., :-1]
    dtotal = r.sum(-1) + torch.exp(total) * (ds * states).sum((-1, -2))
    dcum = dcum + torch.where(below, dm * m, 0.0).sum(-1) - dth * col_t
    dcum[..., :-1] -= r
    dcum[..., -1] += dtotal
    dda = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = (col_t + diag_t) + dw * decay + dda * a[:, None]
    da_part = (dda * dth).sum(-1)                            # [B,nc,H]
    dd_part = (dyh * xh).sum((-1, -2))
    # pass 4
    dg = (dm * torch.where(causal, torch.exp(expo) * dth[..., None, :], 0.0)
          ).sum(2)                                           # [B,nc,cs,cs]
    dc = (torch.einsum("bchlp,bchpn->bcln", e[..., None] * dyh, states)
          + torch.einsum("bcls,bcsn->bcln", dg, bb))
    db = (torch.einsum("bchsp,bchpn->bcsn", w[..., None] * xh, ds)
          + torch.einsum("bcls,bcln->bcsn", dg, cb))
    # pass 5
    return (dx.transpose(2, 3).reshape(bsz, s, h, p),
            ddt.transpose(2, 3).reshape(bsz, s, h), da_part.sum((0, 1)),
            db.reshape(bsz, s, n), dc.reshape(bsz, s, n), dd_part.sum((0, 1)),
            g)
