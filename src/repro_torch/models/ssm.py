"""Mamba-2 SSD (state-space duality) blocks, chunked: the port of
``repro.models.ssm``.

The SSD algorithm computes the selective-SSM recurrence as chunked
products: within a chunk of Q timesteps everything is dense
((C B^T ⊙ decay) X), and across chunks a short loop carries the (H, P, N)
state.  The mixed precision is the reference's: the quadratic terms compute
in the input's dtype (bf16 at full width), the decay sums, the state and
``y`` in f32.

Where the port differs, and why:

* the (B, nc, H, Q, Q) decay and attention blocks are built with the head
  axis ahead of the chunk's rows, so the product with X is a batched
  matmul with no permuted copy.  Where no gradient is taken (serving) they
  are built in place, one f32 buffer and its cast (jamba at batch 4 and
  8,192 tokens: 4.3 GB a buffer); under autograd, out of place, since the
  ``exp`` saves its output for the backward;
* the decay is ``exp`` of ``rel`` filled with ``-inf`` above the diagonal
  (ROADMAP C14).  The reference takes ``where(causal, exp(rel), 0)``:
  above the diagonal ``rel`` is a positive sum of ``|a| dt``, whose ``exp``
  overflows to ``inf`` past ~88 (the configs' own chunks of 128 and 256
  reach it), and the VJP of that ``where`` is ``0 * inf = NaN`` in every
  gradient below the final norm.  ``exp(-inf) = 0``, so the forward is
  bitwise the reference's form and the gradient stays finite: at chunk 128
  it equals the reference's at chunk 32, where nothing overflows;
* ``mamba_forward`` also returns the last ``W - 1`` pre-conv channels,
  sliced from the projections it computed (the reference's ``prefill``
  computes the same products a second time for them: the same numbers);
  a sequence shorter than ``W - 1`` gets zeros ahead of it, where the
  reference's slice would give a window that decode cannot use;
* ``mamba_decode_step`` writes the new state and conv window into the
  cache tensors it is given and returns them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef, Schema, load_weight, rmsnorm


def ssm_dims(cfg):
    d_in = 2 * cfg.d_model
    p = cfg.ssm_head_dim
    h = d_in // p
    n = cfg.ssm_state
    return d_in, h, p, n


def mamba_schema(cfg) -> Schema:
    d = cfg.d_model
    d_in, h, p, n = ssm_dims(cfg)
    w = cfg.conv_width
    return {
        "zx_proj": ParamDef((d, 2 * d_in), ("fsdp", "ff")),
        "bcdt_proj": ParamDef((d, 2 * n + h), ("fsdp", None)),
        "conv_x": ParamDef((w, d_in), (None, "ff"), scale=0.5),
        "conv_bc": ParamDef((w, 2 * n), (None, None), scale=0.5),
        "A_log": ParamDef((h,), (None,), init="zeros"),
        "D": ParamDef((h,), (None,), init="zeros"),
        "dt_bias": ParamDef((h,), (None,), init="zeros"),
        "norm_w": ParamDef((d_in,), ("ff",), init="zeros"),
        "out_proj": ParamDef((d_in, d), ("ff", "fsdp")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (W, C)."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out


def chunk_size(s: int, chunk: int) -> int:
    """The largest divisor of `s` not above `chunk`."""
    q = min(chunk, s)
    while s % q:
        q -= 1
    return q


def _ssd_chunked(
    xh: torch.Tensor,  # (B, S, H, P)
    bmat: torch.Tensor,  # (B, S, N)
    cmat: torch.Tensor,  # (B, S, N)
    dt: torch.Tensor,  # (B, S, H) (softplus'd, f32)
    a: torch.Tensor,  # (H,) negative decay rates
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B, S, H, P) f32, final state (B, H, P, N) f32)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = chunk_size(s, chunk)
    nc = s // q
    cdt = xh.dtype  # the quadratic terms' dtype; the decay sums stay f32

    xc = xh.reshape(b, nc, q, h, p).to(cdt)
    bc = bmat.reshape(b, nc, q, n).to(cdt)
    cc = cmat.reshape(b, nc, q, n).to(cdt)
    dtc = dt.reshape(b, nc, q, h)

    # log-decay within a chunk: l[t] = sum_{u<=t} a*dt_u  (B, nc, Q, H)
    ldec = torch.cumsum(dtc * a[None, None, None, :], dim=2)
    ltot = ldec[:, :, -1, :]  # (B, nc, H) total chunk decay
    ldec_h = ldec.transpose(2, 3)  # (B, nc, H, Q)

    # intra-chunk (dual form): Y_in[t] = sum_{u<=t} C_t.B_u e^{l_t-l_u} dt_u x_u,
    # built as (B, nc, H, Q_t, Q_u): exp of rel, -inf above the diagonal (C14)
    cb = torch.einsum("bcqn,bcun->bcqu", cc, bc)  # (B, nc, Q, Q)
    rel = ldec_h[..., :, None] - ldec_h[..., None, :]
    above = ~torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    dt_u = dtc.transpose(2, 3)[:, :, :, None, :]
    if torch.is_grad_enabled():
        att = torch.exp(rel.masked_fill(above, float("-inf"))) * cb[:, :, None] * dt_u
    else:  # one f32 buffer, in place
        att = rel.masked_fill_(above, float("-inf")).exp_()
        att.mul_(cb[:, :, None]).mul_(dt_u)
    att_c = att.to(cdt)
    del att, rel, cb
    y_in = torch.matmul(att_c, xc.permute(0, 1, 3, 2, 4))  # (B, nc, H, Q, P)
    del att_c
    y = y_in.transpose(2, 3).to(torch.float32)  # (B, nc, Q, H, P)
    del y_in

    # chunk boundary states: S_c = sum_u B_u (dt_u x_u) e^{ltot - l_u}
    wgt = (torch.exp(ltot[:, :, None, :] - ldec) * dtc).to(cdt)  # (B, nc, Q, H)
    s_c = torch.einsum("bcun,bcuhp->bchpn", bc, wgt[..., None] * xc).to(torch.float32)

    # the recurrence over chunks: the state entering each chunk
    hstate = (h0.to(torch.float32) if h0 is not None
              else torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device))
    decay = torch.exp(ltot)  # (B, nc, H)
    hprevs = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=xh.device)
    for c in range(nc):
        hprevs[:, c] = hstate
        hstate = hstate * decay[:, c, :, None, None] + s_c[:, c]
    del s_c

    # inter-chunk contribution: Y_out[t] = C_t . h_in e^{l_t}
    y_out = torch.einsum("bcqn,bchpn->bcqhp", cc, hprevs.to(cdt))
    y_out = (y_out * torch.exp(ldec).to(cdt)[..., None]).to(torch.float32)
    y += y_out
    return y.reshape(b, s, h, p), hstate


def mamba_forward(
    params,
    x: torch.Tensor,  # (B, S, d)
    cfg,
    rules,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence mamba2 block: (out (B, S, d), final state (B, H, P, N)
    f32, the last ``W - 1`` pre-conv channels (B, W - 1, d_in + 2N))."""
    b, s, d = x.shape
    d_in, h, p, n = ssm_dims(cfg)
    w = cfg.conv_width
    dt_ = x.dtype

    zx = x @ load_weight(params["zx_proj"], rules, None, "ff", dtype=dt_)
    zx = rules.constrain(zx, "batch", "seq", "ff")
    z, xin = zx[..., :d_in], zx[..., d_in:]
    bcdt = x @ load_weight(params["bcdt_proj"], rules, None, None, dtype=dt_)
    bc_in, dtr = bcdt[..., :2 * n], bcdt[..., 2 * n:]
    start = max(s - (w - 1), 0)
    conv_tail = torch.cat([xin[:, start:], bc_in[:, start:]], dim=-1)
    # zeros before the sequence, as the causal conv pads (the reference
    # slices past the start there and builds a window decode cannot use)
    conv_tail = F.pad(conv_tail, (0, 0, w - 1 - conv_tail.shape[1], 0))

    xin = F.silu(_causal_conv(xin, params["conv_x"].to(dt_)))
    bc = F.silu(_causal_conv(bc_in, params["conv_bc"].to(dt_)))
    bmat, cmat = bc[..., :n], bc[..., n:]

    dt_act = F.softplus(dtr.to(torch.float32) + params["dt_bias"].to(torch.float32))  # (B,S,H)
    a = -torch.exp(params["A_log"].to(torch.float32))  # (H,)

    xh = xin.reshape(b, s, h, p)  # compute dtype (bf16 in production)
    y, h_t = _ssd_chunked(xh, bmat, cmat, dt_act, a, cfg.ssm_chunk, h0=initial_state)
    y += params["D"].to(torch.float32)[None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(b, s, d_in).to(dt_)
    y = y * F.silu(z)
    y = rmsnorm(y, params["norm_w"], cfg.norm_eps)
    out = y @ load_weight(params["out_proj"], rules, "ff", None, dtype=dt_)
    return rules.constrain(out, "batch", "seq", "embed"), h_t, conv_tail


def mamba_apply(
    params,
    x: torch.Tensor,  # (B, S, d)
    cfg,
    rules,
    *,
    initial_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Full-sequence mamba2 block (train / prefill): out, and the final
    state with `return_state`."""
    out, h_t, _ = mamba_forward(params, x, cfg, rules, initial_state)
    return (out, h_t) if return_state else out


def mamba_decode_step(
    params,
    x_t: torch.Tensor,  # (B, 1, d)
    cfg,
    rules,
    state: Dict[str, torch.Tensor],  # {"h": (B,H,P,N) f32, "conv": (B, W-1, d_in + 2N)}
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrent update: (out (B, 1, d), `state`) with the new
    state and conv window written into `state`'s tensors."""
    b = x_t.shape[0]
    d_in, h, p, n = ssm_dims(cfg)
    dt_ = x_t.dtype
    xt = x_t[:, 0, :]

    zx = xt @ params["zx_proj"].to(dt_)
    z, xin = zx[..., :d_in], zx[..., d_in:]
    bcdt = xt @ params["bcdt_proj"].to(dt_)
    bc_in, dtr = bcdt[..., :2 * n], bcdt[..., 2 * n:]

    # conv state: a rolling window of pre-conv activations
    cur = torch.cat([xin, bc_in], dim=-1)  # (B, d_in + 2N)
    window = torch.cat([state["conv"], cur[:, None, :]], dim=1)  # (B, W, ch)
    conv_w = torch.cat([params["conv_x"], params["conv_bc"]], dim=1).to(dt_)  # (W, ch)
    convd = F.silu(torch.einsum("bwc,wc->bc", window, conv_w))
    xin_c, bc_c = convd[..., :d_in], convd[..., d_in:]
    bmat_c, cmat_c = bc_c[..., :n], bc_c[..., n:]

    dt_act = F.softplus(dtr.to(torch.float32) + params["dt_bias"].to(torch.float32))  # (B,H)
    a = -torch.exp(params["A_log"].to(torch.float32))
    decay = torch.exp(dt_act * a[None, :])  # (B, H)

    xh = xin_c.reshape(b, h, p).to(torch.float32)
    dbx = torch.einsum("bh,bn,bhp->bhpn", dt_act, bmat_c.to(torch.float32), xh)
    h_new = state["h"]
    h_new.mul_(decay[:, :, None, None]).add_(dbx)
    y = torch.einsum("bhpn,bn->bhp", h_new, cmat_c.to(torch.float32))
    y = y + params["D"].to(torch.float32)[None, :, None] * xh
    y = y.reshape(b, d_in).to(dt_)
    y = y * F.silu(z)
    y = rmsnorm(y, params["norm_w"], cfg.norm_eps)
    out = (y @ params["out_proj"].to(dt_))[:, None, :]
    state["conv"].copy_(window[:, 1:, :])
    return out, state
