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

On a mesh the block is tensor-parallel over ``ff`` (``model``), in the
reference's layout: ``conv_x``, ``norm_w`` and the rows of ``out_proj``
are split over ``ff``, and so are the SSM heads (``ssm_heads``), so a rank
runs the SSD of its d_in / n channels.  ``zx_proj`` is (d, 2 d_in) with
its columns over ``ff`` and z, x split at d_in: the rank's contiguous
block holds other ranks' channels (at n = 2, rank 0 holds all of z and
rank 1 all of x).  The rank keeps that block, as the dry run's shapes and
the global checkpoint files need it, and reaches its own z and x columns
by a gather of whichever is smaller: the weight block (d x 2 d_in / n),
for a block of more tokens than d (training, prefill), or the product
x @ block (tokens x 2 d_in / n), for fewer (decode).  Either gather's
backward sums the cotangent and keeps the rank's block.  The B, C and dt
projections and their conv are whole on every rank; B, C and dt enter the
rank's heads through ``tp_copy``, and so do the whole per-head
``A_log``, ``D`` and ``dt_bias``, so each rank's gradient of them is the
whole one.  The gated RMSNorm over the split d_in
sums its squares over ``ff``; ``out_proj`` is row-parallel.  The ``h``
cache holds the rank's heads, the conv window every channel (the
reference's ``cache_pspecs``), so decode and prefill gather the rank's new
x channels into it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    ParamDef,
    Schema,
    load_weight,
    rmsnorm,
    tp_axes,
    tp_copy,
    tp_gather,
    tp_index,
    tp_size,
    tp_sum,
)


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


def _ff_split(cfg, rules) -> Tuple[int, int, int]:
    """(blocks, this rank's block, channels a block) of d_in over ``ff``."""
    d_in, h, _, _ = ssm_dims(cfg)
    n = tp_size(rules, "ff")
    if h % n:
        raise ValueError(f"{h} SSM heads do not split into {n} blocks")
    return n, tp_index(rules, "ff"), d_in // n


def _zx_own(params, x: torch.Tensor, cfg, rules) -> Tuple[torch.Tensor, torch.Tensor]:
    """z and x of the rank's channels (..., d_in / n each) from `x` (..., d)."""
    d_in = ssm_dims(cfg)[0]
    w = load_weight(params["zx_proj"], rules, None, "ff", dtype=x.dtype)
    n, r, c = _ff_split(cfg, rules)
    if n == 1:
        zx = rules.constrain(x @ w, *(("batch", "seq", "ff") if x.dim() == 3 else ("batch", "ff")))
        return zx[..., :d_in], zx[..., d_in:]
    x = tp_copy(x, rules, "ff")
    own = (slice(r * c, (r + 1) * c), slice(d_in + r * c, d_in + (r + 1) * c))
    if x.numel() // x.shape[-1] > x.shape[-1]:  # more tokens than rows: gather the weight
        w = tp_gather(w, rules, "ff", 1)
        zx = x @ torch.cat([w[:, own[0]], w[:, own[1]]], dim=1)
        return zx[..., :c], zx[..., c:]
    zx = tp_gather(x @ w, rules, "ff", x.dim() - 1)
    return zx[..., own[0]], zx[..., own[1]]


def _gated_norm(y: torch.Tensor, w: torch.Tensor, cfg, rules) -> torch.Tensor:
    """``rmsnorm`` over d_in, of the rank's channels where ``ff`` splits
    them: the squares summed over the split."""
    if not tp_axes(rules, "ff"):
        return rmsnorm(y, w, cfg.norm_eps)
    dt = y.dtype
    yf = y.to(torch.float32)
    sq = tp_copy(tp_sum(torch.sum(yf * yf, dim=-1, keepdim=True), rules, "ff"), rules, "ff")
    yf = yf * torch.rsqrt(sq / ssm_dims(cfg)[0] + cfg.norm_eps)
    return (yf * (1.0 + w.to(torch.float32))).to(dt)


def _own_heads(params, name: str, heads: slice, rules) -> torch.Tensor:
    """The rank's heads of a whole per-head parameter, in f32 (its gradient
    summed over ``ff``: every rank's is the whole one)."""
    return tp_copy(params[name], rules, "ff")[heads].to(torch.float32)


def whole_window(window: torch.Tensor, cfg, rules) -> torch.Tensor:
    """A conv window (..., d_in / n + 2N) of the rank's x channels and the
    B, C channels -> (..., d_in + 2N), every x channel gathered over
    ``ff`` (the cache's layout)."""
    n, _, c = _ff_split(cfg, rules)
    if n == 1:
        return window
    return torch.cat([tp_gather(window[..., :c].contiguous(), rules, "ff", window.dim() - 1),
                      window[..., c:]], dim=-1)


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
    f32, the last ``W - 1`` pre-conv channels (B, W - 1, d_in + 2N)).  On a
    mesh the state holds the rank's heads and the channels the rank's x
    channels (``whole_window`` gathers them)."""
    b, s, d = x.shape
    d_in, h, p, n = ssm_dims(cfg)
    w = cfg.conv_width
    dt_ = x.dtype
    _, r, c = _ff_split(cfg, rules)
    hl = c // p
    heads = slice(r * hl, (r + 1) * hl)

    z, xin = _zx_own(params, x, cfg, rules)
    bcdt = x @ load_weight(params["bcdt_proj"], rules, None, None, dtype=dt_)
    bc_in, dtr = bcdt[..., :2 * n], bcdt[..., 2 * n:]
    start = max(s - (w - 1), 0)
    conv_tail = torch.cat([xin[:, start:], bc_in[:, start:]], dim=-1)
    # zeros before the sequence, as the causal conv pads (the reference
    # slices past the start there and builds a window decode cannot use)
    conv_tail = F.pad(conv_tail, (0, 0, w - 1 - conv_tail.shape[1], 0))

    xin = F.silu(_causal_conv(xin, params["conv_x"].to(dt_)))
    bc = tp_copy(F.silu(_causal_conv(bc_in, params["conv_bc"].to(dt_))), rules, "ff")
    bmat, cmat = bc[..., :n], bc[..., n:]

    dtr = tp_copy(dtr.to(torch.float32), rules, "ff")[..., heads]
    dt_act = F.softplus(dtr + _own_heads(params, "dt_bias", heads, rules))  # (B,S,H)
    a = -torch.exp(_own_heads(params, "A_log", heads, rules))  # (H,)

    xh = xin.reshape(b, s, hl, p)  # compute dtype (bf16 in production)
    y, h_t = _ssd_chunked(xh, bmat, cmat, dt_act, a, cfg.ssm_chunk, h0=initial_state)
    y += _own_heads(params, "D", heads, rules)[None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(b, s, c).to(dt_)
    y = y * F.silu(z)
    y = _gated_norm(y, params["norm_w"], cfg, rules)
    out = y @ load_weight(params["out_proj"], rules, "ff", None, dtype=dt_)
    return rules.constrain(tp_sum(out, rules, "ff"), "batch", "seq", "embed"), h_t, conv_tail


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
    _, r, c = _ff_split(cfg, rules)
    hl = c // p
    heads = slice(r * hl, (r + 1) * hl)

    z, xin = _zx_own(params, xt, cfg, rules)
    bcdt = xt @ load_weight(params["bcdt_proj"], rules, None, None, dtype=dt_)
    bc_in, dtr = bcdt[..., :2 * n], bcdt[..., 2 * n:]

    # conv state: a rolling window of pre-conv activations, every channel
    cur = whole_window(torch.cat([xin, bc_in], dim=-1), cfg, rules)  # (B, d_in + 2N)
    window = torch.cat([state["conv"], cur[:, None, :]], dim=1)  # (B, W, ch)
    own = torch.cat([window[..., r * c:(r + 1) * c], window[..., d_in:]], dim=-1)
    conv_w = torch.cat([params["conv_x"], params["conv_bc"]], dim=1).to(dt_)  # (W, c + 2N)
    convd = F.silu(torch.einsum("bwc,wc->bc", own, conv_w))
    xin_c, bc_c = convd[..., :c], tp_copy(convd[..., c:], rules, "ff")
    bmat_c, cmat_c = bc_c[..., :n], bc_c[..., n:]

    dtr = tp_copy(dtr.to(torch.float32), rules, "ff")[..., heads]
    dt_act = F.softplus(dtr + _own_heads(params, "dt_bias", heads, rules))  # (B,H)
    a = -torch.exp(_own_heads(params, "A_log", heads, rules))
    decay = torch.exp(dt_act * a[None, :])  # (B, H)

    xh = xin_c.reshape(b, hl, p).to(torch.float32)
    dbx = torch.einsum("bh,bn,bhp->bhpn", dt_act, bmat_c.to(torch.float32), xh)
    h_new = state["h"]
    h_new.mul_(decay[:, :, None, None]).add_(dbx)
    y = torch.einsum("bhpn,bn->bhp", h_new, cmat_c.to(torch.float32))
    y = y + _own_heads(params, "D", heads, rules)[None, :, None] * xh
    y = y.reshape(b, c).to(dt_)
    y = y * F.silu(z)
    y = _gated_norm(y, params["norm_w"], cfg, rules)
    out = tp_sum(y @ load_weight(params["out_proj"], rules, "ff", None, dtype=dt_), rules, "ff")
    state["conv"].copy_(window[:, 1:, :])
    return out[:, None, :], state
