"""AdamW and Adafactor with global-norm clipping, and the warmup-cosine
schedule.

The port of ``repro.train.optimizer``, with the reference's arithmetic, in
f32.  Where the reference returns new state, these optimizers update the
parameters, their state and the gradients in place: at RM2 width the
tables alone take 16.1 GB, and parameters, gradients and the two moments
already fill 60 GiB of the card's 80 GB, so the update takes no full-size
temporary.  The clip scale is folded into the update pass, and every
tensor is updated in chunks of at most ``CHUNK_ELEMS`` elements along its
leading axes, so the temporaries of a step are a few chunks.

Adafactor (factored second moment, no first moment; the default of the
300B+ MoE configs) clips each leaf's update to RMS <= 1 over the whole
leaf, so a leaf larger than a chunk takes three passes: the second-moment
state (its column means summed over row chunks), the update's sum of
squares, then the update itself, recomputed chunk by chunk.  A jamba
expert stack is 1 x 16 x 4096 x 14336: one f32 temporary of it would be
3.76 GB.

Under a mesh each rank updates its blocks of the parameters; the clip's
global norm sums the squares of sharded leaves over their mesh axes and
counts replicated leaves once (``sq_sum``, built by
``train.step.mesh_sq_sum``), the norm of the global gradient that the
reference takes.  AdamW is elementwise and needs nothing more.  Adafactor
takes the leaves' ``Layout`` (the mesh and each leaf's spec): a leaf is
factored by its global shape, its row and column means over a split axis
are sums over the axis's ranks divided by the whole length, and its RMS
clip takes the squares summed over every axis the leaf is split over and
the whole leaf's count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.common.util import ShapeDtype

from repro_torch.distributed import comm
from repro_torch.distributed.sharding import entry_axes

Tensors = Dict[str, torch.Tensor]
SqSum = Callable[[Tensors], torch.Tensor]  # per-leaf squares -> global sum

CHUNK_ELEMS = 1 << 26  # 256 MB of f32: one RM2 table is 64M elements


# -- LR schedules -------------------------------------------------------------


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    """step -> f32 learning rate: linear warmup to `peak`, then a cosine to
    ``floor * peak`` at `total`."""

    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


# -- global-norm clipping ---------------------------------------------------------


def _zeros(shape, dtype: torch.dtype, like):
    """Zeros of `shape` on `like`'s device; where `like` is a ``ShapeDtype``
    record, their record (a state's shapes with no storage: the reference's
    ``eval_shape`` of ``init``)."""
    if isinstance(like, ShapeDtype):
        return ShapeDtype(tuple(shape), dtype)
    return torch.zeros(shape, dtype=dtype, device=like.device)


def _chunks(t: torch.Tensor):
    """Views of `t` along its first axis, each of at most CHUNK_ELEMS
    elements (a whole tensor when it is small)."""
    if t.numel() <= CHUNK_ELEMS:
        return (t,)
    return t.split(max(1, CHUNK_ELEMS // t[0].numel()), dim=0)


def leaf_squares(grads: Tensors) -> Tensors:
    """Each gradient's sum of squares, an f32 scalar tensor by name: for an
    f32 gradient on the card (or on meta, a dry run's stand-in for it), one
    read (``_foreach_norm``); otherwise (on the CPU, where norms accumulate
    in order and are 1e-4 off at 5M elements, or a bf16 gradient, whose f32
    copy would double it) torch.sum's pairwise sums of the f32 squares,
    chunk by chunk."""
    out: Tensors = {}
    f32 = [k for k, g in grads.items()
           if g.device.type in ("cuda", "meta") and g.dtype == torch.float32]
    if f32:
        norms = torch._foreach_norm([grads[k] for k in f32])
        out.update({k: torch.square(n) for k, n in zip(f32, norms)})
    for k, g in grads.items():
        if k not in out:
            out[k] = torch.sum(torch.stack([torch.sum(torch.square(c.to(torch.float32)))
                                            for c in _chunks(g)]))
    return {k: out[k] for k in grads}


def _local_sq_sum(squares: Tensors) -> torch.Tensor:
    return torch.sum(torch.stack(list(squares.values())))


def _global_norm(grads: Tensors, sq_sum: SqSum | None = None) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, as an f32 tensor on the
    gradients' device (no host sync).  `sq_sum` adds up the per-leaf
    squares (``leaf_squares``): by default this rank's, under a mesh into
    the global sum (``train.step.mesh_sq_sum``)."""
    return torch.sqrt((sq_sum or _local_sq_sum)(leaf_squares(grads)))


def _clip_scale(
    grads: Tensors, max_norm: float, sq_sum: SqSum | None = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, global norm) as f32 tensors on the gradients' device, without
    a host sync: scale = min(1, max_norm / max(norm, 1e-9))."""
    gn = _global_norm(grads, sq_sum)
    return torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0), gn


def clip_by_global_norm(
    grads: Tensors, max_norm: float, sq_sum: SqSum | None = None
) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient IN PLACE so the global norm is at most
    `max_norm`; returns the gradients and their norm before clipping."""
    scale, gn = _clip_scale(grads, max_norm, sq_sum)
    torch._foreach_mul_(list(grads.values()), scale)
    return grads, gn


# -- Optimizer interface -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a rank's leaves lie on a mesh: the mesh and each leaf's spec
    (by name).  A leaf's block is its global tensor cut evenly by its
    spec."""

    mesh: Any
    specs: Dict[str, tuple]

    def axes(self, name: str, dim: int) -> Tuple[str, ...]:
        """The mesh axes (of more than one rank) that split axis `dim`
        (counted from 0) of leaf `name`."""
        spec = tuple(self.specs[name])
        entry = spec[dim] if dim < len(spec) else None
        return tuple(a for a in entry_axes(entry) if self.mesh.shape[a] > 1)

    def global_shape(self, name: str, shape) -> Tuple[int, ...]:
        spec = tuple(self.specs[name]) + (None,) * (len(shape) - len(self.specs[name]))
        return tuple(n * math.prod(self.mesh.shape[a] for a in entry_axes(e))
                     for n, e in zip(shape, spec))

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        for a in axes:
            x = comm.psum(x, self.mesh, a)
        return x


@dataclasses.dataclass(frozen=True)
class Optimizer:
    # (params (name -> tensor)[, layout]) -> state; over ``ShapeDtype``
    # records, the state's records
    init: Callable[..., Dict[str, Any]]
    # (grads, state, params[, sq_sum, layout]) -> (state, metrics); params,
    # state and grads are updated in place; under a mesh, sq_sum makes the
    # clip's norm the global one and layout (a ``Layout``) places the leaves
    update: Callable[..., Tuple[Dict[str, Any], Tensors]]


def adamw(
    lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
    weight_decay: float = 0.0, clip_norm: float = 1.0,
) -> Optimizer:
    def init(params: Tensors, layout: Layout | None = None) -> Dict[str, Any]:
        zeros = lambda p: _zeros(p.shape, torch.float32, p)  # noqa: E731
        return {
            "m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "count": _zeros((), torch.int32, next(iter(params.values()))),
        }

    @torch.no_grad()
    def update(grads: Tensors, state: Dict[str, Any], params: Tensors,
               sq_sum: SqSum | None = None, layout: Layout | None = None):
        with torch.profiler.record_function("adamw"):
            scale, gnorm = _clip_scale(grads, clip_norm, sq_sum)
            count = state["count"] + 1
            lr = lr_fn(count).to(scale.device)
            neg_lr = -lr
            c1 = 1 - b1 ** count.to(torch.float32)
            c2 = 1 - b2 ** count.to(torch.float32)
            for name, p in params.items():
                for g, m, v, pc in zip(*(map(_chunks, (grads[name], state["m"][name],
                                                        state["v"][name], p)))):
                    g.mul_(scale)  # the clip, in f32 as the reference's g * scale
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                    step = (m / c1).div_((v / c2).sqrt_().add_(eps))
                    if weight_decay:
                        step.add_(pc, alpha=weight_decay)
                    pc.add_(step.mul_(neg_lr).to(pc.dtype))
            state = dict(state, count=count)
            return state, {"grad_norm": gnorm, "lr": lr}

    return Optimizer(init, update)


def _adafactor_chunks(shape, factored: bool):
    """Index tuples into the (M, R, C) view of a factored leaf (M the
    product of the leading axes) or the (rows, rest) view of another, each
    chunk at most ``CHUNK_ELEMS`` elements: runs of whole matrices (rows)
    where one fits, else runs of a matrix's rows (elements)."""
    if not factored:
        rows = shape[0] if len(shape) else 1
        rest = math.prod(shape[1:]) if len(shape) > 1 else 1
        k = max(1, CHUNK_ELEMS // rest)
        return [(slice(r, min(r + k, rows)),) for r in range(0, rows, k)]
    m, r, c = math.prod(shape[:-2]), shape[-2], shape[-1]
    if r * c <= CHUNK_ELEMS:
        k = max(1, CHUNK_ELEMS // (r * c))
        return [(slice(i, min(i + k, m)), slice(None)) for i in range(0, m, k)]
    k = max(1, CHUNK_ELEMS // c)
    return [(slice(i, i + 1), slice(j, min(j + k, r))) for i in range(m) for j in range(0, r, k)]


def _adafactor_leaf(g, st, p, scale, beta, neg_lr, eps: float, factored: bool,
                    split=None) -> None:
    """One leaf's Adafactor update, in place: the clip into `g`, the
    second-moment state into `st`, the update into `p` (see the module).
    `split` places a rank's block of the leaf: (layout, the leaf's name,
    its global shape); the means and the RMS then sum over the ranks."""
    shape = tuple(p.shape)
    layout, name, whole = split if split is not None else (None, None, shape)
    if factored:
        m, r, c = math.prod(shape[:-2]), shape[-2], shape[-1]
        g3, p3 = g.view(m, r, c), p.view(m, r, c)
        vr, vc = st["vr"].view(m, r), st["vc"].view(m, c)
    else:
        rows = shape[0] if shape else 1
        g3, p3, v = g.view(rows, -1), p.view(rows, -1), st["v"].view(rows, -1)
    chunks = _adafactor_chunks(shape, factored)
    gscale = scale.to(g.dtype)  # the reference clips in the gradient's dtype
    colsum = torch.zeros((m, c), dtype=torch.float32, device=g.device) if factored else None
    row_axes = col_axes = ()
    if layout is not None and factored:
        row_axes, col_axes = layout.axes(name, len(shape) - 1), layout.axes(name, len(shape) - 2)

    # pass 1: the clip and the second-moment state
    for idx in chunks:
        gc = g3[idx].mul_(gscale).to(torch.float32)
        g2 = gc.square().add_(eps)
        if factored:
            if row_axes:  # the row mean over the ranks' columns
                rmean_g2 = layout.psum(g2.sum(dim=-1), row_axes).div_(whole[-1])
            else:
                rmean_g2 = g2.mean(dim=-1)
            vr[idx].mul_(beta).add_(rmean_g2.mul_(1 - beta))
            colsum[idx[0]] += g2.sum(dim=-2)
        else:
            v[idx].mul_(beta).add_(g2.mul_(1 - beta))
    if factored:
        colsum = layout.psum(colsum, col_axes) if col_axes else colsum
        vc.mul_(beta).add_(colsum.div_(whole[-2]).mul_(1 - beta))
        if col_axes:
            rmean = torch.clamp_min(layout.psum(vr.sum(dim=-1), col_axes) / whole[-2], eps)
        else:
            rmean = torch.clamp_min(vr.mean(dim=-1), eps)

    def pre_of(idx):
        gc = g3[idx].to(torch.float32)
        if factored:
            denom = vr[idx][..., None] * vc[idx[0]][:, None, :] / rmean[idx[0]][:, None, None]
            return gc * torch.rsqrt(denom + eps)
        return gc * torch.rsqrt(v[idx] + eps)

    # pass 2: the update's RMS over the whole leaf (one chunk keeps its update)
    sq, kept = 0, None
    for idx in chunks:
        pre = pre_of(idx)
        sq = sq + torch.sum(pre * pre)
        kept = pre if len(chunks) == 1 else None
    if layout is not None:
        every = tuple(a for d in range(len(shape)) for a in layout.axes(name, d))
        sq = layout.psum(torch.as_tensor(sq, dtype=torch.float32, device=p.device), every)
    clip = torch.clamp_min(torch.sqrt(sq / max(math.prod(whole), 1) + 1e-12), 1.0)
    # pass 3: p += (-lr * pre / max(1, rms)) in the parameter's dtype
    for idx in chunks:
        pre = kept if kept is not None else pre_of(idx)
        p3[idx].add_(pre.div_(clip).mul_(neg_lr).to(p.dtype))


def adafactor(
    lr_fn, decay: float = 0.8, eps: float = 1e-30, clip_norm: float = 1.0,
    min_dim_size_to_factor: int = 128,
) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern), beta1=0.  The
    state of a leaf is ``{"vr", "vc"}`` (means over its last and its
    second-to-last axis) where both of its last two axes reach
    `min_dim_size_to_factor`, else ``{"v"}`` of its shape."""

    def factored(shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def whole(name, p, layout):
        return tuple(p.shape) if layout is None else layout.global_shape(name, p.shape)

    def init(params: Tensors, layout: Layout | None = None) -> Dict[str, Any]:
        def st(name, p):
            zeros = lambda shape: _zeros(shape, torch.float32, p)  # noqa: E731
            shape = tuple(p.shape)
            if factored(whole(name, p, layout)):
                return {"vr": zeros(shape[:-1]), "vc": zeros(shape[:-2] + shape[-1:])}
            return {"v": zeros(shape)}

        return {"f": {k: st(k, p) for k, p in params.items()},
                "count": _zeros((), torch.int32, next(iter(params.values())))}

    @torch.no_grad()
    def update(grads: Tensors, state: Dict[str, Any], params: Tensors,
               sq_sum: SqSum | None = None, layout: Layout | None = None):
        with torch.profiler.record_function("adafactor"):
            scale, gnorm = _clip_scale(grads, clip_norm, sq_sum)
            count = state["count"] + 1
            lr = lr_fn(count).to(scale.device)
            beta = 1.0 - count.to(torch.float32) ** -decay
            for name, p in params.items():
                shape = whole(name, p, layout)
                _adafactor_leaf(grads[name], state["f"][name], p, scale, beta, -lr, eps,
                                factored(shape),
                                None if layout is None else (layout, name, shape))
            return dict(state, count=count), {"grad_norm": gnorm, "lr": lr}

    return Optimizer(init, update)


def make_optimizer(name: str, lr_fn, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr_fn, **kw)
    if name == "adafactor":
        return adafactor(lr_fn, **kw)
    raise ValueError(name)
