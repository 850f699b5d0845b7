"""AdamW with global-norm clipping, and the warmup-cosine schedule.

The port of the AdamW half of ``repro.train.optimizer`` (Adafactor waits
for the LM side), with the reference's arithmetic, in f32.  Where the
reference returns new state, this optimizer updates the parameters, the
moments and the gradients in place: at RM2 width the tables alone take
16.1 GB, and parameters, gradients and the two moments already fill 60 GiB
of the card's 80 GB, so the update takes no full-size temporary.  The clip
scale is folded into the Adam pass, and every tensor is updated in chunks of
at most ``CHUNK_ELEMS`` elements along its first axis, so the temporaries of
a step are two chunks.

Under a mesh each rank updates its blocks of the parameters; the clip's
global norm sums the squares of sharded leaves over their mesh axes and
counts replicated leaves once (``sq_sum``, built by
``train.step.mesh_sq_sum``), the norm of the global gradient that the
reference takes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

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


def _chunks(t: torch.Tensor):
    """Views of `t` along its first axis, each of at most CHUNK_ELEMS
    elements (a whole tensor when it is small)."""
    if t.numel() <= CHUNK_ELEMS:
        return (t,)
    return t.split(max(1, CHUNK_ELEMS // t[0].numel()), dim=0)


def leaf_squares(grads: Tensors) -> Tensors:
    """Each gradient's sum of squares, an f32 scalar tensor by name: on the
    card one read of each gradient; on the CPU, where norms accumulate in
    order (1e-4 off at 5M elements), torch.sum's pairwise sums, in chunks
    that keep the squares' temporaries small."""
    gs = {k: g.to(torch.float32) for k, g in grads.items()}
    if next(iter(gs.values())).device.type == "cuda":
        norms = torch._foreach_norm(list(gs.values()))
        return {k: torch.square(n) for k, n in zip(gs, norms)}
    return {k: torch.sum(torch.stack([torch.sum(torch.square(c)) for c in _chunks(g)]))
            for k, g in gs.items()}


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
class Optimizer:
    # params (name -> tensor) -> state
    init: Callable[[Tensors], Dict[str, Any]]
    # (grads, state, params[, sq_sum]) -> (state, metrics); params, state
    # and grads are updated in place; under a mesh, sq_sum makes the clip's
    # norm the global one
    update: Callable[..., Tuple[Dict[str, Any], Tensors]]


def adamw(
    lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
    weight_decay: float = 0.0, clip_norm: float = 1.0,
) -> Optimizer:
    def init(params: Tensors) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        device = next(iter(params.values())).device
        return {
            "m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    @torch.no_grad()
    def update(grads: Tensors, state: Dict[str, Any], params: Tensors,
               sq_sum: SqSum | None = None):
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
