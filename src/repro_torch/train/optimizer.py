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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]

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


def _global_norm(grads: Tensors) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, as an f32 tensor on the
    gradients' device (no host sync)."""
    gs = [g.to(torch.float32) for g in grads.values()]
    if gs[0].device.type == "cuda":  # one read of each gradient, tree-summed
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
    # on the CPU, norms accumulate in order (1e-4 off at 5M elements) and
    # torch.sum pairwise; chunks keep the squares' temporaries small
    squares = [torch.sum(torch.square(c)) for g in gs for c in _chunks(g)]
    return torch.sqrt(torch.sum(torch.stack(squares)))


def _clip_scale(grads: Tensors, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, global norm) as f32 tensors on the gradients' device, without
    a host sync: scale = min(1, max_norm / max(norm, 1e-9))."""
    gn = _global_norm(grads)
    return torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0), gn


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient IN PLACE so the global norm is at most
    `max_norm`; returns the gradients and their norm before clipping."""
    scale, gn = _clip_scale(grads, max_norm)
    torch._foreach_mul_(list(grads.values()), scale)
    return grads, gn


# -- Optimizer interface -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Optimizer:
    # params (name -> tensor) -> state
    init: Callable[[Tensors], Dict[str, Any]]
    # (grads, state, params) -> (state, metrics); params, state and grads
    # are updated in place
    update: Callable[[Tensors, Dict[str, Any], Tensors], Tuple[Dict[str, Any], Tensors]]


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
    def update(grads: Tensors, state: Dict[str, Any], params: Tensors):
        with torch.profiler.record_function("adamw"):
            scale, gnorm = _clip_scale(grads, clip_norm)
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
