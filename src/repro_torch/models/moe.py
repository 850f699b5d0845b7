"""Mixture-of-Experts FFN with GShard-style grouped capacity routing: the
port of ``repro.models.moe``.

Groups are batch rows; within a group, tokens are routed in sequence blocks
of ``MOE_BLOCK_SEQ`` with a per-block expert capacity C = tb*k/E*cf:

    dispatch  (G, tb, E, C) x (G, tb, d)  -> (G, E, C, d)
    experts   (G, E, C, d)  x (E, d, f)   -> (G, E, C, f)
    combine   (G, tb, E, C) x (G, E, C, d)-> (G, tb, d)

Capacity drops are per (group, block), standard GShard dropping; decode
blocks (tb = 1) never drop.  Where the reference scans over blocks, the
port loops.  Every expert's weights are read for every block, as the
reference's dense dispatch reads them.

The all-to-all dispatch of experts sharded over a batch mesh axis
(``_moe_apply_a2a``) is not ported (ROADMAP A5): ``moe_apply`` raises
where the reference would take it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef, Schema, load_weight

# Tokens routed per block, per group (the reference's constant).
MOE_BLOCK_SEQ = 4096


def moe_schema(cfg) -> Schema:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamDef((d, e), (None, None)),
        "w_gate": ParamDef((e, d, f), ("experts", "fsdp", "ff")),
        "w_up": ParamDef((e, d, f), ("experts", "fsdp", "ff")),
        "w_down": ParamDef((e, f, d), ("experts", "ff", "fsdp")),
    }


def block_size(s: int) -> int:
    """The largest divisor of `s` not above ``MOE_BLOCK_SEQ``."""
    tb = min(MOE_BLOCK_SEQ, s)
    while s % tb:
        tb -= 1
    return tb


def capacity_of(tb: int, cfg) -> int:
    """Expert capacity of a block of `tb` tokens."""
    k, e = cfg.top_k, cfg.n_experts
    return min(tb * k, max(int(tb * k / e * cfg.capacity_factor), 1))


def _route_block(
    xb: torch.Tensor, router: torch.Tensor, k: int, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xb (G, tb, d) -> (dispatch (G, tb, E, C), gates (G, tb, E), aux scalar), f32."""
    e = router.shape[1]
    logits = xb.to(torch.float32) @ router.to(torch.float32)  # (G, tb, E)
    probs = torch.softmax(logits, dim=-1)
    _, idx = torch.topk(probs, k, dim=-1)  # (G, tb, k)
    sel = F.one_hot(idx, e).to(torch.float32).sum(dim=2)  # (G, tb, E)
    gates = sel * probs
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # capacity position within (group, block): a cumsum over the token axis
    pos = torch.cumsum(sel, dim=1) - sel
    keep = sel * (pos < capacity)
    # jax's one_hot gives a zero row at pos >= capacity, torch's raises:
    # clamp, and `keep` is zero at every clamped entry
    dispatch = F.one_hot(pos.to(torch.int64).clamp_max(capacity - 1), capacity)
    dispatch = dispatch.to(torch.float32) * keep[..., None]  # (G, tb, E, C)
    frac_tokens = sel.mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs) / max(k, 1)
    return dispatch, gates, aux


def _experts_over_batch(rules) -> bool:
    """Whether 'experts' maps to a mesh axis that also carries the batch."""
    exp_ax = rules.mapping.get("experts")
    batch_axes = rules.mapping.get("batch") or ()
    if not isinstance(batch_axes, tuple):
        batch_axes = (batch_axes,)
    return isinstance(exp_ax, str) and exp_ax in batch_axes


def moe_apply(params, x: torch.Tensor, cfg, rules) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss (f32 scalar))."""
    b, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    tb = block_size(s)
    nb = s // tb
    capacity = capacity_of(tb, cfg)
    dt = x.dtype
    ep_over_batch = _experts_over_batch(rules)
    mesh, exp_ax = rules.mesh, rules.mapping.get("experts")
    if (ep_over_batch and mesh is not None and exp_ax in mesh.axis_names
            and e % mesh.shape[exp_ax] == 0 and b % mesh.shape[exp_ax] == 0):
        raise NotImplementedError("the all-to-all expert dispatch (_moe_apply_a2a) is not "
                                  "ported yet (ROADMAP A5)")
    lead = None if ep_over_batch else "batch"
    w_gate = load_weight(params["w_gate"], rules, "experts", None, "ff", dtype=dt)
    w_up = load_weight(params["w_up"], rules, "experts", None, "ff", dtype=dt)
    w_down = load_weight(params["w_down"], rules, "experts", "ff", None, dtype=dt)

    outs, auxes = [], []
    for i in range(nb):
        xb = x[:, i * tb:(i + 1) * tb, :]
        dispatch, gates, aux_b = _route_block(xb, params["router"], k, capacity)
        disp = dispatch.to(dt)
        del dispatch
        xe = rules.constrain(torch.einsum("gtec,gtd->gecd", disp, xb),
                             lead, "experts", None, None)  # (B, E, C, d)
        g = rules.constrain(torch.einsum("gecd,edf->gecf", xe, w_gate),
                            lead, "experts", None, "ff")
        u = torch.einsum("gecd,edf->gecf", xe, w_up)
        del xe
        h = F.silu(g) * u
        del g, u
        ye = rules.constrain(torch.einsum("gecf,efd->gecd", h, w_down),
                             lead, "experts", None, None)
        del h
        outs.append(torch.einsum("gtec,gecd->gtd", disp * gates[..., None].to(dt), ye))
        auxes.append(aux_b)
    if nb == 1:
        return rules.constrain(outs[0], "batch", "seq", "embed"), auxes[0]
    return rules.constrain(torch.cat(outs, dim=1), "batch", "seq", "embed"), sum(auxes) / nb
