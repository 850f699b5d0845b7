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

Where 'experts' maps to a mesh axis that also carries the batch (llama4's
rule: experts over ``data``), ``moe_apply`` takes the reference's
all-to-all dispatch (``_moe_apply_a2a``) exactly where the reference does:
each rank routes its own batch rows, sends every expert's buffer to the
rank that holds the expert (``comm.all_to_all``), runs the FFN of its
``e / n`` experts and sends the outputs back.  A rank's ``x`` is its
block of rows, so the global batch is the block times the batch axes'
size and always divides by the experts' axis: the reference's dense
fallback for a batch the axis does not divide has no caller here.  The
aux loss is the mean of the ranks' aux over the axis.

The rest of the reference's layout is tensor parallelism over ``model``.
Under the default rules (``experts -> model``: jamba) each rank holds
``e / n`` experts and the dense dispatch runs them for every one of its
rows; the combine over its experts is a partial sum, summed over
``model``.  Under ``ff -> model`` (grok-1 with ``experts -> None``, and
inside each expert of llama4's all-to-all) each rank holds the ``ff``
block of every expert it runs: the expert MLP is column- then
row-parallel and the combine is summed over ``model``.  Either way the
router and the routing are whole on every rank (drops are counted per
position, as on one device); the tokens and the gates enter the split
part through ``layers.tp_copy``, and one ``psum`` ends the layer.  The
dense dispatch's aux loss takes its experts' fractions over the global
batch (``_batch_mean``: two ``psum``s over the batch's axes a block), the
reference's aux, where the all-to-all dispatch's is the mean of the
ranks' aux.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import comm
from repro_torch.distributed.sharding import spec_index
from repro_torch.models.layers import ParamDef, Schema, live_axes, load_weight

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
    xb: torch.Tensor, router: torch.Tensor, k: int, capacity: int, mean=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xb (G, tb, d) -> (dispatch (G, tb, E, C), gates (G, tb, E), aux scalar), f32.
    `mean` (the identity by default) takes the experts' token and
    probability fractions of these rows to those of the global batch."""
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
    if mean is not None:
        frac_tokens, frac_probs = mean(frac_tokens), mean(frac_probs)
    aux = e * torch.sum(frac_tokens * frac_probs) / max(k, 1)
    return dispatch, gates, aux


def _experts_over_batch(rules) -> bool:
    """Whether 'experts' maps to a mesh axis that also carries the batch."""
    exp_ax = rules.mapping.get("experts")
    batch_axes = rules.mapping.get("batch") or ()
    if not isinstance(batch_axes, tuple):
        batch_axes = (batch_axes,)
    return isinstance(exp_ax, str) and exp_ax in batch_axes


class _AuxMean(torch.autograd.Function):
    """The mean of the ranks' aux over `axis`.  `axis` carries the batch:
    every rank's loss holds the mean, and the meshed train step averages
    the ranks' gradients over the batch axes, so the rank's own aux takes
    the cotangent as it is (the step's division makes it the mean's
    1/n)."""

    @staticmethod
    def forward(ctx, aux, mesh, axis):
        return comm.psum(aux, mesh, axis) / mesh.shape[axis]

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _split_axes(rules) -> Tuple[tuple, tuple]:
    """The live mesh axes that split an expert stack's experts and its
    ``ff`` axis (the spec of the weights as the FFN reads them)."""
    spec = rules.pspec("experts", None, "ff")
    return live_axes(rules, spec[0]), live_axes(rules, spec[2])


def _tp_copy_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    for a in axes:
        x = comm.copy_to(x, mesh, a)
    return x


def _tp_sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    for a in axes:
        x = comm.psum(x, mesh, a)
    return x


def _expert_block(w: torch.Tensor, cfg, mesh, axis: str, n_ff: int = 1) -> torch.Tensor:
    """The rank's experts of one expert stack (E or E / n, d_in, d_out):
    its block along the experts axis (sliced here where `w` is whole).
    Its ``ff`` axis is whole, or the rank's block of ``d_ff / n_ff``."""
    e, n = cfg.n_experts, mesh.shape[axis]
    if w.shape[0] == e and n > 1:
        i = mesh.coords[axis]
        w = w[i * (e // n):(i + 1) * (e // n)]
    dims = sorted(w.shape[1:])
    if w.shape[0] != e // n or dims not in (sorted([cfg.d_model, cfg.d_ff]),
                                           sorted([cfg.d_model, cfg.d_ff // n_ff])):
        raise ValueError(f"an expert stack of {tuple(w.shape)} is not a rank's {e // n} "
                         f"experts of ({cfg.d_model}, {cfg.d_ff} or {cfg.d_ff // n_ff})")
    return w


def _batch_mean(rules):
    """The mean over the batch's mesh axes of a rank's fractions, for the
    dense dispatch's aux over the global batch, as the reference's auto
    sharding computes it (None where the batch is whole).  Its backward
    sums the cotangent over the axes (``comm.copy_to`` after the psum):
    every rank's loss holds the same aux, and the meshed step divides the
    ranks' summed gradients by the axes' size."""
    mesh = rules.mesh
    axes = live_axes(rules, rules.pspec("batch")[0])
    if not axes:
        return None

    def mean(f):
        n = 1
        for a in axes:
            f = comm.copy_to(comm.psum(f, mesh, a), mesh, a)
            n *= mesh.shape[a]
        return f / n

    return mean


def _moe_apply_a2a(params, x: torch.Tensor, cfg, rules, tb: int, nb: int, capacity: int,
                   axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over a batch axis by explicit all-to-alls, on this
    rank's rows `x` (bl, S, d): the port of the reference's shard_map body.
    Routing and the dense token compute stay on the rank; the dispatched
    buffers (bl, E, C, d) go to the experts' ranks, (bl * n, E / n, C, d)
    come back for this rank's experts, and the outputs return by the
    reverse exchange."""
    mesh = rules.mesh
    bl, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    nd = mesh.shape[axis]
    e_local = e // nd
    dt = x.dtype
    router = params["router"].to(torch.float32)
    _, ff_axes = _split_axes(rules)
    n_ff = 1
    for a in ff_axes:
        n_ff *= mesh.shape[a]
    w_gate, w_up, w_down = (_expert_block(params[name], cfg, mesh, axis, n_ff).to(dt)
                            for name in ("w_gate", "w_up", "w_down"))
    outs, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nb):
        xt = x[:, i * tb:(i + 1) * tb, :]
        dispatch, gates, aux_b = _route_block(xt, router, k, capacity)
        disp = dispatch.to(dt)
        del dispatch
        xe = torch.einsum("gtec,gtd->gecd", disp, xt).reshape(bl, nd, e_local, capacity, d)
        xe = comm.all_to_all(xe, mesh, axis, 1, 0).reshape(bl * nd, e_local, capacity, d)
        xe = _tp_copy_over(xe, mesh, ff_axes)
        g = torch.einsum("gecd,edf->gecf", xe, w_gate)
        u = torch.einsum("gecd,edf->gecf", xe, w_up)
        del xe
        h = F.silu(g) * u
        del g, u
        ye = torch.einsum("gecf,efd->gecd", h, w_down)
        del h
        ye = comm.all_to_all(ye.reshape(bl * nd, 1, e_local, capacity, d), mesh, axis, 0, 1)
        gates = _tp_copy_over(gates, mesh, ff_axes)
        outs.append(torch.einsum("gtec,gecd->gtd", disp * gates[..., None].to(dt),
                                 ye.reshape(bl, e, capacity, d)))
        aux = aux + aux_b
    out = _tp_sum_over(outs[0] if nb == 1 else torch.cat(outs, dim=1), mesh, ff_axes)
    if nb > 1:
        aux = aux / nb
    return rules.constrain(out, "batch", "seq", "embed"), _AuxMean.apply(aux, mesh, axis)


def a2a_axis(cfg, rules):
    """The mesh axis over which the experts dispatch by all-to-all ('experts'
    mapped to a mesh axis that also carries the batch and divides the
    experts), or None."""
    mesh, exp_ax = rules.mesh, rules.mapping.get("experts")
    if (_experts_over_batch(rules) and mesh is not None and exp_ax in mesh.axis_names
            and cfg.n_experts % mesh.shape[exp_ax] == 0):
        return exp_ax
    return None


def moe_apply(params, x: torch.Tensor, cfg, rules) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss (f32 scalar)).  On a mesh `x`
    is this rank's block of rows."""
    b, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    tb = block_size(s)
    nb = s // tb
    capacity = capacity_of(tb, cfg)
    dt = x.dtype
    ep_over_batch = _experts_over_batch(rules)
    axis = a2a_axis(cfg, rules)
    # the reference dispatches densely where `axis` does not divide the
    # global batch; here that batch is the block times the batch axes'
    # size, and `axis` is one of those axes, so it always divides
    if axis is not None:
        return _moe_apply_a2a(params, x, cfg, rules, tb, nb, capacity, axis=axis)
    lead = None if ep_over_batch else "batch"
    e_axes, ff_axes = _split_axes(rules)
    split = tuple(dict.fromkeys(e_axes + ff_axes))
    if ep_over_batch and e_axes:
        raise ValueError("experts over a batch axis that does not divide them: the "
                         "reference's dense fallback is not run by the port")
    w_gate = load_weight(params["w_gate"], rules, "experts", None, "ff", dtype=dt)
    w_up = load_weight(params["w_up"], rules, "experts", None, "ff", dtype=dt)
    w_down = load_weight(params["w_down"], rules, "experts", "ff", None, dtype=dt)
    el = w_gate.shape[0]  # the rank's experts: a block of e over `e_axes`
    own = slice(0, e) if not e_axes else slice(
        spec_index(rules.mesh, rules.pspec("experts")[0]) * el,
        (spec_index(rules.mesh, rules.pspec("experts")[0]) + 1) * el)

    outs, auxes = [], []
    mean = _batch_mean(rules)
    for i in range(nb):
        xb = x[:, i * tb:(i + 1) * tb, :]
        dispatch, gates, aux_b = _route_block(xb, params["router"], k, capacity, mean)
        disp = dispatch.to(dt)[:, :, own]
        del dispatch
        xs = _tp_copy_over(xb, rules.mesh, split)
        xe = rules.constrain(torch.einsum("gtec,gtd->gecd", disp, xs),
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
        gates = _tp_copy_over(gates, rules.mesh, split)[:, :, own]
        outs.append(torch.einsum("gtec,gecd->gtd", disp * gates[..., None].to(dt), ye))
        auxes.append(aux_b)
    out = _tp_sum_over(outs[0] if nb == 1 else torch.cat(outs, dim=1), rules.mesh, split)
    aux = auxes[0] if nb == 1 else sum(auxes) / nb
    return rules.constrain(out, "batch", "seq", "embed"), aux
