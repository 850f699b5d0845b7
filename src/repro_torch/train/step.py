"""Train step factories, on one device or on every rank of a mesh, and the
serve step.

The port of ``make_train_step``, ``make_compressed_train_step``,
``make_train_step_with_ingest`` and ``make_serve_step`` of
``repro.train.step``.
``make_train_step_with_ingest`` is the
paper's Fig. 1 pipeline in one step: encoded pages in, preprocessed by the
engine on the card, then the model's gradients and the optimizer update.

``TrainState`` is a plain dict ``{params, opt, step}`` as in the reference.
``params`` is the model (an ``nn.Module``) and ``opt`` the optimizer's
state; a step updates both in place and returns the same objects in a new
dict.  Gradients live in the parameters' ``.grad``: a step drops the
previous step's before its backward, so the first backward's gradient
becomes ``.grad`` with no copy, and further microbatches add into it.

Under a mesh (``rules`` with a ``launch.mesh.Mesh``) each rank holds its
blocks of the parameters (``param_specs``, e.g.
``models.recsys.flat_param_pspecs``) and of the optimizer state, and its
rows of the batch.  The state is laid out as the reference lays it
(``opt_state_pspecs``: a leaf takes the spec of the first parameter of its
shape, whichever parameter it belongs to, so h2o-danube's ``m`` of ``wq``
takes ``wo``'s spec); the step moves each leaf whose spec is not its own
parameter's (``natural_opt_specs``) to that layout for the update and back
(``relayout``), and ``init_state(..., layout=)`` starts it so.  Each rank's
loss is its rows' mean; the gradients are averaged over the batch axes,
replicated leaves and table blocks alike (``average_grads``), before the
clip's global norm (``mesh_sq_sum``) and the update.  The metrics' loss and
accuracy are the means over the batch axes, the global batch's.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.common.util import ShapeDtype
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import entry_axes, reshard, spec_axes
from repro_torch.train.compression import crosspod_compressed_mean, init_error_state
from repro_torch.train.optimizer import Layout, Optimizer, SqSum

TrainState = Dict[str, Any]
Metrics = Dict[str, torch.Tensor]


def apply_updates(params: Dict[str, torch.Tensor], updates: Dict[str, torch.Tensor]) -> None:
    """p += u for every parameter, in place."""
    with torch.no_grad():
        for name, p in params.items():
            p.add_(updates[name].to(p.dtype))


def init_state(model: nn.Module, optimizer: Optimizer, *, with_err: bool = False,
               layout: Optional[Layout] = None) -> TrainState:
    """The state of step 0 around an initialized model (with the zero
    error feedback of the compressed step when `with_err`).  On a mesh
    `layout` places the model's blocks (``optimizer.Layout``), and the
    optimizer state is held as the reference lays it out
    (``opt_state_pspecs``), which the meshed step expects."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    if layout is None:
        opt = optimizer.init(params)
    else:
        ref, nat = opt_layouts(optimizer, layout, params)
        opt = relayout(optimizer.init(params, layout), layout.mesh, nat, ref)
    state = {
        "params": model,
        "opt": opt,
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if with_err:
        state["err"] = init_error_state({k: p.detach() for k, p in params.items()})
    return state


def _records(params: Dict[str, Any]) -> Dict[str, ShapeDtype]:
    """The f32 ``ShapeDtype`` record of each parameter's shape."""
    return {k: ShapeDtype(tuple(p.shape), torch.float32) for k, p in params.items()}


def opt_state_pspecs(optimizer: Optimizer, params: Dict[str, torch.Tensor],
                     param_specs: Dict[str, tuple]) -> Dict[str, Any]:
    """Specs of the optimizer state from the parameters' global shapes, by
    the reference's shape matching: a state leaf takes the spec of the
    first parameter (in the reference's tree order: sorted paths) of its
    shape, whichever parameter it belongs to; a factored leaf (an Adafactor
    row or column mean) the spec of the first parameter of which it is the
    shape with the last axis, or the second-to-last, dropped, that axis's
    entry dropped with it; scalars and unmatched leaves replicate."""
    state = optimizer.init(_records(params))
    by_shape: Dict[tuple, tuple] = {}
    for name in sorted(params, key=lambda k: k.split(".")):
        by_shape.setdefault(tuple(params[name].shape), tuple(param_specs[name]))

    def match(node):
        if isinstance(node, dict):
            return {k: match(v) for k, v in node.items()}
        shape = tuple(node.shape)
        if shape == ():
            return ()
        if shape in by_shape:
            return by_shape[shape]
        for pshape, spec in by_shape.items():
            axes = list(spec) + [None] * (len(pshape) - len(spec))
            if shape == pshape[:-1]:
                return tuple(axes[:-1])
            if shape == pshape[:-2] + pshape[-1:]:
                return tuple(axes[:-2] + axes[-1:])
        return ()

    return match(state)


def natural_opt_specs(optimizer: Optimizer, params: Dict[str, torch.Tensor],
                      param_specs: Dict[str, tuple]) -> Dict[str, Any]:
    """Specs of the optimizer state as the update reads it: each leaf takes
    its own parameter's spec (a row mean ``vr`` without the last axis's
    entry, a column mean ``vc`` without the second-to-last's); scalars
    replicate."""
    state = optimizer.init(_records(params))

    def match(node, key=None, name=None):
        if isinstance(node, dict):
            return {k: match(v, k, k if k in params else name) for k, v in node.items()}
        if not node.shape or name is None:
            return ()
        spec = tuple(param_specs[name]) + (None,) * (len(params[name].shape)
                                                     - len(param_specs[name]))
        if key == "vr":
            return spec[:-1]
        if key == "vc":
            return spec[:-2] + spec[-1:]
        return spec

    return match(state)


def relayout(tree: Dict[str, Any], mesh, src: Dict[str, Any], dst: Dict[str, Any]):
    """`tree`'s blocks moved from the spec tree `src` to `dst`
    (``sharding.reshard`` where a leaf's specs differ; the leaf itself
    where they agree)."""
    if isinstance(tree, dict):
        return {k: relayout(v, mesh, src[k], dst[k]) for k, v in tree.items()}
    return reshard(tree, mesh, src, dst)


def opt_layouts(optimizer: Optimizer, layout: Layout,
                params: Dict[str, torch.Tensor]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the reference's specs of the optimizer state, ``opt_state_pspecs``;
    the update's, ``natural_opt_specs``) for a rank's parameter blocks
    `params` placed by `layout`."""
    whole = {k: ShapeDtype(layout.global_shape(k, p.shape), p.dtype) for k, p in params.items()}
    return (opt_state_pspecs(optimizer, whole, layout.specs),
            natural_opt_specs(optimizer, whole, layout.specs))


def state_shardings(optimizer: Optimizer, params: Dict[str, torch.Tensor],
                    param_specs: Dict[str, tuple], *, with_err: bool = False) -> Dict[str, Any]:
    """Specs of a whole TrainState (the reference's with no mesh: the
    port's ranks hold blocks, not sharded arrays)."""
    specs = {"params": param_specs, "opt": opt_state_pspecs(optimizer, params, param_specs),
             "step": ()}
    if with_err:
        specs["err"] = param_specs
    return specs


def _batch_axes(rules) -> Tuple[str, ...]:
    return entry_axes(rules.mapping.get("batch"))


def average_grads(params: Dict[str, torch.Tensor], param_specs: Dict[str, tuple],
                  mesh, batch_axes: Tuple[str, ...]) -> None:
    """Each rank's gradients -> the mean gradient over `batch_axes`, in
    place.  A leaf sharded over a batch axis (an FSDP weight) was already
    summed over it by its gather's backward; every other leaf is summed
    here."""
    n = math.prod(mesh.shape[a] for a in batch_axes)
    with torch.no_grad():
        for name, p in params.items():
            g = p.grad
            for a in batch_axes:
                if a not in spec_axes(param_specs[name]):
                    g = comm.psum(g, mesh, a)
            p.grad = g.div_(n) if n > 1 else g


def mesh_sq_sum(mesh, param_specs: Dict[str, tuple]) -> SqSum:
    """The global sum of squares from this rank's per-leaf squares: a
    leaf sharded over mesh axes is summed over them, a replicated leaf is
    counted once."""

    def sq_sum(squares: Dict[str, torch.Tensor]) -> torch.Tensor:
        by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
        for name, sq in squares.items():
            axes = spec_axes(param_specs[name])
            by_axes[axes] = by_axes.get(axes, 0) + sq
        total = 0
        for axes, part in by_axes.items():
            for a in axes:
                part = comm.psum(part, mesh, a)
            total = total + part
        return total

    return sq_sum


def _mean_metrics(metrics: Metrics, mesh, axes: Tuple[str, ...]) -> Metrics:
    """The metrics' means over `axes` (the global batch's loss and
    accuracy)."""
    n = math.prod(mesh.shape[a] for a in axes)
    out = dict(metrics)
    for key in ("loss", "accuracy"):
        if key in out:
            v = out[key].detach()
            for a in axes:
                v = comm.psum(v, mesh, a)
            out[key] = v / n
    return out


def _grads_and_update(
    state: TrainState, optimizer: Optimizer, metrics: Metrics, sq_sum: Optional[SqSum] = None,
    layout: Optional[Layout] = None,
) -> Tuple[TrainState, Metrics]:
    params = dict(state["params"].named_parameters())
    grads = {k: p.grad for k, p in params.items()}
    if layout is None:
        opt, om = optimizer.update(grads, state["opt"], params, sq_sum)
    else:  # the update reads each leaf in its parameter's layout
        ref, nat = opt_layouts(optimizer, layout, params)
        work = relayout(state["opt"], layout.mesh, ref, nat)
        opt, om = optimizer.update(grads, work, params, sq_sum, layout=layout)
        opt = relayout(opt, layout.mesh, nat, ref)
    return dict(state, opt=opt, step=state["step"] + 1), {**metrics, **om}


def make_train_step(
    loss_fn: Callable,  # (model, batch) -> (loss, metrics)
    optimizer: Optimizer,
    *,
    microbatches: int = 1,
    rules=None,
    param_specs: Optional[Dict[str, tuple]] = None,
):
    """Returns train_step(state, batch) -> (state, metrics).

    With ``microbatches = k`` the batch splits into k equal slices along its
    row axis; their gradients add up in ``.grad`` and are divided by k, as
    the reference sums then averages.  The metrics are the last slice's
    (the reference's ``m[-1]``), plus the optimizer's ``grad_norm`` and
    ``lr``.  With meshed `rules` (and the parameters' `param_specs`) the
    step runs on this rank's rows and blocks, as the module says."""
    mesh = None if rules is None else rules.mesh
    if mesh is not None and param_specs is None:
        raise ValueError("a meshed train step needs the parameters' specs")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state["params"]
        model.zero_grad(set_to_none=True)
        k = max(1, int(microbatches))
        rows = next(iter(batch.values())).shape[0]
        if rows % k:
            raise ValueError(f"{rows} rows do not split into {k} microbatches")
        slices = [{key: v[i * rows // k:(i + 1) * rows // k] for key, v in batch.items()}
                  for i in range(k)]
        for part in slices:
            loss, metrics = loss_fn(model, part)
            loss.backward()
        if k > 1:
            with torch.no_grad():
                torch._foreach_div_([p.grad for p in model.parameters()], float(k))
        if mesh is None:
            return _grads_and_update(state, optimizer, metrics)
        axes = _batch_axes(rules)
        average_grads(dict(model.named_parameters()), param_specs, mesh, axes)
        return _grads_and_update(state, optimizer, _mean_metrics(metrics, mesh, axes),
                                 mesh_sq_sum(mesh, param_specs), Layout(mesh, param_specs))

    return train_step


def make_compressed_train_step(
    loss_fn: Callable,  # (model, batch) -> (loss, metrics), built with `rules`
    optimizer: Optimizer,
    rules,
    param_specs: Dict[str, tuple],
    axis: str = "pod",
):
    """Train step with int8 + error-feedback compression on the cross-pod
    hop.  Each pod computes its rows' gradients, averaged within the pod
    over `rules`' batch axes (which must not name `axis`, e.g.
    ``ShardingRules.make(mesh, overrides={"batch": ("data",)})``), then the
    pods exchange int8 gradients (``crosspod_compressed_mean``).  Params and
    optimizer state are replicated across pods (`param_specs` name no
    `axis`).  The state carries the error feedback (``init_state(...,
    with_err=True)``).  The metrics are the pod's."""
    mesh = rules.mesh
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no {axis!r} axis")
    axes = _batch_axes(rules)
    if axis in axes or any(axis in spec_axes(sp) for sp in param_specs.values()):
        raise ValueError(f"the step is manual over {axis!r}: rules and specs must not name it")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state["params"]
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        params = dict(model.named_parameters())
        average_grads(params, param_specs, mesh, axes)
        grads, err = crosspod_compressed_mean(
            {k: p.grad for k, p in params.items()}, state["err"], mesh, axis, param_specs)
        for k, p in params.items():
            p.grad = grads[k]
        new, om = _grads_and_update(state, optimizer, _mean_metrics(metrics, mesh, axes),
                                    mesh_sq_sum(mesh, param_specs), Layout(mesh, param_specs))
        return dict(new, err=err), om

    return train_step


def make_train_step_with_ingest(
    engine,  # TorchPreStoEngine
    model_loss_fn: Callable,  # (model, minibatch) -> (loss, metrics)
    optimizer: Optimizer,
):
    """Returns step(state, pages) -> (state, metrics): one partition's
    staged pages (on the engine's device) preprocessed by the engine, then
    one train step on the mini-batch (paper Fig. 1)."""
    if engine.mesh is not None:
        raise ValueError("the ingest step is mesh-less; a meshed engine's batch is one "
                         "rank's rows, and this step averages no gradients")

    def step(state: TrainState, pages: Dict[str, torch.Tensor]):
        minibatch = engine.preprocess_global(pages)
        model = state["params"]
        model.zero_grad(set_to_none=True)
        loss, metrics = model_loss_fn(model, minibatch)
        loss.backward()
        return _grads_and_update(state, optimizer, metrics)

    return step


def make_serve_step(decode_fn: Callable):
    """decode_fn(params, token, caches, cache_len) -> (logits, caches).
    Returns serve_step(...) -> (next token (B, 1) int32, logits, caches):
    greedy, the first of tied maxima as ``jnp.argmax`` takes."""

    def serve_step(params, token, caches, cache_len):
        logits, new_caches = decode_fn(params, token, caches, cache_len)
        next_token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_token[:, None], logits, new_caches

    return serve_step
