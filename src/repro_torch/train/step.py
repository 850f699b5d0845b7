"""Train step factories on one device.

The port of ``make_train_step`` and ``make_train_step_with_ingest`` of
``repro.train.step`` without a mesh.  ``make_train_step_with_ingest`` is the
paper's Fig. 1 pipeline in one step: encoded pages in, preprocessed by the
engine on the card, then the model's gradients and the optimizer update.

``TrainState`` is a plain dict ``{params, opt, step}`` as in the reference.
``params`` is the model (an ``nn.Module``) and ``opt`` the optimizer's
state; a step updates both in place and returns the same objects in a new
dict.  Gradients live in the parameters' ``.grad``: a step drops the
previous step's before its backward, so the first backward's gradient
becomes ``.grad`` with no copy, and further microbatches add into it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from repro_torch.train.optimizer import Optimizer

TrainState = Dict[str, Any]
Metrics = Dict[str, torch.Tensor]


def apply_updates(params: Dict[str, torch.Tensor], updates: Dict[str, torch.Tensor]) -> None:
    """p += u for every parameter, in place."""
    with torch.no_grad():
        for name, p in params.items():
            p.add_(updates[name].to(p.dtype))


def init_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    """The state of step 0 around an initialized model."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    return {
        "params": model,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _grads_and_update(
    state: TrainState, optimizer: Optimizer, metrics: Metrics
) -> Tuple[TrainState, Metrics]:
    params = dict(state["params"].named_parameters())
    grads = {k: p.grad for k, p in params.items()}
    opt, om = optimizer.update(grads, state["opt"], params)
    return dict(state, opt=opt, step=state["step"] + 1), {**metrics, **om}


def make_train_step(
    loss_fn: Callable,  # (model, batch) -> (loss, metrics)
    optimizer: Optimizer,
    *,
    microbatches: int = 1,
):
    """Returns train_step(state, batch) -> (state, metrics).

    With ``microbatches = k`` the batch splits into k equal slices along its
    row axis; their gradients add up in ``.grad`` and are divided by k, as
    the reference sums then averages.  The metrics are the last slice's
    (the reference's ``m[-1]``), plus the optimizer's ``grad_norm`` and
    ``lr``."""

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
        return _grads_and_update(state, optimizer, metrics)

    return train_step


def make_train_step_with_ingest(
    engine,  # TorchPreStoEngine
    model_loss_fn: Callable,  # (model, minibatch) -> (loss, metrics)
    optimizer: Optimizer,
):
    """Returns step(state, pages) -> (state, metrics): one partition's
    staged pages (on the engine's device) preprocessed by the engine, then
    one train step on the mini-batch (paper Fig. 1)."""

    def step(state: TrainState, pages: Dict[str, torch.Tensor]):
        minibatch = engine.preprocess_global(pages)
        model = state["params"]
        model.zero_grad(set_to_none=True)
        loss, metrics = model_loss_fn(model, minibatch)
        loss.backward()
        return _grads_and_update(state, optimizer, metrics)

    return step
