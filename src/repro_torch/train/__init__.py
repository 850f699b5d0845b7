"""Training: AdamW and Adafactor with global-norm clipping, the train steps (meshed and
int8-compressed too), the serve step, checkpoints (of sharded state too)
and the elastic restart loop (over meshes too)."""

from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import ElasticTrainer
from repro_torch.train.optimizer import (
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    make_optimizer,
    warmup_cosine,
)
from repro_torch.train.compression import crosspod_compressed_mean, init_error_state, quantize_int8
from repro_torch.train.step import (
    apply_updates,
    init_state,
    make_compressed_train_step,
    make_serve_step,
    make_train_step,
    make_train_step_with_ingest,
    opt_state_pspecs,
    state_shardings,
)

__all__ = [
    "CheckpointManager",
    "ElasticTrainer",
    "Optimizer",
    "adafactor",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "crosspod_compressed_mean",
    "init_error_state",
    "init_state",
    "make_compressed_train_step",
    "make_optimizer",
    "make_serve_step",
    "make_train_step",
    "make_train_step_with_ingest",
    "opt_state_pspecs",
    "quantize_int8",
    "state_shardings",
    "warmup_cosine",
]
