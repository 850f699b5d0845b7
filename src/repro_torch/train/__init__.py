"""Training: AdamW with global-norm clipping, the train steps, checkpoints
and the elastic restart loop."""

from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import ElasticTrainer
from repro_torch.train.optimizer import (
    Optimizer,
    adamw,
    clip_by_global_norm,
    warmup_cosine,
)
from repro_torch.train.step import (
    apply_updates,
    init_state,
    make_train_step,
    make_train_step_with_ingest,
)

__all__ = [
    "CheckpointManager",
    "ElasticTrainer",
    "Optimizer",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "init_state",
    "make_train_step",
    "make_train_step_with_ingest",
    "warmup_cosine",
]
