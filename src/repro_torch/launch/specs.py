"""The optimizer and the model module of an arch, as the LM driver builds
them: the part of ``repro.launch.specs`` that has a meaning without XLA.

The rest of the reference's ``specs`` (``LoweringSpec``, ``input_specs``,
``lowering_spec`` and the sharded ``ShapeDtypeStruct`` trees the dry run and
the roofline lower) is XLA tooling and waits for ROADMAP A6.
"""

from __future__ import annotations

from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt_lib


def make_optimizer_for(cfg: ModelConfig):
    """``cfg.optimizer`` (adamw or adafactor) over the reference's schedule:
    warmup-cosine to 3e-4, 100 warmup steps, 10,000 in all."""
    lr = opt_lib.warmup_cosine(3e-4, 100, 10_000)
    return opt_lib.make_optimizer(cfg.optimizer, lr)


def _model_module(cfg: ModelConfig):
    return encdec if cfg.is_encdec else tfm
