"""The ``ssm``, ``hybrid_moe`` and ``moe_top1`` cases of
``tests/test_models_consistency.py`` served by the port and by the JAX
package from the same numpy weights, on the CPU: prefill logits, every
cache (``h``, ``conv``, ``k``, ``v``) after prefill and after 4 greedy
decode steps, and each step's logits within rtol=atol=1e-5 in f32, the
greedy tokens equal.  Their capacity factor is 4, so a prefill block drops
no token and routes as decode does."""

import dataclasses

import pytest

from repro_torch.models.config import ModelConfig
from test_models_consistency import CASES
from torch_lm_util import assert_runs_match, run_both

CONSISTENCY = ("ssm", "hybrid_moe", "moe_top1")


@pytest.fixture(scope="module")
def consistency_runs():
    return {case: run_both(CASES[case], ModelConfig(**dataclasses.asdict(CASES[case])),
                           prompt=32)
            for case in CONSISTENCY}


@pytest.mark.parametrize("case", CONSISTENCY)
def test_consistency_case_matches(consistency_runs, case):
    ref, port = consistency_runs[case]
    assert_runs_match(ref, port)
