"""``train.step.opt_state_pspecs`` against the reference's: the specs of
the optimizer state that a global-format save and the meshed step read.
The reference matches a state leaf to a parameter by its shape alone; the
port did so only by name, and gave every factored Adafactor leaf the
replicated spec, where the reference drops the factored axis's entry from
the matching parameter's spec (ROADMAP C)."""

import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.distributed import sharding as S



def _axes(spec) -> tuple:
    return tuple(S.entry_axes(e) for e in spec)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "grok-1-314b"])
def test_opt_state_pspecs_equal_the_references(arch, multi, optimizer):
    """The reduced config under its full config's rule: every state leaf's
    spec is the reference's, by its shape matching, quirks and all (an
    Adafactor row or column mean takes the first parameter of the matching
    shape, an AdamW moment the first parameter of its shape, whichever
    parameter it belongs to)."""
    import dataclasses
    import types

    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import registry as JR
    from repro.distributed.sharding import ShardingRules as JRules
    from repro.models import transformer as JT
    from repro.train import optimizer as JO
    from repro.train.step import opt_state_pspecs as j_opt_state_pspecs
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train.step import opt_state_pspecs

    shape = {"pod": 2, "data": 16, "model": 16} if multi else {"data": 16, "model": 16}
    mesh = types.SimpleNamespace(shape=shape, axis_names=tuple(shape))
    full = JR.get_arch(arch).config
    jcfg = dataclasses.replace(JR.get_arch(arch).reduced,
                               sharding_overrides=full.sharding_overrides)
    cfg = dataclasses.replace(get_arch(arch).reduced, sharding_overrides=full.sharding_overrides)
    jrules = JRules.make(mesh, dict(jcfg.sharding_overrides))
    rules = S.ShardingRules.make(mesh, dict(cfg.sharding_overrides))
    lr = lambda step: 1e-3  # noqa: E731
    jstruct = jax.eval_shape(lambda r: JT.init_params(r, jcfg), jax.random.PRNGKey(0))
    want = j_opt_state_pspecs(JO.make_optimizer(optimizer, lr), jstruct,
                              JT.param_pspecs(jcfg, jrules))
    want = {".".join(str(k.key) for k in path): _axes(v) for path, v in
            jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(x, P))[0]}
    specs = T.flat_rank_param_pspecs(cfg, rules)
    meta = {k: torch.empty(v.shape, device="meta") for k, v in _flat_shapes(jstruct).items()}
    got = opt_state_pspecs(O.make_optimizer(optimizer, lr), meta, specs)
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            name = f"{path}.{k}" if path else k
            walk(v, name) if isinstance(v, dict) else flat.__setitem__(name, _axes(v))

    walk(got, "")
    assert flat == want


def _flat_shapes(struct) -> dict:
    import jax

    return {".".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(struct)[0]}
