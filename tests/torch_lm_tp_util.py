"""Shared machinery of the LM's tensor-parallel tests
(``test_torch_lm_tp.py``, ``test_torch_lm_tp_moe.py``): seeded inputs of
the reduced archs, the port's worlds of CPU ranks (rank programs in
``torch_lm_tp_ranks.py``), the reference's meshed run on fake devices
(started in the background while the ranks run) and the port's one device,
and the checks both files parametrize.

Each arch runs under its full config's sharding rule and optimizer (the
reduced configs carry neither), on (data=2, model=2) or, for gemma3, on
(data=1, model=4): its 2 kv heads do not divide 4, so the reference's
``_kv_axis`` replicates the kv projections.  f32 throughout, rtol = atol =
1e-5 unless a check says otherwise.
"""

import os
import pickle
import subprocess
import sys
import types

import numpy as np
import torch

import torch_lm_tp_ranks as R
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import run_spmd
from repro_torch.launch.specs import shape_rules
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamDef
from repro_torch.train.step import opt_state_pspecs

TOL = dict(rtol=1e-5, atol=1e-5)
B, S_TRAIN, PROMPT, STEPS, MAX_SEQ = 4, 32, 32, 2, 36
KV_ARCH = "gemma3-12b"  # on (data=1, model=4)


def mesh_of(arch) -> tuple:
    return (1, 4) if arch == KV_ARCH else (2, 2)


def close(got, want, **kw) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **{**TOL, **kw})


def flat(tree, path="") -> dict:
    """A nested dict by dotted names; a dict keyed by device ids (a leaf's
    shards) is a leaf."""
    out = {}
    for k, v in tree.items():
        name = f"{path}.{k}" if path else k
        nested = isinstance(v, dict) and not all(isinstance(i, int) for i in v)
        out.update(flat(v, name) if nested else {name: v})
    return out


def nest(named: dict) -> dict:
    """Dotted names back to a nested dict."""
    out: dict = {}
    for name, v in named.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def fake_mesh(shape, rank=0):
    m = types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                              axis_names=("data", "model"))
    m.coords = dict(zip(("data", "model"), divmod(rank, shape[1])))
    return m


def numpy_params(schema, rng) -> dict:
    """Seeded weights of a schema, drawn as ``init_from_schema`` draws
    (normal over the fan-in, zeros where it says so)."""
    if isinstance(schema, ParamDef):
        if schema.init == "zeros":
            return np.zeros(schema.shape, np.float32)
        scale = schema.scale if schema.scale is not None else 1.0 / np.sqrt(schema.fan_in())
        return (rng.normal(size=schema.shape) * scale).astype(np.float32)
    return {k: numpy_params(v, rng) for k, v in schema.items()}


def make_inputs(archs, overrides=None) -> dict:
    """Seeded weights, a batch and prompts of each arch (its config's fields
    changed by `overrides`, kept in the case for the rank program)."""
    cases = {}
    for i, arch in enumerate(archs):
        cfg = R.tp_config(arch, overrides)
        rng = np.random.default_rng(10 + i)
        tree = numpy_params((E if cfg.is_encdec else T).model_schema(cfg), rng)
        toks = rng.integers(1, cfg.vocab_size, (B, S_TRAIN + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 "mask": np.ones((B, S_TRAIN), np.float32)}
        frames = None
        if cfg.is_encdec:
            frames = rng.normal(size=(B, S_TRAIN, cfg.d_model)).astype(np.float32)
            batch["frames"] = frames
        cases[arch] = dict(arch=arch, tree=tree, batch=batch, steps=STEPS, max_seq=MAX_SEQ,
                           prompts=rng.integers(1, cfg.vocab_size, (B, PROMPT)).astype(np.int32),
                           frames=frames, overrides=overrides)
    return cases


_REF = """
import dataclasses, pickle, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import registry as JR
from repro.launch.specs import build_decode_cell, build_prefill_cell, build_train_cell
from repro.launch.specs import make_optimizer_for
from repro.models import encdec as JE, transformer as JT
from repro.models.config import ShapeConfig
inp = pickle.load(open(%(path)r, "rb"))
res = {}

def index(a, sh):
    return tuple((i.start or 0, n if i.stop is None else i.stop) for i, n in zip(sh.index, a.shape))

def shards(tree):
    return jax.tree.map(lambda a: {s.device.id: (index(a, s), np.asarray(s.data))
                                   for s in a.addressable_shards}, tree)

for arch, c in inp["cases"].items():
    full = JR.get_arch(arch).config
    cfg = dataclasses.replace(JR.get_arch(arch).reduced, sharding_overrides=full.sharding_overrides,
                              optimizer=full.optimizer)
    mod = JE if cfg.is_encdec else JT
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(inp["meshes"][arch]), ("data", "model"))
    b, s = c["batch"]["tokens"].shape
    p, max_seq = c["prompts"].shape[1], c["max_seq"]
    cell = build_train_cell(cfg, ShapeConfig("tp_train", s, b, "train"), mesh)
    opt = make_optimizer_for(cfg)
    params = jax.tree.map(jnp.asarray, c["tree"])
    state = {"params": params, "opt": opt.init(params), "step": jnp.zeros((), jnp.int32)}
    state = jax.device_put(state, cell.in_shardings[0])
    batch = jax.device_put(c["batch"], cell.in_shardings[1])
    r = {"params": shards(state["params"]), "opt_index": jax.tree.map(
        lambda a: {x.device.id: index(a, x) for x in a.addressable_shards}, state["opt"])}

    def train(st, bt):
        (loss, m), g = jax.value_and_grad(lambda pr: mod.loss_fn(pr, bt, cfg, cell.rules),
                                          has_aux=True)(st["params"])
        new, met = cell.fn(st, bt)
        return loss, g, new, met

    loss, g, new, met = jax.jit(train, in_shardings=cell.in_shardings)(state, batch)
    r["loss"], r["grads"] = float(loss), jax.tree.map(np.asarray, g)
    r["new"] = jax.tree.map(np.asarray, {"params": new["params"], "opt": new["opt"]})
    r["metrics"] = {k: float(v) for k, v in met.items()}
    pcell = build_prefill_cell(cfg, ShapeConfig("tp_prefill", p, b, "prefill"), mesh)
    dcell = build_decode_cell(cfg, ShapeConfig("tp_decode", max_seq, b, "decode"), mesh)
    if cfg.is_encdec:
        enc = jax.jit(pcell.fn, in_shardings=pcell.in_shardings)(params, c["frames"])
        r["prefill"] = np.asarray(enc)
        xp = params["dec_layers"]["xattn"]
        kv = lambda w: jnp.stack([(enc @ w[j]).reshape(b, enc.shape[1], cfg.n_kv_heads, cfg.hd)
                                  for j in range(cfg.n_layers)])
        zeros = jnp.zeros((cfg.n_layers, b, max_seq, cfg.n_kv_heads, cfg.hd), enc.dtype)
        caches = {"self_k": zeros, "self_v": zeros, "cross_k": kv(xp["wk"]),
                  "cross_v": kv(xp["wv"])}
        tok, start = jnp.asarray(c["prompts"][:, :1]), 0
    else:
        logits, caches = jax.jit(lambda pr, t: JT.prefill(pr, t, cfg, pcell.rules, max_seq),
                                 in_shardings=pcell.in_shardings)(params, c["prompts"])
        r["prefill"] = np.asarray(logits)
        tok, start = jnp.argmax(logits[:, -1, :], -1).astype(jnp.int32)[:, None], p
    r["caches"] = caches = jax.tree.map(np.asarray, caches)  # placed anew by the decode cell
    step = jax.jit(dcell.fn, in_shardings=dcell.in_shardings)
    r["decode"] = []
    for i in range(c["steps"]):
        lg, caches = step(params, tok, caches, jnp.int32(start + i))
        caches = jax.tree.map(np.asarray, caches)
        r["decode"].append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1, :], -1).astype(jnp.int32)[:, None]
    res[arch] = r
pickle.dump(res, open(%(path)r + ".out", "wb"))
print("REF_OK")
"""




def start_reference(cases, tmpdir):
    """The reference's meshed runs of `cases` in a subprocess on 4 fake
    devices, started now: (process, path of its results)."""
    path = os.path.join(str(tmpdir), "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump({"cases": cases, "meshes": {a: mesh_of(a) for a in cases}}, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    with open(path + ".log", "w") as log:  # the child keeps its own descriptor
        proc = subprocess.Popen([sys.executable, "-c", _REF % {"path": path}], stdout=log,
                                stderr=subprocess.STDOUT, env=env)
    return proc, path


def finish_reference(job, timeout: float = 900) -> dict:
    proc, path = job
    try:
        code = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(path + ".log") as f:
        log = f.read()
    assert code == 0 and "REF_OK" in log, f"reference run failed:\n{log[-4000:]}"
    with open(path + ".out", "rb") as f:
        return pickle.load(f)


def run_worlds(cases) -> dict:
    """Each mesh shape's world over its archs: {arch: [each rank's result]}."""
    out = {}
    for shape in sorted({mesh_of(a) for a in cases}):
        archs = [a for a in cases if mesh_of(a) == shape]
        ranks = run_spmd(R.tp_rank, shape, ("data", "model"), device="cpu",
                         args=({a: cases[a] for a in archs},), timeout=900)
        out.update({a: [r[a] for r in ranks] for a in archs})
    return out


def one_device(cases) -> dict:
    """The port's one-device prefill (encode) and greedy decode of each arch."""
    out = {}
    for arch, c in cases.items():
        cfg = R.tp_config(arch, c.get("overrides"))
        mod = E if cfg.is_encdec else T
        rules = S.ShardingRules.make(None)
        params = mod.params_from_numpy(c["tree"], cfg, "cpu")
        if cfg.is_encdec:
            enc = E.encode(params, torch.from_numpy(c["frames"]), cfg, rules)
            first = enc.numpy()
            caches = E.cross_caches(params, enc, cfg, MAX_SEQ)
            tok, start = torch.from_numpy(c["prompts"][:, :1]), 0
        else:
            logits, caches = T.prefill(params, torch.from_numpy(c["prompts"]), cfg, rules,
                                       MAX_SEQ)
            first, tok, start = logits.numpy(), R._greedy(logits), PROMPT
        steps = []
        for i in range(STEPS):
            lg, caches = mod.decode_step(params, tok, caches, start + i, cfg, rules)
            steps.append(lg.numpy())
            tok = R._greedy(lg)
        out[arch] = {"prefill": first, "decode": steps}
    return out


def rank_specs(arch, rank, kind="train"):
    """(config, fake mesh of `rank`, the port's rules for the `kind` cell)."""
    cfg = R.tp_config(arch)
    mesh = fake_mesh(mesh_of(arch), rank)
    return cfg, mesh, shape_rules(cfg, R.shapes(B, S_TRAIN, MAX_SEQ)[kind], mesh)


def index_of(shape, mesh, spec):
    return tuple((sl.start, sl.stop) for sl in S.block_index(shape, mesh, spec))


def _param_specs(arch, rank):
    cfg, mesh, rules = rank_specs(arch, rank)
    return cfg, mesh, flat((E if cfg.is_encdec else T).param_pspecs(cfg, rules))


def check_parameter_blocks(world, ref, arch):
    shapes = {k: v.shape for k, v in flat(ref[arch]["grads"]).items()}
    for rank, r in enumerate(world[arch]):
        _, mesh, specs = _param_specs(arch, rank)
        got, want = flat(r["params"]), flat(ref[arch]["params"])
        assert got.keys() == want.keys() == specs.keys()
        for name, block in got.items():
            index, data = want[name][rank]
            assert index_of(shapes[name], mesh, specs[name]) == index, name
            assert np.array_equal(block, data), name


def _opt_specs(arch, ref, specs):
    return _opt_specs_of(R.tp_config(arch), flat(ref[arch]["grads"]), specs)


def check_optimizer_state_blocks(world, ref, arch):
    want = flat(ref[arch]["opt_index"])
    shapes = {k: v.shape for k, v in flat(ref[arch]["new"]["opt"]).items()}
    for rank, r in enumerate(world[arch]):
        _, mesh, specs = _param_specs(arch, rank)
        ospecs = _opt_specs(arch, ref, specs)
        got = flat(r["train"]["opt"])
        assert ospecs.keys() == want.keys() == shapes.keys() == got.keys()
        for name, spec in ospecs.items():
            assert index_of(shapes[name], mesh, spec) == want[name][rank], name
            assert got[name].shape == S.block_shape(shapes[name], mesh, spec), name


def check_train(world, ref, arch):
    want_g, new_p = flat(ref[arch]["grads"]), flat(ref[arch]["new"]["params"])
    new_opt = flat(ref[arch]["new"]["opt"])
    for rank, r in enumerate(world[arch]):
        _, mesh, specs = _param_specs(arch, rank)
        tr = r["train"]
        close(tr["metrics"]["loss"], ref[arch]["loss"])
        close(tr["metrics"]["grad_norm"], ref[arch]["metrics"]["grad_norm"])
        assert tr["grads"].keys() == want_g.keys()
        for name, g in tr["grads"].items():
            close(g, S.shard(want_g[name], mesh, specs[name]), err_msg=name)
            close(tr["params"][name], S.shard(new_p[name], mesh, specs[name]), err_msg=name)
        ospecs = _opt_specs(arch, ref, specs)
        for name, block in flat(tr["opt"]).items():
            want = S.shard(new_opt[name], mesh, ospecs[name])
            close(block, want, rtol=1e-4, atol=1e-5 * float(np.abs(new_opt[name]).max()),
                  err_msg=name)


def check_serving(world, ref, local, arch):
    _, _, prules = rank_specs(arch, 0, "prefill")
    for rank, r in enumerate(world[arch]):
        rows = S.block_index((B,), fake_mesh(mesh_of(arch), rank), prules.pspec("batch"))[0]
        close(r["prefill"], ref[arch]["prefill"][rows])
        close(r["prefill"], local[arch]["prefill"][rows])
        for i in range(STEPS):
            close(r["decode"][i], ref[arch]["decode"][i][rows])
            close(r["decode"][i], local[arch]["decode"][i][rows])


def check_caches(world, ref, arch):
    cfg = R.tp_config(arch)
    mod = E if cfg.is_encdec else T
    want = flat(ref[arch]["caches"])
    for rank, r in enumerate(world[arch]):
        for kind, key in (("prefill", "prefill_caches"), ("decode", "decode_caches_before")):
            _, mesh, rules = rank_specs(arch, rank, kind)
            specs = flat(mod.cache_pspecs(cfg, rules))
            for name, block in flat(r[key]).items():
                close(block, S.shard(want[name], mesh, specs[name]), err_msg=f"{kind} {name}")


def check_checkpoint(world, ckpt_dir, arch):
    """The global-format checkpoint the ranks saved after the step restores
    on one device into the arrays their blocks make up, bit for bit."""
    from repro_torch.models.layers import ParamTree
    from repro_torch.train import init_state
    from repro_torch.train.checkpoint import CheckpointManager

    cfg = R.tp_config(arch)
    mod = E if cfg.is_encdec else T
    shapes = flat(numpy_params(mod.model_schema(cfg), np.random.default_rng(0)))
    model = ParamTree(nest({k: torch.zeros(v.shape) for k, v in shapes.items()}))
    target = init_state(model, R.make_optimizer_for(cfg))
    CheckpointManager(ckpt_dir, async_save=False).restore(1, target=target)
    got = {f"params.{k}": p.detach().numpy() for k, p in model.named_parameters()}
    got.update({f"opt.{k}": v.numpy() for k, v in flat(target["opt"]).items()})
    for rank, r in enumerate(world[arch]):
        _, mesh, pspecs = _param_specs(arch, rank)
        specs = {**{f"params.{k}": v for k, v in pspecs.items()},
                 **{f"opt.{k}": v for k, v in _opt_specs_of(cfg, shapes, pspecs).items()}}
        blocks = {**{f"params.{k}": v for k, v in r["train"]["params"].items()},
                  **{f"opt.{k}": v for k, v in flat(r["train"]["opt"]).items()}}
        assert blocks.keys() == got.keys() == specs.keys()
        for name, block in blocks.items():
            index = S.block_index(got[name].shape, mesh, specs[name])
            assert np.array_equal(got[name][index], block), name
    assert int(target["step"]) == 1 and int(target["opt"]["count"]) == 1


def _opt_specs_of(cfg, shapes, pspecs) -> dict:
    whole = {k: torch.empty(v.shape, device="meta") for k, v in shapes.items()}
    return flat(opt_state_pspecs(R.make_optimizer_for(cfg), whole, pspecs))
