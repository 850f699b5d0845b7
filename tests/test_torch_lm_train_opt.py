"""The port's Adafactor and the LM training substrate against the JAX
package's, on the CPU: the optimizers over 3 updates (factored and
unfactored leaves, a 4-d stacked leaf, an update-RMS clip that binds, bf16
parameters, and the chunked three-pass path at a tiny chunk size); the
mirrors of ``tests/test_train.py`` with an LM state (the loss falls under
both optimizers, microbatching, the checkpoint round trip and the elastic
restart); ``TokenSynthesizer``; and ``launch.train --mode lm``.

Tolerances: f32 parameters and optimizer state within rtol=1e-5, atol=1e-7
after 3 updates (the means and the sums of squares run in another order);
bf16 parameters within two bf16 ulps an update (AdamW's first bitwise);
the LM losses of a train step within rtol 1e-5, the microbatched step's
parameters within the reference test's 1e-4; the drivers' losses within
1e-4; checkpoint files byte for byte.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.data import tokens as JTok
from repro.launch import train as j_train
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import make_train_step as j_make_train_step
from repro.train import optimizer as JO
from repro.train.step import apply_updates as j_apply_updates
from repro_torch.data import tokens as Tok
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamTree
from repro_torch.train import (
    CheckpointManager,
    ElasticTrainer,
    init_state,
    make_optimizer,
    make_train_step,
    warmup_cosine,
)
from repro_torch.train import optimizer as O
from repro_torch.train.checkpoint import flatten_state
from torch_lm_util import J_RULES, RULES, nested, t

OPT_TOL = dict(rtol=1e-5, atol=1e-7)
LR = (1e-3, 2, 100)
# leaves: factored 2-d and 4-d (stacked), unfactored (one axis < 128), 1-d
SHAPES = {"w": (136, 160), "stack": (2, 3, 128, 136), "thin": (64, 200), "norm": (50,)}


def opt_tree(seed: int, dtype=np.float32):
    """Seeded parameters and 3 gradient trees; the first gradient of `w`
    has a few huge entries, so its factored update's RMS passes 1 and the
    clip binds."""
    rng = np.random.default_rng(seed)
    params = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    grads = []
    for i in range(3):
        g = {k: (0.01 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
        if i == 0:
            g["w"][rng.integers(0, 136, 4), rng.integers(0, 160, 4)] = 3.0
        grads.append(g)
    if dtype is not np.float32:
        params = {k: np.asarray(jnp.asarray(v, dtype)) for k, v in params.items()}
        grads = [{k: np.asarray(jnp.asarray(v, dtype)) for k, v in g.items()} for g in grads]
    return params, grads


def unclipped_rms(g: np.ndarray) -> float:
    """The RMS of the first Adafactor update of a factored leaf before its
    clip (beta = 0 at count 1), as the reference computes it."""
    g2 = g.astype(np.float64) ** 2 + 1e-30
    vr, vc = g2.mean(-1), g2.mean(-2)
    pre = g / np.sqrt(vr[..., None] * vc[..., None, :] / vr.mean(-1)[..., None, None])
    return float(np.sqrt((pre ** 2).mean()))


def run_ref(name, params, grads):
    opt = JO.make_optimizer(name, JO.warmup_cosine(*LR))

    @jax.jit
    def step(g, p, s):
        upd, s, m = opt.update(g, s, p)
        return j_apply_updates(p, upd), s, m

    p = jax.tree.map(jnp.asarray, params)
    s = opt.init(p)
    norms = []
    for g in grads:
        p, s, m = step(jax.tree.map(jnp.asarray, g), p, s)
        norms.append(float(m["grad_norm"]))
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s), norms


def tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array (bf16 ones too, exactly) as a tensor of its dtype."""
    if a.dtype == jnp.bfloat16:
        return t(a.astype(np.float32)).to(torch.bfloat16)
    return t(a)


def run_port(name, params, grads):
    opt = O.make_optimizer(name, O.warmup_cosine(*LR))
    p = {k: tensor(v) for k, v in params.items()}
    s = opt.init(p)
    norms = []
    for g in grads:
        s, m = opt.update({k: tensor(v) for k, v in g.items()}, s, p)
        norms.append(float(m["grad_norm"]))
    return p, s, norms


@pytest.mark.parametrize("chunk", [None, 1000])
@pytest.mark.parametrize("name", ["adafactor", "adamw"])
def test_optimizer_matches_reference_over_three_updates(name, chunk, monkeypatch):
    """f32 leaves of every kind; at `chunk` 1000 elements every leaf but
    `norm` is chunked (runs of rows of one matrix: the three-pass path)."""
    if chunk:
        monkeypatch.setattr(O, "CHUNK_ELEMS", chunk)
    params, grads = opt_tree(0)
    assert unclipped_rms(grads[0]["w"] * min(1.0, 1.0 / np.sqrt(sum(
        (g.astype(np.float64) ** 2).sum() for g in grads[0].values())))) > 1.0
    want_p, want_s, want_n = run_ref(name, params, grads)
    got_p, got_s, got_n = run_port(name, params, grads)
    np.testing.assert_allclose(got_n, want_n, rtol=1e-5)
    for k in SHAPES:
        np.testing.assert_allclose(got_p[k].numpy(), want_p[k], err_msg=k, **OPT_TOL)
    assert int(got_s["count"]) == int(want_s["count"]) == 3
    if name == "adafactor":
        for k in SHAPES:
            st = got_s["f"][k]
            assert set(st) == set(want_s["f"][k]) == ({"vr", "vc"} if k in ("w", "stack")
                                                       else {"v"})
            for part, v in st.items():
                np.testing.assert_allclose(v.numpy(), want_s["f"][k][part], rtol=1e-5,
                                           atol=1e-12, err_msg=f"{k}/{part}")


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 1e-30))) - 7)


@pytest.mark.parametrize("name", ["adafactor", "adamw"])
def test_optimizer_bf16_params_match_reference(name):
    """bf16 parameters and gradients over 3 updates.  AdamW's first update
    (elementwise, in the reference's order) is bitwise the reference's.
    Otherwise each update may round its f32 step and its bf16 sum the other
    way (the clip's norm, Adafactor's means and the f32 state sum in
    another order): every entry stays within two bf16 ulps an update, each
    at the magnitude of that update's operands along the reference's
    trajectory (measured: 1.52 ulps at most)."""
    params, grads = opt_tree(1, jnp.bfloat16)
    traj = [{k: v.astype(np.float32) for k, v in params.items()}]
    for n in (1, 2, 3):
        want_p, _, _ = run_ref(name, params, grads[:n])
        traj.append({k: v.astype(np.float32) for k, v in want_p.items()})
    first, _, _ = run_port(name, params, grads[:1])
    got_p, _, _ = run_port(name, params, grads)
    for k in SHAPES:
        assert got_p[k].dtype == torch.bfloat16
        if name == "adamw":
            np.testing.assert_array_equal(first[k].float().numpy(), traj[1][k], err_msg=k)
        bound = sum(2 * bf16_ulp(np.maximum(np.maximum(np.abs(a[k]), np.abs(b[k])),
                                            np.abs(b[k] - a[k])))
                    for a, b in zip(traj[:-1], traj[1:]))
        assert (np.abs(got_p[k].float().numpy() - traj[-1][k]) <= bound).all(), k


# -- mirrors of tests/test_train.py with an LM state --------------------------

CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32", remat="none")
JCFG = JModelConfig(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32", remat="none")


def setup(name):
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), JCFG))
    batch = {"tokens": np.ones((4, 64), np.int32), "labels": np.ones((4, 64), np.int32),
             "mask": np.ones((4, 64), np.float32)}
    opt = make_optimizer(name, warmup_cosine(*LR))
    state = init_state(ParamTree(T.params_from_numpy(tree, CFG, "cpu")), opt)
    loss_fn = lambda m, b: T.loss_fn(m.tree(), b, CFG, RULES)  # noqa: E731
    return tree, {k: t(v) for k, v in batch.items()}, opt, state, loss_fn


def ref_losses(name, tree, batch, steps, microbatches=1):
    opt = JO.make_optimizer(name, JO.warmup_cosine(*LR))
    step = jax.jit(j_make_train_step(lambda p, b: JT.loss_fn(p, b, JCFG, J_RULES), opt,
                                     microbatches=microbatches))
    p = jax.tree.map(jnp.asarray, tree)
    state = {"params": p, "opt": opt.init(p), "step": jnp.zeros((), jnp.int32)}
    losses = []
    for _ in range(steps):
        state, m = step(state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_loss_decreases(name):
    tree, batch, opt, state, loss_fn = setup(name)
    step = make_train_step(loss_fn, opt)
    losses = []
    for _ in range(5):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], (name, losses)
    np.testing.assert_allclose(losses, ref_losses(name, tree, batch, 5)[0], rtol=1e-5)


def test_microbatch_equivalence():
    tree, batch, opt, s1, loss_fn = setup("adamw")
    s1, m1 = make_train_step(loss_fn, opt, microbatches=1)(s1, batch)
    _, _, _, s2, _ = setup("adamw")
    s2, m2 = make_train_step(loss_fn, opt, microbatches=2)(s2, batch)
    p1, p2 = dict(s1["params"].named_parameters()), dict(s2["params"].named_parameters())
    assert max(float((p1[k] - p2[k]).abs().max()) for k in p1) < 1e-4
    # the reference's k = 2 step: the mean of the two slices' gradients, the
    # last slice's metrics
    losses, jstate = ref_losses("adamw", tree, batch, 1, microbatches=2)
    np.testing.assert_allclose(float(m2["loss"]), losses[0], rtol=1e-5)
    want = jax.tree.map(np.asarray, jstate["params"])
    got = nested(p2.items())
    # the reference test's k = 1 against k = 2 bound: AdamW's first step is
    # g / (|g| + 1e-8), which moves by up to lr where a gradient entry near
    # 1e-8 carries another rounding
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-4), got, want)


def j_state_of(state):
    """A port LM state as the reference's nested state (every leaf in its
    own dtype)."""
    out: dict = {}
    for path, v in flatten_state(state):
        *groups, leaf = path.split("/")
        d = out
        for g in groups:
            d = d.setdefault(g, {})
        d[leaf] = jnp.asarray(v.detach().numpy())
    return out


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_checkpoint_roundtrip_atomic_gc_and_reference_files(name, tmp_path):
    """The mirror of ``test_checkpoint_roundtrip_atomic_and_gc`` with an LM
    state after 2 steps; the same state written by the reference is equal
    file for file, byte for byte, and each package restores the other's."""
    tree, batch, opt, state, loss_fn = setup(name)
    step = make_train_step(loss_fn, opt)
    for _ in range(2):
        state, _ = step(state, batch)
    d = str(tmp_path / "torch")
    ck = CheckpointManager(d, keep=2, async_save=False)
    for s in (1, 2, 3):
        ck.save(s, state)
    assert ck.latest_step() == 3
    assert not os.path.exists(os.path.join(d, "step_000000001"))
    names = [n for n, _ in flatten_state(state)]
    assert names[0] == "opt/count" and names[-1] == "step"
    assert (("opt/f/layers/p0/attn/wq/v" in names and "opt/f/final_ln/v" in names)
            if name == "adafactor"
            else ("opt/m/layers/p0/attn/wq" in names and "opt/v/head" in names))
    _, _, _, fresh, _ = setup(name)
    restored = ck.restore(target=fresh)
    for (n, a), (_, b) in zip(flatten_state(restored), flatten_state(state)):
        assert torch.equal(a, b), n
    os.makedirs(os.path.join(d, "step_000000009.tmp"))
    CheckpointManager(d)
    assert not os.path.exists(os.path.join(d, "step_000000009.tmp"))
    # the reference writes the same bytes for the same state, and restores ours
    jstate = j_state_of(state)
    jd = tmp_path / "jax"
    JCheckpointManager(str(jd), async_save=False).save(3, jstate)
    files = sorted(os.listdir(jd / "step_000000003"))
    assert files == sorted(os.listdir(os.path.join(d, "step_000000003")))
    for fn in files:
        assert (jd / "step_000000003" / fn).read_bytes() == \
            open(os.path.join(d, "step_000000003", fn), "rb").read(), fn
    back = JCheckpointManager(d).restore(target=jax.tree.map(jnp.zeros_like, jstate))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 back, jstate)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_elastic_failure_restart_continues(name, tmp_path):
    tree, batch, opt, _, loss_fn = setup(name)
    step = make_train_step(loss_fn, opt)
    make_state = lambda device: init_state(  # noqa: E731
        ParamTree(T.params_from_numpy(tree, CFG, device)), opt)
    ck = CheckpointManager(str(tmp_path), async_save=False)
    trainer = ElasticTrainer(make_mesh=lambda: torch.device("cpu"), make_state=make_state,
                             make_step=lambda device: step, state_shardings=None, ckpt=ck,
                             checkpoint_every=2)
    batches = lambda: ((i, batch) for i in range(6))  # noqa: E731
    with pytest.raises(RuntimeError, match="simulated failure"):
        trainer.run(batches(), max_steps=6, fail_at=5)
    assert ck.latest_step() == 4
    done, metrics = trainer.run(batches(), max_steps=6)
    state = trainer.state
    assert done == 6 and int(state["step"]) == 6 and np.isfinite(metrics["loss"])
    straight = make_state(torch.device("cpu"))
    for _ in range(6):
        straight, _ = step(straight, batch)
    got = dict(state["params"].named_parameters())
    for k, p in straight["params"].named_parameters():
        assert float((got[k] - p).abs().max()) < 1e-5, k


# -- TokenSynthesizer and the LM driver ---------------------------------------


@pytest.mark.parametrize("seed,vocab,seq", [(0, 512, 256), (3, 32000, 96), (7, 256206, 64)])
def test_token_synthesizer_is_bitwise_the_reference_s(seed, vocab, seq):
    ours, theirs = Tok.TokenSynthesizer(vocab, seq, seed), JTok.TokenSynthesizer(vocab, seq, seed)
    for shard, step, b in ((0, 0, 2), (1, 5, 3), (7, 1 << 21, 1)):
        a, w = ours.shard_batch(shard, step, b), theirs.shard_batch(shard, step, b)
        assert set(a) == set(w)
        for k in w:
            assert a[k].dtype == w[k].dtype and np.array_equal(a[k], w[k]), k
    a, w = Tok.lm_input_batch(vocab, seq, 4, seed, 2), JTok.lm_input_batch(vocab, seq, 4, seed, 2)
    assert all(np.array_equal(a[k], w[k]) for k in w)


def test_lm_driver_matches_the_reference_train_lm(monkeypatch, capsys):
    """``--mode lm --reduced`` at the reference's defaults (mamba2-1.3b,
    batch 8, seq 256) over 4 steps, from the reference's initial weights:
    the losses within 1e-4 of the reference's ``train_lm``."""
    steps = 4
    args = argparse.Namespace(arch="mamba2-1.3b", reduced=True, steps=steps, batch=8, seq=256,
                              seed=0)
    ref = j_train.train_lm(args)
    jcfg = JR.get_arch("mamba2-1.3b").reduced
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))
    monkeypatch.setattr(T, "init_params",
                        lambda gen, cfg, device=None: T.params_from_numpy(tree, cfg, device))
    capsys.readouterr()
    got = t_train.main(["--mode", "lm", "--reduced", "--steps", str(steps), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"lm mamba2-smoke: {steps} steps in ")
    assert out[1].startswith("lm mamba2-smoke on cpu: step ") and out[1].endswith("card cpu")
    assert len(got["losses"]) == len(got["step_ms"]) == steps
    np.testing.assert_allclose(got["first_loss"], ref["first_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["last_loss"], ref["last_loss"], rtol=1e-4)
    assert got["last_loss"] < got["first_loss"]


def test_lm_driver_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(["--mode", "lm", "--reduced", "--steps", "1"])
