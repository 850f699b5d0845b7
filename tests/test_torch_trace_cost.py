"""``launch.trace_cost``, the port's counterpart of ``repro.launch.hlo_cost``:
one call traced on meta tensors.

* hand counts: a matmul chain's FLOPs, HBM bytes and ops; a 2-layer MLP's
  peak of live bytes through its forward and backward; a view and a
  storage viewed twice counted once; a layout's bookkeeping (optimizer-state
  specs, cache shapes, on ``ShapeDtype`` records) counting nothing;
* the collectives of a dry mesh (``distributed.comm`` with no world):
  results of the right shape, their bytes and calls counted by kind,
  backwards included, and nothing called in ``torch.distributed``;
* dry against real, exactly: the reduced one-device h2o-danube train step,
  prefill and decode traced on meta tensors count the FLOPs that
  ``roofline.count_flops`` (``FlopCounterMode``) counts on real CPU
  tensors, and the memo that skips the meta kernels changes no count.
"""

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_arch
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as rl
from repro_torch.launch import trace_cost as TC
from repro_torch.launch.mesh import Mesh
from repro_torch.launch import specs as SP
from repro_torch.launch.specs import make_optimizer_for
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeConfig
from repro_torch.models.layers import ParamTree
from repro_torch.train import init_state, make_train_step
from repro_torch.train.optimizer import Layout
from repro_torch.train.step import opt_layouts


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def test_a_matmul_chains_flops_bytes_and_ops():
    m, k, n, p = 64, 96, 128, 32
    a, b, c = meta(m, k), meta(k, n), meta(n, p)
    cost = TC.analyze(lambda a, b, c: (a @ b) @ c, (a, b, c))
    assert cost.flops == 2 * m * k * n + 2 * m * n * p
    assert cost.hbm_bytes == 4 * (m * k + k * n + m * n) + 4 * (m * n + n * p + m * p)
    assert cost.ops == 2 and cost.trans == 0 and cost.conv_flops == 0
    assert cost.arg_bytes == 4 * (m * k + k * n + n * p)
    # (a @ b) lives beside the arguments until the second product is made
    assert cost.peak_bytes == cost.arg_bytes + 4 * (m * n + m * p)
    assert cost.out_bytes == 4 * m * p and cost.alias_bytes == 0


def test_elementwise_is_free_and_transcendentals_count_apart():
    x = meta(1000)
    cost = TC.analyze(lambda x: torch.exp(x * 2.0 + 1.0).sum(), (x,))
    assert cost.flops == 0 and cost.trans == 1000
    assert cost.hbm_bytes == 4 * 1000 + 4  # the reduction's operand and result


def test_a_two_layer_mlps_forward_and_backward_peak():
    """x (8, 4) @ w1 (4, 4096) -> relu -> @ w2 (4096, 2) -> sum, and its
    backward.  The peak is relu's backward: beside the arguments, the loss
    and its seed gradient (``torch.autograd.backward`` holds it until the
    backward ends), relu's saved output r, the incoming gradient of r and
    the gradient of the hidden layer (3 x 8 x 4096 f32) and w2's gradient,
    each block rounded up to 512 bytes.  The first product's output died
    when relu had read it."""
    b, d, h, o = 8, 4, 4096, 2
    x, w1, w2 = meta(b, d), meta(d, h, grad=True), meta(h, o, grad=True)

    def step(x, w1, w2):
        loss = (torch.relu(x @ w1) @ w2).sum()
        loss.backward()
        return loss

    cost = TC.analyze(step, (x, w1, w2))
    args = 512 + 4 * d * h + 4 * h * o  # x's 128 bytes take one block
    assert cost.arg_bytes == args
    assert cost.peak_bytes == args + 2 * 512 + 3 * 4 * b * h + 4 * h * o
    # forward 2bdh + 2bho; backward: w2's and r's gradients 4bho, w1's 2bdh
    assert cost.flops == 4 * b * d * h + 6 * b * h * o


def test_a_view_and_its_storage_count_once():
    x = meta(256, 256)

    def fn(x):
        y = x + 1
        return x.view(-1), x[::2], y, y.t()

    cost = TC.analyze(fn, (x,))
    assert cost.arg_bytes == 4 * 256 * 256
    assert cost.peak_bytes == 2 * 4 * 256 * 256
    assert cost.out_bytes == 2 * 4 * 256 * 256 and cost.alias_bytes == 4 * 256 * 256


def test_bookkeeping_counts_nothing():
    """The optimizer-state specs of a rank's 1,024 x 512 block of a
    16,384 x 8,192 weight (``opt_layouts``, which a meshed train step
    runs) and full jamba's cache shapes at 524,288 positions, inside a
    trace: no op dispatched, no storage held."""
    x = meta(1024, 512)
    mesh = Mesh({"data": 16, "model": 16}, 0, torch.device("meta"), "none")
    jamba = get_arch("jamba-v0.1-52b").config

    def fn(x):
        layout = Layout(mesh, {"w": ("data", "model")})
        ref, nat = opt_layouts(make_optimizer_for(jamba), layout, {"w": x})
        assert ref["f"]["w"] == nat["f"]["w"] == {"vr": ("data",), "vc": ("model",)}
        caches = T.cache_spec(jamba, 64, 524_288)
        assert caches["p0"]["h"].shape[1] == 64
        return x * 2

    cost = TC.analyze(fn, (x,))
    assert cost.peak_bytes == 2 * 4 * 1024 * 512 and cost.flops == 0 and cost.ops == 1


def test_collectives_on_a_dry_mesh_count_and_call_nothing(monkeypatch):
    for name in ("all_reduce", "all_gather", "all_to_all_single", "batch_isend_irecv"):
        monkeypatch.setattr(dist, name, lambda *a, **k: pytest.fail("a world was called"))
    mesh = Mesh({"data": 2, "model": 4}, 5, torch.device("meta"), "none")
    x = meta(8, 6, grad=True)

    def fn(x):
        s = comm.psum(x, mesh, "model")  # 192 B
        g = comm.gather_shards(comm.copy_to(s, mesh, "data"), mesh, "model", 1)  # 192 B
        a = comm.all_to_all(g, mesh, "model", 0, 1)  # (2, 96): 768 B
        p = comm.ppermute(a.detach(), mesh, "data", 1)  # 768 B
        assert (s.shape, g.shape, a.shape, p.shape) == ((8, 6), (8, 24), (2, 96), (2, 96))
        assert comm.all_gather(x.detach(), mesh, "data").shape == (2, 8, 6)  # 192 B
        a.sum().backward()
        return x.grad

    cost = TC.analyze(fn, (x,), counter=mesh.counter)
    # backward: a2a 768 B, gather_shards' psum 768 B, copy_to's psum 192 B
    assert cost.coll_calls == {"all-gather": 2, "all-reduce": 3, "reduce-scatter": 0,
                               "all-to-all": 2, "collective-permute": 1}
    assert cost.coll_breakdown == {"all-gather": 384, "all-reduce": 192 + 768 + 192,
                                   "reduce-scatter": 0, "all-to-all": 1536,
                                   "collective-permute": 768}
    assert cost.coll_bytes == sum(cost.coll_breakdown.values())
    # a tensor with values on a mesh with no world: no collective, no count
    before = dict(mesh.counter.calls)
    for call in (lambda t: comm.psum(t, mesh, "model"), lambda t: comm.all_gather(t, mesh, "data"),
                 lambda t: comm.ppermute(t, mesh, "data", 1),
                 lambda t: comm.all_to_all(t, mesh, "model", 0, 1)):
        with pytest.raises(RuntimeError, match="takes meta tensors, not cpu ones"):
            call(torch.ones(8, 6))
    assert dict(mesh.counter.calls) == before


H2O = get_arch("h2o-danube-1.8b").reduced
CELLS = {"train": ShapeConfig("t", 64, 2, "train"), "prefill": ShapeConfig("p", 64, 2, "prefill"),
         "decode": ShapeConfig("d", 128, 2, "decode")}
CACHE_LEN = 70


def real_args(kind):
    """The reduced h2o's seeded one-device inputs of a `kind` cell on the CPU."""
    cfg, rules = H2O, ShardingRules.make(None)
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(gen, cfg, "cpu")
    shape = CELLS[kind]
    tokens = torch.randint(1, cfg.vocab_size, (shape.global_batch, shape.seq_len + 1),
                           generator=gen, dtype=torch.int32)
    if kind == "train":
        model = ParamTree(params)
        state = init_state(model, make_optimizer_for(cfg))
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
                 "mask": torch.ones(shape.global_batch, shape.seq_len)}
        return state, batch
    if kind == "prefill":
        return params, tokens[:, :-1]
    caches = T.init_cache(cfg, shape.global_batch, shape.seq_len, "cpu", rules)
    return params, tokens[:, :1], caches, CACHE_LEN


@pytest.mark.parametrize("kind", list(CELLS))
def test_dry_flops_equal_flop_counter_modes_on_real_tensors(kind):
    shape = CELLS[kind]
    spec = {"train": SP.build_train_cell, "prefill": SP.build_prefill_cell,
            "decode": SP.build_decode_cell}[kind](H2O, shape, None)
    args = D.meta_args(spec, shape)
    if kind == "decode":
        args[3] = CACHE_LEN
    cost = TC.analyze(spec.fn, args)
    if kind == "train":  # the real step takes the model its state was built on
        fn = make_train_step(lambda m, b: T.loss_fn(m.tree(), b, H2O, spec.rules),
                             make_optimizer_for(H2O))
    else:
        fn = spec.fn
    _, want = rl.count_flops(fn, *real_args(kind))
    assert cost.flops + cost.conv_flops == want and cost.conv_flops == 0


def test_the_memo_changes_no_count(monkeypatch):
    """The reduced h2o train step on a dry (2, 2) rank, traced with and
    without the memo of meta results: every count equal."""
    mesh = Mesh({"data": 2, "model": 2}, 0, torch.device("meta"), "none")
    shape = CELLS["train"]
    costs = []
    for memo in (True, False):
        spec = SP.build_train_cell(H2O, shape, mesh)
        mesh.counter.reset()
        if not memo:
            monkeypatch.setattr(TC._CostMode, "_memoized", lambda *a: TC._MISS)
        costs.append(TC.analyze(spec.fn, D.meta_args(spec, shape), counter=mesh.counter))
    assert costs[0] == costs[1]
    assert costs[0].coll_bytes > 0 and costs[0].flops > 0
