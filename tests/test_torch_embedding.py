"""The DLRM's embedding bag (``models.recsys.embedding_bag``): the routing by
device, the kernel binding's checks, and on a card the hand-written kernels
(``kernels/csrc/embedding.cu``) against the plain version.

No JAX here: ``test_torch_train.py`` holds the plain version to the
reference.  On the CPU the bag must stay the code it was before the kernels,
bit for bit, forward and tables' gradient (``_todays_bag`` is a frozen copy
of it).  Card tolerances, and why:

* forward, rtol 1e-6 against the plain version: both sum the valid rows in
  position order and divide once; only how the compiler contracts a
  weighted add may differ;
* gradient, against the float64 sum of the same terms, row by row within
  (k + 2) u S, k the row's contributions, S the sum of their magnitudes and
  u the type's unit roundoff (2^-24 in float32, 2^-53 in float64: recursive
  summation's bound, plus each quotient's rounding): kernel and plain sum in
  different orders, so each is held to the bound, and rows no position
  touches are exactly 0 in both;
* float64 forward, rtol 1e-15 against the plain version, for the same
  reason as float32's rtol 1e-6.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import _binding
from repro_torch.kernels import embedding as emb
from repro_torch.models import recsys as RS

UNIT = {torch.float32: 2.0**-24, torch.float64: 2.0**-53}  # unit roundoff


def _todays_bag(tables, multi_ids, lengths, one_ids):
    """The bag as the port computed it before the kernels (frozen copy)."""
    t, r, d = tables.shape
    b, s, L = multi_ids.shape
    g = one_ids.shape[1]
    dev = multi_ids.device
    mask = torch.arange(L, device=dev) < lengths[..., None]
    ids = torch.cat([multi_ids.reshape(b, s * L), one_ids], dim=1).to(torch.int64)
    valid = torch.cat([mask.reshape(b, s * L), torch.ones_like(one_ids, dtype=torch.bool)],
                      dim=1)
    valid &= (ids >= 0) & (ids < r)
    table_of = torch.cat([torch.arange(s, device=dev).repeat_interleave(L),
                          torch.arange(s, s + g, device=dev)])
    counts = torch.cat([valid[:, : s * L].reshape(b, s, L).sum(-1), valid[:, s * L:]], dim=1)
    starts = torch.cat([torch.arange(s, device=dev) * L, s * L + torch.arange(g, device=dev)])
    offsets = (torch.arange(b, device=dev)[:, None] * (s * L + g) + starts).reshape(-1)
    flat = ids.clamp(0, r - 1) + table_of * r
    pooled = F.embedding_bag(
        flat.reshape(-1), tables.reshape(t * r, d), offsets, mode="sum",
        per_sample_weights=valid.reshape(-1).to(tables.dtype),
    ).reshape(b, t, d)
    return pooled / counts.clamp_min(1)[..., None].to(pooled.dtype)


def _inputs(seed, b, s, L, g, r, case="lengths"):
    """Ids, lengths and one-hot ids as int32 tensors for one test case."""
    rng = np.random.default_rng(seed)
    multi = rng.integers(0, r, (b, s, L))
    lengths = rng.integers(0, L + 1, (b, s))
    one = rng.integers(0, r, (b, g))
    if case == "lengths":  # none, some and every position of a bag
        lengths[:, 0], lengths[:, -1] = 0, L
    elif case == "ids_out_of_range":  # below 0, at R and past it count nothing
        multi[rng.random(multi.shape) < 0.3] = rng.choice([-5, -1, r, r + 7])
        one[rng.random(one.shape) < 0.3] = rng.choice([-1, r, r + 3])
    elif case == "empty_bags":
        lengths[:] = 0
        one[:] = -1
    elif case == "hot_row":  # every sample on one id of a one-hot table and of a bag
        multi[:, 0, :] = 2
        lengths[:, 0] = L
        one[:, 0] = 1
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))  # noqa: E731
    return as_t(multi), as_t(lengths), as_t(one)


def _f64_bag(tables, multi, lengths, one):
    """The bag's semantics as a plain loop in float64."""
    t, r, d = tables.shape
    b, s, L = multi.shape
    w = tables.double().numpy()
    out = np.zeros((b, t, d))
    for i in range(b):
        for k in range(t):
            ids = (multi[i, k, : max(int(lengths[i, k]), 0)] if k < s else one[i, k - s: k - s + 1])
            ids = [int(x) for x in ids if 0 <= x < r]
            if ids:
                out[i, k] = w[k, ids].sum(0) / len(ids)
    return out


# (B, S, L, G, R, D, case, dtype): rm2's layout cut down, rm1's one-hot-only
# one, and the elastic drill's float64
CPU_CASES = {
    "lengths": (6, 3, 5, 2, 11, 8, "lengths", torch.float32),
    "ids_out_of_range": (6, 3, 5, 2, 11, 8, "ids_out_of_range", torch.float32),
    "empty_bags": (4, 3, 5, 2, 11, 8, "empty_bags", torch.float32),
    "one_hot_only": (6, 4, 1, 3, 11, 8, "lengths", torch.float32),
    "hot_row": (9, 3, 4, 2, 11, 8, "hot_row", torch.float32),
    "float64": (6, 3, 5, 2, 11, 8, "ids_out_of_range", torch.float64),
}


@pytest.mark.parametrize("name", list(CPU_CASES))
def test_cpu_bag_is_todays_code_bit_for_bit(name):
    b, s, L, g, r, d, case, dtype = CPU_CASES[name]
    multi, lengths, one = _inputs(1, b, s, L, g, r, case)
    base = torch.randn(s + g, r, d, generator=torch.Generator().manual_seed(2), dtype=dtype)
    grad_out = torch.randn(b, s + g, d, generator=torch.Generator().manual_seed(3), dtype=dtype)
    before = dict(_binding.LAUNCHES)
    got_t, want_t = base.clone().requires_grad_(True), base.clone().requires_grad_(True)
    got = RS.embedding_bag(got_t, multi, lengths, one)
    want = _todays_bag(want_t, multi, lengths, one)
    assert torch.equal(got, want)
    got.backward(grad_out)
    want.backward(grad_out)
    assert torch.equal(got_t.grad, want_t.grad)
    assert _binding.LAUNCHES == before
    if case == "empty_bags":
        assert not got.any() and not got_t.grad.any()


@pytest.mark.parametrize("name", list(CPU_CASES))
def test_cpu_bag_pools_only_valid_positions(name):
    b, s, L, g, r, d, case, dtype = CPU_CASES[name]
    multi, lengths, one = _inputs(4, b, s, L, g, r, case)
    tables = torch.randn(s + g, r, d, generator=torch.Generator().manual_seed(5), dtype=dtype)
    got = RS.embedding_bag(tables, multi, lengths, one)
    np.testing.assert_allclose(got.double().numpy(), _f64_bag(tables, multi, lengths, one),
                               rtol=1e-6, atol=1e-6)


def _call(kind):
    """A binding call that must raise, by the fault it carries."""
    multi, lengths, one = _inputs(0, 2, 3, 4, 2, 7)
    tables = torch.zeros(5, 7, 8)
    if kind == "cpu_tensors":
        return lambda: emb.forward(tables, multi, lengths, one)
    if kind == "int64_ids":
        return lambda: emb.forward(tables, multi.long(), lengths, one)
    if kind == "f16_tables":
        return lambda: emb.forward(tables.half(), multi, lengths, one)
    if kind == "lengths_shape":
        return lambda: emb.forward(tables, multi, lengths[:, :2], one)
    if kind == "tables_not_s_plus_g":
        return lambda: emb.forward(torch.zeros(6, 7, 8), multi, lengths, one)
    if kind == "width_not_multiple_of_4":
        return lambda: emb.forward(torch.zeros(5, 7, 6), multi, lengths, one)
    if kind == "backward_cpu_grad":
        keys = torch.zeros(2, 3 * 4 + 2, dtype=torch.int32)
        counts = torch.zeros(2, 5, dtype=torch.int32)
        return lambda: emb.backward(torch.zeros(2, 5, 8), counts, keys, (5, 7, 8), (2, 3, 4))
    if kind == "backward_grad_shape":
        keys = torch.zeros(2, 3 * 4 + 2, dtype=torch.int32)
        counts = torch.zeros(2, 5, dtype=torch.int32)
        return lambda: emb.backward(torch.zeros(2, 4, 8), counts, keys, (5, 7, 8), (2, 3, 4))
    raise AssertionError(kind)


@pytest.mark.parametrize("kind,error,match", [
    ("cpu_tensors", ValueError, "CUDA"),
    ("int64_ids", TypeError, "int32"),
    ("f16_tables", TypeError, "float32 or torch.float64"),
    ("lengths_shape", ValueError, "disagree"),
    ("tables_not_s_plus_g", ValueError, "disagree"),
    ("width_not_multiple_of_4", ValueError, "multiple of 4"),
    ("backward_cpu_grad", ValueError, "CUDA"),
    ("backward_grad_shape", ValueError, "shape"),
])
def test_binding_refuses(kind, error, match):
    before = dict(_binding.LAUNCHES)
    with pytest.raises(error, match=match):
        _call(kind)()
    assert _binding.LAUNCHES == before


def test_tensors_off_the_cpu_take_the_kernels(monkeypatch):
    """A tensor anywhere but the CPU goes to the binding, which launches or
    raises: ``F.embedding_bag`` is never reached."""
    def no_fallback(*a, **k):
        raise AssertionError("fell back to F.embedding_bag")

    monkeypatch.setattr(F, "embedding_bag", no_fallback)
    multi, lengths, one = _inputs(0, 2, 3, 4, 2, 7)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="must be a CUDA tensor, got meta"):
        RS.embedding_bag(torch.zeros(5, 7, 8, device=meta), multi.to(meta), lengths.to(meta),
                         one.to(meta))


def test_both_passes_have_a_counter():
    assert {"embedding_bag", "embedding_bag.backward"} <= set(_binding.LAUNCHES)


# -- on the card ---------------------------------------------------------------


def _keys(multi, lengths, one, r):
    """Each position's flat row t*R + id, T*R where it counts nothing."""
    b, s, L = multi.shape
    g = one.shape[1]
    t = s + g
    dev = multi.device
    pos = torch.arange(L, device=dev)
    table = torch.arange(t, device=dev)
    mk = torch.where((pos < lengths[..., None]) & (multi >= 0) & (multi < r),
                     table[:s, None] * r + multi, t * r)
    ok = torch.where((one >= 0) & (one < r), table[s:] * r + one, t * r)
    return torch.cat([mk.reshape(b, s * L), ok], dim=1).to(torch.int32)


def _hold_grad(name, grad, grad_out, counts, keys, r):
    """`grad` within the float64 bound of every touched row, and exactly 0
    on every other row; returns the largest gap to float64."""
    t, _, d = grad.shape
    p = keys.shape[1]
    flat = keys.reshape(-1)
    pos = torch.nonzero(flat < t * r).squeeze(1)
    row = flat[pos].long()
    b, tt = pos // p, row // r
    term = grad_out[b, tt].double() / counts[b, tt].clamp_min(1).double()[:, None]
    rows, inv = torch.unique(row, return_inverse=True)
    want = torch.zeros(len(rows), d, dtype=torch.float64, device=grad.device)
    mag = torch.zeros_like(want)
    want.index_add_(0, inv, term)
    mag.index_add_(0, inv, term.abs())
    k = torch.bincount(inv, minlength=len(rows)).double()[:, None]
    g2 = grad.view(t * r, d)
    gap = (g2[rows].double() - want).abs()
    assert bool((gap <= (k + 2) * UNIT[grad.dtype] * mag).all()), f"{name}: past the bound"
    for i in range(t):  # untouched rows exactly 0, a table at a time
        nz = torch.nonzero(grad[i].ne(0).any(1)).squeeze(1) + i * r
        assert bool(torch.isin(nz, rows).all()), f"{name}: an untouched row of table {i}"
    return float(gap.max()) if gap.numel() else 0.0


def _card_case(dev, b, s, L, g, r, d, seed, case="lengths", dtype=torch.float32):
    multi, lengths, one = (x.to(dev) for x in _inputs(seed, b, s, L, g, r, case))
    gen = torch.Generator(dev).manual_seed(seed)
    tables = (torch.randn(s + g, r, d, generator=gen, device=dev, dtype=dtype) * 0.01)
    tables.requires_grad_(True)
    grad_out = torch.randn(b, s + g, d, generator=gen, device=dev, dtype=dtype)
    return tables, multi, lengths, one, grad_out


def _kernel_and_plain(tables, multi, lengths, one, grad_out):
    """(pooled, grad) of the kernel path and of the plain version."""
    out = []
    for fn in (RS.embedding_bag, RS.embedding_bag_plain):
        tables.grad = None
        pooled = fn(tables, multi, lengths, one)
        pooled.backward(grad_out)
        out.append((pooled.detach(), tables.grad))
    tables.grad = None
    return out


@pytest.mark.card
def test_kernel_against_plain_at_rm2_shapes(card):
    """RM2's tables (63 x 500,000 x 128) and bags (42 x 32 multi-hot, 21
    one-hot) at B = 1,024: forward and gradient, with the launches."""
    tables, multi, lengths, one, grad_out = _card_case(card, 1024, 42, 32, 21, 500_000, 128, 7)
    before = dict(_binding.LAUNCHES)
    (pooled, grad), (plain, plain_grad) = _kernel_and_plain(tables, multi, lengths, one, grad_out)
    assert _binding.LAUNCHES["embedding_bag"] == before["embedding_bag"] + 1
    assert _binding.LAUNCHES["embedding_bag.backward"] == before["embedding_bag.backward"] + 1
    torch.testing.assert_close(pooled, plain, rtol=1e-6, atol=0)
    _, counts, keys = emb.forward(tables.detach(), multi, lengths, one)
    assert torch.equal(keys, _keys(multi, lengths, one, 500_000))
    for name, g in (("kernel", grad), ("plain", plain_grad)):
        _hold_grad(name, g, grad_out, counts, keys, 500_000)


@pytest.mark.card
def test_backward_is_bit_identical_across_calls(card):
    tables, multi, lengths, one, grad_out = _card_case(card, 1024, 42, 32, 21, 500_000, 128, 8)
    _, counts, keys = emb.forward(tables.detach(), multi, lengths, one)
    first = emb.backward(grad_out, counts, keys, tuple(tables.shape), tuple(multi.shape))
    second = emb.backward(grad_out, counts, keys, tuple(tables.shape), tuple(multi.shape))
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.card
def test_hot_row(card):
    """Every sample of an 8,192-row batch on one id of a Bucketized table
    (and of one multi-hot bag): 8,192 contributions to one row, summed in
    partial chunks; against float64 and plain, and the same bits twice."""
    r = 4096
    tables, multi, lengths, one, grad_out = _card_case(card, 8192, 42, 32, 21, r, 128, 9,
                                                       "hot_row")
    (pooled, grad), (plain, plain_grad) = _kernel_and_plain(tables, multi, lengths, one, grad_out)
    torch.testing.assert_close(pooled, plain, rtol=1e-6, atol=0)
    _, counts, keys = emb.forward(tables.detach(), multi, lengths, one)
    for name, g in (("kernel", grad), ("plain", plain_grad)):
        _hold_grad(name, g, grad_out, counts, keys, r)
    again = emb.backward(grad_out, counts, keys, tuple(tables.shape), tuple(multi.shape))
    assert torch.equal(grad.view(torch.int32), again.view(torch.int32))


@pytest.mark.card
@pytest.mark.parametrize("b,s,L,g,r,d,case,dtype", [
    (300, 3, 5, 2, 1000, 64, "ids_out_of_range", torch.float32),
    (300, 3, 40, 2, 1000, 256, "lengths", torch.float32),  # two ballots a bag, two float4 a lane
    (300, 26, 1, 13, 1000, 512, "lengths", torch.float32),  # rm1's layout at the widest D
    (300, 26, 1, 13, 1000, 384, "lengths", torch.float32),  # a lane's last group past D
    (64, 3, 5, 2, 1000, 8, "empty_bags", torch.float32),
    (513, 4, 3, 3, 1000, 128, "hot_row", torch.float32),
    (513, 4, 33, 3, 1000, 128, "hot_row", torch.float64),  # the elastic drill's control
])
def test_kernel_against_plain_at_other_shapes(card, b, s, L, g, r, d, case, dtype):
    tables, multi, lengths, one, grad_out = _card_case(card, b, s, L, g, r, d, 10, case, dtype)
    (pooled, grad), (plain, plain_grad) = _kernel_and_plain(tables, multi, lengths, one, grad_out)
    assert pooled.dtype == grad.dtype == dtype
    torch.testing.assert_close(pooled, plain, rtol=1e-6 if dtype == torch.float32 else 1e-15,
                               atol=0)
    _, counts, keys = emb.forward(tables.detach(), multi, lengths, one)
    assert torch.equal(keys, _keys(multi, lengths, one, r))
    for name, gr in (("kernel", grad), ("plain", plain_grad)):
        _hold_grad(name, gr, grad_out, counts, keys, r)
    if case == "empty_bags":
        assert not pooled.any() and not grad.any()
