"""Python binding of the embedding bag kernels in ``csrc/embedding.cu``, and
the autograd Function of the one-device DLRM's bag over them.

The binding works as ``kernels._binding`` describes: checked arguments,
outputs and scratch from ``torch.empty``, launches on the current stream
that raise if refused, and one more in ``LAUNCHES`` a call ("embedding_bag"
for the forward, "embedding_bag.backward" for the backward).  Dtypes and
shapes are checked before the device, so a wrong call raises the same on
any device.  Its plain version, with the same arguments, is
``models.recsys.embedding_bag_plain``.

The backward sorts the forward's keys (each position's flat row t*R + id,
T*R where it counts nothing) stably with ``torch.sort``, the glue between
the forward's keys and the backward's kernels, then writes every row of the
dense (T, R, D) gradient once.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.common.util import span
from repro_torch.kernels._binding import I32, I64, P, check, count, launch

_SIGNATURES = {
    "presto_embedding_bag_forward": (P, P, P, P, P, P, P, I64, I32, I32, I32, I32, I32, I32,
                                     I32, P),
    "presto_embedding_bag_backward": (P, I64, I64, P, P, P, I32, P, P, P,
                                      I32, I32, I32, I32, I32, I32, I32, P),
}

CHUNK = 64  # sorted positions a partial sum covers (kChunk in csrc/embedding.cu)
MAX_DIM = 512  # four groups of 4 elements a lane
FLOATS = (torch.float32, torch.float64)  # the trainer's type, and the elastic drill's control
_INT_LIMIT = 2**31 - 1


def geometry(tables, multi_ids, lengths, one_ids):
    """(T, R, D, B, S, L, G) of a bag call; raises on a dtype, a shape or a
    size the kernels do not take, whatever the device."""
    for name, x, dtypes, dim in (("tables", tables, FLOATS, 3),
                                 ("multi_ids", multi_ids, (torch.int32,), 3),
                                 ("lengths", lengths, (torch.int32,), 2),
                                 ("one_ids", one_ids, (torch.int32,), 2)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
        if x.dtype not in dtypes:
            raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {x.dtype}")
        if x.dim() != dim:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want {dim} dimensions")
    t, r, d = tables.shape
    b, s, L = multi_ids.shape
    g = one_ids.shape[1]
    if tuple(lengths.shape) != (b, s) or one_ids.shape[0] != b or s + g != t:
        raise ValueError(
            f"bag shapes disagree: tables {tuple(tables.shape)}, multi_ids {(b, s, L)}, "
            f"lengths {tuple(lengths.shape)}, one_ids {tuple(one_ids.shape)} (want T = S + G)")
    if d % 4 or not 0 < d <= MAX_DIM:
        raise ValueError(f"the bag kernels take D a multiple of 4 up to {MAX_DIM}, got {d}")
    if t * r >= _INT_LIMIT or b * (s * L + g) >= _INT_LIMIT:
        raise ValueError(f"{t} x {r} rows or {b} x {s * L + g} positions exceed int32 keys")
    return t, r, d, b, s, L, g


def forward(tables, multi_ids, lengths, one_ids, keys: bool = True):
    """Mean-pooled (B, T, D) of the tables' type (f32 or f64), each bag's
    count of valid ids (B, T) i32 and, with `keys`, each position's flat row
    (B, S*L + G) i32 (T*R where it counts nothing); else None for the keys."""
    t, r, d, b, s, L, g = geometry(tables, multi_ids, lengths, one_ids)
    check(tables, "tables", tables.dtype, None, align=16)
    dev = tables.device
    for name, x in (("multi_ids", multi_ids), ("lengths", lengths), ("one_ids", one_ids)):
        check(x, name, torch.int32, None, dev)
    out = torch.empty((b, t, d), dtype=tables.dtype, device=dev)
    counts = torch.empty((b, t), dtype=torch.int32, device=dev)
    key_out = torch.empty((b, s * L + g), dtype=torch.int32, device=dev) if keys else None
    if b * t:
        launch("embedding", _SIGNATURES, "presto_embedding_bag_forward", dev,
               tables.data_ptr(), multi_ids.data_ptr(), lengths.data_ptr(), one_ids.data_ptr(),
               out.data_ptr(), counts.data_ptr(), 0 if key_out is None else key_out.data_ptr(),
               b, t, r, d, s, L, g, int(tables.dtype == torch.float64))
        count("embedding_bag")
    return out, counts, key_out


def backward(grad_out, counts, keys, tables_shape, multi_shape):
    """The dense (T, R, D) gradient of the tables, of grad_out's type (f32
    or f64): row t*R + id holds the sum, over the positions keyed to it in
    position order, of grad_out[b, t] / max(count[b, t], 1); every other row
    0.  grad_out (B, T, D) needs unit stride along D and 16-byte aligned
    rows."""
    t, r, d = tables_shape
    b, s, L = multi_shape
    g = t - s
    n = b * (s * L + g)
    if not isinstance(grad_out, torch.Tensor) or grad_out.dtype not in FLOATS:
        raise TypeError(f"grad_out must be float32 or float64, got "
                        f"{getattr(grad_out, 'dtype', grad_out)}")
    if tuple(grad_out.shape) != (b, t, d):
        raise ValueError(f"grad_out has shape {tuple(grad_out.shape)}, want {(b, t, d)}")
    if grad_out.device.type != "cuda":
        raise ValueError(f"grad_out must be a CUDA tensor, got {grad_out.device}")
    sb, st, sd = grad_out.stride()
    if sd != 1 or sb % 4 or st % 4 or grad_out.data_ptr() % 16:
        raise ValueError(f"grad_out's rows must be unit-stride and 16-byte aligned, strides "
                         f"{(sb, st, sd)}")
    dev = grad_out.device
    check(counts, "counts", torch.int32, (b, t), dev)
    check(keys, "keys", torch.int32, (b, s * L + g), dev)
    grad = torch.empty((t, r, d), dtype=grad_out.dtype, device=dev)
    if t * r:
        sorted_keys, perm = torch.sort(keys.reshape(-1), stable=True)
        starts = torch.empty(t * r, dtype=torch.int32, device=dev)
        partials = torch.empty((n // CHUNK, d), dtype=grad_out.dtype, device=dev)
        launch("embedding", _SIGNATURES, "presto_embedding_bag_backward", dev,
               grad_out.data_ptr(), sb, st, counts.data_ptr(), sorted_keys.data_ptr(),
               perm.data_ptr(), n, starts.data_ptr(), partials.data_ptr(), grad.data_ptr(),
               t, r, d, s, L, g, int(grad_out.dtype == torch.float64))
        count("embedding_bag.backward")
    return grad


class EmbeddingBag(torch.autograd.Function):
    """The bag as one node: the forward kernel, and a backward that returns
    the tables' dense gradient (autograd adds it into ``.grad``, or makes it
    ``.grad``).  Its backward launches under the ``dlrm.embedding_bag`` span
    too, so the span holds both passes."""

    @staticmethod
    def forward(ctx, tables, multi_ids, lengths, one_ids):
        pooled, counts, keys = forward(tables, multi_ids, lengths, one_ids,
                                       keys=ctx.needs_input_grad[0])
        ctx.save_for_backward(counts, keys)
        ctx.shapes = (tuple(tables.shape), tuple(multi_ids.shape))
        return pooled

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        counts, keys = ctx.saved_tensors
        with span("dlrm.embedding_bag"):
            if grad_out.stride(-1) != 1 or grad_out.data_ptr() % 16 or any(
                    st % 4 for st in grad_out.stride()[:2]):
                grad_out = grad_out.contiguous()
            return backward(grad_out, counts, keys, *ctx.shapes), None, None, None
