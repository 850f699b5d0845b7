"""Schema-driven parameters, norms, RoPE, attention and MLPs: the port of
``repro.models.layers``.

A model declares its parameters once as a nested dict of ``ParamDef``;
``init_from_schema`` turns the schema into tensors.  The reference draws
from ``jax.random`` and this port from ``torch.Generator``: the two give
different numbers from the same seed, so parity tests carry the reference's
initialized weights across as numpy (``recsys.params_from_numpy``,
``transformer.params_from_numpy``) instead of initializing twice.
``pspecs_from_schema`` maps the schema's logical axes to mesh axes through
``distributed.sharding.ShardingRules``.

The layers keep the reference's arithmetic in plain torch ops: norms and
attention in f32, RoPE frequencies computed in numpy float32 as the
reference computes them, and attention as the reference's blockwise online
softmax (q blocks of 512, kv blocks of 1024, ``-1e30`` fills, every kv block
visited in order, fully masked ones included), with no library attention
and no compile.  ``cp_decode_attention`` is the context-parallel decode
over a mesh: each rank holds a contiguous slice of the cache's sequence
and the partial softmaxes combine by one ``pmax`` and two ``psum``s
(``distributed.comm``).

On a mesh (``rules.mesh``) every weight is the rank's block under the
reference's layout (``param_pspecs``): its ``fsdp`` axis over ``data``,
its tensor-parallel axis (``heads``, ``kv_heads``, ``ff``, ``vocab``,
``experts``) over ``model``.  ``load_weight`` gathers the ``fsdp`` axes in
the compute dtype (the reference's explicit bf16 all-gather) and keeps the
tensor-parallel block.  A column-parallel product takes its input through
``tp_copy`` (Megatron's "f": the backward sums the input's gradient over
the axis), a row-parallel one gives its output to ``tp_sum`` ("g", the
psum).  ``mlp_apply`` is one of each.  With no mesh, or axes of one rank,
both are the identity and the arithmetic is the one-device arithmetic.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import comm
from repro_torch.distributed.sharding import entry_axes, shard, spec_index


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple  # logical axis names (len == ndim); the meshed port reads them
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in)

    def fan_in(self) -> int:
        # second-minor dim: (d_in, d_out) and stacked layouts alike
        return self.shape[-2] if len(self.shape) > 1 else self.shape[-1]


Schema = Dict[str, Any]  # nested dict of ParamDef


def _path_seed(path: str) -> int:
    return zlib.crc32(path.encode())


def init_from_schema(
    generator: torch.Generator, schema: Schema, dtype: torch.dtype, device: torch.device,
    specs: Optional[Dict[str, Any]] = None, mesh=None,
) -> Dict[str, Any]:
    """Nested dict of tensors on `device`, one per ``ParamDef``.  Each
    normal leaf draws from its own generator on `device`, seeded by
    `generator`'s seed and the leaf's path (the counterpart of the
    reference's ``fold_in``), so a leaf's values do not depend on the order
    of the schema.  Leaves are filled in place: a full-size table takes no
    second buffer.  With `specs` (a tree of specs over `mesh`) each leaf a
    spec splits is drawn whole and cut to this rank's block, one leaf at a
    time."""
    base = generator.initial_seed()

    def draw(node, path):
        if node.init == "zeros":
            return torch.zeros(node.shape, dtype=dtype, device=device)
        if node.init == "ones":
            return torch.ones(node.shape, dtype=dtype, device=device)
        scale = node.scale if node.scale is not None else 1.0 / math.sqrt(
            max(node.fan_in(), 1)
        )
        leaf = torch.Generator(device=device)
        leaf.manual_seed((base * 0x9E3779B1 + _path_seed(path)) % (1 << 63))
        t = torch.empty(node.shape, dtype=torch.float32, device=device)
        return t.normal_(generator=leaf).mul_(scale).to(dtype)

    def walk(node, path, spec):
        if isinstance(node, ParamDef):
            t = draw(node, path)
            return shard(t, mesh, spec).clone() if spec is not None and any(spec) else t
        return {k: walk(v, f"{path}/{k}", None if spec is None else spec[k])
                for k, v in node.items()}

    return walk(schema, "", specs)


def pspecs_from_schema(schema: Schema, rules) -> Dict[str, Any]:
    """Nested dict of specs (``rules.pspec`` of each leaf's logical axes)."""

    def walk(node):
        if isinstance(node, ParamDef):
            return rules.pspec(*node.axes)
        return {k: walk(v) for k, v in node.items()}

    return walk(schema)


def shapes_from_schema(schema: Schema, dtype: torch.dtype) -> Dict[str, Any]:
    """Nested dict of meta tensors of each leaf's shape and `dtype` (the
    reference's ``ShapeDtypeStruct`` tree)."""

    def walk(node):
        if isinstance(node, ParamDef):
            return torch.empty(node.shape, dtype=dtype, device="meta")
        return {k: walk(v) for k, v in node.items()}

    return walk(schema)


def tree_from_numpy(tree: Dict[str, Any], schema: Schema, device: torch.device) -> Dict[str, Any]:
    """The reference's params (a nested dict of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them) as tensors on `device`,
    walked by `schema` and checked against its shapes."""

    def walk(node, sch, path):
        if isinstance(sch, ParamDef):
            arr = np.asarray(node)
            if arr.shape != tuple(sch.shape):
                raise ValueError(f"{path}: {arr.shape}, the schema {sch.shape}")
            return torch.from_numpy(np.array(arr, copy=True)).to(device)
        return {k: walk(node[k], sch[k], f"{path}/{k}") for k in sch}

    return walk(tree, schema, "")


class ParamTree(nn.Module):
    """A nested dict of tensors as an ``nn.Module``: every leaf an
    ``nn.Parameter`` registered under its tree path (``layers.p0.attn.wq``
    for the reference's ``layers/p0/attn/wq``), so ``named_parameters``,
    ``zero_grad``, the train steps and the checkpoint's nesting of dotted
    names see the reference's tree.  ``tree()`` gives the nested dict of
    these same Parameters, which the models' functions take."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, v if isinstance(v, nn.Parameter)
                                        else nn.Parameter(v))

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.named_parameters(recurse=False))
        out.update({k: m.tree() for k, m in self.named_children()})
        return out


def stack_schema(schema: Schema, n: int) -> Schema:
    """Prepend a scan ('layers') axis of length n to every leaf."""

    def walk(node):
        if isinstance(node, ParamDef):
            return ParamDef(
                (n,) + node.shape, ("layers",) + node.axes, node.init, node.scale
            )
        return {k: walk(v) for k, v in node.items()}

    return walk(schema)


def live_axes(rules, entry) -> tuple:
    """The mesh axes of one spec entry that have more than one rank
    (none without a mesh)."""
    if rules.mesh is None:
        return ()
    return tuple(a for a in entry_axes(entry) if rules.mesh.shape[a] > 1)


def tp_axes(rules, logical: Optional[str]) -> tuple:
    """The mesh axes (of more than one rank) that `logical` splits over."""
    if logical is None:
        return ()
    return live_axes(rules, rules.pspec(logical)[0])


def tp_index(rules, logical: str) -> int:
    """This rank's block along `logical` (0 where it is whole)."""
    if not tp_axes(rules, logical):
        return 0
    return spec_index(rules.mesh, rules.pspec(logical)[0])


def tp_size(rules, logical: str) -> int:
    """The number of blocks `logical` is split into on this mesh."""
    n = 1
    for a in tp_axes(rules, logical):
        n *= rules.mesh.shape[a]
    return n


def tp_copy(x: torch.Tensor, rules, logical: Optional[str]) -> torch.Tensor:
    """`x` entering a product split over `logical` ("f": identity forward,
    the gradient summed over the axes)."""
    for a in tp_axes(rules, logical):
        x = comm.copy_to(x, rules.mesh, a)
    return x


def tp_sum(x: torch.Tensor, rules, logical: Optional[str]) -> torch.Tensor:
    """The sum over `logical`'s axes of a product split over it ("g")."""
    for a in tp_axes(rules, logical):
        x = comm.psum(x, rules.mesh, a)
    return x


def tp_gather(x: torch.Tensor, rules, logical: Optional[str], dim: int) -> torch.Tensor:
    """The whole of tensor axis `dim` from the ranks' blocks along
    `logical` (minor mesh axis first); the backward keeps this rank's
    block of the summed cotangent."""
    for a in reversed(tp_axes(rules, logical)):
        x = comm.gather_shards(x, rules.mesh, a, dim)
    return x


def load_weight(p: torch.Tensor, rules, *axes, dtype: torch.dtype) -> torch.Tensor:
    """A weight cast to the compute dtype (no copy when it already is), its
    axes checked by ``rules.constrain``.  `axes` are the weight's logical
    axes with ``None`` where its schema says ``fsdp``.  On a mesh `p` is
    the rank's block of the stored weight, and each mesh axis the stored
    spec has and `axes`' spec has not (the FSDP axes) is all-gathered after
    the cast: the reference's explicit compute-dtype gather."""
    w = p.to(dtype)
    if rules.mesh is not None:
        stored = rules.pspec(*("fsdp" if a is None else a for a in axes))
        kept = rules.pspec(*axes)
        for dim, (s_entry, k_entry) in enumerate(zip(stored, kept)):
            for a in reversed(live_axes(rules, s_entry)):
                if a not in entry_axes(k_entry):
                    w = comm.gather_shards(w, rules.mesh, a, dim)
    return rules.constrain(w, *axes)


# ---------------------------------------------------------------------------
# Norms


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.to(torch.float32))).to(dt)


# ---------------------------------------------------------------------------
# RoPE


def rope_freq(d: int, theta: float) -> np.ndarray:
    """The half-split RoPE frequencies, in numpy float32 as the reference
    computes them."""
    half = d // 2
    return (theta ** (-np.arange(0, half, dtype=np.float32) / half)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rope_freq_on(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freq`` on `device`, copied there once: a copy from host memory
    waits for the device's queue to drain, and a decode step applies RoPE
    twice a layer."""
    return torch.from_numpy(rope_freq(d, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, D), positions (..., S) -> rotated x (half-split RoPE)."""
    half = x.shape[-1] // 2
    freq = _rope_freq_on(x.shape[-1], float(theta), x.device)
    ang = positions[..., None].to(torch.float32) * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise attention (prefill)


def _pattern_mask(qpos: torch.Tensor, kpos: torch.Tensor, pattern: str, window: int,
                  chunk: int, causal: bool) -> torch.Tensor:
    """(Qb, KVb) bool mask from positions."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if pattern == "swa" and window > 0:
        m &= (qpos[:, None] - kpos[None, :]) < window
    if pattern == "chunked" and chunk > 0:
        m &= torch.div(qpos[:, None], chunk, rounding_mode="floor") == torch.div(
            kpos[None, :], chunk, rounding_mode="floor")
    return m


def blockwise_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, K, D)
    v: torch.Tensor,  # (B, Skv, K, D)
    *,
    pattern: str = "full",
    window: int = 0,
    chunk: int = 0,
    causal: bool = True,
    q_offset: int = 0,
    q_block: int = 512,
    kv_block: int = 1024,
    segment_ids_q: Optional[torch.Tensor] = None,
    segment_ids_kv: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Online-softmax attention, O(q_block*kv_block) memory. GQA via groups.
    Raises where a sequence does not split into its blocks (the reference
    asserts it)."""
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    G = H // K
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Skv)
    if Sq % q_block or Skv % kv_block:
        raise ValueError(f"sequences of {Sq} and {Skv} do not split into blocks of "
                         f"{q_block} and {kv_block}")
    nq, nk = Sq // q_block, Skv // kv_block
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    qr = q.reshape(B, nq, q_block, K, G, D).permute(1, 0, 3, 4, 2, 5)  # (nq, B, K, G, Qb, D)
    kr = k.reshape(B, nk, kv_block, K, D).permute(1, 0, 3, 2, 4)  # (nk, B, K, KVb, D)
    vr = v.reshape(B, nk, kv_block, K, D).permute(1, 0, 3, 2, 4)
    segq = (segment_ids_q.reshape(B, nq, q_block).permute(1, 0, 2)
            if segment_ids_q is not None else None)
    segk = (segment_ids_kv.reshape(B, nk, kv_block).permute(1, 0, 2)
            if segment_ids_kv is not None else None)

    outs = []
    for iq in range(nq):
        qb = qr[iq].to(torch.float32)
        qpos = q_offset + iq * q_block + torch.arange(q_block, device=dev)
        m_run = torch.full((B, K, G, q_block), -1e30, dtype=torch.float32, device=dev)
        l_run = torch.zeros((B, K, G, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, K, G, q_block, D), dtype=torch.float32, device=dev)
        for jk in range(nk):  # every block in order, fully masked ones too
            kpos = jk * kv_block + torch.arange(kv_block, device=dev)
            logits = torch.einsum("bkgqd,bkcd->bkgqc", qb, kr[jk].to(torch.float32)) * scale
            mask = _pattern_mask(qpos, kpos, pattern, window, chunk, causal)
            if segq is not None:
                mask = mask & (segq[iq][:, None, None, :, None] == segk[jk][:, None, None, None, :])
            else:
                mask = mask[None, None, None]
            logits = torch.where(mask, logits, -1e30)
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqc,bkcd->bkgqd", p, vr[jk].to(torch.float32))
            m_run = m_new
        out = acc / torch.clamp_min(l_run[..., None], 1e-30)
        outs.append(out.to(q.dtype))
    # (nq, B, K, G, Qb, D) -> (B, Sq, H, D)
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, K * G, D)


# ---------------------------------------------------------------------------
# Decode attention (single new token against a KV cache)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, K, D)
    v_cache: torch.Tensor,  # (B, S, K, D)
    cache_len: torch.Tensor,  # (B,) valid prefix length (new token included)
    *,
    pattern: str = "full",
    window: int = 0,
    chunk: int = 0,
) -> torch.Tensor:
    B, S, K, D = k_cache.shape
    H = q.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    qr = q.reshape(B, K, G, D)
    logits = torch.einsum("bkgd,bskd->bkgs", qr.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    kpos = torch.arange(S, device=q.device)[None, :]  # (1, S)
    qpos = cache_len[:, None] - 1  # (B, 1) position of the new token
    m = kpos < cache_len[:, None]
    if pattern == "swa" and window > 0:
        m &= (qpos - kpos) < window
    if pattern == "chunked" and chunk > 0:
        m &= torch.div(qpos, chunk, rounding_mode="floor") == torch.div(
            kpos, chunk, rounding_mode="floor")
    logits = torch.where(m[:, None, None, :], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, D).to(q.dtype)


def cp_decode_attention(
    q: torch.Tensor,  # (B, 1, H, D), whole on every rank
    k_local: torch.Tensor,  # (B, S_local, K, D): this rank's slice of the cache
    v_local: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) global valid prefix length (new token included)
    *,
    mesh,
    axis: str = "data",
    pattern: str = "full",
    window: int = 0,
    chunk: int = 0,
) -> torch.Tensor:
    """Context-parallel decode: the KV cache's sequence split over `axis`,
    rank i of the axis holding positions [i * S_local, (i + 1) * S_local).

    Flash-decoding combine, in the reference's arithmetic: each rank takes
    its slice's masked f32 logits, their max, the exponentials' sum and the
    weighted sum of values; the ranks' partials merge by a ``pmax`` of the
    maxima and ``psum``s of the rescaled sums, divided at the end by the
    sum clamped at 1e-30.  Every rank returns the whole result in
    ``q.dtype``."""
    B, S, K, D = k_local.shape
    H = q.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    shard = mesh.coords[axis]
    qr = q.reshape(B, K, G, D)
    logits = torch.einsum("bkgd,bskd->bkgs", qr.to(torch.float32),
                          k_local.to(torch.float32)) * scale
    kpos = shard * S + torch.arange(S, device=q.device)[None, :]
    qpos = cache_len[:, None] - 1
    m = kpos < cache_len[:, None]
    if pattern == "swa" and window > 0:
        m &= (qpos - kpos) < window
    if pattern == "chunked" and chunk > 0:
        m &= torch.div(qpos, chunk, rounding_mode="floor") == torch.div(
            kpos, chunk, rounding_mode="floor")
    logits = torch.where(m[:, None, None, :], logits, -1e30)
    m_loc = logits.amax(dim=-1)  # (B, K, G)
    p = torch.exp(logits - m_loc[..., None])
    del logits
    l_loc = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v_local.to(torch.float32))
    m_glob = comm.pmax(m_loc, mesh, axis)
    corr = torch.exp(m_loc - m_glob)
    l_glob = comm.psum(l_loc * corr, mesh, axis)
    acc_glob = comm.psum(acc * corr[..., None], mesh, axis)
    out = acc_glob / torch.clamp_min(l_glob[..., None], 1e-30)
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs


def mlp_schema(cfg, kind: str) -> Schema:
    d, f = cfg.d_model, cfg.d_ff
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": ParamDef((d, f), ("fsdp", "ff")),
            "w_up": ParamDef((d, f), ("fsdp", "ff")),
            "w_down": ParamDef((f, d), ("ff", "fsdp")),
        }
    return {
        "w_in": ParamDef((d, f), ("fsdp", "ff")),
        "w_out": ParamDef((f, d), ("ff", "fsdp")),
    }


def mlp_apply(params, x: torch.Tensor, kind: str, rules) -> torch.Tensor:
    """The MLP of `kind`; on a mesh the input products are column-parallel
    over ``ff`` and the output product row-parallel, summed over it."""
    dt = x.dtype
    x = tp_copy(x, rules, "ff")
    if kind in ("swiglu", "geglu"):
        w_gate = load_weight(params["w_gate"], rules, None, "ff", dtype=dt)
        w_up = load_weight(params["w_up"], rules, None, "ff", dtype=dt)
        w_down = load_weight(params["w_down"], rules, "ff", None, dtype=dt)
        g = x @ w_gate
        u = x @ w_up
        g = rules.constrain(g, "batch", "seq", "ff")
        act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
        out = h @ w_down
    else:
        w_in = load_weight(params["w_in"], rules, None, "ff", dtype=dt)
        w_out = load_weight(params["w_out"], rules, "ff", None, dtype=dt)
        h = F.gelu(x @ w_in, approximate="tanh")
        h = rules.constrain(h, "batch", "seq", "ff")
        out = h @ w_out
    return rules.constrain(tp_sum(out, rules, "ff"), "batch", "seq", "embed")
