"""Periodic decoder LM: the port of ``repro.models.transformer``'s schemas,
its training forward (``loss_fn``, ``_backbone``, ``chunked_xent``),
``prefill`` and ``decode_step``.

The layer stack is `n_periods` repetitions of a heterogeneous *period*
(``cfg.period()``).  Parameters keep the reference's tree: layers stacked
over periods under ``layers/p{i}``, each leaf with a leading ``n_periods``
axis, so ``params_from_numpy`` carries the reference's ``init_params``
output across.  Where the reference scans over periods, the port loops over
the stacked axis.  Caches keep the reference's layout too:
``(n_periods, B, max_seq, K, hd)`` per attention position ``p{i}``.

Where the port differs, and why:

* ``decode_step`` writes the new token's k and v into `caches` in place and
  returns the same dict (the reference returns new arrays): a cache of the
  full h2o-danube-1.8b at batch 4 and 8,224 positions is 2 GB of bf16.
* Writing past the cache: the reference's ``dynamic_update_slice`` clamps a
  write at ``cache_len >= max_seq`` onto the last slot; indexing there
  would raise on the CPU and assert on the card, which ends the CUDA
  context.  ``decode_step`` checks ``0 <= cache_len < max_seq`` on the host
  and raises ``ValueError`` (ROADMAP C11).
* ``cast_weights`` keeps one copy of every weight that ``load_weight``
  reads (and of the embedding) in the compute dtype; ``load_weight`` then
  casts nothing.  The numbers are those of the reference's cast on every
  call; the norms' weights stay in the parameter dtype, as the reference
  reads them.

* Mamba positions keep their state ``h`` and conv window in the caches too,
  written in place by ``decode_step``; ``prefill`` takes the window from the
  projections ``ssm.mamba_forward`` computed (the reference computes them
  again: the same numbers).  A config with no attention position has no KV
  cache, so C11 has nothing to check there and decode runs past any
  ``max_seq``, as the reference's does.

Training runs on autograd.  The train path reads the parameters (f32
masters, or bf16 where ``cfg.param_dtype`` says so) through
``load_weight``, a cast that autograd differentiates; ``cast_weights``'
copies, which hold no gradient, are for serving only.  A model to train is
a ``layers.ParamTree`` over ``params_from_numpy``'s or ``init_params``'
tree, and ``loss_fn(model.tree(), batch, cfg, rules)`` keeps the
reference's signature.  The reference's remat (``jax.checkpoint`` of the
scan body) is ``torch.utils.checkpoint`` of each period
(``use_reentrant=False``): ``"full"`` saves nothing, ``"dots"`` saves the
outputs of ``aten.mm`` (the projections: 3-d activations times 2-d
weights), as ``checkpoint_dots_with_no_batch_dims`` saves the dots without
batch dimensions; attention's and the SSD's einsums and the experts'
products are batched (``bmm``) and recomputed.  Remat moves memory, not
numbers.  Where the reference scans over the stacked periods, ``_backbone``
unbinds each stacked leaf once, so autograd stacks the periods' gradients
in one pass (indexing period by period would add a full-size zero
gradient a period).

Every family of the registry serves and trains: attention (full, swa,
local_global, chunked), mamba and MoE layers.

Context-parallel decode (``shard_kv_seq`` on a mesh with a ``data`` axis,
as ``launch.specs.shape_rules`` sets it up for ``long_500k``): each rank
holds its contiguous slice of every attention cache's sequence
(``cache_pspecs``: ``kv_seq -> data``) and the whole batch.  The new
token's k and v are written only by the rank whose slice holds position
``cache_len``, at the local index; attention is
``layers.cp_decode_attention``; C11 checks ``cache_len`` against the global
length, the data axis's size times the slice.  The SSM state and conv
window are not sequence-sharded: every rank computes them whole.  On a
mesh without a ``data`` axis decode runs plain, as the reference's does.
The weights stay whole on every rank but the MoE's expert stacks where
they dispatch by all-to-all (``moe``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.common.util import resolve_device
from repro_torch.distributed.sharding import entry_axes, shard
from repro_torch.models import moe, ssm
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (
    ParamDef,
    Schema,
    apply_rope,
    blockwise_attention,
    cp_decode_attention,
    decode_attention,
    init_from_schema,
    load_weight,
    mlp_apply,
    mlp_schema,
    pspecs_from_schema,
    rmsnorm,
    stack_schema,
    tree_from_numpy,
)


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Schemas


def attn_schema(cfg: ModelConfig) -> Schema:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamDef((d, h * hd), ("fsdp", "heads")),
        "wk": ParamDef((d, k * hd), ("fsdp", "kv_heads")),
        "wv": ParamDef((d, k * hd), ("fsdp", "kv_heads")),
        "wo": ParamDef((h * hd, d), ("heads", "fsdp")),
    }


def layer_schema(cfg: ModelConfig, spec: LayerSpec) -> Schema:
    d = cfg.d_model
    s: Schema = {"ln1": ParamDef((d,), (None,), init="zeros")}
    if spec.kind == "attn":
        s["attn"] = attn_schema(cfg)
    else:
        s["mamba"] = ssm.mamba_schema(cfg)
    if cfg.d_ff > 0:
        s["ln2"] = ParamDef((d,), (None,), init="zeros")
        s["mlp"] = (moe.moe_schema(cfg) if spec.mlp_kind == "moe"
                    else mlp_schema(cfg, spec.mlp_kind))
    return s


def model_schema(cfg: ModelConfig) -> Schema:
    d, v = cfg.d_model, cfg.padded_vocab
    period = {f"p{i}": layer_schema(cfg, spec) for i, spec in enumerate(cfg.period())}
    s: Schema = {
        "embed": ParamDef((v, d), ("vocab", None), scale=1.0),
        "final_ln": ParamDef((d,), (None,), init="zeros"),
        "layers": stack_schema(period, cfg.n_periods),
    }
    if not cfg.tie_embeddings:
        s["head"] = ParamDef((d, v), ("fsdp", "vocab"))
    return s


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str | None = None, rules=None) -> Dict[str, Any]:
    """Parameters drawn from `generator` (not the reference's numbers: see
    ``models.layers``), in ``cfg.param_dtype``, on `device` (CUDA unless
    named).  With meshed `rules`, this rank's blocks (``rank_params`` of
    the same draw), the whole tree never held at once."""
    specs, mesh = None, None
    if rules is not None and rules.mesh is not None:
        specs, mesh = rank_param_pspecs(cfg, rules), rules.mesh
    return init_from_schema(generator, model_schema(cfg), dtype_of(cfg.param_dtype),
                            resolve_device(device), specs, mesh)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: torch.device | str | None = None) -> Dict[str, Any]:
    """The reference's params (a nested dict of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them) as tensors on `device`,
    checked against the schema's shapes."""
    return tree_from_numpy(tree, model_schema(cfg), resolve_device(device))


def param_pspecs(cfg: ModelConfig, rules) -> Dict[str, Any]:
    return pspecs_from_schema(model_schema(cfg), rules)


def rank_param_pspecs(cfg: ModelConfig, rules) -> Dict[str, Any]:
    """The specs of the parameters as a rank holds them: the expert stacks
    split over their experts axis where the MoE dispatches by all-to-all
    (``moe.a2a_axis``), every other leaf whole.  Tensor parallelism and
    FSDP, the rest of the reference's layout, wait for ROADMAP A8."""
    axis = moe.a2a_axis(cfg, rules)

    def walk(node):
        if isinstance(node, ParamDef):
            return tuple(axis if (a == "experts" and axis is not None) else None
                         for a in node.axes)
        return {k: walk(v) for k, v in node.items()}

    return walk(model_schema(cfg))


def flat_rank_param_pspecs(cfg: ModelConfig, rules) -> Dict[str, Any]:
    """``rank_param_pspecs`` under ``layers.ParamTree``'s dotted names: the
    ``param_specs`` of a meshed ``train.make_train_step``."""
    out: Dict[str, Any] = {}

    def walk(node, path):
        for k, v in node.items():
            name = f"{path}.{k}" if path else k
            if isinstance(v, dict):
                walk(v, name)
            else:
                out[name] = v

    walk(rank_param_pspecs(cfg, rules), "")
    return out


def rank_params(params: Dict[str, Any], cfg: ModelConfig, rules) -> Dict[str, Any]:
    """This rank's blocks of whole `params` under ``rank_param_pspecs``
    (copies of the split leaves, the other leaves themselves)."""
    specs = rank_param_pspecs(cfg, rules)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if any(spec):
            return shard(node, rules.mesh, spec).clone()
        return node

    return walk(params, specs)


_CAST = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in", "w_out", "head", "embed",
         "zx_proj", "bcdt_proj", "conv_x", "conv_bc", "out_proj")


def cast_weights(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """`params` with one copy of each weight that the forward casts (the
    projections, the MLPs and experts, the mamba projections and convs, the
    head and the embedding) in ``cfg.dtype``; the norms' weights, the
    router and the SSM's ``A_log``, ``D`` and ``dt_bias`` are shared as they
    are, since the reference reads them in their own dtype or in f32."""
    dt = dtype_of(cfg.dtype)

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return node.to(dt) if key in _CAST else node

    return walk(params, None)


def _period(tree: Dict[str, Any], j: int) -> Dict[str, Any]:
    """Period j of a tree stacked over periods (views)."""
    return {k: _period(v, j) if isinstance(v, dict) else v[j] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Layer application


def _mlp_or_moe(p, x, spec, cfg, rules):
    """The layer's MLP or MoE with its residual, and the MoE's aux loss (an
    f32 scalar tensor; the float 0.0 for a dense MLP, which launches
    nothing)."""
    if cfg.d_ff == 0:
        return x, 0.0
    xn = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if spec.mlp_kind == "moe":
        out, aux = moe.moe_apply(p["mlp"], xn, cfg, rules)
        return x + out, aux
    return x + mlp_apply(p["mlp"], xn, spec.mlp_kind, rules), 0.0


def _embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig, rules) -> torch.Tensor:
    dt = dtype_of(cfg.dtype)
    x = params["embed"][tokens].to(dt)
    # sqrt(d_model) rounded to the compute dtype on the host, as the
    # reference casts it (50.596 is 50.5 in bf16): no copy to the device
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt).item()
    return rules.constrain(x, "batch", "seq", "embed")


def _logits_head(params, h: torch.Tensor, cfg: ModelConfig, rules) -> torch.Tensor:
    dt = h.dtype
    if cfg.tie_embeddings:
        w = params["embed"].T.to(dt)
    else:
        w = load_weight(params["head"], rules, None, "vocab", dtype=dt)
    logits = h @ w
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding rows
        valid = torch.arange(cfg.padded_vocab, device=h.device) < cfg.vocab_size
        logits = torch.where(valid, logits, -1e30)
    return rules.constrain(logits, "batch", "seq", "vocab")


def _qkv(p, xn: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, rules):
    """q and k (rotated) and v of one attention layer, (B, S, heads, hd)."""
    b, s, _ = xn.shape
    dt = xn.dtype
    wq = load_weight(p["attn"]["wq"], rules, None, "heads", dtype=dt)
    wk = load_weight(p["attn"]["wk"], rules, None, "kv_heads", dtype=dt)
    wv = load_weight(p["attn"]["wv"], rules, None, "kv_heads", dtype=dt)
    q = apply_rope((xn @ wq).reshape(b, s, cfg.n_heads, cfg.hd), positions, cfg.rope_theta)
    k = apply_rope((xn @ wk).reshape(b, s, cfg.n_kv_heads, cfg.hd), positions, cfg.rope_theta)
    v = (xn @ wv).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    return q, k, v


def _attn_out(p, out: torch.Tensor, cfg: ModelConfig, rules) -> torch.Tensor:
    b, s = out.shape[:2]
    wo = load_weight(p["attn"]["wo"], rules, "heads", None, dtype=out.dtype)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ wo


# ---------------------------------------------------------------------------
# Training forward


def _periods(tree: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The `n` periods of a tree stacked over periods, as `n` trees of views:
    one ``unbind`` a leaf, whose backward stacks the periods' gradients."""
    parts: List[Dict[str, Any]] = [{} for _ in range(n)]
    for k, v in tree.items():
        subs = _periods(v, n) if isinstance(v, dict) else torch.unbind(v, 0)
        for j in range(n):
            parts[j][k] = subs[j]
    return parts


_DOTS = frozenset({torch.ops.aten.mm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(mode: str, fn, *args):
    """``fn(*args)``, under the checkpoint of remat `mode` when a gradient is
    being taken: ``"none"`` saves everything, ``"dots"`` the outputs of
    ``aten.mm`` alone, ``"full"`` nothing (the module says why)."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if mode == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=ctx)
    return checkpoint(fn, *args, use_reentrant=False)


def _attn_apply_train(p, x: torch.Tensor, positions: torch.Tensor, spec: LayerSpec,
                      cfg: ModelConfig, rules,
                      segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
    xn = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p, xn, positions, cfg, rules)
    out = blockwise_attention(q, k, v, pattern=spec.attn_pattern, window=cfg.window,
                              chunk=cfg.chunk_size, causal=True,
                              segment_ids_q=segment_ids, segment_ids_kv=segment_ids)
    return x + rules.constrain(_attn_out(p, out, cfg, rules), "batch", "seq", "embed")


def _period_apply_train(pparams, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                        rules, segment_ids: Optional[torch.Tensor]):
    """One period of the training forward: (x, the period's MoE aux, summed
    layer by layer as the reference does; the float 0.0 without MoE)."""
    aux_total = 0.0
    for i, spec in enumerate(cfg.period()):
        lp = pparams[f"p{i}"]
        if spec.kind == "attn":
            x = _attn_apply_train(lp, x, positions, spec, cfg, rules, segment_ids)
        else:
            xn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
            x = x + ssm.mamba_apply(lp["mamba"], xn, cfg, rules)
        x, aux = _mlp_or_moe(lp, x, spec, cfg, rules)
        aux_total = aux_total + aux
    return x, aux_total


def _backbone(params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, rules,
              segment_ids: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs the layer stack, each period under ``cfg.remat``.  Returns
    (hidden after the final norm, moe_aux as an f32 scalar tensor)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pparams in _periods(params["layers"], cfg.n_periods):
        x, aux_p = remat_call(cfg.remat, _period_apply_train, pparams, x, positions, cfg,
                              rules, segment_ids)
        if not isinstance(aux_p, float):  # a dense period adds 0.0
            aux = aux + aux_p
    return rmsnorm(x, params["final_ln"], cfg.norm_eps), aux


def _xent_block(params, hx: torch.Tensor, lx: torch.Tensor, mx: torch.Tensor,
                cfg: ModelConfig, rules) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = _logits_head(params, hx, cfg, rules).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lx[..., None].to(torch.int64))[..., 0]
    mx = mx.to(torch.float32)
    return ((lse - gold) * mx).sum(), mx.sum()


def chunked_xent(
    params,
    h: torch.Tensor,  # (B, S, d) final hidden
    labels: torch.Tensor,  # (B, S)
    mask: torch.Tensor,  # (B, S) float/bool
    cfg: ModelConfig,
    rules,
    block: int = 1024,
) -> torch.Tensor:
    """Cross-entropy without materializing (B, S, V): a loop over sequence
    blocks (the largest divisor of S up to `block`), f32 logits, each block
    checkpointed (nothing saved) unless ``cfg.remat`` is ``"none"``."""
    b, s, d = h.shape
    block = min(block, s)
    while s % block:  # largest divisor of s not exceeding the target block
        block -= 1
    mode = "none" if cfg.remat == "none" else "full"
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // block):
        sl = slice(i * block, (i + 1) * block)
        nll, m = remat_call(mode, _xent_block, params, h[:, sl], labels[:, sl], mask[:, sl],
                            cfg, rules)
        tot, cnt = tot + nll, cnt + m
    return tot / torch.clamp_min(cnt, 1.0)


def loss_fn(
    params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    rules,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss. batch: tokens (B,S), labels (B,S), mask (B,S);
    optional segment_ids (B,S) and prefix_embeds (B,P,d) for VLM/audio
    frontends (stubbed): the prefix runs ahead of the tokens as segment 0,
    and its positions are sliced off before the loss."""
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg, rules)
    prefix = batch.get("prefix_embeds")
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    seg = batch.get("segment_ids")
    if seg is not None and prefix is not None:
        seg = torch.cat([torch.zeros((b, prefix.shape[1]), dtype=seg.dtype, device=seg.device),
                         seg], dim=1)
    h, aux = _backbone(params, x, positions, cfg, rules, seg)
    if prefix is not None:
        h = h[:, prefix.shape[1]:, :]
    xent = chunked_xent(params, h, batch["labels"], batch["mask"], cfg, rules)
    loss = xent + 0.01 * aux
    return loss, {"loss": loss.detach(), "xent": xent.detach(), "moe_aux": aux.detach()}


# ---------------------------------------------------------------------------
# Serving: cache structure, prefill, decode


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    """Meta tensors of the decode cache tree (the reference's
    ``ShapeDtypeStruct`` tree)."""
    np_, hd, k = cfg.n_periods, cfg.hd, cfg.n_kv_heads
    dt = dtype_of(cfg.dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out: Dict[str, Any] = {}
    for i, spec in enumerate(cfg.period()):
        if spec.kind == "attn":
            shape = (np_, batch, max_seq, k, hd)
            out[f"p{i}"] = {"k": meta(shape, dt), "v": meta(shape, dt)}
        else:
            d_in, h, p, n = ssm.ssm_dims(cfg)
            out[f"p{i}"] = {
                "h": meta((np_, batch, h, p, n), torch.float32),
                "conv": meta((np_, batch, cfg.conv_width - 1, d_in + 2 * n), dt),
            }
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: torch.device | str | None = None) -> Dict[str, Any]:
    device = resolve_device(device)
    return {name: {k: torch.zeros(t.shape, dtype=t.dtype, device=device) for k, t in c.items()}
            for name, c in cache_spec(cfg, batch, max_seq).items()}


def cache_pspecs(cfg: ModelConfig, rules) -> Dict[str, Any]:
    """The specs of the decode cache tree under `rules`."""
    # kv_heads shard over 'model' only when divisible (GQA kv counts are
    # usually smaller than the model axis)
    model_n = rules.mesh.shape.get("model", 1) if rules.mesh else 1
    kv_ax = "kv_heads" if cfg.n_kv_heads % max(model_n, 1) == 0 else None
    out: Dict[str, Any] = {}
    for i, spec in enumerate(cfg.period()):
        if spec.kind == "attn":
            p = rules.pspec("layers", "batch", "kv_seq", kv_ax, None)
            out[f"p{i}"] = {"k": p, "v": p}
        else:
            out[f"p{i}"] = {
                "h": rules.pspec("layers", "batch", "ssm_heads", None, None),
                "conv": rules.pspec("layers", "batch", None, None),
            }
    return out


def _attn_decode(p, x: torch.Tensor, lcache: Dict[str, torch.Tensor], cache_len: int,
                 spec: LayerSpec, cfg: ModelConfig, rules, mesh=None,
                 cp: bool = False) -> torch.Tensor:
    """One attention layer of a decode step; writes the token's k and v at
    `cache_len` of `lcache` (this period's (B, max_seq, K, hd) views, or
    under `cp` this rank's (B, S_local, K, hd) slices: written only where
    the slice holds `cache_len`)."""
    b = x.shape[0]
    xn = rmsnorm(x, p["ln1"], cfg.norm_eps)
    pos = torch.full((b, 1), cache_len, dtype=torch.int32, device=x.device)
    q, kt, vt = _qkv(p, xn, pos, cfg, rules)
    valid = torch.full((b,), cache_len + 1, dtype=torch.int32, device=x.device)
    kw = dict(pattern=spec.attn_pattern, window=cfg.window, chunk=cfg.chunk_size)
    if cp:
        owner, local = divmod(cache_len, lcache["k"].shape[1])
        if mesh.coords["data"] == owner:
            lcache["k"][:, local] = kt[:, 0]
            lcache["v"][:, local] = vt[:, 0]
        out = cp_decode_attention(q, lcache["k"], lcache["v"], valid, mesh=mesh, axis="data",
                                  **kw)
    else:
        lcache["k"][:, cache_len] = kt[:, 0]
        lcache["v"][:, cache_len] = vt[:, 0]
        out = decode_attention(q, lcache["k"], lcache["v"], valid, **kw)
    return x + _attn_out(p, out, cfg, rules)


def decode_step(
    params,
    token: torch.Tensor,  # (B, 1) int32
    caches: Dict[str, Any],
    cache_len,  # int (or a 0-d tensor): tokens already in the cache
    cfg: ModelConfig,
    rules,
    *,
    mesh=None,
    shard_kv_seq: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serve step: next-token logits, and `caches` with the token's k
    and v (attention) or state and conv window (mamba) written in place
    (C11: raises at ``cache_len >= max_seq`` where there is a KV cache).
    With `shard_kv_seq` on a mesh with a ``data`` axis, `caches` hold this
    rank's slices of the sequence and decode is context-parallel (the
    module says how)."""
    period = cfg.period()
    has_attn = any(spec.kind == "attn" for spec in period)
    cp = bool(shard_kv_seq) and mesh is not None and "data" in mesh.axis_names and has_attn
    if cp and rules.mesh is not None and "data" in entry_axes(rules.pspec("batch")[0]):
        raise ValueError("context-parallel decode holds the whole batch on every rank; "
                         "these rules shard it over 'data' (use launch.specs.shape_rules)")
    n = int(cache_len)
    n_slices = mesh.shape["data"] if cp else 1
    for name, c in caches.items():
        if "k" not in c:
            continue
        max_seq = n_slices * c["k"].shape[2]
        if not 0 <= n < max_seq:
            raise ValueError(f"cache_len {n} is outside the cache's {max_seq} positions "
                             f"({name}); the reference would overwrite its last slot")
    h = _embed_tokens(params, token, cfg, rules)
    for j in range(cfg.n_periods):
        pparams = _period(params["layers"], j)
        for i, spec in enumerate(period):
            lp = pparams[f"p{i}"]
            lcache = {k: t[j] for k, t in caches[f"p{i}"].items()}
            if spec.kind == "attn":
                h = _attn_decode(lp, h, lcache, n, spec, cfg, rules, mesh, cp)
            else:
                xn = rmsnorm(h, lp["ln1"], cfg.norm_eps)
                dh, _ = ssm.mamba_decode_step(lp["mamba"], xn, cfg, rules, lcache)
                h = h + dh
            h, _ = _mlp_or_moe(lp, h, spec, cfg, rules)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    return _logits_head(params, h, cfg, rules), caches


def prefill_hidden(
    params,
    tokens: torch.Tensor,  # (B, S)
    cfg: ModelConfig,
    rules,
    max_seq: int,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The full forward of ``prefill``: the final-normed hidden state of
    every position (B, S, d), and the caches filled up to S."""
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of {max_seq}")
    h = _embed_tokens(params, tokens, cfg, rules)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    caches = init_cache(cfg, b, max_seq, tokens.device)
    for j in range(cfg.n_periods):
        pparams = _period(params["layers"], j)
        for i, spec in enumerate(cfg.period()):
            lp = pparams[f"p{i}"]
            lcache = caches[f"p{i}"]
            xn = rmsnorm(h, lp["ln1"], cfg.norm_eps)
            if spec.kind == "attn":
                q, kk, vv = _qkv(lp, xn, positions, cfg, rules)
                out = blockwise_attention(q, kk, vv, pattern=spec.attn_pattern,
                                          window=cfg.window, chunk=cfg.chunk_size, causal=True)
                h = h + _attn_out(lp, out, cfg, rules)
                lcache["k"][j, :, :s] = kk
                lcache["v"][j, :, :s] = vv
            else:
                dh, h_t, conv = ssm.mamba_forward(lp["mamba"], xn, cfg, rules)
                h = h + dh
                lcache["h"][j] = h_t
                lcache["conv"][j] = conv
            del xn
            h, _ = _mlp_or_moe(lp, h, spec, cfg, rules)
    return rmsnorm(h, params["final_ln"], cfg.norm_eps), caches


def prefill(
    params,
    tokens: torch.Tensor,  # (B, S)
    cfg: ModelConfig,
    rules,
    max_seq: int,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full forward that fills caches up to S; returns last-position logits
    (B, 1, V).  Cache tensors are allocated at max_seq; positions [0, S)
    are written."""
    h, caches = prefill_hidden(params, tokens, cfg, rules, max_seq)
    return _logits_head(params, h[:, -1:, :], cfg, rules), caches
