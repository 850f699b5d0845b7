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

The layout on a mesh is the reference's GSPMD layout, run as one program
a rank (``launch.mesh``): every parameter is the rank's block under
``param_pspecs`` (``rank_params``, ``init_params(..., rules=)``), the
activations are the rank's rows of the batch, whole along ``embed``.
``load_weight`` gathers each weight's FSDP axes; the tensor-parallel axes
stay split, and the layers run on their blocks with explicit collectives
(``layers.tp_copy`` at the input of a column-parallel product,
``layers.tp_sum`` after a row-parallel one):

* attention runs on the rank's heads (``heads -> model``).  Where the kv
  heads do not divide the heads' axis, the kv projections are gathered
  whole (the reference's ``_kv_axis`` replicates them) and each rank
  attends with the kv heads of its own q heads;
* the embedding table is split over ``vocab``: a rank looks up the ids of
  its rows, zeros the others, and the lookups are summed;
* the head's logits are the rank's vocab block (``gather_logits`` puts
  them together); ``chunked_xent`` takes its logsumexp through a ``pmax``
  and a ``psum`` and the gold logit from the rank that holds it;
* the MLP, the mamba block (``ssm``) and the MoE (``moe``) are column- then
  row-parallel over ``ff`` or ``experts``.

Decode reads the caches' layout from ``cache_pspecs``: the rank's heads
where ``kv_heads`` splits them, the rank's slice of the sequence where
``kv_seq`` maps to a mesh axis.  Context-parallel decode (``shard_kv_seq``
on a mesh with a ``data`` axis, ``long_500k``'s rules) gives each rank its
contiguous slice of the sequence over ``data`` and the whole batch; under
the other decode shapes' rules (``kv_seq -> model``) the slice is over
``model``, the axis that also splits the heads, so q's heads are gathered
over ``model`` (one token's), the partial softmaxes combine over it
(``layers.cp_decode_attention``) and each rank keeps its heads for ``wo``.
Either way the new token's k and v are written only by the rank whose
slice holds position ``cache_len``, at the local index, and C11 checks
``cache_len`` against the global length.  ``prefill`` fills caches whose
sequence is whole; ``reshard_caches`` moves them to a decode shape's
layout (an all-gather of the kv heads over ``model``, then the rank's
slice of the sequence).  On a mesh without a ``data`` axis and with
``kv_seq`` unmapped decode runs plain, as the reference's does.
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

from repro_torch.common.util import ShapeDtype, resolve_device
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import block_shape, entry_axes, reshard, shard, spec_size
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
    live_axes,
    load_weight,
    mlp_apply,
    mlp_schema,
    pspecs_from_schema,
    rmsnorm,
    stack_schema,
    tp_axes,
    tp_copy,
    tp_gather,
    tp_index,
    tp_size,
    tp_sum,
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
        specs, mesh = param_pspecs(cfg, rules), rules.mesh
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


def flat_rank_param_pspecs(cfg: ModelConfig, rules) -> Dict[str, Any]:
    """``param_pspecs`` under ``layers.ParamTree``'s dotted names: the
    ``param_specs`` of a meshed ``train.make_train_step``."""
    out: Dict[str, Any] = {}

    def walk(node, path):
        for k, v in node.items():
            name = f"{path}.{k}" if path else k
            if isinstance(v, dict):
                walk(v, name)
            else:
                out[name] = v

    walk(param_pspecs(cfg, rules), "")
    return out


def rank_params(params: Dict[str, Any], cfg: ModelConfig, rules) -> Dict[str, Any]:
    """This rank's blocks of whole `params` under ``param_pspecs``
    (copies of the split leaves, the other leaves themselves)."""
    specs = param_pspecs(cfg, rules)

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


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dt: torch.dtype,
                 rules) -> torch.Tensor:
    """The rows of `tokens` in `dt`.  Where ``vocab`` splits the table, the
    rank looks up the ids of its rows, zeros the others, and the lookups
    are summed over the split."""
    if not tp_axes(rules, "vocab"):
        return table[tokens].to(dt)
    rows = table.shape[0]
    local = tokens.to(torch.int64) - tp_index(rules, "vocab") * rows
    inside = (local >= 0) & (local < rows)
    x = torch.where(inside[..., None], table[local.clamp(0, rows - 1)].to(dt), 0.0)
    return tp_sum(x, rules, "vocab")


def _embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig, rules) -> torch.Tensor:
    dt = dtype_of(cfg.dtype)
    x = embed_lookup(params["embed"], tokens, dt, rules)
    # sqrt(d_model) rounded to the compute dtype on the host, as the
    # reference casts it (50.596 is 50.5 in bf16): no copy to the device
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt).item()
    return rules.constrain(x, "batch", "seq", "embed")


def _logits_head(params, h: torch.Tensor, cfg: ModelConfig, rules) -> torch.Tensor:
    """The logits of `h`: on a mesh the rank's block of the (padded) vocab."""
    dt = h.dtype
    h = tp_copy(h, rules, "vocab")
    if cfg.tie_embeddings:
        w = params["embed"].T.to(dt)
    else:
        w = load_weight(params["head"], rules, None, "vocab", dtype=dt)
    logits = h @ w
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding rows
        cols = torch.arange(w.shape[1], device=h.device) + tp_index(rules, "vocab") * w.shape[1]
        logits = torch.where(cols < cfg.vocab_size, logits, -1e30)
    return rules.constrain(logits, "batch", "seq", "vocab")


def gather_logits(logits: torch.Tensor, rules) -> torch.Tensor:
    """The whole vocab from the ranks' blocks of ``_logits_head``'s logits
    (no copy without a split vocab)."""
    return tp_gather(logits, rules, "vocab", logits.dim() - 1)


def _head_split(cfg: ModelConfig, rules) -> Tuple[int, int]:
    """(blocks, this rank's block) of the attention heads."""
    n = tp_size(rules, "heads")
    if cfg.n_heads % n:
        raise ValueError(f"{cfg.n_heads} heads do not split into {n} blocks")
    if tp_axes(rules, "kv_heads") not in ((), tp_axes(rules, "heads")):
        raise ValueError("kv_heads must split over the heads' mesh axes or none")
    return n, tp_index(rules, "heads")


def _head_range(cfg: ModelConfig, rules) -> Tuple[int, int]:
    """This rank's q heads [lo, hi): its block of the heads, or, where the
    heads' mesh axes do not divide them (llama4's 40 heads over 16 ranks),
    rank r of n runs heads [r H // n, (r + 1) H // n), whose weights it
    cuts from the gathered whole (``_uneven_block``)."""
    n = tp_size(rules, "heads")
    if tp_axes(rules, "kv_heads") not in ((), tp_axes(rules, "heads")):
        raise ValueError("kv_heads must split over the heads' mesh axes or none")
    if cfg.n_heads < n:
        raise ValueError(f"{cfg.n_heads} heads do not split into {n} blocks: a rank would "
                         f"hold none")
    r = tp_index(rules, "heads")
    return r * cfg.n_heads // n, (r + 1) * cfg.n_heads // n


def _uneven_block(w: torch.Tensor, cfg: ModelConfig, rules, dim: int) -> torch.Tensor:
    """The rank's heads' part of a heads-split weight's block `w` (axis
    `dim` of hd-wide heads): the block itself where the heads divide their
    axes; else the whole axis gathered and cut to ``_head_range``.  Each
    rank's gradient then reaches its own heads' part alone, and the
    gather's backward sums the parts."""
    if cfg.n_heads % tp_size(rules, "heads") == 0:
        return w
    lo, hi = _head_range(cfg, rules)
    return tp_gather(w, rules, "heads", dim).narrow(dim, lo * cfg.hd, (hi - lo) * cfg.hd)


def _kv_split(cfg: ModelConfig, rules) -> bool:
    """Whether the kv projections stay split over the heads' axes (the
    reference's ``_kv_axis``: only where the kv heads divide the axis)."""
    return cfg.n_kv_heads % max(rules.axis_size("kv_heads"), 1) == 0


def _qkv(p, xn: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, rules):
    """q and k (rotated) and v of one attention layer, (B, S, heads, hd):
    the rank's q heads; its kv heads, or every kv head where they do not
    divide the heads' axis (``_kv_split``)."""
    b, s, _ = xn.shape
    dt = xn.dtype
    lo, hi = _head_range(cfg, rules)
    xn = tp_copy(xn, rules, "heads")
    wq = _uneven_block(load_weight(p["attn"]["wq"], rules, None, "heads", dtype=dt), cfg,
                       rules, 1)
    wk = load_weight(p["attn"]["wk"], rules, None, "kv_heads", dtype=dt)
    wv = load_weight(p["attn"]["wv"], rules, None, "kv_heads", dtype=dt)
    if not _kv_split(cfg, rules):
        wk, wv = tp_gather(wk, rules, "kv_heads", 1), tp_gather(wv, rules, "kv_heads", 1)
    hl, kl = hi - lo, wk.shape[1] // cfg.hd
    q = apply_rope((xn @ wq).reshape(b, s, hl, cfg.hd), positions, cfg.rope_theta)
    k = apply_rope((xn @ wk).reshape(b, s, kl, cfg.hd), positions, cfg.rope_theta)
    v = (xn @ wv).reshape(b, s, kl, cfg.hd)
    return q, k, v


def _kv_for_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig, rules):
    """The kv heads (B, S, K', hd) that this rank's q heads attend with:
    `k` and `v` themselves where they are the rank's block; where every kv
    head is held (``_kv_split`` false on a split mesh), the heads of the
    rank's q heads' groups."""
    lo, hi = _head_range(cfg, rules)
    if tp_size(rules, "heads") == 1 or _kv_split(cfg, rules):
        return k, v
    g = cfg.n_heads // cfg.n_kv_heads
    k_lo, k_hi = lo // g, (hi - 1) // g + 1
    kl = k_hi - k_lo
    # the attention groups the rank's q heads evenly over its kv heads
    if (hi - lo) % kl or any((lo + j) // g - k_lo != j // ((hi - lo) // kl)
                             for j in range(hi - lo)):
        raise ValueError(f"q heads [{lo}, {hi}) straddle kv groups of {g}")
    return k[:, :, k_lo:k_hi], v[:, :, k_lo:k_hi]


def _attn_out(p, out: torch.Tensor, cfg: ModelConfig, rules) -> torch.Tensor:
    """The output projection of the rank's heads (B, S, heads, hd), summed
    over the heads' axes."""
    b, s = out.shape[:2]
    wo = _uneven_block(load_weight(p["attn"]["wo"], rules, "heads", None, dtype=out.dtype),
                       cfg, rules, 0)
    return tp_sum(out.reshape(b, s, out.shape[2] * cfg.hd) @ wo, rules, "heads")


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
    k, v = _kv_for_heads(k, v, cfg, rules)
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
    mx = mx.to(torch.float32)
    axes = tp_axes(rules, "vocab")
    if not axes:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lx[..., None].to(torch.int64))[..., 0]
        return ((lse - gold) * mx).sum(), mx.sum()
    # the rank's vocab block: the max over the ranks (no gradient: it
    # cancels), the sum of exponentials over them, the gold logit from the
    # rank that holds the label
    m = logits.detach().amax(dim=-1)
    for a in axes:
        m = comm.pmax(m, rules.mesh, a)
    lse = m + torch.log(tp_sum(torch.exp(logits - m[..., None]).sum(dim=-1), rules, "vocab"))
    vl = logits.shape[-1]
    local = lx.to(torch.int64) - tp_index(rules, "vocab") * vl
    inside = (local >= 0) & (local < vl)
    gold = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    gold = tp_sum(torch.where(inside, gold, 0.0), rules, "vocab")
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
    """``ShapeDtype`` records of the decode cache tree (the reference's
    ``ShapeDtypeStruct`` tree)."""
    np_, hd, k = cfg.n_periods, cfg.hd, cfg.n_kv_heads
    dt = dtype_of(cfg.dtype)
    out: Dict[str, Any] = {}
    for i, spec in enumerate(cfg.period()):
        if spec.kind == "attn":
            shape = (np_, batch, max_seq, k, hd)
            out[f"p{i}"] = {"k": ShapeDtype(shape, dt), "v": ShapeDtype(shape, dt)}
        else:
            d_in, h, p, n = ssm.ssm_dims(cfg)
            out[f"p{i}"] = {
                "h": ShapeDtype((np_, batch, h, p, n), torch.float32),
                "conv": ShapeDtype((np_, batch, cfg.conv_width - 1, d_in + 2 * n), dt),
            }
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: torch.device | str | None = None, rules=None) -> Dict[str, Any]:
    """Zeroed caches of `batch` rows.  With meshed `rules`, `batch` is the
    rank's rows and each leaf is the rank's block under ``cache_pspecs``."""
    device = resolve_device(device)
    shapes = cache_block_shapes(cfg, batch, max_seq, rules)
    return {name: {k: torch.zeros(shape, dtype=dt, device=device) for k, (shape, dt) in c.items()}
            for name, c in shapes.items()}


def cache_block_shapes(cfg: ModelConfig, batch: int, max_seq: int, rules=None, *,
                       spec_fn=None, pspec_fn=None) -> Dict[str, Any]:
    """(shape, dtype) of each cache leaf as this rank holds it: `batch` is
    the rank's rows; `spec_fn` and `pspec_fn` are a model's ``cache_spec``
    and ``cache_pspecs`` (this module's by default)."""
    spec_fn, pspec_fn = spec_fn or cache_spec, pspec_fn or cache_pspecs
    mesh = None if rules is None else rules.mesh
    n_batch = 1 if mesh is None else spec_size(mesh, rules.pspec("batch")[0])
    specs = None if mesh is None else pspec_fn(cfg, rules)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, None if spec is None else spec[k]) for k, v in node.items()}
        shape = tuple(node.shape) if spec is None else block_shape(node.shape, mesh, spec)
        return shape, node.dtype

    return walk(spec_fn(cfg, batch * n_batch, max_seq), specs)


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


def reshard_caches(caches: Dict[str, Any], cfg: ModelConfig, src_rules, dst_rules, *,
                   pspec_fn=None) -> Dict[str, Any]:
    """The rank's caches under `dst_rules`' ``cache_pspecs`` from its
    caches under `src_rules`' (say a prefill shape's and a decode shape's
    rules over one mesh): each leaf gathered over the mesh axes whose
    place changes, then cut to the rank's block (``sharding.reshard``).
    From the prefill rules to ``decode_32k``'s that is an all-gather of
    the attention caches' kv heads over ``model`` (where they were split)
    and this rank's slice of the sequence; the SSM caches keep their
    layout and move nothing.  `pspec_fn` is the model's ``cache_pspecs``
    (this module's by default)."""
    pspec_fn = pspec_fn or cache_pspecs
    src, dst = pspec_fn(cfg, src_rules), pspec_fn(cfg, dst_rules)
    mesh = dst_rules.mesh

    def walk(node, a, b):
        if isinstance(node, dict):
            return {k: walk(v, a[k], b[k]) for k, v in node.items()}
        return reshard(node, mesh, a, b)

    return walk(caches, src, dst)


def decode_attend(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, valid: torch.Tensor,
                  cfg: ModelConfig, rules, mesh, cp_axis: Optional[str], **kw) -> torch.Tensor:
    """One token's attention of the rank's q heads (B, 1, heads, hd) over
    the rank's caches (B, S, K', hd): plain, or context-parallel over
    `cp_axis` (the caches then hold the rank's slice of the sequence).
    Where `cp_axis` also splits the heads, the caches hold every kv head:
    q's heads are gathered over it and each rank keeps its own from the
    combined result."""
    if cp_axis is None:
        kc, vc = _kv_for_heads(kc, vc, cfg, rules)
        return decode_attention(q, kc, vc, valid, **kw)
    heads_on_axis = cp_axis in tp_axes(rules, "heads")
    if not heads_on_axis:
        kc, vc = _kv_for_heads(kc, vc, cfg, rules)
        return cp_decode_attention(q, kc, vc, valid, mesh=mesh, axis=cp_axis, **kw)
    if tp_axes(rules, "heads") != (cp_axis,):
        raise ValueError(f"heads split over {tp_axes(rules, 'heads')}, the sequence over "
                         f"{cp_axis}")
    lo, hi = _head_range(cfg, rules)
    out = cp_decode_attention(_gather_heads(q, cfg, rules), kc, vc, valid, mesh=mesh,
                              axis=cp_axis, **kw)
    return out[:, :, lo:hi]


def _gather_heads(q: torch.Tensor, cfg: ModelConfig, rules) -> torch.Tensor:
    """Every q head (B, 1, H, hd) from the ranks' ``_head_range``s: where
    the ranges are uneven each is padded to the longest before the gather
    and the padding dropped after (a decode step: no backward)."""
    n = tp_size(rules, "heads")
    if cfg.n_heads % n == 0:
        return tp_gather(q, rules, "heads", 2)
    m = -(-cfg.n_heads // n)
    pad = torch.zeros(*q.shape[:2], m - q.shape[2], q.shape[3], dtype=q.dtype, device=q.device)
    whole = tp_gather(torch.cat([q, pad], dim=2), rules, "heads", 2)
    keep = [r * m + j for r in range(n)
            for j in range((r + 1) * cfg.n_heads // n - r * cfg.n_heads // n)]
    return whole.index_select(2, torch.tensor(keep, device=q.device))


def write_token_kv(lcache: Dict[str, torch.Tensor], kt: torch.Tensor, vt: torch.Tensor,
                   cache_len: int, cfg: ModelConfig, rules, mesh,
                   cp_axis: Optional[str]) -> None:
    """Write the token's k and v (B, 1, K', hd) at `cache_len` of the
    rank's caches (B, S, K'', hd): at the local index on the rank whose
    slice holds it under `cp_axis`, after gathering the kv heads where the
    caches hold every head and the projections gave the rank's block."""
    if cp_axis is not None and lcache["k"].shape[2] != kt.shape[2]:
        kt, vt = tp_gather(kt, rules, "kv_heads", 2), tp_gather(vt, rules, "kv_heads", 2)
    owner, local = (0, cache_len) if cp_axis is None else divmod(cache_len, lcache["k"].shape[1])
    if cp_axis is None or mesh.coords[cp_axis] == owner:
        lcache["k"][:, local] = kt[:, 0]
        lcache["v"][:, local] = vt[:, 0]


def _attn_decode(p, x: torch.Tensor, lcache: Dict[str, torch.Tensor], cache_len: int,
                 spec: LayerSpec, cfg: ModelConfig, rules, mesh=None,
                 cp_axis: Optional[str] = None) -> torch.Tensor:
    """One attention layer of a decode step; writes the token's k and v at
    `cache_len` of `lcache` (this period's (B, max_seq, K, hd) views, or
    under `cp_axis` this rank's (B, S_local, K', hd) slices: written only
    where the slice holds `cache_len`)."""
    b = x.shape[0]
    xn = rmsnorm(x, p["ln1"], cfg.norm_eps)
    pos = torch.full((b, 1), cache_len, dtype=torch.int32, device=x.device)
    q, kt, vt = _qkv(p, xn, pos, cfg, rules)
    valid = torch.full((b,), cache_len + 1, dtype=torch.int32, device=x.device)
    write_token_kv(lcache, kt, vt, cache_len, cfg, rules, mesh, cp_axis)
    out = decode_attend(q, lcache["k"], lcache["v"], valid, cfg, rules, mesh, cp_axis,
                        pattern=spec.attn_pattern, window=cfg.window, chunk=cfg.chunk_size)
    return x + _attn_out(p, out, cfg, rules)


def cp_axis_of(rules, mesh, shard_kv_seq: bool, has_attn: bool) -> Optional[str]:
    """The mesh axis that splits the caches' sequence in decode: ``data``
    for context-parallel decode (`shard_kv_seq` on a mesh with a ``data``
    axis), else the axis ``kv_seq`` maps to under `rules` if it has more
    than one rank, else None."""
    if not has_attn:
        return None
    if shard_kv_seq and mesh is not None and "data" in mesh.axis_names:
        return "data"
    seq = live_axes(rules, rules.pspec("kv_seq")[0])
    if len(seq) > 1:
        raise ValueError(f"the caches' sequence splits over {seq}: decode takes one axis")
    return seq[0] if seq else None


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
    With `shard_kv_seq` on a mesh with a ``data`` axis, or rules that map
    ``kv_seq`` to a mesh axis, `caches` hold this rank's slices of the
    sequence and decode is context-parallel (the module says how).  On a
    mesh the logits are the rank's vocab block (``gather_logits``)."""
    period = cfg.period()
    has_attn = any(spec.kind == "attn" for spec in period)
    mesh = rules.mesh if mesh is None else mesh
    cp_axis = cp_axis_of(rules, mesh, bool(shard_kv_seq), has_attn)
    if (cp_axis == "data" and rules.mesh is not None
            and "data" in entry_axes(rules.pspec("batch")[0])):
        raise ValueError("context-parallel decode holds the whole batch on every rank; "
                         "these rules shard it over 'data' (use launch.specs.shape_rules)")
    n = int(cache_len)
    n_slices = 1 if cp_axis is None else mesh.shape[cp_axis]
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
                h = _attn_decode(lp, h, lcache, n, spec, cfg, rules, mesh, cp_axis)
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
    if rules.mesh is not None and live_axes(rules, rules.pspec("kv_seq")[0]):
        raise ValueError("prefill fills caches whose sequence is whole: prefill under rules "
                         "with kv_seq unmapped, then reshard_caches")
    h = _embed_tokens(params, tokens, cfg, rules)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    caches = init_cache(cfg, b, max_seq, tokens.device, rules)
    for j in range(cfg.n_periods):
        pparams = _period(params["layers"], j)
        for i, spec in enumerate(cfg.period()):
            lp = pparams[f"p{i}"]
            lcache = caches[f"p{i}"]
            xn = rmsnorm(h, lp["ln1"], cfg.norm_eps)
            if spec.kind == "attn":
                q, kk, vv = _qkv(lp, xn, positions, cfg, rules)
                lcache["k"][j, :, :s] = kk
                lcache["v"][j, :, :s] = vv
                kk, vv = _kv_for_heads(kk, vv, cfg, rules)
                out = blockwise_attention(q, kk, vv, pattern=spec.attn_pattern,
                                          window=cfg.window, chunk=cfg.chunk_size, causal=True)
                h = h + _attn_out(lp, out, cfg, rules)
            else:
                dh, h_t, conv = ssm.mamba_forward(lp["mamba"], xn, cfg, rules)
                h = h + dh
                lcache["h"][j] = h_t
                lcache["conv"][j] = ssm.whole_window(conv, cfg, rules)
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
    (B, 1, V; on a mesh the rank's rows and vocab block, and the caches the
    rank's blocks under ``cache_pspecs``).  Cache tensors are allocated at max_seq; positions [0, S)
    are written."""
    h, caches = prefill_hidden(params, tokens, cfg, rules, max_seq)
    return _logits_head(params, h[:, -1:, :], cfg, rules), caches
