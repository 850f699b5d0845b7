"""Encoder-decoder transformer (the seamless-m4t backbone): the port of
``repro.models.encdec``, training (``loss_fn``) and serving.

The audio/text modality frontend is a stub: the encoder consumes
precomputed frame embeddings (B, S_enc, d).  The decoder is causal
self-attention, cross-attention to the encoder output, and an MLP.  Serving
caches: the decoder's self-attention K/V and the cross-attention K/V
computed once from the encoder output (``cross_caches``).

Where the port differs, and why:

* ``decode_step`` writes the token's self-attention k and v into `caches`
  in place and returns the same dict; writing at ``cache_len >= max_seq``
  raises ``ValueError`` on the host where the reference clamps onto the
  last slot (ROADMAP C11, as ``transformer.decode_step``);
* ``cross_caches`` builds the cross K/V one decoder layer at a time (the
  reference's ``examples/serve_lm.py`` maps over the stacked layers).

On a mesh the layout is the decoder-only model's (``transformer``): the
attention of the rank's heads in every encoder, decoder and cross
attention, column- then row-parallel MLPs, the vocab-split embedding and
head, and the caches under ``cache_pspecs``: the cross K/V too take the
rank's heads, or its slice of the encoder's sequence where ``kv_seq``
maps to ``model`` (decode then combines over it, as
``transformer.decode_attend`` does).

Under ``cfg.remat`` other than ``"none"`` the reference checkpoints every
encoder and decoder layer with a plain ``jax.checkpoint`` (nothing saved),
whatever the policy's name; so does the port, with
``transformer.remat_call("full", ...)`` when a gradient is taken.
Decode never takes the ``data`` axis's context-parallel path, as the
reference's does not.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.common.util import ShapeDtype, resolve_device
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ParamDef,
    Schema,
    apply_rope,
    blockwise_attention,
    init_from_schema,
    live_axes,
    load_weight,
    tp_copy,
    tp_gather,
    mlp_apply,
    mlp_schema,
    pspecs_from_schema,
    rmsnorm,
    stack_schema,
    tree_from_numpy,
)
from repro_torch.models.transformer import (
    _attn_out,
    _head_split,
    _kv_for_heads,
    _kv_split,
    _logits_head,
    _period,
    _periods,
    attn_schema,
    cache_block_shapes,
    chunked_xent,
    cp_axis_of,
    decode_attend,
    dtype_of,
    embed_lookup,
    remat_call,
    write_token_kv,
)


def _xattn_schema(cfg: ModelConfig) -> Schema:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamDef((d, h * hd), ("fsdp", "heads")),
        "wk": ParamDef((d, k * hd), ("fsdp", "kv_heads")),
        "wv": ParamDef((d, k * hd), ("fsdp", "kv_heads")),
        "wo": ParamDef((h * hd, d), ("heads", "fsdp")),
    }


def enc_layer_schema(cfg: ModelConfig) -> Schema:
    d = cfg.d_model
    return {
        "ln1": ParamDef((d,), (None,), init="zeros"),
        "attn": attn_schema(cfg),
        "ln2": ParamDef((d,), (None,), init="zeros"),
        "mlp": mlp_schema(cfg, cfg.mlp_kind),
    }


def dec_layer_schema(cfg: ModelConfig) -> Schema:
    d = cfg.d_model
    return {
        "ln1": ParamDef((d,), (None,), init="zeros"),
        "attn": attn_schema(cfg),
        "lnx": ParamDef((d,), (None,), init="zeros"),
        "xattn": _xattn_schema(cfg),
        "ln2": ParamDef((d,), (None,), init="zeros"),
        "mlp": mlp_schema(cfg, cfg.mlp_kind),
    }


def model_schema(cfg: ModelConfig) -> Schema:
    d, v = cfg.d_model, cfg.padded_vocab
    return {
        "embed": ParamDef((v, d), ("vocab", None), scale=1.0),
        "enc_layers": stack_schema(enc_layer_schema(cfg), cfg.enc_layers),
        "enc_ln": ParamDef((d,), (None,), init="zeros"),
        "dec_layers": stack_schema(dec_layer_schema(cfg), cfg.n_layers),
        "final_ln": ParamDef((d,), (None,), init="zeros"),
        "head": ParamDef((d, v), ("fsdp", "vocab")),
    }


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str | None = None) -> Dict[str, Any]:
    """Parameters drawn from `generator` (not the reference's numbers), in
    ``cfg.param_dtype``, on `device` (CUDA unless named)."""
    return init_from_schema(generator, model_schema(cfg), dtype_of(cfg.param_dtype),
                            resolve_device(device))


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: torch.device | str | None = None) -> Dict[str, Any]:
    """The reference's enc-dec params (a nested dict of numpy arrays) as
    tensors on `device`, checked against the schema's shapes."""
    return tree_from_numpy(tree, model_schema(cfg), resolve_device(device))


def param_pspecs(cfg: ModelConfig, rules) -> Dict[str, Any]:
    return pspecs_from_schema(model_schema(cfg), rules)


def _kv_proj(p, xkv: torch.Tensor, cfg: ModelConfig, rules):
    """k and v (B, S, K', hd) of `xkv` (already through ``tp_copy``): the
    rank's kv heads, or every kv head where they do not divide the heads'
    axis."""
    b, skv, _ = xkv.shape
    dt = xkv.dtype
    wk = load_weight(p["wk"], rules, None, "kv_heads", dtype=dt)
    wv = load_weight(p["wv"], rules, None, "kv_heads", dtype=dt)
    if not _kv_split(cfg, rules):
        wk, wv = tp_gather(wk, rules, "kv_heads", 1), tp_gather(wv, rules, "kv_heads", 1)
    kl = wk.shape[1] // cfg.hd
    return (xkv @ wk).reshape(b, skv, kl, cfg.hd), (xkv @ wv).reshape(b, skv, kl, cfg.hd)


def _mha(p, xq, xkv, positions_q, positions_kv, cfg, rules, causal) -> torch.Tensor:
    """Attention of the rank's heads of `xq` over `xkv`, its output
    projection summed over the heads' axes."""
    b, sq, _ = xq.shape
    n, _ = _head_split(cfg, rules)
    hd = cfg.hd
    dt = xq.dtype
    same = xkv is xq
    xq = tp_copy(xq, rules, "heads")
    xkv = xq if same else tp_copy(xkv, rules, "heads")
    wq = load_weight(p["wq"], rules, None, "heads", dtype=dt)
    q = rules.constrain(xq @ wq, "batch", "seq", "heads").reshape(b, sq, cfg.n_heads // n, hd)
    kk, vv = _kv_proj(p, xkv, cfg, rules)
    if positions_q is not None:
        q = apply_rope(q, positions_q, cfg.rope_theta)
        kk = apply_rope(kk, positions_kv, cfg.rope_theta)
    kk, vv = _kv_for_heads(kk, vv, cfg, rules)
    out = blockwise_attention(q, kk, vv, causal=causal)
    return _attn_out({"attn": p}, out, cfg, rules)


def _remat(cfg: ModelConfig) -> str:
    return "none" if cfg.remat == "none" else "full"


def _enc_layer(lp, h, pos, cfg: ModelConfig, rules) -> torch.Tensor:
    xn = rmsnorm(h, lp["ln1"], cfg.norm_eps)
    h = h + _mha(lp["attn"], xn, xn, pos, pos, cfg, rules, False)
    return h + mlp_apply(lp["mlp"], rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg.mlp_kind, rules)


def _dec_layer(lp, h, enc_out, pos, cfg: ModelConfig, rules) -> torch.Tensor:
    xn = rmsnorm(h, lp["ln1"], cfg.norm_eps)
    h = h + _mha(lp["attn"], xn, xn, pos, pos, cfg, rules, True)
    h = h + _mha(lp["xattn"], rmsnorm(h, lp["lnx"], cfg.norm_eps), enc_out, None, None, cfg,
                 rules, False)
    return h + mlp_apply(lp["mlp"], rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg.mlp_kind, rules)


def encode(params, frames: torch.Tensor, cfg: ModelConfig, rules) -> torch.Tensor:
    """frames (B, S_enc, d) stub embeddings -> encoder hidden states."""
    b, s, _ = frames.shape
    pos = torch.arange(s, device=frames.device).expand(b, s)
    h = rules.constrain(frames.to(dtype_of(cfg.dtype)), "batch", "seq", "embed")
    for lp in _periods(params["enc_layers"], cfg.enc_layers):
        h = remat_call(_remat(cfg), _enc_layer, lp, h, pos, cfg, rules)
    return rmsnorm(h, params["enc_ln"], cfg.norm_eps)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            rules) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: frames (B, S_enc, d), tokens (B, S_dec), labels, mask.
    Returns (xent, {loss, xent})."""
    enc_out = encode(params, batch["frames"], cfg, rules)
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = embed_lookup(params["embed"], tokens, dtype_of(cfg.dtype), rules)
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    for lp in _periods(params["dec_layers"], cfg.n_layers):
        h = remat_call(_remat(cfg), _dec_layer, lp, h, enc_out, pos, cfg, rules)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    xent = chunked_xent(params, h, batch["labels"], batch["mask"], cfg, rules)
    return xent, {"loss": xent.detach(), "xent": xent.detach()}


# -- serving -----------------------------------------------------------------


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    """``ShapeDtype`` records of the decode cache (the reference's
    ``ShapeDtypeStruct`` dict)."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dt = dtype_of(cfg.dtype)
    return {name: ShapeDtype(shape, dt) for name in ("self_k", "self_v", "cross_k", "cross_v")}


def cache_pspecs(cfg: ModelConfig, rules) -> Dict[str, Any]:
    """The specs of the decode cache dict under `rules`."""
    model_n = rules.mesh.shape.get("model", 1) if rules.mesh else 1
    kv_ax = "kv_heads" if cfg.n_kv_heads % max(model_n, 1) == 0 else None
    p = rules.pspec("layers", "batch", "kv_seq", kv_ax, None)
    return {"self_k": p, "self_v": p, "cross_k": p, "cross_v": p}


def cross_caches(params, enc_out: torch.Tensor, cfg: ModelConfig, max_seq: int,
                 rules=None) -> Dict[str, torch.Tensor]:
    """The decode caches for `enc_out` (B, S_enc, d): the cross K/V of
    every decoder layer, (n_layers, B, S_enc, K, hd), and zeroed
    self-attention K/V of `max_seq` positions.  With meshed `rules` the
    rank's blocks under ``cache_pspecs`` (`enc_out` the rank's rows; the
    rules must leave ``kv_seq`` unmapped: ``transformer.reshard_caches``
    moves the caches to a decode shape's layout)."""
    b, s, _ = enc_out.shape
    dt = enc_out.dtype
    rules = rules or ShardingRules.make(None)
    if live_axes(rules, rules.pspec("kv_seq")[0]):
        raise ValueError("cross_caches fills caches whose sequence is whole: build them "
                         "under rules with kv_seq unmapped, then reshard_caches")
    shapes = cache_block_shapes(cfg, b, max_seq, rules, spec_fn=cache_spec,
                                pspec_fn=cache_pspecs)
    xkv = tp_copy(enc_out, rules, "heads")
    cross = shapes["cross_k"][0][:2] + (s,) + shapes["cross_k"][0][3:]
    ck = torch.empty(cross, dtype=dt, device=enc_out.device)
    cv = torch.empty(cross, dtype=dt, device=enc_out.device)
    for j in range(cfg.n_layers):
        xp = _period(params["dec_layers"]["xattn"], j)
        ck[j], cv[j] = _kv_proj(xp, xkv, cfg, rules)
    return {"self_k": torch.zeros(shapes["self_k"][0], dtype=dt, device=enc_out.device),
            "self_v": torch.zeros(shapes["self_v"][0], dtype=dt, device=enc_out.device),
            "cross_k": ck, "cross_v": cv}


def decode_step(params, token: torch.Tensor, caches: Dict[str, torch.Tensor], cache_len,
                cfg: ModelConfig, rules, *, mesh=None,
                shard_kv_seq: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder token against the self- and cross-attention caches:
    (logits (B, 1, V), `caches` with the token's self k and v written in
    place).  C11: raises at ``cache_len >= max_seq``.  On a mesh the
    caches are the rank's blocks under ``cache_pspecs`` and the logits
    the rank's vocab block; where ``kv_seq`` maps to a mesh axis both
    attentions combine over it."""
    b = token.shape[0]
    dt = dtype_of(cfg.dtype)
    mesh = rules.mesh if mesh is None else mesh
    cp_axis = cp_axis_of(rules, None, False, True)  # never the data axis's path
    n_slices = 1 if cp_axis is None else mesh.shape[cp_axis]
    n = int(cache_len)
    max_seq = n_slices * caches["self_k"].shape[2]
    if not 0 <= n < max_seq:
        raise ValueError(f"cache_len {n} is outside the cache's {max_seq} positions; "
                         f"the reference would overwrite its last slot")
    h = embed_lookup(params["embed"], token, dt, rules)
    pos = torch.full((b, 1), n, dtype=torch.int32, device=token.device)
    valid = torch.full((b,), n + 1, dtype=torch.int32, device=token.device)
    enc_len = n_slices * caches["cross_k"].shape[2]
    enc_valid = torch.full((b,), enc_len, dtype=torch.int32, device=token.device)
    hn, _ = _head_split(cfg, rules)
    hl = cfg.n_heads // hn
    for j in range(cfg.n_layers):
        lp = _period(params["dec_layers"], j)
        lcache = {"k": caches["self_k"][j], "v": caches["self_v"][j]}
        xn = tp_copy(rmsnorm(h, lp["ln1"], cfg.norm_eps), rules, "heads")
        wq = load_weight(lp["attn"]["wq"], rules, None, "heads", dtype=dt)
        q = apply_rope((xn @ wq).reshape(b, 1, hl, cfg.hd), pos, cfg.rope_theta)
        kt, vt = _kv_proj(lp["attn"], xn, cfg, rules)
        kt = apply_rope(kt, pos, cfg.rope_theta)
        write_token_kv(lcache, kt, vt, n, cfg, rules, mesh, cp_axis)
        a = decode_attend(q, lcache["k"], lcache["v"], valid, cfg, rules, mesh, cp_axis)
        h = h + _attn_out(lp, a, cfg, rules)
        # cross attention against the precomputed encoder K/V
        xq = tp_copy(rmsnorm(h, lp["lnx"], cfg.norm_eps), rules, "heads")
        wqx = load_weight(lp["xattn"]["wq"], rules, None, "heads", dtype=dt)
        qx = (xq @ wqx).reshape(b, 1, hl, cfg.hd)
        ax = decode_attend(qx, caches["cross_k"][j], caches["cross_v"][j], enc_valid, cfg,
                           rules, mesh, cp_axis)
        h = h + _attn_out({"attn": lp["xattn"]}, ax, cfg, rules)
        h = h + mlp_apply(lp["mlp"], rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg.mlp_kind, rules)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    return _logits_head(params, h, cfg, rules), caches
