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

Under ``cfg.remat`` other than ``"none"`` the reference checkpoints every
encoder and decoder layer with a plain ``jax.checkpoint`` (nothing saved),
whatever the policy's name; so does the port, with
``transformer.remat_call("full", ...)`` when a gradient is taken.
Decode stays plain on any mesh, as the reference's does: it never takes
the context-parallel path.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.common.util import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ParamDef,
    Schema,
    apply_rope,
    blockwise_attention,
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
from repro_torch.models.transformer import (
    _period,
    _periods,
    attn_schema,
    chunked_xent,
    dtype_of,
    remat_call,
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


def _mha(p, xq, xkv, positions_q, positions_kv, cfg, rules, causal) -> torch.Tensor:
    b, sq, _ = xq.shape
    skv = xkv.shape[1]
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = xq.dtype
    wq = load_weight(p["wq"], rules, None, "heads", dtype=dt)
    wk = load_weight(p["wk"], rules, None, "kv_heads", dtype=dt)
    wv = load_weight(p["wv"], rules, None, "kv_heads", dtype=dt)
    kv_ax = "kv_heads" if cfg.n_kv_heads % max(rules.axis_size("kv_heads"), 1) == 0 else None
    q = rules.constrain(xq @ wq, "batch", "seq", "heads").reshape(b, sq, h, hd)
    kk = rules.constrain(xkv @ wk, "batch", "seq", kv_ax).reshape(b, skv, k, hd)
    vv = rules.constrain(xkv @ wv, "batch", "seq", kv_ax).reshape(b, skv, k, hd)
    if positions_q is not None:
        q = apply_rope(q, positions_q, cfg.rope_theta)
        kk = apply_rope(kk, positions_kv, cfg.rope_theta)
    out = blockwise_attention(q, kk, vv, causal=causal)
    wo = load_weight(p["wo"], rules, "heads", None, dtype=dt)
    return out.reshape(b, sq, h * hd) @ wo


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
    h = params["embed"][tokens].to(dtype_of(cfg.dtype))
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    for lp in _periods(params["dec_layers"], cfg.n_layers):
        h = remat_call(_remat(cfg), _dec_layer, lp, h, enc_out, pos, cfg, rules)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    xent = chunked_xent(params, h, batch["labels"], batch["mask"], cfg, rules)
    return xent, {"loss": xent.detach(), "xent": xent.detach()}


# -- serving -----------------------------------------------------------------


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    """Meta tensors of the decode cache (the reference's
    ``ShapeDtypeStruct`` dict)."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dt = dtype_of(cfg.dtype)
    return {name: torch.empty(shape, dtype=dt, device="meta")
            for name in ("self_k", "self_v", "cross_k", "cross_v")}


def cache_pspecs(cfg: ModelConfig, rules) -> Dict[str, Any]:
    """The specs of the decode cache dict under `rules`."""
    model_n = rules.mesh.shape.get("model", 1) if rules.mesh else 1
    kv_ax = "kv_heads" if cfg.n_kv_heads % max(model_n, 1) == 0 else None
    p = rules.pspec("layers", "batch", "kv_seq", kv_ax, None)
    return {"self_k": p, "self_v": p, "cross_k": p, "cross_v": p}


def cross_caches(params, enc_out: torch.Tensor, cfg: ModelConfig,
                 max_seq: int) -> Dict[str, torch.Tensor]:
    """The decode caches for `enc_out` (B, S_enc, d): the cross K/V of
    every decoder layer, (n_layers, B, S_enc, K, hd), and zeroed
    self-attention K/V of `max_seq` positions."""
    b, s, _ = enc_out.shape
    k, hd, dt = cfg.n_kv_heads, cfg.hd, enc_out.dtype
    shape = (cfg.n_layers, b, s, k, hd)
    ck = torch.empty(shape, dtype=dt, device=enc_out.device)
    cv = torch.empty(shape, dtype=dt, device=enc_out.device)
    for j in range(cfg.n_layers):
        xp = params["dec_layers"]["xattn"]
        ck[j] = (enc_out @ xp["wk"][j].to(dt)).reshape(b, s, k, hd)
        cv[j] = (enc_out @ xp["wv"][j].to(dt)).reshape(b, s, k, hd)
    self_shape = (cfg.n_layers, b, max_seq, k, hd)
    return {"self_k": torch.zeros(self_shape, dtype=dt, device=enc_out.device),
            "self_v": torch.zeros(self_shape, dtype=dt, device=enc_out.device),
            "cross_k": ck, "cross_v": cv}


def decode_step(params, token: torch.Tensor, caches: Dict[str, torch.Tensor], cache_len,
                cfg: ModelConfig, rules, *, mesh=None,
                shard_kv_seq: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder token against the self- and cross-attention caches:
    (logits (B, 1, V), `caches` with the token's self k and v written in
    place).  C11: raises at ``cache_len >= max_seq``."""
    b = token.shape[0]
    h_, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg.dtype)
    n = int(cache_len)
    max_seq = caches["self_k"].shape[2]
    if not 0 <= n < max_seq:
        raise ValueError(f"cache_len {n} is outside the cache's {max_seq} positions; "
                         f"the reference would overwrite its last slot")
    h = params["embed"][token].to(dt)
    pos = torch.full((b, 1), n, dtype=torch.int32, device=token.device)
    valid = torch.full((b,), n + 1, dtype=torch.int32, device=token.device)
    enc_len = caches["cross_k"].shape[2]
    enc_valid = torch.full((b,), enc_len, dtype=torch.int32, device=token.device)
    for j in range(cfg.n_layers):
        lp = _period(params["dec_layers"], j)
        sk, sv = caches["self_k"][j], caches["self_v"][j]
        xn = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        q = apply_rope((xn @ lp["attn"]["wq"].to(dt)).reshape(b, 1, h_, hd), pos, cfg.rope_theta)
        kt = apply_rope((xn @ lp["attn"]["wk"].to(dt)).reshape(b, 1, k, hd), pos,
                        cfg.rope_theta)
        vt = (xn @ lp["attn"]["wv"].to(dt)).reshape(b, 1, k, hd)
        sk[:, n] = kt[:, 0]
        sv[:, n] = vt[:, 0]
        a = decode_attention(q, sk, sv, valid)
        h = h + a.reshape(b, 1, h_ * hd) @ lp["attn"]["wo"].to(dt)
        # cross attention against the precomputed encoder K/V
        xq = rmsnorm(h, lp["lnx"], cfg.norm_eps)
        qx = (xq @ lp["xattn"]["wq"].to(dt)).reshape(b, 1, h_, hd)
        ax = decode_attention(qx, caches["cross_k"][j], caches["cross_v"][j], enc_valid)
        h = h + ax.reshape(b, 1, h_ * hd) @ lp["xattn"]["wo"].to(dt)
        h = h + mlp_apply(lp["mlp"], rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg.mlp_kind, rules)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    logits = h @ load_weight(params["head"], rules, None, "vocab", dtype=dt)
    if cfg.padded_vocab != cfg.vocab_size:
        valid_v = torch.arange(cfg.padded_vocab, device=h.device) < cfg.vocab_size
        logits = torch.where(valid_v, logits, -1e30)
    return rules.constrain(logits, "batch", "seq", "vocab"), caches
