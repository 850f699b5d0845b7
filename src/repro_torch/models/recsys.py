"""DLRM-style RecSys model (the paper's training stage, Table I), on one device.

The port of ``repro.models.recsys`` without the mesh: embedding tables,
a bottom MLP over the dense features, the pairwise-dot feature interaction
(a batched GEMM) and a top MLP to one CTR logit.  It consumes the mini-batch
that ``repro_torch.core.preprocess`` produces (dense, multi-hot SigridHashed
ids with their lengths, generated one-hot ids, labels).

Parameters keep the reference's names and layouts (``tables`` (T, R, D),
``bottom.w{i}`` (d_in, d_out), ``bottom_b.b{i}``, ``top.w{i}``,
``top_b.b{i}``), so ``params_from_numpy`` / ``params_to_numpy`` carry
weights between the two packages.  Table gradients are dense, as the
reference's are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.util import resolve_device
from repro_torch.data.synth import RMDataConfig
from repro_torch.models.layers import ParamDef, Schema, init_from_schema

GROUPS = ("bottom", "bottom_b", "top", "top_b")


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    data: RMDataConfig
    emb_dim: int = 128
    bottom_mlp: tuple = (512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    dtype: str = "float32"
    param_dtype: str = "float32"

    @property
    def n_tables(self) -> int:
        return self.data.n_tables

    @property
    def family(self) -> str:
        return "recsys"


def model_schema(cfg: RecSysConfig) -> Schema:
    nd = cfg.data.n_dense
    rows = cfg.data.embedding_rows
    s: Schema = {
        "tables": ParamDef(
            (cfg.n_tables, rows, cfg.emb_dim), (None, "vocab", None), scale=0.01
        ),
    }
    dims = (nd,) + cfg.bottom_mlp
    s["bottom"] = {
        f"w{i}": ParamDef((dims[i], dims[i + 1]), ("fsdp", None))
        for i in range(len(dims) - 1)
    }
    s["bottom_b"] = {
        f"b{i}": ParamDef((dims[i + 1],), (None,), init="zeros")
        for i in range(len(dims) - 1)
    }
    n_int = cfg.n_tables + 1
    top_in = n_int * (n_int - 1) // 2 + cfg.bottom_mlp[-1]
    tdims = (top_in,) + cfg.top_mlp
    s["top"] = {
        f"w{i}": ParamDef((tdims[i], tdims[i + 1]), ("fsdp", None))
        for i in range(len(tdims) - 1)
    }
    s["top_b"] = {
        f"b{i}": ParamDef((tdims[i + 1],), (None,), init="zeros")
        for i in range(len(tdims) - 1)
    }
    return s


class DLRM(nn.Module):
    """The parameters of one DLRM; ``forward(minibatch)`` gives the logits."""

    def __init__(self, cfg: RecSysConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.tables = nn.Parameter(params["tables"])
        for group in GROUPS:
            setattr(self, group, nn.ParameterDict(
                {k: nn.Parameter(v) for k, v in params[group].items()}))

    def forward(self, minibatch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return forward(self, minibatch, self.cfg)


def init_params(
    generator: torch.Generator, cfg: RecSysConfig, device: torch.device | str | None = None
) -> DLRM:
    """A DLRM with weights drawn from `generator` (not the reference's
    numbers: see ``models.layers``), on `device` (CUDA unless named)."""
    dtype = getattr(torch, cfg.param_dtype)
    return DLRM(cfg, init_from_schema(generator, model_schema(cfg), dtype,
                                      resolve_device(device)))


def params_from_numpy(
    tree: Dict[str, Any], cfg: RecSysConfig, device: torch.device | str | None = None
) -> DLRM:
    """The reference's params (a nested dict of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them) as a DLRM on `device`."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, copy=True)).to(device)

    return DLRM(cfg, walk(tree))


def params_to_numpy(model: DLRM) -> Dict[str, Any]:
    """The model's params as the reference's nested dict of numpy arrays."""
    out: Dict[str, Any] = {"tables": model.tables.detach().cpu().numpy()}
    for group in GROUPS:
        out[group] = {k: v.detach().cpu().numpy() for k, v in getattr(model, group).items()}
    return out


# ---------------------------------------------------------------------------
# Embedding bag


def embedding_bag(
    tables: torch.Tensor,  # (T, R, D)
    multi_ids: torch.Tensor,  # (B, S, L)
    lengths: torch.Tensor,  # (B, S)
    one_ids: torch.Tensor,  # (B, G), S + G == T
) -> torch.Tensor:
    """Mean-pooled embeddings of every table -> (B, T, D).

    Multi-hot table s pools the ids of position l < lengths[b, s]; one-hot
    table S + g pools its one id.  Ids outside [0, R) count nothing.  A bag
    with no valid id pools to 0 (sum over max(count, 1)).  One
    ``embedding_bag`` call over the tables viewed as (T*R, D) does it, with
    each table's ids offset by t*R and the validity mask as per-sample
    weights: the (B, S, L, D) gather is never materialised, and the
    gradient of the tables is one dense (T, R, D) buffer."""
    with torch.profiler.record_function("dlrm.embedding_bag"):
        t, r, d = tables.shape
        b, s, L = multi_ids.shape
        g = one_ids.shape[1]
        dev = multi_ids.device
        mask = torch.arange(L, device=dev) < lengths[..., None]  # (B, S, L)
        ids = torch.cat([multi_ids.reshape(b, s * L), one_ids], dim=1).to(torch.int64)
        valid = torch.cat([mask.reshape(b, s * L), torch.ones_like(one_ids, dtype=torch.bool)],
                          dim=1)
        valid &= (ids >= 0) & (ids < r)
        # table of each of a sample's s*L + g ids, and where each bag starts
        table_of = torch.cat([torch.arange(s, device=dev).repeat_interleave(L),
                              torch.arange(s, s + g, device=dev)])
        starts = torch.cat([torch.arange(s, device=dev) * L,
                            s * L + torch.arange(g, device=dev)])
        per_sample = s * L + g
        offsets = (torch.arange(b, device=dev)[:, None] * per_sample + starts).reshape(-1)
        flat = ids.clamp(0, r - 1) + table_of * r
        pooled = F.embedding_bag(
            flat.reshape(-1), tables.reshape(t * r, d), offsets, mode="sum",
            per_sample_weights=valid.reshape(-1).to(tables.dtype),
        ).reshape(b, t, d)
        counts = torch.cat([valid[:, : s * L].reshape(b, s, L).sum(-1), valid[:, s * L:]], dim=1)
        return pooled / counts.clamp_min(1)[..., None].to(pooled.dtype)


def _mlp(ws: nn.ParameterDict, bs: nn.ParameterDict, x: torch.Tensor, n: int) -> torch.Tensor:
    for i in range(n):
        x = x @ ws[f"w{i}"] + bs[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def forward(model: DLRM, minibatch: Dict[str, torch.Tensor], cfg: RecSysConfig) -> torch.Tensor:
    """Mini-batch -> CTR logits (B,)."""
    bot = _mlp(model.bottom, model.bottom_b, minibatch["dense"], len(cfg.bottom_mlp))
    emb = embedding_bag(model.tables, minibatch["multi_hot_ids"], minibatch["lengths"],
                        minibatch["one_hot_ids"])  # (B, T, D)
    z = torch.cat([bot[:, None, :], emb], dim=1)  # (B, T+1, D)
    inter = torch.bmm(z, z.transpose(1, 2))  # batched GEMM interaction
    n_int = cfg.n_tables + 1
    iu = torch.triu_indices(n_int, n_int, offset=1, device=z.device)
    flat = inter[:, iu[0], iu[1]]  # (B, n_int*(n_int-1)/2)
    top_in = torch.cat([bot, flat], dim=1)
    return _mlp(model.top, model.top_b, top_in, len(cfg.top_mlp))[:, 0]


def loss_fn(
    model: DLRM, minibatch: Dict[str, torch.Tensor], cfg: RecSysConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stable binary cross-entropy of the logits, and the accuracy."""
    logits = forward(model, minibatch, cfg)
    labels = minibatch["labels"]
    loss = torch.mean(
        torch.clamp_min(logits, 0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    )
    acc = torch.mean(((logits > 0) == (labels > 0.5)).to(torch.float32))
    return loss, {"loss": loss.detach(), "accuracy": acc}
