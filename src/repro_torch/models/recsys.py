"""DLRM-style RecSys model (the paper's training stage, Table I).

The port of ``repro.models.recsys``: embedding tables, a bottom MLP over
the dense features, the pairwise-dot feature interaction
(a batched GEMM) and a top MLP to one CTR logit.  It consumes the mini-batch
that ``repro_torch.core.preprocess`` produces (dense, multi-hot SigridHashed
ids with their lengths, generated one-hot ids, labels).

Parameters keep the reference's names and layouts (``tables`` (T, R, D),
``bottom.w{i}`` (d_in, d_out), ``bottom_b.b{i}``, ``top.w{i}``,
``top_b.b{i}``), so ``params_from_numpy`` / ``params_to_numpy`` carry
weights between the two packages.  Table gradients are dense, as the
reference's are.

Under a mesh (``rules`` with a ``launch.mesh.Mesh``) a DLRM holds this
rank's block of each parameter (``param_pspecs``): the tables row-sharded
over ``model`` (the logical ``vocab`` axis), the MLP weights' input axis
over ``data`` (``fsdp``), gathered for the forward (``comm.gather_shards``).
The row-sharded ``sharded_embedding_bag`` pools each bag over the rank's own
rows and sums pools and counts over ``model`` (``comm.psum``), one (B, T, D)
all-reduce per batch, as the reference's shard_map does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.util import ShapeDtype, resolve_device
from repro_torch.data.synth import RMDataConfig
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import entry_axes, shard
from repro_torch.models.layers import ParamDef, Schema, init_from_schema, pspecs_from_schema

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
    tree: Dict[str, Any], cfg: RecSysConfig, device: torch.device | str | None = None,
    *, rules=None,
) -> DLRM:
    """The reference's params (a nested dict of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them) as a DLRM on `device`.
    With meshed `rules`, this rank's block of each (``param_pspecs``)."""
    device = resolve_device(device)
    mesh = None if rules is None else rules.mesh
    specs = param_pspecs(cfg, rules) if mesh is not None else None

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, None if spec is None else spec[k]) for k, v in node.items()}
        if spec is not None:
            node = shard(np.asarray(node), mesh, spec)
        return torch.from_numpy(np.array(node, copy=True)).to(device)

    return DLRM(cfg, walk(tree, specs))


def param_pspecs(cfg: RecSysConfig, rules) -> Dict[str, Any]:
    """Nested dict of each parameter's spec under `rules`."""
    return pspecs_from_schema(model_schema(cfg), rules)


def flat_param_pspecs(cfg: RecSysConfig, rules) -> Dict[str, tuple]:
    """``param_pspecs`` under the DLRM's ``named_parameters`` names."""
    out = {}
    for key, node in param_pspecs(cfg, rules).items():
        if isinstance(node, dict):
            out.update({f"{key}.{k}": v for k, v in node.items()})
        else:
            out[key] = node
    return out


def state_pspecs(cfg: RecSysConfig, rules, optimizer) -> Dict[str, Any]:
    """The spec tree of a DLRM's TrainState ``{params, opt, step}`` under
    `rules` (``train.step.state_shardings`` over the schema's shapes): what
    a meshed ``ElasticTrainer.state_shardings`` gives its checkpoints."""
    from repro_torch.train.step import state_shardings

    schema = model_schema(cfg)
    shapes = {"tables": schema["tables"].shape,
              **{f"{g}.{k}": d.shape for g in GROUPS for k, d in schema[g].items()}}
    records = {k: ShapeDtype(tuple(v), torch.float32) for k, v in shapes.items()}
    return state_shardings(optimizer, records, flat_param_pspecs(cfg, rules))


def params_to_numpy(model: DLRM) -> Dict[str, Any]:
    """The model's params as the reference's nested dict of numpy arrays."""
    out: Dict[str, Any] = {"tables": model.tables.detach().cpu().numpy()}
    for group in GROUPS:
        out[group] = {k: v.detach().cpu().numpy() for k, v in getattr(model, group).items()}
    return out


# ---------------------------------------------------------------------------
# Embedding bag


def _bag_ids(multi_ids, lengths, one_ids, rows: int, base: int = 0):
    """Every sample's ids flat, the multi-hot bags' S*L positions then the G
    one-hot ones, as int64 less `base`; their validity (within the bag's
    length and in [0, rows)); the table of each position; and each bag's
    count of valid ids, (B, T)."""
    b, s, L = multi_ids.shape
    g = one_ids.shape[1]
    dev = multi_ids.device
    mask = torch.arange(L, device=dev) < lengths[..., None]  # (B, S, L)
    ids = torch.cat([multi_ids.reshape(b, s * L), one_ids], dim=1).to(torch.int64)
    if base:
        ids = ids - base
    valid = torch.cat([mask.reshape(b, s * L), torch.ones_like(one_ids, dtype=torch.bool)],
                      dim=1)
    valid &= (ids >= 0) & (ids < rows)
    table_of = torch.cat([torch.arange(s, device=dev).repeat_interleave(L),
                          torch.arange(s, s + g, device=dev)])
    counts = torch.cat([valid[:, : s * L].reshape(b, s, L).sum(-1), valid[:, s * L:]], dim=1)
    return ids, valid, table_of, counts


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
        ids, valid, table_of, counts = _bag_ids(multi_ids, lengths, one_ids, r)
        # where each of a sample's s*L + g bags starts
        starts = torch.cat([torch.arange(s, device=dev) * L,
                            s * L + torch.arange(g, device=dev)])
        per_sample = s * L + g
        offsets = (torch.arange(b, device=dev)[:, None] * per_sample + starts).reshape(-1)
        flat = ids.clamp(0, r - 1) + table_of * r
        pooled = F.embedding_bag(
            flat.reshape(-1), tables.reshape(t * r, d), offsets, mode="sum",
            per_sample_weights=valid.reshape(-1).to(tables.dtype),
        ).reshape(b, t, d)
        return pooled / counts.clamp_min(1)[..., None].to(pooled.dtype)


def _mlp(ws, bs, x: torch.Tensor, n: int) -> torch.Tensor:
    for i in range(n):
        x = x @ ws[f"w{i}"] + bs[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def sharded_embedding_bag(
    tables: torch.Tensor,  # (T, R_local, D): this rank's rows of every table
    multi_ids: torch.Tensor,  # (B, S, L) global row ids
    lengths: torch.Tensor,  # (B, S)
    one_ids: torch.Tensor,  # (B, G)
    mesh,
    axis: str,
) -> torch.Tensor:
    """``embedding_bag`` over tables row-sharded along mesh `axis`.

    Rank i owns rows [i * R_local, (i + 1) * R_local) of every table; ids
    are offset by that base, and ids outside [0, R_local) count nothing on
    this rank.  Only the rank's own ids enter the bag (the whole batch's
    ids would cost a (n_ids, D) buffer of partial sums in the backward),
    sum-pooled per bag by offsets; pooled sums and counts are then summed
    over `axis` and divided.  The table gradient is this rank's rows of the
    one-device gradient (``comm.psum``'s backward is the identity)."""
    with torch.profiler.record_function("dlrm.embedding_bag"):
        t, r, d = tables.shape
        b = multi_ids.shape[0]
        ids, valid, table_of, counts = _bag_ids(multi_ids, lengths, one_ids, r,
                                                mesh.coords[axis] * r)
        counts = counts.to(torch.int32)  # (B, T)
        # positions run sample by sample, bag by bag: the valid ids in that
        # order, and each bag's start among them
        own = (ids + table_of * r)[valid]
        offsets = torch.cumsum(counts.reshape(-1), 0) - counts.reshape(-1)
        pooled = F.embedding_bag(own, tables.reshape(t * r, d), offsets, mode="sum")
        pooled = comm.psum(pooled.reshape(b, t, d), mesh, axis)
        counts = comm.psum(counts, mesh, axis)
        return pooled / counts.clamp_min(1)[..., None].to(pooled.dtype)


def _gather_param(p: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole parameter from this rank's block (minor axis first)."""
    for dim, entry in enumerate(spec):
        for axis in reversed(entry_axes(entry)):
            p = comm.gather_shards(p, mesh, axis, dim)
    return p


def forward(model: DLRM, minibatch: Dict[str, torch.Tensor], cfg: RecSysConfig,
            rules=None) -> torch.Tensor:
    """Mini-batch -> CTR logits (B,); under meshed `rules`, this rank's
    rows of them, from its blocks of the parameters: the MLP weights
    gathered whole, the bag row-sharded where the tables are."""
    mesh = None if rules is None else rules.mesh
    whole, bag = getattr, embedding_bag
    if mesh is not None:
        specs = param_pspecs(cfg, rules)
        vocab = entry_axes(specs["tables"][1])
        if len(vocab) > 1:
            raise ValueError(f"tables shard over one mesh axis, not {vocab}")

        def whole(model, group):
            return {k: _gather_param(v, specs[group][k], mesh)
                    for k, v in getattr(model, group).items()}

        if vocab:
            bag = functools.partial(sharded_embedding_bag, mesh=mesh, axis=vocab[0])
    dense = minibatch["dense"] if rules is None else rules.constrain(
        minibatch["dense"], "batch", None)
    bot = _mlp(whole(model, "bottom"), whole(model, "bottom_b"), dense, len(cfg.bottom_mlp))
    emb = bag(model.tables, minibatch["multi_hot_ids"], minibatch["lengths"],
              minibatch["one_hot_ids"])  # (B, T, D)
    z = torch.cat([bot[:, None, :], emb], dim=1)  # (B, T+1, D)
    inter = torch.bmm(z, z.transpose(1, 2))  # batched GEMM interaction
    n_int = cfg.n_tables + 1
    iu = torch.triu_indices(n_int, n_int, offset=1, device=z.device)
    flat = inter[:, iu[0], iu[1]]  # (B, n_int*(n_int-1)/2)
    top_in = torch.cat([bot, flat], dim=1)
    return _mlp(whole(model, "top"), whole(model, "top_b"), top_in, len(cfg.top_mlp))[:, 0]


def loss_fn(
    model: DLRM, minibatch: Dict[str, torch.Tensor], cfg: RecSysConfig, rules=None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stable binary cross-entropy of the logits, and the accuracy (under
    meshed `rules`, of this rank's rows)."""
    logits = forward(model, minibatch, cfg, rules)
    labels = minibatch["labels"]
    loss = torch.mean(
        torch.clamp_min(logits, 0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    )
    acc = torch.mean(((logits > 0) == (labels > 0.5)).to(torch.float32))
    return loss, {"loss": loss.detach(), "accuracy": acc}
