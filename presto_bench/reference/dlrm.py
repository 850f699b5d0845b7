"""The plain DLRM and AdamW that the train cells' checks replay.

Plain PyTorch in float32, written from the model's description (the PreSto
paper's Table I models: embedding bags, a bottom MLP over the dense
features, the pairwise dot-product interaction, a top MLP to one logit,
binary cross-entropy) and from AdamW's, with no fused operator: a bag is a
gather, a masked sum and a division; the interaction is the product of the
(T+1, D) feature matrix with its transpose, of which the pairs above the
diagonal, row by row, follow the bottom MLP's output into the top MLP.
Matrix products run with TF32 off, unless ``tf32`` asks for it (the
benchmark's control).

``replay`` draws the weights again from the seed (``draw``), runs the
first steps on the reference Transform's batches, and returns what the
check compares: each step's loss, each leaf's norm of the first step's
clipped gradient (and of the raw one, for the rule that leaves out leaves
whose gradient is nought), and each leaf's norm of its change after the
last step.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch

from presto_bench.reference import draw


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def forward(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], model: Dict,
            data: Dict) -> torch.Tensor:
    """Logits (B,) of a batch."""
    s, g = data["n_sparse"], data["n_generated"]
    rows = data["embedding_rows"]
    x = batch["dense"]
    nb = len(model["bottom_mlp"])
    for i in range(nb):
        x = x @ p[f"bottom.w{i}"] + p[f"bottom_b.b{i}"]
        if i < nb - 1:
            x = torch.relu(x)
    ids, lengths, one = batch["multi_hot_ids"], batch["lengths"], batch["one_hot_ids"]
    L = ids.shape[2]
    pos = torch.arange(L, device=ids.device)
    pooled = []
    for t in range(s):
        tid = ids[:, t, :].long()
        valid = (pos[None, :] < lengths[:, t, None]) & (tid >= 0) & (tid < rows)
        rows_ = p[f"tables.{t}"][tid.clamp(0, rows - 1)]  # (B, L, D)
        w = valid.to(rows_.dtype)
        total = (rows_ * w[..., None]).sum(dim=1)
        pooled.append(total / w.sum(dim=1).clamp_min(1.0)[:, None])
    for k in range(g):
        tid = one[:, k].long()
        valid = ((tid >= 0) & (tid < rows)).to(torch.float32)
        pooled.append(p[f"tables.{s + k}"][tid.clamp(0, rows - 1)] * valid[:, None])
    z = torch.stack([x] + pooled, dim=1)  # (B, T+1, D)
    inter = z @ z.transpose(1, 2)
    n = z.shape[1]
    iu = torch.triu_indices(n, n, offset=1, device=z.device)
    y = torch.cat([x, inter[:, iu[0], iu[1]]], dim=1)
    nt = len(model["top_mlp"])
    for i in range(nt):
        y = y @ p[f"top.w{i}"] + p[f"top_b.b{i}"]
        if i < nt - 1:
            y = torch.relu(y)
    return y[:, 0]


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def learning_rate(train: Dict, count: int) -> float:
    """Linear warm-up to the peak, then a cosine down to floor x peak."""
    peak, warm = train["lr"], train["warmup"]
    total = max(train["schedule_steps"], train["min_total"])
    if count < warm:
        return peak * count / max(warm, 1)
    frac = min(max((count - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (train["lr_floor"] + (1 - train["lr_floor"]) * 0.5 * (1 + math.cos(math.pi * frac)))


def leaf_norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def replay(model: Dict, data: Dict, train: Dict, seed: int,
           batches: List[Dict[str, torch.Tensor]], device, *, tf32: bool = False,
           rows: Optional[int] = None) -> Dict:
    """The first ``len(batches)`` steps from the drawn weights (see the
    module).  ``rows`` trains on the first `rows` rows of each batch (a
    planted fault for the check's calibration)."""
    p = draw.draw_all(model, data, seed, device)
    for v in p.values():
        v.requires_grad_(True)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps, wd = train["b1"], train["b2"], train["eps"], train["weight_decay"]
    out = {"loss": [], "grad": {}, "grad_raw": {}, "change": {}}
    with matmul_precision(tf32):
        for step, batch in enumerate(batches, start=1):
            if rows is not None:
                batch = {k: v[:rows] for k, v in batch.items()}
            loss = bce(forward(p, batch, model, data), batch["labels"])
            grads = torch.autograd.grad(loss, list(p.values()))
            out["loss"].append(float(loss.detach()))
            with torch.no_grad():
                sq = sum(float(torch.sum(gr.double() ** 2)) for gr in grads)
                scale = min(1.0, train["clip_norm"] / max(math.sqrt(sq), 1e-9))
                lr = learning_rate(train, step)
                c1, c2 = 1 - b1 ** step, 1 - b2 ** step
                for (name, w), gr in zip(p.items(), grads):
                    if step == 1:
                        out["grad_raw"][name] = leaf_norm(gr)
                    gr = gr * scale
                    if step == 1:
                        out["grad"][name] = leaf_norm(gr)
                    m[name].mul_(b1).add_((1 - b1) * gr)
                    v2[name].mul_(b2).add_((1 - b2) * gr * gr)
                    upd = (m[name] / c1) / (torch.sqrt(v2[name] / c2) + eps)
                    if wd:
                        upd = upd + wd * w
                    w.sub_(lr * upd)
                del grads
    del m, v2
    with torch.no_grad():
        for name, shape, std, idx in draw.leaf_specs(model, data):
            w0 = draw.draw_leaf(shape, std, idx, seed, device)
            out["change"][name] = leaf_norm(p[name].detach() - w0)
            del w0
    return out
