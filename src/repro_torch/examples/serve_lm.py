"""Serve a small LM with batched requests: prefill + greedy decode.

The port of ``examples/serve_lm.py``: the serving substrate on reduced
configs of the assigned architectures — KV caches for attention layers,
recurrent state for SSM/hybrid layers, cross-attention caches for the
enc-dec model.  The flags are the reference's plus ``--device`` (CUDA by
default, raising when no card is present; ``cpu`` on request).  It prints
the reference's lines, the last with the card's name and power limit
beside its time (host clock around work that ends in a synchronize), and
returns the numbers.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch jamba-v0.1-52b --gen 24 \
        --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common.util import card_line, resolve_device
from repro_torch.configs.registry import get_arch
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.train import make_serve_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-v0.1-52b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default CUDA; cpu on request)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced
    rules = ShardingRules.make(None)
    rng = np.random.default_rng(0)
    max_seq = args.prompt_len + args.gen
    B = args.batch
    gen_seed = torch.Generator().manual_seed(0)

    if cfg.is_encdec:
        params = tfm.cast_weights(encdec.init_params(gen_seed, cfg, device), cfg)
        frames = torch.from_numpy(
            rng.normal(size=(B, args.prompt_len, cfg.d_model)).astype(np.float32)).to(device)
        enc_out = encdec.encode(params, frames, cfg, rules)
        caches = encdec.cross_caches(params, enc_out, cfg, max_seq)
        decode = lambda p, t, c, n: encdec.decode_step(p, t, c, n, cfg, rules)  # noqa: E731
        token = torch.ones((B, 1), dtype=torch.int32, device=device)
        start = 0
        print(f"{cfg.name}: encoded {args.prompt_len} frames; decoding...")
    else:
        params = tfm.cast_weights(tfm.init_params(gen_seed, cfg, device), cfg)
        prompts = torch.from_numpy(
            rng.integers(1, cfg.vocab_size, (B, args.prompt_len)).astype(np.int32)).to(device)
        logits, caches = tfm.prefill(params, prompts, cfg, rules, max_seq)
        token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        decode = lambda p, t, c, n: tfm.decode_step(p, t, c, n, cfg, rules)  # noqa: E731
        start = args.prompt_len
        print(f"{cfg.name}: prefilled {B}x{args.prompt_len}; decoding...")

    serve = make_serve_step(decode)
    out = [token]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        token, logits, caches = serve(params, token, caches, start + i)
        out.append(token)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    gen = torch.cat(out, dim=1).cpu().numpy()
    if not (gen.min() >= 0 and gen.max() < cfg.vocab_size):
        raise RuntimeError(f"generated ids outside [0, {cfg.vocab_size})")
    tok_s = B * (args.gen - 1) / max(dt, 1e-9)
    card = card_line(device)
    print(f"decoded {args.gen - 1} steps x {B} requests in {dt:.2f}s "
          f"({tok_s:.1f} tok/s) [{card}]; sample: {gen[0, :12].tolist()}")
    return {"arch": cfg.name, "decode_s": dt, "tok_s": tok_s, "tokens": gen, "card": card}


if __name__ == "__main__":
    main()
