"""Serving CLI: prefill + batched greedy decode for any decoder-only --arch.

The port of ``repro.launch.serve``: prefill fills the KV and SSM caches,
then token-by-token decode with batched requests.  The flags are the
reference's plus ``--device`` (CUDA by default, raising when no card is
present; ``cpu`` on request).  It prints the reference's two lines, the
first with the card's name and power limit beside its times (host clock
around work that ends in a synchronize), and returns the numbers.  An
encoder-decoder arch is refused with the reference's message:
``repro_torch.examples.serve_lm`` serves it.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b --reduced \
      --batch 4 --prompt-len 64 --gen 32 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common.util import card_line, resolve_device
from repro_torch.configs.registry import get_arch
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models import transformer as tfm
from repro_torch.train import make_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default CUDA; cpu on request)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    entry = get_arch(args.arch)
    cfg = entry.reduced if args.reduced else entry.config
    if cfg.is_encdec:
        raise ValueError("use examples/serve_lm.py for enc-dec serving")
    rules = ShardingRules.make(None)
    params = tfm.cast_weights(
        tfm.init_params(torch.Generator().manual_seed(args.seed), cfg, device), cfg)

    rng = np.random.default_rng(args.seed)
    max_seq = args.prompt_len + args.gen
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(device)

    t0 = time.perf_counter()
    logits, caches = tfm.prefill(params, prompts, cfg, rules, max_seq)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    serve = make_serve_step(lambda p, t, c, n: tfm.decode_step(p, t, c, n, cfg, rules))
    token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    out_tokens = [token]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        token, logits, caches = serve(params, token, caches, args.prompt_len + i)
        out_tokens.append(token)
    _sync(device)
    decode_s = time.perf_counter() - t0
    gen = torch.cat(out_tokens, dim=1).cpu().numpy()
    tok_s = args.batch * (args.gen - 1) / max(decode_s, 1e-9)
    card = card_line(device)
    print(f"{cfg.name}: prefill({args.batch}x{args.prompt_len}) {prefill_s:.2f}s, "
          f"decode {args.gen-1} steps {decode_s:.2f}s ({tok_s:.1f} tok/s) [{card}]")
    print("sample token ids:", gen[0, :16].tolist())
    if not (0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size):
        raise RuntimeError(f"generated ids outside [0, {cfg.vocab_size})")
    return {"arch": cfg.name, "prefill_s": prefill_s, "decode_s": decode_s, "tok_s": tok_s,
            "tokens": gen, "card": card}


if __name__ == "__main__":
    main()
