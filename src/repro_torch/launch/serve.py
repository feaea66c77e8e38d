"""Serving launcher: spin up the batched LM engine on a reduced config and
stream a few requests through it.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b --device cpu

Runs on the card unless ``--device`` names another; on the CPU every
kernel's plain version runs instead.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=sorted(configs.ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-tokens", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_reduced(args.arch)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params, buffers = lm.init(cfg, gen, device=args.device)
    engine = ServeEngine(cfg, params, buffers,
                         max_batch=args.max_batch, max_seq=args.max_seq)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(3, 10)))
        engine.submit(Request(uid=i, prompt=prompt.astype(np.int32),
                              max_tokens=args.max_tokens))
    t0 = time.time()
    done = engine.run()
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in done)
    print(f"{args.arch}: served {len(done)} requests / {toks} tokens "
          f"in {dt:.1f}s ({engine.ticks} ticks, batch {args.max_batch}, {args.device})")
    for r in done[:3]:
        print(f"  req {r.uid}: prompt[:4]={r.prompt[:4].tolist()} -> {r.generated}")
    return done


if __name__ == "__main__":
    main()
