#!/usr/bin/env python3
"""How often the moe family's routing decisions differ between one GPU and
the CPU, and between the CPU's bfloat16 and float32.

    python3 tools/probe_moe_flips.py [--prompts 8] [--tokens 256]

Initialises phi3.5-moe-42b-a6.6b at full width and ``chip_smoke.MOE_LAYERS``
layers as ``chip_smoke.py``'s ``moe_serve`` phase does (``lm.init`` from
``LM_SEED`` on the card), takes its first two layers, and prefills
``--prompts`` random prompts of ``--tokens`` tokens (numpy, seeds 0, 1, ...)
through them on the card and on CPU copies, in float32 and in bfloat16,
tracing every routing decision (``chip_smoke.moe_traced``).  Prints, a
prompt and a layer, the share of tokens whose decision (``gate_idx`` or
``keep``) differs: card bfloat16 against CPU bfloat16 (what
``chip_smoke``'s cut check counts), CPU bfloat16 against CPU float32 (the
CPU's own rounding), card bfloat16 against CPU float32, and card float32
against CPU float32 (which the cut check holds at none); then each
comparison's mean and largest share over the prompts at layer 0, the
layer whose input (the embedding) is the same on both sides.
"""
import argparse
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.tree import tree_map

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=cs.LM_CHECK_PROMPT)
    args = ap.parse_args(argv)
    cs.check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}; torch {torch.__version__}", flush=True)

    cfg = configs.get(cs.MOE_ARCH, n_layers=cs.MOE_LAYERS)
    params, buffers = lm.init(cfg, torch.Generator(device="cuda").manual_seed(cs.LM_SEED),
                              device="cuda")
    n = 2
    cut_p = dict(params, blocks=tree_map(lambda t: t[:n].clone(), params["blocks"]))
    del params
    cpu_p = tree_map(lambda t: t.detach().to("cpu", copy=True), cut_p)
    cpu_b = tree_map(lambda t: t.detach().to("cpu", copy=True), buffers)
    sides = {"card": (cut_p, buffers, "cuda"), "cpu": (cpu_p, cpu_b, "cpu")}

    def decisions(side, dtype, toks):
        p, b, device = sides[side]
        cut = dataclasses.replace(cfg, n_layers=n, dtype=dtype)
        cache = lm.init_cache(cut, 1, toks.shape[1], device=device)
        with torch.inference_mode():
            _, trace = cs.moe_traced(lambda: lm.prefill(p, b, cut, toks.to(device), cache))
        cs.check(len(trace) == n, f"{len(trace)} routes traced, not {n}")
        return [(g[0], k[0]) for _, g, k in trace]

    def differ(a, b):
        """Per layer: the tokens whose gate_idx or keep differ."""
        return [((ga != gb).any(-1) | (ka != kb).any(-1)).numpy() for (ga, ka), (gb, kb)
                in zip(a, b)]

    pairs = {"card_bf16_vs_cpu_bf16": (("card", "bf16"), ("cpu", "bf16")),
             "cpu_bf16_vs_cpu_f32": (("cpu", "bf16"), ("cpu", "f32")),
             "card_bf16_vs_cpu_f32": (("card", "bf16"), ("cpu", "f32")),
             "card_f32_vs_cpu_f32": (("card", "f32"), ("cpu", "f32"))}
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    layer0 = {name: [] for name in pairs}
    for i in range(args.prompts):
        rng = np.random.default_rng(i)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, args.tokens)).astype(np.int64))
        got = {(side, dn): decisions(side, dt, toks)
               for side in sides for dn, dt in dtypes.items()}
        row = {"prompt": i, "tokens": args.tokens}
        for name, (a, b) in pairs.items():
            flips = differ(got[a], got[b])
            row[name] = [float(f.mean()) for f in flips]
            layer0[name].append(float(flips[0].mean()))
        print(json.dumps(row), flush=True)
    summary = {name: {"layer0_mean": float(np.mean(v)), "layer0_max": float(np.max(v))}
               for name, v in layer0.items()}
    print(json.dumps({"card": cs.card_line(), "prompts": args.prompts, "tokens": args.tokens,
                      "layer0": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
