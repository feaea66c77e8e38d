#!/usr/bin/env python3
"""A LM cut's first bfloat16 gradients on one GPU against the CPU's, with
cuBLAS's reduced-precision reductions of bfloat16 GEMMs allowed (torch's
default) and not.

    python3 tools/probe_bf16_grads.py [--arch xlstm-1.3b]

Initialises the full-width model as ``chip_smoke.py``'s training phases do
(``lm.init`` from ``LM_SEED`` on the card), takes ``chip_smoke.lm_cut`` of
it (xlstm: its first mLSTM and first sLSTM block) and the first loss and
gradients of chip_smoke's cut batch (2 x LM_CUT_SEQ tokens): on the CPU in
float32 and bfloat16, and on the card in bfloat16 with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` True,
then False, then True again.  Prints, for every gradient leaf, each one's
error against the CPU's float32 relative to the leaf's largest magnitude
(``chip_smoke.NOISE_GRAD_SCALE``'s against another leaf's), and the card's
over the CPU's own bfloat16 error: ``chip_smoke``'s xlstm check holds that
ratio under ``BF16_OWN_RATIO``.
"""
import argparse
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    import torch

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.train import loop
    from repro_torch.tree import jax_leaves, jax_leaves_with_paths, tree_map

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=cs.XLSTM_ARCH)
    args = ap.parse_args(argv)
    cs.check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}; torch {torch.__version__}", flush=True)

    cfg = configs.get(args.arch)
    params, buffers = lm.init(cfg, torch.Generator(device="cuda").manual_seed(cs.LM_SEED),
                              device="cuda")
    cut_cfg, cut_p = cs.lm_cut(cfg, params)
    cut_p = tree_map(lambda t: t.clone(), cut_p)
    del params
    cpu_p = tree_map(lambda t: t.detach().to("cpu", copy=True), cut_p)
    cpu_b = tree_map(lambda t: t.detach().to("cpu", copy=True), buffers)
    toks = torch.from_numpy(cs._lm_batch(cfg.vocab, cs.LM_TRAIN_BATCH, cs.LM_CUT_SEQ,
                                         cs.LM_SEED, 0)[0]["tokens"]).to(torch.int64)

    def grads(dtype, p, b, device):
        cut = dataclasses.replace(cut_cfg, dtype=dtype)
        _, g = loop.value_and_grad(lambda p, b, mb: lm.next_token_loss(p, b, cut, mb), p, b,
                                   {"tokens": toks.to(device)})
        return g

    g32 = grads(torch.float32, cpu_p, cpu_b, "cpu")
    paths = [p for p, _ in jax_leaves_with_paths(g32)]
    want = jax_leaves(g32)

    def rel(got):  # each leaf's error against the CPU's float32, relative
        errs = cs._leaf_errors(got, want)
        scale = {p: m for p, (_, m) in zip(paths, errs)}
        return [e / max(m, scale.get(cs.NOISE_GRAD_SCALE.get(p), 0.0), 1e-30)
                for p, (e, m) in zip(paths, errs)]

    own = rel(jax_leaves(grads(torch.bfloat16, cpu_p, cpu_b, "cpu")))
    cols = {}
    for i, reduced in enumerate((True, False, True)):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
        cols[f"card{i + 1}{'+-+'[i]}"] = rel(jax_leaves(grads(torch.bfloat16, cut_p, buffers, "cuda")))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    print(f"{args.arch} cut ({cut_cfg.n_layers} blocks, d {cfg.d_model}), {cs.LM_TRAIN_BATCH} x "
          f"{cs.LM_CUT_SEQ} tokens: bfloat16 gradients against the CPU's float32, relative to "
          f"each leaf's largest; card1+ and card3+ with reduced-precision reductions allowed, card2- not; "
          f"ratio = card / CPU's own bfloat16")
    print(f"{'leaf':44s} {'CPU bf16':>10s} " + " ".join(f"{k:>10s} {'ratio':>6s}" for k in cols))
    for j, path in enumerate(paths):
        print(f"{path:44s} {own[j]:10.6f} " + " ".join(
            f"{v[j]:10.6f} {v[j] / max(own[j], 1e-30):6.3f}" for v in cols.values()))
    limit = [max(cs.LM_GRAD_RTOL["bfloat16"], cs.BF16_OWN_RATIO * o) for o in own]
    for k, v in cols.items():
        worst = max((a / o, p) for a, o, p in zip(v, own, paths) if o > 0)
        print(f"{k}: largest ratio {worst[0]!r} ({worst[1]}); leaves over the larger of "
              f"{cs.LM_GRAD_RTOL['bfloat16']} and {cs.BF16_OWN_RATIO} x the CPU's own: "
              f"{[p for p, a, m in zip(paths, v, limit) if a > m]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
