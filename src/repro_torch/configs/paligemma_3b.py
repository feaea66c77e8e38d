"""paligemma-3b [vlm] — gemma-2b text backbone: 18L d_model=2048 8H
(MQA kv=1, head_dim=256) d_ff=16384 vocab=257216.  [arXiv:2407.07726; hf]

The SigLIP vision frontend is a stub, as in the JAX package: ``lm.forward``
takes precomputed patch embeddings (B, 256, d_model), projects them and
prepends them to the text sequence; serving is text-only.  Gemma details:
GELU MLP with biases, sqrt(d) embedding scaling, tied input and output
embeddings (the CCE token table is also the head).
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    act="gelu",
    emb_scale=True,
    tie_embeddings=True,
    n_patches=256,
    rope_theta=10_000.0,
    emb_method="cce",
    emb_budget=257216 * 2048 // 16,
    dtype=torch.bfloat16,
    train_microbatch=32,
)
