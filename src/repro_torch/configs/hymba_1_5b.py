"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer.

32L d_model=1600 25H (GQA kv=5, head_dim=64) d_ff=5504 vocab=32001,
ssm_state=16.  [arXiv:2411.13676; hf]

Hymba runs sliding-window attention in most layers (the SSM branch carries
global context), which is what makes it eligible for long_500k decode:
O(window) KV cache + O(1) SSM state per token.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    ssm_expand=2,
    sliding_window=1024,
    rope_theta=10_000.0,
    # the paper's technique on the vocab table: 16x compression budget
    emb_method="cce",
    emb_budget=32001 * 1600 // 16,
    dtype=torch.bfloat16,
    train_microbatch=32,
)
