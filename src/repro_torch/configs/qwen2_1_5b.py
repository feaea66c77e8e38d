"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936; GQA, QKV bias, head_dim=128.  [arXiv:2407.10671; hf]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    emb_method="cce",
    emb_budget=151936 * 1536 // 16,
    dtype=torch.bfloat16,
    train_microbatch=32,
)
