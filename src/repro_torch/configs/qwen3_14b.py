"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936; qk_norm, GQA, head_dim=128.  [hf:Qwen/Qwen3-8B; hf]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    emb_method="cce",
    emb_budget=151936 * 5120 // 16,
    dtype=torch.bfloat16,
    train_microbatch=16,
)
