"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936; qk_norm, GQA, head_dim=128 (decoupled from d_model, as in
the Qwen3 family).  [hf:Qwen/Qwen3-8B; hf]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    emb_method="cce",
    emb_budget=151936 * 2560 // 16,
    dtype=torch.bfloat16,
    train_microbatch=32,
)
