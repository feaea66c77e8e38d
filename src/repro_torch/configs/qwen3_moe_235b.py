"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4,
head_dim=128) expert d_ff=1536 vocab=151936, MoE 128 experts top-8,
qk_norm.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    n_experts=128,
    top_k=8,
    capacity_factor=1.25,
    qk_norm=True,
    rope_theta=1_000_000.0,
    emb_method="cce",
    emb_budget=151936 * 4096 // 16,
    dtype=torch.bfloat16,
    train_microbatch=8,
    moe_group=2048,
)
