"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000; GQA, no-bias, parallel attention+FFN blocks, LayerNorm.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab=256000,
    parallel_block=True,
    norm="layernorm",
    rope_theta=8_000_000.0,
    emb_method="cce",
    emb_budget=256000 * 8192 // 16,
    dtype=torch.bfloat16,
    train_microbatch=16,
)
