"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8,
head_dim=128) expert d_ff=6400 vocab=32064, MoE 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]

Each layer holds 16 SwiGLU experts of 3 x 4096 x 6400 and a (4096, 16)
router: 1.30 B params a layer, 5.2 GB in float32.  The CCE token table
and the factored CCE head are each c=4, T=2, k=1002, dsub=1024 under the
16x budget.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
    capacity_factor=1.25,
    rope_theta=10_000.0,
    emb_method="cce",
    emb_budget=32064 * 4096 // 16,
    dtype=torch.bfloat16,
    train_microbatch=16,
    moe_group=2048,
)
