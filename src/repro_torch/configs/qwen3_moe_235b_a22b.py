"""qwen3-moe-235b-a22b: 94L d_model=4096 64H (kv=4) vocab=151936,
MoE 128 experts top-8, d_ff_expert=1536. Expert-parallel over the 16-way
model axis (8 experts/chip). bf16 params + opt to fit the v5e HBM budget.
[hf:Qwen/Qwen3-235B-A22B]"""
import torch
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="dense",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab=151936,
        act="silu", gated_mlp=True, rope_theta=1e6,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
        param_dtype=torch.bfloat16,
        train_accum=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=512,
        act="silu", gated_mlp=True,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96),
        q_chunk=32, kv_chunk=32, logits_chunk=64,
    )
