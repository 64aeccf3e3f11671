"""llama4-scout-17b-a16e: 48L d_model=5120 40H (kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + one shared expert. 40 heads do not
divide the 16-way model axis -> attention TP replicated (MLP/vocab sharded).
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
import torch
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=202048,
        act="silu", gated_mlp=True, rope_theta=5e5,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                      shared_expert_ff=8192),
        param_dtype=torch.bfloat16,
        train_accum=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=5, n_kv_heads=1, head_dim=16,
        d_ff=96, vocab=512,
        act="silu", gated_mlp=True,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=96,
                      shared_expert_ff=96),
        q_chunk=32, kv_chunk=32, logits_chunk=64,
    )
