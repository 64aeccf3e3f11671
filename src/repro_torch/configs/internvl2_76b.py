"""internvl2-76b: 80L d_model=8192 64H (kv=8) d_ff=28672 vocab=128256.
InternViT frontend is a STUB (input_specs provides 256 patch embeddings
overlaid on the token prefix); backbone is the LLaMA3-70B-shaped LM.
[arXiv:2404.16821]"""
import torch
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=28672, vocab=128256,
        act="silu", gated_mlp=True, rope_theta=5e5, vision_prefix=256,
        param_dtype=torch.bfloat16,
        train_accum=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        act="silu", gated_mlp=True, vision_prefix=8,
        q_chunk=32, kv_chunk=32, logits_chunk=64,
    )
