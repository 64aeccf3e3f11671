"""qwen2-0.5b: 24L d_model=896 14H (kv=2) d_ff=4864 vocab=151936.
GQA with QKV bias. 14 heads do not divide the 16-way model axis ->
attention TP falls back to replication (see dist/sharding.py).
[arXiv:2407.10671]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab=151936,
        act="silu", gated_mlp=True, qkv_bias=True, rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=3, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=512,
        act="silu", gated_mlp=True, qkv_bias=True,
        q_chunk=32, kv_chunk=32, logits_chunk=64,
    )
