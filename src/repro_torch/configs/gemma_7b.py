"""gemma-7b: 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.
GeGLU, head_dim=256, embeddings scaled by sqrt(d). [arXiv:2403.08295]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
        d_ff=24576, vocab=256000,
        act="gelu", gated_mlp=True, embed_scale=True, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512,
        act="gelu", gated_mlp=True, embed_scale=True,
        q_chunk=32, kv_chunk=32, logits_chunk=64,
    )
