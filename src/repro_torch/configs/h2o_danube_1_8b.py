"""h2o-danube-1.8b: 24L d_model=2560 32H (kv=8) d_ff=6912 vocab=32000.
Llama+Mistral mix with sliding-window attention. [arXiv:2401.16818]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
        d_ff=6912, vocab=32000,
        act="silu", gated_mlp=True, window=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        act="silu", gated_mlp=True, window=32,
        q_chunk=32, kv_chunk=32, logits_chunk=64,
    )
