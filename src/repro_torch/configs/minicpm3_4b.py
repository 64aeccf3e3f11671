"""minicpm3-4b: 62L d_model=2560 40H d_ff=6400 vocab=73448, MLA attention
(q_lora 768, kv_lora 256, 64 nope + 32 rope dims, 64 v dims).
[hf:openbmb/MiniCPM3-4B]"""
from repro_torch.configs.base import ModelConfig, MLAConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=96,
        d_ff=6400, vocab=73448,
        act="silu", gated_mlp=True,
        mla=MLAConfig(q_lora=768, kv_lora=256, nope_dim=64, rope_dim=32,
                      v_dim=64),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=128, vocab=512,
        act="silu", gated_mlp=True,
        mla=MLAConfig(q_lora=32, kv_lora=16, nope_dim=16, rope_dim=8,
                      v_dim=16),
        q_chunk=32, kv_chunk=32, logits_chunk=64,
    )
