"""whisper-base: enc-dec, 6L encoder + 6L decoder, d_model=512 8H
d_ff=2048 vocab=51865. Conv audio frontend is a STUB per the assignment
(input_specs provides precomputed frame embeddings); LM-family shape cells
split seq_len 50/50 between encoder frames and decoder tokens.
[arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="encdec",
        n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        head_dim=64, d_ff=2048, vocab=51865,
        act="gelu", gated_mlp=False, norm="layernorm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base-smoke", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=512,
        act="gelu", gated_mlp=False, norm="layernorm",
        q_chunk=32, kv_chunk=32, logits_chunk=64,
    )
