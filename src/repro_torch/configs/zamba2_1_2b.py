"""zamba2-1.2b: 38 Mamba2 layers (d_model=2048, ssm_state=64) + one shared
attention block (32H, d_ff=8192) applied every 6 layers (38 = 6x6 + 2 tail).
[arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab=32000,
        act="silu", gated_mlp=True, shared_attn_every=6,
        ssm=SSMConfig(d_state=64, expand=2, head_dim=64),
        train_accum=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512,
        act="silu", gated_mlp=True, shared_attn_every=2,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=8, chunk=16),
        q_chunk=32, kv_chunk=32, logits_chunk=64,
    )
