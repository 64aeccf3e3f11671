"""mamba2-780m: 48L d_model=1536, attention-free SSD (state-space duality),
ssm_state=128, vocab=50280. The purest PERKS fit: the SSD recurrence IS
x^{k+1} = F(x^k) along the sequence. [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, head_dim=1,
        d_ff=0, vocab=50280,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=1, n_kv_heads=1, head_dim=1,
        d_ff=0, vocab=512,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=8, chunk=16),
        logits_chunk=64,
    )
