"""Model configuration dataclasses shared by every architecture: the port of
``repro/configs/base.py``. Shapes only; the dtypes are torch dtypes where the
reference has ``jnp`` ones."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)."""
    q_lora: int = 768
    kv_lora: int = 256
    nope_dim: int = 64      # per-head non-rotary q/k dims
    rope_dim: int = 32      # decoupled rotary dims (shared k)
    v_dim: int = 64         # per-head value dims


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    shared_expert_ff: int = 0       # 0 = no shared expert (Llama4 has one)
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD block dims."""
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64              # P
    conv_kernel: int = 4
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    act: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    embed_scale: bool = False       # gemma multiplies embeddings by sqrt(d)
    window: Optional[int] = None    # sliding-window attention

    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0      # hybrid (zamba2): shared block cadence

    n_enc_layers: int = 0           # encdec (whisper)
    vision_prefix: int = 0          # vlm (internvl2): stub patch embeddings

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    # execution knobs
    q_chunk: int = 512
    kv_chunk: int = 1024
    logits_chunk: int = 512
    remat: bool = True
    scan_layers: bool = True
    train_accum: int = 1    # gradient-accumulation microbatches per step

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / windowed)."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    @property
    def has_decode(self) -> bool:
        return True

    def n_params(self) -> int:
        """Parameter count, through the port's model stack (the dense, ssm
        and hybrid families so far; the others raise
        ``NotImplementedError``)."""
        from repro_torch.models import lm
        from repro_torch.nn.param import count_params
        return count_params(lm.Model(self).params_spec())

    def n_active_params(self) -> int:
        """Active params per token (MoE counts top_k + shared experts)."""
        n = self.n_params()
        if self.moe is not None:
            e, k = self.moe.n_experts, self.moe.top_k
            per_expert = 3 * self.d_model * self.moe.d_ff_expert
            n -= self.n_layers * (e - k) * per_expert
        return n
