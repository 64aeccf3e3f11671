"""Core layers as plain functions over ``ParamSpec``-described weights: the
port of ``repro/nn/layers.py``. Every weight is read through
``.to(compute_dtype)``, which returns the tensor itself when it is already
of that dtype: a model's parameters are cast once
(``repro_torch.models.lm.Model.compute_params``), not at every use."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.param import ParamSpec


# -- normalisation -----------------------------------------------------------

def rmsnorm_spec(dim: int, dtype=torch.float32):
    return {"scale": ParamSpec((dim,), dtype, "ones", ("embed",))}


def rmsnorm(p, x, *, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def layernorm_spec(dim: int, dtype=torch.float32):
    return {
        "scale": ParamSpec((dim,), dtype, "ones", ("embed",)),
        "bias": ParamSpec((dim,), dtype, "zeros", ("embed",)),
    }


def layernorm(p, x, *, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


# -- embedding ---------------------------------------------------------------

def embedding_spec(vocab: int, dim: int, dtype=torch.float32):
    return {"table": ParamSpec((vocab, dim), dtype, "normal",
                               ("vocab", "embed"))}


def embed(p, ids, compute_dtype=torch.bfloat16):
    return p["table"].to(compute_dtype)[ids]


def unembed(p, x, compute_dtype=torch.bfloat16):
    """Tied LM head: logits = x @ table.T, returned in float32."""
    return (x.to(compute_dtype) @ p["table"].to(compute_dtype).T).float()


# -- activations ---------------------------------------------------------------

def _silu(x):
    # jax.nn.silu's definition, x * sigmoid(x), each op rounded to x's
    # dtype. On the CPU the sigmoid is XLA's expansion, 1 / (1 + exp(-x)),
    # each of its ops rounded too, as the reference computes it there: with
    # torch.sigmoid (rounded once) the zamba2 smoke model's bf16 decode
    # drifts past the CPU parity tests' 5e-2 (PERF.md section 7). On the
    # card one sigmoid kernel; in float32 the two agree to rounding.
    if x.device.type == "cpu":
        return x * (1 / (1 + torch.exp(-x)))
    return x * torch.sigmoid(x)


def act_fn(name: str):
    return {
        "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
        "silu": _silu,
        "relu": F.relu,
    }[name]


# -- gated MLP (GeGLU / SwiGLU) ------------------------------------------------

def mlp_spec(d_model: int, d_ff: int, *, gated: bool = True,
             dtype=torch.float32):
    p = {
        "up": ParamSpec((d_model, d_ff), dtype, "scaled", ("embed", "ffn")),
        "down": ParamSpec((d_ff, d_model), dtype, "scaled", ("ffn", "embed")),
    }
    if gated:
        p["gate"] = ParamSpec((d_model, d_ff), dtype, "scaled",
                              ("embed", "ffn"))
    return p


def mlp(p, x, *, act: str = "gelu", compute_dtype=torch.bfloat16):
    xc = x.to(compute_dtype)
    up = xc @ p["up"].to(compute_dtype)
    if "gate" in p:
        h = act_fn(act)(xc @ p["gate"].to(compute_dtype)) * up
    else:
        h = act_fn(act)(up)
    return h @ p["down"].to(compute_dtype)
