"""Mamba2 (SSD) blocks and the pure-SSM decoder family (mamba2-780m): the
port of ``repro/models/mamba2.py``.

Parameters keep the reference's tree (the blocks' weights stacked on a
leading "layers" axis, which the layer loop indexes). The prefill's chunk
scan is ``nn.ssd.ssd_chunked``: on the card the hand-written SSD kernel
(``csrc/ssm_scan.cu``), one launch a layer, which returns the final state h
for the decode cache. A decode step advances each layer's conv window and
state h **in place** in the cache tensors (the reference returns a new
cache from a donated one: the same contents), so a captured decode loop
holds one copy of the state, not one a step; ``pos`` is a new tensor.
Sharding constraints of the reference are no-ops on one device and are not
kept.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.nn import layers as L
from repro_torch.nn.param import ParamSpec, tree_map
from repro_torch.nn.ssd import (causal_conv1d, causal_conv1d_step,
                                ssd_chunked, ssd_step)


def mamba_block_spec(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.n_heads(d)
    n = s.d_state
    conv_ch = di + 2 * n            # conv runs over [x, B, C]
    dt_ = cfg.param_dtype
    return {
        "norm": L.rmsnorm_spec(d, dt_),
        # in_proj -> [z (di), xBC (di + 2N), dt (H)]
        "in_proj": ParamSpec((d, 2 * di + 2 * n + h), dt_, "scaled",
                             ("embed", "ffn")),
        "conv_w": ParamSpec((s.conv_kernel, conv_ch), dt_, "scaled",
                            (None, "ffn")),
        "conv_b": ParamSpec((conv_ch,), dt_, "zeros", ("ffn",)),
        "a_log": ParamSpec((h,), dt_, "zeros", (None,)),
        "dt_bias": ParamSpec((h,), dt_, "zeros", (None,)),
        "d_skip": ParamSpec((h,), dt_, "ones", (None,)),
        "out_norm": L.rmsnorm_spec(di, dt_),
        "out_proj": ParamSpec((di, d), dt_, "scaled", ("ffn", "embed")),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    n = s.d_state
    h = s.n_heads(cfg.d_model)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xbc, dt, di, n, h


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _decay(p):
    return -torch.exp(p["a_log"].float())


def mamba_block(p, cfg: ModelConfig, x, *, return_state: bool = False):
    """x (B, S, d) -> (B, S, d), the prefill path (chunked SSD). With
    ``return_state`` also returns (conv_state (B, K-1, conv_ch), h_final
    (B, H, N, P) float32) for serving: the last K-1 *raw* xBC rows (before
    the SiLU; zeros before the prompt where it is shorter) and the scan's
    final state."""
    s = cfg.ssm
    cd = cfg.compute_dtype
    bsz, seq, _ = x.shape
    xn = L.rmsnorm(p["norm"], x)
    zxbcdt = xn.to(cd) @ p["in_proj"].to(cd)
    z, xbc_raw, dt, di, n, h = _split_proj(cfg, zxbcdt)

    xbc = L.act_fn("silu")(causal_conv1d(xbc_raw, p["conv_w"].to(cd),
                                         p["conv_b"].to(cd)))
    xs = xbc[..., :di].reshape(bsz, seq, h, s.head_dim)
    b_in = xbc[..., di:di + n]
    c_in = xbc[..., di + n:]
    dt = _softplus(dt.float() + p["dt_bias"].float())

    y, h_final = ssd_chunked(xs, dt, _decay(p), b_in, c_in,
                             p["d_skip"].float(), chunk=s.chunk,
                             return_state=True)
    y = y.reshape(bsz, seq, di)
    y = L.rmsnorm(p["out_norm"], y) * L.act_fn("silu")(z)
    out = y.to(cd) @ p["out_proj"].to(cd)
    if return_state:
        k1 = s.conv_kernel - 1
        tail = xbc_raw[:, max(0, seq - k1):, :]
        conv_state = torch.nn.functional.pad(tail, (0, 0, k1 - tail.shape[1],
                                                    0))
        return out, (conv_state, h_final)
    return out


def mamba_block_step(p, cfg: ModelConfig, state, x1):
    """One decode step. state = (conv_state (B,K-1,conv_ch), h (B,H,N,P)),
    both advanced in place (the reference returns them new); x1 (B, d).
    Returns out (B, d)."""
    s = cfg.ssm
    cd = cfg.compute_dtype
    bsz = x1.shape[0]
    conv_state, h_state = state
    xn = L.rmsnorm(p["norm"], x1)
    zxbcdt = xn.to(cd) @ p["in_proj"].to(cd)
    z, xbc, dt, di, n, h = _split_proj(cfg, zxbcdt)

    new_conv, xbc = causal_conv1d_step(conv_state, xbc, p["conv_w"].to(cd),
                                       p["conv_b"].to(cd))
    conv_state.copy_(new_conv)
    xbc = L.act_fn("silu")(xbc)
    xs = xbc[..., :di].reshape(bsz, h, s.head_dim)
    b_in = xbc[..., di:di + n]
    c_in = xbc[..., di + n:]
    dt = _softplus(dt.float() + p["dt_bias"].float())

    h_new, y = ssd_step(h_state, xs, dt, _decay(p), b_in, c_in,
                        p["d_skip"].float())
    h_state.copy_(h_new)
    y = y.reshape(bsz, di)
    y = L.rmsnorm(p["out_norm"], y) * L.act_fn("silu")(z)
    return y.to(cd) @ p["out_proj"].to(cd)


def mamba_layers(cfg: ModelConfig, x, layers, *, collect_state: bool):
    """Run the Mamba2 blocks ``layers`` (a list of weight trees) over x (B,
    S, d), each added to the residual. With ``collect_state`` also returns
    the stacked (conv, h) of the blocks."""
    convs, hs = [], []
    for lp in layers:
        if collect_state:
            out, (conv, h) = mamba_block(lp, cfg, x, return_state=True)
            convs.append(conv)
            hs.append(h)
        else:
            out = mamba_block(lp, cfg, x)
        x = x + out.to(x.dtype)
    if collect_state:
        return x, (torch.stack(convs), torch.stack(hs))
    return x


def mamba_layers_step(cfg: ModelConfig, x, layers, conv, h):
    """One decode step through the blocks ``layers``, block i advancing
    conv[i] and h[i] in place. x (B, d) -> x."""
    for i, lp in enumerate(layers):
        x = x + mamba_block_step(lp, cfg, (conv[i], h[i]), x).to(x.dtype)
    return x


def stack_params(stacked, n: int):
    """The ``n`` weight trees of a stacked tree, as views."""
    return [tree_map(lambda a, i=i: a[i], stacked) for i in range(n)]


# -- pure-SSM LM (mamba2-780m) ---------------------------------------------------

def params_spec(cfg: ModelConfig):
    return {
        "embed": L.embedding_spec(cfg.vocab, cfg.d_model, cfg.param_dtype),
        "layers": tfm.stack_specs(mamba_block_spec(cfg), cfg.n_layers),
        "final_norm": tfm.norm_spec(cfg),
    }


def forward_hidden(params, cfg: ModelConfig, tokens, vision_embeds=None):
    x = tfm.embed_tokens(params, cfg, tokens, vision_embeds)
    x = mamba_layers(cfg, x, stack_params(params["layers"], cfg.n_layers),
                     collect_state=False)
    return (tfm.apply_norm(cfg, params["final_norm"], x),
            torch.zeros((), device=x.device))


def prefill(params, cfg: ModelConfig, tokens, vision_embeds=None,
            cache_seq: Optional[int] = None):
    """Forward over the prompt collecting the SSM and conv states per layer.
    Returns (last-token logits (B, V) float32, cache at pos = S)."""
    s = tokens.shape[1]
    x = tfm.embed_tokens(params, cfg, tokens, vision_embeds)
    x, (conv, h) = mamba_layers(
        cfg, x, stack_params(params["layers"], cfg.n_layers),
        collect_state=True)
    x = tfm.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(params["embed"], x[:, -1], cfg.compute_dtype)
    pos = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    return logits, {"conv": conv, "h": h, "pos": pos}


def state_spec(cfg: ModelConfig, lead: tuple, batch: int):
    """The conv window and state h of blocks stacked on ``lead``, as meta
    tensors."""
    s = cfg.ssm
    d = cfg.d_model
    di, n, h = s.d_inner(d), s.d_state, s.n_heads(d)
    return {
        "conv": torch.empty(lead + (batch, s.conv_kernel - 1, di + 2 * n),
                            dtype=cfg.compute_dtype, device="meta"),
        "h": torch.empty(lead + (batch, h, n, s.head_dim),
                         dtype=torch.float32, device="meta"),
    }


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int):
    """The decode cache's shapes and dtypes as meta tensors."""
    spec = state_spec(cfg, (cfg.n_layers,), batch)
    spec["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return spec


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Zeroed decode state on ``device``."""
    return {k: torch.zeros(t.shape, dtype=t.dtype, device=device)
            for k, t in cache_spec(cfg, batch, seq_len).items()}


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """One-token decode. tokens (B,) -> (logits (B, V) float32, cache): the
    conv windows and states advanced in place, a new ``pos``."""
    x = tfm.embed_tokens(params, cfg, tokens[:, None])[:, 0]
    x = mamba_layers_step(cfg, x, stack_params(params["layers"],
                                               cfg.n_layers),
                          cache["conv"], cache["h"])
    x = tfm.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(params["embed"], x, cfg.compute_dtype)
    return logits, {"conv": cache["conv"], "h": cache["h"],
                    "pos": cache["pos"] + 1}
