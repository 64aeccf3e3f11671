"""Zamba2-style hybrid: a Mamba2 backbone and one weight-SHARED attention
block applied every ``shared_attn_every`` layers — the port of
``repro/models/hybrid.py``.

The layer stack is ``n_apps`` super-blocks of (``every`` Mamba2 layers + one
application of the shared attention block), then a tail of leftover Mamba2
layers (zamba2-1.2b: 38 = 6 x 6 + 2). The parameters keep the reference's
two-level stacking (``layers``: apps x every x ...). The shared block's
weights serve every application; each application owns its own slot of the
KV ring (``shared_k``/``shared_v`` (apps, B, c, Hkv, D)). Its decode
attends through ``decode_attention`` — on the card the hand-written
flash-decode kernel (``csrc/decode_attn.cu``), ``n_apps`` launches a token;
the Mamba2 layers' prefill scans run ``csrc/ssm_scan.cu``, one launch a
layer. A decode step writes the ring, the conv windows and the states in
place (``models/mamba2.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2 as mb
from repro_torch.models import transformer as tfm
from repro_torch.nn import layers as L
from repro_torch.nn.param import tree_map


def n_shared_apps(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0


def n_tail(cfg: ModelConfig) -> int:
    return cfg.n_layers - n_shared_apps(cfg) * cfg.shared_attn_every


def params_spec(cfg: ModelConfig):
    block = mb.mamba_block_spec(cfg)
    spec = {
        "embed": L.embedding_spec(cfg.vocab, cfg.d_model, cfg.param_dtype),
        "layers": tfm.stack_specs(
            tfm.stack_specs(block, cfg.shared_attn_every), n_shared_apps(cfg)),
        "final_norm": tfm.norm_spec(cfg),
        "shared_attn": {
            "attn_norm": tfm.norm_spec(cfg),
            "attn": tfm.attn_spec(cfg),
            "mlp_norm": tfm.norm_spec(cfg),
            "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, gated=True,
                              dtype=cfg.param_dtype),
        },
    }
    if n_tail(cfg):
        spec["tail_layers"] = tfm.stack_specs(block, n_tail(cfg))
    return spec


def _groups(params, cfg: ModelConfig):
    """Super-block a's Mamba2 weight trees, for every a (views)."""
    every = cfg.shared_attn_every
    return [mb.stack_params(tree_map(lambda t, a=a: t[a], params["layers"]),
                            every) for a in range(n_shared_apps(cfg))]


def _tail(params, cfg: ModelConfig):
    return mb.stack_params(params["tail_layers"], n_tail(cfg)) if n_tail(
        cfg) else []


def prefill(params, cfg: ModelConfig, tokens, vision_embeds=None,
            cache_seq: Optional[int] = None):
    """Prompt forward collecting the Mamba2 states and each application's
    shared K/V. Returns (last-token logits (B, V) float32, cache at
    pos = S)."""
    b, s = tokens.shape
    c = tfm.cache_len(cfg, cache_seq or s)
    keep = min(c, s)
    x = tfm.embed_tokens(params, cfg, tokens, vision_embeds)
    positions, rope = tfm.prompt_rope(cfg, b, s, tokens.device)
    convs, hs, ks, vs = [], [], [], []
    for group in _groups(params, cfg):
        x, (conv, h) = mb.mamba_layers(cfg, x, group, collect_state=True)
        x, k, v = tfm.prefill_layer(params["shared_attn"], cfg, x, positions,
                                    rope)
        convs.append(conv)
        hs.append(h)
        ks.append(k[:, s - keep:])
        vs.append(v[:, s - keep:])
    cache = {"conv": torch.stack(convs), "h": torch.stack(hs),
             "shared_k": tfm.place_ring(ks, c, s),
             "shared_v": tfm.place_ring(vs, c, s),
             "pos": torch.tensor(s, dtype=torch.int32, device=tokens.device)}
    tail = _tail(params, cfg)
    if tail:
        x, (cache["tail_conv"], cache["tail_h"]) = mb.mamba_layers(
            cfg, x, tail, collect_state=True)
    x = tfm.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(params["embed"], x[:, -1], cfg.compute_dtype)
    return logits, cache


# -- decode state ---------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, seq_len: int):
    """The decode cache's shapes and dtypes as meta tensors."""
    napps, every, tail = n_shared_apps(cfg), cfg.shared_attn_every, n_tail(cfg)
    c = tfm.cache_len(cfg, seq_len)
    ring = (napps, batch, c, cfg.n_kv_heads, cfg.head_dim)
    spec = mb.state_spec(cfg, (napps, every), batch)
    spec["shared_k"] = torch.empty(ring, dtype=cfg.compute_dtype,
                                   device="meta")
    spec["shared_v"] = torch.empty(ring, dtype=cfg.compute_dtype,
                                   device="meta")
    spec["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    if tail:
        spec.update({f"tail_{k}": t for k, t in
                     mb.state_spec(cfg, (tail,), batch).items()})
    return spec


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Zeroed decode state on ``device``."""
    return {k: torch.zeros(t.shape, dtype=t.dtype, device=device)
            for k, t in cache_spec(cfg, batch, seq_len).items()}


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """One-token decode. tokens (B,) -> (logits (B, V) float32, cache): the
    ring written at pos % c, the conv windows and states advanced, all in
    place; a new ``pos``."""
    pos = cache["pos"]
    sk, sv = cache["shared_k"], cache["shared_v"]
    ring = tfm.ring_step(cfg, pos, sk.shape[2], tokens.shape[0])
    x = tfm.embed_tokens(params, cfg, tokens[:, None])[:, 0]
    for a, group in enumerate(_groups(params, cfg)):
        x = mb.mamba_layers_step(cfg, x, group, cache["conv"][a],
                                 cache["h"][a])
        x = tfm.decode_layer(params["shared_attn"], cfg, x, sk[a], sv[a],
                             ring)
    new_cache = dict(cache, pos=pos + 1)
    tail = _tail(params, cfg)
    if tail:
        x = mb.mamba_layers_step(cfg, x, tail, cache["tail_conv"],
                                 cache["tail_h"])
    x = tfm.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(params["embed"], x, cfg.compute_dtype)
    return logits, new_cache
