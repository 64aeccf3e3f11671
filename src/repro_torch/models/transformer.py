"""Dense decoder-only transformer: the dense path of
``repro/models/transformer.py``.

Parameters keep the reference's tree: the layers' weights stacked on a
leading "layers" axis, which the layer loop indexes. ``prefill`` runs the
prompt and collects the decode cache; ``decode_step`` advances one token,
writing its K/V into the cache tensors in place at slot ``pos % C`` (the
reference returns a new cache from a donated one: the same contents) and
attending through ``nn.attention.decode_attention`` — on the card the
hand-written flash-decode kernel, every layer of every token. ``pos``, the
slot, the valid length and the rotary angles (computed once a step, not
once a layer) stay device tensors and the cache is written
through a device index, so a decode step has no host value that changes per
token and can be captured into a CUDA graph.

Multi-head latent attention (``cfg.mla``), mixture-of-experts MLPs
(``cfg.moe``) and vision-prefix embeddings are not ported yet and raise
``NotImplementedError`` (ROADMAP, Queue 1, item 6). Sharding constraints of
the reference are no-ops on one device and are not kept.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import layers as L
from repro_torch.nn.attention import chunked_attention, decode_attention
from repro_torch.nn.param import ParamSpec, tree_map
from repro_torch.nn.rope import rope_tables, rotate

_TODO = "(ROADMAP, Queue 1, item 6: still to port)"


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: multi-head latent attention "
                                  f"(models/mla.py) {_TODO}")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: mixture-of-experts MLPs "
                                  f"(models/moe.py) {_TODO}")


# -- specs -------------------------------------------------------------------

def norm_spec(cfg: ModelConfig, dim: Optional[int] = None):
    dim = dim or cfg.d_model
    return (L.rmsnorm_spec if cfg.norm == "rmsnorm" else L.layernorm_spec)(
        dim, cfg.param_dtype)


def apply_norm(cfg: ModelConfig, p, x):
    return (L.rmsnorm if cfg.norm == "rmsnorm" else L.layernorm)(p, x)


def attn_spec(cfg: ModelConfig):
    _dense_only(cfg)
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    p = {
        "wq": ParamSpec((d, hq * hd), dt, "scaled", ("embed", "heads")),
        "wk": ParamSpec((d, hkv * hd), dt, "scaled", ("embed", "kv_heads")),
        "wv": ParamSpec((d, hkv * hd), dt, "scaled", ("embed", "kv_heads")),
        "wo": ParamSpec((hq * hd, d), dt, "scaled", ("heads", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((hq * hd,), dt, "zeros", ("heads",))
        p["bk"] = ParamSpec((hkv * hd,), dt, "zeros", ("kv_heads",))
        p["bv"] = ParamSpec((hkv * hd,), dt, "zeros", ("kv_heads",))
    return p


def mlp_spec(cfg: ModelConfig):
    _dense_only(cfg)
    return L.mlp_spec(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                      dtype=cfg.param_dtype)


def layer_spec(cfg: ModelConfig):
    return {
        "attn_norm": norm_spec(cfg),
        "attn": attn_spec(cfg),
        "mlp_norm": norm_spec(cfg),
        "mlp": mlp_spec(cfg),
    }


def stack_specs(tree, n: int):
    """Add a leading 'layers' axis to every ParamSpec leaf."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, s.dtype, s.init,
                                        ("layers",) + tuple(s.axes), s.scale),
                    tree)


def params_spec(cfg: ModelConfig):
    return {
        "embed": L.embedding_spec(cfg.vocab, cfg.d_model, cfg.param_dtype),
        "layers": stack_specs(layer_spec(cfg), cfg.n_layers),
        "final_norm": norm_spec(cfg),
    }


def layer_params(params, i: int):
    """Layer ``i``'s weights: views of the stacked tree."""
    return tree_map(lambda a: a[i], params["layers"])


# -- forward -------------------------------------------------------------------

def _qkv(p, cfg: ModelConfig, x):
    cd = cfg.compute_dtype
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xc = x.to(cd)
    q = xc @ p["wq"].to(cd)
    k = xc @ p["wk"].to(cd)
    v = xc @ p["wv"].to(cd)
    if "bq" in p:
        q, k, v = q + p["bq"].to(cd), k + p["bk"].to(cd), v + p["bv"].to(cd)
    return (q.reshape(b, s, hq, hd), k.reshape(b, s, hkv, hd),
            v.reshape(b, s, hkv, hd))


def self_attention(p, cfg: ModelConfig, x, positions, *, collect_kv=False,
                   rope=None):
    """``rope``: the (cos, sin) of ``positions`` (``rope_tables``), computed
    here when not given."""
    _dense_only(cfg)
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    if rope is None:
        rope = rope_tables(positions, cfg.head_dim, theta=cfg.rope_theta)
    q, k = rotate(q, *rope), rotate(k, *rope)
    out = chunked_attention(q, k, v, causal=True, window=cfg.window,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    o = out.reshape(b, s, -1) @ p["wo"].to(cfg.compute_dtype)
    return (o, (k, v)) if collect_kv else o


def embed_tokens(params, cfg: ModelConfig, tokens, vision_embeds=None):
    if vision_embeds is not None:
        raise NotImplementedError(f"{cfg.name}: vision-prefix embeddings "
                                  f"{_TODO}")
    x = L.embed(params["embed"], tokens, cfg.compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _residual_mlp(lp, cfg: ModelConfig, x, h):
    """The attention output ``h`` added to the residual ``x``, then the MLP
    block."""
    x = x + h.to(x.dtype)
    xm = apply_norm(cfg, lp["mlp_norm"], x)
    return x + L.mlp(lp["mlp"], xm, act=cfg.act,
                     compute_dtype=cfg.compute_dtype).to(x.dtype)


# -- prefill -------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, tokens, vision_embeds=None,
            cache_seq: Optional[int] = None):
    """Forward over the prompt, collecting the decode cache.

    Returns (last-token logits (B, V) float32, cache positioned at
    pos = S). ``cache_seq`` sizes the cache for the decoding to follow
    (>= S; defaults to S).
    """
    _dense_only(cfg)
    b, s = tokens.shape
    total = cache_seq or s
    c = cache_len(cfg, total)
    keep = min(c, s)                 # the last `keep` prompt entries are cached
    x = embed_tokens(params, cfg, tokens, vision_embeds)
    positions, rope = prompt_rope(cfg, b, s, tokens.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, k, v = prefill_layer(layer_params(params, i), cfg, x, positions,
                                rope)
        ks.append(k[:, s - keep:])
        vs.append(v[:, s - keep:])
    x = apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(params["embed"], x[:, -1], cfg.compute_dtype)
    pos = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    return logits, {"k": place_ring(ks, c, s), "v": place_ring(vs, c, s),
                    "pos": pos}


def prompt_rope(cfg: ModelConfig, b: int, s: int, device):
    """The prompt's positions (B, S) and their rotary tables."""
    positions = torch.arange(s, device=device)[None, :].expand(b, s)
    return positions, rope_tables(positions, cfg.head_dim,
                                  theta=cfg.rope_theta)


def prefill_layer(lp, cfg: ModelConfig, x, positions, rope):
    """One attention + MLP layer over the prompt (the dense layer, and the
    hybrid's shared block). Returns (x, k, v), k and v rotated."""
    h, (k, v) = self_attention(lp["attn"], cfg,
                               apply_norm(cfg, lp["attn_norm"], x),
                               positions, collect_kv=True, rope=rope)
    return _residual_mlp(lp, cfg, x, h), k, v


def place_ring(entries, c: int, s: int):
    """Stack the layers' last ``keep`` prompt entries (each (B, keep, Hkv,
    D)) into a zeroed ring (n, B, c, Hkv, D). The reference's
    dynamic_update_slice at slot (s - keep) % c clamps the start to
    c - keep."""
    keep = entries[0].shape[1]
    start = min((s - keep) % c, c - keep)
    first = entries[0]
    buf = torch.zeros((len(entries), first.shape[0], c) + first.shape[2:],
                      dtype=first.dtype, device=first.device)
    buf[:, :, start:start + keep] = torch.stack(entries)
    return buf


# -- decode --------------------------------------------------------------------

def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    return min(seq_len, cfg.window) if cfg.window else seq_len


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int):
    """The decode cache's shapes and dtypes as meta tensors."""
    _dense_only(cfg)
    shape = (cfg.n_layers, batch, cache_len(cfg, seq_len), cfg.n_kv_heads,
             cfg.head_dim)
    return {
        "k": torch.empty(shape, dtype=cfg.compute_dtype, device="meta"),
        "v": torch.empty(shape, dtype=cfg.compute_dtype, device="meta"),
        "pos": torch.empty((), dtype=torch.int32, device="meta"),
    }


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Zeroed decode state on ``device``."""
    return {k: torch.zeros(t.shape, dtype=t.dtype, device=device)
            for k, t in cache_spec(cfg, batch, seq_len).items()}


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """One-token decode. tokens (B,) -> (logits (B, V) float32, cache).

    The new K/V are written in place into ``cache["k"]``/``cache["v"]`` at
    ``pos % C`` (ring semantics; for sliding windows the ring is the
    window); attention masks slots beyond min(pos + 1, C). The returned
    cache holds the same K/V tensors and a new ``pos``.
    """
    _dense_only(cfg)
    pos = cache["pos"]
    ks, vs = cache["k"], cache["v"]
    ring = ring_step(cfg, pos, ks.shape[2], tokens.shape[0])
    x = embed_tokens(params, cfg, tokens[:, None])[:, 0]       # (B, d)
    for i in range(cfg.n_layers):
        x = decode_layer(layer_params(params, i), cfg, x, ks[i], vs[i], ring)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(params["embed"], x, cfg.compute_dtype)  # (B, V)
    return logits, {"k": ks, "v": vs, "pos": pos + 1}


def ring_step(cfg: ModelConfig, pos, c: int, b: int):
    """What every attention layer of a decode step shares, from the device
    tensor ``pos``: the ring slot pos % c, the valid length min(pos + 1, c)
    per row, and the rotary tables of position pos."""
    slot = torch.remainder(pos, c).long().reshape(1)
    length = torch.clamp(pos + 1, max=c).to(torch.int32).expand(b).contiguous()
    rope = rope_tables(pos.expand(b, 1), cfg.head_dim, theta=cfg.rope_theta)
    return slot, length, rope


def decode_layer(lp, cfg: ModelConfig, x, kc, vc, ring):
    """One attention + MLP layer of a decode step (the dense layer, and the
    hybrid's shared block): its K/V written in place into the ring ``kc``/
    ``vc`` (B, c, Hkv, D) at the slot, attention through
    ``decode_attention``. x (B, d) -> x."""
    slot, length, rope = ring
    b = x.shape[0]
    xa = apply_norm(cfg, lp["attn_norm"], x)[:, None, :]
    q, k1, v1 = _qkv(lp["attn"], cfg, xa)
    q = rotate(q, *rope)[:, 0]
    k1 = rotate(k1, *rope)
    kc.index_copy_(1, slot, k1)
    vc.index_copy_(1, slot, v1)
    att = decode_attention(q, kc, vc, length=length)
    h = att.reshape(b, -1) @ lp["attn"]["wo"].to(cfg.compute_dtype)
    return _residual_mlp(lp, cfg, x, h)
