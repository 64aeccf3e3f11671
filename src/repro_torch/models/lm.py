"""The LM facade of the port: ``Model`` for the ``"dense"``, ``"ssm"``
(mamba2-780m) and ``"hybrid"`` (zamba2-1.2b) families, after
``repro/models/lm.py``.

``Model`` exposes what the server and the executor consume:

  * ``params_spec`` / ``init`` — the weights' single source of truth, and
    ``compute_params``, the weights as the compute reads them (every matrix
    and bias cast to ``compute_dtype`` once, the norm scales kept);
  * ``prefill`` — the prompt forward that returns the decode cache;
  * ``decode_step`` — one-token serve step (the cache's tensors written in
    place: K/V ring slots, conv windows and SSM states);
  * ``decode_loop`` — the PERKS persistent decode: N greedy tokens in one
    dispatch. On the card that is one kept CUDA graph of the N decode
    steps (``core.perks.device_loop`` of ``token_step``), replayed on every
    later call with the same weights and shapes; on the CPU a plain loop.

The ``encdec`` family, the training loss and sampled decoding are not
ported yet and raise ``NotImplementedError`` (ROADMAP, Queue 1, items
6-7).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import perks
from repro_torch.models import hybrid, mamba2, transformer
from repro_torch.nn import param as P

_TODO = "(ROADMAP, Queue 1, items 6-7: still to port)"
#: Values kept per model (``memo``), least recent dropped.
_KEPT = 8
#: The ported families; ``"encdec"`` (whisper-base) raises.
_FAMILIES = {
    "dense": transformer,
    "ssm": mamba2,
    "hybrid": hybrid,
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family not in _FAMILIES:
            raise NotImplementedError(
                f"{self.cfg.name}: the {self.cfg.family!r} family {_TODO}")
        object.__setattr__(self, "_memo", collections.OrderedDict())

    @property
    def mod(self):
        return _FAMILIES[self.cfg.family]

    # -- params ----------------------------------------------------------

    def params_spec(self):
        return self.mod.params_spec(self.cfg)

    def init(self, generator: torch.Generator):
        """Random weights from ``generator``, on its device."""
        return P.init(self.params_spec(), generator)

    def n_params(self) -> int:
        return P.count_params(self.params_spec())

    def compute_params(self, params):
        """``params`` as the compute reads them: every weight matrix and
        bias cast to ``compute_dtype`` (a leaf already of that dtype is
        kept, not copied; ``params`` itself is returned when every leaf is),
        the norm scales and the SSM blocks' per-head scalars (``a_log``,
        ``dt_bias``, ``d_skip``, which the layers read in float32) as they
        are. The values the layers compute with are the same; only the
        per-use cast is gone. Made once per parameter set (``memo``)."""
        return self.memo(params, "compute", _cast_params)

    # -- training --------------------------------------------------------

    def loss(self, params, batch):
        raise NotImplementedError(f"the training loss {_TODO}")

    # -- serving ----------------------------------------------------------

    def prefill(self, params, batch, cache_seq: Optional[int] = None):
        return self.mod.prefill(params, self.cfg, batch["tokens"],
                                batch.get("vision_embeds"),
                                cache_seq=cache_seq)

    def decode_step(self, params, cache, tokens):
        return self.mod.decode_step(params, self.cfg, cache, tokens)

    def init_cache(self, batch: int, seq_len: int, device=None):
        return self.mod.init_cache(self.cfg, batch, seq_len, device=device)

    def cache_spec(self, batch: int, seq_len: int):
        return self.mod.cache_spec(self.cfg, batch, seq_len)

    def cache_keys(self) -> tuple[str, ...]:
        """The decode cache's leaves, in the order of ``token_step``'s
        state."""
        return tuple(self.cache_spec(1, 1))

    def decode_loop(self, params, cache, first_tokens, n_tokens: int, *,
                    temperature: float = 0.0):
        """PERKS persistent decode: ``n_tokens`` greedy steps in one
        dispatch. Returns (tokens (B, n_tokens) int32, final cache).

        The cache passed in is not written (the reference donates it): the
        loop starts from a copy. On the card the N steps of ``token_step``
        are one CUDA graph, captured on the first call and kept for this
        model, these weights and these shapes; a later call copies its
        state into the graph's buffers and replays it."""
        if temperature > 0.0:
            raise NotImplementedError(f"sampled decoding {_TODO}")
        state = token_state(self, cache, first_tokens, n_tokens)
        step = self.memo(self.compute_params(params), "tokens", token_step)
        return token_result(self, perks.device_loop(step, n_tokens)(state))

    def memo(self, params, kind: str, make):
        """``make(model, params)`` once per (``kind``, parameter set), the
        same object on later calls (the last ``_KEPT`` kept). The step
        functions are made so: the kept CUDA graphs of ``core.perks`` are
        keyed by step function, so every problem over the same weights
        finds its graph again."""
        key = (kind, id(params))
        hit = self._memo.get(key)
        if hit is not None and hit[0] is params:
            self._memo.move_to_end(key)
            return hit[1]
        fn = make(self, params)
        self._memo[key] = (params, fn)
        while len(self._memo) > _KEPT:
            self._memo.popitem(last=False)
        return fn


#: Leaves the layers read in their own dtype, not the compute dtype.
_AS_STORED = ("a_log", "dt_bias", "d_skip")


def _cast_params(model: Model, params):
    cd = model.cfg.compute_dtype

    def cast(tree, norm=False):
        return {k: cast(v, norm or k.endswith("norm"))
                if isinstance(v, dict)
                else (v if norm or k in _AS_STORED else v.to(cd))
                for k, v in tree.items()}

    out = cast(params)
    same = all(a is b for a, b in zip(P.tree_leaves(out),
                                      P.tree_leaves(params)))
    return params if same else out


def token_state(model: Model, cache, first_tokens, n_tokens: int):
    """``token_step``'s starting state from a prefilled cache (copied, so
    the caller's cache is never written): (cache leaves in
    ``model.cache_keys()`` order, tok, toks, i)."""
    first = first_tokens.to(torch.int32)
    b, dev = first.shape[0], first.device
    return (tuple(cache[k].clone() for k in model.cache_keys())
            + (first, torch.zeros((b, n_tokens), dtype=torch.int32,
                                  device=dev),
               torch.zeros((), dtype=torch.int32, device=dev)))


def token_result(model: Model, state):
    """(tokens (B, n) int32, cache) from a ``token_step`` state."""
    *leaves, _, toks, _ = state
    return toks, dict(zip(model.cache_keys(), leaves))


def token_step(model: Model, params):
    """One greedy decode step as a ``core.perks`` step on the state (cache
    leaves..., tok, toks, i): ``decode_step`` + argmax, the token written
    into ``toks`` at column i. The cache's tensors (the K/V rings, the conv
    windows and SSM states) and toks are written in place and returned (a
    copy of the cache each step would move O(cache) bytes a token, and fill
    a captured loop's memory pool); the position, the token and i are new
    tensors. Every tier of ``DecodeAttentionProblem`` and ``decode_loop``
    run it."""
    keys = model.cache_keys()

    def step(state, out):
        *leaves, tok, toks, i = state
        logits, cache = model.decode_step(params, dict(zip(keys, leaves)),
                                          tok)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.index_copy_(1, i.long().reshape(1), nxt[:, None])
        return tuple(cache[k] for k in keys) + (nxt, toks, i + 1)

    return step
