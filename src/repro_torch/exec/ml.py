"""ML workloads as Problem adapters: LM decode and the Mamba2 SSD scan — the
port of ``repro/exec/ml.py`` (single instances; the batching surface comes
with the next slice, and until then a ``BatchedProblem`` of them raises
``NotImplementedError`` naming the family).

* :class:`DecodeAttentionProblem` — token-by-token greedy decode of any
  ported family (dense, ssm, hybrid). The time axis is the generated-token
  index; a step is ``models.lm.token_step`` (``Model.decode_step`` + argmax
  + the token written into the output at a device index). The resident
  tier is ``Model.decode_loop``; every tier attends through the
  flash-decode kernel (``kernels/decode_attn.py``) on the card, where the
  model has attention layers.
* :class:`SSMScanProblem` — the SSD scan over one sequence, the chunk index
  as time axis. On the loop tiers the state ``h`` (H, N, P) float32 goes
  through device memory once per chunk; the resident tier runs
  ``kernels/ssm_scan.py``, whose CTAs keep it on chip (in registers) for
  the whole scan.

**The state design.** The port's loop runners (``core.perks``) ping-pong
two sets of buffers the size of the whole state. A decode cache or an SSD
output copied every step would add O(cache) or O(T) traffic to each step,
so the large state tensors are written in place instead: ``initial_state``
copies the problem's cache once (the reference's ``_copy_tree``) and makes
a fresh output buffer, and each step writes only its part — the K/V ring at
``pos % C``, the conv windows and SSM states of a decode cache (advanced in
place), the output at the step's rows, all through device indices — and
returns those same tensors; the small tensors (position, tokens, step
counter, the SSD state h of ``SSMScanProblem``) are new each step. So the
problem's own cache and streams are never written, on any tier. A device
loop's warm-up step before capture runs on a copy of the state
(``core.perks.capture``), and a chunked device loop's chunks continue from
the tensors the last one wrote, so both stay exact.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core.cache_policy import CacheableArray
from repro_torch.exec.problem import Problem, operand_fingerprint
from repro_torch.kernels import ref as kref
from repro_torch.kernels import ssm_scan as kssm
from repro_torch.models import lm
from repro_torch.nn.param import tree_leaves


def _tree_bytes(tree) -> int:
    """Total bytes of a nested dict (or a tensor) of tensors."""
    leaves = tree_leaves(tree) if isinstance(tree, dict) else [tree]
    return int(sum(math.prod(t.shape) * t.element_size() for t in leaves
                   if isinstance(t, torch.Tensor)))


# =============================================================================
# LM decode
# =============================================================================

@dataclasses.dataclass(frozen=True, eq=False)
class DecodeAttentionProblem(Problem):
    """Autoregressive greedy decode of ``n_steps`` tokens as one Problem.

    ``cache`` is a prefilled decode cache (``Model.prefill``);
    ``first_tokens`` (B,) seeds the generation (the argmax of the prefill
    logits, as ``runtime/server.py`` computes it). The steps run on
    ``model.compute_params(params)``, made once per parameter set. One step =
    ``decode_step`` + argmax + the token written into the output, so the
    loop tiers reproduce the per-token serving loop (``oracle``) bit for
    bit, and the resident tier — ``Model.decode_loop`` — is
    token-identical to both.

    ``eos_id`` declares the convergence contract: an instance is done when
    every row's latest token is EOS.
    """

    model: Any                       # repro_torch.models.lm.Model
    params: Any
    cache: Any                       # the dict Model.prefill returns
    first_tokens: torch.Tensor       # (B,) int32
    n_steps: int                     # tokens to generate beyond first_tokens
    eos_id: Optional[int] = None

    kind = "decode"
    #: the reference's resident tier keeps the attention carry on chip (the
    #: flash-decode online-softmax state never goes to device memory)
    carry_names = ("attn_carry",)
    #: on the port every tier attends through the flash-decode kernel, so no
    #: tier moves ``attn_carry``: the planner prices the loop tiers without
    #: it, and resident (``Model.decode_loop``, the device loop's kept graph)
    #: differs from the device loop in its single dispatch only
    carry_on_chip_every_tier = True

    #: cache leaves that are rings (one slot written a step); the rest but
    #: ``pos`` are recurrent state (rewritten every step)
    ring_keys = ("k", "v", "ckv", "shared_k", "shared_v")

    def __post_init__(self):
        dev = self.cache["pos"].device
        object.__setattr__(self, "first_tokens", _device.as_domain(
            self.first_tokens, dev).to(torch.int32))
        object.__setattr__(self, "_cparams",
                           self.model.compute_params(self.params))
        # one step function per model and weights, shared by every problem
        # over them, so the device loop's kept graph (core.perks) is found
        # again on the next execute and the next batch
        object.__setattr__(self, "_step", self.model.memo(
            self._cparams, "tokens", lm.token_step))

    @property
    def name(self) -> str:  # type: ignore[override]
        fp = operand_fingerprint(self.first_tokens, *(
            self.cache[k] for k in self.model.cache_keys()[:2]))
        b = self.first_tokens.shape[0]
        return f"decode_{self.model.cfg.name}_b{b}_n{self.n_steps}_{fp}"

    # -- protocol -------------------------------------------------------------

    def initial_state(self):
        return lm.token_state(self.model, self.cache, self.first_tokens,
                              self.n_steps)

    def step_fn(self):
        return self._step

    def finalize(self, state):
        return lm.token_result(self.model, state)

    def oracle(self):
        """The per-token serving loop (host-loop order): ``decode_step`` +
        argmax per token on a copy of the cache."""
        cache = {k: t.clone() for k, t in self.cache.items()}
        tok = self.first_tokens
        outs = []
        for _ in range(self.n_steps):
            logits, cache = self.model.decode_step(self._cparams, cache, tok)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            outs.append(tok)
        if outs:
            out = torch.stack(outs, dim=1)
        else:
            out = torch.zeros((self.first_tokens.shape[0], 0),
                              dtype=torch.int32, device=tok.device)
        return out, cache

    def convergence(self):
        # retired when every row's latest token is EOS; only the EOS id
        # rides in the params
        if self.eos_id is None:
            return None
        return ((lambda s, eos: torch.all(s[-3] == eos)),
                torch.tensor(self.eos_id, dtype=torch.int32,
                             device=self.first_tokens.device))

    def cacheable_arrays(self, *, fuse_steps: int = 1) -> Sequence[CacheableArray]:
        """The KV-bytes-per-token traffic model: each generated token
        re-reads the whole cache and every weight the step reads (in the
        compute dtype); the ring leaves (``kv_cache``) append one slot per
        step (stores amortise to 1/len), the recurrent leaves
        (``ssm_state``: conv windows and SSM states) are rewritten whole.
        ``attn_carry``, where the model has attention layers, is the
        attention score matrix an unfused step would write and read per
        layer, which the flash-decode kernel keeps on chip — on every tier
        of the port, so the planner charges it to none
        (``carry_on_chip_every_tier``)."""
        cfg = self.model.cfg
        b = int(self.first_tokens.shape[0])
        arrays = [CacheableArray("params", _tree_bytes(self._cparams),
                                 loads_per_step=1.0, stores_per_step=0.0)]
        kv_len = 1
        ring_b = state_b = 0
        for key, leaf in self.cache.items():
            if key in self.ring_keys:
                ring_b += _tree_bytes(leaf)
                if leaf.dim() >= 3:
                    kv_len = max(kv_len, int(leaf.shape[-3]))
            elif key != "pos":
                state_b += _tree_bytes(leaf)
        if ring_b:
            arrays.append(CacheableArray(
                "kv_cache", ring_b, loads_per_step=1.0,
                stores_per_step=1.0 / kv_len))
        if state_b:
            arrays.append(CacheableArray(
                "ssm_state", state_b, loads_per_step=1.0,
                stores_per_step=1.0))
        n_attn = self._n_attn_layers()
        if n_attn and ring_b:
            arrays.append(CacheableArray(
                "attn_carry", b * cfg.n_heads * kv_len * 4,
                loads_per_step=float(n_attn),
                stores_per_step=float(n_attn)))
        return arrays

    def _n_attn_layers(self) -> int:
        """Attention layers a decode step runs: every layer of a dense
        model, one a super-block of a hybrid, none in a pure SSM."""
        cfg = self.model.cfg
        if cfg.family == "dense":
            return cfg.n_layers
        if cfg.family == "hybrid":
            every = max(1, cfg.shared_attn_every or 1)
            return max(1, cfg.n_layers // every)
        return 0

    def resident_scratch_bytes(self) -> int:
        """On-chip memory the fused decode needs live at once: one layer's
        attention scores plus the online-softmax carry (m/l/acc)."""
        cfg = self.model.cfg
        b = int(self.first_tokens.shape[0])
        carry = next((a for a in self.cacheable_arrays()
                      if a.name == "attn_carry"), None)
        scores = carry.bytes if carry is not None else 0
        return scores + b * cfg.n_heads * (cfg.head_dim + 2) * 4

    def domain_bytes(self) -> int:
        return _tree_bytes(self.cache)

    def batch_key(self) -> tuple:
        """Instances share a plan iff they decode the same weights at the
        same shapes for the same budget (the EOS id stays out)."""
        shapes = tuple(sorted((k, tuple(t.shape), str(t.dtype))
                              for k, t in self.cache.items()))
        return ("decode", self.model.cfg.name, id(self.params), shapes,
                tuple(self.first_tokens.shape), self.n_steps)

    # -- tiers ----------------------------------------------------------------

    def run_resident(self, plan):
        """The fused persistent decode, ``Model.decode_loop``: on the card
        the whole generation is one kept CUDA graph. It runs the loop
        tiers' step (``models.lm.token_step``) through the device loop, so
        it replays the device loop's graph when one is kept: on the port the
        two tiers are one mechanism, and the flash-decode carry stays on
        chip on every tier."""
        return self.model.decode_loop(self._cparams, self.cache,
                                      self.first_tokens, self.n_steps)


# =============================================================================
# Mamba2 SSD scan
# =============================================================================

def _ssd_chunk(h_prev, xc, dtc, bc, cc, a, d, out_dtype):
    """One SSD chunk on a single sequence — the chunk decomposition of the
    SSD scan without the batch axis (the loop tiers' step, plain torch).
    xc (C,H,P); dtc (C,H); bc/cc (C,N); h_prev (H,N,P) float32."""
    xc32, dtc32, bc32, cc32 = xc.float(), dtc.float(), bc.float(), cc.float()
    a32, d32 = a.float(), d.float()
    g = dtc32 * a32[None, :]                            # (C,H) log decay
    cum = torch.cumsum(g, dim=0)                        # inclusive
    scores = cc32 @ bc32.T                              # (i,j) c_i . b_j
    li = cum[:, None, :] - cum[None, :, :]              # (i,j,H)
    ck = xc.shape[0]
    causal = torch.tril(torch.ones((ck, ck), dtype=torch.bool,
                                   device=xc.device))
    li = torch.where(causal[:, :, None], li,
                     torch.full((), -math.inf, device=xc.device))
    m = torch.exp(li) * scores[..., None] * dtc32[None]
    y = torch.einsum("ijh,jhp->ihp", m, xc32)
    y = y + torch.exp(cum)[..., None] * torch.einsum("in,hnp->ihp", cc32,
                                                     h_prev)
    y = y + d32[None, :, None] * xc32
    tail = torch.exp(cum[-1:, :] - cum)                 # (C,H)
    upd = torch.einsum("jh,jn,jhp->hnp", tail * dtc32, bc32, xc32)
    h_new = torch.exp(cum[-1])[:, None, None] * h_prev + upd
    return h_new, y.to(out_dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class SSMScanProblem(Problem):
    """The Mamba2 SSD scan over one sequence, the chunk index as time axis.

    One step consumes a ``chunk``-long slice of the streams (x, dt, b, c),
    advances the state ``h`` (H, N, P) float32 and writes the matching rows
    of y. A chunk that does not divide T is shrunk to the largest divisor
    (per-timestep chunks at worst), as the reference does, so every
    sequence length is legal on every tier. The operands are moved to
    ``device`` (default ``"cuda"``; raises without a card unless
    ``device="cpu"``).
    """

    x: torch.Tensor                  # (T, H, P)
    dt: torch.Tensor                 # (T, H)
    a: torch.Tensor                  # (H,)
    b: torch.Tensor                  # (T, N)
    c: torch.Tensor                  # (T, N)
    d: torch.Tensor                  # (H,)
    chunk: int = 128
    device: Optional[_device.DeviceLike] = None

    kind = "ssm"
    carry_names = ("h_state",)

    def __post_init__(self):
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        dev = _device.resolve(self.device)
        object.__setattr__(self, "device", dev)
        for f in ("x", "dt", "a", "b", "c", "d"):
            object.__setattr__(self, f, _device.as_domain(getattr(self, f),
                                                          dev))
        ck = self.chunk_eff
        x, dt, a, b, c, d = self.x, self.dt, self.a, self.b, self.c, self.d
        rows = torch.arange(ck, device=dev)

        def step(state, out):
            h, y, i = state
            idx = i.long() * ck + rows
            h_new, yc = _ssd_chunk(h, x.index_select(0, idx),
                                   dt.index_select(0, idx),
                                   b.index_select(0, idx),
                                   c.index_select(0, idx), a, d, x.dtype)
            y.index_copy_(0, idx, yc)
            return (h_new, y, i + 1)

        object.__setattr__(self, "_step", step)

    @property
    def chunk_eff(self) -> int:
        """Largest chunk <= the requested one that divides T."""
        t = int(self.x.shape[0])
        ck = min(self.chunk, t)
        while ck > 1 and t % ck:
            ck -= 1
        return max(ck, 1)

    @property
    def n_steps(self) -> int:  # type: ignore[override]
        return int(self.x.shape[0]) // self.chunk_eff

    @property
    def name(self) -> str:  # type: ignore[override]
        t, h, p = self.x.shape
        n = self.b.shape[-1]
        fp = operand_fingerprint(self.x, self.dt, self.a, self.b, self.c,
                                 self.d)
        return f"ssm_t{t}_h{h}_p{p}_n{n}_{fp}"

    # -- protocol -------------------------------------------------------------

    def initial_state(self):
        t, h, p = self.x.shape
        n = self.b.shape[-1]
        return (torch.zeros((h, n, p), dtype=torch.float32,
                            device=self.device),
                torch.zeros((t, h, p), dtype=self.x.dtype, device=self.device),
                torch.zeros((), dtype=torch.int32, device=self.device))

    def step_fn(self):
        return self._step

    def finalize(self, state):
        return state[1]

    def oracle(self):
        return kref.ssm_scan(self.x, self.dt, self.a, self.b, self.c, self.d)

    def cacheable_arrays(self, *, fuse_steps: int = 1) -> Sequence[CacheableArray]:
        t, h, p = (int(s) for s in self.x.shape)
        n = int(self.b.shape[-1])
        db = self.x.element_size()
        steps = max(1, self.n_steps)
        in_bytes = (t * h * p + t * h + 2 * t * n) * db
        return [
            # the recurrent state: read and rewritten every chunk on the
            # loop tiers, on chip in the resident kernel
            CacheableArray("h_state", h * n * p * 4,
                           loads_per_step=1.0, stores_per_step=1.0),
            # streamed once over the whole scan: 1/n_steps of the stream
            # per chunk
            CacheableArray("seq_stream", in_bytes,
                           loads_per_step=1.0 / steps, stores_per_step=0.0),
            CacheableArray("y_stream", t * h * p * db,
                           loads_per_step=0.0, stores_per_step=1.0 / steps),
            CacheableArray("ab_coeffs", 2 * h * 4,
                           loads_per_step=1.0, stores_per_step=0.0),
        ]

    def resident_scratch_bytes(self) -> int:
        """On-chip memory the kernel needs live at once: the float32 state
        plus one chunk's input/output tiles (the reference's formula)."""
        t, h, p = (int(s) for s in self.x.shape)
        n = int(self.b.shape[-1])
        db = self.x.element_size()
        ck = self.chunk_eff
        tiles = ck * (2 * h * p + h + 2 * n) * db
        return h * n * p * 4 + tiles

    def domain_bytes(self) -> int:
        return sum(a.bytes for a in self.cacheable_arrays()
                   if a.name != "h_state")

    def batch_key(self) -> tuple:
        return ("ssm", tuple(self.x.shape), str(self.x.dtype),
                int(self.b.shape[-1]), self.chunk_eff,
                operand_fingerprint(self.a, self.d))

    # -- tiers ----------------------------------------------------------------

    def run_resident(self, plan):
        return kssm.ssm_scan(self.x, self.dt, self.a, self.b, self.c, self.d,
                             chunk=self.chunk_eff)
