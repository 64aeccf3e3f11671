"""Batched serving with PERKS persistent decode: the ``Engine`` of
``repro/runtime/server.py``.

Requests accumulate into a batch; the engine prefills them together and
generates through the PERKS executor: it wraps the batch as a
:class:`repro_torch.exec.DecodeAttentionProblem`, asks ``plan()`` for the
tier (plans are cached per ``batch_key``, so serving the same shapes again
reuses the decision) and runs ``execute()`` — the resident tier is
``Model.decode_loop``, the whole generation as one kept CUDA graph on the
card. The host-loop mode calls ``decode_step`` per token, for the
comparison. The weights are cast to the compute dtype once, when the
engine is made.

The reference's ``MetricsServer`` and Prometheus counters wait for the
observability slice (ROADMAP, Queue 1, item 4); ``run_batch`` still returns
the stats dict.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.exec import DecodeAttentionProblem, execute, plan
from repro_torch.models.lm import Model


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (prompt_len,) int32
    max_new_tokens: int = 32


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    persistent: bool = True      # PERKS executor vs per-token host loop


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    def __init__(self, model: Model, params, cfg: ServeConfig = ServeConfig()):
        self.model = model
        self.params = params
        self.cfg = cfg
        self._cparams = model.compute_params(params)
        self.device = params["embed"]["table"].device
        self._queue: list[Request] = []
        # plan cache: batch_key -> Plan
        self._plans: dict = {}

    def submit(self, req: Request):
        self._queue.append(req)

    def run_batch(self) -> tuple[np.ndarray, dict]:
        """Serve up to max_batch queued requests (left-padded to one prompt
        length). Returns (generated tokens (B, max_new), stats)."""
        batch = self._queue[:self.cfg.max_batch]
        self._queue = self._queue[self.cfg.max_batch:]
        if not batch:
            raise ValueError("no queued requests")
        plen = max(len(r.prompt) for r in batch)
        new = max(r.max_new_tokens for r in batch)
        prompts = np.stack([
            np.pad(r.prompt, (plen - len(r.prompt), 0)) for r in batch
        ]).astype(np.int32)

        t0 = time.perf_counter()
        tokens = torch.from_numpy(prompts).to(self.device)
        logits, cache = self.model.prefill(self._cparams, {"tokens": tokens},
                                           cache_seq=plen + new)
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        _sync(self.device)
        t_prefill = time.perf_counter() - t0

        t0 = time.perf_counter()
        tier = None
        if self.cfg.persistent:
            prob = DecodeAttentionProblem(
                model=self.model, params=self._cparams, cache=cache,
                first_tokens=first, n_steps=new - 1)
            key = prob.batch_key()
            eplan = self._plans.get(key)
            if eplan is None:
                eplan = plan(prob)
                self._plans[key] = eplan
            tier = eplan.tier
            toks, cache = execute(prob, eplan)
            out = torch.cat([first[:, None], toks], dim=1).cpu().numpy()
        else:
            out_list = [first]
            tok = first
            for _ in range(new - 1):
                logits, cache = self.model.decode_step(self._cparams, cache,
                                                       tok)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                out_list.append(tok)
            out = torch.stack(out_list, dim=1).cpu().numpy()
        t_decode = time.perf_counter() - t0
        mode = "persistent" if self.cfg.persistent else "host_loop"
        stats = {
            "batch": len(batch),
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tok_per_s": len(batch) * new / max(t_decode, 1e-9),
            "mode": mode,
            "tier": tier,
        }
        return out, stats
