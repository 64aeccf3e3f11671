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

``run_batch`` returns the stats dict.

:func:`start_metrics_server` serves any :class:`repro_torch.obs.MetricsRegistry`
(the ambient one by default) over HTTP in the Prometheus text exposition
format, from a daemon thread bound to the address the caller gives: point
a scraper at ``GET /metrics``.
"""
from __future__ import annotations

import dataclasses
import http.server
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.exec import DecodeAttentionProblem, execute, plan
from repro_torch.models.lm import Model


class MetricsServer:
    """A daemon-threaded HTTP server serving one registry at /metrics."""

    def __init__(self, registry: obs.MetricsRegistry, host: str, port: int):
        self.registry = registry

        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.rstrip("/") != "/metrics":
                    self.send_error(404, "only /metrics is served here")
                    return
                body = server.registry.prometheus_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):     # scrapes are not stdout events
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_metrics_server(registry: Optional[obs.MetricsRegistry] = None, *,
                         host: str = "127.0.0.1",
                         port: int = 0) -> MetricsServer:
    """Serve ``registry`` (default: the ambient metrics registry) at
    ``GET /metrics`` in Prometheus text format on ``host``:``port``
    (``port=0`` picks a free port; read it back from ``.port``). The server
    runs on a daemon thread; call ``.close()`` (or use it as a context
    manager) to stop it."""
    if registry is None:
        registry = obs.get_metrics()
    return MetricsServer(registry, host, port)


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
