"""The predicted-against-measured drift ledger, a persisted tuning
database: the port of ``repro/obs/ledger.py``.

Every measurement records ``(problem key, device, torch, CUDA) -> plan
signature -> (predicted_s, measured_s, prediction_ratio)`` into a JSON
file that

* ``autotune(ledger=...)`` reads to skip re-measuring plans it has timed
  on this device with this torch and CUDA (and writes every fresh
  measurement back, the winner included);
* ``plan_candidates(ledger=...)`` consults to re-rank candidates: measured
  evidence outranks the performance model's projection;
* :meth:`DriftLedger.drift_report` mines for plans whose measured/predicted
  ratio departs a threshold.

Where the reference keys entries by chip and JAX version, the port keys
them by the device's name (``torch.cuda.get_device_name`` of the
problem's card, or the planning ``Chip``'s name for a problem on the CPU),
``torch.__version__`` and ``torch.version.cuda``. ``problem_key`` and
``plan_signature`` give the reference's strings for the same problem and
plan: the problem key is built from ``Problem.name`` (which embeds the
operand fingerprint) plus batch and step counts, never from ``id()``-
bearing batch keys, so a ledger written by one process is read by the
next.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Optional

import torch

SCHEMA_VERSION = 1

#: measured/predicted drift beyond which ``drift_report`` flags a plan
#: (either direction: 4x slower or 4x faster than projected both mean the
#: model no longer describes this device/problem pair).
DEFAULT_DRIFT_THRESHOLD = 4.0


def device_name(problem, chip: str) -> str:
    """The device a problem runs on, for the ledger's key: the card's name
    (``torch.cuda.get_device_name``) for a problem on a CUDA device, else
    ``chip``, the planning chip's name. A batched problem runs on its
    instances' device."""
    dev = getattr(getattr(problem, "template", problem), "device", None)
    if isinstance(dev, torch.device) and dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return chip


def problem_key(problem) -> str:
    """Content-stable identity of a problem instance for the ledger.

    ``Problem.name`` already folds the family, size, and (for operator
    problems) a content fingerprint of the operands; batch width and step
    count complete the key. Deliberately NOT ``Problem.batch_key()`` —
    that tuple may carry ``id()``\\ s, which do not survive a process.
    """
    return f"{problem.name}_b{problem.batch}_s{problem.n_steps}"


def plan_signature(plan) -> str:
    """Compact stable identity of *how* a plan runs — every field that
    changes the executed program, none of the planner metadata
    (``predicted_s`` et al. are values, not identity)."""
    parts = [plan.tier, f"t{plan.fuse_steps}", f"b{plan.batch}"]
    if plan.schedule != "shallow":
        # the resident tier's blocking schedule changes the executed
        # kernel; "shallow" stays implicit, as in the reference
        parts.append(plan.schedule)
    if plan.sync_every is not None:
        parts.append(f"sync{plan.sync_every}")
    if plan.cached_rows is not None:
        parts.append(f"rows{plan.cached_rows}")
    if plan.policy:
        parts.append(plan.policy.lower())
    if plan.block_rows is not None:
        parts.append(f"bm{plan.block_rows}")
    if plan.tier == "distributed":
        parts.append(f"ax{plan.shard_axis}:{plan.partition}")
        if plan.fuse_reductions:
            parts.append("fusedred")
        if plan.s_step > 1:
            parts.append(f"s{plan.s_step}")
    if plan.precision != "uniform":
        parts.append(plan.precision)
    return "-".join(parts)


def prediction_ratio(predicted_s: Optional[float],
                     measured_s: float) -> Optional[float]:
    """measured/predicted: ``None`` only when there is no prediction; a
    predicted 0.0 reports ``inf`` rather than passing as unmeasured (the
    contract of ``TimingRow``)."""
    if predicted_s is None:
        return None
    if predicted_s == 0.0:
        return math.inf if measured_s > 0.0 else 1.0
    return measured_s / predicted_s


@dataclasses.dataclass
class LedgerRecord:
    """One (problem, device, torch, plan) measurement."""

    predicted_s: Optional[float]
    measured_s: float
    count: int = 1
    plan: Optional[dict] = None          # Plan.to_dict() of the measured plan

    @property
    def prediction_ratio(self) -> Optional[float]:
        return prediction_ratio(self.predicted_s, self.measured_s)

    def to_dict(self) -> dict[str, Any]:
        r = self.prediction_ratio
        return {"predicted_s": self.predicted_s,
                "measured_s": self.measured_s,
                "prediction_ratio": (None if r is None
                                     else ("inf" if math.isinf(r) else r)),
                "count": self.count, "plan": self.plan}

    @classmethod
    def from_dict(cls, d: dict) -> "LedgerRecord":
        return cls(predicted_s=d.get("predicted_s"),
                   measured_s=d["measured_s"], count=d.get("count", 1),
                   plan=d.get("plan"))


class DriftLedger:
    """Persisted ``(problem, device, torch) -> plan -> timing`` database.

    ``path=None`` keeps the ledger in memory (tests); with a path, every
    mutation autosaves (the file is small JSON and the write keeps the
    ledger crash-consistent with what autotune believes it knows).

    ``hits``/``misses`` count lookup outcomes — the ``hits`` counter is
    how the tests prove a second ``autotune()`` skipped re-measurement.
    """

    def __init__(self, path: Optional[str] = None, *, autosave: bool = True):
        self.path = path
        self.autosave = autosave
        self.hits = 0
        self.misses = 0
        # entry key -> {"best": sig|None, "plans": {sig: LedgerRecord}}
        self._entries: dict[str, dict] = {}
        if path is not None and os.path.exists(path):
            self._load(path)

    # -- persistence ----------------------------------------------------------

    def _load(self, path: str) -> None:
        with open(path) as f:
            doc = json.load(f)
        if doc.get("version") != SCHEMA_VERSION:
            raise ValueError(
                f"ledger {path}: schema version {doc.get('version')!r} "
                f"!= {SCHEMA_VERSION}")
        for key, ent in doc.get("entries", {}).items():
            self._entries[key] = {
                "best": ent.get("best"),
                "plans": {sig: LedgerRecord.from_dict(r)
                          for sig, r in ent.get("plans", {}).items()},
            }

    def to_dict(self) -> dict[str, Any]:
        return {
            "version": SCHEMA_VERSION,
            "entries": {
                key: {"best": ent["best"],
                      "plans": {sig: rec.to_dict()
                                for sig, rec in ent["plans"].items()}}
                for key, ent in sorted(self._entries.items())
            },
        }

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if path is None:
            return
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    def _autosave(self) -> None:
        if self.autosave:
            self.save()

    # -- keys -----------------------------------------------------------------

    @staticmethod
    def entry_key(problem, chip: str) -> str:
        return (f"{problem_key(problem)}|{device_name(problem, chip)}"
                f"|torch{torch.__version__}|cuda{torch.version.cuda}")

    def _entry(self, problem, chip: str) -> dict:
        key = self.entry_key(problem, chip)
        ent = self._entries.get(key)
        if ent is None:
            ent = {"best": None, "plans": {}}
            self._entries[key] = ent
        return ent

    def __len__(self) -> int:
        return sum(len(e["plans"]) for e in self._entries.values())

    # -- recording / lookup ----------------------------------------------------

    def record(self, problem, plan, measured_s: float) -> LedgerRecord:
        """Record one measurement of ``plan`` on ``problem`` (keyed by the
        problem's device, or the plan's own chip on the CPU); repeated
        measurements overwrite the timing and bump ``count``."""
        ent = self._entry(problem, plan.chip)
        sig = plan_signature(plan)
        rec = ent["plans"].get(sig)
        if rec is None:
            rec = LedgerRecord(predicted_s=plan.predicted_s,
                               measured_s=float(measured_s),
                               plan=plan.to_dict())
            ent["plans"][sig] = rec
        else:
            rec.predicted_s = plan.predicted_s
            rec.measured_s = float(measured_s)
            rec.count += 1
            rec.plan = plan.to_dict()
        self._autosave()
        return rec

    def lookup(self, problem, plan) -> Optional[LedgerRecord]:
        """The stored record for (problem, its device, this torch and
        CUDA, plan) or None; counts into ``hits``/``misses``."""
        ent = self._entries.get(self.entry_key(problem, plan.chip))
        rec = None if ent is None else ent["plans"].get(plan_signature(plan))
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    def set_best(self, problem, plan) -> None:
        """Remember ``plan`` as the measured winner for this problem and
        device."""
        self._entry(problem, plan.chip)["best"] = plan_signature(plan)
        self._autosave()

    def best_signature(self, problem, chip: str) -> Optional[str]:
        ent = self._entries.get(self.entry_key(problem, chip))
        return None if ent is None else ent["best"]

    # -- planner integration ---------------------------------------------------

    def rerank(self, problem, candidates: list) -> list:
        """Measured evidence outranks the projection: candidates this
        ledger has timed (same problem, device, torch) sort first by measured
        seconds; unmeasured candidates keep their projected order after
        them. A ledger that knows nothing returns the list unchanged."""
        measured = {}
        for c in candidates:
            ent = self._entries.get(self.entry_key(problem, c.chip))
            rec = None if ent is None else ent["plans"].get(plan_signature(c))
            if rec is not None:
                measured[id(c)] = rec.measured_s
        if not measured:
            return list(candidates)
        known = sorted((c for c in candidates if id(c) in measured),
                       key=lambda c: measured[id(c)])
        unknown = [c for c in candidates if id(c) not in measured]
        return known + unknown

    # -- drift -----------------------------------------------------------------

    def drift_report(self, threshold: float = DEFAULT_DRIFT_THRESHOLD
                     ) -> list[dict]:
        """Plans whose measured/predicted ratio departs ``threshold`` in
        either direction (ratio > threshold or < 1/threshold), worst
        first. Each row carries enough to replan: the entry key, the plan
        signature + dict, and the three numbers. Rows with no prediction
        are skipped (nothing to drift from)."""
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1.0, got {threshold}")
        out = []
        for key, ent in self._entries.items():
            for sig, rec in ent["plans"].items():
                r = rec.prediction_ratio
                if r is None:
                    continue
                if r > threshold or r < 1.0 / threshold:
                    out.append({
                        "key": key, "plan_signature": sig,
                        "predicted_s": rec.predicted_s,
                        "measured_s": rec.measured_s,
                        "prediction_ratio": r,
                        "plan": rec.plan,
                    })
        severity = lambda row: (row["prediction_ratio"]
                                if row["prediction_ratio"] >= 1.0
                                else 1.0 / max(row["prediction_ratio"],
                                               1e-300))
        return sorted(out, key=severity, reverse=True)

    def records(self) -> list[tuple[str, str, LedgerRecord]]:
        """Every (entry key, plan signature, record), in key order."""
        return [(key, sig, rec)
                for key, ent in sorted(self._entries.items())
                for sig, rec in sorted(ent["plans"].items())]
