"""The ``Problem`` protocol: what a workload exposes to the executor — the
port of ``repro/exec/problem.py``, with its batching surface
(``payload``/``with_payload``/``batch_key``/``array_scales_with_batch``,
read by ``exec/batch.py``).
"""
from __future__ import annotations

import abc
import dataclasses
import zlib
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cache_policy import CacheableArray


def _dtype_name(a) -> str:
    dtype = getattr(a, "dtype", None)
    if dtype is None:
        return type(a).__name__
    return str(dtype).replace("torch.", "")


def operand_fingerprint(*operands) -> str:
    """Content digest of solver operands, for cache-safe problem names.

    Folds each operand's shape/dtype plus up to 16 evenly spaced element
    values into one crc32, as the reference does; dtypes are named as numpy
    names them, so equal data gives the same digest in both packages.
    Opaque callables contribute their identity. A device tensor transfers
    at most 16 elements.
    """
    h = zlib.crc32(b"operands")
    for a in operands:
        if a is None:
            h = zlib.crc32(b"|none", h)
            continue
        if callable(a) and not hasattr(a, "shape"):
            h = zlib.crc32(f"|fn:{id(a):x}".encode(), h)
            continue
        shape = tuple(int(d) for d in getattr(a, "shape", ()))
        h = zlib.crc32(repr((shape, _dtype_name(a))).encode(), h)
        sample = _sample_elements(a, shape)
        if sample is not None:
            h = zlib.crc32(np.ascontiguousarray(sample).tobytes(), h)
    return f"{h:08x}"


def _leaves(x) -> list:
    """The tensors of a payload: a tensor, or a (nested) tuple of them."""
    if isinstance(x, (tuple, list)):
        return [t for e in x for t in _leaves(e)]
    return [x]


def _sample_elements(a, shape, k: int = 16):
    """Up to ``k`` evenly spaced elements of a concrete array as a host
    ndarray; None for anything else."""
    size = int(np.prod(shape)) if shape else 1
    if size == 0:
        return None
    idx = np.linspace(0, size - 1, num=min(k, size)).astype(np.int64)
    if isinstance(a, np.ndarray):
        return a.reshape(-1)[idx]
    if isinstance(a, torch.Tensor) and a.device.type != "meta":
        t = a.reshape(-1)[torch.from_numpy(idx).to(a.device)].cpu()
        if t.dtype == torch.bfloat16:    # numpy has no bf16: the same bytes
            t = t.view(torch.int16)
        return t.numpy()
    return None


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """How a problem shards over one mesh axis (distributed tier).

    ``axis`` is the array axis that row-partitions; ``halo`` is how many
    rows of neighbour data ONE step needs; ``partitions`` lists the
    row-repacking strategies the problem supports.
    """

    axis: int = 0
    halo: int = 0
    partitions: tuple[str, ...] = ("rows",)


class Problem(abc.ABC):
    """One iterative workload, described for the PERKS executor.

    Adapters provide the four abstract pieces; the tier hooks
    ``run_resident``/``run_distributed`` raise by default, and ``supports``
    reports which tiers a problem runs.
    """

    kind: str = "generic"
    name: str = "problem"
    n_steps: int = 0
    batch: int = 1

    @abc.abstractmethod
    def initial_state(self) -> Any:
        """The state fed to the first step."""

    @abc.abstractmethod
    def step_fn(self) -> Callable[[Any, Any], Any]:
        """The step function ``(state, out) -> state`` (one iteration,
        written into ``out``; see ``repro_torch.core.perks``)."""

    @abc.abstractmethod
    def cacheable_arrays(self, *, fuse_steps: int = 1) -> Sequence[CacheableArray]:
        """The arrays/regions a cache plan may keep on chip (paper §III-B)."""

    @abc.abstractmethod
    def oracle(self) -> Any:
        """Reference result after ``n_steps`` (plain torch, host-loop order)."""

    def finalize(self, state: Any) -> Any:
        """Map the final loop state to the user-facing result."""
        return state

    def convergence(self) -> Optional[tuple[Callable[[Any, Any], Any], Any]]:
        """Convergence contract ``(pred, params)``: ``pred(state, params)``
        returns a boolean tensor (True = converged) computed on the device;
        None = no convergence check (run all steps)."""
        return None

    def on_sync(self) -> Optional[Callable[[Any, int], bool]]:
        """Host-sync callback for chunked execution; returning True stops
        early. None = run all steps. Defaults to evaluating
        :meth:`convergence` (one device-to-host read per sync point)."""
        conv = self.convergence()
        if conv is None:
            return None
        pred, params = conv
        return lambda state, k: bool(pred(state, params))

    def halo_spec(self) -> Optional[HaloSpec]:
        """Partition description for the distributed tier (None = cannot
        shard)."""
        return None

    def domain_bytes(self) -> int:
        """Total bytes of the per-step working set."""
        return sum(a.bytes for a in self.cacheable_arrays())

    # -- batching surface (repro_torch.exec.batch) -----------------------------

    def payload(self) -> Any:
        """The per-instance data that varies across a batch (a tensor or a
        tuple of tensors). Everything else (operators, specs, step counts)
        is shared by every instance of a batch; two instances may be
        packed together only when their ``batch_key`` matches. Defaults to
        the initial state."""
        return self.initial_state()

    def with_payload(self, payload: Any) -> "Problem":
        """A copy of this problem carrying ``payload`` instead of its own
        per-instance data (adapters implement it as a dataclass replace)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support batched execution "
            f"(no with_payload)")

    def batch_key(self) -> tuple:
        """Hashable compatibility key: instances may share one batched
        dispatch iff their keys are equal (same family, shapes, dtypes,
        shared operands and step count). The default is conservative: the
        shape and dtype of every payload tensor plus kind, name and
        n_steps."""
        return (self.kind, self.name, self.n_steps,
                tuple((tuple(a.shape), _dtype_name(a))
                      for a in _leaves(self.payload())))

    def array_scales_with_batch(self, name: str) -> bool:
        """Whether the cacheable array ``name`` grows with the batch
        (per-instance state) or is shared by every instance (a common
        operator). Default: everything is per-instance."""
        return True

    def batched_tiers(self) -> tuple[str, ...]:
        """The tiers a batch of instances of this problem runs
        (``exec.batch.BatchedProblem.supports``); none until the family
        has its batched step."""
        return ()

    def batched_step_fn(self) -> Callable[[Any, Any], Any]:
        """The step function over a stacked state (leading axis: the
        instances), one dispatch a step for the whole batch, each lane
        stepping exactly as its instance alone (``core.perks``'s
        signature). Raises for a family without one."""
        raise NotImplementedError(
            f"{type(self).__name__} (family {self.kind!r}) has no batched "
            f"execution in the port: a family batches by defining "
            f"batched_tiers() and batched_step_fn(), as the stencil, CG, "
            f"BiCGStab and GMRES problems do; SSMScanProblem and "
            f"DecodeAttentionProblem have no batching surface yet "
            f"(ROADMAP, Queue 1)")

    #: Why a batch of this family runs no resident tier (the message of a
    #: batched resident plan's ``NotImplementedError``, raised by
    #: ``execute`` through ``BatchedProblem.unsupported``).
    batched_resident_missing = "its resident kernel has no batched launch"

    def run_resident_batched(self, payload: Any, plan) -> Any:
        """The resident tier over B stacked payloads in one launch, for a
        family whose ``batched_tiers()`` holds 'resident'."""
        raise NotImplementedError(
            f"{type(self).__name__} has no run_resident_batched")

    def with_precision(self, precision: str) -> "Problem":
        """A copy of this problem running under ``precision``; a problem
        that hardens no reduction runs 'uniform' only."""
        if precision == "uniform":
            return self
        raise NotImplementedError(
            f"{type(self).__name__} does not support precision="
            f"{precision!r}")

    def run_resident(self, plan) -> Any:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the resident tier")

    def run_distributed(self, plan, mesh) -> Any:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the distributed tier")

    def supports(self, tier: str) -> bool:
        """Which Plan tiers this problem can execute."""
        if tier in ("host_loop", "device_loop"):
            return True
        if tier == "resident":
            return type(self).run_resident is not Problem.run_resident
        if tier == "distributed":
            return type(self).run_distributed is not Problem.run_distributed
        return False
