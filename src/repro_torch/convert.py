"""Carry the reference package's objects into the port without importing
the reference: specs by duck typing, plans through their JSON schema,
domains through numpy."""
from __future__ import annotations

import json
from typing import Any, Union

import torch

from repro_torch import device as _device
from repro_torch.exec.plan import Plan
from repro_torch.kernels.common import StencilSpec


def spec_from_reference(obj: Any) -> StencilSpec:
    """A port ``StencilSpec`` from anything with ``.name``, ``.ndim``,
    ``.offsets`` and ``.weights`` (the reference's ``StencilSpec``)."""
    return StencilSpec(
        str(obj.name), int(obj.ndim),
        tuple(tuple(int(c) for c in o) for o in obj.offsets),
        tuple(float(w) for w in obj.weights))


def plan_from_reference(plan: Union[str, dict]) -> Plan:
    """A port ``Plan`` from a reference plan's JSON text or its
    ``to_dict()`` dict (the two packages share the schema)."""
    if isinstance(plan, str):
        plan = json.loads(plan)
    return Plan.from_dict(plan)


def domain_from_numpy(a: Any, device: _device.DeviceLike = None) -> torch.Tensor:
    """A numpy array (e.g. ``np.asarray`` of a jax array) as a contiguous
    tensor on ``device`` (default ``"cuda"``; raises without a card unless
    ``device="cpu"``)."""
    return _device.as_domain(a, _device.resolve(device))
