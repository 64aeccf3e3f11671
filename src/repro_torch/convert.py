"""Carry the reference package's objects into the port without importing
the reference: specs and sparse operators by duck typing, plans through
their JSON schema, domains, model parameters and decode caches through
numpy."""
from __future__ import annotations

import json
from typing import Any, Union

import numpy as np
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


def ell_from_reference(ell: Any, device: _device.DeviceLike = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """ELL planes ``(data, cols)`` as tensors on ``device`` (default
    ``"cuda"``) from the reference's ``EllMatrix`` (anything with ``.data``
    and ``.cols``) or a ``(data, cols)`` pair of arrays (e.g. from
    ``repro.solvers.cg.load_dataset`` or ``spmv_ell.poisson2d_ell``)."""
    data, cols = (ell.data, ell.cols) if hasattr(ell, "cols") else ell
    dev = _device.resolve(device)
    return (_device.as_domain(np.array(data), dev),
            _device.as_domain(np.array(cols), dev))


def sell_from_reference(sell: Any, device: _device.DeviceLike = None):
    """A port ``SellOperator`` on ``device`` from the reference's
    ``SellMatrix`` (anything with ``.perm`` and ``.row_positions()``) or
    its device ``SellOperator`` (anything with ``.positions``)."""
    from repro_torch.solvers.cg import SellOperator
    if not hasattr(sell, "positions"):
        return SellOperator.from_matrix(sell, device)
    dev = _device.resolve(device)

    def put(a):
        return _device.as_domain(np.array(a), dev)   # a copy jax cannot hold

    return SellOperator(put(sell.data), put(sell.cols),
                        put(sell.slice_offsets), put(sell.slice_k),
                        put(sell.positions), int(sell.c), int(sell.k_max),
                        int(sell.n_rows), matrix=sell.matrix)


def _tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """One numpy array (bf16 ones, as numpy holds jax's bfloat16, included)
    as a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device).contiguous()


def params_from_reference(tree: Any, device: _device.DeviceLike = None):
    """The port's parameter tree (nested dicts of tensors, the same keys) on
    ``device`` (default ``"cuda"``) from the reference's parameters as
    numpy arrays (``jax.tree.map(np.asarray, params)``). Stacked leaves
    keep their leading axes: a hybrid's Mamba2 ``layers`` (apps x every x
    ...) come across as they are."""
    dev = _device.resolve(device)

    def conv(t):
        return ({k: conv(v) for k, v in t.items()} if isinstance(t, dict)
                else _tensor_from_numpy(t, dev))

    return conv(tree)


def cache_from_reference(tree: Any, device: _device.DeviceLike = None):
    """A prefilled decode cache from the reference's as numpy arrays, on
    ``device`` (default ``"cuda"``): a dense model's ``{"k", "v", "pos"}``,
    mamba2's ``{"conv", "h", "pos"}`` or a hybrid's ``{"conv", "h",
    "shared_k", "shared_v", "pos"}`` with ``tail_conv``/``tail_h`` where it
    has tail layers; every leaf keeps its shape and dtype (conv windows and
    rings in the compute dtype, states h float32, pos int32)."""
    return params_from_reference(tree, device)
