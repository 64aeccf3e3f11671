"""Parameter substrate: spec trees -> init, the port of ``repro/nn/param.py``.

A model is described once as a nested dict of ``ParamSpec`` leaves (shape,
dtype, initializer, logical axis names). ``init`` materialises it with an
explicit ``torch.Generator``: each leaf draws from its own generator, seeded
from the given generator's seed and the leaf's path, so initialisation does
not depend on the order of the leaves. The values differ from the
reference's (another RNG); ``repro_torch.convert.params_from_reference``
carries the reference's values over where the two must agree.

Logical axes used across the model zoo: "embed", "vocab", "heads",
"kv_heads", "head_dim", "ffn", "expert", "state", "layers" (the stacked
layer dim), None (replicated dim).
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Callable, Iterator, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: Any = torch.float32
    init: str = "normal"          # normal | zeros | ones | scaled
    axes: tuple[Optional[str], ...] = ()
    scale: float = 1.0            # stddev multiplier for normal/scaled

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} rank != shape {self.shape}")


def tree_items(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` for every leaf of a nested dict, paths as
    ``"layers/attn/wq"``, in key order."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from tree_items(v, path)
        else:
            yield path, v


def tree_map(fn: Callable[[Any], Any], tree):
    """A nested dict of the same keys with ``fn`` applied to every leaf."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def _materialize(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "scaled":
        # LeCun-style fan-in scaling on the penultimate dim
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(fan_in)
    else:
        std = 0.02 * spec.scale
    z = torch.randn(spec.shape, generator=gen, device=dev, dtype=torch.float32)
    return (std * z).to(spec.dtype)


def init(spec_tree, generator: torch.Generator):
    """Materialise a spec tree on ``generator``'s device. Leaf ``path``
    draws from a generator seeded with crc32(path) folded into
    ``generator.initial_seed()``."""
    base = generator.initial_seed()

    def leaf_gen(path: str) -> torch.Generator:
        seed = (base * 1_000_003 + zlib.crc32(path.encode())) % (2**63)
        return torch.Generator(device=generator.device).manual_seed(seed)

    vals = {path: _materialize(s, leaf_gen(path))
            for path, s in tree_items(spec_tree)}

    def fill(tree, prefix=""):
        return {k: fill(v, f"{prefix}/{k}" if prefix else k)
                if isinstance(v, dict) else vals[f"{prefix}/{k}"
                                                 if prefix else k]
                for k, v in tree.items()}

    return fill(spec_tree)


def count_params(spec_tree) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(spec_tree)))


def param_bytes(spec_tree) -> int:
    return int(sum(math.prod(s.shape) * s.dtype.itemsize
                   for s in tree_leaves(spec_tree)))
