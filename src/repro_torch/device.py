"""Where the port's entry points run: on the card unless the caller asks for
the CPU."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``device``, with ``None`` meaning ``"cuda"``. Raises ``RuntimeError``
    when that is a CUDA device and no CUDA device is present: the port never
    moves to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; the port runs on the card unless "
            "the caller passes device='cpu'")
    return dev


def as_domain(a, device: Optional[torch.device]) -> torch.Tensor:
    """``a`` (a tensor or anything numpy takes) as a contiguous tensor on
    ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.to(device).contiguous()
