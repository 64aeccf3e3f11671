"""Serving launcher: batched requests through the PERKS persistent-decode
engine, on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --requests 8 --new-tokens 32

``--arch`` names a dense architecture, ``mamba2-780m`` (ssm) or
``zamba2-1.2b`` (hybrid). The weights are random, from seed 0.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models.lm import Model
from repro_torch.runtime.server import Engine, Request, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--host-loop", action="store_true",
                    help="baseline per-token dispatch instead of PERKS "
                    "(faster for a one-off batch: the persistent mode's "
                    "graph capture is not priced by the planner yet)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    eng = Engine(model, params, ServeConfig(
        max_batch=args.requests, persistent=not args.host_loop))

    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(Request(
            prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                dtype=np.int32),
            max_new_tokens=args.new_tokens))
    toks, stats = eng.run_batch()
    print("generated:", toks.shape)
    for k, v in stats.items():
        print(f"  {k}: {v}")
    return toks, stats


if __name__ == "__main__":
    main()
