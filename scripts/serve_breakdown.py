"""Where the serving path's time goes on the card: the port's Engine path
at an architecture's full width (random weights from a seed; qwen2-0.5b by
default, or mamba2-780m and zamba2-1.2b), one prefill and one decode step
traced with ``torch.profiler`` and the kept graph of the whole generation
timed against the sum of its kernels.

    python3 scripts/serve_breakdown.py [--arch qwen2-0.5b] [--requests 8] \
        [--prompt 128] [--new 32]

Prints JSON lines: the prefill's wall time (CUDA events), its kernels'
summed device time and the device's idle share in it, with the device
time by kernel (top 12, and the SSD scan's share); the device time of one
eager decode step by kernel (top 12, and ``decode_attention``'s share),
the kernels a step launches; and the kept graph's replay time, its
kernels' summed device time and the device's idle share inside the
replay. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import Model
    from repro_torch.configs import get_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    model = Model(cfg)
    params = model.compute_params(model.init(
        torch.Generator(device="cuda").manual_seed(args.seed)))
    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.requests, args.prompt), dtype=np.int32)).cuda()
    logits, cache = model.prefill(params, {"tokens": tokens},
                                  cache_seq=args.prompt + args.new)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        model.prefill(params, {"tokens": tokens},
                      cache_seq=args.prompt + args.new)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    ev = prof.key_averages()
    times = {e.key: e.device_time_total for e in ev
             if e.device_time_total > 0}
    calls = {e.key: e.count for e in ev if e.device_time_total > 0}
    total = sum(times.values())
    scan = sum(v for k, v in times.items() if "ssd_" in k)
    print(json.dumps(dict(
        what=f"one prefill, {args.requests} x {args.prompt} tokens",
        arch=args.arch, card=torch.cuda.get_device_name(0),
        wall_ms=wall_ms, kernels_device_ms=total / 1e3,
        idle_share=max(0.0, 1 - total / 1e3 / wall_ms),
        kernels_launched=sum(calls.values()), ssd_scan_us=scan,
        ssd_scan_share=scan / total if total else None,
        top=[dict(kernel=k[:90], us=v, calls=calls[k]) for k, v in
             sorted(times.items(), key=lambda kv: -kv[1])[:12]])))
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    step_cache = {k: t.clone() for k, t in cache.items()}
    model.decode_step(params, step_cache, first)          # warm
    torch.cuda.synchronize()

    def device_us(events):
        return {e.key: e.device_time_total for e in events
                if e.device_time_total > 0}

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.decode_step(params, step_cache, first)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    times = device_us(ev)
    calls = {e.key: e.count for e in ev if e.device_time_total > 0}
    total = sum(times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1])[:12]
    attn = sum(v for k, v in times.items() if "decode_attn" in k
               or "decode_combine" in k)
    print(json.dumps(dict(
        what="one eager decode step, device time by kernel (us)",
        arch=args.arch,
        card=torch.cuda.get_device_name(0), total_us=total,
        kernels_launched=sum(calls.values()),
        decode_attention_us=attn, decode_attention_share=attn / total,
        top=[dict(kernel=k[:90], us=v, calls=calls[k]) for k, v in top])))

    n = args.new - 1
    toks, _ = model.decode_loop(params, cache, first, n)   # capture
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        model.decode_loop(params, cache, first, n)
        end.record()
        torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end)
    kern_us = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_time_total > 0)
    print(json.dumps(dict(
        what=f"the kept graph of {n} decode steps (Model.decode_loop), "
        f"copies in and out included",
        replay_ms=replay_ms, ms_per_token=replay_ms / n,
        kernels_device_ms=kern_us / 1e3,
        idle_share=max(0.0, 1 - kern_us / 1e3 / replay_ms)
        if kern_us else None)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
