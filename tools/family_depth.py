#!/usr/bin/env python3
"""Peak memory of an MoE/MLA family's train step at full width and a given
depth, on one card: what sets the cuts of ``chip_smoke.py``'s FAMILY_TRAIN.

    python3 tools/family_depth.py deepseek-7b:25 qwen2-moe-a2.7b:10
    python3 tools/family_depth.py --unsliced deepseek-v2-236b:1

Each ARCH:LAYERS runs ``chip_smoke.family_train`` (B 1 x S 2048, bf16, one
warm-up and one timed step, without the gradient checks) and prints its
peak memory, or that the step ran out of memory.  With ``--unsliced``, AdamW
updates every leaf whole instead of in slices of 1 GB of fp32 temporaries.
"""
from __future__ import annotations

import argparse
import gc
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", nargs="+", help="ARCH:LAYERS")
    ap.add_argument("--unsliced", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("family_depth: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.optim import adamw

    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}")
    build.build_all()
    torch.zeros(1, device=dev)  # the CUDA context, before the allocator's statistics are reset
    cs.family_checks = lambda *a, **k: {"launches": (0, 0)}
    cs.FAMILY_TRAIN_STEPS = 2
    if args.unsliced:
        adamw.SLICE_BYTES = 1 << 62
    for run in args.runs:
        arch, layers = run.rsplit(":", 1)
        try:
            r = cs.family_train(dev, arch, int(layers))
            print(f"family_depth {arch} {layers} layers{' unsliced' * args.unsliced}: "
                  f"max_memory_allocated {r['max_memory']} step_ms "
                  f"{r['mean_step_s'] * 1e3:.3f}")
        except torch.OutOfMemoryError as e:
            print(f"family_depth {arch} {layers} layers{' unsliced' * args.unsliced}: out of "
                  f"memory with {torch.cuda.memory_allocated(dev)} B allocated "
                  f"({str(e).splitlines()[0]})")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
