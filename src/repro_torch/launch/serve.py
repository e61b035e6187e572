"""Serving driver: RISP-prefix-cache engine over a request stream, on torch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --smoke --device cpu

``--arch`` takes every LM architecture of ``repro_torch.configs``:
``tinyllama-1.1b``, ``gemma3-4b``, ``deepseek-7b`` (dense MHA),
``qwen2-moe-a2.7b`` (MoE) and ``deepseek-v2-236b`` (MLA + MoE; at full width
its 60 layers do not fit one card, ``--layers`` cuts the depth and prints
the cut).

Weights are random (seed 0), drawn with the reference's init scheme.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.layers import init_params
from repro_torch.models.transformer import lm_specs
from repro_torch.serve import ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this many layers")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--system-len", type=int, default=48)
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but CUDA is not available")
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        print(f"{cfg.name}: reduced n_layers {cfg.n_layers} -> {args.layers}; "
              f"this is not the published model")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(gen, lm_specs(cfg), cfg.dtype, device)
    engine = ServeEngine(
        cfg, params, max_len=args.max_len, chunk=args.chunk, device=device
    )

    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab, size=args.system_len).tolist()
    tot_prefill = tot_skipped = tot_chunks = 0
    for i in range(args.requests):
        user = rng.integers(0, cfg.vocab, size=12).tolist()
        _, st = engine.generate(system + user, max_new_tokens=args.max_new)
        tot_prefill += st.prefill_s
        tot_skipped += st.chunks_skipped
        tot_chunks += st.n_chunks
        print(f"req {i}: skipped {st.chunks_skipped}/{st.n_chunks} chunks, "
              f"prefill {st.prefill_s*1e3:.1f} ms, decode {st.decode_s*1e3:.1f} ms")
    print(f"total: prefill {tot_prefill:.2f}s, chunks skipped "
          f"{tot_skipped}/{tot_chunks}, snapshots {engine.n_snapshots}")


if __name__ == "__main__":
    main()
