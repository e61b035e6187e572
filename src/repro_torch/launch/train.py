"""Training driver: --arch config + fault-tolerant loop, on torch.

Runs on the card unless ``--device cpu`` (use --smoke for CPU-scale
configs).  Weights are random (seed 0), drawn with the reference's init
scheme; batch ``step`` comes from ``numpy.random.default_rng(step)``, as in
the reference's driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 4 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \
        --steps 6 --batch 2 --seq 32 --device cpu --fail-at 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v2-236b \
        --layers 1 --steps 4 --batch 1 --seq 2048

``--arch`` takes every LM architecture of ``repro_torch.configs``, at smoke
width with ``--smoke`` (the CPU's) and at full width otherwise (the card's):
``tinyllama-1.1b``, ``gemma3-4b``, ``deepseek-7b``, ``qwen2-moe-a2.7b`` and
``deepseek-v2-236b``.  ``--layers N`` cuts the depth to N layers and prints
the cut.  The reference's CLI has no such option: it exists because one card
holds the train state (bf16 parameters and gradients, fp32 moments: 12 B a
parameter) of only so many layers at full width: at B 1 x S 2048 on an 80 GB
card, deepseek-7b 24 of its 30, qwen2-moe-a2.7b 9 of 24, deepseek-v2-236b 1
of 60.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.models.layers import init_params, param_count
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainDriver
from repro_torch.train import build_param_specs, build_train_step, make_train_state


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this many layers")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--fail-at", type=int, default=None, help="inject failure")
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but CUDA is not available")
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family != "lm":
        raise SystemExit("train.py drives LM archs")
    if args.layers:
        print(f"{cfg.name}: reduced n_layers {cfg.n_layers} -> {args.layers}; "
              f"this is not the published model")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    cell = ShapeCell("train", "train", {"seq_len": args.seq, "global_batch": args.batch})
    specs = build_param_specs(cfg, cell)
    print(f"arch={cfg.name} params={param_count(specs)/1e6:.1f}M device={device}")

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(gen, specs, cfg.dtype, device)
    state = make_train_state(params)
    step_fn = build_train_step(
        cfg,
        cell,
        AdamWConfig(warmup_steps=10, total_steps=args.steps),
        remat=args.remat,
        grad_accum=args.grad_accum,
    )

    def make_batch(step: int) -> dict:
        r = np.random.default_rng(step)
        toks = r.integers(0, cfg.vocab, size=(args.batch, args.seq + 1)).astype(np.int32)
        return {
            "tokens": torch.from_numpy(toks[:, :-1].copy()).to(device),
            "targets": torch.from_numpy(toks[:, 1:].copy()).to(device),
        }

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp()
    driver = TrainDriver(
        train_step=step_fn,
        make_batch=make_batch,
        ckpt=CheckpointManager(ckpt_dir, keep=3, async_save=True, device=device),
        ckpt_every=args.ckpt_every,
        fail_at_steps=(args.fail_at,) if args.fail_at else (),
    )
    state, log = driver.run(state, args.steps)
    for e in log:
        if "loss" in e:
            print(f"step {e['step']}: loss {e['loss']:.4f} grad_norm {e['grad_norm']:.4f} "
                  f"lr {e['lr']:.3e} {e['seconds'] * 1e3:.1f} ms")
        else:
            print(f"{e['event']} from step {e['from_step']}")
    losses = [e["loss"] for e in log if "loss" in e]
    print(f"done: {args.steps} steps, loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"ckpts in {ckpt_dir}")


if __name__ == "__main__":
    main()
