"""The dry-run's cuts of the reference's ``train_4k`` cell for every LM
architecture, on the meta device (no card needed): for each, the remat
``dryrun.fit_train`` takes, the cut under one H100's 75 GB (the batch, and
the depth at B 1) and the reckoned peak, as ``chip_smoke.py``'s
``lm_train_cell`` takes them.  The flash backward's scratch is part of the
peak (``flash_attention.ops.work_floats``), so a change to it can move a
cut.

    PYTHONPATH=src python3 tools/train_cuts.py [ARCH ...]
"""
from __future__ import annotations

import sys
import time

from repro_torch.configs import get_shapes
from repro_torch.launch import dryrun

FIT_BYTES = 75 * 10**9  # chip_smoke.py's FIT_BYTES
ARCHS = ["tinyllama-1.1b", "gemma3-4b", "deepseek-7b", "qwen2-moe-a2.7b", "deepseek-v2-236b"]


def main() -> None:
    for arch in sys.argv[1:] or ARCHS:
        cell = next(c for c in get_shapes(arch) if c.name == "train_4k")
        t0 = time.perf_counter()
        remat, fits = dryrun.fit_train(arch, cell, FIT_BYTES)
        for r, (c, _, cuts, rec) in fits.items():
            print(f"{arch} train_4k remat {r}{' (taken)' if r == remat else ''}: "
                  f"B {c.params['global_batch']} of {cell.params['global_batch']}, "
                  f"{rec['n_layers']} layers, cuts {cuts or 'none'}, reckoned peak "
                  f"{rec['memory']['peak_hbm_bytes']} B", flush=True)
        print(f"{arch}: {time.perf_counter() - t0:.1f} s of tracing", flush=True)


if __name__ == "__main__":
    main()
