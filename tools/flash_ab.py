"""Runs pieces of one tree's ``chip_smoke.py`` that time and check the flash
kernels, so that two trees' flash kernels can be held against each other on
one card.

    python3 tools/flash_ab.py TREE PIECE [PIECE ...]

TREE is the root of a checkout: this one (``.``), or another commit unpacked
under ``build/`` (``git archive``); its own ``chip_smoke.py`` and ``src`` are
imported, so each tree builds and times its own kernels.  Run it for the two
trees in turns within one call (A, B, B, A) and compare only inside that
call.  The pieces, in the order given:

  * ``mla``: ``flash_family_case`` at deepseek-v2's prefill shape (B 1, S
    1024, 128 heads, keys 192, values 128);
  * ``ds7``: the same at deepseek-7b's (B 1, S 2048, 32 heads, dh 128);
  * ``flash``: ``phase_flash``, every flash case with its times;
  * ``ptxas``: ``print_ptxas``; ``work``: ``check_flash_work_floats``;
  * ``dsv2``: ``phase_deepseek_v2``; ``train``: ``family_train`` of
    deepseek-v2-236b at one layer.

The first two take a tree from before the pieces they name existed as long
as its ``chip_smoke.py`` has ``flash_family_case`` and ``phase_flash``.
Each piece prints what ``chip_smoke.py`` prints for it, then ``piece NAME:
SECONDS s``.  It builds the flash library alone (every library with
``dsv2`` or ``train``), exits 2 without a CUDA card, and fails where a
piece's check fails.
"""
from __future__ import annotations

import gc
import os
import sys
import time

import torch


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    root, pieces = os.path.abspath(sys.argv[1]), sys.argv[2:]
    sys.path[:0] = [os.path.join(root, "src"), root]
    import chip_smoke as cs
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"tree {root} card {cs.card_line()} torch {torch.__version__} {torch.version.cuda}")
    t = time.perf_counter()
    if {"dsv2", "train"} & set(pieces):
        build.build_all()
    else:
        build.load("flash_attention")
    print(f"build {time.perf_counter() - t:.1f} s")
    runs = {
        "mla": lambda: cs.flash_family_case("deepseek-v2 prefill (MLA)", 1, cs.MLA_SEQ, 128,
                                            192, 128, dev),
        "ds7": lambda: cs.flash_family_case("deepseek-7b prefill", 1, cs.FAMILY_SEQ, 32, 128,
                                            128, dev),
        "flash": lambda: cs.phase_flash(dev),
        "ptxas": cs.print_ptxas if hasattr(cs, "print_ptxas") else None,
        "work": getattr(cs, "check_flash_work_floats", None),
        "dsv2": lambda: cs.phase_deepseek_v2(dev),
        "train": lambda: cs.family_train(dev, "deepseek-v2-236b", 1),
    }
    for name in pieces:
        fn = runs.get(name)
        if fn is None:
            print(f"flash_ab: no piece {name!r} in {root}", file=sys.stderr)
            return 2
        t = time.perf_counter()
        fn()
        print(f"piece {name}: {time.perf_counter() - t:.3f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
