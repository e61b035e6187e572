"""Times one tree's embedding-bag kernel at the bag cases of
``chip_smoke.py`` (``BAG_CASES``), so that two trees' kernels can be held
against each other on one card.

    python3 tools/bag_ab.py --src DIR

DIR holds the ``repro_torch`` package to drive: ``src`` of this tree, or of
another commit unpacked under ``build/`` (``git archive``).  Run it for the
two trees in turns within one call (A, B, B, A) and compare only inside that
call.  For each case, fp32 and bf16, it builds the kernel from DIR's
sources, holds the kernel's output within TOL of DIR's ``embedding_bag_ref``
(the 4,096-id bags within TOL plus the bound on a sequential fp32 sum), and
times it by ``queued_ms`` and ``l2_flushed_ms`` as ``chip_smoke.py`` does.
Its last line is one JSON object, ``{"src": DIR, "card": ..., "cases":
{...}}``.  It exits non-zero without a CUDA card or when a check fails; the
bit-for-bit checks against ``embedding_bag_seq_ref`` are ``chip_smoke.py``'s.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="directory holding the repro_torch package")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bag_ab: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)  # chip_smoke: the cases, inputs and timers
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref

    card = cs.card_line()
    print(f"card: {card}")
    build.load("embedding_bag")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    cases = {}
    for label, arch, cell_name, lookup, combiner, weighted in cs.BAG_CASES:
        (V, dim), ids = cs.bag_inputs(arch, cell_name, lookup, dev)
        n_bags, bag = ids.shape
        table32 = torch.randn(V, dim, generator=gen, device=dev)
        w = torch.rand(n_bags, bag, generator=gen, device=dev) if weighted else None
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).replace("torch.", "")
            table = table32 if dtype == torch.float32 else table32.to(dtype)
            run = lambda: embedding_bag(table, ids, w, combiner=combiner)
            got = run()
            tol = cs.TOL[dtype]
            if lookup == "long":
                err, ratio = cs.long_bag_ratio(got, table, ids, w, combiner, tol)
            else:
                want = embedding_bag_ref(table.float(), ids, w, combiner)
                err, ratio = cs.assert_close_ratio(got, want, tol)
                del want
            cs.check(math.isfinite(err) and ratio <= 1.0,
                     f"embedding_bag {label} {tname}: max_abs_err {err}, worst ratio {ratio}")
            del got
            row = {"queued_ms": cs.queued_ms(run), "flushed_ms": cs.flushed_ms(run),
                   "max_abs_err": err}
            print(f"bag ab {label:22s} {tname:8s} queued_ms {row['queued_ms']:.6f} "
                  f"l2_flushed_ms {row['flushed_ms']:.6f} max_abs_err {err:.3e}", flush=True)
            cases[f"{label} {tname}"] = row
            del table
        del table32, ids, w
        torch.cuda.empty_cache()
    print(json.dumps({"src": args.src, "card": card, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
