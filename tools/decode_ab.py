"""Times the fused decode-attention kernel's plan at long caches, and where
a decode cell's step spends the host's time, on one card.

    python3 tools/decode_ab.py PIECE [PIECE ...]

The pieces, in the order given:

  * ``sweep``: splits and cluster sizes of the fused plan swept at long
    caches (``ops.plan_fused`` patched), each output held against the
    planned call's;
  * ``host``: a decode cell's step (``build_serve_step`` at the dry-run's
    cut, as ``chip_smoke.py`` runs it) enqueued behind a device sleep and
    without, and one step under cProfile: where the host waits.

Compare numbers only inside one call.  Exits 2 without a CUDA card.
"""
from __future__ import annotations

import cProfile
import io
import os
import pstats
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def inputs(B, Hq, Hkv, T, dh, q_start, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    q = torch.randn(B, 1, Hq, dh, generator=g, device=dev).to(bf)
    kn, vn = (torch.randn(B, 1, Hkv, dh, generator=g, device=dev).to(bf) for _ in range(2))
    k, v = (torch.randn(B, T, Hkv, dh, generator=g, device=dev).to(bf) for _ in range(2))
    return q, kn, vn, k, v, torch.tensor(q_start, dtype=torch.int32, device=dev)


def piece_sweep(cs, ops, dev) -> None:
    plan = ops.plan_fused
    for label, B, Hq, Hkv, T, dh, window in (
            ("long_500k global", 1, 8, 4, 524288, 256, None),
            ("T131072 dh256", 1, 8, 4, 131072, 256, None),
            ("T65536 dh64", 1, 32, 4, 65536, 64, None),
            ("gemma3 decode_32k B14 global", 14, 8, 4, 32768, 256, None)):
        q, kn, vn, k, v, q_start = inputs(B, Hq, Hkv, T, dh, [T // 2] * B, dev)
        tk, n0, c0 = plan(B, Hkv, T, dh, torch.bfloat16, 132, window)
        want = ops.decode_attention_insert(q, kn, vn, k, v, q_start, window=window).clone()
        combos = sorted({(n0, c0), *((n, c) for n in (4, 16, 32, 64, 128) for c in (1, 2, 4, 8)
                                     if n % c == 0 and n * B * Hkv <= 528)})
        res = []
        try:
            for n, c in combos:
                ops.plan_fused = lambda *_, n=n, c=c: (tk, n, c)
                out = ops.decode_attention_insert(q, kn, vn, k, v, q_start, window=window)
                err = (out.float() - want.float()).abs().max().item()
                if err > 2e-2:
                    raise SystemExit(f"decode_ab: sweep {label} at {n} x {c}: error {err}")
                res.append((n, c, cs.queued_ms(
                    lambda: ops.decode_attention_insert(q, kn, vn, k, v, q_start, window=window))))
        finally:
            ops.plan_fused = plan
        print(f"sweep {label} (planned {n0} splits in clusters of {c0}): splits x cluster ms "
              + "; ".join(f"{n}x{c} {t:.4f}" for n, c, t in res), flush=True)
        del q, kn, vn, k, v
        torch.cuda.empty_cache()


def piece_host(cs, dev) -> None:
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.data import make_batch
    from repro_torch.launch import dryrun
    from repro_torch.train import build_serve_step

    torch._C._accelerator_setAllocatorSettings("expandable_segments:True")
    for arch, name in (("gemma3-4b", "long_500k"), ("tinyllama-1.1b", "decode_32k")):
        published = next(c for c in get_shapes(arch) if c.name == name)
        cell, overrides, _, _ = dryrun.fit(arch, published, cs.FIT_BYTES)
        cfg = dryrun.apply_cfg_overrides(get_config(arch), overrides)
        params = cs.lm_params(dev, cfg, seed=0)
        batch = make_batch(cfg, cell, seed=0, generator=torch.Generator(device=dev).manual_seed(1))
        step = build_serve_step(cfg, cell)
        args = (params, batch["tokens"], batch["cache"], batch["cache_len"])
        for _ in range(2):
            step(*args)
        torch.cuda.synchronize()
        for label, sleep in (("behind a 1 s device sleep", True), ("alone", False)):
            enq = []
            for _ in range(3):
                if sleep:
                    torch.cuda._sleep(2_000_000_000)
                t0 = time.perf_counter()
                step(*args)
                enq.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            print(f"host {arch} {name} ({cfg.n_layers} layers, B {cell.params['global_batch']})"
                  f": ms to enqueue a step, {label}: {[round(x, 3) for x in enq]}", flush=True)
        torch.cuda._sleep(2_000_000_000)
        prof = cProfile.Profile()
        prof.enable()
        step(*args)
        prof.disable()
        torch.cuda.synchronize()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(8)
        print(f"host {arch} {name}: cProfile of one step behind the sleep\n"
              + text.getvalue()[-2500:], flush=True)
        del params, batch, args
        torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    if not args or set(args) - {"sweep", "host"}:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(HERE, "src"), HERE]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops

    dev = torch.device("cuda", 0)
    print(f"card {cs.card_line()} torch {torch.__version__} {torch.version.cuda}")
    if "host" in args:
        build.build_all()
    else:
        build.load("decode_attention")
    for piece in args:
        t = time.perf_counter()
        if piece == "sweep":
            piece_sweep(cs, ops, dev)
        else:
            piece_host(cs, dev)
        print(f"piece {piece}: {time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
