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
    deepseek-v2-236b at one layer;
  * ``train4k``: the bf16 flash forward and backward at the ``train_4k``
    cells' shapes (S 4,096: TinyLlama-1.1B at B 6, gemma3-4b's local and
    global layers at B 2, deepseek-7b at B 1), queries at 4 times the keys'
    scale: ``queued_ms`` of each, and the first sequence's out, lse, dq, dk
    and dv against fp32 autograd of the plain version (the worst err / (tol
    + tol |ref|) of each; at most 1 holds TOL), which it prints and does not
    check;
  * ``bwd``: the bf16 backward alone at every ``train_4k`` cell's shape
    (those four, qwen2-moe-a2.7b at B 1 and deepseek-v2-236b's MLA at B 1),
    the train shape (B 4, S 2,048) and MLA's other two shapes (S 1,024 and
    32,768, B 1, 128 heads, keys 192, values 128): ``queued_ms`` twice, the
    kernels of one call by the profiler (their count and each one's device
    ms), the bound and SDPA's backward (``backward_ms``), and whether a
    second call gives the same bits (it fails where not);
  * ``fwd``: the bf16 forward alone at MLA's three shapes (S 1,024, 4,096
    and 32,768): the same figures, SDPA's forward beside them.

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


TRAIN_4K = [  # label, B, S, Hq, Hkv, dh, window: the train_4k cells at their cuts
    ("tinyllama-1.1b", 6, 4096, 32, 4, 64, None),
    ("gemma3-4b local", 2, 4096, 8, 4, 256, 1024),
    ("gemma3-4b global", 2, 4096, 8, 4, 256, None),
    ("deepseek-7b", 1, 4096, 32, 32, 128, None),
]


def train_4k(cs, dev) -> None:
    """The ``train4k`` piece, from what every tree's ``chip_smoke.py`` has."""
    from repro_torch.kernels.flash_attention import ops

    bf16 = torch.bfloat16
    for label, B, S, Hq, Hkv, dh, window in TRAIN_4K:
        gen = torch.Generator(device=dev).manual_seed(9)
        q = (torch.randn(B, S, Hq, dh, generator=gen, device=dev) * 4).to(bf16)
        k, v = ((torch.randn(B, S, Hkv, dh, generator=gen, device=dev)).to(bf16)
                for _ in range(2))
        dout = torch.randn(B, S, Hq, dh, generator=gen, device=dev).to(bf16)
        kw = dict(causal=True, window=window)
        out, lse = ops.flash_attention_fwd(q, k, v, **kw)
        grads = ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        want = cs.flash_oracle(q[:1], k[:1], v[:1], dout[:1], True, window)
        ratios = {name: cs.assert_close_ratio(g[:1], w, cs.TOL[bf16])[1]
                  for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads),
                                        want)}
        del want, grads
        fwd = cs.queued_ms(lambda: ops.flash_attention_fwd(q, k, v, **kw))
        bwd = cs.queued_ms(lambda: ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw))
        print(f"train4k {label} B {B} S {S} Hq {Hq} Hkv {Hkv} dh {dh} window {window}: "
              f"queued_ms fwd {fwd:.4f} bwd {bwd:.4f}; first sequence against fp32 autograd, "
              "worst err/(tol + tol*|ref|): "
              + " ".join(f"{n} {r:.4f}" for n, r in ratios.items()))
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()


# label, B, S, Hq, Hkv, dh, window, dv: MLA's prefill shape of the family
# checks, its train_4k cell and its prefill_32k cell
MLA_SHAPES = [
    ("deepseek-v2-236b mla S 1024", 1, 1024, 128, 128, 192, None, 128),
    ("deepseek-v2-236b mla", 1, 4096, 128, 128, 192, None, 128),
    ("deepseek-v2-236b mla S 32768", 1, 32768, 128, 128, 192, None, 128),
]
BWD_SHAPES = TRAIN_4K + [  # label, B, S, Hq, Hkv, dh, window[, dv]
    ("qwen2-moe-a2.7b", 1, 4096, 16, 16, 128, None),
    MLA_SHAPES[1],
    ("train shape", 4, 2048, 32, 4, 64, None),
    MLA_SHAPES[0],
    MLA_SHAPES[2],
]


def _inputs(dev, B, S, Hq, Hkv, dh, dv):
    """q at 4 times the keys' scale, k, v and dout from one seeded generator."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(9)
    q = (torch.randn(B, S, Hq, dh, generator=gen, device=dev) * 4).to(bf16)
    k = torch.randn(B, S, Hkv, dh, generator=gen, device=dev).to(bf16)
    v = torch.randn(B, S, Hkv, dv, generator=gen, device=dev).to(bf16)
    dout = torch.randn(B, S, Hq, dv, generator=gen, device=dev).to(bf16)
    return q, k, v, dout


def _iters(S: int) -> int:
    """Calls a time averages: fewer at S 32,768, where one takes tenths of a second."""
    return 3 if S >= 32768 else 10


def fwd(cs, dev) -> None:
    """The ``fwd`` piece, from what every tree's ``chip_smoke.py`` has."""
    from repro_torch.kernels.flash_attention import ops

    bf16 = torch.bfloat16
    for label, B, S, Hq, Hkv, dh, window, dv in MLA_SHAPES:
        q, k, v, _ = _inputs(dev, B, S, Hq, Hkv, dh, dv)
        kw = dict(causal=True, window=window)
        fn = lambda: ops.flash_attention_fwd(q, k, v, **kw)
        first, again = fn(), fn()
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        del first, again
        split: dict[str, float] = {}
        cs.kernel_device_ms(fn, iters=_iters(S), by_kernel=split)
        ms = [cs.queued_ms(fn, _iters(S)), cs.queued_ms(fn, _iters(S))]
        bound, by = cs.flash_bound_ms((label, B, S, Hq, Hkv, dh, True, window), bf16, False, dv)
        lib = cs.queued_ms(lambda: cs.sdpa(q, k, v, True, window), _iters(S))
        print(f"fwd {label} B {B} S {S} Hq {Hq} Hkv {Hkv} dh {dh} dv {dv} window {window} "
              f"{ops.instance(bf16, dh, Hq // Hkv, dv)}: queued_ms {ms[0]:.4f} {ms[1]:.4f} "
              f"bound_ms {bound:.4f} ({by}) sdpa_ms {lib:.4f} equal bits {same}; "
              f"{len(split)} kernels a call: "
              + " ".join(f"{name[:48]} {t:.4f}" for name, t in split.items()))
        cs.check(same, f"flash_ab fwd {label}: two forward calls differ")
        del q, k, v
        torch.cuda.empty_cache()


def bwd(cs, dev) -> None:
    """The ``bwd`` piece, from what every tree's ``chip_smoke.py`` has."""
    from repro_torch.kernels.flash_attention import ops

    bf16 = torch.bfloat16
    for label, B, S, Hq, Hkv, dh, window, *rest in BWD_SHAPES:
        dv = rest[0] if rest else dh
        q, k, v, dout = _inputs(dev, B, S, Hq, Hkv, dh, dv)
        kw = dict(causal=True, window=window)
        out, lse = ops.flash_attention_fwd(q, k, v, **kw)
        fn = lambda: ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        first, again = fn(), fn()
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        del first, again
        split: dict[str, float] = {}
        cs.kernel_device_ms(fn, iters=min(5, _iters(S)), by_kernel=split)
        ms = [cs.queued_ms(fn, _iters(S)), cs.queued_ms(fn, _iters(S))]
        case = (label, B, S, Hq, Hkv, dh, True, window)
        bound, by = cs.flash_bound_ms(case, bf16, True, dv)
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        lib_out = cs.sdpa(qg, kg, vg, True, window)
        lib = cs.backward_ms(lib_out, (qg, kg, vg), dout, 5)
        del lib_out, qg, kg, vg
        print(f"bwd {label} B {B} S {S} Hq {Hq} Hkv {Hkv} dh {dh} dv {dv} window {window} "
              f"{ops.instance(bf16, dh, Hq // Hkv, dv)}: queued_ms {ms[0]:.4f} {ms[1]:.4f} "
              f"bound_ms {bound:.4f} ({by}) sdpa_ms {lib:.4f} equal bits {same}; "
              f"{len(split)} kernels a call: "
              + " ".join(f"{name[:48]} {t:.4f}" for name, t in split.items()))
        cs.check(same, f"flash_ab bwd {label}: two backward calls differ")
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()


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
        "train4k": lambda: train_4k(cs, dev),
        "bwd": lambda: bwd(cs, dev),
        "fwd": lambda: fwd(cs, dev),
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
