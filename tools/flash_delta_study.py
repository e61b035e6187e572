"""Where the bf16 flash backward could take D = rowsum(P * dP) from, studied
on the CPU with the kernels' emulation (``kernels/flash_attention/ref.py``).

    PYTHONPATH=src python3 tools/flash_delta_study.py

The kernels sum D over the key tiles in a walk of their own (two tile
products a tile).  A cheaper source is the output: D = rowsum(dO * O).  From
the bf16 output alone that misses the tolerance at spread scores; this
study takes the forward's P.V with P as hi + lo bf16 and saves O's fp32
residual as a bf16 ``o_lo``, so that D = rowsum(dO * (O + o_lo)) keeps some
16 bits of O.  At the spread cases of ``tests/test_torch_flash_spread.py``
(queries at 4 times the keys' scale, inputs from the same numpy seeds) it
prints, for each D source, the worst err / (tol + tol |ref|) of dq, dk and
dv against fp32 autograd of the plain version on the same bf16 values (at
most 1 holds the card tests' 2e-2), every other step as the kernels
compute it.  No kernel is built for it; the cost it would add is one more
forward product a tile in training forwards (P.V as hi + lo) and a bf16
[B, Sq, Hq, dv] saved a layer."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_attention import attention_ref, ref

TOL, SPREAD = 2e-2, 4.0
# (label, B, S, Hq, Hkv, dh, dv, window): the spread test's cases
CASES = [
    ("tinyllama-heads", 1, 512, 32, 4, 64, 64, None),
    ("deepseek-7b-heads", 1, 512, 4, 4, 128, 128, None),
    ("gemma3-local-heads", 1, 384, 4, 2, 256, 256, 64),
    ("deepseek-v2-mla-heads", 1, 320, 4, 4, 192, 128, None),
    ("g3-heads", 1, 300, 6, 2, 64, 64, None),
]


def inputs(B, S, Hq, Hkv, dh, dv):
    """As the spread test draws them: q at SPREAD, the rest unit normal."""
    rng = np.random.default_rng(B + S + Hq + Hkv + dh)
    shapes = [(B, S, Hq, dh), (B, S, Hkv, dh), (B, S, Hkv, dv), (B, S, Hq, dv)]
    q, k, v, dout = (rng.normal(size=s).astype(np.float32) for s in shapes)
    return [torch.from_numpy(x).bfloat16() for x in (q * SPREAD, k, v, dout)]


def worst(got, want) -> float:
    return float(((got.float() - want).abs() / (TOL + TOL * want.abs())).max())


def main() -> None:
    torch.set_num_threads(4)
    for label, B, S, Hq, Hkv, dh, dv, window in CASES:
        q, k, v, dout = inputs(B, S, Hq, Hkv, dh, dv)
        q32, k32, v32 = (t.float().requires_grad_(True) for t in (q, k, v))
        out32 = attention_ref(q32, k32, v32, causal=True, window=window)
        want = torch.autograd.grad(out32, (q32, k32, v32), dout.float())
        kw = dict(causal=True, window=window)
        out, lse = ref.attention_rows_fwd(q, k, v, **kw)
        out_h, lse_h, o_lo = ref.attention_rows_fwd(q, k, v, p_hilo=True, residual=True, **kw)
        runs = {
            "walk (the kernels)": ref.attention_rows_bwd(q, k, v, out, lse, dout, **kw),
            "bf16 output": ref.attention_rows_bwd(q, k, v, out, lse, dout,
                                                  o_lo=torch.zeros_like(out), **kw),
            "output + o_lo, P.V hi + lo": ref.attention_rows_bwd(q, k, v, out_h, lse_h, dout,
                                                                 o_lo=o_lo, **kw),
        }
        for name, got in runs.items():
            r = [worst(g, w) for g, w in zip(got, want)]
            print(f"{label} B {B} S {S} Hq {Hq} Hkv {Hkv} dh {dh} dv {dv} window {window}: "
                  f"D from {name}: worst err/(tol + tol|ref|) dq {r[0]:.4f} dk {r[1]:.4f} "
                  f"dv {r[2]:.4f} (max {max(r):.4f})", flush=True)


if __name__ == "__main__":
    main()
