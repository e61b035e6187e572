"""Makes a copy of a tree whose bf16 flash forward takes another layout, so
that ``tools/flash_ab.py TREE fwd`` can time the layouts against each other
in one call.

    python3 tools/flash_fwd_layouts.py SRC DST [grid] [stages=EXPR] [consumers=EXPR]
                                       [group=EXPR] [poly=N]

SRC is the root of a checkout (this one, or a commit unpacked with ``git
archive``); DST, which must not exist, receives its files but ``build/``,
``.git/`` and output directories (``*_out``), and then these changes to
``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``:

  * ``grid``: for a tree whose ``flash_fwd_wgmma_kernel`` still takes one
    and two column chunks (before the ping-pong forward took them), that
    kernel's grid becomes (row tiles, B*Hkv), the row tiles of one kv head
    next to each other as the ping-pong kernel's: the grid's share of the
    gain, apart from the schedule's;
  * ``stages=EXPR``: the ping-pong forward's ring depth, ``pp_stages``, as a
    C++ expression in DC and DVC (e.g. ``"DC == 1 ? 3 : 2"``);
  * ``consumers=EXPR``: its consumer warpgroups, ``pp_consumers``, the same
    way (e.g. ``"DC == 1 ? 3 : 2"``: 192-row blocks at one chunk);
  * ``group=EXPR``: the bytes of K and V of the kv heads of a group of its
    grid, ``pp_group_bytes`` (``0``: one head a group, ``"1LL << 62"``: all
    of them);
  * ``poly=N``: of every 8 scores of a thread in the ping-pong forward at
    one column chunk, N (1 to 7) take their exponential on the FMA pipe
    (``EXP2_FMA``: a Cody-Waite cut and a degree-5 polynomial, relative
    error 2.3e-7, as ex2.approx's) instead of the MUFU's ex2.

Each change fails if the text it replaces is not in the source.  Run on the
machine with the card from the root of this tree, DST under ``build/``.
"""
from __future__ import annotations

import re
import shutil
import sys
from pathlib import Path

SOURCE = Path("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu")


def _sub(text: str, pattern: str, repl: str, what: str, count: int = 1) -> str:
    new, n = re.subn(pattern, repl, text, count=count)
    if n != count:
        raise SystemExit(f"flash_fwd_layouts: {what}: the text is not in the source")
    return new


def grid(text: str) -> str:
    """flash_fwd_wgmma_kernel's blocks by (row tile, kv head), heaviest first."""
    start = text.index("flash_fwd_wgmma_kernel(const __grid_constant__")
    end = text.index("\n}\n", start)
    body = text[start:end]
    body = _sub(body, re.escape("const int tile = causal ? gridDim.y - 1 - blockIdx.y : "
                                "blockIdx.y;"),
                "const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;", "grid tile")
    body = _sub(body, re.escape("const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;"),
                "const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;", "grid head")
    text = text[:start] + body + text[end:]
    return _sub(text, r"(flash_fwd_wgmma_kernel<DC(?:, DVC)?, kRows>(?:,|;)[^;]*?)"
                      r"row_grid\(s, kBlockRows\)\)",
                r"\1dim3(row_grid(s, kBlockRows).y, row_grid(s, kBlockRows).x))", "grid launch")


FUNCTIONS = {"stages": "pp_stages", "consumers": "pp_consumers", "group": "pp_group_bytes"}

# 2^x for x <= 0 on the FMA pipe, 0 below -126: x = n + f, n rounded by
# adding 1.5 x 2^23, 2^f (|f| <= 1/2) by the polynomial, n added to the
# exponent's bits
EXP2_FMA = """
__device__ __forceinline__ float exp2_fma(float x) {
  constexpr float kRound = 12582912.f;
  const float t = x + kRound;
  const float f = x - (t - kRound);
  float p = fmaf(1.3276457e-3f, f, 9.6755410e-3f);
  p = fmaf(p, f, 5.5507135e-2f);
  p = fmaf(p, f, 2.4022120e-1f);
  p = fmaf(p, f, 6.9314694e-1f);
  p = fmaf(p, f, 1.0000001f);
  const float r = __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
  return x < -126.f ? 0.f : r;
}
"""


def poly(text: str, n: int) -> str:
    """N of every 8 exponentials of the ping-pong forward's softmax at DC 1
    through exp2_fma."""
    if not 0 < n < 8:
        raise SystemExit(f"flash_fwd_layouts: poly={n}: 1 to 7")
    start = text.index("flash_fwd_pp_wgmma_kernel(const __grid_constant__")
    end = text.index("\n}\n", start)
    use = ("const float y = sacc[e] * sc - m_use[x];\n        "
           f"const float p = DC == 1 && e % 8 < {n} ? exp2_fma(y) : fast_exp2(y);")
    body = _sub(text[start:end], re.escape("const float p = fast_exp2(sacc[e] * sc - m_use[x]);"),
                use, "poly use")
    text = text[:start] + body + text[end:]
    return _sub(text, r"(// The ping-pong forward \(fwd_pingpong)", EXP2_FMA + r"\n\1",
                "poly helper")


def constexpr_fn(text: str, name: str, expr: str) -> str:
    """The body of the one-line ``constexpr ... name(int DC, int DVC)``."""
    return _sub(text, r"(constexpr [\w ]+ " + name + r"\(int DC, int DVC\) \{ return )[^;]*;",
                lambda m: m.group(1) + expr + ";", name)


def main(argv: list[str]) -> int:
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    src, dst = Path(argv[1]).resolve(), Path(argv[2]).resolve()
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("build", "*_out", ".git",
                                                            "__pycache__"))
    path = dst / SOURCE
    text = path.read_text()
    for change in argv[3:]:
        key, _, expr = change.partition("=")
        if key == "grid" and not expr:
            text = grid(text)
        elif key in FUNCTIONS and expr:
            text = constexpr_fn(text, FUNCTIONS[key], expr)
        elif key == "poly" and expr.isdigit():
            text = poly(text, int(expr))
        else:
            raise SystemExit(f"flash_fwd_layouts: no change {change!r}")
    path.write_text(text)
    print(f"{dst}: {' '.join(argv[3:]) or 'as it is'}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
