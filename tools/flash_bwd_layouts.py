"""Makes a copy of a tree whose bf16 flash backward takes another layout or
grid, so that ``tools/flash_ab.py TREE bwd34`` can time them against each
other in one call.

    python3 tools/flash_bwd_layouts.py SRC DST [grid] [slots=EXPR]
                                       [delta_stages=EXPR] [rows_first=EXPR] [heads=N]

SRC is the root of a checkout (this one, or a commit unpacked with ``git
archive``); DST, which must not exist, receives its files but ``build/``,
``.git/`` and output directories (``*_out``), and then these changes to
``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu`` (and
``ref.py``):

  * ``grid``: for a tree whose backward at three and four equal chunks is
    the dQ kernel and the dK/dV kernel (``flash_bwd_dq_wgmma_kernel``,
    ``flash_bwd_dkdv_wgmma_kernel``; this one), their grids become (row
    tiles, B*Hkv) and (key blocks, B*Hkv): the blocks on the card at once
    are one kv head's row tiles, heaviest first under causal, or its key
    blocks, first first (the heaviest under causal), as the delta kernel's
    grid at ``delta_rows_first``; where they were (B*Hkv, ...), one block of
    every head at a time.  The grid's share of a gain, apart from the
    design's.

The other changes are for a tree whose backward at three and four equal
chunks is the fused design instead, ``fused_wide`` (the dQ and dK/dV
kernels retired): this tree with ``tools/flash_bwd_wide.patch`` applied
(``git apply tools/flash_bwd_wide.patch`` at its root).  That design was
measured slower than the dQ and dK/dV kernels (``PERF.md``) and is kept as
the patch alone, a starting point for the next layout:

  * ``slots=EXPR``: the fused key-tile kernel's slots of one tensor at three
    and four equal chunks (``fused_stages``'s ``DC == 3 ? 4 : 3``), a C++
    expression in DC;
  * ``delta_stages=EXPR``: the delta kernel's K/V ring depth at those pairs
    (``delta_stages``'s last arm, ``2``);
  * ``rows_first=EXPR``: ``delta_rows_first``, a C++ expression in DC and
    DVC (``"DVC < DC"``: swapped only at MLA's (3, 2), as before);
  * ``heads=N``: the kv heads of a group of the key-tile kernel's tickets at
    three and four equal chunks (``ref.fused_heads_per_group``: every head,
    key block major), at most N (3: gemma3-4b's ``train_4k`` in groups whose
    Q, dO and dQ sums fit 48 MiB of the L2).

Each change fails if the text it replaces is not in the source.  Run on the
machine with the card from the root of this tree, DST under ``build/``.
"""
from __future__ import annotations

import re
import shutil
import sys
from pathlib import Path

SOURCE = Path("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu")
REF = Path("src/repro_torch/kernels/flash_attention/ref.py")


def _sub(text: str, pattern: str, repl: str, what: str, count: int = 1) -> str:
    new, n = re.subn(pattern, repl, text, count=count)
    if n != count:
        raise SystemExit(f"flash_bwd_layouts: {what}: the text is not in the source")
    return new


def _body(text: str, name: str, edit) -> str:
    """``edit`` applied to the body of the kernel ``name``."""
    start = text.index(name + "(const __grid_constant__")
    end = text.index("\n}\n", start)
    return text[:start] + edit(text[start:end]) + text[end:]


def grid(text: str) -> str:
    """The dQ and dK/dV kernels' grids with a kv head's blocks together."""
    def dq(body: str) -> str:
        body = _sub(body, re.escape("const int tile = causal ? gridDim.y - 1 - blockIdx.y : "
                                    "blockIdx.y;"),
                    "const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;",
                    "dq tile")
        return _sub(body, re.escape("const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;"),
                    "const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;", "dq head")

    def dkdv(body: str) -> str:
        body = _sub(body, re.escape("const int k0 = blockIdx.y * kKvKeys;"),
                    "const int k0 = blockIdx.x * kKvKeys;", "dkdv key block")
        return _sub(body, re.escape("const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;"),
                    "const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;", "dkdv head")

    text = _body(text, "flash_bwd_dq_wgmma_kernel", dq)
    text = _body(text, "flash_bwd_dkdv_wgmma_kernel", dkdv)
    text = _sub(text, re.escape("dq_kern<<<row_grid(s, nc * kWgRows),"),
                "dq_kern<<<dim3(row_grid(s, nc * kWgRows).y, row_grid(s, nc * kWgRows).x),",
                "dq launch")
    return _sub(text, re.escape("const dim3 grid(s.B * s.Hkv, (s.Sk + keys - 1) / keys);"),
                "const dim3 grid((s.Sk + keys - 1) / keys, s.B * s.Hkv);", "dkdv launch")


def slots(text: str, expr: str) -> str:
    return _sub(text, re.escape("return fused_wide(DC, DVC) ? (DC == 3 ? 4 : 3) :"),
                f"return fused_wide(DC, DVC) ? ({expr}) :", "slots")


def delta_stages(text: str, expr: str) -> str:
    return _sub(text, re.escape("return DC + DVC <= 4 ? 4 : DC + DVC == 5 ? 3 : 2;"),
                f"return DC + DVC <= 4 ? 4 : DC + DVC == 5 ? 3 : ({expr});", "delta_stages")


def rows_first(text: str, expr: str) -> str:
    return _sub(text, r"(constexpr bool delta_rows_first\(int DC, int DVC\) \{ return )[^;]*;",
                lambda m: m.group(1) + expr + ";", "rows_first")


def heads(ref: str, n: int) -> str:
    anchor = "    if (column_chunks(dh), column_chunks(dv)) != (3, 2):\n        return BH\n"
    return _sub(ref, re.escape(anchor),
                "    if column_chunks(dh) >= 3 and column_chunks(dh) == column_chunks(dv):\n"
                f"        return min(BH, {n})\n" + anchor.replace("\\", "\\\\"), "heads")


def main(argv: list[str]) -> int:
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    src, dst = Path(argv[1]).resolve(), Path(argv[2]).resolve()
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("build", "*_out", ".git",
                                                            "__pycache__"))
    path, ref_path = dst / SOURCE, dst / REF
    text, ref = path.read_text(), ref_path.read_text()
    for change in argv[3:]:
        key, _, expr = change.partition("=")
        if key == "grid" and not expr:
            text = grid(text)
        elif key == "slots" and expr:
            text = slots(text, expr)
        elif key == "delta_stages" and expr:
            text = delta_stages(text, expr)
        elif key == "rows_first" and expr:
            text = rows_first(text, expr)
        elif key == "heads" and expr.isdigit():
            ref = heads(ref, int(expr))
        else:
            raise SystemExit(f"flash_bwd_layouts: no change {change!r}")
    path.write_text(text)
    ref_path.write_text(ref)
    print(f"{dst}: {' '.join(argv[3:]) or 'as it is'}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
