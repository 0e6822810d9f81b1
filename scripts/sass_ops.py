#!/usr/bin/env python3
"""Count a CUDA library's SASS instructions, by opcode, in each kernel's
loops: for every backward branch, the instructions from its target up to
it (inner loops included once). The loop that closes last is the
kernel's grid-stride loop.

    python3 scripts/sass_ops.py LIBRARY.so [NAME_REGEX]

LIBRARY.so is a build of the port's kernels (`build/repro_torch/*.so`);
NAME_REGEX picks kernels by their mangled names. Needs `cuobjdump` (the
CUDA toolkit, on PATH or under /usr/local/cuda/bin). Prints, per kernel
and loop, the instruction count split into integer-datapath operations
(what the 32-bit ALU and the FMA pipe's IMAD issue per thread), uniform
datapath, memory and control instructions; for the grid-stride loop also
every opcode's count. A static count: both sides of a branch are in it.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
from collections import Counter

MEMORY = {"LDG", "STG", "LDS", "STS", "LDL", "STL", "LDC", "ULDC", "LD",
          "ST", "ATOM", "RED", "LDGSTS"}
CONTROL = {"BRA", "BSSY", "BSYNC", "EXIT", "NOP", "BAR", "CALL", "RET",
           "WARPSYNC", "YIELD"}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"(.*?);")


def kernels(sass: str):
    """{mangled name: [(address, opcode, operands)]} of a SASS dump."""
    out, name = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = fn.group(1)
            out[name] = []
            continue
        m = _INSN.search(line)
        if m and name:
            out[name].append((int(m.group(1), 16), m.group(2).split(".")[0],
                              m.group(3)))
    return out


def loops(insns):
    """[(start, end)] address spans of the loops, one per backward BRA,
    in the order the branches appear (the grid-stride loop last)."""
    spans = []
    for addr, op, args in insns:
        t = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
        if t and int(t.group(1), 16) < addr:
            spans.append((int(t.group(1), 16), addr))
    return spans


def classify(op: str) -> str:
    if op in MEMORY:
        return "memory"
    if op in CONTROL:
        return "control"
    if op.startswith("U") or op == "S2UR" or op == "R2UR":
        return "uniform"
    return "integer"


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", argv[1]], capture_output=True,
                          text=True, check=True).stdout
    pattern = re.compile(argv[2] if len(argv) > 2 else ".")
    for name, insns in kernels(sass).items():
        if not pattern.search(name):
            continue
        print(f"{name}: {len(insns)} instructions")
        spans = loops(insns) or [(insns[0][0], insns[-1][0])]
        for n, (start, end) in enumerate(spans):
            ops = Counter(op for addr, op, _ in insns
                          if start <= addr <= end)
            kinds = Counter()
            for op, c in ops.items():
                kinds[classify(op)] += c
            last = n == len(spans) - 1
            print(f"  {'grid-stride loop' if last else 'loop'} "
                  f"{start:#x}-{end:#x}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {kinds[k]}" for k in
                              ("integer", "uniform", "memory", "control")))
            if last:
                print("    " + ", ".join(f"{op} {c}"
                                         for op, c in ops.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
