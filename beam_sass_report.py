"""What the compiler made of the graph beam step's kernels: SASS counts.

    python3 beam_sass_report.py [--dump OUT] DIR [DIR ...]

Each DIR is a checkout of this repository (for instance one unpacked with
``git archive`` into a directory that .gitignore lists).  For each, its
``cphnsw_tpu_torch/csrc/beam_step.cu`` is compiled with this checkout's
``nvcc`` flags (``kernels/nvcc.py``) into ``build/beam_sass/``, and
``cuobjdump -sass`` of the build is read.  Prints one JSON line per
kernel instance: the checkout, the kernel, its registers, spill bytes and
static shared memory from ptxas's ``-v`` report, its SASS instructions in
all and by opcode (the part before the first dot), the barriers
(``BAR``), and each loop's body in instructions (a branch back to a lower
address closes a loop) with the watched opcodes in it.  Then the card's name and power limit as
nvidia-smi gives them.  ``--dump OUT`` also writes each checkout's SASS
listing under OUT.  Needs the CUDA toolkit (``nvcc``, ``cuobjdump``); no
card is used.
"""

from __future__ import annotations

import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from cphnsw_tpu_torch.kernels import nvcc

OUT = Path(__file__).resolve().parent / "build" / "beam_sass"
# opcodes counted by name in the summary (the rest are in `by_opcode`)
WATCH = ("BAR", "LDS", "STS", "LDG", "STG", "LD", "ST", "SHFL", "POPC",
         "MATCH", "VOTE", "ATOMS", "SYNCS", "UBLKCP", "IMAD", "LOP3", "ISETP",
         "FSETP", "BRA", "FADD", "FMUL", "FFMA")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)\s*([^;]*);")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")


def kernel_name(mangled: str) -> str:
    """beam_expand_kernel<Lb1> and the like from a mangled name."""
    base = re.search(r"beam_[a-z_]+_kernel", mangled)
    if not base:
        return mangled
    args = re.search(r"_kernelI(.*?)EEv", mangled)
    return base.group(0) + (f"<{args.group(1)}>" if args else "")


def sass_functions(text: str) -> dict:
    """{mangled name: [(address, opcode, operands)]} from cuobjdump's
    -sass listing."""
    funcs, cur = {}, None
    for line in text.splitlines():
        f = _FUNC.search(line)
        if f:
            cur = funcs.setdefault(f.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def summary(instrs) -> dict:
    ops = collections.Counter(op.split(".")[0] for _, op, _ in instrs)
    loops = []
    for addr, op, args in instrs:
        if op.split(".")[0] == "BRA":
            t = re.search(r"0x([0-9a-f]+)", args)
            if t and int(t.group(1), 16) < addr:
                top = int(t.group(1), 16)
                body = collections.Counter(
                    o.split(".")[0] for a, o, _ in instrs if top <= a <= addr)
                loops.append(dict(
                    instructions=(addr - top) // 16 + 1,
                    watched={o: body[o] for o in WATCH if body[o]}))
    real = sum(n for op, n in ops.items() if op not in ("NOP", "EXIT"))
    return dict(instructions=real,
                watched={op: ops.get(op, 0) for op in WATCH},
                loop_bodies=sorted(x["instructions"] for x in loops),
                loops=loops, by_opcode=dict(ops.most_common()))


def ptxas_registers(log: str) -> dict:
    """{mangled: (registers, spill stores + loads, static smem)}."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            out.setdefault(cur, {})["spill_bytes"] = int(m.group(1)) + int(
                m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[cur]["static_smem"] = int(s.group(1)) if s else 0
    return out


def report(checkout: Path, dump: Path | None = None):
    source = checkout / "cphnsw_tpu_torch" / "csrc" / "beam_step.cu"
    tag = re.sub(r"\W+", "_", str(checkout.resolve()).strip("/"))
    lib, _ = nvcc.build_library(source, build_dir=OUT / tag)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    if dump is not None:
        dump.mkdir(parents=True, exist_ok=True)
        (dump / f"{tag}.sass").write_text(text)
    regs = ptxas_registers(nvcc.build_log(lib).read_text())
    for mangled, instrs in sass_functions(text).items():
        print(json.dumps(dict(checkout=str(checkout),
                              kernel=kernel_name(mangled),
                              **regs.get(mangled, {}), **summary(instrs))),
              flush=True)


def main(argv):
    dump = None
    if argv[:1] == ["--dump"]:
        dump, argv = Path(argv[1]), argv[2:]
    if not argv:
        sys.exit(__doc__)
    for d in argv:
        report(Path(d), dump)
    smi = shutil.which("nvidia-smi")
    if smi:
        print(subprocess.run([smi, "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
