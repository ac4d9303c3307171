#!/usr/bin/env python3
"""What the compiler made of the round-stage kernels, and their times at
the training shape, for one tree of the port.

    python3 tools/kernel_trace.py [--src DIR] [--tag NAME]

``--src`` is the ``src/`` directory whose ``repro_torch`` is traced
(default: this checkout's), so the same script reads an older tree
unpacked beside this one. It builds that tree's ``encode_fused`` and
``multipass`` libraries and prints, one JSON line each:

- ``ptxas``: registers, spills and shared memory of every qdq, encode and
  quant_rr instantiation (``nvcc -Xptxas -v``);
- ``sass``: per qdq and quant_rr function, its SASS instruction count and
  every loop (a backward branch: the range it closes and the instructions
  in it), from ``cuobjdump -sass`` (the listing of each qdq function is
  written to ``chiprun_out/sass_<tag>_*.txt``);
- ``time``: device ms (torch.profiler) and events ms of ``qdq_fused`` at
  66,058 rows × 2048 in rr mode with the exchange's mask at s = 3, 9 and
  17 (orq-3, orq-9, orq-17 levels), of ``encode_fused`` at 4 bits and of
  ``quant_rr`` at s = 9, with ``chip_smoke.py``'s timing functions and
  inputs, beside the bound (bytes over 3.35 TB/s).

Needs a CUDA device and the toolkit's ``cuobjdump``; exits non-zero
without them.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out"

_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"\bBRA\s+(?:\w+\s+)*(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)")


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` text -> {function name: [(address, instruction
    text)]}; label lines become (address, ".L_x_N:") markers."""
    funcs, cur, pending = {}, None, []
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.match(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                cur.append((addr, name + ":"))
            pending = []
            cur.append((addr, m.group(2)))
    return funcs


def loops(insns) -> list:
    """Loops of one function: each backward branch closes the range from
    its target to itself -> [{"from", "to", "instructions"}], instructions
    counted without NOPs and labels."""
    labels = {t[:-1]: a for a, t in insns if t.endswith(":")}
    code = [(a, t) for a, t in insns if not t.endswith(":")]
    out = []
    for addr, text in code:
        m = _TARGET.search(text)
        if not m:
            continue
        tgt = m.group(1)
        tgt = labels.get(tgt) if tgt.startswith(".L") else int(tgt, 16)
        if tgt is None or tgt >= addr:
            continue
        n = sum(1 for a, t in code if tgt <= a <= addr
                and not t.split()[0].startswith("NOP"))
        out.append({"from": hex(tgt), "to": hex(addr), "instructions": n})
    return out


def instruction_count(insns) -> int:
    return sum(1 for _, t in insns if not t.endswith(":")
               and not t.split()[0].startswith("NOP"))


def ptxas_entries(log: str) -> dict:
    """``-Xptxas -v`` output -> {function: [the lines after its "Compiling
    entry function" line that give registers, spills, shared memory]}."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        if cur is not None and any(k in line for k in (
                "registers", "spill", "smem", "stack frame")):
            cur.append(line.split("info    :")[-1].strip())
    return out


def _demangle(names):
    tool = shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True)
    return dict(zip(names, res.stdout.splitlines()))


def _cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(path).exists():
        raise RuntimeError("cuobjdump not found")
    return path


WANTED = ("qdq", "encode_fused_kernel", "quant_rr")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_trace: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import levels as lvmod
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.kernels import quant_rr as qr

    tag = args.tag
    cs.emit("trace_env", tag=tag, src=str(Path(args.src).resolve()),
            device=torch.cuda.get_device_name(0), nvidia_smi=cs.nvidia_smi(),
            torch=torch.__version__, cuda=torch.version.cuda)
    # a fresh build directory, so that nvcc runs and reports
    build.BUILD_DIR = Path(tempfile.mkdtemp(prefix="kernel_trace_"))
    report = build.build_all(["encode_fused", "multipass"])
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(4)
    v, lv9, rb, mask = cs._train_shape_inputs(torch, dev, g)
    runs = {"qdq_s3": lvmod.orq_levels(v, mask, 1), "qdq_s9": lv9,
            "qdq_s17": lvmod.orq_levels(v, mask, 4)}
    for case, lv in runs.items():
        kern = lambda: fe.qdq_fused_cuda(v, lv, rb, mask, None, mode="rr")
        got = kern()
        mism = cs._mismatch(torch, got, fe.qdq_fused_plain(
            v, lv, rb, mask, None, mode="rr"))
        moved = cs.nbytes(v, lv, rb, mask, got)
        _time(cs, tag, "qdq_fused", case, kern, moved, mismatched=mism,
              s=lv.shape[1])
        del got
    enc = lambda: fe.encode_fused_cuda(v, lv9, rb, mask, None, bits=4)
    words = enc()
    _time(cs, tag, "encode_fused", "bits4", enc,
          cs.nbytes(v, lv9, rb, mask, words), s=9)
    del words
    qrr = lambda: qr.quant_rr_cuda(v, lv9, rb)
    idx = qrr()
    _time(cs, tag, "quant_rr", "s9", qrr, cs.nbytes(v, lv9, rb, idx), s=9)
    OUT.mkdir(exist_ok=True)
    for lib in ("encode_fused", "multipass"):
        entries = ptxas_entries(report[lib]["ptxas"])
        names = _demangle(list(entries))
        cs.emit("ptxas", tag=tag, library=lib, functions={
            names[k]: v for k, v in entries.items()
            if any(w in names[k] for w in WANTED)})
        sass = subprocess.run(
            [_cuobjdump(), "-sass", str(build.library_path(lib))],
            capture_output=True, text=True, check=True).stdout
        funcs = sass_functions(sass)
        names = _demangle(list(funcs))
        rows = {}
        for i, (mangled, insns) in enumerate(sorted(funcs.items())):
            name = names[mangled]
            if not any(w in name for w in ("qdq", "quant_rr")):
                continue
            rows[name] = {"instructions": instruction_count(insns),
                          "loops": loops(insns)}
            if "qdq" in name:
                (OUT / f"sass_{tag}_{lib}_{i}.txt").write_text(
                    name + "\n" + "\n".join(f"{a:05x} {t}"
                                            for a, t in insns) + "\n")
        cs.emit("sass", tag=tag, library=lib, functions=rows)

    return 0


def _time(cs, tag, kernel, case, fn, moved, **extra):
    b_ms, b_by = cs.bound(moved, 0.0)
    dev_ms = cs.device_ms(fn, floor_ms=cs.hbm_floor_ms(moved))
    ms = cs.time_ms(fn, reps=10, rounds=3)
    cs.emit("time", tag=tag, kernel=kernel, case=case, device_ms=dev_ms,
            ms=ms, bound_ms=b_ms, bound_by=b_by, bytes=moved,
            share_of_bound=b_ms / dev_ms, **extra)


if __name__ == "__main__":
    sys.exit(main())
