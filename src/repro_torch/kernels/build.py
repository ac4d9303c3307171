"""Build and bind the hand-written CUDA kernels (``repro_torch/csrc``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``; no PyTorch
header is compiled, so a build takes seconds. Libraries go to
``build/repro_torch/`` at the repository root, named by a hash of the
source, the shared headers and the flags, and are built at first use (or all at once, in
parallel, by :func:`build_all`). Nothing here runs at import time.

Every C entry point returns the ``cudaError_t`` of ``cudaGetLastError()``
after its launch; :func:`function` turns a non-zero code into an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v")
#: kernel name -> (source file, extra nvcc flags)
SOURCES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    # bit-exact rounding: no FMA contraction, IEEE division (no fast math)
    "encode_fused": ("encode_fused.cu", ("-fmad=false",)),
    "decode_attend": ("decode_attend.cu", ()),
    "decode_fused": ("decode_fused.cu", ("-fmad=false",)),
    "encode_bingrad": ("encode_bingrad.cu", ("-fmad=false",)),
    "multipass": ("multipass.cu", ("-fmad=false",)),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[Tuple[str, str], object] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _flags(name: str) -> Tuple[str, ...]:
    return COMMON_FLAGS + SOURCES[name][1]


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every shared
    header (``csrc/*.cuh``, which a source may include) and the flags."""
    src = CSRC / SOURCES[name][0]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns name -> {"seconds", "cached", "ptxas"} where
    ``ptxas`` is the compiler's register and shared-memory report."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    report = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *_flags(name), "-o", str(tmp),
               str(CSRC / SOURCES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(rc {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0,
                        "cached": False, "ptxas": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    if name not in _LIBS:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


def function(name: str, symbol: str, argtypes):
    """``symbol`` of library ``name`` with its argument types set, wrapped
    so that a non-zero CUDA error code raises."""
    key = (name, symbol)
    if key not in _FUNCS:
        lib = load(name)
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        errstr = lib.repro_error_string
        errstr.argtypes = [ctypes.c_int]
        errstr.restype = ctypes.c_char_p

        def call(*args):
            rc = fn(*args)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc} at launch: "
                                   f"{errstr(rc).decode()}")
        _FUNCS[key] = call
    return _FUNCS[key]


def check_cuda(kernel: str, **tensors: Optional[torch.Tensor]) -> None:
    """Every given tensor lies on one CUDA device and is contiguous."""
    devs = set()
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {arg} lies on {t.device}, "
                             f"not on a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {arg} must be contiguous")
        devs.add(t.device)
    if len(devs) > 1:
        raise ValueError(f"{kernel}: tensors on several devices {devs}")
    # the C launcher runs on the runtime's current device
    if devs and devs.pop().index not in (None, torch.cuda.current_device()):
        raise ValueError(f"{kernel}: tensors must lie on the current CUDA "
                         f"device ({torch.cuda.current_device()})")
