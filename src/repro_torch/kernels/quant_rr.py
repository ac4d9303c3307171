"""Multi-pass ROUND: interval search + unbiased random rounding.

Port of the reference's Pallas kernel ``kernels/quant_rr.py: quant_rr``
(``pl.pallas_call`` at line 74, body ``_quant_rr_kernel``): every value is
mapped to a level index, ``k + (bits * 2**-32 < (v - lo) / (hi - lo))``
with ``lo, hi`` the levels around ``v`` (Eq. 7). The CUDA kernel is in
``csrc/multipass.cu`` and rounds with the fused encode's round stage
(``csrc/round.cuh``); :func:`quant_rr_plain` is its plain PyTorch
version, the reference's compare-accumulate and one-hot select
(``core.rounding.random_round``). Both are exact, so they are bit-equal
to each other and to the Pallas kernel for ascending level tables, which
every fit gives.

Rounding words are int32 tensors holding uint32 bit patterns (uint32 is
taken too); indices are int32, the reference's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import rounding as R
from repro_torch.kernels import build

MAX_LEVELS = 17          # the kernel's level-table capacity (s <= 17)

#: repro_quant_rr(v, levels, rbits, out, nb, d, s, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check(v: torch.Tensor, levels: torch.Tensor, bits: torch.Tensor):
    if v.dim() != 2 or levels.dim() != 2 or levels.shape[0] != v.shape[0]:
        raise ValueError(f"v (nb, d) and levels (nb, s) expected, got "
                         f"{tuple(v.shape)} and {tuple(levels.shape)}")
    if not 2 <= levels.shape[1] <= MAX_LEVELS:
        raise ValueError(f"quant_rr takes 2..{MAX_LEVELS} levels, got "
                         f"{levels.shape[1]}")
    if bits.shape != v.shape:
        raise ValueError(f"bits must be shaped like v {tuple(v.shape)}, "
                         f"got {tuple(bits.shape)}")


def quant_rr_plain(v: torch.Tensor, levels: torch.Tensor,
                   bits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (nb, d) values + (nb, s) ascending levels +
    (nb, d) uint32 rounding words -> (nb, d) int32 level indices."""
    _check(v, levels, bits)
    return R.random_round(v, levels, bits)


def quant_rr_cuda(v: torch.Tensor, levels: torch.Tensor,
                  bits: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/multipass.cu``'s quant_rr kernel on the current
    stream; same contract as :func:`quant_rr_plain`. v/levels float32,
    bits int32 or uint32, all contiguous on one CUDA device."""
    _check(v, levels, bits)
    build.check_cuda("quant_rr", v=v, levels=levels, bits=bits)
    for name, t, dts in (("v", v, (torch.float32,)),
                         ("levels", levels, (torch.float32,)),
                         ("bits", bits, (torch.int32, torch.uint32))):
        if t.dtype not in dts:
            raise TypeError(f"quant_rr: {name} must be {dts}, got {t.dtype}")
    nb, d = v.shape
    out = torch.empty((nb, d), dtype=torch.int32, device=v.device)
    if nb and d:
        launch = build.function("multipass", "repro_quant_rr", _ARGTYPES)
        launch(v.data_ptr(), levels.data_ptr(), bits.data_ptr(),
               out.data_ptr(), nb, d, levels.shape[1],
               torch.cuda.current_stream().cuda_stream)
        quant_rr_cuda.launches += 1
    return out


quant_rr_cuda.launches = 0
