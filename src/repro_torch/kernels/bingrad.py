"""Fused BinGrad statistics + binary assignment at a given threshold.

Port of the reference's Pallas kernel ``kernels/bingrad.py: bingrad_pass``
(``pl.pallas_call`` at line 52, body ``_bingrad_kernel``): per bucket row,
the conditional sums and counts below / above a caller-given b₀ and the
assignment ``v >= b₀`` on valid slots, in one pass over the values. The
reference calls it from its kernel tests only (BinGrad-b's encode fuses
the whole fit into ``encode_bingrad_fused``). The CUDA kernel is in
``csrc/encode_bingrad.cu``; :func:`bingrad_pass_plain` is its plain
PyTorch version (``ref.bingrad_pass_ref``).

Parity: the assignment is exact; the sums are float-close across
summation orders (exact on values whose partial sums are exact in
float32), and NaN where the reference's are (its v * lo and v * hi take
a NaN or an infinity from a slot left out of the sum); the counts are
exact.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref


def _check(v, b0, mask):
    if v.dim() != 2:
        raise ValueError(f"v must be (nb, d), got {tuple(v.shape)}")
    if b0.shape != (v.shape[0], 1):
        raise ValueError(f"b0 must be ({v.shape[0]}, 1), got "
                         f"{tuple(b0.shape)}")
    if mask.shape != v.shape or mask.dtype != torch.bool:
        raise ValueError("mask must be a bool tensor shaped like v")


def bingrad_pass_plain(v: torch.Tensor, b0: torch.Tensor,
                       mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (nb, d) values + (nb, 1) b₀ + (nb, d) bool
    mask -> ((nb, d) int32 assignment, (nb, 4) f32 ``[sum_lo, cnt_lo,
    sum_hi, cnt_hi]``)."""
    _check(v, b0, mask)
    return _ref.bingrad_pass_ref(v, b0, mask)


#: repro_bingrad_pass(v, b0, mask, idx, part, nb, d, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def bingrad_pass_cuda(v: torch.Tensor, b0: torch.Tensor, mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the pass kernel of ``csrc/encode_bingrad.cu`` on the current
    stream; same contract as :func:`bingrad_pass_plain`. v/b0 float32,
    mask bool, all contiguous on one CUDA device."""
    _check(v, b0, mask)
    build.check_cuda("bingrad_pass", v=v, b0=b0, mask=mask)
    for name, t in (("v", v), ("b0", b0)):
        if t.dtype != torch.float32:
            raise TypeError(f"bingrad_pass: {name} must be float32, "
                            f"got {t.dtype}")
    nb, d = v.shape
    idx = torch.empty((nb, d), dtype=torch.int32, device=v.device)
    part = torch.empty((nb, 4), dtype=torch.float32, device=v.device)
    if nb:
        launch = build.function("encode_bingrad", "repro_bingrad_pass",
                                _ARGTYPES)
        launch(v.data_ptr(), b0.data_ptr(), mask.data_ptr(), idx.data_ptr(),
               part.data_ptr(), nb, d,
               torch.cuda.current_stream().cuda_stream)
        bingrad_pass_cuda.launches += 1
    return idx, part


bingrad_pass_cuda.launches = 0
