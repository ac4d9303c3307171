"""Multi-pass DECODE + AVERAGE: level lookup and mean over L workers.

Port of the reference's Pallas kernel ``kernels/dequant_avg.py:
dequant_avg`` (``pl.pallas_call`` at line 50, body
``_dequant_avg_kernel``): the server side of Algorithm 2 on the
multi-pass path, L workers' (nb, d) level indices decoded with their own
level tables and averaged. The CUDA kernel is in ``csrc/multipass.cu``;
:func:`dequant_avg_plain` is its plain PyTorch version
(``ref.dequant_avg_ref``). Both accumulate ``out = fma(val, f32(1/L),
out)`` worker by worker from +0, the Pallas kernel's ``out += val * (1.0
/ L)`` in its order as XLA contracts it, so they are bit-equal to each
other and to the Pallas kernel for every L (the reference's own jnp
oracle sums first, then scales, and agrees only when L is a power of
two). An index outside [0, s) decodes to 0, as the one-hot sum gives.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

#: repro_dequant_avg(idx, levels, out, L, nb, d, s, inv, stream)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])


def _check(idx: torch.Tensor, levels: torch.Tensor) -> None:
    if idx.dim() != 3 or levels.dim() != 3 \
            or levels.shape[:2] != idx.shape[:2]:
        raise ValueError(f"idx (L, nb, d) and levels (L, nb, s) expected, "
                         f"got {tuple(idx.shape)} and "
                         f"{tuple(levels.shape)}")
    if idx.shape[0] < 1 or levels.shape[2] < 1:
        raise ValueError("no worker payloads or no levels to decode")


def dequant_avg_plain(idx: torch.Tensor, levels: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version: (L, nb, d) integer indices + (L, nb, s)
    levels -> (nb, d) f32 mean over the L workers."""
    _check(idx, levels)
    return _ref.dequant_avg_ref(idx, levels)


def dequant_avg_cuda(idx: torch.Tensor, levels: torch.Tensor
                     ) -> torch.Tensor:
    """Launch ``csrc/multipass.cu``'s dequant_avg kernel on the current
    stream; same contract as :func:`dequant_avg_plain`. idx int32, levels
    float32, both contiguous on one CUDA device."""
    _check(idx, levels)
    build.check_cuda("dequant_avg", idx=idx, levels=levels)
    if idx.dtype != torch.int32:
        raise TypeError(f"dequant_avg: idx must be int32, got {idx.dtype}")
    if levels.dtype != torch.float32:
        raise TypeError(f"dequant_avg: levels must be float32, got "
                        f"{levels.dtype}")
    L, nb, d = idx.shape
    out = torch.empty((nb, d), dtype=torch.float32, device=idx.device)
    if nb and d:
        launch = build.function("multipass", "repro_dequant_avg", _ARGTYPES)
        launch(idx.data_ptr(), levels.data_ptr(), out.data_ptr(), L, nb, d,
               levels.shape[2], float(np.float32(1.0 / L)),
               torch.cuda.current_stream().cuda_stream)
        dequant_avg_cuda.launches += 1
    return out


dequant_avg_cuda.launches = 0
