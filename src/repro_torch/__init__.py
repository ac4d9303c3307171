"""PyTorch/CUDA port of the ``repro`` gradient-quantization package.

A sibling of ``src/repro`` (the JAX reference, which this package never
imports). Module names mirror the reference so each counterpart is easy
to find. Plain tensor code is PyTorch; every Pallas kernel on a ported
path is a hand-written CUDA kernel for Hopper (``csrc/``), built with
``nvcc`` at first use and bound with ``ctypes``.

Dispatch goes by the tensor's device: a CPU tensor takes the kernel's
plain PyTorch version, a CUDA tensor launches the kernel (or raises).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
