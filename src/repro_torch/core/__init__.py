"""The paper's contribution: optimal gradient quantization (ORQ), in PyTorch.

    prng        threefry-2x32, bit-equal to the reference's jax.random
    encode      uint32 bit-packing of level indices
    rounding    uniform-from-bits map
    clipping    TernGrad σ-clip
    levels      ORQ's Algorithm 1
    quantizers  the Quantizer recipe; api: the scheme registry
    theory      the paper's exact error terms (expected / deterministic MSE)
    comm.wire   the (words, levels) wire unit
"""
