# Hand-written CUDA kernels for Hopper and their plain PyTorch versions.
#
#   ops.py            device dispatch (CPU -> plain version, CUDA -> kernel)
#   ref.py            plain oracles (the reference's kernels/ref.py twins)
#   fused_encode.py   encode_fused: clip -> round -> mask -> pack;
#                     qdq_fused: the same round stage, decoded in-register
#   fused_decode.py   decode_fused_mean / decode_fused_each: unpack ->
#                     level lookup [-> mean over workers]
#   fused_kv.py       decode_attend (fused dequant-attention), append_kv
#   fused_bingrad.py  encode_bingrad_fused: BinGrad-b's level fit +
#                     threshold + 1-bit pack in one launch
#   bingrad.py        bingrad_pass: conditional sums + assignment at b0
#   quant_rr.py       quant_rr: interval search + random rounding (the
#                     multi-pass round stage)
#   bitpack.py        pack / unpack: indices <-> uint32 wire words
#   dequant_avg.py    dequant_avg: level lookup + mean over workers
#   build.py          nvcc build into build/repro_torch/ + ctypes binding
#
# Sources live in ../csrc/.
