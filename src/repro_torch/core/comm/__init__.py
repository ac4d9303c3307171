"""Quantized communication: the wire format (``wire``: fit, round, pack,
decode; fused and multi-pass), the two-phase collectives of Algorithm 2
over ``torch.distributed`` (``collectives``) and the exchange engines
that lay a gradient tree out for them (``exchange``)."""
