"""Quantized communication: only the wire format is ported so far."""
