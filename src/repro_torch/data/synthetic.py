"""Deterministic synthetic streams (the reference's ``data/synthetic.py``),
bit-equal to it: the token stream ``SyntheticLM`` and the image stream
``cifar_like_batches``.

The token stream is a fixed random Markov chain over the vocabulary
(order 1, with a long-range copy channel), generated counter-based from
(seed, step) with
the reference's threefry keys (``core/prng``): the stream is
reproducible, shardable, and has real structure, so the training loss
falls measurably below ln(V).

The reference scans one row at a time. Here every key of the step is
derived at once, vectorised over batch and time (``split`` / ``randint``
/ ``uniform`` broadcast over key batches); only the state/history
recurrence runs as a loop over time.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    n_states: int = 64        # low-rank structure of the transition model
    copy_offset: int = 8      # long-range correlation: token repeats from t-8
    copy_prob: float = 0.3

    def _chain(self) -> torch.Tensor:
        """Static transition structure (numpy, as the reference draws it)."""
        rng = np.random.RandomState(self.seed)
        table = rng.randint(0, self.vocab_size, size=(self.n_states, 4))
        return torch.from_numpy(table.astype(np.int64))

    def batch(self, step: int, *, device=None) -> dict:
        """Batch for a global step: {tokens (B, S+1) int64} (the loss
        shifts off one position), drawn on ``device`` (the card unless
        ``device="cpu"``)."""
        device = resolve_device(device)
        table = self._chain().to(device)
        key = prng.fold_in(prng.key(self.seed, device=device), step)
        rows = prng.split(key, self.batch_size)              # (B, 2)
        k0, k1 = prng.split(rows).unbind(dim=-2)             # (B, 2) each
        hist = prng.randint(k0, (self.copy_offset,), 0, self.vocab_size)
        state = prng.randint(k1, (), 0, self.n_states)       # (B,)
        steps = prng.split(rows, self.seq_len + 1)           # (B, T, 2)
        sub = prng.split(steps, 3)                           # (B, T, 3, 2)
        pick = prng.randint(sub[..., 0, :], (), 0, 4)        # (B, T)
        copy = prng.uniform(sub[..., 1, :]) < torch.tensor(
            self.copy_prob, dtype=torch.float32)
        toks = []
        for t in range(self.seq_len + 1):
            choice = table[state % self.n_states, pick[:, t]]
            tok = torch.where(copy[:, t], hist[:, 0], choice)
            tok = tok % self.vocab_size
            hist = torch.cat([hist[:, 1:], tok[:, None]], dim=1)
            state = tok % self.n_states
            toks.append(tok)
        return {"tokens": torch.stack(toks, dim=1)}


def cifar_like_batches(batch_size: int, seed: int = 0, num_classes: int = 10,
                       device=None) -> Iterator[dict]:
    """Synthetic 32x32x3 image-classification stream standing in for
    CIFAR (class-conditional Gaussian blobs plus noise), drawn with
    numpy's ``RandomState`` exactly as the reference draws it: the
    prototypes from ``seed``, each step's labels then noise from
    ``seed * 100003 + step``. Yields {images (B, 32, 32, 3) float32 NHWC,
    labels (B,) int32} on ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    prototypes = rng.randn(num_classes, 32, 32, 3).astype(np.float32)
    step = 0
    while True:
        r = np.random.RandomState(seed * 100003 + step)
        labels = r.randint(0, num_classes, size=(batch_size,))
        noise = r.randn(batch_size, 32, 32, 3).astype(np.float32)
        images = prototypes[labels] * 0.7 + noise
        yield {"images": torch.from_numpy(images).to(device),
               "labels": torch.from_numpy(labels.astype(np.int32)).to(
                   device)}
        step += 1
