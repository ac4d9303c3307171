"""Quantized collectives: the distributed half of Algorithm 2, on
``torch.distributed`` (the reference's ``core/comm/collectives.py``).

The paper's parameter-server exchange maps onto two collective phases
over the data-parallel process group (NCCL on the card, gloo on the CPU):

  phase 1 (worker -> server)  ``quantized_reduce_scatter_mean``:
      each worker fits levels on its *local* gradient, quantizes,
      bit-packs, and ``all_to_all_single``s the int32 words + f32 level
      tables. Every worker then decodes the L received copies of its own
      chunk and averages (``decode_fused_mean``): it *is* the server for
      that chunk.

  phase 2 (server -> worker)  inside ``quantized_all_reduce_mean``:
      the averaged chunk is re-quantized (fresh levels, its own key) and
      ``all_gather``ed; every worker decodes each server's chunk
      (``decode_fused_each``), so all reconstruct identical gradients.
      ``server_requant=False`` gathers the f32 chunk instead.

The worker index is the process group rank, which plays the reference's
``axis_index`` over the dp axes; the key folds are the reference's:
``fold_in(key, worker)`` in phase 1 and ``fold_in(fold_in(key, 0x5EC0),
worker)`` in phase 2. With one process the same two phases run with
L = 1, as the reference runs them on a one-device mesh.

``pipeline_chunks = K > 1`` is the reference's pipelined schedule: both
phases split their bucket rows into K contiguous spans, each span encoded
and sent by its own collectives (issued with ``async_op=True``, waited on
only before that span's decode, so span k's transfer can overlap span
k+1's encode). The rounding stream is drawn once at the full layout and
sliced per span, so the result is bit-identical to K = 1.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.comm import wire
from repro_torch.core.comm.wire import bucket_len
from repro_torch.core.quantizers import Quantizer


def world(group=None) -> Tuple[int, int]:
    """(size, rank) of the data-parallel process group."""
    if not dist.is_initialized():
        raise RuntimeError(
            "the exchange runs over torch.distributed: initialize a process "
            "group first (one process is a world of one)")
    return dist.get_world_size(group), dist.get_rank(group)


def _start_all_to_all(x: torch.Tensor, group):
    """(L, ...) -> (L, ...): slice l goes to worker l; slice j of the
    result came from worker j (``lax.all_to_all`` split/concat axis 0).
    Returns (out, work): read ``out`` after ``work.wait()``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    return out, dist.all_to_all_single(out, x, group=group, async_op=True)


def _start_all_gather(x: torch.Tensor, group):
    """(...) -> (L, ...), stacked by rank (``lax.all_gather``, untiled).
    Returns (out, work): read ``out`` after ``work.wait()``."""
    L = dist.get_world_size(group)
    out = torch.empty((L * x.numel(),), dtype=x.dtype, device=x.device)
    # every torch 2.x has this call (newer releases also name it
    # all_gather_single and warn that this name is deprecated)
    work = dist.all_gather_into_tensor(out, x.contiguous().reshape(-1),
                                       group=group, async_op=True)
    return out.reshape((L,) + tuple(x.shape)), work


def _done(pending):
    """Wait on (out, work) pairs; -> the outs."""
    for _, work in pending:
        work.wait()
    return [out for out, _ in pending]


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    return _done([_start_all_gather(x, group)])[0]


def scatter_mean(parts: torch.Tensor, group) -> torch.Tensor:
    """Full-precision reduce-scatter mean: ``parts`` (L, ...) holds one
    slice per destination worker; returns this worker's slice of the
    across-worker mean. One all_to_all, then the L received slices summed
    in rank order and divided by L (``lax.psum_scatter(...) / L``). The
    order of additions is fixed, so NCCL and gloo agree bit for bit, and
    a + b commutes, so at L <= 2 it is any backend's order."""
    recv = _done([_start_all_to_all(parts, group)])[0]
    total = recv[0]
    for j in range(1, recv.shape[0]):
        total = total + recv[j]
    return total / recv.shape[0]


def _chunk_spans(n_rows: int, k) -> list:
    """Split ``n_rows`` bucket rows into ``k`` contiguous [a, b) spans
    (clamped to [1, n_rows]; the first ``n_rows % k`` spans get the extra
    row)."""
    k = max(1, min(int(k), n_rows))
    base, rem = divmod(n_rows, k)
    spans, a = [], 0
    for i in range(k):
        b = a + base + (1 if i < rem else 0)
        spans.append((a, b))
        a = b
    return spans


def _rs_mean_parts(parts: torch.Tensor, valid: torch.Tensor, qz: Quantizer,
                   key: torch.Tensor, group,
                   pipeline_chunks: int = 1) -> torch.Tensor:
    """parts (L, chunk) local contributions, one row per destination
    worker; valid (L, chunk) bool. ``key`` is already folded per worker.
    Returns this worker's (chunk,) mean slice: per span of bucket rows one
    encode, one pair of all_to_alls and one decode (one span unless
    ``pipeline_chunks > 1``)."""
    L, chunk = parts.shape
    d_eff = bucket_len(chunk, qz.bucket_size)
    pad = -(-chunk // d_eff) * d_eff - chunk
    parts = F.pad(parts.to(torch.float32), (0, pad))
    valid = F.pad(valid, (0, pad))
    nbc = parts.shape[1] // d_eff
    bkt = parts.reshape(L, nbc, d_eff)
    mask = valid.reshape(L, nbc, d_eff)
    spans = _chunk_spans(nbc, pipeline_chunks)
    rbits = None
    if len(spans) > 1:
        # drawn once at the full (L·nbc, d_eff) layout and sliced: threefry
        # counts over the flattened shape, so a span's own draw would differ
        rbits = wire.encode_rbits(qz, key, (L * nbc, d_eff), parts.device)
        rbits = None if rbits is None else rbits.reshape(L, nbc, d_eff)
    pending = []
    for a, b in spans:
        rows = L * (b - a)
        words, levels = wire.encode(
            qz, bkt[:, a:b].reshape(rows, d_eff),
            mask[:, a:b].reshape(rows, d_eff), key,
            rbits=None if rbits is None else rbits[:, a:b].reshape(rows,
                                                                    d_eff))
        # the wire: int32 payload + f32 level tables
        pending.append((_start_all_to_all(words.reshape(L, b - a, -1), group),
                        _start_all_to_all(levels.reshape(L, b - a, -1),
                                          group)))
    means = [wire.decode_mean(qz, *_done(pair), d_eff) for pair in pending]
    mean_bkt = means[0] if len(means) == 1 else torch.cat(means)
    return mean_bkt.reshape(-1)[:chunk]


def _valid_parts(valid: Optional[torch.Tensor], n: int, L: int, chunk: int,
                 device) -> torch.Tensor:
    """(L, chunk) bool validity for an (n,) buffer split into L chunks."""
    if valid is None:
        return (torch.arange(L * chunk, device=device) < n).reshape(L, chunk)
    return F.pad(valid, (0, L * chunk - n)).reshape(L, chunk)


def quantized_reduce_scatter_mean(flat: torch.Tensor, qz: Quantizer,
                                  key: torch.Tensor, *, group=None,
                                  worker_id: Optional[int] = None,
                                  valid: Optional[torch.Tensor] = None,
                                  pipeline_chunks: int = 1) -> torch.Tensor:
    """Each worker holds a full local gradient ``flat`` (n,). Returns this
    worker's (chunk,) slice of the across-worker mean, chunk = ceil(n/L).
    The fp scheme is :func:`scatter_mean` (an all_to_all and a sum in rank
    order).
    ``pipeline_chunks`` splits the exchange into that many bucket-row
    spans, bit-identical to the single-shot schedule."""
    n = flat.shape[0]
    L, rank = world(group)
    chunk = -(-n // L)
    me = rank if worker_id is None else worker_id
    padded = F.pad(flat, (0, L * chunk - n))
    if qz.is_identity:
        return scatter_mean(padded.to(torch.float32).reshape(L, chunk),
                            group)
    valid = _valid_parts(valid, n, L, chunk, flat.device)
    return _rs_mean_parts(padded.reshape(L, chunk), valid, qz,
                          prng.fold_in(key, me), group,
                          pipeline_chunks=pipeline_chunks)


def local_qdq_comm_layout(flat: torch.Tensor, qz: Quantizer,
                          key: torch.Tensor, *, group=None,
                          worker_id: Optional[int] = None,
                          valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """This worker's own dequantized gradient, bit-identical to what it
    contributed to :func:`quantized_reduce_scatter_mean` (same chunk and
    bucket layout, same folded key, same mask). Error feedback:
    e <- g - Q^-1(Q(g)), one ``qdq_fused`` launch."""
    n = flat.shape[0]
    L, rank = world(group)
    chunk = -(-n // L)
    padded = F.pad(flat.to(torch.float32), (0, L * chunk - n))
    d_eff = bucket_len(chunk, qz.bucket_size)
    pad2 = -(-chunk // d_eff) * d_eff - chunk
    parts = F.pad(padded.reshape(L, chunk), (0, pad2))
    valid = F.pad(_valid_parts(valid, n, L, chunk, flat.device), (0, pad2))
    me = rank if worker_id is None else worker_id
    vals = wire.qdq(qz, parts.reshape(-1, d_eff), valid.reshape(-1, d_eff),
                    prng.fold_in(key, me))
    return vals.reshape(L, -1)[:, :chunk].reshape(-1)[:n]


def quantized_all_reduce_mean(flat: torch.Tensor, qz: Quantizer,
                              key: torch.Tensor, *, group=None,
                              worker_id: Optional[int] = None,
                              server_requant: bool = True,
                              valid: Optional[torch.Tensor] = None,
                              pipeline_chunks: int = 1) -> torch.Tensor:
    """Full Algorithm 2 exchange. Returns the (n,) mean gradient,
    identical on every worker (the phase-2 decode is deterministic).
    ``valid`` optionally marks the real positions of ``flat``.
    ``pipeline_chunks`` pipelines both phases over the same bucket-row
    spans, bit-identical to the single-shot schedule."""
    n = flat.shape[0]
    L, rank = world(group)
    if qz.is_identity:
        total = flat.clone()
        dist.all_reduce(total, group=group)
        return total / L

    chunk = -(-n // L)
    mean_chunk = quantized_reduce_scatter_mean(
        flat, qz, key, group=group, worker_id=worker_id, valid=valid,
        pipeline_chunks=pipeline_chunks)
    if not server_requant:
        full = _all_gather(mean_chunk, group)
        return full.reshape(-1)[:n].to(flat.dtype)

    # phase 2: re-quantize the averaged chunk; broadcast payload + levels
    me = rank if worker_id is None else worker_id
    d_eff = bucket_len(chunk, qz.bucket_size)
    pad = -(-chunk // d_eff) * d_eff - chunk
    bkt = F.pad(mean_chunk, (0, pad)).reshape(-1, d_eff)
    ar = torch.arange(chunk + pad, device=flat.device)
    if valid is None:
        mask = (me * chunk + ar < n) & (ar < chunk)
    else:
        vchunk = F.pad(valid, (0, L * chunk - n))[me * chunk:
                                                  (me + 1) * chunk]
        mask = F.pad(vchunk, (0, pad))
    key2 = prng.fold_in(prng.fold_in(key, 0x5EC0), me)
    mask = mask.reshape(-1, d_eff)
    spans = _chunk_spans(bkt.shape[0], pipeline_chunks)
    rbits = (wire.encode_rbits(qz, key2, bkt.shape, bkt.device)
             if len(spans) > 1 else None)
    pending = []
    for a, b in spans:
        words, levels = wire.encode(
            qz, bkt[a:b], mask[a:b], key2,
            rbits=None if rbits is None else rbits[a:b])
        pending.append((_start_all_gather(words, group),
                        _start_all_gather(levels, group)))
    vals = [wire.decode_each(qz, *_done(pair), d_eff) for pair in pending]
    vals = vals[0] if len(vals) == 1 else torch.cat(vals, dim=1)
    vals = vals.reshape(L, -1)[:, :chunk]            # (L, chunk)
    return vals.reshape(-1)[:n].to(flat.dtype)
