"""Continuous-batching scheduler: request admission, slot + page
bookkeeping, per-request lifecycle metrics.

Host-side state machine (a copy of the reference's ``serve/scheduler.py``;
no tensors). A request moves

    WAITING --admit--> PREFILLING --last chunk--> DECODING --max_new--> DONE
             (slot + pages            (first token                (pages
              allocated)               emitted)                    freed)

The engine drives one *tick* at a time: admission first, then either ONE
prefill chunk (lowest occupied slot still prefilling — prefill has
priority so admitted requests reach their first token quickly) or ONE
batched decode step over every fully-prefilled slot. Pages are allocated
up front at admission for the worst case ceil((prompt+max_new)/page_size)
so a running request can never be stranded mid-decode by pool exhaustion;
admission is all-or-nothing and FIFO.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.serve.kv_cache import PageAllocator


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static engine configuration (shapes are fixed at construction)."""

    kv_quant: str = "bf16"       # "bf16" | fused-encode scheme (e.g. orq-9)
    page_size: int = 16
    max_batch: int = 4           # decode-batch slots
    max_pages_per_seq: int = 16  # context cap = max_pages_per_seq*page_size
    num_pages: Optional[int] = None   # default: full occupancy + trash page
    prefill_chunk: int = 16
    clip_c: Optional[float] = None
    record_logits: bool = False  # keep per-token logits (drift metrics)

    @property
    def resolved_num_pages(self) -> int:
        if self.num_pages is not None:
            return self.num_pages
        return 1 + self.max_batch * self.max_pages_per_seq

    @property
    def max_context(self) -> int:
        return self.max_pages_per_seq * self.page_size


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int
    seed: int
    arrival: int = 0             # tick index at which it becomes visible


@dataclasses.dataclass
class SeqState:
    req: Request
    slot: int
    pages: List[int]
    n_prefilled: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)
    submit_time: float = 0.0
    first_token_time: float = -1.0
    finish_time: float = -1.0
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.req.prompt.shape[0])

    @property
    def in_prefill(self) -> bool:
        return self.n_prefilled < self.prompt_len

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.req.max_new

    @property
    def next_pos(self) -> int:
        """Absolute position of the next token fed to decode (= position
        at which the last generated token's KV is appended)."""
        return self.prompt_len + len(self.generated) - 1


class Scheduler:
    """Slot/page bookkeeping for the continuous-batching engine."""

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        self.alloc = PageAllocator(cfg.resolved_num_pages)
        self.waiting: Deque[Request] = deque()
        self.slots: List[Optional[SeqState]] = [None] * cfg.max_batch
        self.finished: Dict[int, SeqState] = {}
        self.tick = 0

    # -- submission ------------------------------------------------------

    def submit(self, req: Request) -> None:
        need = self.pages_needed(req)
        if need > self.cfg.max_pages_per_seq:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt.shape[0]} + "
                f"max_new {req.max_new} needs {need} pages > "
                f"max_pages_per_seq {self.cfg.max_pages_per_seq}")
        self.waiting.append(req)

    def pages_needed(self, req: Request) -> int:
        total = int(req.prompt.shape[0]) + req.max_new
        return -(-total // self.cfg.page_size)

    # -- per-tick transitions -------------------------------------------

    def admit(self, now: float) -> List[SeqState]:
        """FIFO all-or-nothing admission into free slots (arrived
        requests only). Returns the newly admitted states."""
        admitted = []
        for slot in range(self.cfg.max_batch):
            if self.slots[slot] is not None:
                continue
            if not self.waiting or self.waiting[0].arrival > self.tick:
                break
            pages = self.alloc.alloc(self.pages_needed(self.waiting[0]))
            if pages is None:
                break
            req = self.waiting.popleft()
            st = SeqState(req=req, slot=slot, pages=pages, submit_time=now)
            self.slots[slot] = st
            admitted.append(st)
        return admitted

    def next_prefill(self) -> Optional[SeqState]:
        for st in self.slots:
            if st is not None and st.in_prefill:
                return st
        return None

    def decode_ready(self) -> List[SeqState]:
        return [st for st in self.slots
                if st is not None and not st.in_prefill and not st.done]

    def finish(self, st: SeqState, now: float) -> None:
        """Evict a finished sequence: free its pages and its slot."""
        st.finish_time = now
        self.alloc.free(st.pages)
        self.slots[st.slot] = None
        self.finished[st.req.rid] = st

    @property
    def has_work(self) -> bool:
        return (bool(self.waiting)
                or any(st is not None for st in self.slots))
