"""Quantized-KV continuous-batching serving engine (the reference's
``serve/engine.py``).

One forward serves both phases over the paged pools
(``serve/kv_cache.py``): batched decode at (max_batch, 1), chunked
prefill at (1, chunk). Each attention layer

    projects q/k/v for the incoming tokens, applies rope at their
    absolute positions, quantizes the new K/V rows (level fit, then ONE
    ``encode_fused`` launch for K and V together, or for BinGrad-b one
    ``encode_bingrad_fused`` launch that fits too: ``append_kv``), writes
    them into their pages, gathers the sequence's pages into a contiguous
    context view, and attends through the fused dequant-attention kernel
    (``ops.decode_attend``) — or, for the bf16 escape hatch, stores raw
    rows and runs the dense ``masked_decode_attention``.

Determinism: random-round schemes key their threefry stream on (request
seed, absolute position, layer, K/V), never on batch shape or slot
index (BinGrad-b and SignSGD round deterministically and draw none), so a sequence's greedy tokens are identical whether it runs alone
or mixed into a busy batch. Inactive decode slots point at the trash page
and their outputs are discarded.

The pools are updated in place (the reference donates them through its
jit); ``_forward`` returns the same pool objects.
"""
from __future__ import annotations

import time
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.fused_kv import append_kv
from repro_torch.models.attention import _scale, masked_decode_attention
from repro_torch.models.blocks import (_apply_norm, _ffn_train, _gqa_project,
                                       attn_spec, check_dense_gqa)
from repro_torch.models.layers import apply_rope, softcap
from repro_torch.models.model import LM, map_tree
from repro_torch.serve.kv_cache import (KVQuantSpec, TRASH_PAGE, append_rows,
                                        gather_context, init_kv_pools,
                                        pool_bytes, token_rbits)
from repro_torch.serve.scheduler import (Request, Scheduler, SeqState,
                                         ServeConfig)


def _layer_salt(gi: int, j: int, flavor: str) -> int:
    return zlib.crc32(f"kv/g{gi}/pos{j}/{flavor}".encode()) & 0x7FFFFFFF


class Engine:
    """Continuous-batching engine over a paged (quantized) KV cache.

    ``device=None`` runs on the card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch versions of the kernels."""

    def __init__(self, model: LM, params, cfg: ServeConfig, *,
                 device=None):
        self._validate(model)
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        mc = model.cfg
        self.kvq = KVQuantSpec(cfg.kv_quant, mc.num_kv_heads,
                               mc.resolved_head_dim, clip_c=cfg.clip_c)
        if not self.kvq.is_bf16:
            from repro_torch.core.comm import wire
            self.qz = self.kvq.quantizer()
            self._rr = wire._fused_mode(self.qz) == "rr"
        else:
            self.qz, self._rr = None, False
        self.C_max = cfg.max_context
        self.params = map_tree(lambda t: t.to(self.device), params)
        self.pools = init_kv_pools(model, self.kvq, cfg.resolved_num_pages,
                                   cfg.page_size, self.device)
        self.sched = Scheduler(cfg)
        self.page_table = np.zeros((cfg.max_batch, cfg.max_pages_per_seq),
                                   np.int32)
        self.seeds = np.zeros((cfg.max_batch,), np.int32)
        self._next_rid = 0
        # aggregate metrics
        self.prefill_time = 0.0
        self.prefill_tokens = 0
        self.decode_times: List[float] = []
        self.decode_tokens = 0
        self.forward_calls = 0      # every forward since construction

    @staticmethod
    def _validate(model: LM) -> None:
        mc = model.cfg
        bad = [s.kind for s in model.specs
               if s.kind not in ("attn", "attn_local")]
        if bad or mc.mla is not None or mc.encoder is not None:
            raise ValueError(
                f"paged KV serving supports GQA attention stacks only "
                f"(kinds={sorted(set(bad))!r}, mla={mc.mla is not None}, "
                f"encoder={mc.encoder is not None})")
        if any(s.moe for s in model.specs):
            raise ValueError("paged KV serving does not support MoE layers")
        for s in model.specs:
            check_dense_gqa(mc, s)

    def cache_bytes(self) -> int:
        return pool_bytes(self.pools)

    # ------------------------------------------------------------------
    # forward (decode at (max_batch, 1) / prefill at (1, chunk))
    # ------------------------------------------------------------------

    def _attn_layer(self, gi, j, spec, p, x, pool, table, qpos, mask,
                    seeds, rep):
        mc = self.model.cfg
        asp = attn_spec(mc, spec)
        B, T = x.shape[:2]
        KV, hd = mc.num_kv_heads, mc.resolved_head_dim
        xn = _apply_norm(mc, p["norm1"], x)
        q, k, v = _gqa_project(mc, p["attn"], xn)
        q = apply_rope(q, qpos, asp.rope_theta)
        k = apply_rope(k, qpos, asp.rope_theta)
        flat_pos = qpos.reshape(-1)
        pages = torch.gather(table, 1, qpos // self.cfg.page_size).reshape(-1)
        slots = flat_pos % self.cfg.page_size
        if spec.kind == "attn_local" and mc.window:
            carr = torch.arange(self.C_max, device=x.device)
            mask = mask & ((qpos[:, :, None] - carr[None, None, :])
                           < mc.window)
        if self.kvq.is_bf16:
            append_rows(pool, pages, slots,
                        {"k": k.reshape(B * T, KV, hd),
                         "v": v.reshape(B * T, KV, hd)})
            ctx = gather_context(pool, table)
            o = masked_decode_attention(q, ctx["k"], ctx["v"], mask, asp)
        else:
            d = KV * hd
            k_rows = k.to(torch.float32).reshape(B * T, d)
            v_rows = v.to(torch.float32).reshape(B * T, d)
            rbits = None
            if self._rr:
                seeds_rows = seeds.repeat_interleave(T)
                rk = token_rbits(seeds_rows, flat_pos,
                                 _layer_salt(gi, j, "k"), rep, d)
                rv = token_rbits(seeds_rows, flat_pos,
                                 _layer_salt(gi, j, "v"), rep, d)
                rbits = torch.cat([rk, rv], dim=0)
            kw, klv, vw, vlv = append_kv(self.qz, k_rows, v_rows, rbits)
            append_rows(pool, pages, slots,
                        {"kw": kw, "klv": klv, "vw": vw, "vlv": vlv})
            ctx = gather_context(pool, table)
            o = ops.decode_attend(
                q.to(torch.float32).contiguous(), ctx["kw"], ctx["klv"],
                ctx["vw"], ctx["vlv"], mask,
                bits=self.qz.wire_bits_per_element, kv_heads=KV,
                scale=_scale(asp), softcap=asp.attn_softcap)
            o = o.to(x.dtype)
        h = x + o.reshape(B, T, -1) @ p["attn"]["wo"]
        y, _ = _ffn_train(mc, spec, p["ffn"],
                          _apply_norm(mc, p["norm2"], h))
        return h + y

    @torch.no_grad()
    def _forward(self, params, pools, table, pos, seeds, tokens):
        """tokens (B, T) at absolute positions pos[b]..pos[b]+T-1 ->
        (last-position logits (B, V) f32, greedy next token (B,) int32,
        pools updated in place). Decode runs at T == 1 over max_batch
        slots; prefill at B == 1 over a chunk."""
        model, mc = self.model, self.model.cfg
        self.forward_calls += 1
        B, T = tokens.shape
        x = model._embed(params, tokens)
        qpos = pos[:, None] + torch.arange(T, device=tokens.device)[None]
        carr = torch.arange(self.C_max, device=tokens.device)
        mask = carr[None, None, :] <= qpos[:, :, None]     # (B, T, C_max)
        for gi, (g, gp, gpool) in enumerate(
                zip(model.groups, params["groups"], pools)):
            for rep in range(g.repeats):           # the reference's scan
                for j, spec in enumerate(g.unit):
                    pj = model._cast_tree(
                        map_tree(lambda t: t[rep], gp[f"pos{j}"]))
                    pool = {k: t[rep] for k, t in gpool[f"pos{j}"].items()}
                    x = self._attn_layer(gi, j, spec, pj, x, pool, table,
                                         qpos, mask, seeds, rep)
        x = x[:, -1:]
        x = model._final_norm(model._cast(params["final_norm"]), x)
        head = model._head(params)
        lg = (x @ head.to(x.dtype)).to(torch.float32)
        lg = softcap(lg, mc.final_softcap)[:, 0]            # (B, V)
        return lg, torch.argmax(lg, dim=-1).to(torch.int32), pools

    # ------------------------------------------------------------------
    # host loop
    # ------------------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=self.device)

    def submit(self, prompt, max_new: int, seed: Optional[int] = None,
               arrival: int = 0) -> int:
        """Queue a request; returns its rid. ``seed`` defaults to a hash
        of the prompt CONTENT (not the rid), so the same prompt draws the
        same quantization noise in any run composition."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if seed is None:
            seed = zlib.crc32(prompt.tobytes()) & 0x7FFFFFFF
        rid = self._next_rid
        self._next_rid += 1
        self.sched.submit(Request(rid=rid, prompt=prompt, max_new=max_new,
                                  seed=int(seed), arrival=arrival))
        return rid

    def _write_slot(self, st: SeqState) -> None:
        row = np.full((self.cfg.max_pages_per_seq,), TRASH_PAGE, np.int32)
        row[:len(st.pages)] = st.pages
        self.page_table[st.slot] = row
        self.seeds[st.slot] = st.req.seed

    def _clear_slot(self, st: SeqState) -> None:
        self.page_table[st.slot] = TRASH_PAGE
        self.seeds[st.slot] = 0

    def _emit(self, st: SeqState, tok: int, lg, now: float) -> None:
        st.generated.append(int(tok))
        st.token_times.append(now)
        if st.first_token_time < 0:
            st.first_token_time = now
        if self.cfg.record_logits:
            st.logits.append(np.asarray(lg))
        if st.done:
            self._clear_slot(st)
            self.sched.finish(st, now)

    def step(self) -> str:
        """Run one tick: admission, then one prefill chunk OR one batched
        decode step. Returns 'prefill' | 'decode' | 'idle'."""
        now = time.perf_counter()
        for st in self.sched.admit(now):
            self._write_slot(st)
        self.sched.tick += 1
        st = self.sched.next_prefill()
        if st is not None:
            T = min(self.cfg.prefill_chunk,
                    st.prompt_len - st.n_prefilled)
            toks = st.req.prompt[st.n_prefilled:st.n_prefilled + T]
            t0 = time.perf_counter()
            lg, ntok, self.pools = self._forward(
                self.params, self.pools,
                self._tensor(self.page_table[st.slot:st.slot + 1]),
                self._tensor([st.n_prefilled]),
                self._tensor(self.seeds[st.slot:st.slot + 1]),
                self._tensor(toks[None]))
            ntok = ntok.cpu().numpy()                  # waits for the card
            dt = time.perf_counter() - t0
            self.prefill_time += dt
            self.prefill_tokens += T
            st.n_prefilled += T
            if not st.in_prefill:
                self._emit(st, int(ntok[0]), lg[0].cpu().numpy(),
                           time.perf_counter())
            return "prefill"
        ready = self.sched.decode_ready()
        if not ready:
            return "idle"
        tokens = np.zeros((self.cfg.max_batch, 1), np.int32)
        pos = np.zeros((self.cfg.max_batch,), np.int32)
        table = np.full_like(self.page_table, TRASH_PAGE)
        for st in ready:
            tokens[st.slot, 0] = st.generated[-1]
            pos[st.slot] = st.next_pos
            table[st.slot] = self.page_table[st.slot]
        t0 = time.perf_counter()
        lg, ntok, self.pools = self._forward(
            self.params, self.pools, self._tensor(table),
            self._tensor(pos), self._tensor(self.seeds),
            self._tensor(tokens))
        ntok, lg = ntok.cpu().numpy(), lg.cpu().numpy()  # waits for the card
        dt = time.perf_counter() - t0
        self.decode_times.append(dt)
        self.decode_tokens += len(ready)
        now = time.perf_counter()
        for st in ready:
            self._emit(st, int(ntok[st.slot]), lg[st.slot], now)
        return "decode"

    def run(self, max_ticks: int = 100_000) -> Dict[int, SeqState]:
        """Drive ticks until every submitted request finishes."""
        for _ in range(max_ticks):
            if not self.sched.has_work:
                break
            kind = self.step()
            if kind == "idle" and not self.sched.waiting:
                break
        else:
            raise RuntimeError(f"engine did not drain in {max_ticks} ticks")
        if self.sched.has_work:
            raise RuntimeError(
                "engine idle with work left (arrivals in the future? "
                "call step() manually for open-loop workloads)")
        return dict(self.sched.finished)
