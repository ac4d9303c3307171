#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. env      torch / CUDA versions, the card's name and power limit.
2. build    compile every CUDA kernel (one nvcc per source, in parallel).
3. kernels  each kernel against its plain PyTorch version: ``encode_fused``
            at the serving path's shapes, ``decode_attend`` within ATOL;
            ``decode_fused_mean`` (L = 1, 3, 4) and ``decode_fused_each``
            bit-equal by value; ``qdq_fused`` bit for bit (rr, bin, sign,
            clip, s 2-5, 7, 9, 17, d 2048 / 300 / 97, one row, tied
            levels, NaN, ±inf and -0.0 values, NaN and infinite levels,
            ``_qdq_edge``), ``encode_fused`` also on non-finite values
            under a clip;
            ``encode_bingrad_fused`` and ``bingrad_pass`` at the KV shape
            (16 rows of 768) and the training shape, bit-equal on
            multiples of 1/64, elsewhere levels / sums within LEVEL_RTOL
            and words the exact threshold of the kernel's own levels; the
            encode's levels also bit-equal to ``kernel_order_levels`` (its
            order of additions in plain PyTorch) in every case, which
            include the training buffer cut into rows of 4096 (the block
            path) and of 2047 (the warp path's 4-byte copies).
            The multi-pass kernels: ``quant_rr`` (s 2, 3, 5, 9, 17),
            ``pack`` and ``unpack`` (bits 1-5), ``dequant_avg`` (L 1, 3,
            4), bit-equal at nb 5 × d 37, nb 1 × d 129 and the training
            shape.
            Times per call of the kernel, the plain version and the library
            yardstick: ``*ms`` from CUDA events around back-to-back calls
            (host work between launches included), ``*device_ms`` the
            kernels' own time from torch.profiler; beside the least time
            the card could take (bytes over 3.35 TB/s or float32
            operations over 67 TFLOP/s, the larger; for ``decode_attend``
            only the positions the mask admits). ``decode_attend`` also
            prints its context splits and the tiles its blocks walk (the
            rest it skips), and is timed at the serving phase's positions
            and at head dims 16 and 256 too. The training kernels are
            timed at the training path's shape (66,058 buckets of 2048):
            ``encode_fused`` at 4, 1 and 3 bits, both decodes at 4 and at
            1 bit and at L = 4 (4 workers' chunks of 16,515 rows).
            Then ``encode_fused``, ``qdq_fused``, both decodes (L = 1 and
            4) and ``encode_bingrad_fused`` at the shapes only the
            per-leaf and pipelined schedules give them: one row of 768,
            one row of 192, 5 rows of 2048 with 1024 valid in the last,
            and the last K = 4 span (16,514 rows, 768 valid in the last),
            by the same rules. Then the same five kernels at the shapes
            only fsdp and the two-level hierarchy give them (FSDP_SHAPES:
            the fsdp reduce-scatter's L = 4 chunks of 16,515 rows, the
            67,642,752-value two-level intra shard as one buffer of
            33,029 rows, a per-leaf fsdp slice of 288 rows), each checked
            and timed beside its bound.
4. serve    the serving path: ``repro_torch.launch.serve`` on full-width
            lm-100m (bf16 weights from seed 0), orq-9 KV pages, page 16,
            batch 8, context 512, prefill chunk 64, 8 requests of 128
            prompt tokens and 32 new tokens after a warm-up request. Every
            launch counter is zeroed just before; the KV encode and
            ``decode_attend`` must read forward calls x layers just after,
            every other kernel 0.
5. check    the smoke-size engine on the card against the same engine on
            the CPU (the plain versions, which the CPU tests hold against
            the JAX reference): logits within ATOL_LOGITS.
6. profile  device time by kernel and by category over two decode steps
            (torch.profiler), beside the same steps' wall time without
            the profiler; busy share = device time / unprofiled wall.
   Phases 4-6 run again with BinGrad-b KV pages (``encode_bingrad_fused``,
   208 bytes per token-layer); the check also holds the first layer's
   pages on the card (levels against the plain fit, words the threshold
   of the kernel's levels) and the logits within ATOL_LOGITS_BIN.
7. train    the training path: ``repro_torch.launch.train`` on full-width
            lm-100m (f32 weights from seed 0), orq-9, bucket 2048, batch
            8, seq 128, a world of one on NCCL (``file://`` store): 3
            steps, then 2 with error feedback. The counters are zeroed
            just before and must read encode 10, mean 5, each 5, qdq 2
            just after; losses finite; wire bytes per worker 140,042,960;
            replicas in sync; params sha256 equal to ORQ9_SHA256. Then
            device time by category over one EF step
            (torch.profiler), beside their unprofiled wall. Then BinGrad-b
            the same way (encode_bingrad_fused 12, mean 5, each 5, qdq 2;
            34,878,624 wire bytes; its params sha256 equal to PR 20's),
            and one step of each other scheme
            (bingrad-pb, terngrad, qsgd-5, linear-5, minmax2, signsgd;
            encode 2, mean 1, each 1; the reference's wire bytes).
8. exchange the smoke-size fused exchange of a buffer of multiples of 1/64
            (every fit's sums exact in any order) on the card and on the
            CPU (gloo), for every scheme: outputs and EF residuals
            bit-equal.
9. multipass lm-100m's full-width gradient (seed 0, batch 8 × 128)
            through ``wire.encode_multipass`` and the multi-pass decodes
            for every scheme, held against the fused path (encode and
            mean decode bit-equal, BinGrad-b's levels within LEVEL_RTOL;
            per-worker decode by value) at L = 1 and 4, with the launch
            counts of each call and both paths' times. (The four kernels
            are checked and timed in phase 3: torch.profiler has been
            seen to lose kernel events late in this long process.)
10. train_pipelined  the launcher with ``--pipeline-chunks 4``: orq-9 and
            BinGrad-b, 3 steps then 2 with error feedback, and orq-9's 3
            steps at K = 3: params sha256 equal to the K = 1 runs of
            phase 7, 4K collective launches a step, the same wire bytes,
            the kernels' launch counts (encode 8 a step at K = 4, ...).
11. train_per_leaf   the launcher with ``--per-leaf-exchange``: orq-9 and
            BinGrad-b, one step then one with error feedback: 48
            collective launches a step, 140,043,800 / 34,878,832 wire
            bytes, 24 encodes, 12 decodes of each kind and 12 qdq a step.
            Then the per-leaf exchange and its EF residuals of five leaves
            of the full-width gradient (final_norm, wq, norm1, norm2 and
            the FFN's wo) on the 1/64 grid, card (NCCL) against CPU
            (gloo).
12. theory  ``scheme_mse`` of the full-width gradient for every scheme,
            timed on the card; its first 1024 buckets on the card and on
            the CPU within THEORY_RTOL.
13. train_local  two steps of the single-device step (no collective)
            for orq-9 and BinGrad-b with error feedback: finite losses,
            step times. Before it (in phase 12's process group, which it
            does not use): the same step, fused and per leaf, on a model
            whose gradient is fixed (the leaves of phase 11 but wo on the
            1/64 grid), card against CPU over two steps, the second with
            the first's residual: step 1 bit-equal, step 2 within
            LOCAL_RESIDUAL_RTOL / LOCAL_UPDATE_RTOL.
14. serve_dense  the launcher without ``--kv-quant`` (the dense
            ring-buffer path) on full-width lm-100m, batch 8, prompt 128,
            32 new tokens, context 512, chunk 64, then the bf16 paged
            engine on the same prompts: equal greedy tokens; prefill and
            decode tok/s, step p50 / p99, cache bytes, tokens sha256;
            then device time by category over four dense decode steps.
            Phases 12-14 are plain PyTorch, as in the reference: every
            counter must read 0 after them.
15. train_fsdp  the launcher with ``--mode fsdp`` (ZeRO-3) on full-width
            lm-100m, the NCCL world of one: orq-9 and BinGrad-b, 3 steps
            then 2 with error feedback. Each sharded group is one
            quantized reduce-scatter (phase 1 only), so the counters must
            read encode 5, mean 5, each 0, qdq 2 (BinGrad-b:
            encode_bingrad_fused 7, mean 5, each 0, qdq 2); 2 collective
            launches a step; wire bytes 70,021,480 / 17,439,312; losses
            finite; step p50, each run's own peak memory (above what was
            allocated at its start) and params sha256 printed. Then
            device time by category over one fsdp orq-9 EF step;
            ``--hierarchy two_level`` on this world of one: the flat
            run's sha256 (encode 3, mean 3); one per-leaf fsdp step: 222
            launches, 111 encodes and 111 mean decodes. After phase 11's
            check: the fsdp exchange and its EF residuals of phase 11's
            five full-width leaves on the 1/64 grid, card (NCCL) against
            CPU (gloo), bit-equal.
16. checkpoint  ``--smoke`` fsdp orq-9 with error feedback: 4 steps
            writing the state after step 2, then ``--resume`` of it: the
            same params sha256 (encode, mean and qdq 6 each over both
            runs); the resumed run's ``--checkpoint`` file hashes to
            its params sha256. Then the save and load of a full-width params
            checkpoint (541 MB of float32), timed once.

17. train_bit_schedule  ``--bit-schedule "norm|bias=fp,default=orq@5..1"
            --resolve-every 1`` on full-width lm-100m with error feedback,
            one step at each of 5, 4, 3, 2 and 1 wire bits (orq-17, orq-9,
            orq-5, orq-3, minmax2, the EF residual carried across): per
            step the assignment, the launches (encode 2, mean 1, each 1,
            qdq 1), the wire bytes (the static policy's at that width) and
            the step time; a frozen ``orq@4`` ends on the static
            ``default=orq-9`` run's sha256, replicated and fsdp; then a
            ``ScheduledTrainStep`` whose controller prices on the flat
            4-worker link with the static orq-9 policy's bytes as its
            budget: step 0 capped at 4 bits, the later decisions
            statistics-driven, each within the budget.
18. train_async  ``hierarchy="two_level_async"``, orq-9 with error
            feedback, on a pod of one (``make_train_step(...,
            pod_axis=True)``): H = 2 over 4 steps, inner steps with no
            kernel and no wire collective, sync steps the flat EF step's
            (and the anchor as params after them), the p50 of each kind;
            H = 1 (``--local-steps 1``) and ``--hierarchy two_level``
            through the launcher end on phase 7's flat EF sha256. After
            phase 15's check: the sync step on five full-width leaves
            (phase 11's and the FFN's wo) from a state on the grid, card
            (NCCL) against CPU (gloo), bit-equal.
19. paper_cifar  ``repro_torch.launch.paper_cifar.train`` on the card,
            3 steps of every method of the reference example (fp,
            terngrad, orq-3, orq-9, BinGrad-b) on the example's ResNet
            (width 16, one block a stage: 25 leaves, 77,850 params) and on
            ResNet-20 (61 leaves, 272,282 params): counters zeroed just
            before each run must read qdq_fused leaves x steps (BinGrad-b
            also encode_bingrad_fused leaves x steps; fp nothing); finite
            losses, step times, loss and accuracy. Then card against CPU
            from the same weights, batch and keys: the first gradient
            within CIFAR_GRAD_ATOL of each leaf's largest entry, each
            leaf's qdq of one fixed gradient bit-equal (terngrad, orq-3,
            orq-9; BinGrad-b within LEVEL_RTOL but FLIP_SHARE), the params
            after one fp step, and after one orq-9 optimizer step from
            each side's qdq of the same gradient, within lr x the
            gradient's bound.
20. serve_archs  qwen1.5-32b, command-r-plus-104b, chameleon-34b,
            gemma2-9b and gemma3-27b at full width with the depth cut to
            one cycle of the layer pattern (1, 1, 1, 2, 6 layers; bf16
            weights drawn on the card), the paged engine with orq-9 pages:
            two prompts 64 tokens past the window (or of 128), 3 greedy
            tokens; encode and decode_attend launches = forward calls x
            layers. Every ``decode_attend`` call of one decode step held
            against its plain version within ATOL_ATTEND (hd 128 / 256, GQA
            ratios 1-12, softcap 50, the window mask) and the KV encode bit
            for bit, both timed; then one ``--smoke`` orq-9 training step
            of each through the launcher.
21. moe_mla  mixtral-8x22b (one MoE layer) and deepseek-v2-236b (its
            dense first layer, then one MLA + MoE layer of 160 routed and
            2 shared experts) at full width, weights drawn on the card,
            each peak reckoned before the draw: the serving launcher's
            dense path (chunked prefill for mixtral, token by token for
            MLA) of 8 prompts of 64 tokens, then 8 decode steps; prefill
            seconds, decode p50 and tok/s, own peak, the MoE capacity and
            dropped share at prefill and at decode, the cache bytes a
            token and layer (MLA: (kv_lora + rope) x 2 = 1152 against 2 x
            H x hd x 2); every counter 0 (plain PyTorch, as in the
            reference). Card against CPU at the smoke sizes: ``moe_ffn``
            in f32 with drops (routing equal, y within MOE_ATOL_F32), one
            MLA decode step in f32, a bf16 forward (routing agreement;
            logits within ATOL_BF16 routed as the CPU). Then ``--smoke``
            training of each, orq-9 and BinGrad-b, 2 steps and 1 with
            error feedback on a world of one: the fused path's launches
            (encode 6 / BinGrad-b 7, mean 3, each 3, qdq 1), 4
            collectives a step, aux > 0, ``policy_stats``' wire bytes;
            every kernel call of the EF step recorded at its dispatcher
            and held against its plain version on the same inputs (buckets
            of 512 with a ragged last row), by phase 3's rules.
22. recurrent  jamba-v0.1-52b (28 Mamba and 4 attention layers) and
            rwkv6-3b (32 RWKV-6 layers) at full width and full depth,
            weights drawn on the card, each peak reckoned before the draw:
            the serving launcher's dense path, 8 prompts of 64 tokens
            prefilled token by token (no chunked prefill for a recurrent
            layer, as in the reference), then 8 decode steps; prefill
            seconds, decode p50 / p99 and tok/s, own peak, the cache
            bytes (exactly the reference's ``init_cache(8, 128)``: K/V a
            token of an attention layer, the recurrent state a sequence
            of a Mamba or RWKV layer); every counter 0. Card against CPU
            at the smoke sizes: ``mamba_forward``, a ``mamba_decode_step``
            chain with its states, ``_wkv_scan``, ``time_mix``, the
            channel mix and one RWKV decode step in f32 (REC_ATOL_F32),
            then a bf16 forward (jamba routed as the CPU; rwkv6 on the
            tokens its group norms leave well-conditioned) within
            ATOL_BF16. Then ``--smoke`` training of each through phase
            21's checks (launches, collectives, wire bytes, every EF-step
            kernel call against its plain version; aux 0 for rwkv6), and
            one full-width training forward + backward of one layer each
            (batch 8 x 128, bf16): ms and own peak.
23. whisper  whisper-base (6 encoder + 6 decoder layers, layer norm,
            cross-attention over 1500 frames) at full width and depth:
            (a) the serving launcher's dense path, weights drawn on the
            card, 8 prompts of 64 tokens in one chunk after the encoder's
            ``warm_cache`` (timed on its own), then 8 decode steps: warm
            seconds, prefill seconds, decode p50 / p99, own peak, the
            cache bytes (exactly the reference's ``init_cache(8, 128)``,
            160,041,984) and every counter 0; (b) card against CPU at the
            smoke size: ``layer_norm``, ``dense_mlp`` and the chunked
            attention (cross, ragged key chunks; the encoder's) in f32
            within WHISPER_ATOL_F32, the encoder's output, logits,
            warmed cross K/V and served logits in bf16 within ATOL_BF16,
            gradients within WHISPER_GRAD_REL; (c) ``make_train_step``
            on the NCCL world of one with ``{tokens, enc_embeds}``
            batches at the smoke size, orq-9 and BinGrad-b, bucket 512,
            2 steps then 1 with error feedback: phase 21's launches, 4
            collectives a step, ``policy_stats``' wire bytes (266,888 /
            65,808), every EF-step kernel call against its plain
            version; (d) the same at published widths, bucket 2048,
            8 x 128 tokens and (8, 1500, 512) frames: wire bytes
            101,427,160 / 25,261,104 at L = 1, step p50 and own peak.
24. model_parallel  lm-100m at full width, tensor-parallel in a 1
            (data) x 2 (model) world of two processes sharing the card
            (``python3 chip_smoke.py --model-parallel-worker RANK DIR``,
            started by the script): a gloo world, each process's dp group
            a one-rank NCCL group, the model group gloo on CUDA tensors
            (NCCL refuses two ranks on one card); each group's backend is
            printed. (a) the training and serving plans and their quirks;
            (b) the launcher (``train(argv, mesh=...)``) on the stream of
            phase 7, 2 + 1 EF replicated orq-9 steps and 2 BinGrad-b
            steps: every kernel call recorded at its dispatcher and held
            against its plain version by phase 21's rules, the launches a
            process (encode 6, mean 3, each 3, qdq 1; BinGrad-b encode 4,
            mean 2, each 2), the world of one's wire bytes, dp and
            model-group collectives a step, step ms and own peak; (c) 2
            per-leaf fsdp orq-9 steps (222 encodes and mean decodes at the
            TP blocks' shapes, held the same way); (d) the sharded dense
            decode, batch 8 and context 512, 64 prompt tokens through the
            chunked prefill then 8 greedy steps, then ``seq_sharded`` with
            batch 1 (8 steps): p50, and on rank 0 the logits against the
            same card's world of one fed the same tokens (within
            MP_ATOL; greedy picks equal where its top-2 margin exceeds
            MP_MARGIN). A failure in either process fails the phase. Times
            through the gloo model group are not tensor-parallel speed.
    Phase 3 times ``encode_fused``, ``qdq_fused`` and both decodes at the
    training shape at 2 and 5 bits too (the schedule's widths).

Then the kernels JSON line (all eleven kernels), the ``nvidia-smi``
name/power line, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2 cache (at most 50 MB)
#: a device time under this share of ``hbm_floor_ms`` is a lost profile
FLOOR_SLACK = 0.95
ATOL_ATTEND = 1e-5             # online softmax reorders the f32 sums
ATOL_LOGITS = 0.25             # bf16 matmuls + 4-bit rounding flips
ATOL_LOGITS_BIN = ATOL_LOGITS  # bf16 matmuls + 1-bit threshold flips
                               # (0.039 read on the card)
#: idle seconds at each end of a profiling window: torch.profiler can drop
#: kernel events near the edges of its window
PROFILE_PAD_S = 0.1


T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line; ``t_s`` is the script's wall seconds so far, so the
    gaps between lines break each phase's time down."""
    print(json.dumps({"phase": phase, **kw,
                      "t_s": time.perf_counter() - T_START}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Milliseconds per call: CUDA events around ``reps`` back-to-back
    calls, after a warm-up; the median of ``rounds`` such runs. Host work
    between launches (the wrapper's checks) counts, as it does on the
    serving path."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / reps)
    return statistics.median(per_call)


def _kernel_events(prof):
    """(self device us, name, count) of the device-side (kernel) events
    of a profile; host-side ops are left out so nothing counts twice."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us:
            rows.append((float(us), e.key, e.count))
    return sorted(rows, reverse=True)


def hbm_floor_ms(bytes_moved: int) -> float:
    """The least device time a call moving ``bytes_moved`` can take even
    when repeated calls find their inputs in the L2 cache: the bytes beyond
    the L2's size over the HBM rate."""
    return max(0, bytes_moved - L2_BYTES) / HBM_BYTES_PER_S * 1e3


def device_ms(fn, calls: int = 10, attempts: int = 5,
              floor_ms: float = 0.0) -> float:
    """Milliseconds of device (kernel) time per call, from torch.profiler:
    the sum of the device times of every kernel ``fn`` launches. Each call
    launches the same kernels, so every kernel's event count is a multiple
    of ``calls`` unless the profiler lost events (seen on the card: one of
    ten, now and then; once, every event of a profile; once, events whose
    recorded durations were short). A profile that lost events, or whose
    time per call is under ``FLOOR_SLACK`` x ``floor_ms`` (``hbm_floor_ms``
    of the work: the card cannot be that fast, so kernel events went
    missing), is taken again, up to ``attempts`` profiles. If none is
    whole, each profile that recorded kernels gives an estimate: each
    kernel's mean recorded duration times its launches per call (the count
    rounded up to a multiple of ``calls``); the median of the estimates
    that clear the floor is returned. If no estimate clears it, the time
    is CUDA events around the calls (``time_ms``), which counts host gaps
    too and so never reads under the device time. Every fallback is
    reported; it raises if even the events time is under the floor."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    readings, estimates = [], []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        rows = _kernel_events(prof)
        per_call = sum(r[0] for r in rows) / calls / 1e3
        whole = rows and all(count % calls == 0 for _, _, count in rows)
        if whole and per_call >= FLOOR_SLACK * floor_ms:
            return per_call
        emit("profiler", lost_events={n[:60]: c for _, n, c in rows},
             calls=calls, ms=per_call, floor_ms=floor_ms)
        readings.append(per_call)
        if rows:
            estimates.append(sum(us / count * -(-count // calls)
                                 for us, _, count in rows) / 1e3)
    cleared = [e for e in estimates if e >= FLOOR_SLACK * floor_ms]
    if cleared:
        return statistics.median(cleared)
    events_ms = time_ms(fn, reps=calls, rounds=3)
    emit("profiler", fallback="events", readings=readings,
         estimates=estimates, events_ms=events_ms, floor_ms=floor_ms)
    if events_ms < FLOOR_SLACK * floor_ms:
        raise AssertionError(
            f"device time of {fn} stays under its HBM floor "
            f"{floor_ms:.6f} ms: profiles {readings}, estimates "
            f"{estimates}, events {events_ms} ms")
    return events_ms


def _category(kernel_name: str) -> str:
    n = kernel_name.lower()
    for k in ("decode_attend", "encode_fused", "qdq_fused", "decode_mean",
              "decode_each", "encode_bingrad", "bingrad_pass"):
        if k in n:
            return k
    if "nccl" in n:
        return "nccl"
    if any(k in n for k in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul"
    if any(k in n for k in ("sort", "radix", "scan")):
        return "sort_cumsum"
    if "<long" in n:
        return "int64_elementwise"
    return "other"


def _by_category(rows):
    """Device us and launches by ``_category`` of profile rows."""
    by_cat = {}
    for us, name, count in rows:
        c = by_cat.setdefault(_category(name), {"device_us": 0.0,
                                                "launches": 0})
        c["device_us"] += us
        c["launches"] += count
    return by_cat


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(bytes_moved: int, f32_ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = f32_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_encode(torch, dev):
    from repro_torch.core import levels
    from repro_torch.kernels import fused_encode as fe

    g = torch.Generator(device="cpu").manual_seed(1)
    # KV rows are all valid, so the serving path's cases pass no mask
    cases = {  # name -> (rows, d, s, bits, mode, masked, clip_c)
        "decode_rows16": (16, 768, 9, 4, "rr", "none", None),
        "prefill_rows128": (128, 768, 9, 4, "rr", "none", None),
        "bin": (16, 768, 2, 1, "bin", "none", None),
        "sign": (16, 768, 2, 1, "sign", "random", None),
        "ragged_d100_bits3": (16, 100, 5, 3, "rr", "random", None),
        "clip_c2.5": (16, 768, 9, 4, "rr", "none", 2.5),
    }
    results = {}
    for name, (nb, d, s, bits, mode, masked, clip_c) in cases.items():
        v = torch.randn((nb, d), generator=g) * 0.3
        mask = {"none": None,
                "random": torch.rand((nb, d), generator=g) > 0.1}[masked]
        fit_mask = mask if mask is not None else torch.ones_like(v,
                                                                 dtype=bool)
        if mode == "rr":
            K = (s - 1).bit_length() - 1
            lv = levels.orq_levels(v, fit_mask, K)
        else:
            lv = torch.sort(torch.randn((nb, s), generator=g) * 0.3).values
        rb = (torch.randint(-2 ** 31, 2 ** 31, (nb, d), generator=g,
                            dtype=torch.int64).to(torch.int32)
              if mode == "rr" else None)
        lim = fe.clip_limit(v, mask, clip_c)
        cpu = (v, lv, rb, mask, lim)
        want = fe.encode_fused_plain(*cpu, bits=bits, mode=mode)
        gpu = [None if t is None else t.to(dev) for t in cpu]
        got = fe.encode_fused_cuda(*gpu, bits=bits, mode=mode)
        torch.cuda.synchronize()
        mism = int((got.cpu() != want).sum())
        plain_gpu = fe.encode_fused_plain(*gpu, bits=bits, mode=mode)
        kern = lambda: fe.encode_fused_cuda(*gpu, bits=bits, mode=mode)
        plain = lambda: fe.encode_fused_plain(*gpu, bits=bits, mode=mode)
        ms, plain_ms = time_ms(kern), time_ms(plain)
        moved = nbytes(*gpu, got)
        b_ms, b_by = bound(moved, nb * d * (2 * s + 8))
        dev_ms, plain_dev_ms = device_ms(
            kern, floor_ms=hbm_floor_ms(moved)), device_ms(plain)
        results[name] = dict(
            shape=[nb, d], s=s, bits=bits, mode=mode, mask=masked,
            clip_c=clip_c, words_mismatched=mism,
            plain_on_card_mismatched=int((plain_gpu != got).sum()),
            max_abs_err=float(mism), ms=ms, plain_ms=plain_ms,
            library_ms=None, device_ms=dev_ms, plain_device_ms=plain_dev_ms,
            bytes=moved, bound_ms=b_ms, bound_by=b_by,
            warps_blocks=fe.encode_grid(nb, d, bits))
        emit("kernel", kernel="encode_fused", case=name, **results[name])
        if mism:
            raise AssertionError(f"encode_fused {name}: {mism} words differ "
                                 f"from the plain version")
    # non-finite values and levels under a clip (a NaN value or limit
    # clips to NaN and rounds to index 0), untimed
    for bits, s in ((1, 2), (4, 9), (4, 12), (5, 17)):
        for edge in ("nonfinite", "inftable"):
            v = torch.randn((64, 2048), generator=g) * 0.3
            mask = torch.rand((64, 2048), generator=g) > 0.1
            lv = torch.sort(torch.randn((64, s), generator=g) * 0.3).values
            rb = _rand_words(torch, g, (64, 2048))
            _qdq_edge(torch, edge, v, lv)
            cpu = (v, lv, rb, mask, fe.clip_limit(v, mask, 2.5))
            want = fe.encode_fused_plain(*cpu, bits=bits)
            got = fe.encode_fused_cuda(*[t.to(dev) for t in cpu], bits=bits)
            torch.cuda.synchronize()
            mism = int((got.cpu() != want).sum())
            emit("kernel", kernel="encode_fused", case=f"{edge}_clip",
                 bits=bits, s=s, words_mismatched=mism)
            if mism:
                raise AssertionError(f"encode_fused {edge}_clip bits {bits}:"
                                     f" {mism} words differ from the plain "
                                     f"version")
    # the training path's shape (both exchange phases encode one buffer):
    # orq-9 at 4 bits, the 1-bit (minmax2's levels) and 3-bit (orq-5)
    # widths of the other random-round schemes, and the bit schedule's 2
    # (orq-3) and 5 (orq-17) bits
    from repro_torch.core import levels as lvmod
    v, lv, rb, mask = _train_shape_inputs(torch, dev, g)
    widths = {"train_main_shape": (4, lv),
              "train_main_shape_bits1": (1, lvmod.minmax_levels(v, mask)),
              "train_main_shape_bits3": (3, lvmod.orq_levels(v, mask, 2)),
              # the bit schedule's widths: orq-3 and orq-17 (phase 17)
              "train_main_shape_bits2": (2, lvmod.orq_levels(v, mask, 1)),
              "train_main_shape_bits5": (5, lvmod.orq_levels(v, mask, 4))}
    for name, (bits, lv) in widths.items():
        args = (v, lv, rb, mask, None)
        kern = lambda: fe.encode_fused_cuda(*args, bits=bits)
        plain = lambda: fe.encode_fused_plain(*args, bits=bits)
        got = kern()
        mism = _mismatch(torch, got, plain())
        ms, plain_ms = time_ms(kern, reps=10, rounds=3), time_ms(
            plain, reps=2, rounds=3)
        moved = nbytes(*args, got)
        s = lv.shape[1]
        b_ms, b_by = bound(moved, float(TRAIN_NB * TRAIN_D * (2 * s + 8)))
        dev_ms, plain_dev_ms = device_ms(
            kern, floor_ms=hbm_floor_ms(moved)), device_ms(plain, calls=2)
        results[name] = dict(
            shape=[TRAIN_NB, TRAIN_D], s=s, bits=bits, mode="rr",
            mask="exchange", words_mismatched=mism, max_abs_err=float(mism),
            ms=ms, plain_ms=plain_ms, library_ms=None, device_ms=dev_ms,
            plain_device_ms=plain_dev_ms, bytes=moved, bound_ms=b_ms,
            bound_by=b_by, warps_blocks=fe.encode_grid(TRAIN_NB, TRAIN_D,
                                                       bits))
        emit("kernel", kernel="encode_fused", case=name, **results[name])
        if mism:
            raise AssertionError(f"encode_fused {name}: {mism} words differ "
                                 f"from the plain version")
    return results


def _library_attend(torch, q, kw, klv, vw, vlv, mask, bits, kv_heads, scale):
    """Yardstick only: the plain dequant, then PyTorch's SDPA."""
    from repro_torch.kernels.ref import _kv_decode
    B, T, H, hd = q.shape
    d = kv_heads * hd
    C = kw.shape[1]
    k = _kv_decode(kw, klv, bits, klv.shape[-1], d).reshape(B, C, kv_heads,
                                                            hd)
    v = _kv_decode(vw, vlv, bits, vlv.shape[-1], d).reshape(B, C, kv_heads,
                                                            hd)
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[:, None], scale=scale, enable_gqa=H != kv_heads)


def attend_work(torch, q, kw, klv, mask, out):
    """(bytes, float32 operations) that ``decode_attend`` needs on this
    run's mask. A masked score is -2e38, so its weight exp(-2e38 - m) is
    exactly 0 and an admitted row needs only K and V up to its sequence's
    last admitted position, 4·hd operations per (head, admitted position).
    A fully masked row averages V over all C positions (2·hd operations per
    head and position) and reads no K. q, mask and out count whole."""
    B, T, H, hd = q.shape
    C = kw.shape[1]
    n = mask.sum(dim=-1)                                     # (B, T)
    pos = torch.arange(1, C + 1, device=mask.device)
    k_rows = torch.where(mask, pos, 0).amax(dim=(1, 2))      # (B,)
    v_rows = torch.where((n == 0).any(dim=1), C, k_rows)
    row_bytes = nbytes(kw[0, 0], klv[0, 0])                  # one of K or V
    moved = (nbytes(q, mask, out)
             + int((k_rows + v_rows).sum()) * row_bytes)
    ops = H * hd * (4.0 * float(n.sum()) + 2.0 * C * float((n == 0).sum()))
    return moved, ops


def check_attend(torch, dev):
    from repro_torch.core.api import make_quantizer
    from repro_torch.kernels import fused_kv as fk

    g = torch.Generator(device="cpu").manual_seed(2)
    cases = {  # name -> (B, T, H, KV, hd, C, softcap, first query pos)
        "decode_b8": (8, 1, 12, 12, 64, 512, 0.0, None),
        "prefill_t64": (1, 64, 12, 12, 64, 512, 0.0, [64]),
        "gqa_h8_kv2": (4, 1, 8, 2, 64, 256, 0.0, None),
        "softcap50": (2, 4, 12, 12, 64, 512, 50.0, None),
        "fully_masked_row": (3, 1, 12, 12, 64, 512, 0.0, [-1, 100, 511]),
        # the serving phase's decode positions: 128-160 of 512
        "serve_positions": (8, 1, 12, 12, 64, 512, 0.0,
                            [128, 132, 137, 141, 146, 150, 155, 160]),
        # other head dims at batch-8 decode: command-r-plus's smoke config
        # (hd 16, padded to 32) and gemma2-9b (16 heads over 8, hd 256)
        "hd16": (8, 1, 8, 2, 16, 512, 0.0, None),
        "hd256": (8, 1, 16, 8, 256, 512, 0.0, None),
    }
    results = {}
    for name, (B, T, H, KV, hd, C, cap, first) in cases.items():
        d = KV * hd
        qz = make_quantizer("orq-9", bucket_size=d)
        rows = (torch.randn((2, B * C, d), generator=g) * 0.5).to(dev)
        rb = torch.randint(-2 ** 31, 2 ** 31, (2 * B * C, d), generator=g,
                           dtype=torch.int64).to(torch.int32).to(dev)
        kw_, klv, vw_, vlv = fk.append_kv(qz, rows[0], rows[1], rb)
        kw_, klv, vw_, vlv = (t.reshape(B, C, -1).contiguous()
                              for t in (kw_, klv, vw_, vlv))
        q = torch.randn((B, T, H, hd), generator=g).to(dev)
        if first is None:   # decode: each sequence at its own position
            first = torch.randint(0, C - T + 1, (B,), generator=g).tolist()
        qpos = torch.tensor(first)[:, None] + torch.arange(T)[None]
        mask = (torch.arange(C)[None, None, :] <= qpos[:, :, None]).to(dev)
        kwargs = dict(bits=qz.wire_bits_per_element, kv_heads=KV,
                      scale=hd ** -0.5, softcap=cap)
        args = (q, kw_, klv, vw_, vlv, mask)
        want = fk.decode_attend_plain(*args, **kwargs)
        got = fk.decode_attend_cuda(*args, **kwargs)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        kern = lambda: fk.decode_attend_cuda(*args, **kwargs)
        plain = lambda: fk.decode_attend_plain(*args, **kwargs)
        ms, plain_ms = time_ms(kern), time_ms(plain)
        lib_ms = lib_dev_ms = None
        if not cap and name != "fully_masked_row":
            lib = lambda: _library_attend(torch, *args, kwargs["bits"], KV,
                                          hd ** -0.5)
            lib_ms, lib_dev_ms = time_ms(lib), device_ms(lib)
        moved, ops = attend_work(torch, q, kw_, klv, mask, got)
        b_ms, b_by = bound(moved, ops)
        dev_ms, plain_dev_ms = device_ms(
            kern, floor_ms=hbm_floor_ms(moved)), device_ms(plain)
        walked = fk.walked_tiles(mask, H, KV)
        results[name] = dict(
            B=B, T=T, H=H, KV=KV, hd=hd, padded_hd=fk.padded_head_dim(hd),
            C=C, softcap=cap,
            admitted_share=float(mask.float().mean()),
            splits=fk.split_count(B, T, H, KV, C),
            tiles_walked=int(walked.sum()) * KV,
            tiles_total=walked.numel() * KV,
            max_abs_err=err, finite=bool(torch.isfinite(got).all()),
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, device_ms=dev_ms,
            plain_device_ms=plain_dev_ms, library_device_ms=lib_dev_ms,
            bytes=moved, bound_ms=b_ms, bound_by=b_by)
        emit("kernel", kernel="decode_attend", case=name, atol=ATOL_ATTEND,
             **results[name])
        if not err <= ATOL_ATTEND or not results[name]["finite"]:
            raise AssertionError(f"decode_attend {name}: max abs err {err} "
                                 f"> {ATOL_ATTEND}")
    return results


# training path's shape: lm-100m's 135,285,504 gradients in buckets of 2048
TRAIN_NB, TRAIN_D = 66_058, 2048
#: the decodes' timed shapes: tag -> (L, rows per worker, bits, levels)
TRAIN_DECODE_SHAPES = {"bits4": (1, TRAIN_NB, 4, 9),
                       "bits1": (1, TRAIN_NB, 1, 2),
                       "L4": (4, 16_515, 4, 9),
                       "bits2": (1, TRAIN_NB, 2, 3),
                       "bits5": (1, TRAIN_NB, 5, 17)}


def _train_shape_inputs(torch, dev, g):
    """(values, orq-9 levels, rounding words, mask) of one gradient buffer
    at the training path's bucket layout: lm-100m's 135,285,504 values,
    the ragged tail of the last bucket masked, as the exchange passes it."""
    from repro_torch.core import levels as lvmod
    mask = (torch.arange(TRAIN_NB * TRAIN_D, device=dev) < 135_285_504
            ).reshape(TRAIN_NB, TRAIN_D)
    v = torch.where(mask, (torch.randn((TRAIN_NB, TRAIN_D), generator=g)
                           * 1e-3).to(dev), 0.0)
    rb = torch.randint(-2 ** 31, 2 ** 31, (TRAIN_NB, TRAIN_D), device=dev,
                       dtype=torch.int64).to(torch.int32)
    return v, lvmod.orq_levels(v, mask, 3), rb, mask


def _rand_words(torch, g, shape):
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                         dtype=torch.int64).to(torch.int32)


def _mismatch(torch, got, want) -> int:
    """Elements that differ by value (-0.0 == 0.0, as torch.equal),
    compared on ``got``'s device (a full-width buffer is not copied to the
    host)."""
    return int((got != want.to(got.device)).sum())


def check_decode(torch, dev):
    """decode_fused_mean / _each against their plain versions (bit-equal by
    value) at L = 1, 3, 4, 4 bits, d 2048 with a ragged row, and at 1, 3
    and 5 bits; then both timed at the training path's shape (L = 1) at 4,
    1, 2 and 5 bits (the last two the bit schedule's), and at L = 4."""
    from repro_torch.core import encode
    from repro_torch.kernels import fused_decode as fd

    g = torch.Generator(device="cpu").manual_seed(3)
    cases = {  # name -> (L, nb, d, bits, s)
        "L1": (1, 64, 2048, 4, 9), "L3": (3, 64, 2048, 4, 9),
        "L4": (4, 64, 2048, 4, 9), "L3_ragged_d2047": (3, 64, 2047, 4, 9),
        "bits1": (3, 64, 300, 1, 2), "bits3": (3, 64, 300, 3, 5),
        "bits5": (3, 64, 300, 5, 17),
    }
    worst = {"decode_fused_mean": 0.0, "decode_fused_each": 0.0}
    for name, (L, nb, d, bits, s) in cases.items():
        words = _rand_words(torch, g, (L, nb, encode.packed_words(d, bits)))
        levels = torch.sort(torch.randn((L, nb, s), generator=g) * 0.3).values
        row = dict(L=L, shape=[nb, d], bits=bits, s=s)
        for kname, plain, cuda in (
                ("decode_fused_mean", fd.decode_fused_mean_plain,
                 fd.decode_fused_mean_cuda),
                ("decode_fused_each", fd.decode_fused_each_plain,
                 fd.decode_fused_each_cuda)):
            want = plain(words, levels, d=d, bits=bits)
            got = cuda(words.to(dev), levels.to(dev), d=d, bits=bits)
            torch.cuda.synchronize()
            mism = _mismatch(torch, got, want)
            err = float((got.cpu() - want).abs().max())
            worst[kname] = max(worst[kname], err)
            emit("kernel", kernel=kname, case=name, mismatched=mism,
                 max_abs_err=err, **row)
            if mism:
                raise AssertionError(f"{kname} {name}: {mism} values differ "
                                     f"from the plain version")
    # the training path's shape: L = 1, 66,058 rows of 2048, at 4 bits
    # (orq-9) and at 1 bit (BinGrad-b); the per-worker decode also at
    # L = 4 (each worker's chunk of 16,515 rows)
    results = {}
    for tag, (L, nb, bits, s) in TRAIN_DECODE_SHAPES.items():
        words = _rand_words(
            torch, g, (L, nb, encode.packed_words(TRAIN_D, bits))).to(dev)
        levels = torch.sort(torch.randn((L, nb, s), generator=g)
                            ).values.to(dev)
        for kname, plain, cuda in (
                ("decode_fused_mean", fd.decode_fused_mean_plain,
                 fd.decode_fused_mean_cuda),
                ("decode_fused_each", fd.decode_fused_each_plain,
                 fd.decode_fused_each_cuda)):
            kern = lambda: cuda(words, levels, d=TRAIN_D, bits=bits)
            pl = lambda: plain(words, levels, d=TRAIN_D, bits=bits)
            got = kern()
            mism = _mismatch(torch, got, pl())
            ms, plain_ms = time_ms(kern, reps=10, rounds=3), time_ms(
                pl, reps=2, rounds=3)
            moved = nbytes(words, levels, got)
            b_ms, b_by = bound(moved, float(L * nb * TRAIN_D))
            dev_ms, plain_dev_ms = device_ms(
                kern, floor_ms=hbm_floor_ms(moved)), device_ms(pl, calls=2)
            key = kname if tag == "bits4" else f"{kname}/{tag}"
            results[key] = dict(
                shape=[L, nb, TRAIN_D], bits=bits, s=s, mismatched=mism,
                rows_per_block=(fd.mean_rows(L, s)
                                if kname == "decode_fused_mean" else None),
                max_abs_err=worst[kname], ms=ms, plain_ms=plain_ms,
                library_ms=None, device_ms=dev_ms,
                plain_device_ms=plain_dev_ms, bytes=moved, bound_ms=b_ms,
                bound_by=b_by)
            emit("kernel", kernel=kname, case="train_main_shape" + (
                "" if tag == "bits4" else f"_{tag}"),
                 **results[key])
            if mism:
                raise AssertionError(f"{kname} at the training shape "
                                     f"({tag}): {mism} values differ from "
                                     f"the plain version")
            del got
        del words, levels
    return results


def _qdq_edge(torch, edge, v, lv):
    """Write an edge case into CPU values / sorted level tables (rows
    0-5): ``ties`` equal levels (a whole table, an inner run, the top and
    the bottom pair) with values on them; ``nonfinite`` NaN, ±inf and
    -0.0 values (row 3 one NaN, so its clip limit is NaN); ``nantable``
    a NaN inside / filling / on top of / under a table and a descending
    one; ``inftable`` infinite levels and values; ``negzero`` -0.0
    levels and signed zero values."""
    nan, inf = float("nan"), float("inf")
    s, k = lv.shape[1], min(6, v.shape[1])
    if edge == "ties":
        lv[0, :] = lv[0, 0].item()
        lv[1, 1:s - 1] = lv[1, 1].item()
        lv[2, -1] = lv[2, -2].item()
        lv[3, 1] = lv[3, 0].item()
        v[:4, :s] = lv[:4]
    elif edge == "nonfinite":
        v[0, :k] = torch.tensor([nan, inf, -inf, -0.0, 0.0, nan])[:k]
        v[1, :] = inf
        v[2, ::3] = -inf
        v[3, v.shape[1] // 2] = nan
    elif edge == "nantable":
        lv[0, 1], lv[1, :], lv[2, -1], lv[3, 0] = nan, nan, nan, nan
        lv[4] = lv[4].flip(0)
    elif edge == "inftable":
        lv[0, 0], lv[1, -1], lv[2, :] = -inf, inf, inf
        lv[3, 0], lv[3, -1] = -inf, inf
        v[:4, :3] = torch.tensor([inf, -inf, 0.0])
    elif edge == "negzero":
        lv[0, 0], lv[1, 1], lv[2, :] = -0.0, -0.0, -0.0
        v[:3, :4] = torch.tensor([-0.0, 0.0, -0.0, 0.0])


def check_qdq(torch, dev):
    """qdq_fused against its plain version, bit for bit (a NaN a table
    holds comes out as the same NaN), in modes rr, bin and sign, with and
    without a clip and a mask, at every compiled level count (2, 3, 5, 9,
    17) and two the general path takes (4, 7), 16-byte (d 2048) and single
    accesses (d 300, 97), one row, and the edge cases of ``_qdq_edge``;
    then timed at the training path's shape (rr, the exchange's mask)
    with orq-9's levels and with the bit schedule's orq-3 and orq-17."""
    from repro_torch.kernels import fused_encode as fe

    g = torch.Generator(device="cpu").manual_seed(4)
    cases = {  # name -> (nb, d, s, mode, masked, clip_c, edge)
        "rr": (64, 2048, 9, "rr", True, None, None),
        "rr_clip2.5": (64, 2048, 9, "rr", False, 2.5, None),
        "rr_ragged_d300_s5": (64, 300, 5, "rr", True, None, None),
        "bin": (64, 2048, 2, "bin", True, None, None),
        "sign_clip": (64, 2048, 2, "sign", False, 1.7, None),
    }
    for s in (2, 3, 4, 5, 7, 17):
        cases[f"rr_s{s}"] = (64, 2048, s, "rr", True, None, None)
    for edge in ("ties", "nonfinite", "nantable", "inftable", "negzero"):
        for s, d in ((3, 2048), (9, 97), (17, 2048), (7, 300)):
            for clip_c in (None, 2.5):
                cases[f"{edge}_s{s}_d{d}" + ("_clip" if clip_c else "")] = (
                    64, d, s, "rr", True, clip_c, edge)
        for mode in ("bin", "sign"):
            cases[f"{edge}_{mode}_clip"] = (64, 2048, 2, mode, False, 2.5,
                                            edge)
    cases["nb1_s17_d97_nonfinite_clip"] = (1, 97, 17, "rr", False, 2.5,
                                           "nonfinite")
    cases["nb1_s9_d2048"] = (1, 2048, 9, "rr", True, None, None)
    worst = 0.0
    for name, (nb, d, s, mode, masked, clip_c, edge) in cases.items():
        v = torch.randn((max(nb, 6), d), generator=g) * 0.3
        mask = torch.rand((nb, d), generator=g) > 0.1 if masked else None
        lv = torch.sort(torch.randn((max(nb, 6), s), generator=g) * 0.3
                        ).values
        rb = _rand_words(torch, g, (nb, d)) if mode == "rr" else None
        if edge:
            _qdq_edge(torch, edge, v, lv)
        v, lv = v[:nb].contiguous(), lv[:nb].contiguous()
        lim = fe.clip_limit(v, mask, clip_c)
        cpu = (v, lv, rb, mask, lim)
        want = fe.qdq_fused_plain(*cpu, mode=mode)
        got = fe.qdq_fused_cuda(*[None if t is None else t.to(dev)
                                  for t in cpu], mode=mode)
        torch.cuda.synchronize()
        got = got.cpu()
        mism = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        fin = torch.isfinite(want)
        if fin.any():
            worst = max(worst, float((got[fin] - want[fin]).abs().max()))
        emit("kernel", kernel="qdq_fused", case=name, shape=[nb, d], s=s,
             mode=mode, mask=masked, clip_c=clip_c, edge=edge,
             mismatched=mism)
        if mism:
            raise AssertionError(f"qdq_fused {name}: {mism} values differ "
                                 f"from the plain version")
    from repro_torch.core import levels as lvmod
    v, lv, rb, mask = _train_shape_inputs(torch, dev, g)
    # orq-9's levels, and the bit schedule's orq-3 and orq-17 (phase 17)
    widths = {"train_main_shape": lv,
              "train_main_shape_bits2": lvmod.orq_levels(v, mask, 1),
              "train_main_shape_bits5": lvmod.orq_levels(v, mask, 4)}
    out = {}
    for case, lv in widths.items():
        args = (v, lv, rb, mask, None)
        kern = lambda: fe.qdq_fused_cuda(*args, mode="rr")
        pl = lambda: fe.qdq_fused_plain(*args, mode="rr")
        got = kern()
        mism = _mismatch(torch, got, pl())
        ms, plain_ms = time_ms(kern, reps=10, rounds=3), time_ms(
            pl, reps=2, rounds=3)
        moved = nbytes(v, lv, rb, mask, got)
        s = lv.shape[1]
        b_ms, b_by = bound(moved, float(TRAIN_NB * TRAIN_D * (2 * s + 8)))
        dev_ms, plain_dev_ms = device_ms(
            kern, floor_ms=hbm_floor_ms(moved)), device_ms(pl, calls=2)
        out[case] = dict(
            shape=[TRAIN_NB, TRAIN_D], s=s, mode="rr", mismatched=mism,
            max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=None,
            device_ms=dev_ms, plain_device_ms=plain_dev_ms, bytes=moved,
            bound_ms=b_ms, bound_by=b_by)
        emit("kernel", kernel="qdq_fused", case=case, **out[case])
        if mism:
            raise AssertionError(f"qdq_fused at the training shape ({case}):"
                                 f" {mism} values differ from the plain "
                                 f"version")
        del got
    return out


LEVEL_RTOL = 1e-5     # BinGrad-b levels: row sums in another order
# A Lloyd iteration re-splits the row at b0 = (b-1 + b1) / 2; when the two
# b0 differ by an ulp and a value lies between them, that value changes
# sides and the means move by ~|v| / count: such rows (at most
# FLIP_SHARE of them) are held within FLIP_RTOL of the row's max |v|.
FLIP_SHARE = 1e-3
FLIP_RTOL = 1e-2


def _bin_inputs(torch, dev, g, nb, d, dist, masked):
    """(values, mask) on the card: ``q64`` multiples of 1/64 in [-1, 1]
    (every partial sum exact in float32 in any order) or gradient-like
    normal values; the training shape masks its ragged tail as the
    exchange does."""
    if dist == "q64":
        v = torch.randint(-64, 65, (nb, d), generator=g).float() / 64
    else:
        v = torch.randn((nb, d), generator=g) * (1e-3 if masked else 0.3)
    v = v.to(dev)
    mask = None
    if masked:
        mask = (torch.arange(nb * d, device=dev) < 135_285_504
                ).reshape(nb, d)
        v = torch.where(mask, v, 0.0)
    return v, mask


def check_bingrad(torch, dev):
    """encode_bingrad_fused and bingrad_pass against their plain versions
    on the card, at the serving path's KV shape (16 rows of 768, no mask)
    and at the training path's shape (66,058 masked buckets of 2048; for
    the encode also the same buffer in rows of 4096 and of 2047).
    Exact cases (q64): levels, words, sums and counts bit-equal.
    Float-close cases: levels within LEVEL_RTOL of the row's max |v|, the
    words exactly the threshold of the kernel's own levels, and the word
    bits that differ from the plain version's counted. In every case the
    encode's levels are bit-equal to ``kernel_order_levels``."""
    from repro_torch.kernels import bingrad as bg
    from repro_torch.kernels import fused_bingrad as fb
    from repro_torch.kernels import fused_encode as fe

    g = torch.Generator(device="cpu").manual_seed(6)
    cases = {  # name -> (nb, d, dist, masked, lloyd_iters, clip_c)
        "kv_rows16": (16, 768, "normal", False, 0, None),
        "kv_rows16_q64": (16, 768, "q64", False, 0, None),
        "train_q64_lloyd0": (TRAIN_NB, TRAIN_D, "q64", True, 0, None),
        "train_q64_lloyd2": (TRAIN_NB, TRAIN_D, "q64", True, 2, None),
        "train_main_shape": (TRAIN_NB, TRAIN_D, "normal", True, 0, None),
        "train_lloyd2_clip2.5": (TRAIN_NB, TRAIN_D, "normal", True, 2, 2.5),
        # the same buffer in rows of 4096 and of 2047 (no main path)
        "train_d4096": (-(-TRAIN_NB * TRAIN_D // 4096), 4096, "normal",
                        True, 0, None),
        "train_d2047": (-(-TRAIN_NB * TRAIN_D // 2047), 2047, "normal",
                        True, 0, None),
    }
    # the wider rows draw from their own generator, so that every other
    # case keeps the inputs of earlier runs of this script
    g_wide = torch.Generator(device="cpu").manual_seed(7)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for name, (nb, d, dist, masked, li, clip_c) in cases.items():
        gen = g_wide if name in ("train_d4096", "train_d2047") else g
        v, mask = _bin_inputs(torch, dev, gen, nb, d, dist, masked)
        lim = fe.clip_limit(v, mask, clip_c)
        kern = lambda: fb.encode_bingrad_fused_cuda(v, mask, lim,
                                                    lloyd_iters=li)
        plain = lambda: fb.encode_bingrad_fused_plain(v, mask, lim,
                                                      lloyd_iters=li)
        words, lv = kern()
        want_w, want_l = plain()
        order = fb.kernel_order_levels(v, mask, lim, lloyd_iters=li)
        torch.cuda.synchronize()
        order_equal = torch.equal(lv.view(torch.int32),
                                  order.view(torch.int32))
        exact = dist == "q64" and clip_c is None
        diff = (lv - want_l).abs()
        lv_err = float(diff.max())
        vmax = float(v.abs().max())
        tol = LEVEL_RTOL * vmax
        far_rows = int((diff > tol).any(dim=1).sum())
        own = fe.encode_fused_plain(v, lv, None, mask, lim, bits=1,
                                    mode="bin")
        words_vs_own = _mismatch(torch, words, own)
        flips = int(((words ^ want_w) != 0).sum())
        ok = (words_vs_own == 0 and far_rows <= FLIP_SHARE * nb
              and lv_err <= FLIP_RTOL * vmax and order_equal
              and (not exact or (lv_err == 0.0 and flips == 0)))
        reps = 20 if nb < 1000 else 10
        ms, plain_ms = time_ms(kern, reps=reps, rounds=3), time_ms(
            plain, reps=2, rounds=3)
        moved = nbytes(v, mask, lim, words, lv)
        b_ms, b_by = bound(moved, float(nb * d * (3 + 3 * (1 + li))))
        dev_ms, plain_dev_ms = device_ms(
            kern, floor_ms=hbm_floor_ms(moved)), device_ms(plain, calls=2)
        results[name] = dict(
            shape=[nb, d], data=dist, mask=masked, lloyd_iters=li,
            clip_c=clip_c, plan=fb.launch_plan(nb, d, sm)._asdict(),
            levels_equal_kernel_order=order_equal, exact_case=exact,
            max_abs_err=lv_err,
            level_tol=tol, level_entries_differ=int((lv != want_l).sum()),
            level_rows_beyond_tol=far_rows,
            words_vs_own_threshold=words_vs_own,
            words_differ_from_plain=flips, ms=ms, plain_ms=plain_ms,
            library_ms=None, device_ms=dev_ms, plain_device_ms=plain_dev_ms,
            bytes=moved, bound_ms=b_ms, bound_by=b_by)
        emit("kernel", kernel="encode_bingrad_fused", case=name,
             **results[name])
        if not ok:
            raise AssertionError(f"encode_bingrad_fused {name}: "
                                 f"{results[name]}")
        # the encode's words through encode_fused(mode="bin") given its
        # levels: the same words (cross-check of the two kernels)
        again = fe.encode_fused_cuda(v, lv, None, mask, lim, bits=1,
                                     mode="bin")
        if _mismatch(torch, again, words):
            raise AssertionError(f"encode_fused(bin) disagrees with "
                                 f"encode_bingrad_fused on {name}")
        del v, mask, lim, words, lv, want_w, want_l, own, again, order

    pass_cases = {  # name -> (nb, d, dist, masked)
        "kv_rows16": (16, 768, "normal", False),
        "train_q64": (TRAIN_NB, TRAIN_D, "q64", True),
        "train_main_shape": (TRAIN_NB, TRAIN_D, "normal", True),
    }
    for name, (nb, d, dist, masked) in pass_cases.items():
        v, mask = _bin_inputs(torch, dev, g, nb, d, dist, masked)
        if mask is None:
            mask = torch.ones_like(v, dtype=torch.bool)
        b0 = (v * mask).sum(dim=1, keepdim=True) / mask.sum(
            dim=1, keepdim=True).clamp(min=1)
        kern = lambda: bg.bingrad_pass_cuda(v, b0, mask)
        plain = lambda: bg.bingrad_pass_plain(v, b0, mask)
        idx, part = kern()
        want_i, want_p = plain()
        torch.cuda.synchronize()
        idx_mism = _mismatch(torch, idx, want_i)
        cnt_mism = _mismatch(torch, part[:, 1::2], want_p[:, 1::2])
        err = float((part - want_p).abs().max())
        tol = LEVEL_RTOL * float((v.abs() * mask).sum(dim=1).max())
        exact = dist == "q64"
        reps = 20 if nb < 1000 else 10
        ms, plain_ms = time_ms(kern, reps=reps, rounds=3), time_ms(
            plain, reps=2, rounds=3)
        moved = nbytes(v, b0, mask, idx, part)
        b_ms, b_by = bound(moved, float(nb * d * 3))
        dev_ms, plain_dev_ms = device_ms(
            kern, floor_ms=hbm_floor_ms(moved)), device_ms(plain, calls=2)
        results["pass/" + name] = dict(
            shape=[nb, d], data=dist, mask=masked, exact_case=exact,
            idx_mismatched=idx_mism, counts_mismatched=cnt_mism,
            max_abs_err=err, sum_tol=tol, ms=ms, plain_ms=plain_ms,
            library_ms=None, device_ms=dev_ms, plain_device_ms=plain_dev_ms,
            bytes=moved, bound_ms=b_ms, bound_by=b_by)
        emit("kernel", kernel="bingrad_pass", case=name,
             **results["pass/" + name])
        if idx_mism or cnt_mism or err > (0.0 if exact else tol):
            raise AssertionError(f"bingrad_pass {name}: "
                                 f"{results['pass/' + name]}")
        del v, mask, b0, idx, part, want_i, want_p
    return results


# ---------------------------------------------------------------------------
# phases 4-6
# ---------------------------------------------------------------------------

MAIN_ARGS = ["--arch", "lm-100m", "--kv-quant", "orq-9", "--batch", "8",
             "--prompt-len", "128", "--gen", "32", "--max-len", "512",
             "--prefill-chunk", "64", "--page-size", "16", "--seed", "0"]
#: scheme -> (kernel that encodes its KV rows, token bytes, ratio to bf16)
SERVE_SCHEMES = {"orq-9": ("encode_fused", 840, 0.2734),
                 "bingrad-b": ("encode_bingrad_fused", 208, 0.0677)}


def _counters():
    """Every kernel's launch counter (the CUDA wrappers)."""
    from repro_torch.kernels.ops import launch_counters
    return launch_counters()


def _zero_counters():
    for fn in _counters().values():
        fn.launches = 0


def _read_counters():
    return {k: fn.launches for k, fn in _counters().items()}


def run_main_path(torch, scheme="orq-9"):
    """The serving launcher with ``scheme`` KV pages; every counter is
    zeroed just before and read just after."""
    import numpy as np

    from repro_torch.launch import serve as launcher

    args = list(MAIN_ARGS)
    args[args.index("--kv-quant") + 1] = scheme
    enc, tok_bytes, ratio = SERVE_SCHEMES[scheme]
    _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = launcher.serve(args)
    wall = time.perf_counter() - t0
    launches = _read_counters()
    toks = r.pop("tokens")
    eng = r.pop("engine")
    expect = r["forward_calls"] * r["layers"]
    want = {k: (expect if k in (enc, "decode_attend") else 0)
            for k in launches}
    cache_expect = (r["layers"] * eng.cfg.resolved_num_pages
                    * eng.cfg.page_size * r["token_bytes"])
    emit("serve", scheme=scheme, args=" ".join(args), wall_s=wall,
         launches=launches, expected_launches=want,
         cache_bytes_expected=cache_expect,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         tokens_shape=list(toks.shape), **r)
    if launches != want:
        raise AssertionError(f"{scheme} serve launches {launches} != {want} "
                             f"(forward calls x layers)")
    if (r["token_bytes"] != tok_bytes
            or round(r["token_bytes_ratio"], 4) != ratio):
        raise AssertionError(f"{scheme} cache accounting off: {r}")
    if r["cache_bytes"] != cache_expect:
        raise AssertionError("cache bytes disagree with the page count")
    if toks.shape != (8, 32) or not ((toks >= 0) & (toks < 32768)).all():
        raise AssertionError(f"bad tokens {toks.shape}")
    if not np.isfinite(r["decode_tok_s"]):
        raise AssertionError("no decode throughput")
    return launches, eng


def _first_layer_pages(torch, seen):
    """BinGrad-b's first layer on the card: the KV rows the engine encoded
    in its first forward, held against the plain version on the same rows
    (levels within LEVEL_RTOL, words the exact threshold of the kernel's
    levels), and against the CPU engine's rows and pages."""
    from repro_torch.kernels import fused_bingrad as fb
    from repro_torch.kernels import fused_encode as fe

    rows = {d: torch.cat([k, v]) for d, (k, v, _) in seen.items()}
    outs = {d: (torch.cat([o[0], o[2]]), torch.cat([o[1], o[3]]))
            for d, (_, _, o) in seen.items()}
    x, (w, lv) = rows["card"], outs["card"]
    _, want_l = fb.encode_bingrad_fused_plain(x, None, None)
    own = fe.encode_fused_plain(x, lv, None, None, None, bits=1, mode="bin")
    lv_err = float((lv - want_l).abs().max())
    tol = LEVEL_RTOL * float(x.abs().max())
    res = dict(rows=list(x.shape), level_err_vs_plain=lv_err, level_tol=tol,
               words_vs_own_threshold=_mismatch(torch, w, own))
    cw, cl = outs["cpu"]
    bits = lambda t: torch.stack([(t.cpu() >> i) & 1 for i in range(32)])
    res.update(
        rows_max_abs_diff_card_vs_cpu=float(
            (x.cpu() - rows["cpu"]).abs().max()),
        levels_max_abs_diff_card_vs_cpu=float((lv.cpu() - cl).abs().max()),
        word_bits_differ_card_vs_cpu=int((bits(w) != bits(cw)).sum()),
        word_bits=int(x.numel()))
    if res["words_vs_own_threshold"] or not lv_err <= tol:
        raise AssertionError(f"bingrad-b first-layer pages on the card: "
                             f"{res}")
    return res


def check_against_cpu(torch, dev, scheme="orq-9"):
    """Smoke lm-100m: one prefill and two decode forwards on the card and
    on the CPU from the same weights, pools and seeds. For BinGrad-b the
    first layer's pages of the first forward are held too."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import LM
    from repro_torch.models.model import map_tree
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve import engine as engine_mod

    atol = ATOL_LOGITS if scheme == "orq-9" else ATOL_LOGITS_BIN
    model = LM(get_smoke_config("lm-100m"))
    params = map_tree(lambda t: t.to(torch.bfloat16),
                      model.init(torch.Generator().manual_seed(0),
                                 device="cpu"))
    cfg = ServeConfig(kv_quant=scheme, page_size=16, max_batch=2,
                      max_pages_per_seq=4, prefill_chunk=32)
    engines = {d: Engine(model, params, cfg, device=d) for d in (dev, "cpu")}
    prompt = torch.randint(0, 512, (1, 32),
                           generator=torch.Generator().manual_seed(3))
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    seeds = torch.tensor([11, 12])
    real_append, seen, which = engine_mod.append_kv, {}, [None]

    def spy(qz, k_rows, v_rows, rbits):   # the first call is layer 0's
        out = real_append(qz, k_rows, v_rows, rbits)
        seen.setdefault(which[0], (k_rows.clone(), v_rows.clone(),
                                   [t.clone() for t in out]))
        return out

    errs = []
    for step in range(3):
        if step == 0:
            args = (table[:1], torch.tensor([0]), seeds[:1], prompt)
            engine_mod.append_kv = spy
        else:
            args = (table, torch.tensor([31 + step, 0]), seeds,
                    torch.tensor([[7 * step], [9]]))
        out = {}
        try:
            for d, eng in engines.items():
                if d != "cpu":   # same pools before every call
                    for gc, gg in zip(engines["cpu"].pools, eng.pools):
                        for pos in gc:
                            for k in gc[pos]:
                                gg[pos][k].copy_(gc[pos][k])
                which[0] = "cpu" if d == "cpu" else "card"
                lg, _, _ = eng._forward(eng.params, eng.pools,
                                        *[a.to(eng.device) for a in args])
                out[d] = lg.float().cpu()
        finally:
            engine_mod.append_kv = real_append
        errs.append(float((out[dev] - out["cpu"]).abs().max()))
    pages = (_first_layer_pages(torch, seen) if scheme == "bingrad-b"
             else None)
    emit("check", scheme=scheme,
         what="smoke engine forward, card vs CPU plain versions",
         max_abs_logit_err=errs, atol=atol, first_layer_pages=pages)
    if not max(errs) <= atol:
        raise AssertionError(f"card and CPU logits differ by {max(errs)}")


#: decode steps in a serve profile and EF steps in a train profile: the
#: orq-9 serve profile's ~93,000 launches take the profiler about 7 s a
#: step to process
PROFILE_DECODE_STEPS = 2
PROFILE_TRAIN_STEPS = 1


def profile_decode(torch, eng):
    """Device time by op over PROFILE_DECODE_STEPS decode steps of the
    main-path engine."""
    from torch.profiler import ProfilerActivity, profile

    for b in range(eng.cfg.max_batch):
        eng.submit([b + 1] * 16, max_new=10)
    while eng.sched.next_prefill() is not None or not eng.sched.decode_ready():
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_DECODE_STEPS):
        eng.step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        for _ in range(PROFILE_DECODE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_PAD_S)
    rows = _kernel_events(prof)
    total = sum(r[0] for r in rows)
    by_cat = _by_category(rows)
    emit("profile", scheme=eng.cfg.kv_quant,
         window=f"{PROFILE_DECODE_STEPS} decode steps, batch 8",
         wall_ms_unprofiled=plain_wall * 1e3, wall_ms_profiled=wall * 1e3,
         device_us=total, kernel_launches=sum(r[2] for r in rows),
         device_busy_share=total / 1e3 / (plain_wall * 1e3),
         by_category=by_cat,
         top=[{"name": k[:90], "count": c, "device_us": us}
              for us, k, c in rows[:12]])
    eng.run()


# ---------------------------------------------------------------------------
# phases 7-8: the training path
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--arch", "lm-100m", "--quant", "orq-9", "--bucket", "2048",
              "--batch", "8", "--seq", "128", "--seed", "0",
              "--log-every", "1"]
TRAIN_WIRE_BYTES = 140_042_960
TRAIN_EXPECT = {"encode_fused": 10, "decode_fused_mean": 5,
                "decode_fused_each": 5, "qdq_fused": 2}
#: BinGrad-b: phase 1, phase 2 and the EF levels are each one fused encode
BIN_EXPECT = {"encode_bingrad_fused": 12, "decode_fused_mean": 5,
              "decode_fused_each": 5, "qdq_fused": 2}
#: the other schemes, one step each: (s, the encode's rounding mode)
OTHER_SCHEMES = {"bingrad-pb": 2, "terngrad": 3, "qsgd-5": 5, "linear-5": 5,
                 "minmax2": 2, "signsgd": 2}


def _expect(want):
    return {k: want.get(k, 0) for k in _counters()}


def wire_bytes_formula(s: int, nb: int = TRAIN_NB, d: int = TRAIN_D) -> int:
    """The reference's wire bytes per worker and step at L = 1: phase 1 and
    phase 2 each ship nb buckets of ceil(d / (32 // bits)) uint32 words
    plus s float32 levels, bits = ceil(log2 s)."""
    bits = max(1, (s - 1).bit_length())
    return 2 * nb * (-(-d // (32 // bits)) + s) * 4


def _train_runs(torch, quant, runs, expect, wire):
    """Launcher runs of ``quant``: every counter zeroed just before and
    read just after; losses finite, wire bytes, replicas in sync."""
    from repro_torch.launch import train as launcher

    _zero_counters()
    out = {}
    for name, extra in runs:
        args = list(TRAIN_ARGS)
        args[args.index("--quant") + 1] = quant
        args += extra
        # the run's own peak: what earlier phases and runs left allocated
        # is the base, not counted
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        r = launcher.train(args)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        losses = [h["loss"] for h in r["history"]]
        out[name] = r
        emit("train", run=name, args=" ".join(args), wall_s=wall,
             losses=losses, step_s=r["step_s"],
             step_p50_ms=statistics.median(r["step_s"]) * 1e3,
             wire_bytes_per_worker=r["wire_bytes_per_worker"],
             collective_launches_per_step=r["collective_launches_per_step"],
             n_params=r["n_params"], world_size=r["world_size"],
             replicas_in_sync=r["replicas_in_sync"],
             params_sha256=r["params_sha256"], peak_mem_above_start=peak)
        if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
            raise AssertionError(f"train {name}: non-finite loss {losses}")
        if r["wire_bytes_per_worker"] != wire:
            raise AssertionError(f"train {name}: wire bytes "
                                 f"{r['wire_bytes_per_worker']} != {wire}")
        if not r["replicas_in_sync"]:
            raise AssertionError(f"train {name}: replicas out of sync")
    launches = _read_counters()
    emit("train", run=f"{quant} launches", launches=launches,
         expected=_expect(expect))
    if launches != _expect(expect):
        raise AssertionError(f"{quant} training launches {launches} != "
                             f"{_expect(expect)}")
    return launches, out


def run_train_path(torch):
    """3 orq-9 steps, then 2 with error feedback, through the launcher on
    the world of one that main() started, the params sha256 held to the
    recorded digests; -> (launches, the last state, each run's params
    sha256)."""
    launches, runs = _train_runs(
        torch, "orq-9", (("orq9", ["--steps", "3"]),
                         ("orq9_ef", ["--steps", "2", "--error-feedback"])),
        TRAIN_EXPECT, TRAIN_WIRE_BYTES)
    sha = {k: r["params_sha256"] for k, r in runs.items()}
    emit("train", run="orq-9 params sha256", sha256=sha,
         recorded=ORQ9_SHA256, equal_recorded=sha == ORQ9_SHA256)
    if sha != ORQ9_SHA256:
        raise AssertionError(f"orq-9 params sha256 {sha} != the recorded "
                             f"{ORQ9_SHA256}")
    return launches, runs["orq9_ef"]["state"], sha


#: orq-9's params sha256 after the runs of ``run_train_path`` (3 steps;
#: 2 with error feedback), as every chip run since the SGD step rounds as
#: XLA's FMA contraction does (``optimizers.step``) has printed them
#: (NVIDIA H100 80GB HBM3): the fused kernels keep their bits while
#: their designs change. Asserted.
ORQ9_SHA256 = {
    "orq9":
        "80278210162066b60ba2c9cfcafb5bbfed17527174f14ed27415ff7e67786c64",
    "orq9_ef":
        "1af5daf5fdc76385c329043fdee0fad5652a74d90454dc57f6565a3150b0a6c7"}

#: BinGrad-b's params sha256 after the runs of ``run_bingrad_train`` as
#: PR 20's chip runs printed them (NVIDIA H100 80GB HBM3): the encode's
#: levels keep their bits while its kernel changes. PRs 13-19 printed
#: 0a8e2c8f... and adf8ebd3...; PR 20 rounds the SGD step as XLA's FMA
#: contraction does (``optimizers.step``), which moves every digest once.
#: Asserted.
BIN_SHA256_PR20 = {
    "bingrad_b":
        "fb2eb4b44e8bf8f9ea560c6594201de7b5d76fc7f08f3f1df7bee9c0be852177",
    "bingrad_b_ef":
        "75e76893e052a262e0a1eebb0f0218942511a2564ad56824cf7286a6a8da9007"}


def run_bingrad_train(torch):
    """BinGrad-b: 3 steps, then 2 with error feedback; the params sha256
    held to the recorded digests; -> (launches, the last state, each
    run's params sha256)."""
    launches, runs = _train_runs(
        torch, "bingrad-b",
        (("bingrad_b", ["--steps", "3"]),
         ("bingrad_b_ef", ["--steps", "2", "--error-feedback"])),
        BIN_EXPECT, wire_bytes_formula(2))
    sha = {k: runs[k]["params_sha256"] for k in BIN_SHA256_PR20}
    emit("train", run="bingrad-b params sha256", sha256=sha,
         pr20=BIN_SHA256_PR20, equal_pr20=sha == BIN_SHA256_PR20)
    if sha != BIN_SHA256_PR20:
        raise AssertionError(f"BinGrad-b params sha256 {sha} != the "
                             f"recorded {BIN_SHA256_PR20}")
    return launches, runs["bingrad_b_ef"]["state"], sha


def run_other_schemes(torch):
    """One full-width step of each other scheme: finite loss, the
    reference's wire bytes, two encodes and one decode of each kind."""
    total = {}
    for quant, s in OTHER_SCHEMES.items():
        launches, _ = _train_runs(
            torch, quant, ((quant, ["--steps", "1"]),),
            {"encode_fused": 2, "decode_fused_mean": 1,
             "decode_fused_each": 1}, wire_bytes_formula(s))
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


def profile_train(torch, state, quant="orq-9", mode="replicated"):
    """Device time by category over PROFILE_TRAIN_STEPS ``quant`` + EF
    steps of ``mode``
    (``state`` is a state of that mode), beside the same steps' wall time
    without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.core import prng
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import TrainConfig, make_train_step

    cfg = get_config("lm-100m")
    step_fn = make_train_step(
        LM(cfg), TrainConfig(policy=QuantPolicy.parse(quant), mode=mode,
                             error_feedback=True), constant_lr(0.05))
    data = SyntheticLM(cfg.vocab_size, 128, 8, seed=0)
    batches = [data.batch(i, device="cuda")
               for i in range(PROFILE_TRAIN_STEPS)]
    key = prng.key(0, device="cuda")
    # the fresh step function's first call (its set-up) outside both
    # windows, so the busy share reads warm steps only
    state, _ = step_fn(state, batches[0], key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        state, _ = step_fn(state, b, key)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for b in batches:
            state, _ = step_fn(state, b, key)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    rows = _kernel_events(prof)
    total = sum(r[0] for r in rows)
    by_cat = _by_category(rows)
    emit("train_profile", scheme=quant, mode=mode,
         window=f"{PROFILE_TRAIN_STEPS} step(s), lm-100m {mode} {quant} "
                f"+ EF, batch 8 x 128",
         wall_ms_unprofiled=plain_wall * 1e3, device_us=total,
         kernel_launches=sum(r[2] for r in rows),
         device_busy_share=total / 1e3 / (plain_wall * 1e3),
         by_category=by_cat,
         top=[{"name": k[:90], "count": c, "device_us": us}
              for us, k, c in rows[:12]])


EXCHANGE_SCHEMES = ("orq-9", "bingrad-b", "bingrad-pb", "terngrad", "qsgd-5",
                    "linear-5", "minmax2", "signsgd")
#: schemes whose levels are means (row sums over counts): their phase-2
#: re-fit sums those levels, which lie off the 1/64 grid
MEAN_LEVELS = ("bingrad-b", "signsgd")


def check_exchange_card_vs_cpu(torch, dev):
    """Smoke lm-100m's fused exchange of one gradient buffer of multiples
    of 1/64 in [-1, 1], on the card (NCCL) and on the CPU (a gloo group of
    the same world), for every scheme with a fused encode: the means and
    the EF residuals are bit-equal. (For BinGrad-b and SignSGD the phase-2
    re-fit sums phase 1's levels, which are means and lie off the grid:
    there the means are held within 2^-20 of their magnitude and the
    values that differ are counted; without the phase-2 re-quantization
    their exchange is bit-equal.)"""
    import torch.distributed as dist

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core import prng
    from repro_torch.core.comm.exchange import PartitionedExchange
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import LM

    model = LM(get_smoke_config("lm-100m"))
    ap = model.abstract_params()
    gloo = dist.new_group(ranks=[0], backend="gloo")
    failed = []
    runs = [(s, s) for s in EXCHANGE_SCHEMES] + [
        (f"{s} (no phase-2 re-quantization)",
         json.dumps({"default": {"name": s, "server_requant": False}}))
        for s in MEAN_LEVELS]
    for scheme, spec in runs:
        pol = QuantPolicy.parse(spec, bucket_size=2048)
        out = {}
        for where, group in ((dev, None), ("cpu", gloo)):
            pex = PartitionedExchange.build(pol, ap, group,
                                            paths=model.param_paths(ap))
            n = pex.layout.size
            g = torch.Generator().manual_seed(5)
            buf = (torch.randint(-64, 65, (n,), generator=g).float() / 64
                   ).to(where)
            key = prng.key(9, device=where)
            out[str(where)] = (pex.exchange_parts([buf], key)[0].cpu(),
                               pex.local_qdq_parts([buf], key)[0].cpu())
        (m_card, q_card), (m_cpu, q_cpu) = out[str(dev)], out["cpu"]
        mean_mism = _mismatch(torch, m_card, m_cpu)
        qdq_mism = _mismatch(torch, q_card, q_cpu)
        mean_err = float((m_card - m_cpu).abs().max())
        emit("exchange", scheme=scheme,
             what="smoke lm-100m fused exchange + EF qdq of a "
             "multiple-of-1/64 buffer, card (NCCL) vs CPU (gloo)", n=n,
             mismatched=mean_mism + qdq_mism, mean_mismatched=mean_mism,
             qdq_mismatched=qdq_mism, mean_max_abs_diff=mean_err,
             mean_abs=float(m_card.abs().mean()))
        tol = (2.0 ** -20 * float(m_cpu.abs().max())
               if scheme in MEAN_LEVELS else 0.0)
        if qdq_mism or mean_err > tol:
            failed.append(scheme)
    dist.destroy_process_group(gloo)
    if failed:
        raise AssertionError(f"card and CPU exchanges differ for {failed}")


# ---------------------------------------------------------------------------
# the multi-pass wire path: its kernels (phase 3) and the path (phase 9)
# ---------------------------------------------------------------------------

TRAIN_N = 135_285_504          # lm-100m's gradients
#: the training shape's levels at each s: a scheme of the registry fits them
S_SCHEME = {2: "minmax2", 3: "terngrad", 5: "orq-5", 9: "orq-9",
            17: "orq-17"}
MP_SMALL = {"nb5_d37": (5, 37), "nb1_d129": (1, 129)}


def _mp_train_values(torch, dev, g):
    """Gradient-like values at the training shape, the last bucket's
    tail masked (zero), and the mask."""
    mask = (torch.arange(TRAIN_NB * TRAIN_D, device=dev) < TRAIN_N
            ).reshape(TRAIN_NB, TRAIN_D)
    v = torch.where(mask, (torch.randn((TRAIN_NB, TRAIN_D), generator=g)
                           * 1e-3).to(dev), 0.0)
    return v, mask


def _timed(torch, name, case, kern, plain, moved, ops, library=None,
           **extra):
    """Times of a kernel at the training shape: ``ms`` (events) and
    ``device_ms`` (profiler) of the kernel, its plain version and the
    library yardstick, beside the bound."""
    ms, plain_ms = time_ms(kern, reps=10, rounds=3), time_ms(plain, reps=2,
                                                              rounds=3)
    lib_ms = lib_dev_ms = None
    if library is not None:
        lib_ms, lib_dev_ms = time_ms(library, reps=10, rounds=3), device_ms(
            library)
    b_ms, b_by = bound(moved, ops)
    dev_ms, plain_dev_ms = device_ms(
        kern, floor_ms=hbm_floor_ms(moved)), device_ms(plain, calls=2)
    res = dict(shape=[TRAIN_NB, TRAIN_D], ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, device_ms=dev_ms,
               plain_device_ms=plain_dev_ms, library_device_ms=lib_dev_ms,
               bytes=moved, bound_ms=b_ms, bound_by=b_by, **extra)
    emit("kernel", kernel=name, case=case, **res)
    return res


def _hold(torch, name, case, got, want, **row):
    """A multi-pass kernel against its plain version: bit-equal, floats
    as bit patterns (so the sign of a zero counts)."""
    torch.cuda.synchronize()
    a, b = got, want.to(got.device)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    mism = int((a != b).sum()) if a.shape == b.shape else -1
    emit("kernel", kernel=name, case=case, mismatched=mism, **row)
    if mism:
        raise AssertionError(f"{name} {case}: {mism} values differ from the "
                             f"plain version")


def check_multipass_kernels(torch, dev):
    """quant_rr (s 2, 3, 5, 9, 17), pack and unpack (bits 1-5) and
    dequant_avg (L 1, 3, 4) against their plain versions, bit-equal, at
    nb 5 × d 37, nb 1 × d 129 and the training shape (66,058 buckets of
    2048, the last one's tail masked); then each timed at the training
    shape (quant_rr s 9, pack/unpack 4 bits, dequant_avg L 1 and 4; the
    library yardstick of dequant_avg at L 1 is one ``torch.gather``)."""
    from repro_torch.core.api import make_quantizer
    from repro_torch.kernels import bitpack as bp
    from repro_torch.kernels import dequant_avg as dq
    from repro_torch.kernels import quant_rr as qr

    g = torch.Generator(device="cpu").manual_seed(8)
    results = {}
    shapes = dict(MP_SMALL, train=(TRAIN_NB, TRAIN_D))
    for case, (nb, d) in shapes.items():
        if case == "train":
            v, mask = _mp_train_values(torch, dev, g)
        else:
            v = (torch.randn((nb, d), generator=g) * 0.3).to(dev)
            v[0, :2] = torch.tensor([-10.0, 10.0])    # outside every table
            mask = torch.ones_like(v, dtype=torch.bool)
        rb = torch.randint(-2 ** 31, 2 ** 31, (nb, d), device=dev,
                           dtype=torch.int64).to(torch.int32)
        for s in (2, 3, 5, 9, 17):
            lv = make_quantizer(S_SCHEME[s]).fit(v, mask)
            if case != "train":
                lv[0, :] = lv[0, :1]                  # equal levels
            got = qr.quant_rr_cuda(v, lv, rb)
            _hold(torch, "quant_rr", f"{case}_s{s}", got,
                  qr.quant_rr_plain(v, lv, rb), shape=[nb, d], s=s)
            if case == "train" and s == 9:
                results["quant_rr"] = _timed(
                    torch, "quant_rr", "train_main_shape",
                    lambda: qr.quant_rr_cuda(v, lv, rb),
                    lambda: qr.quant_rr_plain(v, lv, rb),
                    nbytes(v, lv, rb, got), float(nb * d * (2 * s + 8)),
                    s=s, max_abs_err=0.0)
            del got
        del rb
        for nbits in (1, 2, 3, 4, 5):
            idx = torch.where(mask, torch.randint(
                0, 2 ** nbits, (nb, d), device=dev, dtype=torch.int32), 0)
            words = bp.pack_cuda(idx, nbits)
            _hold(torch, "pack", f"{case}_bits{nbits}", words,
                  bp.pack_plain(idx, nbits), shape=[nb, d], bits=nbits)
            back = bp.unpack_cuda(words, nbits, d)
            _hold(torch, "unpack", f"{case}_bits{nbits}", back,
                  bp.unpack_plain(words, nbits, d), shape=[nb, d],
                  bits=nbits)
            if not torch.equal(back, idx):
                raise AssertionError(f"unpack(pack) {case} bits {nbits}")
            if case == "train" and nbits == 4:
                results["pack"] = _timed(
                    torch, "pack", "train_main_shape",
                    lambda: bp.pack_cuda(idx, 4),
                    lambda: bp.pack_plain(idx, 4), nbytes(idx, words),
                    float(nb * d * 2), bits=4, max_abs_err=0.0)
                results["unpack"] = _timed(
                    torch, "unpack", "train_main_shape",
                    lambda: bp.unpack_cuda(words, 4, d),
                    lambda: bp.unpack_plain(words, 4, d),
                    nbytes(words, back), float(nb * d * 2), bits=4,
                    max_abs_err=0.0)
            del idx, words, back
        del v, mask
        for L in (1, 3, 4):
            idx = torch.randint(0, 16, (L, nb, d), device=dev,
                                dtype=torch.int32)
            idx[:, 0, :2] = torch.tensor([-1, 15])    # decode to 0
            lv = torch.sort(torch.randn((L, nb, 9), device=dev)).values
            lv[:, 0, 0] = -0.0
            out = dq.dequant_avg_cuda(idx, lv)
            _hold(torch, "dequant_avg", f"{case}_L{L}", out,
                  dq.dequant_avg_plain(idx, lv), shape=[nb, d], L=L, s=9)
            if case == "train" and L in (1, 4):
                lib = None
                if L == 1:
                    idx64 = idx[0].to(torch.int64).clamp_(0, 8)
                    lib = lambda: torch.gather(lv[0], 1, idx64)
                results[f"dequant_avg_L{L}"] = _timed(
                    torch, "dequant_avg", f"train_main_shape_L{L}",
                    lambda: dq.dequant_avg_cuda(idx, lv),
                    lambda: dq.dequant_avg_plain(idx, lv),
                    nbytes(idx, lv, out), float(nb * d * L * 2), library=lib,
                    L=L, s=9, max_abs_err=0.0)
            del idx, lv, out
    return results


#: the multi-pass phase's schemes: the registry's, and the two σ-clip
#: cases of the reference's fused-parity tests
MP_SCHEMES = ("orq-9", "orq-17", "bingrad-b", "bingrad-pb", "terngrad",
              "qsgd-5", "linear-5", "minmax2", "signsgd", "terngrad-clip2.5",
              "bingrad-b-lloyd2-clip2.5")
MP_KERNELS = ("quant_rr", "pack", "unpack", "dequant_avg")


def _mp_quantizer(name):
    from repro_torch.core.api import make_quantizer
    from repro_torch.core.quantizers import Quantizer
    if name == "terngrad-clip2.5":
        return Quantizer(method="terngrad", clip_c=2.5)
    if name == "bingrad-b-lloyd2-clip2.5":
        return Quantizer(method="bingrad_b", clip_c=2.5, lloyd_iters=2)
    return make_quantizer(name)


def full_width_grads(torch, dev):
    """(gradient tree, loss) of one full-width lm-100m step (f32 weights
    from seed 0, batch 8 × 128 of the synthetic stream)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM
    from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

    cfg = get_config("lm-100m")
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    batch = SyntheticLM(cfg.vocab_size, 128, 8, seed=0).batch(0, device=dev)
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = model.loss(p, batch)
    grads = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(p)))
    return grads, float(loss.detach())


def full_width_gradient(torch, grads_loss):
    """The full-width gradient laid out by ``GradLayout`` and cut into
    buckets of 2048: the buffer the main path's exchange encodes."""
    from repro_torch.core import buckets
    from repro_torch.core.comm.exchange import GradLayout

    grads, loss = grads_loss
    flat = GradLayout.from_tree(grads).flatten(grads)
    if flat.numel() != TRAIN_N or not bool(torch.isfinite(flat).all()):
        raise AssertionError(f"gradient of {flat.numel()} values, finite "
                             f"{bool(torch.isfinite(flat).all())}")
    bkt, mask = buckets.to_buckets(flat, TRAIN_D)
    return bkt, mask, loss


def _events_ms(torch, fn) -> float:
    """Milliseconds of one call (already warm), CUDA events around it."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _counted(torch, fn, want, totals, what):
    """``fn()`` with every counter zeroed just before and read just after;
    the counts must be ``want`` (every other counter 0). Adds them to
    ``totals``."""
    _zero_counters()
    out = fn()
    torch.cuda.synchronize()
    got = _read_counters()
    if got != _expect(want):
        raise AssertionError(f"{what}: launches {got} != {_expect(want)}")
    for k, n in got.items():
        totals[k] = totals.get(k, 0) + n
    return out, {k: n for k, n in got.items() if n}


def run_multipass_path(torch, dev, grads_loss):
    """Every scheme's multi-pass encode and decodes at full width on
    lm-100m's gradient, against the fused path: encode bit-equal (for
    BinGrad-b the levels within LEVEL_RTOL / FLIP_SHARE, the words the
    exact threshold of the multi-pass levels), mean decode bit-equal,
    per-worker decode equal by value, at L = 1 and at L = 4 (units from
    keys 0-3); launch counts per call; times of both paths."""
    from repro_torch.core import prng
    from repro_torch.core.comm import wire
    from repro_torch.kernels import fused_encode as fe

    bkt, mask, loss = full_width_gradient(torch, grads_loss)
    emit("multipass", what="full-width lm-100m gradient", loss=loss,
         buckets=list(bkt.shape), valid=int(mask.sum()),
         abs_max=float(bkt.abs().max()))
    totals, failed = {}, []
    d = TRAIN_D
    for name in MP_SCHEMES:
        qz = _mp_quantizer(name)
        rr = wire._fused_mode(qz) == "rr"
        keys = [prng.key(k, device=dev) for k in range(4)]
        enc = {"quant_rr": 1, "pack": 1} if rr else {"pack": 1}
        (w_m, l_m), enc_launches = _counted(
            torch, lambda: wire.encode_multipass(qz, bkt, mask, keys[0]),
            enc, totals, f"{name} encode_multipass")
        w_f, l_f = wire.encode(qz, bkt, mask, keys[0])
        res = dict(scheme=name, encode_launches=enc_launches)
        if qz.method == "bingrad_b":
            diff = (l_m - l_f).abs()
            vmax = float((bkt.abs() * mask).max())
            far = int((diff > LEVEL_RTOL * vmax).any(dim=1).sum())
            lim = fe.clip_limit(bkt, mask, qz.clip_c)
            own = fe.encode_fused_cuda(bkt, l_m, None, mask, lim, bits=1,
                                       mode="bin")
            res.update(level_max_abs_diff=float(diff.max()),
                       level_rows_beyond_tol=far,
                       words_vs_own_threshold=_mismatch(torch, w_m, own))
            ok = (res["words_vs_own_threshold"] == 0
                  and far <= FLIP_SHARE * bkt.shape[0]
                  and res["level_max_abs_diff"] <= FLIP_RTOL * vmax)
            del own
        else:
            res.update(
                words_mismatched=_mismatch(torch, w_m, w_f),
                levels_mismatched=_mismatch(torch, l_m.view(torch.int32),
                                            l_f.view(torch.int32)))
            ok = res["words_mismatched"] == 0 and res["levels_mismatched"] == 0
        res["encode_ms"] = {
            "multipass": _events_ms(torch, lambda: wire.encode_multipass(
                qz, bkt, mask, keys[0])),
            "fused": _events_ms(torch, lambda: wire.encode(qz, bkt, mask,
                                                           keys[0]))}
        units = [(w_f, l_f)] + [wire.encode(qz, bkt, mask, k)
                                for k in keys[1:]]
        del w_m, l_m, w_f, l_f
        for L in (1, 4):
            ws = torch.stack([u[0] for u in units[:L]])
            lvs = torch.stack([u[1] for u in units[:L]])
            mean_m, mean_launches = _counted(
                torch, lambda: wire.decode_mean_multipass(qz, ws, lvs, d),
                {"unpack": 1, "dequant_avg": 1}, totals,
                f"{name} decode_mean_multipass L={L}")
            mean_f = wire.decode_mean(qz, ws, lvs, d)
            res[f"L{L}_mean_mismatched_bits"] = _mismatch(
                torch, mean_m.view(torch.int32), mean_f.view(torch.int32))
            del mean_m, mean_f
            each_m, each_launches = _counted(
                torch, lambda: wire.decode_each_multipass(qz, ws, lvs, d),
                {"unpack": 1}, totals, f"{name} decode_each_multipass L={L}")
            each_f = wire.decode_each(qz, ws, lvs, d)
            res[f"L{L}_each_mismatched"] = _mismatch(torch, each_m, each_f)
            del each_m, each_f
            res[f"L{L}_decode_launches"] = {"mean": mean_launches,
                                            "each": each_launches}
            res[f"L{L}_decode_ms"] = {
                "mean_multipass": _events_ms(
                    torch, lambda: wire.decode_mean_multipass(qz, ws, lvs,
                                                              d)),
                "mean_fused": _events_ms(
                    torch, lambda: wire.decode_mean(qz, ws, lvs, d)),
                "each_multipass": _events_ms(
                    torch, lambda: wire.decode_each_multipass(qz, ws, lvs,
                                                              d)),
                "each_fused": _events_ms(
                    torch, lambda: wire.decode_each(qz, ws, lvs, d))}
            ok = ok and res[f"L{L}_mean_mismatched_bits"] == 0 \
                and res[f"L{L}_each_mismatched"] == 0
            del ws, lvs
        del units
        res["ok"] = ok
        emit("multipass", **res)
        if not ok:
            failed.append(name)
    if failed:
        raise AssertionError(f"multi-pass path disagrees with the fused path "
                             f"for {failed}")
    emit("multipass", what="launches over the phase's counted calls",
         launches={k: n for k, n in totals.items() if n})
    return totals


# ---------------------------------------------------------------------------
# phases 10-15: the exchange schedules, the single-device step, theory and
# the dense serve path
# ---------------------------------------------------------------------------

#: shapes the per-leaf and pipelined schedules give the kernels, which no
#: other path gives them: name -> (rows, d, valid values in the last row)
SCHEDULE_SHAPES = {
    "row768": (1, 768, 768),            # final_norm, per leaf at L = 1
    "row192": (1, 192, 192),            # final_norm's chunk at L = 4
    "rows5_last1024": (5, 2048, 1024),  # a (12, 768) norm leaf at L = 1
    "span_k4_last": (16_514, 2048, 768),  # the last K = 4 span at L = 1
}


def check_schedule_shapes(torch, dev):
    """encode_fused, qdq_fused, decode_fused_mean / _each (L = 1 and 4)
    and encode_bingrad_fused at SCHEDULE_SHAPES against their plain
    versions, with the rules of the phases above: bit-equal by value;
    BinGrad-b's levels bit-equal to ``kernel_order_levels``, within
    LEVEL_RTOL of the plain fit (bit-equal on multiples of 1/64), its
    words the exact threshold of its own levels."""
    from repro_torch.core import encode
    from repro_torch.core import levels as lvmod
    from repro_torch.kernels import fused_bingrad as fb
    from repro_torch.kernels import fused_decode as fd
    from repro_torch.kernels import fused_encode as fe

    g = torch.Generator(device="cpu").manual_seed(10)
    failed = []
    for case, (nb, d, last) in SCHEDULE_SHAPES.items():
        mask = (torch.arange(nb * d, device=dev) < (nb - 1) * d + last
                ).reshape(nb, d)
        v = torch.where(mask, (torch.randn((nb, d), generator=g)
                               * 1e-3).to(dev), 0.0)
        lv = lvmod.orq_levels(v, mask, 3)
        rb = _rand_words(torch, g, (nb, d)).to(dev)
        args = (v, lv, rb, mask, None)
        words = fe.encode_fused_cuda(*args, bits=4)
        res = {"encode_fused": _mismatch(
                   torch, words, fe.encode_fused_plain(*args, bits=4)),
               "qdq_fused": _mismatch(
                   torch, fe.qdq_fused_cuda(*args, mode="rr"),
                   fe.qdq_fused_plain(*args, mode="rr"))}
        for L in (1, 4):
            ws = torch.cat([words[None], _rand_words(
                torch, g, (L - 1, nb, encode.packed_words(d, 4))).to(dev)])
            lvs = torch.cat([lv[None], torch.sort(torch.randn(
                (L - 1, nb, 9), generator=g) * 1e-3).values.to(dev)])
            for kname, plain, cuda in (
                    ("decode_fused_mean", fd.decode_fused_mean_plain,
                     fd.decode_fused_mean_cuda),
                    ("decode_fused_each", fd.decode_fused_each_plain,
                     fd.decode_fused_each_cuda)):
                res[f"{kname}/L{L}"] = _mismatch(
                    torch, cuda(ws, lvs, d=d, bits=4),
                    plain(ws, lvs, d=d, bits=4))
        for dist in ("q64", "normal"):
            vb = v if dist == "normal" else torch.where(mask, (torch.randint(
                -64, 65, (nb, d), generator=g).float() / 64).to(dev), 0.0)
            bw, blv = fb.encode_bingrad_fused_cuda(vb, mask, None)
            _, want_l = fb.encode_bingrad_fused_plain(vb, mask, None)
            order = fb.kernel_order_levels(vb, mask, None)
            own = fe.encode_fused_plain(vb, blv, None, mask, None, bits=1,
                                        mode="bin")
            err = float((blv - want_l).abs().max())
            tol = 0.0 if dist == "q64" else LEVEL_RTOL * float(
                vb.abs().max())
            res[f"encode_bingrad_fused/{dist}"] = dict(
                levels_equal_kernel_order=torch.equal(
                    blv.view(torch.int32), order.view(torch.int32)),
                level_err=err, level_tol=tol,
                words_vs_own_threshold=_mismatch(torch, bw, own))
        emit("kernel", case=f"schedule_{case}", shape=[nb, d],
             valid_last_row=last, mismatched=res)
        bad = [k for k, m in res.items() if (
            m if isinstance(m, int) else not (
                m["levels_equal_kernel_order"] and m["level_err"]
                <= m["level_tol"] and m["words_vs_own_threshold"] == 0))]
        if bad:
            failed.append((case, bad))
        del v, mask, lv, rb, words
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"at the schedules' shapes: {failed}")


def run_pipelined_train(torch, k1_sha):
    """The pipelined exchange through the launcher: orq-9 and BinGrad-b,
    3 steps then 2 with error feedback, at K = 4, and orq-9's 3 steps at
    K = 3. The params sha256 of each run equals the K = 1 run's of the
    same arguments (``k1_sha``), collective launches are 4K a step and the
    wire bytes are unchanged; every counter is zeroed just before and read
    just after each scheme's runs."""
    total, failed = {}, []
    plan = (
        ("orq-9", 4, (("orq9", ["--steps", "3"]),
                      ("orq9_ef", ["--steps", "2", "--error-feedback"])),
         {"encode_fused": 40, "decode_fused_mean": 20,
          "decode_fused_each": 20, "qdq_fused": 2}, TRAIN_WIRE_BYTES),
        ("bingrad-b", 4, (("bingrad_b", ["--steps", "3"]),
                          ("bingrad_b_ef", ["--steps", "2",
                                            "--error-feedback"])),
         {"encode_bingrad_fused": 42, "decode_fused_mean": 20,
          "decode_fused_each": 20, "qdq_fused": 2}, wire_bytes_formula(2)),
        ("orq-9", 3, (("orq9", ["--steps", "3"]),),
         {"encode_fused": 18, "decode_fused_mean": 9,
          "decode_fused_each": 9}, TRAIN_WIRE_BYTES))
    for quant, k, runs, expect, wire in plan:
        launches, out = _train_runs(
            torch, quant, tuple((f"{n}_k{k}",
                                 extra + ["--pipeline-chunks", str(k)])
                                for n, extra in runs), expect, wire)
        for k_, n in launches.items():
            total[k_] = total.get(k_, 0) + n
        for name, _ in runs:
            r = out[f"{name}_k{k}"]
            same = r["params_sha256"] == k1_sha[name]
            emit("train_pipelined", run=f"{name}_k{k}", pipeline_chunks=k,
                 params_sha256=r["params_sha256"], k1_sha256=k1_sha[name],
                 equal_k1=same,
                 collective_launches_per_step=r[
                     "collective_launches_per_step"])
            if not same or r["collective_launches_per_step"] != 4 * k:
                failed.append(f"{name}_k{k}")
    if failed:
        raise AssertionError(f"pipelined runs differ from K = 1: {failed}")
    return total


#: lm-100m's per-leaf exchange at L = 1: 12 leaves, 4 collectives each
PER_LEAF_WIRE = {"orq-9": 140_043_800, "bingrad-b": 34_878_832}


def run_per_leaf_train(torch):
    """The per-leaf exchange through the launcher: one step, then one with
    error feedback, for orq-9 and BinGrad-b. 48 collective launches a
    step, the reference's per-leaf wire bytes, and per step 24 encodes,
    12 decodes of each kind (and 12 qdq with error feedback)."""
    total = {}
    for quant, enc, enc_n in (("orq-9", "encode_fused", 48),
                              ("bingrad-b", "encode_bingrad_fused", 60)):
        name = quant.replace("-", "")
        launches, out = _train_runs(
            torch, quant,
            ((f"{name}_leaf", ["--steps", "1", "--per-leaf-exchange"]),
             (f"{name}_leaf_ef", ["--steps", "1", "--per-leaf-exchange",
                                  "--error-feedback"])),
            {enc: enc_n, "decode_fused_mean": 24, "decode_fused_each": 24,
             "qdq_fused": 12}, PER_LEAF_WIRE[quant])
        for r in out.values():
            if r["collective_launches_per_step"] != 48:
                raise AssertionError(f"{quant} per-leaf launches "
                                     f"{r['collective_launches_per_step']}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


def _subtree(tree, ffn_wo=False):
    """final_norm, and the first group's wq, norm1 and norm2 (stacked over
    the 12 layers): the leaves of 768 values, of 12 rows of 768 and a
    7,077,888-value weight; with ``ffn_wo`` also the FFN's 18,874,368-value
    down projection (12 × 2048 × 768)."""
    gp = tree["groups"][0]["pos0"]
    sub = {"attn": {"wq": gp["attn"]["wq"]}, "norm1": gp["norm1"],
           "norm2": gp["norm2"]}
    if ffn_wo:
        sub["ffn"] = {"wo": gp["ffn"]["wo"]}
    return {"final_norm": tree["final_norm"], "groups": ({"pos0": sub},)}


def check_per_leaf_card_vs_cpu(torch, dev, grads):
    """The per-leaf exchange and its EF residuals (``LeafExchange``) of
    five leaves of the full-width gradient (final_norm, wq, norm1, norm2
    and the FFN's wo: 26.0 M values), each put on the grid of
    multiples of 1/64 of its max |g| (so every fit's sums are exact in any
    order), on the card (NCCL) and on the CPU (a gloo group of the same
    world): bit-equal for orq-9; for BinGrad-b the means within 2^-20 of
    their magnitude (phase 2 re-fits means, off the grid) and the
    residuals bit-equal."""
    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.core import prng
    from repro_torch.core.comm.exchange import LeafExchange
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import LM
    from repro_torch.utils.pytree import tree_leaves, tree_map

    paths = _subtree(LM(get_config("lm-100m")).param_paths(grads), True)
    sub = _on_grid(torch, _subtree(grads, True))
    gloo = dist.new_group(ranks=[0], backend="gloo")
    failed = []
    for scheme in ("orq-9", "bingrad-b"):
        out = {}
        for where, group in ((dev, None), ("cpu", gloo)):
            lex = LeafExchange(QuantPolicy.parse(scheme), group)
            x = tree_map(lambda t: t.to(where), sub)
            key = prng.key(13, device=where)
            out[str(where)] = [
                torch.cat([t.reshape(-1).cpu() for t in tree_leaves(tr)])
                for tr in (lex.exchange(paths, x, key),
                           lex.residuals(paths, x, key))]
        (m_card, e_card), (m_cpu, e_cpu) = out[str(dev)], out["cpu"]
        err = float((m_card - m_cpu).abs().max())
        tol = (2.0 ** -20 * float(m_cpu.abs().max())
               if scheme in MEAN_LEVELS else 0.0)
        res = dict(scheme=scheme, leaves=tree_leaves(paths),
                   n=m_card.numel(),
                   mean_mismatched=_mismatch(torch, m_card, m_cpu),
                   residual_mismatched=_mismatch(torch, e_card, e_cpu),
                   mean_max_abs_diff=err, mean_tol=tol)
        emit("train_per_leaf", what="per-leaf exchange + EF of full-width "
             "leaves on the 1/64 grid, card (NCCL) vs CPU (gloo)", **res)
        if res["residual_mismatched"] or err > tol:
            failed.append(scheme)
    dist.destroy_process_group(gloo)
    if failed:
        raise AssertionError(f"card and CPU per-leaf exchanges differ for "
                             f"{failed}")


def _on_grid(torch, tree):
    """Each leaf put on the multiples of 1/64 of its max |g|."""
    from repro_torch.utils.pytree import tree_map
    return tree_map(lambda g: torch.round(g / g.abs().max() * 64) / 64, tree)


class _FixedGradient:
    """A model over the leaves of ``G`` whose loss is ``sum(p * G)``: its
    gradient is ``G`` exactly, on any device, so that the single-device
    step's exchange and residuals can be held card against CPU."""

    def __init__(self, G, paths):
        self.G, self.paths = G, paths

    def abstract_params(self):
        return self.G

    def param_paths(self, params):
        return self.paths

    def init(self, generator, device=None):
        import torch
        from repro_torch.utils.pytree import tree_map
        return tree_map(torch.zeros_like, self.G)

    def loss(self, params, batch):
        import torch
        from repro_torch.utils.pytree import tree_leaves
        loss = sum((p * g).sum() for p, g in zip(
            tree_leaves(params), tree_leaves(self.G), strict=True))
        return loss, {"nll": loss, "aux": 0.0,
                      "tokens": torch.ones((), device=loss.device)}


#: the single-device step's second step, card vs CPU, per leaf: the
#: relative norm of the residuals' and of the updates' differences (see
#: check_local_card_vs_cpu; readings on an H100 80GB HBM3 at 700 W:
#: 0 for orq-9, <= 9.3e-8 and <= 1.5e-7 for BinGrad-b, whose levels are
#: means)
LOCAL_RESIDUAL_RTOL = 1e-6
LOCAL_UPDATE_RTOL = 1e-6


def check_local_card_vs_cpu(torch, dev, grads):
    """The single-device step (``data_parallel=False``) with error feedback
    on ``_FixedGradient`` over ``_subtree``'s leaves of the full-width
    gradient on the 1/64 grid, on the card and on the CPU: orq-9 and
    BinGrad-b, fused and per leaf, two steps from zero residuals. The
    first step quantizes grid values, whose fits are exact in any order:
    params and residuals bit-equal. The second adds that residual, off the
    grid, so the fits sum in another order: per leaf, the residual within
    LOCAL_RESIDUAL_RTOL and the update within LOCAL_UPDATE_RTOL in
    relative norm."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import prng
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import LM
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import TrainConfig, init_state, make_train_step
    from repro_torch.utils.pytree import tree_leaves, tree_map

    paths = _subtree(LM(get_config("lm-100m")).param_paths(grads))
    G = _on_grid(torch, _subtree(grads))
    failed = []
    for quant in ("orq-9", "bingrad-b"):
        for fused in (True, False):
            tcfg = TrainConfig(policy=QuantPolicy.parse(quant),
                               error_feedback=True, fused_exchange=fused)
            runs = {}
            for where in (dev, "cpu"):
                model = _FixedGradient(
                    tree_map(lambda g: g.to(where), G), paths)
                fn = make_train_step(model, tcfg, constant_lr(0.05),
                                     data_parallel=False)
                state = init_state(model, tcfg, device=where)
                states = [state]
                for _ in range(2):
                    state, _ = fn(state, {}, prng.key(0, device=where))
                    states.append(state)
                runs[str(where)] = [
                    ([p.cpu() for p in tree_leaves(s.params)],
                     [e.cpu() for e in tree_leaves(s.ef)])
                    for s in states]
            card, cpu = runs[str(dev)], runs["cpu"]
            res = dict(scheme=quant,
                       exchange="fused" if fused else "per-leaf",
                       leaves=tree_leaves(paths))
            res["step1_params_mismatched"] = sum(
                _mismatch(torch, a, b) for a, b in zip(card[1][0], cpu[1][0]))
            res["step1_residuals_mismatched"] = sum(
                _mismatch(torch, a, b) for a, b in zip(card[1][1], cpu[1][1]))
            res["step1_residual_max_abs"] = max(
                float(e.abs().max()) for e in card[1][1])
            res["step2_residuals_mismatched"] = sum(
                _mismatch(torch, a, b) for a, b in zip(card[2][1], cpu[2][1]))
            res["step2_residual_rel"] = [
                float((a - b).norm() / max(float(b.norm()), 1e-30))
                for a, b in zip(card[2][1], cpu[2][1])]
            res["step2_update_rel"] = [
                float((a - b).norm() / max(float((b - p0).norm()), 1e-30))
                for a, b, p0 in zip(card[2][0], cpu[2][0], cpu[1][0])]
            emit("train_local", what="single-device step on a fixed "
                 "gradient (1/64 grid), card vs CPU", **res)
            ok = (res["step1_params_mismatched"] == 0
                  and res["step1_residuals_mismatched"] == 0
                  and res["step1_residual_max_abs"] > 0)
            ok = (ok and max(res["step2_update_rel"]) <= LOCAL_UPDATE_RTOL
                  and max(res["step2_residual_rel"]) <= LOCAL_RESIDUAL_RTOL)
            if not ok:
                failed.append(f"{quant} {res['exchange']}")
    if failed:
        raise AssertionError(f"single-device step card vs CPU: {failed}")


def _all_zero(torch, what, fn):
    """``fn()`` with every counter zeroed just before; the path is plain
    PyTorch, as in the reference, so every counter must still read 0."""
    _zero_counters()
    out = fn()
    torch.cuda.synchronize()
    launches = _read_counters()
    if any(launches.values()):
        raise AssertionError(f"{what} launched kernels: {launches}")
    return out


def run_local_train(torch, dev):
    """The single-device step (``make_train_step(..., data_parallel=
    False)``, no collective) on full-width lm-100m for orq-9 and
    BinGrad-b with error feedback: two steps each, finite losses, each
    step's time (the first includes the warm-up). The local qdq is plain
    PyTorch (``Quantizer.qdq``), as in the reference: no kernel."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import prng
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import TrainConfig, init_state, make_train_step

    cfg = get_config("lm-100m")
    model = LM(cfg)
    data = SyntheticLM(cfg.vocab_size, 128, 8, seed=0)
    for quant in ("orq-9", "bingrad-b"):
        tcfg = TrainConfig(policy=QuantPolicy.parse(quant),
                           error_feedback=True)
        state = init_state(model, tcfg, seed=0, device=dev)
        fn = make_train_step(model, tcfg, constant_lr(0.05),
                             data_parallel=False)
        key = prng.key(0, device=dev)
        losses, step_ms = [], []

        def steps():
            nonlocal state
            for i in range(2):
                batch = data.batch(i, device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = fn(state, batch, key)
                losses.append(float(m["loss"]))
                step_ms.append((time.perf_counter() - t0) * 1e3)

        _all_zero(torch, f"train_local {quant}", steps)
        emit("train_local", scheme=quant, losses=losses, step_ms=step_ms,
             launches_and_bytes=list(fn.launches_and_bytes(1)))
        if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
            raise AssertionError(f"train_local {quant}: loss {losses}")
        del state


#: scheme_mse card vs CPU: the same bucket fits in another summation order
#: (readings on an H100 80GB HBM3 at 700 W: rel_diff <= 1.7e-7)
THEORY_RTOL = 1e-6
#: buckets the CPU recomputes (all 66,058 take ~170 s there)
THEORY_CPU_BUCKETS = 1024


def check_theory(torch, grads):
    """``theory.scheme_mse`` of the full-width gradient for every scheme of
    the registry on the card (fp has no fit and raises, as in the
    reference), timed; the same on its first THEORY_CPU_BUCKETS buckets on
    the card and on the CPU, within THEORY_RTOL."""
    from repro_torch.core import theory
    from repro_torch.core.api import all_methods, make_quantizer
    from repro_torch.core.comm.exchange import GradLayout

    flat = GradLayout.from_tree(grads).flatten(grads)
    head = flat[:THEORY_CPU_BUCKETS * TRAIN_D]
    failed = []

    def run():
        for name in all_methods():
            qz = make_quantizer(name)
            if qz.is_identity:
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = float(theory.scheme_mse(qz, flat))
            ms = (time.perf_counter() - t0) * 1e3
            card = float(theory.scheme_mse(qz, head))
            cpu = float(theory.scheme_mse(qz, head.cpu()))
            rel = abs(card - cpu) / max(abs(cpu), 1e-30)
            emit("theory", scheme=name, mse_full_width=full, ms=ms,
                 head_buckets=THEORY_CPU_BUCKETS, mse_head_card=card,
                 mse_head_cpu=cpu, rel_diff=rel, rtol=THEORY_RTOL)
            if not (rel <= THEORY_RTOL and full > 0 and full == full):
                failed.append(name)

    _all_zero(torch, "theory", run)
    if failed:
        raise AssertionError(f"scheme_mse card vs CPU: {failed}")


def _first_difference(torch, args, dense, paged):
    """The first (row, step) where the dense and the paged greedy tokens
    differ, and the dense logits' gap there between the two picks (the
    dense decode fed the paged engine's tokens up to that step)."""
    from repro_torch.launch import serve as launcher

    diff = dense != paged
    t = int(diff.any(axis=0).argmax())
    b = int(diff[:, t].argmax())
    a = launcher.parse_args(args)
    device, model, params, prompt = launcher.setup(a)
    cache = model.init_cache(a.batch, a.max_len, device=device)
    p = torch.as_tensor(prompt, dtype=torch.int64, device=device)
    for off in range(0, a.prompt_len, a.prefill_chunk):
        lg, cache = model.prefill_chunk(params, cache,
                                        p[:, off:off + a.prefill_chunk], off)
    for i in range(t):
        tok = torch.as_tensor(paged[:, i:i + 1], dtype=torch.int64,
                              device=device)
        lg, cache = model.decode_step(params, cache, tok, a.prompt_len + i)
    row = lg[b, -1].float()
    return dict(row=b, step=t, dense_token=int(dense[b, t]),
                paged_token=int(paged[b, t]),
                logit_gap=float(row[int(dense[b, t])]
                                - row[int(paged[b, t])]))


def profile_dense_decode(torch, args):
    """Device time by category over four dense decode steps (batch 8,
    the prompt prefilled in chunks), beside the same steps' wall time
    without the profiler; busy share = device time / unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve as launcher

    a = launcher.parse_args(args)
    device, model, params, prompt = launcher.setup(a)
    cache = model.init_cache(a.batch, a.max_len, device=device)
    p = torch.as_tensor(prompt, dtype=torch.int64, device=device)
    for off in range(0, a.prompt_len, a.prefill_chunk):
        lg, cache = model.prefill_chunk(params, cache,
                                        p[:, off:off + a.prefill_chunk], off)
    pos = [a.prompt_len]

    def steps():
        nonlocal lg, cache
        for _ in range(4):
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            lg, cache = model.decode_step(params, cache, tok, pos[0])
            pos[0] += 1
        torch.cuda.synchronize()

    steps()                                          # warm-up
    t0 = time.perf_counter()
    steps()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        steps()
        time.sleep(PROFILE_PAD_S)
    rows = _kernel_events(prof)
    total = sum(r[0] for r in rows)
    emit("profile", scheme="dense bf16 ring buffer",
         window="4 decode steps, batch 8",
         wall_ms_unprofiled=plain_wall * 1e3, device_us=total,
         kernel_launches=sum(r[2] for r in rows),
         device_busy_share=total / 1e3 / (plain_wall * 1e3),
         by_category=_by_category(rows),
         top=[{"name": k[:90], "count": c, "device_us": us}
              for us, k, c in rows[:12]])


def run_dense_serve(torch):
    """The dense ring-buffer serve path through the launcher (no
    ``--kv-quant``) on full-width lm-100m, batch 8, prompt 128, 32 new
    tokens, context 512, prefill chunk 64; then the bf16 paged engine on
    the same prompts. The greedy tokens must be equal (the reference's
    ``tests/test_serve_engine.py`` holds the same); both paths are plain
    PyTorch (``masked_decode_attention``), so every counter reads 0."""
    import numpy as np

    from repro_torch.launch import serve as launcher

    dense_args = [a for a in MAIN_ARGS if a not in ("--kv-quant", "orq-9")]
    paged_args = dense_args + ["--kv-quant", "bf16"]
    runs = {}
    for name, args in (("dense", dense_args), ("paged_bf16", paged_args)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = _all_zero(torch, f"serve {name}",
                      lambda: launcher.serve(args))
        wall = time.perf_counter() - t0
        r.pop("engine")
        runs[name] = r
        emit("serve_dense", run=name, args=" ".join(args), wall_s=wall,
             peak_mem_bytes=torch.cuda.max_memory_allocated(),
             **{k: v for k, v in r.items() if k != "tokens"})
    dense, paged = runs["dense"]["tokens"], runs["paged_bf16"]["tokens"]
    equal = bool(np.array_equal(dense, paged))
    first = None if equal else _first_difference(torch, dense_args, dense,
                                                  paged)
    emit("serve_dense", what="dense vs bf16 paged greedy tokens",
         equal=equal, first_difference=first,
         differing=int((dense != paged).sum()), tokens=int(dense.size))
    if dense.shape != (8, 32) or not equal:
        raise AssertionError(f"dense and bf16 paged tokens differ: {first}")
    _all_zero(torch, "dense decode profile",
              lambda: profile_dense_decode(torch, dense_args))


# ---------------------------------------------------------------------------
# phases 15-16: fsdp, the two-level hierarchy, checkpoints
# ---------------------------------------------------------------------------

#: shapes only the fsdp and two-level paths give the kernels (lm-100m,
#: bucket 2048): name -> (workers L, rows per worker, d, valid values in
#: each worker's last row). The fsdp buffer at L = 1 is the training shape.
FSDP_SHAPES = {
    "fsdp_L4_chunks": (4, 16_515, 2048, 704),     # the fsdp RS at L = 4
    "intra_shard": (1, 33_029, 2048, 1408),       # the two-level shard
    "leaf_wq_L1": (1, 288, 2048, 2048),           # a per-leaf fsdp slice
}


def _kernel_times(torch, kern, plain, moved, ops):
    """ms / device_ms of a kernel and of its plain version, and the
    bound, at one of FSDP_SHAPES."""
    b_ms, b_by = bound(moved, ops)
    return dict(ms=time_ms(kern, reps=5, rounds=3),
                plain_ms=time_ms(plain, reps=1, rounds=2),
                device_ms=device_ms(kern, calls=5,
                                    floor_ms=hbm_floor_ms(moved)),
                plain_device_ms=device_ms(plain, calls=1), bytes=moved,
                bound_ms=b_ms, bound_by=b_by)


def check_fsdp_shapes(torch, dev):
    """encode_fused, qdq_fused, decode_fused_mean / _each and
    encode_bingrad_fused at FSDP_SHAPES against their plain versions, by
    the rules of ``check_schedule_shapes``, each timed beside its bound;
    -> kernel -> case -> times."""
    from repro_torch.core import encode
    from repro_torch.core import levels as lvmod
    from repro_torch.kernels import fused_bingrad as fb
    from repro_torch.kernels import fused_decode as fd
    from repro_torch.kernels import fused_encode as fe

    g = torch.Generator(device="cpu").manual_seed(15)
    times, failed = {}, []
    for case, (L, nb, d, last) in FSDP_SHAPES.items():
        rows = L * nb
        one = torch.arange(nb * d, device=dev) < (nb - 1) * d + last
        mask = one.repeat(L).reshape(rows, d)
        v = torch.where(mask, (torch.randn((rows, d), generator=g)
                               * 1e-3).to(dev), 0.0)
        lv = lvmod.orq_levels(v, mask, 3)
        rb = _rand_words(torch, g, (rows, d)).to(dev)
        args = (v, lv, rb, mask, None)
        words = fe.encode_fused_cuda(*args, bits=4)
        qdq = fe.qdq_fused_cuda(*args, mode="rr")
        res = {"encode_fused": _mismatch(
                   torch, words, fe.encode_fused_plain(*args, bits=4)),
               "qdq_fused": _mismatch(
                   torch, qdq, fe.qdq_fused_plain(*args, mode="rr"))}
        ops = float(rows * d * (2 * 9 + 8))
        row = {"encode_fused": _kernel_times(
                   torch, lambda: fe.encode_fused_cuda(*args, bits=4),
                   lambda: fe.encode_fused_plain(*args, bits=4),
                   nbytes(*args, words), ops),
               "qdq_fused": _kernel_times(
                   torch, lambda: fe.qdq_fused_cuda(*args, mode="rr"),
                   lambda: fe.qdq_fused_plain(*args, mode="rr"),
                   nbytes(*args, qdq), ops)}
        ws = words.reshape(L, nb, encode.packed_words(d, 4))
        lvs = lv.reshape(L, nb, 9)
        for kname, plain, cuda in (
                ("decode_fused_mean", fd.decode_fused_mean_plain,
                 fd.decode_fused_mean_cuda),
                ("decode_fused_each", fd.decode_fused_each_plain,
                 fd.decode_fused_each_cuda)):
            got = cuda(ws, lvs, d=d, bits=4)
            res[kname] = _mismatch(torch, got, plain(ws, lvs, d=d, bits=4))
            row[kname] = _kernel_times(
                torch, lambda: cuda(ws, lvs, d=d, bits=4),
                lambda: plain(ws, lvs, d=d, bits=4), nbytes(ws, lvs, got),
                float(rows * d))
        for dist in ("q64", "normal"):
            vb = v if dist == "normal" else torch.where(mask, (torch.randint(
                -64, 65, (rows, d), generator=g).float() / 64).to(dev), 0.0)
            bw, blv = fb.encode_bingrad_fused_cuda(vb, mask, None)
            want_w, want_l = fb.encode_bingrad_fused_plain(vb, mask, None)
            order = fb.kernel_order_levels(vb, mask, None)
            own = fe.encode_fused_plain(vb, blv, None, mask, None, bits=1,
                                        mode="bin")
            ok = (torch.equal(blv.view(torch.int32), order.view(torch.int32))
                  and _mismatch(torch, bw, own) == 0)
            if dist == "q64":
                ok = ok and torch.equal(blv, want_l) and torch.equal(bw,
                                                                     want_w)
            res[f"encode_bingrad_fused/{dist}"] = int(not ok)
        row["encode_bingrad_fused"] = _kernel_times(
            torch, lambda: fb.encode_bingrad_fused_cuda(v, mask, None),
            lambda: fb.encode_bingrad_fused_plain(v, mask, None),
            nbytes(v, mask, bw, blv), float(rows * d * 6))
        emit("kernel", case=f"fsdp_{case}", workers=L, rows_per_worker=nb,
             d=d, valid_last_row=last, mismatched=res, times=row)
        for kname, t in row.items():
            times.setdefault(kname, {})[case] = t
        bad = [k for k, m in res.items() if m]
        if bad:
            failed.append((case, bad))
        del v, mask, lv, rb, words, qdq, ws, lvs
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"at the fsdp shapes: {failed}")
    return times


#: lm-100m's fsdp reduce-scatter at L = 1, bucket 2048 (the reference's
#: ``FsdpExchange`` accounting): 2 collective launches a step
FSDP_WIRE = {"orq-9": 70_021_480, "bingrad-b": 17_439_312}
#: 3 steps, then 2 with error feedback: one encode and one mean decode a
#: step (``quantized_reduce_scatter_mean``), one ``qdq_fused`` an EF step
#: (``local_qdq_comm_layout``); BinGrad-b's EF levels are one more encode
FSDP_EXPECT = {
    "orq-9": {"encode_fused": 5, "decode_fused_mean": 5, "qdq_fused": 2},
    "bingrad-b": {"encode_bingrad_fused": 7, "decode_fused_mean": 5,
                  "qdq_fused": 2}}
#: per-leaf fsdp, orq-9, L = 1: 111 gather calls a step (each stacked leaf
#: once per layer), one reduce-scatter each: 222 collective launches,
#: 70,021,380 wire bytes (the reference's per-gather accounting)
PER_LEAF_FSDP = {"gathers": 111, "launches": 222, "wire": 70_021_380}


def run_fsdp_train(torch):
    """Phase 15: the launcher with ``--mode fsdp`` on full-width lm-100m,
    a NCCL world of one: orq-9 and BinGrad-b, 3 steps then 2 with error
    feedback (every counter zeroed just before each scheme's runs and read
    just after: FSDP_EXPECT); 2 collective launches a step and FSDP_WIRE
    bytes. ``--hierarchy two_level`` on this world of one is the flat
    exchange: the same params sha256 as the flat orq-9 run. One per-leaf
    fsdp step: PER_LEAF_FSDP. -> (launches, the orq-9 EF run's state)."""
    total, sha, state = {}, {}, None
    for quant in ("orq-9", "bingrad-b"):
        name = quant.replace("-", "")
        launches, out = _train_runs(
            torch, quant,
            ((f"{name}_fsdp", ["--steps", "3", "--mode", "fsdp"]),
             (f"{name}_fsdp_ef", ["--steps", "2", "--mode", "fsdp",
                                  "--error-feedback"])),
            FSDP_EXPECT[quant], FSDP_WIRE[quant])
        for k, r in out.items():
            sha[k] = r["params_sha256"]
            if r["collective_launches_per_step"] != 2:
                raise AssertionError(f"{k}: {r['collective_launches_per_step']}"
                                     f" collective launches a step")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        if quant == "orq-9":
            state = out[f"{name}_fsdp_ef"]["state"]
    launches, out = _train_runs(
        torch, "orq-9", (("orq9_fsdp_two_level",
                          ["--steps", "3", "--mode", "fsdp", "--hierarchy",
                           "two_level"]),),
        {"encode_fused": 3, "decode_fused_mean": 3}, FSDP_WIRE["orq-9"])
    two = out["orq9_fsdp_two_level"]["params_sha256"]
    emit("train_fsdp", run="orq9_fsdp_two_level", params_sha256=two,
         flat_sha256=sha["orq9_fsdp"], equal_flat=two == sha["orq9_fsdp"])
    if two != sha["orq9_fsdp"]:
        raise AssertionError("two_level on a world of one differs from flat")
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n
    launches, out = _train_runs(
        torch, "orq-9", (("orq9_fsdp_leaf",
                          ["--steps", "1", "--mode", "fsdp",
                           "--per-leaf-exchange"]),),
        {"encode_fused": PER_LEAF_FSDP["gathers"],
         "decode_fused_mean": PER_LEAF_FSDP["gathers"]},
        PER_LEAF_FSDP["wire"])
    got = out["orq9_fsdp_leaf"]["collective_launches_per_step"]
    emit("train_fsdp", run="orq9_fsdp_leaf", collective_launches=got,
         expected=PER_LEAF_FSDP["launches"])
    if got != PER_LEAF_FSDP["launches"]:
        raise AssertionError(f"per-leaf fsdp launches {got}")
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n
    return total, state


def check_fsdp_card_vs_cpu(torch, dev, grads):
    """The fsdp exchange and its EF residuals
    (``FsdpExchange.exchange_with_residuals``) of the five full-width
    leaves of phase 11 (final_norm, wq, norm1, norm2 and the FFN's wo:
    26.0 M values, sharded as lm-100m's plan shards them), on the 1/64
    grid with
    EF buffers of multiples of 1/512, on the card (NCCL) and on the CPU (a
    gloo group of the same world), orq-9 and BinGrad-b: bit-equal."""
    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.core import prng
    from repro_torch.core.comm.fsdp_exchange import FsdpExchange
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import LM
    from repro_torch.train.step import plan_sharding_shapes

    model = LM(get_config("lm-100m"))
    ap = model.abstract_params()
    plan = plan_sharding_shapes(model, ap, dp_axes=("data",),
                                axis_sizes={"data": 1})
    sub = _on_grid(torch, _subtree(grads, True))
    gloo = dist.new_group(ranks=[0], backend="gloo")
    failed = []
    for scheme in ("orq-9", "bingrad-b"):
        out = {}
        for where, group in ((dev, None), ("cpu", gloo)):
            fex = FsdpExchange.build(
                QuantPolicy.parse(scheme), _subtree(ap, True), ("data",),
                paths=_subtree(plan.paths, True),
                shard_dims=plan.full_shard_dims(), n_shards=1, group=group)
            bufs = [b.to(where) for b in fex.layout.flatten_groups(sub)]
            g = torch.Generator().manual_seed(16)
            ef = tuple(None if n is None else (torch.randint(
                -8, 9, (n,), generator=g).float() / 512).to(where)
                for n in fex.ef_group_sizes())
            outs, res = fex.exchange_with_residuals(
                bufs, prng.key(17, device=where), None, ef)
            out[str(where)] = [t.cpu() for t in list(outs) + [
                r for r in res if r is not None]]
        mism = [_mismatch(torch, a, b) for a, b in zip(out[str(dev)],
                                                       out["cpu"])]
        emit("train_fsdp", what="fsdp exchange + EF of full-width leaves "
             "on the 1/64 grid, card (NCCL) vs CPU (gloo)", scheme=scheme,
             n=sum(t.numel() for t in out["cpu"]), mismatched=mism)
        if any(mism):
            failed.append(scheme)
    dist.destroy_process_group(gloo)
    if failed:
        raise AssertionError(f"card and CPU fsdp exchanges differ for "
                             f"{failed}")


CKPT_ARGS = ["--smoke", "--arch", "lm-100m", "--quant", "orq-9", "--bucket",
             "512", "--mode", "fsdp", "--error-feedback", "--batch", "8",
             "--seq", "64", "--seed", "0", "--log-every", "1", "--steps",
             "4"]


def run_checkpoint(torch):
    """Phase 16: ``--smoke`` fsdp orq-9 with error feedback, 4 steps
    writing its state after step 2, then a run resumed from that state:
    the same params sha256 (6 steps: encode, mean decode and qdq 6 each).
    Then the save and load of a full-width params checkpoint (541 MB of
    float32), timed once. -> launches."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as launcher
    from repro_torch.models import LM
    from repro_torch.utils.pytree import tree_leaves

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ck = f"{tmp}/state"
    _zero_counters()
    whole = launcher.train(CKPT_ARGS + ["--state-checkpoint", ck,
                                        "--checkpoint-at", "2"])
    resumed = launcher.train(CKPT_ARGS + ["--resume", ck,
                                          "--checkpoint", f"{tmp}/final"])
    launches = _read_counters()
    want = _expect({"encode_fused": 6, "decode_fused_mean": 6,
                    "qdq_fused": 6})
    same = whole["params_sha256"] == resumed["params_sha256"]
    emit("checkpoint", run="fsdp orq-9 EF, resume after step 2",
         params_sha256=whole["params_sha256"],
         resumed_sha256=resumed["params_sha256"], equal=same,
         resumed_steps=len(resumed["step_s"]), launches=launches,
         expected=want)
    final, _ = load_checkpoint(f"{tmp}/final", resumed["state"].params)
    digest = launcher.params_digest(final)
    emit("checkpoint", what="--checkpoint of the resumed run",
         params_sha256=digest, equal=digest == resumed["params_sha256"])
    if not same or launches != want or digest != resumed["params_sha256"]:
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one, or its params file from "
                             "its params")
    params = LM(get_config("lm-100m")).init(torch.Generator().manual_seed(0),
                                            device="cuda")
    path = f"{tmp}/params"
    t0 = time.perf_counter()
    save_checkpoint(path, params, step=0)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, _ = load_checkpoint(path, params)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                  tree_leaves(params)))
    emit("checkpoint", what="full-width lm-100m params, npz (compressed)",
         bytes=sum(t.numel() * 4 for t in tree_leaves(params)),
         file_bytes=Path(path + ".npz").stat().st_size, save_s=save_s,
         load_s=load_s, equal=equal)
    if not equal:
        raise AssertionError("the params checkpoint does not round-trip")
    return launches


# ---------------------------------------------------------------------------
# phase 17: the adaptive bit schedule
# ---------------------------------------------------------------------------

SCHED_ARGS = ["--arch", "lm-100m", "--bucket", "2048", "--batch", "8",
              "--seq", "128", "--seed", "0", "--log-every", "1",
              "--error-feedback"]
#: the ramp of phase 17: one step at each of 5, 4, 3, 2 and 1 wire bits
RAMP = "norm|bias=fp,default=orq@5..1"
RAMP_SCHEMES = {5: "orq-17", 4: "orq-9", 3: "orq-5", 2: "orq-3",
                1: "minmax2"}
#: an EF step of one quantized group (and the fp norms): both exchange
#: phases encode once and decode once, the residual is one qdq
STEP_EXPECT = {"encode_fused": 2, "decode_fused_mean": 1,
               "decode_fused_each": 1, "qdq_fused": 1}


def _path_sizes(model):
    from repro_torch.utils.pytree import tree_leaves
    ap = model.abstract_params()
    return [(p, int(t.numel())) for p, t in zip(
        tree_leaves(model.param_paths(ap)), tree_leaves(ap))]


def run_bit_schedule_train(torch, dev):
    """Phase 17: ``--bit-schedule`` through the launcher on full-width
    lm-100m, the NCCL world of one, error feedback. The ramp orq@5..1
    resolved every step (orq-17, orq-9, orq-5, orq-3, minmax2): each step's
    assignment, launch counts (zeroed before the step, read after it), wire
    bytes (the static policy's accounting at that width) and time. A
    frozen ``orq@4`` ends on the static ``default=orq-9`` run's sha256,
    replicated and fsdp. Then the controller with a DCN budget: the
    ScheduledTrainStep priced on the reference benchmark's flat 4-worker
    link (``policy_link_stats``, as ``benchmarks/convergence.py``), the
    budget the static orq-9 policy's own priced bytes: the decisions
    after the first are statistics-driven, each within the budget.
    -> launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import prng
    from repro_torch.core.comm.exchange import (policy_link_stats,
                                                policy_stats)
    from repro_torch.core.policy import (BitBudgetController, BitSchedule,
                                         QuantPolicy)
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as launcher
    from repro_torch.models import LM
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import TrainConfig, init_state
    from repro_torch.train.step import ScheduledTrainStep

    model = LM(get_config("lm-100m"))
    ps = _path_sizes(model)
    total = dict.fromkeys(_counters(), 0)
    rows = []

    def on_step(i, state, metrics, step_fn):
        torch.cuda.synchronize()
        got = _read_counters()
        bits = step_fn.last_assignment[-1]
        want_bytes = policy_stats(QuantPolicy.parse(
            f"norm|bias=fp,default={RAMP_SCHEMES[bits]}",
            bucket_size=2048), ps, 1)[1]
        rows.append(dict(step=i, bits=list(step_fn.last_assignment),
                         scheme=RAMP_SCHEMES[bits], launches=got,
                         wire_bytes=step_fn.launches_and_bytes(1)[1],
                         static_wire_bytes=want_bytes,
                         loss=float(metrics["loss"])))
        for k, n in got.items():
            total[k] += n
        _zero_counters()

    _zero_counters()
    r = launcher.train(SCHED_ARGS + ["--bit-schedule", RAMP,
                                     "--resolve-every", "1", "--steps", "5"],
                       on_step=on_step)
    for row, sec in zip(rows, r["step_s"]):
        row["step_ms"] = sec * 1e3
        emit("train_bit_schedule", run="ramp orq@5..1", **row)
    bad = [row["step"] for row in rows
           if row["launches"] != _expect(STEP_EXPECT)
           or row["wire_bytes"] != row["static_wire_bytes"]
           or not abs(row["loss"]) < float("inf")]
    if ([row["bits"][-1] for row in rows] != [5, 4, 3, 2, 1] or bad
            or not r["replicas_in_sync"]):
        raise AssertionError(f"the ramp's steps {bad} (or its bits) are off")

    # a frozen schedule is the static policy, replicated and fsdp
    frozen = {}
    _zero_counters()
    for mode in ("replicated", "fsdp"):
        m = ["--mode", mode, "--steps", "2"]
        st = launcher.train(SCHED_ARGS + m + ["--quant",
                                              "norm|bias=fp,default=orq-9"])
        fr = launcher.train(SCHED_ARGS + m + ["--bit-schedule",
                                              "norm|bias=fp,default=orq@4"])
        frozen[mode] = (st["params_sha256"], fr["params_sha256"])
        emit("train_bit_schedule", run=f"frozen orq@4, {mode}",
             static_sha256=st["params_sha256"],
             frozen_sha256=fr["params_sha256"],
             equal=st["params_sha256"] == fr["params_sha256"],
             bits=[h["bits"] for h in fr["history"]])
    for k, n in _read_counters().items():
        total[k] += n
    if any(a != b for a, b in frozen.values()):
        raise AssertionError(f"a frozen schedule left the static run: "
                             f"{frozen}")

    # the water-filling solve under a budget, statistics-driven
    sched = BitSchedule.parse(RAMP, bucket_size=2048)

    def priced(policy):
        return policy_link_stats(policy, ps, n_intra=1, n_inter=4,
                                 two_level=False)[0]["dcn_q_bytes"]

    budget = priced(QuantPolicy.parse("norm|bias=fp,default=orq-9",
                                      bucket_size=2048))
    ctl = BitBudgetController(sched, 5, resolve_every=1,
                              dcn_budget_bytes=budget, cost_fn=priced)
    step_fn = ScheduledTrainStep(
        model, TrainConfig(error_feedback=True, collect_stats=True), ctl,
        constant_lr(0.05))
    state = init_state(model, step_fn.init_config, device=dev, step=step_fn)
    data = SyntheticLM(model.cfg.vocab_size, 128, 8, seed=0)
    key = prng.key(0, device=dev)
    _zero_counters()
    for i in range(5):
        state, m = step_fn(state, data.batch(i, device=dev), key)
    for k, n in _read_counters().items():
        total[k] += n
    emit("train_bit_schedule", run="budget = static orq-9's priced bytes "
         "(flat 4-worker link)", budget=budget, decisions=ctl.decisions,
         last_stats=step_fn.entry_stats(m["exchange_stats"]))
    del state
    d = ctl.decisions
    if (len(d) != 5 or not all(x["stats_driven"] for x in d[1:])
            or any(x["est_dcn_bytes"] > budget for x in d)
            or d[0]["bits"] != [None, 4]):
        raise AssertionError(f"the budgeted decisions are off: {d}")
    emit("train_bit_schedule", what="launches over the phase", **total)
    return total


# ---------------------------------------------------------------------------
# phase 18: the temporal hierarchy
# ---------------------------------------------------------------------------

class _WireCount:
    """Counts the wire collectives (``all_to_all_single``, the all-gathers)
    every ``torch.distributed`` call of the port makes while active."""

    NAMES = ("all_to_all_single", "all_gather_into_tensor", "all_gather")

    def __init__(self, dist):
        self.dist, self.n, self.real = dist, 0, {}

    def __enter__(self):
        for name in self.NAMES:
            real = self.real[name] = getattr(self.dist, name)

            def counted(*a, _real=real, **kw):
                self.n += 1
                return _real(*a, **kw)
            setattr(self.dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.dist, name, real)


def run_async_train(torch, dev, dist, flat_sha):
    """Phase 18: ``two_level_async`` on full-width lm-100m, orq-9, EF, a
    pod of one (``pod_axis=True``: the NCCL world of one, its outer
    exchange flat). H = 2 over 4 steps through ``make_train_step``: inner
    steps launch no kernel and no wire collective, sync steps what the
    flat EF step does (encode 2, mean 1, each 1, qdq 1; 2 all_to_all + 2
    all_gather), and after each sync the params are the anchor; the p50 of
    each kind. H = 1 through the launcher ends on phase 7's flat EF
    sha256, as ``--hierarchy two_level`` does. -> launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import prng
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as launcher
    from repro_torch.models import LM
    from repro_torch.optim.schedule import step_decay
    from repro_torch.train import TrainConfig, init_state, make_train_step
    from repro_torch.train.step import AsyncTrainStep
    from repro_torch.utils.pytree import tree_leaves

    model = LM(get_config("lm-100m"))
    tcfg = TrainConfig(policy=QuantPolicy.parse("orq-9", bucket_size=2048),
                       hierarchy="two_level_async", local_steps=2,
                       error_feedback=True)
    fn = make_train_step(model, tcfg, step_decay(0.05, [2, 3]),
                         pod_axis=True)
    if not isinstance(fn, AsyncTrainStep) or fn.layout.two_level:
        raise AssertionError("a pod of one should give the flat async step")
    state = init_state(model, tcfg, device=dev, step=fn)
    data = SyntheticLM(model.cfg.vocab_size, 128, 8, seed=0)
    key = prng.key(0, device=dev)
    total = dict.fromkeys(_counters(), 0)
    times = {True: [], False: []}
    bad = []
    for i in range(4):
        batch = data.batch(i, device=dev)
        sync = fn.is_sync_step(state.step)
        _zero_counters()
        torch.cuda.synchronize()
        with _WireCount(dist) as wire:
            t0 = time.perf_counter()
            state, m = fn(state, batch, key)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        got = _read_counters()
        for k, n in got.items():
            total[k] += n
        times[sync].append(sec)
        at_anchor = all(torch.equal(a, p) for a, p in zip(
            tree_leaves(state.outer.anchor), tree_leaves(state.params)))
        want = _expect(STEP_EXPECT if sync else {})
        emit("train_async", step=i, sync=sync, launches=got,
             wire_collectives=wire.n, params_are_anchor=at_anchor,
             loss=float(m["loss"]), step_ms=sec * 1e3)
        if (got != want or wire.n != (4 if sync else 0)
                or at_anchor != sync or not abs(float(m["loss"])) < 1e30):
            bad.append(i)
    del state
    p50 = {("sync" if k else "inner"): statistics.median(v) * 1e3
           for k, v in times.items()}
    links = fn.link_bytes()
    emit("train_async", run="H = 2, 4 steps", step_p50_ms=p50,
         link_bytes_per_step=links,
         launches_and_bytes=list(fn.launches_and_bytes(1)))
    if bad:
        raise AssertionError(f"async steps {bad} launched or synced wrongly")

    shas = {}
    _zero_counters()
    for name, extra in (("two_level_async H=1",
                         ["--hierarchy", "two_level_async",
                          "--local-steps", "1"]),
                        ("two_level", ["--hierarchy", "two_level"])):
        r = launcher.train(TRAIN_ARGS + ["--steps", "2", "--error-feedback",
                                         *extra])
        shas[name] = r["params_sha256"]
    for k, n in _read_counters().items():
        total[k] += n
    emit("train_async", run="H = 1 and two_level on one card, 2 EF steps",
         sha256=shas, flat_sha256=flat_sha,
         equal=set(shas.values()) == {flat_sha})
    if set(shas.values()) != {flat_sha}:
        raise AssertionError("H = 1 / two_level left the flat run")
    emit("train_async", what="launches over the phase", **total)
    return total


def check_async_card_vs_cpu(torch, dev, grads):
    """The sync step of ``two_level_async`` (the inner update, the outer
    exchange of the window's delta with its EF residual, the Nesterov
    outer step) on phase 11's five full-width leaves (a model whose
    gradient is those leaves on the 1/64 grid), from a
    state on the grid (lr 1, momentum 0.5: the delta stays on the grid),
    on the card (NCCL) and on the CPU (a gloo group of the same world):
    params, optimizer state, EF, anchor and outer momentum bit-equal."""
    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.core import prng
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import LM
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.state import OuterState, TrainState
    from repro_torch.utils.pytree import tree_leaves, tree_map

    cfg = get_config("lm-100m")
    paths = _subtree(LM(cfg).param_paths(grads), True)
    G = _on_grid(torch, _subtree(grads, True))
    g = torch.Generator().manual_seed(21)

    def grid(k, den):
        return tree_map(lambda t: (torch.randint(
            -k, k + 1, tuple(t.shape), generator=g).float() / den), G)

    start = dict(params=grid(16, 64), opt=grid(16, 32),
                 anchor=grid(16, 64), mom=grid(16, 64))
    tcfg = TrainConfig(policy=QuantPolicy.parse("orq-9", bucket_size=2048),
                       hierarchy="two_level_async", local_steps=2,
                       error_feedback=True, momentum=0.5)
    gloo = dist.new_group(ranks=[0], backend="gloo")
    out = {}
    for where, group in ((dev, None), ("cpu", gloo)):
        model = _FixedGradient(tree_map(lambda t: t.to(where), G), paths)
        model.cfg = cfg
        fn = make_train_step(model, tcfg, constant_lr(1.0), group=group,
                             pod_axis=True)
        n_ef = [n for n in fn.exchange.ef_shard_sizes(1)]
        ef = tuple(None if n is None else (torch.randint(
            -8, 9, (n,), generator=torch.Generator().manual_seed(22)
        ).float() / 64).to(where) for n in n_ef)
        on = {k: tree_map(lambda t: t.to(where), v) for k, v in start.items()}
        state = TrainState(params=on["params"], opt=on["opt"], step=1, ef=ef,
                           outer=OuterState(anchor=on["anchor"],
                                            mom=on["mom"]))
        if not fn.is_sync_step(state.step):
            raise AssertionError("step 1 of a window of 2 is a sync step")
        new, _ = fn(state, None, prng.key(23, device=where))
        out[str(where)] = [t.cpu() for t in tree_leaves(
            (new.params, new.opt, new.ef, new.outer))]
    dist.destroy_process_group(gloo)
    mism = [_mismatch(torch, a, b) for a, b in zip(out[str(dev)],
                                                   out["cpu"])]
    emit("train_async", what="sync step (outer exchange + EF + Nesterov) "
         "of full-width leaves on the 1/64 grid, card (NCCL) vs CPU (gloo)",
         n=sum(t.numel() for t in out["cpu"]), mismatched=sum(mism))
    if any(mism):
        raise AssertionError("card and CPU async sync steps differ")


# ---------------------------------------------------------------------------
# phase 19: the paper's CIFAR setting (ResNet, per-leaf qdq, SGD with wd)
# ---------------------------------------------------------------------------

CIFAR_STEPS = 3
#: config -> (ResNetConfig fields, leaves, parameters)
CIFAR_CONFIGS = {"example": ({"width": 16, "blocks_per_stage": 1}, 25,
                             77_850),
                 "resnet20": ({}, 61, 272_282)}
#: a float32 gradient of this net is good to ~5e-3 of a leaf's largest
#: entry (the CPU tests' float64 comparison): card and CPU within 1e-2
CIFAR_GRAD_ATOL = 1e-2


def _cifar_expect(method, leaves, steps):
    want = {k: 0 for k in _counters()}
    if method != "fp":
        want["qdq_fused"] = leaves * steps
    if method == "bingrad-b":
        want["encode_bingrad_fused"] = leaves * steps
    return want


def run_paper_cifar(torch, dev):
    """``paper_cifar.train`` on the card for every method of the reference
    example on both configs: launches (one ``qdq_fused`` a leaf a step,
    BinGrad-b also one ``encode_bingrad_fused``; none for fp), finite
    losses, step times, the table's loss and accuracy."""
    from repro_torch.launch import paper_cifar as pc
    from repro_torch.models.resnet import ResNetConfig
    from repro_torch.utils.pytree import tree_leaves

    totals = {k: 0 for k in _counters()}
    smi = nvidia_smi()
    for cname, (fields, leaves, n_params) in CIFAR_CONFIGS.items():
        cfg = ResNetConfig(**fields)
        for m in pc.METHODS:
            _zero_counters()
            t0 = time.perf_counter()
            r = pc.train(m, CIFAR_STEPS, cfg=cfg, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read_counters()
            want = _cifar_expect(m, leaves, CIFAR_STEPS)
            ps = tree_leaves(r.params)
            emit("paper_cifar", config=cname, method=m, steps=CIFAR_STEPS,
                 leaves=len(ps), n_params=sum(t.numel() for t in ps),
                 losses=r.losses, loss=r.loss, accuracy=r.accuracy,
                 step_ms=[t * 1e3 for t in r.step_s],
                 step_p50_ms_after_first=statistics.median(
                     r.step_s[1:]) * 1e3,
                 wall_s=wall, sha256=r.sha256, launches=launches,
                 expected_launches=want, device=smi)
            if launches != want:
                raise AssertionError(f"paper_cifar {cname} {m}: launches "
                                     f"{launches} != {want}")
            if (len(ps), sum(t.numel() for t in ps)) != (leaves, n_params):
                raise AssertionError(f"paper_cifar {cname}: tree "
                                     f"{len(ps)} leaves")
            finite = all(x == x and abs(x) < float("inf") for x in r.losses)
            if not finite or not 0.0 <= r.accuracy <= 1.0:
                raise AssertionError(f"paper_cifar {cname} {m}: losses "
                                     f"{r.losses}, accuracy {r.accuracy}")
            for k, v in launches.items():
                totals[k] += v
    return totals


def check_cifar_card_vs_cpu(torch, dev):
    """The card against the CPU from the same start (weights, batch,
    keys), on both configs: the first step's gradient within
    CIFAR_GRAD_ATOL of each leaf's largest entry; each leaf's qdq of the
    CPU's gradient bit-equal for the random-rounding schemes (BinGrad-b:
    values within LEVEL_RTOL, at most FLIP_SHARE of them on the other side
    of b0); the params after one fp step within lr x that gradient bound
    of each other, and after one orq-9 optimizer step from each side's
    qdq of the same gradient within the same bound (a step from each
    side's own gradient would let a rounding that the gradient's last
    bits flip move an element by a whole level)."""
    from repro_torch.core import prng
    from repro_torch.core.api import make_quantizer
    from repro_torch.data import cifar_like_batches
    from repro_torch.launch import paper_cifar as pc
    from repro_torch.models.resnet import ResNetConfig, init_resnet
    from repro_torch.optim import optimizers
    from repro_torch.utils.pytree import (tree_flatten_with_path, tree_leaves,
                                          tree_map)

    for cname, (fields, _, _) in CIFAR_CONFIGS.items():
        cfg = ResNetConfig(**fields)
        p_cpu = init_resnet(torch.Generator().manual_seed(0), cfg, "cpu")
        p_dev = tree_map(lambda t: t.to(dev), p_cpu)
        b_cpu = next(cifar_like_batches(pc.BATCH, seed=0, device="cpu"))
        b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
        key = prng.fold_in(prng.key(1), 0)
        l_cpu, g_cpu = pc.loss_and_grads(p_cpu, b_cpu, cfg)
        l_dev, g_dev = pc.loss_and_grads(p_dev, b_dev, cfg)
        grad_err = max(
            float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(tree_leaves(g_dev), tree_leaves(g_cpu)))
        g_max = max(float(t.abs().max()) for t in tree_leaves(g_cpu))
        row = {"config": cname, "loss_card": float(l_dev),
               "loss_cpu": float(l_cpu),
               "grad_max_err_of_leaf_max": grad_err}
        if not grad_err <= CIFAR_GRAD_ATOL:
            raise AssertionError(f"paper_cifar {cname}: gradient card vs "
                                 f"CPU {grad_err} > {CIFAR_GRAD_ATOL}")
        g_fixed = tree_map(lambda t: t.to(dev), g_cpu)
        for m in ("terngrad", "orq-3", "orq-9", "bingrad-b"):
            qz = make_quantizer(m, bucket_size=pc.BUCKET)
            want = pc.qdq_grads(qz, g_cpu, key)
            got = pc.qdq_grads(qz, g_fixed, key.to(dev))
            diff = flips = total = 0
            for (path, a), b in zip(tree_flatten_with_path(got)[0],
                                    tree_leaves(want)):
                a = a.cpu()
                total += b.numel()
                if m == "bingrad-b":
                    tol = LEVEL_RTOL * float(b.abs().max())
                    flips += int(((a - b).abs() > tol).sum())
                else:
                    diff += int((a.view(torch.int32)
                                 != b.view(torch.int32)).sum())
            row[f"qdq_{m}"] = ({"flips": flips, "elements": total}
                               if m == "bingrad-b" else
                               {"bits_differ": diff, "elements": total})
            if diff or flips > FLIP_SHARE * total:
                raise AssertionError(f"paper_cifar {cname} {m} qdq card vs "
                                     f"CPU: {row[f'qdq_{m}']}")
        # the first step moves p by lr x (g + wd p): the gradients'
        # difference bounds the params'
        tol = pc.LR * CIFAR_GRAD_ATOL * g_max + 1e-6
        for m in ("fp", "orq-9"):
            opt, step = pc.make_step(m, cfg)
            if m == "fp":
                pc_, _, _ = step(p_cpu, opt.init(p_cpu), b_cpu, key)
                pd_, _, _ = step(p_dev, opt.init(p_dev), b_dev, key.to(dev))
            else:     # each side's qdq of one gradient, bit-equal above
                qz = make_quantizer(m, bucket_size=pc.BUCKET)
                pc_, _ = optimizers.step(
                    opt, pc.qdq_grads(qz, g_cpu, key), opt.init(p_cpu),
                    p_cpu, pc.LR)
                pd_, _ = optimizers.step(
                    opt, pc.qdq_grads(qz, g_fixed, key.to(dev)),
                    opt.init(p_dev), p_dev, pc.LR)
            err = max(float((a.cpu() - b).abs().max())
                      for a, b in zip(tree_leaves(pd_), tree_leaves(pc_)))
            row[f"step_{m}_params_max_err"] = err
            row[f"step_{m}_tol"] = tol
            if not err <= tol:
                raise AssertionError(f"paper_cifar {cname} {m}: params after "
                                     f"one step card vs CPU {err} > {tol}")
        emit("paper_cifar_card_vs_cpu", **row)


# ---------------------------------------------------------------------------
# phase 20: the dense GQA and sliding-window architectures, served
# ---------------------------------------------------------------------------

#: arch -> layers kept: one cycle of its layer pattern
SERVE_ARCHS = {"qwen1.5-32b": 1, "command-r-plus-104b": 1,
               "chameleon-34b": 1, "gemma2-9b": 2, "gemma3-27b": 6}
ARCH_BATCH, ARCH_GEN, ARCH_PAGE, ARCH_CHUNK = 2, 3, 64, 512
ARCH_TRAIN_ARGS = ["--smoke", "--quant", "orq-9", "--steps", "1",
                   "--batch", "2", "--seq", "128", "--bucket", "512"]


def _arch_prompt_len(cfg) -> int:
    """64 tokens past the window (so a local layer's mask binds), or 128."""
    return (cfg.window or 64) + 64


def _record(module, name, calls, keep):
    """Wrap ``module.name`` so that calls ``keep(args)`` accepts are
    recorded; returns the original to restore."""
    orig = getattr(module, name)

    def rec(*args, **kwargs):
        if keep(args):
            calls.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, rec)
    return orig


def _hold_arch_attend(torch, arch, calls, smi):
    """The recorded ``decode_attend`` calls of one decode step (one a
    layer), kernel against its plain version on the same inputs within
    ATOL_ATTEND; the first and the last layer's timed (local and global
    on the windowed archs)."""
    from repro_torch.kernels import fused_kv as fk

    out = []
    for li, (args, kw) in enumerate(calls):
        args = tuple(a.clone() for a in args)
        want = fk.decode_attend_plain(*args, **kw)
        got = fk.decode_attend_cuda(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        q, kw_, klv, vw, vlv, mask = args
        B, T, H, hd = q.shape
        row = dict(arch=arch, layer=li, B=B, T=T, H=H, KV=kw["kv_heads"],
                   hd=hd, C=kw_.shape[1], softcap=kw["softcap"],
                   admitted_share=float(mask.float().mean()),
                   max_abs_err=err, finite=bool(torch.isfinite(got).all()))
        if li in (0, len(calls) - 1):
            kern = lambda: fk.decode_attend_cuda(*args, **kw)
            plain = lambda: fk.decode_attend_plain(*args, **kw)
            moved, ops = attend_work(torch, q, kw_, klv, mask, got)
            b_ms, b_by = bound(moved, ops)
            row.update(ms=time_ms(kern), plain_ms=time_ms(plain),
                       device_ms=device_ms(kern,
                                           floor_ms=hbm_floor_ms(moved)),
                       plain_device_ms=device_ms(plain), bytes=moved,
                       bound_ms=b_ms, bound_by=b_by, device=smi)
        emit("kernel", kernel="decode_attend", case=f"{arch}/layer{li}",
             atol=ATOL_ATTEND, **row)
        if not err <= ATOL_ATTEND or not row["finite"]:
            raise AssertionError(f"decode_attend {arch} layer {li}: max abs "
                                 f"err {err} > {ATOL_ATTEND}")
        out.append(row)
    return out


def _hold_arch_encode(torch, arch, calls, smi):
    """The first recorded KV encode (K and V rows of one decode step of
    one layer): ``encode_fused`` against its plain version on the card,
    bit for bit, timed."""
    from repro_torch.core.comm import wire
    from repro_torch.kernels import fused_encode as fe

    (qz, k_rows, v_rows, rbits), _ = calls[0]
    v = torch.cat([k_rows, v_rows], dim=0).to(torch.float32).contiguous()
    levels = wire._fit(qz, v, None)
    lim = fe.clip_limit(v, None, qz.clip_c)
    args = (v, levels, rbits, None, lim)
    kw = dict(bits=qz.wire_bits_per_element, mode="rr")
    got = fe.encode_fused_cuda(*args, **kw)
    want = fe.encode_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    bad = _mismatch(torch, got, want)
    kern = lambda: fe.encode_fused_cuda(*args, **kw)
    plain = lambda: fe.encode_fused_plain(*args, **kw)
    moved = nbytes(v, levels, rbits, got)
    b_ms, b_by = bound(moved, 0.0)
    row = dict(arch=arch, rows=v.shape[0], d=v.shape[1], words_differ=bad,
               ms=time_ms(kern), plain_ms=time_ms(plain),
               device_ms=device_ms(kern, floor_ms=hbm_floor_ms(moved)),
               bytes=moved, bound_ms=b_ms, bound_by=b_by, device=smi)
    emit("kernel", kernel="encode_fused", case=f"{arch}/kv_rows", **row)
    if bad:
        raise AssertionError(f"encode_fused {arch}: {bad} words differ")
    return row


def run_serve_archs(torch, dev):
    """Each new architecture at full width, its depth cut to one cycle of
    its layer pattern, served on the paged engine with orq-9 pages: two
    prompts 64 tokens past the window (or of 128), then ARCH_GEN greedy
    tokens. Counters zeroed just before: the KV encode and
    ``decode_attend`` read forward calls x layers. Then every decode-step
    ``decode_attend`` call of the run and its first KV encode held against
    the plain versions; then one ``--smoke`` training step of the arch
    through the launcher."""
    from repro_torch.configs.base import cut_depth, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.models import LM
    from repro_torch.models.model import map_tree
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve import engine as engine_mod
    from repro_torch.utils.pytree import tree_leaves

    smi = nvidia_smi()
    totals = {k: 0 for k in _counters()}
    times = {}
    for arch, layers in SERVE_ARCHS.items():
        full = get_config(arch)
        cfg = cut_depth(full, layers)
        model = LM(cfg)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        n_params = sum(t.numel() for t in tree_leaves(params))
        params = map_tree(lambda t: t.to(torch.bfloat16), params)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        plen = _arch_prompt_len(cfg)
        pages = -(-(plen + ARCH_GEN) // ARCH_PAGE)
        scfg = ServeConfig(kv_quant="orq-9", page_size=ARCH_PAGE,
                           max_batch=ARCH_BATCH, max_pages_per_seq=pages,
                           prefill_chunk=ARCH_CHUNK)
        eng = Engine(model, params, scfg, device=dev)
        prompts = torch.randint(0, cfg.vocab_size, (ARCH_BATCH, plen),
                                generator=torch.Generator().manual_seed(1))
        attend_calls, encode_calls = [], []
        decode_shape = lambda a: a[0].shape[:2] == (ARCH_BATCH, 1)
        o_att = _record(ops, "decode_attend", attend_calls, decode_shape)
        o_enc = _record(engine_mod, "append_kv", encode_calls,
                        lambda a: a[1].shape[0] == ARCH_BATCH)
        try:
            _zero_counters()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rids = [eng.submit(p.numpy().astype("int32"), max_new=ARCH_GEN)
                    for p in prompts]
            res = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read_counters()
        finally:
            ops.decode_attend, engine_mod.append_kv = o_att, o_enc
        toks = [res[r].generated for r in rids]
        expect = eng.forward_calls * layers
        want = {k: (expect if k in ("encode_fused", "decode_attend") else 0)
                for k in launches}
        row = dict(arch=arch, layers=layers, layers_full=full.num_layers,
                   reduced=f"num_layers {full.num_layers} -> {layers} (one "
                           f"cycle of {list(full.layer_pattern)})",
                   n_params=n_params, bf16_weight_bytes=2 * n_params,
                   d_model=cfg.d_model, heads=cfg.num_heads,
                   kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
                   window=cfg.window, attn_softcap=cfg.attn_softcap,
                   prompt_len=plen, context=pages * ARCH_PAGE,
                   init_s=init_s, wall_s=wall,
                   prefill_s=eng.prefill_time,
                   prefill_tok_s=eng.prefill_tokens / max(eng.prefill_time,
                                                          1e-9),
                   decode_step_ms=[t * 1e3 for t in eng.decode_times],
                   tokens=toks, forward_calls=eng.forward_calls,
                   launches=launches, expected_launches=want,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   device=smi)
        emit("serve_archs", **row)
        if launches != want:
            raise AssertionError(f"serve {arch}: launches {launches} != "
                                 f"{want}")
        if (any(len(t) != ARCH_GEN for t in toks)
                or not all(0 <= x < cfg.vocab_size for t in toks for x in t)):
            raise AssertionError(f"serve {arch}: bad tokens {toks}")
        if len(attend_calls) < layers or not encode_calls:
            raise AssertionError(f"serve {arch}: no decode-step calls "
                                 f"recorded")
        for k, v in launches.items():
            totals[k] += v
        del eng, params
        torch.cuda.empty_cache()
        att = _hold_arch_attend(torch, arch, attend_calls[:layers], smi)
        enc = _hold_arch_encode(torch, arch, encode_calls, smi)
        times[arch] = {"decode_attend": [r for r in att if "ms" in r],
                       "encode_fused": enc}
        if att[0]["softcap"] != cfg.attn_softcap or (
                att[0]["H"], att[0]["KV"], att[0]["hd"]) != (
                cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim):
            raise AssertionError(f"serve {arch}: decode_attend saw "
                                 f"{att[0]}")
        del attend_calls, encode_calls
        r = launcher.train(["--arch", arch, *ARCH_TRAIN_ARGS])
        losses = [h["loss"] for h in r["history"]]
        emit("serve_archs_train", arch=arch, args=" ".join(ARCH_TRAIN_ARGS),
             losses=losses, step_s=r["step_s"], n_params=r["n_params"],
             params_sha256=r["params_sha256"], device=smi)
        if not all(x == x and abs(x) < float("inf") for x in losses):
            raise AssertionError(f"train {arch} --smoke: losses {losses}")
    return totals, times


# ---------------------------------------------------------------------------
# phase 21: Mixture-of-Experts and Multi-head Latent Attention
# ---------------------------------------------------------------------------

#: arch -> layers kept: mixtral's one (MoE) layer; deepseek's dense first
#: layer and one MLA + MoE layer
MOE_ARCHS = {"mixtral-8x22b": 1, "deepseek-v2-236b": 2}
MOE_BATCH, MOE_PROMPT, MOE_GEN, MOE_MAX_LEN = 8, 64, 9, 128
MOE_TRAIN_ARGS = ["--smoke", "--bucket", "512", "--batch", "8", "--seq",
                  "64", "--seed", "0", "--log-every", "1"]
#: 2 steps then 1 with error feedback: two encodes a step (BinGrad-b's EF
#: levels a third), one decode of each kind, one qdq an EF step
MOE_TRAIN_EXPECT = {
    "orq-9": {"encode_fused": 6, "decode_fused_mean": 3,
              "decode_fused_each": 3, "qdq_fused": 1},
    "bingrad-b": {"encode_bingrad_fused": 7, "decode_fused_mean": 3,
                  "decode_fused_each": 3, "qdq_fused": 1}}
MOE_ATOL_F32 = 1e-5
MLA_ATOL = 1e-4
MLA_CACHE_RTOL = 1e-6
ATOL_BF16 = 0.02               # of the logits' largest magnitude
ROUTE_AGREE = 0.9
ROUTE_TIE = 1e-2               # a router margin the bf16 drift may close


def _moe_routing_log(moe):
    """Record every ``moe.route`` call's tokens, capacity and tensors
    (left on their device: no sync inside the timed path); returns (log,
    restore)."""
    log, orig = [], moe.route

    def rec(p, x, spec):
        r = orig(p, x, spec)
        log.append(dict(T=int(x.shape[0]), C=r.capacity, keep=r.keep,
                        topi=r.topi, probs=r.probs.detach()))
        return r

    moe.route = rec
    return log, lambda: setattr(moe, "route", orig)


def _drop_stats(calls):
    if not calls:
        return None
    kept = sum(int(c["keep"].sum()) for c in calls)
    slots = sum(c["keep"].numel() for c in calls)
    return dict(calls=len(calls), tokens=sorted({c["T"] for c in calls}),
                capacity=sorted({c["C"] for c in calls}),
                dropped_share=1.0 - kept / slots)


def _route_flips(want_log, got_log):
    """Per MoE call: the share of tokens sent to the same expert set, and
    the reference side's margin between its k-th and (k+1)-th prob at
    each token whose set differs."""
    out = []
    for w, g in zip(want_log, got_log, strict=True):
        wi, gi = w["topi"].cpu(), g["topi"].cpu()
        same = (wi.sort(-1).values == gi.sort(-1).values).all(-1)
        k = wi.shape[-1]
        srt = w["probs"].cpu().sort(-1, descending=True).values
        margin = (srt[:, k - 1] - srt[:, k])[~same]
        out.append((float(same.float().mean()), margin.tolist()))
    return out


def _moe_serve(torch, dev, arch, layers, smi):
    """One arch at full width, its depth cut to ``layers``, on the dense
    path through the serving launcher's ``_serve_dense``: prefill (chunked
    for GQA, token by token for MLA) of MOE_BATCH prompts of MOE_PROMPT
    tokens, then MOE_GEN - 1 decode steps. Counters zeroed just before
    must read 0 (the dense path is plain PyTorch, as in the reference)."""
    from repro_torch.configs.base import cut_depth, get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import LM, moe
    from repro_torch.models.model import map_tree
    from repro_torch.utils.pytree import tree_leaves

    full = get_config(arch)
    cfg = cut_depth(full, layers)
    model = LM(cfg)
    ap = model.abstract_params()
    n_params = sum(t.numel() for t in tree_leaves(ap))
    biggest = max(t.numel() for t in tree_leaves(ap))
    # the f32 draw, one leaf's stacking copy, then the bf16 copy beside it
    reckoned = 4 * n_params + 4 * biggest + 2 * n_params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    params = map_tree(lambda t: t.to(torch.bfloat16), params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    chunk = MOE_PROMPT if model.supports_chunked_prefill() else 0
    args = launcher.parse_args([
        "--arch", arch, "--batch", str(MOE_BATCH), "--prompt-len",
        str(MOE_PROMPT), "--gen", str(MOE_GEN), "--max-len",
        str(MOE_MAX_LEN), "--prefill-chunk", str(chunk)])
    prompt = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT),
                           generator=torch.Generator().manual_seed(1)
                           ).numpy().astype("int32")
    n_moe = sum(s.moe for s in model.specs)
    log, restore = _moe_routing_log(moe)
    try:
        _zero_counters()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        r = launcher._serve_dense(args, model, params, prompt, dev)
        launches = _read_counters()
        serve_peak = torch.cuda.max_memory_allocated() - base
    finally:
        restore()
    warm = n_moe * (2 if chunk else 1)
    dec_calls = (MOE_GEN - 1) * n_moe
    m = cfg.mla
    gqa_bytes = 2 * cfg.num_heads * cfg.resolved_head_dim * 2
    cache_expect = sum(
        (MOE_BATCH * MOE_MAX_LEN * r["token_bytes"] + MOE_MAX_LEN * 4)
        for s in model.specs) if m else None
    row = dict(arch=arch, layers=layers, layers_full=full.num_layers,
               reduced=f"num_layers {full.num_layers} -> {layers}",
               n_params=n_params, bf16_weight_bytes=2 * n_params,
               d_model=cfg.d_model, heads=cfg.num_heads,
               kv_heads=cfg.num_kv_heads, experts=cfg.moe.num_experts,
               top_k=cfg.moe.top_k, shared=cfg.moe.num_shared,
               d_ff_expert=cfg.moe.d_ff_expert, mla=m is not None,
               init_s=init_s, init_peak_bytes=init_peak,
               init_peak_reckoned_bytes=reckoned,
               serve_peak_above_start=serve_peak,
               prefill_chunk=r["prefill_chunk"],
               prefill_tokens=r["prefill_tokens"], prefill_s=r["prefill_s"],
               prefill_tok_s=r["prefill_tok_s"],
               decode_tokens=r["decode_tokens"],
               decode_step_p50_ms=r["step_p50_ms"],
               decode_step_p99_ms=r["step_p99_ms"],
               decode_tok_s=r["decode_tok_s"],
               moe_prefill=_drop_stats(log[warm:len(log) - dec_calls]),
               moe_decode=_drop_stats(log[len(log) - dec_calls:]),
               token_bytes=r["token_bytes"], gqa_token_bytes=gqa_bytes,
               cache_bytes=r["cache_bytes"], cache_bytes_expected=cache_expect,
               launches=launches, tokens_sha256=r["sha256"], device=smi)
    emit("moe_mla", what="serve, dense path", **row)
    toks = r["tokens"]
    if any(launches.values()):
        raise AssertionError(f"{arch} dense serve launched kernels "
                             f"{launches}")
    if toks.shape != (MOE_BATCH, MOE_GEN) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{arch}: bad tokens {toks.shape}")
    if (len(log) != warm + (MOE_PROMPT // max(chunk, 1) if chunk
                            else MOE_PROMPT) * n_moe + dec_calls):
        raise AssertionError(f"{arch}: {len(log)} MoE calls")
    if m is not None and (r["token_bytes"] != (m.kv_lora + m.rope_head_dim)
                          * 2 or r["cache_bytes"] != cache_expect):
        raise AssertionError(f"{arch}: MLA cache accounting {row}")
    del params, r
    torch.cuda.empty_cache()
    return row


def _mla_row_split(torch, dev, cfg, p, x, pos):
    """Where the new cache row's card-vs-CPU differences arise, stage by
    stage of ``blocks._mla_decode``'s write: the projection ``norm1(x) @
    wkv_a`` (its latent and rope parts), then ``rms_norm`` and
    ``apply_rope`` each on the CPU's projection on both sides, so that
    each stage's own rounding shows. -> stage -> (values that differ of
    all, max abs diff)."""
    from repro_torch.models import blocks
    from repro_torch.models.layers import apply_rope, rms_norm
    from repro_torch.models.model import map_tree

    dc = cfg.mla.kv_lora
    to_dev = lambda t: t.to(dev)  # noqa: E731

    def project(pp, xx):
        return blocks._apply_norm(cfg, pp["norm1"], xx)[:, 0] @ pp["attn"][
            "wkv_a"]

    def norm_rope(pp, kv):
        posv = torch.full((kv.shape[0], 1), pos, dtype=torch.int32,
                          device=kv.device)
        return (rms_norm(kv[..., :dc], pp["attn"]["kv_norm"], cfg.norm_eps),
                apply_rope(kv[..., dc:][:, None, None, :], posv,
                           cfg.rope_theta)[:, 0, 0])

    def diff(a, b):
        a = a.cpu()
        return [int((a != b).sum()), b.numel(), float((a - b).abs().max())]

    pd = map_tree(to_dev, p)
    kv_cpu = project(p, x)
    kv_dev = project(pd, to_dev(x))
    ckv_cpu, kr_cpu = norm_rope(p, kv_cpu)
    ckv_dev, kr_dev = norm_rope(pd, to_dev(kv_cpu))
    return {"projection_latent": diff(kv_dev[..., :dc], kv_cpu[..., :dc]),
            "projection_rope": diff(kv_dev[..., dc:], kv_cpu[..., dc:]),
            "rms_norm_alone": diff(ckv_dev, ckv_cpu),
            "apply_rope_alone": diff(kr_dev, kr_cpu)}


def _moe_card_vs_cpu(torch, dev, arch, smi):
    """At the ``SMOKE`` sizes, the same weights on both sides: ``moe_ffn``
    in f32 (routing equal, y and aux within MOE_ATOL_F32), one MLA decode
    step in f32 (new ``ckv`` / ``kr`` rows within MLA_CACHE_RTOL of their
    magnitude, every other slot and ``pos`` bit-equal, the output within
    MLA_ATOL; ``_mla_row_split`` reads which stage the rows' differences
    come from), and a bf16 forward: the card's own routing on at least
    ROUTE_AGREE of the tokens of every MoE layer the CPU's, every token
    that differs a near-tie of the CPU's router (margin under ROUTE_TIE),
    and the logits within ATOL_BF16 with the card routed as the CPU."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import LM, blocks, moe
    from repro_torch.models.model import map_tree

    cfg = get_smoke_config(arch)
    model = LM(cfg)
    to_dev = lambda tree: map_tree(lambda t: t.to(dev), tree)  # noqa: E731
    g = torch.Generator().manual_seed(2)
    spec = next(s for s in model.specs if s.moe)
    p = blocks.init_layer(cfg, spec, g)
    x = torch.randn((256, cfg.d_model), generator=g)
    # expert 0 favoured, so its queue overflows: drops on both sides
    p["ffn"]["router"][0, 0] = 4.0
    x[:, 0] += 1.5
    mspec = blocks.moe_spec(cfg)
    y_cpu, aux_cpu = moe.moe_ffn(p["ffn"], x, mspec)
    y, aux = moe.moe_ffn(to_dev(p["ffn"]), x.to(dev), mspec)
    r_cpu = moe.route(p["ffn"], x, mspec)
    r = moe.route(to_dev(p["ffn"]), x.to(dev), mspec)
    res = dict(arch=arch, routing_equal=bool(
        torch.equal(r.topi.cpu(), r_cpu.topi)
        and torch.equal(r.keep.cpu(), r_cpu.keep)),
        dropped=int((~r_cpu.keep).sum()),
        moe_y_max_abs_diff=float((y.cpu() - y_cpu).abs().max()),
        moe_aux_diff=abs(float(aux) - float(aux_cpu)))
    ok = (res["routing_equal"] and res["moe_y_max_abs_diff"] <= MOE_ATOL_F32
          and res["moe_aux_diff"] <= MOE_ATOL_F32)
    if cfg.mla is not None:
        B, C, pos = 3, 16, 5
        m = cfg.mla
        cache = blocks.init_layer_cache(cfg, spec, B, C, torch.float32,
                                        device="cpu")
        cache["ckv"][:, :pos] = torch.randn((B, pos, m.kv_lora), generator=g)
        cache["kr"][:, :pos] = torch.randn((B, pos, m.rope_head_dim),
                                           generator=g)
        cache["pos"][:pos] = torch.arange(pos, dtype=torch.int32)
        xd = torch.randn((B, 1, cfg.d_model), generator=g)
        cache_d = {k: v.to(dev) for k, v in cache.items()}
        want = blocks._mla_decode(cfg, p, xd, cache, pos)
        got = blocks._mla_decode(cfg, to_dev(p), xd.to(dev), cache_d, pos)
        res["mla_out_max_abs_diff"] = float((got.cpu() - want).abs().max())
        ok &= res["mla_out_max_abs_diff"] <= MLA_ATOL
        for k in ("ckv", "kr"):
            a, b = cache_d[k].cpu(), cache[k]
            new = (a[:, pos] - b[:, pos]).abs()
            res[f"{k}_new_row_max_abs_diff"] = float(new.max())
            res[f"{k}_new_row_values_differ"] = [
                int((a[:, pos] != b[:, pos]).sum()), b[:, pos].numel()]
            ok &= (torch.equal(a[:, :pos], b[:, :pos])
                   and torch.equal(a[:, pos + 1:], b[:, pos + 1:])
                   and float(new.max()) <= MLA_CACHE_RTOL
                   * float(b.abs().max()))
        ok &= torch.equal(cache_d["pos"].cpu(), cache["pos"])
        res["mla_row_split"] = _mla_row_split(torch, dev, cfg, p, xd, pos)
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(4))
    runs = []
    for where, pp, force in (("cpu", params, None),
                             (dev, to_dev(params), None),
                             (dev, to_dev(params), "cpu")):
        log, restore = _moe_routing_log(moe)
        top_k = moe.top_k
        if force:                     # the card routed as the CPU routed
            forced = iter([c["topi"].to(dev) for c in runs[0][2]])

            def routed_as_cpu(probs, k):
                idx = next(forced)
                return torch.gather(probs, -1, idx), idx

            moe.top_k = routed_as_cpu
        try:
            lg, a = model.logits(pp, toks.to(where))
        finally:
            restore()
            moe.top_k = top_k
        runs.append((lg.cpu(), float(a), log))
    (want, aux_cpu, log_cpu), (_, _, log_dev), (got, aux_dev, _) = runs
    flips = _route_flips(log_cpu, log_dev)
    err = float((got - want).abs().max())
    bound = ATOL_BF16 * float(want.abs().max())
    res.update(routing_agreement_by_layer=[f[0] for f in flips],
               flip_margins_by_layer=[f[1] for f in flips],
               logits_max_abs_diff_routed_as_cpu=err, logits_bound=bound,
               aux_cpu=aux_cpu, aux_card=aux_dev, device=smi)
    ok &= (err <= bound and abs(aux_dev - aux_cpu) <= 1e-4 and aux_dev > 0
           and all(share >= ROUTE_AGREE and all(m < ROUTE_TIE for m in mg)
                   for share, mg in flips))
    emit("moe_mla", what="card vs CPU at SMOKE", ok=bool(ok), **res)
    if not ok:
        raise AssertionError(f"{arch}: card and CPU differ: {res}")
    return res


#: the dispatchers (``kernels.ops``) of the exchange's kernels -> the
#: kernel each launches on a CUDA tensor
MOE_HELD = {"encode_fused": "encode_fused", "qdq_fused": "qdq_fused",
            "encode_bingrad": "encode_bingrad_fused",
            "decode_fused_mean": "decode_fused_mean",
            "decode_fused_each": "decode_fused_each"}


def _record_ops(torch, calls):
    """Record every call of MOE_HELD's dispatchers as (name, args, kwargs),
    its tensors cloned (the exchange reuses its buffers); returns the
    restore."""
    from repro_torch.kernels import ops

    origs = {n: getattr(ops, n) for n in MOE_HELD}

    def recorder(name, orig):
        def rec(*args, **kw):
            calls.append((name, tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args), dict(kw)))
            return orig(*args, **kw)
        return rec

    for n, f in origs.items():
        setattr(ops, n, recorder(n, f))
    return lambda: [setattr(ops, n, f) for n, f in origs.items()]


def _check_recorded(calls, before, what):
    """The calls ``_record_ops`` recorded since the counters read
    ``before`` are exactly the kernel launches since then."""
    step = {k: n - before[k] for k, n in _read_counters().items()}
    seen = {k: sum(c[0] == op for c in calls) for op, k in MOE_HELD.items()}
    if any(seen[k] != step[k] for k in seen) or any(
            n for k, n in step.items() if k not in seen):
        raise AssertionError(f"{what}: recorded {seen}, launched {step}")


def _hold_exchange_calls(torch, arch, quant, calls, smi, phase="moe_mla",
                         brief=False):
    """The recorded kernel calls of one training step, each kernel against
    its plain version on the same inputs, by the rules of phase 3:
    ``encode_fused``'s words and both decodes equal by value, ``qdq_fused``
    bit for bit; ``encode_bingrad_fused``'s levels bit-equal to
    ``kernel_order_levels``, within LEVEL_RTOL of the plain fit's (at most
    FLIP_SHARE of the rows beyond it, none beyond FLIP_RTOL), its words
    the exact threshold of its own levels. ``brief``: the line counts the
    calls of each kernel and shape instead of listing them."""
    from repro_torch.kernels import fused_bingrad as fb
    from repro_torch.kernels import fused_decode as fd
    from repro_torch.kernels import fused_encode as fe

    rows, failed = [], []
    for name, args, kw in calls:
        row = dict(call=name, shape=list(args[0].shape))
        if name in ("encode_fused", "qdq_fused"):
            v, lv, rb, mask = args
            lim = fe.clip_limit(v, mask, kw.get("clip_c"))
            a = (v, lv, rb, mask, lim)
            if name == "encode_fused":
                k = dict(bits=kw["bits"], mode=kw.get("mode", "rr"))
                row.update(valid=int(mask.sum()) if mask is not None
                           else v.numel(), **k)
                bad = _mismatch(torch, fe.encode_fused_cuda(*a, **k),
                                fe.encode_fused_plain(*a, **k))
            else:
                k = dict(mode=kw.get("mode", "rr"))
                got = fe.qdq_fused_cuda(*a, **k).view(torch.int32)
                bad = _mismatch(torch, got, fe.qdq_fused_plain(*a, **k)
                                .view(torch.int32))
            row["mismatched"] = bad
        elif name == "encode_bingrad":
            v, mask = args
            lim = fe.clip_limit(v, mask, kw.get("clip_c"))
            li = kw.get("lloyd_iters", 0)
            words, lv = fb.encode_bingrad_fused_cuda(v, mask, lim,
                                                     lloyd_iters=li)
            _, want_l = fb.encode_bingrad_fused_plain(v, mask, lim,
                                                      lloyd_iters=li)
            order = fb.kernel_order_levels(v, mask, lim, lloyd_iters=li)
            own = fe.encode_fused_plain(v, lv, None, mask, lim, bits=1,
                                        mode="bin")
            diff = (lv - want_l).abs()
            vmax = float((v.abs() * mask).max() if mask is not None
                         else v.abs().max())
            far = int((diff > LEVEL_RTOL * vmax).any(dim=1).sum())
            row.update(levels_equal_kernel_order=torch.equal(
                lv.view(torch.int32), order.view(torch.int32)),
                level_err=float(diff.max()), level_tol=LEVEL_RTOL * vmax,
                level_rows_beyond_tol=far,
                words_vs_own_threshold=_mismatch(torch, words, own))
            bad = int(not (row["levels_equal_kernel_order"]
                           and far <= FLIP_SHARE * v.shape[0]
                           and row["level_err"] <= FLIP_RTOL * vmax
                           and row["words_vs_own_threshold"] == 0))
        else:
            words, lv, d = args
            k = dict(d=d, bits=kw["bits"])
            cuda, plain = ((fd.decode_fused_mean_cuda,
                            fd.decode_fused_mean_plain)
                           if name == "decode_fused_mean" else
                           (fd.decode_fused_each_cuda,
                            fd.decode_fused_each_plain))
            row.update(d=d, bits=kw["bits"])
            bad = row["mismatched"] = _mismatch(
                torch, cuda(words, lv, **k), plain(words, lv, **k))
        rows.append(row)
        if bad:
            failed.append(row)
    if brief:
        groups = {}
        for row in rows:
            g = groups.setdefault((row["call"], tuple(row["shape"])), dict(
                call=row["call"], shape=row["shape"], calls=0, failed=0))
            g["calls"] += 1
            g["failed"] += row in failed
        rows = list(groups.values())
    emit(phase, what="train step's kernel calls vs plain", arch=arch,
         quant=quant, calls=rows, device=smi)
    if failed:
        raise AssertionError(f"train {arch} {quant}: kernels disagree with "
                             f"their plain versions: {failed}")
    return rows


def _moe_train(torch, arch, smi, phase="moe_mla"):
    """``launch.train --arch <arch> --smoke``, orq-9 and BinGrad-b, 2
    steps then 1 with error feedback, on a world of one: finite losses,
    aux > 0 where the model has MoE layers (0 where it has none), 4
    collective launches a step, the fused path's kernel launches, wire
    bytes per worker equal to ``policy_stats`` on the model's path sizes.
    Every kernel call of the EF step (encodes, qdq, decodes) is recorded
    and held against its plain version."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.comm.exchange import policy_stats
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.launch import train as launcher
    from repro_torch.models import LM

    model = LM(get_smoke_config(arch))
    sizes = _path_sizes(model)
    has_moe = any(s.moe for s in model.specs)
    total = {}
    for quant, expect in MOE_TRAIN_EXPECT.items():
        wire = policy_stats(QuantPolicy.parse(quant, bucket_size=512),
                            sizes, 1)[1]
        _zero_counters()
        rows, calls = [], []
        for extra in (["--steps", "2"], ["--steps", "1",
                                         "--error-feedback"]):
            args = ["--arch", arch, "--quant", quant, *MOE_TRAIN_ARGS,
                    *extra]
            if "--error-feedback" not in extra:
                r = launcher.train(args)
            else:
                before = _read_counters()
                restore = _record_ops(torch, calls)
                try:
                    r = launcher.train(args)
                finally:
                    restore()
                _check_recorded(calls, before, f"train {arch} {quant}")
            rows.append(dict(args=" ".join(args),
                             losses=[h["loss"] for h in r["history"]],
                             aux=[h["aux"] for h in r["history"]],
                             step_s=r["step_s"], n_params=r["n_params"],
                             wire_bytes_per_worker=r[
                                 "wire_bytes_per_worker"],
                             collective_launches_per_step=r[
                                 "collective_launches_per_step"],
                             replicas_in_sync=r["replicas_in_sync"]))
        launches = _read_counters()
        want = _expect(expect)
        emit(phase, what="train --smoke", arch=arch, quant=quant,
             runs=rows, launches=launches, expected_launches=want,
             wire_expected=wire, device=smi)
        for row in rows:
            if (not all(x == x and abs(x) < float("inf")
                        for x in row["losses"])
                    or not all((a > 0) if has_moe else (a == 0)
                               for a in row["aux"])
                    or row["collective_launches_per_step"] != 4
                    or row["wire_bytes_per_worker"] != wire
                    or not row["replicas_in_sync"]):
                raise AssertionError(f"train {arch} {quant}: {row}")
        if launches != want:
            raise AssertionError(f"train {arch} {quant}: launches "
                                 f"{launches} != {want}")
        _hold_exchange_calls(torch, arch, quant, calls, smi, phase)
        del calls
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def run_moe_mla(torch, dev):
    """Phase 21: mixtral-8x22b and deepseek-v2-236b served at full width
    on the dense path, the card against the CPU at their smoke sizes, and
    their smoke training through the ported exchange's kernels."""
    smi = nvidia_smi()
    total = {k: 0 for k in _counters()}
    for arch, layers in MOE_ARCHS.items():
        _moe_serve(torch, dev, arch, layers, smi)
        _moe_card_vs_cpu(torch, dev, arch, smi)
        for k, v in _moe_train(torch, arch, smi).items():
            total[k] += v
    return total


# ---------------------------------------------------------------------------
# phase 22: Mamba (jamba-v0.1-52b) and RWKV-6 (rwkv6-3b)
# ---------------------------------------------------------------------------

#: full-width parameters, ``init_cache(8, 128)`` bytes, the dense path's
#: bytes a sequence of one recurrent layer and a token of one attention
#: layer, and the parameters of the one-layer training cut
RECURRENT = {
    "jamba-v0.1-52b": dict(n_params=4_358_066_176, cache=145_229_824,
                           state=573_440, token=4096,
                           train_params=642_187_264),
    "rwkv6-3b": dict(n_params=3_099_609_600, cache=170_393_600,
                     state=665_600, token=0, train_params=421_923_840)}
REC_ATOL_F32 = 1e-5
#: a head whose group-norm input variance is under 10 x eps at some token
#: turns its output around on a 1-ulp difference (tests/test_torch_rwkv.py)
GN_COND = 1e-4
REC_TRAIN_BATCH, REC_TRAIN_SEQ, REC_TRAIN_REPS = 8, 128, 3


def _recurrent_serve(torch, dev, arch, smi):
    """One arch at full width and full depth on the dense path through the
    serving launcher's ``_serve_dense``: MOE_BATCH prompts of MOE_PROMPT
    tokens prefilled token by token (the launcher falls back from the
    chunk it is given, as the reference's does), then MOE_GEN - 1 decode
    steps. The cache must read the reference's ``init_cache(8, 128)``
    bytes; counters zeroed just before must read 0."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import LM
    from repro_torch.models.model import map_tree
    from repro_torch.utils.pytree import tree_leaves

    want = RECURRENT[arch]
    cfg = get_config(arch)
    model = LM(cfg)
    ap = model.abstract_params()
    n_params = sum(t.numel() for t in tree_leaves(ap))
    biggest = max(t.numel() for t in tree_leaves(ap))
    # the f32 draw, one leaf's stacking copy, then the bf16 copy beside it
    reckoned = 4 * n_params + 4 * biggest + 2 * n_params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    params = map_tree(lambda t: t.to(torch.bfloat16), params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    args = launcher.parse_args([
        "--arch", arch, "--batch", str(MOE_BATCH), "--prompt-len",
        str(MOE_PROMPT), "--gen", str(MOE_GEN), "--max-len",
        str(MOE_MAX_LEN), "--prefill-chunk", str(MOE_PROMPT)])
    prompt = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT),
                           generator=torch.Generator().manual_seed(1)
                           ).numpy().astype("int32")
    _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    r = launcher._serve_dense(args, model, params, prompt, dev)
    launches = _read_counters()
    serve_peak = torch.cuda.max_memory_allocated() - base
    embed_bytes = 2 * cfg.vocab_size * cfg.d_model
    kinds = [s.kind for s in model.specs]
    row = dict(arch=arch, layers=cfg.num_layers,
               layer_kinds={k: kinds.count(k) for k in sorted(set(kinds))},
               # the reference's MoE flag falls on layers with no FFN
               moe_layers_run=sum(s.moe and s.kind in ("attn", "attn_local")
                                  for s in model.specs),
               n_params=n_params, bf16_weight_bytes=2 * n_params,
               d_model=cfg.d_model, init_s=init_s,
               init_peak_bytes=init_peak,
               init_peak_reckoned_bytes=reckoned,
               serve_peak_above_start=serve_peak,
               prefill_chunk=r["prefill_chunk"],
               prefill_tokens=r["prefill_tokens"], prefill_s=r["prefill_s"],
               prefill_tok_s=r["prefill_tok_s"],
               decode_tokens=r["decode_tokens"],
               decode_step_p50_ms=r["step_p50_ms"],
               decode_step_p99_ms=r["step_p99_ms"],
               decode_tok_s=r["decode_tok_s"],
               weights_read_less_embed_ms=(2 * n_params - embed_bytes)
               / HBM_BYTES_PER_S * 1e3,
               token_bytes=r["token_bytes"], state_bytes=r["state_bytes"],
               cache_bytes=r["cache_bytes"],
               cache_bytes_expected=want["cache"], launches=launches,
               tokens_sha256=r["sha256"], device=smi)
    emit("recurrent", what="serve, dense path, full width and depth", **row)
    toks = r["tokens"]
    if any(launches.values()):
        raise AssertionError(f"{arch} dense serve launched kernels "
                             f"{launches}")
    if toks.shape != (MOE_BATCH, MOE_GEN) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{arch}: bad tokens {toks.shape}")
    if (n_params != want["n_params"] or r["prefill_chunk"] != 0
            or r["cache_bytes"] != want["cache"]
            or r["state_bytes"] != want["state"]
            or r["token_bytes"] != want["token"]):
        raise AssertionError(f"{arch}: serve accounting {row}")
    del params, r
    torch.cuda.empty_cache()
    return row


def _off_init(torch, p, g, limit):
    """The layer's small leaves (norm scales, biases, mixes, decays) moved
    off their constant init by N(0, 0.1^2), so that every term acts."""
    for n, t in p.items():
        if not isinstance(t, dict) and t.numel() <= limit:
            p[n] = t + 0.1 * torch.randn(t.shape, generator=g)
    return p


def _recurrent_f32_errors(torch, dev, cfg, spec, p, g):
    """The layer's functions in float32 at the smoke size, card against
    CPU on the same inputs -> {what: largest |difference| over the CPU's
    largest magnitude}; decode shifts must be bit-equal (-1 if not)."""
    from repro_torch.models import blocks, rwkv, ssm
    from repro_torch.models.model import map_tree

    to_dev = lambda tree: map_tree(lambda t: t.to(dev), tree)  # noqa: E731

    def err(got, want):
        return float((got.cpu() - want).abs().max() / want.abs().max())

    D, out = cfg.d_model, {}
    if spec.kind == "mamba":
        pm = {k: v for k, v in p.items() if k != "norm"}
        pd, ms = to_dev(pm), blocks.mamba_spec(cfg)
        for S in (64, 300):
            x = torch.randn((2, S, D), generator=g)
            out[f"mamba_forward_S{S}"] = err(
                ssm.mamba_forward(pd, x.to(dev), ms),
                ssm.mamba_forward(pm, x, ms))
        x = torch.randn((3, 12, D), generator=g)
        st = ssm.init_mamba_state(3, ms, torch.float32, device="cpu")
        sd = ssm.init_mamba_state(3, ms, torch.float32, device=dev)
        worst = 0.0
        for i in range(12):
            want, st = ssm.mamba_decode_step(pm, x[:, i:i + 1], st, ms)
            got, sd = ssm.mamba_decode_step(pd, x[:, i:i + 1].to(dev), sd,
                                            ms)
            worst = max(worst, err(got, want))
        out.update(mamba_decode_chain12_out=worst,
                   mamba_decode_ssm=err(sd["ssm"], st["ssm"]),
                   mamba_decode_conv=err(sd["conv"], st["conv"]))
        return out
    rs = blocks.rwkv_spec(cfg)
    pd = to_dev(p)
    B, S, H, hd = 2, 128, rs.num_heads, rs.head_dim
    r, k, v = (torch.randn((B, S, H, hd), generator=g) for _ in range(3))
    logw = -torch.exp(torch.randn((B, S, H, hd), generator=g) - 1.0)
    s0 = torch.randn((B, H, hd, hd), generator=g)
    want = rwkv._wkv_scan(r, k, v, None, p["u"], rs.chunk, s0, logw=logw)
    got = rwkv._wkv_scan(*(t.to(dev) for t in (r, k, v)), None, pd["u"],
                         rs.chunk, s0.to(dev), logw=logw.to(dev))
    out.update(wkv_scan_out=err(got[0], want[0]),
               wkv_scan_state=err(got[1], want[1]))
    x = torch.randn((2, 64, D), generator=g)
    out["time_mix"] = err(rwkv.time_mix(pd, x.to(dev), rs),
                          rwkv.time_mix(p, x, rs))
    out["channel_mix_train"] = err(rwkv.channel_mix_train(pd, x.to(dev)),
                                   rwkv.channel_mix_train(p, x))
    xt, ht, tsh, csh = (torch.randn((3, 1, D), generator=g)
                        for _ in range(4))
    wkv = torch.randn((3, H, hd, hd), generator=g)
    tw, tws = rwkv.time_mix_decode(p, xt, {"wkv": wkv, "shift": tsh[:, 0]},
                                   rs)
    tg, tgs = rwkv.time_mix_decode(pd, xt.to(dev), {
        "wkv": wkv.to(dev), "shift": tsh[:, 0].to(dev)}, rs)
    cw, cws = rwkv.channel_mix_decode(p, ht, {"shift": csh[:, 0]})
    cg, cgs = rwkv.channel_mix_decode(pd, ht.to(dev),
                                      {"shift": csh[:, 0].to(dev)})
    out.update(decode_time_mix=err(tg, tw), decode_wkv=err(tgs["wkv"],
                                                           tws["wkv"]),
               decode_channel_mix=err(cg, cw))
    if not (torch.equal(tgs["shift"].cpu(), tws["shift"])
            and torch.equal(cgs["shift"].cpu(), cws["shift"])):
        out["decode_shifts_bit_equal"] = -1.0
    return out


def _group_norm_log(rwkv):
    """Record every ``rwkv._group_norm`` call's smallest per-head
    variance of its input, (B, S), on its device; returns (log,
    restore)."""
    log, orig = [], rwkv._group_norm

    def rec(x, scale, n_heads, eps=1e-5):
        B, S, _ = x.shape
        xh = x.reshape(B, S, n_heads, -1).float()
        log.append(((xh - xh.mean(-1, keepdim=True)) ** 2).mean(-1)
                   .min(-1).values.detach())
        return orig(x, scale, n_heads, eps)

    rwkv._group_norm = rec
    return log, lambda: setattr(rwkv, "_group_norm", orig)


def _recurrent_card_vs_cpu(torch, dev, arch, smi):
    """At the ``SMOKE`` sizes: the recurrent layer's functions in float32
    (``_recurrent_f32_errors``, each within REC_ATOL_F32), then a bf16
    forward of the model, card against CPU: jamba's MoE layer routed as
    the CPU routed it (its own routing's agreement printed, every flip a
    near-tie), rwkv6's logits held on the tokens the CPU's group norms
    leave well-conditioned (GN_COND, as tests/test_torch_rwkv.py), all
    within ATOL_BF16 of the CPU's largest logit."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import LM, blocks, moe, rwkv
    from repro_torch.models.model import map_tree

    cfg = get_smoke_config(arch)
    model = LM(cfg)
    g = torch.Generator().manual_seed(5)
    spec = next(s for s in model.specs if s.kind in ("mamba", "rwkv"))
    p = _off_init(torch, blocks.init_layer(cfg, spec, g), g,
                  8 * cfg.d_model * 2)
    errs = _recurrent_f32_errors(torch, dev, cfg, spec, p, g)
    ok = all(0 <= e <= REC_ATOL_F32 for e in errs.values())
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    pd = map_tree(lambda t: t.to(dev), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(4))
    n_moe = sum(s.moe for s in model.specs)
    runs = []
    for where, pp, force in (("cpu", params, False), (dev, pd, False),
                             (dev, pd, True)):
        log, restore = _moe_routing_log(moe)
        gn_log, gn_restore = _group_norm_log(rwkv)
        top_k = moe.top_k
        if force and n_moe:           # the card routed as the CPU routed
            forced = iter([c["topi"].to(dev) for c in runs[0][1]])

            def routed_as_cpu(probs, k):
                idx = next(forced)
                return torch.gather(probs, -1, idx), idx

            moe.top_k = routed_as_cpu
        try:
            lg, _ = model.logits(pp, toks.to(where))
        finally:
            restore()
            gn_restore()
            moe.top_k = top_k
        runs.append((lg.float().cpu(), log, [v.cpu() for v in gn_log]))
    (want, log_cpu, gn_cpu), (own, log_dev, _), (got, _, _) = runs
    B, S = toks.shape
    keep = torch.ones((B, S), dtype=torch.bool)
    for i, var in enumerate(gn_cpu):
        for b, t in (var < GN_COND).nonzero().tolist():
            keep[b, t:t + 2 if i == len(gn_cpu) - 1 else S] = False
    flips = _route_flips(log_cpu, log_dev) if n_moe else []
    bound = ATOL_BF16 * float(want.abs().max())
    err = float((got - want)[keep].abs().max())
    errs.update(bf16_logits_max_abs_diff=err, bf16_logits_bound=bound,
                bf16_own_routing_max_abs_diff=float(
                    (own - want)[keep].abs().max()),
                tokens_held=int(keep.sum()), tokens=keep.numel(),
                routing_agreement_by_layer=[f[0] for f in flips],
                flip_margins_by_layer=[f[1] for f in flips],
                group_norm_min_var_by_layer=[float(v.min()) for v in gn_cpu])
    ok &= (err <= bound and bool(torch.isfinite(got).all())
           and keep.float().mean() >= 0.95
           and all(share >= ROUTE_AGREE and all(m < ROUTE_TIE for m in mg)
                   for share, mg in flips))
    emit("recurrent", what="card vs CPU at SMOKE", arch=arch, ok=bool(ok),
         atol_f32=REC_ATOL_F32, **errs, device=smi)
    if not ok:
        raise AssertionError(f"{arch}: card and CPU differ: {errs}")
    return errs


def _recurrent_train_full(torch, dev, arch, smi):
    """One full-width training forward + backward of ``LM.loss``, depth
    cut to its first layer (jamba: one Mamba layer, rwkv6: one RWKV
    layer), batch REC_TRAIN_BATCH x REC_TRAIN_SEQ, bf16 compute, no
    exchange: ms per step (CUDA-synchronised wall clock, the median of
    REC_TRAIN_REPS after a warm-up) and the step's own peak above the
    f32 params; the loss and every gradient finite."""
    from repro_torch.configs.base import cut_depth, get_config
    from repro_torch.models import LM
    from repro_torch.utils.pytree import tree_leaves

    cfg = cut_depth(get_config(arch), 1)
    model = LM(cfg)
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    n_params = sum(t.numel() for t in leaves)
    toks = torch.randint(0, cfg.vocab_size, (REC_TRAIN_BATCH, REC_TRAIN_SEQ),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)

    def step():
        loss, _ = model.loss(params, {"tokens": toks})
        return loss, torch.autograd.grad(loss, leaves)

    loss, grads = step()
    finite = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    del grads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(REC_TRAIN_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del grads
    peak = torch.cuda.max_memory_allocated() - base
    row = dict(arch=arch, layers=1, layer_kind=model.specs[0].kind,
               n_params=n_params, batch=REC_TRAIN_BATCH, seq=REC_TRAIN_SEQ,
               loss=float(loss.detach()), finite=finite,
               step_ms=statistics.median(times), step_ms_all=times,
               step_peak_above_params=peak, params_f32_bytes=4 * n_params,
               device=smi)
    emit("recurrent", what="train forward + backward, full width, 1 layer",
         **row)
    if not finite or n_params != RECURRENT[arch]["train_params"]:
        raise AssertionError(f"{arch} full-width training step: {row}")
    del params, leaves, loss
    torch.cuda.empty_cache()
    return row


def run_recurrent(torch, dev):
    """Phase 22: jamba-v0.1-52b and rwkv6-3b served at full width and full
    depth on the dense path, the card against the CPU at their smoke
    sizes, their smoke training through the ported exchange's kernels
    and one full-width one-layer training step each."""
    smi = nvidia_smi()
    total = {k: 0 for k in _counters()}
    for arch in RECURRENT:
        _recurrent_serve(torch, dev, arch, smi)
        _recurrent_card_vs_cpu(torch, dev, arch, smi)
        for k, v in _moe_train(torch, arch, smi, "recurrent").items():
            total[k] += v
        _recurrent_train_full(torch, dev, arch, smi)
    return total


# ---------------------------------------------------------------------------
# phase 23: whisper-base (encoder, cross-attention, layer norm)
# ---------------------------------------------------------------------------

WHISPER = "whisper-base"
#: full width and depth: parameters, ``init_cache(8, 128)`` bytes, the
#: cross K/V bytes a sequence and decoder layer, the bytes a token of a
#: decoder layer's self-attention
WHISPER_FULL = dict(n_params=97_981_440, cache=160_041_984,
                    cross=3_072_000, token=2048)
#: wire bytes a worker and step at L = 1: the smoke model at bucket 512,
#: the full model at bucket 2048
WHISPER_WIRE = {"smoke": {"orq-9": 266_888, "bingrad-b": 65_808},
                "full": {"orq-9": 101_427_160, "bingrad-b": 25_261_104}}
WHISPER_TRAIN = {"smoke": dict(bucket=512, batch=8, seq=64),
                 "full": dict(bucket=2048, batch=8, seq=128)}
WHISPER_ATOL_F32 = 1e-5
WHISPER_GRAD_REL = 2e-2


def _whisper_serve(torch, dev, smi):
    """(a) whisper-base at full width and depth on the dense path through
    the serving launcher's ``_serve_dense``: the encoder's ``warm_cache``
    on the launcher's frame embeddings (seed + 2) before the clock, then
    MOE_BATCH prompts of MOE_PROMPT tokens in one chunk and MOE_GEN - 1
    decode steps. The cache must read the reference's ``init_cache(8,
    128)`` bytes; counters zeroed just before must read 0."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import LM
    from repro_torch.models.model import map_tree
    from repro_torch.utils.pytree import tree_leaves

    cfg = get_config(WHISPER)
    model = LM(cfg)
    n_params = sum(t.numel() for t in tree_leaves(model.abstract_params()))
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    params = map_tree(lambda t: t.to(torch.bfloat16), params)
    args = launcher.parse_args([
        "--arch", WHISPER, "--batch", str(MOE_BATCH), "--prompt-len",
        str(MOE_PROMPT), "--gen", str(MOE_GEN), "--max-len",
        str(MOE_MAX_LEN), "--prefill-chunk", str(MOE_PROMPT)])
    prompt = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT),
                           generator=torch.Generator().manual_seed(1)
                           ).numpy().astype("int32")
    torch.cuda.synchronize()
    _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    r = launcher._serve_dense(args, model, params, prompt, dev)
    launches = _read_counters()
    row = dict(arch=WHISPER, layers=cfg.num_layers,
               encoder_layers=cfg.encoder.num_layers,
               frames=cfg.encoder.num_frames, n_params=n_params,
               warm_cache_s=r["warm_cache_s"],
               prefill_chunk=r["prefill_chunk"],
               prefill_tokens=r["prefill_tokens"], prefill_s=r["prefill_s"],
               prefill_tok_s=r["prefill_tok_s"],
               decode_tokens=r["decode_tokens"],
               decode_step_p50_ms=r["step_p50_ms"],
               decode_step_p99_ms=r["step_p99_ms"],
               decode_tok_s=r["decode_tok_s"],
               serve_peak_above_start=torch.cuda.max_memory_allocated()
               - base,
               weights_read_less_embed_ms=2 * (n_params - cfg.vocab_size
                                               * cfg.d_model)
               / HBM_BYTES_PER_S * 1e3,
               token_bytes=r["token_bytes"], cross_bytes=r["cross_bytes"],
               cache_bytes=r["cache_bytes"],
               cache_bytes_expected=WHISPER_FULL["cache"],
               launches=launches, tokens_sha256=r["sha256"], device=smi)
    emit("whisper", what="(a) serve, dense path, full width and depth",
         **row)
    toks = r["tokens"]
    if any(launches.values()):
        raise AssertionError(f"whisper dense serve launched kernels "
                             f"{launches}")
    if toks.shape != (MOE_BATCH, MOE_GEN) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"whisper: bad tokens {toks.shape}")
    if (n_params != WHISPER_FULL["n_params"]
            or r["prefill_chunk"] != MOE_PROMPT
            or r["cache_bytes"] != WHISPER_FULL["cache"]
            or r["cross_bytes"] != WHISPER_FULL["cross"]
            or r["token_bytes"] != WHISPER_FULL["token"]
            or not r["warm_cache_s"] > 0):
        raise AssertionError(f"whisper: serve accounting {row}")
    del params, r
    torch.cuda.empty_cache()
    return row


def _whisper_card_vs_cpu(torch, dev, smi):
    """(b) At the smoke size, card against CPU on the same inputs: the
    layer functions in f32 (WHISPER_ATOL_F32 of the CPU's largest value),
    then the bf16 model: the encoder's output and the logits within
    ATOL_BF16, every gradient of the loss (the encoder's too) within
    WHISPER_GRAD_REL in relative norm, the warmed cross K/V and the
    served logits (one prefill chunk, 4 decode steps) within ATOL_BF16."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import LM, attention, layers
    from repro_torch.models.model import map_tree
    from repro_torch.utils.pytree import tree_leaves

    g = torch.Generator().manual_seed(23)
    to = lambda tree: map_tree(lambda t: t.to(dev), tree)  # noqa: E731

    def err(got, want):
        got, want = got.detach().float().cpu(), want.detach().float()
        return float((got - want).abs().max() / want.abs().max())

    errs = {}
    x = 3.0 + torch.randn((2, 7, 64), generator=g)
    sc, bi = 1 + 0.1 * torch.randn(64, generator=g), 0.1 * torch.randn(
        64, generator=g)
    errs["layer_norm_f32"] = err(layers.layer_norm(*to((x, sc, bi))),
                                 layers.layer_norm(x, sc, bi))
    mp = {"wi": torch.randn((64, 128), generator=g) / 8,
          "bi": 0.1 * torch.randn(128, generator=g),
          "wo": torch.randn((128, 64), generator=g) / 11,
          "bo": 0.1 * torch.randn(64, generator=g)}
    x = torch.randn((2, 16, 64), generator=g)
    errs["dense_mlp_f32"] = err(layers.dense_mlp(to(mp), x.to(dev)),
                                layers.dense_mlp(mp, x))
    for name, (S, T, causal, rope) in {"cross_ragged": (20, 75, False, False),
                                       "encoder_self": (75, 75, False, True)
                                       }.items():
        spec = attention.AttnSpec(num_heads=4, num_kv_heads=2, head_dim=16,
                                  causal=causal, use_rope=rope, q_chunk=32,
                                  kv_chunk=32)
        q = torch.randn((2, S, 4, 16), generator=g)
        k, v = (torch.randn((2, T, 2, 16), generator=g) for _ in range(2))
        errs[f"attention_{name}_f32"] = err(
            attention.chunked_attention(*to((q, k, v)), spec),
            attention.chunked_attention(q, k, v, spec))
    f32_ok = all(e <= WHISPER_ATOL_F32 for e in errs.values())

    cfg = get_smoke_config(WHISPER)
    model = LM(cfg)
    params = map_tree(lambda t: t if t.any() else 0.1 * torch.randn(
        t.shape, generator=g), model.init(g, device="cpu"))
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
    enc = 0.02 * torch.randn((2, cfg.encoder.num_frames, cfg.d_model),
                             generator=g)
    runs = {}
    for where in ("cpu", dev):
        p = map_tree(lambda t: t.to(where).requires_grad_(True), params)
        e, t = enc.to(where), toks.to(where)
        with torch.no_grad():
            enc_out = model.encode(p, e)
            lg, _ = model.logits(p, t, enc_embeds=e)
        loss, _ = model.loss(p, {"tokens": t, "enc_embeds": e})
        grads = torch.autograd.grad(loss, tree_leaves(p))
        pb = map_tree(lambda t: t.detach().to(torch.bfloat16), p)
        cache = model.warm_cache(pb, model.init_cache(2, 32, device=where),
                                 e.to(torch.bfloat16))
        warmed = [cache[0]["pos0"][k].clone() for k in ("xk", "xv")]
        slg, cache = model.prefill_chunk(pb, cache, t[:, :8], 0)
        served = [slg[:, -1]]
        for i in range(8, 12):
            slg, cache = model.decode_step(pb, cache, t[:, i:i + 1], i)
            served.append(slg[:, 0])
        runs[str(where)] = (enc_out, lg, float(loss.detach()), grads, warmed,
                            served)
    want, got = runs["cpu"], runs[str(dev)]
    errs.update(encode_bf16=err(got[0], want[0]),
                logits_bf16=err(got[1], want[1]),
                loss_rel=abs(got[2] - want[2]) / abs(want[2]),
                warm_xk_bf16=err(got[4][0], want[4][0]),
                warm_xv_bf16=err(got[4][1], want[4][1]),
                served_logits_bf16=max(err(a, b) for a, b in zip(got[5],
                                                                 want[5])))
    rels = [float((a.cpu() - b).norm() / max(float(b.norm()), 1e-30))
            for a, b in zip(got[3], want[3], strict=True)]
    errs["grad_rel_max"] = max(rels)
    bf16 = ("encode_bf16", "logits_bf16", "warm_xk_bf16", "warm_xv_bf16",
            "served_logits_bf16")
    ok = (f32_ok and all(errs[k] <= ATOL_BF16 for k in bf16)
          and errs["loss_rel"] <= 1e-3
          and errs["grad_rel_max"] <= WHISPER_GRAD_REL)
    emit("whisper", what="(b) card vs CPU at SMOKE", ok=bool(ok),
         atol_f32=WHISPER_ATOL_F32, atol_bf16=ATOL_BF16,
         grad_rel=WHISPER_GRAD_REL, **errs, device=smi)
    if not ok:
        raise AssertionError(f"whisper: card and CPU differ: {errs}")
    return errs


def _whisper_train(torch, dev, smi, size):
    """(c) / (d) ``make_train_step`` on the NCCL world of one, the batch
    ``{tokens, enc_embeds}``: the tokens the training launcher's
    ``SyntheticLM`` stream gives, the frames N(0, 0.02^2) drawn on the
    card. orq-9 and BinGrad-b, 2 steps then 1 with error feedback (a
    fresh state each): finite losses, 4 collective launches a step,
    ``policy_stats``' wire bytes (WHISPER_WIRE), the fused path's
    launches (MOE_TRAIN_EXPECT); every kernel call of the EF step held
    against its plain version. Step seconds (CUDA-synchronised) and each
    run's own peak above what was allocated before its state."""
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.core import prng
    from repro_torch.core.comm.exchange import policy_stats
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import TrainConfig, init_state, make_train_step

    cfg = (get_smoke_config if size == "smoke" else get_config)(WHISPER)
    shape = WHISPER_TRAIN[size]
    model = LM(cfg)
    sizes = _path_sizes(model)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=shape["seq"],
                       batch_size=shape["batch"], seed=0)
    enc = 0.02 * torch.randn(
        (shape["batch"], cfg.encoder.num_frames, cfg.d_model),
        generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    total = {}
    for quant, expect in MOE_TRAIN_EXPECT.items():
        policy = QuantPolicy.parse(quant, bucket_size=shape["bucket"])
        wire = policy_stats(policy, sizes, 1)[1]
        _zero_counters()
        rows, calls = [], []
        for steps, ef in ((2, False), (1, True)):
            tcfg = TrainConfig(policy=policy, error_feedback=ef)
            fn = make_train_step(model, tcfg, constant_lr(0.05))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            state = init_state(model, tcfg, seed=0, device=dev, step=fn)
            key = prng.key(0, device=dev)
            before = _read_counters()
            restore = _record_ops(torch, calls) if ef else (lambda: None)
            losses, step_s = [], []
            try:
                for i in range(steps):
                    batch = {"tokens": data.batch(i, device=dev)["tokens"],
                             "enc_embeds": enc}
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = fn(state, batch, key)
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t0)
                    losses.append(float(m["loss"]))
            finally:
                restore()
            peak = torch.cuda.max_memory_allocated() - base
            if ef:
                _check_recorded(calls, before, f"train whisper {quant}")
            n_coll, wbytes = fn.launches_and_bytes(1)
            rows.append(dict(steps=steps, error_feedback=ef, losses=losses,
                             step_s=step_s,
                             step_p50_ms=statistics.median(step_s) * 1e3,
                             peak_mem_above_start=peak,
                             collective_launches_per_step=n_coll,
                             wire_bytes_per_worker=wbytes))
            del state
        launches = _read_counters()
        want = _expect(expect)
        emit("whisper", what=f"({'c' if size == 'smoke' else 'd'}) train "
             f"{size}, make_train_step with enc_embeds", arch=WHISPER,
             quant=quant, bucket=shape["bucket"], batch=shape["batch"],
             seq=shape["seq"], frames=cfg.encoder.num_frames,
             n_params=sum(n for _, n in sizes), runs=rows, launches=launches,
             expected_launches=want, wire_expected=wire,
             wire_asserted=WHISPER_WIRE[size][quant], device=smi)
        for row in rows:
            if (not all(x == x and abs(x) < float("inf")
                        for x in row["losses"])
                    or row["collective_launches_per_step"] != 4
                    or row["wire_bytes_per_worker"] != wire
                    or wire != WHISPER_WIRE[size][quant]):
                raise AssertionError(f"train whisper {size} {quant}: {row}")
        if launches != want:
            raise AssertionError(f"train whisper {size} {quant}: launches "
                                 f"{launches} != {want}")
        _hold_exchange_calls(torch, f"{WHISPER} {size}", quant, calls, smi,
                             "whisper")
        del calls
        torch.cuda.empty_cache()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def run_whisper(torch, dev):
    """Phase 23: whisper-base served at full width and depth on the dense
    path, the card against the CPU at its smoke size, and its training
    through ``make_train_step`` with frame embeddings in the batch on the
    NCCL world of one, at the smoke size and at published widths."""
    smi = nvidia_smi()
    _whisper_serve(torch, dev, smi)
    _whisper_card_vs_cpu(torch, dev, smi)
    dist = start_world(torch)
    total = {k: 0 for k in _counters()}
    try:
        for size in ("smoke", "full"):
            for k, v in _whisper_train(torch, dev, smi, size).items():
                total[k] += v
    finally:
        dist.destroy_process_group()
    return total


MP_TRAIN = [("orq-9", [["--steps", "2"], ["--steps", "1",
                                            "--error-feedback"]]),
            ("bingrad-b", [["--steps", "2"]]),
            ("orq-9 fsdp", [["--steps", "2", "--mode", "fsdp"]])]
#: each process's launches: 2 + 1 EF replicated orq-9 steps, 2 BinGrad-b
#: steps (L = 1: the fused exchange of the gathered gradient), 2 per-leaf
#: fsdp steps (one reduce-scatter of each gather call's TP block)
MP_EXPECT = {"orq-9": {"encode_fused": 6, "decode_fused_mean": 3,
                       "decode_fused_each": 3, "qdq_fused": 1},
             "bingrad-b": {"encode_bingrad_fused": 4,
                           "decode_fused_mean": 2, "decode_fused_each": 2},
             "orq-9 fsdp": {"encode_fused": 222, "decode_fused_mean": 222}}
MP_WIRE = {"orq-9": TRAIN_WIRE_BYTES, "bingrad-b": 34_878_624}
MP_SERVE = dict(batch=8, max_len=512, prompt=64, steps=8, seq_steps=8)
MP_MARGIN = 2 * 0.06          # the dense decode's bf16 noise bound
MP_ATOL = 0.25                # full width, 12 layers of bf16 parts
MP_TIMEOUT_S = 600


def _mp_train(torch, mesh, smi, rank):
    """(b), (c): the launcher on the 1 x 2 mesh, every kernel call of each
    run recorded at its dispatcher and held against its plain version
    (phase 21's rules) -> the launches of every run."""
    from repro_torch.launch import train as launcher

    total = {}
    for quant, runs in MP_TRAIN:
        calls = []
        _zero_counters()
        before = _read_counters()
        rows = []
        restore = _record_ops(torch, calls)
        try:
            for extra in runs:
                args = list(TRAIN_ARGS) + ["--model-parallel", "2", *extra]
                args[args.index("--quant") + 1] = quant.split()[0]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                r = launcher.train(args, mesh=mesh)
                peak = torch.cuda.max_memory_allocated() - base
                losses = [h["loss"] for h in r["history"]]
                rows.append(dict(
                    args=" ".join(args), losses=losses, step_s=r["step_s"],
                    step_p50_ms=statistics.median(r["step_s"]) * 1e3,
                    wire_bytes_per_worker=r["wire_bytes_per_worker"],
                    dp_collectives_per_step=r[
                        "collective_launches_per_step"],
                    model_collectives_per_step=r[
                        "model_collectives_per_step"],
                    params_sha256=r["params_sha256"],
                    replicas_in_sync=r["replicas_in_sync"],
                    peak_mem_above_start=peak))
                if not all(x == x and abs(x) < float("inf")
                           for x in losses) or not r["replicas_in_sync"]:
                    raise AssertionError(f"model_parallel {quant}: {rows}")
                want_wire = MP_WIRE.get(quant)
                if want_wire is not None and \
                        r["wire_bytes_per_worker"] != want_wire:
                    raise AssertionError(
                        f"model_parallel {quant}: wire bytes "
                        f"{r['wire_bytes_per_worker']} != {want_wire}")
        finally:
            restore()
        _check_recorded(calls, before, f"model_parallel {quant}")
        launches = _read_counters()
        want = _expect(MP_EXPECT[quant])
        emit("model_parallel", rank=rank, what=f"train {quant}", runs=rows,
             launches=launches, expected_launches=want,
             note="the model group is gloo through the host: these step "
                  "times are not tensor-parallel speed", device=smi)
        if launches != want:
            raise AssertionError(f"model_parallel {quant}: launches "
                                 f"{launches} != {want}")
        _hold_exchange_calls(torch, "lm-100m", quant, calls, smi,
                             phase="model_parallel", brief=True)
        del calls
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def _mp_decode(torch, dev, mesh, smi, rank):
    """(d): the sharded dense decode at full width, batch 8 over the dp
    axis (of one) with the slots over ``model``, then ``seq_sharded``
    with batch 1: greedy tokens, p50, held on rank 0 against the same
    card's world of one fed the same tokens."""
    from repro_torch.configs.base import get_config
    from repro_torch.convert import shard_cache, shard_params
    from repro_torch.models import LM
    from repro_torch.models.model import map_tree
    from repro_torch.serve.step import (make_chunked_prefill_step,
                                        make_serve_step, plan_serve_sharding)

    sv = MP_SERVE
    model = LM(get_config("lm-100m"))
    params = map_tree(lambda t: t.to(torch.bfloat16), model.init(
        torch.Generator().manual_seed(0), device=dev))
    prompt = torch.randint(0, model.cfg.vocab_size,
                           (sv["batch"], sv["prompt"]),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    out = {}
    for seq in (False, True):
        b = 1 if seq else sv["batch"]
        plan = plan_serve_sharding(model, model.abstract_params(),
                                   model.abstract_cache(b, sv["max_len"]),
                                   mesh, seq_sharded=seq)
        pb = shard_params(params, plan, mesh.coords)
        cache = shard_cache(model.init_cache(b, sv["max_len"], device=dev),
                            plan, mesh.coords)
        step = make_serve_step(model, mesh, plan, batch_dp=not seq)
        c0 = mesh.model_axis.collectives
        lgs, step_s = [], []
        if seq:
            toks, start = prompt[:1, :1], 0
        else:
            pre = make_chunked_prefill_step(model, mesh, plan)
            lg, cache = pre(pb, cache, prompt, 0)
            lgs.append(lg[:, -1:])
            toks, start = lg[:, -1].argmax(-1)[:, None], sv["prompt"]
        fed = [toks]
        n = sv["seq_steps"] if seq else sv["steps"]
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = step(pb, cache, toks, start + i)
            toks = lg[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            lgs.append(lg)
            fed.append(toks)
        name = "seq_sharded" if seq else "batch"
        row = dict(layout=name, batch=b, max_len=sv["max_len"],
                   cache_k_spec=plan.cache_specs[0]["pos0"]["k"],
                   decode_p50_ms=statistics.median(step_s) * 1e3,
                   step_ms=[x * 1e3 for x in step_s],
                   model_collectives=mesh.model_axis.collectives - c0,
                   tokens=torch.cat(fed, 1).tolist())
        if rank == 0:
            # the same card's world of one, fed the same tokens
            ref_cache = model.init_cache(b, sv["max_len"], device=dev)
            want = []
            if seq:
                pos0 = 0
            else:
                lg, ref_cache = model.prefill_chunk(params, ref_cache,
                                                    prompt, 0)
                want.append(lg[:, -1:])
                pos0 = sv["prompt"]
            for i in range(n):
                lg, ref_cache = model.decode_step(params, ref_cache,
                                                  fed[i], pos0 + i)
                want.append(lg)
            got, want = torch.cat(lgs, 1), torch.cat(want, 1)
            top2 = want.topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > MP_MARGIN
            agree = got.argmax(-1)[clear] == want.argmax(-1)[clear]
            row.update(max_abs_err=float((got - want).abs().max()),
                       atol=MP_ATOL, clear_picks=int(clear.sum()),
                       picks=int(clear.numel()),
                       clear_picks_equal=bool(agree.all()))
            if row["max_abs_err"] > MP_ATOL or not row["clear_picks_equal"]:
                raise AssertionError(f"model_parallel decode {name}: {row}")
        out[name] = row
        emit("model_parallel", rank=rank, what=f"(d) sharded decode {name}",
             note="the model group is gloo through the host: not "
                  "tensor-parallel speed", device=smi,
             **{k: v for k, v in row.items() if k != "tokens"})
    return out


def _mp_plans(torch, mesh, smi, rank):
    """(a): the full-width lm-100m plans on this mesh, with the quirks the
    compute must accept."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import LM
    from repro_torch.serve.step import plan_serve_sharding
    from repro_torch.train.step import plan_sharding

    model = LM(get_config("lm-100m"))
    ap = model.abstract_params()
    tp = plan_sharding(model, ap, mesh).tp_dims
    sv = plan_serve_sharding(model, ap, model.abstract_cache(
        MP_SERVE["batch"], MP_SERVE["max_len"]), mesh)
    sq = plan_serve_sharding(model, ap, model.abstract_cache(
        1, MP_SERVE["max_len"]), mesh, seq_sharded=True)
    row = dict(train_tp_leaves=sum(d is not None for d in tp.values()),
               leaves=len(tp), attn_wo=tp["g0/pos0['attn']['wo']"],
               ffn_wo=tp["g0/pos0['ffn']['wo']"], embed=tp["embed"],
               lm_head=tp["lm_head"],
               serve_wq=sv.tp_dims()["g0/pos0['attn']['wq']"],
               cache_k=sv.cache_specs[0]["pos0"]["k"],
               cache_pos=sv.cache_specs[0]["pos0"]["pos"],
               seq_cache_k=sq.cache_specs[0]["pos0"]["k"])
    emit("model_parallel", rank=rank, what="(a) plans", device=smi, **row)
    if (row["attn_wo"], row["ffn_wo"], row["embed"], row["lm_head"],
            row["serve_wq"]) != (1, 0, 0, 1, 0) or row["cache_k"][2] != \
            "model" or row["seq_cache_k"][2] != ("data", "model"):
        raise AssertionError(f"model_parallel plans: {row}")


def model_parallel_worker(rank: int, tmp: str) -> int:
    """One of phase 24's two processes on the one card: a gloo world of
    two, the dp groups one-rank NCCL groups, the model group gloo on CUDA
    tensors (NCCL refuses two ranks on one card)."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=2)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        smi = nvidia_smi()
        mesh = make_host_mesh(model=2, dp_backend="nccl",
                              model_backend="gloo")
        emit("model_parallel", rank=rank, what="mesh",
             shape=dict(mesh.sizes), coords=mesh.coords,
             backends={"dp": dist.get_backend(mesh.dp_group),
                       "model": dist.get_backend(mesh.model_group),
                       "world": dist.get_backend()}, device=smi)
        _mp_plans(torch, mesh, smi, rank)
        launches = _mp_train(torch, mesh, smi, rank)
        decode = _mp_decode(torch, dev, mesh, smi, rank)
        with open(f"{tmp}/launches{rank}.json", "w") as f:
            json.dump({"launches": launches,
                       "decode_p50_ms": {k: v["decode_p50_ms"]
                                         for k, v in decode.items()}}, f)
    finally:
        dist.destroy_process_group()
    return 0


def run_model_parallel(torch):
    """Phase 24: the 1 (data) x 2 (model) world as two processes sharing
    the card; a failure in either fails the phase. -> the launches of
    both processes, summed."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"),
         "--model-parallel-worker", str(r), tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=MP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out in outs:
        for line in out.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
    rcs = [p.returncode for p in procs]
    if rcs != [0, 0]:
        raise AssertionError(f"model_parallel: worker exit codes {rcs}: "
                             + "\n".join(o[-4000:] for o in outs))
    total, p50 = {}, {}
    for r in range(2):
        with open(f"{tmp}/launches{r}.json") as f:
            got = json.load(f)
        for k, v in got["launches"].items():
            total[k] = total.get(k, 0) + v
        p50[r] = got["decode_p50_ms"]
    emit("model_parallel", what="launches of both processes",
         launches=total, decode_p50_ms=p50)
    return total


def start_world(torch):
    """A world of one process on NCCL, rendezvous through a file store in a
    temporary directory (no network)."""
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="chip_smoke_world_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    return dist


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--model-parallel-worker"]:
        return model_parallel_worker(int(sys.argv[2]), sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no repro_torch package under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    laps, last = {}, [time.perf_counter()]

    def lap(name):
        """Wall seconds since the previous lap, kept for the done line."""
        now = time.perf_counter()
        laps[name] = now - last[0]
        last[0] = now

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         per_kernel={k: {"seconds": v["seconds"], "cached": v["cached"],
                         "ptxas": [ln.strip() for ln in v["ptxas"].splitlines()
                                   if "registers" in ln or "spill" in ln]}
                     for k, v in report.items()})
    lap("build")

    enc = check_encode(torch, dev)
    att = check_attend(torch, dev)
    dec = check_decode(torch, dev)
    qdq = check_qdq(torch, dev)
    bgr = check_bingrad(torch, dev)
    mpk = check_multipass_kernels(torch, dev)
    check_schedule_shapes(torch, dev)
    fsdp_times = check_fsdp_shapes(torch, dev)
    lap("kernels")
    serve_launches, eng = run_main_path(torch)
    check_against_cpu(torch, dev)
    profile_decode(torch, eng)
    del eng
    bin_serve_launches, eng = run_main_path(torch, "bingrad-b")
    check_against_cpu(torch, dev, "bingrad-b")
    profile_decode(torch, eng)
    del eng
    lap("serve")
    dist = start_world(torch)
    try:
        train_launches, state, k1_sha = run_train_path(torch)
        profile_train(torch, state)
        del state
        bin_train_launches, state, bin_sha = run_bingrad_train(torch)
        profile_train(torch, state, "bingrad-b")
        del state
        other_launches = run_other_schemes(torch)
        lap("train")
        check_exchange_card_vs_cpu(torch, dev)
        lap("exchange")
        pipe_launches = run_pipelined_train(torch, {**k1_sha, **bin_sha})
        leaf_launches = run_per_leaf_train(torch)
        lap("train_pipelined_per_leaf")
        fsdp_launches, state = run_fsdp_train(torch)
        profile_train(torch, state, "orq-9", mode="fsdp")
        del state
        lap("train_fsdp")
        ckpt_launches = run_checkpoint(torch)
        lap("checkpoint")
        sched_launches = run_bit_schedule_train(torch, dev)
        lap("train_bit_schedule")
        async_launches = run_async_train(torch, dev, dist, k1_sha["orq9_ef"])
        lap("train_async")
        grads_loss = full_width_grads(torch, dev)
        check_per_leaf_card_vs_cpu(torch, dev, grads_loss[0])
        check_fsdp_card_vs_cpu(torch, dev, grads_loss[0])
        check_async_card_vs_cpu(torch, dev, grads_loss[0])
        lap("card_vs_cpu_leaves")
        mp_launches = run_multipass_path(torch, dev, grads_loss)
        lap("multipass")
        check_theory(torch, grads_loss[0])
        lap("theory")
        _all_zero(torch, "train_local card vs CPU",
                  lambda: check_local_card_vs_cpu(torch, dev, grads_loss[0]))
        del grads_loss
    finally:
        dist.destroy_process_group()
    run_local_train(torch, dev)
    lap("train_local")
    run_dense_serve(torch)
    lap("serve_dense")
    cifar_launches = run_paper_cifar(torch, dev)
    check_cifar_card_vs_cpu(torch, dev)
    lap("paper_cifar")
    arch_launches, arch_times = run_serve_archs(torch, dev)
    lap("serve_archs")
    moe_launches = run_moe_mla(torch, dev)
    lap("moe_mla")
    rec_launches = run_recurrent(torch, dev)
    lap("recurrent")
    whisper_launches = run_whisper(torch, dev)
    lap("whisper")
    mp_par_launches = run_model_parallel(torch)
    lap("model_parallel")

    paths = {"serve_orq9": serve_launches,
             "serve_bingrad_b": bin_serve_launches,
             "train_orq9": train_launches,
             "train_bingrad_b": bin_train_launches,
             "train_other_schemes": other_launches,
             "multipass_exchange": mp_launches,
             "train_pipelined": pipe_launches,
             "train_per_leaf": leaf_launches,
             "train_fsdp": fsdp_launches,
             "checkpoint": ckpt_launches,
             "train_bit_schedule": sched_launches,
             "train_async": async_launches,
             "paper_cifar": cifar_launches,
             "serve_archs": arch_launches,
             "moe_mla": moe_launches,
             "recurrent": rec_launches,
             "whisper": whisper_launches,
             "model_parallel": mp_par_launches}
    unlaunched = [k for k in MP_KERNELS if not mp_launches.get(k)]
    if unlaunched:
        raise AssertionError(f"the multi-pass path launched no {unlaunched}")

    def row(name, source, replaces, m, **extra):
        by_path = {p: c[name] for p, c in paths.items() if c[name]}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "device_ms": m["device_ms"],
                "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                **extra}

    def shape_of(m):
        return {k: m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "device_ms")}

    def fsdp(name):
        return {"fsdp_shapes": fsdp_times[name]}

    def archs(name):
        keys = ("layer", "T", "H", "KV", "hd", "C", "softcap", "rows", "d",
                "ms", "plain_ms", "device_ms", "bound_ms", "bound_by")
        pick = lambda r: {k: r[k] for k in keys if k in r}   # noqa: E731
        if name == "decode_attend":
            return {"arch_shapes": {a: [pick(r) for r in t[name]]
                                    for a, t in arch_times.items()}}
        return {"arch_shapes": {a: pick(t[name])
                                for a, t in arch_times.items()}}

    e, a = enc["decode_rows16"], att["decode_b8"]
    kernels = [
        row("encode_fused", "src/repro_torch/csrc/encode_fused.cu",
            "src/repro/kernels/fused_encode.py:255", e,
            train_shape=shape_of(enc["train_main_shape"]),
            train_shape_bits1=shape_of(enc["train_main_shape_bits1"]),
            train_shape_bits3=shape_of(enc["train_main_shape_bits3"]),
            train_shape_bits2=shape_of(enc["train_main_shape_bits2"]),
            train_shape_bits5=shape_of(enc["train_main_shape_bits5"]),
            **fsdp("encode_fused"), **archs("encode_fused")),
        row("decode_attend", "src/repro_torch/csrc/decode_attend.cu",
            "src/repro/kernels/fused_kv.py:70", a,
            prefill_t64=shape_of(att["prefill_t64"]),
            serve_positions=shape_of(att["serve_positions"]),
            hd16=shape_of(att["hd16"]), hd256=shape_of(att["hd256"]),
            **archs("decode_attend")),
        row("qdq_fused", "src/repro_torch/csrc/encode_fused.cu",
            "src/repro/kernels/fused_encode.py:283",
            qdq["train_main_shape"],
            train_shape_bits2=shape_of(qdq["train_main_shape_bits2"]),
            train_shape_bits5=shape_of(qdq["train_main_shape_bits5"]),
            **fsdp("qdq_fused")),
        row("decode_fused_mean", "src/repro_torch/csrc/decode_fused.cu",
            "src/repro/kernels/fused_decode.py:84", dec["decode_fused_mean"],
            bits1=shape_of(dec["decode_fused_mean/bits1"]),
            L4=shape_of(dec["decode_fused_mean/L4"]),
            bits2=shape_of(dec["decode_fused_mean/bits2"]),
            bits5=shape_of(dec["decode_fused_mean/bits5"]),
            **fsdp("decode_fused_mean")),
        row("decode_fused_each", "src/repro_torch/csrc/decode_fused.cu",
            "src/repro/kernels/fused_decode.py:107",
            dec["decode_fused_each"],
            bits1=shape_of(dec["decode_fused_each/bits1"]),
            L4=shape_of(dec["decode_fused_each/L4"]),
            bits2=shape_of(dec["decode_fused_each/bits2"]),
            bits5=shape_of(dec["decode_fused_each/bits5"]),
            **fsdp("decode_fused_each")),
        row("encode_bingrad_fused", "src/repro_torch/csrc/encode_bingrad.cu",
            "src/repro/kernels/fused_bingrad.py:102",
            bgr["train_main_shape"], kv_shape=shape_of(bgr["kv_rows16"]),
            lloyd2_clip=shape_of(bgr["train_lloyd2_clip2.5"]),
            d4096=shape_of(bgr["train_d4096"]),
            d2047=shape_of(bgr["train_d2047"]),
            **fsdp("encode_bingrad_fused")),
        row("bingrad_pass", "src/repro_torch/csrc/encode_bingrad.cu",
            "src/repro/kernels/bingrad.py:52", bgr["pass/train_main_shape"],
            kv_shape=shape_of(bgr["pass/kv_rows16"]),
            note="on no main path: the reference calls it only from its "
                 "kernel tests"),
    ]
    mp_note = ("on no main path: the reference's parity baseline and its "
               "fallback encode")
    mp_src = "src/repro_torch/csrc/multipass.cu"
    kernels += [
        row("quant_rr", mp_src, "src/repro/kernels/quant_rr.py:74",
            mpk["quant_rr"], note=mp_note),
        row("pack", mp_src, "src/repro/kernels/bitpack.py:46", mpk["pack"],
            note=mp_note),
        row("unpack", mp_src, "src/repro/kernels/bitpack.py:65",
            mpk["unpack"], note=mp_note),
        row("dequant_avg", mp_src, "src/repro/kernels/dequant_avg.py:50",
            mpk["dequant_avg_L1"], L4=shape_of(mpk["dequant_avg_L4"]),
            note=mp_note),
    ]
    emit("done", seconds=time.perf_counter() - t_start, phase_seconds=laps)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
