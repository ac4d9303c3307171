"""Serving launcher (the reference's ``launch/serve.py``): batched greedy
decoding on one card. Two paths:

  dense (default)      the ring-buffer bf16 cache through
                       ``serve.step.make_serve_step`` on the host mesh
                       (``launch.mesh.make_host_mesh()``, a world of one:
                       ``LM.decode_step``); the prompt prefills in chunks
                       through ``make_chunked_prefill_step``
                       (``--prefill-chunk N``) or token by token through
                       the decode step (``--prefill-chunk 0``, the
                       reference loop). Sharded serving is reached through
                       ``serve/step.py``, as the reference's is.
  paged (--kv-quant)   the continuous-batching engine over the paged
                       quantized KV cache (``--kv-quant orq-9`` etc.;
                       ``--kv-quant bf16`` is the unquantized escape
                       hatch, greedy-identical to the dense path at equal
                       context).

Weights are random, drawn from ``torch.Generator(seed)``, and served in
bf16; prompts are drawn from ``torch.Generator(seed + 1)``. An
encoder-decoder config (whisper) serves on the dense path only: its frame
embeddings (batch, frames, d_model), N(0, 0.02^2) from
``torch.Generator(seed + 2)`` in bf16 (the reference's stub of the audio
frontend), go through the encoder into the cache's cross K/V
(``serve.step.make_warm_step`` on the mesh: ``LM.warm_cache``) before the
clock starts, timed on their own. Timing
starts AFTER a warm-up (a step on a throwaway cache, or a warm-up
request), and prefill / decode throughput are reported separately, with
the decode steps' p50 / p99 latency, the cache bytes (K/V bytes per
token of an attention layer; a Mamba or RWKV layer's recurrent state per
sequence; the cross K/V per sequence of a decoder layer) and a sha256
digest of the generated tokens.

    python -m repro_torch.launch.serve --batch 8 --prompt-len 128 \\
        --gen 32 --max-len 512 --prefill-chunk 64
    python -m repro_torch.launch.serve --kv-quant orq-9 --batch 8 \\
        --prompt-len 128 --gen 32 --max-len 512 --prefill-chunk 64

Runs on the card; ``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_smoke_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM
from repro_torch.models.blocks import mamba_spec, rwkv_spec
from repro_torch.models.model import map_tree
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.kv_cache import token_bytes_ratio
from repro_torch.serve.step import (make_chunked_prefill_step,
                                    make_serve_step, make_warm_step,
                                    plan_serve_sharding)


def _digest(toks: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(toks, np.int32)).tobytes()).hexdigest()


def _latency(step_s) -> dict:
    lat = np.asarray(step_s) * 1e3
    return {"step_p50_ms": float(np.percentile(lat, 50)) if len(lat) else None,
            "step_p99_ms": float(np.percentile(lat, 99)) if len(lat) else None}


def dense_token_bytes(cfg) -> int:
    """bf16 cache bytes per token and attention layer on the dense path: K
    and V of every KV head, or MLA's compressed latent and its rope key; 0
    for a stack with no attention layer (rwkv6 has no KV heads)."""
    if not any(k in ("attn", "attn_local") for k in cfg.layer_pattern):
        return 0
    if cfg.mla is not None:
        return (cfg.mla.kv_lora + cfg.mla.rope_head_dim) * 2
    return 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2


def dense_state_bytes(cfg) -> int:
    """Cache bytes per sequence of one Mamba or RWKV layer on the dense
    path, whatever the context: Mamba's bf16 conv window and float32 SSM
    state, or RWKV's float32 WKV state and its two bf16 token shifts; 0
    for a stack with neither."""
    kinds = set(cfg.layer_pattern)
    if "mamba" in kinds:
        ms = mamba_spec(cfg)
        return ((ms.d_conv - 1) * ms.d_inner * 2
                + ms.d_inner * ms.d_state * 4)
    if "rwkv" in kinds:
        rs = rwkv_spec(cfg)
        return rs.num_heads * rs.head_dim ** 2 * 4 + 2 * cfg.d_model * 2
    return 0


def dense_cross_bytes(cfg) -> int:
    """bf16 cross-attention K/V bytes per sequence and decoder layer of
    an encoder-decoder config (every encoder frame, every KV head); 0
    without an encoder."""
    if cfg.encoder is None:
        return 0
    return cfg.encoder.num_frames * 2 * cfg.num_kv_heads * \
        cfg.resolved_head_dim * 2


def frame_embeds(cfg, batch: int, seed: int, device) -> torch.Tensor:
    """The serving launcher's frame embeddings (batch, frames, d_model):
    N(0, 0.02^2) from ``torch.Generator(seed + 2)``, in bf16."""
    g = torch.Generator().manual_seed(seed + 2)
    return (torch.randn((batch, cfg.encoder.num_frames, cfg.d_model),
                        generator=g) * 0.02).to(torch.bfloat16).to(device)


def _serve_dense(args, model, params, prompt, device) -> dict:
    cfg = model.cfg
    chunk = args.prefill_chunk
    if chunk and not model.supports_chunked_prefill():
        print("note: arch has no chunked-prefill path; falling back to the "
              "token-by-token loop")
        chunk = 0
    if chunk:
        # chunked prefill writes at absolute slots (no ring wrap), so the
        # prompt must fit the smallest layer cache (window for attn_local)
        min_c = min((cfg.window if s.kind == "attn_local" else args.max_len)
                    for s in model.specs)
        if args.prompt_len > min_c:
            print(f"note: prompt {args.prompt_len} exceeds the smallest "
                  f"layer cache ({min_c}); falling back to the "
                  f"token-by-token loop")
            chunk = 0
    prompt = torch.as_tensor(prompt, dtype=torch.int64, device=device)
    forward_calls = 0
    # the reference's launcher: the host mesh, its plan and steps
    mesh = make_host_mesh()
    plan = plan_serve_sharding(model, model.abstract_params(),
                               model.abstract_cache(args.batch, args.max_len),
                               mesh)
    decode_step = make_serve_step(model, mesh, plan)
    prefill_chunk = make_chunked_prefill_step(model, mesh, plan)
    warm_step = make_warm_step(model, mesh, plan)

    def forward(fn, cache, tokens, pos):
        nonlocal forward_calls
        forward_calls += 1
        return fn(params, cache, tokens, pos)

    enc = (frame_embeds(cfg, args.batch, args.seed, device) if cfg.encoder
           else None)
    # warm up on a throwaway cache
    warm = model.init_cache(args.batch, args.max_len, device=device)
    if enc is not None:
        warm_step(params, warm, enc)
    forward(decode_step, warm, prompt[:, :1], 0)
    if chunk:
        warm = model.init_cache(args.batch, args.max_len, device=device)
        forward(prefill_chunk, warm,
                prompt[:, :min(chunk, args.prompt_len)], 0)
    del warm
    if device.type == "cuda":          # the warm-up ends before the clock
        torch.cuda.synchronize(device)

    cache = model.init_cache(args.batch, args.max_len, device=device)
    warm_s = None
    if enc is not None:                # the encoder, before the clock
        t0 = time.perf_counter()
        cache = warm_step(params, cache, enc)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if chunk:
        for off in range(0, args.prompt_len, chunk):
            logits, cache = forward(prefill_chunk, cache,
                                    prompt[:, off:off + chunk], off)
    else:
        for i in range(args.prompt_len):
            logits, cache = forward(decode_step, cache,
                                    prompt[:, i:i + 1], i)
    out = [torch.argmax(logits[:, -1], dim=-1).cpu()]   # waits for the card
    pre_s = time.perf_counter() - t0
    step_s = []
    for i in range(args.gen - 1):
        ts = time.perf_counter()
        logits, cache = forward(decode_step, cache,
                                out[-1][:, None].to(device),
                                args.prompt_len + i)
        out.append(torch.argmax(logits[:, -1], dim=-1).cpu())
        step_s.append(time.perf_counter() - ts)
    toks = torch.stack(out, dim=1).numpy().astype(np.int32)
    dec_s = sum(step_s)
    kv_bytes = dense_token_bytes(cfg)
    pre_tok = args.batch * args.prompt_len
    dec_tok = args.batch * (args.gen - 1)
    return {
        "path": "dense",
        "tokens": toks,
        "prefill_tokens": pre_tok,
        "prefill_s": pre_s,
        "prefill_tok_s": pre_tok / max(pre_s, 1e-9),
        "prefill_chunk": chunk,
        "decode_tokens": dec_tok,
        "decode_s": dec_s,
        "decode_tok_s": dec_tok / max(dec_s, 1e-9),
        **_latency(step_s),
        "cache_bytes": sum(t.numel() * t.element_size()
                           for gc in cache for c in gc.values()
                           for t in c.values()),
        "token_bytes": kv_bytes,
        "state_bytes": dense_state_bytes(cfg),
        "cross_bytes": dense_cross_bytes(cfg),
        "warm_cache_s": warm_s,
        "token_bytes_ratio": 1.0,
        "forward_calls": forward_calls,
        "layers": cfg.num_layers,
        "sha256": _digest(toks),
        "engine": None,
    }


def _serve_paged(args, model, params, prompt, device) -> dict:
    page = args.page_size
    if args.max_len % page:
        raise SystemExit(f"--max-len {args.max_len} must be a multiple of "
                         f"--page-size {page}")
    scfg = ServeConfig(kv_quant=args.kv_quant, page_size=page,
                       max_batch=args.batch,
                       max_pages_per_seq=args.max_len // page,
                       prefill_chunk=args.prefill_chunk or 16)
    try:
        eng = Engine(model, params, scfg, device=device)
    except ValueError as e:
        raise SystemExit(f"--kv-quant: {e}")

    # warm-up request before timing
    eng.submit(prompt[0, :scfg.prefill_chunk + 1], max_new=2)
    eng.run()
    eng.prefill_time, eng.prefill_tokens = 0.0, 0
    eng.decode_times, eng.decode_tokens = [], 0

    rids = [eng.submit(prompt[b], max_new=args.gen)
            for b in range(args.batch)]
    res = eng.run()
    toks = np.stack([np.asarray(res[r].generated, np.int32) for r in rids])

    pre_s, dec_s = eng.prefill_time, sum(eng.decode_times)
    return {
        "path": "paged",
        "tokens": toks,
        "prefill_tokens": eng.prefill_tokens,
        "prefill_s": pre_s,
        "prefill_tok_s": eng.prefill_tokens / max(pre_s, 1e-9),
        "decode_tokens": eng.decode_tokens,
        "decode_s": dec_s,
        "decode_tok_s": eng.decode_tokens / max(dec_s, 1e-9),
        **_latency(eng.decode_times),
        "cache_bytes": eng.cache_bytes(),
        "token_bytes": eng.kvq.token_bytes(),
        "state_bytes": 0,
        "cross_bytes": 0,
        "warm_cache_s": None,
        "token_bytes_ratio": token_bytes_ratio(eng.kvq),
        "forward_calls": eng.forward_calls,
        "layers": model.cfg.num_layers,
        "sha256": _digest(toks),
        "engine": eng,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm-100m", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill chunk size (0: the token-by-token loop "
                         "on the dense path, 16 on the paged path)")
    ap.add_argument("--kv-quant", default="",
                    help="paged-engine KV scheme: any scheme with a "
                         "fused encode (orq-*, bingrad-b, bingrad-pb, "
                         "terngrad, qsgd-*, linear-*, signsgd, minmax2); "
                         "bf16 = unquantized pages; empty = the dense "
                         "ring-buffer path")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    return ap.parse_args(argv)


def setup(args):
    """(device, model, bf16 params, prompt (batch, prompt_len) int32) as
    the launcher builds them from its parsed arguments."""
    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(args.seed),
                        device=device)
    params = map_tree(lambda t: t.to(torch.bfloat16), params)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(
                               args.seed + 1)).numpy().astype(np.int32)
    return device, model, params, prompt


def serve(argv=None) -> dict:
    """Build the model (and, with ``--kv-quant``, the engine) from
    command-line style arguments, run the warm-up and the timed requests,
    and return the metrics (with the generated ``tokens`` and the paged
    path's ``engine``)."""
    args = parse_args(argv)
    device, model, params, prompt = setup(args)
    if args.kv_quant:
        return _serve_paged(args, model, params, prompt, device)
    return _serve_dense(args, model, params, prompt, device)


def main(argv=None) -> int:
    r = serve(argv)
    if r["warm_cache_s"] is not None:
        print(f"encoder warm_cache: {r['warm_cache_s']:.3f}s")
    print("generated:", r["tokens"][:, :16])
    print(f"prefill: {r['prefill_tokens']} tokens in {r['prefill_s']:.2f}s "
          f"= {r['prefill_tok_s']:.1f} tok/s")
    print(f"decode:  {r['decode_tokens']} tokens in {r['decode_s']:.2f}s = "
          f"{r['decode_tok_s']:.1f} tok/s")
    if r["step_p50_ms"] is not None:
        print(f"step latency p50 {r['step_p50_ms']:.1f}ms "
              f"p99 {r['step_p99_ms']:.1f}ms")
    state = (f", {r['state_bytes']} per sequence and recurrent layer"
             if r["state_bytes"] else "")
    if r["cross_bytes"]:
        state += (f", {r['cross_bytes']} cross K/V per sequence and "
                  f"decoder layer")
    print(f"cache bytes: {r['cache_bytes']} "
          f"({r['token_bytes']} per token and attention layer{state}, "
          f"{r['path']} path)")
    print("tokens sha256:", r["sha256"])
    print(json.dumps({k: v for k, v in r.items()
                      if k not in ("tokens", "engine")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
