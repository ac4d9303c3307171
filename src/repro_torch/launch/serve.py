"""Serving launcher (the reference's ``launch/serve.py``): batched greedy
decoding on one card. Two paths:

  dense (default)      the ring-buffer bf16 cache through
                       ``LM.decode_step`` (the reference's
                       ``make_serve_step``); the prompt prefills in chunks
                       through ``LM.prefill_chunk`` (``--prefill-chunk N``,
                       the reference's ``make_chunked_prefill_step``) or
                       token by token through the decode step
                       (``--prefill-chunk 0``, the reference loop).
  paged (--kv-quant)   the continuous-batching engine over the paged
                       quantized KV cache (``--kv-quant orq-9`` etc.;
                       ``--kv-quant bf16`` is the unquantized escape
                       hatch, greedy-identical to the dense path at equal
                       context).

Weights are random, drawn from ``torch.Generator(seed)``, and served in
bf16; prompts are drawn from ``torch.Generator(seed + 1)``. Timing starts
AFTER a warm-up (a step on a throwaway cache, or a warm-up request), and
prefill / decode throughput are reported separately, with the decode
steps' p50 / p99 latency, the cache bytes and a sha256 digest of the
generated tokens.

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
from repro_torch.models import LM
from repro_torch.models.model import map_tree
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.kv_cache import token_bytes_ratio


def _digest(toks: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(toks, np.int32)).tobytes()).hexdigest()


def _latency(step_s) -> dict:
    lat = np.asarray(step_s) * 1e3
    return {"step_p50_ms": float(np.percentile(lat, 50)) if len(lat) else None,
            "step_p99_ms": float(np.percentile(lat, 99)) if len(lat) else None}


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

    def forward(fn, cache, tokens, pos):
        nonlocal forward_calls
        forward_calls += 1
        return fn(params, cache, tokens, pos)

    # warm up on a throwaway cache
    warm = model.init_cache(args.batch, args.max_len, device=device)
    forward(model.decode_step, warm, prompt[:, :1], 0)
    if chunk:
        warm = model.init_cache(args.batch, args.max_len, device=device)
        forward(model.prefill_chunk, warm,
                prompt[:, :min(chunk, args.prompt_len)], 0)
    del warm
    if device.type == "cuda":          # the warm-up ends before the clock
        torch.cuda.synchronize(device)

    cache = model.init_cache(args.batch, args.max_len, device=device)
    t0 = time.perf_counter()
    if chunk:
        for off in range(0, args.prompt_len, chunk):
            logits, cache = forward(model.prefill_chunk, cache,
                                    prompt[:, off:off + chunk], off)
    else:
        for i in range(args.prompt_len):
            logits, cache = forward(model.decode_step, cache,
                                    prompt[:, i:i + 1], i)
    out = [torch.argmax(logits[:, -1], dim=-1).cpu()]   # waits for the card
    pre_s = time.perf_counter() - t0
    step_s = []
    for i in range(args.gen - 1):
        ts = time.perf_counter()
        logits, cache = forward(model.decode_step, cache,
                                out[-1][:, None].to(device),
                                args.prompt_len + i)
        out.append(torch.argmax(logits[:, -1], dim=-1).cpu())
        step_s.append(time.perf_counter() - ts)
    toks = torch.stack(out, dim=1).numpy().astype(np.int32)
    dec_s = sum(step_s)
    kv_bytes = 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2
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
    print("generated:", r["tokens"][:, :16])
    print(f"prefill: {r['prefill_tokens']} tokens in {r['prefill_s']:.2f}s "
          f"= {r['prefill_tok_s']:.1f} tok/s")
    print(f"decode:  {r['decode_tokens']} tokens in {r['decode_s']:.2f}s = "
          f"{r['decode_tok_s']:.1f} tok/s")
    if r["step_p50_ms"] is not None:
        print(f"step latency p50 {r['step_p50_ms']:.1f}ms "
              f"p99 {r['step_p99_ms']:.1f}ms")
    print(f"cache bytes: {r['cache_bytes']} "
          f"({r['token_bytes']} per token-layer, {r['path']} path)")
    print("tokens sha256:", r["sha256"])
    print(json.dumps({k: v for k, v in r.items()
                      if k not in ("tokens", "engine")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
