"""Serving launcher: the paged quantized-KV engine (the reference's
``launch/serve.py``, its ``--kv-quant`` path).

Weights are random, drawn from ``torch.Generator(seed)``, and served in
bf16; prompts are drawn from ``torch.Generator(seed + 1)``. Timing starts
AFTER a warm-up request, and prefill / decode throughput are reported
separately; a sha256 digest of the generated tokens is printed.

    python -m repro_torch.launch.serve --kv-quant orq-9 --batch 8 \\
        --prompt-len 128 --gen 32 --max-len 512 --prefill-chunk 64
    python -m repro_torch.launch.serve --kv-quant bingrad-b --batch 8 \\
        --prompt-len 128 --gen 32 --max-len 512 --prefill-chunk 64

Runs on the card; ``--device cpu`` runs the kernels' plain versions. The
dense ring-buffer path (no ``--kv-quant``) is not ported yet.
"""
from __future__ import annotations

import argparse
import hashlib
import json

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
    lat = np.asarray(eng.decode_times) * 1e3
    return {
        "tokens": toks,
        "prefill_tokens": eng.prefill_tokens,
        "prefill_s": pre_s,
        "prefill_tok_s": eng.prefill_tokens / max(pre_s, 1e-9),
        "decode_tokens": eng.decode_tokens,
        "decode_s": dec_s,
        "decode_tok_s": eng.decode_tokens / max(dec_s, 1e-9),
        "step_p50_ms": float(np.percentile(lat, 50)) if len(lat) else None,
        "step_p99_ms": float(np.percentile(lat, 99)) if len(lat) else None,
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
                    help="prefill chunk size (0 = 16)")
    ap.add_argument("--kv-quant", default="",
                    help="paged-engine KV scheme: any scheme with a "
                         "fused encode (orq-*, bingrad-b, bingrad-pb, "
                         "terngrad, qsgd-*, linear-*, signsgd, minmax2); "
                         "bf16 = unquantized pages")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    return ap.parse_args(argv)


def serve(argv=None) -> dict:
    """Build the model and engine from command-line style arguments, run
    the warm-up and the timed requests, and return the metrics (with the
    generated ``tokens`` and the ``engine`` itself)."""
    args = parse_args(argv)
    if not args.kv_quant:
        raise SystemExit("the dense ring-buffer serve path is not ported to "
                         "repro_torch yet; pass --kv-quant (e.g. orq-9)")
    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(args.seed),
                        device=device)
    params = map_tree(lambda t: t.to(torch.bfloat16), params)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(
                               args.seed + 1)).numpy().astype(np.int32)
    return _serve_paged(args, model, params, prompt, device)


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
          f"({r['token_bytes']} per token-layer)")
    print("tokens sha256:", r["sha256"])
    print(json.dumps({k: v for k, v in r.items()
                      if k not in ("tokens", "engine")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
