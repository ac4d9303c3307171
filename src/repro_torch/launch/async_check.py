"""The temporal hierarchy (``two_level_async``) on a world of workers in
pods, against the two-level step: one launcher run of ``two_level``, then
one of ``two_level_async`` for each window H, each recording after every
step every worker's params sha256 and the outer anchor's.

    torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.async_check --pods 2 --local-steps 1,2,4

Rank 0 prints one JSON line a run (the launcher's params sha256, the step
times split into inner and sync steps, the per-link bytes a step) and a
last line with the checks, which every run must pass:

* H = 1 ends on the two_level run's params sha256 (it is that path);
* after every sync step all workers hold the same params, the new anchor;
* after an inner step the workers of a pod agree and the pods differ,
  and the anchor has not moved.

Exits 1 if a check fails. ``--device cpu`` runs it on gloo processes;
a caller that has initialized a process group already runs it in that.
``--model-parallel N`` adds a model axis (``launch.train``'s): every
digest is then of the params and anchor gathered over ``model``, so the
model ranks of a worker agree.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys

import torch
import torch.distributed as dist

from repro_torch.launch import train as launcher
from repro_torch.utils.pytree import tree_leaves


def _sha(tree) -> str:
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _everyone(hexdigest: str, device) -> list:
    """Every worker's digest, in rank order."""
    mine = torch.tensor(list(bytes.fromhex(hexdigest)), dtype=torch.uint8,
                        device=device)
    got = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(got, mine)
    return [bytes(t.cpu().tolist()).hex() for t in got]


def _run(base, hierarchy: str, h: int, pods: int) -> dict:
    """One launcher run -> its record and every step's digests."""
    steps = []

    def on_step(i, state, metrics, step_fn):
        dev = tree_leaves(state.params)[0].device
        sync = (step_fn.is_sync_step(i) if hasattr(step_fn, "is_sync_step")
                else True)
        params, anchor = state.params, (None if state.outer is None
                                        else state.outer.anchor)
        if step_fn.tp is not None:
            params = step_fn.tp.full(params)
            anchor = None if anchor is None else step_fn.tp.full(anchor)
        steps.append({"step": i, "sync": sync,
                      "params": _everyone(_sha(params), dev),
                      "anchor": None if anchor is None else _sha(anchor)})

    r = launcher.train(base + ["--pods", str(pods), "--hierarchy", hierarchy,
                               "--local-steps", str(h)], on_step=on_step)
    return {"record": r, "steps": steps}


def _window_ok(run: dict, pods: int) -> bool:
    """Sync: every worker equal to the new anchor; inner: each pod
    together, the pods apart, the anchor where it was."""
    n = len(run["steps"][0]["params"])
    per_pod = n // pods
    prev = None
    for s in run["steps"]:
        p = s["params"]
        moved = prev is not None and s["anchor"] != prev
        pod_rows = [p[k * per_pod:(k + 1) * per_pod] for k in range(pods)]
        together = all(len(set(rows)) == 1 for rows in pod_rows)
        if s["sync"]:
            if len(set(p)) != 1 or p[0] != s["anchor"] or (
                    prev is not None and not moved):
                return False
        elif not together or len(set(p)) == 1 or moved:
            return False
        prev = s["anchor"]
    return True


def _join_world(device: str) -> bool:
    """Join the world ``torchrun`` describes once, for every run (the
    launcher then uses it and leaves it up), unless the caller already
    initialized one -> whether this call created it."""
    import os
    if dist.is_initialized():
        return False
    if device == "cpu":
        dist.init_process_group("gloo", init_method="env://")
        return True
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl", init_method="env://")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch."
                                      "async_check")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--local-steps", default="1,2,4",
                    help="comma-separated windows H to run")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--arch", default="lm-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default="orq-9")
    ap.add_argument("--bucket", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None)
    ap.add_argument("--model-parallel", type=int, default=1)
    args = ap.parse_args(argv)
    base = ["--arch", args.arch, "--quant", args.quant, "--bucket",
            str(args.bucket), "--batch", str(args.batch), "--seq",
            str(args.seq), "--steps", str(args.steps), "--error-feedback",
            "--log-every", str(args.steps), "--model-parallel",
            str(args.model_parallel)]
    if args.smoke:
        base.append("--smoke")
    if args.device:
        base += ["--device", args.device]
    windows = [int(h) for h in args.local_steps.split(",")]
    created = _join_world(args.device or "cuda")
    rank = dist.get_rank()
    try:
        runs = {"two_level": _run(base, "two_level", 1, args.pods)}
        for h in windows:
            runs[f"async_h{h}"] = _run(base, "two_level_async", h,
                                       args.pods)
    finally:
        if created:
            dist.destroy_process_group()
    if rank != 0:
        return 0
    checks = {}
    for name, run in runs.items():
        r = run["record"]
        sync = [s["sync"] for s in run["steps"]]
        times = {kind: [t for t, s in zip(r["step_s"], sync) if s == want]
                 for kind, want in (("sync", True), ("inner", False))}
        print(json.dumps({
            "run": name, "local_steps": r["local_steps"],
            "params_sha256": r["params_sha256"], "step_s": r["step_s"],
            # the first step sets up cuBLAS and NCCL: the p50s leave it out
            "p50_ms": {k: statistics.median(v[1:] if len(v) > 2 else v) * 1e3
                       for k, v in times.items() if v},
            "link_bytes_per_step": r["link_bytes_per_worker"],
            "losses": [h["loss"] for h in r["history"]],
            "replicas_in_sync": r["replicas_in_sync"]}), flush=True)
        if name.startswith("async") and r["local_steps"] > 1:
            checks[f"{name}_window"] = _window_ok(run, args.pods)
    if "async_h1" in runs:
        checks["h1_equals_two_level"] = (
            runs["async_h1"]["record"]["params_sha256"]
            == runs["two_level"]["record"]["params_sha256"])
    print(json.dumps({"checks": checks, "ok": all(checks.values())}),
          flush=True)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
