#!/usr/bin/env python3
"""Run the training launcher once and print, on each rank, one JSON line
of what a reading of it needs: the card's name and power limit, the step
seconds, the run's own peak device memory (above what was allocated when
it started), the kernels' launch counts, the collective launches and the
wire bytes per worker.

    torchrun --standalone --nproc-per-node 4 tools/train_reading.py \\
        --arch lm-100m --mode fsdp --quant orq-9 --steps 2

Every argument goes to ``repro_torch.launch.train`` as it is; the card is
the rank's ``LOCAL_RANK`` (``--layers N`` cuts a config's depth).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_reading: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.ops import launch_counters
    from repro_torch.launch import train as launcher

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kernels = launch_counters()
    for fn in kernels.values():
        fn.launches = 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    r = launcher.train(argv)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "rank": r["rank"], "world_size": r["world_size"],
        "args": " ".join(argv), "wall_s": wall, "step_s": r["step_s"],
        "losses": [h["loss"] for h in r["history"]],
        "aux": [h["aux"] for h in r["history"]],
        "n_params": r["n_params"],
        "peak_mem_above_start": torch.cuda.max_memory_allocated() - base,
        "launches": {k: fn.launches for k, fn in kernels.items()
                     if fn.launches},
        "collective_launches_per_step": r["collective_launches_per_step"],
        "wire_bytes_per_worker": r["wire_bytes_per_worker"],
        "replicas_in_sync": r["replicas_in_sync"],
        "params_sha256": r["params_sha256"],
        "device": smi[int(os.environ.get("LOCAL_RANK", 0))]
        if smi else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
