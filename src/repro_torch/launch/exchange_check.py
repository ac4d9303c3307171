"""Hold the fused exchange on the cards against the same exchange on the
CPU, in one ``torchrun`` world of L workers:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.exchange_check

Every rank draws smoke lm-100m's gradient buffer from its own seed, of
multiples of 1/64 in [-1, 1] (every prefix sum of the ORQ fit is then
exact in float32 in any order, so the fits cannot differ by an ulp), and
runs the orq-9 ``PartitionedExchange`` (``exchange_parts`` and the
error-feedback ``local_qdq_parts``) twice: over NCCL on its card and over
gloo on the CPU (a gloo group of the same world, the plain versions of the
kernels). Rank 0 prints one JSON line; the script exits non-zero if any
value differs on any rank, or if the workers' means differ. ``--device
cpu`` runs both sides on the CPU (a rehearsal of the script itself).
``main`` joins a process group its caller has already initialized.
"""
from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_smoke_config
from repro_torch.core import prng
from repro_torch.core.comm.exchange import PartitionedExchange
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import LM


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torchrun ... -m repro_torch.launch.exchange_check")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    created = not dist.is_initialized()
    if created:     # torchrun's world: RANK / WORLD_SIZE / MASTER_ADDR
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    rank, ws = dist.get_rank(), dist.get_world_size()
    try:
        gloo = dist.new_group(backend="gloo")
        model = LM(get_smoke_config("lm-100m"))
        ap_ = model.abstract_params()
        pol = QuantPolicy.parse("orq-9", bucket_size=2048)
        out = {}
        for where, group in ((dev, None), (torch.device("cpu"), gloo)):
            pex = PartitionedExchange.build(pol, ap_, group,
                                            paths=model.param_paths(ap_))
            g = torch.Generator().manual_seed(args.seed + rank)
            buf = (torch.randint(-64, 65, (pex.layout.size,), generator=g)
                   .float() / 64).to(where)
            key = prng.key(11, device=where)
            out[where.type] = [t.cpu() for t in (
                pex.exchange_parts([buf], key)[0],
                pex.local_qdq_parts([buf], key)[0])]
        (mean_dev, qdq_dev), (mean_cpu, qdq_cpu) = out[dev.type], out["cpu"]
        mism = int((mean_dev != mean_cpu).sum() + (qdq_dev != qdq_cpu).sum())
        # phase 2 is deterministic: every worker must hold the same mean
        means = [torch.empty_like(mean_cpu) for _ in range(ws)]
        dist.all_gather(means, mean_cpu, group=gloo)
        agree = all(torch.equal(m, means[0]) for m in means)
        counts = torch.tensor([mism, int(not agree)])
        dist.all_reduce(counts, group=gloo)
        if rank == 0:
            print(json.dumps({
                "phase": "exchange_check", "world_size": ws,
                "backends": [dist.get_backend(), "gloo"],
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                "n": pex.layout.size,
                "wire_bytes_per_worker": pex.wire_bytes_per_worker(ws),
                "mismatched": int(counts[0]),
                "workers_disagree": int(counts[1]),
                "mean_abs": float(mean_cpu.abs().mean())}), flush=True)
        return 0 if int(counts.sum()) == 0 else 1
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
