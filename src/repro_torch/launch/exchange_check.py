"""Hold the exchange on the cards against the same exchange on the CPU,
in one ``torchrun`` world of L workers:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.exchange_check
    torchrun ... -m repro_torch.launch.exchange_check --mode fsdp
    torchrun ... -m repro_torch.launch.exchange_check --pods 2

Every rank draws smoke lm-100m's gradient buffers from its own seed, of
multiples of 1/64 in [-1, 1] (every prefix sum of the ORQ fit is then
exact in float32 in any order, so the fits cannot differ by an ulp), and
its error-feedback buffers of multiples of 1/512, and runs the orq-9
exchange twice: over NCCL on its card and over gloo on the CPU (gloo
groups of the same world, the plain versions of the kernels).

* ``--mode replicated`` (default): ``PartitionedExchange``'s
  ``exchange_parts`` and the error-feedback ``local_qdq_parts``; with
  ``--pods P`` the two-level exchange of the train step (fp intra scatter,
  EF on the shard, quantized shard exchange across pods, fp intra gather).
* ``--mode fsdp``: ``FsdpExchange.exchange_with_residuals`` on the fsdp
  plan's worker-major buffers (flat, or two-level with ``--pods P``).

Rank 0 prints one JSON line; the script exits non-zero if any value
differs on any rank, or if the workers' replicated means differ.
``--device cpu`` runs both sides on the CPU (a rehearsal of the script
itself). ``main`` joins a process group its caller has already
initialized.
"""
from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_smoke_config
from repro_torch.core import prng
from repro_torch.core.comm import hierarchical
from repro_torch.core.comm.exchange import (PartitionedExchange,
                                            observed_link_stats)
from repro_torch.core.comm.fsdp_exchange import FsdpExchange
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import LM
from repro_torch.train.step import dp_world, plan_sharding_shapes


def _grid(g, n, scale, where):
    return (torch.randint(-scale, scale + 1, (n,), generator=g).float()
            / scale).to(where)


def _run(args, rank, ws, where, group, backend):
    """(values to compare, the replicated mean or None, wire bytes)."""
    model = LM(get_smoke_config("lm-100m"))
    ap_ = model.abstract_params()
    pol = QuantPolicy.parse("orq-9", bucket_size=2048)
    dp, sizes = dp_world(ws, args.pods)
    intra = inter = None
    two = args.pods > 1 and ws // args.pods > 1
    if two:
        intra, inter = hierarchical.pod_groups(args.pods, ws // args.pods,
                                               backend=backend)
    g = torch.Generator().manual_seed(args.seed + rank)
    key = prng.key(11, device=where)
    if args.mode == "fsdp":
        plan = plan_sharding_shapes(model, ap_, dp_axes=dp, axis_sizes=sizes)
        ex = FsdpExchange.build(
            pol, ap_, dp, paths=plan.paths,
            shard_dims=plan.full_shard_dims(), n_shards=ws, group=group,
            intra_axes=("data",) if two else (),
            n_intra=ws // args.pods, intra_group=intra, inter_group=inter)
        bufs = [_grid(g, grp.size, 64, where) for grp in ex.layout.groups]
        ef = tuple(None if n is None else _grid(g, n, 512, where) / 8
                   for n in ex.ef_group_sizes())
        outs, res = ex.exchange_with_residuals(bufs, key, None, ef)
        vals = list(outs) + [r for r in res if r is not None]
        return vals, None, ex.wire_bytes_per_worker()
    pex = PartitionedExchange.build(
        pol, ap_, inter if two else group, paths=model.param_paths(ap_),
        intra_group=intra)
    buf = _grid(g, pex.layout.size, 64, where)
    if not two:
        mean = pex.exchange_parts([buf], key)[0]
        return ([mean, pex.local_qdq_parts([buf], key)[0]], mean,
                pex.wire_bytes_per_worker(ws))
    shards, valids = pex.intra_scatter_parts([buf])
    ef = _grid(g, shards[0].numel(), 512, where) / 8
    shards = (shards[0] + ef,)
    local = pex.local_qdq_shard_parts(shards, key, valids)[0]
    mean = pex.intra_gather_parts(pex.exchange_shard_parts(shards, key,
                                                           valids))[0]
    links = observed_link_stats(pex, n_intra=ws // args.pods,
                                n_inter=args.pods)[0]
    return ([mean, shards[0] - local], mean,
            links["ici_bytes"] + links["dcn_bytes"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torchrun ... -m repro_torch.launch.exchange_check")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mode", default="replicated",
                    choices=["replicated", "fsdp"])
    ap.add_argument("--pods", type=int, default=1)
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
        out = {}
        for where, group, backend in ((dev, None, None),
                                      (torch.device("cpu"), gloo, "gloo")):
            out[where.type] = _run(args, rank, ws, where, group, backend)
        (v_dev, mean_dev, wire), (v_cpu, mean_cpu, _) = (out[dev.type],
                                                          out["cpu"])
        mism = sum(int((a.cpu() != b).sum()) for a, b in zip(v_dev, v_cpu))
        agree = True
        if mean_cpu is not None:
            # phase 2 is deterministic: every worker holds the same mean
            means = [torch.empty_like(mean_cpu) for _ in range(ws)]
            dist.all_gather(means, mean_cpu, group=gloo)
            agree = all(torch.equal(m, means[0]) for m in means)
        counts = torch.tensor([mism, int(not agree)])
        dist.all_reduce(counts, group=gloo)
        if rank == 0:
            print(json.dumps({
                "phase": "exchange_check", "mode": args.mode,
                "pods": args.pods, "world_size": ws,
                "backends": [dist.get_backend(), "gloo"],
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                "n": sum(v.numel() for v in v_cpu),
                "wire_bytes_per_worker": wire,
                "mismatched": int(counts[0]),
                "workers_disagree": int(counts[1]),
                "mean_abs": float(v_cpu[0].abs().mean())}), flush=True)
        return 0 if int(counts.sum()) == 0 else 1
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
