"""Training launcher: data-parallel training with the paper's quantized
exchange (the reference's ``launch/train.py``).

    python -m repro_torch.launch.train --arch lm-100m --steps 100 \\
        --quant orq-9 --batch 8 --seq 128 [--error-feedback]
    python -m repro_torch.launch.train --arch lm-100m --steps 100 \\
        --quant bingrad-b --batch 8 --seq 128 [--error-feedback]

    # the pipelined exchange (K bucket-row chunks a phase, bit-identical
    # to K = 1) and the per-leaf exchange (one all-reduce per leaf):
    python -m repro_torch.launch.train --quant orq-9 --pipeline-chunks 4
    python -m repro_torch.launch.train --quant orq-9 --per-leaf-exchange

    # ZeRO-3: parameters and optimizer state sharded over the workers, one
    # quantized reduce-scatter per policy group a step:
    python -m repro_torch.launch.train --quant orq-9 --mode fsdp

    # checkpoints: write the state after step 2, then resume from it
    python -m repro_torch.launch.train --steps 4 --state-checkpoint ck \\
        --checkpoint-at 2
    python -m repro_torch.launch.train --steps 4 --resume ck

    # several workers, one card each (torchrun sets RANK / WORLD_SIZE /
    # MASTER_ADDR / MASTER_PORT; NCCL on the cards); with --pods 2 the
    # four workers are two pods of two and the exchange is two-level:
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --quant orq-9
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --quant orq-9 \\
        --pods 2 --hierarchy two_level

Without ``torchrun`` the launcher starts a world of one through a
``file://`` store in a temporary directory: NCCL on the card, gloo with
``--device cpu`` (which runs the kernels' plain versions). Weights are
random, drawn from ``torch.Generator(seed)``; the tokens are the
reference's ``SyntheticLM`` stream, bit for bit, each worker taking its
rows of the global batch. A sha256 digest of the final parameters (in
fsdp mode the full parameters, gathered in rank order) is printed
(``params sha256 ...``) and written to ``--metrics-out``, with the step's
collective launches and wire bytes per worker from the engine's own
accounting. Checkpoints are the reference's file format: rank 0 writes
the full arrays (fsdp shards gathered in rank order, EF buffers stacked
over the ranks), and ``--resume`` slices them back.

The async hierarchy, bit schedules and model parallelism are not ported
yet (ROADMAP.md); their flags exit with a message.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import get_config, get_smoke_config, list_archs
from repro_torch.core import prng
from repro_torch.core.api import all_methods
from repro_torch.core.comm.hierarchical import HIERARCHIES
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.optim.schedule import step_decay
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import StateSharding
from repro_torch.utils.pytree import tree_leaves

_NOT_PORTED = "is not ported to repro_torch yet (see ROADMAP.md)"


def params_digest(params) -> str:
    """sha256 over the raw bytes of every parameter leaf, in the
    reference's canonical order: a bit-level run fingerprint."""
    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="lm-100m", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (rows are split over the workers)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument(
        "--quant", default="fp", metavar="SCHEME|POLICY",
        help="quantization scheme or per-parameter-group policy string "
             "('pattern=scheme[,...][,default=scheme]'); registered "
             f"schemes: {', '.join(all_methods())}")
    ap.add_argument("--bucket", type=int, default=2048)
    ap.add_argument("--clip-c", type=float, default=None)
    ap.add_argument("--mode", default="replicated",
                    choices=["replicated", "fsdp"],
                    help="replicated: every worker holds every parameter; "
                         "fsdp: ZeRO-3, parameters and optimizer state "
                         "sharded over the workers")
    ap.add_argument("--hierarchy", default="auto", choices=list(HIERARCHIES),
                    help="two_level quantizes only across pods after a "
                         "full-precision mean within each pod; auto picks "
                         "two_level whenever --pods > 1")
    ap.add_argument("--pods", type=int, default=1,
                    help="split the workers into this many pods (rank = "
                         "pod * workers_per_pod + index)")
    ap.add_argument("--error-feedback", action="store_true",
                    help="accumulate error-feedback residuals")
    ap.add_argument("--exchange-chunk", type=int, default=None,
                    help="cap fused-collective size (elements) for memory")
    ap.add_argument("--pipeline-chunks", type=int, default=1,
                    help="split each fused exchange into K bucket-row "
                         "chunks (bit-identical to K = 1)")
    ap.add_argument("--per-leaf-exchange", action="store_true",
                    help="one quantized collective per parameter leaf "
                         "instead of the fused buffer")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None,
                    help="save the final PARAMS here")
    ap.add_argument("--state-checkpoint", default=None,
                    help="save the full TrainState here (params, optimizer, "
                         "EF residuals): what --resume restores")
    ap.add_argument("--checkpoint-at", type=int, default=None,
                    metavar="STEP",
                    help="write --state-checkpoint after this step instead "
                         "of at the end (the run continues)")
    ap.add_argument("--resume", default=None, metavar="STATE_CKPT",
                    help="restore a --state-checkpoint and continue from its "
                         "step counter (strict load)")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    # reference flags whose paths are not ported yet
    ap.add_argument("--bit-schedule", default=None)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    return ap


def _refuse_unported(ap, args) -> None:
    checks = [
        (args.bit_schedule is not None, "--bit-schedule"),
        (args.hierarchy == "two_level_async",
         "--hierarchy two_level_async"),
        (args.local_steps != 1, "--local-steps"),
        (args.model_parallel != 1, "--model-parallel"),
    ]
    for bad, what in checks:
        if bad:
            ap.error(f"{what} {_NOT_PORTED}")
    if args.checkpoint_at is not None and not args.state_checkpoint:
        ap.error("--checkpoint-at needs --state-checkpoint")


def _init_world(device):
    """(device, rank, world size, created): join the torchrun world, or
    start a world of one on a ``file://`` store in a temporary directory."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if dist.is_initialized():
        return device, dist.get_rank(), dist.get_world_size(), None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, ws = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="env://", rank=rank, world_size=ws)
        return device, rank, ws, ""
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/store", rank=0,
                            world_size=1)
    return device, 0, 1, tmp


def train(argv=None) -> dict:
    """Run the launcher; returns the run's record (history, per-step
    seconds, digest, wire accounting, final state)."""
    ap = _parser()
    args = ap.parse_args(argv)
    _refuse_unported(ap, args)
    try:
        policy = QuantPolicy.parse(args.quant, bucket_size=args.bucket,
                                   clip_c=args.clip_c)
        tcfg = TrainConfig(policy=policy, mode=args.mode,
                           hierarchy=args.hierarchy,
                           error_feedback=args.error_feedback,
                           fused_exchange=not args.per_leaf_exchange,
                           exchange_chunk_elems=args.exchange_chunk,
                           pipeline_chunks=args.pipeline_chunks)
    except (ValueError, NotImplementedError) as e:
        ap.error(str(e))
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    model = LM(cfg)
    device, rank, ws, created = _init_world(resolve_device(args.device))
    try:
        if args.batch % ws:
            ap.error(f"--batch {args.batch} does not split over {ws} "
                     f"workers")
        try:
            step_fn = make_train_step(
                model, tcfg, step_decay(args.lr, [args.steps // 2,
                                                  3 * args.steps // 4]),
                pods=args.pods)
        except (ValueError, NotImplementedError) as e:
            ap.error(str(e))
        state = init_state(model, tcfg, seed=args.seed, device=device,
                           step=step_fn)
        sharding = StateSharding(step_fn)
        start = 0
        if args.resume:
            # strict load against the fresh state's global form: params,
            # optimizer and EF residuals all round-trip
            full, _ = load_checkpoint(args.resume, like=sharding.gather(state))
            state = sharding.scatter(full)
            start = state.step
            if rank == 0:
                print(f"resumed {args.resume} at step {start}", flush=True)
        data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           batch_size=args.batch, seed=args.seed)
        key = prng.key(args.seed, device=device)
        rows = slice(rank * args.batch // ws, (rank + 1) * args.batch // ws)
        history, step_s = [], []
        t0 = time.perf_counter()
        for i in range(start, args.steps):
            tokens = data.batch(i, device=device)["tokens"][rows]
            ts = time.perf_counter()
            state, metrics = step_fn(state, {"tokens": tokens}, key)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_s.append(time.perf_counter() - ts)
            if args.state_checkpoint and args.checkpoint_at == i + 1:
                _save(rank, args.state_checkpoint, sharding.gather(state),
                      state.step)
            if i % args.log_every == 0 or i == args.steps - 1:
                row = {"step": i, "loss": float(metrics["loss"]),
                       "nll": float(metrics["nll"]),
                       "lr": float(metrics["lr"])}
                history.append(row)
                if rank == 0:
                    per = (time.perf_counter() - t0) / (i - start + 1)
                    print(f"step {i:5d} loss {row['loss']:.4f} "
                          f"({per:.2f}s/step)", flush=True)
        full_params = sharding.full_params(state.params)
        digest = params_digest(full_params)
        # every worker must end with the same (full) parameters
        mine = torch.tensor(list(bytes.fromhex(digest)), device=device)
        every = [torch.empty_like(mine) for _ in range(ws)]
        dist.all_gather(every, mine)
        in_sync = all(torch.equal(d, mine) for d in every)
        if args.checkpoint:
            _save(rank, args.checkpoint, full_params, state.step)
        if args.state_checkpoint and args.checkpoint_at is None:
            _save(rank, args.state_checkpoint, sharding.gather(state),
                  state.step)
        launches, wire_bytes = step_fn.launches_and_bytes(ws)
        out = {"history": history, "params_sha256": digest,
               "step_s": step_s, "world_size": ws, "rank": rank,
               "mode": args.mode, "pods": args.pods,
               "two_level": step_fn.layout.two_level,
               "n_params": sum(p.numel() for p in tree_leaves(full_params)),
               "exchange": ("per-leaf" if args.per_leaf_exchange
                            else "fused"),
               "pipeline_chunks": args.pipeline_chunks,
               "wire_bytes_per_worker": wire_bytes,
               "collective_launches_per_step": launches,
               "link_bytes_per_worker": (step_fn.link_bytes()
                                         if step_fn.link_bytes else None),
               "replicas_in_sync": in_sync, "device": str(device),
               "state": state}
        if rank == 0:
            print("params sha256", digest, flush=True)
            print(f"replicas in sync: {in_sync} ({ws} workers)", flush=True)
            print(f"collective launches per step {launches}, wire bytes "
                  f"per worker {wire_bytes:.0f}", flush=True)
            if args.metrics_out:
                with open(args.metrics_out, "w") as f:
                    json.dump({k: v for k, v in out.items() if k != "state"},
                              f, indent=1)
        return out
    finally:
        if created is not None:
            dist.destroy_process_group()
            if created:
                shutil.rmtree(created, ignore_errors=True)


def _save(rank: int, path: str, tree, step: int) -> None:
    """Rank 0 writes ``tree`` (already in its global form); every rank
    waits for the file."""
    if rank == 0:
        save_checkpoint(path, tree, step=step)
        print(f"checkpoint -> {path} at step {step}", flush=True)
    dist.barrier()


def main(argv=None) -> int:
    train(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
