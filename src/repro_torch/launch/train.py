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

    # the temporal hierarchy: 3 inner steps averaged within each pod, then
    # one quantized exchange of the window's parameter delta across pods
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --quant orq-9 \\
        --pods 2 --hierarchy two_level_async --local-steps 4

    # adaptive bit budget: per-group wire bits follow a schedule (and, with
    # --bit-budget, a bytes/step water-filling solve fed by the exchange's
    # statistics)
    python -m repro_torch.launch.train --steps 100 --resolve-every 25 \\
        --bit-schedule "norm|bias=fp,default=orq@5..2" [--bit-budget 2e5]

Without ``torchrun`` the launcher starts a world of one through a
``file://`` store in a temporary directory: NCCL on the card, gloo with
``--device cpu`` (which runs the kernels' plain versions). Weights are
random, drawn from ``torch.Generator(seed)``; the tokens are the
reference's ``SyntheticLM`` stream, bit for bit, each worker taking its
rows of the global batch. A sha256 digest of the final parameters (in
fsdp mode the full parameters, gathered in rank order) is printed
(``params sha256 ...``) and written to ``--metrics-out``, with the step's
collective launches and wire bytes per worker from the engine's own
accounting (per step over the window in two_level_async mode, where the
digest covers every worker's params stacked in rank order, the
reference's stacked tree). With ``--bit-schedule`` each logged row
carries the step's bits and ``--metrics-out`` the controller's
``bit_decisions``. Checkpoints are the reference's file format: rank 0
writes the full arrays (fsdp shards gathered in rank order, EF buffers
stacked over the ranks, async params and optimizer state stacked over
the ranks), and ``--resume`` slices them back.

``--model-parallel N`` lays the world out as the reference's host mesh
(``launch/mesh.py``: rank = dp index * N + model index) and trains
tensor-parallel over the model axis: each rank stores its TP blocks,
model ranks of one dp index read the same rows of the batch, and the
digest covers the params gathered over both axes. Two ranks cannot share
a card on NCCL; ``train(argv, mesh=...)`` takes a mesh built with other
backends (``make_host_mesh(model=2, dp_backend="nccl",
model_backend="gloo")`` in a gloo world of two processes on one card).

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --model-parallel 2 --quant orq-9 [--mode fsdp]

An encoder-decoder arch (whisper-base) is refused by name: its
batch carries frame embeddings beside the tokens, which this launcher's
token stream lacks (as the reference launcher's); it trains through
``make_train_step`` with ``{"tokens", "enc_embeds"}`` batches.
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
from repro_torch.configs.base import (cut_depth, get_config, get_smoke_config,
                                     list_archs)
from repro_torch.core import prng
from repro_torch.core.api import all_methods
from repro_torch.core.comm.hierarchical import HIERARCHIES
from repro_torch.core.comm.exchange import observed_link_stats
from repro_torch.core.policy import (BitBudgetController, BitSchedule,
                                     QuantPolicy)
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, mesh_shape
from repro_torch.models import LM
from repro_torch.models import tp as tp_mod
from repro_torch.optim.schedule import step_decay
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import (ScheduledTrainStep, StateSharding,
                                    check_async_axes, dp_world,
                                    specialize_engines)
from repro_torch.utils.pytree import tree_leaves


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
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers of the config (a depth "
                         "cut; widths unchanged)")
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
    ap.add_argument(
        "--bit-schedule", default=None, metavar="SCHEDULE",
        help="adaptive bit schedule: the --quant policy grammar extended "
             "with bit-ramp tokens 'family@HI..LO', HI <= 5 (e.g. "
             "\"embed=orq@5..3,norm|bias=fp,default=orq@4..1\"); per-group "
             "wire bits follow the ramp over --steps, re-resolved every "
             "--resolve-every steps. Mutually exclusive with --quant.")
    ap.add_argument(
        "--bit-budget", type=float, default=None, metavar="BYTES",
        help="quantized-DCN bytes/step budget: each phase water-fills "
             "bits from the ramps' LO toward the deterministic ramp value, "
             "largest marginal MSE reduction per byte first, fed by the "
             "exchange's statistics (needs --bit-schedule)")
    ap.add_argument("--resolve-every", type=int, default=50,
                    help="bit-schedule phase length in steps")
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
                         "two_level whenever --pods > 1; two_level_async "
                         "runs --local-steps inner steps averaged within "
                         "each pod between quantized outer syncs of the "
                         "parameter delta (needs --pods >= 2 and "
                         "replicated mode)")
    ap.add_argument("--local-steps", type=int, default=1,
                    help="two_level_async window H: inner steps per "
                         "quantized outer sync (H = 1 is two_level)")
    ap.add_argument("--outer-optimizer", default="nesterov",
                    choices=["nesterov", "sgd"],
                    help="outer optimizer applied to the window's "
                         "parameter delta at sync steps")
    ap.add_argument("--outer-lr", type=float, default=0.7)
    ap.add_argument("--outer-momentum", type=float, default=0.9)
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
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-axis size of the host mesh (tensor "
                         "parallelism over that many ranks)")
    return ap


def _check_args(ap, args):
    """Refusals while parsing, before any process group or model exists,
    with the reference launcher's messages -> (schedule or None, tcfg)."""
    try:
        mesh_shape(_world_size(), model=args.model_parallel, pods=args.pods)
    except ValueError as e:
        ap.error(str(e))
    if get_config(args.arch).encoder is not None:
        ap.error(f"--arch {args.arch}: an encoder-decoder model needs its "
                 f"frame embeddings in every batch, and this launcher's "
                 f"stream has tokens only; {args.arch} trains through "
                 f"make_train_step with enc_embeds in the batch "
                 f"({{'tokens', 'enc_embeds'}})")
    if args.checkpoint_at is not None and not args.state_checkpoint:
        ap.error("--checkpoint-at needs --state-checkpoint")
    schedule = None
    try:
        if args.bit_schedule is not None:
            if args.quant != "fp":
                ap.error("--bit-schedule and --quant are mutually exclusive "
                         "(the schedule IS the policy; put static entries "
                         "in the schedule string)")
            if args.bit_budget is not None and args.per_leaf_exchange:
                ap.error("--bit-budget needs the fused exchange (its "
                         "statistics feed) — drop --per-leaf-exchange")
            schedule = BitSchedule.parse(args.bit_schedule,
                                         bucket_size=args.bucket,
                                         clip_c=args.clip_c)
        policy = (None if schedule is not None else
                  QuantPolicy.parse(args.quant, bucket_size=args.bucket,
                                    clip_c=args.clip_c))
        tcfg = TrainConfig(
            policy=policy, mode=args.mode, hierarchy=args.hierarchy,
            local_steps=args.local_steps,
            outer_optimizer=args.outer_optimizer, outer_lr=args.outer_lr,
            outer_momentum=args.outer_momentum,
            error_feedback=args.error_feedback,
            fused_exchange=not args.per_leaf_exchange,
            exchange_chunk_elems=args.exchange_chunk,
            pipeline_chunks=args.pipeline_chunks,
            # the water-filling solve reads the statistics; the plain ramp
            # needs none, so the step skips them without a budget
            collect_stats=(schedule is not None
                           and args.bit_budget is not None))
        # --pods 1 names no pod axis, as the reference's host mesh
        check_async_axes(tcfg, dp_world(args.pods, args.pods)[0])
    except ValueError as e:
        ap.error(str(e))
    return schedule, tcfg


def _world_size() -> int:
    """The size of the world the launcher runs in: the initialized group's,
    torchrun's, else one."""
    if dist.is_initialized():
        return dist.get_world_size()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return 1


def _scheduled_step(model, tcfg, schedule, args, lr_fn, mesh):
    """The ScheduledTrainStep of ``--bit-schedule``, its controller
    pricing an assignment with the per-link accounting of the engines as
    built (the reference launcher's cost_fn): the quantized DCN bytes a
    step, the outer exchange amortized over a two_level_async window."""
    controller = BitBudgetController(
        schedule, total_steps=args.steps, resolve_every=args.resolve_every,
        dcn_budget_bytes=args.bit_budget)
    step_fn = ScheduledTrainStep(model, tcfg, controller, lr_fn, mesh=mesh)
    lay = step_fn.skeleton.layout
    n_intra = max(1, lay.n_intra)
    n_inter = max(1, lay.n_dp // n_intra)

    def cost_fn(phase_policy):
        eng = specialize_engines(step_fn.skeleton, phase_policy)
        total, _ = observed_link_stats(eng.pex, n_intra=n_intra,
                                       n_inter=n_inter,
                                       sync_every=lay.local_steps)
        return total["dcn_q_bytes"]

    controller.cost_fn = cost_fn
    return step_fn, controller


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


def train(argv=None, on_step=None, mesh=None) -> dict:
    """Run the launcher; returns the run's record (history, per-step
    seconds, digest, wire accounting, final state). ``on_step(i, state,
    metrics, step_fn)``, if given, runs on every rank after each step
    (inspection from Python: digests, launch counts). ``mesh`` (from
    ``make_host_mesh`` in the caller's world) replaces the one
    ``--model-parallel`` and ``--pods`` build."""
    ap = _parser()
    args = ap.parse_args(argv)
    schedule, tcfg = _check_args(ap, args)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cut_depth(cfg, args.layers)
    model = LM(cfg)
    device, rank, ws, created = _init_world(resolve_device(args.device))
    try:
        if mesh is None:
            try:
                mesh = make_host_mesh(model=args.model_parallel,
                                      pods=args.pods)
            except ValueError as e:
                ap.error(str(e))
        n_dp, dp_rank = mesh.n_dp, mesh.dp_axis.index
        if args.batch % n_dp:
            ap.error(f"--batch {args.batch} does not split over {n_dp} "
                     f"workers")
        lr_fn = step_decay(args.lr, [args.steps // 2, 3 * args.steps // 4])
        controller = None
        try:
            if schedule is not None:
                step_fn, controller = _scheduled_step(model, tcfg, schedule,
                                                      args, lr_fn, mesh)
                tcfg = step_fn.init_config
            else:
                step_fn = make_train_step(model, tcfg, lr_fn, mesh=mesh)
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
        # model ranks of one dp index read the same rows
        rows = slice(dp_rank * args.batch // n_dp,
                     (dp_rank + 1) * args.batch // n_dp)
        history, step_s, model_coll = [], [], []
        t0 = time.perf_counter()
        for i in range(start, args.steps):
            tokens = data.batch(i, device=device)["tokens"][rows]
            ts = time.perf_counter()
            c0 = mesh.model_axis.collectives
            state, metrics = step_fn(state, {"tokens": tokens}, key)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_s.append(time.perf_counter() - ts)
            model_coll.append(mesh.model_axis.collectives - c0)
            if on_step is not None:
                on_step(i, state, metrics, step_fn)
            if args.state_checkpoint and args.checkpoint_at == i + 1:
                _save(rank, args.state_checkpoint, sharding.gather(state),
                      state.step)
            if i % args.log_every == 0 or i == args.steps - 1:
                row = {"step": i, "loss": float(metrics["loss"]),
                       "nll": float(metrics["nll"]),
                       "aux": float(metrics["aux"]),
                       "lr": float(metrics["lr"])}
                bits = ""
                if controller is not None:
                    row["bits"] = list(step_fn.last_assignment)
                    bits = " bits " + ",".join(
                        "fp" if b is None else str(b) for b in row["bits"])
                history.append(row)
                if rank == 0:
                    per = (time.perf_counter() - t0) / (i - start + 1)
                    print(f"step {i:5d} loss {row['loss']:.4f}{bits} "
                          f"({per:.2f}s/step)", flush=True)
        full_params = sharding.full_params(state.params)
        digest = params_digest(full_params)
        # every worker must end with the same (full) parameters
        mine = torch.tensor(list(bytes.fromhex(digest)), dtype=torch.uint8,
                            device=device)
        every = tp_mod.gather_blocks(mesh.world_axis, [mine])[0]
        in_sync = all(torch.equal(d, mine) for d in every)
        if args.checkpoint:
            _save(rank, args.checkpoint, full_params, state.step)
        if args.state_checkpoint and args.checkpoint_at is None:
            _save(rank, args.state_checkpoint, sharding.gather(state),
                  state.step)
        launches, wire_bytes = step_fn.launches_and_bytes(n_dp)
        out = {"history": history, "params_sha256": digest,
               "step_s": step_s, "world_size": ws, "rank": rank,
               "mode": args.mode, "pods": args.pods,
               "model_parallel": mesh.n_model, "dp_size": n_dp,
               "model_collectives_per_step": model_coll,
               "backends": dict(mesh.backends),
               "two_level": step_fn.layout.two_level,
               "n_params": sum(p.numel() for p in tree_leaves(
                   model.abstract_params())),
               "local_steps": step_fn.layout.local_steps,
               "exchange": ("per-leaf" if args.per_leaf_exchange
                            else "fused"),
               "pipeline_chunks": args.pipeline_chunks,
               "wire_bytes_per_worker": wire_bytes,
               "collective_launches_per_step": launches,
               "link_bytes_per_worker": (step_fn.link_bytes()
                                         if step_fn.link_bytes else None),
               "replicas_in_sync": in_sync, "device": str(device),
               "state": state}
        if controller is not None:
            out["bit_decisions"] = controller.decisions
        if rank == 0:
            print("params sha256", digest, flush=True)
            print(f"replicas in sync: {in_sync} ({ws} workers)", flush=True)
            if mesh.n_model > 1:
                print(f"mesh {dict(mesh.sizes)}: model-group collectives "
                      f"per step {model_coll}", flush=True)
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
