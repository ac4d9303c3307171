"""Model parallelism on the card: the 1 (data) x 2 (model) world as two
processes sharing one card (NCCL refuses two ranks on one card, so each
process's dp group is a one-rank NCCL group and the model group is gloo
on CUDA tensors), held against the same world on the CPU, where the
kernels' plain versions run (gloo for both groups).

One step of each: replicated orq-9 with error feedback, replicated
BinGrad-b and per-leaf fsdp orq-9, on smoke lm-100m with the loss
``sum(p * G)`` (through the per-leaf gathers in fsdp) and G on the 1/64
grid (every sum of a fit exact in any order): the params gathered over
``model`` and the EF residuals are bit-equal, card against CPU, and the
card's kernels ran (their launch counters moved). BinGrad-b's phase 2
re-fits the averaged chunk, whose level means are off the grid, so its
exchange is float-close (1e-5, ``tests/test_torch_exchange_schemes.py``)
and its params are held within BIN_PARAMS_ATOL: lr 0.05 x 1e-5 x
max |G| (1). Tests marked ``gpu`` need a CUDA device and skip
without one; they import no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_tp_gpu.py
"""
import json
import os
import subprocess
import sys
import tempfile

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN_PARAMS_ATOL = 0.05 * 1e-5
CASES = {"orq9_ef": ("orq-9", "replicated", True),
         "bingrad_b": ("bingrad-b", "replicated", False),
         "fsdp_orq9": ("orq-9", "fsdp", False)}

PROG = """
import json, sys
import torch, torch.distributed as dist
rank, rdv, cases = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=2)
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import prng
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels.ops import launch_counters
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM
from repro_torch.models import tp as tp_mod
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import StateSharding
from repro_torch.utils.pytree import tree_leaves, tree_unflatten


class Grid(LM):
    # loss sum(p * G), G on the 1/64 grid; each rank adds its TP blocks
    def __init__(self, cfg, dev):
        super().__init__(cfg)
        g = torch.Generator().manual_seed(3)
        aps = self.abstract_params()
        self.G = tree_unflatten(aps, [
            (torch.randint(-64, 65, tuple(t.shape), generator=g).float()
             / 64).to(dev) for t in tree_leaves(aps)])

    def loss(self, params, batch, gather=None, *, tp=None, **kw):
        G = tree_leaves(self.G)
        paths = tree_leaves(self.param_paths(self.G))
        if gather is not None:      # per-leaf fsdp: each repeat's slice
            params = tree_unflatten(params, [
                torch.stack([gather(p, x[r], r) for r in range(x.shape[0])])
                if p.startswith("g") else gather(p, x, 0)
                for p, x in zip(paths, tree_leaves(params))])
        if tp is not None:
            G = [g if tp.dims.get(p) is None else tp_mod.own_block(
                tp.axis, g, tp.dims[p] + p.startswith("g"))
                for p, g in zip(paths, G)]
        loss = sum((p * g.to(p.dtype)).sum()
                   for p, g in zip(tree_leaves(params), G))
        return loss, {"nll": loss, "aux": 0.0,
                      "tokens": torch.ones((), device=loss.device)}


cfg = get_smoke_config("lm-100m")
meshes = {"cuda": make_host_mesh(model=2, dp_backend="nccl",
                                  model_backend="gloo"),
          "cpu": make_host_mesh(model=2, dp_backend="gloo",
                                model_backend="gloo")}
out = {}
for name, (quant, mode, ef) in cases.items():
    res = {}
    for dev, mesh in meshes.items():
        model = Grid(cfg, dev)
        tcfg = TrainConfig(policy=QuantPolicy.parse(quant, bucket_size=512),
                           mode=mode, error_feedback=ef)
        fn = make_train_step(model, tcfg, constant_lr(0.05), mesh=mesh)
        state = init_state(model, tcfg, device=dev, step=fn)
        for c in launch_counters().values():
            c.launches = 0
        state, _ = fn(state, dict(tokens=torch.zeros(
            (1, 16), dtype=torch.int64, device=dev)), prng.key(0))
        launched = sum(c.launches for c in launch_counters().values())
        sh = StateSharding(fn)
        params = [t.cpu() for t in tree_leaves(sh.full_params(state.params))]
        efs = ([t.cpu() for t in tree_leaves(fn.tp.full(state.ef))]
               if ef else [])
        res[dev] = (params, efs, launched)
    out[name] = dict(
        params_equal=all(torch.equal(a, b) for a, b in zip(
            res["cuda"][0], res["cpu"][0])),
        params_max_abs_diff=max(float((a - b).abs().max()) for a, b in zip(
            res["cuda"][0], res["cpu"][0])),
        ef_equal=all(torch.equal(a, b) for a, b in zip(
            res["cuda"][1], res["cpu"][1])),
        launched_cuda=res["cuda"][2], launched_cpu=res["cpu"][2])
print("ROWS " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def rows():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    tmp = tempfile.mkdtemp(prefix="repro_torch_tp_gpu_")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", PROG, str(r), f"{tmp}/rdv",
         json.dumps(CASES)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    return [json.loads([ln for ln in o.splitlines()
                        if ln.startswith("ROWS ")][-1][5:]) for o in outs]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_world_on_the_card_equals_plain(rows, case):
    for r in rows:
        row = r[case]
        if case == "bingrad_b":
            assert row["params_max_abs_diff"] <= BIN_PARAMS_ATOL, row
        else:
            assert row["params_equal"], row
        assert row["ef_equal"], row
        assert row["launched_cuda"] > 0 and row["launched_cpu"] == 0, row
