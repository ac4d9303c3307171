"""The port's host mesh (``launch/mesh.py``) against the reference's
``make_host_mesh``.

* The factor checks: for every case of ``tests/test_launch_mesh.py`` and
  a few valid layouts, at world sizes 1, 2 and 4, the port's
  ``mesh_shape`` raises the reference's message word for word, or gives
  the reference's axis names and shape (the reference's side with
  ``jax.devices`` and ``jax.make_mesh`` standing in for n devices).
* Gloo worlds of 2 and 4 processes (one module fixture, concurrently):
  ``make_host_mesh(model=2)`` gives each rank the coordinates
  ``jax.make_mesh`` would (rank = dp index * n_model + model index), the
  dp group holds the ranks of its model index in dp order, the model
  group the ranks of its dp index; ``pods=2`` adds the leading pod axis
  and its two-level pod groups; a factor that does not divide the world
  raises the reference's message there too. With no process group the
  mesh is a world of one.
"""
import json
import os
import subprocess
import sys

import jax
import pytest

from repro.launch import mesh as jmesh
from repro_torch.launch.mesh import make_host_mesh, mesh_shape
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cases(n):
    """(kwargs, ...) of the reference's mesh tests at device count n."""
    return [dict(), dict(model=n + 1), dict(data=0), dict(model=0),
            dict(model=-2), dict(pods=0), dict(data=2.0), dict(data=n + 3),
            dict(pods=n + 1), dict(model=n), dict(model=2), dict(pods=2),
            dict(pods=2, model=2), dict(data=1, model=n)]


def _outcome(fn, kw):
    try:
        return ("ok",) + tuple(map(tuple, fn(**kw)))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_factor_checks_match_reference(monkeypatch, n):
    monkeypatch.setattr(jax, "devices", lambda *a: [None] * n)
    monkeypatch.setattr(jax, "make_mesh",
                        lambda shape, names: (names, shape))
    for kw in _cases(n):
        want = _outcome(jmesh.make_host_mesh, kw)
        got = _outcome(lambda **k: mesh_shape(n, **k), kw)
        assert got == want, (n, kw)


def test_no_process_group_is_a_world_of_one():
    prog = ("from repro_torch.launch.mesh import make_host_mesh; "
            "m = make_host_mesh(); print(m.axis_names, m.shape, m.n_dp, "
            "m.n_model, m.coords)")
    out = subprocess.run(
        [sys.executable, "-c", prog], capture_output=True, text=True,
        timeout=120, env={**os.environ,
                          "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ("('data', 'model') (1, 1) 1 1 "
                                  "{'data': 0, 'model': 0}")


PROG = """
import json, sys, torch, torch.distributed as dist
rank, ws, rdv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=ws)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import tp

def members(ax):
    t = torch.tensor([rank], dtype=torch.int64)
    return tp.gather_blocks(ax, [t])[0].reshape(-1).tolist()

out = dict()
m = make_host_mesh(model=2)
out["model2"] = dict(shape=list(m.shape), names=list(m.axis_names),
                     coords=m.coords, dp=members(m.dp_axis),
                     model=members(m.model_axis),
                     world=members(m.world_axis))
if ws == 4:
    p = make_host_mesh(model=2, pods=2)
    intra, inter = p.pod_groups(1)
    out["pods2"] = dict(shape=list(p.shape), names=list(p.axis_names),
                        coords=p.coords, dp=members(p.dp_axis),
                        inter=dist.get_process_group_ranks(inter))
try:
    make_host_mesh(model=3)
except ValueError as e:
    out["model3"] = str(e)
print("ROWS " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    procs = {ws: [subprocess.Popen(
        [sys.executable, "-c", PROG, str(r), str(ws), str(tmp / f"rdv{ws}")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(ws)] for ws in (2, 4)}
    rows = {}
    for ws, ps in procs.items():
        outs = [p.communicate(timeout=300)[0] for p in ps]
        assert [p.returncode for p in ps] == [0] * ws, outs
        rows[ws] = [json.loads([ln for ln in o.splitlines()
                                if ln.startswith("ROWS ")][-1][5:])
                    for o in outs]
    return rows


@pytest.mark.parametrize("ws", [2, 4])
def test_mesh_coordinates_and_groups(worlds, ws):
    n_dp = ws // 2
    for rank, r in enumerate(worlds[ws]):
        m = r["model2"]
        assert (m["names"], m["shape"]) == (["data", "model"], [n_dp, 2])
        d, k = divmod(rank, 2)
        assert m["coords"] == {"data": d, "model": k}
        assert m["dp"] == [w * 2 + k for w in range(n_dp)]
        assert m["model"] == [d * 2 + j for j in range(2)]
        assert m["world"] == list(range(ws))
        assert r["model3"] == (f"model*pods=3*1 does not divide the device "
                               f"count {ws}; pick factors of {ws}")


def test_pod_mesh_and_pod_groups(worlds):
    for rank, r in enumerate(worlds[4]):
        p = r["pods2"]
        assert (p["names"], p["shape"]) == (["pod", "data", "model"],
                                            [2, 1, 2])
        pod, k = divmod(rank, 2)
        assert p["coords"] == {"pod": pod, "data": 0, "model": k}
        assert p["dp"] == [k, 2 + k]
        assert p["inter"] == [k, 2 + k]
