"""The host mesh over the torch.distributed world (the reference's
``launch/mesh.py`` ``make_host_mesh``).

The reference lays its devices out as a ``(data, model)`` mesh, or
``(pod, data, model)`` with ``pods > 1``; the port lays the ranks of the
process group out the same way. ``jax.make_mesh`` orders devices
row-major, so the rank of the process at coordinates (pod, data, model)
is ``(pod * n_data + data) * n_model + model``.

:class:`HostMesh` holds this rank's coordinates and the process groups
its collectives run over:

* the dp group: the ranks with this model index, in dp order (pod-major),
  over which the paper's quantized exchange runs;
* the model group: the ranks with these dp coordinates, in model order,
  over which the tensor-parallel layers add and gather their blocks
  (``models/tp.py``).

``dist.new_group`` is collective, so every rank creates every group, in
the same order. A size-one axis creates no group: with ``model=1`` the dp
group is the default group, as it was before the mesh existed, and with
no process group at all the mesh is a world of one.

``make_production_mesh`` and the TPU v5e constants of the reference's
module describe TPU pods and have no counterpart here.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch.distributed as dist

from repro_torch.models.tp import Axis


class MeshShape(NamedTuple):
    """Axis names and sizes without a world: what the plans read (the
    reference's plans read only ``mesh.axis_names`` and
    ``mesh.devices.shape``)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


class HostMesh:
    """This rank's place in the mesh and the groups it communicates in.

    ``dp_axis``, ``model_axis`` and ``world_axis`` are
    :class:`~repro_torch.models.tp.Axis` objects (group, size, this rank's
    index); ``dp_group`` is the group the exchange takes (None: the
    default group)."""

    def __init__(self, axis_names, shape, rank: int, dp_axis: Axis,
                 model_axis: Axis, world_axis: Axis, backends):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape)
        self.rank = rank
        self.dp_axis, self.model_axis, self.world_axis = (
            dp_axis, model_axis, world_axis)
        self.backends = backends       # {"dp": name, "model": name}

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def coords(self) -> Dict[str, int]:
        """{axis name: this rank's index along it}."""
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.shape))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.axis_names)

    @property
    def pods(self) -> int:
        return self.sizes.get("pod", 1)

    @property
    def n_dp(self) -> int:
        return self.dp_axis.n

    @property
    def n_model(self) -> int:
        return self.model_axis.n

    @property
    def dp_group(self):
        return self.dp_axis.group

    @property
    def model_group(self):
        return self.model_axis.group

    def axis_for(self, entry) -> Axis:
        """The :class:`Axis` of a spec entry: ``"model"``, the dp axes
        (one name or the tuple), or the dp axes and ``"model"`` together
        (every rank)."""
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        names = tuple(names)
        if names == ("model",):
            return self.model_axis
        if names == self.dp_axes:
            return self.dp_axis
        if names == self.dp_axes + ("model",):
            return self.world_axis
        raise ValueError(f"no group for the axes {names} of a mesh "
                         f"{self.axis_names}")

    def pod_groups(self, n_intra: int):
        """(intra group, inter group) of the two-level hierarchy within
        this rank's dp group (``hierarchical.pod_groups`` over the mesh's
        rank layout); every rank calls this."""
        from repro_torch.core.comm import hierarchical
        return hierarchical.pod_groups(self.n_dp // n_intra, n_intra,
                                       backend=self.backends.get("dp"),
                                       n_model=self.n_model)


def _positive_int(name: str, value) -> int:
    if not isinstance(value, int) or isinstance(value, bool) or value < 1:
        raise ValueError(
            f"{name} must be a positive integer, got {value!r}")
    return value


def mesh_shape(n: int, data: Optional[int] = None, model: int = 1, *,
               pods: int = 1) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, shape) of the mesh over ``n`` ranks, after the
    reference's factor checks (its messages word for word, ``n`` in the
    place of its device count)."""
    model = _positive_int("model", model)
    pods = _positive_int("pods", pods)
    if n % (model * pods):
        raise ValueError(
            f"model*pods={model}*{pods} does not divide the device count "
            f"{n}; pick factors of {n}")
    if data is None:
        data = n // (model * pods)
    data = _positive_int("data", data)
    if pods * data * model != n:
        raise ValueError(
            f"mesh shape pods*data*model = {pods}*{data}*{model} = "
            f"{pods * data * model} must equal the device count {n}")
    if pods > 1:
        return ("pod", "data", "model"), (pods, data, model)
    return ("data", "model"), (data, model)


def make_host_mesh(data: Optional[int] = None, model: int = 1, *,
                   pods: int = 1, dp_backend: Optional[str] = None,
                   model_backend: Optional[str] = None) -> HostMesh:
    """The mesh over the ranks of the torch.distributed world (a world of
    one when no process group is initialized), with the reference's
    factor checks and messages. ``dp_backend`` / ``model_backend`` name
    the backends of the dp and the model groups (None: the default
    group's); a backend given for a size-one axis creates that group too,
    so that the exchange runs on it."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    names, shape = mesh_shape(n, data, model, pods=pods)
    pods, data, model = (shape if pods > 1 else (1,) + shape)
    rank = dist.get_rank() if dist.is_initialized() else 0
    n_dp = pods * data
    dp_index, model_index = divmod(rank, model)
    default = dist.get_backend() if dist.is_initialized() else None
    dp_group = model_group = None
    if model > 1 or dp_backend is not None:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(n_dp)],
                               backend=dp_backend)
            if m == model_index:
                dp_group = g
    if model > 1 or model_backend is not None:
        for d in range(n_dp):
            g = dist.new_group([d * model + m for m in range(model)],
                               backend=model_backend)
            if d == dp_index:
                model_group = g
    return HostMesh(
        names, shape, rank,
        dp_axis=Axis(dp_group, n_dp, dp_index),
        model_axis=Axis(model_group, model, model_index),
        world_axis=Axis(None, n, rank),
        backends={"dp": dp_backend or default,
                  "model": model_backend or default})
