"""Sharding of the filter batch over devices and processes (port of ``msckf_mono_tpu/parallel/sharding.py``).

The reference is strictly single-threaded; the scale-out axis is the batch
of independent filters (Monte-Carlo perturbations x sequences x parameter
grids). The JAX package shards it over a 1-D ``filters`` mesh of the devices
one process drives. PyTorch's idiom is one process per card under
``torch.distributed``; the port does both: a :class:`Mesh` is this process's
devices, in order, and optionally a process group. With ``world_size``
processes of ``len(devices)`` devices each, global shard ``k = rank *
len(devices) + i`` lives on this process's device ``i`` of process ``rank``.

The filters never talk to each other: the only communication is the metric
reduction of :func:`fleet_metrics` (all-reduces over the group, after the
run and outside any graph). Each shard's run is the graphed
``run_sequence`` on its own device (``ops/cuda_graph``).
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.distributed as dist

from msckf_mono_tpu_torch.core import filter as msckf_filter
from msckf_mono_tpu_torch.ops import cuda_graph
from msckf_mono_tpu_torch.utils.config import MsckfConfig

FILTER_AXIS = "filters"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's devices, in order, and the process group (``None``:
    this process alone)."""

    devices: tuple
    group: object = None
    rank: int = 0
    world_size: int = 1

    @property
    def size(self) -> int:
        """The global shard count."""
        return self.world_size * len(self.devices)

    @property
    def shard_ids(self) -> range:
        """The global shards this process holds, in the order of ``devices``."""
        n = len(self.devices)
        return range(self.rank * n, (self.rank + 1) * n)


@dataclasses.dataclass(eq=False)
class Sharded:
    """This process's shards of a global tree split on its batch ``axis``:
    ``shards[i]`` is global shard ``mesh.shard_ids[i]``, on ``mesh.devices[i]``."""

    shards: list
    mesh: Mesh
    axis: int = 0

    def gather(self, device=None):
        """This process's shards as one tree on ``device`` (default: the
        first shard's), concatenated in global order."""
        device = self.mesh.devices[0] if device is None else device
        per_shard = [cuda_graph.flatten(s)[0] for s in self.shards]
        _, structure = cuda_graph.flatten(self.shards[0])
        return cuda_graph.unflatten(structure, [
            torch.cat([x.to(device) for x in leaves], dim=self.axis) for leaves in zip(*per_shard)])


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices=None, group=None) -> Mesh:
    """The mesh of ``devices`` (default: every visible CUDA device) in
    ``group`` (default: the default group when ``torch.distributed`` is
    initialized, else none). A process that drives one of several cards
    passes its own, e.g. ``devices=[f"cuda:{local_rank}"]``; the CPU tests
    pass ``["cpu"] * 8``. Every process of the group must hold as many
    devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=['cpu'] to run on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(tuple(_device(d) for d in devices))
    return Mesh(tuple(_device(d) for d in devices), group, dist.get_rank(group),
                dist.get_world_size(group))


def _split(tree, mesh: Mesh, axis: int) -> Sharded:
    leaves, structure = cuda_graph.flatten(tree)
    B = leaves[0].shape[axis]
    if B % mesh.size:
        raise ValueError(f"a batch of {B} does not split into {mesh.size} equal shards")
    b = B // mesh.size

    def shard(k, device):
        return cuda_graph.unflatten(structure,
                                    [x.narrow(axis, k * b, b).to(device) for x in leaves])

    return Sharded([shard(k, d) for k, d in zip(mesh.shard_ids, mesh.devices)], mesh, axis)


def shard_batch(tree, mesh: Mesh) -> Sharded:
    """Split a global (B, ...) tree into ``mesh.size`` equal contiguous
    shards and keep this process's, each on its device (JAX's
    ``NamedSharding(mesh, P(FILTER_AXIS))``)."""
    return _split(tree, mesh, 0)


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` per local device, in the order of ``mesh.devices``."""
    leaves, structure = cuda_graph.flatten(tree)
    return [cuda_graph.unflatten(structure, [x.to(d) for x in leaves]) for d in mesh.devices]


def batched_step(config: MsckfConfig):
    """One frame step of (B,)-batched filters, ``step(states, frames) ->
    (states, FrameOutput)`` (``msckf_mono_tpu/parallel/sharding.py:43``
    under ``jax.jit``): a replayed graph on the card, fresh output tensors."""
    return cuda_graph.jit(msckf_filter.step, (config,))


def batched_run_sequence(config: MsckfConfig):
    """(B,)-batched filters through (T, B, ...) frame stacks (the graphed
    :func:`core.filter.run_sequence`)."""

    def run(states, frames):
        return msckf_filter.run_sequence(states, frames, config)

    return run


def _pos_cov_trace(states):
    return torch.diagonal(states.P[:, 12:15, 12:15], dim1=-2, dim2=-1).sum(-1)


def fleet_metrics(states, mesh: Mesh | None = None) -> dict:
    """Cross-filter summary statistics, 0-dim tensors.

    Without a mesh, of one (B, ...) state on its device. With a mesh (or a
    :class:`Sharded` state), of every global shard: each local shard's sums,
    count and maximum in f64, combined over the local shards and then
    all-reduced over the group (sums with ``SUM``, maxima with ``MAX``; a
    mean is the all-reduced sum over the all-reduced count), so every rank
    gets the same values, on its first device. Sums of f32 values in f64
    make a mean agree with the unsharded ``torch.mean`` to rounding only;
    totals and maxima are exact.
    """
    if mesh is None and not isinstance(states, Sharded):
        pos_cov_trace = _pos_cov_trace(states)
        return {
            "mean_pos_cov_trace": torch.mean(pos_cov_trace),
            "max_pos_cov_trace": torch.max(pos_cov_trace),
            "mean_cam_count": torch.mean(states.window.count.to(torch.float32)),
            "total_residualized": torch.sum(states.num_residualized),
            "total_row_overflow": torch.sum(states.diag.row_overflow),
            "total_staged_overflow": torch.sum(states.diag.staged_overflow),
        }
    shards = states.shards if isinstance(states, Sharded) else [states]
    mesh = states.mesh if mesh is None else mesh
    gloo = mesh.group is not None and dist.get_backend(mesh.group) == "gloo"
    where = torch.device("cpu") if gloo else mesh.devices[0]
    sums, maxima = [], []
    for s in shards:
        tr = _pos_cov_trace(s).double()
        sums.append(torch.stack([
            tr.sum(), tr.new_tensor(tr.shape[0]),
            s.window.count.double().sum(), s.num_residualized.double().sum(),
            s.diag.row_overflow.double().sum(), s.diag.staged_overflow.double().sum(),
        ]).to(where))
        maxima.append(tr.max().to(where))
    total = torch.stack(sums).sum(0)
    peak = torch.stack(maxima).max()
    if mesh.group is not None:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=mesh.group)
    out, dtype = mesh.devices[0], shards[0].P.dtype
    total, peak = total.to(out), peak.to(out)
    return {
        "mean_pos_cov_trace": (total[0] / total[1]).to(dtype),
        "max_pos_cov_trace": peak.to(dtype),
        "mean_cam_count": (total[2] / total[1]).to(torch.float32),
        "total_residualized": total[3].to(torch.int64),
        "total_row_overflow": total[4].to(torch.int64),
        "total_staged_overflow": total[5].to(torch.int64),
    }


def make_sharded_run(config: MsckfConfig, mesh: Mesh):
    """The sharded fleet runner, ``fleet_run(states, frames) -> (final,
    outputs, metrics)``.

    ``states``: a :class:`Sharded` (B, ...) state, or the global one (sharded
    here); ``frames``: the global (T, B, ...) stack (split on axis 1, JAX's
    ``P(None, FILTER_AXIS)``), or a :class:`Sharded` one. Every local shard
    runs the graphed ``run_sequence`` on its device. Shards on different
    devices step in turn frame by frame (``cuda_graph.scans``), so all of
    them are queued before the host waits on any; shards of one device run
    one after another, since equal shards share one cached graph. Returns
    this process's shards of the final state (axis 0) and of the outputs
    (axis 1), and the metrics of the whole fleet (:func:`fleet_metrics`,
    the same on every rank).
    """
    by_device: dict = {}
    for i, d in enumerate(mesh.devices):
        by_device.setdefault(d, []).append(i)
    rounds = [[i for i in r if i is not None] for r in itertools.zip_longest(*by_device.values())]

    def fleet_run(states, frames):
        if not isinstance(states, Sharded):
            states = shard_batch(states, mesh)
        if not isinstance(frames, Sharded):
            frames = _split(frames, mesh, 1)
        results = [None] * len(mesh.devices)
        for idx in rounds:
            done = cuda_graph.scans(msckf_filter.step, [states.shards[i] for i in idx],
                                    [frames.shards[i] for i in idx], (config,))
            for i, r in zip(idx, done):
                results[i] = r
        final = Sharded([r[0] for r in results], mesh, 0)
        outs = Sharded([r[1] for r in results], mesh, 1)
        return final, outs, fleet_metrics(final, mesh)

    return fleet_run
