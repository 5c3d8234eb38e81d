"""Checkpoint / resume (port of ``msckf_mono_tpu/parallel/checkpoint.py``).

The reference has no checkpointing: state lives in RAM. Here the whole
(batched) filter state is one tree of tensors, so a snapshot is exact and a
run resumes mid-sequence from any frame index.

A checkpoint is a directory of one file per global shard,
``shard-<k>-of-<n>.pt``: ``torch.save`` of a flat dict of CPU tensors keyed
by field path ("imu.q_IG", "P", ..., as ``core/types.filter_state_to_numpy``
keys them). It holds no class, so ``torch.load(..., weights_only=True)``
reads it. An unsharded state is one shard of one. Under a process group
each rank writes and reads the files of its own global shards.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import torch
import torch.distributed as dist

from msckf_mono_tpu_torch.core.types import _leaves
from msckf_mono_tpu_torch.parallel.sharding import Sharded


def _name(k: int, n: int) -> str:
    return f"shard-{k:05d}-of-{n:05d}.pt"


def _write(path: str, state) -> None:
    tmp = path + ".tmp"
    torch.save({key: x.detach().cpu() for key, x in _leaves(state)}, tmp)
    os.replace(tmp, path)


def save(path: str, state, step: int | None = None) -> str:
    """Save a FilterState (batched or not), or a :class:`Sharded` one, under
    ``path`` (``path/<step>`` with ``step``), overwriting an earlier save of
    the same shards. Returns the checkpoint's directory."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, str(step))
    os.makedirs(path, exist_ok=True)
    if not isinstance(state, Sharded):
        _write(os.path.join(path, _name(0, 1)), state)
        return path
    mesh = state.mesh
    for k, shard in zip(mesh.shard_ids, state.shards):
        _write(os.path.join(path, _name(k, mesh.size)), shard)
    if mesh.group is not None:
        dist.barrier(group=mesh.group)     # every rank's files are written before anyone reads
    return path


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _fill(template, arrays: dict, prefix: str = ""):
    """``template`` with each tensor leaf replaced by ``arrays[field path]``,
    on the leaf's device and in its dtype."""
    kw = {}
    for f in dataclasses.fields(template):
        x = getattr(template, f.name)
        key = prefix + f.name
        if dataclasses.is_dataclass(x):
            kw[f.name] = _fill(x, arrays, key + ".")
            continue
        a = arrays[key]
        if a.shape != x.shape:
            raise ValueError(f"checkpoint {key}: shape {tuple(a.shape)}, template {tuple(x.shape)}")
        kw[f.name] = a.to(device=x.device, dtype=x.dtype)
    return dataclasses.replace(template, **kw)


def restore(path: str, template):
    """Restore into the structure, dtypes and devices of ``template``.

    A :class:`Sharded` template restores shard by shard from its own global
    shards' files (the checkpoint must hold as many shards as its mesh); a
    plain one reads every shard and concatenates them on the batch axis.
    Runs before a scan, never inside one (the copies to the card are
    synchronous)."""
    path = os.path.abspath(path)
    if isinstance(template, Sharded):
        mesh = template.mesh
        shards = [_fill(t, _load(os.path.join(path, _name(k, mesh.size))))
                  for k, t in zip(mesh.shard_ids, template.shards)]
        return Sharded(shards, mesh, template.axis)
    files = sorted(glob.glob(os.path.join(path, "shard-*-of-*.pt")))
    if not files:
        raise FileNotFoundError(f"no checkpoint shards under {path}")
    n = int(files[0].rsplit("-of-", 1)[1][:-3])
    if [os.path.basename(f) for f in files] != [_name(k, n) for k in range(n)]:
        raise ValueError(f"{path}: expected the {n} files shard-*-of-{n:05d}.pt, found {files}")
    parts = [_load(f) for f in files]
    return _fill(template, {key: torch.cat([p[key] for p in parts]) for key in parts[0]})
