"""The port's checkpoint / resume (parallel/checkpoint.py), as
tests/test_checkpoint.py checks the JAX package's.

A sharded fleet (4 CPU shards, the small shapes) runs half the sequence, is
saved, restored into a fresh template and resumed: the restored state equals
the saved one and the resumed final equals the uninterrupted run, bit for
bit. Also: ``step=`` names the directory as JAX's does, every file loads with
``torch.load(weights_only=True)``, a plain template restores the whole fleet,
and a template of another shape raises.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.core.types import _leaves, filter_state_to_numpy, tree_map
from msckf_mono_tpu_torch.parallel import checkpoint, sharding
from msckf_mono_tpu_torch.parallel import montecarlo as tmc

from tests import _torch_port as tp

BATCH = 8
FRAMES = 8
_, TC = tp.small_configs()


def _assert_equal(a, b):
    for (k, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and x.device == y.device, k
        assert torch.equal(x, y), k


def test_checkpoint_resume_identical(tmp_path):
    seq = tp.sequence(TC, FRAMES, seed=0)
    imu = tp.port_initial_state(TC, seq, torch.float32).imu
    states = tmc.make_fleet(TC, imu, BATCH, dtype=torch.float32, device="cpu")
    frames = tp.port_frames(seq, torch.float32, BATCH)
    first = tree_map(lambda x: x[: FRAMES // 2], frames)
    second = tree_map(lambda x: x[FRAMES // 2:], frames)

    mesh = sharding.make_mesh(["cpu"] * 4)
    run = sharding.make_sharded_run(TC, mesh)
    states = sharding.shard_batch(states, mesh)

    final_ref, _, metrics = run(states, frames)
    assert int(metrics["total_residualized"]) > 0

    mid, _, _ = run(states, first)
    path = checkpoint.save(str(tmp_path / "ckpt"), mid, step=FRAMES // 2)
    assert path == os.path.join(str(tmp_path), "ckpt", str(FRAMES // 2))
    files = sorted(glob.glob(os.path.join(path, "*.pt")))
    assert [os.path.basename(f) for f in files] == [f"shard-{k:05d}-of-00004.pt" for k in range(4)]
    loaded = torch.load(files[1], map_location="cpu", weights_only=True)
    assert set(loaded) == set(filter_state_to_numpy(mid.shards[1]))
    np.testing.assert_array_equal(loaded["P"].numpy(), mid.shards[1].P.numpy())

    template = sharding.shard_batch(tree_map(torch.zeros_like, mid.gather()), mesh)
    restored = checkpoint.restore(path, template)
    for a, b in zip(restored.shards, mid.shards):
        _assert_equal(a, b)

    final_resumed, _, _ = run(restored, second)
    for a, b in zip(final_resumed.shards, final_ref.shards):
        _assert_equal(a, b)
    assert torch.equal(final_ref.gather().diag.updates_applied,
                       final_resumed.gather().diag.updates_applied)

    # a plain template reads every shard; a plain state saves as one shard of one
    whole = checkpoint.restore(path, tree_map(torch.zeros_like, mid.gather()))
    _assert_equal(whole, mid.gather())
    plain = checkpoint.save(str(tmp_path / "plain"), whole)
    assert os.listdir(plain) == ["shard-00000-of-00001.pt"]
    _assert_equal(checkpoint.restore(plain, tree_map(torch.zeros_like, whole)), whole)

    wrong = whole.replace(P=whole.P[:, :-1])
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(plain, wrong)


def test_restore_takes_the_templates_dtype(tmp_path):
    """As orbax restores into its target: the template's dtype and device."""
    seq = tp.sequence(TC, 2, seed=0)
    state = tp.port_initial_state(TC, seq, torch.float64)
    path = checkpoint.save(str(tmp_path), state)
    template = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32)
                        if x.is_floating_point() else torch.zeros_like(x), state)
    got = checkpoint.restore(path, template)
    assert got.P.dtype == torch.float32 and got.num_residualized.dtype == torch.int32
    np.testing.assert_array_equal(got.P.numpy(), state.P.float().numpy())
    assert dataclasses.fields(got) == dataclasses.fields(state)
