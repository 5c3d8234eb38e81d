"""Shared fixtures for the port's tests (tests/test_torch_*.py).

Helpers to build matching JAX / PyTorch configurations, to carry a filter
state across the two packages as a dict of numpy arrays keyed by field path,
and to produce realistic mid-sequence states by running the port on the
synthetic world (cheap on the CPU, so JAX compiles only the function under
test).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from msckf_mono_tpu.core.types import init_filter_state as jax_init_filter_state
from msckf_mono_tpu.utils import config as jcfg
from msckf_mono_tpu_torch.core import filter as tfilter
from msckf_mono_tpu_torch.core.init import ground_truth_init
from msckf_mono_tpu_torch.core.types import filter_state_from_numpy, filter_state_to_numpy, init_filter_state
from msckf_mono_tpu_torch.data import synthetic as tsyn
from msckf_mono_tpu_torch.parallel.montecarlo import broadcast_frames
from msckf_mono_tpu_torch.utils import config as tcfg

CPU = "cpu"

# The port's CPU tensors here are small: intra-op threads only contend with
# the other test workers (each worker would otherwise start one per core).
torch.set_num_threads(1)

# __graft_entry__._tiny_config()'s shapes, and a variant with a window of 22
# slots so the hard-coded 20-state redundant prune (msckf.h:455) runs.
TINY_FILTER = dict(max_cam_states=6, min_track_length=3, fused_updates=True)
TINY_SHAPES = dict(num_slots=8, max_tracks=16, max_staged=4, max_staged_prune=8,
                   max_update_rows=32, max_features_per_frame=8, imu_per_frame=4)
SMALL_FILTER = dict(max_cam_states=20, min_track_length=3, max_track_length=8)
SMALL_SHAPES = dict(num_slots=22, max_tracks=32, max_staged=8, max_staged_prune=8,
                    max_update_rows=64, max_features_per_frame=16, imu_per_frame=4)
# bench.py's serving knobs at the small shapes.
SERVING_FILTER = dict(fused_updates=True, gating_precision="high")
SERVING_SHAPES = dict(prune_obs_cap=2, marg_obs_cap=6, prune_chunk=8, staged_chunk=4)

INIT = dict(p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0], v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4])


def configs(filter_kw=None, shapes_kw=None):
    """(JAX MsckfConfig, port MsckfConfig) with the same overrides."""
    f, s = dict(filter_kw or {}), dict(shapes_kw or {})
    j = jcfg.MsckfConfig(filter=jcfg.FilterConfig(**f), shapes=jcfg.ShapeConfig(**s))
    t = tcfg.MsckfConfig(filter=tcfg.FilterConfig(**f), shapes=tcfg.ShapeConfig(**s))
    return j, t


def small_configs(serving=False):
    f, s = dict(SMALL_FILTER), dict(SMALL_SHAPES)
    if serving:
        f.update(SERVING_FILTER)
        s.update(SERVING_SHAPES)
    return configs(f, s)


def tdtype(jdtype):
    return torch.float64 if jnp.dtype(jdtype) == jnp.float64 else torch.float32


def _key(path):
    return jax.tree_util.keystr(path).lstrip(".")


def jax_to_dict(tree, batched=True):
    """A JAX pytree of dataclasses as {field path: numpy array} (batch axis added if absent)."""
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(tree):
        x = np.asarray(x)
        out[_key(path)] = x if batched else x[None]
    return out


def jax_from_dict(arrays, template):
    """Rebuild a JAX pytree shaped like ``template`` from :func:`jax_to_dict` output."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(arrays[_key(p)]) for p, _ in paths])


def jax_state(arrays, jconfig, dtype):
    """Batched JAX FilterState from a port state dict."""
    return jax_from_dict(arrays, jax_init_filter_state(jconfig, dtype=dtype))


def port_state(arrays):
    return filter_state_from_numpy(arrays, device=CPU)


def sequence(tconfig, n_frames, seed=3):
    return tsyn.generate(tconfig, n_frames=n_frames, seed=seed, pixel_noise=0.5)


def port_initial_state(tconfig, seq, dtype=torch.float64):
    imu = ground_truth_init(**INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=dtype, device=CPU)
    return init_filter_state(tconfig, imu, dtype=dtype, device=CPU)


def port_frames(seq, dtype=torch.float64, batch=1):
    return broadcast_frames(tsyn.to_frame_inputs(seq, dtype, device=CPU), batch)


def port_snapshots(tconfig, n_frames, at, dtype=torch.float64, seed=3):
    """Run the port on the synthetic world; return (seq, frames, {t: state dict before frame t})."""
    seq = sequence(tconfig, n_frames, seed)
    frames = port_frames(seq, dtype)
    state = port_initial_state(tconfig, seq, dtype)
    snaps = {}
    for t in range(n_frames):
        if t in at:
            snaps[t] = filter_state_to_numpy(state)
        state, _ = tfilter.step(state, tfilter.frame_at(frames, t), tconfig)
    return seq, frames, snaps


def stack_dicts(dicts):
    """Concatenate state dicts along the batch axis."""
    return {k: np.concatenate([d[k] for d in dicts]) for k in dicts[0]}


def frame_arrays(frames, t):
    """Frame t of port frames as a dict of numpy arrays with the batch axis."""
    f = tfilter.frame_at(frames, t)
    return {k: v.numpy() for k, v in vars(f).items()}


def replace_config(cfg, **shapes):
    return dataclasses.replace(cfg, shapes=dataclasses.replace(cfg.shapes, **shapes))
