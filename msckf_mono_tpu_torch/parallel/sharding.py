"""Batched fleet runner on one device (port of ``msckf_mono_tpu/parallel/sharding.py``).

The JAX package shards the filter batch over a device mesh; the port runs the
whole batch on one device (every tensor already carries the batch axis). On
the card the step and the sequence replay captured CUDA graphs
(``ops/cuda_graph``), as the JAX ones run under ``jax.jit``.

Not ported yet: multi-device sharding (``make_mesh``, ``shard_batch``,
``make_sharded_run``).
"""

from __future__ import annotations

import torch

from msckf_mono_tpu_torch.core import filter as msckf_filter
from msckf_mono_tpu_torch.ops import cuda_graph
from msckf_mono_tpu_torch.utils.config import MsckfConfig


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


def fleet_metrics(states) -> dict:
    """Cross-filter summary statistics (0-dim tensors on the state's device)."""
    pos_cov_trace = torch.diagonal(states.P[:, 12:15, 12:15], dim1=-2, dim2=-1).sum(-1)
    return {
        "mean_pos_cov_trace": torch.mean(pos_cov_trace),
        "max_pos_cov_trace": torch.max(pos_cov_trace),
        "mean_cam_count": torch.mean(states.window.count.to(torch.float32)),
        "total_residualized": torch.sum(states.num_residualized),
        "total_row_overflow": torch.sum(states.diag.row_overflow),
        "total_staged_overflow": torch.sum(states.diag.staged_overflow),
    }
