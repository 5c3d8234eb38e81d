"""Per-stage timing (port of ``msckf_mono_tpu/eval/timing.py``).

The device-side replacement for the reference's TSTART/TEND/TRECORD
wall-clock macros and the ``StageTiming`` message (datasets/asl_msckf.cpp:
207-296, msg/StageTiming.msg).

Measurement, as the JAX package's in-scan repetition: each stage is called
``reps`` times in a chain (each call's output state feeds the next), the
chain is captured in ONE CUDA graph (``ops/cuda_graph``), and the graph's
replay is timed with CUDA events and divided by ``reps``: device time per
call, the host's dispatch outside it. On the CPU the chain runs eagerly,
timed by the host clock.
"""

from __future__ import annotations

import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from msckf_mono_tpu_torch.core import augment, prune, tracks, update
from msckf_mono_tpu_torch.core import filter as msckf_filter
from msckf_mono_tpu_torch.ops import cuda_graph
from msckf_mono_tpu_torch.utils.config import MsckfConfig

STAGES = (
    "imu_prop",
    "augment_state",
    "update",
    "add_features",
    "marginalize",
    "prune_redundant",
    "prune_empty_states",
    "full_step",
)


def _stage_fns(config: MsckfConfig):
    """{stage: (fn(state, *rest) -> state, index of rest: frame or staged)}."""
    return {
        "imu_prop": (lambda s, f: msckf_filter.propagate_block(s, f, config), "frame"),
        "augment_state": (lambda s, f: augment.augment_state(s, f.state_id, f.time, config), "frame"),
        "update": (lambda s, f: tracks.update_tracks(s, f.tracked_uv, f.tracked_ids,
                                                     f.tracked_valid, config)[0], "frame"),
        "add_features": (lambda s, f: tracks.add_features(s, f.new_uv, f.new_ids, f.new_valid,
                                                          config), "frame"),
        "marginalize": (lambda s, st: update.marginalize(s, st, config), "staged"),
        "prune_redundant": (lambda s: prune.prune_redundant_states(s, config), None),
        "prune_empty_states": (lambda s: prune.prune_empty_states(s, config), None),
        "full_step": (lambda s, f: msckf_filter.step(s, f, config)[0], "frame"),
    }


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor operand and result of every operator
    that is not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            leaves, _ = cuda_graph.flatten((args, kwargs or {}, out))
            self.bytes += sum(t.numel() * t.element_size() for t in leaves)
        return out


def _cost(fn, args):
    """(flops, bytes) of one eager call (see :func:`stage_timing`)."""
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter()
    with cuda_graph.counted_apart(), flops, nbytes:
        fn(*cuda_graph.clone(args))
    return float(flops.get_total_flops()), float(nbytes.bytes)


def stage_timing(state, frame, staged, config: MsckfConfig, reps: int = 10, cost: bool = False):
    """Times each stage on the state's device. Returns {stage: seconds}, or
    {stage: (seconds, flops, bytes_accessed)} with ``cost=True``.

    ``state``/``frame``/``staged`` carry the filter-batch axis. The time is
    device time per call (``reps`` >= 4 chained calls in one replayed CUDA
    graph, CUDA events); on the CPU, host time per call of the eager chain.

    ``cost=True`` counts one eager call by hand (XLA's cost analysis has no
    counterpart):

    * bytes accessed: the sum of every operator's operand and result bytes,
      XLA's own definition, over every operator that is not a view;
    * flops: ``torch.utils.flop_counter.FlopCounterMode``, which counts the
      matrix-product family only (mm, bmm, addmm, baddbmm, convolutions,
      attention). The linear-algebra calls (Cholesky, triangular solves,
      QR) and elementwise work are not counted.

    The hand-written kernels are called through ctypes, outside PyTorch's
    dispatcher: on the card neither count sees their reads or arithmetic,
    only the allocation of their outputs.

    Launch counts are left as they were.
    """
    reps = max(reps, 4)
    rest_of = {"frame": (frame,), "staged": (staged,), None: ()}
    out = {}
    with cuda_graph.counted_apart():
        for name in STAGES:
            fn, which = _stage_fns(config)[name]
            args = (state, *rest_of[which])
            dt = _time_chain(fn, args, reps)
            out[name] = (dt, *_cost(fn, args)) if cost else dt
    return out


def _time_chain(fn, args, reps):
    """Seconds per call of ``reps`` chained calls of ``fn``."""
    def chained(carry, s, *rest):
        for _ in range(reps):
            s = fn(s, *rest)
        return carry, s

    if args[0].P.device.type != "cuda":
        chained((), *cuda_graph.clone(args))          # warm-up
        t0 = time.perf_counter()
        chained((), *args)
        return (time.perf_counter() - t0) / reps
    graph = cuda_graph.StepGraph(chained, (), args)
    graph((), *args)                                  # loads the inputs; first replay
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps
