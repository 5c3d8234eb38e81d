"""CUDA graphs: the port's counterpart of ``jax.jit`` and ``lax.scan``.

The JAX package runs every entry point as one compiled program
(``lax.scan`` over frames, ``jax.jit`` of the step and of ``finish``). Here
a step is captured once into a ``torch.cuda.CUDAGraph`` and replayed:

* :class:`StepGraph` holds one function ``fn(carry, *xs, *static) -> (carry,
  y)`` for one set of input shapes. Its inputs live in static buffers; the
  graph writes the new carry back into the carry buffers, so one replay is
  one scan iteration and a carry that stays in the buffers is never copied.
  Per-call inputs are copied into their buffers before each replay.
* :func:`scan` (``lax.scan``) and :func:`jit` (``jax.jit``) run a function
  through a :class:`StepGraph` taken from a cache keyed by (function, static
  arguments, tree structure, shapes, dtypes, devices).
* :func:`disabled` is ``jax.disable_jit``'s counterpart: inside it,
  :func:`scan` and :func:`jit` run the function eagerly, for comparisons.

On CUDA tensors a capture succeeds or raises; nothing falls back to eager.
On CPU tensors a :class:`StepGraph` calls the same function directly on its
static buffers, as the kernels' plain versions serve the CPU, so the CPU
tests run the buffer and copy-back logic that the card replays.

Capture (``capture_error_mode="thread_local"``) is preceded by one warm-up
call on a side stream, on clones of the inputs: it fills the lazy caches
(the per-device constants of ``core/augment``, ``core/pipeline``, the
front-end's operators, the kernels' shared-memory attributes and occupancy
queries, library handles) so that nothing copies from the host or
synchronizes while the graph records. Warm-up advances no state.

Launch counts: each kernel wrapper counts its launches in Python, and a
replayed graph calls no Python. Warm-up's and capture's counts are undone;
the capture's count of each wrapper is kept as the graph's delta and added
on every replay, so the counts equal those of an eager run.

Host spans (``eval/profile.span``): ``graph.warm_up`` and ``graph.capture``
around a capture, ``graph.load`` and ``graph.replay`` in each call, and in
a scan ``scan.step`` (request id: the step's index) around ``scan.slice``,
the call and ``scan.stack``; a capture's spans name its function. :data:`captures`
counts the graphs captured.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading

import torch

from msckf_mono_tpu_torch.eval.profile import span
from msckf_mono_tpu_torch.ops import fast_cuda, klt_cuda, psd_cuda

# The wrappers whose ``.launches`` a replay adds to (the function objects
# hold the counts, see ops/psd_cuda.py).
LAUNCH_COUNTERS = (psd_cuda._GAMMA_PSD, fast_cuda._FAST_NMS_SCORE, klt_cuda._TRACK_LEVEL)

# Graphs captured in this process.
captures = 0

_STATE = threading.local()


@contextlib.contextmanager
def disabled():
    """Run :func:`scan`, :func:`jit` and the entry points built on them
    eagerly, as ``jax.disable_jit`` does; for comparisons only."""
    before = enabled()
    _STATE.disabled = True
    try:
        yield
    finally:
        _STATE.disabled = not before


def enabled() -> bool:
    return not getattr(_STATE, "disabled", False)


# ---- trees: dataclasses, tuples, lists and dicts of tensors ----

def flatten(tree):
    """(tensor leaves, structure). Non-tensor leaves (None, numbers,
    strings) are part of the structure, as static values."""
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return None
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return (type(x), tuple((f.name, walk(getattr(x, f.name)))
                                   for f in dataclasses.fields(x)))
        if isinstance(x, (tuple, list)):
            return (type(x), tuple(walk(v) for v in x))
        if isinstance(x, dict):
            return (dict, tuple((k, walk(x[k])) for k in sorted(x)))
        return ("static", x)

    return leaves, walk(tree)


def unflatten(structure, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, body = s
        if kind == "static":
            return body
        if kind is dict:
            return {k: build(v) for k, v in body}
        if kind in (tuple, list):
            return kind(build(v) for v in body)
        return kind(**{k: build(v) for k, v in body})

    return build(structure)


def _spec(leaves):
    return tuple((tuple(x.shape), x.dtype, x.device) for x in leaves)


# ---- launch bookkeeping ----

def counts(counters=LAUNCH_COUNTERS):
    return [c.launches for c in counters]


@contextlib.contextmanager
def counted_apart(counters=LAUNCH_COUNTERS):
    """Run the body with its launches set apart: yields a list that holds,
    on exit, each counter's launches made inside; the counts are restored."""
    before = counts(counters)
    delta = []
    try:
        yield delta
    finally:
        delta.extend(c.launches - b for c, b in zip(counters, before))
        for c, b in zip(counters, before):
            c.launches = b


def warm_up(fn, args, counters=LAUNCH_COUNTERS):
    """One call of ``fn`` on clones of ``args`` (a tuple of trees), on a side
    stream for CUDA tensors, with its launches set apart: the lazy caches
    fill, and no state advances and no count moves."""
    leaves, structure = flatten(args)
    clones = unflatten(structure, [x.clone() for x in leaves])
    cuda = [x for x in leaves if x.is_cuda]
    with counted_apart(counters):
        if not cuda:
            fn(*clones)
            return
        side = torch.cuda.Stream(cuda[0].device)
        side.wait_stream(torch.cuda.current_stream(cuda[0].device))
        with torch.cuda.stream(side):
            fn(*clones)
        torch.cuda.current_stream(cuda[0].device).wait_stream(side)


def _release_generator(device):
    """Take the device's default generator out of capture mode after a
    capture that failed: the failed capture never ran its epilogue, and
    every later random draw on the device would raise. A capture that
    succeeds runs prologue and epilogue again."""
    buf = torch.zeros((), device=device)
    with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=torch.cuda.Stream(device)):
        buf.add_(1)


# ---- the captured step ----

class StepGraph:
    """``fn(carry, *xs, *static) -> (new_carry, y)`` held for one set of
    input shapes.

    :meth:`__call__` copies each carry leaf that is not already its buffer
    and every ``xs`` leaf (from the host too) into the static buffers, all
    on the carry's device, replays (on the CPU: calls
    the function on the buffers), and returns (carry, y): the carry is the
    static carry buffers, which the next call updates in place, and ``y``
    holds until the next call. Copy what must outlive it.
    """

    def __init__(self, fn, carry, xs: tuple, static: tuple = (), counters=LAUNCH_COUNTERS):
        self.fn, self.static, self.counters = fn, tuple(static), counters
        c_leaves, self._c_struct = flatten(carry)
        x_leaves, self._x_struct = flatten(tuple(xs))
        # every buffer on the carry's device; host inputs (pinned staging
        # buffers) are copied in without blocking
        self.device = (c_leaves + x_leaves)[0].device
        self._c_bufs = [torch.empty_like(x) for x in c_leaves]
        self._x_bufs = [torch.empty_like(x, device=self.device) for x in x_leaves]
        self.carry = unflatten(self._c_struct, self._c_bufs)
        self._xs = unflatten(self._x_struct, self._x_bufs)
        self._storages = {b.untyped_storage().data_ptr() for b in self._c_bufs + self._x_bufs}
        self.graph = None
        self.delta = [0] * len(counters)
        self.replays = 0
        self._load(c_leaves, x_leaves)
        if self.device.type == "cuda":
            self._capture()
        else:
            self._y = None

    def _load(self, c_leaves, x_leaves):
        for buf, x in zip(self._c_bufs, c_leaves):
            if x is not buf:
                buf.copy_(x)
        for buf, x in zip(self._x_bufs, x_leaves):
            buf.copy_(x, non_blocking=True)

    def _body(self):
        """The function on the static buffers, then the new carry copied
        into the carry buffers. A result that shares memory with an input
        buffer (a field passed through, or a view of one) is cloned before
        any buffer is overwritten; a carry leaf that is its own buffer is
        left as it is."""
        new_carry, y = self.fn(self.carry, *self._xs, *self.static)
        new_leaves, struct = flatten(new_carry)
        if struct != self._c_struct:
            raise ValueError(f"{self.fn.__qualname__}: the carry changed structure")
        y_leaves, y_struct = flatten(y)

        def safe(x, own=None):
            if x is own or x.untyped_storage().data_ptr() not in self._storages:
                return x
            return x.clone()

        new_leaves = [safe(x, buf) for x, buf in zip(new_leaves, self._c_bufs)]
        y_leaves = [safe(x) for x in y_leaves]
        for buf, x in zip(self._c_bufs, new_leaves):
            if x is not buf:
                buf.copy_(x)
        return y_leaves, y_struct

    def _capture(self):
        global captures
        dev = self.device
        name = self.fn.__qualname__
        with torch.cuda.device(dev):
            with span("graph.warm_up", attrs={"graph": name}):
                warm_up(lambda c, *xs: self.fn(c, *xs, *self.static), (self.carry, *self._xs),
                        self.counters)
            side = torch.cuda.Stream(dev)
            self.graph = torch.cuda.CUDAGraph()
            # A graph that the cyclic collector frees during the capture (a
            # dropped step's graph in a reference cycle) would invalidate
            # it: CUDAGraph.reset is not permitted while a stream captures.
            collect = gc.isenabled()
            gc.disable()
            try:
                with span("graph.capture", attrs={"graph": name}), \
                        counted_apart(self.counters) as delta:
                    with torch.cuda.graph(self.graph, stream=side,
                                          capture_error_mode="thread_local"):
                        self._y = self._body()
            except BaseException:
                self.graph = None
                _release_generator(dev)
                raise
            finally:
                if collect:
                    gc.enable()
        self.delta = delta
        captures += 1

    def __call__(self, carry, *xs):
        c_leaves, c_struct = flatten(carry)
        x_leaves, x_struct = flatten(tuple(xs))
        if c_struct != self._c_struct or x_struct != self._x_struct:
            raise ValueError(f"{self.fn.__qualname__}: inputs do not match the captured structure")
        with span("graph.load"):
            self._load(c_leaves, x_leaves)
        with span("graph.replay"):
            if self.graph is None:
                y_leaves, y_struct = self._body()
            else:
                self.graph.replay()
                for c, d in zip(self.counters, self.delta):
                    c.launches += d
                y_leaves, y_struct = self._y
        self.replays += 1
        return self.carry, unflatten(y_struct, y_leaves)


_CACHE: dict = {}


def step_graph(fn, carry, xs: tuple, static: tuple = ()) -> StepGraph:
    """The cached :class:`StepGraph` of ``fn`` for these inputs' structure,
    shapes, dtypes and devices and these static arguments; captured on
    first use."""
    c_leaves, c_struct = flatten(carry)
    x_leaves, x_struct = flatten(tuple(xs))
    key = (fn, tuple(static), c_struct, _spec(c_leaves), x_struct, _spec(x_leaves))
    g = _CACHE.get(key)
    if g is None:
        g = _CACHE[key] = StepGraph(fn, carry, xs, static)
    return g


def clear_cache():
    """Drop every cached graph (and the memory its pool holds)."""
    _CACHE.clear()


def clone(tree):
    leaves, structure = flatten(tree)
    return unflatten(structure, [x.clone() for x in leaves])


def _at(tree, t):
    leaves, structure = flatten(tree)
    return unflatten(structure, [x[t] for x in leaves])


def scan(fn, carry, xs, static: tuple = ()):
    """``lax.scan``: ``fn(carry, x, *static) -> (carry, y)`` over the leading
    axis of every leaf of ``xs``; returns (final carry, ys stacked on a new
    leading axis). Replays one cached graph a step on CUDA tensors; eager
    under :func:`disabled`."""
    return scans(fn, [carry], [xs], static)[0]


def scans(fn, carries, xss, static: tuple = ()):
    """Several independent :func:`scan` runs, each carry on its own device,
    stepped in turn one frame at a time, so that every device has work
    queued before the host waits on any: returns a list of (final carry,
    ys).

    Two carries of equal shapes on one device would share one cached
    :class:`StepGraph` and its buffers, and stepping them in turn would
    overwrite one's carry with the other's: that raises. Run such scans
    one after another (each :func:`scan` ends by cloning its carry)."""
    devices = [flatten(c)[0][0].device for c in carries]
    if len(set(devices)) != len(devices):
        raise ValueError(f"scans: two carries on one device ({devices}); run them one after another")
    runs = [_scan_steps(fn, c, xs, static) for c, xs in zip(carries, xss)]
    results = [None] * len(runs)
    live = list(range(len(runs)))
    while live:
        for i in list(live):
            try:
                next(runs[i])
            except StopIteration as done:
                results[i] = done.value
                live.remove(i)
    return results


def _scan_steps(fn, carry, xs, static):
    """:func:`scan` as a generator that yields once a step is queued and
    returns (final carry, ys)."""
    x_leaves, _ = flatten(xs)
    T = x_leaves[0].shape[0]
    if not enabled():
        ys = []
        for t in range(T):
            with span("scan.step", request=t):
                with span("scan.slice"):
                    x = _at(xs, t)
                carry, y = fn(carry, x, *static)
            ys.append(y)
            yield
        y_leaves = [flatten(y)[0] for y in ys]
        return carry, unflatten(flatten(ys[0])[1], [torch.stack(c) for c in zip(*y_leaves)])

    g = None
    for t in range(T):
        with span("scan.step", request=t):
            with span("scan.slice"):
                x = _at(xs, t)
            if g is None:
                g = step_graph(fn, carry, (x,), static)
            carry, y = g(carry, x)
            with span("scan.stack"):
                y_leaves, y_struct = flatten(y)
                if t == 0:
                    stacks = [torch.empty((T,) + tuple(v.shape), dtype=v.dtype, device=v.device)
                              for v in y_leaves]
                for s, v in zip(stacks, y_leaves):
                    s[t].copy_(v)
        yield
    return clone(carry), unflatten(y_struct, stacks)


def _as_step(fn):
    """``fn(*args, *static) -> out`` as a step with an empty carry."""
    step = _STEPS.get(fn)
    if step is None:
        def step(carry, *args):
            return carry, fn(*args)
        step.__qualname__ = f"jit({fn.__qualname__})"
        step = _STEPS.setdefault(fn, step)
    return step


_STEPS: dict = {}


def jit(fn, static: tuple = ()):
    """``jax.jit``: a function of ``*args`` that replays ``fn(*args,
    *static)`` from a cached graph on CUDA tensors and returns fresh copies
    of its outputs; eager under :func:`disabled`."""
    def call(*args):
        if not enabled():
            return fn(*args, *static)
        g = step_graph(_as_step(fn), (), args, static)
        _, out = g((), *args)
        return clone(out)

    call.__qualname__ = f"jit({fn.__qualname__})"
    return call
