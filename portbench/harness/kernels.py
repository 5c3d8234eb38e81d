"""Each hand-written kernel's launches, recorded with their rooflines.

While on, :class:`KernelRecorder` stands a wrapper in for each of the
program's kernel entry points in its module (``ops/psd_cuda.gamma_psd``,
``ops/fast_cuda.fast_nms_score``, ``ops/klt_cuda.track_level``), which the
program calls through the module; each launch records what its bound needs.
A replayed CUDA graph calls no Python, so the recorded steps run eagerly.
"""

from __future__ import annotations

import collections

from portbench.harness import roofline


class KernelRecorder:
    def __init__(self):
        from msckf_mono_tpu_torch.ops import fast_cuda, klt_cuda, psd_cuda

        self.mods = dict(gamma=(psd_cuda, "gamma_psd"), fast=(fast_cuda, "fast_nms_score"),
                         klt=(klt_cuda, "track_level"))
        self.orig = {k: getattr(m, a) for k, (m, a) in self.mods.items()}
        self.launches = collections.defaultdict(list)

    def on(self):
        o, rec = self.orig, self.launches

        def gamma(Smat, r):
            rec["gamma"].append(("gamma", tuple(Smat.shape)))
            return o["gamma"](Smat, r)

        def fast(imgs, threshold=20.0):
            rec["fast"].append(("fast", imgs.clone(), threshold))
            return o["fast"](imgs, threshold)

        def klt(*args, **kw):
            rec["klt"].append(("klt", tuple(a.clone() for a in args), dict(kw)))
            return o["klt"](*args, **kw)

        for k, f in dict(gamma=gamma, fast=fast, klt=klt).items():
            mod, attr = self.mods[k]
            setattr(mod, attr, f)

    def off(self):
        for k, (mod, attr) in self.mods.items():
            setattr(mod, attr, self.orig[k])

    def bounds_s(self, kernel):
        """The bound of each recorded launch of ``kernel``, in launch order."""
        out = []
        for rec in self.launches.get(kernel, []):
            if rec[0] == "gamma":
                out.append(roofline.gamma_bound_s(rec[1]))
            elif rec[0] == "fast":
                out.append(roofline.fast_bound_s(rec[1], rec[2]))
            else:
                out.append(roofline.klt_bound_s(rec[1], rec[2]))
        return out


def shares(recorder, events_of, log):
    """{kernel: (Σ bound / Σ device time, launches)} over the recorded
    launches, each matched in order to its own device event:
    ``events_of(kernel, n)`` gives the n device events (name, start, end)
    that are the recorded launches, or None where the trace does not hold
    them; such a kernel gets no share, and the log says so."""
    out = {}
    for kernel in ("gamma", "fast", "klt"):
        bounds = recorder.bounds_s(kernel)
        if not bounds:
            continue
        events = events_of(kernel, len(bounds))
        if events is None or len(events) != len(bounds):
            log(f"[kernels] {kernel}: {len(bounds)} launches recorded, their device events not "
                f"found in the trace: no roofline")
            continue
        out[kernel] = (sum(bounds) / (sum(e - s for _, s, e in events) / 1e6), len(bounds))
    return out
