#!/usr/bin/env python3
"""Time the port's γ-gate, FAST-10+NMS and LK-level kernels on one NVIDIA GPU.

    python3 tools/kernel_ab.py [--label NAME]
    PYTHONPATH=/path/to/other/checkout python3 tools/kernel_ab.py --label parent

Times whichever ``msckf_mono_tpu_torch`` is first on the path, so two
checkouts (a parent and its change) can be compared in one run on one
card: run parent, change, change, parent. Each kernel is timed two ways at
the main paths' shapes, by chip_smoke.py's timers (this checkout's):

* ``ms``: CUDA events around one wrapper call (the median of 25 after two
  warm-up calls): the host's launch work included, as a lone call pays it;
* ``device_ms``: device time per launch, from a CUDA graph of 20 back-to-back
  wrapper calls replayed 5 times (CUDA events around each replay; the median).

γ runs on S = XXᵀ/R + 1e-5 I (X of R × (R + 4), seed 0) at (R, n) = (41, 8192)
and (1, 49152) (the filter path's marginalize and prune gates at 1024
filters) and (41, 2048), (1, 12288) (the image path's, at 256 filters). FAST
runs at threshold 20 on rendered frame 30 of the image path's world at
(1, 480, 752), on the same frame x64 with the 64-stream path's brightness
offsets, and on uniform noise (the pre-test's worst case). KLT
runs the four pyramid levels of rendered frames 30 → 31 of the image path's
world (window 21, 30 iterations, eps 1 px), 256 filters × 64 features at
detected corners with 0.5 px jitter and a 1.5 px prediction error, 90% valid:
the shared camera (Bi = 1) and, at 64 filters, per-stream images (Bi = B).
Each KLT level is also timed with ``max_iters = 0`` (the template pass
alone), and its live Gauss-Newton iterations are counted by the plain
version. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if __package__ in (None, ""):
    sys.path.append(str(ROOT))


def _smoke():
    """This checkout's chip_smoke.py (its timers), whichever package is on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rendered_frames(torch):
    """Frames 30 and 31 of the image path's world, (2, 480, 752) on the card."""
    from msckf_mono_tpu_torch.data import render, synthetic
    from msckf_mono_tpu_torch.utils.config import MsckfConfig

    cfg = MsckfConfig()
    _, world = synthetic.generate(cfg, n_frames=32, seed=0, pixel_noise=0.0, n_landmarks=500,
                                  return_world=True)
    return torch.as_tensor(np.stack([render.render_frame(cfg, world, i) for i in (30, 31)]),
                           device="cuda")


def fast_images(torch, imgs):
    """FAST's three images: rendered frame 30, the same frame x64 with the
    64-stream path's brightness offsets (b mod 7) * 0.5, and chip_smoke.py's
    uniform noise (seed 1)."""
    frame = imgs[:1]
    noise = np.random.default_rng(1).uniform(0, 255, size=(1, 480, 752)).astype(np.float32)
    return (("rendered", frame),
            ("rendered x64", (frame + 0.5 * (torch.arange(64, device="cuda") % 7)[:, None, None])
             .contiguous()),
            ("random", torch.as_tensor(noise, device="cuda")))


def klt_launches(torch, imgs, B, shared, seed=1):
    """The four level launches of frames 30 -> 31: (args, kwargs) each."""
    from msckf_mono_tpu_torch.frontend import detect, klt

    pyr0, pyr1 = klt.build_pyramid(imgs[:1], 3), klt.build_pyramid(imgs[1:], 3)
    xy, _, ok = detect.detect_features(imgs[:1], torch.zeros(1, 100, dtype=torch.bool,
                                                              device="cuda"))
    corners = xy[0][ok[0]].cpu().numpy()
    rng = np.random.default_rng(seed)
    F = 64
    pts0 = corners[rng.integers(0, len(corners), size=(B, F))] + rng.normal(0, 0.5, size=(B, F, 2))
    pred0 = pts0 + rng.normal(0, 1.5, size=(B, F, 2))
    valid = torch.as_tensor(rng.uniform(size=(B, F)) < 0.9, device="cuda")
    offs = 0.5 * (torch.arange(B, device="cuda") % 7)[:, None, None]
    out = []
    for lvl in range(4):
        s = 2.0 ** lvl
        p0 = pyr0[lvl] if shared else (pyr0[lvl] + offs).contiguous()
        p1 = pyr1[lvl] if shared else (pyr1[lvl] + offs).contiguous()
        pts = torch.as_tensor(pts0 / s, dtype=torch.float32, device="cuda")
        pred = torch.as_tensor(pred0 / s, dtype=torch.float32, device="cuda")
        out.append(((p0, p1, pts, pred, valid),
                    dict(window_size=21, max_iters=30, eps=1.0, min_eigen_threshold=1e-5)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--kernels", default="gamma,fast,klt",
                    help="comma-separated subset of gamma, fast, klt")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tools/kernel_ab.py needs an NVIDIA GPU")
    import msckf_mono_tpu_torch
    from msckf_mono_tpu_torch.ops import fast_cuda, klt_cuda, psd_cuda

    smoke = _smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    result = dict(label=args.label, package=str(Path(msckf_mono_tpu_torch.__file__).parent),
                  card=card, gamma=[], fast=[], klt=[])
    kernels = set(args.kernels.split(","))
    rng = np.random.default_rng(0)
    for R, n in ((41, 8192), (1, 49152), (41, 2048), (1, 12288)) if "gamma" in kernels else ():
        S, r = smoke._make_systems(torch, rng, n, R)
        row = dict(R=R, n=n, ms=smoke._time_ms(torch, lambda: psd_cuda.gamma_psd(S, r)),
                   device_ms=smoke._graph_ms(torch, lambda: psd_cuda.gamma_psd(S, r)))
        result["gamma"].append(row)
        print(f"[kernel_ab] {args.label} gamma {row}", file=sys.stderr, flush=True)

    imgs = rendered_frames(torch)
    for name, t in fast_images(torch, imgs) if "fast" in kernels else ():
        row = dict(image=name, shape=list(t.shape),
                   ms=smoke._time_ms(torch, lambda: fast_cuda.fast_nms_score(t, 20.0)),
                   device_ms=smoke._graph_ms(torch, lambda: fast_cuda.fast_nms_score(t, 20.0)))
        result["fast"].append(row)
        print(f"[kernel_ab] {args.label} fast {row}", file=sys.stderr, flush=True)

    for shared, B in ((True, 256), (False, 64)) if "klt" in kernels else ():
        for lvl, (largs, kw) in enumerate(klt_launches(torch, imgs, B, shared)):
            row = dict(path="shared" if shared else "per-stream", B=B, level=lvl,
                       shape=list(largs[0].shape),
                       ms=smoke._time_ms(torch, lambda: klt_cuda.track_level(*largs, **kw)),
                       device_ms=smoke._graph_ms(torch, lambda: klt_cuda.track_level(*largs, **kw)))
            nz = dict(kw, max_iters=0)
            row["template_only_device_ms"] = smoke._graph_ms(
                torch, lambda: klt_cuda.track_level(*largs, **nz))
            _, good, live = klt_cuda.track_level_plain(*largs, **kw, count_iters=True)
            row.update(valid=int(largs[4].sum()), good=int(good.sum()),
                       live_iters=int(live.sum()), max_live=int(live.max()))
            result["klt"].append(row)
            print(f"[kernel_ab] {args.label} klt {row}", file=sys.stderr, flush=True)
    for path in ("shared", "per-stream"):
        rows = [k for k in result["klt"] if k["path"] == path]
        if not rows:
            continue
        result[f"klt_{path}_frame_ms"] = sum(k["ms"] for k in rows)
        result[f"klt_{path}_frame_device_ms"] = sum(k["device_ms"] for k in rows)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
