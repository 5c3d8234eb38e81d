"""The port's kernel build helpers and chip_smoke.py's KLT byte count, on the CPU.

* ``ops/cuda_build.build_all`` reuses a library built earlier together with
  the nvcc report kept beside it, without running nvcc, so a second smoke
  run in one checkout still gets every kernel's registers and spills;
  ``ptxas_usage`` reads registers, stack frame, spills and static shared
  memory from such a report.
* ``chip_smoke.klt_level_bytes`` (the bytes in the KLT bound): the pixels an
  LK level reads, a union of rectangles counted with a 2-D difference array,
  against painting each rectangle; exact.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.ops import cuda_build

PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z17klt_staged_kernelPKfS0_iiiS0_S0_PKbPfPbiiiiff' for 'sm_90a'
ptxas info    : Function properties for _Z17klt_staged_kernelPKfS0_iiiS0_S0_PKbPfPbiiiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_Z17klt_global_kernelPKf' for 'sm_90a'
ptxas info    : Function properties for _Z17klt_global_kernelPKf
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 56 registers, 32 bytes smem, 456 bytes cmem[0]
"""


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_all_reuses_libraries_and_their_reports(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise AssertionError("nvcc ran for a library that was built already")

    monkeypatch.setattr(cuda_build, "_nvcc", no_nvcc)
    for name in cuda_build.KERNELS:
        lib = cuda_build.library_path(name)
        assert lib.parent == tmp_path and lib.name.startswith(f"lib{name}_")
        lib.write_bytes(b"")
        cuda_build.log_path(name).write_text(f"{name}\n{PTXAS_REPORT}")
    logs = cuda_build.build_all()
    assert logs == {name: f"{name}\n{PTXAS_REPORT}" for name in cuda_build.KERNELS}
    assert len(cuda_build.ptxas_usage(logs["klt_level"])) == 2


def test_ptxas_usage_reads_every_instance():
    rows = cuda_build.ptxas_usage(PTXAS_REPORT)
    assert rows == [
        dict(kernel="_Z17klt_staged_kernelPKfS0_iiiS0_S0_PKbPfPbiiiiff", registers=64,
             stack_bytes=0, spill_stores=0, spill_loads=0, smem_bytes=0),
        dict(kernel="_Z17klt_global_kernelPKf", registers=56, stack_bytes=16, spill_stores=8,
             spill_loads=4, smem_bytes=32),
    ]


def _painted_pixels(Bi, H, W, pts, mask, reach):
    cover = np.zeros((Bi, H, W), bool)
    B, F = mask.shape
    for b in range(B):
        for f in range(F):
            if not mask[b, f]:
                continue
            x, y = pts[b, f]
            x0 = int(np.clip(np.floor(x - np.float32(reach)), 0, W - 2))
            x1 = int(np.clip(np.floor(x + np.float32(reach)), 0, W - 2)) + 1
            y0 = int(np.clip(np.floor(y - np.float32(reach)), 0, H - 2))
            y1 = int(np.clip(np.floor(y + np.float32(reach)), 0, H - 2)) + 1
            cover[b if Bi > 1 else 0, y0:y1 + 1, x0:x1 + 1] = True
    return int(cover.sum())


@pytest.mark.parametrize("Bi", [1, 3])
def test_klt_level_bytes_counts_the_pixels_read(Bi):
    smoke = _chip_smoke()
    rng = np.random.default_rng(Bi)
    B, F, H, W, window = 3, 9, 40, 57, 7
    pts_prev = np.stack([rng.uniform(-3, W + 3, size=(B, F)), rng.uniform(-3, H + 3, size=(B, F))],
                        -1).astype(np.float32)
    pts_prev[0, :3] = [[0.2, 0.4], [W - 1.5, H - 0.5], [20.0, 20.0]]
    pts_cur = (pts_prev + rng.normal(0, 2.0, size=pts_prev.shape)).astype(np.float32)
    valid = rng.uniform(size=(B, F)) < 0.7
    live = np.where(valid & (rng.uniform(size=(B, F)) < 0.6), 1, 0).astype(np.int32)
    img = torch.zeros(Bi, H, W)
    args = (img, img, torch.as_tensor(pts_prev), torch.as_tensor(pts_cur), torch.as_tensor(valid))
    nbytes, pixels = smoke.klt_level_bytes(args, window, torch.as_tensor(live))
    want = (_painted_pixels(Bi, H, W, pts_prev, valid, window // 2 + 1.0)
            + _painted_pixels(Bi, H, W, pts_cur, live > 0, float(window // 2)))
    assert pixels == want
    assert 0 < pixels < 2 * Bi * H * W
    assert nbytes == 4 * want + B * F * (2 * 8 + 1 + 8 + 1)
