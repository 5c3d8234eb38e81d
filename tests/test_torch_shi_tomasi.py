"""The Shi-Tomasi route of the port's corner detection on the CPU, and its kernel's source.

* On the CPU, ``detect.detect_features`` and ``detect.shi_tomasi_score`` take
  the plain version (``ops/shi_tomasi_cuda``) and equal, bit for bit, the
  code path they had before the kernel existed: the frozen copy of the
  port's plain front-end in ``portbench/reference/msckf`` (the benchmark's
  reference), in float32 and float64, at Bi in {1, 3} with per-filter
  occupancy, at both precision tiers.
* ``shi_tomasi_cuda.shi_tomasi_cells`` on CPU tensors is its plain version
  and raises on shapes and sizes it does not take.
* No ``__global__`` function of ``csrc/shi_tomasi.cu`` has a name that the
  benchmark's device trace (``portbench/harness/trace.KERNEL_PREFIXES``)
  would count as the γ, FAST or KLT kernel's.
"""

import re

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.frontend import detect
from msckf_mono_tpu_torch.ops import cuda_build, fast_cuda, shi_tomasi_cuda
from portbench.harness import trace
from portbench.reference.msckf.frontend import detect as reference

from tests.test_torch_image_cuda import _smooth_image

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _images(Bi, seed, H=120, W=188):
    """Smooth images with planted corners, and noise: marked cells of every kind."""
    rng = np.random.default_rng(seed)
    imgs = []
    for b in range(Bi):
        img = _smooth_image(rng, (H, W))
        for y, x in rng.integers(8, min(H, W) - 8, size=(12, 2)):
            img[y - 2 : y + 3, x - 2 : x + 3] = 5.0
            img[y, x] = 255.0
        if b % 2:
            img += rng.uniform(0, 30, size=img.shape).astype(np.float32)
        imgs.append(img)
    return np.stack(imgs)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("Bi", [1, 3])
def test_detect_features_cpu_route_is_bit_equal(Bi, dtype, precision):
    rng = np.random.default_rng(Bi)
    img = torch.as_tensor(_images(Bi, Bi + 10), dtype=DTYPES[dtype])
    occ = torch.as_tensor(rng.uniform(size=(3, 100)) < np.array([[0.0], [0.3], [0.7]]))
    got = detect.detect_features(img, occ, 10, 10, 20.0, 40.0, st_precision=precision)
    want = reference.detect_features(img, occ, 10, 10, 20.0, 40.0, st_precision=precision)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(got[2][0].sum()) > int(got[2][2].sum()) > 0


@pytest.mark.parametrize("halfbox", [15, 7])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_shi_tomasi_score_cpu_route_is_bit_equal(dtype, halfbox):
    img = torch.as_tensor(_images(3, 4), dtype=DTYPES[dtype])
    for precision in ("highest", "default"):
        got = detect.shi_tomasi_score(img, halfbox, precision)
        assert torch.equal(got, reference.shi_tomasi_score(img, halfbox, precision))
    assert float(got.abs().max()) > 0


@pytest.mark.parametrize("halfbox,n_rows,n_cols", [(15, 10, 10), (7, 8, 12), (15, 1, 1)])
def test_shi_tomasi_cells_on_the_cpu_is_the_plain_version(halfbox, n_rows, n_cols):
    img = torch.as_tensor(_images(2, 5))
    nms = fast_cuda.fast_nms_score(img, 20.0)
    before = shi_tomasi_cuda.shi_tomasi_cells.launches
    best, local = shi_tomasi_cuda.shi_tomasi_cells(img, nms, halfbox, n_rows, n_cols)
    assert shi_tomasi_cuda.shi_tomasi_cells.launches == before
    want = shi_tomasi_cuda.cell_best_plain(detect.shi_tomasi_score(img, halfbox), nms, n_rows,
                                           n_cols)
    assert torch.equal(best, want[0]) and torch.equal(local, want[1])
    assert best.shape == (2, n_rows * n_cols) and local.dtype == torch.int64
    assert bool((best > 40).any()) and bool((best >= -1).all())


def test_shi_tomasi_cells_rejects_what_it_does_not_take():
    img = torch.as_tensor(_images(1, 6))
    nms = fast_cuda.fast_nms_score(img, 20.0)
    with pytest.raises(ValueError):
        shi_tomasi_cuda.shi_tomasi_cells(img[0], nms[0])
    with pytest.raises(ValueError):
        shi_tomasi_cuda.shi_tomasi_cells(img, nms[:, :-1])
    with pytest.raises(ValueError):
        shi_tomasi_cuda.shi_tomasi_cells(img, nms, halfbox=0)
    with pytest.raises(ValueError):
        shi_tomasi_cuda.shi_tomasi_cells(img, nms, n_rows=0)


def _global_functions(src: str):
    """Names of the ``__global__`` functions a CUDA source defines."""
    return re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s+)?(?:void\s+)?"
                      r"([A-Za-z_]\w*)\s*\(", src)


def test_kernel_names_match_no_counted_prefix():
    src = cuda_build.source("shi_tomasi").read_text()
    names = _global_functions(src)
    assert names == ["shi_tomasi_cells_kernel"]
    assert trace.KERNEL_PREFIXES and all(trace.kernel_of(f"void (anonymous namespace)::{n}(float "
                                                         "const*, float const*)") is None
                                         for n in names)
    for name in names:
        assert not any(p in name for p in trace.KERNEL_PREFIXES.values())
    # the parser finds the other sources' kernels, which the prefixes do count
    fast = _global_functions(cuda_build.source("fast_nms").read_text())
    assert fast and all(trace.kernel_of(f"void {n}<true>(float const*)") == "fast" for n in fast)
