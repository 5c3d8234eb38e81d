"""The port's dataset layer against the JAX package's, on the CPU.

* The YAML-subset reader (``data/asl._load_yaml``) against PyYAML's
  ``yaml.safe_load`` (through the JAX package's reader, which strips the
  OpenCV directive and tag) on EuRoC, ASL-writer and OpenCV-style files:
  equal values and types.
* The PNG codec (``data/png.py``) against PIL on gray, RGB and RGBA images
  with every row filter, both ways: PIL reads what the codec writes and the
  codec reads what PIL writes, pixel-equal; its gray conversion equal to the
  native library's (libpng's) where that builds.
* The port's ``asl``, ``sync`` and ``penncosy`` readers on trees the JAX
  package's writers wrote: equal to the JAX readers' outputs; the port's
  writers read back by the JAX readers: equal, images bit-equal to the
  rendered frames.
* The native library built from ``native/loader.cpp`` (where it builds) and
  the numpy fallback give the same CSVs and images.
"""

import dataclasses
import os

import numpy as np
import pytest

from msckf_mono_tpu.data import asl as jasl
from msckf_mono_tpu.data import penncosy as jpcv
from msckf_mono_tpu.data import sync as jsync
from msckf_mono_tpu.data import synthetic as jsyn
from msckf_mono_tpu.data import write_asl as jwrite_asl
from msckf_mono_tpu.data import write_penncosy as jwrite_pcv
from msckf_mono_tpu.utils import config as jcfg
from msckf_mono_tpu_torch.data import asl as tasl
from msckf_mono_tpu_torch.data import native_loader as tnative
from msckf_mono_tpu_torch.data import penncosy as tpcv
from msckf_mono_tpu_torch.data import png
from msckf_mono_tpu_torch.data import render as trender
from msckf_mono_tpu_torch.data import sync as tsync
from msckf_mono_tpu_torch.data import synthetic as tsyn
from msckf_mono_tpu_torch.data import write_asl as twrite_asl
from msckf_mono_tpu_torch.data import write_penncosy as twrite_pcv
from msckf_mono_tpu_torch.utils import config as tcfg

from tests import _torch_port as tp  # noqa: F401  (one intra-op thread)
from tests.test_torch_live import SMALL_CAMERA

N_FRAMES = 6

EUROC_CAM = """%YAML:1.0
# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""

EUROC_IMU = """#Default imu sensor yaml file
sensor_type: imu
comment: VI-Sensor IMU (ADIS16448)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [1.0, 0.0, 0.0, 0.0,
         0.0, 1.0, 0.0, 0.0,
         0.0, 0.0, 1.0, 0.0,
         0.0, 0.0, 0.0, 1.0]
rate_hz: 200

# inertial sensor noise model parameters (static)
gyroscope_noise_density: 1.6968e-04     # [ rad / s / sqrt(Hz) ]   ( gyro "white noise" )
gyroscope_random_walk: 1.9393e-05       # [ rad / s^2 / sqrt(Hz) ] ( gyro bias diffusion )
accelerometer_noise_density: 2.0000e-3  # [ m / s^2 / sqrt(Hz) ]   ( accel "white noise" )
accelerometer_random_walk: 3.0000e-3    # [ m / s^3 / sqrt(Hz) ].  ( accel bias diffusion )
"""

OPENCV = """%YAML:1.0
---
T_BS: !!opencv-matrix
   rows: 4
   cols: 4
   dt: d
   data: [ 1., 0., 0., 5.0000000000000003e-02, 0., 1., 0., 1.0e-02,
       0., 0., 1., -2.0000000000000001e-02, 0., 0., 0., 1. ]
rate_hz: 20
resolution: [ 752, 480 ]
intrinsics: [ 4.6e+02, 459., 370., 240. ]
distortion_model: "radtan"
distortion_coefficients: [ -0.29, 8.0e-02, 0., 0. ]
use_it: true
nothing: ~
"""


def _small_configs():
    j = jcfg.MsckfConfig(camera=jcfg.CameraConfig(**SMALL_CAMERA))
    t = tcfg.MsckfConfig(camera=tcfg.CameraConfig(**SMALL_CAMERA))
    return j, t


def _assert_same(got, want, path=""):
    assert type(got) is type(want), f"{path}: {type(got)} != {type(want)}"
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


# ---- YAML ----

@pytest.fixture(scope="module")
def written_trees(tmp_path_factory):
    """The same small world written by both packages' writers, ASL and
    PennCOSYVIO layouts."""
    jc, tc = _small_configs()
    jseq, jworld = jsyn.generate(jc, n_frames=N_FRAMES, seed=3, pixel_noise=0.0, n_landmarks=500,
                                 return_world=True)
    tseq, tworld = tsyn.generate(tc, n_frames=N_FRAMES, seed=3, pixel_noise=0.0, n_landmarks=500,
                                 return_world=True)
    roots = {k: str(tmp_path_factory.mktemp(k)) for k in ("j_asl", "t_asl", "j_pcv", "t_pcv")}
    info = jwrite_asl.write_sequence(roots["j_asl"], jc, jseq, jworld)
    assert twrite_asl.write_sequence(roots["t_asl"], tc, tseq, tworld)["t0_ns"] == info["t0_ns"]
    jwrite_pcv.write_sequence(roots["j_pcv"], jc, jseq, jworld)
    twrite_pcv.write_sequence(roots["t_pcv"], tc, tseq, tworld)
    imgs = [trender.render_frame(tc, tworld, i).astype(np.uint8) for i in range(N_FRAMES)]
    return roots, imgs


@pytest.mark.parametrize("name", ["euroc_cam", "euroc_imu", "opencv", "t_asl_cam", "t_asl_imu",
                                  "t_pcv_left", "j_pcv_left"])
def test_yaml_reader_matches_pyyaml(tmp_path, written_trees, name):
    roots, _ = written_trees
    files = {
        "t_asl_cam": os.path.join(roots["t_asl"], "cam0", "sensor.yaml"),
        "t_asl_imu": os.path.join(roots["t_asl"], "imu0", "sensor.yaml"),
        "t_pcv_left": os.path.join(roots["t_pcv"], "data", "visensor", "af", "left.yaml"),
        "j_pcv_left": os.path.join(roots["j_pcv"], "data", "visensor", "af", "left.yaml"),
    }
    if name in files:
        path = files[name]
    else:
        path = str(tmp_path / f"{name}.yaml")
        with open(path, "w") as f:
            f.write({"euroc_cam": EUROC_CAM, "euroc_imu": EUROC_IMU, "opencv": OPENCV}[name])
    want = jasl._load_yaml(path)
    got = tasl._load_yaml(path)
    _assert_same(got, want)
    assert isinstance(want, dict) and "T_BS" in want


# ---- PNG ----

def _image(rng, shape):
    """Smooth gradients plus noise: every row filter has work to do."""
    H, W = shape[:2]
    base = np.add.outer(np.arange(H) * 3, np.arange(W) * 5)
    if len(shape) == 3:
        base = base[..., None] + 40 * np.arange(shape[2])
    return ((base + rng.integers(0, 30, size=shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("filter", png.FILTERS)
def test_png_codec_matches_pil(tmp_path, channels, filter):
    from PIL import Image

    rng = np.random.default_rng(channels)
    img = _image(rng, (23, 37) if channels == 1 else (23, 37, channels))
    path = str(tmp_path / "codec.png")
    png.write(path, img, filter=filter)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)      # PIL reads the codec
    np.testing.assert_array_equal(png.decode(open(path, "rb").read()), img)

    pil_path = str(tmp_path / "pil.png")
    Image.fromarray(img).save(pil_path)                                   # adaptive filters
    np.testing.assert_array_equal(png.decode(open(pil_path, "rb").read()), img)


def test_png_gray_conversion_matches_libpng(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(5)
    for mode, channels in (("RGB", 3), ("RGBA", 4), ("LA", 2)):
        img = _image(rng, (19, 29, channels))
        img[0, :4, :3 if channels > 2 else 1] = 77                       # equal channels
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(img, mode).save(path)
        got = png.read_gray(path)
        if channels == 2:
            np.testing.assert_array_equal(got, img[..., 0])
        else:
            r, g, b = (img[..., i].astype(np.int64) for i in range(3))
            want = (9797 * r + 19234 * g + 3737 * b) >> 15
            np.testing.assert_array_equal(got, np.where((r == g) & (g == b), r, want))
        if tnative.available():
            np.testing.assert_array_equal(got, tnative.imread_gray(path))


# ---- readers and writers ----

def _assert_dataclass_equal(got, want, exact=True):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "image_files":
            assert [os.path.basename(p) for p in g] == [os.path.basename(p) for p in w]
        elif dataclasses.is_dataclass(w):
            _assert_dataclass_equal(g, w, exact)
        elif w is None:
            assert g is None
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


@pytest.mark.parametrize("writer", ["j", "t"], ids=["jax-written", "port-written"])
def test_asl_readers_match_jax(written_trees, writer):
    roots, imgs = written_trees
    root = roots[f"{writer}_asl"]
    want, got = jasl.read_sequence(root), tasl.read_sequence(root)
    _assert_dataclass_equal(got, want)
    for i in range(N_FRAMES):
        np.testing.assert_array_equal(got.cam.read_image(i), want.cam.read_image(i))
        np.testing.assert_array_equal(got.cam.read_image(i), imgs[i].astype(np.float32))
    with got.cam.prefetcher(n_threads=2, lookahead=3) as pf:
        for i in (0, 1, 4, 2):
            np.testing.assert_array_equal(pf.get(i), imgs[i])

    frame_ts = tsync.select_frames(got, start_time_ns=got.cam.timestamps[1], max_frames=4)
    np.testing.assert_array_equal(frame_ts, jsync.select_frames(
        want, start_time_ns=want.cam.timestamps[1], max_frames=4))
    for K, start in ((10, got.cam.timestamps[0]), (4, None)):
        p_got = tsync.bucket_imu(got.imu.timestamps, got.imu.omega, got.imu.acc, got.imu.dT,
                                 frame_ts, K, start_ts=start)
        p_want = jsync.bucket_imu(want.imu.timestamps, want.imu.omega, want.imu.acc, want.imu.dT,
                                  frame_ts, K, start_ts=start)
        _assert_dataclass_equal(p_got, p_want)
    assert tsync.closest_gt_index(got.gt.timestamps, frame_ts[2]) == \
        jsync.closest_gt_index(want.gt.timestamps, frame_ts[2])
    for g, w in zip(tsync.gt_at_frames(got.gt, frame_ts), jsync.gt_at_frames(want.gt, frame_ts)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("writer", ["j", "t"], ids=["jax-written", "port-written"])
def test_penncosy_readers_match_jax(written_trees, writer):
    roots, imgs = written_trees
    root = roots[f"{writer}_pcv"]
    want, got = jpcv.read_sequence(root), tpcv.read_sequence(root)
    _assert_dataclass_equal(got, want)
    for i in (0, N_FRAMES - 1):
        np.testing.assert_array_equal(got.cam.read_image(i), imgs[i].astype(np.float32))


def test_port_writers_equal_jax_writers(written_trees):
    """Every text file of the two trees is equal; images decode equal."""
    roots, _ = written_trees
    for a, b in (("j_asl", "t_asl"), ("j_pcv", "t_pcv")):
        for dirpath, _, names in os.walk(roots[a]):
            for n in names:
                pa = os.path.join(dirpath, n)
                pb = os.path.join(roots[b], os.path.relpath(pa, roots[a]))
                if n.endswith(".png"):
                    np.testing.assert_array_equal(png.read_gray(pb), png.read_gray(pa))
                else:
                    want = open(pa).read().replace("msckf_mono_tpu.data", "msckf_mono_tpu_torch.data")
                    assert open(pb).read() == want, pb


# ---- the native library and the fallback ----

def test_fallback_matches_native(written_trees, monkeypatch):
    roots, imgs = written_trees
    if not tnative.available():
        pytest.skip("the native library does not build here (no compiler or libpng/libjpeg)")
    root = roots["t_asl"]
    csv_path = os.path.join(root, "imu0", "data.csv")
    img_path = tasl.read_camera(os.path.join(root, "cam0")).image_files[2]
    native = (tnative.parse_csv(csv_path, 7), tnative.parse_csv_i64_col(csv_path, 0),
              tnative.imread_gray(img_path))
    assert tnative.decoder().startswith("native")
    monkeypatch.setattr(tnative, "_load", lambda: None)
    assert not tnative.available() and tnative.decoder().startswith("zlib")
    fallback = (tnative.parse_csv(csv_path, 7), tnative.parse_csv_i64_col(csv_path, 0),
                tnative.imread_gray(img_path))
    for a, b in zip(native, fallback):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fallback[2], imgs[2])
    cam = tasl.read_camera(os.path.join(root, "cam0"))
    with cam.prefetcher(n_threads=2, lookahead=2) as pf:
        np.testing.assert_array_equal(pf.get(3), imgs[3])


def test_native_library_builds_into_the_port(written_trees):
    if not tnative.available():
        pytest.skip("the native library does not build here (no compiler or libpng/libjpeg)")
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "build"
    assert path.parent.parent.name == "msckf_mono_tpu_torch"
