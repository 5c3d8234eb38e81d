"""EuRoC / ASL dataset readers (port of ``msckf_mono_tpu/data/asl.py``).

The ``asl_dataset`` readers (reference include/datasets/asl_readers.h,
datasets/asl_readers.cpp) as host-side numpy parsers producing packed
arrays; images are decoded lazily (``data/native_loader.py``).

Conventions reproduced from the reference:
* camera T_BS is inverted into (q_BS, p_BS) — q is the conjugated rotation
  (asl_readers.cpp:32-33), giving q_CI / p_C_I for the filter;
* ground truth converts to the filter frame: v <- q*v, q <- q^-1, with
  g = (0,0,-9.81) (asl_readers.cpp:331-337);
* IMU dT is fixed at 1/rate_hz (asl_readers.cpp:170-171).

The sensor files are read by :func:`_load_yaml`, a reader of the YAML subset
that EuRoC's ``sensor.yaml`` and OpenCV's ``%YAML:1.0`` / ``!!opencv-matrix``
files use, so the port needs no YAML package.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import re

import numpy as np

# PyYAML's implicit scalar types (YAML 1.1), so a file reads as yaml.safe_load reads it
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")


def _scalar(text: str):
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        if v.lstrip("+-") == ".inf":
            return float("-inf") if v.startswith("-") else float("inf")
        return float("nan") if v == ".nan" else float(v)
    return s


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def _flow_list(text: str):
    inner = text.strip()[1:-1]
    return [_scalar(item) for item in inner.split(",")] if inner.strip() else []


def _value(text: str):
    t = text.strip()
    if t.startswith("!!"):                      # a tag such as !!opencv-matrix
        t = t.split(None, 1)[1] if " " in t else ""
    return _flow_list(t) if t.startswith("[") else _scalar(t)


def _parse_yaml(text: str):
    """Block maps by indentation, ``- item`` block lists, flow lists (over
    several lines too), plain and quoted scalars, comments, directives,
    document markers and tags."""
    lines = []
    pending = None
    for raw in text.splitlines():
        if raw.startswith("%") or raw.strip() in ("---", "..."):
            continue
        line = _strip_comment(raw).rstrip()
        if pending is not None:
            pending += " " + line.strip()
            if pending.count("[") <= pending.count("]"):
                lines.append(pending)
                pending = None
            continue
        if not line.strip():
            continue
        if line.count("[") > line.count("]"):
            pending = line
            continue
        lines.append(line)

    def indent(line):
        return len(line) - len(line.lstrip(" "))

    def block(i, ind):
        """Parse the block starting at line i with indentation ind -> (value, next i)."""
        if lines[i].lstrip().startswith("- "):
            out = []
            while i < len(lines) and indent(lines[i]) == ind and lines[i].lstrip().startswith("- "):
                out.append(_value(lines[i].lstrip()[2:]))
                i += 1
            return out, i
        out = {}
        while i < len(lines) and indent(lines[i]) == ind:
            key, _, rest = lines[i].strip().partition(":")
            key = _scalar(key)
            i += 1
            rest = rest.strip()
            if rest and not (rest.startswith("!!") and " " not in rest):
                out[key] = _value(rest)
            elif i < len(lines) and indent(lines[i]) > ind:
                out[key], i = block(i, indent(lines[i]))
            else:
                out[key] = None
        return out, i

    return block(0, indent(lines[0]))[0] if lines else None


def _load_yaml(path):
    with open(path) as f:
        return _parse_yaml(f.read())


def _rotmat_to_quat_wxyz(R):
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(R).as_quat()  # xyzw
    return np.array([q[3], q[0], q[1], q[2]])


def _quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


@dataclasses.dataclass
class AslCamera:
    timestamps: np.ndarray      # (n,) int64 ns
    image_files: list           # n paths
    T_BS: np.ndarray            # (4,4)
    q_BS: np.ndarray            # (4,) wxyz  — INVERTED rotation (q_CI)
    p_BS: np.ndarray            # (3,)       — p_C_I
    K: np.ndarray               # (3,3)
    distortion_model: str
    distortion_coeffs: np.ndarray
    width: int
    height: int
    rate_hz: float

    @property
    def dT(self):
        return 1.0 / self.rate_hz

    def read_image(self, i: int) -> np.ndarray:
        from msckf_mono_tpu_torch.data import native_loader

        return native_loader.imread_gray(self.image_files[i]).astype(np.float32)

    def prefetcher(self, n_threads: int = 4, lookahead: int = 16):
        """Decode-ahead image pipeline (native threads, or Python threads over
        the zlib codec); decode overlaps with device execution."""
        from msckf_mono_tpu_torch.data import native_loader

        return native_loader.ImagePrefetcher(self.image_files, self.width, self.height,
                                             n_threads=n_threads, lookahead=lookahead)


def read_camera(folder: str) -> AslCamera:
    cfg = _load_yaml(os.path.join(folder, "sensor.yaml"))
    T = np.asarray(cfg["T_BS"]["data"], float).reshape(cfg["T_BS"]["rows"], cfg["T_BS"]["cols"])
    R_BS = T[:3, :3]
    q_BS = _quat_conj(_rotmat_to_quat_wxyz(R_BS))  # inverse (asl_readers.cpp:32)
    p_BS = T[:3, 3]

    fu, fv, cu, cv_ = cfg["intrinsics"]
    K = np.array([[fu, 0, cu], [0, fv, cv_], [0, 0, 1.0]])

    ts, files = [], []
    with open(os.path.join(folder, "data.csv")) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts.append(int(row[0]))
            files.append(os.path.join(folder, "data", row[1].strip()))

    res = cfg["resolution"]
    return AslCamera(
        timestamps=np.asarray(ts, np.int64),
        image_files=files,
        T_BS=T,
        q_BS=q_BS,
        p_BS=p_BS,
        K=K,
        distortion_model=cfg.get("distortion_model", "radtan"),
        distortion_coeffs=np.asarray(cfg.get("distortion_coefficients", [0, 0, 0, 0]), float),
        width=int(res[0]),
        height=int(res[1]),
        rate_hz=float(cfg["rate_hz"]),
    )


@dataclasses.dataclass
class AslImu:
    timestamps: np.ndarray  # (n,) int64 ns
    omega: np.ndarray       # (n,3)
    acc: np.ndarray         # (n,3)
    dT: float
    gyroscope_noise_density: float
    gyroscope_random_walk: float
    accelerometer_noise_density: float
    accelerometer_random_walk: float


def read_imu(folder: str) -> AslImu:
    from msckf_mono_tpu_torch.data import native_loader

    cfg = _load_yaml(os.path.join(folder, "sensor.yaml"))
    path = os.path.join(folder, "data.csv")
    vals = native_loader.parse_csv(path, 7)          # ts wx wy wz ax ay az
    ts = native_loader.parse_csv_i64_col(path, 0)    # exact int64 ns
    return AslImu(
        timestamps=ts,
        omega=vals[:, 1:4],
        acc=vals[:, 4:7],
        dT=1.0 / float(cfg["rate_hz"]),
        gyroscope_noise_density=float(cfg.get("gyroscope_noise_density", 0.0)),
        gyroscope_random_walk=float(cfg.get("gyroscope_random_walk", 0.0)),
        accelerometer_noise_density=float(cfg.get("accelerometer_noise_density", 0.0)),
        accelerometer_random_walk=float(cfg.get("accelerometer_random_walk", 0.0)),
    )


@dataclasses.dataclass
class AslGroundTruth:
    timestamps: np.ndarray  # (n,) int64 ns
    p: np.ndarray           # (n,3)
    q: np.ndarray           # (n,4) wxyz, ALREADY inverted to filter frame
    v: np.ndarray           # (n,3) rotated into the filter frame (q*v)
    b_g: np.ndarray         # (n,3)
    b_a: np.ndarray         # (n,3)


def read_ground_truth(folder: str) -> AslGroundTruth:
    from scipy.spatial.transform import Rotation

    from msckf_mono_tpu_torch.data import native_loader

    path = os.path.join(folder, "data.csv")
    vals = native_loader.parse_csv(path, 17)
    ts = native_loader.parse_csv_i64_col(path, 0)
    q = vals[:, 4:8]    # w,x,y,z
    # filter convention: v <- q*v (rotate into IMU frame), q <- q^-1
    # (asl_readers.cpp:335-336)
    rot = Rotation.from_quat(np.roll(q, -1, axis=1))  # xyzw
    v_rot = rot.apply(vals[:, 8:11])  # Eigen q*v with the as-read quaternion, pre-inversion
    q_inv = np.concatenate([q[:, :1], -q[:, 1:]], axis=1)
    return AslGroundTruth(timestamps=ts, p=vals[:, 1:4], q=q_inv, v=v_rot,
                          b_g=vals[:, 11:14], b_a=vals[:, 14:17])


@dataclasses.dataclass
class AslSequence:
    imu: AslImu
    cam: AslCamera
    gt: AslGroundTruth | None


def read_sequence(root: str) -> AslSequence:
    """root = .../MH_03_medium/mav0"""
    gt_dir = os.path.join(root, "state_groundtruth_estimate0")
    return AslSequence(
        imu=read_imu(os.path.join(root, "imu0")),
        cam=read_camera(os.path.join(root, "cam0")),
        gt=read_ground_truth(gt_dir) if os.path.isdir(gt_dir) else None,
    )
