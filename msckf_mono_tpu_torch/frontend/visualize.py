"""Track visualization (port of ``msckf_mono_tpu/frontend/visualize.py``, numpy only).

Re-design of ``TrackVisualizer`` (reference src/corner_detector.cpp:561-661): per-id polyline track history + predicted-point circles drawn on the
image — as pure-numpy RGB rendering (no OpenCV/ROS). The per-id color formula
matches the reference (corner_detector.cpp:641).
"""

from __future__ import annotations

import numpy as np


def _id_color(fid: int):
    # cv::Scalar(((id/64)%8)*255/8, ((id/8)%8)*255/8, (id%8)*255/8) is BGR;
    # return RGB.
    b = ((fid // 64) % 8) * 255 // 8
    g = ((fid // 8) % 8) * 255 // 8
    r = (fid % 8) * 255 // 8
    return np.array([r, g, b], np.uint8)


def _draw_disk(img, x, y, radius, color):
    h, w = img.shape[:2]
    xi, yi = int(round(x)), int(round(y))
    r = int(radius)
    y0, y1 = max(yi - r, 0), min(yi + r + 1, h)
    x0, x1 = max(xi - r, 0), min(xi + r + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    ring = np.abs((yy - yi) ** 2 + (xx - xi) ** 2 - r * r) <= r  # circle outline
    img[y0:y1, x0:x1][ring] = color


def _draw_line(img, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    ts = np.linspace(0, 1, n + 1)
    xs = np.clip(np.round(p0[0] + ts * (p1[0] - p0[0])).astype(int), 0, img.shape[1] - 1)
    ys = np.clip(np.round(p0[1] + ts * (p1[1] - p0[1])).astype(int), 0, img.shape[0] - 1)
    img[ys, xs] = color


class TrackVisualizer:
    """Accumulates per-id pixel track history and draws overlays."""

    def __init__(self):
        self.tracks = {}       # id -> list[(x, y)]
        self.predicted = {}    # id -> (x, y)

    def add_predicted(self, pts, ids, valid):
        self.predicted = {}
        for p, fid, v in zip(np.asarray(pts), np.asarray(ids), np.asarray(valid)):
            if v:
                self.predicted[int(fid)] = (float(p[0]), float(p[1]))

    def add_current_features(self, pts, ids, valid):
        current = set()
        for p, fid, v in zip(np.asarray(pts), np.asarray(ids), np.asarray(valid)):
            if not v:
                continue
            fid = int(fid)
            current.add(fid)
            self.tracks.setdefault(fid, []).append((float(p[0]), float(p[1])))
        # drop dead tracks (corner_detector.cpp:595-601)
        for fid in [k for k in self.tracks if k not in current]:
            del self.tracks[fid]

    def add_new_features(self, pts, ids, valid):
        for p, fid, v in zip(np.asarray(pts), np.asarray(ids), np.asarray(valid)):
            if v:
                self.tracks.setdefault(int(fid), []).append((float(p[0]), float(p[1])))

    def draw(self, gray_img) -> np.ndarray:
        """Grayscale (H,W) -> RGB (H,W,3) with track polylines + circles."""
        img = np.asarray(gray_img)
        rgb = np.stack([img, img, img], axis=-1).astype(np.uint8)
        for fid, pts in self.tracks.items():
            color = _id_color(fid)
            if fid in self.predicted:
                _draw_disk(rgb, *self.predicted[fid], 6, color)
            if pts:
                _draw_disk(rgb, *pts[-1], 4, color)
                for a, b in zip(pts[:-1], pts[1:]):
                    _draw_line(rgb, a, b, color)
        return rgb
