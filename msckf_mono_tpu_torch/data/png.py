"""A PNG codec on the standard library's ``zlib`` and numpy.

The port's image decoder when the native loader (``native/loader.cpp``)
cannot be built, and the PNG writer of its dataset writers. It reads
non-interlaced PNGs of bit depth 8 or 16 — gray, gray + alpha, RGB, RGBA and
8-bit palette images — with any of the five row filters, and brings them to
8-bit gray exactly as ``loader.cpp`` asks libpng to (``png_set_strip_16``,
``png_set_strip_alpha``, then ``png_set_rgb_to_gray_fixed(png, 1, 29900,
58700)``: 15-bit coefficients truncated from the weights, the weighted sum
truncated, and a pixel whose three channels are equal kept as it is). It
also reads 8-bit binary PGM (``P5``). JPEG needs the native loader.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}       # color type -> samples a pixel
FILTERS = ("none", "sub", "up", "average", "paeth")
# libpng's png_set_rgb_to_gray_fixed(png, 1, 29900, 58700) coefficients (of 32768)
_RC = 29900 * 32768 // 100000
_GC = 58700 * 32768 // 100000
_BC = 32768 - _RC - _GC


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    at = 8
    while at + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[at:at + 8])
        yield kind, data[at + 8:at + 8 + n]
        at += 12 + n
        if kind == b"IEND":
            return


def _unfilter(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (height, row_bytes) uint8."""
    rows = np.frombuffer(raw, np.uint8)[: height * (row_bytes + 1)].reshape(height, row_bytes + 1)
    kinds, data = rows[:, 0], rows[:, 1:].astype(np.int32)
    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int32)
    for y in range(height):
        line = data[y]
        kind = kinds[y]
        if kind == 0:
            cur = line
        elif kind == 1:        # sub: a running sum per byte position mod bpp
            cur = np.zeros(row_bytes, np.int32)
            for c in range(bpp):
                cur[c::bpp] = np.cumsum(line[c::bpp]) & 255
        elif kind == 2:        # up
            cur = (line + prev) & 255
        elif kind in (3, 4):   # average, paeth: each byte needs its left neighbour
            cur = np.zeros(row_bytes + bpp, np.int32)
            up = np.concatenate([np.zeros(bpp, np.int32), prev])
            for x in range(bpp, row_bytes + bpp):
                a, b, c = int(cur[x - bpp]), int(up[x]), int(up[x - bpp])
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x - bpp] + pred) & 255
            cur = cur[bpp:]
        else:
            raise ValueError(f"PNG row filter {kind}")
        out[y] = cur
        prev = cur.astype(np.int32)
    return out


def decode(data: bytes) -> np.ndarray:
    """The PNG's pixels as stored: (H, W) or (H, W, C) uint8 (16-bit samples
    keep their high byte; palette images become RGB)."""
    header, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if interlace or depth not in (8, 16) or color not in _CHANNELS:
        raise ValueError(f"unsupported PNG: depth {depth}, color type {color}, "
                         f"interlace {interlace}")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    px = rows.reshape(height, width, channels * depth // 8)
    if depth == 16:
        px = px[..., 0::2]
    if color == 3:
        px = palette[px[..., 0]]
    return px[..., 0] if px.shape[-1] == 1 else px


def to_gray(px: np.ndarray) -> np.ndarray:
    """8-bit gray as libpng gives it for ``loader.cpp``'s transforms."""
    if px.ndim == 2:
        return px
    if px.shape[-1] in (1, 2):                      # gray (+ alpha): strip the alpha
        return px[..., 0]
    r, g, b = (px[..., i].astype(np.uint32) for i in range(3))
    mixed = ((_RC * r + _GC * g + _BC * b) >> 15).astype(np.uint8)
    return np.where((r == g) & (r == b), px[..., 0], mixed)


def _decode_pgm(data: bytes) -> np.ndarray:
    fields, at = [], 2
    while len(fields) < 3:
        while data[at:at + 1].isspace():
            at += 1
        if data[at:at + 1] == b"#":
            at = data.index(b"\n", at) + 1
            continue
        end = at
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[at:end]))
        at = end
    width, height, maxv = fields
    if maxv >= 256:
        raise ValueError("16-bit PGM")
    return np.frombuffer(data, np.uint8, width * height, at + 1).reshape(height, width).copy()


def read_gray(path: str) -> np.ndarray:
    """Decode a PNG or binary PGM file to (H, W) uint8 gray."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P5":
        return _decode_pgm(data)
    return to_gray(decode(data))


def _filter_rows(px: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """Filter every row with one filter type, from the original rows."""
    x = px.astype(np.int32)
    H, n = x.shape
    left = np.concatenate([np.zeros((H, bpp), np.int32), x[:, :-bpp]], axis=1)
    up = np.concatenate([np.zeros((1, n), np.int32), x[:-1]], axis=0)
    upleft = np.concatenate([np.zeros((H, bpp), np.int32), up[:, :-bpp]], axis=1)
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    return ((x - pred) & 255).astype(np.uint8)


def encode(px: np.ndarray, filter: str = "sub", level: int = 6) -> bytes:
    """PNG bytes of an 8-bit (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA
    image, every row with the named filter."""
    px = np.ascontiguousarray(px)
    if px.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8, got {px.dtype}")
    channels = 1 if px.ndim == 2 else px.shape[-1]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    H, W = px.shape[:2]
    rows = _filter_rows(px.reshape(H, W * channels), channels, FILTERS.index(filter))
    raw = np.concatenate([np.full((H, 1), FILTERS.index(filter), np.uint8), rows], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))


def write(path: str, px: np.ndarray, filter: str = "sub") -> None:
    """Write :func:`encode`'s bytes to ``path``."""
    with open(path, "wb") as f:
        f.write(encode(px, filter))
