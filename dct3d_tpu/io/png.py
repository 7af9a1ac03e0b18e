"""Dependency-free PNG reading (the ingestion half of io/render.py's writer).

The reference captures real screen content via AWT Robot
(CaptureScreen.java:16-163); a headless host has no display, so real footage
arrives as files instead — PNG sequences (exported by ffmpeg, screenshots,
render farms) are the lowest-common-denominator input.  SURVEY.md §7 M5
planned this "frame-from-PNG path".

Supports non-interlaced 8-bit PNGs: grayscale (0), RGB (2), palette (3),
grayscale+alpha (4), RGBA (6); alpha is dropped (capture semantics).  All
five scanline filters are implemented.
"""

from __future__ import annotations

import glob
import os
import struct
import zlib

import numpy as np


def read_png(path: str) -> np.ndarray:
    """PNG file -> (H, W) grayscale or (H, W, 3) RGB uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    ihdr = None
    idat = []
    palette = None
    while pos + 8 <= len(data):
        length, tag = struct.unpack_from(">I4s", data, pos)
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", chunk)
        elif tag == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(chunk)
        elif tag == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{path}: missing IHDR/IDAT")
    w, h, depth, color, comp, filt, interlace = ihdr
    if depth != 8 or comp != 0 or filt != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNGs supported "
                         f"(depth={depth})")
    if interlace != 0:
        raise ValueError(f"{path}: Adam7 interlacing not supported")
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if nch is None:
        raise ValueError(f"{path}: unsupported color type {color}")
    raw = zlib.decompress(b"".join(idat))
    stride = w * nch
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: truncated image data")
    out = _unfilter(raw, h, stride, nch)
    img = out.reshape(h, w, nch)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        img = palette[img[:, :, 0]]
    elif color == 4:
        img = img[:, :, :1]
    elif color == 6:
        img = img[:, :, :3]
    return img[:, :, 0] if img.shape[2] == 1 else img


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo per-scanline filtering (PNG spec 4.5.2 types 0-4).

    Native C when available (sequential per pixel — ~100x the Python loop
    at 1080p); pure-Python fallback otherwise."""
    from .. import native

    buf = np.ascontiguousarray(
        np.frombuffer(raw, np.uint8, count=h * (stride + 1))
    )
    lib = native.load()
    if lib is not None:
        out = np.empty((h, stride), np.uint8)
        rc = lib.png_unfilter(buf.ctypes.data, h, stride, bpp, out.ctypes.data)
        if rc != 0:
            raise ValueError("bad PNG filter type")
        return out
    buf = buf.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = buf[y, 0]
        line = buf[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub
            cur = line.copy()
            for x in range(bpp, stride):
                cur[x] = (cur[x] + cur[x - bpp]) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((a + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def list_sequence(pattern: str) -> list[str]:
    """Expand a PNG-sequence spec: a directory (all *.png, sorted), a glob
    pattern, or a single file."""
    if os.path.isdir(pattern):
        files = sorted(glob.glob(os.path.join(pattern, "*.png")))
    elif any(ch in pattern for ch in "*?["):
        files = sorted(glob.glob(pattern))
    else:
        files = [pattern]
    if not files:
        raise FileNotFoundError(f"no PNG frames match {pattern!r}")
    return files


def read_png_sequence(
    pattern: str, frames: int | None = None, gray: bool = True
) -> np.ndarray:
    """PNG sequence -> (T, H, W) grayscale or (T, H, W, 3) RGB uint8.

    `gray=True` converts color frames with the integer BT.601 luma
    (like RGBUtils' single-channel workflow feeds the codec one plane;
    luma is the standard capture-to-grayscale reduction).
    """
    files = list_sequence(pattern)
    if frames is not None:
        files = files[:frames]
    out = []
    shape = None
    for p in files:
        img = read_png(p)
        if gray and img.ndim == 3:
            r, g, b = (img[..., 0].astype(np.uint32),
                       img[..., 1].astype(np.uint32),
                       img[..., 2].astype(np.uint32))
            img = ((77 * r + 150 * g + 29 * b + 128) >> 8).astype(np.uint8)
        if not gray and img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        if shape is None:
            shape = img.shape
        elif img.shape != shape:
            raise ValueError(
                f"{p}: frame geometry {img.shape} != first frame {shape}"
            )
        out.append(img)
    return np.stack(out)
