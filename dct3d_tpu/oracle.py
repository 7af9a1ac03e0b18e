"""Float64 NumPy oracle: a from-scratch, slow-but-exact model of the
reference codec's math, used as the parity surface for tests and baselines.

This is NOT the production path — it exists because the reference ships no
tests (SURVEY.md §4) and no longer runnable here (Java/OpenCL), so the
framework needs an independent, double-precision executable spec of:
  frames -> cubes -> 3D DCT -> quantize -> zigzag -> Exp-Golomb -> zlib
to assert (a) quantized-integer parity and (b) byte parity of the entropy
stream (SURVEY.md §4 items 1-3).

It reuses only layout/format *constants* (zigzag tables, basis, divisors) from
the ops modules — all compute here is plain float64 NumPy + Python bit I/O,
plus exact integer arithmetic for the few coefficients whose float64 value
lies too close to a rounding boundary to decide it (_exact_quantize).
"""

from __future__ import annotations

import functools
import math
import zlib

import numpy as np

from .config import CodecConfig
from .ops import dct, expgolomb, quant, zigzag

#: float64 quantizer values this close to a rounding boundary are decided by
#: _exact_quantize.  The float64 product's own error stays below 1e-9
#: (|coefficient| <= 255*sqrt(cube), cube-term sums).
_NEAR = 1e-7


def _round_half_away(x: np.ndarray, bias: float = 0.5) -> np.ndarray:
    """q = sign(x)*floor(|x| + bias).  bias=0.5 is C round()/roundf()
    semantics (half away from zero), the behavior of the accelerated
    reference (encoder.c:53).  Java's Math.round is half-up and differs
    only at exact negative .5 ties (SURVEY.md §7 quirks)."""
    return np.trunc(x + np.copysign(bias, x))


def _pi_fixed(bits: int) -> int:
    """pi * 2^bits, to a few units (Machin's formula in integers)."""
    g = bits + 16

    def atan_inv(x: int) -> int:
        term = total = (1 << g) // x
        n, sign = 3, -1
        while term:
            term //= x * x
            total += sign * (term // n)
            n, sign = n + 2, -sign
        return total

    return (16 * atan_inv(5) - 4 * atan_inv(239)) >> 16


@functools.lru_cache(maxsize=None)
def _basis_fixed(n: int, bits: int) -> tuple[tuple[int, ...], ...]:
    """Orthonormal DCT-II basis D[k][m] * 2^bits as integers, to a few
    units: s(k) cos(pi (2m+1) k / (2n)) by integer Taylor series."""
    g = bits + 32
    one = 1 << g
    pi = _pi_fixed(g)
    rows = []
    for k in range(n):
        s = math.isqrt(((1 if k == 0 else 2) << (2 * g)) // n)
        row = []
        for m in range(n):
            a = (2 * m + 1) * k % (4 * n)  # angle pi*a/(2n), cos even
            a = min(a, 4 * n - a)  # now in [0, pi]
            th = pi * a // (2 * n)
            th2 = th * th >> g
            term = total = one
            i, sign = 0, 1
            while term:
                i, sign = i + 2, -sign
                term = (term * th2 >> g) // ((i - 1) * i)
                total += sign * term
            row.append((s * total >> g) >> 32)
        rows.append(tuple(row))
    return tuple(rows)


def _exact_bits(cfg: CodecConfig) -> int:
    """Fixed-point fraction bits per 1D factor for _exact_quantize."""
    lcm = math.lcm(cfg.block_w, cfg.block_h, cfg.block_d)
    return 96 * lcm + 256


@functools.lru_cache(maxsize=None)
def _row_fixed(w: int, h: int, d: int, k: int, bits: int) -> np.ndarray:
    """3D basis row of natural frequency k, times 2^(3*bits), as an object
    array of Python ints over the flat [z][y][x] pixel layout."""
    kz, ky, kx = k // (h * w), k // w % h, k % w
    bz = _basis_fixed(d, bits)[kz]
    by = _basis_fixed(h, bits)[ky]
    bx = _basis_fixed(w, bits)[kx]
    row = np.empty(d * h * w, dtype=object)
    row[:] = [a * b * c for a in bz for b in by for c in bx]
    return row


def _exact_quantize(pix: np.ndarray, freq: np.ndarray, cfg: CodecConfig,
                    stats: dict | None = None) -> np.ndarray:
    """Exact sign(c)*floor(|c|/div + bias) for pixel cubes `pix` (m, cube)
    at natural frequencies `freq` (m,), where c is the 3D DCT coefficient.

    c is evaluated in integers, each 1D basis factor to `bits` =
    _exact_bits fraction bits, so its error stays below 2^(20-bits).  An
    exact tie is possible: some frequencies have rational-valued
    coefficients for suitable integer pixels, and then c/div + bias can be
    an integer, on which float64 lands on either side depending on
    summation order.  A value that is NOT on a boundary stays
    far from it: c lies in the real cyclotomic field of degree <= L =
    lcm(block dims), and c/div + bias - j times its denominators is a
    nonzero algebraic integer whose conjugates stay below 2^80, so its norm
    (>= 1) keeps it at least ~2^(-80 L) from the boundary.  The fixed-point
    value therefore decides every side, and one within 2^(64-bits) of a
    boundary IS on it and rounds up (away from zero, as roundf)."""
    bits = _exact_bits(cfg)
    scale = 1 << (3 * bits)
    bn, bd = float(cfg.quant_bias).as_integer_ratio()
    div = quant.quant_divisors(cfg.block_w, cfg.block_h, cfg.block_d,
                               cfg.quant_strength)
    out = np.empty(freq.shape, np.int64)
    for k in np.unique(freq):
        sel = np.flatnonzero(freq == k)
        row = _row_fixed(cfg.block_w, cfg.block_h, cfg.block_d, int(k), bits)
        sums = pix[sel].astype(np.int64).astype(object) @ row
        # y = |c|/div + bias as the fraction num/den; floor, and the
        # distance to the boundaries either side in units of den.
        den = bd * scale * int(div[k])
        tol = den >> (bits - 64)
        for i, s in zip(sel.tolist(), sums.tolist()):
            num = abs(s) * bd + bn * scale * int(div[k])
            j, r = divmod(num, den)
            on = r < tol or den - r < tol
            q = j + (den - r < tol)
            out[i] = q if s >= 0 else -q
            if stats is not None:
                stats["ties"] = stats.get("ties", 0) + on
                if not on:
                    dist = min(r, den - r) / den
                    stats["closest"] = min(stats.get("closest", 1.0), dist)
    if stats is not None:
        stats["checked"] = stats.get("checked", 0) + int(freq.size)
    return out


def _cubes(frames: np.ndarray, cfg: CodecConfig) -> np.ndarray:
    t, h, w = frames.shape
    bd, bh, bw = cfg.block_d, cfg.block_h, cfg.block_w
    x = frames.reshape(t // bd, bd, h // bh, bh, w // bw, bw)
    x = x.transpose(0, 2, 4, 1, 3, 5)
    return x.reshape(-1, bd * bh * bw).astype(np.float64)


def _uncubes(cubes: np.ndarray, cfg: CodecConfig, h: int, w: int) -> np.ndarray:
    bd, bh, bw = cfg.block_d, cfg.block_h, cfg.block_w
    nbh, nbw = h // bh, w // bw
    gops = cubes.shape[0] // (nbh * nbw)
    x = cubes.reshape(gops, nbh, nbw, bd, bh, bw)
    x = x.transpose(0, 3, 1, 4, 2, 5)
    return x.reshape(gops * bd, h, w)


def quantized_coefficients(frames: np.ndarray, cfg: CodecConfig,
                           stats: dict | None = None) -> np.ndarray:
    """(num_cubes, cube) int32 quantized coefficients in zigzag order.

    Values within _NEAR of a rounding boundary are decided exactly
    (_exact_quantize).  `stats`, if given, receives the count of values so
    checked ("checked"), how many were exact ties ("ties"), and the
    smallest distance of a non-tie from its boundary ("closest")."""
    cubes = _cubes(frames, cfg)
    m3d = dct._dct3d_dense(cfg.block_w, cfg.block_h, cfg.block_d)
    coeff = cubes @ m3d.T
    div = quant.quant_divisors(
        cfg.block_w, cfg.block_h, cfg.block_d, cfg.quant_strength
    )
    x = coeff / div[None, :]
    q = _round_half_away(x, cfg.quant_bias).astype(np.int32)
    t = np.abs(x) + cfg.quant_bias
    ci, ki = np.nonzero(np.abs(t - np.rint(t)) < _NEAR)
    if ci.size:
        q[ci, ki] = _exact_quantize(cubes[ci], ki, cfg, stats)
    elif stats is not None:
        stats.setdefault("checked", 0)
    perm = zigzag.zigzag_flat_indices(cfg.block_w, cfg.block_h, cfg.block_d)
    return q[:, perm]


def expgolomb_bytes(coeffs_zigzag: np.ndarray) -> tuple[bytes, int]:
    """Serial Exp-Golomb pack of zigzag-ordered coefficients.

    Returns (packed bytes incl. zero-padded partial byte, bit length)."""
    w = expgolomb.SerialWriter()
    for v in coeffs_zigzag.reshape(-1).tolist():
        w.write(int(v))
    return w.getvalue(), w.bit_length


def encode(frames: np.ndarray, cfg: CodecConfig | None = None) -> bytes:
    """Full oracle encode: frames (T, H, W) uint8 -> zlib bitstream.

    Matches the Java encoder's one-shot structure (Encoder.java:113-125):
    one DEFLATE stream over the whole Exp-Golomb buffer including the final
    partial byte."""
    cfg = cfg or CodecConfig()
    t = frames.shape[0] - frames.shape[0] % cfg.gop_size
    frames = frames[:t]
    q = quantized_coefficients(frames, cfg)
    payload, nbits = expgolomb_bytes(q)
    if nbits % 8 == 0:
        # The reference always deflates bufferPosition+1 bytes, i.e. one byte
        # past the last complete one (Encoder.java:117, encoder.c:270).
        payload += b"\x00"
    return zlib.compress(payload, cfg.zlib_level)


def decode(
    data: bytes, width: int, height: int, frames: int, cfg: CodecConfig | None = None
) -> np.ndarray:
    """Full oracle decode: bitstream -> (T, H, W) uint8 frames."""
    cfg = cfg or CodecConfig()
    t = frames - frames % cfg.gop_size
    payload = zlib.decompress(data)
    reader = expgolomb.SerialReader(payload)
    n = width * height * t
    vals = np.fromiter((reader.read() for _ in range(n)), np.int32, n)
    ncubes = n // cfg.cube_size
    vals = vals.reshape(ncubes, cfg.cube_size).astype(np.float64)

    div = quant.quant_divisors(
        cfg.block_w, cfg.block_h, cfg.block_d, cfg.quant_strength
    )
    perm = zigzag.zigzag_flat_indices(cfg.block_w, cfg.block_h, cfg.block_d)
    m3d = dct._dct3d_dense(cfg.block_w, cfg.block_h, cfg.block_d)
    dequant = vals * div[perm][None, :]
    pixels = dequant @ m3d[perm]  # x[n] = sum_i v[i] * M[perm[i], n]
    pixels = np.clip(pixels, 0.0, 255.0)
    return _uncubes(pixels, cfg, height, width).astype(np.uint8)
