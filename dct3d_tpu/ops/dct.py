"""3D DCT-II / DCT-III as matmuls, with zigzag + quantization folded in.

The reference computes the 3D DCT by brute force: O(N^2) multiply-adds per
cube (512x512 per 8x8x8 cube in OpenCL, 3dDCT.cl:43-143; partially-factored
scalar loops in Java, DCT.java:41-59).  Its normalization is the orthonormal
DCT: global scale ``sqrt(2^3 / N^3)`` plus a ``1/sqrt(2)`` factor per
zero-frequency axis (Transform.java:20-21, DCT.java:81+96-104,
3dDCT.cl:109-140).  That is exactly the tensor product of three orthonormal
1D DCT-II bases ``D[k, n] = s(k) * cos(pi * (2n+1) * k / (2N))`` with
``s(0) = sqrt(1/N)``, ``s(k>0) = sqrt(2/N)``.

Accelerator-first design (SURVEY.md §7): instead of translating those
kernels, the whole per-cube encode chain

    DCT  ->  divide by max(1, q*(i+j+k))  ->  reorder to zigzag

is folded into ONE constant matrix so encoding a batch of cubes is a single
``(num_cubes, 512) @ (512, 512)`` matmul plus a round — one large GEMM
(contraction and output dims both 512).
Decoding is the mirrored matmul plus clamp.  Zigzag and (de)quantization are
literally free.

Matrices are built once in float64 on host (like the reference precomputes its
coefficient tables, DCT.java:77-140 / InverseDCT.java:87-133) and cast to the
compute dtype.
"""

from __future__ import annotations

import functools

import numpy as np

from ..config import CodecConfig
from . import quant, zigzag


def dct_basis_1d(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis, D[k, m] = s(k) cos(pi (2m+1) k / (2n)).

    Rows are frequencies; D @ x transforms a length-n signal.  D is
    orthogonal, so the inverse (DCT-III) is D.T.  Reproduces the reference
    normalization exactly (see module docstring).
    """
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * (2.0 * m + 1.0) * k / (2.0 * n))
    d *= np.sqrt(2.0 / n)
    d[0] *= 1.0 / np.sqrt(2.0)
    return d


@functools.lru_cache(maxsize=None)
def _dct3d_dense(width: int, height: int, depth: int) -> np.ndarray:
    """Dense (cube, cube) forward-3D-DCT matrix on flat [z][y][x] layout.

    M[kflat, nflat] with kflat = kz*h*w + ky*w + kx (same layout as the
    input), i.e. M = Dd (x) Dh (x) Dw as a Kronecker product.
    """
    dw = dct_basis_1d(width)
    dh = dct_basis_1d(height)
    dd = dct_basis_1d(depth)
    return np.kron(dd, np.kron(dh, dw))


@functools.lru_cache(maxsize=None)
def _matrices_f64(
    width: int, height: int, depth: int, strength: int
) -> tuple[np.ndarray, np.ndarray]:
    """(encode, decode) float64 matrices; see encode_matrix/decode_matrix."""
    m3d = _dct3d_dense(width, height, depth)
    div = quant.quant_divisors(width, height, depth, strength)
    perm = zigzag.zigzag_flat_indices(width, height, depth)
    # Encode: row i of E produces the i-th zigzag coefficient already divided
    # by its quantization divisor.  coeffs_zig = E @ x_flat.
    enc = m3d[perm] / div[perm][:, None]
    # Decode: x_flat = sum_i v_zig[i] * div[perm[i]] * M[perm[i], :].
    dec = m3d[perm] * div[perm][:, None]
    return enc, dec


def encode_matrix(cfg: CodecConfig, dtype=np.float32) -> np.ndarray:
    """(cube, cube) matrix E^T such that round(x_cubes @ E^T) are the
    quantized coefficients in zigzag/bitstream order.

    x_cubes: (num_cubes, cube) float pixels, intra-cube layout
    [frame][row][col] (matching readCubes, encoder.c:29-41).
    """
    enc, _ = _matrices_f64(cfg.block_w, cfg.block_h, cfg.block_d, cfg.quant_strength)
    return np.ascontiguousarray(enc.T).astype(dtype)


def encode_matrix_pair(cfg: CodecConfig, dtype=np.float32) -> np.ndarray:
    """encode_matrix with its output columns PAIR-PERMUTED: even zigzag
    indices first (0, 2, ..., cube-2), then odd (1, 3, ...).

    round(x_cubes @ Ep) yields quantized coefficients whose even/odd zigzag
    halves are CONTIGUOUS column slices — the turbo profile's nibble pack
    becomes a pure elementwise op on the two halves instead of a 16.6M
    stride-2 interleave.  Column values are identical to
    encode_matrix's (same f64 build, same cast), so each quantized integer
    is bit-identical to the reference profile's — only the column ORDER
    differs, and the pair permutation keeps DC at column 0 (the exact-DC
    epilogue in codec/transform._quantize applies unchanged)."""
    enc, _ = _matrices_f64(
        cfg.block_w, cfg.block_h, cfg.block_d, cfg.quant_strength
    )
    cube = enc.shape[0]
    perm = np.concatenate([np.arange(0, cube, 2), np.arange(1, cube, 2)])
    return np.ascontiguousarray(enc.T[:, perm]).astype(dtype)


def decode_matrix(cfg: CodecConfig, dtype=np.float32) -> np.ndarray:
    """(cube, cube) matrix D^T such that v_zig @ D^T reconstructs pixel cubes
    (before the [0, 255] clamp) from quantized zigzag-order integers."""
    _, dec = _matrices_f64(cfg.block_w, cfg.block_h, cfg.block_d, cfg.quant_strength)
    return np.ascontiguousarray(dec).astype(dtype)
