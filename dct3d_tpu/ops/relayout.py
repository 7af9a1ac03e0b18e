"""Word-transpose relayouts between cube rows and frames or wire planes.

Decode emits pixels in a PERMUTED cube column order for free: the decode
matrices' columns are permuted by inv_sigma (same dot products, reordered
outputs — bit-exact), and cubes_perm_to_frames restores frames with 2-D
word transposes on i32 words instead of a 6-axis uint8 transpose:

  per 8-row slab:   (8,8,W/4) i32 <-> (64,W/4) <-> (W/4,64)
                    [row 2*bx+w, lane 8*k+i]

Byte c = 64k+8i+4w+b of cube (by,bx) sits at permuted position
sigma(c) = 256w+32k+4i+b of row by*nbw+bx.

The turbo wire layout (coefficient-pair-major, docs/FORMAT.md) uses the
same word trick: plane_to_wire on encode, wire_words on decode.

Reference parity target: readCubes cube enumeration, encoder.c:10-45.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def supports(cfg, height: int, width: int) -> bool:
    """The word relayout covers the 8x8x8 cube geometry (block widths that
    pack whole i32 words); other geometries use framing's 6-axis
    transpose."""
    return (
        cfg.block_d == 8 and cfg.block_h == 8 and cfg.block_w == 8
        and height % 8 == 0 and width % 8 == 0
    )


def sigma(cube_size: int = 512) -> np.ndarray:
    """sigma[c] = lane of cube byte c in the permuted layout."""
    c = np.arange(cube_size)
    k, i = c >> 6, (c >> 3) & 7
    w, b = (c >> 2) & 1, c & 3
    return 256 * w + 32 * k + 4 * i + b


@jax.jit
def plane_to_wire(plane):
    """(cubes, hc) uint8 transport nibble plane -> (hc, cubes) uint8 wire
    layout (coefficient-pair-major; docs/FORMAT.md) ON DEVICE.

    The word trick instead of a byte-granular transpose: bitcast rows to
    i32 (4 plane bytes per word), 2-D word transpose, then peel the 4 bytes
    per word with elementwise shifts — wire row 4k+b is byte b of word row
    k.

    Replaces the drain pool's host byte_transpose (native/expgolomb.c
    byte_transpose) when the device emits the wire layout directly
    (turbo.encode_step_turbo(wire=True))."""
    cubes, hc = plane.shape
    w32 = hc // 4
    words = jax.lax.bitcast_convert_type(
        plane.reshape(cubes, w32, 4), jnp.int32
    )  # (cubes, w32): word k of row c = plane bytes [c, 4k:4k+4], LE
    wt = words.T  # (w32, cubes)
    parts = [((wt >> (8 * b)) & 0xFF).astype(jnp.uint8) for b in range(4)]
    return jnp.stack(parts, axis=1).reshape(hc, cubes)


@jax.jit
def wire_words(wire):
    """(hc, cubes) uint8 wire layout -> (cubes, hc/4) i32 WORD rows ON
    DEVICE: word j of cube row c packs plane bytes 4j..4j+3 LE — the word
    transpose half of plane_to_wire run backwards, stopping BEFORE the
    byte peel.

    The decode step consumes these words directly (elementwise nibble
    shifts + the exact one-hot pair unscramble, codec/transform.py), so
    the byte-order plane never materializes."""
    hc, cubes = wire.shape
    w32 = hc // 4
    w4 = wire.reshape(w32, 4, cubes).astype(jnp.int32)
    words = (w4[:, 0] | (w4[:, 1] << 8) | (w4[:, 2] << 16)
             | (w4[:, 3] << 24))  # (w32, cubes), LE — plane_to_wire's words
    return words.T  # (cubes, w32)


@jax.jit
def wire_to_plane(wire):
    """(hc, cubes) uint8 wire layout -> (cubes, hc) uint8 transport nibble
    plane ON DEVICE — the exact inverse of plane_to_wire, by the same word
    trick run backwards: pack wire rows 4k..4k+3 into i32 word rows with
    elementwise shifts, 2-D word transpose, bitcast the words back to 4
    plane bytes each.

    Kept for layout tests; the decode step itself consumes wire_words."""
    hc, cubes = wire.shape
    wt = wire_words(wire)
    return jax.lax.bitcast_convert_type(wt, jnp.uint8).reshape(cubes, hc)


def pair_unscramble(cube_size: int = 512) -> np.ndarray:
    """P with P[64*(p%4) + p//4, p] = 1 for pair index p: restores natural
    coefficient-pair order from the word-grouped nibble blocks the decode
    step peels off wire_words (block k holds byte k of every word).

    Applied as an exact one-hot matmul (integers below 2^24 are exact in
    f32 products with 0/1, and each output column has a single nonzero
    term), so the downstream dequant matmul sees operands BIT-IDENTICAL
    to the flat-plane path."""
    hw = cube_size // 2  # pairs per cube
    p = np.arange(hw)
    m = np.zeros((hw, hw), np.float32)
    m[(hw // 4) * (p % 4) + p // 4, p] = 1.0
    return m


def inv_sigma(cube_size: int = 512) -> np.ndarray:
    """inv with sigma()[inv[j]] = j: perm[:, j] == cube byte inv[j], so a
    decode matmul whose COLUMNS are permuted by inv emits pixels directly
    in the permuted layout (same dot products, just reordered
    outputs — bit-exact)."""
    return np.argsort(sigma(cube_size))


@functools.partial(jax.jit, static_argnames=("height", "width"))
def cubes_perm_to_frames(perm, *, height: int, width: int):
    """(num_cubes, 512) uint8 cubes in the sigma-PERMUTED column order ->
    (T, H, W) uint8 frames by per-block i32 word transposes.

    The decode matmul emits the permuted order for free (column-permuted
    decode matrices, inv_sigma), so this replaces framing.cubes_to_frames'
    6-axis uint8 transpose with word-granular moves."""
    num_cubes = perm.shape[0]
    nbh, nbw, w32 = height // 8, width // 8, width // 4
    gops = num_cubes // (nbh * nbw)
    words = jax.lax.bitcast_convert_type(
        perm.reshape(num_cubes, 128, 4), jnp.int32
    ).reshape(gops, nbh * w32, 64)
    blk = jnp.swapaxes(words.reshape(gops, nbh, w32, 64), 2, 3)
    x32 = jnp.swapaxes(
        blk.reshape(gops, nbh, 8, 8, w32), 1, 2
    ).reshape(gops, 8, nbh * 8, w32)
    by = jax.lax.bitcast_convert_type(x32, jnp.uint8)
    return by.reshape(gops * 8, height, width)
