"""Jitted device pipeline: frames <-> quantized zigzag coefficients <-> bits.

One fused XLA program per direction (SURVEY.md §7 M1/M2):

  encode step:  (T, H, W) uint8
                -> cube repack (relayout)
                -> (num_cubes, cube) @ (cube, cube) f64 matmul
                   [3D DCT + quantization + zigzag folded into the matrix]
                -> round  -> Exp-Golomb codewords -> device bit pack
  decode step:  codes -> matmul -> clamp -> uint8 frames

The reference spreads this across a thread-pool of scalar loops
(Transform.java:63-104, DCT.java:41-59) or two OpenCL reduction kernels
(3dDCT.cl:43-143) plus host loops for quantization and bit I/O
(encoder.c:47-71).  Here the whole encode GOP step is a single compiled
XLA executable; rounding and codeword math fuse into the matmul's epilogue.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CodecConfig
from ..ops import bitpack, dct, expgolomb, quant, relayout
from . import framing

# Every float32 matmul names its precision: without it a GPU may run the
# product in TF32, exact only for integers up to 2^11.
_PRECISION = jax.lax.Precision.HIGHEST


def encode_dtype(cfg: CodecConfig):
    """dtype of the encode matmul: float64 for the parity profile
    (compute_dtype float32), else compute_dtype.  A float32 product flips
    a few quantized coefficients per GOP across rounding boundaries vs
    the float64 oracle, whatever the precision setting; float64 with the
    tie snap of _quantize gives exact-arithmetic integers whatever the
    summation order."""
    if cfg.compute_dtype == "float32":
        return np.float64
    return np.dtype(cfg.compute_dtype)


def round_half_away(x, bias, tol):
    """sign(x) * floor(|x| + bias): half away from zero at bias 0.5, as
    C's roundf (encoder.c:53; jnp.round is half-to-even and would diverge
    from the reference); bias < 0.5 is a deadzone quantizer.  |x| within
    `tol` of a rounding boundary, where frac(|x|) = 1 - bias, counts as on
    it and rounds up, as the exact value of a tie does."""
    a = jnp.abs(x)
    f = jnp.floor(a)
    snap = jnp.abs(a - f - (1.0 - bias)) < tol
    return jnp.copysign(jnp.where(snap, f + 1.0, jnp.floor(a + bias)), x)


def _tie_tolerance(enc_t, cube: int):
    """Per output column, a bound on the float64 product's error for uint8
    pixels in any summation order: (cube + 2) units of 2^-53 (the sum, the
    products, and enc_t's own rounding) times sum_n 255 |enc_t[n, k]|.
    Some DCT frequencies give rational coefficients for suitable integer
    pixels, so a coefficient can sit exactly on a rounding boundary; the
    bound puts every such tie within reach of round_half_away's snap."""
    return (cube + 2) * 2.0**-53 * 255.0 * jnp.sum(jnp.abs(enc_t), axis=0)


def _quantize(cubes, enc_t, cfg):
    """(num_cubes, cube) uint8 pixel cubes -> int32 quantized zigzag
    coefficients.

    The matmul folds DCT + 1/divisor + zigzag (ops/dct.py).  A float64
    enc_t (encode_dtype) runs it in float64, with 64-bit types enabled
    for this product alone, and snaps exact ties (_tie_tolerance).  DC
    (zigzag column 0, divisor 1) is replaced by the exact fixed-point
    quantizer of its integer cube sums (ops/quant.exact_dc_quant), a dozen
    elementwise int32 ops that fuse into the round epilogue.

    PRECONDITION: `cubes` are non-negative pixel values (uint8-derived).
    exact_dc_quant's limb split silently corrupts on negative sums — a
    future signed level shift must rework it, not just flow through."""
    f64 = enc_t.dtype == jnp.float64
    with jax.enable_x64(f64):
        scaled = jnp.dot(cubes.astype(enc_t.dtype), enc_t,
                         precision=_PRECISION)
        tol = _tie_tolerance(enc_t, cfg.cube_size) if f64 else 0.0
        q = round_half_away(scaled, cfg.quant_bias, tol).astype(jnp.int32)
    if cfg.cube_size <= 4096:
        sums = jnp.sum(cubes.astype(jnp.int32), axis=-1)
        dc = quant.exact_dc_quant(sums, cfg.cube_size, cfg.quant_bias)
        q = jnp.where(
            jnp.arange(q.shape[-1], dtype=jnp.int32) == 0, dc[:, None], q
        )
    return q


class EncodedGOP(NamedTuple):
    """Device-side result of encoding one batch of frames."""

    packed: jax.Array  # (max_bytes,) uint8, bit-concatenated codewords
    total_bits: jax.Array  # () int32, valid bit count in `packed`
    carry_code: jax.Array  # () uint32, trailing partial byte, right-aligned
    carry_bits: jax.Array  # () int32, 0..7
    overflow: jax.Array  # () bool, a pack group exceeded its bit budget
    # (packed is then invalid and the driver retries with tight=False;
    # total_bits and the carry scalars stay exact either way)


def _frames_to_q(frames, enc_t, cfg):
    """Transform front half shared by every encode profile: (T, H, W) uint8
    (raw or transport-delta) -> (num_cubes, cube) int32 quantized zigzag
    coefficients, bit-identical to the float64 oracle's."""
    if cfg.transport_delta:
        # Frames arrived as wrapping temporal deltas (cheap-to-compress on
        # the wire); reconstruct exactly with a mod-256 prefix sum.  The
        # scan stays in uint8 — wrapping adds ARE the mod — so no int32
        # blow-up of the frame volume ever touches device memory.
        frames = jax.lax.associative_scan(jnp.add, frames, axis=0)
    # Keep the cube relayout in uint8: without a barrier XLA may fuse the
    # float convert into the 6-axis transpose, running the relayout copy
    # at 4-8 bytes/pixel.
    cubes = jax.lax.optimization_barrier(framing.frames_to_cubes(frames, cfg))
    return _quantize(cubes, enc_t, cfg)


def _encode_core(frames, enc_t, carry_code, carry_bits, max_bytes, cfg,
                 tight=True, pack_bits=None):
    q = _frames_to_q(frames, enc_t, cfg)
    if pack_bits is not None:
        w_words = bitpack.budget_w_words(256, pack_bits)
    else:
        w_words = (bitpack.budget_w_words(256, cfg.pack_bits_per_value)
                   if tight else None)
    max_width = bitpack.max_codeword_bits(cfg.cube_size)
    if q.size % 256 == 0:
        # Fast path: the carry rides as a bit offset and the packer derives
        # codewords from q itself (no code/width arrays, no concat copies).
        packed, total_bits, tail_byte, overflow = bitpack.pack_values(
            q.reshape(-1), carry_code, carry_bits, max_bytes,
            max_width=max_width, w_words=w_words,
        )
    else:
        # Odd cube counts (e.g. tiny 4^3 frames): carry as a pseudo-codeword.
        code, width = expgolomb.codewords(q.reshape(-1))
        code = jnp.concatenate([carry_code[None].astype(jnp.uint32), code])
        width = jnp.concatenate([carry_bits[None].astype(jnp.int32), width])
        packed, total_bits, tail_byte, overflow = bitpack.pack_bits(
            code, width, max_bytes, max_width=max_width, w_words=w_words,
        )
    # Next GOP's carry, computed ON DEVICE so consecutive encode steps chain
    # without a host round trip (the host learns total_bits asynchronously).
    # tail_byte is overflow-proof (dedicated mini-pack, ops/bitpack.py), so
    # the carry chain survives buffer/budget overflows and the driver can
    # retry just the overflowed batch.
    rem = total_bits % 8
    new_code = jnp.where(rem > 0, tail_byte >> (8 - rem).astype(jnp.uint32), 0)
    return EncodedGOP(packed, total_bits, new_code.astype(jnp.uint32), rem,
                      overflow)


@functools.partial(
    jax.jit, static_argnames=("max_bytes", "cfg", "tight", "pack_bits")
)
def encode_step(frames, enc_t, carry_code, carry_bits, *, max_bytes, cfg,
                tight=True, pack_bits=None):
    """Encode a (T, H, W) uint8 frame batch into packed Exp-Golomb bytes.

    carry_code/carry_bits: the partial trailing byte of the previous call
    (value right-aligned in carry_bits bits), continuing the bitstream across
    GOPs exactly like the C encoder's buffer carry (encoder.c:266-271).

    tight=True uses budget-capped pack buffers (fast path; may flag
    overflow); tight=False is the worst-case retry shape.  pack_bits
    overrides the per-group budget explicitly (the drivers' adaptive
    ladder passes its middle rungs here); it never affects bytes, only
    buffer sizes and the overflow flag.
    """
    return _encode_core(frames, enc_t, carry_code, carry_bits, max_bytes, cfg,
                        tight=tight, pack_bits=pack_bits)


def _finish_frames(pixels, cfg, height, width, perm: bool = False):
    """Clamp to [0, 255] (3dDCT.cl:256-262), truncating byte cast
    (writeCubes decoder.c:30, Decoder.java:112), frame relayout, and the
    optional transport-delta wire form.

    perm=True: pixels arrived in the sigma-permuted column order
    (column-permuted decode matrices — same dot products, bit-exact
    values), so the frame relayout is the word-transpose inverse
    (ops/relayout.cubes_perm_to_frames) instead of the 6-axis transpose."""
    pixels = jnp.clip(pixels, 0.0, 255.0)
    if perm:
        frames = relayout.cubes_perm_to_frames(
            pixels.astype(jnp.uint8), height=height, width=width,
        )
    else:
        frames = framing.cubes_to_frames(pixels, cfg, height, width)
        frames = frames.astype(jnp.uint8)
    if cfg.transport_delta:
        # Ship wrapping temporal deltas down the wire; the host reconstructs
        # with a uint8 cumsum (see codec/decoder.py).
        frames = jnp.concatenate([frames[:1], frames[1:] - frames[:-1]])
    return frames


def _perm_decode(cfg, height, width, dec_me, dec_mo):
    """Shared gate for the permuted decode path: when the word relayout
    covers the geometry, permute the decode matrices' COLUMNS by inv_sigma
    (same dot products, reordered outputs — decoded pixels bit-identical)
    so _finish_frames(perm=True) can run the word-transpose inverse
    relayout instead of the 6-axis transpose.  ONE helper so decode_step /
    planar4_to_frames / sharded_decode_step can never diverge in layout
    handling.  Returns (perm, dec_me, dec_mo)."""
    if not relayout.supports(cfg, height, width):
        return False, dec_me, dec_mo
    inv = relayout.inv_sigma(cfg.cube_size)
    return True, dec_me[:, inv], dec_mo[:, inv]


def _dequant_matmul(ce, co, dec_me, dec_mo):
    """Inverse transform as even-feature + odd-feature half matmuls.

    The split exists so the packed-nibble upload never interleaves its two
    planes (a 16.6M-element stride-2 shuffle).  EVERY decode path uses this
    same summation order so decoded pixels stay identical across upload
    formats (the transparency invariant); vs the float64 oracle the f32
    result keeps the usual <=1 LSB envelope."""
    return (
        jnp.dot(ce.astype(dec_me.dtype), dec_me, precision=_PRECISION)
        + jnp.dot(co.astype(dec_mo.dtype), dec_mo, precision=_PRECISION)
    )


@functools.partial(jax.jit, static_argnames=("cfg", "height", "width"))
def decode_step(coeffs, dec_me, dec_mo, *, cfg, height, width):
    """Quantized zigzag coefficients (num_cubes, cube) int -> uint8 frames.

    Dequantization (exact integer multiply, folded into the matrices) and
    inverse DCT via the split matmul (_dequant_matmul)."""
    v2 = coeffs.reshape(coeffs.shape[0], -1, 2)
    perm, dec_me, dec_mo = _perm_decode(cfg, height, width, dec_me, dec_mo)
    pixels = _dequant_matmul(v2[:, :, 0], v2[:, :, 1], dec_me, dec_mo)
    return _finish_frames(pixels, cfg, height, width, perm=perm)


@functools.partial(jax.jit, static_argnames=("cfg", "height", "width"))
def decode_step_planar(coeff8, exc_idx, exc_val, dec_me, dec_mo, *, cfg,
                       height, width):
    """decode_step taking an int8 coefficient plane + sparse exceptions.

    int32 coefficients are 4 bytes each on the host->device link, but
    ~99.9% of quantized coefficients fit int8, so the host
    ships an int8 plane plus an exception list (flat index, true value) and
    the device restores the outliers with one small scatter.  Padding slots
    use an out-of-range index and are dropped."""
    coeffs = coeff8.astype(jnp.int32).reshape(-1)
    coeffs = coeffs.at[exc_idx].set(exc_val, mode="drop")
    return decode_step(
        coeffs.reshape(coeff8.shape), dec_me, dec_mo,
        cfg=cfg, height=height, width=width,
    )


@functools.partial(
    jax.jit, static_argnames=("cfg", "height", "width", "wire")
)
def decode_step_planar4(plane, exc_idx, exc_val, dec_me, dec_mo, *, cfg,
                        height, width, wire: bool = False, dc=None):
    """decode_step taking a packed-nibble plane (two coefficients per byte,
    low nibble = even index, sign-extended from 4 bits) + exceptions — half
    the upload of the int8 plane; DC coefficients ride the exception list.

    The even/odd planes feed the split matmul directly — no interleave.

    wire=True: `plane` is the (cube/2, cubes) WIRE layout straight off the
    turbo member — the device consumes its word rows directly
    (ops/relayout.wire_words + the exact pair unscramble; byte order never
    materializes) so the host never byte-transposes on decode either."""
    return planar4_to_frames(plane, exc_idx, exc_val, dec_me, dec_mo,
                             cfg=cfg, height=height, width=width, wire=wire,
                             dc=dc)


def planar4_to_frames(plane, exc_idx, exc_val, dec_me, dec_mo, *, cfg,
                      height, width, wire: bool = False, dc=None):
    """Unjitted decode_step_planar4 body — also the per-shard body of the
    sharded turbo decode (codec/turbo.py), where `height` is the tile's
    local height.  One body so every planar4 path keeps the identical
    split-matmul summation order (the transparency invariant).

    `dc`: optional dense per-cube DC vector spliced as the even plane's
    column 0 instead of riding the exception scatter.  On the wire it
    comes from the member's own dense DC stream
    (turbo._parse_payload(split_dc=True)); on the FLAT path the host
    derives it exactly from nibble column 0 + the DC exceptions
    (decoder._split_dc_flat) — either way the matmul operands are
    bit-identical to the scatter route's, and the scatter shrinks to the
    true outliers."""
    hc = cfg.cube_size // 2
    if wire:
        # The wire's byte order never materializes: un-bitcasting the word
        # transpose back to plane bytes would cost layout copies.  Instead
        # peel nibbles ELEMENTWISE from the i32 word rows (block k = byte k
        # of every word), scatter exceptions in the word-grouped order, and
        # restore natural pair order with the exact one-hot matmul
        # (ops/relayout.pair_unscramble) — integers are exact in f32/bf16
        # one-hot products, so the dequant matmul sees operands
        # BIT-IDENTICAL to the flat-plane path (same values, same
        # summation order; the transparency invariant holds).
        wt = relayout.wire_words(plane)
        cubes = wt.shape[0]
        lo_p = jnp.concatenate(
            [(((wt >> (8 * k)) & 0xF) ^ 8) - 8 for k in range(4)], axis=1)
        hi_p = jnp.concatenate(
            [(((wt >> (8 * k + 4)) & 0xF) ^ 8) - 8 for k in range(4)],
            axis=1)
        # Natural flat coefficient index -> word-grouped (permuted) slot.
        cube_i = exc_idx // cfg.cube_size
        r = exc_idx % cfg.cube_size
        p = r >> 1
        pidx = cube_i * hc + (hc // 4) * (p % 4) + p // 4
        nperm = cubes * hc
        e_even = jnp.where((r & 1) == 0, pidx, nperm)
        e_odd = jnp.where((r & 1) == 1, pidx, nperm)
        # Scatter into fresh sentinel buffers (natural layout — scattering
        # into the shift-derived operands forces a layout copy) and merge
        # elementwise; INT32_MIN cannot be a real coefficient (quantized
        # magnitudes are < 2^23).
        sent = jnp.int32(-(2 ** 31))
        de = jnp.full((nperm,), sent, jnp.int32).at[e_even].set(
            exc_val, mode="drop", unique_indices=True).reshape(cubes, hc)
        do = jnp.full((nperm,), sent, jnp.int32).at[e_odd].set(
            exc_val, mode="drop", unique_indices=True).reshape(cubes, hc)
        lo_p = jnp.where(de == sent, lo_p, de)
        hi_p = jnp.where(do == sent, hi_p, do)
        if dc is not None:
            # Dense per-cube DC shipped as its own vector (turbo wire,
            # _parse_payload(split_dc=True)): pair 0 is COLUMN 0 of the
            # word-grouped layout, so a concat splice replaces scattering
            # `cubes` extra elements — identical operand values.
            lo_p = jnp.concatenate(
                [dc.astype(jnp.int32)[:, None], lo_p[:, 1:]], axis=1
            )
        perm, dec_me, dec_mo = _perm_decode(cfg, height, width,
                                            dec_me, dec_mo)
        unscr = jnp.asarray(relayout.pair_unscramble(cfg.cube_size),
                            dec_me.dtype)
        lo_n = jnp.dot(lo_p.astype(dec_me.dtype), unscr,
                       precision=_PRECISION)
        hi_n = jnp.dot(hi_p.astype(dec_mo.dtype), unscr,
                       precision=_PRECISION)
        pixels = _dequant_matmul(lo_n, hi_n, dec_me, dec_mo)
        return _finish_frames(pixels, cfg, height, width, perm=perm)
    b = plane.astype(jnp.int32)
    lo = (((b & 0xF) ^ 8) - 8).reshape(-1)
    hi = ((((b >> 4) & 0xF) ^ 8) - 8).reshape(-1)
    half = lo.shape[0]
    e_even = jnp.where((exc_idx & 1) == 0, exc_idx >> 1, half)
    e_odd = jnp.where((exc_idx & 1) == 1, exc_idx >> 1, half)
    lo = lo.at[e_even].set(exc_val, mode="drop", unique_indices=True)
    hi = hi.at[e_odd].set(exc_val, mode="drop", unique_indices=True)
    perm, dec_me, dec_mo = _perm_decode(cfg, height, width, dec_me, dec_mo)
    lo2 = lo.reshape(-1, hc)
    if dc is not None:
        # DC is coefficient 0 = the even plane's column 0: an elementwise
        # select that fuses into the matmul operand read, vs scattering
        # `cubes` extra exception elements.
        lo2 = jnp.where(
            jnp.arange(hc, dtype=jnp.int32)[None, :] == 0,
            dc.astype(jnp.int32)[:, None], lo2,
        )
    pixels = _dequant_matmul(lo2, hi.reshape(-1, hc), dec_me, dec_mo)
    return _finish_frames(pixels, cfg, height, width, perm=perm)


@functools.partial(jax.jit, static_argnames=("cfg",))
def quantize_step(frames, enc_t, *, cfg):
    """Frames -> quantized zigzag int32 coefficients (no bit packing)."""
    return _quantize(framing.frames_to_cubes(frames, cfg), enc_t, cfg)


class TransformContext:
    """Holds the constant encode/decode matrices on device.

    The analogue of the reference's precomputed coefficient tables
    (DCT.java:77-140, InverseDCT.java:87-133), built once per config.
    """

    def __init__(self, cfg: CodecConfig | None = None):
        self.cfg = cfg or CodecConfig()
        dtype = np.dtype(self.cfg.compute_dtype)
        edt = encode_dtype(self.cfg)
        with jax.enable_x64(edt == np.float64):
            self.enc_t = jnp.asarray(dct.encode_matrix(self.cfg, edt))
            # Pair-permuted encode matrix for the turbo profile (even
            # zigzag columns first; ops/dct.encode_matrix_pair).  Built
            # eagerly — a lazy property would capture a tracer if first
            # touched inside a jit trace, and the constant is only cube^2
            # floats.
            self.enc_t_pair = jnp.asarray(
                dct.encode_matrix_pair(self.cfg, edt))
        dec_m = dct.decode_matrix(self.cfg, dtype)
        self.dec_m = jnp.asarray(dec_m)
        # Even/odd coefficient-row halves for the split inverse matmul
        # (_dequant_matmul): the packed-nibble decode upload feeds its two
        # planes straight into these without interleaving.
        self.dec_me = jnp.asarray(np.ascontiguousarray(dec_m[0::2]))
        self.dec_mo = jnp.asarray(np.ascontiguousarray(dec_m[1::2]))

    def max_packed_bytes(self, num_pixels: int) -> int:
        """Static bit-pack buffer size for a frame batch.

        Sized by cfg.stream_budget_bits_per_value (default 3
        bits/coefficient, a ~2.4x margin over typical 1-1.3 bit streams).
        Worst-case codewords are 29 bits, so pathological content can
        overflow this buffer: the driver detects it via total_bits and
        retries the batch against max_packed_bytes_worst_case (the carry
        chain is overflow-proof, see ops/bitpack.py).  A tight budget
        matters because level-2 assembly cost scales with the static buffer
        size — its row gathers cover the whole static buffer whether or not
        the stream fills it.  (The reference assumes 8 bits/coeff and would
        overrun beyond that: Encoder.java:95, encoder.c:133.)
        """
        return (self.cfg.stream_budget_bits_per_value * num_pixels) // 8 + 64

    def max_packed_bytes_worst_case(self, num_pixels: int) -> int:
        """Cannot overflow: 32 bits/value >= the 29-bit codeword bound."""
        return 4 * num_pixels + 64
