"""Bit-exact Exp-Golomb tests (SURVEY.md §4 item 2).

The serial Python writer/reader is the format oracle; the vectorized
codewords, the device bit packer, and the native C codec must all agree with
it byte for byte.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dct3d_tpu import native
from dct3d_tpu.codec import entropy
from dct3d_tpu.ops import bitpack, expgolomb


def golden_cases():
    # Hand-computed against the format definition (ExpGolombWriter.java:19-49):
    # v -> mapped -> code -> bits
    return [
        (0, "1"),          # m=0 c=1
        (1, "010"),        # m=1 c=2
        (-1, "011"),       # m=2 c=3
        (2, "00100"),      # m=3 c=4
        (-2, "00101"),     # m=4 c=5
        (3, "00110"),
        (-3, "00111"),
        (4, "0001000"),
    ]


def test_serial_writer_golden():
    for v, bits in golden_cases():
        w = expgolomb.SerialWriter()
        w.write(v)
        assert w.bit_length == len(bits)
        got = "".join(
            str((b >> (7 - i)) & 1)
            for b in w.getvalue()
            for i in range(8)
        )[: len(bits)]
        assert got == bits, f"value {v}"


def test_serial_roundtrip_range():
    vals = list(range(-300, 301)) + [1000, -1000, 123456, -123456]
    w = expgolomb.SerialWriter()
    for v in vals:
        w.write(v)
    r = expgolomb.SerialReader(w.getvalue())
    assert [r.read() for _ in vals] == vals


def test_vectorized_codewords_match_serial():
    rng = np.random.default_rng(5)
    vals = np.concatenate(
        [np.arange(-64, 65), rng.integers(-5000, 5000, 500)]
    ).astype(np.int32)
    code, width = expgolomb.codewords_np(vals)
    code_j, width_j = expgolomb.codewords(jnp.asarray(vals))
    np.testing.assert_array_equal(np.asarray(code_j), code)
    np.testing.assert_array_equal(np.asarray(width_j), width)
    for v, c, wd in zip(vals.tolist(), code.tolist(), width.tolist()):
        w = expgolomb.SerialWriter()
        w.write(v)
        assert w.bit_length == wd
        # code in `wd` bits MSB-first == serial bit pattern
        bits = format(c, "b").rjust(wd, "0")
        got = "".join(
            str((b >> (7 - i)) & 1) for b in w.getvalue() for i in range(8)
        )[:wd]
        assert bits == got


@pytest.mark.parametrize("n", [1, 7, 256, 4096])
def test_device_bitpack_matches_serial(n, rng):
    vals = rng.integers(-2000, 2000, n).astype(np.int32)
    w = expgolomb.SerialWriter()
    for v in vals.tolist():
        w.write(int(v))
    want = w.getvalue()

    code, width = expgolomb.codewords(jnp.asarray(vals))
    out_bytes = 4 * n + 16
    buf, total_bits, _tail, ovf = bitpack.pack_bits(code, width, out_bytes)
    assert not bool(ovf)
    assert int(total_bits) == w.bit_length
    got = np.asarray(buf)[: (w.bit_length + 7) // 8].tobytes()
    assert got == want

    # NumPy twin
    code_n, width_n = expgolomb.codewords_np(vals)
    buf_n, bits_n = bitpack.pack_bits_np(code_n, width_n)
    assert bits_n == w.bit_length
    assert buf_n.tobytes() == want


def test_bitpack_with_offset_carry():
    """Packing with a carry pseudo-codeword reproduces a continued stream."""
    vals1 = np.array([3, -7, 0, 12], dtype=np.int32)
    vals2 = np.array([-1, 500, 2], dtype=np.int32)
    w = expgolomb.SerialWriter()
    for v in np.concatenate([vals1, vals2]).tolist():
        w.write(int(v))
    want = w.getvalue()

    c1, w1 = expgolomb.codewords_np(vals1)
    buf1, bits1 = bitpack.pack_bits_np(c1, w1)
    full, rem = bits1 // 8, bits1 % 8
    carry = int(buf1[full]) >> (8 - rem) if rem else 0
    c2, w2 = expgolomb.codewords_np(vals2)
    c2 = np.concatenate([[np.uint32(carry)], c2])
    w2 = np.concatenate([[np.int32(rem)], w2.astype(np.int32)])
    buf2, bits2 = bitpack.pack_bits_np(c2, w2)
    stream = buf1[:full].tobytes() + buf2.tobytes()
    assert stream[: len(want)] == want


def test_native_codec_matches_serial(rng):
    if native.load() is None:
        pytest.skip("no C compiler")
    vals = rng.integers(-3000, 3000, 2048).astype(np.int32)
    w = expgolomb.SerialWriter()
    for v in vals.tolist():
        w.write(int(v))
    want = w.getvalue()

    got, nbits = entropy.encode_values(vals)
    assert nbits == w.bit_length
    assert got == want

    dec, pos = entropy.decode_values(got, len(vals))
    assert pos == nbits
    np.testing.assert_array_equal(dec, vals)


def test_decode_values_eof():
    vals = np.array([5, -5, 100], dtype=np.int32)
    data, nbits = entropy.encode_values(vals)
    with pytest.raises(EOFError):
        entropy.decode_values(data, 50)


def test_encode_values_with_bitpos():
    vals = np.array([1, 2, 3, -4, 5], dtype=np.int32)
    ref, _ = entropy.encode_values(vals)
    shifted, nbits = entropy.encode_values(vals, bitpos=5)
    # First 5 bits are zero padding; content must be the same stream shifted.
    r = expgolomb.SerialReader(shifted)
    for _ in range(5):
        pass
    r._pos = 5
    assert [r.read() for _ in vals] == vals.tolist()


def test_deflate_sink_inflate_source_roundtrip(rng):
    vals = [rng.integers(-500, 500, 512).astype(np.int32) for _ in range(5)]
    sink = entropy.DeflateSink(level=6)
    stream = b"".join([sink.push_values(v) for v in vals]) + sink.finish()

    src = entropy.InflateSource()
    src.feed(stream)
    src.feed_eof()
    for v in vals:
        got = src.try_read(len(v))
        np.testing.assert_array_equal(got, v)


def test_deflate_sink_byte_parity_with_oneshot(rng):
    """Chunked DeflateSink payload == Java-style one-shot payload
    (same continuous bitstream; SURVEY.md §7 hard part 1)."""
    import zlib

    chunks = [rng.integers(-100, 100, 777).astype(np.int32) for _ in range(4)]
    sink = entropy.DeflateSink(level=9)
    stream = b"".join([sink.push_values(c) for c in chunks]) + sink.finish()

    w = expgolomb.SerialWriter()
    for c in chunks:
        for v in c.tolist():
            w.write(int(v))
    payload = w.getvalue()
    if w.bit_length % 8 == 0:
        payload += b"\x00"  # reference writes bufferPosition+1 bytes
    assert zlib.decompress(stream) == payload


def test_parallel_deflate_sink_payload_parity(rng):
    """ParallelDeflateSink: different zlib block layout, identical payload,
    single stream readable by any inflater (the reference decoders included)."""
    import zlib

    from dct3d_tpu.codec.entropy import DeflateSink, ParallelDeflateSink

    vals = rng.integers(-200, 200, size=50_000).astype(np.int32)
    serial, parallel = DeflateSink(9), ParallelDeflateSink(9, workers=3,
                                                           block_size=4096)
    a = serial.push_values(vals[:20_000])
    a += serial.push_values(vals[20_000:])
    a += serial.finish()
    b = parallel.push_values(vals[:20_000])
    b += parallel.push_values(vals[20_000:])
    b += parallel.finish()
    assert zlib.decompress(a) == zlib.decompress(b)


def test_parallel_deflate_end_to_end(clip_module=None):
    """Full encode with parallel DEFLATE decodes identically to serial."""
    from tests.conftest import synthetic_video
    from dct3d_tpu import CodecConfig, decode_video, encode_video

    clip = synthetic_video(16, 64, 64)
    serial = encode_video(clip, CodecConfig(deflate_workers=0))
    fast = encode_video(clip, CodecConfig(deflate_workers=3))
    import zlib

    assert zlib.decompress(serial) == zlib.decompress(fast)
    out_a = decode_video(serial, 64, 64, 16, CodecConfig(deflate_workers=0))
    out_b = decode_video(fast, 64, 64, 16, CodecConfig(deflate_workers=3))
    np.testing.assert_array_equal(out_a, out_b)


def test_planar_decode_matches_plain(rng):
    """eg_decode_planar (C) and the numpy fallback agree with decode_values,
    including values outside int8 and the wrapping-cast plane."""
    from dct3d_tpu.codec import entropy

    vals = np.concatenate([
        rng.integers(-6000, 6000, 2000),
        rng.integers(-5, 5, 30_000),
    ]).astype(np.int32)
    rng.shuffle(vals)
    payload, nbits = entropy.encode_values(vals)
    plane, ei, ev, pos = entropy.decode_values_planar(payload, vals.size)
    assert pos == nbits
    rec = plane.astype(np.int32)
    rec[ei] = ev
    np.testing.assert_array_equal(rec, vals)
    # plane is the wrapping cast everywhere
    np.testing.assert_array_equal(plane, vals.astype(np.int8))
    # exceptions are exactly the out-of-int8 values
    assert set(ei.tolist()) == set(np.flatnonzero(vals.astype(np.int8) != vals).tolist())


@pytest.mark.parametrize("n", [100, 70_000, 300_000])
def test_pack_bits_matches_numpy(rng, n):
    """The XLA level-2 row-gather assembly produces the NumPy twin's bytes,
    tail byte and bit count, across multi-row buffers and group boundary
    words."""
    from dct3d_tpu.ops import bitpack, expgolomb

    vals = rng.integers(-300, 300, n).astype(np.int32)
    code, width = expgolomb.codewords_np(vals)
    out_bytes = int(width.sum()) // 8 + 8
    ref, ref_bits = bitpack.pack_bits_np(code, width, out_bytes)
    got, bits, tail, ovf = jax.jit(
        lambda c, w: bitpack.pack_bits(c, w, out_bytes)
    )(code, width)
    assert int(bits) == ref_bits and not bool(ovf)
    assert int(tail) == int(ref[(ref_bits - 1) // 8])
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_planar4_decode_reconstructs(rng):
    """Nibble-plane decode (C + numpy fallback) reconstructs exactly,
    including DC-sized exception values and the -8 nibble edge."""
    from dct3d_tpu.codec import entropy

    vals = np.concatenate([
        rng.integers(-6000, 6000, 1000),
        rng.integers(-8, 8, 30_000),
        np.full(24, -8),
    ]).astype(np.int32)
    rng.shuffle(vals)
    payload, nbits = entropy.encode_values(vals)
    plane, ei, ev, pos = entropy.decode_values_planar4(payload, vals.size)
    assert pos == nbits
    lo = (plane & 0xF).astype(np.int32)
    hi = ((plane >> 4) & 0xF).astype(np.int32)
    rec = np.stack([(lo ^ 8) - 8, (hi ^ 8) - 8], axis=-1).reshape(-1)
    rec[ei] = ev
    np.testing.assert_array_equal(rec, vals)
    assert set(ei.tolist()) == set(np.flatnonzero((vals < -8) | (vals > 7)).tolist())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_bits_fuzz_vs_numpy(seed):
    """Fuzz the device packer against the NumPy twin across sizes, leading
    carry pseudo-codewords, and extreme values (within the documented
    contract: real codewords have width >= 1, zero-width slots only lead)."""
    rng = np.random.default_rng(seed)
    for n in (1, 2, 63, 64, 65, 257, 4099, 70_001):
        vals = rng.integers(-5771, 5772, n).astype(np.int32)
        code, width = expgolomb.codewords_np(vals)
        carry_bits = int(rng.integers(0, 8))
        carry_code = int(rng.integers(0, 1 << carry_bits)) if carry_bits else 0
        code = np.concatenate([[np.uint32(carry_code)], code])
        width = np.concatenate([[np.int32(carry_bits)], width.astype(np.int32)])
        out_bytes = (int(width.sum()) + 7) // 8 + 5
        ref, ref_bits = bitpack.pack_bits_np(code, width, out_bytes)
        got, got_bits, _tail, ovf = jax.jit(
            lambda c, w, ob=out_bytes: bitpack.pack_bits(c, w, ob)
        )(code, width)
        assert int(got_bits) == ref_bits and not bool(ovf)
        np.testing.assert_array_equal(np.asarray(got), ref)


def test_deflate_sink_sub_byte_carry_chain(rng):
    """Many tiny pushes (single 1-3 bit codewords) must equal one-shot —
    exercises the carry path where a whole push stays inside one byte."""
    import zlib

    vals = rng.integers(-2, 3, 300).astype(np.int32)
    one = entropy.DeflateSink()
    a = one.push_values(vals) + one.finish()
    many = entropy.DeflateSink()
    chunks = [many.push_values(vals[i : i + 1]) for i in range(300)]
    b = b"".join(chunks) + many.finish()
    assert a == b
    par = entropy.ParallelDeflateSink(workers=2, block_size=64)
    c = b"".join(par.push_values(vals[i : i + 1]) for i in range(300)) + par.finish()
    assert zlib.decompress(c) == zlib.decompress(a)


def test_pack_bits_group_overflow_flag_and_tail(rng):
    """A group exceeding its budgeted w_words must raise the overflow flag
    while total_bits and the tail byte (the carry source) stay exact —
    that's what lets the driver retry without breaking the carry chain."""
    vals = rng.integers(-5000, 5000, 600).astype(np.int32)  # ~21 bits each
    code, width = expgolomb.codewords_np(vals)
    out_bytes = (int(width.sum()) + 7) // 8 + 5
    ref, ref_bits = bitpack.pack_bits_np(code, width, out_bytes)
    got, bits, tail, ovf = jax.jit(
        lambda c, w: bitpack.pack_bits(c, w, out_bytes, w_words=8)
    )(code, width)
    assert bool(ovf)
    assert int(bits) == ref_bits
    assert int(tail) == int(ref[(ref_bits - 1) // 8])
    # Ample budget: no overflow, byte-exact.
    got2, bits2, tail2, ovf2 = jax.jit(
        lambda c, w: bitpack.pack_bits(
            c, w, out_bytes, w_words=bitpack.budget_w_words(256, 24)
        )
    )(code, width)
    assert not bool(ovf2)
    np.testing.assert_array_equal(np.asarray(got2), ref)


def test_scan_values_matches_decode_positions(rng):
    """eg_scan's bit positions agree with the decoder's, chunk by chunk,
    including wide codewords and long zero runs."""
    if native.load() is None:
        pytest.skip("no C compiler")
    vals = np.concatenate([
        rng.integers(-3, 4, 5000),
        rng.integers(-6000, 6000, 300),
        np.zeros(700, np.int64),
    ]).astype(np.int32)
    rng.shuffle(vals)
    payload, nbits = entropy.encode_values(vals)
    pos_s = 0
    pos_d = 0
    for chunk in (1, 999, 2000, 3000):
        pos_s = entropy.scan_values(payload, chunk, pos_s)
        _, pos_d = entropy.decode_values(payload, chunk, pos_d)
        assert pos_s == pos_d
    assert entropy.scan_values(payload, vals.size) == nbits
    with pytest.raises(EOFError):
        entropy.scan_values(payload, vals.size + 1)


@pytest.mark.parametrize("w_words", [34, None])
def test_pack_values_matches_numpy_at_budget_and_worst_case(rng, w_words):
    """pack_values is byte-exact vs the NumPy twin at the budget width and
    at the worst-case width, with a partial-byte carry and wide
    codewords."""
    from dct3d_tpu.ops import bitpack

    g_count = 13
    vals = rng.integers(-2, 3, g_count * 256).astype(np.int32)
    hot = rng.random(vals.size) < 0.01
    vals[hot] = rng.integers(-5771, 5772, hot.sum())
    code, width = expgolomb.codewords_np(vals)
    code = np.concatenate([[np.uint32(5)], code])
    width = np.concatenate([[np.int32(3)], width.astype(np.int32)])
    out_bytes = (int(width.sum()) + 7) // 8 + 5
    ref, ref_bits = bitpack.pack_bits_np(code, width, out_bytes)
    got, bits, tail, ovf = jax.jit(
        lambda v: bitpack.pack_values(
            v, jnp.uint32(5), jnp.int32(3), out_bytes, max_width=29,
            w_words=w_words,
        )
    )(vals)
    assert int(bits) == ref_bits and not bool(ovf)
    assert int(tail) == int(ref[(ref_bits - 1) // 8])
    np.testing.assert_array_equal(np.asarray(got), ref)


@pytest.mark.parametrize("carry_bits", [0, 3, 7, 31])
def test_pack_values_matches_pack_bits(rng, carry_bits):
    """pack_values (lead-offset carry, in-kernel codewords) is byte-exact
    vs pack_bits (pseudo-codeword carry) on whole-group batches."""
    from dct3d_tpu.ops import bitpack

    vals = rng.integers(-2000, 2000, 1536).astype(np.int32)
    carry_code = int(rng.integers(0, 1 << carry_bits)) if carry_bits else 0
    code, width = expgolomb.codewords_np(vals)
    code = np.concatenate([[np.uint32(carry_code)], code])
    width = np.concatenate([[np.int32(carry_bits)], width.astype(np.int32)])
    out_bytes = (int(width.sum()) + 7) // 8 + 5
    want, want_bits, want_tail, _ = jax.jit(
        lambda c, w: bitpack.pack_bits(c, w, out_bytes)
    )(code, width)
    got, bits, tail, ovf = jax.jit(
        lambda v: bitpack.pack_values(
            v, jnp.uint32(carry_code), jnp.int32(carry_bits), out_bytes
        )
    )(vals)
    assert int(bits) == int(want_bits)
    assert int(tail) == int(want_tail)
    assert not bool(ovf)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_pack_oversized_buffer_tail(rng):
    """A budget-sized buffer much larger than the content: the all-beyond-
    stream tail must come back deterministically zero (tail rows clamp
    their gather base to row 0 in ops/bitpack._place) and bytes identical
    to the NumPy oracle."""
    vals = rng.integers(-40, 41, 2048).astype(np.int32)
    code, width = expgolomb.codewords_np(vals)
    content_bytes = (int(width.sum()) + 7) // 8
    out_bytes = 8 * 64 * 4 * 7  # 7 chunks; content fills ~2
    assert content_bytes < out_bytes // 3
    ref, ref_bits = bitpack.pack_bits_np(code, width, out_bytes)
    got, got_bits, _tail, ovf = jax.jit(
        lambda c, w: bitpack.pack_bits(c, w, out_bytes)
    )(code.astype(np.uint32), width.astype(np.int32))
    assert int(got_bits) == ref_bits and not bool(ovf)
    np.testing.assert_array_equal(np.asarray(got), ref)
    got2, bits2, _t2, ovf2 = jax.jit(
        lambda v: bitpack.pack_values(
            v, jnp.uint32(0), jnp.int32(0), out_bytes
        )
    )(vals)
    assert int(bits2) == ref_bits and not bool(ovf2)
    np.testing.assert_array_equal(np.asarray(got2), ref)


def test_group_pack_einsum_matches_numpy(rng):
    """The level-1 einsum's words for each group equal the NumPy twin's
    pack of that group alone, led by `phase` zero bits — wide codewords,
    varied phases, zero-width pads."""
    from dct3d_tpu.ops import bitpack

    g_count, group, w = 11, 256, 34
    vals = rng.integers(-2, 3, (g_count, group)).astype(np.int32)
    hot = rng.random((g_count, group)) < 0.01
    vals[hot] = rng.integers(-5771, 5772, hot.sum())
    code, wid = expgolomb.codewords_np(vals.reshape(-1))
    code = code.reshape(g_count, group).astype(np.uint32)
    wid = wid.astype(np.int32).reshape(g_count, group)
    wid[-1, 100:] = 0  # trailing zero-width pad slots
    code[wid == 0] = 0
    phase = (np.arange(g_count) * 7 % 32).astype(np.int32)
    got = np.asarray(jax.jit(bitpack._group_pack_einsum, static_argnums=3)(
        code, wid, phase, w))
    for g in range(g_count):
        ref, _ = bitpack.pack_bits_np(
            np.concatenate([[np.uint32(0)], code[g]]),
            np.concatenate([[phase[g]], wid[g]]), 4 * w)
        np.testing.assert_array_equal(got[g], ref.view(">u4"))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_planar4_table_path_fuzz(seed):
    """Fuzz the 12-bit-table batch decode (native/expgolomb.c g_tab) against
    the scalar eg_decode witness: random value mixes (in-nibble runs, wide
    exception values, width-1 zero runs), sizes straddling the <16-value
    scalar tail guard, and nonzero start bit phases."""
    from dct3d_tpu.codec import entropy

    rng = np.random.default_rng(seed)
    for n in (2, 14, 16, 18, 34, 1000, 4096, 65_538):
        mix = rng.integers(0, 3)
        if mix == 0:
            vals = rng.integers(-8, 8, n)
        elif mix == 1:
            vals = np.where(
                rng.random(n) < 0.05,
                rng.integers(-60_000, 60_000, n),
                rng.integers(-3, 4, n),
            )
        else:
            vals = np.zeros(n, np.int64)  # width-1 codewords back to back
            vals[rng.integers(0, n, max(1, n // 7))] = 7000
        vals = vals.astype(np.int32)
        bitpos = int(rng.integers(0, 8))
        payload, nbits = entropy.encode_values(vals, bitpos)
        want, want_pos = entropy.decode_values(payload, n, bitpos)
        # decode_values is itself table-driven now — pin it to the ground
        # truth so the two table paths can't agree on a shared bug.
        np.testing.assert_array_equal(want, vals)
        plane, ei, ev, pos = entropy.decode_values_planar4(
            payload, n, bitpos
        )
        assert pos == want_pos == nbits
        lo = (plane & 0xF).astype(np.int32)
        hi = ((plane >> 4) & 0xF).astype(np.int32)
        rec = np.stack([(lo ^ 8) - 8, (hi ^ 8) - 8], axis=-1).reshape(-1)[:n]
        rec[ei] = ev
        np.testing.assert_array_equal(rec, want)
        p8, ei8, ev8, pos8 = entropy.decode_values_planar(payload, n, bitpos)
        assert pos8 == nbits
        rec8 = p8.astype(np.int32)
        rec8[ei8] = ev8
        np.testing.assert_array_equal(rec8, want)


def test_scan_table_path_long_runs(rng):
    """eg_scan's table fast path across width-1 runs, wide codewords, and
    every start phase agrees with the decoder's positions."""
    from dct3d_tpu.codec import entropy

    vals = np.concatenate([
        np.zeros(5000, np.int32),               # 1-bit codewords
        rng.integers(-2, 3, 5000),
        rng.integers(-120_000, 120_000, 300),   # >12-bit codewords
    ]).astype(np.int32)
    rng.shuffle(vals)
    for bitpos in range(8):
        payload, nbits = entropy.encode_values(vals, bitpos)
        pos_s, pos_d = bitpos, bitpos
        for chunk in (1, 11, 12, 13, 500, vals.size - 537):
            pos_s = entropy.scan_values(payload, chunk, pos_s)
            _, pos_d = entropy.decode_values(payload, chunk, pos_d)
            assert pos_s == pos_d


def test_multi_decode_n_zero_returns_immediately():
    """Regression: eg_decode_planar4_multi with n == 0 must return 0 with
    zero exception counts, not spin forever (every stream started done but
    `live` was never decremented)."""
    import numpy as np

    from dct3d_tpu import native

    lib = native.load()
    if lib is None:
        import pytest

        pytest.skip("native library unavailable")
    buf = np.zeros(64, np.uint8)
    pos = np.zeros(2, np.uint64)
    cnts = np.ones(2, np.uint64)  # must be overwritten to 0
    planes = np.empty(1, np.uint8)
    ei = np.empty(8, np.int32)
    ev = np.empty(8, np.int32)
    rc = lib.eg_decode_planar4_multi(
        buf.ctypes.data, buf.size * 8, pos.ctypes.data, 2, 0,
        planes.ctypes.data, ei.ctypes.data, ev.ctypes.data, 4,
        cnts.ctypes.data,
    )
    assert rc == 0 and cnts.tolist() == [0, 0]
