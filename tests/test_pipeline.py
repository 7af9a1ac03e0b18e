"""End-to-end pipeline tests: device path vs float64 oracle (SURVEY.md §4
items 1-3) and streaming-vs-oneshot byte equality (§7 hard part 1)."""

import numpy as np
import pytest

import jax.numpy as jnp

from dct3d_tpu import (
    CodecConfig,
    StreamingEncoder,
    decode_stream,
    decode_video,
    encode_video,
    oracle,
    psnr,
)
from dct3d_tpu.codec import framing, transform


def test_framing_roundtrip(clip):
    cfg = CodecConfig()
    cubes = framing.frames_to_cubes(jnp.asarray(clip), cfg)
    assert cubes.shape == (2 * 8 * 8, 512)
    back = framing.cubes_to_frames(cubes, cfg, 64, 64)
    np.testing.assert_array_equal(np.asarray(back), clip)


def test_framing_cube_order_matches_reference(clip):
    """Cube extraction must match readCubes (encoder.c:29-41): first cube is
    frames 0..7 x rows 0..7 x cols 0..7 in [frame][row][col] order."""
    cfg = CodecConfig()
    cubes = np.asarray(framing.frames_to_cubes(jnp.asarray(clip), cfg))
    want_first = clip[0:8, 0:8, 0:8].reshape(-1)
    np.testing.assert_array_equal(cubes[0], want_first)
    # Second cube: next block column (x blocks inner).
    want_second = clip[0:8, 0:8, 8:16].reshape(-1)
    np.testing.assert_array_equal(cubes[1], want_second)
    # First cube of the second GOP comes after all cubes of GOP 0.
    want_gop2 = clip[8:16, 0:8, 0:8].reshape(-1)
    np.testing.assert_array_equal(cubes[64], want_gop2)


def test_quantized_parity_with_oracle(clip):
    """float32 device quantization vs float64 oracle: quantized integers are
    the parity surface (SURVEY.md §4 item 3).  The two reference impls
    themselves disagree at the LSB (double vs native_cos float), so demand
    >= 99.9% exact and |diff| <= 1 elsewhere."""
    cfg = CodecConfig()
    ctx = transform.TransformContext(cfg)
    q_dev = np.asarray(
        transform.quantize_step(jnp.asarray(clip), ctx.enc_t, cfg=cfg)
    )
    q_ora = oracle.quantized_coefficients(clip, cfg)
    same = np.mean(q_dev == q_ora)
    assert same > 0.999, f"only {same:.6f} quantized ints match"
    assert np.max(np.abs(q_dev - q_ora)) <= 1


def test_roundtrip_psnr(clip):
    data = encode_video(clip)
    out = decode_video(data, 64, 64, clip.shape[0])
    assert out.shape == clip.shape
    p = psnr(clip, out)
    assert p > 30.0, f"roundtrip PSNR {p:.2f} dB too low"
    # Identical to the oracle decode of the same stream (same math).
    out_ora = oracle.decode(data, 64, 64, clip.shape[0])
    assert psnr(out, out_ora) > 50.0


def test_near_lossless_when_quant_disabled(clip):
    """strength=0 -> divisors all 1.  Coefficients are still rounded to ints,
    which injects ~N(0, 1/sqrt(12)) per-pixel noise through the orthonormal
    inverse, so the round trip is near-lossless: PSNR ~ 20*log10(255/0.29)
    ~ 58 dB and almost all pixels within +/-1."""
    cfg = CodecConfig(quant_strength=0)
    data = encode_video(clip, cfg)
    out = decode_video(data, 64, 64, clip.shape[0], cfg)
    assert psnr(clip, out) > 48.0
    assert np.mean(np.abs(out.astype(int) - clip.astype(int)) <= 1) > 0.995


def test_device_stream_matches_oracle_bytes(clip):
    """Full bitstream byte parity: device pipeline vs float64 oracle encoder.

    Coefficient parity is not bit-guaranteed (float32 vs float64), so build
    the oracle stream FROM the device-quantized ints and require exact byte
    equality of the entropy+deflate stages."""
    cfg = CodecConfig()
    ctx = transform.TransformContext(cfg)
    q_dev = np.asarray(
        transform.quantize_step(jnp.asarray(clip), ctx.enc_t, cfg=cfg)
    )
    payload, nbits = oracle.expgolomb_bytes(q_dev)
    if nbits % 8 == 0:
        payload += b"\x00"
    import zlib

    want = zlib.compress(payload, cfg.zlib_level)
    got = encode_video(clip, cfg, ctx)
    assert got == want


def test_streaming_equals_oneshot(clip):
    """Chunked (1 GOP at a time) encode == whole-video encode, byte for byte
    — the cross-GOP bit-carry semantics (encoder.c:266-271)."""
    cfg = CodecConfig()
    one = encode_video(clip, cfg, gops_per_batch=2)
    enc = StreamingEncoder(64, 64, cfg)
    chunks = [enc.push(clip[i : i + 8]) for i in range(0, 16, 8)]
    chunks.append(enc.finish())
    assert b"".join(chunks) == one


def test_decode_stream_generator(clip):
    data = encode_video(clip)
    batches = list(
        decode_stream(
            [data[i : i + 100] for i in range(0, len(data), 100)],
            64,
            64,
            clip.shape[0],
        )
    )
    out = np.concatenate(batches)
    assert out.shape == clip.shape
    assert psnr(clip, out) > 30.0


def test_cpu_fallback_encode_matches_device_pack(clip):
    cfg = CodecConfig()
    enc_a = StreamingEncoder(64, 64, cfg, device_pack=True)
    enc_b = StreamingEncoder(64, 64, cfg, device_pack=False)
    a = enc_a.push(clip) + enc_a.finish()
    b = enc_b.push(clip) + enc_b.finish()
    assert a == b


def test_frame_truncation_to_gop_multiple(clip):
    """Reference truncates frame count to a multiple of 8 (Encoder.java:39-40)."""
    data_trunc = encode_video(clip[:13])
    data_8 = encode_video(clip[:8])
    assert data_trunc == data_8


@pytest.mark.parametrize("dims", [(4, 4, 4), (8, 8, 4)])
def test_alternate_block_sizes(dims, clip):
    """README.md:20 documents 4x4x4 blocks for weak GPUs; the framework is
    fully parameterized like Transform.java:44-56."""
    w, h, d = dims
    cfg = CodecConfig(block_w=w, block_h=h, block_d=d)
    data = encode_video(clip, cfg)
    out = decode_video(data, 64, 64, clip.shape[0], cfg)
    assert psnr(clip[: out.shape[0]], out) > 28.0


def test_pack_budget_overflow_retries(clip):
    """A batch whose stream exceeds pack_bits_per_value must transparently
    retry with the worst-case buffer and still be byte-exact (the device
    carry chain is buffer-independent)."""
    lossless = CodecConfig(quant_strength=0)  # big coeffs, ~8-10 bits/value
    tight = CodecConfig(quant_strength=0, pack_bits_per_value=2)
    assert encode_video(clip, tight) == encode_video(clip, lossless)


def test_stream_budget_overflow_retries(clip):
    """A stream that exceeds the whole-stream buffer budget (but not the
    per-group budget) must transparently retry and stay byte-exact."""
    assert (
        encode_video(clip, CodecConfig(stream_bits_per_value=1))
        == encode_video(clip, CodecConfig())
    )


def test_stream_budget_default_derivation():
    # 2 bits/value: a tighter static buffer at identical bytes (typical
    # content is ~1.2).
    assert CodecConfig().stream_budget_bits_per_value == 2
    # Near-lossless streams genuinely run wide: fall back to the group budget.
    assert CodecConfig(quant_strength=0).stream_budget_bits_per_value == 4
    assert CodecConfig(stream_bits_per_value=5).stream_budget_bits_per_value == 5


def test_pack_budget_ladder_skips_ruled_out_rungs():
    """Near-lossless content (~8-10 bits/value) must jump straight past the
    6-bit rung to the worst-case buffer — the measured stream average
    already rules 6 out, so stopping there would burn two more
    double-encodes per clip discovering that."""
    from conftest import synthetic_video

    clip = synthetic_video(32, 64, 64, seed=9)
    enc = StreamingEncoder(64, 64, CodecConfig(quant_strength=0))
    out = enc.push(clip) + enc.finish()
    assert enc._ladder.budget is None, (
        f"settled at rung {enc._ladder.budget}, expected worst-case"
    )
    assert out == encode_video(clip, CodecConfig(quant_strength=0,
                                                 stream_bits_per_value=32))


def test_extreme_coefficients_through_device_pack():
    """Flat-white video maximizes the DC coefficient (|c| ~ 255*sqrt(512)
    before quantization) — exercises the widest Exp-Golomb codewords and the
    pack's two-word spill path end to end."""
    clip = np.full((8, 64, 64), 255, dtype=np.uint8)
    for q in (0, 5):
        cfg = CodecConfig(quant_strength=q)
        data = encode_video(clip, cfg)
        out = decode_video(data, 64, 64, 8, cfg)
        assert psnr(clip, out) > 40.0
        # Byte parity with the float64 oracle on the same content.
        assert data == oracle.encode(clip, cfg)


def test_decode_truncated_stream_raises(clip):
    data = encode_video(clip)
    with pytest.raises(EOFError):
        decode_video(data[: len(data) // 4], 64, 64, clip.shape[0])


def test_geometry_validation():
    with pytest.raises(ValueError):
        CodecConfig().validate_geometry(321, 240)
    from dct3d_tpu import StreamingEncoder

    with pytest.raises(ValueError):
        StreamingEncoder(321, 240)


def test_deadzone_quantizer_rd(clip):
    """quant_bias < 0.5 (deadzone) must cut rate and remain decodable by the
    bias-agnostic decoder; 0.5 stays byte-exact reference parity (covered by
    the oracle tests, which use the same bias path)."""
    ref = encode_video(clip, CodecConfig())
    dz = encode_video(clip, CodecConfig(quant_bias=0.4))
    assert len(dz) < len(ref)
    out = decode_video(dz, 64, 64, clip.shape[0], CodecConfig(quant_bias=0.4))
    assert psnr(clip, out) > 30.0


def test_transport_delta_is_transparent(clip):
    """transport_delta changes only the wire layout: identical bitstream and
    identical decoded frames."""
    plain = CodecConfig()
    delta = CodecConfig(transport_delta=True)
    assert encode_video(clip, delta) == encode_video(clip, plain)
    data = encode_video(clip, plain)
    np.testing.assert_array_equal(
        decode_video(data, 64, 64, clip.shape[0], delta),
        decode_video(data, 64, 64, clip.shape[0], plain),
    )


def test_drainer_exception_propagates(clip, monkeypatch):
    """A failure on the background drainer thread must surface to the
    caller, not vanish (SURVEY.md §5 failure detection)."""
    from dct3d_tpu.codec import encoder as enc_mod

    enc = enc_mod.StreamingEncoder(64, 64)

    def boom(*a, **k):
        raise RuntimeError("injected drain failure")

    monkeypatch.setattr(enc, "_drain_gop", boom)
    with pytest.raises(RuntimeError, match="injected drain failure"):
        enc.push(clip[:8])  # may surface here (timing) ...
        enc.finish()        # ... or at flush, never silently


def test_local_burst_group_overflow_retries():
    """One noisy cube in an otherwise flat clip: the GLOBAL stream fits the
    pack budget but one pack group bursts its per-group word cap.  The
    overflow flag must force the worst-case retry and keep byte parity and
    the cross-GOP carry chain intact."""
    rng = np.random.default_rng(7)
    clip = np.zeros((16, 64, 64), np.uint8)
    clip[0:8, 0:8, 0:8] = rng.integers(0, 256, (8, 8, 8))
    cfg = CodecConfig(quant_strength=0, pack_bits_per_value=4)
    assert encode_video(clip, cfg) == oracle.encode(clip, cfg)


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_profile_corrupt_input_error_contract(seed):
    """Corrupt reference-profile streams raise ValueError (inflate errors
    translated) or EOFError (truncation) — never raw zlib.error."""
    import zlib

    from dct3d_tpu.codec.decoder import decode_video
    from dct3d_tpu.codec.encoder import encode_video

    rng = np.random.default_rng(seed)
    cfg = CodecConfig()
    video = rng.integers(0, 256, (8, 16, 16), dtype=np.uint8)
    good = encode_video(video, cfg)
    for i in range(25):
        b = bytearray(good)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        for blob in (bytes(b), bytes(b)[: int(rng.integers(1, len(b)))]):
            try:
                decode_video(blob, 16, 16, 8, cfg)
            except (EOFError, ValueError):
                pass
            except zlib.error as e:  # pragma: no cover
                raise AssertionError(f"raw zlib.error escaped: {e}")


def test_bfloat16_fast_profile_stream_stays_decodable():
    """compute_dtype='bfloat16' is the encoder-side fast profile: the
    quantized ints may differ from float32's in the LSBs, but the stream
    stays a valid reference-format bitstream and quality stays within a
    fraction of a dB (uint8 inputs are exact in bf16; the transform
    matmul accumulates in f32)."""
    from conftest import synthetic_video

    from dct3d_tpu import metrics
    from dct3d_tpu.codec.decoder import decode_video
    from dct3d_tpu.codec.encoder import encode_video

    video = synthetic_video(16, 32, 40, seed=61)
    f32 = CodecConfig()
    bf16 = CodecConfig(compute_dtype="bfloat16")
    base = decode_video(encode_video(video, f32), 40, 32, 16, f32)
    fast_stream = encode_video(video, bf16)
    # the stream decodes with the PARITY (float32) decoder: format unchanged
    fast = decode_video(fast_stream, 40, 32, 16, f32)
    p_base = metrics.psnr(video, base)
    p_fast = metrics.psnr(video, fast)
    assert p_fast > p_base - 0.7, (p_base, p_fast)


def _boundary_adversarial_clip(num_cubes: int = 64) -> np.ndarray:
    """Frames whose cube sums put the DC coefficient as close as an integer
    sum allows to a 0.5 quantization boundary (DC = S/sqrt(512), divisor 1).
    A plain f32 matmul flips ~10% of these vs the f64 oracle — the content
    that motivated ops/quant.exact_dc_quant."""
    import math

    cubes = np.zeros((num_cubes, 512), np.float64)
    for c in range(num_cubes):
        q = 100 + 7 * c
        s = round((q + 0.5) * math.sqrt(512.0))
        base, rem = divmod(s, 512)
        cubes[c, :] = base
        cubes[c, :rem] += 1
    # 64 cubes of a (8, 64, 64) clip
    frames = oracle._uncubes(cubes, CodecConfig(), 64, 64)
    return frames.astype(np.uint8)


def test_exact_dc_quant_boundary_parity():
    """Byte parity with the f64 oracle holds even on content engineered to
    sit at DC rounding boundaries (regression: a 1080p gradient+noise clip
    flipped 6 DC values before the exact-DC quantizer existed)."""
    frames = _boundary_adversarial_clip()
    cfg = CodecConfig()
    ctx = transform.TransformContext(cfg)
    q_dev = np.asarray(
        transform.quantize_step(jnp.asarray(frames), ctx.enc_t, cfg=cfg)
    )
    q_ora = oracle.quantized_coefficients(frames, cfg)
    np.testing.assert_array_equal(q_dev[:, 0], q_ora[:, 0])
    assert encode_video(frames, cfg) == oracle.encode(frames, cfg)


def test_exact_dc_quant_arithmetic():
    """ops/quant.exact_dc_quant == floor(S/sqrt(cube) + bias) exactly, for
    every supported geometry and bias, against 60-digit decimal."""
    import decimal

    from dct3d_tpu.ops import quant as quantops

    decimal.getcontext().prec = 60
    rng = np.random.default_rng(3)
    for cube in (64, 128, 512, 4096):
        root = decimal.Decimal(cube).sqrt()
        for bias in (0.5, 0.3):
            ss = np.concatenate(
                [np.arange(64), rng.integers(0, 256 * cube, 512)]
            ).astype(np.int32)
            got = np.asarray(
                quantops.exact_dc_quant(jnp.asarray(ss), cube, bias)
            )
            for s, g in zip(ss.tolist(), got.tolist()):
                want = int(
                    (decimal.Decimal(s) / root + decimal.Decimal(repr(bias)))
                    .to_integral_value(rounding=decimal.ROUND_FLOOR)
                )
                assert g == want, (cube, bias, s, g, want)


@pytest.mark.parametrize("x,bias,want", [
    (1.4999999999999998, 0.5, 2),   # a tie float64 landed just below
    (-2.5000000000000004, 0.5, -3),
    (2.5, 0.5, 3),
    (1.4999, 0.5, 1),
    (-0.49, 0.5, 0),
    (0.6 - 1e-12, 0.4, 1),          # deadzone: the boundary is frac 0.6
    (0.6 + 1e-12, 0.4, 1),
    (-0.6 + 1e-12, 0.4, -1),
    (0.5999, 0.4, 0),
    (0.5 + 1e-12, 0.4, 0),
])
def test_device_round_half_away(x, bias, want):
    import jax

    with jax.enable_x64(True):
        got = transform.round_half_away(jnp.asarray(x, jnp.float64), bias,
                                        1e-9)
    assert int(got) == want


@pytest.mark.parametrize("x,bias,want", [
    (2.5, 0.5, 3), (-2.5, 0.5, -3), (1.4999, 0.5, 1), (-0.4999, 0.5, 0),
    (0.6, 0.4, 1), (0.59, 0.4, 0), (-0.61, 0.4, -1),
])
def test_oracle_round_half_away(x, bias, want):
    assert oracle._round_half_away(np.float64(x), bias) == want


# Uniform-noise 8x8x8 cubes, each with one coefficient exactly on a .5
# rounding boundary that a float64 product lands just below:
# (cube pixels, natural frequency kz*64 + ky*8 + kx).
_TIE_CUBES = [
    ("uxdaDNG0OnaguLjbHhL2Jjc4Yv9qoVVcfF4KWfN/RB71FTjGwUvlKvEyNw0M2LjZODbHqyE"
     "J3aFRUxuDZY4/sSarMsHEZwt9E44wZ6sCPk0Gnu2SIMHkz031c4gj1G2xa+y9CaDVUhNqV"
     "b890Ok9Wk3Cr6FtWZhVkQOKd8NMbKGUzJ04RgGIGDnZkgmNK2Rggt3DE3Ni/3g7SPLXq9O"
     "Tdy4HXLyZZdOm/SvZr1TRL5C5kp/W3DnJMVaHXxa/r5ag8uJaE9ayLb+NRl1JGHc9XVXjd"
     "veWId+c5xMEZdfjNNvXO3xDVfFtV6oGZEH17QZDk05VIrRW/OfKkl9fZ3WCQNBH4D0x+Hc"
     "GIOa6E1VRvNK+orzDy6dBL0Sj/d301rtcBjdlRBqlVNEWXPMQ6I/VHfqCTuKFAxX5qBGR0"
     "RNMkn78CQiQ1j31KMU1/bYTf9SoM+nxf0U+xaGN8sK8mikYpLgGBj1n2sVIP+wH45T+h3d"
     "LfxjVKVlgNouhzywrpysuPi8u7yQNk3X7aZHBFzLRsMdxiHDPDC8T1IKAx68P/lpX8o0fd"
     "DKMyLGaB9qkb3C6uxFeKR6yhqXbtCM7YlDLKQG+s6u8EN+E+pGmvUuHGp4LiqUfqA6OISK"
     "W6zphttegkfRh/EcxL5pOkkX+/9FsGh/C/1hITIHabnFtwOEUOoI=", 144),
    ("/puHlZSXBdUtj/QjDUYnAG99QdpXBokafVfOv7YcHJFV9JbrSLIg6/x0z3+S9RYfx/0Snse"
     "U++9szlixf58wGyTkbpD4ZTHoUqqIQfejH6h95zyRxWfXnlI+4Odtl2ZeUbSoGQC4u5DEc"
     "tcu+O8tZ7/x79B/rWW6MfwHblfHgT73FJSw7xsmNhbZEqa9I6GIfl9eEgEw3Hd7bI5Qkfe"
     "sPLdVavOQ8IKdEQFANTqKR61g52WXuG8aBIILO4WJx1a3Tdcdnlzq6ds61JkICRPxCxtCi"
     "9m8fCslwKRRNOsbgSzd2o866tRwSkfTRtcvqeJNf+YH8g5yWBo9leYgL3QTrqvK5dOwcCb"
     "DBC00S5GOVYHExwMRNaIg61fBQRGylQCms/7ulLRv7fnyfDZQy0IAPnS4JtA8lKiEb9ugb"
     "64ndil5eN9rIRwtO6z8f2n+hbASAnIb7yUMBy+LOOWEtO/+3mjy0CMbvbWC1F65t9u95EG"
     "rVPWDshdLt5IS1BwmztPxw8XZ9BtQWJ0uAez5/dVq0ksFfioNTfU+sNo51tGFSuz+J9ytW"
     "bv2ddi872ITaDVBTP8fIwIO7/9102G4INHLyl6xQeJ3yH8lY1JsmpSPn/7CBzaWs47kwrT"
     "7QlyvYe6wDfbVpY9SqCKV6/WcRz6KDkdSRR2uk80MOlPx8OzCNSg=", 310),
]


def _coefficient_in_z_t(cube: np.ndarray, k: int) -> list[int]:
    """64 * the 8x8x8 DCT coefficient k of `cube`, exactly, as integer
    coordinates over 1, t, ..., t^7 with t = 2cos(pi/16), whose minimal
    polynomial is t^8 - 8t^6 + 20t^4 - 16t^2 + 2.  4 * s(k) cos(pi (2n+1)
    k / 16) is the Chebyshev-Dickson polynomial C_m(t) = 2cos(m pi / 16)
    at m = (2n+1) k, and sqrt(2) = C_4(t) for k = 0."""

    def reduce(p):
        p = list(p) + [0] * (15 - len(p))
        for d in range(len(p) - 1, 7, -1):
            c, p[d] = p[d], 0
            p[d - 2] += 8 * c
            p[d - 4] -= 20 * c
            p[d - 6] += 16 * c
            p[d - 8] -= 2 * c
        return p[:8]

    def mul(a, b):
        out = [0] * 15
        for i, x in enumerate(a):
            for j, y in enumerate(b):
                out[i + j] += x * y
        return reduce(out)

    t = [0, 1] + [0] * 6
    cheb = [[2] + [0] * 7, t]  # C_{m+1} = t C_m - C_{m-1}
    while len(cheb) < 106:
        cheb.append([a - b for a, b in zip(mul(t, cheb[-1]), cheb[-2])])

    def factor(kk, n):
        return cheb[4] if kk == 0 else cheb[(2 * n + 1) * kk]

    kz, ky, kx = k // 64, k // 8 % 8, k % 8
    total = [0] * 8
    pix = cube.reshape(8, 8, 8)
    for z in range(8):
        for y in range(8):
            zy = mul(factor(kz, z), factor(ky, y))
            for x in range(8):
                term = mul(zy, factor(kx, x))
                total = [s + int(pix[z, y, x]) * v
                         for s, v in zip(total, term)]
    return total


@pytest.mark.parametrize("case", range(len(_TIE_CUBES)))
def test_exact_tie_cube_device_matches_oracle(case):
    """An exact .5 tie that float64 lands below: the oracle decides it
    exactly (away from zero), the device snaps it the same way, and the
    parity bytes match."""
    import base64

    from dct3d_tpu.ops import dct, quant, zigzag

    blob, k = _TIE_CUBES[case]
    cube = np.frombuffer(base64.b64decode(blob), np.uint8)
    cfg = CodecConfig()
    div = int(quant.quant_divisors(8, 8, 8, cfg.quant_strength)[k])
    # Independent proof of the tie: the coefficient is the rational v0/64,
    # and v0/(64 div) + 1/2 is an integer.
    v = _coefficient_in_z_t(cube, k)
    assert v[1:] == [0] * 7
    assert (2 * v[0] + 64 * div) % (128 * div) == 0
    want = (2 * v[0] + 64 * div) // (128 * div)
    if v[0] < 0:
        want = -((-2 * v[0] + 64 * div) // (128 * div))
    # A float64 product lands on the wrong side of the boundary.
    x = float(cube.astype(np.float64) @ dct._dct3d_dense(8, 8, 8)[k]) / div
    assert oracle._round_half_away(x) != want
    assert oracle._exact_quantize(cube[None], np.array([k]), cfg) == [want]
    zz = int(np.argsort(zigzag.zigzag_flat_indices(8, 8, 8))[k])
    frames = cube.reshape(8, 8, 8)
    stats = {}
    q_ora = oracle.quantized_coefficients(frames, cfg, stats)
    assert q_ora[0, zz] == want and stats["ties"] == 1
    ctx = transform.TransformContext(cfg)
    q_dev = np.asarray(
        transform.quantize_step(jnp.asarray(frames), ctx.enc_t, cfg=cfg))
    np.testing.assert_array_equal(q_dev, q_ora)
    assert encode_video(frames, cfg) == oracle.encode(frames, cfg)


@pytest.mark.parametrize("dims,bias", [((8, 8, 8), 0.5), ((8, 8, 8), 0.4),
                                       ((4, 4, 4), 0.5)])
def test_oracle_exact_quantize_off_boundary(dims, bias):
    """The oracle's exact evaluation agrees with float64 rounding wherever
    float64 is far from a boundary: random cubes, every frequency, both
    signs."""
    w, h, d = dims
    cfg = CodecConfig(block_w=w, block_h=h, block_d=d, quant_bias=bias)
    rng = np.random.default_rng(5)
    cube = w * h * d
    pix = rng.integers(0, 256, (64, cube)).astype(np.float64)
    freq = rng.integers(0, cube, 64)
    from dct3d_tpu.ops import dct, quant

    div = quant.quant_divisors(w, h, d, cfg.quant_strength)
    x = np.einsum("mn,mn->m", pix, dct._dct3d_dense(w, h, d)[freq]) / div[freq]
    t = np.abs(x) + bias
    far = np.abs(t - np.rint(t)) > 1e-6
    stats = {}
    got = oracle._exact_quantize(pix[far], freq[far], cfg, stats)
    np.testing.assert_array_equal(got, oracle._round_half_away(x[far], bias))
    assert stats["ties"] == 0 and stats["checked"] == far.sum()
    assert (got < 0).any() and (got > 0).any()


def test_noisy_stream_widens_after_repeated_retries(rng):
    """Pure noise at the default budgets (~3.3 bits/value > stream 2;
    low-frequency groups > pack 4) overflows every GOP; after two retries
    the driver must climb the budget ladder permanently (one encode per
    GOP afterwards) and the bytes must stay exact across the switch."""
    from dct3d_tpu.codec.encoder import StreamingEncoder

    noise = rng.integers(0, 256, (32, 64, 64), dtype=np.uint8)
    enc = StreamingEncoder(64, 64, CodecConfig())
    got = enc.push(noise) + enc.finish()
    assert enc._ladder.level > 0  # the adaptive ladder climbed
    assert enc._ladder.streak == 0  # and the settled rung fits
    assert got == encode_video(noise, CodecConfig(stream_bits_per_value=6))
