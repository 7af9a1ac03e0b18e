"""Turbo (planar) profile tests (docs/FORMAT.md type-5 members).

Pins: the einsum exception compaction against a numpy witness (including the
slots-overflow retry shape), pixel-identity with the reference profile,
rate sanity, CLI roundtrip + info routing, and transport-delta
transparency.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from dct3d_tpu.codec import turbo
from dct3d_tpu.codec.decoder import decode_video
from dct3d_tpu.codec.encoder import encode_video
from dct3d_tpu.config import CodecConfig
from dct3d_tpu.ops import exceptions
from dct3d_tpu.parallel import multihost

from conftest import synthetic_video


def _np_exceptions(values: np.ndarray):
    idx = np.flatnonzero((values < -8) | (values > 7)).astype(np.int64)
    return idx, values[idx].astype(np.int32)


@pytest.mark.parametrize("slots", [4, 16, 256])
def test_compact_exceptions_matches_numpy(rng, slots):
    import jax.numpy as jnp

    vals = np.where(
        rng.random(4096) < 0.01,
        rng.integers(-5771, 5772, 4096),
        rng.integers(-8, 8, 4096),
    ).astype(np.int32)
    lidx, v, counts, ovf = exceptions.compact_exceptions(
        jnp.asarray(vals), slots=slots
    )
    per_group = ((vals.reshape(-1, 256) < -8)
                 | (vals.reshape(-1, 256) > 7)).sum(axis=1)
    np.testing.assert_array_equal(np.asarray(counts), per_group)
    assert bool(ovf) == bool((per_group > slots).any())
    if not bool(ovf):
        idx, val = exceptions.expand_exceptions_np(
            np.asarray(lidx), np.asarray(v), np.asarray(counts)
        )
        widx, wval = _np_exceptions(vals)
        np.testing.assert_array_equal(idx, widx)
        np.testing.assert_array_equal(val, wval)


def test_compact_exceptions_worst_case_dense(rng):
    import jax.numpy as jnp

    vals = rng.integers(-5771, 5772, 2048).astype(np.int32)  # ~all except.
    lidx, v, counts, ovf = exceptions.compact_exceptions(
        jnp.asarray(vals), slots=256
    )
    assert not bool(ovf)
    idx, val = exceptions.expand_exceptions_np(
        np.asarray(lidx), np.asarray(v), np.asarray(counts)
    )
    widx, wval = _np_exceptions(vals)
    np.testing.assert_array_equal(idx, widx)
    np.testing.assert_array_equal(val, wval)


def _np_exception_tables(values: np.ndarray, slots: int, dc_stride: int):
    """NumPy twin of compact_exceptions' dense tables (slots < group)."""
    v2 = values.reshape(-1, 256)
    flat = np.arange(values.size).reshape(v2.shape)
    mask = (v2 < -8) | (v2 > 7)
    if dc_stride:
        mask &= flat % dc_stride != 0
    counts = mask.sum(axis=1).astype(np.int32)
    lidx = np.zeros((v2.shape[0], slots), np.uint8)
    vals = np.zeros((v2.shape[0], slots), np.int16)
    for g in range(v2.shape[0]):
        cols = np.flatnonzero(mask[g])[:slots]
        lidx[g, : cols.size] = cols
        vals[g, : cols.size] = v2[g, cols]
    return lidx, vals, counts, bool((counts > slots).any())


@pytest.mark.parametrize("dc_stride", [0, 512, 64, 96])
def test_compact_exceptions_einsum_matches_numpy(rng, dc_stride):
    """The einsum compaction agrees table-for-table with the NumPy twin,
    including the dc exclusion (pow2 and non-pow2)."""
    import jax.numpy as jnp

    n = 1536 * 256
    vals = np.where(
        rng.random(n) < 0.02,
        rng.integers(-5771, 5772, n),
        rng.integers(-8, 8, n),
    ).astype(np.int32)
    vals[::512] = 4096  # dense DC-like outliers exercise the exclusion
    got = exceptions.compact_exceptions(
        jnp.asarray(vals), slots=16, dc_stride=dc_stride
    )
    want = _np_exception_tables(vals, 16, dc_stride)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_compact_exceptions_einsum_odd_groups(rng):
    """A length that is not a whole number of groups exercises the zero
    pad (the padded group's count must read 0)."""
    import jax.numpy as jnp

    n = 300 * 256 + 77
    vals = np.where(
        rng.random(n) < 0.05,
        rng.integers(-200, 201, n),
        rng.integers(-8, 8, n),
    ).astype(np.int32)
    got = exceptions.compact_exceptions(jnp.asarray(vals), slots=16)
    padded = np.concatenate([vals, np.zeros((-n) % 256, np.int32)])
    want = _np_exception_tables(padded, 16, 0)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_expand_pair_roundtrip(rng):
    """_expand_pair inverts the pair permutation: exceptions listed over
    the permuted flat order come back as sorted original-zigzag indices."""
    cube = 512
    cubes = 7
    q = np.where(
        rng.random(cubes * cube) < 0.03,
        rng.integers(-300, 301, cubes * cube),
        rng.integers(-8, 8, cubes * cube),
    ).astype(np.int32).reshape(cubes, cube)
    half = cube // 2
    qp = np.concatenate([q[:, 0::2], q[:, 1::2]], axis=1)
    import jax.numpy as jnp

    lidx, v, counts, ovf = exceptions.compact_exceptions(
        jnp.asarray(qp.reshape(-1)), slots=64, dc_stride=cube
    )
    assert not bool(ovf)
    idx, val = turbo._expand_pair(lidx, v, counts, cube)
    mask = (q.reshape(-1) < -8) | (q.reshape(-1) > 7)
    mask[::cube] = False  # DC rides the dense stream
    widx = np.flatnonzero(mask)
    np.testing.assert_array_equal(idx, widx)
    np.testing.assert_array_equal(val, q.reshape(-1)[widx])
    assert half == 256  # geometry assumed above


def test_turbo_pixels_identical_to_reference():
    cfg = CodecConfig()
    video = synthetic_video(16, 32, 40, seed=31)
    ref = decode_video(encode_video(video, cfg), 40, 32, 16, cfg)
    data = turbo.encode_turbo_video(video, cfg)
    got = turbo.decode_turbo_container(data, 40, 32, cfg)
    np.testing.assert_array_equal(got, ref)
    members = multihost.split_members(data)
    assert [m[2] for m in members] == [turbo.MEMBER_TURBO] * 2
    assert turbo.is_turbo_container(members)


def test_turbo_slots_overflow_retry():
    cfg = CodecConfig(quant_strength=0)  # near-lossless: dense exceptions
    video = synthetic_video(8, 16, 16, seed=33)
    ref = decode_video(encode_video(video, cfg), 16, 16, 8, cfg)
    enc = turbo.TurboEncoder(16, 16, cfg, slots=2)  # force the retry path
    data = enc.push(video) + enc.finish()
    got = turbo.decode_turbo_container(data, 16, 16, cfg)
    np.testing.assert_array_equal(got, ref)


def test_turbo_transport_delta_transparent():
    cfg = CodecConfig(transport_delta=True)
    video = synthetic_video(16, 24, 32, seed=35)
    plain = turbo.decode_turbo_container(
        turbo.encode_turbo_video(video, CodecConfig()), 32, 24,
        CodecConfig(),
    )
    delta = turbo.decode_turbo_container(
        turbo.encode_turbo_video(video, cfg), 32, 24, cfg
    )
    np.testing.assert_array_equal(plain, delta)


def test_turbo_rate_beats_reference():
    """The coefficient-major wire layout compresses ~30% better than the
    reference profile at identical pixels.  Pin the win at a mid-size
    geometry — tiny clips carry relatively more per-member/zlib-stream
    overhead."""
    cfg = CodecConfig()
    video = synthetic_video(16, 240, 320, seed=37)
    ref = encode_video(video, cfg)
    data = turbo.encode_turbo_video(video, cfg)
    assert len(data) < len(ref), (len(data), len(ref))


def test_cli_turbo_roundtrip(tmp_path):
    import io
    from contextlib import redirect_stdout

    from dct3d_tpu.cli import main

    src = tmp_path / "src.raw"
    enc = tmp_path / "enc.d3t"
    dec = tmp_path / "dec.raw"
    video = synthetic_video(16, 32, 40, seed=39)
    src.write_bytes(video.tobytes())
    assert main(["encode", str(src), str(enc), "40", "32", "--turbo"]) == 0
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["info", str(enc)]) == 0
    info = json.loads(buf.getvalue())
    assert info["kind"] == "turbo"
    assert [m["type"] for m in info["members"]] == ["turbo", "turbo"]
    assert main(["decode", str(enc), str(dec), "40", "32"]) == 0
    want = decode_video(encode_video(video, CodecConfig()), 40, 32, 16,
                        CodecConfig())
    got = np.frombuffer(dec.read_bytes(), np.uint8).reshape(16, 32, 40)
    np.testing.assert_array_equal(got, want)
    # incompatible flag combos are rejected
    assert main(["encode", str(src), str(enc), "40", "32", "--turbo",
                 "--parity"]) == 2


def test_turbo_sharded_matches_single_device():
    import jax

    from dct3d_tpu.parallel import mesh as mesh_lib

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    cfg = CodecConfig()
    video = synthetic_video(32, 32, 40, seed=41)
    single = turbo.encode_turbo_video(video, cfg)
    m = mesh_lib.make_mesh(gop=2, tile=2, devices=jax.devices()[:4])
    enc = turbo.TurboShardedEncoder(40, 32, m, cfg)
    sharded = enc.push(video) + enc.finish()
    assert sharded == single


def test_turbo_sharded_overflow_retry():
    import jax

    from dct3d_tpu.parallel import mesh as mesh_lib

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    cfg = CodecConfig(quant_strength=0)  # dense exceptions
    video = synthetic_video(16, 16, 16, seed=43)
    single = turbo.encode_turbo_video(video, cfg)
    m = mesh_lib.make_mesh(gop=2, tile=1, devices=jax.devices()[:2])
    enc = turbo.TurboShardedEncoder(16, 16, m, cfg, slots=2)
    sharded = enc.push(video) + enc.finish()
    assert sharded == single


def test_cli_turbo_mesh(tmp_path):
    import jax

    from dct3d_tpu.cli import main

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    src = tmp_path / "src.raw"
    e1 = tmp_path / "a.d3t"
    e2 = tmp_path / "b.d3t"
    video = synthetic_video(16, 32, 40, seed=45)
    src.write_bytes(video.tobytes())
    assert main(["encode", str(src), str(e1), "40", "32", "--turbo"]) == 0
    assert main(["encode", str(src), str(e2), "40", "32", "--turbo",
                 "--mesh", "2x1"]) == 0
    assert e1.read_bytes() == e2.read_bytes()


def test_turbo_rgb_roundtrip(tmp_path):
    from dct3d_tpu.codec.rgb_codec import decode_rgb_video, encode_rgb_video
    from dct3d_tpu.cli import main

    cfg = CodecConfig()
    rgb = np.stack(
        [synthetic_video(16, 24, 32, seed=s) for s in (51, 52, 53)], axis=-1
    )
    want = decode_rgb_video(encode_rgb_video(rgb, cfg), 32, 24, cfg)
    data = turbo.encode_turbo_rgb_video(rgb, cfg)
    assert [m[2] for m in multihost.split_members(data)] == \
        [6, 6, 7, 7, 8, 8]
    got = turbo.decode_turbo_rgb_video(data, 32, 24, cfg)
    np.testing.assert_array_equal(got, want)
    # CLI: encode --rgb --turbo, decode with NO flags (auto-routed)
    src = tmp_path / "src.rgb"
    enc = tmp_path / "enc.d3t"
    dec = tmp_path / "dec.rgb"
    src.write_bytes(rgb.tobytes())
    assert main(["encode", str(src), str(enc), "32", "24", "--rgb",
                 "--turbo"]) == 0
    assert main(["decode", str(enc), str(dec), "32", "24"]) == 0
    np.testing.assert_array_equal(
        np.frombuffer(dec.read_bytes(), np.uint8).reshape(16, 24, 32, 3),
        want,
    )


def test_turbo_checkpoint_resume(tmp_path):
    from dct3d_tpu.codec.checkpoint import CheckpointingEncoder

    cfg = CodecConfig()
    video = synthetic_video(32, 24, 32, seed=61)
    path = str(tmp_path / "ckpt.d3t")
    with CheckpointingEncoder(path, 32, 24, cfg, checkpoint_gops=1,
                              turbo=True) as enc:
        enc.push(video[:16])
    # torn tail: cut into the last member, resume must drop it
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-5])
    with CheckpointingEncoder(path, 32, 24, cfg, checkpoint_gops=1,
                              turbo=True) as enc:
        assert enc.frames_done == 8
        enc.push(video[8:])
    whole = open(path, "rb").read()
    assert [m[2] for m in multihost.split_members(whole)] == [5] * 4
    got = turbo.decode_turbo_container(whole, 32, 24, cfg)
    np.testing.assert_array_equal(
        got, turbo.decode_turbo_container(
            turbo.encode_turbo_video(video, cfg), 32, 24, cfg)
    )
    # resuming with a non-turbo encoder must fail loudly (profile pinned)
    with pytest.raises(ValueError, match="resume parameters differ"):
        CheckpointingEncoder(path, 32, 24, cfg, checkpoint_gops=1)


def test_cli_turbo_checkpoint(tmp_path):
    from dct3d_tpu.cli import main

    src = tmp_path / "src.raw"
    enc = tmp_path / "c.d3t"
    dec = tmp_path / "dec.raw"
    video = synthetic_video(24, 32, 40, seed=63)
    src.write_bytes(video.tobytes())
    assert main(["encode", str(src), str(enc), "40", "32", "--turbo",
                 "--checkpoint-every", "2"]) == 0
    # decode with NO geometry flags: the .meta sidecar pins them
    assert main(["decode", str(enc), str(dec)]) == 0
    want = turbo.decode_turbo_container(
        turbo.encode_turbo_video(video, CodecConfig()), 40, 32,
        CodecConfig(),
    )
    np.testing.assert_array_equal(
        np.frombuffer(dec.read_bytes(), np.uint8).reshape(24, 32, 40), want
    )


def test_turbo_sharded_transport_delta_identical():
    """Regression (code review): the sharded turbo encoder ships raw
    frames, so cfg.transport_delta must not change its output."""
    import jax

    from dct3d_tpu.parallel import mesh as mesh_lib

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    cfg = CodecConfig(transport_delta=True)
    video = synthetic_video(16, 24, 32, seed=71)
    single = turbo.encode_turbo_video(video, cfg)
    m = mesh_lib.make_mesh(gop=2, tile=1, devices=jax.devices()[:2])
    enc = turbo.TurboShardedEncoder(32, 24, m, cfg)
    sharded = enc.push(video) + enc.finish()
    assert sharded == single


def test_turbo_block4_odd_group_count():
    """Regression: block-4 geometries where w*h*gop % 256 != 0 must encode
    (zero-pad inside the exception compaction), matching the reference
    profile's pixels."""
    cfg = CodecConfig(block_w=4, block_h=4, block_d=4)
    video = synthetic_video(8, 36, 36, seed=73)
    ref = decode_video(encode_video(video, cfg), 36, 36, 8, cfg)
    data = turbo.encode_turbo_video(video, cfg)
    got = turbo.decode_turbo_container(data, 36, 36, cfg)
    np.testing.assert_array_equal(got, ref)


def test_cli_rgb_turbo_rejects_index_and_parity(tmp_path):
    from dct3d_tpu.cli import main

    src = tmp_path / "src.rgb"
    rgb = np.stack(
        [synthetic_video(8, 16, 16, seed=s) for s in (81, 82, 83)], axis=-1
    )
    src.write_bytes(rgb.tobytes())
    out = str(tmp_path / "o.d3t")
    assert main(["encode", str(src), out, "16", "16", "--rgb", "--turbo",
                 "--index"]) == 2
    assert main(["encode", str(src), out, "16", "16", "--rgb", "--turbo",
                 "--parity"]) == 2


def test_multihost_turbo_single_process_equals_single_device():
    import jax

    from dct3d_tpu.parallel import mesh as mesh_lib

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    cfg = CodecConfig()
    video = synthetic_video(24, 24, 32, seed=91)  # 2 mesh GOPs + 1 tail
    m = mesh_lib.make_mesh(gop=2, tile=1, devices=jax.devices()[:2])
    data = multihost.encode_multihost(video, 32, 24, 24, m, cfg, turbo=True)
    assert data == turbo.encode_turbo_video(video, cfg)
    got = turbo.decode_turbo_container(data, 32, 24, cfg)
    np.testing.assert_array_equal(
        got, turbo.decode_turbo_container(
            turbo.encode_turbo_video(video, cfg), 32, 24, cfg)
    )


def test_decode_auto_routes_every_form(tmp_path):
    from dct3d_tpu import decode_auto
    from dct3d_tpu.codec.rgb_codec import encode_rgb_video

    cfg = CodecConfig()
    video = synthetic_video(16, 24, 32, seed=95)
    raw = encode_video(video, cfg)
    want = decode_video(raw, 32, 24, 16, cfg)
    np.testing.assert_array_equal(decode_auto(raw, 32, 24, 16), want)
    with pytest.raises(ValueError, match="headerless"):
        decode_auto(raw, 32, 24)
    indexed = multihost._member(raw, 16)
    np.testing.assert_array_equal(decode_auto(indexed, 32, 24), want)
    np.testing.assert_array_equal(
        decode_auto(turbo.encode_turbo_video(video, cfg), 32, 24), want
    )
    np.testing.assert_array_equal(
        decode_auto(turbo.encode_turbo_video(video, cfg), 32, 24, 8),
        want[:8],
    )
    rgb = np.stack([video, video[::-1], video], axis=-1)
    wrgb = decode_auto(encode_rgb_video(rgb, cfg), 32, 24)
    np.testing.assert_array_equal(
        decode_auto(turbo.encode_turbo_rgb_video(rgb, cfg), 32, 24), wrgb
    )


def test_torn_turbo_member_clear_error():
    cfg = CodecConfig()
    video = synthetic_video(8, 16, 16, seed=97)
    data = turbo.encode_turbo_video(video, cfg)
    torn = data[:-9]
    with pytest.raises(EOFError, match="torn turbo member"):
        turbo.decode_turbo_container(torn, 16, 16, cfg)


def test_turbo_codec_zstd_default_and_zlib_cross_read():
    """The payload codec (zstd default / zlib option) is sniffed per
    stream: either decoder config reads either wire, including a container
    mixing members from both encoders; zstd is also the smaller wire."""
    pytest.importorskip("zstandard")
    video = synthetic_video(16, 32, 40, seed=41)
    z = turbo.encode_turbo_video(video, CodecConfig(turbo_codec="zstd"))
    d = turbo.encode_turbo_video(video, CodecConfig(turbo_codec="zlib"))
    assert z != d
    want = turbo.decode_turbo_container(d, 40, 32, CodecConfig())
    # cross-read: cfg's codec setting is irrelevant on decode
    np.testing.assert_array_equal(
        turbo.decode_turbo_container(z, 40, 32,
                                     CodecConfig(turbo_codec="zlib")),
        want,
    )
    # container mixing zstd and zlib members decodes too
    zm, dm = multihost.split_members(z), multihost.split_members(d)
    mixed = b"".join(
        turbo._member(m[1], m[0], m[2])
        for m in [zm[0], dm[1]]
    )
    np.testing.assert_array_equal(
        turbo.decode_turbo_container(mixed, 40, 32, CodecConfig()), want
    )


def test_turbo_zstd_rate_envelope():
    """zstd-10 (the rate knee) beats zlib-6; the speed-knee default
    (zstd-3, several times faster to compress) stays within a +6-12%
    envelope of it."""
    pytest.importorskip("zstandard")
    video = synthetic_video(16, 240, 320, seed=43)
    z10 = turbo.encode_turbo_video(
        video, CodecConfig(turbo_codec="zstd", turbo_zstd_level=10)
    )
    z3 = turbo.encode_turbo_video(video, CodecConfig(turbo_codec="zstd"))
    d = turbo.encode_turbo_video(
        video, CodecConfig(turbo_codec="zlib", zlib_level=6)
    )
    assert len(z10) <= len(d) * 1.02, (len(z10), len(d))
    assert len(z3) <= len(z10) * 1.15, (len(z3), len(z10))


def test_turbo_sharded_decode_matches_single_device():
    import jax

    from dct3d_tpu.parallel import mesh as mesh_lib

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg = CodecConfig()
    # 5 GOPs: 2 full mesh steps (gop=2) + 1 tail member (single-device path)
    video = synthetic_video(40, 48, 40, seed=51)
    data = turbo.encode_turbo_video(video, cfg)
    want = turbo.decode_turbo_container(data, 40, 48, cfg)
    for g, t in [(2, 2), (4, 1), (1, 3), (2, 3)]:
        m = mesh_lib.make_mesh(gop=g, tile=t, devices=jax.devices()[: g * t])
        got = turbo.TurboShardedDecoder(40, 48, m, cfg).decode(data)
        np.testing.assert_array_equal(got, want, err_msg=f"mesh {g}x{t}")


def test_turbo_sharded_decode_transport_delta():
    import jax

    from dct3d_tpu.parallel import mesh as mesh_lib

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    cfg = CodecConfig(transport_delta=True)
    video = synthetic_video(32, 32, 40, seed=53)
    data = turbo.encode_turbo_video(video, cfg)
    want = turbo.decode_turbo_container(data, 40, 32, cfg)
    m = mesh_lib.make_mesh(gop=2, tile=2, devices=jax.devices()[:4])
    got = turbo.TurboShardedDecoder(40, 32, m, cfg).decode(data)
    np.testing.assert_array_equal(got, want)


def test_cli_turbo_mesh_decode(tmp_path):
    import jax

    from dct3d_tpu.cli import main

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    src = tmp_path / "src.raw"
    enc = tmp_path / "a.d3t"
    video = synthetic_video(16, 32, 40, seed=55)
    src.write_bytes(video.tobytes())
    assert main(["encode", str(src), str(enc), "40", "32", "--turbo"]) == 0
    d1, d2 = tmp_path / "d1.raw", tmp_path / "d2.raw"
    assert main(["decode", str(enc), str(d1), "40", "32"]) == 0
    assert main(["decode", str(enc), str(d2), "40", "32",
                 "--mesh", "2x1"]) == 0
    assert d1.read_bytes() == d2.read_bytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_turbo_corrupt_input_error_contract(seed):
    """Mutated or truncated turbo containers must raise EOFError or
    ValueError (never a raw codec exception or a crash): the zstd wire
    carries frame checksums, the zlib wire adler32, and _decompress
    translates both codecs' errors."""
    rng = np.random.default_rng(seed)
    cfg = CodecConfig()
    video = rng.integers(0, 256, (8, 16, 16), dtype=np.uint8)
    good = turbo.encode_turbo_video(video, cfg)
    for i in range(25):
        b = bytearray(good)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        for blob in (bytes(b), bytes(b)[: int(rng.integers(1, len(b)))]):
            try:
                turbo.decode_turbo_container(blob, 16, 16, cfg)
            except (EOFError, ValueError):
                pass


def test_turbo_without_zstandard_falls_back_to_zlib(monkeypatch):
    """Hosts without the zstandard module encode a zlib wire transparently
    (and still read zlib wires); only reading a ZSTD wire needs the module."""
    video = synthetic_video(8, 16, 16, seed=71)
    cfg = CodecConfig()  # turbo_codec="zstd", but the module is "absent":
    monkeypatch.setattr(turbo, "_zstd", None)
    data = turbo.encode_turbo_video(video, cfg)
    got = turbo.decode_turbo_container(data, 16, 16, cfg)
    monkeypatch.undo()
    want = turbo.decode_turbo_container(
        turbo.encode_turbo_video(video, CodecConfig(turbo_codec="zlib")),
        16, 16, cfg,
    )
    np.testing.assert_array_equal(got, want)
    # the fallback wire really is zlib (no zstd magic anywhere)
    assert turbo._ZSTD_MAGIC not in data


def test_turbo_quant0_falls_back_per_gop():
    """Near-lossless content floods the exception streams (-9% bpp vs the
    reference format at quant 0, BASELINE.md); affected GOPs must ship as
    reference-profile members chosen by MEASURED size, so the turbo
    container never exceeds the reference rate beyond the 16-byte member
    headers — and decodes pixel-identical through auto-routing."""
    cfg = CodecConfig(quant_strength=0)
    clip = synthetic_video(24, 64, 64, seed=77)
    data = turbo.encode_turbo_video(clip, cfg)
    members = multihost.split_members(data)
    types = [m[2] for m in members]
    assert multihost.MEMBER_TEMPORAL in types, types  # fallback triggered
    # rate: at worst the reference stream + per-member framing (16-byte
    # header + independent-DEFLATE restart) — closes the -9% corner to
    # well under 1%
    ref = encode_video(clip, cfg)
    assert len(data) <= len(ref) + 128 * len(members), (
        len(data), len(ref)
    )
    # pixels identical to the reference profile's decode
    want = decode_video(ref, 64, 64, 24, cfg)
    got = turbo.decode_turbo_container(data, 64, 64, cfg)
    np.testing.assert_array_equal(got, want)


def test_turbo_mixed_container_auto_detected():
    """A hybrid turbo container (some GOPs fell back) must still be
    routed as turbo by the detectors and the CLI info kind."""
    cfg = CodecConfig(quant_strength=0)
    clip = synthetic_video(16, 64, 64, seed=78)
    data = turbo.encode_turbo_video(clip, cfg)
    members = multihost.split_members(data)
    types = {m[2] for m in members}
    if turbo.MEMBER_TURBO in types and multihost.MEMBER_TEMPORAL in types:
        assert turbo.is_turbo_container(members)
    elif types <= {multihost.MEMBER_TEMPORAL}:
        # every GOP fell back: a plain temporal container, by design
        assert not turbo.is_turbo_container(members)
        assert multihost.container_kind(members) == "temporal"


def test_turbo_typical_content_never_falls_back():
    """The fallback probe must not fire on typical content (exceptions
    run 0.2-1.5% there): the fast path is unchanged."""
    cfg = CodecConfig()
    clip = synthetic_video(16, 64, 64, seed=79)
    data = turbo.encode_turbo_video(clip, cfg)
    assert all(
        m[2] == turbo.MEMBER_TURBO
        for m in multihost.split_members(data)
    )


def test_turbo_sharded_quant0_byte_identical():
    """The sharded turbo encoder must make the identical per-GOP fallback
    choice (same measured sizes) so mesh-vs-single byte identity holds at
    the degenerate corner too."""
    import jax

    from dct3d_tpu.parallel import mesh as mesh_lib

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    m = mesh_lib.make_mesh(gop=2, tile=2, devices=jax.devices()[:4])
    cfg = CodecConfig(quant_strength=0)
    clip = synthetic_video(16, 64, 64, seed=80)
    want = turbo.encode_turbo_video(clip, cfg)
    enc = turbo.TurboShardedEncoder(64, 64, m, cfg)
    got = enc.push(clip) + enc.finish()
    assert got == want
    # and the sharded decoder reads the hybrid container
    dec = turbo.TurboShardedDecoder(64, 64, m, cfg)
    np.testing.assert_array_equal(
        dec.decode(got), turbo.decode_turbo_container(want, 64, 64, cfg)
    )


def test_turbo_rgb_quant0_roundtrip():
    """RGB turbo at quant 0: per-channel fallback members (types 1/2/3)
    are detected and decode pixel-identical to the rgb reference."""
    cfg = CodecConfig(quant_strength=0)
    rng = np.random.default_rng(81)
    clip = synthetic_video(8, 64, 64, seed=81)
    rgbclip = np.stack(
        [clip, np.roll(clip, 1, axis=1), np.roll(clip, 2, axis=2)], axis=-1
    )
    data = turbo.encode_turbo_rgb_video(rgbclip, cfg)
    members = multihost.split_members(data)
    assert turbo.is_turbo_rgb_container(members) or all(
        m[2] in (1, 2, 3) for m in members
    )
    if turbo.is_turbo_rgb_container(members):
        got = turbo.decode_turbo_rgb_video(data, 64, 64, cfg)
        from dct3d_tpu.codec.rgb_codec import encode_rgb_video, decode_rgb_video

        want = decode_rgb_video(encode_rgb_video(rgbclip, cfg), 64, 64, cfg)
        np.testing.assert_array_equal(got, want)


def test_all_fallback_turbo_rgb_routes_and_decodes():
    """Regression: a turbo-RGB encode where EVERY GOP of every channel
    degenerated (quant 0 noise) carries only channel-typed fallback
    members; it must still route (is_turbo_rgb_container) and decode to
    the reference profile's pixels through decode_auto and the CLI."""
    from dct3d_tpu import decode_auto
    from dct3d_tpu.codec.rgb_codec import encode_rgb_video
    from dct3d_tpu.codec.rgb_codec import decode_rgb_video

    cfg = CodecConfig(quant_strength=0)
    rng = np.random.default_rng(31)
    rgb = rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    data = turbo.encode_turbo_rgb_video(rgb, cfg)
    members = multihost.split_members(data)
    types = sorted({m[2] for m in members})
    assert types == [1, 2, 3], types  # every GOP fell back
    assert turbo.is_turbo_rgb_container(members)
    want = decode_rgb_video(encode_rgb_video(rgb, cfg), 32, 32, cfg)
    got = decode_auto(data, 32, 32, cfg=cfg)
    np.testing.assert_array_equal(got, want)
    # range decode across the same container
    got_r = turbo.decode_turbo_rgb_range(data, 32, 32, 3, 11, cfg)
    np.testing.assert_array_equal(got_r, want[3:11])


def test_multihost_decode_rejects_mixed_turbo_container():
    """Regression: decode_multihost_container silently decoded only the
    TEMPORAL fallback members of a mixed turbo container (wrong, shorter
    video); it must reject with ValueError directing to the turbo route."""
    cfg = CodecConfig(quant_strength=0)
    # Flat GOPs keep the turbo wire (only dense DC); noise GOPs flood the
    # exception streams at quant 0 and fall back -> a genuinely MIXED
    # container.
    clip = np.full((24, 64, 64), 128, np.uint8)
    clip[16:] = np.random.default_rng(77).integers(
        0, 256, (8, 64, 64), dtype=np.uint8
    )
    data = turbo.encode_turbo_video(clip, cfg)
    types = {m[2] for m in multihost.split_members(data)}
    assert types == {turbo.MEMBER_TURBO, multihost.MEMBER_TEMPORAL}, types
    with pytest.raises(ValueError):
        multihost.decode_multihost_container(data, 64, 64, cfg)
    with pytest.raises(ValueError):
        multihost.decode_container_range(data, 64, 64, 0, 8, cfg)
    # the sanctioned routes still read it
    np.testing.assert_array_equal(
        turbo.decode_turbo_container(data, 64, 64, cfg),
        decode_video(encode_video(clip, cfg), 64, 64, 24, cfg),
    )
