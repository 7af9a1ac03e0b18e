"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4 item 5).

The crucial property: a (gop x tile)-sharded encode must produce the SAME
BYTES as the single-device encoder — the bitstream has no notion of the mesh.
"""

import os
import numpy as np
import pytest

import jax

from dct3d_tpu import CodecConfig, encode_video, decode_video, psnr
from dct3d_tpu.parallel import mesh as mesh_lib
from dct3d_tpu.parallel.sharding import ShardedDecoder, ShardedEncoder

from conftest import synthetic_video


def _mesh_or_skip(gop, tile):
    if len(jax.devices()) < gop * tile:
        pytest.skip(f"needs {gop * tile} devices")
    return mesh_lib.make_mesh(gop=gop, tile=tile, devices=jax.devices()[: gop * tile])


@pytest.mark.parametrize("gop,tile", [(1, 1), (4, 1), (1, 4), (4, 2), (2, 4)])
def test_sharded_encode_matches_single_device(gop, tile):
    m = _mesh_or_skip(gop, tile)
    cfg = CodecConfig()
    clip = synthetic_video(8 * gop * 2, 64, 64, seed=7)
    want = encode_video(clip, cfg)

    enc = ShardedEncoder(64, 64, m, cfg)
    got = enc.push(clip) + enc.finish()
    assert got == want


def test_sharded_encode_multiple_pushes():
    m = _mesh_or_skip(2, 2)
    cfg = CodecConfig()
    clip = synthetic_video(8 * 2 * 3, 64, 64, seed=8)
    want = encode_video(clip, cfg)
    enc = ShardedEncoder(64, 64, m, cfg)
    chunks = [enc.push(clip[i : i + 16]) for i in range(0, clip.shape[0], 16)]
    chunks.append(enc.finish())
    assert b"".join(chunks) == want


@pytest.mark.parametrize("gop,tile", [(2, 2), (8, 1), (1, 8)])
def test_sharded_decode_roundtrip(gop, tile):
    m = _mesh_or_skip(gop, tile)
    cfg = CodecConfig()
    clip = synthetic_video(8 * gop, 64, 64, seed=9)
    data = encode_video(clip, cfg)
    dec = ShardedDecoder(64, 64, m, cfg)
    got = dec.decode(data, clip.shape[0])
    want = decode_video(data, 64, 64, clip.shape[0], cfg)
    np.testing.assert_array_equal(got, want)
    assert psnr(clip, got) > 30.0


def test_mesh_validation():
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(gop=3, tile=3, devices=jax.devices()[:8])
    m = _mesh_or_skip(2, 2)
    with pytest.raises(ValueError):
        ShardedEncoder(64, 60, m)  # height not splittable into block tiles


def test_multihost_single_process_equals_sharded():
    """1-process multihost path == sharded encoder; span math is balanced."""
    from dct3d_tpu.parallel import multihost

    m = _mesh_or_skip(2, 1)
    cfg = CodecConfig()
    clip = synthetic_video(32, 64, 64, seed=11)
    data = multihost.encode_multihost(clip, 64, 64, 32, m, cfg)
    members = multihost.split_members(data)
    assert [m[0] for m in members] == [32]
    assert members[0][1] == encode_video(clip, cfg)  # payload byte parity
    out = multihost.decode_multihost_container(data, 64, 64, cfg)
    assert psnr(clip, out) > 30.0

    # Span arithmetic: contiguous, GOP-aligned, balanced to one GOP.
    spans = [multihost.host_frame_span(100, cfg, p, 3) for p in range(3)]
    assert spans[0][0] == 0 and spans[-1][1] == 96
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    sizes = [b - a for a, b in spans]
    assert max(sizes) - min(sizes) <= cfg.gop_size
    assert all(s % cfg.gop_size == 0 for s in sizes)


def test_multihost_container_roundtrip_two_members():
    """Two spans wrapped as container members decode to one video."""
    from dct3d_tpu.parallel import multihost

    cfg = CodecConfig()
    clip = synthetic_video(32, 64, 64, seed=12)
    a = encode_video(clip[:16], cfg)
    b = encode_video(clip[16:], cfg)
    data = multihost._member(a, 16) + multihost._member(b, 16)
    out = multihost.decode_multihost_container(data, 64, 64, cfg)
    assert out.shape == (32, 64, 64)
    assert psnr(clip, out) > 30.0


def test_sharded_parallel_deflate_payload_parity():
    import zlib

    m = _mesh_or_skip(2, 1)
    clip = synthetic_video(16, 64, 64, seed=13)
    want = encode_video(clip, CodecConfig())
    enc = ShardedEncoder(64, 64, m, CodecConfig(deflate_workers=2))
    got = enc.push(clip) + enc.finish()
    assert zlib.decompress(got) == zlib.decompress(want)


def test_multihost_encodes_tail_gops():
    """A host span that doesn't fill the gop mesh axis must not lose frames
    (tail GOPs become their own member)."""
    from dct3d_tpu.parallel import multihost

    m = _mesh_or_skip(2, 1)
    cfg = CodecConfig()
    clip = synthetic_video(24, 64, 64, seed=25)  # 3 GOPs on a gop=2 mesh
    data = multihost.encode_multihost(clip, 64, 64, 24, m, cfg)
    members = multihost.split_members(data)
    assert [m[0] for m in members] == [16, 8]
    out = multihost.decode_multihost_container(data, 64, 64, cfg)
    assert out.shape == (24, 64, 64)
    assert psnr(clip, out) > 30.0


def test_multihost_two_process_simulation():
    """Spawn a REAL 2-process jax.distributed run on CPU and validate the
    cross-process member gather (tools/multihost_sim.py)."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__), "..",
                                      "tools", "multihost_sim.py")],
        capture_output=True, text=True, timeout=280,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "MULTIHOST SIM PASSED" in r.stdout


def test_sharded_decoder_streams_multi_step():
    """Long stream (4 mesh steps): the streaming sharded decoder (parallel
    entropy + windowed device steps) matches the single-device decode."""
    from dct3d_tpu.codec.decoder import decode_video

    m = _mesh_or_skip(2, 1)
    cfg = CodecConfig()
    clip = synthetic_video(64, 64, 64, seed=31)
    data = encode_video(clip, cfg)
    want = decode_video(data, 64, 64, 64, cfg)
    got = ShardedDecoder(64, 64, m, cfg).decode(data, 64)
    np.testing.assert_array_equal(got, want)


def test_sharded_decode_stream_bounded_rss():
    """decode_stream yields per-step batches at O(step) RSS: the inflate
    window's high-water mark stays near one in-flight span, far below the
    whole payload."""
    from dct3d_tpu.codec import entropy
    from dct3d_tpu.codec.decoder import decode_video

    m = _mesh_or_skip(2, 1)
    cfg = CodecConfig()
    clip = synthetic_video(8 * 2 * 12, 64, 64, seed=41)  # 12 mesh steps
    data = encode_video(clip, cfg)
    want = decode_video(data, 64, 64, clip.shape[0], cfg)
    # Tiny pump chunks so the window only grows on demand; 2 workers pin
    # the in-flight span (the bound is O(workers * step), not O(stream)).
    win = entropy.InflateWindow(data, chunk_bytes=1024)
    dec = ShardedDecoder(64, 64, m, cfg, entropy_workers=2)
    batches = list(dec.decode_stream(data, clip.shape[0], _window=win))
    assert [b.shape[0] for b in batches] == [16] * 12
    np.testing.assert_array_equal(np.concatenate(batches), want)
    # Whole inflated payload would be ~total_bits/8; a bounded window on a
    # 12-step stream with 2 workers must hold well under half of it.
    whole = len(__import__("zlib").decompress(data))
    assert win.max_held < whole // 2, (win.max_held, whole)


def test_sharded_decode_stream_indexed_and_serial():
    """The indexed path (no scan) and the no-native serial fallback both
    produce identical frames through the bounded window."""
    from unittest import mock

    from dct3d_tpu import native
    from dct3d_tpu.codec.decoder import decode_video
    from dct3d_tpu.codec.encoder import StreamingEncoder
    from dct3d_tpu.parallel.multihost import gop_positions

    m = _mesh_or_skip(2, 1)
    cfg = CodecConfig()
    clip = synthetic_video(8 * 2 * 3, 64, 64, seed=43)
    enc = StreamingEncoder(64, 64, cfg)
    stream = enc.push(clip) + enc.finish()
    positions = gop_positions(
        enc.gop_bit_ends, clip.shape[0] // cfg.gop_size, cfg.gop_size,
        clip.shape[0],
    )
    want = decode_video(stream, 64, 64, clip.shape[0], cfg)
    dec = ShardedDecoder(64, 64, m, cfg)
    got = dec.decode(stream, clip.shape[0], positions=positions)
    np.testing.assert_array_equal(got, want)
    with mock.patch.object(native, "load", lambda: None):
        got2 = ShardedDecoder(64, 64, m, cfg).decode(stream, clip.shape[0])
    np.testing.assert_array_equal(got2, want)


def test_cli_mesh_encode_decode(tmp_path):
    """CLI --mesh: sharded encode is byte-identical to single-device encode;
    sharded decode reproduces the single-device decode."""
    import jax

    from dct3d_tpu import cli
    from dct3d_tpu.io import rawvideo

    if len(jax.devices()) < 4:
        import pytest

        pytest.skip("needs >= 4 virtual devices")
    d = str(tmp_path)
    clip = synthetic_video(32, 64, 64, seed=32)
    rawvideo.write_video(f"{d}/src.raw", clip)
    assert cli.main(["encode", f"{d}/src.raw", f"{d}/a.bin", "64", "64"]) == 0
    assert cli.main(["encode", f"{d}/src.raw", f"{d}/b.bin", "64", "64",
                     "--mesh", "2x2", "--parity"]) == 0
    assert cli.main(["encode", f"{d}/src.raw", f"{d}/c.bin", "64", "64",
                     "--parity"]) == 0
    assert open(f"{d}/b.bin", "rb").read() == open(f"{d}/c.bin", "rb").read()
    assert cli.main(["decode", f"{d}/a.bin", f"{d}/a.raw", "64", "64",
                     "32"]) == 0
    assert cli.main(["decode", f"{d}/a.bin", f"{d}/m.raw", "64", "64", "32",
                     "--mesh", "4x1"]) == 0
    np.testing.assert_array_equal(
        rawvideo.read_video(f"{d}/m.raw", 64, 64),
        rawvideo.read_video(f"{d}/a.raw", 64, 64),
    )


def test_cli_mesh_too_many_devices(tmp_path, capsys):
    from dct3d_tpu import cli

    d = str(tmp_path)
    clip = synthetic_video(16, 64, 64, seed=33)
    from dct3d_tpu.io import rawvideo

    rawvideo.write_video(f"{d}/src.raw", clip)
    assert cli.main(["encode", f"{d}/src.raw", f"{d}/x.bin", "64", "64",
                     "--mesh", "64x1"]) == 2


@pytest.mark.parametrize("tight_cfg", [
    dict(quant_strength=0, pack_bits_per_value=2),   # per-group overflow
    dict(stream_bits_per_value=1),                   # stream-buffer overflow
])
def test_sharded_overflow_retries_worst_case(tight_cfg):
    """A shard blowing its budget must transparently retry with the
    worst-case buffer and stay byte-identical to the single-device encoder
    under the same config (the single-device driver has the same retry)."""
    m = _mesh_or_skip(2, 2)
    cfg = CodecConfig(**tight_cfg)
    clip = synthetic_video(16, 64, 64, seed=41)
    want = encode_video(clip, cfg)
    enc = ShardedEncoder(64, 64, m, cfg)
    got = enc.push(clip) + enc.finish()
    assert got == want


def test_sharded_budget_ladder_climbs_on_noise():
    """Sustained overflow must climb the sharded driver's budget ladder
    permanently (same machinery as StreamingEncoder) with byte identity
    to the single-device stream across the switch."""
    m = _mesh_or_skip(2, 2)
    rng = np.random.default_rng(3)
    noise = rng.integers(0, 256, (64, 64, 64), dtype=np.uint8)
    enc = ShardedEncoder(64, 64, m, CodecConfig())
    got = enc.push(noise) + enc.finish()
    assert enc._ladder.level > 0  # the ladder climbed mid-stream
    assert got == encode_video(noise, CodecConfig())


def test_sharded_720p_one_step_byte_identity():
    """Realistic geometry: one (gop=4, tile=2) mesh
    step at 1280x720 — 14,400 cubes/GOP — pins shard-boundary arithmetic
    at real cube counts: the sharded bitstream must be byte-identical to
    the single-device encoder's, and the sharded turbo members identical
    to the single-device turbo encoder's.  Slow (~1-2 min on the CPU
    mesh); one step bounds it."""
    from dct3d_tpu.codec import turbo

    m = _mesh_or_skip(4, 2)
    cfg = CodecConfig()
    clip = synthetic_video(32, 720, 1280, seed=90)
    want = encode_video(clip, cfg)
    enc = ShardedEncoder(1280, 720, m, cfg)
    got = enc.push(clip) + enc.finish()
    assert got == want
    tenc = turbo.TurboShardedEncoder(1280, 720, m, cfg)
    tgot = tenc.push(clip) + tenc.finish()
    assert tgot == turbo.encode_turbo_video(clip, cfg)
