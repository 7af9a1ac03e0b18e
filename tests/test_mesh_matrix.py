"""CLI/API feature-matrix on a device mesh: --rgb, --checkpoint-every, and
--turbo --checkpoint-every all compose with --mesh.

Every sharded encoder is byte-identical to its single-device counterpart
(parallel/sharding.py invariant), so each combination is pinned by literal
byte equality of the produced containers — the strongest possible test.
"""

import numpy as np
import pytest

from dct3d_tpu import CodecConfig
from dct3d_tpu.codec.checkpoint import CheckpointingEncoder
from dct3d_tpu.codec.rgb_codec import decode_rgb_video, encode_rgb_video
from dct3d_tpu.parallel.mesh import make_mesh

from conftest import synthetic_video


def rgb_clip(t=16, h=64, w=64, seed=5):
    r = synthetic_video(t, h, w, seed=seed)
    g = synthetic_video(t, h, w, seed=seed + 1)
    b = synthetic_video(t, h, w, seed=seed + 2)
    return np.stack([r, g, b], axis=-1)


@pytest.fixture
def mesh22():
    import jax

    return make_mesh(gop=2, tile=2, devices=jax.devices()[:4])


@pytest.fixture
def mesh21():
    import jax

    return make_mesh(gop=2, tile=1, devices=jax.devices()[:2])


def test_rgb_mesh_byte_identical(mesh22):
    clip = rgb_clip()
    cfg = CodecConfig()
    want = encode_rgb_video(clip, cfg)
    got = encode_rgb_video(clip, cfg, mesh=mesh22)
    assert got == want
    out = decode_rgb_video(got, 64, 64, cfg)
    assert out.shape == clip.shape


def test_rgb_mesh_with_index_byte_identical(mesh21):
    clip = rgb_clip(seed=9)
    cfg = CodecConfig()
    want = encode_rgb_video(clip, cfg, index=True)
    got = encode_rgb_video(clip, cfg, index=True, mesh=mesh21)
    assert got == want


def test_turbo_rgb_mesh_byte_identical(mesh22):
    from dct3d_tpu.codec.turbo import (
        decode_turbo_rgb_video, encode_turbo_rgb_video,
    )

    clip = rgb_clip(seed=7)
    cfg = CodecConfig()
    want = encode_turbo_rgb_video(clip, cfg)
    got = encode_turbo_rgb_video(clip, cfg, mesh=mesh22)
    assert got == want
    out = decode_turbo_rgb_video(got, 64, 64, cfg)
    np.testing.assert_array_equal(out, decode_turbo_rgb_video(want, 64, 64, cfg))


def test_checkpoint_mesh_byte_identical(tmp_path, mesh22):
    """Members from the sharded encoder equal the single-device members
    when the checkpoint interval is whole mesh steps."""
    cfg = CodecConfig()
    clip = synthetic_video(32, 64, 64, seed=30)
    a, b = str(tmp_path / "a.d3mh"), str(tmp_path / "b.d3mh")
    with CheckpointingEncoder(a, 64, 64, cfg, checkpoint_gops=2) as enc:
        enc.push(clip)
    with CheckpointingEncoder(b, 64, 64, cfg, checkpoint_gops=2,
                              mesh=mesh22) as enc:
        enc.push(clip)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_checkpoint_resume_across_mesh_change(tmp_path, mesh21):
    """Byte identity means a resume may drop or change the mesh freely:
    half on a mesh + half single-device == one uninterrupted run."""
    cfg = CodecConfig()
    clip = synthetic_video(32, 64, 64, seed=31)
    a, b = str(tmp_path / "a.d3mh"), str(tmp_path / "b.d3mh")
    with CheckpointingEncoder(a, 64, 64, cfg, checkpoint_gops=2) as enc:
        enc.push(clip)
    with CheckpointingEncoder(b, 64, 64, cfg, checkpoint_gops=2,
                              mesh=mesh21) as enc:
        enc.push(clip[:16])
    with CheckpointingEncoder(b, 64, 64, cfg, checkpoint_gops=2) as enc:
        assert enc.frames_done == 16
        enc.push(clip[16:])
    assert open(a, "rb").read() == open(b, "rb").read()


def test_turbo_checkpoint_mesh_byte_identical(tmp_path, mesh21):
    cfg = CodecConfig()
    clip = synthetic_video(32, 64, 64, seed=32)
    a, b = str(tmp_path / "a.d3t"), str(tmp_path / "b.d3t")
    with CheckpointingEncoder(a, 64, 64, cfg, checkpoint_gops=2,
                              turbo=True) as enc:
        enc.push(clip)
    with CheckpointingEncoder(b, 64, 64, cfg, checkpoint_gops=2, turbo=True,
                              mesh=mesh21) as enc:
        enc.push(clip)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_checkpoint_mesh_push_alignment_error(tmp_path, mesh21):
    cfg = CodecConfig()
    clip = synthetic_video(8, 64, 64, seed=33)
    with CheckpointingEncoder(str(tmp_path / "x.d3mh"), 64, 64, cfg,
                              checkpoint_gops=2, mesh=mesh21) as enc:
        with pytest.raises(ValueError, match="multiple of 16"):
            enc.push(clip)


def test_cli_mesh_matrix(tmp_path, capsys):
    """The CLI combinations once rejected with --mesh now round-trip,
    and the containers equal their single-device twins byte-for-byte."""
    from dct3d_tpu import cli
    from dct3d_tpu.io import rawvideo

    gray = synthetic_video(32, 64, 64, seed=40)
    color = rgb_clip(t=16, seed=41)
    src = str(tmp_path / "g.raw")
    srgb = str(tmp_path / "c.rgb")
    rawvideo.write_video(src, gray)
    color.tofile(srgb)

    # --rgb --mesh.  Byte identity needs the serial DEFLATE sink: the
    # parallel sink's block boundaries follow push cadence (per GOP vs per
    # mesh step), changing the wire layout only (CLAUDE.md invariant).
    a, b = str(tmp_path / "r1.bin"), str(tmp_path / "r2.bin")
    assert cli.main(["encode", srgb, a, "64", "64", "--rgb",
                     "--deflate-workers", "0"]) == 0
    assert cli.main(["encode", srgb, b, "64", "64", "--rgb",
                     "--mesh", "2x2", "--deflate-workers", "0"]) == 0
    assert open(a, "rb").read() == open(b, "rb").read()
    dec = str(tmp_path / "r.raw")
    assert cli.main(["decode", b, dec, "64", "64"]) == 0  # auto-routes

    # Parallel sink: bytes may differ, decoded pixels must not.
    c = str(tmp_path / "r3.bin")
    assert cli.main(["encode", srgb, c, "64", "64", "--rgb",
                     "--mesh", "2x2"]) == 0
    d1, d2 = str(tmp_path / "d1.raw"), str(tmp_path / "d2.raw")
    assert cli.main(["decode", b, d1, "64", "64"]) == 0
    assert cli.main(["decode", c, d2, "64", "64"]) == 0
    np.testing.assert_array_equal(
        np.fromfile(d1, np.uint8), np.fromfile(d2, np.uint8)
    )

    # --checkpoint-every --mesh
    a, b = str(tmp_path / "k1.d3mh"), str(tmp_path / "k2.d3mh")
    assert cli.main(["encode", src, a, "64", "64",
                     "--checkpoint-every", "2", "--deflate-workers", "0"]) == 0
    assert cli.main(["encode", src, b, "64", "64", "--deflate-workers", "0",
                     "--checkpoint-every", "2", "--mesh", "2x1"]) == 0
    assert open(a, "rb").read() == open(b, "rb").read()

    # --turbo --checkpoint-every --mesh
    a, b = str(tmp_path / "t1.d3t"), str(tmp_path / "t2.d3t")
    assert cli.main(["encode", src, a, "64", "64", "--turbo",
                     "--checkpoint-every", "2"]) == 0
    assert cli.main(["encode", src, b, "64", "64", "--turbo",
                     "--checkpoint-every", "2", "--mesh", "2x1"]) == 0
    assert open(a, "rb").read() == open(b, "rb").read()
    out = str(tmp_path / "t.raw")
    assert cli.main(["decode", b, out, "64", "64"]) == 0


def test_checkpoint_mesh_rejects_misaligned_interval(tmp_path, mesh21):
    with pytest.raises(ValueError, match="not a multiple of"):
        CheckpointingEncoder(str(tmp_path / "x.d3mh"), 64, 64, CodecConfig(),
                             checkpoint_gops=3, mesh=mesh21)


def test_checkpoint_mesh_rejects_misaligned_resume(tmp_path, mesh21):
    """A single-device encode that stopped mid-mesh-step cannot silently
    resume on the mesh — the constructor says so instead of crashing in
    push with an opaque batch error."""
    cfg = CodecConfig()
    clip = synthetic_video(24, 64, 64, seed=50)
    p = str(tmp_path / "v.d3mh")
    with CheckpointingEncoder(p, 64, 64, cfg, checkpoint_gops=1) as enc:
        enc.push(clip)  # 3 GOPs: not a whole 2-gop mesh step
    with pytest.raises(ValueError, match="resume without --mesh"):
        CheckpointingEncoder(p, 64, 64, cfg, checkpoint_gops=2, mesh=mesh21)


def test_sharded_encoder_widens_after_repeated_overflow(mesh21, rng):
    """Noise above the stream budget: the sharded encoder must climb its
    budget ladder (like StreamingEncoder) and stay byte-exact."""
    from dct3d_tpu import encode_video
    from dct3d_tpu.parallel.sharding import ShardedEncoder

    noise = rng.integers(0, 256, (48, 64, 64), dtype=np.uint8)
    enc = ShardedEncoder(64, 64, mesh21, CodecConfig())
    chunks = [enc.push(noise[i : i + 16]) for i in range(0, 48, 16)]
    chunks.append(enc.finish())
    assert enc._ladder.level > 0  # settled on a wider rung
    assert b"".join(chunks) == encode_video(
        noise, CodecConfig(stream_bits_per_value=6)
    )


def test_turbo_checkpoint_mesh_resumes_at_any_gop(tmp_path, mesh21):
    """Turbo members are independent per GOP: a mesh resume from a
    non-step-aligned point (and a non-step checkpoint interval) must work
    and stay byte-identical — whole steps ride the sharded encoder, GOP
    tails a single-device encoder."""
    cfg = CodecConfig()
    clip = synthetic_video(48, 64, 64, seed=51)
    a, b = str(tmp_path / "a.d3t"), str(tmp_path / "b.d3t")
    with CheckpointingEncoder(a, 64, 64, cfg, checkpoint_gops=3,
                              turbo=True) as enc:
        enc.push(clip)
    with CheckpointingEncoder(b, 64, 64, cfg, checkpoint_gops=3,
                              turbo=True) as enc:
        enc.push(clip[:24])  # 3 GOPs: not a whole 2-gop mesh step
    with CheckpointingEncoder(b, 64, 64, cfg, checkpoint_gops=3, turbo=True,
                              mesh=mesh21) as enc:  # gops=3 OK for turbo
        assert enc.frames_done == 24
        enc.push(clip[24:])  # 24 frames = 1 mesh step + 1 GOP tail
    assert open(a, "rb").read() == open(b, "rb").read()


def test_cli_turbo_checkpoint_mesh_keeps_gop_tail(tmp_path):
    """The CLI must not step-truncate turbo checkpoint encodes on a mesh:
    56 frames = 3 mesh steps + 1 GOP tail, byte-identical to the
    single-device container (which keeps all 7 GOPs)."""
    from dct3d_tpu import cli
    from dct3d_tpu.io import rawvideo

    clip = synthetic_video(56, 64, 64, seed=52)
    src = str(tmp_path / "g.raw")
    rawvideo.write_video(src, clip)
    a, b = str(tmp_path / "a.d3t"), str(tmp_path / "b.d3t")
    assert cli.main(["encode", src, a, "64", "64", "--turbo",
                     "--checkpoint-every", "2"]) == 0
    assert cli.main(["encode", src, b, "64", "64", "--turbo",
                     "--checkpoint-every", "2", "--mesh", "2x1"]) == 0
    assert open(a, "rb").read() == open(b, "rb").read()
