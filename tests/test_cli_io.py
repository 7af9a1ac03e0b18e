"""CLI and I/O tooling tests: the end-to-end user workflow of the reference
(README.md:22-27): capture -> split -> encode -> decode -> mix -> render."""

import os

import numpy as np
import pytest

from dct3d_tpu import cli, metrics
from dct3d_tpu.io import rawvideo, render, rgb, synthetic


def test_rawvideo_roundtrip(tmp_path, clip):
    p = str(tmp_path / "v.raw")
    rawvideo.write_video(p, clip)
    assert rawvideo.frame_count(p, 64, 64) == clip.shape[0]
    back = rawvideo.read_video(p, 64, 64)
    np.testing.assert_array_equal(back, clip)
    batches = list(rawvideo.iter_frame_batches(p, 64, 64, 8))
    np.testing.assert_array_equal(np.concatenate(batches), clip)


def test_iter_batches_gop_aligned_tail(tmp_path, clip):
    p = str(tmp_path / "v.raw")
    rawvideo.write_video(p, clip[:16])
    # batch of 24 frames, align 8 -> one batch of 16
    batches = list(rawvideo.iter_frame_batches(p, 64, 64, 24, align=8))
    assert [b.shape[0] for b in batches] == [16]


def test_rgb_split_mix(tmp_path, rng):
    rgb_clip = rng.integers(0, 256, (4, 16, 16, 3)).astype(np.uint8)
    p = str(tmp_path / "v.rgb")
    rawvideo.write_video(p, rgb_clip)
    outs = rgb.split_file(p)
    r = rawvideo.read_video(outs[0], 16, 16)
    np.testing.assert_array_equal(r, rgb_clip[..., 0])
    mixed = str(tmp_path / "back.rgb")
    rgb.mix_files(p, mixed)
    back = rawvideo.read_video(mixed, 16, 16, channels=3)
    np.testing.assert_array_equal(back, rgb_clip)


def test_synthetic_pads_geometry(tmp_path):
    p = str(tmp_path / "cap.raw")
    t, h, w = synthetic.capture(p, 8, 60, 67)
    assert (h, w) == (64, 72)  # padded to block multiples
    assert os.path.getsize(p) == 8 * h * w


def test_render_png_and_stats(tmp_path, clip):
    p = str(tmp_path / "v.raw")
    rawvideo.write_video(p, clip)
    stats = render.video_stats(p, 64, 64)
    assert stats["frames"] == clip.shape[0]
    outs = render.render_frames(p, 64, 64, str(tmp_path / "img"), frames=[0])
    assert len(outs) == 1 and os.path.getsize(outs[0]) > 100
    with open(outs[0], "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_cli_end_to_end(tmp_path, capsys):
    d = str(tmp_path)
    src = f"{d}/src.raw"
    enc = f"{d}/enc.bin"
    dec = f"{d}/dec.raw"
    assert cli.main(["capture", src, "64", "64", "16", "--kind", "blocks"]) == 0
    assert cli.main(["encode", src, enc, "64", "64"]) == 0
    assert cli.main(["decode", enc, dec, "64", "64", "16"]) == 0
    assert cli.main(["psnr", src, dec, "64", "64"]) == 0
    out = capsys.readouterr().out
    assert "PSNR" in out
    a = rawvideo.read_video(src, 64, 64)
    b = rawvideo.read_video(dec, 64, 64)
    assert metrics.psnr(a, b) > 30.0
    assert os.path.getsize(enc) < os.path.getsize(src) / 3  # actually compresses


def test_cli_devices(capsys):
    assert cli.main(["devices"]) == 0
    assert "devices" in capsys.readouterr().out


def test_cli_decode_requires_frames(tmp_path, capsys):
    assert cli.main(["decode", "x", "y", "64", "64"]) == 2


def test_cli_sweep(tmp_path, capsys):
    import json

    out = str(tmp_path / "rd.json")
    rc = cli.main([
        "sweep", "synthetic", "32", "32", "16",
        "--quants", "2,10", "--blocks", "8", "--output", out,
    ])
    assert rc == 0
    rows = json.load(open(out))
    assert len(rows) == 2
    # Rate-distortion monotonicity: harsher quant -> fewer bits, lower PSNR.
    q2, q10 = rows
    assert q2["quant"] == 2 and q10["quant"] == 10
    assert q10["bpp"] < q2["bpp"]
    assert q10["psnr_db"] < q2["psnr_db"]
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(lines) == 2


def test_rgb_codec_roundtrip(tmp_path):
    from dct3d_tpu import decode_rgb_video, encode_rgb_video, psnr
    from dct3d_tpu.io import synthetic

    clip = synthetic.moving_gradient(16, 32, 32, rgb=True)
    data = encode_rgb_video(clip)
    out = decode_rgb_video(data, 32, 32)
    assert out.shape == clip.shape
    assert psnr(clip, out) > 30.0


def test_cli_rgb_encode_decode(tmp_path):
    from dct3d_tpu import psnr
    from dct3d_tpu.io import synthetic

    src = str(tmp_path / "c.rgb")
    enc = str(tmp_path / "c.bin")
    dec = str(tmp_path / "back.rgb")
    synthetic.capture(src, 16, 32, 32, rgb=True)
    assert cli.main(["encode", src, enc, "32", "32", "--rgb"]) == 0
    assert cli.main(["decode", enc, dec, "32", "32", "--rgb"]) == 0
    a = rawvideo.read_video(src, 32, 32, channels=3)
    b = rawvideo.read_video(dec, 32, 32, channels=3)
    assert psnr(a, b) > 30.0


def test_encode_determinism_parallel_deflate():
    """Same input -> identical bytes even with threaded DEFLATE (race guard,
    SURVEY.md §5 'race detection')."""
    from dct3d_tpu import CodecConfig, encode_video
    from conftest import synthetic_video

    clip = synthetic_video(16, 64, 64, seed=30)
    cfg = CodecConfig(deflate_workers=3)
    assert encode_video(clip, cfg) == encode_video(clip, cfg)


def test_cli_info(tmp_path, capsys):
    import json

    from dct3d_tpu import encode_video
    from dct3d_tpu.parallel.multihost import _member
    from conftest import synthetic_video

    clip = synthetic_video(16, 32, 32)
    raw = str(tmp_path / "v.bin")
    open(raw, "wb").write(encode_video(clip))
    assert cli.main(["info", raw]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["format"].startswith("raw-zlib")

    cont = str(tmp_path / "v.d3mh")
    open(cont, "wb").write(_member(encode_video(clip[:8]), 8)
                           + _member(encode_video(clip[8:]), 8))
    assert cli.main(["info", cont]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["format"] == "d3mh-container"
    assert out["frames"] == 16 and len(out["members"]) == 2


def test_cli_rgb_autoroutes_without_flag(tmp_path):
    """Member type tags make decode self-routing: an RGB container decodes
    correctly with NO --rgb flag, and a temporal container refuses --rgb."""
    from dct3d_tpu import psnr
    from dct3d_tpu.io import synthetic

    src = str(tmp_path / "c.rgb")
    enc = str(tmp_path / "c.bin")
    dec = str(tmp_path / "back.rgb")
    synthetic.capture(src, 16, 32, 32, rgb=True)
    assert cli.main(["encode", src, enc, "32", "32", "--rgb"]) == 0
    assert cli.main(["decode", enc, dec, "32", "32"]) == 0  # no --rgb
    a = rawvideo.read_video(src, 32, 32, channels=3)
    b = rawvideo.read_video(dec, 32, 32, channels=3)
    assert psnr(a, b) > 30.0


def test_rgb_container_rejected_by_temporal_decode(tmp_path):
    from dct3d_tpu.codec.rgb_codec import encode_rgb_video
    from dct3d_tpu.io import synthetic
    from dct3d_tpu.parallel.multihost import decode_multihost_container

    clip = synthetic.moving_gradient(8, 32, 32, rgb=True)
    data = encode_rgb_video(clip)
    with pytest.raises(ValueError, match="RGB channel members"):
        decode_multihost_container(data, 32, 32)


def test_cli_decode_honors_meta_sidecar(tmp_path, capsys):
    """Checkpoint-container decode pins cfg/geometry from the .meta sidecar,
    so mismatched CLI flags cannot silently produce garbage."""
    from dct3d_tpu import psnr
    from dct3d_tpu.io import synthetic

    src = str(tmp_path / "s.raw")
    enc = str(tmp_path / "s.d3mh")
    dec = str(tmp_path / "back.raw")
    synthetic.capture(src, 16, 32, 32)
    assert cli.main([
        "encode", src, enc, "32", "32", "--quant", "3",
        "--checkpoint-every", "1",
    ]) == 0
    # Wrong quant on the CLI: the sidecar must win.
    assert cli.main(["decode", enc, dec, "32", "32", "--quant", "20"]) == 0
    a = rawvideo.read_video(src, 32, 32)
    b = rawvideo.read_video(dec, 32, 32)
    assert psnr(a, b) > 30.0


def test_cli_decode_requires_geometry(tmp_path):
    """Flagless decode of a container without a .meta sidecar must fail
    cleanly, not crash on None geometry."""
    from dct3d_tpu.codec.rgb_codec import encode_rgb_video
    from dct3d_tpu.io import synthetic

    clip = synthetic.moving_gradient(8, 32, 32, rgb=True)
    cont = str(tmp_path / "c.bin")
    open(cont, "wb").write(encode_rgb_video(clip))
    assert cli.main(["decode", cont, str(tmp_path / "o.rgb")]) == 2


def test_cli_mesh_bad_spec(tmp_path):
    from dct3d_tpu.io import synthetic

    src = str(tmp_path / "s.raw")
    synthetic.capture(src, 8, 32, 32)
    assert cli.main(["encode", src, str(tmp_path / "o.bin"), "32", "32",
                     "--mesh", "2x2x2"]) == 2
    assert cli.main(["encode", src, str(tmp_path / "o.bin"), "32", "32",
                     "--mesh", "x2"]) == 2


def test_cli_pipe_roundtrip(tmp_path, monkeypatch):
    """'-' paths stream raw frames in on encode and raw pixels out on
    decode (ffmpeg-style piping); bytes identical to the file paths."""
    import io

    from dct3d_tpu.io import synthetic

    src = str(tmp_path / "s.raw")
    synthetic.capture(src, 16, 32, 32)
    raw = open(src, "rb").read()

    class _Buf:
        def __init__(self, data=b""):
            self.buffer = io.BytesIO(data)

    # encode: stdin -> stdout
    monkeypatch.setattr(cli.sys, "stdin", _Buf(raw))
    out = _Buf()
    monkeypatch.setattr(cli.sys, "stdout", out)
    assert cli.main(["encode", "-", "-", "32", "32", "--turbo"]) == 0
    piped = out.buffer.getvalue()
    monkeypatch.undo()
    enc = str(tmp_path / "e.d3t")
    assert cli.main(["encode", src, enc, "32", "32", "--turbo"]) == 0
    assert piped == open(enc, "rb").read()
    # decode: stdin -> stdout
    monkeypatch.setattr(cli.sys, "stdin", _Buf(piped))
    out = _Buf()
    monkeypatch.setattr(cli.sys, "stdout", out)
    assert cli.main(["decode", "-", "-", "32", "32"]) == 0
    monkeypatch.undo()
    dec = str(tmp_path / "d.raw")
    assert cli.main(["decode", enc, dec, "32", "32"]) == 0
    assert out.buffer.getvalue() == open(dec, "rb").read()
    # seek-dependent flags are rejected on stdout
    assert cli.main(["encode", src, "-", "32", "32", "--index"]) == 2


class _OnDemand:
    """Raw-frame pipe that materializes bytes only when read: a read()
    with no size argument (i.e. whole-pipe buffering) fails the test, so
    this pins the constant-RSS contract of `encode -` (
    the C encoder streams through a fixed buffer, encoder.c:203-278)."""

    def __init__(self, nbytes: int, chunk: int = 1 << 16):
        self.left = nbytes
        self.pos = 0
        self.chunk = chunk

    def read(self, n=None):
        assert n is not None and n > 0, \
            "encode - must stream bounded reads, never buffer the pipe"
        n = min(n, self.left, self.chunk)  # pipes return short reads
        if n == 0:
            return b""
        out = (np.arange(self.pos, self.pos + n) % 251).astype(np.uint8)
        self.pos += n
        self.left -= n
        return out.tobytes()


def test_cli_stdin_streams_constant_rss(tmp_path, monkeypatch):
    """stdin encode streams GOP batches (bounded reads, partial tail
    frame + non-GOP tail frames trimmed) and matches the file encode of
    the same trimmed footage byte-for-byte."""
    w = h = 32
    fsz = w * h
    # 19 whole frames (not a GOP multiple) plus half a frame of trailing
    # junk: the encoder must trim to 16 frames.
    total = 19 * fsz + fsz // 2

    class _Std:
        buffer = _OnDemand(total)

    monkeypatch.setattr(cli.sys, "stdin", _Std)
    enc_pipe = str(tmp_path / "p.bin")
    assert cli.main(["encode", "-", enc_pipe, "32", "32"]) == 0
    monkeypatch.undo()

    src = str(tmp_path / "s.raw")
    with open(src, "wb") as f:
        f.write(_OnDemand(total, chunk=1 << 30).read(19 * fsz))
    enc_file = str(tmp_path / "f.bin")
    assert cli.main(["encode", src, enc_file, "32", "32"]) == 0
    assert open(enc_pipe, "rb").read() == open(enc_file, "rb").read()


def test_stream_frames_batches():
    """StreamFrames unit behavior: align trimming, start skip, bounds."""
    import io

    from dct3d_tpu.io.rawvideo import StreamFrames

    w, h = 8, 4
    fsz = w * h
    frames = np.arange(23 * fsz, dtype=np.uint32).astype(np.uint8)
    video = frames.reshape(23, h, w)

    def stream():
        return StreamFrames(io.BytesIO(frames.tobytes()), w, h)

    got = list(stream().iter_batches(8, align=4))
    assert [b.shape[0] for b in got] == [8, 8, 4]  # tail 23 -> 20
    np.testing.assert_array_equal(np.concatenate(got), video[:20])
    # start skips (and still trims the tail)
    got = list(stream().iter_batches(8, align=4, start=4))
    np.testing.assert_array_equal(np.concatenate(got), video[4:20])
    # max_frames bounds the read even mid-stream
    got = list(stream().iter_batches(8, max_frames=12, align=4))
    np.testing.assert_array_equal(np.concatenate(got), video[:12])
    # an empty pipe yields nothing
    assert list(StreamFrames(io.BytesIO(b""), w, h).iter_batches(8)) == []


def test_cli_dtype_fast_profile(tmp_path, capsys):
    """--dtype bfloat16: stream decodes with the DEFAULT (f32) decoder
    within the pinned 0.7 dB of the parity stream; --parity rejects it."""
    import json

    d = str(tmp_path)
    src = f"{d}/src.raw"
    assert cli.main(["capture", src, "64", "64", "16", "--kind", "blocks"]) == 0
    assert cli.main(["encode", src, f"{d}/f32.bin", "64", "64"]) == 0
    assert cli.main(["encode", src, f"{d}/bf16.bin", "64", "64",
                     "--dtype", "bf16"]) == 0
    assert cli.main(["encode", src, f"{d}/x.bin", "64", "64",
                     "--dtype", "bf16", "--parity"]) == 2
    assert cli.main(["decode", f"{d}/f32.bin", f"{d}/f32.raw",
                     "64", "64", "16"]) == 0
    assert cli.main(["decode", f"{d}/bf16.bin", f"{d}/bf16.raw",
                     "64", "64", "16"]) == 0
    a = rawvideo.read_video(src, 64, 64)
    f32 = rawvideo.read_video(f"{d}/f32.raw", 64, 64)
    bf16 = rawvideo.read_video(f"{d}/bf16.raw", 64, 64)
    assert metrics.psnr(a, f32) - metrics.psnr(a, bf16) < 0.7

    # sweep rows carry the dtype tag
    assert cli.main(["sweep", "synthetic", "64", "64", "8",
                     "--quants", "5", "--blocks", "8",
                     "--dtype", "bf16"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["dtype"] == "bfloat16"


def test_stream_frames_max_frames_is_absolute(rng):
    """iter_batches counts max_frames from stream frame 0 (like
    iter_frame_batches), so a resumed pipe encode of --frames F yields
    frames [start, F), not F more after the skip."""
    import io as _io

    from dct3d_tpu.io.rawvideo import StreamFrames

    clip = rng.integers(0, 256, (12, 8, 8), dtype=np.uint8)
    sf = StreamFrames(_io.BytesIO(clip.tobytes()), 8, 8)
    got = list(sf.iter_batches(4, max_frames=10, align=2, start=4))
    total = sum(b.shape[0] for b in got)
    assert total == 6  # frames [4, 10)
    np.testing.assert_array_equal(np.concatenate(got), clip[4:10])


def test_cli_pack_bits_is_byte_neutral(tmp_path):
    """--pack-bits sizes device buffers only: output bytes identical."""
    d = str(tmp_path)
    src = f"{d}/src.raw"
    assert cli.main(["capture", src, "64", "64", "16", "--kind", "blocks"]) == 0
    assert cli.main(["encode", src, f"{d}/a.bin", "64", "64",
                     "--deflate-workers", "0"]) == 0
    assert cli.main(["encode", src, f"{d}/b.bin", "64", "64",
                     "--deflate-workers", "0", "--pack-bits", "4"]) == 0
    assert open(f"{d}/a.bin", "rb").read() == open(f"{d}/b.bin", "rb").read()


def test_cli_stdin_pad_streams_constant_rss(tmp_path, monkeypatch):
    """`encode - ... --pad` pads per batch — bounded reads (the _OnDemand
    pipe fails on any unbounded read), output byte-identical to the
    file-input padded encode."""
    w, h = 30, 21  # not block multiples -> pads to 32x24
    fsz = w * h
    total = 17 * fsz  # trims to 16 frames

    class _Std:
        buffer = _OnDemand(total)

    monkeypatch.setattr(cli.sys, "stdin", _Std)
    enc_pipe = str(tmp_path / "p.bin")
    assert cli.main(["encode", "-", enc_pipe, str(w), str(h), "--pad"]) == 0
    monkeypatch.undo()

    src = str(tmp_path / "s.raw")
    with open(src, "wb") as f:
        f.write(_OnDemand(total, chunk=1 << 30).read(17 * fsz))
    enc_file = str(tmp_path / "f.bin")
    assert cli.main(["encode", src, enc_file, str(w), str(h), "--pad"]) == 0
    assert open(enc_pipe, "rb").read() == open(enc_file, "rb").read()


def test_cli_stdin_index_streams_constant_rss(tmp_path, monkeypatch):
    """`encode - out.d3i ... --index` streams the pipe (bounded reads) and
    patches the member header's frame count + length at finish: the
    container must be byte-identical to the file-input indexed encode and
    decode with NO frame count."""
    w = h = 32
    fsz = w * h
    total = 24 * fsz

    class _Std:
        buffer = _OnDemand(total)

    monkeypatch.setattr(cli.sys, "stdin", _Std)
    enc_pipe = str(tmp_path / "p.d3i")
    assert cli.main(["encode", "-", enc_pipe, "32", "32", "--index"]) == 0
    monkeypatch.undo()

    src = str(tmp_path / "s.raw")
    with open(src, "wb") as f:
        f.write(_OnDemand(total, chunk=1 << 30).read(total))
    enc_file = str(tmp_path / "f.d3i")
    assert cli.main(["encode", src, enc_file, "32", "32", "--index"]) == 0
    assert open(enc_pipe, "rb").read() == open(enc_file, "rb").read()
    # container self-describes frames: decode without a count
    dec = str(tmp_path / "d.raw")
    assert cli.main(["decode", enc_pipe, dec, "32", "32"]) == 0
    assert os.path.getsize(dec) == total


def test_cli_stdin_rgb_warns_about_buffering(tmp_path, monkeypatch, capsys):
    """--rgb with a pipe legitimately buffers (channel passes) but must
    say so loudly instead of silently eating RAM."""
    import io

    w = h = 16
    raw = (np.arange(8 * h * w * 3) % 251).astype(np.uint8).tobytes()

    class _Buf:
        buffer = io.BytesIO(raw)

    monkeypatch.setattr(cli.sys, "stdin", _Buf)
    enc = str(tmp_path / "p.d3c")
    assert cli.main(["encode", "-", enc, "16", "16", "--rgb"]) == 0
    monkeypatch.undo()
    err = capsys.readouterr().err
    assert "buffers the WHOLE pipe" in err
