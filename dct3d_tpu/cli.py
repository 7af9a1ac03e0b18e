"""Command-line interface.

Mirrors the reference's entry points (SURVEY.md §1 L5/L6):
  encode/decode     <in> <out> <width> <height> [frames]  — main.c:27-44,
                    Encoder.java:17, Decoder.java:18 (geometry out of band)
  devices           — `codec list_platforms` (main.c:25-26) for JAX
  capture           — CaptureScreen.java (synthetic source; no display needed)
  split / mix       — RGBUtils.java:39-131
  render            — RenderVideo.java (headless: PNG export + stats)
  psnr              — new: quality measurement (absent in the reference)

Run as `python -m dct3d_tpu ...`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .config import CodecConfig
from . import metrics


def _cfg_from_args(args) -> CodecConfig:
    level = args.zlib_level
    if level is None:
        # Reference parity wants Z_BEST_COMPRESSION (encoder.c:139); the
        # turbo profile's zlib mode deflates ~6x more bytes (the raw nibble
        # plane), where level 9 costs several times level 6's time for a
        # few percent of rate — default it to 6.  Turbo's default
        # codec is zstd, which ignores this knob.
        level = 6 if getattr(args, "turbo", False) else 9
    return CodecConfig(
        turbo_codec=getattr(args, "turbo_codec", "zstd"),
        turbo_zstd_level=getattr(args, "turbo_zstd_level", None) or 3,
        block_w=args.block,
        block_h=args.block,
        block_d=args.block,
        quant_strength=args.quant,
        quant_bias=getattr(args, "quant_bias", 0.5),
        transport_delta=getattr(args, "transport_delta", False),
        zlib_level=level,
        deflate_workers=0 if getattr(args, "parity", False) else args.deflate_workers,
        compute_dtype=_norm_dtype(getattr(args, "dtype", "float32")),
        pack_bits_per_value=getattr(args, "pack_bits", None) or 4,
    )


def _norm_dtype(d: str) -> str:
    return {"bf16": "bfloat16", "f32": "float32"}.get(d, d)


def _add_codec_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument(
        "width", type=int, nargs="?", default=None,
        help="frame width (required for raw input; PNG sequences and .y4m "
        "streams carry their own geometry)",
    )
    p.add_argument("height", type=int, nargs="?", default=None)
    p.add_argument(
        "frames",
        type=int,
        nargs="?",
        default=None,
        help="frame count (default: derived from file size, the fallback the "
        "reference intended at Encoder.java:34-36)",
    )
    p.add_argument("--block", type=int, default=8, help="DCT cube edge (8 or 4)")
    p.add_argument("--quant", type=int, default=5, help="quantization strength")
    p.add_argument(
        "--quant-bias", type=float, default=0.5,
        help="quantizer rounding bias; 0.5 = reference parity, ~0.4 = "
        "deadzone (+0.1-0.4 dB at equal rate, stream stays "
        "reference-decodable)",
    )
    p.add_argument(
        "--zlib-level", type=int, default=None,
        help="DEFLATE level (default 9 = reference C encoder; the turbo "
        "profile defaults to 6 — it deflates the raw nibble plane, where "
        "9 costs ~6x the time for ~5%% rate)",
    )
    p.add_argument(
        "--gops-per-batch", type=int, default=4,
        help="GOPs per device dispatch",
    )
    p.add_argument(
        "--deflate-workers", type=int, default=-1,
        help="DEFLATE threads (-1 = all cores but one; 0 = serial "
        "reference-parity stream layout)",
    )
    p.add_argument(
        "--parity", action="store_true",
        help="byte-exact stream layout vs the serial reference encoder "
        "(same as --deflate-workers 0)",
    )
    p.add_argument(
        "--pack-bits", type=int, default=None, metavar="N",
        help="starting per-group device pack-buffer budget, bits/value "
        "(default 4 — 13%% faster encode than 6 on typical content at "
        "identical bytes; buffer-sizing only).  Content that overflows "
        "retries worst-case and after 2 consecutive overflows the budget "
        "climbs permanently (N -> 6 -> worst case), so noisy sources "
        "settle automatically",
    )
    p.add_argument(
        "--dtype", default="float32",
        choices=("float32", "bfloat16", "f32", "bf16"),
        help="transform matmul dtype: float32 (default) is byte-exact "
        "reference parity; bfloat16 is the fast profile — the stream stays "
        "reference-decodable within 0.7 dB (tests/test_pipeline.py pins "
        "the floor)",
    )
    p.add_argument(
        "--stats", action="store_true",
        help="print per-stage timing/bandwidth JSON to stderr",
    )
    p.add_argument(
        "--transport-delta", action="store_true",
        help="encode: ship frames to the device as temporal deltas "
        "(faster over compressing transports; output unchanged)",
    )
    p.add_argument(
        "--rgb", action="store_true",
        help="treat input/output as interleaved RGB (3 B/px): channels are "
        "split, coded separately (the reference's RGBUtils workflow, "
        "README.md:22-27), and carried as 3 members of one container",
    )
    p.add_argument(
        "--turbo", action="store_true",
        help="encode: turbo (planar) profile — no Exp-Golomb: the wire "
        "carries the nibble-plane device transport per GOP (D3MH type-5 "
        "members), zstd-compressed. Smaller than the reference stack "
        "(~0.21 vs 0.31 bpp at 1080p quant 5), identical pixels; the "
        "encode step drops its whole bit-pack stage and decode's host "
        "work is pure decompression. Extension profile: the reference "
        "decoder cannot read it (decode auto-detects; see docs/FORMAT.md)",
    )
    p.add_argument(
        "--turbo-codec", choices=("zstd", "zlib"), default="zstd",
        help="turbo payload codec (zstd: ~5%% smaller, ~2x faster compress, "
        "~4x faster inflate; zlib: stdlib-only wire). Decode sniffs per "
        "stream — no flag needed",
    )
    p.add_argument(
        "--turbo-zstd-level", type=int, default=None,
        help="zstd level for turbo payloads (default 3 = speed knee, 6x "
        "faster drain than 10 for +6-12%% bytes; 10 = rate knee, 19 = "
        "archival; any level decodes any wire)",
    )
    p.add_argument(
        "--index", action="store_true", default=None,
        help="encode: wrap the stream in a D3MH container with a seekable "
        "per-GOP bit index member — decode then needs no frame count and "
        "its host entropy stage scales with cores (no serial stream scan); "
        "the stream member itself stays byte-identical.  DEFAULT for file "
        "outputs; combined with --parity the reference-byte-exact stream "
        "stays raw and the index goes to a <output>.idx sidecar (decode "
        "auto-loads it)",
    )
    p.add_argument(
        "--no-index", dest="index", action="store_false",
        help="encode: emit the raw headerless stream with no container "
        "framing and no sidecar (the reference's own output shape; decode "
        "then needs an explicit frame count)",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=0, metavar="GOPS",
        help="encode: write a resumable member container (D3MH) with durable "
        "progress every N GOPs; re-running the same command resumes",
    )
    p.add_argument(
        "--profile-dir", default=None,
        help="capture a jax.profiler device trace into this directory",
    )
    p.add_argument(
        "--mesh", default=None, metavar="GxT",
        help="run on a (gop, tile) device mesh, e.g. 4x1 or 2x2 — the "
        "bitstream stays byte-identical to single-device; the analogue of "
        "the reference's compute-platform selection (main.c:33-37)",
    )
    p.add_argument(
        "--pad", action="store_true",
        help="encode: edge-replicate frames up to block multiples when the "
        "geometry doesn't divide (the documented extension over the "
        "reference's hard requirement, CaptureScreen.java:113-118); the "
        "stream then carries the padded geometry — decode with it and "
        "--crop WxH to recover the original",
    )
    p.add_argument(
        "--crop", default=None, metavar="WxH",
        help="decode: crop the decoded frames back to WxH (pairs with "
        "encode --pad)",
    )
    p.add_argument(
        "--range", default=None, metavar="A:B", dest="frame_range",
        help="decode: random-access decode of frames [A, B) only — turbo "
        "containers skip non-covering members outright; reference-profile "
        "streams skip the prefix's entropy+transform (scan-free with an "
        "encode --index container).  The reference decoder can only walk "
        "from frame 0 (decoder.c:207)",
    )


def _make_cli_mesh(spec: str):
    """Build the (gop, tile) mesh requested by --mesh, or None + error rc."""
    import jax

    from .parallel.mesh import make_mesh

    g, _, t = spec.lower().partition("x")
    try:
        gop, tile = int(g), int(t or 1)
        if gop < 1 or tile < 1:
            raise ValueError
    except ValueError:
        print(f"--mesh expects GxT (e.g. 4x1, 2x2), got {spec!r}",
              file=sys.stderr)
        return None
    devs = jax.devices()
    if gop * tile > len(devs):
        print(
            f"--mesh {spec} needs {gop * tile} devices, found {len(devs)} "
            "(see `devices`)", file=sys.stderr,
        )
        return None
    return make_mesh(gop=gop, tile=tile, devices=devs[: gop * tile])


def _mesh_align(cfg, mesh, frames):
    """(align, frames) for a mesh encode: align = gop_size * mesh gop axis;
    frames truncates to whole mesh steps (None = until EOF — the batch
    iterators align downstream).  frames == 0 means too-short input; the
    error is already printed."""
    align = cfg.gop_size * mesh.shape["gop"]
    if frames is not None:
        old, frames = frames, frames - frames % align
        if frames == 0:
            print(f"input shorter than one {align}-frame mesh step",
                  file=sys.stderr)
        elif frames != old:
            print(f"note: truncating to {frames} frames "
                  f"(mesh step {align})", file=sys.stderr)
    return align, frames


def _setup_mesh(args, cfg, frames):
    """One scaffold for every cmd_encode path: (mesh, align, frames), or
    None after printing the error (caller returns 2).  mesh is None when
    --mesh was not given; align is then the plain GOP size."""
    if not args.mesh:
        return None, cfg.gop_size, frames
    mesh = _make_cli_mesh(args.mesh)
    if mesh is None:
        return None
    align, frames = _mesh_align(cfg, mesh, frames)
    if frames == 0:
        return None
    return mesh, align, frames


def _load_footage(args):
    """Detect and load non-raw input (PNG sequence / y4m stream).

    Returns (video_or_None, width, height): video None means "raw file,
    stream it from disk"; otherwise the footage is in memory and geometry
    came from the content (SURVEY.md §7 M5 real-footage path).
    """
    inp = args.input
    if inp == "-":
        # Pipe ingestion (e.g. ffmpeg -f rawvideo ... - | dct3d encode -):
        # geometry from flags; frames STREAM through a fixed batch buffer
        # (io/rawvideo.StreamFrames — the C encoder's bounded-memory loop,
        # encoder.c:203-278), so an arbitrarily long pipe encodes at
        # constant RSS — including --pad (per-batch) and --index (member
        # header patched at finish).  Only --rgb still buffers the whole
        # pipe (channel passes re-read the footage) and warns loudly.
        if args.width is None or args.height is None:
            print("stdin input needs explicit width and height",
                  file=sys.stderr)
            raise SystemExit(2)
        from .io import rawvideo

        channels = 3 if args.rgb else 1
        stream = rawvideo.StreamFrames(
            sys.stdin.buffer, args.width, args.height, channels
        )
        return stream, args.width, args.height
    is_png = (
        os.path.isdir(inp)
        or any(c in inp for c in "*?[")
        or inp.lower().endswith(".png")
    )
    is_y4m = False
    if not is_png and os.path.isfile(inp):
        with open(inp, "rb") as f:
            is_y4m = f.read(9) == b"YUV4MPEG2"
    if is_png:
        from .io.png import read_png_sequence

        video = read_png_sequence(inp, frames=args.frames,
                                  gray=not args.rgb)
    elif is_y4m:
        from .io.y4m import read_y4m, read_y4m_rgb

        if args.rgb:
            # BT.601 limited-range YCbCr -> RGB (4:2:0/422/444 upsampled
            # by repetition); the three planes then ride the normal RGB
            # channel-member path.
            video, _info = read_y4m_rgb(inp, frames=args.frames)
        else:
            video, _info = read_y4m(inp, frames=args.frames)
    else:
        return None, args.width, args.height
    h, w = video.shape[1], video.shape[2]
    if (args.width, args.height) not in ((None, None), (w, h)):
        print(f"note: input carries its own geometry {w}x{h}; "
              "ignoring the command-line values", file=sys.stderr)
    return video, w, h


def cmd_encode(args) -> int:
    from .codec.encoder import StreamingEncoder
    from .io import rawvideo

    from .profiling import profile_to

    cfg = _cfg_from_args(args)
    if args.parity and cfg.compute_dtype != "float32":
        print("--parity (byte-exact reference layout) cannot combine with "
              "the lossy --dtype bfloat16 fast profile", file=sys.stderr)
        return 2
    if args.output == "-" and (args.index or args.checkpoint_every):
        print("stdout output cannot combine with --index (needs a seekable "
              "file) or --checkpoint-every (needs fsync/resume)",
              file=sys.stderr)
        return 2
    say = (lambda *a: print(*a, file=sys.stderr)) \
        if args.output == "-" else print
    if args.turbo:
        # Checked up front so every input branch (--rgb included) rejects
        # the same combinations instead of silently dropping a flag.
        for flag, why in (
            ("index", "turbo members are already per-GOP seekable"),
            ("parity", "turbo is an extension profile, never byte-parity"),
        ):
            if getattr(args, flag, None):
                print(f"--turbo cannot combine with --{flag.replace('_', '-')}"
                      f" ({why})", file=sys.stderr)
                return 2
    if args.mesh and getattr(args, "transport_delta", False):
        print("warning: --transport-delta is a single-device upload "
              "optimization; the sharded path ships raw frames (output "
              "is identical)", file=sys.stderr)
    video, width, height = _load_footage(args)
    if width is None or height is None:
        print("raw input needs explicit width and height", file=sys.stderr)
        return 2
    channels = 3 if args.rgb else 1
    stream = video if isinstance(video, rawvideo.StreamFrames) else None
    if stream is not None and args.rgb:
        # The RGB channel passes genuinely need the whole footage resident
        # (three sequential per-channel encodes over the same frames); a
        # pipe cannot be re-read, so this path buffers — loudly.  --pad
        # pads per batch and --index patches its member header at finish,
        # so both STREAM at constant RSS.
        print(
            "warning: --rgb with piped input buffers the WHOLE pipe in "
            "RAM (channel passes re-read the footage; an hour of 1080p "
            "RGB is ~22 GB) — use a file input for bounded memory",
            file=sys.stderr,
        )
        video, stream = stream.read_all(), None
    if args.pad:
        from .io.pad import pad_frames, padded_geometry, padded_stream

        pw, ph = padded_geometry(width, height, cfg.block_w, cfg.block_h)
        if (pw, ph) != (width, height):
            if stream is not None:
                video = stream = padded_stream(
                    stream, cfg.block_w, cfg.block_h
                )
            else:
                if video is None:
                    video = rawvideo.read_video(
                        args.input, width, height, args.frames,
                        channels=channels,
                    )
                video = pad_frames(video, cfg.block_w, cfg.block_h)
            print(
                f"note: padded {width}x{height} -> {pw}x{ph}; decode with "
                f"geometry {pw} {ph} and --crop {width}x{height}",
                file=sys.stderr,
            )
            width, height = pw, ph

    if args.rgb:
        from .codec.rgb_codec import encode_rgb_video

        for flag in ("checkpoint_every", "profile_dir", "stats"):
            if getattr(args, flag, None):
                print(f"warning: --{flag.replace('_', '-')} is not yet "
                      "supported with --rgb and is ignored", file=sys.stderr)
        # Three sharded channel streams on a mesh; members stay
        # byte-identical to the single-device container (sharding.py).
        ms = _setup_mesh(args, cfg, None)
        if ms is None:
            return 2
        mesh, align, _ = ms
        if video is None:
            video = rawvideo.read_video(
                args.input, width, height, args.frames, channels=3
            )
        t = video.shape[0] - video.shape[0] % align
        if t == 0:
            print(f"input shorter than one {align}-frame step",
                  file=sys.stderr)
            return 2
        t0 = time.perf_counter()
        if args.turbo:
            from .codec.turbo import encode_turbo_rgb_video

            data = encode_turbo_rgb_video(video, cfg, mesh=mesh)
        else:
            # Channel index members by default (seekable container either
            # way); --no-index opts out.
            data = encode_rgb_video(video, cfg, index=args.index is not False,
                                    mesh=mesh)
        dt = time.perf_counter() - t0
        with _open_out(args.output) as f:
            f.write(data)
        say(
            f"encoded {t} RGB frames {width}x{height} -> "
            f"{len(data)} bytes in {dt:.2f}s ({t / dt:.1f} fps)"
        )
        return 0
    if stream is not None:
        total = None  # a pipe's length is unknowable up front
    elif video is not None:
        total = video.shape[0]
    else:
        total = rawvideo.frame_count(args.input, width, height)
    if total is None:
        frames = args.frames  # None = until EOF; tail trims per batch
    else:
        frames = total if args.frames is None else min(args.frames, total)
    if frames is not None:
        frames -= frames % cfg.gop_size
        if frames == 0:
            print(
                f"nothing to encode: input holds fewer than one GOP "
                f"({cfg.gop_size} frames; reference truncates the same way, "
                "Encoder.java:39-40)", file=sys.stderr,
            )
            return 2
    if args.turbo:
        if args.checkpoint_every:
            from .codec.checkpoint import CheckpointingEncoder

            # No step truncation here: turbo members are per GOP, and the
            # checkpointer routes whole mesh steps to the sharded encoder
            # and GOP tails to a single-device one — so a mesh encode keeps
            # exactly the frames a single-device encode keeps.
            mesh = None
            align = cfg.gop_size
            if args.mesh:
                mesh = _make_cli_mesh(args.mesh)
                if mesh is None:
                    return 2
            t0 = time.perf_counter()
            with profile_to(args.profile_dir), CheckpointingEncoder(
                args.output, width, height, cfg,
                checkpoint_gops=args.checkpoint_every, turbo=True,
                mesh=mesh,
            ) as cenc:
                skip = cenc.frames_done
                if skip:
                    print(f"resuming at frame {skip}")
                for batch in _frame_batches(args, video, width, height,
                                            align, frames, start=skip):
                    cenc.push(batch)
            dt = time.perf_counter() - t0
            written = os.path.getsize(args.output)
            print(
                f"encoded {cenc.frames_done} frames -> {written} bytes "
                f"(turbo container) in {dt:.2f}s"
            )
            return 0
        from .codec.turbo import TurboEncoder, TurboShardedEncoder

        ms = _setup_mesh(args, cfg, frames)
        if ms is None:
            return 2
        mesh, align, frames = ms
        if mesh is not None:
            enc = TurboShardedEncoder(width, height, mesh, cfg)
        else:
            enc = TurboEncoder(width, height, cfg)
        t0 = time.perf_counter()
        written = 0
        with profile_to(args.profile_dir), _open_out(args.output) as out:
            for batch in _frame_batches(args, video, width, height,
                                        align, frames):
                written += out.write(enc.push(batch))
            written += out.write(enc.finish())
        dt = time.perf_counter() - t0
        frames = enc.frames_encoded
        if frames == 0:
            print(f"nothing to encode: input shorter than one "
                  f"{align}-frame step", file=sys.stderr)
            return 2
        say(
            f"encoded {frames} frames {width}x{height} -> {written} bytes "
            f"(turbo, "
            f"{metrics.bits_per_pixel(written, width, height, frames):.3f} "
            f"bpp) in {dt:.2f}s ({frames / dt:.1f} fps)"
        )
        return 0
    if args.checkpoint_every:
        from .codec.checkpoint import CheckpointingEncoder

        ms = _setup_mesh(args, cfg, frames)
        if ms is None:
            return 2
        mesh, align, frames = ms
        t0 = time.perf_counter()
        with profile_to(args.profile_dir), CheckpointingEncoder(
            args.output, width, height, cfg,
            # Explicit --index only: resume must find the member layout the
            # original run wrote, so the checkpoint default stays put.
            checkpoint_gops=args.checkpoint_every, index=bool(args.index),
            mesh=mesh,
        ) as cenc:
            skip = cenc.frames_done
            if skip:
                print(f"resuming at frame {skip}")
            for batch in _frame_batches(args, video, width, height,
                                        align, frames, start=skip):
                cenc.push(batch)
        dt = time.perf_counter() - t0
        written = os.path.getsize(args.output)
        print(
            f"encoded {cenc.frames_done} frames -> {written} bytes "
            f"(container) in {dt:.2f}s"
        )
        return 0
    ms = _setup_mesh(args, cfg, frames)
    if ms is None:
        return 2
    mesh, align, frames = ms
    if mesh is not None:
        from .parallel.sharding import ShardedEncoder

        enc = ShardedEncoder(width, height, mesh, cfg)
    else:
        enc = StreamingEncoder(width, height, cfg)
    # Seekability is the DEFAULT for file outputs: wrap
    # the stream in an indexed container so decode needs no frame count
    # and the host entropy stage jumps straight to every GOP.  --parity
    # keeps the raw reference-byte-exact layout (explicit --index then
    # writes the index to a <output>.idx sidecar; the stream file stays
    # byte-identical); --no-index restores the raw headerless stream;
    # stdout cannot seek to patch the header, so it stays raw.
    write_container = (not args.parity and args.index is not False
                       and args.output != "-")
    write_sidecar = bool(args.index) and args.parity
    t0 = time.perf_counter()
    written = 0
    with profile_to(args.profile_dir), _open_out(args.output) as out:
        if write_container:
            # Container framing: placeholder member header now; BOTH the
            # frame count and the payload length are patched after
            # streaming (so a pipe, whose length is unknowable up front,
            # streams at constant RSS too), index member appended last.
            import struct

            from .parallel.multihost import (
                _MAX_MEMBER_FRAMES, MEMBER_MAGIC, MEMBER_TEMPORAL,
                make_index_member,
            )

            if frames is not None and frames > _MAX_MEMBER_FRAMES:
                if args.index:
                    print(f"--index: {frames} frames exceed one member's "
                          f"2^24-1 limit; use --checkpoint-every instead",
                          file=sys.stderr)
                    return 2
                print(f"note: {frames} frames exceed one indexed member's "
                      "2^24-1 limit; writing a raw headerless stream",
                      file=sys.stderr)
                write_container = False
        if write_container:
            if frames is None:  # pipe: bound by the member header field
                frames = _MAX_MEMBER_FRAMES - _MAX_MEMBER_FRAMES % align
            out.write(MEMBER_MAGIC + struct.pack("<IQ", 0, 0))
        for batch in _frame_batches(args, video, width, height, align, frames):
            written += out.write(enc.push(batch))
        written += out.write(enc.finish())
        if write_container:
            out.write(make_index_member(
                enc.gop_bit_ends,
                sync_offsets=getattr(enc, "gop_sync_offsets", None),
            ))
            out.seek(4)
            out.write(struct.pack(
                "<IQ", (MEMBER_TEMPORAL << 24) | enc.frames_encoded, written
            ))
            written = out.seek(0, os.SEEK_END)
    if write_sidecar:
        from .parallel.multihost import make_index_member

        with open(args.output + ".idx", "wb") as sf:
            sf.write(make_index_member(enc.gop_bit_ends))
        say(f"index sidecar -> {args.output}.idx (stream file stays "
            "reference-byte-exact)")
    dt = time.perf_counter() - t0
    frames = enc.frames_encoded
    if frames == 0:
        print(f"nothing to encode: input shorter than one "
              f"{align}-frame step", file=sys.stderr)
        return 2
    say(
        f"encoded {frames} frames {width}x{height} -> {written} bytes "
        f"({metrics.bits_per_pixel(written, width, height, frames):.3f} bpp) "
        f"in {dt:.2f}s ({frames / dt:.1f} fps)"
    )
    if args.stats and hasattr(enc, "timer"):
        print(enc.timer.report(), file=sys.stderr)
    return 0


def _frame_batches(args, video, width, height, align, frames, start=0):
    """Aligned frame batches from in-memory footage, a raw file, or a
    stdin pipe (constant-RSS streaming; frames None = until EOF)."""
    from .io import rawvideo

    step = align * args.gops_per_batch
    if isinstance(video, rawvideo.StreamFrames):
        yield from video.iter_batches(step, frames, align=align, start=start)
    elif video is not None:
        for i in range(start, frames, step):
            yield video[i : min(i + step, frames)]
    else:
        yield from rawvideo.iter_frame_batches(
            args.input, width, height, step, frames, align=align, start=start
        )


import contextlib


@contextlib.contextmanager
def _open_out(path):
    """Output sink; '-' streams to stdout (status then prints to stderr)."""
    if path == "-":
        yield sys.stdout.buffer
        sys.stdout.buffer.flush()
    else:
        with open(path, "wb") as f:
            yield f


def cmd_decode(args) -> int:
    from .codec.decoder import decode_video
    from .io import rawvideo

    cfg = _cfg_from_args(args)
    width, height = args.width, args.height
    # A .meta sidecar (written by checkpointing encode) pins cfg/geometry;
    # honor it so stale CLI flags can't silently decode to garbage.
    meta_path = args.input + ".meta"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        mcfg = CodecConfig(**meta["cfg"])
        differs = (
            (width, height) != (meta["width"], meta["height"])
            or (cfg.block_w, cfg.block_h, cfg.block_d, cfg.quant_strength)
            != (mcfg.block_w, mcfg.block_h, mcfg.block_d, mcfg.quant_strength)
        )
        if differs:
            print(
                f"note: decoding with the parameters pinned in {meta_path} "
                "(the command-line flags differ)", file=sys.stderr,
            )
        cfg, width, height = mcfg, meta["width"], meta["height"]
    if width is None or height is None:
        # Geometry travels out of band in every container/stream variant
        # (Decoder.java:17-28); only a .meta sidecar can supply it.
        print("decode requires explicit width and height (or a .meta "
              "sidecar next to the input)", file=sys.stderr)
        return 2
    if args.input == "-":
        data = sys.stdin.buffer.read()
    elif os.path.exists(args.input):
        with open(args.input, "rb") as f:
            data = f.read()
    else:
        print(f"no such input: {args.input}", file=sys.stderr)
        return 2
    head = data[:4]
    if head != b"D3MH" and args.rgb:
        print("--rgb decode needs a D3MH container (produced by encode "
              "--rgb); this input is a raw grayscale stream", file=sys.stderr)
        return 2
    frame_range = None
    if args.frame_range is not None:
        a, _, b = args.frame_range.partition(":")
        try:
            frame_range = (int(a), int(b))
            if not (0 <= frame_range[0] < frame_range[1]):
                raise ValueError
        except ValueError:
            print(f"--range expects A:B with 0 <= A < B, got "
                  f"{args.frame_range!r}", file=sys.stderr)
            return 2
        if args.frames is not None:
            print("--range and an explicit frame count are mutually "
                  "exclusive", file=sys.stderr)
            return 2
        if args.mesh:
            print("note: --range decodes single-device; ignoring --mesh",
                  file=sys.stderr)
            args.mesh = None
    # Raw stream with an .idx sidecar (encode --parity --index): the
    # stream file is reference-byte-exact, the sidecar supplies the frame
    # count and the per-GOP positions for the indexed entropy path.
    sidecar_positions = None
    sidecar_frames = None
    sidecar_syncs = None
    if head != b"D3MH" and args.input != "-":
        idx_path = args.input + ".idx"
        if os.path.exists(idx_path):
            from .parallel.multihost import (
                MEMBER_INDEX, gop_positions, parse_index,
                parse_index_syncs, split_members,
            )

            try:
                with open(idx_path, "rb") as f:
                    idx_members = split_members(f.read())
            except ValueError:
                idx_members = []
            ipay = next(
                (p for _, p, t in idx_members if t == MEMBER_INDEX), None,
            )
            ends = parse_index(ipay) if ipay is not None else None
            if ends:
                sidecar_frames = len(ends) * cfg.gop_size
                sidecar_positions = gop_positions(
                    ends, len(ends), cfg.gop_size, sidecar_frames
                )
                sidecar_syncs = parse_index_syncs(ipay)
    if (head != b"D3MH" and args.frames is None
            and frame_range is None and sidecar_frames is None):
        print("decode requires an explicit frame count or --range "
              "(headerless stream, as in the reference: Decoder.java:18; "
              "default encodes write an indexed container or an .idx "
              "sidecar that makes the count optional)",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    if frame_range is not None:
        video = _decode_range(args, data, head, width, height, cfg,
                              frame_range, positions=sidecar_positions)
        if video is None:
            return 2
        return _write_decoded(args, video, width, height, t0)
    if head == b"D3MH":
        # Route by the container's member type tags, not the --rgb flag:
        # tagged containers self-describe (ADVICE r1); the flag only decides
        # legacy all-zero-tag 3-member containers.
        from .parallel.multihost import (
            MEMBER_INDEX, container_kind, split_members,
        )

        members = split_members(data)
        from .codec.turbo import (
            decode_turbo_container, decode_turbo_rgb_video,
            is_turbo_container, is_turbo_rgb_container,
        )

        if is_turbo_container(members):
            if args.mesh:
                from .codec.turbo import TurboShardedDecoder

                dec = TurboShardedDecoder(
                    width, height, _make_cli_mesh(args.mesh), cfg
                )
                video = dec.decode(data)
            else:
                video = decode_turbo_container(data, width, height, cfg)
            if args.frames is not None:
                video = video[: args.frames]
            return _write_decoded(args, video, width, height, t0)
        if is_turbo_rgb_container(members):
            video = decode_turbo_rgb_video(data, width, height, cfg)
            if args.frames is not None:
                video = video[: args.frames]
            return _write_decoded(args, video, width, height, t0)
        kind = container_kind(members)
        if kind == "unknown":
            print(f"unrecognized member type tags "
                  f"{[m[2] for m in members]}", file=sys.stderr)
            return 2
        n_streams = sum(1 for m in members if m[2] != MEMBER_INDEX)
        as_rgb = kind == "rgb" or (args.rgb and n_streams == 3)
        if args.rgb and kind == "temporal" and n_streams != 3:
            print("--rgb requested but this container holds "
                  f"{n_streams} temporal member(s)", file=sys.stderr)
            return 2
        if as_rgb:
            from .codec.rgb_codec import decode_rgb_video

            video = decode_rgb_video(data, width, height, cfg)
        else:
            video = None
            if args.mesh and n_streams > 1:
                print("note: --mesh applies only to single-stream "
                      "containers; decoding members host-parallel instead",
                      file=sys.stderr)
            elif args.mesh:
                # Single-stream container on a device mesh: feed the member
                # to the sharded decoder, with its index positions if
                # present — unless the frame count doesn't fill whole mesh
                # steps (the sharded decoder truncates; fall back rather
                # than silently dropping tail GOPs).
                from .parallel.multihost import (
                    MEMBER_TEMPORAL, gop_positions, parse_index,
                )
                from .parallel.sharding import ShardedDecoder

                mesh = _make_cli_mesh(args.mesh)
                if mesh is None:
                    return 2
                frames, payload, _ = next(
                    m for m in members if m[2] == MEMBER_TEMPORAL
                )
                if frames % (cfg.gop_size * mesh.shape["gop"]):
                    print(
                        f"note: {frames} frames don't fill whole "
                        f"{cfg.gop_size * mesh.shape['gop']}-frame mesh "
                        "steps; decoding single-device instead",
                        file=sys.stderr,
                    )
                else:
                    positions = None
                    for f, p, mtype in members:
                        if mtype == MEMBER_INDEX:
                            ends = parse_index(p)
                            if ends is not None:
                                positions = gop_positions(
                                    ends, frames // cfg.gop_size,
                                    cfg.gop_size, frames,
                                )
                    video = ShardedDecoder(width, height, mesh, cfg).decode(
                        payload, frames, positions=positions
                    )
            if video is None:
                from .parallel.multihost import decode_multihost_container

                video = decode_multihost_container(data, width, height, cfg)
        if args.frames is not None:
            video = video[: args.frames]
    elif args.mesh:
        from .parallel.sharding import ShardedDecoder

        mesh = _make_cli_mesh(args.mesh)
        if mesh is None:
            return 2
        frames = args.frames if args.frames is not None else sidecar_frames
        positions = sidecar_positions
        if positions is not None and frames // cfg.gop_size > len(positions):
            positions = None  # stale/short sidecar: scan instead
        video = ShardedDecoder(width, height, mesh, cfg).decode(
            data, frames, positions=positions
        )
    else:
        frames = args.frames if args.frames is not None else sidecar_frames
        positions = sidecar_positions
        if positions is not None and frames // cfg.gop_size > len(positions):
            positions = None  # stale/short sidecar: scan instead
        video = decode_video(
            data, width, height, frames, cfg,
            gops_per_batch=args.gops_per_batch,
            positions=positions, sync_offsets=sidecar_syncs,
        )
    return _write_decoded(args, video, width, height, t0)


def _decode_range(args, data, head, width, height, cfg, frame_range,
                  positions=None):
    """--range A:B routing for cmd_decode; returns frames or None + error.

    One routing body lives in codec.auto.decode_auto_range; this adds only
    what the library twin cannot know: the --rgb flag that identifies
    legacy all-zero-tag 3-member RGB containers, and CLI-style printed
    errors for unrecognized tags."""
    a, b = frame_range
    from .codec.auto import decode_auto_range

    if head == b"D3MH":
        from .codec.turbo import is_turbo_container, is_turbo_rgb_container
        from .parallel.multihost import (
            MEMBER_INDEX, container_kind, split_members,
        )

        members = split_members(data)
        if not (is_turbo_container(members)
                or is_turbo_rgb_container(members)):
            kind = container_kind(members)
            if kind == "unknown":
                print(f"unrecognized member type tags "
                      f"{[m[2] for m in members]}", file=sys.stderr)
                return None
            if args.rgb and kind == "temporal":
                n_streams = sum(
                    1 for m in members if m[2] != MEMBER_INDEX
                )
                if n_streams != 3:
                    print(f"--rgb requested but this container holds "
                          f"{n_streams} temporal member(s)", file=sys.stderr)
                    return None
                from .codec.rgb_codec import decode_rgb_range

                return decode_rgb_range(data, width, height, a, b, cfg)
    return decode_auto_range(data, width, height, a, b, cfg,
                             positions=positions)


def _write_decoded(args, video, width, height, t0) -> int:
    """Shared tail of cmd_decode: crop, write (.y4m or raw), report."""
    from .io import rawvideo

    dt = time.perf_counter() - t0
    if args.crop:
        from .io.pad import crop_frames

        cw, _, ch = args.crop.lower().partition("x")
        video = crop_frames(video, int(cw), int(ch))
        width, height = int(cw), int(ch)
    if args.output == "-":
        sys.stdout.buffer.write(np.ascontiguousarray(video).tobytes())
        sys.stdout.buffer.flush()
    elif args.output.lower().endswith(".y4m"):
        if video.ndim == 4:
            # Color output: C444 BT.601 (read_y4m_rgb round-trips it; any
            # ffmpeg/ffplay consumes it directly).
            from .io.y4m import write_y4m_rgb

            write_y4m_rgb(args.output, video)
        else:
            from .io.y4m import write_y4m

            write_y4m(args.output, video)
    else:
        rawvideo.write_video(args.output, video)
    print(
        f"decoded {video.shape[0]} frames {width}x{height} "
        f"in {dt:.2f}s ({video.shape[0] / dt:.1f} fps)",
        file=sys.stderr if args.output == "-" else sys.stdout,
    )
    return 0


def cmd_info(args) -> int:
    """Inspect a bitstream / container (SURVEY.md §7 M5 'info')."""
    import zlib

    with open(args.input, "rb") as f:
        data = f.read()
    out: dict = {"bytes": len(data)}
    if data[:4] == b"D3MH":
        from .parallel.multihost import (
            MEMBER_INDEX, container_kind, parse_index,
            parse_index_syncs, split_members,
        )

        from .codec.turbo import is_turbo_container, is_turbo_rgb_container

        members = split_members(data)
        type_names = {0: "temporal", 1: "red", 2: "green", 3: "blue",
                      4: "index", 5: "turbo", 6: "turbo-red",
                      7: "turbo-green", 8: "turbo-blue"}

        def _index_info(payload):
            ends = parse_index(payload)
            if ends is None:
                return {"torn": True}
            info = {"gops": len(ends)}
            if parse_index_syncs(payload) is not None:
                info["parallel_inflate"] = True  # v2 sync offsets present
            return info

        out["format"] = "d3mh-container"
        out["kind"] = (
            "turbo" if is_turbo_container(members)
            else "turbo-rgb" if is_turbo_rgb_container(members)
            else container_kind(members)
        )
        out["members"] = [
            {"frames": frames, "bytes": len(payload),
             "type": type_names.get(mtype, mtype),
             **(_index_info(payload) if mtype == MEMBER_INDEX else {})}
            for frames, payload, mtype in members
        ]
        if out["kind"] == "rgb":
            out["frames"] = members[0][0]
        elif out["kind"] == "turbo-rgb":
            out["frames"] = sum(m[0] for m in members if m[2] == 6)
        else:
            out["frames"] = sum(m[0] for m in members)
        if out["kind"] in ("turbo", "turbo-rgb"):
            from .codec.turbo import _ZSTD_MAGIC

            payload = next(
                (m[1] for m in members if m[2] in (5, 6, 7, 8)), None
            )
            if payload is not None:
                out["codec"] = (
                    "zstd" if payload[16:20] == _ZSTD_MAGIC else "zlib"
                )
        meta_path = args.input + ".meta"
        if os.path.exists(meta_path):
            out["meta"] = json.load(open(meta_path))
    else:
        out["format"] = "raw-zlib-stream (reference-compatible, headerless)"
        try:
            payload = zlib.decompressobj().decompress(data, 1 << 20)
            out["payload_bytes_sampled"] = len(payload)
            out["note"] = ("geometry travels out of band; supply width/"
                           "height/frames to decode (Decoder.java:17-28)")
        except zlib.error:
            out["format"] = "unknown (not zlib, not D3MH)"
    print(json.dumps(out, indent=2))
    return 0


def cmd_devices(_args) -> int:
    import jax

    devs = jax.devices()
    print(f"platform: {devs[0].platform}  devices: {len(devs)}")
    for d in devs:
        print(f"  [{d.id}] {d.device_kind} process={d.process_index}")
    return 0


def cmd_capture(args) -> int:
    from .io import synthetic

    cfg = CodecConfig()
    t, h, w = synthetic.capture(
        args.output, args.frames, args.height, args.width,
        cfg, kind=args.kind, rgb=args.rgb, seed=args.seed,
    )
    ch = 3 if args.rgb else 1
    print(f"captured {t} frames {w}x{h} x{ch}B/px -> {args.output}")
    return 0


def cmd_split(args) -> int:
    from .io import rgb

    outs = rgb.split_file(args.input, args.prefix)
    print("wrote: " + " ".join(outs))
    return 0


def cmd_mix(args) -> int:
    from .io import rgb

    out = rgb.mix_files(args.prefix, args.output)
    print(f"wrote: {out}")
    return 0


def cmd_render(args) -> int:
    from .io import render

    if args.play:
        # fps-paced playback through an external y4m player — the
        # RenderVideo.java:54-87 analogue for a headless host.
        try:
            return render.play_video(
                args.input, args.width, args.height, fps=args.fps,
                channels=3 if args.rgb else 1, player=args.player,
            )
        except RuntimeError as e:
            print(str(e), file=sys.stderr)
            return 2
    stats = render.video_stats(
        args.input, args.width, args.height, channels=3 if args.rgb else 1
    )
    print(json.dumps(stats))
    if args.png_prefix:
        sel = None  # default: first / middle / last
        if args.frames == "all":
            sel = list(range(stats["frames"]))
        elif args.frames and ":" in args.frames:
            a, _, b = args.frames.partition(":")
            sel = list(range(int(a or 0), min(int(b or stats["frames"]),
                                              stats["frames"])))
        elif args.frames:
            sel = [int(x) for x in args.frames.split(",")]
        outs = render.render_frames(
            args.input, args.width, args.height, args.png_prefix,
            frames=sel, channels=3 if args.rgb else 1,
        )
        print("wrote: " + " ".join(outs))
    return 0


def cmd_sweep(args) -> int:
    """Rate-distortion sweep: quant strength x block size -> bpp/PSNR/fps.

    The reference exposes exactly these two knobs (quant strength hardcoded 5
    at Encoder.java:82; block dims 8 or 4 via codec.h:11-13 + README.md:20)
    but ships no measurement harness (SURVEY.md §6); this is the M6
    deliverable."""
    from .codec.decoder import decode_video
    from .codec.encoder import encode_video
    from .io import rawvideo

    if args.input == "synthetic":
        from .io import synthetic

        video = synthetic.moving_gradient(
            args.frames or 32, args.height, args.width
        )
    else:
        total = rawvideo.frame_count(args.input, args.width, args.height)
        n = total if args.frames is None else min(args.frames, total)
        video = rawvideo.read_video(args.input, args.width, args.height, n)
    t, h, w = video.shape

    strengths = [int(s) for s in args.quants.split(",")]
    blocks = [int(b) for b in args.blocks.split(",")]
    rows = []
    for block in blocks:
        for q in strengths:
            cfg = CodecConfig(
                block_w=block, block_h=block, block_d=block,
                quant_strength=q, quant_bias=args.quant_bias,
                zlib_level=args.zlib_level,
                deflate_workers=args.deflate_workers,
                compute_dtype=_norm_dtype(args.dtype),
            )
            tt = t - t % cfg.gop_size
            if tt == 0:
                print(f"skipping block={block}: fewer than one "
                      f"{cfg.gop_size}-frame GOP", file=sys.stderr)
                continue
            t0 = time.perf_counter()
            data = encode_video(video[:tt], cfg)
            enc_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = decode_video(data, w, h, tt, cfg)
            dec_s = time.perf_counter() - t0
            row = {
                "block": block,
                "quant": q,
                **({"dtype": cfg.compute_dtype}
                   if cfg.compute_dtype != "float32" else {}),
                "bpp": round(metrics.bits_per_pixel(len(data), w, h, tt), 4),
                "psnr_db": round(metrics.psnr(video[:tt], out), 3),
                "encode_fps": round(tt / enc_s, 2),
                "decode_fps": round(tt / dec_s, 2),
            }
            if args.turbo:
                from .codec.turbo import encode_turbo_video

                tdata = encode_turbo_video(video[:tt], cfg)
                row["turbo_bpp"] = round(
                    metrics.bits_per_pixel(len(tdata), w, h, tt), 4
                )
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(rows, f, indent=2)
    return 0


def cmd_psnr(args) -> int:
    from .io import rawvideo

    ch = 3 if args.rgb else 1
    a = rawvideo.read_video(args.a, args.width, args.height, channels=ch)
    b = rawvideo.read_video(args.b, args.width, args.height, channels=ch)
    t = min(a.shape[0], b.shape[0])
    print(f"PSNR: {metrics.psnr(a[:t], b[:t]):.3f} dB over {t} frames")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dct3d_tpu", description="3D-DCT video codec (JAX/XLA)"
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="raw grayscale video -> bitstream")
    _add_codec_args(pe)
    pe.set_defaults(fn=cmd_encode)

    pd = sub.add_parser("decode", help="bitstream -> raw grayscale video")
    _add_codec_args(pd)
    pd.set_defaults(fn=cmd_decode)

    pv = sub.add_parser("devices", help="list accelerator devices")
    pv.set_defaults(fn=cmd_devices)

    pi = sub.add_parser("info", help="inspect a bitstream or container")
    pi.add_argument("input")
    pi.set_defaults(fn=cmd_info)

    pc = sub.add_parser("capture", help="generate a synthetic raw clip")
    pc.add_argument("output")
    pc.add_argument("width", type=int)
    pc.add_argument("height", type=int)
    pc.add_argument("frames", type=int)
    pc.add_argument("--kind", choices=["gradient", "blocks"], default="gradient")
    pc.add_argument("--rgb", action="store_true")
    pc.add_argument("--seed", type=int, default=0)
    pc.set_defaults(fn=cmd_capture)

    ps = sub.add_parser("split", help="interleaved RGB -> planar .red/.green/.blue")
    ps.add_argument("input")
    ps.add_argument("--prefix", default=None)
    ps.set_defaults(fn=cmd_split)

    pm = sub.add_parser("mix", help="planar .red/.green/.blue -> interleaved RGB")
    pm.add_argument("prefix")
    pm.add_argument("output")
    pm.set_defaults(fn=cmd_mix)

    pr = sub.add_parser("render", help="raw video stats + PNG export")
    pr.add_argument("input")
    pr.add_argument("width", type=int)
    pr.add_argument("height", type=int)
    pr.add_argument("--rgb", action="store_true")
    pr.add_argument("--png-prefix", default=None)
    pr.add_argument(
        "--frames", default=None,
        help='frames to export: "all", "a:b", or a comma list '
        "(default: first/middle/last; full export matches "
        "RenderVideo.java:54-87 playing every frame)",
    )
    pr.add_argument(
        "--play", action="store_true",
        help="fps-paced playback: pipe the video as y4m into a player "
        "(ffplay/mpv when a display exists; any y4m-reading command via "
        "--player) — the reference's RenderVideo playback loop",
    )
    pr.add_argument("--fps", type=float, default=30.0,
                    help="playback rate for --play")
    pr.add_argument(
        "--player", default=None,
        help="player command reading YUV4MPEG2 on stdin "
        "(default: ffplay, then mpv)",
    )
    pr.set_defaults(fn=cmd_render)

    pw = sub.add_parser(
        "sweep", help="rate-distortion sweep (quant x block -> bpp/PSNR/fps)"
    )
    pw.add_argument("input", help='raw grayscale video path, or "synthetic"')
    pw.add_argument("width", type=int)
    pw.add_argument("height", type=int)
    pw.add_argument("frames", type=int, nargs="?", default=None)
    pw.add_argument("--quants", default="0,1,2,5,10,20",
                    help="comma-separated quant strengths")
    pw.add_argument("--blocks", default="8,4",
                    help="comma-separated cube edges")
    pw.add_argument("--quant-bias", type=float, default=0.5)
    pw.add_argument("--zlib-level", type=int, default=9)
    pw.add_argument("--deflate-workers", type=int, default=-1)
    pw.add_argument(
        "--dtype", default="float32",
        choices=("float32", "bfloat16", "f32", "bf16"),
        help="transform dtype for the RD rows (bfloat16 = fast profile)",
    )
    pw.add_argument("--output", default=None, help="write JSON table here")
    pw.add_argument(
        "--turbo", action="store_true",
        help="also report the turbo profile's bpp at each point "
        "(pixels are identical, so PSNR is shared)",
    )
    pw.set_defaults(fn=cmd_sweep)

    pq = sub.add_parser("psnr", help="PSNR between two raw videos")
    pq.add_argument("a")
    pq.add_argument("b")
    pq.add_argument("width", type=int)
    pq.add_argument("height", type=int)
    pq.add_argument("--rgb", action="store_true",
                    help="inputs are interleaved RGB (3 B/px); PSNR over "
                    "all three channels")
    pq.set_defaults(fn=cmd_psnr)

    return p


def main(argv: list[str] | None = None) -> int:
    from .utils import enable_compilation_cache

    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
