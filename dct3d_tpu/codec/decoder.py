"""Streaming GOP decoder driver.

Mirrors the C decoder's incremental refill loop (decode(), decoder.c:85-314):
compressed bytes stream in, are inflated, Exp-Golomb-decoded until a GOP
batch of coefficients is available, then inverse-transformed on the
accelerator and emitted as frames.  Geometry (width/height/frame count) is
supplied out of band exactly like the reference (no container header,
Decoder.java:17-28, main.c:27-44).
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import jax
import numpy as np

from ..config import CodecConfig
from . import entropy
from .transform import (
    TransformContext,
    decode_step,
    decode_step_planar,
    decode_step_planar4,
)


def _undelta(frames: np.ndarray, cfg: CodecConfig) -> np.ndarray:
    """Reconstruct frames shipped as wrapping temporal deltas (exact)."""
    if not cfg.transport_delta:
        return frames
    return np.cumsum(frames, axis=0, dtype=np.uint8)


def _pad_exceptions(n: int, idx: np.ndarray, val: np.ndarray):
    """Pad exception arrays to a {2^k, 1.5*2^k} bucket (few distinct jit
    shapes); pad slots carry an out-of-range index and are dropped on
    device.  The half-step rungs matter because dropped slots still cost
    scatter latency: exception-heavy content (e.g. 80K entries) lands in
    a 96K bucket instead of 128K, ~0.26 ms/GOP less element-latency at
    1080p (~8 ns/slot)."""
    p2 = max(1024, 1 << int(np.ceil(np.log2(max(1, idx.size)))))
    cap = p2 * 3 // 4 if idx.size <= p2 * 3 // 4 else p2
    exc_idx = np.full(cap, n, np.int32)
    exc_idx[: idx.size] = idx
    exc_val = np.zeros(cap, np.int32)
    exc_val[: idx.size] = val
    return exc_idx, exc_val


def _planarize(vals: np.ndarray, cube: int):
    """int32 coefficients -> (int8 plane, exception idx/val) for cheap H2D."""
    vals = vals.reshape(-1)
    plane = vals.astype(np.int8)  # wrapping cast
    idx = np.flatnonzero(plane != vals).astype(np.int32)
    return plane.reshape(-1, cube), idx, vals[idx]


def _dispatch_planar(planar, ctx: TransformContext, cfg: CodecConfig,
                     height: int, width: int):
    """Dispatch one device inverse-transform batch from planar coefficients."""
    plane, idx, val = planar
    plane = np.asarray(plane).reshape(-1, cfg.cube_size)
    exc_idx, exc_val = _pad_exceptions(plane.size, np.asarray(idx), np.asarray(val))
    return decode_step_planar(
        jax.numpy.asarray(plane),
        jax.numpy.asarray(exc_idx),
        jax.numpy.asarray(exc_val),
        ctx.dec_me,
        ctx.dec_mo,
        cfg=cfg,
        height=height,
        width=width,
    )


def _split_dc_flat(plane: np.ndarray, idx: np.ndarray, val: np.ndarray,
                   cube: int):
    """Derive the dense per-cube DC vector of a FLAT nibble plane and drop
    the DC entries from the exception list.

    dc[c] is the true value at flat index c*cube: the sign-extended low
    nibble of the cube's first plane byte, overwritten by its exception
    when one exists — exact by construction for ANY stream (unlike the
    turbo wire, the flat format keeps small DCs in the nibble; the
    reference-profile dequant is DC-heavy, decoder.c:48-59).  The device
    then splices dc as column 0 (planar4_to_frames) and the exception
    scatter shrinks to the true outliers (~40K -> ~8K at 1080p).
    Returns (dc int32, idx', val')."""
    dc = (((plane[:: cube // 2].astype(np.int32)) & 0xF) ^ 8) - 8
    is_dc = (idx % cube) == 0
    if is_dc.any():
        dc[idx[is_dc] // cube] = val[is_dc]
        idx = idx[~is_dc]
        val = val[~is_dc]
    return dc, idx, val


def _dispatch_planar4(planar, ctx: TransformContext, cfg: CodecConfig,
                      height: int, width: int, wire: bool = False):
    """Dispatch from the packed-nibble planar format (half the upload).

    wire=True: the plane is the turbo member's (cube/2, cubes) wire layout
    and the device consumes its word rows directly (no host
    byte_transpose).  A 4-tuple planar carries the dense DC vector
    separately (turbo._parse_payload(split_dc=True)); a flat 3-tuple gets
    the same split derived host-side (_split_dc_flat) — both splice DC as
    column 0 on device instead of scattering `cubes` extra exception
    elements."""
    dc = None
    if len(planar) == 4:
        plane, dc, idx, val = planar
        dc = jax.numpy.asarray(np.ascontiguousarray(dc, np.int32))
        plane = np.asarray(plane)
    else:
        plane, idx, val = planar
        plane = np.asarray(plane)
        if not wire and plane.size:
            dc_np, idx, val = _split_dc_flat(
                plane.reshape(-1), np.asarray(idx), np.asarray(val),
                cfg.cube_size,
            )
            dc = jax.numpy.asarray(dc_np)
    n = plane.size * 2
    exc_idx, exc_val = _pad_exceptions(n, np.asarray(idx), np.asarray(val))
    return decode_step_planar4(
        jax.numpy.asarray(plane),
        jax.numpy.asarray(exc_idx),
        jax.numpy.asarray(exc_val),
        ctx.dec_me,
        ctx.dec_mo,
        cfg=cfg,
        height=height,
        width=width,
        wire=wire,
        dc=dc,
    )


def _decode_batch(vals: np.ndarray, ctx: TransformContext, cfg: CodecConfig,
                  height: int, width: int):
    """Dispatch one device inverse-transform batch from int32 coefficients."""
    return _dispatch_planar(
        _planarize(vals, cfg.cube_size), ctx, cfg, height, width
    )


class StreamingDecoder:
    """Feed compressed bytes, pull decoded frame batches."""

    def __init__(
        self,
        width: int,
        height: int,
        cfg: CodecConfig | None = None,
        ctx: TransformContext | None = None,
        gops_per_batch: int = 1,
    ) -> None:
        self.cfg = cfg or CodecConfig()
        self.cfg.validate_geometry(width, height)
        self.width = width
        self.height = height
        self.ctx = ctx or TransformContext(self.cfg)
        self.source = entropy.InflateSource()
        self.gops_per_batch = gops_per_batch
        self._coeffs_per_gop = width * height * self.cfg.gop_size

    def feed(self, data: bytes) -> None:
        self.source.feed(data)

    def feed_eof(self) -> None:
        self.source.feed_eof()

    def try_decode(self) -> np.ndarray | None:
        """Decode up to gops_per_batch GOPs if buffered; (T, H, W) uint8."""
        n = self._coeffs_per_gop * self.gops_per_batch
        vals = self.source.try_read(n)
        if vals is None and self.gops_per_batch > 1:
            # Tail: fall back to single GOPs.
            vals = self.source.try_read(self._coeffs_per_gop)
        if vals is None:
            return None
        # One device dispatch per GOP: a single compiled shape per
        # geometry.
        per = self._coeffs_per_gop
        batches = [
            _undelta(
                np.asarray(
                    _decode_batch(vals.reshape(-1)[i : i + per], self.ctx,
                                  self.cfg, self.height, self.width)
                ),
                self.cfg,
            )
            for i in range(0, vals.size, per)
        ]
        return np.concatenate(batches) if len(batches) > 1 else batches[0]


def decode_video(
    data: bytes,
    width: int,
    height: int,
    frames: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    gops_per_batch: int = 4,
    entropy_workers: int | None = None,
    positions: list[int] | None = None,
    sync_offsets: list[int] | None = None,
) -> np.ndarray:
    """One-call decode of a complete bitstream -> (T, H, W) uint8.

    `frames` is truncated to a GOP multiple (Decoder.java:34-36).

    The host entropy stage runs GOP-parallel: eg_scan finds each GOP's bit
    boundary ~5x faster than decoding (native/expgolomb.c), so the main
    thread scans ahead and a worker pool entropy-decodes several GOPs
    concurrently (the C decoder releases the GIL) while the device inverse
    transform + async D2H of earlier GOPs are in flight.  The reference's
    refill loop (decoder.c:207-236) is single-threaded and synchronous.

    ``positions`` (per-GOP start bit offsets, from a container index member)
    removes the serial scan — workers jump straight to their GOP, so the
    entropy stage scales with cores instead of capping at scan speed.
    """
    cfg = cfg or CodecConfig()
    ctx = ctx or TransformContext(cfg)
    t = frames - frames % cfg.gop_size
    n_gops = t // cfg.gop_size
    cpg = width * height * cfg.gop_size
    fpg = cfg.gop_size
    from .. import native

    if n_gops > 1 and native.load() is not None:
        # The range decoder with [0, t) IS the full decode (one shared
        # pipeline body; the range path stays pinned to this one).
        return decode_frame_range(
            data, width, height, 0, t, cfg, ctx, positions=positions,
            entropy_workers=entropy_workers, gops_per_batch=gops_per_batch,
            sync_offsets=sync_offsets,
        )
    out = np.empty((t, height, width), dtype=np.uint8)
    window = max(2, gops_per_batch)
    pending: collections.deque = collections.deque()

    def drain_one():
        a0, fd = pending.popleft()
        out[a0 * fpg : (a0 + 1) * fpg] = _undelta(np.asarray(fd), cfg)

    # No native library (or a single GOP): serial streaming route.
    dec = StreamingDecoder(width, height, cfg, ctx)
    dec.feed(data)
    dec.feed_eof()
    for g0 in range(n_gops):
        planar = dec.source.try_read_planar4(cpg)
        if planar is None:
            raise EOFError("bitstream too short for requested frame count")
        frames_dev = _dispatch_planar4(planar, ctx, cfg, height, width)
        frames_dev.copy_to_host_async()
        pending.append((g0, frames_dev))
        if len(pending) >= window:
            drain_one()
    while pending:
        drain_one()
    return out


def decode_frame_range(
    data: bytes,
    width: int,
    height: int,
    start: int,
    stop: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    positions: list[int] | None = None,
    entropy_workers: int | None = None,
    gops_per_batch: int = 4,
    sync_offsets: list[int] | None = None,
) -> np.ndarray:
    """Random-access decode of the half-open frame range [start, stop).

    Only the covering GOPs run the host entropy stage and the device
    inverse transform — the capability the reference's design forecloses
    (its decoder must walk every codeword from byte 0, decoder.c:207-236;
    GOPs here are temporally independent by construction, README).  The
    skipped prefix costs one inflate pass (the single zlib stream is not
    byte-seekable, encoder.c:139) plus, without an index, a boundary scan;
    with ``positions`` from an ``--index`` container the skip is scan-free.

    This is ALSO the full-decode pipeline: decode_video's native path is
    decode_frame_range(0, t) — one body, so the two cannot diverge.

    Returns (stop - start, H, W) pixels identical to the same slice of
    decode_video's output; raises EOFError when the stream ends before
    ``stop`` and ValueError on corrupt input (the decode error contract).
    """
    import os
    import zlib

    cfg = cfg or CodecConfig()
    ctx = ctx or TransformContext(cfg)
    if not (0 <= start < stop):
        raise ValueError(f"bad frame range [{start}, {stop})")
    fpg = cfg.gop_size
    g0, g1 = start // fpg, -(-stop // fpg)
    from .. import native

    if native.load() is None:
        # Pure-Python fallback: decode from the start and slice (correct,
        # no skip — the scan needs the C library).  No recursion:
        # decode_video only delegates here when the library IS present.
        video = decode_video(data, width, height, g1 * fpg, cfg, ctx)
        return video[start : stop]
    cpg = width * height * fpg
    try:
        if sync_offsets is not None:
            # Index v2 sync points: the last serial host stage — the whole-
            # stream inflate — runs GOP-parallel (entropy.parallel_inflate;
            # falls back to serial itself on any inconsistency).
            payload = np.frombuffer(
                entropy.parallel_inflate(data, sync_offsets,
                                         entropy_workers), np.uint8,
            )
        else:
            z = zlib.decompressobj()
            payload = np.frombuffer(z.decompress(data) + z.flush(), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt bitstream: {e}") from e
    if positions is not None:
        if len(positions) < g1:
            raise ValueError(
                f"index has {len(positions)} positions, need {g1}"
            )
        span = list(positions[g0:g1])
    elif g0 == 0:
        # Full-prefix ranges need no pre-scan: parallel_chunks overlaps
        # its own boundary discovery (speculative or scan-ahead) with the
        # GOP decode workers.
        span = None
    else:
        # Prefix skip.  The speculative scan covers the WHOLE payload
        # across all cores; the serial walk touches only the g1-GOP
        # prefix on one.  Pick by estimated work (payload carries
        # ~1.2 bits/value on typical streams -> ~payload_bytes*6.7
        # values total).
        workers = entropy_workers or (os.cpu_count() or 2)
        spec = None
        if g1 * cpg * workers > payload.size * 6.7:
            spec = entropy.speculative_positions(payload, cpg, g1,
                                                 entropy_workers)
        if spec is not None:
            span = spec[g0:g1]
        else:
            pos, span = 0, []
            for g in range(g1):
                if g >= g0:
                    span.append(pos)
                if g + 1 < g1:
                    nxt = entropy.scan_values(payload, cpg, pos)
                    if nxt is None:
                        raise EOFError(
                            "bitstream too short for requested frame range"
                        )
                    pos = nxt
    out = np.empty(((g1 - g0) * fpg, height, width), np.uint8)
    window = max(2, gops_per_batch)
    pending: collections.deque = collections.deque()

    def drain_one():
        a0, fd = pending.popleft()
        out[a0 * fpg : (a0 + 1) * fpg] = _undelta(np.asarray(fd), cfg)

    try:
        for k, (plane, ei, ev, _pos) in enumerate(entropy.parallel_chunks(
            payload, cpg, g1 - g0, entropy.decode_values_planar4,
            entropy_workers, positions=span,
        )):
            frames_dev = _dispatch_planar4(
                (plane, ei, ev), ctx, cfg, height, width
            )
            frames_dev.copy_to_host_async()
            pending.append((k, frames_dev))
            if len(pending) >= window:
                drain_one()
    except EOFError:
        raise EOFError("bitstream too short for requested frames")
    while pending:
        drain_one()
    lo, hi = start - g0 * fpg, stop - g0 * fpg
    if lo == 0 and hi == out.shape[0]:
        return out
    # Copy the trimmed slice: a view would pin up to gop_size-1 hidden
    # frames per end alive and alias them under caller writes.
    return np.ascontiguousarray(out[lo:hi])


def decode_stream(
    chunks: Iterable[bytes],
    width: int,
    height: int,
    frames: int,
    cfg: CodecConfig | None = None,
) -> Iterator[np.ndarray]:
    """Generator: inflate+decode an iterable of compressed chunks into frame
    batches, stopping after `frames` frames (GOP-truncated)."""
    cfg = cfg or CodecConfig()
    t = frames - frames % cfg.gop_size
    dec = StreamingDecoder(width, height, cfg)
    emitted = 0
    it = iter(chunks)
    exhausted = False
    while emitted < t:
        batch = dec.try_decode()
        if batch is None:
            if exhausted:
                raise EOFError("bitstream too short for requested frame count")
            try:
                dec.feed(next(it))
            except StopIteration:
                dec.feed_eof()
                exhausted = True
            continue
        emitted += batch.shape[0]
        yield batch
