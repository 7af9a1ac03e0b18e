"""Streaming GOP encoder driver.

Mirrors the C encoder's structure (encode(), encoder.c:88-293): the video
streams through in fixed GOP batches, each batch is transformed on the
accelerator, entropy-coded, and deflated into one continuous zlib stream;
bit state carries across batches.  Differences, by design (SURVEY.md §7):

  * the transform + quantization + zigzag is one jitted matmul
    (codec/transform.py) instead of two OpenCL reduction kernels,
  * Exp-Golomb packing happens on the device as a vectorized prefix-sum
    scatter (ops/bitpack.py) instead of a serial host bit loop,
  * the cross-GOP bit carry is chained ON DEVICE (encode_step returns the
    next carry as device scalars), so back-to-back batches dispatch without
    a host round trip,
  * device→host readback + DEFLATE run on a background drainer thread,
    overlapping the next batch's compute — the reference's blocking
    clEnqueueReadBuffer (encoder.c:254) forfeits all of this,
  * DEFLATE itself can fan out over a thread pool (entropy.ParallelDeflateSink)
    while staying a single reference-readable zlib stream.
"""

from __future__ import annotations

import collections
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Iterable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CodecConfig
from ..profiling import StageTimer
from . import entropy
from .transform import TransformContext, encode_step

# Device→host readback length is rounded up to this bucket so the number of
# distinct slice shapes (each a separate XLA compile) stays tiny across a
# stream of varying GOP sizes.
_D2H_BUCKET = 1 << 20


class BudgetLadder:
    """Adaptive per-group pack-budget ladder, shared by StreamingEncoder
    and the sharded encoder (parallel/sharding.py) so the two cannot
    drift rung-for-rung.

    Rungs: the configured budget (default 4), then 6, then None = the
    worst-case buffer.  After 2
    consecutive overflow retries the ladder climbs PERMANENTLY, skipping
    rungs the measured stream average already rules out (near-lossless
    content at ~8-10 bits/value jumps straight to worst-case instead of
    burning two more double-encodes discovering that 6 overflows too).
    Noisy content settles at a rung that fits instead of double-encoding
    forever; bytes are identical at every rung (the budget sizes
    buffers, not bits)."""

    def __init__(self, base: int) -> None:
        self.rungs: list[int | None] = [base] + (
            [6] if base < 6 else []
        ) + [None]
        self.level = 0
        self.streak = 0

    @property
    def budget(self) -> int | None:
        """Current rung's bits/value budget; None = worst-case buffer."""
        return self.rungs[self.level]

    def overflow(self, avg_bits: float) -> None:
        """Record one overflow retry; climbs permanently at 2 consecutive,
        skipping rungs at or below the measured average bits/value."""
        self.streak += 1
        if self.streak < 2 or self.level >= len(self.rungs) - 1:
            return
        self.level += 1
        while (self.level < len(self.rungs) - 1
               and self.rungs[self.level] is not None
               and self.rungs[self.level] <= avg_bits):
            self.level += 1
        self.streak = 0

    def ok(self) -> None:
        """A batch fit: the streak (but not the settled rung) resets."""
        self.streak = 0


class StreamingEncoder:
    """Push frames in, get compressed bytes out.

    Usage:
        enc = StreamingEncoder(width, height, cfg)
        for batch in frame_batches:        # (T, H, W) uint8, T % gop == 0
            out.write(enc.push(batch))
        out.write(enc.finish())

    push() may return b"" while work is in flight; finish() flushes
    everything.  Output bytes are always emitted in stream order.
    """

    def __init__(
        self,
        width: int,
        height: int,
        cfg: CodecConfig | None = None,
        ctx: TransformContext | None = None,
        device_pack: bool = True,
        max_inflight: int = 3,
    ) -> None:
        self.cfg = cfg or CodecConfig()
        self.cfg.validate_geometry(width, height)
        self.width = width
        self.height = height
        self.ctx = ctx or TransformContext(self.cfg)
        self.sink = entropy.make_sink(self.cfg)
        self.device_pack = device_pack
        self.frames_encoded = 0
        self.max_inflight = max_inflight
        # Single-thread drainer: serializes sink access and keeps output order
        # while overlapping readback/DEFLATE with device compute.
        self._drainer = ThreadPoolExecutor(max_workers=1)
        self._out: collections.deque[Future] = collections.deque()
        self._carry = None  # (code, bits) device scalars chaining GOPs
        #: per-stage wall time / bytes (SURVEY.md §5 observability)
        self.timer = StageTimer()
        #: absolute bit position after each GOP — the seekable stream index
        #: (docs/FORMAT.md "index member"); complete once finish() returns.
        self.gop_bit_ends: list[int] = []
        self._abs_end = 0
        # Budget ladder state (written by the drainer, read by push — a
        # benign race: at worst a couple of extra tight dispatches).
        self._ladder = BudgetLadder(self.cfg.pack_bits_per_value)

    # -- internal ------------------------------------------------------------

    def _drain_gop(self, frames_dev, carry_in, gop) -> bytes:
        """Drainer thread: fetch packed bytes (bucketed slice) and deflate.

        If the batch overflowed the budgeted pack buffer OR a pack group's
        bit budget (pathological content), re-encode just this batch with
        the worst-case shapes — the carry chain is overflow-proof
        (ops/bitpack.py), so already dispatched later batches remain valid.
        """
        with self.timer.stage("device_wait"):
            total_bits = int(gop.total_bits)
        # Per-batch total_bits includes the carried partial byte's bits, so
        # the absolute end chains as whole-bytes-so-far + batch bits.  The
        # drainer runs one GOP at a time in stream order, so appending here
        # yields the in-order index.
        self._abs_end = ((self._abs_end >> 3) << 3) + total_bits
        self.gop_bit_ends.append(self._abs_end)
        nbytes = total_bits // 8 + 1
        if nbytes > gop.packed.shape[0] or bool(gop.overflow):
            self._ladder.overflow(total_bits / frames_dev.size)
            gop = encode_step(
                frames_dev,
                self.ctx.enc_t,
                carry_in[0],
                carry_in[1],
                max_bytes=self.ctx.max_packed_bytes_worst_case(frames_dev.size),
                cfg=self.cfg,
                tight=False,
            )
        else:
            self._ladder.ok()
        cap = min(gop.packed.shape[0], -(-nbytes // _D2H_BUCKET) * _D2H_BUCKET)
        with self.timer.stage("d2h", cap):
            packed = np.asarray(jax.device_get(gop.packed[:cap]))
        with self.timer.stage("deflate", nbytes):
            # Per-GOP sync boundary: the parallel sink resets its window
            # here so decode can inflate GOPs independently (the serial
            # parity sink no-ops — one z_stream spans the file there).
            self.sink.gop_boundary()
            return self.sink.push_packed(packed, total_bits)

    def _collect(self, block: bool = False) -> bytes:
        out = []
        while self._out and (block or self._out[0].done()):
            out.append(self._out.popleft().result())
        return b"".join(out)

    # -- public --------------------------------------------------------------

    def push(self, frames: np.ndarray) -> bytes:
        """Encode a (T, H, W) uint8 batch; T must be a GOP multiple.

        Returns compressed bytes ready to append to the output stream (may
        be empty — work is pipelined and DEFLATE buffers internally).

        Internally the batch is dispatched one GOP at a time: a single
        compiled shape per geometry, and the pipeline keeps the device
        busy anyway.
        """
        t = frames.shape[0]
        if t % self.cfg.gop_size:
            raise ValueError(
                f"batch of {t} frames is not a multiple of GOP "
                f"{self.cfg.gop_size}; truncate (reference behavior, "
                "Encoder.java:39-40) or pad upstream"
            )
        if frames.shape[1:] != (self.height, self.width):
            raise ValueError("frame geometry mismatch")
        if t > self.cfg.gop_size:
            out = []
            for i in range(0, t, self.cfg.gop_size):
                out.append(self.push(frames[i : i + self.cfg.gop_size]))
            return b"".join(out)
        if self.device_pack:
            if self._carry is None:
                self._carry = (jnp.uint32(0), jnp.int32(0))
            carry_in = self._carry
            if self.cfg.transport_delta:
                delta = np.empty_like(frames)
                delta[0] = frames[0]
                np.subtract(frames[1:], frames[:-1], out=delta[1:])  # wraps
                frames = delta
            with self.timer.stage("dispatch", frames.nbytes):
                frames_dev = jnp.asarray(frames)
                budget = self._ladder.budget
                if budget is None:  # settled on the worst-case buffer
                    max_bytes = self.ctx.max_packed_bytes_worst_case(
                        frames.size
                    )
                else:
                    # Middle rungs widen the stream buffer alongside the
                    # group budget — content that blew the group budget has
                    # also outgrown the 2-bit/value stream average.
                    max_bytes = max(
                        self.ctx.max_packed_bytes(frames.size),
                        budget * frames.size // 8 + 64
                        if self._ladder.level else 0,
                    )
                gop = encode_step(
                    frames_dev,
                    self.ctx.enc_t,
                    carry_in[0],
                    carry_in[1],
                    max_bytes=max_bytes,
                    cfg=self.cfg,
                    tight=budget is not None,
                    pack_bits=budget,
                )
            self._carry = (gop.carry_code, gop.carry_bits)
            self._out.append(
                self._drainer.submit(self._drain_gop, frames_dev, carry_in, gop)
            )
            # Backpressure: bound in-flight device buffers / host memory.
            if len(self._out) > self.max_inflight:
                self._out[0].result()
        else:
            from .transform import quantize_step

            q = np.asarray(
                quantize_step(jnp.asarray(frames), self.ctx.enc_t, cfg=self.cfg)
            )
            self._out.append(
                self._drainer.submit(self.sink.push_values, q.reshape(-1))
            )
        self.frames_encoded += t
        return self._collect()

    def finish(self) -> bytes:
        """Flush pipeline + carry + DEFLATE tail.  Stream complete after.

        Also releases the drainer and sink worker threads deterministically
        (loops building many encoders — sweep, per-member checkpoint/RGB —
        must not lean on GC to reap them).  The encoder is done after this.
        """
        self._out.append(self._drainer.submit(self.sink.finish))
        out = self._collect(block=True)
        self._drainer.shutdown(wait=True)
        self.sink.close()
        return out

    @property
    def gop_sync_offsets(self) -> list[int] | None:
        """Per-GOP compressed byte sync offsets for parallel inflate
        (entropy.parallel_inflate) — available after finish() with the
        parallel sink; None for the serial reference-parity layout.
        Rides the index member alongside gop_bit_ends (docs/FORMAT.md)."""
        return self.sink.sync_offsets()


def encode_video(
    frames: np.ndarray,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    gops_per_batch: int = 1,
) -> bytes:
    """One-call encode of an in-memory (T, H, W) uint8 video.

    Frame count is truncated to a GOP multiple (Encoder.java:39-40)."""
    cfg = cfg or CodecConfig()
    t = frames.shape[0] - frames.shape[0] % cfg.gop_size
    frames = frames[:t]
    enc = StreamingEncoder(frames.shape[2], frames.shape[1], cfg, ctx)
    step = cfg.gop_size * gops_per_batch
    chunks = []
    for i in range(0, t, step):
        chunks.append(enc.push(frames[i : i + min(step, t - i)]))
    chunks.append(enc.finish())
    return b"".join(chunks)


def encode_stream(
    batches: Iterable[np.ndarray],
    width: int,
    height: int,
    cfg: CodecConfig | None = None,
) -> Iterator[bytes]:
    """Generator: encode an iterable of frame batches into stream chunks."""
    enc = StreamingEncoder(width, height, cfg)
    for batch in batches:
        yield enc.push(batch)
    yield enc.finish()
