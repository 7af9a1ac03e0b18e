"""Sharded encode/decode over a (gop, tile) device mesh.

Design (SURVEY.md §7 M4, BASELINE.json north star): frames are sharded over
devices — the temporal axis across the "gop" mesh axis, frame block-rows
across the "tile" axis.  Every device runs the same fused transform+pack
step on its shard.  The bitstream is order-sensitive (cube order: GOP-major,
then block-row — codec/framing.py), and shards own *contiguous* runs of
cubes in exactly mesh-rank order, so concatenation is the only coupling.

The serial-concatenation problem is solved on device: each shard all-gathers
the per-shard bit counts (one scalar per device), computes its
global start offset by exclusive scan, and packs its codewords already
*phase-aligned* to its global bit position.  Host assembly then only
byte-splices buffers and ORs the single overlapping boundary byte per shard
— no host-side bit shifting of bulk data (SURVEY.md §7 hard part 4).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import CodecConfig
from ..codec import entropy, framing
from ..codec.transform import TransformContext, _quantize
from ..ops import bitpack, expgolomb
from .mesh import GOP_AXIS, TILE_AXIS


def _encode_shard(frames, enc_t, carry_bits, *, cfg, max_bytes, mesh_shape,
                  tight=True, pack_bits=None):
    """Per-device body: transform, codewords, offset-aligned bit pack."""
    n_tile = mesh_shape[1]
    cubes = framing.frames_to_cubes(frames, cfg)
    # Same quantizer as the single-device path (incl. the exact-DC fix) —
    # anything else would break sharded-vs-single byte identity.
    q = _quantize(cubes, enc_t, cfg)
    code, width = expgolomb.codewords(q.reshape(-1))

    local_bits = jnp.sum(width, dtype=jnp.int32)
    # One scalar per shard; exclusive scan -> global start bit.
    all_bits = jax.lax.all_gather(
        local_bits, (GOP_AXIS, TILE_AXIS), tiled=False
    ).reshape(-1)
    rank = jax.lax.axis_index(GOP_AXIS) * n_tile + jax.lax.axis_index(TILE_AXIS)
    start = carry_bits[0] + jnp.where(
        jnp.arange(all_bits.shape[0]) < rank, all_bits, 0
    ).sum().astype(jnp.int32)
    phase = (start % 8).astype(jnp.int32)
    # Pack phase-aligned: the first `phase` bits are zeros so the buffer's
    # bytes land on global byte boundaries (a lead offset in pack_values;
    # a zero pseudo-codeword in the pack_bits fallback).
    max_width = bitpack.max_codeword_bits(cfg.cube_size)
    if pack_bits is not None:
        w_words = bitpack.budget_w_words(256, pack_bits)
    else:
        w_words = (bitpack.budget_w_words(256, cfg.pack_bits_per_value)
                   if tight else None)
    if q.size % 256 == 0:
        packed, total_bits, _, overflow = bitpack.pack_values(
            q.reshape(-1), jnp.uint32(0), phase, max_bytes,
            max_width=max_width, w_words=w_words,
        )
    else:
        code = jnp.concatenate([jnp.zeros((1,), jnp.uint32), code])
        width = jnp.concatenate([phase[None], width])
        packed, total_bits, _, overflow = bitpack.pack_bits(
            code, width, max_bytes, max_width=max_width, w_words=w_words,
        )
    # Any shard's budget overflow is everyone's problem (the stream is one
    # bit-contiguous concatenation); replicate the flag for the host retry.
    any_overflow = jax.lax.psum(
        overflow.astype(jnp.int32), (GOP_AXIS, TILE_AXIS)
    ) > 0
    # Next step's sink bit phase, replicated on device — lets consecutive
    # steps dispatch back to back without waiting for host assembly.
    # (psum rather than all_bits.sum(): the vma checker can prove psum
    # output is replicated across the axes.)
    next_carry = (
        carry_bits[0] + jax.lax.psum(local_bits, (GOP_AXIS, TILE_AXIS))
    ) % 8
    return (
        packed[None],
        (total_bits - phase)[None],
        start[None],
        next_carry[None].astype(jnp.int32),
        any_overflow[None],
    )


@functools.lru_cache(maxsize=None)
def _jitted_encode_step(mesh: Mesh, cfg: CodecConfig, max_bytes: int,
                        mesh_shape: tuple, tight: bool,
                        pack_bits: int | None = None):
    """Process-wide cache of the jitted sharded encode step (Mesh and the
    frozen CodecConfig are both hashable).  CheckpointingEncoder builds a
    fresh ShardedEncoder per member; without this cache every member would
    re-trace and re-compile the shard_map program."""
    fn = shard_map(
        functools.partial(
            _encode_shard, cfg=cfg, max_bytes=max_bytes,
            mesh_shape=mesh_shape, tight=tight, pack_bits=pack_bits,
        ),
        mesh=mesh,
        in_specs=(P(GOP_AXIS, TILE_AXIS, None), P(), P()),
        out_specs=(
            P((GOP_AXIS, TILE_AXIS)),
            P((GOP_AXIS, TILE_AXIS)),
            P((GOP_AXIS, TILE_AXIS)),
            P(),
            P(),
        ),
    )
    return jax.jit(fn)


class ShardedEncoder:
    """Multi-device streaming encoder.

    Frames per push: (T, H, W) with T a multiple of gop_size * mesh.gop and
    H a multiple of block_h * mesh.tile.  Emits one continuous zlib stream
    byte-identical to the single-device / reference-layout encoder.
    """

    def __init__(
        self,
        width: int,
        height: int,
        mesh: Mesh,
        cfg: CodecConfig | None = None,
        ctx: TransformContext | None = None,
    ) -> None:
        self.cfg = cfg or CodecConfig()
        self.width = width
        self.height = height
        self.mesh = mesh
        self.ctx = ctx or TransformContext(self.cfg)
        self.sink = entropy.make_sink(self.cfg)
        self.frames_encoded = 0
        n_gop, n_tile = mesh.shape[GOP_AXIS], mesh.shape[TILE_AXIS]
        if height % (self.cfg.block_h * n_tile):
            raise ValueError(
                f"height {height} must split into {n_tile} tiles of whole "
                f"{self.cfg.block_h}-pixel block rows"
            )
        self._mesh_shape = (n_gop, n_tile)
        self._sharding = NamedSharding(mesh, P(GOP_AXIS, TILE_AXIS, None))
        #: absolute bit position after each GOP (seekable index, same
        #: contract as StreamingEncoder.gop_bit_ends); complete after push.
        self.gop_bit_ends: list[int] = []
        self._abs_end = 0
        # The same adaptive budget ladder as StreamingEncoder — one shared
        # class so the drivers cannot drift rung-for-rung.
        from ..codec.encoder import BudgetLadder

        self._ladder = BudgetLadder(self.cfg.pack_bits_per_value)

    def _step_fn(self, max_bytes: int, tight: bool = True,
                 pack_bits: int | None = None):
        return _jitted_encode_step(
            self.mesh, self.cfg, max_bytes, self._mesh_shape, tight, pack_bits
        )

    def push(self, frames: np.ndarray) -> bytes:
        """Encode frames; T must be a multiple of gop_size * mesh.gop.

        Each device step consumes exactly ONE GOP per gop-shard — that makes
        shard rank order equal global cube order (GOP-major, then block row),
        which is what keeps the stream byte-identical to the single-device
        encoder.  Longer inputs loop over steps.
        """
        n_gop, n_tile = self._mesh_shape
        t, h, w = frames.shape
        step_t = self.cfg.gop_size * n_gop
        if t % step_t or (h, w) != (self.height, self.width):
            raise ValueError(
                f"push expects T % {step_t} == 0 and geometry "
                f"{self.height}x{self.width}"
            )
        shard_vals = self.cfg.gop_size * (h // n_tile) * w

        def step_fn():
            # Re-checked per step (assembly can climb the ladder mid-push):
            # once settled on a wider rung, every later step dispatches
            # there directly instead of double-encoding.
            budget = self._ladder.budget
            if budget is None:
                return self._step_fn(4 * shard_vals + 64, tight=False)
            max_bytes = max(
                self.cfg.stream_budget_bits_per_value * shard_vals // 8 + 64,
                budget * shard_vals // 8 + 64 if self._ladder.level else 0,
            )
            return self._step_fn(max_bytes, pack_bits=budget)

        # Pipeline: the sink bit-phase carry chains ON DEVICE, so step k+1
        # dispatches while step k's buffers are still in flight; host
        # assembly trails one step behind.
        carry = jnp.asarray([self.sink.carry_bits], jnp.int32)
        pending = None
        out = []
        for i in range(0, t, step_t):
            frames_sharded = jax.device_put(
                frames[i : i + step_t], self._sharding
            )
            carry_in = carry
            packed, bits, starts, carry, ovf = step_fn()(
                frames_sharded, self.ctx.enc_t, carry
            )
            if pending is not None:
                out.append(self._assemble_dev(*pending))
            pending = (frames_sharded, carry_in, packed, bits, starts, ovf)
        if pending is not None:
            out.append(self._assemble_dev(*pending))
        self.frames_encoded += t
        return b"".join(out)

    def _assemble_dev(self, frames_sharded, carry_in, packed, bits, starts,
                      ovf) -> bytes:
        bits_h = np.asarray(bits).astype(np.int64)
        starts_h = np.asarray(starts).astype(np.int64)
        # Pathological content: a shard blew the per-group bit budget or its
        # packed-buffer budget.  Re-dispatch just this step with worst-case
        # shapes — the device carry chain depends only on bit counts, so
        # later (already dispatched) steps stay valid.
        span_over = bool(
            np.any(starts_h % 8 + bits_h > 8 * packed.shape[1] - 7)
        )
        if bool(np.asarray(ovf)) or span_over:
            # The worst shard's measured average drives the rung skip.
            shard_vals = frames_sharded.size // int(
                np.prod(self._mesh_shape)
            )
            self._ladder.overflow(float(bits_h.max()) / shard_vals)
            worst = self._step_fn(
                4 * int(frames_sharded.size) // int(np.prod(self._mesh_shape))
                + 64,
                tight=False,
            )
            packed, bits, starts, _, _ = worst(
                frames_sharded, self.ctx.enc_t, carry_in
            )
        else:
            self._ladder.ok()
        return self._assemble(
            np.asarray(jax.device_get(packed)),
            np.asarray(bits),
            np.asarray(starts),
        )

    def _assemble(self, packed: np.ndarray, bits: np.ndarray, starts: np.ndarray) -> bytes:
        """Byte-splice phase-aligned shard buffers into the global stream."""
        carry_bits = self.sink.carry_bits
        total_bits = int(carry_bits + bits.astype(np.int64).sum())
        # Seekable index: shard k = (gop g, tile t) in rank order, so GOP g
        # starts at shard g*n_tile's offset.  starts[] already include the
        # sink's carry phase, exactly like total_bits — add the whole bytes
        # emitted so far to get absolute stream positions.
        base = (self._abs_end >> 3) << 3
        n_tile = self._mesh_shape[1]
        self.gop_bit_ends.extend(
            base + int(starts[g * n_tile])
            for g in range(1, self._mesh_shape[0])
        )
        self.gop_bit_ends.append(base + total_bits)
        self._abs_end = base + total_bits
        if total_bits >= 1 << 31:
            # Device-side offsets (start, all-bits scan) are int32; one step
            # must stay under 2^31 bits (~256 MB of entropy bits).  Large gop
            # meshes on near-lossless content can exceed it — split the push
            # into more steps instead of corrupting the stream silently.
            raise OverflowError(
                f"one sharded step produced {total_bits} bits >= 2^31; "
                "push fewer GOPs per step (smaller gop mesh axis / batch)"
            )
        nbytes = total_bits // 8 + 1
        stream = np.zeros(nbytes, dtype=np.uint8)
        for k in range(packed.shape[0]):
            s, b = int(starts[k]), int(bits[k])
            if b == 0:
                continue
            byte0 = s // 8
            phase = s % 8
            span = (phase + b + 7) // 8
            if span > packed.shape[1]:
                raise OverflowError(
                    "shard bitstream exceeded the stream buffer budget; "
                    "raise CodecConfig.stream_bits_per_value"
                )
            chunk = packed[k, :span]
            end = min(byte0 + span, nbytes)
            # OR the (up to one) boundary byte shared with the previous
            # shard; the rest is a plain copy.
            stream[byte0] |= chunk[0]
            if end - byte0 > 1:
                stream[byte0 + 1 : end] = chunk[1 : end - byte0]
        # push_packed expects the carry phase zeros at the front (bit 0).
        # Step-granularity parallel-inflate sync: the parallel sink resets
        # its priming window here (serial parity sink no-ops).
        self.sink.gop_boundary()
        return self.sink.push_packed(stream, total_bits)

    def finish(self) -> bytes:
        out = self.sink.finish()
        self.sink.close()
        return out

    @property
    def gop_sync_offsets(self) -> list[int] | None:
        """Per-GOP compressed sync offsets at STEP granularity: every GOP
        of a device step shares the step's sync (entropy.parallel_inflate
        treats equal adjacent syncs as empty spans), so mesh encodes are
        parallel-inflatable too.  None for the serial parity sink."""
        syncs = self.sink.sync_offsets()
        if syncs is None:
            return None
        n_gop = self._mesh_shape[0]
        out: list[int] = []
        for s in syncs:
            out.extend([s] * n_gop)
        return out


def sharded_decode_step(mesh: Mesh, ctx: TransformContext, cfg: CodecConfig,
                        height: int, width: int):
    """Build a jitted sharded decode: coefficient cubes -> frames.

    Coefficients arrive host-side (serial entropy decode), are laid out as
    (n_gop_shards, n_tile_shards, cubes_local, cube) and inverse-transformed
    in parallel; output frames are sharded (gop, tile) and gathered by the
    caller.
    """

    from ..codec.transform import _dequant_matmul, _finish_frames, _perm_decode

    n_tile = mesh.shape[TILE_AXIS]
    local_h = height // n_tile

    def _shard(coeffs_local, dec_me, dec_mo):
        c = coeffs_local[0, 0]
        v2 = c.reshape(c.shape[0], -1, 2)
        # Shared perm fast path + split even/odd matmul: same summation
        # order as every other decode path, so sharded pixels match
        # single-device pixels exactly.
        perm, dme, dmo = _perm_decode(cfg, local_h, width, dec_me, dec_mo)
        pixels = _dequant_matmul(v2[:, :, 0], v2[:, :, 1], dme, dmo)
        import dataclasses as _dc

        cfg_ = _dc.replace(cfg, transport_delta=False)
        return _finish_frames(pixels, cfg_, local_h, width, perm=perm)

    fn = shard_map(
        _shard,
        mesh=mesh,
        in_specs=(P(GOP_AXIS, TILE_AXIS, None, None), P(), P()),
        out_specs=P(GOP_AXIS, TILE_AXIS, None),
    )
    return jax.jit(lambda c: fn(c, ctx.dec_me, ctx.dec_mo))


class ShardedDecoder:
    """Multi-device streaming decode (entropy on host, inverse transform
    sharded over the mesh).

    Streams one mesh-step (gop_size * mesh.gop frames) at a time instead of
    materializing the whole video's coefficients: the host entropy stage
    runs step-parallel on a worker pool behind a fast eg_scan boundary
    cursor (like codec/decoder.decode_video), and device steps overlap via
    a small in-flight window.  EVERYTHING is O(step): the int32
    coefficient arrays, the inflated entropy payload (a bounded
    InflateWindow pumps the inflater on demand and drops consumed bytes),
    and — via decode_stream — the output frames, which yield to the caller
    per mesh step.  decode() assembles the generator into one array for
    callers that want the whole video.
    """

    def __init__(
        self,
        width: int,
        height: int,
        mesh: Mesh,
        cfg: CodecConfig | None = None,
        ctx: TransformContext | None = None,
        entropy_workers: int | None = None,
    ) -> None:
        self.cfg = cfg or CodecConfig()
        self.width = width
        self.height = height
        self.mesh = mesh
        self.ctx = ctx or TransformContext(self.cfg)
        self.entropy_workers = entropy_workers
        self._step = sharded_decode_step(mesh, self.ctx, self.cfg, height, width)

    def _relayout(self, vals: np.ndarray, n_gop: int, n_tile: int) -> np.ndarray:
        """Stream-ordered coefficients of ONE mesh step -> shard layout.

        Global cube order is (gop, block_row, block_col); axis 0 becomes the
        gop shard, axis 1 the tile (block-row) shard."""
        cube = self.cfg.cube_size
        rows_per_tile = self.height // self.cfg.block_h // n_tile
        cols = self.width // self.cfg.block_w
        return vals.reshape(
            n_gop, 1, n_tile, rows_per_tile * cols, cube
        ).transpose(0, 2, 1, 3, 4).reshape(n_gop, n_tile, -1, cube)

    def decode_stream(self, data: bytes, frames: int,
                      positions: list[int] | None = None,
                      _window: "entropy.InflateWindow | None" = None):
        """Generator: yield (step_t, H, W) uint8 batches, one per mesh
        step, at O(step) host RSS (bounded inflate window, bounded device
        in-flight deque, no whole-video output array).

        positions: per-GOP start bit offsets from an index member
        (docs/FORMAT.md); every mesh-step then starts at a known offset and
        the host entropy stage needs no serial scan."""
        import collections

        from .. import native

        n_gop, n_tile = self.mesh.shape[GOP_AXIS], self.mesh.shape[TILE_AXIS]
        step_t = self.cfg.gop_size * n_gop
        t = frames - frames % step_t
        n_steps = t // step_t
        step_positions = None
        if positions is not None and len(positions) >= n_steps * n_gop:
            step_positions = positions[::n_gop][:n_steps]
        cps = self.width * self.height * step_t  # coefficients per step
        sharding = NamedSharding(self.mesh, P(GOP_AXIS, TILE_AXIS, None, None))
        pending: collections.deque = collections.deque()
        win = _window or entropy.InflateWindow(data)

        def dispatch(vals: np.ndarray) -> None:
            coeffs = self._relayout(vals, n_gop, n_tile)
            fd = self._step(jax.device_put(coeffs, sharding))
            fd.copy_to_host_async()
            pending.append(fd)

        def drain_one() -> np.ndarray:
            return np.asarray(jax.device_get(pending.popleft())).reshape(
                step_t, self.height, self.width
            )

        hint = cps * self.cfg.stream_budget_bits_per_value
        try:
            if n_steps > 1 and native.load() is not None:
                for vals, _pos in entropy.parallel_chunks_bounded(
                    win, cps, n_steps, entropy.decode_values,
                    self.entropy_workers, positions=step_positions,
                    hint_bits_per_value=(
                        self.cfg.stream_budget_bits_per_value
                    ),
                ):
                    dispatch(vals)
                    if len(pending) >= 3:
                        yield drain_one()
            else:
                pos = 0
                for _s in range(n_steps):
                    win.ensure_bit(pos + hint)
                    while True:
                        arr, base = win.array(pos)
                        try:
                            vals, rel = entropy.decode_values(
                                arr, cps, pos - base
                            )
                            break
                        except EOFError:
                            if not win.pump():
                                raise
                    pos = rel + base
                    win.drop_before(pos)
                    dispatch(vals)
                    if len(pending) >= 3:
                        yield drain_one()
        except EOFError:
            raise EOFError("bitstream too short")
        while pending:
            yield drain_one()

    def decode(self, data: bytes, frames: int,
               positions: list[int] | None = None) -> np.ndarray:
        """Whole-video assembly of decode_stream (kept for callers that
        want one array; long streams should iterate decode_stream)."""
        n_gop = self.mesh.shape[GOP_AXIS]
        step_t = self.cfg.gop_size * n_gop
        t = frames - frames % step_t
        out = np.empty((t, self.height, self.width), np.uint8)
        a0 = 0
        for batch in self.decode_stream(data, frames, positions):
            out[a0 : a0 + batch.shape[0]] = batch
            a0 += batch.shape[0]
        return out
