"""Turbo (planar) profile: block-compressed planes, no Exp-Golomb anywhere.

The reference's entropy stack (Exp-Golomb + zlib) is inherently bit-serial
on the host side; the repo's device bit-packer makes ENCODE parallel, but
host decode still walks codewords.  The turbo profile is the
accelerator-native alternative: the wire carries exactly the codec's
device transport format — a packed-nibble plane of quantized zigzag
coefficients plus a sparse exception list — block-compressed per GOP.  Consequences:

  * encode: the device step is transform + nibble pack + exception
    compaction (ops/exceptions.py) — the whole Exp-Golomb bit-pack stage
    disappears;
  * decode: the host does nothing but decompress (GOP-parallel across
    members); planes feed decode_step_planar4 directly;
  * pixels are IDENTICAL to the reference profile (same quantized
    integers, same inverse transform) — only the container differs;
  * rate: with the coefficient-pair-major wire layout + dense delta DC
    stream, SMALLER than the reference stack across the quant range
    even at the speed-knee default zstd-3 (`sweep --turbo` reports both
    rates; cfg.turbo_zstd_level picks the point).

Wire format (docs/FORMAT.md): one D3MH member (type 5) per GOP; payload =
four length-prefixed compressed streams (coefficient-pair-major nibble
plane, dense DC deltas int16, exception-index deltas int32, exception
values int16).  Streams are zstd by default (smaller and much faster than
DEFLATE here) or zlib via cfg.turbo_codec; decode sniffs each stream's
magic, so every decoder reads every wire.

The reference cannot read this container — it is an explicit extension
profile (`encode --turbo`), not the default.
"""

from __future__ import annotations

import collections
import functools
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CodecConfig
from ..ops import exceptions
from ..parallel.multihost import (
    MEMBER_BLUE, MEMBER_GREEN, MEMBER_INDEX, MEMBER_RED, MEMBER_TEMPORAL,
    _member, split_members,
)
from .transform import TransformContext, _frames_to_q
from .decoder import _dispatch_planar4, _undelta

try:  # optional: smaller AND faster than DEFLATE on the nibble plane
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None

#: every zstd frame starts with this magic; zlib streams start 0x78
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

MEMBER_TURBO = 5
#: turbo RGB channel members (red, green, blue), one per GOP per channel
MEMBER_TURBO_RGB = (6, 7, 8)

def _warn_fallback_once(already: bool) -> bool:
    """One note per encoder when the wire degenerates (benign race under
    the drain pool: at worst two notes).  Shared by TurboEncoder and
    TurboShardedEncoder; returns the new warned flag."""
    if not already:
        import sys

        print(
            "note: turbo wire degenerate on this content (exceptions "
            f"above {FALLBACK_EXC_FRAC:.0%} of coefficients); affected "
            "GOPs ship as reference-profile members (decode "
            "auto-routes per member)", file=sys.stderr,
        )
    return True


#: Per-GOP escape hatch for content the nibble wire degenerates on
#: (near-lossless quants: most coefficients exceed [-8, 7] and flood the
#: int32-delta + int16 exception streams, measured -9% bpp vs the
#: reference format at quant 0, BASELINE.md).  When a GOP's exception
#: count crosses this fraction of its coefficients, the encoder ALSO
#: builds the GOP as a self-contained reference-profile member
#: (Exp-Golomb + DEFLATE) and ships whichever is smaller, tagged with the
#: corresponding reference member type — so a turbo container may
#: interleave reference members and decode auto-routes per member.
#: Typical content runs 0.2-1.5% exceptions and never triggers the probe.
FALLBACK_EXC_FRAC = 0.02
#: turbo member type -> its reference-profile fallback member type
_FALLBACK_TYPE = {
    MEMBER_TURBO: MEMBER_TEMPORAL,
    MEMBER_TURBO_RGB[0]: MEMBER_RED,
    MEMBER_TURBO_RGB[1]: MEMBER_GREEN,
    MEMBER_TURBO_RGB[2]: MEMBER_BLUE,
}
_REF_TYPES = frozenset(_FALLBACK_TYPE.values())


def _pick_member(raw_gop: np.ndarray, payload: bytes, n_exc: int, t: int,
                 member_type: int, cfg: CodecConfig, ctx, warn) -> bytes:
    """Emit the GOP as a turbo member, or as a reference-profile member
    when the turbo wire degenerates (see FALLBACK_EXC_FRAC).  The probe
    compares ACTUAL encoded sizes, so the choice is content-measured, and
    it is a pure function of (GOP pixels, cfg) — the sharded turbo
    encoder makes the identical choice, preserving the mesh-vs-single
    byte-identity invariant."""
    if n_exc <= FALLBACK_EXC_FRAC * raw_gop.size:
        return _member(payload, t, member_type)
    import dataclasses

    from .encoder import encode_video

    # Serial sink: deterministic reference-layout bytes regardless of the
    # caller's deflate worker pool.
    ref = encode_video(
        raw_gop, dataclasses.replace(cfg, deflate_workers=0), ctx
    )
    if len(ref) < len(payload):
        warn()
        return _member(ref, t, _FALLBACK_TYPE[member_type])
    return _member(payload, t, member_type)


def _plane_and_tables(qp, slots: int, wire: bool = False):
    """Shared back half of every turbo encode path: coefficients ->
    (nibble plane, dense DC, exception tables).  One body so the
    single-device and sharded encoders cannot drift apart (their
    byte-identity is pinned).

    qp: (num_cubes, cube) quantized coefficients in PAIR-PERMUTED column
    order (even zigzag indices first, then odd — ops/dct.
    encode_matrix_pair), so the two nibble halves are contiguous slices
    and the pack is pure elementwise, with no 16.6M stride-2 interleave
    (the flat-pair formulation q.reshape(-1, 2)).

    The DC coefficient (zigzag index 0 = permuted column 0; divisor
    max(1, q*0) = 1) is out-of-nibble for essentially every cube, so it
    ships as a dense int16 stream instead of flooding the exception
    tables.  Exception tables index the PERMUTED flat order; the host
    converts back via _expand_pair.

    wire=True emits the plane already in the WIRE's coefficient-pair-major
    (cube/2, cubes) layout (ops/relayout.plane_to_wire: word transpose +
    byte peel) so _member_payload skips the host byte_transpose entirely;
    wire=False keeps the flat transport layout (decode-side staging,
    measurement tools)."""
    cube = qp.shape[-1]
    half = cube // 2
    qe, qo = qp[:, :half], qp[:, half:]
    plane = ((qe & 0xF) | ((qo & 0xF) << 4)).astype(jnp.uint8)
    if wire:
        from ..ops.relayout import plane_to_wire

        plane = plane_to_wire(plane)
    else:
        plane = plane.reshape(-1)
    dc = qe[:, 0].astype(jnp.int16)
    lidx, vals, counts, overflow = exceptions.compact_exceptions(
        qp.reshape(-1), slots=slots, dc_stride=cube
    )
    return plane, dc, lidx, vals, counts, overflow


def _expand_pair(lidx, vals, counts, cube: int):
    """Host half: device tables over the PAIR-PERMUTED flat order ->
    sorted original-zigzag-order flat (idx, val) lists.

    Permuted flat p = c*cube + pk maps to zigzag j = 2*pk for
    pk < cube/2, else 2*(pk - cube/2) + 1; exception lists are tiny
    (~0.2-1.5% of values), so the conversion + sort is host noise."""
    p_idx, val = exceptions.expand_exceptions_np(
        np.asarray(lidx), np.asarray(vals), np.asarray(counts)
    )
    half = cube // 2
    c, pk = np.divmod(p_idx, cube)
    j = np.where(pk < half, 2 * pk, 2 * (pk - half) + 1)
    idx = c * cube + j
    order = np.argsort(idx)
    return idx[order], val[order]


@functools.partial(jax.jit, static_argnames=("cfg", "slots", "wire"))
def encode_step_turbo(frames, enc_t_pair, *, cfg, slots, wire: bool = False):
    """(T, H, W) uint8 -> (nibble plane, dense DC, exception tables).

    enc_t_pair: TransformContext.enc_t_pair (pair-permuted columns); the
    quantized integers are bit-identical to the reference profile's.

    plane: (n/2,) uint8, two zigzag coefficients per byte (low nibble =
    even index) — the decode transport layout; wire=True (production
    encode) emits the WIRE's (cube/2, cubes) coefficient-pair-major
    transpose on device instead (see _plane_and_tables / _member_payload).
    """
    return _plane_and_tables(
        _frames_to_q(frames, enc_t_pair, cfg), slots, wire=wire
    )


def _compress(data: bytes, cfg: CodecConfig) -> bytes:
    """One wire stream.  zstd (default) compresses and inflates faster
    than DEFLATE level 6 on the nibble plane, and smaller;
    cfg.turbo_codec="zlib" keeps a stdlib-only wire.  Falls back to zlib
    when zstandard is absent."""
    if cfg.turbo_codec == "zstd" and _zstd is not None:
        # write_checksum gives the zstd wire the same bit-flip detection
        # zlib's adler32 gives the zlib wire (4 bytes per stream).
        return _zstd.ZstdCompressor(
            level=cfg.turbo_zstd_level, write_checksum=True
        ).compress(data)
    return zlib.compress(data, cfg.zlib_level)


def _decompress(buf: bytes) -> bytes:
    """Per-stream codec sniff: either decoder build reads either wire.

    Raises ValueError on corrupt data (both codecs), so callers see one
    stable error contract; truncated members raise EOFError upstream."""
    if buf[:4] == _ZSTD_MAGIC:
        if _zstd is None:  # pragma: no cover
            raise RuntimeError(
                "zstd-coded turbo member, but the zstandard module is not "
                "installed (re-encode with CodecConfig(turbo_codec='zlib'))"
            )
        try:
            return _zstd.ZstdDecompressor().decompress(buf)
        except _zstd.ZstdError as e:
            raise ValueError(f"corrupt turbo stream: {e}") from e
    try:
        return zlib.decompress(buf)
    except zlib.error as e:
        raise ValueError(f"corrupt turbo stream: {e}") from e


def _member_payload(plane: np.ndarray, dc: np.ndarray, idx: np.ndarray,
                    val: np.ndarray, cfg: CodecConfig,
                    wire: bool = False) -> bytes:
    """Member payload: four length-prefixed compressed streams (zstd by
    default, zlib via cfg.turbo_codec; decode sniffs per stream).

    The nibble plane is stored COEFFICIENT-pair-major — byte [jj, c] packs
    coefficients (2jj, 2jj+1) of cube c — i.e. the transpose of the device
    transport's (cubes, cube/2) byte grid.  Same-frequency coefficients
    share statistics, so DEFLATE compresses this layout much better than
    cube-major, which puts turbo BELOW the reference profile's rate.
    Exception indices are stored in the same coefficient-major order as
    sorted deltas (exceptions cluster by frequency, so deltas are small).

    wire=True: `plane` already IS the (cube/2, cubes) wire layout (emitted
    on device by encode_step_turbo(wire=True)); skip the host transpose.
    """
    from .. import native

    cube = cfg.cube_size
    if wire:
        wire_plane = np.ascontiguousarray(plane)
        cubes = wire_plane.shape[1]
    else:
        cubes = plane.size * 2 // cube
        wire_plane = native.byte_transpose(plane.reshape(cubes, cube // 2))
    idx = np.asarray(idx, np.int64)
    if cube & (cube - 1) == 0:  # power-of-two cubes: shift/mask, no divmod
        j = idx & (cube - 1)
        c = idx >> (cube.bit_length() - 1)
    else:  # pragma: no cover - block dims are powers of two in practice
        j = idx % cube
        c = idx // cube
    # Coefficient-pair-major order = stable sort by the pair key alone:
    # the incoming idx is cube-major ascending, so within one pair the
    # (cube, parity) order is already right.  A narrow key makes numpy's
    # stable sort a 1-2 pass radix (~5x the int64 argsort this replaces).
    pair = j >> 1
    key_dtype = np.uint8 if cube <= 512 else np.uint16
    order = np.argsort(pair.astype(key_dtype), kind="stable")
    i2 = ((pair * cubes + c) * 2 + (j & 1))[order]
    didx = np.diff(i2, prepend=np.int64(0)).astype(np.int32)
    dc = np.asarray(dc, np.int16)
    ddc = np.diff(dc, prepend=np.int16(0)).astype(np.int16)  # |dc| <= 5771
    # _compress takes any buffer: no 8.3 MB tobytes copy of the plane.
    parts = [
        _compress(wire_plane.reshape(-1), cfg),
        _compress(ddc, cfg),
        _compress(didx, cfg),
        _compress(np.ascontiguousarray(np.asarray(val)[order], np.int16),
                  cfg),
    ]
    head = struct.pack("<IIII", *(len(p) for p in parts))
    return head + b"".join(parts)


def _parse_payload(payload: bytes, cube: int, wire: bool = False,
                   split_dc: bool = False):
    """Wire payload -> (plane, exception idx, exception val) with the dense
    DC stream merged back into the exception list (decode_step_planar4's
    scatter restores it like any outlier).

    wire=False returns the plane in device-transport layout (host
    byte_transpose — the sharded decoder's tile slicing wants it);
    wire=True returns the raw (cube/2, cubes) wire layout so the DEVICE
    un-transposes instead (decode_step_planar4(wire=True)) and the host
    decode drain is pure decompression.

    split_dc=True (wire only) skips the merge and returns
    (plane, dc int32, idx, val): DC is pair 0 = COLUMN 0 of the
    word-grouped layout, so the device splices it with a concat instead
    of scattering `cubes` extra elements."""
    if len(payload) < 16:
        raise EOFError("torn turbo member (truncated header)")
    a, b, c, d = struct.unpack_from("<IIII", payload, 0)
    if 16 + a + b + c + d > len(payload):
        raise EOFError(
            "torn turbo member (payload shorter than its stream lengths); "
            "a checkpointed encode resumes past this via resume_info"
        )
    o = 16
    wire_plane = np.frombuffer(_decompress(payload[o : o + a]), np.uint8)
    o += a
    ddc = np.frombuffer(_decompress(payload[o : o + b]), np.int16)
    dc = np.cumsum(ddc.astype(np.int32)).astype(np.int16)
    o += b
    didx = np.frombuffer(_decompress(payload[o : o + c]), np.int32)
    o += c
    val = np.frombuffer(_decompress(payload[o : o + d]), np.int16)
    from .. import native

    cubes = dc.size
    if wire:
        plane = wire_plane.reshape(cube // 2, cubes)
    else:
        plane = native.byte_transpose(
            wire_plane.reshape(cube // 2, cubes)
        ).reshape(-1)
    i2 = np.cumsum(didx.astype(np.int64))
    cpos = (i2 >> 1) % cubes
    jj = (i2 >> 1) // cubes
    idx = cpos * cube + jj * 2 + (i2 & 1)
    if split_dc:
        if not wire:
            raise ValueError("split_dc needs the wire layout")
        return plane, dc.astype(np.int32), idx, val.astype(np.int32)
    idx_all = np.concatenate(
        [idx, np.arange(cubes, dtype=np.int64) * cube]
    )
    val_all = np.concatenate([val.astype(np.int32), dc.astype(np.int32)])
    return plane, idx_all, val_all


class TurboEncoder:
    """Push frames, get turbo container bytes (one type-5 member per GOP).

    Same pipelining shape as StreamingEncoder: per-GOP device dispatch, a
    drainer thread overlapping D2H + DEFLATE with compute, and a
    slots-budget overflow retry (exception-dense groups re-encode with the
    cannot-overflow table shape).
    """

    def __init__(
        self,
        width: int,
        height: int,
        cfg: CodecConfig | None = None,
        ctx: TransformContext | None = None,
        slots: int = exceptions.DEFAULT_SLOTS,
        max_inflight: int = 6,
        member_type: int = MEMBER_TURBO,
    ) -> None:
        from .entropy import resolve_workers

        self.member_type = member_type
        self.cfg = cfg or CodecConfig()
        self.cfg.validate_geometry(width, height)
        self.width = width
        self.height = height
        self.ctx = ctx or TransformContext(self.cfg)
        self.slots = slots
        self.frames_encoded = 0
        self.max_inflight = max_inflight
        # Unlike the reference stream's single zlib state, turbo members are
        # independent — the drain stage (D2H + DEFLATE) fans out across
        # cores; output order is preserved by the futures deque regardless
        # of completion order.
        self._drainer = ThreadPoolExecutor(
            max_workers=resolve_workers(self.cfg.deflate_workers)
        )
        self._out: collections.deque = collections.deque()
        self._warned_fallback = False

    def _warn_fallback(self) -> None:
        self._warned_fallback = _warn_fallback_once(self._warned_fallback)

    def _drain_gop(self, frames_dev, t, raw) -> bytes:
        plane, dc, lidx, vals, counts, overflow = encode_step_turbo(
            frames_dev, self.ctx.enc_t_pair, cfg=self.cfg, slots=self.slots,
            wire=True,
        )
        if bool(overflow):
            plane, dc, lidx, vals, counts, _ = encode_step_turbo(
                frames_dev, self.ctx.enc_t_pair, cfg=self.cfg, slots=256,
                wire=True,
            )
        idx, val = _expand_pair(lidx, vals, counts, self.cfg.cube_size)
        payload = _member_payload(
            np.asarray(plane), np.asarray(dc), idx, val, self.cfg, wire=True
        )
        return _pick_member(raw, payload, idx.size, t, self.member_type,
                            self.cfg, self.ctx, self._warn_fallback)

    def push(self, frames: np.ndarray) -> bytes:
        t = frames.shape[0]
        if t % self.cfg.gop_size:
            raise ValueError(
                f"batch of {t} frames is not a multiple of GOP "
                f"{self.cfg.gop_size}"
            )
        if frames.shape[1:] != (self.height, self.width):
            raise ValueError("frame geometry mismatch")
        gop = self.cfg.gop_size
        for i in range(0, t, gop):
            raw = frames[i : i + gop]
            batch = raw
            if self.cfg.transport_delta:
                delta = np.empty_like(batch)
                delta[0] = batch[0]
                np.subtract(batch[1:], batch[:-1], out=delta[1:])
                batch = delta
            frames_dev = jnp.asarray(batch)
            self._out.append(
                self._drainer.submit(self._drain_gop, frames_dev, gop, raw)
            )
            if len(self._out) > self.max_inflight:
                self._out[0].result()
        self.frames_encoded += t
        out = []
        while self._out and self._out[0].done():
            out.append(self._out.popleft().result())
        return b"".join(out)

    def drain(self) -> bytes:
        """Block for every in-flight member and return its bytes (the
        checkpointing encoder calls this before fsync so its durability
        bound is real, not max_inflight members behind)."""
        out = []
        while self._out:
            out.append(self._out.popleft().result())
        return b"".join(out)

    def finish(self) -> bytes:
        out = self.drain()
        self._drainer.shutdown(wait=True)
        return out


def encode_turbo_video(
    frames: np.ndarray,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
) -> bytes:
    cfg = cfg or CodecConfig()
    t = frames.shape[0] - frames.shape[0] % cfg.gop_size
    enc = TurboEncoder(frames.shape[2], frames.shape[1], cfg, ctx)
    data = enc.push(frames[:t])
    return data + enc.finish()


class TurboShardedEncoder:
    """Turbo encode over a (gop, tile) device mesh; output byte-identical
    to the single-device TurboEncoder.

    Far simpler than the reference profile's sharded packer: turbo has no
    bit phases — shard rank order IS global value order (GOP-major, then
    block-row tiles), so the gathered plane slices per GOP directly, and
    the gathered (group, slot) exception tables are already globally
    ordered (groups are value-order contiguous).  No cross-shard
    collectives at all except the overflow psum.
    """

    def __init__(self, width, height, mesh, cfg=None, ctx=None,
                 slots: int = exceptions.DEFAULT_SLOTS,
                 member_type: int = MEMBER_TURBO):
        from jax.sharding import NamedSharding, PartitionSpec as P
        from jax import shard_map

        from ..parallel.mesh import GOP_AXIS, TILE_AXIS

        self.member_type = member_type
        self.cfg = cfg or CodecConfig()
        self.cfg.validate_geometry(width, height)
        self.width = width
        self.height = height
        self.mesh = mesh
        self.ctx = ctx or TransformContext(self.cfg)
        self.slots = slots
        n_gop, n_tile = mesh.shape[GOP_AXIS], mesh.shape[TILE_AXIS]
        if height % (self.cfg.block_h * n_tile):
            raise ValueError(
                f"height {height} must split into {n_tile} tiles of whole "
                f"{self.cfg.block_h}-pixel block rows"
            )
        self._mesh_shape = (n_gop, n_tile)
        self._sharding = NamedSharding(mesh, P(GOP_AXIS, TILE_AXIS, None))
        # push() ships RAW frames to the shards (like the reference-profile
        # ShardedEncoder; the CLI notes that --transport-delta is a
        # single-device upload optimization), so the shard body must not
        # run _frames_to_q's un-delta scan.
        import dataclasses as _dc

        cfg_ = _dc.replace(self.cfg, transport_delta=False)

        def _shard(frames, enc_t_pair, *, slots):
            import jax as _jax

            # wire=True: each shard emits its (cube/2, local_cubes) wire
            # slab on device; tiles own contiguous global cube ranges, so
            # the GOP wire plane is just their column-wise concatenation —
            # no host byte_transpose anywhere in the sharded drain either.
            plane, dc, lidx, vals, counts, ovf = _plane_and_tables(
                _frames_to_q(frames, enc_t_pair, cfg_), slots, wire=True
            )
            any_ovf = _jax.lax.psum(
                ovf.astype(jnp.int32), (GOP_AXIS, TILE_AXIS)
            ) > 0
            return (plane[None], dc[None], lidx[None], vals[None],
                    counts[None], any_ovf[None])

        def build(slots):
            fn = shard_map(
                functools.partial(_shard, slots=slots),
                mesh=mesh,
                in_specs=(P(GOP_AXIS, TILE_AXIS, None), P()),
                out_specs=(P((GOP_AXIS, TILE_AXIS)),) * 5 + (P(),),
            )
            return jax.jit(fn)

        from .entropy import resolve_workers

        self._build = build
        self._step = {slots: build(slots)}
        self._pool = ThreadPoolExecutor(
            max_workers=resolve_workers(self.cfg.deflate_workers)
        )
        self.frames_encoded = 0

    def push(self, frames: np.ndarray) -> bytes:
        n_gop, n_tile = self._mesh_shape
        step_t = self.cfg.gop_size * n_gop
        t, h, w = frames.shape
        if t % step_t or (h, w) != (self.height, self.width):
            raise ValueError(
                f"push expects T % {step_t} == 0 and geometry "
                f"{self.height}x{self.width}"
            )
        out = []
        for i in range(0, t, step_t):
            fd = jax.device_put(frames[i : i + step_t], self._sharding)
            plane, dc, lidx, vals, counts, ovf = self._step[self.slots](
                fd, self.ctx.enc_t_pair
            )
            if bool(np.asarray(ovf)):
                worst = self._step.setdefault(256, self._build(256))
                plane, dc, lidx, vals, counts, _ = worst(
                    fd, self.ctx.enc_t_pair
                )
            # Gathered arrays are in global value order; slice per GOP and
            # emit members identical to the single-device encoder's.
            # plane: (n_shards, cube/2, local_cubes) wire slabs; the GOP
            # wire plane is its tiles' column concatenation.
            hc = self.cfg.cube_size // 2
            plane_h = np.asarray(jax.device_get(plane)).reshape(
                n_gop, n_tile, hc, -1
            )
            dc_h = np.asarray(dc).reshape(-1)
            idx, val = _expand_pair(
                np.asarray(lidx).reshape(-1, np.asarray(lidx).shape[-1]),
                np.asarray(vals).reshape(-1, np.asarray(vals).shape[-1]),
                np.asarray(counts).reshape(-1),
                self.cfg.cube_size,
            )
            npg = self.width * self.height * self.cfg.gop_size
            cpg = npg // self.cfg.cube_size  # cubes per GOP
            gop = self.cfg.gop_size
            futs = []
            for g in range(n_gop):
                lo, hi = np.searchsorted(idx, [g * npg, (g + 1) * npg])
                futs.append((self._pool.submit(
                    _member_payload,
                    plane_h[g].transpose(1, 0, 2).reshape(hc, -1),
                    dc_h[g * cpg : (g + 1) * cpg],
                    idx[lo:hi] - g * npg, val[lo:hi], self.cfg, True,
                ), int(hi - lo), frames[i + g * gop : i + (g + 1) * gop]))
            out.extend(
                # Same content-measured fallback as TurboEncoder (exception
                # lists and payload bytes are identical across the mesh
                # invariant, so the CHOICE is identical too — members stay
                # byte-identical to the single-device encoder's).
                _pick_member(raw_gop, f.result(), n_exc, gop,
                             self.member_type, self.cfg, self.ctx,
                             self._warn_fallback)
                for f, n_exc, raw_gop in futs
            )
            self.frames_encoded += step_t
        return b"".join(out)

    def _warn_fallback(self) -> None:
        self._warned_fallback = _warn_fallback_once(
            getattr(self, "_warned_fallback", False)
        )

    def drain(self) -> bytes:
        """push() already blocks on every member future before returning,
        so nothing is ever in flight here — kept for interface parity with
        TurboEncoder (CheckpointingEncoder drains before each fsync)."""
        return b""

    def finish(self) -> bytes:
        self._pool.shutdown(wait=True)
        return b""


class TurboShardedDecoder:
    """Turbo decode over a (gop, tile) device mesh; pixels byte-identical
    to the single-device turbo decode — the SAME production composition:
    split-DC parse (_parse_payload(split_dc=True)) + wire word peel +
    DC-as-column splice + the planar4 split-matmul body
    (codec/transform.py planar4_to_frames), so mesh and single-chip
    paths cannot diverge.

    Host work per mesh step is just n_gop parallel payload parses (pure
    decompression) + a contiguous tile reshape: the cube-major plane
    slices per tile without any relayout transpose, exceptions split by
    flat-index range, and the dense DC vector by cube range.  Member
    counts that don't fill a whole mesh step fall back to the
    single-device path for the tail.
    """

    def __init__(self, width, height, mesh, cfg=None, ctx=None,
                 inflate_workers: int | None = None):
        import os

        from jax.sharding import NamedSharding, PartitionSpec as P
        from jax import shard_map

        from ..parallel.mesh import GOP_AXIS, TILE_AXIS
        from .transform import planar4_to_frames

        self.cfg = cfg or CodecConfig()
        self.cfg.validate_geometry(width, height)
        self.width = width
        self.height = height
        self.mesh = mesh
        self.ctx = ctx or TransformContext(self.cfg)
        n_gop, n_tile = mesh.shape[GOP_AXIS], mesh.shape[TILE_AXIS]
        if height % (self.cfg.block_h * n_tile):
            raise ValueError(
                f"height {height} must split into {n_tile} tiles of whole "
                f"{self.cfg.block_h}-pixel block rows"
            )
        self._mesh_shape = (n_gop, n_tile)
        self._sharding = NamedSharding(mesh, P(GOP_AXIS, TILE_AXIS, None))
        self._workers = inflate_workers or max(1, (os.cpu_count() or 2))
        cfg_ = self.cfg
        local_h = height // n_tile

        def _shard(plane, dc, ei, ev, dec_me, dec_mo):
            # wire=True: each shard peels its own wire slab's words on
            # device (ops/relayout.wire_words + pair unscramble) — the
            # host never byte-transposes on the sharded decode either.
            # dc: the member's dense DC stream, sliced per tile (tiles own
            # contiguous cube ranges) and spliced as column 0 — the SAME
            # split-DC composition as the single-chip production decode
            # (_decode_members), so the two cannot diverge.
            return planar4_to_frames(
                plane[0, 0], ei[0, 0], ev[0, 0], dec_me, dec_mo,
                cfg=cfg_, height=local_h, width=width, wire=True,
                dc=dc[0, 0],
            )

        fn = shard_map(
            _shard,
            mesh=mesh,
            in_specs=(P(GOP_AXIS, TILE_AXIS, None, None),
                      P(GOP_AXIS, TILE_AXIS, None),
                      P(GOP_AXIS, TILE_AXIS, None),
                      P(GOP_AXIS, TILE_AXIS, None), P(), P()),
            out_specs=P(GOP_AXIS, TILE_AXIS, None),
        )
        self._step = jax.jit(
            lambda p, dc, ei, ev: fn(p, dc, ei, ev,
                                     self.ctx.dec_me, self.ctx.dec_mo)
        )

    def _stage(self, parsed) -> tuple:
        """n_gop parsed split-DC WIRE payloads -> sharded
        (plane, dc, exc_idx, exc_val).

        Tiles own contiguous cube ranges, so tile t's wire slab is columns
        [t*local_c, (t+1)*local_c) of the (cube/2, cubes) wire plane — a
        cheap row-chunk copy, never a byte transpose — and its DC span is
        the same contiguous slice of the dense DC vector."""
        n_gop, n_tile = self._mesh_shape
        npg = self.width * self.height * self.cfg.gop_size
        local_n = npg // n_tile
        hc = self.cfg.cube_size // 2
        plane = np.stack([
            np.swapaxes(p.reshape(hc, n_tile, -1), 0, 1)
            for p, _, _, _ in parsed
        ])  # (n_gop, n_tile, hc, local_cubes)
        dc = np.stack([d.reshape(n_tile, -1) for _, d, _, _ in parsed])
        counts = [
            int(((idx >= t * local_n) & (idx < (t + 1) * local_n)).sum())
            for _, _, idx, _ in parsed for t in range(n_tile)
        ]
        # Same {2^k, 1.5*2^k} bucket ladder as decoder._pad_exceptions:
        # dropped pad slots still cost scatter latency per slot.
        need = max(1, max(counts))
        p2 = max(1024, 1 << int(np.ceil(np.log2(need))))
        cap = p2 * 3 // 4 if need <= p2 * 3 // 4 else p2
        ei = np.full((n_gop, n_tile, cap), local_n, np.int32)
        ev = np.zeros((n_gop, n_tile, cap), np.int32)
        for g, (_, _, idx, val) in enumerate(parsed):
            tile = idx // local_n
            for t in range(n_tile):
                sel = tile == t
                k = int(sel.sum())
                ei[g, t, :k] = idx[sel] - t * local_n
                ev[g, t, :k] = val[sel]
        return plane, dc, ei, ev

    def decode(self, data: bytes,
               member_type: int = MEMBER_TURBO) -> np.ndarray:
        members = [
            m for m in split_members(data)
            if m[2] in (member_type, _FALLBACK_TYPE[member_type])
        ]
        if not members:
            raise ValueError(
                f"not a turbo container (no type-{member_type} members)"
            )
        n_gop, n_tile = self._mesh_shape
        gop = self.cfg.gop_size
        n_steps = len(members) // n_gop
        # Step offsets assume one GOP per member of turbo type (what every
        # turbo encoder emits); reference-profile fallback members (see
        # FALLBACK_EXC_FRAC) or odd sizes decode via the general path.
        if any(m[0] != gop or m[2] != member_type
               for m in members[: n_steps * n_gop]):
            n_steps = 0
        cube = self.cfg.cube_size
        step_t = gop * n_gop
        total_t = sum(m[0] for m in members)
        out = np.empty((total_t, self.height, self.width), np.uint8)
        pending: collections.deque = collections.deque()

        def drain_one() -> None:
            a0, fd = pending.popleft()
            got = np.asarray(fd)
            for g in range(n_gop):  # transport_delta reconstructs per GOP
                out[a0 + g * gop : a0 + (g + 1) * gop] = _undelta(
                    got[g * gop : (g + 1) * gop], self.cfg
                )

        with ThreadPoolExecutor(self._workers) as pool:
            lookahead = max(n_gop, 2 * self._workers)
            inflight: collections.deque = collections.deque(
                pool.submit(_parse_payload, m[1], cube, True, True)
                for m in members[: min(n_steps * n_gop, lookahead)]
            )
            nxt = len(inflight)
            for s in range(n_steps):
                parsed = []
                for _ in range(n_gop):
                    parsed.append(inflight.popleft().result())
                    if nxt < n_steps * n_gop:
                        inflight.append(pool.submit(
                            _parse_payload, members[nxt][1], cube,
                            True, True,
                        ))
                        nxt += 1
                plane, dc, ei, ev = self._stage(parsed)
                fd = self._step(
                    jax.device_put(plane, self._sharding),
                    jax.device_put(dc, self._sharding),
                    jax.device_put(ei, self._sharding),
                    jax.device_put(ev, self._sharding),
                )
                fd.copy_to_host_async()
                pending.append((s * step_t, fd))
                if len(pending) >= 3:
                    drain_one()
            while pending:
                drain_one()
            if n_steps * n_gop < len(members):  # tail: single-device path
                out[n_steps * step_t :] = _decode_members(
                    members[n_steps * n_gop :], pool,
                    self.width, self.height, self.cfg, self.ctx,
                )
        return out


def is_turbo_container(members: Iterable[tuple[int, bytes, int]]) -> bool:
    """Turbo containers may interleave reference-profile fallback members
    (MEMBER_TEMPORAL) for GOPs where the nibble wire degenerates — see
    FALLBACK_EXC_FRAC.  A container where EVERY GOP fell back carries no
    type-5 member at all and is, by construction, a plain temporal
    container (routed as such)."""
    types = {m[2] for m in members}
    return MEMBER_TURBO in types and types <= {
        MEMBER_TURBO, MEMBER_TEMPORAL, MEMBER_INDEX
    }


def is_turbo_rgb_container(members: Iterable[tuple[int, bytes, int]]) -> bool:
    """Like is_turbo_container, channel members may interleave per-GOP
    RGB-channel fallback types (1/2/3).  A container where EVERY GOP of
    every channel fell back carries only channel types — it is a plain RGB
    container ONLY in the one-member-per-channel shape decode_rgb_video
    reads; with several members per channel it must route here (the
    per-channel member walk reads both types)."""
    members = list(members)
    types = {m[2] for m in members}
    channel = {MEMBER_RED, MEMBER_GREEN, MEMBER_BLUE}
    if not types or not types <= set(MEMBER_TURBO_RGB) | channel:
        return False
    if types & set(MEMBER_TURBO_RGB):
        return True
    return sum(1 for m in members if m[2] in channel) > 3


def encode_turbo_rgb_video(
    frames: np.ndarray,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    mesh=None,
) -> bytes:
    """(T, H, W, 3) interleaved RGB -> turbo container: per channel, one
    type-6/7/8 member per GOP (channel-major member order, like the
    reference-profile RGB container).

    mesh: optional (gop, tile) device mesh — channels encode through
    TurboShardedEncoder (members byte-identical to single-device); frames
    truncate to whole mesh steps."""
    cfg = cfg or CodecConfig()
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError("expected (T, H, W, 3) interleaved RGB")
    ctx = ctx or TransformContext(cfg)
    align = cfg.gop_size if mesh is None else cfg.gop_size * mesh.shape["gop"]
    t = frames.shape[0] - frames.shape[0] % align
    if t == 0:
        raise ValueError(f"input shorter than one {align}-frame step")
    out = []
    for c, mtype in enumerate(MEMBER_TURBO_RGB):
        if mesh is not None:
            enc = TurboShardedEncoder(frames.shape[2], frames.shape[1],
                                      mesh, cfg, ctx, member_type=mtype)
        else:
            enc = TurboEncoder(frames.shape[2], frames.shape[1], cfg, ctx,
                               member_type=mtype)
        plane = np.ascontiguousarray(frames[:t, :, :, c])
        out.append(enc.push(plane) + enc.finish())
    return b"".join(out)


def decode_turbo_rgb_video(
    data: bytes,
    width: int,
    height: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
) -> np.ndarray:
    """One split, one inflate pool shared by all three channels."""
    import os

    cfg = cfg or CodecConfig()
    ctx = ctx or TransformContext(cfg)
    members = split_members(data)
    by_type = {
        t: [m for m in members if m[2] in (t, _FALLBACK_TYPE[t])]
        for t in MEMBER_TURBO_RGB
    }
    if not all(by_type.values()):
        raise ValueError("not a turbo-rgb container (missing channels)")
    with ThreadPoolExecutor(max(1, (os.cpu_count() or 2))) as pool:
        planes = [
            _decode_members(by_type[t], pool, width, height, cfg, ctx)
            for t in MEMBER_TURBO_RGB
        ]
    return np.stack(planes, axis=-1)


def decode_turbo_container(
    data: bytes,
    width: int,
    height: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    inflate_workers: int | None = None,
    member_type: int = MEMBER_TURBO,
) -> np.ndarray:
    """Turbo container -> (T, H, W) uint8; pixels identical to the
    reference profile's decode of the same source.

    The host entropy stage is pure inflate, GOP-parallel on a pool; device
    inverse transforms overlap via the same async window as decode_video.
    """
    import os

    cfg = cfg or CodecConfig()
    ctx = ctx or TransformContext(cfg)
    members = [
        m for m in split_members(data)
        if m[2] in (member_type, _FALLBACK_TYPE[member_type])
    ]
    # No turbo-typed member at all is still legal when every GOP fell back
    # to its reference-profile type (see FALLBACK_EXC_FRAC) — that
    # container decodes here OR through the plain temporal route.
    if not members:
        raise ValueError(
            f"not a turbo container (no type-{member_type} members)"
        )
    with ThreadPoolExecutor(
        inflate_workers or max(1, min(len(members), (os.cpu_count() or 2)))
    ) as pool:
        return _decode_members(members, pool, width, height, cfg, ctx)


def decode_turbo_rgb_range(
    data: bytes,
    width: int,
    height: int,
    start: int,
    stop: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
) -> np.ndarray:
    """Random-access decode of frames [start, stop) from a turbo-rgb
    container -> (stop-start, H, W, 3): each channel skips its
    non-covering members (decode_turbo_range per channel type)."""
    cfg = cfg or CodecConfig()
    ctx = ctx or TransformContext(cfg)
    planes = [
        decode_turbo_range(data, width, height, start, stop, cfg, ctx,
                           member_type=t)
        for t in MEMBER_TURBO_RGB
    ]
    return np.stack(planes, axis=-1)


def decode_turbo_range(
    data: bytes,
    width: int,
    height: int,
    start: int,
    stop: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    inflate_workers: int | None = None,
    member_type: int = MEMBER_TURBO,
) -> np.ndarray:
    """Random-access decode of frames [start, stop) from a turbo container.

    Members are self-delimiting and independent (one GOP each, including
    any reference-profile fallback members), so the skipped prefix costs
    NOTHING — not even an inflate pass (unlike the reference profile's
    single zlib stream, codec/decoder.decode_frame_range).  Pixels are
    identical to the same slice of decode_turbo_container's output.
    ``member_type`` selects a turbo-rgb channel (decode_turbo_rgb_range).
    """
    import os

    cfg = cfg or CodecConfig()
    ctx = ctx or TransformContext(cfg)
    if not (0 <= start < stop):
        raise ValueError(f"bad frame range [{start}, {stop})")
    covering = []
    a0 = 0
    saw_member = False
    for m in split_members(data):
        if m[2] not in (member_type, _FALLBACK_TYPE[member_type]):
            continue
        saw_member = True
        if a0 + m[0] > start and a0 < stop:
            if not covering:
                first_a0 = a0
            covering.append(m)
        a0 += m[0]
        if a0 >= stop:
            break
    if not saw_member:
        # Wrong container type, not truncation: the decode error contract
        # wants ValueError here (decode_turbo_container agrees).
        raise ValueError(
            f"not a turbo container (no type-{member_type} members)"
        )
    if a0 < stop:
        raise EOFError(
            f"container holds {a0} frames, range [{start}, {stop}) "
            "reaches past the end"
        )
    with ThreadPoolExecutor(
        inflate_workers or max(1, min(len(covering), (os.cpu_count() or 2)))
    ) as pool:
        span = _decode_members(covering, pool, width, height, cfg, ctx)
    return span[start - first_a0 : stop - first_a0]


def _decode_members(members, pool, width, height, cfg, ctx) -> np.ndarray:
    """Inflate members on `pool`, dispatch inverse transforms, assemble.

    The inflate lookahead is bounded (not ``pool.map`` over every member):
    an hour of 1080p is ~10K members whose inflated planes would otherwise
    all materialize in host RAM before the first device dispatch retires.

    Members may interleave reference-profile fallback types (see
    FALLBACK_EXC_FRAC): those decode through the full reference path
    (decode_video — host Exp-Golomb entropy + its own device dispatch) on
    the same pool slot and land directly in the output.
    """
    from .decoder import decode_video

    out = np.empty(
        (sum(m[0] for m in members), height, width), np.uint8
    )
    pending: collections.deque = collections.deque()

    def drain_one() -> None:
        a0, t, fd = pending.popleft()
        out[a0 : a0 + t] = _undelta(np.asarray(fd), cfg)

    a0 = 0
    cube = cfg.cube_size
    lookahead = max(4, 2 * getattr(pool, "_max_workers", 2))

    def _submit(m):
        t_m, payload, mtype = m
        if mtype in _REF_TYPES:
            return pool.submit(
                decode_video, payload, width, height, t_m, cfg, ctx
            )
        return pool.submit(_parse_payload, payload, cube, True, True)

    inflight: collections.deque = collections.deque(
        _submit(m) for m in members[:lookahead]
    )
    nxt = len(inflight)

    def parsed_in_order():
        nonlocal nxt
        while inflight:
            planar = inflight.popleft().result()
            if nxt < len(members):
                inflight.append(_submit(members[nxt]))
                nxt += 1
            yield planar

    for (t, _, mtype), planar in zip(members, parsed_in_order()):
        if mtype in _REF_TYPES:
            out[a0 : a0 + t] = planar  # already decoded frames
            a0 += t
            continue
        fd = _dispatch_planar4(planar, ctx, cfg, height, width, wire=True)
        fd.copy_to_host_async()
        pending.append((a0, t, fd))
        a0 += t
        if len(pending) >= 3:
            drain_one()
    while pending:
        drain_one()
    return out
