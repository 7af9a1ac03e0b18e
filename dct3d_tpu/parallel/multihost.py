"""Multi-host scale-out: distributed ingest + ordered bitstream gather.

The reference is single-process/single-device (SURVEY.md §2.4); this module
is the framework's layer across hosts.  Design (SURVEY.md §5 "Distributed
communication backend", BASELINE.md scaling target):

  * each host process reads only ITS temporal span of the input video
    (GOP-major split — GOPs are embarrassingly parallel, encoder.c:203-278),
  * the per-host frame arrays are assembled into one global sharded array
    with ``jax.make_array_from_process_local_data`` (no frame ever crosses
    the network between hosts),
  * the fused encode step runs under the same (gop, tile) shard_map as the
    single-host path — the only cross-shard traffic is the per-shard bit
    count all-gather (scalars),
  * each host deflates ITS shards' phase-aligned bytes locally, then the
    variable-length compressed chunks are gathered to process 0 in stream
    order (one ``process_allgather`` of lengths + one of padded payloads),
    which splices and writes.  Only compressed bytes cross hosts, once.

With a single process this degrades to the ShardedEncoder path exactly and
is tested that way (a real multi-host run needs ``jax.distributed.initialize``,
which cannot be simulated in-process; the per-host logic below is pure
functions of (process_index, process_count) and is unit-tested with fakes).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..config import CodecConfig


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the JAX distributed runtime.  No-op if single-host.

    Each process sees every local GPU by default, so this suits one
    process per host.  Several processes on one machine (one per card)
    also need ``local_device_ids`` passed to ``jax.distributed.initialize``
    (and a memory share each), which this wrapper does not set."""
    import jax

    if num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_frame_span(total_frames: int, cfg: CodecConfig,
                    process_index: int, process_count: int) -> tuple[int, int]:
    """[start, stop) frame range this host ingests: a contiguous GOP-major
    slice, balanced to within one GOP.  Frame count is truncated to a GOP
    multiple first (Encoder.java:39-40)."""
    t = total_frames - total_frames % cfg.gop_size
    gops = t // cfg.gop_size
    base, extra = divmod(gops, process_count)
    start_gop = process_index * base + min(process_index, extra)
    n_gop = base + (1 if process_index < extra else 0)
    return start_gop * cfg.gop_size, (start_gop + n_gop) * cfg.gop_size


# Multi-host stream container: the reference format is headerless and its
# Exp-Golomb padding makes zlib members non-concatenable at the bit level, so
# the multi-host gather wraps each host's (whole-GOP) member with a 16-byte
# header.  Single-host output stays headerless/reference-shaped.
MEMBER_MAGIC = b"D3MH"

# Member type rides in the top byte of the count field (frame counts are
# bounded far below 2^24; round-1 containers always wrote 0 there, so old
# temporal containers parse identically).  The tag is what lets decode
# auto-route an RGB container vs a temporal (checkpoint / multi-host) one
# instead of trusting a CLI flag.
MEMBER_TEMPORAL = 0
MEMBER_RED, MEMBER_GREEN, MEMBER_BLUE = 1, 2, 3
#: Seekable index for the PRECEDING stream member: per-GOP absolute bit end
#: positions within that member's inflated Exp-Golomb payload.  Lets the
#: parallel entropy decoder jump straight to any GOP instead of serially
#: eg_scan-ning the headerless stream (the scan is the decode throughput
#: ceiling once enough worker cores exist).  Decoders that don't know the
#: type skip it like any unknown member.
MEMBER_INDEX = 4
_MAX_MEMBER_FRAMES = (1 << 24) - 1


def _member(payload: bytes, frames: int, mtype: int = MEMBER_TEMPORAL) -> bytes:
    import struct

    if frames > _MAX_MEMBER_FRAMES:
        raise ValueError(f"member frame count {frames} exceeds 2^24-1")
    return (
        MEMBER_MAGIC
        + struct.pack("<IQ", (mtype << 24) | frames, len(payload))
        + payload
    )


def split_members(data: bytes) -> list[tuple[int, bytes, int]]:
    """Parse a container into [(frame_count, zlib member, member_type), ...]."""
    import struct

    out = []
    pos = 0
    while pos < len(data):
        if data[pos : pos + 4] != MEMBER_MAGIC:
            raise ValueError("not a multi-host container (missing D3MH magic)")
        tagged, length = struct.unpack_from("<IQ", data, pos + 4)
        pos += 16
        out.append((tagged & _MAX_MEMBER_FRAMES, data[pos : pos + length],
                    tagged >> 24))
        pos += length
    return out


def make_index_member(gop_bit_ends: list[int],
                      sync_offsets: list[int] | None = None) -> bytes:
    """Frame an index member (see MEMBER_INDEX): uint32 LE GOP count, then
    one uint64 LE absolute bit end position per GOP.

    sync_offsets (v2 extension, len == GOP count): per-GOP compressed byte
    sync points from the parallel sink's window resets
    (entropy.ParallelDeflateSink.gop_boundary), appended as a second
    uint64 array — decode then inflates GOPs in parallel
    (entropy.parallel_inflate).  Old readers ignore the extra bytes
    (parse_index reads only the first array)."""
    import struct

    n = len(gop_bit_ends)
    payload = struct.pack("<I", n) + struct.pack(f"<{n}Q", *gop_bit_ends)
    if sync_offsets is not None and len(sync_offsets) == n:
        payload += struct.pack(f"<{n}Q", *sync_offsets)
    return _member(payload, 0, MEMBER_INDEX)


def parse_index(payload: bytes) -> list[int] | None:
    """Inverse of make_index_member; None for a torn/short payload (e.g. a
    crash mid-checkpoint) so callers fall back to the serial scan instead
    of refusing to decode a file whose stream members are valid."""
    import struct

    if len(payload) < 4:
        return None
    (n,) = struct.unpack_from("<I", payload, 0)
    if len(payload) < 4 + 8 * n:
        return None
    return list(struct.unpack_from(f"<{n}Q", payload, 4))


def parse_index_syncs(payload: bytes) -> list[int] | None:
    """The v2 sync-offset array of an index member, or None when the
    member predates v2 (or is torn) — callers then inflate serially."""
    import struct

    if len(payload) < 4:
        return None
    (n,) = struct.unpack_from("<I", payload, 0)
    if n == 0 or len(payload) < 4 + 16 * n:
        return None
    return list(struct.unpack_from(f"<{n}Q", payload, 4 + 8 * n))


class IndexInfo(NamedTuple):
    """Parsed index member: per-GOP bit ends (v1) + per-GOP compressed
    sync offsets for parallel inflate (v2, may be None)."""

    ends: list[int] | None
    syncs: list[int] | None


def gop_positions(index_ends: list[int], n_gops: int,
                  gop_size: int, member_frames: int) -> list[int] | None:
    """GOP START bit offsets from an index member's end positions, or None
    if the index doesn't cover the member's GOP count (decoders then fall
    back to the serial scan rather than trusting a stale index)."""
    if member_frames and len(index_ends) != member_frames // gop_size:
        return None
    if len(index_ends) < n_gops:
        return None
    return [0] + index_ends[: n_gops - 1]


def container_kind(members: list[tuple[int, bytes, int]]) -> str:
    """'rgb' | 'temporal' | 'unknown' from the member type tags (index
    members describe their predecessor and don't affect the kind)."""
    types = [m[2] for m in members if m[2] != MEMBER_INDEX]
    if types == [MEMBER_RED, MEMBER_GREEN, MEMBER_BLUE]:
        return "rgb"
    if all(t == MEMBER_TEMPORAL for t in types):
        return "temporal"
    return "unknown"


def gather_ordered_bytes(local_container: bytes) -> bytes | None:
    """Gather per-host container fragments (already member-framed) to
    process 0 in process (= stream) order.

    Returns the concatenated container on process 0, None elsewhere.  Uses
    two all-gathers (lengths, then padded payload) — the standard
    variable-length gather across hosts.
    """
    import jax

    if jax.process_count() == 1:
        return local_container
    from jax.experimental import multihost_utils

    lengths = multihost_utils.process_allgather(
        np.array([len(local_container)], np.int64)
    ).reshape(-1)
    cap = int(lengths.max())
    padded = np.zeros(cap, np.uint8)
    padded[: len(local_container)] = np.frombuffer(local_container, np.uint8)
    gathered = multihost_utils.process_allgather(padded)
    if jax.process_index() != 0:
        return None
    return b"".join(
        gathered[p, : int(lengths[p])].tobytes()
        for p in range(jax.process_count())
    )


def encode_multihost(
    local_frames: np.ndarray,
    width: int,
    height: int,
    total_frames: int,
    mesh,
    cfg: CodecConfig | None = None,
    index: bool = False,
    turbo: bool = False,
) -> bytes | None:
    """Encode a video whose frames are distributed across host processes.

    ``local_frames`` is this host's span (see host_frame_span).  Every host
    encodes its GOPs on its addressable devices of ``mesh`` via the sharded
    encoder; the compressed chunks are gathered in order to process 0.

    Stream format: each host emits a complete zlib member for its span;
    process 0 receives the in-order container (see MEMBER_MAGIC).  A single
    cross-host zlib/bit stream would serialize hosts on the DEFLATE and
    Exp-Golomb carry state — the container is the deliberate extension point
    over the (single-process) reference format.
    """
    return gather_ordered_bytes(
        encode_local_members(local_frames, width, height, mesh, cfg,
                             index=index, turbo=turbo)
    )


def encode_local_members(
    local_frames: np.ndarray,
    width: int,
    height: int,
    mesh,
    cfg: CodecConfig | None = None,
    index: bool = False,
    turbo: bool = False,
) -> bytes:
    """This host's member-framed container fragment for its frame span —
    the per-host half of encode_multihost (pure local compute, no
    cross-host traffic).
    Exposed so measurement/simulation tools can separate local encode cost
    from the ordered gather."""
    from ..codec.encoder import StreamingEncoder
    from .sharding import ShardedEncoder

    cfg = cfg or CodecConfig()
    step = cfg.gop_size * mesh.shape["gop"]
    t_all = local_frames.shape[0] - local_frames.shape[0] % cfg.gop_size
    t_main = t_all - t_all % step
    if turbo:
        # Turbo encoders emit complete per-GOP members already; the global
        # container is just the in-order concatenation across hosts.
        from ..codec.turbo import TurboEncoder, TurboShardedEncoder

        members = b""
        if t_main:
            tse = TurboShardedEncoder(width, height, mesh, cfg)
            members += b"".join(
                tse.push(local_frames[i : i + step])
                for i in range(0, t_main, step)
            ) + tse.finish()
        if t_all > t_main:
            te = TurboEncoder(width, height, cfg)
            members += te.push(local_frames[t_main:t_all]) + te.finish()
        return members
    members = b""
    if t_main:
        enc = ShardedEncoder(width, height, mesh, cfg)
        chunks = [
            enc.push(local_frames[i : i + step]) for i in range(0, t_main, step)
        ]
        chunks.append(enc.finish())
        members += _member(b"".join(chunks), t_main)
        if index:
            members += make_index_member(enc.gop_bit_ends)
    if t_all > t_main:
        # Tail GOPs that don't fill the gop mesh axis: their own member,
        # encoded on this host's default device (a host span is balanced to
        # one GOP, so the tail is at most mesh.gop - 1 GOPs).
        tenc = StreamingEncoder(width, height, cfg)
        tail = (tenc.push(local_frames[t_main:t_all]) + tenc.finish())
        members += _member(tail, t_all - t_main)
        if index:
            members += make_index_member(tenc.gop_bit_ends)
    return members


def _temporal_streams(
    members: list[tuple[int, bytes, int]],
) -> list[tuple[int, bytes, "IndexInfo"]]:
    """Temporal stream members with their index members attached
    (IndexInfo: bit ends + v2 parallel-inflate sync offsets, either None).

    Rejects containers that ALSO carry other frame-bearing member types
    (turbo, RGB channels): silently decoding just the temporal subset
    would return a wrong, shorter video — mixed turbo containers (per-GOP
    fallback, codec/turbo.FALLBACK_EXC_FRAC) must go through the turbo
    route, which reads both types."""
    foreign = {m[2] for m in members} - {MEMBER_TEMPORAL, MEMBER_INDEX}
    if foreign:
        raise ValueError(
            f"container carries non-temporal member types {sorted(foreign)};"
            " decode it through its own route (decode_turbo_container / "
            "decode_rgb_video / decode_auto)"
        )
    streams: list[tuple[int, bytes, IndexInfo]] = []
    for frames, payload, mtype in members:
        if mtype == MEMBER_INDEX and streams:
            f, p, _ = streams[-1]
            streams[-1] = (f, p, IndexInfo(
                parse_index(payload), parse_index_syncs(payload)
            ))
        elif mtype == MEMBER_TEMPORAL:
            streams.append((frames, payload, IndexInfo(None, None)))
    if not streams:
        raise ValueError(
            f"container has no decodable stream members "
            f"(member type tags: {[m[2] for m in members]})"
        )
    return streams


def decode_container_range(
    data: bytes,
    width: int,
    height: int,
    start: int,
    stop: int,
    cfg: CodecConfig | None = None,
) -> np.ndarray:
    """Random-access decode of frames [start, stop) from a temporal
    container (single- or multi-stream, with or without index members).

    Each covering stream member decodes only its local sub-range
    (codec.decoder.decode_frame_range — scan-free when the member carries
    an index); members wholly before/after the range are never touched.
    Pixels are identical to the same slice of decode_multihost_container.
    """
    from ..codec.decoder import decode_frame_range
    from ..codec.transform import TransformContext

    cfg = cfg or CodecConfig()
    if not (0 <= start < stop):
        raise ValueError(f"bad frame range [{start}, {stop})")
    streams = _temporal_streams(split_members(data))
    total = sum(f for f, _, _ in streams)
    if stop > total:
        raise EOFError(
            f"container holds {total} frames, range [{start}, {stop}) "
            "reaches past the end"
        )
    ctx = TransformContext(cfg)
    parts: list[np.ndarray] = []
    a0 = 0
    for frames, payload, idx in streams:
        lo, hi = max(start, a0), min(stop, a0 + frames)
        if lo < hi:
            positions = None
            if idx.ends is not None:
                positions = gop_positions(
                    idx.ends, frames // cfg.gop_size, cfg.gop_size, frames
                )
            parts.append(decode_frame_range(
                payload, width, height, lo - a0, hi - a0, cfg, ctx,
                positions=positions, sync_offsets=idx.syncs,
            ))
        a0 += frames
        if a0 >= stop:
            break
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def decode_multihost_container(
    data: bytes,
    width: int,
    height: int,
    cfg: CodecConfig | None = None,
    workers: int | None = None,
) -> np.ndarray:
    """Decode a multi-host container back to (T, H, W) frames (any host).

    Members are self-contained, so they decode IN PARALLEL across host
    threads (the serial entropy stage releases the GIL in C, zlib releases
    it too, and device dispatches interleave safely) — the container doubles
    as a parallel-decode index, something the headerless reference stream
    fundamentally cannot offer.
    """
    import os
    from concurrent.futures import ThreadPoolExecutor

    from ..codec.decoder import decode_video
    from ..codec.transform import TransformContext

    cfg = cfg or CodecConfig()
    members = split_members(data)
    if container_kind(members) == "rgb":
        raise ValueError(
            "this container carries RGB channel members; decode it with "
            "codec.rgb_codec.decode_rgb_video (CLI: decode --rgb)"
        )
    # Attach each index member to the stream member it describes (the one
    # preceding it); streams without one decode via the serial-scan path.
    streams = _temporal_streams(members)

    def _one(m: tuple[int, bytes, "IndexInfo"]) -> np.ndarray:
        frames, payload, idx = m
        positions = None
        if idx.ends is not None:
            positions = gop_positions(
                idx.ends, frames // cfg.gop_size, cfg.gop_size, frames
            )
        return decode_video(payload, width, height, frames, cfg, ctx,
                            positions=positions, sync_offsets=idx.syncs)

    ctx = TransformContext(cfg)  # shared constant matrices
    if len(streams) == 1:
        return _one(streams[0])
    with ThreadPoolExecutor(
        workers or min(len(streams), os.cpu_count() or 2)
    ) as pool:
        parts = list(pool.map(_one, streams))
    return np.concatenate(parts)
