#!/usr/bin/env python
"""Headline benchmark: end-to-end encode frames/s at 1080p grayscale, 1 chip.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

vs_baseline is measured, not assumed: benchmarks/ref_baseline.c implements the
reference's algorithm (brute-force O(N^2)-per-cube 3D DCT on all CPU cores +
serial Exp-Golomb + one-shot zlib-9, i.e. the Java encoder's structure in
C -O3 — a *favorable* stand-in, so the reported ratio is an underestimate of
the true vs-Java speedup).  The baseline is timed on a scaled-down frame
(identical per-pixel work, the algorithm is embarrassingly parallel per cube)
and cached in benchmarks/_build/baseline.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "benchmarks", "_build")
W, H = 1920, 1080
BASE_W, BASE_H, BASE_T = 480, 272, 8  # baseline probe geometry (scaled up)


def measure_baseline() -> float:
    """Reference-algorithm encoder sec/frame at 1080p on this host (cached)."""
    cache = os.path.join(BUILD, "baseline.json")
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)["sec_per_frame_1080p"]
    os.makedirs(BUILD, exist_ok=True)
    exe = os.path.join(BUILD, "ref_baseline")
    src = os.path.join(ROOT, "benchmarks", "ref_baseline.c")
    subprocess.run(
        ["cc", "-O3", "-o", exe, src, "-lm", "-lz", "-lpthread"], check=True
    )
    ncpu = os.cpu_count() or 1
    out = subprocess.run(
        [exe, str(BASE_W), str(BASE_H), str(BASE_T), str(ncpu)],
        check=True, capture_output=True, text=True, timeout=1800,
    )
    probe = json.loads(out.stdout)
    spf = probe["sec_per_frame"] * (W * H) / (BASE_W * BASE_H)
    with open(cache, "w") as f:
        json.dump({"sec_per_frame_1080p": spf, "probe": probe}, f)
    return spf


def synthetic_clip(t: int, h: int, w: int) -> np.ndarray:
    """Moving gradient + noise, mirroring the baseline's content mix."""
    rng = np.random.default_rng(12345)
    x = np.arange(w, dtype=np.uint32)
    y = np.arange(h, dtype=np.uint32)[:, None]
    frames = np.empty((t, h, w), np.uint8)
    for k in range(t):
        frames[k] = ((x[None, :] + y + k) & 0xFF).astype(np.uint8)
    noise = (rng.integers(0, 16, size=frames.shape, dtype=np.uint8)).astype(np.uint8)
    return frames ^ noise


def bench_encode(frames: np.ndarray, reps: int = 4) -> dict:
    from dct3d_tpu.codec.encoder import StreamingEncoder
    from dct3d_tpu.codec.decoder import decode_video
    from dct3d_tpu.codec.transform import TransformContext
    from dct3d_tpu.config import CodecConfig
    from dct3d_tpu import metrics

    t, h, w = frames.shape
    cfg = CodecConfig(deflate_workers=-1, pack_bits_per_value=4)
    ctx = TransformContext(cfg)

    gop_bit_ends: list[int] = []
    gop_syncs: list = [None]

    def run_encode() -> bytes:
        enc = StreamingEncoder(w, h, cfg, ctx)
        chunks = []
        for i in range(0, t, cfg.gop_size):
            chunks.append(enc.push(frames[i : i + cfg.gop_size]))
        chunks.append(enc.finish())
        gop_bit_ends[:] = enc.gop_bit_ends
        gop_syncs[0] = enc.gop_sync_offsets
        return b"".join(chunks)

    data = run_encode()  # warmup (compile)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run_encode()
        best = min(best, time.perf_counter() - t0)
    enc_fps = t / best

    # Compute-only throughput (input resident on device).
    import jax
    import jax.numpy as jnp
    from dct3d_tpu.codec.transform import encode_step

    fj = jnp.asarray(frames[: cfg.gop_size])
    mb = ctx.max_packed_bytes(fj.size)

    def chain(steps: int) -> float:
        # Back-to-back dispatch with the carry chained ON DEVICE — exactly
        # how StreamingEncoder pipelines GOPs — then one tiny fetch to force
        # completion.
        carry = (jnp.uint32(0), jnp.int32(0))
        g = None
        t0 = time.perf_counter()
        for _ in range(steps):
            g = encode_step(fj, ctx.enc_t, carry[0], carry[1],
                            max_bytes=mb, cfg=cfg)
            carry = (g.carry_code, g.carry_bits)
        int(g.total_bits)
        return time.perf_counter() - t0

    chain(1)  # warmup (compile)
    compute_fps = max(
        8 * cfg.gop_size / (chain(10) - chain(2)) for _ in range(3)
    )

    # Device throughput without dispatch cost: K carry-chained steps inside
    # ONE program (production semantics — GOPs chain through the carry),
    # with the packed buffer forced live via a data-dependent element so
    # XLA cannot dead-code the pack pipeline.
    def make_inprog(k: int):
        @jax.jit
        def f(frames):
            def body(i, acc):
                g = encode_step(frames, ctx.enc_t, acc[0], acc[1],
                                max_bytes=mb, cfg=cfg)
                live = g.packed[
                    (g.total_bits % jnp.int32(g.packed.shape[0]))
                ].astype(jnp.uint32)
                return (g.carry_code ^ live, g.carry_bits)

            c = jax.lax.fori_loop(
                0, k, body, (jnp.uint32(0), jnp.int32(0)))
            return c[0] + c[1].astype(jnp.uint32)

        return f

    def run_prog(f) -> float:
        jax.device_get(f(fj))  # warmup
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.device_get(f(fj))
            best = min(best, time.perf_counter() - t0)
        return best

    f2, f10 = make_inprog(2), make_inprog(10)
    compute_device_fps = 8 * cfg.gop_size / (run_prog(f10) - run_prog(f2))

    # Turbo (planar) profile: compute slope of its encode step (no bit-pack
    # stage) + its rate.  Uses the same device-resident input chain trick.
    from dct3d_tpu.codec.turbo import TurboEncoder, encode_step_turbo
    from dct3d_tpu.ops.exceptions import DEFAULT_SLOTS

    def tchain(steps: int) -> float:
        r = None
        t0 = time.perf_counter()
        for _ in range(steps):
            r = encode_step_turbo(fj, ctx.enc_t_pair, cfg=cfg,
                                  slots=DEFAULT_SLOTS, wire=True)
        jax.device_get(r[-2][:1])  # counts: forces the whole step
        return time.perf_counter() - t0

    tchain(1)
    turbo_compute_fps = max(
        8 * cfg.gop_size / (tchain(10) - tchain(2)) for _ in range(3)
    )
    tenc = TurboEncoder(w, h, cfg)
    turbo_data = tenc.push(frames) + tenc.finish()
    turbo_bpp = metrics.bits_per_pixel(len(turbo_data), w, h, t)

    # Turbo host drain stages, per GOP per core (they fan out across the
    # drain pool).
    from dct3d_tpu.codec.turbo import (
        MEMBER_TURBO, _member_payload, _parse_payload,
    )
    from dct3d_tpu.parallel.multihost import split_members

    m0 = [m for m in split_members(turbo_data) if m[2] == MEMBER_TURBO][0]
    # split_dc=True is the production parse (codec/turbo._decode_members):
    # the measured operands ARE the production ones.
    wire_plane, dc_real, idx_real, val_real = _parse_payload(
        m0[1], cfg.cube_size, True, True
    )
    t0 = time.perf_counter()
    for _ in range(3):
        _parse_payload(m0[1], cfg.cube_size, True, True)
    turbo_parse_fps = 3 * cfg.gop_size / (time.perf_counter() - t0)
    # Rebuild the member from the real parsed streams so the build figure
    # carries real compression + argsort work.
    t0 = time.perf_counter()
    for _ in range(3):
        _member_payload(wire_plane, dc_real, idx_real, val_real, cfg,
                        wire=True)
    turbo_member_build_fps = 3 * cfg.gop_size / (time.perf_counter() - t0)

    video = decode_video(data, w, h, t, cfg, ctx)  # warmup
    t0 = time.perf_counter()
    video = decode_video(data, w, h, t, cfg, ctx)
    dec_fps = t / (time.perf_counter() - t0)

    # Turbo-container e2e decode: same wire, but the host stage is pure
    # decompression (no Exp-Golomb walk), so this shows what e2e decode
    # does when the entropy stage is off the critical path.
    from dct3d_tpu.codec.turbo import decode_turbo_container

    tv = decode_turbo_container(turbo_data, w, h, cfg, ctx)  # warmup
    t0 = time.perf_counter()
    tv = decode_turbo_container(turbo_data, w, h, cfg, ctx)
    turbo_dec_fps = t / (time.perf_counter() - t0)
    assert np.array_equal(tv, video), "turbo decode diverged from reference"

    # Decode compute (device-resident planes -> frames), slope-based like
    # compute_fps: back-to-back async dispatches, one tiny fetch.
    import zlib

    from dct3d_tpu.codec import entropy
    from dct3d_tpu.codec.transform import decode_step_planar4

    from dct3d_tpu.codec.decoder import _pad_exceptions, _split_dc_flat

    cpg = w * h * cfg.gop_size
    payload = zlib.decompress(data)
    plane, ei, ev, _ = entropy.decode_values_planar4(payload, cpg)
    # Production flat dispatch splits the DC column out of the exception
    # list and splices it on device (_dispatch_planar4) — measure exactly
    # those operands.
    fdc, fei, fev = _split_dc_flat(plane, ei.astype(np.int64), ev,
                                   cfg.cube_size)
    exc_idx, exc_val = _pad_exceptions(plane.size * 2, fei, fev)
    pd, pi, pv = jnp.asarray(plane), jnp.asarray(exc_idx), jnp.asarray(exc_val)
    pdc = jnp.asarray(fdc)

    def dchain(steps: int) -> float:
        fd = None
        t0 = time.perf_counter()
        for _ in range(steps):
            fd = decode_step_planar4(pd, pi, pv, ctx.dec_me, ctx.dec_mo,
                                     cfg=cfg, height=h, width=w, dc=pdc)
        jax.device_get(fd[0, 0, 0])
        return time.perf_counter() - t0

    dchain(1)
    decode_compute_fps = max(
        8 * cfg.gop_size / (dchain(10) - dchain(2)) for _ in range(3)
    )

    # Serialized in-program decode step (fori_loop with a data-dependent
    # carry xor): independent dispatches overlap on device, so the train
    # above mixes pipelining with stage cost — this one cannot (the decode
    # analogue of compute_device_fps).
    def make_dec_inprog(k: int):
        @jax.jit
        def f(p):
            def body(i, carry):
                fd = decode_step_planar4(
                    p ^ (carry & 1).astype(jnp.uint8), pi, pv,
                    ctx.dec_me, ctx.dec_mo, cfg=cfg, height=h, width=w,
                    dc=pdc,
                )
                return fd[0, 0, 0].astype(jnp.int32)

            return jax.lax.fori_loop(0, k, body, jnp.int32(0))

        return f

    def run_dec_prog(f) -> float:
        jax.device_get(f(pd))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.device_get(f(pd))
            best = min(best, time.perf_counter() - t0)
        return best

    d2, d10 = make_dec_inprog(2), make_dec_inprog(10)
    decode_compute_device_fps = 8 * cfg.gop_size / (
        run_dec_prog(d10) - run_dec_prog(d2)
    )

    # Turbo decode device step (wire member -> frames), same methodology,
    # reusing the first turbo member's production split-DC parse above.
    from dct3d_tpu.codec.transform import decode_step_planar4

    tdc = np.asarray(dc_real, np.int32)
    tei, tev = _pad_exceptions(
        np.asarray(wire_plane).size * 2,
        np.asarray(idx_real, np.int32),
        np.asarray(val_real, np.int32),
    )
    tp, tpi, tpv = jnp.asarray(np.asarray(wire_plane)), jnp.asarray(tei), \
        jnp.asarray(tev)
    tdcj = jnp.asarray(tdc)

    def tdchain(steps: int) -> float:
        fd = None
        t0 = time.perf_counter()
        for _ in range(steps):
            fd = decode_step_planar4(tp, tpi, tpv, ctx.dec_me, ctx.dec_mo,
                                     cfg=cfg, height=h, width=w, wire=True,
                                     dc=tdcj)
        jax.device_get(fd[0, 0, 0])
        return time.perf_counter() - t0

    tdchain(1)
    turbo_decode_compute_fps = max(
        8 * cfg.gop_size / (tdchain(10) - tdchain(2)) for _ in range(3)
    )

    # Host entropy stage alone: GOP-parallel scan + planar4 decode pool.
    # Warmup + best-of like every other stage here: the first pass pays
    # one-time page faults on the multi-MB plane buffers (the heap then
    # retains them — see native._tune_malloc), which is process-lifetime
    # cost, not stage throughput.
    n_gops = t // cfg.gop_size
    pay8 = np.frombuffer(payload, np.uint8)

    def entropy_pass(positions=None) -> float:
        t0 = time.perf_counter()
        for _ in entropy.parallel_chunks(
            pay8, cpg, n_gops, entropy.decode_values_planar4,
            positions=positions,
        ):
            pass
        return t / (time.perf_counter() - t0)

    entropy_pass()  # warmup
    entropy_fps = max(entropy_pass() for _ in range(3))

    # Same stage with the seekable index (encode --index): no speculative
    # scan risk at all — the production host-entropy figure.
    from dct3d_tpu.parallel.multihost import gop_positions

    positions = gop_positions(gop_bit_ends, n_gops, cfg.gop_size, t)
    entropy_indexed_fps = max(entropy_pass(positions) for _ in range(3))

    # Host inflate stage, serial vs index-v2 parallel.
    def time_best(f):
        f()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            f()
            best = min(best, time.perf_counter() - t0)
        return t / best

    inflate_fps = time_best(lambda: zlib.decompress(data))
    syncs = gop_syncs[0]
    inflate_parallel_fps = (
        time_best(lambda: entropy.parallel_inflate(data, syncs))
        if syncs else inflate_fps
    )

    return {
        "encode_fps": enc_fps,
        "decode_fps": dec_fps,
        "turbo_decode_fps": turbo_dec_fps,
        "compute_fps": compute_fps,
        "compute_device_fps": compute_device_fps,
        "decode_compute_fps": decode_compute_fps,
        "decode_compute_device_fps": decode_compute_device_fps,
        "decode_entropy_fps": entropy_fps,
        "decode_entropy_indexed_fps": entropy_indexed_fps,
        "decode_inflate_fps": inflate_fps,
        "decode_inflate_parallel_fps": inflate_parallel_fps,
        "turbo_compute_fps": turbo_compute_fps,
        "turbo_decode_compute_fps": turbo_decode_compute_fps,
        "turbo_parse_fps": turbo_parse_fps,
        "turbo_member_build_fps": turbo_member_build_fps,
        "turbo_bpp": turbo_bpp,
        "bpp": metrics.bits_per_pixel(len(data), w, h, t),
        "psnr_db": metrics.psnr(frames, video),
        "bytes": len(data),
    }


def main() -> int:
    import jax

    from dct3d_tpu.utils import enable_compilation_cache

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"bench.py measures a GPU; JAX's backend is {platform!r}",
              file=sys.stderr)
        return 1
    enable_compilation_cache()
    t = int(os.environ.get("BENCH_FRAMES", "64"))
    base_spf = measure_baseline()
    frames = synthetic_clip(t, H, W)
    r = bench_encode(frames)
    result = {
        "metric": "encode_fps_1080p_gray",
        "value": round(r["encode_fps"], 2),
        "unit": "frames/s/chip",
        "vs_baseline": round(r["encode_fps"] * base_spf, 2),
        "detail": {
            "decode_fps": round(r["decode_fps"], 2),
            "turbo_decode_fps": round(r["turbo_decode_fps"], 2),
            "compute_fps": round(r["compute_fps"], 2),
            "compute_device_fps": round(r["compute_device_fps"], 2),
            "decode_compute_fps": round(r["decode_compute_fps"], 2),
            "decode_compute_device_fps": round(
                r["decode_compute_device_fps"], 2
            ),
            "decode_entropy_fps": round(r["decode_entropy_fps"], 2),
            "decode_entropy_indexed_fps": round(
                r["decode_entropy_indexed_fps"], 2
            ),
            "decode_inflate_fps": round(r["decode_inflate_fps"], 2),
            "decode_inflate_parallel_fps": round(
                r["decode_inflate_parallel_fps"], 2
            ),
            "turbo_compute_fps": round(r["turbo_compute_fps"], 2),
            "turbo_decode_compute_fps": round(
                r["turbo_decode_compute_fps"], 2
            ),
            "turbo_parse_fps": round(r["turbo_parse_fps"], 2),
            "turbo_member_build_fps": round(
                r["turbo_member_build_fps"], 2
            ),
            "turbo_bpp": round(r["turbo_bpp"], 4),
            "compute_vs_baseline": round(r["compute_fps"] * base_spf, 2),
            "bpp": round(r["bpp"], 4),
            "psnr_db": round(r["psnr_db"], 2),
            "baseline_fps": round(1.0 / base_spf, 3),
            "frames": t,
            "backend": _backend(),
        },
    }
    print(json.dumps(result))
    return 0


def _backend() -> str:
    import jax

    d = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return f"{d.platform}:{d.device_kind}x{jax.device_count()} ({smi})"


if __name__ == "__main__":
    sys.exit(main())
