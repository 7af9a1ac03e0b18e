#!/usr/bin/env python
"""Bring-up check of the codec on a GPU, through the entry points a user calls.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the mesh phase only

Phases, in order (one card):

  device     card name and power limit, JAX platform and version, compile
             cache, native entropy library, turbo payload codec
  gpu-tests  the tests marked `gpu`, in a child pytest, before this process
             opens the card
  kernels    every device kernel of the encode/decode path against its plain
             reference at one 1080p GOP
  parity     three seeded 1920x1080 clips (gradient + noise, uniform noise,
             blocky screen content): quantize_step vs the float64 oracle's
             coefficients, `encode --parity` vs oracle.encode byte for byte,
             decode vs oracle.decode within 1 LSB
  main-path  cli.main capture / encode / decode / psnr / encode --turbo /
             decode at 1920x1080 x 64 frames

A phase that fails ends the run with a non-zero exit and no result line.
The last line of a passing run is the JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Scratch files live in .smoke_work/ at the checkout root and are removed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")
W, H = 1920, 1080
PARITY_FRAMES = 16  # two GOPs
MAIN_FRAMES = 64
UHD_W, UHD_H = 3840, 2160  # four-card tile split: 270 block rows over 2
CONTENTS = ("gradient_noise", "uniform_noise", "blocks")
SEED = 7


class PhaseFailed(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def clip(kind: str, t: int, h: int | None = None, w: int | None = None,
         seed: int = SEED):
    """The seeded test contents (H x W unless given)."""
    h, w = h or H, w or W
    if kind == "gradient_noise":
        import bench

        return bench.synthetic_clip(t, h, w)
    if kind == "uniform_noise":
        return np.random.default_rng(seed).integers(
            0, 256, (t, h, w), dtype=np.uint8)
    if kind == "blocks":
        from dct3d_tpu.io import synthetic

        return synthetic.moving_blocks(t, h, w, seed=seed)
    raise ValueError(kind)


def _oracle_worker_init() -> None:
    # The oracle is NumPy only; keep its worker processes off the card.
    os.environ["JAX_PLATFORMS"] = "cpu"


def _oracle_job(kind: str):
    """oracle.encode and oracle.decode of one parity clip (worker)."""
    from dct3d_tpu import oracle

    frames = clip(kind, PARITY_FRAMES)
    data = oracle.encode(frames)
    return data, oracle.decode(data, W, H, PARITY_FRAMES)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        raise PhaseFailed(f"nvidia-smi failed: {e}") from e
    check(out, "nvidia-smi printed nothing")
    return out.splitlines()[0]


def _probe_platform() -> tuple[str, str]:
    """(platform, device_kind) from a short child that reserves no memory,
    so this process can still leave the card to the test child."""
    env = dict(os.environ, XLA_PYTHON_CLIENT_PREALLOCATE="false")
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; d = jax.devices()[0]; print(d.platform); "
         "print(d.device_kind)"],
        capture_output=True, text=True, timeout=300, env=env,
    )
    check(r.returncode == 0, f"JAX found no backend: {r.stderr[-2000:]}")
    platform, kind = r.stdout.strip().splitlines()[-2:]
    return platform, kind


def phase_device() -> str:
    import jax

    from dct3d_tpu import native
    from dct3d_tpu.codec import turbo
    from dct3d_tpu.utils import enable_compilation_cache

    platform, kind = _probe_platform()
    check(platform == "gpu", f"JAX platform is {platform!r}, not 'gpu'")
    smi = nvidia_smi()
    say(smi)
    say("device_kind:", kind)
    say("jax:", jax.__version__)
    say("compile cache:", enable_compilation_cache())
    check(native.load() is not None,
          "native entropy library did not build (dct3d_tpu/native)")
    say("native entropy library: built")
    say("turbo payload codec:",
        "zstd" if turbo._zstd is not None else "zlib (zstandard absent)")
    return smi


def phase_gpu_tests() -> None:
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-rs",
         "-p", "no:cacheprovider", os.path.join(ROOT, "tests")],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    say("gpu tests:", tail)
    check(r.returncode == 0, "gpu tests failed:\n" + r.stdout[-4000:]
          + r.stderr[-2000:])
    check("passed" in tail and "skipped" not in tail,
          f"gpu tests did not all run: {tail}")


def _assert_equal(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape,
          f"{what}: shape {got.shape} != {want.shape}")
    bad = np.flatnonzero(got.reshape(-1) != want.reshape(-1))
    check(bad.size == 0, f"{what}: {bad.size} elements differ, first at "
          f"{bad[:8].tolist()}")


def phase_kernels() -> None:
    """Each device form against its NumPy reference at one 1080p GOP."""
    import jax
    import jax.numpy as jnp

    from dct3d_tpu.codec import framing, transform
    from dct3d_tpu.config import CodecConfig
    from dct3d_tpu.ops import bitpack, exceptions, expgolomb, relayout

    cfg = CodecConfig()
    ctx = transform.TransformContext(cfg)
    gop = clip("gradient_noise", cfg.gop_size)
    fj = jnp.asarray(gop)
    q = transform.quantize_step(fj, ctx.enc_t, cfg=cfg)
    vals = np.asarray(q).reshape(-1)
    # The packers vs the NumPy twin: pack_values at the budget width and at
    # the worst-case width, pack_bits on the same GOP.
    w_words = bitpack.budget_w_words(256, cfg.pack_bits_per_value)
    max_width = bitpack.max_codeword_bits(cfg.cube_size)
    for name, values, ww in (
        ("pack_values budget", vals, w_words),
        ("pack_values worst case",
         np.random.default_rng(SEED).integers(
             -5771, 5772, vals.size).astype(np.int32), None),
    ):
        c_np, w_np = expgolomb.codewords_np(values)
        ob = (int(w_np.sum()) + 7) // 8 + 64
        ref, ref_bits = bitpack.pack_bits_np(c_np, w_np, ob)
        got, bits, tail, ovf = jax.jit(
            lambda v, ob=ob, ww=ww: bitpack.pack_values(
                v, jnp.uint32(0), jnp.int32(0), ob, max_width=max_width,
                w_words=ww)
        )(jnp.asarray(values))
        check(not bool(ovf) and int(bits) == ref_bits,
              f"{name}: bits {int(bits)} vs {ref_bits}, overflow {bool(ovf)}")
        _assert_equal(got, ref, f"{name} bytes")
        check(int(tail) == int(ref[(ref_bits - 1) // 8]), f"{name} tail")
        if ww is not None:
            got2, bits2, _, _ = jax.jit(
                lambda c, w, ob=ob: bitpack.pack_bits(
                    c, w, ob, max_width=max_width)
            )(jnp.asarray(c_np), jnp.asarray(w_np.astype(np.int32)))
            check(int(bits2) == ref_bits, "pack_bits bit count")
            _assert_equal(got2, ref, "pack_bits bytes")
    say(f"kernels: bit packers == NumPy twin ({vals.size} values, "
        f"w_words {w_words} and worst case)")

    # Turbo exception compaction (einsum) vs the NumPy reference.
    qp = transform._frames_to_q(fj, ctx.enc_t_pair, cfg).reshape(-1)
    lidx, ev, counts, ovf = exceptions.compact_exceptions(
        qp, slots=exceptions.DEFAULT_SLOTS, dc_stride=cfg.cube_size)
    check(not bool(ovf), "exception tables overflowed on the bench GOP")
    idx, val = exceptions.expand_exceptions_np(
        np.asarray(lidx), np.asarray(ev), np.asarray(counts))
    qn = np.asarray(qp)
    mask = (qn < -8) | (qn > 7)
    mask[:: cfg.cube_size] = False
    _assert_equal(idx, np.flatnonzero(mask), "exception indices")
    _assert_equal(val, qn[mask], "exception values")

    # Word-transpose relayouts vs plain NumPy byte moves.
    plane = np.asarray(jnp.asarray(qn.reshape(-1, 256)).astype(jnp.uint8))
    _assert_equal(relayout.plane_to_wire(jnp.asarray(plane)), plane.T,
                  "plane_to_wire")
    cubes = np.asarray(framing.frames_to_cubes(fj, cfg))
    frames = relayout.cubes_perm_to_frames(
        jnp.asarray(cubes[:, relayout.inv_sigma()]), height=H, width=W)
    _assert_equal(frames, gop, "cubes_perm_to_frames")
    say(f"kernels: exception compaction ({idx.size} exceptions) and "
        "relayouts == NumPy")


def _run_cli(argv: list[str]) -> tuple[float, str]:
    from dct3d_tpu import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli {' '.join(argv[:1])} exited {rc}: {out.getvalue()}")
    return dt, out.getvalue()


def phase_parity(oracle_futs) -> None:
    import jax.numpy as jnp

    from dct3d_tpu import oracle
    from dct3d_tpu.codec import transform
    from dct3d_tpu.config import CodecConfig
    from dct3d_tpu.io import rawvideo

    cfg = CodecConfig()
    ctx = transform.TransformContext(cfg)
    # Column 0 (DC) is quantized exactly (quant.exact_dc_quant).
    tol = np.asarray(transform._tie_tolerance(np.asarray(ctx.enc_t),
                                              cfg.cube_size))[1:]
    say(f"parity: device tie snap within {tol.min():.3g}..{tol.max():.3g} "
        "of a rounding boundary (AC)")
    for kind in CONTENTS:
        frames = clip(kind, PARITY_FRAMES)
        stats = {}
        want = oracle.quantized_coefficients(frames, cfg, stats)
        got = np.asarray(transform.quantize_step(
            jnp.asarray(frames), ctx.enc_t, cfg=cfg))
        bad = np.argwhere(got != want)
        say(f"parity {kind}: oracle decided {stats['checked']} values "
            f"within 1e-7 of a boundary exactly: {stats.get('ties', 0)} "
            f"exact ties, closest non-tie {stats.get('closest', 'none')}")
        check(bad.size == 0,
              f"{kind}: {len(bad)} quantized coefficients differ from the "
              f"oracle, zigzag indices {sorted(set(bad[:, 1].tolist()))}")
        src = os.path.join(WORK, f"{kind}.raw")
        enc = os.path.join(WORK, f"{kind}.bin")
        dec = os.path.join(WORK, f"{kind}.dec")
        rawvideo.write_video(src, frames)
        _run_cli(["encode", src, enc, str(W), str(H), "--parity"])
        _run_cli(["decode", enc, dec, str(W), str(H), str(PARITY_FRAMES)])
        ref_bytes, ref_dec = oracle_futs[kind].result()
        with open(enc, "rb") as f:
            check(f.read() == ref_bytes,
                  f"{kind}: encode --parity bytes differ from oracle.encode")
        out = rawvideo.read_video(dec, W, H)
        check(out.shape == ref_dec.shape, f"{kind}: decoded {out.shape}")
        diff = np.abs(out.astype(np.int32) - ref_dec.astype(np.int32))
        rate = float((diff > 0).mean())
        check(diff.max() <= 1 and rate < 0.01,
              f"{kind}: decode vs oracle max |diff| {diff.max()}, "
              f"mismatch rate {rate}")
        say(f"parity {kind}: 0 of {want.size} coefficients flipped; "
            f"--parity bytes == oracle.encode ({len(ref_bytes)} B); decode "
            f"max |diff| {diff.max()}, mismatch rate {rate:.2e}")


def phase_main_path(smi: str) -> None:
    from dct3d_tpu import metrics
    from dct3d_tpu.io import rawvideo

    p = {k: os.path.join(WORK, k) for k in
         ("src.raw", "enc.d3m", "dec.raw", "enc.d3t", "dect.raw")}
    geo = [str(W), str(H)]
    _run_cli(["capture", p["src.raw"], *geo, str(MAIN_FRAMES)])
    t_enc = [_run_cli(["encode", p["src.raw"], p["enc.d3m"], *geo])[0]
             for _ in range(2)]
    t_dec = [_run_cli(["decode", p["enc.d3m"], p["dec.raw"], *geo])[0]
             for _ in range(2)]
    _, psnr_out = _run_cli(["psnr", p["src.raw"], p["dec.raw"], *geo])
    say("main-path:", psnr_out.strip())
    src = rawvideo.read_video(p["src.raw"], W, H)
    dec = rawvideo.read_video(p["dec.raw"], W, H)
    check(dec.shape == src.shape, f"decoded {dec.shape} != {src.shape}")
    db = metrics.psnr(src, dec)
    check(np.isfinite(db) and db > 30.0, f"PSNR {db} dB")
    t_tenc = [_run_cli(["encode", p["src.raw"], p["enc.d3t"], *geo,
                        "--turbo"])[0] for _ in range(2)]
    t_tdec = [_run_cli(["decode", p["enc.d3t"], p["dect.raw"], *geo])[0]
              for _ in range(2)]
    tdec = rawvideo.read_video(p["dect.raw"], W, H)
    _assert_equal(tdec, dec, "turbo decode vs reference-profile decode")
    say("main-path: turbo decode pixel-identical to reference-profile "
        "decode")
    rates = ", ".join(
        f"{name} {MAIN_FRAMES / t[1]:.1f} fps (first call "
        f"{MAIN_FRAMES / t[0]:.1f})"
        for name, t in (("encode", t_enc), ("decode", t_dec),
                        ("turbo encode", t_tenc), ("turbo decode", t_tdec)))
    say(f"info: {W}x{H} x {MAIN_FRAMES} frames, {rates}; card {smi}")


def phase_four_cards(smi: str) -> None:
    """The (gop, tile) mesh over four cards against one card."""
    import jax

    from dct3d_tpu.codec.decoder import decode_video
    from dct3d_tpu.codec.encoder import encode_video
    from dct3d_tpu.codec.turbo import (
        TurboShardedDecoder, TurboShardedEncoder, decode_turbo_container,
        encode_turbo_video,
    )
    from dct3d_tpu.config import CodecConfig
    from dct3d_tpu.io import rawvideo
    from dct3d_tpu.parallel.mesh import make_mesh
    from dct3d_tpu.parallel.sharding import ShardedDecoder, ShardedEncoder

    devs = jax.devices()
    check(len(devs) >= 4, f"--four-cards needs 4 devices, found {len(devs)}")
    cfg = CodecConfig()
    src = os.path.join(WORK, "mesh.raw")
    rawvideo.write_video(src, clip("gradient_noise", 32))
    one, four = os.path.join(WORK, "one.d3m"), os.path.join(WORK, "four.d3m")
    _run_cli(["encode", src, one, str(W), str(H), "--parity"])
    _run_cli(["encode", src, four, str(W), str(H), "--parity",
              "--mesh", "4x1"])
    with open(one, "rb") as a, open(four, "rb") as b:
        check(a.read() == b.read(), "encode --mesh 4x1 bytes differ from "
              "the single-card encode")
    say("four-cards: cli encode --parity --mesh 4x1 at 1920x1080 == single "
        "card")

    uw, uh = UHD_W, UHD_H
    uhd = clip("gradient_noise", 16, uh, uw)
    mesh = make_mesh(gop=2, tile=2, devices=devs[:4])
    ref = encode_video(uhd, cfg)
    enc = ShardedEncoder(uw, uh, mesh, cfg)
    got = enc.push(uhd) + enc.finish()
    check(got == ref, "ShardedEncoder 2x2 bytes differ from single card")
    ref_dec = decode_video(ref, uw, uh, 16, cfg)
    _assert_equal(ShardedDecoder(uw, uh, mesh, cfg).decode(got, 16),
                  ref_dec, "ShardedDecoder 2x2 vs single card")
    say("four-cards: ShardedEncoder/ShardedDecoder 2x2 at 3840x2160 == "
        "single card")

    tref = encode_turbo_video(uhd, cfg)
    tenc = TurboShardedEncoder(uw, uh, mesh, cfg)
    tgot = tenc.push(uhd) + tenc.finish()
    check(tgot == tref, "TurboShardedEncoder 2x2 bytes differ from single "
          "card")
    tdec = TurboShardedDecoder(uw, uh, mesh, cfg).decode(tgot)
    _assert_equal(tdec, decode_turbo_container(tref, uw, uh, cfg),
                  "TurboShardedDecoder 2x2 vs single card")
    _assert_equal(tdec, ref_dec, "sharded turbo decode vs reference profile")
    say("four-cards: TurboShardedEncoder/TurboShardedDecoder 2x2 at "
        "3840x2160 == single card")

    # Each card must have held its share of the 4K batch, not just card 0.
    shard = uhd.nbytes // 4
    peaks = [d.memory_stats()["peak_bytes_in_use"] for d in devs[:4]]
    check(all(pk >= shard for pk in peaks),
          f"peak bytes per card {peaks} < one frame shard {shard}")
    say(f"four-cards: peak bytes per card {peaks} (card {smi})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    import dct3d_tpu  # noqa: F401  (fails fast outside a checkout)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    pool = None
    try:
        say("== device")
        smi = phase_device()
        if args.four_cards:
            import jax

            say("== four-cards")
            phase_four_cards(smi)
        else:
            # The oracle runs in worker processes meanwhile (NumPy only).
            pool = ProcessPoolExecutor(
                max_workers=len(CONTENTS), initializer=_oracle_worker_init,
                mp_context=__import__("multiprocessing").get_context("spawn"))
            oracle_futs = {k: pool.submit(_oracle_job, k) for k in CONTENTS}
            say("== gpu-tests")
            phase_gpu_tests()
            import jax

            check(jax.devices()[0].platform == "gpu", "no GPU in this process")
            say("== kernels")
            phase_kernels()
            say("== parity")
            phase_parity(oracle_futs)
            say("== main-path")
            phase_main_path(smi)
        d = jax.devices()
        result = {"ok": True, "device": {"platform": d[0].platform,
                                         "kind": d[0].device_kind,
                                         "count": len(d)}}
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
