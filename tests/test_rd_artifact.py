"""Reproducible rate-distortion artifact (benchmarks/rd_sweep.json).

Pins BASELINE.md's "turbo rides at or below the reference profile's rate
at every operating point" claim to a checked-in, regenerable artifact
instead of prose.  Regenerate with:

    python -m dct3d_tpu sweep synthetic 320 240 32 \
        --quants 1,2,5,8,12 --blocks 8,4 --turbo \
        --output benchmarks/rd_sweep.json

(The fps fields are host-dependent and not asserted; rate/quality are
content-deterministic: synthetic moving_gradient + the parity-mode
defaults make bpp/psnr reproducible bit-for-bit across hosts.)
"""

from __future__ import annotations

import json
import os

import pytest

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "rd_sweep.json")


@pytest.fixture(scope="module")
def rows():
    if not os.path.exists(ART):
        pytest.skip("benchmarks/rd_sweep.json not generated yet")
    with open(ART) as f:
        rows = json.load(f)
    assert rows, "empty artifact"
    return rows


def test_schema(rows):
    for r in rows:
        for key in ("block", "quant", "bpp", "psnr_db", "turbo_bpp"):
            assert key in r, f"artifact row missing {key}: {r}"
        assert r["bpp"] > 0 and r["turbo_bpp"] > 0
        assert 10 < r["psnr_db"] < 100


def test_rd_monotone_per_block(rows):
    """Harsher quant -> fewer bits AND lower PSNR, per block size and per
    profile (the reference exposes exactly these two knobs)."""
    blocks = sorted({r["block"] for r in rows})
    for b in blocks:
        pts = sorted((r for r in rows if r["block"] == b),
                     key=lambda r: r["quant"])
        assert len(pts) >= 2, f"block {b}: need >= 2 quant points"
        for lo, hi in zip(pts, pts[1:]):
            assert hi["bpp"] < lo["bpp"], (b, lo, hi)
            assert hi["psnr_db"] < lo["psnr_db"], (b, lo, hi)
            assert hi["turbo_bpp"] < lo["turbo_bpp"], (b, lo, hi)


def test_turbo_dominates_reference_rate(rows):
    """BASELINE.md's rate claim, mechanically, at IDENTICAL pixels (the
    turbo transparency invariant, tests/test_turbo.py):

      * at the wire's operating points (quant >= 5) the turbo container
        must be a REAL margin below the reference-profile stream (the
        claim's +10-32%, not a tie);
      * below that (near-lossless corners) the wire may ship a slightly
        larger member when its exception fraction stays under the
        fallback gate (FALLBACK_EXC_FRAC — probing measured size there
        would need a second full reference encode per GOP); once the
        gate trips, per-GOP measured-size fallback caps the excess at
        member framing.  Measured worst on this artifact: +2.3% at
        block=8 quant=2; the pin allows 3%."""
    for r in rows:
        assert r["turbo_bpp"] <= r["bpp"] * 1.03, (
            f"turbo rate above the low-quant bound at block={r['block']} "
            f"quant={r['quant']}: {r['turbo_bpp']} vs {r['bpp']}"
        )
        if r["quant"] >= 5:
            assert r["turbo_bpp"] < r["bpp"] * 0.99, (
                f"turbo margin missing at block={r['block']} "
                f"quant={r['quant']}: {r['turbo_bpp']} vs {r['bpp']}"
            )
