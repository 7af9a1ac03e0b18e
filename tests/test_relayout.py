"""The word-transpose relayouts (ops/relayout.py) vs plain byte moves.

The permuted decode path (transform._perm_decode) relies on
cubes_perm_to_frames being BIT-identical to framing.cubes_to_frames on
sigma-permuted columns, and the turbo wire path on plane_to_wire /
wire_words being the plain byte transpose; these pin both against NumPy."""

import jax.numpy as jnp
import numpy as np
import pytest

from dct3d_tpu import oracle
from dct3d_tpu.codec import framing
from dct3d_tpu.config import CodecConfig
from dct3d_tpu.ops import relayout


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.mark.parametrize("t,h,w", [(8, 32, 64), (16, 24, 40)])
def test_perm_relayout_matches_cubes_to_frames(rng, t, h, w):
    """Arbitrary cube bytes in sigma-permuted column order come back as
    the frames framing.cubes_to_frames builds from the natural order."""
    cfg = CodecConfig()
    assert relayout.supports(cfg, h, w)
    cubes = rng.integers(0, 256, (t * h * w // 512, 512), dtype=np.uint8)
    want = np.asarray(framing.cubes_to_frames(jnp.asarray(cubes), cfg, h, w))
    perm = cubes[:, relayout.inv_sigma()]
    # sigma-permuted columns: perm[:, sigma[c]] == cube byte c
    np.testing.assert_array_equal(perm[:, relayout.sigma()], cubes)
    got = relayout.cubes_perm_to_frames(jnp.asarray(perm), height=h, width=w)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_supports_gates_geometry():
    cfg = CodecConfig()
    assert relayout.supports(cfg, 1080, 1920)
    assert not relayout.supports(cfg, 1080, 1924)  # width % 8 != 0
    small = CodecConfig(block_d=4, block_h=4, block_w=4)
    assert not relayout.supports(small, 32, 32)


@pytest.mark.parametrize("cubes", [32, 128, 1296])
def test_plane_to_wire_is_the_byte_transpose(rng, cubes):
    """The word transpose + byte peel equals the plain numpy byte
    transpose of the transport plane."""
    hc = 256
    plane = rng.integers(0, 256, (cubes, hc), dtype=np.uint8)
    got = np.asarray(relayout.plane_to_wire(jnp.asarray(plane)))
    np.testing.assert_array_equal(got, plane.T)


@pytest.mark.parametrize("cubes", [32, 1296])
def test_wire_to_plane_inverts_plane_to_wire(rng, cubes):
    hc = 256
    plane = rng.integers(0, 256, (cubes, hc), dtype=np.uint8)
    wire = jnp.asarray(plane.T)
    np.testing.assert_array_equal(np.asarray(relayout.wire_to_plane(wire)),
                                  plane)
    # wire_words: word j of cube row c packs plane bytes 4j..4j+3 LE
    words = np.asarray(relayout.wire_words(wire))
    np.testing.assert_array_equal(words, plane.view("<i4"))


@pytest.mark.parametrize("t,h,w", [(8, 32, 64), (16, 24, 40)])
def test_cubes_perm_to_frames_inverts_forward(rng, t, h, w):
    """Frames -> the oracle's cube enumeration -> sigma-permuted columns
    -> cubes_perm_to_frames is the identity."""
    cfg = CodecConfig()
    frames = rng.integers(0, 256, (t, h, w), dtype=np.uint8)
    cubes = oracle._cubes(frames, cfg).astype(np.uint8)
    perm = cubes[:, relayout.inv_sigma()]
    back = relayout.cubes_perm_to_frames(jnp.asarray(perm), height=h, width=w)
    np.testing.assert_array_equal(np.asarray(back), frames)


def test_inv_sigma_roundtrip():
    s = relayout.sigma()
    inv = relayout.inv_sigma()
    np.testing.assert_array_equal(s[inv], np.arange(512))
    # column-permuted pixels land in the perm layout:
    # perm[:, j] = pixels[:, inv[j]]  <=>  perm[:, s[c]] = pixels[:, c]
    x = np.random.default_rng(1).integers(0, 255, (3, 512))
    np.testing.assert_array_equal(x[:, inv][:, s], x)


def test_pair_unscramble_restores_natural_order():
    """lo_p[:, (hw/4)*(p%4) + p/4] == lo_nat[:, p] — the one-hot matmul
    (exact on integers) must equal the gather formulation exactly."""
    hw = 256
    p = np.arange(hw)
    perm_col = (hw // 4) * (p % 4) + p // 4
    m = relayout.pair_unscramble(512)
    x = np.random.default_rng(3).integers(-130560, 130560, (7, hw))
    scrambled = np.zeros_like(x)
    scrambled[:, perm_col] = x  # x in natural order -> word-grouped slots
    got = scrambled.astype(np.float32) @ m
    np.testing.assert_array_equal(got, x.astype(np.float32))


@pytest.mark.parametrize("t,h,w", [(8, 32, 64), (8, 16, 16)])
def test_wire_decode_step_matches_flat(rng, t, h, w):
    """decode_step_planar4(wire=True) on the wire layout must emit frames
    BYTE-identical to the flat-plane path: the word-grouped nibble peel +
    exact pair unscramble (round 4) may not perturb a single pixel, with
    exceptions landing on every parity and cube (transparency
    invariant)."""
    from dct3d_tpu.codec.transform import TransformContext, decode_step_planar4

    cfg = CodecConfig()
    ctx = TransformContext(cfg)
    n = t * h * w
    plane = rng.integers(0, 256, n // 2, dtype=np.uint16).astype(np.uint8)
    n_exc = max(64, n // 128)
    exc_idx = np.sort(
        rng.choice(n, n_exc, replace=False)).astype(np.int32)
    exc_val = rng.integers(-130560, 130560, n_exc).astype(np.int32)
    wire = np.ascontiguousarray(plane.reshape(-1, cfg.cube_size // 2).T)
    f_flat = np.asarray(decode_step_planar4(
        jnp.asarray(plane), jnp.asarray(exc_idx), jnp.asarray(exc_val),
        ctx.dec_me, ctx.dec_mo, cfg=cfg, height=h, width=w))
    f_wire = np.asarray(decode_step_planar4(
        jnp.asarray(wire), jnp.asarray(exc_idx), jnp.asarray(exc_val),
        ctx.dec_me, ctx.dec_mo, cfg=cfg, height=h, width=w, wire=True))
    np.testing.assert_array_equal(f_flat, f_wire)


def test_wire_decode_dc_splice_matches_merged(rng):
    """The split-DC wire path (dc as its own vector, spliced as column 0)
    must emit frames BYTE-identical to merging DC into the exception list
    — the production turbo decode uses the splice
    (turbo._parse_payload(split_dc=True))."""
    from dct3d_tpu.codec.transform import TransformContext, decode_step_planar4

    cfg = CodecConfig()
    ctx = TransformContext(cfg)
    t, h, w = 8, 32, 64
    n = t * h * w
    cubes = n // cfg.cube_size
    plane = rng.integers(0, 256, n // 2, dtype=np.uint16).astype(np.uint8)
    wire = np.ascontiguousarray(plane.reshape(-1, cfg.cube_size // 2).T)
    dc = rng.integers(-5771, 5771, cubes).astype(np.int32)
    out_idx = np.sort(rng.choice(
        np.setdiff1d(np.arange(n), np.arange(cubes) * cfg.cube_size),
        n // 128, replace=False)).astype(np.int32)
    out_val = rng.integers(-2000, 2000, out_idx.size).astype(np.int32)
    # merged route: DC rides the exception list
    mi = np.concatenate([out_idx, np.arange(cubes) * cfg.cube_size])
    mv = np.concatenate([out_val, dc])
    f_merged = np.asarray(decode_step_planar4(
        jnp.asarray(wire), jnp.asarray(mi.astype(np.int32)),
        jnp.asarray(mv.astype(np.int32)), ctx.dec_me, ctx.dec_mo,
        cfg=cfg, height=h, width=w, wire=True))
    f_split = np.asarray(decode_step_planar4(
        jnp.asarray(wire), jnp.asarray(out_idx), jnp.asarray(out_val),
        ctx.dec_me, ctx.dec_mo, cfg=cfg, height=h, width=w, wire=True,
        dc=jnp.asarray(dc)))
    np.testing.assert_array_equal(f_merged, f_split)


def test_flat_decode_dc_splice_matches_scatter(rng):
    """The flat-path DC splice (decoder._split_dc_flat -> dc spliced as the
    even plane's column 0) must emit frames BYTE-identical to scattering
    every DC through the exception list — the production flat decode uses
    the splice (decoder._dispatch_planar4)."""
    from dct3d_tpu.codec.decoder import _split_dc_flat
    from dct3d_tpu.codec.transform import TransformContext, decode_step_planar4

    cfg = CodecConfig()
    ctx = TransformContext(cfg)
    t, h, w = 8, 32, 64
    n = t * h * w
    cubes = n // cfg.cube_size
    plane = rng.integers(0, 256, n // 2, dtype=np.uint16).astype(np.uint8)
    # Exceptions: every large DC + some AC outliers; SMALL DCs stay in the
    # nibble plane (the planar4 emitter's behavior the split must honor).
    dc_exc_cubes = np.sort(rng.choice(cubes, cubes * 3 // 4, replace=False))
    ac_idx = np.sort(rng.choice(
        np.setdiff1d(np.arange(n), np.arange(cubes) * cfg.cube_size),
        n // 128, replace=False)).astype(np.int64)
    idx = np.sort(np.concatenate(
        [ac_idx, dc_exc_cubes.astype(np.int64) * cfg.cube_size]))
    val = np.where(idx % cfg.cube_size == 0,
                   rng.integers(-5771, 5771, idx.size),
                   rng.integers(-2000, 2000, idx.size)).astype(np.int32)
    # scatter route: everything through the exception list
    f_scatter = np.asarray(decode_step_planar4(
        jnp.asarray(plane), jnp.asarray(idx.astype(np.int32)),
        jnp.asarray(val), ctx.dec_me, ctx.dec_mo,
        cfg=cfg, height=h, width=w))
    # splice route: the production host split
    dc, idx2, val2 = _split_dc_flat(plane, idx, val, cfg.cube_size)
    assert idx2.size == ac_idx.size  # every DC left the exception list
    f_split = np.asarray(decode_step_planar4(
        jnp.asarray(plane), jnp.asarray(idx2.astype(np.int32)),
        jnp.asarray(val2), ctx.dec_me, ctx.dec_mo,
        cfg=cfg, height=h, width=w, dc=jnp.asarray(dc)))
    np.testing.assert_array_equal(f_scatter, f_split)
