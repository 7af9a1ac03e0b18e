"""Device-side sparse-exception compaction for the turbo (planar) profile.

The turbo wire format (docs/FORMAT.md, codec/turbo.py) ships quantized
coefficients as a packed-nibble plane plus an exception list for values
outside [-8, 7].  Extracting that list on device is the only irregular
step.  The compaction rides the same machinery as the bit packer: values
are grouped (256/group), each exception's within-group rank is a row
cumsum, and the per-slot selection is a one-hot (group, slot) pick via
exact bf16 einsums (local indices are < 256 and values split into two byte
planes, both exact in bf16 with f32 accumulation).

Groups hold at most ``slots`` exceptions; denser groups raise the overflow
flag and the driver retries with slots=group (cannot overflow), the same
budget-retry pattern as the packer.  The host receives small dense
(g, slots) arrays and compacts them at memory speed.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

#: default exception slots per 256-value group (typical content runs
#: ~0.2-1.5% exceptions; 16 slots = 6.25% local headroom)
DEFAULT_SLOTS = 16


def compact_exceptions(values, group: int = 256,
                       slots: int = DEFAULT_SLOTS, dc_stride: int = 0):
    """(n,) int32 -> dense per-group exception tables.

    Returns (lidx, vals, counts, overflow):
      lidx: (g, slots) uint8 — within-group index of each exception, slot
        order = stream order; slots >= counts[g] are zero padding.
      vals: (g, slots) int16 — the exception values (|v| <= 5771 for every
        supported cube size, ops/bitpack.max_codeword_bits bound).
      counts: (g,) int32 — exceptions in each group.
      overflow: () bool — some group exceeded `slots` (tables invalid for
        that group; retry with slots=group).

    dc_stride > 0 excludes positions with flat index % dc_stride == 0 (the
    DC coefficient of every cube in zigzag order) — the turbo wire ships
    those densely, since DC's divisor is 1 and it is ~always out of range.
    """
    n = values.shape[0]
    pad = (-n) % group
    if pad:
        # Zero-pad to whole groups (zeros are in-nibble, never exceptions,
        # so padded groups contribute nothing and global indices stay < n).
        # Small block-4 geometries legitimately hit this (w*h*gop % 256).
        values = jnp.concatenate(
            [values, jnp.zeros((pad,), values.dtype)]
        )
    v2 = values.reshape(-1, group)
    mask = (v2 < -8) | (v2 > 7)
    if dc_stride:
        flat = (
            jnp.arange(v2.shape[0], dtype=jnp.int32)[:, None] * group
            + jnp.arange(group, dtype=jnp.int32)[None, :]
        )
        mask &= (flat % dc_stride) != 0
    rank = jnp.cumsum(mask, axis=1) - mask.astype(jnp.int32)
    counts = mask.sum(axis=1, dtype=jnp.int32)
    if slots >= group:
        # Worst-case retry shape: the (g, group, group) one-hot would be
        # gigabytes, so place by a stable row argsort instead (exceptions
        # first, ascending) — slower (row gather) but retry-only.
        order = jnp.argsort(jnp.logical_not(mask), axis=1, stable=True)
        lidx = order.astype(jnp.uint8)
        vals = jnp.take_along_axis(v2, order, axis=1).astype(jnp.int16)
        return lidx, vals, counts, jnp.bool_(False)
    overflow = jnp.any(counts > slots)

    # One-hot (g, group, slots) selection; every product is exact in bf16
    # (operands are 0/1 times bytes < 256).
    oh = (
        mask[..., None]
        & (rank[..., None] == jnp.arange(slots, dtype=jnp.int32))
    ).astype(jnp.bfloat16)
    cidx = jnp.arange(group, dtype=jnp.bfloat16)
    lidx = jnp.einsum("gcs,c->gs", oh, cidx,
                      preferred_element_type=jnp.float32)
    v16 = v2.astype(jnp.int32) & 0xFFFF
    lo = (v16 & 0xFF).astype(jnp.bfloat16)
    hi = ((v16 >> 8) & 0xFF).astype(jnp.bfloat16)
    slo = jnp.einsum("gcs,gc->gs", oh, lo, preferred_element_type=jnp.float32)
    shi = jnp.einsum("gcs,gc->gs", oh, hi, preferred_element_type=jnp.float32)
    vals = (slo.astype(jnp.int32) | (shi.astype(jnp.int32) << 8))
    vals = ((vals ^ 0x8000) - 0x8000).astype(jnp.int16)  # sign-extend
    return lidx.astype(jnp.uint8), vals, counts, overflow


def expand_exceptions_np(lidx: np.ndarray, vals: np.ndarray,
                         counts: np.ndarray, group: int = 256):
    """Host half: dense (g, slots) tables -> sorted flat (idx, val) lists."""
    slots = lidx.shape[1]
    sel = np.arange(slots)[None, :] < counts[:, None]
    gsel, ssel = np.nonzero(sel)
    idx = (gsel * group + lidx[gsel, ssel]).astype(np.int64)
    return idx, vals[gsel, ssel].astype(np.int32)
