"""Device-side parallel bit packing of Exp-Golomb codewords.

The reference packs bits serially on the host (ExpGolombWriter.java:19-49,
ExpGolomb.c:32-64).  Here packing is data-parallel on the device (SURVEY.md
§7 M3), in two levels:

  level 1 — groups of `group` (256) codewords.  Bit offsets inside a group
    are a row-wise cumsum.  Each codeword (field width <= 32 bits)
    contributes to exactly two 32-bit words of a zero-padded per-group
    buffer of `w_words` words, via shifts.  The per-word segment sums are
    an exact one-hot einsum: one-hot(word index) in bfloat16 x the
    byte-planes of each contribution (bf16 holds 0..255 exactly), f32
    accumulation, recombined into uint32 words.  `w_words` is
    budget-capped (pack_bits_per_value), not worst-case-capped; groups whose
    content exceeds the budget raise an `overflow` flag and the driver
    retries with the worst-case shape.

  level 2 — the global stream is the concatenation of per-group bit
    strings, each already packed at its *global* bit phase (phase = group
    start bit % 32; group starts = one tiny cumsum), so group g's word j IS
    global word sw[g] + j.  Key structural facts (real codewords are >= 1
    bit, zero-width slots only lead or trail):
      * every interior group carries >= 255 bits, so it spans >= 7 whole
        words and a predecessor's bits reach at most the ONE boundary word
        sw[g] — merged by two scalar gathers per group (pre-merge);
      * group starts are therefore >= 7 words apart, so an aligned 8-word
        output row crosses at most ONE ownership change — the whole output
        is assembled from TWO row gathers (owner of the row's first word,
        owner of its last) over an overlapping-8-word-window table, plus a
        per-word select, instead of one element gather per output word.

  The carry byte for the next batch (the byte containing bit total_bits-1)
  comes from a dedicated worst-case-sized mini-pack of the last two groups,
  NOT from the main buffers — so it stays correct under BOTH overflow modes
  (global buffer and per-group budget), which lets the driver retry an
  overflowed batch with a bigger static shape without breaking the bit-carry
  chain (already-dispatched later batches chained on these scalars).

The output buffer has a static size (jit-friendly); the true bit length is
returned alongside.  Streaming carry across GOPs (the C encoder's
partial-byte carry, encoder.c:266-271) is handled by the caller passing the
carry as a pseudo-codeword occupying the first `carry_bits` bits.

Width limit: quantized 3D-DCT coefficients of 8-bit video are bounded by
255*sqrt(cube) (orthonormal basis), so code numbers < 2^15 and field widths
<= 29 < 32 for every supported block size; the device path requires <= 32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Max output bytes a single codeword may span in pack_bits_np (width<=41 at
# any bit phase); the device path instead requires width <= 32 (see above).
MAX_SPAN_BYTES = 6

# Output words per placement row (see level-2 notes: safe while interior
# groups span >= ROW_WORDS-1 whole words, i.e. group >= 256 at width >= 1).
ROW_WORDS = 8

def max_codeword_bits(cube_size: int) -> int:
    """Worst-case Exp-Golomb field width for quantized 3D-DCT coefficients
    of 8-bit video: |c| <= 255*sqrt(cube) (orthonormal basis; divisors only
    shrink it), code number m+1 <= 2*|c|+2."""
    max_code = 2 * int(np.ceil(255.0 * np.sqrt(cube_size))) + 2
    return 2 * max_code.bit_length() - 1


def worst_case_w_words(group: int, max_width: int = 32) -> int:
    """Per-group buffer words that can never overflow."""
    return -(-group * min(max_width, 32) // 32) + 2


def budget_w_words(group: int, bits_per_value: float) -> int:
    """Budget-capped per-group buffer words (bits_per_value average)."""
    return max(int(np.ceil(group * bits_per_value / 32.0)) + 2, 6)


def _group_pack_einsum(code32, wid, phase, w_words: int):
    """Level-1 pack of per-group codewords into phase-aligned words, as a
    one-hot einsum (exact byte-plane sums in bf16 with f32 accumulation).

    code32/wid: (g, group) uint32/int32; phase: (g,) int32 start-bit % 32.
    Returns (g, w_words) uint32.  Contributions whose word index exceeds
    w_words-1 are silently dropped (callers flag that via the budget check).
    """
    g_count, group = code32.shape
    loff = jnp.cumsum(wid, axis=1) - wid + phase[:, None]
    word0 = (loff >> 5).astype(jnp.int32)
    start_bit = (loff & 31).astype(jnp.int32)
    over = start_bit + wid - 32  # bits spilling into the next word
    shr = jnp.clip(over, 0, 31).astype(jnp.uint32)
    shl = jnp.clip(-over, 0, 31).astype(jnp.uint32)
    c0 = jnp.where(over > 0, code32 >> shr, code32 << shl)
    c0 = jnp.where(wid > 0, c0, 0)
    c1 = jnp.where(over > 0, code32 << (32 - shr), 0)

    onehot = (
        word0[:, :, None] == jnp.arange(w_words, dtype=jnp.int32)[None, None, :]
    ).astype(jnp.bfloat16)
    planes = jnp.stack(
        [
            (c0 >> 24) & 0xFF, (c0 >> 16) & 0xFF, (c0 >> 8) & 0xFF, c0 & 0xFF,
            (c1 >> 24) & 0xFF, (c1 >> 16) & 0xFF, (c1 >> 8) & 0xFF, c1 & 0xFF,
        ],
        axis=-1,
    ).astype(jnp.bfloat16)  # (g, group, 8)
    sums = jnp.einsum(
        "gcw,gcx->gwx", onehot, planes, preferred_element_type=jnp.float32
    ).astype(jnp.uint32)  # exact: byte planes of bit-disjoint fields
    w0 = (sums[..., 0] << 24) + (sums[..., 1] << 16) + (sums[..., 2] << 8) + sums[..., 3]
    w1 = (sums[..., 4] << 24) + (sums[..., 5] << 16) + (sums[..., 6] << 8) + sums[..., 7]
    # c1 lands one word later than c0's word.
    return w0 + jnp.concatenate(
        [jnp.zeros((g_count, 1), jnp.uint32), w1[:, :-1]], axis=1
    )


def pack_bits(code, width, out_bytes: int, group: int = 256,
              max_width: int = 32, w_words: int | None = None):
    """Pack codewords into a byte buffer of static size.

    Args:
      code: (n,) uint32 code numbers (MSB-first payload of each field).
      width: (n,) int32 field widths in bits, each <= max_width.  Real
        codewords have width >= 1; zero-width slots may only lead (the
        carry/phase pseudo-codeword) or trail (padding) — the level-2 row
        placement relies on interior groups spanning whole words.
      out_bytes: static output buffer size in bytes.
      group: codewords per level-1 group (>= 256; input is zero-padded to a
        multiple).
      max_width: static bound on field widths (<= 32); widths exceeding it
        corrupt the stream.
      w_words: per-group buffer words.  None = worst case (cannot overflow).
        Smaller (budget_w_words) shrinks the level-1 one-hot and the level-2
        table; batches whose content exceeds it set the overflow flag and
        must be retried with w_words=None.

    Returns:
      (buf, total_bits, tail_byte, overflow): buf (out_bytes,) uint8 with
      the MSB-first bit concatenation starting at bit 0; total_bits int32
      scalar; tail_byte uint32 scalar = the stream byte containing bit
      total_bits-1 (zero padded), valid even on overflow; overflow bool
      scalar = some group exceeded w_words (buf invalid, retry).
    """
    width = width.astype(jnp.int32)
    n = width.shape[0]
    if n == 0:
        return (jnp.zeros((out_bytes,), jnp.uint8), jnp.int32(0),
                jnp.uint32(0), jnp.bool_(False))
    _check_batch_bits(n, max_width, group)
    worst = worst_case_w_words(group, max_width)
    w_words = worst if w_words is None else min(w_words, worst)
    pad = (-n) % group
    code32 = code.astype(jnp.uint32)
    if pad:
        code32 = jnp.concatenate([code32, jnp.zeros((pad,), jnp.uint32)])
        width = jnp.concatenate([width, jnp.zeros((pad,), jnp.int32)])
    g_count = (n + pad) // group
    code32 = code32.reshape(g_count, group)
    wid = width.reshape(g_count, group)

    gbits, gstart, total_bits, phase, sw, overflow = _geometry(wid, 0, w_words)
    buf_groups = _group_pack_einsum(code32, wid, phase, w_words)
    tail_byte = _tail_byte(code32, wid, gstart, total_bits)
    buf = _place(buf_groups, gbits, gstart, total_bits, out_bytes, w_words)
    return (buf, total_bits.astype(jnp.int32), tail_byte.astype(jnp.uint32),
            overflow)


def _check_batch_bits(n: int, max_width: int, group: int) -> None:
    assert group >= 32 * ROW_WORDS, "row placement needs group >= 256"
    if n * max_width >= 1 << 31:
        # Bit offsets are int32 on device; one batch must stay under 2^31
        # bits even at worst-case widths (a 1080p GOP is ~0.45 Gbit worst
        # case; an 8K GOP would not be — shard it over a (gop, tile) mesh).
        raise ValueError(
            f"batch of {n} codewords can exceed 2^31 bits at width "
            f"{max_width}; split the batch (e.g. tile-shard the frame)"
        )


def _geometry(wid, lead_bits, w_words: int):
    """Group bit geometry (tiny arrays; one global cumsum of g_count).

    lead_bits: bits occupying the stream before the first codeword (the
    carry partial byte / sharded phase alignment), folded into every
    group's start offset instead of a prepended pseudo-codeword.
    """
    gbits = wid.sum(axis=1, dtype=jnp.int32)
    gstart = jnp.cumsum(gbits) - gbits + lead_bits
    total_bits = gstart[-1] + gbits[-1]
    phase = (gstart & 31).astype(jnp.int32)
    sw = (gstart >> 5).astype(jnp.int32)  # start word per group
    # A group overflows its budgeted buffer if its last written word
    # (incl. the one-word c1 spill) would exceed w_words - 1.
    overflow = jnp.any(
        (gbits > 0) & (((phase + gbits - 1) >> 5) > w_words - 2)
    )
    return gbits, gstart, total_bits, phase, sw, overflow


def _tail_byte(code32, wid, gstart, total_bits):
    """The stream byte containing bit total_bits-1, from a dedicated
    worst-case mini-pack of the last two groups (>= 255 bits of history
    before the final byte) — exact under BOTH overflow modes, which is what
    keeps the device carry chain valid when the driver retries a batch."""
    g_count, group = code32.shape
    g2 = min(2, g_count)
    mstart = gstart[g_count - g2]
    mbuf = _group_pack_einsum(
        code32[g_count - g2:].reshape(1, -1),
        wid[g_count - g2:].reshape(1, -1),
        (mstart & 31)[None],
        g2 * group + 2,
    )[0]
    tail_w_local = ((total_bits - 1) >> 5) - (mstart >> 5)
    tail_word = mbuf[jnp.clip(tail_w_local, 0, mbuf.shape[0] - 1)]
    byte_in_word = (jnp.maximum(total_bits - 1, 0) >> 3) & 3
    return (tail_word >> (8 * (3 - byte_in_word)).astype(jnp.uint32)) & 0xFF


def _place(buf_groups, gbits, gstart, total_bits, out_bytes: int,
           w_words: int, dense: bool = False):
    """Level 2 (XLA): pre-merge + overlapping-window row gather.

    dense=True asserts every group is nonempty (pack_values: 256 codewords
    x >= 1 bit each), which replaces the g_count-element pre-merge boundary
    gather with a one-hot select + shift.
    """
    g_count = buf_groups.shape[0]
    sw = (gstart >> 5).astype(jnp.int32)
    gidx = jnp.arange(g_count, dtype=jnp.int32)

    # Pre-merge: predecessors reach only word sw[g]; add their contribution
    # into each group's word 0 so every output word has ONE owner source.
    # One term suffices: a second-predecessor term would need p1's data to
    # END in the word p1 STARTS in (p1 spanning zero whole words), i.e.
    # gbits[p1] < 32 — impossible for a nonempty predecessor, since only
    # the globally LAST group can hold fewer than 255 real bits (zero-width
    # slots only lead or trail), and nothing follows the last group.
    if dense:
        # Predecessor is always g-1; its boundary word is its LAST occupied
        # word, selected one-hot over w_words (elementwise, no gather).
        endw = jnp.clip(((gstart & 31) + gbits - 1) >> 5, 0, w_words - 1)
        lastw = jnp.sum(
            jnp.where(
                endw[:, None] == jnp.arange(w_words, dtype=jnp.int32)[None, :],
                buf_groups, 0,
            ),
            axis=1, dtype=jnp.uint32,
        )
        # It overlaps this group's word 0 only when the predecessor's end
        # word IS this group's start word (i.e. gstart[g] % 32 != 0).
        same_word = (
            sw - jnp.concatenate([sw[:1], sw[:-1]])
            == jnp.concatenate([jnp.zeros((1,), jnp.int32), endw[:-1]])
        )
        bnd = jnp.where(
            (gidx > 0) & same_word,
            jnp.concatenate([jnp.zeros((1,), jnp.uint32), lastw[:-1]]),
            0,
        )
        pre = buf_groups.at[:, 0].add(bnd)
    else:
        nonempty = jnp.where(gbits > 0, gidx, -1)
        last_ne = jax.lax.cummax(nonempty)
        prev_ne = jnp.concatenate(
            [jnp.full((1,), -1, jnp.int32), last_ne[:-1]]
        )
        flat0 = buf_groups.reshape(-1)

        def boundary_from(p):
            pc = jnp.clip(p, 0, g_count - 1)
            delta = sw - sw[pc]
            ok = (p >= 0) & (delta >= 0) & (delta < w_words)
            src = pc * w_words + jnp.clip(delta, 0, w_words - 1)
            return jnp.where(ok, flat0[src], 0)

        pre = buf_groups.at[:, 0].add(boundary_from(prev_ne))

    # Overlapping ROW_WORDS-word windows of the pre-merged table: window i =
    # flat[i : i + ROW_WORDS], so the window starting at any global word is
    # ONE row gather away.
    flat = pre.reshape(-1)
    padf = jnp.concatenate([flat, jnp.zeros((ROW_WORDS,), jnp.uint32)])
    t8 = jnp.stack(
        [padf[k : k + flat.shape[0]] for k in range(ROW_WORDS)], axis=1
    )
    t_max = flat.shape[0] - 1

    nwords = (out_bytes + 3) // 4
    nrows = -(-nwords // ROW_WORDS)
    rows = jnp.arange(nrows, dtype=jnp.int32)
    w0_glob = rows * ROW_WORDS
    neg = jnp.int32(-(1 << 30))
    base_g = gidx * w_words - sw  # monotone nondecreasing in g

    if dense:
        # Every dense group emits >= 256 bits = ROW_WORDS words, so both
        # sw//8 and (sw+7)//8 are STRICTLY increasing: the scatter indices
        # are sorted and unique, so scatter-SET can declare both flags
        # instead of running the generic scatter-max.
        def smear(row_idx, vals, init):
            return jax.lax.cummax(
                jnp.full((nrows,), init, jnp.int32).at[row_idx].set(
                    vals, mode="drop", indices_are_sorted=True,
                    unique_indices=True,
                )
            )
    else:
        def smear(row_idx, vals, init):
            return jax.lax.cummax(
                jnp.full((nrows,), init, jnp.int32).at[row_idx].max(
                    vals, mode="drop"
                )
            )

    # Owner of a row's FIRST word: last g with sw[g] <= 8r; of its LAST
    # word: last g with sw[g] <= 8r+7.  Both via scatter-max + cummax
    # (values monotone in g).
    base_a = smear((sw + ROW_WORDS - 1) // ROW_WORDS, base_g, neg)
    base_b = smear(sw // ROW_WORDS, base_g, neg)
    sw_b = smear(sw // ROW_WORDS, sw, 0)
    total_words = (total_bits + 31) >> 5

    row_a = t8[jnp.clip(base_a + w0_glob, 0, t_max)]
    row_b = t8[jnp.clip(base_b + w0_glob, 0, t_max)]
    k = jnp.arange(ROW_WORDS, dtype=jnp.int32)[None, :]
    words = jnp.where(k >= (sw_b - w0_glob)[:, None], row_b, row_a)
    # Beyond-stream words read trailing buffer padding via the index clamp;
    # zero them so the whole static buffer is deterministic.
    words = jnp.where((w0_glob[:, None] + k) < total_words, words, 0)

    shifts = jnp.array([24, 16, 8, 0], jnp.uint32)
    buf = ((words.reshape(-1)[:nwords, None] >> shifts[None, :]) & 0xFF).astype(
        jnp.uint8
    )
    return buf.reshape(-1)[:out_bytes]


def pack_values(values, carry_code, carry_bits, out_bytes: int,
                group: int = 256, max_width: int = 32,
                w_words: int | None = None):
    """Pack int32 coefficients (codewords computed on the fly) after a
    leading partial byte.

    The fast-path twin of pack_bits for the encoders: instead of
    materializing (code, width) arrays in memory and prepending the carry as a
    pseudo-codeword (which forces whole-array copies for the concat and the
    group-multiple pad), the carry rides as a global bit offset
    (carry_bits <= 31, value right-aligned in carry_code) OR-ed into the
    first buffer word.  Requires n % group == 0 (the encoders' cube
    batches always are; other callers use pack_bits).

    Returns (buf, total_bits, tail_byte, overflow) exactly like pack_bits.
    """
    n = values.shape[0]
    assert n and n % group == 0, "pack_values needs whole groups"
    _check_batch_bits(n, max_width, group)
    worst = worst_case_w_words(group, max_width)
    w_words = worst if w_words is None else min(w_words, worst)
    g_count = n // group

    from . import expgolomb

    code32, wid = expgolomb.codewords(values)
    code32 = code32.reshape(g_count, group)
    wid = wid.reshape(g_count, group)
    gbits, gstart, total_bits, phase, sw, overflow = _geometry(
        wid, carry_bits.astype(jnp.int32), w_words
    )
    buf_groups = _group_pack_einsum(code32, wid, phase, w_words)
    # The carry's bits live at [0, carry_bits) of word 0 (group 0 starts at
    # bit carry_bits, so there is no overlap; shift clamp dodges the
    # undefined shift-by-32 when carry_bits == 0, which `where` masks).
    shift = ((32 - carry_bits) & 31).astype(jnp.uint32)
    lead = jnp.where(
        carry_bits > 0, carry_code.astype(jnp.uint32) << shift, 0
    )
    buf_groups = buf_groups.at[0, 0].add(lead)

    g2 = min(2, g_count)
    tail_byte = _tail_byte(code32[-g2:], wid[-g2:], gstart[-g2:], total_bits)

    buf = _place(buf_groups, gbits, gstart, total_bits, out_bytes, w_words,
                 dense=True)
    return (buf, total_bits.astype(jnp.int32), tail_byte.astype(jnp.uint32),
            overflow)


def pack_bits_np(
    code: np.ndarray, width: np.ndarray, out_bytes: int | None = None
) -> tuple[np.ndarray, int]:
    """NumPy twin of pack_bits for the host oracle / fallback (scatter-based;
    np.add.at is fine on CPU and this path has no width<=32 restriction)."""
    width = width.astype(np.int64)
    offsets = np.cumsum(width) - width
    total_bits = int(offsets[-1] + width[-1]) if width.size else 0
    if out_bytes is None:
        out_bytes = (total_bits + 7) // 8
    end = offsets + width
    code64 = code.astype(np.uint64)
    buf = np.zeros((out_bytes + 1,), dtype=np.uint32)
    first_byte = offsets >> 3
    for j in range(MAX_SPAN_BYTES):
        byte_idx = first_byte + j
        sh = end - 8 * (byte_idx + 1)
        shr = np.clip(sh, 0, 63).astype(np.uint64)
        shl = np.clip(-sh, 0, 63).astype(np.uint64)
        contrib = ((code64 >> shr) << shl).astype(np.uint32) & 0xFF
        valid = (8 * byte_idx < end) & (8 * (byte_idx + 1) > offsets)
        idx = np.where(valid, byte_idx, out_bytes)
        np.add.at(buf, idx, np.where(valid, contrib, 0))
    return buf[:out_bytes].astype(np.uint8), total_bits
