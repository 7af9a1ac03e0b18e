/* Streaming signed Exp-Golomb bit codec (host side).
 *
 * This codec's equivalent of the reference's C entropy codec
 * (reference: 3d-DCT-video-encoding-OpenCL/ExpGolomb.c:5-130) — same bit
 * format, new implementation:
 *   - 64-bit accumulator reader/writer instead of per-bit byte twiddling,
 *   - bulk (array-at-a-time) API so Python crosses the FFI once per GOP,
 *   - explicit bit-position cursors so chunked streaming needs no buffer
 *     compaction dance (decoder.c:210-243 in the reference).
 *
 * The encode path is normally executed on the device (ops/bitpack.py); this C
 * encoder is the CPU fallback and test oracle.  The serial decode path is
 * inherently sequential, so it lives here at memory speed.
 *
 * Format (ExpGolombWriter.java:19-49): v>0 -> m=2v-1, v<=0 -> m=-2v;
 * code = m+1 emitted MSB-first in (2*bitlen(code)-1) bits.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#if defined(__GNUC__)
#define EG_EXPORT __attribute__((visibility("default")))
#else
#define EG_EXPORT
#endif

/* ------------------------------------------------------------------ */
/* Encode: append n codewords to `out` starting at bit *bitpos.        */
/* `out` must be zeroed from *bitpos onward; returns 0 on success,     */
/* -1 if out_cap (bytes) would be exceeded.                            */
/* ------------------------------------------------------------------ */
EG_EXPORT int eg_encode(const int32_t *values, size_t n, uint8_t *out,
                        size_t out_cap, uint64_t *bitpos) {
    uint64_t pos = *bitpos;
    for (size_t i = 0; i < n; i++) {
        int64_t v = values[i];
        uint64_t m = v > 0 ? (uint64_t)(2 * v - 1) : (uint64_t)(-2 * v);
        uint64_t code = m + 1;
        int nbits = 64 - __builtin_clzll(code);
        int width = 2 * nbits - 1;
        uint64_t end = pos + (uint64_t)width;
        if ((end + 7) / 8 > out_cap) return -1;
        /* write `code` MSB-first into bits [pos, end) */
        uint64_t bit = pos;
        int remaining = width;
        while (remaining > 0) {
            size_t byte = (size_t)(bit >> 3);
            int avail = 8 - (int)(bit & 7);
            int take = remaining < avail ? remaining : avail;
            uint64_t chunk = (code >> (remaining - take)) & ((1u << take) - 1u);
            out[byte] |= (uint8_t)(chunk << (avail - take));
            bit += (uint64_t)take;
            remaining -= take;
        }
        pos = end;
    }
    *bitpos = pos;
    return 0;
}

/* ------------------------------------------------------------------ */
/* 14-bit window batch tables: one lookup decodes/skips EVERY complete */
/* codeword in the next 14 stream bits (typical streams run 1-2.5      */
/* bits/codeword, so ~6-11 codewords per hit).  The walk's bottleneck  */
/* is the serial key->table->advance dependency chain, so the CHAIN-   */
/* critical payload (bits consumed | count << 8) lives in its own      */
/* 32 KB uint16 table that stays L1-resident; the decoded nibbles      */
/* (off the chain — only the accumulator consumes them) ride a         */
/* separate 128 KB table.  Entries with count == 0 ("scalar one":      */
/* value outside the int4 plane range [-8, 7], or a codeword that      */
/* does not fit the window) also have bits == 0, so the branchless     */
/* fixed-step walkers below stall in place harmlessly on them.         */
/* ------------------------------------------------------------------ */
#define EG_WIN 14
#define EG_TAB_SIZE (1 << EG_WIN)

static uint16_t g_meta[EG_TAB_SIZE];      /* bits | count << 8, [-8,7] only */
static uint64_t g_nib[EG_TAB_SIZE];       /* value j at bits [4j, 4j+4) */
static uint16_t g_scan_meta[EG_TAB_SIZE]; /* bits | count << 8, any value */

__attribute__((constructor)) static void eg_build_tables(void) {
    for (int key = 0; key < EG_TAB_SIZE; key++) {
        /* bit j of the window (MSB-first) = (key >> (EG_WIN-1-j)) & 1 */
        int pos = 0, k = 0;
        uint64_t nib = 0;
        while (pos < EG_WIN && k < EG_WIN) {
            int z = 0;
            while (pos + z < EG_WIN &&
                   !((key >> (EG_WIN - 1 - (pos + z))) & 1))
                z++;
            if (pos + z >= EG_WIN || pos + 2 * z + 1 > EG_WIN) break;
            uint32_t code = 0;
            for (int b = 0; b <= z; b++)
                code = (code << 1) |
                       ((key >> (EG_WIN - 1 - (pos + z + b))) & 1u);
            uint32_t m = code - 1;
            int v = (m & 1) ? (int)((m + 1) >> 1) : -(int)(m >> 1);
            if (v < -8 || v > 7) break;
            nib |= ((uint64_t)(v & 0xF)) << (4 * k);
            k++;
            pos += 2 * z + 1;
        }
        g_meta[key] = (uint16_t)(pos | (k << 8));
        g_nib[key] = nib;
        /* scan variant: same walk without the value restriction */
        int spos = 0, sk = 0;
        while (spos < EG_WIN) {
            int z = 0;
            while (spos + z < EG_WIN &&
                   !((key >> (EG_WIN - 1 - (spos + z))) & 1))
                z++;
            if (spos + z >= EG_WIN || spos + 2 * z + 1 > EG_WIN) break;
            sk++;
            spos += 2 * z + 1;
        }
        g_scan_meta[key] = (uint16_t)(spos | (sk << 8));
    }
}

/* Big-endian 64-bit window load (for the fast decode path). */
static inline uint64_t load_be64(const uint8_t *p) {
    uint64_t v;
    memcpy(&v, p, 8);
#if defined(__GNUC__)
    return __builtin_bswap64(v);
#else
    return ((v & 0xFFull) << 56) | ((v & 0xFF00ull) << 40) |
           ((v & 0xFF0000ull) << 24) | ((v & 0xFF000000ull) << 8) |
           ((v >> 8) & 0xFF000000ull) | ((v >> 24) & 0xFF0000ull) |
           ((v >> 40) & 0xFF00ull) | (v >> 56);
#endif
}

/* Fast path: decode one codeword from a 64-bit window when it fits
 * entirely (width <= 57-phase guaranteed by lz bound check).  Returns the
 * signed value and advances *pos; returns 0/1 via *ok. */
static inline int64_t decode_fast(const uint8_t *data, size_t cap_bytes,
                                  uint64_t nbits_avail, uint64_t *pos,
                                  int *ok) {
    uint64_t p = *pos;
    size_t byte = (size_t)(p >> 3);
    int phase = (int)(p & 7);
    if (byte + 8 > cap_bytes) { *ok = 0; return 0; }
    uint64_t w = load_be64(data + byte) << phase;
    if (w == 0) { *ok = 0; return 0; } /* long zero run: slow path */
    int lz = __builtin_clzll(w);
    int width = 2 * lz + 1;
    if (width > 64 - phase || p + (uint64_t)width > nbits_avail) {
        *ok = 0;
        return 0;
    }
    uint64_t code = w >> (64 - width);
    *pos = p + (uint64_t)width;
    uint64_t m = code - 1;
    *ok = 1;
    return (m & 1) ? (int64_t)((m + 1) >> 1) : -(int64_t)(m >> 1);
}

/* One BRANCHLESS window of the planar4 fast walk: exactly 4 table steps
 * (4*EG_WIN = 56 bits always fit the >= 57 usable bits of a phase-shifted
 * 64-bit window; count==0 entries have bits==0 and nib==0, so a stalled
 * step is a no-op that later steps repeat harmlessly).  Data-dependent
 * branches — the per-hit flush and the window-exit check of the old walk —
 * mispredict every few hits and cost more than the work itself; here the
 * flush is an unconditional 8-byte store plus a conditional-move advance.
 *
 * Caller guarantees i + 4*EG_WIN + 16 <= n (so the unconditional store
 * stays inside plane[n/2]) and byte + 8 <= cap.  Invariants: *i - *accn is
 * even and *dst == plane + (*i - *accn)/2.  Returns bits consumed, NEGATED
 * when the window ended stalled (wide value / long zero run at the new
 * position — the caller handles ONE codeword inline and re-enters). */
static inline int eg_win4(const uint8_t *data, uint64_t pos,
                          uint64_t *acc, int *accn, size_t *i,
                          uint8_t **dst) {
    uint64_t w = load_be64(data + (size_t)(pos >> 3)) << (pos & 7);
    int used = 0;
    uint64_t a = *acc; /* accn pending nibbles, nibble j at bits [4j,4j+4) */
    int an = *accn;
    size_t ii = *i;
    uint8_t *d = *dst;
    unsigned cnt = 1;
    for (int s = 0; s < 4; s++) {
        size_t key = (size_t)((w << used) >> (64 - EG_WIN));
        unsigned m = g_meta[key];
        cnt = m >> 8;
        uint64_t add = g_nib[key];
        int sh = 4 * an; /* 0..60 */
        a |= add << sh;
        /* nibbles spilling past the accumulator's 16 slots ((add>>1) >>
         * (63-sh) is add >> (64-sh) without the undefined sh==0 case) */
        uint64_t spill = (add >> 1) >> (63 - sh);
        an += (int)cnt;
        ii += cnt;
        used += (int)(m & 0xFF);
        /* flush: always store acc's 8 bytes (garbage tail bytes are plane
         * bytes of values not yet decoded — every one is rewritten by a
         * later flush or the scalar path's assign-then-OR pair); mask-
         * select the post-flush accumulator so no branch can mispredict.
         * (A clz run-skip variant that eats zero-value '1'-bit runs in
         * bulk measured WORSE — same window bits, more instructions —
         * and the walk is instruction-throughput-bound: 2026-08-20.) */
        memcpy(d, &a, 8);
        uint64_t fm = -(uint64_t)(an >> 4); /* an <= 15 + EG_WIN < 32 */
        d += (size_t)(an >> 4) << 3;
        a = (spill & fm) | (a & ~fm);
        an &= 15;
    }
    *acc = a;
    *accn = an;
    *i = ii;
    *dst = d;
    return cnt ? used : -used;
}

/* Decode ONE codeword straight from a 64-bit window at `pos` and append
 * its wrapping nibble to the eg_win4 accumulator (the inline stall
 * handler: wide values would otherwise exit the fast loop into an
 * out-of-line scalar call ~10x the cost).  Returns the value via *v_out
 * (for the caller's exception bookkeeping); 0 => long zero run / window
 * end / stream end — caller leaves the fast loop. */
static inline int eg_slow_one(const uint8_t *data, size_t cap_bytes,
                              uint64_t nbits_avail, uint64_t *pos,
                              uint64_t *acc, int *accn, size_t *i,
                              uint8_t **dst, int64_t *v_out) {
    uint64_t p = *pos;
    size_t byte = (size_t)(p >> 3);
    if (byte + 8 > cap_bytes) return 0;
    uint64_t w = load_be64(data + byte) << (p & 7);
    if (w == 0) return 0;
    int lz = __builtin_clzll(w);
    int width = 2 * lz + 1;
    if (width > 64 - (int)(p & 7) || p + (uint64_t)width > nbits_avail)
        return 0;
    uint64_t code = w >> (64 - width);
    uint64_t m = code - 1;
    int64_t v = (m & 1) ? (int64_t)((m + 1) >> 1) : -(int64_t)(m >> 1);
    *pos = p + (uint64_t)width;
    *acc |= (uint64_t)(v & 0xF) << (4 * *accn);
    if (++*accn == 16) {
        memcpy(*dst, acc, 8);
        *dst += 8;
        *acc = 0;
        *accn = 0;
    }
    ++*i;
    *v_out = v;
    return 1;
}

/* ------------------------------------------------------------------ */
/* Decode: read n values starting at bit *bitpos.  nbits_avail is the  */
/* number of valid bits in `data`.  Returns 0 on success, -1 if the    */
/* stream ran out mid-codeword (bitpos is then left unchanged).        */
/* ------------------------------------------------------------------ */
EG_EXPORT int eg_decode(const uint8_t *data, uint64_t nbits_avail,
                        uint64_t *bitpos, int32_t *out, size_t n) {
    uint64_t pos = *bitpos;
    uint64_t start = pos;
    size_t cap_bytes = (size_t)((nbits_avail + 7) / 8);
    for (size_t i = 0; i < n; i++) {
        /* batch fast path: decode every complete in-nibble codeword of
         * the next EG_WIN bits per table hit (same table as planar4).
         * Whole bytes only (nbits_avail >> 3), so a trailing partial
         * byte's padding bits can never be consumed as codewords. */
        while (i + EG_WIN <= n) {
            size_t byte = (size_t)(pos >> 3);
            if (byte + 8 > (size_t)(nbits_avail >> 3)) break;
            uint64_t w = load_be64(data + byte) << (pos & 7);
            int avail = 64 - (int)(pos & 7);
            int used = 0;
            while (used + EG_WIN <= avail && i + EG_WIN <= n) {
                size_t key = (w << used) >> (64 - EG_WIN);
                unsigned m = g_meta[key];
                unsigned cnt = m >> 8;
                if (!cnt) break;
                uint64_t nib = g_nib[key];
                for (unsigned j = 0; j < cnt; j++)
                    out[i + j] =
                        (int32_t)(((int)((nib >> (4 * j)) & 0xF) ^ 8) - 8);
                used += (int)(m & 0xFF);
                i += cnt;
            }
            if (!used) break;
            pos += (uint64_t)used;
        }
        if (i >= n) break;
        int ok;
        int64_t v = decode_fast(data, cap_bytes, nbits_avail, &pos, &ok);
        if (ok) {
            out[i] = (int32_t)v;
            continue;
        }
        /* count leading zeros */
        int zeros = 0;
        uint64_t p = pos;
        while (1) {
            if (p >= nbits_avail) { *bitpos = start; return -1; }
            uint8_t byte = data[p >> 3];
            int off = (int)(p & 7);
            uint8_t rest = (uint8_t)(byte << off); /* stream bits at top */
            if (rest != 0) {
                int lz = __builtin_clz((uint32_t)rest) - 24;
                int in_byte = 8 - off;
                if (lz < in_byte) { zeros += lz; p += (uint64_t)lz; break; }
            }
            zeros += 8 - off;
            p += (uint64_t)(8 - off);
        }
        int nbits = zeros + 1;
        if (p + (uint64_t)nbits > nbits_avail) { *bitpos = start; return -1; }
        /* read nbits bits MSB-first starting at p */
        uint64_t code = 0;
        int remaining = nbits;
        while (remaining > 0) {
            uint8_t byte = data[p >> 3];
            int off = (int)(p & 7);
            int avail = 8 - off;
            int take = remaining < avail ? remaining : avail;
            uint64_t chunk = ((uint64_t)byte >> (avail - take)) &
                             ((1u << take) - 1u);
            code = (code << take) | chunk;
            p += (uint64_t)take;
            remaining -= take;
        }
        pos = p;
        uint64_t m = code - 1;
        out[i] = (m & 1) ? (int32_t)((m + 1) >> 1) : -(int32_t)(m >> 1);
    }
    *bitpos = pos;
    return 0;
}

/* ------------------------------------------------------------------ */
/* Fused decode + planarize: decode n values directly into an int8     */
/* plane (wrapping cast) plus an exception list (flat index, true      */
/* value) for values outside int8 — the device-upload format of the    */
/* decoder (codec/decoder.py).  One pass, no int32 intermediate.       */
/* Returns 0 ok, -1 stream exhausted (bitpos unchanged), -2 exception  */
/* capacity exceeded (bitpos unchanged).                               */
/* ------------------------------------------------------------------ */
EG_EXPORT int eg_decode_planar(const uint8_t *data, uint64_t nbits_avail,
                               uint64_t *bitpos, int8_t *plane, size_t n,
                               int32_t *exc_idx, int32_t *exc_val,
                               size_t exc_cap, uint64_t *exc_count) {
    uint64_t pos = *bitpos;
    uint64_t start = pos;
    size_t cap_bytes = (size_t)(nbits_avail >> 3); /* whole bytes only */
    size_t nexc = 0;
    size_t i = 0;
    while (i < n) {
        /* fast path: batch-decode the 16-bit window's complete in-nibble
         * codewords per table hit (values in [-8,7] are also in int8, so
         * they never hit the exception list), then drain wider-but-int8
         * codewords with the per-codeword clz loop */
        size_t byte = (size_t)(pos >> 3);
        if (byte + 8 <= cap_bytes) {
            uint64_t w = load_be64(data + byte) << (pos & 7);
            int avail = 64 - (int)(pos & 7);
            int used = 0;
            while (used + EG_WIN <= avail && i + EG_WIN <= n) {
                size_t key = (w << used) >> (64 - EG_WIN);
                unsigned m = g_meta[key];
                unsigned cnt = m >> 8;
                if (!cnt) break;
                uint64_t nib = g_nib[key];
                for (unsigned j = 0; j < cnt; j++)
                    plane[i + j] =
                        (int8_t)(((int)((nib >> (4 * j)) & 0xF) ^ 8) - 8);
                used += (int)(m & 0xFF);
                i += cnt;
            }
            while (i < n) {
                uint64_t ww = w << used;
                if (ww == 0) break;
                int lz = __builtin_clzll(ww);
                int width = 2 * lz + 1;
                if (used + width > avail) break;
                uint64_t code = ww >> (64 - width);
                used += width;
                uint64_t m = code - 1;
                int64_t v = (m & 1) ? (int64_t)((m + 1) >> 1)
                                    : -(int64_t)(m >> 1);
                plane[i] = (int8_t)v;
                if ((int64_t)(int8_t)v != v) {
                    if (nexc >= exc_cap) { *bitpos = start; return -2; }
                    exc_idx[nexc] = (int32_t)i;
                    exc_val[nexc] = (int32_t)v;
                    nexc++;
                }
                i++;
            }
            if (used > 0) {
                pos += (uint64_t)used;
                continue;
            }
        }
        /* slow path shared with eg_decode */
        int32_t one;
        uint64_t p2 = pos;
        if (eg_decode(data, nbits_avail, &p2, &one, 1) != 0) {
            *bitpos = start;
            return -1;
        }
        pos = p2;
        plane[i] = (int8_t)one;
        if ((int64_t)(int8_t)one != (int64_t)one) {
            if (nexc >= exc_cap) { *bitpos = start; return -2; }
            exc_idx[nexc] = (int32_t)i;
            exc_val[nexc] = (int32_t)one;
            nexc++;
        }
        i++;
    }
    *bitpos = pos;
    *exc_count = nexc;
    return 0;
}

/* ------------------------------------------------------------------ */
/* Fused decode + 4-bit planarize: like eg_decode_planar but the plane */
/* packs two values per byte (low nibble = even index), halving the    */
/* host->device upload.  Values outside [-8, 7] go to the exception    */
/* list.  n must be even.                                              */
/* ------------------------------------------------------------------ */
EG_EXPORT int eg_decode_planar4(const uint8_t *data, uint64_t nbits_avail,
                                uint64_t *bitpos, uint8_t *plane, size_t n,
                                int32_t *exc_idx, int32_t *exc_val,
                                size_t exc_cap, uint64_t *exc_count) {
    uint64_t pos = *bitpos;
    uint64_t start = pos;
    size_t cap_bytes = (size_t)(nbits_avail >> 3); /* whole bytes only */
    size_t nexc = 0;
    size_t i = 0;
    while (i < n) {
        /* fast path: branchless 4-step windows (eg_win4, ~0.3-0.5
         * ns/value).  Little-endian hosts only (the flush lays
         * accumulator nibble j at plane nibble i+j); big-endian builds
         * take the endian-safe scalar path. */
#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
        if (!(i & 1) && i + 4 * EG_WIN + 16 <= n &&
            (pos >> 3) + 8 <= cap_bytes) {
            uint64_t acc = 0;
            int accn = 0; /* pending nibbles in acc (< 16 after flush) */
            uint8_t *dst = plane + (i >> 1);
            size_t i_enter = i;
            while (i + 4 * EG_WIN + 16 <= n &&
                   (pos >> 3) + 8 <= cap_bytes) {
                int used = eg_win4(data, pos, &acc, &accn, &i, &dst);
                if (used > 0) {
                    pos += (uint64_t)used;
                    continue;
                }
                pos += (uint64_t)(-used);
                /* stalled: one wide codeword, handled inline */
                int64_t v;
                if (!eg_slow_one(data, cap_bytes, nbits_avail, &pos, &acc,
                                 &accn, &i, &dst, &v))
                    break; /* long zero run / stream end: scalar path */
                if (v < -8 || v > 7) {
                    if (nexc >= exc_cap) { *bitpos = start; return -2; }
                    exc_idx[nexc] = (int32_t)(i - 1);
                    exc_val[nexc] = (int32_t)v;
                    nexc++;
                }
            }
            /* flush pending nibbles; an odd count leaves the last byte's
             * high nibble 0 for the scalar path to OR into */
            uint64_t lo = (uint64_t)acc;
            for (int b = (accn + 1) >> 1; b > 0; b--) {
                *dst++ = (uint8_t)lo;
                lo >>= 8;
            }
            if (i != i_enter) continue;
        }
#endif
        /* scalar: window tail, long zero run, out-of-nibble value
         * (-> exception list), or the last <16 values */
        int32_t one;
        uint64_t p2 = pos;
        if (eg_decode(data, nbits_avail, &p2, &one, 1) != 0) {
            *bitpos = start;
            return -1;
        }
        pos = p2;
        uint8_t nib = (uint8_t)(one & 0xF);
        if (i & 1)
            plane[i >> 1] |= (uint8_t)(nib << 4);
        else
            plane[i >> 1] = nib;
        if (one < -8 || one > 7) {
            if (nexc >= exc_cap) { *bitpos = start; return -2; }
            exc_idx[nexc] = (int32_t)i;
            exc_val[nexc] = (int32_t)one;
            nexc++;
        }
        i++;
    }
    *bitpos = pos;
    *exc_count = nexc;
    return 0;
}

/* ------------------------------------------------------------------ */
/* Interleaved multi-stream planar4 decode.  The table walk is a       */
/* serial load->advance dependency chain (~15-20 cycles/hit, load      */
/* latency bound); decoding S INDEPENDENT streams round-robin at       */
/* window granularity overlaps S chains in the out-of-order window,    */
/* so one core sustains ~S hits per chain latency.  Streams are        */
/* independent spans of the same payload (consecutive GOPs, from the   */
/* stream index or the speculative scan).                              */
/*                                                                     */
/* Stream k decodes n values from bit positions[k] into                */
/* planes + k*(n/2), exceptions into exc_idx/exc_val + k*exc_cap with  */
/* counts in exc_counts[k].  Returns 0 ok, -1 some stream exhausted,   */
/* -2 some stream overflowed exc_cap (positions[] then undefined;      */
/* callers retry).                                                     */
/* ------------------------------------------------------------------ */
#define EG_MAX_STREAMS 8

typedef struct {
    uint64_t pos;
    size_t i;
    uint64_t acc;
    int accn;
    uint8_t *dst;
    size_t nexc;
    int done;
} EgMState;

EG_EXPORT int eg_decode_planar4_multi(const uint8_t *data,
                                      uint64_t nbits_avail,
                                      uint64_t *positions, int nstreams,
                                      size_t n, uint8_t *planes,
                                      int32_t *exc_idx, int32_t *exc_val,
                                      size_t exc_cap,
                                      uint64_t *exc_counts) {
    size_t cap_bytes = (size_t)(nbits_avail >> 3);
    EgMState st[EG_MAX_STREAMS];
    if (nstreams < 1 || nstreams > EG_MAX_STREAMS) return -3;
    if (n == 0) {
        /* No work: every stream is trivially done at its start position.
         * (Without this, live would never decrement below — the loop
         * only decrements in branches a done stream cannot reach.) */
        for (int k = 0; k < nstreams; k++) exc_counts[k] = 0;
        return 0;
    }
    for (int k = 0; k < nstreams; k++) {
        st[k].pos = positions[k];
        st[k].i = 0;
        st[k].acc = 0;
        st[k].accn = 0;
        st[k].dst = planes + (size_t)k * (n >> 1);
        st[k].nexc = 0;
        st[k].done = 0;
    }
    int live = nstreams;
    while (live > 0) {
        for (int k = 0; k < nstreams; k++) {
            EgMState *s = &st[k];
            if (s->done) continue;
#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
            /* one branchless window of the fast path (eg_win4).  Entry
             * needs i - accn even (the accumulator's base nibble index is
             * byte-aligned); scalar writes bypass acc, so check both
             * parities. */
            if (!((s->i ^ (size_t)s->accn) & 1) &&
                s->i + 4 * EG_WIN + 16 <= n &&
                (s->pos >> 3) + 8 <= cap_bytes) {
                int used = eg_win4(data, s->pos, &s->acc, &s->accn, &s->i,
                                   &s->dst);
                if (used > 0) {
                    s->pos += (uint64_t)used;
                    continue; /* stay on the fast path */
                }
                s->pos += (uint64_t)(-used);
                int64_t v;
                if (eg_slow_one(data, cap_bytes, nbits_avail, &s->pos,
                                &s->acc, &s->accn, &s->i, &s->dst, &v)) {
                    if (v < -8 || v > 7) {
                        if (s->nexc >= exc_cap) return -2;
                        exc_idx[(size_t)k * exc_cap + s->nexc] =
                            (int32_t)(s->i - 1);
                        exc_val[(size_t)k * exc_cap + s->nexc] = (int32_t)v;
                        s->nexc++;
                    }
                    continue;
                }
            }
#endif
            /* flush pending nibbles before any scalar/terminal handling */
            if (s->accn > 0) {
                uint64_t lo = (uint64_t)s->acc;
                for (int b = (s->accn + 1) >> 1; b > 0; b--) {
                    *s->dst++ = (uint8_t)lo;
                    lo >>= 8;
                }
                /* an odd flush leaves the last byte half-filled; step dst
                 * back so the scalar path's OR lands in it */
                if (s->accn & 1) s->dst--;
                s->acc = 0;
                s->accn = 0;
            }
            if (s->i >= n) {
                s->done = 1;
                live--;
                positions[k] = s->pos;
                exc_counts[k] = s->nexc;
                continue;
            }
            /* scalar: one value (window tail, long zero run, wide value
             * or the last few) */
            int32_t one;
            uint64_t p2 = s->pos;
            if (eg_decode(data, nbits_avail, &p2, &one, 1) != 0) return -1;
            s->pos = p2;
            uint8_t nib = (uint8_t)(one & 0xF);
            if (s->i & 1)
                *s->dst++ |= (uint8_t)(nib << 4);
            else
                *s->dst = nib;
            if (one < -8 || one > 7) {
                if (s->nexc >= exc_cap) return -2;
                exc_idx[(size_t)k * exc_cap + s->nexc] = (int32_t)s->i;
                exc_val[(size_t)k * exc_cap + s->nexc] = (int32_t)one;
                s->nexc++;
            }
            s->i++;
            if (s->i >= n) {
                s->done = 1;
                live--;
                positions[k] = s->pos;
                exc_counts[k] = s->nexc;
            }
        }
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* Fused speculative segment DECODE (the plain-stream fast path).      */
/*                                                                     */
/* speculative boundary discovery (eg_scan_segment) + a second decode  */
/* pass costs two table walks per codeword; here the segment walk IS   */
/* the planar4 decode.  Each of the nstreams segments walks codewords  */
/* from bitpos[k] — ASSUMED to be a codeword start; workers guess byte */
/* boundaries and the Python stitch validates by the rec[] position    */
/* handshake, discarding each segment's pre-convergence prefix — and   */
/* decodes every value into the segment's LOCAL nibble plane.  The     */
/* streams interleave round-robin at window granularity so their       */
/* serial table-walk chains overlap in the out-of-order core (same     */
/* trick as eg_decode_planar4_multi, ~1.26x/core).                     */
/*                                                                     */
/* Stream k:                                                           */
/*   plane   at planes + k*plane_stride (>= (val_cap+1)/2 + 16 bytes   */
/*           — eg_win4 stores 8 bytes unconditionally),                */
/*   rec     at recs + k*rec_cap: the first rec_cap visited start      */
/*           positions (handshake targets),                            */
/*   ckpt    at ckpt_cnts/ckpt_poss + k*ckpt_cap: (count, position)    */
/*           checkpoints whenever the count crosses a multiple of      */
/*           1 << ckpt_shift (>= 6: one step visits < 64 codewords),   */
/*           entry 0 = (0, bitpos[k]) — boundary lookups later rescan  */
/*           at most one checkpoint interval,                          */
/*   exceptions at exc_idx/exc_val + k*exc_cap with LOCAL value        */
/*           indices; counts in exc_counts[k].                         */
/* On return bitpos[k] = exit position (first start >= end_bits[k], or */
/* the last reachable start if the data ran out first — the Python     */
/* side treats a short interior segment as a truncated stream) and     */
/* counts[k] = values decoded in [entry, exit).                        */
/* Returns 0 ok, -2 exc_cap overflow, -3 bad nstreams / val_cap hit    */
/* (callers retry with bigger buffers; outputs are then undefined).    */
/* ------------------------------------------------------------------ */
#define EG_SEG_MAX 8

typedef struct {
    uint64_t pos;
    uint64_t end_bit;
    size_t i;
    uint64_t acc;
    int accn;
    uint8_t *plane;
    uint8_t *dst;
    uint64_t *ckpt_cnt;
    uint64_t *ckpt_pos;
    uint64_t next_ckpt; /* first count that needs a new checkpoint */
    size_t nexc;
    int done;
} EgSegState;

/* Record a checkpoint when the count crossed s->next_ckpt.  The hot
 * windows pre-check `cnt1 >= s->next_ckpt` (one predictable compare)
 * before calling, so the shift math here is off the fast path. */
static void eg_seg_ckpt(EgSegState *s, size_t ckpt_cap, int ckpt_shift,
                        uint64_t cnt0, uint64_t pos0, uint64_t cnt1) {
    if ((cnt0 >> ckpt_shift) != (cnt1 >> ckpt_shift)) {
        uint64_t t = (cnt0 >> ckpt_shift) + 1;
        if (t < ckpt_cap) {
            s->ckpt_cnt[t] = cnt0;
            s->ckpt_pos[t] = pos0;
        }
    }
    s->next_ckpt = ((cnt1 >> ckpt_shift) + 1) << ckpt_shift;
}

EG_EXPORT int eg_decode_planar4_seg_multi(
    const uint8_t *data, uint64_t nbits_avail, int nstreams,
    uint64_t *bitpos, const uint64_t *end_bits,
    uint64_t *recs, size_t rec_cap,
    uint64_t *ckpt_cnts, uint64_t *ckpt_poss, size_t ckpt_cap,
    int ckpt_shift,
    uint8_t *planes, size_t plane_stride, size_t val_cap,
    int32_t *exc_idx, int32_t *exc_val, size_t exc_cap,
    uint64_t *exc_counts, uint64_t *counts) {
    size_t cap_bytes = (size_t)(nbits_avail >> 3);
    EgSegState st[EG_SEG_MAX];
    if (nstreams < 1 || nstreams > EG_SEG_MAX || ckpt_shift < 6) return -3;
    for (int k = 0; k < nstreams; k++) {
        EgSegState *s = &st[k];
        s->pos = bitpos[k];
        s->end_bit = end_bits[k];
        s->i = 0;
        s->acc = 0;
        s->accn = 0;
        s->plane = planes + (size_t)k * plane_stride;
        s->dst = s->plane;
        s->ckpt_cnt = ckpt_cnts + (size_t)k * ckpt_cap;
        s->ckpt_pos = ckpt_poss + (size_t)k * ckpt_cap;
        s->next_ckpt = 1ull << ckpt_shift;
        s->nexc = 0;
        s->done = 0;
        if (ckpt_cap > 0) {
            s->ckpt_cnt[0] = 0;
            s->ckpt_pos[0] = s->pos;
        }
    }
    /* phase 1: per-stream scalar walk recording the handshake targets */
    for (int k = 0; k < nstreams; k++) {
        EgSegState *s = &st[k];
        uint64_t *rec = recs + (size_t)k * rec_cap;
        while (s->i < rec_cap && s->pos < s->end_bit) {
            if (s->i >= val_cap) return -3;
            rec[s->i] = s->pos;
            int32_t one;
            uint64_t p2 = s->pos;
            if (eg_decode(data, nbits_avail, &p2, &one, 1) != 0) {
                s->done = 1; /* ran out: exit = last reachable start */
                break;
            }
            if (s->i + 1 >= s->next_ckpt)
                eg_seg_ckpt(s, ckpt_cap, ckpt_shift, s->i, s->pos,
                            s->i + 1);
            s->pos = p2;
            uint8_t nib = (uint8_t)(one & 0xF);
            if (s->i & 1)
                *s->dst++ |= (uint8_t)(nib << 4);
            else
                *s->dst = nib;
            if (one < -8 || one > 7) {
                if (s->nexc >= exc_cap) return -2;
                exc_idx[(size_t)k * exc_cap + s->nexc] = (int32_t)s->i;
                exc_val[(size_t)k * exc_cap + s->nexc] = one;
                s->nexc++;
            }
            s->i++;
        }
        if (!s->done && s->pos >= s->end_bit) s->done = 1;
    }
    /* phase 2: round-robin interleaved fast walk */
    int live = 0;
    for (int k = 0; k < nstreams; k++)
        if (!st[k].done) live++;
    while (live > 0) {
        for (int k = 0; k < nstreams; k++) {
            EgSegState *s = &st[k];
            if (s->done) continue;
#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
            if (!((s->i ^ (size_t)s->accn) & 1) &&
                s->i + 4 * EG_WIN + 16 <= val_cap &&
                (s->pos >> 3) + 8 <= cap_bytes &&
                s->pos + 4 * EG_WIN <= s->end_bit) {
                uint64_t cnt0 = s->i, pos0 = s->pos;
                int used = eg_win4(data, s->pos, &s->acc, &s->accn, &s->i,
                                   &s->dst);
                if (s->i >= s->next_ckpt)
                    eg_seg_ckpt(s, ckpt_cap, ckpt_shift, cnt0, pos0, s->i);
                if (used > 0) {
                    s->pos += (uint64_t)used;
                    continue; /* stay on the fast path */
                }
                s->pos += (uint64_t)(-used);
                if (s->pos < s->end_bit) {
                    int64_t v;
                    cnt0 = s->i;
                    pos0 = s->pos;
                    if (eg_slow_one(data, cap_bytes, nbits_avail, &s->pos,
                                    &s->acc, &s->accn, &s->i, &s->dst, &v)) {
                        if (s->i >= s->next_ckpt)
                            eg_seg_ckpt(s, ckpt_cap, ckpt_shift, cnt0, pos0,
                                        s->i);
                        if (v < -8 || v > 7) {
                            if (s->nexc >= exc_cap) return -2;
                            exc_idx[(size_t)k * exc_cap + s->nexc] =
                                (int32_t)(s->i - 1);
                            exc_val[(size_t)k * exc_cap + s->nexc] =
                                (int32_t)v;
                            s->nexc++;
                        }
                        continue;
                    }
                }
                /* stalled at/past end_bit, long zero run, or data end:
                 * fall through to the flush + scalar/terminal handling */
            }
#endif
            /* flush pending nibbles before any scalar/terminal handling */
            if (s->accn > 0) {
                uint64_t lo = (uint64_t)s->acc;
                for (int b = (s->accn + 1) >> 1; b > 0; b--) {
                    *s->dst++ = (uint8_t)lo;
                    lo >>= 8;
                }
                if (s->accn & 1) s->dst--;
                s->acc = 0;
                s->accn = 0;
            }
            if (s->pos >= s->end_bit) {
                s->done = 1;
                live--;
                continue;
            }
            if (s->i >= val_cap) return -3;
            /* scalar: one codeword (window tail, long zero run, or the
             * approach to end_bit) */
            int32_t one;
            uint64_t p2 = s->pos;
            if (eg_decode(data, nbits_avail, &p2, &one, 1) != 0) {
                s->done = 1; /* ran out: exit = last reachable start */
                live--;
                continue;
            }
            if (s->i + 1 >= s->next_ckpt)
                eg_seg_ckpt(s, ckpt_cap, ckpt_shift, s->i, s->pos,
                            s->i + 1);
            s->pos = p2;
            uint8_t nib = (uint8_t)(one & 0xF);
            if (s->i & 1)
                *s->dst++ |= (uint8_t)(nib << 4);
            else
                *s->dst = nib;
            if (one < -8 || one > 7) {
                if (s->nexc >= exc_cap) return -2;
                exc_idx[(size_t)k * exc_cap + s->nexc] = (int32_t)s->i;
                exc_val[(size_t)k * exc_cap + s->nexc] = (int32_t)one;
                s->nexc++;
            }
            s->i++;
        }
    }
    for (int k = 0; k < nstreams; k++) {
        bitpos[k] = st[k].pos;
        counts[k] = st[k].i;
        exc_counts[k] = st[k].nexc;
    }
    return 0;
}

/* Catch-up for a failed handshake that DECODES: walk from `bitpos` one
 * codeword at a time, appending values to vals[], until the position
 * equals an entry of the sorted rec[] array (*match = its index), or
 * >= limit_bit, or the data runs out (both: *match = -1; the caller
 * distinguishes stream end by *pos_out < limit_bit, which is only legal
 * in the FINAL segment).  *steps_out values were written; the caller
 * splices them ahead of the segment's post-convergence span.  Returns 0,
 * or -2 if val_cap would overflow. */
EG_EXPORT int eg_decode_catchup(const uint8_t *data, uint64_t nbits_avail,
                                uint64_t bitpos, uint64_t limit_bit,
                                const uint64_t *rec, size_t rec_len,
                                int32_t *vals, size_t val_cap,
                                int64_t *match, uint64_t *pos_out,
                                uint64_t *steps_out) {
    uint64_t pos = bitpos;
    uint64_t steps = 0;
    size_t r = 0;
    while (pos < limit_bit) {
        while (r < rec_len && rec[r] < pos) r++;
        if (r < rec_len && rec[r] == pos) {
            *match = (int64_t)r;
            *pos_out = pos;
            *steps_out = steps;
            return 0;
        }
        if (steps >= val_cap) return -2;
        int32_t one;
        uint64_t p2 = pos;
        if (eg_decode(data, nbits_avail, &p2, &one, 1) != 0)
            break; /* data ran out: pos is the last reachable start */
        pos = p2;
        vals[steps++] = one;
    }
    *match = -1;
    *pos_out = pos;
    *steps_out = steps;
    return 0;
}

/* Copy `count` 4-bit values between packed nibble planes at arbitrary
 * nibble offsets (value i lives in byte i >> 1, low nibble when i is
 * even) — the speculative decode's chunk assembly primitive.  Byte-
 * boundary nibbles merge read-modify-write, so adjacent spans may share
 * a byte regardless of write order.  Never reads or writes outside the
 * nibbles' own bytes.  The misaligned case runs a SWAR shift at ~8
 * bytes/iteration. */
EG_EXPORT void nibble_copy(uint8_t *dst, size_t d0,
                           const uint8_t *src, size_t s0, size_t count) {
    if (!count) return;
    if (d0 & 1) { /* head: align dst to a byte boundary */
        uint8_t v = (uint8_t)((src[s0 >> 1] >> ((s0 & 1) * 4)) & 0xF);
        dst[d0 >> 1] = (uint8_t)((dst[d0 >> 1] & 0x0F) | (v << 4));
        d0++;
        s0++;
        if (!--count) return;
    }
    uint8_t *d = dst + (d0 >> 1);
    const uint8_t *p = src + (s0 >> 1);
    size_t nb = count >> 1; /* full destination bytes */
    if (!(s0 & 1)) { /* aligned: whole bytes + optional tail nibble */
        memcpy(d, p, nb);
        if (count & 1)
            d[nb] = (uint8_t)((d[nb] & 0xF0) | (p[nb] & 0xF));
        return;
    }
    /* misaligned: dst byte j = (p[j] >> 4) | (p[j+1] << 4) */
    size_t j = 0;
#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    const uint64_t M = 0x0F0F0F0F0F0F0F0Full;
    for (; j + 8 <= nb; j += 8) {
        uint64_t x, y, o;
        memcpy(&x, p + j, 8);
        memcpy(&y, p + j + 1, 8);
        o = ((x >> 4) & M) | ((y & M) << 4);
        memcpy(d + j, &o, 8);
    }
#endif
    for (; j < nb; j++)
        d[j] = (uint8_t)((p[j] >> 4) | (uint8_t)(p[j + 1] << 4));
    if (count & 1)
        d[nb] = (uint8_t)((d[nb] & 0xF0) | (p[nb] >> 4));
}

/* Scan without materializing values: returns the bit position after
 * skipping n codewords, or UINT64_MAX if the stream ran out.  Used by the
 * parallel decoder to find GOP bit boundaries cheaply (codec/decoder.py).
 *
 * Fast path drains MANY codewords per 64-bit window load (typical widths
 * are 1-3 bits, so ~20 codewords per load) instead of reloading per
 * codeword — ~5x the naive per-codeword scan. */
EG_EXPORT uint64_t eg_scan(const uint8_t *data, uint64_t nbits_avail,
                           uint64_t bitpos, size_t n) {
    uint64_t pos = bitpos;
    size_t i = 0;
    size_t cap_bytes = (size_t)(nbits_avail >> 3); /* whole bytes only */
    while (i < n) {
        /* branchless fast walk: exactly 4 table steps per 64-bit window
         * (4*EG_WIN = 56 bits always available; stalled steps are no-ops)
         * — the per-hit exit branches of the careful walk below mispredict
         * every few hits and dominate its cost. */
        while (i + 4 * EG_WIN <= n && (pos >> 3) + 8 <= cap_bytes) {
            uint64_t w = load_be64(data + (size_t)(pos >> 3)) << (pos & 7);
            int used = 0;
            for (int s = 0; s < 4; s++) {
                unsigned m = g_scan_meta[(w << used) >> (64 - EG_WIN)];
                i += m >> 8;
                used += (int)(m & 0xFF);
            }
            if (!used) break; /* wide codeword / long zero run */
            pos += (uint64_t)used;
        }
        if (i >= n) break;
        size_t byte = (size_t)(pos >> 3);
        if (byte + 8 <= cap_bytes) {
            uint64_t w = load_be64(data + byte) << (pos & 7);
            int avail = 64 - (int)(pos & 7);
            int used = 0;
            /* careful walk: window tail / the last few values */
            while (used + EG_WIN <= avail) {
                unsigned m = g_scan_meta[(w << used) >> (64 - EG_WIN)];
                unsigned cnt = m >> 8;
                if (!cnt || i + cnt > n) break;
                used += (int)(m & 0xFF);
                i += cnt;
            }
            while (i < n) {
                uint64_t ww = w << used;
                if (ww == 0) break; /* zero run continues past the window */
                int lz = __builtin_clzll(ww);
                int width = 2 * lz + 1;
                if (used + width > avail) break;
                used += width;
                i++;
            }
            if (used > 0) {
                pos += (uint64_t)used;
                continue;
            }
        }
        /* slow path: one codeword bit by bit (window tail / long zero run) */
        int zeros = 0;
        while (1) {
            if (pos >= nbits_avail) return UINT64_MAX;
            uint8_t b = data[pos >> 3];
            int off = (int)(pos & 7);
            uint8_t rest = (uint8_t)(b << off);
            if (rest != 0) {
                int lz = __builtin_clz((uint32_t)rest) - 24;
                int in_byte = 8 - off;
                if (lz < in_byte) { zeros += lz; pos += (uint64_t)lz; break; }
            }
            zeros += 8 - off;
            pos += (uint64_t)(8 - off);
        }
        pos += (uint64_t)(zeros + 1);
        if (pos > nbits_avail) return UINT64_MAX;
        i++;
    }
    return pos;
}

/* Scan ONE codeword at *pos; 1 = ok (*pos advanced), 0 = data ran out. */
static inline int eg_scan_one(const uint8_t *data, uint64_t nbits_avail,
                              size_t cap_bytes, uint64_t *pos) {
    uint64_t p = *pos;
    size_t byte = (size_t)(p >> 3);
    if (byte + 8 <= cap_bytes) {
        uint64_t w = load_be64(data + byte) << (p & 7);
        if (w != 0) {
            int lz = __builtin_clzll(w);
            int width = 2 * lz + 1;
            if (width <= 64 - (int)(p & 7) &&
                p + (uint64_t)width <= nbits_avail) {
                *pos = p + (uint64_t)width;
                return 1;
            }
        }
    }
    /* bit-by-bit (window tail / long zero run / buffer end) */
    int zeros = 0;
    while (1) {
        if (p >= nbits_avail) return 0;
        uint8_t b = data[p >> 3];
        int off = (int)(p & 7);
        uint8_t rest = (uint8_t)(b << off);
        if (rest != 0) {
            int lz = __builtin_clz((uint32_t)rest) - 24;
            int in_byte = 8 - off;
            if (lz < in_byte) {
                zeros += lz;
                p += (uint64_t)lz;
                break;
            }
        }
        zeros += 8 - off;
        p += (uint64_t)(8 - off);
    }
    p += (uint64_t)(zeros + 1);
    if (p > nbits_avail) return 0;
    *pos = p;
    return 1;
}

/* ------------------------------------------------------------------ */
/* Speculative segment scan (parallel boundary discovery for the       */
/* headerless stream).  Walk codewords from `bitpos` — ASSUMED to be a */
/* codeword start; workers guess byte boundaries and the Python stitch */
/* validates by position-handshake — until the first start >= end_bit. */
/*                                                                     */
/* Records the first rec_cap visited start positions in rec[] (the     */
/* handshake targets: if the TRUE walk enters this segment at rec[j],  */
/* the true walk from there IS this walk, exactly), and a              */
/* (count, position) checkpoint whenever the codeword count crosses a  */
/* multiple of 1 << ckpt_shift (boundary lookup later rescans at most  */
/* one checkpoint interval).  ckpt_shift must be >= 6 (one window      */
/* consumes < 64 codewords, so at most one crossing per step).         */
/*                                                                     */
/* Returns the exit position (first start >= end_bit) and the count of */
/* starts visited in [bitpos, exit) via *count_out.  If the data runs  */
/* out first (final segment / truncated stream), returns the last      */
/* reachable start with the count up to it.                            */
/* ------------------------------------------------------------------ */
EG_EXPORT uint64_t eg_scan_segment(const uint8_t *data, uint64_t nbits_avail,
                                   uint64_t bitpos, uint64_t end_bit,
                                   uint64_t *rec, size_t rec_cap,
                                   uint64_t *ckpt_cnt, uint64_t *ckpt_pos,
                                   size_t ckpt_cap, int ckpt_shift,
                                   uint64_t *count_out) {
    uint64_t pos = bitpos;
    uint64_t cnt = 0;
    size_t cap_bytes = (size_t)(nbits_avail >> 3);
    if (ckpt_cap > 0) {
        ckpt_cnt[0] = 0;
        ckpt_pos[0] = bitpos;
    }
    /* phase 1: per-codeword walk recording the handshake positions */
    while (cnt < rec_cap && pos < end_bit) {
        rec[cnt] = pos;
        if (!eg_scan_one(data, nbits_avail, cap_bytes, &pos)) {
            *count_out = cnt;
            return pos;
        }
        cnt++;
    }
    /* phase 2: branchless fast windows with checkpoint recording */
    while (pos < end_bit) {
        while (pos + 4 * EG_WIN <= end_bit &&
               (pos >> 3) + 8 <= cap_bytes) {
            uint64_t w = load_be64(data + (size_t)(pos >> 3)) << (pos & 7);
            int used = 0;
            uint64_t cnt0 = cnt, pos0 = pos;
            for (int s = 0; s < 4; s++) {
                unsigned m = g_scan_meta[(w << used) >> (64 - EG_WIN)];
                cnt += m >> 8;
                used += (int)(m & 0xFF);
            }
            if (!used) break; /* wide codeword / long zero run */
            pos += (uint64_t)used;
            if ((cnt0 >> ckpt_shift) != (cnt >> ckpt_shift)) {
                uint64_t t = (cnt0 >> ckpt_shift) + 1;
                if (t < ckpt_cap) {
                    ckpt_cnt[t] = cnt0;
                    ckpt_pos[t] = pos0;
                }
            }
        }
        if (pos >= end_bit) break;
        /* careful: one codeword (window tail / stall / near end_bit) */
        uint64_t pos0 = pos;
        if (!eg_scan_one(data, nbits_avail, cap_bytes, &pos)) {
            *count_out = cnt;
            return pos0;
        }
        if (((cnt >> ckpt_shift) != ((cnt + 1) >> ckpt_shift))) {
            uint64_t t = (cnt >> ckpt_shift) + 1;
            if (t < ckpt_cap) {
                ckpt_cnt[t] = cnt;
                ckpt_pos[t] = pos0;
            }
        }
        cnt++;
    }
    *count_out = cnt;
    return pos;
}

/* Catch-up walk for a failed handshake: scan from `bitpos` one codeword
 * at a time until the position equals an entry of the sorted rec[] array
 * (returns its index via *match, position unchanged semantics: *pos_out =
 * converged position) or until >= limit_bit (returns -1 via *match,
 * *pos_out = first start >= limit_bit).  *steps_out = codewords consumed
 * from bitpos to *pos_out.  Returns 0, or -1 if the data ran out. */
EG_EXPORT int eg_scan_catchup(const uint8_t *data, uint64_t nbits_avail,
                              uint64_t bitpos, uint64_t limit_bit,
                              const uint64_t *rec, size_t rec_len,
                              int64_t *match, uint64_t *pos_out,
                              uint64_t *steps_out) {
    uint64_t pos = bitpos;
    uint64_t steps = 0;
    size_t cap_bytes = (size_t)(nbits_avail >> 3);
    size_t r = 0;
    while (pos < limit_bit) {
        while (r < rec_len && rec[r] < pos) r++;
        if (r < rec_len && rec[r] == pos) {
            *match = (int64_t)r;
            *pos_out = pos;
            *steps_out = steps;
            return 0;
        }
        if (!eg_scan_one(data, nbits_avail, cap_bytes, &pos)) return -1;
        steps++;
    }
    *match = -1;
    *pos_out = pos;
    *steps_out = steps;
    return 0;
}

/* ------------------------------------------------------------------ */
/* PNG scanline unfiltering (spec 4.5.2): sequential per pixel, so it */
/* lives here at memory speed (io/png.py's reader calls it; the       */
/* Python fallback is only for hosts without a compiler).             */
/* raw: h*(stride+1) filtered bytes; out: h*stride.  Returns 0, or    */
/* -1 on an invalid filter type.                                      */
/* ------------------------------------------------------------------ */
EG_EXPORT int png_unfilter(const uint8_t *raw, size_t h, size_t stride,
                           int bpp, uint8_t *out) {
    const uint8_t *prev = NULL;
    for (size_t y = 0; y < h; y++) {
        uint8_t ftype = raw[y * (stride + 1)];
        const uint8_t *line = raw + y * (stride + 1) + 1;
        uint8_t *cur = out + y * stride;
        switch (ftype) {
        case 0:
            memcpy(cur, line, stride);
            break;
        case 1: /* Sub */
            for (size_t x = 0; x < stride; x++) {
                uint8_t a = x >= (size_t)bpp ? cur[x - bpp] : 0;
                cur[x] = (uint8_t)(line[x] + a);
            }
            break;
        case 2: /* Up */
            for (size_t x = 0; x < stride; x++)
                cur[x] = (uint8_t)(line[x] + (prev ? prev[x] : 0));
            break;
        case 3: /* Average */
            for (size_t x = 0; x < stride; x++) {
                int a = x >= (size_t)bpp ? cur[x - bpp] : 0;
                int b = prev ? prev[x] : 0;
                cur[x] = (uint8_t)(line[x] + ((a + b) >> 1));
            }
            break;
        case 4: /* Paeth */
            for (size_t x = 0; x < stride; x++) {
                int a = x >= (size_t)bpp ? cur[x - bpp] : 0;
                int b = prev ? prev[x] : 0;
                int c = (prev && x >= (size_t)bpp) ? prev[x - bpp] : 0;
                int p = a + b - c;
                int pa = p > a ? p - a : a - p;
                int pb = p > b ? p - b : b - p;
                int pc = p > c ? p - c : c - p;
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                cur[x] = (uint8_t)(line[x] + pred);
            }
            break;
        default:
            return -1;
        }
        prev = cur;
    }
    return 0;
}

/* Cache-blocked byte-matrix transpose: out[c * rows + r] = in[r * cols + c].
 * The turbo wire stores the coefficient-pair-major TRANSPOSE of the device
 * transport's (cubes, cube/2) nibble plane (codec/turbo.py); numpy's strided
 * transpose copy runs ~3 ns/byte on the 1080p plane, the blocked form well
 * under 1. ctypes releases the GIL for the call, so the per-member drain
 * pool overlaps transposes across cores. */
void byte_transpose(const uint8_t *in, size_t rows, size_t cols,
                    uint8_t *out) {
    const size_t B = 128;
    for (size_t r0 = 0; r0 < rows; r0 += B) {
        size_t r1 = r0 + B < rows ? r0 + B : rows;
        for (size_t c0 = 0; c0 < cols; c0 += B) {
            size_t c1 = c0 + B < cols ? c0 + B : cols;
            for (size_t c = c0; c < c1; ++c) {
                uint8_t *o = out + c * rows + r0;
                const uint8_t *i = in + r0 * cols + c;
                for (size_t r = r0; r < r1; ++r, i += cols)
                    *o++ = *i;
            }
        }
    }
}
