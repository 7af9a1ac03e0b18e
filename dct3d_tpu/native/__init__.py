"""Native (C) host-side components, built on demand with the system compiler.

The reference's host runtime is C (SURVEY.md §2.2); this codec
keeps the genuinely serial host work — streaming Exp-Golomb decode — in C as
well, compiled once into a shared library and bound via ctypes.
Everything has a pure-Python/NumPy
fallback so the framework degrades gracefully without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

_SRC = os.path.join(os.path.dirname(__file__), "expgolomb.c")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_LIB = os.path.join(_BUILD_DIR, "libexpgolomb.so")

_lib = None
_tried = False


def _build() -> str | None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if not cc:
            continue
        # Build into a temp file then rename, so concurrent builders race
        # safely.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [cc, "-O3", "-fPIC", "-shared", "-o", tmp, _SRC]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, _LIB)
            return _LIB
        except (subprocess.CalledProcessError, FileNotFoundError):
            if os.path.exists(tmp):
                os.unlink(tmp)
            continue
    return None


def load():
    """Return the ctypes library handle, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.eg_encode.restype = ctypes.c_int
        lib.eg_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.eg_decode.restype = ctypes.c_int
        lib.eg_decode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.eg_decode_planar.restype = ctypes.c_int
        lib.eg_decode_planar.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.eg_decode_planar4.restype = ctypes.c_int
        lib.eg_decode_planar4.argtypes = lib.eg_decode_planar.argtypes
        lib.eg_decode_planar4_multi.restype = ctypes.c_int
        lib.eg_decode_planar4_multi.argtypes = [
            ctypes.c_void_p,  # data
            ctypes.c_uint64,  # nbits_avail
            ctypes.c_void_p,  # positions (uint64[nstreams], in/out)
            ctypes.c_int,     # nstreams
            ctypes.c_size_t,  # n per stream
            ctypes.c_void_p,  # planes (nstreams * n/2 bytes)
            ctypes.c_void_p,  # exc_idx (nstreams * exc_cap)
            ctypes.c_void_p,  # exc_val
            ctypes.c_size_t,  # exc_cap
            ctypes.c_void_p,  # exc_counts (uint64[nstreams])
        ]
        lib.eg_decode_planar4_seg_multi.restype = ctypes.c_int
        lib.eg_decode_planar4_seg_multi.argtypes = [
            ctypes.c_void_p,  # data
            ctypes.c_uint64,  # nbits_avail
            ctypes.c_int,     # nstreams
            ctypes.c_void_p,  # bitpos (uint64[nstreams], in/out)
            ctypes.c_void_p,  # end_bits (uint64[nstreams])
            ctypes.c_void_p,  # recs (uint64[nstreams * rec_cap])
            ctypes.c_size_t,  # rec_cap
            ctypes.c_void_p,  # ckpt_cnts (uint64[nstreams * ckpt_cap])
            ctypes.c_void_p,  # ckpt_poss
            ctypes.c_size_t,  # ckpt_cap
            ctypes.c_int,     # ckpt_shift
            ctypes.c_void_p,  # planes (nstreams * plane_stride bytes)
            ctypes.c_size_t,  # plane_stride
            ctypes.c_size_t,  # val_cap
            ctypes.c_void_p,  # exc_idx (nstreams * exc_cap)
            ctypes.c_void_p,  # exc_val
            ctypes.c_size_t,  # exc_cap
            ctypes.c_void_p,  # exc_counts (uint64[nstreams])
            ctypes.c_void_p,  # counts (uint64[nstreams])
        ]
        lib.eg_decode_catchup.restype = ctypes.c_int
        lib.eg_decode_catchup.argtypes = [
            ctypes.c_void_p,  # data
            ctypes.c_uint64,  # nbits_avail
            ctypes.c_uint64,  # bitpos
            ctypes.c_uint64,  # limit_bit
            ctypes.c_void_p,  # rec (sorted uint64[rec_len])
            ctypes.c_size_t,  # rec_len
            ctypes.c_void_p,  # vals (int32[val_cap])
            ctypes.c_size_t,  # val_cap
            ctypes.POINTER(ctypes.c_int64),   # match index or -1
            ctypes.POINTER(ctypes.c_uint64),  # pos_out
            ctypes.POINTER(ctypes.c_uint64),  # steps_out
        ]
        lib.nibble_copy.restype = None
        lib.nibble_copy.argtypes = [
            ctypes.c_void_p,  # dst
            ctypes.c_size_t,  # d0 (nibble index)
            ctypes.c_void_p,  # src
            ctypes.c_size_t,  # s0 (nibble index)
            ctypes.c_size_t,  # count (nibbles)
        ]
        lib.eg_scan.restype = ctypes.c_uint64
        lib.eg_scan.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.c_size_t,
        ]
        lib.eg_scan_segment.restype = ctypes.c_uint64
        lib.eg_scan_segment.argtypes = [
            ctypes.c_void_p,  # data
            ctypes.c_uint64,  # nbits_avail
            ctypes.c_uint64,  # bitpos (speculative segment start)
            ctypes.c_uint64,  # end_bit
            ctypes.c_void_p,  # rec (uint64[rec_cap])
            ctypes.c_size_t,  # rec_cap
            ctypes.c_void_p,  # ckpt_cnt (uint64[ckpt_cap])
            ctypes.c_void_p,  # ckpt_pos
            ctypes.c_size_t,  # ckpt_cap
            ctypes.c_int,     # ckpt_shift
            ctypes.POINTER(ctypes.c_uint64),  # count_out
        ]
        lib.eg_scan_catchup.restype = ctypes.c_int
        lib.eg_scan_catchup.argtypes = [
            ctypes.c_void_p,  # data
            ctypes.c_uint64,  # nbits_avail
            ctypes.c_uint64,  # bitpos
            ctypes.c_uint64,  # limit_bit
            ctypes.c_void_p,  # rec (sorted uint64[rec_len])
            ctypes.c_size_t,  # rec_len
            ctypes.POINTER(ctypes.c_int64),   # match index or -1
            ctypes.POINTER(ctypes.c_uint64),  # pos_out
            ctypes.POINTER(ctypes.c_uint64),  # steps_out
        ]
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.byte_transpose.restype = None
        lib.byte_transpose.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_void_p,
        ]
        _tune_malloc()
        _lib = lib
    except OSError as e:  # pragma: no cover
        print(f"dct3d_tpu: native codec unavailable ({e})", file=sys.stderr)
    return _lib


def _tune_malloc() -> None:
    """Raise glibc's mmap/trim thresholds so the multi-MB per-GOP host
    buffers (decode planes, exception lists, turbo members) are served from
    the reusable heap instead of fresh mmap regions — a fresh 16 MB mapping
    costs ~4000 page faults that serialize on the kernel's mmap lock across
    the decode worker pool (measured ~25% of a pair-decode call).  Traded
    for bounded RSS retention at the high-water mark.  Opt out with
    DCT3D_NO_MALLOPT=1."""
    if os.environ.get("DCT3D_NO_MALLOPT"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 512 << 20)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 512 << 20)  # M_TRIM_THRESHOLD
    except (OSError, AttributeError):  # pragma: no cover - non-glibc hosts
        pass


def byte_transpose(a):
    """Transpose a 2-D uint8 array via the blocked C kernel (GIL released),
    falling back to numpy's strided copy when the library is unavailable."""
    import numpy as np

    lib = load()
    a = np.ascontiguousarray(a, dtype=np.uint8)
    if lib is None:
        return np.ascontiguousarray(a.T)
    out = np.empty((a.shape[1], a.shape[0]), np.uint8)
    lib.byte_transpose(
        a.ctypes.data, a.shape[0], a.shape[1], out.ctypes.data
    )
    return out
