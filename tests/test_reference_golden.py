"""Golden parity against the reference's OWN compiled C code.

The reference's entropy layer and zigzag enumeration are plain C with no
OpenCL dependency (reference: 3d-DCT-video-encoding-OpenCL/ExpGolomb.c:32-110,
CubeUtils.c:5-46).  These tests compile them verbatim from /root/reference at
test time and drive them via ctypes, so byte parity no longer rests solely on
oracle.py being a correct transliteration (SURVEY.md §4 item 3):

  * the reference WRITER's bytes   == our encoder's bytes,
  * the reference READER reads our production (device-packed) bitstream,
  * our reader reads reference-written streams,
  * the reference's diagonalSlices == our zigzag tables, element by element.

Skipped (not failed) when the reference tree or a C compiler is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np
import pytest

REF = "/root/reference/3d-DCT-video-encoding-OpenCL"
_BUILD = os.path.join(os.path.dirname(__file__), "_build")


class _Coord(ctypes.Structure):
    _fields_ = [("x", ctypes.c_int), ("y", ctypes.c_int), ("z", ctypes.c_int)]


class _SlicesPositions(ctypes.Structure):
    _fields_ = [("positions", ctypes.POINTER(_Coord)), ("length", ctypes.c_int)]


class _EGStream(ctypes.Structure):
    _fields_ = [
        ("buffer", ctypes.c_char_p),
        ("bitPosition", ctypes.c_int),
        ("bufferPosition", ctypes.c_int),
    ]


@pytest.fixture(scope="module")
def reflib():
    """Compile the reference's ExpGolomb.c + CubeUtils.c into a test .so."""
    srcs = [os.path.join(REF, "ExpGolomb.c"), os.path.join(REF, "CubeUtils.c")]
    if not all(os.path.exists(s) for s in srcs):
        pytest.skip("reference tree not available")
    os.makedirs(_BUILD, exist_ok=True)
    so = os.path.join(_BUILD, "libref_golden.so")
    if not os.path.exists(so) or any(
        os.path.getmtime(s) > os.path.getmtime(so) for s in srcs
    ):
        try:
            subprocess.run(
                ["cc", "-O2", "-shared", "-fPIC", "-o", so, *srcs],
                check=True, capture_output=True,
            )
        except (OSError, subprocess.CalledProcessError) as e:  # pragma: no cover
            pytest.skip(f"cannot compile reference C: {e}")
    lib = ctypes.CDLL(so)
    lib.expGolomb_createStream.restype = ctypes.POINTER(_EGStream)
    lib.expGolomb_createStream.argtypes = [ctypes.c_char_p]
    lib.expGolomb_writeValue.argtypes = [ctypes.POINTER(_EGStream), ctypes.c_int]
    lib.expGolomb_readValue.restype = ctypes.c_int
    lib.expGolomb_readValue.argtypes = [ctypes.POINTER(_EGStream)]
    lib.cubeUtils_diagonalSlices.restype = ctypes.POINTER(_SlicesPositions)
    lib.cubeUtils_diagonalSlices.argtypes = [ctypes.c_int] * 3
    return lib


def _ref_write(lib, values) -> tuple[bytes, int]:
    """Drive the reference writer; returns (bytes incl. partial, bit length).

    The reference relies on the caller's buffer byte 0 starting zeroed
    (encoder.c mallocs it; writeValue only zeroes bytes it advances into) —
    we use a zero-initialized buffer like a correct caller.
    """
    buf = ctypes.create_string_buffer(len(values) * 8 + 16)  # zeroed
    stream = lib.expGolomb_createStream(ctypes.cast(buf, ctypes.c_char_p))
    for v in values:
        lib.expGolomb_writeValue(stream, int(v))
    s = stream.contents
    nbits = s.bufferPosition * 8 + (8 - s.bitPosition)
    out = bytes(buf[: (nbits + 7) // 8])
    return out, nbits


def _ref_read(lib, data: bytes, n: int) -> np.ndarray:
    buf = ctypes.create_string_buffer(bytes(data), len(data) + 16)
    stream = lib.expGolomb_createStream(ctypes.cast(buf, ctypes.c_char_p))
    return np.array(
        [lib.expGolomb_readValue(stream) for _ in range(n)], np.int32
    )


def _sample_values(rng, n=4096) -> np.ndarray:
    """Coefficient-like mix: mostly tiny, some huge, all edge cases."""
    vals = rng.integers(-6, 7, size=n).astype(np.int32)
    hot = rng.integers(0, n, size=n // 16)
    vals[hot] = rng.integers(-6000, 6001, size=hot.size)
    vals[:8] = [0, 1, -1, 2, -2, 255, -255, 5772]
    return vals


def test_reference_writer_byte_parity(reflib, rng):
    """Our host encoder emits byte-for-byte what the reference's C writes."""
    from dct3d_tpu.codec import entropy

    values = _sample_values(rng)
    ref_bytes, ref_bits = _ref_write(reflib, values)
    ours, our_bits = entropy.encode_values(values)
    assert our_bits == ref_bits
    assert ours == ref_bytes


def test_reference_reader_reads_device_packed_stream(reflib, rng):
    """The reference's own C reader decodes our production bitstream.

    Full pipeline witness: frames -> device (CPU-jax) encode with the device
    bit-packer -> zlib inflate -> reference expGolomb_readValue -> compare
    with independently computed quantized coefficients."""
    import zlib

    from dct3d_tpu import oracle
    from dct3d_tpu.codec.encoder import encode_video
    from dct3d_tpu.config import CodecConfig

    from conftest import synthetic_video

    cfg = CodecConfig()  # parity mode: serial sink
    clip = synthetic_video(8, 32, 40, seed=3)
    data = encode_video(clip, cfg)
    payload = zlib.decompress(data)
    want = oracle.quantized_coefficients(clip, cfg).reshape(-1)
    got = _ref_read(reflib, payload, want.size)
    np.testing.assert_array_equal(got, want)


def test_our_reader_reads_reference_stream(reflib, rng):
    """Round-trip the other way: reference writer -> our native decoder."""
    from dct3d_tpu.codec import entropy

    values = _sample_values(rng, n=2000)
    ref_bytes, ref_bits = _ref_write(reflib, values)
    got, pos = entropy.decode_values(ref_bytes, values.size)
    assert pos == ref_bits
    np.testing.assert_array_equal(got, values)


@pytest.mark.parametrize("dims", [(8, 8, 8), (4, 4, 4), (8, 4, 2), (2, 8, 5)])
def test_reference_zigzag_order(reflib, dims):
    """cubeUtils_diagonalSlices(w,h,d) == our table, element by element."""
    from dct3d_tpu.ops import zigzag

    w, h, d = dims
    sp = reflib.cubeUtils_diagonalSlices(w, h, d).contents
    ref = np.array(
        [(sp.positions[i].x, sp.positions[i].y, sp.positions[i].z)
         for i in range(sp.length)],
        np.int32,
    )
    ours = zigzag.diagonal_slices(w, h, d)
    assert sp.length == w * h * d
    np.testing.assert_array_equal(ref, ours)
