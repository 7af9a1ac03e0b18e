"""Codec configuration.

The reference hardcodes its parameters across several places: cube dims 8x8x8
(reference: 3d-DCT-video-encoding/src/br/jpiccoli/video/Encoder.java:28-30,
3d-DCT-video-encoding-OpenCL/codec.h:11-13), quantization strength 5
(Encoder.java:82, encoder.c:53), GOP depth = cube depth = 8, and zlib level
(Java: default; C: Z_BEST_COMPRESSION, encoder.c:139).  Here everything flows
from one frozen dataclass shared by encoder and decoder (SURVEY.md §5 "Config").
"""

from __future__ import annotations

import dataclasses
import zlib


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Parameters of the 3D-DCT codec.

    Attributes:
      block_w / block_h / block_d: DCT cube dimensions (x, y, z=temporal).
        The reference supports lowering 8 -> 4 for weak GPUs (README.md:20).
      quant_strength: the ``q`` of the analytic quantizer
        ``round(c / max(1, q * (i + j + k)))`` (Encoder.java:82).
      zlib_level: DEFLATE level for the output stream. 9 matches the C
        encoder's Z_BEST_COMPRESSION; lower levels trade bpp for speed.
        Any level yields a bitstream the reference decoder can read.
      compute_dtype: dtype of the on-device transform matmuls.  float32 is
        the parity profile: quantized integers equal the float64 oracle's
        (SURVEY.md §7 "hard parts" #3), for which the encode matmul runs in
        float64 (codec/transform.encode_dtype) and decode in float32;
        bfloat16 is available for a fast, lower-fidelity profile.
    """

    block_w: int = 8
    block_h: int = 8
    block_d: int = 8
    quant_strength: int = 5
    zlib_level: int = zlib.Z_BEST_COMPRESSION
    compute_dtype: str = "float32"
    #: DEFLATE worker threads. 0 = serial sink whose stream is byte-identical
    #: to the reference's one-shot deflate (parity mode); -1 = all cores but
    #: one; N>0 = exactly N.  Parallel streams are still a single valid zlib
    #: stream (pigz-style full-flush blocks) that the reference decoder reads.
    deflate_workers: int = 0
    #: Static per-GROUP bit-pack buffer budget, bits per coefficient (sets
    #: the level-1 buffer width).  Typical streams need 1-2; a smaller
    #: budget means less level-1 work at identical bytes.  Pathological
    #: batches that exceed it are
    #: retried automatically with a worst-case buffer, and after 2
    #: consecutive overflow retries the drivers climb a budget LADDER
    #: (this value -> 6 -> worst case) permanently, so noisy content
    #: settles instead of double-encoding forever (codec/encoder.py).
    pack_bits_per_value: int = 4
    #: Whole-STREAM packed-output buffer budget, bits per coefficient.
    #: Level-2 placement cost (and the packed buffer itself) scales with
    #: this static size, so it is kept tighter than the per-group budget:
    #: whole-stream averages are stable (~1.2 bits/value on typical content,
    #: ~3.3 on pure noise at quant 5).  None derives the default: 2 when
    #: quant_strength >= 2 (bytes unchanged), else pack_bits_per_value
    #: (near-lossless streams genuinely run wide).  Overflow retries the
    #: batch with the worst-case buffer, and the streaming drivers widen
    #: permanently after repeated retries so noisy content settles instead
    #: of double-encoding forever.
    stream_bits_per_value: int | None = None
    #: Ship frames to the device as wrapping mod-256 temporal deltas and
    #: reconstruct on device (exact; bitstream unchanged).  Can only pay
    #: off where the host<->device transport compresses its traffic (video
    #: deltas are near-zero); plain PCIe does not.
    transport_delta: bool = False
    #: Turbo-profile payload codec.  "zstd" (default) is smaller and faster
    #: to compress and inflate than DEFLATE level 6 on the nibble plane;
    #: "zlib" keeps the wire stdlib-only.  Decode sniffs the per-stream
    #: magic, so either setting reads either wire; if the zstandard module
    #: is absent, encode falls back to zlib.  Reference-profile streams
    #: are unaffected.
    turbo_codec: str = "zstd"
    #: zstd level for the turbo payload (wire-layout-neutral knob; decode
    #: sniffs, so any level reads any wire).  3 is the SPEED knee:
    #: compress runs several times faster than level 10 for a few percent
    #: more bytes, and the host drain bounds end-to-end turbo throughput.
    #: 10 is the rate knee (the old default), 19 archival.
    turbo_zstd_level: int = 3
    #: Quantizer rounding bias: q = sign(c)*floor(|c|/div + bias).  0.5 is
    #: the reference's round-half-away (Encoder.java:82, encoder.c:53);
    #: smaller values give a deadzone quantizer — an encoder-side-only
    #: rate-distortion knob (the bitstream stays reference-decodable).
    quant_bias: float = 0.5

    @property
    def stream_budget_bits_per_value(self) -> int:
        """Resolved whole-stream buffer budget (see stream_bits_per_value)."""
        if self.stream_bits_per_value is not None:
            return self.stream_bits_per_value
        return 2 if self.quant_strength >= 2 else self.pack_bits_per_value

    @property
    def gop_size(self) -> int:
        """Frames per group-of-pictures (== temporal cube depth)."""
        return self.block_d

    @property
    def cube_size(self) -> int:
        return self.block_w * self.block_h * self.block_d

    @property
    def face_size(self) -> int:
        return self.block_w * self.block_h

    def validate_geometry(self, width: int, height: int) -> None:
        if width % self.block_w or height % self.block_h:
            raise ValueError(
                f"frame {width}x{height} must be a multiple of the "
                f"{self.block_w}x{self.block_h} block (reference requires the "
                "same: CaptureScreen.java:113-118)"
            )

    def cubes_per_gop(self, width: int, height: int) -> int:
        self.validate_geometry(width, height)
        return (width // self.block_w) * (height // self.block_h)


DEFAULT_CONFIG = CodecConfig()
