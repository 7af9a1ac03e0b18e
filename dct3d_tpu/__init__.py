"""dct3d_tpu — a 3D-DCT video codec on an accelerator (JAX/XLA).

A from-scratch JAX/XLA re-design of the capabilities of
julianopiccoli/3dDCTVideoEncoding (see SURVEY.md): 8-frame GOPs transformed in
8x8x8 cubes by a 3D DCT, quantized with the analytic quantization function,
serialized in 3D diagonal-slice (zigzag) order, entropy-coded with signed
Exp-Golomb and DEFLATE-compressed — with the transform chain folded into
single matmuls, device-side parallel bit packing, and shard_map scale-out
over GOP/tile meshes.
"""

from .config import CodecConfig, DEFAULT_CONFIG
from .codec.encoder import StreamingEncoder, encode_stream, encode_video
from .codec.auto import decode_auto, decode_auto_range
from .codec.turbo import decode_turbo_container, encode_turbo_video
from .codec.decoder import StreamingDecoder, decode_stream, decode_video
from .codec.checkpoint import CheckpointingEncoder
from .codec.rgb_codec import decode_rgb_video, encode_rgb_video
from .codec.transform import TransformContext
from .metrics import psnr, bits_per_pixel
from .profiling import StageTimer

__version__ = "0.1.0"

__all__ = [
    "CodecConfig",
    "DEFAULT_CONFIG",
    "CheckpointingEncoder",
    "StreamingEncoder",
    "StreamingDecoder",
    "StageTimer",
    "TransformContext",
    "encode_video",
    "decode_video",
    "decode_auto",
    "decode_auto_range",
    "encode_turbo_video",
    "decode_turbo_container",
    "encode_rgb_video",
    "decode_rgb_video",
    "encode_stream",
    "decode_stream",
    "psnr",
    "bits_per_pixel",
    "__version__",
]
