"""mic — lossless medical image codec with a GPU device tier.

A ground-up JAX/XLA/Pallas rebuild of the MIC codec family
(pappuks/medical-image-codec): lossless compression for 10–16-bit DICOM
medical images via spatial prediction → 16-bit RLE → large-alphabet
FSE/tANS (1/2/4/8 interleaved states), rANS, or canonical Huffman entropy
coding, with MIC1/MIC2/MIC3/MICR/PICS/PICA container formats.

Tiers:

* ``mic.ops`` / ``mic.models`` — host reference tier (vectorized
  numpy), byte-compatible with the reference stream formats.
* ``mic.native`` — C++ fast host tier (ctypes).
* ``mic.device`` — the device tier: the wide-lane interleaved rANS
  device format, its entropy kernel and decode plan, sharded over
  devices with shard_map.
* ``mic.parallel`` — PICS/PICA strips, MIC2 multi-frame, MIC3 WSI.

Public API mirrors the reference Go surface in snake_case; the original
names are provided as aliases for discoverability.
"""

from .ops.fse import IncompressibleError, UseRLEError  # noqa: F401
from .ops.fse_codec import (  # noqa: F401
    ScratchU16,
    fse_compress,
    fse_compress_2state,
    fse_compress_4state,
    fse_compress_8state,
    fse_decompress,
    fse_decompress_2state,
    fse_decompress_4state,
    fse_decompress_8state,
    fse_decompress_auto,
)
from .ops.rans import rans_compress_8state, rans_decompress_8state  # noqa: F401
from .ops.huffman import can_huffman_compress, can_huffman_decompress  # noqa: F401
from .ops.rle import rle_compress, rle_decompress  # noqa: F401
from .ops.deltarle import (  # noqa: F401
    delta_rle_compress,
    delta_rle_decompress,
    grad_delta_rle_compress,
    grad_delta_rle_decompress,
    zz_delta_rle_compress,
    zz_delta_rle_decompress,
)
from .ops.predictors import (  # noqa: F401
    delta_compress,
    delta_decompress,
    delta_zz_compress,
    delta_zz_decompress,
    grad_delta_compress,
    grad_delta_decompress,
    med_delta_compress,
    med_delta_decompress,
    temporal_delta_decode,
    temporal_delta_encode,
    unzigzag,
    zigzag,
)
from .models.single_frame import (  # noqa: F401
    compress_residual_frame,
    compress_single_frame_huffman,
    decompress_single_frame_huffman,
    compress_single_frame,
    compress_single_frame_4state,
    compress_single_frame_8state,
    compress_single_frame_grad,
    compress_single_frame_rans8,
    decompress_residual_frame,
    decompress_single_frame,
    decompress_single_frame_grad,
    decode_frame,
)

# Reference-name aliases (Go API surface).
FSECompressU16 = fse_compress
FSEDecompressU16 = fse_decompress
FSECompressU16TwoState = fse_compress_2state
FSEDecompressU16TwoState = fse_decompress_2state
FSECompressU16FourState = fse_compress_4state
FSEDecompressU16FourState = fse_decompress_4state
FSECompressU16EightState = fse_compress_8state
FSEDecompressU16EightState = fse_decompress_8state
FSEDecompressU16Auto = fse_decompress_auto
RANSCompressU16EightState = rans_compress_8state
RANSDecompressU16EightState = rans_decompress_8state
CompressSingleFrame = compress_single_frame
CompressSingleFrame4State = compress_single_frame_4state
CompressSingleFrame8State = compress_single_frame_8state
CompressSingleFrameGrad = compress_single_frame_grad
DecompressSingleFrame = decompress_single_frame
DecompressSingleFrameGrad = decompress_single_frame_grad
TemporalDeltaEncode = temporal_delta_encode
TemporalDeltaDecode = temporal_delta_decode
ZigZag = zigzag
UnZigZag = unzigzag
CanHuffmanCompressU16 = can_huffman_compress
CanHuffmanDecompressU16 = can_huffman_decompress

__version__ = "0.1.0"
