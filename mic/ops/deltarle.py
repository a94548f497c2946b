"""Fused predictor + RLE pipelines (the L3 layer of the codec).

Stream layout (deltarlecompressu16.go:24-67): an RLE stream whose Init
maxValue word is the *delimiter* for the pixel depth, and whose first
encoded symbol is the image's true maxValue, followed by the escaped
residual symbols.  No length prefix — the decoder pulls symbols until the
pixel raster is filled.

Decode here is the two-pass shape used by the reference C decoder and the
device path: full RLE expansion, then vectorized predictor inversion.
"""

from __future__ import annotations

import numpy as np

from .predictors import (
    delta_params,
    parse_escaped,
    predictor_decode,
    predictor_encode,
    zigzag,
    unzigzag,
)
from .rle import RleEncoder, rle_decompress_stream

__all__ = [
    "delta_rle_compress",
    "delta_rle_decompress",
    "grad_delta_rle_compress",
    "grad_delta_rle_decompress",
    "zz_delta_rle_compress",
    "zz_delta_rle_decompress",
]


def _fused_compress(img, width: int, height: int, max_value: int, kind: str) -> np.ndarray:
    thr, delim = delta_params(max_value)
    if kind == "zz":
        img2 = np.asarray(img, dtype=np.uint16).reshape(height, width)
        p = img2.astype(np.int64)
        left = np.zeros_like(p)
        left[:, 1:] = p[:, :-1]
        diff = p - left
        escape = np.abs(diff) >= thr
        coded = zigzag(diff.astype(np.int16)).ravel()
        from .predictors import _interleave_escapes

        stream = _interleave_escapes(coded, img2.ravel(), escape.ravel(), delim)
    else:
        stream = predictor_encode(img, width, height, max_value, kind)

    rle = RleEncoder(width, height, delim)
    enc = rle.encode
    enc(int(max_value))
    for v in stream.tolist():
        enc(v)
    rle.flush()
    return np.array(rle.out, dtype=np.uint16)


def _fused_decompress(stream, width: int, height: int, kind: str) -> np.ndarray:
    symbols, _mid = rle_decompress_stream(stream)
    max_value = int(symbols[0])
    _, delim = delta_params(max_value)
    values, is_raw = parse_escaped(symbols[1:], delim, width * height)
    return predictor_decode(values, is_raw, width, height, max_value, kind).ravel()


def delta_rle_compress(img, width, height, max_value) -> np.ndarray:
    """Reference DeltaRleCompressU16.Compress (deltarlecompressu16.go:24)."""
    return _fused_compress(img, width, height, max_value, "avg")


def delta_rle_decompress(stream, width, height) -> np.ndarray:
    """Reference DeltaRleDecompressU16.Decompress (deltarlecompressu16.go:69)."""
    return _fused_decompress(stream, width, height, "avg")


def grad_delta_rle_compress(img, width, height, max_value) -> np.ndarray:
    """Reference GradDeltaRleCompressU16 (deltagradrlecompressu16.go:26)."""
    return _fused_compress(img, width, height, max_value, "grad")


def grad_delta_rle_decompress(stream, width, height) -> np.ndarray:
    """Reference GradDeltaRleDecompressU16 (deltagradrlecompressu16.go:71)."""
    return _fused_decompress(stream, width, height, "grad")


def zz_delta_rle_compress(img, width, height, max_value) -> np.ndarray:
    """Reference DeltaRleZZU16.Compress (deltazzrlecompressu16.go:15)."""
    return _fused_compress(img, width, height, max_value, "zz")


def zz_delta_rle_decompress(stream, width, height) -> np.ndarray:
    """Reference DeltaRleZZU16.Decompress (deltazzrlecompressu16.go:49)."""
    return _fused_decompress(stream, width, height, "zz")
