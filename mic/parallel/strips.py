"""PICS — Parallel Image Compressed Strips (reference parallelstrips.go).

A single image splits into N horizontal strips, each an independent
CompressSingleFrame blob, so all strips compress/decompress concurrently.
Format::

    "PICS" | width u32 | height u32 | numStrips u32 | stripHeight u32
    offset table: numStrips x [offset u32, length u32]
    concatenated strip blobs

Ratio cost is only the strip-boundary rows (~0.1–1.2% for 2–16 strips,
parallelstrips.go:31-39).

On the host tier, strips run on a thread pool.  On the device tier the strip
axis is the *device batch axis*: mic.device decodes all strips of an
image (or many images) in one sharded device program.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..models.single_frame import (
    compress_single_frame,
    compress_single_frame_4state,
    compress_single_frame_8state,
    decompress_single_frame,
)

__all__ = [
    "compress_parallel_strips",
    "compress_parallel_strips_4state",
    "compress_parallel_strips_8state",
    "decompress_parallel_strips",
    "pics_strip_blobs",
]

PICS_MAGIC = b"PICS"
PICS_HEADER_BASE = 20


def _strip_plan(height: int, num_strips: int) -> tuple[int, int]:
    strip_h = (height + num_strips - 1) // num_strips
    actual = (height + strip_h - 1) // strip_h
    return strip_h, actual


def _compress_strips(pixels, width, height, max_value, num_strips, frame_compress,
                     n_states=0) -> bytes:
    pixels = np.asarray(pixels, dtype=np.uint16)
    if len(pixels) != width * height:
        raise ValueError(
            f"parallelstrips: pixel count {len(pixels)} != width*height {width * height}"
        )
    if num_strips <= 0:
        num_strips = os.cpu_count() or 1
    num_strips = max(1, min(num_strips, height))
    if n_states:
        # Native whole-container path: std::thread strip pool, no GIL —
        # byte-identical to the per-strip assembly below (pinned by
        # tests/test_native.py); None falls through to the Python tier.
        from ..native import compress_strips_native

        blob = compress_strips_native(pixels, width, height, max_value,
                                      n_states=n_states,
                                      num_strips=num_strips)
        if blob is not None:
            return blob
    strip_h, actual = _strip_plan(height, num_strips)

    def one(idx: int) -> bytes:
        y0 = idx * strip_h
        y1 = min(y0 + strip_h, height)
        return frame_compress(pixels[y0 * width : y1 * width], width, y1 - y0, max_value)

    with ThreadPoolExecutor(max_workers=min(actual, os.cpu_count() or 1)) as ex:
        results = list(ex.map(one, range(actual)))

    header = bytearray()
    header += PICS_MAGIC
    header += struct.pack("<IIII", width, height, actual, strip_h)
    offset = 0
    for r in results:
        header += struct.pack("<II", offset, len(r))
        offset += len(r)
    return bytes(header) + b"".join(results)


def compress_parallel_strips(pixels, width, height, max_value, num_strips=0) -> bytes:
    """2-state strips (reference CompressParallelStrips, parallelstrips.go:55)."""
    return _compress_strips(
        pixels, width, height, max_value, num_strips, compress_single_frame, n_states=2
    )


def compress_parallel_strips_4state(pixels, width, height, max_value, num_strips=0) -> bytes:
    """4-state strips (parallelstrips.go:128)."""
    return _compress_strips(
        pixels, width, height, max_value, num_strips, compress_single_frame_4state, n_states=4
    )


def compress_parallel_strips_8state(pixels, width, height, max_value, num_strips=0) -> bytes:
    """8-state strips (parallelstrips.go:199)."""
    return _compress_strips(
        pixels, width, height, max_value, num_strips, compress_single_frame_8state, n_states=8
    )


def pics_strip_blobs(blob: bytes):
    """Parse a PICS container into (width, height, strip_h, [(y0, h, bytes)]).

    Shared by the host decoder and the device batch decoder.
    """
    if len(blob) < PICS_HEADER_BASE or blob[:4] != PICS_MAGIC:
        raise ValueError("parallelstrips: invalid magic")
    width, height, num_strips, strip_h = struct.unpack_from("<IIII", blob, 4)
    header_size = PICS_HEADER_BASE + num_strips * 8
    if len(blob) < header_size:
        raise ValueError("parallelstrips: truncated header")
    if width <= 0 or height <= 0 or num_strips <= 0 or strip_h <= 0:
        raise ValueError("parallelstrips: invalid dimensions")
    strips = []
    for s in range(num_strips):
        off, ln = struct.unpack_from("<II", blob, PICS_HEADER_BASE + s * 8)
        start = header_size + off
        end = start + ln
        if start < 0 or end > len(blob) or start > end:
            raise ValueError(f"strip {s}: offset out of bounds")
        y0 = s * strip_h
        y1 = min(y0 + strip_h, height)
        strips.append((y0, y1 - y0, blob[start:end]))
    return width, height, strip_h, strips


def decompress_parallel_strips(blob: bytes):
    """Reference DecompressParallelStrips (parallelstrips.go:270).
    Returns (pixels, width, height)."""
    width, height, _strip_h, strips = pics_strip_blobs(blob)
    out = np.empty(width * height, dtype=np.uint16)

    def one(item):
        y0, sh, data = item
        out[y0 * width : (y0 + sh) * width] = decompress_single_frame(data, width, sh)

    with ThreadPoolExecutor(max_workers=min(len(strips), os.cpu_count() or 1)) as ex:
        list(ex.map(one, strips))
    return out, width, height
