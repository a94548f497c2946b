"""Corpus-coverage tests for images the benchmarks use but round-1 tests
missed: XA1 (16-bit grayscale) and US1 (RGB DICOM)."""

import numpy as np
import pytest


def test_xa1_roundtrip(dicom_images):
    if "XA1_UNC" not in dicom_images:
        pytest.skip("XA1 not available")
    img = dicom_images["XA1_UNC"]
    px, h, w = img.pixels, img.rows, img.cols
    mx = img.max_value
    from mic.models.single_frame import (
        compress_single_frame_4state,
        decompress_single_frame,
    )

    blob = compress_single_frame_4state(px, w, h, mx)
    assert np.array_equal(decompress_single_frame(blob, w, h), px)
    # Published XA1 ratio is 5.01x (reference README.md table).
    assert abs(px.nbytes / len(blob) - 5.01) < 0.05


def test_us1_rgb_roundtrip(rgb_dicom):
    img = rgb_dicom
    h, w = img.rows, img.cols
    rgb = img.pixels.reshape(h, w, 3).astype(np.uint8)
    from mic.models.rgb import compress_rgb, decompress_rgb

    blob = compress_rgb(rgb, w, h)
    out = np.asarray(decompress_rgb(blob, w, h)).reshape(h, w, 3)
    assert np.array_equal(out, rgb)
    # Published US1 ratio is 6.24x (reference README.md:209).
    assert abs(rgb.nbytes / len(blob) - 6.24) < 0.05


def test_us1_mwr3_beats_host_format(rgb_dicom):
    """The device RGB container (MWR3 over MICW v4) compresses US1 better
    than the host MICR format — regression-pin the round-2 result."""
    img = rgb_dicom
    h, w = img.rows, img.cols
    rgb = img.pixels.reshape(h, w, 3).astype(np.uint8)
    from mic.device.rgb_device import micwr_compress, micwr_decompress_host

    blob = micwr_compress(rgb.reshape(-1), w, h)
    out, ow, oh = micwr_decompress_host(blob)
    assert np.array_equal(np.asarray(out).ravel(), rgb.ravel())
    assert rgb.nbytes / len(blob) > 6.5  # measured 6.84 vs MICR 6.24
