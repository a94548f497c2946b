"""Pipeline integration tests on real corpus images: every single-frame
variant must be pixel-exact (reference fseu16_test.go:381-470)."""

import numpy as np
import pytest

from mic.models.single_frame import (
    compress_single_frame,
    compress_single_frame_4state,
    compress_single_frame_8state,
    compress_single_frame_grad,
    compress_single_frame_rans8,
    compress_residual_frame,
    decompress_residual_frame,
    decompress_single_frame,
    decompress_single_frame_grad,
)

VARIANTS = [
    (compress_single_frame, decompress_single_frame, "2s"),
    (compress_single_frame_4state, decompress_single_frame, "4s"),
    (compress_single_frame_8state, decompress_single_frame, "8s"),
    (compress_single_frame_rans8, decompress_single_frame, "rans8"),
    (compress_single_frame_grad, decompress_single_frame_grad, "grad"),
]


@pytest.mark.parametrize("comp,dec,name", VARIANTS, ids=[v[2] for v in VARIANTS])
def test_mr_roundtrip(comp, dec, name, mr_image):
    px, h, w, mx = mr_image
    blob = comp(px, w, h, mx)
    out = dec(blob, w, h)
    assert np.array_equal(out, px)
    ratio = (h * w * 2) / len(blob)
    assert ratio > 2.0  # reference MR ratio ≈ 2.35


def test_ct_roundtrip_and_ratio(ct_image):
    px, h, w, mx = ct_image
    blob = compress_single_frame(px, w, h, mx)
    out = decompress_single_frame(blob, w, h)
    assert np.array_equal(out, px)
    ratio = (h * w * 2) / len(blob)
    # Reference CT ratio = 2.237 (README.md table); allow small slack.
    assert 2.2 < ratio < 2.3


def test_dicom_corpus_roundtrip(dicom_images):
    for name, img in dicom_images.items():
        px = img.pixels
        h, w = img.rows, img.cols
        mx = max(int(px.max()), 1)
        blob = compress_single_frame_4state(px, w, h, mx)
        out = decompress_single_frame(blob, w, h)
        assert np.array_equal(out, px), name


def test_constant_image_fallback(rng):
    """Constant frame: FSE rejects with UseRLE all the way down — the
    single-frame API propagates the error like the reference."""
    px = np.full(64 * 64, 7, np.uint16)
    from mic.ops.fse import UseRLEError, IncompressibleError

    try:
        blob = compress_single_frame(px, 64, 64, 7)
        out = decompress_single_frame(blob, 64, 64)
        assert np.array_equal(out, px)
    except (UseRLEError, IncompressibleError):
        pass  # matches reference behaviour (caller handles, e.g. WSI planeRaw)


def test_residual_frame_roundtrip(rng):
    res = (rng.standard_normal(20000) * 4 + 8).clip(0, 100).astype(np.uint16)
    blob = compress_residual_frame(res, int(res.max()))
    out = decompress_residual_frame(blob)
    assert np.array_equal(out, res)


def test_residual_frame_tiny_max(rng):
    """Regression: tiny resMax (near-identical frames) must not produce a
    degenerate RLE midCount — guarded by the 255 floor
    (wsicompress.go:398-400 applies the same guard to WSI planes).

    Tiny inputs may still be rejected by the entropy stage (reference
    parity); what must never happen is a *wrong* roundtrip.
    """
    from mic.ops.fse import IncompressibleError, UseRLEError

    for mx in [1, 3, 6, 15]:
        res = rng.integers(0, mx + 1, 65536).astype(np.uint16)
        try:
            blob = compress_residual_frame(res, mx)
        except (IncompressibleError, UseRLEError, ValueError):
            continue
        assert np.array_equal(decompress_residual_frame(blob), res), mx
