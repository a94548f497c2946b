"""JPEG 2000 comparison-baseline tests — the analog of the reference's
in-process HTJ2K validation (ojph/htj2k_fair_comparison_test.go,
ojph_wrapper.cpp).  Uses OpenJPEG Part-1 reversible 5/3 (same wavelet
as the reference's HTJ2K configuration; see mic/utils/j2k.py)."""

import pathlib

import numpy as np
import pytest

from mic.utils import j2k

pytestmark = pytest.mark.skipif(
    not j2k.available(), reason="Pillow JPEG2000 codec not present"
)


def test_j2k_gray16_roundtrip_and_ratio_band():
    p = pathlib.Path("/root/reference/testdata/CT_512_512_image.bin")
    if not p.exists():
        pytest.skip("missing CT test data")
    px = np.fromfile(p, dtype="<u2").reshape(512, 512)
    blob = j2k.encode(px)
    assert np.array_equal(j2k.decode(blob), px)
    ratio = px.nbytes / len(blob)
    # Published CT: HTJ2K 1.77x, JPEG-LS 2.68x (reference README.md:270).
    # Part-1 EBCOT must land at or above the HT coder and below JPEG-LS;
    # measured 2.06x with this OpenJPEG build.
    assert 1.77 <= ratio <= 2.68, ratio


def test_j2k_rgb_roundtrip(rng):
    img = (rng.integers(0, 255, (40, 56, 3), dtype=np.uint16) // 3 * 3).astype(
        np.uint8
    )
    blob = j2k.encode(img)
    assert np.array_equal(j2k.decode(blob), img)
