"""JPEG-LS (CharLS) comparison-baseline tests — the analog of the
reference's in-process CharLS validation (ojph/jpegls_comparison_test.go,
charls_wrapper.cpp)."""

import pathlib

import numpy as np
import pytest

from mic.utils import charls

pytestmark = pytest.mark.skipif(
    not charls.available(), reason="libcharls not present"
)


def test_charls_gray16_roundtrip_and_published_ratio():
    p = pathlib.Path("/root/reference/testdata/CT_512_512_image.bin")
    if not p.exists():
        pytest.skip("missing CT test data")
    px = np.fromfile(p, dtype="<u2").reshape(512, 512)
    bps = max(int(px.max()).bit_length(), 2)
    blob = charls.encode(px, bits_per_sample=bps)
    assert np.array_equal(charls.decode(blob), px)
    ratio = px.nbytes / len(blob)
    # Reference publishes 2.68x for CT / JPEG-LS (README.md:270).
    assert abs(ratio - 2.68) < 0.02


def test_charls_rgb_roundtrip(rng):
    img = (rng.integers(0, 255, (40, 56, 3), dtype=np.uint16) // 3 * 3).astype(
        np.uint8
    )
    blob = charls.encode(img)
    assert np.array_equal(charls.decode(blob), img)
