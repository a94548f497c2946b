"""Unit round-trips per stage: RLE, predictors, fused Delta+RLE
(reference deltacompressu16_test.go, rlecompressu16_test.go, etc.)."""

import numpy as np
import pytest

from mic.ops.deltarle import (
    delta_rle_compress,
    delta_rle_decompress,
    grad_delta_rle_compress,
    grad_delta_rle_decompress,
    zz_delta_rle_compress,
    zz_delta_rle_decompress,
)
from mic.ops.predictors import (
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
from mic.ops.rle import rle_compress, rle_decompress

PREDICTOR_CODECS = [
    (delta_compress, delta_decompress),
    (grad_delta_compress, grad_delta_decompress),
    (med_delta_compress, med_delta_decompress),
    (delta_zz_compress, delta_zz_decompress),
]

FUSED_CODECS = [
    (delta_rle_compress, delta_rle_decompress),
    (grad_delta_rle_compress, grad_delta_rle_decompress),
    (zz_delta_rle_compress, zz_delta_rle_decompress),
]


def _synth_image(rng, h, w, depth=12):
    img = rng.standard_normal((h, w)).cumsum(axis=1).cumsum(axis=0)
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return (img * ((1 << depth) - 1)).astype(np.uint16)


def test_zigzag_identity():
    x = np.arange(-32768, 32768, dtype=np.int16)
    assert np.array_equal(unzigzag(zigzag(x)), x)
    assert zigzag(np.int16(0)) == 0
    assert zigzag(np.int16(-1)) == 1
    assert zigzag(np.int16(1)) == 2


def test_rle_roundtrip_mixed(rng):
    data = np.concatenate(
        [
            np.full(100, 5),
            rng.integers(0, 1000, 50),
            np.full(7, 3),
            np.full(3, 9),
            rng.integers(0, 1000, 200),
            np.zeros(5000),
        ]
    ).astype(np.uint16)
    enc = rle_compress(data, len(data), 1, 1023)
    assert np.array_equal(rle_decompress(enc), data)


@pytest.mark.parametrize("max_value", [255, 1023, 65535])
def test_rle_overflow_runs(max_value, rng):
    same = np.full(100000, 42, np.uint16)
    assert np.array_equal(rle_decompress(rle_compress(same, len(same), 1, max_value)), same)
    diff = (np.arange(100000) % 251).astype(np.uint16)
    assert np.array_equal(rle_decompress(rle_compress(diff, len(diff), 1, max_value)), diff)


def test_rle_never_expands_much(rng):
    """Min-run-3 property: pure noise must not expand beyond input+headers."""
    data = rng.integers(0, 65000, 10000).astype(np.uint16)
    enc = rle_compress(data, len(data), 1, 65535)
    # 3 words header (maxValue + 2 len words) + per-run headers.
    assert len(enc) <= len(data) + 3 + len(data) // 3 + 2


@pytest.mark.parametrize("comp,dec", PREDICTOR_CODECS, ids=["avg", "grad", "med", "zz"])
def test_predictor_roundtrip(comp, dec, rng):
    img = _synth_image(rng, 64, 67)
    img[10, 10] = 4095
    img[0, 0] = 4094  # force escapes
    mx = int(img.max())
    out = dec(comp(img.ravel(), 67, 64, mx), 67, 64)
    assert np.array_equal(out, img.ravel())


@pytest.mark.parametrize("comp,dec", PREDICTOR_CODECS, ids=["avg", "grad", "med", "zz"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 17), (17, 1), (2, 2), (3, 5)])
def test_predictor_edge_shapes(comp, dec, shape, rng):
    h, w = shape
    img = rng.integers(0, 4096, (h, w)).astype(np.uint16)
    mx = max(int(img.max()), 1)
    out = dec(comp(img.ravel(), w, h, mx), w, h)
    assert np.array_equal(out, img.ravel())


@pytest.mark.parametrize("comp,dec", PREDICTOR_CODECS, ids=["avg", "grad", "med", "zz"])
def test_predictor_extreme_values(comp, dec, rng):
    """Full-range data with many escapes."""
    img = rng.integers(0, 65536, (32, 32)).astype(np.uint16)
    img[0, :8] = 65535
    out = dec(comp(img.ravel(), 32, 32, 65535), 32, 32)
    assert np.array_equal(out, img.ravel())


@pytest.mark.parametrize("comp,dec", FUSED_CODECS, ids=["avg", "grad", "zz"])
def test_fused_delta_rle_roundtrip(comp, dec, rng):
    img = _synth_image(rng, 96, 51)
    mx = int(img.max())
    out = dec(comp(img.ravel(), 51, 96, mx), 51, 96)
    assert np.array_equal(out, img.ravel())


def test_fused_matches_mr(mr_image):
    px, h, w, mx = mr_image
    rle = delta_rle_compress(px, w, h, mx)
    out = delta_rle_decompress(rle, w, h)
    assert np.array_equal(out, px)


def test_temporal_roundtrip(rng):
    f0 = rng.integers(0, 4095, 10000).astype(np.uint16)
    f1 = (f0.astype(np.int32) + rng.integers(-50, 51, 10000)).clip(0, 4095).astype(np.uint16)
    res = temporal_delta_encode(f1, f0)
    assert np.array_equal(temporal_delta_decode(res, f0), f1)
    # Frame 0 passthrough.
    assert np.array_equal(temporal_delta_encode(f0, None), f0)
    assert np.array_equal(temporal_delta_decode(f0, None), f0)
