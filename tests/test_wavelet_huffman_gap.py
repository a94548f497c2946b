"""Wavelet pipelines, canonical Huffman, and gap-removal tests
(reference waveletu16_test.go, canhuffmancompressu16_test.go,
gapremovalcompressu16_test.go)."""

import numpy as np
import pytest

from mic.models.wavelet_pipeline import (
    wavelet_fse_compress,
    wavelet_fse_decompress,
    wavelet_rle_fse_compress,
    wavelet_rle_fse_decompress,
    wavelet_v2_rle_fse_compress,
    wavelet_v2_rle_fse_decompress,
    wavelet_v2_simd_rle_fse_compress,
)
from mic.ops.gapremoval import (
    compress_single_frame_gap_removal,
    decompress_single_frame_gap_removal,
)
from mic.ops.huffman import can_huffman_compress, can_huffman_decompress
from mic.ops.wavelet import (
    coeffs_to_u16,
    collect_subband_order,
    scatter_subband_order,
    u16_to_coeffs,
    wt53_forward_1d,
    wt53_forward_2d_separated,
    wt53_inverse_1d,
    wt53_inverse_2d_separated,
)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 7, 8, 255, 256, 257])
def test_wavelet_1d_roundtrip(n, rng):
    x = rng.integers(0, 65535, (4, n)).astype(np.int64)
    assert np.array_equal(wt53_inverse_1d(wt53_forward_1d(x, axis=1), axis=1), x)


@pytest.mark.parametrize("shape", [(64, 64), (33, 47), (100, 37), (2, 2), (5, 3)])
def test_wavelet_2d_separated_multilevel(shape, rng):
    r, c = shape
    img = rng.integers(0, 4096, (r, c)).astype(np.int64)
    buf = img.copy()
    dims = []
    rr, cc = r, c
    for _ in range(4):
        if rr < 2 or cc < 2:
            break
        wt53_forward_2d_separated(buf, rr, cc, c)
        dims.append((rr, cc))
        rr, cc = (rr + 1) // 2, (cc + 1) // 2
    lin = collect_subband_order(buf, r, c, c, len(dims))
    back = scatter_subband_order(lin, r, c, c, len(dims)).reshape(r, c)
    assert np.array_equal(back, buf)
    for rr, cc in reversed(dims):
        wt53_inverse_2d_separated(back, rr, cc, c)
    assert np.array_equal(back, img)


def test_coeff_escape_roundtrip(rng):
    c = np.concatenate(
        [rng.integers(-32767, 32768, 2000), [40000, -40000, 100000, -(2**30), 2**30, 65535 >> 1]]
    ).astype(np.int64)
    rng.shuffle(c)
    assert np.array_equal(u16_to_coeffs(coeffs_to_u16(c), len(c)), c)


WAVELET_PIPELINES = [
    (wavelet_fse_compress, wavelet_fse_decompress, "v1"),
    (wavelet_rle_fse_compress, wavelet_rle_fse_decompress, "v1.5"),
    (wavelet_v2_rle_fse_compress, wavelet_v2_rle_fse_decompress, "v2"),
]


@pytest.mark.parametrize("comp,dec,name", WAVELET_PIPELINES, ids=[p[2] for p in WAVELET_PIPELINES])
def test_wavelet_pipeline_mr(comp, dec, name, mr_image):
    px, h, w, mx = mr_image
    blob = comp(px, h, w, mx, 5)
    out, r, c = dec(blob)
    assert (r, c) == (h, w)
    assert np.array_equal(out, px)


def test_wavelet_v2_ct_ratio(ct_image):
    px, h, w, mx = ct_image
    blob = wavelet_v2_rle_fse_compress(px, h, w, mx, 5)
    out, r, c = wavelet_v2_rle_fse_decompress(blob)
    assert np.array_equal(out, px)
    ratio = px.nbytes / len(blob)
    # Reference results table: Wavelet on CT = 1.67x (its weakest modality;
    # results/20260518-112009/paper-tables.txt Table 1).
    assert 1.6 < ratio < 1.75


def test_wavelet_simd_alias_bitidentical(mr_image):
    px, h, w, mx = mr_image
    a = wavelet_v2_rle_fse_compress(px, h, w, mx, 5)
    b = wavelet_v2_simd_rle_fse_compress(px, h, w, mx, 5)
    assert a == b


@pytest.mark.parametrize("gen", ["skewed", "wide", "tiny_alphabet", "constant"])
def test_huffman_roundtrip(gen, rng):
    data = {
        "skewed": (rng.standard_normal(30000) * 30 + 511).clip(0, 1023).astype(np.uint16),
        "wide": (rng.standard_normal(20000) * 2000 + 30000).clip(0, 65000).astype(np.uint16),
        "tiny_alphabet": rng.integers(0, 16, 10000).astype(np.uint16),
        "constant": np.full(5000, 3, np.uint16),
    }[gen]
    blob = can_huffman_compress(data)
    assert np.array_equal(can_huffman_decompress(blob), data)


def test_huffman_max_code_len(rng):
    """Adaptive subset keeps codes <= 14 bits even on huge alphabets."""
    data = rng.zipf(1.3, 100000).clip(0, 60000).astype(np.uint16)
    blob = can_huffman_compress(data)
    assert np.array_equal(can_huffman_decompress(blob), data)


def test_huffman_on_delta_rle(mr_image):
    """Delta+RLE+Huffman pipeline (reference rlehuffdecompressu16.go path)."""
    from mic.ops.deltarle import delta_rle_compress, delta_rle_decompress

    px, h, w, mx = mr_image
    rle = delta_rle_compress(px, w, h, mx)
    blob = can_huffman_compress(rle)
    back = can_huffman_decompress(blob)
    assert np.array_equal(delta_rle_decompress(back, w, h), px)


def test_gap_removal_ct(ct_image):
    px, h, w, mx = ct_image
    blob = compress_single_frame_gap_removal(px, w, h, mx)
    assert blob[0] == 0x03  # CT uses the delta-list map (README.md:293)
    out = decompress_single_frame_gap_removal(blob, w, h)
    assert np.array_equal(out, px)
    ratio = px.nbytes / len(blob)
    assert 2.24 < ratio < 2.26  # reference: 2.247


def test_gap_removal_dense_passthrough(rng):
    """Dense alphabets skip gap removal (mode 0x00)."""
    img = (rng.standard_normal((64, 64)) * 5 + 100).clip(0, 255).astype(np.uint16)
    blob = compress_single_frame_gap_removal(img.ravel(), 64, 64, int(img.max()))
    out = decompress_single_frame_gap_removal(blob, 64, 64)
    assert np.array_equal(out, img.ravel())


@pytest.mark.parametrize("scale,want_mode", [(97, 0x03), (256, 0x03), (513, 0x01)])
def test_gap_removal_modes(scale, want_mode, rng):
    """Sparse residual alphabets (quantized smooth images) exercise the
    delta-list and raw expand-map modes."""
    img = (rng.standard_normal((64, 64)).cumsum(axis=1) * 3 + 40).astype(np.int32)
    img = (img.clip(0, 120) * scale).astype(np.uint16).ravel()
    blob = compress_single_frame_gap_removal(img, 64, 64, int(img.max()))
    assert blob[0] == want_mode
    out = decompress_single_frame_gap_removal(blob, 64, 64)
    assert np.array_equal(out, img)
