"""Container edge cases mirroring the reference's deeper suites
(wsi_test.go:229-886, multiframe_test.go:18-61, parallelstrips_test.go:82-148):
tile content variants, odd-dimension downsampling, file-based round
trips, YCoCg-R exhaustive sweeps, temporal-delta edges, and PICS header
validation — the long tail of container checks."""

import struct

import numpy as np
import pytest

from mic.ops.color import ycocgr_forward, ycocgr_inverse
from mic.ops.pyramid import downsample2x_grey, downsample2x_rgb
from mic.ops.predictors import temporal_delta_decode, temporal_delta_encode
from mic.parallel.strips import (
    compress_parallel_strips_4state,
    decompress_parallel_strips,
)
from mic.parallel.wsi import (
    WSIOptions,
    compress_wsi,
    decompress_wsi_region,
    decompress_wsi_tile,
    read_mic3_header,
    read_wsi_header,
)


# ── YCoCg-R (wsi_test.go:136-228) ────────────────────────────────────


def test_ycocgr_known_values():
    """Pinned transform outputs (TestYCoCgRKnownValues wsi_test.go:197):
    grey has Co=Cg=0 (stored zig-zagged as 0), primaries match the
    lifting formulas Co=R-B, t=B+(Co>>1), Cg=G-t, Y=t+(Cg>>1)."""
    rgb = np.array([0, 0, 0, 255, 255, 255, 255, 0, 0, 0, 255, 0, 0, 0, 255],
                   dtype=np.uint8)
    y, co, cg = ycocgr_forward(rgb, 5, 1)
    assert list(y) == [0, 255, 63, 127, 63]
    out = ycocgr_inverse(y, co, cg, 5, 1)
    assert np.array_equal(out, rgb)
    # Grey pixels: chroma planes are exactly zero.
    assert co[0] == 0 and cg[0] == 0 and co[1] == 0 and cg[1] == 0


def test_ycocgr_exhaustive_8bit_grid():
    """Dense sweep of the 8-bit cube on a 18x18x18 lattice + the extreme
    corners (TestYCoCgRExhaustive8Bit wsi_test.go:170, sampled like the
    reference) — every (R,G,B) must survive the reversible transform."""
    vals = np.r_[np.arange(0, 256, 15), 255].astype(np.uint8)
    r, g, b = np.meshgrid(vals, vals, vals, indexing="ij")
    rgb = np.stack([r.ravel(), g.ravel(), b.ravel()], axis=1).ravel()
    n = len(rgb) // 3
    y, co, cg = ycocgr_forward(rgb, n, 1)
    assert y.max() <= 255 and co.max() <= 510 and cg.max() <= 510
    out = ycocgr_inverse(y, co, cg, n, 1)
    assert np.array_equal(out, rgb)


# ── Pyramid downsampling (wsi_test.go:229-288) ───────────────────────


def test_downsample2x_rgb_box_filter():
    """2x2 box filter with +2 rounding (wsipyramid.go:10-32)."""
    src = np.array(
        [10, 20, 30, 50, 60, 70,
         90, 100, 110, 130, 140, 150], dtype=np.uint8)  # 2x2 RGB
    out, w, h = downsample2x_rgb(src, 2, 2)
    assert (w, h) == (1, 1)
    assert list(out) == [(10 + 50 + 90 + 130 + 2) // 4,
                         (20 + 60 + 100 + 140 + 2) // 4,
                         (30 + 70 + 110 + 150 + 2) // 4]


@pytest.mark.parametrize("w,h", [(5, 4), (4, 5), (5, 5), (3, 3)])
def test_downsample2x_odd_dimensions(w, h, rng):
    """Odd trailing pixels drop; dims floor-halve
    (TestDownsample2xOddDimensions wsi_test.go:256)."""
    grey = rng.integers(0, 4096, w * h).astype(np.uint16)
    out, ow, oh = downsample2x_grey(grey, w, h)
    assert (ow, oh) == (w // 2, h // 2)
    assert len(out) == ow * oh
    g = grey.reshape(h, w).astype(np.uint32)
    want = (g[0, 0] + g[0, 1] + g[1, 0] + g[1, 1] + 2) // 4
    assert out[0] == want

    rgb = rng.integers(0, 256, w * h * 3).astype(np.uint8)
    out3, ow3, oh3 = downsample2x_rgb(rgb, w, h)
    assert (ow3, oh3) == (w // 2, h // 2)
    assert len(out3) == ow3 * oh3 * 3


@pytest.mark.parametrize("w,h", [(1, 7), (7, 1), (1, 1)])
def test_downsample2x_too_small(w, h, rng):
    """A dimension that halves to zero stops the pyramid
    ((None, 0, 0) sentinel; callers auto-stop, wsiformat.go:273)."""
    grey = rng.integers(0, 4096, w * h).astype(np.uint16)
    assert downsample2x_grey(grey, w, h) == (None, 0, 0)
    rgb = rng.integers(0, 256, w * h * 3).astype(np.uint8)
    assert downsample2x_rgb(rgb, w, h) == (None, 0, 0)


# ── Temporal delta edges (multiframe_test.go:18-61) ──────────────────


def test_temporal_delta_edge_cases():
    empty = np.array([], dtype=np.uint16)
    assert len(temporal_delta_encode(empty, empty)) == 0
    assert len(temporal_delta_decode(empty, empty)) == 0
    one = np.array([777], dtype=np.uint16)
    res = temporal_delta_encode(one, np.array([775], dtype=np.uint16))
    back = temporal_delta_decode(res, np.array([775], dtype=np.uint16))
    assert np.array_equal(back, one)
    # Extremes: wrap-safe at the u16 boundaries.
    cur = np.array([0, 65535, 65535, 0], dtype=np.uint16)
    prev = np.array([65535, 0, 65535, 0], dtype=np.uint16)
    assert np.array_equal(
        temporal_delta_decode(temporal_delta_encode(cur, prev), prev), cur)


# ── WSI tile content variants (wsi_test.go:361-492) ──────────────────


def _tile_roundtrip(img8, w, h, **opts):
    blob = compress_wsi(img8, w, h, 3, 8,
                        WSIOptions(tile_width=w, tile_height=h,
                                   pyramid_levels=1, **opts))
    out = decompress_wsi_tile(blob, 0, 0, 0)
    assert np.array_equal(np.frombuffer(out, np.uint8), np.asarray(img8)), \
        "tile roundtrip mismatch"
    return blob


def test_wsi_tile_black(rng):
    blob = _tile_roundtrip(np.zeros(64 * 64 * 3, np.uint8), 64, 64)
    _, entries, _ = read_mic3_header(blob)
    assert entries[0][1] <= 17  # constant planes collapse


def test_wsi_tile_gradient():
    g = np.arange(64 * 64, dtype=np.uint32)
    img = np.stack([(g % 256), (g // 16 % 256), ((g * 3) % 256)], 1)
    _tile_roundtrip(img.astype(np.uint8).ravel(), 64, 64)


def test_wsi_tile_random_incompressible(rng):
    """Random pixels must still roundtrip (planeRaw fallback,
    wsicompress.go:404-414)."""
    img = rng.integers(0, 256, 64 * 64 * 3).astype(np.uint8)
    blob = _tile_roundtrip(img, 64, 64)
    # Raw fallback bounds the size near the input.
    assert len(blob) < img.nbytes * 1.25 + 256


def test_wsi_tile_no_color_transform(rng):
    """Tile blob codec with the YCoCg-R stage disabled — the reference
    exercises compressTileBlob directly because public WSIOptions
    force-enable the transform for RGB (wsiformat.go:92-94), exactly as
    ours do (TestWSITileCompressNoColorTransform wsi_test.go:454)."""
    from mic.parallel.wsi import _compress_tile_blob, _decompress_tile_blob

    img = rng.integers(0, 200, 32 * 32 * 3).astype(np.uint8)
    blob = _compress_tile_blob(img, 32, 32, 3, 8, False)
    out = _decompress_tile_blob(blob, 32, 32, 3, 8, False)
    assert np.array_equal(np.frombuffer(out, np.uint8), img)


def test_wsi_grey_odd_dims_region(rng):
    """16-bit grey + odd dims + cross-tile region in one path."""
    w, h = 97, 61
    img = (rng.standard_normal((h, w)).cumsum(axis=1) * 20 + 1000)
    px = img.clip(0, 4095).astype("<u2")
    blob = compress_wsi(px.tobytes(), w, h, 1, 16,
                        WSIOptions(tile_width=32, tile_height=32,
                                   pyramid_levels=1))
    out = decompress_wsi_region(blob, 0, 17, 9, 70, 44)
    got = np.frombuffer(out, "<u2").reshape(44, 70)
    assert np.array_equal(got, px[9:53, 17:87])


# ── File-based round trips (wsi_test.go:781-886) ─────────────────────


def test_wsi_file_roundtrip(tmp_path, rng):
    """Raw file → compress → .mic3 on disk → reopen → tile decode
    (TestWSICompressFromFile)."""
    w, h = 96, 64
    img = rng.integers(0, 256, w * h * 3).astype(np.uint8)
    raw = tmp_path / "slide.raw"
    raw.write_bytes(img.tobytes())
    data = np.frombuffer(raw.read_bytes(), np.uint8)
    blob = compress_wsi(data, w, h, 3, 8,
                        WSIOptions(tile_width=32, tile_height=32,
                                   pyramid_levels=2))
    out_path = tmp_path / "slide.mic3"
    out_path.write_bytes(blob)

    reread = out_path.read_bytes()
    hdr = read_wsi_header(reread)
    assert (hdr.levels[0].width, hdr.levels[0].height) == (w, h)
    full = decompress_wsi_region(reread, 0, 0, 0, w, h)
    assert np.array_equal(np.frombuffer(full, np.uint8), img)


def test_mic1_file_roundtrip(tmp_path, mr_image):
    from mic.models.single_frame import (
        compress_single_frame_4state,
        decompress_single_frame,
    )
    from mic.utils.io import read_mic1, write_mic1

    px, h, w, mx = mr_image
    payload = compress_single_frame_4state(px, w, h, mx)
    p = tmp_path / "img.mic"
    p.write_bytes(write_mic1(w, h, payload))
    w2, h2, _pipe, data = read_mic1(p.read_bytes())
    assert (w2, h2) == (w, h)
    assert np.array_equal(decompress_single_frame(data, w, h), px)


# ── PICS header validation (parallelstrips_test.go:82-148) ───────────


def test_pics_header_validation(mr_image):
    px, h, w, mx = mr_image
    blob = bytearray(compress_parallel_strips_4state(px, w, h, mx, 4))
    # Truncated container.
    with pytest.raises(ValueError):
        decompress_parallel_strips(bytes(blob[:20]))
    # Strip offset past the blob.
    bad = bytearray(blob)
    struct.pack_into("<I", bad, 20, 2**31)  # first strip offset
    with pytest.raises(ValueError):
        decompress_parallel_strips(bytes(bad))
    # Length overflowing the blob.
    bad = bytearray(blob)
    struct.pack_into("<I", bad, 24, 2**31)  # first strip length
    with pytest.raises(ValueError):
        decompress_parallel_strips(bytes(bad))
    # Zero strips.
    bad = bytearray(blob)
    struct.pack_into("<I", bad, 12, 0)
    with pytest.raises(ValueError):
        decompress_parallel_strips(bytes(bad))


def test_mic2_many_frame_series(rng):
    """A longer series (16 frames) in both modes — the synthetic stand-in
    for the reference's 69-frame tomo DICOM (multiframe_test.go:292)."""
    from mic.parallel.multiframe import (
        compress_multi_frame,
        decompress_frame,
        decompress_multi_frame,
    )

    h, w = 40, 64
    base = (rng.standard_normal((h, w)).cumsum(axis=1) * 30 + 1500).astype(np.int32)
    base = (base >> 3 << 3).clip(0, 4095).astype(np.uint16)
    frames = [base.ravel()]
    for i in range(15):
        nxt = (frames[-1].astype(np.int32) + rng.integers(-1, 2, h * w) * 8).clip(0, 4095)
        frames.append(nxt.astype(np.uint16))
    mx = int(max(f.max() for f in frames))
    for temporal in (False, True):
        blob = compress_multi_frame(frames, w, h, mx, temporal)
        out, hdr = decompress_multi_frame(blob)
        assert hdr.frame_count == 16
        for a, b in zip(out, frames):
            assert np.array_equal(a, b)
        mid, _ = decompress_frame(blob, 8)
        assert np.array_equal(mid, frames[8])
