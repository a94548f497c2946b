"""Container tests: PICS/PICA strips, MIC2 multi-frame, MIC3 WSI, MICR RGB
(reference parallelstrips_test.go, multiframe_test.go, wsi_test.go,
rgbbench_test.go)."""

import struct

import numpy as np
import pytest

from mic.models.rgb import compress_rgb, decompress_rgb
from mic.parallel.multiframe import (
    compress_multi_frame,
    decompress_frame,
    decompress_multi_frame,
    read_mic2_header,
)
from mic.parallel.strips import (
    compress_parallel_strips,
    compress_parallel_strips_4state,
    compress_parallel_strips_8state,
    decompress_parallel_strips,
)
from mic.parallel.strips_adaptive import (
    adaptive_strip_boundaries,
    compress_parallel_strips_adaptive,
    decompress_parallel_strips_adaptive,
)
from mic.parallel.wsi import (
    WSIOptions,
    compress_wsi,
    decompress_wsi_region,
    decompress_wsi_tile,
    read_wsi_header,
)
from mic.utils.io import read_mic1, read_micr, write_mic1, write_micr


# ── PICS ──────────────────────────────────────────────────────────────


@pytest.mark.parametrize(
    "comp",
    [compress_parallel_strips, compress_parallel_strips_4state, compress_parallel_strips_8state],
    ids=["2s", "4s", "8s"],
)
@pytest.mark.parametrize("num_strips", [1, 2, 4, 7])
def test_pics_roundtrip(comp, num_strips, mr_image):
    px, h, w, mx = mr_image
    blob = comp(px, w, h, mx, num_strips)
    assert blob[:4] == b"PICS"
    out, ow, oh = decompress_parallel_strips(blob)
    assert (ow, oh) == (w, h)
    assert np.array_equal(out, px)


def test_pics_format_fields(mr_image):
    px, h, w, mx = mr_image
    blob = compress_parallel_strips(px, w, h, mx, 4)
    width, height, n, strip_h = struct.unpack_from("<IIII", blob, 4)
    assert (width, height) == (w, h)
    assert n == 4 and strip_h == (h + 3) // 4


def test_pics_strip_count_clamped_to_height(mr_image):
    """numStrips > height clamps to height strips (reference
    TestParallelStripsSingleRowImage, parallelstrips_test.go:119-145)."""
    px, h, w, mx = mr_image
    rows = 2
    px2 = px[: w * rows]
    blob = compress_parallel_strips(px2, w, rows, mx, h)  # ask for 256 strips
    out, ow, oh = decompress_parallel_strips(blob)
    assert (ow, oh) == (w, rows)
    assert np.array_equal(out, px2)
    assert struct.unpack_from("<I", blob, 12)[0] == rows  # clamped


def test_pics_ratio_cost_small(ct_image):
    """Strip cost = boundary rows + per-strip FSE headers.  CT's sparse
    16-bit alphabet makes header duplication the dominant term (~4% at 4
    strips); boundary-row loss itself is sub-percent (parallelstrips.go:31-39)."""
    px, h, w, mx = ct_image
    single = compress_parallel_strips(px, w, h, mx, 1)
    four = compress_parallel_strips(px, w, h, mx, 4)
    assert len(four) < len(single) * 1.06


def test_pics_corrupt_magic():
    with pytest.raises(ValueError):
        decompress_parallel_strips(b"PICX" + b"\x00" * 32)


# ── PICA ──────────────────────────────────────────────────────────────


def test_pica_roundtrip(mr_image):
    px, h, w, mx = mr_image
    blob = compress_parallel_strips_adaptive(px, w, h, mx, 4)
    assert blob[:4] == b"PICA"
    out, ow, oh = decompress_parallel_strips_adaptive(blob)
    assert np.array_equal(out, px)


def test_pica_adaptive_boundaries(rng):
    """Busy rows get narrower strips."""
    img = np.zeros((100, 64), dtype=np.uint16)
    img[50:] = rng.integers(0, 4096, (50, 64)).astype(np.uint16)
    starts = adaptive_strip_boundaries(img.ravel(), 64, 100, 4)
    assert starts[0] == 0 and len(starts) == 4
    # all interior boundaries should land in the busy half
    assert all(s >= 50 for s in starts[1:])


def test_pica_uses_grad_flag_when_smaller(mr_image):
    px, h, w, mx = mr_image
    blob = compress_parallel_strips_adaptive(px, w, h, mx, 2)
    n = struct.unpack_from("<I", blob, 12)[0]
    flags = [struct.unpack_from("<IIII", blob, 16 + i * 16)[3] for i in range(n)]
    assert all(f in (0, 1) for f in flags)


# ── MIC2 ──────────────────────────────────────────────────────────────


def _frames(rng, n=4, h=48, w=53):
    # Smooth-ish frames: small-alphabet residuals so tiny frames stay
    # compressible (a 2.5k-pixel frame with ~800 distinct residuals is
    # rejected by the entropy stage, faithfully to the reference).
    base = (rng.standard_normal((h, w)).cumsum(axis=1) * 50 + 2000).astype(np.int32)
    base = (base >> 4 << 4).clip(0, 4095).astype(np.uint16)
    frames = [base.ravel()]
    for _ in range(n - 1):
        nxt = (frames[-1].astype(np.int32) + rng.integers(-2, 3, h * w) * 16).clip(0, 4095)
        frames.append(nxt.astype(np.uint16))
    return frames, w, h


@pytest.mark.parametrize("temporal", [False, True], ids=["independent", "temporal"])
def test_mic2_roundtrip(temporal, rng):
    frames, w, h = _frames(rng)
    mx = int(max(f.max() for f in frames))
    blob = compress_multi_frame(frames, w, h, mx, temporal)
    assert blob[:4] == b"MIC2"
    out, hdr = decompress_multi_frame(blob)
    assert hdr.temporal == temporal and hdr.frame_count == len(frames)
    for a, b in zip(out, frames):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("temporal", [False, True], ids=["independent", "temporal"])
def test_mic2_random_frame_access(temporal, rng):
    frames, w, h = _frames(rng, n=5)
    mx = int(max(f.max() for f in frames))
    blob = compress_multi_frame(frames, w, h, mx, temporal)
    for idx in [0, 2, 4]:
        px, hdr = decompress_frame(blob, idx)
        assert np.array_equal(px, frames[idx]), idx


def test_mic2_header_fields(rng):
    frames, w, h = _frames(rng, n=3)
    blob = compress_multi_frame(frames, w, h, 4095, True)
    hdr, entries, off = read_mic2_header(blob)
    assert (hdr.width, hdr.height, hdr.frame_count) == (w, h, 3)
    assert hdr.temporal
    assert len(entries) == 3
    assert blob[16] == 0x03  # spatial | temporal flags


def test_mic2_out_of_range_frame(rng):
    frames, w, h = _frames(rng, n=2)
    blob = compress_multi_frame(frames, w, h, 4095, False)
    with pytest.raises(ValueError):
        decompress_frame(blob, 2)


# ── MICR / RGB ───────────────────────────────────────────────────────


def test_rgb_roundtrip(rgb_tissue):
    data, w, h = rgb_tissue
    blob = compress_rgb(data, w, h)
    out = decompress_rgb(blob, w, h)
    assert np.array_equal(out, data)
    ratio = len(data) / len(blob)
    assert ratio > 2.0  # tissue compresses 3-5x per reference


def test_micr_container(rgb_tissue):
    data, w, h = rgb_tissue
    blob = compress_rgb(data, w, h)
    f = write_micr(w, h, blob)
    w2, h2, payload = read_micr(f)
    assert (w2, h2) == (w, h)
    assert np.array_equal(decompress_rgb(payload, w, h), data)


def test_mic1_container(mr_image):
    from mic.models.single_frame import compress_single_frame, decompress_single_frame

    px, h, w, mx = mr_image
    payload = compress_single_frame(px, w, h, mx)
    f = write_mic1(w, h, payload)
    w2, h2, pipeline, data = read_mic1(f)
    assert (w2, h2, pipeline) == (w, h, 1)
    assert np.array_equal(decompress_single_frame(data, w, h), px)


# ── MIC3 / WSI ───────────────────────────────────────────────────────


def test_wsi_rgb_roundtrip(rgb_tissue):
    data, w, h = rgb_tissue
    blob = compress_wsi(data, w, h, 3, 8, WSIOptions(tile_width=128, tile_height=128))
    hdr = read_wsi_header(blob)
    assert hdr.channels == 3 and hdr.color_transform
    assert len(hdr.levels) >= 2
    # Reassemble level 0 from tiles and compare.
    lv = hdr.levels[0]
    img = np.zeros((h, w * 3), dtype=np.uint8)
    for ty in range(lv.tiles_y):
        for tx in range(lv.tiles_x):
            tile = decompress_wsi_tile(blob, 0, tx, ty)
            tw = min(128, w - tx * 128)
            th = min(128, h - ty * 128)
            t = np.frombuffer(tile, np.uint8).reshape(th, tw * 3)
            img[ty * 128 : ty * 128 + th, tx * 128 * 3 : (tx * 128 + tw) * 3] = t
    assert np.array_equal(img.ravel(), data)


def test_wsi_grey16_roundtrip(mr_image):
    px, h, w, mx = mr_image
    raw = px.astype("<u2").tobytes()
    blob = compress_wsi(raw, w, h, 1, 16, WSIOptions(tile_width=64, tile_height=64))
    hdr = read_wsi_header(blob)
    assert hdr.channels == 1 and hdr.bits_per_sample == 16
    tile = decompress_wsi_tile(blob, 0, 1, 1)
    got = np.frombuffer(tile, "<u2").reshape(64, 64)
    want = px.reshape(h, w)[64:128, 64:128]
    assert np.array_equal(got, want)


def test_wsi_constant_background_tiny(rng):
    """Background (constant) tiles must collapse to ~15-17 bytes (README.md:147)."""
    w = h = 256
    white = np.full(w * h * 3, 255, dtype=np.uint8)
    blob = compress_wsi(white, w, h, 3, 8, WSIOptions(pyramid_levels=1))
    hdr = read_wsi_header(blob)
    from mic.parallel.wsi import extract_tile_blob, read_mic3_header

    _, entries, off = read_mic3_header(blob)
    assert entries[0][1] <= 17


def test_wsi_region_cross_tile(rgb_tissue):
    data, w, h = rgb_tissue
    blob = compress_wsi(data, w, h, 3, 8, WSIOptions(tile_width=128, tile_height=128, pyramid_levels=1))
    region = decompress_wsi_region(blob, 0, 100, 100, 120, 90)
    got = np.frombuffer(region, np.uint8).reshape(90, 120 * 3)
    want = np.asarray(data).reshape(h, w * 3)[100:190, 300:660]
    assert np.array_equal(got, want)


def test_wsi_odd_dims(rng):
    w, h = 131, 77
    img = rng.integers(0, 256, w * h * 3).astype(np.uint8)
    blob = compress_wsi(img, w, h, 3, 8, WSIOptions(tile_width=64, tile_height=64, pyramid_levels=2))
    hdr = read_wsi_header(blob)
    lv = hdr.levels[0]
    out = decompress_wsi_region(blob, 0, 0, 0, w, h)
    assert np.array_equal(np.frombuffer(out, np.uint8), img)


def test_wsi_pyramid_level_dims(rgb_tissue):
    data, w, h = rgb_tissue
    blob = compress_wsi(data, w, h, 3, 8, WSIOptions(tile_width=128, tile_height=128))
    hdr = read_wsi_header(blob)
    assert hdr.levels[0].width == w and hdr.levels[0].height == h
    for i in range(1, len(hdr.levels)):
        assert hdr.levels[i].width == hdr.levels[i - 1].width // 2


def test_mic2_device_format_frames(rng):
    """MIC2 carrying MICW device-format frames: batch device decode and
    host sniffing both roundtrip."""
    from mic.parallel.multiframe import (
        compress_multi_frame_device,
        decompress_multi_frame,
        decompress_multi_frame_device,
        decompress_frame,
    )

    h, w = 32, 64
    base = (
        ((rng.standard_normal((h, w)).cumsum(axis=1) * 10 + 500).astype(np.int32) >> 2 << 2)
        .clip(0, 1023)
        .astype(np.uint16)
    )
    frames = [base.ravel()]
    for _ in range(2):
        frames.append(
            ((frames[-1].astype(np.int32) + rng.integers(-1, 2, h * w) * 4).clip(0, 1023)).astype(
                np.uint16
            )
        )
    blob = compress_multi_frame_device(frames, w, h, 1023, lanes=64)
    out, hdr = decompress_multi_frame_device(blob)
    assert all(np.array_equal(a, b) for a, b in zip(out, frames))
    out2, _ = decompress_multi_frame(blob)
    assert all(np.array_equal(a, b) for a, b in zip(out2, frames))
    one, _ = decompress_frame(blob, 2)
    assert np.array_equal(one, frames[2])


def test_mic2_device_temporal(rng):
    """Temporal device MIC2: residual planes batch through the fused
    decoder, frame chain reconstructs exactly."""
    from mic.parallel.multiframe import (
        compress_multi_frame_device,
        decompress_multi_frame_device,
    )

    base = (rng.standard_normal((16, 128)).cumsum(axis=1) * 10 + 900).astype(np.int32)
    f0 = base.clip(0, 4095).astype(np.uint16).ravel()
    f1 = ((base + rng.integers(-3, 4, base.shape) * 4).clip(0, 4095)).astype(np.uint16).ravel()
    blob = compress_multi_frame_device([f0, f1], 128, 16, int(max(f0.max(), f1.max())), temporal=True)
    frames, hdr = decompress_multi_frame_device(blob)
    assert hdr.temporal and hdr.frame_count == 2
    assert np.array_equal(np.asarray(frames[0], np.uint16).ravel(), f0)
    assert np.array_equal(np.asarray(frames[1], np.uint16).ravel(), f1)


def test_mic2_device_encode_batched(rng):
    """MIC2 with device_encode=True: one Pallas launch encodes every
    frame's strips; container decodes bit-exact in both temporal modes."""
    from mic.parallel.multiframe import (
        compress_multi_frame_device,
        decompress_multi_frame_device,
    )

    h, w = 32, 128
    img = (rng.standard_normal((h, w)).cumsum(axis=1) * 9 + 700)
    img = img.clip(0, 4095).astype(np.uint16)
    frames = [img.ravel(), np.roll(img, 1, 0).ravel(), np.roll(img, 2, 1).ravel()]
    for temporal in (False, True):
        blob = compress_multi_frame_device(frames, w, h, int(img.max()),
                                           temporal=temporal,
                                           device_encode=True)
        out, _hdr = decompress_multi_frame_device(blob)
        for got, want in zip(out, frames):
            assert np.array_equal(got, want), temporal
