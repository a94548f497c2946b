"""End-to-end device decode of reference containers (MIC1 / PICS).

Pins device.ref_decode against the host tier: same blobs, bit-exact
pixels, across predictor pipelines, state counts, and strip layouts.
"""

import numpy as np
import pytest

from mic.models.single_frame import (
    compress_single_frame,
    compress_single_frame_4state,
    compress_single_frame_8state,
    compress_single_frame_grad,
    decompress_single_frame,
)
from mic.parallel.strips import (
    compress_parallel_strips_4state,
    compress_parallel_strips_8state,
    decompress_parallel_strips,
)
from mic.device.ref_decode import (
    decompress_frames_device,
    decompress_pics_device,
    decompress_pics_device_many,
)


@pytest.fixture
def rng():
    return np.random.default_rng(77)


def _image(rng, h, w, scale=5):
    img = (rng.standard_normal((h, w)).cumsum(0).cumsum(1) * scale).astype(np.int64)
    return (img - img.min()).clip(0, 60000).astype(np.uint16).ravel()


@pytest.mark.parametrize(
    "comp",
    [compress_single_frame, compress_single_frame_4state, compress_single_frame_8state],
)
def test_frame_device_matches_host(comp, rng):
    px = _image(rng, 64, 96)
    blob = comp(px, 96, 64, int(px.max()))
    (out,) = decompress_frames_device([blob], [(96, 64)])
    assert np.array_equal(out, decompress_single_frame(blob, 96, 64))
    assert np.array_equal(out, px)


def test_frame_grad_pipeline(rng):
    px = _image(rng, 48, 64)
    blob = compress_single_frame_grad(px, 64, 48, int(px.max()))
    (out,) = decompress_frames_device([blob], [(64, 48)], kind="grad")
    assert np.array_equal(out, px)


def test_frame_batch_mixed_sizes(rng):
    frames = [(_image(rng, h, w), w, h) for h, w in ((32, 64), (64, 64), (96, 128))]
    blobs = [compress_single_frame_4state(p, w, h, int(p.max())) for p, w, h in frames]
    outs = decompress_frames_device(blobs, [(w, h) for _p, w, h in frames])
    for out, (p, _w, _h) in zip(outs, frames):
        assert np.array_equal(out, p)


@pytest.mark.parametrize("comp", [compress_parallel_strips_4state, compress_parallel_strips_8state])
def test_pics_device_matches_host(comp, rng):
    px = _image(rng, 128, 96)
    blob = comp(px, 96, 128, int(px.max()), num_strips=4)
    out, w, h = decompress_pics_device(blob)
    host, hw, hh = decompress_parallel_strips(blob)
    assert (w, h) == (hw, hh) == (96, 128)
    assert np.array_equal(out, host)
    assert np.array_equal(out, px)


def test_pics_many_one_flat_batch(rng):
    imgs = [_image(rng, 64, 64), _image(rng, 96, 64), _image(rng, 64, 128)]
    geo = [(64, 64), (64, 96), (128, 64)]
    blobs = [
        compress_parallel_strips_4state(p, w, h, int(p.max()), num_strips=3)
        for p, (w, h) in zip(imgs, geo)
    ]
    results = decompress_pics_device_many(blobs)
    for (out, w, h), p, (gw, gh) in zip(results, imgs, geo):
        assert (w, h) == (gw, gh)
        assert np.array_equal(out, p)


def test_unsupported_kind_raises(rng):
    px = _image(rng, 32, 32)
    blob = compress_single_frame(px, 32, 32, int(px.max()))
    with pytest.raises(ValueError):
        decompress_frames_device([blob], [(32, 32)], kind="nope")


def test_mic2_device_independent(rng):
    """Reference-format MIC2 (independent mode): all frames' entropy
    stages pool on device; bit-exact vs the host container decode."""
    from mic.parallel.multiframe import compress_multi_frame, decompress_multi_frame
    from mic.device.ref_decode import decompress_mic2_device, decompress_mic2_frame_device

    frames = [_image(rng, 48, 64) for _ in range(4)]
    blob = compress_multi_frame(frames, 64, 48, int(max(f.max() for f in frames)), temporal=False)
    want, _hdr = decompress_multi_frame(blob)
    got, hdr = decompress_mic2_device(blob)
    assert hdr.frame_count == 4 and not hdr.temporal
    for g, w_ in zip(got, want):
        assert np.array_equal(g, w_)
    px, _ = decompress_mic2_frame_device(blob, 2)
    assert np.array_equal(px, want[2])


def test_mic2_device_temporal(rng):
    """Temporal MIC2 (multiframecompress.go:190-200): residual frames
    batch with frame 0's spatial decode; the add chain matches the host."""
    from mic.parallel.multiframe import compress_multi_frame, decompress_multi_frame
    from mic.device.ref_decode import decompress_mic2_device, decompress_mic2_frame_device

    base = _image(rng, 40, 56)
    frames = [base]
    for i in range(3):
        nxt = frames[-1].astype(np.int64) + (rng.integers(-3, 4, size=base.size))
        frames.append(nxt.clip(0, 60000).astype(np.uint16))
    blob = compress_multi_frame(frames, 56, 40, int(max(f.max() for f in frames)), temporal=True)
    want, _hdr = decompress_multi_frame(blob)
    got, hdr = decompress_mic2_device(blob)
    assert hdr.temporal
    for g, w_ in zip(got, want):
        assert np.array_equal(g, w_)
    px, _ = decompress_mic2_frame_device(blob, 3)
    assert np.array_equal(px, want[3])


def _wsi_rgb(rng, w, h):
    img = (rng.standard_normal((h, w, 3)).cumsum(0).cumsum(1) * 3 + 128)
    return img.clip(0, 255).astype(np.uint8).ravel()


def test_wsi_device_tile_region_level(rng):
    """Reference MIC3 serving on device (wsicompress.go:175-296): tile,
    region (cross-tile), and whole-level decodes must match the host
    tier byte-for-byte, RGB (YCoCg-R) and grey, edge crops included."""
    from mic.parallel.wsi import (
        WSIOptions,
        compress_wsi,
        decompress_wsi_region,
        decompress_wsi_tile,
        read_wsi_header,
    )
    from mic.device.ref_decode import (
        decompress_wsi_level_device,
        decompress_wsi_region_device,
        decompress_wsi_tile_device,
    )

    rgb = _wsi_rgb(rng, 150, 100)
    blob = compress_wsi(rgb, 150, 100, 3, 8, WSIOptions(tile_width=64, tile_height=64))
    hdr = read_wsi_header(blob)
    assert hdr.color_transform
    # every tile of level 0 (incl. cropped edge tiles)
    lv = hdr.levels[0]
    for ty in range(lv.tiles_y):
        for tx in range(lv.tiles_x):
            assert decompress_wsi_tile_device(blob, 0, tx, ty) == decompress_wsi_tile(blob, 0, tx, ty)
    # cross-tile region
    assert decompress_wsi_region_device(blob, 0, 50, 30, 80, 60) == decompress_wsi_region(blob, 0, 50, 30, 80, 60)
    # whole level = full region, all levels
    for lvl, lv in enumerate(hdr.levels):
        assert decompress_wsi_level_device(blob, lvl) == decompress_wsi_region(blob, lvl, 0, 0, lv.width, lv.height)

    # grey 16-bit path
    grey = _image(rng, 80, 110)
    gblob = compress_wsi(np.asarray(grey, "<u2").tobytes(), 110, 80, 1, 16,
                         WSIOptions(tile_width=64, tile_height=64))
    assert decompress_wsi_tile_device(gblob, 0, 0, 0) == decompress_wsi_tile(gblob, 0, 0, 0)
    assert decompress_wsi_region_device(gblob, 0, 32, 16, 60, 50) == decompress_wsi_region(gblob, 0, 32, 16, 60, 50)

    with pytest.raises(ValueError):
        decompress_wsi_tile_device(blob, 99, 0, 0)
    with pytest.raises(ValueError):
        decompress_wsi_region_device(blob, 0, 149, 99, 0, 0)
