"""Transcode-on-ingest tests: reference-format blobs decode bit-exact
through the device-involved path (SURVEY §2.5:
the device answer for the reference's own formats)."""

import numpy as np
import pytest

from mic.models.single_frame import compress_single_frame_4state
from mic.parallel.strips import compress_parallel_strips_4state
from mic.device.ingest import ingest_plan, transcode_auto
from mic.device.strips import micw_decompress_host


@pytest.fixture()
def img(rng):
    a = (rng.standard_normal((96, 128)).cumsum(axis=1) * 14 + 900).astype(np.int32)
    return ((a >> 1) << 1).clip(0, 4095).astype(np.uint16)


def test_transcode_frame_bit_exact(img):
    h, w = img.shape
    px = img.ravel()
    ref = compress_single_frame_4state(px, w, h, int(px.max()))
    micw = transcode_auto(ref, w, h)
    out, ow, oh = micw_decompress_host(micw)
    assert (ow, oh) == (w, h)
    assert np.array_equal(out, px)


def test_transcode_pics_bit_exact(img):
    h, w = img.shape
    px = img.ravel()
    ref = compress_parallel_strips_4state(px, w, h, int(px.max()), 4)
    micw = transcode_auto(ref)
    out, ow, oh = micw_decompress_host(micw)
    assert (ow, oh) == (w, h)
    assert np.array_equal(out, px)


def test_ingest_plan_device_path(img, rng):
    """Mixed batch (frame + PICS) through the staged device plan."""
    h, w = img.shape
    px = img.ravel()
    img2 = (rng.standard_normal((64, 64)).cumsum(axis=0) * 9 + 700).astype(
        np.int32
    ).clip(0, 2047).astype(np.uint16)
    px2 = img2.ravel()
    blobs = [
        compress_single_frame_4state(px, w, h, int(px.max())),
        compress_parallel_strips_4state(px2, 64, 64, int(px2.max()), 2),
    ]
    plan = ingest_plan(blobs, dims=[(w, h), (64, 64)])
    out = plan.assemble(plan.run())
    assert np.array_equal(out[0][0], px)
    assert np.array_equal(out[1][0], px2)

def test_transcode_device_entropy(img):
    """entropy="device": the reference blob's entropy stage runs through
    the device ANS decode; the transcoded MICW must still be bit-exact
    (and byte-identical to the native-entropy transcode)."""
    h, w = img.shape
    px = img.ravel()
    for ref in (
        compress_single_frame_4state(px, w, h, int(px.max())),
        compress_parallel_strips_4state(px, w, h, int(px.max()), 4),
    ):
        micw_dev = transcode_auto(ref, w, h, entropy="device")
        micw_nat = transcode_auto(ref, w, h, entropy="native")
        assert micw_dev == micw_nat
        out, ow, oh = micw_decompress_host(micw_dev)
        assert (ow, oh) == (w, h)
        assert np.array_equal(out, px)


def test_ingest_plan_device_encode_batched(rng):
    """ingest_plan(device_encode=True) transcodes via ONE batched device
    encode launch; the plan must decode every frame bit-exact."""
    from mic.models.single_frame import compress_single_frame_4state
    from mic.device.ingest import ingest_plan

    frames, dims, pixels = [], [], []
    for h, w in [(32, 128), (48, 256)]:
        img = (rng.standard_normal((h, w)).cumsum(axis=1) * 9 + 700)
        px = img.clip(0, 4095).astype(np.uint16).ravel()
        frames.append(compress_single_frame_4state(px, w, h, int(px.max())))
        dims.append((w, h))
        pixels.append(px)
    plan = ingest_plan(frames, dims=dims, device_encode=True)
    for (out, w, h), px in zip(plan.assemble(plan.run()), pixels):
        assert np.array_equal(out, px)
