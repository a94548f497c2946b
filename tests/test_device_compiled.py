"""Compiled-kernel correctness gate (GPU, < 60 s).

The interpret-mode suite can drift from what the GPU compiler actually
builds; these tests run the device decode and encode COMPILED on tiny
shapes and assert bit-exactness against the numpy tier.  Run on a card:

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu -q

(chip_smoke.py makes the same checks at full size.)  Elsewhere the
``gpu_backend`` fixture skips them.
"""

import numpy as np
import pytest

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu_backend")]


def _tiny_image(rng, h=16, w=128, scale=11, base=700, clip=4095):
    img = (rng.standard_normal((h, w)).cumsum(axis=1) * scale + base).astype(np.int32)
    return img.clip(0, clip).astype(np.uint16)


def test_fused_zzd_kernel_compiled(rng):
    from mic.device.strips import micw_compress, micw_decompress_device

    img = _tiny_image(rng)
    px = img.ravel()
    blob = micw_compress(px, 128, 16, int(px.max()), num_strips=2, predictor="zzd")
    out, w, h = micw_decompress_device(blob)
    assert np.array_equal(out, px)


def test_packed_kernel_rle_modes_compiled(rng):
    from mic.device.strips import micw_compress, micw_decompress_device

    img = _tiny_image(rng, h=32)
    img[16:] = np.where(img[16:] > 800, img[16:], 0)  # runs -> RLE modes
    px = img.ravel()
    for pred in ("zz", "avg", "vdd"):
        blob = micw_compress(px, 128, 32, int(px.max()), num_strips=2, predictor=pred)
        out, _, _ = micw_decompress_device(blob)
        assert np.array_equal(out, px), pred


def test_fused_rle_kernel_compiled(rng):
    """r-mode strips (entropy kernel + SoA-RLE expand + direct inverse)
    compiled, both stream families."""
    from mic.device.strips import micw_compress, micw_decompress_device

    img = _tiny_image(rng, h=32)
    img[16:] = np.where(img[16:] > 800, img[16:], 0)  # runs -> RLE wins
    px = img.ravel()
    for pred in ("zzr", "vdr", "pdr"):
        for ent in ("standard", "alias"):
            blob = micw_compress(px, 128, 32, int(px.max()), num_strips=2,
                                 predictor=pred, entropy=ent)
            out, _, _ = micw_decompress_device(blob)
            assert np.array_equal(out, px), (pred, ent)


def test_auto_mixed_modes_compiled(rng):
    from mic.device.strips import micw_compress, micw_decode_many

    img = _tiny_image(rng, h=48)
    img[32:] = 777  # constant strip
    px = img.ravel()
    blob = micw_compress(px, 128, 48, int(px.max()), num_strips=3)
    res = micw_decode_many([blob, blob])
    for out, w, h in res:
        assert np.array_equal(out, px)


def test_encode_kernel_compiled(rng):
    from mic.device.device_rans import mict_encode
    from mic.device.device_encode import mict_encode_device_batch

    img = _tiny_image(rng)
    d = img.astype(np.int64)
    left = np.zeros_like(d)
    left[:, 1:] = d[:, :-1]
    syms = (((d - left).astype(np.uint16).astype(np.int16).astype(np.int32) << 1)
            ^ ((d - left).astype(np.uint16).astype(np.int16).astype(np.int32) >> 15)
            & 0xFFFF).astype(np.uint16).ravel()
    host = mict_encode(syms, lanes=128, max_table_log=12)
    dev = mict_encode_device_batch([syms])[0]
    assert host == dev


def test_alias_kernel_compiled(rng):
    """FF 41 alias containers through the plan, compiled: direct modes
    and r-modes, plus the escape-folded case (spiky content -> alphabet
    > 255 kept)."""
    from mic.device.strips import micw_compress, micw_decompress_device

    img = _tiny_image(rng, h=32)
    px = img.ravel()
    for pred in ("auto-fast", "zzr"):
        blob = micw_compress(px, 128, 32, int(px.max()), num_strips=2,
                             predictor=pred, entropy="alias")
        out, _, _ = micw_decompress_device(blob)
        assert np.array_equal(out, px), pred
    spiky = img.astype(np.int32)
    m = rng.random(img.shape) < 0.05
    spiky = np.where(m, rng.integers(0, 4095, img.shape), spiky).astype(np.uint16)
    px2 = spiky.ravel()
    blob = micw_compress(px2, 128, 32, int(px2.max()), num_strips=2,
                         predictor="zzd", entropy="alias")
    out, _, _ = micw_decompress_device(blob)
    assert np.array_equal(out, px2)


def test_alias_encode_kernel_compiled(rng):
    """Device alias ENCODE, compiled: blobs must be byte-identical to the
    host alias encoder."""
    from mic.device.device_rans import mict_encode_alias
    from mic.device.device_encode import mict_encode_device_batch

    streams = []
    for n, alpha in [(4096, 60), (6000, 300)]:
        streams.append(
            np.minimum(rng.geometric(2.0 / alpha, n), alpha).astype(np.uint16))
    host = [mict_encode_alias(s, table_log=12) for s in streams]
    dev = mict_encode_device_batch(streams, alias=True)
    for hb, db in zip(host, dev):
        assert hb == db


def test_two_table_kernel_compiled():
    """tl=13 strip (beyond the MICW encoder caps, still inside the
    decoder's table packing) through the compiled kernel.

    tl=13 needs >=2^15 source symbols (optimalTableLog's maxBitsSrc cap,
    fsecompressu16.go:480-518) and a dense >512-wide alphabet to trigger
    the density bump — hence the 64Ki sample size."""
    from mic.device.device_rans import mict_decode_numpy, mict_encode, mict_parse
    from mic.device.rans_kernel import interpret_mode, mict_decode_device

    lrng = np.random.default_rng(20240814)
    syms = (lrng.standard_normal(65536) * 600 + 2000).clip(0, 4095).astype(np.uint16)
    blob = mict_encode(syms, lanes=128)
    assert mict_parse(blob)[1] == 13
    assert not interpret_mode()
    assert np.array_equal(mict_decode_device(blob), mict_decode_numpy(blob))
