"""Device batch encoder ≡ host encoder for the adaptive trial sets.

The ratio-target family (auto-r + best) must device-encode
byte-identically, so the archive-ingest path can default to it.  The
identity is structural — candidate generation and selection are the
same code (strips._strip_candidates/_strip_select) — but these tests pin
it end-to-end through the device encode scan (on the CPU here; the GPU
run is in tests/test_device_compiled.py).
"""

import numpy as np
import pytest

from mic.device.device_encode import micw_compress_device_many
from mic.device.strips import micw_compress, micw_decompress_host


@pytest.fixture(scope="module")
def images(rng_module):
    rng = rng_module
    a = (rng.standard_normal((32, 128)).cumsum(1) * 11 + 700).clip(0, 4095).astype(np.uint16)
    b = (rng.standard_normal((32, 128)).cumsum(0) * 9 + 600).astype(np.int32)
    b = np.where(b > 610, b, 0).clip(0, 4095).astype(np.uint16)  # runs
    c = a.copy()
    m = rng.random((32, 128)) < 0.02
    c[m] = rng.integers(0, 4095, int(m.sum())).astype(np.uint16)  # spikes
    d = np.full((32, 128), 777, np.uint16)
    d[:16] = b[:16]  # constant strip
    return [(x.ravel(), 128, 32, int(x.max()), 2) for x in (a, b, c, d)]


@pytest.fixture(scope="module")
def rng_module():
    return np.random.default_rng(7)


@pytest.mark.parametrize("pred", ["auto-r", "auto-fast"])
@pytest.mark.parametrize("ent", ["standard", "alias", "best"])
def test_device_many_byte_identity(images, pred, ent):
    host = [micw_compress(px, w, h, mx, num_strips=ns, predictor=pred,
                          entropy=ent)
            for px, w, h, mx, ns in images]
    dev = micw_compress_device_many(images, entropy=ent, predictor=pred)
    for i, (hb, db) in enumerate(zip(host, dev)):
        assert hb == db, (i, pred, ent)
    # and the containers actually hold the image
    for (px, w, h, _mx, _ns), blob in zip(images, dev):
        out, ow, oh = micw_decompress_host(blob)
        assert (ow, oh) == (w, h)
        assert np.array_equal(out, px)


def test_device_many_margin_identity(images, monkeypatch):
    monkeypatch.setenv("MICW_R_MARGIN", "0.05")
    host = [micw_compress(px, w, h, mx, num_strips=ns, predictor="auto-r",
                          entropy="best")
            for px, w, h, mx, ns in images]
    dev = micw_compress_device_many(images, entropy="best", predictor="auto-r")
    assert host == dev


def test_device_many_banded_auto_r(rng_module):
    rng = rng_module
    img = (rng.standard_normal((64, 1024)).cumsum(1) * 7 + 900).clip(
        0, 4095).astype(np.uint16)
    px = img.ravel()
    host = micw_compress(px, 1024, 64, int(px.max()), predictor="auto-r",
                         entropy="best")
    dev = micw_compress_device_many(
        [(px, 1024, 64, int(px.max()))], entropy="best", predictor="auto-r")[0]
    assert host == dev
