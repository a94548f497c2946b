"""Device decode of the reference's byte-compatible tANS formats.

The bit-granular interleaved FSE streams (magic FF 02/04/84 —
fse2state.go:22, fse4state.go:195, fse8state.go:230) are the formats an
archive of existing .mic blobs is stored in.  ``pallas_tans`` decodes
them bit-exactly on device (interpret mode on CPU), so these tests pin
kernel-vs-host equality across state counts, table logs, alphabets, and
batch grouping.
"""

import numpy as np
import pytest

from mic.ops.fse_codec import (
    fse_compress,
    fse_compress_2state,
    fse_compress_4state,
    fse_compress_8state,
    fse_decompress_auto,
)
from mic.device.tans_device import (
    fse_decompress_device_batch,
    fse_parse_header,
)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _skewed(rng, n, nsym, p=1.3):
    w = 1.0 / np.arange(1, nsym + 1) ** p
    return rng.choice(nsym, size=n, p=w / w.sum()).astype(np.uint16)


@pytest.mark.parametrize(
    "comp,n_states",
    [
        (fse_compress_2state, 2),
        (fse_compress_4state, 4),
        (fse_compress_8state, 8),
    ],
)
def test_device_matches_host(comp, n_states, rng):
    data = _skewed(rng, 4096, 48)
    blob = comp(data)
    n, count, _body, _coder = fse_parse_header(blob)
    assert n == n_states and count == len(data)
    (out,) = fse_decompress_device_batch([blob])
    assert np.array_equal(out, fse_decompress_auto(blob))
    assert np.array_equal(out, data)


def test_batch_mixed_formats(rng):
    """A mixed batch (different N, table logs, lengths, alphabets) must
    come back blob-order, each bit-exact; 1-state blobs ride the host
    fallback inside the same call."""
    blobs, datas = [], []
    for i, (comp, n, nsym) in enumerate(
        [
            (fse_compress_4state, 1000, 16),
            (fse_compress_8state, 5000, 200),
            (fse_compress_2state, 300, 8),
            (fse_compress, 2000, 32),  # 1-state: host fallback path
            (fse_compress_4state, 7777, 500),
        ]
    ):
        data = _skewed(rng, n, nsym)
        blobs.append(comp(data))
        datas.append(data)
    outs = fse_decompress_device_batch(blobs)
    for out, data in zip(outs, datas):
        assert np.array_equal(out, data)


def test_batch_groups_same_format(rng):
    """Same-format streams of different lengths share one kernel launch
    (steps bucket); correctness must not depend on grouping."""
    datas = [_skewed(rng, n, 64) for n in (257, 1024, 4096, 4097)]
    blobs = [fse_compress_4state(d) for d in datas]
    outs = fse_decompress_device_batch(blobs)
    for out, data in zip(outs, datas):
        assert np.array_equal(out, data)


def test_large_table_log_falls_back(rng):
    """Streams beyond the kernel caps (tableLog > 13) decode via the
    host path — still correct, never an error."""
    data = _skewed(rng, 20000, 3000, p=0.6)
    blob = fse_compress_4state(data, table_log=14)
    (out,) = fse_decompress_device_batch([blob])
    assert np.array_equal(out, data)


def test_real_image_deltas(rng):
    """CT-like residual distribution (the actual payload shape these
    blobs carry): zigzag deltas of a smooth field."""
    img = (rng.standard_normal((64, 64)).cumsum(0).cumsum(1) * 4).astype(np.int64)
    px = (img - img.min()).clip(0, 4000).astype(np.uint16).ravel()
    d = np.diff(px.astype(np.int64), prepend=px[0].astype(np.int64))
    zz = ((d << 1) ^ (d >> 63)).astype(np.uint16)
    for comp in (fse_compress_2state, fse_compress_4state, fse_compress_8state):
        blob = comp(zz)
        (out,) = fse_decompress_device_batch([blob])
        assert np.array_equal(out, zz)


def test_rans8_device_matches_host(rng):
    """FF 08 (8-state rANS, rans8state.go:14-17) decodes on device
    through the SAME kernel as tANS — only the dtable construction
    differs (linear fill, ransu16.go:77-135).  Bit-exact vs the host
    coder, including in a batch mixed with tANS formats."""
    from mic.ops.rans import rans_compress_8state, rans_decompress_8state

    data = _skewed(rng, 4096, 48)
    blob = rans_compress_8state(data)
    n, count, _body, coder = fse_parse_header(blob)
    assert (n, coder) == (8, "rans") and count == len(data)
    (out,) = fse_decompress_device_batch([blob])
    assert np.array_equal(out, rans_decompress_8state(blob))
    assert np.array_equal(out, data)

    # Mixed batch: rANS groups separately from same-N tANS (FF 84).
    datas = [_skewed(rng, n, s) for n, s in ((1000, 16), (2222, 200), (512, 8))]
    blobs = [rans_compress_8state(datas[0]), fse_compress_8state(datas[1]),
             rans_compress_8state(datas[2])]
    outs = fse_decompress_device_batch(blobs)
    for o, d in zip(outs, datas):
        assert np.array_equal(o, d)
