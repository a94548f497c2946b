"""FF 41 (alias-mapped) streams through the device decode program.

Bit-exactness of the entropy kernel + escape substitution against the
numpy tier: raw-symbols mode across table logs / alphabets / escape
shares, and the zzd / vdd predictor-inverse post stages.  Runs in
interpret mode on CPU (the gpu-marked tests cover the compiled kernel)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mic.device import device_rans as dr  # noqa: E402
from mic.device.rans_kernel import FlatStreams  # noqa: E402
from mic.device.strips import (  # noqa: E402
    _vdd_syms,
    _zzd_syms,
    entropy_decode,
    post_decode,
)


def _decode_raw(parsed, predictor=None, width=0, esc=True):
    """Entropy-decode ``parsed`` strips in one launch; with a direct
    ``predictor`` the post stage inverts them to pixels."""
    fs = FlatStreams(parsed)
    syms = entropy_decode(
        *fs.device_operands(), jnp.asarray(fs.esc_vals),
        jnp.asarray(fs.esc_sides), n_steps=fs.n_steps,
        escapes=esc and fs.has_escapes)
    counts = fs.meta[:, 0]
    if predictor is not None:
        strip_h = int(counts[0]) // width
        zeros = jnp.zeros(len(parsed), jnp.int32)
        syms = post_decode(syms, zeros, zeros, zeros, width=width,
                           strip_h=strip_h, max_runs=128, max_tokens=128,
                           mid_count=0, delim=0, predictor=predictor)
    return np.asarray(syms), counts


def test_alias_kernel_raw_bit_exact():
    rng = np.random.default_rng(0)
    parsed, expected = [], []
    for n, alpha, esc_heavy in [
        (5000, 40, False), (8192, 300, False), (3000, 12, False),
        (6000, 500, True), (4096, 64, False),
    ]:
        if esc_heavy:
            base = np.minimum(rng.geometric(0.15, n), 30).astype(np.uint16)
            tail = rng.integers(0, 4000, n).astype(np.uint16)
            data = np.where(rng.random(n) < 0.08, tail, base)
        else:
            data = np.minimum(rng.geometric(0.08, n), alpha - 1).astype(np.uint16)
        blob = dr.mict_encode_alias(data, table_log=12)
        assert np.array_equal(dr.mict_decode_numpy(blob), data)
        parsed.append(dr.mict_parse(blob))
        expected.append(data)
    out, counts = _decode_raw(parsed)
    for i, data in enumerate(expected):
        got = out[i].reshape(-1)[: counts[i]].astype(np.uint16)
        assert np.array_equal(got, data), f"strip {i}"


def test_alias_kernel_fused_zzd():
    rng = np.random.default_rng(1)
    sh, width = 24, 256
    parsed, pixels = [], []
    for s in range(2):
        img = (rng.standard_normal((sh, width)).cumsum(axis=1) * 9 + 600)
        px = img.clip(0, 4095).astype(np.uint16).ravel()
        syms = _zzd_syms(px, width, sh)
        blob = dr.mict_encode_alias(syms, table_log=11)
        parsed.append(dr.mict_parse(blob))
        pixels.append(px)
    out, counts = _decode_raw(parsed, predictor="zzd", width=width)
    for i, px in enumerate(pixels):
        got = out[i].reshape(-1)[: counts[i]].astype(np.uint16)
        assert np.array_equal(got, px), f"strip {i}"
    # Escape-free variant (esc=False compiles the substitution out):
    # identical output when no strip has escapes.
    assert all(len(p[7][1]) == 0 for p in parsed)
    out2, _ = _decode_raw(parsed, predictor="zzd", width=width, esc=False)
    assert np.array_equal(out2, out)


def test_alias_kernel_fused_vdd():
    rng = np.random.default_rng(2)
    sh, width = 16, 256
    img = (rng.standard_normal((sh, width)).cumsum(axis=0) * 7 + 900)
    px = img.clip(0, 4095).astype(np.uint16).ravel()
    syms = _vdd_syms(px, width, sh)
    blob = dr.mict_encode_alias(syms, table_log=10)
    parsed = [dr.mict_parse(blob)]
    out, counts = _decode_raw(parsed, predictor="vdd", width=width)
    got = out[0].reshape(-1)[: counts[0]].astype(np.uint16)
    assert np.array_equal(got, px)


def test_mict_decode_device_substitutes_escapes():
    """Regression: the single-blob device decoder must substitute FF 41
    ESC placeholders like the numpy tier — an earlier decoder silently
    returned esc_val at every escape position."""
    from mic.device.rans_kernel import mict_decode_device

    rng = np.random.default_rng(5)
    base = np.minimum(rng.geometric(0.1, 6000), 40).astype(np.uint16)
    tail = rng.integers(0, 30000, 6000).astype(np.uint16)
    data = np.where(rng.random(6000) < 0.1, tail, base)
    blob = dr.mict_encode(data, alias=True)
    p = dr.mict_parse(blob)
    assert p[0] == 128  # alias default lane width is the kernel's 128
    assert p[7] is not None and len(p[7][1]) > 0, "no escapes triggered"
    assert np.array_equal(mict_decode := mict_decode_device(blob), data), (
        f"{int((mict_decode != data).sum())} mismatches"
    )


def test_alias_kernel_shares_program_across_tls():
    """Strips of DIFFERENT table logs decode in ONE launch of one
    program (no tl static)."""
    rng = np.random.default_rng(3)
    parsed, expected = [], []
    for tl, n in [(9, 4000), (11, 6000), (12, 8000)]:
        data = np.minimum(rng.geometric(0.05, n), 900).astype(np.uint16)
        blob = dr.mict_encode_alias(data, table_log=tl)
        parsed.append(dr.mict_parse(blob))
        expected.append(data)
    tls = {p[1] for p in parsed}
    assert len(tls) > 1, "trial set degenerated to one table log"
    out, counts = _decode_raw(parsed)
    for i, data in enumerate(expected):
        got = out[i].reshape(-1)[: counts[i]].astype(np.uint16)
        assert np.array_equal(got, data), f"strip {i}"


def test_device_alias_encode_byte_identity(rng):
    """mict_encode_device_batch(alias=True) must be byte-identical to the
    host alias encoder (incl. escape-folded streams), and
    micw_compress_device(entropy="alias") to the host container."""
    from mic.device.device_encode import mict_encode_device_batch, micw_compress_device
    from mic.device.strips import micw_compress

    streams = []
    for n, alpha, esc in [(5000, 40, 0), (3000, 12, 0), (6000, 30, 0.1)]:
        base = np.minimum(rng.geometric(0.08, n), alpha - 1).astype(np.uint16)
        if esc:
            tail = rng.integers(0, 30000, n).astype(np.uint16)
            base = np.where(rng.random(n) < esc, tail, base)
        streams.append(base)
    host = [dr.mict_encode_alias(s, table_log=12) for s in streams]
    dev = mict_encode_device_batch(streams, alias=True)
    for i, (hb, db) in enumerate(zip(host, dev)):
        assert hb == db, f"stream {i}"
        assert np.array_equal(dr.mict_decode_numpy(db), streams[i])

    img = (rng.standard_normal((32, 128)).cumsum(axis=1) * 9 + 700)
    px = img.clip(0, 4095).astype(np.uint16).ravel()
    hostc = micw_compress(px, 128, 32, int(px.max()), num_strips=2,
                          predictor="zzd", entropy="alias")
    devc = micw_compress_device(px, 128, 32, int(px.max()), num_strips=2,
                                entropy="alias")
    assert hostc == devc


def test_micw_device_container_contract_defaults(rng):
    """Regression: micw_compress_device must match the host container
    byte-for-byte WITHOUT explicit num_strips (default 128-row strips)
    and on dense wide-alphabet strips (host caps standard tl at 11,
    alias at 12 — the device batch must use the same caps)."""
    from mic.device.device_encode import micw_compress_device
    from mic.device.strips import micw_compress

    img = (rng.standard_normal((256, 512)).cumsum(axis=1) * 80 + 2000)
    px = img.clip(0, 4095).astype(np.uint16).ravel()
    for e in ("standard", "alias"):
        host = micw_compress(px, 512, 256, int(px.max()), predictor="zzd",
                             entropy=e)
        dev = micw_compress_device(px, 512, 256, int(px.max()), entropy=e)
        assert host == dev, e
