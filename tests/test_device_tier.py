"""Device-tier tests: wide-lane rANS (MICT), the device pipeline
stages, and the MICW strip container.

Cross-tier bit-equality is the contract (SURVEY.md §4): numpy host
decoder == JAX device decoder == original pixels.  On the CPU backend
the entropy kernel runs in interpret mode inside jitted programs; the
compiled GPU path is checked by chip_smoke.py and the gpu-marked tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mic.ops.deltarle import zz_delta_rle_compress, zz_delta_rle_decompress
from mic.ops.fse import IncompressibleError, UseRLEError
from mic.ops.predictors import delta_params, parse_escaped
from mic.ops.rle import RleEncoder, rle_decompress_stream, rle_expand
from mic.device.device_rans import mict_decode_numpy, mict_encode, mict_parse
from mic.device.pipeline import (
    parse_escaped_device,
    rle_expand_device,
    zz_delta_inverse_device,
)
from mic.device.strips import micw_compress, micw_decompress_host, micw_parse


@pytest.fixture()
def _jit_enabled():
    """Tests of staged plans run their compiled programs (the default;
    named so the dependency stays visible)."""
    with jax.disable_jit(disable=False):
        yield


@pytest.mark.parametrize("n,lanes", [(50, 8), (1000, 64), (65536, 512), (65537, 256)])
def test_mict_roundtrip(n, lanes, rng):
    data = (rng.standard_normal(n) * 5 + 50).clip(0, 255).astype(np.uint16)
    blob = mict_encode(data, lanes=lanes)
    out = mict_decode_numpy(blob)
    assert np.array_equal(out, data)


def test_mict_magic_and_counts(rng):
    data = (rng.standard_normal(5000) * 20 + 200).clip(0, 1023).astype(np.uint16)
    blob = mict_encode(data, lanes=128)
    assert blob[:2] == b"\xffW"
    L, tl, count, states, words, norm, sl, _alias = mict_parse(blob)
    assert L == 128 and count == 5000
    assert len(states) == 128


def test_mict_rejects_constant():
    with pytest.raises(UseRLEError):
        mict_encode(np.full(1000, 3, np.uint16), lanes=64)


def test_mict_rejects_wide_tiny():
    with pytest.raises((IncompressibleError, UseRLEError)):
        mict_encode(np.arange(65536, dtype=np.uint16), lanes=64)


def test_mict_corrupt_stream_detected(rng):
    data = (rng.standard_normal(20000) * 20 + 200).clip(0, 1023).astype(np.uint16)
    blob = bytearray(mict_encode(data, lanes=128))
    blob[-7] ^= 0x5A  # flip a word near the stream end
    with pytest.raises(ValueError):
        mict_decode_numpy(bytes(blob))  # final-state integrity check fires


def test_mict_vs_jax_decoder(rng):
    """numpy host decoder == JAX decoder, element for element."""
    from mic.device.rans_kernel import mict_decode_device

    data = (rng.standard_normal(30000) * 30 + 500).clip(0, 2047).astype(np.uint16)
    blob = mict_encode(data, lanes=256)
    a = mict_decode_numpy(blob)
    b = mict_decode_device(blob)
    assert np.array_equal(a, b)
    assert np.array_equal(a, data)


def test_rle_expand_device_matches_host(rng):
    data = np.concatenate(
        [np.full(500, 5), rng.integers(0, 200, 300), np.full(70, 3), np.zeros(2000)]
    ).astype(np.uint16)
    enc = RleEncoder(len(data), 1, 255)
    enc.encode(123)
    for v in data.tolist():
        enc.encode(v)
    enc.flush()
    stream = np.array(enc.out, dtype=np.uint16)
    host_tokens, _ = rle_expand(stream, 1, 127, None)
    m_pad = len(stream) + 8
    s_pad = np.zeros(m_pad, np.int32)
    s_pad[: len(stream) - 1] = stream[1:]
    tokens, n_tok = rle_expand_device(
        jnp.asarray(s_pad), jnp.int32(len(stream) - 1), jnp.int32(127), len(host_tokens) + 64
    )
    assert int(n_tok) == len(host_tokens)
    assert np.array_equal(np.asarray(tokens)[: len(host_tokens)], host_tokens)


def test_escape_parse_device_matches_host(rng):
    h, w = 24, 31
    img = rng.integers(0, 4000, (h, w)).astype(np.uint16)
    mx = int(img.max())
    _, delim = delta_params(mx)
    rle_stream = zz_delta_rle_compress(img.ravel(), w, h, mx)
    tokens, _ = rle_decompress_stream(rle_stream)
    tok = tokens[1:]
    v_host, raw_host = parse_escaped(tok, delim, w * h)
    pad = np.zeros(len(tok) + 32, np.int32)
    pad[: len(tok)] = tok
    v_dev, raw_dev = parse_escaped_device(
        jnp.asarray(pad), jnp.int32(len(tok)), jnp.int32(delim), w * h
    )
    assert np.array_equal(np.asarray(v_dev), v_host.astype(np.int32))
    assert np.array_equal(np.asarray(raw_dev), raw_host)


def test_zz_inverse_device_matches_host(rng):
    h, w = 16, 40
    img = rng.integers(0, 4000, (h, w)).astype(np.uint16)
    mx = int(img.max())
    thr, delim = delta_params(mx)
    rle_stream = zz_delta_rle_compress(img.ravel(), w, h, mx)
    tokens, _ = rle_decompress_stream(rle_stream)
    v, raw = parse_escaped(tokens[1:], delim, w * h)
    out = zz_delta_inverse_device(
        jnp.asarray(v.astype(np.int32)), jnp.asarray(raw), jnp.int32(thr), w, h
    )
    want = zz_delta_rle_decompress(rle_stream, w, h)
    assert np.array_equal(np.asarray(out), want)
    assert np.array_equal(want, img.ravel())


def test_micw_host_roundtrip(mr_image):
    px, h, w, mx = mr_image
    blob = micw_compress(px, w, h, mx, num_strips=4, lanes=128)
    assert blob[:4] == b"MICW"
    out, ow, oh = micw_decompress_host(blob)
    assert (ow, oh) == (w, h)
    assert np.array_equal(out, px)


def test_micw_device_matches_host(rng):
    h, w = 64, 96
    img = (rng.standard_normal((h, w)).cumsum(axis=1) * 20 + 1000).astype(np.uint16)
    img = (img >> 2 << 2).clip(0, 4095)
    mx = int(img.max())
    from mic.device.strips import micw_decompress_device

    blob = micw_compress(img.ravel(), w, h, mx, num_strips=2, lanes=64)
    a, _, _ = micw_decompress_host(blob)
    b, _, _ = micw_decompress_device(blob)
    assert np.array_equal(a, img.ravel())
    assert np.array_equal(a, b)


def test_micw_parse_fields(mr_image):
    px, h, w, mx = mr_image
    blob = micw_compress(px, w, h, mx, num_strips=4, lanes=128)
    width, height, n, strip_h, max_value, predictor, lanes, strips = micw_parse(blob)
    assert (width, height, n) == (w, h, 4)
    assert max_value == mx and lanes == 128
    assert len(strips) == 4
    from mic.device.strips import strip_predictor

    # v4: every strip carries its own mode (auto-fast default).
    assert all(strip_predictor(predictor, st[5]) in ("zzd", "vdd", "pdd", "zz", "avg", None)
               for st in strips)
    # Fixed-predictor compat: zzd request pins every strip to zzd/raw.
    blob_z = micw_compress(px, w, h, mx, num_strips=4, lanes=128, predictor="zzd")
    _, _, _, _, _, gp, _, strips_z = micw_parse(blob_z)
    assert gp == "zzd"
    assert all(strip_predictor(gp, st[5]) in ("zzd", None) for st in strips_z)


def test_soa_rle_roundtrip(rng):
    """SoA re-ordering preserves the symbol multiset and expands exactly."""
    from mic.ops.rle import RleEncoder, rle_expand, rle_to_soa, soa_expand

    data = np.concatenate(
        [np.full(300, 9), rng.integers(0, 200, 400), np.zeros(1500)]
    ).astype(np.uint16)
    enc = RleEncoder(len(data), 1, 255)
    enc.encode(77)
    for v in data.tolist():
        enc.encode(v)
    enc.flush()
    stream = np.array(enc.out, dtype=np.uint16)
    want, _ = rle_expand(stream, 1, 127, None)
    soa, n_runs, n_same = rle_to_soa(stream, 1, 127)
    assert sorted(soa.tolist()) == sorted(stream[1:].tolist())  # same multiset
    got = soa_expand(soa, n_runs, n_same, 127)
    assert np.array_equal(got, want)


def test_soa_rle_expand_device_matches_host(rng):
    from mic.ops.rle import RleEncoder, rle_to_soa, soa_expand
    from mic.device.pipeline import soa_rle_expand_device

    data = np.concatenate(
        [np.full(250, 5), rng.integers(0, 100, 300), np.full(64, 2), np.zeros(900)]
    ).astype(np.uint16)
    enc = RleEncoder(len(data), 1, 255)
    enc.encode(42)
    for v in data.tolist():
        enc.encode(v)
    enc.flush()
    stream = np.array(enc.out, dtype=np.uint16)
    soa, n_runs, n_same = rle_to_soa(stream, 1, 127)
    want = soa_expand(soa, n_runs, n_same, 127)
    pad = np.zeros(len(soa) + 16, np.int32)
    pad[: len(soa)] = soa
    tokens, n_tok = soa_rle_expand_device(
        jnp.asarray(pad), jnp.int32(n_runs), jnp.int32(n_same), jnp.int32(127),
        n_runs + 8, len(want) + 64,
    )
    assert int(n_tok) == len(want)
    assert np.array_equal(np.asarray(tokens)[: len(want)], want)


def test_micw_avg_predictor_device(rng):
    """MICW avg mode: wavefront inversion on device matches host + pixels."""
    from mic.device.strips import micw_decompress_device

    h, w = 40, 48
    img = (
        ((rng.standard_normal((h, w)).cumsum(axis=1) * 10 + 800).astype(np.int32) >> 2 << 2)
        .clip(0, 2047)
        .astype(np.uint16)
    )
    blob = micw_compress(img.ravel(), w, h, int(img.max()), lanes=64, predictor="avg")
    a, _, _ = micw_decompress_host(blob)
    b, _, _ = micw_decompress_device(blob)
    assert np.array_equal(a, img.ravel())
    assert np.array_equal(a, b)


def test_pallas_rans_kernel_interpret(rng):
    """The Pallas rANS kernel (interpret mode on CPU) matches the host
    decoder symbol-for-symbol, including the strip-padding branch
    (S=2 strips padded up to the program's group)."""
    from mic.device.device_rans import mict_decode_numpy, mict_parse
    from mic.device.rans_kernel import FlatStreams, rans_decode
    from mic.device.strips import micw_compress, micw_parse

    img = (rng.standard_normal((32, 128)).cumsum(axis=1) * 20 + 800).astype(np.int32)
    px = img.clip(0, 4095).astype(np.uint16).ravel()
    blob = micw_compress(px, 128, 32, int(px.max()), num_strips=2, lanes=128)
    *_, strips = micw_parse(blob)
    fs = FlatStreams([mict_parse(st[0]) for st in strips])
    out = np.asarray(rans_decode(*fs.device_operands(), n_steps=fs.n_steps))
    for i, st in enumerate(strips):
        want = mict_decode_numpy(st[0])
        # kernel emits [strip, step, lane]; stream order is lane-major per step
        got = out[i].reshape(-1)[: len(want)]
        assert np.array_equal(got, want)


def test_micw_pallas_roundtrip(rng):
    """Full MICW decode through the Pallas entropy kernel is bit-exact."""
    from mic.device.strips import micw_compress, micw_decompress_device

    img = (rng.standard_normal((48, 128)).cumsum(axis=1) * 15 + 900).astype(np.int32)
    px = img.clip(0, 4095).astype(np.uint16).ravel()
    blob = micw_compress(px, 128, 48, int(px.max()), num_strips=3, lanes=128)
    out, w, h = micw_decompress_device(blob)
    assert (w, h) == (128, 48)
    assert np.array_equal(np.asarray(out, dtype=np.uint16).ravel(), px)


def test_micw_decode_many_mixed(rng):
    """Batch decode of images with DIFFERENT widths/heights in one kernel
    launch (per-strip row widths + step-count buckets) is bit-exact."""
    from mic.device.strips import micw_compress, micw_decode_many

    # Sizes chosen to share one step bucket (keeps the interpret-mode
    # run fast) while mixing row widths 128 and 256 in one launch.
    imgs = []
    for h, w in ((16, 128), (8, 256), (12, 128)):
        img = (rng.standard_normal((h, w)).cumsum(axis=1) * 12 + 700).astype(np.int32)
        imgs.append((img.clip(0, 4095).astype(np.uint16).ravel(), w, h))
    blobs = [micw_compress(px, w, h, int(px.max()), num_strips=2, lanes=128)
             for px, w, h in imgs]
    outs = micw_decode_many(blobs)
    for (px, w, h), (got, gw, gh) in zip(imgs, outs):
        assert (gw, gh) == (w, h)
        assert np.array_equal(np.asarray(got, np.uint16).ravel(), px)


def test_micw_decode_batch_const_strip(rng):
    """The batch decoder must special-case mode-5 constant strips like
    every other decoder (regression: a batch decoder once np.frombuffer'd
    the 2-byte constant payload as w*rows pixels)."""
    from mic.device.strips import micw_compress, micw_decode_many

    img = (rng.standard_normal((48, 128)).cumsum(axis=1) * 15 + 900).astype(np.int32)
    img = img.clip(0, 4095).astype(np.uint16)
    img[32:] = 777  # third strip constant
    px = img.ravel()
    blob = micw_compress(px, 128, 48, int(px.max()), num_strips=3)
    out = micw_decode_many([blob])
    assert np.array_equal(np.asarray(out[0][0], np.uint16).ravel(), px)


def test_plan_verify_against(rng):
    """A staged plan runs repeatedly: every run assembles every replica
    bit-exactly, and runs stay on the device until assembled."""
    from mic.device.strips import MicwDecodePlan, micw_compress

    img = (rng.standard_normal((32, 128)).cumsum(axis=1) * 15 + 800).astype(np.int32)
    px = img.clip(0, 4095).astype(np.uint16).ravel()
    blob = micw_compress(px, 128, 32, int(px.max()), num_strips=2)
    plan = MicwDecodePlan([blob, blob])
    for _ in range(2):
        decoded = plan.run()
        assert all(isinstance(v, jax.Array) for v in decoded.values())
        out = plan.assemble(decoded)
        assert [o[1:] for o in out] == [(128, 32)] * 2
        assert all(np.array_equal(o[0], px) for o in out)


def test_plan_reuses_programs_for_a_new_batch(rng):
    """A second batch of distinct images of the same composition (the next
    series of a study) pads to the same size buckets and compiles
    nothing new."""
    from mic.device.strips import (
        _entropy_program,
        _post_program,
        micw_compress,
        micw_decode_many,
    )

    def batch():
        imgs = []
        for _ in range(5):
            img = (rng.standard_normal((32, 128)).cumsum(axis=1) * 15 + 800).astype(np.int32)
            imgs.append(img.clip(0, 4095).astype(np.uint16).ravel())
        return imgs, [micw_compress(px, 128, 32, int(px.max()), num_strips=2,
                                    predictor="zzd") for px in imgs]

    first, second = batch(), batch()
    assert first[1] != second[1]
    for imgs, blobs in (first, second):
        for px, (got, _w, _h) in zip(imgs, micw_decode_many(blobs)):
            assert np.array_equal(got, px)
        if blobs is first[1]:
            sizes = (_entropy_program._cache_size(), _post_program._cache_size())
    assert (_entropy_program._cache_size(), _post_program._cache_size()) == sizes


def test_device_encode_byte_identical(rng):
    """Device encode output blobs == host encoder blobs, including mixed
    tableLogs in one launch (per-strip renorm shifts)."""
    from mic.device.device_rans import mict_encode
    from mic.device.device_encode import mict_encode_device_batch

    streams = []
    for h, w, spread in ((24, 128, 8), (16, 128, 30)):
        img = (rng.standard_normal((h, w)).cumsum(axis=1) * spread + 1000).astype(np.int32)
        img = img.clip(0, 4095).astype(np.uint16)
        d = img.astype(np.int64)
        left = np.zeros_like(d)
        left[:, 1:] = d[:, :-1]
        d16 = (d - left).astype(np.uint16).astype(np.int16)
        zz = (((d16.astype(np.int32) << 1) ^ (d16.astype(np.int32) >> 15)) & 0xFFFF)
        streams.append(zz.astype(np.uint16).ravel())
    host = [mict_encode(s, lanes=128, max_table_log=11) for s in streams]
    dev = mict_encode_device_batch(streams, max_table_log=11)
    assert len({mict_parse(b)[1] for b in host}) > 1
    assert all(a == b for a, b in zip(host, dev))


def test_micw_compress_device_container(rng):
    """Container-level device encode == host micw_compress bytes, and the
    raw-strip fallback engages on constant strips."""
    from mic.device.device_encode import micw_compress_device
    from mic.device.strips import micw_compress, micw_decompress_host

    img = (rng.standard_normal((32, 128)).cumsum(axis=1) * 10 + 800).astype(np.int32)
    img[16:] = 500  # second strip constant -> encoder rejects -> raw mode
    px = img.clip(0, 4095).astype(np.uint16).ravel()
    a = micw_compress(px, 128, 32, int(px.max()), num_strips=2, predictor="zzd")
    b = micw_compress_device(px, 128, 32, int(px.max()), num_strips=2)
    assert a == b
    out, w, h = micw_decompress_host(b)
    assert np.array_equal(out, px)


def test_micwr_rgb_roundtrip(rng):
    """MWR3 device RGB container: YCoCg-R planes through MICW, batch
    decode of several tiles in shared launches, host == device."""
    from mic.device.rgb_device import (
        micwr_compress,
        micwr_decode_many,
        micwr_decompress_host,
    )

    tiles = []
    for _ in range(2):
        base = rng.integers(0, 200, (16, 128, 1), dtype=np.int32)
        rgb = np.clip(base + rng.integers(0, 40, (16, 128, 3)), 0, 255).astype(np.uint8)
        tiles.append(rgb.reshape(-1))
    blobs = [micwr_compress(t, 128, 16) for t in tiles]
    outs = micwr_decode_many(blobs)
    for t, blob, (got, w, h) in zip(tiles, blobs, outs):
        assert (w, h) == (128, 16)
        assert np.array_equal(got.ravel(), t)
        host, _, _ = micwr_decompress_host(blob)
        assert np.array_equal(host.ravel(), t)


@pytest.mark.parametrize("predictor", ["zzd", "vdd", "pdd", "zzr", "vdr", "pdr", "zz", "avg"])
def test_micw_property_sweep(predictor, rng):
    """Property sweep: random shapes x bit depths x predictors — host
    decode == XLA device decode == original pixels."""
    from mic.device.strips import micw_decompress_device

    for w, h, depth in ((37, 21, 12), (128, 32, 10), (65, 17, 16), (256, 8, 8)):
        hi = (1 << depth) - 1
        img = (rng.standard_normal((h, w)).cumsum(axis=1) * (hi / 80) + hi / 2).astype(np.int64)
        px = img.clip(0, hi).astype(np.uint16).ravel()
        blob = micw_compress(px, w, h, int(px.max()), num_strips=2, lanes=64,
                             predictor=predictor)
        a, aw, ah = micw_decompress_host(blob)
        assert (aw, ah) == (w, h) and np.array_equal(a, px), (predictor, w, h, depth)
        b, *_ = micw_decompress_device(blob)
        assert np.array_equal(np.asarray(b, np.uint16).ravel(), px), (predictor, w, h, depth)


def test_w3d_wsi_device(rng):
    """W3D1 device WSI: pyramid levels, constant-tile collapse, region
    decode — all tiles through the batched MWR3 path."""
    from mic.device.wsi_device import (
        w3d_compress,
        w3d_decompress_level,
        w3d_decompress_region,
        w3d_header,
    )

    W, H, TW, TH = 128, 64, 128, 32
    base = (rng.standard_normal((H, W, 1)).cumsum(0).cumsum(1) * 2 + 150)
    rgb = np.clip(base + rng.integers(-10, 10, (H, W, 3)), 0, 255).astype(np.uint8)
    rgb[:TH, :TW] = 240  # one constant background tile
    flat = rgb.reshape(-1)
    blob = w3d_compress(flat, W, H, tile_w=TW, tile_h=TH, num_levels=2)
    hdr, entries, _ = w3d_header(blob)
    assert hdr[:4] == (W, H, TW, TH) and hdr[4] == 2
    assert any(e[3] == 1 for e in entries)  # constant tile present
    # The level geometry and the region path (crossing a tile boundary,
    # one constant + one MWR3 tile).
    lvl1, w1, h1 = w3d_decompress_level(blob, 1)
    assert (w1, h1) == (W // 2, H // 2)
    reg, rw, rh = w3d_decompress_region(blob, 50, 20, 60, 40, level=0)
    assert (rw, rh) == (60, 40)
    want = rgb[20:60, 50:110].reshape(-1)
    assert np.array_equal(reg, want)


def test_micw_pdd_inverse_matches_host(rng):
    """pdd (plane-direct) device inverse == host two-cumsum inverse.

    The plane predictor's residual is the separable 2D difference
    p - W - N + NW (mod 2^16), so decode is two prefix sums — the device
    ratio mode (pipeline.pdd_inverse_device)."""
    from mic.device.pipeline import pdd_inverse_device
    from mic.device.strips import _pdd_syms

    for h, w in ((16, 40), (7, 129), (64, 64)):
        img = (rng.standard_normal((h, w)).cumsum(0).cumsum(1) * 15 + 900).astype(np.int64)
        px = img.clip(0, 4095).astype(np.uint16).ravel()
        syms = _pdd_syms(px, w, h)
        out = pdd_inverse_device(jnp.asarray(syms), w, h)
        assert np.array_equal(np.asarray(out), px), (h, w)


def test_micw_banded_roundtrip(rng):
    """FLAG_BANDED wide containers: column bands stacked vertically; host
    and device decoders both restore the original geometry bit-exactly."""
    from mic.device.strips import (
        MICW_BAND_W,
        band_merge,
        band_split,
        micw_band_info,
        micw_decompress_device,
    )

    h, w = 96, 1024
    img = (rng.standard_normal((h, w)).cumsum(1) * 25 + 2000).astype(np.int64)
    px = img.clip(0, 65535).astype(np.uint16).ravel()
    blob = micw_compress(px, w, h, int(px.max()), lanes=64)
    assert micw_band_info(blob) == (w, h)
    width, height, _n, _sh, _mv, _gp, _l, _strips = micw_parse(blob)
    assert width == MICW_BAND_W and height == h * (w // MICW_BAND_W)
    stacked, bw, sh2 = band_split(px, w, h)
    assert np.array_equal(band_merge(stacked, bw, w, h), px)
    a, aw, ah = micw_decompress_host(blob)
    assert (aw, ah) == (w, h) and np.array_equal(a, px)
    b, bw2, bh2 = micw_decompress_device(blob)
    assert (bw2, bh2) == (w, h) and np.array_equal(b, px)


def test_micw_narrow_not_banded(rng):
    """Images at or below MICW_BAND_W never get the banded layout."""
    from mic.device.strips import micw_band_info

    img = (rng.standard_normal((32, 512)).cumsum(1) * 25 + 2000).astype(np.int64)
    px = img.clip(0, 65535).astype(np.uint16).ravel()
    blob = micw_compress(px, 512, 32, int(px.max()), lanes=64)
    assert micw_band_info(blob) is None


def test_micw_rle_direct_modes(rng):
    """r-modes (SoA-RLE over bijective direct symbols): flat-background
    data picks them up; host == device == original."""
    from mic.device.strips import micw_decompress_device

    img = np.full((64, 128), 100, np.int64)
    img[8:40, 16:100] += (rng.standard_normal((32, 84)).cumsum(1) * 30).astype(np.int64)
    px = img.clip(0, 65535).astype(np.uint16).ravel()
    mx = int(px.max())
    for pred in ("zzr", "vdr", "pdr"):
        blob = micw_compress(px, 128, 64, mx, num_strips=2, predictor=pred)
        a, *_ = micw_decompress_host(blob)
        assert np.array_equal(a, px), pred
        b, *_ = micw_decompress_device(blob)
        assert np.array_equal(np.asarray(b), px), pred


def test_micw_plan_verify_batch(rng, _jit_enabled):
    """One plan over mixed geometries (incl. banded images and short last
    strips), every replica bit-exact."""
    from mic.device.strips import MicwDecodePlan, micw_compress

    imgs = []
    for (h, w) in ((96, 128), (100, 128), (128, 1024)):
        a = (rng.standard_normal((h, w)).cumsum(1) * 10 + 800).astype(np.int64)
        imgs.append((a.clip(0, 4095).astype(np.uint16).ravel(), w, h))
    blobs = [micw_compress(px, w, h, int(px.max()), num_strips=3)
             for px, w, h in imgs]
    plan = MicwDecodePlan(blobs * 2)
    out = plan.assemble(plan.run())
    for (px, w, h), (got, gw, gh) in zip(imgs * 2, out):
        assert (gw, gh) == (w, h)
        assert np.array_equal(got, px)


def test_micw_fused_vdd_plan(rng, _jit_enabled):
    """vdd strips (column prefix sum): a vertical-gradient image forces
    them; a 40-replica plan decodes every replica bit-exactly and
    host/device agree."""
    from mic.device.strips import (
        MicwDecodePlan,
        micw_compress,
        micw_decompress_host,
    )

    img = (np.arange(96)[:, None] * 37 + rng.integers(0, 6, (96, 256))).astype(np.int64)
    px = img.clip(0, 4095).astype(np.uint16).ravel()
    blob = micw_compress(px, 256, 96, int(px.max()), num_strips=2, predictor="vdd")
    a, *_ = micw_decompress_host(blob)
    assert np.array_equal(a, px)
    plan = MicwDecodePlan([blob] * 40)
    assert all(np.array_equal(o[0], px) for o in plan.assemble(plan.run()))


def test_w3d_device_encode_batched(rng):
    """w3d_compress(device_encode=True): every tile plane in one encode
    launch; region decode must stay bit-exact vs the host-encoded path's
    pixels (blobs differ: device uses the zzd pipeline, host 'auto')."""
    from mic.device.wsi_device import w3d_compress, w3d_decompress_region

    W, H, TW, TH = 128, 64, 128, 32
    base = (rng.standard_normal((H, W, 1)).cumsum(0).cumsum(1) * 2 + 150)
    rgb = np.clip(base + rng.integers(-10, 10, (H, W, 3)), 0, 255).astype(np.uint8)
    rgb[:TH, :TW] = 240
    flat = rgb.reshape(-1)
    blob = w3d_compress(flat, W, H, tile_w=TW, tile_h=TH, num_levels=1,
                        device_encode=True)
    reg, rw, rh = w3d_decompress_region(blob, 50, 20, 60, 40, level=0)
    assert (rw, rh) == (60, 40)
    assert np.array_equal(reg, rgb[20:60, 50:110].reshape(-1))


def test_micw_compress_device_banded_wide(rng):
    """Wide images must band identically on both encoders:
    micw_compress_device == host micw_compress(predictor="zzd") for
    width > MICW_BAND_W containers, including the FLAG_BANDED header
    extension and the band-scaled default strip geometry.

    The geometry/extension pin uses a constant 1024x256 image (all
    strips collapse to STRIP_MODE_CONST, so no kernel work, but the
    header, extension, strip count and table must still match exactly —
    an unscaled 128-row device default would emit 4 strips vs the
    host's band-scaled 2).  A small content image then covers the
    banded path through the real encode scan."""
    from mic.device.device_encode import micw_compress_device
    from mic.device.strips import (
        micw_band_info,
        micw_compress,
        micw_decompress_host,
        micw_parse,
    )

    const = np.full(1024 * 256, 777, np.uint16)
    host = micw_compress(const, 1024, 256, 777, predictor="zzd")
    dev = micw_compress_device(const, 1024, 256, 777)
    assert micw_band_info(dev) == (1024, 256)
    assert micw_parse(dev)[2] == 2  # band-scaled default: two 256-row strips
    assert host == dev

    img = (rng.standard_normal((8, 1024)).cumsum(axis=1) * 12 + 900)
    px = img.clip(0, 4095).astype(np.uint16).ravel()
    host = micw_compress(px, 1024, 8, int(px.max()), predictor="zzd")
    dev = micw_compress_device(px, 1024, 8, int(px.max()))
    assert micw_band_info(dev) == (1024, 8)
    assert host == dev
    out, w, h = micw_decompress_host(dev)
    assert (w, h) == (1024, 8)
    assert np.array_equal(out, px)
