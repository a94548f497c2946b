"""Contracts of the benchmark (bench.py), exercised on the CPU at tiny
sizes: every row names its device, verification is real, the GPU
requirement holds without the rehearsal flag, and the timed plans cover
every staging family."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench


def test_small_group_plans_are_macro_timable():
    """Every predictor family the plan stages (r-modes, classic RLE,
    direct) times and verifies through bench.time_plan."""
    from mic.device.strips import micw_compress

    r = np.random.default_rng(5)
    yy, xx = np.mgrid[0:128, 0:128]
    px = ((np.sin(xx / 7.0) * 300 + yy * 5 + 900)
          + r.integers(-3, 4, (128, 128))).clip(0, 4095).astype(np.uint16).ravel()
    for pred, ent in (("auto-r", "best"), ("zzr", "standard"),
                      ("avg", "standard"), ("zzd", "standard")):
        blob = micw_compress(px, 128, 128, int(px.max()),
                             predictor=pred, entropy=ent)
        times, _stage, _first, ok = bench.time_plan([blob, blob], [px, px], 2)
        assert ok, (pred, ent)
        assert len(times) == 2 and all(t > 0 for t in times)


def test_time_plan_detects_a_wrong_pixel():
    """Verification compares every pixel: a wrong expectation fails."""
    from mic.device.strips import micw_compress

    px = (np.arange(64 * 128) % 251).astype(np.uint16)
    blob = micw_compress(px, 128, 64, int(px.max()))
    bad = px.copy()
    bad[-1] ^= 1
    assert bench.time_plan([blob, blob], [px, px], 1)[3]
    assert not bench.time_plan([blob, blob], [px, bad], 1)[3]


def test_device_info_names_the_device():
    import jax

    info = bench.device_info()
    assert info["platform"] == jax.devices()[0].platform
    assert info["kind"] == jax.devices()[0].device_kind
    assert info["count"] == len(jax.devices())


def test_needs_gpu_without_rehearsal_flag(capsys):
    """On the CPU the benchmark refuses to run unless told it rehearses,
    and prints no result row."""
    assert bench.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_decode_row_on_cpu():
    px = (np.random.default_rng(1).standard_normal((64, 128)).cumsum(1) * 9
          + 900).clip(0, 4095).astype(np.uint16).ravel()
    from mic.device.strips import micw_compress

    blob = micw_compress(px, 128, 64, int(px.max()))
    dev = bench.device_info()
    row = bench.decode_row("X", blob, px, 2, 2, dev)
    assert row["verified"] is True
    assert row["GBps"] > 0 and row["ratio"] > 1.0
    assert row["device"] == dev


def test_r_margin_selector(monkeypatch):
    """MICW_R_MARGIN makes the auto-r selector decode-cost-aware: an
    impossible margin collapses the container to the direct family
    (byte-identical to auto-fast); margin 0 keeps pure-size selection;
    either container round-trips."""
    from mic.device.strips import micw_compress, micw_decompress_host

    r = np.random.default_rng(9)
    base = np.repeat(r.integers(0, 600, 2048), 8)[: 128 * 96]
    px = base.astype(np.uint16)  # runs -> r-modes win at margin 0

    monkeypatch.delenv("MICW_R_MARGIN", raising=False)
    b0 = micw_compress(px, 128, 96, int(px.max()),
                       predictor="auto-r", entropy="standard")
    monkeypatch.setenv("MICW_R_MARGIN", "1.0")
    b1 = micw_compress(px, 128, 96, int(px.max()),
                       predictor="auto-r", entropy="standard")
    bf = micw_compress(px, 128, 96, int(px.max()),
                       predictor="auto-fast", entropy="standard")
    assert b1 == bf
    assert len(b0) <= len(b1)
    for blob in (b0, b1):
        out, w, h = micw_decompress_host(blob)
        assert np.array_equal(np.asarray(out).ravel(), px)


def test_encode_row_on_cpu():
    images = [(n, px, w, h) for n, px, w, h in bench._grey_images(8)]
    row = bench.encode_row(images, bench.device_info())
    assert row["byte_identical"] is True
    assert row["images"] == ["CT", "MR"]


def test_rgb_row_measures_on_cpu():
    """The RGB row through the plan on a tiny synthetic RGB image (CPU
    interpret kernels)."""
    rng = np.random.default_rng(3)
    base = (rng.standard_normal((32, 128, 1)).cumsum(0) * 5 + 120)
    rgb = np.clip(base + rng.integers(0, 3, (32, 128, 3)), 0, 255).astype(np.uint8)
    row = bench.rgb_row("RGBX", rgb.reshape(-1), 128, 32, 2, 2, bench.device_info())
    assert row["kind"] == "rgb"
    assert row["verified"] is True
    assert row["GBps"] > 0
    assert row["ratio"] > 1.0
