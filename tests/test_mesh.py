"""Multi-device sharding tests on the virtual 8-device CPU mesh:
the strip axis shards with shard_map and decodes exactly
(SURVEY.md §5: strips/tiles/frames become sharded batch axes)."""

import numpy as np
import pytest


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_strip_decode(n_devices):
    import jax

    if len(jax.devices()) < n_devices:
        pytest.skip(f"need {n_devices} devices")
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import __graft_entry__ as ge

    ge.dryrun_multichip(n_devices)  # raises on any mismatch


def test_entry_compiles_and_runs():
    import jax
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape[0] == 4
    assert out.dtype == np.uint16


def test_sharded_pallas_decode():
    """The decode program (entropy kernel + post stages) under shard_map
    on an 8-device CPU mesh, one zzd strip per device."""
    import jax

    from mic.device.device_rans import mict_parse
    from mic.device.mesh import decode_strips_sharded, make_strip_mesh
    from mic.device.strips import micw_compress, micw_parse, strip_group_operands

    devs = jax.devices()[:8]
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(5)
    img = (rng.standard_normal((64, 128)).cumsum(axis=1) * 9 + 700).astype(np.int32)
    px = img.clip(0, 4095).astype(np.uint16).ravel()
    blob = micw_compress(px, 128, 64, int(px.max()), num_strips=8, lanes=128,
                         predictor="zzd")
    width, height, ns, sh, mv, _gp, _l, strips = micw_parse(blob)
    parsed = [mict_parse(st[0]) for st in strips]
    arrays, static = strip_group_operands(parsed, strips, "zzd", width, sh, mv)
    out = decode_strips_sharded(make_strip_mesh(devs), *arrays, **static)
    got = np.asarray(out)
    for i in range(ns):
        assert np.array_equal(got[i][: sh * width], px[i * sh * width : (i + 1) * sh * width])


def _encode_check(alias):
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("need 8 devices")
    import __graft_entry__ as ge
    from mic.device.device_encode import rans_encode_scan
    from mic.device.mesh import encode_strips_sharded, make_strip_mesh

    args = ge.encode_operands(np.random.default_rng(21), 8, n=4096, alias=alias)
    ref = rans_encode_scan(*args, lanes=128)
    got = encode_strips_sharded(make_strip_mesh(jax.devices()[:8]), *args, lanes=128)
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_sharded_encode():
    """Device encode under shard_map: sharded outputs == single-program
    outputs, strip axis split across the 8-device CPU mesh."""
    _encode_check(alias=False)


def test_sharded_alias_decode():
    """FF 41 strips of MIXED table logs under shard_map in one sharded
    executable (no tableLog static)."""
    import jax

    from mic.device.device_rans import mict_encode_alias, mict_parse
    from mic.device.mesh import decode_strips_sharded, make_strip_mesh
    from mic.device.strips import _zzd_syms, strip_group_operands

    devs = jax.devices()[:8]
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(9)
    width, strip_h = 128, 64
    pixels, parsed, strips = [], [], []
    for s in range(8):
        rows = strip_h if s % 2 == 0 else 16  # 8192 vs 2048 symbols
        img = (rng.standard_normal((rows, width)).cumsum(axis=1) * 9 + 700)
        px = img.clip(0, 4095).astype(np.uint16).ravel()
        syms = _zzd_syms(px, width, rows)
        blob = mict_encode_alias(syms, table_log=11)
        pixels.append(px)
        parsed.append(mict_parse(blob))
        strips.append((blob, len(syms), len(syms), 0, 0, 2))
    assert len({p[1] for p in parsed}) > 1
    arrays, static = strip_group_operands(parsed, strips, "zzd", width,
                                          strip_h, 4095)
    out = decode_strips_sharded(make_strip_mesh(devs), *arrays, **static)
    got = np.asarray(out)
    for i, px in enumerate(pixels):
        assert np.array_equal(got[i][: len(px)], px)


def test_sharded_alias_encode():
    """FF 41 alias permutations through the sharded encode must equal the
    single-program encode bit for bit."""
    _encode_check(alias=True)
