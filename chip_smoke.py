"""Smoke run of the device tier on one GPU, through the normal entry points.

Phases (one JSON line each; any failure exits non-zero without the
final line):

1. device: JAX's device and the card's name and power limit.
2. series: a PACS-viewer series — 256 distinct 512x512 CT slices and 128
   distinct 256x256 MR slices made from the committed real slices with
   seeded shifts, flips and +-1-2 LSB noise on tissue pixels — encoded by
   ``micw_compress`` with its defaults and decoded in one
   ``micw_decode_many`` call, every slice bit-exact; then the warm split
   of the same decode through ``MicwDecodePlan`` (host staging, device
   run, copy back) and peak device memory; then a second, distinct series
   of the same composition (the next series a viewer opens), timed and
   bit-exact, with the number of decode programs it had to compile.
3. frozen: every committed device-format blob (MICW, MWR3, device MIC2)
   decoded on the device and compared with its .raw file.
4. reference: reference archives (PICS, MIC2, MIC3) decoded through
   ``ref_decode`` and compared with their .raw files.
5. encode: device encode of 32 CT slices, byte-identical to the host.
6. entropy: the entropy kernel against XLA's own scan on the CT series'
   operands (already on the device), both bit-identical and checked
   against the numpy decoder on sample strips; median times and the
   faster route.
7. compiled: the lowered entropy program holds the Triton kernel and no
   interpreter loop.

    python chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TESTDATA = ROOT / "web" / "testdata"
N_CT, N_MR, N_ENCODE = 256, 128, 32


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def make_series(rng, base, n, w, h, tissue):
    """n distinct slices from one real slice: a shift of up to 8 pixels,
    random flips, +-1-2 LSB noise on tissue pixels."""
    img0 = base.reshape(h, w).astype(np.int32)
    out = []
    for _ in range(n):
        img = np.roll(img0, (int(rng.integers(-8, 9)), int(rng.integers(-8, 9))), (0, 1))
        if rng.random() < 0.5:
            img = img[:, ::-1]
        if rng.random() < 0.5:
            img = img[::-1]
        noise = rng.integers(-2, 3, img.shape) * ((img > tissue) & (img < 65534))
        out.append((img + noise).astype(np.uint16).ravel())
    return out


def make_study(rng):
    """One CT+MR series: (images, blobs), blobs by ``micw_compress`` with
    its defaults."""
    from mic.device.strips import micw_compress

    ct = np.fromfile(TESTDATA / "CT_2s.raw", dtype="<u2")
    mr = np.fromfile(TESTDATA / "MR_2s.raw", dtype="<u2")
    images = ([(px, 512, 512) for px in make_series(rng, ct, N_CT, 512, 512, 1000)]
              + [(px, 256, 256) for px in make_series(rng, mr, N_MR, 256, 256, 100)])
    return images, [micw_compress(px, w, h, int(px.max())) for px, w, h in images]


def mismatched(images, outs):
    return [i for i, ((px, w, h), (got, gw, gh)) in enumerate(zip(images, outs))
            if (gw, gh) != (w, h) or not np.array_equal(got, px)]


def n_programs() -> int:
    """Decode programs compiled so far in this process."""
    from mic.device.strips import _entropy_program, _post_program

    return _entropy_program._cache_size() + _post_program._cache_size()


def phase_series(rng, state):
    import jax

    from mic.device.strips import MicwDecodePlan, micw_decode_many

    t0 = time.perf_counter()
    images, blobs = make_study(rng)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = micw_decode_many(blobs)
    decode_s = time.perf_counter() - t0
    bad = mismatched(images, outs)
    raw = sum(px.nbytes for px, _w, _h in images)
    state.update(images=images, blobs=blobs)
    # Warm split of the same decode: host staging, device run, copy back.
    t0 = time.perf_counter()
    plan = MicwDecodePlan(blobs)
    stage_s = time.perf_counter() - t0
    run_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = jax.block_until_ready(plan.run())
        run_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    plan.assemble(out)
    assemble_s = time.perf_counter() - t0
    entropy_s, post_s = _split_run(plan)
    stats = jax.devices()[0].memory_stats() or {}
    launches, post_programs = len(plan.run_entropy()), len(out)
    del plan, out
    # The next series: distinct slices, same composition.
    images2, blobs2 = make_study(rng)
    programs = n_programs()
    t0 = time.perf_counter()
    outs2 = micw_decode_many(blobs2)
    decode2_s = time.perf_counter() - t0
    bad2 = mismatched(images2, outs2)
    emit("series", ok=not bad and not bad2, slices=len(images), ct=N_CT, mr=N_MR,
         raw_bytes=raw, compressed_bytes=sum(map(len, blobs)),
         ratio=raw / sum(map(len, blobs)), mismatched=bad[:8],
         host_encode_s=encode_s, first_decode_s=decode_s,
         stage_s=stage_s, run_s=run_s, assemble_s=assemble_s,
         entropy_s=entropy_s, post_s=post_s,
         run_GBps=raw / float(np.median(run_s)) / 1e9,
         entropy_launches=launches, post_programs=post_programs,
         programs_first=programs,
         peak_bytes_in_use=stats.get("peak_bytes_in_use"),
         second_decode_s=decode2_s, second_new_programs=n_programs() - programs,
         second_compressed_bytes=sum(map(len, blobs2)), second_mismatched=bad2[:8])
    return not bad and not bad2


def _split_run(plan, runs: int = 5):
    """Median seconds of a plan's entropy launches and of its post
    programs, each timed to block_until_ready on its own."""
    import jax

    ent, post = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        syms = jax.block_until_ready(plan.run_entropy())
        t1 = time.perf_counter()
        jax.block_until_ready(plan.run_post(syms))
        ent.append(t1 - t0)
        post.append(time.perf_counter() - t1)
    return float(np.median(ent)), float(np.median(post))


def phase_frozen():
    from mic.device.rgb_device import micwr_decode_many
    from mic.device.strips import micw_decode_many
    from mic.parallel.multiframe import decompress_multi_frame_device

    def raw(name, dtype="<u2"):
        return np.fromfile(TESTDATA / f"{name}.raw", dtype=dtype)

    names = ["CT_dev", "MR_dev", "MR_dev_alias", "MR_dev_auto", "MR_dev_rbest",
             "wide_banded"]
    outs = micw_decode_many([(TESTDATA / f"{n}.micw").read_bytes() for n in names])
    res = {n: bool(np.array_equal(o[0], raw(n))) for n, o in zip(names, outs)}
    rgb, _w, _h = micwr_decode_many([(TESTDATA / "tissue_dev.mwr3").read_bytes()])[0]
    res["tissue_dev"] = bool(np.array_equal(np.frombuffer(bytes(rgb), np.uint8),
                                            raw("tissue_dev", np.uint8)))
    for n in ("series_dev_ind", "series_dev_tmp"):
        frames, _hdr = decompress_multi_frame_device((TESTDATA / f"{n}.mic2").read_bytes())
        res[n] = bool(np.array_equal(np.concatenate(frames), raw(n)))
    emit("frozen", ok=all(res.values()), blobs=res)
    return all(res.values())


def phase_reference():
    from mic.device.ref_decode import (
        decompress_mic2_device,
        decompress_pics_device,
        decompress_wsi_level_device,
    )

    def raw(name, dtype="<u2"):
        return np.fromfile(TESTDATA / f"{name}.raw", dtype=dtype)

    res = {}
    for n in ("CT_pics4", "CT_pics8"):
        px, _w, _h = decompress_pics_device((TESTDATA / f"{n}.pics").read_bytes())
        res[n] = bool(np.array_equal(px, raw(n)))
    frames, _hdr = decompress_mic2_device((TESTDATA / "series_tmp.mic2").read_bytes())
    res["series_tmp"] = bool(np.array_equal(np.concatenate(frames), raw("series_tmp")))
    lvl = decompress_wsi_level_device((TESTDATA / "tissue.mic3").read_bytes(), 0)
    res["tissue"] = bool(np.array_equal(np.frombuffer(lvl, np.uint8), raw("tissue", np.uint8)))
    emit("reference", ok=all(res.values()), archives=res)
    return all(res.values())


def phase_encode(state):
    from mic.device.device_encode import micw_compress_device_many

    specs = [(px, w, h, int(px.max())) for px, w, h in state["images"][:N_ENCODE]]
    t0 = time.perf_counter()
    dev = micw_compress_device_many(specs, predictor="auto-fast")
    dt = time.perf_counter() - t0
    same = [d == b for d, b in zip(dev, state["blobs"][:N_ENCODE])]
    emit("encode", ok=all(same), slices=len(specs), byte_identical=sum(same),
         seconds_incl_compile=dt)
    return all(same)


def _ct_operands(state):
    from mic.device.device_rans import mict_parse
    from mic.device.rans_kernel import FlatStreams
    from mic.device.strips import micw_parse, strip_predictor

    parsed, strips = [], []
    for blob in state["blobs"][:N_CT]:
        *_, gpred, _lanes, sts = micw_parse(blob)
        for st in sts:
            if strip_predictor(gpred, st[5]) is not None:
                parsed.append(mict_parse(st[0]))
                strips.append(st[0])
    fs = FlatStreams(parsed)
    n_steps = 1
    while n_steps < fs.n_steps:
        n_steps *= 2
    return fs, n_steps, parsed, strips


def phase_entropy(state, runs: int):
    import jax

    from mic.device.device_rans import alias_substitute_escapes, mict_decode_numpy
    from mic.device.rans_kernel import rans_decode, rans_decode_scan

    fs, n_steps, parsed, strips = _ct_operands(state)
    ops = jax.block_until_ready(fs.device_operands())
    k_out = jax.block_until_ready(rans_decode(*ops, n_steps=n_steps))
    s_out = jax.block_until_ready(rans_decode_scan(*ops, n_steps=n_steps))
    same = bool(np.array_equal(np.asarray(k_out), np.asarray(s_out)))
    k_host = np.asarray(k_out)
    sample = sorted({0, len(strips) - 1, *np.random.default_rng(1).integers(0, len(strips), 14)})
    numpy_ok = True
    for i in sample:
        got = k_host[i, : fs.meta[i, 0]]
        if parsed[i][7] is not None:
            got = alias_substitute_escapes(got, parsed[i][7])
        numpy_ok &= bool(np.array_equal(got, mict_decode_numpy(strips[i])))
    times = {"kernel": [], "xla_scan": []}
    for _ in range(runs):  # in turns
        for name, fn in (("kernel", rans_decode), ("xla_scan", rans_decode_scan)):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*ops, n_steps=n_steps))
            times[name].append(time.perf_counter() - t0)
    med = {k: float(np.median(v)) for k, v in times.items()}
    faster = min(med, key=med.get)
    emit("entropy", ok=same and numpy_ok and faster == "kernel", strips=len(strips),
         n_steps=n_steps, symbols=int(fs.meta[:, 0].sum()),
         bit_identical=same, numpy_sample_ok=numpy_ok, sample=len(sample),
         median_s=med, times_s=times, faster=faster,
         kernel_GBps=int(fs.meta[:, 0].sum()) * 2 / med["kernel"] / 1e9)
    state["entropy"] = (fs, n_steps)
    return same and numpy_ok and faster == "kernel"


def phase_compiled(state):
    import jax
    import jax.numpy as jnp

    from mic.device.rans_kernel import interpret_mode
    from mic.device.strips import _entropy_program

    fs, n_steps = state["entropy"]
    args = fs.device_operands() + (jnp.asarray(fs.esc_vals), jnp.asarray(fs.esc_sides))
    text = _entropy_program.lower(*args, n_steps=n_steps, escapes=fs.has_escapes).as_text()
    triton = "__gpu$xla.gpu.triton" in text
    loop = "stablehlo.while" in text
    ok = triton and not loop and not interpret_mode() and jax.default_backend() == "gpu"
    emit("compiled", ok=ok, triton_custom_call=triton, while_loop=loop,
         interpret=interpret_mode())
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=7)
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mic.device import enable_compile_cache

    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(smi, flush=True)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    emit("device", ok=True, nvidia_smi=smi, **device)

    rng = np.random.default_rng(args.seed)
    state: dict = {}
    phases = [
        ("series", lambda: phase_series(rng, state)),
        ("frozen", phase_frozen),
        ("reference", phase_reference),
        ("encode", lambda: phase_encode(state)),
        ("entropy", lambda: phase_entropy(state, args.runs)),
        ("compiled", lambda: phase_compiled(state)),
    ]
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            passed = fn()
        except Exception as e:  # report the phase and go on to the next
            emit(name, ok=False, error=f"{type(e).__name__}: {e}",
                 trace=traceback.format_exc()[-2000:])
            passed = False
        print(f"# {name}: {'ok' if passed else 'FAILED'} in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
        ok &= bool(passed)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
