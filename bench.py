"""Device decode and encode benchmark, one process on one device.

Rows (one JSON line each, every row names the device it ran on):

* ``decode``: a MicwDecodePlan over ``--replicas`` copies of each real
  image in web/testdata (CT 512x512, MR 256x256 greyscale; the WSI
  tissue tile as MWR3 RGB planes).  Times ``plan.run()`` to
  ``block_until_ready`` with the operands already on the device, and
  checks the assembled pixels of the last run bit for bit.
* ``encode``: ``device_encode.micw_compress_device_many`` over the same
  greyscale images with the default ``auto-fast`` predictors (host
  candidate generation included), byte-compared with the host encoder.

The last line is a summary with the geomean decode GB/s and ratio.  The
benchmark needs a GPU; ``--cpu`` runs the same code on the CPU at tiny
sizes as a rehearsal, and its numbers are not device numbers.

    python bench.py [--replicas N] [--runs N]
    python bench.py --cpu
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np

TESTDATA = ROOT / "web" / "testdata"
GREY = (("CT", "CT_2s.raw", 512, 512), ("MR", "MR_2s.raw", 256, 256))


def device_info() -> dict:
    """The JAX device this process runs on, plus the card's name and power
    limit from nvidia-smi when there is one."""
    import jax

    d = jax.devices()[0]
    info = {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}
    if d.platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=False)
        info["nvidia_smi"] = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    return info


def _grey_images(scale: int = 1):
    out = []
    for name, fn, w, h in GREY:
        px = np.fromfile(TESTDATA / fn, dtype="<u2")
        if scale > 1:  # rehearsal: a band from the middle of the image
            h //= scale
            px = px[w * h * (scale // 2) :][: w * h]
        out.append((name, px, w, h))
    return out


def time_plan(blobs, expected, runs: int):
    """Stage a plan, run it ``runs`` times warm, verify the last run.
    Returns (per-run seconds, stage seconds, first-run seconds, verified)."""
    import jax

    from mic.device.strips import MicwDecodePlan

    t0 = time.perf_counter()
    plan = MicwDecodePlan(blobs)
    stage_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(plan.run())
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(plan.run())
        times.append(time.perf_counter() - t0)
    got = plan.assemble(out)
    verified = all(np.array_equal(np.asarray(g[0]).ravel(), np.asarray(e).ravel())
                   for g, e in zip(got, expected))
    return times, stage_s, first_s, verified


def _decode_fields(times, stage_s, first_s, ok, nbytes, blob_bytes):
    med = float(np.median(times))
    return {"GBps": nbytes / med / 1e9, "median_s": med, "times_s": times,
            "stage_s": stage_s, "first_run_s": first_s,
            "ratio": nbytes / blob_bytes, "verified": ok}


def decode_row(name, blob, px, replicas: int, runs: int, dev: dict):
    res = time_plan([blob] * replicas, [px] * replicas, runs)
    return {"row": "decode", "name": name, "replicas": replicas, "runs": runs,
            **_decode_fields(*res, replicas * px.nbytes, replicas * len(blob)),
            "device": dev}


def rgb_row(name, rgb, w, h, replicas: int, runs: int, dev: dict):
    """MWR3: three MICW plane blobs through the same plan; the YCoCg-R
    inverse stays on the host, outside the timed run."""
    from mic.device.rgb_device import _pad_plane, _parse, micwr_compress
    from mic.ops.color import ycocgr_forward

    blob = micwr_compress(rgb, w, h, predictor="auto-fast")
    planes = _parse(blob)[2]
    exp = [_pad_plane(np.asarray(p, np.uint16), w, h)[0]
           for p in ycocgr_forward(rgb, w, h)]
    res = time_plan(list(planes) * replicas, exp * replicas, runs)
    return {"row": "decode", "name": name, "kind": "rgb", "replicas": replicas,
            "runs": runs,
            **_decode_fields(*res, replicas * rgb.nbytes, replicas * len(blob)),
            "device": dev}


def encode_row(images, dev: dict):
    from mic.device.device_encode import micw_compress_device_many
    from mic.device.strips import micw_compress

    specs = [(px, w, h, int(px.max())) for _n, px, w, h in images]
    micw_compress_device_many(specs[:1], predictor="auto-fast")  # compile
    t0 = time.perf_counter()
    dev_blobs = micw_compress_device_many(specs, predictor="auto-fast")
    dt = time.perf_counter() - t0
    host = [micw_compress(*s) for s in specs]
    raw = sum(px.nbytes for _n, px, _w, _h in images)
    return {"row": "encode", "images": [n for n, *_ in images], "MBps": raw / dt / 1e6,
            "seconds": dt, "byte_identical": dev_blobs == host, "device": dev}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--replicas", type=int, default=256)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at tiny sizes (no device numbers)")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    dev = device_info()
    if dev["platform"] != "gpu" and not args.cpu:
        print(f"bench: needs a GPU, found {dev['platform']} (--cpu rehearses)",
              file=sys.stderr)
        return 2
    if not args.cpu:
        from mic.device import enable_compile_cache

        enable_compile_cache()
    scale, replicas = (8, 2) if args.cpu else (1, args.replicas)

    from mic.device.strips import micw_compress

    rows = []
    images = _grey_images(scale)
    for name, px, w, h in images:
        blob = micw_compress(px, w, h, int(px.max()))
        rows.append(decode_row(name, blob, px, replicas, args.runs, dev))
        print(json.dumps(rows[-1]), flush=True)
    w, h = 512, 384 // scale
    rgb = np.fromfile(TESTDATA / "tissue.raw", dtype=np.uint8)
    rgb = rgb[w * h * 3 * (scale // 2) :][: w * h * 3]
    rows.append(rgb_row("tissue", rgb, w, h, replicas, args.runs, dev))
    print(json.dumps(rows[-1]), flush=True)
    enc = encode_row(images, dev)
    print(json.dumps(enc), flush=True)

    rates = [r["GBps"] for r in rows]
    ratios = [r["ratio"] for r in rows]
    ok = all(r["verified"] for r in rows) and enc["byte_identical"]
    print(json.dumps({
        "metric": "device_decode_geomean", "unit": "GB/s",
        "value": math.exp(sum(map(math.log, rates)) / len(rates)),
        "ratio_geomean": math.exp(sum(map(math.log, ratios)) / len(ratios)),
        "verified": ok, "rehearsal": args.cpu, "device": dev,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
