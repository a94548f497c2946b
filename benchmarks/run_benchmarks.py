"""Corpus benchmark driver — the analog of the reference's
run-paper-benchmarks.sh + paper-tables.py: compresses every available
corpus image through every pipeline variant and prints the ratio and
throughput tables (reference results format:
results/<timestamp>/paper-tables.txt).

Usage:
    python benchmarks/run_benchmarks.py [--fast] [--out results.json]

--fast limits to the small images.  Device decode speed is bench.py's.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

REF = Path("/root/reference/testdata")

CORPUS = [
    # name, loader args
    ("MR", ("bin", "MR_256_256_image.bin", 256, 256)),
    ("CT", ("bin", "CT_512_512_image.bin", 512, 512)),
    ("CT1", ("dcm", "compsamples_refanddir/IMAGES/REF/CT1_UNC")),
    ("CT2", ("dcm", "compsamples_refanddir/IMAGES/REF/CT2_UNC")),
    ("MR1", ("dcm", "compsamples_refanddir/IMAGES/REF/MR1_UNC")),
    ("MR2", ("dcm", "compsamples_refanddir/IMAGES/REF/MR2_UNC")),
    ("MR3", ("dcm", "compsamples_refanddir/IMAGES/REF/MR3_UNC")),
    ("MR4", ("dcm", "compsamples_refanddir/IMAGES/REF/MR4_UNC")),
    ("NM1", ("dcm", "compsamples_refanddir/IMAGES/REF/NM1_UNC")),
    ("XA1", ("dcm", "compsamples_refanddir/IMAGES/REF/XA1_UNC")),
]

# Reference ratios for context (results/20260518-112009/paper-tables.txt).
REFERENCE_MIC_RATIOS = {
    "MR": 2.35, "CT": 2.24, "CT1": 2.79, "CT2": 3.48,
    "MR1": 2.09, "MR2": 3.28, "MR3": 3.92, "MR4": 4.12, "NM1": 5.15,
}

RGB_CORPUS = ["US1", "VL1", "VL2", "VL3", "VL6"]
# Published RGB ratios (reference README.md:205-216, rgbbench_test.go).
REFERENCE_RGB_RATIOS = {
    "US1": 6.24, "VL1": 3.41, "VL2": 3.23, "VL3": 3.46, "VL6": 1.93,
}


def load_rgb_corpus():
    from mic.utils.dicom import read_dicom

    out = []
    for name in RGB_CORPUS:
        p = REF / f"compsamples_refanddir/IMAGES/REF/{name}_UNC"
        if not p.exists():
            continue
        img = read_dicom(str(p))
        if img.samples_per_pixel != 3:
            continue
        h, w = img.rows, img.cols
        rgb = img.pixels.reshape(h, w, 3).astype(np.uint8)
        out.append((name, rgb, w, h))
    return out


def rgb_tables(results: dict) -> None:
    """Compress the NEMA RGB corpus through the RGB pipelines — the
    analog of the reference's rgbbench_test.go:44-184 suite."""
    from mic.models.rgb import compress_rgb, decompress_rgb
    from mic.parallel.wsi import (
        WSIOptions,
        compress_wsi,
        decompress_wsi_region,
    )
    from mic.device.rgb_device import micwr_compress, micwr_decompress_host
    from mic.utils import charls

    corpus = load_rgb_corpus()
    if not corpus:
        print("\n(no RGB corpus images available)")
        return
    variants = {
        "MICR": (
            lambda rgb, w, h: compress_rgb(rgb, w, h),
            lambda b, w, h: np.asarray(decompress_rgb(b, w, h)).reshape(h, w, 3),
        ),
        "MWR3": (
            lambda rgb, w, h: micwr_compress(rgb, w, h),
            lambda b, w, h: np.asarray(micwr_decompress_host(b)[0]).reshape(h, w, 3),
        ),
        "MIC3": (
            lambda rgb, w, h: compress_wsi(
                rgb.ravel(), w, h, 3, 8, WSIOptions(pyramid_levels=1)
            ),
            lambda b, w, h: np.frombuffer(
                decompress_wsi_region(b, 0, 0, 0, w, h), dtype=np.uint8
            ).reshape(h, w, 3),
        ),
    }
    if charls.available():
        variants["JPEG-LS"] = (
            lambda rgb, w, h: charls.encode(rgb),
            lambda b, w, h: charls.decode(b),
        )
    print("\nTable 3 — RGB corpus (NEMA compsamples), lossless ratios")
    vnames = list(variants)
    print(f"{'Image':6} " + " ".join(f"{v:>14}" for v in vnames) + "   ref-MICR")
    geo: dict[str, list[float]] = {v: [] for v in vnames}
    for name, rgb, w, h in corpus:
        results.setdefault(name, {})
        row = [name.ljust(6)]
        for v, (cf, df) in variants.items():
            try:
                t0 = time.time()
                blob = cf(rgb, w, h)
                enc_t = time.time() - t0
                t0 = time.time()
                out = df(blob, w, h)
                dec_t = time.time() - t0
                exact = np.array_equal(np.asarray(out), rgb)
                r = {
                    "ratio": rgb.nbytes / len(blob),
                    "enc_MBps": rgb.nbytes / enc_t / 1e6,
                    "dec_MBps": rgb.nbytes / dec_t / 1e6,
                    "exact": bool(exact),
                    "bytes": len(blob),
                }
            except Exception as e:  # noqa: BLE001
                r = {"error": str(e)[:80]}
            results[name][v] = r
            if "ratio" in r and r["exact"]:
                row.append(f"{r['ratio']:>13.3f}x")
                geo[v].append(r["ratio"])
            else:
                row.append(f"{'ERR':>14}")
        row.append(f"   {REFERENCE_RGB_RATIOS.get(name, 0):.2f}")
        print(" ".join(row))
    print(
        f"{'geomean':6} "
        + " ".join(
            f"{math.exp(sum(map(math.log, g)) / len(g)):>13.3f}x" if g else f"{'-':>14}"
            for g in (geo[v] for v in vnames)
        )
    )


def load_corpus(fast: bool):
    from mic.utils.dicom import read_dicom

    out = []
    for name, spec in CORPUS:
        if fast and name not in ("MR", "CT", "CT1", "MR1"):
            continue
        try:
            if spec[0] == "bin":
                _, fn, h, w = spec
                p = REF / fn
                if not p.exists():
                    continue
                px = np.fromfile(p, dtype="<u2", count=h * w)
            else:
                p = REF / spec[1]
                if not p.exists():
                    continue
                img = read_dicom(str(p))
                if img.samples_per_pixel != 1:
                    continue
                px, h, w = img.pixels, img.rows, img.cols
            out.append((name, px, w, h, int(px.max())))
        except Exception as e:  # noqa: BLE001
            print(f"skip {name}: {e}", file=sys.stderr)
    return out


def bench_variant(name, fn, px, w, h, mx, dec_fn, reps=1):
    t0 = time.time()
    blob = fn(px, w, h, mx)
    enc_t = time.time() - t0
    t0 = time.time()
    for _ in range(reps):
        out = dec_fn(blob, w, h)
    dec_t = (time.time() - t0) / reps
    exact = np.array_equal(np.asarray(out).ravel()[: len(px)], px)
    return {
        "ratio": px.nbytes / len(blob),
        "enc_MBps": px.nbytes / enc_t / 1e6,
        "dec_MBps": px.nbytes / dec_t / 1e6,
        "exact": bool(exact),
        "bytes": len(blob),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    from mic.models.single_frame import (
        compress_single_frame,
        compress_single_frame_4state,
        compress_single_frame_8state,
        compress_single_frame_rans8,
        decompress_single_frame,
    )
    from mic.models.wavelet_pipeline import (
        wavelet_v2_rle_fse_compress,
        wavelet_v2_rle_fse_decompress,
    )
    from mic.ops.gapremoval import (
        compress_single_frame_gap_removal,
        decompress_single_frame_gap_removal,
    )
    from mic.parallel.strips import (
        compress_parallel_strips_4state,
        decompress_parallel_strips,
    )
    from mic.device.strips import micw_compress, micw_decompress_host

    try:
        from mic.native import (
            PRED_AVG,
            available as native_available,
            compress_frame_native,
            decompress_frame_native,
        )
    except Exception:  # noqa: BLE001
        native_available = lambda: False  # noqa: E731

    variants = {
        "MIC-2s": (
            compress_single_frame,
            lambda b, w, h: decompress_single_frame(b, w, h),
        ),
        "MIC-4s": (
            compress_single_frame_4state,
            lambda b, w, h: decompress_single_frame(b, w, h),
        ),
        "MIC-8s": (
            compress_single_frame_8state,
            lambda b, w, h: decompress_single_frame(b, w, h),
        ),
        "rANS-8s": (
            compress_single_frame_rans8,
            lambda b, w, h: decompress_single_frame(b, w, h),
        ),
        "GapRemoval": (
            compress_single_frame_gap_removal,
            lambda b, w, h: decompress_single_frame_gap_removal(b, w, h),
        ),
        "Wavelet-V2": (
            lambda px, w, h, mx: wavelet_v2_rle_fse_compress(px, h, w, mx, 5),
            lambda b, w, h: wavelet_v2_rle_fse_decompress(b)[0],
        ),
        "PICS-4s": (
            lambda px, w, h, mx: compress_parallel_strips_4state(px, w, h, mx, 4),
            lambda b, w, h: decompress_parallel_strips(b)[0],
        ),
        "MICW": (
            lambda px, w, h, mx: micw_compress(px, w, h, mx),
            lambda b, w, h: micw_decompress_host(b)[0],
        ),
    }
    if native_available():
        variants["MIC-4s-native"] = (
            lambda px, w, h, mx: compress_frame_native(px, w, h, mx, kind=PRED_AVG, n_states=4),
            lambda b, w, h: decompress_frame_native(b, w, h, PRED_AVG),
        )

    corpus = load_corpus(args.fast)
    results: dict[str, dict[str, dict]] = {}
    for name, px, w, h, mx in corpus:
        results[name] = {}
        for vname, (cf, df) in variants.items():
            try:
                results[name][vname] = bench_variant(name, cf, px, w, h, mx, df)
            except Exception as e:  # noqa: BLE001
                results[name][vname] = {"error": str(e)[:80]}

    # Table 1 — ratios.
    vnames = list(variants)
    print("\nTable 1 — Lossless compression ratios")
    print(f"{'Image':6} " + " ".join(f"{v:>14}" for v in vnames) + "   ref-MIC")
    geo: dict[str, list[float]] = {v: [] for v in vnames}
    for name in results:
        row = [name.ljust(6)]
        for v in vnames:
            r = results[name][v]
            if "ratio" in r and r["exact"]:
                row.append(f"{r['ratio']:>13.3f}x")
                geo[v].append(r["ratio"])
            else:
                row.append(f"{'ERR':>14}")
        ref = REFERENCE_MIC_RATIOS.get(name)
        row.append(f"   {ref:.2f}" if ref else "")
        print(" ".join(row))
    print(
        f"{'geomean':6} "
        + " ".join(
            f"{math.exp(sum(map(math.log, g)) / len(g)):>13.3f}x" if g else f"{'-':>14}"
            for g in (geo[v] for v in vnames)
        )
    )

    # Table 2 — host decode throughput.
    print("\nTable 2 — Host decode throughput (MB/s, single process)")
    print(f"{'Image':6} " + " ".join(f"{v:>14}" for v in vnames))
    for name in results:
        row = [name.ljust(6)]
        for v in vnames:
            r = results[name][v]
            row.append(f"{r.get('dec_MBps', 0):>14.1f}")
        print(" ".join(row))

    if not args.fast:
        rgb_tables(results)

    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1, default=str))
        print(f"\nwrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
