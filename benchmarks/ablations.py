"""Ablation studies — the analog of the reference's ablation_test.go:
tableLog adaptation, predictor family, RLE contribution, gap removal, and
the MICT lane-count/strip-count sweep, plus the FSE table working-set
report (reference BenchmarkFSETableMemory).

Usage: python benchmarks/ablations.py [--fast]
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def tablelog_ablation(corpus):
    """Fixed tableLog 11/12/13 vs adaptive (reference TestTableLogAblation)."""
    from mic.ops.deltarle import delta_rle_compress
    from mic.ops.fse_codec import fse_compress_4state

    print("\n== tableLog ablation (Delta+RLE+FSE4 bytes) ==")
    print(f"{'Image':6} {'tl=11':>10} {'tl=12':>10} {'tl=13':>10} {'adaptive':>10}")
    for name, px, w, h, mx in corpus:
        rle = delta_rle_compress(px, w, h, mx)
        row = [name.ljust(6)]
        for tl in (11, 12, 13):
            # Fixed tableLog: bypass adaptation (patch the name the coder
            # resolves — fse_codec imported it into its own namespace).
            from mic.ops import fse as F
            from mic.ops import fse_codec as FC

            orig = FC.optimal_table_log
            FC.optimal_table_log = lambda hint, n, sl, _tl=tl: max(
                min(_tl, F.MAX_TABLE_LOG), F.MIN_TABLE_LOG
            )
            try:
                n_bytes = len(fse_compress_4state(rle))
            except Exception:
                n_bytes = 0
            finally:
                FC.optimal_table_log = orig
            row.append(f"{n_bytes:>10}")
        row.append(f"{len(fse_compress_4state(rle)):>10}")
        print(" ".join(row))


def predictor_ablation(corpus):
    """left/avg/grad/MED ratio comparison (reference TestPredictorAblation;
    published geomeans: left 3.38 / avg 3.46 / MED 3.52)."""
    from mic.models.single_frame import _fse_chain
    from mic.ops.deltarle import (
        delta_rle_compress,
        grad_delta_rle_compress,
        zz_delta_rle_compress,
    )
    from mic.ops.predictors import med_delta_compress
    from mic.ops.rle import RleEncoder
    from mic.ops.predictors import delta_params

    def med_rle(px, w, h, mx):
        # MED fused with RLE (the reference benches MED via the same fusion).
        from mic.ops.predictors import predictor_encode

        thr, delim = delta_params(mx)
        stream = predictor_encode(px, w, h, mx, "med")
        enc = RleEncoder(w, h, delim)
        enc.encode(mx)
        for v in stream.tolist():
            enc.encode(v)
        enc.flush()
        return np.array(enc.out, dtype=np.uint16)

    variants = {
        "left(zz)": zz_delta_rle_compress,
        "avg": delta_rle_compress,
        "grad": grad_delta_rle_compress,
        "med": med_rle,
    }
    print("\n== predictor ablation (Delta+RLE+FSE4 ratio) ==")
    print(f"{'Image':6} " + " ".join(f"{v:>10}" for v in variants))
    geo = {v: [] for v in variants}
    for name, px, w, h, mx in corpus:
        row = [name.ljust(6)]
        for vname, fn in variants.items():
            rle = fn(px, w, h, mx)
            blob = _fse_chain(np.asarray(rle, dtype=np.uint16), 4)
            r = px.nbytes / len(blob)
            geo[vname].append(r)
            row.append(f"{r:>9.3f}x")
        print(" ".join(row))
    print(
        f"{'geo':6} "
        + " ".join(
            f"{math.exp(sum(map(math.log, g))/len(g)):>9.3f}x" for g in geo.values()
        )
    )


def mict_sweep(corpus):
    """Device-format geometry sweep: lanes × strips vs ratio."""
    from mic.device.strips import micw_compress

    print("\n== MICW geometry sweep (ratio) ==")
    print(f"{'Image':6} " + " ".join(f"s{s}/L{l}".rjust(10) for s, l in SWEEP))
    for name, px, w, h, mx in corpus:
        row = [name.ljust(6)]
        for s, l in SWEEP:
            try:
                blob = micw_compress(px, w, h, mx, num_strips=s, lanes=l)
                row.append(f"{px.nbytes/len(blob):>9.3f}x")
            except Exception:
                row.append(f"{'ERR':>10}")
        print(" ".join(row))


SWEEP = [(1, 256), (1, 512), (1, 1024), (2, 1024), (8, 256)]


def entropy_family_ablation(corpus):
    """Stream-family axis: standard FF 57 (packed sweep, tl<=11) vs
    alias FF 41 (3-gather buckets, tl<=12) vs per-strip best-of, for
    both trial sets (docs/formats.md 'MICT alias-mapped')."""
    import math

    from mic.device.strips import micw_compress

    print("\n== MICW entropy family (ratio) ==")
    cols = [("auto-fast", "standard"), ("auto-fast", "alias"),
            ("auto-fast", "best"), ("auto-r", "standard"),
            ("auto-r", "best"), ("auto", "standard"), ("auto", "best")]
    lbl = {"auto-fast": "fast", "auto-r": "r", "auto": "auto"}
    print(f"{'Image':6} " + " ".join(f"{lbl[p]}/{e[:4]}".rjust(10) for p, e in cols))
    geos = [[] for _ in cols]
    for name, px, w, h, mx in corpus:
        row = [name.ljust(6)]
        for i, (p, e) in enumerate(cols):
            blob = micw_compress(px, w, h, mx, predictor=p, entropy=e)
            r = px.nbytes / len(blob)
            geos[i].append(math.log(r))
            row.append(f"{r:>9.3f}x")
        print(" ".join(row))
    print("geomean " + " ".join(
        f"{math.exp(sum(g)/len(g)):>9.3f}x" for g in geos if g))


def r_margin_ablation(corpus):
    """Decode-cost-aware selection axis: ratio cost of demanding an
    r-mode strip beat the best direct candidate by MICW_R_MARGIN (the
    hardware ratio-at-speed capture's policy knob)."""
    import math
    import os

    from mic.device.strips import micw_compress

    print("\n== MICW_R_MARGIN (auto-r/best ratio vs margin) ==")
    margins = ["0", "0.02", "0.05", "0.10", "0.25", "1.0"]
    geos = []
    for m in margins:
        os.environ["MICW_R_MARGIN"] = m
        logs = []
        for _name, px, w, h, mx in corpus:
            blob = micw_compress(px, w, h, mx, predictor="auto-r",
                                 entropy="best")
            logs.append(math.log(px.nbytes / len(blob)))
        geos.append(math.exp(sum(logs) / len(logs)))
    os.environ.pop("MICW_R_MARGIN", None)
    print("margin  " + " ".join(f"{m:>8}" for m in margins))
    print("geomean " + " ".join(f"{g:>7.3f}x" for g in geos))


def table_memory_report():
    """FSE working-set: dynamic table sizing vs fixed (reference
    BenchmarkFSETableMemory; README 'symbolTT+stateTable ~4-8 KB typical')."""
    from mic.ops.fse import build_ctable, build_dtable, histogram, normalize_count, optimal_table_log

    rng = np.random.default_rng(0)
    print("\n== FSE table working set ==")
    for label, data in [
        ("8-bit alphabet", rng.integers(0, 256, 100000).astype(np.uint16)),
        ("12-bit residuals", (rng.standard_normal(100000) * 200 + 2048).clip(0, 4095).astype(np.uint16)),
    ]:
        counts, _mc, sl = histogram(data)
        tl = optimal_table_log(11, len(data), sl)
        norm = normalize_count(counts, len(data), tl, sl)
        st, dnb, dfs, _ = build_ctable(norm, sl, tl)
        ns, sym, nb, _ = build_dtable(norm, sl, tl)
        enc_kb = (st.nbytes + dnb.nbytes + dfs.nbytes) / 1024
        dec_kb = (ns.nbytes + sym.nbytes + nb.nbytes) / 1024
        print(f"{label:18} tableLog={tl:2}  ctable {enc_kb:7.1f} KB  dtable {dec_kb:7.1f} KB")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    args = ap.parse_args()
    from benchmarks.run_benchmarks import load_corpus

    corpus = load_corpus(args.fast)
    tablelog_ablation(corpus)
    predictor_ablation(corpus)
    mict_sweep(corpus)
    entropy_family_ablation(corpus)
    r_margin_ablation(corpus)
    table_memory_report()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
