"""Generate web/testdata: every container format + expected raw pixels +
manifest.json, for the browser acceptance test (the analog of the
reference's mic-compress -testdata feeding web/test-decoder.mjs, which
compares ALL pixels against the originals, web/README.md:57-76).

Usage: python web/gen_testdata.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mic.models.rgb import compress_rgb  # noqa: E402
from mic.models.single_frame import (  # noqa: E402
    compress_single_frame,
    compress_single_frame_4state,
    compress_single_frame_8state,
    compress_single_frame_rans8,
)
from mic.parallel.multiframe import compress_multi_frame  # noqa: E402
from mic.parallel.strips import (  # noqa: E402
    compress_parallel_strips_4state,
    compress_parallel_strips_8state,
)
from mic.parallel.strips_adaptive import compress_parallel_strips_adaptive  # noqa: E402
from mic.parallel.wsi import WSIOptions, compress_wsi  # noqa: E402
from mic.utils.io import write_mic1, write_micr  # noqa: E402

REF = Path("/root/reference/testdata")
OUT = Path(__file__).resolve().parent / "testdata"


def main() -> int:
    OUT.mkdir(exist_ok=True)
    manifest = []

    def add(name: str, blob: bytes, kind: str, expected: np.ndarray, **meta):
        (OUT / name).write_bytes(blob)
        raw = name.rsplit(".", 1)[0] + ".raw"
        (OUT / raw).write_bytes(expected.tobytes())
        manifest.append({"file": name, "kind": kind, "expected": raw, **meta})

    images = []
    for nm, fn, w, h in (("MR", "MR_256_256_image.bin", 256, 256),
                         ("CT", "CT_512_512_image.bin", 512, 512)):
        p = REF / fn
        if p.exists():
            px = np.fromfile(p, dtype="<u2", count=w * h)
            images.append((nm, px, w, h, int(px.max())))

    for nm, px, w, h, mx in images:
        exp = px.astype("<u2")
        add(f"{nm}_2s.mic", write_mic1(w, h, compress_single_frame(px, w, h, mx)),
            "mic1", exp, width=w, height=h)
        add(f"{nm}_4s.mic", write_mic1(w, h, compress_single_frame_4state(px, w, h, mx)),
            "mic1", exp, width=w, height=h)
        add(f"{nm}_8s.mic", write_mic1(w, h, compress_single_frame_8state(px, w, h, mx)),
            "mic1", exp, width=w, height=h)
        add(f"{nm}_rans8.mic", write_mic1(w, h, compress_single_frame_rans8(px, w, h, mx)),
            "mic1", exp, width=w, height=h)
        add(f"{nm}_pics4.pics", compress_parallel_strips_4state(px, w, h, mx, 4),
            "pics", exp, width=w, height=h)
        add(f"{nm}_pics8.pics", compress_parallel_strips_8state(px, w, h, mx, 8),
            "pics", exp, width=w, height=h)
        add(f"{nm}_pica.pica", compress_parallel_strips_adaptive(px, w, h, mx, 4),
            "pica", exp, width=w, height=h)

    # MIC2: a short synthetic series derived from CT (shifted frames make
    # real temporal residuals), both independent and temporal modes.
    if images:
        nm, px, w, h, mx = images[-1]
        img = px.reshape(h, w)
        frames = [img, np.roll(img, 1, axis=0), np.roll(img, 2, axis=1)]
        flat = [f.ravel() for f in frames]
        exp = np.concatenate(flat).astype("<u2")
        add("series_ind.mic2", compress_multi_frame(flat, w, h, mx, temporal=False),
            "mic2", exp, width=w, height=h, frames=3)
        add("series_tmp.mic2", compress_multi_frame(flat, w, h, mx, temporal=True),
            "mic2", exp, width=w, height=h, frames=3)

    tis = REF / "wsi_tissue_512x384.rgb"
    if tis.exists():
        rgb = np.fromfile(tis, dtype=np.uint8)
        add("tissue.micr", write_micr(512, 384, compress_rgb(rgb, 512, 384)),
            "micr", rgb, width=512, height=384, channels=3)
        add("tissue.mic3", compress_wsi(rgb, 512, 384, 3, 8, WSIOptions()),
            "mic3", rgb, width=512, height=384, channels=3)

    # Grey MIC3 exercises the single-plane tile path.
    if images:
        nm, px, w, h, mx = images[0]
        grey_bytes = np.frombuffer(px.astype("<u2").tobytes(), dtype=np.uint8)
        add("grey.mic3", compress_wsi(grey_bytes, w, h, 1, 16, WSIOptions()),
            "mic3", px.astype("<u2"), width=w, height=h, channels=1)

    # Device formats: MICW, MWR3, device MIC2 (independent + temporal) —
    # the JS decoder covers the device tier's containers too.
    from mic.parallel.multiframe import compress_multi_frame_device
    from mic.device.strips import micw_compress

    for nm, px, w, h, mx in images:
        add(f"{nm}_dev.micw", micw_compress(px, w, h, mx), "micw",
            px.astype("<u2"), width=w, height=h)
    if images:
        # Alias-entropy (FF 41) and ratio-first ("auto": r-modes + escaped)
        # containers so the JS harness covers every stream/mode family.
        nm, px, w, h, mx = images[0]
        add(f"{nm}_dev_alias.micw",
            micw_compress(px, w, h, mx, entropy="alias"), "micw",
            px.astype("<u2"), width=w, height=h)
        add(f"{nm}_dev_auto.micw",
            micw_compress(px, w, h, mx, predictor="auto"), "micw",
            px.astype("<u2"), width=w, height=h)
        # Ratio-at-speed capture family: r-mode strips with per-strip
        # entropy selection (FF 57 and FF 41 mixed in one container).
        add(f"{nm}_dev_rbest.micw",
            micw_compress(px, w, h, mx, predictor="auto-r", entropy="best"),
            "micw", px.astype("<u2"), width=w, height=h)
    if images:
        # FLAG_BANDED container: widths > 512 divisible by 512 store
        # stacked column bands + an 8-byte orig-dims extension; the JS
        # decoder must un-band.
        nm, px, w, h, mx = images[-1]
        img = px.reshape(h, w)
        wide = np.hstack([img, np.fliplr(img)])
        wpx = wide.ravel()
        add("wide_banded.micw",
            micw_compress(wpx, 2 * w, h, int(wpx.max())), "micw",
            wpx.astype("<u2"), width=2 * w, height=h)
    if images:
        nm, px, w, h, mx = images[-1]
        img = px.reshape(h, w)
        frames = [img.ravel(), np.roll(img, 1, 0).ravel(), np.roll(img, 2, 1).ravel()]
        exp = np.concatenate(frames).astype("<u2")
        add("series_dev_ind.mic2", compress_multi_frame_device(frames, w, h, mx),
            "mic2", exp, width=w, height=h, frames=3)
        add("series_dev_tmp.mic2",
            compress_multi_frame_device(frames, w, h, mx, temporal=True),
            "mic2", exp, width=w, height=h, frames=3)
    tis2 = REF / "wsi_tissue_512x384.rgb"
    if tis2.exists():
        from mic.device.rgb_device import micwr_compress

        rgb = np.fromfile(tis2, dtype=np.uint8)
        add("tissue_dev.mwr3", micwr_compress(rgb, 512, 384), "mwr3",
            rgb, width=512, height=384, channels=3)

    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1))
    print(f"wrote {len(manifest)} cases to {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
