"""Web delivery-tier checks.

No JS engine ships in this build image (no node/bun/browser — verified),
so the browser acceptance test (web/test-decoder.html, the analog of the
reference's web/test-decoder.mjs) cannot execute here.  What CAN be
verified host-side:

* every blob in web/testdata decodes bit-exact through the Python tier
  (harness-data integrity — a JS failure then isolates the JS),
* the manifest is complete and self-consistent,
* mic-decoder.js is structurally sound (balanced nesting, every export
  defined, no accidental Python-isms).
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest

WEB = Path(__file__).resolve().parent.parent / "web"


@pytest.fixture(scope="module")
def manifest():
    p = WEB / "testdata" / "manifest.json"
    if not p.exists():
        pytest.skip("web/testdata not generated (python web/gen_testdata.py)")
    return json.loads(p.read_text())


def test_manifest_files_exist(manifest):
    assert len(manifest) >= 15
    kinds = {c["kind"] for c in manifest}
    assert kinds >= {"mic1", "pics", "pica", "mic2", "micr", "mic3"}
    for c in manifest:
        assert (WEB / "testdata" / c["file"]).exists(), c["file"]
        assert (WEB / "testdata" / c["expected"]).exists(), c["expected"]


def test_testdata_decodes_bitexact_python_tier(manifest):
    from mic.models.rgb import decompress_rgb
    from mic.models.single_frame import decompress_single_frame
    from mic.parallel.multiframe import decompress_multi_frame
    from mic.parallel.strips import decompress_parallel_strips
    from mic.parallel.strips_adaptive import decompress_parallel_strips_adaptive
    from mic.parallel.wsi import decompress_wsi_region, read_wsi_header
    from mic.utils.io import read_mic1, read_micr

    for c in manifest:
        blob = (WEB / "testdata" / c["file"]).read_bytes()
        raw = (WEB / "testdata" / c["expected"]).read_bytes()
        kind = c["kind"]
        if kind in ("micr", "mwr3") or (kind == "mic3" and c.get("channels") == 3):
            exp = np.frombuffer(raw, dtype=np.uint8)
        else:
            exp = np.frombuffer(raw, dtype="<u2")
        if kind == "mic1":
            w, h, _, payload = read_mic1(blob)
            got = decompress_single_frame(payload, w, h)
        elif kind == "pics":
            got, _w, _h = decompress_parallel_strips(blob)
        elif kind == "pica":
            got, _w, _h = decompress_parallel_strips_adaptive(blob)
        elif kind == "mic2":
            frames, _hdr = decompress_multi_frame(blob)
            got = np.concatenate(frames)
        elif kind == "micr":
            w, h, payload = read_micr(blob)
            got = decompress_rgb(payload, w, h)
        elif kind == "mic3":
            hdr = read_wsi_header(blob)
            got_b = decompress_wsi_region(blob, 0, 0, 0, hdr.width, hdr.height)
            got = np.frombuffer(got_b, dtype=np.uint8 if c.get("channels") == 3 else "<u2")
        elif kind == "micw":
            from mic.device.strips import micw_decompress_host

            got = micw_decompress_host(blob)[0]
        elif kind == "mwr3":
            from mic.device.rgb_device import micwr_decompress_host

            got = micwr_decompress_host(blob)[0]
        else:
            pytest.fail(f"unknown kind {kind}")
        assert np.array_equal(np.asarray(got).ravel(), exp), c["file"]


def test_js_decoder_structure():
    src = (WEB / "mic-decoder.js").read_text()
    # Balanced nesting outside strings/comments/regex-free code.
    stripped = re.sub(r"//[^\n]*", "", src)
    stripped = re.sub(r"/\*.*?\*/", "", stripped, flags=re.S)
    stripped = re.sub(r"'(?:[^'\\]|\\.)*'", "''", stripped)
    stripped = re.sub(r'"(?:[^"\\]|\\.)*"', '""', stripped)
    for o, c in ("{}", "()", "[]"):
        assert stripped.count(o) == stripped.count(c), f"unbalanced {o}{c}"
    # Every name in the export object resolves to a definition.
    ms = re.findall(r"return \{([^{}]*)\n\};", stripped, flags=re.S)
    assert ms, "export object not found"
    names = re.findall(r"\b([A-Za-z_]\w*)\b", ms[-1])
    skip = {"version"}
    for n in set(names) - skip:
        assert re.search(rf"(function {n}\b|class {n}\b|const {n}\b)", stripped), (
            f"exported but undefined: {n}"
        )
    # Python-isms that silently break JS.
    assert " elif " not in stripped
    assert re.search(r"\bTrue\b|\bFalse\b|\bNone\b", stripped) is None


def test_serve_and_harness_files_present():
    assert (WEB / "serve.py").exists()
    assert (WEB / "test-decoder.html").exists()
    html = (WEB / "test-decoder.html").read_text()
    assert "__MIC_TEST_RESULTS__" in html
    assert "mic-decoder.js" in html


def test_parallel_and_demo_files():
    for f in ("mic-decoder-parallel.js", "mic-worker.js", "index.html"):
        assert (WEB / f).exists(), f
    par = (WEB / "mic-decoder-parallel.js").read_text()
    assert "SharedArrayBuffer" in par and "crossOriginIsolated" in par
    wrk = (WEB / "mic-worker.js").read_text()
    assert "importScripts" in wrk and "worker_threads" in wrk
    demo = (WEB / "index.html").read_text()
    assert "decodeMicFile" in demo and "MICParallelDecoder" in demo
