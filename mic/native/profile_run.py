"""Profile workload for the PGO build (`make -C mic/native pgo`):
exercises every hot loop (N-state encode/decode, threaded strips) over
the real corpus so gcc's -fprofile-use sees representative branches.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from benchmarks.run_benchmarks import load_corpus  # noqa: E402
from mic.native import (  # noqa: E402
    PRED_AVG,
    PRED_GRAD,
    compress_frame_native,
    decompress_frame_native,
    decompress_strips_native,
)
from mic.parallel.strips import compress_parallel_strips_4state  # noqa: E402


def main() -> int:
    corpus = load_corpus(False)
    if not corpus:
        print("no corpus; profiling skipped", file=sys.stderr)
        return 0
    for _name, px, w, h, mx in corpus:
        for ns in (2, 4, 8):
            blob = compress_frame_native(px, w, h, mx, kind=PRED_AVG, n_states=ns)
            for _ in range(3):
                decompress_frame_native(blob, w, h, PRED_AVG)
        gb = compress_frame_native(px, w, h, mx, kind=PRED_GRAD, n_states=4)
        decompress_frame_native(gb, w, h, PRED_GRAD)
        sb = compress_parallel_strips_4state(px, w, h, mx, 4)
        decompress_strips_native(sb)
    print("profile collected")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
