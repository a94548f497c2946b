#!/usr/bin/env bash
# CI gate — the one command a stranger runs to validate the repo
# (reference analog .github/workflows/go.yml:23-28).
#
#   1. build the native tier (C++ -> libmicfse.so)
#   2. full pytest suite on the virtual 8-device CPU mesh
#   3. multi-device dryrun: jit + run the sharded decode/encode paths
#
# Any format drift fails step 2 (tests/test_format_freeze.py pins
# container hashes), any sharding regression fails step 3.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== native build =="
make -C mic/native

echo "== pytest (virtual 8-device CPU mesh) =="
python -m pytest tests/ -q

echo "== multi-device dryrun =="
python __graft_entry__.py

echo "CI gate: OK"
