#!/usr/bin/env bash
# In-image lint/static gate — the counterpart of the reference's CI
# (/root/reference/.github/workflows/ci.yml:26-46: cargo fmt --check +
# clippy -D warnings + cargo test).  No ruff/flake8/clang-format exists in
# this image, so:
#   1. scripts/lint_lite.py  — AST lint (unused imports, bare except,
#      placeholder-less f-strings, trailing whitespace, tabs, syntax)
#   2. python -m compileall  — bytecode-compiles every file (syntax gate)
#   3. g++ -fsyntax-only -Wall -Wextra -Werror over io/native/*.cc
#
# Run from the repo root before every commit (wired into the verify skill).
set -u
cd "$(dirname "$0")/.."

fail=0

echo "[check] lint_lite over portello_tpu/ tests/ scripts/ bench.py chip_smoke.py ..."
# shellcheck disable=SC2046
python scripts/lint_lite.py \
    $(find portello_tpu tests scripts -name "*.py") \
    bench.py chip_smoke.py __graft_entry__.py || fail=1

echo "[check] compileall ..."
python -m compileall -q portello_tpu tests scripts bench.py chip_smoke.py \
    __graft_entry__.py || fail=1

echo "[check] g++ -Wall -Wextra -Werror -fsyntax-only io/native/*.cc ..."
for f in portello_tpu/io/native/*.cc; do
    g++ -std=c++17 -fsyntax-only -Wall -Wextra -Werror "$f" || fail=1
done

if [ "$fail" -ne 0 ]; then
    echo "[check] FAILED"
    exit 1
fi
echo "[check] OK"
