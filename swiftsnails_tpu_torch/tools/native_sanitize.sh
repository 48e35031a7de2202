#!/usr/bin/env bash
# Sanitizer pass for the port's native batch producer, the twin of the JAX
# package's tools/native_sanitize.sh: builds the port's libsnails.cpp under
# ASan/UBSan and under TSan, and drives the port's native tests through each
# build by SSN_NATIVE_SO (the loader then builds nothing), the sanitizer's
# runtime preloaded into python.
#
#   swiftsnails_tpu_torch/tools/native_sanitize.sh [asan|tsan|both]
#
# Needs g++ with libasan/libubsan and libtsan. Exit 0: every selected test
# passed and no sanitizer reported (UBSan halts on its first report, ASan
# and TSan exit non-zero on theirs).
set -euo pipefail
cd "$(dirname "$0")/../.."

MODE="${1:-both}"
SRC=swiftsnails_tpu_torch/data/native/libsnails.cpp
OUT_DIR=$(mktemp -d "${TMPDIR:-/tmp}/snails_sanitize.XXXXXX")
trap 'rm -rf "$OUT_DIR"' EXIT

# -k: the two cases left out test the default build, which SSN_NATIVE_SO
# replaces:
# * the_port_builds_its_own_library checks the build's place under
#   swiftsnails_tpu_torch/build/;
# * failed_build_raises fakes a failed g++ build, and with SSN_NATIVE_SO
#   nothing is built.
# The trainer, CLI and SIGTERM cases stay, unlike in the JAX script (whose
# JAX-training cases hang under a preloaded sanitizer): the port's run in
# seconds under both runtimes and drive the producer's threads, and their
# subprocesses inherit the preload and SSN_NATIVE_SO.
KEEP="not the_port_builds_its_own_library and not failed_build_raises"

run_mode() {
  local name="$1"; shift
  local flags="$*"
  echo "=== $name build ==="
  g++ -O1 -g -std=c++17 -shared -fPIC -pthread $flags \
      -o "$OUT_DIR/libsnails_$name.so" "$SRC"
  echo "=== $name: pytest tests/test_torch_native.py tests/test_torch_streaming.py ==="
  # The test files import the JAX package too, whose own loader honours
  # SSN_NATIVE_SO: both packages then run this one build (their sources are
  # the same, word for word), so a JAX-against-port comparison here checks
  # the build against itself; the sanitizer is what this pass adds.
  # --capture=sys: a report written to fd 2 reaches the terminal even when
  # the sanitizer aborts the process.
  SSN_NATIVE_SO="$OUT_DIR/libsnails_$name.so" \
  LD_PRELOAD="$(g++ -print-file-name=lib${name}.so)" \
  ASAN_OPTIONS=detect_leaks=0 \
  UBSAN_OPTIONS=print_stacktrace=1:halt_on_error=1 \
  JAX_PLATFORMS=cpu \
  python -m pytest tests/test_torch_native.py tests/test_torch_streaming.py -q \
      --capture=sys -p no:cacheprovider -p no:randomly -k "$KEEP"
}

case "$MODE" in
  asan) run_mode asan -fsanitize=address,undefined ;;
  tsan) run_mode tsan -fsanitize=thread ;;
  both) run_mode asan -fsanitize=address,undefined
        run_mode tsan -fsanitize=thread ;;
  *) echo "usage: $0 [asan|tsan|both]" >&2; exit 2 ;;
esac
echo "sanitizer pass OK"
