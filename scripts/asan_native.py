"""AddressSanitizer harness for the native runtime (companion to
scripts/tsan_native.py; SURVEY.md section 5 race/failure detection).

TSAN sees data races but not lifetime bugs; this is the harness that caught
the round-5 WorkPool stale-epoch corruption (a worker invoking a destroyed
pool_run closure after the next epoch reset `next` — the wandering RA>=2
suite crashes/hangs).  Recipe:

    python scripts/asan_native.py --build-asan          # -> /tmp/ptscan_asan.so
    LD_PRELOAD="/lib/x86_64-linux-gnu/libasan.so.8 /lib/x86_64-linux-gnu/libstdc++.so.6" \
      ASAN_OPTIONS="detect_leaks=0 abort_on_error=1 log_path=/tmp/asan_report" \
      PTPU_PTSCAN_SO=/tmp/ptscan_asan.so \
      python -m pytest tests/test_native_feed.py ... -x -q

Hard-won environment notes (do NOT rediscover these):
  - python does not link libstdc++, so preloading libasan ALONE leaves
    ASan's `real___cxa_throw` unresolved at init; the first deliberate
    error-parity throw in the dlopen'd .so then dies with
    "CHECK failed: asan_interceptors.cpp ... real___cxa_throw != 0".
    Preloading libstdc++.so.6 AFTER libasan.so.8 (order matters: the
    runtime must still come first) resolves the interceptor and both
    throw/catch and report generation work.
  - PTPU_PTSCAN_SO binds the prebuilt instrumented library for the whole
    process (pipeline/native_feed.get_lib honors it), bypassing the
    staleness rebuild that would silently swap in an uninstrumented build;
    PTPU_PTIO_SO / PTPU_PTCORE_SO do the same for the standalone codec and
    exact-core libraries (io/native_codec.py, ops/native_core.py).
  - jax runs fine under the preload (CPU-forced tests included); leak
    detection must stay off (jaxlib/python hold intentional globals).
  - The pool-handoff regression also has a jax-free deterministic driver:
    tests/test_native_feed.py::test_pool_epoch_stress (ptscan_dbg_pool_stress
    alternates two epoch bodies; pre-fix ASAN aborted within ~one
    200k-epoch trial at 6 threads).

`--loop N` runs the feed-heavy test files N times under the current
environment (set the preload + PTPU_PTSCAN_SO as above; with
PTPU_RA_THREADS=3 this was the ~1/6 reproduction of the round-5 bug).
"""

import argparse
import os
import subprocess
import sys

NATIVE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "portello_tpu", "io",
    "native",
)
SRC = os.path.join(NATIVE, "ptscan.cc")
# standalone libs loaded by io/native_codec.py and ops/native_core.py; bound
# via PTPU_PTIO_SO / PTPU_PTCORE_SO (ptscan.so statically includes both
# sources, so PTPU_PTSCAN_SO covers the scanner-side copies)
EXTRA = {
    "PTPU_PTIO_SO": (os.path.join(NATIVE, "ptio.cc"), "/tmp/ptio_asan.so"),
    "PTPU_PTCORE_SO": (
        os.path.join(NATIVE, "ptcore.cc"), "/tmp/ptcore_asan.so"
    ),
}

FEED_TESTS = [
    "tests/test_native_feed.py",
    "tests/test_host_shift.py",
    "tests/test_resident.py",
    "tests/test_cram.py",
    "tests/test_failure_modes.py",
    "tests/test_pipeline_e2e.py",
    "tests/test_contig_scan_parallel.py",
]


def build_asan(out_so: str, src: str = SRC) -> None:
    base = [
        "g++", "-O1", "-g", "-std=c++17", "-shared", "-fPIC",
        "-fsanitize=address", src, "-o", out_so,
    ]
    proc = subprocess.run(base + ["-lz", "-ldeflate", "-lpthread"])
    if proc.returncode != 0:
        subprocess.run(
            base + ["-DPTIO_NO_LIBDEFLATE", "-lz", "-lpthread"], check=True
        )
    print(f"built {out_so}")


def loop(n: int) -> None:
    if "PTPU_PTSCAN_SO" not in os.environ or "asan" not in os.environ.get(
        "LD_PRELOAD", ""
    ):
        raise SystemExit(
            "set LD_PRELOAD (libasan.so.8 then libstdc++.so.6) and "
            "PTPU_PTSCAN_SO (see module docstring) before --loop"
        )
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    for i in range(n):
        print(f"=== asan loop iteration {i + 1}/{n} ===", flush=True)
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", *FEED_TESTS, "-x", "-q"],
            cwd=root,
        ).returncode
        if rc != 0:
            raise SystemExit(f"iteration {i + 1} failed rc={rc}")
    print("ALL_CLEAN")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--build-asan", action="store_true")
    p.add_argument("--loop", type=int, default=0)
    a = p.parse_args()
    if a.build_asan:
        build_asan("/tmp/ptscan_asan.so")
        for env, (src, out) in EXTRA.items():
            build_asan(out, src)
            print(f"  bind with {env}={out}")
    if a.loop:
        loop(a.loop)
