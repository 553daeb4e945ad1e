"""The port's native sanitizer gates: the host C++ of the main path's step 1
(``native/at2_prep.cpp``), of the message plane (``native/at2_ingest.cpp``)
and of the verifier's native seam (``native/at2_seam.cpp`` on its host
stand-in) built with g++ under ThreadSanitizer and AddressSanitizer beside
their harnesses (``native/sanitize_test.cpp``, ``native/sanitize_ingest_test.cpp``,
``native/sanitize_seam_test.cpp``), and run. A harness fails on its own
checks (a multithreaded fill or verify that differs from the
single-threaded one, a wrong RFC 8032 row, a parse or reader fault, a
completion out of order or a job left unended); the test fails on that
exit code or on any sanitizer report."""

import os
import subprocess

import pytest

import at2_node_tpu_torch

NATIVE = os.path.join(os.path.dirname(at2_node_tpu_torch.__file__), "native")

DRIVERS = {
    "prep": (("at2_prep.cpp", "sanitize_test.cpp"), ("-lpthread",), "sanitize_test: OK"),
    "ingest": (("at2_ingest.cpp", "sanitize_ingest_test.cpp"), ("-lpthread", "-l:libcrypto.so.3"),
               "sanitize_ingest_test: OK"),
    "seam": (("at2_seam.cpp", "at2_seam_host.cpp", "../csrc/ed25519_lane_host.cpp", "sanitize_seam_test.cpp"),
             ("-lpthread",), "sanitize_seam_test: OK"),
}
REPORTS = ("WARNING: ThreadSanitizer", "ERROR: AddressSanitizer", "ERROR: LeakSanitizer",
           "runtime error:")


@pytest.mark.parametrize("sanitizer", ["thread", "address"])
@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_native_library_runs_clean_under_the_sanitizer(driver, sanitizer, tmp_path):
    sources, libs, ok_line = DRIVERS[driver]
    binary = str(tmp_path / f"sanitize_{driver}_{sanitizer}")
    build = subprocess.run(
        ["g++", "-std=c++17", "-O1", "-g", f"-fsanitize={sanitizer}",
         *(os.path.join(NATIVE, s) for s in sources), "-o", binary, *libs],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr[-4000:]
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1", ASAN_OPTIONS="halt_on_error=1")
    run = subprocess.run([binary], capture_output=True, text=True, timeout=300, env=env)
    out = run.stdout + run.stderr
    assert run.returncode == 0, out[-4000:]
    assert not [r for r in REPORTS if r in out], out[-4000:]
    assert ok_line in run.stdout
