"""tests/torch_modes.py's `fixture_time_limit`, in pytest runs of their own
(a file written to tmp_path): a module fixture whose teardown stalls past
its limit errors with its file named, every thread's stack printed on the
run's stderr and what it started killed; one whose boot never unwinds
exits the process after the grace. Neither holds the run, and neither
passes."""

import os
import subprocess
import sys
import textwrap
import time

HERE = os.path.dirname(os.path.abspath(__file__))

TEARDOWN = textwrap.dedent("""
    import subprocess, sys, threading
    import pytest
    import torch_modes

    @pytest.fixture(scope="module")
    def stalls_at_teardown():
        child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
        with open("child.pid", "w") as f:
            f.write(str(child.pid))
        yield child
        with torch_modes.fixture_time_limit(2, child.kill):
            threading.Event().wait()  # a stall the kill alone does not end

    def test_case(stalls_at_teardown):
        assert stalls_at_teardown.poll() is None
""")

BOOT = textwrap.dedent("""
    import time
    import pytest
    import torch_modes

    @pytest.fixture(scope="module")
    def never_unwinds():
        with torch_modes.fixture_time_limit(1, lambda: None, grace=1):
            while True:
                try:
                    time.sleep(600)
                except torch_modes.FixtureTimeLimitError:
                    pass  # a boot that swallows the interrupt
        yield

    def test_case(never_unwinds):
        pass
""")


def _run(tmp_path, name, source):
    path = tmp_path / name
    path.write_text(source)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (HERE, env.get("PYTHONPATH")) if p)
    start = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "--noconftest", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", str(path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    return proc, time.monotonic() - start


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_stalled_teardown_errors_prints_and_kills(tmp_path):
    proc, took = _run(tmp_path, "test_stalls_at_teardown.py", TEARDOWN)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "1 passed, 1 error" in proc.stdout, proc.stdout
    assert "FixtureTimeLimitError: test_stalls_at_teardown.py" in proc.stdout, proc.stdout
    assert "(teardown)" in proc.stdout
    assert "ran past its 2 s limit; every thread's stack" in proc.stderr, proc.stderr
    assert "most recent call first" in proc.stderr
    assert not _alive(int((tmp_path / "child.pid").read_text()))
    assert took < 60, took


def test_boot_that_never_unwinds_exits_the_process(tmp_path):
    proc, took = _run(tmp_path, "test_never_unwinds.py", BOOT)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "test_never_unwinds.py" in proc.stderr
    assert "did not unwind within 1 s of its limit: exiting this worker" in proc.stderr
    assert "passed" not in proc.stdout, proc.stdout
    assert took < 60, took
