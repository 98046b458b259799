"""Bounded waits for the runtime and Serve tests of the port: a test that
would block on a wedged stream or actor fails at its deadline instead of
holding its pytest worker."""

import threading
import time

import pytest


def wait_for(predicate, timeout=10.0, interval=0.01):
    """Polls `predicate` until it returns something true or `timeout` s pass;
    returns its last value."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        last = predicate()
        if last:
            return last
        time.sleep(interval)
    return last


def bounded(fn, timeout=30.0):
    """fn() in a daemon thread: its value, or its exception re-raised here;
    fails the test if fn has not returned within `timeout` s."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        pytest.fail(f"no result within {timeout} s")
    if "error" in box:
        raise box["error"]
    return box["value"]
