"""The channel's TCP stream transport, the port against the JAX package
(ray_tpu_torch/core/channel.py, ray_tpu/core/channel.py): a writer handed a
spec whose ring path is not on its filesystem, as a writer on another host
sees it, takes the stream in both packages.

  - both deliver the same 200 records, in order;
  - a reader that stops reading blocks the writer, and the write times out;
  - closing either end raises ChannelClosed on the other;
  - a torch tensor arrives bitwise;
  - the port only: a writer with a wrong or no RAY_TPU_AUTH_TOKEN is refused
    (the JAX reader takes any connection), and a reader without the token
    opens no listener.

Each case runs under torch_modes.case_time_limit; blocking reads and writes
carry timeouts.
"""

import importlib
import threading
import time

import numpy as np
import pytest
import torch

import torch_modes

PKGS = ("jax", "torch")
ROOT = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
TOKEN = "channel-test-token"
LIMIT_S = 60
_SEEN = {}


@pytest.fixture
def limit(request):
    with torch_modes.case_time_limit(request, LIMIT_S):
        yield


def _ch(name):
    return importlib.import_module(f"{ROOT[name]}.core.channel")


def _remote_spec(ch, reader, tmp_path):
    """The reader's spec as a writer on another host sees it: its ring path
    names a file this filesystem does not have."""
    s = reader.spec()
    return ch.ChannelSpec(s.name, str(tmp_path / "elsewhere" / "ch.ring"), s.uds_path,
                          s.tcp_addr, s.capacity)


def _records():
    rng = np.random.default_rng(7)
    return [{"i": i, "payload": rng.integers(0, 1 << 30, size=int(rng.integers(1, 64))).tolist(),
             "tag": f"rec-{i}"} for i in range(200)]


def _agree(case, name, seen):
    """The JAX package's case runs first (parametrize order); the port's
    result must equal it."""
    _SEEN.setdefault(case, {})[name] = seen
    if name == "torch" and "jax" in _SEEN[case]:
        assert seen == _SEEN[case]["jax"]


@pytest.mark.parametrize("name", PKGS)
def test_stream_delivers_records_in_order(name, tmp_path, monkeypatch, limit):
    monkeypatch.setenv("RAY_TPU_AUTH_TOKEN", TOKEN)
    ch = _ch(name)
    r = ch.ChannelReader(str(tmp_path), capacity=1 << 16)
    w = ch.ChannelWriter(_remote_spec(ch, r, tmp_path))
    try:
        assert w._stream is not None and w._ring is None  # the stream, not the ring
        sent = _records()
        t = threading.Thread(target=lambda: [w.write(x, timeout=30) for x in sent], daemon=True)
        t.start()
        got = [r.read(timeout=30) for _ in sent]
        t.join(timeout=30)
        assert got == sent
        _agree("records", name, got)
    finally:
        w.close()
        r.close()


@pytest.mark.parametrize("name", PKGS)
def test_stream_backpressure_times_out_the_writer(name, tmp_path, monkeypatch, limit):
    """The reader never reads: the kernel's buffers fill and a write with a
    timeout raises TimeoutError instead of queueing without bound."""
    monkeypatch.setenv("RAY_TPU_AUTH_TOKEN", TOKEN)
    ch = _ch(name)
    r = ch.ChannelReader(str(tmp_path), capacity=1 << 16)
    w = ch.ChannelWriter(_remote_spec(ch, r, tmp_path))
    blob = b"x" * (1 << 20)
    try:
        with pytest.raises(TimeoutError):
            for _ in range(512):  # far more than any socket buffer holds
                w.write_bytes(blob, timeout=1.0)
    finally:
        w.close()
        r.close()


@pytest.mark.parametrize("name", PKGS)
def test_stream_close_of_either_end_is_seen_by_the_other(name, tmp_path, monkeypatch, limit):
    monkeypatch.setenv("RAY_TPU_AUTH_TOKEN", TOKEN)
    ch = _ch(name)
    # The writer closes: the reader's next read raises ChannelClosed.
    r = ch.ChannelReader(str(tmp_path), name="wclose", capacity=1 << 16)
    w = ch.ChannelWriter(_remote_spec(ch, r, tmp_path))
    w.write("last", timeout=10)
    assert r.read(timeout=10) == "last"
    w.close()
    with pytest.raises(ch.ChannelClosed):
        r.read(timeout=10)
    r.close()
    # The reader closes: the writer's writes raise ChannelClosed (the first
    # may still land in the kernel's buffer before the reset comes back).
    r = ch.ChannelReader(str(tmp_path), name="rclose", capacity=1 << 16)
    w = ch.ChannelWriter(_remote_spec(ch, r, tmp_path))
    w.write("first", timeout=10)
    assert r.read(timeout=10) == "first"
    r.close()
    with pytest.raises(ch.ChannelClosed):
        for _ in range(100):
            w.write_bytes(b"y" * 4096, timeout=5)
            time.sleep(0.02)
    w.close()


@pytest.mark.parametrize("name", PKGS)
def test_stream_tensor_arrives_bitwise(name, tmp_path, monkeypatch, limit):
    monkeypatch.setenv("RAY_TPU_AUTH_TOKEN", TOKEN)
    ch = _ch(name)
    r = ch.ChannelReader(str(tmp_path), capacity=1 << 16)
    w = ch.ChannelWriter(_remote_spec(ch, r, tmp_path))
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 64, 4, 32, generator=g).to(torch.bfloat16)
    try:
        t = threading.Thread(target=lambda: w.write({"q": x, "n": 1}, timeout=30), daemon=True)
        t.start()
        got = r.read(timeout=30)
        t.join(timeout=30)
        assert got["n"] == 1 and got["q"].dtype == torch.bfloat16
        assert torch.equal(got["q"].view(torch.int16), x.view(torch.int16))
        _agree("tensor", name, got["q"].view(torch.int16).numpy().tobytes())
    finally:
        w.close()
        r.close()


def test_port_stream_refuses_a_wrong_or_missing_token(tmp_path, monkeypatch, limit):
    ch = _ch("torch")
    monkeypatch.setenv("RAY_TPU_AUTH_TOKEN", TOKEN)
    r = ch.ChannelReader(str(tmp_path), capacity=1 << 16)
    spec = _remote_spec(ch, r, tmp_path)
    try:
        # A wrong token: the reader drops the connection and keeps waiting;
        # the writer's writes fail once the drop comes back.
        monkeypatch.setenv("RAY_TPU_AUTH_TOKEN", "not-the-token")
        bad = ch.ChannelWriter(spec)
        bad.write("intruder", timeout=5)
        with pytest.raises(TimeoutError):
            r.read(timeout=1.0)
        with pytest.raises(ch.ChannelClosed):
            for _ in range(100):
                bad.write_bytes(b"z" * 4096, timeout=5)
                time.sleep(0.02)
        bad.close()
        # No token: refused before any connection, naming the variable.
        monkeypatch.delenv("RAY_TPU_AUTH_TOKEN")
        with pytest.raises(ConnectionError, match="RAY_TPU_AUTH_TOKEN"):
            ch.ChannelWriter(spec)
        # The right token still attaches, and its record is the one read.
        monkeypatch.setenv("RAY_TPU_AUTH_TOKEN", TOKEN)
        good = ch.ChannelWriter(spec)
        good.write("friend", timeout=5)
        assert r.read(timeout=10) == "friend"
        good.close()
    finally:
        r.close()
    # A reader without the token serves no stream: its spec has no address,
    # and a writer that cannot see its ring is refused at once.
    monkeypatch.delenv("RAY_TPU_AUTH_TOKEN")
    r = ch.ChannelReader(str(tmp_path), name="notcp", capacity=1 << 16)
    try:
        assert r.spec().tcp_addr is None
        monkeypatch.setenv("RAY_TPU_AUTH_TOKEN", TOKEN)
        with pytest.raises(ConnectionError, match="RAY_TPU_AUTH_TOKEN"):
            ch.ChannelWriter(_remote_spec(ch, r, tmp_path))
    finally:
        r.close()
