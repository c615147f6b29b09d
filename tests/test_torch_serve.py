"""The port's TCP service (``sdfa_tpu_torch/serve.py``) over loopback: the 7
cases of tests/test_serve.py (framing, chunked pushes, concurrent clients,
bad requests, slots freed on disconnect, the two coefficient wires), on the
small synthetic template of tests/test_torch_slice.py with the network at
narrow widths. The JAX package's own
``StreamClient`` also talks to the port's server: the protocol on the wire is
one. Every socket has a timeout, so no case can hang.

Tolerances (metres): a served i16 stream against the port's offline request
2e-5 + WIRE_LSB / 2 and against the JAX task's offline request one step more;
coef frames decoded on the client 5e-5, coef16 5e-4 (tests/test_serve.py's).
"""

import socket
import threading
import time

import numpy as np
import pytest

from test_torch_slice import task_pair

from sdfa_tpu.serve import StreamClient as JStreamClient
from sdfa_tpu_torch.serve import ServeApp, StreamClient, StreamServerTCP, recv_msg, send_msg
from sdfa_tpu_torch.streaming import CoefDecoder
from sdfa_tpu_torch.task import WIRE_LSB

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    with task_pair(tmp_path_factory.mktemp("serve"), narrow=True) as pair:
        yield pair


def _serving(task, **kw):
    app = ServeApp(task, **kw)
    srv = StreamServerTCP(("127.0.0.1", 0), app)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def stop():
        srv.shutdown()
        srv.server_close()
        app.shutdown()
        thread.join(timeout=10)

    return app, srv.server_address, stop


@pytest.fixture()
def server(tasks):
    _, ttask, _ = tasks
    app, addr, stop = _serving(ttask, capacity=4, emit_batch=16, block_frames=16, wire="i16",
                               pipeline=True)
    yield app, addr
    stop()


def _client(addr, cls=StreamClient):
    client = cls(addr)
    client.sock.settimeout(TIMEOUT_S)
    return client


def _sig(seconds=1.2, seed=3, f0=150.0):
    t = np.arange(int(seconds * 8000)) / 8000
    rng = np.random.default_rng(seed)
    s = (0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3 * t))
         + 0.01 * rng.normal(size=len(t)))
    return np.clip(s, -1, 1).astype(np.float32)


def _err(got, verts_ref):
    verts = np.stack([v for _, v in got])
    return float(np.abs(verts - np.asarray(verts_ref).reshape(verts.shape)).max())


def test_framing_roundtrip():
    a, b = socket.socketpair()
    a.settimeout(TIMEOUT_S)
    b.settimeout(TIMEOUT_S)
    try:
        payload = np.arange(7, dtype="<f4").tobytes()
        send_msg(a, {"op": "push", "sid": 3}, payload)
        header, got = recv_msg(b)
        assert header["op"] == "push" and header["sid"] == 3
        assert header["nbytes"] == len(payload) and got == payload
        b.close()
        assert recv_msg(a) is None  # clean EOF
    finally:
        a.close()


def test_single_stream_matches_offline(tasks, server):
    jtask, ttask, _ = tasks
    app, addr = server
    sig = _sig()
    ts_ref, verts_ref = ttask.generate_vertices(sig, speaker=0)
    results = []
    for cls in (StreamClient, JStreamClient):  # the reference's client speaks the same protocol
        with _client(addr, cls) as c:
            sid = c.open(speaker=0)
            assert c.wire == "i16"
            for lo in range(0, len(sig), 2000):  # chunked pushes: framing mid-utterance
                c.push(sid, sig[lo:lo + 2000])
            c.flush(sid)
            results.append(list(c.frames(sid)))  # returns at the done marker
    for got in results:
        assert [t for t, _ in got] == list(ts_ref)
        assert _err(got, verts_ref) <= 2e-5 + WIRE_LSB / 2
    np.testing.assert_array_equal(np.stack([v for _, v in results[0]]),
                                  np.stack([v for _, v in results[1]]))
    _, verts_j = jtask.generate_vertices(sig, speaker=0)
    assert _err(results[0], verts_j) <= 2e-5 + WIRE_LSB / 2 + WIRE_LSB
    deadline = time.time() + 10
    while app.srv.live() and time.time() < deadline:
        time.sleep(0.05)
    assert app.srv.live() == []  # a finished stream's slot is free again


def test_concurrent_clients(tasks, server):
    _, ttask, _ = tasks
    _, addr = server
    sigs = [_sig(seed=s, f0=140 + 10 * s) for s in range(3)]
    results, errors = {}, []

    def run(k):
        try:
            with _client(addr) as c:
                sid = c.open(speaker=k)
                c.push(sid, sigs[k])
                c.flush(sid)
                results[k] = list(c.frames(sid))
        except Exception as exc:  # pragma: no cover
            errors.append((k, exc))

    threads = [threading.Thread(target=run, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    for k in range(3):
        ts_ref, verts_ref = ttask.generate_vertices(sigs[k], speaker=k)
        assert [t for t, _ in results[k]] == list(ts_ref), k
        assert _err(results[k], verts_ref) <= 2e-5 + WIRE_LSB / 2, k


def test_bad_ops_are_rejected(server):
    _, addr = server
    with _client(addr) as c:
        send_msg(c.sock, {"op": "nonsense"})
        header, _ = c._next()
        assert header["op"] == "error"
        # a push to a sid this connection does not own
        send_msg(c.sock, {"op": "push", "sid": 0}, np.zeros(4, "<f4").tobytes())
        header, _ = c._next()
        assert header["op"] == "error"
        # the connection survives both: a stream still opens on it
        assert c.open(speaker=0) == 0


def test_slot_released_on_disconnect(server):
    _, addr = server
    c = _client(addr)
    for _ in range(4):  # fill every slot (capacity 4)
        c.open(speaker=0)
    with _client(addr) as c2:
        with pytest.raises(RuntimeError, match="full"):
            c2.open(speaker=0)
    c.sock.close()  # drop the connection without close or flush
    for _ in range(50):
        with _client(addr) as c3:
            try:
                c3.open(speaker=0)
                return
            except RuntimeError:
                time.sleep(0.1)
    pytest.fail("slots not released after the disconnect")  # pragma: no cover


def test_coef_wire_over_tcp(tasks):
    """A coef-wire service announces the wire at open(); frames cross as (K,)
    coefficient payloads and the client reconstructs meshes with
    ``CoefDecoder`` (``frames(decoder=...)``)."""
    _, ttask, _ = tasks
    _, addr, stop = _serving(ttask, capacity=2, emit_batch=16, block_frames=16, wire="coef",
                             pipeline=True)
    try:
        sig = _sig(seconds=1.1, seed=9)
        ts_ref, verts_ref = ttask.generate_vertices(sig, speaker=1)
        dec = CoefDecoder(ttask)
        with _client(addr) as c:
            sid = c.open(speaker=1)
            assert c.wire == "coef"
            c.push(sid, sig)
            c.flush(sid)
            got = list(c.frames(sid, decoder=dec))
        assert [t for t, _ in got] == list(ts_ref)
        assert _err(got, verts_ref) <= 5e-5
    finally:
        stop()


def test_coef16_wire_stays_f16_on_tcp_and_fingerprint_checked(tasks):
    """coef16 payloads cross the TCP link as float16, the open-ok reply
    carries the decode system's fingerprint, and a fingerprint that does not
    match is refused before any frame decodes."""
    _, ttask, _ = tasks
    _, addr, stop = _serving(ttask, capacity=2, emit_batch=16, block_frames=16, wire="coef16",
                             pipeline=True, warm_start=False)
    try:
        sig = _sig(seconds=1.1, seed=9)
        ts_ref, verts_ref = ttask.generate_vertices(sig, speaker=1)
        dec = CoefDecoder(ttask)
        with _client(addr) as c:
            sid = c.open(speaker=1)
            assert c.wire == "coef16"
            assert c.coef_fp == dec.fingerprint()
            c.push(sid, sig)
            c.flush(sid)
            got = list(c.frames(sid))  # undecoded: the raw wire payloads
        assert [t for t, _ in got] == list(ts_ref)
        coefs = np.stack([v for _, v in got])
        assert coefs.dtype == np.float16, coefs.dtype  # float16 end to end
        verts = dec.decode(coefs)
        assert float(np.abs(verts - verts_ref).max()) <= 5e-4

        with _client(addr) as c:
            sid = c.open(speaker=1)
            c.coef_fp = dict(c.coef_fp, system_sha1="0" * 16)
            c.push(sid, sig)
            c.flush(sid)
            with pytest.raises(AssertionError, match="decode system"):
                list(c.frames(sid, decoder=dec))
    finally:
        stop()
