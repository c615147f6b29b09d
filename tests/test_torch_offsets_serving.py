"""Serving the offsets model (``configs/model/offsets.py``, ``verts_off_3d``;
and ``verts_pos_3d``), port vs JAX on the same weights, audio and small
synthetic template (``tests/test_torch_slice.py::task_pair`` with
``face_type``, the network's layers at narrow widths): offline requests on
every vertex wire, the refused coefficient wire, ensembling, the per-window
fallback, ``StreamingSession``, ``StreamingServer`` and the TCP service.

Tolerances, all in metres:
- f32 requests, ensembled and per-window requests against the JAX task ≤ 1e-5;
- a quantized wire against the port's own f32 wire: i16 ≤ WIRE_LSB / 2 + 1e-7,
  i8d ≤ WIRE_LSB8 / 2 + 1e-7; against the JAX task on the same wire one step
  more at a rounding boundary, in fewer than 2% of the cells
  (tests/test_torch_wires.py's);
- the fused path against ``generate_animation`` + ``frames_to_meshes`` ≤ 1e-6
  (tests/test_task.py's), against the per-window path as far as the JAX
  package's two paths are apart + 1e-5;
- streamed frames against the offline request ≤ 1e-5 plus half the wire's step,
  against the JAX session / server 1e-5 plus one step; timelines equal.
"""

import threading

import numpy as np
import pytest

from test_torch_slice import _signal, task_pair

from sdfa_tpu.streaming import StreamingServer as JServer
from sdfa_tpu_torch.serve import ServeApp, StreamClient, StreamServerTCP
from sdfa_tpu_torch.streaming import CoefDecoder, StreamingServer
from sdfa_tpu_torch.task import WIRE_LSB, WIRE_LSB8
from sdfa_tpu_torch.task import AnimationTask as TTask
from sdfa_tpu_torch.viewer import frame as tframe

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

TOL_M = 1e-5
STEP = {"f32": 0.0, "i16": WIRE_LSB, "i8d": WIRE_LSB8}
TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    with task_pair(tmp_path_factory.mktemp("offsets"), narrow=True,
                   face_type="verts_off_3d") as pair:
        yield pair


@pytest.fixture(scope="module")
def request_f32(tasks):
    jtask, ttask, _ = tasks
    sig = _signal(0.9, 4)
    return sig, jtask.generate_vertices(sig, 1), ttask.generate_vertices(sig, 1)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_f32_request_matches_jax(tasks, request_f32):
    _, ttask, n_verts = tasks
    sig, (ts_j, verts_j), (ts_t, verts_t) = request_f32
    assert list(ts_t) == list(ts_j)
    assert verts_t.shape == (len(ts_j), n_verts, 3) and verts_t.dtype == np.float32
    assert _err(verts_t, verts_j) <= TOL_M
    # offsets of a few millimetres around the template: not the template alone
    assert 1e-4 < _err(verts_t, tframe.template()[0][None]) < 0.1
    assert ttask._decode is None  # no solver constants for a vertex face type


@pytest.mark.parametrize("wire", ["i16", "i8d"])
def test_quantized_wire_matches_f32_and_jax(tasks, request_f32, wire):
    jtask, ttask, _ = tasks
    sig, _, (ts_f, verts_f) = request_f32
    ts_q, verts_q = ttask.generate_vertices(sig, 1, wire=wire)
    assert ts_q == ts_f and verts_q.dtype == np.float32 and verts_q.shape == verts_f.shape
    assert _err(verts_q, verts_f) <= STEP[wire] / 2 + 1e-7
    _, verts_j = jtask.generate_vertices(sig, 1, wire=wire)
    diff = np.abs(verts_q - np.asarray(verts_j))
    assert float(diff.max()) <= STEP[wire] + 1e-7
    assert float((diff > 1e-7).mean()) < 0.02


def test_coefficient_wire_is_refused(tasks):
    """Offsets has no dgrad PCA heads: the coef wire of a request, the
    coefficient wires of the server and service, and the client decoder are
    refused with the reference's texts."""
    jtask, ttask, _ = tasks
    for task in (jtask, ttask):
        with pytest.raises(ValueError, match="wire='coef' needs dgrad_3d PCA heads"):
            task.generate_vertices(_signal(0.3, 1), 0, wire="coef")
    for wire in ("coef", "coef16"):
        with pytest.raises(ValueError, match="coefficient wire needs dgrad_3d PCA heads .*"
                                             "use a vertex wire for face type 'verts_off_3d'"):
            StreamingServer(ttask, capacity=1, wire=wire)
    with pytest.raises(ValueError, match="CoefDecoder matches the coefficient wire"):
        CoefDecoder(ttask)
    with pytest.raises(ValueError, match="coefficient wire needs dgrad_3d PCA heads"):
        ServeApp(ttask, capacity=1, wire="coef")


def test_ensembling_fallback_and_roundtrip(tasks, request_f32):
    """The ensembled request is the mean of two runs turned into meshes; the
    per-window path (overlap off) and the fused path agree with JAX and with
    ``generate_animation`` + ``frames_to_meshes``; ``warmup`` runs."""
    jtask, ttask, _ = tasks
    sig, _, (ts_f, verts_f) = request_f32
    ts_a, animes, _ = ttask.generate_animation(sig, 1)
    assert ts_a == ts_f and animes.shape == (len(ts_f), verts_f[0].size)
    ref, _ = tframe.frames_to_meshes(animes, "verts_off_3d", "cpu")
    assert _err(verts_f, ref) <= 1e-6

    ts_e, verts_e = ttask.generate_vertices(sig, 1, ensembling_ms=100.0)
    _, verts_je = jtask.generate_vertices(sig, 1, ensembling_ms=100.0)
    assert list(ts_e) == list(ts_f) and _err(verts_e, verts_je) <= TOL_M
    _, a1, _ = ttask.generate_animation(ttask._shifted(sig, 100.0), 1)
    mean, _ = tframe.frames_to_meshes((animes + a1) / 2.0, "verts_off_3d", "cpu")
    np.testing.assert_array_equal(verts_e, mean)
    assert _err(verts_e, verts_f) > 1e-7  # it did shift

    per_window = TTask(ttask.hp, ttask.model, "cpu", overlap_frontend=False)
    ts_w, verts_w = per_window.generate_vertices(sig, 1)
    jtask.overlap_frontend = False
    try:
        _, verts_jw = jtask.generate_vertices(sig, 1)
    finally:
        jtask.overlap_frontend = True
    assert list(ts_w) == list(ts_f) and _err(verts_w, verts_jw) <= TOL_M
    # the per-window features differ from the clip-level ones by rounding, and
    # the offsets reach the vertices undamped: the two paths stand as far apart
    # as the JAX package's own two do
    assert _err(verts_w, verts_f) <= _err(verts_jw, request_f32[1][1]) + TOL_M
    assert ttask.warmup(seconds=0.3, wire="i16") >= 0.0
    assert ttask._decode is None and per_window._decode is None


def test_positions_request_matches_jax(tmp_path):
    """``verts_pos_3d``: the decoded frames are the vertices, no template added."""
    with task_pair(tmp_path, narrow=True, face_type="verts_pos_3d") as (jtask, ttask, n_verts):
        sig = _signal(0.6, 2)
        ts_j, verts_j = jtask.generate_vertices(sig, 3)
        ts_t, verts_t = ttask.generate_vertices(sig, 3)
        assert list(ts_t) == list(ts_j) and verts_t.shape == (len(ts_j), n_verts, 3)
        assert _err(verts_t, verts_j) <= TOL_M
        _, animes, _ = ttask.generate_animation(sig, 3)
        np.testing.assert_allclose(verts_t.reshape(len(ts_t), -1), animes, atol=1e-6)


def _session(task, sig, seed=0):
    sess = task.stream(2, emit_batch=16, block_frames=16)
    rng, got, i = np.random.default_rng(seed), [], 0
    while i < len(sig):
        n = int(rng.integers(400, 3000))
        got.extend(sess.push(sig[i:i + n]))
        i += n
    live = len(got)
    return got + sess.flush(), live


def test_session_matches_offline_and_jax(tasks):
    jtask, ttask, _ = tasks
    sig = _signal(1.6, 9)
    ts_ref, verts_ref = ttask.generate_vertices(sig, 2)
    got, live = _session(ttask, sig)
    assert [t for t, _ in got] == list(ts_ref) and live > len(got) // 2
    verts = np.stack([v for _, v in got])
    assert _err(verts, verts_ref) <= TOL_M
    jgot, jlive = _session(jtask, sig)
    assert [t for t, _ in jgot] == [t for t, _ in got] and jlive == live
    assert _err(verts, np.stack([np.asarray(v) for _, v in jgot])) <= TOL_M


def _serve(server_cls, task, clips, wire):
    srv = server_cls(task, capacity=2, emit_batch=8, block_frames=16, wire=wire)
    sids = [srv.open(k) for k in range(len(clips))]
    got = {sid: [] for sid in sids}
    for lo in range(0, max(map(len, clips)), 1500):
        for sid, clip in zip(sids, clips):
            if lo < len(clip):
                srv.push(sid, clip[lo:lo + 1500])
        for sid, frames in srv.tick().items():
            got[sid].extend(frames)
    for sid in sids:
        srv.flush(sid)
    while not all(srv.is_done(sid) for sid in sids):
        for sid, frames in srv.tick().items():
            got[sid].extend(frames)
    return [got[sid] for sid in sids]


@pytest.mark.parametrize("wire", ["f32", "i16"])
def test_server_matches_offline_and_jax(tasks, wire):
    """Two streams of different lengths and speakers in one pool."""
    jtask, ttask, _ = tasks
    clips = [_signal(1.1, 21), _signal(0.8, 22)]
    got = _serve(StreamingServer, ttask, clips, wire)
    jgot = _serve(JServer, jtask, clips, wire)
    for k, clip in enumerate(clips):
        ts_ref, verts_ref = ttask.generate_vertices(clip, k)
        assert [t for t, _ in got[k]] == list(ts_ref) == [t for t, _ in jgot[k]]
        verts = np.stack([v for _, v in got[k]])
        assert _err(verts, verts_ref) <= TOL_M + STEP[wire] / 2
        assert _err(verts, np.stack([np.asarray(v) for _, v in jgot[k]])) <= TOL_M + STEP[wire]


def test_tcp_service_serves_offsets(tasks):
    """``ServeApp`` + ``StreamServerTCP`` on loopback with one client on i16."""
    _, ttask, _ = tasks
    app = ServeApp(ttask, capacity=2, emit_batch=16, block_frames=16, wire="i16")
    srv = StreamServerTCP(("127.0.0.1", 0), app)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        sig = _signal(1.0, 31)
        ts_ref, verts_ref = ttask.generate_vertices(sig, 1)
        with StreamClient(srv.server_address) as client:
            client.sock.settimeout(TIMEOUT_S)
            sid = client.open(speaker=1)
            assert client.wire == "i16"
            for lo in range(0, len(sig), 2000):
                client.push(sid, sig[lo:lo + 2000])
            client.flush(sid)
            got = list(client.frames(sid))
    finally:
        srv.shutdown()
        srv.server_close()
        app.shutdown()
        thread.join(timeout=10)
    assert [t for t, _ in got] == list(ts_ref)
    assert _err(np.stack([v for _, v in got]), verts_ref) <= TOL_M + WIRE_LSB / 2
