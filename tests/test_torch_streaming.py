"""``StreamingSession`` and ``StreamingServer`` of the port: every case of
tests/test_streaming.py, each also against the JAX session / server on the
same audio, weights and small synthetic template (the fixture of
tests/test_torch_slice.py, with the network's layers at narrow widths).

Tolerances (metres). Timelines are equal exactly, everywhere.
- streamed against the port's own offline request: 5e-5 (the reference's; the
  band Δ operator sums in another order than the whole-clip one);
- server against a dedicated session: 2e-5, plus half a step on a quantized
  wire (WIRE_LSB / 2 = 5e-6, WIRE_LSB8 / 2 = 2e-5); an i8d stream's first 4
  frames are left out where it is still catching up from the template at 127
  steps a frame;
- the port against the JAX package on the same path: 1e-5 on f32 and coef
  frames; on a quantized wire one step more (an integer may land one step
  apart at a rounding boundary);
- coef frames decoded: 5e-5 to offline; coef16 5e-4.
"""

import numpy as np
import pytest

from test_torch_slice import task_pair

from sdfa_tpu.streaming import CoefDecoder as JCoefDecoder
from sdfa_tpu.streaming import StreamingServer as JServer
from sdfa_tpu_torch.streaming import CoefDecoder, StreamingServer
from sdfa_tpu_torch.task import WIRE_LSB, WIRE_LSB8

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

JAX_TOL = 1e-5


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    with task_pair(tmp_path_factory.mktemp("streaming"), narrow=True) as pair:
        yield pair


def _sig(seconds=1.6, seed=3):
    t = np.arange(int(seconds * 8000)) / 8000
    rng = np.random.default_rng(seed)
    s = (0.3 * np.sin(2 * np.pi * 150 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3 * t))
         + 0.01 * rng.normal(size=len(t)))
    return np.clip(s, -1, 1).astype(np.float32)


def _stack(frames):
    return np.stack([np.asarray(v) for _, v in frames])


def _times(frames):
    return [t for t, _ in frames]


def _stream_session(task, sig, chunks, **kw):
    sess = task.stream(kw.pop("speaker", 0), **kw)
    got, i = [], 0
    for n in chunks:
        got.extend(sess.push(sig[i:i + n]))
        i += n
    n_live = len(got)
    got.extend(sess.flush())
    return got, n_live


def _chunks(total, lo, hi, seed):
    rng, out = np.random.default_rng(seed), []
    while sum(out) < total:
        out.append(int(rng.integers(lo, hi)))
    return out


def _drain(srv, sids, got):
    for sid in sids:
        srv.flush(sid)
    while not all(srv.is_done(sid) for sid in sids):
        for sid, frames in srv.tick().items():
            got[sid].extend(frames)


def _serve_one(server_cls, task, sig, speaker, chunk=None, **kw):
    srv = server_cls(task, **kw)
    sid = srv.open(speaker)
    got = {sid: []}
    for lo in range(0, len(sig), chunk or len(sig)):
        srv.push(sid, sig[lo:lo + (chunk or len(sig))])
        for s2, frames in srv.tick().items():
            got[s2].extend(frames)
    _drain(srv, [sid], got)
    return got[sid], srv


class TestStreaming:
    def test_matches_offline(self, tasks):
        jtask, ttask, _ = tasks
        sig = _sig(seconds=2.0)
        ts_ref, verts_ref = ttask.generate_vertices(sig, 0)
        chunks = _chunks(len(sig), 400, 3000, 0)
        got, n_live = _stream_session(ttask, sig, chunks, emit_batch=16)
        assert _times(got) == list(ts_ref)
        verts = _stack(got)
        assert verts.shape == verts_ref.shape
        np.testing.assert_allclose(verts, verts_ref, atol=5e-5)
        # most frames arrive before the flush (it is streaming, not a batch)
        assert n_live > len(got) * 0.55, (n_live, len(got))
        jgot, j_live = _stream_session(jtask, sig, chunks, emit_batch=16)
        assert _times(jgot) == _times(got) and j_live == n_live
        assert float(np.abs(verts - _stack(jgot)).max()) <= JAX_TOL

    def test_matches_offline_at_bucket_boundary_length(self, tasks):
        """A clip whose frame grid lands exactly on the 256-frame bucket with
        the least right slack: the class where the last windows' deltas would
        hit the offline right-edge fits while streaming uses interior taps."""
        jtask, ttask, _ = tasks
        wspec = ttask.wspec
        n_pick = None
        for t_target in range(20, 420):
            n = t_target * wspec.hop_size + wspec.win_size
            idx, _, _, _, t_total = wspec.frame_grid(n, bucket=256)
            if t_total % 256 == 0 and t_total - int(idx.max()) <= 6:
                n_pick = n
                break
        assert n_pick is not None, "no boundary length found in the sweep"
        sig = _sig(seconds=n_pick / 8000 + 0.01)[:n_pick]
        ts_ref, verts_ref = ttask.generate_vertices(sig, 0)
        got, _ = _stream_session(ttask, sig, [len(sig)], emit_batch=16)
        assert _times(got) == list(ts_ref)
        np.testing.assert_allclose(_stack(got), verts_ref, atol=5e-5)
        jgot, _ = _stream_session(jtask, sig, [len(sig)], emit_batch=16)
        assert _times(jgot) == _times(got)
        assert float(np.abs(_stack(got) - _stack(jgot)).max()) <= JAX_TOL

    def test_lookahead_bound(self, tasks):
        """Every frame arrives within lookahead_s + one block + one emit batch
        of audio of its timestamp; the JAX session emits the same frames at
        the same pushes."""
        jtask, ttask, _ = tasks
        sig = _sig(seconds=1.2, seed=5)
        sess, jsess = ttask.stream(0, emit_batch=4), jtask.stream(0, emit_batch=4)
        assert sess.lookahead_s == jsess.lookahead_s
        block_s = sess.BLOCK * sess.spec.hop_size / 8000
        batch_s = sess.emit_batch / sess.spec.fps
        bound = sess.lookahead_s + block_s + batch_s + sess.spec.ts_delta / 1000.0 + 0.05
        step = 160  # 20 ms pushes
        for i in range(0, len(sig), step):
            arrived_at = (i + step) / 8000
            frames = sess.push(sig[i:i + step])
            for ts, _ in frames:
                assert arrived_at - ts / 1000.0 <= bound, (ts, arrived_at)
            assert _times(jsess.push(sig[i:i + step])) == _times(frames)

    def test_empty_and_flush_only(self, tasks):
        """No audio at all still yields the offline path's pad windows."""
        jtask, ttask, _ = tasks
        sess = ttask.stream(0)
        assert sess.push(np.zeros(0, np.float32)) == []
        ts_ref, verts_ref = ttask.generate_vertices(np.zeros(0, np.float32), 0)
        got = sess.flush()
        assert _times(got) == list(ts_ref) and len(got) > 0
        np.testing.assert_allclose(_stack(got), verts_ref, atol=5e-5)
        jgot = jtask.stream(0).flush()
        assert _times(jgot) == _times(got)
        assert float(np.abs(_stack(got) - _stack(jgot)).max()) <= JAX_TOL
        with pytest.raises(RuntimeError, match="already flushed"):
            sess.push(np.zeros(4, np.float32))

    def test_long_session_bounded_memory(self, tasks):
        """An indefinite session does not grow its buffers: signal, mel and z
        stay O(lookahead + block) however much audio was pushed, as on the
        JAX side."""
        jtask, ttask, _ = tasks
        sess, jsess = ttask.stream(0, emit_batch=16), jtask.stream(0, emit_batch=16)
        rng = np.random.default_rng(7)
        total = n_frames = 0
        caps = dict(sig=0, mel=0, z=0)
        for k in range(10):          # 5 s in 0.5 s pushes
            chunk = np.clip(0.1 * rng.normal(size=4000), -1, 1).astype(np.float32)
            n_frames += len(sess.push(chunk))
            total += len(chunk)
            for key, v in sess.buffer_samples().items():
                caps[key] = max(caps[key], v)
            if k < 4:  # the JAX session's sizes over the same first pushes
                jsess.push(chunk)
                assert sess.buffer_samples() == jsess.buffer_samples()
        n_frames += len(sess.flush())
        assert n_frames == sess._n_windows(total)
        assert caps["sig"] < 3 * sess.spec.sliding, caps
        assert caps["mel"] < 600 and caps["z"] < 600, caps


class TestServer:
    """StreamingServer: N concurrent streams, one batched pipeline."""

    def test_concurrent_streams_match_offline(self, tasks):
        jtask, ttask, _ = tasks
        clips = [_sig(seconds=s, seed=k) for k, s in ((11, 1.4), (12, 1.9), (13, 1.1))]
        offline = [ttask.generate_vertices(c, spk) for spk, c in enumerate(clips)]
        results = []
        for cls, task in ((StreamingServer, ttask), (JServer, jtask)):
            srv = cls(task, capacity=4, emit_batch=8, wire="f32")
            sids = [srv.open(spk) for spk in range(len(clips))]
            got = {sid: [] for sid in sids}
            pos = [0] * len(clips)
            rng = np.random.default_rng(0)
            while any(p < len(c) for p, c in zip(pos, clips)):
                for k, sid in enumerate(sids):
                    if pos[k] < len(clips[k]):
                        n = int(rng.integers(500, 2500))
                        srv.push(sid, clips[k][pos[k]:pos[k] + n])
                        pos[k] += n
                for sid, frames in srv.tick().items():
                    got[sid].extend(frames)
            live_counts = {sid: len(got[sid]) for sid in sids}
            _drain(srv, sids, got)
            results.append((sids, got, live_counts))
        sids, got, live_counts = results[0]
        jsids, jgot, j_live = results[1]
        assert live_counts == j_live
        for k, sid in enumerate(sids):
            ts_ref, verts_ref = offline[k]
            assert _times(got[sid]) == list(ts_ref), f"stream {k}"
            np.testing.assert_allclose(_stack(got[sid]), verts_ref, atol=5e-5,
                                       err_msg=f"stream {k}")
            assert live_counts[sid] > 0.4 * len(got[sid]), (k, live_counts)
            assert float(np.abs(_stack(got[sid]) - _stack(jgot[jsids[k]])).max()) <= JAX_TOL

    def test_matches_dedicated_session(self, tasks):
        jtask, ttask, _ = tasks
        sig = _sig(seconds=1.3, seed=21)
        ref, _ = _stream_session(ttask, sig, [len(sig)], speaker=1, emit_batch=8)
        got, _ = _serve_one(StreamingServer, ttask, sig, 1, capacity=2, emit_batch=8, wire="f32")
        assert _times(got) == _times(ref)
        np.testing.assert_allclose(_stack(got), _stack(ref), atol=2e-5)
        jgot, _ = _serve_one(JServer, jtask, sig, 1, capacity=2, emit_batch=8, wire="f32")
        assert _times(jgot) == _times(got)
        assert float(np.abs(_stack(got) - _stack(jgot)).max()) <= JAX_TOL

    def test_capacity_and_slot_reuse(self, tasks):
        jtask, ttask, _ = tasks
        for cls, task in ((StreamingServer, ttask), (JServer, jtask)):
            srv = cls(task, capacity=2, emit_batch=4)
            a = srv.open(0)
            b = srv.open(1)
            with pytest.raises(RuntimeError, match="server full"):
                srv.open(0)
            # an empty stream still emits the geometry's silence windows
            srv.flush(a)
            n_silence = 0
            while not srv.is_done(a):
                n_silence += len(srv.tick().get(a, []))
            assert n_silence == srv.spec.n_windows(0) > 0
            srv.close(a)
            c = srv.open(2)        # the slot is reused
            assert c == a
            assert sorted(srv.live()) == sorted([b, c])

    def test_pipelined_ticks_match_and_wire_formats(self, tasks):
        """``pipeline=True`` returns the previous round's frames, but the
        union over the drain loop is the same; f32 matches a dedicated session
        to reassociation tolerance, and i16 / i8d add at most half a step."""
        jtask, ttask, _ = tasks
        sig = _sig(seconds=1.2, seed=33)
        ref, _ = _stream_session(ttask, sig, [len(sig)], emit_batch=8)
        chunk = 1900
        for wire, step in (("f32", 0.0), ("i16", WIRE_LSB), ("i8d", WIRE_LSB8)):
            kw = dict(capacity=2, emit_batch=8, wire=wire, pipeline=True)
            got, srv = _serve_one(StreamingServer, ttask, sig, 0, chunk, **kw)
            assert srv.pipeline and _times(got) == _times(ref), wire
            # a delta stream starts from the template and catches up at 127 steps
            # (5 mm) a frame: its first frames are held by the i8d case below
            head = 4 if wire == "i8d" else 0
            err = float(np.abs(_stack(got) - _stack(ref))[head:].max())
            assert err <= 2e-5 + step / 2, (wire, err)
            unpiped, _ = _serve_one(StreamingServer, ttask, sig, 0, chunk,
                                    **dict(kw, pipeline=False))
            np.testing.assert_array_equal(_stack(unpiped), _stack(got))
            jgot, _ = _serve_one(JServer, jtask, sig, 0, chunk, **kw)
            assert _times(jgot) == _times(got), wire
            diff = np.abs(_stack(got) - _stack(jgot))
            assert float(diff.max()) <= JAX_TOL + step, wire
            if step:
                assert float((diff > 1e-6).mean()) < 0.02, wire  # cells a boundary split

    def test_i8d_delta_wire_rebase_and_no_drift(self, tasks):
        """Closing a slot and opening it again re-bases both carries (the new
        stream's frames are absolute, not relative to the dead one's), and a
        long stream gathers no drift: the tail is as accurate as the head."""
        jtask, ttask, _ = tasks
        sig_a, sig_b = _sig(seconds=0.7, seed=7), _sig(seconds=2.2, seed=8)
        ref_b = ttask.generate_vertices(sig_b, 1)[1]
        outs = []
        for cls, task in ((StreamingServer, ttask), (JServer, jtask)):
            srv = cls(task, capacity=2, emit_batch=8, wire="i8d")
            a = srv.open(0)
            srv.push(a, sig_a)
            srv.flush(a)
            while not srv.is_done(a):
                srv.tick()
            srv.close(a)
            b = srv.open(1)  # the freed slot again: must re-base
            assert b == a
            srv.push(b, sig_b)
            got = {b: []}
            _drain(srv, [b], got)
            outs.append(_stack(got[b]))
        verts, jverts = outs
        bound = 2e-5 + WIRE_LSB8 / 2
        # this template's first frame sits further than 127 steps (5 mm) from
        # the template, so the stream catches up at 5 mm a frame: a clamped
        # start corrects itself, on both sides alike
        err = np.abs(verts - ref_b).max(axis=(1, 2))
        print("i8d frames still catching up:", int((err > bound).sum()))
        assert float(err[4:].max()) <= bound
        assert float(err[-8:].max()) <= bound
        assert float(np.abs(verts - jverts).max()) <= JAX_TOL + WIRE_LSB8

    def test_ring_wrap_long_stream(self, tasks):
        """A clip much longer than the ring wraps every slot's segment many
        times; frames still match offline."""
        jtask, ttask, _ = tasks
        sig = _sig(seconds=2.6, seed=44)
        ts_ref, verts_ref = ttask.generate_vertices(sig, 1)
        kw = dict(capacity=2, emit_batch=4, block_frames=12, ring_frames=128, wire="f32")
        got, srv = _serve_one(StreamingServer, ttask, sig, 1, 1800, **kw)
        assert srv.R * srv.spec.hop_size < len(sig) / 2  # it must wrap
        assert _times(got) == list(ts_ref)
        np.testing.assert_allclose(_stack(got), verts_ref, atol=5e-5)
        jgot, _ = _serve_one(JServer, jtask, sig, 1, 1800, **kw)
        assert _times(jgot) == _times(got)
        assert float(np.abs(_stack(got) - _stack(jgot)).max()) <= JAX_TOL

    def test_coefficient_wire_and_client_decoder(self, tasks):
        """``wire="coef"`` ships the raw (85 + 180,) PCA coefficients per frame
        and ``CoefDecoder`` reconstructs meshes that match offline; "coef16"
        halves the wire again and stays float16."""
        jtask, ttask, _ = tasks
        sig = _sig(seconds=1.3, seed=51)
        ts_ref, verts_ref = ttask.generate_vertices(sig, 1)
        dec = CoefDecoder(ttask)
        assert dec.n_coefs == 85 + 180
        for wire, atol, dtype in (("coef", 5e-5, np.float32), ("coef16", 5e-4, np.float16)):
            kw = dict(capacity=2, emit_batch=8, wire=wire)
            got, _ = _serve_one(StreamingServer, ttask, sig, 1, **kw)
            assert _times(got) == list(ts_ref), wire
            coefs = _stack(got)
            assert coefs.shape == (len(ts_ref), dec.n_coefs) and coefs.dtype == dtype
            assert float(np.abs(dec.decode(coefs) - verts_ref).max()) <= atol, wire
            jgot, _ = _serve_one(JServer, jtask, sig, 1, **kw)
            assert _times(jgot) == _times(got), wire
            jcoefs = _stack(jgot)
            assert jcoefs.dtype == dtype
            # coefficients are O(1): 1e-4 absolute in float32, one float16 step more
            tol = 1e-4 if wire == "coef" else 1e-4 + 2e-3 * float(np.abs(jcoefs).max())
            assert float(np.abs(coefs.astype(np.float32) - jcoefs.astype(np.float32)).max()) <= tol
            verts_j = JCoefDecoder(jtask).decode(jcoefs)
            assert float(np.abs(dec.decode(coefs) - verts_j).max()) <= atol, wire
