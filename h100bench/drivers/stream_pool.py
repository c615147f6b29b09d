"""A closed-loop pool of live streams on one ``StreamingServer``.

``clients`` clients at once: each opens a stream for its speaker, pushes its
whole clip, flushes, and when the stream is done opens the next at once, so
the pool stays full. The window drives ``open / push / flush / tick /
close``; frames count when ``tick()`` delivers them. After the window the
pool stops opening streams and ticks on until the streams under check are
done; their delivered frames are then held to the plain reference."""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from .. import program
from ..generator import StreamSchedule

LSB = 1e-5  # metres a step of the i16 wire (the program's WIRE_LSB)
DRAIN_LIMIT_S = 60.0


class Pool:
    def __init__(self, srv, schedule: StreamSchedule, clients: int, check: List[int]):
        self.srv, self.schedule, self.clients = srv, schedule, clients
        self.opened = 0
        self.owner: Dict[int, int] = {}       # slot → stream number
        self.kept: Dict[int, list] = {k: [] for k in check}
        self.done = set()                     # stream numbers run to their end
        self.z_at_close = 0                   # frames encoded by the streams closed so far
        self.last = None                      # after the window: the last stream to open

    def open_next(self):
        k = self.opened
        clip, speaker = self.schedule.stream(k)
        sid = self.srv.open(speaker)
        self.srv.push(sid, self.schedule.clips[clip])
        self.srv.flush(sid)
        self.owner[sid] = k
        self.opened += 1

    def fill(self):
        while len(self.owner) < self.clients and (self.last is None or self.opened <= self.last):
            self.open_next()

    def tick(self) -> int:
        out = self.srv.tick()
        n = 0
        for sid, frames in out.items():
            n += len(frames)
            k = self.owner[sid]
            if k in self.kept:
                self.kept[k].extend(v for _, v in frames)
        with record_function("bench/refill"):
            for sid in list(self.owner):
                if self.srv.is_done(sid):
                    k = self.owner.pop(sid)
                    self.z_at_close += self.srv._slots[sid].z_done
                    self.done.add(k)
                    self.srv.close(sid)
            self.fill()
        return n

    def encoded(self) -> int:
        """Frames through the encoder's prefix so far (K1's rows), by the
        server's own counters."""
        return self.z_at_close + sum(self.srv._slots[sid].z_done for sid in self.owner)


def run(env) -> Dict:
    from sdfa_tpu_torch.streaming import StreamingServer

    mix, dev = env.mix, env.device
    hp = program.hparams(env.cfg)
    tmpl = program.install_template()
    model, state = program.model_and_state(hp, env.seed, dev)
    task = program.task(hp, model, dev)
    schedule = StreamSchedule(mix, env.seed, int(hp.audio.sample_rate))
    clients = int(mix["clients"])
    check = schedule.check_set(clients, int(mix["check_span"]), int(mix["check_streams"]))
    srv = StreamingServer(task, capacity=int(mix["capacity"]), emit_batch=int(mix["emit_batch"]),
                          block_frames=int(mix["block_frames"]), wire=mix["wire"],
                          pipeline=bool(mix["pipeline"]))
    pool = Pool(srv, schedule, clients, check)
    pool.fill()
    # set-up: the pool's own traffic until every shape it uses has run
    t_warm = time.perf_counter()
    while time.perf_counter() - t_warm < float(mix["warm_s"]):
        pool.tick()
    env.sync()
    setup_s = env.setup_done()

    frames, tick_s = 0, []
    z0 = pool.encoded()
    prof = env.profiler()
    with prof if prof is not None else nullcontext():
        t0 = time.perf_counter()
        while True:
            ta = time.perf_counter()
            if ta - t0 >= env.seconds:
                break
            with record_function("bench/tick"):
                frames += pool.tick()
            tick_s.append(time.perf_counter() - ta)
        window_s = time.perf_counter() - t0
        env.sync()
    encoded = pool.encoded() - z0
    trace = env.reduce_trace(prof, "bench/tick")
    memory_peak = env.memory_peak()

    # after the window: the pool runs on until the streams under check have
    # opened and run to their end, and opens no stream after the last of them
    pool.last = max(check)
    t_drain = time.perf_counter()
    while any(k not in pool.done for k in check) and time.perf_counter() - t_drain < DRAIN_LIMIT_S:
        pool.tick()
    delivered = {k: pool.kept[k] for k in check if k in pool.done}
    drain_s = time.perf_counter() - t_drain
    del pool, srv, task, model
    env.free()

    fps = float(hp.anime.fps)
    e2e = {"stream_x_realtime": frames / fps / window_s}
    counts = {"frames": frames, "ticks": len(tick_s), "encoded": encoded,
              "windows": frames, "streams_checked": len(delivered), "clients": clients}
    t_ref = time.perf_counter()
    ref = reference(env, hp, state, tmpl)
    checks = compare(ref, schedule, check, delivered)
    env.note(setup_s=setup_s, window_s=window_s, drain_s=drain_s,
             reference_s=time.perf_counter() - t_ref, **counts)
    return dict(setup_s=setup_s, e2e=e2e, counts=counts, host={"tick_s": tick_s}, trace=trace,
                model_flops=model_flops(ref, int(mix["block_frames"])), window_s=window_s,
                memory_peak=memory_peak, checks=checks, attempted=len(check), failed=len(check) - len(delivered))


def reference(env, hp, state, tmpl, **kw):
    """The configuration's plain reference over the same seeded weights."""
    import json

    from ..reference import model_class

    return model_class(env.cfg["name"])(json.loads(json.dumps(hp)), state, tmpl, env.device, **kw)


def model_flops(ref, block_frames: int) -> Dict[str, float]:
    """FLOPs of the reference's products (``FlopCounterMode``) for one
    encoded frame (a block's prefix over its frames) and for one window
    (suffix, heads, decode)."""
    from torch.utils.flop_counter import FlopCounterMode

    net, dev, dt = ref.net, ref.net.device, ref.net.dtype
    n_mels = net.mel_fb.shape[0]
    with torch.no_grad(), FlopCounterMode(display=False) as block:
        power = torch.zeros(block_frames, net.mel_fb.shape[1], device=dev, dtype=dt)
        net.encode_frames(torch.zeros(block_frames, n_mels, 3, device=dev, dtype=dt))
        power @ net.mel_fb.T
    with torch.no_grad(), FlopCounterMode(display=False) as window:
        heads = net.suffix(torch.zeros(1, net.geo.frames, net.encoded_width, device=dev, dtype=dt),
                           torch.zeros(1, dtype=torch.long, device=dev))
        ref.decode(heads)
    return {"frame": block.get_total_flops() / block_frames, "window": window.get_total_flops()}


def compare(ref, schedule, check, delivered) -> Dict[str, float]:
    """The numbers that decide ``correct``, each over every frame of the
    streams under check: the widest gap to the reference in micrometres, the
    share of moving coordinates whose i16 step differs from the reference's
    rounding (overall and in the worst frame), and the frames missing or
    extra."""
    moving = ref.moving if hasattr(ref, "moving") else slice(None)
    gap, mism, coords, worst, missing = 0.0, 0, 0, 0.0, 0
    for k in check:
        clip, speaker = schedule.stream(k)
        want = ref.vertices(schedule.clips[clip], speaker)
        got = delivered.get(k, [])
        missing += abs(len(want) - len(got))
        n = min(len(want), len(got))
        if not n:
            continue
        got = np.stack(got[:n]).astype(np.float64)
        want = want[:n]
        gap = max(gap, float(np.abs(got - want).max()))
        q_got = np.rint(got[:, moving] / LSB)
        q_want = np.rint(want[:, moving] / LSB)
        diff = (q_got != q_want).reshape(n, -1)
        mism += int(diff.sum())
        coords += diff.size
        worst = max(worst, float(diff.mean(axis=1).max()))
    return {"gap_um": gap * 1e6, "step_mismatch_pct": 100.0 * mism / max(coords, 1),
            "frame_mismatch_max_pct": 100.0 * worst, "missing_frames": float(missing)}
