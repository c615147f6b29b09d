#!/usr/bin/env python
"""Live streams run to capacity on one card: the PyTorch/CUDA port's
counterpart of ``tools/stream_capacity.py``, with the same arguments.

N streams, each fed the same formant-synthesized clip, share one
``StreamingServer(capacity=N)``; the server is ticked until every stream is
done, and the aggregate is N · clip_s / wall.

Modes:
  delivered    every tick's frames downloaded and routed to their streams:
               the service's own path (``tick()``: dispatch, then the wait
               on the pinned copy, dequantization, routing)
  device-only  ``tick_dispatch()`` and the plan's ``inflight`` bookkeeping
               only: no ``HostBuffer.finish``, no dequantization, no
               routing, and one ``torch.cuda.synchronize()`` at the end.
               The port enqueues the device-to-host copy at dispatch
               (``StreamingServer._dispatch`` → ``HostBuffer.start``, two
               pinned buffers that take turns), so the copies still run;
               what this mode leaves out is the host's half of the tick. The
               i8d wire's host mirror is not advanced in this mode.

On the coefficient wires (``coef``, ``coef16``) the client's
``CoefDecoder.decode`` is timed per frame as well, fast and ``precise=True``.

Each N runs a discarded warm round of min(2, clip_s) s, then the timed
round; each round prints one JSON line with the card's name and power limit
and the kernels' launches in it. The last line names the largest N whose
streams each stayed ahead of real time.

Usage (from the repository root):
  python tools/stream_capacity_torch.py --n 8 32 128 --clip-s 8 --wire i16
  python tools/stream_capacity_torch.py --n 8 128 --device-only
  python tools/stream_capacity_torch.py --n 2 --clip-s 1 --platform cpu

Weights: ``--load_from <run>/last.ckpt`` through ``api.load_task``, else
seeded weights (``compat.init_params``) with seeded PCA bases at the shipped
dims (85 / 180 components over 9976 triangles). Capacity depends on the
shapes, not on trained values. The template is ``mesh.synthetic_template(0)``
(FLAME's counts).
"""

import argparse
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402

SEED = 0
N_TRIS = 9976  # FLAME's triangle count, the shipped PCA bases' width


def _formant_utterance(sr: int, seconds: float = 3.0) -> np.ndarray:
    """Formant-synthesized utterance: glottal-like pulse train with an f0
    declination through cascaded second-order formant resonators, syllabic
    envelopes, leading/trailing silence (a copy of ``bench.py``'s, bit for
    bit)."""
    from scipy import signal as sps

    rng = np.random.default_rng(7)
    n = int(seconds * sr)
    out = np.zeros(n, np.float64)
    # /a/ /i/ /u/ /ae/ first three formants (Hz); all < 4 kHz Nyquist
    vowels = [(730, 1090, 2440), (270, 2290, 3010), (300, 870, 2240),
              (660, 1720, 2410)]
    syl, gap, pos, k = 0.22, 0.08, 0.35, 0
    while pos + syl < seconds - 0.3:
        seg_n = int(syl * sr)
        tt = np.arange(seg_n) / sr
        f0 = 150.0 - 25.0 * (pos / seconds) + 8.0 * np.sin(2 * np.pi * 2.0 * tt)
        phase = np.cumsum(2 * np.pi * f0 / sr)
        src = np.power(np.clip(np.sin(phase), 0, None), 3.0) - 0.1
        src = src + rng.normal(0, 0.03, seg_n)
        y = src
        for f, bw in zip(vowels[k % len(vowels)], (90.0, 110.0, 160.0)):
            if f >= sr / 2:
                continue
            r = np.exp(-np.pi * bw / sr)
            y = sps.lfilter([1.0 - r], [1.0, -2.0 * r * np.cos(2 * np.pi * f / sr), r * r], y)
        env = np.clip(np.minimum(tt / 0.03, 1.0), 0, 1) * np.clip(
            np.minimum((syl - tt) / 0.05, 1.0), 0, 1)
        i0 = int(pos * sr)
        out[i0 : i0 + seg_n] += y * env
        pos += syl + gap
        k += 1
    out = out / (np.abs(out).max() + 1e-9) * 0.7
    out += rng.normal(0, 1e-4, n)  # noise floor so log-mel stays finite
    return np.clip(out, -1.0, 1.0).astype(np.float32)


def _clip(hp, seconds: float) -> np.ndarray:
    """At most 3 s of speech, RMS-normalized to ``audio_target_db``,
    zero-padded to ``seconds``."""
    from sdfa_tpu_torch.audio import rms

    sr = int(hp.audio.sample_rate)
    sig = _formant_utterance(sr, min(seconds, 3.0))
    sig = rms.normalize(sig, hp.dataset_anime.get("audio_target_db", -24.5))
    out = np.zeros(int(seconds * sr), np.float32)
    n = min(len(sig), len(out))
    out[:n] = sig[:n]
    return np.clip(out, -1, 1)


def _seeded_pca() -> dict:
    """PCA bases at the shipped dims, drawn as ``bench._ensure_pca`` draws
    its files: one generator of seed 0, N(0, 0.01), in this order."""
    rng = np.random.default_rng(0)
    specs = {"scale_compT": (6 * N_TRIS, 85), "scale_means": (6 * N_TRIS,),
             "rotat_compT": (3 * N_TRIS, 180), "rotat_means": (3 * N_TRIS,)}
    return {name: rng.normal(0, 0.01, shape).astype(np.float32)
            for name, shape in specs.items()}


def _build_task(device, load_from=None):
    """(hparams, task, what the weights are) over ``synthetic_template(0)``."""
    from sdfa_tpu_torch import api
    from sdfa_tpu_torch.compat import init_params
    from sdfa_tpu_torch.config import configure
    from sdfa_tpu_torch.mesh import synthetic_template
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.task import AnimationTask
    from sdfa_tpu_torch.viewer import frame

    frame.set_template_mesh(*synthetic_template(SEED))
    if load_from:
        task = api.load_task(load_from, device=device, device_frontend=True,
                             overlap_frontend=True)
        return task.hp, task, load_from
    hp = configure("dgrad")
    model = init_params(build_model(hp, pca=_seeded_pca()), SEED)
    task = AnimationTask(hp, model, device, device_frontend=True, overlap_frontend=True)
    return hp, task, "seeded"


def _drain_device_only(srv):
    """Dispatch-only ticks: the plan's frames are counted and its slots'
    ``inflight`` released without waiting for the copy; one synchronize at
    the end waits for the last round."""
    import torch

    frames = 0
    while srv.live() and not all(srv.is_done(s) for s in srv.live()):
        pending = srv.tick_dispatch()
        if pending:
            plan, _ = pending
            for _, slot, batch in plan:
                slot.inflight -= len(batch)
                frames += len(batch)
    if srv.task.device.type == "cuda":
        torch.cuda.synchronize(srv.task.device)
    return frames


def _run_round(task, hp, n: int, clip_s: float, wire: str, pipeline: bool,
               device_only: bool, emit_batch: int, block_frames: int):
    from sdfa_tpu_torch.streaming import StreamingServer

    sig = _clip(hp, clip_s)
    srv = StreamingServer(task, capacity=n, emit_batch=emit_batch,
                          block_frames=block_frames, wire=wire,
                          pipeline=pipeline and not device_only)
    t0 = time.perf_counter()
    for i in range(n):
        sid = srv.open(i % 8)
        srv.push(sid, sig)
        srv.flush(sid)
    frames = 0
    if device_only:
        frames = _drain_device_only(srv)
    else:
        while not all(srv.is_done(s) for s in srv.live()):
            out = srv.tick()
            frames += sum(len(v) for v in out.values())
        # pipelined: one more tick drains the in-flight round
        out = srv.tick()
        frames += sum(len(v) for v in out.values())
    wall = time.perf_counter() - t0
    for sid in srv.live():
        srv.close(sid)
    return {
        "wall_s": wall,
        "per_stream_x_realtime": clip_s / wall,
        "aggregate_x_realtime": n * clip_s / wall,
        "frames": frames,
    }


def _launches() -> dict:
    """Kernel launches since the last ``_reset_launches``: K1, K2 and K3's
    delta and full bodies (the wrappers count on the card only)."""
    from sdfa_tpu_torch.ops import bilstm2, decode_solve, freq_lstm

    return {"freq_lstm": freq_lstm.LAUNCHES.total(), "bilstm2": bilstm2.LAUNCHES.total(),
            "decode_solve": decode_solve.LAUNCHES["delta"],
            "decode_solve_full": decode_solve.LAUNCHES["full"]}


def _reset_launches() -> None:
    from sdfa_tpu_torch.ops import bilstm2, decode_solve, freq_lstm

    for mod in (freq_lstm, bilstm2, decode_solve):
        mod.LAUNCHES.clear()


def _card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _client_decode(task, emit_batch: int) -> dict:
    """ms a frame of the client's ``CoefDecoder.decode``, fast and precise,
    on a random batch (its cost does not depend on the values)."""
    from sdfa_tpu_torch.streaming import CoefDecoder

    dec = CoefDecoder(task)
    batch = np.random.default_rng(0).normal(
        size=(emit_batch, dec.n_coefs)).astype(np.float32) * 0.01
    reps = 4
    ms = {}
    for precise in (False, True):
        dec.decode(batch, precise=precise)  # warm the host paths
        t0 = time.perf_counter()
        for _ in range(reps):
            dec.decode(batch, precise=precise)
        ms[precise] = (time.perf_counter() - t0) / (reps * len(batch)) * 1e3
    fps = float(task.wspec.fps)
    return {"ms_per_frame": ms[False],
            # frames one client core decodes a second, over a stream's fps
            "x_realtime_per_core": 1e3 / (ms[False] * fps),
            "ms_per_frame_precise_f64": ms[True], "emit_batch": emit_batch,
            "host_cores": os.cpu_count()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[8])
    ap.add_argument("--clip-s", type=float, default=8.0)
    ap.add_argument("--wire", choices=["f32", "i16", "i8d", "coef", "coef16"], default="i16")
    ap.add_argument("--pipeline", action="store_true", default=True)
    ap.add_argument("--no-pipeline", dest="pipeline", action="store_false")
    ap.add_argument("--device-only", action="store_true")
    ap.add_argument("--emit-batch", type=int, default=16)
    ap.add_argument("--block-frames", type=int, default=16)
    ap.add_argument("--warmup-n", type=int, default=None,
                    help="capacity of the discarded warm round (default: each timed N)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--load_from", default=None,
                    help="a checkpoint (api.load_task); default: seeded weights")
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                    help="run on the card (default) or on the CPU")
    args = ap.parse_args(argv)

    import torch

    if args.platform == "gpu" and not torch.cuda.is_available():
        raise RuntimeError("--platform gpu: torch sees no CUDA device "
                           "(pass --platform cpu to run on the CPU)")
    device = torch.device("cuda" if args.platform == "gpu" else "cpu")
    hp, task, src = _build_task(device, args.load_from)
    card = _card(device)
    results = {"config": {
        "clip_s": args.clip_s, "wire": args.wire, "pipeline": args.pipeline,
        "device_only": args.device_only, "emit_batch": args.emit_batch,
        "block_frames": args.block_frames, "weights": src, "card": card}}
    if args.wire.startswith("coef"):
        results["client_decode"] = _client_decode(task, args.emit_batch)
        print(json.dumps({"client_decode": results["client_decode"], "card": card}),
              flush=True)
    rounds = (args.wire, args.pipeline, args.device_only, args.emit_batch, args.block_frames)
    for n in args.n:
        # the first round at each N builds that N's ring and buffers and warms
        # the allocator: a short discarded round first, so the timed one is warm
        warm = _run_round(task, hp, args.warmup_n or n, min(2.0, args.clip_s), *rounds)
        _reset_launches()
        r = _run_round(task, hp, n, args.clip_s, *rounds)
        r["cold_wall_s"] = warm["wall_s"]
        r["launches"] = _launches()
        results[str(n)] = r
        print(json.dumps({"n": n, **r, "card": card}), flush=True)
    ahead = [n for n in args.n if results[str(n)]["per_stream_x_realtime"] >= 1.0]
    summary = {"largest_n_ahead_of_real_time": max(ahead) if ahead else None,
               "every_n_ahead_of_real_time": len(ahead) == len(args.n), "card": card}
    results["capacity"] = summary
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"capacity": summary}), flush=True)
    return results


if __name__ == "__main__":
    main()
