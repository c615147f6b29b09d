"""The readers of the program's spans and counters on synthetic traces with
known intervals (the card's idle time split by stage, the garbage collector
first; the exchange that no other device work hides; the collectives a
step), the global batch put back together from the ranks' shards, and the
data-parallel cell's ``correct`` failing when the gradient exchange is left
out on every rank."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from h100bench_helpers import REPO

from h100bench.drivers.train_dp import unshard
from h100bench.metrics_ctx import Context
from h100bench.run import metric_reader
from h100bench.stages import BUCKETS, STAGES, exposed_us, idle_by_stage
from h100bench.tracing import Trace


def _event(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": float(ts), "dur": float(dur)}


STEP_SPANS = [  # two steps of the train loop's shape, times in µs
    ("bench/step", 0, 1000), ("bench/step", 1000, 1000),
    ("train/upload", 0, 40), ("train/zero_grad", 40, 20), ("train/forward_loss", 60, 440),
    ("train/features", 70, 100), ("train/model", 170, 200), ("train/loss_terms", 380, 100),
    ("train/backward", 500, 300), ("train/clip_adam", 800, 150),
    ("train/upload", 1000, 50), ("train/zero_grad", 1050, 30), ("train/forward_loss", 1080, 420),
    ("train/features", 1090, 90), ("train/model", 1180, 210), ("train/loss_terms", 1400, 80),
    ("train/backward", 1500, 300), ("train/clip_adam", 1800, 120),
    ("mesh/all_reduce_sum", 200, 30), ("bench/next_batch", 960, 30),
    ("host/gc", 180, 45), ("host/gc", 955, 20), ("host/gc", 1995, 10),
]
NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL"
KERNELS = [("gemm", 100, 50), ("gemm", 190, 120), (NCCL, 300, 100), ("elementwise", 350, 20),
           ("bwd", 520, 200), ("adam", 820, 60), ("gemm", 1100, 40), (NCCL, 1190, 150),
           ("bwd", 1510, 250), ("adam", 1830, 50), ("late", 1990, 30)]
COPIES = [("Memcpy HtoD (Pinned -> Device)", 10, 20), ("Memcpy HtoD (Pinned -> Device)", 1330, 30)]


def _trace(spans=STEP_SPANS, kernels=KERNELS, copies=COPIES):
    events = [_event(n, ts, dur) for n, ts, dur in spans]
    events += [_event(n, ts, dur, "kernel") for n, ts, dur in kernels]
    events += [_event(n, ts, dur, "gpu_memcpy") for n, ts, dur in copies]
    events.append(_event("train/model", 170, 200, "gpu_user_annotation"))  # not a host span
    return Trace(events, "bench/step")


def _brute_force(spans, kernels, copies, t0, t1):
    """Idle µs by bucket, one µs at a time: every time here is whole µs."""
    busy = np.zeros(t1 - t0, bool)
    for _, ts, dur in kernels + copies:
        busy[max(ts, t0) - t0:min(ts + dur, t1) - t0] = True
    out = dict.fromkeys(BUCKETS, 0)
    for t in range(t0, t1):
        if busy[t - t0]:
            continue
        if any(n == "host/gc" and ts <= t < ts + d for n, ts, d in spans):
            out["gc"] += 1
            continue
        open_ = [(ts, -d, n) for n, ts, d in spans if n in STAGES and ts <= t < ts + d]
        out[STAGES[max(open_)[2]] if open_ else "unassigned"] += 1
    return out, int((~busy).sum())


def test_idle_split_by_stage_is_exact():
    split = idle_by_stage(_trace())
    want, idle = _brute_force(STEP_SPANS, KERNELS, COPIES, 0, 2000)
    assert {k: split[k] for k in BUCKETS} == {k: float(v) for k, v in want.items()}
    assert sum(split[k] for k in BUCKETS) == split["total"] == float(idle)
    # the collector's pauses go to gc before the stage open over them: 180-190 inside
    # the model (a kernel from 190), 955-975 inside the next batch; 1995-2000 is busy
    assert split["gc"] == 10 + 20
    assert all(split[k] > 0 for k in BUCKETS)


def test_idle_readers_give_ms_a_step_and_nothing_without_the_stage_spans():
    tr = _trace()
    ctx = Context({}, {"hparams": {}}, {}, dict(counts={"steps": 2}, host={}, trace=tr))
    split = idle_by_stage(tr)
    for bucket in ("features", "model", "loss", "backward", "optimizer", "gc"):
        assert metric_reader(f"train.idle_ms.{bucket}")(ctx) == split[bucket] * 1e-3 / 2
    parent = _trace(spans=[s for s in STEP_SPANS if s[0] in ("bench/step", "train/forward_loss",
                                                              "train/backward")])
    ctx = Context({}, {"hparams": {}}, {}, dict(counts={"steps": 2}, host={}, trace=parent))
    for bucket in ("features", "model", "loss", "backward", "optimizer", "gc"):
        assert metric_reader(f"train.idle_ms.{bucket}")(ctx) is None


def test_exchange_exposed_is_the_nccl_time_no_other_work_hides():
    tr = _trace()
    # 300-400: a gemm hides 300-310, the elementwise kernel 350-370; 1190-1340: a copy
    # hides 1330-1340
    assert exposed_us(tr) == (100 - 10 - 20) + (150 - 10)
    ctx = Context({}, {"hparams": {}}, {}, dict(counts={"steps": 2}, host={}, trace=tr))
    got = metric_reader("train.exchange_exposed_pct")(ctx)
    assert got == pytest.approx(100.0 * 210 / 2000, rel=1e-12)
    one_card = _trace(kernels=[k for k in KERNELS if not k[0].startswith("nccl")])
    ctx = Context({}, {"hparams": {}}, {}, dict(counts={"steps": 2}, host={}, trace=one_card))
    assert metric_reader("train.exchange_exposed_pct")(ctx) is None


def test_collectives_per_step_reads_the_programs_counter():
    read = metric_reader("train.collectives_per_step")
    counts = {"steps": 4, "collectives": 4 * 46}
    assert read(Context({}, {}, {}, dict(counts=counts, host={}, trace=None))) == 46
    assert read(Context({}, {}, {}, dict(counts={"steps": 4}, host={}, trace=None))) is None


def test_unshard_inverts_the_pair_keeping_shard():
    from sdfa_tpu_torch.parallel.mesh import shard_rows

    rng = np.random.default_rng(3)
    whole = {"raw_wav": rng.normal(size=(16, 5)), "speaker_id": np.arange(16)}
    parts = [{k: shard_rows(v, 4, r) for k, v in whole.items()} for r in range(4)]
    for k, v in unshard(parts).items():
        np.testing.assert_array_equal(v, whole[k])


def test_the_exchange_left_out_on_every_rank_is_not_correct(tiny_root, tmp_path):
    """``parallel.mesh.average_gradients`` made a no-op in every process of the
    run (a ``sitecustomize`` on the path): each rank steps on its own
    gradient, and the first gradient is no longer the global batch's."""
    fault = tmp_path / "fault"
    fault.mkdir()
    (fault / "sitecustomize.py").write_text(
        "from sdfa_tpu_torch.parallel import mesh\n"
        "mesh.average_gradients = lambda grads, mesh: None\n")
    env = dict(os.environ, PYTHONPATH=f"{fault}{os.pathsep}{REPO}", TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                           "tiny-dgrad-train-dp4", "--seed", "3000000007", "--seconds", "1",
                           "--trace", "0", "--rehearse"], cwd=tiny_root, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is False
    gap = result["checks"]["grad_norm_gap_median"]
    assert gap["value"] > gap["limit"], result["checks"]
