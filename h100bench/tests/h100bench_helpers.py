"""Helpers of the benchmark's CPU tests: a copy of the benchmark in a
temporary directory with tiny cells of its own, and a run of it on the CPU's
plain route."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_STREAM = {"clients": 2, "capacity": 2, "clip_s": [1.0, 1.5], "clip_bank": 2, "warm_s": 0.3,
               "check_streams": 2, "check_span": 2}
TINY_TRAIN = {"batch_pairs": 4, "corpus": {"sentences": 1, "seconds": 1.5}, "warm_s": 0.0}
# the tiny cells' own limits, from CPU runs of the port against the reference
# (float32 through the kernels' plain versions on both sides of a comparison)
TINY_LIMITS = {
    "stream": {"gap_um": 10.0, "step_mismatch_pct": 1.5, "frame_mismatch_max_pct": 3.0,
               "missing_frames": 0},
    "train": {"grad_norm_gap_median": 1.5e-4, "change_norm_gap": 0.15,
              "change_norm_gap_median": 0.03, "reader_input_gap": 2e-5,
              "reader_target_gap": 1e-4},
}


def with_held_back() -> dict:
    """``BENCHMARK.json`` with the entries of ``held_back.json`` (cells kept
    out of it, whose files stay) added back."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    with open(os.path.join(BENCH, "held_back.json")) as fp:
        held = json.load(fp)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + held[key]
    return bench


def tiny_copy(dest: str, extra_per_layer=()) -> str:
    """``h100bench/`` and a ``BENCHMARK.json`` copied under ``dest``, the
    held-back cells added back, with a tiny cell beside each cell
    (``tiny-<cell>``, the same configuration, its mix cut to a few streams or
    pairs)."""
    shutil.copytree(BENCH, os.path.join(dest, "h100bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = with_held_back()
    for cell in list(bench["workloads"]):
        with open(os.path.join(BENCH, "traffic", cell["traffic"] + ".json")) as fp:
            mix = json.load(fp)
        kind = "stream" if mix["kind"] == "stream_pool" else "train"
        mix.update(TINY_STREAM if kind == "stream" else TINY_TRAIN)
        name = "tiny-" + cell["name"]
        traffic = "tiny_" + cell["traffic"]
        with open(os.path.join(dest, "h100bench", "traffic", traffic + ".json"), "w") as fp:
            json.dump(mix, fp)
        with open(os.path.join(dest, "h100bench", "limits", name + ".json"), "w") as fp:
            json.dump({"limits": TINY_LIMITS[kind]}, fp)
        bench["workloads"].append(dict(cell, name=name, traffic=traffic))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if cell["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
    bench["per_layer"] += list(extra_per_layer)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as fp:
        json.dump(bench, fp)
    return dest


def rehearse(root: str, workload: str, seed: int = 3000000001, trace: int = 0,
             seconds: float = 1.0):
    """Run a cell of the copy at ``root`` on the CPU: (exit code, result or
    None, standard error)."""
    env = dict(os.environ, PYTHONPATH=REPO, TMPDIR=root)
    proc = subprocess.run([sys.executable, "h100bench/run.py", "--workload", workload,
                           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
                           "--rehearse"], cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return proc.returncode, result, proc.stderr
