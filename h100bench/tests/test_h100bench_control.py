"""The controls of ``correct``, on the card at each cell's own size: the plain
reference put in the program's place in the nearest precision below the
configuration's (float32 with TF32 on; for the training cell's reader,
bfloat16), and the program's own
lower-precision path (``SDFA_MATMUL_PRECISION=high``: its
library products in TF32). Each has to come out as not correct on three
seeds. Run with ``python -m pytest h100bench/tests -m gpu`` on the card; it
skips elsewhere."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from h100bench_helpers import BENCH, REPO

SEEDS = ("3000000101", "3000000102", "3000000103")


def _cells():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fp:
        return [w for w in json.load(fp)["workloads"] if w["chips"] == 1]


def _fails(checks, limits) -> bool:
    return any(limits.get(k) is not None and not v <= limits[k] for k, v in checks.items())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c["name"] for c in _cells()])
def test_reference_in_tf32_is_not_correct(on_card, cell):
    with open(os.path.join(BENCH, "limits", cell + ".json")) as fp:
        limits = json.load(fp)["limits"]
    out = subprocess.run([sys.executable, "h100bench/control.py", "--workload", cell, "--seeds",
                          *SEEDS], cwd=REPO, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(rows) >= len(SEEDS)
    assert all(_fails(r["checks"], limits) for r in rows), rows


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c["name"] for c in _cells()])
def test_program_in_tf32_is_not_correct(on_card, cell):
    env = dict(os.environ, SDFA_MATMUL_PRECISION="high")
    for seed in SEEDS:
        out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", cell, "--seed",
                              seed, "--seconds", "10", "--trace", "0"], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is False
