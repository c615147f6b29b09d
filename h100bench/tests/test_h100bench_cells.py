"""The benchmark's layout and yardstick: every cell found by name, the
contract's shapes of ``BENCHMARK.json``, deterministic traffic, the frozen
cost formulas, and no JAX anywhere in what a run loads."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from h100bench_helpers import BENCH, REPO, with_held_back

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fp:
        return json.load(fp)


def test_every_cell_resolves_by_name():
    """The cells of ``BENCHMARK.json`` and the held-back ones alike."""
    bench = with_held_back()
    configs = {c["name"]: c for c in bench["configs"]}
    for cell in bench["workloads"]:
        cfg = configs[cell["config"]]
        assert os.path.exists(os.path.join(REPO, cfg["file"]))
        with open(os.path.join(BENCH, "traffic", cell["traffic"] + ".json")) as fp:
            mix = json.load(fp)
        assert os.path.exists(os.path.join(BENCH, "drivers", mix["kind"] + ".py"))
        assert os.path.exists(os.path.join(BENCH, "limits", cell["name"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "reference", cell["config"] + ".py"))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]


def test_benchmark_json_keeps_the_contracts_shapes():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert bench["paths"] == ["h100bench"] and 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        with open(os.path.join(REPO, c["file"])) as fp:
            assert json.load(fp)["reduced"] == c["reduced"]
        # only the training corpus's scale is cut, never a width
        assert set(c["reduced"]) <= {"dataset_anime"}
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and set(m["workloads"]) <= cells
    # every cell reports setup_s, another end-to-end metric and a per-layer metric
    for cell in cells:
        assert [m for m in bench["end_to_end"] if m["name"] != "setup_s"
                and cell in m.get("workloads", [cell])]
        assert [m for m in bench["per_layer"] if cell in m["workloads"]]
    assert len(json.dumps(bench)) <= 64 * 1024


@pytest.mark.parametrize("config", ["dgrad", "offsets"])
def test_config_files_hold_the_shipped_widths(config):
    """The frozen configuration is the one ``configs/model/<name>.py`` gives."""
    from sdfa_tpu_torch.config import configure

    with open(os.path.join(BENCH, "configs", config + ".json")) as fp:
        frozen = json.load(fp)["hparams"]
    live = json.loads(json.dumps(configure(config), default=str))
    assert frozen["model"] == json.loads(json.dumps(live["model"]).replace(REPO + "/", ""))
    assert frozen["audio"] == live["audio"]


def test_stream_schedule_is_the_same_for_the_same_seed():
    from h100bench.generator import StreamSchedule

    mix = {"clip_s": [1.0, 2.0], "clip_bank": 3, "speakers": 8, "audio_target_db": -24.5}
    a, b, c = (StreamSchedule(mix, s, 8000) for s in (2 ** 31 + 5, 2 ** 31 + 5, 7))
    assert all(np.array_equal(x, y) for x, y in zip(a.clips, b.clips))
    assert [a.stream(k) for k in range(10)] == [b.stream(k) for k in range(10)]
    assert a.check_set(2, 6, 3) == b.check_set(2, 6, 3)
    # another seed: other inputs, the same set of clip lengths
    assert not all(np.array_equal(x, y) for x, y in zip(a.clips, c.clips))
    assert sorted(map(len, a.clips)) == sorted(map(len, c.clips))


def test_seeded_weights_are_the_same_for_the_same_seed():
    import torch

    from h100bench import weights

    shapes = {"a.kernel_v": torch.Size([3, 4]), "a.kernel_g": torch.Size([4]),
              "l.w_hh_l0": torch.Size([8, 32])}
    x, y = (weights.seeded_state(shapes, 2 ** 31 + 9, "cpu") for _ in range(2))
    assert all(torch.equal(x[k], y[k]) for k in shapes)
    assert bool((x["a.kernel_g"] > 0).all())


def test_cost_formulas_give_the_kernel_tables_operation_counts():
    """The frozen formulas count what the port's own ``cost`` functions count
    (K3 at unpadded sizes, both sides given the same triangle count)."""
    from h100bench import costs
    from sdfa_tpu_torch.ops import bilstm2, bilstm_core, decode_solve, freq_lstm

    assert costs.freq_lstm(768, 32, 64, 128, 256) == freq_lstm.cost(768, 32, 64, 128, 256)
    assert costs.bilstm2(512, 64, 256, 256, False) == bilstm2.cost(512, 64, 256, 256, False)
    assert costs.bilstm_core(32, 6400, 128) == bilstm_core.cost(32, 6400, 128)
    assert costs.decode_solve(256, 85, 180, 9976, 1261)[0] == \
        decode_solve.cost(256, 85, 180, 9976, 1261)[0]
    # the kernel table's rows (PERF.md), their bounds with every product at
    # 67 TFLOP/s: K1 at 768 rows 0.192 ms, K2 at 512 windows 2.564 ms
    assert abs(costs.freq_lstm(768, 32, 64, 128, 256)[0] / 67e12 * 1e3 - 0.192) < 1e-3
    assert abs(costs.bilstm2(512, 64, 256, 256, False)[0] / 67e12 * 1e3 - 2.564) < 1e-3


def test_nothing_a_run_loads_is_jax():
    """Every module of the benchmark, and each module of the port that its
    drivers use, imported in a fresh process: no module whose top-level name
    is jax, jaxlib, flax or sdfa_tpu."""
    mods = ["sdfa_tpu_torch.streaming", "sdfa_tpu_torch.task", "sdfa_tpu_torch.train.trainer",
            "sdfa_tpu_torch.data", "sdfa_tpu_torch.data.thread_prefetch"]
    for dirpath, _, files in os.walk(BENCH):
        if "tests" in dirpath.split(os.sep) or "__pycache__" in dirpath:
            continue
        for f in files:
            if f.endswith(".py") and "." not in f[:-3]:
                rel = os.path.relpath(os.path.join(dirpath, f), REPO)[:-3].replace(os.sep, ".")
                mods.append(rel.removesuffix(".__init__"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'sdfa_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(ref, f)) as fp:
            tree = ast.parse(fp.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("sdfa_tpu_torch", "sdfa_tpu", "jax", "flax"), (f, n)
