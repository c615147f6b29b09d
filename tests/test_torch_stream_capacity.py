"""``tools/stream_capacity_torch.py`` against the JAX package's
``tools/stream_capacity.py`` on the CPU.

- The clip: the port tool's ``_formant_utterance`` and ``_clip`` equal
  ``bench._formant_utterance`` and the JAX tool's ``_clip`` bit for bit, and
  its seeded PCA bases equal the files ``bench._ensure_pca`` writes.
- A round: ``_run_round`` at N = 2 and 3, on i16 and coef, delivered and
  device-only, counts the same frames as the JAX ``_run_round`` on the same
  weights (``task_pair(narrow=True)`` of tests/test_torch_slice.py carries the
  flax variables into the port), and N times the offline request's frames.
  Delivered frames are recorded from each server's ``tick``: the same
  timestamps, and on i16 the port's frames within the wire's step of the JAX
  server's (5.1e-6 m: half a step each side; JAX_TOL + one step where a
  rounding boundary splits a cell, as tests/test_torch_streaming.py holds
  it, on a share of cells under 2%).
- ``main`` on ``--platform cpu`` prints a line a round and the capacity
  line, and ``--platform gpu`` without a card refuses.

Importing either JAX-side module sets ``SDFA_MATMUL_PRECISION``,
``SDFA_OPS_PRECISION`` and ``JAX_COMPILATION_CACHE_DIR`` by
``os.environ.setdefault``: they are loaded under ``monkeypatch.setenv``, so
this worker's environment comes back as it was.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from test_torch_slice import task_pair

from sdfa_tpu.streaming import StreamingServer as JServer
from sdfa_tpu_torch.streaming import StreamingServer
from sdfa_tpu_torch.task import WIRE_LSB

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOL = 1e-5  # the port against the JAX package on the same path (f32)
CLIP_S = 1.0


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    """(the port's tool, the JAX tool, bench), the JAX-side two loaded with
    the environment they set restored afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDFA_MATMUL_PRECISION", os.environ.get("SDFA_MATMUL_PRECISION", "high"))
        mp.setenv("SDFA_OPS_PRECISION", os.environ.get("SDFA_OPS_PRECISION", "high"))
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
        jtool = _load("_jax_stream_capacity", "tools/stream_capacity.py")
        bench = sys.modules.get("bench") or _load("bench", "bench.py")
        mp.setitem(sys.modules, "bench", bench)  # what the JAX _clip imports
        yield _load("_torch_stream_capacity", "tools/stream_capacity_torch.py"), jtool, bench


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    with task_pair(tmp_path_factory.mktemp("capacity"), narrow=True) as pair:
        yield pair


@pytest.mark.parametrize("sr,seconds", [(8000, 3.0), (8000, 1.0), (16000, 0.5)])
def test_formant_utterance_is_bench_s(tools, sr, seconds):
    tool, _, bench = tools
    got, want = tool._formant_utterance(sr, seconds), bench._formant_utterance(sr, seconds)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seconds", [0.5, 2.0, 8.0])
def test_clip_is_the_jax_tool_s(tools, tasks, seconds):
    tool, jtool, _ = tools
    jtask, ttask, _ = tasks
    got, want = tool._clip(ttask.hp, seconds), jtool._clip(jtask.hp, seconds)
    assert got.shape == (int(seconds * 8000),) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_seeded_pca_is_bench_s(tools, tmp_path):
    tool, _, bench = tools
    root = bench._ensure_pca(str(tmp_path))
    for name, arr in tool._seeded_pca().items():
        np.testing.assert_array_equal(arr, np.load(os.path.join(root, "pca", f"{name}.npy")))


def _recording(monkeypatch, cls):
    """Every frame ``cls.tick`` returns, by stream id."""
    got = {}
    tick = cls.tick

    def recorded(self):
        out = tick(self)
        for sid, frames in out.items():
            got.setdefault(sid, []).extend(frames)
        return out

    monkeypatch.setattr(cls, "tick", recorded)
    return got


@pytest.mark.parametrize("wire", ["i16", "coef"])
@pytest.mark.parametrize("device_only", [False, True], ids=["delivered", "device_only"])
@pytest.mark.parametrize("n", [2, 3])
def test_run_round_matches_jax(tools, tasks, monkeypatch, n, wire, device_only):
    tool, jtool, _ = tools
    jtask, ttask, _ = tasks
    got_t = _recording(monkeypatch, StreamingServer)
    got_j = _recording(monkeypatch, JServer)
    args = (n, CLIP_S, wire, True, device_only, 16, 16)
    r_t = tool._run_round(ttask, ttask.hp, *args)
    r_j = jtool._run_round(jtask, jtask.hp, *args)
    offline = len(ttask.generate_vertices(tool._clip(ttask.hp, CLIP_S), 0)[0])
    assert r_t["frames"] == r_j["frames"] == n * offline > 0
    assert r_t["wall_s"] > 0 and r_t["aggregate_x_realtime"] == pytest.approx(
        n * r_t["per_stream_x_realtime"])
    if device_only:
        assert got_t == got_j == {}  # nothing was collected on either side
        return
    assert sorted(got_t) == sorted(got_j) == list(range(n))
    for sid in range(n):
        assert [ts for ts, _ in got_t[sid]] == [ts for ts, _ in got_j[sid]]
    if wire == "i16":
        v_t = np.stack([v for sid in range(n) for _, v in got_t[sid]])
        v_j = np.stack([np.asarray(v) for sid in range(n) for _, v in got_j[sid]])
        diff = np.abs(v_t - v_j)
        assert float(diff.max()) <= JAX_TOL + WIRE_LSB
        # every cell within half a step of each side's f32 value, but where the two
        # f32 values straddle a rounding boundary and land one step apart
        assert float((diff > WIRE_LSB / 2 + 1e-7).mean()) < 0.02


def test_main_on_the_cpu(tools, tasks, monkeypatch, tmp_path, capsys):
    tool, _, _ = tools
    _, ttask, _ = tasks
    monkeypatch.setattr(tool, "_build_task", lambda device, load_from=None: (
        ttask.hp, ttask, "narrow"))
    out = tmp_path / "cap" / "coef.json"
    results = tool.main(["--n", "2", "--clip-s", "0.5", "--wire", "coef", "--platform", "cpu",
                         "--out", str(out)])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines[0]["client_decode"]["ms_per_frame"] > 0 and lines[0]["card"] == "cpu"
    assert lines[1]["n"] == 2 and lines[1]["frames"] > 0 and lines[1]["card"] == "cpu"
    assert lines[1]["launches"] == {"freq_lstm": 0, "bilstm2": 0, "decode_solve": 0,
                                    "decode_solve_full": 0}  # the CPU launches no kernel
    assert set(lines[1]) >= {"wall_s", "per_stream_x_realtime", "aggregate_x_realtime",
                             "cold_wall_s"}
    assert lines[-1]["capacity"]["every_n_ahead_of_real_time"] == (
        lines[1]["per_stream_x_realtime"] >= 1)
    assert json.loads(out.read_text())["2"]["frames"] == results["2"]["frames"]


def test_gpu_platform_without_a_card_refuses(tools, monkeypatch):
    import torch

    tool, _, _ = tools
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--n", "2"])
