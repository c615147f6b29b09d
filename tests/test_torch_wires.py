"""Offline requests of the port on every wire, with ensembling and through
the exact per-window path, against the JAX task on the same weights, audio
and small synthetic template (the fixture of tests/test_torch_slice.py, with
the network's layers at narrow widths).

Tolerances, all in metres:
- a quantized wire against the port's own f32 wire: i16 ≤ WIRE_LSB / 2 + 1e-7
  = 5.1e-6, i8d ≤ WIRE_LSB8 / 2 + 1e-7 = 2.01e-5 (tests/test_task.py's);
- the same wire on both sides: the f32 vertices differ by about 6e-8 m, so a
  quantized integer may land one step apart at a rounding boundary: every
  cell ≤ one step + 1e-7, and fewer than 2% of the cells differ at all;
- coef against the float64 ``solve_host`` oracle ≤ 1e-6, against the f32 wire
  ≤ 1e-5;
- f32, ensembled and per-window requests against the JAX task ≤ 1e-5;
- the fused path against ``generate_animation`` + ``frames_to_meshes`` ≤ 1e-6
  (tests/test_task.py:194), against the per-window path ≤ 1e-5;
- ``others`` (inputs, latent, alignments) against the JAX task's ≤ 1e-4.
"""

import numpy as np
import pytest

from test_torch_slice import _signal, task_pair

from sdfa_tpu_torch import task as ttask_mod
from sdfa_tpu_torch.task import WIRE_LSB, WIRE_LSB8
from sdfa_tpu_torch.task import AnimationTask as TTask
from sdfa_tpu_torch.viewer import frame as tframe

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

STEP = {"i16": WIRE_LSB, "i8d": WIRE_LSB8}


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    with task_pair(tmp_path_factory.mktemp("wires"), narrow=True) as pair:
        yield pair


@pytest.fixture(scope="module")
def request_f32(tasks):
    jtask, ttask, _ = tasks
    sig = _signal(0.9, 4)
    return sig, jtask.generate_vertices(sig, 1), ttask.generate_vertices(sig, 1)


def test_constants_are_the_reference_s():
    from sdfa_tpu import task as jtask_mod

    assert (ttask_mod.WIRE_LSB, ttask_mod.WIRE_LSB8) == (jtask_mod.WIRE_LSB, jtask_mod.WIRE_LSB8)


@pytest.mark.parametrize("wire", ["i16", "i8d"])
def test_quantized_wire_matches_f32_and_jax(tasks, request_f32, wire):
    jtask, ttask, _ = tasks
    sig, _, (ts_f, verts_f) = request_f32
    ts_q, verts_q = ttask.generate_vertices(sig, 1, wire=wire)
    assert ts_q == ts_f and verts_q.dtype == np.float32 and verts_q.shape == verts_f.shape
    assert float(np.abs(verts_q - verts_f).max()) <= STEP[wire] / 2 + 1e-7
    _, verts_j = jtask.generate_vertices(sig, 1, wire=wire)
    diff = np.abs(verts_q - np.asarray(verts_j))
    assert float(diff.max()) <= STEP[wire] + 1e-7
    assert float((diff > 1e-7).mean()) < 0.02  # cells a rounding boundary split


def test_i8d_carry_crosses_window_chunks(tasks, monkeypatch):
    """A lowered ``MAX_WINDOW_BATCH`` cuts the clip into chunks: the integer
    carry stays on the device between them and the host's running sum still
    lands within half a step of the f32 wire at every frame."""
    _, ttask, _ = tasks
    sig = _signal(1.3, 6)
    _, verts_f = ttask.generate_vertices(sig, 0)
    monkeypatch.setattr(ttask_mod, "MAX_WINDOW_BATCH", 32)
    _, verts_d = ttask.generate_vertices(sig, 0, wire="i8d")
    assert len(verts_d) > 2 * 32  # really crossed two chunk boundaries
    assert float(np.abs(verts_d - verts_f).max()) <= WIRE_LSB8 / 2 + 1e-7
    assert float(np.abs(verts_d[-8:] - verts_f[-8:]).max()) <= WIRE_LSB8 / 2 + 1e-7  # no drift


def test_coef_wire_matches_oracle_and_jax(tasks, request_f32):
    jtask, ttask, _ = tasks
    sig, _, (ts_f, verts_f) = request_f32
    ts_c, verts_c = ttask.generate_vertices(sig, 1, wire="coef")
    assert ts_c == ts_f and verts_c.shape == verts_f.shape
    assert float(np.abs(verts_c - verts_f).max()) <= 1e-5
    _, animes, _ = ttask.generate_animation(sig, 1)
    solver = tframe.get_solver()
    oracle = np.stack([solver.solve_host(a) for a in animes[::7]])
    assert float(np.abs(verts_c[::7] - oracle).max()) <= 1e-6
    _, verts_j = jtask.generate_vertices(sig, 1, wire="coef")
    assert float(np.abs(verts_c - np.asarray(verts_j)).max()) <= 1e-5


def test_coef_wire_needs_pca_heads(tasks, monkeypatch):
    _, ttask, _ = tasks
    monkeypatch.setattr(ttask, "_has_coef_heads", lambda: False)
    with pytest.raises(ValueError, match="wire='coef' needs dgrad_3d PCA heads"):
        ttask.generate_vertices(_signal(0.3, 1), 0, wire="coef")


def test_ensembling_matches_jax_and_is_the_mean_of_two_runs(tasks):
    jtask, ttask, _ = tasks
    sig = _signal(0.8, 8)
    ts_t, verts_t = ttask.generate_vertices(sig, 2, ensembling_ms=100.0)
    ts_j, verts_j = jtask.generate_vertices(sig, 2, ensembling_ms=100.0)
    assert list(ts_t) == list(ts_j)
    assert float(np.abs(verts_t - np.asarray(verts_j)).max()) <= 1e-5
    pad = int(100.0 * 8000) // 1000
    _, a0, _ = ttask.generate_animation(sig, 2)
    _, a1, _ = ttask.generate_animation(np.pad(sig[:-pad], (pad, 0)), 2)
    mean, _ = tframe.frames_to_meshes((a0 + a1) / 2.0, "dgrad_3d", "cpu")
    np.testing.assert_array_equal(verts_t, mean)
    assert float(np.abs(verts_t - ttask.generate_vertices(sig, 2)[1]).max()) > 1e-6  # it did shift


def test_fused_matches_roundtrip(tasks, request_f32):
    _, ttask, n_verts = tasks
    sig, _, (ts_f, verts_f) = request_f32
    ts_a, animes, _ = ttask.generate_animation(sig, 1)
    assert ts_a == ts_f
    ref, faces = tframe.frames_to_meshes(animes, "dgrad_3d", "cpu")
    assert ref.shape == verts_f.shape == (len(animes), n_verts, 3) and faces.shape[1] == 3
    np.testing.assert_allclose(verts_f, ref, atol=1e-6)
    one, _ = tframe.frame_to_mesh(animes[3], "dgrad_3d", "cpu")
    np.testing.assert_allclose(one, ref[3], atol=1e-7)  # a product of another batch size


def test_fallback_when_overlap_off(tasks):
    """``overlap_frontend=False`` runs the exact per-window path (features per
    window, ``batch_windows`` chunks with a padded tail, the signal cache) and
    lands on the fused path's vertices and on the JAX task's."""
    from sdfa_tpu.task import AnimationTask as JTask

    jtask, ttask, _ = tasks
    sig = _signal(0.7, 9)
    exact = TTask(ttask.hp, ttask.model, "cpu", batch_windows=24, overlap_frontend=False)
    assert not exact.overlap_frontend and ttask.overlap_frontend
    ts_e, verts_e = exact.generate_vertices(sig, 0)
    ts_f, verts_f = ttask.generate_vertices(sig, 0)
    assert ts_e == ts_f and len(ts_e) % 24  # the tail chunk was padded
    assert float(np.abs(verts_e - verts_f).max()) <= 1e-5
    jexact = JTask(jtask.hp, jtask.model, jtask.variables, batch_windows=24,
                   device_frontend=True, overlap_frontend=False)
    ts_j, verts_j = jexact.generate_vertices(sig, 0)
    assert list(ts_j) == list(ts_e)
    assert float(np.abs(verts_e - np.asarray(verts_j)).max()) <= 1e-5
    key = exact._signal_cache[0]
    _, again = exact.generate_vertices(sig, 0)  # served from the signal cache
    assert exact._signal_cache[0] is key
    np.testing.assert_array_equal(again, verts_e)
    exact.generate_vertices(sig, 0, ensembling_ms=50.0)  # another key: ensembling is part of it
    assert exact._signal_cache[0] != key and len(exact._signal_cache[1]) == 2


def test_others_match_jax(tasks, request_f32):
    jtask, ttask, _ = tasks
    sig = request_f32[0]
    _, animes_t, others_t = ttask.generate_animation(sig, 1)
    _, animes_j, others_j = jtask.generate_animation(sig, 1)
    assert float(np.abs(animes_t - np.asarray(animes_j)).max()) <= 1e-4
    assert set(others_t) == set(others_j)
    for key in ("inputs", "latent", "latent_align"):
        assert others_t[key].shape == np.asarray(others_j[key]).shape, key
        assert float(np.abs(others_t[key] - np.asarray(others_j[key])).max()) <= 1e-4, key
    assert others_t["phones"] is None and others_t["formants"] is None


def test_same_positional_and_keyword_calls_on_both_sides(tasks, request_f32):
    jtask, ttask, _ = tasks
    sig, _, (ts_f, verts_f) = request_f32
    for task in (jtask, ttask):
        ts, verts = task.generate_vertices(sig, "f1", 0, None, "i16")
        assert list(ts) == list(ts_f) and np.asarray(verts).shape == verts_f.shape
        ts, verts = task.generate_vertices(signal=sig, speaker=1, emotion=0, ensembling_ms=0,
                                           wire="f32")
        assert float(np.abs(np.asarray(verts) - verts_f).max()) <= 1e-5
        assert task.warmup(0.3, "f32", 2) >= 0.0
        assert task.warmup(seconds=0.3, wire="coef", speaker="f2") >= 0.0


def test_results_do_not_alias_and_repeat_bit_for_bit(tasks, request_f32):
    """Two requests in a row own their arrays (the download buffer is
    reused), and a request with every cache cleared gives the warm request's
    bits."""
    from sdfa_tpu_torch.audio import pipeline as tpipe

    _, ttask, _ = tasks
    sig, _, (_, verts_f) = request_f32
    _, first = ttask.generate_vertices(sig, 1)
    kept = first.copy()
    _, other = ttask.generate_vertices(_signal(0.9, 5), 3)
    assert not np.shares_memory(first, other)
    np.testing.assert_array_equal(first, kept)
    np.testing.assert_array_equal(first, verts_f)
    tpipe.clear_const_cache()
    for module in ttask.model.modules():
        if hasattr(module, "_stacked"):
            module._stacked.clear()
    _, cold = ttask.generate_vertices(sig, 1)
    np.testing.assert_array_equal(cold, verts_f)
