"""An offsets request (``configs/model/offsets.py`` at full width, seeded
weights, seeded PCA bases over a small synthetic template) on the card through
the kernels against the same request through ``ops.plain_versions()``:
≤ 1e-5 m, with ``freq_lstm`` and ``bilstm2`` launched once each and
``decode_solve`` not at all."""

import numpy as np
import pytest

from sdfa_tpu_torch import ops
from sdfa_tpu_torch.compat import init_params
from sdfa_tpu_torch.config import configure
from sdfa_tpu_torch.mesh import synthetic_template
from sdfa_tpu_torch.models import build_model
from sdfa_tpu_torch.ops import bilstm2, decode_solve, freq_lstm
from sdfa_tpu_torch.task import AnimationTask
from sdfa_tpu_torch.viewer import frame

pytestmark = pytest.mark.gpu


def test_offsets_request_matches_plain(cuda):
    verts, faces, cnst = synthetic_template(1, n_major=10, n_minor=12, n_extra=5, n_free=50)
    n3 = 3 * len(verts)
    rng = np.random.default_rng(0)
    hp = configure("offsets", overrides={"model": {"output": {"output_dim": n3}}})
    pca = {"compT": rng.normal(0, 0.002, (n3, 59)).astype(np.float32),
           "means": rng.normal(0, 0.002, (n3,)).astype(np.float32)}
    saved = dict(frame._state)
    try:
        frame.set_template_mesh(verts, faces, cnst)
        task = AnimationTask(hp, init_params(build_model(hp, pca=pca), 0), cuda)
        t = np.arange(8000) / 8000
        sig = (0.3 * np.sin(2 * np.pi * 150 * t) + 0.02 * rng.standard_normal(len(t)))
        sig = sig.clip(-1, 1).astype(np.float32)
        task.warmup(1.0)
        freq_lstm.LAUNCHES.clear()
        decode_solve.LAUNCHES.clear()
        bilstm2.LAUNCHES.clear()
        ts, v = task.generate_vertices(sig, 2)
        assert (freq_lstm.LAUNCHES.total(), bilstm2.LAUNCHES.total(),
                decode_solve.LAUNCHES.total()) == (1, 1, 0)
        with ops.plain_versions():
            ts_p, v_plain = task.generate_vertices(sig, 2)
    finally:
        frame._state.clear()
        frame._state.update(saved)
    assert ts == ts_p and v.shape == (len(ts), len(verts), 3) and np.isfinite(v).all()
    assert float(np.abs(v - v_plain).max()) <= 1e-5
