"""The whole wav → vertices slice, port vs JAX: ``AnimationTask.
generate_vertices`` on the flagship dgrad network (full widths, same flax
variables on both sides through the weight bridge) over a small synthetic
template, with the PCA dims cut to that mesh (6·/3·n_tris) and seeded PCA
bases. The JAX task runs its device frontend and overlap path (the XLA
scan and solve paths on CPU); the port runs its plain versions on CPU.

Budget: the ROADMAP's 1e-4 m; both sides are f32 through the same math,
so the test holds them to 1e-5 m."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_nn import _perturb

from sdfa_tpu.models import build_model as jbuild
from sdfa_tpu.task import AnimationTask as JTask
from sdfa_tpu.tools import configure as jconfigure
from sdfa_tpu.viewer import frame as jframe
from sdfa_tpu_torch.compat import load_flax_variables
from sdfa_tpu_torch.config import configure as tconfigure
from sdfa_tpu_torch.mesh import synthetic_template, write_ply
from sdfa_tpu_torch.models import build_model as tbuild
from sdfa_tpu_torch.task import AnimationTask as TTask
from sdfa_tpu_torch.viewer import frame as tframe

TOL_M = 1e-5

_BN = "batch_norm={'momentum': 0.01, 'eps': 0.001}"
_LRELU = "act=lrelu@a:0.2"


def narrow_model():
    """The dgrad network's layers at narrow widths (the same layer types, 128
    mel bins → 32 frequency steps, 85 + 180 coefficients): what the serving
    test files other than this one run, so that they stay fast on a CPU."""
    head = [("fc", 24 + 8, 24, _LRELU, "cat_condition=2"), ("fc", 24, 16, "act=tanh")]
    return {"audio_encoder": {"layers": [
        ("permute", (0, 3, 2, 1)),
        ("conv2d", 3, 6, (3, 1), (1, 1), _LRELU, _BN),
        ("pool2d", "max", (2, 1)),
        ("conv2d", 6, 8, (3, 1), (1, 1), _LRELU, _BN),
        ("pool2d", "max", (2, 1)),
        ("conv2d", 8, 8, (1, 1), (1, 1), _LRELU, _BN),
        ("freq-lstm", 8, 32, "hidden_size=8", "output_size=16"),
        ("squeeze", 2),
        ("permute", (0, 2, 1)),
        ("lstm", 16, 12, "num_layers=2", "bidirectional=True", "dropout=0.1"),
        ("attn", "bah", 24, 12, 2, "scale_score_at_eval=1.0"),
    ]}, "output": {
        "layers": [("fc", 24 + 8, 24, _LRELU, "cat_condition=2")],
        "layers_scale": head + [("fc", 16, 85, "act=linear")],
        "layers_rotat": head + [("fc", 16, 180, "act=linear")],
    }}


@contextlib.contextmanager
def task_pair(root, narrow=False, **port_kwargs):
    """(JAX task, port task, n_verts) on the same weights over a small
    synthetic template installed on both sides; both template states are
    restored on exit. Shared by the other ``test_torch_*`` serving files,
    which pass ``narrow=True`` (``narrow_model``); this file runs the full
    widths."""
    verts, faces, cnst = synthetic_template(2, n_major=10, n_minor=12, n_extra=5, n_free=50)
    n = len(faces)
    rng = np.random.default_rng(0)
    (root / "pca").mkdir()
    for name, shape in (("scale_compT", (6 * n, 85)), ("scale_means", (6 * n,)),
                        ("rotat_compT", (3 * n, 180)), ("rotat_means", (3 * n,))):
        np.save(root / "pca" / f"{name}.npy", rng.normal(0, 0.02, shape).astype(np.float32))
    write_ply(str(root / "template.ply"), verts, faces)
    (root / "cnst.txt").write_text(" ".join(str(int(i)) for i in cnst))
    dims = {"model": {"output": {"output_dim_scale": 6 * n, "output_dim_rotat": 3 * n}}}
    if narrow:
        net = narrow_model()
        dims["model"]["audio_encoder"] = net["audio_encoder"]
        dims["model"]["output"].update(net["output"])

    jhp = jconfigure("dgrad", overrides=dims, dataset_root=str(root))
    jmodel = jbuild(jhp, load_pca=True)
    k = jax.random.PRNGKey(0)
    variables = jax.device_get(jmodel.init({"params": k, "dropout": k},
                                           jnp.zeros((2, 64, 128, 3), jnp.float32),
                                           jnp.zeros((2,), jnp.int32), False))
    variables = _perturb(variables, rng)

    saved_j, saved_t = dict(jframe._state), dict(tframe._state)
    try:
        # the JAX template state is module-global and later test files in
        # this worker expect the FLAME template: restored below
        jframe.set_template_mesh(str(root / "template.ply"), str(root / "cnst.txt"))
        tframe.set_template_mesh(verts, faces, cnst)
        jtask = JTask(jhp, jmodel, variables, device_frontend=True, overlap_frontend=True)
        tmodel = load_flax_variables(tbuild(tconfigure("dgrad", overrides=dims,
                                                       dataset_root=str(root))), variables)
        yield jtask, TTask(tconfigure("dgrad", overrides=dims, dataset_root=str(root)),
                           tmodel, "cpu", **port_kwargs), len(verts)
    finally:
        jframe._state.clear()
        jframe._state.update(saved_j)
        tframe._state.clear()
        tframe._state.update(saved_t)


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    with task_pair(tmp_path_factory.mktemp("slice")) as pair:
        yield pair


def _signal(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 8000)) / 8000
    sig = 0.3 * np.sin(2 * np.pi * 150 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3 * t))
    return (sig + 0.02 * rng.standard_normal(len(t))).clip(-1, 1).astype(np.float32)


@pytest.mark.parametrize("seconds,speaker", [(0.6, 2), (0.9, "f1")])
def test_generate_vertices_matches_jax(tasks, seconds, speaker):
    jtask, ttask, n_verts = tasks
    sig = _signal(seconds, int(seconds * 10))
    ts_j, verts_j = jtask.generate_vertices(sig, speaker)
    ts_t, verts_t = ttask.generate_vertices(sig, speaker)
    assert list(ts_t) == list(ts_j)
    assert verts_t.shape == np.asarray(verts_j).shape == (len(ts_j), n_verts, 3)
    assert np.isfinite(verts_t).all()
    assert float(np.abs(verts_t - np.asarray(verts_j)).max()) < TOL_M


def test_warmup_and_unported_wires(tasks):
    """``warmup`` takes the reference's arguments; a wire neither side knows is
    a ``ValueError`` with the reference's text; the host-numpy frontend builds
    and takes the per-window path, as the JAX task's does (its parity:
    ``tests/test_torch_data.py::test_host_frontend_task_matches_jax``)."""
    jtask, ttask, _ = tasks
    assert ttask.warmup(seconds=0.3) >= 0.0
    assert ttask.warmup(0.3, "i16", 1) >= 0.0
    for task in (jtask, ttask):
        with pytest.raises(ValueError, match="unknown wire format 'i4'"):
            task.generate_vertices(_signal(0.3, 1), 0, wire="i4")
    host = TTask(ttask.hp, ttask.model, "cpu", device_frontend=False)
    assert not host.device_frontend and not host.overlap_frontend
    assert ttask.device_frontend and ttask.overlap_frontend


def test_task_switches_tf32_off(tasks):
    """AnimationTask leaves both TF32 switches off without the caller's help."""
    _, ttask, _ = tasks
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        TTask(ttask.hp, ttask.model, "cpu")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
