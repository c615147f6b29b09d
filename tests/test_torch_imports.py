"""sdfa_tpu_torch imports neither jax, flax, sdfa_tpu, sklearn, cv2,
matplotlib nor tensorboard (the GPU host has no scikit-learn, no OpenCV, no
matplotlib and no TensorBoard), and importing it builds nothing.
Checked in a fresh interpreter: this test process has jax loaded by conftest.
The sources are also read statement by statement: no import of jax, flax,
sdfa_tpu or sklearn anywhere in the port or in ``chip_smoke.py``, and OpenCV,
matplotlib and TensorBoard only inside the functions that need them."""

import ast
import os
import subprocess
import sys

import pytest

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DATA_MODULES = ["sdfa_tpu_torch.api", "sdfa_tpu_torch.utils.filesystem"] + [
    f"sdfa_tpu_torch.data.{m}" for m in ("csvio", "speech_anime", "synthetic", "features_host",
                                         "device_features", "sliding_window", "thread_prefetch",
                                         "prefetch")]
CLI_MODULES = ["sdfa_tpu_torch.__main__", "sdfa_tpu_torch.tools", "sdfa_tpu_torch.profiling",
               "sdfa_tpu_torch.compat.torch_ckpt", "sdfa_tpu_torch.audio.io",
               "sdfa_tpu_torch.audio.rms", "sdfa_tpu_torch.utils.argparser",
               "sdfa_tpu_torch.utils.stream", "sdfa_tpu_torch.viewer.render",
               "sdfa_tpu_torch.viewer.video"]
PREPROCESS_MODULES = ["sdfa_tpu_torch.data.vocaset.preload", "sdfa_tpu_torch.data.vocaset.config",
                      "sdfa_tpu_torch.ops.dgrad", "sdfa_tpu_torch.ops.rotation",
                      "sdfa_tpu_torch.audio.misc"]
PARALLEL_MODULES = ["sdfa_tpu_torch.parallel", "sdfa_tpu_torch.parallel.mesh",
                    "sdfa_tpu_torch.parallel.multihost"]
LAST_MODULES = ["sdfa_tpu_torch.utils.log", "sdfa_tpu_torch.utils.npext",
                "sdfa_tpu_torch.utils.bilateral", "sdfa_tpu_torch.utils.visualizer",
                "sdfa_tpu_torch.nn.precision", "sdfa_tpu_torch.audio.features",
                "sdfa_tpu_torch.train.stepbench", "sdfa_tpu_torch.train.summary",
                "sdfa_tpu_torch.visualize", "sdfa_tpu_torch.native"]
_BAD = "('jax', 'jaxlib', 'flax', 'sdfa_tpu', 'sklearn', 'cv2', 'matplotlib', 'tensorboard')"

_SCRIPT = (f"NEW = {DATA_MODULES + CLI_MODULES + PREPROCESS_MODULES + PARALLEL_MODULES!r}\n"
           f"NEW += {LAST_MODULES!r}\n") + r"""
import importlib, pkgutil, sys
import sdfa_tpu_torch
names = ["sdfa_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    sdfa_tpu_torch.__path__, "sdfa_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sdfa_tpu", "sklearn", "cv2",
                                    "matplotlib", "tensorboard"))
from sdfa_tpu_torch.ops import build
missing = sorted(({"sdfa_tpu_torch.ops.bilstm_core", "sdfa_tpu_torch.ops.bilstm_layer",
                   "sdfa_tpu_torch.models.losses", "sdfa_tpu_torch.train.trainer",
                   "sdfa_tpu_torch.train.checkpoints", "sdfa_tpu_torch.train.lr_schedules",
                   "sdfa_tpu_torch.streaming", "sdfa_tpu_torch.serve"} | set(NEW))
                 - set(names))
assert not missing, missing
print(len(names), bad, sorted(build._LIBS))
"""


@pytest.fixture(scope="module")
def import_report():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def test_every_module_imports_without_jax(import_report):
    n, bad, _ = import_report.split(" ", 2)
    assert int(n) >= 63, import_report  # every subpackage walked; data/, api, utils, the CLI
    assert bad == "[]", f"sdfa_tpu_torch pulled in {bad}"


def test_import_builds_no_kernel(import_report):
    assert import_report.endswith("[]"), import_report


def _alone(module):
    script = (f"import sys, {module}\n"
              "print(sorted(m for m in sys.modules "
              f"if m.split('.')[0] in {_BAD}))")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("module", DATA_MODULES)
def test_training_module_alone_imports_without_jax_or_cv2(module):
    """A training-path module imported on its own, as a loader worker's
    process does, pulls in no jax, flax, sdfa_tpu or cv2."""
    _alone(module)


@pytest.mark.parametrize("module", ["streaming", "serve"])
def test_serving_module_alone_imports_without_jax(module):
    """Importing the live-serving modules on their own, as a service's
    process does, pulls in no jax, flax or sdfa_tpu either."""
    _alone(f"sdfa_tpu_torch.{module}")


@pytest.mark.parametrize("module", PREPROCESS_MODULES)
def test_preprocess_module_alone_imports_without_jax_or_sklearn(module):
    """The preprocessing pipeline and the float64 extraction, each imported
    on its own, pull in no jax, sdfa_tpu or sklearn: the PCA fit is the
    port's own."""
    _alone(module)


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_module_alone_imports_without_jax(module):
    """The data-parallel modules, each imported on its own, as a rank's
    process does, pull in no jax, flax or sdfa_tpu."""
    _alone(module)


@pytest.mark.parametrize("module", LAST_MODULES)
def test_last_module_alone_imports_without_jax_cv2_matplotlib_or_tensorboard(module):
    """The modules of the JAX package's remainder (logging, the bilateral
    filter, the plotting helpers, library precision, the feature registry,
    ``StepEnv``, the summaries, dataset videos, the native runtime), each
    imported on its own, pull in none of them, and build nothing."""
    _alone(module)


@pytest.mark.parametrize("module", ["__main__", "viewer.video", "compat.torch_ckpt"])
def test_cli_module_alone_imports_without_jax_cv2_or_matplotlib(module):
    """The CLI, the evaluation exports (renderer, video, template from paths)
    and the reference checkpoint reader, each imported on its own, pull in
    none of them."""
    _alone(f"sdfa_tpu_torch.{module}")


def _imports(path, full=False):
    """(module name, whether the import statement is at module level) of every
    import in the file: the top-level package's name, or with ``full`` the
    dotted name."""
    tree = ast.parse(open(path).read(), path)
    top = {id(node) for node in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            yield (name if full else name.split(".")[0]), id(node) in top


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(REPO, "sdfa_tpu_torch")):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_sources_import_no_jax_and_no_cv2_at_module_level():
    found = {os.path.relpath(p, REPO): list(_imports(p)) for p in _sources()}
    assert "sdfa_tpu_torch/__main__.py" in found and len(found) >= 53
    jax_like = {p: n for p, names in found.items() for n, _ in names
                if n in ("jax", "jaxlib", "flax", "sdfa_tpu", "sklearn")}
    assert not jax_like, jax_like
    top_level = {p: n for p, names in found.items() for n, top in names
                 if top and n in ("cv2", "matplotlib")}
    assert not top_level, top_level
    tensorboard = {p: n for p in found for n, top in _imports(os.path.join(REPO, p), full=True)
                   if top and "tensorboard" in n}
    assert not tensorboard, tensorboard
    # the viewer does import them, inside its functions
    assert ("cv2", False) in found["sdfa_tpu_torch/viewer/render.py"]
    assert ("matplotlib", False) in found["sdfa_tpu_torch/viewer/video.py"]
    assert ("matplotlib", False) in found["sdfa_tpu_torch/utils/visualizer.py"]
    assert ("torch.utils.tensorboard", False) in _imports(
        os.path.join(REPO, "sdfa_tpu_torch/train/summary.py"), full=True)
