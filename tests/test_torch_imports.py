"""sdfa_tpu_torch imports neither jax, flax, sdfa_tpu nor cv2 (the GPU host has
no OpenCV), and importing it builds nothing. Checked in a fresh interpreter:
this test process has jax loaded by conftest."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DATA_MODULES = ["sdfa_tpu_torch.api", "sdfa_tpu_torch.utils.filesystem"] + [
    f"sdfa_tpu_torch.data.{m}" for m in ("csvio", "speech_anime", "synthetic", "features_host",
                                         "device_features", "sliding_window", "thread_prefetch",
                                         "prefetch")]
_BAD = "('jax', 'jaxlib', 'flax', 'sdfa_tpu', 'cv2')"

_SCRIPT = f"NEW = {DATA_MODULES!r}\n" + r"""
import importlib, pkgutil, sys
import sdfa_tpu_torch
names = ["sdfa_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    sdfa_tpu_torch.__path__, "sdfa_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sdfa_tpu", "cv2"))
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
    assert int(n) >= 42, import_report  # every subpackage walked; data/, api and utils included
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
