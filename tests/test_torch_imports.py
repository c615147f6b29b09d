"""sdfa_tpu_torch imports neither jax, flax nor sdfa_tpu, and importing it
builds nothing. Checked in a fresh interpreter: this test process has jax
loaded by conftest."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
import sdfa_tpu_torch
names = ["sdfa_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    sdfa_tpu_torch.__path__, "sdfa_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sdfa_tpu"))
from sdfa_tpu_torch.ops import build
missing = sorted({"sdfa_tpu_torch.ops.bilstm_core", "sdfa_tpu_torch.ops.bilstm_layer",
                  "sdfa_tpu_torch.models.losses", "sdfa_tpu_torch.train.trainer",
                  "sdfa_tpu_torch.train.checkpoints", "sdfa_tpu_torch.train.lr_schedules",
                  "sdfa_tpu_torch.streaming", "sdfa_tpu_torch.serve"}
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
    assert int(n) >= 30, import_report  # every subpackage walked; streaming and serve included
    assert bad == "[]", f"sdfa_tpu_torch pulled in {bad}"


def test_import_builds_no_kernel(import_report):
    assert import_report.endswith("[]"), import_report


@pytest.mark.parametrize("module", ["streaming", "serve"])
def test_serving_module_alone_imports_without_jax(module):
    """Importing the live-serving modules on their own, as a service's
    process does, pulls in no jax, flax or sdfa_tpu either."""
    script = (f"import sys, sdfa_tpu_torch.{module}\n"
              "print(sorted(m for m in sys.modules "
              "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sdfa_tpu')))")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
