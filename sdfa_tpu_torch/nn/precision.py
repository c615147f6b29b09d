"""Library matmul and convolution precision (counterpart of
``sdfa_tpu/nn/precision.py``), as far as a knob means something on a card.

The same three variables are read at import, with the same defaults:
``SDFA_MATMUL_PRECISION`` (the model's products), ``SDFA_OPS_PRECISION``
(the frontend, the solver and the dgrad extraction) and
``SDFA_CONV_PRECISION`` (convolutions; unset, it follows
``SDFA_MATMUL_PRECISION``), each ``highest``, ``high`` or ``default``.
``apply()`` sets PyTorch's process-wide flags from them; the entry points
call it through ``ops.full_float32()``.

- ``highest`` (every default): float32 products and convolutions, no TF32 —
  ``torch.set_float32_matmul_precision("highest")``,
  ``torch.backends.cudnn.allow_tf32 = False``. With the variables unset the
  numerics are the port's full-float32 ones, bit for bit.
- ``high``: TF32 on the tensor cores (``set_float32_matmul_precision("high")``,
  which sets ``torch.backends.cuda.matmul.allow_tf32``; for convolutions
  ``torch.backends.cudnn.allow_tf32``). JAX's ``high`` is bf16 in three
  passes, about 2e-6 relative; no H100 library call offers that, and TF32
  (10 mantissa bits, about 5e-4 relative a product) is coarser.
- ``default``: ``set_float32_matmul_precision("medium")``, which lets cuBLAS
  use bf16 internally (JAX's one-pass bf16); convolutions in TF32.

PyTorch has one matmul flag a process, not one per call site: it follows
``SDFA_MATMUL_PRECISION``, and the ops' library products (the frontend's DFT
and mel products, the plain solve, the dgrad extraction) follow it with the
model's. ``SDFA_OPS_PRECISION`` is read and checked, and has no effect of
its own. The hand-written kernels ignore all three: each kernel has one
design (K3's solve product is TF32 on the tensor cores whatever they say),
and its accuracy is the one ``chip_smoke.py`` holds it to.
"""

from __future__ import annotations

import os

import torch

LEVELS = ("default", "high", "highest")
_TORCH_MATMUL = {"default": "medium", "high": "high", "highest": "highest"}


def _read(name: str, default: str) -> str:
    value = (os.environ.get(name) or default).lower()
    if value not in LEVELS:
        raise ValueError(f"{name}={value!r}: expected one of {LEVELS}")
    return value


MODEL_PREC = _read("SDFA_MATMUL_PRECISION", "highest")
OPS_PREC = _read("SDFA_OPS_PRECISION", "highest")
CONV_PREC = _read("SDFA_CONV_PRECISION", MODEL_PREC)


def apply():
    """Set PyTorch's library precision flags from the three knobs."""
    torch.set_float32_matmul_precision(_TORCH_MATMUL[MODEL_PREC])
    torch.backends.cudnn.allow_tf32 = CONV_PREC != "highest"
