"""Seeded weights: every tensor of the model's state dict, PCA bases included,
drawn on the device from ``--seed`` in one call to ``torch.randn`` and cut
into leaves by name. The benchmark hands the same tensors to the program
(``load_state_dict``) and to the plain reference.

Scales keep the activations of a trained model's order: weight-norm
directions unit-free with gains near 1, recurrent and plain kernels at
1/sqrt(fan in), BatchNorm statistics near identity, the PCA bases N(0, 0.01)
as ``tools/stream_capacity_torch.py`` draws them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _shaped(name: str, shape, z: torch.Tensor) -> torch.Tensor:
    """One leaf from standard normals ``z``, scaled by what it is."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel_v":
        return z
    if leaf in ("kernel_g", "scale"):
        return torch.exp(0.1 * z)
    if leaf == "var":
        return torch.exp(0.2 * z)
    if leaf in ("bias", "mean", "b"):
        return 0.1 * z
    if leaf in ("compT", "means"):
        return 0.01 * z
    if leaf.startswith(("w_ih", "w_hh", "b_ih", "b_hh")):
        return z / math.sqrt(shape[-1] // 4)  # 1/sqrt(H): the gates are 4H wide
    if leaf == "kernel":
        if len(shape) == 2:  # (in, out)
            return z / math.sqrt(shape[0])
        return z / math.sqrt(math.prod(shape[1:]))  # (out, in, k...)
    raise KeyError(f"no seeded rule for {name}")


def seeded_state(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every (name, shape), in the
    order given, from one generator of ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = _shaped(name, tuple(shape), flat[at:at + n].view(shape)).contiguous()
        at += n
    return out
