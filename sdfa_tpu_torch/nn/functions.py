"""NN functional helpers (counterpart of ``sdfa_tpu/nn/functions.py``):
activation parsing with the ``lrelu@a:0.2`` syntax, TF-style left-heavy
"same" padding, torch-gain init, one-hot."""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def _analyze_activation(name: Optional[str]) -> Tuple[Optional[str], float]:
    """``"lrelu@a:0.2"`` → ("leaky_relu", 0.2); plain names → (name, 0.0)."""
    if name is None or name == "linear":
        return None, 0.0
    if "@" in name:
        base, _, arg = name.partition("@")
        _, _, val = arg.partition(":")
        return {"lrelu": "leaky_relu"}.get(base, base), float(val)
    return {"lrelu": "leaky_relu"}.get(name, name), 0.0


def parse_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    base, arg = _analyze_activation(name)
    if base is None:
        return lambda x: x
    if base == "relu":
        return F.relu
    if base == "sigmoid":
        return torch.sigmoid
    if base == "softmax":
        return lambda x: torch.softmax(x, dim=-1)
    if base == "tanh":
        return torch.tanh
    if base == "softplus":
        return F.softplus
    if base == "leaky_relu":
        slope = arg if arg else 0.01
        return lambda x: F.leaky_relu(x, negative_slope=slope)
    if base == "glu":
        dim = int(arg)
        return lambda x: F.glu(x, dim=dim)
    raise ValueError(f"unsupported activation: {name}")


def activation_gain(name: Optional[str]) -> float:
    """torch.nn.init.calculate_gain for the activation names above."""
    base, arg = _analyze_activation(name)
    if base == "tanh":
        return 5.0 / 3.0
    if base == "relu":
        return math.sqrt(2.0)
    if base == "leaky_relu":
        slope = arg if arg else 0.01
        return math.sqrt(2.0 / (1.0 + slope * slope))
    return 1.0


def get_pad_tuple(size: int, kernel_size: int, stride: int, dilation: int, padding: str):
    """TF-style padding, left-heavy for "same" (left = padlr − padlr//2).
    padlr goes negative when stride > 1 and size is not a stride multiple;
    ``F.pad`` then crops, as in the reference."""
    padlr = (size // stride - 1) * stride + dilation * (kernel_size - 1) + 1 - size
    if padding == "same":
        right = padlr // 2
        return (padlr - right, right)
    if padding == "causal":
        return (padlr, 0)
    if padding == "valid":
        return (0, 0)
    raise ValueError(f"unknown padding mode: {padding}")


def one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    return F.one_hot(ids.long(), n).to(torch.float32)
