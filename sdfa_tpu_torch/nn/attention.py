"""Bahdanau attention (counterpart of ``sdfa_tpu/nn/attention.py``; the
Prod and Gmm variants are not ported yet).

The query is a length-(2r−1) window of the sequence, compressed to one
step by a stride-(2r−1) Conv1d; ``context = align · value``.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv1d, FullyConnected


class BahdanauAttention(nn.Module):
    """Additive attention; ``scale_score_at_eval`` multiplies the scores in
    eval mode only."""

    def __init__(self, num_units: int = 128, query_size: int = 512,
                 key_size: int = 512, query_radius: int = 1,
                 smooth: bool = False, scale_score_at_eval: float = 1.0):
        super().__init__()
        self.qry_length = 2 * int(query_radius) - 1
        self.query_size = int(query_size)
        self.smooth = bool(smooth)
        self.scale_score_at_eval = float(scale_score_at_eval)
        self.conv_query = Conv1d(query_size, query_size, kernel_size=self.qry_length,
                                 stride=self.qry_length, padding="valid", bias=False)
        self.proj_qry = FullyConnected(query_size, num_units, bias=False, init_method="glorot")
        self.proj_key = FullyConnected(key_size, num_units, bias=False, init_method="glorot")
        self.v = FullyConnected(num_units, 1, bias=False, init_method="glorot")
        self.b = nn.Parameter(torch.zeros(1, 1, num_units))

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.b.zero_()

    def forward(self, query, key, value=None):
        """query (N, 2r−1, C), key (N, T, C) → (context (N, 1, C), align (N, 1, T))."""
        if value is None:
            value = key
        if query.shape[1] != self.qry_length or query.shape[2] != self.query_size:
            raise ValueError(f"query shape {tuple(query.shape)}")
        q = self.conv_query(query.transpose(1, 2)).transpose(1, 2)  # (N, 1, C)
        score = self.v(torch.tanh(self.proj_qry(q) + self.proj_key(key) + self.b))
        score = score.transpose(1, 2)  # (N, 1, T)
        if not self.training:
            score = score * self.scale_score_at_eval
        if self.smooth:
            s = torch.sigmoid(score)
            align = s / s.sum(dim=-1, keepdim=True)
        else:
            align = torch.softmax(score, dim=-1)
        return torch.matmul(align, value), align


def create_self_atten(name: str, memory_size: int, num_units: int, query_radius: int,
                      smooth: bool = False, scale_score_at_eval: float = 1.0, **kwargs):
    """Spec factory ("attn", name, memory, units, radius, ...)."""
    if name != "bah":
        raise NotImplementedError(f"attention '{name}' is not ported yet")
    return BahdanauAttention(num_units=num_units, query_size=memory_size,
                             key_size=memory_size, query_radius=query_radius,
                             smooth=smooth, scale_score_at_eval=scale_score_at_eval)
