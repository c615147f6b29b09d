"""The attention family (counterpart of ``sdfa_tpu/nn/attention.py``):
Bahdanau (additive), Prod (scaled dot product) and Gmm (Graves' mixture of
Gaussians over positions).

The query is a length-(2r−1) window of the sequence, compressed to one
step by a stride-(2r−1) Conv1d; ``context = align · value``. The subclasses
differ only in the alignment. These are library ops: in JAX they run outside
any Pallas kernel.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Conv1d, FullyConnected


class _Attention(nn.Module):
    """The shared query compression and context; ``alignment(query (N, 1, C),
    key (N, T, C)) → (N, 1, T)`` is the subclass's."""

    def __init__(self, num_units: int = 128, query_size: int = 512, key_size: int = 512,
                 query_radius: int = 1):
        super().__init__()
        self.num_units, self.query_size, self.key_size = (int(num_units), int(query_size),
                                                          int(key_size))
        self.qry_length = 2 * int(query_radius) - 1
        self.conv_query = Conv1d(query_size, query_size, kernel_size=self.qry_length,
                                 stride=self.qry_length, padding="valid", bias=False)

    def forward(self, query, key, value=None):
        """query (N, 2r−1, C), key (N, T, C) → (context (N, 1, C), align (N, 1, T))."""
        if value is None:
            value = key
        if query.shape[1] != self.qry_length or query.shape[2] != self.query_size:
            raise ValueError(f"query shape {tuple(query.shape)}")
        q = self.conv_query(query.transpose(1, 2)).transpose(1, 2)  # (N, 1, C)
        align = self.alignment(q, key)
        return torch.matmul(align, value), align

    def alignment(self, query, key):  # pragma: no cover
        raise NotImplementedError


class BahdanauAttention(_Attention):
    """Additive attention; ``scale_score_at_eval`` multiplies the scores in
    eval mode only, ``smooth`` normalises sigmoids instead of a softmax."""

    def __init__(self, num_units: int = 128, query_size: int = 512,
                 key_size: int = 512, query_radius: int = 1,
                 smooth: bool = False, scale_score_at_eval: float = 1.0):
        super().__init__(num_units, query_size, key_size, query_radius)
        self.smooth = bool(smooth)
        self.scale_score_at_eval = float(scale_score_at_eval)
        self.proj_qry = FullyConnected(query_size, num_units, bias=False, init_method="glorot")
        self.proj_key = FullyConnected(key_size, num_units, bias=False, init_method="glorot")
        self.v = FullyConnected(num_units, 1, bias=False, init_method="glorot")
        self.b = nn.Parameter(torch.zeros(1, 1, num_units))

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.b.zero_()

    def alignment(self, query, key):
        score = self.v(torch.tanh(self.proj_qry(query) + self.proj_key(key) + self.b))
        score = score.transpose(1, 2)  # (N, 1, T)
        if not self.training:
            score = score * self.scale_score_at_eval
        if self.smooth:
            s = torch.sigmoid(score)
            return s / s.sum(dim=-1, keepdim=True)
        return torch.softmax(score, dim=-1)


class ProdAttention(_Attention):
    """Scaled dot-product attention after ``num_proj_layers`` projections of
    query and key (``proj_qry_{i}`` / ``proj_key_{i}``, leaky ReLU 0.2 between
    them, glorot init)."""

    def __init__(self, num_units: int = 128, query_size: int = 512, key_size: int = 512,
                 query_radius: int = 1, num_proj_layers: int = 1):
        super().__init__(num_units, query_size, key_size, query_radius)
        self.num_proj_layers = int(num_proj_layers)
        for i in range(self.num_proj_layers):
            act = "lrelu@a:0.2" if i < self.num_proj_layers - 1 else "linear"
            for side, first in (("qry", query_size), ("key", key_size)):
                self.add_module(f"proj_{side}_{i}", FullyConnected(
                    first if i == 0 else num_units, num_units, bias=False, activation=act,
                    init_method="glorot"))

    def alignment(self, query, key):
        q, k = query, key
        for i in range(self.num_proj_layers):
            q, k = getattr(self, f"proj_qry_{i}")(q), getattr(self, f"proj_key_{i}")(k)
        score = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(self.num_units)
        return torch.softmax(score, dim=-1)


class GmmAttention(_Attention):
    """Graves' GMM attention: the compressed query through three FCs
    (``proj_0`` .. ``proj_2``) gives ``num_k`` weights, widths and centres of
    Gaussians over the key positions, scaled to [−scale_x / 2, scale_x / 2)."""

    def __init__(self, num_units: int = 128, query_size: int = 512, key_size: int = 512,
                 query_radius: int = 1, num_k: int = 4, softmax: bool = False,
                 scale_x: float = 6.0):
        super().__init__(num_units, query_size, key_size, query_radius)
        self.num_k, self.softmax, self.scale_x = int(num_k), bool(softmax), float(scale_x)
        self.proj_0 = FullyConnected(query_size, num_units, bias=False, activation="lrelu@a:0.01")
        self.proj_1 = FullyConnected(num_units, num_units, bias=False, activation="lrelu@a:0.01")
        self.proj_2 = FullyConnected(num_units, 3 * self.num_k, bias=False)

    def alignment(self, query, key):
        x = self.proj_2(self.proj_1(self.proj_0(query[:, 0, :])))
        alpha_hat, beta_hat, kappa = x.chunk(3, dim=1)
        alpha = (torch.softmax(alpha_hat, dim=1) if self.softmax
                 else torch.exp(alpha_hat) / float(self.num_k))
        beta = torch.exp(beta_hat)
        length = key.shape[1]
        pos = (torch.arange(length, dtype=torch.float32, device=key.device) / float(length)
               - 0.5) * self.scale_x
        return torch.sum(alpha[..., None] * torch.exp(-beta[..., None]
                                                      * (pos - kappa[..., None]) ** 2),
                         dim=1, keepdim=True)


def create_self_atten(name: str, memory_size: int, num_units: int, query_radius: int,
                      smooth: bool = False, scale_score_at_eval: float = 1.0, num_k=None,
                      softmax: bool = False, scale_x: float = 6.0, num_heads=None, **kwargs):
    """Spec factory ("attn", name, memory, units, radius, ...); the keys of
    ``sdfa_tpu/nn/attention.py::create_self_atten``."""
    common = dict(num_units=num_units, query_size=memory_size, key_size=memory_size,
                  query_radius=query_radius)
    if name == "bah":
        return BahdanauAttention(smooth=smooth, scale_score_at_eval=scale_score_at_eval,
                                 **common)
    if name == "gmm":
        if num_k is None:
            raise ValueError("gmm attention needs num_k")
        return GmmAttention(num_k=num_k, softmax=softmax, scale_x=scale_x, **common)
    if name == "prod":
        return ProdAttention(**common)
    raise NotImplementedError(f"attention '{name}' is not supported")
