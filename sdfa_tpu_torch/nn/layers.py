"""Layer zoo (counterpart of ``sdfa_tpu/nn/layers.py``): FullyConnected,
Conv1d/Conv2d and their transposes, Pool1d/Pool2d, the reshape layers
(Flatten, Permute, Transpose, Squeeze, Unsqueeze, View, Identity),
GradScaler, the residual conv stack and MultiplicativeNoise, with the pre-
and post-layer activation + BatchNorm + dropout extensions and weight norm.

Training and eval follow ``nn.Module.training``. In training BatchNorm
normalises with the batch's mean and biased variance and moves its running
statistics by ``new = (1 − momentum)·old + momentum·batch`` (the biased
variance there too, unlike ``torch.nn.BatchNorm*``). Dropout draws its keep
mask from an explicit ``torch.Generator`` (``set_dropout_generator``), so a
caller that seeds it per step gets the same masks again.

Layouts follow the JAX package: FC kernels (in, out), conv kernels
(O, I, kh, kw); parameter names match the flax tree (``kernel_v``,
``kernel_g``, ``bias``, ``post_bn.scale``, ...) so weights bridge by name.
Weight norm keeps (v, g) as parameters and forms v / ‖v‖ · g in forward.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import Mesh, all_reduce_sum, draw_rows
from . import functions as fn


def _pair(x) -> Tuple[int, int]:
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Bernoulli keep-mask with probability 1 − rate, kept values scaled by
    1 / keep. ``gen`` must live on ``x``'s device. Under a data-parallel
    ``mesh`` the mask is drawn for the global batch and this rank keeps its
    rows (``parallel.mesh.draw_rows``)."""
    if gen is None:
        raise RuntimeError("dropout needs a generator: call set_dropout_generator(model, gen)")
    keep = 1.0 - float(rate)
    u = draw_rows(lambda shape: torch.rand(shape, generator=gen, device=x.device, dtype=x.dtype),
                  x.shape, mesh)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, gen: Optional[torch.Generator]):
    """Hand ``gen`` to every module of ``model`` that draws dropout masks."""
    for module in model.modules():
        if hasattr(module, "dropout_generator"):
            module.dropout_generator = gen


def set_data_mesh(model: nn.Module, mesh: Optional[Mesh]):
    """Hand a data-parallel ``mesh`` (None: one process) to every module of
    ``model`` whose training step depends on the global batch: BatchNorm's
    statistics and the random draws."""
    for module in model.modules():
        if hasattr(module, "data_mesh"):
            module.data_mesh = mesh


class BatchNorm(nn.Module):
    """BatchNorm over ``axis`` with flax's parameter names. ``momentum`` is
    the weight of the new batch in the running statistics (torch's sense)."""

    def __init__(self, num_features: int, eps: float, axis: int, momentum: float = 0.1):
        super().__init__()
        self.eps, self.axis = float(eps), axis
        self.decay = 1.0 - float(momentum)
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        self.data_mesh: Optional[Mesh] = None  # see set_data_mesh

    def forward(self, x):
        shape = [1] * x.ndim
        shape[self.axis] = -1
        mean, var = self.mean, self.var
        if self.training:
            axes = [a for a in range(x.ndim) if a != self.axis % x.ndim]
            if self.data_mesh is not None and self.data_mesh.parallel:
                mean, ex2 = self._global_moments(x, axes)
            else:
                mean, ex2 = x.mean(dim=axes), (x * x).mean(dim=axes)
            # E[x²] − E[x]², clamped at 0: the JAX package's (flax's) form
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.decay).add_((1 - self.decay) * mean)
                self.var.mul_(self.decay).add_((1 - self.decay) * var)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)

    def _global_moments(self, x, axes):
        """E[x] and E[x²] over every rank's rows: the local Σx, Σx² and element
        count in one autograd-aware all-reduce, so that the gradient of the
        global statistics reaches every rank's inputs. The count is exact in
        float32 up to 2^24 elements a channel."""
        c = x.shape[self.axis]
        count = x.new_full((1,), x.numel() // c)
        sums = all_reduce_sum(torch.cat([x.sum(dim=axes), (x * x).sum(dim=axes), count]),
                              self.data_mesh)
        return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)


class _Ext(nn.Module):
    """Pre- and post-layer extensions: an activation, BatchNorm (``prev_bn``
    over the input's channels, ``post_bn`` over the output's; ``*bn_first``
    puts it before the activation) and dropout (in training, or always with
    ``*drop_always``), the masks drawn from the layer's dropout generator."""

    bn_axis = -1

    def _init_ext(self, in_channels: int, out_channels: int, activation=None, batch_norm=None,
                  bn_first: bool = False, dropout=None, drop_always: bool = False,
                  prev_activation=None, prev_batch_norm=None, prev_bn_first: bool = False,
                  prev_dropout=None, prev_drop_always: bool = False):
        self._act = fn.parse_activation(activation)
        self._prev_act = fn.parse_activation(prev_activation)
        self.bn_first, self.prev_bn_first = bool(bn_first), bool(prev_bn_first)
        self.drop_rate, self.drop_always = float(dropout or 0.0), bool(drop_always)
        self.prev_drop_rate = float(prev_dropout or 0.0)
        self.prev_drop_always = bool(prev_drop_always)
        self.dropout_generator: Optional[torch.Generator] = None
        self.data_mesh: Optional[Mesh] = None  # see set_data_mesh
        self.prev_bn = self._make_bn(prev_batch_norm, in_channels)
        self.post_bn = self._make_bn(batch_norm, out_channels)

    def _make_bn(self, cfg, features: int) -> Optional[BatchNorm]:
        if cfg is None:
            return None
        cfg = dict(cfg)
        return BatchNorm(features, float(cfg.get("eps", 1e-5)), self.bn_axis,
                         momentum=float(cfg.get("momentum", 0.1)))

    def _extend(self, x, act, bn, bn_first: bool, rate: float, always: bool):
        if bn is not None and bn_first:
            x = act(bn(x))
        else:
            x = act(x)
            if bn is not None:
                x = bn(x)
        if rate and (self.training or always):
            x = dropout(x, rate, self.dropout_generator, self.data_mesh)
        return x

    def ext_prev(self, x):
        return self._extend(x, self._prev_act, self.prev_bn, self.prev_bn_first,
                            self.prev_drop_rate, self.prev_drop_always)

    def ext_post(self, x):
        return self._extend(x, self._act, self.post_bn, self.bn_first, self.drop_rate,
                            self.drop_always)


class _Weighted(_Ext):
    """A kernel parameter, optionally weight-normed over ``norm_axes``."""

    def _init_weight(self, shape, fan_in: int, fan_out: int, weight_norm: bool,
                     norm_axes: Sequence[int], init_method: str,
                     init_nonlinearity: Optional[str]):
        self.weight_norm = bool(weight_norm)
        self.norm_axes = tuple(norm_axes)
        self._fans = (fan_in, fan_out)
        self._init = (init_method, init_nonlinearity)
        if self.weight_norm:
            self.kernel_v = nn.Parameter(torch.empty(shape))
            g_shape = [shape[a] for a in range(len(shape)) if a not in self.norm_axes]
            self.kernel_g = nn.Parameter(torch.empty(g_shape))
        else:
            self.kernel = nn.Parameter(torch.empty(shape))

    def weight(self) -> torch.Tensor:
        if not self.weight_norm:
            return self.kernel
        v = self.kernel_v
        norm = torch.sqrt(torch.sum(v * v, dim=self.norm_axes, keepdim=True))
        g = self.kernel_g.view([1 if a in self.norm_axes else v.shape[a]
                                for a in range(v.ndim)])
        return v / torch.clamp(norm, min=1e-12) * g

    def reset_parameters(self, gen: torch.Generator):
        fan_in, fan_out = self._fans
        method, nonlin = self._init
        v = self.kernel_v if self.weight_norm else self.kernel
        with torch.no_grad():
            if method == "glorot":
                w = torch.randn(v.shape, generator=gen) * math.sqrt(2.0 / (fan_in + fan_out))
            elif method == "default":
                bound = math.sqrt(1.0 / fan_in)
                w = torch.rand(v.shape, generator=gen) * (2 * bound) - bound
            else:
                gain = fn.activation_gain(nonlin or "leaky_relu@a:0")
                w = torch.randn(v.shape, generator=gen) * (gain / math.sqrt(fan_in))
            v.copy_(w)
            if self.weight_norm:
                self.kernel_g.copy_(torch.sqrt(torch.sum(w * w, dim=self.norm_axes)))
            if getattr(self, "bias", None) is not None:
                self.bias.zero_()


class FullyConnected(_Weighted):
    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 init_method: str = "kaiming", init_nonlinearity: Optional[str] = None,
                 weight_norm: bool = False, **ext):
        super().__init__()
        self.in_channels, self.out_channels = int(in_channels), int(out_channels)
        self._init_weight((self.in_channels, self.out_channels), self.in_channels,
                          self.out_channels, weight_norm, (0,), init_method,
                          init_nonlinearity)
        self.bias = nn.Parameter(torch.zeros(self.out_channels)) if bias else None
        self._init_ext(self.in_channels, self.out_channels, **ext)

    def forward(self, x):
        shape = x.shape
        x = torch.matmul(self.ext_prev(x.reshape(-1, shape[-1])), self.weight())
        if self.bias is not None:
            x = x + self.bias
        return self.ext_post(x).reshape(shape[:-1] + (self.out_channels,))


class Conv1d(_Weighted):
    bn_axis = 1

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, padding: Any = "same", dilation: int = 1,
                 groups: int = 1, bias: bool = True, init_method: str = "kaiming",
                 init_nonlinearity: Optional[str] = None, weight_norm: bool = False,
                 **ext):
        super().__init__()
        k = int(kernel_size)
        self.k, self.stride, self.dilation = k, int(stride), int(dilation)
        self.padding, self.groups = padding, int(groups)
        self._init_weight((out_channels, in_channels // groups, k),
                          in_channels // groups * k, out_channels * k // groups,
                          weight_norm, (1, 2), init_method, init_nonlinearity)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self._init_ext(in_channels, out_channels, **ext)

    def forward(self, x):  # (B, C, T)
        x = self.ext_prev(x)
        if isinstance(self.padding, str):
            lo, hi = fn.get_pad_tuple(x.shape[-1], self.k, self.stride, self.dilation,
                                      self.padding)
        else:
            lo = hi = int(self.padding)
        x = F.pad(x, (lo, hi))
        out = F.conv1d(x, self.weight(), self.bias, stride=self.stride,
                       dilation=self.dilation, groups=self.groups)
        return self.ext_post(out)


class Conv2d(_Weighted):
    bn_axis = 1

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Any = 1,
                 stride: Any = 1, padding: Any = "same", dilation: Any = 1,
                 groups: int = 1, bias: bool = True, init_method: str = "kaiming",
                 init_nonlinearity: Optional[str] = None, weight_norm: bool = False,
                 **ext):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.k, self.stride, self.dilation = (kh, kw), _pair(stride), _pair(dilation)
        self.padding, self.groups = padding, int(groups)
        self._init_weight((out_channels, in_channels // groups, kh, kw),
                          in_channels // groups * kh * kw,
                          out_channels * kh * kw // groups,
                          weight_norm, (1, 2, 3), init_method, init_nonlinearity)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self._init_ext(in_channels, out_channels, **ext)

    def forward(self, x):  # (B, C, H, W)
        x = self.ext_prev(x)
        (kh, kw), (sh, sw), (dh, dw) = self.k, self.stride, self.dilation
        if isinstance(self.padding, str):
            pw = fn.get_pad_tuple(x.shape[-1], kw, sw, dw, self.padding)
            ph = fn.get_pad_tuple(x.shape[-2], kh, sh, dh, self.padding)
        else:
            p0, p1 = _pair(self.padding)
            ph, pw = (p0, p0), (p1, p1)
        x = F.pad(x, pw + ph)
        out = F.conv2d(x, self.weight(), self.bias, stride=(sh, sw),
                       dilation=(dh, dw), groups=self.groups)
        return self.ext_post(out)


class _ConvTranspose(_Weighted):
    """Shared by the transposed convs: kernel (in, out / groups, *k), the
    torch ConvTranspose of the JAX package's lhs-dilated conv (which takes no
    feature groups), ``output_padding`` extra zero outputs on the high side
    of every spatial axis, and with ``want_size`` and a string padding the
    "same" cropping to the wanted size."""

    bn_axis = 1

    def __init__(self, nd: int, in_channels: int, out_channels: int, kernel_size: Any = 1,
                 stride: Any = 1, padding: Any = "same", output_padding: int = 0,
                 dilation: Any = 1, groups: int = 1, bias: bool = True, want_size=None,
                 init_method: str = "kaiming", init_nonlinearity: Optional[str] = None,
                 weight_norm: bool = False, **ext):
        super().__init__()
        tup = (lambda v: (int(v),)) if nd == 1 else (lambda v: tuple(map(int, _pair(v))))
        self.k, self.stride, self.dilation = tup(kernel_size), tup(stride), tup(dilation)
        self.padding, self.output_padding, self.want_size = padding, int(output_padding), want_size
        area = math.prod(self.k)
        self._init_weight((in_channels, out_channels // groups) + self.k,
                          in_channels * area // groups, out_channels * area // groups,
                          weight_norm, tuple(range(1, 2 + nd)), init_method, init_nonlinearity)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self._init_ext(in_channels, out_channels, **ext)

    def forward(self, x):
        x = self.ext_prev(x)
        nd = len(self.k)
        conv = F.conv_transpose1d if nd == 1 else F.conv_transpose2d
        out = conv(x, self.weight(), stride=self.stride, dilation=self.dilation)
        if self.output_padding:
            out = F.pad(out, (0, self.output_padding) * nd)
        if self.bias is not None:
            out = out + self.bias.view((1, -1) + (1,) * nd)
        if self.want_size is not None and isinstance(self.padding, str):
            want = self.want_size
            want = ((want[0] if isinstance(want, (list, tuple)) else want,) if nd == 1
                    else tuple(want))
            for axis, (size, k, s, d) in enumerate(zip(want, self.k, self.stride,
                                                       self.dilation)):
                lo, hi = fn.get_pad_tuple(size, k, s, d, self.padding)
                dim = out.ndim - nd + axis
                index = [slice(None)] * out.ndim
                index[dim] = slice(lo, out.shape[dim] - hi)
                out = out[tuple(index)]
        return self.ext_post(out)


class ConvTranspose1d(_ConvTranspose):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1, **kwargs):
        super().__init__(1, in_channels, out_channels, kernel_size, **kwargs)


class ConvTranspose2d(_ConvTranspose):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: Any = 1, **kwargs):
        super().__init__(2, in_channels, out_channels, kernel_size, **kwargs)


class Pool1d(nn.Module):
    """Max/avg pool over the last axis after explicit zero "same" padding
    (a negative pad crops, as ``F.pad`` does)."""

    def __init__(self, mode: str = "max", kernel_size: int = 2, stride: Optional[int] = None,
                 padding: Any = "same"):
        super().__init__()
        self.mode, self.padding = mode, padding
        self.k = int(kernel_size)
        self.stride = int(stride or kernel_size)

    def forward(self, x):
        if isinstance(self.padding, str):
            lo, hi = fn.get_pad_tuple(x.shape[-1], self.k, self.stride, 1, self.padding)
        else:
            lo = hi = int(self.padding)
        x = F.pad(x, (lo, hi))
        if self.mode == "max":
            return F.max_pool1d(x, self.k, self.stride)
        return F.avg_pool1d(x, self.k, self.stride)


class Pool2d(nn.Module):
    """Max/avg pool after explicit zero "same" padding (as the reference)."""

    def __init__(self, mode: str = "max", kernel_size: Any = 2,
                 stride: Optional[Any] = None, padding: Any = "same"):
        super().__init__()
        self.mode, self.padding = mode, padding
        self.k = _pair(kernel_size)
        self.stride = _pair(stride or kernel_size)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.k, self.stride
        if isinstance(self.padding, str):
            ph = fn.get_pad_tuple(x.shape[-2], kh, sh, 1, self.padding)
            pw = fn.get_pad_tuple(x.shape[-1], kw, sw, 1, self.padding)
        else:
            p0, p1 = _pair(self.padding)
            ph, pw = (p0, p0), (p1, p1)
        x = F.pad(x, pw + ph)
        if self.mode == "max":
            return F.max_pool2d(x, (kh, kw), (sh, sw))
        return F.avg_pool2d(x, (kh, kw), (sh, sw))


class Permute(nn.Module):
    def __init__(self, dims: Sequence[int] = ()):
        super().__init__()
        self.dims = tuple(dims)

    def forward(self, x):
        return x.permute(self.dims)


class Squeeze(nn.Module):
    def __init__(self, dim: int = 0):
        super().__init__()
        self.dim = int(dim)

    def forward(self, x):
        return x.squeeze(self.dim)


class Flatten(nn.Module):
    def __init__(self, start_dim: int = 1):
        super().__init__()
        self.start_dim = int(start_dim)

    def forward(self, x):
        return x.reshape(x.shape[:self.start_dim] + (-1,))


class Transpose(nn.Module):
    def __init__(self, dim0: int = 0, dim1: int = 1):
        super().__init__()
        self.dim0, self.dim1 = int(dim0), int(dim1)

    def forward(self, x):
        return x.transpose(self.dim0, self.dim1)


class Unsqueeze(nn.Module):
    def __init__(self, dim: int = 0):
        super().__init__()
        self.dim = int(dim)

    def forward(self, x):
        return x.unsqueeze(self.dim)


class View(nn.Module):
    def __init__(self, shape: Sequence[int] = ()):
        super().__init__()
        self.shape = tuple(shape)

    def forward(self, x):
        return x.reshape(self.shape)


class Identity(nn.Module):
    def forward(self, x):
        return x


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


class GradScaler(nn.Module):
    """Identity forward, the gradient times ``scale`` in backward."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = float(scale)

    def forward(self, x):
        return _ScaleGrad.apply(x, self.scale)


class Residual1d(nn.Module):
    """Pre-activation residual conv block: relu → conv1 (k 3, BatchNorm then
    relu) → conv2 (k 3, BatchNorm), plus the input through a 1×1 ``shortcut``
    where the widths differ."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 batch_norm=None, weight_norm: bool = False):
        super().__init__()
        self.conv1 = Conv1d(in_channels, out_channels, kernel_size=3, stride=stride, bias=False,
                            batch_norm=batch_norm, bn_first=True, activation="relu",
                            weight_norm=weight_norm)
        self.conv2 = Conv1d(out_channels, out_channels, kernel_size=3, bias=False,
                            batch_norm=batch_norm, weight_norm=weight_norm)
        self.shortcut = (Conv1d(in_channels, out_channels, kernel_size=1, bias=False,
                                weight_norm=weight_norm)
                         if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv2(self.conv1(torch.relu(x)))
        return h + (x if self.shortcut is None else self.shortcut(x))


class ResidualStack1d(nn.Module):
    """``num_blocks`` residual blocks (``block_{i}``), then ``last_activation``."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int = 1,
                 batch_norm=None, weight_norm: bool = False,
                 last_activation: Optional[str] = "relu"):
        super().__init__()
        self.num_blocks = int(num_blocks)
        for i in range(self.num_blocks):
            self.add_module(f"block_{i}", Residual1d(in_channels if i == 0 else out_channels,
                                                     out_channels, batch_norm=batch_norm,
                                                     weight_norm=weight_norm))
        self._act = fn.parse_activation(last_activation)

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x)
        return self._act(x)


class MultiplicativeNoise(nn.Module):
    """x · base^N(mean, std) in training (identity in eval), one draw per
    (batch, channel) from the layer's dropout generator; the second half of
    the batch (the adjacent frames) reuses the first half's noise. Under a
    data-parallel mesh the draw is the global batch's, halves tied, and this
    rank keeps its rows: each of its pairs gets the global draw of that pair."""

    def __init__(self, base: float = 1.4, mean: float = 0.0, std: float = 1.0):
        super().__init__()
        self.base, self.mean, self.std = float(base), float(mean), float(std)
        self.dropout_generator: Optional[torch.Generator] = None
        self.data_mesh: Optional[Mesh] = None  # see set_data_mesh

    def forward(self, x):
        if not self.training:
            return x
        if self.dropout_generator is None:
            raise RuntimeError("MultiplicativeNoise needs a generator: call "
                               "set_dropout_generator(model, gen)")

        def draw(shape):
            noise = self.mean + self.std * torch.randn(shape, generator=self.dropout_generator,
                                                       device=x.device, dtype=x.dtype)
            if shape[0] > 1:
                half = shape[0] // 2
                noise = torch.cat([noise[:half], noise[:half]])
            return noise

        noise = draw_rows(draw, (x.shape[0], x.shape[1]) + (1,) * (x.ndim - 2), self.data_mesh)
        return x * torch.pow(self.base, noise)
