"""1-D bilateral smoothing of vertex sequences (counterpart of
``sdfa_tpu/utils/bilateral.py``).

Reference: saber/utils/bilateral.py:6-74 (BilateralFilter1D). For each time
step, the neighbours within ``radius`` steps (the sequence's ends repeated
past its edges) are weighted by a spatial gaussian of their offset times a
range gaussian of their mean squared distance to the centre frame. Runs in
torch in float64 on the device of its input (a numpy array runs on the
host) and returns float32: a numpy array for a numpy input, a tensor on the
input's device for a tensor.
"""

from __future__ import annotations

import numpy as np
import torch


class BilateralFilter1D:
    def __init__(self, radius: int = 3, sigma_space: float = 2.0, sigma_value: float = 0.01):
        self.radius = int(radius)
        self.sigma_space = float(sigma_space)
        self.sigma_value = float(sigma_value)
        offs = np.arange(-self.radius, self.radius + 1)
        self._space_w = np.exp(-(offs ** 2) / (2 * self.sigma_space ** 2))
        self._offs = offs

    def __call__(self, seq):
        """(T, ...) → smoothed (T, ...) float32."""
        is_tensor = torch.is_tensor(seq)
        x = (seq if is_tensor else torch.from_numpy(np.asarray(seq))).to(torch.float64)
        t = x.shape[0]
        center = x.reshape(t, -1)
        acc = torch.zeros_like(center)
        wsum = center.new_zeros(t, 1)
        steps = torch.arange(t, device=x.device)
        for k, off in enumerate(self._offs):
            neigh = center[(steps + int(off)).clamp(0, t - 1)]  # edge padding
            dist2 = ((neigh - center) ** 2).mean(dim=1, keepdim=True)
            w = float(self._space_w[k]) * torch.exp(-dist2 / (2 * self.sigma_value ** 2))
            acc += w * neigh
            wsum += w
        out = (acc / wsum.clamp_min(1e-12)).reshape(x.shape).to(torch.float32)
        return out if is_tensor else out.numpy()
