"""Plain reference of the ``offsets`` configuration: the network of
``common.Reference``, then one PCA inversion to per-vertex offsets, added to
the template."""

from __future__ import annotations

import numpy as np
import torch

from .common import Reference, tf32_mode


class Model:
    def __init__(self, hp, state, template, device, dtype=torch.float64, tf32=False):
        self.net = Reference(hp, state, device, dtype, tf32)
        self.tf32 = tf32
        t = dict(device=torch.device(device), dtype=dtype)
        self.comp, self.means = state["pca.compT"].to(**t), state["pca.means"].to(**t)
        self.template = torch.as_tensor(np.asarray(template[0], np.float64), **t).reshape(-1)

    def decode(self, heads) -> torch.Tensor:
        """Head outputs → vertices (W, V, 3)."""
        out = heads["coef"] @ self.comp.T + self.means + self.template
        return out.reshape(len(out), -1, 3)

    def vertices(self, clip: np.ndarray, speaker: int, block: int = 1024) -> np.ndarray:
        heads = self.net.coefficients(clip, speaker)
        with tf32_mode(self.tf32), torch.no_grad():
            c = heads["coef"]
            return np.concatenate([self.decode({"coef": c[i:i + block]}).double().cpu().numpy()
                                   for i in range(0, len(c), block)])
