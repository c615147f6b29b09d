"""Task-level enums, seeding and the dataset path conventions (counterpart of
``sdfa_tpu/tools.py``, copied). ``configure`` lives in ``config.py`` and is
re-exported here under the JAX package's name.

Reference surfaces: FaceDataType / PredictionType (tools/data_type.py:4-44),
the path-convention helpers (tools/data_info.py:9-41).
"""

from __future__ import annotations

import enum
import os
import random

import numpy as np
import torch

from .config import configure

__all__ = ["FaceDataType", "PredictionType", "configure", "data_dir", "parse_data_dir",
           "seed_everything"]


class FaceDataType(enum.Enum):
    dgrad_3d = "dgrad_3d"
    blend_1d = "blend_1d"
    verts_pos_3d = "verts_pos_3d"
    verts_off_3d = "verts_off_3d"
    marks_pos_2d = "marks_pos_2d"
    marks_off_2d = "marks_off_2d"

    @classmethod
    def valid_types(cls):
        return [t.name for t in cls]

    @classmethod
    def is_mesh(cls, t) -> bool:
        name = t.name if isinstance(t, cls) else str(t)
        return name in ("dgrad_3d", "verts_pos_3d", "verts_off_3d")


class PredictionType(enum.Enum):
    pca_coeffs = "pca_coeffs"
    pca_normal = "pca_normal"
    face_data = "face_data"

    @classmethod
    def valid_types(cls):
        return [t.name for t in cls]


def seed_everything(seed: int = 1234):
    """Seed Python's, numpy's and torch's global generators (reference
    config.py:64-72). The port's own randomness takes explicit generators;
    this is for callers that draw from the global ones."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def data_dir(root: str, speaker: str, emotion: str, sent: int) -> str:
    """root/data/<speaker>/<emotion>/<sent zfill 3> (0-based sentence id)."""
    return os.path.join(root, "data", speaker, emotion, f"{int(sent):03d}")


def parse_data_dir(path: str):
    parts = os.path.normpath(path).split(os.sep)
    sent = parts[-1]
    if sent.startswith("sent"):  # legacy round-1 layout
        sent = sent[4:]
    return dict(speaker=parts[-3], emotion=parts[-2], sent=int(sent))
