"""VOCASET conventions (counterpart of ``sdfa_tpu/data/vocaset/config.py``):
FLAME's counts, the lips vertices, the speaker alias table and the public
VOCA split.

The FLAME template is not part of this repository, so nothing here points
at one: the caller names the template (``FLAME_sample.ply`` of the VOCASET
layout), and its non-face mask is ``mask/non_face.py`` beside the template's
directory, read as data (its ``non_face_verts`` / ``non_face_tris`` literal
lists), never run.
"""

from __future__ import annotations

import ast
import os

import numpy as np

N_VERTS = 5023
N_TRIS = 9976
LIPS_UPPER_VERT = 3531
LIPS_LOWER_VERT = 3509

SPEAKER_ALIAS = dict(
    m0="FaceTalk_170728_03272_TA",
    f0="FaceTalk_170904_00128_TA",
    m1="FaceTalk_170725_00137_TA",
    m2="FaceTalk_170915_00223_TA",
    f1="FaceTalk_170811_03274_TA",
    m3="FaceTalk_170913_03279_TA",
    f2="FaceTalk_170904_03276_TA",
    f3="FaceTalk_170912_03278_TA",
    f4="FaceTalk_170811_03275_TA",
    m4="FaceTalk_170908_03277_TA",
    m5="FaceTalk_170809_00138_TA",
    f5="FaceTalk_170731_00024_TA",
)
TRAIN_SPEAKERS = ["m0", "f0", "m1", "m2", "f1", "m3", "f2", "f3"]
VALID_SPEAKERS = ["f4", "m4"]
TEST_SPEAKERS = ["m5", "f5"]


def mask_path(template_path: str) -> str:
    """``<vocaset>/mask/non_face.py`` for a template at
    ``<vocaset>/template/FLAME_sample.ply``."""
    vocaset = os.path.dirname(os.path.dirname(os.path.abspath(template_path)))
    return os.path.join(vocaset, "mask", "non_face.py")


def read_mask(path: str, name: str) -> np.ndarray:
    """The literal list assigned to ``name`` in the mask module at ``path``,
    read as data (``ast.literal_eval``), never run."""
    with open(path) as fp:
        tree = ast.parse(fp.read(), path)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return np.asarray(ast.literal_eval(node.value), np.int64)
    raise ValueError(f"{path} assigns no literal {name} list")


def non_face_masks(template_path: str):
    """(non_face_verts, non_face_tris) of the mask beside the template."""
    path = mask_path(template_path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no non-face mask at {path} (the VOCASET layout keeps "
                                "mask/non_face.py beside template/)")
    return read_mask(path, "non_face_verts"), read_mask(path, "non_face_tris")
