"""Filesystem helpers the API needs (counterpart of
``sdfa_tpu/utils/filesystem.py``; ``maybe_in_dirs`` copied)."""

from __future__ import annotations

import os
from typing import Iterable, Optional


def maybe_in_dirs(
    filename: Optional[str],
    must_in: bool = False,
    possible_roots: Optional[Iterable[str]] = None,
    possible_exts: Optional[Iterable[str]] = None,
) -> Optional[str]:
    """Resolve ``filename`` against candidate roots and extensions
    (reference: filesystem.py:44-83)."""
    if filename is None:
        return None
    candidates = [filename]
    if possible_roots:
        for root in possible_roots:
            candidates.append(os.path.join(root, filename))
    expanded = []
    for cand in candidates:
        expanded.append(cand)
        if possible_exts:
            for ext in possible_exts:
                if not ext.startswith("."):
                    ext = "." + ext
                expanded.append(cand + ext)
    for cand in expanded:
        if os.path.exists(cand):
            return os.path.abspath(cand)
    if must_in:
        raise FileNotFoundError(f"{filename} not found in {possible_roots}")
    return None
