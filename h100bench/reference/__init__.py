"""Plain references, one module per configuration (``<config>.py``, with a
``Model(hp, state, template, device, dtype, tf32)`` class), sharing
``common.py``. Nothing here imports the program or JAX."""

import importlib


def model_class(config: str):
    return importlib.import_module(f"{__name__}.{config}").Model
