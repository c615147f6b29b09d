"""The VOCASET preprocessing pipeline (counterpart of ``sdfa_tpu/data/vocaset``):
its conventions (``config``) and the pipeline that turns a download into
the dataset and PCA bases that training reads (``preload``)."""

from . import config, preload

__all__ = ["config", "preload"]
