"""PyTorch/CUDA port of ``sdfa_tpu``: the wav → vertices serving path and the
training path.

Layout mirrors the JAX package so each module's counterpart is easy to
find: ``audio/`` (frontend), ``nn/`` (layers, the layer-spec engine,
recurrent layers, attention), ``models/`` (the network), ``ops/`` (the
deformation solver and the hand-written Hopper kernels with their plain
PyTorch versions), ``train/`` (``Experiment``, ``Trainer``, schedules,
checkpoints), ``parallel/`` (data parallelism on ``torch.distributed``),
``compat/`` (flax variables and reference checkpoints),
``viewer/`` (template state, mesh export, video), ``utils/`` (logging, the
bilateral filter, the plotting helpers), ``native/`` (the float64 C++
deformation runtime), ``task.py`` (``AnimationTask``), ``api.py`` and
``__main__.py`` (the entry points: ``python -m sdfa_tpu_torch``),
``visualize.py`` (dataset QA videos: ``python -m sdfa_tpu_torch.visualize``)
and ``config.py`` (the config reader). Subpackages load on first access, as
in the JAX package.

The package imports ``torch``, numpy and scipy — never ``jax``, ``flax`` or
``sdfa_tpu``; OpenCV and matplotlib only inside the video and colour-map
functions, TensorBoard only when a summary writer is built. Importing it
builds nothing: each CUDA kernel is compiled from ``csrc/`` on its first
launch on a CUDA tensor, the native runtime on its first call.
"""

_LAZY = ("api", "audio", "compat", "config", "data", "mesh", "models", "native", "nn", "ops",
         "parallel", "profiling", "serve", "streaming", "task", "tools", "train", "utils",
         "viewer", "visualize")


def __getattr__(name):
    """Subpackages and modules on first access (``sdfa_tpu_torch.visualize``),
    so that importing the package stays light."""
    if name in _LAZY:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_LAZY)
