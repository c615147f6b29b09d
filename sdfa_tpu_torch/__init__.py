"""PyTorch/CUDA port of ``sdfa_tpu``: the wav → vertices serving path and the
training path.

Layout mirrors the JAX package so each module's counterpart is easy to
find: ``audio/`` (frontend), ``nn/`` (layers, the layer-spec engine,
recurrent layers, attention), ``models/`` (the network), ``ops/`` (the
deformation solver and the hand-written Hopper kernels with their plain
PyTorch versions), ``train/`` (``Experiment``, ``Trainer``, schedules,
checkpoints), ``parallel/`` (data parallelism on ``torch.distributed``),
``compat/`` (flax variables and reference checkpoints),
``viewer/`` (template state, mesh export, video), ``task.py``
(``AnimationTask``), ``api.py`` and ``__main__.py`` (the entry points:
``python -m sdfa_tpu_torch``) and ``config.py`` (the config reader).

The package imports ``torch``, numpy and scipy — never ``jax``, ``flax`` or
``sdfa_tpu``; OpenCV and matplotlib only inside the video and colour-map
functions. Importing it builds nothing: each CUDA kernel is compiled from
``csrc/`` on its first launch on a CUDA tensor.
"""
