#!/usr/bin/env python
"""A long training run of the shipped dgrad model: the PyTorch/CUDA port's
counterpart of ``tools/longrun_train.py``, with the same arguments and
defaults.

Trains ``dgrad`` for ``--steps`` optimizer steps on the synthetic dgrad
dataset (generated under ``--root`` when it has no ``train.csv``; FLAME's
counts, PCA bases fitted on it), in raw mode (features made on the card)
with PCA targets: rolling checkpoints, the loss CSV and
``train_log/metrics.jsonl`` (the shipped config's ``valid_gap_epochs`` is 0:
no validation epoch runs); the last line is a JSON object of the kernel
launches in the process. The run directory serves as a trained
checkpoint (``<run-dir>/last.ckpt``) for ``api.load_task``,
``python -m sdfa_tpu_torch evaluate`` and the examples.

Usage (from the repository root; on the card unless ``--platform cpu``):
  python tools/longrun_train_torch.py --steps 2500 --run-dir runs/longrun \
      [--root runs/longrun_assets/voca]
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_TMP = tempfile.gettempdir()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--run-dir", default=os.path.join(_TMP, "longrun_r4"))
    ap.add_argument("--root", default=os.path.join(_TMP, "longrun_assets", "voca"))
    ap.add_argument("--speakers", type=int, default=2)
    ap.add_argument("--sentences", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                    help="run on the card (default) or on the CPU")
    args = ap.parse_args(argv)

    import torch

    if args.platform == "gpu" and not torch.cuda.is_available():
        raise RuntimeError("--platform gpu: torch sees no CUDA device "
                           "(pass --platform cpu to run on the CPU)")

    from sdfa_tpu_torch import api
    from sdfa_tpu_torch.data import synthetic

    if not os.path.exists(os.path.join(args.root, "train.csv")):
        synthetic.generate(
            args.root, "dgrad_3d",
            speakers=[f"m{i}" if i % 2 == 0 else f"f{i}"
                      for i in range(args.speakers)],
            sentences_per_speaker=args.sentences,
            seconds_per_sentence=args.seconds)
    # max_epochs must not bind before --steps: the synthetic dataset at the
    # defaults yields about 10 optimizer steps an epoch, so the shipped
    # max_epochs=100 would stop a 2500-step run at step 1000. The trainer's
    # max_steps caps the whole run, so an unbounded epoch cap makes --steps
    # the stop.
    api.train_model(
        "dgrad", dataset_root=args.root, log_dir=args.run_dir,
        max_steps=args.steps,
        overrides=dict(trainer=dict(pca_targets=True,
                                    max_epochs=10 ** 6)),
        device="cuda" if args.platform == "gpu" else "cpu")
    print(f"trained {args.steps} steps -> {args.run_dir}")
    # the kernels this process launched (the wrappers count on the card only)
    from sdfa_tpu_torch.ops import bilstm2, bilstm_core, freq_lstm

    print(json.dumps({"launches": {
        "bilstm_core_fwd": bilstm_core.FWD_LAUNCHES, "bilstm_core_bwd": bilstm_core.BWD_LAUNCHES,
        "freq_lstm": freq_lstm.LAUNCHES.total(), "bilstm2": bilstm2.LAUNCHES.total()}}),
        flush=True)


if __name__ == "__main__":
    main()
