#!/usr/bin/env bash
# Inference entry of the PyTorch/CUDA port (evaluate.sh's command with the
# port's module), on the card.
# Usage: ./evaluate_torch.sh <wav_or_mp4> [speaker] [ckpt] [dataset_root] [template_mesh] [mesh_constraints]
# The port has no default template: pass a .ply / .obj and its constrained
# vertex ids (white-space separated), else the evaluation stops before the
# model loads.
set -euo pipefail

EVAL_INPUT="${1:?usage: evaluate_torch.sh <wav> [speaker] [ckpt] [dataset_root] [template_mesh] [mesh_constraints]}"
SPEAKER="${2:-m1}"
CKPT="${3:-experiments/results/latest/last.ckpt}"
DATASET_ROOT="${4:-/tmp/synth_voca_dgrad}"
TEMPLATE=()
if [ -n "${5:-}" ]; then TEMPLATE+=(--template_mesh "$5"); fi
if [ -n "${6:-}" ]; then TEMPLATE+=(--mesh_constraints "$6"); fi

python -m sdfa_tpu_torch evaluate \
  --custom_hparams dgrad \
  --dataset_root "${DATASET_ROOT}" \
  --load_from "${CKPT}" \
  --eval_input "${EVAL_INPUT}" \
  --eval_spk_cond "${SPEAKER}" \
  --output_dir evaluate_results \
  "${TEMPLATE[@]}"
