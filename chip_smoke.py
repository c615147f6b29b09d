#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sdfa_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py            # about ten minutes (640 s on an NVIDIA H100 80GB HBM3,
                                     # 700 W, with the stream_capacity, longrun and examples
                                     # phases; 297 s before them)
    python3 chip_smoke.py --profile  # a minute or two more. Also torch.profiler breakdowns: a
                                     # request (with its host-to-device copies counted), a
                                     # server tick,
                                     # both also for the offsets model,
                                     # a train step; the biLSTM step kernel's SM clocks by part
                                     # of a step; the other tile choices of the training core,
                                     # of FreqLstm's step loop and of the solve product; K3's
                                     # full body with its sums promoted every 16, 8, 4 k tiles
    python3 chip_smoke.py --cards 4  # on a machine with 4 cards, only this: data_parallel's
                                     # comparison on NCCL, a rank a card, at 2 and 4 ranks
    python3 chip_smoke.py --k3-turns PARENT . . PARENT  # K3's timed rows with the package of
                                     # each checkout in turn (PARENT: another commit unpacked
                                     # by git archive), a process each: two commits on one card
    python3 chip_smoke.py --proj-turns PARENT . . PARENT  # the same for the input projection's
                                     # rows (proj_kernel at each instantiation)
    python3 chip_smoke.py --outproj-turns PARENT . . PARENT  # the same for K1's output
                                     # projection's rows (out_parts_kernel + out_sum_kernel)
    python3 chip_smoke.py --wide-turns PARENT . . PARENT  # the same for the wide step loop's
                                     # rows (wide_steps_kernel, wide_bwd_kernel: K1, K2, K4,
                                     # K5 from H = 384), with each row's drift from float64
    python3 chip_smoke.py --longrun 2500  # the longrun phase alone at that many steps

Phases, each printed as one JSON line:

1. device: the card's name and power limit, torch / CUDA / nvcc versions.
2. build: compiles the five CUDA sources of ``sdfa_tpu_torch/csrc`` side by side
   and prints what ptxas says of each kernel (registers, shared memory, spills),
   how many clusters the card holds at once of the biLSTM step kernel, of
   FreqLstm's and of the training core's forward and backward kernels at each
   hidden width, the wide step loop's tiling for each of its kernels at H =
   384, 512 and 1024 (units a block U, rows a block R, blocks and rows one
   cooperative launch takes), how many
   blocks of the solve product, of the input projection ``proj_kernel`` and of K1's
   output projection ``out_parts_kernel`` the card holds, ptxas' registers and
   spills of the two projections' kernels, and the
   tensor-core opcodes (``HGMMA``) in the machine code of ``decode_solve``,
   ``bilstm_layer``, ``bilstm2`` and ``freq_lstm``.
3. kernels: runs each kernel at its path's shapes, holds it against its plain
   PyTorch version on the same inputs, times both with CUDA events, computes
   the card's bound for the same work (the recurrent kernels' input projection
   and K1's output projection at the TF32 rate in three passes, the rest of
   their work at the f32 rate;
   ``f32_bound_ms`` all at the f32 rate), and times the one library call that
   computes the same function where there is one (``torch.nn.LSTM`` through
   cuDNN for the recurrences), as a yardstick that no path uses. ``freq_lstm``
   and ``decode_solve`` are timed at a request's own shape as well (768 rows,
   216 windows), ``freq_lstm`` and ``bilstm2`` at ``Experiment.plot_forward``'s on
   a 100-window batch (6400 rows, 100 windows), ``bilstm_layer`` at H = 128 at the
   ``spec_variants`` phase's shapes and ``bilstm2`` at H = 128 at 256 windows, and the
   recurrent kernels at the ``wide_variants`` phase's widths (``WIDE_K1``, ``WIDE_K2``,
   ``WIDE_K4``, ``WIDE_K5``: the wide step loop from H = 384 on, K1 at H = 256 and other
   output widths, K4 with a 1024-wide input and at H = 1024, K5 at 6400 rows and H =
   512), each wide row also split by kernel under ``torch.profiler`` (the step loop
   apart from the input projection ``proj_kernel`` and K1's output projection).
   The two projections (3xTF32 on the tensor cores) have rows of their own: the
   input projection at every instantiation (``proj_row_specs``), K1's output
   projection at every K1 shape (``outproj_row_specs``), each its device ms from
   the split beside its bound, cuBLAS's f32 product and its plain walk, and
   launched alone against the plain walk and a float64 product (<= 1e-5 of the
   largest value), the output projection also twice for the same bits.
   ``decode_solve_full``, K3's full body (the TPU ``_kernel``), runs on the
   ``retarget`` phase's correspondence table at 216, 128 and 512 windows and on
   the identity table at 256, split into decode, product and sum by kernel name,
   its bound by the folded reckoning (the decode per triangle, 3xTF32 over 3T')
   and by the per-equation design's over the equations, with the f32 cuBLAS product over the
   equations and over the folded triangles as its yardsticks and both it and
   its plain version held to a float64 decode + product (<= 5e-7 m). The delta
   body's library column is its product alone as one TF32 ``torch.matmul``.
   Every kernel is also held
   to its plain version, untimed, at
   ragged shapes that reach every edge of its tiling; ``freq_lstm``,
   ``decode_solve``, ``decode_solve_full`` and ``bilstm_core``'s backward must
   give the same bits twice.
4. serve: the flagship ``dgrad`` config at full width (seeded weights, seeded
   PCA bases at the shipped dims, a synthetic template with FLAME's 5023
   vertices / 9976 triangles / 1261 free vertices) serves three 3 s requests
   through ``AnimationTask.generate_vertices``; the launch counters of
   ``freq_lstm``, ``bilstm2`` and ``decode_solve`` must move.
5. check: one request again through the plain versions on the card, and
   sampled frames against the float64 host solve.
6. wires: the first request again on every wire (f32, i16, i8d, coef): error to
   the f32 wire (coef: to the float64 solve), bytes downloaded, wall time, the
   launch counters (``decode_solve`` must stay put on coef); an ensembled
   request against the mean of its two runs; a request with every kept
   constant dropped against the warm one, bit for bit.
7. session: one ``StreamingSession`` fed the clip in uneven chunks, then
   flushed, against the offline request.
8. server: ``StreamingServer(capacity=8)`` with 8 streams of different lengths
   and speakers on i16, i8d, coef and i16 pipelined, each stream against its
   own offline request; tick time, frames a second, bytes a frame. One run at
   capacity 32 for its tick time.
9. tcp: ``ServeApp`` + ``StreamServerTCP`` on 127.0.0.1, four ``StreamClient``
   threads, one of them on a coef service with a ``CoefDecoder``.
10. k4_path: the same config with a 1-layer time LSTM serves a 1 s request; the
   ``bilstm_layer`` counter must move and the plain versions must agree.
11. train: ``Trainer.train()`` takes 5 steps of 100 windows at full width with
   the shipped optimizer and loss sections; every loss term and the gradient
   norm must be finite, the ``bilstm_core`` forward and backward counters must
   each read 15, parameters must change, the checkpoint must load back equal,
   and one step through the plain versions from the same state and dropout
   seed must give the same loss and gradients.
12. data_train: ``synthetic.generate`` writes a dataset (2 speakers x 1
   sentence x 2 s at FLAME's counts, PCA bases fitted on it);
   ``api.train_model`` trains 30 steps on it in raw mode (the reader on a
   prefetch thread, the features made on the card), and the ``bilstm_core``
   counters must read 90 and 90, every epoch loss be finite and ``last.ckpt``
   exist; the median interval between step dispatches and the share of wall
   time the ``Trainer`` waited on its loader are printed. Then the device
   frontend on one training batch against the host features with the same
   knobs, 2 steps on host features, two ``PrefetchLoader`` batches from
   forkserver workers in this CUDA process, and the trained checkpoint served
   with the dataset's bases: a 3 s request against the float64 solve and the
   plain versions, the same request through the host frontend
   (``device_frontend=False``), and fault C4: K3 at the dataset's own
   projected coefficients (every frame of one sentence) against its plain
   version and the float64 decode + solve. The loader's forkserver and
   resource tracker are stopped before the phase ends.
13. offsets: the shipped ``offsets`` config (``verts_off_3d``) at full width, seeded
   weights and seeded PCA bases at 15069 x 59, over the same template: three 3 s
   requests, each with ``freq_lstm`` / ``bilstm2`` / ``decode_solve`` launched 1 / 1 /
   0 times, against the plain versions and against a float64 host decode of the
   card's own coefficients; the first request on i16 and i8d against f32, the coef
   wire refused; one ``StreamingSession`` against the offline request
   (``offsets_session`` line); ``StreamingServer(capacity=8)`` on i16, each stream
   against its own offline request (``offsets_server`` line). ``decode_solve`` must
   stay at 0 throughout.
14. offsets_train: ``synthetic.generate`` of a ``verts_off_3d`` dataset at the
   ``data_train`` size (PCA fitted on it, 59 components); ``api.train_model("offsets")``
   for 30 raw-mode steps with PCA targets (``bilstm_core`` 90 and 90, K1 / K2 / K3 0,
   the epoch position loss falling); the trained checkpoint serving a 3 s request
   against the float64 host decode and the plain versions.
15. cli: ``python -m sdfa_tpu_torch`` on the ``data_train`` phase's dataset and
   checkpoint. ``train`` in process for 16 steps with ``--profile_dir`` (K5 48 / 48,
   ``last.ckpt``, one trace file of steps 10-14 that names the training core's
   kernels); ``trace`` in process, then the same 3 s request through
   ``load_traced``, ``load_task`` and the trained task in memory (K1 / K2 / K3 1 / 1
   / 1 each, within 1e-7 m of each other; ``load_task``'s through the plain
   versions too, within 1e-5 m); ``evaluate`` as a subprocess (``evaluate.sh``'s
   command with the port's module) on a 1 s wav over the template written to a
   ``.ply``, its meshes within 1e-5 m of the same evaluation in process through
   the plain versions and within 1e-4 m of the float64 solve of its own frames;
   ``serve`` as a subprocess answering one ``StreamClient`` within the i16 wire's
   5.1e-6 m of the offline request, then terminated and reaped. Both subprocesses
   start first, so that their start-up overlaps the in-process modes. Wall
   seconds by mode.

16. preprocess: ``python -m sdfa_tpu_torch preprocess --pitch_variants`` as a
   subprocess on a raw tree in VOCASET's layout (6 sentences of 2 s at 22050 Hz
   with a quiet head, two of them in the trim tables; 60 fps meshes of the
   synthetic template, its non-face mask beside it as data), the seconds of each
   stage; every dgrad file against the numpy float64 extraction (<= 1e-6), the
   fitted components against a float64 numpy SVD with sklearn's sign rule (<=
   1e-5, equal counts; the covariance route too, on the card, at the offsets'
   15069 columns), four frames solved back to the template plus the smoothed
   offsets (<= 1e-4 m); ``api.train_model`` for 8 raw-mode steps with
   ``random_pitch_shift`` and the PCA heads at the fitted counts (K5 3 / 3 a
   step); one 3 s request from the checkpoint (K1 / K2 / K3 1 / 1 / 1) within
   1e-5 m of the plain versions and 1e-4 m of the float64 host decode + solve.
17. retarget: the serve phase's model over the synthetic template with triangle
   correspondences (two sources on every even triangle, none on every fifth):
   the float64 solver build; one 3 s request on f32 / i16 / i8d (K1 / K2 1 / 1
   each, K3's full body 1 and its delta body 0) against ``solve_host`` of its
   decoded dgrads; a session (the full body); a capacity-8 server on coef with
   ``CoefDecoder`` (<= 1e-6 m to float64, K3 0); the request's device time by
   kernel through the full body and through the route before it (the decode to
   planes and ``solve_fn``, <= 1e-5 m apart), and the f32 product over the
   equations alone; the one-to-one file (the identity table: the delta body)
   and every equation twice (the full body) against the request without a file
   (<= 1e-5 m).
18. spec_variants: three models of layers the shipped configs do not use, at the
   dgrad widths over the same template and bases: ``freq_last_gmm`` (FreqLstm
   "last" through ``bilstm_layer`` at H = 128, a 3-layer time stack at H = 256,
   GMM attention), ``lstm2d_prod`` (LSTM2d per window through ``bilstm_layer``
   at H = 128, ``bilstm2``, dot-product attention) and ``gru_extras``
   (``mul-noise`` and ``gradx`` after FreqLstm, a biGRU through cuDNN, a head fc
   with pre-layer extras). Each serves a 3 s request (launches by kernel and
   width, wall and device busy ms) within 1e-5 m of the plain versions and 1e-4
   m of the float64 solve, then takes 10 train steps of 100 windows
   (``bilstm_core`` launches counted; the first step's loss terms within 1e-5
   and its gradient norm within 1e-4 of the plain versions'); ``freq_last_gmm``
   then trains one epoch of 3 batches with an aux loader (``Trainer.aux_steps``
   counted: one aux step after each main step, host steps = main + aux).

19. data_parallel (after ``cli``, on the ``data_train`` dataset): two gloo ranks
   on ``cuda:0`` (NCCL refuses two ranks on one card), subprocesses of this script
   (``--dp-rank``), take 3 steps of the full-width dgrad model on their pair-keeping
   halves of the seeded 100-window batches while this process takes them on the whole
   batches: the ranks bit-equal, rank 0 within ``DP_LOSS_RTOL`` and ``dp_state_checks``
   of this process, K5 3 + 3 a step in each rank; wall and all-reduce ms a step
   (contended: both ranks share the card). Started beside them: ``python -m
   torch.distributed.run --standalone --nproc_per_node 1 -m sdfa_tpu_torch train`` with
   ``trainer.multihost`` and a validation epoch on NCCL (its log names the backend and
   the child's K1 / K2 / K5 launches; three checkpoint files), then a 3 s request from
   its checkpoint through ``load_task`` (K1 / K2 / K3 1 / 1 / 1). The kernel phase also
   times K5 at a rank's shapes, 32 x 3200 x 128 and 64 x 50 x 256.

20. last_modules (after ``data_parallel``, on the ``data_train`` dataset at the
   shipped width): ``StepEnv`` (a warm step, the median of 5 synchronized steps, 10
   back-to-back steps without and with the upload; K5 3 + 3 a step; ``cost_stats``
   split into the library ops and each kernel's launches; windows a second beside the
   train phase's step); ``Experiment.plot_forward`` on its 100-window batch (K1 / K2
   1 / 1, within ``PLOT_REL_TOL`` of the plain versions, wall and device busy ms;
   the kernel phase times K1 at 6400 rows and K2 at 100 windows); a ``Trainer`` with
   ``plot_gap_steps=2`` for 4 steps (``summary.enabled``, ``PLUGIN_FAILURES`` 0, K5 12 /
   12, K1 / K2 2 / 2); a ``Trainer`` with ``eval_gap_epochs=1`` and a wav that exists:
   on a host with OpenCV one epoch of one step and the evaluation's video, its frame
   count from the clip's window geometry; on one without, refused before any step
   (the exception's type and message checked, K5 0); ``features.get_dict`` (mel, spec, deepspeech_spec, lpc) on
   a 3 s clip on the card against the CPU; ``BilateralFilter1D`` on the serve phase's
   request vertices on the card against the CPU; the native float64 runtime, built
   now, solving the request's first 16 frames against K3's vertices (<= 1e-4 m).

21. wide_variants (after ``spec_variants``): the dgrad model with its recurrent stacks
   widened (``WIDE_VARIANTS``): ``wide512`` (FreqLstm at H = 256 projected to 512, a
   2-layer time stack at H = 512: K1 at 256, K2 at 512, K5 at 256 and 512) and ``wide384``
   (FreqLstm at H = 384 projected to 384, a 3-layer time stack at H = 384: K1 and K4 x 3 at
   384, K5 at 384), the shipped conv stack, heads, template and bases. Each serves a 3 s
   request within 1e-5 m of the plain versions and 1e-4 m of the float64 solve, with its
   launches by kernel and width, then takes 10 train steps of 100 windows (K5 by pass and
   width), the first step's loss terms within 1e-5 and its gradients within 1e-4 of the
   largest against the plain versions'.

22. stream_capacity (after ``wide_variants``): ``tools/stream_capacity_torch.py`` as a
   subprocess on the full-width dgrad model (seeded weights and bases, the synthetic
   template), N streams of the same 8 s formant clip in one ``StreamingServer(capacity=N)``
   until all are done: delivered and pipelined at N = 8, 32, 128 on i16, device-only at 8
   and 128, on coef at 8 with the client's ``CoefDecoder`` timed a frame. Each round's wall,
   per-stream and aggregate times real time, frames (N times an offline request's of the
   same clip) and K1 / K2 / K3 launches (K3 0 on coef).

23. longrun: ``tools/longrun_train_torch.py --steps 300`` as a subprocess (it generates
   its dataset, then ``api.train_model`` with PCA targets and an unbounded epoch cap): wall
   seconds, the median interval between step dispatches, every epoch's train losses (all
   finite, the position loss of the last below the first's), K5 900 / 900, the checkpoints
   written; then, in
   process, the last checkpoint's validation loss over the dataset's validation windows in
   eval mode (K1 / K2 a batch, within 1e-5 of the plain versions'; the shipped config runs
   no validation epoch) and in training mode (BatchNorm on each batch's statistics).

24. examples, on the long run's ``last.ckpt``, four subprocesses started together:
   ``examples/torch_serve_vertices.py`` on a 3 s formant wav (its OBJs the offline request's
   count, the middle one read back within 1e-4 m of the native float64 solve of the same
   frame's planes), ``evaluate_torch.sh`` on a 1 s wav (video included) and
   ``examples/torch_render_template.py`` (both exit 0, their files not empty), and ``python
   -m sdfa_tpu_torch serve --capacity 8``; then, alone beside it,
   ``examples/torch_stream_client.py`` pushing the wav in 100 ms chunks at real pace on
   loopback (the offline count, frames during the push, wall against the clip's seconds).

The kernel phase also gives the input projection ``proj_kernel`` (3xTF32 on the tensor
cores) rows of its own at every instantiation on the path's shapes (``proj_row_specs``:
``<512>`` in K1 at 3072, 768, 512, 128, 12 rows and K4 over LSTM2d's frequency layer,
``<1024>`` in K2 at 256, 216, 128, 512 windows and K4 at 256 rows, ``<0>`` at the wide
rows): its device ms from the kernel's torch.profiler split (the product and the staging of
w_ih), its bound in 3xTF32 (f32 beside it), the f32 cuBLAS product of the same operands,
its plain version, and the projection launched alone against the plain version (<= 1e-4)
and a float64 product (<= 1e-5 of the largest |xp|).

At the end ``ops.PLAIN_ROUTES`` must read 0: no path this script drives has a
recurrent shape that no kernel takes.

Before its last lines the script checks that no process it started is left
(every process of its process group that was not there when it began). Any
failure raises, so the script exits non-zero and prints no result
line. The last line is ``{"ok": true, "device": {...}}``.
"""

import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

SEED = 0
K1_ROWS = 4 * 768     # 4 clips x a 3 s clip's 768-frame grid
K1_REQUEST_ROWS = 768  # one 3 s request's frame grid
K2_WINDOWS = 256      # windows per suffix call
K3_WINDOWS = 256
K3_REQUEST_WINDOWS = 216  # one 3 s request's windows
K4_ROWS = 256
# K4 at H = 128, (rows, T, in): V1's FreqLstm "last" over a 3 s request's 768 frames; V2's
# LSTM2d over its 216 windows (216 x 64 rows of 32 frequency steps, then 216 x 32 rows of 64)
K4_H128_SHAPES = ((768, 32, 64), (216 * 64, 32, 64), (216 * 32, 64, 256))
K1_LIVE_ROWS = (12, 128, 512)  # a stream's first block; a block round at capacity 8 and 32
LIVE_WINDOWS = (128, 512)      # a full tick's suffix call at capacity 8 and 32
K1_PLOT_ROWS, K2_PLOT_WINDOWS = 6400, 100  # Experiment.plot_forward on a 100-window batch
# The wide step loop (H = 384 and up) and K1 at H = 256 / any output width, at the
# wide_variants phase's shapes: K1 (H, out) over a request's 768 rows (and H = 512); K2 (H, in)
# over its 216 windows; K4 (H, in) over them, the wide384 stack's and H = 512 (in 1024 = 2H
# too); K5 (T, rows, H, the input width cuDNN's yardstick takes) at the train step's shapes
WIDE_K1 = ((256, 512), (384, 384), (512, 512))
WIDE_K2 = ((512, 512),)
WIDE_K4 = ((384, 384), (384, 768), (512, 512), (512, 1024), (1024, 1024))
WIDE_K5 = ((64, 100, 512, 512), (64, 100, 384, 384), (32, 6400, 256, 64), (32, 6400, 384, 64),
           (32, 6400, 512, 64))
WIDE_HIDDENS = (384, 512, 1024)  # the build line's tilings of the wide step loop
PROJ_F64_REL = 1e-5  # a projection (input, or K1's output) vs a float64 product, over the
                     # largest value it computes
# kernel_split's parts by a fragment of the kernel's name: a recurrent kernel's, K3 full body's
RECURRENT_PARTS = (("steps_kernel", "step_loop"), ("proj_kernel", "input_projection"),
                   ("proj_", "input_projection_staging"), ("out_parts", "output_projection"),
                   ("out_sum", "output_projection"))
# the whole input projection of a call, for --proj-rows: proj_kernel, and in a checkout whose
# projection stages w_ih first, proj_weights_kernel (and proj_pad_kernel)
PROJ_PARTS = (("proj_", "input_projection"),)
# the whole output projection of a K1 call, for --outproj-rows: the slabs' product and their sum
OUTPROJ_PARTS = (("out_parts", "output_projection"), ("out_sum", "output_projection"))
# kernel_split profiles a call again when its trace lost device records, and pads the traced
# window with idle host time at both ends (records past its edges are dropped)
PROFILE_ATTEMPTS = 4
PROFILE_PAD_S = 0.1
PROFILES_LOST = []  # the first part's label of each such profile, for the seconds_by_part line
K3_FULL_PARTS = (("split_product_kernel", "product"), ("decode_delta_kernel", "decode"),
                 ("solve_sum_kernel", "sum"))
TRAIN_WINDOWS = 100   # 50 adjacent-frame pairs, the shipped batch
TRAIN_STEPS = 5
VARIANT_TRAIN_STEPS = 10  # spec_variants: train steps of 100 windows per variant
VARIANT_PLAIN_TOL_M = 1e-5  # spec_variants: a request through kernels vs plain versions
DATA_TRAIN_STEPS = 30  # api.train_model from a generated dataset: 6 epochs of 5 batches
TOL = {"freq_lstm": 1e-4, "bilstm2": 1e-4, "decode_solve": 1e-5, "decode_solve_full": 1e-5,
       "bilstm_layer": 1e-4, "bilstm_core_fwd": 1e-4}  # max |kernel - plain|
BWD_REL_TOL = 1e-4    # bilstm_core_bwd: max |diff| / max |reference|, for d(xp) and d(w_hh)
PLAIN_TOL_M = 1e-4    # wav -> vertices through kernels vs through plain versions
ORACLE_TOL_M = 1e-4   # sampled frames vs the float64 host solve
FRONTEND_TOL, FRONTEND_CH0_TOL = 2e-3, 5e-4  # device training frontend vs host features
WIRE_TOL_M = {"f32": 0.0, "i16": 5e-6 + 1e-7, "i8d": 2e-5 + 1e-7}  # a wire vs the f32 wire
COEF_ORACLE_TOL_M = 1e-6  # the coef wire, decoded on the host, vs the float64 host solve
OFFSETS_PLAIN_TOL_M = 1e-5  # the offsets model: a request through kernels vs plain versions
OFFSETS_HOST_TOL_M = 1e-6   # ... and vs its coefficients decoded on the host in float64
STREAM_TOL_M = 1e-5   # streamed vs offline on the same audio (f32 and decoded coef frames)
SOCKET_TIMEOUT_S = 120.0
CLI_TRAIN_STEPS = 16   # `python -m sdfa_tpu_torch train`: the profiler window is steps 10-14
CLI_SAME_TOL_M = 1e-7  # load_traced / load_task / the task in memory: the same weights
CLI_SERVE_TOL_M = 5e-6 + 1e-7  # a served stream on i16 vs the offline f32 request
CLI_SUBPROCESS_TIMEOUT_S = 300
# what the train window's trace must name: the training core's kernels, by their CUDA
# names (the backward; the forward runs bilstm_layer.cuh's step kernel), and a span
CLI_TRACE_NAMES = ("core_bwd_kernel", "steps_kernel", "train/backward")
STEP_LOSS_RTOL = 1e-5  # train step, kernels vs plain versions: total loss
STEP_GRAD_RTOL = 1e-4  # ... and every gradient: max |diff| over the model's largest |gradient|;
                       # the recurrent layers' gradients also over their own largest |value|
# preprocess: the raw tree's sentences (m3's 37th and 38th are in the trim tables, the
# 38th also in the must-silent one; f4 validates, m5 tests), their audio, the train steps
PRE_SENTENCES = (("m0", 1), ("m0", 2), ("m3", 37), ("m3", 38), ("f4", 21), ("m5", 21))
PRE_AUDIO_S = 2.0
PRE_TRAIN_STEPS = 8
DGRAD_FILE_TOL = 1e-6  # a dgrad file (float64 on the card, saved float32) vs numpy float64
PRE_CHECK_FRAMES = 16  # dgrad files of each sentence held against numpy, a seeded sample
                       # (tests/test_torch_preprocess.py holds every file against JAX's)
PCA_TOL = 1e-5         # fitted components vs a float64 numpy SVD with sklearn's sign rule
PRE_ROUNDTRIP_TOL_M = 1e-4  # float32 dgrad files solved back (tests/test_deformation.py:168)
PRE_PLAIN_TOL_M = 1e-5  # the preprocessed checkpoint's request, kernels vs plain versions
IDENTITY_TOL_M = 1e-5   # an identity correspondence table vs no table
# K3's full body vs the float64 decode, gather and product: float32 grade (the plain float32
# product is within 1.4e-7 m at the kernel phase's shapes; 3xTF32 summed by the tensor cores
# alone drifted to 2.75e-6 at 216 windows)
FULL_F64_TOL_M = 5e-7
# data_parallel: two gloo ranks on cuda:0 against one process on the global batch
DP_WORLD = 2
DP_STEPS = 3
DP_GROUP_TIMEOUT_S = 120  # a collective that waits longer raises in the rank
DP_LOSS_RTOL = 1e-5       # each step's loss terms and gradient norm, rank 0 vs one process
DP_STATE_TOL = 1e-5       # every parameter, BatchNorm statistic and scaler state, max abs,
DP_ROUNDING_REL = 1e-2    # but the entries whose gradient the two runs give this far apart
                          # (relative to its own size) in a step: see dp_state_checks
DP_NCCL_STEPS = 4         # torch.distributed.run at world size 1 on NCCL
DP_TIMEOUT_S = 300        # the ranks, the launcher
# last_modules: StepEnv's steps; plot_forward against the plain versions; the features on the
# card against the CPU; the bilateral filter on the card against the CPU; the native float64
# runtime against K3's vertices of the same frames
STEPENV_MEDIAN_STEPS, STEPENV_STEADY_STEPS = 5, 10
PLOT_REL_TOL = 1e-4       # plot_forward's predictions: max |kernel − plain| / max |plain|
FEATURE_CARD_TOL = 1e-4   # features.get_dict on the card vs the CPU
BILATERAL_CARD_TOL = 1e-6
NATIVE_TOL_M = 1e-4       # native float64 vs K3's vertices (the wav → vertices budget)
NATIVE_FRAMES = 16
PLOT_TRAINER_STEPS = 4
# stream_capacity: tools/stream_capacity_torch.py as a subprocess on the full-width dgrad model,
# one 8 s clip a stream, each run's rounds (mode, arguments); the frames of every round must be N
# times an offline request's
CAPACITY_CLIP_S = 8.0
CAPACITY_RUNS = (("delivered", ("--n", "8", "32", "128")),
                 ("device_only", ("--n", "8", "128", "--device-only")),
                 ("coef", ("--n", "8", "--wire", "coef")))
# longrun: tools/longrun_train_torch.py for LONGRUN_STEPS (its own default is 2500)
LONGRUN_STEPS = 300
# examples: the long run's checkpoint through the three examples and evaluate_torch.sh
EXAMPLE_CLIP_S, EXAMPLE_EVAL_S = 3.0, 1.0
TOOL_TIMEOUT_S = 600     # a tool or example subprocess
F32_PEAK = 67e12      # H100 SXM, float32 outside the tensor cores, FLOP/s (data sheet)
TF32_PEAK = 495e12    # H100 SXM, TF32 on the tensor cores, dense, FLOP/s (data sheet)
HBM_RATE = 3.35e12    # H100 SXM, bytes/s (data sheet)


def emit(obj):
    print(json.dumps(obj), flush=True)


def group_processes():
    """pid -> (state, command line) of every other process in this script's
    process group, read from /proc."""
    group, me = os.getpgrp(), os.getpid()
    found = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == me:
            continue
        try:
            with open(f"/proc/{entry}/stat") as fp:
                stat = fp.read()
            with open(f"/proc/{entry}/cmdline", "rb") as fp:
                cmd = fp.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:  # it exited while we looked
            continue
        state, _ppid, pgrp = stat[stat.rindex(")") + 2:].split()[:3]
        if int(pgrp) == group:
            found[int(entry)] = (state, cmd[:200])
    return found


def check_no_process_left(before):
    """Raises if a process that was not in the group when the script began
    is still there (running or unreaped)."""
    left = {pid: v for pid, v in group_processes().items() if pid not in before}
    emit({"phase": "processes_left", "count": len(left)})
    if left:
        raise RuntimeError(f"processes this script started are still there: {left}")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_backward_ms(make_out, inputs, dout, n: int) -> float:
    """Time of the backward pass alone: a fresh forward graph each turn, CUDA
    events around ``autograd.grad``; the first turn warms up."""
    import torch

    total = 0.0
    for turn in range(n + 1):
        out = make_out()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(out, inputs, dout)
        end.record()
        torch.cuda.synchronize()
        if turn:
            total += start.elapsed_time(end)
    return total / n


def bound(flops: float, nbytes: float, tensor_flops: float = 0.0):
    """The least time the card could take: the larger of operations over
    their unit's peak (``flops`` in float32 outside the tensor cores,
    ``tensor_flops`` in TF32 on them) and bytes (inputs once, outputs once)
    over the HBM rate."""
    t_ops = (flops / F32_PEAK + tensor_flops / TF32_PEAK) * 1e3
    t_bytes = nbytes / HBM_RATE * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cost_full_per_equation(windows: int, ks: int, kr: int, tp: int, ep: int, nf: int):
    """(flops, bytes) of K3's full body as its per-equation design ran it (the
    table gathered on the card), for the bound by that reckoning: the decode
    once per triangle, three TF32 products over K' = 9E' (E' padded
    equations), its inputs the bases, the table and B' = [hi | lo | hi] of
    1280 x 9E' floats, the output written once."""
    n_pad = -(-nf // 128) * 128
    flops = 2.0 * windows * (6 * ks + 3 * kr) * tp + 3 * 2.0 * windows * 9 * ep * nf
    floats = (windows * (ks + kr) + (ks + 1) * 6 * tp + (kr + 1) * 3 * tp + ep
              + n_pad * 9 * ep + windows * 3 * nf)
    return flops, 4.0 * floats


def kernel_split(fn, n=3, names=None):
    """Device ms a call of ``fn`` spends in each part of a kernel, from
    torch.profiler's kernel names (``n`` calls after a warm-up): ``names`` maps
    a fragment of a kernel's name to its part (the first fragment that matches
    wins), the first part must be there. By default a recurrent kernel's
    (``RECURRENT_PARTS``): the step loop (``steps_kernel``, ``wide_steps_kernel``)
    apart from the input projection (``proj_kernel``, and the staging of w_ih
    before it, ``proj_weights_kernel`` / ``proj_pad_kernel``) and K1's output
    projection (``out_parts`` + ``out_sum``). A profile that holds no device
    record, or a kernel a number of times that is no multiple of ``n``, lost
    records and is taken again, up to PROFILE_ATTEMPTS times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = RECURRENT_PARTS if names is None else names
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILE_PAD_S)
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_PAD_S)
        parts, whole = collections.Counter(), True
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            part = next((label for fragment, label in names if fragment in e.key), "other")
            parts[part] += e.self_device_time_total / 1e3 / n
            whole = whole and e.count % n == 0
        if parts and whole:
            break
        # every call launches the same kernels, so a kernel seen a number of times that is no
        # multiple of n (or no device record at all) is a trace that lost records at its edges:
        # the calls are profiled once more
        PROFILES_LOST.append(names[0][1])
        print(f"kernel_split: profile {attempt} of {PROFILE_ATTEMPTS} lost device records "
              f"({dict(parts)}), profiling again", file=sys.stderr, flush=True)
    if not parts[names[0][1]]:
        raise RuntimeError(f"no {names[0][1]} kernel in the profile: {dict(parts)}")
    return dict(parts)


def tensor_core_sass(build, name: str) -> dict:
    """The tensor-core opcodes (``HGMMA``) in the machine code of the built
    library ``name``, by ``cuobjdump -sass``: how many, and the first one.
    Raises if its product was compiled to none."""
    lib = build.load_library(name)._name
    sass = subprocess.run([os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"), "-sass",
                           lib], capture_output=True, text=True, check=True, timeout=120).stdout
    found = [line.split("*/")[1].split("/*")[0].strip(" ;") for line in sass.splitlines()
             if "GMMA" in line and "*/" in line]
    if not found:
        raise RuntimeError(f"{name}: no warpgroup matrix opcode in the machine code")
    return {"count": len(found), "first": found[0]}


def ptxas_kernels(ptxas: str, fragment: str) -> list:
    """Registers and spill bytes of each kernel whose mangled name holds
    ``fragment``, from ``nvcc -Xptxas -v``'s report of one build."""
    found, name = [], None
    for line in ptxas.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1) if fragment in m.group(1) else None
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            found.append({"function": name, "spill_stores": int(st), "spill_loads": int(ld)})
        elif name and "Used" in line and found and found[-1]["function"] == name:
            found[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            name = None
    return found


def wide_hidden(hidden: int) -> bool:
    """Whether the recurrent kernels run the wide step loop at ``hidden`` units:
    a multiple of 128 from 384 on."""
    return hidden >= 384 and hidden % 128 == 0


def proj_instance(hidden: int) -> int:
    """The template argument of proj_kernel at ``hidden`` units: the gate
    width 4H at 128 and 256, 0 (at run time) from 384 on."""
    return 4 * hidden if hidden in (128, 256) else 0


def proj_row_specs():
    """The rows the input projection (``proj_kernel``) is timed at, every
    instantiation on the path's shapes: (row, kernel, H, (rows, T, in), out).
    <512>: K1 at the kernel phase's 3072 rows, a request's 768 and live
    serving's 12 / 128 / 512, K4 at H = 128 over LSTM2d's frequency layer (216 x
    64 rows of 32 steps); <1024>: K2 at 256, 216, 128 and 512 windows, K4 at
    256 rows of 256 and 512 inputs; then the wide rows (WIDE_K1, of which H =
    256 is <1024>, WIDE_K2, WIDE_K4 with H = 1024): <0>."""
    specs = [(f"k1_{r}", "freq_lstm", 128, (r, 32, 64), 256)
             for r in (K1_ROWS, K1_REQUEST_ROWS) + K1_LIVE_ROWS]
    specs.append(("k4_h128_lstm2d_freq", "bilstm_layer", 128, K4_H128_SHAPES[1], None))
    specs += [(f"k2_{w}", "bilstm2", 256, (w, 64, 256), None)
              for w in (K2_WINDOWS, K3_REQUEST_WINDOWS) + LIVE_WINDOWS]
    specs += [(f"k4_in{n}", "bilstm_layer", 256, (K4_ROWS, 64, n), None) for n in (256, 512)]
    specs += [(f"k1_h{h}_out{o}", "freq_lstm", h, (K1_REQUEST_ROWS, 32, 64), o)
              for h, o in WIDE_K1]
    specs += [(f"k2_h{h}", "bilstm2", h, (K3_REQUEST_WINDOWS, 64, n), None) for h, n in WIDE_K2]
    specs += [(f"k4_h{h}_in{n}", "bilstm_layer", h, (K3_REQUEST_WINDOWS, 64, n), None)
              for h, n in WIDE_K4]
    return specs


def proj_row_call(spec, kernels, dev, seed):
    """The kernel call of a projection row (``proj_row_specs``) on seeded
    inputs at PyTorch's LSTM scale, and the operands of the projections it
    runs, [(x, w_ih, gate bias)] layer by layer: K2's second layer reads the
    first's output, computed here by K4. ``kernels``: the modules freq_lstm,
    bilstm2, bilstm_layer of the package to call."""
    import torch

    _, kernel, hid, (rows, steps, n_in), out = spec
    freq_lstm, bilstm2, bilstm_layer = kernels
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    def layer(n):
        return (randn(2, n, 4 * hid, scale=hid ** -0.5), randn(2, hid, 4 * hid, scale=hid ** -0.5),
                randn(2, 4 * hid, scale=0.1))

    x, w1 = randn(rows, steps, n_in, scale=0.5), layer(n_in)
    if kernel == "freq_lstm":
        args = (x, *w1, randn(steps * 2 * hid, out, scale=0.02), randn(out, scale=0.1))
        return (lambda: freq_lstm.freq_lstm(*args)), [(x, w1[0], w1[2])]
    if kernel == "bilstm_layer":
        return (lambda: bilstm_layer.bilstm_layer(x, *w1)), [(x, w1[0], w1[2])]
    w2 = layer(2 * hid)
    with torch.inference_mode():
        stack = bilstm_layer.bilstm_layer(x, *w1)
    return (lambda: bilstm2.bilstm2(x, *w1, *w2)), [(x, w1[0], w1[2]), (stack, w2[0], w2[2])]


def wide_row_specs():
    """The rows the wide step loop (H = 384 and up) is timed at by ``--wide-rows``:
    (row, kernel, H, shape, out). K1 at a request's 768 rows (WIDE_K1 from H =
    384), K2 at its 216 windows (WIDE_K2), K4 at them (WIDE_K4), and K5's forward
    (``core_fwd``: ``wide_steps_kernel`` by time, gates and c saved) and backward
    (``core_bwd``: ``wide_bwd_kernel``) at the train step's shapes (WIDE_K5 from H =
    384; shape (T, rows))."""
    specs = [(f"k1_h{h}_out{o}", "freq_lstm", h, (K1_REQUEST_ROWS, 32, 64), o)
             for h, o in WIDE_K1 if wide_hidden(h)]
    specs += [(f"k2_h{h}", "bilstm2", h, (K3_REQUEST_WINDOWS, 64, n), None) for h, n in WIDE_K2]
    specs += [(f"k4_h{h}_in{n}", "bilstm_layer", h, (K3_REQUEST_WINDOWS, 64, n), None)
              for h, n in WIDE_K4]
    for steps, rows, h, _ in WIDE_K5:
        if wide_hidden(h):
            specs += [(f"k5_{which}_{steps}x{rows}x{h}", f"core_{which}", h, (steps, rows), None)
                      for which in ("fwd", "bwd")]
    return specs


# a wide row's step loop by kernel name: K1 / K2 / K4 (RECURRENT_PARTS' first), K5's passes
WIDE_PARTS = {"core_fwd": (("wide_steps_kernel", "step_loop"),),
              "core_bwd": (("wide_bwd_kernel", "step_loop"),)}


def wide_row_call(spec, kernels, dev, seed):
    """The kernel call of a wide row (``wide_row_specs``) on seeded inputs at
    PyTorch's LSTM scale, and a function giving its drift from float64: for K1,
    K2, K4 and K5's forward the largest |kernel - float64| of the output (the
    module's plain version on float64 operands), for K5's backward that of d(xp)
    over its largest |value| (the backward step in float64 on the kernel's
    residuals). ``kernels``: the modules freq_lstm, bilstm2, bilstm_layer,
    bilstm_core of the package to call."""
    import torch

    _, kernel, hid, shape, out = spec
    freq_lstm, bilstm2, bilstm_layer, bilstm_core = kernels
    gen = torch.Generator().manual_seed(seed)

    def randn(*size, scale=1.0):
        return (scale * torch.randn(*size, generator=gen)).to(dev)

    def layer(n):
        return (randn(2, n, 4 * hid, scale=hid ** -0.5), randn(2, hid, 4 * hid, scale=hid ** -0.5),
                randn(2, 4 * hid, scale=0.1))

    def f64(args):
        return [a if a is None else a.double() for a in args]

    def drift_of(fn, plain, args):
        def drift():
            with torch.inference_mode():
                return float((fn().double() - plain(*f64(args))).abs().max())
        return drift

    if kernel.startswith("core_"):
        steps, rows = shape
        xp, w_hh = randn(2, steps, rows, 4 * hid, scale=0.5), randn(2, hid, 4 * hid,
                                                                    scale=hid ** -0.5)
        if kernel == "core_fwd":
            call = lambda: bilstm_core._forward_kernel(xp, w_hh)[0]  # noqa: E731
            return call, drift_of(call, lambda a, b: bilstm_core.forward_steps(a, b)[0],
                                  (xp, w_hh))
        dout = randn(steps, rows, 2 * hid)
        with torch.inference_mode():
            _, gates, cs = bilstm_core._forward_kernel(xp, w_hh)
        call = lambda: bilstm_core._backward_kernel(gates, cs, w_hh, dout)  # noqa: E731

        def drift():
            with torch.inference_mode():
                exact = bilstm_core.backward_steps(*f64((gates, cs, w_hh, dout)))
                return float((call().double() - exact).abs().max() / exact.abs().max())
        return call, drift
    rows, steps, n_in = shape
    x, w1 = randn(rows, steps, n_in, scale=0.5), layer(n_in)
    if kernel == "freq_lstm":
        args = (x, *w1, randn(steps * 2 * hid, out, scale=0.02), randn(out, scale=0.1))
        module = freq_lstm.freq_lstm, freq_lstm.freq_lstm_plain
    elif kernel == "bilstm_layer":
        args, module = (x, *w1), (bilstm_layer.bilstm_layer, bilstm_layer.bilstm_layer_plain)
    else:
        args, module = (x, *w1, *layer(2 * hid)), (bilstm2.bilstm2, bilstm2.bilstm2_plain)
    call = lambda: module[0](*args)  # noqa: E731
    return call, drift_of(call, module[1], args)


def outproj_row_specs():
    """The rows K1's output projection (``out_parts_kernel`` + ``out_sum_kernel``)
    is timed at, every K1 shape of the path: (row, H, rows, out). At H = 128,
    out 256 (K = 8192): the kernel phase's 3072 rows, a request's 768, live
    serving's 12 / 128 / 512, ``plot_forward``'s 6400; then the WIDE_K1 shapes
    at a request's 768 rows (K = 16384, 24576, 32768)."""
    specs = [(f"k1_{r}", 128, r, 256)
             for r in (K1_ROWS, K1_REQUEST_ROWS) + K1_LIVE_ROWS + (K1_PLOT_ROWS,)]
    specs += [(f"k1_h{h}_out{o}", h, K1_REQUEST_ROWS, o) for h, o in WIDE_K1]
    return specs


def outproj_row_call(spec, freq_lstm, dev, seed):
    """The K1 call of an output-projection row (``outproj_row_specs``) on seeded
    inputs (x (rows, 32, 64), weights at PyTorch's LSTM scale, w_proj at 0.02),
    and the projection's own operands: an h of the shape K1 gives it, (rows, 32
    · 2H) with |h| < 1, the same w_proj and b_proj. ``freq_lstm``: the module
    of the package to call."""
    import torch

    _, hid, rows, out = spec
    steps, k = 32, 32 * 2 * hid
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    args = (randn(rows, steps, 64, scale=0.5), randn(2, 64, 4 * hid, scale=hid ** -0.5),
            randn(2, hid, 4 * hid, scale=hid ** -0.5), randn(2, 4 * hid, scale=0.1),
            randn(k, out, scale=0.02), randn(out, scale=0.1))
    h = (2 * torch.rand(rows, k, generator=gen) - 1).to(dev)
    return (lambda: freq_lstm.freq_lstm(*args)), (h, *args[4:])


def proj_cost(layers):
    """(flops, bytes) of the projections on ``layers``' operands: one product
    of both directions, 2 M in 8H FLOP a layer, and x, w_ih, the bias read once,
    xp written once."""
    flops = moved = 0.0
    for x, w, g in layers:
        pairs, gdim = x.numel() // x.shape[-1], w.shape[-1]
        flops += 2.0 * pairs * x.shape[-1] * 2 * gdim
        moved += 4.0 * (x.numel() + w.numel() + g.numel() + 2 * pairs * gdim)
    return flops, moved


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def signal(seconds: float, sr: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(110.0, 220.0)
    sig = 0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3 * t))
    return (sig + 0.02 * rng.standard_normal(len(t))).clip(-1, 1).astype(np.float32)


def train_batches(n: int, windows: int = TRAIN_WINDOWS):
    """Seeded synthetic batches at FLAME's counts, as the sliding-window
    reader ships them: first half frame i, second half frame i + 1."""
    import numpy as np

    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        half = rng.integers(0, 8, (windows // 2,)).astype(np.int64)
        out.append({
            "audio_feat": rng.normal(0.4, 0.2, (windows, 64, 128, 3)).astype(np.float32),
            "speaker_id": np.concatenate([half, half]),
            "dgrad_3d_scale_coef": rng.normal(0, 1, (windows, 1, 85)).astype(np.float32),
            "dgrad_3d_rotat_coef": rng.normal(0, 1, (windows, 1, 180)).astype(np.float32)})
    return out


def seeded_pca():
    """Seeded PCA bases at the shipped dims (85 + 180 components) over FLAME's
    triangle count."""
    import numpy as np

    from sdfa_tpu_torch.mesh import FLAME_COUNTS

    rng = np.random.default_rng(SEED)
    n_tris = FLAME_COUNTS[1]
    return {"scale_compT": rng.normal(0, 0.01, (6 * n_tris, 85)).astype(np.float32),
            "scale_means": rng.normal(0, 0.01, (6 * n_tris,)).astype(np.float32),
            "rotat_compT": rng.normal(0, 0.01, (3 * n_tris, 180)).astype(np.float32),
            "rotat_means": rng.normal(0, 0.01, (3 * n_tris,)).astype(np.float32)}


def main():
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "sdfa_tpu_torch")):
        sys.exit("chip_smoke.py: the sdfa_tpu_torch package is not beside this script")
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is false; this needs a GPU")
    processes_before = group_processes()
    marks = [("start", time.perf_counter())]  # wall seconds by part of the run, printed at the end

    def mark(name):
        marks.append((name, time.perf_counter()))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sdfa_tpu_torch import ops
    from sdfa_tpu_torch.compat import init_params
    from sdfa_tpu_torch.config import configure
    from sdfa_tpu_torch.mesh import FLAME_COUNTS, synthetic_template
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.ops import (bilstm2, bilstm_core, bilstm_layer, build, decode_solve,
                                    freq_lstm)
    from sdfa_tpu_torch.ops.deform_solver import DeformationSolver
    from sdfa_tpu_torch.task import AnimationTask
    from sdfa_tpu_torch.train import Experiment, Trainer, checkpoints
    from sdfa_tpu_torch.viewer import frame

    dev = torch.device("cuda:0")
    smi = nvidia_smi_line()
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc": nvcc, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    build.load_libraries(["freq_lstm", "bilstm2", "decode_solve", "bilstm_layer", "bilstm_core"])
    core_clusters = {f"{hid}_{which}": n  # resident clusters per (hidden width, pass)
                     for (hid, which), n in bilstm_core.max_active_clusters(dev).items()}
    k1_tiling = freq_lstm.tiling(dev)
    k1_clusters = k1_tiling[128]
    # the wide step loop: resident blocks of each of its kernels (one cooperative launch takes
    # at most that many), and its tiling at each wide width: a block owns U units and R rows
    # (the product streams W_hh through L2 every step)
    wide_blocks = {"bilstm_layer": bilstm_layer.wide_resident_blocks(dev),
                   "freq_lstm": k1_tiling["wide"],
                   **{f"bilstm_core_{k}": n
                      for k, n in bilstm_core.wide_resident_blocks(dev).items()}}
    wide_tiling = {}
    for name, n in wide_blocks.items():
        for h in WIDE_HIDDENS:
            rows = bilstm_layer.wide_wave_rows(h, n)
            wide_tiling.setdefault(name, {})[h] = {
                "U": bilstm_layer.WIDE_UNITS, "R": bilstm_layer.WIDE_ROW_TILE,
                "blocks_a_wave": rows // bilstm_layer.WIDE_ROW_TILE * 2 * (
                    h // bilstm_layer.WIDE_UNITS),
                "rows_a_wave": rows}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": {k: v["seconds"] for k, v in build.BUILD_INFO.items()},
          "bilstm_step_kernel_max_active_clusters": bilstm_layer.max_active_clusters(dev),
          "bilstm_core_max_active_clusters": core_clusters,
          "freq_lstm_step_kernel_max_active_clusters": {h: k1_tiling[h] for h in (128, 256)},
          "wide_step_loop_resident_blocks": wide_blocks,
          "wide_step_loop_tiling": wide_tiling,
          "decode_solve_product_resident_blocks": {
              body: decode_solve.resident_blocks(dev, body) for body in ("delta", "full")},
          "tensor_core_sass": {name: tensor_core_sass(build, name)
                               for name in ("decode_solve", "bilstm_layer", "bilstm2", "freq_lstm")},
          "proj_kernel_ptxas": ptxas_kernels(
              build.BUILD_INFO.get("bilstm_layer", {}).get("ptxas", ""), "proj_"),
          "proj_kernel_tiling": bilstm_layer.proj_tiling(dev),
          "out_parts_kernel_ptxas": ptxas_kernels(
              build.BUILD_INFO.get("freq_lstm", {}).get("ptxas", ""), "out_parts"),
          "out_parts_kernel_tiling": freq_lstm.out_tiling(dev),
          "ptxas": {k: v["ptxas"] for k, v in build.BUILD_INFO.items()}})

    mark("device_and_build")
    # --- the flagship model at full width, seeded ---------------------------
    hp = configure("dgrad")
    pca = seeded_pca()
    model = init_params(build_model(hp, pca=pca), SEED)
    t0 = time.perf_counter()
    verts, faces, cnst = synthetic_template(SEED)
    solver = frame.set_template_mesh(verts, faces, cnst)
    assert (solver.n_verts, solver.n_tris, solver.n_free) == FLAME_COUNTS
    task = AnimationTask(hp, model, dev)
    _, consts, dsc = task._decode_consts()
    emit({"phase": "setup", "solver_and_consts_s": time.perf_counter() - t0,
          "n_verts": solver.n_verts, "n_tris": solver.n_tris, "n_free": solver.n_free,
          "params": sum(p.numel() for p in model.parameters())})

    # --- each kernel against its plain version at its path's shapes ---------
    def randn(seed, *shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=torch.Generator().manual_seed(seed))).to(dev)

    def library_lstm(n_in, hidden, layers, seed):
        lstm = torch.nn.LSTM(n_in, hidden, num_layers=layers, bias=False, bidirectional=True)
        torch.manual_seed(seed)
        for p in lstm.parameters():
            torch.nn.init.uniform_(p, -hidden ** -0.5, hidden ** -0.5)
        return lstm.to(dev)

    report = {}

    def record(name, shape, err, tol, ms, plain_ms, flops, moved, library_ms, source, replaces,
               primary=True, tensor_flops=0.0, **extra):
        bound_ms, bound_by = bound(flops, moved, tensor_flops)
        line = {"phase": "kernel", "name": name, "shape": shape, "max_abs_err": err, "tol": tol,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "gflop": flops / 1e9, "mbytes": moved / 1e6,
                "card": smi, **extra}
        if tensor_flops:
            line["gflop_tf32_tensor_cores"] = tensor_flops / 1e9
        emit(line)
        if not err <= tol:
            raise RuntimeError(f"{name} {shape}: kernel disagrees with its plain version: "
                               f"{err} > {tol}")
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                 **{k: v for k, v in extra.items()
                    if k in ("err_is", "bound_peaks", "hidden", "out", "split_ms", "table",
                             "f32_bound_ms", "max_abs_m_vs_f64", "library_f32_ms",
                             "library_folded_ms", "bound_ms_per_equation", "max_abs_vs_f64")}}
        if primary:
            report[name] = entry
        else:
            report[name].setdefault("other_shapes", []).append(
                {k: entry[k] for k in ("shape", "hidden", "out", "table", "max_abs_err",
                                       "max_abs_m_vs_f64", "max_abs_vs_f64", "ms", "plain_ms",
                                       "bound_ms", "f32_bound_ms", "bound_ms_per_equation",
                                       "bound_by", "library_ms", "library_f32_ms",
                                       "library_folded_ms", "split_ms")
                 if k in entry})

    def forward_case(name, kernel, plain, args, cost, library, source, replaces, primary=True,
                     **extra):
        """A recurrent kernel (K1, K2, K4) against its plain version. ``cost``: the
        kernel module's (flops, bytes) of one launch on ``args``, the work its bound
        reckons: the input projections' product (w_ih is ``args[1]``, K2's second
        layer's ``args[4]``) and K1's output projection (w_proj is ``args[4]``) at
        the TF32 rate in three passes, and from H = 384 on (the wide step loop,
        ``wide_hidden``) the recurrence too, the rest at the f32 rate;
        ``f32_bound_ms`` reckons it all at the f32 rate. A wide row is also held to
        the plain version in float64 (``max_abs_vs_f64``, the plain version's own
        beside it)."""
        wide = wide_hidden(extra.get("hidden", 0))
        with torch.inference_mode():
            got = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"{name}: non-finite output")
            err = float((got - want).abs().max())
            if wide:
                exact = plain(*(a if a is None else a.double() for a in args))
                extra["max_abs_vs_f64"] = {"kernel": float((got.double() - exact).abs().max()),
                                           "plain": float((want.double() - exact).abs().max())}
                del exact
            ms = time_ms(lambda: kernel(*args), 5)
            plain_ms = time_ms(lambda: plain(*args), 3)
            library_ms = time_ms(library, 5) if library else None
        pairs = args[0].numel() // args[0].shape[-1]
        proj = sum(2.0 * pairs * w.shape[1] * 2 * w.shape[2]
                   for w in ((args[1], args[4]) if name == "bilstm2" else (args[1],)))
        if name == "freq_lstm":  # K1's output projection, (rows, F 2H) . (F 2H, out)
            proj += 2.0 * args[0].shape[0] * args[4].shape[0] * args[4].shape[1]
        flops, moved = cost
        on_tensor_cores = flops if wide else proj  # the wide loop's h . w_hh too
        record(name, list(args[0].shape), err, TOL[name], ms, plain_ms, flops - on_tensor_cores,
               moved, library_ms, source, replaces, primary, tensor_flops=3 * on_tensor_cores,
               f32_bound_ms=bound(flops, moved)[0],
               bound_peaks=("recurrence (the wide step loop), input projection (and K1's output "
                            "projection): 3 TF32 passes at 495 TFLOP/s" if wide else
                            "recurrence: 67 TFLOP/s f32; input projection (and K1's output "
                            "projection): 3 TF32 passes at 495 TFLOP/s") +
                           " (f32_bound_ms: all at 67)",
               **extra)

    def repeats(name, kernel, args, first):
        """Two launches on the same inputs must be equal bit for bit."""
        if not torch.equal(kernel(*args), first):
            raise RuntimeError(f"{name} {tuple(args[0].shape)}: two launches on the same inputs "
                               "differ")
        return True

    enc = model.audio_encoder
    fl = enc.built_layers_6
    w_ih, w_hh, gb = fl.lstm.layer_weights(0)
    k1_weights = (w_ih, w_hh, gb, fl.proj.weight(), fl.proj.bias)
    lib1 = library_lstm(64, 128, 1, 1)
    # the kernel phase's four clips, one request's grid, then live serving's block rounds
    for rows in (K1_ROWS, K1_REQUEST_ROWS) + K1_LIVE_ROWS + (K1_PLOT_ROWS,):
        x1 = randn(1, rows, fl.freq_length, w_ih.shape[1])
        x1_lib = x1.transpose(0, 1).contiguous()
        forward_case("freq_lstm", freq_lstm.freq_lstm, freq_lstm.freq_lstm_plain,
                     (x1, *k1_weights),
                     freq_lstm.cost(*x1.shape, 128, 256, gb is not None,
                                    k1_weights[4] is not None),
                     lambda: lib1(x1_lib),  # the LSTM part only: no 8192 -> 256 projection
                     "sdfa_tpu_torch/csrc/freq_lstm.cu", "sdfa_tpu/ops/pallas_freq_lstm.py:187",
                     primary=rows == K1_ROWS)
        with torch.inference_mode():
            repeats("freq_lstm", freq_lstm.freq_lstm, (x1, *k1_weights),
                    freq_lstm.freq_lstm(x1, *k1_weights))

    lw = [enc.built_layers_9.layer_weights(layer) for layer in range(2)]
    lib2 = library_lstm(256, 256, 2, 2)
    # then a live tick's suffix calls and plot_forward's 100 windows
    for windows in (K2_WINDOWS,) + LIVE_WINDOWS + (K2_PLOT_WINDOWS,):
        x2 = randn(2, windows, 64, 256, scale=0.5)
        x2_lib = x2.transpose(0, 1).contiguous()
        forward_case("bilstm2", bilstm2.bilstm2, bilstm2.bilstm2_plain, (x2, *lw[0], *lw[1]),
                     bilstm2.cost(*x2.shape, 256, lw[0][2] is not None),
                     lambda: lib2(x2_lib), "sdfa_tpu_torch/csrc/bilstm2.cu",
                     "sdfa_tpu/ops/pallas_bilstm2.py:52", primary=windows == K2_WINDOWS,
                     hidden=256)

    # K3 at the kernel phase's 256 windows, a request's 216, a live tick's 128 and 512; its
    # bound reckons the decode
    # in float32 outside the tensor cores and the solve's product in TF32 on them. Then, held
    # to the plain version only: one window, 7, 43, and one more than 256. Every case is
    # launched twice: the K parts are added in a fixed order, so the bits must repeat.
    tp, nf = dsc.p.shape[1:]
    k3_src = ("sdfa_tpu_torch/csrc/decode_solve.cu", "sdfa_tpu/ops/pallas_decode_solve.py:229")
    k3_timed = (K3_WINDOWS, K3_REQUEST_WINDOWS) + LIVE_WINDOWS
    for windows in k3_timed + (1, 7, 43, K3_WINDOWS + 1):
        g3 = torch.Generator().manual_seed(3 if windows == K3_WINDOWS else 300 + windows)
        coef_s = torch.randn(windows, 85, generator=g3).to(dev)
        coef_r = torch.randn(windows, 180, generator=g3).to(dev)
        timed = windows in k3_timed
        with torch.inference_mode():
            got = decode_solve.decode_solve(coef_s, coef_r, dsc)
            torch.cuda.synchronize()
            want = decode_solve.decode_solve_plain(coef_s, coef_r, dsc)
            err = float((got - want).abs().max())
            twice = repeats("decode_solve", decode_solve.decode_solve, (coef_s, coef_r, dsc), got)
            if not timed:
                emit({"phase": "kernel", "name": "decode_solve", "shape": list(got.shape),
                      "max_abs_err": err, "tol": TOL["decode_solve"],
                      "repeats_bit_for_bit": twice, "card": smi})
                if not (err <= TOL["decode_solve"] and bool(torch.isfinite(got).all())):
                    raise RuntimeError(f"decode_solve {windows} windows: {err}")
                continue
            ms = time_ms(lambda: decode_solve.decode_solve(coef_s, coef_r, dsc), 5)
            plain_ms = time_ms(lambda: decode_solve.decode_solve_plain(coef_s, coef_r, dsc), 5)
            # the library column, used by no path: the solve's product (3W x 3T') . (3T' x NF)
            # as one library call in TF32, and in f32
            dt = decode_solve.delta_transforms(coef_s, coef_r, dsc).reshape(3 * windows, 3 * tp)
            p_mat = dsc.p.reshape(3 * tp, nf)
            try:
                torch.backends.cuda.matmul.allow_tf32 = True
                matmul_tf32_ms = time_ms(lambda: dt @ p_mat, 5)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            matmul_f32_ms = time_ms(lambda: dt @ p_mat, 5)
            del dt
        # the decode's operations in float32, the product's in TF32 on the tensor cores
        flops, moved = decode_solve.cost(windows, 85, 180, tp, nf)
        product = 2.0 * windows * 9 * tp * nf
        # no one call computes decode + solve: the library column is the product alone in
        # TF32, the kernel's precision (in f32 beside it)
        record("decode_solve", list(got.shape), err, TOL["decode_solve"], ms, plain_ms,
               flops - product, moved, matmul_tf32_ms,
               *k3_src, primary=windows == K3_WINDOWS, tensor_flops=product,
               bound_peaks="decode: 67 TFLOP/s f32; product: 495 TFLOP/s TF32 tensor cores",
               library_is="the product alone, one TF32 torch.matmul",
               library_f32_ms=matmul_f32_ms,
               repeats_bit_for_bit=twice)

    # K3's full body on the retarget phase's fan-out table (13966 equations) at a request's
    # 216 windows and a live tick's 128 and 512, and on the identity table at the 256 windows
    # of the delta body's row, on the same coefficients as the delta rows; then held to the
    # plain version only at 1, 7 and 43 windows. Every case is launched twice and must repeat
    # bit for bit. Its bound reckons the decode once per triangle in float32 and the folded
    # product as the tensor cores run it, three TF32 products over K = 3T'; beside it the f32
    # reckoning (one product on the FMA units) and the per-equation design's (the decode per
    # equation, three products over K' = 9E'). The yardsticks: the product alone as one f32
    # cuBLAS call over the equations (T_eq @ P, the library column) and over the folded
    # triangles (T @ Pt).
    fan_count, fan_faces, _ = fanout_table(solver.n_tris)
    fan_solver = DeformationSolver(verts, faces, cnst, corr_count=fan_count, corr_faces=fan_faces)
    pca_bases = (model.scale_pca.compT.detach(), model.scale_pca.means.detach(),
                 model.rotat_pca.compT.detach(), model.rotat_pca.means.detach())
    full_src = ("sdfa_tpu_torch/csrc/decode_solve.cu", "sdfa_tpu/ops/pallas_decode_solve.py:201")
    for table, fsc_solver, timed, checked in (
            ("fanout", fan_solver, (K3_REQUEST_WINDOWS,) + LIVE_WINDOWS, (1, 7, 43)),
            ("identity", solver, (K3_WINDOWS,), ())):
        fsc = decode_solve.prep_full_consts(*pca_bases, fsc_solver, dev)
        tp, (ep, nf) = fsc.basis_s.shape[2], fsc.p.shape[1:]
        for windows in timed + checked:
            g3 = torch.Generator().manual_seed(3 if windows == K3_WINDOWS else 300 + windows)
            coef_s = torch.randn(windows, 85, generator=g3).to(dev)
            coef_r = torch.randn(windows, 180, generator=g3).to(dev)
            with torch.inference_mode():
                got = decode_solve.decode_solve_full(coef_s, coef_r, fsc)
                torch.cuda.synchronize()
                want = decode_solve.decode_solve_full_plain(coef_s, coef_r, fsc)
                err = float((got - want).abs().max())
                twice = repeats("decode_solve_full", decode_solve.decode_solve_full,
                                (coef_s, coef_r, fsc), got)
                if not bool(torch.isfinite(got).all()):
                    raise RuntimeError(f"decode_solve_full {table} {windows} windows: non-finite")
                if windows not in timed:
                    emit({"phase": "kernel", "name": "decode_solve_full", "table": table,
                          "shape": list(got.shape), "max_abs_err": err,
                          "tol": TOL["decode_solve_full"], "repeats_bit_for_bit": twice,
                          "card": smi})
                    if not err <= TOL["decode_solve_full"]:
                        raise RuntimeError(f"decode_solve_full {windows} windows: {err}")
                    continue
                ms = time_ms(lambda: decode_solve.decode_solve_full(coef_s, coef_r, fsc), 5)
                plain_ms = time_ms(lambda: decode_solve.decode_solve_full_plain(coef_s, coef_r,
                                                                                fsc), 5)
                t_eq = decode_solve.equation_transforms(coef_s, coef_r, fsc).reshape(
                    3 * windows, 3 * ep)
                p_mat = fsc.p.reshape(3 * ep, nf)
                library_ms = time_ms(lambda: t_eq @ p_mat, 5)
                del t_eq
                t_tri = decode_solve.transforms(coef_s, coef_r, fsc).reshape(3 * windows, 3 * tp)
                pt_mat = (fsc.b_t[0, :nf] + fsc.b_t[1, :nf]).T.contiguous()
                library_folded_ms = time_ms(lambda: t_tri @ pt_mat, 5)
                del t_tri, pt_mat
                # the kernel and the plain version against the float64 decode, gather, product
                f64 = fsc._replace(**{k: getattr(fsc, k).double() for k in (
                    "basis_s", "means_s", "basis_r", "means_r", "p")})
                exact = decode_solve.decode_solve_full_plain(coef_s.double(), coef_r.double(),
                                                             f64)
                f64_err = {"kernel": float((got.double() - exact).abs().max()),
                           "plain": float((want.double() - exact).abs().max()),
                           "tol": FULL_F64_TOL_M}
                del f64, exact
                if not f64_err["kernel"] <= FULL_F64_TOL_M:
                    raise RuntimeError(f"decode_solve_full {table} {windows} windows vs float64: "
                                       f"{f64_err}")
            split = kernel_split(lambda: decode_solve.decode_solve_full(coef_s, coef_r, fsc),
                                 names=K3_FULL_PARTS)
            flops, moved = decode_solve.cost_full(windows, 85, 180, tp, nf)
            product = 2.0 * windows * 9 * tp * nf
            eq_flops, eq_moved = cost_full_per_equation(windows, 85, 180, tp, ep, nf)
            eq_product = 2.0 * windows * 9 * ep * nf
            record("decode_solve_full", list(got.shape), err, TOL["decode_solve_full"], ms,
                   plain_ms, flops - 3 * product, moved, library_ms, *full_src,
                   primary=table == "fanout" and windows == K3_REQUEST_WINDOWS,
                   tensor_flops=3 * product, table=table, n_eqs=fsc_solver.n_eqs,
                   f32_bound_ms=bound(flops - 2 * product, moved)[0],
                   bound_ms_per_equation=bound(eq_flops - 3 * eq_product, eq_moved,
                                               3 * eq_product)[0],
                   library_folded_ms=library_folded_ms, split_ms=split,
                   max_abs_m_vs_f64=f64_err,
                   bound_peaks="decode: 67 TFLOP/s f32; product: 3 TF32 passes at 495 TFLOP/s "
                               "(f32_bound_ms: one product at 67 TFLOP/s f32; "
                               "bound_ms_per_equation: a decode per equation and "
                               "3 TF32 passes over 9E')",
                   library_is="the f32 cuBLAS product alone over the equations "
                              "(library_folded_ms: over the folded triangles)",
                   repeats_bit_for_bit=twice)
        del fsc
    del fan_solver
    torch.cuda.empty_cache()

    for n_in, layer in ((256, 0), (512, 1)):  # the stack's first layer, then a deeper one
        x4 = randn(4 + layer, K4_ROWS, 64, n_in, scale=0.5)
        lib4, x4_lib = library_lstm(n_in, 256, 1, 4 + layer), x4.transpose(0, 1).contiguous()
        forward_case("bilstm_layer", bilstm_layer.bilstm_layer, bilstm_layer.bilstm_layer_plain,
                     (x4, *lw[layer]), bilstm_layer.cost(*x4.shape, 256, lw[layer][2] is not None),
                     lambda: lib4(x4_lib), "sdfa_tpu_torch/csrc/bilstm_layer.cu",
                     "sdfa_tpu/ops/pallas_bilstm.py:42", primary=layer == 0, hidden=256)

    # K4 and K2 at H = 128, clusters of four blocks: K4 at the spec_variants phase's shapes
    # (V1's FreqLstm "last" over a 3 s request's 768 frames; V2's LSTM2d over its 216
    # windows, the frequency layer then the time layer), K2 at 256 windows of a 256-wide
    # input; seeded weights at PyTorch's LSTM scale, cuDNN's nn.LSTM at the same shapes
    def h128_weights(seed, n_in, bias=True):
        return (randn(seed, 2, n_in, 512, scale=128 ** -0.5),
                randn(seed + 1, 2, 128, 512, scale=128 ** -0.5),
                randn(seed + 2, 2, 512, scale=0.1) if bias else None)

    for i, (rows, steps, n_in) in enumerate(K4_H128_SHAPES):
        x4 = randn(70 + i, rows, steps, n_in, scale=0.5)
        lib4, x4_lib = library_lstm(n_in, 128, 1, 70 + i), x4.transpose(0, 1).contiguous()
        forward_case("bilstm_layer", bilstm_layer.bilstm_layer, bilstm_layer.bilstm_layer_plain,
                     (x4, *h128_weights(71 + i, n_in)), bilstm_layer.cost(rows, steps, n_in, 128),
                     lambda: lib4(x4_lib),
                     "sdfa_tpu_torch/csrc/bilstm_layer.cu", "sdfa_tpu/ops/pallas_bilstm.py:42",
                     primary=False, hidden=128)
        del x4, x4_lib, lib4
    x2 = randn(80, K2_WINDOWS, 64, 256, scale=0.5)
    lib2, x2_lib = library_lstm(256, 128, 2, 80), x2.transpose(0, 1).contiguous()
    forward_case("bilstm2", bilstm2.bilstm2, bilstm2.bilstm2_plain,
                 (x2, *h128_weights(81, 256), *h128_weights(84, 256)),
                 bilstm2.cost(*x2.shape, 128),
                 lambda: lib2(x2_lib), "sdfa_tpu_torch/csrc/bilstm2.cu",
                 "sdfa_tpu/ops/pallas_bilstm2.py:52", primary=False, hidden=128)
    del x2, x2_lib, lib2

    # K4 and K2 at ragged shapes, held to the plain versions only: one row, a partial row
    # tile, the request's 216 windows, a second row chunk (257 rows at T = 64); T = 1 and 3;
    # an input width that is no multiple of the projection's K tile; with and without bias
    def ragged_case(name, kernel, plain, args):
        with torch.inference_mode():
            got = kernel(*args)
            torch.cuda.synchronize()
            err = float((got - plain(*args)).abs().max())
        emit({"phase": "kernel", "name": name, "shape": list(args[0].shape),
              "hidden": args[2].shape[1], "gate_bias": args[3] is not None,
              "max_abs_err": err, "tol": TOL[name], "card": smi})
        if not (err <= TOL[name] and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"{name} {tuple(args[0].shape)}: {err} > {TOL[name]}")

    def layer_weights(seed, n_in, bias):
        return (randn(seed, 2, n_in, 1024, scale=1 / 16),
                randn(seed + 1, 2, 256, 1024, scale=1 / 16),
                randn(seed + 2, 2, 1024, scale=0.1) if bias else None)

    for i, (rows, steps, n_in, bias) in enumerate((
            (1, 1, 100, True), (7, 3, 256, False), (216, 64, 512, True), (257, 64, 100, False),
            (257, 3, 512, True), (1, 64, 256, False), (7, 1, 512, True), (216, 3, 100, False))):
        first = (randn(60 + 10 * i, rows, steps, n_in, scale=0.5),
                 *layer_weights(61 + 10 * i, n_in, bias))
        ragged_case("bilstm_layer", bilstm_layer.bilstm_layer, bilstm_layer.bilstm_layer_plain,
                    first)
        ragged_case("bilstm2", bilstm2.bilstm2, bilstm2.bilstm2_plain,
                    first + layer_weights(64 + 10 * i, 512, bias))
    # the same at H = 128, where a chunk is 1024 rows at T = 32 and 512 at T = 64: one row,
    # a partial row tile, one row more than a chunk at each, an input width off the K tile
    for i, (rows, steps, n_in, bias) in enumerate((
            (1, 1, 64, True), (7, 3, 256, False), (1025, 32, 64, True), (513, 64, 100, False),
            (33, 32, 512, True))):
        first = (randn(260 + 10 * i, rows, steps, n_in, scale=0.5),
                 *h128_weights(261 + 10 * i, n_in, bias))
        ragged_case("bilstm_layer", bilstm_layer.bilstm_layer, bilstm_layer.bilstm_layer_plain,
                    first)
        ragged_case("bilstm2", bilstm2.bilstm2, bilstm2.bilstm2_plain,
                    first + h128_weights(264 + 10 * i, 256, bias))

    # K1 at ragged shapes, held to the plain version only and launched twice (the slabs of the
    # output projection are added in a fixed order): one row; a partial row tile; one row more
    # than a tile; one row more than a wave of resident clusters, which is also a second row
    # chunk at F = 32; F = 1 and F = 3; an input width that is no multiple of 4; with and
    # without gate bias and b_proj
    wave_rows = k1_clusters // 2 * freq_lstm.ROW_TILE
    for i, (rows, n_freq, n_in, bias) in enumerate((
            (1, 32, 64, True), (7, 3, 64, False), (freq_lstm.ROW_TILE + 1, 32, 100, True),
            (wave_rows + 1, 32, 64, False), (216, 1, 64, True), (257, 3, 100, False),
            (wave_rows + 1, 1, 100, True))):
        args = (randn(160 + 10 * i, rows, n_freq, n_in),
                randn(161 + 10 * i, 2, n_in, 512, scale=n_in ** -0.5),
                randn(162 + 10 * i, 2, 128, 512, scale=128 ** -0.5),
                randn(163 + 10 * i, 2, 512, scale=0.1) if bias else None,
                randn(164 + 10 * i, n_freq * 256, 256, scale=0.02),
                randn(165 + 10 * i, 256, scale=0.1) if bias else None)
        ragged_case("freq_lstm", freq_lstm.freq_lstm, freq_lstm.freq_lstm_plain, args)
        with torch.inference_mode():
            repeats("freq_lstm", freq_lstm.freq_lstm, args, freq_lstm.freq_lstm(*args))

    # The wide step loop (H = 384 and up), and K1 at H = 256 and other output widths, at the
    # wide_variants phase's shapes (WIDE_K1, WIDE_K2, WIDE_K4): seeded weights at PyTorch's
    # LSTM scale, cuDNN's nn.LSTM at the same widths as the yardstick; then, held to the plain
    # versions only, shapes that reach the edges of the wide tiling: one row, a partial row
    # tile, one row more than one cooperative launch takes, an input width off the K tile, H =
    # 640, H = 1024; K1 at an output width that is no multiple of 4 (scalar loads and stores),
    # one that is no multiple of the 128-column tile, and one row more than a wave at H = 384.
    # Each wide row is also split by kernel (kernel_split).
    def lstm_weights(seed, n_in, hid, bias=True):
        return (randn(seed, 2, n_in, 4 * hid, scale=hid ** -0.5),
                randn(seed + 1, 2, hid, 4 * hid, scale=hid ** -0.5),
                randn(seed + 2, 2, 4 * hid, scale=0.1) if bias else None)

    def k1_args(seed, rows, n_freq, n_in, hid, out_dim, bias=True):
        return (randn(seed, rows, n_freq, n_in), *lstm_weights(seed + 1, n_in, hid, bias),
                randn(seed + 4, n_freq * 2 * hid, out_dim, scale=0.02),
                randn(seed + 5, out_dim, scale=0.1) if bias else None)

    k1_src = ("sdfa_tpu_torch/csrc/freq_lstm.cu", "sdfa_tpu/ops/pallas_freq_lstm.py:187")
    for i, (hid, out_dim) in enumerate(WIDE_K1):
        args = k1_args(400 + 10 * i, K1_REQUEST_ROWS, 32, 64, hid, out_dim)
        lib1w, x_lib = library_lstm(64, hid, 1, 400 + i), args[0].transpose(0, 1).contiguous()
        forward_case("freq_lstm", freq_lstm.freq_lstm, freq_lstm.freq_lstm_plain, args,
                     freq_lstm.cost(*args[0].shape, hid, out_dim), lambda: lib1w(x_lib), *k1_src,
                     primary=False, hidden=hid, out=out_dim,
                     split_ms=kernel_split(lambda: freq_lstm.freq_lstm(*args)))
        with torch.inference_mode():
            repeats("freq_lstm", freq_lstm.freq_lstm, args, freq_lstm.freq_lstm(*args))
        del args, lib1w, x_lib
    for i, (hid, n_in) in enumerate(WIDE_K2):
        x2 = randn(430 + i, K3_REQUEST_WINDOWS, 64, n_in, scale=0.5)
        lib2w, x_lib = library_lstm(n_in, hid, 2, 430 + i), x2.transpose(0, 1).contiguous()
        args2 = (x2, *lstm_weights(431 + i, n_in, hid), *lstm_weights(434, 2 * hid, hid))
        forward_case("bilstm2", bilstm2.bilstm2, bilstm2.bilstm2_plain, args2,
                     bilstm2.cost(*x2.shape, hid), lambda: lib2w(x_lib),
                     "sdfa_tpu_torch/csrc/bilstm2.cu", "sdfa_tpu/ops/pallas_bilstm2.py:52",
                     primary=False, hidden=hid,
                     split_ms=kernel_split(lambda: bilstm2.bilstm2(*args2)))
        del x2, args2, lib2w, x_lib
    for i, (hid, n_in) in enumerate(WIDE_K4):
        x4 = randn(440 + i, K3_REQUEST_WINDOWS, 64, n_in, scale=0.5)
        lib4w, x_lib = library_lstm(n_in, hid, 1, 440 + i), x4.transpose(0, 1).contiguous()
        args4 = (x4, *lstm_weights(441 + i, n_in, hid))
        split = kernel_split(lambda: bilstm_layer.bilstm_layer(*args4))
        forward_case("bilstm_layer", bilstm_layer.bilstm_layer, bilstm_layer.bilstm_layer_plain,
                     args4, bilstm_layer.cost(*x4.shape, hid),
                     lambda: lib4w(x_lib), "sdfa_tpu_torch/csrc/bilstm_layer.cu",
                     "sdfa_tpu/ops/pallas_bilstm.py:42", primary=False, hidden=hid,
                     split_ms=split)
        del x4, args4, lib4w, x_lib
    layer_wave = bilstm_layer.wide_wave_rows(384, wide_blocks["bilstm_layer"])
    for i, (rows, steps, n_in, hid, bias) in enumerate((
            (1, 1, 100, 384, True), (33, 3, 1000, 512, False), (layer_wave + 1, 2, 384, 384, True),
            (7, 5, 64, 640, False), (9, 3, 64, 1024, True))):
        first = (randn(460 + 10 * i, rows, steps, n_in, scale=0.5),
                 *lstm_weights(461 + 10 * i, n_in, hid, bias))
        ragged_case("bilstm_layer", bilstm_layer.bilstm_layer, bilstm_layer.bilstm_layer_plain,
                    first)
        ragged_case("bilstm2", bilstm2.bilstm2, bilstm2.bilstm2_plain,
                    first + lstm_weights(464 + 10 * i, 2 * hid, hid, bias))
    k1_wave = bilstm_layer.wide_wave_rows(384, k1_tiling["wide"])
    for i, (rows, n_freq, n_in, hid, out_dim, bias) in enumerate((
            (5, 32, 64, 256, 201, True), (k1_wave + 1, 2, 64, 384, 200, False),
            (33, 3, 100, 512, 384, True), (1, 1, 64, 256, 7, False))):
        args = k1_args(500 + 10 * i, rows, n_freq, n_in, hid, out_dim, bias)
        ragged_case("freq_lstm", freq_lstm.freq_lstm, freq_lstm.freq_lstm_plain, args)
        with torch.inference_mode():
            repeats("freq_lstm", freq_lstm.freq_lstm, args, freq_lstm.freq_lstm(*args))

    mark("setup_and_kernels_k1_to_wide")
    # The input projection alone (proj_kernel, 3xTF32 on the tensor cores) at every
    # instantiation on the path's shapes (proj_row_specs): its device ms from torch.profiler's
    # split of the kernel that runs it (the product and the staging of w_ih before it), beside its
    # bound (3xTF32 at 495 TFLOP/s; one f32 product at 67 in f32_bound_ms), the f32 cuBLAS product
    # of the same operands, its plain version (projection_tiled), and the projection launched
    # alone (bilstm_layer.projection) against the plain version and a float64 product
    for i, spec in enumerate(proj_row_specs()):
        label, host, hid, shape, _ = spec
        call, layers = proj_row_call(spec, (freq_lstm, bilstm2, bilstm_layer), dev, 600 + i)
        split = kernel_split(call)
        product_ms = split["input_projection"]
        staging_ms = split.get("input_projection_staging", 0.0)
        err = rel = 0.0
        with torch.inference_mode():
            for x, w, g in layers:
                got = bilstm_layer.projection(x, w, g)
                err = max(err, float((got - bilstm_layer.projection_tiled(x, w, g)).abs().max()))
                exact = torch.stack([x.double() @ w[d].double() for d in range(2)])
                exact += g.double()[:, None, None]
                rel = max(rel, float((got.double() - exact).abs().max() / exact.abs().max()))
                del got, exact
            plain_ms = time_ms(lambda: [bilstm_layer.projection_tiled(*op) for op in layers], 2)
            library_ms = time_ms(lambda: [torch.matmul(x.reshape(-1, x.shape[-1]), w)
                                          for x, w, _ in layers], 5)
        flops, moved = proj_cost(layers)
        bound_ms, bound_by = bound(0.0, moved, 3 * flops)
        line = {"row": label, "in_kernel": host, "shape": list(shape), "hidden": hid,
                "layers": len(layers), "ms": product_ms + staging_ms, "product_ms": product_ms,
                "staging_ms": staging_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "f32_bound_ms": bound(flops, moved)[0], "library_ms": library_ms,
                "plain_ms": plain_ms, "max_abs_err": err, "max_rel_vs_f64": rel,
                "gflop": flops / 1e9, "mbytes": moved / 1e6}
        emit({"phase": "kernel", "name": f"proj_kernel<{proj_instance(hid)}>", **line,
              "split_ms": split,
              "ms_is": "device ms of proj_kernel + proj_weights_kernel in the torch.profiler split",
              "bound_peaks": "3 TF32 passes at 495 TFLOP/s (f32_bound_ms: one at 67 TFLOP/s f32)",
              "library_is": "f32 torch.matmul of x (rows T, in) by w_ih (2, in, 4H), each layer",
              "card": smi})
        if not (err <= TOL["bilstm_layer"] and rel <= PROJ_F64_REL):
            raise RuntimeError(f"proj_kernel {label}: {err} from its plain version, {rel} of the "
                               f"largest |xp| from float64")
        report[host].setdefault("proj_kernel", []).append(line)
        del call, layers
    torch.cuda.empty_cache()

    mark("projection_rows")
    # K1's output projection alone (out_parts_kernel + out_sum_kernel, 3xTF32 on the tensor
    # cores) at every K1 shape of the path (outproj_row_specs): its device ms from torch.profiler's
    # split of the K1 call, beside its bound (3xTF32 at 495 TFLOP/s; one f32 product at 67 in
    # f32_bound_ms), the f32 cuBLAS torch.addmm of the same operands, its plain version
    # (output_projection_tiled), and the projection launched alone (output_projection) on an h
    # of the kernel's shape against the plain walk, a float64 product and itself (the same bits)
    for i, spec in enumerate(outproj_row_specs()):
        label, hid, rows, out_dim = spec
        call, (h, w_p, b_p) = outproj_row_call(spec, freq_lstm, dev, 700 + i)
        split = kernel_split(call)
        with torch.inference_mode():
            got = freq_lstm.output_projection(h, w_p, b_p)
            torch.cuda.synchronize()
            err = float((got - freq_lstm.output_projection_tiled(h, w_p, b_p)).abs().max())
            exact = torch.addmm(b_p.double(), h.double(), w_p.double())
            rel = float((got.double() - exact).abs().max() / exact.abs().max())
            del exact
            twice = repeats("output_projection", freq_lstm.output_projection, (h, w_p, b_p), got)
            plain_ms = time_ms(lambda: freq_lstm.output_projection_tiled(h, w_p, b_p), 2)
            library_ms = time_ms(lambda: torch.addmm(b_p, h, w_p), 20)
        flops = 2.0 * h.numel() * out_dim
        moved = 4.0 * (h.numel() + w_p.numel() + out_dim + rows * out_dim)
        bound_ms, bound_by = bound(0.0, moved, 3 * flops)
        line = {"row": label, "shape": [rows, h.shape[1], out_dim], "hidden": hid,
                "ms": split["output_projection"], "bound_ms": bound_ms, "bound_by": bound_by,
                "f32_bound_ms": bound(flops, moved)[0], "library_ms": library_ms,
                "plain_ms": plain_ms, "max_abs_err": err, "max_rel_vs_f64": rel,
                "repeats_bit_for_bit": twice, "gflop": flops / 1e9, "mbytes": moved / 1e6}
        emit({"phase": "kernel", "name": "out_parts_kernel", **line, "split_ms": split,
              "ms_is": "device ms of out_parts_kernel + out_sum_kernel in the torch.profiler "
                       "split of the K1 call",
              "bound_peaks": "3 TF32 passes at 495 TFLOP/s (f32_bound_ms: one at 67 TFLOP/s f32)",
              "library_is": "f32 torch.addmm(b_proj, h, w_proj), h (rows, F 2H)",
              "card": smi})
        if not (err <= TOL["freq_lstm"] and rel <= PROJ_F64_REL):
            raise RuntimeError(f"out_parts_kernel {label}: {err} from its plain version, {rel} of "
                               f"the largest |out| from float64")
        report["freq_lstm"].setdefault("output_projection", []).append(line)
        del call, h, w_p, b_p, got
    torch.cuda.empty_cache()

    mark("output_projection_rows")
    # K5 at the train step's two shapes (the FreqLstm core first: it is the larger), then,
    # held to the plain version only, ragged shapes that reach every edge of the cluster
    # tiling at both widths: one row; a partial row tile with T = 2 (the double buffers'
    # first turn); T = 1 (no exchange at all) at one row more than a tile; one row more than
    # one wave of resident clusters; T = 64 at 100 rows. Every case also launches the
    # backward twice on the same inputs: the partial sums are added in a fixed order, so
    # the two results must be equal bit for bit.
    core_src = "sdfa_tpu_torch/csrc/bilstm_core.cu"
    cases = [(32, 6400, 128, 64), (64, 100, 256, 256), (3, 1061, 256, 0), (5, 7, 128, 0)]
    for hid, tile in bilstm_core.ROW_TILE.items():
        wave_tiles = min(core_clusters[f"{hid}_fwd"], core_clusters[f"{hid}_bwd"]) // 2
        cases += [(3, 1, hid, 0), (2, 7, hid, 0), (1, tile + 1, hid, 0),
                  (3, wave_tiles * tile + 1, hid, 0)]
    cases.append((64, 100, 128, 0))  # at H = 256 this is a timed shape already
    # timed too: a rank's shapes in a two-rank step of 100 windows (50 each)
    cases += [(32, 3200, 128, 64), (64, 50, 256, 256)]
    # the wide step loop at the wide_variants phase's train step shapes (timed), then its edges
    # (held to the plain version): one row; T = 2 at a partial row tile; T = 1; one row more
    # than one cooperative launch takes at H = 384 and 512; H = 640 (40 runs of 16 units);
    # H = 1024 (64 runs)
    core_blocks = min(wide_blocks["bilstm_core_fwd"], wide_blocks["bilstm_core_bwd"])
    cases += list(WIDE_K5) + [(3, 1, 384, 0), (2, 7, 512, 0), (1, 33, 384, 0),
                              (3, bilstm_layer.wide_wave_rows(384, core_blocks) + 1, 384, 0),
                              (2, bilstm_layer.wide_wave_rows(512, core_blocks) + 1, 512, 0),
                              (2, 40, 640, 0), (2, 9, 1024, 0)]

    def core_case(steps, rows, hid, n_in):  # a function: its tensors go when it returns
        timed = n_in > 0
        xp = randn(50 + hid, 2, steps, rows, 4 * hid, scale=0.5).requires_grad_()
        w_core = randn(51 + hid, 2, hid, 4 * hid, scale=hid ** -0.5).requires_grad_()
        dout = randn(52 + hid, steps, rows, 2 * hid)
        out = bilstm_core.bilstm_core(xp, w_core)
        torch.cuda.synchronize()
        got_g = torch.autograd.grad(out, (xp, w_core), dout)
        torch.cuda.synchronize()
        ref = bilstm_core.bilstm_core_plain(xp, w_core)
        ref_g = torch.autograd.grad(ref, (xp, w_core), dout)
        err_f = float((out - ref).detach().abs().max())
        err_b = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                    for a, b in zip(got_g, ref_g))
        xp_d, w_d = xp.detach(), w_core.detach()
        with torch.no_grad():
            _, gates, cs = bilstm_core._forward_kernel(xp_d, w_d)
            again = bilstm_core._backward_kernel(gates, cs, w_d, dout)
            repeats = (torch.equal(again, got_g[0]) and
                       torch.equal(again, bilstm_core._backward_kernel(gates, cs, w_d, dout)))
        if not repeats:
            raise RuntimeError(f"bilstm_core backward {(steps, rows, hid)}: two launches on the "
                               "same inputs differ")
        if not timed:
            emit({"phase": "kernel", "name": "bilstm_core", "shape": [steps, rows, hid],
                  "fwd_max_abs_err": err_f, "bwd_max_rel_err": err_b,
                  "bwd_repeats_bit_for_bit": repeats, "card": smi})
            if not (err_f <= TOL["bilstm_core_fwd"] and err_b <= BWD_REL_TOL):
                raise RuntimeError(f"bilstm_core {(steps, rows, hid)}: {err_f}, {err_b}")
            return
        del ref, ref_g, got_g
        lib5 = library_lstm(n_in, hid, 1, 5).train()
        x5 = randn(53, steps, rows, n_in, scale=0.5).requires_grad_()
        with torch.no_grad():
            fwd_ms = time_ms(lambda: bilstm_core.bilstm_core(xp_d, w_d), 5)
            plain_fwd_ms = time_ms(lambda: bilstm_core.bilstm_core_plain(xp_d, w_d), 3)
            bwd_ms = time_ms(lambda: bilstm_core._backward_kernel(gates, cs, w_d, dout), 5)
            dw_ms = time_ms(lambda: bilstm_core.dw_hh(out.detach(), gates), 5)
        lib_fwd_ms = time_ms(lambda: lib5(x5), 5)
        plain_bwd_ms = time_backward_ms(lambda: bilstm_core.bilstm_core_plain(xp, w_core),
                                        (xp, w_core), dout, 2)
        lib_bwd_ms = time_backward_ms(lambda: lib5(x5)[0], (x5, *lib5.parameters()), dout, 3)
        flops, moved = bilstm_core.cost(steps, rows, hid)  # either pass: operands and bytes
        primary = (steps, rows, hid) == (32, 6400, 128)
        wide = {}  # from H = 384 on: the product in 3 TF32 passes; both passes against float64
        if wide_hidden(hid):
            with torch.no_grad():
                ex_out, ex_gates, ex_cs = bilstm_core.forward_steps(xp_d.double(), w_d.double())
                fwd_f64 = float((out.detach().double() - ex_out).abs().max())
                ex_dg = bilstm_core.backward_steps(gates.double(), cs.double(), w_d.double(),
                                                   dout.double())
                bwd_f64 = float((again.double() - ex_dg).abs().max() / ex_dg.abs().max())
                del ex_out, ex_gates, ex_cs, ex_dg
            wide = {"tensor_flops": 3 * flops, "f32_bound_ms": bound(flops, moved)[0],
                    "bound_peaks": "the product: 3 TF32 passes at 495 TFLOP/s (f32_bound_ms: "
                                   "one at 67 TFLOP/s f32)"}
        del again
        record("bilstm_core_fwd", [steps, rows, hid], err_f, TOL["bilstm_core_fwd"], fwd_ms,
               plain_fwd_ms, 0.0 if wide else flops, moved, lib_fwd_ms, core_src,
               "sdfa_tpu/ops/pallas_bilstm_train.py:101", primary, **wide,
               **({"max_abs_vs_f64": fwd_f64} if wide else {}))
        record("bilstm_core_bwd", [steps, rows, hid], err_b, BWD_REL_TOL, bwd_ms, plain_bwd_ms,
               0.0 if wide else flops, moved, lib_bwd_ms, core_src,
               "sdfa_tpu/ops/pallas_bilstm_train.py:198", primary, **wide,
               **({"max_abs_vs_f64": bwd_f64} if wide else {}),
               err_is="max |diff| / max |reference| over d(xp) and d(w_hh)"
                      + ("; max_abs_vs_f64: d(xp)'s, over its largest" if wide else ""),
               dw_hh_library_product_ms=dw_ms, repeats_bit_for_bit=repeats)

    for case in cases:
        core_case(*case)
    torch.cuda.empty_cache()

    mark("kernels_k5")
    # --- the serving path: warm up, then three requests --------------------
    sr = int(hp.audio.sample_rate)
    warm_s = task.warmup(3.0)
    requests = [(signal(3.0, sr, 10 + i), spk) for i, spk in enumerate((0, 3, 6))]
    reset_counts({"freq_lstm": freq_lstm, "bilstm2": bilstm2, "decode_solve": decode_solve})
    outs, walls = [], []
    for sig, spk in requests:
        t0 = time.perf_counter()
        ts, v = task.generate_vertices(sig, spk)
        walls.append(time.perf_counter() - t0)
        outs.append((ts, v))
    launches = read_counts({"freq_lstm": freq_lstm, "bilstm2": bilstm2,
                            "decode_solve": decode_solve}, "serve")
    for (ts, v), (sig, _) in zip(outs, requests):
        if v.shape != (len(ts), FLAME_COUNTS[0], 3) or not np.isfinite(v).all():
            raise RuntimeError(f"bad output: shape {v.shape}, finite {np.isfinite(v).all()}")
    emit({"phase": "serve", "requests": len(requests), "audio_s_each": 3.0,
          "windows": [len(ts) for ts, _ in outs], "warmup_s": warm_s, "wall_s": walls,
          "audio_s_per_s": [3.0 / w for w in walls], "launches": launches, "card": smi})

    # --- the same request through the plain versions, and the f64 oracle ----
    (ts0, v0), (sig0, spk0) = outs[0], requests[0]
    with ops.plain_versions():
        _, v_plain = task.generate_vertices(sig0, spk0)
    plain_err = float(np.abs(v_plain - v0).max())
    sample = sorted({0, len(ts0) // 3, 2 * len(ts0) // 3, len(ts0) - 1})
    with torch.inference_mode():
        frame_idx, _, z, _ = task._overlap_prefix(sig0)
        idx = torch.from_numpy(frame_idx[sample]).long().to(dev)
        spk = torch.full((len(sample),), spk0, dtype=torch.long, device=dev)
        preds, _, _ = model.forward_windows(z, idx, spk, raw_pca=True)
        dgrad = model.decode_to_anime(preds)[:, 0].double().cpu().numpy()
    oracle = np.stack([solver.solve_host(d) for d in dgrad])
    oracle_err = float(np.abs(v0[sample] - oracle).max())
    emit({"phase": "check", "plain_max_abs_m": plain_err, "plain_tol_m": PLAIN_TOL_M,
          "oracle_frames": sample, "oracle_max_abs_m": oracle_err,
          "oracle_tol_m": ORACLE_TOL_M,
          "vertex_range_m": [float(v0.min()), float(v0.max())]})
    if not plain_err <= PLAIN_TOL_M:
        raise RuntimeError(f"kernel path vs plain path: {plain_err} m > {PLAIN_TOL_M}")
    if not oracle_err <= ORACLE_TOL_M:
        raise RuntimeError(f"kernel path vs float64 oracle: {oracle_err} m > {ORACLE_TOL_M}")

    # --- live serving: every wire, ensembling, a session, the server, the TCP service ---
    counters = {"freq_lstm": freq_lstm, "bilstm2": bilstm2, "decode_solve": decode_solve}
    path_launches = {"serve": dict(launches)}
    path_launches["wires"] = wires_phase(task, counters, sig0, spk0, v0, sample, oracle, smi)
    path_launches["session"] = session_phase(task, counters, sig0, spk0, ts0, v0, smi)
    path_launches["server"] = server_phase(task, counters, sr, smi)
    path_launches["tcp"] = tcp_phase(task, counters, sr, smi)

    if "--profile" in sys.argv[1:]:
        profile_serving(task, requests, sorted(walls)[1] * 1e3, smi)
        profile_server_tick(task, sr, smi)
        profile_step_clocks(build, dev, smi)
        profile_core_tiles(build, dev, smi)
        profile_serving_tiles(build, dev, smi, k1_weights, dsc)
        profile_full_sums(build, dev, smi, pca_bases, (verts, faces, cnst))

    mark("serve_and_live")
    # --- K4's path: a stack that is not 2 layers deep serves through bilstm_layer ---
    hp1 = configure("dgrad")
    hp1.model.audio_encoder.set_key("layers", [
        ("lstm", 256, 256, "num_layers=1", "bidirectional=True") if spec[0] == "lstm"
        else spec for spec in hp1.model.audio_encoder.layers])
    task1 = AnimationTask(hp1, init_params(build_model(hp1, pca=pca), SEED), dev)
    task1._decode = task._decode  # same template, same PCA bases
    sig1 = signal(1.0, sr, 20)
    task1.generate_vertices(sig1, 2)  # warm-up
    bilstm_layer.LAUNCHES.clear()
    t0 = time.perf_counter()
    ts1, v1 = task1.generate_vertices(sig1, 2)
    wall1 = time.perf_counter() - t0
    launches["bilstm_layer"] = launched(bilstm_layer)
    path_launches["k4_path"] = {"bilstm_layer": launches["bilstm_layer"]}
    with ops.plain_versions():
        _, v1_plain = task1.generate_vertices(sig1, 2)
    k4_err = float(np.abs(v1 - v1_plain).max())
    emit({"phase": "k4_path", "audio_s": 1.0, "windows": len(ts1), "wall_s": wall1,
          "launches": launches["bilstm_layer"], "plain_max_abs_m": k4_err,
          "plain_tol_m": PLAIN_TOL_M, "card": smi})
    if launches["bilstm_layer"] < 1:
        raise RuntimeError("the 1-layer stack did not launch bilstm_layer")
    if v1.shape != (len(ts1), FLAME_COUNTS[0], 3) or not np.isfinite(v1).all():
        raise RuntimeError(f"k4 path: bad output {v1.shape}")
    if not k4_err <= PLAIN_TOL_M:
        raise RuntimeError(f"k4 path, kernels vs plain versions: {k4_err} m > {PLAIN_TOL_M}")
    del task1

    # --- the training path: Trainer.train() for 5 steps at full width ----------
    hp_t = configure("dgrad")
    hp_t.trainer.set_key("max_epochs", 1)
    hp_t.trainer.set_key("save_gap_epochs", 1)
    batches = train_batches(TRAIN_STEPS)
    with tempfile.TemporaryDirectory(prefix="sdfa_chip_smoke_") as tmp:
        def experiment(name, **kw):
            return Experiment(hp_t, build_model(hp_t, pca=pca), os.path.join(tmp, name), dev,
                              seed=SEED, **kw)

        # one step on a throwaway experiment warms up the allocator and the libraries,
        # and is the kernel side of the kernel-vs-plain comparison below
        warm = experiment("warm")
        m_kernel = warm.train_step(batches[0])
        g_kernel = {n: p.grad.clone() for n, p in warm.model.named_parameters()}
        torch.cuda.synchronize()
        del warm

        exp = experiment("run")
        before = {k: v.clone() for k, v in exp.model.state_dict().items()}
        stamps = []

        def timed_loader():
            # the Trainer asks for the next batch between steps: a synchronize there
            # brackets each step, upload and host work included
            for batch in batches:
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                yield batch
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(exp, timed_loader())
        trainer.train()
        launches["bilstm_core_fwd"] = bilstm_core.FWD_LAUNCHES
        launches["bilstm_core_bwd"] = bilstm_core.BWD_LAUNCHES
        path_launches["train"] = {k: launches[k] for k in ("bilstm_core_fwd", "bilstm_core_bwd")}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
        for i, m in enumerate(trainer.step_metrics):
            bad = [k for k, v in m.items() if not np.isfinite(v)]
            if bad:
                raise RuntimeError(f"train step {i}: non-finite {bad}")
        if (launches["bilstm_core_fwd"], launches["bilstm_core_bwd"]) != (3 * TRAIN_STEPS,) * 2:
            raise RuntimeError(f"bilstm_core launches {launches}, expected {3 * TRAIN_STEPS} each")
        after = exp.model.state_dict()
        unchanged = [n for n, p in exp.model.named_parameters() if torch.equal(before[n], p)]
        if unchanged:
            raise RuntimeError(f"parameters did not change: {unchanged}")
        loaded = experiment("reload", load_from=checkpoints.latest_checkpoint(exp.log_dir))
        got_state, got_opt = loaded.model.state_dict(), loaded.optimizer.state_dict()["state"]
        same = (all(torch.equal(got_state[k], v) for k, v in after.items())
                and all(torch.equal(got_opt[i][k], v)
                        for i, slot in exp.optimizer.state_dict()["state"].items()
                        for k, v in slot.items())
                and all(torch.equal(a, b) for n in exp.scalers
                        for a, b in zip(loaded.scalers[n], exp.scalers[n]))
                and (loaded.step, loaded.epoch) == (exp.step, exp.epoch) == (TRAIN_STEPS, 1))
        if not same:
            raise RuntimeError("the reloaded checkpoint differs from the state saved")
        del loaded

        plain = experiment("plain")
        with ops.plain_versions():
            m_plain = plain.train_step(batches[0])
        loss_rel = abs(float(m_kernel["total"]) - float(m_plain["total"])) / abs(
            float(m_plain["total"]))
        # A gradient that is zero but for rounding (the weight-norm gain of a conv whose
        # output goes through BatchNorm, the attention query under a near-uniform softmax)
        # differs by 1e-3 of its own size between two runs of the SAME path, so every
        # parameter is held to the largest gradient of the model, and the recurrent
        # layers' own parameters, which the kernels produce, to their own size as well.
        def own_size_diffs(grads):
            """max |kernel − other| per parameter, and the same over its own max |value|."""
            diffs = {n: float((g_kernel[n] - g).abs().max()) for n, g in grads.items()}
            return diffs, {n: diffs[n] / max(float(g.abs().max()), 1e-30)
                           for n, g in grads.items()}

        g_plain = {n: p.grad for n, p in plain.model.named_parameters()}
        g_max = max(float(g.abs().max()) for g in g_plain.values())
        diffs, own = own_size_diffs(g_plain)
        grad_rel = max(diffs.values()) / g_max
        lstm_rel = max(v for n, v in own.items()
                       if n.rpartition(".")[2].startswith(("w_ih", "w_hh", "b_ih", "b_hh")))
        worst = sorted(own, key=own.get, reverse=True)[:3]
        del plain
        again = experiment("again")  # the kernel path once more: the floor of that measure
        again.train_step(batches[0])
        _, own_again = own_size_diffs({n: p.grad for n, p in again.model.named_parameters()})
        worst_again = max(own_again, key=own_again.get)
        del again
        emit({"phase": "train", "steps": TRAIN_STEPS, "windows_per_step": TRAIN_WINDOWS,
              "step_ms_median": step_ms[len(step_ms) // 2], "step_ms_all": step_ms,
              "windows_per_s": TRAIN_WINDOWS / (step_ms[len(step_ms) // 2] / 1e3),
              "peak_memory_gib": peak_gib, "launches": {k: launches[k] for k in (
                  "bilstm_core_fwd", "bilstm_core_bwd")},
              "first_step": trainer.step_metrics[0], "last_step": trainer.step_metrics[-1],
              "plain_step_loss_rel": loss_rel, "plain_step_grad_vs_largest_gradient": grad_rel,
              "plain_step_lstm_grad_rel": lstm_rel, "largest_gradient": g_max,
              "worst_by_own_size": [{"name": n, "rel": own[n],
                                     "max_abs_gradient": float(g_plain[n].abs().max())}
                                    for n in worst],
              "same_path_twice_worst_by_own_size": {"name": worst_again,
                                                    "rel": own_again[worst_again]},
              "loss_rtol": STEP_LOSS_RTOL, "grad_rtol": STEP_GRAD_RTOL, "card": smi})
        if not loss_rel <= STEP_LOSS_RTOL:
            raise RuntimeError(f"train step, kernels vs plain: loss differs by {loss_rel}")
        if not (grad_rel <= STEP_GRAD_RTOL and lstm_rel <= STEP_GRAD_RTOL):
            raise RuntimeError(f"train step, kernels vs plain: gradients differ by {grad_rel} "
                               f"of the largest gradient, {lstm_rel} on the recurrent layers")

        if "--profile" in sys.argv[1:]:
            profile_train_step(exp, batches, smi, step_ms[len(step_ms) // 2])

    mark("k4_path_and_train")
    # --- training from a dataset on disk, then its checkpoint served; then the CLI on
    #     the same dataset and checkpoint --------------------------------------------
    with tempfile.TemporaryDirectory(prefix="sdfa_chip_data_") as data_tmp:
        path_launches["data_train"], trained = data_train_phase(task, sig0, spk0, solver, dev,
                                                                smi, data_tmp)
        path_launches["cli"] = cli_phase(trained, root, dev, smi)
        path_launches["data_parallel"] = data_parallel_phase(trained, root, dev, smi)
        # --- the JAX package's last modules: StepEnv and its cost count, plot_forward,
        #     the plotting Trainer, the feature registry, the bilateral filter, native ---
        path_launches["last_modules"] = last_modules_phase(
            trained, dict(task=task, sig=sig0, spk=spk0, v=v0, template=(verts, faces, cnst)),
            step_ms[len(step_ms) // 2], dev, smi, data_tmp)
    del trained

    mark("data_train_to_last_modules")
    # --- the offsets model family: served, streamed, then trained from disk and served ---
    path_launches["offsets"] = offsets_phase(dev, sr, smi)
    path_launches["offsets_train"] = offsets_train_phase(dev, smi)

    mark("offsets")
    # --- VOCASET preprocessing, training on its output; retargeting onto a template
    #     with triangle correspondences ------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="sdfa_chip_pre_") as pre_tmp:
        path_launches["preprocess"] = preprocess_phase(root, dev, smi, pre_tmp)
        path_launches["retarget"] = retarget_phase(hp, model, sig0, spk0, v0, dev, sr, smi,
                                                   pre_tmp)
    launches["decode_solve_full"] = path_launches["retarget"]["decode_solve_full"]
    mark("preprocess_and_retarget")
    # --- every layer a spec can name: three variants at the dgrad model's widths -------
    with tempfile.TemporaryDirectory(prefix="sdfa_chip_spec_") as spec_tmp:
        path_launches["spec_variants"] = spec_variants_phase(task, pca, sig0, spk0, solver, dev,
                                                             smi, spec_tmp)
    mark("spec_variants")
    # --- the recurrent stacks widened: H = 256 / 384 / 512 through the wide step loop ---
    with tempfile.TemporaryDirectory(prefix="sdfa_chip_wide_") as wide_tmp:
        path_launches["wide_variants"] = wide_variants_phase(task, pca, sig0, spk0, solver, dev,
                                                             smi, wide_tmp)
    mark("wide_variants")
    # --- the last JAX-only surfaces: N live streams to capacity, a long training run, the
    #     examples and evaluate_torch.sh on its checkpoint ------------------------------
    path_launches["stream_capacity"] = stream_capacity_phase(task, root, smi)
    with tempfile.TemporaryDirectory(prefix="sdfa_chip_longrun_") as long_tmp:
        path_launches["longrun"], longrun = longrun_phase(root, dev, smi, long_tmp)
        path_launches["examples"] = examples_phase(longrun, root, dev, smi, long_tmp)
    mark("stream_capacity_longrun_examples")
    emit({"phase": "seconds_by_part", **{name: t - t0 for (_, t0), (name, t) in
                                         zip(marks, marks[1:])},
          "total": marks[-1][1] - marks[0][1],
          "profiles_lost": collections.Counter(PROFILES_LOST)})
    if ops.PLAIN_ROUTES:
        raise RuntimeError(f"{ops.PLAIN_ROUTES} plain recurrences were taken on the card: a "
                           "path this script drives has a shape no kernel takes")
    check_no_process_left(processes_before)

    kernels = []
    for name, entry in report.items():
        entry["launches"] = launches[name]
        if entry["launches"] < 1:
            raise RuntimeError(f"{name} was never launched on its path")
        entry["launches_by_path"] = {path: counts[name] for path, counts in path_launches.items()
                                     if name in counts}
        kernels.append(entry)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def spec_variant_hparams(name):
    """The dgrad config with the encoder (and, for ``gru_extras``, a scale head)
    of a spec variant, at the shipped widths: the conv stack of
    ``configs/_shared.py:32-46``, 64 channels over 32 bins, the time stack at
    256, the heads 85 / 180."""
    from sdfa_tpu_torch.config import configure

    hp = configure("dgrad")
    hp.trainer.set_key("max_epochs", 1)
    hp.trainer.set_key("save_gap_epochs", None)
    shipped = [tuple(spec) for spec in hp.model.audio_encoder.layers]
    conv, (freq, squeeze, permute, lstm, attn) = shipped[:6], shipped[6:]
    if name == "freq_last_gmm":
        layers = conv + [("freq-lstm", 64, 32, "hidden_size=128", "output_size=256", "mode=last"),
                         squeeze, permute, ("lstm", 256, 256, "num_layers=3", "bidirectional=True"),
                         ("attn", "gmm", 512, 128, 2, "num_k=4")]
    elif name == "lstm2d_prod":
        layers = conv + [("lstm2d", 64, 128, "num_layers=2"), ("permute", (0, 3, 1, 2)),
                         ("flatten", 2), ("fc", 8192, 256), lstm, ("attn", "prod", 512, 128, 2)]
    else:  # gru_extras
        layers = conv + [freq, ("mul-noise",), ("gradx", 0.5), squeeze, permute,
                         ("gru", 256, 256, "num_layers=2", "bidirectional=True"), attn]
        scale = [tuple(spec) for spec in hp.model.output.layers_scale]
        scale[1] = scale[1] + ("prev_activation=lrelu@a:0.2",
                               "prev_batch_norm={'momentum': 0.01, 'eps': 0.001}")
        hp.model.output.set_key("layers_scale", scale)
    hp.model.audio_encoder.set_key("layers", layers)
    return hp


def spec_variants_phase(task_main, pca, sig, spk, solver, dev, smi, tmp):
    """Three models of layers the shipped configs do not use, at the dgrad
    widths, seeded, over the serve phase's template and PCA bases:
    ``freq_last_gmm`` (FreqLstm "last" through K4 at H = 128, a 3-layer time
    stack through K4 at H = 256, GMM attention), ``lstm2d_prod`` (LSTM2d ending
    the per-frame prefix, so run per window through K4 at H = 128; permute /
    flatten / fc 8192 -> 256; K2; dot-product attention) and ``gru_extras``
    (the shipped encoder with ``mul-noise`` and ``gradx`` after FreqLstm, a
    2-layer biGRU through cuDNN, a head fc with pre-layer extras). Each serves
    a 3 s request on the f32 wire against the plain versions and the float64
    host solve, with its launches, wall and device busy ms, then takes
    ``VARIANT_TRAIN_STEPS`` train steps of 100 windows (the first against the
    plain versions' on the same batch); ``freq_last_gmm`` then trains one
    epoch with an aux loader. ``ops.PLAIN_ROUTES`` must stay 0 throughout."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdfa_tpu_torch import ops
    from sdfa_tpu_torch.compat import init_params
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.ops import bilstm2, bilstm_core, bilstm_layer, decode_solve, freq_lstm
    from sdfa_tpu_torch.task import AnimationTask
    from sdfa_tpu_torch.train import Experiment, Trainer

    t_phase = time.perf_counter()
    counted = {"freq_lstm": freq_lstm, "bilstm2": bilstm2, "decode_solve": decode_solve,
               "bilstm_layer": bilstm_layer}

    def reset():
        reset_counts(counted)
        bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0

    def counts():
        out = {name: launched(mod) for name, mod in counted.items()}
        out.update(decode_solve=decode_solve.LAUNCHES["delta"],
                   decode_solve_full=decode_solve.LAUNCHES["full"])
        out.update({f"{name}_h{h}": mod.LAUNCHES[h] for name, mod in (("bilstm2", bilstm2),
                                                                    ("bilstm_layer", bilstm_layer))
                    for h in (128, 256)})
        out.update(bilstm_core_fwd=bilstm_core.FWD_LAUNCHES,
                   bilstm_core_bwd=bilstm_core.BWD_LAUNCHES)
        return out

    # the launches a request must make, and a train step's recurrences through K5
    want = {"freq_last_gmm": ({"bilstm_layer_h128": 1, "bilstm_layer_h256": 3, "decode_solve": 1,
                               "decode_solve_full": 0, "freq_lstm": 0, "bilstm2": 0}, 4),
            "lstm2d_prod": ({"bilstm_layer_h128": 2, "bilstm2_h256": 1, "decode_solve": 1,
                             "decode_solve_full": 0, "freq_lstm": 0}, 4),
            "gru_extras": ({"freq_lstm": 1, "decode_solve": 1, "decode_solve_full": 0,
                            "bilstm2": 0, "bilstm_layer": 0}, 1)}
    batches = train_batches(VARIANT_TRAIN_STEPS)
    path = {}
    for name, (want_request, k5_per_step) in want.items():
        t0 = time.perf_counter()
        hp = spec_variant_hparams(name)
        model = init_params(build_model(hp, pca=pca), SEED)
        task = AnimationTask(hp, model, dev)
        task._decode = task_main._decode  # the same template and PCA bases
        task.generate_vertices(sig, spk)  # warm-up
        reset()
        routes_before = ops.PLAIN_ROUTES
        torch.cuda.synchronize()
        t_req = time.perf_counter()
        ts, v = task.generate_vertices(sig, spk)
        wall_ms = (time.perf_counter() - t_req) * 1e3
        request = counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            task.generate_vertices(sig, spk)
            torch.cuda.synchronize()
        device, busy_ms = device_kernels(prof)
        with ops.plain_versions():
            _, v_plain = task.generate_vertices(sig, spk)
        plain_err = max_err(v, v_plain)
        sample = sorted({0, len(ts) // 2, len(ts) - 1})
        with torch.inference_mode():
            frame_idx, _, z, _ = task._overlap_prefix(sig)
            idx = torch.from_numpy(frame_idx[sample]).long().to(dev)
            preds, _, _ = model.forward_windows(
                z, idx, torch.full((len(sample),), spk, dtype=torch.long, device=dev),
                raw_pca=True)
            dgrad = model.decode_to_anime(preds)[:, 0].double().cpu().numpy()
        oracle_err = max_err(v[sample], np.stack([solver.solve_host(d) for d in dgrad]))
        serve_s = time.perf_counter() - t0
        del task

        t0 = time.perf_counter()
        exp = Experiment(hp, build_model(hp, pca=pca), os.path.join(tmp, name), dev, seed=SEED)
        reset()
        losses, step_ms, first = [], [], None
        for batch in batches:
            torch.cuda.synchronize()
            t_step = time.perf_counter()
            metrics = exp.train_step(batch)
            losses.append(float(metrics["total"]))
            step_ms.append((time.perf_counter() - t_step) * 1e3)
            first = first or {k: float(v) for k, v in metrics.items()}
        train = counts()
        plain_exp = Experiment(hp, build_model(hp, pca=pca), os.path.join(tmp, name + "_plain"),
                               dev, seed=SEED)
        with ops.plain_versions():
            plain = {k: float(v) for k, v in plain_exp.train_step(batches[0]).items()}
        del plain_exp
        # the first step's loss terms (the total is about 4 at any first step: each term
        # is divided by its dynamic scale) and its gradient norm, against the plain versions'
        loss_rel = max(abs(first[k] - plain[k]) / abs(plain[k])
                       for k in plain if k == "total" or k.startswith("scalar_"))
        grad_norm_rel = abs(first["grad_norm"] - plain["grad_norm"]) / plain["grad_norm"]
        aux = None
        if name == "freq_last_gmm":
            main, extra = batches[:3], {"aux": batches[3:5]}  # the aux loader cycles
            step0 = exp.step
            trainer = Trainer(exp, main, aux_loaders=extra)
            trainer.train()
            aux = {"main_steps": len(trainer.step_metrics), "aux_steps": trainer.aux_steps,
                   "host_steps": exp.step - step0,
                   "main_losses": [m["total"] for m in trainer.step_metrics]}
            if not all(np.isfinite(aux["main_losses"])):
                raise RuntimeError(f"{name}: aux epoch, non-finite losses {aux}")
        train_s = time.perf_counter() - t0
        del exp
        torch.cuda.empty_cache()
        routes = ops.PLAIN_ROUTES - routes_before
        emit({"phase": "spec_variants", "variant": name,
              "encoder": [spec[0] for spec in hp.model.audio_encoder.layers],
              "params": sum(p.numel() for p in model.parameters()), "windows": len(ts),
              "request_wall_ms": wall_ms, "request_device_busy_ms": busy_ms,
              "request_launches": request, "plain_routes": routes,
              "plain_max_abs_m": plain_err, "plain_tol_m": VARIANT_PLAIN_TOL_M,
              "oracle_frames": sample, "oracle_max_abs_m": oracle_err,
              "oracle_tol_m": ORACLE_TOL_M,
              "top_device_ms": [{"name": k[:60], "ms": ms, "calls": c} for k, ms, c in device[:6]],
              "train_steps": len(losses), "train_losses": losses,
              "train_step_ms_median": sorted(step_ms)[len(step_ms) // 2],
              "train_launches": {k: train[k] for k in ("bilstm_core_fwd", "bilstm_core_bwd")},
              "first_step_plain_loss_rel": loss_rel, "loss_rtol": STEP_LOSS_RTOL,
              "first_step_plain_grad_norm_rel": grad_norm_rel, "grad_rtol": STEP_GRAD_RTOL,
              "aux_epoch": aux, "serve_s": serve_s, "train_s": train_s, "card": smi})
        bad = {k: (request[k], n) for k, n in want_request.items()
               if (request[k] != n if n == 0 else request[k] < n)}
        if bad:
            raise RuntimeError(f"{name}: launches (got, want) {bad}")
        if v.shape != (len(ts), solver.n_verts, 3) or not np.isfinite(v).all():
            raise RuntimeError(f"{name}: bad output {v.shape}")
        if not plain_err <= VARIANT_PLAIN_TOL_M:
            raise RuntimeError(f"{name}: kernels vs plain versions {plain_err} m")
        if not oracle_err <= ORACLE_TOL_M:
            raise RuntimeError(f"{name}: vs the float64 solve {oracle_err} m")
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"{name}: non-finite training loss {losses}")
        k5 = k5_per_step * len(losses)
        if (train["bilstm_core_fwd"], train["bilstm_core_bwd"]) != (k5, k5):
            raise RuntimeError(f"{name}: bilstm_core launches {train}, want {k5} each")
        if not (loss_rel <= STEP_LOSS_RTOL and grad_norm_rel <= STEP_GRAD_RTOL):
            raise RuntimeError(f"{name}: first step's loss terms {loss_rel} and gradient norm "
                               f"{grad_norm_rel} from the plain versions'")
        if aux is not None and (aux["main_steps"] != 3 or aux["aux_steps"] != aux["main_steps"]
                                or aux["host_steps"] != aux["main_steps"] + aux["aux_steps"]):
            raise RuntimeError(f"{name}: aux epoch {aux}")
        if routes:
            raise RuntimeError(f"{name}: {routes} plain recurrences on the card")
        path[name] = {k: request[k] + train[k] for k in request}
    emit({"phase": "spec_variants_done", "seconds": time.perf_counter() - t_phase, "card": smi})
    return {name: sum(p[name] for p in path.values()) for name in
            ("freq_lstm", "bilstm2", "decode_solve", "bilstm_layer", "bilstm_core_fwd",
             "bilstm_core_bwd")}


# wide_variants: the shipped dgrad encoder with its recurrent stacks widened (FreqLstm spec,
# time stack spec, the attention's width = 2 H of the time stack)
WIDE_VARIANTS = {
    "wide512": (("freq-lstm", 64, 32, "hidden_size=256", "output_size=512"),
                ("lstm", 512, 512, "num_layers=2", "bidirectional=True", "dropout=0.1"), 1024),
    "wide384": (("freq-lstm", 64, 32, "hidden_size=384", "output_size=384"),
                ("lstm", 384, 384, "num_layers=3", "bidirectional=True"), 768)}


def wide_variant_hparams(name):
    """The dgrad config of ``configs/model/dgrad.py`` with only its recurrent
    stacks widened (``WIDE_VARIANTS``): the conv stack of
    ``configs/_shared.py:32-46``, Bahdanau attention over the time stack's 2 H,
    the trunk's input following it; the heads, template, bases and data as
    shipped."""
    from sdfa_tpu_torch.config import configure

    hp = configure("dgrad")
    hp.trainer.set_key("max_epochs", 1)
    hp.trainer.set_key("save_gap_epochs", None)
    shipped = [tuple(spec) for spec in hp.model.audio_encoder.layers]
    conv, (_, squeeze, permute, _, _) = shipped[:6], shipped[6:]
    freq, lstm, width = WIDE_VARIANTS[name]
    hp.model.audio_encoder.set_key("layers", conv + [
        freq, squeeze, permute, lstm, ("attn", "bah", width, 128, 2, "scale_score_at_eval=1.0")])
    trunk = [tuple(spec) for spec in hp.model.output.layers]
    trunk[0] = (trunk[0][0], trunk[0][1] - 512 + width, *trunk[0][2:])  # 512 + 8 -> width + 8
    hp.model.output.set_key("layers", trunk)
    return hp


def wide_variants_phase(task_main, pca, sig, spk, solver, dev, smi, tmp):
    """The two wide models of ``WIDE_VARIANTS`` at full width, seeded, over the
    serve phase's template and PCA bases. Each serves a 3 s request on the f32
    wire through ``AnimationTask.generate_vertices`` (launches by kernel and
    width, wall and device busy ms) within ``VARIANT_PLAIN_TOL_M`` of the same
    call under ``ops.plain_versions()`` and ``ORACLE_TOL_M`` of the float64
    solve, then ``Experiment`` takes ``VARIANT_TRAIN_STEPS`` steps of 100
    windows (K5 launches by width; one step more under torch.profiler for its
    device busy ms), its first step's loss terms within
    ``STEP_LOSS_RTOL`` and every gradient within ``STEP_GRAD_RTOL`` of the
    largest against the same step through the plain versions.
    ``ops.PLAIN_ROUTES`` must stay 0."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdfa_tpu_torch import ops
    from sdfa_tpu_torch.compat import init_params
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.ops import bilstm2, bilstm_core, bilstm_layer, decode_solve, freq_lstm
    from sdfa_tpu_torch.task import AnimationTask
    from sdfa_tpu_torch.train import Experiment

    t_phase = time.perf_counter()
    counted = {"freq_lstm": freq_lstm, "bilstm2": bilstm2, "decode_solve": decode_solve,
               "bilstm_layer": bilstm_layer}

    def reset():
        reset_counts(counted)
        bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
        bilstm_core.LAUNCHES_BY_HIDDEN.clear()

    def counts():
        out = {name: launched(mod) for name, mod in counted.items()}
        out.update(decode_solve=decode_solve.LAUNCHES["delta"],
                   decode_solve_full=decode_solve.LAUNCHES["full"])
        out.update({f"{name}_h{h}": n for name in ("freq_lstm", "bilstm2", "bilstm_layer")
                    for h, n in counted[name].LAUNCHES.items()})
        out.update({f"bilstm_core_{p}_h{h}": n
                    for (p, h), n in bilstm_core.LAUNCHES_BY_HIDDEN.items()})
        out.update(bilstm_core_fwd=bilstm_core.FWD_LAUNCHES,
                   bilstm_core_bwd=bilstm_core.BWD_LAUNCHES)
        return out

    # a request's launches, and a train step's by pass and width
    want = {"wide512": ({"freq_lstm_h256": 1, "bilstm2_h512": 1, "decode_solve": 1,
                         "decode_solve_full": 0, "freq_lstm": 1, "bilstm2": 1, "bilstm_layer": 0},
                        {"bilstm_core_fwd_h256": 1, "bilstm_core_fwd_h512": 2,
                         "bilstm_core_bwd_h256": 1, "bilstm_core_bwd_h512": 2}),
            "wide384": ({"freq_lstm_h384": 1, "bilstm_layer_h384": 3, "decode_solve": 1,
                         "decode_solve_full": 0, "freq_lstm": 1, "bilstm_layer": 3, "bilstm2": 0},
                        {"bilstm_core_fwd_h384": 4, "bilstm_core_bwd_h384": 4})}
    batches = train_batches(VARIANT_TRAIN_STEPS)
    path = {}
    for name, (want_request, want_step) in want.items():
        t0 = time.perf_counter()
        hp = wide_variant_hparams(name)
        model = init_params(build_model(hp, pca=pca), SEED)
        task = AnimationTask(hp, model, dev)
        task._decode = task_main._decode  # the same template and PCA bases
        task.generate_vertices(sig, spk)  # warm-up
        reset()
        routes_before = ops.PLAIN_ROUTES
        torch.cuda.synchronize()
        t_req = time.perf_counter()
        ts, v = task.generate_vertices(sig, spk)
        wall_ms = (time.perf_counter() - t_req) * 1e3
        request = counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            task.generate_vertices(sig, spk)
            torch.cuda.synchronize()
        device, busy_ms = device_kernels(prof)
        with ops.plain_versions():
            _, v_plain = task.generate_vertices(sig, spk)
        plain_err = max_err(v, v_plain)
        sample = sorted({0, len(ts) // 2, len(ts) - 1})
        with torch.inference_mode():
            frame_idx, _, z, _ = task._overlap_prefix(sig)
            idx = torch.from_numpy(frame_idx[sample]).long().to(dev)
            preds, _, _ = model.forward_windows(
                z, idx, torch.full((len(sample),), spk, dtype=torch.long, device=dev),
                raw_pca=True)
            dgrad = model.decode_to_anime(preds)[:, 0].double().cpu().numpy()
        oracle_err = max_err(v[sample], np.stack([solver.solve_host(d) for d in dgrad]))
        serve_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        del task, model

        t0 = time.perf_counter()
        exp = Experiment(hp, build_model(hp, pca=pca), os.path.join(tmp, name), dev, seed=SEED)
        reset()
        losses, step_ms, first, g_kernel = [], [], None, None
        for batch in batches:
            torch.cuda.synchronize()
            t_step = time.perf_counter()
            metrics = exp.train_step(batch)
            losses.append(float(metrics["total"]))
            step_ms.append((time.perf_counter() - t_step) * 1e3)
            if first is None:
                first = {k: float(v) for k, v in metrics.items()}
                g_kernel = {n: p.grad.clone() for n, p in exp.model.named_parameters()}
                step_counts = counts()
        train = counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            exp.train_step(batches[0])  # one step more, profiled: the step's device busy ms
            torch.cuda.synchronize()
        step_device, step_busy_ms = device_kernels(prof, TRAIN_SPANS)
        del exp
        plain_exp = Experiment(hp, build_model(hp, pca=pca), os.path.join(tmp, name + "_plain"),
                               dev, seed=SEED)
        with ops.plain_versions():
            plain = {k: float(v) for k, v in plain_exp.train_step(batches[0]).items()}
        g_plain = {n: p.grad for n, p in plain_exp.model.named_parameters()}
        loss_rel = max(abs(first[k] - plain[k]) / abs(plain[k])
                       for k in plain if k == "total" or k.startswith("scalar_"))
        g_max = max(float(g.abs().max()) for g in g_plain.values())
        grad_diffs = {n: float((g_kernel[n] - g).abs().max()) for n, g in g_plain.items()}
        grad_rel = max(grad_diffs.values()) / g_max
        worst = max(grad_diffs, key=grad_diffs.get)
        del plain_exp, g_kernel, g_plain
        torch.cuda.empty_cache()
        train_s = time.perf_counter() - t0
        routes = ops.PLAIN_ROUTES - routes_before
        emit({"phase": "wide_variants", "variant": name,
              "encoder": [list(spec) for spec in hp.model.audio_encoder.layers[6:]],
              "params": n_params,
              "windows": len(ts), "request_wall_ms": wall_ms, "request_device_busy_ms": busy_ms,
              "request_launches": request, "plain_routes": routes,
              "plain_max_abs_m": plain_err, "plain_tol_m": VARIANT_PLAIN_TOL_M,
              "oracle_frames": sample, "oracle_max_abs_m": oracle_err,
              "oracle_tol_m": ORACLE_TOL_M,
              "top_device_ms": [{"name": k[:60], "ms": ms, "calls": c} for k, ms, c in device[:6]],
              "train_steps": len(losses), "train_losses": losses,
              "train_step_ms_median": sorted(step_ms)[len(step_ms) // 2],
              "train_step_device_busy_ms": step_busy_ms,
              "train_step_top_device_ms": [{"name": k[:60], "ms": ms, "calls": c}
                                           for k, ms, c in step_device[:6]],
              "first_step_launches": {k: n for k, n in step_counts.items()
                                      if k.startswith("bilstm_core_")},
              "train_launches": {k: n for k, n in train.items() if k.startswith("bilstm_core_")},
              "first_step_plain_loss_rel": loss_rel, "loss_rtol": STEP_LOSS_RTOL,
              "first_step_plain_grad_vs_largest_gradient": grad_rel, "grad_rtol": STEP_GRAD_RTOL,
              "largest_gradient": g_max, "worst_gradient": worst,
              "serve_s": serve_s, "train_s": train_s, "card": smi})
        bad = {k: (request.get(k, 0), n) for k, n in want_request.items()
               if request.get(k, 0) != n}
        bad.update({k: (step_counts.get(k, 0), n) for k, n in want_step.items()
                    if step_counts.get(k, 0) != n})
        bad.update({k: (train.get(k, 0), n * len(losses)) for k, n in want_step.items()
                    if train.get(k, 0) != n * len(losses)})
        if bad:
            raise RuntimeError(f"{name}: launches (got, want) {bad}")
        if v.shape != (len(ts), solver.n_verts, 3) or not np.isfinite(v).all():
            raise RuntimeError(f"{name}: bad output {v.shape}")
        if not plain_err <= VARIANT_PLAIN_TOL_M:
            raise RuntimeError(f"{name}: kernels vs plain versions {plain_err} m")
        if not oracle_err <= ORACLE_TOL_M:
            raise RuntimeError(f"{name}: vs the float64 solve {oracle_err} m")
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"{name}: non-finite training loss {losses}")
        if not (loss_rel <= STEP_LOSS_RTOL and grad_rel <= STEP_GRAD_RTOL):
            raise RuntimeError(f"{name}: first step's loss terms {loss_rel} and gradients "
                               f"{grad_rel} of the largest from the plain versions'")
        if routes:
            raise RuntimeError(f"{name}: {routes} plain recurrences on the card")
        path[name] = {k: request[k] + train.get(k, 0) for k in request}
    emit({"phase": "wide_variants_done", "seconds": time.perf_counter() - t_phase, "card": smi})
    return {name: sum(p.get(name, 0) for p in path.values()) for name in
            ("freq_lstm", "bilstm2", "decode_solve", "bilstm_layer", "bilstm_core_fwd",
             "bilstm_core_bwd")}


def data_train_phase(task_seeded, sig, spk, solver, dev, smi, tmp):
    """``synthetic.generate`` → ``api.train_model`` (raw mode, thread prefetch,
    30 steps) → the device frontend against the host features on one batch →
    2 steps on host features and two ``PrefetchLoader`` batches from forkserver
    workers → the trained checkpoint served with the dataset's fitted PCA bases
    → K3 at the dataset's own coefficients (fault C4). Returns the launch
    counts of the phase's own path (the comparisons after it not counted) and
    what the ``cli`` phase reuses: the dataset root, the trained checkpoint
    and the task serving it. Works in ``tmp``."""
    from sdfa_tpu_torch.ops import bilstm2, decode_solve, freq_lstm

    from sdfa_tpu_torch.data import prefetch

    counters = {"freq_lstm": freq_lstm, "bilstm2": bilstm2, "decode_solve": decode_solve}
    out = {"phase": "data_train", "card": smi}
    try:
        return _data_train(out, task_seeded, sig, spk, solver, dev, counters, tmp)
    finally:
        # the loader's forkserver and resource tracker would only exit after this
        # process; stop them now, and wait for them
        prefetch.stop_servers()
        emit(out)  # what was measured, also when a check failed


def _data_train(out, task_seeded, sig, spk, solver, dev, counters, tmp):
    import csv

    import numpy as np
    import torch

    from sdfa_tpu_torch import api, ops
    from sdfa_tpu_torch.config import configure
    from sdfa_tpu_torch.data import DatasetSlidingWindow, synthetic
    from sdfa_tpu_torch.data import device_features as dfeat
    from sdfa_tpu_torch.data.prefetch import PrefetchLoader
    from sdfa_tpu_torch.mesh import FLAME_COUNTS
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.ops import bilstm_core, decode_solve
    from sdfa_tpu_torch.task import AnimationTask
    from sdfa_tpu_torch.train import checkpoints
    from sdfa_tpu_torch.train.trainer import RAW_KEYS

    t0 = time.perf_counter()
    root = synthetic.generate(os.path.join(tmp, "voca"), "dgrad_3d", speakers=["m0", "f0"],
                              sentences_per_speaker=1, seconds_per_sentence=2.0, seed=SEED)
    pca_on = {"trainer": {"pca_targets": True}}
    hp = configure("dgrad", dataset_root=root, overrides=pca_on)
    out["generate_s"] = time.perf_counter() - t0
    out["train_windows"] = len(DatasetSlidingWindow(hp, training=True))

    # 1. api.train_model: raw mode, thread prefetch, 30 steps; training launches
    #    bilstm_core only (no validation pass runs K1 / K2, no request K3)
    bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
    reset_counts(counters)
    run = os.path.join(tmp, "run")
    t0 = time.perf_counter()
    exp = api.train_model("dgrad", dataset_root=root, log_dir=run, max_steps=DATA_TRAIN_STEPS,
                          overrides=pca_on, device=dev)
    out["train_model_s"] = time.perf_counter() - t0
    path = read_counts(counters, "data_train train_model", zero=tuple(counters))
    core = (bilstm_core.FWD_LAUNCHES, bilstm_core.BWD_LAUNCHES)
    out["bilstm_core_launches"] = list(core)
    if core != (3 * DATA_TRAIN_STEPS,) * 2 or exp.step != DATA_TRAIN_STEPS:
        raise RuntimeError(f"train_model: {exp.step} steps, bilstm_core launches {core}")
    ckpt = os.path.join(run, "last.ckpt")
    if not os.path.exists(ckpt):
        raise RuntimeError("train_model wrote no last.ckpt")
    with open(os.path.join(run, "train_log", "loss", "epoch-loss.csv"), newline="") as fp:
        rows = list(csv.DictReader(fp))
    bad = [(r["epoch"], k) for r in rows for k, v in r.items()
           if k != "epoch" and not np.isfinite(float(v))]
    if bad or not rows:
        raise RuntimeError(f"train_model: non-finite epoch losses {bad} ({len(rows)} rows)")
    out.update(epochs=len(rows), first_epoch_loss=float(rows[0]["train_total"]),
               last_epoch_loss=float(rows[-1]["train_total"]), **train_timing(run))

    # 2. the device frontend on one training batch against the host features
    ds = DatasetSlidingWindow(hp, training=True)
    batch = next(ds.raw_batches(int(hp.trainer.anime_loader.batch_size)))
    with torch.no_grad():
        got = dfeat.device_train_features(
            *(torch.from_numpy(batch[k]).to(dev) for k in RAW_KEYS),
            spec=dfeat.FeatureSpec.from_hparams(hp)).cpu().numpy()
    want = np.stack([dfeat.host_train_features(
        *(batch[k][i] for k in RAW_KEYS[:7]), mel_cfg=ds._mel_cfg, sr=ds._sr)
        for i in range(len(got))])
    out["frontend"] = {"windows": len(got), "max_abs": float(np.abs(got - want).max()),
                       "channel0_max_abs": float(np.abs(got[..., 0] - want[..., 0]).max()),
                       "tol": FRONTEND_TOL, "channel0_tol": FRONTEND_CH0_TOL}
    if not (out["frontend"]["max_abs"] <= FRONTEND_TOL
            and out["frontend"]["channel0_max_abs"] <= FRONTEND_CH0_TOL):
        raise RuntimeError(f"device frontend vs host features: {out['frontend']}")

    # 3. host features: two steps, then two batches from forkserver workers
    t0 = time.perf_counter()
    host_exp = api.train_model("dgrad", dataset_root=root, log_dir=os.path.join(tmp, "host"),
                               max_steps=2, device=dev,
                               overrides={"trainer": {"pca_targets": True,
                                                      "host_features": True}})
    out["host_features_train_s"] = time.perf_counter() - t0
    if host_exp.step != 2:
        raise RuntimeError(f"host-feature training took {host_exp.step} steps, not 2")
    want = ds.collate([ds[0], ds[1]])
    schema = {k: (v.shape[1:], v.dtype) for k, v in want.items()}
    loader = PrefetchLoader(ds, 4, num_workers=2)
    got = []
    t0 = time.perf_counter()
    for b in loader:
        got.append(b)
        if len(got) == 2:
            break
    out["prefetch_two_batches_s"] = time.perf_counter() - t0
    loader.close()  # the loop broke out of the epoch: stop its workers now
    for b in got:
        if ({k: (v.shape[1:], v.dtype) for k, v in b.items()} != schema
                or len(b["audio_feat"]) != 8):
            raise RuntimeError("PrefetchLoader batch schema "
                               f"{[(k, v.shape, v.dtype) for k, v in b.items()]}")
    out["prefetch_batch_keys"] = sorted(schema)

    # 4. the trained checkpoint, served with the dataset's fitted PCA bases
    hp_s = configure("dgrad", dataset_root=root)
    model = build_model(hp_s)
    model.load_state_dict(checkpoints.load_checkpoint(ckpt)["model"])
    served = AnimationTask(hp_s, model, dev)
    served.warmup(3.0)
    clip = signal(3.0, int(hp_s.audio.sample_rate), 30)
    reset_counts(counters)
    ts, v = served.generate_vertices(clip, 1)
    for name, n in read_counts(counters, "data_train serve").items():
        path[name] += n
    host_task = AnimationTask(hp_s, model, dev, device_frontend=False)
    reset_counts(counters)
    ts_h, v_h = host_task.generate_vertices(clip, 1)
    # the host features take the per-window path, which solves through
    # frames_to_meshes, not K3
    for name, n in read_counts(counters, "data_train host frontend",
                               zero=("decode_solve",)).items():
        path[name] += n
    path["bilstm_core_fwd"], path["bilstm_core_bwd"] = (bilstm_core.FWD_LAUNCHES,
                                                        bilstm_core.BWD_LAUNCHES)
    if v.shape != (len(ts), FLAME_COUNTS[0], 3) or not np.isfinite(v).all():
        raise RuntimeError(f"trained checkpoint: bad output {v.shape}")
    if ts_h != ts or v_h.shape != v.shape or not np.isfinite(v_h).all():
        raise RuntimeError(f"host frontend request: bad output {v_h.shape}")
    with ops.plain_versions():
        _, v_plain = served.generate_vertices(clip, 1)
    solver_, consts, dsc = served._decode_consts()
    sample = sorted({int(i) for i in np.linspace(0, len(ts) - 1, 8)})
    with torch.inference_mode():
        frame_idx, _, z, _ = served._overlap_prefix(clip)
        spk_t = torch.full((len(frame_idx),), 1, dtype=torch.long, device=dev)
        preds, _, _ = model.forward_windows(z, torch.from_numpy(frame_idx).long().to(dev),
                                            spk_t, raw_pca=True)
        dgrad = model.decode_to_anime(preds)[sample, 0].double().cpu().numpy()
        dt_request = float(decode_solve.delta_transforms(
            preds["dgrad_3d_scale_pca"][:, 0], preds["dgrad_3d_rotat_pca"][:, 0],
            dsc).abs().max())
        # the seeded bases of the serve phase on their first request, for scale
        idx0, _, z0, _ = task_seeded._overlap_prefix(sig)
        p0, _, _ = task_seeded.model.forward_windows(
            z0, torch.from_numpy(idx0).long().to(dev),
            torch.full((len(idx0),), spk, dtype=torch.long, device=dev), raw_pca=True)
        dt_seeded = float(decode_solve.delta_transforms(
            p0["dgrad_3d_scale_pca"][:, 0], p0["dgrad_3d_rotat_pca"][:, 0],
            task_seeded._decode_consts()[2]).abs().max())
    oracle = np.stack([solver.solve_host(d) for d in dgrad])
    out["serve"] = {"audio_s": 3.0, "windows": len(ts),
                    "oracle_frames": sample,
                    "oracle_max_abs_m": float(np.abs(v[sample] - oracle).max()),
                    "plain_max_abs_m": float(np.abs(v - v_plain).max()),
                    "host_frontend_max_abs_m_vs_device_frontend": float(np.abs(v_h - v).max()),
                    "max_abs_T_minus_T0": dt_request, "tol_m": ORACLE_TOL_M}
    if not (out["serve"]["oracle_max_abs_m"] <= ORACLE_TOL_M
            and out["serve"]["plain_max_abs_m"] <= PLAIN_TOL_M):
        raise RuntimeError(f"trained checkpoint: {out['serve']}")

    # 5. fault C4: K3 at the dataset's own projected coefficients, every frame of one
    #    sentence, against its plain version and the float64 decode + solve
    info = ds.info_list[0]
    coefs = np.asarray(ds._frame_store(info["npy_data_path:path"], int(info["anime_minfi:int"]),
                                       int(info["anime_maxfi:int"]))[3], np.float32)
    ks = model.scale_pca.compT.shape[1]
    cs = torch.from_numpy(np.ascontiguousarray(coefs[:, :ks])).to(dev)
    cr = torch.from_numpy(np.ascontiguousarray(coefs[:, ks:])).to(dev)
    with torch.inference_mode():
        x_kernel = decode_solve.decode_solve(cs, cr, dsc)
        torch.cuda.synchronize()
        x_plain = decode_solve.decode_solve_plain(cs, cr, dsc)
        verts = decode_solve.assemble_from_free(consts, solver_.spec, x_kernel,
                                                consts.template_cnst).cpu().numpy()
        dt_data = float(decode_solve.delta_transforms(cs, cr, dsc).abs().max())
    c64 = coefs.astype(np.float64)
    comp = {n: getattr(model, f"{n}_pca") for n in ("scale", "rotat")}
    dec = [c64[:, sl] @ comp[n].compT.double().cpu().numpy().T
           + comp[n].means.double().cpu().numpy()
           for n, sl in (("scale", slice(0, ks)), ("rotat", slice(ks, None)))]
    frames64 = np.concatenate([dec[0].reshape(len(c64), -1, 6),
                               dec[1].reshape(len(c64), -1, 3)], axis=-1)
    oracle = np.stack([solver.solve_host(f) for f in frames64])
    out["c4"] = {"frames": len(coefs), "max_abs_coef": float(np.abs(coefs).max()),
                 "max_abs_T_minus_T0": dt_data,
                 "seeded_bases_max_abs_T_minus_T0": dt_seeded,
                 "kernel_vs_plain_max_abs_m": float((x_kernel - x_plain).abs().max()),
                 "kernel_vs_float64_max_abs_m": float(np.abs(verts - oracle).max()),
                 "plain_tol_m": TOL["decode_solve"], "oracle_tol_m": ORACLE_TOL_M}
    if not (out["c4"]["kernel_vs_plain_max_abs_m"] <= TOL["decode_solve"]
            and out["c4"]["kernel_vs_float64_max_abs_m"] <= ORACLE_TOL_M):
        raise RuntimeError(f"C4: K3 at trained magnitudes {out['c4']}")
    return path, {"tmp": tmp, "root": root, "ckpt": ckpt, "config": "dgrad", "task": served,
                  "clip": clip}


def last_modules_phase(trained, served, train_step_ms, dev, smi, tmp):
    """The modules the port took over last, on the ``data_train`` dataset at
    the shipped ``dgrad`` width: ``StepEnv`` (a warm step, the median of 5
    synchronized steps, 10 back-to-back steps with and without the upload,
    K5 3 + 3 a step, ``cost_stats`` split into the library ops and each
    kernel's launches); ``Experiment.plot_forward`` on its 100-window batch
    (K1 / K2 1 / 1, within ``PLOT_REL_TOL`` of the plain versions, wall and
    device busy ms); a ``Trainer`` with ``plot_gap_steps=2`` for 4 steps
    (``summary.enabled``, ``PLUGIN_FAILURES`` 0, K5 12 / 12, K1 / K2 2 / 2),
    then one with ``eval_gap_epochs=1`` and an existing wav: where the host has
    OpenCV, one epoch of one step and the evaluation's video (its frame count
    from the clip's window geometry); where it has not, a refusal before any
    step; ``features.get_dict`` on a 3 s
    clip on the card against the CPU; ``BilateralFilter1D`` on the serve
    phase's request vertices on the card against the CPU; the native float64
    runtime (built now) solving the request's first 16 frames against K3's
    vertices. Returns the launch counts of the paths it drives."""
    out = {"phase": "last_modules", "card": smi}
    t_phase = time.perf_counter()
    try:
        return _last_modules(out, trained, served, train_step_ms, dev, tmp)
    finally:
        out["seconds"] = time.perf_counter() - t_phase
        emit(out)  # what was measured, also when a check failed


def _last_modules(out, trained, served, train_step_ms, dev, tmp):
    import importlib.util
    import itertools

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdfa_tpu_torch import native, ops
    from sdfa_tpu_torch.audio import features
    from sdfa_tpu_torch.audio import io as audio_io
    from sdfa_tpu_torch.audio.pipeline import WindowSpec
    from sdfa_tpu_torch.config import configure
    from sdfa_tpu_torch.data import DatasetSlidingWindow
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.ops import bilstm2, bilstm_core, build, freq_lstm
    from sdfa_tpu_torch.train import Experiment, Trainer, summary
    from sdfa_tpu_torch.train.stepbench import StepEnv
    from sdfa_tpu_torch.utils import BilateralFilter1D

    counters = {"freq_lstm": freq_lstm, "bilstm2": bilstm2}

    def core_counts():
        return bilstm_core.FWD_LAUNCHES, bilstm_core.BWD_LAUNCHES

    # 1. StepEnv: the timing harness a benchmark's train-step fields come from
    t0 = time.perf_counter()
    env = StepEnv(trained["root"], os.path.join(tmp, "stepenv"), device=dev, seed=SEED)
    env.sync(env.step(0))  # warm
    out["stepenv_setup_s"] = time.perf_counter() - t0
    bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
    median_s = env.timed_median_s(STEPENV_MEDIAN_STEPS)
    steady_s = env.timed_steady_s(STEPENV_STEADY_STEPS)
    steady_up_s = env.timed_steady_s(STEPENV_STEADY_STEPS, upload=True)
    steps = STEPENV_MEDIAN_STEPS + 2 * STEPENV_STEADY_STEPS
    k5 = core_counts()
    path = {"bilstm_core_fwd": k5[0], "bilstm_core_bwd": k5[1]}
    if k5 != (3 * steps, 3 * steps):
        raise RuntimeError(f"StepEnv: K5 launched {k5} in {steps} steps, expected 3 + 3 a step")
    stats = env.cost_stats()
    out["stepenv"] = {
        "windows": env.n_windows, "step_ms_synced_median": median_s * 1e3,
        "step_ms_steady": steady_s * 1e3, "step_ms_steady_with_upload": steady_up_s * 1e3,
        "windows_per_s": {"synced": env.n_windows / median_s, "steady": env.n_windows / steady_s,
                          "steady_with_upload": env.n_windows / steady_up_s},
        "train_phase_step_ms_median": train_step_ms,
        "train_phase_windows_per_s": TRAIN_WINDOWS / (train_step_ms / 1e3),
        "k5_launches_per_step": [k5[0] / steps, k5[1] / steps],
        "cost_stats": stats, "cost_parts": env.cost_parts,
        "gflop_per_step": stats["flops"] / 1e9, "gbytes_per_step": stats["bytes"] / 1e9}
    kernels = env.cost_parts["kernels"]
    if (sorted(kernels) != ["bilstm_core_bwd", "bilstm_core_fwd"]
            or [k["launches"] for k in kernels.values()] != [3, 3]
            or not stats["flops"] > env.cost_parts["library"]["flops"] > 0):
        raise RuntimeError(f"cost_stats: {env.cost_parts}")

    # 2. plot_forward on the held 100-window batch: through the kernels, then the plain versions
    batch = env.batch
    env.exp.plot_forward(batch)  # warm
    torch.cuda.synchronize()
    reset_counts(counters)
    t0 = time.perf_counter()
    got = env.exp.plot_forward(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    path.update(read_counts(counters, "last_modules plot_forward"))
    plot_launches = dict(path)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        env.exp.plot_forward(batch)
        torch.cuda.synchronize()
    _, busy_ms = device_kernels(prof)
    with ops.plain_versions():
        want = env.exp.plot_forward(batch)
    rel = max(float((got["prediction"][k] - want["prediction"][k]).abs().max()
                    / want["prediction"][k].abs().max()) for k in want["prediction"])
    finite = all(bool(torch.isfinite(v).all()) for v in got["prediction"].values())
    out["plot_forward"] = {
        "windows": int(batch["raw_wav"].shape[0]),
        "launches": {k: plot_launches[k] for k in counters},
        "prediction_max_rel_vs_plain": rel, "tol": PLOT_REL_TOL, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "audio_feat_shape": list(got["audio_feat"].shape), "latent_shape": list(got["latent"].shape)}
    if plot_launches["freq_lstm"] != 1 or plot_launches["bilstm2"] != 1:
        raise RuntimeError(f"plot_forward launched {plot_launches}, expected K1 / K2 1 / 1")
    if not (rel <= PLOT_REL_TOL and finite):
        raise RuntimeError(f"plot_forward, kernels vs plain versions: {rel} (finite {finite})")
    del env, got, want

    # 3. the plotting Trainer on the dataset's raw batches, then the mid-training evaluation
    #    that a host without OpenCV cannot render
    hp = configure("dgrad", dataset_root=trained["root"], overrides={"trainer": {
        "pca_targets": True, "plot_gap_steps": 2, "max_epochs": 1}})
    bs = int(hp.trainer.anime_loader.batch_size)
    loader = list(itertools.islice(DatasetSlidingWindow(hp, training=True).raw_batches(bs),
                                   PLOT_TRAINER_STEPS))
    exp = Experiment(hp, build_model(hp), os.path.join(tmp, "plot_run"), dev, seed=SEED)
    failures = summary.PLUGIN_FAILURES
    reset_counts(counters)
    bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    Trainer(exp, loader).train()
    trainer_s = time.perf_counter() - t0
    trainer_counts = {**{k: launched(m) for k, m in counters.items()},
                      "bilstm_core_fwd": core_counts()[0], "bilstm_core_bwd": core_counts()[1]}
    for name, n in trainer_counts.items():
        path[name] += n
    n_plots = PLOT_TRAINER_STEPS // 2
    out["plot_trainer"] = {"steps": exp.step, "summary_enabled": exp.summary.enabled,
                           "plugin_failures": summary.PLUGIN_FAILURES - failures,
                           "launches": trainer_counts, "seconds": trainer_s}
    if (exp.step != PLOT_TRAINER_STEPS or summary.PLUGIN_FAILURES != 0
            or trainer_counts != {"freq_lstm": n_plots, "bilstm2": n_plots,
                                  "bilstm_core_fwd": 3 * PLOT_TRAINER_STEPS,
                                  "bilstm_core_bwd": 3 * PLOT_TRAINER_STEPS}):
        raise RuntimeError(f"the plotting Trainer: {out['plot_trainer']}")
    wav = os.path.join(tmp, "eval_source.wav")
    audio_io.save(wav, signal(1.0, int(hp.audio.sample_rate), 41), int(hp.audio.sample_rate))
    hp.trainer.set_key("eval_gap_epochs", 1)
    hp.trainer.set_key("max_epochs", exp.epoch + 1)
    hp.trainer.set_key("evaluate", {"test": [[wav, "speaker=m0"]]})
    has_video = importlib.util.find_spec("cv2") is not None
    evaluation = out["mid_training_evaluation"] = {"opencv_on_host": has_video}
    bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
    if not has_video:  # the Trainer must refuse when it is built, before any step
        refusal = None
        try:
            Trainer(exp, loader[:1])
        except ImportError as exc:
            refusal = str(exc)
        evaluation.update(refusal=refusal, k5_launches=list(core_counts()))
        if refusal is None or "video rendering needs cv2" not in refusal:
            raise RuntimeError(f"a Trainer with eval_gap_epochs and a source on a host without "
                               f"OpenCV was built: {refusal!r}")
        if core_counts() != (0, 0):
            raise RuntimeError("K5 launched while the refused Trainer was built")
    else:  # one epoch of one step, then the evaluation's video of the source
        import cv2

        t0 = time.perf_counter()
        Trainer(exp, loader[:1]).train()
        video = os.path.join(exp.log_dir, "eval_at_train", f"epoch{exp.epoch:04d}",
                             "eval_source.avi")
        cap = cv2.VideoCapture(video)
        frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        _, ts_list = WindowSpec(hp).window_starts(int(hp.audio.sample_rate))
        want = int(ts_list[-1] * float(hp.anime.fps) / 1000.0) + 1
        evaluation.update(cv2=cv2.__version__, seconds=time.perf_counter() - t0,
                          video_frames=frames, frames_expected=want,
                          k5_launches=list(core_counts()))
        if frames != want or core_counts() != (3, 3):
            raise RuntimeError(f"mid-training evaluation: {evaluation}")
        path["bilstm_core_fwd"] += 3
        path["bilstm_core_bwd"] += 3
    del exp, loader

    # 4. the feature registry on a 3 s clip: the dgrad audio config, sizes in samples
    sr = int(hp.audio.sample_rate)
    args = {"sample_rate": sr}
    for name in ("mel", "lpc"):
        args[name] = {k: (int(round(v * sr)) if k in ("win_size", "hop_size") else v)
                      for k, v in dict(hp.audio[name]).items()}
    frame_kw = {k: args["mel"][k] for k in ("win_size", "hop_size", "win_fn")}
    args["spec"] = dict(frame_kw, normalize=True, ref_db=20, top_db=80, preemphasis=0.65)
    args["deepspeech_spec"] = dict(frame_kw, win_fn="hann", padding=True)
    names = ["mel", "spec", "deepspeech_spec", "lpc"]
    clip = signal(3.0, sr, 42)
    on_cpu = features.get_dict(names, clip, args)
    clip_t = torch.from_numpy(clip).to(dev)
    features.get_dict(names, clip_t, args)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = features.get_dict(names, clip_t, args)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    mel_card = features.get_dict(["mel"], clip_t, args)["mel"]
    torch.cuda.synchronize()
    mel_ms = (time.perf_counter() - t0) * 1e3
    errs = {n: float(np.abs(on_card[n].cpu().numpy() - on_cpu[n]).max()) for n in names}
    out["features"] = {"clip_s": 3.0, "shapes": {n: list(v.shape) for n, v in on_cpu.items()},
                       "card_vs_cpu_max_abs": errs, "tol": FEATURE_CARD_TOL,
                       "ms_per_clip_all_four": card_ms, "ms_per_clip_mel": mel_ms,
                       "mel_device": str(mel_card.device)}
    if not max(errs.values()) <= FEATURE_CARD_TOL:
        raise RuntimeError(f"features on the card vs the CPU: {errs}")

    # 5. the bilateral filter on the request's vertices: the card against the CPU
    v_req = served["v"]
    filt = BilateralFilter1D()
    v_t = torch.from_numpy(v_req).to(dev)
    filt(v_t)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smooth_card = filt(v_t)
    torch.cuda.synchronize()
    bil_ms = (time.perf_counter() - t0) * 1e3
    smooth_cpu = filt(v_req)
    bil_err = float(np.abs(smooth_card.cpu().numpy() - smooth_cpu).max())
    out["bilateral"] = {"shape": list(v_req.shape), "card_vs_cpu_max_abs": bil_err,
                        "tol": BILATERAL_CARD_TOL, "card_ms": bil_ms,
                        "dtype": str(smooth_card.dtype)}
    if not (bil_err <= BILATERAL_CARD_TOL and smooth_card.dtype == torch.float32):
        raise RuntimeError(f"bilateral on the card vs the CPU: {out['bilateral']}")

    # 6. the native float64 runtime against K3's vertices of the request's first frames
    t0 = time.perf_counter()
    native._load()
    build_s = time.perf_counter() - t0
    verts, faces, cnst = served["template"]
    if not native.set_target(verts, faces, cnst):
        raise RuntimeError("native.set_target failed on the synthetic template")
    task, model = served["task"], served["task"].model
    with torch.inference_mode():
        frame_idx, _, z, _ = task._overlap_prefix(served["sig"])
        idx = torch.arange(NATIVE_FRAMES, device=dev)
        preds, _, _ = model.forward_windows(
            z, torch.from_numpy(frame_idx).long().to(dev)[idx],
            torch.full((NATIVE_FRAMES,), served["spk"], dtype=torch.long, device=dev),
            raw_pca=True)
        dgrad = model.decode_to_anime(preds)[:, 0].cpu().numpy()
    t0 = time.perf_counter()
    meshes = native.get_meshes(dgrad, len(verts))
    native_ms = (time.perf_counter() - t0) * 1e3
    native_err = float(np.abs(meshes - v_req[:NATIVE_FRAMES]).max())
    out["native"] = {"build_and_load_s": build_s, "built_now": "deformation" in build.BUILD_INFO,
                     "constrained": len(cnst), "frames": NATIVE_FRAMES,
                     "solve_ms": native_ms, "max_abs_m_vs_k3": native_err, "tol_m": NATIVE_TOL_M}
    if not native_err <= NATIVE_TOL_M:
        raise RuntimeError(f"native float64 vs K3's vertices: {native_err} m > {NATIVE_TOL_M}")
    return path


def obj_vertices(path):
    """The ``v`` lines of an ``.obj`` as (V, 3) float64: what ``mesh.read_obj``
    reads, parsed by numpy in one call."""
    import numpy as np

    with open(path) as fp:
        rows = [line[2:] for line in fp if line.startswith("v ")]
    return np.array(" ".join(rows).split(), np.float64).reshape(-1, 3)


def cli_phase(trained, repo, dev, smi):
    """``python -m sdfa_tpu_torch`` on the ``data_train`` phase's dataset and
    checkpoint. ``serve`` and ``evaluate`` (on a 1 s wav over the template
    written to a ``.ply``) start first as subprocesses, so that their start-up
    overlaps the modes run in process: ``train`` for 16 steps with
    ``--profile_dir`` (K5 48 / 48, ``last.ckpt``, a trace file that names the
    training core's kernels); ``trace``, then one 3 s request each through
    ``load_traced``, ``load_task`` and the trained task in memory (K1 / K2 / K3
    1 / 1 / 1 each, within ``CLI_SAME_TOL_M`` of each other, ``load_task``'s also
    through the plain versions); the same evaluation as the subprocess's, in
    process, through the kernels for its K1 / K2 / K3 counts (K3 0) and through
    the plain versions for its meshes. Then the subprocess's meshes against the
    plain versions' and against the float64 solve of its own frames, and one
    ``StreamClient`` on the served port against the offline request on the i16
    wire's budget; the server is terminated and reaped. Returns the launch
    counts of the modes run in process (the plain-version runs not counted)."""
    import numpy as np

    from sdfa_tpu_torch import api, ops
    from sdfa_tpu_torch.__main__ import main as cli_main
    from sdfa_tpu_torch.audio import io as audio_io
    from sdfa_tpu_torch.mesh import FLAME_COUNTS, synthetic_template, write_ply
    from sdfa_tpu_torch.ops import bilstm2, bilstm_core, decode_solve, freq_lstm
    from sdfa_tpu_torch.serve import StreamClient
    from sdfa_tpu_torch.viewer import frame

    counters = {"freq_lstm": freq_lstm, "bilstm2": bilstm2, "decode_solve": decode_solve}
    tmp, root, ckpt, config = trained["tmp"], trained["root"], trained["ckpt"], trained["config"]
    platform = ["--platform", "cpu" if str(dev) == "cpu" else "gpu"]
    dgrad = ["--custom_hparams", config, "--dataset_root", root] + platform
    out = {"phase": "cli", "card": smi, "wall_s": {}}
    path = {name: 0 for name in counters}
    saved_frame = dict(frame._state)
    procs, t_phase = {}, time.perf_counter()
    try:
        # 0. the inputs on disk; serve and evaluate start as subprocesses
        sr = int(trained["task"].hp.audio.sample_rate)
        wav, ply, cnst_txt = (os.path.join(tmp, name) for name in (
            "cli.wav", "template.ply", "constraints.txt"))
        audio_io.save(wav, signal(1.0, sr, 40), sr)
        verts, faces, cnst = synthetic_template(SEED)
        write_ply(ply, verts, faces)
        with open(cnst_txt, "w") as fp:
            fp.write(" ".join(str(int(i)) for i in cnst))
        template = ["--template_mesh", ply, "--mesh_constraints", cnst_txt]
        # evaluate.sh's command with the port's module
        evaluate = ["evaluate", "--load_from", ckpt, "--eval_input", wav, "--eval_spk_cond", "m0",
                    "--no-save_video"] + template + dgrad
        commands = {
            # port 0: the server binds a free port and logs the one it bound
            "serve": ["serve", "--load_from", ckpt, "--port", "0", "--capacity", "2",
                      "--device_wire", "i16"] + template + platform,
            "evaluate": evaluate + ["--output_dir", os.path.join(tmp, "cli_eval")]}
        t_start = time.perf_counter()
        for name, args in commands.items():
            with open(os.path.join(tmp, f"cli_{name}.log"), "w") as logs:
                procs[name] = subprocess.Popen([sys.executable, "-m", "sdfa_tpu_torch"] + args,
                                               cwd=repo, stdout=logs, stderr=subprocess.STDOUT)

        def failed(name):
            with open(os.path.join(tmp, f"cli_{name}.log")) as fp:
                return RuntimeError(f"cli {name} exited {procs[name].returncode}: "
                                    f"{fp.read()[-3000:]}")

        # 1. train, in process, with the profiler window of --profile_dir
        bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
        reset_counts(counters)
        prof_dir, run = os.path.join(tmp, "cli_profile"), os.path.join(tmp, "cli_run")
        t0 = time.perf_counter()
        exp = cli_main(["train", "--max_steps", str(CLI_TRAIN_STEPS), "--log_dir", run,
                        "--profile_dir", prof_dir,
                        "--overrides", json.dumps({"trainer": {"pca_targets": True}})] + dgrad)
        out["wall_s"]["train"] = time.perf_counter() - t0
        read_counts(counters, "cli train", zero=tuple(counters))
        core = (bilstm_core.FWD_LAUNCHES, bilstm_core.BWD_LAUNCHES)
        traces = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
        text = open(os.path.join(prof_dir, traces[0])).read() if len(traces) == 1 else ""
        named = {k: k in text for k in CLI_TRACE_NAMES}
        out["train"] = {"steps": exp.step, "bilstm_core_launches": list(core),
                        "last_ckpt": os.path.exists(os.path.join(run, "last.ckpt")),
                        "trace_files": len(traces), "trace_mbytes": len(text) / 1e6,
                        "trace_names": named}
        path["bilstm_core_fwd"], path["bilstm_core_bwd"] = core
        if (exp.step, core) != (CLI_TRAIN_STEPS, (3 * CLI_TRAIN_STEPS,) * 2) or \
                not out["train"]["last_ckpt"] or not all(named.values()):
            raise RuntimeError(f"cli train: {out['train']}")
        del exp, text

        # 2. trace, in process; then one request each through the dump, the
        #    checkpoint and the trained task in memory
        reset_counts(counters)
        t0 = time.perf_counter()
        dump = cli_main(["trace", "--load_from", ckpt,
                         "--traced_dump_path", os.path.join(tmp, "cli_dump")] + dgrad)
        out["wall_s"]["trace"] = time.perf_counter() - t0
        warm = read_counts(counters, "cli trace", zero=("decode_solve",))
        for name, n in warm.items():
            path[name] += n
        clip, speaker = trained["clip"], 1
        tasks = {"load_traced": api.load_traced(dump, device=dev),
                 "load_task": api.load_task(ckpt, device=dev), "in_memory": trained["task"]}
        got, per_request, walls = {}, {}, {}
        for name, task in tasks.items():
            task.warmup(1.0)
            reset_counts(counters)
            t0 = time.perf_counter()
            ts, got[name] = task.generate_vertices(clip, speaker)
            walls[name] = time.perf_counter() - t0
            per_request[name] = read_counts(counters, f"cli {name} request")
            for k, n in per_request[name].items():
                path[k] += n
        with ops.plain_versions():
            _, v_plain = tasks["load_task"].generate_vertices(clip, speaker)
        ref = got["in_memory"]
        out["requests"] = {
            "audio_s": 3.0, "windows": len(ts), "wall_s": walls, "launches": per_request,
            "max_abs_m_vs_in_memory": {k: max_err(v, ref) for k, v in got.items()},
            "load_task_plain_max_abs_m": max_err(got["load_task"], v_plain),
            "tol_m": CLI_SAME_TOL_M, "plain_tol_m": OFFSETS_PLAIN_TOL_M}
        if ref.shape != (len(ts), FLAME_COUNTS[0], 3) or not np.isfinite(ref).all() or \
                any(c != {k: 1 for k in counters} for c in per_request.values()) or \
                max(out["requests"]["max_abs_m_vs_in_memory"].values()) > CLI_SAME_TOL_M or \
                not out["requests"]["load_task_plain_max_abs_m"] <= OFFSETS_PLAIN_TOL_M:
            raise RuntimeError(f"cli requests: {out['requests']}")
        del tasks

        # 3. the subprocess's evaluation again in process, over the same template file:
        #    through the kernels for its launch counts, through the plain versions for
        #    its meshes
        frame.set_template_mesh(template_path=ply, constraints_path=cnst_txt)

        def evaluate_in_process(name, export):
            return api.evaluate_model(config, load_from=ckpt, eval_input=wav,
                                      eval_spk_cond="m0", output_dir=os.path.join(tmp, name),
                                      dataset_root=root, device=dev, save_video=False,
                                      export_mesh_frames=export)

        reset_counts(counters)
        t0 = time.perf_counter()
        (kernel_run,) = evaluate_in_process("cli_eval_kernels", export=False)
        out["wall_s"]["evaluate_in_process_no_export"] = time.perf_counter() - t0
        eval_launches = read_counts(counters, "cli evaluate", zero=("decode_solve",))
        for k, n in eval_launches.items():
            path[k] += n
        with ops.plain_versions():
            (plain_run,) = evaluate_in_process("cli_eval_plain", export=True)

        # 4. the evaluate subprocess's exports against the plain versions' and the
        #    float64 solve of its own frames
        try:
            procs["evaluate"].wait(timeout=CLI_SUBPROCESS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise RuntimeError("cli evaluate: no exit within its time limit")
        out["wall_s"]["evaluate_subprocess"] = time.perf_counter() - t_start
        if procs["evaluate"].returncode != 0:
            raise failed("evaluate")
        d_sub, d_plain = (os.path.join(tmp, name, "cli") for name in ("cli_eval",
                                                                      "cli_eval_plain"))
        objs = sorted(f for f in os.listdir(d_sub) if f.endswith(".obj"))
        v_sub = np.stack([obj_vertices(os.path.join(d_sub, f)) for f in objs])
        v_plain = np.stack([obj_vertices(os.path.join(d_plain, f)) for f in objs])
        solver = frame.get_solver()
        sample = sorted({int(i) for i in np.linspace(0, len(objs) - 1, 8)})
        oracle = np.stack([solver.solve_host(np.load(os.path.join(
            d_sub, f"{i:06d}_dgrad_3d.npy")).astype(np.float64)) for i in sample])
        out["evaluate"] = {
            "audio_s": 1.0, "frames": len(objs), "launches_in_process": eval_launches,
            "files": sorted({f.rsplit(".", 1)[1] for f in os.listdir(d_sub)}),
            "max_abs_m_vs_plain": float(np.abs(v_sub - v_plain).max()),
            "in_process_frames_kernels_vs_plain_max_abs": max_err(kernel_run["animes"],
                                                                  plain_run["animes"]),
            "oracle_frames": sample,
            "max_abs_m_vs_float64": float(np.abs(v_sub[sample] - oracle).max()),
            "plain_tol_m": OFFSETS_PLAIN_TOL_M, "oracle_tol_m": ORACLE_TOL_M}
        if not objs or sorted(f for f in os.listdir(d_plain) if f.endswith(".obj")) != objs or \
                not os.path.exists(os.path.join(d_sub, "audio.wav")) or \
                len([f for f in os.listdir(d_sub) if f.endswith(".npy")]) != len(objs) or \
                v_sub.shape[1:] != (FLAME_COUNTS[0], 3) or \
                not out["evaluate"]["max_abs_m_vs_plain"] <= OFFSETS_PLAIN_TOL_M or \
                not out["evaluate"]["max_abs_m_vs_float64"] <= ORACLE_TOL_M:
            raise RuntimeError(f"cli evaluate: {out['evaluate']}")

        # 5. the served port, read from the server's log: one client streams 1 s
        #    of audio; then the server is terminated and reaped
        server = procs["serve"]
        deadline = time.time() + CLI_SUBPROCESS_TIMEOUT_S
        while True:
            with open(os.path.join(tmp, "cli_serve.log")) as fp:
                bound = re.search(r"streaming server on 127\.0\.0\.1:(\d+)", fp.read())
            if bound:
                port = int(bound.group(1))
                break
            if server.poll() is not None:
                raise failed("serve")
            if time.time() > deadline:
                raise RuntimeError("cli serve: the server never logged its port")
            time.sleep(0.25)
        out["wall_s"]["serve_port_open_seen"] = time.perf_counter() - t_start
        sig = signal(1.0, sr, 41)
        t0 = time.perf_counter()
        with StreamClient(("127.0.0.1", port)) as client:
            client.sock.settimeout(SOCKET_TIMEOUT_S)
            sid = client.open(speaker=speaker)
            for lo in range(0, len(sig), 2000):
                client.push(sid, sig[lo:lo + 2000])
            client.flush(sid)
            frames = list(client.frames(sid))
        out["wall_s"]["serve_stream"] = time.perf_counter() - t0
        alive = server.poll() is None
        server.terminate()
        server.wait(timeout=60)
        ts_ref, v_ref = api.load_task(ckpt, device=dev).generate_vertices(sig, speaker)
        out["serve"] = {"audio_s": 1.0, "frames": len(frames), "alive_until_terminated": alive,
                        "timeline_equal": [t for t, _ in frames] == list(ts_ref),
                        "max_abs_m_vs_offline": max_err(np.stack([v for _, v in frames]), v_ref)
                        if frames else None, "tol_m": CLI_SERVE_TOL_M}
        if not (alive and out["serve"]["timeline_equal"] and frames
                and out["serve"]["max_abs_m_vs_offline"] <= CLI_SERVE_TOL_M):
            raise RuntimeError(f"cli serve: {out['serve']}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        frame._state.clear()
        frame._state.update(saved_frame)
        out["wall_s"]["phase"] = time.perf_counter() - t_phase
        emit(out)  # what was measured, also when a check failed
    return path


def train_timing(run) -> dict:
    """The ``Trainer``'s timing lines of a run directory: the median interval
    between step dispatches, by epoch and over the run, and the share of wall
    time spent waiting on the loader."""
    import numpy as np

    with open(os.path.join(run, "train_log", "metrics.jsonl")) as fp:
        timing = [t for t in map(json.loads, fp) if t["tag"] == "timing"]
    by_epoch = [1e3 * t["step_interval_median_s"] for t in timing]
    return {"step_interval_median_ms_by_epoch": by_epoch,
            "step_interval_median_ms": float(np.median(by_epoch)),
            "loader_wait_share": sum(t["loader_wait_s"] for t in timing)
            / sum(t["wall_s"] for t in timing)}


def offsets_host_decode(task, sig, spk):
    """A request's vertices decoded on the host in float64 from the card's own
    coefficients: coefficients · compTᵀ + means (+ the template for offsets)."""
    import numpy as np
    import torch

    from sdfa_tpu_torch.viewer import frame

    model = task.model
    with torch.inference_mode():
        frame_idx, _, z, _ = task._overlap_prefix(sig)
        spk_t = torch.full((len(frame_idx),), spk, dtype=torch.long, device=task.device)
        preds, _, _ = model.forward_windows(z, torch.from_numpy(frame_idx).long().to(task.device),
                                            spk_t, raw_pca=True)
    coefs = preds[f"{model.face_type}_pca"][:, 0].double().cpu().numpy()
    flat = (coefs @ model.pca.compT.detach().double().cpu().numpy().T
            + model.pca.means.detach().double().cpu().numpy())
    if model.face_type == "verts_off_3d":
        flat = flat + frame.template()[0].astype(np.float64).reshape(-1)
    return flat.reshape(len(frame_idx), -1, 3)


def offsets_phase(dev, sr, smi):
    """The shipped offsets model (``configs/model/offsets.py``) at full width,
    seeded, over the template the dgrad phases installed: three 3 s requests on
    the f32 wire, each against the plain versions and against a float64 host
    decode of the card's own coefficients, with K1 / K2 / K3 counted per
    request (1 / 1 / 0: the offsets decode is one PCA product, no solve); the
    first request on i16 and i8d against f32, coef refused; one
    ``StreamingSession`` against the offline request; a ``StreamingServer`` at
    capacity 8 on i16, each stream against its own offline request. Returns
    the launch counts of the requests, the session and the server."""
    import numpy as np

    from sdfa_tpu_torch import ops
    from sdfa_tpu_torch.compat import init_params
    from sdfa_tpu_torch.config import configure
    from sdfa_tpu_torch.mesh import FLAME_COUNTS
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.ops import bilstm2, decode_solve, freq_lstm
    from sdfa_tpu_torch.streaming import StreamingServer
    from sdfa_tpu_torch.task import AnimationTask
    from sdfa_tpu_torch.viewer import frame

    counters = {"freq_lstm": freq_lstm, "bilstm2": bilstm2, "decode_solve": decode_solve}
    hp = configure("offsets")
    rng = np.random.default_rng(SEED + 1)
    n3 = 3 * FLAME_COUNTS[0]
    # offsets of a few millimetres: 59 seeded components around seeded means
    pca = {"compT": rng.normal(0, 0.002, (n3, 59)).astype(np.float32),
           "means": rng.normal(0, 0.002, (n3,)).astype(np.float32)}
    model = init_params(build_model(hp, pca=pca), SEED)
    task = AnimationTask(hp, model, dev)
    warm_s = task.warmup(3.0)
    out = {"phase": "offsets", "params": sum(p.numel() for p in model.parameters()),
           "output_dim": int(model.pca.compT.shape[0]),
           "coefficients": int(model.pca.compT.shape[1]), "warmup_s": warm_s, "card": smi}
    path = {name: 0 for name in counters}

    def add(counts):
        for name, n in counts.items():
            path[name] += n

    requests = [(signal(3.0, sr, 50 + i), spk) for i, spk in enumerate((1, 4, 7))]
    outs, walls, plain_errs, host_errs = [], [], [], []
    for k, (sig, spk) in enumerate(requests):
        reset_counts(counters)
        t0 = time.perf_counter()
        ts, v = task.generate_vertices(sig, spk)
        walls.append(1e3 * (time.perf_counter() - t0))
        counts = read_counts(counters, f"offsets request {k}", zero=("decode_solve",))
        if (counts["freq_lstm"], counts["bilstm2"]) != (1, 1):
            raise RuntimeError(f"offsets request {k}: launches {counts}, expected K1 1 / K2 1")
        add(counts)
        if v.shape != (len(ts), FLAME_COUNTS[0], 3) or not np.isfinite(v).all():
            raise RuntimeError(f"offsets request {k}: bad output {v.shape}")
        with ops.plain_versions():
            _, v_plain = task.generate_vertices(sig, spk)
        plain_errs.append(max_err(v, v_plain))
        host_errs.append(float(np.abs(v - offsets_host_decode(task, sig, spk)).max()))
        outs.append((ts, v))
    out.update(requests=len(requests), audio_s_each=3.0, windows=[len(ts) for ts, _ in outs],
               request_wall_ms=walls, launches_per_request={"freq_lstm": 1, "bilstm2": 1,
                                                            "decode_solve": 0},
               plain_max_abs_m=plain_errs, plain_tol_m=OFFSETS_PLAIN_TOL_M,
               float64_max_abs_m=host_errs, float64_tol_m=OFFSETS_HOST_TOL_M,
               offsets_max_abs_m=float(np.abs(outs[0][1] - frame.template()[0]).max()))
    if not max(plain_errs) <= OFFSETS_PLAIN_TOL_M:
        raise RuntimeError(f"offsets, kernels vs plain versions: {plain_errs} m")
    if not max(host_errs) <= OFFSETS_HOST_TOL_M:
        raise RuntimeError(f"offsets vs the float64 host decode: {host_errs} m")

    (ts0, v0), (sig0, spk0) = outs[0], requests[0]
    wires = {}
    for wire in ("i16", "i8d"):
        task.generate_vertices(sig0, spk0, wire=wire)  # the wire's own first call
        reset_counts(counters)
        t0 = time.perf_counter()
        ts, v = task.generate_vertices(sig0, spk0, wire=wire)
        wall = 1e3 * (time.perf_counter() - t0)
        add(read_counts(counters, f"offsets wire {wire}", zero=("decode_solve",)))
        wires[wire] = {"max_abs_m_vs_f32": max_err(v, v0), "tol_m": WIRE_TOL_M[wire],
                       "wall_ms": wall}
        if ts != ts0 or not wires[wire]["max_abs_m_vs_f32"] <= WIRE_TOL_M[wire]:
            raise RuntimeError(f"offsets wire {wire}: {wires[wire]}")
    try:
        task.generate_vertices(sig0, spk0, wire="coef")
    except ValueError as exc:
        wires["coef"] = f"refused: {exc}"
    else:
        raise RuntimeError("offsets: the coef wire was not refused")
    out["wires"] = wires
    emit(out)

    add(session_phase(task, counters, sig0, spk0, ts0, v0, smi, phase="offsets_session",
                      zero=("decode_solve",)))

    n, emit_batch, block = 8, 16, 16
    per_tick = 2 * block * task.wspec.hop_size
    clips = [signal(2.0 + 0.125 * k, sr, 140 + k) for k in range(n)]
    offline = [task.generate_vertices(c, k) for k, c in enumerate(clips)]
    srv = StreamingServer(task, capacity=n, emit_batch=emit_batch, block_frames=block, wire="i16")
    drive_server(srv, clips[:2], [0, 1], per_tick)  # warm-up on the same server
    reset_counts(counters)
    got, tick_ms, tick_frames = drive_server(srv, clips, list(range(n)), per_tick)
    add(read_counts(counters, "offsets server", zero=("decode_solve",)))
    tol = WIRE_TOL_M["i16"] + STREAM_TOL_M
    errs = []
    for k, frames in enumerate(got):
        ts_ref, v_ref = offline[k]
        if [t for t, _ in frames] != list(ts_ref):
            raise RuntimeError(f"offsets server: stream {k}'s timeline differs from offline")
        errs.append(max_err(np.stack([v for _, v in frames]), v_ref))
    full = sorted(ms for ms, fr in zip(tick_ms, tick_frames) if fr >= n * (emit_batch - 2))
    fps = sum(tick_frames) / (sum(tick_ms) / 1e3)
    emit({"phase": "offsets_server", "capacity": n, "wire": "i16", "streams": n,
          "max_abs_m_vs_offline": max(errs), "tol_m": tol, "ticks": len(tick_ms),
          "full_ticks": len(full),
          "full_tick_wall_ms_median": full[len(full) // 2] if full else None,
          "full_tick_wall_ms_min_max": [full[0], full[-1]] if full else None,
          "frames_per_s": fps, "times_real_time": fps / (60.0 * n), "card": smi})
    if not max(errs) <= tol:
        raise RuntimeError(f"offsets server: {max(errs)} m from offline > {tol}")
    if path["decode_solve"] != 0:
        raise RuntimeError(f"offsets: decode_solve launched {path['decode_solve']} times")
    if "--profile" in sys.argv[1:]:
        profile_serving(task, requests, sorted(walls)[1], smi, phase="profile_offsets_serve")
        profile_server_tick(task, sr, smi, phase="profile_offsets_server_tick")
    return path


def offsets_train_phase(dev, smi):
    """``synthetic.generate(face_type="verts_off_3d")`` at FLAME's counts (the
    ``data_train`` size, PCA fitted on the data: 59 components) →
    ``api.train_model("offsets")`` for 30 raw-mode steps with PCA targets (the
    ``bilstm_core`` counters must read 90 and 90, K1 / K2 / K3 0, the
    position loss must fall) → the trained checkpoint serving a 3 s request against the
    float64 host decode and the plain versions. Returns the phase's launch
    counts (the comparison with the plain versions not counted)."""
    import csv

    import numpy as np

    from sdfa_tpu_torch import api, ops
    from sdfa_tpu_torch.config import configure
    from sdfa_tpu_torch.data import synthetic
    from sdfa_tpu_torch.mesh import FLAME_COUNTS
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.ops import bilstm2, bilstm_core, decode_solve, freq_lstm
    from sdfa_tpu_torch.task import AnimationTask
    from sdfa_tpu_torch.train import checkpoints

    counters = {"freq_lstm": freq_lstm, "bilstm2": bilstm2, "decode_solve": decode_solve}
    out = {"phase": "offsets_train", "card": smi}
    with tempfile.TemporaryDirectory(prefix="sdfa_chip_offsets_") as tmp:
        t0 = time.perf_counter()
        root = synthetic.generate(os.path.join(tmp, "voca"), "verts_off_3d",
                                  speakers=["m0", "f0"], sentences_per_speaker=1,
                                  seconds_per_sentence=2.0, seed=SEED)
        out["generate_s"] = time.perf_counter() - t0
        pca_on = {"trainer": {"pca_targets": True}}
        bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
        reset_counts(counters)
        run = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        exp = api.train_model("offsets", dataset_root=root, log_dir=run,
                              max_steps=DATA_TRAIN_STEPS, overrides=pca_on, device=dev)
        out["train_model_s"] = time.perf_counter() - t0
        path = read_counts(counters, "offsets_train train_model", zero=tuple(counters))
        core = (bilstm_core.FWD_LAUNCHES, bilstm_core.BWD_LAUNCHES)
        path.update(bilstm_core_fwd=core[0], bilstm_core_bwd=core[1])
        out["bilstm_core_launches"] = list(core)
        if core != (3 * DATA_TRAIN_STEPS,) * 2 or exp.step != DATA_TRAIN_STEPS:
            raise RuntimeError(f"offsets train_model: {exp.step} steps, bilstm_core {core}")
        with open(os.path.join(run, "train_log", "loss", "epoch-loss.csv"), newline="") as fp:
            rows = list(csv.DictReader(fp))
        losses = [float(r["train_total"]) for r in rows]
        ploss = [float(r["train_scalar_ploss"]) for r in rows]
        out.update(epochs=len(rows), epoch_loss=losses, epoch_scalar_ploss=ploss,
                   scalers=sorted(exp.scalers), **train_timing(run))
        # the total is divided by each term's running RMS (dynamic scalers), so the
        # raw position loss is what must fall
        if not (rows and np.isfinite(losses).all() and ploss[-1] < ploss[0]):
            raise RuntimeError(f"offsets train_model: the loss did not fall: {ploss}")

        hp_s = configure("offsets", dataset_root=root)
        model = build_model(hp_s)
        model.load_state_dict(checkpoints.load_checkpoint(os.path.join(run, "last.ckpt"))["model"])
        served = AnimationTask(hp_s, model, dev)
        served.warmup(3.0)
        clip = signal(3.0, int(hp_s.audio.sample_rate), 70)
        reset_counts(counters)
        ts, v = served.generate_vertices(clip, 1)
        for name, n in read_counts(counters, "offsets_train serve",
                                   zero=("decode_solve",)).items():
            path[name] += n
        if v.shape != (len(ts), FLAME_COUNTS[0], 3) or not np.isfinite(v).all():
            raise RuntimeError(f"offsets trained checkpoint: bad output {v.shape}")
        with ops.plain_versions():
            _, v_plain = served.generate_vertices(clip, 1)
        out["serve"] = {"audio_s": 3.0, "windows": len(ts),
                        "float64_max_abs_m": float(np.abs(
                            v - offsets_host_decode(served, clip, 1)).max()),
                        "plain_max_abs_m": max_err(v, v_plain),
                        "float64_tol_m": OFFSETS_HOST_TOL_M, "plain_tol_m": OFFSETS_PLAIN_TOL_M}
        emit(out)
        if not (out["serve"]["float64_max_abs_m"] <= OFFSETS_HOST_TOL_M
                and out["serve"]["plain_max_abs_m"] <= OFFSETS_PLAIN_TOL_M):
            raise RuntimeError(f"offsets trained checkpoint: {out['serve']}")
    return path



def write_raw_vocaset(tmp):
    """A raw tree in VOCASET's layout under ``tmp/raw`` and a FLAME-layout
    template (``mesh.synthetic_template``, its non-face mask beside it as
    data) → (raw root, template path). Per sentence of ``PRE_SENTENCES``:
    ``PRE_AUDIO_S`` of 22050 Hz audio with a quiet 0.4 s head (the VAD and the
    trims act on it), 60 fps meshes over the same span moving six bumps of the
    template's free band with seeded smooth coefficients, and the speaker's
    template."""
    import numpy as np

    from sdfa_tpu_torch.audio import io as audio_io
    from sdfa_tpu_torch.data.vocaset import config as vc
    from sdfa_tpu_torch.mesh import read_ply, synthetic_template, write_ply

    verts, faces, cnst = synthetic_template(SEED)
    tpl = os.path.join(tmp, "flame", "template", "FLAME_sample.ply")
    os.makedirs(os.path.dirname(tpl))
    os.makedirs(os.path.join(tmp, "flame", "mask"))
    write_ply(tpl, verts, faces)
    is_cnst = np.zeros(len(verts), bool)
    is_cnst[cnst] = True
    tris = np.nonzero(is_cnst[faces].all(1))[0]
    with open(os.path.join(tmp, "flame", "mask", "non_face.py"), "w") as fp:
        fp.write(f"non_face_verts = {cnst.tolist()}\nnon_face_tris = {tris.tolist()}\n")
    base = read_ply(tpl, dtype=np.float64)[0]
    rng = np.random.default_rng(SEED)
    free = np.nonzero(~is_cnst)[0]
    bumps = [np.exp(-np.sum((base - base[c]) ** 2, 1) / (2 * 0.015 ** 2))[:, None]
             * ~is_cnst[:, None] * rng.normal(size=3) for c in rng.choice(free, 6)]
    sr, raw = 22050, os.path.join(tmp, "raw")
    n, head = int(PRE_AUDIO_S * sr), int(0.4 * sr)
    t = np.arange(n) / sr
    for k, (spk, sent) in enumerate(PRE_SENTENCES):
        alias = vc.SPEAKER_ALIAS[spk]
        srng = np.random.default_rng(200 + k)
        phase = np.cumsum(2 * np.pi * srng.uniform(110, 220) * (1 + 0.1 * np.sin(2.6 * t)) / sr)
        voiced = sum(np.sin(h * phase) / h for h in range(1, 6))
        wav = 0.2 * voiced * np.clip(np.sin(2 * np.pi * 3.1 * t) + 0.7, 0, None)
        wav[:head] = 0.0
        wav = (wav + srng.normal(0, 0.001, n)).astype(np.float32)
        os.makedirs(os.path.join(raw, "audio", alias), exist_ok=True)
        audio_io.save(os.path.join(raw, "audio", alias, f"sentence{sent:02d}.wav"), wav, sr)
        os.makedirs(os.path.join(raw, "templates"), exist_ok=True)
        write_ply(os.path.join(raw, "templates", f"{alias}.ply"), verts, faces)
        mdir = os.path.join(raw, "unposedcleaneddata", alias, f"sentence{sent:02d}")
        os.makedirs(mdir)
        freqs, offs = srng.uniform(0.5, 4.0, 6), srng.uniform(0, 2 * np.pi, 6)
        for fi in range(int(PRE_AUDIO_S * 60)):
            amp = 0.004 * np.sin(2 * np.pi * freqs * fi / 60 + offs)
            write_ply(os.path.join(mdir, f"sentence{sent:02d}.{fi:06d}.ply"),
                      base + sum(a * b for a, b in zip(amp, bumps)), faces)
    return raw, tpl


def preprocess_phase(repo, dev, smi, tmp):
    """``python -m sdfa_tpu_torch preprocess --pitch_variants`` as a subprocess
    on a raw tree (``write_raw_vocaset``), its output held on the card's
    host: ``PRE_CHECK_FRAMES`` seeded dgrad files of each sentence against the
    numpy float64 plain version, the fitted
    components against a float64 numpy SVD with sklearn's sign rule (and the
    covariance route on the card at the offsets' 15069 columns), a few frames
    solved back to the template plus the smoothed offsets. Then
    ``api.train_model`` for ``PRE_TRAIN_STEPS`` raw-mode steps with
    ``random_pitch_shift`` (the PCA heads at the fitted counts; K5 3 / 3 a
    step) and one 3 s request from the checkpoint (K1 / K2 / K3 1 / 1 / 1)
    against the plain versions and the float64 host decode + solve. Returns
    the launch counts of the phase's path (its comparisons not counted)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from scipy.ndimage import gaussian_filter1d

    from sdfa_tpu_torch import api, ops
    from sdfa_tpu_torch.config import configure
    from sdfa_tpu_torch.data.vocaset import config as vc
    from sdfa_tpu_torch.data.vocaset import preload
    from sdfa_tpu_torch.mesh import FLAME_COUNTS, read_ply
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.ops import bilstm2, bilstm_core, decode_solve, freq_lstm
    from sdfa_tpu_torch.ops.dgrad import deformation_gradients_np, rotation_cut_flips
    from sdfa_tpu_torch.task import AnimationTask
    from sdfa_tpu_torch.train import checkpoints
    from sdfa_tpu_torch.viewer import frame

    counters = {"freq_lstm": freq_lstm, "bilstm2": bilstm2, "decode_solve": decode_solve}
    out = {"phase": "preprocess", "card": smi, "wall_s": {}}
    t_phase = t0 = time.perf_counter()
    raw, tpl = write_raw_vocaset(tmp)
    out["wall_s"]["raw_tree"] = time.perf_counter() - t0

    # 1. the CLI's preprocess mode as a user runs it
    data = os.path.join(tmp, "data")
    cmd = [sys.executable, "-m", "sdfa_tpu_torch", "preprocess", "--source_root", raw,
           "--dataset_root", data, "--template_mesh", tpl, "--pitch_variants",
           "--platform", "cpu" if str(dev) == "cpu" else "gpu"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                          timeout=CLI_SUBPROCESS_TIMEOUT_S)
    out["wall_s"]["subprocess"] = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"preprocess exited {proc.returncode}: {proc.stderr[-3000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    root, out["stage_s"] = result["dataset_root"], result["stage_s"]
    offsets_root = os.path.join(data, "offsets")

    # 2. a seeded sample of each sentence's dgrad files against the numpy plain version
    t0 = time.perf_counter()
    pick_rng = np.random.default_rng(0)
    _, faces = read_ply(tpl)
    nf_verts, nf_tris = vc.non_face_masks(tpl)
    jobs = []
    for spk in sorted(os.listdir(os.path.join(offsets_root, "data"))):
        template = read_ply(os.path.join(raw, "templates", f"{vc.SPEAKER_ALIAS[spk]}.ply"),
                            dtype=np.float64)[0]
        sdir = os.path.join(offsets_root, "data", spk, "neutral")
        for sent in sorted(d for d in os.listdir(sdir) if os.path.isdir(os.path.join(sdir, d))):
            files = sorted((f for f in os.listdir(os.path.join(sdir, sent))
                            if preload._NPY_FRAME_RE.match(f)), key=lambda f: int(f[:-4]))
            offs = gaussian_filter1d(np.stack([np.load(os.path.join(sdir, sent, f))
                                               for f in files]), sigma=1.0, axis=0)
            pick = sorted(pick_rng.choice(len(files), min(PRE_CHECK_FRAMES, len(files)),
                                          replace=False))
            jobs += [(template, offs[i], os.path.join(root, "data", spk, "neutral", sent,
                                                      files[i])) for i in pick]

    def plain_err(job):
        template, offsets, path = job
        want = deformation_gradients_np(template, template + offsets.reshape(-1, 3), faces)
        want[nf_tris] = 0.0
        got = np.load(path).reshape(-1, 9)
        diff = np.abs(want.astype(np.float32) - got)
        flips = rotation_cut_flips(want, got)  # rows the two SVDs put across the 1e-6 rad cut
        diff[flips, 6:] = 0.0
        return float(diff.max()), int(flips.sum())

    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:  # numpy's SVD loop frees the GIL
        errs = list(pool.map(plain_err, jobs))
    out["dgrad_files"] = {"files": len(errs), "sentences": len(PRE_SENTENCES),
                          "max_abs_vs_numpy_f64": max(e for e, _ in errs),
                          "rotations_across_the_1e-6_rad_cut": sum(n for _, n in errs),
                          "tol": DGRAD_FILE_TOL, "check_s": time.perf_counter() - t0}
    if not (len(errs) == PRE_CHECK_FRAMES * len(PRE_SENTENCES)
            and out["dgrad_files"]["max_abs_vs_numpy_f64"] <= DGRAD_FILE_TOL):
        raise RuntimeError(f"dgrad files vs the numpy plain version: {out['dgrad_files']}")

    # 3. the fits against a float64 numpy SVD with sklearn's selection and sign rule
    t0 = time.perf_counter()
    frames = {"offsets": preload._load_training_frames(offsets_root, 1)}
    dg = preload._load_training_frames(root, 1).reshape(-1, vc.N_TRIS, 9)
    frames["scale_"] = dg[:, :, :6].reshape(len(dg), -1)
    frames["rotat_"] = dg[:, :, 6:].reshape(len(dg), -1)
    pca, numpy_fit = {}, {}
    for part, x in frames.items():
        pdir = os.path.join(offsets_root if part == "offsets" else root, "pca")
        prefix = "" if part == "offsets" else part
        comp = np.load(os.path.join(pdir, f"{prefix}compT.npy")).T
        means = np.load(os.path.join(pdir, f"{prefix}means.npy"))
        want, want_mean = numpy_fit[part] = preload.fit_pca_np(x)
        pca[part] = {"frames": len(x), "columns": x.shape[1], "components": len(comp),
                     "numpy_components": len(want),
                     "max_abs_vs_numpy": float(np.abs(comp - want).max())
                     if comp.shape == want.shape else None,
                     "means_max_abs_vs_numpy": float(np.abs(means - want_mean).max())}
    # the covariance route, which the full dataset's 59856 columns take, at 15069
    t1 = time.perf_counter()
    gram, _ = preload.fit_pca(frames["offsets"], device=dev, route="gram")
    pca["offsets"]["gram_route_s"] = time.perf_counter() - t1
    want = numpy_fit["offsets"][0]
    pca["offsets"]["gram_route_max_abs_vs_numpy"] = (
        float(np.abs(gram - want).max()) if gram.shape == want.shape else None)
    out["pca"], out["pca_check_s"], out["pca_tol"] = pca, time.perf_counter() - t0, PCA_TOL
    for part, v in pca.items():
        errs = [v["max_abs_vs_numpy"], v.get("gram_route_max_abs_vs_numpy", 0.0)]
        if None in errs or max(errs) > PCA_TOL or not v["means_max_abs_vs_numpy"] <= 1e-7:
            raise RuntimeError(f"PCA fit {part!r} vs numpy: {v}")
    del frames, dg

    # 4. dgrad files solved back to the template plus the smoothed offsets
    solver = frame.set_template_mesh(template_path=tpl)  # constraints: the mask's vertices
    template = read_ply(tpl, dtype=np.float64)[0]
    picks = [jobs[i] for i in np.linspace(0, len(jobs) - 1, 4).astype(int)]
    rt = [float(np.abs(solver.solve_host(np.load(path).reshape(-1, 9))
                       - (template + offsets.reshape(-1, 3))).max())
          for _, offsets, path in picks]
    out["solve_back"] = {"frames": len(rt), "max_abs_m": max(rt), "tol_m": PRE_ROUNDTRIP_TOL_M}
    if not max(rt) <= PRE_ROUNDTRIP_TOL_M:
        raise RuntimeError(f"dgrad files solved back: {out['solve_back']}")

    # 5. training on the preprocessed root: the PCA heads take the fitted counts
    hp = configure("dgrad")
    heads = {}
    for part in ("scale", "rotat"):
        k = int(np.load(os.path.join(root, "pca", f"{part}_compT.npy")).shape[1])
        layers = [tuple(s) for s in hp.model.output[f"layers_{part}"]]
        heads[f"layers_{part}"] = layers[:-1] + [layers[-1][:2] + (k,) + layers[-1][3:]]
    out["pca_heads"] = {"scale": heads["layers_scale"][-1][2],
                        "rotat": heads["layers_rotat"][-1][2],
                        "note": "the only widths taken from the data"}
    overrides = {"model": {"output": heads}, "trainer": {"pca_targets": True},
                 "audio": {"feature": {"random_pitch_shift": True}}}
    bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
    reset_counts(counters)
    run = os.path.join(tmp, "run")
    t0 = time.perf_counter()
    exp = api.train_model("dgrad", dataset_root=root, log_dir=run, max_steps=PRE_TRAIN_STEPS,
                          overrides=overrides, device=dev)
    out["wall_s"]["train_model"] = time.perf_counter() - t0
    path = read_counts(counters, "preprocess train_model", zero=tuple(counters))
    core = (bilstm_core.FWD_LAUNCHES, bilstm_core.BWD_LAUNCHES)
    path.update(bilstm_core_fwd=core[0], bilstm_core_bwd=core[1])
    out["train"] = {"steps": exp.step, "bilstm_core_launches": list(core),
                    "per_step": [c / max(exp.step, 1) for c in core],
                    "random_pitch_shift": bool(exp.hp.audio.feature.random_pitch_shift)}
    if exp.step != PRE_TRAIN_STEPS or core != (3 * PRE_TRAIN_STEPS,) * 2:
        raise RuntimeError(f"preprocess train_model: {out['train']}")

    # 6. the trained checkpoint serves one 3 s request over the FLAME-layout template
    hp_s = configure("dgrad", dataset_root=root, overrides={"model": {"output": heads}})
    model = build_model(hp_s)
    model.load_state_dict(checkpoints.load_checkpoint(os.path.join(run, "last.ckpt"))["model"])
    served = AnimationTask(hp_s, model, dev)
    served.warmup(3.0)
    clip = signal(3.0, int(hp_s.audio.sample_rate), 90)
    reset_counts(counters)
    t0 = time.perf_counter()
    ts, v = served.generate_vertices(clip, "m0")
    out["wall_s"]["request"] = time.perf_counter() - t0
    for name, n in read_counts(counters, "preprocess serve").items():
        path[name] += n
    out["serve_launches"] = {name: launched(mod) for name, mod in counters.items()}
    if v.shape != (len(ts), FLAME_COUNTS[0], 3) or not np.isfinite(v).all():
        raise RuntimeError(f"preprocessed checkpoint: bad output {v.shape}")
    with ops.plain_versions():
        _, v_plain = served.generate_vertices(clip, "m0")
    sample = sorted({int(i) for i in np.linspace(0, len(ts) - 1, 6)})
    with torch.inference_mode():
        frame_idx, _, z, _ = served._overlap_prefix(clip)
        spk = dict(hp_s.dataset_anime.speakers)["m0"]
        preds, _, _ = model.forward_windows(
            z, torch.from_numpy(frame_idx[sample]).long().to(dev),
            torch.full((len(sample),), spk, dtype=torch.long, device=dev), raw_pca=True)
    dec = []
    for part, per in (("scale", 6), ("rotat", 3)):
        c = preds[f"dgrad_3d_{part}_pca"][:, 0].double().cpu().numpy()
        pca_mod = getattr(model, f"{part}_pca")
        dec.append((c @ pca_mod.compT.double().cpu().numpy().T
                    + pca_mod.means.double().cpu().numpy()).reshape(len(c), -1, per))
    oracle = np.stack([solver.solve_host(d) for d in np.concatenate(dec, axis=-1)])
    out["serve"] = {"audio_s": 3.0, "windows": len(ts),
                    "plain_max_abs_m": max_err(v, v_plain), "plain_tol_m": PRE_PLAIN_TOL_M,
                    "f64_decode_solve_max_abs_m": float(np.abs(v[sample] - oracle).max()),
                    "f64_tol_m": ORACLE_TOL_M, "vertex_motion_max_m": float(np.abs(
                        v - template.astype(np.float32)).max())}
    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    emit(out)
    if not (out["serve"]["plain_max_abs_m"] <= PRE_PLAIN_TOL_M
            and out["serve"]["f64_decode_solve_max_abs_m"] <= ORACLE_TOL_M):
        raise RuntimeError(f"preprocessed checkpoint: {out['serve']}")
    return path


def fanout_table(nf: int):
    """The retarget phase's correspondences onto ``nf`` triangles: two sources
    on every even triangle, none on every fifth, otherwise one to one, as
    (corr_count, corr_faces) and as the file's (source, target) rows."""
    count, faces, rows = [], [], []
    for i in range(nf):
        if i % 5 == 4:
            count.append(0)
            faces.append(0)
        elif i % 2 == 0:
            count.append(2)
            faces.extend([i, (i + 3) % nf])
            rows += [(i, i), ((i + 3) % nf, i)]
        else:
            count.append(1)
            faces.append(i)
            rows.append((i, i))
    return count, faces, rows


def retarget_phase(hp, model, sig, spk, v_ref, dev, sr, smi, tmp):
    """The shipped dgrad model (the serve phase's seeded weights and bases)
    over ``mesh.synthetic_template`` with triangle correspondences in the
    reference's file format (``fanout_table``): the float64 solver build; one
    3 s request on f32, i16 and i8d (K1 / K2 1 / 1 each and K3's full body
    once, its delta body not) against ``solve_host`` of its own decoded dgrads;
    a ``StreamingSession`` against the offline request; a capacity-8
    ``StreamingServer`` on coef decoded by ``CoefDecoder`` against the float64
    decode of the same coefficients; the request's device time by kernel,
    through K3's full body and through the route before it (the decode to
    planes and ``solve_fn``), and the f32 product over the equations alone.
    Then the one-to-one file (recognized as the identity table: K3's delta
    body) and the same table with every equation twice (its full body) against
    the serve phase's request without a file. Returns the launch counts of the
    f32 request."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdfa_tpu_torch.mesh import FLAME_COUNTS, synthetic_template
    from sdfa_tpu_torch.ops import bilstm2, decode_solve, freq_lstm
    from sdfa_tpu_torch.ops.deform_solver import equation_entries
    from sdfa_tpu_torch.streaming import CoefDecoder, StreamingServer
    from sdfa_tpu_torch.task import AnimationTask
    from sdfa_tpu_torch.viewer import frame

    counters = {"freq_lstm": freq_lstm, "bilstm2": bilstm2, "decode_solve": decode_solve}
    out = {"phase": "retarget", "card": smi}
    t_phase = time.perf_counter()
    verts, faces, cnst = synthetic_template(SEED)
    nf = len(faces)

    def corres(name, rows):
        path = os.path.join(tmp, f"{name}.txt")
        with open(path, "w") as fp:
            fp.write(f"{len(rows)}\n" + "".join(f"{s},{d},0\n" for s, d in rows))
        t0 = time.perf_counter()
        solver = frame.set_template_mesh(verts, faces, cnst, corres_path=path)
        return solver, time.perf_counter() - t0

    rows = fanout_table(nf)[2]
    solver, out["solver_build_s"] = corres("fanout", rows)
    out.update(n_tris=nf, n_eqs=solver.n_eqs, identity_rows=int((solver._eq_src < 0).sum()))
    if solver.spec.identity_eq or solver.n_eqs != len(rows) + nf // 5:
        raise RuntimeError(f"correspondence table: {solver.n_eqs} equations for {len(rows)} rows")
    task = AnimationTask(hp, model, dev)
    task.warmup(3.0)

    # 1. one request a wire, against the float64 solve of its own decoded dgrads
    lines, got = {}, {}
    for wire in ("f32", "i16", "i8d"):
        task.generate_vertices(sig, spk, wire=wire)
        reset_counts(counters)
        t0 = time.perf_counter()
        ts, v = task.generate_vertices(sig, spk, wire=wire)
        wall = 1e3 * (time.perf_counter() - t0)
        counts = read_counts(counters, f"retarget {wire}", k3_full=True)
        if counts != {"freq_lstm": 1, "bilstm2": 1, "decode_solve": 0, "decode_solve_full": 1}:
            raise RuntimeError(f"retarget {wire}: launches {counts}")
        if v.shape != (len(ts), FLAME_COUNTS[0], 3) or not np.isfinite(v).all():
            raise RuntimeError(f"retarget {wire}: bad output {v.shape}")
        got[wire] = (ts, v)
        lines[wire] = {"wall_ms": wall, "launches": counts}
    ts, v = got["f32"]
    sample = sorted({int(i) for i in np.linspace(0, len(ts) - 1, 6)})
    with torch.inference_mode():
        frame_idx, _, z, _ = task._overlap_prefix(sig)
        preds, _, _ = model.forward_windows(
            z, torch.from_numpy(frame_idx[sample]).long().to(dev),
            torch.full((len(sample),), spk, dtype=torch.long, device=dev), raw_pca=True)
        dgrad = model.decode_to_anime(preds)[:, 0].double().cpu().numpy()
    oracle = np.stack([solver.solve_host(d) for d in dgrad])
    for wire, (_, vw) in got.items():
        lines[wire]["max_abs_m_vs_f64_solve"] = max_err(vw[sample], oracle)
        lines[wire]["max_abs_m_vs_f32"] = max_err(vw, v)
        if not (lines[wire]["max_abs_m_vs_f64_solve"] <= ORACLE_TOL_M + WIRE_TOL_M[wire]
                and lines[wire]["max_abs_m_vs_f32"] <= WIRE_TOL_M[wire]):
            raise RuntimeError(f"retarget {wire}: {lines[wire]}")
    out["wires"] = lines
    out["tol_m"] = {"vs_f64_solve": ORACLE_TOL_M, "vs_f32": WIRE_TOL_M}

    # 2. the request's device time by kernel through K3's full body and through the route
    #    before it (decode to planes, solve_fn's f32 product over the equations), and that
    #    product alone
    def profiled(t):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, verts_out = t.generate_vertices(sig, spk)
            torch.cuda.synchronize()
        return (*device_kernels(prof), verts_out)

    device, busy_ms, _ = profiled(task)
    solver_, consts, _ = task._decode_consts()
    task_solve_fn = AnimationTask(hp, model, dev)
    task_solve_fn._decode = (solver_, consts, None)  # the decode to planes and solve_fn
    task_solve_fn.warmup(3.0)
    device_old, busy_old_ms, v_old = profiled(task_solve_fn)
    del task_solve_fn
    w = len(ts)
    t9 = torch.randn(w, 9, nf, device=dev)
    t_eq = equation_entries(consts, solver.spec, t9).reshape(-1, 3 * solver.n_eqs)
    p = consts.p.reshape(3 * solver.n_eqs, solver.n_free)
    prod_ms = time_ms(lambda: t_eq @ p, 5)
    flops = 2.0 * t_eq.shape[0] * t_eq.shape[1] * p.shape[1]
    out["profile"] = {"device_busy_ms": busy_ms, "request_wall_ms": lines["f32"]["wall_ms"],
                      "top_device_ms": [{"name": k[:80], "ms": ms, "calls": c}
                                        for k, ms, c in device[:10]],
                      "solve_fn_route": {"device_busy_ms": busy_old_ms,
                                         "max_abs_m_vs_full_body": max_err(v_old, v),
                                         "tol_m": TOL["decode_solve_full"],
                                         "top_device_ms": [{"name": k[:80], "ms": ms, "calls": c}
                                                           for k, ms, c in device_old[:6]]},
                      "f32_product_over_n_eqs": {
                          "shape": [list(t_eq.shape), list(p.shape)], "ms": prod_ms,
                          "bound_ms": bound(flops, nbytes(t_eq, p) + 4 * t_eq.shape[0]
                                            * p.shape[1])[0],
                          "tflops": flops / prod_ms / 1e9}}
    del t9, t_eq
    if not out["profile"]["solve_fn_route"]["max_abs_m_vs_full_body"] <= TOL["decode_solve_full"]:
        raise RuntimeError(f"retarget: K3's full body vs solve_fn {out['profile']}")

    # 3. a live session and a coef server on the correspondence template
    reset_counts(counters)
    out["session_launches"] = session_phase(task, counters, sig, spk, ts, v, smi,
                                            phase="retarget_session", k3_full=True)
    n = 8
    clips = [signal(2.0 + 0.125 * k, sr, 140 + k) for k in range(n)]
    decoder = CoefDecoder(task)
    srv = StreamingServer(task, capacity=n, emit_batch=16, block_frames=16, wire="coef")
    reset_counts(counters)
    streams, tick_ms, _ = drive_server(srv, clips, list(range(n)), 2 * 16 * task.wspec.hop_size)
    counts = read_counts(counters, "retarget server coef", zero=("decode_solve",))
    errs = []
    for k, frames in enumerate(streams):
        coefs = np.stack([c for _, c in frames])
        errs.append(max_err(decoder.decode(coefs), decoder.decode(coefs, precise=True)))
        if [t for t, _ in frames] != list(task.generate_vertices(clips[k], k)[0]):
            raise RuntimeError(f"retarget server: stream {k}'s timeline differs from offline")
    out["server_coef"] = {"capacity": n, "streams": n, "max_abs_m_vs_f64": max(errs),
                          "tol_m": COEF_ORACLE_TOL_M, "ticks": len(tick_ms),
                          "tick_ms_median": sorted(tick_ms)[len(tick_ms) // 2],
                          "launches": counts}
    if not max(errs) <= COEF_ORACLE_TOL_M:
        raise RuntimeError(f"retarget coef server: {out['server_coef']}")

    # 4. identity tables: the one-to-one file (K3's delta body) and every equation twice
    #    (not an identity table: its full body)
    idents = {}
    for name, table in (("one_to_one", [(i, i) for i in range(nf)]),
                        ("doubled", [(i, i) for i in range(nf) for _ in range(2)])):
        solver_i, build_s = corres(name, table)
        task_i = AnimationTask(hp, model, dev)
        task_i.warmup(3.0)
        reset_counts(counters)
        _, vi = task_i.generate_vertices(sig, spk)
        counts = read_counts(counters, f"retarget {name}", k3_full=name == "doubled")
        idents[name] = {"identity_table": solver_i.spec.identity_eq, "n_eqs": solver_i.n_eqs,
                        "solver_build_s": build_s, "launches": counts,
                        "max_abs_m_vs_no_file": max_err(vi, v_ref)}
        if (solver_i.spec.identity_eq != (name == "one_to_one")
                or not idents[name]["max_abs_m_vs_no_file"] <= IDENTITY_TOL_M):
            raise RuntimeError(f"identity table {name}: {idents[name]}")
        del task_i
    out["identity_tables"], out["identity_tol_m"] = idents, IDENTITY_TOL_M
    out["phase_wall_s"] = time.perf_counter() - t_phase
    emit(out)
    torch.cuda.empty_cache()
    return lines["f32"]["launches"]


def longrun_main(steps: int):
    """``python3 chip_smoke.py --longrun STEPS``: the ``longrun`` phase alone at
    ``STEPS`` steps (the tool's own default is 2500), then the card's name and
    power limit and the result line."""
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "sdfa_tpu_torch")):
        sys.exit("chip_smoke.py: the sdfa_tpu_torch package is not beside this script")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is false; this needs a GPU")
    processes_before = group_processes()
    from sdfa_tpu_torch.ops import build

    build.load_libraries(["freq_lstm", "bilstm2", "decode_solve", "bilstm_layer", "bilstm_core"])
    smi = nvidia_smi_line()
    with tempfile.TemporaryDirectory(prefix="sdfa_chip_longrun_") as tmp:
        longrun_phase(root, torch.device("cuda:0"), smi, tmp, steps)
    check_no_process_left(processes_before)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def load_file(repo, path):
    """A tool or example of the repository, imported from its file."""
    import importlib.util

    name = "_chip_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(repo, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_json(cmd, repo, what):
    """Run ``cmd`` from the repository's root to its end; its stdout's JSON lines
    and its wall seconds. Raises with the end of its output if it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=TOOL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"{what} exited {proc.returncode}: {proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")], wall


def stream_capacity_phase(task, repo, smi):
    """``tools/stream_capacity_torch.py`` as a subprocess on the full-width dgrad
    model (seeded weights, the synthetic template): N streams of an 8 s clip
    each until all are done, delivered and pipelined at N = 8, 32, 128 on i16,
    device-only at 8 and 128, on coef at 8 with the client's decode timed.
    Every round's frames must be N times an offline request's of the same clip;
    K1, K2 and K3's delta body must launch on i16, K3 not at all on coef.
    Returns the launches of the timed rounds, summed."""
    out = {"phase": "stream_capacity", "card": smi, "clip_s": CAPACITY_CLIP_S, "rounds": [],
           "wall_s": {}}
    path = collections.Counter()
    try:
        clip = load_file(repo, "tools/stream_capacity_torch.py")._clip(task.hp, CAPACITY_CLIP_S)
        offline = out["offline_frames"] = len(task.generate_vertices(clip, 0)[0])
        for mode, args in CAPACITY_RUNS:
            lines, out["wall_s"][mode] = run_json(
                [sys.executable, os.path.join(repo, "tools", "stream_capacity_torch.py"),
                 "--clip-s", str(CAPACITY_CLIP_S), *args], repo, f"stream_capacity {mode}")
            for line in lines:
                if "n" in line:
                    out["rounds"].append({"mode": mode, **line})
                elif "client_decode" in line:
                    out["client_decode"] = line["client_decode"]
                elif "capacity" in line:
                    out.setdefault("capacity", {})[mode] = line["capacity"]
        for r in out["rounds"]:
            launches, coef = r["launches"], r["mode"] == "coef"
            path.update(launches)
            if r["frames"] != r["n"] * offline:
                raise RuntimeError(f"stream_capacity {r['mode']} N = {r['n']}: {r['frames']} "
                                   f"frames, not {r['n']} x {offline}")
            if not (launches["freq_lstm"] > 0 and launches["bilstm2"] > 0
                    and (launches["decode_solve"] == 0 if coef else launches["decode_solve"] > 0)
                    and launches["decode_solve_full"] == 0):
                raise RuntimeError(f"stream_capacity {r['mode']} N = {r['n']}: launches "
                                   f"{launches}")
        want = {(mode, n) for mode, args in CAPACITY_RUNS for n in args[1:] if n.isdigit()}
        if {(r["mode"], str(r["n"])) for r in out["rounds"]} != want or "client_decode" not in out:
            raise RuntimeError(f"stream_capacity: rounds {out['rounds']}")
    finally:
        emit(out)  # what was measured, also when a check failed
    return {k: path[k] for k in ("freq_lstm", "bilstm2", "decode_solve")}


def longrun_phase(repo, dev, smi, tmp, steps=LONGRUN_STEPS):
    """``tools/longrun_train_torch.py --steps STEPS`` as a subprocess: the dataset
    it generates, then ``api.train_model`` on it in raw mode with PCA targets.
    Its wall seconds, the median interval between step dispatches, the first
    and last epochs' train losses (every one finite; the position loss of the
    last below the first's: the total is divided by each term's running RMS,
    the dynamic scalers, and need not fall), its K5 launches (3 + 3 a step),
    the checkpoints written. The shipped config runs no validation epoch, so
    the last checkpoint's validation loss is taken here, in process, over the
    dataset's validation windows (K1 / K2 once a batch; the plain versions'
    within ``STEP_LOSS_RTOL``), and in training mode. Returns the launches and
    what the ``examples`` phase reuses."""
    import csv

    import numpy as np
    import torch

    from sdfa_tpu_torch import ops
    from sdfa_tpu_torch.config import ConfigDict
    from sdfa_tpu_torch.data import DatasetSlidingWindow
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.ops import bilstm2, freq_lstm
    from sdfa_tpu_torch.train import Experiment

    run, root = os.path.join(tmp, "longrun"), os.path.join(tmp, "longrun_voca")
    out = {"phase": "longrun", "card": smi, "steps": steps}
    try:
        lines, out["wall_s"] = run_json(
            [sys.executable, os.path.join(repo, "tools", "longrun_train_torch.py"), "--steps",
             str(steps), "--run-dir", run, "--root", root], repo, "longrun")
        path = dict(lines[-1]["launches"])
        out["launches"] = dict(path)
        with open(os.path.join(run, "train_log", "loss", "epoch-loss.csv"), newline="") as fp:
            rows = list(csv.DictReader(fp))
        train_keys = sorted(k for k in rows[0] if k.startswith("train_"))
        out.update(epochs=len(rows), **train_timing(run),
                   first_epoch=({k: float(rows[0][k]) for k in train_keys}),
                   last_epoch=({k: float(rows[-1][k]) for k in train_keys}),
                   epoch_train_total=[float(r["train_total"]) for r in rows],
                   checkpoints=sorted(f for f in os.listdir(run) if f.endswith(".ckpt")))
        bad = [(r["epoch"], k) for r in rows for k, v in r.items()
               if k != "epoch" and not np.isfinite(float(v))]
        core = (path["bilstm_core_fwd"], path["bilstm_core_bwd"])
        ploss = "train_scalar_ploss"
        if bad or core != (3 * steps,) * 2 or "last.ckpt" not in out["checkpoints"] or \
                not out["last_epoch"][ploss] < out["first_epoch"][ploss]:
            raise RuntimeError(f"longrun: non-finite {bad}, launches {path}, "
                               f"checkpoints {out['checkpoints']}, {ploss} "
                               f"{out['first_epoch'][ploss]} -> {out['last_epoch'][ploss]}")

        # the last checkpoint's validation loss, through the kernels in eval mode
        hp = ConfigDict.parse_file(os.path.join(run, "hparams.json"))
        ckpt = os.path.join(run, "last.ckpt")
        exp = Experiment(hp, build_model(hp), os.path.join(tmp, "longrun_valid"), dev,
                         load_from=ckpt)
        reset_counts({"freq_lstm": freq_lstm, "bilstm2": bilstm2})
        t0 = time.perf_counter()
        batches = DatasetSlidingWindow(hp, training=False).raw_batches(
            int(hp.trainer.anime_loader.batch_size), shuffle=False)
        batches = list(batches)
        rows = [{k: float(v) for k, v in exp.eval_step(b).items()} for b in batches]
        torch.cuda.synchronize()
        valid = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]} if rows else {}
        out["validation"] = {"batches": len(rows), "s": time.perf_counter() - t0,
                             "launches": {"freq_lstm": launched(freq_lstm),
                                          "bilstm2": launched(bilstm2)}, "loss": valid}
        path["freq_lstm"] += launched(freq_lstm)
        path["bilstm2"] += launched(bilstm2)
        # eval mode through the plain versions, and the same windows in training mode
        # (BatchNorm on each batch's statistics, not the running ones; no update): how far
        # eval mode's running statistics lag
        with ops.plain_versions():
            out["validation"]["plain_scalar_ploss"] = float(np.mean(
                [float(exp.eval_step(b)["scalar_ploss"]) for b in batches]))
        exp.model.train()
        with torch.no_grad():
            out["validation"]["training_mode_scalar_ploss"] = float(np.mean([float(
                exp.loss_fn(exp.scalers, exp.put_batch(b), True)[1]["scalars"]["scalar_ploss"])
                for b in batches]))
        del exp
        plain_rel = abs(out["validation"]["plain_scalar_ploss"] / valid["scalar_ploss"] - 1)
        out["validation"]["kernels_vs_plain_rel"] = plain_rel
        if not rows or not all(np.isfinite(v) for v in valid.values()) or \
                min(out["validation"]["launches"].values()) < len(rows) or \
                not plain_rel <= STEP_LOSS_RTOL:
            raise RuntimeError(f"longrun validation: {out['validation']}")
    finally:
        emit(out)  # what was measured, also when a check failed
    return path, {"ckpt": ckpt, "root": root}


def examples_phase(longrun, repo, dev, smi, tmp):
    """The long run's ``last.ckpt`` through the port's examples. ``python -m
    sdfa_tpu_torch serve --capacity 8``, ``examples/torch_serve_vertices.py`` on
    a 3 s formant wav, ``evaluate_torch.sh`` (a 1 s wav, with video) and
    ``examples/torch_render_template.py`` start first as subprocesses, side by
    side. The OBJ count must equal an offline request's frames (K1 / K2 / K3
    1 / 1 / 1, in process), and its middle frame, read back, be within
    ``ORACLE_TOL_M`` of the native float64 solve of the same frame's planes;
    the evaluation and the renderer must exit 0 and their files exist and not
    be empty. Then, alone beside the service, ``examples/torch_stream_client.py``
    pushes the wav in 100 ms chunks at real pace on loopback, writing no OBJ:
    the offline frame count, and frames while still pushing; the service is
    terminated and reaped. Returns the in-process request's launches."""
    import numpy as np
    import torch

    from sdfa_tpu_torch import api, native
    from sdfa_tpu_torch.audio import io as audio_io
    from sdfa_tpu_torch.audio import rms
    from sdfa_tpu_torch.mesh import FLAME_COUNTS, synthetic_template, write_ply
    from sdfa_tpu_torch.ops import bilstm2, decode_solve, freq_lstm
    from sdfa_tpu_torch.viewer import frame

    counters = {"freq_lstm": freq_lstm, "bilstm2": bilstm2, "decode_solve": decode_solve}
    ckpt, root = longrun["ckpt"], longrun["root"]
    out = {"phase": "examples", "card": smi, "wall_s": {}}
    procs, logs = {}, {}
    saved_frame = dict(frame._state)
    t_phase = time.perf_counter()

    def start(name, cmd, cwd=repo):
        # the package from this checkout also where the command runs elsewhere
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (repo, os.environ.get("PYTHONPATH")) if p))
        logs[name] = os.path.join(tmp, f"example_{name}.log")
        with open(logs[name], "w") as fp:
            procs[name] = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=fp,
                                           stderr=subprocess.STDOUT)

    def finish(name):
        try:
            procs[name].wait(timeout=TOOL_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"{name}: no exit within {TOOL_TIMEOUT_S} s")
        with open(logs[name]) as fp:
            text = fp.read()
        if procs[name].returncode:
            raise RuntimeError(f"{name} exited {procs[name].returncode}: {text[-3000:]}")
        return text

    try:
        sr = 8000
        utterance = load_file(repo, "tools/stream_capacity_torch.py")._formant_utterance
        wav, wav_eval, ply, cnst_txt = (os.path.join(tmp, name) for name in (
            "example.wav", "example_eval.wav", "template.ply", "constraints.txt"))
        audio_io.save(wav, utterance(sr, EXAMPLE_CLIP_S), sr)
        audio_io.save(wav_eval, utterance(sr, EXAMPLE_EVAL_S), sr)
        verts, faces, cnst = synthetic_template(SEED)
        write_ply(ply, verts, faces)
        with open(cnst_txt, "w") as fp:
            fp.write(" ".join(str(int(i)) for i in cnst))
        objs = os.path.join(tmp, "example_objs")
        eval_cwd, png = os.path.join(tmp, "example_eval"), os.path.join(tmp, "template.png")
        os.makedirs(eval_cwd)
        # every subprocess starts now, so that their start-ups overlap; the paced client
        # comes last, alone beside the service
        t0 = time.perf_counter()
        start("serve", [sys.executable, "-m", "sdfa_tpu_torch", "serve", "--load_from", ckpt,
                        "--port", "0", "--capacity", "8", "--template_mesh", ply,
                        "--mesh_constraints", cnst_txt])
        start("serve_vertices", [sys.executable, os.path.join(repo, "examples",
                                                               "torch_serve_vertices.py"),
                                 ckpt, wav, objs])
        start("evaluate", ["bash", os.path.join(repo, "evaluate_torch.sh"), wav_eval, "m0", ckpt,
                           root, ply, cnst_txt], cwd=eval_cwd)
        start("render", [sys.executable, os.path.join(repo, "examples",
                                                       "torch_render_template.py"), "--out", png])

        # the offline request in process, and the planes of its middle frame
        frame.set_template_mesh(verts, faces, cnst)
        task = api.load_task(ckpt, device=dev)
        sig, _ = audio_io.load(wav, sr=sr)
        sig = rms.normalize(sig, task.hp.dataset_anime.get("audio_target_db", -24.5))
        task.warmup(1.0)
        reset_counts(counters)
        ts, v = task.generate_vertices(sig, 0)
        path = read_counts(counters, "examples offline request")
        mid = len(ts) // 2
        with torch.inference_mode():
            frame_idx, _, z, _ = task._overlap_prefix(sig)
            preds, _, _ = task.model.forward_windows(
                z, torch.from_numpy(frame_idx[mid:mid + 1]).long().to(dev),
                torch.zeros(1, dtype=torch.long, device=dev), raw_pca=True)
            planes = task.model.decode_to_anime(preds)[:, 0].cpu().numpy()
        if not native.set_target(verts, faces, cnst):
            raise RuntimeError("native.set_target failed on the synthetic template")
        oracle = native.get_meshes(planes, len(verts)).reshape(len(verts), 3)

        finish("serve_vertices")
        out["wall_s"]["serve_vertices"] = time.perf_counter() - t0
        files = sorted(f for f in os.listdir(objs) if f.endswith(".obj"))
        got = obj_vertices(os.path.join(objs, f"{mid:06d}.obj")) if files else None
        out["serve_vertices"] = {
            "audio_s": EXAMPLE_CLIP_S, "objs": len(files), "offline_frames": len(ts),
            "launches_offline": path, "frame": mid,
            "max_abs_m_vs_float64": float(np.abs(got - oracle).max()) if files else None,
            "max_abs_m_vs_offline": float(np.abs(got - v[mid]).max()) if files else None,
            "tol_m": ORACLE_TOL_M}
        if v.shape != (len(ts), FLAME_COUNTS[0], 3) or len(files) != len(ts) or \
                not out["serve_vertices"]["max_abs_m_vs_float64"] <= ORACLE_TOL_M:
            raise RuntimeError(f"examples serve_vertices: {out['serve_vertices']}")

        # evaluate_torch.sh and the renderer
        for name in ("render", "evaluate"):
            finish(name)
            out["wall_s"][name] = time.perf_counter() - t0
        written = [os.path.join(base, f) for base, _, names in os.walk(eval_cwd) for f in names]
        out["evaluate"] = {"audio_s": EXAMPLE_EVAL_S, "files": len(written),
                           "kinds": sorted({f.rsplit(".", 1)[-1] for f in written}),
                           "empty": sum(os.path.getsize(f) == 0 for f in written)}
        out["render"] = {"png_bytes": os.path.getsize(png) if os.path.exists(png) else 0}
        if not written or out["evaluate"]["empty"] or "obj" not in out["evaluate"]["kinds"] or \
                not out["render"]["png_bytes"]:
            raise RuntimeError(f"examples evaluate / render: {out['evaluate']} {out['render']}")

        # the paced client against the service, its port read from the service's log
        deadline = time.time() + TOOL_TIMEOUT_S
        while True:
            with open(logs["serve"]) as fp:
                bound_port = re.search(r"streaming server on 127\.0\.0\.1:(\d+)", fp.read())
            if bound_port:
                break
            if procs["serve"].poll() is not None:
                finish("serve")
                raise RuntimeError("serve exited before it logged its port")
            if time.time() > deadline:
                raise RuntimeError("serve never logged its port")
            time.sleep(0.25)
        out["wall_s"]["serve_port_open_seen"] = time.perf_counter() - t0
        # no out_dir: writing an OBJ a frame in the client's reader thread (400 KB of
        # text each) holds the pushes back, and the wall would time the client's disk
        start("stream_client", [sys.executable, os.path.join(repo, "examples",
                                                              "torch_stream_client.py"),
                                wav, "127.0.0.1", bound_port.group(1)])
        text = finish("stream_client")
        said = re.search(r"(\d+) frames for a ([\d.]+)s clip in ([\d.]+)s .*; (\d+) frames "
                         r"arrived while still pushing", text)
        alive = procs["serve"].poll() is None
        procs["serve"].terminate()
        procs["serve"].wait(timeout=60)
        out["stream_client"] = {
            "said": said.group(0) if said else text[-500:],
            "frames": int(said.group(1)) if said else None,
            "clip_s": float(said.group(2)) if said else None,
            "wall_s": float(said.group(3)) if said else None,
            "during_push": int(said.group(4)) if said else None,
            "offline_frames": len(ts), "service_alive_until_terminated": alive}
        if not (said and alive and out["stream_client"]["frames"] == len(ts)
                and out["stream_client"]["during_push"] > 0):
            raise RuntimeError(f"examples stream_client: {out['stream_client']}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        frame._state.clear()
        frame._state.update(saved_frame)
        out["wall_s"]["phase"] = time.perf_counter() - t_phase
        emit(out)  # what was measured, also when a check failed
    return path


def launched(mod) -> int:
    """A wrapper's launches since ``reset_counts``: K1, K2 and K4 keep theirs
    by hidden width, K3 by body (all of them here)."""
    n = mod.LAUNCHES
    return n.total() if isinstance(n, collections.Counter) else n


def reset_counts(counters):
    for mod in counters.values():
        if isinstance(mod.LAUNCHES, collections.Counter):
            mod.LAUNCHES.clear()
        else:
            mod.LAUNCHES = 0


def read_counts(counters, path, zero=(), k3_full=False):
    """The launch counts since ``reset_counts``; raises if a kernel of ``path``
    never launched (or one named in ``zero`` did). K3 counts by body:
    ``decode_solve`` is its delta body. Its full body launches only on a path
    over a table with triangle correspondences (``k3_full``: counted as
    ``decode_solve_full``, and the delta body must stay put); elsewhere it
    must not launch."""
    counts = {name: launched(mod) for name, mod in counters.items()}
    if "decode_solve" in counters:
        k3 = counters["decode_solve"].LAUNCHES
        counts["decode_solve"] = k3["delta"]
        if k3_full:
            counts["decode_solve_full"] = k3["full"]
            zero = (*zero, "decode_solve")
        elif k3["full"]:
            raise RuntimeError(f"{path}: decode_solve's full body launched {k3['full']} times")
    for name, n in counts.items():
        if (n != 0) if name in zero else (n < 1):
            raise RuntimeError(f"{path}: {name} launched {n} times")
    return counts


def max_err(a, b) -> float:
    import numpy as np

    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def wires_phase(task, counters, sig, spk, v_f32, sample, oracle, smi):
    """One request per wire against the f32 wire's vertices (coef: against
    the float64 solve on the sampled frames), an ensembled request against the
    mean of its two runs, and a request with every kept constant dropped
    against the warm one."""
    import numpy as np
    import torch

    from sdfa_tpu_torch.audio import pipeline
    from sdfa_tpu_torch.viewer import frame

    n_w, v3 = len(v_f32), v_f32[0].size
    payload = {"f32": n_w * v3 * 4, "i16": n_w * v3 * 2, "i8d": n_w * v3 + v3 * 2,
               "coef": n_w * (85 + 180) * 4}
    lines, launches = {}, {}
    for wire in ("f32", "i16", "i8d", "coef"):
        task.generate_vertices(sig, spk, wire=wire)  # the wire's own first call
        walls = []
        for _ in range(3):
            reset_counts(counters)
            t0 = time.perf_counter()
            ts, verts = task.generate_vertices(sig, spk, wire=wire)
            walls.append(1e3 * (time.perf_counter() - t0))
        launches[wire] = read_counts(counters, f"wire {wire}",
                                     zero=("decode_solve",) if wire == "coef" else ())
        if verts.shape != v_f32.shape or verts.dtype != np.float32 or not np.isfinite(verts).all():
            raise RuntimeError(f"wire {wire}: bad output {verts.shape} {verts.dtype}")
        err = max_err(verts, v_f32)
        line = {"max_abs_m_vs_f32": err, "bytes_downloaded": payload[wire],
                "wall_ms": sorted(walls), "launches": launches[wire]}
        if wire == "coef":
            line["max_abs_m_vs_f64_solve"] = max_err(verts[sample], oracle)
            line["tol_m_vs_f64_solve"] = COEF_ORACLE_TOL_M
            if not line["max_abs_m_vs_f64_solve"] <= COEF_ORACLE_TOL_M:
                raise RuntimeError(f"coef wire vs the float64 solve: {line}")
        else:
            line["tol_m"] = WIRE_TOL_M[wire]
            if not err <= WIRE_TOL_M[wire]:
                raise RuntimeError(f"wire {wire} vs the f32 wire: {err} m > {WIRE_TOL_M[wire]}")
        lines[wire] = line

    # ensembling: the answer is the mean of the clip's run and of a run delayed by 100 ms
    t0 = time.perf_counter()
    _, v_ens = task.generate_vertices(sig, spk, ensembling_ms=100.0)
    ens_ms = 1e3 * (time.perf_counter() - t0)
    _, a0, _ = task.generate_animation(sig, spk)
    _, a1, _ = task.generate_animation(task._shifted(sig, 100.0), spk)
    v_mean, _ = frame.frames_to_meshes((a0 + a1) / 2.0, "dgrad_3d", task.device)
    ens_err = max_err(v_ens, v_mean)
    if not ens_err <= 1e-6 or not max_err(v_ens, v_f32) > 1e-7:
        raise RuntimeError(f"ensembled request: {ens_err} m from the mean of its two runs")

    # every kept constant dropped (frontend constants, stacked LSTM weights): the same bits
    _, warm = task.generate_vertices(sig, spk)
    pipeline.clear_const_cache()
    for module in task.model.modules():
        if hasattr(module, "_stacked"):
            module._stacked.clear()
    _, cold = task.generate_vertices(sig, spk)
    if not (np.array_equal(warm, cold) and np.array_equal(warm, v_f32)):
        raise RuntimeError("a request with its kept constants dropped differs from the warm one: "
                           f"{max_err(warm, cold)} m")
    emit({"phase": "wires", "audio_s": len(sig) / task.wspec.sr, "windows": n_w, "wires": lines,
          "ensembled_vs_mean_of_two_runs_m": ens_err, "ensembled_wall_ms": ens_ms,
          "kept_constants_dropped_vs_warm": "bit-equal", "card": smi})
    torch.cuda.empty_cache()
    return launches["i16"]


def session_phase(task, counters, sig, spk, ts_ref, v_ref, smi, phase="session", zero=(),
                  k3_full=False):
    """One ``StreamingSession`` fed the clip in uneven chunks, then flushed;
    the counters named in ``zero`` must not move (``k3_full``: as ``read_counts``)."""
    import numpy as np

    def run():
        sess = task.stream(spk, emit_batch=16, block_frames=16)
        rng, got, i = np.random.default_rng(0), [], 0
        while i < len(sig):
            n = int(rng.integers(400, 3000))
            got.extend(sess.push(sig[i:i + n]))
            i += n
        live = len(got)
        got.extend(sess.flush())
        return got, live

    run()  # warm-up: the block constants, the allocator
    reset_counts(counters)
    t0 = time.perf_counter()
    got, live = run()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = read_counts(counters, phase, zero=zero, k3_full=k3_full)
    err = max_err(np.stack([v for _, v in got]), v_ref)
    emit({"phase": phase, "frames": len(got), "frames_before_flush": live,
          "timeline_equal": [t for t, _ in got] == list(ts_ref), "max_abs_m_vs_offline": err,
          "tol_m": STREAM_TOL_M, "wall_ms": wall_ms, "wall_ms_per_frame": wall_ms / len(got),
          "launches": launches, "card": smi})
    if [t for t, _ in got] != list(ts_ref) or not err <= STREAM_TOL_M:
        raise RuntimeError(f"{phase} vs offline: timeline or vertices differ ({err} m)")
    return launches


def drive_server(srv, clips, speakers, per_tick: int):
    """Open one stream per clip, push ``per_tick`` samples to each stream per
    tick until the clips end, flush and drain. → (frames by clip, wall ms of
    every tick, frames each tick delivered)."""
    sids = [srv.open(spk) for spk in speakers]
    got = {sid: [] for sid in sids}
    tick_ms, tick_frames = [], []

    def tick():
        t0 = time.perf_counter()
        out = srv.tick()
        tick_ms.append(1e3 * (time.perf_counter() - t0))
        tick_frames.append(sum(len(f) for f in out.values()))
        for sid, frames in out.items():
            got[sid].extend(frames)

    pos = 0
    while pos < max(len(c) for c in clips):
        for sid, clip in zip(sids, clips):
            if pos < len(clip):
                srv.push(sid, clip[pos:pos + per_tick])
        pos += per_tick
        tick()
    for sid in sids:
        srv.flush(sid)
    while not all(srv.is_done(sid) for sid in sids):
        tick()
    for sid in sids:
        srv.close(sid)
    return [got[sid] for sid in sids], tick_ms, tick_frames


def server_phase(task, counters, sr, smi):
    """``StreamingServer`` at capacity 8: 8 streams of different lengths and
    speakers per wire, each against its own offline request; two blocks of
    audio per stream and tick, so that a full tick is two block rounds of 128
    FreqLstm rows and one suffix call of up to 128 windows. Then capacity 32
    on i16 for its tick time."""
    import numpy as np

    from sdfa_tpu_torch.streaming import CoefDecoder, StreamingServer

    n, emit_batch, block = 8, 16, 16
    per_tick = 2 * block * task.wspec.hop_size
    clips = [signal(2.0 + 0.125 * k, sr, 40 + k) for k in range(n)]
    speakers = list(range(n))
    offline = [task.generate_vertices(c, k) for k, c in enumerate(clips)]
    decoder = CoefDecoder(task)
    v3 = offline[0][1][0].size
    frame_bytes = {"i16": v3 * 2, "i8d": v3, "coef": (85 + 180) * 4}
    tol = {"i16": WIRE_TOL_M["i16"] + STREAM_TOL_M, "i8d": WIRE_TOL_M["i8d"] + STREAM_TOL_M,
           "coef": STREAM_TOL_M}
    lines, launches = [], None
    for wire, pipelined in (("i16", False), ("i8d", False), ("coef", False), ("i16", True)):
        srv = StreamingServer(task, capacity=n, emit_batch=emit_batch, block_frames=block,
                              wire=wire, pipeline=pipelined)
        drive_server(srv, clips[:2], speakers[:2], per_tick)  # warm-up on the same server
        reset_counts(counters)
        got, tick_ms, tick_frames = drive_server(srv, clips, speakers, per_tick)
        counts = read_counts(counters, f"server {wire}",
                             zero=("decode_solve",) if wire == "coef" else ())
        launches = launches or counts
        # a delta stream starts from the template and catches up at 127 steps a frame: its
        # first frames may be further off and are reported apart
        skip = 8 if wire == "i8d" else 0
        errs, head_errs = [], []
        for k, frames in enumerate(got):
            ts_ref, v_ref = offline[k]
            if [t for t, _ in frames] != list(ts_ref):
                raise RuntimeError(f"server {wire}: stream {k}'s timeline differs from offline")
            verts = np.stack([v for _, v in frames])
            verts = decoder.decode(verts) if wire == "coef" else verts
            errs.append(max_err(verts[skip:], v_ref[skip:]))
            head_errs.append(max_err(verts[:8], v_ref[:8]))
        full = sorted(ms for ms, fr in zip(tick_ms, tick_frames) if fr >= n * (emit_batch - 2))
        n_frames = sum(tick_frames)
        fps = n_frames / (sum(tick_ms) / 1e3)
        lines.append({"wire": wire, "pipeline": pipelined, "streams": n,
                      "max_abs_m_vs_offline": max(errs), "tol_m": tol[wire],
                      "first_frames_left_out": skip, "max_abs_m_first_8_frames": max(head_errs),
                      "ticks": len(tick_ms), "full_ticks": len(full),
                      "full_tick_wall_ms_median": full[len(full) // 2] if full else None,
                      "full_tick_wall_ms_min_max": [full[0], full[-1]] if full else None,
                      "frames": n_frames, "frames_per_s": fps,
                      "times_real_time": fps / (60.0 * n), "bytes_per_frame": frame_bytes[wire],
                      "launches": counts})
        if not max(errs) <= tol[wire]:
            raise RuntimeError(f"server {wire}: {max(errs)} m from offline > {tol[wire]}")

    n32 = 32
    clips32 = [signal(2.0, sr, 80 + k) for k in range(n32)]
    srv = StreamingServer(task, capacity=n32, emit_batch=emit_batch, block_frames=block, wire="i16")
    drive_server(srv, clips32[:2], [0, 1], per_tick)
    got, tick_ms, tick_frames = drive_server(srv, clips32, [k % 8 for k in range(n32)], per_tick)
    if any(len(f) != len(got[0]) or not np.isfinite(np.stack([v for _, v in f])).all()
           for f in got):
        raise RuntimeError("server at capacity 32: a stream's frames are missing or not finite")
    full = sorted(ms for ms, fr in zip(tick_ms, tick_frames) if fr >= n32 * (emit_batch - 2))
    fps32 = sum(tick_frames) / (sum(tick_ms) / 1e3)
    emit({"phase": "server", "capacity": n, "emit_batch": emit_batch, "block_frames": block,
          "audio_s": [len(c) / sr for c in clips], "samples_per_stream_and_tick": per_tick,
          "runs": lines,
          "capacity_32_i16": {"full_ticks": len(full),
                              "full_tick_wall_ms_median": full[len(full) // 2] if full else None,
                              "frames_per_s": fps32, "times_real_time": fps32 / (60.0 * n32)},
          "card": smi})
    return launches


def tcp_phase(task, counters, sr, smi):
    """``ServeApp`` + ``StreamServerTCP`` on loopback: three clients on an i16
    service and one on a coef service with a ``CoefDecoder``, all at once."""
    import numpy as np

    from sdfa_tpu_torch.serve import ServeApp, StreamClient, StreamServerTCP
    from sdfa_tpu_torch.streaming import CoefDecoder

    clips = [signal(1.5 + 0.25 * k, sr, 60 + k) for k in range(4)]
    offline = [task.generate_vertices(c, k) for k, c in enumerate(clips)]
    decoder = CoefDecoder(task)
    services = []
    for wire in ("i16", "coef"):
        app = ServeApp(task, capacity=4, emit_batch=16, block_frames=16, wire=wire, pipeline=True)
        tcp = StreamServerTCP(("127.0.0.1", 0), app)
        thread = threading.Thread(target=tcp.serve_forever, daemon=True)
        thread.start()
        services.append((app, tcp, thread))
    results, errors = {}, []

    def client(k):
        try:
            on_coef = k == 3
            with StreamClient(services[on_coef][1].server_address) as c:
                c.sock.settimeout(SOCKET_TIMEOUT_S)
                sid = c.open(speaker=k)
                for lo in range(0, len(clips[k]), 2000):
                    c.push(sid, clips[k][lo:lo + 2000])
                c.flush(sid)
                # frames() returns when the stream's done marker arrives
                results[k] = (c.wire, list(c.frames(sid, decoder=decoder if on_coef else None)))
        except Exception as exc:  # reported below, on the main thread
            errors.append((k, repr(exc)))

    reset_counts(counters)
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SOCKET_TIMEOUT_S + 30)
        wall_s = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads) or len(results) != 4:
            raise RuntimeError(f"tcp clients failed: {errors}, {sorted(results)} finished")
        deadline = time.time() + 10
        while any(app.srv.live() for app, _, _ in services) and time.time() < deadline:
            time.sleep(0.02)
        free = [app.srv.live() == [] for app, _, _ in services]
    finally:
        for app, tcp, thread in services:
            tcp.shutdown()
            tcp.server_close()
            app.shutdown()
            thread.join(timeout=10)
    launches = read_counts(counters, "tcp")
    errs, wires = [], []
    for k in range(4):
        wire, frames = results[k]
        ts_ref, v_ref = offline[k]
        if [t for t, _ in frames] != list(ts_ref):
            raise RuntimeError(f"tcp client {k}: timeline differs from offline")
        errs.append(max_err(np.stack([v for _, v in frames]), v_ref))
        wires.append(wire)
    tols = [STREAM_TOL_M + (WIRE_TOL_M["i16"] if w == "i16" else 0.0) for w in wires]
    emit({"phase": "tcp", "clients": 4, "wires": wires, "max_abs_m_vs_offline": errs,
          "tol_m": tols, "done_markers": 4, "slots_free_afterwards": free,
          "frames": [len(results[k][1]) for k in range(4)], "wall_s": wall_s,
          "launches": launches, "card": smi})
    if wires != ["i16"] * 3 + ["coef"] or not all(free) or \
            not all(e <= t for e, t in zip(errs, tols)):
        raise RuntimeError(f"tcp: wires {wires}, errors {errs} m, slots free {free}")
    return launches


def profile_server_tick(task, sr, smi, phase="profile_server_tick"):
    """Full ticks of an i16 server at capacity 8 under ``torch.profiler``:
    device time by kernel per tick (two block rounds, one suffix call of up to
    128 windows, one download)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdfa_tpu_torch.streaming import StreamingServer

    n, per_tick, ticks = 8, 2 * 16 * task.wspec.hop_size, 6
    clips = [signal((4 + 2 * ticks + 1) * per_tick / sr, sr, 90 + k) for k in range(n)]
    srv = StreamingServer(task, capacity=n, emit_batch=16, block_frames=16, wire="i16")
    sids = [srv.open(k) for k in range(n)]
    pos, frames = 0, 0
    host_ms = {"block_rounds": 0.0, "dispatch_suffix": 0.0, "collect": 0.0}

    def rounds(count):
        """``count`` ticks, the host's clock split by half of a tick: the block
        rounds and the suffix call only enqueue; collect waits for the card,
        copies the payload out of the pinned buffer and dequantizes it."""
        nonlocal pos, frames
        for _ in range(count):
            for sid, clip in zip(sids, clips):
                srv.push(sid, clip[pos:pos + per_tick])
            pos += per_tick
            t0 = time.perf_counter()
            srv._advance_blocks()
            t1 = time.perf_counter()
            pending = srv._dispatch()
            t2 = time.perf_counter()
            frames += sum(len(f) for f in srv.tick_collect(pending).values())
            t3 = time.perf_counter()
            for key, ms in zip(host_ms, (t1 - t0, t2 - t1, t3 - t2)):
                host_ms[key] += 1e3 * ms

    rounds(4)  # past the first blocks and the lookahead: every later tick is full
    frames, host_ms = 0, dict.fromkeys(host_ms, 0.0)
    rounds(ticks)
    unprofiled = {key: ms / ticks for key, ms in host_ms.items()}
    unprofiled_ms = sum(unprofiled.values())
    torch.cuda.synchronize()
    frames = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rounds(ticks)
        torch.cuda.synchronize()
    device, busy_ms = device_kernels(prof)
    emit({"phase": phase, "capacity": n, "wire": "i16", "ticks": ticks,
          "frames_per_tick": frames / ticks, "tick_wall_ms_unprofiled": unprofiled_ms,
          "tick_host_ms_unprofiled_by_half": unprofiled,
          "device_busy_ms_per_tick": busy_ms / ticks,
          "device_busy_share": busy_ms / ticks / unprofiled_ms,
          "top_device_ms_per_tick": [{"name": k[:80], "ms": ms / ticks, "calls_per_tick": c / ticks}
                                     for k, ms, c in device[:16]], "card": smi})


# the record_function spans of Experiment.train_step: ranges, not kernels, in a profile
TRAIN_SPANS = ("train/upload", "train/forward_loss", "train/backward", "train/clip_adam")


def device_kernels(prof, spans=()):
    """(name, device ms, launches) of every kernel and copy in a profile, largest
    first, and their sum; ``spans`` names record_function ranges to leave out."""
    from torch.autograd import DeviceType

    device = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.key not in spans]
    device.sort(key=lambda item: -item[1])
    return device, sum(ms for _, ms, _ in device)


def profile_serving(task, requests, wall_ms_unprofiled, smi, phase="profile_serve"):
    """The serve phase's requests once more under ``torch.profiler``: device
    time by kernel per request and the busy share of an unprofiled request."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for sig, spk in requests:
            task.generate_vertices(sig, spk)
        torch.cuda.synchronize()
    device, busy_ms = device_kernels(prof)
    n = len(requests)
    # a warm request uploads its signal and its window indices, and nothing else
    h2d = sum(c for k, _, c in device if "memcpy" in k.lower() and "htod" in k.lower()) / n
    if h2d > 2:
        raise RuntimeError(f"a warm request makes {h2d} host-to-device copies; the signal's and "
                           "the window indices' are the two it may make")
    emit({"phase": phase, "requests": n, "device_busy_ms_per_request": busy_ms / n,
          "h2d_copies_per_request": h2d,
          "wall_ms_unprofiled_median": wall_ms_unprofiled,
          "device_busy_share": busy_ms / n / wall_ms_unprofiled,
          "top_device_ms_per_request": [{"name": k[:80], "ms": ms / n, "calls_per_request": c / n}
                                        for k, ms, c in device[:14]], "card": smi})


def profile_step_clocks(build, dev, smi):
    """Where a step of the biLSTM step kernel spends its time: builds
    ``csrc/bilstm_layer.cu`` once more with ``-DSDFA_STEP_CLOCKS`` (thread 0 of
    the first block adds up SM clocks by part of a turn), runs one layer at
    224 and 256 rows x 64 steps, and prints clocks per step beside the least
    a step's 32 x 256 x 128 multiply-adds need on one SM (128 a clock)."""
    import ctypes

    import torch

    lib_path = os.path.join(build.BUILD_ROOT, "libbilstm_layer_step_clocks.so")
    src = os.path.join(build.CSRC, "bilstm_layer.cu")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-DSDFA_STEP_CLOCKS", "-o", lib_path,
                    src], capture_output=True, text=True, check=True, timeout=600)
    lib = ctypes.CDLL(lib_path)
    lib.sdfa_bilstm_layer.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.sdfa_bilstm_layer_step_clocks.argtypes = [ctypes.c_void_p]
    steps, n_in = 64, 256
    for rows in (224, 256):
        gen = torch.Generator().manual_seed(rows)
        x = (0.5 * torch.randn(rows, steps, n_in, generator=gen)).to(dev)
        w_ih = (torch.randn(2, n_in, 1024, generator=gen) / 16).to(dev)
        w_hh = (torch.randn(2, 256, 1024, generator=gen) / 16).to(dev)
        wt = torch.empty(2, 2048, n_in, device=dev)  # w_ih staged for the input projection
        xp = torch.empty(2, rows, steps, 1024, device=dev)
        out = torch.empty(rows, steps, 512, device=dev)

        def call():
            code = lib.sdfa_bilstm_layer(x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), None,
                                         wt.data_ptr(), None, xp.data_ptr(), out.data_ptr(), rows,
                                         steps, n_in, 256, rows,
                                         torch.cuda.current_stream(dev).cuda_stream)
            if code != 0:
                raise RuntimeError(f"bilstm_layer (step clocks build): CUDA error {code}")

        ms = time_ms(call, 5)
        clocks = (ctypes.c_longlong * 4)()
        if lib.sdfa_bilstm_layer_step_clocks(clocks) != 0:
            raise RuntimeError("could not read the step clocks")
        per_step = [c / steps for c in clocks]
        emit({"phase": "profile_step_clocks", "rows": rows, "steps": steps, "layer_ms": ms,
              "sm_clocks_per_step": dict(zip(("product", "warp_exchanges", "cell_and_send_h",
                                              "barrier_and_output"), per_step)),
              "sm_clocks_per_step_total": sum(per_step),
              "fma_floor_clocks_per_step": 32 * 256 * 128 / 128, "card": smi})


def profile_core_tiles(build, dev, smi):
    """The training core's tile choices side by side: builds ``csrc/bilstm_core.cu``
    as it is and with each compile-time choice changed (``-DSDFA_CORE_RG256=2``:
    32-row tiles at H = 256; ``-DSDFA_CORE_RG128=1``: 16-row tiles at H = 128;
    ``-DSDFA_CORE_MINB128=1``: one block to a multiprocessor at H = 128), and
    times both passes of each build at the train step's two shapes, twice."""
    import torch

    variants = {"as_built": [], "h256_32_row_tiles": ["-DSDFA_CORE_RG256=2"],
                "h128_16_row_tiles": ["-DSDFA_CORE_RG128=1"],
                "h128_one_block_per_sm": ["-DSDFA_CORE_MINB128=1"]}
    libs = build_variants(build, "bilstm_core", variants)
    times = {tag: {} for tag in variants}
    for steps, rows, hid in ((32, 6400, 128), (64, 100, 256)):
        gen = torch.Generator().manual_seed(hid)
        xp = (0.5 * torch.randn(2, steps, rows, 4 * hid, generator=gen)).to(dev)
        w_hh = (torch.randn(2, hid, 4 * hid, generator=gen) * hid ** -0.5).to(dev)
        dout = torch.randn(steps, rows, 2 * hid, generator=gen).to(dev)
        out, gates, dg = torch.empty_like(dout), torch.empty_like(xp), torch.empty_like(xp)
        cs = torch.empty(2, steps, rows, hid, device=dev)
        for turn in range(2):
            for tag, lib in libs.items():
                def call(entry, *tensors):
                    call_entry(lib, entry, tensors, (steps, rows, hid), dev)

                fwd = time_ms(lambda: call("sdfa_bilstm_core_fwd", xp, w_hh, out, gates, cs), 5)
                bwd = time_ms(lambda: call("sdfa_bilstm_core_bwd", gates, cs, w_hh, dout, dg), 5)
                times[tag].setdefault(f"{steps}x{rows}x{hid}", []).append(
                    {"fwd_ms": fwd, "bwd_ms": bwd})
    emit({"phase": "profile_core_tiles", "ms": times, "card": smi})


def build_variants(build, name, variants):
    """``csrc/<name>.cu`` built once per entry of ``variants`` (tag -> extra nvcc
    flags), side by side; -> {tag: the loaded library}. A library's file is
    named by a hash of its flags and the sources, and built once: a process
    keeps a library it loaded mapped, and loading its path again returns that
    library, whatever was built there since."""
    import concurrent.futures
    import ctypes
    import glob
    import hashlib

    src = os.path.join(build.CSRC, name + ".cu")
    source = b""
    for path in [src] + sorted(glob.glob(os.path.join(build.CSRC, "*.cuh"))):
        with open(path, "rb") as fp:
            source += fp.read()

    def compile_one(tag):
        digest = hashlib.sha256(" ".join(variants[tag]).encode() + source).hexdigest()[:12]
        path = os.path.join(build.BUILD_ROOT, f"lib{name}_{tag}_{digest}.so")
        if os.path.exists(path):
            return ctypes.CDLL(path)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, *variants[tag], "-o", path, src],
                       capture_output=True, text=True, check=True, timeout=600)
        return ctypes.CDLL(path)

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        return dict(zip(variants, pool.map(compile_one, variants)))


def call_entry(lib, entry, tensors, ints, dev):
    """``entry(pointers..., ints..., stream)`` of a library built by
    ``build_variants``, on ``dev``'s current stream; raises on a CUDA error."""
    import ctypes

    import torch

    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    code = fn(*(None if t is None else t.data_ptr() for t in tensors), *ints,
              torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{entry}: CUDA error {code}")


def profile_full_sums(build, dev, smi, pca_bases, template):
    """Whether K3's full body needs its tensor-core sums promoted into float32
    registers: ``csrc/decode_solve.cu`` as built (never promoted) and with the
    sums promoted every 16, 8 and 4 k tiles (``-DSDFA_FULL_PROMOTE``), each at
    the ring as built and at 4 stages and one block a multiprocessor
    (``-DSDFA_FULL_STAGES=4 -DSDFA_FULL_MINB=1``, where the promoted sums need
    no spill), at a request's 216 windows on the retarget phase's fan-out
    table, K split by the wrapper's rule from each build's own occupancy and
    in one part; each build timed twice in turns, with its ptxas line and its
    max |diff| from the float64 decode, gather and product."""
    import ctypes

    import torch

    from sdfa_tpu_torch.ops import decode_solve
    from sdfa_tpu_torch.ops.deform_solver import DeformationSolver

    verts, faces, cnst = template
    count, corr, _ = fanout_table(len(faces))
    solver = DeformationSolver(verts, faces, cnst, corr_count=count, corr_faces=corr)
    fsc = decode_solve.prep_full_consts(*pca_bases, solver, dev)
    tp, nf, n_pad = fsc.t0.shape[1], fsc.x0.shape[1], fsc.b_t.shape[1]
    windows = K3_REQUEST_WINDOWS
    gen = torch.Generator().manual_seed(300 + windows)
    coef_s = torch.randn(windows, 85, generator=gen).to(dev)
    coef_r = torch.randn(windows, 180, generator=gen).to(dev)
    with torch.inference_mode():
        f64 = fsc._replace(**{k: getattr(fsc, k).double() for k in (
            "basis_s", "means_s", "basis_r", "means_r", "p")})
        exact = decode_solve.decode_solve_full_plain(coef_s.double(), coef_r.double(), f64)
        del f64
    one_block = ["-DSDFA_FULL_STAGES=4", "-DSDFA_FULL_MINB=1"]
    variants = {"as_built": [], "4_stages_1_block": one_block}
    for every in (16, 8, 4):
        variants[f"promote_{every}"] = [f"-DSDFA_FULL_PROMOTE={every}"]
        variants[f"promote_{every}_4_stages_1_block"] = [f"-DSDFA_FULL_PROMOTE={every}",
                                                         *one_block]
    libs = build_variants(build, "decode_solve", variants)
    empty = dict(device=dev, dtype=torch.float32)
    dt, out = torch.empty(windows, 9, tp, **empty), torch.empty(windows, 3, nf, **empty)
    lines = {}
    for turn in range(2):
        for tag, lib in libs.items():
            found = (ctypes.c_int * 5)()
            if lib.sdfa_decode_solve_tiling(found) != 0:
                raise RuntimeError(f"{tag}: sdfa_decode_solve_tiling failed")
            split = decode_solve.k_parts(3 * windows, n_pad, 3 * tp, found[4])
            for parts in sorted({split, 1}):
                part = torch.empty(parts, 3 * windows, n_pad, **empty)

                def call():
                    call_entry(lib, "sdfa_decode_solve_full",
                               (coef_s, coef_r, fsc.basis_s, fsc.means_s, fsc.basis_r,
                                fsc.means_r, fsc.b_t, fsc.t0, fsc.x0, dt, part, out),
                               (windows, 85, 180, tp, nf, n_pad, parts), dev)

                ms = time_ms(call, 5)
                line = lines.setdefault(f"{tag}_{parts}_parts", {
                    "resident_blocks": found[4], "wrapper_split": parts == split, "ms": []})
                line["ms"].append(ms)
                line["max_abs_m_vs_f64"] = float((out.double() - exact).abs().max())
    emit({"phase": "profile_full_sums", "windows": windows, "n_eqs": solver.n_eqs,
          "builds": lines, "card": smi})


def profile_serving_tiles(build, dev, smi, k1_weights, dsc):
    """The compile-time choices of the two serving kernels redesigned last, side
    by side, each build timed twice in turns. ``csrc/freq_lstm.cu`` as it is and
    with 16-row tiles (``-DSDFA_FREQ_RG=1``) at 768 and 3072 rows;
    ``csrc/decode_solve.cu`` as it is (a ring of 3 stages, two blocks to a
    multiprocessor; the decode 4 windows a block) and with 4 stages and one
    block, 2 stages and two blocks (``-DSDFA_SOLVE_STAGES``,
    ``-DSDFA_SOLVE_MINB``), and the decode 8 and 16 windows a block
    (``-DSDFA_DECODE_WR``), at 256 and 216 windows, K split by the same rule
    from each build's own occupancy."""
    import ctypes

    import torch

    from sdfa_tpu_torch.ops import decode_solve

    def tiling(lib, entry, count):
        out = (ctypes.c_int * count)()
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        if fn(out) != 0:
            raise RuntimeError(f"{entry} failed")
        return list(out)

    empty = dict(device=dev, dtype=torch.float32)
    times = {"freq_lstm": {}, "decode_solve": {}}
    libs = build_variants(build, "freq_lstm", {"as_built": [],
                                               "16_row_tiles": ["-DSDFA_FREQ_RG=1"]})
    for rows in (K1_REQUEST_ROWS, K1_ROWS):
        x = torch.randn(rows, 32, 64, generator=torch.Generator().manual_seed(rows)).to(dev)
        out = torch.empty(rows, 256, **empty)
        for turn in range(2):
            for tag, lib in libs.items():
                found = tiling(lib, "sdfa_freq_lstm_tiling", 5)
                clusters, row_tile = found[0], found[3]  # at H = 128
                wave = clusters // 2 * row_tile
                chunk = max(wave, 1024 - 1024 % wave)  # whole waves, about 1024 rows
                n = min(rows, chunk)
                # w_ih staged for the input projection (C = 64: one k tile of 32 pads nothing),
                # no padded x, then xp, h and the partial sums
                scratch = (torch.empty(2, 1024, 64, **empty), None,
                           torch.empty(2, n, 32, 512, **empty), torch.empty(n, 32, 256, **empty),
                           torch.empty(16, n, 256, **empty))
                ms = time_ms(lambda: call_entry(lib, "sdfa_freq_lstm",
                                                (x, *k1_weights, *scratch, out),
                                                (rows, 32, 64, 128, 256, chunk), dev), 5)
                times["freq_lstm"].setdefault(tag, {"resident_clusters": clusters,
                                                    "rows_per_cluster": row_tile})
                times["freq_lstm"][tag].setdefault(f"{rows}_rows_ms", []).append(ms)
    libs = build_variants(build, "decode_solve", {
        "as_built": [], "4_stages_1_block": ["-DSDFA_SOLVE_STAGES=4", "-DSDFA_SOLVE_MINB=1"],
        "2_stages_2_blocks": ["-DSDFA_SOLVE_STAGES=2"],
        "decode_8_windows_a_block": ["-DSDFA_DECODE_WR=8"],
        "decode_16_windows_a_block": ["-DSDFA_DECODE_WR=16"]})
    tp, nf = dsc.p.shape[1:]
    n_pad = dsc.p_t.shape[0]
    for windows in (K3_WINDOWS, K3_REQUEST_WINDOWS):
        gen = torch.Generator().manual_seed(windows)
        coef_s = torch.randn(windows, 85, generator=gen).to(dev)
        coef_r = torch.randn(windows, 180, generator=gen).to(dev)
        dt, out = torch.empty(windows, 9, tp, **empty), torch.empty(windows, 3, nf, **empty)
        for turn in range(2):
            for tag, lib in libs.items():
                resident = tiling(lib, "sdfa_decode_solve_tiling", 5)[0]
                parts = decode_solve.k_parts(3 * windows, n_pad, 3 * tp, resident)
                part = torch.empty(parts, 3 * windows, n_pad, **empty)
                ms = time_ms(lambda: call_entry(
                    lib, "sdfa_decode_solve",
                    (coef_s, coef_r, dsc.basis_s, dsc.means_s, dsc.basis_r, dsc.means_r, dsc.p_t,
                     dsc.t0, dsc.x0, dt, part, out),
                    (windows, 85, 180, tp, nf, n_pad, parts), dev), 5)
                times["decode_solve"].setdefault(tag, {"resident_blocks": resident})
                times["decode_solve"][tag].setdefault(f"{windows}_windows", {"k_parts": parts,
                                                                              "ms": []})
                times["decode_solve"][tag][f"{windows}_windows"]["ms"].append(ms)
    emit({"phase": "profile_serving_tiles", "ms": times, "card": smi})


def profile_train_step(exp, batches, smi, step_ms_unprofiled):
    """Three more train steps under ``torch.profiler``: device time by stage
    (the ``record_function`` spans of ``Experiment.train_step``) and by
    kernel, and the device's busy time per step as a share of the unprofiled
    step (the profiler slows the host, so the profiled span would understate it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in batches[:3]:
            exp.train_step(batch)
        torch.cuda.synchronize()
    span_ms = 1e3 * (time.perf_counter() - t0)
    spans = TRAIN_SPANS
    device, busy_ms = device_kernels(prof, spans)
    # a span's device time is that of the kernels launched inside it on the calling
    # thread; autograd launches the backward's kernels from its own thread, so the
    # backward's share is what the other three leave
    stages = {e.key: e.device_time_total / 1e3 / 3 for e in prof.key_averages()
              if e.device_type == DeviceType.CPU and e.key in spans and e.key != spans[2]}
    stages[spans[2]] = busy_ms / 3 - sum(stages.values())
    emit({"phase": "profile", "steps": 3, "profiled_span_ms": span_ms,
          "device_busy_ms_per_step": busy_ms / 3, "step_ms_unprofiled": step_ms_unprofiled,
          "device_busy_share": busy_ms / 3 / step_ms_unprofiled,
          "stage_device_ms_per_step": stages,
          "top_device_ms_per_step": [{"name": k[:80], "ms": ms / 3, "calls_per_step": n / 3}
                                     for k, ms, n in device[:16]], "card": smi})


def dp_hparams(multihost: bool):
    """The shipped dgrad config (dropout as configured), ``trainer.multihost``
    as asked."""
    from sdfa_tpu_torch.config import configure

    hp = configure("dgrad")
    hp.trainer.set_key("multihost", multihost)
    return hp


def dp_steps(exp, batches):
    """``exp.train_step`` on this process's rows of each global batch; per step
    the metrics, the wall ms, the all-reduces' ms (every ``all_reduce`` timed
    between two synchronizes; the largest is the gradients') and the training
    core's launches. Then the state, on the host."""
    import torch
    import torch.distributed as dist

    from sdfa_tpu_torch.ops import bilstm_core
    from sdfa_tpu_torch.parallel import shard_batch

    real, calls = dist.all_reduce, []

    def timed_all_reduce(tensor, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work = real(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        calls.append((tensor.numel(), 1e3 * (time.perf_counter() - t0)))
        return work

    dist.all_reduce = timed_all_reduce
    steps = []
    try:
        for batch in batches:
            local = shard_batch(exp.mesh, batch)
            calls.clear()
            bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = exp.train_step(local)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            steps.append({"wall_ms": wall, "windows": len(local["speaker_id"]),
                          "grads": {n: p.grad.clone() for n, p in exp.model.named_parameters()
                                    if p.grad is not None},
                          "all_reduces": len(calls),
                          "all_reduce_ms": sum(ms for _, ms in calls),
                          "grad_all_reduce_ms": max(calls)[1] if calls else 0.0,
                          "k5": [bilstm_core.FWD_LAUNCHES, bilstm_core.BWD_LAUNCHES],
                          "metrics": {k: float(v) for k, v in metrics.items()}})
    finally:
        dist.all_reduce = real
    for step in steps:  # to the host after the timed steps
        step["grads"] = {n: g.cpu() for n, g in step["grads"].items()}
    return {"steps": steps, "n_devices": exp.n_devices,
            "state": {k: v.cpu() for k, v in exp.model.state_dict().items()},
            "scalers": {n: [float(x) for x in v] for n, v in exp.scalers.items()}}


def dp_state_checks(model, got, want, lr):
    """Rank 0 (``got``) against one process (``want``), entry by entry.

    The first step's gradient (rank 0's is the mean over the ranks), from the
    same parameters, is reported over its largest |gradient|, not held: an
    entry that BatchNorm all but cancels (a conv's bias before it) is set by
    the order of its sums: a one-process step on the same batch with its
    pairs permuted moves such an entry as far as the ranks do. The loss terms
    and the gradient norm of every step are held by the caller.

    Adam divides each entry's update by the entry's own gradient, so where
    the two runs give an entry's gradient more than ``DP_ROUNDING_REL`` of its
    own size apart in some step (a gradient so small
    against the sums that make it that their order decides it: the weight-norm
    gain of a conv that feeds BatchNorm, whose gradient only BatchNorm's eps
    keeps from zero), the two runs move the entry apart by up to lr a step
    each, and it is held to 2 · lr · steps; every other parameter entry to
    ``DP_STATE_TOL``. A BatchNorm's running statistics after a weight-normed
    layer are held to ``DP_STATE_TOL`` plus what that layer's gain difference r
    explains (the mean scales with the gain, the variance with its square:
    r·|mean|, 2r·|var|, channel by channel); every other buffer to
    ``DP_STATE_TOL``. Returns the worst of each measure; raises where one is
    missed."""
    import torch

    bound = 2 * lr * len(want["steps"])
    gains = {f"{name}.post_bn": f"{name}.kernel_g" for name, m in model.named_modules()
             if getattr(m, "post_bn", None) is not None and hasattr(m, "kernel_g")}
    worst = {"first_step_grad_vs_largest": 0.0, "strict_max_abs": 0.0, "strict_worst": None,
             "rounding_entries": 0, "rounding_max_abs": 0.0, "rounding_bound": bound,
             "buffer_excess": -DP_STATE_TOL}
    rounding = {}
    first = want["steps"][0]["grads"]
    largest = max(float(g.abs().max()) for g in first.values())
    worst["first_step_grad_vs_largest"] = max(
        float((got["steps"][0]["grads"][n] - g).abs().max()) for n, g in first.items()) / largest
    for g_step, w_step in zip(got["steps"], want["steps"]):
        for name, ref in w_step["grads"].items():
            diff = (g_step["grads"][name] - ref).abs()
            apart = diff > DP_ROUNDING_REL * ref.abs()
            rounding[name] = rounding[name] | apart if name in rounding else apart
    for name, ref in want["state"].items():
        diff = (got["state"][name] - ref).abs()
        if name in rounding:
            apart = rounding[name]
            strict = float(diff[~apart].max()) if bool((~apart).any()) else 0.0
            if strict > worst["strict_max_abs"]:
                worst["strict_max_abs"], worst["strict_worst"] = strict, name
            if bool(apart.any()):
                worst["rounding_entries"] += int(apart.sum())
                worst["rounding_max_abs"] = max(worst["rounding_max_abs"],
                                                float(diff[apart].max()))
            continue
        bn, _, stat = name.rpartition(".")
        allow = torch.full_like(ref, DP_STATE_TOL)
        if bn in gains and stat in ("mean", "var"):
            g0, g1 = got["state"][gains[bn]].flatten(), want["state"][gains[bn]].flatten()
            allow += (1 if stat == "mean" else 2) * ((g0 - g1) / g1).abs() * ref.abs()
        worst["buffer_excess"] = max(worst["buffer_excess"], float((diff - allow).max()))
    worst["entries"] = sum(v.numel() for v in rounding.values())
    if not (worst["strict_max_abs"] <= DP_STATE_TOL
            and worst["rounding_max_abs"] <= bound and worst["buffer_excess"] <= 0):
        raise RuntimeError(f"data_parallel: rank 0 vs one process, state {worst}")
    return worst


def dp_compare(ranks, one, hp):
    """The ranks' results (``dp_steps``) against each other and rank 0's against
    one process's (``one``) on the same global batches: per step and rank the
    loss terms, wall ms and all-reduce ms; raises unless the ranks are
    bit-equal, every rank launched K5 3 + 3 a step on a mesh of all of them,
    and rank 0 is within ``DP_LOSS_RTOL`` and ``dp_state_checks`` of one
    process. Returns the summary."""
    import torch

    from sdfa_tpu_torch.models import build_model

    r0 = ranks[0]
    bit_equal = all(all(torch.equal(v, r["state"][k]) for k, v in r0["state"].items())
                    and r0["scalers"] == r["scalers"]
                    and [s["metrics"] for s in r0["steps"]] == [s["metrics"] for s in r["steps"]]
                    for r in ranks[1:])
    ranks_diff = max(float((v - r["state"][k]).abs().max())
                     for r in ranks[1:] for k, v in r0["state"].items())
    state_diff = {k: float((v - one["state"][k]).abs().max()) for k, v in r0["state"].items()}
    worst = sorted(state_diff, key=state_diff.get, reverse=True)[:3]
    scaler_diff = max(abs(a - b) for n in one["scalers"]
                      for a, b in zip(r0["scalers"][n], one["scalers"][n]))
    loss_rel = max(abs(s0["metrics"][k] - s1["metrics"][k]) / max(abs(s1["metrics"][k]), 1e-9)
                   for s0, s1 in zip(r0["steps"], one["steps"]) for k in s1["metrics"])
    k5 = [[s["k5"] for s in r["steps"]] for r in ranks]
    out = {
        "backend": r0["group_backend"], "n_devices": [r["n_devices"] for r in ranks],
        "per_step": [{"rank": rank, "step": i, "windows": s["windows"],
                      "wall_ms": s["wall_ms"], "all_reduces": s["all_reduces"],
                      "all_reduce_ms": s["all_reduce_ms"],
                      "grad_all_reduce_ms": s["grad_all_reduce_ms"], "k5": s["k5"],
                      **{k: v for k, v in s["metrics"].items() if k != "lr"}}
                     for rank, r in enumerate(ranks) for i, s in enumerate(r["steps"])],
        "one_process": [{"step": i, "windows": s["windows"], "wall_ms": s["wall_ms"],
                         "k5": s["k5"], "total": s["metrics"]["total"],
                         "grad_norm": s["metrics"]["grad_norm"]}
                        for i, s in enumerate(one["steps"])],
        "three_steps_ms": {"ranks": max(sum(s["wall_ms"] for s in r["steps"]) for r in ranks),
                           "one_process": sum(s["wall_ms"] for s in one["steps"])},
        "last_two_steps_ms": {"ranks": max(sum(s["wall_ms"] for s in r["steps"][1:])
                                           for r in ranks),
                              "one_process": sum(s["wall_ms"] for s in one["steps"][1:])},
        "ranks_bit_equal": bit_equal, "ranks_max_abs_diff": ranks_diff,
        "vs_one_process": {"max_abs_state": state_diff[worst[0]],
                           "worst_state": {k: state_diff[k] for k in worst},
                           "max_abs_scalers": scaler_diff, "max_rel_metrics": loss_rel,
                           "state_tol": DP_STATE_TOL, "metrics_rtol": DP_LOSS_RTOL}}
    if not bit_equal or ranks_diff != 0.0:
        raise RuntimeError(f"data_parallel: the ranks differ ({ranks_diff})")
    if any(step != [3, 3] for r in k5 for step in r):
        raise RuntimeError(f"data_parallel: training-core launches per step {k5}, not 3 + 3")
    if [r["n_devices"] for r in ranks] != [len(ranks)] * len(ranks):
        raise RuntimeError(f"data_parallel: mesh sizes {[r['n_devices'] for r in ranks]}")
    if not (scaler_diff <= DP_STATE_TOL and loss_rel <= DP_LOSS_RTOL):
        raise RuntimeError(f"data_parallel: rank 0 vs one process {out['vs_one_process']}")
    out["vs_one_process"]["state_by_entry"] = dp_state_checks(
        build_model(hp, pca=seeded_pca()), r0, one, float(hp.optim.args.lr))
    return out


def dp_rank(argv):
    """One rank of the ``data_parallel`` phase: ``chip_smoke.py --dp-rank RANK
    WORLD INIT_FILE OUT LOG_DIR``. It joins a gloo group through the phase's
    rendezvous file, takes ``DP_STEPS`` steps of the full-width dgrad model on
    its rows of the script's seeded batches on ``cuda:0`` and writes
    ``dp_steps``' result to OUT."""
    rank, world, init, out, log_dir = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import datetime

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.train import Experiment

    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT_S))
    try:
        hp = dp_hparams(multihost=True)
        exp = Experiment(hp, build_model(hp, pca=seeded_pca()), log_dir, "cuda:0", seed=SEED)
        result = dp_steps(exp, train_batches(DP_STEPS))
        result["group_backend"] = dist.get_backend()
    finally:
        dist.destroy_process_group()
    torch.save(result, out)


def data_parallel_phase(trained, repo, dev, smi):
    """Two gloo ranks on ``cuda:0`` (the card's one device; NCCL refuses two
    ranks on one card) start as subprocesses of this script (``dp_rank``) and
    take ``DP_STEPS`` steps of 50 windows each, their pair-keeping halves of the
    seeded 100-window batches, while this process takes the same steps at world
    size 1 on the whole batches. The ranks must be bit-equal to each other and
    within ``DP_LOSS_RTOL`` / ``dp_state_checks`` of the one process, with 3 +
    3 training-core launches a step each. Started beside them, so that their
    start-ups overlap: ``python -m torch.distributed.run --standalone
    --nproc_per_node 1 -m sdfa_tpu_torch train`` with ``trainer.multihost`` on
    the ``data_train`` dataset and a validation epoch: NCCL reported, its
    epoch, last and best checkpoints, the child's K1 / K2 (validation) and K5
    launches from its log; ``load_task`` of that checkpoint
    serves a 3 s request through K1, K2 and K3. Returns the launch counts of
    the phase's path: the ranks' steps (both ranks) and the request. The two
    ranks share the card's SMs (and may meet the launcher's child there):
    their step times measure contention, not a rank on a card of its own."""
    import numpy as np
    import torch

    from sdfa_tpu_torch import api
    from sdfa_tpu_torch.mesh import FLAME_COUNTS
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.ops import bilstm2, decode_solve, freq_lstm
    from sdfa_tpu_torch.train import Experiment

    counters = {"freq_lstm": freq_lstm, "bilstm2": bilstm2, "decode_solve": decode_solve}
    out = {"phase": "data_parallel", "card": smi, "world": DP_WORLD, "steps": DP_STEPS}
    path, procs, t_phase = {}, [], time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="sdfa_chip_dp_", dir=trained["tmp"])
    try:
        # 1. the launcher's NCCL run (3. below) and the two gloo ranks start together:
        #    their start-up, imports and a CUDA context each, overlaps the one-process run
        run, nccl_log = os.path.join(tmp, "nccl_run"), os.path.join(tmp, "nccl.log")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
               "1", "-m", "sdfa_tpu_torch", "train", "--custom_hparams", trained["config"],
               "--dataset_root", trained["root"], "--max_steps", str(DP_NCCL_STEPS),
               "--log_dir", run,
               "--overrides", json.dumps({"trainer": {"pca_targets": True, "multihost": True,
                                                      "valid_gap_epochs": 1}})]
        with open(nccl_log, "w") as fp:
            procs.append(subprocess.Popen(cmd, cwd=repo, stdout=fp, stderr=subprocess.STDOUT))
        init = os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(DP_WORLD)]
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(DP_WORLD)]
        for r in range(DP_WORLD):
            with open(logs[r], "w") as fp:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
                     str(DP_WORLD), init, outs[r], os.path.join(tmp, f"run{r}")],
                    cwd=repo, stdout=fp, stderr=subprocess.STDOUT))
        hp1 = dp_hparams(multihost=False)
        exp1 = Experiment(hp1, build_model(hp1, pca=seeded_pca()), os.path.join(tmp, "one"), dev,
                          seed=SEED)
        one = dp_steps(exp1, train_batches(DP_STEPS))
        del exp1
        end = time.monotonic() + DP_TIMEOUT_S
        for proc in procs[1:]:
            proc.wait(timeout=max(end - time.monotonic(), 1.0))
        failed = [(r, p.returncode, open(logs[r]).read()[-3000:])
                  for r, p in enumerate(procs[1:]) if p.returncode]
        if failed:
            raise RuntimeError(f"data_parallel ranks failed: {failed}")
        ranks = [torch.load(o, weights_only=False) for o in outs]
        out["ranks_wall_s"] = time.perf_counter() - t_phase

        # 2. the checks: the ranks bit-equal, rank 0 against one process
        out.update(dp_compare(ranks, one, hp1))
        path["bilstm_core_fwd"] = sum(s["k5"][0] for r in ranks for s in r["steps"])
        path["bilstm_core_bwd"] = sum(s["k5"][1] for r in ranks for s in r["steps"])

        # 3. NCCL at world size 1 through the launcher, on the data_train dataset
        proc = procs[0]
        proc.wait(timeout=max(end - time.monotonic(), 1.0))
        with open(nccl_log) as fp:
            text = fp.read()
        group = re.search(r"process group: rank (\d+) of (\d+) \((\w+)\)", text)
        launches = re.search(r"kernel launches in this process: freq_lstm (\d+), bilstm2 (\d+), "
                             r"training core forward (\d+), backward (\d+)", text)
        ckpts = sorted(f for f in os.listdir(run) if f.endswith(".ckpt")) \
            if os.path.isdir(run) else []
        out["nccl"] = {"exit": proc.returncode, "wall_s": time.perf_counter() - t_phase,
                       "group": group.groups() if group else None,
                       "launches": [int(n) for n in launches.groups()] if launches else None,
                       "checkpoints": ckpts}
        if proc.returncode != 0:
            raise RuntimeError(f"torch.distributed.run train exited {proc.returncode}: "
                               f"{text[-3000:]}")
        if out["nccl"]["group"] != ("0", "1", "nccl"):
            raise RuntimeError(f"torch.distributed.run train: group {out['nccl']['group']}")
        n = out["nccl"]["launches"]  # K1, K2 in the validation's eval steps; K5 3 + 3 a step
        if n is None or min(n[:2]) < 1 or n[2:] != [3 * DP_NCCL_STEPS] * 2:
            raise RuntimeError(f"torch.distributed.run train: launches {n}")
        if ckpts != sorted(["best-ploss.ckpt", f"epoch0001-step{DP_NCCL_STEPS:06d}.ckpt",
                            "last.ckpt"]):
            raise RuntimeError(f"torch.distributed.run train: checkpoints {ckpts}")

        # 4. that checkpoint serves a request through K1, K2 and K3
        task = api.load_task(os.path.join(run, "last.ckpt"), device=dev)
        task.warmup(3.0)
        sig = signal(3.0, int(task.hp.audio.sample_rate), 50)
        reset_counts(counters)
        ts, v = task.generate_vertices(sig, 1)
        served = read_counts(counters, "data_parallel request")
        out["request"] = {"windows": len(ts), "launches": served}
        path.update(served)
        if v.shape != (len(ts), FLAME_COUNTS[0], 3) or not np.isfinite(v).all():
            raise RuntimeError(f"data_parallel request: bad output {v.shape}")
        if min(served.values()) < 1:
            raise RuntimeError(f"data_parallel request: a kernel never launched {served}")
        del task
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()  # the launcher stops its worker on SIGTERM
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        out["phase_s"] = time.perf_counter() - t_phase
        emit(out)  # what was measured, also when a check failed
    return path


def dp_launched(out_dir: str, windows: int):
    """One rank under ``torch.distributed.run`` (``chip_smoke.py --dp-launched
    OUT_DIR WINDOWS``): ``trainer.multihost`` joins the launcher's group (NCCL,
    ``cuda:{LOCAL_RANK}``), ``DP_STEPS`` steps of the full-width dgrad model on
    the rank's rows of seeded batches of ``windows``, ``dp_steps``' result to
    ``OUT_DIR/rank{r}.pt``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import torch.distributed as dist

    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.parallel import multihost
    from sdfa_tpu_torch.train import Experiment

    try:
        hp = dp_hparams(multihost=True)
        exp = Experiment(hp, build_model(hp, pca=seeded_pca()), os.path.join(out_dir, "run"),
                         "cuda", seed=SEED)
        result = dp_steps(exp, train_batches(DP_STEPS, windows))
        result["group_backend"] = dist.get_backend()
        result["device"] = str(exp.device)
        torch.save(result, os.path.join(out_dir, f"rank{exp.mesh.rank}.pt"))
    finally:
        multihost.shutdown()


def cards_main(n_cards: int):
    """``python3 chip_smoke.py --cards N``, on a machine with N cards: the
    ``data_parallel`` comparison with one rank a card on NCCL, under
    ``torch.distributed.run``, at 2 ranks and at N: each rank holds 50 windows
    (the global batch 50 x ranks), against one process on ``cuda:0`` on the
    same global batches, after the launch. Prints one line per world size,
    then the cards' names and power limits and the result line."""
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "sdfa_tpu_torch")):
        sys.exit("chip_smoke.py: the sdfa_tpu_torch package is not beside this script")
    sys.path.insert(0, root)
    import torch

    if torch.cuda.device_count() < n_cards:
        sys.exit(f"chip_smoke.py --cards {n_cards}: torch sees {torch.cuda.device_count()} "
                 "CUDA devices")
    processes_before = group_processes()
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.ops import build
    from sdfa_tpu_torch.train import Experiment

    build.load_libraries(["freq_lstm", "bilstm2", "decode_solve", "bilstm_layer", "bilstm_core"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()
    for world in sorted({2, n_cards}):
        windows = TRAIN_WINDOWS // 2 * world
        with tempfile.TemporaryDirectory(prefix="sdfa_chip_cards_") as tmp:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                 str(world), os.path.abspath(__file__), "--dp-launched", tmp, str(windows)],
                cwd=root, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
            launch_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"--cards: {world} ranks exited {proc.returncode}: "
                                   f"{(proc.stdout + proc.stderr)[-3000:]}")
            ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                     for r in range(world)]
            hp1 = dp_hparams(multihost=False)
            exp1 = Experiment(hp1, build_model(hp1, pca=seeded_pca()), os.path.join(tmp, "one"),
                              "cuda:0", seed=SEED)
            one = dp_steps(exp1, train_batches(DP_STEPS, windows))
            del exp1
            out = {"phase": "data_parallel_cards", "world": world, "windows": windows,
                   "devices": [r["device"] for r in ranks], "launch_s": launch_s,
                   **dp_compare(ranks, one, hp1), "cards": smi}
            emit(out)
            if out["backend"] != "nccl" or len(set(out["devices"])) != world:
                raise RuntimeError(f"--cards: backend {out['backend']}, devices {out['devices']}")
    check_no_process_left(processes_before)
    print("; ".join(smi), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def k3_rows(root: str):
    """``chip_smoke.py --k3-rows ROOT``: the package at ROOT (a checkout of this
    repository, this one or another commit's unpacked by ``git archive``)
    times K3's rows of the kernel phase, the full body on the fan-out table at
    216, 128 and 512 windows and on the identity table at 256, the delta body at
    256, 216, 128 and 512, on seeded bases and coefficients, 20 launches after
    a warm-up each; prints one JSON line of ms by row."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import sdfa_tpu_torch
    from sdfa_tpu_torch.mesh import synthetic_template
    from sdfa_tpu_torch.ops import build, decode_solve
    from sdfa_tpu_torch.ops.deform_solver import DeformationSolver

    if not os.path.abspath(sdfa_tpu_torch.__file__).startswith(root + os.sep):
        sys.exit(f"--k3-rows: imported {sdfa_tpu_torch.__file__}, not the package at {root}")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py --k3-rows: torch.cuda.is_available() is false")
    dev = torch.device("cuda:0")
    build.load_libraries(["decode_solve"])
    verts, faces, cnst = synthetic_template(SEED)
    pca = seeded_pca()
    bases = (pca["scale_compT"], pca["scale_means"], pca["rotat_compT"], pca["rotat_means"])
    ident = DeformationSolver(verts, faces, cnst)
    count, corr, _ = fanout_table(len(faces))
    fan = DeformationSolver(verts, faces, cnst, corr_count=count, corr_faces=corr)

    def coefs(windows):
        gen = torch.Generator().manual_seed(3 if windows == K3_WINDOWS else 300 + windows)
        return (torch.randn(windows, 85, generator=gen).to(dev),
                torch.randn(windows, 180, generator=gen).to(dev))

    ms = {}
    with torch.inference_mode():
        dsc = decode_solve.prep_consts(*bases, ident, dev)
        for windows in (K3_WINDOWS, K3_REQUEST_WINDOWS) + LIVE_WINDOWS:
            cs, cr = coefs(windows)
            ms[f"delta_{windows}"] = time_ms(lambda: decode_solve.decode_solve(cs, cr, dsc), 20)
        del dsc
        for table, solver, rows in (("fanout", fan, (K3_REQUEST_WINDOWS,) + LIVE_WINDOWS),
                                    ("identity", ident, (K3_WINDOWS,))):
            fsc = decode_solve.prep_full_consts(*bases, solver, dev)
            for windows in rows:
                cs, cr = coefs(windows)
                ms[f"full_{table}_{windows}"] = time_ms(
                    lambda: decode_solve.decode_solve_full(cs, cr, fsc), 20)
            del fsc
    emit({"phase": "k3_rows", "root": root, "ms": ms})


def proj_rows(root: str):
    """``chip_smoke.py --proj-rows ROOT``: the package at ROOT (as ``--k3-rows``
    takes it) times the input projection's rows of the kernel phase
    (``proj_row_specs``): the device ms of the whole projection in a call of the
    kernel that runs it (every kernel whose name holds ``proj_``: the product
    and, where the checkout has it, the staging of w_ih), by torch.profiler over
    10 calls after a warm-up, on the same seeded inputs; prints one JSON line of
    ms by row."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import sdfa_tpu_torch
    from sdfa_tpu_torch.ops import bilstm2, bilstm_layer, build, freq_lstm

    if not os.path.abspath(sdfa_tpu_torch.__file__).startswith(root + os.sep):
        sys.exit(f"--proj-rows: imported {sdfa_tpu_torch.__file__}, not the package at {root}")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py --proj-rows: torch.cuda.is_available() is false")
    dev = torch.device("cuda:0")
    build.load_libraries(["freq_lstm", "bilstm2", "bilstm_layer"])
    ms = {}
    for i, spec in enumerate(proj_row_specs()):
        call, _ = proj_row_call(spec, (freq_lstm, bilstm2, bilstm_layer), dev, 600 + i)
        ms[spec[0]] = kernel_split(call, 10, PROJ_PARTS)["input_projection"]
        del call
        torch.cuda.empty_cache()
    emit({"phase": "proj_rows", "root": root, "ms": ms})


def outproj_rows(root: str):
    """``chip_smoke.py --outproj-rows ROOT``: the package at ROOT (as ``--k3-rows``
    takes it) times K1's output projection at its rows of the kernel phase
    (``outproj_row_specs``): the device ms of ``out_parts_kernel`` +
    ``out_sum_kernel`` in a call of the public ``freq_lstm.freq_lstm``, by
    torch.profiler over 10 calls after a warm-up, on the same seeded inputs;
    prints one JSON line of ms by row."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import sdfa_tpu_torch
    from sdfa_tpu_torch.ops import build, freq_lstm

    if not os.path.abspath(sdfa_tpu_torch.__file__).startswith(root + os.sep):
        sys.exit(f"--outproj-rows: imported {sdfa_tpu_torch.__file__}, not the package at {root}")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py --outproj-rows: torch.cuda.is_available() is false")
    dev = torch.device("cuda:0")
    build.load_libraries(["freq_lstm"])
    ms = {}
    for i, spec in enumerate(outproj_row_specs()):
        call, _ = outproj_row_call(spec, freq_lstm, dev, 700 + i)
        ms[spec[0]] = kernel_split(call, 10, OUTPROJ_PARTS)["output_projection"]
        del call
        torch.cuda.empty_cache()
    emit({"phase": "outproj_rows", "root": root, "ms": ms})


def wide_rows(root: str):
    """``chip_smoke.py --wide-rows ROOT``: the package at ROOT (as ``--k3-rows``
    takes it) times the wide step loop at its rows of the kernel phase
    (``wide_row_specs``): the device ms of the step loop's kernel in a call
    (``wide_steps_kernel`` for K1, K2, K4 and K5's forward, ``wide_bwd_kernel``
    for K5's backward) and of the whole call (``row_ms``), by torch.profiler over
    10 calls after a warm-up, on the same seeded inputs, and each row's drift from
    float64 (``wide_row_call``); prints one JSON line."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import sdfa_tpu_torch
    from sdfa_tpu_torch.ops import bilstm2, bilstm_core, bilstm_layer, build, freq_lstm

    if not os.path.abspath(sdfa_tpu_torch.__file__).startswith(root + os.sep):
        sys.exit(f"--wide-rows: imported {sdfa_tpu_torch.__file__}, not the package at {root}")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py --wide-rows: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    build.load_libraries(["freq_lstm", "bilstm2", "bilstm_layer", "bilstm_core"])
    ms, row_ms, drift = {}, {}, {}
    for i, spec in enumerate(wide_row_specs()):
        call, f64_drift = wide_row_call(spec, (freq_lstm, bilstm2, bilstm_layer, bilstm_core),
                                        dev, 800 + i)
        split = kernel_split(call, 10, WIDE_PARTS.get(spec[1], RECURRENT_PARTS))
        ms[spec[0]], row_ms[spec[0]] = split["step_loop"], sum(split.values())
        drift[spec[0]] = f64_drift()
        del call, f64_drift
        torch.cuda.empty_cache()
    emit({"phase": "wide_rows", "root": root, "ms": ms, "row_ms": row_ms, "f64_drift": drift,
          "f64_drift_is": "max |kernel - float64| (K5 bwd: of d(xp), over its largest)"})


def rows_in_turns(kind: str, roots):
    """``chip_smoke.py --k3-turns ROOT [ROOT ...]`` (``kind`` "k3"),
    ``--proj-turns`` (``kind`` "proj"), ``--outproj-turns`` (``kind``
    "outproj") or ``--wide-turns`` (``kind`` "wide"): ``--k3-rows`` /
    ``--proj-rows`` / ``--outproj-rows`` / ``--wide-rows`` of each ROOT in a
    process of its own, in the order given (parent, change, change, parent
    compares two commits on one card), then each row's times (and, where a
    mode gives them, its whole call's ms and its drift from float64) by root;
    ends with the card's name and power limit and the result line."""
    import torch

    if not torch.cuda.is_available():
        sys.exit(f"chip_smoke.py --{kind}-turns: torch.cuda.is_available() is false; this needs "
                 "a GPU")
    smi = nvidia_smi_line()
    by_root, extra_by_root = {}, {}
    for turn, root in enumerate(roots):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), f"--{kind}-rows", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"--{kind}-rows {root} exited {proc.returncode}: "
                               f"{(proc.stdout + proc.stderr)[-3000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        emit({"phase": f"{kind}_turn", "turn": turn, **line, "card": smi})
        for row, ms in line["ms"].items():
            by_root.setdefault(line["root"], {}).setdefault(row, []).append(ms)
        for key in ("row_ms", "f64_drift"):
            for row, v in line.get(key, {}).items():
                extra_by_root.setdefault(key, {}).setdefault(line["root"], {}).setdefault(
                    row, []).append(v)
    emit({"phase": f"{kind}_turns", "ms_by_root": by_root,
          **{f"{k}_by_root": v for k, v in extra_by_root.items()}, "card": smi})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank(sys.argv[2:])
    elif sys.argv[1:2] == ["--dp-launched"]:
        dp_launched(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1:2] == ["--cards"]:
        cards_main(int(sys.argv[2]))
    elif sys.argv[1:2] == ["--k3-rows"]:
        k3_rows(sys.argv[2])
    elif sys.argv[1:2] == ["--k3-turns"]:
        rows_in_turns("k3", sys.argv[2:])
    elif sys.argv[1:2] == ["--proj-rows"]:
        proj_rows(sys.argv[2])
    elif sys.argv[1:2] == ["--proj-turns"]:
        rows_in_turns("proj", sys.argv[2:])
    elif sys.argv[1:2] == ["--outproj-rows"]:
        outproj_rows(sys.argv[2])
    elif sys.argv[1:2] == ["--outproj-turns"]:
        rows_in_turns("outproj", sys.argv[2:])
    elif sys.argv[1:2] == ["--wide-rows"]:
        wide_rows(sys.argv[2])
    elif sys.argv[1:2] == ["--wide-turns"]:
        rows_in_turns("wide", sys.argv[2:])
    elif sys.argv[1:2] == ["--longrun"]:
        longrun_main(int(sys.argv[2]))
    else:
        main()
