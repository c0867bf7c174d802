#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``feddrift_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines of output each:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles every CUDA source of ``feddrift_torch/kernels/csrc``
   with nvcc (sm_90a, one process a source, all at once) and prints the
   build seconds, ptxas' registers and spills per kernel of every source,
   and the count of tensor-core (``HMMA``) instructions in the flash and
   ``dense_rows`` libraries' SASS (``cuobjdump``; "not measured" without
   it).
3. kernel: holds the flash-attention kernel against its plain PyTorch
   version on the card at the serving shape and the mean served
   micro-batch (q, k, v split off one qkv projection, as the transformer
   hands them over), and at three others, the last at L = 8192 for the
   error at long sequences; it times the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only; the port never
   calls it): per call, on the device, and the host's enqueue alone (host
   times in turns, five rounds, medians). Then the per-row Dense kernel
   (``dense_rows``) at the five Dense shapes of the served transformer at
   b32 and b8: against its plain version (and both against the float64
   product), its first and last rows bitwise equal to their b1 calls, and
   its times (with its route) beside ``torch.bmm``'s (``torch.baddbmm``
   where the layer has a bias), the device time recorded for its first
   design (SIMT float32) and the bound (over the routes the card offers:
   bytes against 3xTF32 tensor-core operations, the float32 SIMT figure
   beside it); then the Dense work of one forward (``dense_forward``: 2 x
   the four block layers + the lm_head) at each batch.
4. serve: the port's main path at full registry width. The ``shakespeare``
   dataset at its defaults, a pool of 4 distinct ``transformer`` models,
   10 clients spread over them, ``InferenceEngine`` with the
   (1, 2, 4, 8, 16, 32) buckets, 512 requests from 8 closed-loop workers
   with dataset windows as inputs. Fails unless every request completed
   with no error and both kernels were launched on that path (2 flash and
   9 Dense launches a micro-batch); then checks served answers against
   one-row forwards (bitwise) and against the plain CPU path, and runs one
   row alone and in a batch of 32, op by op: it fails if any op's answer
   for that row depends on the batch.
5. train_kernel: holds K1, the local-SGD kernel, against its plain version
   on the card through both of its kernels: the fused one at the canonical
   SEA shape (M=4 models, C=10 clients, T1=11 steps, N=B=500 rows, S=5
   local steps, 3->10->2 fnn) with three pairs and one whole model
   inactive and at F=2 (sine), the general one at the SEA shape (forced:
   the kernel of the first design, timed in the same run) and at H=32,
   and both on gathered batches (rows drawn by K4 under Poisson sample
   weights, per-model feature masks: KUE's route), the wide one at
   MNIST-4's width (the fnn under AMSGrad, contiguous and gathered with
   masks, and under SGD; the lr under both; AMSGrad held to the plain
   version run in float64 as the float32 plain version is) with the general
   one forced there beside it, and the general one's lr and SGD routes at
   SEA; the split kernel at fmow's width (F 3072, the fnn 3072 -> 10 -> 62:
   AMSGrad contiguous, gathered with masks, at B 32 and with one model, and
   SGD) and the wide kernel at
   femnist-fnn's shape (784 -> 10 -> 62, two classes a lane); two calls of
   each must agree bitwise. It times each (per call and on the device, and
   the device time per local step) and the plain version in turns; a
   ``mnist_width_by_route`` line sets the wide kernel beside the general
   one, the plain version, its bound and its clusters at once, and a
   ``fmow_width_by_route`` line the split kernel beside its plain version,
   its bound, its clusters at once and the rate at which it streams x;
   the split kernel padded past F at stackoverflow_lr's fnn (1000 -> 10 ->
   50, AMSGrad, contiguous and gathered with masks) and at cifar10's (K
   10), each with ptxas' registers and spills in the build line; the fused
   kernel at susy's (18 -> 10 -> 2) and ro's (5 -> 10 -> 2) widths, where
   it folds a row's values 32 at a time (contiguous, and gathered with
   masks; ptxas' registers and spills of each instance on its lines),
   held to the plain version as SEA's fused case is, the general kernel
   forced on the same inputs timed beside it (``susy_width_by_route``,
   ``ro_width_by_route``).
   train_draw: K4, the weighted draw, as its two kernels at KUE's
   canonical shape with clients 1 and 6 left out by a round's mask: K4a
   (``weighted_cdf``, the step's cdf of the unmasked weights) and K4b
   (``weighted_search``, a round's rows under the masked total weights)
   against their plain versions (integer weights: cdf and rows bitwise,
   and the rows those of the one-call draw of the masked weights;
   non-integer weights: the cdf to 1e-6 relative, a row differing only
   where its uniform lies within that of a cdf boundary; the count is
   printed), each timed per call, enqueue and on the device beside its
   plain version, one library call (``torch.cumsum``,
   ``torch.searchsorted``), both together, and its bound.
   train_agg, train_eval: K2, the masked FedAvg, against its plain version
   on one K1 round's client stack at H = 32 (the general route's, M 4, C
   10, P 194), at the canonical width (P 62), at MNIST-4's (P 7960, M 4 and
   10) and at fmow's (P 31,412), model 3 with no active client: within
   1e-6, that model's params
   bitwise its previous ones, the stats equal; K2 as the epilogue of K1's
   fused kernel (``local_sgd_fedavg``) at the canonical shape, on gathered
   rows (KUE's route) and at F = 2: bitwise equal to the K1 launch
   followed by the ``fedavg.cu`` launch in every output, over 200 calls
   back to back, timed beside K1 and K2 alone (and the same at susy's and
   ro's widths, contiguous, and at susy's gathered with masks); the same
   launch with K3
   folded in (``local_sgd_fedavg_eval``: the eval of its input params on
   steps 4 and 5, with the case's feature masks) bitwise equal in every
   output, counts and NLL sums included, to the K1 + K2 launch followed by
   the standalone K3 launch, over 200 calls back to back, timed per call,
   enqueue and on the device beside K1 + K2 alone and K3 alone; K3, the
   eval matrices,
   through both of its kernels on strided windows of the SEA dataset
   (T1 11, N 500): an eval's two steps (G = 2), one step (G = 1), every
   step (G = T1, counts only), with feature masks, the general kernel
   forced at SEA and at H = 32, the wide kernel at MNIST-4's width (the fnn
   and the lr, the general kernel forced there beside it) and its
   streamed kernel at fmow's (G = 2, T1, masks; G = 2 and T1 with one
   model), the general
   kernel's lr route at SEA, the fused kernel at susy's width with the
   general one forced on its inputs beside it (counts equal and NLL sums
   bitwise between the two): counts equal except rows whose top two
   plain logits lie within 1e-5 (counted), NLL sums within 1e-4
   relative. Two calls of each agree bitwise; each is timed per call,
   enqueue and on the device beside its plain version and bound. Then
   ``train_plain`` lines time K5's functions, still plain PyTorch
   (``ensemble_eval`` hard and soft, ``mse_matrix``,
   ``confusion_matrices``), at AUE's and KUE's shapes beside their bounds.
6. train: the port's training main path at full width, the canonical
   ``python -m feddrift_torch run`` configuration (SEA, change points A,
   fnn, softcluster H_A_C_1_10_0, 10 steps x 200 rounds, checkpoint every
   step): per-step wall, rounds/s, final Test/Acc and models in use, then
   the launches of K1 (through the fused kernel), K2 (the aggregations:
   K1's epilogues and K2's own launches), the evals folded into K1's
   launches and K3's own launches, the plain K2 / K3 / K4 calls on the
   card, and the launches a round, device-busy share and device time a
   round of one profiled time step.
   Fails unless every step ran, the checkpoint exists, K1 carried all
   2000 rounds and aggregated each in its epilogue (no K2 launch of its
   own), every step folded its 40 regular evals into K1's launches (400)
   and launched K3 for its final one, no K4 and no plain K2 / K3 / K4
   ran, and
   Test/Acc tracks the committed reference run
   ``runs/sea-fnn-softcluster-H_A_C_1_10_0-s0`` (each step within 0.04,
   the 10-step mean within 0.015: across seeds 0-2 of the committed
   ``H_A_F_1_3_0`` runs one step differs by up to 0.025, the mean by 0.003).

7. train_algos: the paper's other algorithms at the canonical full width
   (SEA, change points A, 10 clients, 10 steps x 200 rounds of 5 AMSGrad
   steps on 500 rows): CFL (``softcluster cfl_0.1_win-1``, the per-round
   path), IFCA on the current step (``softclusterwin-1 hard``), the
   single-model baselines ``win-1``, ``oblivious``, ``exp`` and ``lin``
   (M = 1), DriftSurf, MultiModel ``mmacc_06`` and ``mmgeni`` (fused),
   Adaptive-FedAvg ``win-1_iter``, the legacy ``clusterfl``, AUE, AUE-PC
   and KUE (per round; KUE through K4 and K1's gather route). One
   ``train_algo`` line each: the path, wall, rounds/s, K1 launches, K2's
   aggregations, folded evals and K3 launches (and KUE's K4a and K4b), the
   plain K2 / K3 / K4 calls, host syncs a round, models
   in use per step, per-step Test/Acc beside its committed SEA reference
   run, and the card's decisions (each client's model at every step's
   end, and the counts of drift, spawn, split and replacement events)
   beside the committed run's; then the kernel launches a round, busy
   share and device time a round and K1's and K3's device time a launch
   in one profiled time step. Fails unless K1 carried all 2000 rounds on
   the expected path and aggregated each in its epilogue, every fused
   run folded all but one eval a step into K1 and every per-round run
   none,
   KUE launched K4a once a step and K4b once a round (and nothing else
   launched K4), no plain K2 / K3 / K4 ran on the card, and
   every step is within 0.04 (the mean within 0.015) of the committed run,
   whose final Test/Acc are pinned.
8. train_sampling: 4 of 10 clients a round at full width, T = 2, R = 50,
   once fused and once per round: fails unless the two give bitwise-equal
   Test/Acc series and final pools, the series differs from k = 10, and a
   round's n is 0 exactly for the clients its mask leaves out.
9. train_per_round_kinds: ``hard-r`` (per round), ``softcluster
   mmacc_06``, ``softmax_3``, ``geni`` and ``softclusterreset softmax_3``
   at full width, T = 3, R = 20: each must take its path, launch K1 and
   aggregate once a round and give finite metrics.
10. train_general: the general kernel's route (``fnn_hidden_dim`` 32, T =
   2, R = 20), which has no epilogue and folds no eval: K1 and
   ``fedavg.cu`` launch once a round, K3 once an eval.
11. train_mnist: MNIST-4 (F 784, the fnn 784 -> 10 -> 10, B = N = 500) at
   full width, the five committed configurations of ``MNIST_RUNS``, all 10
   steps each, from the reference's init: every round one launch of K1's
   wide kernel and one of ``fedavg.cu``, every eval one of K3's wide
   kernel, none of either general kernel, no plain call on the card;
   Test/Acc against the committed run within the gates fixed there.
12. train_lr: the lr model and SGD (``LR_RUNS``): MNIST-4's lr under adam
   and sgd on the wide kernels' lr routes, SEA's lr under sgd and adam on
   the general kernels', each against the JAX package's own run (SEA's
   adam at step 0, ``LR_STEP0_RUNS``).
13. nan_semantics: a poisoned pool (model 0 a NaN in Dense_0/kernel,
   model 1 an Inf in its last bias) through K1 (fused with its epilogue,
   general, wide, the lr routes) and K3 (folded into K1, fused, general,
   wide, lr): every output finite in exactly the plain version's cells,
   K3's counts equal (the first NaN is the argmax) and its NLL sums equal
   where finite; the MNIST cases on the wide kernels, the fmow cases on
   K1's split kernel and K3's streamed kernel.
14. train_gmm: ``softcluster gmm`` at the canonical full width, fused,
   from the reference's init, against the JAX package's CPU run
   (``GMM_RUN``): K1 carries every round, no plain call, Test/Acc within
   the SEA gates; gmm's mean weight on model 0 per step is printed beside
   the reference's.
15. train_guard: the canonical run and CFL with the divergence guard on
   and off (Test/Acc bitwise equal; walls and host syncs a round of
   both); win-1 poisoned at step 1, fused and per round (every
   divergence non-finite, each rollback bitwise the pool its step or
   round started from, ``DivergenceError`` after 3, an incident bundle
   that ``python -m feddrift_torch incident`` renders naming it); and
   ``BLOWUP_RUN``, a learning rate at which the JAX package's CPU run goes
   non-finite (the guard fires non-finite and the run aborts).
16. train_preempt: ``python -m feddrift_torch run`` (T = 4, R = 20) in a
   subprocess stopped by SIGTERM after its first checkpoint: exit 0 with
   ``"preempted": true``; ``run --auto_resume`` and ``resume --out_dir``
   each finish a copy, with every metrics row equal to an uninterrupted
   run's.
17. trace_plane: the training run's trace plane. The canonical run, fused,
   with ``out_dir``, ``hostprof_hz`` 100 and ``debug_checks`` on: its
   Test/Acc series bitwise that of the run with every plane off, K1
   carrying its 2000 rounds; ``python -m feddrift_torch report --trace``,
   ``critical_path --flame`` and ``lineage --dot`` exit 0 on its run
   directory; every iteration's segments cover its wall within [0.95,
   1.05] and hold ``dispatch`` and ``device_compute``; ``hostprof.folded``
   is not empty; ``host_overhead_frac``'s mean is printed beside the
   profiler's busy share of one more fused step. CFL per round at
   ``profile_rounds`` 10 (20 profiled rounds and a ``host_overhead_frac``
   every step) against 10^9, bitwise, both walls printed (in turns: 10,
   10^9, 10^9, 10). ``device_trace`` around one fused step: a trace file
   naming K1's kernel and a ``profile_captured`` event. ``debug_checks``
   on ``BLOWUP_RUN``: the run raises ``FloatingPointError`` naming K1.
18. train_fmow: FMoW (images 32 x 32 x 3, F 3072, the fnn 3072 -> 10 ->
   62, B = N = 500) at full width, the four committed configurations of
   ``FMOW_RUNS``, 10 steps each, from the reference's init: every round
   one launch of K1's split kernel and one of ``fedavg.cu``, every eval one
   of K3's streamed kernel, none of the other K1 kernels, no
   plain call on the card; Test/Acc a step and on the mean within the
   gates of ``FMOW_RUNS`` of the JAX package's run from the same init
   (``FMOW_REFERENCE_ACCS``; the committed run is printed beside it). It
   runs last, so a run outside its gate leaves every other phase checked;
   it drives all four runs before it fails.
   Before it, train_tabular: susy (F 18) and ro (F 5) on K1's fused
   kernel with K2 as its epilogue and the evals folded in (K3's fused
   kernel for a step's last eval), stackoverflow_lr (the fnn 1000 -> 10
   -> 50, AMSGrad) on K1's split kernel padded past F and K3's resident
   wide tiles, at full
   width (``TABULAR_RUNS``: susy's and stackoverflow_lr's softcluster,
   win-1 and oblivious, ro's softcluster), each from its reference init;
   and train_images: femnist (784 -> 10 -> 62, K1's and K3's wide kernels)
   and cifar10 (3072 -> 10 -> 10, the split K1, K3's streamed kernel) in
   softcluster (``IMAGE_RUNS``), and cifar100's fnn refused by
   ``TrainStep.create`` on the card under either optimizer, naming ROADMAP
   §2's item. Each run: every round one K1 launch on its route and one
   ``fedavg.cu`` launch, every eval one K3 launch on its route (susy and
   ro: every round one fused K1 launch with its epilogue, 400 folded
   evals and 10 fused K3 launches, no ``fedavg.cu``, general K1 or other
   K3 launch), no plain call; Test/Acc a step and on the mean against its
   committed run where
   the JAX package reproduces it (susy's three, stackoverflow_lr's
   softcluster), else against the JAX package's CPU run from the same init
   (``NEW_REFERENCE_ACCS``), within the larger of SEA's tolerances and the
   plain version's rounding envelope (``NEW_PLAIN_ENVELOPE``); every run
   is driven before the phase fails.
   Before train_fmow, train_conv: the conv models, trained by the
   model-generic local SGD (cuDNN and cuBLAS, no K1 or K3) with K2's
   ``fedavg.cu`` closing every round. Each registry name (``cnn``,
   ``cnn_dropout``, ``resnet`` / ``resnet20``, ``resnet8``, ``resnet56``,
   ``resnet110``, ``resnet56_gn``, ``resnet18``) at its published width:
   logits and gradient on the card against the CPU path in float64: the
   card's float64 within ``CONV_F64_CARD_TOL``, its float32 under the
   package's ``model_numerics`` within ``CONV_F64_FLOOR`` /
   ``CONV_F64_FACTOR``; two forwards bitwise. The timing case, a round of
   the cnn at fmow-smooth (M 4, C 10, S 5) at B 32 and 500: two rounds
   from the same inputs bitwise, every forward of them under cuDNN's TF32
   off and its algorithms deterministic and the process's flags restored
   after them (asserted), the wall, device ms,
   launches, busy share and top device operations of a round, no gate;
   K2 at that width (P 2,183,166) against its plain version. Then the
   three committed conv runs at their own configurations and full width
   (``CONV_RUNS``: femnist-smooth's cnn under Ada, fmow-smooth's cnn under
   softcluster H_A_C_1_10_0 per round, cifar10-smooth's resnet8 under
   ``hard-r``): every round one ``fedavg.cu`` launch, no K1, K3, K4 or
   plain call, the data and pool on the card; Test/Acc a step and on the
   mean against the committed run within ``_conv_gate``.
   Last, train_rnn: the LSTMs (``rnn``, ``rnn_stackoverflow``), trained by
   the same model-generic local SGD. A float32 layer of a width the layer
   kernels take (CharLSTM's 256) runs its L steps in one
   ``csrc/lstm_layer.cu`` launch forward and one backward; other layers
   (WordLSTM's 670, float64) take the per-step route, each step's cell one
   ``csrc/lstm_cell.cu`` launch forward and one backward. The layer
   kernels against their plain versions at CharLSTM's training shape (K
   30, N 32, L 80), its eval forward (K 1, N 8192) and a ragged N 37,
   within ``LAYER_F64_FACTOR`` times the float32 plain version's distance
   from float64 plus ``LAYER_F64_FLOOR``, two calls bitwise, each
   direction timed beside its bound, the per-step route with the cell
   kernels, the per-step route with PyTorch's fused cell and cuDNN's layer;
   the cell kernels against their plain versions at CharLSTM's (R 960, H
   256) and WordLSTM's (R 1280, H 670) step shapes, float64 and float32,
   within ``RNN_CELL_RTOL``, timed (the per-step route's checked-once call
   and the checked wrappers) beside PyTorch's fused cell and bound; each
   LSTM at its published width held as the conv models are, its layer and
   cell launches counted; the timing case, a round of the committed run's
   configuration, twice bitwise, with its wall, device ms, launches, peak
   memory and top device operations, and K2 at CharLSTM's width (P
   820,522; ``fedavg_rnn``); then ``fed_shakespeare-rnn-aue-10c-s0`` at
   its own configuration (lr 0.03) against its committed run within
   ``_rnn_gate``, and ``rnn_stackoverflow`` on ``stackoverflow_nwp``
   (``RNN_SO_RUN``, no committed run: no gate). Each run: every round one
   ``fedavg.cu`` launch, its route's kernels launched and the other's not,
   no K1, K3, K4 or plain call.
It then prints a ``phase_walls`` line (each phase's seconds), the kernels'
JSON line, the card line and, last, the result line. Each entry of the kernels line takes its launches from the driven
run whose path launches it and its error, times and bound from the case
at that path's shape: the flash kernel and ``dense_rows`` from ``serve``;
K1 with K2 as its epilogue (``local_sgd_fedavg``), the folded evals
(``local_sgd_fedavg_eval``) and K3's own launches from ``train``;
K4a and K4b from KUE's ``train_algo`` run; K1 without an epilogue
(``local_sgd``, the general kernel) and ``fedavg.cu`` from
``train_general``, with their cases at H = 32; K1's and K3's wide kernels
and ``fedavg.cu`` at MNIST's width from ``train_mnist`` and ``train_lr``,
the general kernels' lr routes from ``train_lr``'s SEA run; K1's split
kernel, K3's streamed kernel and ``fedavg.cu`` at fmow's width from
``train_fmow``; K1 + K2, K1 + K2 + K3 and K3's fused kernel at susy's
width (``local_sgd_fedavg_susy``, ``local_sgd_fedavg_eval_susy``,
``eval_cells_fused_susy``) from susy's ``train_tabular`` runs with their
cases from ``train_agg`` / ``train_eval``, the split K1 padded
past F and K3's resident wide tiles at stackoverflow_lr's from its runs,
the wide K1 at two classes a lane and the split K1 at K 10 from
``train_images``' femnist and cifar10 runs, ``fedavg.cu`` at the conv
width (``fedavg_conv``) from ``train_conv``'s runs, the LSTM layer's
kernels (``lstm_layer_fwd``, ``lstm_layer_bwd``) and ``fedavg.cu`` at
CharLSTM's width (``fedavg_rnn``) from ``train_rnn``'s committed run with
their cases at CharLSTM's shapes, the LSTM cell's kernels
(``lstm_cell_fwd``, ``lstm_cell_bwd``) from its WordLSTM run with their
case at WordLSTM's step shape. Every entry
also carries
``device_ms`` beside ``ms``. Any failed phase exits non-zero before the result line. It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

# |kernel - plain| bound: float32 with the sums in another order; outputs
# are convex combinations of v rows (|v| ~ 4 at most), ~1e-6 rounding
KERNEL_ATOL = 1e-5
# served logits against the plain CPU path (blockwise attention, CPU
# matmuls): two 128-wide layers summed in other orders, as the CPU tests
SERVE_ATOL = 1e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# the kernels' route: TF32 tensor cores (495 TFLOP/s dense), three TF32
# products per float32 product to keep float32 accuracy
TC_3XTF32_FLOPS_PER_S = 495e12 / 3
# |K1 - plain| on params, mu and losses: float32 gradient sums over 500
# rows in another order, five AMSGrad steps of lr = 0.01; nu and nu_max
# (squares of gradients) at a relative 1e-4
TRAIN_ATOL = 1e-5
TRAIN_NU_RTOL = 1e-4
REF_RUN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                       "sea-fnn-softcluster-H_A_C_1_10_0-s0", "metrics.jsonl")
# that run's final Test/Acc per step, as committed
REF_ACCS = (0.859, 0.8566, 0.8718, 0.8478, 0.8548, 0.8702, 0.8646, 0.87,
            0.8632, 0.8626)
STEP_ACC_TOL = 0.04
MEAN_ACC_TOL = 0.015
# train_algos: (algo, arg, expected path, committed SEA run, that run's
# final Test/Acc per step as committed); each run has R = 200, T = 10 and a
# final eval at round 199 of every step
ALGO_RUNS = (
    ("softcluster", "cfl_0.1_win-1", "per_round",
     "sea-fnn-softcluster-cfl_0.1_win-1-s0",
     (0.8636, 0.8596, 0.8604, 0.8536, 0.8584, 0.8674, 0.8548, 0.865, 0.8622,
      0.863)),
    ("softclusterwin-1", "hard", "fused", "sea-fnn-softclusterwin-1-hard-s0",
     (0.8702, 0.8672, 0.8668, 0.8558, 0.8572, 0.864, 0.864, 0.8692, 0.8632,
      0.8608)),
    ("win-1", "H_A_C_1_10_0", "fused", "sea-fnn-win-1-H_A_C_1_10_0-s0",
     (0.8594, 0.8654, 0.871, 0.8576, 0.8564, 0.8642, 0.863, 0.8678, 0.8626,
      0.8588)),
    ("oblivious", "H_A_C_1_10_0", "fused",
     "sea-fnn-oblivious-H_A_C_1_10_0-s0",
     (0.8594, 0.8622, 0.871, 0.8494, 0.8572, 0.8704, 0.867, 0.8694, 0.863,
      0.8642)),
    ("exp", "H_A_C_1_10_0", "fused", "sea-fnn-exp-H_A_C_1_10_0-s0",
     (0.8594, 0.8624, 0.8736, 0.8546, 0.8548, 0.867, 0.8668, 0.8678, 0.864,
      0.862)),
    ("lin", "H_A_C_1_10_0", "fused", "sea-fnn-lin-H_A_C_1_10_0-s0",
     (0.8594, 0.8624, 0.8736, 0.854, 0.8552, 0.8678, 0.866, 0.867, 0.8634,
      0.8628)),
    # the rest of the paper's table (statebased.py, ensembles.py)
    ("driftsurf", "H_A_C_1_10_0", "fused", "sea-fnn-driftsurf-H_A_C_1_10_0-s0",
     (0.859, 0.8566, 0.8718, 0.8478, 0.8548, 0.8578, 0.8646, 0.87, 0.8632,
      0.8626)),
    ("mmacc", "mmacc_06", "fused", "sea-fnn-mmacc-mmacc_06-s0",
     (0.859, 0.8566, 0.8758, 0.8716, 0.861, 0.8786, 0.8672, 0.887, 0.8874,
      0.883)),
    ("mmgeni", "H_A_C_1_10_0", "fused", "sea-fnn-mmgeni-H_A_C_1_10_0-s0",
     (0.859, 0.8646, 0.875, 0.8726, 0.8556, 0.8764, 0.8732, 0.8848, 0.8858,
      0.887)),
    ("ada", "win-1_iter", "per_round", "sea-fnn-ada-win-1_iter-s0",
     (0.8594, 0.8652, 0.8696, 0.8576, 0.8556, 0.8634, 0.8656, 0.8674, 0.8604,
      0.8644)),
    ("clusterfl", "H_A_C_1_10_0", "per_round",
     "sea-fnn-clusterfl-H_A_C_1_10_0-s0",
     (0.859, 0.867, 0.8632, 0.8572, 0.8596, 0.855, 0.8484, 0.865, 0.8486,
      0.8596)),
    ("aue", "H_A_C_1_10_0", "per_round", "sea-fnn-aue-H_A_C_1_10_0-s0",
     (0.859, 0.867, 0.8712, 0.8536, 0.855, 0.8624, 0.8574, 0.8672, 0.8592,
      0.8602)),
    ("auepc", "H_A_C_1_10_0", "per_round", "sea-fnn-auepc-H_A_C_1_10_0-s0",
     (0.859, 0.867, 0.8712, 0.8536, 0.855, 0.8624, 0.8574, 0.8672, 0.8592,
      0.8602)),
    ("kue", "H_A_C_1_10_0", "per_round", "sea-fnn-kue-H_A_C_1_10_0-s0",
     (0.85, 0.8414, 0.8414, 0.8344, 0.8524, 0.8654, 0.8538, 0.8684, 0.8578,
      0.8606)))
# The CFL run starts from the reference's own initial params for seed 0 (the
# fnn 3 -> 10 -> 2 that feddrift_tpu's ModelPool.create draws with seed 42,
# in every slot and as the reinit target; biases zero), so that its splits
# can be held to the reference's: which clients split off, and when, turns
# on the init. tests/test_torch_cfl.py checks these numbers against the
# reference's pool.
CFL_REFERENCE_INIT = {
    "Dense_0/kernel": (
        (-0.3013927936553955, -0.7337485551834106, 0.735293447971344,
         1.1579012870788574, -0.9330488443374634, -0.47260305285453796,
         -0.5756090879440308, -0.6413235664367676, -0.13448485732078552,
         -0.32538720965385437),
        (0.5787304043769836, 0.09523212909698486, -0.6297964453697205,
         0.017802000045776367, 0.0036465830635279417, -0.5373333096504211,
         -0.19254755973815918, -0.6379693150520325, -0.6390431523323059,
         0.54328852891922),
        (-0.7591025233268738, 0.48755326867103577, 1.1067979335784912,
         0.2585987150669098, 0.252706378698349, 0.4743505120277405,
         -0.8023117780685425, 0.0012960204621776938, -0.15250730514526367,
         -0.17975205183029175)),
    "Dense_0/bias": (0.0,) * 10,
    "Dense_1/kernel": (
        (0.7070286273956299, 0.46985214948654175),
        (0.4172981083393097, -0.14754554629325867),
        (0.1774415671825409, -0.26158806681632996),
        (-0.26701608300209045, -0.08199362456798553),
        (-0.4387688636779785, -0.42183682322502136),
        (0.35413286089897156, -0.18944045901298523),
        (0.0019123121164739132, -0.6498702168464661),
        (-0.42706796526908875, 0.5786910057067871),
        (-0.3704472780227661, -0.2757079005241394),
        (-0.49893784523010254, -0.24591310322284698)),
    "Dense_1/bias": (0.0, 0.0)}
# what the reference does from that init on the CPU (tests/test_torch_cfl.py
# runs both packages and holds them to these): its first split, as (round,
# model split, new model, clients kept, clients moved), and each client's
# model (Plurality/CL-c) at the final eval of every step. The committed run
# makes the same first split; from step 1 on it, and the port on the card,
# split other clients at other times, as rounding steers CFL's later
# decisions (PERF.md), so the card is held to step 0 and the rest printed
CFL_FIRST_SPLIT = (44, 0, 1, [0, 2, 6, 7], [1, 3, 4, 5, 8, 9])
SPLIT_KEYS = ("round", "model", "new_model", "clients_kept", "clients_moved")
CFL_ASSIGNMENT = ((0, 1, 0, 1, 1, 1, 0, 0, 1, 1),) + (
    (0, 1, 0, 2, 2, 2, 0, 0, 1, 1),) * 9
# train_per_round_kinds: (algo, arg, expected path) at T = 3, R = 20
PER_ROUND_KINDS = (("softcluster", "hard-r", "per_round"),
                   ("softcluster", "mmacc_06", "fused"),
                   ("softcluster", "softmax_3", "fused"),
                   ("softcluster", "geni", "fused"),
                   ("softclusterreset", "softmax_3", "fused"))
# train_mnist: MNIST-4 (the paper's fourth dataset, the synthetic prototype
# images, F = 784, K = 10) at full width with the fnn 784 -> 10 -> 10 (K1's
# and K3's wide kernels, K2's fedavg.cu), against its committed runs: (algo,
# arg, pool size, steps T driven, committed run, that run's final Test/Acc
# per step as committed, step tolerance or None, tolerance of the mean over
# the T steps driven). All five run their 10 steps: K1's wide kernel takes
# well under a millisecond a launch on the card, where the general kernel
# took ~21 ms (~215 s of K1 for the five at T = 10).
# Every run starts from the reference's own initial params for seed 0 (the
# fnn 784 -> 10 -> 10 that feddrift_tpu's ModelPool.create draws with seed
# 42, in every slot and as the reinit target; MNIST_REFERENCE_INIT, packed
# in param_specs order; tests/test_torch_smoke_helpers.py checks it against
# the reference's pool): with 10 hidden units, which of them an init leaves
# dead on MNIST-4 sets the accuracy a run reaches (the port's own init put
# win-1 0.0112 below the committed run at step 0 and 0.041 above it at step
# 3 on the card, PERF.md), so the runs compare the port's training, not
# two draws of the init.
MNIST_REFERENCE_INIT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "data",
    "mnist_fnn_reference_init_s0.npy")
# Tolerances, fixed before the first card run of these runs:
# - win-1 and oblivious make no clustering decision: each step within
#   STEP_ACC_TOL, the mean within MEAN_ACC_TOL, as the SEA runs;
# - the canonical H_A_C_1_10_0: the mean within 0.03 (the JAX package's own
#   run of it on a CPU, seed 0, differs from the committed one by up to
#   0.0198 a step and 0.0036 on the mean);
# - H_A_F_1_3_0 and mmacc_06 turn on noise-driven spawns: the mean of the
#   10 steps within the larger of 0.03 and the largest |mean(seed s) -
#   mean(committed seed 0)| over the JAX package's CPU runs at seeds 1 and
#   2 (scripts/mnist_seed_runs.py; H_A_F_1_3_0 at its pool of 10: 0.71474
#   and 0.6859 against 0.70822, so 0.02232; mmacc_06: 0.6204 and 0.58262
#   against 0.6065, so 0.02388; both gates are therefore 0.03).
MNIST_RUNS = (
    ("softcluster", "H_A_C_1_10_0", 4, 10,
     "MNIST-fnn-softcluster-H_A_C_1_10_0-s0",
     (0.4528, 0.714, 0.6998, 0.726, 0.7098, 0.7734, 0.7778, 0.8274, 0.8254,
      0.8486), None, 0.03),
    ("win-1", "H_A_C_1_10_0", 4, 10, "MNIST-fnn-win-1-H_A_C_1_10_0-s0",
     (0.4528, 0.7038, 0.66, 0.6666, 0.6972, 0.6982, 0.6898, 0.684, 0.6734,
      0.6844), STEP_ACC_TOL, MEAN_ACC_TOL),
    ("oblivious", "H_A_C_1_10_0", 4, 10,
     "MNIST-fnn-oblivious-H_A_C_1_10_0-s0",
     (0.4528, 0.7412, 0.6964, 0.7326, 0.7336, 0.7652, 0.7594, 0.8, 0.7866,
      0.799), STEP_ACC_TOL, MEAN_ACC_TOL),
    ("softcluster", "H_A_F_1_3_0", 10, 10,
     "MNIST-fnn-softcluster-H_A_F_1_3_0-s0",
     (0.254, 0.6718, 0.6782, 0.7346, 0.7392, 0.7706, 0.7682, 0.8114, 0.82,
      0.8342), None, max(0.03, 0.02232)),
    ("mmacc", "mmacc_06", 4, 10, "MNIST-fnn-mmacc-mmacc_06-s0",
     (0.4528, 0.296, 0.604, 0.2568, 0.6988, 0.7194, 0.7328, 0.7596, 0.7536,
      0.7912), None, max(0.03, 0.02388)))
# a clustering run's step further than this from the committed one prints
# both runs' decisions (models used and each client's model)
DECISION_GAP = 0.10
# train_fmow: FMoW (F 3072 = 32 x 32 x 3, the fnn 3072 -> 10 -> 62, B = N =
# 500) at full width, the four committed runs (C 10, T 10, R 200, S 5, an
# eval every 5, M 4), from the reference's init for seed 0 (the fnn that
# feddrift_tpu's ModelPool.create draws with seed 42, packed in param_specs
# order; tests/test_torch_fmow.py checks it against the reference's pool):
# every committed run sits at 0.0152 after step 0, near chance (1/62), and
# which hidden units an init leaves dead sets what a run reaches.
FMOW_REFERENCE_INIT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "data",
    "fmow_fnn_reference_init_s0.npy")
# femnist-fnn's classes (a K1 case on MNIST-4's images: 784 -> 10 -> 62)
FEMNIST_CLASSES = 62
# The JAX package's own CPU runs of FMOW_RUNS at seed 0, whose init is
# FMOW_REFERENCE_INIT (scripts/mnist_seed_runs.py --dataset fmow --seeds 0):
# the same init, data and draws as the port's runs, so only the order of
# float32 sums differs. Final Test/Acc per step.
FMOW_REFERENCE_ACCS = {
    "softcluster": (0.0164, 0.0164, 0.0164, 0.0236, 0.053, 0.163, 0.1568,
                    0.1632, 0.1564, 0.177),
    "win-1": (0.0164, 0.043, 0.0764, 0.0874, 0.0992, 0.0948, 0.0982, 0.118,
              0.1158, 0.1224),
    "oblivious": (0.0164, 0.0164, 0.0154, 0.014, 0.0152, 0.0164, 0.0134,
                  0.0162, 0.0186, 0.0182),
    "mmacc": (0.0164, 0.0164, 0.0164, 0.0236, 0.053, 0.163, 0.1568, 0.1632,
              0.1564, 0.177)}
# The gates. The committed runs are not reproducible from this init: the
# JAX package's own CPU runs of them from it (FMOW_REFERENCE_ACCS) sit far
# from them (oblivious at chance for 10 steps against a committed mean of
# 0.129, softcluster 0.094 against 0.270), so each run is held, a step and
# on the mean, to the JAX package's run from the same init, where only the
# order of float32 sums differs. fmow's fnn trains only once a rounding
# lets a hidden unit live, so such an order moves a run far: each gate is
# the larger of SEA's STEP_ACC_TOL / MEAN_ACC_TOL and the plain version's
# rounding envelope, the largest distance from FMOW_REFERENCE_ACCS of the
# plain version on the card on the batch rows as drawn and on two row
# permutations within each batch (local_sgd_ref, none of the kernels; the
# plain_envelope of scripts/torch_rounding_spread.py --dataset fmow --runs
# win-1,oblivious,softcluster,mmacc on an NVIDIA H100 80GB HBM3, 700.00 W;
# the means 0.16398 / 0.1641 / 0.07268 for softcluster, 0.07566 / 0.06682
# / 0.07194 for win-1, 0.03444 / 0.03526 / 0.03716 for oblivious, 0.10686
# / 0.14508 / 0.11706 for mmacc_06). A run that stays at chance misses
# every gate but oblivious's, whose reference stays at chance itself.
FMOW_RUNS = (
    ("softcluster", "H_A_C_1_10_0", 4, 10,
     "fmow-fnn-softcluster-H_A_C_1_10_0-s0",
     (0.0152, 0.1342, 0.165, 0.2442, 0.2704, 0.3528, 0.3496, 0.3756, 0.39,
      0.4048), max(STEP_ACC_TOL, 0.1574), max(MEAN_ACC_TOL, 0.06988)),
    ("win-1", "H_A_C_1_10_0", 4, 10, "fmow-fnn-win-1-H_A_C_1_10_0-s0",
     (0.0152, 0.122, 0.0808, 0.0574, 0.0714, 0.1144, 0.1224, 0.1284, 0.131,
      0.109), max(STEP_ACC_TOL, 0.0756), max(MEAN_ACC_TOL, 0.02034)),
    ("oblivious", "H_A_C_1_10_0", 4, 10,
     "fmow-fnn-oblivious-H_A_C_1_10_0-s0",
     (0.0152, 0.1202, 0.0928, 0.115, 0.1352, 0.1518, 0.1566, 0.1666, 0.1626,
      0.174), max(STEP_ACC_TOL, 0.0366), max(MEAN_ACC_TOL, 0.02114)),
    ("mmacc", "mmacc_06", 4, 10, "fmow-fnn-mmacc-mmacc_06-s0",
     (0.0152, 0.1342, 0.0218, 0.1562, 0.1014, 0.1596, 0.2732, 0.319, 0.3176,
      0.3448), max(STEP_ACC_TOL, 0.1596), max(MEAN_ACC_TOL, 0.05086)))
# train_tabular and train_images: the tabular datasets (susy, ro,
# stackoverflow_lr) and the synthetic image datasets femnist and cifar10 at
# full width (C 10, T 10, R 200, S 5, B = N = 500, an eval every 5, M 4),
# each run from the reference's init for seed 0 (the fnn that
# feddrift_tpu's ModelPool.create draws with seed 42, packed in param_specs
# order; tests/test_torch_tabular.py and tests/test_torch_prototype.py
# check each file against the reference's pool). By dataset: the file, the
# input shape, the classes, K1's route and K3's (the wide route's resident
# 32-row tiles, "wide", or its streamed kernel, "stream"; "fused" for both:
# K1's fused kernel with K2 as its epilogue and the evals folded in, K3's
# fused kernel for a step's last eval).
NEW_DATASETS = {
    "susy": ((18,), 2, "fused", "fused"),
    "ro": ((5,), 2, "fused", "fused"),
    "stackoverflow_lr": ((1000,), 50, "split", "wide"),
    "femnist": ((784,), 62, "wide", "wide"),
    "cifar10": ((32, 32, 3), 10, "split", "stream")}


def _reference_init(dataset: str) -> str:
    """The committed reference init of a dataset's fnn for seed 0."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", f"{dataset}_fnn_reference_init_s0.npy")


# The JAX package's own CPU runs of these configurations at seed 0, from
# the same init, data and draws as the port's runs (scripts/mnist_seed_runs.py
# ALGO ARG --dataset D --seeds 0): final Test/Acc per step. susy's three
# runs and stackoverflow_lr's softcluster reproduce their committed runs
# exactly, and are held to those; stackoverflow_lr's win-1 and oblivious do
# not (win-1 differs by up to 0.0132 a step, oblivious by 0.0052), so they
# are held to these series, as ro's, femnist's and cifar10's runs, which
# have no committed fnn run.
NEW_REFERENCE_ACCS = {
    "stackoverflow_lr": {
        "win-1": (0.902, 0.8026, 0.5082, 0.4156, 0.47, 0.4452, 0.4738,
                  0.4848, 0.516, 0.5366),
        "oblivious": (0.902, 0.8026, 0.5082, 0.4122, 0.4104, 0.6068, 0.5118,
                      0.602, 0.5532, 0.6)},
    "ro": {"softcluster": (0.9348, 0.871, 0.7326, 0.9354, 0.7392, 0.8662,
                           0.8006, 0.9342, 0.9992, 0.9988)},
    "femnist": {"softcluster": (0.0176, 0.4348, 0.4732, 0.4998, 0.515,
                                0.5124, 0.5296, 0.5306, 0.53, 0.53)},
    "cifar10": {"softcluster": (0.0948, 0.1018, 0.0972, 0.1002, 0.0982,
                                0.1014, 0.101, 0.0968, 0.1022, 0.0996)}}
# The plain version's rounding envelope on the card around each gate's
# series: the largest distance a step and on the mean of local_sgd_ref's
# runs on the batch rows as drawn and on two row permutations within each
# batch (none of the kernels; the plain_envelope of
# scripts/torch_rounding_spread.py --dataset D --plain_only), measured
# before any kernel's run of these datasets was read. Each gate is the
# larger of SEA's STEP_ACC_TOL / MEAN_ACC_TOL and that envelope.
# (on an NVIDIA H100 80GB HBM3, 700.00 W; (step, mean) by run)
NEW_PLAIN_ENVELOPE = {
    "susy": {"softcluster": (0.0028, 0.0001), "win-1": (0.0182, 0.00776),
             "oblivious": (0.0108, 0.00236)},
    "stackoverflow_lr": {"softcluster": (0.0, 0.0),
                         "win-1": (0.0194, 0.00498),
                         "oblivious": (0.015, 0.0023)},
    "ro": {"softcluster": (0.0006, 0.00006)},
    "femnist": {"softcluster": (0.0106, 0.00156)},
    # cifar10's fnn trains only once a rounding lets a hidden unit live:
    # one of the three plain runs left chance at step 3 and reached 0.622,
    # the JAX package's run and the other two stay at chance, so its gate
    # cannot tell a run at chance from one that learns
    "cifar10": {"softcluster": (0.5224, 0.25098)}}


def _new_gate(dataset: str, algo: str) -> tuple[float, float]:
    """(step, mean) tolerances of a run of ``NEW_DATASETS``."""
    step, mean = NEW_PLAIN_ENVELOPE[dataset][algo]
    return max(STEP_ACC_TOL, step), max(MEAN_ACC_TOL, mean)


# The runs, as MNIST_RUNS: (algo, arg, pool, T, committed run or None,
# its pinned final Test/Acc or None, step tolerance, mean tolerance).
TABULAR_RUNS = {
    "susy": (
        ("softcluster", "H_A_C_1_10_0", 4, 10,
         "susy-fnn-softcluster-H_A_C_1_10_0-s0",
         (0.9382, 0.8966, 0.794, 0.9422, 0.7846, 0.8938, 0.8464, 0.9474,
          0.9966, 0.9968), *_new_gate("susy", "softcluster")),
        ("win-1", "H_A_C_1_10_0", 4, 10, "susy-fnn-win-1-H_A_C_1_10_0-s0",
         (0.9382, 0.8926, 0.7436, 0.7004, 0.7464, 0.718, 0.7414, 0.7432,
          0.7638, 0.7854), *_new_gate("susy", "win-1")),
        ("oblivious", "H_A_C_1_10_0", 4, 10,
         "susy-fnn-oblivious-H_A_C_1_10_0-s0",
         (0.9382, 0.8968, 0.7466, 0.6854, 0.6966, 0.7834, 0.7516, 0.7824,
          0.7636, 0.7876), *_new_gate("susy", "oblivious"))),
    "stackoverflow_lr": (
        ("softcluster", "H_A_C_1_10_0", 4, 10,
         "stackoverflow_lr-fnn-softcluster-H_A_C_1_10_0-s0",
         (0.902, 0.8026, 0.6064, 0.9018, 0.6072, 0.8044, 0.7068, 0.9024,
          1.0, 1.0), *_new_gate("stackoverflow_lr", "softcluster")),
        ("win-1", "H_A_C_1_10_0", 4, 10,
         "stackoverflow_lr-fnn-win-1-H_A_C_1_10_0-s0",
         (0.902, 0.8026, 0.5082, 0.4146, 0.4586, 0.4442, 0.4758, 0.4794,
          0.5122, 0.5498), *_new_gate("stackoverflow_lr", "win-1")),
        ("oblivious", "H_A_C_1_10_0", 4, 10,
         "stackoverflow_lr-fnn-oblivious-H_A_C_1_10_0-s0",
         (0.902, 0.8026, 0.5082, 0.4122, 0.4104, 0.6074, 0.5118, 0.6016,
          0.548, 0.602), *_new_gate("stackoverflow_lr", "oblivious"))),
    "ro": (("softcluster", "H_A_C_1_10_0", 4, 10, None, None,
            *_new_gate("ro", "softcluster")),)}
IMAGE_RUNS = {
    d: (("softcluster", "H_A_C_1_10_0", 4, 10, None, None,
         *_new_gate(d, "softcluster")),) for d in ("femnist", "cifar10")}
# the fnn no K1 layout takes on the card: cifar100's (and fed_cifar100's)
# 3072 -> 10 -> 100, under either optimizer
REFUSED_IMAGE_DATASET = "cifar100"

# train_lr: the lr model and the SGD client optimizer (K1's and K3's lr and
# SGD routes) against the JAX package's own runs of the same configuration
# and seed on a CPU (no committed run uses them): (label, config, that
# run's final Test/Acc per step, initial params or None). MNIST-4 at the
# canonical shape (10 clients, 10 steps of 200 rounds, batch 500), and SEA
# at the JAX package's megastep test base (tests/test_megastep.py), whose
# Test/Acc turns on the init (its sigmoid saturates on SEA's features in
# [0, 10]: the port's own init reaches ~0.63 where the reference's reaches
# 0.383), so it starts from the reference's init for that seed. Each step
# within STEP_ACC_TOL, the mean within MEAN_ACC_TOL, except in a run of
# LR_STEP0_RUNS. The series come from scripts/lr_reference_runs.py.
LR_SEA_REFERENCE_INIT = {
    "Dense_0/kernel": ((-0.9309638738632202, 0.44398048520088196),
                       (-0.8102397918701172, -0.28121232986450195),
                       (0.9874085783958435, -1.0198450088500977)),
    "Dense_0/bias": (0.0, 0.0)}
LR_SEA_BASE = dict(dataset="sea", model="lr", concept_drift_algo="oblivious",
                   concept_drift_algo_arg="", concept_num=1,
                   client_num_in_total=8, client_num_per_round=8,
                   train_iterations=8, comm_round=5, epochs=1, batch_size=50,
                   sample_num=50, frequency_of_the_test=5, lr=0.05, seed=7)
LR_RUNS = (
    ("mnist_lr_adam", dict(dataset="MNIST", model="lr",
                           concept_drift_algo="oblivious",
                           client_optimizer="adam"),
     (0.7764, 0.8062, 0.7662, 0.759, 0.7562, 0.7836, 0.7704, 0.799, 0.7836,
      0.7818), None),
    ("mnist_lr_sgd", dict(dataset="MNIST", model="lr",
                          concept_drift_algo="oblivious",
                          client_optimizer="sgd"),
     (0.5084, 0.6936, 0.7096, 0.7256, 0.7392, 0.7748, 0.7706, 0.8046, 0.792,
      0.7978), None),
    ("sea_lr_sgd", dict(LR_SEA_BASE, client_optimizer="sgd"),
     (0.38, 0.375, 0.3675, 0.385, 0.4075, 0.375, 0.375, 0.4),
     LR_SEA_REFERENCE_INIT),
    ("sea_lr_adam", dict(LR_SEA_BASE, client_optimizer="adam"),
     (0.375, 0.385, 0.365, 0.32, 0.41, 0.355, 0.34, 0.37),
     LR_SEA_REFERENCE_INIT))
# runs held to the reference at step 0 only, whose batches are the whole
# step in both packages, and finite at every step: SEA's lr under AMSGrad
# (the megastep base itself, the general kernel's lr and AMSGrad route).
# From step 1 on, oblivious draws its rows from every earlier step, the
# packages' draws differ, and AMSGrad's normalised steps carry that further
# than SGD's: the port's own CPU run leaves STEP_ACC_TOL at step 3
# (scripts/lr_reference_runs.py --port)
LR_STEP0_RUNS = ("sea_lr_adam",)
# softcluster gmm at the canonical full width (SEA, change points A, 10
# clients, 10 steps x 200 rounds, M = 4), fused: the JAX package's own CPU
# run of it (scripts/gmm_reference_runs.py), its final Test/Acc per step and
# the mean over clients of gmm's weight on model 0 per step
GMM_RUN = {"kw": dict(concept_drift_algo="softcluster",
                      concept_drift_algo_arg="gmm"),
           "test_acc": (0.859, 0.8516, 0.8694, 0.8588, 0.858, 0.88, 0.8686,
                        0.8798, 0.875, 0.8864),
           "model0_weight": (1.0, 0.3984745740890503, 0.700034499168396,
                             0.5, 0.4000000059604645, 0.6051939725875854,
                             0.6000401377677917, 0.6000000238418579,
                             0.4999971389770508, 0.6000000238418579)}

# a real blow-up: the canonical configuration, shortened, at a learning
# rate whose JAX CPU run goes non-finite (scripts/blowup_lr_search.py)
BLOWUP_RUN = dict(train_iterations=4, comm_round=20, lr=1e20)

NUM_REQUESTS = 512
CONCURRENCY = 8
# K1's device time at the canonical shape as recorded for its first design
# (PERF.md's kernel table, NVIDIA H100 80GB HBM3, 700 W), printed beside
# this run's
K1_FIRST_DESIGN_DEVICE_MS = 0.08191
SLICE_SHAPE = (32, 4, 80, 32)  # largest bucket x heads x seq x head dim
# (shape, causal, layout): "qkv" gives q, k, v as the transformer does,
# [B, H, L, D] views split off one [B, L, 3E] projection; "contiguous"
# gives three separate [B, H, L, D] tensors
SHAPES = ((SLICE_SHAPE, True, "qkv"),
          ((8, 4, 80, 32), True, "qkv"),  # the mean served micro-batch
          ((2, 2, 100, 8), False, "contiguous"),
          ((4, 8, 2048, 64), True, "contiguous"),
          ((1, 2, 8192, 64), True, "contiguous"))   # the error at long L
# the served transformer's Dense layers: (layer, L, in, out, bias); the
# lm_head sees the last position only
DENSE_SHAPES = (("qkv", 80, 128, 384, False), ("proj", 80, 128, 128, False),
                ("Dense_0", 80, 128, 512, True),
                ("Dense_1", 80, 512, 128, True),
                ("lm_head", 1, 128, 90, True))
DENSE_BATCHES = (32, 8)        # the largest bucket and the mean micro-batch
DENSE_ENTRY = ("Dense_0", 32)  # the kernels line's representative call
# launches of each Dense layer in one forward of the 2-block transformer
DENSE_PER_FORWARD = {"qkv": 2, "proj": 2, "Dense_0": 2, "Dense_1": 2,
                     "lm_head": 1}
# dense_rows's device ms per layer and batch as recorded for its first
# design (SIMT float32; PERF.md's kernel table, NVIDIA H100 80GB HBM3,
# 700 W), printed beside this run's as pr4_device_ms
DENSE_FIRST_DESIGN_DEVICE_MS = {
    32: {"qkv": 0.02168, "proj": 0.01561, "Dense_0": 0.02700,
         "Dense_1": 0.05562, "lm_head": 0.01023},
    8: {"qkv": 0.01372, "proj": 0.01344, "Dense_0": 0.01614,
        "Dense_1": 0.04987, "lm_head": 0.00997}}


def _say(phase: str, **fields) -> None:
    print(f"{phase}: " + json.dumps(fields, default=str), flush=True)


def _time_ms(fn, iters: int = 50) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _profile(fn, reps: int, union: bool = False):
    """Run ``fn`` ``reps`` times under torch.profiler; returns the CUDA
    kernels it launched (FunctionEventAvg, device time > 0) and the wall
    microseconds of the run; with ``union``, also the microseconds the card
    was busy: the union of the kernels' device intervals (the sum of their
    times counts kernels that overlap twice)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not union:
        return kernels, wall_us
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return kernels, wall_us, busy


def _device_ms(fn, reps: int = 20):
    """Device time per call of ``fn``: the summed duration of the CUDA
    kernels it launches, free of host launch gaps. None when the profiler
    records no device time."""
    kernels, _ = _profile(fn, reps)
    busy_us = sum(e.self_device_time_total for e in kernels)
    return busy_us / reps / 1e3 if busy_us > 0 else None


def _interleaved(measure, calls: dict, rounds: int = 5) -> dict:
    """``measure(fn)`` of each call, in turns for ``rounds`` rounds; the
    median of each (of the rounds that measured one; None if none did).
    Host-side times drift within a run on a shared host, so the calls
    compared are measured side by side."""
    import statistics
    got = {name: [] for name in calls}
    for _ in range(rounds):
        for name, fn in calls.items():
            got[name].append(measure(fn))
    return {name: statistics.median([x for x in v if x is not None])
            if any(x is not None for x in v) else None
            for name, v in got.items()}


def _host_enqueue_ms(fn, iters: int = 200) -> float:
    """Host time per call to enqueue ``fn``, without waiting for the card
    (the queue is drained before and after)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def _bound(nbytes: float, flops: float,
           flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time for a function on the card: the larger of its bytes over
    the memory rate and its operations over ``flops_per_s`` (float32
    outside the tensor cores by default), in ms, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops \
        else (t_ops * 1e3, "operations")


def _attention_bound_ms(shape, causal: bool,
                        flops_per_s: float) -> tuple[float, str]:
    """Least time for the function on the card: q, k, v read once and out
    written once over HBM, against the multiply-adds of the (q, k) pairs the
    mask keeps (q.k and p.v, 2 flops each per dim) at ``flops_per_s``."""
    B, H, L, D = shape
    pairs = L * (L + 1) // 2 if causal else L * L
    return _bound(4 * B * H * L * D * 4, 4 * B * H * pairs * D, flops_per_s)


def phase_device() -> str:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False    # Dense bmm stays f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    _say("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=False, nvidia_smi=card)
    return card


def _ptxas_per_kernel(log: str) -> dict:
    """ptxas' registers and spills for each compiled kernel, keyed by the
    kernel's name and its int and bool template arguments
    (``flash_fwd_kernel<32>``, ``dense_rows_mma_kernel<64,1>``)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)(I(?:L[ib]\d+E)+E)?",
                          m.group(1))
            ints = re.findall(r"L[ib](\d+)E", k.group(2) or "") if k else []
            name = (k.group(1) + (f"<{','.join(ints)}>" if ints else "")) \
                if k else m.group(1)
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def _sass_count(lib_path: str, opcode: str):
    """Count of ``opcode`` instructions in a library's SASS, or "not
    measured" where the toolkit has no ``cuobjdump``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        return "not measured"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120)
    if sass.returncode != 0:
        return f"not measured (cuobjdump: {sass.stderr.strip()[:200]})"
    return sum(1 for ln in sass.stdout.splitlines()
               if re.search(rf"\b{opcode}\b", ln))


def phase_build() -> None:
    from feddrift_torch.kernels import build
    build.build_all()
    ptxas = {src: _ptxas_per_kernel(log)
             for src, log in sorted(build.build_log.items())}
    _say("build", seconds=round(build.build_seconds, 3),
         sources=sorted(build.build_log), ptxas=ptxas,
         flash_sass_hmma=_sass_count(build.lib_path("flash_attn_fwd.cu"),
                                     "HMMA"),
         dense_sass_hmma=_sass_count(build.lib_path("dense_rows.cu"),
                                     "HMMA"))


def phase_kernel() -> dict:
    import torch
    import torch.nn.functional as F
    from feddrift_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(0)
    entry = None
    for shape, causal, layout in SHAPES:
        B, H, L, D = shape
        if layout == "qkv":
            qkv = torch.randn((B, L, 3 * H * D), generator=gen, device="cuda")
            q, k, v = (t.view(B, L, H, D).transpose(1, 2)
                       for t in qkv.split(H * D, dim=-1))
        else:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       for _ in range(3))
        out = flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        err = (out - flash_attention_ref(q, k, v, causal)).abs().max().item()
        calls = {
            "kernel": lambda: flash_attention(q, k, v, causal),
            "plain": lambda: flash_attention_ref(q, k, v, causal),
            "library": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)}
        ms, plain_ms, library_ms = _interleaved(_time_ms, calls).values()
        device = {name: _device_ms(f) for name, f in calls.items()}
        # the host's floor: one PyTorch elementwise op on the same card
        enqueue = _interleaved(_host_enqueue_ms, {
            "kernel": calls["kernel"], "library": calls["library"],
            "one_op": lambda: torch.add(q, 1.0)})
        bound_ms, bound_by = _attention_bound_ms(shape, causal,
                                                 TC_3XTF32_FLOPS_PER_S)
        simt_ms, simt_by = _attention_bound_ms(shape, causal,
                                               F32_FLOPS_PER_S)
        device_vs_library = device["kernel"] / device["library"] \
            if device["kernel"] and device["library"] else "not measured"
        _say("kernel", name="flash_attn_fwd", shape=shape, causal=causal,
             layout=layout, max_abs_err=err, atol=KERNEL_ATOL, kernel_ms=ms,
             plain_ms=plain_ms, library_ms=library_ms,
             call_vs_library=ms / library_ms,
             device_vs_library=device_vs_library, bound_ms=bound_ms,
             bound_by=bound_by, bound_f32_simt_ms=simt_ms,
             bound_f32_simt_by=simt_by, kernel_device_ms=device["kernel"],
             plain_device_ms=device["plain"],
             library_device_ms=device["library"],
             kernel_enqueue_ms=enqueue["kernel"],
             library_enqueue_ms=enqueue["library"],
             one_op_enqueue_ms=enqueue["one_op"])
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"flash_attn_fwd at {shape} causal={causal}: "
                                 f"max |kernel - plain| {err} > {KERNEL_ATOL}")
        if shape == SLICE_SHAPE:
            entry = {"name": "flash_attn_fwd", "route": "cuda",
                     "source": "feddrift_torch/kernels/csrc/flash_attn_fwd.cu",
                     "replaces": "feddrift_tpu/parallel/pallas_attention.py:111",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "device_ms": device["kernel"],
                     "bound_f32_simt_ms": simt_ms}
    return entry


def _dense_bound_ms(B: int, L: int, n_in: int, n_out: int, bias: bool,
                    flops_per_s: float = TC_3XTF32_FLOPS_PER_S
                    ) -> tuple[float, str]:
    """Least time for one per-row Dense on the card: x, the per-row weights
    (and bias) read once and y written once over HBM, against its
    multiply-adds (and bias adds) at ``flops_per_s``. The default is the
    fastest float32-accurate route the card offers, 3xTF32 on the tensor
    cores; ``F32_FLOPS_PER_S`` gives the SIMT figure."""
    nbytes = 4 * (B * L * n_in + B * n_in * n_out + B * L * n_out
                  + (B * n_out if bias else 0))
    flops = 2 * B * L * n_in * n_out + (B * L * n_out if bias else 0)
    return _bound(nbytes, flops, flops_per_s)


def phase_dense() -> dict:
    """The per-row Dense kernel at the served transformer's Dense shapes:
    error against its plain version, its first and last rows bitwise equal
    to their b1 calls, and its times beside torch.bmm's (baddbmm's with a
    bias), its first design's recorded time and the bound; then the Dense
    work of one forward at each batch."""
    import torch
    from feddrift_torch.kernels.dense_rows import (_launch_config,
                                                   dense_rows, dense_rows_ref)
    gen = torch.Generator(device="cuda").manual_seed(1)
    entry = None
    for B in DENSE_BATCHES:
        forward = {"kernel": 0.0, "library": 0.0, "first": 0.0,
                   "bound": 0.0, "simt": 0.0}
        for layer, L, n_in, n_out, has_bias in DENSE_SHAPES:
            x = torch.randn((B, L, n_in), generator=gen, device="cuda")
            w = torch.randn((B, n_in, n_out), generator=gen,
                            device="cuda") / n_in ** 0.5
            b = torch.randn((B, n_out), generator=gen, device="cuda") * 0.1 \
                if has_bias else None
            out = dense_rows(x, w, b)
            ones = [dense_rows(x[r:r + 1], w[r:r + 1],
                               None if b is None else b[r:r + 1])
                    for r in (0, B - 1)]
            torch.cuda.synchronize()
            plain = dense_rows_ref(x, w, b)
            err = (out - plain).abs().max().item()
            # both against the exact product (float64): the kernel's own
            # error apart from the plain version's rounding
            exact = dense_rows_ref(x.double(), w.double(),
                                   None if b is None else b.double())
            err64 = (out - exact).abs().max().item()
            plain_err64 = (plain - exact).abs().max().item()
            row_bitwise = bool(torch.equal(ones[0][0], out[0])
                               and torch.equal(ones[1][0], out[B - 1]))
            library = (lambda: torch.baddbmm(b[:, None, :], x, w)) \
                if has_bias else (lambda: torch.bmm(x, w))
            calls = {"kernel": lambda: dense_rows(x, w, b),
                     "plain": lambda: dense_rows_ref(x, w, b),
                     "library": library}
            ms, plain_ms, library_ms = _interleaved(_time_ms, calls).values()
            device = {name: _device_ms(f) for name, f in calls.items()}
            enqueue = _interleaved(_host_enqueue_ms, {
                "kernel": calls["kernel"], "library": library})
            bound_ms, bound_by = _dense_bound_ms(B, L, n_in, n_out, has_bias)
            simt_ms, simt_by = _dense_bound_ms(B, L, n_in, n_out, has_bias,
                                               F32_FLOPS_PER_S)
            first_ms = DENSE_FIRST_DESIGN_DEVICE_MS[B][layer]
            cfg = _launch_config(L, n_in, n_out)
            _say("kernel", name="dense_rows", layer=layer,
                 shape=(B, L, n_in, n_out), bias=has_bias, route=cfg.route,
                 tile=(cfg.tile_l, cfg.tile_out), warps=cfg.warps,
                 max_abs_err=err, atol=KERNEL_ATOL,
                 max_abs_err_vs_f64=err64,
                 plain_max_abs_err_vs_f64=plain_err64,
                 row_bitwise=row_bitwise,
                 kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 library="torch.baddbmm" if has_bias else "torch.bmm",
                 kernel_device_ms=device["kernel"],
                 plain_device_ms=device["plain"],
                 library_device_ms=device["library"],
                 device_vs_library=device["kernel"] / device["library"]
                 if device["kernel"] and device["library"]
                 else "not measured",
                 pr4_device_ms=first_ms,
                 kernel_enqueue_ms=enqueue["kernel"],
                 library_enqueue_ms=enqueue["library"], bound_ms=bound_ms,
                 bound_by=bound_by, bound_f32_simt_ms=simt_ms,
                 bound_f32_simt_by=simt_by,
                 device_vs_bound=(device["kernel"] or ms) / bound_ms)
            if not (err <= KERNEL_ATOL and row_bitwise):
                raise AssertionError(f"dense_rows {layer} at b{B}: max "
                                     f"|kernel - plain| {err} (atol "
                                     f"{KERNEL_ATOL}), row bitwise "
                                     f"{row_bitwise}")
            n = DENSE_PER_FORWARD[layer]
            forward["kernel"] += n * (device["kernel"] or float("nan"))
            forward["library"] += n * (device["library"] or float("nan"))
            forward["first"] += n * first_ms
            forward["bound"] += n * bound_ms
            forward["simt"] += n * simt_ms
            if (layer, B) == DENSE_ENTRY:
                entry = {"name": "dense_rows", "route": "cuda",
                         "source": "feddrift_torch/kernels/csrc/dense_rows.cu",
                         "replaces": "feddrift_tpu/models/transformer.py:77",
                         "launches": None, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": library_ms,
                         "device_ms": device["kernel"],
                         "bound_f32_simt_ms": simt_ms,
                         "shape": (B, L, n_in, n_out)}
        _say("dense_forward", batch=B,
             launches=sum(DENSE_PER_FORWARD.values()),
             kernel_device_ms=forward["kernel"],
             library_device_ms=forward["library"],
             pr4_device_ms=forward["first"], bound_ms=forward["bound"],
             bound_f32_simt_ms=forward["simt"],
             device_vs_library=forward["kernel"] / forward["library"],
             device_vs_bound=forward["kernel"] / forward["bound"])
    return entry


def phase_serve(entry: dict, dense_entry: dict) -> None:
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.core.pool import ModelPool
    from feddrift_torch.data.registry import make_dataset
    from feddrift_torch.kernels.dense_rows import dense_rows
    from feddrift_torch.kernels.flash_attention import flash_attention
    from feddrift_torch.models import create_model
    from feddrift_torch.models.transformer import TransformerLM
    from feddrift_torch.platform.serving import (SERVE_BUCKETS,
                                                 InferenceEngine,
                                                 RoutingTable,
                                                 TrafficGenerator)

    cfg = ExperimentConfig(dataset="shakespeare", model="transformer")
    t0 = time.perf_counter()
    ds = make_dataset(cfg)
    data_s = time.perf_counter() - t0
    model = create_model(cfg.model, ds, cfg)
    pool = ModelPool.create(model, torch.from_numpy(ds.x[0, 0, :2]),
                            cfg.num_models, seed=cfg.seed, identical=False,
                            device="cuda")
    assignment = np.arange(cfg.client_num_in_total) % cfg.num_models
    engine = InferenceEngine(pool, RoutingTable.from_assignment(assignment),
                             buckets=SERVE_BUCKETS)
    windows = ds.x.reshape(-1, ds.x.shape[-1])
    try:
        t0 = time.perf_counter()
        engine.warmup()
        warmup_s = time.perf_counter() - t0
        engine.start()
        batches0 = engine.stats()["batches"]

        flash_attention.launches = 0
        dense_rows.launches = 0
        traffic = TrafficGenerator(
            engine, range(cfg.client_num_in_total), seed=cfg.seed,
            concurrency=CONCURRENCY,
            make_x=lambda rng: windows[rng.randint(len(windows))]
        ).run(NUM_REQUESTS)
        launches = flash_attention.launches
        dense_launches = dense_rows.launches

        stats = engine.stats()
        batches = stats["batches"] - batches0
        layers = len(model.blocks)
        _say("serve", dataset=cfg.dataset, x_shape=ds.x.shape,
             data_s=data_s, model=cfg.model, d_model=model.d_model,
             heads=model.num_heads, layers=layers,
             vocab=model.vocab_size, pool=cfg.num_models,
             warmup_s=warmup_s, flash_launches=launches,
             dense_rows_launches=dense_launches, micro_batches=batches,
             mean_batch=stats["served"] / max(stats["batches"], 1),
             **traffic, engine=stats)
        entry["launches"] = launches
        dense_entry["launches"] = dense_launches
        if traffic["errors"] or traffic["completed"] != NUM_REQUESTS:
            raise AssertionError(f"serving failed: {traffic}")
        if launches <= 0 or launches != layers * batches:
            raise AssertionError(f"flash launches {launches} for {batches} "
                                 f"micro-batches of {layers} layers")
        # four Dense layers a block and the lm_head
        if dense_launches <= 0 or dense_launches != (4 * layers + 1) * batches:
            raise AssertionError(f"dense_rows launches {dense_launches} for "
                                 f"{batches} micro-batches of {layers} "
                                 f"layers")

        # served answers, coalesced into mixed-model micro-batches, against
        # one-row forwards of the same request and against the plain path
        rng = np.random.RandomState(1)
        clients = rng.randint(cfg.client_num_in_total, size=48)
        xs = windows[rng.randint(len(windows), size=48)]
        with ThreadPoolExecutor(max_workers=48) as ex:
            results = list(ex.map(engine.submit, clients, xs))
        gen = engine._gen
        rows = []
        for r, x in zip(results, xs):
            one = engine.step.forward(
                gen.params, torch.from_numpy(x[None]).cuda(),
                torch.tensor([r.model], device="cuda"))
            rows.append(one[0].cpu().numpy())
        rows = np.stack(rows)
        served = np.stack([r.logits for r in results])
        one_row_err = float(np.abs(served - rows).max())
        cpu_model = TransformerLM(
            vocab_size=model.vocab_size, d_model=model.d_model,
            num_heads=model.num_heads, num_layers=len(model.blocks),
            max_len=model.max_len, attention_impl="blockwise")
        cpu_params = {k: p.cpu() for k, p in gen.params.items()}
        with torch.no_grad():
            plain = cpu_model(
                {k: p[torch.tensor([r.model for r in results])]
                 for k, p in cpu_params.items()}, torch.from_numpy(xs)
            ).numpy()
        plain_err = float(np.abs(served - plain).max())
        one_row_bitwise = bool(np.array_equal(served, rows))
        _say("serve_check", requests=len(results),
             models=sorted({r.model for r in results}),
             finite=bool(np.isfinite(served).all()),
             one_row_bitwise=one_row_bitwise,
             one_row_max_abs_err=one_row_err,
             plain_cpu_max_abs_err=plain_err, atol=SERVE_ATOL)
        if not (np.isfinite(served).all() and served.shape == (48, 90)):
            raise AssertionError("served logits not finite [48, 90]")
        if not (one_row_bitwise and plain_err <= SERVE_ATOL):
            raise AssertionError("served answers differ from the one-row "
                                 "forward (bitwise) or the plain CPU path")

        first = _batch_variance(engine.step, gen.params, windows,
                                cfg.num_models)
        if first is not None:
            raise AssertionError(f"row 0's answer depends on its batch from "
                                 f"op {first} on")

        # device time of one micro-batch forward per bucket (CUDA events)
        fwd = {}
        for b in SERVE_BUCKETS:
            x = torch.from_numpy(windows[:b].copy()).cuda()
            midx = torch.arange(b, device="cuda") % cfg.num_models
            fwd[b] = _time_ms(lambda: engine.step.forward(gen.params, x,
                                                          midx), iters=20)
        _say("serve_forward_ms", **{f"b{b}": t for b, t in fwd.items()})
        _profile_forward(engine.step, gen.params, x, midx)
    finally:
        engine.close()


def _batch_variance(step, params, windows, num_models: int):
    """One serving forward of the same row alone (b1) and first in a batch
    of 32, every op's output recorded: the max difference of that row per
    op, and the first op whose row differs bitwise (returned; None when
    every op agrees)."""
    import torch
    from feddrift_torch.models import transformer
    from feddrift_torch.obs.optrace import first_difference, record_calls
    x = torch.from_numpy(windows[:32].copy()).cuda()
    midx = torch.arange(32, device="cuda") % num_models
    ops = ("embed", "layer_norm", "dense", "flash_attention")
    with record_calls(transformer, ops) as one:
        step.forward(params, x[:1], midx[:1])
    with record_calls(transformer, ops) as many:
        step.forward(params, x, midx)
    torch.cuda.synchronize()
    diffs, first = first_difference(one, many)
    _say("serve_check", what="batch_variance", row=0, batches=(1, 32),
         first_op_that_differs=first, max_abs_diff_per_op=dict(diffs))
    return first


def _profile_forward(step, params, x, midx, reps: int = 10) -> None:
    """Where one micro-batch forward's time goes: the device-busy share of
    its wall time (profiler on) and the kernels that take it."""
    kernels, wall_us = _profile(lambda: step.forward(params, x, midx), reps)
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    _say("serve_profile", batch=x.shape[0],
         wall_ms_per_forward=wall_us / reps / 1e3,
         device_busy_ms_per_forward=busy_us / reps / 1e3,
         device_busy_share=busy_us / wall_us if busy_us else "not measured",
         kernel_launches_per_forward=sum(e.count for e in kernels) / reps,
         top_kernels_us_per_forward={
             e.key[:60]: e.self_device_time_total / reps for e in top})


def _train_case(dataset: str, seed: int, hidden: int = 10,
                model: str = "fnn", optimizer: str = "adam",
                models: int = 4, batch: int | None = None):
    """One canonical round's K1 inputs on the card: the dataset at its
    registry defaults (the fnn's hidden width ``hidden``, or the lr), a
    pool of ``models`` distinct draws, fresh optimizer state, seeded time
    weights with pair (0, 3) inactive and, with four models or more, pair
    (2, 7) and all of model 3 too, and
    seeded batch indices (of ``batch`` rows where given, else the
    registry's batch size). x is laid out ``[C, T1, N, F]`` (images
    flattened over H, W, C, as the fnn flattens them). ``"femnist"``:
    femnist-fnn's shape (784 -> 10 -> 62) on MNIST-4's images with labels
    drawn over the 62 classes (the case's inputs as before femnist's own
    data was ported, so that trees compare on the same inputs)."""
    import numpy as np
    import torch
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.data.registry import make_dataset
    from feddrift_torch.kernels.local_sgd import init_opt_state
    from feddrift_torch.models import create_model
    femnist = dataset == "femnist"
    cfg = ExperimentConfig(dataset="MNIST" if femnist else dataset,
                           change_points="A" if dataset in (
                               "sea", "MNIST", "fmow", "femnist",
                               *NEW_DATASETS) else "W",
                           fnn_hidden_dim=hidden, model=model,
                           client_optimizer=optimizer, concept_num=models)
    ds = make_dataset(cfg)
    if femnist:
        ds.num_classes = FEMNIST_CLASSES
        ds.y = np.random.default_rng(seed).integers(
            0, FEMNIST_CLASSES, ds.y.shape).astype(np.int32)
    mod = create_model(model, ds, cfg)
    gen = torch.Generator().manual_seed(seed)
    M, (C, T1, N), F = cfg.num_models, ds.x.shape[:3], mod.in_dim
    params = torch.stack([mod.pack(mod.init_params(gen, "cuda"))
                          for _ in range(M)])
    rng = np.random.default_rng(seed)
    tw = (rng.random((M, C, T1)) < 0.5).astype(np.float32)
    tw[:, :, -1] = 0
    tw[0, 3] = 0
    if M > 3:
        tw[2, 7] = tw[3] = 0
    S, B = cfg.epochs, min(batch or cfg.batch_size, N)
    t_idx = rng.integers(0, T1 - 1, (M, C, S)).astype(np.int32)
    slot = rng.integers(0, N // B, (M, C, S)).astype(np.int32)
    dev = lambda a: torch.from_numpy(a).cuda()
    args = (dev(ds.x.reshape(C, T1, N, F)), dev(ds.y), params,
            init_opt_state(M, C, mod.num_params, "cuda", optimizer),
            dev(t_idx), dev(slot), dev(tw.sum(-1)))
    kw = dict(hidden=mod.hidden_dim, batch_size=B, lr=cfg.lr, wd=cfg.wd)
    return args, kw, dict(M=M, C=C, S=S, B=B, F=F, H=mod.hidden_dim,
                          K=mod.num_classes), tw


def _local_sgd_bound_ms(rows, total_w, M: int, C: int, S: int, B: int,
                        F: int, H: int, K: int, index_bytes: int,
                        aggregate: bool = False,
                        sgd: bool = False) -> tuple[float, str]:
    """Least time for one K1 call on the card, counting the active pairs'
    work. Bytes: each distinct row (client, row of its T1·N) that an active
    pair's batches ``rows [M, C, S, B]`` read, read once (x and label), the
    pool read once, the active pairs' optimizer state read and written
    (none under ``sgd``), the client params, n and loss written, the batch
    indices (``index_bytes``) and the weights read; with a feature mask,
    that too. Operations: the float32 work of the active pairs' forward,
    backward and AMSGrad (or SGD) steps, of the fnn or, with ``H = 0``, of
    the lr (its sigmoid, softmax and their derivatives ~14 a class). With
    ``aggregate`` (K2 as the epilogue) also the aggregated params and stats
    written once and the weighted sum's operations; the client stack it
    reads is already counted as written."""
    import torch
    P = F * H + H + H * K + K if H else F * K + K
    act = total_w > 0                                            # [M, C]
    client = torch.arange(C, device=rows.device)[None, :, None, None]
    key = (client * (1 << 32) + rows.long()).expand(M, C, S, B)[act]
    distinct = torch.unique(key).numel()
    active = int(act.sum())
    nbytes = (distinct * (4 * F + 4) + M * P * 4
              + (0 if sgd else active * 2 * (3 * P * 4 + 4))
              + M * C * (P * 4 + 8) + index_bytes + M * C * 4)
    row = 4 * F * H + 6 * H * K + 6 * K + 2 * H if H else 4 * F * K + 14 * K
    flops = active * S * (B * row + (3 if sgd else 14) * P)
    if aggregate:
        nbytes += 4 * (M * P + 3 * M)
        flops += 2 * M * C * P + 2 * M * C
    return _bound(nbytes, flops)


# K1's cases: (label, dataset, seed, model, fnn hidden width, optimizer,
# forced route, gathered batches); the registry's widths take the fused
# kernel, H = 32 the general one, and the general one forced at the SEA
# shape is the first design, timed here too. A gathered case trains on rows
# drawn by K4 (the weighted draw, Poisson sample weights) with per-model
# feature masks, as KUE does: the per-thread copy branch of either kernel.
# MNIST's width (F = 784, K = 10) takes the wide kernel: the fnn under
# AMSGrad, contiguous and gathered with masks, the lr under AMSGrad and SGD,
# and the fnn under SGD; the general kernel forced there is the design the
# wide one replaced, timed in the same run. At SEA's F = 3 the general
# kernel keeps its lr route under SGD and AMSGrad and its SGD route of the
# fnn: each of its four instantiations runs here. fmow's width (F = 3072, K =
# 62) takes the split kernel: AMSGrad contiguous and gathered with masks,
# and SGD, AMSGrad at a batch of 32 (K1_BATCH: 2 x tiles a step, fewer
# than its ring's stages) and with one model (K1_MODELS: win-1's and
# oblivious' pool, one pair a client); femnist-fnn's shape (784 -> 10 -> 62) the wide
# kernel's two-classes-a-lane row phase. stackoverflow_lr's fnn (1000 -> 10
# -> 50) under AMSGrad takes the split kernel with its last CTA padded past
# F (contiguous, and gathered with masks), cifar10's (3072 -> 10 -> 10) the
# split kernel at 10 classes. susy's (18 -> 10 -> 2, P 212) and ro's (5 ->
# 10 -> 2, P 82) widths take the fused kernel folding a row's values in
# chunks (contiguous, and gathered with masks), held to the plain version
# as SEA's fused case is; the general kernel forced at each (the design
# the fused route replaced there) is timed in the same run.
K1_CASES = (("sea", "sea", 0, "fnn", 10, "adam", None, False),
            ("sine", "sine", 1, "fnn", 10, "adam", None, False),
            ("sea_general", "sea", 0, "fnn", 10, "adam", "general", False),
            ("h32", "sea", 2, "fnn", 32, "adam", None, False),
            ("sea_gather", "sea", 3, "fnn", 10, "adam", None, True),
            ("sea_gather_general", "sea", 3, "fnn", 10, "adam", "general",
             True),
            ("sea_lr_sgd", "sea", 9, "lr", 10, "sgd", None, False),
            ("sea_lr", "sea", 10, "lr", 10, "adam", None, False),
            ("sea_sgd", "sea", 11, "fnn", 10, "sgd", None, False),
            ("mnist", "MNIST", 4, "fnn", 10, "adam", None, False),
            ("mnist_general", "MNIST", 4, "fnn", 10, "adam", "general",
             False),
            ("mnist_gather", "MNIST", 5, "fnn", 10, "adam", None, True),
            ("mnist_lr", "MNIST", 6, "lr", 10, "adam", None, False),
            ("mnist_lr_sgd", "MNIST", 7, "lr", 10, "sgd", None, False),
            ("mnist_sgd", "MNIST", 8, "fnn", 10, "sgd", None, False),
            ("fmow", "fmow", 12, "fnn", 10, "adam", None, False),
            ("fmow_gather", "fmow", 13, "fnn", 10, "adam", None, True),
            ("fmow_sgd", "fmow", 14, "fnn", 10, "sgd", None, False),
            ("fmow_b32", "fmow", 16, "fnn", 10, "adam", None, False),
            ("fmow_m1", "fmow", 17, "fnn", 10, "adam", None, False),
            ("femnist", "femnist", 15, "fnn", 10, "adam", None, False),
            ("so", "stackoverflow_lr", 18, "fnn", 10, "adam", None, False),
            ("so_gather", "stackoverflow_lr", 19, "fnn", 10, "adam", None,
             True),
            ("susy", "susy", 20, "fnn", 10, "adam", None, False),
            ("susy_gather", "susy", 22, "fnn", 10, "adam", None, True),
            ("susy_general", "susy", 20, "fnn", 10, "adam", "general", False),
            ("ro", "ro", 23, "fnn", 10, "adam", None, False),
            ("ro_gather", "ro", 24, "fnn", 10, "adam", None, True),
            ("ro_general", "ro", 23, "fnn", 10, "adam", "general", False),
            ("cifar10", "cifar10", 21, "fnn", 10, "adam", None, False))
# the batch size of a case, where it is not its dataset's registry default
K1_BATCH = {"fmow_b32": 32}
# the pool size of a case, where it is not 4
K1_MODELS = {"fmow_m1": 1}
# the route each dataset's width must take, where it is not the wide one
K1_WIDTH_ROUTE = {"fmow": "split", "cifar10": "split",
                  "stackoverflow_lr": "split", "susy": "fused", "ro": "fused"}
# the fused kernel's instances that fold a row's values in chunks, by
# dataset: ptxas' registers and spills of each go on its cases' lines
FUSED_CHUNKED = {"susy": "local_sgd_fused_kernel<18,10,2>",
                 "ro": "local_sgd_fused_kernel<5,10,2>"}


def _gathered(x, tw, S: int, B: int, seed: int):
    """K1's gathered inputs for one case: rows drawn by K4 under the case's
    time weights and Poisson(1) sample weights, and 0/1 feature masks with
    at least one feature on per model (KUE's)."""
    import numpy as np
    import torch
    from feddrift_torch.kernels.weighted_draw import weighted_draw
    rng = np.random.default_rng(seed + 100)
    C, T1, N, F = x.shape
    M = tw.shape[0]
    sw = rng.poisson(1.0, (M, C, N)).astype(np.float32)
    fm = (rng.random((M, F)) < 0.6).astype(np.float32)
    fm[np.arange(M), rng.integers(0, F, M)] = 1.0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.rand((M, C, S, B), generator=gen, device="cuda")
    idx = weighted_draw(torch.from_numpy(tw).cuda(),
                        torch.from_numpy(sw).cuda(), u)
    return idx, torch.from_numpy(fm).cuda()


# the kernels line's entries of the MNIST-width and lr routes, in order
WIDE_ENTRIES = ("local_sgd_wide", "local_sgd_wide_lr", "local_sgd_wide_lr_sgd",
                "local_sgd_general_lr", "local_sgd_general_lr_sgd",
                "fedavg_mnist", "eval_cells_wide", "eval_cells_wide_lr",
                "eval_cells_general_lr", "local_sgd_split", "fedavg_fmow",
                "eval_cells_stream", "local_sgd_split_padded",
                "eval_cells_wide_so", "local_sgd_fedavg_susy",
                "local_sgd_fedavg_eval_susy", "eval_cells_fused_susy",
                "local_sgd_wide_k64", "local_sgd_split_k10")
# the kernels line's entries of K1's wide kernel and of the general
# kernel's lr and SGD routes, by case: (name, case, the route it must take)
K1_ENTRIES = {"mnist": ("local_sgd_wide", "MNIST-4's fnn 784 -> 10 -> 10, "
                        "AMSGrad, the wide kernel", "wide"),
              "mnist_lr": ("local_sgd_wide_lr", "MNIST-4's lr 784 -> 10, "
                           "AMSGrad, the wide kernel's lr route", "wide"),
              "mnist_lr_sgd": ("local_sgd_wide_lr_sgd", "MNIST-4's lr 784 "
                               "-> 10, SGD, the wide kernel's lr and SGD "
                               "routes", "wide"),
              "sea_lr_sgd": ("local_sgd_general_lr_sgd", "SEA's lr 3 -> 2, "
                             "SGD, the general kernel's lr and SGD routes",
                             "general"),
              "sea_lr": ("local_sgd_general_lr", "SEA's lr 3 -> 2, AMSGrad, "
                         "the general kernel's lr route", "general"),
              "fmow": ("local_sgd_split", "fmow's fnn 3072 -> 10 -> 62, "
                       "AMSGrad, the split kernel", "split"),
              "so": ("local_sgd_split_padded", "stackoverflow_lr's fnn 1000 "
                     "-> 10 -> 50, AMSGrad, the split kernel, its last CTA "
                     "padded past F", "split"),
              "femnist": ("local_sgd_wide_k64", "femnist's fnn 784 -> 10 -> "
                          "62, AMSGrad, the wide kernel at two classes a "
                          "lane", "wide"),
              "cifar10": ("local_sgd_split_k10", "cifar10's fnn 3072 -> 10 "
                          "-> 10, AMSGrad, the split kernel", "split")}
# K1 at MNIST's width (F = 784) under AMSGrad. Two float32 orders of a
# gradient's 500-row sums differ by ~1e-8, and a rounding can flip a
# hidden unit's ReLU on a row; where a unit is active on few rows its
# weights' gradients are ~1e-6 and such a change moves their sign, and
# AMSGrad's step normalises the gradient (lr * g / |g| at count 1), so
# those weights move by up to 2 lr apart (0.0107 at lr 0.01 on the card,
# 1208 of 318400 params over 1e-5, PERF.md). The plain float32 version
# sits as far from exact math at such coordinates. So the kernel is held
# to the plain version run in float64 as the float32 plain version is: at
# most twice as many coordinates of params and mu off by more than
# TRAIN_ATOL and of nu and nu_max by more than TRAIN_NU_RTOL, plus
# WIDE_ADAM_SLACK of them, no param further than S steps of lr, and the
# mean losses (of steps that start from those params) no further from the
# float64 ones than twice the float32 plain version's distance plus
# TRAIN_ATOL. Under SGD a step is lr times the gradient itself, and every
# coordinate is held to TRAIN_ATOL.
WIDE_ADAM_SLACK = 1e-4
# the timing of the general kernels forced at MNIST's width (~21 ms a K1
# call), and of K1 at fmow's width (its plain version gathers 1.2 GB of
# batch rows a call): calls a measure, rounds
WIDE_TIMING = dict(iters=5, rounds=3, reps=5, enqueue=20)
# the timing of the fused kernel's cases at susy's and ro's widths, whose
# plain version (~13 ms a call, hundreds of launches under the profiler)
# sets the cost of a case
TABULAR_TIMING = dict(iters=20, rounds=3, reps=5, enqueue=100)
# every other K1 case; _timed's defaults (K2's, K3's, K4's and the LSTM
# cell's cases) take the same depth, which keeps the whole script well
# inside its time limit on a slow host
K1_TIMING = dict(iters=20, rounds=3, reps=10, enqueue=100)


def _over(got, want, atol: float = 0.0, rtol: float = 0.0) -> int:
    """Coordinates where |got - want| > atol + rtol * |want|."""
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


def phase_train_kernel() -> tuple[dict, dict]:
    """K1 against its plain version at each of ``K1_CASES``. Returns the
    kernels line's entry of K1 without an epilogue at H = 32 and those of
    its MNIST-width routes (``K1_ENTRIES``)."""
    import torch
    from feddrift_torch.kernels import build
    from feddrift_torch.kernels.local_sgd import (_route, local_sgd,
                                                  local_sgd_ref)
    entry, entries, device_ms, bounds, times = None, {}, {}, {}, {}
    for label, dataset, seed, model, hidden, optimizer, forced, gather \
            in K1_CASES:
        args, kw, dims, tw = _train_case(dataset, seed, hidden, model,
                                         optimizer,
                                         models=K1_MODELS.get(label, 4),
                                         batch=K1_BATCH.get(label))
        x, y, params, opt, t_idx, slot, total_w = args
        route = forced or _route(dims["F"], dims["H"], dims["K"], dims["B"],
                                 optimizer)
        kw = dict(kw, route=route, optimizer=optimizer)
        N, B = x.shape[2], dims["B"]
        if gather:
            idx, fm = _gathered(x, tw, dims["S"], B, seed)
            t_idx = slot = None
            kw = dict(kw, idx=idx, feat_mask=fm)
            rows = idx
        else:
            rows = (t_idx * N + slot * B)[..., None] \
                + torch.arange(B, device="cuda")
        # the fused route at susy's and ro's widths is held as SEA's is
        sgd, wide = optimizer == "sgd", dims["F"] > 3 and route != "fused"
        want_route = forced or K1_WIDTH_ROUTE.get(
            dataset, "wide" if wide else None)
        if want_route and route != want_route:
            raise AssertionError(f"{label} took the {route} kernel")
        fresh = lambda: {k: v.clone() for k, v in opt.items()}
        client, k_opt, n, loss = local_sgd(x, y, params, fresh(), t_idx, slot,
                                           total_w, **kw)
        again = local_sgd(x, y, params, fresh(), t_idx, slot, total_w, **kw)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(
            (client, loss, n, *k_opt.values()),
            (again[0], again[3], again[2], *again[1].values())))
        plain_kw = {k: v for k, v in kw.items() if k != "route"}
        r_client, r_opt, r_n, r_loss = local_sgd_ref(
            x, y, params, fresh(), t_idx, slot, total_w, **plain_kw)
        err = max(float((client - r_client).abs().max()),
                  float((loss - r_loss).abs().max()),
                  0.0 if sgd else float((k_opt["mu"] - r_opt["mu"])
                                        .abs().max()))
        over = _over(client, r_client, TRAIN_ATOL)
        nu_rel = None if sgd else max(
            float(((k_opt[k] - r_opt[k]).abs()
                   / r_opt[k].abs().clamp_min(1e-30)).max())
            for k in ("nu", "nu_max"))
        inactive = total_w == 0
        untouched = bool(torch.equal(client[inactive],
                                     params[:, None].expand_as(client)
                                     [inactive])
                         and (sgd or (k_opt["count"][inactive] == 0).all())
                         and (n[inactive] == 0).all())
        same = bool(torch.equal(n, r_n) and (
            sgd or torch.equal(k_opt["count"], r_opt["count"])))
        coords = client.numel()
        off = None
        if wide and not sgd:
            # the MNIST width under AMSGrad: as far from float64 as the
            # float32 plain version (WIDE_ADAM_SLACK)
            exact_c, exact_opt, _, exact_loss = local_sgd_ref(
                x.double(), y, params.double(),
                {k: v.double() if v.is_floating_point() else v
                 for k, v in fresh().items()},
                t_idx, slot, total_w, **plain_kw)
            off = {}
            for name, (c, o) in (("kernel", (client, k_opt)),
                                 ("plain", (r_client, r_opt))):
                off[name] = _over(c.double(), exact_c, TRAIN_ATOL) \
                    + _over(o["mu"].double(), exact_opt["mu"], TRAIN_ATOL) \
                    + sum(_over(o[k].double(), exact_opt[k],
                                rtol=TRAIN_NU_RTOL)
                          for k in ("nu", "nu_max"))
            for name, l in (("kernel_loss", loss), ("plain_loss", r_loss)):
                off[name] = float((l.double() - exact_loss).abs().max())
            held = (off["kernel"] <= 2 * off["plain"]
                    + WIDE_ADAM_SLACK * 4 * coords
                    and float((client - r_client).abs().max())
                    <= dims["S"] * kw["lr"]
                    and off["kernel_loss"] <= 2 * off["plain_loss"]
                    + TRAIN_ATOL)
        else:
            held = err <= TRAIN_ATOL and (sgd or nu_rel <= TRAIN_NU_RTOL)
        state = fresh()
        calls = {"kernel": lambda: local_sgd(x, y, params, state, t_idx, slot,
                                             total_w, **kw),
                 "plain": lambda: local_sgd_ref(
                     x, y, params, state, t_idx, slot, total_w, **plain_kw)}
        timing = WIDE_TIMING if wide and route in ("general", "split") \
            else TABULAR_TIMING if dataset in FUSED_CHUNKED \
            else K1_TIMING
        ms, plain_ms = _interleaved(
            lambda f: _time_ms(f, timing["iters"]), calls,
            timing["rounds"]).values()
        device = {name: _device_ms(f, timing["reps"])
                  for name, f in calls.items()}
        device_ms[label] = device["kernel"]
        times[label] = {"kernel_ms": ms, "plain_ms": plain_ms}
        enqueue_ms = _host_enqueue_ms(calls["kernel"], timing["enqueue"])
        active = int((total_w > 0).sum())
        bound_ms, bound_by = _local_sgd_bound_ms(
            rows, total_w, **dims, index_bytes=4 * (
                rows.numel() + dims["M"] * dims["F"] if gather
                else 2 * t_idx.numel()), sgd=sgd)
        ptxas = _ptxas_per_kernel(build.build_log.get("local_sgd.cu", "")) \
            .get(FUSED_CHUNKED.get(dataset), "not built in this process") \
            if route == "fused" and dataset in FUSED_CHUNKED else None
        _say("train_kernel", name="local_sgd", case=label, dataset=dataset,
             model=model, optimizer=optimizer, route=route, ptxas=ptxas,
             batches="gathered (K4 rows, feature masks)"
             if gather else "contiguous", **dims, active_pairs=active,
             max_abs_err=err,
             atol=TRAIN_ATOL, coords_over_atol=over, coords=coords,
             coords_off_float64=off, nu_max_rel_err=nu_rel,
             nu_rtol=TRAIN_NU_RTOL, inactive_untouched=untouched,
             n_and_count_equal=same, two_calls_bitwise=bitwise,
             kernel_ms=ms, plain_ms=plain_ms,
             kernel_device_ms=device["kernel"], kernel_enqueue_ms=enqueue_ms,
             step_us=device["kernel"] * 1e3 / dims["S"]
             if device["kernel"] else "not measured",
             plain_device_ms=device["plain"], bound_ms=bound_ms,
             bound_by=bound_by, kernel_vs_bound=(device["kernel"] or ms)
             / bound_ms)
        if not (held and untouched and same and bitwise):
            raise AssertionError(f"local_sgd ({label}, {route}): |kernel - "
                                 f"plain| {err} (atol {TRAIN_ATOL}; "
                                 f"{over} params over; off float64 "
                                 f"{off}), nu rel {nu_rel}, "
                                 f"inactive untouched {untouched}, n/count "
                                 f"equal {same}, two calls bitwise "
                                 f"{bitwise}")
        bounds[label] = bound_ms
        if label == "sea" and route != "fused":
            raise AssertionError(f"the canonical shape took the {route} "
                                 f"kernel")
        # K1 without an epilogue runs on the general route (H = 32,
        # train_general's; SEA's lr) and the wide one (MNIST's width); the
        # fused route's K1 is local_sgd_fedavg's
        if label == "h32" or label in K1_ENTRIES:
            name, case, want = K1_ENTRIES.get(label, (
                "local_sgd", "H = 32, the general kernel (no epilogue)",
                "general"))
            if route != want:
                raise AssertionError(f"{label} took the {route} kernel")
            e = {"name": name, "route": "cuda",
                 "source": "feddrift_torch/kernels/csrc/local_sgd.cu",
                 "replaces": "feddrift_tpu/core/step.py:225",
                 "case": case, "launches": None, "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None,
                 "device_ms": device["kernel"]}
            if label == "h32":
                entry = e
            else:
                entries[name] = e
    fused, general = device_ms["sea"], device_ms["sea_general"]
    _say("train_kernel", what="canonical_shape_by_kernel",
         fused_device_ms=fused, general_device_ms=general,
         fused_vs_general=fused / general if fused and general
         else "not measured",
         first_design_device_ms_recorded=K1_FIRST_DESIGN_DEVICE_MS,
         bound_ms=bounds["sea"],
         gather_fused_device_ms=device_ms["sea_gather"],
         gather_general_device_ms=device_ms["sea_gather_general"],
         gather_vs_contiguous_fused=device_ms["sea_gather"] / fused
         if fused and device_ms["sea_gather"] else "not measured")
    from feddrift_torch.kernels.local_sgd import wide_clusters
    mnist, general = device_ms["mnist"], device_ms["mnist_general"]
    clusters = wide_clusters(784, 10, 10, 500)
    _say("train_kernel", what="mnist_width_by_route",
         wide_fnn_adam_device_ms=mnist, general_fnn_adam_device_ms=general,
         wide_vs_general=mnist / general if mnist and general
         else "not measured",
         wide_ms=times["mnist"]["kernel_ms"],
         general_ms=times["mnist_general"]["kernel_ms"],
         plain_ms=times["mnist"]["plain_ms"],
         wide_vs_plain=times["mnist"]["kernel_ms"] / times["mnist"]["plain_ms"],
         bound_ms=bounds["mnist"],
         wide_vs_bound=mnist / bounds["mnist"] if mnist else "not measured",
         wide_clusters_at_once=clusters, wide_waves=-(-40 // clusters),
         gathered_masked_device_ms=device_ms["mnist_gather"],
         lr_adam_device_ms=device_ms["mnist_lr"],
         lr_sgd_device_ms=device_ms["mnist_lr_sgd"],
         fnn_sgd_device_ms=device_ms["mnist_sgd"],
         canonical_run_k1_seconds_at_this_rate=mnist * 2000 / 1e3
         if mnist else "not measured")
    # fmow's width: the split kernel streams each pair's batch twice a step
    # (passes 1 and 2 each read B rows of F floats); the rate of that
    # stream against HBM's bounds how much of it L2 served (no profiler of
    # the card's counters runs here, so the hit rate itself is not read)
    fmow = device_ms["fmow"] or times["fmow"]["kernel_ms"]
    clusters = wide_clusters(3072, 10, 62, 500, route="split")
    streamed = 40 * 5 * 2 * 500 * 3072 * 4
    _say("train_kernel", what="fmow_width_by_route",
         split_device_ms=device_ms["fmow"],
         split_ms=times["fmow"]["kernel_ms"],
         plain_ms=times["fmow"]["plain_ms"],
         split_vs_plain=times["fmow"]["kernel_ms"]
         / times["fmow"]["plain_ms"],
         bound_ms=bounds["fmow"], split_vs_bound=fmow / bounds["fmow"],
         split_clusters_at_once=clusters, split_waves=-(-40 // clusters),
         streamed_bytes=streamed,
         streamed_bytes_per_s=streamed / (fmow / 1e3),
         streamed_vs_hbm=streamed / (fmow / 1e3) / HBM_BYTES_PER_S,
         gathered_masked_device_ms=device_ms["fmow_gather"],
         fnn_sgd_device_ms=device_ms["fmow_sgd"],
         femnist_fnn_wide_device_ms=device_ms["femnist"],
         canonical_run_k1_seconds_at_this_rate=fmow * 2000 / 1e3)
    # stackoverflow_lr's width: the split kernel padded past F (64 inputs a
    # CTA, the last CTA's 24 slots past F = 1000 idle), which the wide
    # kernel's budget and the general kernel's shared memory refuse
    so = device_ms["so"] or times["so"]["kernel_ms"]
    clusters = wide_clusters(1000, 10, 50, 500, route="split")
    _say("train_kernel", what="stackoverflow_lr_width_by_route",
         split_padded_device_ms=device_ms["so"],
         split_padded_ms=times["so"]["kernel_ms"],
         plain_ms=times["so"]["plain_ms"],
         split_padded_vs_plain=times["so"]["kernel_ms"]
         / times["so"]["plain_ms"],
         bound_ms=bounds["so"], split_padded_vs_bound=so / bounds["so"],
         step_us=so * 1e3 / 5, split_clusters_at_once=clusters,
         split_waves=-(-40 // clusters),
         gathered_masked_device_ms=device_ms["so_gather"],
         cifar10_split_device_ms=device_ms["cifar10"])
    # susy's and ro's widths: the fused kernel (a row's values folded 32 at
    # a time) beside the general kernel forced on the same inputs, the
    # plain version and the bound
    for d in ("susy", "ro"):
        fused = device_ms[d] or times[d]["kernel_ms"]
        general = device_ms[f"{d}_general"] \
            or times[f"{d}_general"]["kernel_ms"]
        _say("train_kernel", what=f"{d}_width_by_route",
             fused_ms=times[d]["kernel_ms"], fused_device_ms=device_ms[d],
             general_ms=times[f"{d}_general"]["kernel_ms"],
             general_device_ms=device_ms[f"{d}_general"],
             fused_vs_general=fused / general,
             plain_ms=times[d]["plain_ms"],
             fused_vs_plain=times[d]["kernel_ms"] / times[d]["plain_ms"],
             bound_ms=bounds[d], fused_vs_bound=fused / bounds[d],
             general_vs_bound=general / bounds[f"{d}_general"],
             step_us=fused * 1e3 / 5,
             gathered_masked_device_ms=device_ms[f"{d}_gather"],
             gathered_masked_ms=times[f"{d}_gather"]["kernel_ms"])
    return entry, entries


# K4's cases: (label, time weights, sample weights) at KUE's canonical
# shape (M = 4, C = 10, T1 = 11, N = 500, S = 5, B = 500): KUE's own
# (win-1 at step 5 times Poisson(1) counts: integers, so the kernels' cdf
# and rows must equal the plain versions' bit for bit), and non-integer
# weights (linear recency over steps 0..5 times counts scaled by
# U(0.5, 2)), where the cdf is held to DRAW_CDF_RTOL and a row may differ
# only where its uniform lies within that distance of a cdf boundary.
# Client 3 is left out of every model's weights (the uniform fallback) in
# both, and the round's client mask DRAW_MASK_OFF leaves clients 1 and 6
# out of its total weights (the search's uniform fallback).
DRAW_CASES = (("kue", "integer"), ("recency", "non_integer"))
DRAW_CDF_RTOL = 1e-6
DRAW_MASK_OFF = (1, 6)


def _draw_case(kind: str):
    import numpy as np
    import torch
    rng = np.random.default_rng(7 if kind == "integer" else 8)
    M, C, T1, N, S, B, t = 4, 10, 11, 500, 5, 500, 5
    tw = np.zeros((M, C, T1), np.float32)
    if kind == "integer":
        tw[:, :, t] = 1.0
        sw = rng.poisson(1.0, (M, C, N)).astype(np.float32)
    else:
        tw[:, :, : t + 1] = np.arange(1, t + 2, dtype=np.float32)
        sw = (rng.poisson(1.0, (M, C, N))
              * rng.uniform(0.5, 2.0, (M, C, N))).astype(np.float32)
    tw[:, 3] = 0.0
    mask = np.ones(C, np.float32)
    mask[list(DRAW_MASK_OFF)] = 0.0
    gen = torch.Generator(device="cuda").manual_seed(11)
    u = torch.rand((M, C, S, B), generator=gen, device="cuda")
    tw, sw = torch.from_numpy(tw).cuda(), torch.from_numpy(sw).cuda()
    masked = tw * torch.from_numpy(mask).cuda()[None, :, None]
    return tw, sw, masked, u, dict(M=M, C=C, T1=T1, N=N, S=S, B=B)


def _cdf_bound_ms(d: dict) -> tuple[float, str]:
    """Least time for one K4a call: the weights read once and the cdf
    written once, against its operations (the time weights' sum, a
    multiply, an add and a divide a row)."""
    pairs, L = d["M"] * d["C"], d["T1"] * d["N"]
    return _bound(4 * pairs * (d["T1"] + d["N"] + L),
                  pairs * (d["T1"] + 3 * L))


def _search_bound_ms(d: dict, weighted_pairs: int) -> tuple[float, str]:
    """Least time for one K4b call: the cdf rows of the pairs that search
    them (total weight > 0) read once, the total weights and uniforms read
    once and the rows written once, against ceil(log2(T1·N)) + 1
    comparisons a uniform."""
    import math
    pairs, L, D = d["M"] * d["C"], d["T1"] * d["N"], d["S"] * d["B"]
    return _bound(4 * (weighted_pairs * L + pairs * (1 + 2 * D)),
                  pairs * D * (math.ceil(math.log2(L)) + 1))


def phase_train_draw() -> tuple[dict, dict]:
    """K4, the weighted draw, as its two kernels against their plain
    versions on the card (rule of ``DRAW_CASES``): K4a, the step's cdf of
    the unmasked weights, and K4b, a round's search under the masked total
    weights, whose rows must also be the one-call draw's of the masked
    weights. Each is timed beside its plain version, one library call and
    its bound. Returns the kernels line's K4a and K4b entries."""
    import torch
    from feddrift_torch.kernels.weighted_draw import (weighted_cdf,
                                                      weighted_cdf_ref,
                                                      weighted_draw_ref,
                                                      weighted_search,
                                                      weighted_search_ref)
    entries = None
    for label, kind in DRAW_CASES:
        tw, sw, masked, u, d = _draw_case(kind)
        total_w = masked.sum(-1)
        cdf = weighted_cdf(tw, sw)
        idx = weighted_search(cdf, total_w, u)
        again = weighted_search(weighted_cdf(tw, sw), total_w, u)
        torch.cuda.synchronize()
        want_cdf = weighted_cdf_ref(tw, sw)
        want = weighted_search_ref(want_cdf, total_w, u)
        one_call = weighted_draw_ref(masked, sw, u)
        cdf_rel = float(((cdf - want_cdf).abs()
                         / want_cdf.abs().clamp_min(1e-30)).max())
        differ = idx != want
        # where a row differs, its uniform must lie within the tolerance
        # of the plain cdf's boundary between the two rows (rows of weight
        # 0 between them share that boundary)
        flat_u = u.reshape(d["M"], d["C"], -1)
        lo = torch.minimum(idx, want).reshape(d["M"], d["C"], -1).long()
        edge = want_cdf.gather(-1, lo)
        near = ((flat_u - edge).abs() <= DRAW_CDF_RTOL * edge.abs()) \
            .reshape(u.shape)
        gap = (idx - want).abs().max().item()
        search_on_plain_cdf = bool(torch.equal(
            weighted_search(want_cdf, total_w, u), want))
        ok = bool(torch.equal(idx, again)) and search_on_plain_cdf and bool(
            torch.equal(want, one_call)) and (
            bool(torch.equal(idx, want)) and bool(torch.equal(cdf, want_cdf))
            if kind == "integer" else cdf_rel <= DRAW_CDF_RTOL
            and bool(near[differ].all()))
        # the library's pieces: cumsum of the probabilities, searchsorted
        # of the uniforms in a normalised cdf, and both
        p = (tw[..., :, None] * sw[..., None, :]).reshape(d["M"], d["C"], -1)
        p = torch.where(p.sum(-1, keepdim=True) > 0, p, torch.ones_like(p))
        scaled = (flat_u * p.sum(-1, keepdim=True)).contiguous()
        times = {
            "cdf": _timed({"kernel": lambda: weighted_cdf(tw, sw),
                           "plain": lambda: weighted_cdf_ref(tw, sw),
                           "library": lambda: torch.cumsum(p, -1)}),
            "search": _timed({
                "kernel": lambda: weighted_search(cdf, total_w, u),
                "plain": lambda: weighted_search_ref(cdf, total_w, u),
                "library": lambda: torch.searchsorted(cdf, flat_u,
                                                      right=True)})}
        both = _timed({"kernel": lambda: torch.searchsorted(
            torch.cumsum(p, -1), scaled, right=True)})["kernel"]
        weighted_pairs = int((total_w > 0).sum())
        bounds = {"cdf": _cdf_bound_ms(d),
                  "search": _search_bound_ms(d, weighted_pairs)}
        for part, t in times.items():
            k = t["kernel"]
            _say("train_draw", name=f"weighted_{part}", case=label,
                 weights=kind, **d, masked_clients=list(DRAW_MASK_OFF),
                 weighted_pairs=weighted_pairs,
                 rows_equal=bool(torch.equal(idx, want)),
                 rows_differing=int(differ.sum()),
                 rows_differing_near_boundary=int(near[differ].sum()),
                 max_row_gap=gap,
                 cdf_bitwise=bool(torch.equal(cdf, want_cdf)),
                 cdf_max_rel_err=cdf_rel, cdf_rtol=DRAW_CDF_RTOL,
                 rows_are_the_masked_one_call_draw=bool(
                     torch.equal(want, one_call)),
                 search_on_plain_cdf_bitwise=search_on_plain_cdf,
                 two_calls_bitwise=bool(torch.equal(idx, again)),
                 kernel_ms=k["ms"], kernel_device_ms=k["device_ms"],
                 kernel_enqueue_ms=t["kernel_enqueue_ms"],
                 plain_ms=t["plain"]["ms"],
                 plain_device_ms=t["plain"]["device_ms"],
                 library_ms=t["library"]["ms"],
                 library_device_ms=t["library"]["device_ms"],
                 cumsum_searchsorted_ms=both["ms"],
                 cumsum_searchsorted_device_ms=both["device_ms"],
                 bound_ms=bounds[part][0], bound_by=bounds[part][1],
                 kernel_vs_bound=(k["device_ms"] or k["ms"])
                 / bounds[part][0])
        if not ok:
            raise AssertionError(f"weighted draw ({label}): rows equal "
                                 f"{bool(torch.equal(idx, want))}, "
                                 f"{int(differ.sum())} differ "
                                 f"({int(near[differ].sum())} near a "
                                 f"boundary), cdf rel {cdf_rel}, the masked "
                                 f"one-call draw's rows "
                                 f"{bool(torch.equal(want, one_call))}")
        if kind == "integer":
            src = "feddrift_torch/kernels/csrc/weighted_draw.cu"
            err = {"cdf": float((cdf - want_cdf).abs().max()),
                   "search": float((idx - want).abs().max())}
            entries = tuple(
                {"name": f"weighted_{part}", "route": "cuda", "source": src,
                 "replaces": "feddrift_tpu/core/step.py:"
                 + ("72" if part == "cdf" else "79"),
                 "launches": None, "max_abs_err": err[part],
                 "ms": times[part]["kernel"]["ms"],
                 "plain_ms": times[part]["plain"]["ms"],
                 "bound_ms": bounds[part][0], "bound_by": bounds[part][1],
                 "library_ms": times[part]["library"]["ms"],
                 "device_ms": times[part]["kernel"]["device_ms"]}
                for part in ("cdf", "search"))
    return entries


# K2 and K3 against their plain versions: K2 within AGG_ATOL (float32, ten
# weighted terms in another order) with a model that has no active client
# bitwise its previous params; K3's counts equal except rows whose top two
# plain logits lie within EVAL_TIE_GAP (the two compute the logits in other
# orders, ~1 ulp; the count of such rows is printed) and its NLL sums
# within EVAL_NLL_RTOL relative (sums of 500 rows in another order)
AGG_ATOL = 1e-6
EVAL_TIE_GAP = 1e-5
EVAL_NLL_RTOL = 1e-4
# K3's cases: (label, dataset, model, fnn hidden width, forced route,
# window, feature masks, scale of the params); the window of the dataset
# (T1 = 11): "G2" the train and test steps of an eval (t = 4, 5), "G1" one
# step (acc_matrix), "T1" every step (acc_cells, counts only). MNIST's
# width takes the wide kernel, the lr its lr route (the general kernel
# forced there is the design the wide one replaced, timed in the same run);
# SEA's lr keeps the general kernel's lr route; the lr's params scaled by
# 40 saturate most outputs to exactly 1.0, where the tie rule alone decides
# the row. fmow's width takes the wide route's streamed kernel, with the
# pool of 4 and, as win-1 and oblivious run it, of one model (K3_MODELS:
# one 10-column group a CTA)
K3_CASES = (("eval", "sea", "fnn", 10, None, "G2", False, 1.0),
            ("acc_matrix", "sea", "fnn", 10, None, "G1", False, 1.0),
            ("acc_cells", "sea", "fnn", 10, None, "T1", False, 1.0),
            ("eval_masked", "sea", "fnn", 10, None, "G2", True, 1.0),
            ("eval_general", "sea", "fnn", 10, "general", "G2", False, 1.0),
            ("h32_masked", "sea", "fnn", 32, None, "G2", True, 1.0),
            ("h32_cells", "sea", "fnn", 32, None, "T1", False, 1.0),
            ("mnist_eval", "MNIST", "fnn", 10, None, "G2", False, 1.0),
            ("mnist_cells", "MNIST", "fnn", 10, None, "T1", False, 1.0),
            ("mnist_masked", "MNIST", "fnn", 10, None, "G2", True, 1.0),
            ("mnist_lr_eval", "MNIST", "lr", 10, None, "G2", False, 1.0),
            ("mnist_lr_saturated", "MNIST", "lr", 10, None, "G2", True,
             40.0),
            ("mnist_lr_cells", "MNIST", "lr", 10, None, "T1", False, 40.0),
            ("sea_lr_eval", "sea", "lr", 10, None, "G2", False, 1.0),
            ("mnist_eval_general", "MNIST", "fnn", 10, "general", "G2", False,
             1.0),
            ("fmow_eval", "fmow", "fnn", 10, None, "G2", False, 1.0),
            ("fmow_cells", "fmow", "fnn", 10, None, "T1", False, 1.0),
            ("fmow_masked", "fmow", "fnn", 10, None, "G2", True, 1.0),
            ("fmow_eval_m1", "fmow", "fnn", 10, None, "G2", False, 1.0),
            ("fmow_cells_m1", "fmow", "fnn", 10, None, "T1", False, 1.0),
            ("susy_eval", "susy", "fnn", 10, None, "G2", False, 1.0),
            ("so_eval", "stackoverflow_lr", "fnn", 10, None, "G2", False,
             1.0),
            ("susy_eval_general", "susy", "fnn", 10, "general", "G2", False,
             1.0))
# the pool size of a case, where it is not 4
K3_MODELS = {"fmow_eval_m1": 1, "fmow_cells_m1": 1}
# the route a dataset's width must take, where it is not the wide one
K3_WIDTH_ROUTE = {"susy": "fused"}
# a case that runs on another case's inputs, the general kernel forced
# beside that case's fused one: their counts must be equal and their NLL
# sums bitwise (both kernels sum a row in one order)
K3_BESIDE = {"susy_eval_general": "susy_eval"}
# the kernels line's entries of K3's wide kernel and of the general
# kernel's lr route, by case
K3_ENTRIES = {"mnist_eval": ("eval_cells_wide", "MNIST-4's fnn, G = 2, the "
                             "wide kernel"),
              "mnist_lr_saturated": ("eval_cells_wide_lr", "MNIST-4's lr, "
                                     "G = 2, most outputs saturated, the "
                                     "wide kernel's lr route"),
              "sea_lr_eval": ("eval_cells_general_lr", "SEA's lr, G = 2, the "
                              "general kernel's lr route"),
              "fmow_eval": ("eval_cells_stream", "fmow's fnn 3072 -> 10 -> "
                            "62, G = 2, the wide route's streamed kernel"),
              "susy_eval": ("eval_cells_fused_susy", "susy's fnn 18 -> 10 "
                            "-> 2, G = 2, the fused kernel"),
              "so_eval": ("eval_cells_wide_so", "stackoverflow_lr's fnn 1000 "
                          "-> 10 -> 50, G = 2, the wide kernel's resident "
                          "32-row tiles")}
# a row of the lr with two outputs or more of z at least LR_SOLID_Z (1 / (1
# + exp(-z)) rounds to 1.0f from z ~ 17.3 on) and none in [LR_FLIP_Z,
# LR_SOLID_Z), where the kernel's z (another summation order, ~1e-5 apart
# at |z| ~ 20) may round its sigmoid to the other side of 1.0f, is tied in
# the kernel too: the tie rule alone decides it, and its count must equal
# the plain version's
LR_SOLID_Z, LR_FLIP_Z = 20.0, 15.0


def _forward_flops(rows: int, F: int, H: int, K: int) -> int:
    """Operations of the fnn forward, its argmax and its log-softmax at the
    label, per row: the two products and biases, the ReLU, and ~6 a
    class (compare, subtract, exp, add; the log and the label's term).
    ``H = 0``: the lr, its product and bias and ~4 a class more for the
    sigmoid."""
    if H == 0:
        return rows * (2 * F * K + K + 10 * K)
    return rows * (2 * F * H + 2 * H * K + H + K + 6 * K)


def _eval_bound_ms(flat, xw, F: int, H: int, K: int, nll_on: bool,
                   masked: bool) -> tuple[float, str]:
    """Least time for one eval of ``flat [M, P]`` on the window ``xw [C, G,
    N, F]``: its rows, labels, the params (and masks) read once and the
    cells written once, against the forward's operations."""
    M, P, (C, G, N) = flat.shape[0], flat.shape[1], xw.shape[:3]
    return _bound(4 * (C * G * N * (F + 1) + M * P + M * C * G * (1 + nll_on)
                       + (M * F if masked else 0)),
                  _forward_flops(M * C * G * N, F, H, K))


def _timed(calls: dict, iters: int = 20, rounds: int = 3, reps: int = 10,
           enqueue: int = 100) -> dict:
    """Per call (``iters`` calls a measure, in turns for ``rounds``), on
    the device (``reps`` calls) and, for the kernel, the host's enqueue
    alone (``enqueue`` calls): ``{name: {"ms", "device_ms"}}`` plus
    ``kernel_enqueue_ms``."""
    ms = _interleaved(lambda f: _time_ms(f, iters), calls, rounds)
    out = {name: {"ms": ms[name], "device_ms": _device_ms(fn, reps)}
           for name, fn in calls.items()}
    out["kernel_enqueue_ms"] = _host_enqueue_ms(calls["kernel"], enqueue)
    return out


# K2's cases: (label, fnn hidden width). K2 runs as its own launch only on
# K1's general route, which H = 32 takes (P 194): its kernels-line entry is
# that case's. The canonical width (P 62) is held and timed beside it.
# MNIST's fnn (P 7960) takes K2 as its own launch too: at the canonical
# pool of 4 (the kernels line's fedavg_mnist) and H_A_F_1_3_0's pool of 10.
# fmow's fnn (P 31,412) likewise (the kernels line's fedavg_fmow).
K2_CASES = (("h32", 32, "sea", 4), ("sea", 10, "sea", 4),
            ("mnist", 10, "MNIST", 4), ("mnist_m10", 10, "MNIST", 10),
            ("fmow", 10, "fmow", 4))
K2_ENTRIES = {"h32": "fedavg", "mnist": "fedavg_mnist",
              "fmow": "fedavg_fmow"}


def _k2_case(hidden: int, dataset: str = "sea", models: int = 4):
    """K2's inputs: the client stack and n of one K1 round at the
    dataset's shape and fnn width ``hidden`` with ``models`` models (pairs
    (0, 3), (2, 7) and all of model 3 inactive: model 3 is a cluster with
    no active client), and the pool as prev."""
    from feddrift_torch.kernels.local_sgd import local_sgd
    args, kw, d, _ = _train_case(dataset, 0, hidden, models=models)
    client, _, n, _ = local_sgd(*args, **kw)
    return client, n, args[2], d


def _k2_phase() -> dict:
    """K2 against its plain version at each of ``K2_CASES``: within
    ``AGG_ATOL``, the empty cluster bitwise its previous params, the stats
    row equal and written only where asked, two calls bitwise; timed
    beside its plain version and bound. Returns the kernels line's entries
    of ``K2_ENTRIES`` by name."""
    entries = {}
    for label, hidden, dataset, models in K2_CASES:
        client, n, prev, _ = _k2_case(hidden, dataset, models)
        entry = _k2_check(label, client, n, prev, dataset=dataset,
                          hidden=hidden)
        if label in K2_ENTRIES:
            entries[K2_ENTRIES[label]] = dict(
                entry, name=K2_ENTRIES[label],
                case=f"{entry['case']} ({dataset}, fnn H = {hidden}, K1's "
                f"general route)")
    return entries


def _k2_check(label: str, client, n, prev, **case) -> dict:
    """K2 on ``client [M, C, P]``, ``n`` and ``prev`` against its plain
    version (see ``_k2_phase``), one ``train_agg`` line with ``case``'s
    fields; returns its kernels-line entry, named and counted by the
    caller."""
    import torch
    from feddrift_torch.kernels.fedavg import fedavg, fedavg_ref
    M, C, P = client.shape
    rows = torch.full((3, M, 3), -1.0, device="cuda")
    out, stats = fedavg(client, n, prev, stats_out=rows[1])
    again, again_stats = fedavg(client, n, prev)
    torch.cuda.synchronize()
    want, want_stats = fedavg_ref(client, n, prev)
    err = float((out - want).abs().max())
    empty = n.sum(1) == 0
    empty_bitwise = bool(torch.equal(out[empty], prev[empty]))
    stats_equal = bool(torch.equal(stats, want_stats)
                       and torch.equal(rows[1], want_stats)
                       and (rows[[0, 2]] == -1).all())
    bitwise = bool(torch.equal(out, again)
                   and torch.equal(stats, again_stats))
    times = _timed({"kernel": lambda: fedavg(client, n, prev),
                    "plain": lambda: fedavg_ref(client, n, prev)})
    # what this call's n needs: bytes, the stack's columns of the active
    # pairs (a weight of 0 adds nothing), n, and prev of the empty clusters
    # read once, out and stats written once; operations, a multiply and an
    # add a term of the active pairs, the weights' sums and divisions
    active = int((n > 0).sum())
    bound_ms, bound_by = _bound(
        4 * (active * P + M * C + int(empty.sum()) * P + M * P + 3 * M),
        2 * active * P + 2 * M * C)
    kernel = times["kernel"]
    _say("train_agg", name="fedavg", case=label, **case, M=M, C=C, P=P,
         empty_clusters=int(empty.sum()), active_pairs=active,
         active_clients=stats[:, 0].tolist(), max_abs_err=err,
         atol=AGG_ATOL, empty_bitwise_prev=empty_bitwise,
         stats_equal=stats_equal, two_calls_bitwise=bitwise,
         kernel_ms=kernel["ms"], kernel_device_ms=kernel["device_ms"],
         kernel_enqueue_ms=times["kernel_enqueue_ms"],
         plain_ms=times["plain"]["ms"],
         plain_device_ms=times["plain"]["device_ms"],
         plain_launches_per_call=_launches(
             lambda: fedavg_ref(client, n, prev)),
         bound_ms=bound_ms, bound_by=bound_by,
         kernel_vs_bound=(kernel["device_ms"] or kernel["ms"]) / bound_ms)
    if not (err <= AGG_ATOL and empty_bitwise and stats_equal
            and bitwise and bool(empty.any())):
        raise AssertionError(f"fedavg ({label}): |kernel - plain| {err} "
                             f"(atol {AGG_ATOL}), empty clusters "
                             f"bitwise {empty_bitwise}, stats equal "
                             f"{stats_equal}, two calls bitwise "
                             f"{bitwise}")
    return {"name": None, "route": "cuda",
            "source": "feddrift_torch/kernels/csrc/fedavg.cu",
            "replaces": "feddrift_tpu/resilience/robust_agg.py:139",
            "case": f"M {M}, C {C}, P {P}", "launches": None,
            "max_abs_err": err, "ms": kernel["ms"],
            "plain_ms": times["plain"]["ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "device_ms": kernel["device_ms"]}


def _k3_case(dataset: str, model: str, hidden: int, window: str,
             masked: bool, seed: int, scale: float = 1.0, models: int = 4):
    """K3's canonical inputs: the dataset on the card, a pool of
    ``models`` distinct draws of the model (the fnn at width ``hidden``, or the lr)
    scaled by ``scale``, the window and, if asked, per-model 0/1 feature
    masks (at least one feature on per model)."""
    import numpy as np
    import torch
    args, _, d, _ = _train_case(dataset, seed, hidden, model, models=models)
    x, y, flat = args[:3]
    flat = flat * scale
    t = 4
    xw, yw = {"G1": (x[:, t, None], y[:, t, None]),
              "G2": (x[:, t:t + 2], y[:, t:t + 2]), "T1": (x, y)}[window]
    fm = None
    if masked:
        rng = np.random.default_rng(seed + 200)
        f = (rng.random((d["M"], d["F"])) < 0.6).astype(np.float32)
        f[np.arange(d["M"]), rng.integers(0, d["F"], d["M"])] = 1.0
        fm = torch.from_numpy(f).cuda()
    return flat, xw, yw, fm, d


def _near_ties(flat, x, fm, F: int, H: int, K: int):
    """Rows of each cell whose top two plain logits (the lr's: sigmoid
    outputs) lie within EVAL_TIE_GAP, and, for the lr, the rows of each
    cell tied solidly: both top outputs 1.0 from z of at least
    LR_SOLID_Z, which the kernel ties too (not among the near ties)."""
    import torch
    from feddrift_torch.kernels.local_sgd import _unpack
    leaves = [v[:, None, None] for v in _unpack(flat, F, H, K)]
    xin = x[None] if fm is None else x[None] * fm[:, None, None, None, :]
    if H:
        w0, b0, w1, b1 = leaves
        z = (xin @ w0 + b0.unsqueeze(-2)).relu() @ w1 + b1.unsqueeze(-2)
        top = z.topk(2, dim=-1).values
        return ((top[..., 0] - top[..., 1]) <= EVAL_TIE_GAP).sum(-1), None
    w, b = leaves
    z = xin @ w + b.unsqueeze(-2)
    top = torch.sigmoid(z).topk(2, dim=-1).values
    solid = ((z >= LR_SOLID_Z).sum(-1) >= 2) \
        & ~((z >= LR_FLIP_Z) & (z < LR_SOLID_Z)).any(-1)
    near = (top[..., 0] - top[..., 1]) <= EVAL_TIE_GAP
    return (near & ~solid).sum(-1), solid.sum(-1)


def _k3_phase() -> tuple[dict, dict]:
    """K3 against its plain version at each of ``K3_CASES``. Returns the
    kernels line's entry of the canonical eval and those of K3's
    MNIST-width and lr routes (``K3_ENTRIES``)."""
    import torch
    from feddrift_torch.kernels.eval_cells import (STREAM_ROWS, _route,
                                                   eval_cells, eval_cells_ref,
                                                   wide_rows)
    entry, entries, outs = None, {}, {}
    seeds = {c[0]: i for i, c in enumerate(K3_CASES)}
    for label, dataset, model, hidden, forced, window, masked, scale \
            in K3_CASES:
        flat, xw, yw, fm, d = _k3_case(dataset, model, hidden, window,
                                       masked,
                                       seeds[K3_BESIDE.get(label, label)],
                                       scale, K3_MODELS.get(label, 4))
        F, H, K = d["F"], d["H"], d["K"]
        route = forced or _route(F, H, K)
        nll_on = window != "T1"
        kw = dict(hidden=H, feat_mask=fm, with_nll=nll_on, route=route)
        correct, nll = eval_cells(flat, xw, yw, **kw)
        again = eval_cells(flat, xw, yw, **kw)
        torch.cuda.synchronize()
        plain = {k: v for k, v in kw.items() if k != "route"}
        want, want_nll = eval_cells_ref(flat, xw, yw, **plain)
        ties, solid = _near_ties(flat, xw, fm, F, H, K)
        diff = (correct - want).abs()
        counts_ok = bool((diff <= ties).all())
        nll_rel = float(((nll - want_nll).abs()
                         / want_nll.abs().clamp_min(1e-30)).max()) \
            if nll_on else None
        bitwise = bool(torch.equal(correct, again[0]) and (
            not nll_on or torch.equal(nll, again[1])))
        wide = F > 3
        times = _timed({
            "kernel": lambda: eval_cells(flat, xw, yw, **kw),
            "plain": lambda: eval_cells_ref(flat, xw, yw, **plain)},
            **(WIDE_TIMING if wide and route == "general" else {}))
        M, (C, G, N) = flat.shape[0], xw.shape[:3]
        bound_ms, bound_by = _eval_bound_ms(flat, xw, F, H, K, nll_on, masked)
        kernel = times["kernel"]
        _say("train_eval", name="eval_cells", case=label, dataset=dataset,
             model=model, route=route,
             tile_rows=wide_rows(F, H, K) if route == "wide" else None,
             window=window, M=M, C=C, G=G, N=N,
             F=F, H=H, K=K, feature_masks=masked, params_scale=scale,
             blocks=M * C * G,
             counts_equal=bool(torch.equal(correct, want)),
             cells_differing=int((diff > 0).sum()),
             near_tied_rows=int(ties.sum()),
             solidly_tied_rows=None if solid is None else int(solid.sum()),
             counts_within_ties=counts_ok,
             nll_max_rel_err=nll_rel, nll_rtol=EVAL_NLL_RTOL,
             two_calls_bitwise=bitwise, kernel_ms=kernel["ms"],
             kernel_device_ms=kernel["device_ms"],
             kernel_enqueue_ms=times["kernel_enqueue_ms"],
             plain_ms=times["plain"]["ms"],
             plain_device_ms=times["plain"]["device_ms"],
             plain_launches_per_call=_launches(
                 lambda: eval_cells_ref(flat, xw, yw, **plain)),
             bound_ms=bound_ms, bound_by=bound_by,
             kernel_vs_bound=(kernel["device_ms"] or kernel["ms"])
             / bound_ms)
        if not (counts_ok and bitwise and (
                not nll_on or nll_rel <= EVAL_NLL_RTOL)):
            raise AssertionError(f"eval_cells ({label}, {route}): counts "
                                 f"within near ties {counts_ok}, nll rel "
                                 f"{nll_rel} (rtol {EVAL_NLL_RTOL}), two "
                                 f"calls bitwise {bitwise}")
        if scale > 1 and not int(solid.sum()):
            raise AssertionError(f"{label}: no row is tied solidly, so the "
                                 f"tie rule was not exercised")
        outs[label] = (correct, nll, kernel)
        if label in K3_BESIDE:
            f_c, f_l, f_t = outs[K3_BESIDE[label]]
            same = bool(torch.equal(f_c, correct) and torch.equal(f_l, nll))
            _say("train_eval", what=f"{K3_BESIDE[label]}_fused_vs_general",
                 counts_equal=bool(torch.equal(f_c, correct)),
                 nll_bitwise=bool(torch.equal(f_l, nll)),
                 nll_max_abs_diff=float((f_l - nll).abs().max()),
                 fused_ms=f_t["ms"], fused_device_ms=f_t["device_ms"],
                 general_ms=kernel["ms"],
                 general_device_ms=kernel["device_ms"],
                 fused_vs_general=f_t["ms"] / kernel["ms"])
            if not same:
                raise AssertionError(f"{label}: the fused and general "
                                     f"kernels' cells differ at the same "
                                     f"inputs")
        if route != (forced or K3_WIDTH_ROUTE.get(
                dataset, "wide" if wide else route)) or (
                dataset == "fmow" and wide_rows(F, H, K) != STREAM_ROWS):
            raise AssertionError(f"{label} took the {route} kernel")
        if label in K3_ENTRIES:
            name, case = K3_ENTRIES[label]
            entries[name] = {
                "name": name, "route": "cuda",
                "source": "feddrift_torch/kernels/csrc/eval_cells.cu",
                "replaces": "feddrift_tpu/core/step.py:777", "case": case,
                "launches": None,
                "max_abs_err": float((correct - want).abs().max()),
                "ms": kernel["ms"], "plain_ms": times["plain"]["ms"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "device_ms": kernel["device_ms"]}
        if label == "eval":
            if route != "fused":
                raise AssertionError(f"the canonical eval took the {route} "
                                     f"kernel")
            entry = {"name": "eval_cells", "route": "cuda",
                     "source": "feddrift_torch/kernels/csrc/eval_cells.cu",
                     "replaces": "feddrift_tpu/core/step.py:777",
                     "launches": None,
                     "max_abs_err": float((correct - want).abs().max()),
                     "ms": kernel["ms"], "plain_ms": times["plain"]["ms"],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None, "device_ms": kernel["device_ms"]}
    return entry, entries


def _k5_phase() -> None:
    """K5's functions, still plain PyTorch on the card, at the ensembles'
    shapes (AUE: M = 3, no masks; KUE: M = 4, feature masks): per call, on
    the device and their launches, beside the bound of each."""
    import torch
    from feddrift_torch.core.step import TrainStep
    from feddrift_torch.models.mlp import FeedForwardNN
    for algo, M in (("aue", 3), ("kue", 4)):
        flat, xw, yw, fm, d = _k3_case("sea", "fnn", 10, "G1", algo == "kue",
                                       7)
        flat, x, y = flat[:M], xw[:, 0], yw[:, 0]
        fm = None if fm is None else fm[:M]
        F, H, K, (C, N) = d["F"], d["H"], d["K"], x.shape[:2]
        step = TrainStep(FeedForwardNN((F,), K, H), d["B"], d["S"], K)
        tree = step.module.unpack(flat)
        w = torch.linspace(0.5, 1.5, M, device="cuda")
        reads = 4 * (C * N * (F + 1) + flat.numel()
                     + (fm.numel() if fm is not None else 0))
        fwd = _forward_flops(M * C * N, F, H, K)
        calls = {"mse_matrix": (lambda: step.mse_matrix(tree, x, y, fm),
                                reads + 4 * (M * C + C), fwd)}
        if algo == "aue":
            calls["ensemble_eval_hard"] = (
                lambda: step.ensemble_eval(tree, x, y, w, "hard", None, fm),
                reads + 4 * (M + 3 * C), fwd + 2 * M * C * N * K)
        else:
            calls["ensemble_eval_soft"] = (
                lambda: step.ensemble_eval(tree, x, y, w, "soft", None, fm),
                reads + 4 * (M + 3 * C), fwd + 4 * M * C * N * K)
            calls["confusion_matrices"] = (
                lambda: step.confusion_matrices(tree, x, y, fm),
                reads + 4 * M * C * K * K, fwd + M * C * N)
        for name, (fn, nbytes, flops) in calls.items():
            bound_ms, bound_by = _bound(nbytes, flops)
            device_ms = _device_ms(fn)
            _say("train_plain", name=name, algo=algo, M=M, C=C, N=N,
                 feature_masks=fm is not None, ms=_time_ms(fn),
                 device_ms=device_ms, enqueue_ms=_host_enqueue_ms(fn),
                 launches_per_call=_launches(fn), bound_ms=bound_ms,
                 bound_by=bound_by, device_vs_bound=device_ms / bound_ms
                 if device_ms else "not measured")


# K1 with K2 as its epilogue: (label, dataset, seed, gathered batches) at
# the canonical round shape with _train_case's inactive pairs and model 3
# without an active client; gathered rows as KUE's route (with KUE's
# feature masks); F = 2 (sine). Every case also folds K3 into the launch:
# the eval of the round's input params on steps FOLD_STEP and FOLD_STEP + 1
K1K2_CASES = (("sea", "sea", 0, False), ("sea_gather", "sea", 3, True),
              ("sine", "sine", 1, False), ("susy", "susy", 20, False),
              ("susy_gather", "susy", 22, True), ("ro", "ro", 23, False))
# the kernels line's K1 + K2 and K1 + K2 + K3 entries of the fused kernel's
# chunked instances, by case (the canonical SEA case's are
# local_sgd_fedavg and local_sgd_fedavg_eval)
K1K2_ENTRIES = {"susy": ("local_sgd_fedavg_susy",
                         "local_sgd_fedavg_eval_susy")}
K1K2_REPEATS = 200
FOLD_STEP = 4


def _k1k2_phase() -> tuple[dict, dict, dict]:
    """The fused round (``local_sgd_fedavg``: K1 with K2 as its epilogue)
    against the K1 launch followed by the ``fedavg.cu`` launch: bitwise in
    the aggregated params, stats, client stack, optimizer state, n and
    losses; ``K1K2_REPEATS`` calls back to back give the same bits (a
    ticket race, or a ticket not reset, would not: each call's stats row
    starts at -1). Then the same launch with K3 folded in (the eval of its
    input params on a two-step window): ``K1K2_REPEATS`` calls bitwise
    equal, in every output, to the K1 + K2 launch followed by the
    ``eval_cells`` launch on those params. Device times beside K1's, K2's
    and K3's alone; at SEA's and sine's widths and at susy's and ro's,
    where the kernel folds a row's values in chunks. Returns the kernels
    line's entries of K1 + K2 and of K1 + K2 + K3, and those of
    ``K1K2_ENTRIES`` by name."""
    import torch
    from feddrift_torch.kernels.eval_cells import eval_cells, eval_cells_ref
    from feddrift_torch.kernels.fedavg import fedavg, fedavg_ref
    from feddrift_torch.kernels.local_sgd import (local_sgd, local_sgd_fedavg,
                                                  local_sgd_fedavg_ref)
    entry = fold_entry = None
    entries = {}
    for label, dataset, seed, gather in K1K2_CASES:
        args, kw, dims, tw = _train_case(dataset, seed)
        x, y, params, opt, t_idx, slot, total_w = args
        fm = None
        if gather:
            idx, fm = _gathered(x, tw, dims["S"], dims["B"], seed)
            t_idx = slot = None
            kw = dict(kw, idx=idx, feat_mask=fm)
            rows = idx
        else:
            rows = (t_idx * x.shape[2] + slot * dims["B"])[..., None] \
                + torch.arange(dims["B"], device="cuda")
        M, C, H = dims["M"], dims["C"], dims["H"]
        window = (x[:, FOLD_STEP:FOLD_STEP + 2], y[:, FOLD_STEP:FOLD_STEP + 2])
        fresh = lambda: {k: v.clone() for k, v in opt.items()}
        cells = lambda: (torch.full((M, C, 2), -1, dtype=torch.int32,
                                    device="cuda"),
                         torch.full((M, C, 2), -1.0, device="cuda"))
        state = fresh()
        client, state, n, loss = local_sgd(x, y, params, state, t_idx, slot,
                                           total_w, **kw)
        agg, stats = fedavg(client, n, params)
        k3 = lambda: eval_cells(params, *window, hidden=H, feat_mask=fm)
        want_c, want_l = k3()

        def same(o):
            return bool(torch.equal(o[4], agg) and torch.equal(o[5], stats)
                        and torch.equal(o[0], client) and torch.equal(o[2], n)
                        and torch.equal(o[3], loss)
                        and all(torch.equal(o[1][k], state[k])
                                for k in state))

        def back_to_back(fold):
            """K1K2_REPEATS calls; how many differ, and the last one's
            eval cells."""
            states = [fresh() for _ in range(K1K2_REPEATS)]
            stat_rows = torch.full((K1K2_REPEATS, M, 3), -1.0,
                                   device="cuda")
            outs = [cells() for _ in range(K1K2_REPEATS)]
            got = [local_sgd_fedavg(
                x, y, params, st, t_idx, slot, total_w, **kw,
                stats_out=stat_rows[i],
                **(dict(eval_window=window, eval_out=outs[i]) if fold
                   else {})) for i, st in enumerate(states)]
            torch.cuda.synchronize()
            return sum(not (same(o) and (not fold or (
                torch.equal(e[0], want_c) and torch.equal(e[1], want_l))))
                for o, e in zip(got, outs)), outs[-1]
        differing, _ = back_to_back(False)
        fold_differing, (fold_c, fold_l) = back_to_back(True)
        want, want_stats = fedavg_ref(client, n, params)
        err = float((agg - want).abs().max())
        empty = n.sum(1) == 0
        empty_prev = bool(torch.equal(agg[empty], params[empty]))
        # the folded eval against the plain one: counts equal but on
        # near-tied rows, NLL sums within EVAL_NLL_RTOL
        plain_c, plain_l = eval_cells_ref(params, *window, hidden=H,
                                          feat_mask=fm)
        ties = _near_ties(params, window[0], fm, dims["F"], H, dims["K"])[0]
        cells_ok = bool(((fold_c - plain_c).abs() <= ties).all())
        nll_err = float((fold_l - plain_l).abs().max())
        nll_rel = float(((fold_l - plain_l).abs()
                         / plain_l.abs().clamp_min(1e-30)).max())
        state, eo = fresh(), cells()
        calls = {"kernel": lambda: local_sgd_fedavg(
                     x, y, params, state, t_idx, slot, total_w, **kw),
                 "plain": lambda: local_sgd_fedavg_ref(
                     x, y, params, state, t_idx, slot, total_w, **kw),
                 "fold": lambda: local_sgd_fedavg(
                     x, y, params, state, t_idx, slot, total_w, **kw,
                     eval_window=window, eval_out=eo),
                 "fold_plain": lambda: local_sgd_fedavg_ref(
                     x, y, params, state, t_idx, slot, total_w, **kw,
                     eval_window=window, eval_out=eo)}
        times = _timed(calls, **(TABULAR_TIMING if dataset in FUSED_CHUNKED
                                 else {}))
        fold_enqueue = _host_enqueue_ms(calls["fold"])
        k1_dev = _device_ms(lambda: local_sgd(x, y, params, state, t_idx,
                                              slot, total_w, **kw))
        k2_dev = _device_ms(lambda: fedavg(client, n, params))
        k3_dev, k3_enqueue = _device_ms(k3), _host_enqueue_ms(k3)
        bound_ms, bound_by = _local_sgd_bound_ms(
            rows, total_w, **dims, index_bytes=4 * (
                rows.numel() + M * dims["F"] if gather
                else 2 * t_idx.numel()), aggregate=True)
        ev_bound, ev_by = _eval_bound_ms(params, window[0], dims["F"], H,
                                         dims["K"], True, gather)
        fold_bound = bound_ms + ev_bound
        fold_by = bound_by if bound_ms >= ev_bound else ev_by
        k, f = times["kernel"], times["fold"]
        _say("train_agg", name="local_sgd_fedavg", case=label,
             dataset=dataset, batches="gathered (K4 rows, feature masks)"
             if gather else "contiguous", **dims,
             active_pairs=int((total_w > 0).sum()),
             empty_models=int(empty.sum()), repeats=K1K2_REPEATS,
             repeats_differing=differing, max_abs_err_vs_plain=err,
             stats_equal_plain=bool(torch.equal(stats, want_stats)),
             empty_model_bitwise_prev=empty_prev,
             kernel_ms=k["ms"], kernel_device_ms=k["device_ms"],
             kernel_enqueue_ms=times["kernel_enqueue_ms"],
             k1_alone_device_ms=k1_dev, k2_alone_device_ms=k2_dev,
             k1_plus_k2_device_ms=k1_dev + k2_dev if k1_dev and k2_dev
             else "not measured",
             plain_ms=times["plain"]["ms"],
             plain_device_ms=times["plain"]["device_ms"],
             bound_ms=bound_ms, bound_by=bound_by,
             kernel_vs_bound=(k["device_ms"] or k["ms"]) / bound_ms)
        _say("train_agg", name="local_sgd_fedavg_eval", case=label,
             dataset=dataset, window_steps=[FOLD_STEP, FOLD_STEP + 1],
             feature_masks=fm is not None,
             repeats=K1K2_REPEATS, repeats_differing=fold_differing,
             counts_within_near_ties_of_plain=cells_ok,
             near_tied_rows=int(ties.sum()), nll_max_abs_err=nll_err,
             nll_max_rel_err=nll_rel, nll_rtol=EVAL_NLL_RTOL,
             fold_ms=f["ms"], fold_device_ms=f["device_ms"],
             fold_enqueue_ms=fold_enqueue,
             k1k2_device_ms=k["device_ms"],
             k1k2_enqueue_ms=times["kernel_enqueue_ms"],
             k3_alone_device_ms=k3_dev, k3_alone_enqueue_ms=k3_enqueue,
             k1k2_plus_k3_device_ms=k["device_ms"] + k3_dev
             if k["device_ms"] and k3_dev else "not measured",
             k1k2_plus_k3_enqueue_ms=times["kernel_enqueue_ms"] + k3_enqueue,
             plain_ms=times["fold_plain"]["ms"],
             plain_device_ms=times["fold_plain"]["device_ms"],
             bound_ms=fold_bound, bound_by=fold_by,
             fold_vs_bound=(f["device_ms"] or f["ms"]) / fold_bound)
        if differing or err > AGG_ATOL or not empty_prev \
                or not bool(empty.any()) \
                or not torch.equal(stats, want_stats):
            raise AssertionError(f"local_sgd_fedavg ({label}): "
                                 f"{differing} of {K1K2_REPEATS} calls "
                                 f"differ from K1 then K2, |K2 - plain| "
                                 f"{err}, empty model bitwise prev "
                                 f"{empty_prev}")
        if fold_differing or not cells_ok or nll_rel > EVAL_NLL_RTOL:
            raise AssertionError(f"local_sgd_fedavg with the eval "
                                 f"({label}): {fold_differing} of "
                                 f"{K1K2_REPEATS} calls differ from K1 + "
                                 f"K2 then K3; the eval against plain: "
                                 f"counts within near ties {cells_ok}, "
                                 f"nll rel {nll_rel}")
        if label == "sea" or label in K1K2_ENTRIES:
            name, fold_name = K1K2_ENTRIES.get(
                label, ("local_sgd_fedavg", "local_sgd_fedavg_eval"))
            e = {"name": name, "route": "cuda",
                 "source": "feddrift_torch/kernels/csrc/local_sgd.cu",
                 "replaces": "feddrift_tpu/core/step.py:225 and "
                 "feddrift_tpu/resilience/robust_agg.py:139",
                 "launches": None, "max_abs_err": err, "ms": k["ms"],
                 "plain_ms": times["plain"]["ms"], "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None,
                 "device_ms": k["device_ms"]}
            fe = {
                "name": fold_name, "route": "cuda",
                "source": "feddrift_torch/kernels/csrc/local_sgd.cu "
                "(feddrift_torch/kernels/csrc/fnn_eval.cuh)",
                "replaces": "feddrift_tpu/core/step.py:225, "
                "feddrift_tpu/resilience/robust_agg.py:139 and "
                "feddrift_tpu/core/step.py:777",
                # K2's error and the eval's NLL error against plain (its
                # counts: within near ties, checked above)
                "launches": None, "max_abs_err": max(err, nll_err),
                "ms": f["ms"],
                "plain_ms": times["fold_plain"]["ms"], "bound_ms": fold_bound,
                "bound_by": fold_by, "library_ms": None,
                "device_ms": f["device_ms"]}
            if label == "sea":
                entry, fold_entry = e, fe
            else:
                entries.update({name: e, fold_name: fe})
    return entry, fold_entry, entries


def phase_train_agg_eval() -> tuple[dict, dict, dict, dict, dict]:
    """K2 (the masked FedAvg) alone and as K1's epilogue, K3 (the eval
    matrices) folded into that launch and alone, against their plain
    versions on the card at the canonical shapes and at MNIST's width,
    timed beside them and their bounds; then K5's plain functions timed
    alone. Returns the kernels line's entries of K2, K1 + K2, K1 + K2 + K3
    and K3, and those of K2 and K3 at MNIST's and fmow's widths and K3's lr
    route by name."""
    agg = _k2_phase()
    fused, fold, more = _k1k2_phase()
    ev, ev_entries = _k3_phase()
    _k5_phase()
    return agg.pop("fedavg"), fused, fold, ev, dict(ev_entries, **agg,
                                                    **more)


def _launches_by_kernel(kernels) -> dict:
    """The launches in a profile by kernel name (its first 60 characters,
    so kernels of one template family add up under one name), most first:
    which launches a round counts beside K1's and K3's."""
    out = {}
    for e in kernels:
        out[e.key[:60]] = out.get(e.key[:60], 0) + e.count
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _launches(fn, reps: int = 5) -> float:
    kernels, _ = _profile(fn, reps)
    return sum(e.count for e in kernels) / reps


def _reference_accs(path: str | None = None,
                    pinned: tuple | None = None) -> list[float]:
    """Final Test/Acc of each step of a committed reference run (default:
    the canonical ``REF_RUN``, pinned by ``REF_ACCS``). Refuses a file that
    holds more than one run (its rounds do not rise strictly: ``python -m
    feddrift_torch run`` with the default ``--out_dir`` appends to such a
    file) or whose values are not the committed ones."""
    if path is None:
        path, pinned = REF_RUN, REF_ACCS
    final, rounds = {}, []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            rounds.append(rec["round"])
            final[rec["iteration"]] = rec["Test/Acc"]
    accs = [final[t] for t in sorted(final)]
    if rounds != sorted(set(rounds)) or accs != list(pinned):
        raise AssertionError(f"{path} is not the committed reference run "
                             f"(one run, final Test/Acc {pinned}); got "
                             f"rounds {rounds} and final Test/Acc {accs}")
    return accs


def _reset_counts() -> None:
    """Every training kernel's launch count and the plain K2 / K3 / K4
    versions' calls on the card, set to 0 just before a run is driven."""
    from feddrift_torch.kernels.eval_cells import eval_cells, eval_cells_ref
    from feddrift_torch.kernels.fedavg import fedavg, fedavg_ref
    from feddrift_torch.kernels.local_sgd import local_sgd, local_sgd_fedavg
    from feddrift_torch.kernels.lstm_cell import (lstm_cell_bwd,
                                                  lstm_cell_bwd_ref,
                                                  lstm_cell_fwd,
                                                  lstm_cell_fwd_ref)
    from feddrift_torch.kernels.weighted_draw import (weighted_cdf,
                                                      weighted_cdf_ref,
                                                      weighted_search,
                                                      weighted_search_ref)
    from feddrift_torch.kernels.lstm_layer import (lstm_layer_bwd,
                                                   lstm_layer_bwd_ref,
                                                   lstm_layer_fwd,
                                                   lstm_layer_fwd_ref)
    lstm_cell_fwd.launches = lstm_cell_bwd.launches = 0
    lstm_cell_fwd_ref.cuda_calls = lstm_cell_bwd_ref.cuda_calls = 0
    lstm_layer_fwd.launches = lstm_layer_bwd.launches = 0
    lstm_layer_fwd_ref.cuda_calls = lstm_layer_bwd_ref.cuda_calls = 0
    local_sgd.launches = local_sgd_fedavg.launches = 0
    local_sgd.fused_launches = eval_cells.fused_launches = 0
    local_sgd.wide_launches = eval_cells.wide_launches = 0
    local_sgd.split_launches = eval_cells.stream_launches = 0
    local_sgd_fedavg.evals = 0
    weighted_cdf.launches = weighted_search.launches = 0
    fedavg.launches = eval_cells.launches = 0
    fedavg_ref.cuda_calls = eval_cells_ref.cuda_calls = 0
    weighted_cdf_ref.cuda_calls = weighted_search_ref.cuda_calls = 0


def _read_counts() -> dict:
    """The counts ``_reset_counts`` zeroed, read just after a run. A round
    is aggregated by K1's epilogue (``k2_epilogues``, the fused route) or
    by its own ``fedavg.cu`` launch (``k2_launches``, the general route).
    ``local_sgd.launches`` counts every K1 launch, with an epilogue or
    without; ``k1_without_epilogue`` the latter alone; ``k1_fused_launches``
    those of the fused kernel, ``k1_wide_launches`` the wide kernel's,
    ``k1_split_launches`` the split kernel's and ``k1_general_launches`` the
    rest. An eval runs in a K1 launch (``folded_evals``) or as its own K3
    launch (``k3_launches``; on the fused kernel ``k3_fused_launches``, on
    the wide one ``k3_wide_launches``, of which ``k3_stream_launches`` on
    its streamed kernel). An LSTM layer on the layer kernels launches
    ``lstm_layer_fwd`` once and, in training, ``lstm_layer_bwd`` once; on
    the per-step route each step's cell launches ``lstm_cell_fwd`` once
    and, in training, ``lstm_cell_bwd`` once."""
    from feddrift_torch.kernels.eval_cells import eval_cells, eval_cells_ref
    from feddrift_torch.kernels.fedavg import fedavg, fedavg_ref
    from feddrift_torch.kernels.local_sgd import local_sgd, local_sgd_fedavg
    from feddrift_torch.kernels.lstm_cell import (lstm_cell_bwd,
                                                  lstm_cell_bwd_ref,
                                                  lstm_cell_fwd,
                                                  lstm_cell_fwd_ref)
    from feddrift_torch.kernels.lstm_layer import (lstm_layer_bwd,
                                                   lstm_layer_bwd_ref,
                                                   lstm_layer_fwd,
                                                   lstm_layer_fwd_ref)
    from feddrift_torch.kernels.weighted_draw import (weighted_cdf,
                                                      weighted_cdf_ref,
                                                      weighted_search,
                                                      weighted_search_ref)
    return {"k1_launches": local_sgd.launches,
            "k1_without_epilogue":
            local_sgd.launches - local_sgd_fedavg.launches,
            "k1_fused_launches": local_sgd.fused_launches,
            "k1_wide_launches": local_sgd.wide_launches,
            "k1_split_launches": local_sgd.split_launches,
            "k1_general_launches": local_sgd.launches
            - local_sgd.fused_launches - local_sgd.wide_launches
            - local_sgd.split_launches,
            "k4a_launches": weighted_cdf.launches,
            "k4b_launches": weighted_search.launches,
            "k2_launches": fedavg.launches,
            "k2_epilogues": local_sgd_fedavg.launches,
            "aggregations": fedavg.launches + local_sgd_fedavg.launches,
            "k3_launches": eval_cells.launches,
            "k3_fused_launches": eval_cells.fused_launches,
            "k3_wide_launches": eval_cells.wide_launches,
            "k3_stream_launches": eval_cells.stream_launches,
            "folded_evals": local_sgd_fedavg.evals,
            "lstm_cell_fwd_launches": lstm_cell_fwd.launches,
            "lstm_cell_bwd_launches": lstm_cell_bwd.launches,
            "lstm_layer_fwd_launches": lstm_layer_fwd.launches,
            "lstm_layer_bwd_launches": lstm_layer_bwd.launches,
            "plain_calls": {"fedavg_ref": fedavg_ref.cuda_calls,
                            "lstm_cell_fwd_ref": lstm_cell_fwd_ref.cuda_calls,
                            "lstm_cell_bwd_ref": lstm_cell_bwd_ref.cuda_calls,
                            "lstm_layer_fwd_ref":
                            lstm_layer_fwd_ref.cuda_calls,
                            "lstm_layer_bwd_ref":
                            lstm_layer_bwd_ref.cuda_calls,
                            "eval_cells_ref": eval_cells_ref.cuda_calls,
                            "weighted_cdf_ref": weighted_cdf_ref.cuda_calls,
                            "weighted_search_ref":
                            weighted_search_ref.cuda_calls}}


def _check_k2_k3(name: str, got: dict, rounds: int,
                 k2_launches: int = 0) -> None:
    """K2 aggregated every round once (by K1's epilogue, or by
    ``k2_launches`` launches of its own on the general route), K3 ran, and
    no plain K2 / K3 / K4 ran on the card."""
    if got["aggregations"] != rounds or got["k2_launches"] != k2_launches \
            or got["k3_launches"] < 1 or any(got["plain_calls"].values()):
        raise AssertionError(f"{name}: K2 aggregated {got['aggregations']} "
                             f"times for {rounds} rounds ("
                             f"{got['k2_launches']} launches of its own, "
                             f"want {k2_launches}), K3 launched "
                             f"{got['k3_launches']} times, plain calls on "
                             f"the card {got['plain_calls']}")


def _check_evals(name: str, got: dict, cfg, exp, fused_steps: int,
                 folds: bool) -> None:
    """``folds``: whether the run's shape must let K1 fold an eval
    (``_folds_eval``); a shape that does otherwise fails. Where it folds,
    each of its ``fused_steps`` fused steps folded every eval but its final
    one into the next round's K1 launch; every other eval (a fused step's
    last, each of a per-round step's, all of them where the shape does not
    fold) was a K3 launch of its own."""
    from feddrift_torch.core.step import TrainStep
    from feddrift_torch.kernels.local_sgd import _folds_eval
    mod, N = exp.step.module, exp.x.shape[2]
    if _folds_eval(mod.in_dim, mod.hidden_dim, mod.num_classes,
                   min(cfg.batch_size, N), N, cfg.client_optimizer) != folds:
        raise AssertionError(f"{name}: _folds_eval is not {folds} at "
                             f"this run's shape: evals folded wrongly")
    E = len(TrainStep.eval_rounds(cfg.comm_round, cfg.frequency_of_the_test))
    folded = fused_steps * (E - 1) if folds else 0
    standalone = cfg.train_iterations * E - folded
    if got["folded_evals"] != folded or got["k3_launches"] < standalone:
        raise AssertionError(f"{name}: {got['folded_evals']} evals folded "
                             f"into K1 (want {folded}: {fused_steps} fused "
                             f"steps, fold {folds}), {got['k3_launches']} K3 "
                             f"launches (want at least {standalone})")


def phase_train(fused_entry: dict, fold_entry: dict,
                eval_entry: dict) -> None:
    import tempfile

    import torch
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.simulation.runner import Experiment
    from feddrift_torch.utils.prng import iteration_seed
    cfg = ExperimentConfig()
    ref = _reference_accs()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        exp = Experiment(cfg, out_dir=out_dir)
        setup_s = time.perf_counter() - t0
        _reset_counts()
        t0 = time.perf_counter()
        exp.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        launches = counts["k1_launches"]
        ckpt = os.path.isfile(os.path.join(out_dir, "ckpt", "MANIFEST.json"))
        ends = exp.events.events("iteration_end")
        models = [e["num_models"] for e in exp.events.events("cluster_state")]
        final = {}
        for rec in exp.logger.history:
            final[rec["iteration"]] = rec["Test/Acc"]
        accs = [final[t] for t in sorted(final)]
        for t, e in enumerate(ends):
            _say("train_step", iteration=t, wall_s=e["wall_s"],
                 rounds_per_s=e["rounds_per_s"], test_acc=accs[t],
                 reference_test_acc=ref[t], models_in_use=models[t])
        # each fused launch stands in one row: with a folded eval in the
        # fold's, without one in K1 + K2's
        fused_entry["launches"] = counts["k2_epilogues"] \
            - counts["folded_evals"]
        fold_entry["launches"] = counts["folded_evals"]
        eval_entry["launches"] = counts["k3_launches"]
        # one more time step under the profiler: where its wall goes
        R, freq = cfg.comm_round, cfg.frequency_of_the_test
        T = cfg.train_iterations
        params = exp.pool.params
        opt = exp.step.init_opt_states(params, exp.pool.num_models, exp.C_)
        tw = exp.algo.round_inputs(T - 1, 0)[0]
        exp.step.generator.manual_seed(iteration_seed(cfg.seed, T - 1))
        # the step alone: no copy of the state inside the profiled window
        kernels, prof_us = _profile(
            lambda: exp.step.train_iteration_eval(
                params, opt, exp.x, exp.y, tw, 1.0, R, freq, T - 1), 1)
        busy_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        mean_acc = sum(accs) / len(accs)
        ref_mean = sum(ref) / len(ref)
        diffs = [a - b for a, b in zip(accs, ref)]
        route = _run_route(cfg, exp)
        _say("train", dataset=cfg.dataset, model=cfg.model,
             algo=cfg.concept_drift_algo, algo_arg=cfg.concept_drift_algo_arg,
             steps=len(ends), rounds=exp.global_round, setup_s=setup_s,
             wall_s=wall, local_sgd_launches=launches,
             k1_without_epilogue=counts["k1_without_epilogue"],
             local_sgd_route=route, aggregations=counts["aggregations"],
             k2_epilogues=counts["k2_epilogues"],
             fedavg_launches=counts["k2_launches"],
             eval_cells_launches=counts["k3_launches"],
             folded_evals=counts["folded_evals"],
             k4a_launches=counts["k4a_launches"],
             k4b_launches=counts["k4b_launches"],
             plain_calls=counts["plain_calls"], checkpoint=ckpt,
             test_acc_mean=mean_acc, reference_mean=ref_mean,
             max_step_diff=max(map(abs, diffs)),
             profiled_step_wall_ms=prof_us / 1e3,
             profiled_step_device_busy_ms=busy_us / 1e3,
             device_busy_share=busy_us / prof_us if busy_us
             else "not measured",
             kernel_launches_per_round=sum(e.count for e in kernels) / R,
             device_ms_per_round=busy_us / R / 1e3 if busy_us
             else "not measured",
             top_kernels_us_per_round={e.key[:60]: e.self_device_time_total / R
                                       for e in top},
             launches_a_step_by_kernel=_launches_by_kernel(kernels))
        want = cfg.train_iterations * cfg.comm_round
        if len(ends) != cfg.train_iterations or len(accs) != len(ref):
            raise AssertionError(f"{len(ends)} of {cfg.train_iterations} "
                                 f"steps ran")
        if not ckpt:
            raise AssertionError("no checkpoint was written")
        if launches != want or route != "fused":
            raise AssertionError(f"local_sgd launched {launches} times for "
                                 f"{want} rounds, through the {route} "
                                 f"kernel")
        _check_k2_k3("train", counts, want)
        _check_evals("train", counts, cfg, exp, cfg.train_iterations,
                     folds=True)
        if counts["k4a_launches"] or counts["k4b_launches"]:
            raise AssertionError(f"K4 launched in a run without weighted "
                                 f"sampling: {counts}")
        if max(map(abs, diffs)) > STEP_ACC_TOL \
                or abs(mean_acc - ref_mean) > MEAN_ACC_TOL:
            raise AssertionError(f"Test/Acc per step {accs} against the "
                                 f"reference {ref}")


def _experiment(cfg, out_dir=None, init=None):
    """An ``Experiment`` of ``cfg`` on the card; ``init`` (a flat dict of
    one model's params, as ``CFL_REFERENCE_INIT``) replaces its initial
    params in every slot and as the reinit target."""
    import torch
    from feddrift_torch.simulation.runner import Experiment
    exp = Experiment(cfg, out_dir=out_dir)
    if init is not None:
        pool = exp.pool
        pool.init_params = {
            k: torch.as_tensor(init[k], dtype=v.dtype, device=v.device)
            for k, v in pool.init_params.items()}
        pool.params = {k: v[None].expand(pool.num_models, *v.shape).clone()
                       for k, v in pool.init_params.items()}
    return exp


def _drive(cfg, out_dir=None, init=None, syncs: bool = True) -> dict:
    """Run one ``Experiment`` of ``cfg`` on the card through its entry point
    and report what carried it: which path each step took, the launches of
    K1, K2 (and its epilogues), K3, K4a and K4b and the plain K2 / K3 / K4
    versions' calls on the card
    (every count set to 0 just before the run and read just after), and the
    wall. Host syncs are counted in a second run of the same configuration
    (``_host_syncs_per_round``), so that the count's cost stays out of the
    timed one; ``syncs=False`` makes no second run (None)."""
    import tempfile

    import torch
    exp = _experiment(cfg, out_dir, init)
    paths = []

    def path(name, fn):
        def inner(t, opt):
            paths.append(name)
            return fn(t, opt)
        return inner
    exp._run_iteration_fused = path("fused", exp._run_iteration_fused)
    exp._run_rounds = path("per_round", exp._run_rounds)
    _reset_counts()
    t0 = time.perf_counter()
    exp.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    rounds = cfg.train_iterations * cfg.comm_round
    final = {}
    for rec in exp.logger.history:
        final[rec["iteration"]] = rec
    models = [e["num_models"] for e in exp.events.events("cluster_state")]
    if not syncs:
        syncs = None
    elif out_dir is None:
        syncs = _host_syncs_per_round(cfg, None, init)
    else:
        with tempfile.TemporaryDirectory() as sync_dir:
            syncs = _host_syncs_per_round(cfg, sync_dir, init)
    return {"exp": exp, "wall_s": wall, "paths": list(paths), **counts,
            "host_syncs_per_round": syncs,
            "rounds_per_s": rounds / wall,
            "step_wall_s": [e["wall_s"] for e in
                            exp.events.events("iteration_end")],
            "accs": [final[t]["Test/Acc"] for t in sorted(final)],
            "assignment": [_assignment(final[t]) for t in sorted(final)],
            "models_in_use": models or [exp.pool.num_models]
            * cfg.train_iterations}


def _assignment(rec: dict) -> list[int]:
    """Each client's model (``Plurality/CL-c``) in one logged eval."""
    return [rec[f"Plurality/CL-{c}"] for c in range(
        sum(k.startswith("Plurality/CL-") for k in rec))]


def _host_syncs_per_round(cfg, out_dir=None, init=None):
    """Host syncs a round over a whole run of ``cfg``, untimed: CUDA's sync
    debug mode warns once per synchronising call (None when it recorded
    none)."""
    import warnings

    import torch
    exp = _experiment(cfg, out_dir, init)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            exp.run()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return syncs / (cfg.train_iterations * cfg.comm_round) if syncs \
        else None


def _profile_step(exp, top: bool = False) -> dict:
    """One more time step of a finished run under the profiler, on the path
    its last step took: kernel launches a round (and each kernel's a
    step), the device-busy share and K1's device time a launch; with
    ``top``, the kernels with the most device time a round too
    (``_top_device_ops``)."""
    T, R = exp.cfg.train_iterations, exp.cfg.comm_round
    opt = exp.step.init_opt_states(exp.pool.params, exp.pool.num_models,
                                   exp.C_)
    fused = exp.cfg.chunk_rounds and exp.algo.chunkable(T - 1)
    run = exp._run_iteration_fused if fused else exp._run_rounds
    # the step alone: no copy of the state inside the profiled window
    kernels, wall_us, union_us = _profile(lambda: run(T - 1, opt), 1,
                                          union=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    out = {"launches_per_round": sum(e.count for e in kernels) / R,
           "device_busy_share": busy_us / wall_us if busy_us
           else "not measured",
           "device_ms_per_round": busy_us / R / 1e3 if busy_us
           else "not measured"}
    for name, tag in (("k1", "local_sgd"), ("k2", "fedavg_kernel"),
                      ("k3", "eval_"), ("k4a", "weighted_cdf"),
                      ("k4b", "weighted_search")):
        ks = [e for e in kernels if tag in e.key]
        us = sum(e.self_device_time_total for e in ks)
        out[f"{name}_device_ms"] = us / sum(e.count for e in ks) / 1e3 \
            if us else "not measured"
    out["profiled_step_wall_ms"] = wall_us / 1e3
    out["launches_a_step_by_kernel"] = _launches_by_kernel(kernels)
    if top:
        out["top_device_ops_a_round"] = _top_device_ops(kernels, R)
        out["device_union_ms_per_round"] = union_us / R / 1e3
        out["device_union_share"] = union_us / wall_us
    return out


def _reference_assignment(path: str) -> list[list[int]]:
    """Each client's model at the final eval of every step of a committed
    run (``_reference_accs`` has checked that the file is that run)."""
    final = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            final[rec["iteration"]] = rec
    return [_assignment(final[t]) for t in sorted(final)]


def phase_train_algos(cdf_entry: dict, search_entry: dict) -> None:
    """Every algorithm of ``ALGO_RUNS`` at full width against its committed
    SEA run. Besides the numbers, each line prints the card's decisions
    (each client's model at each step's final eval) beside the committed
    run's, and the run's own decision events; KUE's line counts K4a's and
    K4b's launches, which the kernels line reports."""
    import tempfile

    from feddrift_torch.config import ExperimentConfig
    here = os.path.dirname(os.path.abspath(__file__))
    for algo, arg, want_path, run, pinned in ALGO_RUNS:
        ref_path = os.path.join(here, "runs", run, "metrics.jsonl")
        ref = _reference_accs(ref_path, pinned)
        cfg = ExperimentConfig(concept_drift_algo=algo,
                               concept_drift_algo_arg=arg)
        cfl = arg.startswith("cfl")
        with tempfile.TemporaryDirectory() as out_dir:
            got = _drive(cfg, out_dir, CFL_REFERENCE_INIT if cfl else None)
            exp, accs = got.pop("exp"), got["accs"]
            prof = _profile_step(exp)
        diffs = [a - b for a, b in zip(accs, ref)]
        mean, ref_mean = sum(accs) / len(accs), sum(ref) / len(ref)
        paths = set(got["paths"])
        held = {"assignment": got["assignment"],
                "committed_assignment": _reference_assignment(ref_path),
                "decision_events": {
                    k: len(exp.events.events(k)) for k in (
                        "drift_detected", "cluster_create", "cluster_split",
                        "model_replaced")}}
        splits = exp.events.events("cluster_split")
        if splits:
            held["splits"] = [[e.get(k) for k in SPLIT_KEYS] for e in splits]
        if cfl:
            held.update(init="reference",
                        first_split=held["splits"][0] if splits else None,
                        reference_assignment=[list(a)
                                              for a in CFL_ASSIGNMENT])
        if algo == "driftsurf":
            held["driftsurf_state"] = exp.algo.state
        if algo == "kue":
            held.update(k4a_launches=got["k4a_launches"],
                        k4b_launches=got["k4b_launches"],
                        kappas=[float(k) for k in exp.algo.ens_weights])
        _say("train_algo", algo=algo, arg=arg, models=exp.pool.num_models,
             path=want_path if paths == {want_path} else sorted(paths),
             wall_s=got["wall_s"], rounds_per_s=got["rounds_per_s"],
             step_wall_s=got["step_wall_s"], k1_launches=got["k1_launches"],
             aggregations=got["aggregations"],
             k2_epilogues=got["k2_epilogues"], k2_launches=got["k2_launches"],
             k3_launches=got["k3_launches"], folded_evals=got["folded_evals"],
             plain_calls=got["plain_calls"],
             host_syncs_per_round=got["host_syncs_per_round"] or
             "not measured", models_in_use=got["models_in_use"],
             test_acc=accs, reference_test_acc=ref, test_acc_mean=mean,
             reference_mean=ref_mean,
             max_step_diff=max(map(abs, diffs)) if diffs else None,
             reference_run=run, **held, **prof)
        want = cfg.train_iterations * cfg.comm_round
        if got["k1_launches"] != want or paths != {want_path} \
                or len(accs) != len(ref):
            raise AssertionError(f"{algo} {arg}: K1 launched "
                                 f"{got['k1_launches']} times for {want} "
                                 f"rounds on paths {paths} (want "
                                 f"{want_path}), {len(accs)} steps")
        kue = algo == "kue"
        if (got["k4a_launches"], got["k4b_launches"]) != (
                (cfg.train_iterations, want) if kue else (0, 0)):
            raise AssertionError(f"{algo}: K4a launched "
                                 f"{got['k4a_launches']} times in "
                                 f"{cfg.train_iterations} steps, K4b "
                                 f"{got['k4b_launches']} in {want} rounds")
        _check_k2_k3(f"{algo} {arg}", got, want)
        _check_evals(f"{algo} {arg}", got, cfg, exp,
                     got["paths"].count("fused"), folds=True)
        if kue:
            cdf_entry["launches"] = got["k4a_launches"]
            search_entry["launches"] = got["k4b_launches"]
        if max(map(abs, diffs)) > STEP_ACC_TOL \
                or abs(mean - ref_mean) > MEAN_ACC_TOL:
            raise AssertionError(f"{algo} {arg}: Test/Acc per step {accs} "
                                 f"against the reference {ref}")
        # CFL's clusters: from the reference's init, step 0 splits in the
        # reference's round into the reference's clusters, which are the
        # committed run's too
        if cfl and (held["first_split"] != list(CFL_FIRST_SPLIT)
                    or got["assignment"][0] != list(CFL_ASSIGNMENT[0])
                    or got["assignment"][0]
                    != held["committed_assignment"][0]):
            raise AssertionError(
                f"{arg}: first split {held['first_split']} (the "
                f"reference's {CFL_FIRST_SPLIT}); clients' models per step "
                f"{got['assignment']}, the reference's "
                f"{held['reference_assignment']}, the committed run's "
                f"{held['committed_assignment']}")


def phase_train_sampling() -> None:
    import dataclasses

    import numpy as np
    import torch
    from feddrift_torch.config import ExperimentConfig
    cfg = ExperimentConfig(client_num_per_round=4, train_iterations=2,
                           comm_round=50)
    runs, seen = {}, {}
    for name, c in (("fused", cfg),
                    ("per_round", dataclasses.replace(cfg,
                                                      chunk_rounds=False)),
                    ("all_clients", dataclasses.replace(
                        cfg, client_num_per_round=10))):
        got = runs[name] = _drive(c)
        _say("train_sampling", run=name, k=c.client_num_per_round,
             paths=got["paths"], wall_s=got["wall_s"],
             rounds_per_s=got["rounds_per_s"], k1_launches=got["k1_launches"],
             aggregations=got["aggregations"],
             k2_epilogues=got["k2_epilogues"], k2_launches=got["k2_launches"],
             k3_launches=got["k3_launches"], folded_evals=got["folded_evals"],
             plain_calls=got["plain_calls"],
             host_syncs_per_round=got["host_syncs_per_round"] or
             "not measured", test_acc=got["accs"])
        if got["k1_launches"] != c.train_iterations * c.comm_round:
            raise AssertionError(f"{name}: K1 launched {got['k1_launches']}"
                                 f" times")
        _check_k2_k3(name, got, c.train_iterations * c.comm_round)
        _check_evals(name, got, c, got["exp"], got["paths"].count("fused"),
                     folds=True)
    series = {k: [(r["round"], r["Test/Acc"]) for r in
                  v["exp"].logger.history] for k, v in runs.items()}
    pools = {k: v["exp"].pool.params for k, v in runs.items()}
    same_pool = all(torch.equal(v, pools["per_round"][k])
                    for k, v in pools["fused"].items())
    # one round on the host: n of the clients the mask leaves out
    exp = runs["per_round"]["exp"]
    masks = exp._client_masks(range(cfg.comm_round))
    r = min(7, cfg.comm_round - 1)
    tw = exp.algo.round_inputs(cfg.train_iterations - 1, r)[0]
    opt = exp.step.init_opt_states(exp.pool.params, exp.pool.num_models,
                                   exp.C_)
    mask = torch.from_numpy(masks[r]).to(exp.device)
    n = exp.step.train_round(exp.pool.params, opt, exp.x, exp.y, tw, 1.0,
                             mask)[3].cpu()
    out = masks[r] == 0
    n_ok = bool((n[:, out] == 0).all() and (n[0, ~out] > 0).all())
    _say("train_sampling", series_bitwise=series["fused"]
         == series["per_round"], pools_bitwise=same_pool,
         differs_from_k10=series["fused"] != series["all_clients"],
         checked_round=r, sampled=np.nonzero(masks[r])[0].tolist(),
         unsampled_n_zero=n_ok)
    if series["fused"] != series["per_round"] or not same_pool \
            or series["fused"] == series["all_clients"] or not n_ok:
        raise AssertionError("client sampling: the fused and per-round "
                             "paths disagree, sampling changed nothing, or "
                             "an unsampled client reported samples")


def phase_train_per_round_kinds() -> None:
    import math

    from feddrift_torch.config import ExperimentConfig
    for algo, arg, want_path in PER_ROUND_KINDS:
        cfg = ExperimentConfig(concept_drift_algo=algo,
                               concept_drift_algo_arg=arg,
                               train_iterations=3, comm_round=20)
        got = _drive(cfg)
        paths = set(got["paths"])
        finite = all(math.isfinite(v) for rec in got["exp"].logger.history
                     for k, v in rec.items() if "/" in k)
        _say("train_per_round_kind", algo=algo, arg=arg,
             path=want_path if paths == {want_path} else sorted(paths),
             wall_s=got["wall_s"], rounds_per_s=got["rounds_per_s"],
             k1_launches=got["k1_launches"], aggregations=got["aggregations"],
             k2_epilogues=got["k2_epilogues"], k2_launches=got["k2_launches"],
             k3_launches=got["k3_launches"], folded_evals=got["folded_evals"],
             plain_calls=got["plain_calls"],
             host_syncs_per_round=got["host_syncs_per_round"] or
             "not measured", models_in_use=got["models_in_use"],
             test_acc=got["accs"], finite=finite)
        if got["k1_launches"] != cfg.train_iterations * cfg.comm_round \
                or paths != {want_path} or not finite:
            raise AssertionError(f"{algo} {arg}: K1 launched "
                                 f"{got['k1_launches']} times on paths "
                                 f"{paths} (want {want_path}), finite "
                                 f"{finite}")
        _check_k2_k3(f"{algo} {arg}", got,
                     cfg.train_iterations * cfg.comm_round)
        _check_evals(f"{algo} {arg}", got, cfg, got["exp"],
                     got["paths"].count("fused"), folds=True)


def _run_route(cfg, exp) -> str:
    """The K1 route ``_route`` gives a run's shape, model and update."""
    from feddrift_torch.kernels.local_sgd import _route
    mod = exp.step.module
    return _route(mod.in_dim, mod.hidden_dim, mod.num_classes,
                  min(cfg.batch_size, exp.x.shape[2]), cfg.client_optimizer)


def _check_general_run(name: str, got: dict, cfg, exp, rounds: int,
                       route: str = "general", k3: str | None = None) -> None:
    """A run on K1's ``route``, the general, wide or split one (no
    epilogue): every round one K1 launch without an epilogue on that kernel
    (the wide one: every launch counted as wide, the split one as split;
    the general one: neither) and one ``fedavg.cu`` launch, every eval a K3
    launch (none folded) on K3's route ``k3``: ``"wide"`` every one the
    wide K3 kernel's on its resident tiles, ``"stream"`` on its streamed
    kernel, ``"general"`` none of either (by default K1's route says:
    general, wide, or for split the streamed kernel); no K4, no plain K2 /
    K3 / K4 call on the card, every step on the fused path."""
    got_route = _run_route(cfg, exp)
    k3 = k3 or {"split": "stream"}.get(route, route)
    wide = rounds if route == "wide" else 0
    split = rounds if route == "split" else 0
    k3_wide = got["k3_launches"] if k3 in ("wide", "stream") else 0
    k3_stream = got["k3_launches"] if k3 == "stream" else 0
    if got_route != route or got["k1_launches"] != rounds \
            or got["k1_without_epilogue"] != rounds \
            or got["k1_wide_launches"] != wide \
            or got["k1_split_launches"] != split \
            or got["k3_wide_launches"] != k3_wide \
            or got["k3_stream_launches"] != k3_stream \
            or set(got["paths"]) != {"fused"} \
            or got["k4a_launches"] or got["k4b_launches"]:
        raise AssertionError(f"{name}: route {got_route} (want {route}), K1 "
                             f"launched {got['k1_launches']} times "
                             f"({got['k1_without_epilogue']} without an "
                             f"epilogue, {got['k1_wide_launches']} wide, "
                             f"{got['k1_split_launches']} split) "
                             f"for {rounds} rounds on paths "
                             f"{set(got['paths'])}, K3 "
                             f"{got['k3_launches']} ({got['k3_wide_launches']}"
                             f" wide, {got['k3_stream_launches']} "
                             f"streamed), K4 {got['k4a_launches']} / "
                             f"{got['k4b_launches']}")
    _check_k2_k3(name, got, rounds, k2_launches=rounds)
    _check_evals(name, got, cfg, exp, got["paths"].count("fused"),
                 folds=False)


def _check_fused_tabular_run(name: str, got: dict, cfg, exp,
                             rounds: int) -> None:
    """A run on the fused route at a width where K1's fused kernel folds a
    row's values in chunks (susy's, ro's), checked as ``phase_train``
    checks SEA's: every round one launch of K1's fused kernel with K2 as
    its epilogue (no ``fedavg.cu`` launch, no general, wide or split K1
    launch), each fused step's evals but its last folded into K1's
    launches and that last one a launch of K3's fused kernel (no other K3
    kernel), no K4, no plain K2 / K3 / K4 call on the card."""
    got_route = _run_route(cfg, exp)
    if got_route != "fused" or got["k1_launches"] != rounds \
            or got["k1_fused_launches"] != rounds \
            or got["k2_epilogues"] != rounds \
            or got["k1_general_launches"] or got["k1_wide_launches"] \
            or got["k1_split_launches"] \
            or got["k3_fused_launches"] != got["k3_launches"] \
            or set(got["paths"]) != {"fused"} \
            or got["k4a_launches"] or got["k4b_launches"]:
        raise AssertionError(f"{name}: route {got_route} (want fused), K1 "
                             f"launched {got['k1_launches']} times "
                             f"({got['k1_fused_launches']} fused, "
                             f"{got['k2_epilogues']} with the epilogue, "
                             f"{got['k1_general_launches']} general) for "
                             f"{rounds} rounds on paths "
                             f"{set(got['paths'])}, K3 "
                             f"{got['k3_launches']} "
                             f"({got['k3_fused_launches']} fused), K4 "
                             f"{got['k4a_launches']} / "
                             f"{got['k4b_launches']}")
    _check_k2_k3(name, got, rounds)
    _check_evals(name, got, cfg, exp, got["paths"].count("fused"),
                 folds=True)


def _image_runs(phase: str, dataset: str, runs, init_path: str,
                feature_shape: tuple, classes: int, route: str,
                entries: dict, names: tuple | None,
                reference: dict | None = None,
                k3: str | None = None) -> list[str]:
    """``runs`` of a dataset at full width (B = N = 500, C 10, R 200, an
    eval every 5 rounds) from the reference's init ``init_path``, each gated
    against its committed run or, where ``reference`` holds the run's
    algorithm, against that series (the JAX package's run from the same
    init), the committed run printed beside where there is one: K1 on
    ``route`` every round, one ``fedavg.cu`` launch a round, one K3 launch
    an eval on K3's route ``k3`` (``_check_general_run``), no folded eval,
    no plain call; on the fused route (susy's and ro's widths) every round
    one K1 launch with K2 as its epilogue and every eval but a step's last
    folded into it (``_check_fused_tabular_run``). One ``phase`` line a
    run: the wall, the launches,
    launches and device ms a round of one profiled step, and each step's
    Test/Acc and models used beside the gate's. A clustering run's step
    more than DECISION_GAP from the committed one prints both runs'
    decisions on a ``<phase>_decision`` line. Every run is driven and
    reported (``within_gate``); the runs outside their gates are returned,
    for the phase to fail on once it has driven the rest. The kernels
    line's K1, K2 and K3 entries ``names`` (None: none) take their
    launches from these runs."""
    import numpy as np
    import torch
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.models.mlp import FeedForwardNN
    here = os.path.dirname(os.path.abspath(__file__))
    init = FeedForwardNN(feature_shape, classes, 10).unpack(
        torch.from_numpy(np.load(init_path)))
    launches = {"k1": 0, "k2": 0, "k3": 0}
    missed = []
    for algo, arg, pool, T, run, pinned, step_tol, mean_tol in runs:
        ref = ref_assign = None
        if run is not None:
            ref_path = os.path.join(here, "runs", run, "metrics.jsonl")
            ref = _reference_accs(ref_path, pinned)[:T]
            ref_assign = _reference_assignment(ref_path)[:T]
        gated = "reference" if reference and algo in reference \
            else "committed"
        gate = list(reference[algo] if gated == "reference" else ref)[:T]
        cfg = ExperimentConfig(dataset=dataset, concept_drift_algo=algo,
                               concept_drift_algo_arg=arg, concept_num=pool,
                               train_iterations=T)
        got = _drive(cfg, init=init, syncs=False)
        exp, accs = got.pop("exp"), got["accs"]
        prof = _profile_step(exp)
        rounds = T * cfg.comm_round
        gate_diffs = [a - b for a, b in zip(accs, gate)]
        mean, gate_mean = sum(accs) / len(accs), sum(gate) / len(gate)
        used = [len(set(a)) for a in got["assignment"]]
        within = not ((step_tol is not None and max(map(abs, gate_diffs))
                       > step_tol) or abs(mean - gate_mean) > mean_tol)
        committed = {}
        if ref is not None:
            diffs = [a - b for a, b in zip(accs, ref)]
            committed = dict(
                committed_models_used=[len(set(a)) for a in ref_assign],
                committed_test_acc=ref,
                committed_mean=sum(ref) / len(ref),
                max_step_diff_committed=max(map(abs, diffs)))
        _say(phase, dataset=dataset, algo=algo, arg=arg,
             models=exp.pool.num_models, init="reference", steps=T,
             rounds=rounds, wall_s=got["wall_s"],
             rounds_per_s=got["rounds_per_s"], step_wall_s=got["step_wall_s"],
             k1_launches=got["k1_launches"],
             k1_without_epilogue=got["k1_without_epilogue"],
             k1_fused_launches=got["k1_fused_launches"],
             k1_wide_launches=got["k1_wide_launches"],
             k1_split_launches=got["k1_split_launches"],
             k1_general_launches=got["k1_general_launches"],
             fedavg_launches=got["k2_launches"],
             k2_epilogues=got["k2_epilogues"],
             k3_launches=got["k3_launches"],
             k3_fused_launches=got["k3_fused_launches"],
             k3_wide_launches=got["k3_wide_launches"],
             k3_stream_launches=got["k3_stream_launches"],
             folded_evals=got["folded_evals"],
             plain_calls=got["plain_calls"],
             models_in_use=got["models_in_use"], models_used=used,
             test_acc=accs, test_acc_mean=mean, gated_against=gated,
             reference_test_acc=gate, reference_mean=gate_mean,
             mean_tol=mean_tol, step_tol=step_tol,
             max_step_diff=max(map(abs, gate_diffs)), within_gate=within,
             reference_run=run, **committed, **prof)
        for t, d in enumerate(diffs if ref is not None else ()):
            if step_tol is None and abs(d) > DECISION_GAP:
                _say(f"{phase}_decision", algo=algo, arg=arg, step=t,
                     test_acc=accs[t], committed_test_acc=ref[t],
                     models_in_use=got["models_in_use"][t],
                     models_used=used[t],
                     committed_models_used=len(set(ref_assign[t])),
                     assignment=got["assignment"][t],
                     committed_assignment=ref_assign[t])
        name = f"{dataset} {algo} {arg}"
        if route == "fused":
            _check_fused_tabular_run(name, got, cfg, exp, rounds)
        else:
            _check_general_run(name, got, cfg, exp, rounds, route=route,
                               k3=k3)
        if len(accs) != T:
            raise AssertionError(f"{name}: {len(accs)} of {T} steps ran")
        if route == "fused":      # K1 + K2 alone, with the eval, K3
            launches["k1"] += got["k2_epilogues"] - got["folded_evals"]
            launches["k2"] += got["folded_evals"]
        else:                     # K1, fedavg.cu, K3
            launches["k1"] += got["k1_launches"]
            launches["k2"] += got["k2_launches"]
        launches["k3"] += got["k3_launches"]
        if not within:
            missed.append(f"{name}: Test/Acc per step {accs} against "
                          f"{gate} (step tolerance {step_tol}, mean "
                          f"{mean_tol})")
    for key, entry in zip(("k1", "k2", "k3"), names or ()):
        if entry is not None:
            entries[entry]["launches"] = launches[key]
    return missed


def phase_train_mnist(entries: dict) -> None:
    """MNIST-4 at full width (F 784, H 10, K 10) for each of
    ``MNIST_RUNS``: K1's and K3's wide kernels on every round and eval (K1
    2000 launches a 10-step run, ``fedavg.cu`` as many, K3 41 a step)."""
    missed = _image_runs("train_mnist", "MNIST", MNIST_RUNS,
                         MNIST_REFERENCE_INIT, (784,), 10, "wide", entries,
                         ("local_sgd_wide", "fedavg_mnist",
                          "eval_cells_wide"))
    if missed:
        raise AssertionError("; ".join(missed))


def phase_train_fmow(entries: dict) -> None:
    """FMoW at full width (images 32 x 32 x 3, F 3072, H 10, K 62) for each
    of ``FMOW_RUNS``: K1's split kernel on every round, K3's streamed
    kernel at every eval (K1 2000 launches a 10-step run,
    ``fedavg.cu`` as many, K3 41 a step)."""
    missed = _image_runs("train_fmow", "fmow", FMOW_RUNS, FMOW_REFERENCE_INIT,
                         (32, 32, 3), 62, "split", entries,
                         ("local_sgd_split", "fedavg_fmow",
                          "eval_cells_stream"),
                         reference=FMOW_REFERENCE_ACCS)
    if missed:
        raise AssertionError("; ".join(missed))


# the kernels line's K1, K2 and K3 entries that take their launches from a
# dataset's runs in train_tabular and train_images (None: no entry); on the
# fused route K1 + K2 (launches without an eval), K1 + K2 + K3 (those with
# the eval folded in) and K3's own launches
NEW_DATASET_ENTRIES = {
    "susy": ("local_sgd_fedavg_susy", "local_sgd_fedavg_eval_susy",
             "eval_cells_fused_susy"),
    "ro": None,
    "stackoverflow_lr": ("local_sgd_split_padded", None, "eval_cells_wide_so"),
    "femnist": ("local_sgd_wide_k64", None, None),
    "cifar10": ("local_sgd_split_k10", None, None)}


def _new_dataset_runs(phase: str, table: dict, entries: dict) -> None:
    """Each dataset of ``table`` (``TABULAR_RUNS`` or ``IMAGE_RUNS``) through
    ``_image_runs`` on its routes (``NEW_DATASETS``), gated against the JAX
    package's run from the same init where ``NEW_REFERENCE_ACCS`` holds
    one, else against the committed run; fails once every run has been
    driven if any left its gate."""
    missed = []
    for dataset, runs in table.items():
        shape, classes, route, k3 = NEW_DATASETS[dataset]
        missed += _image_runs(phase, dataset, runs, _reference_init(dataset),
                              shape, classes, route, entries,
                              NEW_DATASET_ENTRIES[dataset],
                              reference=NEW_REFERENCE_ACCS.get(dataset),
                              k3=k3)
    if missed:
        raise AssertionError("; ".join(missed))


def phase_train_tabular(entries: dict) -> None:
    """susy (F 18, the fnn 18 -> 10 -> 2) and ro (F 5) on K1's fused kernel
    (2000 launches a run, each with K2 as its epilogue, 400 evals folded
    in, 10 launches of K3's fused kernel), stackoverflow_lr (F 1000, the
    fnn 1000 -> 10 -> 50, AMSGrad) on K1's split kernel padded past F and
    K3's resident wide tiles (K1 2000 launches a run, ``fedavg.cu`` as
    many, K3 41 a step), at full width (``TABULAR_RUNS``), each from its
    reference init."""
    _new_dataset_runs("train_tabular", TABULAR_RUNS, entries)


def phase_train_images(entries: dict) -> None:
    """femnist (the fnn 784 -> 10 -> 62, K1's wide kernel at two classes a
    lane, K3's resident wide tiles) and cifar10 (3072 -> 10 -> 10, K1's
    split kernel, K3's streamed kernel) in softcluster H_A_C_1_10_0 at
    full width (``IMAGE_RUNS``), from their reference inits; then
    ``TrainStep.create`` on the card must refuse cifar100's fnn (3072 ->
    10 -> 100) under AMSGrad and SGD, naming ROADMAP §2's item, before any
    of its data reaches the card."""
    _new_dataset_runs("train_images", IMAGE_RUNS, entries)
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.core.step import TrainStep
    from feddrift_torch.kernels.local_sgd import LAYOUT_ITEM
    from feddrift_torch.models.mlp import FeedForwardNN
    for optimizer in ("adam", "sgd"):
        cfg = ExperimentConfig(dataset=REFUSED_IMAGE_DATASET,
                               client_optimizer=optimizer)
        mod = FeedForwardNN((32, 32, 3), 100, 10)
        try:
            TrainStep.create(cfg, mod, 100, device="cuda")
        except ValueError as err:
            refused = str(err)
        else:
            refused = None
        _say("train_images", refused_dataset=REFUSED_IMAGE_DATASET,
             optimizer=optimizer, refusal=refused)
        if refused is None or LAYOUT_ITEM not in refused:
            raise AssertionError(f"{REFUSED_IMAGE_DATASET}'s fnn under "
                                 f"{optimizer!r} was not refused on the "
                                 f"card naming {LAYOUT_ITEM!r}: {refused}")


def phase_train_lr(entries: dict) -> None:
    """The lr model and the SGD client optimizer through the runner, each
    of ``LR_RUNS`` against the JAX package's own run of it: one
    ``train_lr`` line a run with its launches by kernel (every K1 launch
    on the wide or the general kernel's lr route, a ``fedavg.cu`` launch a
    round, K3's lr route for every eval, no plain call on the card) and
    its Test/Acc per step beside the reference's. The kernels line's lr entries take
    their launches from these runs."""
    import math

    from feddrift_torch.config import ExperimentConfig
    k1 = {"local_sgd_wide_lr": 0, "local_sgd_wide_lr_sgd": 0,
          "local_sgd_general_lr": 0, "local_sgd_general_lr_sgd": 0}
    k3 = {"eval_cells_wide_lr": 0, "eval_cells_general_lr": 0}
    for label, kw, ref, init in LR_RUNS:
        cfg = ExperimentConfig(**kw)
        got = _drive(cfg, init=init, syncs=False)
        exp, accs = got.pop("exp"), got["accs"]
        prof = _profile_step(exp)
        rounds = cfg.train_iterations * cfg.comm_round
        diffs = [a - b for a, b in zip(accs, ref)]
        mean, ref_mean = sum(accs) / len(accs), sum(ref) / len(ref)
        _say("train_lr", run=label, dataset=cfg.dataset, model=cfg.model,
             optimizer=cfg.client_optimizer, init="reference" if init
             else "port", steps=cfg.train_iterations, rounds=rounds,
             wall_s=got["wall_s"], rounds_per_s=got["rounds_per_s"],
             k1_launches=got["k1_launches"],
             k1_without_epilogue=got["k1_without_epilogue"],
             k1_wide_launches=got["k1_wide_launches"],
             fedavg_launches=got["k2_launches"],
             k3_launches=got["k3_launches"],
             k3_wide_launches=got["k3_wide_launches"],
             folded_evals=got["folded_evals"],
             plain_calls=got["plain_calls"], test_acc=accs,
             reference_test_acc=list(ref), test_acc_mean=mean,
             reference_mean=ref_mean, max_step_diff=max(map(abs, diffs)),
             held_steps="step 0" if label in LR_STEP0_RUNS else "all",
             **prof)
        route = "wide" if cfg.dataset == "MNIST" else "general"
        _check_general_run(label, got, cfg, exp, rounds, route=route)
        if exp.step.module.hidden_dim != 0 or len(accs) != len(ref):
            raise AssertionError(f"{label}: not the lr, or {len(accs)} of "
                                 f"{len(ref)} steps")
        k1["local_sgd_" + route + "_lr"
           + ("_sgd" if cfg.client_optimizer == "sgd" else "")] \
            += got["k1_launches"]
        k3["eval_cells_" + route + "_lr"] += got["k3_launches"]
        finite = all(math.isfinite(v) for rec in exp.logger.history
                     for k, v in rec.items() if "/" in k)
        if label in LR_STEP0_RUNS:
            held = abs(diffs[0]) <= STEP_ACC_TOL
        else:
            held = max(map(abs, diffs)) <= STEP_ACC_TOL \
                and abs(mean - ref_mean) <= MEAN_ACC_TOL
        if not (held and finite):
            raise AssertionError(f"{label}: Test/Acc per step {accs} against "
                                 f"the reference's {list(ref)}"
                                 + ("" if finite else ", metrics not finite"))
    for name, n in (*k1.items(), *k3.items()):
        entries[name]["launches"] = n


def phase_train_general(k1_entry: dict, agg_entry: dict) -> None:
    """The general kernel's route, which has no epilogue: the canonical
    configuration at ``fnn_hidden_dim = 32``, T = 2, R = 20 (the fused
    loop, K1's general kernel). Fails unless every round launched K1 and
    ``fedavg.cu`` once each (no epilogue), K3 ran, no plain version ran on
    the card, and the metrics are finite. K1's launches without an
    epilogue and ``fedavg.cu``'s launches here are the kernels line's: on
    the fused route neither runs (K1 launches there with its epilogue,
    ``local_sgd_fedavg``'s entry)."""
    import math

    from feddrift_torch.config import ExperimentConfig
    cfg = ExperimentConfig(fnn_hidden_dim=32, train_iterations=2,
                           comm_round=20)
    got = _drive(cfg)
    exp = got["exp"]
    route = _run_route(cfg, exp)
    rounds = cfg.train_iterations * cfg.comm_round
    finite = all(math.isfinite(v) for rec in exp.logger.history
                 for k, v in rec.items() if "/" in k)
    _say("train_general", hidden=cfg.fnn_hidden_dim, route=route,
         paths=got["paths"], wall_s=got["wall_s"],
         rounds_per_s=got["rounds_per_s"], k1_launches=got["k1_launches"],
         k1_without_epilogue=got["k1_without_epilogue"],
         aggregations=got["aggregations"], k2_epilogues=got["k2_epilogues"],
         k2_launches=got["k2_launches"], k3_launches=got["k3_launches"],
         folded_evals=got["folded_evals"], plain_calls=got["plain_calls"],
         test_acc=got["accs"], finite=finite)
    if not finite:
        raise AssertionError("H = 32: metrics not finite")
    _check_general_run("general route", got, cfg, exp, rounds)
    k1_entry["launches"] = got["k1_without_epilogue"]
    agg_entry["launches"] = got["k2_launches"]


# ---------------------------------------------------------------------------
# NaN semantics: K1 and K3 on a poisoned pool (model 0 a NaN in
# Dense_0/kernel, model 1 an Inf in Dense_1/bias, the lr's in Dense_0/bias)
# against their plain versions: (label, kernel, dataset, model, optimizer,
# forced route); "k1f" is K1 with its K2 epilogue, "fold" the eval folded
# into that launch
NAN_CASES = (("k1_fused_epilogue", "k1f", "sea", "fnn", "adam", None),
             ("k1_general", "k1", "sea", "fnn", "adam", "general"),
             ("k1_wide", "k1", "MNIST", "fnn", "adam", None),
             ("k1_general_lr_sgd", "k1", "sea", "lr", "sgd", None),
             ("k1_general_lr", "k1", "sea", "lr", "adam", None),
             ("k1_wide_lr", "k1", "MNIST", "lr", "adam", None),
             ("k1_wide_lr_sgd", "k1", "MNIST", "lr", "sgd", None),
             ("k3_folded", "fold", "sea", "fnn", "adam", None),
             ("k3_fused", "k3", "sea", "fnn", "adam", None),
             ("k3_general", "k3", "sea", "fnn", "adam", "general"),
             ("k3_wide", "k3", "MNIST", "fnn", "adam", None),
             ("k3_general_lr", "k3", "sea", "lr", "adam", None),
             ("k3_wide_lr", "k3", "MNIST", "lr", "adam", None),
             ("k1_split", "k1", "fmow", "fnn", "adam", None),
             ("k3_stream", "k3", "fmow", "fnn", "adam", None))
# the datasets whose width takes a cluster kernel (K1's wide or split one,
# K3's wide one): each nan_semantics case there launches one
CLUSTER_DATASETS = ("MNIST", "fmow")


def _poison(params, d: dict):
    """A copy of the packed pool with a NaN in model 0's Dense_0/kernel
    [1, 2] and an Inf in model 1's last bias (Dense_1/bias[0], the lr's
    Dense_0/bias[0])."""
    p = params.clone()
    F, H, K = d["F"], d["H"], d["K"]
    width = H or K
    p[0, width + min(2, width - 1)] = float("nan")
    p[1, F * H + H + H * K if H else F * K] = float("inf")
    return p


def _same_finite(got, want) -> tuple[bool, int]:
    """Whether two outputs are finite in the same cells, and the count of
    non-finite cells of the plain one."""
    import torch
    if not got.is_floating_point():
        return bool(torch.equal(got, want)), 0
    a, b = torch.isfinite(got), torch.isfinite(want)
    return bool(torch.equal(a, b)), int((~b).sum())


def phase_nan_semantics() -> None:
    """Each of ``NAN_CASES`` on a poisoned pool: every output of the kernel
    finite in exactly the cells where its plain version's is; K3's counts
    equal (on the poisoned models exactly: the first NaN is the argmax)
    and its NLL sums equal within EVAL_NLL_RTOL where finite."""
    import torch
    from feddrift_torch.kernels.eval_cells import eval_cells, eval_cells_ref
    from feddrift_torch.kernels.local_sgd import (local_sgd,
                                                  local_sgd_fedavg,
                                                  local_sgd_fedavg_ref,
                                                  local_sgd_ref)
    failed = []
    for seed, (label, kind, dataset, model, optimizer, route) in \
            enumerate(NAN_CASES):
        args, kw, d, _ = _train_case(dataset, 30 + seed, 10, model,
                                     optimizer)
        x, y, params, opt, t_idx, slot, total_w = args
        bad = _poison(params, d)
        fresh = lambda: {k: v.clone() for k, v in opt.items()}
        pats, eval_ok = {}, True
        wide0 = local_sgd.wide_launches + local_sgd.split_launches \
            + eval_cells.wide_launches
        if kind in ("k1", "k1f"):
            if kind == "k1f":
                got = local_sgd_fedavg(x, y, bad, fresh(), t_idx, slot,
                                       total_w, **kw)
                want = local_sgd_fedavg_ref(x, y, bad, fresh(), t_idx, slot,
                                            total_w, **kw)
                names = ("client", "opt", "n", "loss", "params", "stats")
            else:
                got = local_sgd(x, y, bad, fresh(), t_idx, slot, total_w,
                                route=route, optimizer=optimizer, **kw)
                want = local_sgd_ref(x, y, bad, fresh(), t_idx, slot,
                                     total_w, optimizer=optimizer, **kw)
                names = ("client", "opt", "n", "loss")
            for name, g, w in zip(names, got, want):
                for sub, gg in (g.items() if name == "opt" else
                                ((name, g),)):
                    ww = w[sub] if name == "opt" else w
                    pats[sub] = _same_finite(gg, ww)
        else:
            xw, yw = x[:, 4:6].contiguous(), y[:, 4:6].contiguous()
            if kind == "fold":
                M, C = bad.shape[0], x.shape[0]
                corr = torch.empty((M, C, 2), dtype=torch.int32,
                                   device="cuda")
                nll = torch.empty((M, C, 2), device="cuda")
                local_sgd_fedavg(x, y, bad, fresh(), t_idx, slot, total_w,
                                 eval_window=(xw.flatten(3), yw),
                                 eval_out=(corr, nll), **kw)
            else:
                corr, nll = eval_cells(bad, xw, yw, hidden=d["H"],
                                       route=route)
            want_c, want_n = eval_cells_ref(bad, xw, yw, hidden=d["H"])
            ties, _ = _near_ties(bad, xw, None, d["F"], d["H"], d["K"])
            ties[:2] = 0                      # the poisoned models: exact
            pats["correct"] = (bool(((corr - want_c).abs() <= ties).all()),
                               0)
            pats["nll"] = _same_finite(nll, want_n)
            both = torch.isfinite(nll) & torch.isfinite(want_n)
            eval_ok = bool(((nll - want_n).abs()[both]
                            <= EVAL_NLL_RTOL * want_n.abs()[both]).all())
        torch.cuda.synchronize()
        # MNIST's and fmow's widths must have taken the cluster kernels
        wide = local_sgd.wide_launches + local_sgd.split_launches \
            + eval_cells.wide_launches - wide0
        ok = all(v[0] for v in pats.values()) and eval_ok \
            and wide == (dataset in CLUSTER_DATASETS)
        _say("nan_semantics", case=label, dataset=dataset, model=model,
             optimizer=optimizer, route=route or "by shape",
             wide_launches=wide,
             patterns_equal=ok, finite_nll_equal=eval_ok,
             plain_nonfinite_cells={k: v[1] for k, v in pats.items()},
             mismatched=[k for k, v in pats.items() if not v[0]])
        if not ok:
            failed.append(label)
    if failed:
        raise AssertionError(f"nan_semantics: the kernels' finiteness "
                             f"differs from the plain versions' in "
                             f"{failed}")


def _weights0(exp) -> list[float]:
    """The mean over clients of each step's weight on model 0."""
    w = exp.algo.weights
    return [float(w[t, 0].mean()) for t in range(exp.cfg.train_iterations)]


def phase_train_gmm() -> None:
    """softcluster gmm at the canonical full width on the card, fused, from
    the reference's initial params (``CFL_REFERENCE_INIT``, the same SEA fnn
    pool), held to the JAX package's own CPU run of it (``GMM_RUN``): K1
    carries every
    round with K2 as its epilogue, every step folds its evals, no plain call
    runs on the card, and Test/Acc per step within STEP_ACC_TOL of the
    reference's (the mean within MEAN_ACC_TOL)."""
    from feddrift_torch.config import ExperimentConfig
    cfg = ExperimentConfig(**GMM_RUN["kw"])
    got = _drive(cfg, init=CFL_REFERENCE_INIT)
    exp, accs = got.pop("exp"), got["accs"]
    prof = _profile_step(exp)
    ref = GMM_RUN["test_acc"]
    rounds = cfg.train_iterations * cfg.comm_round
    diffs = [a - b for a, b in zip(accs, ref)]
    mean, ref_mean = sum(accs) / len(accs), sum(ref) / len(ref)
    _say("train_gmm", algo=cfg.concept_drift_algo,
         arg=cfg.concept_drift_algo_arg, paths=sorted(set(got["paths"])),
         wall_s=got["wall_s"], rounds_per_s=got["rounds_per_s"],
         k1_launches=got["k1_launches"], k2_epilogues=got["k2_epilogues"],
         folded_evals=got["folded_evals"], k3_launches=got["k3_launches"],
         plain_calls=got["plain_calls"],
         host_syncs_per_round=got["host_syncs_per_round"],
         test_acc=accs, reference_test_acc=list(ref),
         test_acc_mean=mean, reference_mean=ref_mean,
         max_step_diff=max(map(abs, diffs)),
         model0_weight=_weights0(exp),
         reference_model0_weight=list(GMM_RUN["model0_weight"]), **prof)
    if got["k1_launches"] != rounds or set(got["paths"]) != {"fused"}:
        raise AssertionError(f"gmm: K1 launched {got['k1_launches']} times "
                             f"for {rounds} rounds on {set(got['paths'])}")
    _check_k2_k3("gmm", got, rounds)
    _check_evals("gmm", got, cfg, exp, cfg.train_iterations, folds=True)
    if len(accs) != len(ref) or max(map(abs, diffs)) > STEP_ACC_TOL \
            or abs(mean - ref_mean) > MEAN_ACC_TOL:
        raise AssertionError(f"gmm: Test/Acc per step {accs} against the "
                             f"reference's {list(ref)}")


def _poisoned_run(cfg, out_dir: str) -> dict:
    """A run of ``cfg`` on the card whose pool gets a NaN in every model's
    Dense_0/kernel and an Inf in its Dense_1/bias at step 1's start: the
    guard's events, the params each diverged step (or round) started from
    beside the pool after its rollback, and the error it ended in."""
    import torch
    from feddrift_torch.resilience.divergence import DivergenceError
    from feddrift_torch.simulation.runner import Experiment
    exp = Experiment(cfg, out_dir=out_dir)
    orig, inputs = exp.run_iteration, []

    def hooked(t):
        if t == 1:
            p = {k: v.clone() for k, v in exp.pool.params.items()}
            p["Dense_0/kernel"][:, 1, 2] = float("nan")
            p["Dense_1/bias"][:, 0] = float("inf")
            exp.pool.params = p
        return orig(t)
    exp.run_iteration = hooked
    name = "train_iteration_eval" if cfg.chunk_rounds else "train_round"
    call = getattr(exp.step, name)

    def record(params, *a, **k):
        inputs.append({k2: v.clone() for k2, v in params.items()})
        return call(params, *a, **k)
    setattr(exp.step, name, record)
    err = None
    try:
        exp.run()
    except DivergenceError as e:
        err = e
    bits = lambda t: t.contiguous().view(torch.int32)
    restored = bool(inputs) and all(
        torch.equal(bits(exp.pool.params[k]), bits(v))
        for k, v in inputs[-1].items())
    return {"exp": exp, "error": err, "restored": restored,
            "events": exp.events.events("divergence_detected")}


def phase_train_guard() -> None:
    """The divergence guard on the card. Healthy: the canonical run (fused)
    and CFL (per round), each with the guard on and off: Test/Acc bitwise
    equal; walls and host syncs a round of both. Poisoned at step 1 (win-1,
    whose one model every client trains), fused and per round: every
    divergence non-finite, the pool after each
    rollback bitwise the one its step (round) started from,
    DivergenceError after divergence_max_rollbacks, an incident bundle that
    ``python -m feddrift_torch incident`` renders naming it. A real
    blow-up (``BLOWUP_RUN``'s lr, where the JAX package's CPU run goes
    non-finite): the guard fires non-finite and the run ends in
    DivergenceError, as the reference's does."""
    import tempfile

    from feddrift_torch.config import ExperimentConfig
    for name, kw in (("canonical", {}),
                     ("cfl", dict(concept_drift_algo_arg="cfl_0.1_win-1"))):
        runs = {}
        for guard in (True, False):
            cfg = ExperimentConfig(divergence_guard=guard, **kw)
            got = _drive(cfg)
            runs[guard] = got
        on, off = runs[True], runs[False]
        same = on["accs"] == off["accs"]
        _say("train_guard", run=name, paths=sorted(set(on["paths"])),
             guard_on_wall_s=on["wall_s"], guard_off_wall_s=off["wall_s"],
             guard_on_host_syncs_per_round=on["host_syncs_per_round"],
             guard_off_host_syncs_per_round=off["host_syncs_per_round"],
             test_acc_bitwise_equal=same,
             divergences=len(on["exp"].events.events(
                 "divergence_detected")))
        if not same or on["exp"].events.events("divergence_detected"):
            raise AssertionError(f"{name}: the guard changed a healthy run "
                                 f"({on['accs']} against {off['accs']})")
    for chunk in (True, False):
        cfg = ExperimentConfig(concept_drift_algo="win-1",
                               chunk_rounds=chunk, train_iterations=4)
        with tempfile.TemporaryDirectory() as out_dir:
            got = _poisoned_run(cfg, out_dir)
            bundles = sorted(os.listdir(os.path.join(out_dir, "incidents"))) \
                if os.path.isdir(os.path.join(out_dir, "incidents")) else []
            shown = subprocess.run(
                [sys.executable, "-m", "feddrift_torch", "incident",
                 out_dir], capture_output=True, text=True, timeout=120,
                cwd=os.path.dirname(os.path.abspath(__file__)))
        reasons = [e["reason"] for e in got["events"]]
        named = shown.returncode == 0 and "DivergenceError" in shown.stdout
        _say("train_guard", run="poisoned", path="fused" if chunk
             else "per_round", divergences=len(reasons),
             reasons=sorted(set(reasons)),
             restored_bitwise=got["restored"],
             divergence_error=repr(got["error"]), bundles=bundles,
             incident_names_divergence=named)
        if reasons != ["nonfinite"] * cfg.divergence_max_rollbacks \
                or not got["restored"] or got["error"] is None \
                or not bundles or not named:
            raise AssertionError(f"poisoned run (chunk {chunk}): {reasons}, "
                                 f"restored {got['restored']}, "
                                 f"{got['error']!r}, {bundles}, {named}")
    from feddrift_torch.resilience.divergence import DivergenceError
    from feddrift_torch.simulation.runner import Experiment
    exp = Experiment(ExperimentConfig(**BLOWUP_RUN))
    err = None
    try:
        exp.run()
    except DivergenceError as e:
        err = e
    evs = exp.events.events("divergence_detected")
    _say("train_guard", run="blowup", lr=BLOWUP_RUN["lr"],
         divergences=len(evs), reasons=sorted({e["reason"] for e in evs}),
         first_iteration=evs[0].get("iteration") if evs else None,
         divergence_error=repr(err))
    if not evs or {e["reason"] for e in evs} != {"nonfinite"} or err is None:
        raise AssertionError(f"blow-up at lr {BLOWUP_RUN['lr']}: the guard "
                             f"fired {len(evs)} times, {err!r}")


PREEMPT_ARGS = ("--train_iterations", "4", "--comm_round", "20",
                "--flat_out_dir")


def _cli(*args, out_dir: str, wait: bool = True):
    """``python -m feddrift_torch ARGS --out_dir OUT_DIR`` from the repo
    root: its (exit code, stdout, stderr), or the process itself."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "feddrift_torch", "--log_level", "warning",
         *args, "--out_dir", out_dir],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    if not wait:
        return proc
    out, err = proc.communicate(timeout=300)
    return proc.returncode, out, err


def _preempted_run(out_dir: str, tries: int = 3) -> dict:
    """``python -m feddrift_torch run`` (canonical, T = 4, R = 20) in a
    subprocess on the card, SIGTERM right after its first checkpoint_save:
    its exit code and final JSON line. The run is retried (up to
    ``tries``) if it finished before the signal arrived."""
    import shutil
    import signal
    events = os.path.join(out_dir, "events.jsonl")
    for attempt in range(1, tries + 1):
        shutil.rmtree(out_dir, ignore_errors=True)
        proc = _cli("run", *PREEMPT_ARGS, out_dir=out_dir, wait=False)
        deadline = time.time() + 240
        while time.time() < deadline and proc.poll() is None:
            if os.path.isfile(events):
                with open(events) as f:
                    if '"checkpoint_save"' in f.read():
                        proc.send_signal(signal.SIGTERM)
                        break
            time.sleep(0.001)
        out, err = proc.communicate(timeout=300)
        last = json.loads(out.strip().splitlines()[-1]) if out.strip() \
            else {}
        if last.get("preempted") or proc.returncode != 0:
            return {"rc": proc.returncode, "last": last, "attempts": attempt,
                    "stderr": err[-2000:]}
    return {"rc": proc.returncode, "last": last, "attempts": tries,
            "stderr": err[-2000:]}


def phase_train_preempt() -> None:
    """Preemption through the CLI on the card: a run stopped by SIGTERM
    after its first checkpoint exits 0 with ``"preempted": true``; ``run
    --auto_resume`` and ``resume --out_dir`` each finish a copy of it, and
    each one's metrics.jsonl is the uninterrupted run's row for row, every
    value bitwise (the rows' ``_ts`` wall-clock stamps aside)."""
    import shutil
    import tempfile

    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.simulation.runner import Experiment
    with tempfile.TemporaryDirectory() as root:
        full_dir = os.path.join(root, "full")
        cfg = ExperimentConfig(train_iterations=4, comm_round=20)
        Experiment(cfg, out_dir=full_dir).run()

        def rows(d):
            with open(os.path.join(d, "metrics.jsonl")) as f:
                return [{k: v for k, v in json.loads(line).items()
                         if k != "_ts"} for line in f]
        full = rows(full_dir)
        part = os.path.join(root, "part")
        t0 = time.perf_counter()
        stop = _preempted_run(part)
        stop_s = time.perf_counter() - t0
        copy = os.path.join(root, "copy")
        shutil.copytree(part, copy)
        with open(os.path.join(part, "ckpt", "MANIFEST.json")) as f:
            done = json.load(f)["iteration"]
        rc_a, out_a, err_a = _cli("run", *PREEMPT_ARGS, "--auto_resume",
                                  out_dir=part)
        rc_r, out_r, err_r = _cli("resume", out_dir=copy)
        same = {}
        for name, d in (("auto_resume", part), ("resume", copy)):
            same[name] = rows(d) == full
        last_a = json.loads(out_a.strip().splitlines()[-1]) if rc_a == 0 \
            else {}
        _say("train_preempt", preempted=stop["last"].get("preempted"),
             rc=stop["rc"], attempts=stop["attempts"],
             checkpointed_through_iteration=done, run_wall_s=stop_s,
             auto_resume_rc=rc_a, resume_rc=rc_r,
             auto_resume_preempted=last_a.get("preempted"),
             metrics_bitwise_equal=same)
        if stop["rc"] != 0 or stop["last"].get("preempted") is not True:
            raise AssertionError(f"preempt: rc {stop['rc']}, "
                                 f"{stop['last']}: {stop['stderr']}")
        if rc_a or rc_r or not all(same.values()):
            raise AssertionError(f"resume: rc {rc_a} / {rc_r}, metrics "
                                 f"equal {same}: {err_a[-1500:]} "
                                 f"{err_r[-1500:]}")


def _series(exp) -> list:
    return [(r["round"], r["Test/Acc"], r["Train/Loss"])
            for r in exp.logger.history]


def phase_trace_plane() -> None:
    """The trace plane on the card (module docstring, phase 17)."""
    import tempfile

    import torch
    from feddrift_torch import obs
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.obs import critical_path, hostprof
    from feddrift_torch.simulation.runner import Experiment
    from feddrift_torch.utils.prng import iteration_seed
    from feddrift_torch.utils.tracing import device_trace
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        run_dir = os.path.join(root, "sea")
        exp = Experiment(ExperimentConfig(hostprof_hz=100.0,
                                          debug_checks=True), out_dir=run_dir)
        _reset_counts()
        t0 = time.perf_counter()
        try:
            exp.run()
        finally:
            hostprof.configure_profiler(0.0)
        torch.cuda.synchronize()
        on_wall = time.perf_counter() - t0
        counts = _read_counts()
        off = Experiment(ExperimentConfig(profile_rounds=10 ** 9))
        t0 = time.perf_counter()
        off.run()
        torch.cuda.synchronize()
        off_wall = time.perf_counter() - t0
        bitwise = _series(exp) == _series(off)
        rcs = {}
        for verb in (("report", "--trace"), ("critical_path", "--flame"),
                     ("lineage", "--dot", os.path.join(root, "l.dot"))):
            got = subprocess.run(
                [sys.executable, "-m", "feddrift_torch", "--log_level",
                 "warning", verb[0], run_dir, *verb[1:]],
                capture_output=True, text=True, timeout=120,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            rcs[verb[0]] = got.returncode
            if got.returncode:
                print(got.stderr[-2000:], file=sys.stderr)
        cp = critical_path.analyze(run_dir)
        rows = cp["iterations"]
        coverage = [r["coverage"] for r in rows]
        both = all({"dispatch", "device_compute"} <= set(r["segments"])
                   for r in rows)
        folded = os.path.getsize(os.path.join(run_dir, "hostprof.folded")) \
            if os.path.isfile(os.path.join(run_dir, "hostprof.folded")) \
            else 0
        # the profiler's busy share of one more fused step of the run
        cfg, T = exp.cfg, exp.cfg.train_iterations
        opt = exp.step.init_opt_states(exp.pool.params, exp.pool.num_models,
                                       exp.C_)
        tw = exp.algo.round_inputs(T - 1, 0)[0]
        one_step = lambda: exp.step.train_iteration_eval(  # noqa: E731
            exp.pool.params, opt, exp.x, exp.y, tw, 1.0, cfg.comm_round,
            cfg.frequency_of_the_test, T - 1)
        exp.step.generator.manual_seed(iteration_seed(cfg.seed, T - 1))
        kernels, prof_us = _profile(one_step, 1)
        busy_us = sum(e.self_device_time_total for e in kernels)
        # device_trace around one fused step
        bus = obs.configure(None)
        trace_dir = os.path.join(root, "trace")
        with device_trace(trace_dir):
            one_step()
        files = os.listdir(trace_dir) if os.path.isdir(trace_dir) else []
        names = set()
        for name in files:
            with open(os.path.join(trace_dir, name)) as f:
                names |= {e.get("name", "") for e in
                          json.load(f).get("traceEvents", ())}
        k1_named = any("local_sgd_fused_kernel" in n for n in names)
        captured = [e["trace_dir"] for e in bus.events("profile_captured")]
    _say("trace_plane", run="canonical", planes_on_wall_s=on_wall,
         planes_off_wall_s=off_wall, test_acc_bitwise_equal=bitwise,
         k1_launches=counts["k1_launches"], verbs_rc=rcs,
         coverage=coverage, dispatch_and_device_compute=both,
         hostprof_folded_bytes=folded,
         segments_s=cp["totals"], dominant_segment=cp["dominant_segment"],
         host_overhead_frac_mean=cp["host_overhead_frac_mean"],
         profiler_busy_share=busy_us / prof_us if busy_us
         else "not measured",
         profiler_host_share=1 - busy_us / prof_us if busy_us
         else "not measured")
    if not bitwise or counts["k1_launches"] != 2000 or any(rcs.values()) \
            or not all(0.95 <= c <= 1.05 for c in coverage) \
            or len(coverage) != cfg.train_iterations or not both \
            or not folded:
        raise AssertionError(f"trace plane, canonical run: bitwise "
                             f"{bitwise}, K1 {counts['k1_launches']}, verbs "
                             f"{rcs}, coverage {coverage}, segments {both}, "
                             f"hostprof.folded {folded} bytes")
    _say("trace_plane", run="device_trace", files=files,
         names_k1_kernel=k1_named, profile_captured=captured)
    if len(files) != 1 or not k1_named or captured != [trace_dir]:
        raise AssertionError(f"device_trace: {files}, K1 named {k1_named}, "
                             f"profile_captured {captured}")
    # CFL per round: the default sample against none, in turns
    walls = {10: [], 10 ** 9: []}
    runs = {}
    for pr in (10, 10 ** 9, 10 ** 9, 10):
        e = Experiment(ExperimentConfig(
            concept_drift_algo_arg="cfl_0.1_win-1", profile_rounds=pr,
            checkpoint_every_iteration=False))
        t0 = time.perf_counter()
        e.run()
        torch.cuda.synchronize()
        walls[pr].append(time.perf_counter() - t0)
        runs[pr] = e
    bds = runs[10].events.events("round_breakdown")
    profiled = [b["profiled_rounds"] for b in bds]
    fracs = [b["host_overhead_frac"] for b in bds]
    same = _series(runs[10]) == _series(runs[10 ** 9])
    _say("trace_plane", run="cfl", profile_rounds_10_walls_s=walls[10],
         profile_rounds_1e9_walls_s=walls[10 ** 9],
         profiled_rounds=profiled, host_overhead_frac=fracs,
         test_acc_bitwise_equal=same)
    if not same or profiled != [20] * len(bds) \
            or len(bds) != runs[10].cfg.train_iterations \
            or any(f is None for f in fracs):
        raise AssertionError(f"CFL: bitwise {same}, profiled {profiled}, "
                             f"host_overhead_frac {fracs}")
    # debug_checks on a real blow-up: the K1 program's NaN raises
    err = None
    try:
        Experiment(ExperimentConfig(**BLOWUP_RUN, debug_checks=True)).run()
    except FloatingPointError as e:
        err = e
    _say("trace_plane", run="blowup_debug_checks", lr=BLOWUP_RUN["lr"],
         error=repr(err))
    if err is None or "K1" not in str(err):
        raise AssertionError(f"debug_checks on the blow-up: {err!r}")
    _say("trace_plane", phase_wall_s=time.perf_counter() - t_phase)


# train_conv: the conv models of the registry (models/cnn.py,
# models/resnet.py), trained by the model-generic local SGD
# (core/functional.py::model_local_sgd: cuDNN's convolutions and cuBLAS'
# products, no K1 layout) with K2, fedavg.cu, closing every round, and
# evaluated through their forward (model_logits, no K3). Each registry name
# is first held on the card against the port's CPU path in float64 at a
# batch of CONV_CHECK_ROWS, relative to the largest magnitude: logits and
# the gradient of the cross entropy computed on the card in float64 within
# CONV_F64_CARD_TOL (the card's convolutions, paddings and norms apart
# from TF32: float64's rounding, amplified as float32's is below, lies
# near 1e-11 at resnet110), and in float32 under the package's
# model_numerics within the larger of CONV_F64_FLOOR (TF32 in a conv or a
# product would leave it, ~1e-3, where float32 is well conditioned, as
# for the cnn and resnet8) and CONV_F64_FACTOR times the CPU float32
# path's own distance from float64 on the same inputs (the deep ResNets'
# float32 gradients at init lie ~1e-2 from float64 on the CPU too: a
# batch norm's backward cancels).
CONV_CHECK_MODELS = (("cnn", (784,), 62), ("cnn_dropout", (784,), 62),
                     ("resnet", (32, 32, 3), 10),
                     ("resnet20", (32, 32, 3), 10),
                     ("resnet8", (32, 32, 3), 10),
                     ("resnet56", (32, 32, 3), 10),
                     ("resnet110", (32, 32, 3), 10),
                     ("resnet56_gn", (32, 32, 3), 10),
                     ("resnet18", (32, 32, 3), 10))
CONV_CHECK_ROWS = 32
CONV_F64_FLOOR, CONV_F64_FACTOR, CONV_F64_CARD_TOL = 1e-4, 4.0, 1e-8
# cuDNN's TF32, determinism and autotuning, and the matmuls' TF32, as
# models/base.py::model_numerics sets them
CONV_FLAGS = {"cudnn_allow_tf32": False, "cudnn_deterministic": True,
              "cudnn_benchmark": False, "matmul_allow_tf32": False}
# The three committed conv runs (scripts/run_round5_cpu.sh, made by the JAX
# package on one CPU core) at their own configurations and full model
# width: (committed run, its configuration, that run's final Test/Acc per
# step as committed, the path its steps take). femnist's command line asks
# for 5 steps; its committed file holds 2, and the card runs those 2.
CONV_RUNS = (
    ("femnist-smooth-cnn-ada-win-1_iter-s0",
     dict(dataset="femnist-smooth", model="cnn", concept_drift_algo="ada",
          concept_drift_algo_arg="win-1_iter", concept_num=2,
          change_points="rand", client_num_in_total=20,
          client_num_per_round=10, train_iterations=2, comm_round=12,
          epochs=5, batch_size=32, sample_num=500, lr=0.003,
          frequency_of_the_test=3),
     (0.393, 0.5007), "per_round"),
    ("fmow-smooth-cnn-softcluster-H_A_C_1_10_0-s0",
     dict(dataset="fmow-smooth", model="cnn",
          concept_drift_algo="softcluster", chunk_rounds=False,
          concept_drift_algo_arg="H_A_C_1_10_0", concept_num=4,
          change_points="A", client_num_in_total=10,
          client_num_per_round=10, train_iterations=2, comm_round=4,
          epochs=5, batch_size=32, sample_num=500, lr=0.003,
          frequency_of_the_test=4),
     (0.0154, 0.0238), "per_round"),
    ("cifar10-smooth-resnet8-hard-r-s0",
     dict(dataset="cifar10-smooth", model="resnet8",
          concept_drift_algo="softclusterwin-1",
          concept_drift_algo_arg="hard-r", concept_num=2,
          change_points="rand", client_num_in_total=4,
          client_num_per_round=4, train_iterations=2, comm_round=6,
          epochs=5, batch_size=32, sample_num=500, lr=0.05,
          frequency_of_the_test=2),
     (0.1815, 0.2855), "per_round"))
# The gates, fixed before the card's seed-0 runs were compared: the whole
# conv path is plain PyTorch and the port's draws and init are not the JAX
# package's, so a run is held to its committed series a step and on the
# mean within the larger of SEA's STEP_ACC_TOL / MEAN_ACC_TOL and the
# spread of the port's own card runs at seeds 1-3 of the same
# configuration (scripts/torch_conv_seed_runs.py --seeds 1,2,3: the
# largest max - min over the seeds of a step's final Test/Acc, and of
# their means), as (step, mean) by run.
# (on an NVIDIA H100 80GB HBM3, 700.00 W; the seeds' final Test/Acc:
# femnist (0.2468, 0.488), (0.1903, 0.5016), (0.309, 0.4989); fmow (0.018,
# 0.034), (0.0168, 0.0226), (0.0194, 0.0132); cifar10 (0.213, 0.337),
# (0.196, 0.238), (0.1605, 0.223)). fmow-smooth's committed run sits at
# chance (1/62 ~ 0.016) at both steps, as do the port's seeds: its gate
# cannot tell chance from learning.
CONV_SEED_SPREAD = {
    "femnist-smooth-cnn-ada-win-1_iter-s0": (0.1187, 0.058),
    "fmow-smooth-cnn-softcluster-H_A_C_1_10_0-s0": (0.0208, 0.0097),
    "cifar10-smooth-resnet8-hard-r-s0": (0.114, 0.08325)}


def _conv_gate(run: str) -> tuple[float, float]:
    step, mean = CONV_SEED_SPREAD[run]
    return max(STEP_ACC_TOL, step), max(MEAN_ACC_TOL, mean)


# the timing case: a round of the cnn at fmow-smooth (M 4, C 10, S 5, 32 x
# 32 x 3 images, 62 classes) at each batch, model 3 with no active client
CONV_TIMING_BATCHES = (32, 500)
CONV_TOP_OPS = 8


def _rel_err(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def _conv_flags() -> dict:
    import torch
    b = torch.backends
    return {"cudnn_allow_tf32": b.cudnn.allow_tf32,
            "cudnn_deterministic": b.cudnn.deterministic,
            "cudnn_benchmark": b.cudnn.benchmark,
            "matmul_allow_tf32": b.cuda.matmul.allow_tf32}


def _conv_model_checks() -> None:
    """Each of ``CONV_CHECK_MODELS`` at its published width through
    ``_model_errors``."""
    import numpy as np
    import torch
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.data.drift_dataset import DriftDataset
    from feddrift_torch.models import create_model
    for name, shape, classes in CONV_CHECK_MODELS:
        ds = DriftDataset(x=np.zeros((1, 1, 1, *shape), np.float32),
                          y=np.zeros((1, 1, 1), np.int32),
                          concepts=np.zeros((1, 1), np.int64),
                          num_classes=classes)
        mod = create_model(name, ds, ExperimentConfig())
        gen = torch.Generator().manual_seed(1)
        x = torch.rand(CONV_CHECK_ROWS, *shape, generator=gen)
        y = torch.randint(0, classes, (CONV_CHECK_ROWS,), generator=gen)
        fields, failed = _model_errors(mod, x, y)
        _say("train_conv_model", model=name, input=list(shape),
             classes=classes, **fields)
        if failed:
            raise AssertionError(f"{name} on the card: {failed}")


def _conv_timing_setup(batch: int):
    """The timing case's experiment at ``batch``, a round's inputs and a
    call of one round."""
    import torch
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.simulation.runner import Experiment
    kw = dict(CONV_RUNS[1][1], batch_size=batch)
    exp = Experiment(ExperimentConfig(**kw))
    M, C, T1 = exp.pool.num_models, exp.C_, exp.x.shape[1]
    tw = torch.zeros(M, C, T1, device="cuda")
    tw[:3, :, 0] = 1.0                        # model 3: no active client
    step, params = exp.step, exp.pool.params
    opt = step.init_opt_states(params, M, C)
    step.generator.manual_seed(0)
    draws = step.draw_batches(tw, 1, exp.x.shape[2])
    draws = (draws[0][0], draws[1][0])
    return exp, lambda: step.train_round(params, opt, exp.x, exp.y, tw,
                                         draws=draws)


def _top_device_ops(kernels, per: int) -> list:
    """The ``CONV_TOP_OPS`` kernels with the most device time: name (60
    characters), device ms and launches, each per ``per``."""
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    return [{"op": e.key[:60], "device_ms": e.self_device_time_total
             / per / 1e3, "launches": e.count / per}
            for e in top[:CONV_TOP_OPS]]


def _conv_round_checks() -> dict:
    """The timing case at each of ``CONV_TIMING_BATCHES``: one round twice
    from the same inputs, bitwise (params, client stack, optimizer state,
    n, losses; cuDNN deterministic), every forward of them under
    ``CONV_FLAGS`` and the process's flags as they were after them; the
    wall a round (median of 5), its
    device ms, launches, busy share and top device operations under the
    profiler, no gate. At B 32, K2 on that round's client stack (P
    2,183,166; model 3 an empty cluster) through ``_k2_check``: the
    kernels line's ``fedavg_conv``."""
    import statistics

    import torch
    entry = None
    for batch in CONV_TIMING_BATCHES:
        exp, fn = _conv_timing_setup(batch)
        mod = exp.module
        seen, before = [], _conv_flags()
        hook = mod.register_forward_pre_hook(
            lambda m, args: seen.append(_conv_flags()))
        a, b = fn(), fn()
        torch.cuda.synchronize()
        hook.remove()
        scoped = bool(seen) and all(f == CONV_FLAGS for f in seen) \
            and _conv_flags() == before
        bitwise = all(torch.equal(a[i][k], b[i][k]) for i in (0, 2)
                      for k in a[i]) \
            and all(torch.equal(a[1][k], b[1][k]) for k in a[1]) \
            and torch.equal(a[3], b[3]) and torch.equal(a[4], b[4])
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        kernels, wall_us, union_us = _profile(fn, 3, union=True)
        busy_us = sum(e.self_device_time_total for e in kernels)
        _say("train_conv_round", model="cnn", dataset="fmow-smooth",
             M=exp.pool.num_models, C=exp.C_, S=exp.step.num_steps,
             B=batch, P=mod.num_params, two_rounds_bitwise=bitwise,
             forwards=len(seen), forwards_under_conv_flags=scoped,
             flags_after=_conv_flags(),
             wall_ms=statistics.median(walls),
             device_ms=busy_us / 3 / 1e3 if busy_us else "not measured",
             busy_share=busy_us / wall_us if busy_us else "not measured",
             device_union_ms=union_us / 3 / 1e3,
             device_union_share=union_us / wall_us,
             profiled_wall_ms=wall_us / 3 / 1e3,
             launches=sum(e.count for e in kernels) / 3,
             fedavg_launches=sum(e.count for e in kernels
                                 if "fedavg_kernel" in e.key) / 3,
             top_device_ops=_top_device_ops(kernels, 3))
        if not (bitwise and scoped):
            raise AssertionError(f"a conv round at B {batch} twice from the "
                                 f"same inputs: bitwise {bitwise}; its "
                                 f"{len(seen)} forwards under {CONV_FLAGS} "
                                 f"and the flags restored: {scoped}")
        if batch != CONV_TIMING_BATCHES[0]:
            continue
        client, n, prev = mod.pack(a[2]), a[3], mod.pack(exp.pool.params)
        entry = _k2_check("conv", client, n, prev, dataset="fmow-smooth",
                          model="cnn")
        entry.update(name="fedavg_conv", case=f"{entry['case']} "
                     f"(fmow-smooth, the cnn, a conv round's client stack)")
        del exp, fn, a, b, client
        torch.cuda.empty_cache()
    return entry


def _conv_runs() -> tuple[int, list[str]]:
    """``CONV_RUNS`` through the runner on the card, each gated against its
    committed run (``_conv_gate``): every round one ``fedavg.cu`` launch,
    no K1, K3 or K4 launch and no plain call on the card, the pool and the
    data on the card; one ``train_conv`` line a run with its wall, launches,
    the device ms, busy share and top device operations of one more
    profiled step, and each step's Test/Acc beside the committed run's.
    Returns the ``fedavg.cu`` launches and the runs outside their gates."""
    import torch
    from feddrift_torch.config import ExperimentConfig
    here = os.path.dirname(os.path.abspath(__file__))
    launches, missed = 0, []
    for run, kw, pinned, path in CONV_RUNS:
        ref = _reference_accs(os.path.join(here, "runs", run,
                                           "metrics.jsonl"), pinned)
        cfg = ExperimentConfig(**kw)
        got = _drive(cfg, syncs=False)
        exp, accs = got.pop("exp"), got["accs"]
        rounds = cfg.train_iterations * cfg.comm_round
        on_card = all(t.is_cuda for t in (exp.x, exp.y,
                                          *exp.pool.params.values()))
        prof = _profile_step(exp, top=True)
        step_tol, mean_tol = _conv_gate(run)
        diffs = [a - b for a, b in zip(accs, ref)]
        mean, ref_mean = sum(accs) / len(accs), sum(ref) / len(ref)
        within = max(map(abs, diffs)) <= step_tol \
            and abs(mean - ref_mean) <= mean_tol
        chance = 1.0 / exp.ds.num_classes
        _say("train_conv", run=run, model=cfg.model, dataset=cfg.dataset,
             algo=cfg.concept_drift_algo, arg=cfg.concept_drift_algo_arg,
             models=exp.pool.num_models, clients=exp.C_,
             params=exp.module.num_params, steps=cfg.train_iterations,
             rounds=rounds, paths=got["paths"], wall_s=got["wall_s"],
             step_wall_s=got["step_wall_s"],
             rounds_per_s=got["rounds_per_s"],
             fedavg_launches=got["k2_launches"],
             k1_launches=got["k1_launches"], k3_launches=got["k3_launches"],
             k4_launches=got["k4a_launches"] + got["k4b_launches"],
             plain_calls=got["plain_calls"], on_card=on_card,
             test_acc=accs, committed_test_acc=ref, test_acc_mean=mean,
             committed_mean=ref_mean, max_step_diff=max(map(abs, diffs)),
             step_tol=step_tol, mean_tol=mean_tol, within_gate=within,
             chance=chance,
             gate_separates_committed_from_chance=max(ref) - chance
             > step_tol,
             **prof)
        if got["k2_launches"] != rounds or got["k1_launches"] \
                or got["k3_launches"] or got["k4a_launches"] \
                or got["k4b_launches"] or any(got["plain_calls"].values()) \
                or set(got["paths"]) != {path} or not on_card \
                or len(accs) != cfg.train_iterations:
            raise AssertionError(f"{run}: fedavg.cu launched "
                                 f"{got['k2_launches']} times for {rounds} "
                                 f"rounds, K1 {got['k1_launches']}, K3 "
                                 f"{got['k3_launches']}, K4 "
                                 f"{got['k4a_launches']} / "
                                 f"{got['k4b_launches']}, plain calls "
                                 f"{got['plain_calls']}, paths "
                                 f"{got['paths']} (want {path}), on the "
                                 f"card {on_card}, {len(accs)} steps")
        launches += got["k2_launches"]
        if not within:
            missed.append(f"{run}: Test/Acc per step {accs} against the "
                          f"committed {ref} (step tolerance {step_tol}, "
                          f"mean {mean_tol})")
        del exp, got
        torch.cuda.empty_cache()
    return launches, missed


def phase_train_conv() -> dict:
    """The conv models on the card: ``_conv_model_checks``, the timing case
    and K2 at the conv width (``_conv_round_checks``), then the three
    committed conv runs (``_conv_runs``), every run driven before the phase
    fails. Returns the kernels line's ``fedavg_conv`` entry, its launches
    those of the three runs."""
    _conv_model_checks()
    entry = _conv_round_checks()
    entry["launches"], missed = _conv_runs()
    if missed:
        raise AssertionError("conv runs outside their gates: "
                             + "; ".join(missed))
    return entry


# train_rnn: the LSTMs of the registry (models/rnn.py: CharLSTM ``rnn``,
# WordLSTM ``rnn_stackoverflow``), trained by the model-generic local SGD
# with each LSTM step's cell in kernels/lstm_cell.py (one csrc/lstm_cell.cu
# launch forward, one backward; the gate products cuBLAS' float32 matmuls)
# and K2's fedavg.cu closing every round. First the cell kernels against
# their plain versions at the two models' main-path shapes (RNN_CELL_CASES:
# the rows of a step, M·C pairs of B, and H), within RNN_CELL_RTOL of the
# plain output's largest magnitude (float32 exp and tanh, a few ulp
# apart); each registry name then held as CONV_CHECK_MODELS are
# (RNN_CHECK_MODELS: float64 on the card within CONV_F64_CARD_TOL of the
# CPU's, float32 within the larger of CONV_F64_FLOOR and CONV_F64_FACTOR
# times the CPU float32's own error).
RNN_CELL_CASES = (("rnn", 30 * 32, 256), ("rnn_stackoverflow", 40 * 32, 670))
RNN_CELL_RTOL = 1e-6
# The cell's timed calls rotate through copies of their inputs holding
# twice the H100's 50 MB L2, so a call reads its inputs from HBM.
CELL_COLD_BYTES = 100 * 2**20
# A cell call's float32 words and operations a (row, unit): the forward
# reads z (4) and c and writes h' and c'; the backward reads dh', dc', the
# gates (4), c and c' and writes dz (4) and dc. The gates the forward also
# writes are the backward's to read: a backward that recomputed them
# would read z instead, the same words.
CELL_COST = {"fwd": (7, 20), "bwd": (13, 25)}
RNN_CHECK_MODELS = (("rnn", "fed_shakespeare", 80, 90),
                    ("rnn_stackoverflow", "stackoverflow_nwp", 20, 10000))
RNN_CHECK_ROWS = 32
# The committed LSTM run at its own configuration
# (scripts/run_round4_cpu.sh:45-51; its lr is the 0.03 PARITY.md records,
# not the script's 0.1): (committed run, its configuration, its final
# Test/Acc per step as committed, the path its steps take).
RNN_RUNS = (
    ("fed_shakespeare-rnn-aue-10c-s0",
     dict(dataset="fed_shakespeare", model="rnn", concept_drift_algo="aue",
          concept_num=3, change_points="rand", client_num_in_total=10,
          client_num_per_round=10, train_iterations=3, comm_round=20,
          epochs=5, batch_size=32, sample_num=1000, lr=0.03,
          frequency_of_the_test=5),
     (0.1738, 0.2987, 0.4233), "per_round"),)
# The gate, fixed before the card's seed-0 run was read, as
# CONV_SEED_SPREAD: the larger of SEA's tolerances and the spread of the
# port's card runs at seeds 1-3 (scripts/torch_conv_seed_runs.py --family
# rnn --seeds 1,2,3), as (step, mean). (On an NVIDIA H100 80GB HBM3,
# 700.00 W, the seeds' final Test/Acc: (0.2203, 0.2081, 0.4245), (0.1376,
# 0.3451, 0.4303), (0.1757, 0.2919, 0.4348).)
RNN_SEED_SPREAD = {"fed_shakespeare-rnn-aue-10c-s0": (0.137, 0.02003)}
# rnn_stackoverflow on stackoverflow_nwp at the registry's sizes (V 10000,
# seq 20) in the conv runs' shape (fmow-smooth's: softcluster H_A_C_1_10_0,
# change points A, C 10, T 2, 4 rounds, S 5, B 32, N 500): no committed
# run exists, so it is held to its model checks and to the launches of its
# path, and its Test/Acc is reported without a gate.
RNN_SO_RUN = dict(dataset="stackoverflow_nwp", model="rnn_stackoverflow",
                  concept_drift_algo="softcluster",
                  concept_drift_algo_arg="H_A_C_1_10_0", concept_num=4,
                  change_points="A", client_num_in_total=10,
                  client_num_per_round=10, train_iterations=2, comm_round=4,
                  epochs=5, batch_size=32, sample_num=500, lr=0.003,
                  frequency_of_the_test=4)


def _rnn_gate(run: str) -> tuple[float, float]:
    step, mean = RNN_SEED_SPREAD[run]
    return max(STEP_ACC_TOL, step), max(MEAN_ACC_TOL, mean)


def _cell_inputs(R: int, H: int, seed: int = 0):
    """One cell step's inputs on the card: pre-activations ~ N(0, 2²) (the
    gates span their saturating range), carry and upstream gradients ~
    N(0, 1)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    return 2.0 * rand(R, 4 * H), rand(R, H), rand(R, H), rand(R, H)


def _cell_rel(got, want) -> float:
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def _cell_errs(got, want) -> tuple[float, float]:
    """(relative to the largest plain output, absolute) of a cell call."""
    return _cell_rel(got, want), max(float((a - b).abs().max())
                                     for a, b in zip(got, want))


def _rotating(sets: list, fn):
    """A call of ``fn`` on each of ``sets`` in turn, call after call."""
    turn = iter(range(1 << 62))
    return lambda: fn(*sets[next(turn) % len(sets)])


def _lstm_library():
    """PyTorch's own fused LSTM cell (the CUDA kernels behind ``nn.LSTM``
    without cuDNN), on the cell kernels' arguments: the forward
    ``aten._thnn_fused_lstm_cell(input_gates, hidden_gates, cx)`` with
    ``z`` as the input gates and a zero hidden gates tensor (it adds the
    two), giving ``(h', c', the activated gates)`` in the same i, f, g, o
    order; the backward ``_thnn_fused_lstm_cell_backward_impl(dh', dc',
    c, c', gates, has_bias)``, giving ``(dz, dc)``. Timed and checked
    beside the kernels; the port never calls them."""
    import torch
    aten = torch.ops.aten
    return (lambda z, c, zero: aten._thnn_fused_lstm_cell(z, zero, c),
            lambda dh, dcn, gates, c, cn:
            aten._thnn_fused_lstm_cell_backward_impl(dh, dcn, c, cn, gates,
                                                     False)[:2])


def _lstm_cell_checks() -> tuple[dict, dict]:
    """``lstm_cell_fwd`` and ``lstm_cell_bwd`` against their plain versions
    at each of ``RNN_CELL_CASES``, in float32 and float64: within
    ``RNN_CELL_RTOL`` of the largest plain output, two calls bitwise;
    PyTorch's fused LSTM cell (``_lstm_library``) held to the same plain
    outputs. In float32 the kernel (through the per-step route's
    ``CellLauncher``, checked once a layer, its forward's outputs allocated
    once as in training, and through the wrappers, which check and
    allocate every call: ``checked_ms``), the plain version and the library
    are timed (CUDA events, and the profiler's device time) on inputs rotated
    through ``CELL_COLD_BYTES`` of copies, so each call reads them from HBM
    as the bound counts; the bound is the bytes of the function's inputs
    and outputs (forward: z and c in, h' and c' out; backward: dh', dc',
    the gates, c and c' in, dz and dc out). Returns the kernels line's
    ``lstm_cell_fwd`` and ``lstm_cell_bwd`` entries at WordLSTM's shape,
    the per-step route's only driven one since the layer kernels (launches
    from its run)."""
    import torch
    from feddrift_torch.kernels.lstm_cell import (CellLauncher,
                                                  StepOutputs,
                                                  lstm_cell_bwd,
                                                  lstm_cell_bwd_ref,
                                                  lstm_cell_fwd,
                                                  lstm_cell_fwd_ref)
    lib_fwd, lib_bwd = _lstm_library()
    entries = {}
    for model, R, H in RNN_CELL_CASES:
        z, c, dh, dcn = _cell_inputs(R, H)
        for dt in (torch.float64, torch.float32):
            z_, c_, dh_, dcn_ = (t.to(dt) for t in (z, c, dh, dcn))
            fwd = lstm_cell_fwd(z_, c_)
            bwd = lstm_cell_bwd(dh_, dcn_, fwd[2], c_, fwd[1])
            again = (lstm_cell_fwd(z_, c_),
                     lstm_cell_bwd(dh_, dcn_, fwd[2], c_, fwd[1]))
            zero = torch.zeros_like(z_)
            lib = (lib_fwd(z_, c_, zero),)
            torch.cuda.synchronize()
            want_f = lstm_cell_fwd_ref(z_, c_)
            want_b = lstm_cell_bwd_ref(dh_, dcn_, want_f[2], c_, want_f[1])
            lib += (lib_bwd(dh_, dcn_, want_f[2], c_, want_f[1]),)
            bitwise = all(torch.equal(a, b) for a, b in
                          zip((*fwd, *bwd), (*again[0], *again[1])))
            errs = {"fwd": _cell_errs(fwd, want_f),
                    "bwd": _cell_errs(bwd, want_b),
                    "library_fwd": _cell_errs(lib[0], want_f),
                    "library_bwd": _cell_errs(lib[1], want_b)}
            ok = bitwise and all(r <= RNN_CELL_RTOL for r, _ in
                                 errs.values())
            if dt == torch.float64:
                _say("train_rnn_cell", model=model, R=R, H=H,
                     dtype="float64", fwd_rel_err=errs["fwd"][0],
                     bwd_rel_err=errs["bwd"][0],
                     library_fwd_rel_err=errs["library_fwd"][0],
                     library_bwd_rel_err=errs["library_bwd"][0],
                     rtol=RNN_CELL_RTOL, two_calls_bitwise=bitwise)
                if not ok:
                    raise AssertionError(f"lstm_cell float64 at R {R}, H "
                                         f"{H}: {errs}, bitwise {bitwise}")
                continue
            one = (z_, c_, dh_, dcn_, fwd[2], fwd[1], zero)
            per_set = sum(t.numel() * t.element_size() for t in one)
            sets = [one] + [tuple(t.clone() for t in one) for _ in
                            range(-(-CELL_COLD_BYTES // per_set) - 1)]
            times = {}
            # the per-step route's call in training: checked once a
            # layer, the forward's outputs allocated once (a step each)
            thin = CellLauncher(R, H, dt, "cuda")
            slots = StepOutputs(len(sets), R, H, z_)
            for part, kernel, checked, plain, library in (
                    ("fwd", lambda z, c, *_: thin.fwd(z, c, slots),
                     lambda z, c, *_: lstm_cell_fwd(z, c),
                     lambda z, c, *_: lstm_cell_fwd_ref(z, c),
                     lambda z, c, _a, _b, _g, _n, zero: lib_fwd(z, c, zero)),
                    ("bwd", lambda _z, c, dh, dcn, g, cn, _: thin.bwd(
                        dh, dcn, g, c, cn),
                     lambda _z, c, dh, dcn, g, cn, _: lstm_cell_bwd(
                         dh, dcn, g, c, cn),
                     lambda _z, c, dh, dcn, g, cn, _: lstm_cell_bwd_ref(
                         dh, dcn, g, c, cn),
                     lambda _z, c, dh, dcn, g, cn, _: lib_bwd(
                         dh, dcn, g, c, cn))):
                t = _timed({"kernel": _rotating(sets, kernel),
                            "checked": _rotating(sets, checked),
                            "plain": _rotating(sets, plain),
                            "library": _rotating(sets, library)}, iters=200)
                words, ops = CELL_COST[part]
                bound_ms, bound_by = _bound(words * R * H * 4, ops * R * H)
                times[part] = (t, bound_ms, bound_by,
                               _launches(_rotating(sets, plain)))
            _say("train_rnn_cell", model=model, R=R, H=H, dtype="float32",
                 rtol=RNN_CELL_RTOL, two_calls_bitwise=bitwise,
                 rotated_input_sets=len(sets),
                 rotated_mb=len(sets) * per_set / 1e6,
                 **{f"{p}_{k}": v for p, (t, b, by, pl) in times.items()
                    for k, v in (("rel_err", errs[p][0]),
                                 ("max_abs_err", errs[p][1]),
                                 ("library_rel_err", errs[f"library_{p}"][0]),
                                 ("ms", t["kernel"]["ms"]),
                                 ("device_ms", t["kernel"]["device_ms"]),
                                 ("enqueue_ms", t["kernel_enqueue_ms"]),
                                 ("checked_ms", t["checked"]["ms"]),
                                 ("plain_ms", t["plain"]["ms"]),
                                 ("plain_device_ms",
                                  t["plain"]["device_ms"]),
                                 ("plain_launches_per_call", pl),
                                 ("library_ms", t["library"]["ms"]),
                                 ("library_device_ms",
                                  t["library"]["device_ms"]),
                                 ("bound_ms", b), ("bound_by", by),
                                 ("kernel_vs_bound",
                                  (t["kernel"]["device_ms"]
                                   or t["kernel"]["ms"]) / b),
                                 ("kernel_vs_library",
                                  t["kernel"]["ms"] / t["library"]["ms"]))})
            if not ok:
                raise AssertionError(f"lstm_cell float32 at R {R}, H {H}: "
                                     f"(relative, absolute) {errs}, two "
                                     f"calls bitwise {bitwise}")
            del sets, one, slots
            if model != RNN_CELL_CASES[1][0]:
                continue
            for part, (t, b, by, _) in times.items():
                entries[part] = {
                    "name": f"lstm_cell_{part}", "route": "cuda",
                    "source": "feddrift_torch/kernels/csrc/lstm_cell.cu",
                    "replaces": "feddrift_tpu/models/rnn.py:25 (flax's "
                    "OptimizedLSTMCell, also :26, :40; left to XLA: no "
                    "Pallas kernel)",
                    "case": f"R {R}, H {H} (WordLSTM's step: 40 pairs of "
                    f"32 rows; the per-step route's driven shape), inputs "
                    f"read from HBM, the per-step route's call in training "
                    f"(checked once a layer, the forward's outputs "
                    f"allocated once a layer; every call checked and "
                    f"allocating: checked_ms)",
                    "launches": None,
                    "checked_ms": t["checked"]["ms"],
                    "max_abs_err": errs[part][1], "ms": t["kernel"]["ms"],
                    "plain_ms": t["plain"]["ms"], "bound_ms": b,
                    "bound_by": by, "library_ms": t["library"]["ms"],
                    "library": "aten._thnn_fused_lstm_cell" if part == "fwd"
                    else "aten._thnn_fused_lstm_cell_backward_impl",
                    "device_ms": t["kernel"]["device_ms"],
                    "library_device_ms": t["library"]["device_ms"]}
        del z, c, dh, dcn
        torch.cuda.empty_cache()
    return entries["fwd"], entries["bwd"]


# The layer kernels' cases (label, K pairs, N rows, L steps, H, gradient):
# CharLSTM's training step (M·C = 30 pairs of B = 32 rows, seq 80), its
# eval forward (one model over EVAL_ROWS rows, no gradient: only h
# written), a ragged N (a last block of 5 rows).
LSTM_LAYER_CASES = (("rnn_train", 30, 32, 80, 256, True),
                    ("rnn_eval", 1, 8192, 80, 256, False),
                    ("ragged", 30, 37, 80, 256, True))
# A kernel output's distance from the plain version run in float64 (its
# largest difference over the float64 output's largest magnitude) may be at
# most LAYER_F64_FACTOR times the float32 plain version's plus
# LAYER_F64_FLOOR: the rule of the K1 checks, the floor fixed before the
# kernels' first card run.
LAYER_F64_FACTOR, LAYER_F64_FLOOR = 2.0, 1e-6
LAYER_TIMING = dict(iters=5, rounds=3)
# CharLSTM's first layer reads the 8-wide embedding: cuDNN's layer there
# does the recurrence of the layer kernels plus an input product of 8.
LAYER_CUDNN_INPUT = 8


def _layer_inputs(K: int, N: int, L: int, H: int, seed: int = 0):
    """float64 inputs of a layer on the card: zx and b ~ N(0, 1), W_h ~
    N(0, 1 / H) (an orthogonal init's scale), the outputs' gradient ~
    N(0, 1)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *s: torch.randn(*s, device="cuda", generator=gen,
                                  dtype=torch.float64)
    return (rand(K, N, L, 4 * H), rand(K, H, 4 * H) / H ** 0.5,
            rand(K, 4 * H), rand(K, N, L, H))


def _f64_dist(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def _layer_layouts(zx, wh, b):
    """The same layer's recurrence four ways, as callables of the forward
    and of the backward of ``(zx, wh, b)``'s every step's output: the layer
    op (``lstm_layer``), the per-step route with the cell kernels (its
    launcher checked once, in training its outputs allocated once), the
    per-step route with PyTorch's fused cell,
    and cuDNN's layer (``torch._VF.lstm``, K calls of ``nn.LSTM``, on an
    input of ``LAYER_CUDNN_INPUT``). The backward of each is autograd's
    over its graph (the layer op's: the backward kernel, then dW_h's one
    product and db's sum)."""
    import torch
    from feddrift_torch.kernels.lstm_cell import (StepOutputs, cell_launcher,
                                                  lstm_cell)
    from feddrift_torch.kernels.lstm_layer import lstm_layer
    aten = torch.ops.aten
    K, N, L, G = zx.shape
    H = G // 4
    launcher = cell_launcher(K * N, H, zx)
    zero = zx.new_zeros(K * N, G)

    def step(cell):
        def run(zx_, wh_, b_):
            h = zx_.new_zeros(K, N, H)
            c = zx_.new_zeros(K * N, H)
            slots = StepOutputs(L, K * N, H, zx_) if zx_.requires_grad \
                and torch.is_grad_enabled() else None
            outs = []
            for zt in zx_.unbind(2):
                z = torch.baddbmm(b_[:, None], h, wh_) + zt
                h, c = cell(z.view(K * N, G), c, slots)[:2]
                h = h.view(K, N, H)
                outs.append(h)
            return torch.stack(outs, 2)
        return run
    ours = step(lambda z, c, slots: lstm_cell(z, c, launcher, slots))
    library = step(lambda z, c, _: aten._thnn_fused_lstm_cell(z, zero, c))
    nets = [torch.nn.LSTM(LAYER_CUDNN_INPUT, H, batch_first=True).cuda()
            for _ in range(K)]
    xs = torch.randn(K, N, L, LAYER_CUDNN_INPUT, device="cuda")
    with torch.no_grad():
        for k, net in enumerate(nets):
            net.weight_hh_l0.copy_(wh[k].T)
            net.bias_hh_l0.copy_(b[k])
            net.bias_ih_l0.zero_()

    def cudnn(*_):
        return torch.stack([net(xs[k])[0] for k, net in enumerate(nets)])
    return {"layer": lambda zx_, wh_, b_: lstm_layer(zx_, wh_, b_),
            "per_step_cell_kernels": ours, "per_step_fused_cell": library,
            "cudnn": cudnn}, nets


def _layer_bounds(K: int, N: int, L: int, H: int, grad: bool) -> dict:
    """Each direction's least time: its FMAs (the recurrent product, 2
    operations each, and the cell's CELL_COST operations a unit) at the
    float32 rate against its bytes (forward: zx, W_h and b in, h out and,
    with a gradient, c and the gates; backward: dH, the gates, c and W_h
    in, dZ out) over HBM."""
    units = K * N * L * H
    prod = 2 * K * N * L * H * 4 * H
    out = {"fwd": _bound(4 * (units * 4 + K * H * 4 * H + K * 4 * H
                              + units * (6 if grad else 1)),
                         prod + CELL_COST["fwd"][1] * units)}
    if grad:
        out["bwd"] = _bound(4 * (units * (1 + 4 + 1 + 4) + K * H * 4 * H),
                            prod + CELL_COST["bwd"][1] * units)
    return out


def _lstm_layer_checks() -> tuple[dict, dict]:
    """``lstm_layer_fwd`` and ``lstm_layer_bwd`` against their plain
    versions at each of ``LSTM_LAYER_CASES``: every output within the rule
    of ``LAYER_F64_FACTOR`` and ``LAYER_F64_FLOOR`` against the plain
    version run in float64, two calls bitwise, one launch a call. Each
    direction timed by CUDA events (``LAYER_TIMING``) beside its bound:
    the kernel alone, and the layer's whole forward or backward four ways
    (``_layer_layouts``), side by side; with ``cudaOccupancyMaxActiveClusters``.
    Returns the kernels line's ``lstm_layer_fwd`` and ``lstm_layer_bwd``
    entries at CharLSTM's training shape (launches from the run)."""
    import torch
    from feddrift_torch.kernels.lstm_layer import (lstm_layer_bwd,
                                                   lstm_layer_bwd_ref,
                                                   lstm_layer_fwd,
                                                   lstm_layer_fwd_ref,
                                                   max_active_clusters)
    from feddrift_torch.models.base import model_numerics
    entries = {}
    clusters = {d: max_active_clusters(256, d) for d in ("fwd", "bwd")}
    for label, K, N, L, H, grad in LSTM_LAYER_CASES:
        zx64, wh64, b64, dH64 = _layer_inputs(K, N, L, H)
        zx, wh, b, dH = (t.float() for t in (zx64, wh64, b64, dH64))
        with torch.no_grad(), model_numerics():
            before = lstm_layer_fwd.launches, lstm_layer_bwd.launches
            got = lstm_layer_fwd(zx, wh, b, state=grad)
            again = lstm_layer_fwd(zx, wh, b, state=grad)
            outs = {"h": (got[0], again[0])}
            if grad:
                outs.update(c=(got[1], again[1]), gates=(got[2], again[2]))
                outs["dZ"] = (lstm_layer_bwd(dH, got[2], got[1], wh),
                              lstm_layer_bwd(dH, again[2], again[1], wh))
            torch.cuda.synchronize()
            launched = (lstm_layer_fwd.launches - before[0],
                        lstm_layer_bwd.launches - before[1])
            bitwise = all(torch.equal(a, b_) for a, b_ in outs.values())
            p32 = lstm_layer_fwd_ref(zx, wh, b, state=grad)
            p64 = lstm_layer_fwd_ref(zx64, wh64, b64, state=grad)
            plain = {"h": (p32[0], p64[0])}
            if grad:
                plain.update(c=(p32[1], p64[1]), gates=(p32[2], p64[2]))
                plain["dZ"] = (lstm_layer_bwd_ref(dH, p32[2], p32[1], wh),
                               lstm_layer_bwd_ref(dH64, p64[2], p64[1],
                                                  wh64))
            errs, max_abs = {}, {}
            for key, (k32, _) in outs.items():
                q32, q64 = plain[key]
                errs[key] = (_f64_dist(k32, q64), _f64_dist(q32, q64))
                max_abs[key] = float((k32.double() - q64).abs().max())
            del p32, p64, plain
        within = all(e <= LAYER_F64_FACTOR * p + LAYER_F64_FLOOR
                     for e, p in errs.values())
        want = (2, 2 if grad else 0)
        bounds = _layer_bounds(K, N, L, H, grad)
        fields = dict(case=label, K=K, N=N, L=L, H=H, gradient=grad,
                      two_calls_bitwise=bitwise, launches=list(launched),
                      launches_want=list(want),
                      max_active_clusters=clusters,
                      rule=f"dist <= {LAYER_F64_FACTOR} x plain32 dist + "
                      f"{LAYER_F64_FLOOR}",
                      **{f"{key}_dist_vs_f64": e for key, (e, _) in
                         errs.items()},
                      **{f"{key}_plain32_dist_vs_f64": p for key, (_, p) in
                         errs.items()})
        # timing, float32, under the model path's numerics
        with model_numerics():
            calls = {"fwd": {"kernel": lambda: lstm_layer_fwd(
                zx, wh, b, state=grad), "plain": lambda: lstm_layer_fwd_ref(
                    zx, wh, b, state=grad)}}
            if grad:
                calls["bwd"] = {"kernel": lambda: lstm_layer_bwd(
                    dH, got[2], got[1], wh), "plain": lambda:
                    lstm_layer_bwd_ref(dH, got[2], got[1], wh)}
            layouts, nets = _layer_layouts(zx, wh, b)
            ins = [t.clone().requires_grad_(grad) for t in (zx, wh, b)]
            graphs = {}
            for name, fn in layouts.items():
                if grad:
                    graphs[name] = fn(*ins)
                    tensors = ins if name != "cudnn" else [
                        p for net in nets for p in net.parameters()]
                    calls["bwd"][name] = (
                        lambda out=graphs[name], ts=tensors:
                        torch.autograd.grad(out, ts, dH,
                                            retain_graph=True))
                calls["fwd"][name] = (lambda fn=fn: fn(*ins)) if grad \
                    else (lambda fn=fn: _no_grad(fn, zx, wh, b))
            times = {d: _interleaved(
                lambda f: _time_ms(f, LAYER_TIMING["iters"]), c,
                LAYER_TIMING["rounds"]) for d, c in calls.items()}
            del graphs, ins, nets
        for d, t in times.items():
            bound_ms, by = bounds[d]
            fields.update({f"{d}_{name}_ms": v for name, v in t.items()})
            fields.update({f"{d}_bound_ms": bound_ms, f"{d}_bound_by": by,
                           f"{d}_kernel_vs_bound": t["kernel"] / bound_ms})
        _say("train_rnn_layer", **fields)
        if not (bitwise and within and launched == want):
            raise AssertionError(f"lstm_layer at {label}: two calls bitwise "
                                 f"{bitwise}, launches {launched} (want "
                                 f"{want}), (distance, plain float32's) from "
                                 f"float64 {errs}")
        if label == "rnn_train":
            for d, part in (("fwd", "h"), ("bwd", "dZ")):
                t = times[d]
                entries[d] = {
                    "name": f"lstm_layer_{d}", "route": "cuda",
                    "source": "feddrift_torch/kernels/csrc/lstm_layer.cu",
                    "replaces": "feddrift_tpu/models/rnn.py:25 (flax's "
                    "nn.RNN(nn.OptimizedLSTMCell), a lax.scan; also :26, "
                    ":40; left to XLA: no Pallas kernel)",
                    "case": f"K {K}, N {N}, L {L}, H {H} (CharLSTM's "
                    f"training step: M·C pairs of B rows)",
                    "launches": None,
                    "max_abs_err": max_abs[part],
                    "error_against": "the plain version in float64",
                    "ms": t["kernel"],
                    "plain_ms": t["plain"], "bound_ms": bounds[d][0],
                    "bound_by": bounds[d][1],
                    "library_ms": t["cudnn"],
                    "library": f"cuDNN's layer (torch._VF.lstm, K calls of "
                    f"nn.LSTM on a {LAYER_CUDNN_INPUT}-wide input"
                    + ("" if d == "fwd" else ", autograd's backward: "
                       "every weight's gradient") + ")",
                    "per_step_cell_kernels_ms": t["per_step_cell_kernels"],
                    "per_step_fused_cell_ms": t["per_step_fused_cell"],
                    "layer_op_ms": t["layer"],
                    "max_active_clusters": clusters[d]}
        del zx64, wh64, b64, dH64, zx, wh, b, dH, got, again, outs
        torch.cuda.empty_cache()
    return entries["fwd"], entries["bwd"]


def _no_grad(fn, *args):
    import torch
    with torch.no_grad():
        return fn(*args)


def _model_errors(mod, x, y) -> tuple[dict, str | None]:
    """``mod``'s logits and the gradient of its cross entropy on ``(x,
    y)`` on the card in float32 and float64 and on the CPU in float32
    (all under the package's ``model_numerics``, as ``core/functional.py``'s
    programs run) against the CPU in float64, and two card forwards
    bitwise: the float64 card within ``CONV_F64_CARD_TOL``, the float32
    card within the larger of ``CONV_F64_FLOOR`` and ``CONV_F64_FACTOR``
    times the CPU float32's own error. Returns the line's fields and what
    failed (None if nothing)."""
    import torch
    from feddrift_torch.core.functional import cross_entropy
    from feddrift_torch.models.base import model_numerics
    params = mod.init_params(torch.Generator().manual_seed(0), "cpu")
    out = {}
    for key, dt, dev in (("card", torch.float32, "cuda"),
                         ("card64", torch.float64, "cuda"),
                         ("cpu32", torch.float32, "cpu"),
                         ("cpu64", torch.float64, "cpu")):
        xs = x.to(dev, dt) if x.is_floating_point() else x.to(dev)
        with model_numerics():
            flat = mod.pack(params).to(dev, dt).requires_grad_(True)
            logits = mod(mod.unpack(flat), xs)
            grad, = torch.autograd.grad(cross_entropy(logits, y.to(dev)),
                                        flat)
        out[key] = (logits.detach().cpu(), grad.cpu())
    with model_numerics():
        again = mod(mod.unpack(mod.pack(params).cuda()), x.cuda())
    bitwise = bool(torch.equal(again.cpu(), out["card"][0]))
    errs, errs64 = {}, {}
    for i, part in enumerate(("logits", "grad")):
        want = out["cpu64"][i]
        cpu32 = _rel_err(out["cpu32"][i], want)
        tol = max(CONV_F64_FLOOR, CONV_F64_FACTOR * cpu32)
        errs[part] = (_rel_err(out["card"][i], want), cpu32, tol)
        errs64[part] = _rel_err(out["card64"][i], want)
    fields = dict(params=mod.num_params, rows=x.shape[0],
                  card64_logits_rel_err_vs_f64=errs64["logits"],
                  card64_grad_rel_err_vs_f64=errs64["grad"],
                  card64_tol=CONV_F64_CARD_TOL,
                  logits_rel_err_vs_f64=errs["logits"][0],
                  cpu32_logits_rel_err_vs_f64=errs["logits"][1],
                  logits_tol=errs["logits"][2],
                  grad_rel_err_vs_f64=errs["grad"][0],
                  cpu32_grad_rel_err_vs_f64=errs["grad"][1],
                  grad_tol=errs["grad"][2], two_forwards_bitwise=bitwise)
    if bitwise and all(e <= tol for e, _, tol in errs.values()) \
            and all(e <= CONV_F64_CARD_TOL for e in errs64.values()):
        return fields, None
    return fields, (f"two forwards bitwise {bitwise}, float32 (error, cpu "
                    f"float32's, tolerance) {errs}, float64 errors "
                    f"{errs64} (tolerance {CONV_F64_CARD_TOL})")


def _rnn_model_checks() -> None:
    """Each of ``RNN_CHECK_MODELS`` at its published width on
    ``RNN_CHECK_ROWS`` random token rows through ``_model_errors`` (the
    card's forwards and backwards: CharLSTM's float32 through the layer
    kernels, once a layer; its float64 and WordLSTM's through the cell
    kernels, once a step), and those launches counted."""
    import numpy as np
    import torch
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.data.drift_dataset import DriftDataset
    from feddrift_torch.kernels.lstm_cell import (lstm_cell_bwd,
                                                  lstm_cell_fwd)
    from feddrift_torch.kernels.lstm_layer import (lstm_layer_bwd,
                                                   lstm_layer_fwd)
    from feddrift_torch.models import create_model
    for name, dataset, L, V in RNN_CHECK_MODELS:
        ds = DriftDataset(x=np.zeros((1, 1, 1, L), np.int32),
                          y=np.zeros((1, 1, 1), np.int32),
                          concepts=np.zeros((1, 1), np.int64),
                          num_classes=V, name=dataset, is_sequence=True)
        mod = create_model(name, ds, ExperimentConfig())
        gen = torch.Generator().manual_seed(1)
        x = torch.randint(0, V, (RNN_CHECK_ROWS, L), generator=gen,
                          dtype=torch.int32)
        y = torch.randint(0, V, (RNN_CHECK_ROWS,), generator=gen)
        counters = (lstm_cell_fwd, lstm_cell_bwd, lstm_layer_fwd,
                    lstm_layer_bwd)
        before = [f.launches for f in counters]
        fields, failed = _model_errors(mod, x, y)
        launched = [f.launches - b for f, b in zip(counters, before)]
        # three card forwards (float32 twice, float64), two backwards: a
        # float32 layer of CharLSTM's on the layer kernels, every other
        # layer's step on the cell kernels
        layers = 2 if name == "rnn" else 1
        if name == "rnn":
            want = [L * layers, L * layers, 2 * layers, layers]
        else:
            want = [3 * L * layers, 2 * L * layers, 0, 0]
        _say("train_rnn_model", model=name, dataset=dataset, seq_len=L,
             classes=mod.num_classes, **fields,
             cell_launches=launched[:2], cell_launches_want=want[:2],
             layer_launches=launched[2:], layer_launches_want=want[2:])
        if failed or launched != want:
            raise AssertionError(f"{name} on the card: {failed}, cell and "
                                 f"layer launches {launched} (want "
                                 f"{want})")


def _rnn_round_checks() -> dict:
    """The timing case: one round of the committed run's configuration (M
    3, C 10, S 5, B 32, seq 80; model 2 with no active client) from fixed
    draws, twice, bitwise; the peak of allocated device memory in the
    first, its wall (median of 5), and under the profiler its device ms
    (the union of the kernels' intervals), launches, the layer and cell
    kernels' launches, plain calls and top device operations, no gate.
    Then K2 on that round's client stack (P 820,522) through
    ``_k2_check``: the kernels line's ``fedavg_rnn``."""
    import statistics

    import torch
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.simulation.runner import Experiment
    exp = Experiment(ExperimentConfig(**RNN_RUNS[0][1]))
    M, C, T1 = exp.pool.num_models, exp.C_, exp.x.shape[1]
    tw = torch.zeros(M, C, T1, device="cuda")
    tw[:2, :, 0] = 1.0                        # model 2: no active client
    step, params = exp.step, exp.pool.params
    opt = step.init_opt_states(params, M, C)
    step.generator.manual_seed(0)
    draws = step.draw_batches(tw, 1, exp.x.shape[2])
    draws = (draws[0][0], draws[1][0])

    def fn():
        return step.train_round(params, opt, exp.x, exp.y, tw, draws=draws)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    a = fn()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = _read_counts()
    one = (counts["lstm_layer_fwd_launches"],
           counts["lstm_layer_bwd_launches"],
           counts["lstm_cell_fwd_launches"], counts["lstm_cell_bwd_launches"])
    plain = {k: v for k, v in counts["plain_calls"].items() if v}
    b = fn()
    bitwise = all(torch.equal(a[i][k], b[i][k]) for i in (0, 2)
                  for k in a[i]) \
        and all(torch.equal(a[1][k], b[1][k]) for k in a[1]) \
        and torch.equal(a[3], b[3]) and torch.equal(a[4], b[4])
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    kernels, wall_us, union_us = _profile(fn, 2, union=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    S = step.num_steps
    want = (2 * S, 2 * S, 0, 0)                # two layers a local step
    _say("train_rnn_round", model="rnn", dataset="fed_shakespeare", M=M,
         C=C, S=S, B=step.batch_size, seq_len=exp.x.shape[3],
         P=exp.module.num_params, two_rounds_bitwise=bitwise,
         wall_ms=statistics.median(walls), peak_memory_gb=peak_gb,
         card_memory_gb=torch.cuda.get_device_properties(0).total_memory
         / 1e9,
         device_ms=busy_us / 2 / 1e3 if busy_us else "not measured",
         device_union_ms=union_us / 2 / 1e3,
         device_union_share=union_us / wall_us,
         profiled_wall_ms=wall_us / 2 / 1e3,
         launches=sum(e.count for e in kernels) / 2,
         lstm_layer_launches=list(one[:2]), lstm_cell_launches=list(one[2:]),
         launches_want=list(want), plain_calls=plain,
         lstm_layer_device_ms=sum(e.self_device_time_total for e in kernels
                                  if "lstm_layer" in e.key) / 2 / 1e3,
         fedavg_launches=sum(e.count for e in kernels
                             if "fedavg_kernel" in e.key) / 2,
         top_device_ops=_top_device_ops(kernels, 2))
    if not bitwise or one != want or plain:
        raise AssertionError(f"an rnn round twice from the same inputs: "
                             f"bitwise {bitwise}; layer and cell launches "
                             f"{one} (want {want}), plain calls {plain}")
    mod = exp.module
    client, n, prev = mod.pack(a[2]), a[3], mod.pack(exp.pool.params)
    entry = _k2_check("rnn", client, n, prev, dataset="fed_shakespeare",
                      model="rnn")
    entry.update(name="fedavg_rnn", case=f"{entry['case']} "
                 f"(fed_shakespeare, CharLSTM, an rnn round's client stack)")
    del exp, a, b, client
    torch.cuda.empty_cache()
    return entry


def _rnn_drive(run: str, cfg, path: str, ref=None) -> tuple[dict, list]:
    """One LSTM run through the runner on the card: every round one
    ``fedavg.cu`` launch; a layer the layer kernels take
    (``layer_refusal``) launched once a local step forward and backward
    (and once an eval piece forward), else its steps' cell kernels; the
    other route's kernels not at all; no K1, K3, K4 or plain call (the
    layer's and cell's included), the data and pool on the card; one
    ``train_rnn`` line with its wall, the peak of allocated device memory
    (its evals' included), launches, each step's Test/Acc and, given the
    committed series ``ref``, the gate (a round's device time is
    ``_rnn_round_checks``'s: a profiled step of this run would take 20
    more rounds). Returns the (cell forward, cell backward, layer forward,
    layer backward) launches and the gate's failures."""
    import torch
    from feddrift_torch.kernels.lstm_layer import layer_refusal
    torch.cuda.reset_peak_memory_stats()
    got = _drive(cfg, syncs=False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    exp, accs = got.pop("exp"), got["accs"]
    counts = (got["lstm_cell_fwd_launches"], got["lstm_cell_bwd_launches"],
              got["lstm_layer_fwd_launches"], got["lstm_layer_bwd_launches"])
    rounds = cfg.train_iterations * cfg.comm_round
    widths = [shape[0] for key, (shape, _) in
              exp.module.param_specs().items() if key.endswith("/hi/kernel")]
    on_layer = all(layer_refusal(torch.float32, w) is None for w in widths)
    layer_bwd = rounds * exp.step.num_steps * len(widths) if on_layer else 0
    # the layer route: the backward's launches exactly, the forward's those
    # and the evals' (a forward of every layer a piece); the per-step route:
    # the cells launched, the layer kernels not
    routed = counts[3] == layer_bwd and (
        (counts[:2] == (0, 0) and counts[2] > layer_bwd
         and (counts[2] - layer_bwd) % len(widths) == 0) if on_layer
        else (all(counts[:2]) and counts[2] == 0))
    on_card = all(t.is_cuda for t in (exp.x, exp.y,
                                      *exp.pool.params.values()))
    fields, missed = {}, []
    if ref is not None:
        step_tol, mean_tol = _rnn_gate(run)
        diffs = [a - b for a, b in zip(accs, ref)]
        mean, ref_mean = sum(accs) / len(accs), sum(ref) / len(ref)
        within = max(map(abs, diffs)) <= step_tol \
            and abs(mean - ref_mean) <= mean_tol
        fields = dict(committed_test_acc=ref, test_acc_mean=mean,
                      committed_mean=ref_mean,
                      max_step_diff=max(map(abs, diffs)), step_tol=step_tol,
                      mean_tol=mean_tol, within_gate=within)
        if not within:
            missed.append(f"{run}: Test/Acc per step {accs} against the "
                          f"committed {ref} (step tolerance {step_tol}, "
                          f"mean {mean_tol})")
    _say("train_rnn", run=run, model=cfg.model, dataset=cfg.dataset,
         algo=cfg.concept_drift_algo, arg=cfg.concept_drift_algo_arg,
         models=exp.pool.num_models, clients=exp.C_,
         params=exp.module.num_params, seq_len=exp.x.shape[3],
         steps=cfg.train_iterations, rounds=rounds, paths=got["paths"],
         wall_s=got["wall_s"], step_wall_s=got["step_wall_s"],
         rounds_per_s=got["rounds_per_s"], peak_memory_gb=peak_gb,
         fedavg_launches=got["k2_launches"], k1_launches=got["k1_launches"],
         k3_launches=got["k3_launches"],
         k4_launches=got["k4a_launches"] + got["k4b_launches"],
         route="layer kernels" if on_layer else "per-step cell kernels",
         lstm_cell_fwd_launches=counts[0], lstm_cell_bwd_launches=counts[1],
         lstm_layer_fwd_launches=counts[2], lstm_layer_bwd_launches=counts[3],
         lstm_layer_bwd_want=layer_bwd,
         plain_calls=got["plain_calls"], on_card=on_card, test_acc=accs,
         chance=1.0 / exp.ds.num_classes, **fields)
    if got["k2_launches"] != rounds or got["k1_launches"] \
            or got["k3_launches"] or got["k4a_launches"] \
            or got["k4b_launches"] or any(got["plain_calls"].values()) \
            or not routed or set(got["paths"]) != {path} or not on_card \
            or len(accs) != cfg.train_iterations:
        raise AssertionError(f"{run}: fedavg.cu launched "
                             f"{got['k2_launches']} times for {rounds} "
                             f"rounds, K1 {got['k1_launches']}, K3 "
                             f"{got['k3_launches']}, K4 "
                             f"{got['k4a_launches']} / "
                             f"{got['k4b_launches']}, cell and layer "
                             f"(forward, backward) {counts} (the layer "
                             f"route {on_layer}, its backward's want "
                             f"{layer_bwd}), plain calls "
                             f"{got['plain_calls']}, paths {got['paths']} "
                             f"(want {path}), on the card {on_card}, "
                             f"{len(accs)} steps")
    del exp, got
    torch.cuda.empty_cache()
    return counts, missed


def _rnn_runs() -> tuple[tuple, tuple, int, list[str]]:
    """``RNN_RUNS`` gated against their committed runs (``_rnn_gate``),
    then ``RNN_SO_RUN`` ungated. Returns the layer kernels' (forward,
    backward) launches and ``fedavg.cu``'s over the gated runs, the cell
    kernels' over the WordLSTM run (the per-step route's), and the runs
    outside their gates."""
    from feddrift_torch.config import ExperimentConfig
    here = os.path.dirname(os.path.abspath(__file__))
    layer = [0, 0]
    agg = 0
    missed = []
    for run, kw, pinned, path in RNN_RUNS:
        ref = _reference_accs(os.path.join(here, "runs", run,
                                           "metrics.jsonl"), pinned)
        cfg = ExperimentConfig(**kw)
        counts, miss = _rnn_drive(run, cfg, path, ref)
        layer[0] += counts[2]
        layer[1] += counts[3]
        agg += cfg.train_iterations * cfg.comm_round
        missed += miss
    counts, _ = _rnn_drive("stackoverflow_nwp-rnn_stackoverflow-softcluster",
                           ExperimentConfig(**RNN_SO_RUN), "fused")
    return tuple(layer), counts[:2], agg, missed


def phase_train_rnn() -> tuple[dict, dict, dict, dict, dict]:
    """The LSTMs on the card: the layer kernels against their plain
    versions and timed beside the per-step routes and cuDNN
    (``_lstm_layer_checks``), the cell kernels likewise
    (``_lstm_cell_checks``), ``_rnn_model_checks``, the timing case and K2
    at CharLSTM's width (``_rnn_round_checks``), then the committed run and
    the WordLSTM run (``_rnn_runs``), every run driven before the phase
    fails. Returns the kernels line's ``lstm_layer_fwd``,
    ``lstm_layer_bwd``, ``lstm_cell_fwd``, ``lstm_cell_bwd`` and
    ``fedavg_rnn`` entries, the layer kernels' and K2's launches those of
    the gated run, the cell kernels' those of the WordLSTM run."""
    layer_fwd, layer_bwd = _lstm_layer_checks()
    fwd_entry, bwd_entry = _lstm_cell_checks()
    _rnn_model_checks()
    agg_entry = _rnn_round_checks()
    ((layer_fwd["launches"], layer_bwd["launches"]),
     (fwd_entry["launches"], bwd_entry["launches"]), agg_entry["launches"],
     missed) = _rnn_runs()
    if missed:
        raise AssertionError("rnn runs outside their gates: "
                             + "; ".join(missed))
    return layer_fwd, layer_bwd, fwd_entry, bwd_entry, agg_entry


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    try:
        import feddrift_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a checkout of the repository "
              "(feddrift_torch not found)", file=sys.stderr)
        return 1
    walls = {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[fn.__name__.removeprefix("phase_")] = time.perf_counter() - t0
        return out
    try:
        card = timed(phase_device)
        timed(phase_build)
        entry = timed(phase_kernel)
        dense_entry = timed(phase_dense)
        timed(phase_serve, entry, dense_entry)
        train_entry, wide = timed(phase_train_kernel)
        cdf_entry, search_entry = timed(phase_train_draw)
        agg_entry, fused_entry, fold_entry, eval_entry, more = \
            timed(phase_train_agg_eval)
        wide.update(more)
        timed(phase_train, fused_entry, fold_entry, eval_entry)
        timed(phase_train_algos, cdf_entry, search_entry)
        timed(phase_train_sampling)
        timed(phase_train_per_round_kinds)
        timed(phase_train_general, train_entry, agg_entry)
        timed(phase_train_mnist, wide)
        timed(phase_train_lr, wide)
        timed(phase_nan_semantics)
        timed(phase_train_gmm)
        timed(phase_train_guard)
        timed(phase_train_preempt)
        timed(phase_trace_plane)
        timed(phase_train_tabular, wide)
        timed(phase_train_images, wide)
        conv_entry = timed(phase_train_conv)
        timed(phase_train_fmow, wide)
        rnn_entries = timed(phase_train_rnn)
        _say("phase_walls", seconds=walls, total_s=sum(walls.values()))
    except Exception:   # noqa: BLE001 — report the phase that failed
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    kernels = [entry, train_entry, fused_entry, fold_entry, dense_entry,
               cdf_entry, search_entry, agg_entry, eval_entry] \
        + [wide[k] for k in WIDE_ENTRIES] + [conv_entry, *rnn_entries]
    for e in kernels:   # above 1: the kernel loses to its plain version
        e["ms_vs_plain"] = e["ms"] / e["plain_ms"]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
