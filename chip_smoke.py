#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and
``nvcc``. Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit, torch/CUDA versions, TF32
   flags (both set off);
2. build: compile the kernels from ``src/repro_torch/csrc`` and print the
   compiler's register / shared-memory / spill report; for the twelve
   instantiations of the Gram engine's tile kernels (csrc/gram_pipe.cuh:
   gram_tiles, triangle and dense, for syrk_tri and weighted_gram;
   stat_tiles, triangle and window, for the two statistics; each with
   fp32 16-byte, fp32 4-byte and bf16 copies) also their dynamic shared
   memory and resident CTAs an SM, naming any spills, and require <= 128
   registers and two CTAs an SM of each; then the row pass's twelve
   instantiations (six epilogues x f32, bf16 X); the Nystrom projection
   phi_tiles (write and score, on the engine's CopyPair) under the same
   gates; the cross-Gram's six (csrc/rbf.cuh: cross_tiles on the engine's
   CopyPair and cross_direct for small depths, each rbf_gram's row-major
   and the Nystrom kernels' landmark-major rbf and linear) under the same
   gates, and its transposing pass cross_operand (float32, bfloat16 X);
   and the E-step's four (estep_rows: float32, bfloat16 X x a group of
   four columns one 16-byte (8-byte) load or four element loads), which
   must fit fused_estep.CTAS_PER_SM CTAs an SM;
3. kernels vs plain: each kernel at its main-path shape and at odd masked
   shapes, f32 and bf16 X, in the well-conditioned and the hinge regime of
   tests/test_torch_kernels_ref.py, against the plain PyTorch version
   evaluated in float64; each called twice and required bitwise equal;
   then timed (CUDA events, median of 10 calls after warm-up, each behind
   a device sleep so that the host's preparation of the call is not
   counted) beside the plain version, a one-call library equivalent where
   one exists, and the bound max(flop / 67 TFLOP/s, bytes / 3.35 TB/s).
   The three mc_hinge variants of fused_stats (noise operands, the in-kernel
   counter seed, and four chains on the seed) are held so: margins
   against the float64 plain version; gamma against the plain epilogue
   applied to the kernel's own margin and noise (at least 99 % of rows
   bitwise equal, 99.95 % within 1e-3 relative, all finite and >= eps);
   b and Sigma against a float64 recomputation from the kernel's own
   gamma;
4. main path, K <= 1536: LIN-EM-CLS fit on make_alpha_like(300,000 x 500)
   (250,000 training rows, 50,000 held out) through the kernels and
   through the plain path, both on the card, held to the bands of
   tests/test_torch_em_cls.py; fused_stats must have launched once per
   iteration run;
5. main path, K > 1536: 5 iterations at K = 2,048 through fused_estep
   and syrk_tri, and not through fused_stats; then a torch.profiler
   breakdown of the fit (device time by kernel) and its set-up time;
6. main path, LIN-MC-CLS (the Gibbs sampler) on the alpha-like set:
   rng='fused' through the kernels and through the plain path, both
   converged, accuracy within 0.01, posterior-mean weights within 3x the
   spread of two plain fits (seeds 0 and 1); an rng='host' fit through
   the noise-operand variant and an n_chains=4 fit through the multichain
   variant, each launched once per step run; then a torch.profiler
   breakdown of one rng='fused' fit and its set-up time;
7. main path, KRN-{EM,MC}-CLS through NystromSVM, fused route: the
   KRN configuration of examples/nystrom_kernel_svm.py (lam 0.1, sigma
   0.7, max_iters 60) on make_circles(1,000,000) with m = ceil(sqrt(N)) =
   1,000 landmarks, held out on make_circles(100,000, seed=1): EM, MC
   rng='fused' and MC rng='host', each through the kernels and through the
   plain path on the same landmarks and projection. Every step runs
   nystrom_fused_stats (once a step), never nystrom_phi; rbf_gram runs once
   a fit (the landmark Gram), nystrom_score on predict; held-out accuracy
   >= 0.99 and within 0.01 of the plain fit; the kernel fit's peak device
   memory below the 4.0 GB that phi (1,000,000 x 1,001 float32) would
   take; then a torch.profiler breakdown of the EM kernel fit;
8. main path, featurize-then-accumulate route: NystromSVM with 2,048
   landmarks (m > 1,024) on the alpha-like 250,000 x 500 training rows of
   phase 4, sigma = sqrt(500), 5 EM iterations: every step runs
   nystrom_phi, then fused_estep and syrk_tri at K = 2,049, never
   nystrom_fused_stats; objective trace within 2e-2 relative and held-out
   accuracy within 0.01 of the plain fit on the same landmarks and
   projection, then a torch.profiler breakdown of the kernel fit on its
   featurizer. The weights band of 5e-2 is measured and printed, not
   gated: at this configuration two correct float32 fits sit ~14 % apart
   (a posterior condition number ~3.5e6), so the script prints both
   fits' distance to a float64 EM on the same featurizer beside it
   (ROADMAP section 3).

9. main path, LIN-{EM,MC}-SVR, the paper's Table 6 at YearPredictionMSD's
   size: make_year_like(515,345, 90), the first 463,715 rows to train and
   the last 51,630 held out (the data set's own split), K = 91 with the
   bias column, lam = lam_from_C(0.01), eps_ins 0.3, max_iters 100
   (benchmarks/table6_svr.py). EM through the kernels and through the
   plain path: iterations within 3, objective trace within 5e-2 (two
   correct float32 EM-SVR fits drift ~2 % apart: ROADMAP section 3),
   weights within 5e-2, held-out RMSE within 0.01; the ridge RMSE and both
   fits' distance to a float64 EM are printed, beside that EM's distance
   to itself with the targets moved by 1e-15 and to a float32 E-step with
   float64 Sigma and Cholesky (where the drift comes from). MC
   rng='fused' through the kernels and the plain path (seeds 0 and 1),
   rng='host' and n_chains=4: converged, RMSE within 0.01, weights within
   3x the plain seed spread.
   Each kernel fit launches its SVR variant of fused_stats once a step;
10. main path, KRN-{EM,MC}-SVR through NystromSVM on the same split, m =
   ceil(sqrt(463,715)) = 681, sigma = sqrt(90), lam 1.0, eps_ins 0.3: EM,
   MC rng='fused' and rng='host', kernels and plain path on one
   featurizer; nystrom_fused_stats once a step, never nystrom_phi,
   rbf_gram once a fit, nystrom_score on predict; RMSE within 0.01, the EM
   objective trace within 2e-2 (with the float64 EM printed), the weights
   distance printed; the kernel fits' peak device memory below phi's
   463,715 x 682 x 4 B = 1,206 MiB.

Phase 3 also holds the four SVR variants of fused_stats (em_svr; mc_svr
with four noise operands, with the seed, and with four chains) at
1037 x 29 (f32 and bf16, masked and not, targets away from the knees and
at them) and at the year shape 463,715 x 91; gamma and omega each against
the plain epilogue on the kernel's own margin and noise (em_svr bitwise),
b and Sigma against a float64 recomputation from the kernel's own gamma
and omega; weighted_gram (the dense grid of the Table 9 statistic) at odd
shapes and at 250,000 x 500, timed beside syrk_tri and torch.einsum, and
called once through ops.weighted_gram as a user calls it (its launch
count); syrk_tri also at phase 8's 250,000 x 2,049 beside its einsum and
bound; each Gram kernel's rate in TFLOP/s, of the FMAs its tiles execute
and of the flop the function needs; the engine's design choices, timed
past the wrappers (uncounted) on the same inputs: 4-byte against 16-byte
copies for syrk_tri at 131,072 x 2,048 and weighted_gram at 250,000 x
500, and each wrapper's split plan beside shorter and longer splits (the
L2 question at K = 2,048, the last wave at Table 9); one em_svr call at
K = 2,048 through the split route, where syrk_tri must launch; the three SVR
variants of nystrom_fused_stats at odd masked shapes and at 463,715 x 90
with m = 681.

Phase 3 also holds the four Nystrom kernels against their plain versions
in float64: rbf_gram at (1,000 x 2)^2 and (2,048 x 500)^2; nystrom_phi at
250,000 x 500 with m = 2,048; nystrom_score at 100,000 x 2 with m = 1,000
and C = 1; nystrom_fused_stats (em_hinge, mc_hinge with noise operands and
with the seed) at 1,000,000 x 2 with m = 1,000; each also at odd masked
shapes with the bias column, both kinds (rbf, linear), f32 and bf16 X.
Tolerances: rbf_gram |d| <= 1e-5 |ref| + 1e-7; phi |d| <= 1e-5 (|k| @
|proj|) elementwise, scores through |W|, margins through |w|; em_hinge
gamma |dg| <= |dm| + 2^-24 (g + g_ref) + 1e-7; mc_hinge gamma against the
plain epilogue on the kernel's own margin and noise; b and Sigma within
1e-5 max of a float64 recomputation from the kernel's own phi (the
nystrom_phi kernel's bits) and gamma. Beside them, the device time by
stage (torch.profiler, a call's mean over three: norms, cross-Gram,
projection, score reduce, other) of nystrom_phi, nystrom_score and one
nystrom_fused_stats call at phase 7's and phase 10's shapes; the
projection stage at phase 7's, 8's and 10's shapes beside torch.mm of the
same row chunks' cross-Gram and proj (TF32 off, summed over the chunks)
and its bound 2 N m M flop at the fp32 peak; the cross-Gram stage (its
operands' transposing pass and its product) at the same three shapes
beside torch.mm of the same row chunks with the landmarks (TF32 off) and
its bound max(2 N m D flop, the bytes of X, L and the (m, N) output); a
phi_design line at those shapes (each operand's copy path, proj's
stride, the CTAs of a chunk and their waves, phi_tiles' registers,
spills, shared memory and CTAs an SM); and cross_design: the cross-
Gram's two routes on the same inputs at D = 2, 8, 12, 16, 32, 90 and 500
(250,000 rows, m = 1,000), in the order engine, direct, direct, engine,
beside the route rbf_gram.cross_route ships. fused_estep is timed at
phase 5's 131,072 x 2,048 and phase 8's 250,000 x 2,049, each beside
its bytes bound, the plain version and, for reference only, the
torch.mv pair X w, X^T coef.

11. the multi-device fit (the paper's Sec 4.1 reduce and the 2-D k-shard):
   four processes on cuda:0 under gloo (the card is one; NCCL refuses two
   ranks on one device; gloo stages the collectives through the host, the
   kernels run on the card), spawned with torch.multiprocessing after the
   kernels are built. Fit 1: LIN-EM-CLS on the alpha-like split on a 2 x 2
   (data x k) mesh with pad_features=2 (K = 502), held to phase 4's bands
   against the one-device kernel fit with the same pad_features; the
   window variant of fused_stats once a step on each rank, the full one
   never. Fit 2: LIN-MC-CLS rng='fused' on a 4 x 1 mesh, held to phase 6's
   bands against phase 6's kernel fit, its first objective within 1e-6
   (the same draws). Fit 3: KRN-EM-SVR on phase 10's year split and
   featurizer (m = 681, phi width 682) on a 2 x 2 mesh, held to phase 10's
   bands (RMSE within 0.01, trace within 2e-2); the window variant of
   nystrom_fused_stats once a step. Then short (4-iteration) 2 x 2 fits run
   each other window variant once a step. In every fit all ranks' weights
   are bitwise equal; step times are printed labelled "4 ranks share one
   card" (they say nothing about scaling). A one-rank NCCL group fits
   LIN-EM-CLS bitwise equal to the fit without a mesh. Where two or more
   cards are visible, fit 1 runs again under NCCL, one rank a card;
   otherwise the script says that no multi-card run was made.

Phase 3 also holds the column window of fused_stats (its six single-chain
variants) and of nystrom_fused_stats (six variants): at 1037 x 29 with the
reference's windows and at 1037 x 300 (windows across and between 128-
column tiles), f32 and bf16, both regimes; at 250,000 x 502 with (0, 251)
and (251, 251); the Nystrom windows at odd masked shapes and at the year
shape 463,715 x 90, m = 681, with (0, 341) and (341, 341). Each window is
called twice and must be bitwise repeatable, bitwise the full variant's
column slice (margin, gamma, omega and b bitwise the full variant's), and
within 1e-5 max|S64| of the float64 statistic from the kernel's own gamma
(and omega); it is timed at the second window with the bound flop
2 N K blk + 4 N K (Nystrom: plus the cross-Gram and the projection).

Phase 3 ends with the statistics' design choices on the Gram engine,
timed through the wrappers on the same inputs (nothing asserted): each
shipped split plan against the plan the staged pass ran on (tile_plan
for fused_stats at 250,000 x 501, one chain and four, and at a rank's
window (251, 251) of 125,000 x 502; the old stats_plan for
nystrom_fused_stats at 1,000,000 x 2, m = 1,000), and the Nystrom phi
scratch at a 16-byte row stride against M (phase 7's and phase 10's
shapes), in the order a, b, b, a.

12. LIN-{EM,MC}-MLT, the paper's Table 8 at its full size
   (benchmarks/table8_mlt.py, full=True): make_mnist8m_like(200,000, 784,
   10), the last 40,000 rows held out, K = 785 with the bias column (the
   Gram engine's 4-byte copies), lam_from_C(0.04) = 50, max_iters 40,
   min_iters 25, burn-in 8. EM through the kernels and through the plain
   path: iterations within 3, objective trace within 2e-2, held-out
   accuracy within 0.01; the weights band of 5e-2 is measured and printed,
   not gated, as in phase 8: two correct float32 MLT EM fits at this size
   sit ~17 % apart in W (the flat start, where rows clamp at eps, magnifies
   last-bit differences), so both fits' distance to a float64 EM and the
   held-out class scores' distance are printed beside it (ROADMAP section
   3). MC rng='host' (Table 8's) through the kernels and the plain
   path (seeds 0 and 1), and an rng='fused' kernel fit: all converged,
   accuracy within 0.01, posterior-mean weights within 3x the plain seed
   spread. Every kernel fit launches its fused_stats variant M = 10 times
   a step (a class pass each) and nothing else, within ceil(max_iters /
   scan_chunk) host syncs; then a torch.profiler breakdown of the EM fit:
   the device-busy share and a step by kernel, by part (row pass, Sigma,
   Cholesky and solve, F refresh) and by host op;
13. KRN-{EM,MC}-MLT through NystromSVM on phase 12's split, m = 400
   landmarks, sigma 8.0 (the median pairwise distance of 2,000 training
   rows printed beside it): rbf_gram once a fit, nystrom_phi once a step,
   the fused_stats variant 10 times a step, nystrom_score once a predict
   dispatch (C = 10; the scorer serves 1,024 rows a dispatch); against the plain path on the same featurizer, the EM
   objective trace within 2e-2 and accuracy within 0.01 (EM and MC); the
   weights distance and the EM's distance to a float64 EM printed;
14. exact KRN-{EM,MC}-CLS, Table 7 (benchmarks/table7_krn.py):
   make_circles(1,800), sigma 0.7, lam_from_C(1.0), max_iters 60, through
   the kernels, against the plain path on the CPU (the plain path on the
   card is run and printed: cuBLAS's float32 Sigma leaves P indefinite at
   its first step, ROADMAP section 3): training accuracy >= 0.97 and
   within 0.01; EM decision values within 5e-2 (and their distance to a
   float64 EM printed) and iterations within 3; MC's first gamma_mean
   within 1e-5 (the same draws); the Gram rows (1,800 > FUSED_STATS_MAX_K)
   take fused_estep (EM) once a step and syrk_tri once a step, never
   fused_stats; rbf_gram once a fit, and on predict nystrom_score once a
   dispatch (the model served through the Nystrom score cell, landmarks =
   the training rows, proj = omega) and no rbf_gram. Then a timing
   point at make_circles(16,384): one step at the default jitter (its
   objective printed: NaN, P indefinite in float32 at this size), then 5
   EM steps at jitter 1e-3 (launch counts, a finite objective, the peak
   memory) and a step's parts timed on its own inputs (syrk_tri and
   fused_estep beside their plain versions and bounds, the Cholesky, the
   solve, the prior matvec).

15. the stream driver (driver="stream"), run before phase 11. Table 5 at
   its full size (benchmarks/table5_dna.py, full=True): make_dna_like(
   2,500,000, 800), the last 10,000 rows held out, lam_from_C(1e-5), K =
   801 (N = 1,000,000, lam scaled as the benchmark scales it, when the
   host has less than 64 GB available). First the two copy paths of
   in-memory rows, one pass each through the prefetcher (a pinned staging
   ring, the page-locked array; GB/s), and the host work of a 4,096-row
   chunk, each part alone (placing it; the chunk body). LIN-EM-CLS for a
   fixed 20
   iterations, resident (scan) and streamed from the arrays at chunk_rows
   4,096 and 65,536: each fit's time, ms a pass, set-up, copy rate,
   peak_input_bytes, max_memory_allocated, host syncs, launches and held-
   out accuracy; gates: the first pass's (S, b) within 1e-4 max|S| of the
   resident first statistic, objective trace within 2e-2, weights within
   5e-2, accuracy within 0.01, peak_input_bytes = (prefetch + 2) chunks
   (below 1/100 of the resident X at 4,096 rows), one host sync an
   iteration, fused_stats once a chunk a pass; a torch.profiler breakdown
   of a 3-iteration stream fit (copies and kernels against the wall; at
   most one device-to-host copy an iteration); prefetch 1, 2, 4 and 2
   again bitwise equal. LIN-MC-CLS rng 'fused', 5 iterations, streamed
   against resident: the first gamma_mean within 1e-6. Phase 5's 131,072 x
   2,048 for 3 iterations (fused_estep and syrk_tri once a chunk);
   LIN-EM-SVR on phase 9's split (10 iterations) and LIN-EM-MLT on phase
   12's (5 iterations, class scores within 5e-2), KRN-EM-MLT on phase 13's
   featurizer (2 iterations, nystrom_phi once a chunk a pass), each
   streamed against resident. KRN-EM-CLS through NystromSVM on phase 7's
   rings (m = 1,000, 10 iterations) at 4,096 (its own featurizer, bitwise
   the resident fit's), 62,500 and 65,536 rows: accuracy within 0.01, the
   masked tail (65,536) within 1e-4 of the divisible chunking (62,500);
   rbf_gram once a fit, nystrom_score once a predict dispatch. fused_stats
   and nystrom_fused_stats timed on one stream chunk beside their bounds,
   fused_estep and syrk_tri on a K = 2,048 chunk of 4,096 rows beside
   theirs, the torch.mv pair and torch.einsum. Warm-started generations:
   three generations of a third of Table 5's training rows each at
   65,536-row chunks with window = 2 (8 iterations each, each warm-started
   from the one before; generation 3's effective (S, b) bitwise its fresh
   plus generation 2's fresh), then a decay = 0.5 pair (one iteration
   folds exactly fresh + 0.5 x the donor's (S, b)). The
   file path: make_dna_like(20,000, 200) saved as libsvm text with comment
   and blank lines, fit_libsvm streamed against the resident fit of the
   same rows (12 iterations, weights within 1e-3) beside the parse rate;
   NystromSVM.fit_libsvm on the same file with 200 reservoir landmarks
   (bitwise the host reservoir's rows) within the Nystrom bands of the
   resident fit on its featurizer;
   on a staging-ring source, prefetch 1, 2, 4 and 2 again bitwise equal
   and one IOError mid-pass absorbed by one retry, bitwise. Last, the
   resident set-up of phases 4-10's inputs built as the parent tree built
   it (host concatenation, host padding, pageable copies) and as this
   tree builds it (pinned staging, bias and padding on the card), timed
   in the order host, card, card, host and held bitwise equal.

16. serving, run after phase 15: the models of phases 4 (LIN-EM-CLS, K =
   501), 8 (KRN-EM-CLS, m = 2,048), 13 (KRN-EM-MLT, m = 400, C = 10) and
   14 (the exact KRN, 1,800 training rows, and the 16,384-row point)
   through their scorers on 4,096 query rows: served scores bitwise
   decision_function's at every bucket of the ladder 128 ... 1,024 (two
   request sizes a bucket) and at row offsets 0, 1 and 333; coalesced
   ServeLoop requests bitwise the same requests served alone;
   nystrom_score launched once a dispatch and no cell built at a seen
   bucket; phi_never_materialized at bucket 1,024 (no (1,024, M) buffer
   among the wrapper's scratch, peak allocation within it);
   nystrom_score timed at each Nystrom model's bucket-1,024 shape beside
   its plain version, torch.mm of the projection and its bound; the exact
   KRN margins within 1e-5 |k| @ |omega| of float64 and of the cross-Gram
   x omega route; a dispatch's time at each bucket (CUDA events and host
   wall). A threaded ServeLoop under 400 requests of 1-512 rows (p50 and
   p99 latency, rows/s, results bitwise served alone) for phases 4's and
   8's models; WeightPager with 8 resident of 12 tenants (hits, misses,
   evictions against an LRU); score_with_std of phase 4's model with the
   posterior from 50,000 training rows against a float64 Sigma oracle
   (within the first-order bound of the float32 statistic's measured
   error), and phase 6's 4-chain ensemble std against np.std(ddof=1) of
   the chains' margins.
17. reliability, run after phase 16: snapshots (``SVMConfig.fault``,
   ``core/resume.py``), kill and resume through ``runtime.faults``, each
   resumed fit bitwise the uninterrupted one (weights, last sample,
   objective, iterations). Phase 4's LIN-EM-CLS and phase 6's LIN-MC-CLS
   ('fused', 'host') at scan_chunk 4, killed after iteration 8, resumed
   from the iteration-8 snapshot, the statistic launched once for each
   iteration run after it; the stream driver on a third of Table 5's
   training rows (65,536-row chunks, fit_chunks, a snapshot every 4
   chunks and every 2 iterations) killed mid-pass by kill_after_chunks
   and resumed inside the pass, then its iteration-2 snapshot resumed
   into the scan driver within the stream band (tests/test_torch_stream.py's
   1e-4 of max|w|, or twice what the uninterrupted stream fit is from the
   resident one); phase 8's KRN-EM-CLS (m = 2,048) killed at iteration 3
   of 5 and resumed on its own featurizer (nystrom_phi, fused_estep and
   syrk_tri twice, rbf_gram never; decision values bitwise); a
   FleetController with in-process hosts on phase 4's fit (a kill, a
   StragglerError) recovering bitwise; a FleetController over
   SubprocessHost processes, started first in a thread: its first child
   hangs and is SIGTERMed by the watchdog, its second fits phase 4's model
   with the port alone (phase 4's bands). Printed, not gated: a
   snapshot's cost (device-to-host copy and blocking commit) at K = 501
   and for the MLT (10, 785) state, and phase 4's fit with a snapshot at
   every host sync against the fit without (host syncs gated equal to
   phase 4's, weights bitwise), each beside nvidia-smi's name and power
   limit.

Phase 11 runs last (it holds its exact KRN fit against phase 14's), kills
fit 1 (2 x 2) after iteration 8 and resumes it on 4 x 1 within fit 1's
bands against one device (rank 0 alone writing snapshots), drops shard 3
from a 4 x 1 fit at an injected 4 s step (report_slow_shard,
on_straggler='drop'; the trace the full fit's through iteration 8), and
also fits phase 12's LIN-EM-MLT on the 2 x 2 mesh (pad_features=2, K =
786, 40,000 training rows, 8 iterations; the window variant 10 times a
step; objective trace within 2e-2 and accuracy within 0.01 of the
one-device fit, the weights band of 5e-2 printed as in phase 12) and the
exact KRN-EM-CLS
on a 4 x 1 mesh at N = 1,800 (padded to 1,824 rows; fused_estep and
syrk_tri once a step on each rank, rbf_gram once a fit; decision values
within 5e-2 of phase 14's and accuracy within 0.01). Phase 3 also holds
the kernels at the shapes phases 12-14 give them: fused_stats (em_hinge,
mc_hinge with noise operands and with the seed) at 160,000 x 785 in the
well regime; nystrom_score with C = 10 at 40,000 x 784, m = 400;
fused_estep and syrk_tri on Table 7's Gram rows (1,795 rings padded to
1,800, the pad mask in syrk_tri's weights: the padded rows and columns of
Sigma exactly 0); rbf_gram at (1,800 x 2)^2.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.

"""
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_FP32 = 67e12       # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
REL = 1e-5              # tolerance of tests/test_torch_kernels_ref.py
EPS = 1e-6              # the gamma clamp of SVMConfig

torch = None            # imported in main(), after the device check
# Models the fitting phases keep for phase 16 (serving): name -> (model,
# query rows, training rows, training targets).
SERVE_MODELS: dict = {}


def check(ok: bool, msg: str) -> None:
    if not ok:
        print(f"FAIL: {msg}", flush=True)
        raise SystemExit(1)


def say(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------ measurement
SLEEP_CYCLES = 4_000_000  # ~2 ms at the H100's clock


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() over ``reps`` calls, by CUDA events. A
    device sleep ahead of the start event keeps the card busy while the
    host prepares the call (a wrapper's checks, allocations and launch),
    so that host time is not counted as the kernel's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    t_op, t_mem = flop / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


# ---------------------------------------------------------------- inputs
def problem(n: int, k: int, dtype, regime: str, dev, seed: int = 0):
    """(X, rho, beta, w, wmask) on ``dev``. well: rho = m64 +- U[0.05, 2]
    (gamma >= ~0.05); hinge: rho = beta = y at a random w (gamma reaches
    the clamp on rows at the knee)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn(n, k, generator=g, device=dev).to(dtype)
    w = torch.randn(k, generator=g, device=dev) / math.sqrt(k)
    y = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, -1.0, 1.0)
    if regime == "well":
        m64 = X.double() @ w.double()
        off = 0.05 + 1.95 * torch.rand(n, generator=g, device=dev,
                                       dtype=torch.float64)
        rho = (m64 + off * y.double()).float()
        beta = torch.randn(n, generator=g, device=dev)
    else:
        rho = beta = y
    wm = (torch.rand(n, generator=g, device=dev) > 0.2).float()
    return X, rho.contiguous(), beta.contiguous(), w, wm


def stats64(X, rho, beta, wm, gamma):
    """b and Sigma in float64 from a given gamma (wm None = ones)."""
    X64, g = X.double(), gamma.double()
    wt = 1.0 / g if wm is None else wm.double() / g
    coef = rho.double() / g + beta.double()
    return X64.T @ coef, (X64 * wt[:, None]).T @ X64


def rows_close(name, got, want):
    err = (got.double() - want).abs()
    check(bool(torch.all(err <= REL * (1 + want.abs()))),
          f"{name}: max |d| {err.max().item():.3e} exceeds 1e-5 (1 + |v|)")
    return err.max().item()


def max_close(name, got, want):
    err = (got.double() - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= REL * scale,
          f"{name}: max |d| {err:.3e} exceeds 1e-5 max|ref| = "
          f"{REL * scale:.3e}")
    return err


def gamma_close(name, g, m, g_ref, m_ref):
    """|dgamma| <= |dm| + half an ulp each side + 1e-7 (max, |.| are
    1-Lipschitz)."""
    lim = ((m.double() - m_ref).abs() + 2.0 ** -24 * (g.double() + g_ref)
           + 1e-7)
    check(bool(torch.all((g.double() - g_ref).abs() <= lim)),
          f"{name}: gamma differs by more than the margin difference")


def gamma_band(name, g, g_plain):
    """mc_hinge gamma against the plain epilogue on the same margin and
    noise: >= 99 % bitwise, >= 99.95 % within 1e-3, finite and >= eps."""
    g, gp = g.reshape(-1), g_plain.reshape(-1)
    check(bool(torch.all(torch.isfinite(g))) and bool(torch.all(g >= EPS)),
          f"{name}: gamma not finite or below eps")
    same = (g == gp).double().mean().item()
    rel = ((g.double() - gp.double()).abs() / gp.double().abs())
    near = (rel <= 1e-3).double().mean().item()
    check(same >= 0.99 and near >= 0.9995,
          f"{name}: gamma {same:.5f} bitwise equal, {near:.5f} within 1e-3")
    return same


def _rel(a, b):
    """Relative distance |a - b| / |b| of two weight vectors."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def twice(fn):
    a, b = fn(), fn()
    torch.cuda.synchronize()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          "two launches on the same inputs differ")
    return a


# ---------------------------------------------------------------- phases
def phase_device():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("card (nvidia-smi name, power.limit):")
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    say(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return card


def _kernel_key(mangled):
    """A readable key for an engine or row-pass kernel's mangled name
    (gram_tiles<copy path, tri|dense>, stat_tiles<copy path, tri|window>,
    stat_rows<X's type, epilogue index>, phi_tiles<write|score>,
    cross_tiles|cross_direct<kind, layout>, cross_operand<X's type>,
    estep_rows<X's type, loads>), or None."""
    m = re.search(r"(gram_tiles|stat_tiles)I.*?(CopyF32ILi(\d)ELi\dE|"
                  r"CopyBf16ILi\dE)E*Lb(\d)", mangled)
    if m:
        path = ("bf16" if m.group(2).startswith("CopyBf16")
                else "f32x16" if m.group(3) == "4" else "f32x4")
        grid = {("gram_tiles", "1"): "tri", ("gram_tiles", "0"): "dense",
                ("stat_tiles", "0"): "tri",
                ("stat_tiles", "1"): "window"}[m.group(1), m.group(4)]
        return f"{m.group(1)}<{path},{grid}>"
    m = re.search(r"stat_rowsI(f|13__nv_bfloat16)Li(\d)E", mangled)
    if m:
        return f"stat_rows<{'float' if m.group(1) == 'f' else 'bf16'}," \
               f"{m.group(2)}>"
    m = re.search(r"phi_tilesILi(\d)E", mangled)
    if m:
        return f"phi_tiles<{('write', 'score')[int(m.group(1))]}>"
    m = re.search(r"cross_(tiles|direct)ILi(\d)ELb(\d)E", mangled)
    if m:
        return (f"cross_{m.group(1)}<{('rbf', 'linear')[int(m.group(2))]},"
                f"{('row-major', 'landmark-major')[int(m.group(3))]}>")
    m = re.search(r"cross_operandI(f|13__nv_bfloat16)E", mangled)
    if m:
        return f"cross_operand<{'float' if m.group(1) == 'f' else 'bf16'}>"
    m = re.search(r"estep_rowsI(f|13__nv_bfloat16)Lb(\d)E", mangled)
    if m:
        return (f"estep_rows<{'float' if m.group(1) == 'f' else 'bf16'},"
                f"{('element', '16-byte')[int(m.group(2))]}>")
    return None


def build_report(log):
    """kernel key -> (registers, stack frame, spill stores, spill loads,
    static shared memory bytes) from nvcc's -Xptxas -v output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = _kernel_key(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur] = [0, *map(int, m.groups()), 0]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur in out:
            out[cur][0] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[cur][4] = int(sm.group(1)) if sm else 0
            out[cur] = tuple(out[cur])
            cur = None
    return out


def phase_build():
    import ctypes
    from repro_torch.kernels import _build
    path, log, secs = _build.build()
    lib = _build.library()
    say(f"build: {path.relative_to(ROOT)} in {secs:.1f} s "
        f"(sources: {', '.join(p.name for p in sorted(_build.CSRC.glob('*.cu')))})")
    for line in log.splitlines():
        if line.startswith("==") or "Used" in line or "spill" in line \
                or "Compiling entry" in line:
            say(f"  {line.strip()}")
    report = build_report(log)
    say("  the Gram engine's tile kernels (csrc/gram_pipe.cuh): registers, "
        "stack, spill stores / loads, dynamic shared memory, CTAs an SM")
    dev = torch.cuda.current_device()
    grids = (("gram_tiles", "tri", lambda c, a, b: lib.rt_syrk_occupancy(
                 dev, c, a, b)),
             ("gram_tiles", "dense",
              lambda c, a, b: lib.rt_weighted_gram_occupancy(dev, c, a, b)),
             ("stat_tiles", "tri",
              lambda c, a, b: lib.rt_fused_stats_occupancy(dev, c, 0, a, b)),
             ("stat_tiles", "window",
              lambda c, a, b: lib.rt_fused_stats_occupancy(dev, c, 1, a, b)))
    for kern, grid, fn in grids:
        for code, name in enumerate(_build.GRAM_PATHS):
            key = f"{kern}<{name},{grid}>"
            smem, ctas = ctypes.c_int(), ctypes.c_int()
            err = fn(code, ctypes.byref(smem), ctypes.byref(ctas))
            check(err == 0 and key in report,
                  f"{key}: occupancy query error {err} or no build report")
            reg, stack, sst, sld, _ = report[key]
            say(f"  {key}: {reg} registers, {stack} B stack, {sst} / {sld} "
                f"B spilled{' (SPILLS)' if sst or sld else ''}, "
                f"{smem.value} B dynamic shared, {ctas.value} CTAs an SM")
            check(reg <= 128 and ctas.value >= 2,
                  f"{key}: {reg} registers, {ctas.value} CTAs an SM; the "
                  "engine is laid out for two CTAs of 256 threads an SM")
    say("  the Nystrom projection on the engine (phi_tiles, csrc/"
        "nystrom_phi.cu, copy policy CopyPair):")
    for code, mode in enumerate(("write", "score")):
        key = f"phi_tiles<{mode}>"
        smem, ctas = ctypes.c_int(), ctypes.c_int()
        err = lib.rt_nystrom_phi_occupancy(dev, code, ctypes.byref(smem),
                                           ctypes.byref(ctas))
        check(err == 0 and key in report,
              f"{key}: occupancy query error {err} or no build report")
        reg, stack, sst, sld, _ = report[key]
        say(f"  {key}: {reg} registers, {stack} B stack, {sst} / {sld} B "
            f"spilled{' (SPILLS)' if sst or sld else ''}, {smem.value} B "
            f"dynamic shared, {ctas.value} CTAs an SM")
        check(reg <= 128 and ctas.value >= 2,
              f"{key}: {reg} registers, {ctas.value} CTAs an SM; the "
              "engine is laid out for two CTAs of 256 threads an SM")
    say("  the cross-Gram (csrc/rbf.cuh; cross_tiles on the engine's "
        "CopyPair, cross_direct for small depths; rbf_gram's row-major, the "
        "Nystrom kernels' landmark-major):")
    cross = sorted(k for k in report if k.startswith(("cross_tiles",
                                                      "cross_direct")))
    want = {f"cross_{r}<{k},{lay}>" for r in ("tiles", "direct")
            for k, lay in (("rbf", "row-major"), ("rbf", "landmark-major"),
                           ("linear", "landmark-major"))}
    check(set(cross) == want, f"the cross-Gram's instantiations are "
          f"{cross}, not {sorted(want)}")
    for key in cross:
        route = 1 if key.startswith("cross_direct") else 0
        smem, ctas = ctypes.c_int(), ctypes.c_int()
        if "row-major" in key:
            err = lib.rt_rbf_gram_occupancy(dev, route, ctypes.byref(smem),
                                            ctypes.byref(ctas))
        else:
            err = lib.rt_nystrom_cross_occupancy(
                dev, route, int("linear" in key), ctypes.byref(smem),
                ctypes.byref(ctas))
        check(err == 0, f"{key}: occupancy query error {err}")
        reg, stack, sst, sld, _ = report[key]
        say(f"  {key}: {reg} registers, {stack} B stack, {sst} / {sld} B "
            f"spilled{' (SPILLS)' if sst or sld else ''}, {smem.value} B "
            f"dynamic shared, {ctas.value} CTAs an SM")
        check(reg <= 128 and ctas.value >= 2,
              f"{key}: {reg} registers, {ctas.value} CTAs an SM; its tiles "
              "are laid out for two CTAs of 256 threads an SM")
    ops = sorted(k for k in report if k.startswith("cross_operand"))
    check(ops == ["cross_operand<bf16>", "cross_operand<float>"],
          f"the transposing pass has instantiations {ops}")
    say("  the transposing pass: " + "; ".join(
        f"{k} {report[k][0]} registers, {report[k][4]} B static shared"
        for k in ops))
    from repro_torch.kernels import fused_estep
    say("  the E-step (estep_rows<X, loads>, csrc/fused_estep.cu):")
    est = sorted(k for k in report if k.startswith("estep_rows"))
    check(est == [f"estep_rows<{t},{ld}>" for t in ("bf16", "float")
                  for ld in ("16-byte", "element")],
          f"estep_rows has instantiations {est}")
    for key in est:
        smem, ctas = ctypes.c_int(), ctypes.c_int()
        err = lib.rt_fused_estep_occupancy(
            dev, int("bf16" in key), int("16-byte" in key),
            ctypes.byref(smem), ctypes.byref(ctas))
        check(err == 0, f"{key}: occupancy query error {err}")
        reg, stack, sst, sld, _ = report[key]
        say(f"  {key}: {reg} registers, {stack} B stack, {sst} / {sld} B "
            f"spilled{' (SPILLS)' if sst or sld else ''}, {smem.value} B "
            f"static shared, {ctas.value} CTAs of {32 * fused_estep.WARPS} "
            "threads an SM")
        check(ctas.value >= fused_estep.CTAS_PER_SM,
              f"{key}: {ctas.value} CTAs an SM; its plan (estep_plan) "
              f"launches one wave of {fused_estep.CTAS_PER_SM}")
    rows = sorted(k for k in report if k.startswith("stat_rows"))
    check(len(rows) == 12, f"the row pass has {len(rows)} instantiations, "
          "not 12 (6 epilogues x f32, bf16)")
    say("  the row pass (stat_rows<X, epilogue>): " + "; ".join(
        f"{k[10:-1]} {report[k][0]} registers"
        + (f", {report[k][2]} / {report[k][3]} B spilled"
           if report[k][2] or report[k][3] else "") for k in rows))


def check_fused_stats(dev, n, k, dtype, regime, masked):
    from repro_torch.kernels import fused_stats, ref
    X, rho, beta, w, wm = problem(n, k, dtype, regime, dev)
    wm = wm if masked else None
    m, g, b, S = twice(lambda: fused_stats.fused_stats(X, rho, beta, w, wm,
                                                       eps=EPS))
    want = ref.fused_stats(X.double(), rho.double(), beta.double(),
                           w.double(), None if wm is None else wm.double(),
                           EPS)
    name = f"fused_stats {n}x{k} {str(dtype)[6:]} {regime}"
    err = rows_close(name + " margin", m, want[0])
    if regime == "well":
        err = max(err, rows_close(name + " gamma", g, want[1]),
                  max_close(name + " b", b, want[2]),
                  max_close(name + " Sigma", S, want[3]))
    else:
        gamma_close(name, g, m, want[1], want[0])
        b64, S64 = stats64(X, rho, beta, wm, g)
        err = max(err, max_close(name + " b", b, b64),
                  max_close(name + " Sigma", S, S64))
    say(f"  ok {name}: bitwise repeatable, max |d| {err:.3e}")
    return err, (X, rho, beta, w, wm)


def check_estep(dev, n, k, dtype, regime):
    from repro_torch.kernels import fused_estep, ref
    X, rho, beta, w, _ = problem(n, k, dtype, regime, dev)
    m, g, b = twice(lambda: fused_estep.fused_estep(X, rho, beta, w,
                                                    eps=EPS))
    want = ref.fused_estep(X.double(), rho.double(), beta.double(),
                           w.double(), EPS)
    name = f"fused_estep {n}x{k} {str(dtype)[6:]} {regime}"
    err = rows_close(name + " margin", m, want[0])
    if regime == "well":
        err = max(err, rows_close(name + " gamma", g, want[1]),
                  max_close(name + " b", b, want[2]))
    else:
        gamma_close(name, g, m, want[1], want[0])
        err = max(err, max_close(name + " b", b,
                                 stats64(X, rho, beta, None, g)[0]))
    say(f"  ok {name}: bitwise repeatable, max |d| {err:.3e}")
    return err, (X, rho, beta, w)


def check_syrk(dev, n, k, dtype, regime):
    from repro_torch.kernels import ref, syrk
    X, rho, _, w, _ = problem(n, k, dtype, regime, dev)
    wt = 1.0 / (rho - X.float() @ w).abs().clamp_min(EPS)
    (S,) = twice(lambda: syrk.syrk_tri(X, wt))
    name = f"syrk_tri {n}x{k} {str(dtype)[6:]} {regime} weights"
    err = max_close(name, S, ref.syrk_tri(X.double(), wt.double()))
    say(f"  ok {name}: bitwise repeatable, max |d| {err:.3e}")
    return err, (X, wt)


MC_VARIANTS = {  # chip_smoke name: (LAUNCHES key, noise source, chains)
    "fused_stats[mc_hinge,noise]": ("mc_hinge,noise", "noise", 1),
    "fused_stats[mc_hinge,seed]": ("mc_hinge,seed", "seed", 1),
    "fused_stats[mc_hinge,seed,C=4]": ("mc_hinge,seed,multichain", "seed",
                                       4),
}


def mc_inputs(dev, n, k, source, chains, w, epilogue="mc_hinge"):
    """noise= or seed= for the call, the noise the kernel sees (the plain
    stream on the card), and the (K,) or (K, C) weights."""
    from repro_torch.core import prng
    from repro_torch.kernels import ref, rng
    seed = rng.pack_seed(prng.fold_in(prng.PRNGKey(7), 3), 11, 1).to(dev)
    noise = ref.seed_noise(seed, n, chains, epilogue)
    kw = dict(noise=noise) if source == "noise" else dict(seed=seed)
    if chains > 1:
        w = torch.stack([w * (1.0 + 0.25 * c) for c in range(chains)], 1)
    return kw, noise, w.contiguous()


def check_mc(dev, n, k, dtype, regime, masked, name):
    from repro_torch.kernels import epilogues, fused_stats, ref
    _, source, chains = MC_VARIANTS[name]
    X, rho, beta, w, wm = problem(n, k, dtype, regime, dev)
    wm = wm if masked else None
    kw, noise, w = mc_inputs(dev, n, k, source, chains, w)
    m, g, b, S = twice(lambda: fused_stats.fused_stats(
        X, rho, beta, w, wm, epilogue="mc_hinge", eps=EPS, **kw))
    label = f"{name} {n}x{k} {str(dtype)[6:]} {regime}"
    m64 = X.double() @ w.double()
    err = rows_close(label + " margin", m, m64)
    r, bt = (rho, beta) if chains == 1 else (rho[:, None], beta[:, None])
    (g_plain,), _, _ = epilogues.apply_epilogue("mc_hinge", m, r, bt, noise,
                                                EPS)
    same = gamma_band(label, g, g_plain)
    for c in range(chains):
        gc = g if chains == 1 else g[:, c]
        bc = b if chains == 1 else b[:, c]
        Sc = S if chains == 1 else S[c]
        b64, S64 = stats64(X, rho, beta, wm, gc)
        err = max(err, max_close(label + " b", bc, b64),
                  max_close(label + " Sigma", Sc, S64))
    say(f"  ok {label}: bitwise repeatable, gamma {same:.5f} bitwise equal "
        f"to the plain epilogue, max |d| {err:.3e}")
    return err, (X, rho, beta, w, kw)


def gram_flop(n, k, tri):
    """The flop the Gram engine's FMAs execute on (n, k): 2 n 128 for each
    of the 16 A rows of each busy warp of each tile (a warp whose A rows
    all lie past k skips its FMAs); tri: lower-triangle tiles only."""
    nb = -(-k // 128)
    flop = 0
    for i in range(nb):
        cols = k - 128 * i
        busy = sum(8 * v < cols or 64 + 8 * v < cols for v in range(8))
        flop += busy * 16 * 128 * 2 * n * (i + 1 if tri else nb)
    return flop


def ab(label, a, b):
    """Time the calls a = (name, fn) and b in the order a, b, b, a, each
    a median of 10; print both means and their ratio a / b."""
    t = {a[0]: [], b[0]: []}
    for name, fn in (a, b, b, a):
        t[name].append(time_ms(fn))
    ma, mb = statistics.mean(t[a[0]]), statistics.mean(t[b[0]])
    say(f"  {label}: {a[0]} {ma:.3f} ms {[round(x, 3) for x in t[a[0]]]}, "
        f"{b[0]} {mb:.3f} ms {[round(x, 3) for x in t[b[0]]]}; "
        f"{a[0]} / {b[0]} {ma / mb:.4f}")


def patched(fn, obj, name, value):
    """fn with obj.name set to value while it runs."""
    def call():
        old = getattr(obj, name)
        setattr(obj, name, value)
        try:
            return fn()
        finally:
            setattr(obj, name, old)
    return call


def gram_design(name, X, wt, others):
    """The Gram engine's design choices timed on the same inputs, launched
    past the wrapper (uncounted; nothing is asserted): on the wrapper's
    split plan, 4-byte against 16-byte copies in the order 4, 16, 16, 4
    (each a median of 10); then the wrapper's plan beside splits of each
    length in ``others`` (rows)."""
    from repro_torch.kernels import _build
    n, k = X.shape
    tri = name == "rt_syrk_tri"
    nb = -(-k // _build.BK)
    ntiles = nb * (nb + 1) // 2 if tri else nb * nb
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    plan = (_build.tile_plan(n, k, X.device)[2] if tri
            else _build.gram_plan(n, ntiles, sms)[1])
    out = torch.empty((k, k), device=X.device)

    def launcher(path, rows):
        nsplits = -(-n // rows)
        part = torch.empty(nsplits * ntiles * _build.BK ** 2, device=X.device)
        tail = (ntiles, nsplits, rows) if tri else (nsplits, rows)
        return lambda: _build.launch(name, X.device, X.data_ptr(), path,
                                     wt.data_ptr(), part.data_ptr(),
                                     out.data_ptr(), n, k, *tail)

    f32x4, f32x16 = (_build.GRAM_PATHS.index(p) for p in ("f32x4", "f32x16"))
    if _build.gram_copy(X) == f32x16:
        ab(f"copy A/B {name} {[n, k]}", ("4-byte", launcher(f32x4, plan)),
           ("16-byte", launcher(f32x16, plan)))
    for rows in [plan, *others]:
        nsplits = -(-n // rows)
        ms = time_ms(launcher(_build.gram_copy(X), rows))
        say(f"  split plan {name} {[n, k]}: {nsplits} splits of {rows} rows "
            f"({nsplits * ntiles / (2 * sms):.2f} waves of two CTAs an SM)"
            f"{' (the plan of the wrapper)' if rows == plan else ''}: "
            f"{ms:.3f} ms")


def time_gram(name, fn, X, wt, err):
    """Time a Gram kernel (syrk_tri, weighted_gram) beside its plain
    version and torch.einsum; print its rates; returns its kernels row."""
    from repro_torch.kernels import ref
    n, k = X.shape
    ms = time_ms(lambda: fn(X, wt))
    plain = time_ms(lambda: ref.weighted_gram(X, wt))
    lib = time_ms(lambda: torch.einsum("nk,n,nj->kj", X, wt, X))
    need = n * k * (k + 1)
    b_ms, by = bound(need, 4 * (n * k + n + k * k))
    run = gram_flop(n, k, name == "syrk_tri")
    say(f"  rate {name} {[n, k]}: {run / ms / 1e9:.1f} TFLOP/s of the "
        f"{run:.4e} flop its tiles execute, {need / ms / 1e9:.1f} TFLOP/s "
        f"of the {need:.4e} the function needs; the bound {b_ms:.3f} ms "
        f"is {PEAK_FP32 / 1e12:.0f} TFLOP/s"
        + ("" if name == "syrk_tri" else
           f"; the dense grid alone needs "
           f"{2 * n * k * k / PEAK_FP32 * 1e3:.3f} ms, "
           f"{run / PEAK_FP32 * 1e3:.3f} on its 128-padded tiles"))
    return dict(shape=[n, k], max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=by, library_ms=lib)


def phase_kernels(dev, main_nk=(250_000, 501), wide_nk=(131_072, 2048),
                  small_nk=(1037, 29), wide8_nk=(250_000, 2049)):
    from repro_torch.kernels import fused_estep, fused_stats, ref, syrk
    f32, bf16 = torch.float32, torch.bfloat16
    out = {}
    n, k = small_nk
    for regime in ("well", "hinge"):
        check_fused_stats(dev, n, k, f32, regime, True)
        check_fused_stats(dev, n, k, bf16, regime, True)
        check_fused_stats(dev, n, k, bf16, regime, False)
        check_estep(dev, n, k, bf16, regime)
        check_syrk(dev, n, k, bf16, regime)

    n, k = main_nk  # as the fit calls it: no Sigma weight mask
    check_fused_stats(dev, n, k, f32, "hinge", False)
    err, (X, rho, beta, w, _) = check_fused_stats(dev, n, k, f32, "well",
                                                  False)
    ms = time_ms(lambda: fused_stats.fused_stats(X, rho, beta, w, eps=EPS))
    plain = time_ms(lambda: ref.fused_stats(X, rho, beta, w, None, EPS))
    b_ms, by = bound(n * k * (k + 1) + 4 * n * k,
                     4 * (n * k + 2 * n + k + 2 * n + k + k * k))
    out["fused_stats"] = dict(shape=[n, k], max_abs_err=err, ms=ms,
                              plain_ms=plain, bound_ms=b_ms, bound_by=by,
                              library_ms=None)
    del X, rho, beta, w

    for name in MC_VARIANTS:
        n, k = small_nk
        for regime in ("well", "hinge"):
            check_mc(dev, n, k, f32, regime, True, name)
            check_mc(dev, n, k, bf16, regime, True, name)
            check_mc(dev, n, k, bf16, regime, False, name)
        if name == "fused_stats[mc_hinge,seed]":  # each rank of the 4 x 1
            check_mc(dev, rank_rows(250_000, 4), 501, f32, "hinge", False,
                     name)
        n, k = main_nk
        err, (X, rho, beta, w, kw) = check_mc(dev, n, k, f32, "hinge",
                                              False, name)
        C = 1 if w.dim() == 1 else w.shape[1]
        ms = time_ms(lambda: fused_stats.fused_stats(
            X, rho, beta, w, epilogue="mc_hinge", eps=EPS, **kw))
        plain = time_ms(lambda: ref.fused_stats(
            X, rho, beta, w, None, EPS, "mc_hinge", **kw))
        n_noise = 2 * n if "noise" in kw else 0
        b_ms, by = bound(C * n * k * (k + 1) + 4 * C * n * k,
                         4 * (n * k + 2 * n + C * k + n_noise + 2 * n * C
                              + C * k + C * k * k))
        out[name] = dict(shape=[n, k, C], max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=by,
                         library_ms=None)
        del X, rho, beta, w, kw

    # fused_estep at phase 5's shape and phase 8's (K = 2,049: rows off
    # the 16-byte grid), each beside the plain version and, for
    # reference, the torch.mv pair X @ w, X^T coef (no one call computes
    # the E-step)
    rows = []
    for n, k in (wide_nk, wide8_nk):
        check_estep(dev, n, k, f32, "hinge")
        err, (X, rho, beta, w) = check_estep(dev, n, k, f32, "well")
        ms = time_ms(lambda: fused_estep.fused_estep(X, rho, beta, w,
                                                     eps=EPS))
        plain = time_ms(lambda: ref.fused_estep(X, rho, beta, w, EPS))
        mv = time_ms(lambda: (torch.mv(X, w), torch.mv(X.T, rho)))
        b_ms, by = bound(4 * n * k, 4 * (n * k + 2 * n + k + 2 * n + k))
        rows.append(dict(shape=[n, k], max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=by,
                         library_ms=None, mv_pair_ms=mv,
                         share_of_bound=b_ms / ms))
        say(f"  time fused_estep {[n, k]}: kernel {ms:.3f} ms "
            f"({b_ms / ms:.3f} of the bytes bound {b_ms:.3f} ms, "
            f"{4 * n * k / ms / 1e9:.2f} TB/s of X), plain {plain:.3f} ms, "
            f"torch.mv pair (X w, X^T coef; reference only) {mv:.3f} ms")
        del X, rho, beta, w
    out["fused_estep"] = dict(rows[0], phase8=rows[1])
    n, k = wide_nk

    check_syrk(dev, n, k, f32, "hinge")
    err, (X, wt) = check_syrk(dev, n, k, f32, "well")
    out["syrk_tri"] = time_gram("syrk_tri", syrk.syrk_tri, X, wt, err)
    # At K = 2,048 one split of 4,096 rows is 32 MB of the 50 MB L2:
    # shorter splits would win if X were read from DRAM more than once.
    gram_design("rt_syrk_tri", X, wt, [2048, 1024])
    del X, wt
    # phase 8's width: the 4-byte copy path and a one-column edge block
    n, k = wide8_nk
    err, (X, wt) = check_syrk(dev, n, k, f32, "well")
    row = time_gram("syrk_tri", syrk.syrk_tri, X, wt, err)
    del X, wt
    say(f"  time syrk_tri {row['shape']} (phase 8's width): kernel "
        f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, library "
        f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
        f"({row['bound_by']})")
    for name, row in out.items():
        if name.startswith("projection["):
            continue
        say(f"  time {name} {row['shape']}: kernel {row['ms']:.3f} ms, "
            f"plain {row['plain_ms']:.3f} ms, library "
            f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 3)} ms, "
            f"bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
    return out


# ---------------------------------------------------------------- SVR
EPS_INS = 0.3           # the SVR tube of benchmarks/table6_svr.py
N_YEAR, N_YEAR_TRAIN = 515_345, 463_715  # YearPredictionMSD and its split
SVR_VARIANTS = {  # chip_smoke name: (LAUNCHES key, noise source, chains)
    "fused_stats[em_svr]": ("em_svr", None, 1),
    "fused_stats[mc_svr,noise]": ("mc_svr,noise", "noise", 1),
    "fused_stats[mc_svr,seed]": ("mc_svr,seed", "seed", 1),
    "fused_stats[mc_svr,seed,C=4]": ("mc_svr,seed,multichain", "seed", 4),
}


@functools.lru_cache(maxsize=None)
def year_data():
    """make_year_like at YearPredictionMSD's size, made once: 90 features,
    targets normalized (the paper's Sec 5.10)."""
    from repro_torch.data import make_year_like
    return make_year_like(N_YEAR, 90)


def svr_targets(m64, regime, g):
    """well: y = m64 +- U[0.35, 2.3], so every |res -+ eps_ins| >= 0.05;
    knee: y = m64 + 0.5 N(0, 1), rows at both knees."""
    n = m64.shape[0]
    if regime == "well":
        off = 0.35 + 1.95 * torch.rand(n, generator=g, device=m64.device,
                                       dtype=torch.float64)
        off = off * torch.where(torch.rand(n, generator=g, device=m64.device)
                                < 0.5, -1.0, 1.0).double()
    else:
        off = 0.5 * torch.randn(n, generator=g, device=m64.device,
                                dtype=torch.float64)
    return (m64 + off).float()


def svr_stats64(X, y, wm, g, o):
    """b and Sigma in float64 from given gamma and omega (wm None = 1)."""
    X64, y64, g64, o64 = X.double(), y.double(), g.double(), o.double()
    wt = 1.0 / g64 + 1.0 / o64
    wt = wt if wm is None else wm.double() * wt
    coef = (y64 - EPS_INS) / g64 + (y64 + EPS_INS) / o64
    return X64.T @ coef, (X64 * wt[:, None]).T @ X64


def check_svr(dev, X, y, w, wm, regime, name, label):
    """One SVR variant of fused_stats against float64: margins; em_svr's
    gamma and omega bitwise equal to the plain epilogue on the kernel's
    own margin (and in the well regime within 1e-5 (1 + |v|) of the
    float64 plain version); mc_svr's each within the gamma band of the
    plain epilogue on the kernel's own margin and noise; b and Sigma from
    the kernel's own gamma and omega."""
    from repro_torch.kernels import epilogues, fused_stats
    key, source, chains = SVR_VARIANTS[name]
    epi = key.split(",")[0]
    n = X.shape[0]
    kw, noise, w = mc_inputs(dev, n, X.shape[1], source, chains, w, "mc_svr")
    kw = kw if source else {}
    noise = noise if source else None
    zero = torch.zeros_like(y)
    m, g, o, b, S = twice(lambda: fused_stats.fused_stats(
        X, y, zero, w, wm, epilogue=epi, eps=EPS, eps_ins=EPS_INS, **kw))
    m64 = X.double() @ w.double()
    err = rows_close(label + " margin", m, m64)
    yc = y if chains == 1 else y[:, None]
    (gp, op), _, _ = epilogues.apply_epilogue(epi, m, yc, torch.zeros_like(yc),
                                              noise, EPS, EPS_INS)
    if epi == "em_svr":
        check(torch.equal(g, gp) and torch.equal(o, op),
              f"{label}: gamma or omega differs from the plain epilogue")
        same = 1.0
        if regime == "well":
            r64 = y.double() - m64
            err = max(err, rows_close(label + " gamma", g,
                                      (r64 - EPS_INS).abs().clamp_min(EPS)),
                      rows_close(label + " omega", o,
                                 (r64 + EPS_INS).abs().clamp_min(EPS)))
    else:
        same = min(gamma_band(label + " gamma", g, gp),
                   gamma_band(label + " omega", o, op))
    for c in range(chains):
        gc, oc = (g, o) if chains == 1 else (g[:, c], o[:, c])
        b64, S64 = svr_stats64(X, y, wm, gc, oc)
        err = max(err, max_close(label + " b", b if chains == 1 else b[:, c],
                                 b64),
                  max_close(label + " Sigma", S if chains == 1 else S[c],
                            S64))
    say(f"  ok {label}: bitwise repeatable, gamma/omega {same:.5f} bitwise "
        f"equal to the plain epilogue, max |d| {err:.3e}")
    return err, (X, y, zero, w, wm, kw, epi)


def check_gram(dev, n, k, dtype, label):
    from repro_torch.kernels import ref, weighted_gram
    X, rho, _, w, _ = problem(n, k, dtype, "well", dev)
    wt = 1.0 / (rho - X.float() @ w).abs().clamp_min(EPS)
    (S,) = twice(lambda: weighted_gram.weighted_gram(X, wt))
    want = ref.weighted_gram(X.double(), wt.double())
    err = max(max_close(label, S, want), max_close(label + " (j, i)", S.T,
                                                   want))
    say(f"  ok {label}: bitwise repeatable, max |d| {err:.3e}")
    return err, (X, wt)


def phase_svr_kernels(dev, small_nk=(1037, 29), table9=(250_000, 500),
                      wide_nk=(4096, 2048)):
    """Phase 3 for the four SVR variants of fused_stats, weighted_gram
    and the K > 1536 split route; returns their rows."""
    from repro_torch.kernels import fused_stats, ops, ref, syrk
    from repro_torch.kernels import weighted_gram
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(4)
    X_year, y_year = year_data()
    Xy = torch.from_numpy(np.concatenate(
        [X_year[:N_YEAR_TRAIN], np.ones((N_YEAR_TRAIN, 1), np.float32)],
        1)).to(dev)
    yy = torch.from_numpy(y_year[:N_YEAR_TRAIN]).to(dev)
    out = {}
    for name in SVR_VARIANTS:
        n, k = small_nk
        for regime in ("well", "knee"):
            for dtype, masked in ((f32, True), (bf16, True), (bf16, False)):
                X, _, _, w, wm = problem(n, k, dtype, "well", dev, seed=5)
                y = svr_targets(X.double() @ w.double(), regime, g)
                check_svr(dev, X, y, w, wm if masked else None, regime, name,
                          f"{name} {n}x{k} {str(dtype)[6:]} {regime}"
                          f"{' masked' if masked else ''}")
        # the year shape as the fit calls it (no Sigma weight mask)
        n, k = Xy.shape
        w = torch.randn(k, generator=g, device=dev) / math.sqrt(k)
        check_svr(dev, Xy, svr_targets(Xy.double() @ w.double(), "well", g),
                  w, None, "well", name, f"{name} {n}x{k} well")
        err, (X, y, zero, wv, _, kw, epi) = check_svr(
            dev, Xy, yy, w, None, "knee", name, f"{name} {n}x{k} year y")
        C = 1 if wv.dim() == 1 else wv.shape[1]
        ms = time_ms(lambda: fused_stats.fused_stats(
            X, y, zero, wv, epilogue=epi, eps=EPS, eps_ins=EPS_INS, **kw))
        plain = time_ms(lambda: ref.fused_stats(
            X, y, zero, wv, None, EPS, epi, eps_ins=EPS_INS, **kw))
        n_noise = 4 * n if "noise" in kw else 0
        b_ms, by = bound(C * n * k * (k + 1) + 4 * C * n * k,
                         4 * (n * k + 2 * n + C * k + n_noise + 3 * n * C
                              + C * k + C * k * k))
        out[name] = dict(shape=[n, k, C], max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=by,
                         library_ms=None)
    del Xy

    n, k = small_nk
    for dtype in (f32, bf16):
        check_gram(dev, n, k, dtype, f"weighted_gram {n}x{k} "
                   f"{str(dtype)[6:]}")
    check_gram(dev, 4099, 300, bf16, "weighted_gram 4099x300 bfloat16")
    n, k = table9
    err, (X, wt) = check_gram(dev, n, k, f32, f"weighted_gram {n}x{k} "
                              "(Table 9)")
    out["weighted_gram"] = time_gram("weighted_gram",
                                     weighted_gram.weighted_gram, X, wt, err)
    tri = time_ms(lambda: syrk.syrk_tri(X, wt))
    say(f"  time syrk_tri {[n, k]} (the triangle beside the dense grid): "
        f"{tri:.3f} ms")
    gram_design("rt_weighted_gram", X, wt, [4096, 3808, 2048])
    # The Table 9 statistic as a user calls it: ops.weighted_gram, counted.
    _zero_counts()
    S = ops.weighted_gram(X, wt)
    torch.cuda.synchronize()
    gram_counts = _counts()
    check(gram_counts["weighted_gram"] == 1 and gram_counts["syrk_tri"] == 0,
          f"ops.weighted_gram did not launch the dense kernel: "
          f"{gram_counts}")
    check(bool(torch.all(torch.isfinite(S))), "weighted_gram not finite")
    del X, wt, S

    # em_svr past FUSED_STATS_MAX_K: a plain E-step, then syrk_tri.
    n, k = wide_nk
    X, _, _, w, _ = problem(n, k, f32, "well", dev, seed=6)
    y = svr_targets(X.double() @ w.double(), "well", g)
    zero = torch.zeros_like(y)
    _zero_counts()
    m, gm, om, b, S = ops.fused_stats(X, y, zero, w, epilogue="em_svr",
                                      eps=EPS, eps_ins=EPS_INS)
    torch.cuda.synchronize()
    c = _counts()
    check(c["syrk_tri"] == 1 and all(v == 0 for key, v in c.items()
                                     if key != "syrk_tri"),
          f"em_svr at K = {k}: want syrk_tri once and nothing else: {c}")
    b64, S64 = svr_stats64(X, y, None, gm, om)
    err = max(max_close("em_svr split route b", b, b64),
              max_close("em_svr split route Sigma", S, S64))
    say(f"  ok em_svr {n}x{k} split route: syrk_tri launched once, max |d| "
        f"{err:.3e}")
    for name, row in out.items():
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.3f} ms")
        say(f"  time {name} {row['shape']}: kernel {row['ms']:.3f} ms, "
            f"plain {row['plain_ms']:.3f} ms, library {lib}, bound "
            f"{row['bound_ms']:.3f} ms ({row['bound_by']})")
    return out, gram_counts


def _counts():
    from repro_torch.kernels import (fused_estep, fused_stats, nystrom_phi,
                                     rbf_gram, syrk, weighted_gram)
    out = {"fused_stats": fused_stats.LAUNCHES["em_hinge"]}
    for name, (key, _, _) in {**MC_VARIANTS, **SVR_VARIANTS,
                              **WIN_VARIANTS}.items():
        out[name] = fused_stats.LAUNCHES[key]
    out["fused_estep"] = fused_estep.LAUNCHES
    out["syrk_tri"] = syrk.LAUNCHES
    out["weighted_gram"] = weighted_gram.LAUNCHES
    out["rbf_gram"] = rbf_gram.LAUNCHES
    out.update(nystrom_phi.LAUNCHES)
    return out


def dispatches(n, bucket=1024):
    """nystrom_score launches of a predict on n rows: the scorer serves
    them in chunks of its largest bucket, one launch a chunk."""
    return -(-n // bucket)


def _zero_counts():
    from repro_torch.kernels import (fused_estep, fused_stats, nystrom_phi,
                                     rbf_gram, syrk, weighted_gram)
    fused_stats.zero_launches()
    nystrom_phi.zero_launches()
    fused_estep.LAUNCHES = syrk.LAUNCHES = rbf_gram.LAUNCHES = 0
    weighted_gram.LAUNCHES = 0


def _fit(cfg, dev, X, y):
    from repro_torch.core import PEMSVM
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svm = PEMSVM(cfg, device=dev)
    res = svm.fit(X, y)
    torch.cuda.synchronize()
    return svm, res, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def alpha_data(n=300_000, k=500):
    """The alpha-like set of phases 3, 4, 6 and 8, made once."""
    from repro_torch.data import make_alpha_like
    return make_alpha_like(n=n, k=k, seed=0)


@functools.lru_cache(maxsize=None)
def circles_data(n, seed=0):
    """make_circles of phases 3 and 7, made once."""
    from repro_torch.data import make_circles
    return make_circles(n, seed=seed)


def phase_main_path(dev, n=300_000, n_train=250_000, k=500):
    from repro_torch.core import SVMConfig, lam_from_C
    from repro_torch.data import make_alpha_like
    X, y = alpha_data(n, k)
    Xtr, ytr, Xte, yte = X[:n_train], y[:n_train], X[n_train:], y[n_train:]
    cfg = SVMConfig.from_options("LIN-EM-CLS", lam=lam_from_C(1.0),
                                 max_iters=100)
    # Warm-up: the first fit in a process pays cuBLAS/cuSOLVER set-up.
    Xw, yw = make_alpha_like(n=4096, k=k, seed=1)
    for backend in (None, "ref"):
        _fit(dataclasses.replace(cfg, max_iters=2, min_iters=2,
                                 backend=backend), dev, Xw, yw)
    _zero_counts()
    svm, res, secs = _fit(cfg, dev, Xtr, ytr)
    counts = _counts()
    mem = torch.cuda.max_memory_allocated()
    acc = svm.score(Xte, yte)
    SERVE_MODELS["LIN-EM-CLS (phase 4)"] = (svm, Xte, Xtr, ytr)
    RELIABILITY["phase4"] = res
    steps = min(cfg.max_iters, -(-res.n_iters // cfg.scan_chunk)
                * cfg.scan_chunk)
    say(f"  kernels fit: {secs:.3f} s, {res.n_iters} iterations "
        f"({steps} steps run, {secs / steps * 1e3:.2f} ms a step), converged "
        f"{res.converged}, {res.n_host_syncs} host syncs, held-out accuracy "
        f"{acc:.4f}, peak device memory {mem / 2**20:.0f} MiB, "
        f"launches {counts}")
    plain, rp, psecs = _fit(dataclasses.replace(cfg, backend="ref"), dev,
                            Xtr, ytr)
    pacc = plain.score(Xte, yte)
    say(f"  plain fit: {psecs:.3f} s, {rp.n_iters} iterations "
        f"({psecs / steps * 1e3:.2f} ms a step), converged "
        f"{rp.converged}, held-out accuracy {pacc:.4f}")
    chunk = cfg.scan_chunk
    L = counts["fused_stats"]
    check(res.converged and rp.converged, "a fit did not converge")
    check(res.n_iters <= L <= -(-res.n_iters // chunk) * chunk,
          f"fused_stats launched {L} times for {res.n_iters} iterations")
    check(all(v == 0 for name, v in counts.items() if name != "fused_stats"),
          f"the EM K <= 1536 path launched another kernel: {counts}")
    check(_counts() == counts, "the plain fit launched a kernel")
    check(res.n_host_syncs <= math.ceil(cfg.max_iters / chunk),
          "scan driver synced more than once per chunk")
    check(abs(res.n_iters - rp.n_iters) <= 3, "iteration counts differ by "
          f"more than 3: {res.n_iters} vs {rp.n_iters}")
    o, op = np.asarray(res.objective), np.asarray(rp.objective)
    j = min(len(o), len(op))
    orel = float(np.max(np.abs(o[:j] - op[:j]) / np.abs(op[:j])))
    w, wp = res.weights.astype(np.float64), rp.weights.astype(np.float64)
    wrel = float(np.linalg.norm(w - wp) / np.linalg.norm(wp))
    say(f"  bands: objective rel {orel:.3e} (<= 2e-2), weights rel "
        f"{wrel:.3e} (<= 5e-2), accuracy diff {abs(acc - pacc):.4f} "
        f"(<= 0.01)")
    check(orel <= 2e-2 and wrel <= 5e-2 and abs(acc - pacc) <= 0.01,
          "kernel fit outside the bands of the plain fit")
    check(bool(np.all(np.isfinite(w))), "non-finite weights")
    return res.n_iters, steps, counts


def phase_wide(dev, n=131_072, k=2047, iters=5):
    from repro_torch.core import SVMConfig, lam_from_C
    from repro_torch.data import make_alpha_like
    X, y = make_alpha_like(n=n, k=k, seed=0)
    cfg = SVMConfig.from_options("LIN-EM-CLS", lam=lam_from_C(1.0),
                                 max_iters=iters, min_iters=iters)
    _zero_counts()
    svm, res, secs = _fit(cfg, dev, X, y)
    counts = _counts()
    say(f"  K={k + 1} fit: {secs:.3f} s for {res.n_iters} iterations, "
        f"objective {res.objective[-1]:.1f}, train accuracy "
        f"{svm.score(X, y):.4f}, launches {counts}")
    check(counts["fused_estep"] > 0 and counts["syrk_tri"] > 0,
          "the K > 1536 path did not launch fused_estep and syrk_tri")
    check(all(v == 0 for name, v in counts.items() if "fused_stats" in name),
          "the K > 1536 path launched fused_stats")
    check(bool(np.all(np.isfinite(res.weights)))
          and bool(np.all(np.isfinite(res.objective))), "non-finite fit")
    profile_fit(f"the K={k + 1} fit", cfg, dev, (X, y), top=6)
    return res.n_iters, res.n_iters, counts


def _metric(model, cfg, X, y):
    """(name, value) of the held-out metric: accuracy (CLS), RMSE (SVR)."""
    if cfg.task == "SVR":
        return "RMSE", model.rmse(X, y)
    return "accuracy", model.score(X, y)


def _report(label, svm, res, secs, cfg, Xte, yte, counts=None):
    """Print one fit's line; returns (held-out accuracy or RMSE, steps
    run)."""
    what, acc = _metric(svm, cfg, Xte, yte)
    steps = min(cfg.max_iters, -(-res.n_iters // cfg.scan_chunk)
                * cfg.scan_chunk)
    say(f"  {label}: {secs:.3f} s, {res.n_iters} iterations ({steps} "
        f"steps run, {secs / steps * 1e3:.2f} ms a step), converged "
        f"{res.converged}, {res.n_host_syncs} host syncs, held-out {what} "
        f"{acc:.4f}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB"
        + ("" if counts is None else f", launches {counts}"))
    check(bool(np.all(np.isfinite(res.weights))), f"{label}: non-finite "
          "weights")
    check(res.n_host_syncs <= math.ceil(cfg.max_iters / cfg.scan_chunk),
          f"{label}: scan driver synced more than once per chunk")
    return acc, steps


def _mc_fit(label, cfg, dev, data, launched=None, keep=None):
    """One MC fit with the launch counts zeroed just before and read just
    after; ``launched`` names the variant that must run once a step;
    ``keep`` names the model for phase 16."""
    Xtr, ytr, Xte, yte = data
    _zero_counts()
    svm, res, secs = _fit(cfg, dev, Xtr, ytr)
    if keep is not None:
        SERVE_MODELS[keep] = (svm, Xte, Xtr, ytr)
    counts = _counts()
    acc, steps = _report(label, svm, res, secs, cfg, Xte, yte, counts)
    if launched is None:
        check(all(v == 0 for v in counts.values()),
              f"{label}: the plain fit launched a kernel: {counts}")
    else:
        check(counts[launched] == steps, f"{label}: {launched} launched "
              f"{counts[launched]} times for {steps} steps run")
        check(all(v == 0 for name, v in counts.items() if name != launched),
              f"{label}: launched other kernels: {counts}")
    return res, acc, steps, counts


def profile_fit(label, cfg, dev, data, top=8):
    """One fit under torch.profiler: the device time by kernel name (top
    ``top``), the device's busy share of the fit's wall time, and the
    set-up (a one-step fit: bias column, padding, copy, one step)."""
    from torch.profiler import ProfilerActivity, profile
    Xtr, ytr = data[:2]
    one = dataclasses.replace(cfg, max_iters=1, min_iters=1)
    _, _, setup = _fit(one, dev, Xtr, ytr)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, res, secs = _fit(cfg, dev, Xtr, ytr)
    steps = min(cfg.max_iters, -(-res.n_iters // cfg.scan_chunk)
                * cfg.scan_chunk)
    say_profile(prof, secs, top, f"profile of {label}: {secs * 1e3:.1f} ms "
                f"wall for {steps} steps (one-step fit, the set-up: "
                f"{setup * 1e3:.1f} ms)")


def say_profile(prof, secs, top, head):
    """The device's busy share of ``secs`` and its time by kernel name,
    summed over the device's own activities (kernels, copies): a host
    operator's self device time is that of the activities it launched,
    which would count them twice."""
    from torch.autograd import DeviceType
    rows = [(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3, e.count,
             e.key) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    say(f"  {head}, device busy {busy:.1f} ms ({busy / (secs * 1e3):.3f} "
        f"of the wall time) in {sum(r[1] for r in rows)} device "
        f"activities; by self device time:")
    for ms, count, name in rows[:top]:
        say(f"    {ms:9.3f} ms {count:6d}x  {name[:90]}")


def phase_mc(dev, n=300_000, n_train=250_000, k=500):
    from repro_torch.core import SVMConfig, lam_from_C
    from repro_torch.data import make_alpha_like
    X, y = alpha_data(n, k)
    data = (X[:n_train], y[:n_train], X[n_train:], y[n_train:])
    cfg = SVMConfig.from_options("LIN-MC-CLS", lam=lam_from_C(1.0),
                                 max_iters=100, rng="fused")
    Xw, yw = make_alpha_like(n=4096, k=k, seed=1)
    for backend in (None, "ref"):  # warm-up: cuBLAS/cuSOLVER set-up
        _fit(dataclasses.replace(cfg, max_iters=2, min_iters=2,
                                 backend=backend), dev, Xw, yw)
    rk, acc_k, st_k, c_k = _mc_fit(
        "kernels fit, rng='fused'", cfg, dev, data,
        "fused_stats[mc_hinge,seed]")
    plain = dataclasses.replace(cfg, backend="ref")
    rp, acc_p, _, _ = _mc_fit("plain fit, rng='fused', seed 0", plain, dev,
                              data)
    rp1, acc_p1, _, _ = _mc_fit("plain fit, rng='fused', seed 1",
                                dataclasses.replace(plain, seed=1), dev,
                                data)
    rh, acc_h, st_h, c_h = _mc_fit(
        "kernels fit, rng='host'", dataclasses.replace(cfg, rng="host"),
        dev, data, "fused_stats[mc_hinge,noise]")
    rc, acc_c, st_c, c_c = _mc_fit(
        "kernels fit, rng='fused', n_chains=4",
        dataclasses.replace(cfg, n_chains=4), dev, data,
        "fused_stats[mc_hinge,seed,C=4]", keep="LIN-MC-CLS 4 chains (phase 6)")

    profile_fit("the rng='fused' kernels fit", cfg, dev, data)
    spread = _rel(rp1.weights, rp.weights)
    wrel = _rel(rk.weights, rp.weights)
    say(f"  bands: kernel vs plain weights rel {wrel:.4e} (<= 3 x the seed "
        f"0 vs 1 spread of the plain path, {spread:.4e}); accuracy "
        f"kernel {acc_k:.4f} plain {acc_p:.4f} host {acc_h:.4f} 4 chains "
        f"{acc_c:.4f} (each within 0.01 of the kernel fit's); chain std "
        f"mean {float(np.mean(rc.chain_std)):.4e}")
    check(rk.converged and rp.converged, "an rng='fused' fit did not "
          "converge")
    check(abs(acc_k - acc_p) <= 0.01, "kernel and plain accuracy differ by "
          "more than 0.01")
    check(wrel <= 3 * spread, "kernel fit outside 3x the seed spread")
    check(abs(acc_h - acc_k) <= 0.01 and abs(acc_c - acc_k) <= 0.01,
          "rng='host' or n_chains=4 accuracy outside 0.01")
    check(rc.chain_weights.shape == (4, k + 1)
          and bool(np.all(np.isfinite(rc.chain_std))),
          "n_chains=4: bad chain_weights or chain_std")
    return ({"fused_stats[mc_hinge,seed]": (c_k, rk.n_iters, st_k),
             "fused_stats[mc_hinge,noise]": (c_h, rh.n_iters, st_h),
             "fused_stats[mc_hinge,seed,C=4]": (c_c, rc.n_iters, st_c)},
            (rk, spread))


# ------------------------------------------------------- Nystrom kernels
NYS_VARIANTS = {  # chip_smoke name: (epilogue, noise source)
    "nystrom_fused_stats[em_hinge]": ("em_hinge", None),
    "nystrom_fused_stats[mc_hinge,noise]": ("mc_hinge", "noise"),
    "nystrom_fused_stats[mc_hinge,seed]": ("mc_hinge", "seed"),
}
ROWS_A_CHECK = 65_536   # float64 checks go in row chunks of this size


def featurizer(dev, X, m, sigma, seed=0):
    """Landmarks as NystromSVM draws them and their projection (through
    the rbf_gram kernel and a float64 eigh), on the card."""
    from repro_torch.core import nystrom_projection
    rng = np.random.default_rng(seed)
    L = X[rng.choice(X.shape[0], size=m, replace=False)]
    P = nystrom_projection(L, sigma=sigma, device=dev).astype(np.float32)
    return torch.from_numpy(L).to(dev), torch.from_numpy(P).to(dev)


def nys_odd(dev, dtype, kind, n=1037, d=7, m=45, n_pad=13, seed=0):
    """Odd masked inputs: padded tail rows (X-row 0, mask 0), masked rows,
    landmarks from the rows, a mixed-sign projection."""
    g = np.random.default_rng(seed)
    X = g.normal(size=(n, d)).astype(np.float32)
    L = X[g.choice(n - n_pad, size=m, replace=False)].copy()
    X[n - n_pad:] = 0.0
    P = (0.2 * g.normal(size=(m, m))).astype(np.float32)
    mask = (g.uniform(size=n) > 0.2).astype(np.float32)
    mask[n - n_pad:] = 0.0
    X = torch.from_numpy(X).to(dtype).to(dev)
    return (X,) + tuple(torch.from_numpy(a).to(dev) for a in (L, P, mask))


def kmat64(X, L, sigma, kind):
    from repro_torch.kernels import ref
    if kind == "rbf":
        return ref.rbf_gram(X.double(), L.double(), sigma)
    return X.double() @ L.double().T


def phi64_and_scale(k64, P, mask, add_bias):
    """phi in float64 and the scale |k| @ |proj| of its rounding error,
    both masked, bias column last."""
    P64 = P.double()
    phi, scale = k64 @ P64, k64.abs() @ P64.abs()
    if add_bias:
        one = torch.ones_like(phi[:, :1])
        phi, scale = torch.cat([phi, one], 1), torch.cat([scale, one], 1)
    mk = (torch.ones_like(phi[:, 0]) if mask is None else mask.double()
          )[:, None]
    return phi * mk, scale * mk


def within(name, got, want, scale):
    err = (got.double() - want).abs()
    check(bool(torch.all(err <= REL * scale)),
          f"{name}: |d| exceeds 1e-5 x its scale by "
          f"{(err - REL * scale).max().item():.3e}")
    return err.max().item()


def check_rbf(dev, X1, X2, sigma, name):
    from repro_torch.kernels import rbf_gram, ref
    (K,) = twice(lambda: rbf_gram.rbf_gram(X1, X2, sigma=sigma))
    want = ref.rbf_gram(X1.double(), X2.double(), sigma)
    err = (K.double() - want).abs()
    check(bool(torch.all(err <= 1e-5 * want.abs() + 1e-7)),
          f"{name}: |d| exceeds 1e-5 |ref| + 1e-7")
    say(f"  ok {name}: bitwise repeatable, max |d| {err.max().item():.3e}")
    return err.max().item()


def check_phi(X, L, P, mask, sigma, kind, add_bias, name):
    """nystrom_phi against float64 in row chunks; returns max |d|."""
    from repro_torch.kernels import nystrom_phi as nys
    (phi,) = twice(lambda: nys.nystrom_phi(X, L, P, mask, sigma=sigma,
                                           kind=kind, add_bias=add_bias))
    err = 0.0
    for c0 in range(0, X.shape[0], ROWS_A_CHECK):
        sl = slice(c0, c0 + ROWS_A_CHECK)
        want, scale = phi64_and_scale(kmat64(X[sl], L, sigma, kind), P,
                                      None if mask is None else mask[sl],
                                      add_bias)
        err = max(err, within(name, phi[sl], want, scale))
    if mask is not None:
        check(not bool(torch.any(phi[mask == 0])),
              f"{name}: a masked row is not zero")
    say(f"  ok {name}: bitwise repeatable, max |d| {err:.3e}")
    return err


def check_score(X, L, P, W, mask, sigma, kind, name):
    from repro_torch.kernels import nystrom_phi as nys
    (s,) = twice(lambda: nys.nystrom_score(X, L, P, W, mask, sigma=sigma,
                                           kind=kind, add_bias=True))
    err = 0.0
    for c0 in range(0, X.shape[0], ROWS_A_CHECK):
        sl = slice(c0, c0 + ROWS_A_CHECK)
        phi, scale = phi64_and_scale(kmat64(X[sl], L, sigma, kind), P,
                                     None if mask is None else mask[sl],
                                     True)
        err = max(err, within(name, s[sl], phi @ W.double(),
                              scale @ W.double().abs()))
    say(f"  ok {name}: bitwise repeatable, max |d| {err:.3e}")
    return err


def nys_stat_inputs(dev, n, M, source, epilogue="mc_hinge"):
    """y (hinge regime: rho = beta = y), w, and the noise= or seed= of
    the call with the noise the kernel sees."""
    from repro_torch.core import prng
    from repro_torch.kernels import ref, rng
    g = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn(M, generator=g, device=dev) / math.sqrt(M)
    y = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, -1.0, 1.0)
    seed = rng.pack_seed(prng.fold_in(prng.PRNGKey(7), 3), 11, 0).to(dev)
    noise = ref.seed_noise(seed, n, 1, epilogue) if source else None
    kw = (dict(noise=noise) if source == "noise" else
          dict(seed=seed) if source == "seed" else {})
    return y, w, kw, noise


def check_nys_stats(dev, X, L, P, mask, sigma, kind, name, label,
                    y_svr=None):
    """nystrom_fused_stats against float64: margins and em_hinge gamma in
    row chunks, b and Sigma from the kernel's own phi and gamma (and
    omega); MC gamma (and omega) against the plain epilogue on the
    kernel's own margin and noise, em_svr's bitwise. SVR variants take
    their targets ``y_svr`` (zero on masked rows)."""
    from repro_torch.kernels import epilogues
    from repro_torch.kernels import nystrom_phi as nys
    epi, source = {**NYS_VARIANTS, **NYS_SVR_VARIANTS}[name]
    svr = epi.endswith("svr")
    n, M = X.shape[0], L.shape[0] + 1
    y, w, kw, noise = nys_stat_inputs(dev, n, M, source,
                                      "mc_svr" if svr else "mc_hinge")
    if svr:
        y = y_svr
    elif mask is not None:
        y = y * mask
    beta = torch.zeros_like(y) if svr else y
    out = twice(lambda: nys.nystrom_fused_stats(
        X, L, P, y, beta, w, mask, sigma=sigma, kind=kind, add_bias=True,
        epilogue=epi, eps=EPS, eps_ins=EPS_INS if svr else 0.0, **kw))
    m, g, b, S = out[0], out[1], out[-2], out[-1]
    o = out[2] if svr else None
    w64 = w.double()
    b64 = torch.zeros(M, dtype=torch.float64, device=dev)
    S64 = torch.zeros((M, M), dtype=torch.float64, device=dev)
    err = 0.0
    for c0 in range(0, n, ROWS_A_CHECK):
        sl = slice(c0, c0 + ROWS_A_CHECK)
        mk = None if mask is None else mask[sl]
        phi, scale = phi64_and_scale(kmat64(X[sl], L, sigma, kind), P, mk,
                                     True)
        m64 = phi @ w64
        err = max(err, within(f"{label} margin", m[sl], m64,
                              scale @ w64.abs()))
        if epi == "em_hinge":
            gamma_close(label, g[sl], m[sl],
                        (y[sl].double() - m64).abs().clamp_min(EPS), m64)
        del phi, scale, m64
        phik = nys.nystrom_phi(X[sl], L, P, mk, sigma=sigma, kind=kind,
                               add_bias=True).double()
        if svr:
            bk, Sk = svr_stats64(phik, y[sl], mk, g[sl], o[sl])
            b64 += bk
            S64 += Sk
        else:
            gk = g[sl].double()
            wt = (1.0 if mk is None else mk.double()) / gk
            b64 += phik.T @ (y[sl].double() / gk + y[sl].double())
            S64 += (phik * wt[:, None]).T @ phik
        del phik
    same = None
    if epi != "em_hinge":
        aug, _, _ = epilogues.apply_epilogue(epi, m, y, beta, noise, EPS,
                                             EPS_INS if svr else 0.0)
        if epi == "em_svr":
            check(torch.equal(g, aug[0]) and torch.equal(o, aug[1]),
                  f"{label}: gamma or omega differs from the plain epilogue")
            same = 1.0
        else:
            same = gamma_band(label + " gamma", g, aug[0])
            if svr:
                same = min(same, gamma_band(label + " omega", o, aug[1]))
    err = max(err, max_close(label + " b", b, b64),
              max_close(label + " Sigma", S, S64))
    say(f"  ok {label}: bitwise repeatable, max |d| {err:.3e}"
        + ("" if same is None else
           f", gamma{'/omega' if svr else ''} {same:.5f} bitwise equal to "
           "the plain epilogue"))
    return err, (y, beta, w, kw)


def time_nys_stats(dev, X, L, P, mask, sigma, name, label, y_svr=None):
    """Check one nystrom_fused_stats variant at a main-path shape, then
    time it beside its plain version; returns its row."""
    from repro_torch.kernels import nystrom_phi as nys
    from repro_torch.kernels import ref
    epi, source = {**NYS_VARIANTS, **NYS_SVR_VARIANTS}[name]
    eps_ins = EPS_INS if epi.endswith("svr") else 0.0
    err, (y, beta, w, kw) = check_nys_stats(dev, X, L, P, mask, sigma,
                                            "rbf", name, label, y_svr)
    ms = time_ms(lambda: nys.nystrom_fused_stats(
        X, L, P, y, beta, w, mask, sigma=sigma, add_bias=True, epilogue=epi,
        eps=EPS, eps_ins=eps_ins, **kw))
    plain = time_ms(lambda: ref.nystrom_fused_stats(
        X, L, P, y, beta, w, mask, sigma, "rbf", True, EPS, epi,
        eps_ins=eps_ins, **kw))
    (n, d), (m, p) = X.shape, P.shape
    M = p + 1
    svr = epi.endswith("svr")
    n_noise = (4 if svr else 2) * n if source == "noise" else 0
    n_out = 3 * n if svr else 2 * n
    b_ms, by = bound(2 * n * m * d + 2 * n * m * M + n * M * (M + 1)
                     + 4 * n * M,
                     4 * (n * d + m * d + m * p + 3 * n + n_noise + n_out
                          + 2 * M + M * M))
    torch.cuda.empty_cache()
    return dict(shape=[n, d, m], max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=by, library_ms=None)


# kernel name (substring, the first that matches) -> stage
PHI_STAGES = (("row_sqnorm", "norms"),
              ("cross_operand", "cross-Gram operands"),
              ("cross_", "cross-Gram"), ("phi_tiles", "projection"),
              ("score_reduce", "score reduce"))


def device_ms(fn, reps=3):
    """{kernel name: device ms a call} of fn() under torch.profiler, over
    ``reps`` calls after one warm-up (the device's own activities)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0)) / 1e3 / reps
            for e in prof.key_averages() if e.device_type != DeviceType.CPU}


def phi_stages(fn):
    """A featurizer call's device ms by stage: the norms, the cross-Gram's
    operands written depth-major, the cross-Gram's product, the
    projection, the score reduce, and what else it runs ("other": the
    statistic's passes, proj's aligned copy)."""
    out = dict.fromkeys([name for _, name in PHI_STAGES] + ["other"], 0.0)
    for key, ms in device_ms(fn).items():
        out[next((n for k, n in PHI_STAGES if k in key), "other")] += ms
    return out


def projection_row(label, X, L, P, sigma, chunk, stages):
    """The projection stage at a main-path shape: its device ms from
    ``stages``; torch.mm of the same row chunks' cross-Gram (R, m) with
    proj, TF32 off, summed over the chunks (the library yardstick, used
    nowhere in the port); the bound 2 N m M flop at the fp32 peak; and the
    share of the peak on the flop the function needs and on the FMAs the
    engine's tiles execute (depth padded to 32, product columns to 128)."""
    from repro_torch.kernels import ref
    (n, _), (m, p) = X.shape, P.shape
    M = p + 1
    kcs = [ref.rbf_gram(X[c0:c0 + chunk], L, sigma)
           for c0 in range(0, n, chunk)]
    lib = sum(device_ms(lambda: [torch.mm(k, P) for k in kcs]).values())
    del kcs
    torch.cuda.empty_cache()
    b_ms, by = bound(2 * n * m * M, 4 * (n * m + m * p + n * M))
    ms, chunks = stages["projection"], -(-n // chunk)
    tile = 2 * n * (-(-m // 32) * 32) * (-(-p // 128) * 128)
    say(f"  projection {label} {[n, m, M]}: kernel {ms:.3f} ms ({chunks} "
        f"launches a call), torch.mm {lib:.3f} ms (kernel / mm "
        f"{ms / lib:.3f}), bound {b_ms:.3f} ms ({by}); of fp32 peak "
        f"{b_ms / ms:.3f} on the flop needed, {tile / PEAK_FP32 * 1e3 / ms:.3f}"
        f" on the tiles' FMAs")
    return dict(shape=[n, m, M], ms=ms, library_ms=lib, bound_ms=b_ms,
                bound_by=by, launches_a_call=chunks)


def with_depth(plan, *args, D):
    """plan(*args, D=D): a Nystrom chunk plan counting the rows' depth-
    major scratch; plan(*args) for a package whose plans have no depth
    (an older tree's, as scripts/chip_compare.py runs them)."""
    import inspect
    if "D" in inspect.signature(plan).parameters:
        return plan(*args, D=D)
    return plan(*args)


def cross_row(label, X, L, sigma, chunk, stages):
    """The cross-Gram stage at a main-path shape: its device ms from
    ``stages`` (the operands' transposing pass and the product); torch.mm
    of the same row chunks (R, D) with the landmarks' transpose, TF32 off,
    summed over the chunks (the product alone, without the transform: the
    library yardstick, used nowhere in the port); the bound max(2 N m D
    flop at the fp32 peak, the bytes of X, L and the (m, N) output)."""
    from repro_torch.kernels import rbf_gram
    (n, d), m = X.shape, L.shape[0]
    Lt = L.T.contiguous()
    lib = sum(device_ms(lambda: [torch.mm(X[c0:c0 + chunk], Lt)
                                 for c0 in range(0, n, chunk)]).values())
    b_ms, by = bound(2 * n * m * d, 4 * (n * d + m * d + n * m))
    ms = stages["cross-Gram operands"] + stages["cross-Gram"]
    chunks = -(-n // chunk)
    route = (rbf_gram.CROSS_ROUTES[rbf_gram.cross_route(d)]
             if hasattr(rbf_gram, "cross_route") else "staged")
    say(f"  cross-Gram {label} {[n, d, m]}: kernel {ms:.3f} ms a call "
        f"({stages['cross-Gram operands']:.3f} of it the operands' "
        f"transposing pass; route {route}, {chunks} launches a call), "
        f"torch.mm {lib:.3f} ms (kernel / mm {ms / lib:.3f}), bound "
        f"{b_ms:.3f} ms ({by}), {b_ms / ms:.3f} of it")
    return dict(shape=[n, d, m], ms=ms, library_ms=lib, bound_ms=b_ms,
                bound_by=by, launches_a_call=chunks, route=route)


def say_stages(name, stages):
    say(f"  stages {name} (device ms a call, torch.profiler): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))


def stat_projection(dev, label, X, L, P, mask, sigma, epi, y_svr=None):
    """The stage split of one nystrom_fused_stats call (``epi``) at a main-
    path shape, and its projection row (projection_row) on the
    statistic's chunks."""
    from repro_torch.kernels import nystrom_phi as nys
    n, M = X.shape[0], P.shape[1] + 1
    y, w, _, _ = nys_stat_inputs(dev, n, M, None)
    svr = epi.endswith("svr")
    y = y_svr if svr else y
    beta = torch.zeros_like(y) if svr else y
    stages = phi_stages(lambda: nys.nystrom_fused_stats(
        X, L, P, y, beta, w, mask, sigma=sigma, add_bias=True, epilogue=epi,
        eps=EPS, eps_ins=EPS_INS if svr else 0.0))
    say_stages(f"nystrom_fused_stats[{epi}] {[n, X.shape[1], L.shape[0]]}",
               stages)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk = with_depth(nys.stats_plan, n, L.shape[0], M, sms,
                       D=X.shape[1])[2]
    tag = f"{label} (nystrom_fused_stats[{epi}])"
    return (projection_row(tag, X, L, P, sigma, chunk, stages),
            cross_row(tag, X, L, sigma, chunk, stages))


def phase_nystrom_kernels(dev):
    """Phase 3 for the four Nystrom kernels; returns their rows."""
    from repro_torch.kernels import nystrom_phi as nys
    from repro_torch.kernels import rbf_gram, ref
    f32, bf16 = torch.float32, torch.bfloat16
    out = {}
    for dtype in (f32, bf16):  # odd masked shapes, both kinds, bias
        for kind in ("rbf", "linear"):
            X, L, P, mask = nys_odd(dev, dtype, kind)
            tag = f"1037x7 m=45 {str(dtype)[6:]} {kind} masked"
            check_rbf(dev, X, X[:45].contiguous(), 1.3,
                      f"rbf_gram 1037x45x7 {str(dtype)[6:]}")
            for add_bias in (False, True):
                check_phi(X, L, P, mask, 1.3, kind, add_bias,
                          f"nystrom_phi {tag} bias={add_bias}")
            W = torch.randn(46, 3, device=dev)
            check_score(X, L, P, W, mask, 1.3, kind,
                        f"nystrom_score {tag} C=3")
            for name in NYS_VARIANTS:
                check_nys_stats(dev, X, L, P, mask, 1.3, kind, name,
                                f"{name} {tag}")
            y_svr = torch.randn(X.shape[0], generator=torch.Generator(
                device=dev).manual_seed(9), device=dev) * mask
            for name in NYS_SVR_VARIANTS:
                check_nys_stats(dev, X, L, P, mask, 1.3, kind, name,
                                f"{name} {tag}", y_svr=y_svr)

    # Main-path shapes and inputs: the circles featurizer of phase 7 and
    # the alpha-like one of phase 8.
    Xc, _ = circles_data(1_000_000)
    Lc, Pc = featurizer(dev, Xc, 1000, 0.7)
    Xa = alpha_data(300_000, 500)[0][:250_000]
    La, Pa = featurizer(dev, Xa, 2048, math.sqrt(500))
    check_rbf(dev, Lc, Lc, 0.7, "rbf_gram 1000x1000x2")
    err = check_rbf(dev, La, La, math.sqrt(500), "rbf_gram 2048x2048x500")
    t_small = time_ms(lambda: rbf_gram.rbf_gram(Lc, Lc, sigma=0.7))
    ms = time_ms(lambda: rbf_gram.rbf_gram(La, La, sigma=math.sqrt(500)))
    plain = time_ms(lambda: ref.rbf_gram(La, La, math.sqrt(500)))
    n1, d = La.shape
    b_ms, by = bound(2 * n1 * n1 * d, 4 * (2 * n1 * d + n1 * n1))
    out["rbf_gram"] = dict(shape=[n1, n1, d], max_abs_err=err, ms=ms,
                           plain_ms=plain, bound_ms=b_ms, bound_by=by,
                           library_ms=None)
    say(f"  time rbf_gram [1000, 1000, 2] (phase 7's landmark Gram): "
        f"kernel {t_small:.3f} ms")

    X = torch.from_numpy(Xa).to(dev)
    s = math.sqrt(500)
    err = check_phi(X, La, Pa, None, s, "rbf", True,
                    "nystrom_phi 250000x500 m=2048 bias")
    ms = time_ms(lambda: nys.nystrom_phi(X, La, Pa, sigma=s, add_bias=True))
    plain = time_ms(lambda: ref.nystrom_phi(X, La, Pa, None, s, "rbf", True))
    (n, d), (m, P) = X.shape, Pa.shape
    M = P + 1
    b_ms, by = bound(2 * n * m * d + 2 * n * m * M,
                     4 * (n * d + m * d + m * P + n * M))
    out["nystrom_phi"] = dict(shape=[n, d, m], max_abs_err=err, ms=ms,
                              plain_ms=plain, bound_ms=b_ms, bound_by=by,
                              library_ms=None)
    stages = phi_stages(lambda: nys.nystrom_phi(X, La, Pa, sigma=s,
                                                add_bias=True))
    say_stages("nystrom_phi 250000x500 m=2048", stages)
    chunk = with_depth(nys._phi_chunk_rows, n, m, M, D=d)
    out["projection[phase 8]"] = projection_row(
        "phase 8 (nystrom_phi)", X, La, Pa, s, chunk, stages)
    out["cross[phase 8]"] = cross_row("phase 8 (nystrom_phi)", X, La, s,
                                      chunk, stages)
    out["nystrom_phi"].update(
        stages_ms=stages,
        projection_library_ms=out["projection[phase 8]"]["library_ms"])
    del X

    Xs = torch.from_numpy(circles_data(100_000, 1)[0]).to(dev)
    M = Pc.shape[1] + 1
    W = torch.randn(M, 1, device=dev) / math.sqrt(M)
    err = check_score(Xs, Lc, Pc, W, None, 0.7, "rbf",
                      "nystrom_score 100000x2 m=1000 C=1")
    ms = time_ms(lambda: nys.nystrom_score(Xs, Lc, Pc, W, sigma=0.7,
                                           add_bias=True))
    plain = time_ms(lambda: ref.nystrom_score(Xs, Lc, Pc, W, None, 0.7,
                                              "rbf", True))
    (n, d), (m, P), C = Xs.shape, Pc.shape, 1
    M = P + 1
    b_ms, by = bound(2 * n * m * d + 2 * n * m * M + 2 * n * M * C,
                     4 * (n * d + m * d + m * P + M * C + n * C))
    out["nystrom_score"] = dict(shape=[n, d, m, C], max_abs_err=err, ms=ms,
                                plain_ms=plain, bound_ms=b_ms, bound_by=by,
                                library_ms=None)
    stages = phi_stages(lambda: nys.nystrom_score(Xs, Lc, Pc, W, sigma=0.7,
                                                  add_bias=True))
    say_stages("nystrom_score 100000x2 m=1000 C=1", stages)
    proj = projection_row("nystrom_score", Xs, Lc, Pc, 0.7,
                          with_depth(nys._phi_chunk_rows, n, m, M, D=d),
                          stages)
    out["nystrom_score"].update(stages_ms=stages,
                                projection_library_ms=proj["library_ms"])
    del Xs

    X = torch.from_numpy(Xc).to(dev)
    mask = torch.ones(X.shape[0], device=dev)  # as the fit passes it
    for name in NYS_VARIANTS:
        out[name] = time_nys_stats(dev, X, Lc, Pc, mask, 0.7, name,
                                   f"{name} 1000000x2 m=1000")
    out["projection[phase 7]"], out["cross[phase 7]"] = stat_projection(
        dev, "phase 7", X, Lc, Pc, mask, 0.7, "em_hinge")
    del X
    # phase 10's shape: the year split with its featurizer, m = 681
    Xtr, ytr = year_split()[:2]
    m = math.ceil(math.sqrt(Xtr.shape[0]))
    Ly, Py = featurizer(dev, Xtr, m, math.sqrt(90))
    X = torch.from_numpy(Xtr).to(dev)
    mask = torch.ones(X.shape[0], device=dev)
    y = torch.from_numpy(ytr).to(dev)
    for name in NYS_SVR_VARIANTS:
        out[name] = time_nys_stats(dev, X, Ly, Py, mask, math.sqrt(90), name,
                                   f"{name} {Xtr.shape[0]}x90 m={m}",
                                   y_svr=y)
    out["projection[phase 10]"], out["cross[phase 10]"] = stat_projection(
        dev, "phase 10", X, Ly, Py, mask, math.sqrt(90), "em_svr", y)
    del X
    for name, row in out.items():
        if name.startswith(("projection[", "cross[")):
            continue
        say(f"  time {name} {row['shape']}: kernel {row['ms']:.3f} ms, "
            f"plain {row['plain_ms']:.3f} ms, library none, bound "
            f"{row['bound_ms']:.3f} ms ({row['bound_by']})")
    return out


def phi_design(dev):
    """The projection's layout on the Gram engine at phase 7's, 8's and
    10's shapes (nothing timed or asserted): each operand's copy path,
    proj's row stride, the CTAs of a chunk and their waves of resident
    CTAs, and phi_tiles' registers, spills, dynamic shared memory and CTAs
    an SM."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import nystrom_phi as nys
    report = build_report(_build.build()[1])
    lib = _build.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kern, per_sm = [], 0
    for code, mode in enumerate(("write", "score")):
        smem, ctas = ctypes.c_int(), ctypes.c_int()
        check(lib.rt_nystrom_phi_occupancy(dev.index, code,
                                           ctypes.byref(smem),
                                           ctypes.byref(ctas)) == 0,
              "phi_tiles: occupancy query failed")
        reg, _, sst, sld, _ = report[f"phi_tiles<{mode}>"]
        kern.append(f"phi_tiles<{mode}> {reg} registers, {sst} / {sld} B "
                    f"spilled, {smem.value} B dynamic shared, {ctas.value} "
                    "CTAs an SM")
        per_sm = per_sm or ctas.value
    for label, n, m, chunk in (
            ("phase 7", 1_000_000, 1000,
             nys.stats_plan(1_000_000, 1000, 1001, sms, D=2)[2]),
            ("phase 8", 250_000, 2048, nys._phi_chunk_rows(250_000, 2048,
                                                           2049, D=500)),
            ("phase 10", N_YEAR_TRAIN, 681,
             nys.stats_plan(N_YEAR_TRAIN, 681, 682, sms, D=90)[2])):
        M = m + 1
        ldp = nys.proj_operand(torch.empty((m, m), device=dev)).shape[1]
        row_tiles = -(-chunk // nys.GT)
        ctas = row_tiles * -(-M // nys.GT)
        product = row_tiles * -(-m // nys.GT)
        say(f"  phi_design {label} {[n, m, M]}: A the cross-Gram chunk "
            f"(m, R = {chunk}) landmark-major, rows {chunk} apart, 16-byte "
            f"cp.async; B proj, rows {ldp} apart "
            f"({'a padded copy' if ldp != m else 'as given'}), 16-byte "
            f"cp.async; {ctas} CTAs a chunk ({product} with a product), "
            f"{product / (per_sm * sms):.2f} waves of {per_sm} an SM on "
            f"{sms} SMs, {-(-n // chunk)} chunks; " + "; ".join(kern))


def cross_design(dev, n=250_000, m=1000,
                 depths=(2, 8, 12, 16, 32, 90, 500)):
    """The cross-Gram's two routes (csrc/rbf.cuh: the Gram engine's tile
    pass, the direct product) on the same inputs at each depth (nothing
    asserted): the cross-Gram stage (operands and product, torch.profiler,
    a call's mean over three) of nystrom_phi on n rows, m landmarks and a
    4-column proj, in the order engine, direct, direct, engine; beside the
    bound and the route rbf_gram.cross_route ships."""
    from repro_torch.kernels import nystrom_phi as nys
    from repro_torch.kernels import rbf_gram
    g = torch.Generator(device=dev).manual_seed(5)
    for d in depths:
        X = torch.randn(n, d, generator=g, device=dev) / math.sqrt(d)
        L = X[:m].contiguous()
        P = torch.randn(m, 4, generator=g, device=dev)
        t = {"engine": [], "direct": []}
        for route in ("engine", "direct", "direct", "engine"):
            st = phi_stages(patched(
                lambda: nys.nystrom_phi(X, L, P, sigma=1.0), rbf_gram,
                "CROSS_DIRECT_MAX_D", 1 << 20 if route == "direct" else 0))
            t[route].append(st["cross-Gram operands"] + st["cross-Gram"])
        e, r = statistics.mean(t["engine"]), statistics.mean(t["direct"])
        b_ms, by = bound(2 * n * m * d, 4 * (n * d + m * d + n * m))
        say(f"  cross_design D={d} {[n, d, m]}: engine {e:.3f} ms "
            f"{[round(x, 3) for x in t['engine']]}, direct {r:.3f} ms "
            f"{[round(x, 3) for x in t['direct']]}; engine / direct "
            f"{e / r:.3f}; bound {b_ms:.3f} ms ({by}); shipped route "
            f"{rbf_gram.CROSS_ROUTES[rbf_gram.cross_route(d)]} "
            f"(CROSS_DIRECT_MAX_D = {rbf_gram.CROSS_DIRECT_MAX_D})")
        del X, L, P
    torch.cuda.empty_cache()


def _nys_fit(label, cfg, dev, X, y, Xte, yte, m, featurizer_of=None):
    """One NystromSVM fit (own landmarks and projection, or those of
    ``featurizer_of``), its counts zeroed just before and read just after,
    then its held-out accuracy (predict) with the counts read again."""
    from repro_torch.core import NystromSVM
    _zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ny = NystromSVM(cfg, n_landmarks=m, device=dev)
    if featurizer_of is None:
        res = ny.fit(X, y)
    else:
        res = ny.fit_featurized(X, y, featurizer_of._landmarks,
                                featurizer_of._proj)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated()
    counts = _counts()
    what, metric = _metric(ny, cfg, Xte, yte)
    pred = _counts()
    steps = min(cfg.max_iters, -(-res.n_iters // cfg.scan_chunk)
                * cfg.scan_chunk)
    launched = {k: v for k, v in counts.items() if v}
    say(f"  {label}: {secs:.3f} s, {res.n_iters} iterations ({steps} steps "
        f"run, {secs / steps * 1e3:.2f} ms a step), converged "
        f"{res.converged}, {res.n_host_syncs} host syncs, held-out {what} "
        f"{metric:.4f}, peak device memory {mem / 2**20:.0f} MiB, launches "
        f"{launched}, on predict nystrom_score {pred['nystrom_score']}")
    check(bool(np.all(np.isfinite(res.weights))), f"{label}: non-finite "
          "weights")
    check(res.n_host_syncs <= math.ceil(cfg.max_iters / cfg.scan_chunk),
          f"{label}: scan driver synced more than once per chunk")
    return ny, res, dict(secs=secs, mem=mem, counts=counts, pred=pred,
                         metric=metric, steps=steps)


def phase_krn(dev, n=1_000_000, n_test=100_000):
    from repro_torch.core import SVMConfig
    X, y = circles_data(n)
    Xte, yte = circles_data(n_test, 1)
    m = math.ceil(math.sqrt(n))
    phi_bytes = 4 * n * (m + 1)
    common = dict(lam=0.1, sigma=0.7, max_iters=60)
    Xw, yw = circles_data(4096, 2)
    for backend in (None, "ref"):  # warm-up: cuBLAS/cuSOLVER set-up
        _nys_fit("warm-up", SVMConfig.from_options(
            "KRN-EM-CLS", backend=backend, max_iters=2, min_iters=2,
            lam=0.1, sigma=0.7), dev, Xw, yw, Xw, yw, 64)
    runs = {}
    for opts, extra, name in (
            ("KRN-EM-CLS", {}, "nystrom_fused_stats[em_hinge]"),
            ("KRN-MC-CLS", dict(rng="fused"),
             "nystrom_fused_stats[mc_hinge,seed]"),
            ("KRN-MC-CLS", dict(rng="host"),
             "nystrom_fused_stats[mc_hinge,noise]")):
        cfg = SVMConfig.from_options(opts, **common, **extra)
        tag = f"{opts} rng={cfg.rng!r}" if extra else opts
        ny, res, k = _nys_fit(f"kernels fit {tag}", cfg, dev, X, y, Xte, yte,
                              m)
        _, rp, p = _nys_fit(f"plain fit {tag}",
                            dataclasses.replace(cfg, backend="ref"), dev, X,
                            y, Xte, yte, m, featurizer_of=ny)
        c = k["counts"]
        check(res.converged, f"{tag}: the kernel fit did not converge")
        check(c[name] == k["steps"], f"{tag}: {name} launched {c[name]} "
              f"times for {k['steps']} steps run")
        check(c["nystrom_phi"] == 0 and c["rbf_gram"] == 1,
              f"{tag}: nystrom_phi {c['nystrom_phi']} (want 0), rbf_gram "
              f"{c['rbf_gram']} (want 1 a fit)")
        check(all(v == 0 for key, v in c.items()
                  if key not in (name, "rbf_gram")),
              f"{tag}: launched other kernels: {c}")
        check(k["pred"]["nystrom_score"] == dispatches(len(Xte)),
              f"{tag}: predict did not run nystrom_score once a dispatch")
        check(all(v == 0 for v in p["counts"].values()),
              f"{tag}: the plain fit launched a kernel")
        check(k["mem"] < phi_bytes, f"{tag}: peak device memory "
              f"{k['mem']} B is not below phi's {phi_bytes} B")
        check(k["metric"] >= 0.99 and abs(k["metric"] - p["metric"]) <= 0.01,
              f"{tag}: held-out accuracy {k['metric']:.4f} (plain "
              f"{p['metric']:.4f})")
        say(f"  bands {tag}: iterations {res.n_iters} vs plain "
            f"{rp.n_iters}, weights rel {_rel(res.weights, rp.weights):.3e}"
            f", accuracy diff {abs(k['metric'] - p['metric']):.4f} (<= 0.01); "
            f"peak {k['mem'] / 2**20:.0f} MiB against phi's "
            f"{phi_bytes / 2**20:.0f} MiB")
        runs[name] = (c, res.n_iters, k["steps"])
        if name.endswith("[em_hinge]"):
            runs["rbf_gram"] = (c, res.n_iters, k["steps"])
            runs["nystrom_score"] = (k["pred"], res.n_iters, k["steps"])
            profile_krn(cfg, dev, X, y, m, ny)
    return runs


def profile_krn(cfg, dev, X, y, m, featurizer_of, top=8):
    """torch.profiler over one EM kernel fit on a given featurizer."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import NystromSVM
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ny = NystromSVM(cfg, n_landmarks=m, device=dev)
        res = ny.fit_featurized(X, y, featurizer_of._landmarks,
                                featurizer_of._proj)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    say_profile(prof, secs, top, f"profile of the {cfg.options} kernels "
                f"fit: {secs * 1e3:.1f} ms wall for {res.n_iters} iterations")


def phase_krn_wide(dev, n_train=250_000, k=500, m=2048, iters=5):
    from repro_torch.core import SVMConfig
    X, y = alpha_data(n_train + 50_000, k)
    Xtr, ytr, Xte, yte = X[:n_train], y[:n_train], X[n_train:], y[n_train:]
    cfg = SVMConfig.from_options("KRN-EM-CLS", lam=0.1, sigma=math.sqrt(k),
                                 max_iters=iters, min_iters=iters)
    ny, res, kr = _nys_fit("kernels fit", cfg, dev, Xtr, ytr, Xte, yte, m)
    SERVE_MODELS["KRN-EM-CLS m=2048 (phase 8)"] = (ny, Xte, Xtr, ytr)
    _, rp, p = _nys_fit("plain fit", dataclasses.replace(cfg, backend="ref"),
                        dev, Xtr, ytr, Xte, yte, m, featurizer_of=ny)
    c = kr["counts"]
    steps = kr["steps"]
    check(all(c[key] == steps for key in
              ("nystrom_phi", "fused_estep", "syrk_tri")),
          f"nystrom_phi, fused_estep, syrk_tri must each launch once a "
          f"step ({steps}): {c}")
    check(c["rbf_gram"] == 1, f"rbf_gram launched {c['rbf_gram']} times")
    check(all(v == 0 for key, v in c.items() if "fused_stats" in key),
          f"the m > 1024 route launched a fused statistic: {c}")
    check(all(v == 0 for v in p["counts"].values()),
          "the plain fit launched a kernel")
    o, op = np.asarray(res.objective), np.asarray(rp.objective)
    check(len(o) == len(op) == iters, "both fits run 5 iterations")
    orel = float(np.max(np.abs(o - op) / np.abs(op)))
    wrel = _rel(res.weights, rp.weights)
    w64 = em64(dev, Xtr, ytr, ny, cfg, iters)
    say(f"  bands: objective rel {orel:.3e} (<= 2e-2 at every iteration), "
        f"accuracy kernel {kr['metric']:.4f} plain {p['metric']:.4f} (within "
        f"0.01), weights rel {wrel:.3e} (band 5e-2: "
        f"{'met' if wrel <= 5e-2 else 'MISSED, see ROADMAP section 3'}); "
        f"against a float64 EM on the same featurizer: kernel weights rel "
        f"{_rel(res.weights, w64):.3e}, plain {_rel(rp.weights, w64):.3e}")
    check(orel <= 2e-2 and abs(kr["metric"] - p["metric"]) <= 0.01,
          "kernel fit outside the EM bands of the plain fit")
    profile_krn(cfg, dev, Xtr, ytr, m, ny, top=6)
    return {"nystrom_phi": (c, res.n_iters, steps)}


def em64(dev, X, y, ny, cfg, iters):
    """``iters`` EM steps from w = 0 in float64 on the fitted model's
    featurizer (phi from the plain version in float64), with the solver's
    ridge and relative jitter: the yardstick both float32 fits are
    measured against in phase 8."""
    from repro_torch.kernels import ref
    L = torch.from_numpy(ny._landmarks).to(dev).double()
    P = torch.from_numpy(ny._proj).to(dev).double()
    Xd = torch.from_numpy(X).to(dev)
    y64 = torch.from_numpy(y).to(dev).double()
    phi = torch.empty((X.shape[0], P.shape[1] + 1), dtype=torch.float64,
                      device=dev)
    for c0 in range(0, X.shape[0], ROWS_A_CHECK):
        sl = slice(c0, c0 + ROWS_A_CHECK)
        phi[sl] = ref.nystrom_phi(Xd[sl].double(), L, P, None, cfg.sigma,
                                  cfg.kernel, True)
    K = phi.shape[1]
    eye = torch.eye(K, dtype=torch.float64, device=dev)
    w = torch.zeros(K, dtype=torch.float64, device=dev)
    for _ in range(iters):
        g = (y64 - phi @ w).abs().clamp_min(cfg.eps)
        Pm = (phi / g[:, None]).T @ phi + cfg.lam * eye
        Pm = 0.5 * (Pm + Pm.T)
        Pm = Pm + (cfg.jitter * torch.trace(Pm) / K) * eye
        w = torch.linalg.solve(Pm, phi.T @ (y64 / g + y64))
    return w.cpu().numpy()


def year_split():
    """YearPredictionMSD's own split of the year-like set: the first
    463,715 rows train, the last 51,630 are held out."""
    X, y = year_data()
    return (X[:N_YEAR_TRAIN], y[:N_YEAR_TRAIN], X[N_YEAR_TRAIN:],
            y[N_YEAR_TRAIN:])


def em_svr_trace(dev, A, y, cfg, iters, estep=None, y_shift=0.0):
    """``iters`` EM-SVR steps from w = 0 on the rows ``A`` (a float64
    device matrix: X with its bias column, or phi), with the solver's
    ridge and relative jitter; Sigma, b and the Cholesky in float64, the
    E-step (margin, gamma, omega) in ``estep`` (float64 by default).
    ``y_shift`` moves each target by that relative amount times a normal
    draw (seed 0). Returns the objective trace and the weights: at the
    defaults, the yardstick both float32 fits are measured against."""
    estep = estep or torch.float64
    y64 = torch.from_numpy(y).to(dev).double()
    if y_shift:
        g = torch.Generator(device=dev).manual_seed(0)
        y64 = y64 * (1.0 + y_shift * torch.randn(
            y64.shape, generator=g, device=dev, dtype=torch.float64))
    K = A.shape[1]
    Ae, ye = A.to(estep), y64.to(estep)
    eye = torch.eye(K, dtype=torch.float64, device=dev)
    w = torch.zeros(K, dtype=torch.float64, device=dev)
    trace = []
    for _ in range(iters):
        res = ye - Ae @ w.to(estep)
        g = (res - cfg.eps_ins).abs().clamp_min(cfg.eps)
        o = (res + cfg.eps_ins).abs().clamp_min(cfg.eps)
        wt = (1.0 / g + 1.0 / o).double()
        cf = ((ye - cfg.eps_ins) / g + (ye + cfg.eps_ins) / o).double()
        P = (A * wt[:, None]).T @ A + cfg.lam * eye
        P = 0.5 * (P + P.T)
        P = P + (cfg.jitter * torch.trace(P) / K) * eye
        w = torch.linalg.solve(P, A.T @ cf)
        loss = 2.0 * torch.clamp_min(res.double().abs() - cfg.eps_ins,
                                     0.0).sum()
        trace.append(float(0.5 * cfg.lam * (w @ w) + loss))
    del Ae
    return np.asarray(trace), w.cpu().numpy()


def trace_rel(a, b):
    """Largest relative distance of two objective traces over their
    common prefix."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    j = min(len(a), len(b))
    return float(np.max(np.abs(a[:j] - b[:j]) / np.abs(b[:j])))


# LIN-EM-SVR's objective band. The EM-SVR iteration is sensitive at
# the two knees (rows with |res -+ eps_ins| below eps take the weight
# 1/eps): a float64 EM whose targets move by 1e-15 relative drifts ~2 %
# in its trace, and a float32 E-step with float64 Sigma and Cholesky stays
# as far from float64 as the kernel fit. So two correct float32 fits at
# the year size sit ~2 % apart, beyond the CLS band of 2e-2; phase 9
# prints that spread beside the gate (ROADMAP section 3). Phase 10 keeps
# 2e-2.
SVR_TRACE_BAND = 5e-2


def phase_svr(dev):
    """Phase 9: LIN-{EM,MC}-SVR, the paper's Table 6, on the year split."""
    from repro_torch.core import SVMConfig, lam_from_C
    from repro_torch.data import make_year_like
    Xtr, ytr, Xte, yte = data = year_split()
    cfg = SVMConfig.from_options("LIN-EM-SVR", lam=lam_from_C(0.01),
                                 eps_ins=EPS_INS, max_iters=100)
    Xw, yw = make_year_like(4096, 90, seed=1)
    for c in (cfg, dataclasses.replace(cfg, algorithm="MC", rng="fused")):
        for backend in (None, "ref"):  # warm-up: cuBLAS/cuSOLVER set-up
            _fit(dataclasses.replace(c, max_iters=2, min_iters=2,
                                     backend=backend), dev, Xw, yw)
    rk, rmse_k, st_k, c_k = _mc_fit("kernels fit, LIN-EM-SVR", cfg, dev, data,
                                    "fused_stats[em_svr]")
    rp, rmse_p, _, _ = _mc_fit("plain fit, LIN-EM-SVR",
                               dataclasses.replace(cfg, backend="ref"), dev,
                               data)
    # after the fits, so their peak memory is their own: the ridge, Table
    # 6's closed-form anchor, and the float64 EM, both on the card
    A = torch.from_numpy(np.concatenate(
        [Xtr, np.ones((len(Xtr), 1), np.float32)], 1)).to(dev).double()
    At = torch.from_numpy(np.concatenate(
        [Xte, np.ones((len(Xte), 1), np.float32)], 1)).to(dev).double()
    y64 = torch.from_numpy(ytr).to(dev).double()
    wr = torch.linalg.solve(A.T @ A + 1e-6 * torch.eye(A.shape[1],
                            dtype=torch.float64, device=dev), A.T @ y64)
    ridge = float(torch.sqrt(torch.mean(
        (At @ wr - torch.from_numpy(yte).to(dev).double()) ** 2)))
    iters = max(rk.n_iters, rp.n_iters)
    t64, w64 = em_svr_trace(dev, A, ytr, cfg, iters)
    # where the drift comes from: the float64 EM against itself with the
    # targets moved by 1e-15, and a float32 E-step with float64 Sigma and
    # Cholesky (the plain path's arithmetic but for those two)
    t_shift, _ = em_svr_trace(dev, A, ytr, cfg, iters, y_shift=1e-15)
    t_mix, w_mix = em_svr_trace(dev, A, ytr, cfg, iters,
                                estep=torch.float32)
    del A, At
    orel = trace_rel(rk.objective, rp.objective)
    wrel = _rel(rk.weights, rp.weights)
    say(f"  EM bands: iterations {rk.n_iters} vs plain {rp.n_iters} (<= 3), "
        f"objective rel {orel:.3e} (<= {SVR_TRACE_BAND}), weights rel "
        f"{wrel:.3e} (<= 5e-2), RMSE kernel {rmse_k:.4f} plain {rmse_p:.4f} "
        f"(within 0.01), ridge {ridge:.4f}; against a float64 EM: objective "
        f"kernel {trace_rel(rk.objective, t64):.3e} plain "
        f"{trace_rel(rp.objective, t64):.3e}, weights kernel "
        f"{_rel(rk.weights, w64):.3e} plain {_rel(rp.weights, w64):.3e}")
    say(f"  EM-SVR drift against the float64 EM: the float64 EM with "
        f"targets moved by 1e-15 {trace_rel(t_shift, t64):.3e}; float32 "
        f"E-step with float64 Sigma and Cholesky "
        f"{trace_rel(t_mix, t64):.3e} (weights {_rel(w_mix, w64):.3e})")
    check(rk.converged and rp.converged, "an EM-SVR fit did not converge")
    check(abs(rk.n_iters - rp.n_iters) <= 3 and orel <= SVR_TRACE_BAND
          and wrel <= 5e-2 and abs(rmse_k - rmse_p) <= 0.01,
          "EM-SVR kernel fit outside the bands of the plain fit")

    mc = dataclasses.replace(cfg, algorithm="MC", rng="fused")
    mk, rmse_mk, st_mk, c_mk = _mc_fit(
        "kernels fit, LIN-MC-SVR rng='fused'", mc, dev, data,
        "fused_stats[mc_svr,seed]")
    plain = dataclasses.replace(mc, backend="ref")
    mp, rmse_mp, _, _ = _mc_fit("plain fit, rng='fused', seed 0", plain, dev,
                                data)
    mp1, _, _, _ = _mc_fit("plain fit, rng='fused', seed 1",
                           dataclasses.replace(plain, seed=1), dev, data)
    mh, rmse_h, st_h, c_h = _mc_fit(
        "kernels fit, LIN-MC-SVR rng='host'",
        dataclasses.replace(mc, rng="host"), dev, data,
        "fused_stats[mc_svr,noise]")
    mcc, rmse_c, st_c, c_c = _mc_fit(
        "kernels fit, LIN-MC-SVR rng='fused', n_chains=4",
        dataclasses.replace(mc, n_chains=4), dev, data,
        "fused_stats[mc_svr,seed,C=4]")
    profile_fit("the LIN-EM-SVR kernels fit", cfg, dev, data)
    spread = _rel(mp1.weights, mp.weights)
    wrel = _rel(mk.weights, mp.weights)
    say(f"  MC bands: kernel vs plain weights rel {wrel:.4e} (<= 3 x the "
        f"seed 0 vs 1 spread of the plain path, {spread:.4e}); RMSE kernel "
        f"{rmse_mk:.4f} plain {rmse_mp:.4f} host {rmse_h:.4f} 4 chains "
        f"{rmse_c:.4f} (each within 0.01 of the plain fit's); chain std "
        f"mean {float(np.mean(mcc.chain_std)):.4e}")
    check(mk.converged and mp.converged, "an MC-SVR rng='fused' fit did not "
          "converge")
    check(wrel <= 3 * spread, "MC-SVR kernel fit outside 3x the seed spread")
    check(all(abs(r - rmse_mp) <= 0.01 for r in (rmse_mk, rmse_h, rmse_c)),
          "an MC-SVR RMSE is not within 0.01 of the plain fit's")
    check(mcc.chain_weights.shape == (4, 91)
          and bool(np.all(np.isfinite(mcc.chain_std))),
          "n_chains=4: bad chain_weights or chain_std")
    return {"fused_stats[em_svr]": (c_k, rk.n_iters, st_k),
            "fused_stats[mc_svr,seed]": (c_mk, mk.n_iters, st_mk),
            "fused_stats[mc_svr,noise]": (c_h, mh.n_iters, st_h),
            "fused_stats[mc_svr,seed,C=4]": (c_c, mcc.n_iters, st_c)}


NYS_SVR_VARIANTS = {  # chip_smoke name: (epilogue, noise source)
    "nystrom_fused_stats[em_svr]": ("em_svr", None),
    "nystrom_fused_stats[mc_svr,noise]": ("mc_svr", "noise"),
    "nystrom_fused_stats[mc_svr,seed]": ("mc_svr", "seed"),
}


def phase_krn_svr(dev):
    """Phase 10: KRN-{EM,MC}-SVR through NystromSVM on the year split,
    m = ceil(sqrt(463,715)) = 681, the fused route."""
    from repro_torch.core import SVMConfig
    from repro_torch.data import make_year_like
    from repro_torch.kernels import ref
    Xtr, ytr, Xte, yte = year_split()
    n = Xtr.shape[0]
    m = math.ceil(math.sqrt(n))
    phi_bytes = 4 * n * (m + 1)
    common = dict(lam=1.0, sigma=math.sqrt(90), eps_ins=EPS_INS,
                  max_iters=60)
    Xw, yw = make_year_like(4096, 90, seed=1)
    for backend in (None, "ref"):  # warm-up: cuBLAS/cuSOLVER set-up
        _nys_fit("warm-up", SVMConfig.from_options(
            "KRN-EM-SVR", backend=backend, max_iters=2, min_iters=2,
            **{k: v for k, v in common.items() if k != "max_iters"}),
            dev, Xw, yw, Xw, yw, 64)
    runs = {}
    for opts, extra, name in (
            ("KRN-EM-SVR", {}, "nystrom_fused_stats[em_svr]"),
            ("KRN-MC-SVR", dict(rng="fused"),
             "nystrom_fused_stats[mc_svr,seed]"),
            ("KRN-MC-SVR", dict(rng="host"),
             "nystrom_fused_stats[mc_svr,noise]")):
        cfg = SVMConfig.from_options(opts, **common, **extra)
        tag = f"{opts} rng={cfg.rng!r}" if extra else opts
        ny, res, k = _nys_fit(f"kernels fit {tag}", cfg, dev, Xtr, ytr, Xte,
                              yte, m)
        _, rp, p = _nys_fit(f"plain fit {tag}",
                            dataclasses.replace(cfg, backend="ref"), dev, Xtr,
                            ytr, Xte, yte, m, featurizer_of=ny)
        c = k["counts"]
        check(res.converged and rp.converged, f"{tag}: a fit did not "
              "converge")
        check(c[name] == k["steps"], f"{tag}: {name} launched {c[name]} "
              f"times for {k['steps']} steps run")
        check(c["nystrom_phi"] == 0 and c["rbf_gram"] == 1,
              f"{tag}: nystrom_phi {c['nystrom_phi']} (want 0), rbf_gram "
              f"{c['rbf_gram']} (want 1 a fit)")
        check(all(v == 0 for key, v in c.items()
                  if key not in (name, "rbf_gram")),
              f"{tag}: launched other kernels: {c}")
        check(k["pred"]["nystrom_score"] == dispatches(len(Xte)),
              f"{tag}: predict did not run nystrom_score once a dispatch")
        check(all(v == 0 for v in p["counts"].values()),
              f"{tag}: the plain fit launched a kernel")
        check(k["mem"] < phi_bytes, f"{tag}: peak device memory "
              f"{k['mem']} B is not below phi's {phi_bytes} B")
        check(abs(k["metric"] - p["metric"]) <= 0.01,
              f"{tag}: held-out RMSE {k['metric']:.4f} (plain "
              f"{p['metric']:.4f})")
        wrel = _rel(res.weights, rp.weights)
        line = (f"  bands {tag}: iterations {res.n_iters} vs plain "
                f"{rp.n_iters}, weights rel {wrel:.3e}"
                f" (printed, not gated: ROADMAP section 3), RMSE diff "
                f"{abs(k['metric'] - p['metric']):.4f} (<= 0.01); peak "
                f"{k['mem'] / 2**20:.0f} MiB against phi's "
                f"{phi_bytes / 2**20:.0f} MiB")
        if opts == "KRN-EM-SVR":
            orel = trace_rel(res.objective, rp.objective)
            L = torch.from_numpy(ny._landmarks).to(dev).double()
            P = torch.from_numpy(ny._proj).to(dev).double()
            Xd = torch.from_numpy(Xtr).to(dev)
            phi = torch.empty((n, P.shape[1] + 1), dtype=torch.float64,
                              device=dev)
            for c0 in range(0, n, ROWS_A_CHECK):
                sl = slice(c0, c0 + ROWS_A_CHECK)
                phi[sl] = ref.nystrom_phi(Xd[sl].double(), L, P, None,
                                          cfg.sigma, cfg.kernel, True)
            t64, _ = em_svr_trace(dev, phi, ytr, cfg,
                                  max(res.n_iters, rp.n_iters))
            del phi, Xd
            line += (f"; objective rel {orel:.3e} (<= 2e-2), "
                     f"against a float64 EM: kernel "
                     f"{trace_rel(res.objective, t64):.3e} plain "
                     f"{trace_rel(rp.objective, t64):.3e}")
            check(orel <= 2e-2, f"{tag}: objective trace outside "
                  "the band of the plain fit")
            profile_krn(cfg, dev, Xtr, ytr, m, ny)
            em_fit = (ny, res)
        say(line)
        runs[name] = (c, res.n_iters, k["steps"])
        torch.cuda.empty_cache()
    return runs, em_fit


# ---------------------------------------------------------- the windows
WIN_VARIANTS = {  # chip_smoke name: (LAUNCHES key, epilogue, noise source)
    f"fused_stats[{v},window]": (f"{v},window", v.split(",")[0],
                                 v.split(",")[1] if "," in v else None)
    for v in ("em_hinge", "mc_hinge,noise", "mc_hinge,seed", "em_svr",
              "mc_svr,noise", "mc_svr,seed")}
NYS_WIN_VARIANTS = {  # chip_smoke name: (epilogue, noise source)
    f"nystrom_fused_stats[{v},window]": (v.split(",")[0],
                                         v.split(",")[1] if "," in v
                                         else None)
    for v in ("em_hinge", "mc_hinge,noise", "mc_hinge,seed", "em_svr",
              "mc_svr,noise", "mc_svr,seed")}
ODD_WINDOWS = ((0, 29), (5, 7), (22, 7), (13, 1), (0, 1))  # the reference's
MID_WINDOWS = ((0, 7), (130, 7), (293, 7), (100, 150), (0, 300))


def rank_rows(n, shards):
    """Rows of one data shard's block as the port pads a training set of
    ``n`` rows over ``shards`` (``distributed.pad_rows``): 125,000 of the
    alpha-like 250,000 on two shards, 62,504 on four, 231,864 of the year
    split's 463,715 on two."""
    from repro_torch.core import distributed
    z = np.zeros((n, 0), np.float32)
    return distributed.pad_rows(z, z.sum(1), shards)[0].shape[0] // shards


def halves(width):
    """The windows of a 2-way k axis over ``width`` columns: (0, 251) and
    (251, 251) at K = 502, (0, 341) and (341, 341) at phi width 682."""
    half = width // 2
    return (0, half), (half, width - half)


def win_inputs(dev, n, k, dtype, regime, name, g):
    """(X, rho, beta, w, wm, kw) for one window variant: the hinge pair
    from ``problem``, SVR targets from ``svr_targets`` (beta 0); kw the
    noise= or seed= of an MC variant."""
    _, epi, source = WIN_VARIANTS[name]
    X, rho, beta, w, wm = problem(n, k, dtype, "well" if epi.endswith("svr")
                                  else regime, dev)
    if epi.endswith("svr"):
        rho = svr_targets(X.double() @ w.double(),
                          "knee" if regime == "hinge" else "well", g)
        beta = torch.zeros_like(rho)
    kw = {}
    if source:
        kw = mc_inputs(dev, n, k, source, 1, w, epi)[0]
    return X, rho, beta, w, wm, kw


def check_win(X, rho, beta, w, wm, kw, name, windows, label):
    """One window variant of fused_stats at ``windows``: each window twice
    and bitwise repeatable; margin, gamma (omega) and b bitwise the full
    variant's; Sigma's window bitwise the full variant's column slice and
    within 1e-5 max|S64| of the float64 statistic from the kernel's own
    gamma (and omega). Returns max |d|."""
    from repro_torch.kernels import fused_stats
    _, epi, _ = WIN_VARIANTS[name]
    svr = epi.endswith("svr")
    kw = dict(kw, epilogue=epi, eps=EPS, eps_ins=EPS_INS if svr else 0.0)
    full = fused_stats.fused_stats(X, rho, beta, w, wm, **kw)
    if svr:
        _, S64 = svr_stats64(X, rho, wm, full[1], full[2])
    else:
        _, S64 = stats64(X, rho, beta, wm, full[1])
    scale = S64.abs().max().item()
    err = 0.0
    for start, blk in windows:
        out = twice(lambda: fused_stats.fused_stats(
            X, rho, beta, w, wm, col_window=(start, blk), **kw))
        check(all(torch.equal(a, b) for a, b in zip(out[:-1], full[:-1])),
              f"{label} ({start}, {blk}): margin, gamma or b differ from "
              "the full variant's")
        check(torch.equal(out[-1], full[-1][:, start:start + blk]),
              f"{label} ({start}, {blk}): Sigma is not the full variant's "
              "column slice")
        e = (out[-1].double() - S64[:, start:start + blk]).abs().max().item()
        check(e <= REL * scale, f"{label} ({start}, {blk}): max |d| {e:.3e}"
              f" exceeds 1e-5 max|S64| = {REL * scale:.3e}")
        err = max(err, e)
    say(f"  ok {label} windows {list(windows)}: bitwise repeatable, bitwise "
        f"the full variant's column slice, max |d| {err:.3e}")
    return err


def nys_sigma64(X, L, P, mask, sigma, kind, y, g, o=None):
    """Sigma in float64 from the nystrom_phi kernel's own phi and the
    given gamma (and omega under SVR), in row chunks."""
    from repro_torch.kernels import nystrom_phi as nys
    S64 = None
    for c0 in range(0, X.shape[0], ROWS_A_CHECK):
        sl = slice(c0, c0 + ROWS_A_CHECK)
        mk = None if mask is None else mask[sl]
        phik = nys.nystrom_phi(X[sl], L, P, mk, sigma=sigma, kind=kind,
                               add_bias=True).double()
        wt = 1.0 / g[sl].double()
        if o is not None:
            wt = wt + 1.0 / o[sl].double()
        if mk is not None:
            wt = wt * mk.double()
        Sk = (phik * wt[:, None]).T @ phik
        S64 = Sk if S64 is None else S64 + Sk
    return S64


def check_nys_win(dev, X, L, P, mask, sigma, kind, name, windows, label,
                  y_svr=None):
    """One window variant of nystrom_fused_stats, held as check_win holds
    fused_stats's; returns (max |d|, the call's arguments)."""
    from repro_torch.kernels import nystrom_phi as nys
    epi, source = NYS_WIN_VARIANTS[name]
    svr = epi.endswith("svr")
    n, M = X.shape[0], P.shape[1] + 1
    y, w, kw, _ = nys_stat_inputs(dev, n, M, source, epi)
    if svr:
        y = y_svr
    elif mask is not None:
        y = y * mask
    beta = torch.zeros_like(y) if svr else y
    kw = dict(kw, sigma=sigma, kind=kind, add_bias=True, epilogue=epi,
              eps=EPS, eps_ins=EPS_INS if svr else 0.0)
    full = nys.nystrom_fused_stats(X, L, P, y, beta, w, mask, **kw)
    S64 = nys_sigma64(X, L, P, mask, sigma, kind, y, full[1],
                      full[2] if svr else None)
    scale = S64.abs().max().item()
    err = 0.0
    for start, blk in windows:
        out = twice(lambda: nys.nystrom_fused_stats(
            X, L, P, y, beta, w, mask, col_window=(start, blk), **kw))
        check(all(torch.equal(a, b) for a, b in zip(out[:-1], full[:-1])),
              f"{label} ({start}, {blk}): margin, gamma or b differ from "
              "the full variant's")
        check(torch.equal(out[-1], full[-1][:, start:start + blk]),
              f"{label} ({start}, {blk}): Sigma is not the full variant's "
              "column slice")
        e = (out[-1].double() - S64[:, start:start + blk]).abs().max().item()
        check(e <= REL * scale, f"{label} ({start}, {blk}): max |d| {e:.3e}"
              f" exceeds 1e-5 max|S64| = {REL * scale:.3e}")
        err = max(err, e)
    del S64, full
    say(f"  ok {label} windows {list(windows)}: bitwise repeatable, bitwise "
        f"the full variant's column slice, max |d| {err:.3e}")
    return err, (y, beta, w, kw)


def phase_window_kernels(dev, small_nk=(1037, 29), mid_nk=(1037, 300),
                         main_nk=(250_000, 502)):
    """Phase 3 for the column window of fused_stats and
    nystrom_fused_stats: every variant at odd shapes (f32 and bf16, both
    regimes), at the one-device shapes (250,000 x 502; the year split at
    phi width 682) and at the shapes each rank of its 2 x 2 fit in phase
    11 gives it (``mesh_specs``: 125,000 x 502 for the hinge variants,
    231,864 x 92 for the SVR ones, both year blocks of 231,864 rows for
    the Nystrom ones), timed at the rank shape's second window."""
    from repro_torch.core import distributed
    from repro_torch.kernels import fused_stats, ref
    from repro_torch.kernels import nystrom_phi as nys
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(8)
    Xtr, ytr = year_split()[:2]
    rank_nk = {False: (rank_rows(250_000, 2), 502),  # alpha, pad_features=2
               True: (rank_rows(Xtr.shape[0], 2), 92)}  # year, the same
    out = {}
    for name in WIN_VARIANTS:
        for (n, k), windows in ((small_nk, ODD_WINDOWS),
                                (mid_nk, MID_WINDOWS)):
            for regime in ("well", "hinge"):
                for dtype, masked in ((f32, True), (bf16, True),
                                      (bf16, False)):
                    X, rho, beta, w, wm, kw = win_inputs(
                        dev, n, k, dtype, regime, name, g)
                    check_win(X, rho, beta, w, wm if masked else None, kw,
                              name, windows,
                              f"{name} {n}x{k} {str(dtype)[6:]} {regime}"
                              f"{' masked' if masked else ''}")
        _, epi, source = WIN_VARIANTS[name]
        svr = epi.endswith("svr")
        # as the fits call it (no Sigma weight mask): one device, then a rank
        for n, k in (main_nk, rank_nk[svr]):
            X, rho, beta, w, _, kw = win_inputs(dev, n, k, f32, "hinge",
                                                name, g)
            windows = halves(k)
            err = check_win(X, rho, beta, w, None, kw, name, windows,
                            f"{name} {n}x{k} f32")
        ck = dict(kw, eps_ins=EPS_INS if svr else 0.0)
        start, blk = windows[-1]
        t_first = time_ms(lambda: fused_stats.fused_stats(
            X, rho, beta, w, epilogue=epi, eps=EPS, col_window=windows[0],
            **ck))
        ms = time_ms(lambda: fused_stats.fused_stats(
            X, rho, beta, w, epilogue=epi, eps=EPS, col_window=(start, blk),
            **ck))
        plain = time_ms(lambda: ref.fused_stats(
            X, rho, beta, w, None, EPS, epi, col_window=(start, blk), **ck))
        n_noise = ((4 if svr else 2) * n if source == "noise" else 0)
        b_ms, by = bound(2 * n * k * blk + 4 * n * k,
                         4 * (n * k + 2 * n + k + n_noise
                              + (3 if svr else 2) * n + k + k * blk))
        out[name] = dict(shape=[n, k, start, blk], max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=by,
                         library_ms=None)
        say(f"  time {name} at window {windows[0]}: kernel "
            f"{t_first:.3f} ms")
        del X, rho, beta, w, kw

    for dtype in (f32, bf16):  # odd masked Nystrom shapes, both kinds
        for kind in ("rbf", "linear"):
            X, L, P, mask = nys_odd(dev, dtype, kind)
            y_svr = torch.randn(X.shape[0], generator=torch.Generator(
                device=dev).manual_seed(9), device=dev) * mask
            for name in NYS_WIN_VARIANTS:
                check_nys_win(dev, X, L, P, mask, 1.3, kind, name,
                              ((0, 46), (3, 5), (9, 5), (23, 23), (45, 1)),
                              f"{name} 1037x7 m=45 {str(dtype)[6:]} {kind} "
                              "masked", y_svr=y_svr)
    m = math.ceil(math.sqrt(Xtr.shape[0]))
    Ly, Py = featurizer(dev, Xtr, m, math.sqrt(90))
    s = math.sqrt(90)
    windows = halves(Py.shape[1] + 1)
    # the one-device set, then the two data shards' blocks as the ranks of
    # the 2 x 2 KRN fits hold them (the second ends in masked pad rows)
    Xp, yp, mp = distributed.pad_rows(Xtr, ytr, 2)
    nb = Xp.shape[0] // 2
    sets = [(Xtr, ytr, np.ones(Xtr.shape[0], np.float32), "one device")]
    sets += [(Xp[r * nb:(r + 1) * nb], yp[r * nb:(r + 1) * nb],
              mp[r * nb:(r + 1) * nb], f"data shard {r}") for r in (0, 1)]
    for name, (epi, source) in NYS_WIN_VARIANTS.items():
        for Xa, ya, ma, where in sets:
            X, yy, mask = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for a in (Xa, ya, ma))
            err, (y, beta, w, kw) = check_nys_win(
                dev, X, Ly, Py, mask, s, "rbf", name, windows,
                f"{name} {X.shape[0]}x90 m={m} ({where})", y_svr=yy)
        start, blk = windows[-1]
        ms = time_ms(lambda: nys.nystrom_fused_stats(
            X, Ly, Py, y, beta, w, mask, col_window=(start, blk), **kw))
        ck = {key: v for key, v in kw.items()
              if key not in ("sigma", "kind", "add_bias", "epilogue", "eps")}
        plain = time_ms(lambda: ref.nystrom_fused_stats(
            X, Ly, Py, y, beta, w, mask, s, "rbf", True, EPS, epi,
            col_window=(start, blk), **ck))
        (n, d), (mm, p) = X.shape, Py.shape
        M = p + 1
        svr = epi.endswith("svr")
        n_noise = ((4 if svr else 2) * n if source == "noise" else 0)
        b_ms, by = bound(2 * n * mm * d + 2 * n * mm * M + 2 * n * M * blk
                         + 4 * n * M,
                         4 * (n * d + mm * d + mm * p + 3 * n + n_noise
                              + (3 if svr else 2) * n + 2 * M + M * blk))
        out[name] = dict(shape=[n, d, mm, start, blk], max_abs_err=err,
                         ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
                         library_ms=None)
        del X, yy, mask, y, beta, w, kw
        torch.cuda.empty_cache()
    for name, row in out.items():
        if name.startswith(("projection[", "cross[")):
            continue
        say(f"  time {name} {row['shape']}: kernel {row['ms']:.3f} ms, "
            f"plain {row['plain_ms']:.3f} ms, library none, bound "
            f"{row['bound_ms']:.3f} ms ({row['bound_by']})")
    return out


def old_stats_plan(N, m, M, sms, D=0):
    """The Nystrom statistic's plan before the Gram engine ran it: enough
    splits a chunk for two CTAs an SM, however full the chunk's last wave
    of CTAs (at m = 1,000: 8 splits, 288 CTAs on 264 slots); its scratch
    counted as the shipped plan counts it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import nystrom_phi as nys
    nb = -(-M // _build.BK)
    ntiles = nb * (nb + 1) // 2
    splits = -(-2 * sms // ntiles)
    per_split = -(-N // splits)
    rows = min(_build.ROWS_PER_SPLIT, -(-per_split // _build.BN) * _build.BN)
    splits = max(1, min(splits,
                        nys.SCRATCH_WORDS // (rows * max(m, M, D))))
    return ntiles, rows, rows * splits


def stat_design(dev):
    """The statistics' design choices on the Gram engine, timed through
    the wrappers on the same inputs (the main path's counts are zeroed
    before it runs; nothing is asserted): each split plan the kernels
    ship (``_build.stat_plan``, ``nystrom_phi.stats_plan``) against the
    plan the staged pass ran on (``tile_plan``, ``old_stats_plan``), and
    the Nystrom phi scratch's 16-byte row stride (16-byte copies) against
    the row width M (4-byte copies)."""
    from repro_torch.kernels import _build, fused_stats
    from repro_torch.kernels import nystrom_phi as nys
    g = torch.Generator(device=dev).manual_seed(11)

    def tile_plan(N, K, C, sms):
        return _build.tile_plan(N, K, dev)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, k, C, window in ((250_000, 501, 1, None), (250_000, 501, 4, None),
                            (125_000, 502, 1, (251, 251))):
        X = torch.randn(n, k, generator=g, device=dev)
        w = torch.randn(k, C, generator=g, device=dev) / math.sqrt(k)
        w = w[:, 0].contiguous() if C == 1 else w
        y = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, -1.0,
                        1.0)
        seed = torch.tensor([1, 2, 3, 4], dtype=torch.int64, device=dev)
        kw = (dict(epilogue="mc_hinge", seed=seed) if C > 1
              else dict(col_window=window))
        ntiles, nsplits, rows = _build.stat_plan(n, k, C, sms)
        _, n_old, r_old = _build.tile_plan(n, k, dev)

        def call():
            return fused_stats.fused_stats(X, y, y, w, **kw)
        ab(f"plan fused_stats {[n, k]} C={C} window={window} "
           f"({n_old} x {r_old} rows against {nsplits} x {rows})",
           ("tile_plan", patched(call, _build, "stat_plan", tile_plan)),
           ("shipped plan", call))
        del X
    for n, d, m, epi in ((1_000_000, 2, 1000, "em_hinge"),
                         (N_YEAR_TRAIN, 90, 681, "em_svr")):
        X = torch.randn(n, d, generator=g, device=dev)
        L = X[:m].contiguous()
        P = torch.randn(m, m, generator=g, device=dev) / math.sqrt(m)
        M = m + 1
        w = torch.randn(M, generator=g, device=dev) / math.sqrt(M)
        y = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, -1.0,
                        1.0)
        beta = torch.zeros_like(y) if epi == "em_svr" else y
        mask = torch.ones(n, device=dev)

        def call():
            return nys.nystrom_fused_stats(
                X, L, P, y, beta, w, mask, sigma=math.sqrt(d),
                add_bias=True, epilogue=epi,
                eps_ins=EPS_INS if epi == "em_svr" else 0.0)
        plan, plan_old = nys.stats_plan(n, m, M, sms), old_stats_plan(
            n, m, M, sms)
        if plan != plan_old:
            ab(f"plan nystrom_fused_stats[{epi}] {[n, d, m]} (splits of "
               f"{plan_old[1]} rows, {plan_old[2] // plan_old[1]} a chunk, "
               f"against {plan[2] // plan[1]})",
               ("old_stats_plan",
                patched(call, nys, "stats_plan", old_stats_plan)),
               ("shipped plan", call))
        ab(f"phi stride nystrom_fused_stats[{epi}] {[n, d, m]} (M = {M})",
           ("rows M apart", patched(call, nys, "PHI_ALIGN", 1)),
           ("rows 16-byte aligned", call))
        del X
        torch.cuda.empty_cache()


# ------------------------------------------- MLT and the exact KRN solver
M_CLASSES = 10          # Table 8's classes (mnist8m)
LAM_T8 = 50.0           # lam_from_C(0.04), benchmarks/table8_mlt.py
LAM_T7 = 2.0            # lam_from_C(1.0), benchmarks/table7_krn.py
KRN_JITTER = 1e-4       # SVMConfig's default jitter for exact KRN
SLICE_NK = (160_000, 785)  # Table 8's training rows and width with bias


@functools.lru_cache(maxsize=None)
def mnist_split(n=200_000, k=784):
    """Table 8 at its full size (benchmarks/table8_mlt.py, full=True):
    make_mnist8m_like(200,000, 784, 10), the last 40,000 rows held out."""
    from repro_torch.data import make_mnist8m_like
    X, labels = make_mnist8m_like(n, k, M_CLASSES)
    n_te = n // 5
    return X[:-n_te], labels[:-n_te], X[-n_te:], labels[-n_te:]


def t8_cfg(options, **kw):
    """Table 8's settings (benchmarks/table8_mlt.py), ``kw`` on top."""
    from repro_torch.core import SVMConfig
    return SVMConfig.from_options(options, **{
        "num_classes": M_CLASSES, "lam": LAM_T8, "max_iters": 40,
        "min_iters": 25, "burnin": 8, **kw})


def check_krn_pad(dev, n=1795, n_all=1800):
    """fused_estep and syrk_tri on Table 7's padded Gram rows (1,795 rings
    padded to 1,800: blockdiag(K, I)), the mask in syrk_tri's weights."""
    from repro_torch.core import kernel
    from repro_torch.kernels import fused_estep, ref, syrk
    X, y = circles_data(n)
    Xd = torch.from_numpy(X).to(dev)
    G = kernel.pad_gram(kernel.gram_matrix(Xd, Xd, sigma=0.7), n_all - n)
    t = torch.zeros(n_all, device=dev)
    t[:n] = torch.from_numpy(y).to(dev)
    mask = (torch.arange(n_all, device=dev) < n).float()
    g = torch.Generator(device=dev).manual_seed(5)
    om = torch.randn(n_all, generator=g, device=dev) * 0.05 * mask
    m, gam, b = twice(lambda: fused_estep.fused_estep(G, t, t, om, eps=EPS))
    want = ref.fused_estep(G.double(), t.double(), t.double(), om.double(),
                           EPS)
    name = f"fused_estep {n_all}x{n_all} (Table 7 Gram rows, pad mask)"
    err_e = rows_close(name + " margin", m, want[0])
    gamma_close(name, gam, m, want[1], want[0])
    err_e = max(err_e, max_close(name + " b", b,
                                 stats64(G, t, t, None, gam)[0]))
    say(f"  ok {name}: bitwise repeatable, max |d| {err_e:.3e}")
    wt = mask / gam
    (S,) = twice(lambda: syrk.syrk_tri(G, wt))
    name = f"syrk_tri {n_all}x{n_all} (Table 7 Gram rows, mask / gamma)"
    err_s = max_close(name, S, ref.syrk_tri(G.double(), wt.double()))
    check(not bool(torch.any(S[n:])) and not bool(torch.any(S[:, n:])),
          f"{name}: the padded rows or columns of Sigma are not 0")
    say(f"  ok {name}: bitwise repeatable, padded rows and columns 0, max "
        f"|d| {err_s:.3e}")
    return G, t, om, wt, err_e, err_s


def gram_rows(label, G, t, om, wt, err_e, err_s):
    """Timed rows of fused_estep and syrk_tri on an (n, n) Gram."""
    from repro_torch.kernels import fused_estep, ref, syrk
    n = G.shape[0]
    ms = time_ms(lambda: fused_estep.fused_estep(G, t, t, om, eps=EPS))
    plain = time_ms(lambda: ref.fused_estep(G, t, t, om, EPS))
    mv = time_ms(lambda: (torch.mv(G, om), torch.mv(G.T, t)))
    b_ms, by = bound(4 * n * n, 4 * (n * n + 2 * n + n + 2 * n + n))
    estep = dict(shape=[n, n], max_abs_err=err_e, ms=ms, plain_ms=plain,
                 bound_ms=b_ms, bound_by=by, library_ms=None, mv_pair_ms=mv)
    srow = time_gram("syrk_tri", syrk.syrk_tri, G, wt, err_s)
    for name, row in (("fused_estep", estep), ("syrk_tri", srow)):
        say(f"  time {name} {row['shape']} ({label}): kernel "
            f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, library "
            f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 3)}"
            f" ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']})"
            + (f", torch.mv pair (X w, X^T coef; reference only) "
               f"{row['mv_pair_ms']:.3f} ms" if "mv_pair_ms" in row else ""))
    return estep, srow


def phase_slice_kernels(dev):
    """Phase 3 at the shapes phases 12-14 give the kernels: fused_stats
    (em_hinge, mc_hinge with noise operands and with the seed) at Table 8's
    160,000 x 785 in the well regime (rho != beta, as in a class pass);
    nystrom_score with C = 10 at phase 13's predict shape; fused_estep and
    syrk_tri on Table 7's padded 1,800-wide Gram rows; rbf_gram at
    (1,800 x 2)^2. Returns each kernel's extra rows by name."""
    from repro_torch.kernels import fused_stats
    from repro_torch.kernels import nystrom_phi as nys
    from repro_torch.kernels import rbf_gram, ref
    f32 = torch.float32
    out = {}
    n, k = SLICE_NK
    err, (X, rho, beta, w, _) = check_fused_stats(dev, n, k, f32, "well",
                                                  False)
    ms = time_ms(lambda: fused_stats.fused_stats(X, rho, beta, w, eps=EPS))
    plain = time_ms(lambda: ref.fused_stats(X, rho, beta, w, None, EPS))
    b_ms, by = bound(n * k * (k + 1) + 4 * n * k,
                     4 * (n * k + 2 * n + k + 2 * n + k + k * k))
    out["fused_stats"] = {"table8": dict(
        shape=[n, k], max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=by, library_ms=None)}
    del X, rho, beta, w
    for name in ("fused_stats[mc_hinge,noise]", "fused_stats[mc_hinge,seed]"):
        err, (X, rho, beta, w, kw) = check_mc(dev, n, k, f32, "well", False,
                                              name)
        ms = time_ms(lambda: fused_stats.fused_stats(
            X, rho, beta, w, epilogue="mc_hinge", eps=EPS, **kw))
        plain = time_ms(lambda: ref.fused_stats(
            X, rho, beta, w, None, EPS, "mc_hinge", **kw))
        n_noise = 2 * n if "noise" in kw else 0
        b_ms, by = bound(n * k * (k + 1) + 4 * n * k,
                         4 * (n * k + 2 * n + k + n_noise + 2 * n + k
                              + k * k))
        out[name] = {"table8": dict(shape=[n, k], max_abs_err=err, ms=ms,
                                    plain_ms=plain, bound_ms=b_ms,
                                    bound_by=by, library_ms=None)}
        del X, rho, beta, w, kw
    for name, row in out.items():
        row = row["table8"]
        say(f"  time {name} {row['shape']} (Table 8, well): kernel "
            f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
            f"{row['bound_ms']:.3f} ms ({row['bound_by']}), "
            f"{row['bound_ms'] / row['ms']:.3f} of it")

    Xtr, _, Xte, _ = mnist_split()
    L, P = featurizer(dev, Xtr, 400, 8.0)
    Xs = torch.from_numpy(Xte).to(dev)
    C = M_CLASSES
    Wc = torch.randn(P.shape[1] + 1, C, device=dev) / math.sqrt(P.shape[1])
    err = check_score(Xs, L, P, Wc, None, 8.0, "rbf",
                      f"nystrom_score {Xs.shape[0]}x784 m=400 C={C}")
    ms = time_ms(lambda: nys.nystrom_score(Xs, L, P, Wc, sigma=8.0,
                                           add_bias=True))
    plain = time_ms(lambda: ref.nystrom_score(Xs, L, P, Wc, None, 8.0,
                                              "rbf", True))
    (n, d), (m, Pw) = Xs.shape, P.shape
    Mw = Pw + 1
    b_ms, by = bound(2 * n * m * d + 2 * n * m * Mw + 2 * n * Mw * C,
                     4 * (n * d + m * d + m * Pw + Mw * C + n * C))
    out["nystrom_score"] = {"table8_c10": dict(
        shape=[n, d, m, C], max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=by, library_ms=None)}
    say(f"  time nystrom_score [{n}, {d}, {m}, {C}] (phase 13's predict): "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms "
        f"({by})")
    del Xs, L, P

    G, t, om, wt, err_e, err_s = check_krn_pad(dev)
    estep, srow = gram_rows("Table 7's padded Gram", G, t, om, wt, err_e,
                            err_s)
    out["fused_estep"] = {"table7": estep}
    out["syrk_tri"] = {"table7": srow}
    Xc = torch.from_numpy(circles_data(1800)[0]).to(dev)
    err = check_rbf(dev, Xc, Xc, 0.7, "rbf_gram 1800x1800x2 (Table 7)")
    ms = time_ms(lambda: rbf_gram.rbf_gram(Xc, Xc, sigma=0.7))
    plain = time_ms(lambda: ref.rbf_gram(Xc, Xc, 0.7))
    b_ms, by = bound(2 * 1800 * 1800 * 2, 4 * (2 * 1800 * 2 + 1800 * 1800))
    out["rbf_gram"] = {"table7": dict(shape=[1800, 1800, 2],
                                      max_abs_err=err, ms=ms, plain_ms=plain,
                                      bound_ms=b_ms, bound_by=by,
                                      library_ms=None)}
    say(f"  time rbf_gram [1800, 1800, 2] (Table 7's Gram): kernel "
        f"{ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms ({by})")
    return out


def _mlt_fit(label, cfg, dev, data, variant=None, per_step=M_CLASSES):
    """One MLT fit, the counts zeroed just before and read just after;
    ``variant`` names the fused_stats variant that must launch
    ``per_step`` times a step (a class pass each), None: the plain fit,
    which launches nothing. Returns (the model, FitResult, held-out
    accuracy, steps run, counts)."""
    Xtr, ltr, Xte, lte = data
    _zero_counts()
    svm, res, secs = _fit(cfg, dev, Xtr, ltr)
    counts = _counts()
    acc, steps = _report(label, svm, res, secs, cfg, Xte, lte, counts)
    if variant is None:
        check(all(v == 0 for v in counts.values()),
              f"{label}: the plain fit launched a kernel: {counts}")
    else:
        check(counts[variant] == per_step * steps,
              f"{label}: {variant} launched {counts[variant]} times for "
              f"{steps} steps run ({per_step} a step)")
        check(all(v == 0 for name, v in counts.items() if name != variant),
              f"{label}: launched other kernels: {counts}")
    return svm, res, acc, steps, counts


def mlt_em64(dev, A, labels, cfg, iters):
    """``iters`` MLT EM sweeps from W = 0 in float64 on the card, on the
    rows ``A`` (X with its bias column, or phi), with the solver's ridge
    and relative jitter: the yardstick of phases 12 and 13."""
    A = A.double()
    lab = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    N, K = A.shape
    M = cfg.num_classes
    onehot = torch.nn.functional.one_hot(lab, M).double()
    eye = torch.eye(K, dtype=torch.float64, device=dev)
    W = torch.zeros(M, K, dtype=torch.float64, device=dev)
    F = A @ W.T
    for _ in range(iters):
        for y in range(M):
            Aex = F + (1.0 - onehot)
            Aex[:, y] = -1e30
            rho = Aex.amax(1) - (lab != y).double()
            beta = torch.where(lab == y, 1.0, -1.0).double()
            g = (rho - A @ W[y]).abs().clamp_min(cfg.eps)
            Pm = (A / g[:, None]).T @ A + cfg.lam * eye
            Pm = 0.5 * (Pm + Pm.T)
            Pm = Pm + (cfg.jitter * torch.trace(Pm) / K) * eye
            W[y] = torch.linalg.solve(Pm, A.T @ (rho / g + beta))
            F[:, y] = A @ W[y]
    return W.cpu().numpy()


def mlt_mesh_witness(dev, data, cfg, w_mesh, w_one, iters):
    """Phase 11's MLT mesh fit beside its one-device fit: the held-out
    class scores' relative distance, and each fit's weights' distance
    from a float64 EM of the same ``iters`` sweeps on the same padded
    rows."""
    from repro_torch.data.pipeline import pad_features_to
    X, labels, Xte, _, _ = data

    def rows(A):
        return pad_features_to(np.concatenate(
            [A, np.ones((A.shape[0], 1), np.float32)], 1), cfg.pad_features)

    Ate = rows(Xte).astype(np.float64)
    srel = _rel(Ate @ np.asarray(w_mesh, np.float64).T,
                Ate @ np.asarray(w_one, np.float64).T)
    A = torch.from_numpy(rows(X)).to(dev)
    w64 = mlt_em64(dev, A, labels, cfg, iters).reshape(np.shape(w_one))
    return srel, _rel(w_mesh, w64), _rel(w_one, w64)


# kernel-name substrings -> a step's parts, for the MLT profile
MLT_PARTS = (("row pass", ("stat_rows",)),
             ("Sigma", ("stat_tiles", "tri_finalize")),
             ("Cholesky and solve", ("potrf", "getrf", "trsm", "trsv",
                                     "chol", "syrk", "getrs", "potrs")),
             ("F refresh (gemv)", ("gemv", "gemm", "dot_kernel")))
MLT_HOST_OPS = ("aten::linalg_cholesky_ex", "aten::cholesky_solve",
                "aten::linalg_solve_triangular", "aten::mv",
                "aten::index_put_", "aten::amax", "aten::where")


def profile_mlt(cfg, dev, data):
    """One Table 8 EM kernel fit under torch.profiler: the device-busy
    share, a step's device time by kernel (top 10) and by part (row pass,
    Sigma, Cholesky and solve, F refresh), and the device time of the
    host ops that launch them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    Xtr, ltr = data[:2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, res, secs = _fit(cfg, dev, Xtr, ltr)
    steps = min(cfg.max_iters, -(-res.n_iters // cfg.scan_chunk)
                * cfg.scan_chunk)
    say_profile(prof, secs, 10, f"profile of the Table 8 EM kernels fit: "
                f"{secs * 1e3:.1f} ms wall for {steps} steps")
    dev_rows, host_rows = [], {}
    for e in prof.key_averages():
        self_ms = getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0)) / 1e3
        total_ms = getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0)) / 1e3
        if e.device_type != DeviceType.CPU:
            dev_rows.append((e.key, self_ms))
        elif e.key in MLT_HOST_OPS:
            host_rows[e.key] = (total_ms, e.count)
    parts = {name: 0.0 for name, _ in MLT_PARTS}
    other = 0.0
    for key, ms in dev_rows:
        for name, subs in MLT_PARTS:
            if any(s in key for s in subs):
                parts[name] += ms
                break
        else:
            other += ms
    say(f"  a step by part (device ms a step over {steps} steps, "
        f"{M_CLASSES} class passes a step): "
        + ", ".join(f"{k} {v / steps:.3f}" for k, v in parts.items())
        + f", other {other / steps:.3f}")
    say("  a step by host op (device time of the kernels each launched, ms "
        "a step; calls): " + ", ".join(
            f"{k} {v[0] / steps:.3f} ({v[1]})" for k, v in host_rows.items()))


def phase_mlt(dev):
    """Phase 12: LIN-{EM,MC}-MLT, Table 8 at its full size."""
    data = mnist_split()
    Xtr, ltr, Xte, lte = data
    Xw, lw = Xtr[:4096], ltr[:4096]
    for backend in (None, "ref"):  # warm-up at K = 785
        _fit(t8_cfg("LIN-EM-MLT", max_iters=1, min_iters=1,
                    backend=backend), dev, Xw, lw)
    em = t8_cfg("LIN-EM-MLT")
    sk, rk, acc_k, st_k, c_k = _mlt_fit("EM kernels fit", em, dev, data,
                                        "fused_stats")
    sp, rp, acc_p, _, _ = _mlt_fit("EM plain fit", dataclasses.replace(
        em, backend="ref"), dev, data)
    orel = trace_rel(rk.objective, rp.objective)
    wrel = _rel(rk.weights, rp.weights)
    frel = _rel(sk.decision_function(Xte), sp.decision_function(Xte))
    Xb = torch.from_numpy(np.concatenate(
        [Xtr, np.ones((Xtr.shape[0], 1), np.float32)], 1)).to(dev)
    w64 = mlt_em64(dev, Xb, ltr, em, rk.n_iters).reshape(rk.weights.shape)
    del Xb
    d_k, d_p = _rel(rk.weights, w64), _rel(rp.weights, w64)
    say(f"  EM bands: iterations {rk.n_iters} vs plain {rp.n_iters} (<= 3 "
        f"apart), objective rel {orel:.3e} (<= 2e-2), accuracy kernel "
        f"{acc_k:.4f} plain {acc_p:.4f} (<= 0.01 apart); weights rel "
        f"{wrel:.3e} (band 5e-2: "
        f"{'met' if wrel <= 5e-2 else 'MISSED, see ROADMAP section 3'}), "
        f"held-out class scores rel {frel:.3e} (<= 5e-2); against a float64 "
        f"EM of {rk.n_iters} sweeps: kernel weights rel {d_k:.3e}, plain "
        f"{d_p:.3e} (kernel <= 1.25 x plain)")
    check(abs(rk.n_iters - rp.n_iters) <= 3 and orel <= 2e-2
          and abs(acc_k - acc_p) <= 0.01 and frel <= 5e-2
          and d_k <= 1.25 * d_p,
          "the EM kernel fit is outside the bands of the plain fit")
    mc = t8_cfg("LIN-MC-MLT")
    _, rh, acc_h, st_h, c_h = _mlt_fit(
        "MC kernels fit, rng='host' (Table 8)", mc, dev, data,
        "fused_stats[mc_hinge,noise]")
    plain = dataclasses.replace(mc, backend="ref")
    _, rq, acc_q, _, _ = _mlt_fit("MC plain fit, rng='host', seed 0", plain,
                                  dev, data)
    _, rq1, _, _, _ = _mlt_fit("MC plain fit, rng='host', seed 1",
                               dataclasses.replace(plain, seed=1), dev, data)
    _, rf, acc_f, st_f, c_f = _mlt_fit(
        "MC kernels fit, rng='fused'", dataclasses.replace(mc, rng="fused"),
        dev, data, "fused_stats[mc_hinge,seed]")
    spread = _rel(rq1.weights, rq.weights)
    mrel = _rel(rh.weights, rq.weights)
    say(f"  MC bands: kernel vs plain posterior-mean weights rel {mrel:.4e} "
        f"(<= 3 x the plain seed 0 vs 1 spread, {spread:.4e}); accuracy "
        f"kernel {acc_h:.4f} plain {acc_q:.4f} rng='fused' {acc_f:.4f} "
        f"(each within 0.01 of the plain fit's)")
    check(rh.converged and rq.converged and rf.converged,
          "an MC MLT fit did not converge")
    check(abs(acc_h - acc_q) <= 0.01 and abs(acc_f - acc_q) <= 0.01,
          "MC MLT accuracy outside 0.01 of the plain fit")
    check(mrel <= 3 * spread, "the MC kernel fit is outside 3x the seed "
          "spread of the plain path")
    profile_mlt(em, dev, data)
    return {"fused_stats": (c_k, rk.n_iters, st_k),
            "fused_stats[mc_hinge,noise]": (c_h, rh.n_iters, st_h),
            "fused_stats[mc_hinge,seed]": (c_f, rf.n_iters, st_f)}


def phase_krn_mlt(dev):
    """Phase 13: KRN-{EM,MC}-MLT through NystromSVM on phase 12's split,
    m = ceil(sqrt(160,000)) = 400, sigma 8.0."""
    from repro_torch.kernels import ref
    data = mnist_split()
    Xtr, ltr, Xte, lte = data
    m = math.ceil(math.sqrt(Xtr.shape[0]))
    sub = torch.from_numpy(Xtr[:2000]).to(dev).double()
    med = float(torch.median(torch.pdist(sub)))
    say(f"  sigma 8.0; the median pairwise distance of 2,000 training rows "
        f"is {med:.3f}")
    runs = {}
    for opts, name in (("KRN-EM-MLT", "fused_stats"),
                       ("KRN-MC-MLT", "fused_stats[mc_hinge,noise]")):
        cfg = t8_cfg(opts, sigma=8.0)
        ny, res, k = _nys_fit(f"kernels fit {opts}", cfg, dev, Xtr, ltr, Xte,
                              lte, m)
        if opts == "KRN-EM-MLT":
            SERVE_MODELS["KRN-EM-MLT m=400 C=10 (phase 13)"] = (ny, Xte, Xtr,
                                                                ltr)
        _, rp, p = _nys_fit(f"plain fit {opts}",
                            dataclasses.replace(cfg, backend="ref"), dev,
                            Xtr, ltr, Xte, lte, m, featurizer_of=ny)
        c, steps = k["counts"], k["steps"]
        check(c["rbf_gram"] == 1 and c["nystrom_phi"] == steps
              and c[name] == M_CLASSES * steps,
              f"{opts}: want rbf_gram 1, nystrom_phi {steps} and {name} "
              f"{M_CLASSES * steps}; launched {c}")
        check(all(v == 0 for key, v in c.items()
                  if key not in (name, "rbf_gram", "nystrom_phi")),
              f"{opts}: launched other kernels: {c}")
        check(k["pred"]["nystrom_score"] == dispatches(len(Xte)),
              f"{opts}: predict did not run nystrom_score once a dispatch")
        check(all(v == 0 for v in p["counts"].values()),
              f"{opts}: the plain fit launched a kernel")
        acc_d = abs(k["metric"] - p["metric"])
        line = (f"  bands {opts}: iterations {res.n_iters} vs plain "
                f"{rp.n_iters}, accuracy diff {acc_d:.4f} (<= 0.01), weights "
                f"rel {_rel(res.weights, rp.weights):.3e} (printed)")
        if opts == "KRN-EM-MLT":
            orel = trace_rel(res.objective, rp.objective)
            L = torch.from_numpy(ny._landmarks).to(dev).double()
            P = torch.from_numpy(ny._proj).to(dev).double()
            Xd = torch.from_numpy(Xtr).to(dev)
            phi = torch.cat([ref.nystrom_phi(Xd[c0:c0 + ROWS_A_CHECK].double(),
                                             L, P, None, 8.0, "rbf", True)
                             for c0 in range(0, Xtr.shape[0], ROWS_A_CHECK)])
            w64 = mlt_em64(dev, phi, ltr, cfg, res.n_iters).reshape(
                res.weights.shape)
            del phi, Xd
            line += (f", objective rel {orel:.3e} (<= 2e-2); against a "
                     f"float64 EM on the same featurizer: kernel weights rel "
                     f"{_rel(res.weights, w64):.3e}, plain "
                     f"{_rel(rp.weights, w64):.3e} (printed)")
            check(orel <= 2e-2, f"{opts}: objective outside 2e-2 of the "
                  "plain fit")
            runs["nystrom_phi"] = (c, res.n_iters, steps)
        say(line)
        check(acc_d <= 0.01, f"{opts}: accuracy outside 0.01 of the plain "
              "fit")
    return runs


def krn_em64(dev, X, y, cfg, iters):
    """``iters`` exact KRN EM steps from omega = 0 in float64 on the card
    (the float64 Gram, the solver's prior lam*K and relative jitter): the
    decision values f = K omega of phase 14's yardstick."""
    from repro_torch.kernels import ref
    Xd = torch.from_numpy(X).to(dev).double()
    G = ref.rbf_gram(Xd, Xd, cfg.sigma)
    t = torch.from_numpy(y).to(dev).double()
    n = G.shape[0]
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    om = torch.zeros(n, dtype=torch.float64, device=dev)
    for _ in range(iters):
        g = (t - G @ om).abs().clamp_min(cfg.eps)
        P = (G / g[:, None]).T @ G + cfg.lam * G
        P = 0.5 * (P + P.T)
        P = P + (cfg.jitter * torch.trace(P) / n) * eye
        om = torch.linalg.solve(P, G.T @ (t / g + t))
    return (G @ om).cpu().numpy()


def _factor_info(P, jitter):
    """Cholesky info (0: factored) of P plus the solver's relative ridge,
    factored in float32 (the reference's factor) and in float64 (the
    port's)."""
    n = P.shape[0]
    out = []
    for dt in (torch.float32, torch.float64):
        Q = P.to(dt)
        Q = Q + (jitter * torch.trace(Q) / n) * torch.eye(n, dtype=dt,
                                                          device=P.device)
        out.append(int(torch.linalg.cholesky_ex(Q)[1]))
        del Q
    return tuple(out)


def krn_conditioning(dev, X, y):
    """Table 7's first EM step (omega = 0, so gamma = 1 and S = K^T K):
    each float32 Sigma's 2-norm distance from float64, the lowest
    eigenvalue of P = S + lam*K beside the solver's ridge, and whether
    P factors at the default jitter in float32 and in float64, for the
    kernels and for the plain path on the card (cuBLAS)."""
    from repro_torch.core import kernel
    from repro_torch.kernels import ops
    Xd = torch.from_numpy(X).to(dev)
    G = kernel.gram_matrix(Xd, Xd, sigma=0.7)
    t = torch.from_numpy(y).to(dev)
    n = G.shape[0]
    G64 = G.double()
    S64 = G64.T @ G64
    low64 = torch.linalg.eigvalsh(S64 + LAM_T7 * G64).min().item()
    for backend in (None, "ref"):
        S = ops.fused_stats(G, t, t, torch.zeros(n, device=dev),
                            backend=backend)[-1]
        P = (S + LAM_T7 * G).double()
        P = 0.5 * (P + P.T)
        ridge = KRN_JITTER * torch.trace(P).item() / n
        i32, i64 = _factor_info(P, KRN_JITTER)
        say(f"  Table 7, step 1, {'kernels' if backend is None else 'plain'}"
            f": |S - S64|_2 {torch.linalg.matrix_norm(S.double() - S64, 2).item():.4g}"
            f", lowest eigenvalue of P {torch.linalg.eigvalsh(P).min().item():.4g}"
            f" (float64 {low64:.4g}) against the ridge {ridge:.4g}; "
            f"Cholesky info float32 {i32}, float64 {i64} (0: factored)")


def krn_factor_trace(dev, X, y, steps=20):
    """Table 7's first ``steps`` EM steps through the kernels
    (``kernel.krn_step``), past the fit's convergence: at each, whether
    that step's P = lam*K + S factors at the default ridge in float32
    (the solver's factor, as the reference's) and in float64. Printed:
    where the float64 factor fails too, the float32 Sigma has left P
    indefinite beyond the ridge."""
    from repro_torch.core import kernel
    from repro_torch.core.linear import SVMData
    from repro_torch.kernels import ops
    Xd = torch.from_numpy(X).to(dev)
    G = kernel.gram_matrix(Xd, Xd, sigma=0.7)
    t = torch.from_numpy(y).to(dev)
    n = G.shape[0]
    data = SVMData(G, t, torch.ones(n, device=dev))
    om = torch.zeros(n, device=dev)
    infos = []
    for _ in range(steps):
        S = ops.fused_stats(G, t, t, om, data.mask, None, eps=EPS)[-1]
        P = S + LAM_T7 * G
        infos.append(_factor_info(0.5 * (P + P.T), KRN_JITTER))
        om = kernel.krn_step(data, G, om, mode="EM", lam=LAM_T7, eps=EPS,
                             jitter=KRN_JITTER)[0]
        if not bool(torch.isfinite(om).all()):
            break
    say(f"  Table 7, EM steps through the kernels past the fit's "
        f"convergence (from step 0): {len(infos)} of {steps} run (the run "
        f"stops where omega is not finite); P fails the float32 factor at steps "
        f"{[i for i, (a, _) in enumerate(infos) if a]}, the float64 "
        f"factor at {[i for i, (_, b) in enumerate(infos) if b]}")


def phase_exact_krn(dev):
    """Phase 14: exact KRN-{EM,MC}-CLS, Table 7 (make_circles(1,800),
    sigma 0.7, lam_from_C(1.0), 60 iterations), then a timing point at
    make_circles(16,384). The yardstick is the plain path on the CPU: the
    plain path on the card forms S = K^T diag(w) K with cuBLAS, whose
    float32 rounding at iteration 0 leaves lam*K + S indefinite beyond
    the relative jitter's ridge, so that no factor of it exists (printed,
    ROADMAP section 3). Returns the runs, the kernels' extra rows and the EM kernel fit's
    decision values and accuracy on the training rows (phase 11's
    yardstick)."""
    from repro_torch.core import PEMSVM, SVMConfig
    X, y = circles_data(1800)
    krn_conditioning(dev, X, y)
    krn_factor_trace(dev, X, y)
    out = {}
    ref_fit = None
    for algo in ("EM", "MC"):
        cfg = SVMConfig.from_options(f"KRN-{algo}-CLS", lam=LAM_T7,
                                     sigma=0.7, max_iters=60)
        _zero_counts()
        svm, res, secs = _fit(cfg, dev, X, y)
        c = _counts()
        f = svm.decision_function(X)
        pred = _counts()
        if algo == "EM":
            SERVE_MODELS["exact KRN-EM-CLS m=1800 (phase 14)"] = (svm, X, X,
                                                                  y)
        acc = float(np.mean(np.where(f >= 0, 1, -1) == y))
        _, steps = _report(f"{cfg.options} kernels fit", svm, res, secs,
                           cfg, X, y, c)
        t0 = time.perf_counter()
        plain = PEMSVM(cfg, device="cpu")
        rp = plain.fit(X, y)
        fp = plain.decision_function(X)
        accp = plain.score(X, y)
        say(f"  {cfg.options} plain fit on the CPU: "
            f"{time.perf_counter() - t0:.3f} s, {rp.n_iters} iterations, "
            f"converged {rp.converged}, training accuracy {accp:.4f}")
        _, rc, _ = _fit(dataclasses.replace(cfg, backend="ref"), dev, X, y)
        say(f"  {cfg.options} plain fit on the card (printed): "
            f"{rc.n_iters} iterations, converged {rc.converged}, weights "
            f"finite {bool(np.all(np.isfinite(rc.weights)))}, first "
            f"objective {rc.objective[0]:.6g}")
        want = {"syrk_tri": steps, "rbf_gram": 1,
                "fused_estep": steps if algo == "EM" else 0}
        check(all(c[key] == v for key, v in want.items())
              and all(v == 0 for key, v in c.items() if key not in want),
              f"{cfg.options}: want {want}, launched {c}")
        check(pred["rbf_gram"] == 1 and pred["nystrom_score"]
              == dispatches(len(X)), f"{cfg.options}: predict did not run "
              "nystrom_score once a dispatch (and no cross-Gram): "
              f"{pred['nystrom_score']}, rbf_gram {pred['rbf_gram'] - 1}")
        line = (f"  bands {cfg.options}: training accuracy kernel {acc:.4f} "
                f"plain {accp:.4f} (>= 0.97, within 0.01), iterations "
                f"{res.n_iters} vs {rp.n_iters}")
        check(acc >= 0.97 and abs(acc - accp) <= 0.01,
              f"{cfg.options}: training accuracy {acc:.4f} (plain "
              f"{accp:.4f})")
        if algo == "EM":
            frel = _rel(f, fp)
            f64 = krn_em64(dev, X, y, cfg, res.n_iters)
            line += (f" (<= 3 apart), decision values rel {frel:.3e} "
                     f"(<= 5e-2); against a float64 EM of {res.n_iters} "
                     f"steps: kernel {_rel(f, f64):.3e}, plain "
                     f"{_rel(fp, f64):.3e} (printed)")
            check(res.converged and abs(res.n_iters - rp.n_iters) <= 3
                  and frel <= 5e-2, f"{cfg.options}: outside the EM bands")
            out["fused_estep"] = (c, res.n_iters, steps)
            ref_fit = (f, acc)
        else:
            g0, gp0 = res.aux_history["gamma_mean"][0], rp.aux_history[
                "gamma_mean"][0]
            grel = abs(g0 - gp0) / abs(gp0)
            line += (f", first gamma_mean {g0:.7g} vs {gp0:.7g} (rel "
                     f"{grel:.3e} <= 1e-5)")
            check(grel <= 1e-5, f"{cfg.options}: first gamma_mean differs")
        say(line)
    return out, krn_timing_point(dev), ref_fit


def krn_timing_point(dev, n=16_384, iters=5, timing_jitter=1e-3):
    """The exact solver at make_circles(16,384) (a 1 GiB Gram). First at
    the default jitter: step 1's P from each path's float32 Sigma, and
    whether it factors at the default ridge in float32 (the solver's
    factor, as the reference's) and in float64; then 5 EM steps, gated on
    their launch counts. Their objective is printed, not gated: the
    float32 Sigma leaves P indefinite beyond the default ridge at this
    size, and the reference's own step does the same from N = 8,192
    (tests/test_torch_krn.py::test_default_jitter_fails_like_the_
    reference; ROADMAP section 3). Then the timing run, 5 steps at
    ``timing_jitter``, where P factors: launch counts and a finite
    objective gated, the peak device memory, and a step's parts timed on
    its own inputs (syrk_tri, fused_estep, the 16,384^2 Cholesky, the
    prior matvec) beside their plain versions and bounds."""
    from repro_torch.core import SVMConfig, kernel
    from repro_torch.kernels import ops, ref
    X, y = circles_data(n, 3)
    base = SVMConfig.from_options("KRN-EM-CLS", lam=LAM_T7, sigma=0.7,
                                  max_iters=iters, min_iters=iters)
    check(base.jitter == KRN_JITTER, f"the default KRN jitter is "
          f"{base.jitter}")
    Xd = torch.from_numpy(X).to(dev)
    G = kernel.gram_matrix(Xd, Xd, sigma=0.7)
    t = torch.from_numpy(y).to(dev)
    for backend in (None, "ref"):
        S = ops.fused_stats(G, t, t, torch.zeros(n, device=dev),
                            backend=backend)[-1]
        P = S + base.lam * G
        P = 0.5 * (P + P.T)
        del S
        i32, i64 = _factor_info(P, base.jitter)
        say(f"  N = {n}, step 1, {'kernels' if backend is None else 'plain'}"
            f": Cholesky info at the ridge of jitter {base.jitter:g}: "
            f"float32 {i32}, float64 {i64} (0: factored)")
    del G, P

    def launched(label):
        c = _counts()
        check(c["fused_estep"] == iters and c["syrk_tri"] == iters
              and c["rbf_gram"] == 1 and all(
                  v == 0 for key, v in c.items()
                  if key not in ("fused_estep", "syrk_tri", "rbf_gram")),
              f"the N = {n} fit {label} launched {c}")
        return c

    _zero_counts()
    _, r0, _ = _fit(base, dev, X, y)
    launched("at the default jitter")
    say(f"  N = {n}, {iters} EM steps at the default jitter "
        f"{base.jitter:g}: objectives {[float(f'{v:.6g}') for v in r0.objective]}"
        f" (finite {bool(np.all(np.isfinite(r0.objective)))}; the finite "
        "gate is not held at this jitter: ROADMAP section 3)")
    cfg = dataclasses.replace(base, jitter=timing_jitter)
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    svm, res, secs = _fit(cfg, dev, X, y)
    mem = torch.cuda.max_memory_allocated()
    c = launched(f"at jitter {timing_jitter:g}")
    SERVE_MODELS["exact KRN-EM-CLS m=16384 (phase 14)"] = (svm, X, X, y)
    check(bool(np.all(np.isfinite(res.objective))),
          f"the N = {n} fit's objective at jitter {timing_jitter:g} is not "
          "finite")
    say(f"  N = {n}, the timing run at jitter {timing_jitter:g}: {secs:.3f} s "
        f"for {iters} EM steps ({secs / iters * 1e3:.1f} ms a step, the Gram "
        f"included), objective {res.objective[-1]:.4e}, peak device memory "
        f"{mem / 2**20:.0f} MiB, launches {c}")
    Xd = torch.from_numpy(X).to(dev)
    G = kernel.gram_matrix(Xd, Xd, sigma=0.7)
    t = torch.from_numpy(y).to(dev)
    om = torch.from_numpy(res.last_sample).to(dev)
    from repro_torch.kernels import fused_estep
    m, gam, b = fused_estep.fused_estep(G, t, t, om, eps=EPS)
    want = ref.fused_estep(G.double(), t.double(), t.double(), om.double(),
                           EPS)
    err_e = rows_close(f"fused_estep {n}x{n} margin", m, want[0])
    gamma_close(f"fused_estep {n}x{n}", gam, m, want[1], want[0])
    del want
    wt = 1.0 / gam
    from repro_torch.kernels import syrk
    S = syrk.syrk_tri(G, wt)
    err_s = max_close(f"syrk_tri {n}x{n}", S,
                      ref.syrk_tri(G.double(), wt.double()))
    estep, srow = gram_rows(f"the N = {n} Gram", G, t, om, wt, err_e, err_s)
    P = S + cfg.lam * G
    P = 0.5 * (P + P.T)
    K = G.shape[0]
    P = P + (cfg.jitter * torch.trace(P) / K) * torch.eye(K, device=dev)
    chol = time_ms(lambda: torch.linalg.cholesky_ex(P), reps=3, warmup=1)
    L = torch.linalg.cholesky_ex(P)[0]
    solve = time_ms(lambda: torch.cholesky_solve(b[:, None], L), reps=3,
                    warmup=1)
    mv = time_ms(lambda: G @ om)
    say(f"  a step at N = {n} by part (ms): syrk_tri {srow['ms']:.3f}, "
        f"fused_estep {estep['ms']:.3f}, Cholesky {chol:.3f}, cholesky_solve "
        f"{solve:.3f}, prior matvec K omega {mv:.3f}")
    return {"syrk_tri": {"n16384": srow},
            "fused_estep": {"n16384": estep}}


# ------------------------------------------------------ the stream driver
T5_N, T5_K, T5_TEST = 2_500_000, 800, 10_000  # Table 5, full=True
T5_CUT_N = 1_000_000    # N when the host has less than T5_HOST_GB free
T5_HOST_GB = 64
T5_ITERS = 20
STREAM_CHUNKS = (4096, 65_536)


def host_available_gb() -> float:
    """The host's MemAvailable in GB (1e9 bytes)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return 0.0


class Timed:
    """Records the wall time of every call of ``obj.name`` (the device
    synchronized at its end) while the block runs: a fit's set-up,
    ``PEMSVM._prepare`` (resident) or ``PageLock.__enter__`` (stream)."""

    def __init__(self, obj, name):
        self.obj, self.name, self.secs = obj, name, []

    def __enter__(self):
        self.orig = orig = getattr(self.obj, self.name)

        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            self.secs.append(time.perf_counter() - t0)
            return out
        setattr(self.obj, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.orig)


class FirstStats:
    """Records the (S, b) the stream driver's first M-step receives (the
    first pass's sums) while the block runs, by wrapping the
    ``mstep`` that ``solver._stream_fns`` builds."""

    def __enter__(self):
        from repro_torch.core import solver
        self.mod, self.orig, self.S = solver, solver._stream_fns, None
        orig = self.orig

        def fns(cfg, phi):
            out = orig(cfg, phi)
            mstep = out["mstep"]

            def first(S, b, *a):
                if self.S is None:
                    self.S, self.b = S.clone(), b.clone()
                return mstep(S, b, *a)
            return dict(out, mstep=first)
        solver._stream_fns = fns
        return self

    def __exit__(self, *exc):
        self.mod._stream_fns = self.orig


def stream_fit(label, cfg, dev, Xtr, ytr, Xte=None, yte=None, fit=None,
               passes_per_iter=1):
    """One fit (resident or stream), the launch counts zeroed just before
    and read just after. Prints fit s, ms a pass, set-up s, the copy rate
    of the passes, peak_input_bytes and the device's peak memory, host
    syncs, launches and the held-out metric; returns (model, result,
    facts)."""
    from repro_torch.core import PEMSVM
    from repro_torch.data import PageLock
    _zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Timed(PEMSVM, "_prepare") as prep, \
            Timed(PageLock, "__enter__") as lock:
        t0 = time.perf_counter()
        svm = PEMSVM(cfg, device=dev)
        res = svm.fit(Xtr, ytr) if fit is None else fit(svm)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = _counts()
    mem = torch.cuda.max_memory_allocated()
    setup = sum(prep.secs) + sum(lock.secs)
    passes = res.n_iters * passes_per_iter
    per_pass = (secs - setup) / passes
    metric = None
    if Xte is not None:
        metric = _metric(svm, cfg, Xte, yte)
    nbytes = Xtr.nbytes + 4 * len(ytr)
    launched = {k: v for k, v in counts.items() if v}
    say(f"  {label}: {secs:.3f} s, {res.n_iters} iterations, {passes} "
        f"passes, {per_pass * 1e3:.1f} ms a pass"
        + (f" ({nbytes / per_pass / 1e9:.2f} GB/s of rows)"
           if cfg.driver == "stream" else "")
        + f", set-up {setup:.3f} s, peak_input_bytes "
        f"{res.peak_input_bytes:,}, max_memory_allocated "
        f"{mem / 2**20:.0f} MiB, {res.n_host_syncs} host syncs, launches "
        f"{launched}"
        + ("" if metric is None else f", held-out {metric[0]} "
           f"{metric[1]:.4f}"))
    check(bool(np.all(np.isfinite(res.weights))), f"{label}: non-finite "
          "weights")
    if cfg.driver == "stream":
        check(res.n_host_syncs == res.n_iters, f"{label}: "
              f"{res.n_host_syncs} host syncs for {res.n_iters} iterations")
    return svm, res, dict(secs=secs, setup=setup, per_pass=per_pass,
                          counts=counts, mem=mem,
                          metric=None if metric is None else metric[1])


def chunk_bytes(rows, width):
    """One chunk's X, target and mask."""
    return rows * width * 4 + 2 * rows * 4


def stream_gates(label, cfg, res, ref, width, n_rows, w_band=5e-2,
                 t_band=2e-2):
    """The bands of a stream fit against the resident one: objective trace
    and weights; peak_input_bytes at (prefetch + 2) chunks."""
    orel = trace_rel(res.objective, ref.objective)
    wrel = _rel(res.weights, ref.weights)
    want = (cfg.prefetch + 2) * chunk_bytes(cfg.chunk_rows, width)
    say(f"  bands {label}: objective rel {orel:.3e} (<= {t_band}), weights "
        f"rel {wrel:.3e} (<= {w_band}), peak_input_bytes "
        f"{res.peak_input_bytes:,} (want {want:,}, "
        f"{res.peak_input_bytes / (n_rows * width * 4):.4f} of the resident "
        f"X)")
    check(orel <= t_band and wrel <= w_band, f"{label}: outside the bands "
          "of the resident fit")
    check(res.peak_input_bytes == want, f"{label}: peak_input_bytes "
          f"{res.peak_input_bytes} != (prefetch + 2) chunks {want}")
    return orel, wrel


def transfer_rates(dev, X, rows=65_536):
    """One pass of X's rows through the prefetcher with a trivial consumer,
    by the two copy paths of in-memory arrays: a pinned staging ring (a
    host memcpy a chunk) and the page-locked array itself (no host copy),
    in the order ring, locked, locked, ring; also one copy of the whole
    locked array. Prints GB/s."""
    from repro_torch.data import ChunkPrefetcher, DevicePlacer, PageLock
    N, D = X.shape

    def one_pass(pinned):
        def chunks():
            for i0 in range(0, N, rows):
                yield X[i0:i0 + rows], np.zeros(min(rows, N - i0),
                                                np.float32), None
        placer = DevicePlacer(dev, rows, D + 1, D, pinned_source=pinned)
        acc = torch.zeros((), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for Xc, _, _ in ChunkPrefetcher(chunks(), depth=2, place=placer):
            acc += Xc[0, 0]
        torch.cuda.synchronize()
        return X.nbytes / (time.perf_counter() - t0) / 1e9

    rates = {"ring": [], "locked": []}
    t0 = time.perf_counter()
    with PageLock(dev, X):
        lock_s = time.perf_counter() - t0
        for name in ("ring", "locked", "locked", "ring"):
            rates[name].append(one_pass(name == "locked"))
        big = torch.empty(X.shape, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        big.copy_(torch.from_numpy(X), non_blocking=True)
        torch.cuda.synchronize()
        whole = X.nbytes / (time.perf_counter() - t1) / 1e9
        del big
    say(f"  copy paths, {X.nbytes / 1e9:.2f} GB of rows in {rows:,}-row "
        f"chunks (ring, locked, locked, ring): pinned staging ring "
        f"{[round(r, 2) for r in rates['ring']]} GB/s, page-locked array "
        f"{[round(r, 2) for r in rates['locked']]} GB/s; one copy of the "
        f"whole locked array {whole:.2f} GB/s; cudaHostRegister of "
        f"{X.nbytes / 1e9:.2f} GB {lock_s:.3f} s")


def host_costs(dev, X, y, rows=4096, n=100):
    """The host work of one stream chunk, each part alone on the main
    thread (the device synchronized once at the end of each loop): the
    placer's stage and place (page-locked source, bias column and mask
    written on the card; each chunk its own slot, so no stage waits for
    an earlier chunk's copy), the chunk body with the sum, and the
    fused_stats wrapper alone. Prints ms a chunk."""
    from repro_torch.core import linear
    from repro_torch.core.solver import _add_stats
    from repro_torch.data import DevicePlacer, PageLock
    from repro_torch.kernels import fused_stats
    D = X.shape[1]
    placer = DevicePlacer(dev, rows, D + 1, D, pinned_source=True)
    out = {}
    with PageLock(dev, X[:n * rows]):
        def place():
            for i in range(n):
                sl = slice(i * rows, (i + 1) * rows)
                placer.place(placer.stage((X[sl], y[sl], None), i), i)
        data = linear.SVMData(*placer.place(placer.stage(
            (X[:rows], y[:rows], None), 0), 0))
        w = torch.zeros(D + 1, device=dev)

        def body():
            tot = None
            for _ in range(n):
                part = linear.cls_chunk_stats(data, w, None, 0, mode="EM",
                                              eps=EPS, backend=None)
                tot = part if tot is None else _add_stats(tot, part)

        def wrapper():
            for _ in range(n):
                fused_stats.fused_stats(data.X, data.target, data.target, w,
                                        eps=EPS)
        for name, fn in (("place", place), ("body", body),
                         ("fused_stats", wrapper)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) / n * 1e3
    say(f"  host work a {rows:,}-row chunk, each part alone: stage + place "
        f"{out['place']:.3f} ms, chunk body + sum {out['body']:.3f} ms (of "
        f"it the fused_stats wrapper {out['fused_stats']:.3f} ms)")
    return out


def profile_stream(label, cfg, dev, Xtr, ytr, top=8):
    """One stream fit under torch.profiler: the device's busy share, the
    kernels' and the copies' device time, and the host syncs (stream
    synchronizes, device-to-host copies) against the iterations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import PEMSVM
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = PEMSVM(cfg, device=dev).fit(Xtr, ytr)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    dev_rows, syncs, dtoh, htod = [], 0, 0, 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0)) / 1e3
        if e.device_type != DeviceType.CPU:
            if t > 0:
                dev_rows.append((t, e.count, e.key))
            if "DtoH" in e.key:
                dtoh += e.count
            if "HtoD" in e.key:
                htod += t
        elif e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            syncs += e.count
    dev_rows.sort(reverse=True)
    busy = sum(r[0] for r in dev_rows)
    kern = busy - htod - sum(r[0] for r in dev_rows if "DtoH" in r[2])
    say(f"  profile of {label}: {secs * 1e3:.1f} ms wall for "
        f"{res.n_iters} passes; device activities {busy:.1f} ms (copies "
        f"host-to-device {htod:.1f} ms, {htod / (secs * 1e3):.3f} of the "
        f"wall; kernels {kern:.1f} ms, {kern / (secs * 1e3):.3f} of the "
        f"wall); {dtoh} device-to-host copies and {syncs} stream/device "
        f"synchronizes for {res.n_iters} iterations; by self device time:")
    for ms, count, name in dev_rows[:top]:
        say(f"    {ms:9.3f} ms {count:6d}x  {name[:90]}")
    # Outside the sweeps: the final state's copy, the weights' upload, the
    # page lock's release and the timing's own synchronize.
    check(dtoh == res.n_iters + 1 and syncs <= res.n_iters + 5,
          f"{label}: {dtoh} device-to-host copies and {syncs} synchronizes "
          f"for {res.n_iters} iterations: a sweep waits for the device")


def hold_chunk_stats(label, X, y, w, out, epi, seed):
    """A fused_stats call on a stream chunk (rho = beta = y) against
    float64 on the same inputs, as phase 3 holds it: margins within 1e-5
    (1 + |m|); em_hinge gamma within the margin's difference of float64's,
    mc_hinge gamma in the band of the plain epilogue on the kernel's
    margin and the plain counter noise of the same seed words; b and
    Sigma from the kernel's gamma within 1e-5 max|ref|. Returns the
    largest |d|."""
    from repro_torch.kernels import epilogues, ref
    m, g, b, S = out
    m64 = X.double() @ w.double()
    err = rows_close(label + " margin", m, m64)
    if epi == "em_hinge":
        want = ref.fused_stats(X.double(), y.double(), y.double(),
                               w.double(), None, EPS)
        gamma_close(label, g, m, want[1], want[0])
        del want
    else:
        noise = ref.seed_noise(seed, X.shape[0], 1, epi)
        (g_plain,), _, _ = epilogues.apply_epilogue(epi, m, y, y, noise, EPS)
        gamma_band(label + " gamma", g, g_plain)
    b64, S64 = stats64(X, y, y, None, g)
    return max(err, max_close(label + " b", b, b64),
               max_close(label + " Sigma", S, S64))


def chunk_kernel_rows(dev, Xtr, n_pass, rings):
    """The statistics on the stream driver's chunks, each held against
    float64 on the same inputs (phase 3's tolerances), then timed beside
    its plain version and its bound: fused_stats em_hinge on Table 5's
    4,096- and 65,536-row chunks, fused_stats mc_hinge with counter seed
    words on a 4,096-row chunk at the row offset of the last chunk of a
    pass of ``n_pass`` rows (Table 5's: far from row 0); nystrom_fused_stats em_hinge on phase 7's first
    4,096-row chunk and on its masked tail (the 576 rows left of
    1,000,000, then 3,520 zero rows with mask 0: phi(0) != 0). Returns the
    rows by kernel."""
    from repro_torch.core import prng
    from repro_torch.kernels import fused_stats, ref, rng
    out = {}
    k = Xtr.shape[1] + 1
    row0 = (n_pass - 1) // STREAM_CHUNKS[0] * STREAM_CHUNKS[0]
    cases = [(rows, "fused_stats", "em_hinge", 0) for rows in STREAM_CHUNKS]
    cases.append((STREAM_CHUNKS[0], "fused_stats[mc_hinge,seed]",
                  "mc_hinge", row0))
    for rows, name, epi, r0 in cases:
        X = torch.from_numpy(np.concatenate(
            [Xtr[:rows], np.ones((rows, 1), np.float32)], 1)).to(dev)
        g = torch.Generator(device=dev).manual_seed(rows + r0)
        w = torch.randn(k, generator=g, device=dev) / math.sqrt(k)
        y = torch.where(torch.rand(rows, generator=g, device=dev) < 0.5,
                        -1.0, 1.0)
        seed = None
        if epi == "mc_hinge":
            seed = rng.pack_seed(prng.fold_in(prng.PRNGKey(7), 3), r0,
                                 0).to(dev)
        label = f"{name} {rows}x{k}" + (f" at row {r0:,}" if r0 else "")

        def call():
            return fused_stats.fused_stats(X, y, y, w, epilogue=epi,
                                           eps=EPS, seed=seed)
        err = hold_chunk_stats(label, X, y, w, twice(call), epi, seed)
        ms = time_ms(call)
        plain = time_ms(lambda: ref.fused_stats(X, y, y, w, None, EPS, epi,
                                                seed=seed))
        b_ms, by = bound(rows * k * (k + 1) + 4 * rows * k,
                         4 * (rows * k + 2 * rows + k + 2 * rows + k + k * k))
        key = f"chunk{rows}" + (f"_row{r0}" if r0 else "")
        out.setdefault(name, {})[key] = dict(
            shape=[rows, k], max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=b_ms, bound_by=by, library_ms=None)
        say(f"  ok {label} (a Table 5 stream chunk): max |d| {err:.3e}; "
            f"kernel {ms:.3f} ms ({b_ms / ms:.3f} of the bound {b_ms:.3f} "
            f"ms, {by}; {ms / rows * n_pass:.1f} ms a pass of "
            f"{n_pass:,} rows), plain {plain:.3f} ms")
        del X
    Xr, L, P = rings
    rows = STREAM_CHUNKS[0]
    tail = Xr.shape[0] % rows
    Xt = torch.zeros((rows, Xr.shape[1]), device=dev)
    Xt[:tail] = Xr[Xr.shape[0] - tail:]
    mt = (torch.arange(rows, device=dev) < tail).float()
    name = "nystrom_fused_stats[em_hinge]"
    out[name] = {}
    for key, X, mask in (("chunk4096", Xr[:rows].contiguous(),
                          torch.ones(rows, device=dev)),
                         (f"chunk4096_tail{tail}", Xt, mt)):
        row = time_nys_stats(dev, X, L, P, mask, 0.7, name,
                             f"{name} {key} (a phase 7 stream chunk)")
        out[name][key] = row
        say(f"  time {name} {key}: kernel {row['ms']:.3f} ms "
            f"({row['bound_ms'] / row['ms']:.3f} of the bound "
            f"{row['bound_ms']:.3f} ms, {row['bound_by']}; "
            f"{row['ms'] * 1e6 / rows:.1f} ms a pass of 1,000,000 rows), "
            f"plain {row['plain_ms']:.3f} ms")
    return out


WARM_ITERS = 8          # iterations a warm-started generation


def warm_generations(dev, cfg, Xtr, ytr, Xte, yte):
    """Warm-started stream generations on Table 5's rows at 65,536-row
    chunks: three generations of a third of the training rows each with
    window = 2 (each warm-started from the one before), then a decay =
    0.5 pair. Gates: generation 3's effective statistics are its fresh
    (S, b) plus generation 2's, bitwise (generation 1's rows expire
    exactly); one iteration of the decay pair's second generation folds
    exactly decay times the first's statistics; held-out accuracy of each
    generation within 0.01 of the resident fit's is printed."""
    from repro_torch.core import PEMSVM
    g = len(Xtr) // 3
    base = dataclasses.replace(cfg, driver="stream", chunk_rows=65_536,
                               max_iters=WARM_ITERS, min_iters=WARM_ITERS)

    parts = {}

    def gen(i, c, warm):
        # each generation's rows in an array of its own (page-locked whole
        # for the fit)
        if i not in parts:
            parts[i] = (Xtr[i * g:(i + 1) * g].copy(),
                        ytr[i * g:(i + 1) * g].copy())
        Xg, yg = parts[i]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svm = PEMSVM(c, device=dev)
        r = svm.fit(Xg, yg, warm_start=warm)
        torch.cuda.synchronize()
        return svm, r, time.perf_counter() - t0

    wcfg = dataclasses.replace(base, window=2)
    gens, prev = [], None
    for i in range(3):
        svm, r, secs = gen(i, wcfg, prev)
        acc = svm.score(Xte, yte)
        say(f"  window = 2, generation {i + 1} ({g:,} rows): {secs:.3f} s "
            f"with the page lock ({secs / r.n_iters * 1e3:.1f} ms an "
            f"iteration), {r.n_iters} "
            f"iterations, held-out accuracy {acc:.4f}, ring "
            f"{len(r.stats_window)} generation(s)")
        check(bool(np.all(np.isfinite(r.weights))), "a generation's weights "
              "are not finite")
        gens.append(r)
        prev = r
    g2, g3 = gens[1], gens[2]
    exact = all(np.array_equal(g3.stats[k], g3.stats_window[0][k]
                               + g2.stats_window[0][k]) for k in ("S", "b"))
    say(f"  generation 3's effective (S, b) bitwise its fresh plus "
        f"generation 2's fresh (generation 1 expired): {exact}")
    check(exact, "window = 2 did not expire generation 1 exactly")
    dcfg = dataclasses.replace(base, decay=0.5)
    _, d1, s1 = gen(0, dcfg, None)
    d2svm, d2, s2 = gen(1, dcfg, d1)
    one = dataclasses.replace(dcfg, max_iters=1, min_iters=1)
    zero = dataclasses.replace(d1, stats={k: np.zeros_like(v)
                                          for k, v in d1.stats.items()})
    _, a, _ = gen(1, one, d1)
    _, b, _ = gen(1, one, zero)
    folded = all(np.array_equal(a.stats[k], b.stats[k] + np.float32(0.5)
                                * d1.stats[k]) for k in ("S", "b"))
    say(f"  decay = 0.5 pair: {s1:.3f} s and {s2:.3f} s, held-out accuracy "
        f"{d2svm.score(Xte, yte):.4f}; the second generation folds exactly "
        f"fresh + 0.5 x the first's (S, b): {folded}")
    check(folded, "decay did not fold fresh + decay * the donor's stats")


def wide_chunk_rows(dev, Xw, yw, rows):
    """fused_estep and syrk_tri on a K = 2,048 stream chunk (the stream
    driver's route past FUSED_STATS_MAX_K): each held against float64 and
    timed beside its plain version, the library call (the torch.mv pair;
    torch.einsum("nk,n,nj->kj")) and its bound."""
    from repro_torch.kernels import fused_estep, ref, syrk
    X = torch.from_numpy(np.concatenate(
        [Xw[:rows], np.ones((rows, 1), np.float32)], 1)).to(dev)
    k = X.shape[1]
    t = torch.from_numpy(np.asarray(yw[:rows], np.float32)).to(dev)
    g = torch.Generator(device=dev).manual_seed(2048)
    w = torch.randn(k, generator=g, device=dev) / math.sqrt(k)
    m, gam, b = twice(lambda: fused_estep.fused_estep(X, t, t, w, eps=EPS))
    want = ref.fused_estep(X.double(), t.double(), t.double(), w.double(),
                           EPS)
    err_e = rows_close(f"fused_estep {rows}x{k} (a stream chunk)", m,
                       want[0])
    gamma_close(f"fused_estep {rows}x{k}", gam, m, want[1], want[0])
    wt = 1.0 / gam
    (S,) = twice(lambda: syrk.syrk_tri(X, wt))
    err_s = max_close(f"syrk_tri {rows}x{k} (a stream chunk)", S,
                      ref.syrk_tri(X.double(), wt.double()))
    ms = time_ms(lambda: fused_estep.fused_estep(X, t, t, w, eps=EPS))
    plain = time_ms(lambda: ref.fused_estep(X, t, t, w, EPS))
    mv = time_ms(lambda: (torch.mv(X, w), torch.mv(X.T, t)))
    b_ms, by = bound(4 * rows * k, 4 * (rows * k + 2 * rows + k + 2 * rows
                                        + k))
    estep = dict(shape=[rows, k], max_abs_err=err_e, ms=ms, plain_ms=plain,
                 bound_ms=b_ms, bound_by=by, library_ms=mv,
                 library="torch.mv pair")
    srow = time_gram("syrk_tri", syrk.syrk_tri, X, wt, err_s)
    srow["library"] = "torch.einsum"
    for name, row in (("fused_estep", estep), ("syrk_tri", srow)):
        say(f"  time {name} {row['shape']} (a K = 2,048 stream chunk): "
            f"kernel {row['ms']:.3f} ms ({row['bound_ms'] / row['ms']:.3f} "
            f"of the bound {row['bound_ms']:.3f} ms, {row['bound_by']}), "
            f"plain {row['plain_ms']:.3f} ms, {row['library']} "
            f"{row['library_ms']:.3f} ms")
    return {"fused_estep": estep, "syrk_tri": srow}


LIBSVM_ITERS = 4        # NystromSVM.fit_libsvm's iterations (a pass each)


def nystrom_fit_libsvm(dev, path, Xd, yd, m=200):
    """NystromSVM.fit_libsvm on phase 15's libsvm file with n_landmarks:
    its landmarks bitwise the host reservoir's over the same file, and its
    fit within the Nystrom bands (objective 2e-2, weights 5e-2, accuracy
    0.01) of the resident fit on the same featurizer, both run for
    LIBSVM_ITERS iterations (eps 1e-2, as the file path's LIN fit: the
    passes re-read the file, ~1 s each)."""
    from repro_torch.core import NystromSVM, SVMConfig
    from repro_torch.data import iter_libsvm, reservoir_rows
    cfg = SVMConfig.from_options("KRN-EM-CLS", lam=0.1,
                                 sigma=math.sqrt(Xd.shape[1]) / 2, eps=1e-2,
                                 driver="stream", max_iters=LIBSVM_ITERS,
                                 min_iters=LIBSVM_ITERS)
    ny = NystromSVM(cfg, n_landmarks=m, seed=3, device=dev)
    t0 = time.perf_counter()
    rs = ny.fit_libsvm(path, Xd.shape[1])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want, seen = reservoir_rows(iter_libsvm(path, cfg.chunk_rows,
                                            Xd.shape[1]), m, seed=3)
    same = np.array_equal(ny._landmarks, want)
    res = NystromSVM(dataclasses.replace(cfg, driver="scan"), n_landmarks=m,
                     device=dev)
    rr = res.fit_featurized(Xd, yd, ny._landmarks, ny._proj)
    acc, racc = ny.score(Xd, yd), res.score(Xd, yd)
    j = min(len(rs.objective), len(rr.objective))
    orel = trace_rel(rs.objective[:j], rr.objective[:j])
    wrel = _rel(rs.weights, rr.weights)
    say(f"  NystromSVM.fit_libsvm (m = {m} reservoir landmarks of {seen:,} "
        f"rows): {secs:.3f} s, {rs.n_iters} iterations (resident "
        f"{rr.n_iters}); landmarks bitwise the host reservoir's {same}; "
        f"against the resident fit on the same featurizer: objective rel "
        f"{orel:.3e} (<= 2e-2), weights rel {wrel:.3e} (<= 5e-2), accuracy "
        f"{acc:.4f} vs {racc:.4f} (within 0.01)")
    check(same and rs.n_iters == rr.n_iters and orel <= 2e-2
          and wrel <= 5e-2 and abs(acc - racc) <= 0.01,
          "NystromSVM.fit_libsvm outside the Nystrom bands or its landmarks "
          "are not the reservoir's")


def setup_ab(dev):
    """The resident set-up of phases 4-10's inputs built as the parent
    built it (bias column by np.concatenate, row padding by
    distributed.shard_rows, pageable copies) and as this tree builds it
    (``PEMSVM._prepare``: pinned staging, bias and padding on the card),
    timed in the order host, device, device, host, and held bitwise."""
    from repro_torch.core import PEMSVM, SVMConfig, distributed
    from repro_torch.data import make_alpha_like
    Xa, ya = alpha_data()
    Xy, yy, _, _ = year_split()
    Xc, yc = circles_data(1_000_000)
    Xw, yw = make_alpha_like(n=131_072, k=2047, seed=0)
    cases = (("phase 4 (and 6)", Xa[:250_000], ya[:250_000], True),
             ("phase 5", Xw, yw, True),
             ("phase 9", Xy, yy, True),
             ("phase 7", Xc, yc, False),
             ("phase 8", Xa[:250_000], ya[:250_000], False),
             ("phase 10", Xy, yy, False))
    for label, X, y, bias in cases:
        svm = PEMSVM(SVMConfig(task="SVR" if "9" in label or "10" in label
                               else "CLS", add_bias=bias), device=dev)
        target = svm._targets(y)

        def host():
            Xh = (np.concatenate([X, np.ones((len(X), 1), np.float32)], 1)
                  if bias else X)
            Xp, tp, mp = distributed.shard_rows(None, Xh, target)
            out = tuple(torch.from_numpy(a).to(dev) for a in (Xp, tp, mp))
            torch.cuda.synchronize()
            return out

        def device():
            out = svm._prepare(X, target)[0]
            torch.cuda.synchronize()
            return out

        secs = {"host": [], "device": []}
        for name, fn in (("host", host), ("device", device),
                         ("device", device), ("host", host)):
            t0 = time.perf_counter()
            out = fn()
            secs[name].append(time.perf_counter() - t0)
            if name == "host":
                want = out
            else:
                got = out
            del out
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        say(f"  set-up {label}, {X.shape[0]:,} x {X.shape[1]}"
            f"{' + bias' if bias else ''} ({X.nbytes / 1e9:.3f} GB): parent "
            f"(host assembly, pageable copies) "
            f"{[round(s * 1e3, 1) for s in secs['host']]} ms, this tree "
            f"(pinned staging, assembly on the card) "
            f"{[round(s * 1e3, 1) for s in secs['device']]} ms; bitwise "
            f"equal {same}")
        check(same, f"set-up {label}: the device-assembled matrix is not "
              "the host-assembled one")
        del got, want
        torch.cuda.empty_cache()


def phase_stream(dev):
    """Phase 15: the stream driver."""
    import shutil
    import tempfile
    from repro_torch.core import NystromSVM, PEMSVM, SVMConfig, lam_from_C
    from repro_torch.data import (iter_libsvm, make_alpha_like,
                                  make_dna_like, save_libsvm)
    from repro_torch.core import distributed
    runs, stream_rows = {}, {}
    # -- Table 5, LIN-EM-CLS (benchmarks/table5_dna.py, full=True)
    free = host_available_gb()
    n = T5_N if free >= T5_HOST_GB else T5_CUT_N
    t0 = time.perf_counter()
    X, y = make_dna_like(n, T5_K)
    Xtr, ytr, Xte, yte = X[:-T5_TEST], y[:-T5_TEST], X[-T5_TEST:], y[-T5_TEST:]
    say(f"  host MemAvailable {free:.1f} GB (>= {T5_HOST_GB} GB: full size):"
        f" make_dna_like({n:,}, {T5_K}) in {time.perf_counter() - t0:.1f} s,"
        f" {len(Xtr):,} training rows ({Xtr.nbytes / 1e9:.2f} GB), "
        f"{T5_TEST:,} held out")
    t5_rows = len(Xtr)
    lam = lam_from_C(1e-5) * n / T5_N
    cfg = SVMConfig(lam=lam, max_iters=T5_ITERS, min_iters=T5_ITERS)
    K = T5_K + 1
    third = len(Xtr) // 3
    RELIABILITY["t5"] = (Xtr[:third].copy(), ytr[:third].copy(), lam)
    _fit(dataclasses.replace(cfg, max_iters=1, min_iters=1), dev,
         Xtr[:8192], ytr[:8192])       # warm-up at K = 801
    transfer_rates(dev, Xtr)
    host_costs(dev, Xtr, ytr)
    res_svm, res, rf = stream_fit("resident (scan) fit", cfg, dev, Xtr, ytr,
                                  Xte, yte)
    # the resident first statistic, at w = 0 on the resident matrix
    from repro_torch.kernels import ops
    data, _ = res_svm._prepare(Xtr, res_svm._targets(ytr))
    w0 = torch.zeros(K, device=dev)
    _, _, bres, Sres = ops.fused_stats(data.X, data.target, data.target, w0,
                                       eps=cfg.eps)
    del data
    torch.cuda.empty_cache()
    fits = {}
    for rows in STREAM_CHUNKS:
        scfg = dataclasses.replace(cfg, driver="stream", chunk_rows=rows)
        with FirstStats() as first:
            svm, r, f = stream_fit(f"stream fit, chunk_rows {rows:,}", scfg,
                                   dev, Xtr, ytr, Xte, yte)
        fits[rows] = (svm, r, f)
        srel = float((first.S - Sres).abs().max() / Sres.abs().max())
        brel = float((first.b - bres).abs().max() / Sres.abs().max())
        say(f"  first pass (S, b) against the resident first statistic: "
            f"S {srel:.3e}, b {brel:.3e} of max|S| (<= 1e-4)")
        check(srel <= 1e-4 and brel <= 1e-4, "the stream fit's first "
              "statistic is not the resident one")
        stream_gates(f"stream {rows:,} vs resident", scfg, r, res, K,
                     len(Xtr))
        check(abs(f["metric"] - rf["metric"]) <= 0.01, "stream accuracy "
              "outside 0.01 of the resident fit's")
        check(f["counts"]["fused_stats"] == r.n_iters * -(-len(Xtr) // rows),
              f"fused_stats launched {f['counts']['fused_stats']} times")
    r4 = fits[STREAM_CHUNKS[0]][1]
    ratio = r4.peak_input_bytes / Xtr.nbytes
    say(f"  peak_input_bytes at 4,096 rows: {ratio:.5f} of the resident X "
        f"(< 1/100); at 65,536 rows "
        f"{fits[STREAM_CHUNKS[1]][1].peak_input_bytes / Xtr.nbytes:.4f}")
    check(ratio < 0.01, "peak_input_bytes at 4,096 rows not below 1/100 of "
          "the resident bytes")
    runs["fused_stats"] = fits[STREAM_CHUNKS[0]][2]["counts"]
    del fits, res_svm
    profile_stream("the 4,096-row stream fit (3 iterations)",
                   dataclasses.replace(cfg, driver="stream", max_iters=3,
                                       min_iters=3), dev, Xtr, ytr)
    # -- bitwise: prefetch depths and repeats (page-locked arrays)
    sub = slice(0, 500_000)
    ws = []
    for pf in (1, 2, 4, 2):
        scfg = dataclasses.replace(cfg, driver="stream", prefetch=pf,
                                   max_iters=3, min_iters=3)
        ws.append(PEMSVM(scfg, device=dev).fit(Xtr[sub], ytr[sub]).weights)
    same = all(np.array_equal(w, ws[0]) for w in ws[1:])
    say(f"  prefetch 1, 2, 4 and 2 again (500,000 rows, 3 iterations): "
        f"weights bitwise equal {same}")
    check(same, "stream weights differ across prefetch depths or runs")
    # -- LIN-MC-CLS rng 'fused', 5 iterations
    mc = dataclasses.replace(cfg, algorithm="MC", rng="fused", max_iters=5,
                             min_iters=5, burnin=2)
    _, rmc, fmc = stream_fit("MC resident fit, rng='fused'", mc, dev, Xtr,
                             ytr, Xte, yte)
    _, smc, fsm = stream_fit("MC stream fit, rng='fused'", dataclasses.replace(
        mc, driver="stream"), dev, Xtr, ytr, Xte, yte)
    g0, g1 = rmc.aux_history["gamma_mean"], smc.aux_history["gamma_mean"]
    grel = abs(g1[0] - g0[0]) / abs(g0[0])
    say(f"  MC gamma_mean by iteration: resident {[round(v, 6) for v in g0]},"
        f" stream {[round(v, 6) for v in g1]}; first iteration rel {grel:.3e}"
        f" (<= 1e-6); weights rel {_rel(smc.weights, rmc.weights):.3e}")
    check(grel <= 1e-6, "MC first gamma_mean differs")
    runs["fused_stats[mc_hinge,seed]"] = fsm["counts"]
    warm_generations(dev, cfg, Xtr, ytr, Xte, yte)
    del X, y, Xtr, ytr, Xte, yte
    # -- K > 1,536: phase 5's 131,072 x 2,048, 3 iterations
    Xw, yw = make_alpha_like(n=131_072, k=2047, seed=0)
    wcfg = SVMConfig(lam=lam_from_C(1.0), max_iters=3, min_iters=3)
    _, rw, _ = stream_fit("K = 2,048 resident fit", wcfg, dev, Xw, yw)
    _, sw, fw = stream_fit("K = 2,048 stream fit", dataclasses.replace(
        wcfg, driver="stream"), dev, Xw, yw)
    chunks = -(-len(Xw) // wcfg.chunk_rows)
    check(fw["counts"]["fused_estep"] == fw["counts"]["syrk_tri"]
          == 3 * chunks and fw["counts"]["fused_stats"] == 0,
          f"K = 2,048 stream: launches {fw['counts']}")
    stream_gates("K = 2,048 stream vs resident", wcfg, sw, rw,
                 Xw.shape[1] + 1, len(Xw))
    runs["fused_estep"] = runs["syrk_tri"] = fw["counts"]
    for name, row in wide_chunk_rows(dev, Xw, yw, wcfg.chunk_rows).items():
        stream_rows.setdefault(name, {})[f"chunk{wcfg.chunk_rows}"] = row
    del Xw, yw
    # -- LIN-EM-SVR (phase 9's split), 10 iterations
    Xy, yy, Xyt, yyt = year_split()
    ycfg = SVMConfig.from_options("LIN-EM-SVR", lam=lam_from_C(0.01),
                                  eps_ins=EPS_INS, max_iters=10, min_iters=10)
    _, ry, fry = stream_fit("EM-SVR resident fit", ycfg, dev, Xy, yy, Xyt,
                            yyt)
    _, sy, fsy = stream_fit("EM-SVR stream fit", dataclasses.replace(
        ycfg, driver="stream"), dev, Xy, yy, Xyt, yyt)
    stream_gates("EM-SVR stream vs resident", ycfg, sy, ry, 91, len(Xy),
                 t_band=SVR_TRACE_BAND)
    check(abs(fsy["metric"] - fry["metric"]) <= 0.01, "EM-SVR stream RMSE "
          "outside 0.01 of the resident fit's")
    runs["fused_stats[em_svr]"] = fsy["counts"]
    # -- LIN-EM-MLT (phase 12's Table 8 split), 5 iterations
    data = mnist_split()
    Xm, lm, Xmt, lmt = data
    mcfg = t8_cfg("LIN-EM-MLT", max_iters=5, min_iters=5)
    rsvm, rm, _ = stream_fit("EM-MLT resident fit", mcfg, dev, Xm, lm, Xmt,
                             lmt)
    ssvm, sm, fsm2 = stream_fit(
        "EM-MLT stream fit", dataclasses.replace(mcfg, driver="stream"), dev,
        Xm, lm, Xmt, lmt, passes_per_iter=M_CLASSES + 1)
    frel = _rel(ssvm.decision_function(Xmt), rsvm.decision_function(Xmt))
    say(f"  EM-MLT stream vs resident: held-out class scores rel {frel:.3e} "
        f"(<= 5e-2), weights rel {_rel(sm.weights, rm.weights):.3e} "
        f"(printed), objective rel {trace_rel(sm.objective, rm.objective):.3e}")
    check(frel <= 5e-2, "EM-MLT stream class scores outside 5e-2")
    check(fsm2["counts"]["fused_stats"] == 5 * M_CLASSES * -(-len(Xm) // 4096),
          f"EM-MLT stream: fused_stats launched {fsm2['counts']}")
    # -- KRN-EM-MLT through NystromSVM (phase 13's m = 400), 2 iterations:
    # nystrom_phi on every chunk of every pass
    kcfg = t8_cfg("KRN-EM-MLT", sigma=8.0, max_iters=2, min_iters=2)
    rn = NystromSVM(kcfg, n_landmarks=400, device=dev)
    rn_res = rn.fit(Xm, lm)
    _zero_counts()
    sn = NystromSVM(dataclasses.replace(kcfg, driver="stream"),
                    n_landmarks=400, device=dev)
    t0 = time.perf_counter()
    sn_res = sn.fit_featurized(Xm, lm, rn._landmarks, rn._proj)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cn = _counts()
    krel = _rel(sn.decision_function(Xmt), rn.decision_function(Xmt))
    say(f"  KRN-EM-MLT stream fit (m = 400, 2 iterations): {secs:.3f} s, "
        f"launches { {k: v for k, v in cn.items() if v} }, held-out class "
        f"scores rel {krel:.3e} of the resident fit's (<= 5e-2)")
    check(cn["nystrom_phi"] == 2 * (M_CLASSES + 1) * -(-len(Xm) // 4096),
          f"KRN-EM-MLT stream: nystrom_phi launched {cn['nystrom_phi']}")
    check(krel <= 5e-2, "KRN-EM-MLT stream class scores outside 5e-2")
    runs["nystrom_phi"] = cn
    del data, Xm, lm, Xmt, lmt, rn, sn
    # -- KRN-EM-CLS through NystromSVM, phase 7's rings, m = 1,000
    Xr, yr = circles_data(1_000_000)
    Xrt, yrt = circles_data(100_000, 1)
    ncfg = SVMConfig.from_options("KRN-EM-CLS", lam=0.1, sigma=0.7,
                                  max_iters=10, min_iters=10)
    resident = NystromSVM(ncfg, n_landmarks=1000, device=dev)
    rr = resident.fit(Xr, yr)
    racc = resident.score(Xrt, yrt)
    nys, firsts = {}, {}
    for rows in (4096, 62_500, 65_536):
        scfg = dataclasses.replace(ncfg, driver="stream", chunk_rows=rows)
        _zero_counts()
        ny = NystromSVM(scfg, n_landmarks=1000, device=dev)
        t0 = time.perf_counter()
        with FirstStats() as first:
            if rows == 4096:  # its own featurizer: the same draw and bits
                r = ny.fit(Xr, yr)
                check(np.array_equal(ny._proj, resident._proj)
                      and np.array_equal(ny._landmarks, resident._landmarks),
                      "the stream fit's featurizer is not the resident "
                      "one's")
            else:
                r = ny.fit_featurized(Xr, yr, resident._landmarks,
                                      resident._proj)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        firsts[rows] = (first.S, first.b)
        c = _counts()
        acc = ny.score(Xrt, yrt)
        pred = _counts()
        nys[rows] = r
        say(f"  KRN-EM-CLS stream fit, chunk_rows {rows:,}: {secs:.3f} s "
            f"({secs / r.n_iters * 1e3:.1f} ms a pass), held-out accuracy "
            f"{acc:.4f} (resident {racc:.4f}), peak_input_bytes "
            f"{r.peak_input_bytes:,}, {r.n_host_syncs} host syncs, launches "
            f"{ {k: v for k, v in c.items() if v} }, on predict "
            f"nystrom_score {pred['nystrom_score'] - c['nystrom_score']}")
        check(abs(acc - racc) <= 0.01, "KRN stream accuracy outside 0.01")
        check(r.n_host_syncs == r.n_iters, "KRN stream host syncs")
        check(c["nystrom_fused_stats[em_hinge]"]
              == r.n_iters * -(-len(Xr) // rows), "KRN stream launches")
        if rows == 4096:
            check(c["rbf_gram"] == 1 and pred["nystrom_score"]
                  - c["nystrom_score"] == dispatches(len(Xrt)),
                  "KRN stream: rbf_gram once a fit and nystrom_score once a "
                  "predict dispatch")
            runs["nystrom_fused_stats[em_hinge]"] = c
            runs["rbf_gram"] = c
            runs["nystrom_score"] = {"nystrom_score": pred["nystrom_score"]
                                     - c["nystrom_score"]}
    (Sa, ba), (Sb, bb) = firsts[65_536], firsts[62_500]
    scale = float(Sb.abs().max())
    srel = float((Sa - Sb).abs().max()) / scale
    brel = float((ba - bb).abs().max()) / scale
    mrel = float(np.max(np.abs(nys[65_536].weights - nys[62_500].weights))
                 / np.max(np.abs(nys[62_500].weights)))
    say(f"  masked tail (65,536 rows, a 16,960-row tail) against a divisible "
        f"chunking (62,500): first pass S {srel:.3e}, b {brel:.3e} of max|S| "
        f"(<= 1e-4); weights after {nys[62_500].n_iters} iterations rel "
        f"{mrel:.3e}; 4,096 against resident weights rel "
        f"{_rel(nys[4096].weights, rr.weights):.3e}")
    check(srel <= 1e-4 and brel <= 1e-4, "the masked tail chunking's "
          "statistic differs from a divisible one's")
    L = torch.from_numpy(resident._landmarks).to(dev)
    P = torch.from_numpy(resident._proj).to(dev)
    kernel_rows = chunk_kernel_rows(
        dev, make_dna_like(65_536, T5_K)[0], t5_rows,
        (torch.from_numpy(Xr).to(dev), L, P))
    for name, extra in stream_rows.items():
        kernel_rows.setdefault(name, {}).update(extra)
    del Xr, yr, resident, L, P
    # -- the file path: make_dna_like(20,000, 200) as libsvm text
    Xd, yd = make_dna_like(20_000, 200)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_libsvm_")
    path = os.path.join(tmp, "stream_dna.libsvm")
    save_libsvm(path, Xd, yd)
    lines = open(path).read().splitlines()
    with open(path, "w") as f:   # as tests/test_streaming.py writes it
        f.write("# generated by chip_smoke\n\n")
        for i, ln in enumerate(lines):
            f.write(ln + ("  # sv" if i % 7 == 0 else "") + "\n")
            if i % 11 == 0:
                f.write("   \n")
    t0 = time.perf_counter()
    parsed = sum(int(mc.sum()) for _, _, mc in iter_libsvm(path, 4096, 200))
    parse_s = time.perf_counter() - t0
    # the reference test's eps and iterations
    dcfg = SVMConfig(lam=lam_from_C(1e-5) * 20_000 / T5_N, eps=1e-2,
                     max_iters=12, min_iters=12)
    _, rd, _ = stream_fit("file rows, resident fit", dcfg, dev, Xd, yd)
    _, sd, fd = stream_fit(
        "fit_libsvm stream", dataclasses.replace(dcfg, driver="stream"), dev,
        Xd, yd, fit=lambda s: s.fit_libsvm(path, n_features=200))
    drel = float(np.max(np.abs(sd.weights - rd.weights))
                 / np.max(np.abs(rd.weights)))
    say(f"  libsvm parse: {parsed:,} rows in {parse_s:.3f} s "
        f"({parsed / parse_s:,.0f} rows/s) beside {fd['per_pass'] * 1e3:.1f}"
        f" ms a pass of fit_libsvm; weights rel {drel:.3e} of the resident "
        f"fit (<= 1e-3)")
    check(drel <= 1e-3, "fit_libsvm stream weights outside 1e-3")
    nystrom_fit_libsvm(dev, path, Xd, yd)
    shutil.rmtree(tmp, ignore_errors=True)
    # one loader retry, and prefetch depths on the staging ring
    Xb = np.concatenate([Xd, np.ones((len(Xd), 1), np.float32)], 1)
    Xp, tp, mp = distributed.pad_rows(Xb, yd, 1, multiple=1024)
    state = {"failed": False}

    def chunks(fail):
        def gen():
            for j, i0 in enumerate(range(0, Xp.shape[0], 1024)):
                if fail and j == 7 and not state["failed"]:
                    state["failed"] = True
                    raise IOError("transient read error")
                yield Xp[i0:i0 + 1024], tp[i0:i0 + 1024], mp[i0:i0 + 1024]
        return gen

    ccfg = dataclasses.replace(dcfg, driver="stream", chunk_rows=1024)
    ring = []
    for pf in (1, 2, 4, 2):
        ring.append(PEMSVM(dataclasses.replace(ccfg, prefetch=pf),
                           device=dev).fit_chunks(chunks(False), 201))
    flaky = PEMSVM(ccfg, device=dev).fit_chunks(chunks(True), 201)
    same = all(np.array_equal(r.weights, ring[0].weights) for r in ring[1:])
    say(f"  staging ring: prefetch 1, 2, 4 and 2 again bitwise equal {same};"
        f" one IOError mid-pass: loader_retries {flaky.loader_retries}, "
        f"backoff {flaky.loader_backoff_s:.3f} s, weights bitwise the "
        f"fault-free fit's {np.array_equal(flaky.weights, ring[1].weights)}")
    check(same and flaky.loader_retries == 1
          and np.array_equal(flaky.weights, ring[1].weights),
          "the staging ring's bitwise gates failed")
    # -- the resident set-up, parent's host assembly against this tree's
    setup_ab(dev)
    return runs, kernel_rows


# ------------------------------------------------------------ serving
SERVE_LADDER = (128, 256, 512, 1024)
SERVE_OFFSETS = (0, 1, 333)
SERVE_QUERY = 4096          # rows of each model's query set
SERVE_REQUESTS = 400        # ServeLoop requests of 1-512 rows
PAGER_TENANTS, PAGER_RESIDENT, PAGER_CALLS = 12, 8, 600


def serve_score_row(dev, name, sc, Xq, bucket=1024):
    """nystrom_score at a serving cell's shape (one bucket of the model's
    arrays): held against float64, timed beside its plain version and
    torch.mm of the projection (the bucket's cross-Gram (B, m) times proj,
    TF32 off), with its bound."""
    from repro_torch.kernels import nystrom_phi as nys, ref
    m = sc.model
    X = torch.from_numpy(np.ascontiguousarray(Xq[:bucket])).to(dev)
    L, P, W = sc._lm, sc._pj, sc._W
    kw = dict(sigma=m.phi_sigma, kind=m.phi_kind, add_bias=m.phi_add_bias)
    (s,) = twice(lambda: nys.nystrom_score(X, L, P, W, **kw))
    phi, scale = phi64_and_scale(kmat64(X, L, m.phi_sigma, m.phi_kind), P,
                                 None, m.phi_add_bias)
    err = within(f"nystrom_score {name}", s, phi @ W.double(),
                 scale @ W.double().abs())
    del phi, scale
    ms = time_ms(lambda: nys.nystrom_score(X, L, P, W, **kw))
    plain = time_ms(lambda: ref.nystrom_score(X, L, P, W, None,
                                              m.phi_sigma, m.phi_kind,
                                              m.phi_add_bias))
    K = (ref.rbf_gram(X, L, m.phi_sigma) if m.phi_kind == "rbf"
         else X @ L.T)
    lib = time_ms(lambda: torch.mm(K, P))
    del K
    (n, d), (lm, Pw), C = X.shape, P.shape, W.shape[1]
    Mw = Pw + int(m.phi_add_bias)
    b_ms, by = bound(2 * n * lm * d + 2 * n * lm * Pw + 2 * n * Mw * C,
                     4 * (n * d + lm * d + lm * Pw + Mw * C + n * C))
    say(f"  time nystrom_score [{n}, {d}, {lm}, P = {Pw}, C = {C}] "
        f"({name}): max |d| {err:.3e}; kernel {ms:.3f} ms "
        f"({b_ms / ms:.3f} of the bound {b_ms:.3f} ms, {by}), plain "
        f"{plain:.3f} ms, torch.mm of the projection {lib:.3f} ms")
    return dict(shape=[n, d, lm, Pw, C], max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=by, library_ms=None,
                projection_mm_ms=lib)


def serve_bits(name, sc, Xq, f):
    """Served scores at every bucket of the ladder (two request sizes a
    bucket) and several row offsets, against the same rows of
    decision_function (f), bitwise; then coalesced ServeLoop requests
    against the same requests served alone."""
    from repro_torch.serving import ServeLoop, WeightPager
    bad = []
    for b in SERVE_LADDER:
        for n in (b // 2 + 1, b):
            for j in SERVE_OFFSETS:
                if not np.array_equal(sc.margins(Xq[j:j + n]), f[j:j + n]):
                    bad.append((b, n, j))
    pager = WeightPager(device=sc.device)
    pager.register(dataclasses.replace(sc.model, name="m"))
    loop = ServeLoop(pager)
    tail = slice(len(Xq) // 2, len(Xq) // 2 + 100)
    for filler in (1, 127, 500, 900):
        f0 = loop.submit("m", Xq[:filler])
        f1 = loop.submit("m", Xq[tail])
        check(loop.step() == 2, f"{name}: the loop drained no pair")
        if not (np.array_equal(f0.result(), sc.score(Xq[:filler]))
                and np.array_equal(f1.result(), sc.score(Xq[tail]))):
            bad.append(("coalesced", filler))
    say(f"  {name}: served scores bitwise decision_function's at buckets "
        f"{list(SERVE_LADDER)} x offsets {list(SERVE_OFFSETS)}, and "
        f"coalesced requests bitwise served alone: {not bad}")
    check(not bad, f"{name}: served bits differ at {bad}")


def serve_dispatch_times(name, sc, Xq):
    """One dispatch's time at each bucket: device time by CUDA events
    (staging copy, cell, copy back) and the host's wall time."""
    parts = []
    for b in SERVE_LADDER:
        dev_ms = time_ms(lambda: sc.score(Xq[:b]), reps=20, warmup=3)
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            sc.score(Xq[:b])
            walls.append((time.perf_counter() - t0) * 1e3)
        parts.append(f"{b}: {dev_ms:.3f} / {statistics.median(walls):.3f}")
    say(f"  {name}: a dispatch by bucket (device ms by CUDA events / host "
        f"wall ms, median of 20): {'; '.join(parts)}")


def serve_loop_run(name, model, Xq):
    """A threaded ServeLoop under SERVE_REQUESTS requests of 1-512 rows
    (seeded), all submitted at once: p50 and p99 latency, rows/s, and each
    result bitwise the request served alone."""
    from repro_torch.serving import ServeLoop, WeightPager
    pager = WeightPager(device=model.device if hasattr(model, "device")
                        else model.svm.device)
    pager.register(model.export_servable(name="m"))
    alone = pager.scorer("m")
    rng = np.random.default_rng(16)
    spans = [(int(rng.integers(0, len(Xq) - 512)), int(rng.integers(1, 513)))
             for _ in range(SERVE_REQUESTS)]
    loop = ServeLoop(pager, max_wait_ms=1.0).start()
    t0 = time.perf_counter()
    try:
        futs = [loop.submit("m", Xq[j:j + n]) for j, n in spans]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        loop.stop()
    secs = time.perf_counter() - t0
    rows = sum(n for _, n in spans)
    q = loop.latency_quantiles()
    same = all(np.array_equal(o, alone.score(Xq[j:j + n]))
               for (j, n), o in zip(spans, outs))
    say(f"  {name}: ServeLoop, {SERVE_REQUESTS} requests of 1-512 rows "
        f"({rows:,} rows): {rows / secs:,.0f} rows/s, {loop.n_batches} "
        f"dispatches, latency p50 {q['p50_ms']:.3f} ms, p99 "
        f"{q['p99_ms']:.3f} ms; results bitwise served alone {same}")
    check(same and loop.n_requests == SERVE_REQUESTS,
          f"{name}: ServeLoop results differ from single dispatches")


def serve_pager(dev, model, Xq):
    """WeightPager with PAGER_RESIDENT resident of PAGER_TENANTS tenants
    (the model's weights scaled by a power of two a tenant), a seeded
    skewed stream of PAGER_CALLS requests: hits, misses and evictions
    against an LRU kept in the script; each tenant's scores bitwise its
    scale times the first tenant's."""
    from collections import OrderedDict
    from repro_torch.serving import WeightPager
    base = model.export_servable()
    pager = WeightPager(max_resident=PAGER_RESIDENT, device=dev)
    scale = [np.float32(2.0 ** (t % 4)) for t in range(PAGER_TENANTS)]
    for t in range(PAGER_TENANTS):
        pager.register(dataclasses.replace(
            base, name=f"t{t}", weights=base.weights * scale[t]))
    rng = np.random.default_rng(8)
    p = 1.0 / np.arange(1, PAGER_TENANTS + 1)
    names = [f"t{i}" for i in rng.choice(PAGER_TENANTS, PAGER_CALLS,
                                         p=p / p.sum())]
    lru, want = OrderedDict(), [0, 0, 0]
    first = pager.scorer("t0").score(Xq[:64])
    lru["t0"] = True
    want[1] += 1
    t0 = time.perf_counter()
    ok = True
    for nm in names:
        if nm in lru:
            want[0] += 1
            lru.move_to_end(nm)
        else:
            want[1] += 1
            lru[nm] = True
            if len(lru) > PAGER_RESIDENT:
                lru.popitem(last=False)
                want[2] += 1
        got = pager.scorer(nm).score(Xq[:64])
        ok &= np.array_equal(got, first * scale[int(nm[1:])])
    secs = time.perf_counter() - t0
    have = [pager.hits, pager.misses, pager.evictions]
    say(f"  WeightPager, {PAGER_RESIDENT} resident of {PAGER_TENANTS} "
        f"tenants ({base.family}, {base.nbytes:,} B a tenant), "
        f"{PAGER_CALLS} requests of 64 rows in {secs:.3f} s: hits "
        f"{have[0]}, misses {have[1]}, evictions {have[2]} (an LRU: "
        f"{want}), resident {pager.resident_bytes:,} B; scores scale with "
        f"the tenant's weights {ok}")
    check(have == want and list(lru) == pager.resident_names and ok,
          "the pager's counts or residency differ from an LRU's")


def serve_std(dev, name, svm, Xq, Xtr, ytr, n_post=50_000):
    """score_with_std of an MC-posterior LIN model (posterior_from the
    first n_post training rows) against a float64 Sigma oracle: S
    recomputed in float64 on the card from the E-step's own gamma at the
    fitted weights, P = S + lam I (symmetrised, the relative jitter),
    std_i = sqrt(x_i^T P^{-1} x_i) in float64. Bound: the first-order
    effect of the float32 statistic's measured error dS,
    |d std_i| <= ||P^{-1} x_i||^2 ||dS||_2 / (2 std_i), twice, plus the
    served product's 1e-5 (|x| @ |U|) row norm."""
    from repro_torch.kernels import ops
    from repro_torch.serving import SVMScorer
    cfg = svm.config
    n_post = min(n_post, len(Xtr))
    t0 = time.perf_counter()
    sm = svm.export_servable(posterior_from=(Xtr[:n_post], ytr[:n_post]))
    secs = time.perf_counter() - t0
    sc = SVMScorer(sm, device=dev)
    margin, std = sc.score_with_std(Xq)
    f = svm.decision_function(Xq)
    X = torch.from_numpy(np.concatenate(
        [Xtr[:n_post], np.ones((n_post, 1), np.float32)], 1)).to(dev)
    y = torch.from_numpy(np.asarray(ytr[:n_post], np.float32)).to(dev)
    _, gam, _, S32 = ops.fused_stats(X, y, y, svm._weights, eps=cfg.eps)
    X64 = X.double()
    S64 = (X64 * (1.0 / gam.double())[:, None]).T @ X64
    dS = float(torch.linalg.matrix_norm(S32.double() - S64, ord=2))
    K = S64.shape[0]
    eye = torch.eye(K, dtype=torch.float64, device=dev)
    P = 0.5 * ((S64 + cfg.lam * eye) + (S64 + cfg.lam * eye).T)
    P = P + (cfg.jitter * torch.trace(P) / K) * eye
    Q = torch.from_numpy(np.concatenate(
        [Xq, np.ones((len(Xq), 1), np.float32)], 1)).to(dev).double()
    sol = torch.linalg.solve(P, Q.T)                  # P^{-1} x_i
    want = torch.sqrt((Q.T * sol).sum(0)).cpu().numpy()
    first = (sol ** 2).sum(0).cpu().numpy() * dS / (2 * want)
    U = torch.from_numpy(sm.weights[:, 1:]).to(dev).double()
    prod = torch.sqrt(((Q.abs() @ U.abs()) ** 2).sum(1)).cpu().numpy()
    err = np.abs(std.astype(np.float64) - want)
    bnd = 2 * first + REL * prod
    f_err = float(np.max(np.abs(margin.astype(np.float64) - f)))
    say(f"  {name}: posterior columns from {n_post:,} rows in {secs:.3f} s "
        f"(W {sm.weights.shape}); std against the float64 Sigma oracle: "
        f"max rel {float(np.max(err / want)):.3e}, max |d| / bound "
        f"{float(np.max(err / bnd)):.3f} (<= 1; ||dS||_2 {dS:.3e}, cond(P) "
        f"{float(torch.linalg.cond(P)):.3e}); margin column against "
        f"decision_function max |d| {f_err:.3e}")
    check(bool(np.all(err <= bnd)) and bool(np.all(std > 0)),
          f"{name}: served std outside its bound of the float64 oracle")


def serve_ensemble(name, svm, Xq, res_chain_weights):
    """The multichain ensemble's std columns: std equals np.std(ddof=1) of
    the chains' margins (float64), within 1e-5 of the columns'
    (|x| @ |U|) row norm."""
    sc = svm.scorer()
    margin, std = sc.score_with_std(Xq)
    Xb = np.concatenate([Xq, np.ones((len(Xq), 1))], 1)
    want = np.std(Xb @ res_chain_weights.astype(np.float64).T, axis=1,
                  ddof=1)
    U = sc.model.weights[:, 1:].astype(np.float64)
    scale = np.sqrt(np.sum((np.abs(Xb) @ np.abs(U)) ** 2, axis=1))
    err = np.abs(std - want)
    say(f"  {name}: ensemble std (W {sc.model.weights.shape}) against "
        f"np.std(ddof=1) of the 4 chains' margins: max |d| "
        f"{float(err.max()):.3e}, max |d| / (1e-5 scale + 1e-7) "
        f"{float(np.max(err / (REL * scale + 1e-7))):.3f} (<= 1)")
    check(bool(np.all(err <= REL * scale + 1e-7)),
          f"{name}: ensemble std outside its bound")
    check(np.array_equal(margin, svm.decision_function(Xq)),
          f"{name}: the margin column is not decision_function's")


def phase_serve(dev):
    """Phase 16: the serving path on the models phases 4, 6, 8, 13 and 14
    fitted."""
    from repro_torch.core import kernel
    from repro_torch.serving import phi_never_materialized
    from repro_torch.serving.svm_serve import BUILD_COUNTS
    rows = {}
    keys = {"KRN-EM-CLS m=2048 (phase 8)": "serve_b1024_m2048",
            "KRN-EM-MLT m=400 C=10 (phase 13)": "serve_m400_c10",
            "exact KRN-EM-CLS m=1800 (phase 14)": "serve_krn_m1800",
            "exact KRN-EM-CLS m=16384 (phase 14)": "serve_krn_m16384"}
    for name in ("LIN-EM-CLS (phase 4)", *keys):
        model, Xte, Xtr, ytr = SERVE_MODELS[name]
        Xq = np.ascontiguousarray(np.concatenate(
            [Xte, Xtr])[:SERVE_QUERY], np.float32)
        sc = model.scorer()
        _zero_counts()
        f = model.decision_function(Xq)
        c = _counts()
        for b in SERVE_LADDER:          # every bucket seen once
            sc.score(Xq[:b])
        builds = sum(BUILD_COUNTS.values())
        serve_bits(name, sc, Xq, f)
        rebuilt = sum(BUILD_COUNTS.values()) - builds
        nys = sc.model.family == "nystrom"
        want = dispatches(len(Xq)) if nys else 0
        say(f"  {name}: decision_function of {len(Xq):,} rows launched "
            f"nystrom_score {c['nystrom_score']} times (one a dispatch: "
            f"{want}), other kernels "
            f"{ {k: v for k, v in c.items() if v and k != 'nystrom_score'} };"
            f" cells built at seen buckets {rebuilt}")
        check(c["nystrom_score"] == want and all(
            v == 0 for k, v in c.items() if k != "nystrom_score"),
            f"{name}: predict launched {c}")
        check(rebuilt == 0, f"{name}: a cell was rebuilt at a seen bucket")
        if nys:
            never = phi_never_materialized(sc, 1024)
            say(f"  {name}: phi_never_materialized at bucket 1,024: {never}")
            check(never, f"{name}: a (bucket, M) phi was allocated")
            rows[keys[name]] = dict(serve_score_row(dev, name, sc, Xq),
                                    predict_launches=c["nystrom_score"],
                                    predict_rows=len(Xq))
        if name.startswith("exact"):
            omega = model._weights[:model._train_X.shape[0]]
            Xd = torch.from_numpy(Xq[:2048]).to(dev)
            old = kernel.decision_function(omega, model._train_X, Xd,
                                           sigma=0.7).double()
            k64 = kmat64(Xd, model._train_X, 0.7, "rbf")
            f64 = k64 @ omega.double()
            scale = k64.abs() @ omega.double().abs()
            got = torch.from_numpy(f[:2048]).to(dev)
            e_old = within(f"{name} against cross-Gram x omega", got, old,
                           2 * scale)
            e64 = within(f"{name} against float64", got, f64, scale)
            say(f"  {name}: served margins against the cross-Gram x omega "
                f"route max |d| {e_old:.3e}, against float64 {e64:.3e} "
                f"(within 1e-5 |k| @ |omega|)")
            del k64, f64, scale, Xd, old
        serve_dispatch_times(name, sc, Xq)
    lin, Xte, Xtr, ytr = SERVE_MODELS["LIN-EM-CLS (phase 4)"]
    nys8 = SERVE_MODELS["KRN-EM-CLS m=2048 (phase 8)"][0]
    for name, model in (("LIN-EM-CLS (phase 4)", lin),
                        ("KRN-EM-CLS m=2048 (phase 8)", nys8)):
        serve_loop_run(name, model, Xte[:8192])
    serve_pager(dev, lin, Xte)
    serve_std(dev, "LIN-EM-CLS (phase 4), posterior", lin, Xte[:SERVE_QUERY],
              Xtr, ytr)
    mc, Xmc, _, _ = SERVE_MODELS["LIN-MC-CLS 4 chains (phase 6)"]
    serve_ensemble("LIN-MC-CLS 4 chains (phase 6)", mc, Xmc[:SERVE_QUERY],
                   mc._chain_weights)
    return {"nystrom_score": rows}


# ------------------------------------------------------- the mesh fits
MESH_TIMEOUT = 600  # seconds a collective may wait before the ranks fail


def _rank_setup(rank, world, init, backend):
    """A spawned rank: torch, the port on sys.path, TF32 off, the process
    group (ranks sharing a card all on cuda:0 under gloo; one card a rank
    under NCCL)."""
    global torch
    import datetime
    import torch as _torch
    torch = _torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group(
        backend, init_method=f"file://{init}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    return torch.device("cuda", torch.cuda.current_device())


def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cuda", torch.arange(
        int(np.prod(shape))).view(*shape), mesh_dim_names=("data", "k"))


def _mesh_fit(label, make, X, y, Xte, yte, cfg, live=None):
    """One fit on this rank, counts zeroed just before and read just
    after; returns its record (weights, trace, counts, time, metric)."""
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svm = make()
    res = svm.fit(X, y) if live is None else svm.fit(X, y, live=live)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    steps = min(cfg.max_iters, -(-res.n_iters // cfg.scan_chunk)
                * cfg.scan_chunk)
    # the exact KRN model's decision values on its training rows
    f = (svm.decision_function(X)
         if getattr(svm, "_train_X", None) is not None else None)
    return dict(label=label, weights=res.weights, objective=res.objective,
                n_iters=res.n_iters, converged=res.converged, steps=steps,
                secs=secs, counts=counts, metric=_metric(svm, cfg, Xte,
                                                         yte)[1], f=f)


def mesh_specs(featurizer_path):
    """The fits of the multi-rank phase: (name, mesh shape, data, config,
    launches: a variant that must run once a step, or {kernel: (a step, a
    fit)}). The first three are the main path; the short k-shard fits
    after them run each other window variant once a step; the last two
    are phase 12's LIN-EM-MLT on 2 x 2 (the window variant M times a step)
    and phase 14's exact KRN-EM-CLS on 4 x 1."""
    from repro_torch.core import SVMConfig, lam_from_C
    lin = dict(lam=lam_from_C(1.0), max_iters=100)
    short = dict(max_iters=4, min_iters=4)
    svr = dict(lam=lam_from_C(0.01), eps_ins=EPS_INS, pad_features=2,
               k_shard_axis="k", **short)
    krn = dict(lam=1.0, sigma=math.sqrt(90), eps_ins=EPS_INS, max_iters=60,
               k_shard_axis="k")
    return [
        ("LIN-EM-CLS 2x2", (2, 2), "alpha", SVMConfig.from_options(
            "LIN-EM-CLS", pad_features=2, k_shard_axis="k", **lin),
         "fused_stats[em_hinge,window]"),
        ("LIN-MC-CLS 4x1", (4, 1), "alpha", SVMConfig.from_options(
            "LIN-MC-CLS", rng="fused", **lin), "fused_stats[mc_hinge,seed]"),
        ("KRN-EM-SVR 2x2", (2, 2), "krn", SVMConfig.from_options(
            "KRN-EM-SVR", **krn), "nystrom_fused_stats[em_svr,window]"),
        ("LIN-MC-CLS 2x2 fused", (2, 2), "alpha", SVMConfig.from_options(
            "LIN-MC-CLS", rng="fused", pad_features=2, k_shard_axis="k",
            **dict(lin, **short)), "fused_stats[mc_hinge,seed,window]"),
        ("LIN-MC-CLS 2x2 host", (2, 2), "alpha", SVMConfig.from_options(
            "LIN-MC-CLS", pad_features=2, k_shard_axis="k",
            **dict(lin, **short)), "fused_stats[mc_hinge,noise,window]"),
        ("LIN-EM-SVR 2x2", (2, 2), "year", SVMConfig.from_options(
            "LIN-EM-SVR", **svr), "fused_stats[em_svr,window]"),
        ("LIN-MC-SVR 2x2 fused", (2, 2), "year", SVMConfig.from_options(
            "LIN-MC-SVR", rng="fused", **svr),
         "fused_stats[mc_svr,seed,window]"),
        ("LIN-MC-SVR 2x2 host", (2, 2), "year", SVMConfig.from_options(
            "LIN-MC-SVR", **svr), "fused_stats[mc_svr,noise,window]"),
        ("KRN-MC-SVR 2x2 fused", (2, 2), "krn", SVMConfig.from_options(
            "KRN-MC-SVR", rng="fused", **dict(krn, **short)),
         "nystrom_fused_stats[mc_svr,seed,window]"),
        ("KRN-MC-SVR 2x2 host", (2, 2), "krn", SVMConfig.from_options(
            "KRN-MC-SVR", **dict(krn, **short)),
         "nystrom_fused_stats[mc_svr,noise,window]"),
        ("KRN-EM-CLS 2x2", (2, 2), "krn_cls", SVMConfig.from_options(
            "KRN-EM-CLS", **dict(krn, **short)),
         "nystrom_fused_stats[em_hinge,window]"),
        ("KRN-MC-CLS 2x2 fused", (2, 2), "krn_cls", SVMConfig.from_options(
            "KRN-MC-CLS", rng="fused", **dict(krn, **short)),
         "nystrom_fused_stats[mc_hinge,seed,window]"),
        ("KRN-MC-CLS 2x2 host", (2, 2), "krn_cls", SVMConfig.from_options(
            "KRN-MC-CLS", **dict(krn, **short)),
         "nystrom_fused_stats[mc_hinge,noise,window]"),
        ("LIN-EM-MLT 2x2", (2, 2), "mnist40k", t8_cfg(
            "LIN-EM-MLT", pad_features=2, k_shard_axis="k", max_iters=8,
            min_iters=8), {"fused_stats[em_hinge,window]": (M_CLASSES, 0)}),
        ("KRN-EM-CLS 4x1 exact", (4, 1), "circles1800",
         SVMConfig.from_options("KRN-EM-CLS", lam=LAM_T7, sigma=0.7,
                                max_iters=60),
         {"fused_estep": (1, 0), "syrk_tri": (1, 0), "rbf_gram": (0, 1)}),
    ]


def _mesh_data(kind, featurizer_path):
    """(X, y, X held out, y held out, featurizer or None) of a mesh fit:
    the alpha-like split of phases 4 and 6, the year split of phases 9 and
    10 (KRN: phase 10's featurizer; KRN-CLS: the year rows labelled by the
    sign of their target), 40,000 of phase 12's training rows with its
    held-out rows, Table 7's rings (scored on the training rows)."""
    if kind == "mnist40k":
        Xtr, ltr, Xte, lte = mnist_split()
        return Xtr[:40_000], ltr[:40_000], Xte, lte, None
    if kind == "circles1800":
        X, y = circles_data(1800)
        return X, y, X, y, None
    if kind == "alpha":
        X, y = alpha_data()
        return X[:250_000], y[:250_000], X[250_000:], y[250_000:], None
    Xtr, ytr, Xte, yte = year_split()
    if kind == "year":
        return Xtr, ytr, Xte, yte, None
    f = np.load(featurizer_path)
    if kind == "krn_cls":
        ytr, yte = np.where(ytr >= 0, 1.0, -1.0), np.where(yte >= 0, 1.0,
                                                            -1.0)
    return Xtr, ytr, Xte, yte, (f["L"], f["P"])


def _rank_main(rank, world, init, outdir, featurizer_path):
    """One of the four gloo ranks on cuda:0: every mesh fit of
    ``mesh_specs``, its record written to ``outdir``."""
    dev = _rank_setup(rank, world, init, "gloo")
    from repro_torch.core import NystromSVM, PEMSVM
    records = []
    meshes = {}  # one mesh a shape: its process groups are made once
    for name, shape, kind, cfg, _ in mesh_specs(featurizer_path):
        mesh = meshes.setdefault(shape, _mesh(shape))
        X, y, Xte, yte, feat = _mesh_data(kind, featurizer_path)
        if feat is None:
            make = functools.partial(PEMSVM, cfg, device=dev, mesh=mesh)
        else:
            def make(cfg=cfg, mesh=mesh, feat=feat):
                ny = NystromSVM(cfg, n_landmarks=feat[0].shape[0],
                                device=dev, mesh=mesh)
                ny.fit = functools.partial(ny.fit_featurized,
                                           landmarks=feat[0], proj=feat[1])
                return ny
        records.append(_mesh_fit(name, make, X, y, Xte, yte, cfg))
    records.append(_rank_reliability(dev, meshes, outdir))
    torch.distributed.barrier()
    np.save(Path(outdir) / f"rank{rank}.npy", np.array(records, object),
            allow_pickle=True)
    torch.distributed.destroy_process_group()


def _rank_reliability(dev, meshes, outdir):
    """Phase 11's reliability fits on this rank: fit 1 (2 x 2, the
    k-sharded statistic) killed after iteration 8, resumed on 4 x 1 from
    its iteration-8 snapshot; the same 4 x 1 fit uninterrupted, and with
    ``report_slow_shard(3)`` and ``on_straggler='drop'`` while the fault
    hook holds iteration 8 for 4 s (the ranks agree on the verdict; from
    iteration 9 shard 3 is out of every reduction). Counts each rank's
    checkpoint writes."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import PEMSVM
    from repro_torch.runtime import FaultPolicy, faults
    name, shape, kind, cfg1, _ = mesh_specs(None)[0]
    X, y, Xte, yte, _ = _mesh_data(kind, None)
    cfg = dataclasses.replace(cfg1, scan_chunk=KILL_CHUNKS)
    flat = dataclasses.replace(cfg, k_shard_axis=None)
    m22, m41 = meshes[shape], meshes[(4, 1)]
    pol = FaultPolicy(ckpt_dir=str(Path(outdir) / "ckpt"),
                      ckpt_every=KILL_CHUNKS, keep_k=10)
    saves = [0]
    save = Checkpointer.save

    def counted(self, *a, **k):
        saves[0] += 1
        return save(self, *a, **k)

    Checkpointer.save = counted
    try:
        try:
            PEMSVM(dataclasses.replace(cfg, fault=pol), device=dev,
                   mesh=m22).fit(X, y, fault_hook=faults.kill_at_iteration(8))
            raise RuntimeError("phase 11: the kill did not fire")
        except faults.SimulatedPreemption:
            pass
        svm = PEMSVM(dataclasses.replace(flat, fault=pol), device=dev,
                     mesh=m41)
        res, counts, secs = _timed(lambda: svm.fit(
            X, y, resume_from=pol.ckpt_dir, resume_step=8_000_000))
        full = PEMSVM(flat, device=dev, mesh=m41).fit(X, y)
        m = PEMSVM(dataclasses.replace(flat, fault=FaultPolicy(
            on_straggler="drop", straggler_threshold=8.0,
            straggler_warmup=1)), device=dev, mesh=m41)
        m.report_slow_shard(3)
        drop, _, drop_secs = _timed(lambda: m.fit(
            X, y, fault_hook=faults.delay_iterations([8], 4.0)))
    finally:
        Checkpointer.save = save
    return dict(resumed_at=res.resumed_at, weights=res.weights,
                objective=res.objective, n_iters=res.n_iters,
                converged=res.converged, metric=svm.score(Xte, yte),
                counts=counts, secs=secs, saves=saves[0],
                full_w=full.weights, full_obj=full.objective,
                drop_w=drop.weights, drop_obj=drop.objective,
                drop_secs=drop_secs,
                drop_events=[e["it"] for e in drop.straggler_events])


def mesh_reliability(recs, one):
    """Phase 11's reliability gates over the ranks' records
    (``_rank_reliability``): every rank bitwise equal; fit 1 killed on
    2 x 2 and resumed on 4 x 1 within fit 1's bands against one device
    (``one``), ``fused_stats`` once a step of the resume; rank 0 alone
    wrote snapshots; the straggler drop at iteration 8 on every rank, the
    trace the full fit's through iteration 8 and not after."""
    r0 = recs[0]
    for r in recs[1:]:
        check(all(np.array_equal(r[k], r0[k]) for k in (
            "weights", "objective", "full_w", "drop_w", "drop_obj",
            "drop_events")), "phase 11 reliability: the ranks differ")
    steps = _scan_steps(r0["n_iters"], r0["resumed_at"], KILL_CHUNKS, 100)
    orel = trace_rel(r0["objective"], one["objective"])
    wrel = _rel(r0["weights"], one["weights"])
    launched = [r["counts"]["fused_stats"] for r in recs]
    say(f"  fit 1 killed on 2 x 2 after iteration 8, resumed on 4 x 1 at "
        f"{r0['resumed_at']}: {r0['secs']:.3f} s, {r0['n_iters']} "
        f"iterations (one device {one['n_iters']}), objective rel "
        f"{orel:.3e} (<= 2e-2), weights rel {wrel:.3e} (<= 5e-2), accuracy "
        f"{r0['metric']:.4f} (one device {one['metric']:.4f}, <= 0.01), "
        f"fused_stats a rank {launched} ({steps} steps after the resume); "
        f"snapshots written a rank {[r['saves'] for r in recs]}")
    check(r0["resumed_at"] == 8 and r0["converged"]
          and abs(r0["n_iters"] - one["n_iters"]) <= 3 and orel <= 2e-2
          and wrel <= 5e-2 and abs(r0["metric"] - one["metric"]) <= 0.01,
          "the 2 x 2 snapshot resumed on 4 x 1 left fit 1's bands")
    check(all(n == steps for n in launched), "the 4 x 1 resume's fused_stats "
          f"launches {launched}, want {steps} a rank")
    check(r0["saves"] > 0 and all(r["saves"] == 0 for r in recs[1:]),
          "a rank other than 0 wrote snapshots")
    k = 8
    same8 = r0["drop_obj"][:k] == r0["full_obj"][:k]
    after = not np.array_equal(r0["drop_w"], r0["full_w"])
    say(f"  report_slow_shard(3), on_straggler='drop', iteration 8 held 4 s: "
        f"straggler events {r0['drop_events']} on every rank, "
        f"{r0['drop_secs']:.3f} s; trace equal to the full 4 x 1 fit's "
        f"through iteration 8: {same8}, weights differ after the drop: "
        f"{after}")
    check(r0["drop_events"] == [8] and same8 and after
          and bool(np.all(np.isfinite(r0["drop_w"]))),
          "the straggler drop did not take shard 3 out at iteration 9")


def _nccl_one_rank(rank, world, init, outdir):
    """A one-rank NCCL group on the card: LIN-EM-CLS on the alpha-like set
    without a mesh and on a 1 x 1 mesh; the two must agree bitwise."""
    dev = _rank_setup(rank, world, init, "nccl")
    from repro_torch.core import PEMSVM, SVMConfig, lam_from_C
    X, y = alpha_data()
    cfg = SVMConfig.from_options("LIN-EM-CLS", lam=lam_from_C(1.0),
                                 max_iters=100)
    data = (X[:250_000], y[:250_000], X[250_000:], y[250_000:])
    one = _mesh_fit("no mesh", functools.partial(PEMSVM, cfg, device=dev),
                    *data, cfg)
    mesh = _mesh((world, 1))
    on = _mesh_fit("NCCL 1x1", functools.partial(PEMSVM, cfg, device=dev,
                                                  mesh=mesh), *data, cfg)
    np.save(Path(outdir) / f"nccl{rank}.npy", np.array([one, on], object),
            allow_pickle=True)
    torch.distributed.destroy_process_group()


def _nccl_fit1(rank, world, init, outdir, featurizer_path):
    """Fit 1 under NCCL, one rank a card: 2 x 2 on four cards, 1 x 2 on
    two or three."""
    dev = _rank_setup(rank, world, init, "nccl")
    from repro_torch.core import PEMSVM
    name, _, kind, cfg, _ = mesh_specs(featurizer_path)[0]
    X, y, Xte, yte, _ = _mesh_data(kind, featurizer_path)
    rec = _mesh_fit(f"{name[:10]} {world // 2}x2 NCCL", functools.partial(
        PEMSVM, cfg, device=dev, mesh=_mesh((world // 2, 2))), X, y, Xte,
        yte, cfg)
    np.save(Path(outdir) / f"multi{rank}.npy", np.array([rec], object),
            allow_pickle=True)
    torch.distributed.destroy_process_group()


def _spawn(fn, nprocs, prefix, *args):
    """Run ``fn(rank, nprocs, store, outdir, *args)`` in ``nprocs`` spawned
    processes; any rank's failure stops the others and fails the script.
    Returns each rank's records (its ``{prefix}{rank}.npy``); the
    directory of the file store and the records is removed."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    outdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    store = Path(outdir) / "store"
    try:
        try:
            mp.start_processes(fn, args=(nprocs, str(store), outdir, *args),
                               nprocs=nprocs, join=True,
                               start_method="spawn")
        except Exception as e:  # noqa: BLE001 (a rank's failure, re-raised)
            check(False, f"a rank of {fn.__name__} failed: {e}")
        return [list(np.load(Path(outdir) / f"{prefix}{r}.npy",
                             allow_pickle=True)) for r in range(nprocs)]
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def phase_mesh(dev, krn_ref, mc_ref, exact_ref):
    """Phase 11: the multi-device fit. Four gloo ranks on cuda:0 (one
    card is enough; NCCL refuses two ranks on one device), every kernel
    on the card at the window each rank computes; a one-rank NCCL group;
    fit 1 under NCCL, one rank a card, when two or more cards are
    visible.
    ``krn_ref`` is phase 10's KRN-EM-SVR kernel fit (its featurizer and
    result), ``mc_ref`` phase 6's rng='fused' fits and seed spread,
    ``exact_ref`` phase 14's exact KRN-EM-CLS kernel fit (decision values
    and accuracy on the training rows)."""
    import shutil
    import tempfile
    from repro_torch.core import PEMSVM
    ny, r10 = krn_ref
    tmp = tempfile.mkdtemp(prefix="chip_smoke_featurizer_")
    feat = str(Path(tmp) / "featurizer.npz")
    np.savez(feat, L=ny._landmarks, P=ny._proj)
    try:
        specs = mesh_specs(feat)
        # fit 1's one-device yardstick, the same pad_features
        _, _, kind1, cfg1, _ = specs[0]
        one = _mesh_fit("one device", functools.partial(
            PEMSVM, dataclasses.replace(cfg1, k_shard_axis=None),
            device=dev), *_mesh_data(kind1, feat)[:4], cfg1)
        # the MLT fit's one-device yardstick, the same settings
        name_m, _, kind_m, cfg_m, _ = next(
            sp for sp in specs if sp[0].startswith("LIN-EM-MLT"))
        one_mlt = _mesh_fit("one device", functools.partial(
            PEMSVM, dataclasses.replace(cfg_m, k_shard_axis=None),
            device=dev), *_mesh_data(kind_m, feat)[:4], cfg_m)
        t0 = time.perf_counter()
        ranks = _spawn(_rank_main, 4, "rank", feat)
        say(f"  4 gloo ranks on cuda:0: {time.perf_counter() - t0:.1f} s "
            "with start-up")
        runs = {}
        for j, (name, shape, kind, cfg, variant) in enumerate(specs):
            want = (variant if isinstance(variant, dict)
                    else {variant: (1, 0)})
            recs = [r[j] for r in ranks]
            for r in recs[1:]:
                check(np.array_equal(r["weights"], recs[0]["weights"])
                      and r["objective"] == recs[0]["objective"],
                      f"{name}: the ranks' weights or traces differ")
            for r in recs:
                c = r["counts"]
                for key, (a_step, a_fit) in want.items():
                    check(c[key] == a_step * r["steps"] + a_fit,
                          f"{name}: {key} launched {c[key]} times for "
                          f"{r['steps']} steps run ({a_step} a step, "
                          f"{a_fit} a fit)")
                check(all(v == 0 for key, v in c.items() if key not in want),
                      f"{name}: launched other kernels: {c}")
                check(bool(np.all(np.isfinite(r["weights"]))),
                      f"{name}: non-finite weights")
            r = recs[0]
            say(f"  {name} (4 ranks share one card): {r['secs']:.3f} s, "
                f"{r['n_iters']} iterations ({r['steps']} steps run, "
                f"{r['secs'] / r['steps'] * 1e3:.2f} ms a step), converged "
                f"{r['converged']}, held-out "
                f"{'RMSE' if cfg.task == 'SVR' else 'accuracy'} "
                f"{r['metric']:.4f}, ranks bitwise equal, launches a rank "
                f"{ {key: r['counts'][key] for key in want} }")
            if isinstance(variant, str) and variant.endswith(",window]"):
                # summed over the four ranks
                runs[variant] = ({variant: sum(x["counts"][variant]
                                               for x in recs)},
                                 r["n_iters"], r["steps"])
            if j == 0:
                orel, wrel = trace_rel(r["objective"], one["objective"]), _rel(
                    r["weights"], one["weights"])
                say(f"  bands {name} against one device (pad_features=2, "
                    f"{one['n_iters']} iterations, accuracy "
                    f"{one['metric']:.4f}): iterations {r['n_iters']}, "
                    f"objective rel {orel:.3e} (<= 2e-2), weights rel "
                    f"{wrel:.3e} (<= 5e-2), accuracy diff "
                    f"{abs(r['metric'] - one['metric']):.4f} (<= 0.01)")
                check(r["converged"]
                      and abs(r["n_iters"] - one["n_iters"]) <= 3
                      and orel <= 2e-2 and wrel <= 5e-2
                      and abs(r["metric"] - one["metric"]) <= 0.01,
                      f"{name}: outside phase 4's bands of the one-device fit")
            elif j == 1:
                rk, spread = mc_ref
                wrel = _rel(r["weights"], rk.weights)
                first = abs(r["objective"][0] - rk.objective[0]) / abs(
                    rk.objective[0])
                say(f"  bands {name} against phase 6's one-device kernel fit: "
                    f"first objective rel {first:.3e} (<= 1e-6: the same "
                    f"draws), weights rel {wrel:.4e} (<= 3 x the plain seed "
                    f"spread {spread:.4e})")
                check(r["converged"] and first <= 1e-6 and wrel <= 3 * spread,
                      f"{name}: outside phase 6's bands")
            elif j == 2:
                rmse10 = ny.rmse(*year_split()[2:])
                orel = trace_rel(r["objective"], r10.objective)
                say(f"  bands {name} against phase 10's one-device kernel fit "
                    f"(RMSE {rmse10:.4f}): iterations {r['n_iters']} vs "
                    f"{r10.n_iters}, RMSE diff "
                    f"{abs(r['metric'] - rmse10):.4f} (<= 0.01), objective "
                    f"rel {orel:.3e} (<= 2e-2), weights rel "
                    f"{_rel(r['weights'], r10.weights):.3e} (printed)")
                check(r["converged"] and abs(r["metric"] - rmse10) <= 0.01
                      and orel <= 2e-2, f"{name}: outside phase 10's bands")
            elif name == name_m:
                wrel = _rel(r["weights"], one_mlt["weights"])
                orel = trace_rel(r["objective"], one_mlt["objective"])
                srel, d_mesh, d_one = mlt_mesh_witness(
                    dev, _mesh_data(kind_m, feat), cfg_m, r["weights"],
                    one_mlt["weights"], r["n_iters"])
                say(f"  bands {name} against one device (pad_features=2, "
                    f"accuracy {one_mlt['metric']:.4f}): objective rel "
                    f"{orel:.3e} (<= 2e-2), accuracy diff "
                    f"{abs(r['metric'] - one_mlt['metric']):.4f} (<= 0.01), "
                    f"held-out class scores rel {srel:.3e} (<= 5e-2); "
                    f"against a float64 EM of {r['n_iters']} sweeps: mesh "
                    f"weights rel {d_mesh:.3e}, one device {d_one:.3e} "
                    f"(mesh <= 1.5 x one device); weights rel {wrel:.3e} "
                    f"(band 5e-2: "
                    f"{'met' if wrel <= 5e-2 else 'MISSED, see ROADMAP section 3'})")
                check(orel <= 2e-2
                      and abs(r["metric"] - one_mlt["metric"]) <= 0.01
                      and srel <= 5e-2 and d_mesh <= 1.5 * d_one,
                      f"{name}: outside the bands of the one-device fit")
            elif name.startswith("KRN-EM-CLS 4x1"):
                f14, acc14 = exact_ref
                frel = _rel(r["f"], f14)
                say(f"  bands {name} against phase 14's one-device kernel "
                    f"fit: decision values rel {frel:.3e} (<= 5e-2), "
                    f"training accuracy {r['metric']:.4f} vs {acc14:.4f} "
                    f"(<= 0.01 apart)")
                check(frel <= 5e-2 and abs(r["metric"] - acc14) <= 0.01,
                      f"{name}: outside phase 14's bands")
        mesh_reliability([r[-1] for r in ranks], one)
        one, on = _spawn(_nccl_one_rank, 1, "nccl")[0]
        check(np.array_equal(one["weights"], on["weights"])
              and one["objective"] == on["objective"],
              "the one-rank NCCL mesh fit is not bitwise the fit without a "
              "mesh")
        say(f"  one-rank NCCL group: {on['n_iters']} iterations in "
            f"{on['secs']:.3f} s, bitwise equal to the fit without a mesh "
            f"({one['secs']:.3f} s)")
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            world = 4 if n_cards >= 4 else 2
            (rec,) = _spawn(_nccl_fit1, world, "multi", feat)[0]
            say(f"  {rec['label']} on {world} cards: {rec['secs']:.3f} s, "
                f"{rec['n_iters']} iterations, accuracy {rec['metric']:.4f}")
        else:
            say(f"  no multi-card run made: {n_cards} card visible (NCCL "
                "needs one card a rank)")
        return runs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ reliability
# What phase 17 takes from earlier phases: phase 4's result ("phase4") and a
# third of Table 5's training rows with phase 15's lam ("t5").
RELIABILITY: dict = {}
KILL_CHUNKS = 4          # phase 17's scan_chunk and boundary cadence
FLEET_WATCHDOG_S = 25.0  # the subprocess host's watchdog (its first
#                          attempt never commits; the second must commit
#                          within this after its process starts: its
#                          whole fit took 8.5 s on the H100)


def smi() -> str:
    """nvidia-smi's name and power limit line, printed beside timings."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _same_fit(a, b) -> bool:
    """Bitwise equal fits: weights, last sample, trace and iterations."""
    return (np.array_equal(a.weights, b.weights)
            and np.array_equal(a.last_sample, b.last_sample)
            and a.objective == b.objective and a.n_iters == b.n_iters)


def _timed(fn):
    """(fn(), the launch counts of the call, its seconds): the counts zeroed
    just before and read just after, the device synchronized."""
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, _counts(), time.perf_counter() - t0


def _scan_steps(n_iters, start, chunk, max_iters):
    """Iterations a scan fit resumed after ``start`` runs on the card: up
    to the end of the chunk it converges in."""
    return min(max_iters, -(-n_iters // chunk) * chunk) - start


def kill_resume(label, make, fit, d, kill_hook, gate_counts):
    """Phase 17's cell: ``fit(model, **kw)`` uninterrupted, then preempted
    by ``kill_hook`` (a fault hook, or None where ``fit`` injects the fault
    itself), then resumed from directory ``d``; the resumed fit must be
    bitwise the uninterrupted one, and ``gate_counts(result, counts)``
    checks its launches. Returns (uninterrupted, resumed)."""
    from repro_torch.runtime import faults
    ref, _, s_ref = _timed(lambda: fit(make(False)))
    try:
        kw = {} if kill_hook is None else dict(fault_hook=kill_hook)
        fit(make(True), **kw)
        check(False, f"{label}: the injected fault did not fire")
    except faults.SimulatedPreemption:
        pass
    res, counts, s_res = _timed(lambda: fit(make(True), resume_from=d))
    same = _same_fit(ref, res)
    launched = {k: v for k, v in counts.items() if v}
    say(f"  {label}: uninterrupted {s_ref:.3f} s, {ref.n_iters} "
        f"iterations; resumed at {res.resumed_at} in {s_res:.3f} s, "
        f"{res.n_checkpoints} snapshots, {res.n_host_syncs} host syncs, "
        f"launches {launched}; bitwise the uninterrupted fit (weights, "
        f"last sample, objective, n_iters): {same}")
    check(same, f"{label}: the resumed fit is not bitwise the "
          "uninterrupted one")
    check(res.resumed_at is not None and res.resumed_at > 0,
          f"{label}: the fit did not resume")
    gate_counts(res, counts)
    return ref, res


def snapshot_costs(dev, d):
    """The cost of one snapshot of a K = 501 state and of the MLT (10, 785)
    state: the device-to-host copy alone, and the whole blocking save (the
    copy, the write, the fsyncs, the commit); medians of 10."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import SVMConfig, resume
    ck = Checkpointer(d, keep_k=2)
    cfg = SVMConfig()
    objs = [1.0] * 20
    for shape in ((501,), (M_CLASSES, 785)):
        w = torch.randn(shape, device=dev)
        key = torch.tensor([0, 7], dtype=torch.int64, device=dev)
        copies, saves = [], []
        for it in range(1, 11):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w.cpu()
            copies.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resume.save_snapshot(
                ck, cfg, it=it, state=w, key=key,
                samp_sum=np.zeros(shape), n_avg=0, n_small=0, objs=objs,
                aux_hist={"objective": objs}, n_syncs=it, blocking=True)
            saves.append(time.perf_counter() - t0)
        say(f"  snapshot of a {shape} float32 state: device-to-host copy "
            f"{statistics.median(copies) * 1e3:.3f} ms, blocking save "
            f"(copy, write, fsync, commit) "
            f"{statistics.median(saves) * 1e3:.3f} ms (median of 10; "
            f"{smi()})")


def checkpoint_overhead(dev, d):
    """Phase 4's fit without ``fault`` against the same fit with a snapshot
    at every host sync (ckpt_every = 1), in the order plain, ckpt, ckpt,
    plain: host syncs equal to phase 4's, weights bitwise."""
    from repro_torch.core import PEMSVM, SVMConfig, lam_from_C
    from repro_torch.runtime import FaultPolicy
    X, y = alpha_data()
    Xtr, ytr = X[:250_000], y[:250_000]
    cfg = SVMConfig.from_options("LIN-EM-CLS", lam=lam_from_C(1.0),
                                 max_iters=100)
    with_ckpt = dataclasses.replace(cfg, fault=FaultPolicy(ckpt_dir=d,
                                                           ckpt_every=1))
    runs = []
    for c in (cfg, with_ckpt, with_ckpt, cfg):
        res, _, secs = _timed(lambda c=c: PEMSVM(c, device=dev).fit(Xtr, ytr))
        runs.append((res, secs))
    p4 = RELIABILITY["phase4"]
    (r0, a), (r1, b), (r2, c), (r3, e) = runs
    say(f"  phase 4's fit without fault / with a snapshot every host sync "
        f"(plain, ckpt, ckpt, plain): {a:.3f}, {b:.3f}, {c:.3f}, {e:.3f} s; "
        f"host syncs {r0.n_host_syncs} / {r1.n_host_syncs} (phase 4: "
        f"{p4.n_host_syncs}), {r1.n_checkpoints} snapshots ({smi()})")
    check(r0.n_host_syncs == r1.n_host_syncs == p4.n_host_syncs,
          "checkpoints or this tree changed the scan driver's host syncs")
    check(all(_same_fit(r, p4) for r, _ in runs), "a fit with checkpoints "
          "is not bitwise phase 4's")


_FLEET_CHILD = """
import os, sys
import numpy as np
if os.environ["FLEET_ATTEMPT"] == "0":
    import time
    time.sleep(600)            # hung: no commits, no exit
from repro_torch.core import PEMSVM, SVMConfig, lam_from_C
from repro_torch.runtime import FaultPolicy
X, y = np.load({X!r}), np.load({y!r})
cfg = SVMConfig.from_options(
    "LIN-EM-CLS", lam=lam_from_C(1.0), max_iters=100, scan_chunk={chunk},
    fault=FaultPolicy(ckpt_dir={ckpt!r}, ckpt_every={chunk}))
r = PEMSVM(cfg).fit(X, y, resume_from=os.environ["FLEET_RESUME"] or None,
                    epoch=int(os.environ["FLEET_EPOCH"]))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                       "repro")]
np.savez({out!r}, w=r.weights, obj=np.asarray(r.objective), it=r.n_iters,
         bad=len(bad))
"""


def start_subprocess_fleet(d):
    """A FleetController over a SubprocessHost at every level, run in a
    thread: its first attempt's child hangs without committing and is
    SIGTERMed by the watchdog; the second fits phase 4's model on the card
    with the port alone. Returns (thread, box)."""
    import threading
    from repro_torch.runtime import (FleetController, FleetPolicy,
                                     SubprocessHost)
    X, y = alpha_data()
    os.makedirs(d)
    paths = {k: str(Path(d) / f"{k}.npy") for k in ("X", "y")}
    np.save(paths["X"], X[:250_000])
    np.save(paths["y"], y[:250_000])
    out = str(Path(d) / "out.npz")
    code = _FLEET_CHILD.format(chunk=KILL_CHUNKS, ckpt=str(Path(d) / "ckpt"),
                               out=out, **paths)
    fc = FleetController(
        lambda level: SubprocessHost(code, load_result=lambda: dict(
            np.load(out)), grace_s=5.0, poll_s=0.1),
        str(Path(d) / "ckpt"),
        policy=FleetPolicy(max_attempts=3, backoff_s=0.0,
                           watchdog_s=FLEET_WATCHDOG_S, poll_s=0.1,
                           kill_grace_s=5.0))
    box: dict = {}

    def run():
        try:
            box["fr"] = fc.run()
        except Exception as e:  # noqa: BLE001 (read and gated by the caller)
            box["error"] = e

    th = threading.Thread(target=run, daemon=True, name="subprocess-fleet")
    th.start()
    return th, box


def phase_reliability(dev):
    """Phase 17: checkpoint, kill and resume on the card (see the module
    docstring)."""
    import shutil
    import tempfile
    from repro_torch.core import NystromSVM, PEMSVM, SVMConfig, lam_from_C
    from repro_torch.runtime import (FaultPolicy, FleetController,
                                     FleetPolicy, FleetSchedule,
                                     StragglerError, faults)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    dirs = iter(str(tmp / f"c{i}") for i in range(100))
    ch = KILL_CHUNKS
    try:
        snapshot_costs(dev, next(dirs))
        checkpoint_overhead(dev, next(dirs))
        sub_dir = next(dirs)
        sub_thread, sub_box = start_subprocess_fleet(sub_dir)

        # -- phase 4's and 6's models, scan driver, killed after iteration 8
        X, y = alpha_data()
        Xtr, ytr, Xte, yte = X[:250_000], y[:250_000], X[250_000:], \
            y[250_000:]
        base = SVMConfig.from_options("LIN-EM-CLS", lam=lam_from_C(1.0),
                                      max_iters=100, scan_chunk=ch)
        refs = {}
        for label, cfg, key in (
                ("LIN-EM-CLS (phase 4)", base, "fused_stats"),
                ("LIN-MC-CLS rng='fused' (phase 6)", dataclasses.replace(
                    base, algorithm="MC", rng="fused"),
                 "fused_stats[mc_hinge,seed]"),
                ("LIN-MC-CLS rng='host' (phase 6)", dataclasses.replace(
                    base, algorithm="MC"), "fused_stats[mc_hinge,noise]")):
            d = next(dirs)
            pol = FaultPolicy(ckpt_dir=d, ckpt_every=ch)

            def gate(res, counts, cfg=cfg, key=key, label=label):
                want = _scan_steps(res.n_iters, res.resumed_at, ch,
                                   cfg.max_iters)
                say(f"    {key} launched {counts[key]} times on the resume, "
                    f"n_iters - resumed_at = {res.n_iters - res.resumed_at}, "
                    f"iterations run to the end of the converging chunk "
                    f"{want}")
                check(res.resumed_at == 8 and counts[key] == want
                      and all(v == 0 for k, v in counts.items()
                              if k != key),
                      f"{label}: resumed at {res.resumed_at}, launches "
                      f"{counts}")

            refs[label], _ = kill_resume(
                label, lambda f, cfg=cfg, pol=pol: PEMSVM(
                    dataclasses.replace(cfg, fault=pol) if f else cfg,
                    device=dev),
                lambda m, **kw: m.fit(Xtr, ytr, **kw), d,
                faults.kill_at_iteration(8), gate)
        ref4 = refs["LIN-EM-CLS (phase 4)"]

        # -- the stream driver on a third of Table 5, killed mid-pass
        X3, y3, lam = RELIABILITY.pop("t5")
        rows = STREAM_CHUNKS[1]
        n3 = len(X3)
        n_chunks = -(-n3 // rows)
        Xb = np.zeros((n_chunks * rows, X3.shape[1] + 1), np.float32)
        Xb[:n3, :-1] = X3
        Xb[:n3, -1] = 1.0
        yb = np.zeros(n_chunks * rows, np.float32)
        yb[:n3] = y3
        mb = np.zeros(n_chunks * rows, np.float32)
        mb[:n3] = 1.0

        def make_chunks():
            for i0 in range(0, len(Xb), rows):
                yield Xb[i0:i0 + rows], yb[i0:i0 + rows], mb[i0:i0 + rows]

        iters = 6
        scfg = SVMConfig(lam=lam, driver="stream", chunk_rows=rows,
                         max_iters=iters, min_iters=iters)
        d = next(dirs)
        spol = FaultPolicy(ckpt_dir=d, ckpt_every=2, ckpt_chunks=4,
                           keep_k=50)
        kill_at = 2 * n_chunks + 6      # 6 chunks into the third pass
        left = (n_chunks - 4) + (iters - 3) * n_chunks

        def gate_stream(res, counts):
            check(res.resumed_at == 2 and counts["fused_stats"] == left
                  and res.n_host_syncs == iters,
                  f"stream: resumed at {res.resumed_at} (want 2, the third "
                  f"pass's snapshot after 4 chunks), fused_stats "
                  f"{counts['fused_stats']} (want {left}), host syncs "
                  f"{res.n_host_syncs}")

        def stream_fit(m, fault_hook=None, resume_from=None):
            src = make_chunks
            if m.config.fault is not None and resume_from is None:
                src = faults.kill_after_chunks(make_chunks, kill_at)
            return m.fit_chunks(src, Xb.shape[1], resume_from=resume_from)

        say(f"  a third of Table 5: {n3:,} x {X3.shape[1] + 1} in "
            f"{n_chunks} chunks of {rows:,} rows, {iters} iterations, a "
            f"snapshot every 4 chunks and every 2 iterations; killed after "
            f"chunk {kill_at}")
        sref, _ = kill_resume(
            "stream, fit_chunks", lambda f: PEMSVM(
                dataclasses.replace(scfg, fault=spol) if f else scfg,
                device=dev), stream_fit, d, None, gate_stream)
        # its boundary snapshot of iteration 2, resumed into driver="scan"
        rcfg = dataclasses.replace(scfg, driver="scan")
        resident, _, s_res = _timed(
            lambda: PEMSVM(rcfg, device=dev).fit(X3, y3))
        cross, _, s_x = _timed(lambda: PEMSVM(rcfg, device=dev).fit(
            X3, y3, resume_from=d, resume_step=2_000_000))
        layout = _rel_max(sref.weights, resident.weights)
        wrel = _rel_max(cross.weights, resident.weights)
        band = max(1e-4, 2 * layout)
        nrel = _rel(cross.weights, resident.weights)
        say(f"  stream snapshot of iteration 2 resumed into driver='scan' "
            f"({s_x:.3f} s; the resident fit {s_res:.3f} s): weights "
            f"{wrel:.3e} of max|w| from the resident fit (band: "
            f"tests/test_torch_stream.py's 1e-4, or twice the uninterrupted "
            f"stream fit's {layout:.3e}: {band:.3e}); norm rel {nrel:.3e} "
            f"(phase 15's stream band 5e-2)")
        check(cross.resumed_at == 2 and wrel <= band and nrel <= 5e-2,
              "the stream snapshot resumed into the scan driver left the "
              "stream band")
        del Xb, yb, mb, X3, y3

        # -- phase 8's Nystrom KRN-EM-CLS, m = 2,048, killed at iteration 3
        ncfg = SVMConfig.from_options("KRN-EM-CLS", lam=0.1,
                                      sigma=math.sqrt(500), max_iters=5,
                                      min_iters=5, scan_chunk=1)
        d = next(dirs)
        npol = FaultPolicy(ckpt_dir=d, ckpt_every=1)
        ny_ref = NystromSVM(ncfg, n_landmarks=2048, device=dev)
        r_ref, _, s_n = _timed(lambda: ny_ref.fit(Xtr, ytr))
        ny = NystromSVM(dataclasses.replace(ncfg, fault=npol),
                        n_landmarks=2048, device=dev)
        try:
            ny.fit(Xtr, ytr, fault_hook=faults.kill_at_iteration(3))
            check(False, "Nystrom: the kill did not fire")
        except faults.SimulatedPreemption:
            pass
        lm = ny._landmarks
        r_ny, c_ny, s_ny = _timed(lambda: ny.fit(Xtr, ytr, resume_from=d))
        same = _same_fit(r_ref, r_ny)
        f_ref, f_ny = (m.decision_function(Xte[:8192]) for m in (ny_ref, ny))
        say(f"  KRN-EM-CLS m = 2,048 (phase 8): uninterrupted {s_n:.3f} s; "
            f"resumed at {r_ny.resumed_at} in {s_ny:.3f} s on the same "
            f"featurizer, launches "
            f"{ {k: v for k, v in c_ny.items() if v} }; bitwise the "
            f"uninterrupted fit: {same}, decision values bitwise: "
            f"{np.array_equal(f_ref, f_ny)}")
        check(same and np.array_equal(f_ref, f_ny) and ny._landmarks is lm
              and r_ny.resumed_at == 3, "Nystrom: the resumed fit is not "
              "bitwise the uninterrupted one, or made a new featurizer")
        check(all(c_ny[k] == 2 for k in ("nystrom_phi", "fused_estep",
                                           "syrk_tri"))
              and c_ny["rbf_gram"] == 0, f"Nystrom resume launches: {c_ny}")
        del ny, ny_ref

        # -- a FleetController with in-process hosts on phase 4's fit
        d = next(dirs)
        fcfg = dataclasses.replace(base, fault=FaultPolicy(ckpt_dir=d,
                                                           ckpt_every=ch))

        def make_host(level):
            def host(ctx):
                return PEMSVM(fcfg, device=dev).fit(
                    Xtr, ytr, resume_from=ctx.resume_from,
                    fault_hook=ctx.fault_hook, epoch=ctx.epoch)
            return host

        fc = FleetController(
            make_host, d, policy=FleetPolicy(max_attempts=4, backoff_s=1e-3),
            n_levels=2, schedule=FleetSchedule({
                0: lambda cancel: faults.kill_at_iteration(8),
                1: lambda cancel: faults.kill_at_iteration(
                    16, exc=StragglerError)}))
        fr, _, s_f = _timed(fc.run)
        outcomes = [a.outcome for a in fr.attempts]
        same = _same_fit(ref4, fr.result)
        say(f"  FleetController, in-process hosts: {s_f:.3f} s, attempts "
            f"{outcomes} at levels {[a.level for a in fr.attempts]}, epochs "
            f"{[a.epoch for a in fr.attempts]}, resumed at "
            f"{fr.result.resumed_at}; bitwise the uninterrupted fit: {same}")
        check(outcomes == ["retryable", "straggler", "completed"] and same
              and fr.result.resumed_at == 16,
              "the fleet did not recover phase 4's fit bitwise")

        # -- the SubprocessHost fleet started above
        sub_thread.join(timeout=600)
        check(not sub_thread.is_alive() and "fr" in sub_box,
              f"the subprocess fleet did not finish: {sub_box}")
        fr = sub_box["fr"]
        outcomes = [a.outcome for a in fr.attempts]
        res = fr.result
        wrel = _rel(res["w"], ref4.weights)
        same = np.array_equal(res["w"], ref4.weights)
        say(f"  FleetController, SubprocessHost: attempts {outcomes} "
            f"({', '.join(f'{a.seconds:.1f} s' for a in fr.attempts)}; "
            f"watchdog {FLEET_WATCHDOG_S:.0f} s), the child's fit "
            f"{int(res['it'])} iterations, weights {wrel:.3e} from this "
            f"process's fit (bitwise: {same}), JAX modules in the child "
            f"{int(res['bad'])}")
        check(outcomes == ["watchdog", "completed"]
              and fr.attempts[0].seconds < FLEET_WATCHDOG_S + 30
              and int(res["bad"]) == 0 and wrel <= 5e-2
              and abs(int(res["it"]) - ref4.n_iters) <= 3,
              "the subprocess fleet did not SIGTERM the hung attempt and "
              "complete the fit within phase 4's bands")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


SOURCES = {
    "fused_stats": ("src/repro_torch/csrc/fused_stats.cu",
                    "src/repro/kernels/fused_stats.py:155"),
    "fused_stats[mc_hinge,noise]": ("src/repro_torch/csrc/fused_stats.cu",
                                    "src/repro/kernels/fused_stats.py:155"),
    "fused_stats[mc_hinge,seed]": ("src/repro_torch/csrc/fused_stats.cu",
                                   "src/repro/kernels/fused_stats.py:155"),
    "fused_stats[mc_hinge,seed,C=4]": ("src/repro_torch/csrc/fused_stats.cu",
                                       "src/repro/kernels/fused_stats.py:155"),
    "fused_estep": ("src/repro_torch/csrc/fused_estep.cu",
                    "src/repro/kernels/fused_estep.py:58"),
    "syrk_tri": ("src/repro_torch/csrc/syrk.cu",
                 "src/repro/kernels/syrk.py:79"),
    "rbf_gram": ("src/repro_torch/csrc/rbf_gram.cu",
                 "src/repro/kernels/rbf_gram.py:46"),
    "nystrom_phi": ("src/repro_torch/csrc/nystrom_phi.cu",
                    "src/repro/kernels/nystrom_phi.py:205"),
    "nystrom_score": ("src/repro_torch/csrc/nystrom_phi.cu",
                      "src/repro/kernels/nystrom_phi.py:237"),
    **{name: ("src/repro_torch/csrc/nystrom_phi.cu",
              "src/repro/kernels/nystrom_phi.py:283")
       for name in NYS_VARIANTS},
    **{name: ("src/repro_torch/csrc/fused_stats.cu",
              "src/repro/kernels/fused_stats.py:155")
       for name in SVR_VARIANTS},
    **{name: ("src/repro_torch/csrc/nystrom_phi.cu",
              "src/repro/kernels/nystrom_phi.py:283")
       for name in NYS_SVR_VARIANTS},
    "weighted_gram": ("src/repro_torch/csrc/weighted_gram.cu",
                      "src/repro/kernels/weighted_gram.py:40"),
    **{name: ("src/repro_torch/csrc/fused_stats.cu",
              "src/repro/kernels/fused_stats.py:155")
       for name in WIN_VARIANTS},
    **{name: ("src/repro_torch/csrc/nystrom_phi.cu",
              "src/repro/kernels/nystrom_phi.py:283")
       for name in NYS_WIN_VARIANTS},
}


def stamp(t0, *a) -> None:
    """A phase header with the seconds since the run began."""
    say(*a, f"[{time.perf_counter() - t0:.1f} s]")


def main() -> int:
    global torch
    import torch as _torch
    torch = _torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    stamp(t0, "== 1. device")
    phase_device()
    stamp(t0, "== 2. build")
    phase_build()
    stamp(t0, "== 3. kernels vs plain (float64 evaluation of the plain "
              "version)")
    rows = phase_kernels(dev)
    svr_rows, gram_counts = phase_svr_kernels(dev)
    rows.update(svr_rows)
    rows.update(phase_nystrom_kernels(dev))
    phi_design(dev)
    cross_design(dev)
    rows.update(phase_window_kernels(dev))
    stat_design(dev)
    for name, extra in phase_slice_kernels(dev).items():
        rows[name].update(extra)
    stamp(t0, "== 4. main path, K <= 1536: LIN-EM-CLS on alpha-like 250,000 "
              "x 501")
    it4, st4, c4 = phase_main_path(dev)
    stamp(t0, "== 5. main path, K > 1536: LIN-EM-CLS at K = 2,048")
    it5, st5, c5 = phase_wide(dev)
    stamp(t0, "== 6. main path, LIN-MC-CLS on alpha-like 250,000 x 501")
    runs, mc_ref = phase_mc(dev)
    runs["fused_stats"] = (c4, it4, st4)
    for name in ("fused_estep", "syrk_tri"):
        runs[name] = (c5, it5, st5)
    stamp(t0, "== 7. main path, KRN-{EM,MC}-CLS (NystromSVM) on "
              "make_circles(1,000,000), m = 1,000: the fused route")
    runs.update(phase_krn(dev))
    stamp(t0, "== 8. main path, KRN-EM-CLS with m = 2,048 on alpha-like "
              "250,000 x 500: the featurize-then-accumulate route")
    runs.update(phase_krn_wide(dev))
    stamp(t0, "== 9. main path, LIN-{EM,MC}-SVR (Table 6) on year-like "
              "463,715 x 91 (51,630 held out)")
    runs.update(phase_svr(dev))
    stamp(t0, "== 10. main path, KRN-{EM,MC}-SVR (NystromSVM) on the year "
              "split, m = 681: the fused route")
    krn_svr_runs, krn_ref = phase_krn_svr(dev)
    runs.update(krn_svr_runs)
    stamp(t0, "== 12. LIN-{EM,MC}-MLT (Table 8) on mnist8m-like 160,000 x "
              "785 (40,000 held out), M = 10")
    phase_mlt(dev)
    stamp(t0, "== 13. KRN-{EM,MC}-MLT (NystromSVM) on phase 12's split, m = "
              "400")
    phase_krn_mlt(dev)
    stamp(t0, "== 14. exact KRN-{EM,MC}-CLS (Table 7) on "
              "make_circles(1,800); a timing point at 16,384")
    _, krn_rows, exact_ref = phase_exact_krn(dev)
    for name, extra in krn_rows.items():
        rows[name].update(extra)
    stamp(t0, "== 15. the stream driver: Table 5 (make_dna_like) resident "
              "and streamed; MC, K = 2,048, SVR, MLT, Nystrom and the libsvm "
              "file streamed; the resident set-up")
    stream_runs, stream_rows = phase_stream(dev)
    for name, extra in stream_rows.items():
        rows[name].update(extra)
    stamp(t0, "== 16. serving: the bucketed score cells, ServeLoop and "
              "WeightPager on the models of phases 4, 6, 8, 13 and 14")
    for name, extra in phase_serve(dev).items():
        rows[name].update(extra)
    stamp(t0, "== 17. reliability: snapshots, kill and resume (phases 4, 6, "
              "8 and a third of Table 5), the fleet controller")
    phase_reliability(dev)
    stamp(t0, "== 11. the multi-device fit: a 2 x 2 (data x k) mesh and a 4 "
              "x 1 one, four gloo ranks on cuda:0; a one-rank NCCL group")
    runs.update(phase_mesh(dev, krn_ref, mc_ref, exact_ref))
    runs["weighted_gram"] = (gram_counts, 0, 0)
    say(f"== done in {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        counts, iters, steps = runs[name]
        launches = counts[name]
        stream = stream_runs.get(name)
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches,
                            iterations=iters, steps=steps, **rows[name],
                            **({} if stream is None else
                               {"stream_launches": stream[name]})))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
