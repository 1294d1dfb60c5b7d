"""One-command proof that the PyTorch port runs its paths on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k6-values OUT.json   # phase 12's K6 log K only
    python3 chip_smoke.py --rank-worker JOBS.json  # one rank of phase 21 (it starts them)

Phases (the first failure exits non-zero; nothing is caught):

1. environment: the card's name and power limit (nvidia-smi), CUDA, TF32 off;
2. build: the CUDA library from ``stem_kernel_torch/csrc``, and the
   registers, spills and barriers ptxas gave K1's cluster and tile kernels;
3. K1 parity: the closure fixed point through its wrapper in each product
   mode ("highest" f32, "high" 3xTF32, "default" bf16) against its plain
   torch version in the same mode, on both routes (``cluster_route``: the
   cluster kernel, the per-product route's tile kernel), on real DAG
   features of the corpus (B=256 pairs within the most populous node
   bucket, across it and the next, and across the smallest and it, as the
   Gram's cross-bucket blocks run them; true per-pair trip counts) and on
   random operands of 64 and 40 x 56 nodes (the cluster kernel, padded and
   rectangular), 112 x 48 (the tile kernel, padded and rectangular, one CTA
   a pair), 64 x 256 (its 64-row tile), 256, 512 x 512, 320 x 288 and 528 x
   96 nodes (the 3xTF32 strip spilled to device memory), and 1232 x 96 (the
   first Nx at which the wrapper spills the strip in every mode): every
   mode within rel 1e-4; bf16 also at least 10x
   nearer plain bf16 than plain f32; each mode's error against the plain f32
   version is printed, and "high" must stay within JAX "high"'s own 9.0e-4
   of f32;
4. stem path: ``stem_kernel_lite`` train on 100 hairpin-family sequences and
   100 dinucleotide shuffles (length 120, fixed seed), ``svm_tools train``,
   then the predict flow on 40 held-out sequences (the DAG scan and the SMO
   on the port's native host library); both K1 routes' launch
   counts must rise, every string-kernel call must launch its DP kernel
   (``string.calls.kernel`` equal to ``string.calls``, ``string.rows``
   0), the Gram must be finite, symmetric with unit diagonal, the
   predictions written; a small subset is rerun with ``--device cpu`` (the
   plain versions): the two Grams must agree within the 1.4e-2 CLI band and
   the two folds within 5e-4 BPP;
5. every block shape of the stem Gram on the per-product route in each mode
   (beside the cluster kernel up to 64 nodes, where it runs: the times that
   place the wrapper's cut-over) and the library chains below, with the
   block's pairs, its train launches, the tile kernel's geometry and its
   ratio to the f32 chain in "high" and to the bf16 chain in "default", and
   each mode's time and the chains' summed over the train Gram's
   per-product launches; each route in the three modes at the shape
   it takes most often on the path (CUDA events; B=256), against the plain
   f32 version, with its device time (CUDA graph), its bound on the mode's
   unit, its geometry and the library chain (the same pair-trips' products
   through torch.bmm, each pair for its own trips, the batch shrinking as
   pairs finish: f32 with TF32 off, checked against the plain version, bf16
   tensors beside "default", a TF32 chain beside "high" as a one-pass
   reference); and the
   stem path's fold, Gram and flow rates (synchronized host clocks);
6. LA parity: K2-K5 against their plain versions at the shapes of the paths
   below, each square and Lx != Ly (BPLA factors of the folded corpus at
   L=120 and random factors at L=400 for K2; random-profile factors at
   L 32-64 for K3; BLOSUM62 protein scores at L 50-80 for K4 and K5; the
   corpus's (w_pair, w_unpair) through ``la_log_affine_auto`` for K5), exp
   rel 1e-3 and log abs 3e-3, and K2-K5 at Ly = 1500 (Lx != Ly, one block a
   pair, a warp per 1024 columns; exp-space inputs whose values stay
   finite); the log kernels K2 and K5 also at the padded widths 31, 32, 33,
   64, 65, 128 and 129 (Lx != Ly; K2 at ranks 2 and 6, K5 on one slab and on
   two), on a batch whose emissions drop 40+ nats after 30 strong rows, on
   the long-score case (15 a cell, 160 x 160, log K 326.0), and on their
   path batches padded 64 columns wider, which take another lane geometry
   (its values within 3e-3 of the unpadded ones); K2 on 256 pairs of
   384-512 rows and columns (the lane kernels' longest) and at 600 x 600
   (the one-warp kernel past them); the exp kernels K3 and K4 at the same
   widths (Lx != Ly; K3 at ranks 2 and 6, K4 on one slab and on two; log
   emissions -3..-1, K up to about 1e16), on 256 pairs of 384-512 (log
   emissions -8..-3), on an overflow batch (non-finite exactly where the
   plain version is, the finite pairs within 1e-3 rel) and on their path
   batches padded 64 columns wider (within 1e-3 rel of the unpadded
   values); the first 3 pairs alone must equal their values inside the
   batch bit for bit.  K2 at 1000 x 1000 is printed and not held to the
   gate: f32 log K is good to about 1e-2 there, the plain version's too
   (PERF.md, open questions);
7. BPLA path: ``bpla_kernel`` train on the corpus (K2), ``svm_tools train``,
   predict on the 40 held-out sequences, and ``--device cpu`` against
   ``--device cuda`` on 8 sequences within the 1.3e-3 band;
8. LA path: ``la_kernel`` train on 100 synthetic proteins (a 60-residue
   core, 10% mutations, lengths 50-80) and 100 residue shuffles (K4, whose
   lane kernel must run in train and in predict), svm train, predict on 40
   held-out proteins, cpu against cuda on 8 proteins;
9. flagship forward: the normalised exp Gram of ``BPLAKernel`` through
   ``PairKernelEngine`` on 200 random-profile examples of length 32-64 (K3,
   on its lane kernel);
10. log protein Gram: ``BPLAKernel(BLOSUM62, no_bp=True).log_value`` through
   ``PairKernelEngine`` on the proteins (rank 22, so K5), which must agree
   with the LA path's Gram;
11. K2-K5 times against their plain versions (CUDA events, plain, kernel,
   kernel, plain), at the paths' shapes and at Ly = 1500, and the BPLA, LA
   and flagship Gram rates; the lane-geometry tables (device ms a call,
   graph replay, of every geometry that holds the width, and the one-warp
   kernel, at B = 256 on the four path batches and on K2 and K3 factors of
   widths 32-1024: the times that place ``la.LOG_ROUTE`` and
   ``la.EXP_ROUTE``), and K2-K5 at B = 4096;
12. K6 parity: the banded full stem kernel against its plain version at full
   width (n = 301, band 16, B = 16) on the config-3 generator of
   ``bench_full200.py`` (80-300 nt hairpins): the square case, lx != ly,
   the same pairs swapped (bit-identical to the unswapped values) and PHMM
   anchors at ``-a 0.5``, log K within 1e-3 abs; the first 3 pairs alone
   must equal their values inside the batch bit for bit, and every case the
   values in ``tests/golden/k6_log_k.json`` bit for bit (the kernel's log K
   with ``__fdiv_rn`` division at git commit e9461d9, written by
   ``--k6-values`` from a checkout of that commit); the kernel's division by
   a level's scale must equal IEEE f32 division bit for bit where the
   quotient is normal and within one unit in the last place where it is
   subnormal (dividends 2^-149..2^20, scales 1e-30..1e12); one long pair
   (two ~1,000 nt sequences, B = 2) within 1e-3 abs; band 40 (B = 8, two
   opted-in shared-memory planes of 81 x 81) within 1e-3 abs, and its time;
13. full stem path: ``stem_kernel -n -b 16`` train on the config-3 corpus
   (100 + 100 sequences), ``svm_tools train``, predict on 20 held-out
   sequences; K6's launch count must rise in train and in predict; then
   ``-b 16 -a 0.5`` on 40 of the sequences;
14. ``stem_kernel`` with ``--device cpu`` against ``--device cuda`` on 6
   sequences of 60-90 nt, banded (``-b 8``) and dense, within 1e-4;
15. K6 time against its plain version (B = 16, n = 301), its device time
   and launches a call (torch.profiler), a call's time at batches of 1, 4,
   16 and 64 config-3 pairs, the ``-b 16`` train Gram's
   pairs/s, and the device busy share of its first 20 batches under
   torch.profiler with the host's reads of device values (``int(lx.max())``
   in the wrapper among them);
16. optimizer path (no K1-K6 kernel on it): the stem path's generator cut to
   48-60 nt (100 + 100 sequences), folded on the card; K and dK/d(alpha,
   beta, gap, ext) of all 20,100 pairs by ``bpla_optimizer.
   bpla_matrix_with_grads`` (the 7-state flank scan, gradients by autograd),
   finite, with the largest log K, three timed calls
   (pairs/s) and the device busy share of one call traced for device
   events; the same function on 8 sequences
   with ``device=cpu``, K within 1e-4 rel and each dK/dp within 1e-4 of its
   largest; one ``optimize_kernel_params`` run (ncv=5, max_steps=1, the
   CLI's bounds) with its wall time and K+dK evaluations; the
   ``bpla_optimizer -n --fold 2`` CLI on 20 + 20 sequences with ``--device
   cuda`` and ``--device cpu``, each on the native and on the numpy SMO:
   printed parameters and C within 1e-3 rel on the numpy SMO; on the native
   SMO the first step and the last objective within 1e-3 rel, the last
   parameters printed beside each device's native-against-numpy gap;
   and 4 pairs of 80 nt, where f32 overflows, non-finite on the card
   exactly where on the CPU;
17. ``rbf_optimizer``, ``poly_optimizer`` and ``sigmoid_optimizer`` on a
   48-point LIBSVM file, 3 folds (host numpy);
18. ``la_kernel_lite`` (default and ``--use-bp``), ``string_kernel`` and
   ``simpal``: train on phase 16's corpus, ``svm_tools train``, predict on
   20 + 20 held-out sequences; each Gram finite, symmetric, unit diagonal;
   ``--device cpu`` against ``cuda`` on 8 sequences within 5e-7, 1e-4, 1e-6
   and 1e-4 (the card's Gram through the string kernel's DP kernel for
   all but ``simpal``, the CPU's through the plain row loop); each train
   Gram's pairs/s and busy share;
19. the native host code and the Gram-engine options on the stem path:
   (a) the native DAG scan against the Python scan on the BPPs of phase 4's
   200 sequences, identical arrays, each one's ms a sequence beside the
   host's CPU model; (b) the native SMO against the numpy SMO on phase 4's
   normalised Gram (and the nu-solver) and on a seeded random PSD f32 Gram
   of N = 2,000, to ``tests/test_native.py``'s tolerances, with iterations
   and seconds; (c) ``stem_kernel_lite -n --checkpoint`` train: phase 4's
   Gram bit for bit and phase 4's K1 launches, then a resume from the
   complete checkpoint (no K1 launch, the same Gram) and one with the last
   half of the largest bucket block's units cleared (fewer launches than
   the full run, the same Gram); ``bpla_kernel -n --checkpoint``: phase 7's
   Gram bit for bit; (d) ``--trace-dir`` on 20 + 20 sequences: the trace
   holds device events of each K1 route the run launched and the program's
   ``stem_kernel::`` ranges, none of them copied onto the device's
   timeline, ``counters.json`` the run's Gram pairs, the Gram equals the
   untraced run's; (e) the stem train and predict flows' walls with the
   featurize stage apart (host clock, each featurize ended by a
   synchronize), on the native and on the Python scan, beside phase 4's
   walls; (f) the unnormalised ``bpla_optimizer
   --fold 2`` on phase 16's 20 + 20 sequences (native SMO), its wall;
20. the rest of the fold layer: (a) ``bpla_kernel -n --use-alifold`` train
   on 100 + 100 CLUSTAL alignments of 8 rows and 110-130 columns (phase
   4's hairpin family with compensatory and single stem mutations, about
   5% gaps; negatives per-row shuffles), ``svm_tools train``, predict on
   20 + 20; K2's count must rise; 4 + 4 with ``--device cpu`` against
   ``cuda`` (Gram 1.3e-3, BPP 5e-4); batched alifold against
   one-at-a-time on the card within 1e-6 (bit for bit counted); the
   ``ali_*`` goldens within 2e-5; the alifold fold's alignments/s and the
   alifold BPLA Gram's pairs/s; (b) ``stem_kernel_lite -n
   --use-contrafold default`` on phase 4's corpus (both K1 routes),
   ``bpla_kernel -n --use-contrafold`` with ``default`` and with a file of
   the default weights (K2; the two matrices byte-equal), the ``contra_*``
   goldens; (c) the exact fold in f64 on the card against the ten
   ``fold_bpp`` goldens (1e-10) and the card's scaled f32 fold against it
   (BPP 5e-4, logZ 2e-5 rel), ms a sequence on the card and the CPU; (d)
   ``sfold_bpp(seq, 200, seed=0)`` against the ``sfold_*`` goldens bit for
   bit (a draw that f64 rounding moved is printed with its probabilities
   and the case held to the 0.08 Monte-Carlo band); (e) 5 Adam steps of
   ``train_contrafold`` on 4 hairpins of 20-30 nt, card against CPU
   within 1e-9 rel; (f) ``bpla_optimizer -n --use-alifold --fold 2`` on
   20 + 20 alignments of 48-60 columns under phase 16's bands and solver
   split;
21. two ranks on the one card: the script starts itself twice with
   ``--rank-worker`` as ranks 0 and 1 of a torch.distributed group (gloo;
   WORLD_SIZE 2, LOCAL_RANK 0 for both: two single-GPU "nodes" sharing the
   H100), each in its own working directory, and each rank calls the CLIs'
   ``main`` in its process: ``stem_kernel_lite -n`` train and predict on
   phase 4's corpus (K1, both routes), ``bpla_kernel -n`` and ``-n --SW``
   on it (K2; ``--SW`` runs the max-plus DP, plain torch, as plain XLA in
   the JAX package), ``la_kernel -n`` on phase 8's proteins (K4) and
   ``stem_kernel -n -b 16`` on 40 config-3 sequences (K6); no CLI reaches
   K3, so each rank also runs phase 9's flagship exp Gram through
   ``PairKernelEngine`` over the group's mesh.  The same jobs run first in
   this process as one rank (their Grams bit-equal to phases 4, 7, 8 and
   9's).  Every file rank 0 writes must be byte-equal to the
   one-rank file, rank 1 must write none, each rank must launch each of the
   job's kernels, and the two ranks' launches must sum to the one-rank
   count; a rank that exits non-zero fails the phase.  Printed: each job's
   one-rank and two-rank walls (the CLI, and its Gram passes), and
   ``scaling_efficiency`` of the stem kernel on 1 and 2 ranks, all labelled
   "two ranks sharing one card: not a scaling figure";
22. the string kernel's DP kernel (``csrc/string_dp.cu``) against the plain
   row loop on the card, within rel 1e-4: ``StringKernel`` (scores built in
   the kernel) with the RIBOSUM and the match/mismatch tables on
   ``stem_kernel_lite``'s string features of 200 sequences of 110-150 nt
   (B = 256 random pairs, as the Gram gives them), and on random profiles
   with all-gap columns and zero weights at widths 1, 31, 32, 33, 150 and
   1500, Lx = Ly and Lx != Ly; a given score tensor (the string_kernel
   CLI's exact-match scores) at the same widths; a pair alone, the batch
   rolled by one, its first 64 pairs and the batch padded 40 columns wider
   must give the same values bit for bit; then a call's time (CUDA events,
   in turns with the plain loop, and over 50 calls), its device time (CUDA
   graph), the plain loop's time and the bound at the Gram's shape, the
   score-tensor route's at B = 256, 152 x 152, and both at 1500 x 1500;
23. the fold DP kernel (``csrc/fold_dp.cu``) against the plain engine on the
   card (``fold.mccaskill_scaled``'s Python span loops, on the same LUTs), BPP
   within 3e-5 and log Z within 1e-5 relative, bit for bit below n = 1,000
   (the kernel sums in torch's orders), one launch and one
   ``fold.batches.kernel`` a fold: the benchmark's fold batch (200 hairpin
   mutants and shuffles of 110-130 nt), a batch of 64, the fast tier,
   CONTRAfold parameters, an alifold batch of 64 (8 rows, 136 columns,
   w_extra, pt_override, two all-gap dummies of length 0), 4 sequences of
   389-420 nt (past the shared-memory ring) and one of 1,000 nt; at each, the
   wrapper's time on prebuilt LUTs and the whole fold's (CUDA events), the
   kernel's device time and the launches of a whole fold (torch.profiler),
   which must not grow with n, the plain engine's time and the bound.  Run
   alone: ``python3 chip_smoke.py --fold-dp``.

Before each path every launch count is set to 0, and it is read just after;
phases 16-18 must leave every K1-K6 count at 0, and launch the string
kernel's DP kernel on every string-kernel call of ``la_kernel_lite`` (both
runs) and ``string_kernel``, with no plain-loop row, and no string-kernel
call elsewhere; phase 19 must launch K1 and K2;
phase 20's alifold and CONTRAfold paths K2, and K1 on both routes; phase
21 reads each rank's counts of each job.
The line before the last lists every kernel with its launches on the main
path, its error against its plain version, its time, its plain version's
time and its bound: the larger of the bytes it must move over 3.35 TB/s and
the operations this run's inputs need over the peak of the unit that runs
them, 67 TFLOP/s f32, 495 TFLOP/s TF32 (three passes for 3xTF32) or 989
TFLOP/s bf16 (the H100 SXM's published peaks).  K1 has two entries, one a
route, each in the main path's mode, "high", at its busiest shape; their
``library_ms`` is the f32 torch.bmm chain, K2-K6's null.  The string
kernel's DP kernel (SK) and the fold DP kernel (FD) replace no Pallas kernel
(``replaces`` null); their launches are the stem train flow's (phase 4), their
numbers phases 22's and 23's (FD's ``fold_ms`` the whole fold with its LUTs).  ``ms`` is CUDA events around repeated wrapper
calls, host time between launches included; ``device_ms`` the same calls
captured in a CUDA graph and replayed under CUDA events, except K6's: its
wrapper reads max(lx) on the host, so its ``device_ms`` is the summed time
of the device's events under torch.profiler (null if the trace holds
none), and its ``launches_a_call`` the kernel's launches a call there.  K2 and K5 also list their largest abs error on the lane kernels and on
the one-warp kernel apart, K3 and K4 their largest rel error.  The last line is ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
N_TRAIN = 100  # per class
N_TEST = 20  # per class
SEQ_LEN = 120
KERNEL_RTOL = 1e-4  # every kernel mode against its plain version in the same mode
# K1 in bf16 must also sit at least this many times nearer its plain bf16
# version than plain f32, so that a kernel that skips or halves the rounding fails
BF16_SEPARATION = 10.0
JAX_HIGH_REL = 9.0e-4  # JAX "high" (3-pass bf16) against f32 (BASELINE.md)
JAX_DEFAULT_REL = 6.1e-2  # JAX "default" (1-pass bf16) against f32 (BASELINE.md)
CLI_BAND = 1.4e-2  # port-vs-plain Gram band (fold f32 deltas through the DAG)
BPP_BAND = 5e-4  # f32 fold against f32 fold (tests/test_fold_goldens.py)
LA_EXP_RTOL = 1e-3  # the LA kernels' gates (bench.py --paritycheck)
LA_LOG_ATOL = 3e-3
BPLA_BAND = 1.3e-3  # bpla_kernel cross-backend Gram band
LA_BATCH = 256
K1_BATCH = 256  # pairs of a K1 parity / timing batch, as the Gram engine gives them
LONG_BATCH = 32  # pairs of the Ly = 1500 LA batches
AMINO = "ARNDCQEGHILKMFPSTWYV"
BPLA = (4.5, 0.11, -8.0, -0.75)  # alpha, beta, gap, ext (bpla_kernel defaults)
PROT = (0.11, -10.0, -1.0)  # beta, gap, ext (la_kernel defaults)
FULL_N = 200  # config 3 (bench_full200.py): 100 + 100 mixed 80-300 nt sequences
FULL_TEST = 20
FULL_A = 40  # sequences of the -b 16 -a 0.5 run
FULL_BAND = 16
FULL_PAD = 301  # pad width of a corpus whose longest sequence is 300 nt
FULL_WEIGHTS = (0.8, 1.0, 0.5)  # gap, stack, subst (stem_kernel defaults)
K6_ATOL = 1e-3  # log K, kernel against its plain version
K6_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                            "k6_log_k.json")
FULL_CPU_BAND = 1e-4  # stem_kernel --device cpu against --device cuda
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_F32 = 67e12  # H100 SXM f32 outside the tensor cores, operations/s
PEAK_TF32 = 495e12  # H100 SXM TF32 tensor cores, dense
PEAK_BF16 = 989e12  # H100 SXM bf16 tensor cores, dense
# K1's product mode -> (the unit's peak, passes an operation takes on it)
K1_PEAKS = {"f32": (PEAK_F32, 1), "3xtf32": (PEAK_TF32, 3), "bf16": (PEAK_BF16, 1)}
LONG_LY = 1500  # the LA kernels past one warp's 1024 columns
EDGE_LY = (31, 32, 33, 64, 65, 128, 129)  # the log kernels' chunk and geometry edges
EDGE_BATCH = 64  # pairs of those batches
WIDER = 64  # step of the columns a path batch is padded wider by, to take another lane geometry
ROUTE_WIDTHS = (32, 64, 128, 256, 512, 1024)  # K2's and K3's other widths in the geometry tables
BIG_BATCH = 4096  # the LA kernels' large-batch times
EXP_EDGE_LE = (-3.0, -1.0)  # log emissions of the exp kernels' edge cases: K up to ~1e16
EXP_LONG_LE = (-8.0, -3.0)  # of their long cases (384-512 rows and columns): K ~ 3e3
CAP_BATCH = 256  # K2 pairs at the lane kernels' longest
PAST_CAP = 600  # a K2 batch past the lane kernels' 512 rows and columns
ILL_LEN = 1000  # a K2 batch where f32 log K is good to about 1e-2 only
WIDE_BAND = 40  # K6 past its former limit of band 32
K6_BATCHES = (1, 4, 16, 64)  # phase 15's K6 batch table (the CLI's batch is 16)
# operations a cell needs, as each kernel's arithmetic counts them (a
# transcendental, a division or a compare counts as one):
LA_EXP_OPS = 12  # m = e(1 + a + bg g), the closure recurrence, g', the sum, exp
LA_LOG_OPS = 30  # three logaddexp, the row max, exp(m - r), the closure, log
K6_OPS = 23  # injection 6, window scans 6, re-anchor and combine 10, max 1
OPT_LEN = (48, 60)  # the optimizer corpus: f32 K and dK stay finite up to ~70 nt
OPT_RTOL = 1e-4  # K and each dK/dp, --device cpu against cuda
OPT_CLI_N = 20  # sequences a class of the bpla_optimizer CLI run
OPT_CLI_RTOL = 1e-3  # its parameters, first step and last objective, cpu against cuda
OPT_RUN_STEPS = 1  # L-BFGS-B steps of phase 16's optimize_kernel_params run
OVERFLOW_LEN = 80  # the flank kernel's overflow batch
CLASSIC_N = 48  # points of the classic optimizers' LIBSVM file
SMALL_N = 4  # sequences a class of the cpu-against-cuda runs
# the string-family CLIs: (name, flags, cpu-against-cuda band of the Gram)
STRING_CLIS = (("la_kernel_lite", [], 5e-7), ("la_kernel_lite", ["--use-bp"], 1e-4),
               ("string_kernel", [], 1e-6), ("simpal", [], 1e-4))
# phase 22: the string kernel's DP kernel
STRING_BATCH = 256  # pairs of a string-kernel call in the Gram
STRING_LENS = (110, 124, 137, 150)  # stem_kernel_lite's family lengths (the benchmark's 110-130, and longer)
STRING_FAMILY = 25  # sequences of each length (and as many shuffles): 200
STRING_EDGES = (1, 31, 32, 33, 150, LONG_LY)  # the kernel's 32-column chunk edges, a long row
STRING_OTHER = {1: 33, 31: 1, 32: 33, 33: 32, 150: 31, LONG_LY: 150}  # the other side's width
STRING_EDGE_BATCH = 16
STRING_WIDE_W = 0.3  # largest weight of the cases past 150 columns, whose values stay finite
STRING_WIDE_GAP = 0.5  # and the exact-match cases' gap there
# operations a cell needs: the profile score from the row's and column's sums
# (4 FMA, a product, a compare, a division, two products: 13) and the DP
# (v, K1, G1's FMA, K0, G0's FMA: 7)
STRING_PROFILE_OPS = 20
TRACE_N = 20  # sequences a class of the --trace-dir run
SMO_N = 2000  # points of the random PSD Gram of the SMO comparison
SMO_DIM = 10  # their dimension (RBF kernel, gamma 1 / (2 SMO_DIM))
# phase 23: the fold DP kernel; (label, batch, shortest, longest, parameters) of
# each case: the benchmark's family200 fold batch, an alifold-sized batch of
# 64, the fast tier and CONTRAfold, a width past the kernel's shared-memory
# ring, one long sequence
FOLD_CASES = (("family200", 200, 110, 130, "default"), ("batch64", 64, 100, 128, "default"),
              ("fast", 64, 100, 128, "fast"), ("contrafold", 64, 100, 128, "contrafold"),
              ("past_ring", 4, 380, 420, "default"), ("n1000", 1, 1000, 1000, "default"))
FOLD_ALIFOLD = (62, 2, 8, 136)  # alignments (ALI_COLS), all-gap dummies, rows, padded width
FOLD_BPP_ATOL = 3e-5  # BPP, kernel against the plain engine (tests/test_torch_fold_dp.py)
FOLD_LOGZ_RTOL = 1e-5
FOLD_BITS_BELOW = 1000  # widths at which the kernel must give the plain engine's bits
# operations a multiply-add and a multiply-multiply-add of the kernel count
# (2, 3), and the other operations a lane's row does (the hairpin, stacking,
# explicit and closing terms, the Qm1 update, the rescale, the shadows)
FOLD_ROW_OPS = 40
# phase 20: the rest of the fold layer
ALI_ROWS = 8  # rows an alignment, as an Rfam seed alignment
ALI_COLS = (110, 130)  # columns an alignment of the alifold corpus
ALI_GAP = 0.05  # share of gap cells
ALI_BATCH_ATOL = 1e-6  # batched alifold against one-at-a-time, both on the card
ALI_BATCH_N = 8  # alignments of that comparison
GOLDEN_ATOL = 2e-5  # the method goldens' band (tests/test_fold_goldens.py)
ORACLE_TOL = 1e-10  # the exact fold against tests/golden/fold_bpp.npz, rtol and atol
LOGZ_RTOL = 2e-5  # the scaled f32 fold against the exact fold
EXACT_CPU_N = 1  # golden sequences the exact fold is timed on with --device cpu
SFOLD_SAMPLES = 200
SFOLD_BAND = 0.08  # tests/test_fold.py's Monte-Carlo band, for a draw f64 rounding moved
TRAIN_EXAMPLES, TRAIN_LEN, TRAIN_STEPS = 4, (20, 30), 5  # the CONTRAfold trainer's run
TRAIN_RTOL = 1e-9  # its loss history, cuda against cpu (f64)
# phase 21: two ranks sharing the one card
RANK_TIMEOUT = 600  # seconds each rank may take for all its jobs
SCALE_N = 32  # sequences a class behind the stem kernel's scaling_efficiency batches
TWO_RANKS = "two ranks sharing one card: not a scaling figure"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def make_family(rng: np.random.Generator, n: int, length: int) -> list[str]:
    """Hairpin family: one stem/loop/reverse-complement core, 10% mutations."""
    stem = "".join(rng.choice(list("acgu"), size=length // 3))
    comp = {"a": "u", "c": "g", "g": "c", "u": "a"}
    rc = "".join(comp[c] for c in reversed(stem))
    core = stem + "".join(rng.choice(list("acgu"), size=length - 2 * len(stem))) + rc
    out = []
    for _ in range(n):
        s = list(core)
        for i in range(len(s)):
            if rng.random() < 0.1:
                s[i] = rng.choice(list("acgu"))
        out.append("".join(s))
    return out


def make_proteins(rng: np.random.Generator, n: int) -> list[str]:
    """Protein family: a 60-residue core, 10% mutations, cut or extended to
    a length in 50..80."""
    core = rng.choice(list(AMINO), size=60)
    out = []
    for _ in range(n):
        s = [rng.choice(list(AMINO)) if rng.random() < 0.1 else c for c in core]
        length = int(rng.integers(50, 81))
        s = s[:length] + list(rng.choice(list(AMINO), size=max(0, length - 60)))
        out.append("".join(s))
    return out


def trim(rng: np.random.Generator, seqs: list[str], lo: int, hi: int) -> list[str]:
    """Each sequence cut to a random window of length lo..hi."""
    out = []
    for s in seqs:
        n = int(rng.integers(min(lo, len(s)), min(hi, len(s)) + 1))
        start = int(rng.integers(0, len(s) - n + 1))
        out.append(s[start:start + n])
    return out


def random_profiles(rng: np.random.Generator, n: int, lo: int, hi: int) -> dict:
    """bench.py's random-profile BPLA features, lengths lo..hi, padded to hi."""
    prof = rng.dirichlet(np.ones(4), size=(n, hi)).astype(np.float32)
    pl = rng.uniform(0, 0.7, (n, hi)).astype(np.float32)
    pr = rng.uniform(0, 0.7, (n, hi)).astype(np.float32)
    pu = np.sqrt(np.clip(1.0 - pl**2 - pr**2, 0, None)).astype(np.float32)
    return {"profile": prof, "p_left": pl, "p_right": pr, "p_unpair": pu,
            "length": rng.integers(lo, hi + 1, n).astype(np.int32)}


def write_fasta(path: str, seqs: list[str], prefix: str) -> str:
    with open(path, "w") as f:
        f.write("".join(f">{prefix}{i}\n{s}\n" for i, s in enumerate(seqs)))
    return path


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def timed_pair(kernel, plain, reps: int) -> tuple[float, float]:
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel, plain."""
    kernel()
    plain()
    plain_a = cuda_ms(plain, reps)
    kern_a = cuda_ms(kernel, reps)
    kern_b = cuda_ms(kernel, reps)
    plain_b = cuda_ms(plain, reps)
    return (kern_a + kern_b) / 2, (plain_a + plain_b) / 2


def pick(feats: dict, idx: np.ndarray, dev) -> dict:
    """The rows ``idx`` of a numpy feature dict, as tensors on ``dev``."""
    return {k: torch.as_tensor(v[idx], device=dev) for k, v in feats.items()}


def device_us(prof, kernel: str = "") -> tuple[float, float]:
    """(microseconds of the device's events in a torch.profiler trace, those
    whose name contains ``kernel``)."""
    total = named = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # an aten op's device column repeats its kernels' time
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        total += us
        named += us if kernel in e.key else 0.0
    return total, named


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds a call of ``fn``: ``reps`` calls captured in
    one CUDA graph, replayed under CUDA events, so no host time between
    launches enters."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: the library is loaded outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, 3) / reps


def kernel_trace(fn, reps: int, kernel: str):
    """(device ms a call, launches a call of the kernels whose name holds
    ``kernel``) over ``reps`` calls of ``fn`` under torch.profiler, for calls
    that a CUDA graph cannot capture; (None, None) if the trace holds no
    device event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, _ = device_us(prof)
    if total == 0.0:
        return None, None
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key)
    return total / 1e3 / reps, n / reps


def la_edge_cases(rng: np.random.Generator, dev) -> list:
    """(key, label, operands, affine) of the log kernels K2 and K5 at the
    padded widths EDGE_LY, Lx != Ly, ranks 2 and 6 (K2) and with and
    without a second score slab (K5, ``affine``: operands (s0, s1, lx, ly)
    under BPLA's alpha*s0 + s1); ragged lengths up to the pad."""
    out = []
    for w in EDGE_LY:
        lx_max = w + 9
        lx = torch.as_tensor(rng.integers(1, lx_max + 1, EDGE_BATCH).astype(np.int32), device=dev)
        ly = torch.as_tensor(rng.integers(1, w + 1, EDGE_BATCH).astype(np.int32), device=dev)
        lx[0], ly[0] = lx_max, w  # one pair at the full pad
        for rank in (2, 6):
            fx, fy = (torch.as_tensor((rng.normal(size=(EDGE_BATCH, n, rank)) * 0.5)
                                      .astype(np.float32), device=dev) for n in (lx_max, w))
            out.append(("K2", f"rank {rank}, Lx={lx_max} Ly={w}", [fx, fy, lx, ly], False))
        s, s2 = (torch.as_tensor(rng.uniform(lo, hi, (EDGE_BATCH, lx_max, w)).astype(np.float32),
                                 device=dev) for lo, hi in ((-20.0, 25.0), (-10.0, 10.0)))
        out.append(("K5", f"Lx={lx_max} Ly={w}", [s, lx, ly], False))
        out.append(("K5", f"two slabs, Lx={lx_max} Ly={w}", [s, s2, lx, ly], True))
    return out


def exp_factors(rng: np.random.Generator, b: int, nx: int, ny: int, rank: int, le: tuple,
                dev) -> list:
    """K3 factors (fx, fy) whose log emission lies about in ``le`` under BPLA's
    alpha, beta: slot 2 (weight beta) carries it, slot 0 (alpha beta) at rank
    2, the other slots noise of about 0.05."""
    alpha, beta = BPLA[:2]
    fx = rng.normal(size=(b, nx, rank)) * 0.3
    fy = rng.normal(size=(b, ny, rank)) * 0.3
    k, coef = (0, alpha * beta) if rank == 2 else (2, beta)
    fx[:, :, k] = rng.uniform(0.9, 1.1, (b, nx))
    fy[:, :, k] = rng.uniform(*le, (b, ny)) / coef
    return [torch.as_tensor(f.astype(np.float32), device=dev) for f in (fx, fy)]


def exp_scores(rng: np.random.Generator, b: int, nx: int, ny: int, le: tuple, dev,
               two: bool = False) -> list:
    """K4 scores whose log emission lies in ``le``: one slab under la_kernel's
    beta, or two (s0, s1) under BPLA's alpha * s0 + s1, each carrying half."""
    alpha, beta = BPLA[:2]
    if not two:
        return [torch.as_tensor((rng.uniform(*le, (b, nx, ny)) / PROT[0]).astype(np.float32),
                                device=dev)]
    return [torch.as_tensor((rng.uniform(*le, (b, nx, ny)) / (2 * c)).astype(np.float32),
                            device=dev) for c in (alpha * beta, beta)]


def la_exp_edge_cases(rng: np.random.Generator, dev) -> list:
    """(key, label, operands, affine) of the exp kernels K3 and K4 at the padded
    widths EDGE_LY, Lx != Ly: K3 at ranks 2 and 6, K4 on one slab and on two
    (``affine``), log emissions in EXP_EDGE_LE; ragged lengths up to the pad."""
    out = []
    for w in EDGE_LY:
        lx_max = w + 9
        lx = torch.as_tensor(rng.integers(1, lx_max + 1, EDGE_BATCH).astype(np.int32), device=dev)
        ly = torch.as_tensor(rng.integers(1, w + 1, EDGE_BATCH).astype(np.int32), device=dev)
        lx[0], ly[0] = lx_max, w  # one pair at the full pad
        for rank in (2, 6):
            out.append(("K3", f"rank {rank}, Lx={lx_max} Ly={w}",
                        exp_factors(rng, EDGE_BATCH, lx_max, w, rank, EXP_EDGE_LE, dev) + [lx, ly],
                        False))
        out.append(("K4", f"Lx={lx_max} Ly={w}",
                    exp_scores(rng, EDGE_BATCH, lx_max, w, EXP_EDGE_LE, dev) + [lx, ly], False))
        out.append(("K4", f"two slabs, Lx={lx_max} Ly={w}",
                    exp_scores(rng, EDGE_BATCH, lx_max, w, EXP_EDGE_LE, dev, two=True) + [lx, ly],
                    True))
    return out


def exp_overflow_emissions(rng: np.random.Generator) -> tuple:
    """(log emissions (8, 40, 50), lx, ly) of the exp kernels' overflow batch:
    pairs 0-2 finite (EXP_EDGE_LE); 3 emits +3 a cell, so the closure passes
    the largest f32; 4 has one cell of 100, whose exp is inf; 5 one cell of
    87.5 (e = 1e38) among cells of EXP_LONG_LE, finite; 6 emits 4..6 on 3 x 4
    cells, finite; 7 emits +1 with ly = 0, so K = 1."""
    le = rng.uniform(*EXP_EDGE_LE, (8, 40, 50))
    le[3] = 3.0
    le[4, 20, 30] = 100.0
    le[5] = rng.uniform(*EXP_LONG_LE, (40, 50))
    le[5, 10, 10] = 87.5
    le[6] = rng.uniform(4.0, 6.0, (40, 50))
    le[7] = 1.0
    lx = np.array([40, 31, 17, 40, 40, 40, 3, 40], np.int32)
    ly = np.array([50, 50, 26, 50, 50, 50, 4, 0], np.int32)
    return le, lx, ly


def la_overflow_cases(rng: np.random.Generator, dev) -> list:
    """(key, label, operands, False) of K3 and K4 on the overflow batch of
    :func:`exp_overflow_emissions`; K3 builds its emissions from factors:
    slot 2 a column's emission, slot 3 a single cell's."""
    le, lx, ly = exp_overflow_emissions(rng)
    alpha, beta = BPLA[:2]
    fx = np.zeros((8, 40, 6))
    fy = np.zeros((8, 50, 6))
    fx[:, :, 2] = 1.0
    fy[:, :, 2] = le[:, 0, :] / beta  # each column's emission, row 0's
    for p, (i, j) in ((4, (20, 30)), (5, (10, 10))):
        fx[p, i, 3] = 1.0
        fy[p, j, 3] = (le[p, i, j] - le[p, 0, j]) / beta
    t = lambda a, dt=np.float32: torch.as_tensor(a.astype(dt), device=dev)  # noqa: E731
    label = "overflow batch (pairs 3 and 4 overflow)"
    return [("K3", label, [t(fx), t(fy), t(lx, np.int32), t(ly, np.int32)], False),
            ("K4", label, [t(le / PROT[0]), t(lx, np.int32), t(ly, np.int32)], False)]


def la_drop_cases(rng: np.random.Generator, dev) -> list:
    """(key, label, operands, False) of K2 and K5 whose first rows score strongly
    (about +3 a cell) and whose later rows score 40+ nats lower, so that the
    gap state carries mass far below the later rows' maxima."""
    b, nx, ny, strong = 16, 90, 100, 30
    lx = torch.as_tensor(rng.integers(60, nx + 1, b).astype(np.int32), device=dev)
    ly = torch.as_tensor(rng.integers(70, ny + 1, b).astype(np.int32), device=dev)
    beta = BPLA[1]
    fx = rng.normal(size=(b, nx, 6)) * 0.3
    fy = rng.normal(size=(b, ny, 6)) * 0.3
    fx[:, :strong, 2] = 3.0 / beta
    fx[:, strong:, 2] = -rng.uniform(40.0, 45.0, (b, nx - strong)) / beta
    fy[:, :, 2] = rng.uniform(0.9, 1.1, (b, ny))
    s = rng.normal(size=(b, nx, ny)) * 5.0
    s[:, :strong] += 3.0 / PROT[0]
    s[:, strong:] -= 42.0 / PROT[0]
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa: E731
    label = f"drop: rows {strong}.. score 40+ nats below the first {strong}"
    return [("K2", label, [f32(fx), f32(fy), lx, ly], False),
            ("K5", label, [f32(s), lx, ly], False)]


def pad_wider(key: str, ops: list, cols: int) -> list:
    """An LA kernel's operands with the column axis padded ``cols`` wider
    (zeros past every pair's length): the same pairs on another geometry."""
    if key in ("K2", "K3"):
        return [ops[0], torch.nn.functional.pad(ops[1], (0, 0, 0, cols)).contiguous(), *ops[2:]]
    return [torch.nn.functional.pad(ops[0], (0, cols)).contiguous(), *ops[1:]]


def width(key: str, ops: list) -> int:
    """The padded column count Ly of an LA kernel's operands."""
    return ops[1].shape[1] if key in ("K2", "K3") else ops[0].shape[2]


def la_geometry(key: str, ops: list, cols: int = 0) -> tuple[int, int]:
    """The lane geometry the LA kernel ``key`` takes on these operands, with
    the column axis padded ``cols`` wider."""
    from stem_kernel_torch.ops.la import exp_route, log_route

    if key in ("K2", "K5"):
        return log_route(ops[0].shape[1], width(key, ops) + cols)
    return exp_route(ops[0].shape[1], width(key, ops) + cols, factored=key == "K3")


def wider_cols(key: str, ops: list) -> int:
    """The fewest columns, a multiple of WIDER, that padding these operands
    by moves them to another lane geometry."""
    cols = WIDER
    while la_geometry(key, ops, cols) == la_geometry(key, ops):
        cols += WIDER
    return cols


def dims(key: str, ops: list) -> str:
    """B, Lx, Ly of an LA kernel's operands (factors for K2/K3, else scores)."""
    if key in ("K2", "K3"):
        return f"B={ops[0].shape[0]} Lx={ops[0].shape[1]} Ly={ops[1].shape[1]}"
    return "B={} Lx={} Ly={}".format(*ops[0].shape)


def gram_checks(name: str, g: np.ndarray, n: int, labels=None, want_labels=None) -> None:
    check(g.shape == (n, n), f"{name}: Gram shape {g.shape}")
    check(labels == want_labels, f"{name}: labels differ")
    check(bool(np.isfinite(g).all()), f"{name}: Gram not finite")
    check(float(np.abs(g - g.T).max()) <= 1e-6, f"{name}: Gram not symmetric")
    check(float(np.abs(np.diag(g) - 1.0).max()) <= 1e-5, f"{name}: Gram diagonal is not 1")


def predictions(path: str, n: int, name: str) -> float:
    """AUC of a prediction file's decision values; checks its line count."""
    from stem_kernel_torch.utils.roc import roc_curve_and_auc

    lines = open(path).read().splitlines()
    check(len(lines) == n, f"{name}: {len(lines)} prediction lines, want {n}")
    y_true = np.array([1.0 if ln.split()[0] == "+1" else -1.0 for ln in lines])
    dec = np.array([float(ln.split()[1]) for ln in lines])
    check(bool(np.isfinite(dec).all()), f"{name}: decision values not finite")
    auc, _ = roc_curve_and_auc(y_true, dec)
    return auc


def make_mixed(n: int, seed: int = 0, lo: int = 80, hi: int = 300) -> list[str]:
    """bench_full200.py's mixed structured set: stem / loop / reverse
    complement, lengths lo..hi."""
    rng = np.random.default_rng(seed)
    comp = {"a": "u", "c": "g", "g": "c", "u": "a"}
    out = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi + 1))
        stem = "".join(rng.choice(list("acgu"), size=ln // 3))
        mid = "".join(rng.choice(list("acgu"), size=ln - 2 * len(stem)))
        out.append(stem + mid + "".join(comp[c] for c in reversed(stem)))
    return out


def stem_features(seqs: list[str], pad: int) -> dict:
    """The stem_kernel CLI's features (codes, lengths, pair weights) at one pad."""
    from stem_kernel_torch.io.alphabet import encode
    from stem_kernel_torch.models.full_stem import pair_weights

    codes = np.zeros((len(seqs), pad), np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    bp = np.zeros((len(seqs), pad, pad), np.float32)
    for i, s in enumerate(seqs):
        c = encode(s)
        codes[i, :len(c)], lens[i] = c, len(c)
        bp[i, :len(c), :len(c)] = pair_weights(c, len(c))
    return {"codes": codes, "length": lens, "bp": bp}


def bound(nbytes: float, ops: float, peak: float = PEAK_F32) -> tuple[float, str]:
    """(least ms on the card, what bounds it) for moving ``nbytes`` once and
    doing ``ops`` operations on a unit of ``peak`` operations/s."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_bound(args: list, max_iters: int, mode: str = "f32") -> tuple[float, str]:
    """K1: per pair, min(iters, max_iters) iterations of four GEMMs
    (M Vy^T, Vx (.), G Ay^T, Ax (.)), + L and * NS, then ux^T M uy.  The
    products run on the mode's unit, 3xTF32 as three TF32 passes; the
    elementwise work and the bilinear form on the f32 units."""
    ns, iters = args[0], args[-1]
    bsz, nx, ny = ns.shape
    trips = float(torch.clamp(iters, max=max_iters).sum())
    peak, passes = K1_PEAKS[mode]
    products = trips * 4.0 * nx * ny * (nx + ny) * passes
    elementwise = trips * 2.0 * nx * ny + bsz * 2.0 * nx * ny
    nbytes = 4.0 * bsz * (2 * nx * ny + 2 * nx * nx + 2 * ny * ny + nx + ny + 2)
    t_ops = products / peak + elementwise / PEAK_F32
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_chain(ops: list, active: list) -> torch.Tensor:
    """K1's function as the library computes it, each pair for its own trip
    count: ``ops`` are the eight operands (any dtype), the pairs sorted by
    trips, most first, and ``active[k]`` the pairs that take trip k.  A
    trip's four products run on those pairs only, through torch.bmm and
    torch.baddbmm (+ L in the product's epilogue), and NS * (.) writes
    into M's rows in place; the first trip skips M Vy^T (M = 0), as the
    kernels do.  Then ux^T M uy."""
    ns, vx, vy, ax, ay, l, ux, uy = ops
    vyt, ayt = vy.transpose(1, 2), ay.transpose(1, 2)
    m = torch.zeros_like(ns)
    for k, n in enumerate(active):
        s = l[:n] if k == 0 else torch.baddbmm(l[:n], m[:n], vyt[:n])
        g = torch.bmm(vx[:n], s)
        torch.mul(ns[:n], torch.bmm(ax[:n], torch.bmm(g, ayt[:n])), out=m[:n])
    return torch.einsum("bi,bij,bj->b", ux, m, uy)


def chain_ms(args: list, max_iters: int, dtype=torch.float32,
             tf32: bool = False) -> tuple[float, torch.Tensor]:
    """(ms a call of :func:`k1_chain` (CUDA events), its values in f32 in
    the pairs' order) on K1 operands ``args`` cast to ``dtype``, with TF32
    products (``allow_tf32``) where ``tf32``.  Sorting the pairs by trips
    and their trip table are set-up, not timed."""
    trips = torch.clamp(args[-1], max=max_iters)
    order = torch.argsort(trips, descending=True)
    ranked = trips[order].tolist()
    active = [sum(1 for t in ranked if t > k) for k in range(ranked[0] if ranked else 0)]
    ops = [t.index_select(0, order).to(dtype) for t in args[:-1]]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        vals = k1_chain(ops, active)
        ms = cuda_ms(lambda: k1_chain(ops, active), 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    out = torch.empty(len(ranked), device=vals.device, dtype=torch.float32)
    out[order] = vals.float()
    return ms, out


def k1_random(bsz: int, nx: int, ny: int, max_iters: int, seed: int, dev) -> list:
    """Random K1 operands whose fixed point stays bounded (each operator's
    rows sum to about 0.75), with per-pair trips 0..max_iters."""
    g = torch.Generator().manual_seed(seed)
    mats = [torch.rand(bsz, nx, ny, generator=g), torch.rand(bsz, nx, nx, generator=g) * 1.5 / nx,
            torch.rand(bsz, ny, ny, generator=g) * 1.5 / ny,
            torch.rand(bsz, nx, nx, generator=g) * 1.5 / nx,
            torch.rand(bsz, ny, ny, generator=g) * 1.5 / ny, torch.rand(bsz, nx, ny, generator=g)]
    vecs = [torch.rand(bsz, nx, generator=g), torch.rand(bsz, ny, generator=g)]
    trips = torch.randint(0, max_iters + 1, (bsz,), generator=g, dtype=torch.int32)
    return [t.to(dev) for t in mats + vecs + [trips]]


def k1_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest error relative to the value (floored at 1e-6 of the largest)."""
    return float(((got - want).abs() / (want.abs() + 1e-6 * want.abs().max())).max())


def la_bound(key: str, ops: list) -> tuple[float, str]:
    """K2-K5: lx * ly cells a pair (this run's lengths), each a cell of the
    closure plus its emission (2K operations from K factors, 1 from a slab)."""
    lx, ly = ops[-2], ops[-1]
    if key in ("K2", "K3"):
        fx, fy = ops[0], ops[1]
        lxc, lyc = torch.clamp(lx, max=fx.shape[1]), torch.clamp(ly, max=fy.shape[1])
        per_cell = (LA_LOG_OPS if key == "K2" else LA_EXP_OPS) + 2 * fx.shape[2]
        nbytes = 4.0 * (fx.numel() + fy.numel())
    else:
        s = ops[0]
        lxc, lyc = torch.clamp(lx, max=s.shape[1]), torch.clamp(ly, max=s.shape[2])
        per_cell = (LA_LOG_OPS if key == "K5" else LA_EXP_OPS) + 1
        nbytes = 4.0 * s.numel()
    cells = float((lxc.double() * lyc.double()).sum())
    return bound(nbytes + 12.0 * lx.shape[0], cells * per_cell)


def k6_bound(ops: list, band: int) -> tuple[float, str]:
    """K6: per pair, L = max(lx, ly) levels; level d has L - d + 1 windows
    of W^2 cells; the inputs are the codes, lengths and pair weights."""
    lx, ly = ops[2], ops[3]
    big = torch.maximum(lx, ly).double()
    cells = float((big * (big + 1) / 2).sum()) * (2 * band + 1) ** 2
    nbytes = (ops[0].numel() + ops[1].numel() + 4.0 * (ops[4].numel() + ops[5].numel())
              + 12.0 * lx.shape[0])
    return bound(nbytes, cells * K6_OPS)


def device_busy(engine, n_ex: int, kernel: str, batches: int = 20) -> str:
    """Device busy share of the first ``batches`` Gram batches under
    torch.profiler: the summed device time of kernel events over the traced
    wall, and the share of it in kernels whose name contains ``kernel``."""
    from torch.profiler import ProfilerActivity, profile

    iu = np.triu_indices(n_ex)
    count = batches * engine.batch_size
    engine.run_pairs(iu[0][:engine.batch_size], iu[1][:engine.batch_size])  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_pairs(iu[0][:count], iu[1][:count])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    total, named = device_us(prof, kernel)
    if total == 0.0:
        return "device time not measured (the trace holds no kernel events)"
    # host reads of a device value (.item(), int(t)) wait for the device
    waits = [e for e in prof.key_averages() if e.key == "aten::_local_scalar_dense"]
    wait_us = sum(e.cpu_time_total for e in waits)
    return (f"traced wall {wall_us / 1e3:.2f} ms, device {total / 1e3:.2f} ms "
            f"({100 * total / wall_us:.1f}% busy), {kernel} {named / 1e3:.2f} ms "
            f"({100 * named / total:.1f}% of device time); host reads of device values "
            f"{wait_us / 1e3:.2f} ms in {sum(e.count for e in waits)} calls "
            f"({100 * wait_us / wall_us:.1f}% of the wall)")


def k6_cases(dev, feats: dict, rng: np.random.Generator) -> list:
    """Phase 12's K6 operands, B = 16 pairs of ``feats`` each: (label,
    operands, ali_bound) for the square case, lx != ly, the same pairs
    swapped, and PHMM anchors at -a 0.5."""
    n_ex = len(feats["length"])
    lens = feats["length"]
    sq = rng.integers(0, n_ex, 16)
    ix = rng.integers(0, n_ex, 64)
    iy = rng.integers(0, n_ex, 64)
    keep = np.flatnonzero(lens[ix] != lens[iy])[:16]
    ix, iy = ix[keep], iy[keep]
    check(len(ix) == 16, "K6 parity: too few pairs with lx != ly")

    def operands(a, b):
        x, y = pick(feats, a, dev), pick(feats, b, dev)
        return [x["codes"], y["codes"], x["length"], y["length"], x["bp"], y["bp"]]

    rect = operands(ix, iy)
    return [("square", operands(sq, sq), 0.0), ("lx != ly", rect, 0.0),
            ("swapped", operands(iy, ix), 0.0), ("-a 0.5", rect, 0.5)]


def k6_feats() -> tuple[list[str], list[str], dict]:
    """The config-3 corpus (train and test sequences) and the training
    sequences' features at the full pad."""
    full = make_mixed(FULL_N + FULL_TEST, seed=SEED)
    return full[:FULL_N], full[FULL_N:], stem_features(full[:FULL_N], FULL_PAD)


def k6_parity(dev, feats: dict, rng: np.random.Generator) -> tuple[dict, list, list]:
    """K6 against its plain version and the reference values on the cases of
    :func:`k6_cases`, its division against IEEE division, one long pair and
    band 40.  Returns (max abs error against the plain version, the lx != ly
    operands, the band-40 operands)."""
    from stem_kernel_torch.ops.full_stem_banded import (
        _div_scale, full_stem_banded_log, full_stem_banded_log_reference,
    )

    cases = k6_cases(dev, feats, rng)
    with open(K6_REFERENCE) as f:
        ref = json.load(f)["cases"]
    report = {"max_abs_err": 0.0}
    values = {}
    for label, ops, ali in cases:
        got = full_stem_banded_log(*ops, *FULL_WEIGHTS, band=FULL_BAND, ali_bound=ali)
        want = full_stem_banded_log_reference(*ops, *FULL_WEIGHTS, band=FULL_BAND,
                                              ali_bound=ali)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(want).all()), f"K6 {label}: plain version not finite")
        check(bool(torch.isfinite(got).all()), f"K6 {label}: kernel output not finite")
        err = float((got - want).abs().max())
        alone = full_stem_banded_log(*[o[:3].contiguous() for o in ops], *FULL_WEIGHTS,
                                     band=FULL_BAND, ali_bound=ali)
        same = bool(torch.equal(alone, got[:3]))
        golden = torch.tensor(ref[label], dtype=torch.float32)
        kept = int((got.cpu() == golden).sum())
        values[label] = got
        big = torch.maximum(ops[2], ops[3])
        print(f"K6 parity, {label}: B=16 n={ops[0].shape[1]} band={FULL_BAND} max(lx, ly) "
              f"{int(big.min())}..{int(big.max())}, log K {float(want.min()):.2f}.."
              f"{float(want.max()):.2f}: max abs {err:.3e} (abs limit {K6_ATOL}); "
              f"first 3 alone bit-identical {same}; reference values bit-identical "
              f"{kept}/{len(golden)} (max abs {float((got.cpu() - golden).abs().max()):.3e})")
        check(err <= K6_ATOL, f"K6 {label}: kernel disagrees with its plain version")
        check(same, f"K6 {label}: a pair's value depends on its batch")
        check(kept == len(golden), f"K6 {label}: log K differs from the reference values")
        report["max_abs_err"] = max(report["max_abs_err"], err)
    swap_same = bool(torch.equal(values["swapped"], values["lx != ly"]))
    print(f"K6 parity: swapped pairs bit-identical to the unswapped values {swap_same}")
    check(swap_same, "K6: a pair and its swap differ")

    # the division by a level's scale, against IEEE f32 division: the f64
    # quotient of two f32 values rounded to f32 is the correctly rounded one
    x = (2.0 ** rng.uniform(-149, 20, 1 << 22)).astype(np.float32)
    x[rng.random(x.size) < 0.05] = 0.0
    xt = torch.as_tensor(x, device=dev)
    normal_bad = sub_bad = sub_n = worst = 0
    scales = (1e-30, 1e-20, 1e-6, 0.37, 1.0, 3.0, 97.5, 1234.5, 1e6, 1e12)
    for m in map(np.float32, scales):
        want = (x.astype(np.float64) / np.float64(m)).astype(np.float32)
        got = _div_scale(xt, float(m)).cpu().numpy()
        bad = got.view(np.int32) != want.view(np.int32)
        sub = np.abs(want) < np.float32(2.0 ** -126)
        normal_bad += int((bad & ~sub).sum())
        sub_bad += int((bad & sub).sum())
        sub_n += int(sub.sum())
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
        worst = max(worst, int(ulps.max()))
    print(f"K6 division by the scale: {len(scales) * x.size:,} quotients (dividends "
          f"2^-149..2^20 and 0, scales 1e-30..1e12): {normal_bad} normal quotients differ "
          f"from IEEE f32 division; {sub_bad} of {sub_n:,} subnormal ones differ, by at most "
          f"{worst} unit in the last place")
    check(normal_bad == 0 and worst <= 1, "K6: the scale division is not IEEE division")

    # one long pair: the kernel takes any length the TPU kernel took
    long = make_mixed(2, seed=SEED + 4, lo=950, hi=1000)
    lf = stem_features(long, max(len(q) for q in long) + 1)
    xl, yl = pick(lf, np.array([0, 1]), dev), pick(lf, np.array([1, 1]), dev)
    lops = [xl["codes"], yl["codes"], xl["length"], yl["length"], xl["bp"], yl["bp"]]
    got = full_stem_banded_log(*lops, *FULL_WEIGHTS, band=FULL_BAND)
    want = full_stem_banded_log_reference(*lops, *FULL_WEIGHTS, band=FULL_BAND)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"K6 long pair: lengths {[len(q) for q in long]}, B=2 n={lops[0].shape[1]}: log K "
          f"{[round(v, 3) for v in got.tolist()]}: max abs {err:.3e} (abs limit {K6_ATOL})")
    check(bool(torch.isfinite(got).all()) and err <= K6_ATOL,
          "K6: the long pair disagrees with its plain version")
    report["max_abs_err"] = max(report["max_abs_err"], err)

    # band 40: two (81, 81) planes, past the 48 KB a block gets without opting in
    n_ex = len(feats["length"])
    xw, yw = pick(feats, rng.integers(0, n_ex, 8), dev), pick(feats, rng.integers(0, n_ex, 8), dev)
    wops = [xw["codes"], yw["codes"], xw["length"], yw["length"], xw["bp"], yw["bp"]]
    got = full_stem_banded_log(*wops, *FULL_WEIGHTS, band=WIDE_BAND)
    want = full_stem_banded_log_reference(*wops, *FULL_WEIGHTS, band=WIDE_BAND)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"K6 band {WIDE_BAND}: B=8 n={wops[0].shape[1]}, log K {float(want.min()):.2f}.."
          f"{float(want.max()):.2f}: max abs {err:.3e} (abs limit {K6_ATOL})")
    check(bool(torch.isfinite(got).all()) and err <= K6_ATOL,
          f"K6: band {WIDE_BAND} disagrees with its plain version")
    report["max_abs_err"] = max(report["max_abs_err"], err)
    return report, cases[1][1], wops


def k6_values(path: str) -> int:
    """Write log K of phase 12's K6 cases, by the importable package's
    kernel, to ``path`` as JSON: how ``tests/golden/k6_log_k.json`` is made
    from a checkout of the commit whose values it holds."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from stem_kernel_torch.ops.full_stem_banded import full_stem_banded_log

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = k6_cases(dev, k6_feats()[2], np.random.default_rng(SEED + 2))
    out = {label: full_stem_banded_log(*ops, *FULL_WEIGHTS, band=FULL_BAND,
                                       ali_bound=ali).cpu().tolist()
           for label, ops, ali in cases}
    with open(path, "w") as f:
        json.dump({"band": FULL_BAND, "weights": FULL_WEIGHTS, "cases": out}, f, indent=1)
    print(f"K6 log K of {len(out)} cases written to {path}")
    return 0


def max_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want) / np.abs(want)))


def run_cli(main_fn, argv: list) -> str:
    """Run a CLI's main in this process; its standard output, also printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    check(rc == 0, f"{main_fn.__module__} {argv}: exit code {rc}")
    print(buf.getvalue(), end="")
    return buf.getvalue()


def printed_params(out: str) -> np.ndarray:
    """(C, alpha, beta, gap, ext) from bpla_optimizer's last line."""
    import re

    m = re.search(r"C=(\S+), alpha=(\S+), beta=(\S+), gap=(\S+), ext=(\S+)", out)
    check(m is not None, f"bpla_optimizer printed no parameters: {out!r}")
    return np.array([float(v) for v in m.groups()])


def optimizer_cli(argv: list) -> dict:
    """Run bpla_optimizer's main in this process: its printed parameters,
    the x of its first step (of step 0 when it stops there), its last
    step's objective, its count of steps and its wall."""
    import io
    import re

    from stem_kernel_torch.cli import bpla_optimizer

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        out = run_cli(bpla_optimizer.main, argv)
    wall = time.perf_counter() - t0
    print(err.getvalue(), end="", file=sys.stderr)
    steps = re.findall(r"=== step (\d+): f=(\S+) x=\[([^\]]*)\]", err.getvalue())
    check(len(steps) >= 1, f"bpla_optimizer {argv}: no step printed")
    return {"params": printed_params(out),
            "first": np.array(steps[min(1, len(steps) - 1)][2].split(), float),
            "f": float(steps[-1][1]), "steps": len(steps), "s": wall}


@contextlib.contextmanager
def smo_solver(name: str):
    """Run the port's SMO from alpha = 0 on ``name``: "native" (its default)
    or "numpy" (the plain version)."""
    from stem_kernel_torch import native
    from stem_kernel_torch.svm import solver

    def plain(K, y, p, C_p, C_n, eps, max_iter):
        res = solver.smo_solve_numpy(K, y, p, C_p, C_n, eps=eps, max_iter=max_iter)
        return res.alpha, res.rho, res.obj, res.n_iter

    saved = native.smo_solve_native
    if name == "numpy":
        native.smo_solve_native = plain
    try:
        yield
    finally:
        native.smo_solve_native = saved


def optimizer_corpus() -> tuple[list[str], list[str], list[str]]:
    """Phase 16's corpus: the stem path's generator, seed 0, each sequence
    cut to 48-60 nt (family, shuffles), and four 80-nt overflow sequences."""
    from stem_kernel_torch.utils.shuffle import dinucleotide_shuffle

    rng = np.random.default_rng(SEED)
    fam = make_family(rng, N_TRAIN + N_TEST, SEQ_LEN)
    shuf = [dinucleotide_shuffle(s, rng) for s in fam]
    overflow_seqs = trim(rng, fam[:2] + shuf[:2], OVERFLOW_LEN, OVERFLOW_LEN)
    return trim(rng, fam, *OPT_LEN), trim(rng, shuf, *OPT_LEN), overflow_seqs


def slice4_phases(dev, smi: str, reset_counts, counts) -> None:
    """Phases 16-18: the optimizers and the string-family CLIs.  No K1-K6
    kernel lies on these paths: every launch count must stay 0."""
    from torch.profiler import ProfilerActivity, profile

    from stem_kernel_torch.cli import (
        bpla_optimizer, classic_optimizers, la_kernel_lite, simpal, string_kernel, svm_tools,
    )
    from stem_kernel_torch.fold.bpmatrix import bpp_for_alignments, fold_sequences
    from stem_kernel_torch.gram.engine import PairKernelEngine
    from stem_kernel_torch.gram.io import read_precomputed
    from stem_kernel_torch.io.profile import Alignment
    from stem_kernel_torch.models.bpla import (
        DEFAULT_BPLA_SCORE_TABLE, bpla_kernel_batch, bpla_score_parts, pair_mask,
    )
    from stem_kernel_torch.models.featurize import (
        bpla_features, loop_profile_weights, plain_string_features, string_kernel_features,
    )
    from stem_kernel_torch.models.simpal import pal_features, simpal_kernel_fn
    from stem_kernel_torch.models.string_kernel import StringKernel, plain_string_kernel
    from stem_kernel_torch.opt.optimizer import optimize_kernel_params

    def no_kernels(phase: str, string: bool = False) -> None:
        """No K1-K6 launch; the string DP kernel on every string-kernel call
        where ``string``, else no string-kernel call."""
        got, sk = counts(), string_counts()
        print(f"{phase}: K1-K6 launch counts {got}; string kernel {sk}")
        check(not any(got.values()), f"{phase} launched a K1-K6 kernel: {got}")
        check_string_kernel(phase, sk, string)

    fam, shuf, overflow_seqs = optimizer_corpus()
    pos, tpos = fam[:N_TRAIN], fam[N_TRAIN:]
    neg, tneg = shuf[:N_TRAIN], shuf[N_TRAIN:]
    train = pos + neg
    n = len(train)
    n_pairs = n * (n + 1) // 2
    tmp_dir = tempfile.TemporaryDirectory()
    p = lambda f: os.path.join(tmp_dir.name, f)  # noqa: E731
    for name, seqs in (("pos", pos), ("neg", neg), ("tpos", tpos), ("tneg", tneg),
                       ("cpos", pos[:OPT_CLI_N]), ("cneg", neg[:OPT_CLI_N]),
                       ("spos", pos[:SMALL_N]), ("sneg", neg[:SMALL_N])):
        write_fasta(p(f"{name}.fa"), seqs, name)
    table = DEFAULT_BPLA_SCORE_TABLE
    params = np.array(BPLA, np.float64)  # alpha, beta, gap, ext

    # ---- 16. optimizer path: K and dK by autograd on the card ----
    reset_counts()
    t_phase = time.perf_counter()
    alns = [Alignment(rows=[s]) for s in train]
    feats = bpla_features(alns, bpp_for_alignments(alns, device=dev))

    def kdk(f, device, normalize=True):
        return bpla_optimizer.bpla_matrix_with_grads(f, table, params, device=device,
                                                     normalize=normalize)

    # the self pairs' raw K, which with the normalized K gives every pair's
    x = pick(feats, np.arange(n), dev)
    wp, wu = bpla_score_parts(x["profile"], x["p_left"], x["p_right"], x["p_unpair"],
                              x["profile"], x["p_left"], x["p_right"], x["p_unpair"],
                              torch.as_tensor(table, device=dev))
    self_k, self_g = bpla_kernel_batch(wp, wu, pair_mask(x["length"], wp.shape[1], x["length"],
                                                         wp.shape[2]), params, with_grads=True)
    self_k, self_g = self_k.cpu().numpy(), self_g.cpu().numpy()
    check(bool(np.isfinite(self_k).all() and np.isfinite(self_g).all()),
          "K or dK of the optimizer corpus's self pairs is not finite")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k, g = kdk(feats, dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check(bool(np.isfinite(k).all() and np.isfinite(g).all()),
          "normalized K or dK of the optimizer corpus is not finite")
    # device events only: a CPU trace of its ~250k autograd ops would
    # stretch the traced call several times over
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kdk(feats, dev)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    busy_us, _ = device_us(prof)
    busy = ("not measured (the trace holds no device events)" if busy_us == 0.0 else
            f"device {busy_us / 1e3:.1f} ms of a traced {1e3 * traced_s:.1f} ms "
            f"({100 * busy_us / 1e6 / traced_s:.1f}% busy; "
            f"{100 * busy_us / 1e6 / np.mean(times):.1f}% of an untraced call)")
    lens = feats["length"]
    log_d = np.log(self_k.astype(np.float64))
    log_k = np.log(k) + 0.5 * (log_d[:, None] + log_d[None, :])
    print(f"optimizer path on {smi}: K+dK (normalize) of {n} sequences of {lens.min()}-"
          f"{lens.max()} nt, {n_pairs} pairs in batches of 256: largest log K "
          f"{float(log_k.max()):.3f} (of a self pair {float(log_d.max()):.3f}, its |dK/dp| up "
          f"to {np.abs(self_g).max():.3e}); "
          f"{', '.join(f'{t:.3f}' for t in times)} s, "
          f"{', '.join(f'{n_pairs / t:.1f}' for t in times)} pairs/s; traced call: {busy}")
    no_kernels("optimizer K+dK")

    # the same function on the CPU: 8 sequences, 36 pairs
    small = {key: np.concatenate([v[:SMALL_N], v[N_TRAIN:N_TRAIN + SMALL_N]])
             for key, v in feats.items()}
    for normalize in (False, True):
        kc, gc = kdk(small, "cpu", normalize)
        kg, gg = kdk(small, dev, normalize)
        k_err = max_rel(kg, kc)
        g_err = [float(np.abs(gg[q] - gc[q]).max() / np.abs(gc[q]).max()) for q in range(4)]
        print(f"K+dK (normalize={normalize}), {2 * SMALL_N} sequences, cuda vs cpu: K max rel "
              f"{k_err:.3e}, dK/d(alpha, beta, gap, ext) max abs / max |dK/dp| "
              f"{', '.join(f'{e:.3e}' for e in g_err)} (limit {OPT_RTOL})")
        check(k_err <= OPT_RTOL and max(g_err) <= OPT_RTOL, "K+dK: cuda and cpu disagree")

    # one optimizer run: L-BFGS-B over (C, params), 5-fold smoothed AUC
    reset_counts()
    labels = np.array([1.0] * N_TRAIN + [-1.0] * N_TRAIN)
    kernel_s = []

    def kernel_fn(q):
        t0 = time.perf_counter()
        out = bpla_optimizer.bpla_matrix_with_grads(feats, table, q, device=dev, normalize=True)
        kernel_s.append(time.perf_counter() - t0)
        return out

    t0 = time.perf_counter()
    opt_params, opt_c, opt_f = optimize_kernel_params(
        labels, kernel_fn, params, 1.0, lower=bpla_optimizer.LOWER,
        upper=bpla_optimizer.UPPER, bound_types=bpla_optimizer.BOUND_TYPES, ncv=5,
        max_steps=OPT_RUN_STEPS)
    opt_s = time.perf_counter() - t0
    check(bool(np.isfinite(opt_params).all() and np.isfinite(opt_f)),
          "the optimizer run ended on a non-finite point")
    host_s = opt_s - sum(kernel_s)
    print(f"optimizer run on {smi} (N={n}, ncv=5, max_steps={OPT_RUN_STEPS}, normalize): "
          f"{opt_s:.3f} s, "
          f"{len(kernel_s)} K+dK evaluations ({sum(kernel_s):.3f} s; "
          f"{sum(kernel_s) / len(kernel_s):.3f} s each), SVM, CG and the rest on the host "
          f"{host_s:.3f} s ({host_s / len(kernel_s):.3f} s an evaluation); an objective "
          f"evaluation {opt_s / len(kernel_s):.3f} s; f {opt_f:.6f}, C {opt_c:g}, params "
          f"{opt_params}")
    no_kernels("optimizer run")

    # the bpla_optimizer CLI end to end, --device cuda against --device cpu;
    # normalized: unnormalized K of 48-60 nt reaches 1e29, where the SMO's
    # stopping test (1e-3 on gradients of that size) lies below f64 resolution.
    # Each device runs it on the native SMO (the CLI's solver) and on the
    # numpy SMO (its plain version).  The printed parameters and C, cuda
    # against cpu, are held to 1e-3 on the numpy SMO, as before the native
    # solver came.  On the native SMO the first step and the last objective
    # are held to the same band and the parameters printed beside the two
    # solvers' gap on each device's own K: the line searches ride the SMO's
    # free-SV ties, so rounding of 1e-15 between the solvers or of 5e-7 between
    # the devices' K can part the runs towards other points of a flat objective
    cli_args = ["-n", "--fold", "2", "+1", p("cpos.fa"), "-1", p("cneg.fa")]
    cli = {}
    for solver in ("native", "numpy"):
        for d in ("cuda", "cpu"):
            reset_counts()
            with smo_solver(solver):
                cli[solver, d] = optimizer_cli(["--device", d, *cli_args])
            print(f"bpla_optimizer --device {d} -n --fold 2, {2 * OPT_CLI_N} sequences, "
                  f"{solver} SMO: {cli[solver, d]['s']:.2f} s, {cli[solver, d]['steps']} steps, "
                  f"(C, alpha, beta, gap, ext) {cli[solver, d]['params']}")
            no_kernels(f"bpla_optimizer --device {d}, {solver} SMO")
    for d in ("cuda", "cpu"):
        print(f"bpla_optimizer --device {d}: native against numpy SMO on the same K, last "
              f"parameters max rel {max_rel(cli['native', d]['params'], cli['numpy', d]['params']):.3e}")
    first_err = max_rel(cli["native", "cuda"]["first"], cli["native", "cpu"]["first"])
    f_err = (abs(cli["native", "cuda"]["f"] - cli["native", "cpu"]["f"])
             / abs(cli["native", "cpu"]["f"]))
    native_err = max_rel(cli["native", "cuda"]["params"], cli["native", "cpu"]["params"])
    numpy_err = max_rel(cli["numpy", "cuda"]["params"], cli["numpy", "cpu"]["params"])
    print(f"bpla_optimizer cuda vs cpu, native SMO: first step max rel {first_err:.3e}, last "
          f"objective rel {f_err:.3e} (limit {OPT_CLI_RTOL}), last parameters max rel "
          f"{native_err:.3e}; numpy SMO: last parameters max rel {numpy_err:.3e} "
          f"(limit {OPT_CLI_RTOL})")
    check(first_err <= OPT_CLI_RTOL, "bpla_optimizer: cuda and cpu first steps disagree")
    check(f_err <= OPT_CLI_RTOL, "bpla_optimizer: cuda and cpu last objectives disagree")
    check(numpy_err <= OPT_CLI_RTOL, "bpla_optimizer: cuda and cpu parameters disagree")

    # overflow: a self pair of 80 nt overflows f32, three cross pairs do not
    reset_counts()
    ov_alns = [Alignment(rows=[s]) for s in overflow_seqs]
    ov_feats = bpla_features(ov_alns, bpp_for_alignments(ov_alns, device="cpu"))
    ix, iy = np.array([0, 0, 2, 0]), np.array([0, 1, 3, 2])
    ov = {}
    for key, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        x, y = pick(ov_feats, ix, d), pick(ov_feats, iy, d)
        wp, wu = bpla_score_parts(x["profile"], x["p_left"], x["p_right"], x["p_unpair"],
                                  y["profile"], y["p_left"], y["p_right"], y["p_unpair"],
                                  torch.as_tensor(table, device=d))
        mask = pair_mask(x["length"], wp.shape[1], y["length"], wp.shape[2])
        vals, grads = bpla_kernel_batch(wp, wu, mask, params, with_grads=True)
        ov[key] = (vals.cpu().numpy(), grads.cpu().numpy())
    fin_card, fin_c = np.isfinite(ov["cuda"][0]), np.isfinite(ov["cpu"][0])
    print(f"flank kernel at {OVERFLOW_LEN} nt, pairs (0,0) (0,1) (2,3) (0,2): values cuda "
          f"{ov['cuda'][0]} cpu {ov['cpu'][0]}; dK/dp finite (cuda) "
          f"{np.isfinite(ov['cuda'][1]).all(1)} (cpu) {np.isfinite(ov['cpu'][1]).all(1)}")
    check(fin_c.any() and not fin_c.all(), "the overflow batch has no overflow (or only)")
    check(bool((fin_card == fin_c).all()), "the card's non-finite pairs differ from the CPU's")
    check(max_rel(ov["cuda"][0][fin_c], ov["cpu"][0][fin_c]) <= OPT_RTOL,
          "the overflow batch's finite values disagree")
    no_kernels("flank overflow batch")
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")

    # ---- 17. classic optimizers on a LIBSVM file ----
    t_phase = time.perf_counter()
    crng = np.random.default_rng(SEED + 4)
    pts = crng.normal(size=(CLASSIC_N, 3))
    pts[: CLASSIC_N // 2] += 1.0
    with open(p("classic.svm"), "w") as f:
        for i, row in enumerate(pts):
            label = "+1" if i < CLASSIC_N // 2 else "-1"
            f.write(f"{label} " + " ".join(f"{j + 1}:{v:g}" for j, v in enumerate(row)) + "\n")
    for kind in ("rbf", "poly", "sigmoid"):
        reset_counts()
        t0 = time.perf_counter()
        out = run_cli(getattr(classic_optimizers, f"{kind}_main"), ["--fold", "3", p("classic.svm")])
        check("Optimized Parameters" in out, f"{kind}_optimizer printed no parameters")
        no_kernels(f"{kind}_optimizer ({time.perf_counter() - t0:.1f} s)")
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s")

    # ---- 18. string-family CLIs: train, svm train, predict; cpu against cuda ----
    clis = {"la_kernel_lite": la_kernel_lite.main, "string_kernel": string_kernel.main,
            "simpal": simpal.main}
    train_labels = ["+1"] * N_TRAIN + ["-1"] * N_TRAIN
    talns = [Alignment(rows=[s]) for s in train]
    t_phase = time.perf_counter()
    for name, flags, band in STRING_CLIS:
        label = " ".join([name, *flags])
        tag = "_".join([name, *flags]).replace("-", "")
        main_fn = clis[name]
        reset_counts()
        t0 = time.perf_counter()
        main_fn(["--device", "cuda", *flags, "-n", p(f"{tag}.dat"),
                 "+1", p("pos.fa"), "-1", p("neg.fa")])
        train_s = time.perf_counter() - t0
        svm_tools.train_main([p(f"{tag}.dat"), p(f"{tag}.model")])
        t0 = time.perf_counter()
        main_fn(["--device", "cuda", *flags, "-n", p(f"{tag}_test.dat"),
                 "--model", p(f"{tag}.model"), "--predict", p(f"{tag}_pred.txt"),
                 "+1", p("pos.fa"), "-1", p("neg.fa"),
                 "--test", "+1", p("tpos.fa"), "-1", p("tneg.fa")])
        predict_s = time.perf_counter() - t0
        string = name != "simpal"  # la_kernel_lite and string_kernel run the string kernel
        no_kernels(label, string)
        got_labels, gram = read_precomputed(p(f"{tag}.dat"))
        gram_checks(label, gram, n, got_labels, train_labels)
        auc = predictions(p(f"{tag}_pred.txt"), 2 * N_TEST, label)
        for d in ("cuda", "cpu"):
            main_fn(["--device", d, *flags, "-n", p(f"{tag}_small_{d}.dat"),
                     "+1", p("spos.fa"), "-1", p("sneg.fa")])
        diff = float(np.abs(read_precomputed(p(f"{tag}_small_cuda.dat"))[1]
                            - read_precomputed(p(f"{tag}_small_cpu.dat"))[1]).max())
        # the train Gram alone, on the CLI's features and kernel
        if name == "la_kernel_lite":
            weights = loop_profile_weights(talns, device=dev) if flags else None
            gram_feats = string_kernel_features(talns, weights=weights)
            sk = StringKernel(0.6, alpha=0.2).to(dev)

            def kernel_fn(x, y, sk=sk):
                return sk(x["profile"], x["length"], y["profile"], y["length"],
                          wx=x["weight"], wy=y["weight"])
        elif name == "string_kernel":
            gram_feats = plain_string_features(train)

            def kernel_fn(x, y):
                return plain_string_kernel(x["codes"], x["length"], y["codes"], y["length"], 1.0)
        else:
            gram_feats = {"pal": np.stack([pal_features(s, b) for s, b in zip(
                train, fold_sequences(train, device=dev))])}
            kernel_fn = simpal_kernel_fn(device=dev)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        PairKernelEngine(kernel_fn, gram_feats, device=dev).gram(normalize=True)
        torch.cuda.synchronize()
        gram_s = time.perf_counter() - t0
        busy = device_busy(PairKernelEngine(kernel_fn, gram_feats, device=dev), n, "")
        no_kernels(f"{label} Gram", string)
        print(f"{label} on {smi}: train Gram {gram.shape}, {n_pairs / gram_s:.1f} pairs/s "
              f"({gram_s:.3f} s, batch 256; first 20 batches traced: {busy}); train flow "
              f"{train_s:.2f} s, predict flow {2 * N_TEST / predict_s:.2f} rows/s "
              f"({predict_s:.2f} s), AUC {auc:.4f}; {2 * SMALL_N} sequences cuda vs cpu: "
              f"Gram max abs diff {diff:.3e} (band {band})")
        check(diff <= band, f"{label}: cuda and cpu Grams disagree")
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    tmp_dir.cleanup()


def string_profiles(rng: np.random.Generator, n: int, lo: int, hi: int, pad: int,
                    wmax: float) -> tuple:
    """(profiles (n, pad, 4), weights (n, pad), lengths (n,)): Dirichlet
    columns, a tenth of them all-gap (zero), a tenth of the weights 0 and the
    rest U(0, wmax), lengths lo..hi, zero past each length."""
    lens = rng.integers(lo, hi + 1, n).astype(np.int32)
    prof = rng.dirichlet(np.ones(4), size=(n, pad)).astype(np.float32)
    prof[rng.random((n, pad)) < 0.1] = 0.0
    w = rng.uniform(0, wmax, (n, pad)).astype(np.float32)
    w[rng.random((n, pad)) < 0.1] = 0.0
    past = np.arange(pad)[None, :] >= lens[:, None]
    prof[past] = 0.0
    w[past] = 0.0
    return prof, w, lens


def string_case(rng: np.random.Generator, b: int, xs: tuple, ys: tuple, wmax: float,
                dev) -> list:
    """[px, lx, py, ly, wx, wy] of ``b`` random pairs on ``dev``; ``xs``,
    ``ys``: (shortest, longest, padded width) of each side."""
    px, wx, lx = string_profiles(rng, b, *xs, wmax)
    py, wy, ly = string_profiles(rng, b, *ys, wmax)
    return [torch.as_tensor(a, device=dev) for a in (px, lx, py, ly, wx, wy)]


def exact_case(rng: np.random.Generator, b: int, xs: tuple, ys: tuple, gap: float,
               dev) -> torch.Tensor:
    """The exact-match score tensor (B, Lx, Ly) of ``b`` random RNA code
    pairs, as the string_kernel CLI builds it."""
    from stem_kernel_torch.models.string_kernel import exact_match_scores

    def side(lo, hi, pad):
        return (torch.as_tensor(rng.integers(0, 4, (b, pad)).astype(np.uint8), device=dev),
                torch.as_tensor(rng.integers(lo, hi + 1, b).astype(np.int32), device=dev))

    (x, lx), (y, ly) = side(*xs), side(*ys)
    return exact_match_scores(x, lx, y, ly, gap)


def string_phase(dev, smi: str) -> dict:
    """Phase 22: the string kernel's DP kernel (csrc/string_dp.cu) against
    the plain row loop on the card, in both score modes; bit-identical
    values alone, at batch 256, at another batch position and padded wider;
    its time against the plain loop's and its bound.  Returns its entry of
    the kernels line (no launches: phase 4 counts them)."""
    from stem_kernel_torch.io.profile import Alignment
    from stem_kernel_torch.models.composite import StemLiteConfig, featurize_stem_examples
    from stem_kernel_torch.models.string_kernel import (
        StringKernel, gap_weighted_string_kernel, gap_weighted_string_kernel_reference,
    )
    from stem_kernel_torch.utils.shuffle import dinucleotide_shuffle

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 22)
    cfg = StemLiteConfig()
    ribosum = StringKernel(cfg.gap, alpha=cfg.alpha).to(dev)
    mm = StringKernel(cfg.gap, match=cfg.str_match, mismatch=cfg.str_mismatch).to(dev)
    worst = {"max_rel_err": 0.0, "max_abs_err": 0.0}

    def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
        d = (got.double() - want.double()).abs()
        return float(d.max()), float((d / want.double().abs()).max())

    def parity(label: str, kernel, plain) -> torch.Tensor:
        before = counter("string.calls.kernel")
        got = kernel()
        torch.cuda.synchronize()
        check(counter("string.calls.kernel") == before + 1, f"{label}: no string DP launch")
        want = plain()
        check(bool(torch.isfinite(want).all()), f"{label}: the plain loop is not finite")
        check(bool(torch.isfinite(got).all()), f"{label}: the kernel is not finite")
        ab, rel = rel_err(got, want)
        worst["max_rel_err"] = max(worst["max_rel_err"], rel)
        worst["max_abs_err"] = max(worst["max_abs_err"], ab)
        print(f"string DP parity, {label}: max rel {rel:.3e} (gate {KERNEL_RTOL}), values "
              f"{float(want.min()):.4g}..{float(want.max()):.4g}")
        check(rel <= KERNEL_RTOL, f"{label}: the string DP kernel disagrees with the plain loop")
        return got

    def same_bits(label: str, got: torch.Tensor, want: torch.Tensor) -> None:
        check(torch.equal(got, want), f"{label}: not bit-identical")

    # the Gram's shapes: stem_kernel_lite's string features of 200 sequences
    # of 110-150 nt, 256 random pairs
    seqs = [s for length in STRING_LENS for s in make_family(rng, STRING_FAMILY, length)]
    seqs += [dinucleotide_shuffle(s, rng) for s in seqs]
    feats, _ = featurize_stem_examples([Alignment(rows=[s]) for s in seqs], cfg, device=dev)

    def gram_pairs(ix, iy):
        ix, iy = torch.as_tensor(ix, device=dev), torch.as_tensor(iy, device=dev)
        return [feats[k].index_select(0, i) for k, i in (
            ("str_profile", ix), ("str_length", ix), ("str_profile", iy), ("str_length", iy),
            ("str_weight", ix), ("str_weight", iy))]

    ix = rng.integers(0, len(seqs), STRING_BATCH)
    iy = rng.integers(0, len(seqs), STRING_BATCH)
    gram = gram_pairs(ix, iy)
    shape = (f"B={STRING_BATCH} L {int(feats['str_length'].min())}-"
             f"{int(feats['str_length'].max())} (pad {feats['str_profile'].shape[1]})")
    got = parity(f"Gram {shape}, RIBOSUM", lambda: ribosum(*gram),
                 lambda: ribosum.reference(*gram))
    # both f32 evaluations against the plain loop in f64 (not gated)
    exact = StringKernel(cfg.gap, alpha=cfg.alpha).to(dev, torch.float64).reference(
        *[t.double() if t.is_floating_point() else t for t in gram])
    f64 = {name: rel_err(v, exact)[1] for name, v in (
        ("kernel", got), ("plain f32 loop", ribosum.reference(*gram)))}
    print(f"string DP, Gram {shape}, RIBOSUM, max rel against the plain loop in f64: {f64}")
    parity(f"Gram {shape}, match/mismatch", lambda: mm(*gram), lambda: mm.reference(*gram))
    # bit for bit: each of the first 3 pairs alone, the batch rolled by 1, the
    # first 64 pairs, and the batch padded 40 columns wider on both sides
    for k in range(3):
        same_bits(f"Gram pair {k} alone", ribosum(*gram_pairs(ix[k:k + 1], iy[k:k + 1])),
                  got[k:k + 1])
    same_bits("Gram batch rolled by 1", ribosum(*gram_pairs(np.roll(ix, 1), np.roll(iy, 1))),
              torch.roll(got, 1))
    same_bits("Gram first 64 pairs", ribosum(*gram_pairs(ix[:64], iy[:64])), got[:64])
    wide = [torch.nn.functional.pad(t, (0, 0, 0, 40) if t.dim() == 3 else (0, 40))
            if t.dim() > 1 else t for t in gram]
    same_bits("Gram padded 40 columns wider", ribosum(*wide), got)

    # widths around the 32-column chunks and a long row, Lx = Ly and Lx != Ly;
    # zero weights and all-gap columns in every case
    for width in STRING_EDGES:
        other = STRING_OTHER[width]
        wmax = 1.0 if max(width, other) <= 150 else STRING_WIDE_W
        b = STRING_EDGE_BATCH
        for lab, xs, ys in (("Lx = Ly", (width, width, width), (width, width, width)),
                            ("Lx != Ly", (width, width, width), (1, other, other))):
            case = string_case(rng, b, xs, ys, wmax, dev)
            kern = ribosum if lab == "Lx = Ly" else mm
            got = parity(f"profiles {lab} {xs[2]} x {ys[2]}, B={b}",
                         lambda: kern(*case), lambda: kern.reference(*case))
            alone = [t[1:2].contiguous() for t in case]
            same_bits(f"profiles {lab} {xs[2]} x {ys[2]} pair 1 alone", kern(*alone), got[1:2])
        gap = cfg.gap if max(width, other) <= 150 else STRING_WIDE_GAP
        scores = exact_case(rng, b, (1, width, width), (1, other, other), gap, dev)
        got = parity(f"exact-match scores {width} x {other}, B={b}, gap {gap}",
                     lambda: gap_weighted_string_kernel(scores, gap),
                     lambda: gap_weighted_string_kernel_reference(scores, gap))
        same_bits(f"exact-match scores {width} x {other} pair 1 alone",
                  gap_weighted_string_kernel(scores[1:2].contiguous(), gap), got[1:2])

    # times at the Gram's shape (CUDA events; plain, kernel, kernel, plain), a
    # call's device time (CUDA graph) and the bound
    def kernel():
        return ribosum(*gram)

    def plain():
        return ribosum.reference(*gram)

    k3_ms, p_ms = timed_pair(kernel, plain, 3)
    k_ms = cuda_ms(kernel, 50)
    dev_ms = graph_ms(kernel, 50)
    cells = float((gram[1].double() * gram[3].double()).sum())
    nbytes = sum(t.numel() * t.element_size() for t in gram) + 4 * STRING_BATCH
    bound_ms, bound_by = bound(nbytes, STRING_PROFILE_OPS * cells)
    scores = exact_case(rng, STRING_BATCH, (110, 150, 152), (110, 150, 152), cfg.gap, dev)
    s_ms, sp_ms = timed_pair(lambda: gap_weighted_string_kernel(scores, cfg.gap),
                             lambda: gap_weighted_string_kernel_reference(scores, cfg.gap), 3)
    long_case = string_case(rng, STRING_EDGE_BATCH, (LONG_LY, LONG_LY, LONG_LY),
                            (LONG_LY, LONG_LY, LONG_LY), STRING_WIDE_W, dev)
    l_ms, lp_ms = timed_pair(lambda: ribosum(*long_case), lambda: ribosum.reference(*long_case), 1)
    print(f"times on {smi}: string DP (profiles) {k_ms:.4f} ms a call ({k3_ms:.4f} in turns "
          f"with the plain loop), device {dev_ms:.4f} ms (graph), plain loop {p_ms:.3f} ms, bound {bound_ms:.5f} ms by {bound_by} "
          f"({cells:.0f} cells, {STRING_PROFILE_OPS} operations a cell; {shape}); exact-match "
          f"scores {s_ms:.4f} ms vs plain {sp_ms:.3f} ms (B={STRING_BATCH}, 152 x 152); "
          f"{LONG_LY} x {LONG_LY} profiles {l_ms:.3f} ms vs plain {lp_ms:.3f} ms "
          f"(B={STRING_EDGE_BATCH})")
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return {**worst, "ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "shape": shape}


def fold_ops(lengths, tab) -> float:
    """Operations the fold DP kernel does for sequences of ``lengths``: per
    lane and row, the interior offsets that reach a row (a multiply-add
    each), the multiloop split sums (inside: 5 a term; outside: 3 a term of
    the Om row, 5 of Om1's) and FOLD_ROW_OPS."""
    total = 0.0
    for L in np.asarray(lengths, np.int64):
        d = np.arange(1, L)
        lanes = L - d
        k_in = np.array([int((tab.t < x).sum()) for x in d], np.float64)
        k_out = np.array([int((tab.t < L - x).sum()) for x in d], np.float64)
        inside = lanes * (2 * k_in + 5 * np.maximum(d - 2, 0) + FOLD_ROW_OPS)
        i_sum = lanes * (lanes - 1) / 2  # sum over lanes i of i
        om_row = 3 * np.maximum(lanes - 2, 0) * np.maximum(lanes - 1, 0) / 2
        outside = lanes * (2 * k_out + FOLD_ROW_OPS) + 5 * i_sum + om_row
        total += float(inside.sum() + outside.sum())
    return total


def fold_inputs(case: tuple, rng: np.random.Generator):
    """(codes, lengths, parameters, keyword arguments) of a FOLD_CASES case:
    hairpin families and their shuffles, as the benchmark's corpus."""
    from stem_kernel_torch.fold.contrafold import contrafold_energy_params, default_weights
    from stem_kernel_torch.fold.params import default_params, fast_variant
    from stem_kernel_torch.io.alphabet import encode
    from stem_kernel_torch.utils.shuffle import dinucleotide_shuffle

    _, bsz, lo, hi, variant = case
    lens = rng.integers(lo, hi + 1, bsz)
    lens[0] = hi
    seqs = []
    for L in lens:
        s = make_family(rng, 1, int(L))[0]
        seqs.append(dinucleotide_shuffle(s, rng) if rng.random() < 0.5 else s)
    codes = np.zeros((bsz, hi), np.uint8)
    for b, s in enumerate(seqs):
        codes[b, :len(s)] = encode(s)
    params = {"default": default_params, "fast": lambda: fast_variant(default_params()),
              "contrafold": lambda: contrafold_energy_params(default_weights())}[variant]()
    return codes, lens.astype(np.int32), params, {}


def fold_alifold_inputs(rng: np.random.Generator):
    """The alifold case: FOLD_ALIFOLD's alignments padded as
    fold.bpmatrix.alifold_bpps pads them on the card (w_extra, pt_override,
    all-gap dummies of length 0)."""
    from stem_kernel_torch.fold.bpmatrix import alifold_covariance
    from stem_kernel_torch.fold.params import default_params

    from stem_kernel_torch.io.profile import Alignment

    n_aln, dummies, rows, width = FOLD_ALIFOLD
    alns = [Alignment(rows=r) for r in make_alignments(rng, make_family(rng, n_aln, 120),
                                                       *ALI_COLS)]
    bsz = n_aln + dummies
    codes = np.full((bsz, rows, width), 4, np.int64)
    w_extra = np.zeros((bsz, width, width), np.float32)
    pt = np.full((bsz, width, width), -1, np.int32)
    lens = np.zeros(bsz, np.int64)
    for b, aln in enumerate(alns):
        _, we, pm, code = alifold_covariance(aln)
        n = aln.length
        codes[b, :code.shape[0], :n] = code
        w_extra[b, :n, :n] = we
        pt[b, :n, :n] = pm
        lens[b] = n
    return codes, lens, default_params(), {"w_extra": w_extra, "pt_override": pt}


def fold_phase(smi: str) -> dict:
    """Phase 23: the fold DP kernel (csrc/fold_dp.cu) against the plain
    engine on the card at each case's shape: BPP and log Z within their
    bands, one launch and one ``fold.batches.kernel`` a fold; a call's time
    (the kernel's wrapper; the whole fold with its LUTs) against the plain
    engine's, the kernel's device time and the launches of a whole fold
    (torch.profiler), and its bound.  Returns its entry of the kernels line
    (no launches: phase 4 counts them)."""
    from stem_kernel_torch.fold import mccaskill_scaled as ms
    from stem_kernel_torch.ops import fold_dp

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 23)
    dev = torch.device("cuda")
    out, launch_counts = {"max_abs_err": 0.0, "max_rel_err": 0.0}, {}
    cases = [(c[0], lambda c=c: fold_inputs(c, rng)) for c in FOLD_CASES]
    cases.insert(2, ("alifold", lambda: fold_alifold_inputs(rng)))
    for label, make in cases:
        codes, lens, params, kw = make()
        fold = lambda: ms.mccaskill_bpp_batch_scaled(codes, lens, params, device=dev, **kw)  # noqa: E731,B023
        plain = lambda: ms.mccaskill_bpp_batch_scaled_reference(codes, lens, params, device=dev, **kw)  # noqa: E731,B023
        before, launched = counter("fold.batches.kernel"), fold_dp.launches()
        got_bpp, got_z = fold()
        torch.cuda.synchronize()
        check(counter("fold.batches.kernel") == before + 1 and fold_dp.launches() == launched + 1,
              f"fold {label}: not one fold DP launch")
        t0 = time.perf_counter()
        want_bpp, want_z = plain()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check(bool(torch.isfinite(got_bpp).all() and torch.isfinite(got_z).all()),
              f"fold {label}: the kernel is not finite")
        bpp_err = float((got_bpp - want_bpp).abs().max())
        z_err = float(((got_z - want_z).abs() / want_z.abs().clamp(min=1e-30)).max())
        same = float((got_bpp == want_bpp).float().mean())
        bits = bool(torch.equal(got_bpp, want_bpp) and torch.equal(got_z, want_z))
        print(f"fold DP parity, {label} (B={len(lens)}, n={codes.shape[-1]}, lengths "
              f"{int(lens.min())}-{int(lens.max())}): BPP max abs {bpp_err:.3e} (gate "
              f"{FOLD_BPP_ATOL}), log Z max rel {z_err:.3e} (gate {FOLD_LOGZ_RTOL}); BPP values "
              f"equal bit for bit {same:.6f}, the whole fold {bits}")
        check(bpp_err <= FOLD_BPP_ATOL, f"fold {label}: BPP off the plain engine")
        check(z_err <= FOLD_LOGZ_RTOL, f"fold {label}: log Z off the plain engine")
        if codes.shape[-1] < FOLD_BITS_BELOW:
            check(bits, f"fold {label}: not the plain engine's bits")
        if label in ("family200", "batch64", "fast", "contrafold", "alifold"):
            out["max_abs_err"] = max(out["max_abs_err"], bpp_err)
            out["max_rel_err"] = max(out["max_rel_err"], z_err)
        # times: the wrapper alone on prebuilt LUTs, the whole fold, the plain engine
        with torch.no_grad():
            c, ln, we, po = ms._inputs(codes, lens, kw.get("w_extra"), kw.get("pt_override"), dev)
            tabs = ms._kernel_tables(c, ln, params, we, po)
            ln32 = ln.to(torch.int32)
        kernel = lambda: fold_dp.fold_dp(tabs, ln32, params)  # noqa: E731,B023
        reps = 3 if label in ("past_ring", "n1000") else 10
        k_ms = cuda_ms(kernel, reps)
        f_ms = cuda_ms(fold, reps)
        dev_ms, k_launches = kernel_trace(kernel, 2, "fold_dp")
        all_ms, _ = kernel_trace(fold, 2, "")
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fold()
            torch.cuda.synchronize()
        launch_counts[label] = sum(e.count for e in prof.key_averages()
                                   if e.device_type == torch.autograd.DeviceType.CUDA)
        tab = fold_dp.offset_table(params)
        ops = fold_ops(lens, tab)
        n_tabs = len(fold_dp.table_names(params))
        rows = codes.shape[1] if codes.ndim == 3 else 1
        nbytes = 4 * (n_tabs * float((lens.astype(np.float64) * (lens + 1) / 2).sum())
                      + len(lens) * codes.shape[-1] ** 2)
        bound_ms, bound_by = bound(nbytes, ops)
        smem, vec_bytes = fold_dp.route(codes.shape[-1], params)
        dev_s = "not measured" if dev_ms is None else f"{dev_ms:.4f}"
        print(f"fold DP times on {smi}, {label}: kernel {k_ms:.4f} ms a call (device {dev_s} ms, "
              f"{k_launches} launches), whole fold {f_ms:.3f} ms (device {all_ms} ms, "
              f"{launch_counts[label]} launches, the LUT builds' and the kernel's), plain engine "
              f"{1e3 * plain_s:.1f} ms; bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} "
              f"operations, {nbytes:.3e} bytes); work vectors in "
              f"{'shared' if smem else 'device'} memory ({vec_bytes} bytes a block; "
              f"{rows} rows an entry)")
        if label == "family200":
            out.update({"ms": k_ms, "device_ms": dev_ms, "fold_ms": f_ms,
                        "plain_ms": 1e3 * plain_s, "bound_ms": bound_ms, "bound_by": bound_by,
                        "launches_a_call": k_launches,
                        "shape": f"B={len(lens)}, n={codes.shape[-1]}, lengths "
                                 f"{int(lens.min())}-{int(lens.max())}"})
    check(launch_counts["n1000"] <= launch_counts["family200"],
          f"a fold's launches grow with n: {launch_counts}")
    print(f"fold DP, launches of a whole fold by case: {launch_counts}")
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s")
    return out


def fold_main() -> int:
    """Phase 23 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"FD": fold_phase(smi)}))
    return 0


def cpu_model() -> str:
    """The host CPU's model name, or its vendor, family and model numbers
    where /proc/cpuinfo names none; with the count of CPUs."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    name = info.get("model name", "unknown")
    if name in ("", "unknown"):
        name = (f"unnamed CPU (vendor {info.get('vendor_id', '?')}, family "
                f"{info.get('cpu family', '?')} model {info.get('model', '?')})")
    return f"{name}, {os.cpu_count()} CPUs"


def make_alignments(rng: np.random.Generator, cores: list[str], lo: int, hi: int) -> list:
    """One alignment a hairpin core (a stem of a third of its length, a loop,
    the stem's reverse complement, as ``make_family`` builds them): ALI_ROWS
    rows with compensatory (10%) and single (5%) mutations on the stem and
    10% on the loop, the loop resized so the alignment has lo..hi columns,
    and about ALI_GAP gap cells."""
    comp = {"a": "u", "c": "g", "g": "c", "u": "a"}
    out = []
    for core in cores:
        k = len(core) // 3
        cols = int(rng.integers(lo, hi + 1))
        loop = list(core[k:len(core) - k])
        loop = (loop + list(rng.choice(list("acgu"), max(0, cols - 2 * k - len(loop)))))
        loop = loop[:cols - 2 * k]
        rows = []
        for _ in range(ALI_ROWS):
            s, rc = list(core[:k]), list(core[len(core) - k:])
            for i in range(k):
                u = rng.random()
                if u < 0.1:  # compensatory: both bases of the pair
                    b = str(rng.choice(list("acgu")))
                    s[i], rc[k - 1 - i] = b, comp[b]
                elif u < 0.15:
                    s[i] = str(rng.choice(list("acgu")))
            lp = [str(rng.choice(list("acgu"))) if rng.random() < 0.1 else c for c in loop]
            rows.append("".join("-" if rng.random() < ALI_GAP else c for c in s + lp + rc))
        out.append(rows)
    return out


def shuffle_alignments(rng: np.random.Generator, alns: list) -> list:
    """Negatives: each row's residues permuted, its gaps kept in place."""
    out = []
    for rows in alns:
        shuffled = []
        for r in rows:
            idx = [i for i, c in enumerate(r) if c != "-"]
            row = list(r)
            for i, c in zip(idx, rng.permutation([r[i] for i in idx])):
                row[i] = str(c)
            shuffled.append("".join(row))
        out.append(shuffled)
    return out


def write_clustal(path: str, alns: list, prefix: str) -> str:
    with open(path, "w") as f:
        for a, rows in enumerate(alns):
            f.write("CLUSTAL W\n\n" + "".join(f"{prefix}{a}_{r} {row}\n"
                                              for r, row in enumerate(rows)) + "\n")
    return path


def trainer_examples(rng: np.random.Generator) -> list[tuple[str, str]]:
    """TRAIN_EXAMPLES (sequence, dot-bracket) hairpins of TRAIN_LEN nt: a
    4-7 nt loop, a stem of up to 8 bp (5 where the length allows), an
    unpaired tail."""
    comp = {"a": "u", "c": "g", "g": "c", "u": "a"}
    out = []
    for _ in range(TRAIN_EXAMPLES):
        n = int(rng.integers(TRAIN_LEN[0], TRAIN_LEN[1] + 1))
        loop = int(rng.integers(4, 8))
        k = min(int(rng.integers(5, 9)), (n - loop) // 2)
        stem = "".join(rng.choice(list("acgu"), k))
        seq = (stem + "".join(rng.choice(list("acgu"), loop))
               + "".join(comp[c] for c in reversed(stem))
               + "".join(rng.choice(list("acgu"), n - 2 * k - loop)))
        out.append((seq, "(" * k + "." * loop + ")" * k + "." * (n - 2 * k - loop)))
    return out


def sfold_draws(seq: str, device) -> tuple[np.ndarray, list]:
    """sfold_bpp(seq, SFOLD_SAMPLES, seed=0) on ``device``, and every draw's
    (choice, its probability)."""
    from stem_kernel_torch.fold import sampling

    draws = []
    plain = sampling._softmax_choice

    def recorded(rng, logw):
        c = plain(rng, logw)
        p = np.exp(logw - logw.max())
        draws.append((c, float(p[c] / p.sum())))
        return c

    sampling._softmax_choice = recorded
    try:
        bpp = sampling.sfold_bpp(seq, SFOLD_SAMPLES, seed=0, device=device)
    finally:
        sampling._softmax_choice = plain
    return bpp, draws


def slice6_phase(dev, smi: str, reset_counts, counts, corpus: tuple) -> None:
    """Phase 20: the rest of the fold layer at full width.  ``corpus``:
    phase 4's (pos, neg, tpos, tneg)."""
    from stem_kernel_torch.cli import bpla_kernel, stem_kernel_lite, svm_tools
    from stem_kernel_torch.fold.bpmatrix import (
        BPMatrixOptions, alifold_bpp, bpp_for_alignments,
    )
    from stem_kernel_torch.fold.contrafold import (
        contrafold_bpp, default_weights, save_contrafold_params, train_contrafold,
    )
    from stem_kernel_torch.fold.mccaskill import mccaskill_bpp
    from stem_kernel_torch.fold.mccaskill_scaled import mccaskill_bpp_batch_scaled
    from stem_kernel_torch.gram.engine import PairKernelEngine
    from stem_kernel_torch.gram.io import read_precomputed
    from stem_kernel_torch.io.alphabet import encode
    from stem_kernel_torch.io.profile import Alignment
    from stem_kernel_torch.models.bpla import BPLAKernel
    from stem_kernel_torch.models.featurize import bpla_features

    t_phase = time.perf_counter()
    pos, neg, tpos, tneg = corpus
    golden_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")
    method = np.load(os.path.join(golden_dir, "method_bpp.npz"))
    folds = np.load(os.path.join(golden_dir, "fold_bpp.npz"))
    names = lambda data, pre: sorted({k.split("__")[0] for k in data.files  # noqa: E731
                                      if k.startswith(pre)})
    text = lambda data, key: data[key].tobytes().decode()  # noqa: E731
    tmp_dir = tempfile.TemporaryDirectory()
    p = lambda f: os.path.join(tmp_dir.name, f)  # noqa: E731
    rng = np.random.default_rng(SEED + 20)
    ali = make_alignments(rng, pos + tpos, *ALI_COLS)
    ali_neg = shuffle_alignments(rng, ali)
    sets = {"apos": ali[:N_TRAIN], "aneg": ali_neg[:N_TRAIN], "atpos": ali[N_TRAIN:],
            "atneg": ali_neg[N_TRAIN:], "aspos": ali[:SMALL_N], "asneg": ali_neg[:SMALL_N]}
    for name, alns in sets.items():
        write_clustal(p(f"{name}.aln"), alns, name)
    fasta = {"pos": write_fasta(p("pos.fa"), pos, "p"), "neg": write_fasta(p("neg.fa"), neg, "n")}
    alns = [Alignment(rows=r) for r in ali[:N_TRAIN] + ali_neg[:N_TRAIN]]
    n = len(alns)
    n_pairs = n * (n + 1) // 2
    train_labels = ["+1"] * N_TRAIN + ["-1"] * N_TRAIN
    ali_opts = BPMatrixOptions(alifold=True)

    # ---- (a) alifold: bpla_kernel -n --use-alifold train, svm train, predict ----
    reset_counts()
    t0 = time.perf_counter()
    run_cli(bpla_kernel.main, ["--device", "cuda", "--use-alifold", "-n", p("ali.dat"),
                               "+1", p("apos.aln"), "-1", p("aneg.aln")])
    ali_train_s = time.perf_counter() - t0
    k2_train = counts()["K2"]
    svm_tools.train_main([p("ali.dat"), p("ali.model")])
    run_cli(bpla_kernel.main, ["--device", "cuda", "--use-alifold", "-n", p("ali_test.dat"),
                               "--model", p("ali.model"), "--predict", p("ali_pred.txt"),
                               "+1", p("apos.aln"), "-1", p("aneg.aln"),
                               "--test", "+1", p("atpos.aln"), "-1", p("atneg.aln")])
    ali_counts = counts()
    labels, g_ali = read_precomputed(p("ali.dat"))
    gram_checks("bpla_kernel --use-alifold", g_ali, n, labels, train_labels)
    auc = predictions(p("ali_pred.txt"), 2 * N_TEST, "bpla_kernel --use-alifold")
    cols = [a.length for a in alns]
    print(f"alifold path: {n} alignments of {ALI_ROWS} rows, {min(cols)}-{max(cols)} columns, "
          f"train Gram {g_ali.shape} in {ali_train_s:.2f} s, K2 launches {k2_train} (train) "
          f"{ali_counts['K2']} (train + predict); all counts {ali_counts}; predict: "
          f"{2 * N_TEST} rows, AUC {auc:.4f}")
    check(k2_train > 0 and ali_counts["K2"] > k2_train,
          "the alifold BPLA path did not launch K2 in train and predict")
    for d in ("cuda", "cpu"):
        bpla_kernel.main(["--device", d, "--use-alifold", "-n", p(f"sali_{d}.dat"),
                          "+1", p("aspos.aln"), "-1", p("asneg.aln")])
    small_diff = float(np.abs(read_precomputed(p("sali_cuda.dat"))[1]
                              - read_precomputed(p("sali_cpu.dat"))[1]).max())
    small = [Alignment(rows=r) for r in ali[:SMALL_N] + ali_neg[:SMALL_N]]
    bpp_diff = max(float(np.abs(a - b).max()) for a, b in zip(
        bpp_for_alignments(small, ali_opts, device=dev),
        bpp_for_alignments(small, ali_opts, device="cpu")))
    print(f"alifold, {2 * SMALL_N} alignments, cuda vs cpu: Gram max abs diff {small_diff:.3e} "
          f"(band {BPLA_BAND}), BPP max abs diff {bpp_diff:.3e} (band {BPP_BAND})")
    check(small_diff <= BPLA_BAND, "alifold: cuda and cpu Grams disagree")
    check(bpp_diff <= BPP_BAND, "alifold: cuda and cpu folds disagree")
    batched = bpp_for_alignments(alns[:ALI_BATCH_N], ali_opts, device=dev)
    alone = [alifold_bpp(a, device=dev) for a in alns[:ALI_BATCH_N]]
    batch_diff = max(float(np.abs(a - b).max()) for a, b in zip(batched, alone))
    equal = sum(np.array_equal(a, b) for a, b in zip(batched, alone))
    print(f"alifold on the card, {ALI_BATCH_N} alignments batched against one at a time: max abs "
          f"diff {batch_diff:.3e} (limit {ALI_BATCH_ATOL}); bit for bit: {equal} of {ALI_BATCH_N}")
    check(batch_diff <= ALI_BATCH_ATOL, "alifold: batched and one-at-a-time folds disagree")
    gold = []
    for nm in names(method, "ali_"):
        got = alifold_bpp(Alignment(rows=text(method, f"{nm}__rows").split("\n")), device=dev)
        gold.append(float(np.abs(got - method[f"{nm}__bpp"]).max()))
    print(f"alifold ali_* goldens on the card: max abs diff {', '.join(f'{e:.3e}' for e in gold)} "
          f"(limit {GOLDEN_ATOL})")
    check(max(gold) <= GOLDEN_ATOL, "alifold: an ali_* golden disagrees")
    bpp_for_alignments(small, ali_opts, device=dev)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bpps = bpp_for_alignments(alns, ali_opts, device=dev)
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    feats = bpla_features(alns, bpps)
    kernel = BPLAKernel().to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    PairKernelEngine(kernel.log_value, feats, device=dev, batch_size=LA_BATCH,
                     log_values=True).gram(normalize=True)
    torch.cuda.synchronize()
    gram_s = time.perf_counter() - t0
    print(f"times on {smi}: alifold fold {n / fold_s:.1f} alignments/s ({fold_s:.2f} s for {n}), "
          f"alifold BPLA Gram {n_pairs / gram_s:.1f} pairs/s ({gram_s:.2f} s, batch {LA_BATCH})")

    # ---- (b) CONTRAfold: stem_kernel_lite and bpla_kernel --use-contrafold ----
    reset_counts()
    t0 = time.perf_counter()
    run_cli(stem_kernel_lite.main, ["--device", "cuda", "--use-contrafold", "default", "-n",
                                    p("cf_stem.dat"), "+1", fasta["pos"], "-1", fasta["neg"]])
    cf_stem_s = time.perf_counter() - t0
    cf_counts, cf_wide = counts(), counter("k1.calls.tiles")
    labels, g = read_precomputed(p("cf_stem.dat"))
    gram_checks("stem_kernel_lite --use-contrafold", g, n, labels, train_labels)
    print(f"stem_kernel_lite --use-contrafold default, {n} sequences of {SEQ_LEN} nt: "
          f"{cf_stem_s:.2f} s, K1 launches {cf_counts['K1']} cluster + {cf_wide} per-product; "
          f"all counts {cf_counts}")
    check(cf_counts["K1"] > 0 and cf_wide > 0,
          "the CONTRAfold stem path did not launch both K1 routes")
    w_path = p("w.params")
    save_contrafold_params(w_path, default_weights())
    cf_out = {}
    for model in ("default", w_path):
        reset_counts()
        out = p(f"cf_bpla_{len(cf_out)}.dat")
        run_cli(bpla_kernel.main, ["--device", "cuda", "--use-contrafold", model, "-n", out,
                                   "+1", fasta["pos"], "-1", fasta["neg"]])
        cf_out[model] = (open(out, "rb").read(), counts()["K2"])
    labels, g = read_precomputed(p("cf_bpla_0.dat"))
    gram_checks("bpla_kernel --use-contrafold", g, n, labels, train_labels)
    same = cf_out["default"][0] == cf_out[w_path][0]
    print(f"bpla_kernel --use-contrafold: K2 launches {cf_out['default'][1]} (default), "
          f"{cf_out[w_path][1]} (weight file); the two matrices byte-equal: {same}")
    check(cf_out["default"][1] > 0 and cf_out[w_path][1] > 0,
          "the CONTRAfold BPLA path did not launch K2")
    check(same, "--use-contrafold with a file of the default weights differs from 'default'")
    gold = []
    for nm in names(method, "contra_"):
        got = contrafold_bpp([text(method, f"{nm}__seq")], device=dev)[0]
        gold.append(float(np.abs(got - method[f"{nm}__bpp"]).max()))
    print(f"contra_* goldens on the card: max abs diff {', '.join(f'{e:.3e}' for e in gold)} "
          f"(limit {GOLDEN_ATOL})")
    check(max(gold) <= GOLDEN_ATOL, "contrafold: a contra_* golden disagrees")

    # ---- (c) the exact log-space fold, f64, on the card ----
    fold_names = names(folds, "")
    seqs = [text(folds, f"{nm}__seq") for nm in fold_names]
    exact, ex_err, z_err = [], 0.0, 0.0
    mccaskill_bpp(encode(seqs[0]), dtype=torch.float64, device=dev)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for nm, s in zip(fold_names, seqs):
        bpp, z = mccaskill_bpp(encode(s), dtype=torch.float64, device=dev)
        exact.append((bpp, z))
        ex_err = max(ex_err, float(np.abs(bpp - folds[f"{nm}__bpp"]).max()))
        z_err = max(z_err, abs(z - float(folds[f"{nm}__logz"])) / abs(float(folds[f"{nm}__logz"])))
    exact_s = (time.perf_counter() - t0) / len(seqs)
    t0 = time.perf_counter()
    for s in seqs[:EXACT_CPU_N]:
        mccaskill_bpp(encode(s), dtype=torch.float64, device="cpu")
    exact_cpu_s = (time.perf_counter() - t0) / EXACT_CPU_N
    nmax = max(len(s) for s in seqs)
    codes = np.zeros((len(seqs), nmax), np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = encode(s)
    sc_bpp, sc_z = mccaskill_bpp_batch_scaled(codes, [len(s) for s in seqs], device=dev)
    sc_bpp, sc_z = sc_bpp.cpu().numpy(), sc_z.cpu().numpy()
    sc_err = max(float(np.abs(sc_bpp[i, :len(s), :len(s)] - exact[i][0]).max())
                 for i, s in enumerate(seqs))
    sc_z_err = max(abs(float(sc_z[i]) - exact[i][1]) / abs(exact[i][1]) for i in range(len(seqs)))
    lens = [len(s) for s in seqs]
    print(f"exact fold, f64 on the card, {len(seqs)} golden sequences of {min(lens)}-{max(lens)} "
          f"nt: BPP max abs diff {ex_err:.3e}, logZ max rel {z_err:.3e} (limit {ORACLE_TOL}); "
          f"the card's scaled f32 fold against it: BPP {sc_err:.3e} (band {BPP_BAND}), logZ "
          f"{sc_z_err:.3e} (band {LOGZ_RTOL})")
    check(ex_err <= ORACLE_TOL and z_err <= ORACLE_TOL, "the exact fold disagrees with its goldens")
    check(sc_err <= BPP_BAND and sc_z_err <= LOGZ_RTOL,
          "the scaled fold disagrees with the exact fold")
    print(f"times on {smi}: exact fold (f64) {1e3 * exact_s:.1f} ms a sequence on the card, "
          f"{1e3 * exact_cpu_s:.1f} ms on the host's CPU ({EXACT_CPU_N} sequences)")

    # ---- (d) SFOLD sampling: the sfold_* goldens bit for bit ----
    for nm in names(method, "sfold_"):
        seq = text(method, f"{nm}__seq")
        got, draws = sfold_draws(seq, dev)
        want = method[f"{nm}__bpp"]
        if np.array_equal(got, want):
            print(f"sfold {nm} ({len(seq)} nt, {SFOLD_SAMPLES} samples, {len(draws)} draws) on "
                  "the card: the golden's pair counts bit for bit")
            continue
        _, cpu_draws = sfold_draws(seq, "cpu")
        k = next((i for i, (a, b) in enumerate(zip(draws, cpu_draws)) if a[0] != b[0]), None)
        moved = ("no draw differs from the CPU's" if k is None else
                 f"draw {k} chose {draws[k][0]} (p {draws[k][1]:.17g}) where the CPU chose "
                 f"{cpu_draws[k][0]} (p {cpu_draws[k][1]:.17g})")
        exact_bpp, _ = mccaskill_bpp(encode(seq), dtype=torch.float64, device=dev)
        err = float(np.abs(got - exact_bpp).max())
        print(f"sfold {nm} on the card differs from its golden: {moved}; against the exact "
              f"BPP max abs {err:.3e} (band {SFOLD_BAND})")
        check(err <= SFOLD_BAND, f"sfold {nm}: outside the Monte-Carlo band")

    # ---- (e) the CONTRAfold trainer: card against CPU ----
    examples = trainer_examples(np.random.default_rng(SEED + 21))
    t0 = time.perf_counter()
    _, card_hist = train_contrafold(examples, steps=TRAIN_STEPS, device=dev)
    torch.cuda.synchronize()
    card_step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    t0 = time.perf_counter()
    _, cpu_hist = train_contrafold(examples, steps=TRAIN_STEPS, device="cpu")
    cpu_step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    hist_err = max_rel(np.asarray(card_hist), np.asarray(cpu_hist))
    print(f"train_contrafold, {TRAIN_EXAMPLES} examples of "
          f"{'-'.join(str(len(s)) for s, _ in examples)} nt, {TRAIN_STEPS} Adam steps: loss "
          f"{card_hist[0]:.6f} -> {card_hist[-1]:.6f}; cuda vs cpu max rel {hist_err:.3e} "
          f"(limit {TRAIN_RTOL}); times on {smi}: a step {card_step_s:.3f} s on the card, "
          f"{cpu_step_s:.3f} s on the host's CPU")
    check(hist_err <= TRAIN_RTOL, "train_contrafold: cuda and cpu loss histories disagree")
    check(card_hist[-1] < card_hist[0], "train_contrafold: the loss did not fall")

    # ---- (f) bpla_optimizer -n --use-alifold --fold 2: cuda against cpu ----
    opt_rng = np.random.default_rng(SEED + 22)
    opt_ali = make_alignments(opt_rng, make_family(opt_rng, OPT_CLI_N, 54), *OPT_LEN)
    write_clustal(p("opos.aln"), opt_ali, "opos")
    write_clustal(p("oneg.aln"), shuffle_alignments(opt_rng, opt_ali), "oneg")
    cli_args = ["-n", "--use-alifold", "--fold", "2", "+1", p("opos.aln"), "-1", p("oneg.aln")]
    cli = {}
    for solver in ("native", "numpy"):
        for d in ("cuda", "cpu"):
            reset_counts()
            with smo_solver(solver):
                cli[solver, d] = optimizer_cli(["--device", d, *cli_args])
            print(f"bpla_optimizer --device {d} -n --use-alifold --fold 2, {2 * OPT_CLI_N} "
                  f"alignments, {solver} SMO: {cli[solver, d]['s']:.2f} s, "
                  f"{cli[solver, d]['steps']} steps, (C, alpha, beta, gap, ext) "
                  f"{cli[solver, d]['params']}; counts {counts()}")
    first_err = max_rel(cli["native", "cuda"]["first"], cli["native", "cpu"]["first"])
    f_err = (abs(cli["native", "cuda"]["f"] - cli["native", "cpu"]["f"])
             / abs(cli["native", "cpu"]["f"]))
    numpy_err = max_rel(cli["numpy", "cuda"]["params"], cli["numpy", "cpu"]["params"])
    native_err = max_rel(cli["native", "cuda"]["params"], cli["native", "cpu"]["params"])
    print(f"bpla_optimizer --use-alifold cuda vs cpu, native SMO: first step max rel "
          f"{first_err:.3e}, last objective rel {f_err:.3e} (limit {OPT_CLI_RTOL}), last "
          f"parameters {native_err:.3e}; numpy SMO: last parameters max rel {numpy_err:.3e} "
          f"(limit {OPT_CLI_RTOL})")
    check(first_err <= OPT_CLI_RTOL, "bpla_optimizer --use-alifold: first steps disagree")
    check(f_err <= OPT_CLI_RTOL, "bpla_optimizer --use-alifold: last objectives disagree")
    check(numpy_err <= OPT_CLI_RTOL, "bpla_optimizer --use-alifold: parameters disagree")
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    tmp_dir.cleanup()


def slice5_phase(dev, smi: str, reset_counts, counts, corpus: tuple, stem: dict,
                 g_bpla: np.ndarray) -> None:
    """Phase 19: the native host code and the Gram-engine options on the
    stem path at full width.  ``corpus``: phase 4's (pos, neg, tpos, tneg);
    ``stem``: phase 4's Gram and walls; ``g_bpla``: phase 7's Gram."""
    from stem_kernel_torch.cli import bpla_kernel, stem_kernel_lite, svm_tools
    from stem_kernel_torch.fold.bpmatrix import fold_sequences
    from stem_kernel_torch.gram.io import read_precomputed
    from stem_kernel_torch.models import dag
    from stem_kernel_torch.models.composite import StemLiteConfig
    from stem_kernel_torch.svm import solver
    from stem_kernel_torch.utils.tracing import COUNTERS_FILE, TRACE_FILE
    from stem_kernel_torch.utils.tracing import PREFIX as PROGRAM_RANGE

    t_phase = time.perf_counter()
    host = f"{cpu_model()} (the host of {smi})"
    pos, neg, tpos, tneg = corpus
    train = pos + neg
    n = len(train)
    cfg = StemLiteConfig()
    tmp_dir = tempfile.TemporaryDirectory()
    p = lambda f: os.path.join(tmp_dir.name, f)  # noqa: E731
    for name, seqs in (("pos", pos), ("neg", neg), ("tpos", tpos), ("tneg", tneg),
                       ("rpos", pos[:TRACE_N]), ("rneg", neg[:TRACE_N])):
        write_fasta(p(f"{name}.fa"), seqs, name)
    train_args = ["+1", p("pos.fa"), "-1", p("neg.fa")]

    def k1() -> int:
        return counter("k1.calls.cluster") + counter("k1.calls.tiles")

    walls = {}

    def stem_train(out: str, *flags) -> np.ndarray:
        t0 = time.perf_counter()
        run_cli(stem_kernel_lite.main, ["--device", "cuda", *flags, "-n", p(out), *train_args])
        walls[out] = time.perf_counter() - t0
        return read_precomputed(p(out))[1]

    # (a) the DAG scan: native against the Python scan on phase 4's BPPs
    bpps = fold_sequences(train, cfg.bp_opts, device=dev)
    nat_s = py_s = 0.0
    nodes = 0
    for bpp in bpps:
        t0 = time.perf_counter()
        got = dag._dag_topology(bpp, len(bpp), cfg.th)
        t1 = time.perf_counter()
        want = dag._dag_topology_python(bpp, len(bpp), cfg.th)
        py_s += time.perf_counter() - t1
        nat_s += t1 - t0
        nodes += len(got[0])
        check(all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, want)),
              "the native DAG scan differs from the Python scan")
    print(f"DAG scan on {host}: native {1e3 * nat_s / n:.3f} ms a sequence, Python "
          f"{1e3 * py_s / n:.3f} ms ({n} sequences of {SEQ_LEN} nt, th {cfg.th}, {nodes} "
          f"nodes); identical arrays")

    # (b) the SMO: native against numpy, tests/test_native.py's tolerances
    y = np.array([1.0] * N_TRAIN + [-1.0] * N_TRAIN)
    r = np.random.default_rng(SEED + 19)
    y2 = np.where(np.arange(SMO_N) < SMO_N // 2, 1.0, -1.0)
    x2 = r.normal(size=(SMO_N, SMO_DIM)) + 0.35 * y2[:, None]
    sq = (x2 * x2).sum(1)
    k2 = np.exp(-(sq[:, None] + sq[None, :] - 2.0 * x2 @ x2.T) / (2 * SMO_DIM))
    k2 = k2.astype(np.float32)
    for label, kk, yy in ((f"phase 4's normalised stem Gram (N={n}, f64)", stem["g"], y),
                          (f"random PSD RBF Gram (N={SMO_N}, f32)", k2, y2)):
        t0 = time.perf_counter()
        nat = solver.smo_solve(kk, yy, -np.ones(len(yy)), 1.0, 1.0)
        t1 = time.perf_counter()
        plain = solver.smo_solve_numpy(kk, yy, -np.ones(len(yy)), 1.0, 1.0)
        t2 = time.perf_counter()
        obj = abs(nat.obj - plain.obj) / abs(plain.obj)
        alpha = float(np.abs(nat.alpha - plain.alpha).max())
        rho = abs(nat.rho - plain.rho)
        print(f"SMO on {host}, {label}: native {nat.n_iter} iterations {t1 - t0:.4f} s, numpy "
              f"{plain.n_iter} iterations {t2 - t1:.4f} s; obj rel {obj:.2e} (limit 1e-8), "
              f"alpha {alpha:.2e}, rho {rho:.2e} (limit 1e-5)")
        check(obj <= 1e-8 and alpha <= 1e-5 and rho <= 1e-5,
              f"SMO on {label}: native and numpy disagree")
    a0 = np.full(n, 0.5)
    t0 = time.perf_counter()
    nat, r_nat = solver.smo_solve_nu(stem["g"], y, np.zeros(n), 1.0, 1.0, a0)
    t1 = time.perf_counter()
    plain, r_plain = solver.smo_solve_nu_numpy(stem["g"], y, np.zeros(n), 1.0, 1.0, a0)
    t2 = time.perf_counter()
    errs = (abs(nat.obj - plain.obj) / max(1.0, abs(plain.obj)), abs(nat.rho - plain.rho),
            abs(r_nat - r_plain), float(np.abs(nat.alpha - plain.alpha).max()))
    print(f"nu-SMO on {host}, the stem Gram, nu 0.5: native {nat.n_iter} iterations "
          f"{t1 - t0:.4f} s, numpy {plain.n_iter} iterations {t2 - t1:.4f} s; obj, rho, r, "
          f"alpha {', '.join(f'{e:.2e}' for e in errs)} (limits 1e-6, 1e-4, 1e-4, 1e-4)")
    check(errs[0] <= 1e-6 and max(errs[1:]) <= 1e-4, "nu-SMO: native and numpy disagree")

    # (c) --checkpoint: a full run, a complete resume, a partial one
    ck = p("ck")
    reset_counts()
    g_ck = stem_train("ck.dat", "--checkpoint", ck)
    full, ck_counts = k1(), counts()
    print(f"stem_kernel_lite -n --checkpoint: {walls['ck.dat']:.2f} s (phase 4's train flow "
          f"{stem['train_s']:.2f} s), K1 launches {full} (phase 4's train: {stem['launches']}); "
          f"all counts {ck_counts}; Gram equal to phase 4's bit for bit: "
          f"{np.array_equal(g_ck, stem['g'])}")
    check(full == stem["launches"], "the checkpointed run launched K1 another number of times")
    check(np.array_equal(g_ck, stem["g"]), "the checkpointed Gram differs from phase 4's")
    reset_counts()
    g_ck = stem_train("ck2.dat", "--checkpoint", ck)
    print(f"resume from a complete checkpoint: {walls['ck2.dat']:.2f} s, K1 launches {k1()}; "
          f"same Gram: {np.array_equal(g_ck, stem['g'])}")
    check(k1() == 0, "a complete checkpoint recomputed units")
    check(np.array_equal(g_ck, stem["g"]), "the resumed Gram differs")
    metas = {}
    for f in os.listdir(ck):
        if f.endswith(".meta.json"):
            with open(os.path.join(ck, f)) as fh:
                metas[f.removesuffix(".meta.json")] = json.load(fh)
    largest = max(metas, key=lambda b: metas[b]["n_pairs"])
    meta = metas[largest]
    done = np.lib.format.open_memmap(os.path.join(ck, f"{largest}.done.npy"), mode="r+")
    cleared = len(done) - len(done) // 2
    done[len(done) // 2:] = False
    done.flush()
    del done
    reset_counts()
    g_ck = stem_train("ck3.dat", "--checkpoint", ck)
    print(f"resume with the last {cleared} of the units of {largest} "
          f"({meta['n_pairs']} pairs, units of {meta['batch_size']}) cleared: "
          f"{walls['ck3.dat']:.2f} s, K1 launches {k1()} (the full run: {full}); same Gram: "
          f"{np.array_equal(g_ck, stem['g'])}")
    check(0 < k1() < full, "the partial resume did not recompute only the cleared units")
    check(np.array_equal(g_ck, stem["g"]), "the partially resumed Gram differs")
    reset_counts()
    run_cli(bpla_kernel.main, ["--device", "cuda", "-n", "--checkpoint", p("bck"),
                               p("bpla.dat"), *train_args])
    g_bck = read_precomputed(p("bpla.dat"))[1]
    bpla_counts = counts()
    print(f"bpla_kernel -n --checkpoint: counts {bpla_counts}; Gram equal to phase 7's bit for "
          f"bit: {np.array_equal(g_bck, g_bpla)}")
    check(bpla_counts["K2"] > 0, "bpla_kernel --checkpoint never launched K2")
    check(np.array_equal(g_bck, g_bpla), "the checkpointed BPLA Gram differs from phase 7's")

    # (d) --trace-dir on 20 + 20 sequences
    small = ["+1", p("rpos.fa"), "-1", p("rneg.fa")]
    t0 = time.perf_counter()
    run_cli(stem_kernel_lite.main, ["--device", "cuda", "-n", p("untraced.dat"), *small])
    untraced_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    run_cli(stem_kernel_lite.main, ["--device", "cuda", "-n", "--trace-dir", p("trace"),
                                    p("traced.dat"), *small])
    traced_s = time.perf_counter() - t0
    launches = {"cluster": counter("k1.calls.cluster"),
                "per-product": counter("k1.calls.tiles")}
    with open(os.path.join(p("trace"), TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    k1_events = {r: [e for e in events if e.get("cat") == "kernel" and kern in e.get("name", "")]
                 for r, kern in (("cluster", "fixed_point_cluster"),
                                 ("per-product", "fixed_point_tiles"))}
    ranges = [e for e in events if e.get("name", "").startswith(PROGRAM_RANGE)]
    on_device = [e for e in ranges if e.get("cat", "").startswith("gpu")]
    stages = sorted({e["name"] for e in ranges})
    with open(os.path.join(p("trace"), COUNTERS_FILE)) as f:
        traced_counts = json.load(f)
    same = np.array_equal(read_precomputed(p("traced.dat"))[1],
                          read_precomputed(p("untraced.dat"))[1])
    print(f"stem_kernel_lite -n --trace-dir, {2 * TRACE_N} sequences: {traced_s:.2f} s "
          f"(untraced {untraced_s:.2f} s), {len(events)} trace events; K1 device events and "
          f"launches counted by route: "
          + "; ".join(f"{r} {len(ev)} ({ev[0]['name'] if ev else 'none'}), {launches[r]} "
                      f"launches" for r, ev in k1_events.items())
          + f"; {len(ranges)} program ranges ({', '.join(stages)}), {len(on_device)} of them "
          f"on the device's timeline; counters {traced_counts}; Gram equal to the untraced "
          f"run's: {same}")
    pairs = TRACE_N * (2 * TRACE_N + 1)
    check(traced_counts.get("gram.pairs") == pairs,
          f"counters.json counts {traced_counts.get('gram.pairs')} Gram pairs, not {pairs}")
    check({PROGRAM_RANGE + s for s in ("read", "featurize", "fold", "gram", "string", "k1",
                                       "write")} <= set(stages),
          "the trace lacks a stage of the program's train flow")
    check(not on_device, "the profiler copied program ranges onto the device's timeline")
    check(sum(launches.values()) > 0, "the traced run launched no K1 kernel")
    for r, n_launches in launches.items():
        check(n_launches == 0 or len(k1_events[r]) > 0,
              f"the trace holds no device events of K1's {r} route, which ran")
    check(same, "the traced Gram differs from the untraced one")

    # (e) the flows' walls with the featurize stage apart, on the native and
    # on the Python scan (its plain version), in one run
    native_scan = dag._dag_topology
    featurizers = {name: getattr(stem_kernel_lite, name)
                   for name in ("featurize_stem_examples", "featurize_stem_bucketed")}
    totals: dict[str, float] = {}  # seconds by "<scan> <flow> flow" and "... featurize"
    flow = ["train"]

    def timed(fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            key = f"{flow[0]} featurize"
            totals[key] = totals.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    flows = {}
    try:
        for name, fn in featurizers.items():
            setattr(stem_kernel_lite, name, timed(fn))
        for scan, topology in (("python", dag._dag_topology_python), ("native", native_scan)):
            dag._dag_topology = topology
            reset_counts()
            flow[0] = f"{scan} train"
            t0 = time.perf_counter()
            g_e = stem_train(f"{scan}.dat")
            totals[f"{scan} train flow"] = time.perf_counter() - t0
            check(np.array_equal(g_e, stem["g"]),
                  f"the {scan} scan's Gram differs from phase 4's")
            svm_tools.train_main([p(f"{scan}.dat"), p(f"{scan}.model")])
            flow[0] = f"{scan} predict"
            t0 = time.perf_counter()
            run_cli(stem_kernel_lite.main, [
                "--device", "cuda", "-n", p(f"{scan}_test.dat"), "--model",
                p(f"{scan}.model"), "--predict", p(f"{scan}_pred.txt"), *train_args,
                "--test", "+1", p("tpos.fa"), "-1", p("tneg.fa")])
            totals[f"{scan} predict flow"] = time.perf_counter() - t0
            check(k1() > 0, f"the {scan} scan's flows never launched K1")
            flows[scan] = {k: v for k, v in totals.items() if k.startswith(scan)}
    finally:
        dag._dag_topology = native_scan
        for name, fn in featurizers.items():
            setattr(stem_kernel_lite, name, fn)
    for scan, t in flows.items():
        print(f"stem flows on {host}, {scan} DAG scan: train {t[f'{scan} train flow']:.2f} s "
              f"(featurize {t[f'{scan} train featurize']:.2f} s), predict "
              f"{t[f'{scan} predict flow']:.2f} s (featurize "
              f"{t[f'{scan} predict featurize']:.2f} s)")
    print(f"phase 4 (native scan, the first flows of the run): train {stem['train_s']:.2f} s, "
          f"predict {stem['predict_s']:.2f} s")

    # (f) the unnormalised bpla_optimizer --fold 2 on phase 16's 20 + 20
    # sequences, which the numpy SMO did not finish in 1,200 s
    fam, shuf, _ = optimizer_corpus()
    write_fasta(p("opos.fa"), fam[:OPT_CLI_N], "opos")
    write_fasta(p("oneg.fa"), shuf[:OPT_CLI_N], "oneg")
    reset_counts()
    run = optimizer_cli(["--device", "cuda", "--fold", "2", "+1", p("opos.fa"),
                         "-1", p("oneg.fa")])
    print(f"bpla_optimizer --fold 2 (unnormalised, native SMO), {2 * OPT_CLI_N} sequences on "
          f"{host}: {run['s']:.2f} s, {run['steps']} steps, last objective {run['f']}, "
          f"(C, alpha, beta, gap, ext) {run['params']}; counts {counts()}")
    check(bool(np.isfinite(run["params"]).all()), "the unnormalised optimizer ended non-finite")
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    tmp_dir.cleanup()


# each kernel's launches: the program's counter of the wrapper calls that ran it
KERNEL_COUNTERS = {"K1": "k1.calls.cluster", "K2": "la.la_log_factored.calls",
                   "K3": "la.la_exp_factored.calls", "K4": "la.la_exp.calls",
                   "K5": "la.la_log.calls", "K6": "k6.calls"}


def counter(name: str) -> int:
    """The program's counter ``name`` (stem_kernel_torch.utils.tracing); 0
    where nothing has counted it since the last reset."""
    from stem_kernel_torch.utils.tracing import counters

    return counters().get(name, 0)


def kernel_counters():
    """(reset_counts, counts): a function setting every counter of the
    program to 0 and one reading K1-K6's launches."""
    from stem_kernel_torch.utils.tracing import reset_counters

    def counts() -> dict[str, int]:
        return {k: counter(name) for k, name in KERNEL_COUNTERS.items()}

    return reset_counters, counts


def string_counts() -> dict[str, int]:
    """The string kernel's counters: its calls, the launches of its DP kernel
    (csrc/string_dp.cu) and the plain row loop's rows."""
    return {k: counter(f"string.{k}") for k in ("calls", "calls.kernel", "rows")}


def check_string_kernel(label: str, got: dict, called: bool) -> None:
    """Every string-kernel call of a path on the card launched the DP kernel
    and none ran the plain loop (``called``), or the path never called it."""
    if called:
        check(got["calls.kernel"] > 0 and got["calls.kernel"] == got["calls"]
              and got["rows"] == 0, f"{label}: string kernel calls off the DP kernel: {got}")
    else:
        check(not any(got.values()), f"{label} called the string kernel: {got}")


@contextlib.contextmanager
def gram_timer(acc: list):
    """Add the wall time of every ``PairKernelEngine.run_pairs`` call (a
    Gram pass, its gather included; it returns host values) to acc[0]."""
    from stem_kernel_torch.gram.engine import PairKernelEngine

    run_pairs = PairKernelEngine.run_pairs

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return run_pairs(self, *args, **kwargs)
        finally:
            acc[0] += time.perf_counter() - t0

    PairKernelEngine.run_pairs = timed
    try:
        yield
    finally:
        PairKernelEngine.run_pairs = run_pairs


def flagship_gram(argv: list) -> int:
    """The flagship exp BPLA Gram (K3) through ``PairKernelEngine`` over the
    ranks of the process group, as a library user runs it (no CLI reaches
    K3: ``bpla_kernel`` takes log space, and ``--SW`` the max-plus DP, in
    both packages).  ``argv``: [features .npz, output .npy], written by
    rank 0 alone."""
    from stem_kernel_torch.gram.engine import PairKernelEngine
    from stem_kernel_torch.models.bpla import BPLAKernel
    from stem_kernel_torch.parallel.distributed import initialize, rank_device
    from stem_kernel_torch.parallel.mesh import process_zero, resolve_mesh

    initialize()
    dev = rank_device("cuda")
    with np.load(argv[0]) as data:
        feats = dict(data)
    g = PairKernelEngine(BPLAKernel().to(dev), feats, device=dev, batch_size=LA_BATCH,
                         mesh=resolve_mesh(0)).gram(normalize=True)
    if process_zero():
        np.save(argv[1], g)
    return 0


def rank_jobs(f: dict, out: str = "") -> list:
    """Phase 21's jobs, (label, CLI module or "flagship", argv), outputs
    under ``out``."""
    train = ["+1", f["pos"], "-1", f["neg"]]
    return [
        ("stem_kernel_lite -n", "stem_kernel_lite",
         ["--device", "cuda", "-n", f"{out}km.dat", *train]),
        ("stem_kernel_lite -n predict", "stem_kernel_lite",
         ["--device", "cuda", "-n", f"{out}test.dat", "--model", f["model"],
          "--predict", f"{out}pred.txt", *train, "--test", "+1", f["tpos"], "-1", f["tneg"]]),
        ("bpla_kernel -n", "bpla_kernel", ["--device", "cuda", "-n", f"{out}bpla.dat", *train]),
        ("bpla_kernel -n --SW", "bpla_kernel",
         ["--device", "cuda", "-n", "--SW", f"{out}sw.dat", *train]),
        ("flagship exp BPLA Gram (PairKernelEngine)", "flagship",
         [f["profiles"], f"{out}flagship.npy"]),
        ("la_kernel -n", "la_kernel",
         ["--device", "cuda", "-n", f"{out}la.dat", "+1", f["ppos"], "-1", f["pneg"]]),
        (f"stem_kernel -n -b {FULL_BAND}", "stem_kernel",
         ["--device", "cuda", "-n", "-b", str(FULL_BAND), f"{out}full.dat",
          "+1", f["fpos"], "-1", f["fneg"]]),
    ]


# the kernels each job of phase 21 must launch on both ranks (--SW: none,
# the max-plus DP is plain torch, as it is plain XLA in the JAX package; the
# stem train flow launches K1's cluster kernel once, on its one block of
# pairs up to 64 nodes, so one rank only: the split check holds it)
RANK_JOB_KERNELS = (("K1w",), ("K1w",), ("K2",), (), ("K3",), ("K4",), ("K6",))


def run_job(cli: str, argv: list, reset_counts, counts) -> dict:
    """One CLI run in this process: its launch counts (K1w: K1's
    per-product route), its wall and its Gram passes' wall, in seconds."""
    import importlib

    main_fn = (flagship_gram if cli == "flagship"
               else importlib.import_module(f"stem_kernel_torch.cli.{cli}").main)
    gram_s = [0.0]
    reset_counts()
    t0 = time.perf_counter()
    with gram_timer(gram_s):
        rc = main_fn(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"{cli} {argv}: exit code {rc}")
    return {"counts": {**counts(), "K1w": counter("k1.calls.tiles")},
            "wall_s": wall, "gram_s": gram_s[0]}


def rank_worker(spec_path: str) -> int:
    """``--rank-worker JOBS.json``: one rank of phase 21.  RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR and MASTER_PORT come from the caller, and the
    CLIs join the group themselves.  Prints ``rank_report`` and a JSON
    object as its last line: each job's counts and walls, and
    ``scaling_efficiency`` of the stem kernel on 1 and 2 ranks."""
    from stem_kernel_torch.io.parsers import iter_alignments
    from stem_kernel_torch.models.composite import (
        StemLiteConfig, featurize_stem_examples, make_stem_lite_kernel_fn,
    )
    from stem_kernel_torch.ops import full_f32
    from stem_kernel_torch.parallel.distributed import rank_device, scaling_efficiency, world

    with open(spec_path) as fh:
        spec = json.load(fh)
    full_f32()
    reset_counts, counts = kernel_counters()
    report = {"jobs": [run_job(cli, argv, reset_counts, counts) for _, cli, argv in spec["jobs"]]}
    rank, n_ranks = world()
    check(n_ranks == 2, f"rank {rank}: {n_ranks} ranks in the group, not 2")
    dev = rank_device("cuda")
    cfg = StemLiteConfig()
    alns = [a for path in spec["scaling_fasta"] for a in list(iter_alignments(path))[:SCALE_N]]
    feats, iters = featurize_stem_examples(alns, cfg, device=dev)
    kernel_fn = make_stem_lite_kernel_fn(cfg, iters, device=dev)
    rng = np.random.default_rng(SEED)

    def feats_fn(bsz: int):
        ix, iy = (torch.as_tensor(rng.integers(0, len(alns), bsz), device=dev) for _ in range(2))
        return ({k: v.index_select(0, ix) for k, v in feats.items()},
                {k: v.index_select(0, iy) for k, v in feats.items()})

    report["scaling"] = scaling_efficiency(kernel_fn, feats_fn, batch_per_device=K1_BATCH,
                                           device_counts=[1, 2], device="cuda")
    report["device"] = str(dev)
    print("rank_report " + json.dumps(report), flush=True)
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def slice7_phase(smi: str, reset_counts, counts, corpus: tuple, proteins: tuple,
                 profiles: dict, full_train: list, earlier: dict) -> None:
    """Phase 21: the Gram CLIs on two ranks sharing the card.  ``corpus``:
    phase 4's (pos, neg, tpos, tneg); ``proteins``: phase 8's (ppos, pneg);
    ``profiles``: phase 9's random-profile features; ``full_train``: phase
    13's config-3 sequences; ``earlier``: output file name -> the Gram an
    earlier phase computed from the same inputs the same way."""
    from stem_kernel_torch.cli import svm_tools
    from stem_kernel_torch.gram.io import read_precomputed

    t_phase = time.perf_counter()
    pos, neg, tpos, tneg = corpus
    ppos, pneg = proteins
    tmp_dir = tempfile.TemporaryDirectory()
    p = lambda f: os.path.join(tmp_dir.name, f)  # noqa: E731
    half, n_a = FULL_N // 2, FULL_A // 2
    f = {"pos": write_fasta(p("pos.fa"), pos, "p"), "neg": write_fasta(p("neg.fa"), neg, "n"),
         "tpos": write_fasta(p("tpos.fa"), tpos, "tp"),
         "tneg": write_fasta(p("tneg.fa"), tneg, "tn"),
         "ppos": write_fasta(p("ppos.fa"), ppos, "p"), "pneg": write_fasta(p("pneg.fa"), pneg, "n"),
         "fpos": write_fasta(p("fpos.fa"), full_train[:n_a], "p"),
         "fneg": write_fasta(p("fneg.fa"), full_train[half:half + n_a], "n"),
         "model": p("one/km.model"), "profiles": p("profiles.npz")}
    np.savez(f["profiles"], **profiles)
    for d in ("one", "rank0", "rank1"):
        os.mkdir(p(d))

    # one rank, in this process
    one = []
    for i, (label, cli, argv) in enumerate(rank_jobs(f, p("one") + os.sep)):
        one.append(run_job(cli, argv, reset_counts, counts))
        if i == 0:
            svm_tools.train_main([p("one/km.dat"), f["model"]])
    for name, g in earlier.items():
        path = p(f"one/{name}")
        same = np.array_equal(np.load(path) if name.endswith(".npy")
                              else read_precomputed(path)[1], g)
        print(f"phase 21 one-rank {name}: equal to the earlier phase's Gram bit for bit: {same}")
        check(same, f"the one-rank {name} differs from the earlier phase's")

    # two ranks: this script, started twice
    spec = p("jobs.json")
    with open(spec, "w") as fh:
        json.dump({"jobs": rank_jobs(f), "scaling_fasta": [f["pos"], f["neg"]]}, fh)
    env = {**os.environ, "WORLD_SIZE": "2", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port())}
    t0 = time.perf_counter()
    logs = [open(p(f"rank{r}.log"), "w+") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank-worker", spec],
                              cwd=p(f"rank{r}"), env={**env, "RANK": str(r)},
                              stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    try:
        # a rank that fails leaves the other waiting in a gather: stop both
        while (any(proc.poll() is None for proc in procs)
               and not any(proc.poll() for proc in procs)
               and time.perf_counter() - t0 < RANK_TIMEOUT):
            time.sleep(0.5)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    ranks_s = time.perf_counter() - t0
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    # a rank that failed by itself first, before the one stopped for it
    for r in sorted(range(2), key=lambda r: procs[r].returncode < 0):
        check(procs[r].returncode == 0,
              f"rank {r} exited with {procs[r].returncode}:\n{outs[r][-6000:]}")
    reports = []
    for r, out in enumerate(outs):
        last = out.strip().splitlines()[-1]
        check(last.startswith("rank_report "), f"rank {r} printed no report:\n{out[-6000:]}")
        reports.append(json.loads(last[len("rank_report "):]))
    print(f"phase 21: two ranks ran all jobs in {ranks_s:.1f} s (two processes, each paying "
          f"its torch import and CUDA context); devices {[rep['device'] for rep in reports]}")

    written = sorted(os.listdir(p("rank0")))
    want = sorted(set(os.listdir(p("one"))) - {"km.model"})
    print(f"phase 21 files: rank 0 wrote {written}; rank 1 wrote {sorted(os.listdir(p('rank1')))}")
    check(os.listdir(p("rank1")) == [], "rank 1 wrote files")
    check(written == want, f"rank 0 wrote {written}, not {want}")
    for name in written:
        with open(p(f"rank0/{name}"), "rb") as a, open(p(f"one/{name}"), "rb") as b:
            check(a.read() == b.read(), f"two ranks' {name} differs from one rank's")
    for (label, _, _), need, o, r0, r1 in zip(rank_jobs(f), RANK_JOB_KERNELS, one,
                                              *(rep["jobs"] for rep in reports)):
        c0, c1, c = r0["counts"], r1["counts"], o["counts"]
        ran = [k for k in c if c[k] or c0[k] or c1[k]]
        print(f"phase 21 {label}: launches one rank {({k: c[k] for k in ran})}, rank 0 "
              f"{({k: c0[k] for k in ran})}, rank 1 {({k: c1[k] for k in ran})}; walls "
              f"({TWO_RANKS}): one rank {o['wall_s']:.2f} s (Gram {o['gram_s']:.2f} s), "
              f"two ranks {max(r0['wall_s'], r1['wall_s']):.2f} s (Gram "
              f"{max(r0['gram_s'], r1['gram_s']):.2f} s; rank 0 {r0['wall_s']:.2f} s, Gram "
              f"{r0['gram_s']:.2f} s; rank 1 {r1['wall_s']:.2f} s, Gram {r1['gram_s']:.2f} s)")
        for k in c:
            check(c0[k] + c1[k] == c[k], f"{label}: {k} launches {c0[k]} + {c1[k]} != {c[k]}")
        for k in need:
            check(c0[k] > 0 and c1[k] > 0, f"{label}: a rank never launched {k}")
    eff = reports[0]["scaling"]
    print(f"phase 21 scaling_efficiency, stem kernel, {K1_BATCH} pairs a rank of "
          f"{2 * SCALE_N} sequences ({TWO_RANKS}) on {smi}: "
          + ", ".join(f"{n} rank(s) {v:.1f} pairs/s" for n, v in eff.items()))
    check(reports[1]["scaling"] == eff and all(np.isfinite(v) and v > 0 for v in eff.values()),
          f"scaling_efficiency: {reports[0]['scaling']} and {reports[1]['scaling']}")
    tmp_dir.cleanup()
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from stem_kernel_torch.cli import (
        bpla_kernel, la_kernel, stem_kernel, stem_kernel_lite, svm_tools,
    )
    from stem_kernel_torch.fold.bpmatrix import bpp_for_alignments, fold_sequences
    from stem_kernel_torch.gram.bucketed import bucketed_gram
    from stem_kernel_torch.gram.engine import PairKernelEngine
    from stem_kernel_torch.gram.io import read_precomputed
    from stem_kernel_torch.io.aaprofile import aa_features
    from stem_kernel_torch.io.profile import Alignment
    from stem_kernel_torch.models.blosum_data import BLOSUM62
    from stem_kernel_torch.models.bpla import BPLAKernel, la_score_matrix
    from stem_kernel_torch.models.composite import (
        StemLiteConfig, featurize_stem_bucketed, make_stem_lite_kernel_fn,
    )
    from stem_kernel_torch.models.featurize import bpla_features
    from stem_kernel_torch.models.stem_kernel import fixed_point_operands, subst_co_table
    from stem_kernel_torch.ops import full_f32, la
    from stem_kernel_torch.ops._build import BUILD_DIR, PTXAS_LOG, build
    from stem_kernel_torch.ops.full_stem_banded import (
        full_stem_banded_log, full_stem_banded_log_reference,
    )
    from stem_kernel_torch.ops.stem_fixed_point import (
        MODES, cluster_info, cluster_kernel, cluster_route, per_product_route, stem_fixed_point,
        stem_fixed_point_reference, strips_info,
    )
    from stem_kernel_torch.utils.shuffle import dinucleotide_shuffle

    reset_counts, counts = kernel_counters()

    # ---- 1. environment ----
    full_f32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    # ---- 2. build ----
    _, build_s = build()
    print(f"build: {build_s:.1f} s")
    # K1's kernels: cluster <mode, m16 count>, tiles <mode, rows tile>; mode
    # 0 f32, 1 3xTF32, 2 bf16 (the tile kernel: 168 registers a thread at
    # launch, the producer warpgroup giving 128 of its to the consumers)
    log = (BUILD_DIR / PTXAS_LOG).read_text().split("Compiling entry function")
    for entry in log[1:]:
        for kern, label in (("fixed_point_clusterILi", "cluster"), ("fixed_point_tilesILi", "tile")):
            if kern in entry.splitlines()[0]:
                targs = entry.split(kern)[1].split("EEE")[0].replace("ELb", ", ").replace("ELi", ", ")
                use = [ln.split(":")[-1].strip() if "Used" in ln else ln.strip()
                       for ln in entry.splitlines() if "spill" in ln or "Used" in ln]
                print(f"ptxas, K1 {label} kernel <{targs}>: {'; '.join(use)}")

    # ---- data ----
    rng = np.random.default_rng(SEED)
    fam = make_family(rng, N_TRAIN + N_TEST, SEQ_LEN)
    shuf = [dinucleotide_shuffle(s, rng) for s in fam]
    pos, tpos = fam[:N_TRAIN], fam[N_TRAIN:]
    neg, tneg = shuf[:N_TRAIN], shuf[N_TRAIN:]
    train = pos + neg
    prot = make_proteins(rng, N_TRAIN + N_TEST)
    prot_shuf = ["".join(rng.permutation(list(s))) for s in prot]
    ppos, tppos = prot[:N_TRAIN], prot[N_TRAIN:]
    pneg, tpneg = prot_shuf[:N_TRAIN], prot_shuf[N_TRAIN:]

    # ---- 3. kernel parity at the main path's shapes ----
    # the largest node bucket against itself (square), and against the
    # next largest (Nx != Ny, as the Gram's cross-bucket blocks run it)
    cfg = StemLiteConfig()
    buckets = featurize_stem_bucketed([Alignment(rows=[s]) for s in train], cfg, device=dev)
    by_size = sorted(buckets, key=lambda b: len(b[0]), reverse=True)
    co = torch.as_tensor(subst_co_table(cfg.beta), device=dev)
    pair_rng = np.random.default_rng(SEED + 1)

    def corpus_block(bx, by):
        """(operands, iters) of K1_BATCH random pairs of bucket bx x bucket by."""
        (idx_x, fx, it_x), (idx_y, fy, it_y) = bx, by
        bix = torch.as_tensor(pair_rng.integers(0, len(idx_x), K1_BATCH), device=dev)
        biy = torch.as_tensor(pair_rng.integers(0, len(idx_y), K1_BATCH), device=dev)
        x = {k: v.index_select(0, bix) for k, v in fx.items()}
        y = {k: v.index_select(0, biy) for k, v in fy.items()}
        iters = max(it_x, it_y)
        return fixed_point_operands(x, y, co, iters=iters, len_band=cfg.len_band), iters

    # the largest bucket against itself, against the next largest, and the
    # smallest bucket against the largest (both Nx != Ny, as the Gram's
    # cross-bucket blocks run them)
    cases = []
    by_nodes = sorted(buckets, key=lambda b: b[1]["V"].shape[1])
    blocks = [(by_size[0], by_size[0])] + ([(by_size[0], by_size[1])] if len(by_size) > 1 else [])
    if by_nodes[0] is not by_size[0]:
        blocks.append((by_nodes[0], by_size[0]))
    for bx, by in blocks:
        cases.append((f"corpus B={K1_BATCH} Nx={bx[1]['V'].shape[1]} Ny={by[1]['V'].shape[1]}",
                      *corpus_block(bx, by)))
    # shapes the corpus blocks above may not reach: the cluster kernel at 64
    # and on a rectangular padded pair, the tile kernel on a rectangular
    # padded pair (one CTA), at 64 x 256 (its 64-row tile), at 256 and 512
    # nodes, past 256 (the strip spills in 3xTF32) and at 1232 x 96 (it
    # spills in every mode)
    for bsz, nx, ny, seed in ((64, 64, 64, 11), (64, 40, 56, 15), (64, 112, 48, 14),
                              (64, 64, 256, 17), (64, 256, 256, 12), (8, 512, 512, 18),
                              (16, 320, 288, 13), (4, 528, 96, 16), (4, 1232, 96, 19)):
        cases.append((f"random B={bsz} Nx={nx} Ny={ny}", k1_random(bsz, nx, ny, 20, seed, dev), 20))
    for nx, ny in ((320, 288), (528, 96), (512, 512)):
        check(strips_info(nx, ny, "high")["spill"], f"the high strip at {nx} x {ny} stayed")
    for prec in MODES:
        check(strips_info(1232, 96, prec)["spill"], f"the {prec} strip at 1232 x 96 stayed")
    check(strips_info(64, 256, "high")["rows"] == 64, "the tile kernel took 128 rows at Nx = 64")
    report = {"K1": {"max_abs_err": 0.0, "max_rel_err": 0.0},
              "K1w": {"max_abs_err": 0.0, "max_rel_err": 0.0}}
    k1_modes = {}  # (route, precision) -> (max rel against its plain version, against f32)

    def k1_parity(label, case_args, case_iters, prec, run, rname):
        """Check one K1 result against the plain version in the mode ``prec`` names."""
        mode = MODES[prec]
        f32 = stem_fixed_point_reference(*case_args, max_iters=case_iters)
        got = run()
        torch.cuda.synchronize()
        want = stem_fixed_point_reference(*case_args, max_iters=case_iters, mode=mode)
        check(bool(torch.isfinite(got).all()), f"K1 {label} {prec}: kernel output not finite")
        rel, rel_f32 = k1_rel(got, want), k1_rel(got, f32)
        zero = bool((got[case_args[-1] == 0] == 0).all())
        print(f"K1 parity, {label}, {rname}, {prec} ({mode}): trip counts "
              f"{int(case_args[-1].min())}..{int(case_args[-1].max())}: max abs "
              f"{float((got - want).abs().max()):.3e} max rel {rel:.3e} against the plain "
              f"version in {mode} (limit {KERNEL_RTOL}); {rel_f32:.3e} against plain "
              f"f32; 0-trip pairs give 0: {zero}")
        check(rel <= KERNEL_RTOL, f"K1 {label} {prec}: kernel disagrees with its plain version")
        check(zero, f"K1 {label} {prec}: a pair with 0 trips is not 0")
        if mode == "bf16":
            check(rel_f32 > 0 and rel_f32 >= BF16_SEPARATION * rel,
                  f"K1 {label}: the bf16 kernel is not {BF16_SEPARATION}x nearer plain bf16 "
                  f"({rel:.3e}) than plain f32 ({rel_f32:.3e})")
        if prec == "high":
            check(rel_f32 <= JAX_HIGH_REL, f"K1 {label}: high is {rel_f32} from f32")
        key = "K1" if rname.startswith("cluster") else "K1w"
        if prec == "high" or key == "K1w":
            r = report[key]
            r["max_abs_err"] = max(r["max_abs_err"], float((got - want).abs().max()))
            r["max_rel_err"] = max(r["max_rel_err"], rel)
        old = k1_modes.get((key, prec), (0.0, 0.0))
        k1_modes[(key, prec)] = (max(old[0], rel), max(old[1], rel_f32))

    for label, case_args, case_iters in cases:
        _, nx, ny = case_args[0].shape
        rname = "cluster" if cluster_route(nx, ny) else "per-product"
        for prec in MODES:
            before = (counter("k1.calls.cluster"), counter("k1.calls.tiles"))
            k1_parity(label, case_args, case_iters, prec,
                      lambda: stem_fixed_point(*case_args, max_iters=case_iters,  # noqa: B023
                                               precision=prec), f"{rname} route")  # noqa: B023
            after = (counter("k1.calls.cluster"), counter("k1.calls.tiles"))
            which = 0 if rname == "cluster" else 1
            check(after[which] == before[which] + 1, f"K1 {label}: the {rname} route did not run")
    for (key, prec), (rel, rel_f32) in k1_modes.items():
        jax_rel = {"highest": 0.0, "high": JAX_HIGH_REL, "default": JAX_DEFAULT_REL}[prec]
        print(f"K1 {'cluster' if key == 'K1' else 'per-product'} route, {prec} ({MODES[prec]}): "
              f"max rel {rel:.3e} against its plain version, {rel_f32:.3e} against plain f32 "
              f"(JAX {prec}: {jax_rel} against f32)")

    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    p = lambda f: os.path.join(tmp, f)  # noqa: E731
    write_fasta(p("pos.fa"), pos, "p")
    write_fasta(p("neg.fa"), neg, "n")
    write_fasta(p("tpos.fa"), tpos, "tp")
    write_fasta(p("tneg.fa"), tneg, "tn")
    write_fasta(p("spos.fa"), pos[:4], "p")
    write_fasta(p("sneg.fa"), neg[:4], "n")

    # ---- 4. stem path ----
    reset_counts()
    t0 = time.perf_counter()
    stem_kernel_lite.main(["--device", "cuda", "-n", p("km.dat"),
                           "+1", p("pos.fa"), "-1", p("neg.fa")])
    train_s = time.perf_counter() - t0
    train_launches = counter("k1.calls.cluster")
    train_wide = counter("k1.calls.tiles")
    train_string = counter("string.calls.kernel")
    train_fold = counter("fold.batches.kernel")
    check(train_fold > 0 and train_fold == counter("fold.batches"),
          f"the stem path folded off the fold DP kernel: {train_fold} launches, "
          f"{counter('fold.batches')} fold batches")
    svm_tools.train_main([p("km.dat"), p("km.model")])
    t0 = time.perf_counter()
    stem_kernel_lite.main(["--device", "cuda", "-n", p("test.dat"),
                           "--model", p("km.model"), "--predict", p("pred.txt"),
                           "+1", p("pos.fa"), "-1", p("neg.fa"),
                           "--test", "+1", p("tpos.fa"), "-1", p("tneg.fa")])
    predict_s = time.perf_counter() - t0
    stem_counts, stem_string = counts(), string_counts()
    launches, wide = stem_counts["K1"], counter("k1.calls.tiles")
    labels, g = read_precomputed(p("km.dat"))
    g_stem = g

    # small-input reference: the same flow on the plain versions (CPU)
    for d in ("cuda", "cpu"):
        stem_kernel_lite.main(["--device", d, "-n", p(f"small_{d}.dat"),
                               "+1", p("spos.fa"), "-1", p("sneg.fa")])
    _, g_cuda = read_precomputed(p("small_cuda.dat"))
    _, g_cpu = read_precomputed(p("small_cpu.dat"))
    # the fold's f32 scaled engine on the card against the CPU (denormals:
    # the log-table floor TINY = 1e-38 lies below the smallest normal f32)
    small = pos[:4] + neg[:4]
    bpp_diff = max(float(np.abs(a - b).max()) for a, b in zip(
        fold_sequences(small, cfg.bp_opts, device=dev),
        fold_sequences(small, cfg.bp_opts, device="cpu")))

    n = 2 * N_TRAIN
    train_labels = ["+1"] * N_TRAIN + ["-1"] * N_TRAIN
    print(f"stem path (--precision {cfg.precision}, K1 in {MODES[cfg.precision]}): train Gram "
          f"{g.shape}, {n * (n + 1) // 2} pairs, K1 launches {train_launches} (train) "
          f"{launches} (train + predict), per-product route {train_wide} (train) "
          f"{wide} (train + predict); all counts {stem_counts}; string kernel {stem_string}, "
          f"its DP kernel's launches {train_string} (train)")
    check(launches > 0 and train_launches > 0, "the stem path never launched K1's cluster kernel")
    check_string_kernel("the stem path", stem_string, True)
    check(wide > 0, "the stem path never ran K1's per-product route")
    report["K1w"]["launches"] = wide
    gram_checks("stem", g, n, labels, train_labels)
    auc = predictions(p("pred.txt"), 2 * N_TEST, "stem")
    small_diff = float(np.abs(g_cuda - g_cpu).max())
    print(f"predict: {2 * N_TEST} rows, AUC {auc:.4f}; small-input cuda vs cpu: "
          f"Gram max abs diff {small_diff:.3e} (band {CLI_BAND}), BPP max abs diff "
          f"{bpp_diff:.3e} (band {BPP_BAND})")
    check(small_diff <= CLI_BAND, "cuda and cpu Grams disagree on the small input")
    check(bpp_diff <= BPP_BAND, "cuda and cpu folds disagree on the small input")

    # ---- 5. times ----
    # every block shape of the stem Gram, in the Gram's batches, in each
    # mode: the per-product route, beside the cluster kernel where that
    # runs (up to 64 nodes) on the same batch, and the library chains.
    # These times place cluster_route's cut-over.
    picks = {}  # route -> (train launches, operands, iters) of its busiest shape in "high"
    # ms over the train Gram's per-product launches: each mode, each chain
    sums = dict.fromkeys([*MODES, "f32 chain", "tf32 chain", "bf16 chain"], 0.0)
    wide_launches = 0
    for i, bx in enumerate(by_nodes):
        for by in by_nodes[i:]:
            blk, blk_iters = corpus_block(bx, by)
            _, nx, ny = blk[0].shape
            nb = len(bx[0]) * (len(bx[0]) + 1) // 2 if by is bx else len(bx[0]) * len(by[0])
            batches = -(-nb // K1_BATCH)  # the train Gram's launches at this shape
            it = torch.clamp(blk[-1], max=blk_iters).contiguous()
            taken = "cluster" if cluster_route(nx, ny) else "per-product"
            parts, pp_times = [], {}
            for prec, mode in MODES.items():
                pp = lambda: per_product_route(*blk[:-1], it, precision=prec)  # noqa: B023,E731
                if taken != "cluster":
                    pp()
                    pp_times[prec] = cuda_ms(pp, 2)
                    g = strips_info(nx, ny, prec)
                    parts.append(f"{prec} ({mode}): per-product {pp_times[prec]:.3f} ms "
                                 f"[rows tile {g['rows']}, strips of {g['strip']} columns, "
                                 f"{g['ctas']} CTAs a pair, no multicast, "
                                 f"{g['stages']} stages, strip "
                                 f"{'spilled' if g['spill'] else 'in shared memory'}]")
                    continue
                k_ms, pp_ms = timed_pair(
                    lambda: cluster_kernel(*blk[:-1], it, precision=prec),  # noqa: B023
                    pp, 3)
                parts.append(f"{prec} ({mode}): cluster {k_ms:.3f} ms vs per-product "
                             f"{pp_ms:.3f} ms")
            if taken not in picks or batches > picks[taken][0]:
                picks[taken] = (batches, blk, blk_iters)
            chains = (chain_ms(blk, blk_iters)[0], chain_ms(blk, blk_iters, tf32=True)[0],
                      chain_ms(blk, blk_iters, torch.bfloat16)[0])
            ratios = ""
            if taken != "cluster":
                wide_launches += batches
                for key, ms in (*pp_times.items(), *zip(("f32 chain", "tf32 chain", "bf16 chain"),
                                                        chains)):
                    sums[key] += ms * batches
                ratios = (f"; kernel / chain: high / f32 {pp_times['high'] / chains[0]:.3f}, "
                          f"default / bf16 {pp_times['default'] / chains[2]:.3f}")
            print(f"times on {smi}: K1 block Nx={nx} Ny={ny} ({nb} pairs, B={K1_BATCH}, trips "
                  f"{int(blk[-1].min())}..{int(blk[-1].max())}, {batches} train launches, the "
                  f"wrapper takes {taken}): {'; '.join(parts)}; library chain at the same "
                  f"pair-trips: f32 {chains[0]:.3f}, tf32 one pass {chains[1]:.3f}, bf16 "
                  f"{chains[2]:.3f} ms{ratios}")
    print(f"times on {smi}: K1 per-product route summed over the train Gram's "
          f"{wide_launches} per-product launches (each block's B={K1_BATCH} "
          f"time times its launches): " + ", ".join(f"{k} {v:.3f} ms" for k, v in sums.items()))
    # each route in each mode at the shape that takes it most often on the
    # path, against the plain f32 version (plain, kernel, kernel, plain) and
    # the library chain: the same pair-trips' products through torch.bmm
    for key, rname in (("K1", "cluster"), ("K1w", "per-product")):
        _, r_args, r_iters = picks[rname]
        r_it = torch.clamp(r_args[-1], max=r_iters).contiguous()
        _, nx, ny = r_args[0].shape
        f32_chain, chain_vals = chain_ms(r_args, r_iters)
        chain_rel = k1_rel(chain_vals, stem_fixed_point_reference(*r_args, max_iters=r_iters))
        check(chain_rel <= KERNEL_RTOL, f"K1 {rname}: the f32 library chain is {chain_rel} "
              "from the plain version: it does not compute K1's function")
        for prec, mode in MODES.items():
            if key == "K1":
                run = lambda: cluster_kernel(*r_args[:-1], r_it, precision=prec)  # noqa: B023,E731
                geo = cluster_info(nx, ny, prec)
                how = (f"one launch, one CTA a pair, {geo['smem_bytes']} B shared memory a CTA, "
                       f"{geo['active_pairs']} pairs active at once")
            else:
                run = lambda: per_product_route(*r_args[:-1], r_it, precision=prec)  # noqa: B023,E731
                geo = strips_info(nx, ny, prec)
                how = (f"one launch, clusters of {geo['ctas']} CTAs, rows tile {geo['rows']}, "
                       f"strips of {geo['strip']} columns, "
                       f"{geo['stages']} TMA stages, {geo['smem_bytes']} B shared memory a CTA, "
                       f"{geo['active_pairs']} pairs active at once, strip "
                       f"{'spilled' if geo['spill'] else 'in shared memory'}")
            k_ms, p_ms = timed_pair(
                run, lambda: stem_fixed_point_reference(*r_args, max_iters=r_iters), 2)  # noqa: B023
            d_ms = graph_ms(run, 2)
            b_ms, b_by = k1_bound(r_args, r_iters, mode)
            lib = {"f32": f32_chain}
            if mode == "bf16":
                lib["bf16"] = chain_ms(r_args, r_iters, torch.bfloat16)[0]
            if mode == "3xtf32":
                lib["tf32, one pass"] = chain_ms(r_args, r_iters, tf32=True)[0]
            if prec == "high":  # the main path's mode
                report[key].update(ms=k_ms, device_ms=d_ms, plain_ms=p_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=f32_chain, mode="high (3xTF32)",
                                   shape=f"B={K1_BATCH} Nx={nx} Ny={ny}")
            print(f"times on {smi}: K1 {rname} route {prec} ({mode}) {k_ms:.3f} ms [device "
                  f"{d_ms:.3f}] vs plain f32 {p_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by} on its "
                  f"unit ({100 * b_ms / k_ms:.1f}% of the bound), library chain "
                  f"{', '.join(f'{k} {v:.3f} ms' for k, v in lib.items())} (each pair its own "
                  f"trips, {int(r_it.sum())} pair-trips; f32 chain {chain_rel:.3e} from the plain "
                  f"version) (B={K1_BATCH} Nx={nx} Ny={ny} max_iters={r_iters}, trips "
                  f"{int(r_it.min())}..{int(r_it.max())}); {how}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fold_sequences(train, cfg.bp_opts, device=dev)
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bucketed_gram(buckets, lambda it: make_stem_lite_kernel_fn(cfg, it, device=dev),
                  device=dev, normalize=True)
    torch.cuda.synchronize()
    gram_s = time.perf_counter() - t0
    n_pairs = n * (n + 1) // 2
    print(f"times on {smi}: fold {len(train) / fold_s:.1f} seqs/s; Gram (precision "
          f"{cfg.precision}) {n_pairs / gram_s:.1f} pairs/s ({gram_s:.2f} s); train flow "
          f"{train_s:.2f} s; predict flow {2 * N_TEST / predict_s:.2f} rows/s ({predict_s:.2f} s)")
    report["K1"]["launches"] = launches

    # ---- 6. LA parity (K2-K5) at the paths' shapes ----
    alpha, beta, gap, ext = BPLA
    kern = BPLAKernel().to(dev)
    t0 = time.perf_counter()
    rna_feats = bpla_features([Alignment(rows=[s]) for s in train],
                              bpp_for_alignments([Alignment(rows=[s]) for s in train], device=dev))
    torch.cuda.synchronize()
    bpla_featurize_s = time.perf_counter() - t0
    short = trim(rng, tpos + tneg, 60, 100)
    short_feats = bpla_features([Alignment(rows=[s]) for s in short],
                                bpp_for_alignments([Alignment(rows=[s]) for s in short],
                                                   device=dev))
    prof_feats = random_profiles(rng, n, 32, 64)
    prof_short = random_profiles(rng, 64, 32, 48)
    aa_train = aa_features([Alignment(rows=[s]) for s in ppos + pneg])
    aa_short = aa_features([Alignment(rows=[s]) for s in trim(rng, tppos + tpneg, 30, 56)])
    blosum = torch.as_tensor(BLOSUM62, device=dev)
    bidx = lambda m: rng.integers(0, m, LA_BATCH)  # noqa: E731

    def batch(fx, fy):
        """(x, y) feature batches of LA_BATCH random pairs."""
        return (pick(fx, bidx(len(fx["length"])), dev),
                pick(fy, bidx(len(fy["length"])), dev))

    rna_sq, rna_rect = batch(rna_feats, rna_feats), batch(rna_feats, short_feats)
    prof_sq, prof_rect = batch(prof_feats, prof_feats), batch(prof_feats, prof_short)
    aa_sq, aa_rect = batch(aa_train, aa_train), batch(aa_train, aa_short)
    big = random_profiles(rng, LA_BATCH, 400, 400)
    big = pick(big, np.arange(LA_BATCH), dev)
    cap = pick(random_profiles(rng, CAP_BATCH, 384, la.LANE_MAX_LEN), np.arange(CAP_BATCH), dev)
    past = pick(random_profiles(rng, EDGE_BATCH, PAST_CAP, PAST_CAP), np.arange(EDGE_BATCH), dev)
    ill = pick(random_profiles(rng, 16, ILL_LEN, ILL_LEN), np.arange(16), dev)
    # Ly = 1500 > 1024: one block a pair; exp-space operands low enough to stay finite
    long_rng = np.random.default_rng(SEED + 5)
    lb = np.arange(LONG_BATCH)
    long_x = pick(random_profiles(long_rng, LONG_BATCH, 200, 400), lb, dev)
    long_y = pick(random_profiles(long_rng, LONG_BATCH, 1100, LONG_LY), lb, dev)
    long_s = [torch.as_tensor(long_rng.uniform(-8.0, -3.0, (LONG_BATCH, 60, LONG_LY))
                              .astype(np.float32), device=dev),
              torch.as_tensor(long_rng.integers(40, 61, LONG_BATCH).astype(np.int32), device=dev),
              torch.as_tensor(long_rng.integers(1100, LONG_LY + 1, LONG_BATCH).astype(np.int32),
                              device=dev)]
    # K3 at Ly = 1500: rank-6 factors whose third slot gives every cell a
    # score of -8..-3 (as long_s), so that exp space stays finite
    long_f = [long_rng.normal(size=(LONG_BATCH, 60, 6)) * 0.3,
              long_rng.normal(size=(LONG_BATCH, LONG_LY, 6)) * 0.3]
    long_f[0][:, :, 2] = -1.0
    long_f[1][:, :, 2] = long_rng.uniform(3.0 / BPLA[1], 8.0 / BPLA[1], (LONG_BATCH, LONG_LY))
    long_f = [torch.as_tensor(f.astype(np.float32), device=dev) for f in long_f] + long_s[1:]

    def factored(xy):
        x, y = xy
        return [kern.factors(x, "x"), kern.factors(y, "y"), x["length"], y["length"]]

    def protein(xy):
        x, y = xy
        return [la_score_matrix(x["profile"], y["profile"], blosum), x["length"], y["length"]]

    def affine(xy):
        x, y = xy
        return [*kern.score_parts(x, y), x["length"], y["length"]]

    fac = lambda fn: lambda fx, fy, lx, ly: fn(fx, fy, lx, ly, *BPLA)  # noqa: E731
    mat = lambda fn: lambda s, lx, ly: fn(s, lx, ly, *PROT)  # noqa: E731
    aff_exp = lambda wp, wu, lx, ly: la.la_exp_affine_auto(wp, wu, lx, ly, *BPLA)  # noqa: E731
    aff_log = lambda wp, wu, lx, ly: la.la_log_affine_auto(wp, wu, lx, ly, *BPLA)  # noqa: E731

    def aff_plain(fn):
        return lambda wp, wu, lx, ly: fn(wp, lx, ly, beta, gap, ext, scores2=wu, alpha=alpha)

    la_cases = [  # (kernel, label, kernel call, plain call, operands)
        ("K2", "corpus factors", fac(la.la_log_factored), fac(la.la_log_factored_reference),
         factored(rna_sq)),
        ("K2", "corpus x trimmed", fac(la.la_log_factored), fac(la.la_log_factored_reference),
         factored(rna_rect)),
        ("K2", "random factors L=400", fac(la.la_log_factored),
         fac(la.la_log_factored_reference), factored((big, big))),
        ("K2", f"random factors L 384-{la.LANE_MAX_LEN}, the lane kernels' longest",
         fac(la.la_log_factored), fac(la.la_log_factored_reference), factored((cap, cap))),
        ("K2", f"random factors L={PAST_CAP}, past them (the one-warp kernel)",
         fac(la.la_log_factored), fac(la.la_log_factored_reference), factored((past, past))),
        ("K2", f"random factors Lx 200-400, Ly={LONG_LY}", fac(la.la_log_factored),
         fac(la.la_log_factored_reference), factored((long_x, long_y))),
        ("K3", "random profiles", fac(la.la_exp_factored), fac(la.la_exp_factored_reference),
         factored(prof_sq)),
        ("K3", "random profiles rect", fac(la.la_exp_factored),
         fac(la.la_exp_factored_reference), factored(prof_rect)),
        ("K4", "BLOSUM62 proteins", mat(la.la_exp_auto), mat(la.la_exp_reference),
         protein(aa_sq)),
        ("K4", "BLOSUM62 proteins rect", mat(la.la_exp_auto), mat(la.la_exp_reference),
         protein(aa_rect)),
        ("K4", "affine, random profiles", aff_exp, aff_plain(la.la_exp_reference),
         affine(prof_rect)),
        ("K3", f"factors, scores -8..-3, Lx 40-60, Ly={LONG_LY}", fac(la.la_exp_factored),
         fac(la.la_exp_factored_reference), long_f),
        ("K4", f"scores -8..-3, Lx 40-60, Ly={LONG_LY}", mat(la.la_exp), mat(la.la_exp_reference),
         long_s),
        ("K5", f"scores -8..-3, Lx 40-60, Ly={LONG_LY}", mat(la.la_log), mat(la.la_log_reference),
         long_s),
        ("K5", "BLOSUM62 proteins", mat(la.la_log_auto), mat(la.la_log_reference),
         protein(aa_sq)),
        ("K5", "BLOSUM62 proteins rect", mat(la.la_log_auto), mat(la.la_log_reference),
         protein(aa_rect)),
        ("K5", "affine, corpus", aff_log, aff_plain(la.la_log_reference), affine(rna_sq)),
        ("K5", "affine, corpus x trimmed", aff_log, aff_plain(la.la_log_reference),
         affine(rna_rect)),
    ]
    # the log kernels' edges: every chunk and lane-geometry edge, ranks 2 and
    # 6, two slabs, emissions that drop 40+ nats, the long-score case (log K
    # 326.0), and the two path batches padded wider (wider_cols) onto
    # another lane geometry; the exp kernels' edges, ranks and slabs, 256
    # pairs of 384-512 rows and columns, the overflow batch and their path
    # batches padded wider
    la_fns = {("K2", False): (fac(la.la_log_factored), fac(la.la_log_factored_reference)),
              ("K5", False): (mat(la.la_log), mat(la.la_log_reference)),
              ("K5", True): (aff_log, aff_plain(la.la_log_reference)),
              ("K3", False): (fac(la.la_exp_factored), fac(la.la_exp_factored_reference)),
              ("K4", False): (mat(la.la_exp), mat(la.la_exp_reference)),
              ("K4", True): (aff_exp, aff_plain(la.la_exp_reference))}
    edge_rng = np.random.default_rng(SEED + 6)
    for key, label, ops, two in (la_edge_cases(edge_rng, dev) + la_drop_cases(edge_rng, dev)
                                 + la_exp_edge_cases(edge_rng, dev)
                                 + la_overflow_cases(edge_rng, dev)):
        la_cases.append((key, label, *la_fns[key, two], ops))
    n160 = torch.tensor([160, 120], dtype=torch.int32, device=dev)
    la_cases.append(("K5", "long scores, 15 a cell",
                     lambda s, lx, ly: la.la_log(s, lx, ly, *BPLA[1:]),
                     lambda s, lx, ly: la.la_log_reference(s, lx, ly, *BPLA[1:]),
                     [torch.full((2, 160, 160), 15.0, device=dev), n160,
                      torch.full_like(n160, 160)]))
    cap_lens = [torch.as_tensor(edge_rng.integers(384, la.LANE_MAX_LEN + 1, CAP_BATCH)
                                .astype(np.int32), device=dev) for _ in range(2)]
    cap_label = f"log emissions {EXP_LONG_LE}, L 384-{la.LANE_MAX_LEN}, the lane kernels' longest"
    la_cases.append(("K3", cap_label, *la_fns["K3", False],
                     exp_factors(edge_rng, CAP_BATCH, la.LANE_MAX_LEN, la.LANE_MAX_LEN, 6,
                                 EXP_LONG_LE, dev) + cap_lens))
    la_cases.append(("K4", cap_label, *la_fns["K4", False],
                     exp_scores(edge_rng, CAP_BATCH, la.LANE_MAX_LEN, la.LANE_MAX_LEN, EXP_LONG_LE,
                                dev) + cap_lens))
    path_la = {"K2": factored(rna_sq), "K5": protein(aa_sq), "K3": factored(prof_sq),
               "K4": protein(aa_sq)}
    for key, ops in path_la.items():
        cols = wider_cols(key, ops)
        la_cases.append((key, f"path batch padded {cols} columns wider", *la_fns[key, False],
                         pad_wider(key, ops, cols)))
    for key, label, kernel_fn, plain_fn, ops in la_cases:
        log = key in ("K2", "K5")
        got = kernel_fn(*ops)
        want = plain_fn(*ops)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        if "overflow" in label:  # non-finite exactly where the plain version is
            check(not bool(fin.all()), f"{key} {label}: the plain version does not overflow")
            check(torch.equal(torch.isfinite(got), fin),
                  f"{key} {label}: kernel non-finite at {torch.isfinite(got).tolist()}, plain "
                  f"version at {fin.tolist()}")
        else:
            check(bool(fin.all()), f"{key} {label}: plain version not finite")
            check(bool(torch.isfinite(got).all()), f"{key} {label}: kernel output not finite")
        err = (got[fin] - want[fin]).abs()
        rel = float((err / want[fin].abs()).max())
        metric, limit = (float(err.max()), LA_LOG_ATOL) if log else (rel, LA_EXP_RTOL)
        first3 = [o[:3].contiguous() for o in ops]
        alone = kernel_fn(*first3)
        same = bool(torch.equal(alone, got[:3]))
        geo = la_geometry(key, ops)
        print(f"{key} parity, {label}: {dims(key, ops)}, lanes x columns {geo}: max abs "
              f"{float(err.max()):.3e} max rel {rel:.3e} "
              f"({'abs' if log else 'rel'} limit {limit}); first 3 alone bit-identical {same}")
        check(metric <= limit, f"{key} {label}: kernel disagrees with its plain version")
        check(same, f"{key} {label}: a pair's value depends on its batch")
        r = report.setdefault(key, {"max_abs_err": 0.0, "max_rel_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], float(err.max()))
        r["max_rel_err"] = max(r["max_rel_err"], rel)
        # the lane kernels' and the one-warp kernel's worst apart
        f = (f"max_{'abs' if log else 'rel'}_err_"
             f"{'one_warp' if geo == (0, 0) else 'lanes'}")
        r[f] = max(r.get(f, 0.0), metric)
    ill_ops = factored((ill, ill))  # not gated: the plain version itself is 4e-2 from f64 here
    ill_err = float((fac(la.la_log_factored)(*ill_ops)
                     - fac(la.la_log_factored_reference)(*ill_ops)).abs().max())
    print(f"K2 at L={ILL_LEN} ({dims('K2', ill_ops)}, the one-warp kernel): max abs "
          f"{ill_err:.3e} from the plain version, not gated: f32 log K is good to about 1e-2 "
          f"at this length")
    for key, ops in path_la.items():  # the same pairs on two geometries
        log = key in ("K2", "K5")
        fn = la_fns[key, False][0]
        cols = wider_cols(key, ops)
        wide_ops = pad_wider(key, ops, cols)
        geo, geo_wide = la_geometry(key, ops), la_geometry(key, wide_ops)
        check(geo != geo_wide, f"{key}: padded {cols} columns wider, the path batch keeps "
                               f"the lane geometry {geo}")
        k, k_wide = fn(*ops), fn(*wide_ops)
        diff = float((k - k_wide).abs().max() if log else ((k - k_wide).abs() / k.abs()).max())
        limit = LA_LOG_ATOL if log else LA_EXP_RTOL
        w = width(key, ops)
        print(f"{key} path batch at Ly={w} {geo} and padded to {w + cols} {geo_wide}: max "
              f"{'abs' if log else 'rel'} diff {diff:.3e} (limit {limit})")
        check(diff <= limit, f"{key}: the two lane geometries disagree")

    # ---- 7. BPLA path ----
    reset_counts()
    t0 = time.perf_counter()
    bpla_kernel.main(["--device", "cuda", "-n", p("bpla.dat"),
                      "+1", p("pos.fa"), "-1", p("neg.fa")])
    bpla_train_s = time.perf_counter() - t0
    bpla_train_launches = counter("la.la_log_factored.calls")
    svm_tools.train_main([p("bpla.dat"), p("bpla.model")])
    t0 = time.perf_counter()
    bpla_kernel.main(["--device", "cuda", "-n", p("bpla_test.dat"),
                      "--model", p("bpla.model"), "--predict", p("bpla_pred.txt"),
                      "+1", p("pos.fa"), "-1", p("neg.fa"),
                      "--test", "+1", p("tpos.fa"), "-1", p("tneg.fa")])
    bpla_predict_s = time.perf_counter() - t0
    bpla_counts = counts()
    report["K2"]["launches"] = bpla_counts["K2"]
    labels, g_bpla = read_precomputed(p("bpla.dat"))
    print(f"BPLA path: train Gram {g_bpla.shape}, K2 launches {bpla_train_launches} (train) "
          f"{bpla_counts['K2']} (train + predict); all counts {bpla_counts}")
    check(bpla_train_launches > 0 and bpla_counts["K2"] > bpla_train_launches,
          "the BPLA path did not launch K2 in train and predict")
    gram_checks("bpla_kernel", g_bpla, n, labels, train_labels)
    bpla_auc = predictions(p("bpla_pred.txt"), 2 * N_TEST, "bpla_kernel")
    for d in ("cuda", "cpu"):
        bpla_kernel.main(["--device", d, "-n", p(f"bpla_small_{d}.dat"),
                          "+1", p("spos.fa"), "-1", p("sneg.fa")])
    bpla_small = float(np.abs(read_precomputed(p("bpla_small_cuda.dat"))[1]
                              - read_precomputed(p("bpla_small_cpu.dat"))[1]).max())
    print(f"BPLA predict: {2 * N_TEST} rows, AUC {bpla_auc:.4f}; 8 sequences cuda vs cpu: "
          f"Gram max abs diff {bpla_small:.3e} (band {BPLA_BAND})")
    check(bpla_small <= BPLA_BAND, "bpla_kernel: cuda and cpu Grams disagree")

    # ---- 8. LA path ----
    write_fasta(p("ppos.fa"), ppos, "p")
    write_fasta(p("pneg.fa"), pneg, "n")
    write_fasta(p("tppos.fa"), tppos, "tp")
    write_fasta(p("tpneg.fa"), tpneg, "tn")
    write_fasta(p("sppos.fa"), ppos[:4], "p")
    write_fasta(p("spneg.fa"), pneg[:4], "n")
    reset_counts()
    t0 = time.perf_counter()
    la_kernel.main(["--device", "cuda", "-n", p("la.dat"),
                    "+1", p("ppos.fa"), "-1", p("pneg.fa")])
    la_train_s = time.perf_counter() - t0
    la_train_launches = counter("la.la_exp.calls")
    la_train_lanes = counter("la.la_exp.lanes")
    svm_tools.train_main([p("la.dat"), p("la.model")])
    la_kernel.main(["--device", "cuda", "-n", p("la_test.dat"),
                    "--model", p("la.model"), "--predict", p("la_pred.txt"),
                    "+1", p("ppos.fa"), "-1", p("pneg.fa"),
                    "--test", "+1", p("tppos.fa"), "-1", p("tpneg.fa")])
    la_counts = counts()
    report["K4"]["launches"] = la_counts["K4"]
    labels, g_la = read_precomputed(p("la.dat"))
    la_lanes = counter("la.la_exp.lanes")
    print(f"LA path: train Gram {g_la.shape}, K4 launches {la_train_launches} (train) "
          f"{la_counts['K4']} (train + predict), on a lane geometry {la_train_lanes} (train) "
          f"{la_lanes} (train + predict); all counts {la_counts}")
    check(la_train_launches > 0 and la_counts["K4"] > la_train_launches,
          "the LA path did not launch K4 in train and predict")
    check(la_train_lanes > 0 and la_lanes > la_train_lanes,
          "the LA path did not run K4's lane kernel in train and predict")
    gram_checks("la_kernel", g_la, n, labels, train_labels)
    la_auc = predictions(p("la_pred.txt"), 2 * N_TEST, "la_kernel")
    for d in ("cuda", "cpu"):
        la_kernel.main(["--device", d, "-n", p(f"la_small_{d}.dat"),
                        "+1", p("sppos.fa"), "-1", p("spneg.fa")])
    la_small = float(np.abs(read_precomputed(p("la_small_cuda.dat"))[1]
                            - read_precomputed(p("la_small_cpu.dat"))[1]).max())
    print(f"LA predict: {2 * N_TEST} rows, AUC {la_auc:.4f}; 8 proteins cuda vs cpu: "
          f"Gram max abs diff {la_small:.3e} (band {BPLA_BAND})")
    check(la_small <= BPLA_BAND, "la_kernel: cuda and cpu Grams disagree")
    tmp_dir.cleanup()

    # ---- 9. flagship forward: the exp BPLA Gram through the model class ----
    reset_counts()
    g_fwd = PairKernelEngine(BPLAKernel().to(dev), prof_feats, device=dev,
                             batch_size=LA_BATCH).gram(normalize=True)
    fwd_counts = counts()
    fwd_lanes = counter("la.la_exp_factored.lanes")
    report["K3"]["launches"] = fwd_counts["K3"]
    print(f"flagship forward: exp Gram {g_fwd.shape} of random-profile examples "
          f"(L 32-64); K3 on a lane geometry {fwd_lanes}; all counts {fwd_counts}")
    check(fwd_counts["K3"] > 0, "the flagship forward never launched K3")
    check(fwd_lanes > 0, "the flagship forward never ran K3's lane kernel")
    gram_checks("flagship forward", g_fwd, n)

    # ---- 10. log protein Gram: BLOSUM62 has rank 22, so K5 ----
    prot_kernel = BPLAKernel(BLOSUM62, no_bp=True, gap=PROT[1], ext=PROT[2], beta=PROT[0])
    reset_counts()
    g_log = PairKernelEngine(prot_kernel.to(dev).log_value, aa_train, device=dev,
                             batch_size=LA_BATCH, log_values=True).gram(normalize=True)
    log_counts = counts()
    report["K5"]["launches"] = log_counts["K5"]
    log_vs_exp = float(np.abs(g_log - g_la).max())
    print(f"log protein Gram: {g_log.shape}; all counts {log_counts}; against the LA "
          f"path's exp Gram: max abs diff {log_vs_exp:.3e} (band {BPLA_BAND})")
    check(log_counts["K5"] > 0, "the log protein Gram never launched K5")
    gram_checks("log protein", g_log, n)
    check(log_vs_exp <= BPLA_BAND, "the log (K5) and exp (K4) protein Grams disagree")

    # ---- 11. times ----
    timing = {
        "K2": (fac(la.la_log_factored), fac(la.la_log_factored_reference), factored(rna_sq)),
        "K3": (fac(la.la_exp_factored), fac(la.la_exp_factored_reference), factored(prof_sq)),
        "K4": (mat(la.la_exp), mat(la.la_exp_reference), protein(aa_sq)),
        "K5": (mat(la.la_log), mat(la.la_log_reference), protein(aa_sq)),
    }
    for key, (kernel_fn, plain_fn, ops) in timing.items():
        ms, plain_ms = timed_pair(lambda: kernel_fn(*ops), lambda: plain_fn(*ops), 5)
        dev_ms = graph_ms(lambda: kernel_fn(*ops), 5)  # noqa: B023
        bound_ms, bound_by = la_bound(key, ops)
        report[key].update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
        print(f"times on {smi}: {key} {ms:.4f} ms a wrapper call (device {dev_ms:.4f}) vs "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} ({dims(key, ops)})")
    # the lane geometries at B = 256: K2 on the BPLA path's batch, K5 on the
    # log protein Gram's, K4 on the LA path's, K3 on the flagship's, K2, K3
    # and K4 on random operands at the other widths the routes cover (K3's
    # and K4's with log emissions in EXP_LONG_LE, so that K stays finite);
    # device ms a call (graph replay) of every geometry that holds the width
    # at most 4x over, and of the one-warp kernel, (0, 0); K3 and K4 also on
    # B = 4096 pairs of their paths.  These times place LOG_ROUTE and
    # EXP_ROUTE.
    big_idx = lambda m: rng.integers(0, m, BIG_BATCH)  # noqa: E731
    big_rna = (pick(rna_feats, big_idx(n), dev), pick(rna_feats, big_idx(n), dev))
    big_aa = (pick(aa_train, big_idx(n), dev), pick(aa_train, big_idx(n), dev))
    big_prof = (pick(prof_feats, big_idx(n), dev), pick(prof_feats, big_idx(n), dev))
    geo_rng = np.random.default_rng(SEED + 7)
    tables = [("K2", "BPLA path batch", BPLA, path_la["K2"]),
              ("K5", "log protein batch", PROT, path_la["K5"]),
              ("K4", "LA path batch", PROT, path_la["K4"]),
              ("K3", "flagship batch", BPLA, path_la["K3"]),
              ("K4", "LA path pairs", PROT, protein(big_aa)),
              ("K3", "flagship pairs", BPLA, factored(big_prof))]
    for w in ROUTE_WIDTHS:
        lens = [torch.full((LA_BATCH,), SEQ_LEN, dtype=torch.int32, device=dev),
                torch.as_tensor(geo_rng.integers(w // 2 + 1, w + 1, LA_BATCH).astype(np.int32),
                                device=dev)]
        fxy = [torch.as_tensor((geo_rng.normal(size=(LA_BATCH, n, 6)) * 0.4).astype(np.float32),
                               device=dev) for n in (SEQ_LEN, w)]
        tables.append(("K2", "random factors", BPLA, fxy + lens))
        tables.append(("K3", "random factors", BPLA,
                       exp_factors(geo_rng, LA_BATCH, SEQ_LEN, w, 6, EXP_LONG_LE, dev) + lens))
        tables.append(("K4", "random scores", PROT,
                       exp_scores(geo_rng, LA_BATCH, SEQ_LEN, w, EXP_LONG_LE, dev) + lens))
    at_fns = {"K2": (la.la_log_factored_at, la.LOG_GEOMETRIES),
              "K5": (la.la_log_at, la.LOG_GEOMETRIES),
              "K3": (la.la_exp_factored_at, la.EXP_GEOMETRIES["factored"]),
              "K4": (la.la_exp_at, la.EXP_GEOMETRIES["scores"])}
    for key, label, params, ops in tables:
        w = width(key, ops)
        at, library = at_fns[key]
        cells = []
        for geo in [(0, 0)] + [g for g in library if w <= g[0] * g[1] <= 4 * w]:
            t = graph_ms(lambda: at(geo, *ops, *params), 5)  # noqa: B023
            cells.append(f"{'one-warp' if geo == (0, 0) else '%dx%d' % geo} {t:.4f}")
        print(f"times on {smi}: {key} lane geometries (lanes x columns, ms), {label} "
              f"({dims(key, ops)}); the route takes {la_geometry(key, ops)}: {'; '.join(cells)}")
    for key, ops in (("K2", factored(big_rna)), ("K5", protein(big_aa)),
                     ("K3", factored(big_prof)), ("K4", protein(big_aa))):
        kernel_fn, plain_fn = la_fns[key, False]
        ms, plain_ms = timed_pair(lambda: kernel_fn(*ops), lambda: plain_fn(*ops), 2)  # noqa: B023
        dev_ms = graph_ms(lambda: kernel_fn(*ops), 3)  # noqa: B023
        bound_ms, bound_by = la_bound(key, ops)
        print(f"times on {smi}: {key} at B={BIG_BATCH} {ms:.4f} ms a wrapper call (device "
              f"{dev_ms:.4f}) vs plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by} ({dims(key, ops)}, lanes x columns {la_geometry(key, ops)})")
    long_timing = {
        "K2": (fac(la.la_log_factored), fac(la.la_log_factored_reference),
               factored((long_x, long_y))),
        "K3": (fac(la.la_exp_factored), fac(la.la_exp_factored_reference), long_f),
        "K4": (mat(la.la_exp), mat(la.la_exp_reference), long_s),
        "K5": (mat(la.la_log), mat(la.la_log_reference), long_s),
    }
    for key, (kernel_fn, plain_fn, ops) in long_timing.items():
        ms, plain_ms = timed_pair(lambda: kernel_fn(*ops), lambda: plain_fn(*ops), 2)
        bound_ms, bound_by = la_bound(key, ops)
        print(f"times on {smi}: {key} at Ly={LONG_LY} {ms:.4f} ms vs plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({dims(key, ops)}, one block a pair)")
    rates = {}
    for label, fn, feats, log_values in (
            ("bpla_kernel", kern.log_value, rna_feats, True),
            ("la_kernel", lambda x, y: la.la_exp_auto(*protein((x, y)), *PROT), aa_train, False),
            ("flagship", kern, prof_feats, False)):
        eng = PairKernelEngine(fn, feats, device=dev, batch_size=LA_BATCH, log_values=log_values)
        eng.gram(normalize=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.gram(normalize=True)
        torch.cuda.synchronize()
        rates[label] = n_pairs / (time.perf_counter() - t0)
    print(f"times on {smi}: bpla_kernel Gram {rates['bpla_kernel']:.1f} pairs/s, "
          f"la_kernel Gram {rates['la_kernel']:.1f} pairs/s, flagship exp Gram "
          f"{rates['flagship']:.1f} pairs/s ({n_pairs} pairs each); "
          f"bpla_kernel train flow {bpla_train_s:.2f} s (fold + features "
          f"{bpla_featurize_s:.2f} s), predict flow {2 * N_TEST / bpla_predict_s:.2f} rows/s; "
          f"la_kernel train flow {la_train_s:.2f} s")

    # ---- 12. K6 parity at full width (n = 301, band 16, B = 16) ----
    full_train, full_test, full_feats = k6_feats()
    report["K6"], k6_ops, k6_wide = k6_parity(dev, full_feats, np.random.default_rng(SEED + 2))

    # ---- 13. full stem path: stem_kernel -n -b 16 train, svm train, predict ----
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    half, thalf = FULL_N // 2, FULL_TEST // 2
    write_fasta(p("fpos.fa"), full_train[:half], "p")
    write_fasta(p("fneg.fa"), full_train[half:], "n")
    write_fasta(p("ftpos.fa"), full_test[:thalf], "tp")
    write_fasta(p("ftneg.fa"), full_test[thalf:], "tn")
    n_a = min(FULL_A // 2, half)  # the -a run's sequences per class
    write_fasta(p("fapos.fa"), full_train[:n_a], "p")
    write_fasta(p("faneg.fa"), full_train[half:half + n_a], "n")
    band_flags = ["-b", str(FULL_BAND)]
    reset_counts()
    t0 = time.perf_counter()
    stem_kernel.main(["--device", "cuda", "-n", *band_flags, p("full.dat"),
                      "+1", p("fpos.fa"), "-1", p("fneg.fa")])
    full_train_s = time.perf_counter() - t0
    full_train_launches = counter("k6.calls")
    svm_tools.train_main([p("full.dat"), p("full.model")])
    t0 = time.perf_counter()
    stem_kernel.main(["--device", "cuda", "-n", *band_flags, p("full_test.dat"),
                      "--model", p("full.model"), "--predict", p("full_pred.txt"),
                      "+1", p("fpos.fa"), "-1", p("fneg.fa"),
                      "--test", "+1", p("ftpos.fa"), "-1", p("ftneg.fa")])
    full_predict_s = time.perf_counter() - t0
    full_counts = counts()
    report["K6"]["launches"] = full_counts["K6"]
    labels, g_full = read_precomputed(p("full.dat"))
    full_labels = ["+1"] * half + ["-1"] * half
    n_full_pairs = FULL_N * (FULL_N + 1) // 2
    full_auc = predictions(p("full_pred.txt"), FULL_TEST, "stem_kernel -b")
    print(f"full stem path (-b {FULL_BAND}): train Gram {g_full.shape}, {n_full_pairs} pairs, "
          f"K6 launches {full_train_launches} (train) {full_counts['K6']} (train + predict); "
          f"all counts {full_counts}; predict: {FULL_TEST} rows, AUC {full_auc:.4f} (both "
          "classes come from one generator, as in config 3)")
    check(full_train_launches > 0 and full_counts["K6"] > full_train_launches,
          "the full stem path did not launch K6 in train and predict")
    gram_checks("stem_kernel -b", g_full, FULL_N, labels, full_labels)
    reset_counts()
    t0 = time.perf_counter()
    stem_kernel.main(["--device", "cuda", "-n", *band_flags, "-a", "0.5", p("full_a.dat"),
                      "+1", p("fapos.fa"), "-1", p("faneg.fa")])
    full_a_s = time.perf_counter() - t0
    a_counts = counts()
    labels, g_a = read_precomputed(p("full_a.dat"))
    print(f"full stem path (-b {FULL_BAND} -a 0.5): train Gram {g_a.shape} in {full_a_s:.2f} s; "
          f"all counts {a_counts}")
    check(a_counts["K6"] > 0, "the -a path never launched K6")
    gram_checks("stem_kernel -b -a", g_a, 2 * n_a, labels, ["+1"] * n_a + ["-1"] * n_a)

    # ---- 14. --device cpu against --device cuda, banded and dense ----
    small_full = make_mixed(6, seed=SEED + 3, lo=60, hi=90)
    write_fasta(p("sfpos.fa"), small_full[:3], "p")
    write_fasta(p("sfneg.fa"), small_full[3:], "n")
    for route, flags in (("-b 8", ["-b", "8"]), ("dense", [])):
        for d in ("cuda", "cpu"):
            stem_kernel.main(["--device", d, "-n", *flags, p(f"sf_{d}.dat"),
                              "+1", p("sfpos.fa"), "-1", p("sfneg.fa")])
        diff = float(np.abs(read_precomputed(p("sf_cuda.dat"))[1]
                            - read_precomputed(p("sf_cpu.dat"))[1]).max())
        print(f"stem_kernel {route}, 6 sequences of 60-90 nt, cuda vs cpu: Gram max abs "
              f"diff {diff:.3e} (band {FULL_CPU_BAND})")
        check(diff <= FULL_CPU_BAND, f"stem_kernel {route}: cuda and cpu Grams disagree")
    tmp_dir.cleanup()

    # ---- 15. K6 times, and the -b 16 train Gram's rate ----
    k6_ms, k6_plain_ms = timed_pair(
        lambda: full_stem_banded_log(*k6_ops, *FULL_WEIGHTS, band=FULL_BAND),
        lambda: full_stem_banded_log_reference(*k6_ops, *FULL_WEIGHTS, band=FULL_BAND), 3)
    k6_bound_ms, k6_by = k6_bound(k6_ops, FULL_BAND)
    # K6's wrapper reads max(lx) on the host, so no graph captures it
    k6_dev, k6_n = kernel_trace(
        lambda: full_stem_banded_log(*k6_ops, *FULL_WEIGHTS, band=FULL_BAND), 2, "full_stem_level")
    report["K6"].update(ms=k6_ms, device_ms=k6_dev, plain_ms=k6_plain_ms, bound_ms=k6_bound_ms,
                        bound_by=k6_by, launches_a_call=k6_n)
    # a call's time at each batch of the first pairs of 64 (the CLI runs 16)
    n_ex = len(full_feats["length"])
    bix = np.random.default_rng(SEED + 9).integers(0, n_ex, (2, max(K6_BATCHES)))
    bx, by = pick(full_feats, bix[0], dev), pick(full_feats, bix[1], dev)
    bops = [bx["codes"], by["codes"], bx["length"], by["length"], bx["bp"], by["bp"]]
    rows = []
    for bsz in K6_BATCHES:
        sub = [o[:bsz].contiguous() for o in bops]
        full_stem_banded_log(*sub, *FULL_WEIGHTS, band=FULL_BAND)
        ms = cuda_ms(lambda: full_stem_banded_log(*sub, *FULL_WEIGHTS, band=FULL_BAND), 3)
        big = torch.maximum(sub[2], sub[3]).double()
        rows.append(f"B={bsz} {ms:.3f} ms a call, {ms / bsz:.3f} a pair (mean max(lx, ly) "
                    f"{float(big.mean()):.1f})")
    print(f"times on {smi}: K6 band {FULL_BAND} n={bops[0].shape[1]} by batch: "
          + "; ".join(rows))
    w_ms, w_plain_ms = timed_pair(
        lambda: full_stem_banded_log(*k6_wide, *FULL_WEIGHTS, band=WIDE_BAND),
        lambda: full_stem_banded_log_reference(*k6_wide, *FULL_WEIGHTS, band=WIDE_BAND), 1)
    w_bound_ms, w_by = k6_bound(k6_wide, WIDE_BAND)
    print(f"times on {smi}: K6 band {WIDE_BAND} {w_ms:.3f} ms vs plain {w_plain_ms:.3f} ms, bound "
          f"{w_bound_ms:.4f} ms by {w_by} (B=8 n={k6_wide[0].shape[1]})")
    cli_feats = stem_features(full_train, max(len(x) for x in full_train) + 1)

    def banded_fn(x, y):
        return full_stem_banded_log(x["codes"], y["codes"], x["length"], y["length"],
                                    x["bp"], y["bp"], *FULL_WEIGHTS, band=FULL_BAND)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    PairKernelEngine(banded_fn, cli_feats, device=dev, batch_size=16,
                     log_values=True).gram(normalize=True)
    torch.cuda.synchronize()
    full_gram_s = time.perf_counter() - t0
    busy = device_busy(PairKernelEngine(banded_fn, cli_feats, device=dev, batch_size=16,
                                        log_values=True), FULL_N, "full_stem_level")
    print(f"-b {FULL_BAND} Gram, first 20 batches traced: {busy}")
    k6_dev_s = "not measured" if k6_dev is None else f"{k6_dev:.3f}"
    print(f"times on {smi}: K6 {k6_ms:.3f} ms (device {k6_dev_s}, {k6_n} launches a call) vs plain {k6_plain_ms:.3f} "
          f"ms, bound {k6_bound_ms:.4f} ms by {k6_by} (B=16 n={k6_ops[0].shape[1]} "
          f"band={FULL_BAND}, lx != ly); -b {FULL_BAND} Gram {n_full_pairs / full_gram_s:.1f} pairs/s "
          f"({full_gram_s:.2f} s, batch 16); train flow {full_train_s:.2f} s, predict flow "
          f"{FULL_TEST / full_predict_s:.2f} rows/s ({full_predict_s:.2f} s)")

    slice4_phases(dev, smi, reset_counts, counts)
    slice5_phase(dev, smi, reset_counts, counts, (pos, neg, tpos, tneg),
                 {"g": g_stem, "launches": train_launches + train_wide, "train_s": train_s,
                  "predict_s": predict_s}, g_bpla)
    slice6_phase(dev, smi, reset_counts, counts, (pos, neg, tpos, tneg))
    slice7_phase(smi, reset_counts, counts, (pos, neg, tpos, tneg), (ppos, pneg), prof_feats,
                 full_train, {"km.dat": g_stem, "bpla.dat": g_bpla, "flagship.npy": g_fwd,
                              "la.dat": g_la})
    report["SK"] = {**string_phase(dev, smi), "launches": train_string}
    report["FD"] = {**fold_phase(smi), "launches": train_fold}

    meta = {
        "K1": ("stem_fixed_point", "stem_kernel_torch/csrc/stem_fixed_point.cu",
               "stem_kernel_tpu/ops/pallas_stem.py:119"),
        "K1w": ("stem_fixed_point_per_product", "stem_kernel_torch/csrc/stem_fixed_point.cu",
                "stem_kernel_tpu/ops/pallas_stem.py:119"),
        "K2": ("la_log_factored", "stem_kernel_torch/csrc/la_dp.cu",
               "stem_kernel_tpu/ops/pallas_la.py:604"),
        "K3": ("la_exp_factored", "stem_kernel_torch/csrc/la_dp.cu",
               "stem_kernel_tpu/ops/pallas_la.py:563"),
        "K4": ("la_exp", "stem_kernel_torch/csrc/la_dp.cu",
               "stem_kernel_tpu/ops/pallas_la.py:137"),
        "K5": ("la_log", "stem_kernel_torch/csrc/la_dp.cu",
               "stem_kernel_tpu/ops/pallas_la.py:281"),
        "K6": ("full_stem_banded_log", "stem_kernel_torch/csrc/full_stem_banded.cu",
               "stem_kernel_tpu/ops/pallas_full_stem.py:426"),
        "SK": ("string_dp_profile", "stem_kernel_torch/csrc/string_dp.cu", None),
        "FD": ("fold_dp", "stem_kernel_torch/csrc/fold_dp.cu", None),
    }
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    extra = ("device_ms", "fold_ms", "max_rel_err", "mode", "shape", "launches_a_call",
             "max_abs_err_lanes",
             "max_abs_err_one_warp",
             "max_rel_err_lanes", "max_rel_err_one_warp")
    # K1's library_ms is the f32 torch.bmm chain at the same pair-trips
    # (chain_ms); K1's and K1w's "shape" is where they were timed; no PyTorch call
    # computes K2-K6's functions: null
    print(json.dumps({"kernels": [
        {"name": nm, "route": "cuda", "source": src, "replaces": rep,
         **{f: report[k][f] for f in keys}, "library_ms": report[k].get("library_ms"),
         **{f: report[k][f] for f in extra if f in report[k]}}
        for k, (nm, src, rep) in meta.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--k6-values"]:
        sys.exit(k6_values(sys.argv[2]))
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--fold-dp"]:
        sys.exit(fold_main())
    sys.exit(main())
