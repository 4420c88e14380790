#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dla_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases 24-26,3   # these phases only (and phase 1)

Phases, each of which raises on failure (exit code non-zero, no final line):

1. the card: name, power limit, torch and CUDA versions, the kernel build
   (one ``nvcc`` per source, started together);
2. the dense trailing-update kernel against its plain torch version on the
   card, at the main path's shapes (m=16384, nb=tb=1024, origin 0 and 8) for
   the fp32 tiers, fp64 and bf16 storage, plus a ragged m=96, tb=32 case;
   upper tiles must come back bit-identical; kernel and plain times by CUDA
   events, the rate and the share of the bound; which block body one call
   launched (the kernel library's count of launches through each body:
   ``wgmma`` for fp32 ``high``/``default`` and bf16, ``simt`` for ``highest``,
   ``dmma`` for fp64, as ``tiles.trailing_body`` says); at ``highest`` and
   fp64 the output must also be, bit for bit, what the task kernels' scalar
   body (the same fma chain per element, through the test-only entry
   ``tiles.tile_op_reference``) gives tile column by tile column;
3. the main path: ``plgsy(16384)`` → ``potrf_inplace`` in fp32 at ``high``
   (nb=tb=kb=1024, ib=512, two-level diagonal factor), the kernel launched
   n/nb − 1 times per factorization, the residual under the driver's gate;
4. the kernel path against the plain path: N=4096 fp32 on the card against
   the same input through the plain versions on the CPU, and N=4096 fp64
   under the reference's own 1e-10 gate;
5. the driver, ``dla_tpu_torch.cli.potrf_driver``, at N=16384;
6. the packed trailing-update kernel against its plain version on the card:
   N=81920, w=4096, ktb=1024 at steps k=0 and k=nt/2 for the fp32 tiers,
   bf16 storage at the same shape, fp64 at N=32768, and a ragged n=384,
   w=96, ktb=32 case; elements outside the visited tiles must come back
   bit-identical and each call must launch the kernel once; the body, rate,
   share of the bound and, at ``highest`` and fp64, the bits of
   the task kernels' scalar body as in phase 2;
7. the packed path at the reference's ``default:packed`` tier:
   ``plgsy_packed(81920, 4096)`` → ``potrf_packed(trailing="pallas")`` in
   fp32 at ``default`` (ktb=1024, kb=4096, ib=512, two-level diagonal
   factor), the packed kernel launched n/w − 1 = 19 times per
   factorization, the matrix-free Freivalds value under the fp32 gate;
8. the packed kernel path against the plain path: N=4096 fp32 on the card
   against the CPU, N=4096 fp64 under 1e-10, bf16 storage at N=16384;
9. the driver with ``--mode packed --trailing pallas`` at phase 7's size;
10. the df64 trailing-update kernel against its plain version on the card at
    the f64x path's shapes (m=24576, tb=512, nb=1024, s=7, w=8, origin 0 and
    24), plus an nk=2 case (w=9) and a tb=96 case: both planes must come back
    **bit-identical** to the plain version, elements outside the visited
    tiles bit-unchanged, one launch per call; the block body (``wgmma``, the
    only df64 body), kernel and plain times, the kernel's rate counted as
    s(s+1)/2 = 28 one-pass products, and its share of the bound;
11. the f64x path, the reference's emulated-fp64 tier: ``plgsy(24576)`` in
    fp32 with lo = 0 → ``potrf_df64(nb=1024, s=7, trailing="pallas",
    tb=512)``, one warm-up and two timed repeats, the kernel launched
    N/nb − 1 = 23 times per factorization, the blocked df64 residual under
    1e-10 and the native fp64 residual of the same factor under it;
    then the port's native fp64 ``potrf_inplace`` at the same N, timed once
    beside it and beside ``NATIVE_FP64_BEFORE``, kernel #1 launched
    N/nb − 1 = 23 times, every launch through the ``dmma`` body;
12. the df64 kernel path against the plain path: N=4096 factored on the card
    and through the plain versions on the CPU, max|ΔL| ≤ 1e-12·max|L|, both
    df64 residuals under 1e-10;
13. the driver with ``--mode df64 --trailing pallas`` at phase 11's size;
14. the panel kernels against their plain versions on the card:
    ``panel_factor`` (kernel #4) at m=32768, nb=512 for the fp32 tiers and
    fp64 at m=8192, with NaN above the diagonal, its diagonal block held to
    the plain version's bits, its product through the block body
    ``panel.panel_factor_body`` names (``wgmma`` at ``high``/``default``,
    ``simt`` at ``highest``, ``dmma`` for fp64; the other kernels' body
    counts unmoved), at ``highest`` and fp64 bit for bit the scalar body's
    trsm (``tiles.tile_op_reference``, tile 0) of the rows below with
    ``potrf_tile``'s inverse of the block, the card's time alone beside the
    calls' back to back, its diagonal phase timed alone (m = nb) beside
    ``cholesky_ex`` + ``solve_triangular`` and its bound, with the launches
    and the largest grid of its schedule; ``panel_apply`` (kernel #3) at
    m=15360, nb=1024, ib=256, tb=1024 (the first panel of phase 17) for the
    fp32 tiers, with the block body that ran (``wgmma`` at ``high`` and
    ``default``, ``simt`` at ``highest``; the task kernels' count unmoved),
    at ``highest`` bit for bit its schedule's products replayed through the
    scalar body on the same inverses, and its launches a call, beside
    ``torch.linalg.solve_triangular``; and at the path's last panels
    (m=3072, 1024), calls back to back beside the same calls queued behind a
    sleeping kernel, which shows the host's share;
15. the reference's ``highest`` tier at its full size: ``plgsy(32768)`` →
    ``potrf_shrink(nb=8192, panel="blocktrsm", trailing="pallas", tb=1024,
    kb=256, trailing_alias=False, diag_factor="lax", precision="highest",
    ib=512)``, a warm-up and three timed repeats, kernel #1 launched 3 times
    per factorization, every launch through the ``simt`` body, the residual
    under the fp32 gate, the median beside ``HIGHEST_PATH_BEFORE``;
16. the ``panel_factor`` path at the same matrix: ``potrf_shrink(nb=512,
    panel="pallas", trailing="pallas")`` at ``highest`` and at ``high``, 64
    panel_factor and 63 trailing launches per factorization, each kernel's
    through the body of the tier (#4: ``simt``, ``wgmma``; #1 the same), the
    residual under the fp32 gate at both, the ``highest`` median beside
    ``PANEL_FACTOR_PATH_BEFORE``;
17. the ``panel_apply`` path at the main path's configuration:
    ``potrf_inplace(panel="pallas", panel_ib=256)``, 15 panel_apply and 15
    trailing launches per factorization, every panel_apply call through the
    ``wgmma`` body, its median beside phase 3's and beside the path's median
    before #3's redesign (``PANEL_APPLY_PATH_BEFORE``);
18. every ``potrf`` mode on the card against the plain versions on the CPU
    at N=4096: the default ``mode="blocked"``, blocked with both kernels
    (nb=512), masked (nb=512) and shrink with ``panel="invgemm"``;
19. the driver with ``--mode shrink`` at phase 15's configuration;
20. the packed df64 trailing-update kernel against its plain version on the
    card at the packed df64 path's shapes (n=40960, nb=1024, tb=512, s=7, w=8,
    steps k=0 and k=nt/2), plus an nk=2 case (w=9, s=6) and a tb=96 case at
    small n: both planes **bit-identical** to the plain version, elements
    outside the visited tiles bit-unchanged, one launch per call; the body,
    kernel and plain times, the rate counted as 28 one-pass products, and the
    share of the bound;
21. the packed df64 path at the JAX package's packed-df64 record size:
    ``plgsy_packed(40960, 1024, seed=51)`` in fp32 with lo = 0 →
    ``potrf_packed_df64(ktb=512, s=7)``, one timed factorization (no warm-up:
    the kernels are built and loaded by then), the kernel launched
    N/nb − 1 = 39 times, peak memory, ``freivalds_packed_df64`` under 1e-10
    and the native fp64 residual of the unpacked factor beside it;
22. the packed df64 kernel path against the plain path at N=4096: card
    against CPU, max|ΔL| ≤ 1e-12·max|L|; ``potrf_packed_df64`` against
    ``potrf_df64`` on the same matrix and ``potrf_packed_df64_split(split=2)``
    bit for bit; ``potrs_packed_df64`` (both engines) and ``potrs_df64`` under
    the reference's 1e-10 posv gate; the three df64 Freivalds gates on one
    factor, and the packed one on the card against the CPU;
23. the driver with ``--mode df64-packed`` at N=16384 (phase 21 runs the path
    at its full size; the driver's gate is the blocked df64 residual of the
    unpacked factor, as at N=40960), and with
    ``--df64-split 2`` at N=8192 under a validation budget of one byte, which
    sends it to the packed-native Freivalds gate;
24. the four task kernels against their plain versions on the card:
    ``potrf_tile`` (#5), ``trsm_tile`` (#6), ``syrk_tile`` (#7) and
    ``gemm_tile`` (#8) at the tile-task path's tile (n=512) for the fp32 tiers,
    fp64 and (#6 to #8) bf16 storage, a ragged case (n=96; m=200, k=72), and #6
    to #8 at m=4096, n=k=2048, a size clear of the launch floor; inputs
    bit-unchanged, #5's L and inv(L) the plain version's bits (with its
    schedule's launches and largest grid), #7's upper triangle bit-identical
    to C's, one launch per call, through the block body ``tiles.tile_op_body``
    names (the library's count of launches through each body: ``wgmma`` for
    #6 to #8 at fp32 ``high``/``default`` and bf16, ``simt`` at fp32
    ``highest``, ``dmma`` at fp64); on the two chain bodies, also at the fp64
    path's tile (256), ragged and in fp64 at m=4096, n=k=2048 (#7: n=k=2048),
    the bits of the scalar body (``tiles.tile_op_reference``) at the
    launcher's tile edge and, for ``simt``, at both edges, and the card's
    time alone (launches queued behind a sleeping kernel) of the kernel, of
    the scalar body and of each ``simt`` edge; beside ``torch.matmul`` (#6),
    ``torch.addmm`` (#8; for #7 on the full square, a yardstick, since no one
    call masks the triangle) and ``cholesky_ex`` + ``solve_triangular`` (#5,
    two calls, their sum);
25. the tile-task path, the reference's task DAG with one launch per task:
    ``plgsy(16384, seed=51)`` fp32 at ``high``, NB=512, a warm-up and two timed
    factorizations, each launching exactly ``dag_counts(32)`` = 32 POTRF + 496
    TRSM + 496 SYRK + 4960 GEMM = 5984 task kernels, the residual under the
    fp32 gate with the path's median time beside it, and that time beside
    phase 3's; and fp64 at N=4096, NB=256 under the reference's 1e-10 gate,
    every product task through the ``dmma`` body, its factor bit for bit the
    one the same DAG gives with #6 to #8 on the scalar body
    (``tiles.tile_op_reference``; the body they ran before their chain
    bodies);
26. ``freivalds_device`` on the main path's factor beside ``residual_potrf``
    of the same factor (both under the gate), and on that factor with one
    corrupted tile (far above it);
27. the tiered bench, ``python -m dla_tpu_torch.bench.bench``, as a process of
    its own, with the two tiers nothing else here drives:
    ``high:inplace:1024:1024:61440`` (gated by ``freivalds_device``) and
    ``bf16:packed:4096:4096:106496``, two timed factorizations each; one JSON
    line per tier, both gates passed, exit code 0;
28. the driver with ``--mode inplace`` at N=61440, where the exact residual
    does not fit the card: PASS through the Freivalds gate;
29. the ring collectives against their plain versions on a flat mesh of D=4
    members on the card: ``ring_broadcast`` (#11) at the ring planes' largest
    panel (15360 × 1024 fp64, 48 chunks, root 1) and factor tile (1024 × 1024,
    32 chunks), and in two sub-rings (``group=2``, roots 0 and 1), the
    non-root blocks NaN (never read);
    ``ring_all_gather`` (#12) at 1024 × 1024 fp64 with ``group`` 4 and 2, and
    the flat-mesh P×Q row-broadcast check (``group=2``) that gives #12 its
    launch count: every output the plain version's **bits**; the kernel's cut
    (``ring_plan``); kernel, plain and library times (``expand(D, m,
    n).clone()``; ``torch.cat`` per member) of calls back to back, as every
    other phase times them, and beside them (``queued`` in the kernels line)
    the same calls queued behind a sleeping kernel, which hides the host's
    time per call; and the bound;
30. to 32. the three flat-mesh ring planes at N=16384, nb=1024, D=4 members on
    the card (``__graft_entry__.dryrun_multichip`` planes 2, 3 and 6): dense
    column-cyclic fp64 (``plgsy(…, seed=7)``), packed column-cyclic fp64
    (seed 3), packed column-cyclic df64 (seed 17, s=7, w=8); one warm-up and
    two timed factorizations each, exactly 2·nt − 1 = 31 ``ring_broadcast``
    launches per factorization, the time inside them (CUDA events around each
    call), and the residual under the reference's 1e-10 gate.

33. the dense solve and serving path at the main path's width: ``plgsy(16384)``
    fp32 factored by ``potrf_inplace`` as in phase 3 (kernel #1 launched
    n/nb − 1 times, counted from 0 around the factorization), nrhs = 64
    seeded right-hand sides; ``potrs``, ``potri`` + ``solve_inverse`` and
    ``posv_refined_host`` (an fp32 ``potrf_shrink`` factor, fp64 residuals on
    the card), each timed, each ``residual_posv`` under the driver's gate
    (N·2e-6 for the fp32 solves, 1e-10 refined), and the fp32 solves within
    ``FWD_TOL`` (1e-4, max norm) of an fp64 ``cholesky_solve`` on the same
    factor, which a solve at a lower precision would miss; the driver with
    ``--mode inplace --solve refined --nrhs 64`` at N=16384 (``SOLVE PASS``,
    exit code 0, A regenerated in fp64 by the native host generator); and
    one fp64 ``posv_refined`` at N=8192 under 1e-10.
34. the packed serving path through the driver: ``--mode packed --solve
    inverse`` (``potri_packed`` in place on the packed factor, then
    ``solve_inverse_packed``), ``--solve potrs`` (``potrs_packed``) and
    ``--solve refined`` (``posv_refined_streamed``: ``potrs_packed``
    corrections, fp64 residuals streamed from the native host generator) at
    N=32768, nb=4096 (fp32, the packed kernel #2 on its trailing update),
    nrhs = 64 right-hand sides of ones: the driver's times, the solve
    residual (``residual_posv_streamed``, A regenerated from its seed) with
    ``SOLVE PASS`` under N·2e-6 (1e-10 refined, with its iterations), and the
    peak device memory of each call beside the packed triangle's bytes.
35. the out-of-core path through ``python -m dla_tpu_torch.cli.oocore_driver``
    at N=49152 fp32 (3/8 of the JAX package's record size, N=131072, which
    took a third of this script's time), panel 4096, nb=512, the
    device path, a ``DirectPanelStore`` (an O_DIRECT file under
    ``$TMPDIR``) with its RAM cache, the streaming Freivalds gate (2 probes)
    under N·2e-7; the host's memory, disk and cores first, and N cut to
    36864 where they cannot hold the file and its cache (below that the phase
    fails); the wall time, GFLOP/s, every ``stats`` field, the peak device
    memory and the Freivalds value; then fp64 at N=16384 on a flat RAM store
    under 1e-10, and a kill-and-resume at N=16384 (a crash after panel 2, a
    resume in a fresh store) that must give an uninterrupted run's bits;
36. the block-cyclic plane on member meshes on the card (no hand kernel: its
    products are cuBLAS, its factor and solves cuSOLVER): the session,
    ``python -m dla_tpu_torch.cli.session --N 32768 --B 512 --p 2 --q 4
    --dtype d --solve 64`` (64 tile steps, the unrolled program, fp64, PASS
    under 1e-10); ``potrf_block_cyclic`` at N=32768, nb=256 on 2×4 (128 steps,
    the super-stepped program) against the unrolled program on the same
    input within rtol = atol = 1e-11, and its residual under 1e-10; the
    driver's ``--mode distributed`` at N=16384, nb=512 on 2×2 (fp32); and the
    out-of-core driver with ``--p 2 --q 2`` at N=24576 fp32 on a flat RAM
    store (its host Freivalds gate, not the factorization, sets its time).
    Each with its time, GFLOP/s at (1/3)·N³/t, gate value and peak
    device memory.
37. the driver's full flag surface, each run's median time, GFLOP/s, gate
    value, #1 launches and peak device memory on one line: ``--dtype z
    --mode blocked`` at N=16384, nb=1024 (gate 1e-10), again with
    ``DLA_TPU_C3M=1`` (the 3M complex product, its time beside the first);
    ``--dtype c --uplo U --mode shrink``; ``--dtype z --uplo U --mode blocked
    --solve potrs`` at N=4096 (under 1e-10: the solve reads A through its
    upper triangle and L = Uᴴ); ``--dtype c --mode packed --nb
    4096`` with ``--solve potrs`` and ``--solve inverse`` (complex runs take
    cuBLAS and cuSOLVER: the hand kernels are real-only); then fp32 runs that
    launch kernel #1: a principal view (``--lm 65536 --ioff 16384 --joff
    16384 --m 16384``, its peak memory well below the 16 GiB of the 65536²
    square, which is never built), ``--gen gershgorin``, ``--uplo B --mode
    shrink --trailing pallas``, ``--input`` of a ``.npy`` (N taken from the
    file) and its ``--solve refined`` (tril(A) widened to fp64), ``--checked``
    (PASS) and ``--checked --bump 0.0001`` at N=4096 (exit code 3, ``CHECK
    FAILED``); the session at ``--dtype z``, N=4096 on 2×2 (PASS, as the JAX
    package's session); the LAPACK oracle ``--n 4096 --cross-check``; a
    sweep of the harness, two configurations (N=16384 fp32 ``inplace``, and
    ``packed --trailing pallas --precision default`` at nb=4096) × 3 repeats
    into a temporary CSV, every row exit code 0 with a passing ``rel_error``;
    ``time_fn`` and ``Roofline`` over ``potrf_inplace`` at N=16384 (the peak
    fraction below 100%) and ``trace()``, a non-empty Chrome trace; and the
    phase's wall time;
38. the five distributed planes across a process boundary:
    ``python -m dla_tpu_torch.parallel.multihost`` as 2 processes × 4
    members that share this card over ``torch.distributed`` with gloo
    (NCCL refuses two processes on one card), fp64: the block plane at
    N=32768, nb=512 on 2×4, then ``potrs`` (2×4) and the three ring planes
    (D=8) at N=16384, nb=512. Per plane: each process's factorization time
    and rate, its boundary broadcasts (count, bytes and seconds, the device
    synchronized around each), its #11 launches (2·nt − 1 in each process on
    each ring plane) and peak device memory; process 0's gate under 1e-10;
    the same plane in one process on 8 members, its time and the largest
    difference between the two results. A process that fails or outlives
    its timeout fails the phase.
39. the finance model (``dla_tpu_torch/models/``, no hand kernel: the JAX
    package's LSTM and head are XLA ops, the port's torch ops) at the JAX
    package's CLI defaults: ``python -m dla_tpu_torch.models.cli`` as
    processes, ``gen-data`` (all four universes, 19 tickers, 1260 days),
    ``audit``, ``features`` (24 features a ticker, 456 inputs, window 30,
    horizon 5), ``train`` (hidden 64 32, batch 64, 10 epochs, ≈ 146k
    parameters) on the card, ``eval``, ``predict --cumret``; each one's wall
    time, exit code 0, finite losses, the checkpoint, one row per test window
    in both files. Then card against CPU: from one numpy-made weight tree
    (``params_from_flax``), 20 Adam steps on the same batches (noise and
    dropout off), every parameter within 1e-4·max|p| and the predictions
    within 1e-5, with the card's ms a step and its ``predict`` rows a
    second; a reloaded checkpoint predicts the same bits on the card, and
    every parameter and Adam moment lies there.
40. the projection model (``dla_tpu_torch/parallel/model.py``, no kernel of its
    own): each single-card rate this run measured (the main path, phase 27's
    bench tiers, phase 15's ``highest`` path, phase 11's f64x path; run
    alone, the main path measured here) beside ``single_chip_rate(n, "h100",
    tier)``, each ratio within [1/3, 3] (a wrong unit, tier or base chip, not
    noise: whole calls have read 2× apart by host); ``CHIPS["h100"].hbm_gib``
    beside the card's total memory; the headline rows of
    ``python -m dla_tpu_torch.bench.projections`` (projections, not
    measurements); the phase's wall time.

``--phases`` only selects: the ``kernels`` line then lists the kernels whose
comparison phase and path phase both ran, and the last line is printed when
every selected phase passed.

Then the ``kernels`` JSON line (each kernel's launches on its path, its
error and times against the plain version, the bound, and the library call
where one PyTorch call computes the same function; for the four trailing
kernels and #6 to #8 also the block ``body`` their path's case ran; for #6
to #8 also ``big``, the kernel, library and bound ms at m=4096, n=k=2048 (#7:
n=k=2048, with ``addmm_square_ms``, addmm on the full square, a yardstick),
the total wall time, the card as ``nvidia-smi`` reports it, and last
``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside the repository, the script fails before
printing any of those.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

DEVICE = "cuda"
N_MAIN, NB_MAIN = 16384, 1024  # the main path: N=16384, nb=tb=kb=1024, ib=512
MAIN_KW = dict(nb=NB_MAIN, tb=NB_MAIN, kb=NB_MAIN, ib=NB_MAIN // 2, diag_factor="twolevel",
               precision="high")
N_CHECK = 4096  # kernel path against plain path
# the packed path: the reference's default:packed tier (bench.py:136-140, :431-534)
N_PACKED, W_PACKED, KTB_PACKED = 81920, 4096, 1024
PACKED_KW = dict(diag_factor="twolevel", ib=512, precision="default", trailing="pallas",
                 ktb=KTB_PACKED, kb=W_PACKED)
N_PACKED64 = 32768  # fp64 kernel case: 81920 plus a clone would not fit beside the plain one
N_PACKED_BF16 = 16384
# the f64x path: the reference's emulated-fp64 tier (bench.py:536-611)
N_DF64, NB_DF64, TB_DF64, S_DF64 = 24576, 1024, 512, 7
DF64_KW = dict(nb=NB_DF64, s=S_DF64, trailing="pallas", tb=TB_DF64)
N_DF64_CHECK = 4096
# the reference's highest tier (bench.py:64-82, :242-275)
N_HIGHEST = 32768
HIGHEST_KW = dict(nb=8192, panel="blocktrsm", trailing="pallas", tb=1024, kb=256,
                  trailing_alias=False, diag_factor="lax", precision="highest", ib=512)
NB_PANEL_FACTOR = 512  # the panel_factor path: the kernel's largest nb
PANEL_APPLY_KW = dict(MAIN_KW, panel="pallas", panel_ib=256)
# phase 17's path median with #3 as it was before its redesign (64-row strips of
# scalar FMAs, commit 9e5533b), printed beside this run's for comparison
PANEL_APPLY_PATH_BEFORE = "59.6 and 59.9 ms in two runs (NVIDIA H100 80GB HBM3, 700.00 W)"
# the median of phase 15 and phase 11's native fp64 time with #1/#2's fp32
# highest and fp64 body on scalar 64 x 64 nt_block blocks (commit 49d9d4e)
HIGHEST_PATH_BEFORE = "509.3 ms (NVIDIA H100 80GB HBM3, 700.00 W)"
NATIVE_FP64_BEFORE = "394.4 ms, residual 1.205e-15 (NVIDIA H100 80GB HBM3, 700.00 W)"
# phase 16's highest median with #4's products on scalar 64 x 64 nt_block blocks and #1 on
# its simt body (commit 640101e)
PANEL_FACTOR_PATH_BEFORE = "417.7 ms (NVIDIA H100 80GB HBM3, 700.00 W)"
N_MODES = 4096  # every potrf mode, card against CPU
# the packed df64 path: the driver's configuration (potrf_driver.py: ktb = min(512, NB))
N_PDF64, NB_PDF64, KTB_PDF64 = 40960, 1024, 512
PDF64_KW = dict(ktb=KTB_PDF64, s=S_DF64)
N_PDF64_CHECK, N_PDF64_SPLIT = 4096, 8192
# phase 23's driver run: at N_PDF64 it took 78.7 s of the smoke (its factor and the blocked gate
# at full size, which phase 21 already measures); its mode and gate are the same at this size
N_PDF64_DRIVER = 16384
# the tile-task path: the reference's task DAG at the main path's matrix, one launch per task
N_TASK, NB_TASK, TASK_PREC = 16384, 512, "high"
N_TASK64, NB_TASK64 = 4096, 256  # the same path in fp64, under the reference's 1e-10 gate
N_TASK_BIG, M_TASK_BIG = 2048, 4096  # #6-#8 at a size clear of the launch floor
# the two bench tiers nothing else here drives (bench.py:136-140), and the driver at the first
BENCH_TIERS = "high:inplace:1024:1024:61440,bf16:packed:4096:4096:106496"
BENCH_ENV = {"BENCH_ITERS": "2"}
N_HEADLINE, NB_HEADLINE = 61440, 1024
# the dense solve and serving path on the main path's factor, and fp64 refinement
NRHS_SOLVE, N_REFINED64 = 64, 8192
N_PACKED_SOLVE, NB_PACKED_SOLVE = 32768, 4096  # phase 34: the packed serving path
# phase 35: out of core at 3/8 of the JAX package's record size (README.md:86: N=131072, a third
# of this script's time), cut to N_OOC_CUT where the host cannot hold the panel file and its cache;
# fp64 and the kill-and-resume at N_OOC64
N_OOC, N_OOC_CUT, W_OOC, NB_OOC, N_OOC64 = 49152, 36864, 4096, 512, 16384
# phase 36: the block-cyclic plane (the JAX package's only distributed workload is fp64 tiles,
# README.md:130-132): the session at N_BC on a P_BC x Q_BC member mesh, the super-stepped program at
# NB_BC_SUPER, the driver's --mode distributed and the out-of-core driver on a 2x2 mesh
N_BC, NB_BC, P_BC, Q_BC, NRHS_BC, NB_BC_SUPER = 32768, 512, 2, 4, 64, 256
N_BC_DRIVER, NB_BC_DRIVER, N_BC_OOC = 16384, 512, 24576
# phase 37: the driver's full flag surface (complex, views, generators, --input, --checked),
# the c/z session, the oracle, the sweep harness and the profiling helpers
N_FLAGS, NB_FLAGS, NB_FLAGS_PACKED, LM_VIEW, N_CHECK_FAIL = 16384, 1024, 4096, 65536, 4096
N_SESSION_Z, NB_SESSION_Z = 4096, 256
# phase 38: the five planes of dla_tpu/parallel/multihost.py across 2 processes x 4 members on
# this card: the block plane at the session's size, potrs and the ring planes at N_MH (D=8)
N_MH_BLOCK, N_MH, NB_MH, MH_PROCS, MH_MEMBERS, MH_TIMEOUT = 32768, 16384, 512, 2, 4, 300
# phase 39: the finance model at the JAX package's CLI defaults (dla_tpu/models/cli.py:30-52): all
# four universes, MODEL_DAYS days, window, horizon, hidden, batch and epochs; then MODEL_STEPS Adam
# steps on the card against the CPU from one weight tree
MODEL_DAYS, MODEL_WINDOW, MODEL_HORIZON, MODEL_HIDDEN = 1260, 30, 5, (64, 32)
MODEL_BATCH, MODEL_EPOCHS, MODEL_STEPS, MODEL_TIMEOUT = 64, 10, 20, 300
# phase 40: a measured rate may lie this factor either side of the model's single-card curve
RATE_BAND = 3.0
# the flat-mesh ring planes (__graft_entry__.py:110-200): D members on the card
N_RING, NB_RING, D_RING, RING_REPS = 16384, 1024, 4, 2
M_RING_TILE = 1024  # the factor tile; the largest panel is N_RING - NB_RING rows

# The card's peaks (NVIDIA's H100 SXM data sheet, dense, at 700 W): bf16
# tensor cores, fp32 outside them, fp64 tensor cores; HBM3 bytes per second.
PEAK = {"bf16": 989e12, "fp32": 67e12, "fp64": 67e12}
HBM_RATE = 3.35e12


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` on the card over ``iters`` calls, after one warm-up."""
    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` on the card over ``iters`` calls queued behind a
    sleeping kernel, after one warm-up: the host's time between calls is
    hidden wherever it enqueues faster than the sleep lasts (a ring launch
    takes about as long on the card as its own enqueue)."""
    fn()
    sync()
    torch.cuda._sleep(50_000_000)  # ≈ 25 ms at the H100's clock
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def product_s(flops: float, dtype, prec: str) -> float:
    """Least seconds for a matrix product of ``flops`` at the tier: fp64 on
    the fp64 peak; bf16 operands, and fp32 at ``default``, one bf16 pass;
    fp32 ``high`` three (bf16x3); fp32 ``highest`` on the non-tensor fp32
    peak."""
    if dtype == torch.float64:
        return flops / PEAK["fp64"]
    if dtype == torch.bfloat16 or prec == "default":
        return flops / PEAK["bf16"]
    if prec == "high":
        return 3 * flops / PEAK["bf16"]
    return flops / PEAK["fp32"]


def bound(ops_s: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations'
    time at peak and the bytes (each input read once, each output written
    once) over the memory rate, and which of the two binds."""
    bytes_s = nbytes / HBM_RATE
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def pair_bound(pairs: int, tb: int, nb: int, item: int, p_bytes: float, dtype, prec) -> dict:
    """Bound of a trailing update over ``pairs`` tb×tb tile pairs: each
    visited C tile read and written once, P read once."""
    return bound(product_s(2 * pairs * tb * tb * nb, dtype, prec), 2 * pairs * tb * tb * item
                 + p_bytes)


def kernel_body(fn) -> str:
    """Which block body of the trailing kernels ``fn`` launched: ``"wgmma"``,
    ``"simt"`` or ``"dmma"``, from the library's count of launches through
    each body (``tiles.body_launches``) before and after one call."""
    from dla_tpu_torch.kernels import tiles

    before = tiles.body_launches()
    fn()
    sync()
    rose = [b for b, n in tiles.body_launches().items() if n != before[b]]
    require(len(rose) == 1, f"expected one launch through one trailing body, got {rose}")
    return rose[0]


def trailing_report(kind, name, row, tol, pairs, tb, nb, tag, same=None):
    """Print a trailing kernel case: error, times, rate (2·pairs·tb²·nb
    operations), the share of the bound, the body and, for the chain bodies,
    whether the bits are the task kernels' scalar body's."""
    tfs = 2 * pairs * tb * tb * nb / (row["ms"] * 1e-3) / 1e12
    chain = "" if same is None else f", bits of the task kernels' scalar body: {same}"
    print(f"{kind} {name}: body {row['body']}, max_abs_err={row['max_abs_err']:.3e} (tol "
          f"{tol:.3e}) kernel {row['ms']:.3f} ms = {tfs:.2f} TF/s, plain {row['plain_ms']:.3f} "
          f"ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}), {row['bound_ms'] / row['ms']:.1%}"
          f" of the bound{chain} {tag}", flush=True)


def chain_bits(out, c, p, columns, dtype, prec) -> bool | None:
    """Whether ``out`` holds, in every tile column of the window, the bits of
    the task kernels' scalar body (``tile_kernel`` on ``nt_block``: one fma
    chain per element in ascending k, as the ``simt`` and ``dmma`` bodies
    sum; the test-only entry ``tiles.tile_op_reference``) on the same tiles
    of ``c`` and ``p``; None where the tier runs ``wgmma`` or the tensors lie
    on the CPU (whose plain versions sum otherwise). ``columns`` gives each
    tile column as (the block of ``c``, its first row of ``p``, tb)."""
    from dla_tpu_torch.kernels import tiles

    if tiles.trailing_body(dtype, prec) == "wgmma" or out.device.type != "cuda":
        return None
    for blk, r0, tb in columns:
        ref = tiles.tile_op_reference("gemm", c[blk], p[r0:], p[r0:r0 + tb])
        if not torch.equal(bits(out[blk]), bits(ref)):
            return False
    return True


def tolerance(dtype, c: torch.Tensor, p: torch.Tensor) -> float:
    """fp64 1e-12·scale; fp32 1e-5·scale (the same partial products summed in
    another order); bf16 2^-6·(max|c| + scale) (two bf16 roundings, each
    possibly one ulp apart); scale = max_i ||p_i||² = max |P·Pᵀ|."""
    scale = (p.double() ** 2).sum(1).max().item()
    if dtype == torch.float64:
        return 1e-12 * scale
    if dtype == torch.float32:
        return 1e-5 * scale
    return 2**-6 * (c.abs().max().item() + scale)


# ---- 2. the dense kernel against its plain version ----------------------------
def lower_case(dev, tag, m, tb, nb, origin, dtype, prec, iters):
    from dla_tpu_torch.kernels import tiles
    from dla_tpu_torch.kernels.tiles import trailing_update_lower_plain
    from dla_tpu_torch.utils import precision

    g = torch.Generator(device=dev).manual_seed(m + 7 * nb + origin)
    c = torch.randn(m, m, generator=g, device=dev, dtype=torch.float32).to(dtype)
    p = torch.randn(m - origin * tb, nb, generator=g, device=dev, dtype=torch.float32).to(dtype)
    kw = dict(tb=tb, kb=nb, origin=origin)
    with precision.override(prec):
        ref = trailing_update_lower_plain(c.clone(), p, **kw)
        out = c.clone()
        before = tiles.launches
        res = tiles.trailing_update_lower(out, p, **kw)
        sync()
        require(res is out and tiles.launches == before + 1,
                "kernel did not update c in place with one launch")
        require(not torch.equal(out, c), "alias=True left c unchanged")
        ti = torch.arange(m, device=dev) // tb
        lower = (ti[:, None] >= ti[None, :]) & (ti[:, None] >= origin) & (ti[None, :] >= origin)
        require(torch.equal(bits(torch.where(lower, 0, out)), bits(torch.where(lower, 0, c))),
                "elements outside the lower window tiles changed")
        err = torch.where(lower, (out.double() - ref.double()).abs(), 0).max().item()
        tol = tolerance(dtype, c, p)
        o = origin * tb
        same = chain_bits(out, c, p, [((slice(o + j0, None), slice(o + j0, o + j0 + tb)), j0, tb)
                                      for j0 in range(0, m - o, tb)], dtype, prec)
        k_ms = cuda_ms(lambda: tiles.trailing_update_lower(out, p, **kw), iters)
        p_ms = cuda_ms(lambda: trailing_update_lower_plain(ref, p, **kw), iters)
        body = kernel_body(lambda: tiles.trailing_update_lower(out, p, **kw))
        want = tiles.trailing_body(dtype, prec)
    nt = m // tb - origin
    pairs = nt * (nt + 1) // 2
    row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None, body=body,
               **pair_bound(pairs, tb, nb, c.element_size(), p.numel() * p.element_size(),
                            dtype, prec))
    name = f"m={m} tb={tb} nb={nb} origin={origin} {str(dtype)[6:]}/{prec}"
    trailing_report("trailing_update_lower", name, row, tol, pairs, tb, nb, tag, same)
    require(err <= tol, f"kernel disagrees with the plain version at {name}")
    require(body == want, f"the {body} body ran at {name}, not the {want} one")
    require(same is not False, f"the {body} body lost the scalar body's bits at {name}")
    return row


def phase_lower_kernel(dev, tag):
    main_case = None
    half = N_MAIN // NB_MAIN // 2  # origin 8: a full buffer with half its rows in the panel
    for origin in (0, half):
        for prec in ("high", "highest", "default"):
            r = lower_case(dev, tag, N_MAIN, NB_MAIN, NB_MAIN, origin, torch.float32, prec, 5)
            if origin == 0 and prec == "high":
                main_case = r
    lower_case(dev, tag, N_MAIN, NB_MAIN, NB_MAIN, 0, torch.float64, "high", 3)
    lower_case(dev, tag, N_MAIN, NB_MAIN, NB_MAIN, 0, torch.bfloat16, "high", 5)
    lower_case(dev, tag, 96, 32, 32, 0, torch.float32, "high", 5)
    lower_case(dev, tag, 96, 32, 32, 1, torch.float32, "high", 5)
    return main_case


# ---- 3. the main path ---------------------------------------------------------
def phase_main_path(dev, tag):
    import dla_tpu_torch as T
    import dla_tpu_torch.algos as TA
    from dla_tpu_torch.kernels import tiles

    per_fact = N_MAIN // NB_MAIN - 1
    times = []
    tiles.launches = 0
    for rep in range(4):  # repeat 0 is the warm-up
        a = T.plgsy(N_MAIN, seed=51, device=dev)
        sync()
        before = tiles.launches
        t0 = time.perf_counter()
        l = TA.potrf_inplace(a, **MAIN_KW)
        sync()
        dt = time.perf_counter() - t0
        require(tiles.launches - before == per_fact,
                f"{tiles.launches - before} kernel launches in one factorization, "
                f"expected {per_fact}")
        rate = N_MAIN**3 / 3 / dt / 1e9
        print(f"main path N={N_MAIN} fp32 high: repeat {rep} {dt * 1e3:.1f} ms "
              f"{rate:.2f} GFLOP/s{' (warm-up)' if rep == 0 else ''} {tag}", flush=True)
        if rep:
            times.append(dt)
    main_launches = tiles.launches
    require(main_launches == 4 * per_fact, "main path launch count")
    tmed = statistics.median(times)
    print(f"main path N={N_MAIN} fp32 high: median {tmed * 1e3:.1f} ms, "
          f"{N_MAIN**3 / 3 / tmed / 1e9:.2f} GFLOP/s, {main_launches} kernel launches {tag}",
          flush=True)
    ltri = torch.tril(l)
    require(ltri.shape == (N_MAIN, N_MAIN) and bool(torch.isfinite(ltri).all()),
            "the factor has non-finite entries")
    del a, l
    res = float(T.residual_potrf(T.plgsy(N_MAIN, seed=51, device=dev), ltri,
                                 assume_symmetric=True, assume_tril=True, row_chunk=N_MAIN // 4))
    gate = N_MAIN * 2e-7  # the driver's fp32 gate
    print(f"main path residual ||A - LL^T||_inf / ||A||_inf = {res:.3e} (gate {gate:g})",
          flush=True)
    require(res < gate, "main path residual above the fp32 gate")
    return main_launches, tmed


# ---- 4. kernel path against plain path -----------------------------------------
def phase_inplace_check(dev):
    import dla_tpu_torch as T
    import dla_tpu_torch.algos as TA

    n4 = N_CHECK
    kw4 = dict(nb=n4 // 4, tb=n4 // 16, kb=n4 // 4, ib=n4 // 8, diag_factor="twolevel",
               precision="high")
    a_cpu = T.plgsy(n4, seed=7, device="cpu")
    l_gpu = TA.potrf_inplace(a_cpu.to(dev, copy=True), **kw4)
    l_cpu = TA.potrf_inplace(a_cpu.clone(), **kw4)
    lg, lc = torch.tril(l_gpu).cpu(), torch.tril(l_cpu)
    dl = (lg - lc).abs().max().item()
    r_gpu = float(T.residual_potrf(a_cpu, lg))
    r_cpu = float(T.residual_potrf(a_cpu, lc))
    print(f"N={n4} fp32 high, kernel on the card vs plain on the CPU: max|dL|={dl:.3e} "
          f"(max|L|={lc.abs().max().item():.3e}), residuals {r_gpu:.3e} vs {r_cpu:.3e}",
          flush=True)
    require(dl <= 1e-5 * lc.abs().max().item(), "kernel-path L disagrees with the plain path")
    require(0.5 <= r_gpu / r_cpu <= 2.0, "kernel-path residual not within 2x of the plain path")
    a64 = T.plgsy(n4, seed=7, dtype=torch.float64, device=dev)
    l64 = TA.potrf_inplace(a64.clone(), **kw4)
    r64 = float(T.residual_potrf(a64, l64))
    print(f"N={n4} fp64 kernel path residual {r64:.3e} (gate 1e-10)", flush=True)
    require(r64 < 1e-10, "fp64 residual above the reference's 1e-10 gate")


# ---- 5. and 9. the driver -------------------------------------------------------
def driver_run(tag, argv, env=None) -> tuple[int, str]:
    """Run the driver in this process with ``env`` added to the environment;
    print its lines; its exit code and output."""
    from dla_tpu_torch.cli import potrf_driver

    buf = io.StringIO()
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        with contextlib.redirect_stdout(buf):
            rc = potrf_driver.main([str(a) for a in argv])
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    for line in buf.getvalue().splitlines():
        print(f"driver| {line}")
    print(f"driver numbers above: {tag}", flush=True)
    return rc, buf.getvalue()


def phase_driver(tag, argv, env=None):
    """Run the driver in this process with ``env`` added to the environment;
    it must pass."""
    rc, out = driver_run(tag, argv, env)
    require(rc == 0 and "PASS" in out, f"driver returned {rc} without PASS")
    return out


# ---- 6. the packed kernel against its plain version -----------------------------
def slab_visit(dev, n, w, tb, base, j):
    """Slab j's rows of a packed buffer (slab width w) and the mask of its
    elements that the update of the trailing window from ``base`` visits: the
    lower tb-tile pairs in window coordinates."""
    from dla_tpu_torch.algos.packed import _row_offset

    nt = n // w
    rows = slice(_row_offset(j, nt, w), _row_offset(j, nt, w) + (nt - j) * w)
    r = torch.arange(j * w, n, device=dev) - base  # window coordinates
    cc = torch.arange(j * w, (j + 1) * w, device=dev) - base
    visit = ((r[:, None] >= 0) & (cc[None, :] >= 0)
             & (r.clamp(min=0)[:, None] // tb >= cc.clamp(min=0)[None, :] // tb))
    return rows, visit


def packed_case(dev, tag, n, w, ktb, k, dtype, prec, iters):
    from dla_tpu_torch.algos.packed import _row_offset, packed_rows
    from dla_tpu_torch.kernels import tiles
    from dla_tpu_torch.kernels.tiles import trailing_update_packed_plain
    from dla_tpu_torch.utils import precision

    nt, base = n // w, (k + 1) * w
    g = torch.Generator(device=dev).manual_seed(n + 7 * k + w)
    c = torch.randn(packed_rows(n, w), w, generator=g, device=dev, dtype=torch.float32).to(dtype)
    p = torch.randn(n - base, w, generator=g, device=dev, dtype=torch.float32).to(dtype)
    kw = dict(n=n, w=w, k=k, tb=ktb, kb=w)
    with precision.override(prec):
        ref = trailing_update_packed_plain(c.clone(), p, **kw)
        out = c.clone()
        before = tiles.packed_launches
        res = tiles.trailing_update_packed(out, p, **kw)
        sync()
        require(res is out and tiles.packed_launches == before + 1,
                "packed kernel did not update the buffer in place with one launch")
        err, changed = 0.0, False
        for j in range(nt):  # slab by slab: the visited mask of one slab at a time
            rows, visit = slab_visit(dev, n, w, ktb, base, j)
            o, c0 = out[rows], c[rows]
            require(torch.equal(bits(torch.where(visit, 0, o)), bits(torch.where(visit, 0, c0))),
                    f"elements outside the visited tiles of slab {j} changed")
            changed = changed or not torch.equal(o, c0)
            d = torch.where(visit, (o.double() - ref[rows].double()).abs(), 0)
            err = max(err, d.max().item())
            del visit, o, c0, d
        require(changed, "the packed kernel changed nothing")
        tol = tolerance(dtype, c, p)
        columns = []
        for c0 in range(0, n - base, ktb):  # each tile column lies in one slab
            j, cs = divmod(base + c0, w)
            r0 = _row_offset(j, nt, w) + cs
            columns.append(((slice(r0, r0 + n - base - c0), slice(cs, cs + ktb)), c0, ktb))
        same = chain_bits(out, c, p, columns, dtype, prec)
        del c
        k_ms = cuda_ms(lambda: tiles.trailing_update_packed(out, p, **kw), iters)
        p_ms = cuda_ms(lambda: trailing_update_packed_plain(ref, p, **kw), iters)
        body = kernel_body(lambda: tiles.trailing_update_packed(out, p, **kw))
        want = tiles.trailing_body(dtype, prec)
    mt = (n - base) // ktb
    pairs = mt * (mt + 1) // 2
    row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None, body=body,
               **pair_bound(pairs, ktb, w, out.element_size(), p.numel() * p.element_size(),
                            dtype, prec))
    name = f"n={n} w={w} ktb={ktb} k={k} {str(dtype)[6:]}/{prec}"
    trailing_report("trailing_update_packed", name, row, tol, pairs, ktb, w, tag, same)
    require(err <= tol, f"packed kernel disagrees with the plain version at {name}")
    require(body == want, f"the {body} body ran at {name}, not the {want} one")
    require(same is not False, f"the {body} body lost the scalar body's bits at {name}")
    del out, ref, p
    torch.cuda.empty_cache()
    return row


def phase_packed_kernel(dev, tag):
    path_case = None
    nt = N_PACKED // W_PACKED
    for k in (0, nt // 2):
        for prec in ("default", "high", "highest"):
            r = packed_case(dev, tag, N_PACKED, W_PACKED, KTB_PACKED, k, torch.float32, prec,
                            iters=2)
            if k == 0 and prec == PACKED_KW["precision"]:
                path_case = r
    packed_case(dev, tag, N_PACKED, W_PACKED, KTB_PACKED, 0, torch.bfloat16, "high", iters=2)
    packed_case(dev, tag, N_PACKED64, W_PACKED, KTB_PACKED, 0, torch.float64, "high", iters=2)
    for k in (0, 1):  # w not a multiple of the 64-wide block: blocks straddle slabs
        packed_case(dev, tag, 384, 96, 32, k, torch.float32, "high", iters=5)
    return path_case


# ---- 7. the packed path -------------------------------------------------------
def phase_packed_path(dev, tag):
    import dla_tpu_torch as T
    import dla_tpu_torch.algos as TA
    from dla_tpu_torch.kernels import tiles

    n, w = N_PACKED, W_PACKED
    per_fact = n // w - 1
    times = []
    tiles.packed_launches = 0
    for rep in range(3):  # repeat 0 is the warm-up
        a = TA.plgsy_packed(n, w, seed=51, device=dev)
        sync()
        before = tiles.packed_launches
        t0 = time.perf_counter()
        l = T.potrf_packed(a, n, w, **PACKED_KW)
        sync()
        dt = time.perf_counter() - t0
        require(l is a, "potrf_packed did not factor its buffer in place")
        require(tiles.packed_launches - before == per_fact,
                f"{tiles.packed_launches - before} packed kernel launches in one "
                f"factorization, expected {per_fact}")
        print(f"packed path N={n} w={w} fp32 default: repeat {rep} {dt * 1e3:.1f} ms "
              f"{n**3 / 3 / dt / 1e9:.2f} GFLOP/s{' (warm-up)' if rep == 0 else ''} {tag}",
              flush=True)
        if rep:
            times.append(dt)
        del a
    launches = tiles.packed_launches
    require(launches == 3 * per_fact, "packed path launch count")
    tmed = statistics.median(times)
    print(f"packed path N={n} fp32 default: median {tmed * 1e3:.1f} ms, "
          f"{n**3 / 3 / tmed / 1e9:.2f} GFLOP/s, {launches} packed kernel launches "
          f"({per_fact} per factorization), {l.numel() * l.element_size() / 1e9:.2f} GB "
          f"packed buffer {tag}", flush=True)
    require(l.shape == (n * (n + w) // (2 * w), w) and bool(torch.isfinite(l).all()),
            "the packed factor has non-finite entries")
    res = float(TA.freivalds_packed(l, n, w, seed=51))
    gate = n * 2e-7  # the driver's fp32 gate
    print(f"packed path freivalds ||(A - LL^T)x|| / (||A|| ||x||) = {res:.3e} (gate {gate:g})",
          flush=True)
    require(res < gate, "packed path Freivalds value above the fp32 gate")
    del l
    torch.cuda.empty_cache()
    return launches


# ---- 8. packed kernel path against plain path -------------------------------------
def phase_packed_check(dev):
    import dla_tpu_torch as T
    import dla_tpu_torch.algos as TA
    from dla_tpu_torch.kernels import tiles

    def factor(a, n, w, **kw):  # on the card, through the kernel
        before = tiles.packed_launches
        l = T.potrf_packed(a, n, w, **kw)
        sync()
        require(tiles.packed_launches - before == n // w - 1,
                "packed kernel launch count on the check path")
        return l

    n4, w4 = N_CHECK, N_CHECK // 4
    kw4 = dict(diag_factor="twolevel", ib=512, precision="high", trailing="pallas",
               ktb=w4 // 4, kb=w4)
    a_cpu = TA.plgsy_packed(n4, w4, seed=7, device="cpu")
    lg = T.unpack_tri(factor(a_cpu.to(dev, copy=True), n4, w4, **kw4).cpu(), n4, w4)
    lc = T.unpack_tri(T.potrf_packed(a_cpu.clone(), n4, w4, **kw4), n4, w4)
    dl = (lg - lc).abs().max().item()
    print(f"packed N={n4} w={w4} fp32 high, kernel on the card vs plain on the CPU: "
          f"max|dL|={dl:.3e} (max|L|={lc.abs().max().item():.3e})", flush=True)
    require(dl <= 1e-5 * lc.abs().max().item(), "packed kernel-path L disagrees with plain")
    a64 = TA.plgsy_packed(n4, w4, seed=7, dtype=torch.float64, device=dev)
    r64 = float(TA.freivalds_packed(factor(a64, n4, w4, **kw4), n4, w4, seed=7))
    print(f"packed N={n4} fp64 kernel path freivalds {r64:.3e} (gate 1e-10)", flush=True)
    require(r64 < 1e-10, "packed fp64 Freivalds value above the reference's 1e-10 gate")
    nb16 = N_PACKED_BF16
    ab = TA.plgsy_packed(nb16, W_PACKED, seed=51, dtype=torch.bfloat16, device=dev)
    rb = float(TA.freivalds_packed(factor(ab, nb16, W_PACKED, **PACKED_KW), nb16, W_PACKED,
                                  seed=51))
    gate = nb16**0.5 * 2e-4
    print(f"packed N={nb16} bf16 storage kernel path freivalds {rb:.3e} (gate {gate:g})",
          flush=True)
    require(rb < gate, "packed bf16 Freivalds value above the bf16 gate")


# ---- 10. the df64 kernel against its plain version -------------------------------
# the one block body of #9 and #10 (csrc/trailing_df64.cuh): s(s+1)/2 wgmma chunk
# products, folded in registers; csrc/ holds no other df64 body
DF64_BODY = "wgmma"


def df64_case(dev, tag, m, nb, tb, s, w, origin, iters):
    from dla_tpu_torch.kernels import df64_tiles
    from dla_tpu_torch.kernels.df64_tiles import trailing_update_df64_plain
    from dla_tpu_torch.ops.df64 import slice_rows, to_df64

    g = torch.Generator(device=dev).manual_seed(m + 7 * nb + origin)
    ch, cl = to_df64(torch.randn(m, m, generator=g, device=dev, dtype=torch.float64))
    p = torch.randn(m - origin * tb, nb, generator=g, device=dev, dtype=torch.float64)
    sx = slice_rows(*to_df64(p), s=s, w=w)[0]
    del p
    kw = dict(origin=origin, tb=tb, w=w)
    ref = trailing_update_df64_plain(ch.clone(), cl.clone(), sx, **kw)
    out = (ch.clone(), cl.clone())
    before = df64_tiles.launches
    res = df64_tiles.trailing_update_df64(*out, sx, **kw)
    sync()
    require(res[0] is out[0] and res[1] is out[1] and df64_tiles.launches == before + 1,
            "df64 kernel did not update the pair in place with one launch")
    require(not torch.equal(out[0], ch), "the df64 kernel changed nothing")
    ti = torch.arange(m, device=dev) // tb
    visit = (ti[:, None] >= ti[None, :]) & (ti[:, None] >= origin) & (ti[None, :] >= origin)
    for o, c in zip(out, (ch, cl)):
        require(torch.equal(bits(torch.where(visit, 0, o)), bits(torch.where(visit, 0, c))),
                "elements outside the visited tiles changed")
    del visit, ch, cl
    same = all(torch.equal(bits(o), bits(r)) for o, r in zip(out, ref))
    err = max((o - r).abs().max().item() for o, r in zip(out, ref))
    k_ms = cuda_ms(lambda: df64_tiles.trailing_update_df64(*out, sx, **kw), iters)
    p_ms = cuda_ms(lambda: trailing_update_df64_plain(*ref, sx, **kw), iters)
    nt = m // tb - origin
    pairs = nt * (nt + 1) // 2
    flops = 2 * pairs * tb * tb * nb * (s * (s + 1) // 2)
    # s(s+1)/2 one-pass bf16 products; both fp32 planes of each visited tile
    # read and written once, the slices read once
    row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None, body=DF64_BODY,
               **bound(flops / PEAK["bf16"], 2 * 2 * pairs * tb * tb * 4
                       + sum(x.numel() * x.element_size() for x in sx)))
    name = f"m={m} tb={tb} nb={nb} s={s} w={w} origin={origin}"
    print(f"trailing_update_df64 {name}: body {DF64_BODY}, bits equal {same} (max_abs_err="
          f"{err:.3e}) kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, kernel "
          f"{flops / k_ms / 1e9:.2f} TF/s one-pass, bound {row['bound_ms']:.3f} ms "
          f"({row['bound_by']}), {row['bound_ms'] / k_ms:.1%} of the bound {tag}", flush=True)
    require(same, f"df64 kernel and plain version differ in their bits at {name}")
    del out, ref, sx
    torch.cuda.empty_cache()
    return row


def phase_df64_kernel(dev, tag):
    m, nb, tb, s = N_DF64, NB_DF64, TB_DF64, S_DF64
    path_case = df64_case(dev, tag, m, nb, tb, s, 8, 0, iters=2)
    df64_case(dev, tag, m, nb, tb, s, 8, m // tb // 2, iters=3)  # origin 24: the half-way step
    df64_case(dev, tag, 1024, 512, 128, 6, 9, 1, iters=5)  # nk = 2 chunks of kb = 256
    df64_case(dev, tag, 384, 128, 96, s, 8, 0, iters=5)  # tb not a multiple of 64
    return path_case


# ---- 11. the f64x path ------------------------------------------------------------
def phase_df64_path(dev, tag):
    import dla_tpu_torch as T
    import dla_tpu_torch.algos as TA
    from dla_tpu_torch.algos import potrf_df64, residual_potrf_df64_blocked
    from dla_tpu_torch.kernels import df64_tiles, tiles

    n = N_DF64
    per_fact = n // NB_DF64 - 1
    times = []
    df64_tiles.launches = 0
    for rep in range(3):  # repeat 0 is the warm-up
        lh = ll = None  # free the previous factor before the next input exists
        ah = T.plgsy(n, bump=float(n), seed=51, device=dev)
        al = torch.zeros_like(ah)
        sync()
        before = df64_tiles.launches
        t0 = time.perf_counter()
        lh, ll = potrf_df64(ah, al, **DF64_KW)
        sync()
        dt = time.perf_counter() - t0
        require(lh is ah and ll is al, "potrf_df64 did not factor its pair in place")
        require(df64_tiles.launches - before == per_fact,
                f"{df64_tiles.launches - before} df64 kernel launches in one factorization, "
                f"expected {per_fact}")
        print(f"f64x path N={n} df64 s={S_DF64}: repeat {rep} {dt * 1e3:.1f} ms "
              f"{n**3 / 3 / dt / 1e9:.2f} GFLOP/s{' (warm-up)' if rep == 0 else ''} {tag}",
              flush=True)
        if rep:
            times.append(dt)
        del ah, al
    launches = df64_tiles.launches
    require(launches == 3 * per_fact, "f64x path launch count")
    tmed = statistics.median(times)
    print(f"f64x path N={n}: median {tmed * 1e3:.1f} ms, {n**3 / 3 / tmed / 1e9:.2f} GFLOP/s, "
          f"{launches} df64 kernel launches ({per_fact} per factorization) {tag}", flush=True)
    require(lh.shape == (n, n) and bool(torch.isfinite(lh).all() and torch.isfinite(ll).all()),
            "the df64 factor has non-finite entries")
    a = T.plgsy(n, bump=float(n), seed=51, device=dev)
    res = residual_potrf_df64_blocked(a, None, lh, ll, s=S_DF64, rc=2048)
    l64 = lh.double() + ll.double()
    del lh, ll
    res64 = float(T.residual_potrf(a, l64, assume_symmetric=True, assume_tril=True,
                                   row_chunk=min(n, 4096)))
    print(f"f64x path ||A - LL^T||_inf / ||A||_inf = {res:.3e} (df64, blocked; gate 1e-10), "
          f"native fp64 {res64:.3e}", flush=True)
    require(res < 1e-10, "f64x path residual above the reference's 1e-10 gate")
    # The df64 value bounds the fp64 one from above: an |h|+|l| sum, with the
    # dropped slice pairs' and the lo plane's fp32 error on top. At this N
    # that floor, not the factor, sets it (~4e-11 against ~4e-13 in fp64).
    require(res64 <= res, "the native fp64 residual exceeds the df64 gate's value")
    del a, l64
    torch.cuda.empty_cache()
    a64 = T.plgsy(n, bump=float(n), seed=51, dtype=torch.float64, device=dev)
    sync()
    before, bodies = tiles.launches, tiles.body_launches()
    t0 = time.perf_counter()
    l64 = TA.potrf_inplace(a64, nb=NB_DF64, tb=NB_DF64, kb=NB_DF64, ib=512,
                          diag_factor="twolevel")
    sync()
    dt64 = time.perf_counter() - t0
    native = tiles.launches - before
    rose = {b: v - bodies[b] for b, v in tiles.body_launches().items() if v != bodies[b]}
    require(native == per_fact and rose == {"dmma": native},
            f"native fp64 potrf_inplace: {native} #1 launches through {rose}, expected "
            f"{per_fact} through dmma")
    r64 = float(T.residual_potrf(T.plgsy(n, bump=float(n), seed=51, dtype=torch.float64,
                                         device=dev), torch.tril(l64), assume_symmetric=True,
                                 assume_tril=True, row_chunk=min(n, 4096)))
    print(f"N={n} fp64 routes: df64 potrf_df64 {tmed * 1e3:.1f} ms "
          f"({n**3 / 3 / tmed / 1e9:.2f} GFLOP/s), native fp64 potrf_inplace "
          f"{dt64 * 1e3:.1f} ms ({n**3 / 3 / dt64 / 1e9:.2f} GFLOP/s, residual {r64:.3e}, "
          f"{native} #1 launches through dmma; with #1 on nt_block: {NATIVE_FP64_BEFORE}) "
          f"{tag}", flush=True)
    require(r64 <= 1e-14, "native fp64 residual above 1e-14")
    del a64, l64
    torch.cuda.empty_cache()
    return launches, tmed


# ---- 12. df64 kernel path against plain path ---------------------------------------
def phase_df64_check(dev):
    import dla_tpu_torch as T
    from dla_tpu_torch.algos import potrf_df64, residual_potrf_df64_blocked
    from dla_tpu_torch.kernels import df64_tiles
    from dla_tpu_torch.ops import from_df64

    n = N_DF64_CHECK
    a = T.plgsy(n, seed=7, device="cpu")
    before = df64_tiles.launches
    lg = potrf_df64(a.to(dev, copy=True), torch.zeros(n, n, device=dev), **DF64_KW)
    sync()
    require(df64_tiles.launches - before == n // NB_DF64 - 1,
            "df64 kernel launch count on the check path")
    lc = potrf_df64(a.clone(), torch.zeros(n, n), **DF64_KW)
    dl = (from_df64(*lg).cpu() - from_df64(*lc)).abs().max().item()
    lmax = from_df64(*lc).abs().max().item()
    ad = a.to(dev)
    r_gpu = residual_potrf_df64_blocked(ad, None, *lg, s=S_DF64, rc=2048)
    r_cpu = residual_potrf_df64_blocked(ad, None, lc[0].to(dev), lc[1].to(dev), s=S_DF64,
                                        rc=2048)
    print(f"df64 N={n}, kernel on the card vs plain on the CPU: max|dL|={dl:.3e} "
          f"(max|L|={lmax:.3e}), residuals {r_gpu:.3e} vs {r_cpu:.3e} (gate 1e-10)", flush=True)
    require(dl <= 1e-12 * lmax, "df64 kernel-path L disagrees with the plain path")
    require(r_gpu < 1e-10 and r_cpu < 1e-10, "df64 check residual above 1e-10")


# ---- 14. the panel kernels against their plain versions ---------------------------
def panel_body_counts():
    """The per-body call counts of #4 and #3 and the task kernels' launch
    counts per body, all of the library's counts that those share bodies with."""
    from dla_tpu_torch.kernels import panel, tiles

    return {"panel_factor": panel.panel_factor_body_launches(),
            "panel_apply": panel.panel_apply_body_launches(),
            "tile_ops": tiles.tile_body_launches()}


def ran_through(kernel, before, body) -> None:
    """Require that one call of ``kernel`` ("panel_factor" or "panel_apply")
    since ``before`` (``panel_body_counts``) went through ``body`` and moved
    no other count."""
    after = panel_body_counts()
    rose = {k: v - before[kernel][k] for k, v in after[kernel].items() if v != before[kernel][k]}
    require(rose == {body: 1}, f"{kernel}: ran through {rose}, expected one call through {body}")
    require(all(after[k] == before[k] for k in after if k != kernel),
            f"{kernel} moved the other kernels' body counts")


def panel_factor_case(dev, tag, m, nb, dtype, prec, iters):
    """Kernel #4 against its plain version. The diagonal block is SPD with
    NaN above its diagonal, which neither version may read. The diagonal
    block must be the plain version's bits (the tiled schedule of
    ``diag_block.cuh`` rounds every element where the plain version does, in
    the same order); the whole output is held to 1e-5·max|L| for fp32
    (fp64: 1e-12), since the products sum the same partial products in
    another order. The product runs through ``panel.panel_factor_body``; on
    the chain bodies (fp32 ``highest``, fp64) the rows below must be, bit for
    bit, the scalar body's trsm of them with ``potrf_tile``'s inverse of the
    block (the plain version's bits, as the diagonal phase's). The diagonal
    phase alone (m = nb) is timed beside ``cholesky_ex`` +
    ``solve_triangular``, the two calls that give L_kk and its inverse, and
    its bound."""
    from dla_tpu_torch.kernels import panel, tiles
    from dla_tpu_torch.utils import precision

    g = torch.Generator(device=dev).manual_seed(m + nb)
    a = torch.randn(m, nb, generator=g, device=dev, dtype=torch.float64)
    a[:nb] = a[:nb] @ a[:nb].mT + nb * torch.eye(nb, device=dev, dtype=torch.float64)
    p = a.to(dtype)
    p[:nb] += torch.triu(torch.full((nb, nb), float("nan"), device=dev, dtype=dtype), 1)
    body = panel.panel_factor_body(dtype, prec)
    sched = panel.panel_factor_schedule(m, nb, dtype, prec)
    with precision.override(prec):
        ref = panel.panel_factor_plain(p)
        before, counts = panel.panel_factor_launches, panel_body_counts()
        out = panel.panel_factor(p)
        sync()
        require(panel.panel_factor_launches == before + 1, "panel_factor: not one launch")
        ran_through("panel_factor", counts, body)
        require(bool(torch.isfinite(out).all()), "panel_factor read above the diagonal")
        same = torch.equal(bits(out[:nb]), bits(ref[:nb]))
        err = (out.double() - ref.double()).abs().max().item()
        tol = (1e-12 if dtype == torch.float64 else 1e-5) * ref.abs().max().item()
        scalar_bits = None  # the tensor-core body sums in another order
        if body != "wgmma":
            l, linv = tiles.potrf_tile(p[:nb])
            below = tiles.tile_op_reference("trsm", None, p[nb:], linv, tile=0)
            scalar_bits = (torch.equal(bits(out[:nb]), bits(l))
                           and torch.equal(bits(out[nb:]), bits(below)))
            del l, linv, below
        k_ms = cuda_ms(lambda: panel.panel_factor(p), iters)
        q_ms = queued_ms(lambda: panel.panel_factor(p), iters)
        a_ms = cuda_ms(lambda: panel.panel_factor(p[:nb]), iters)  # m = nb: the diagonal phase
        p_ms = cuda_ms(lambda: panel.panel_factor_plain(p), 1)
    spd = torch.tril(p[:nb]) + torch.tril(p[:nb], -1).mT
    eye = torch.eye(nb, device=dev, dtype=dtype)
    a_lib = (cuda_ms(lambda: torch.linalg.cholesky_ex(spd), iters)
             + cuda_ms(lambda: torch.linalg.solve_triangular(ref[:nb], eye, upper=False), iters))
    a_bound = bound(2 * nb**3 / 3 / PEAK["fp64" if dtype == torch.float64 else "fp32"],
                    3 * nb * nb * p.element_size())
    launches, blocks = tiles.potrf_tile_schedule(nb)
    # the diagonal phase's 2·nb³/3 rank-1 operations on the non-tensor peak,
    # the 2·(m − nb)·nb² product at the tier; the panel read, the output written
    item = p.element_size()
    row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None, body=body, queued=q_ms,
               **bound(2 * nb**3 / 3 / PEAK["fp64" if dtype == torch.float64 else "fp32"]
                       + product_s(2 * (m - nb) * nb * nb, dtype, prec), 2 * m * nb * item))
    name = f"m={m} nb={nb} {str(dtype)[6:]}/{prec}"
    chain = "" if scalar_bits is None else f", the scalar body's bits {scalar_bits}"
    print(f"panel_factor {name}: body {body}, {sched.launches} launches a call; diagonal block "
          f"same bits as plain {same}{chain}, max_abs_err={err:.3e} (tol {tol:.3e}) kernel "
          f"{k_ms:.3f} ms (card time alone {q_ms:.3f} ms), plain {p_ms:.3f} ms, bound "
          f"{row['bound_ms']:.3f} ms ({row['bound_by']}), {row['bound_ms'] / k_ms:.1%} of the "
          f"bound ({row['bound_ms'] / q_ms:.1%} alone); diagonal phase alone {a_ms:.4f} ms "
          f"({launches} launches, up to {blocks} blocks), cholesky_ex + solve_triangular "
          f"{a_lib:.4f} ms, bound {a_bound['bound_ms']:.5f} ms ({a_bound['bound_by']}) {tag}",
          flush=True)
    require(same, f"panel_factor's diagonal block is not the plain version's bits at {name}")
    require(scalar_bits is not False, f"panel_factor at {name} is not the scalar body's bits")
    require(err <= tol, f"panel_factor disagrees with the plain version at {name}")
    return row


def panel_apply_scalar_bits(out, lkk, b, ib) -> bool:
    """Whether #3's output at ``highest`` is, bit for bit, its schedule's
    products replayed one by one through the scalar body
    (``tiles.tile_op_reference``, tile 0) on the same ib×ib inverses."""
    from dla_tpu_torch.kernels import panel, tiles

    m, nb = b.shape
    dinv = panel._diag_inverses(lkk, ib)
    x = torch.full((m, nb), float("nan"), device=b.device)
    rhs = None
    for prod in panel.panel_apply_schedule(m, nb, ib, planes=0).products:
        j = prod.col
        if prod.epilogue == "gemm":
            rhs = tiles.tile_op_reference("gemm", b[:, j : j + ib], x[:, :j], lkk[j : j + ib, :j])
        else:
            x[:, j : j + ib] = tiles.tile_op_reference("trsm", None, b[:, :ib] if j == 0 else rhs,
                                                       dinv[j : j + ib])
    return torch.equal(bits(out), bits(x))


def panel_apply_case(dev, tag, m, nb, ib, tb, prec, iters):
    """Kernel #3 against its plain version, through the block body
    ``panel.panel_apply_body`` names (the library's count of calls through
    each body; the task kernels' count must not move). Tolerance, of max|X|:
    1e-4 at high and highest (the right-hand sides are summed in another
    order, so their bf16x3 splits differ in the last fp32 bits); 2^-6 at
    default (one bf16 pass: a right-hand side the two sum differently may
    round to neighbouring bf16 values). At ``highest`` the output must also
    be the scalar body's bits, product by product."""
    from dla_tpu_torch.kernels import panel
    from dla_tpu_torch.utils import precision

    g = torch.Generator(device=dev).manual_seed(m + nb + ib)
    lkk = torch.tril(torch.randn(nb, nb, generator=g, device=dev)) + nb * torch.eye(nb, device=dev)
    b = torch.randn(m, nb, generator=g, device=dev)
    body = panel.panel_apply_body(prec)
    with precision.override(prec):
        ref = panel.panel_apply_plain(lkk, b, ib=ib, tb=tb)
        before, counts = panel.panel_apply_launches, panel_body_counts()
        out = panel.panel_apply(lkk, b, ib=ib, tb=tb)
        sync()
        require(panel.panel_apply_launches == before + 1, "panel_apply: not one launch")
        ran_through("panel_apply", counts, body)
        per_call = panel.panel_apply_schedule(m, nb, ib).launches
        err = (out - ref).abs().max().item()
        tol = (2**-6 if prec == "default" else 1e-4) * ref.abs().max().item()
        scalar_bits = panel_apply_scalar_bits(out, lkk, b, ib) if body != "wgmma" else None
        k_ms = cuda_ms(lambda: panel.panel_apply(lkk, b, ib=ib, tb=tb), iters)
        q_ms = queued_ms(lambda: panel.panel_apply(lkk, b, ib=ib, tb=tb), iters)
        p_ms = cuda_ms(lambda: panel.panel_apply_plain(lkk, b, ib=ib, tb=tb), iters)
    inv_ms = cuda_ms(lambda: panel._diag_inverses(lkk, ib), iters)  # the wrapper's part
    # the one PyTorch call for X·Lᵀ = B, IEEE fp32 (TF32 is off)
    lib_ms = cuda_ms(lambda: torch.linalg.solve_triangular(lkk.mT, b, upper=True, left=False),
                     iters)
    row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, body=body, queued=q_ms,
               **bound(product_s(m * nb * (nb + ib), torch.float32, prec),
                       4 * (2 * m * nb + nb * nb)))
    name = f"m={m} nb={nb} ib={ib} tb={tb} float32/{prec}"
    chain = "" if scalar_bits is None else f", the scalar body's bits {scalar_bits}"
    print(f"panel_apply {name}: body {body}, {per_call} launches a call{chain}, max_abs_err="
          f"{err:.3e} (tol {tol:.3e}) kernel {k_ms:.3f} ms (the ib x ib inverses built before it "
          f"{inv_ms:.3f} ms of that; card time alone {q_ms:.3f} ms), solve_triangular "
          f"{lib_ms:.3f} ms (x{lib_ms / k_ms:.2f}), plain {p_ms:.3f} ms, bound "
          f"{row['bound_ms']:.3f} ms ({row['bound_by']}), {row['bound_ms'] / k_ms:.1%} of the "
          f"bound {tag}", flush=True)
    require(scalar_bits is not False, f"panel_apply at {name} is not the scalar body's bits")
    require(err <= tol, f"panel_apply disagrees with the plain version at {name}")
    return row


def panel_apply_host(dev, tag, m, nb, ib, iters):
    """#3 at fp32 high on one of the path's short panels: calls back to back
    (what the path pays) beside the same calls queued behind a sleeping
    kernel (the card's time alone; the difference is the host's), and the
    ib x ib inverses that the wrapper builds before the C call, alone."""
    from dla_tpu_torch.kernels import panel
    from dla_tpu_torch.utils import precision

    g = torch.Generator(device=dev).manual_seed(m + nb)
    lkk = torch.tril(torch.randn(nb, nb, generator=g, device=dev)) + nb * torch.eye(nb, device=dev)
    b = torch.randn(m, nb, generator=g, device=dev)
    with precision.override("high"):
        call = lambda: panel.panel_apply(lkk, b, ib=ib, tb=min(1024, nb))  # noqa: E731
        back = cuda_ms(call, iters)
        card = queued_ms(call, iters)
        inv = queued_ms(lambda: panel._diag_inverses(lkk, ib), iters)
    print(f"panel_apply m={m} nb={nb} ib={ib} float32/high: back to back {back:.4f} ms, queued "
          f"behind a sleeping kernel {card:.4f} ms (the host's share "
          f"{max(0.0, 1 - card / back):.1%}), of which the ib x ib inverses, queued alone, "
          f"{inv:.4f} ms {tag}", flush=True)


def phase_panel_kernels(dev, tag):
    rows = {}
    for prec in ("highest", "high", "default"):
        rows[("factor", prec)] = panel_factor_case(dev, tag, N_HIGHEST, NB_PANEL_FACTOR,
                                                   torch.float32, prec, 5)
    panel_factor_case(dev, tag, 8192, NB_PANEL_FACTOR, torch.float64, "high", 3)
    nb = MAIN_KW["nb"]
    for prec in ("high", "highest", "default"):
        rows[("apply", prec)] = panel_apply_case(dev, tag, N_MAIN - nb, nb,
                                                 PANEL_APPLY_KW["panel_ib"], min(1024, nb),
                                                 prec, 5)
    for m in (3 * nb, nb):  # the path's last panels
        panel_apply_host(dev, tag, m, nb, PANEL_APPLY_KW["panel_ib"], 10)
    torch.cuda.empty_cache()
    return rows[("factor", "highest")], rows[("apply", "high")]


# ---- 15. to 17. the shrink tier and the two panel-kernel paths -----------------------
def timed_path(dev, tag, name, n, factor, per_fact, reps):
    """Factor ``plgsy(n)`` ``reps`` times after one warm-up, with every
    launch count set to 0 just before and read just after; each repeat
    must launch ``per_fact[k]`` times counter ``k`` (a (module, name) pair).
    Returns the counts, the median, the last factor and its input."""
    import dla_tpu_torch as T
    from dla_tpu_torch.kernels import df64_tiles, panel, tiles

    for mod, attr in ((tiles, "launches"), (tiles, "packed_launches"), (df64_tiles, "launches"),
                      (df64_tiles, "packed_launches"), (panel, "panel_factor_launches"),
                      (panel, "panel_apply_launches")):
        setattr(mod, attr, 0)
    times = []
    for rep in range(reps + 1):
        l = a = None  # free the previous pair before the next one exists
        a = T.plgsy(n, seed=51, device=dev)
        sync()
        before = {k: getattr(*k) for k in per_fact}
        t0 = time.perf_counter()
        l = factor(a)
        sync()
        dt = time.perf_counter() - t0
        for k, want in per_fact.items():
            got = getattr(*k) - before[k]
            require(got == want, f"{name}: {got} {k[1]} in one factorization, expected {want}")
        print(f"{name}: repeat {rep} {dt * 1e3:.1f} ms {n**3 / 3 / dt / 1e9:.2f} GFLOP/s"
              f"{' (warm-up)' if rep == 0 else ''} {tag}", flush=True)
        if rep:
            times.append(dt)
    counts = {k[1]: getattr(*k) for k in per_fact}
    require(all(counts[k[1]] == (reps + 1) * v for k, v in per_fact.items()),
            f"{name}: launch counts {counts}")
    tmed = statistics.median(times)
    print(f"{name}: median {tmed * 1e3:.1f} ms, {n**3 / 3 / tmed / 1e9:.2f} GFLOP/s, "
          f"launches {counts} {tag}", flush=True)
    return counts, tmed, l, a


def dense_residual(name, a, l, n, ms=None):
    """The factor's residual under the driver's fp32 gate; ``ms``, where
    given, is printed beside it."""
    import dla_tpu_torch as T

    ltri = torch.tril(l)
    require(ltri.shape == (n, n) and bool(torch.isfinite(ltri).all()),
            f"{name}: the factor has non-finite entries")
    res = float(T.residual_potrf(a, ltri, assume_symmetric=True, assume_tril=True,
                                 row_chunk=min(n, 4096)))
    gate = max(1e-10, n * 2e-7)  # the driver's fp32 gate
    took = "" if ms is None else f"median {ms:.1f} ms, "
    print(f"{name}: {took}||A - LL^T||_inf / ||A||_inf = {res:.3e} (gate {gate:g})", flush=True)
    require(res < gate, f"{name}: residual above the fp32 gate")
    return res


def simt_launches(name, bodies, launches, body="simt"):
    """Require that the trailing kernels' ``launches`` since ``bodies`` (the
    counts per body) all went through ``body``."""
    from dla_tpu_torch.kernels import tiles

    rose = {b: v - bodies[b] for b, v in tiles.body_launches().items() if v != bodies[b]}
    require(rose == {body: launches}, f"{name}: {launches} #1 launches went through {rose}")


def phase_highest_tier(dev, tag):
    import dla_tpu_torch as T
    import dla_tpu_torch.algos as TA
    from dla_tpu_torch.kernels import tiles

    n, nb = N_HIGHEST, HIGHEST_KW["nb"]
    name = f"highest tier potrf_shrink N={n} nb={nb} blocktrsm/pallas fp32 highest"
    bodies = tiles.body_launches()
    counts, tmed, l, a = timed_path(dev, tag, name, n, lambda a: TA.potrf_shrink(a, **HIGHEST_KW),
                                    {(tiles, "launches"): n // nb - 1}, reps=3)
    simt_launches(name, bodies, counts["launches"])
    print(f"{name}: median {tmed * 1e3:.1f} ms; with #1 on nt_block: {HIGHEST_PATH_BEFORE} {tag}",
          flush=True)
    dense_residual(name, a, l, n)
    del a, l
    torch.cuda.empty_cache()
    return tmed


def phase_panel_factor_path(dev, tag):
    """The path at ``highest`` and at ``high``: #4's calls through the body
    of the tier (``simt``, ``wgmma``), #1's too; returns #4's launches."""
    import dla_tpu_torch.algos as TA
    from dla_tpu_torch.kernels import panel, tiles

    n, nb = N_HIGHEST, NB_PANEL_FACTOR
    launches = 0
    for prec in ("highest", "high"):
        name = f"panel_factor path potrf_shrink N={n} nb={nb} pallas/pallas fp32 {prec}"
        bodies, factor_bodies = tiles.body_launches(), panel.panel_factor_body_launches()
        counts, tmed, l, a = timed_path(
            dev, tag, name, n,
            lambda a, prec=prec: TA.potrf_shrink(a, nb=nb, panel="pallas", trailing="pallas",
                                                precision=prec),
            {(panel, "panel_factor_launches"): n // nb, (tiles, "launches"): n // nb - 1}, reps=2)
        simt_launches(name, bodies, counts["launches"], tiles.trailing_body(torch.float32, prec))
        body = panel.panel_factor_body(torch.float32, prec)
        rose = {b: v - factor_bodies[b] for b, v in panel.panel_factor_body_launches().items()
                if v != factor_bodies[b]}
        require(rose == {body: counts["panel_factor_launches"]},
                f"{name}: {counts['panel_factor_launches']} #4 calls went through {rose}")
        beside = (f"; with #4's products on nt_block: {PANEL_FACTOR_PATH_BEFORE}"
                  if prec == "highest" else "")
        print(f"{name}: median {tmed * 1e3:.1f} ms, #4 through {body}{beside} {tag}", flush=True)
        dense_residual(name, a, l, n)
        launches += counts["panel_factor_launches"]
        del a, l
        torch.cuda.empty_cache()
    return launches


def phase_panel_apply_path(dev, tag, main_median):
    import dla_tpu_torch as T
    import dla_tpu_torch.algos as TA
    from dla_tpu_torch.kernels import panel, tiles

    n, nb = N_MAIN, PANEL_APPLY_KW["nb"]
    name = f"panel_apply path potrf_inplace(panel='pallas') N={n} nb={nb} fp32 high"
    per_fact = n // nb - 1
    bodies = panel.panel_apply_body_launches()
    counts, tmed, l, _ = timed_path(
        dev, tag, name, n, lambda a: TA.potrf_inplace(a, **PANEL_APPLY_KW),
        {(panel, "panel_apply_launches"): per_fact, (tiles, "launches"): per_fact}, reps=3)
    after = panel.panel_apply_body_launches()
    require(after["wgmma"] - bodies["wgmma"] == counts["panel_apply_launches"]
            and after["scalar"] == bodies["scalar"],
            f"{name}: panel_apply's calls went through {after} (before: {bodies})")
    beside = "not run" if main_median is None else f"{main_median * 1e3:.1f} ms"
    print(f"N={n} fp32 high potrf_inplace median: panel='pallas' {tmed * 1e3:.1f} ms, "
          f"panel='blocktrsm' (phase 3) {beside}; panel='pallas' with #3 on 64-row strips "
          f"of scalar FMAs, before its redesign: {PANEL_APPLY_PATH_BEFORE} {tag}", flush=True)
    dense_residual(name, T.plgsy(n, seed=51, device=dev), l, n)
    del l
    torch.cuda.empty_cache()
    return counts["panel_apply_launches"]


# ---- 18. every potrf mode, card against CPU ----------------------------------------
def phase_modes_check(dev):
    import dla_tpu_torch as T
    from dla_tpu_torch.kernels import panel, tiles

    n = N_MODES
    a = T.plgsy(n, seed=7, device="cpu")
    for kw, kernels in (
        ({}, (0, 0)),  # the public default: mode="blocked", nb=256, xla panel and trailing
        (dict(mode="blocked", nb=512, panel="pallas", trailing="pallas"), (n // 512, n // 512 - 1)),
        (dict(mode="masked", nb=512), (0, 0)),
        (dict(mode="shrink", panel="invgemm"), (0, 0)),
    ):
        before = (panel.panel_factor_launches, tiles.launches)
        ad = a.to(dev)
        lg = T.potrf(ad, **kw)
        sync()
        got = (panel.panel_factor_launches - before[0], tiles.launches - before[1])
        require(got == kernels, f"potrf {kw}: launches {got}, expected {kernels}")
        require(torch.equal(ad.cpu(), a), f"potrf {kw} changed its input")
        lc = T.potrf(a, **kw)
        dl = (lg.cpu() - lc).abs().max().item()
        r_gpu = float(T.residual_potrf(a, lg.cpu()))
        r_cpu = float(T.residual_potrf(a, lc))
        print(f"potrf N={n} {kw or 'defaults'} fp32, card vs plain on the CPU: max|dL|={dl:.3e} "
              f"(max|L|={lc.abs().max().item():.3e}), residuals {r_gpu:.3e} vs {r_cpu:.3e} "
              f"(gate {n * 2e-7:g})", flush=True)
        require(dl <= 1e-5 * lc.abs().max().item(), f"potrf {kw}: card and CPU disagree")
        require(r_gpu < n * 2e-7 and r_cpu < n * 2e-7, f"potrf {kw}: residual above the gate")


# ---- 20. the packed df64 kernel against its plain version ----------------------------
def packed_df64_case(dev, tag, n, nb, tb, s, w, k, iters):
    from dla_tpu_torch.algos.packed import packed_rows
    from dla_tpu_torch.kernels import df64_tiles
    from dla_tpu_torch.kernels.df64_tiles import trailing_update_packed_df64_plain
    from dla_tpu_torch.ops.df64 import slice_rows, to_df64

    nt, base = n // nb, (k + 1) * nb
    g = torch.Generator(device=dev).manual_seed(n + 7 * k + nb)
    ch, cl = to_df64(torch.randn(packed_rows(n, nb), nb, generator=g, device=dev,
                                 dtype=torch.float64))
    p = torch.randn(n - base, nb, generator=g, device=dev, dtype=torch.float64)
    sx = slice_rows(*to_df64(p), s=s, w=w)[0]
    del p
    kw = dict(n=n, nb=nb, k=k, tb=tb, w=w)
    ref = trailing_update_packed_df64_plain(ch.clone(), cl.clone(), sx, **kw)
    out = (ch.clone(), cl.clone())
    before = df64_tiles.packed_launches
    res = df64_tiles.trailing_update_packed_df64(*out, sx, **kw)
    sync()
    require(res[0] is out[0] and res[1] is out[1]
            and df64_tiles.packed_launches == before + 1,
            "packed df64 kernel did not update the pair in place with one launch")
    changed = False
    for j in range(nt):  # slab by slab: the visited mask of one slab at a time
        rows, visit = slab_visit(dev, n, nb, tb, base, j)
        for o, c in zip(out, (ch, cl)):
            require(torch.equal(bits(torch.where(visit, 0, o[rows])),
                                bits(torch.where(visit, 0, c[rows]))),
                    f"elements outside the visited tiles of slab {j} changed")
        changed = changed or not torch.equal(out[0][rows], ch[rows])
        del visit
    require(changed, "the packed df64 kernel changed nothing")
    del ch, cl
    same = all(torch.equal(bits(o), bits(r)) for o, r in zip(out, ref))
    err = max((o - r).abs().max().item() for o, r in zip(out, ref))
    k_ms = cuda_ms(lambda: df64_tiles.trailing_update_packed_df64(*out, sx, **kw), iters)
    p_ms = cuda_ms(lambda: trailing_update_packed_df64_plain(*ref, sx, **kw), iters)
    mt = (n - base) // tb
    pairs = mt * (mt + 1) // 2
    flops = 2 * pairs * tb * tb * nb * (s * (s + 1) // 2)
    # s(s+1)/2 one-pass bf16 products; both fp32 planes of each visited tile
    # read and written once, the slices read once
    row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None, body=DF64_BODY,
               **bound(flops / PEAK["bf16"], 2 * 2 * pairs * tb * tb * 4
                       + sum(x.numel() * x.element_size() for x in sx)))
    name = f"n={n} nb={nb} tb={tb} s={s} w={w} k={k}"
    print(f"trailing_update_packed_df64 {name}: body {DF64_BODY}, bits equal {same} "
          f"(max_abs_err={err:.3e}) kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, kernel "
          f"{flops / k_ms / 1e9:.2f} TF/s one-pass, bound {row['bound_ms']:.3f} ms "
          f"({row['bound_by']}), {row['bound_ms'] / k_ms:.1%} of the bound {tag}", flush=True)
    require(same, f"packed df64 kernel and plain version differ in their bits at {name}")
    del out, ref, sx
    torch.cuda.empty_cache()
    return row


def phase_packed_df64_kernel(dev, tag):
    n, nb, tb, s = N_PDF64, NB_PDF64, KTB_PDF64, S_DF64
    path_case = packed_df64_case(dev, tag, n, nb, tb, s, 8, 0, iters=1)
    packed_df64_case(dev, tag, n, nb, tb, s, 8, n // nb // 2, iters=2)
    packed_df64_case(dev, tag, 1024, 512, 128, 6, 9, 0, iters=5)  # nk = 2 chunks of kb = 256
    for k in (0, 1):  # tb not a multiple of the 64-wide block: blocks straddle tiles
        packed_df64_case(dev, tag, 576, 192, 96, s, 8, k, iters=5)
    return path_case


# ---- 21. the packed df64 path -------------------------------------------------------
def phase_packed_df64_path(dev, tag):
    import dla_tpu_torch as T
    import dla_tpu_torch.algos as TA
    from dla_tpu_torch.algos import potrf_packed_df64
    from dla_tpu_torch.algos.potrf_df64 import freivalds_packed_df64
    from dla_tpu_torch.kernels import df64_tiles

    n, nb = N_PDF64, NB_PDF64
    per_fact = n // nb - 1
    aph = TA.plgsy_packed(n, nb, bump=float(n), seed=51, device=dev)
    apl = torch.zeros_like(aph)
    sync()
    torch.cuda.reset_peak_memory_stats()
    df64_tiles.packed_launches = 0
    t0 = time.perf_counter()
    lph, lpl = potrf_packed_df64(aph, apl, n, nb, **PDF64_KW)
    sync()
    dt = time.perf_counter() - t0
    launches = df64_tiles.packed_launches
    peak = torch.cuda.max_memory_allocated()
    require(lph is aph and lpl is apl, "potrf_packed_df64 did not factor its pair in place")
    require(launches == per_fact, f"{launches} packed df64 kernel launches in one "
            f"factorization, expected {per_fact}")
    pair_gb = 2 * lph.numel() * lph.element_size() / 1e9
    print(f"packed df64 path N={n} nb={nb} s={S_DF64}: {dt * 1e3:.1f} ms "
          f"{n**3 / 3 / dt / 1e9:.2f} GFLOP/s, {launches} packed df64 kernel launches, pair "
          f"{pair_gb:.2f} GB, peak {peak / 1e9:.3f} GB {tag}", flush=True)
    require(lph.shape == (n * (n + nb) // (2 * nb), nb)
            and bool(torch.isfinite(lph).all() and torch.isfinite(lpl).all()),
            "the packed df64 factor has non-finite entries")
    t0 = time.perf_counter()
    res = freivalds_packed_df64(lph, lpl, n, nb, gen_seed=51, bump=float(n), s=S_DF64,
                                row_chunk=min(1024, n))
    sync()
    t_gate = time.perf_counter() - t0
    l64 = T.unpack_tri(lph, n, nb).double()
    l64 += T.unpack_tri(lpl, n, nb)
    del lph, lpl, aph, apl
    res64 = float(T.residual_potrf(T.plgsy(n, bump=float(n), seed=51, device=dev), l64,
                                   assume_symmetric=True, assume_tril=True,
                                   row_chunk=min(n, 4096)))
    print(f"packed df64 path freivalds ||(A - LL^T)x|| / (||A|| ||x||) = {res:.3e} (df64, "
          f"packed-native, {t_gate:.1f} s; gate 1e-10), native fp64 ||A - LL^T||_inf / "
          f"||A||_inf = {res64:.3e}", flush=True)
    require(res < 1e-10, "packed df64 path Freivalds value above the reference's 1e-10 gate")
    require(res64 < 1e-10, "packed df64 path native fp64 residual above 1e-10")
    del l64
    torch.cuda.empty_cache()
    return launches


# ---- 22. packed df64 kernel path against plain path ----------------------------------
def phase_packed_df64_check(dev):
    import dla_tpu_torch as T
    import dla_tpu_torch.algos as TA
    from dla_tpu_torch.algos import (
        freivalds_potrf_df64,
        potrf_df64,
        potrf_packed_df64,
        potrf_packed_df64_split,
        potrs_df64,
        potrs_packed_df64,
    )
    from dla_tpu_torch.algos.potrf_df64 import freivalds_packed_df64, freivalds_potrf_df64_gen
    from dla_tpu_torch.kernels import df64_tiles
    from dla_tpu_torch.ops import from_df64, to_df64

    n, nb = N_PDF64_CHECK, NB_PDF64
    steps = n // nb - 1

    def on_card(fac, *a, **kw):  # through the kernel, `steps` launches
        before = df64_tiles.packed_launches
        out = fac(*a, **kw)
        sync()
        require(df64_tiles.packed_launches - before == steps,
                "packed df64 kernel launch count on the check path")
        return out

    a_cpu = TA.plgsy_packed(n, nb, seed=7, device="cpu")
    lg = on_card(potrf_packed_df64, a_cpu.to(dev), torch.zeros(a_cpu.shape, device=dev), n, nb,
                 **PDF64_KW)
    lc = potrf_packed_df64(a_cpu.clone(), torch.zeros_like(a_cpu), n, nb, **PDF64_KW)
    dense = [from_df64(*(T.unpack_tri(x, n, nb) for x in pair)) for pair in (lg, lc)]
    dl = (dense[0].cpu() - dense[1]).abs().max().item()
    lmax = dense[1].abs().max().item()
    print(f"packed df64 N={n}, kernel on the card vs plain on the CPU: max|dL|={dl:.3e} "
          f"(max|L|={lmax:.3e})", flush=True)
    require(dl <= 1e-12 * lmax, "packed df64 kernel-path L disagrees with the plain path")

    a32 = T.plgsy(n, seed=7, device=dev)
    ld = potrf_df64(a32.clone(), torch.zeros_like(a32), **DF64_KW)
    dd = (from_df64(*ld) - dense[0]).abs().max().item()
    ls = on_card(potrf_packed_df64_split, a_cpu.to(dev), torch.zeros(a_cpu.shape, device=dev),
                 n, nb, split=2, **PDF64_KW)
    split_same = all(torch.equal(bits(x), bits(y)) for x, y in zip(ls, lg))
    print(f"packed df64 N={n}: max|L_packed - L_dense(potrf_df64)| = {dd:.3e}; split=2 bits "
          f"equal to the monolith: {split_same}", flush=True)
    require(dd <= 1e-12 * lmax, "potrf_packed_df64 disagrees with potrf_df64")
    require(split_same, "potrf_packed_df64_split(split=2) differs from the monolith")

    # the solves under the reference's posv gate, against fp64 on the card
    a64 = a32.double()
    g = torch.Generator(device=dev).manual_seed(3)
    b64 = torch.randn(n, 4, generator=g, device=dev, dtype=torch.float64)
    bh, bl = to_df64(b64)
    for name, xs in (
        ("potrs_packed_df64 trmm", potrs_packed_df64(*lg, bh, bl, n, nb)),
        ("potrs_packed_df64 matvec", potrs_packed_df64(*lg, bh, bl, n, nb, engine="matvec")),
        ("potrs_df64", potrs_df64(*ld, bh, bl)),
    ):
        x = from_df64(*xs)
        r = ((b64 - a64 @ x).abs().max() / (a64.abs().max() * x.abs().max())).item()
        print(f"packed df64 N={n} {name}: ||b - Ax||_max / (||A||_max ||x||_max) = {r:.3e} "
              "(gate 1e-10)", flush=True)
        require(r < 1e-10, f"{name} above the posv gate")
    del a64

    # one factor, three gates; and the packed gate on the card against the CPU
    fp = freivalds_packed_df64(*lg, n, nb, gen_seed=7, s=S_DF64)
    lh, ll = (T.unpack_tri(x, n, nb) for x in lg)
    fd = float(freivalds_potrf_df64(lh, ll, a32, None, s=S_DF64))
    fg = freivalds_potrf_df64_gen(lh, ll, gen_seed=7, s=S_DF64)
    fc = freivalds_packed_df64(lg[0].cpu(), lg[1].cpu(), n, nb, gen_seed=7, s=S_DF64)
    print(f"packed df64 N={n} df64 Freivalds gates of one factor: packed {fp:.6e}, dense "
          f"{fd:.6e}, generator-streamed {fg:.6e}; packed on the CPU {fc:.6e}", flush=True)
    require(max(fp, fd, fg, fc) < 1e-10, "a df64 Freivalds gate above 1e-10")
    # the dense gates run the same strip products on the same probes: they differ
    # only in the order of the fp32 |A| row sums. The packed gate sums L·(Lᵀx) tile
    # by tile, another order of compensated adds: the same magnitude.
    require(abs(fg - fd) <= 1e-4 * fd, "the two dense Freivalds gates disagree")
    require(0.2 <= fp / fd <= 5, "packed and dense Freivalds gates disagree in magnitude")
    # every product is an exact per-chunk sum, so the card and the CPU differ
    # only in the order of the fp32 |A| row sums
    require(abs(fp - fc) <= 1e-4 * fc, "the packed Freivalds gate differs between card and CPU")


# ---- 24. the task kernels against their plain versions --------------------------------
def product_tol(dtype, c, a, b) -> float:
    """fp64 1e-12·scale; fp32 1e-5·scale (the same partial products summed in
    another order); bf16 2^-6·(max|c| + scale); scale = max|a_i|·max|b_j|."""
    scale = (a.double().norm(dim=1).max() * b.double().norm(dim=1).max()).item()
    if dtype == torch.float64:
        return 1e-12 * scale
    if dtype == torch.float32:
        return 1e-5 * scale
    return 2**-6 * ((0.0 if c is None else c.double().abs().max().item()) + scale)


def task_product_case(dev, tag, op, m, n, k, dtype, prec, iters):
    """Kernels #6 to #8 (``op`` trsm, syrk or gemm) against their plain
    versions: out (m, n) = epilogue(c, a·bᵀ) with a (m, k), b (n, k). The
    library call is IEEE fp32 at every fp32 tier (TF32 is off)."""
    from dla_tpu_torch.kernels import tiles
    from dla_tpu_torch.utils import precision

    g = torch.Generator(device=dev).manual_seed(m + 3 * n + 7 * k)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    if op == "trsm":  # trsm_tile(linv (n, n), b (m, n))
        c, a, b = None, rnd(m, n), torch.tril(rnd(n, n))
        args = (b, a)
        lib = lambda: torch.matmul(a, b.mT)  # noqa: E731
        flops, nbytes = 2 * m * n * n, 2 * m * n + n * n
    elif op == "syrk":  # syrk_tile(c (n, n), a (n, k)): the lower triangle's products
        m = n
        c, a = rnd(n, n), rnd(n, k)
        b, args, lib = a, (c, a), None  # no one call masks the triangle
        flops, nbytes = n * (n + 1) * k, 2 * n * n + n * k
    else:  # gemm_tile(c (m, n), ai (m, k), aj (n, k))
        c, a, b = rnd(m, n), rnd(m, k), rnd(n, k)
        args = (c, a, b)
        lib = lambda: torch.addmm(c, a, b.mT, beta=1, alpha=-1)  # noqa: E731
        flops, nbytes = 2 * m * n * k, 2 * m * n + (m + n) * k
    kernel, plain = getattr(tiles, f"{op}_tile"), getattr(tiles, f"{op}_tile_plain")
    counter = f"{op}_tile_launches"
    kept = [t.clone() for t in args]
    with precision.override(prec):
        ref = plain(*args)
        before, bodies = getattr(tiles, counter), tiles.tile_body_launches()
        out = kernel(*args)
        sync()
        require(getattr(tiles, counter) == before + 1, f"{op}_tile: not one launch")
        rose = [x for x, v in tiles.tile_body_launches().items() if v != bodies[x]]
        body = tiles.tile_op_body(op, dtype, prec)
        require(rose == [body], f"{op}_tile: launched through {rose}, expected the {body} body")
        require(all(out.data_ptr() != t.data_ptr() for t in args)
                and all(torch.equal(bits(t), bits(t0)) for t, t0 in zip(args, kept)),
                f"{op}_tile changed an input")
        if op == "syrk":
            require(torch.equal(bits(torch.triu(out, 1)), bits(torch.triu(c, 1))),
                    "syrk_tile: the upper triangle is not c's, bit for bit")
        err = (out.double() - ref.double()).abs().max().item()
        tol = product_tol(dtype, c, a, b)
        k_ms = cuda_ms(lambda: kernel(*args), iters)
        p_ms = cuda_ms(lambda: plain(*args), iters)
        chain = chain_case(op, body, out, c, a, b, iters) if body in ("simt", "dmma") else ""
    lib_ms = cuda_ms(lib, iters) if lib else None
    row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, body=body,
               **bound(product_s(flops, dtype, prec), nbytes * a.element_size()))
    yard = ""
    if op == "syrk":  # the full square's product, twice syrk's operations: not syrk's function
        row["addmm_square_ms"] = cuda_ms(lambda: torch.addmm(c, a, a.mT, alpha=-1), iters)
        yard = f", yardstick torch.addmm(c, a, a.mT, alpha=-1) on the full square " \
               f"{row['addmm_square_ms']:.4f} ms"
    name = f"m={m} n={n} k={k} {str(dtype)[6:]}/{prec}"
    print(f"{op}_tile {name}: body {body}, max_abs_err={err:.3e} (tol {tol:.3e}) kernel {k_ms:.4f} ms "
          f"({flops / k_ms / 1e9:.3f} TF/s), plain {p_ms:.4f} ms, library "
          f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}{yard}, bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}){chain} {tag}", flush=True)
    require(err <= tol, f"{op}_tile disagrees with the plain version at {name}")
    return row


def chain_case(op, body, out, c, a, b, iters) -> str:
    """On the chain bodies: ``out`` must be the scalar body's bits
    (``tiles.tile_op_reference``), and so must the simt body at each tile
    edge (the dmma body has one); the card's time alone (launches queued
    behind a sleeping kernel) of the wrapper's launch, of the scalar body and
    of each simt edge, and the edge the launcher takes on this card
    (``tiles.chain_tile_edge``)."""
    from dla_tpu_torch.kernels import tiles

    def through(tile):
        return lambda: tiles.tile_op_reference(op, c, a, b, tile=tile)

    ref = through(0)()
    sync()
    require(torch.equal(bits(out), bits(ref)),
            f"{op}_tile: the {body} body lost the scalar body's bits")
    edges = (64, 128) if body == "simt" else ()
    for tile in edges:
        require(torch.equal(bits(through(tile)()), bits(ref)),
                f"{op}_tile: the {body} body at tile {tile} lost the scalar body's bits")
    if op == "trsm":
        wrapper = lambda: tiles.trsm_tile(b, a)  # noqa: E731
    elif op == "syrk":
        wrapper = lambda: tiles.syrk_tile(c, a)  # noqa: E731
    else:
        wrapper = lambda: tiles.gemm_tile(c, a, b)  # noqa: E731
    n_calls = max(5, min(20, iters))
    q = {name: queued_ms(fn, n_calls) for name, fn in (
        [("kernel", wrapper), ("scalar", through(0))]
        + [(f"edge {t}", through(t)) for t in edges])}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    aligned = all(x.data_ptr() % 16 == 0 and x.stride(0) * x.element_size() % 16 == 0
                  for x in (a, b))
    edge = tiles.chain_tile_edge(a.shape[0], b.shape[0], body, sms, aligned, op=op)
    return (f"; the scalar body's bits: True (edge {edge} of {sms} SMs"
            f"{', and both edges' if edges else ''}); card time alone: "
            + ", ".join(f"{name} {ms:.4f} ms" for name, ms in q.items())
            + f", kernel / scalar {q['kernel'] / q['scalar']:.3f}")


def potrf_tile_case(dev, tag, n, dtype, prec, iters):
    """Kernel #5 against its plain version, on an SPD tile with NaN above the
    diagonal: the plain version's bits (the kernel rounds every product,
    difference, quotient and root where the plain version does, in the same
    order), and within 1e-5·max|ref| for fp32 (fp64: 1e-12). The library
    figure is the sum of two calls, ``cholesky_ex`` and ``solve_triangular``
    against the identity (no one call gives both L and its inverse)."""
    from dla_tpu_torch.kernels import tiles
    from dla_tpu_torch.utils import precision

    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, n, generator=g, device=dev, dtype=torch.float64)
    spd = (x @ x.mT + n * torch.eye(n, device=dev, dtype=torch.float64)).to(dtype)
    a = spd + torch.triu(torch.full((n, n), float("nan"), device=dev, dtype=dtype), 1)
    kept = a.clone()
    eye = torch.eye(n, device=dev, dtype=dtype)
    with precision.override(prec):
        lref, xref = tiles.potrf_tile_plain(a)
        before = tiles.potrf_tile_launches
        l, linv = tiles.potrf_tile(a)
        sync()
        require(tiles.potrf_tile_launches == before + 1, "potrf_tile: not one launch")
        require(torch.equal(bits(a), bits(kept)), "potrf_tile changed its input")
        require(bool(torch.isfinite(l).all() and torch.isfinite(linv).all()),
                "potrf_tile read above the diagonal")
        require(torch.equal(l, torch.tril(l)) and torch.equal(linv, torch.tril(linv)),
                "potrf_tile: outputs not lower triangular")
        same = torch.equal(bits(l), bits(lref)) and torch.equal(bits(linv), bits(xref))
        rel = 1e-12 if dtype == torch.float64 else 1e-5
        err = max((l.double() - lref.double()).abs().max().item(),
                  (linv.double() - xref.double()).abs().max().item())
        tol = rel * max(lref.abs().max().item(), xref.abs().max().item())
        ok = ((l - lref).abs().max().item() <= rel * lref.abs().max().item()
              and (linv - xref).abs().max().item() <= rel * xref.abs().max().item())
        k_ms = cuda_ms(lambda: tiles.potrf_tile(a), iters)
        p_ms = cuda_ms(lambda: tiles.potrf_tile_plain(a), 1)
    lib_ms = (cuda_ms(lambda: torch.linalg.cholesky_ex(spd), iters)
              + cuda_ms(lambda: torch.linalg.solve_triangular(lref, eye, upper=False), iters))
    # n³/3 operations for the factor and n³/3 for the inverse, on the non-tensor
    # peak; the lower triangle read (counted as the tile), two tiles written
    item = a.element_size()
    row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
               **bound(2 * n**3 / 3 / PEAK["fp64" if dtype == torch.float64 else "fp32"],
                       3 * n * n * item))
    name = f"n={n} {str(dtype)[6:]}/{prec}"
    launches, blocks = tiles.potrf_tile_schedule(n)
    print(f"potrf_tile {name}: same bits as plain {same}, max_abs_err={err:.3e} (tol {tol:.3e}) "
          f"kernel {k_ms:.4f} ms ({launches} launches, up to {blocks} blocks), plain "
          f"{p_ms:.3f} ms, cholesky_ex + solve_triangular {lib_ms:.4f} ms, bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}) {tag}", flush=True)
    require(same, f"potrf_tile is not the plain version's bits at {name}")
    require(ok, f"potrf_tile disagrees with the plain version at {name}")
    return row


def phase_task_kernels(dev, tag):
    """Every task kernel at the path's tile (n = NB_TASK), a ragged n=96, and
    #6 to #8 at a size clear of the launch floor; the rows of the path's tier."""
    nb = NB_TASK
    tiers = [(torch.float32, "high"), (torch.float32, "highest"), (torch.float32, "default"),
             (torch.float64, "high")]
    rows = {}
    for dtype, prec in tiers:
        r = potrf_tile_case(dev, tag, nb, dtype, prec, 3)
        if (dtype, prec) == (torch.float32, TASK_PREC):
            rows["potrf"] = r
    potrf_tile_case(dev, tag, 96, torch.float32, "high", 5)
    chain_tiers = [(torch.float32, "highest"), (torch.float64, "high")]
    for op in ("trsm", "syrk", "gemm"):
        for dtype, prec in tiers + [(torch.bfloat16, "high")]:
            r = task_product_case(dev, tag, op, nb, nb, nb, dtype, prec, 50)
            if (dtype, prec) == (torch.float32, TASK_PREC):
                rows[op] = r
        task_product_case(dev, tag, op, 200, 96, 72, torch.float32, "high", 20)  # ragged
        if op == "syrk":  # ragged n=200 (the case above is n=96)
            task_product_case(dev, tag, op, 200, 200, 72, torch.float32, "high", 20)
        for dtype, prec in chain_tiers:  # the chain bodies at the fp64 path's tile and ragged
            task_product_case(dev, tag, op, NB_TASK64, NB_TASK64, NB_TASK64, dtype, prec, 50)
            task_product_case(dev, tag, op, 200, 96, 72, dtype, prec, 20)
            if op == "syrk":
                task_product_case(dev, tag, op, 200, 200, 72, dtype, prec, 20)
        for dtype, prec in [(torch.float32, p) for p in ("high", "highest", "default")] + [
                (torch.float64, "high")]:
            r = task_product_case(dev, tag, op, M_TASK_BIG, N_TASK_BIG, N_TASK_BIG,
                                  dtype, prec, 5)
            if (dtype, prec) == (torch.float32, TASK_PREC):
                # syrk's library_ms stays None (no one call masks its triangle); its
                # yardstick, addmm on the full square, beside it
                rows[op]["big"] = {k: r[k] for k in ("ms", "library_ms", "bound_ms",
                                                     "addmm_square_ms") if k in r}
    torch.cuda.empty_cache()
    return rows


# ---- 25. the tile-task path -----------------------------------------------------------
TASK_COUNTERS = {"POTRF": "potrf_tile_launches", "TRSM": "trsm_tile_launches",
                 "SYRK": "syrk_tile_launches", "GEMM": "gemm_tile_launches"}


def tile_task_potrf(a, nb, scalar=False):
    """The reference's task DAG, one kernel launch per task, in the order of
    ``client_distrib.cpp:506-565``: for each k, POTRF(k,k), then TRSM(i,k),
    SYRK(i,i) and GEMM(i,j,k) for i > j > k. The tiles of ``a`` (views, found
    through ``TileLayout``) are read; the factor is assembled in a new
    matrix, zero above the diagonal tiles. ``scalar`` runs TRSM, SYRK and
    GEMM through the scalar body (``tiles.tile_op_reference``, uncounted)
    instead of the task kernels' own body."""
    from dla_tpu_torch import TileLayout
    from dla_tpu_torch.kernels import tiles
    from dla_tpu_torch.kernels.tiles import potrf_tile

    if scalar:
        def trsm_tile(linv, b):
            return tiles.tile_op_reference("trsm", None, b, linv)

        def syrk_tile(c, a):
            return tiles.tile_op_reference("syrk", c, a, a)

        def gemm_tile(c, ai, aj):
            return tiles.tile_op_reference("gemm", c, ai, aj)
    else:
        trsm_tile, syrk_tile, gemm_tile = tiles.trsm_tile, tiles.syrk_tile, tiles.gemm_tile

    lay = TileLayout(mb=nb, nb=nb, lm=a.shape[0], ln=a.shape[1])
    nt = lay.nt

    def view(m, i, j):
        (r0, c0), (h, w) = lay.tile_origin(i, j), lay.tile_shape(i, j)
        return m[r0 : r0 + h, c0 : c0 + w]

    t = {(i, j): view(a, i, j) for i in range(nt) for j in range(i + 1)}
    out = torch.zeros_like(a)
    for k in range(nt):
        lkk, linv = potrf_tile(t.pop((k, k)))
        view(out, k, k).copy_(lkk)
        for i in range(k + 1, nt):
            t[i, k] = trsm_tile(linv, t[i, k])
        for i in range(k + 1, nt):
            t[i, i] = syrk_tile(t[i, i], t[i, k])
        for i in range(k + 1, nt):
            for j in range(k + 1, i):
                t[i, j] = gemm_tile(t[i, j], t[i, k], t[j, k])
        for i in range(k + 1, nt):
            view(out, i, k).copy_(t.pop((i, k)))
    return out


def phase_task_path(dev, tag, main_median):
    import dla_tpu_torch as T
    from dla_tpu_torch.cli.session import dag_counts
    from dla_tpu_torch.kernels import tiles
    from dla_tpu_torch.utils import precision

    n, nb = N_TASK, NB_TASK
    want = dag_counts(n // nb)
    for attr in TASK_COUNTERS.values():
        setattr(tiles, attr, 0)
    times = []
    reps = 3  # repeat 0 is the warm-up
    for rep in range(reps):
        l = None
        a = T.plgsy(n, seed=51, device=dev)
        sync()
        before = {k: getattr(tiles, v) for k, v in TASK_COUNTERS.items()}
        t0 = time.perf_counter()
        with precision.override(TASK_PREC):
            l = tile_task_potrf(a, nb)
        sync()
        dt = time.perf_counter() - t0
        got = {k: getattr(tiles, v) - before[k] for k, v in TASK_COUNTERS.items()}
        require(got == {k: want[k] for k in TASK_COUNTERS},
                f"tile-task path launched {got}, the DAG has {want}")
        print(f"tile-task path N={n} NB={nb} fp32 {TASK_PREC}: repeat {rep} {dt * 1e3:.1f} ms "
              f"{n**3 / 3 / dt / 1e9:.2f} GFLOP/s{' (warm-up)' if rep == 0 else ''} {tag}",
              flush=True)
        if rep:
            times.append(dt)
    counts = {k: getattr(tiles, v) for k, v in TASK_COUNTERS.items()}
    require(sum(counts.values()) == reps * want["total"], f"tile-task launch counts {counts}")
    tmed = statistics.median(times)
    beside = ("not run" if main_median is None else
              f"{main_median * 1e3:.1f} ms, {n**3 / 3 / main_median / 1e9:.2f} GFLOP/s")
    print(f"tile-task path N={n} NB={nb}: median {tmed * 1e3:.1f} ms, "
          f"{n**3 / 3 / tmed / 1e9:.2f} GFLOP/s, {want['total']} launches per factorization "
          f"({want['POTRF']} POTRF + {want['TRSM']} TRSM + {want['SYRK']} SYRK + "
          f"{want['GEMM']} GEMM), {tmed / want['total'] * 1e6:.1f} us per launch; potrf_inplace "
          f"on the same matrix (phase 3): {beside} {tag}", flush=True)
    dense_residual(f"tile-task path N={n} NB={nb} fp32 {TASK_PREC}", a, l, n, ms=tmed * 1e3)
    del a, l
    torch.cuda.empty_cache()
    n64, nb64 = N_TASK64, NB_TASK64
    a64 = T.plgsy(n64, seed=7, dtype=torch.float64, device=dev)
    before = sum(getattr(tiles, v) for v in TASK_COUNTERS.values())
    bodies = tiles.tile_body_launches()
    l64 = tile_task_potrf(a64, nb64)
    sync()
    want64 = dag_counts(n64 // nb64)
    require(sum(getattr(tiles, v) for v in TASK_COUNTERS.values()) - before
            == want64["total"], "fp64 tile-task launch count")
    ran = {x: v - bodies[x] for x, v in tiles.tile_body_launches().items()}
    require(ran == {"scalar": 0, "wgmma": 0, "simt": 0,
                    "dmma": want64["TRSM"] + want64["SYRK"] + want64["GEMM"]},
            f"fp64 tile-task bodies {ran}: TRSM, SYRK and GEMM on dmma expected")
    l64s = tile_task_potrf(a64, nb64, scalar=True)
    sync()
    same = torch.equal(bits(l64), bits(l64s))
    took = {False: [], True: []}  # after the warm-up above, in turns
    for scalar in (False, True, True, False):
        t0 = time.perf_counter()
        tile_task_potrf(a64, nb64, scalar=scalar)
        sync()
        took[scalar].append((time.perf_counter() - t0) * 1e3)
    r64 = float(T.residual_potrf(a64, l64))
    print(f"tile-task path N={n64} NB={nb64} fp64 ({ran} launches a factorization): "
          f"{took[False][0]:.1f} / {took[False][1]:.1f} ms, with TRSM, SYRK and GEMM on the "
          f"scalar body {took[True][0]:.1f} / {took[True][1]:.1f} ms, the same factor bit for bit: "
          f"{same}; residual {r64:.3e} (gate 1e-10) {tag}", flush=True)
    require(same, "the fp64 tile-task factor differs from the scalar body's")
    require(r64 < 1e-10, "tile-task fp64 residual above the reference's 1e-10 gate")
    return counts


# ---- 26. freivalds_device -----------------------------------------------------------------
def phase_freivalds_device(dev, tag):
    """The matrix-free gate beside the exact residual on the main path's
    factor, and on the same factor with one corrupted tile."""
    import dla_tpu_torch as T
    import dla_tpu_torch.algos as TA
    from dla_tpu_torch.validate import freivalds_device

    n = N_MAIN
    chunk = next(c for c in (4096, 2048, 1024, 512, 256, 128) if n % c == 0)
    l = TA.potrf_inplace(T.plgsy(n, seed=51, device=dev), **MAIN_KW)
    sync()
    t0 = time.perf_counter()
    fre = float(freivalds_device(l, seed=51, row_chunk=chunk))
    sync()
    t_fre = time.perf_counter() - t0
    res = float(T.residual_potrf(T.plgsy(n, seed=51, device=dev), torch.tril(l),
                                 assume_symmetric=True, assume_tril=True, row_chunk=chunk))
    gate = n * 2e-7
    bad = l.clone()
    h, t = n // 2, min(512, n // 4)
    bad[h : h + t, h : h + t] *= 1.5  # one corrupted diagonal tile
    fre_bad = float(freivalds_device(bad, seed=51, row_chunk=chunk))
    print(f"freivalds_device N={n}: ||(A - LL^T)x|| / (||A|| ||x||) = {fre:.3e} in "
          f"{t_fre * 1e3:.1f} ms, ||A - LL^T||_inf / ||A||_inf = {res:.3e} (gate {gate:g}); "
          f"one corrupted tile reads {fre_bad:.3e} {tag}", flush=True)
    require(fre < gate and res < gate, "a good factor fails a gate")
    require(fre_bad > 10 * gate, "freivalds_device passes a corrupted factor")
    del l, bad
    torch.cuda.empty_cache()


# ---- 27. the bench ------------------------------------------------------------------------
def phase_bench(tag, tiers, env):
    """``python -m dla_tpu_torch.bench.bench`` as a process of its own: one
    JSON line per tier as it finishes, every gate passed, exit code 0."""
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "dla_tpu_torch.bench.bench"], cwd=root, text=True,
        capture_output=True, timeout=900,
        env={**os.environ, **env, "BENCH_PRECISIONS": tiers,
             "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")})
    for line in proc.stderr.splitlines()[-40:]:
        print(f"bench (stderr)| {line}")
    for line in proc.stdout.splitlines():
        print(f"bench| {line}")
    print(f"bench numbers above: {tag}", flush=True)
    require(proc.returncode == 0, f"the bench exited with {proc.returncode}")
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    want = len(tiers.split(","))
    require(len(lines) == want + 1 and all("tier" in x for x in lines[:-1]),
            "the bench did not print one line per tier and the closing line")
    require(all(x.get("passed") is True for x in lines[:-1]), "a bench tier failed its gate")
    require({"metric", "value", "unit", "vs_baseline", "residual", "gflops_raw", "tiers",
             "config"} == set(lines[-1]), "the bench's closing line has other keys")
    return lines


# ---- 29. the ring collectives against their plain versions -------------------------------
def ring_case(dev, tag, kind, m, n, ndev, iters, **kw):
    """One ring collective on ``ndev`` members at (m, n) fp64 against its plain
    version on the same inputs (bits), with kernel, plain and library times
    and the bound: bytes, (1 + D)·V for the broadcast (the root's block read,
    D outputs written), D·V + D·group·V for the all-gather."""
    from dla_tpu_torch.kernels import collectives as C

    g = torch.Generator(device=dev).manual_seed(m + n + ndev)
    xs = [torch.randn(m, n, generator=g, device=dev, dtype=torch.float64) for _ in range(ndev)]
    group = kw.get("group") or ndev
    if kind == "broadcast":
        kernel, plain = C.ring_broadcast, C.ring_broadcast_plain
        kw = dict(kw)
        root = kw.pop("root")
        for d in range(ndev):  # a non-root block is never read: NaN reaches no output
            if d % group != root % group:
                xs[d].fill_(float("nan"))
        args, counter = (xs, root), "ring_broadcast_launches"
        library = lambda: xs[root % group].expand(ndev, m, n).clone()  # noqa: E731
        nbytes = (1 + ndev) * m * n * 8
    else:
        kernel, plain = C.ring_all_gather, C.ring_all_gather_plain
        args, counter = (xs,), "ring_all_gather_launches"
        library = lambda: [torch.cat(xs[d - d % group : d - d % group + group])  # noqa: E731
                           for d in range(ndev)]
        nbytes = (1 + group) * ndev * m * n * 8
    ref = plain(*args, **kw)
    before = getattr(C, counter)
    out = kernel(*args, **kw)
    sync()
    require(getattr(C, counter) == before + 1, f"ring {kind}: not one launch")
    require(all(torch.equal(bits(o), bits(r)) for o, r in zip(out, ref)),
            f"ring {kind} at {m}x{n}: the kernel's bits are not the plain version's")
    require(not any(bool(o.isnan().any()) for o in out), f"ring {kind}: NaN in an output")
    err = max((o - r).abs().max().item() for o, r in zip(out, ref))
    fns = {"ms": lambda: kernel(*args, **kw), "plain_ms": lambda: plain(*args, **kw),
           "library_ms": library}
    row = dict(max_abs_err=err, **{k: cuda_ms(fn, iters) for k, fn in fns.items()},
               queued={k: queued_ms(fn, iters) for k, fn in fns.items()}, **bound(0.0, nbytes))
    q = row["queued"]
    label = f"group={group}" + (f" root={root}" if kind == "broadcast" else "")
    chunks = C.broadcast_chunks(m, group) if kind == "broadcast" else 1
    plan = C.ring_plan(gather=kind != "broadcast", ndev=ndev, group=group, chunks=chunks,
                       block_bytes=m * n * 8,
                       sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"ring_{kind} D={ndev} {m}x{n} fp64 {label} chunks={chunks} {plan}: bits of the "
          f"plain version, back to back: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
          f"ms, library {row['library_ms']:.4f} ms; queued: kernel {q['ms']:.4f} ms, plain "
          f"{q['plain_ms']:.4f} ms, library {q['library_ms']:.4f} ms; "
          f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}) {tag}", flush=True)
    return row


def phase_ring_kernels(dev, tag):
    """#11 at the planes' shapes and in sub-rings, #12 at the factor tile;
    then the P×Q row-broadcast check (tests/test_parallel.py:219-249) with
    the all-gather count set to 0 before it and read after it."""
    from dla_tpu_torch.kernels import collectives as C

    d, t, big = D_RING, M_RING_TILE, N_RING - NB_RING
    rows = {"ring_bcast": ring_case(dev, tag, "broadcast", big, NB_RING, d, 10, root=1)}
    ring_case(dev, tag, "broadcast", t, NB_RING, d, 20, root=1)
    for root in (0, 1):
        ring_case(dev, tag, "broadcast", t, NB_RING, d, 20, root=root, group=2)
    rows["ring_gather"] = ring_case(dev, tag, "gather", t, NB_RING, d, 20)
    ring_case(dev, tag, "gather", t, NB_RING, d, 20, group=2)
    pg, qg = D_RING // 2, 2
    g = torch.Generator(device=dev).manual_seed(7)
    xs = [torch.randn(4, 6, generator=g, device=dev, dtype=torch.float64) for _ in range(pg * qg)]
    C.ring_all_gather_launches = 0
    out = C.ring_all_gather(xs, group=qg)
    sync()
    rows["ring_gather_launches"] = C.ring_all_gather_launches
    for r in range(pg):
        want = torch.cat(xs[r * qg : (r + 1) * qg])
        require(all(torch.equal(bits(out[r * qg + c]), bits(want)) for c in range(qg)),
                "ring_all_gather: a row of the P×Q grid did not gather its own blocks")
    print(f"ring_all_gather P×Q {pg}x{qg} row broadcast on the flat mesh: every row gathers "
          f"its own blocks, {rows['ring_gather_launches']} launch {tag}", flush=True)
    torch.cuda.empty_cache()
    return rows


# ---- 30. to 32. the flat-mesh ring planes ---------------------------------------------------
RING_PLANES = {  # phase: (name, kind in dla_tpu_torch.parallel.dryrun)
    30: ("column-cyclic fp64", "column"),
    31: ("packed-cyclic fp64", "packed"),
    32: ("packed-cyclic df64", "df64"),
}


@contextlib.contextmanager
def timed_ring():
    """Record CUDA events around each ``ring_broadcast`` call of the planes
    (all go through ``parallel/column_cyclic.py``)."""
    from dla_tpu_torch.parallel import column_cyclic as mod

    real, events = mod.ring_broadcast, []

    def timed(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    mod.ring_broadcast = timed
    try:
        yield events
    finally:
        mod.ring_broadcast = real


def phase_ring_plane(dev, tag, phase):
    """One ring plane at N_RING: a warm-up and RING_REPS timed factorizations,
    2·nt − 1 ring launches each (the count set to 0 before the plane and read
    after it), the time inside the ring, the residual under 1e-10."""
    import dla_tpu_torch as T
    from dla_tpu_torch.kernels import collectives as C
    from dla_tpu_torch.parallel import dryrun, make_flat_mesh

    name, kind = RING_PLANES[phase]
    n, nb = N_RING, NB_RING
    per_fact = 2 * (n // nb) - 1
    p = dryrun.plane(kind, n, nb, make_flat_mesh(D_RING, device=dev))
    times, ring_ms = [], []
    C.ring_broadcast_launches = 0
    with timed_ring() as events:
        for rep in range(1 + RING_REPS):  # repeat 0 is the warm-up
            x = p.shard(p.matrix())
            sync()
            before, events[:] = C.ring_broadcast_launches, []
            t0 = time.perf_counter()
            lx = p.factor(x)
            sync()
            dt = time.perf_counter() - t0
            got = C.ring_broadcast_launches - before
            require(got == per_fact, f"{name}: {got} ring launches in one factorization, "
                    f"expected {per_fact}")
            r_ms = sum(s.elapsed_time(e) for s, e in events)
            print(f"ring plane {name} N={n} NB={nb} D={D_RING}: repeat {rep} {dt * 1e3:.1f} ms "
                  f"{n**3 / 3 / dt / 1e9:.2f} GFLOP/s, {r_ms:.3f} ms in {got} ring_broadcast "
                  f"launches{' (warm-up)' if rep == 0 else ''} {tag}", flush=True)
            if rep:
                times.append(dt)
                ring_ms.append(r_ms)
    launches = C.ring_broadcast_launches
    require(launches == (1 + RING_REPS) * per_fact, f"{name}: ring launch count {launches}")
    l = p.dense(lx)
    del x, lx
    require(bool(torch.isfinite(l).all()), f"{name}: the factor has non-finite entries")
    res = float(T.residual_potrf(p.matrix(), l, assume_symmetric=True))
    tmed, rmed = statistics.median(times), statistics.median(ring_ms)
    print(f"ring plane {name} N={n} NB={nb} D={D_RING}: median {tmed * 1e3:.1f} ms, "
          f"{n**3 / 3 / tmed / 1e9:.2f} GFLOP/s, ring {rmed:.3f} ms "
          f"({100 * rmed / (tmed * 1e3):.2f}%), {per_fact} ring launches per factorization, "
          f"residual {res:.3e} (gate 1e-10) {tag}", flush=True)
    require(res < 1e-10, f"{name}: residual above the reference's 1e-10 gate")
    del l
    torch.cuda.empty_cache()
    return launches


# ---- 33. the dense solve and serving path -----------------------------------------------
#: the fp32 solves' largest relative difference from the fp64 solve on the same factor
#: (max norm): about 840 fp32 ulps (2^-23), a tenth of one TF32 ulp (2^-10)
FWD_TOL = 1e-4


def timed_call(fn):
    """fn() and its wall time between two synchronizations."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def phase_solve(dev, tag):
    import dla_tpu_torch as T
    import dla_tpu_torch.algos as TA
    from dla_tpu_torch.kernels import tiles
    from dla_tpu_torch.validate import residual_posv

    n, nrhs = N_MAIN, NRHS_SOLVE
    a = T.plgsy(n, seed=51, device=dev)
    tiles.launches = 0
    l, dt = timed_call(lambda: TA.potrf_inplace(a.clone(), **MAIN_KW))
    launches = tiles.launches
    require(launches == n // NB_MAIN - 1,
            f"the solve path's factor launched #1 {launches} times")
    g = torch.Generator(device=dev).manual_seed(nrhs)
    b = torch.randn(n, nrhs, generator=g, device=dev)
    gate = n * 2e-6  # the driver's fp32 potrs / inverse gate
    print(f"solve path N={n} fp32 high: potrf_inplace {dt * 1e3:.1f} ms, #1 launched "
          f"{launches} times {tag}", flush=True)
    # The driver's gate mirrors the reference's and is loose; an fp64 solve on the same
    # factor holds the fp32 solves to their own precision: a solve with TF32 (2^-11) or
    # bf16 (2^-8) products would be off from it by more than FWD_TOL.
    x64 = torch.cholesky_solve(b.double(), torch.tril(l).double())

    def forward(x):
        return ((x.double() - x64).abs().max() / x64.abs().max()).item()

    T.potrs(l, b[:, :1])  # warm-up of the solve's kernels and allocations
    x, dt = timed_call(lambda: T.potrs(l, b))
    res, fwd = float(residual_posv(a, b, x)), forward(x)
    print(f"solve path potrs nrhs={nrhs}: {dt * 1e3:.1f} ms, ||B - A X||_inf / (||A||_inf "
          f"||X||_inf) = {res:.3e} (gate {gate:g}), max|X - X64| / max|X64| = {fwd:.3e} "
          f"(X64 the fp64 solve on the same factor; limit {FWD_TOL:g}) {tag}", flush=True)
    require(res < gate, "potrs residual above the driver's fp32 gate")
    require(fwd < FWD_TOL, "potrs is off the fp64 solve on its factor by more than fp32 allows")
    ainv, dt_inv = timed_call(lambda: T.potri(l))
    x, dt = timed_call(lambda: T.solve_inverse(ainv, b))
    res, fwd = float(residual_posv(a, b, x)), forward(x)
    print(f"solve path potri {dt_inv * 1e3:.1f} ms, then solve_inverse nrhs={nrhs} "
          f"{dt * 1e3:.3f} ms, ||B - A X||_inf / (||A||_inf ||X||_inf) = {res:.3e} "
          f"(gate {gate:g}), max|X - X64| / max|X64| = {fwd:.3e} (limit {FWD_TOL:g}) {tag}",
          flush=True)
    require(res < gate, "potri + solve_inverse residual above the driver's fp32 gate")
    require(fwd < FWD_TOL,
            "potri + solve_inverse is off the fp64 solve on its factor by more than fp32 allows")
    del ainv, l, x, x64
    torch.cuda.empty_cache()
    a64 = torch.tril(a).double()
    (x, err, used), dt = timed_call(lambda: TA.posv_refined_host(a64, b.double(), nb=NB_MAIN,
                                                                        device=dev))
    res = float(residual_posv(a, b, x))
    print(f"solve path posv_refined_host nrhs={nrhs}: {dt * 1e3:.1f} ms, {used} iterations, "
          f"backward error {err:.3e}, ||B - A X||_inf / (||A||_inf ||X||_inf) = {res:.3e} "
          f"(gate 1e-10) {tag}", flush=True)
    require(res < 1e-10 and err < 1e-10, "posv_refined_host above the 1e-10 gate")
    del a, a64, x
    torch.cuda.empty_cache()
    out = phase_driver(tag, ["--n", str(n), "--nb", str(NB_MAIN), "--dtype", "s", "--mode",
                             "inplace", "--solve", "refined", "--nrhs", str(nrhs),
                             "--repeats", "1"])
    require("SOLVE PASS" in out, "the driver's refined solve did not pass")
    require("A regenerated in fp64 by the native host generator" in out,
            "the driver's refined solve did not take A from the native host generator")
    n64 = N_REFINED64
    a = T.plgsy(n64, seed=51, dtype=torch.float64, device=dev)
    b = torch.randn(n64, nrhs, generator=g, device=dev, dtype=torch.float64)
    (_, x, rmax), dt = timed_call(lambda: TA.posv_refined(a, b))
    res = float(residual_posv(a, b, x))
    print(f"solve path fp64 posv_refined N={n64} nrhs={nrhs}: {dt * 1e3:.1f} ms, max|B - A X| "
          f"{float(rmax):.3e}, ||B - A X||_inf / (||A||_inf ||X||_inf) = {res:.3e} "
          f"(gate 1e-10) {tag}", flush=True)
    require(res < 1e-10, "fp64 posv_refined above the 1e-10 gate")
    del a, b, x
    torch.cuda.empty_cache()
    return launches


# ---- 34. the packed serving path -----------------------------------------------------
def phase_packed_serving(tag):
    """The driver's ``--mode packed --solve inverse`` and ``--solve potrs``,
    each with the peak device memory of its call beside the packed
    triangle's bytes."""
    from dla_tpu_torch.algos.packed import packed_len

    n, nb = N_PACKED_SOLVE, NB_PACKED_SOLVE
    tri = packed_len(n, nb) * 4
    for solve in ("inverse", "potrs", "refined"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = phase_driver(tag, ["--n", str(n), "--nb", str(nb), "--dtype", "s", "--mode",
                                 "packed", "--trailing", "pallas", "--solve", solve, "--nrhs",
                                 str(NRHS_SOLVE), "--repeats", "1"])
        peak = torch.cuda.max_memory_allocated()
        print(f"packed serving N={n} nb={nb} --solve {solve} nrhs={NRHS_SOLVE}: peak device "
              f"memory {peak / 2**30:.3f} GiB, the packed triangle {tri / 2**30:.3f} GiB "
              f"({peak / tri:.2f}x) {tag}", flush=True)
        require("SOLVE PASS" in out, f"the driver's packed --solve {solve} did not pass")
        if solve == "refined":
            its = re.search(r"refined solve: (\d+) iterations, (\S+) ms", out)
            res = re.search(r"^\|\|B - A X\|\|_inf / \(\|\|A\|\|_inf \|\|X\|\|_inf\) = (\S+)$",
                            out, re.M)
            require(its is not None and res is not None and float(res.group(1)) < 1e-10,
                    "the packed refined solve's lines are missing or above 1e-10")
            print(f"packed serving N={n} nb={nb} --solve refined nrhs={NRHS_SOLVE}: "
                  f"{its.group(1)} iterations, {its.group(2)} ms, ||B - A X||_inf / (||A||_inf "
                  f"||X||_inf) = {res.group(1)} (gate 1e-10; potrs_packed corrections on the "
                  f"card, fp64 residuals streamed from the native host generator) {tag}",
                  flush=True)
    torch.cuda.empty_cache()


# ---- 35. the out-of-core path ------------------------------------------------------------
def host_room(path: str) -> tuple[int, int]:
    """(host memory available, free disk under ``path``) in bytes."""
    with open("/proc/meminfo") as f:
        mem = {line.split(":")[0]: int(line.split()[1]) * 1024 for line in f}
    return mem["MemAvailable"], shutil.disk_usage(path).free


def oocore_need(n: int, w: int) -> tuple[int, int]:
    """Host memory and disk the fp32 panel-store run at N=n needs: on disk the
    triangle of panels and one scratch panel; in memory the write-through cache of the
    triangle, the pinned readback panel, the staging pool (up to five panels), the fp64
    work panel of the streaming Freivalds check (two panels' bytes) and 4 GiB for the
    rest of the process."""
    tri, panel = n * (n + w) // 2 * 4, n * w * 4
    return tri + 8 * panel + (4 << 30), tri + panel


def oocore_run(tag, argv):
    """``python -m dla_tpu_torch.cli.oocore_driver`` in this process; its output."""
    from dla_tpu_torch.cli import oocore_driver

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = oocore_driver.main([str(a) for a in argv])
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"oocore| {line}")
    print(f"oocore driver numbers above: {tag}", flush=True)
    require(rc == 0 and re.search(r"^PASS ", out, re.M) is not None,
            f"the out-of-core driver returned {rc} without PASS")
    return out


def oocore_report(out: str, n: int, peak: int, tag: str) -> None:
    """One line: wall time, GFLOP/s, every stats field, peak device memory, the
    Freivalds value against its gate."""
    ms = float(re.search(r"^Elapsed: (\S+) ms$", out, re.M).group(1))
    stats = json.loads(re.search(r"^\[oocore\] stats: (.*)$", out, re.M).group(1))
    fv = re.search(r"^freivalds .* = (\S+) \((\S+)s\)$", out, re.M)
    gate = re.search(r"^PASS \(gate (\S+)\)$", out, re.M).group(1)
    print(f"out-of-core N={n}: factorization {ms / 1e3:.3f} s, "
          f"{n ** 3 / 3 / (ms / 1e3) / 1e9:.1f} GFLOP/s, stats {json.dumps(stats)}, "
          f"h2d {stats['bytes_in'] / 2**30:.1f} GiB, peak device memory "
          f"{peak / 2**30:.3f} GiB, freivalds {fv.group(1)} (gate {gate}, {fv.group(2)} s) "
          f"{tag}", flush=True)


class Crash(Exception):
    pass


def phase_oocore(tag):
    """The driver at the JAX package's record size, fp32 out of core on a panel store
    with its RAM cache; fp64 on a flat RAM store under 1e-10; a kill-and-resume."""
    import tempfile

    import numpy as np

    from dla_tpu_torch.algos.oocore import potrf_outofcore
    from dla_tpu_torch.runtime.staging import DirectPanelStore

    with tempfile.TemporaryDirectory(prefix="dla_oocore_") as tmp:
        ram, disk = host_room(tmp)
        n = N_OOC
        need = oocore_need(n, W_OOC)
        print(f"out-of-core host: {ram / 2**30:.1f} GiB memory available, "
              f"{disk / 2**30:.1f} GiB free disk under {tmp}, {os.cpu_count()} cores; N={n} "
              f"needs {need[0] / 2**30:.1f} GiB memory, {need[1] / 2**30:.1f} GiB disk {tag}",
              flush=True)
        if ram < need[0] or disk < need[1]:
            n = N_OOC_CUT
            need = oocore_need(n, W_OOC)
            print(f"out-of-core CUT: N={N_OOC} does not fit this host; N={n}", flush=True)
            require(ram >= need[0] and disk >= need[1],
                    f"the out-of-core phase needs {need[0]} B of memory and {need[1]} B of disk "
                    f"even at N={n}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = oocore_run(tag, ["--n", n, "--panel", W_OOC, "--nb", NB_OOC, "--store", "panel",
                               "--matrix", os.path.join(tmp, "a.bin"), "--ram-cache",
                               "--probes", "2"])
        oocore_report(out, n, torch.cuda.max_memory_allocated(), tag)

    n = N_OOC64
    torch.cuda.reset_peak_memory_stats()
    out = oocore_run(tag, ["--n", n, "--panel", W_OOC, "--nb", NB_OOC, "--dtype", "float64",
                           "--probes", "2"])
    require("PASS (gate 1e-10)" in out, "the fp64 out-of-core run did not pass 1e-10")
    oocore_report(out, n, torch.cuda.max_memory_allocated(), tag)

    # kill and resume: crash after panel 2, resume in a fresh store, same bits
    def factor_of(st):
        out = np.zeros((n, n), np.float32)
        for j in range(st.npan):
            b = st.pack(j * W_OOC, j * W_OOC, n - j * W_OOC, W_OOC)
            out[j * W_OOC :, j * W_OOC : (j + 1) * W_OOC] = b
            st.release(b)
        return np.tril(out)

    def crash_after_two(j, npan):
        if j == 1:
            raise Crash

    with tempfile.TemporaryDirectory(prefix="dla_oocore_") as tmp:
        whole_path, path = os.path.join(tmp, "whole.bin"), os.path.join(tmp, "resumed.bin")
        prog = os.path.join(tmp, "progress.json")
        with DirectPanelStore(n, np.float32, path=whole_path, panel=W_OOC) as st:
            st.fill_plgsy(seed=51)
            potrf_outofcore(st, panel=W_OOC, nb=NB_OOC)
            whole = factor_of(st)
        with DirectPanelStore(n, np.float32, path=path, panel=W_OOC) as st:
            st.fill_plgsy(seed=51)
            try:
                potrf_outofcore(st, panel=W_OOC, nb=NB_OOC, progress_path=prog,
                                on_panel=crash_after_two)
                require(False, "the crash after panel 2 did not happen")
            except Crash:
                pass
        with DirectPanelStore(n, np.float32, path=path, panel=W_OOC, ram_cache=True) as st:
            stats = potrf_outofcore(st, panel=W_OOC, nb=NB_OOC, progress_path=prog)
            resumed = factor_of(st)
    same = bool(np.array_equal(resumed, whole))
    print(f"out-of-core kill-and-resume N={n} fp32: crashed after panel 2 of {n // W_OOC}, "
          f"resumed {stats['panels']} panels in a fresh store, the same bits as an "
          f"uninterrupted run: {same} {tag}", flush=True)
    require(stats["panels"] == n // W_OOC - 2 and same,
            "the resumed out-of-core factor is not the uninterrupted run's")


# ---- 36. the block-cyclic plane on member meshes ------------------------------------------
def peak_gib() -> str:
    return f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"


def fresh_peak() -> None:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def number(out: str, pattern: str) -> float:
    """The number a line of ``out`` gives after ``pattern`` (a regex)."""
    m = re.search(pattern + r" *(\S+)", out, re.M)
    require(m is not None, f"no line matching {pattern!r}")
    return float(m.group(1).rstrip(","))


def phase_session(tag):
    """The session CLI in this process, its wave lines counted, not printed;
    first a small session, unprinted, so that the timed factorization does
    not carry the libraries' first-call set-up when phase 36 runs alone."""
    from dla_tpu_torch.cli import session

    n, nb = N_BC, NB_BC
    argv = ["--B", str(nb), "--p", str(P_BC), "--q", str(Q_BC), "--dtype", "d",
            "--solve", str(NRHS_BC)]
    with contextlib.redirect_stdout(io.StringIO()):
        require(session.main(["--N", str(nb * P_BC * Q_BC)] + argv) == 0,
                "the warm-up session failed")
    fresh_peak()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = session.main(["--N", str(n)] + argv)
    out = buf.getvalue()
    waves = 0
    for line in out.splitlines():
        if line.startswith("[CLIENT] wave k="):
            waves += 1
        else:
            print(f"session| {line}")
    ms = number(out, r"^Elapsed:")
    res = number(out, r"^\|\|A - LL\^T\|\|_inf / \|\|A\|\|_inf =")
    sres = number(out, r"^\|\|B - A X\|\|_inf / \(\|\|A\|\|_inf \|\|X\|\|_inf\) =")
    solve_ms = number(out, r"^\[CLIENT\] solve elapsed:")
    print(f"block-cyclic session N={n} nb={nb} {P_BC}x{Q_BC} fp64 ({waves} wave lines): "
          f"factorization {ms:.1f} ms, {n ** 3 / 3 / (ms / 1e3) / 1e9:.1f} GFLOP/s, residual "
          f"{res:.3e} (gate 1e-10), potrs nrhs={NRHS_BC} {solve_ms:.1f} ms, residual {sres:.3e} "
          f"(gate 1e-10), peak device memory {peak_gib()} (A alone "
          f"{n * n * 8 / 2**30:.3f} GiB) {tag}", flush=True)
    require(rc == 0 and "[CLIENT] session complete: PASS" in out and waves == n // nb,
            f"the session returned {rc} without PASS")
    require(res < 1e-10 and sres < 1e-10, "the session's residuals are not below 1e-10")


def phase_block_cyclic(dev, tag):
    """potrf_block_cyclic at N_BC, nb=NB_BC_SUPER (auto: the super-stepped
    program) against the unrolled program on the same input."""
    from dla_tpu_torch import parallel as TP
    from dla_tpu_torch.ops import plgsy
    from dla_tpu_torch.validate import residual_potrf

    n, nb = N_BC, NB_BC_SUPER
    lay = TP.BlockCyclicLayout(n, nb, P_BC, Q_BC)
    mesh = TP.make_mesh(P_BC, Q_BC, device=dev)
    fresh_peak()
    ls = {}
    for name, kw in (("super-stepped", {}), ("unrolled", {"unroll": True})):
        x = TP.generate_spd_block_cyclic(lay, mesh, dtype=torch.float64)
        _, dt = timed_call(lambda: TP.potrf_block_cyclic(x, lay, mesh, **kw))
        ls[name] = TP.to_dense(x, lay).tril_()
        del x
        print(f"block-cyclic {name} N={n} nb={nb} {P_BC}x{Q_BC} fp64 ({lay.ntiles} steps"
              f"{'' if kw else f', super_steps {-(-lay.ntiles // 32)}'}): {dt * 1e3:.1f} ms, "
              f"{n ** 3 / 3 / dt / 1e9:.1f} GFLOP/s {tag}", flush=True)
    a, b = ls["super-stepped"], ls["unrolled"]
    excess = max(((a[r0 : r0 + 4096] - b[r0 : r0 + 4096]).abs()
                  - 1e-11 * b[r0 : r0 + 4096].abs()).max().item() for r0 in range(0, n, 4096))
    dmax = max((a[r0 : r0 + 4096] - b[r0 : r0 + 4096]).abs().max().item()
               for r0 in range(0, n, 4096))
    del b
    res = float(residual_potrf(plgsy(n, dtype=torch.float64, device=dev), a,
                               assume_symmetric=True, assume_tril=True, row_chunk=min(n, 4096)))
    print(f"block-cyclic N={n} nb={nb}: super-stepped against unrolled max|dL| {dmax:.3e}, "
          f"max(|dL| - 1e-11|L|) {excess:.3e} (limit 1e-11); residual {res:.3e} (gate 1e-10); "
          f"peak device memory {peak_gib()} {tag}", flush=True)
    require(excess <= 1e-11, "the super-stepped factor is off the unrolled one")
    require(res < 1e-10, "the super-stepped factor's residual is not below 1e-10")
    del a, ls
    torch.cuda.empty_cache()


def phase_distributed_drivers(tag):
    """The driver's --mode distributed, then the out-of-core driver on a 2x2 mesh."""
    fresh_peak()
    n, nb = N_BC_DRIVER, NB_BC_DRIVER
    out = phase_driver(tag, ["--n", str(n), "--nb", str(nb), "--dtype", "s", "--mode",
                             "distributed", "--p", "2", "--q", "2", "--repeats", "2"])
    ms = number(out, r"^Elapsed:")
    res = number(out, r"^(?:\|\|A - LL\^T\|\|_inf / \|\|A\|\|_inf|freivalds .*) =")
    print(f"driver --mode distributed N={n} nb={nb} 2x2 fp32: median {ms:.1f} ms, "
          f"{n ** 3 / 3 / (ms / 1e3) / 1e9:.1f} GFLOP/s, gate value {res:.3e} (gate "
          f"{n * 2e-7:g}), peak device memory {peak_gib()} {tag}", flush=True)
    fresh_peak()
    n = N_BC_OOC
    out = oocore_run(tag, ["--n", n, "--panel", W_OOC, "--nb", NB_OOC, "--p", 2, "--q", 2,
                           "--probes", 2])
    require("[oocore] distributed: panels sharded over a 2x2 mesh" in out,
            "the out-of-core driver did not take the mesh")
    oocore_report(out, n, torch.cuda.max_memory_allocated(), tag)
    torch.cuda.empty_cache()


# ---- 37. the driver's full flag surface, the session at z, oracle, harness, profiling ------
GATE_LINE = r"^(?:\|\|A - LL\^T\|\|_inf / \|\|A\|\|_inf|freivalds .*) ="
SOLVE_LINE = r"^\|\|B - A X\|\|_inf / \(\|\|A\|\|_inf \|\|X\|\|_inf\) ="


def flags_run(tag, label, argv, env=None, kernel=False, rc_want=0):
    """One driver run of phase 37: its time, gate value (and solve residual)
    and peak device memory on one line; ``kernel``: #1 must have launched."""
    from dla_tpu_torch.kernels import tiles

    fresh_peak()
    before = tiles.launches
    rc, out = driver_run(tag, argv, env)
    peak = torch.cuda.max_memory_allocated()
    require(rc == rc_want, f"{label}: the driver returned {rc}, not {rc_want}")
    if rc_want:
        return out, peak
    require("PASS" in out and "FAIL" not in out, f"{label}: no PASS")
    ms = number(out, r"^Elapsed:")
    gate = re.search(r"^PASS \(residual < (\S+)\)$", out, re.M).group(1)
    solve = (f", solve {number(out, SOLVE_LINE):.3e}" if re.search(SOLVE_LINE, out, re.M)
             else "")
    n = int(re.findall(r"N=(\d+)", out)[-1])  # a file's N comes in a later line
    launched = tiles.launches - before
    refined = re.search(r"refined solve: (\d+) iterations, (\S+) ms", out)
    if refined:
        solve += f" ({refined.group(1)} iterations, {refined.group(2)} ms)"
    print(f"phase 37 {label}: median {ms:.1f} ms, {n ** 3 / 3 / (ms / 1e3) / 1e9:.1f} "
          f"GFLOP/s, gate value {number(out, GATE_LINE):.3e} (gate {gate}){solve}, #1 "
          f"launches {launched} (warm-up and timed repeat), peak device memory "
          f"{peak / 2**30:.3f} GiB {tag}", flush=True)
    require(launched > 0 or not kernel, f"{label}: kernel #1 was not launched")
    return out, peak


def phase_driver_flags(tag):
    """The complex runs and the real flags that reach kernel #1."""
    import numpy as np

    n, nb = N_FLAGS, NB_FLAGS
    base = ["--n", n, "--nb", nb, "--repeats", 1]
    out, _ = flags_run(tag, f"--dtype z --mode blocked N={n}",
                    base + ["--dtype", "z", "--mode", "blocked"])
    plain_ms = number(out, r"^Elapsed:")
    out, _ = flags_run(tag, f"--dtype z --mode blocked N={n} DLA_TPU_C3M=1",
                    base + ["--dtype", "z", "--mode", "blocked"],
                    env={"DLA_TPU_C3M": "1"})
    print(f"phase 37 z blocked N={n}: 4M {plain_ms:.1f} ms, 3M "
          f"{number(out, r'^Elapsed:'):.1f} ms {tag}", flush=True)
    flags_run(tag, f"--dtype c --uplo U --mode shrink N={n}",
           base + ["--dtype", "c", "--uplo", "U", "--mode", "shrink"])
    # the solves through uplo U read A's upper triangle and L = Uᴴ: under 1e-10 at z
    flags_run(tag, f"--dtype z --uplo U --mode blocked --solve potrs N={N_CHECK_FAIL}",
           ["--n", N_CHECK_FAIL, "--nb", nb, "--repeats", 1, "--dtype", "z", "--uplo", "U",
            "--mode", "blocked", "--solve", "potrs", "--nrhs", NRHS_SOLVE])
    for solve in ("potrs", "inverse"):
        flags_run(tag, f"--dtype c --mode packed --nb {NB_FLAGS_PACKED} --solve {solve} N={n}",
               ["--n", n, "--nb", NB_FLAGS_PACKED, "--repeats", 1, "--dtype", "c", "--mode",
                "packed", "--solve", solve, "--nrhs", NRHS_SOLVE])
    view = base + ["--dtype", "s", "--mode", "inplace", "--lm", LM_VIEW, "--ioff", n, "--joff", n,
                   "--m", n]
    _, peak = flags_run(tag, f"--mode inplace view m={n} of lm={LM_VIEW}", view, kernel=True)
    # without the gate's fp64 copies of A and L: what generating the view and factoring it hold
    fresh_peak()
    rc, _ = driver_run(tag, view + ["--no-check"])
    bare = torch.cuda.max_memory_allocated()
    square = LM_VIEW * LM_VIEW * 4
    print(f"phase 37 view: peak device memory {peak / 2**30:.3f} GiB with the gate, "
          f"{bare / 2**30:.3f} GiB without it, against {square / 2**30:.1f} GiB for the "
          f"{LM_VIEW}^2 fp32 square {tag}", flush=True)
    require(rc == 0 and bare < square / 4,
            "the view's run held memory on the scale of the whole square")
    flags_run(tag, f"--gen gershgorin --mode inplace N={n}",
           base + ["--dtype", "s", "--mode", "inplace", "--gen", "gershgorin"], kernel=True)
    flags_run(tag, f"--uplo B --mode shrink --trailing pallas N={n}",
           base + ["--dtype", "s", "--uplo", "B", "--mode", "shrink", "--trailing", "pallas"],
           kernel=True)
    tmp = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"chip_smoke_input_{os.getpid()}.npy")
    from dla_tpu_torch.ops import plgsy

    np.save(tmp, plgsy(n, dtype=torch.float32, device="cuda").cpu().numpy())
    try:
        argv = ["--nb", nb, "--repeats", 1, "--dtype", "s", "--mode", "inplace", "--input", tmp]
        out, _ = flags_run(tag, "--input (.npy, N from the file) --mode inplace", argv)
        require(f"N={n} adopted from" in out, "N was not taken from the file")
        out, _ = flags_run(tag, "--input --mode inplace --solve refined",
                        argv + ["--solve", "refined", "--nrhs", NRHS_SOLVE])
        require("tril(A) widened to fp64" in out and number(out, SOLVE_LINE) < 1e-10,
                "the refined solve did not solve the file's tril(A) under 1e-10")
    finally:
        os.remove(tmp)
    flags_run(tag, f"--checked N={n}", base + ["--dtype", "s", "--mode", "inplace", "--checked"])
    out, _ = flags_run(tag, "--checked --bump 0.0001", ["--n", N_CHECK_FAIL, "--nb", nb, "--dtype",
                                                     "s", "--checked", "--bump", "0.0001"],
                    rc_want=3)
    require("CHECK FAILED: POTRF produced NaNs" in out, "--checked did not say CHECK FAILED")
    print(f"phase 37 --checked --bump 0.0001 N={N_CHECK_FAIL}: exit code 3, "
          f"{next(ln for ln in out.splitlines() if 'CHECK FAILED' in ln)} {tag}", flush=True)


def phase_tools(dev, tag):
    """The session at z, the oracle, a two-config sweep, the profiling helpers."""
    import tempfile

    from dla_tpu_torch.bench.harness import SweepConfig, run_sweep
    from dla_tpu_torch.cli import oracle, session

    n = N_SESSION_Z
    fresh_peak()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = session.main([str(a) for a in ("--N", n, "--B", NB_SESSION_Z, "--p", 2, "--q", 2,
                                            "--dtype", "z", "--solve", 16)])
    out = buf.getvalue()
    require(rc == 0 and "[CLIENT] session complete: PASS" in out, "the z session failed")
    print(f"phase 37 session --dtype z N={n} B={NB_SESSION_Z} 2x2: "
          f"{number(out, r'^Elapsed:'):.1f} ms, "
          f"residual {number(out, GATE_LINE):.3e}, solve {number(out, SOLVE_LINE):.3e} (gate "
          f"1e-10, complex128 as float64), peak device "
          f"memory {peak_gib()} {tag}", flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = oracle.main(["--n", str(n), "--cross-check"])
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"oracle| {line}")
    require(rc == 0 and "CROSS-CHECK PASS" in out, "the oracle's cross-check failed")
    print(f"oracle numbers above: {tag}", flush=True)
    with tempfile.TemporaryDirectory() as d:
        csv_path = os.path.join(d, "sweep.csv")
        t0 = time.perf_counter()
        rows = run_sweep(SweepConfig(ns=(N_FLAGS,), nbs=(NB_FLAGS,), dtypes=("float32",),
                                     modes=("inplace",), repeats=3, timeout_s=300),
                         csv_path, echo=False)
        rows += run_sweep(SweepConfig(ns=(N_FLAGS,), nbs=(NB_FLAGS_PACKED,), dtypes=("float32",),
                                      modes=("packed",), trailing="pallas",
                                      precision="default", repeats=3, timeout_s=300),
                          csv_path, echo=False)
        wall = time.perf_counter() - t0
    for r in rows:
        print(f"sweep| N={r['N']} NB={r['NB']} {r['mode']} {r['precision']} rep={r['run_idx']}: "
              f"{r['ms']} ms, {r['gflops']} GFLOP/s, rel_error {r['rel_error']}, exit code "
              f"{r['exit_code']} {tag}", flush=True)
    print(f"phase 37 sweep: {len(rows)} rows in {wall:.1f} s (two children) {tag}", flush=True)
    require(len(rows) == 6 and all(r["exit_code"] == 0 and r["rel_error"] != ""
                                   and float(r["rel_error"]) < N_FLAGS * 2e-7 for r in rows),
            "a sweep row failed or lacks a passing rel_error")
    import dla_tpu_torch.algos as TA
    from dla_tpu_torch.ops import plgsy
    from dla_tpu_torch.utils import profiling

    a0 = plgsy(N_FLAGS, dtype=torch.float32, device=dev)
    buf0 = torch.empty_like(a0)
    kw = dict(MAIN_KW)
    med, times = profiling.time_fn(lambda: TA.potrf_inplace(buf0.copy_(a0), **kw), iters=3)
    roof = profiling.Roofline("float32", precision=kw["precision"])
    e = roof.record("potrf_inplace", N_FLAGS ** 3 / 3, med)
    for line in roof.report().splitlines():
        print(f"roofline| {line}")
    print(f"phase 37 profiling: time_fn median {med * 1e3:.1f} ms of "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} (each with a {N_FLAGS}^2 copy), "
          f"{e.gflops:.1f} GFLOP/s, {e.peak_fraction:.2%} of the {roof.peak:.0f} GFLOP/s "
          f"peak at {kw['precision']} {tag}", flush=True)
    require(0 < e.peak_fraction < 1, "the roofline's peak fraction is not below 100%")
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            TA.potrf_inplace(buf0.copy_(a0), **kw)
            sync()
        size = os.path.getsize(os.path.join(d, "trace.json"))
    print(f"phase 37 trace: trace.json {size} bytes {tag}", flush=True)
    require(size > 0, "trace() wrote an empty trace")
    del a0, buf0
    torch.cuda.empty_cache()


# ---- 38. the distributed planes across a process boundary ---------------------------------
def mh_run(tag, planes: str, n: int, nb: int) -> list[str]:
    """The multihost demo as MH_PROCS processes of MH_MEMBERS members on this card
    (gloo), each plane compared with one process on process 0; each process's
    output, printed with its process index. Fails unless every process exits 0
    within MH_TIMEOUT seconds."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    argv = ["--coordinator", f"127.0.0.1:{port}", "--nproc", str(MH_PROCS), "--local-devices",
            str(MH_MEMBERS), "--n", str(n), "--nb", str(nb), "--p", "2", "--q", "4",
            "--plane", planes, "--device", "cuda", "--backend", "gloo", "--timeout",
            str(MH_TIMEOUT), "--compare"]
    procs = [subprocess.Popen([sys.executable, "-m", "dla_tpu_torch.parallel.multihost",
                               "--pid", str(pid)] + argv, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in range(MH_PROCS)]
    deadline, outs, rcs = time.monotonic() + MH_TIMEOUT, [], []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
                rcs.append(p.returncode)
            except subprocess.TimeoutExpired:
                rcs.append(None)
                outs.append("")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, out in enumerate(outs):
        for line in out.splitlines():
            if "socket.cpp" not in line:  # c10d's warnings about the client's host name
                print(f"mh{pid}| {line}")
    print(f"multihost numbers above: {tag}", flush=True)
    require(rcs == [0] * MH_PROCS, f"multihost processes exited {rcs} (None: killed at the "
            f"{MH_TIMEOUT} s timeout)")
    return outs


MH_LINE = (r"^\[mh {pid}\] plane {plane}: N=\d+ NB=\d+ over \d+ members, factor (\S+) ms, "
           r"\S+ GFLOP/s(?:, solve \(nrhs=3\) (\S+) ms)?; boundary (\d+) broadcasts, (\S+) MB, "
           r"(\S+) ms \((\S+)% of the plane\); ring_broadcast launches (\d+); assembly "
           r"(\d+) broadcasts, (\S+) MB, (\S+) ms; peak device memory (\S+) GiB$")


def mh_report(tag, outs: list[str], plane: str, n: int, nb: int) -> None:
    """One line for a plane: each process's time, boundary share, #11 launches and
    peak memory; the gate; one process's time and the largest difference."""
    ranks = []
    for pid, out in enumerate(outs):
        m = re.search(MH_LINE.format(pid=pid, plane=re.escape(plane)), out, re.M)
        require(m is not None, f"multihost process {pid} printed no line for plane {plane}")
        ranks.append(m.groups())
    gate = re.search(r"^\[mh 0\] .* = (\S+) (PASS|FAIL)$",
                     outs[0].split(f"[mh 0] plane {plane}:")[1], re.M)
    one = re.search(rf"^\[mh 0\] plane {re.escape(plane)} in one process on \d+ members: factor "
                    r"(\S+) ms(?:, solve (\S+) ms)?; max \|difference\| (\S+), the same bits: "
                    r"(True|False)$", outs[0], re.M)
    require(gate is not None and one is not None, f"multihost plane {plane}: no gate or one-"
            "process line")
    factor = max(float(r[0]) for r in ranks)
    ring = [int(r[6]) for r in ranks]
    solve = "" if ranks[0][1] is None else (
        f", solve {max(float(r[1]) for r in ranks):.3f} ms (one process {one.group(2)} ms)")
    print(f"multihost {plane} N={n} NB={nb} fp64, {MH_PROCS} processes x {MH_MEMBERS} members "
          f"on one card (gloo): factor {factor:.3f} ms, {n ** 3 / 3 / (factor / 1e3) / 1e9:.1f} "
          f"GFLOP/s{solve}; one process {float(one.group(1)):.3f} ms "
          f"({factor / float(one.group(1)):.2f}x); boundary per process "
          + ", ".join(f"{r[2]} broadcasts {float(r[3]):.1f} MB {float(r[4]):.1f} ms ({r[5]}%)"
                      for r in ranks)
          + f"; #11 launches per process {ring}; assembly (the replicate step) per process "
          + ", ".join(f"{float(r[8]):.1f} MB {float(r[9]):.1f} ms" for r in ranks)
          + f"; peak device memory per process {[float(r[10]) for r in ranks]} GiB; gate {gate.group(1)} (1e-10); max |difference| "
          f"from one process {one.group(3)}, the same bits: {one.group(4)} {tag}", flush=True)
    require(gate.group(2) == "PASS" and float(gate.group(1)) < 1e-10,
            f"multihost plane {plane}: gate {gate.group(1)} not below 1e-10")
    if plane in ("column", "packed", "packed-df64"):
        want = 2 * (n // nb) - 1
        require(ring == [want] * MH_PROCS, f"multihost plane {plane}: #11 launches {ring} per "
                f"process, expected {want} in each")


def phase_multihost(tag):
    """The five planes across MH_PROCS processes on this card against one process."""
    torch.cuda.empty_cache()
    t38 = time.perf_counter()
    outs = mh_run(tag, "block", N_MH_BLOCK, NB_MH)
    require(f"[mh 0] {MH_PROCS} processes, {MH_PROCS * MH_MEMBERS} global members "
            f"({MH_MEMBERS} local) on cuda" in outs[0], "multihost: no header line")
    mh_report(tag, outs, "block", N_MH_BLOCK, NB_MH)
    planes = ("potrs", "column", "packed", "packed-df64")
    outs = mh_run(tag, ",".join(planes), N_MH, NB_MH)
    for plane in planes:
        mh_report(tag, outs, plane, N_MH, NB_MH)
    print(f"phase 38 wall time: {time.perf_counter() - t38:.1f} s {tag}", flush=True)


# ---- 39. the finance model ------------------------------------------------------------------
def models_run(tag, *argvs) -> list[str]:
    """Subcommands of ``python -m dla_tpu_torch.models.cli``, each a process of its
    own, started together; their outputs, printed with each one's wall time. Fails
    unless every one exits 0 within MODEL_TIMEOUT seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "dla_tpu_torch.models.cli",
                               *map(str, argv)], cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for argv in argvs]
    outs, together = [], " (started together)" if len(argvs) > 1 else ""
    try:
        for argv, p in zip(argvs, procs):
            out, err = p.communicate(timeout=max(1.0, t0 + MODEL_TIMEOUT - time.perf_counter()))
            for line in out.splitlines():
                print(f"models| {line}")
            print(f"phase 39 {argv[0]}: exit code {p.returncode}, wall "
                  f"{time.perf_counter() - t0:.2f} s{together} {tag}", flush=True)
            require(p.returncode == 0, f"models {argv[0]} exited {p.returncode}: {err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def model_tree(rng, f: int, hidden, outputs: int) -> dict:
    """A weight tree in the JAX package's names, made with numpy: scaled normal input
    and head kernels, orthogonal recurrent kernels, small random biases."""
    import numpy as np

    tree, fan = {}, f
    for layer, h in enumerate(hidden):
        cell = {}
        for g in "ifgo":
            cell[f"i{g}"] = {"kernel": (rng.standard_normal((fan, h)) / fan ** 0.5)
                             .astype(np.float32)}
            cell[f"h{g}"] = {"kernel": np.linalg.qr(rng.standard_normal((h, h)))[0]
                             .astype(np.float32),
                             "bias": (0.1 * rng.standard_normal(h)).astype(np.float32)}
        tree[f"OptimizedLSTMCell_{layer}"] = cell
        fan = h
    tree["Dense_0"] = {"kernel": (rng.standard_normal((fan, outputs)) / fan ** 0.5)
                       .astype(np.float32), "bias": np.zeros(outputs, np.float32)}
    return tree


def phase_models(tag):
    """The models CLI at full width on the card, then the card against the CPU."""
    import tempfile

    import numpy as np

    from dla_tpu_torch.models.dataset import DataSet
    from dla_tpu_torch.models.features import FeatureSet
    from dla_tpu_torch.models.windpuller import WindPuller, params_from_flax

    t39 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        data, feats = os.path.join(d, "data"), os.path.join(d, "f.npz")
        model, pred, cum = (os.path.join(d, n) for n in ("wp.pkl", "pred.tsv", "cum.tsv"))
        out, = models_run(tag, ["gen-data", "--out", data, "--days", MODEL_DAYS])
        require(out.startswith("wrote 19 tickers"), "gen-data did not write 19 tickers")
        out, _ = models_run(tag, ["audit", "--data", data],
                            ["features", "--data", data, "--out", feats, "--window",
                             MODEL_WINDOW, "--horizon", MODEL_HORIZON])
        require(len(out.splitlines()) == 20 and "common overlap" in out, "audit: not 19 rows")
        fs = FeatureSet.load(feats)
        n_test = len(fs.x) - fs.n_train
        require(fs.x.shape == (MODEL_DAYS - MODEL_WINDOW + 1 - MODEL_HORIZON, MODEL_WINDOW,
                               19 * 24), f"features: X{fs.x.shape}")
        out, = models_run(tag, ["train", "--features", feats, "--model", model, "--epochs",
                                MODEL_EPOCHS, "--batch-size", MODEL_BATCH, "--hidden",
                                *MODEL_HIDDEN, "--device", DEVICE])
        epochs = re.findall(r"^epoch \d+/\d+ loss=(\S+) val_loss=(\S+) val_dacc=\S+", out, re.M)
        require(len(epochs) == MODEL_EPOCHS, f"train printed {len(epochs)} epoch lines")
        require(np.all(np.isfinite(np.array(epochs, float))), "train: a loss is not finite")
        require(os.path.getsize(model) > 0, "train wrote no checkpoint")
        out, _ = models_run(tag, ["eval", "--features", feats, "--model", model, "--device",
                                  DEVICE],
                            ["predict", "--features", feats, "--model", model, "--out", pred,
                             "--cumret", cum, "--device", DEVICE])
        m = re.search(r"^loss=(\S+) directional_accuracy=(\S+) pearson=(\S+)$", out, re.M)
        require(m is not None and all(np.isfinite(float(v)) for v in m.groups()),
                "eval printed no finite metrics")
        for path in (pred, cum):
            with open(path) as fh:
                rows = fh.read().splitlines()
            require(len(rows) == 1 + n_test, f"{os.path.basename(path)}: {len(rows) - 1} rows "
                    f"for {n_test} test windows")
            require(all(np.all(np.isfinite([float(v) for v in r.split("\t")[1:]]))
                        for r in rows[1:]), f"{os.path.basename(path)}: a value is not finite")

        # the card against the CPU from one weight tree, on the same batches
        t_cli = time.perf_counter() - t39
        t, f = fs.x.shape[1:]
        tree = model_tree(np.random.default_rng(39), f, MODEL_HIDDEN, fs.y.shape[1])

        def build(device):
            wp = WindPuller(input_shape=(t, f), outputs=fs.y.shape[1], hidden=MODEL_HIDDEN,
                            noise_std=0.0, dropout=0.0, device=device)
            wp.net.load_state_dict(params_from_flax(tree))
            return wp

        xtr, ytr = fs.train()
        xte, _ = fs.test()
        ds, batches = DataSet(xtr, ytr, seed=0), []
        while len(batches) < MODEL_STEPS:
            batches.extend(ds.epoch(MODEL_BATCH))
        batches = batches[:MODEL_STEPS]
        runs = {}
        for device in (DEVICE, "cpu"):
            wp = build(device)
            gen = torch.Generator(device=wp.device)
            xs = [(wp._tensor(xb), wp._tensor(yb)) for xb, yb in batches]
            t0 = time.perf_counter()
            losses = [wp._step(*xs[0], gen)]  # the first step (cuBLAS handles, allocations)
            sync()
            t1 = time.perf_counter()
            losses += [wp._step(xb, yb, gen) for xb, yb in xs[1:]]
            sync()
            step_ms = (time.perf_counter() - t1) / (MODEL_STEPS - 1) * 1e3
            runs[device] = (wp, torch.stack(losses).tolist(), step_ms, (t1 - t0) * 1e3)
        card, cpu = runs[DEVICE][0], runs["cpu"][0]
        nparams = sum(p.numel() for p in card.net.parameters())
        worst = []
        cpu_state = cpu.net.state_dict()
        for k, v in card.net.state_dict().items():
            ref = cpu_state[k]
            worst.append((float((v.cpu() - ref).abs().max()) / float(ref.abs().max()), k))
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs[DEVICE][1], runs["cpu"][1]))
        pc, pp = card.predict(xte), cpu.predict(xte)
        pred_err = float(np.abs(pc - pp).max())
        x_all = fs.x
        card.predict(x_all)
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            card.predict(x_all)
        rows_s = reps * len(x_all) / (time.perf_counter() - t0)
        print(f"phase 39 card against CPU: {nparams} parameters, {MODEL_STEPS} Adam steps at "
              f"batch {MODEL_BATCH} (T={t}, F={f}, hidden {MODEL_HIDDEN}); largest "
              f"|Δp|/max|p| {max(worst)[0]:.3e} ({max(worst)[1]}; tolerance 1e-4), largest loss "
              f"difference {loss_rel:.3e} relative, predictions max |Δ| {pred_err:.3e} "
              f"(tolerance 1e-5); card {runs[DEVICE][2]:.3f} ms a step, CPU "
              f"{runs['cpu'][2]:.3f} ms a step (steps 2 to {MODEL_STEPS}; the first "
              f"{runs[DEVICE][3]:.1f} and {runs['cpu'][3]:.1f} ms); predict "
              f"{rows_s:.0f} rows/s on the card ({len(x_all)} windows, batch 256) {tag}",
              flush=True)
        require(max(worst)[0] <= 1e-4, f"card against CPU: {max(worst)[1]} differs by "
                f"{max(worst)[0]:.3e} of its largest magnitude")
        require(pred_err <= 1e-5, f"card against CPU: predictions differ by {pred_err:.3e}")

        # a reloaded checkpoint, and where the state lies
        card.save(model)
        again = WindPuller.load(model, device=DEVICE)
        require(np.array_equal(again.predict(xte), pc), "a reloaded checkpoint predicts "
                "other bits")
        on = {p.device.type for p in card.net.parameters()}
        moments = {v.device.type for st in card.opt.state.values()
                   for k, v in st.items() if k != "step"}
        print(f"phase 39 reload: the same bits; parameters on {sorted(on)}, Adam moments on "
              f"{sorted(moments)} ({len(card.opt.state)} tensors each; the step count is "
              f"torch's host scalar) {tag}", flush=True)
        require(on == moments == {torch.device(DEVICE).type}, "state off the card")
        t_cmp = time.perf_counter() - t39 - t_cli
    print(f"phase 39 wall time: {time.perf_counter() - t39:.1f} s: the CLI's processes "
          f"{t_cli:.1f} s, card against CPU and the reload {t_cmp:.1f} s {tag}", flush=True)


# ---- 40. the projection model beside this run's rates -------------------------------------
def bench_tier(key: str) -> str:
    """The model's tier of a bench tier key (``high_inplace`` → ``high``)."""
    return "bf16" if key.startswith("bf16") else key.split("_")[0]


def phase_projection(dev, tag, rates):
    """``rates``: {(path, n, tier): GFLOP/s measured in this run}."""
    from dla_tpu_torch.bench import projections
    from dla_tpu_torch.parallel import model

    t40 = time.perf_counter()
    if not rates:
        _, tmed = phase_main_path(dev, tag)
        rates = {("main path", N_MAIN, "high"): N_MAIN**3 / 3 / tmed / 1e9}
    for (path, n, tier), gflops in rates.items():
        proj = model.single_chip_rate(n, "h100", tier)
        ratio = gflops / proj
        print(f"projection model: {path} N={n} {tier}: measured {gflops:.1f} GFLOP/s, "
              f"single_chip_rate {proj:.1f} GFLOP/s, ratio {ratio:.3f} {tag}", flush=True)
        require(1 / RATE_BAND <= ratio <= RATE_BAND,
                f"{path} N={n} {tier}: measured/projected {ratio:.3f} outside "
                f"[1/{RATE_BAND:g}, {RATE_BAND:g}]")
    spec = model.CHIPS["h100"]
    total = torch.cuda.mem_get_info(dev)[1] / 2**30
    print(f"projection model: CHIPS['h100'].hbm_gib {spec.hbm_gib} beside this card's "
          f"{total:.3f} GiB; tflops {spec.tflops} {tag}", flush=True)
    for r in projections.crossover_rows():
        print(f"projection (not a measurement): {r['mesh']} H100 mesh, high, nb={r['nb']}: "
              f"crossover N={r['crossover_n']}, 50% efficiency from N={r['n_eff50']}, 70% "
              f"from N={r['n_eff70']}, speedup {r['speedup_at_131072']:.2f} at N=131072",
              flush=True)
    for r in projections.packed_rows():
        print(f"projection (not a measurement): packed {r['tier']} planes={r['planes']} on "
              f"D={r['ndev']}: crossover N={r['crossover_n']}, mesh holds N={r['mesh_max_n']} "
              f"at {r['gflops_at_mesh_max']:.0f} GFLOP/s", flush=True)
    for r in projections.serving_rows():
        if r["n"] == 16384 and r["p"] == 4:
            print(f"projection (not a measurement): serving N={r['n']} nrhs={r['nrhs']} on "
                  f"p={r['p']}: speedup {r['speedup']:.2f}, {r['cols_per_s']:.0f} columns/s",
                  flush=True)
    for r in projections.oocore_rows():
        print(f"projection (not a measurement): out of core N={r['n']} on {r['mesh']}: "
              f"{r['t_total_s']:.1f} s, {r['bound']}-bound at {r['host_bw_gbps']:.1f} GB/s",
              flush=True)
    print(f"phase 40 wall time: {time.perf_counter() - t40:.1f} s {tag}", flush=True)


LAST_PHASE = 40


def parse_phases(spec: str | None) -> set[int]:
    """``--phases a,b-c``: the phases to run, all of them by default. Phase 1
    (the card and the build) always runs."""
    if not spec:
        return set(range(1, LAST_PHASE + 1))
    sel = {1}
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        sel.update(range(int(lo), int(hi or lo) + 1))
    if not sel <= set(range(1, LAST_PHASE + 1)):
        raise SystemExit(f"chip_smoke: --phases takes phases 1 to {LAST_PHASE}, got {spec!r}")
    return sel


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of dla_tpu_torch on one NVIDIA GPU")
    ap.add_argument("--phases", default=None, metavar="a,b-c",
                    help="run these phases only (default: all); the last line is printed "
                         "when every selected phase passed")
    sel = parse_phases(ap.parse_args(argv).phases)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    from dla_tpu_torch.kernels import _build

    dev = torch.device(DEVICE)
    card = card_line()
    tag = f"[{card}]"

    # ---- 1. the card and the build ------------------------------------
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0 = {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build + load: {time.perf_counter() - t0:.3f} s ({_build.library_path().name}) "
          f"{tag}", flush=True)

    got = {}  # what the phases that ran returned: the kernels' rows and launch counts
    main_median = None
    rates = {}  # (path, n, tier): GFLOP/s, for phase 40
    if 2 in sel:
        got["lower"] = phase_lower_kernel(dev, tag)
    if 3 in sel:
        got["lower_launches"], main_median = phase_main_path(dev, tag)
        rates[("main path", N_MAIN, "high")] = N_MAIN**3 / 3 / main_median / 1e9
    if 4 in sel:
        phase_inplace_check(dev)
    if 5 in sel:
        phase_driver(tag, ["--n", str(N_MAIN), "--nb", str(NB_MAIN), "--dtype", "s",
                           "--mode", "inplace", "--repeats", "2"])
    torch.cuda.empty_cache()
    if 6 in sel:
        got["packed"] = phase_packed_kernel(dev, tag)
    if 7 in sel:
        got["packed_launches"] = phase_packed_path(dev, tag)
    if 8 in sel:
        phase_packed_check(dev)
    if 9 in sel:
        phase_driver(tag, ["--n", str(N_PACKED), "--nb", str(W_PACKED), "--dtype", "s",
                           "--mode", "packed", "--trailing", "pallas", "--precision", "default",
                           "--diag", "twolevel", "--kb", str(W_PACKED), "--repeats", "1"])
    torch.cuda.empty_cache()
    if 10 in sel:
        got["df64"] = phase_df64_kernel(dev, tag)
    if 11 in sel:
        got["df64_launches"], tmed = phase_df64_path(dev, tag)
        rates[("f64x path", N_DF64, "f64x")] = N_DF64**3 / 3 / tmed / 1e9
    if 12 in sel:
        phase_df64_check(dev)
    if 13 in sel:
        phase_driver(tag, ["--n", str(N_DF64), "--nb", str(NB_DF64), "--mode", "df64",
                           "--trailing", "pallas", "--repeats", "1"])
    torch.cuda.empty_cache()
    if 14 in sel:
        got["pfactor"], got["papply"] = phase_panel_kernels(dev, tag)
    if 15 in sel:
        tmed = phase_highest_tier(dev, tag)
        rates[("highest tier", N_HIGHEST, "highest")] = N_HIGHEST**3 / 3 / tmed / 1e9
    if 16 in sel:
        got["pfactor_launches"] = phase_panel_factor_path(dev, tag)
    if 17 in sel:
        got["papply_launches"] = phase_panel_apply_path(dev, tag, main_median)
    if 18 in sel:
        phase_modes_check(dev)
    if 19 in sel:
        phase_driver(tag, ["--n", str(N_HIGHEST), "--nb", str(HIGHEST_KW["nb"]), "--dtype", "s",
                           "--mode", "shrink", "--panel", "blocktrsm", "--trailing", "pallas",
                           "--precision", "highest", "--kb", str(HIGHEST_KW["kb"]),
                           "--repeats", "1"])
    torch.cuda.empty_cache()
    if 20 in sel:
        got["pdf64"] = phase_packed_df64_kernel(dev, tag)
    if 21 in sel:
        got["pdf64_launches"] = phase_packed_df64_path(dev, tag)
    if 22 in sel:
        phase_packed_df64_check(dev)
    if 23 in sel:
        out = phase_driver(tag, ["--n", str(N_PDF64_DRIVER), "--nb", str(NB_PDF64), "--mode",
                                 "df64-packed", "--repeats", "1"])
        require("||A - LL^T||_inf" in out, "the driver did not take the blocked df64 residual")
        # a budget too small for the unpack: the gate straight off the packed pair
        out = phase_driver(tag, ["--n", str(N_PDF64_SPLIT), "--nb", str(NB_PDF64), "--mode",
                                 "df64-packed", "--df64-split", "2", "--repeats", "1"],
                           env={"DLA_TPU_VALIDATE_HBM_BUDGET": "1"})
        require("freivalds" in out, "the driver did not take the packed-native gate")
    torch.cuda.empty_cache()
    if 24 in sel:
        for op, row in phase_task_kernels(dev, tag).items():
            got[f"{op}_tile"] = row
    if 25 in sel:
        for task, count in phase_task_path(dev, tag, main_median).items():
            got[f"{task.lower()}_tile_launches"] = count
    if 26 in sel:
        phase_freivalds_device(dev, tag)
    if 27 in sel:
        for line in phase_bench(tag, BENCH_TIERS, BENCH_ENV)[:-1]:
            rates[(f"bench {line['tier']}", line["n"], bench_tier(line["tier"]))] = line["gflops"]
    if 28 in sel:
        out = phase_driver(tag, ["--n", str(N_HEADLINE), "--nb", str(NB_HEADLINE), "--dtype", "s",
                                 "--mode", "inplace", "--repeats", "1"])
        require("freivalds" in out, "the driver did not take the Freivalds gate at the "
                "headline size")
    torch.cuda.empty_cache()
    if 29 in sel:
        got.update(phase_ring_kernels(dev, tag))
    for phase in (30, 31, 32):
        if phase in sel:
            got["ring_bcast_launches"] = (got.get("ring_bcast_launches", 0)
                                          + phase_ring_plane(dev, tag, phase))
    if 33 in sel:
        phase_solve(dev, tag)
    if 34 in sel:
        phase_packed_serving(tag)
    if 35 in sel:
        phase_oocore(tag)
    if 36 in sel:
        phase_session(tag)
        phase_block_cyclic(dev, tag)
        phase_distributed_drivers(tag)
    if 37 in sel:
        t37 = time.perf_counter()
        phase_driver_flags(tag)
        phase_tools(dev, tag)
        print(f"phase 37 wall time: {time.perf_counter() - t37:.1f} s {tag}", flush=True)
    if 38 in sel:
        phase_multihost(tag)
    if 39 in sel:
        phase_models(tag)
    if 40 in sel:
        phase_projection(dev, tag, rates)

    # a kernel is listed when both its comparison phase and its path phase ran
    rows = []
    for name, src, replaces, row, count in (
        ("trailing_update_lower", "trailing_lower.cu", "pallas_tiles.py:328", "lower",
         "lower_launches"),
        ("trailing_update_packed", "trailing_packed.cu", "pallas_tiles.py:557", "packed",
         "packed_launches"),
        ("trailing_update_df64", "trailing_df64.cu", "df64_tiles.py:110", "df64",
         "df64_launches"),
        ("panel_apply", "panel_apply.cu", "pallas_tiles.py:429", "papply", "papply_launches"),
        ("panel_factor", "panel_factor.cu", "pallas_tiles.py:270", "pfactor",
         "pfactor_launches"),
        ("trailing_update_packed_df64", "trailing_packed_df64.cu", "df64_tiles.py:185", "pdf64",
         "pdf64_launches"),
        ("potrf_tile", "potrf_tile.cu", "pallas_tiles.py:171", "potrf_tile",
         "potrf_tile_launches"),
        ("trsm_tile", "tile_ops.cu", "pallas_tiles.py:194", "trsm_tile", "trsm_tile_launches"),
        ("syrk_tile", "tile_ops.cu", "pallas_tiles.py:218", "syrk_tile", "syrk_tile_launches"),
        ("gemm_tile", "tile_ops.cu", "pallas_tiles.py:238", "gemm_tile", "gemm_tile_launches"),
        ("ring_broadcast", "ring.cu", "collectives.py:166", "ring_bcast", "ring_bcast_launches"),
        ("ring_all_gather", "ring.cu", "collectives.py:223", "ring_gather",
         "ring_gather_launches"),
    ):
        if row not in got or count not in got:
            continue
        require(got[count] > 0, f"{name} was not launched on its path")
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"dla_tpu_torch/kernels/csrc/{src}",
            "replaces": f"dla_tpu/kernels/{replaces}",
            "launches": got[count],
            **{k: got[row][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
            **{k: got[row][k] for k in ("body", "queued", "big") if k in got[row]},
        })
    # no library call took the scalar body (tile_kernel): it stays the chain bodies' bit reference
    from dla_tpu_torch.kernels import panel, tiles

    scalar = {"panel_factor": panel.panel_factor_body_launches()["scalar"],
              "panel_apply": panel.panel_apply_body_launches()["scalar"],
              "tile_ops": tiles.tile_body_launches()["scalar"]}
    print(f"scalar-body launches of the library: {scalar} {tag}", flush=True)
    require(not any(scalar.values()), f"a library call launched tile_kernel: {scalar}")
    print(json.dumps({"kernels": rows}))
    print(f"chip_smoke total wall time: {time.perf_counter() - t_start:.1f} s, phases "
          f"{sorted(sel)} {tag}", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
