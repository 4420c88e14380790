"""Single-run POTRF driver — ``dla_tpu/cli/potrf_driver.py`` on PyTorch, with
its flags: ``--mode blocked|masked|shrink|inplace|packed|df64|df64-packed|
distributed``, the dtypes d/s/h/z/c, ``--uplo L|U|B``, ``--checked``, the
``--lm --ioff --joff --m`` views, ``--gen plgsy|gershgorin``, ``--config``
and ``--input``. ``--platform`` and ``--x64``'s jax settings have no
counterpart: ``--device cuda|cpu`` picks the device (default the card), and
``--x64`` only picks the fp64 refined solve.

It keeps the reference's text contract (``v6_test.c:54-87``), which a sweep
harness greps:

- one ``Repeat i: <ms> ms <rate> Gflop/s`` line per repeat, printed as it
  finishes (repeat 0 is the warm-up, which also builds the CUDA kernel);
- ``Elapsed: <ms> ms`` and ``Performance: %.2f Gflop/s`` for the median of
  the timed repeats, with the rate (1/3)·N³/t;
- ``||A - LL^T||_inf / ||A||_inf = %.2e`` (the dense modes) or the
  matrix-free ``freivalds ||(A - LL^T)x|| / (||A|| ||x||) = %.2e``: for the
  packed triangle (``--mode packed``: a dense A and L need not fit beside
  it), and for a dense mode whose exact residual does not fit the device
  (``freivalds_device``, A regenerated from its seed; the budget is the
  device's memory, or ``DLA_TPU_VALIDATE_HBM_BUDGET`` bytes); then
  ``PASS``/``FAIL`` against the dtype-aware gate; the exit code is non-zero
  on FAIL.

The input, as the reference picks it (``potrf_driver.py:262-335``): the
seed's ``plgsy`` (``plghe`` for c/z), ``spd_gershgorin`` for ``--gen
gershgorin``, only the view's tiles (``plgsy_tile``/``plghe_tile`` at the
view's origin: the lm×lm matrix is never built) for ``--lm``, or the user's
``--input`` (``.npy``, ``.npz`` or raw ``--dtype`` binary; N from a square
file when ``--n`` is omitted; not square, the wrong size, not finite or
complex into a real dtype exits 2). ``--uplo U`` presents a generated matrix
through its upper triangle; ``U`` factors to Uᴴ·U, ``B`` returns L below and
Lᴴ above the diagonal, and the gate reads the lower contract of either; the
packed and df64 modes take L only. The default bump is the N given before a
view or a file sets N, as the reference's. Only the seed's own real plgsy
matrix in uplo L takes the paths that regenerate it (the packed triangle
generated directly, ``potrf_inplace`` on a regenerated buffer, the
matrix-free gates, the host generator of the refined solves); any other
input is built again before each repeat, untimed, and factored through
``potrf`` (the packed mode packs it inside the timed call). Complex input
runs every route but the hand kernels, which raise for it. ``--checked``
factors the dense modes through ``validate.checked.potrf_checked`` and, on a
failed check, prints ``CHECK FAILED: <message>`` and returns 3 before any
repeat line. ``--config PATH`` (or ``$DLA_TPU_CONFIG``) is a JSON profile
under the environment (``CHOLESKY_N``/``CHOLESKY_B``/``CHOLESKY_SEED``) under
the flags.

``--mode blocked|masked|shrink`` call ``potrf`` with that mode, wired as
the reference driver wires them (``potrf_driver.py:533-539``): blocked and
shrink take ``--panel``, ``--trailing`` and ``--diag``, shrink also
``--kb``; masked takes none of them.

``--mode distributed --p P --q Q`` factors on a P×Q member mesh
(``parallel/potrf_dist.py:potrf_block_cyclic``), its members spread over the
visible cards (``--device cuda:0`` keeps them on card 0; ``--device cpu``
on the CPU), the timed region waiting for every card of the mesh, as the reference
(``potrf_driver.py:339-356``): tril(A) is sharded block-cyclically before
each repeat, untimed; the timed factorization includes assembling the dense
tril(L), which the dense modes' gates then check.

``--mode df64`` is the emulated-fp64 factorization (``algos/potrf_df64.py``):
the dtype is forced to float64 and the gate to 1e-10. A is generated in fp64
on the chosen device and split into its (hi, lo) fp32 pair; ``--slices`` sets
s (default 7), ``--trailing pallas`` runs the df64 trailing kernel with
tb = min(512, NB). ``--input PATH`` (``.npy``, ``.npz`` or raw fp64, N from
``--n``) factors a user's matrix, read through its lower triangle, instead. The residual is
evaluated in df64 on the device, by the strip gate up to N = 8192
(``DLA_TPU_DF64_STRIP_RESIDUAL_MAX``) and by the blocked gate above, when its
working set fits the budget: the device's memory, or
``DLA_TPU_VALIDATE_HBM_BUDGET`` bytes. Where it does not fit, or runs out of
memory, the streaming df64 Freivalds gate runs and prints the ``freivalds``
line.

``--mode df64-packed`` is the same contract on triangle-only storage
(``potrf_packed_df64``: 4·N² resident bytes instead of the dense pair's 8·N²;
NB is the slab width, the kernel tile min(512, NB)). Without ``--input`` the
packed fp32 triangle is generated on the device with a zero lo plane and no
square is ever built; with ``--input`` the pair is packed from the dense one.
The factor is unpacked for the dense df64 gates above when the packed pair,
the unpacked pair and A fit the budget together; where they do not, the
generated path certifies straight off the packed pair with
``freivalds_packed_df64`` (A streamed from its seed). ``--df64-split K`` runs the factorization as K
segments of slab steps (0: segments of at most 40 steps), the same bits as
one run.

``--solve potrs|inverse|refined`` (dense modes) then solves A·X = B for
``--nrhs`` right-hand sides of ones, as the reference driver's dense branches
(``dla_tpu/cli/potrf_driver.py:901-961``): ``potrs`` of the factor,
``solve_inverse(potri(L))``, or mixed-precision refinement, and prints
``||B - A X||_inf / (||A||_inf ||X||_inf) = %.2e`` and ``SOLVE PASS``/``SOLVE
FAIL``, which also makes the exit code non-zero. The gates: 1e-10 for a
float64 or complex128 factor, else N·2e-6, for ``potrs``/``inverse``; 1e-10 for
``refined``.
``refined`` is ``posv_refined_host`` (an fp32 ``potrf_shrink`` factor of
tril(A) in fp64, early stop at 1e-11) unless ``--x64`` or an fp64 dtype
picks ``posv_refined`` (an fp32 ``potrf_blocked`` factor, eight fp64
refinement steps), as the reference picks by ``jax_enable_x64`` (on for d
and z); both run their fp64 residuals on the chosen device.

``posv_refined_host`` takes tril(A) regenerated in fp64 on the host by the
native generator (``HostTileStore.fill_plgsy``, the card generator's bits)
for the seed's plgsy matrix, as the reference does
(``dla_tpu/cli/potrf_driver.py:905-917``), and for any other input tril(A)
widened to fp64 where it lies. With ``--uplo U`` every solve reads A through
its upper triangle and takes L = Uᴴ. The refined solves are real (an fp32
factor, fp64 residuals): ``--dtype c|z`` with ``--solve refined`` exits 2,
where the reference drops the imaginary parts and solves another system.

``--mode packed --solve potrs|inverse|refined`` solves from the packed
factor, as the reference driver's packed branch
(``dla_tpu/cli/potrf_driver.py:828-900``): ``potrs_packed``, or
``potri_packed`` (in place on the factor) then ``solve_inverse_packed``, each
timed, their residual ``residual_posv_streamed`` with A streamed from its
seed (``residual_posv`` against the dense A where the input is not the seed's
plgsy matrix), under 1e-10 for fp64 (real or complex), else N·2e-6; or
``posv_refined_streamed`` (the seed's matrix only), correction solves
by ``potrs_packed`` on the card and fp64 residuals streamed from the native
host generator (A is materialized nowhere), under 1e-10.

Only the factorization is timed, between two ``torch.cuda.synchronize()``
calls; the input is regenerated from its seed before each repeat, untimed
(``v6_test.c:54-57`` times dpotrf only). ``--mode packed`` on the seed's
plgsy matrix generates the packed triangle directly (``plgsy_packed``) and
never builds a dense square; NB is its slab width. ``CHOLESKY_N``/``CHOLESKY_B`` in
the environment set N and NB when the flags do not.

Usage:
    python -m dla_tpu_torch.cli.potrf_driver --n 16384 --nb 1024 --dtype s --mode inplace
    python -m dla_tpu_torch.cli.potrf_driver --n 32768 --nb 8192 --dtype s --mode shrink \
        --panel blocktrsm --trailing pallas --precision highest --kb 256
    python -m dla_tpu_torch.cli.potrf_driver --n 81920 --nb 4096 --dtype s --mode packed \
        --trailing pallas --precision default --diag twolevel --kb 4096
    python -m dla_tpu_torch.cli.potrf_driver --n 24576 --nb 1024 --mode df64 --trailing pallas
    python -m dla_tpu_torch.cli.potrf_driver --n 40960 --nb 1024 --mode df64-packed
    python -m dla_tpu_torch.cli.potrf_driver --n 512 --nb 128 --dtype d --device cpu
    python -m dla_tpu_torch.cli.potrf_driver --n 16384 --nb 512 --dtype s --mode distributed \
        --p 2 --q 2
    python -m dla_tpu_torch.cli.potrf_driver --n 16384 --nb 1024 --dtype s --mode inplace \
        --solve refined --nrhs 64
    python -m dla_tpu_torch.cli.potrf_driver --n 32768 --nb 4096 --dtype s --mode packed \
        --solve inverse --nrhs 64
    python -m dla_tpu_torch.cli.potrf_driver --n 16384 --nb 1024 --dtype z --uplo U \
        --mode blocked
    python -m dla_tpu_torch.cli.potrf_driver --n 16384 --nb 1024 --dtype s --lm 65536 \
        --ioff 16384 --joff 16384 --m 16384
    python -m dla_tpu_torch.cli.potrf_driver --nb 1024 --dtype s --input a.npy --solve refined
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def _device_arg(text: str) -> str:
    """``--device``: cpu, cuda or cuda:N."""
    if text in ("cpu", "cuda") or (text.startswith("cuda:") and text[5:].isdigit()):
        return text
    raise argparse.ArgumentTypeError(f"{text!r}: choose cuda, cuda:N or cpu")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dla-potrf-torch",
        description="Tiled Cholesky (POTRF) driver — PyTorch/CUDA port",
    )
    ap.add_argument("--n", type=int, default=None, help="matrix dimension N")
    ap.add_argument("--nb", type=int, default=None, help="panel width NB")
    ap.add_argument("--dtype", default=None,
                    help="d|float64, s|float32, h|bfloat16 (storage), z|complex128, "
                         "c|complex64 (the reference's dtype map)")
    ap.add_argument("--uplo", default=None,
                    help="L (A = L·Lᴴ), U (A = Uᴴ·U, the matrix given through its upper "
                         "triangle) or B (L below and Lᴴ above the diagonal)")
    ap.add_argument("--mode", choices=["blocked", "masked", "shrink", "inplace", "packed",
                                       "df64", "df64-packed", "distributed"], default=None,
                    help="factorization formulation (default inplace): blocked, masked or "
                         "shrinking dense (potrf's modes), the dense in-place buffer, "
                         "triangle-only packed storage (NB = slab width), emulated "
                         "fp64 on a (hi, lo) fp32 pair, dense (df64) or packed "
                         "(df64-packed), or block-cyclic on a P×Q member mesh "
                         "(distributed)")
    ap.add_argument("--p", type=int, default=None, help="mesh rows (distributed)")
    ap.add_argument("--q", type=int, default=None, help="mesh cols (distributed)")
    ap.add_argument("--panel", choices=["xla", "pallas", "invgemm", "blocktrsm"],
                    default="xla", help="blocked and shrink modes' panel: a triangular "
                    "solve (xla), the panel_factor CUDA kernel (pallas), or, shrink "
                    "only, inverse-GEMM or blocked TRSM")
    ap.add_argument("--trailing", choices=["xla", "pallas"], default="xla",
                    help="blocked, shrink, packed and df64 modes' trailing update: the "
                         "torch GEMMs (xla) or the mode's CUDA kernel (pallas, real dtypes)")
    ap.add_argument("--slices", type=int, default=None,
                    help="df64 modes: bf16 slices per row (default 7)")
    ap.add_argument("--df64-split", type=int, default=1,
                    help="df64-packed mode: run the factorization as this many segments "
                         "of slab steps (0: segments of at most 40 steps); same bits as 1")
    ap.add_argument("--checked", action="store_true",
                    help="dense modes: factor through potrf_checked; a non-SPD input prints "
                         "CHECK FAILED and exits 3 instead of giving NaNs")
    ap.add_argument("--lm", type=int, default=None,
                    help="global matrix dimension; with --ioff/--joff/--m, factor a "
                         "tile-aligned principal submatrix view (Desc_Create's lm, ln, ioff, "
                         "joff, m, n); only the view's tiles are generated")
    ap.add_argument("--ioff", type=int, default=0, help="view row offset (elements)")
    ap.add_argument("--joff", type=int, default=0, help="view column offset (elements)")
    ap.add_argument("--m", type=int, default=None, dest="view_m",
                    help="view dimension (default: lm - ioff)")
    ap.add_argument("--gen", choices=["plgsy", "gershgorin"], default=None,
                    help="SPD generator: plgsy (diagonal bump) or gershgorin (the "
                         "distributed client's row dominance)")
    ap.add_argument("--input", default=None, metavar="PATH",
                    help="factor a user-provided N×N matrix (.npy, .npz [array 'a' or the "
                         "first array], or raw --dtype binary, row-major) instead of "
                         "generating one; for .npy/.npz N is taken from the file when --n is "
                         "omitted (not in the df64 modes, which read fp64 through the lower "
                         "triangle)")
    ap.add_argument("--bump", type=float, default=None, help="diagonal bump (default: N)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--precision", choices=["default", "high", "highest"], default=None,
                    help="matmul precision tier (default: library policy)")
    ap.add_argument("--diag", choices=["lax", "unblocked", "twolevel"], default="lax",
                    help="diagonal-block factor (not read by masked)")
    ap.add_argument("--kb", type=int, default=None,
                    help="trailing-update k-split, must divide NB (default: the "
                         "formulation's own, 256 inplace, min(NB, 256) shrink, "
                         "min(NB, 512) packed)")
    ap.add_argument("--repeats", type=int, default=1,
                    help="timed repeats after the warm-up repeat 0")
    ap.add_argument("--no-check", action="store_true", help="skip the residual")
    ap.add_argument("--config", default=None,
                    help="JSON config profile (below the environment and the flags; "
                         "default $DLA_TPU_CONFIG)")
    ap.add_argument("--gate", type=float, default=None,
                    help="PASS threshold (default: dtype-aware)")
    ap.add_argument("--device", type=_device_arg, default="cuda",
                    help="cuda (default; --mode distributed spreads its members over the "
                         "visible cards), cuda:N (that card; the mesh's members all on it) "
                         "or cpu")
    ap.add_argument("--solve", choices=["none", "potrs", "refined", "inverse"], default="none",
                    help="dense and packed modes: also solve A·X=B: plain POTRS, "
                         "mixed-precision iterative refinement (fp32 factor, fp64 residuals), "
                         "or the explicit inverse (POTRI, then one product per block of "
                         "right-hand sides)")
    ap.add_argument("--nrhs", type=int, default=1, help="right-hand sides for --solve")
    ap.add_argument("--x64", action="store_true",
                    help="--solve refined through posv_refined (the reference's "
                         "jax_enable_x64 branch), as an fp64 --dtype (d or z) does")
    return ap


def _gate(n: int, dtype: str) -> float:
    """The reference driver's dtype-aware gate (``potrf_driver.py:808-819``)."""
    if dtype in ("float64", "complex128"):
        return 1e-10  # the reference's gate (v6_test.c:87)
    if dtype in ("float32", "complex64"):
        return max(1e-10, n * 2e-7)
    return max(1e-10, n**0.5 * 2e-4)  # bf16 storage, fp32 accumulation


def _config(args):
    """The layered run configuration (``dla_tpu/cli/potrf_driver.py:210-224``):
    the JSON profile (``--config`` or ``$DLA_TPU_CONFIG``) under the
    environment under the flags. The mode defaults to inplace where neither
    the flags nor the profile name one."""
    import json

    from dla_tpu_torch.utils.config import RunConfig

    path = args.config or os.environ.get("DLA_TPU_CONFIG")
    mode = args.mode
    if mode is None:
        keys = set()
        if path and os.path.exists(path):
            with open(path) as f:
                keys = {k.lower() for k in json.load(f)}
        mode = None if "mode" in keys else "inplace"
    return RunConfig.layered(
        json_path=path, n=args.n, nb=args.nb, dtype=args.dtype, uplo=args.uplo,
        bump=args.bump, seed=args.seed, p=args.p, q=args.q, mode=mode, gen=args.gen,
        check=False if args.no_check else None,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("[dla-potrf] --device cuda: no CUDA device is available "
              "(torch.cuda.is_available() is False); use --device cpu",
              file=sys.stderr)
        return 2

    import dla_tpu_torch.algos as algos
    from dla_tpu_torch.algos import (
        freivalds_packed,
        pack_tri,
        plgsy_packed,
        potrf,
        potrf_df64,
        potrf_inplace,
        potrf_packed,
        unpack_tri,
    )
    from dla_tpu_torch.ops import plghe, plghe_tile, plgsy, plgsy_tile, spd_gershgorin, to_df64
    from dla_tpu_torch.ops.lapack_like import tile_in_slabs
    from dla_tpu_torch.utils.flops import gflops, potrf_flops
    from dla_tpu_torch.validate import residual_potrf

    cfg = _config(args)
    # the default bump is N before a view or a file sets N, as the reference's
    bump = float(cfg.n) if cfg.bump is None else cfg.bump
    device = torch.device(args.device)
    df64_packed = cfg.mode == "df64-packed"
    df64 = cfg.mode == "df64" or df64_packed
    if df64:  # the mode IS the fp64 contract: validate at the 1e-10 gate
        cfg = dataclasses.replace(cfg, dtype="float64")
    packed = cfg.mode == "packed"
    distributed = cfg.mode == "distributed"
    is_complex = cfg.dtype.startswith("complex")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[dla-potrf] N={cfg.n} NB={cfg.nb} dtype={cfg.dtype} mode={cfg.mode} "
          f"uplo={cfg.uplo} gen={cfg.gen} seed={cfg.seed} device={name}", flush=True)

    view = None
    if args.lm is not None:
        from dla_tpu_torch.tiles import TileLayout

        # a descriptor-checked view (tile-aligned, in bounds); POTRF needs a
        # principal one: an off-diagonal block of an SPD matrix is not SPD
        view = TileLayout(mb=cfg.nb, nb=cfg.nb, lm=args.lm, ln=args.lm, ioff=args.ioff,
                          joff=args.joff, m=args.view_m, n=args.view_m)
        if view.ioff != view.joff or view.m != view.n:
            print("[dla-potrf] POTRF view must be principal (ioff==joff, m==n)")
            return 2
        if view.m != cfg.n:
            cfg = dataclasses.replace(cfg, n=view.m)
        print(f"[dla-potrf] {view.describe()}", flush=True)

    host = None  # a user's matrix (dense and packed modes), as numpy
    if args.input and not df64:
        host = _read_matrix(args.input, cfg, args.n is None)
        if host is None:
            return 2
        if host.shape[0] != cfg.n:
            cfg = dataclasses.replace(cfg, n=host.shape[0])
            print(f"[dla-potrf] N={cfg.n} adopted from {args.input}", flush=True)
    if (packed or df64) and cfg.uplo != "L":
        print(f"[dla-potrf] --mode {cfg.mode} supports uplo L only")
        return 2
    if df64 and not args.input and (view is not None or cfg.gen != "plgsy"):
        print("[dla-potrf] --mode df64 needs the plgsy generator or --input")
        return 2
    slices = args.slices or 7
    if args.solve != "none" and df64:
        print("[dla-potrf] --solve with the df64 modes: use --solve refined on the fp32 modes "
              "(the same 1e-10 contract)", file=sys.stderr)
        return 2
    if args.solve == "refined" and is_complex:
        print("[dla-potrf] --solve refined is real (fp32 factor, fp64 residuals): use --solve "
              "potrs or inverse for --dtype c|z", file=sys.stderr)
        return 2
    # the seed's own matrix: what the matrix-free gates and the host
    # generator regenerate, and what the packed and inplace paths may
    # regenerate on the device instead of holding
    seeded = (host is None and view is None and cfg.uplo == "L" and cfg.gen == "plgsy"
              and not is_complex)
    packed_pure = packed and seeded
    # the pure packed-df64 path: exactly-fp32 generation on the device
    # (lo = 0), no fp64 square anywhere
    df64_pure = df64_packed and not args.input
    dtype = getattr(torch, cfg.dtype)
    tb = 1024 if cfg.nb % 1024 == 0 else cfg.nb
    kw = {"diag_factor": args.diag, "precision": args.precision}
    if cfg.mode in ("blocked", "shrink"):
        kw.update(panel=args.panel, trailing=args.trailing)
    if args.kb and (cfg.mode in ("inplace", "shrink") or (packed and args.trailing == "pallas")):
        kw["kb"] = args.kb
    if distributed:
        from dla_tpu_torch import parallel

        layout = parallel.BlockCyclicLayout(n=cfg.n, nb=cfg.nb, p=cfg.p, q=cfg.q)
        # --device cuda spreads the members over the visible cards; cuda:N or cpu holds them
        mesh = parallel.make_mesh(cfg.p, cfg.q, device=None if args.device == "cuda" else device)
        print(f"[dla-potrf] {cfg.p}x{cfg.q} members on "
              f"{','.join(str(d) for d in mesh.cards)}", flush=True)

    def sync():  # with a mesh, every card of it
        if distributed:
            parallel.member_comm.synchronize(mesh.devices)
        elif device.type == "cuda":
            torch.cuda.synchronize(device)

    user_pair = None
    if args.input and df64:
        a64 = _load_input(args.input, cfg.n)
        if a64 is None:
            return 2
        user_pair = to_df64(a64, device=device)

    def dense_pair():
        """The dense (hi, lo) input of the df64 modes, a fresh copy."""
        if user_pair is not None:
            return user_pair[0].clone(), user_pair[1].clone()
        # generated in fp64 where it is factored, then split
        return to_df64(plgsy(cfg.n, bump=bump, seed=cfg.seed, dtype=dtype, device=device))

    def dense_a():
        """The dense input A as the factorization is given it: the user's
        matrix, the view's tiles, or the generator's matrix; with uplo U,
        through its upper triangle (``potrf_driver.py:316-335``)."""
        gkw = dict(bump=bump, dtype=dtype, device=device)
        if host is not None:
            return _to_tensor(host, dtype, device)
        if view is not None:
            i0, j0 = view.tile_origin(0, 0)
            a = tile_in_slabs(plghe_tile if is_complex else plgsy_tile, cfg.seed, i0, j0,
                              view.m, view.n, **gkw)
        elif cfg.gen == "gershgorin":
            a = spd_gershgorin(cfg.n, seed=cfg.seed, dtype=dtype, device=device)
        else:
            a = (plghe if is_complex else plgsy)(cfg.n, seed=cfg.seed, **gkw)
        if cfg.uplo == "U":
            a = torch.tril(a).conj().mT.contiguous()
        return a

    def fresh_a():
        gkw = dict(bump=bump, seed=cfg.seed, dtype=dtype, device=device)
        if distributed:
            a = parallel.from_dense(dense_a().tril_(), layout, mesh)
        elif packed_pure:
            a = plgsy_packed(cfg.n, cfg.nb, **gkw)
        elif df64_pure:
            a = plgsy_packed(cfg.n, cfg.nb, **dict(gkw, dtype=torch.float32))
            a = (a, torch.zeros_like(a))
        elif df64_packed:
            a = tuple(pack_tri(x, cfg.nb) for x in dense_pair())
        elif df64:
            a = dense_pair()
        else:
            a = dense_a()
        sync()
        return a

    failed = []  # --checked: the message of a failed check

    def factor(a):
        if distributed:
            lx = parallel.potrf_block_cyclic(a, layout, mesh)
            return parallel.to_dense(lx, layout).tril_()
        if packed:
            ap = a if packed_pure else pack_tri(a, cfg.nb)
            return potrf_packed(ap, cfg.n, cfg.nb, trailing=args.trailing, **kw)
        if df64_packed:
            pkw = dict(ktb=min(512, cfg.nb), s=slices)
            if args.df64_split != 1:  # 0 auto-sizes, as the function documents
                return algos.potrf_packed_df64_split(*a, cfg.n, cfg.nb, split=args.df64_split,
                                                     **pkw)
            return algos.potrf_packed_df64(*a, cfg.n, cfg.nb, **pkw)
        if df64:
            return potrf_df64(*a, nb=cfg.nb, s=slices, trailing=args.trailing,
                              tb=min(512, cfg.nb))
        if args.checked:
            from dla_tpu_torch.validate.checked import potrf_checked

            err, l = potrf_checked(a, nb=cfg.nb)
            msg = err.get()  # the one host read of the three checks
            if msg:
                failed.append(msg)
            return l
        if cfg.mode == "masked":
            return potrf(a, nb=cfg.nb, mode="masked", uplo=cfg.uplo)
        if cfg.mode in ("blocked", "shrink"):
            return potrf(a, nb=cfg.nb, mode=cfg.mode, uplo=cfg.uplo, **kw)
        if cfg.uplo == "L":  # every input is fresh (``fresh_a``): factored in its own buffer
            return potrf_inplace(a, nb=cfg.nb, tb=tb, **kw)
        return potrf(a, nb=cfg.nb, mode="inplace", uplo=cfg.uplo, **kw)

    def timed():
        a = fresh_a()  # untimed: the factorization may mutate its input
        t0 = time.perf_counter()
        l = factor(a)
        sync()
        return l, time.perf_counter() - t0

    flops = potrf_flops(cfg.n)
    l, dt = timed()
    if failed:
        print(f"[dla-potrf] CHECK FAILED: {failed[0]}", flush=True)
        return 3
    print(f"Repeat 0: {dt * 1e3:.1f} ms {gflops(flops, dt):.2f} Gflop/s (warm-up)",
          flush=True)
    times = []
    for i in range(1, max(1, args.repeats) + 1):
        l = None  # free the previous factor before the next input exists
        l, dt = timed()
        times.append(dt)
        print(f"Repeat {i}: {dt * 1e3:.1f} ms {gflops(flops, dt):.2f} Gflop/s",
              flush=True)
    tmed = sorted(times)[len(times) // 2]
    print(f"Elapsed: {tmed * 1e3:.1f} ms")
    print(f"Performance: {gflops(flops, tmed):.2f} Gflop/s", flush=True)

    if not cfg.check and args.solve == "none":
        return 0
    if packed:
        rc = 0
        a = None if packed_pure else dense_a()
        if cfg.check and packed_pure:
            res = float(freivalds_packed(l, cfg.n, cfg.nb, seed=cfg.seed, bump=bump))
            print(f"freivalds ||(A - LL^T)x|| / (||A|| ||x||) = {res:.2e}")
            rc = _verdict(res, args.gate, cfg)
        elif cfg.check:  # a user's or another generator's matrix: the exact residual
            res = float(residual_potrf(a, unpack_tri(l, cfg.n, cfg.nb),
                                       assume_symmetric=host is None, assume_tril=True,
                                       row_chunk=_row_chunk(cfg.n)))
            print(f"||A - LL^T||_inf / ||A||_inf = {res:.2e}")
            rc = _verdict(res, args.gate, cfg)
        if args.solve != "none":
            if args.solve == "refined" and not packed_pure:
                print("[dla-potrf] --solve refined with --mode packed needs the plgsy "
                      "generator input")
                return 2
            rc = max(rc, _solve_packed(args, cfg, l, bump, device, sync, a))
        return rc
    if df64:
        a = None if df64_pure else dense_pair()
        sync()
        res = _df64_gate(a, l, cfg, bump, slices, device, df64_packed)
        return _verdict(res, args.gate, cfg)
    rc = 0
    a = None
    if cfg.check:
        chunk = _row_chunk(cfg.n)
        # The reference's choice (``dla_tpu/cli/potrf_driver.py:741-766``):
        # where the exact residual's operands do not fit the budget, validate
        # matrix-free, A regenerated from its seed. The budget is what the
        # device holds unless ``DLA_TPU_VALIDATE_HBM_BUDGET`` sets it.
        need = _residual_bytes(cfg.n, dtype, chunk)
        budget = int(os.environ.get("DLA_TPU_VALIDATE_HBM_BUDGET", _memory_bytes(device)))
        chunk_f = next((c for c in (4096, 2048, 1024, 512, 256, 128) if cfg.n % c == 0), None)
        if seeded and need > budget and chunk_f:
            from dla_tpu_torch.validate import freivalds_device

            res = float(freivalds_device(l, seed=cfg.seed, bump=bump, probes=2,
                                         row_chunk=chunk_f))
            print(f"freivalds ||(A - LL^T)x|| / (||A|| ||x||) = {res:.2e}")
        else:
            a = dense_a()
            av, lv = a, l
            if cfg.uplo == "U":  # through the lower contract: L = Uᴴ
                av, lv = torch.triu(a).conj().mT, l.conj().mT
            else:  # B: the lower half holds L
                lv = l = torch.tril(l)
            res = float(residual_potrf(av, lv, assume_symmetric=host is None and cfg.uplo != "U",
                                       assume_tril=cfg.uplo != "U", row_chunk=chunk))
            print(f"||A - LL^T||_inf / ||A||_inf = {res:.2e}")
        rc = _verdict(res, args.gate, cfg)
    if args.solve != "none":
        a = dense_a() if a is None else a
        if cfg.uplo == "U":  # the solvers' lower contract: tril(A) = triu(A)ᴴ, L = Uᴴ
            a, l = (torch.tril(x.mH).contiguous() for x in (a, l))
        rc = max(rc, _solve(args, cfg, a, l, bump, device, sync, seeded))
    return rc


def _row_chunk(n: int) -> int | None:
    """The residual's row chunk: 4096 from N=16384 on, where it divides N."""
    return 4096 if n >= 16384 and n % 4096 == 0 else None


def _solve(args, cfg, a, l, bump: float, device, sync, seeded: bool) -> int:
    """The reference driver's dense ``--solve`` branches
    (``dla_tpu/cli/potrf_driver.py:901-961``) on the input A and its factor
    L (only tril(L) is read): print the solve residual and ``SOLVE
    PASS``/``SOLVE FAIL``; the exit code. The refined solve takes tril(A) in
    fp64 from the native host generator where A is the seed's plgsy matrix
    (``seeded``), else tril(A) widened to fp64 where it lies (``:905-917``)."""
    import torch

    from dla_tpu_torch.algos import posv_refined, posv_refined_host, potri, potrs, solve_inverse
    from dla_tpu_torch.validate import residual_posv

    x64 = args.x64 or cfg.dtype in ("float64", "complex128")
    n = cfg.n
    if args.solve == "refined" and not x64:
        from dla_tpu_torch.runtime.staging import HostTileStore

        if seeded:  # regenerated in fp64 on the host: no N² pull off the card
            with HostTileStore(n, np.float64) as st:
                st.fill_plgsy(seed=cfg.seed, bump=bump)
                a64 = torch.from_numpy(np.tril(st.array))
            source = "A regenerated in fp64 by the native host generator"
        else:
            a64 = torch.tril(a).to(torch.float64)
            source = "tril(A) widened to fp64"
        b64 = torch.ones((n, args.nrhs), dtype=torch.float64, device=device)
        kwp = {}
        if cfg.mode in ("blocked", "shrink"):
            kwp = {"panel": args.panel, "trailing": args.trailing, "diag_factor": args.diag}
        t0 = time.perf_counter()
        _, serr, used = posv_refined_host(a64, b64, nb=cfg.nb, potrf_kwargs=kwp, device=device)
        sync()
        print(f"[dla-potrf] refined solve: {used} iterations, "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms (fp32 factor, fp64 residuals, on "
              f"{device.type}; {source})")
        sgate = args.gate if args.gate is not None else 1e-10
    else:
        b = torch.ones((n, args.nrhs), dtype=l.dtype, device=device)
        fp64 = cfg.dtype in ("float64", "complex128")  # as ``_gate``; JAX's: float64 only
        if args.solve == "refined":
            _, x, _ = posv_refined(a, b, nb=cfg.nb, factor_dtype=torch.float32)
            sgate = 1e-10
        else:
            x = solve_inverse(potri(l), b) if args.solve == "inverse" else potrs(l, b)
            sgate = args.gate if args.gate is not None else (1e-10 if fp64 else n * 2e-6)
        serr = float(residual_posv(a, b.to(x.dtype), x))
    return _solve_verdict(serr, sgate)


def _solve_packed(args, cfg, lp, bump: float, device, sync, a=None) -> int:
    """The reference driver's packed ``--solve potrs|inverse|refined``
    (``dla_tpu/cli/potrf_driver.py:828-900``) from the packed factor ``lp``
    (overwritten by ``inverse``): ``--nrhs`` right-hand sides of ones, the
    solve timed, its residual and ``SOLVE PASS``/``SOLVE FAIL``; the exit
    code. ``refined`` is ``posv_refined_streamed`` with ``potrs_packed`` as
    its correction solve: A is materialized nowhere, its fp64 residuals
    stream A from the native host generator. With a dense ``a`` (the input
    is not the seed's plgsy matrix) the residual is ``residual_posv``
    against it, as the reference's."""
    import torch

    from dla_tpu_torch.algos import (
        posv_refined_streamed,
        potri_packed,
        potrs_packed,
        residual_posv_streamed,
        solve_inverse_packed,
    )

    n, nb = cfg.n, cfg.nb
    if args.solve == "refined":
        t0 = time.perf_counter()
        _, serr, used = posv_refined_streamed(
            lp, np.ones((n, args.nrhs)), seed=cfg.seed, bump=bump, n=n, panel=min(4096, nb),
            solver=lambda r: potrs_packed(lp, r, n, nb))
        print(f"[dla-potrf] refined solve: {used} iterations, "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms (packed low-precision factor on "
              f"{device.type}, fp64 residuals streamed on the host, nrhs={args.nrhs})")
        return _solve_verdict(serr, args.gate if args.gate is not None else 1e-10)
    ct = torch.float32 if lp.dtype == torch.bfloat16 else lp.dtype
    b = torch.ones((n, args.nrhs), dtype=ct, device=device)
    sync()
    t0 = time.perf_counter()
    if args.solve == "inverse":
        sp = potri_packed(lp, n, nb)
        sync()
        t1 = time.perf_counter()
        x = solve_inverse_packed(sp, b, n, nb)
        sync()
        t2 = time.perf_counter()
        print(f"[dla-potrf] potri_packed {(t1 - t0) * 1e3:.1f} ms, solve_inverse_packed "
              f"{(t2 - t1) * 1e3:.1f} ms (nrhs={args.nrhs})")
    else:
        x = potrs_packed(lp, b, n, nb)
        sync()
        print(f"[dla-potrf] potrs_packed {(time.perf_counter() - t0) * 1e3:.1f} ms "
              f"(nrhs={args.nrhs})")
    if a is None:
        serr = float(residual_posv_streamed(x, b, n, seed=cfg.seed, bump=bump))
    else:
        from dla_tpu_torch.validate import residual_posv

        serr = float(residual_posv(a, b.to(x.dtype), x))
    sgate = args.gate if args.gate is not None else (
        1e-10 if cfg.dtype in ("float64", "complex128") else n * 2e-6)
    return _solve_verdict(serr, sgate)


def _solve_verdict(serr: float, sgate: float) -> int:
    """Print the solve residual and SOLVE PASS/FAIL against the gate; the
    exit code."""
    print(f"||B - A X||_inf / (||A||_inf ||X||_inf) = {serr:.2e}")
    if serr < sgate:  # False for NaN
        print(f"SOLVE PASS (residual < {sgate:g})", flush=True)
        return 0
    print(f"SOLVE FAIL (residual >= {sgate:g})", flush=True)
    return 1


def _residual_bytes(n: int, dtype, row_chunk: int | None) -> int:
    """What ``residual_potrf`` of a generated A and tril(L) holds on the
    device. Not the reference's 3·N² elements: A and tril(L) in the storage
    dtype and, unless that is fp64 or bf16 storage takes the row-chunked form,
    whole fp64 (complex128) copies of both beside them."""
    import torch

    wide = 16 if dtype.is_complex else 8
    widened = dtype.itemsize < wide and not (row_chunk and dtype == torch.bfloat16)
    return (2 * dtype.itemsize + (2 * wide if widened else 0)) * n * n


def _memory_bytes(device) -> int:
    """What this process can hold on ``device``: the card's free memory plus
    what its allocator already reserves, or the host's physical memory."""
    import torch

    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0] + torch.cuda.memory_reserved(device)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


_NP_DTYPES = {"float64": np.float64, "float32": np.float32, "bfloat16": np.uint16,
              "complex64": np.complex64, "complex128": np.complex128}


def _read_matrix(path: str, cfg, adopt_n: bool):
    """The user's matrix of the dense and packed modes, checked as the
    reference checks it (``dla_tpu/cli/potrf_driver.py:273-314``): ``.npy``,
    ``.npz`` (array ``a`` or the first) or raw ``--dtype`` binary. A square
    file sets N when ``adopt_n`` (no ``--n``). Returns an (N, N) numpy array,
    or None after printing why (not square, the wrong size, not finite,
    complex into a real dtype): exit code 2. Raw bf16 is read as its bit
    patterns (numpy has no bf16) and widened to fp32."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            host = z["a" if "a" in z.files else z.files[0]]
    elif path.endswith(".npy"):
        host = np.load(path)
    else:
        host = np.fromfile(path, dtype=_NP_DTYPES[cfg.dtype])
        if cfg.dtype == "bfloat16":
            import torch

            host = torch.from_numpy(host.view(np.int16)).view(torch.bfloat16).float().numpy()
    n = cfg.n
    if host.ndim == 2:
        if host.shape[0] != host.shape[1]:
            print(f"[dla-potrf] input matrix is {host.shape}, expected square", flush=True)
            return None
        if adopt_n:
            n = host.shape[0]
    if host.size != n * n:
        print(f"[dla-potrf] input has {host.size} elements, expected {n}*{n}", flush=True)
        return None
    if not np.all(np.isfinite(host)):
        print("[dla-potrf] input contains non-finite entries", flush=True)
        return None
    if host.ndim == 2 and host.dtype.kind == "c" and not cfg.dtype.startswith("complex"):
        print(f"[dla-potrf] input dtype {host.dtype} cannot feed a {cfg.dtype} run "
              "(complex→real)", flush=True)
        return None
    if host.dtype.itemsize > np.dtype(_NP_DTYPES[cfg.dtype]).itemsize:
        print(f"[dla-potrf] note: narrowing input {host.dtype} -> {cfg.dtype}", flush=True)
    return host.reshape(n, n)


def _to_tensor(host, dtype, device):
    """A fresh tensor of ``dtype`` on ``device`` holding the numpy matrix."""
    import torch

    if dtype == torch.bfloat16:
        return torch.from_numpy(host.astype(np.float32)).to(device=device, dtype=dtype)
    return torch.from_numpy(host.astype(_NP_DTYPES[str(dtype).removeprefix("torch.")])).to(device)


def _load_input(path: str, n: int):
    """The user's matrix as the reference's df64 modes read it
    (``dla_tpu/cli/potrf_driver.py:436-449``): fp64, N×N, reflected from its
    lower triangle so that A is bit-level symmetric (the blocked df64 residual
    assumes it). None, with a message, when the file does not hold N·N finite
    elements."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            a64 = z["a" if "a" in z.files else z.files[0]]
    elif path.endswith(".npy"):
        a64 = np.load(path)
    else:
        a64 = np.fromfile(path, np.float64)
    a64 = np.asarray(a64, np.float64)
    if a64.size != n * n:
        print(f"[dla-potrf] input has {a64.size} elements, expected {n}*{n}", file=sys.stderr)
        return None
    if not np.all(np.isfinite(a64)):
        print("[dla-potrf] input contains non-finite entries", file=sys.stderr)
        return None
    a64 = a64.reshape(n, n)
    return np.tril(a64) + np.tril(a64, -1).T


def _df64_gate(a, l, cfg, bump: float, slices: int, device, packed: bool) -> float:
    """Evaluate and print the df64 gate as the reference driver picks it
    (``dla_tpu/cli/potrf_driver.py:644-740``). ``a`` is the dense (hi, lo)
    input, or None on the pure packed path, whose A is regenerated from its
    seed; ``l`` the factor pair, packed when ``packed``.

    The budget is what the device holds (:func:`_memory_bytes`) unless
    ``DLA_TPU_VALIDATE_HBM_BUDGET`` sets it. A packed factor is unpacked (and,
    on the pure path, A regenerated in fp32) for the dense gates when the
    packed pair, the unpacked pair and A fit the budget together; where they
    do not, the pure path certifies straight off the packed pair
    (``freivalds_packed_df64``, A streamed from its seed). The dense gates:
    the strip residual up to ``DLA_TPU_DF64_STRIP_RESIDUAL_MAX`` (8192), above
    it the blocked residual when its working set (both pairs and two strips of
    slices) fits, else, or when it runs out of memory, the streaming Freivalds
    gate."""
    import torch

    import dla_tpu_torch.algos as algos
    from dla_tpu_torch.algos.potrf_df64 import freivalds_packed_df64
    from dla_tpu_torch.ops import plgsy

    n = cfg.n
    budget = int(os.environ.get("DLA_TPU_VALIDATE_HBM_BUDGET", _memory_bytes(device)))
    lh, ll = l
    ah, al = a if a is not None else (None, None)
    if packed:
        if ah is None and 4 * 4 * n * n > budget:  # packed pair + unpacked pair + A
            res = float(freivalds_packed_df64(lh, ll, n, cfg.nb, gen_seed=cfg.seed, bump=bump,
                                              s=slices, row_chunk=min(1024, n)))
            print(f"freivalds ||(A - LL^T)x|| / (||A|| ||x||) = {res:.2e}")
            return res
        lh = algos.unpack_tri(lh, n, cfg.nb)
        ll = algos.unpack_tri(ll, n, cfg.nb)
        if ah is None:  # exactly fp32: no lo plane
            ah = plgsy(n, bump=bump, seed=cfg.seed, dtype=torch.float32, device=device)
    rc = 2048
    need = (3 if al is None else 4) * 4 * n * n + 4 * slices * rc * n
    strip_max = int(os.environ.get("DLA_TPU_DF64_STRIP_RESIDUAL_MAX", 8192))

    def freivalds():
        r = float(algos.freivalds_potrf_df64(lh, ll, ah, al, s=slices, seed=cfg.seed))
        print(f"freivalds ||(A - LL^T)x|| / (||A|| ||x||) = {r:.2e}")
        return r

    if n <= strip_max:
        res = float(algos.residual_potrf_df64(ah, torch.zeros_like(ah) if al is None else al,
                                              lh, ll, s=slices))
    elif need > budget:
        return freivalds()
    else:
        try:  # `need` leaves out the rc×rc transients
            res = algos.residual_potrf_df64_blocked(ah, al, lh, ll, s=slices, rc=min(rc, n))
        except torch.cuda.OutOfMemoryError:
            print("[dla-potrf] blocked residual out of memory; falling back to streaming "
                  "Freivalds")
            return freivalds()
    print(f"||A - LL^T||_inf / ||A||_inf = {res:.2e}")
    return res


def _verdict(res: float, gate: float | None, cfg) -> int:
    """Print PASS/FAIL against the gate; the exit code."""
    gate = gate if gate is not None else _gate(cfg.n, cfg.dtype)
    if res < gate:  # False for NaN
        print(f"PASS (residual < {gate:g})", flush=True)
        return 0
    print(f"FAIL (residual >= {gate:g})", flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
