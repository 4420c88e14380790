"""Two builds of one kernel side by side on one GPU.

    python -m dla_tpu_torch.bench.kernel_ab --other DIR
        --entry lower|packed|df64|packed_df64|potrf_tile|panel_factor|ring|tile_ops|panel_apply
        [--tier high|default|highest] [--dtype f32|f64|bf16] [--iters 3]

``DIR`` holds another version of the kernel sources (the entry's ``.cu`` and
the headers it includes), for example an earlier commit's
``dla_tpu_torch/kernels/csrc`` unpacked with ``git archive`` into a directory
that git ignores. Both versions of the entry's source are compiled with the
package's flags (plus ``-Xptxas -v``, whose register, spill and
shared-memory counts are printed), and the C entry of each is launched on
the same inputs at its path's shape, in turns: other, this, this, other.

- ``lower``: ``dla_trailing_lower_<dtype>`` (kernel #1) at the main path's
  first update, m=16384, nb=tb=1024, origin 0;
- ``packed``: ``dla_trailing_packed_<dtype>`` (kernel #2) at the packed
  path's first update, n=81920, w=4096, ktb=1024, k=0 (fp64: n=32768, as
  ``chip_smoke.py`` phase 6; ``--n``, ``--k``);
  for both, the block body each build ran (its own count of launches per
  body), and the exit code is 1 where fp32 ``highest`` or fp64 gives other
  bits in the two builds (both sum one fma chain per element in ascending k);
- ``df64``: ``dla_trailing_df64`` (kernel #9) at the f64x path's, m=24576,
  tb=512, nb=1024, s=7, w=8, origin 0 (``--tier`` and ``--dtype`` unused);
- ``packed_df64``: ``dla_trailing_packed_df64`` (kernel #10) at the packed
  df64 path's first update, n=40960, nb=1024, tb=512, s=7, w=8, k=0 (``--n``,
  ``--k``; a 6.9 GB pair, each launch on a fresh copy);
- ``potrf_tile``: ``dla_potrf_tile_<dtype>`` (kernel #5, ``(a, l, linv, n,
  lda, tier, stream)``) at the tile-task path's n=512, on an SPD tile with
  NaN above its diagonal, and
- ``panel_factor``: ``dla_panel_factor_<dtype>`` (kernel #4) at the
  ``panel_factor`` path's first panel, m=32768, nb=512; for both, every
  tier in one call (fp32 ``highest``, ``high``, ``default``, fp64;
  ``--tier`` and ``--dtype`` unused), and this build's schedule (launches
  and the largest grid of ``diag_block.cuh``);
- ``ring``: ``dla_ring_launch`` (kernels #11 and #12, ``ring.cu``) at the
  shapes of ``chip_smoke.py`` phase 29, fp64 on D=4 members: the broadcast
  of the planes' largest panel (15360 × 1024, C=48) and of the factor tile
  (1024 × 1024, C=32), the tile in two sub-rings (roots 0 and 1), and the
  all-gather of the tile with group 4 and 2. Each build is called through
  its own C signature (one whose protocol forwards through comm slots gets
  its slots, allocated beforehand); each case's two outputs must have the
  same bits, and those of the plain version. A ring time is the mean of 10
  launches queued behind a sleeping kernel: the card's time, without the
  host's enqueue between launches;
- ``tile_ops``: ``dla_<op>_tile_<dtype>`` (kernels #6, #7, #8) at 512³,
  256³ and m=4096, n=k=2048 (#7: m=n), fp32 ``high``, ``default``,
  ``highest``, fp64 and bf16 in one call (``--tier`` and ``--dtype``
  unused), with the block body each build ran (its own count of launches
  per body) and each case's largest difference to the plain version, and
  each build's card time alone, 20 launches queued behind a sleeping
  kernel. The exit code is 1 where a case leaves its tolerance or
  where this build runs the scalar body or a chain body (fp32 ``highest``,
  fp64: one fma chain per element, the scalar body's bits) and the two
  builds' bits differ; the last line also says whether every case gave the
  same bits in both builds;
- ``panel_apply``: ``dla_panel_apply_f32`` (kernel #3) at the ``panel_apply``
  path's first panel, m=15360, nb=1024, ib=256, every fp32 tier in one call,
  with the body of this build, the largest difference between the builds and
  to the plain version (1e-4 of max|X| at ``high`` and ``highest``, 2^-6 at
  ``default``), and this build's launches per call.

A version whose C entry takes a split scratch (the tensor-core body's) gets
one, sized by ``tiles.split_planes`` (``panel.panel_apply_schedule`` for
#3); an older one is called without. Prints
each launch's time by CUDA events, the largest difference between the two
outputs (df64, packed_df64, potrf_tile, panel_factor: whether they give the same bits,
which they must; the exit code is 1 when they do not), and the card's name
and power limit. Two versions are only comparable inside one such call.

It needs a CUDA device and ``nvcc`` and fails without them.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

SOURCE = {"lower": "trailing_lower.cu", "packed": ("trailing_packed.cu", "trailing_lower.cu"),
          "df64": "trailing_df64.cu", "packed_df64": "trailing_packed_df64.cu",
          "potrf_tile": "potrf_tile.cu",
          "panel_factor": "panel_factor.cu", "ring": "ring.cu", "tile_ops": "tile_ops.cu",
          "panel_apply": "panel_apply.cu"}
RING_CASES = [  # (kind, m, root, group) on D=4 fp64 members of 1024 columns
    ("broadcast", 15360, 1, 4), ("broadcast", 1024, 1, 4), ("broadcast", 1024, 0, 2),
    ("broadcast", 1024, 1, 2), ("gather", 1024, 0, 4), ("gather", 1024, 0, 2)]
DIAG_TIERS = [("f32", "highest"), ("f32", "high"), ("f32", "default"), ("f64", "high")]
DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}
TILE_CASES = [(512, 512, 512), (256, 256, 256), (4096, 2048, 2048)]  # (m, n, k)
TILE_TIERS = [("f32", "high"), ("f32", "default"), ("f32", "highest"), ("f64", "high"),
              ("bf16", "high")]
PANEL_APPLY_CASE = (15360, 1024, 256)  # (m, nb, ib)


def _build_lib(csrc: Path, out: Path, entry: str) -> ctypes.CDLL:
    """Build ``csrc``'s source of ``entry`` into ``out``, printing ptxas's
    register, spill and shared-memory counts."""
    from dla_tpu_torch.kernels import _build

    srcs = SOURCE[entry] if isinstance(SOURCE[entry], tuple) else (SOURCE[entry],)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(out),
           *(str(csrc / src) for src in srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  {csrc}: {line.strip()}")
    return ctypes.CDLL(str(out))


def _bodies(lib, csrc: Path):
    """A build's launches of the trailing kernels per block body (None where
    the build has no such count): ``{"simt", "wgmma", "dmma"}`` where its
    chain bodies exist, else ``{"scalar", "wgmma"}``."""
    fn = getattr(lib, "dla_trailing_body_launches", None)
    if fn is None:
        return None
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    chain = (csrc / "trailing_chain.cuh").exists()
    names = ("simt", "wgmma", "dmma") if chain else ("scalar", "wgmma")
    return lambda: {name: fn(i) for i, name in enumerate(names)}


def _compile(csrc: Path, out: Path, entry: str, symbol: str):
    """Build ``csrc``'s source of ``entry`` into ``out``; the C function,
    whether it takes a split scratch, and its body counts (trailing kernels)."""
    src = csrc / (SOURCE[entry][0] if isinstance(SOURCE[entry], tuple) else SOURCE[entry])
    lib = _build_lib(csrc, out, entry)
    fn = getattr(lib, symbol)
    df64 = entry in ("df64", "packed_df64")
    scratch = not df64 and "void* scratch" in src.read_text()
    if df64:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
                       + [ctypes.c_longlong] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    elif scratch:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 7 + [ctypes.c_int,
                                                                          ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 6 + [ctypes.c_int,
                                                                          ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, scratch, _bodies(lib, csrc)


def _df64_case(m, stream):
    """The f64x path's update: (inputs to clone, launch(fn, scratch, outs))."""
    from dla_tpu_torch.ops.df64 import slice_rows, to_df64

    tb, nb, s = 512, 1024, 7
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(m)
    ch, cl = to_df64(torch.randn(m, m, generator=g, device=dev, dtype=torch.float64))
    sx = slice_rows(*to_df64(torch.randn(m, nb, generator=g, device=dev, dtype=torch.float64)),
                    s=s, w=8)[0]
    ptrs = (ctypes.c_void_p * s)(*[x.data_ptr() for x in sx])

    def launch(fn, _scratch, outs):
        h, l = outs
        return fn(h.data_ptr(), l.data_ptr(), ptrs, m, nb, m, nb, 0, tb, nb, s, 3, stream)

    return (ch, cl), launch, f"m={m} tb={tb} nb={nb} s={s}"


def _packed_df64_case(n, k, stream):
    """The packed df64 path's update at step k: (inputs to clone, launch(fn,
    scratch, outs))."""
    from dla_tpu_torch.algos.packed import packed_rows
    from dla_tpu_torch.ops.df64 import slice_rows, to_df64

    tb, nb, s = 512, 1024, 7
    m, base = n - (k + 1) * nb, (k + 1) * nb
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n + k)
    ph, pl = to_df64(torch.randn(packed_rows(n, nb), nb, generator=g, device=dev,
                                 dtype=torch.float64))
    sx = slice_rows(*to_df64(torch.randn(m, nb, generator=g, device=dev, dtype=torch.float64)),
                    s=s, w=8)[0]
    ptrs = (ctypes.c_void_p * s)(*[x.data_ptr() for x in sx])

    def launch(fn, _scratch, outs):
        h, l = outs
        return fn(h.data_ptr(), l.data_ptr(), ptrs, m, nb, nb, base, n // nb, tb, nb, s, 3,
                  stream)

    return (ph, pl), launch, f"n={n} nb={nb} tb={tb} s={s} k={k}"


def _trailing_case(entry, dtype, tier_name, stream, n=None, k=0):
    """The lower or packed path's first update at ``tier_name``; packed at
    (n, k), by default phase 6's n (81920, fp64 32768) and k = 0."""
    from dla_tpu_torch.algos.packed import packed_rows
    from dla_tpu_torch.kernels import tiles

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(51)
    if entry == "lower":
        m, tb, nb = 16384, 1024, 1024
        c = torch.randn(m, m, generator=g, device=dev).to(dtype)
        p = torch.randn(m, nb, generator=g, device=dev).to(dtype)
        ints = (m, nb, m, nb, 0, tb)
        name = f"m={m} nb=tb={tb} origin 0"
    else:
        w, tb = 4096, 1024
        n = n or (32768 if dtype == torch.float64 else 81920)
        base = (k + 1) * w
        c = torch.randn(packed_rows(n, w), w, generator=g, device=dev).to(dtype)
        p = torch.randn(n - base, w, generator=g, device=dev).to(dtype)
        ints = (n - base, w, w, base, n // w, tb)
        name = f"n={n} w={w} ktb={tb} k={k}"
    planes = tiles.split_planes(dtype, tier_name)
    code = tiles._TIER_CODE[tier_name]

    def launch(fn, scratch, outs):
        (out,) = outs
        if not scratch:
            return fn(out.data_ptr(), p.data_ptr(), *ints, code, stream)
        buf = tiles._split_scratch(p, planes)
        nbytes = 0 if buf is None else buf.numel() * buf.element_size()
        return fn(out.data_ptr(), p.data_ptr(), None if buf is None else buf.data_ptr(), *ints,
                  nbytes, code, stream)

    scale = (p.double() ** 2).sum(1).max().item()
    return (c,), launch, f"{name} {str(dtype)[6:]}/{tier_name}", scale


def _diag_ab(args, card: str) -> int:
    """#5 or #4 of two builds at every tier: times and whether the bits agree."""
    from dla_tpu_torch.kernels import _build, tiles

    dev, stream = torch.device("cuda"), torch.cuda.current_stream().cuda_stream
    n = 512
    m = 32768 if args.entry == "panel_factor" else n
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"other": _build_lib(Path(args.other), Path(tmp) / "other.so", args.entry),
                "this": _build_lib(_build.CSRC, Path(tmp) / "this.so", args.entry)}
        if args.entry == "potrf_tile":
            launches, blocks = ctypes.c_int(), ctypes.c_int()
            libs["this"].dla_diag_schedule(ctypes.c_longlong(n), ctypes.byref(launches),
                                           ctypes.byref(blocks))
            print(f"this build's schedule at n={n}: {launches.value} launches, up to "
                  f"{blocks.value} blocks a launch")
        for sfx, tier_name in DIAG_TIERS:
            dtype = DTYPES[sfx]
            g = torch.Generator(device=dev).manual_seed(m + n)
            a = torch.randn(m, n, generator=g, device=dev, dtype=torch.float64)
            a[:n] = a[:n] @ a[:n].mT + n * torch.eye(n, device=dev, dtype=torch.float64)
            a = a.to(dtype)
            a[:n] += torch.triu(torch.full((n, n), float("nan"), device=dev, dtype=dtype), 1)
            code = tiles._TIER_CODE[tier_name]
            outs, times = {}, {"other": [], "this": []}
            for version in ["other", "this", "this", "other"] * args.iters:
                if args.entry == "potrf_tile":
                    out = (torch.empty(n, n, device=dev, dtype=dtype),
                           torch.empty(n, n, device=dev, dtype=dtype))
                    fn = getattr(libs[version], f"dla_potrf_tile_{sfx}")
                    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
                        ctypes.c_int, ctypes.c_void_p]
                    ints = (n, n)
                else:
                    out = (torch.empty(m, n, device=dev, dtype=dtype),
                           torch.empty(n, n, device=dev, dtype=dtype))
                    fn = getattr(libs[version], f"dla_panel_factor_{sfx}")
                    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
                        ctypes.c_int, ctypes.c_void_p]
                    ints = (m, n, n)
                fn.restype = ctypes.c_int
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                err = fn(a.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), *ints, code, stream)
                t1.record()
                t1.synchronize()
                if err:
                    raise RuntimeError(f"{version}: CUDA error {err}")
                times[version].append(t0.elapsed_time(t1))
                outs[version] = out
            view = torch.int32 if dtype == torch.float32 else torch.int64
            same = all(torch.equal(x.view(view), y.view(view))
                       for x, y in zip(outs["other"], outs["this"]))
            ok = ok and same
            med = {v: sorted(ts[1:])[len(ts[1:]) // 2] for v, ts in times.items()}
            print(f"{args.entry} m={m} n={n} {sfx}/{tier_name}: same bits {same}; other median "
                  f"{med['other']:.4f} ms of {[round(t, 4) for t in times['other']]}, this median "
                  f"{med['this']:.4f} ms of {[round(t, 4) for t in times['this']]} [{card}]",
                  flush=True)
    print(f"{args.entry}: every tier bit-identical: {ok} [{card}]")
    return 0 if ok else 1


def _queued_ms(launch, n: int = 10) -> float:
    """Mean card time of ``n`` launches queued behind a sleeping kernel, so
    that the host's enqueue between them is hidden (a short ring launch takes
    about as long on the card as its own enqueue)."""
    torch.cuda._sleep(50_000_000)  # ≈ 25 ms at the H100's clock: the launches queue behind it
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        err = launch()
        if err:
            raise RuntimeError(f"CUDA error {err}")
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / n


def _ring_launcher(lib, slots: bool):
    """prepare(xs, outs, gather, group, root, chunks) -> launch() -> CUDA
    error, through the build's own C signature; each build keeps its flags
    and epoch. A build without comm slots is called as the wrapper calls it
    (``collectives._call``); one whose hops forward through comm slots gets
    them, allocated beforehand."""
    from dla_tpu_torch.kernels import collectives as C

    dev = torch.device("cuda")
    flags = C._new_flags(dev)
    if not slots:
        fn = C._bind(lib.dla_ring_launch)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count

        def prepare(xs, outs, gather, group, root, chunks):
            plan = C.ring_plan(gather=gather, ndev=len(xs), group=group, chunks=chunks,
                               block_bytes=xs[0].numel() * xs[0].element_size(), sms=sms)

            def launch():
                return C._call(fn, flags, xs, outs, gather=gather, group=group, root=root,
                               plan=plan)
            launch.plan = plan
            return launch
        return prepare

    fn = lib.dla_ring_launch  # (gather, ndev, group, root, chunks, steps, xs, outs, comms, ...)
    fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                   + [ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def prepare(xs, outs, gather, group, root, chunks):
        ndev = len(xs)
        ptrs = ctypes.c_void_p * ndev
        xp, op = ptrs(*(x.data_ptr() for x in xs)), ptrs(*(o.data_ptr() for o in outs))
        chunk_bytes = xs[0].numel() * xs[0].element_size() // (1 if gather else chunks)
        steps = group - 1 if gather else chunks + group - 2
        comm = [torch.empty(2 * (-(-chunk_bytes // 16) * 16), dtype=torch.uint8, device=dev)
                for _ in range(ndev)]
        cp = ptrs(*(c.data_ptr() for c in comm))

        def launch():
            err = fn(int(gather), ndev, group, root, chunks, steps, xp, op, cp,
                     flags[0].data_ptr(), C._FLAG_WORDS, chunk_bytes, flags[1], 0, stream)
            flags[1] += steps + 1
            return err
        launch.keep = comm
        return launch
    return prepare


def _ring_ab(args, card: str) -> int:
    """#11 and #12 of two builds at phase 29's shapes: times, and whether the
    bits agree with each other and with the plain version."""
    from dla_tpu_torch.kernels import _build
    from dla_tpu_torch.kernels import collectives as C

    dev, ndev, n = torch.device("cuda"), 4, 1024
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        preps = {}
        for version, csrc in (("other", Path(args.other)), ("this", _build.CSRC)):
            lib = _build_lib(csrc, Path(tmp) / f"{version}.so", "ring")
            slots = "void* const* comms" in (csrc / SOURCE["ring"]).read_text()
            preps[version] = _ring_launcher(lib, slots)
        for kind, m, root, group in RING_CASES:
            gather = kind == "gather"
            g = torch.Generator(device=dev).manual_seed(m + n + ndev)
            xs = [torch.randn(m, n, generator=g, device=dev, dtype=torch.float64)
                  for _ in range(ndev)]
            chunks = 1 if gather else C.broadcast_chunks(m, group)
            rows = group * m if gather else m
            outs = {v: [torch.empty(rows, n, device=dev, dtype=torch.float64) for _ in xs]
                    for v in preps}
            launches = {v: preps[v](xs, outs[v], gather, group, root, chunks) for v in preps}
            times = {"other": [], "this": []}
            for version in ["other", "this", "this", "other"] * args.iters:
                times[version].append(_queued_ms(launches[version]))
            ref = (C.ring_all_gather_plain(xs, group=group) if gather
                   else C.ring_broadcast_plain(xs, root, group=group, chunks=chunks))
            bits = lambda t: t.view(torch.int64)  # noqa: E731
            same = all(torch.equal(bits(a), bits(b)) for a, b in zip(outs["other"], outs["this"]))
            plain = all(torch.equal(bits(a), bits(b)) for a, b in zip(outs["this"], ref))
            ok = ok and same and plain
            med = {v: sorted(ts[1:])[len(ts[1:]) // 2] for v, ts in times.items()}
            label = f"group={group}" + ("" if gather else f" root={root} chunks={chunks}")
            print(f"ring {kind} D={ndev} {m}x{n} fp64 {label}: same bits {same}, plain's bits "
                  f"{plain}; other median {med['other']:.4f} ms of "
                  f"{[round(t, 4) for t in times['other']]}, this median {med['this']:.4f} ms "
                  f"of {[round(t, 4) for t in times['this']]}, x{med['other'] / med['this']:.2f}; "
                  f"this build's {getattr(launches['this'], 'plan', 'slots')} [{card}]",
                  flush=True)
            del xs, outs, launches, ref
            torch.cuda.empty_cache()
    print(f"ring: every case bit-identical to the other build and to the plain version: {ok} "
          f"[{card}]")
    return 0 if ok else 1


def _tile_launcher(lib, op: str, sfx: str, scratch: bool):
    """launch(c, a, b, out, tier) -> CUDA error through the build's own C
    signature of ``dla_<op>_tile_<sfx>``; one that takes a split scratch gets
    one, allocated once here per shape."""
    from dla_tpu_torch.kernels import tiles

    fn = getattr(lib, f"dla_{op}_tile_{sfx}")
    npointers, nints = (5, 7) if scratch else (4, 6)
    fn.argtypes = [ctypes.c_void_p] * npointers + [ctypes.c_longlong] * nints + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    bufs = {}

    def launch(c, a, b, out, tier_name):
        m, n, k = a.shape[0], b.shape[0], a.shape[1]
        ptrs = (None if c is None else c.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr())
        ints = (m, n, k, 0 if c is None else c.stride(0), a.stride(0), b.stride(0))
        code = tiles._TIER_CODE[tier_name]
        if not scratch:
            return fn(*ptrs, *ints, code, stream)
        planes = tiles.tile_op_planes(op, a.dtype, tier_name)
        key = (m, n, k, planes)
        if key not in bufs:
            bufs.clear()
            bufs[key] = tiles._pair_scratch(m, n, k, planes, a.device)
        buf = bufs[key]
        nbytes = 0 if buf is None else buf.numel() * buf.element_size()
        return fn(*ptrs[:4], None if buf is None else buf.data_ptr(), *ints, nbytes, code, stream)
    return launch


def _tile_bodies(lib):
    """A build's launches of the task kernels per block body: ``{"scalar",
    "wgmma", "simt", "dmma"}`` where it has the chain bodies (and their
    reference entry), else ``{"scalar", "wgmma"}``."""
    fn = lib.dla_tile_body_launches
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    chain = hasattr(lib, "dla_tile_op_scalar_f32")
    names = ("scalar", "wgmma", "simt", "dmma") if chain else ("scalar", "wgmma")
    return lambda: {name: fn(i) for i, name in enumerate(names)}


def _tile_ab(args, card: str) -> int:
    """#6 to #8 of two builds: times, the bodies, and the largest differences."""
    from dla_tpu_torch.kernels import _build, tiles
    from dla_tpu_torch.utils import precision

    dev = torch.device("cuda")
    ok = all_same = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for version, csrc in (("other", Path(args.other)), ("this", _build.CSRC)):
            scratch = "void* scratch" in (csrc / SOURCE["tile_ops"]).read_text()
            libs[version] = (_build_lib(csrc, Path(tmp) / f"{version}.so", "tile_ops"), scratch)
        for op in ("trsm", "syrk", "gemm"):
            for m, n, k in TILE_CASES:
                k = n if op == "trsm" else k
                m = n if op == "syrk" else m
                for sfx, tier_name in TILE_TIERS:
                    dtype = DTYPES[sfx]
                    g = torch.Generator(device=dev).manual_seed(m + 3 * n + 7 * k)
                    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)  # noqa: E731
                    if op == "trsm":  # trsm_tile(linv (n, n), b (m, n)): a = b, b = linv
                        c, a, b = None, rnd(m, n), torch.tril(rnd(n, n))
                    elif op == "syrk":  # syrk_tile(c (n, n), a (n, k)): b = a
                        c, a = rnd(n, n), rnd(n, k)
                        b = a
                    else:
                        c, a, b = rnd(m, n), rnd(m, k), rnd(n, k)
                    launch = {v: _tile_launcher(lib, op, sfx, sc) for v, (lib, sc) in libs.items()}
                    counts = {v: _tile_bodies(lib) for v, (lib, _) in libs.items()}
                    reps = 20 if m <= 512 else 1
                    outs, times, ran = {}, {"other": [], "this": []}, {}
                    queued = {"other": [], "this": []}
                    for version in ["other", "this", "this", "other"] * args.iters:
                        out = torch.empty(m, n, device=dev, dtype=dtype)

                        def call():
                            err = launch[version](c, a, b, out, tier_name)  # noqa: B023
                            if err:
                                raise RuntimeError(f"{version}: CUDA error {err}")  # noqa: B023

                        before = counts[version]()
                        t0 = torch.cuda.Event(enable_timing=True)
                        t1 = torch.cuda.Event(enable_timing=True)
                        t0.record()
                        for _ in range(reps):
                            call()
                        t1.record()
                        t1.synchronize()
                        after = counts[version]()
                        ran[version] = [x for x in after if after[x] != before[x]]
                        times[version].append(t0.elapsed_time(t1) / reps)
                        queued[version].append(_queued_ms(call, 20))
                        outs[version] = out
                    with precision.override(tier_name):
                        ref = (tiles.trsm_tile_plain(b, a) if op == "trsm" else
                               tiles.syrk_tile_plain(c, a) if op == "syrk" else
                               tiles.gemm_tile_plain(c, a, b))
                    scale = (a.double().norm(dim=1).max() * b.double().norm(dim=1).max()).item()
                    tol = {torch.float64: 1e-12 * scale, torch.float32: 1e-5 * scale}.get(
                        dtype, 2**-6 * ((0.0 if c is None else c.double().abs().max().item())
                                        + scale))
                    diff = (outs["this"].double() - outs["other"].double()).abs().max().item()
                    err = (outs["this"].double() - ref.double()).abs().max().item()
                    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[out.element_size()]
                    same = torch.equal(outs["this"].view(view), outs["other"].view(view))
                    body = tiles.tile_op_body(op, dtype, tier_name)
                    good = err <= tol and (same or body == "wgmma")
                    ok = ok and good
                    all_same = all_same and same
                    med = {v: sorted(ts[1:])[len(ts[1:]) // 2] for v, ts in times.items()}
                    card_ms = "".join(
                        f", {v} queued median {sorted(q)[len(q) // 2]:.4f} ms of "
                        f"{[round(t, 4) for t in q]}" for v, q in queued.items() if q)
                    print(f"{op}_tile m={m} n={n} k={k} {sfx}/{tier_name}: other body "
                          f"{ran['other']}, this body {ran['this']} (table: {body}); "
                          f"max |this - other| {diff:.3e}, same bits {same}; max |this - plain| "
                          f"{err:.3e} (tol {tol:.3e}){'' if good else ' FAILED'}; other median "
                          f"{med['other']:.4f} ms of {[round(t, 4) for t in times['other']]}, "
                          f"this median {med['this']:.4f} ms of "
                          f"{[round(t, 4) for t in times['this']]}, "
                          f"x{med['other'] / med['this']:.2f}{card_ms} [{card}]", flush=True)
                    del c, a, b, outs, ref, launch
                    torch.cuda.empty_cache()
    print(f"tile_ops: every case within tolerance, same bits where this build runs the scalar "
          f"or a chain body: {ok}; same bits in every case: {all_same} [{card}]")
    return 0 if ok else 1


def _panel_apply_launcher(lib, scratch: bool):
    """launch(lkk, b, out, tier) -> CUDA error through the build's own C
    signature of ``dla_panel_apply_f32``: one that takes a split scratch gets
    the one ``panel.panel_apply_schedule`` sizes, an older one is called
    without; the inverses and the right-hand side scratch are made once."""
    from dla_tpu_torch.kernels import panel, tiles

    fn = lib.dla_panel_apply_f32
    npointers, nints = (6, 6) if scratch else (5, 5)
    fn.argtypes = [ctypes.c_void_p] * npointers + [ctypes.c_longlong] * nints + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    m, nb, ib = PANEL_APPLY_CASE
    dev = torch.device("cuda")
    rhs = torch.empty(m, ib, device=dev)
    bufs = {}

    def launch(lkk, dinv, b, out, tier_name):
        ptrs = (b.data_ptr(), lkk.data_ptr(), dinv.data_ptr(), out.data_ptr(), rhs.data_ptr())
        ints = (m, nb, ib, b.stride(0), lkk.stride(0))
        code = tiles._TIER_CODE[tier_name]
        if not scratch:
            return fn(*ptrs, *ints, code, stream)
        sched = panel.panel_apply_schedule(m, nb, ib, planes=panel.panel_apply_planes(tier_name))
        if sched.scratch not in bufs:
            bufs.clear()
            bufs[sched.scratch] = panel._split_scratch(sched, dev)
        buf = bufs[sched.scratch]
        nbytes = 0 if buf is None else buf.numel() * buf.element_size()
        return fn(*ptrs, None if buf is None else buf.data_ptr(), *ints, nbytes, code, stream)
    return launch


def _panel_apply_ab(args, card: str) -> int:
    """#3 of two builds at every fp32 tier: times, the body, the largest
    differences between the builds and to the plain version."""
    from dla_tpu_torch.kernels import _build, panel
    from dla_tpu_torch.utils import precision

    dev = torch.device("cuda")
    m, nb, ib = PANEL_APPLY_CASE
    g = torch.Generator(device=dev).manual_seed(m + nb + ib)
    lkk = torch.tril(torch.randn(nb, nb, generator=g, device=dev)) + nb * torch.eye(nb, device=dev)
    b = torch.randn(m, nb, generator=g, device=dev)
    dinv = panel._diag_inverses(lkk, ib)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        launch = {}
        for version, csrc in (("other", Path(args.other)), ("this", _build.CSRC)):
            scratch = "void* scratch" in (csrc / SOURCE["panel_apply"]).read_text()
            launch[version] = _panel_apply_launcher(
                _build_lib(csrc, Path(tmp) / f"{version}.so", "panel_apply"), scratch)
        for tier_name in ("high", "default", "highest"):
            outs, times = {}, {"other": [], "this": []}
            for version in ["other", "this", "this", "other"] * args.iters:
                out = torch.empty(m, nb, device=dev)
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                err = launch[version](lkk, dinv, b, out, tier_name)
                t1.record()
                t1.synchronize()
                if err:
                    raise RuntimeError(f"{version}: CUDA error {err}")
                times[version].append(t0.elapsed_time(t1))
                outs[version] = out
            with precision.override(tier_name):
                ref = panel.panel_apply_plain(lkk, b, ib=ib, tb=1024)
            tol = (2**-6 if tier_name == "default" else 1e-4) * ref.abs().max().item()
            diff = (outs["this"] - outs["other"]).abs().max().item()
            err = (outs["this"] - ref).abs().max().item()
            good = err <= tol and bool(torch.isfinite(outs["this"]).all())
            ok = ok and good
            sched = panel.panel_apply_schedule(m, nb, ib,
                                               planes=panel.panel_apply_planes(tier_name))
            med = {v: sorted(ts[1:])[len(ts[1:]) // 2] for v, ts in times.items()}
            print(f"panel_apply m={m} nb={nb} ib={ib} f32/{tier_name}: this body "
                  f"{panel.panel_apply_body(tier_name)}, {sched.launches} launches a call; max "
                  f"|this - other| {diff:.3e}; max |this - plain| {err:.3e} (tol {tol:.3e})"
                  f"{'' if good else ' FAILED'}; other median {med['other']:.4f} ms of "
                  f"{[round(t, 4) for t in times['other']]}, this median {med['this']:.4f} ms of "
                  f"{[round(t, 4) for t in times['this']]}, x{med['other'] / med['this']:.2f} "
                  f"[{card}]", flush=True)
            del outs, ref
            torch.cuda.empty_cache()
    print(f"panel_apply: every tier within tolerance of the plain version: {ok} [{card}]")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="directory of the other version's sources")
    ap.add_argument("--entry", choices=sorted(SOURCE), default="df64")
    ap.add_argument("--tier", choices=["high", "default", "highest"], default="high")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    ap.add_argument("--m", type=int, default=24576, help="df64: the window's size")
    ap.add_argument("--n", type=int, default=None,
                    help="packed_df64 (default 40960), packed (default 81920, fp64 32768): "
                         "the matrix's size")
    ap.add_argument("--k", type=int, default=0, help="packed_df64, packed: the step")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from dla_tpu_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    if args.entry in ("potrf_tile", "panel_factor"):
        return _diag_ab(args, card)
    if args.entry == "ring":
        return _ring_ab(args, card)
    if args.entry == "tile_ops":
        return _tile_ab(args, card)
    if args.entry == "panel_apply":
        return _panel_apply_ab(args, card)
    stream = torch.cuda.current_stream().cuda_stream
    dtype = DTYPES[args.dtype]
    if args.entry == "df64":
        inputs, launch, name = _df64_case(args.m, stream)
        symbol, scale = "dla_trailing_df64", None
    elif args.entry == "packed_df64":
        inputs, launch, name = _packed_df64_case(args.n or 40960, args.k, stream)
        symbol, scale = "dla_trailing_packed_df64", None
    else:
        inputs, launch, name, scale = _trailing_case(args.entry, dtype, args.tier, stream,
                                                     args.n, args.k)
        symbol = f"dla_trailing_{args.entry}_{args.dtype}"
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"other": _compile(Path(args.other), Path(tmp) / "other.so", args.entry, symbol),
               "this": _compile(_build.CSRC, Path(tmp) / "this.so", args.entry, symbol)}
        outs, times, ran = {}, {"other": [], "this": []}, {}
        for version in ["other", "this", "this", "other"] * args.iters:
            out = tuple(x.clone() for x in inputs)
            fn, scratch, bodies = fns[version]
            before = bodies() if bodies else None
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            err = launch(fn, scratch, out)
            t1.record()
            t1.synchronize()
            if err:
                raise RuntimeError(f"{version}: CUDA error {err}")
            if bodies:
                ran[version] = [b for b, v in bodies().items() if v != before[b]]
            times[version].append(t0.elapsed_time(t1))
            outs[version] = out
            del out
    for version, ts in times.items():
        print(f"{version}: first launch {ts[0]:.3f} ms, then median "
              f"{sorted(ts[1:])[len(ts[1:]) // 2]:.3f} ms of {[round(t, 3) for t in ts[1:]]} "
              f"[{card}]")
    if scale is None:
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(outs["other"], outs["this"]))
        print(f"{args.entry} {name}: same bits {same} [{card}]")
        return 0 if same else 1
    for version, bodies in ran.items():
        print(f"{version}: body {', '.join(bodies)}")
    a, b = (outs[v][0].view(-1) for v in ("other", "this"))
    chunk = 1 << 26  # a packed buffer in fp64 at once would not fit beside the others
    diff = max((a[i:i + chunk].double() - b[i:i + chunk].double()).abs().max().item()
               for i in range(0, a.numel(), chunk))
    view = {torch.float32: torch.int32, torch.float64: torch.int64, torch.bfloat16: torch.int16}
    same = all(torch.equal(a[i:i + chunk].view(view[dtype]), b[i:i + chunk].view(view[dtype]))
               for i in range(0, a.numel(), chunk))
    print(f"{args.entry} {name}: max |this - other| = {diff:.3e} = {diff / scale:.3e} of "
          f"max_i ||p_i||^2, same bits {same} [{card}]")
    chain = dtype == torch.float64 or (dtype == torch.float32 and args.tier == "highest")
    return 1 if chain and not same else 0


if __name__ == "__main__":
    sys.exit(main())
