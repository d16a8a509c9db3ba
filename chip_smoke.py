#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. the card's name and power limit (nvidia-smi), and the build of every
   CUDA source under src/repro_torch/kernels/csrc with nvcc;
2. each kernel against its plain PyTorch version on the same CUDA tensors,
   bit for bit in J and iters: 2-D conn4/conn8 at T in {16, 64, 128},
   int32 and float32, K in {1, 8, 64}, with a holed valid mask; 3-D conn26
   at T=16; K=256 at T=64 (the main path's batched shape); and starved
   max_iters that truncate.  On the same cases, at queue capacities
   {1, 33, default, 256}, the queued kernels against their plain version
   bit for bit in J, iters and spills, and against the dense kernels in J
   and iters; then resident seeds (count 0, within and above the capacity)
   and the serpentine block starved of max_iters;
3. the main path at full size: grayscale reconstruction of a 4096^2 tissue
   image with 64 marker seeds through engine="tiled-kernel" (tile=64,
   queue_capacity=256, drain_batch=256), held bit for bit against the
   port's own "frontier" engine, then a 1024^2 dense-marker image through
   tile=128, drain_batch=1; then both again with kernel_queue=True (the
   queued kernels), each bit-equal to "frontier" with the dense run's five
   counters; the launch counts are reset before each run and read after
   it, and every kernel must have launched;
4. one more 4096^2 solve under torch.profiler for each of the dense and
   the queued drain (the card's busy time by kernel and its idle share);
   then, on the first chunk each main-path run drains, each kernel held bit
   for bit against its plain version, and the times of both and the
   kernel's bound.

Every line before the last is one JSON object; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): device-memory rate and the float32
# rate outside the tensor cores, used for the int32 min/max of the drain too.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def block_case(rng, K, block, dtype):
    """(K, *block) drain inputs: a random mask, a marker of 1% seeds at the
    mask and low values elsewhere, and a valid mask with scattered holes and
    an invalid slab."""
    shape = (K,) + tuple(block)
    I = rng.integers(30, 230, size=shape)
    J = np.where(rng.random(shape) < 0.01, I, rng.integers(0, 30, size=shape))
    valid = rng.random(shape) < 0.95
    valid[(slice(None),) + (slice(2, 5),) * len(block)] = False
    np_dtype = np.int32 if dtype == torch.int32 else np.float32
    return (torch.tensor(J.astype(np_dtype), device="cuda"),
            torch.tensor(I.astype(np_dtype), device="cuda"),
            torch.tensor(valid, device="cuda"))


def serpentine_block(n: int):
    """A 1-px serpentine corridor in an (n+2)^2 block, seeded at one end:
    its geodesic is ~n^2/2 rounds long."""
    corridor = np.zeros((n, n), bool)
    corridor[0::2, :] = True
    for i, r in enumerate(range(1, n - 1, 2)):
        corridor[r, (n - 1) if i % 2 == 0 else 0] = True
    neut = np.iinfo(np.int32).min
    mask = np.pad(np.where(corridor, 100, 0).astype(np.int32), 1,
                  constant_values=neut)
    marker = np.full_like(mask, neut)
    marker[1:-1, 1:-1] = 0
    marker[1, 1] = 100
    valid = np.pad(np.ones((n, n), bool), 1)
    return (torch.tensor(marker, device="cuda"),
            torch.tensor(mask, device="cuda"),
            torch.tensor(valid, device="cuda"))


def max_abs_err(a, b) -> float:
    if torch.equal(a, b):
        return 0.0
    both = torch.isfinite(a.double()) & torch.isfinite(b.double())
    if not bool(both.all()) and not torch.equal(a[~both], b[~both]):
        return float("inf")
    return float((a.double() - b.double())[both].abs().max())


def queue_caps(block):
    """The queue capacities each case runs at: 1 (every round that
    improves more than one contribution spills), 33, the engine's default
    for the block, and 256."""
    from repro_torch.kernels.ops import default_kernel_queue_capacity
    return sorted({1, 33, default_kernel_queue_capacity(block), 256})


def queued_call(morph_tile, J, I, valid, seed=None, **kw):
    """The queued kernel on a (K, ...) batch: the single-block entry point
    for K=1, the batched one otherwise.  Returns (name, J, iters[K],
    spills[K])."""
    if J.shape[0] == 1:
        s1 = None if seed is None else (seed[0][0], seed[1][0])
        Jk, ik, sk = morph_tile.morph_tile_solve_queued(
            J[0], I[0], valid[0], s1, **kw)
        return ("morph_tile_solve_queued", Jk[None], ik.reshape(1),
                sk.reshape(1))
    Jk, ik, sk = morph_tile.morph_tile_solve_queued_batched(
        J, I, valid, seed, **kw)
    return "morph_tile_solve_queued_batched", Jk, ik, sk


def check_queued(morph_tile, qerrs, J, I, valid, conn, cap, max_iters,
                 dense=None, seed=None, what=""):
    """Queued kernel against its plain version, bit for bit in J, iters and
    spills; against the dense kernel's ``dense = (J, iters)`` when given.
    Returns the kernel's (J, iters, spills)."""
    kw = dict(connectivity=conn, max_iters=max_iters, queue_capacity=cap)
    name, Jq, iq, sq = queued_call(morph_tile, J, I, valid, seed, **kw)
    Jp, ip, sp = morph_tile.morph_tile_solve_queued_plain(J, I, valid, seed,
                                                          **kw)
    torch.cuda.synchronize()
    err = max_abs_err(Jq, Jp)
    qerrs[name] = max(qerrs[name], err)
    tag = (f"{name} {what} conn={conn} block={tuple(J.shape[1:])} "
           f"dtype={J.dtype} K={J.shape[0]} cap={cap} max_iters={max_iters}")
    check(err == 0.0 and torch.equal(iq, ip) and torch.equal(sq, sp),
          f"{tag} differs from plain: err={err} iters kernel="
          f"{iq.tolist()[:8]} plain={ip.tolist()[:8]} spills kernel="
          f"{sq.tolist()[:8]} plain={sp.tolist()[:8]}")
    if dense is not None:
        check(torch.equal(Jq, dense[0]) and torch.equal(iq, dense[1]),
              f"{tag}: J or iters differ from the dense kernel's")
    return Jq, iq, sq


def phase_kernels_vs_plain(morph_tile):
    """Every listed case, kernel against plain, bit for bit."""
    rng = np.random.default_rng(0)
    errs = {"morph_tile_solve": 0.0, "morph_tile_solve_batched": 0.0}
    qerrs = {"morph_tile_solve_queued": 0.0,
             "morph_tile_solve_queued_batched": 0.0}
    n_queued = 0
    cases = []
    for conn in (4, 8):
        for T in (16, 64, 128):
            for dtype in (torch.int32, torch.float32):
                for K in (1, 8, 64):
                    cases.append((conn, (T + 2,) * 2, dtype, K, None))
    for dtype in (torch.int32, torch.float32):
        cases.append(("conn26", (18,) * 3, dtype, 8, None))
    # The main path's B2 launch shape: 256 blocks of T=64.
    for dtype in (torch.int32, torch.float32):
        cases.append((8, (66, 66), dtype, 256, None))
    cases.append((8, (66, 66), torch.int32, 8, 5))          # starved batch
    for conn, block, dtype, K, starve in cases:
        J, I, valid = block_case(rng, K, block, dtype)
        bound = starve or int(np.prod(block))
        Jp, ip = morph_tile.morph_tile_solve_plain(
            J, I, valid, connectivity=conn, max_iters=bound)
        if K == 1:
            name = "morph_tile_solve"
            Jk, ik = morph_tile.morph_tile_solve(
                J[0], I[0], valid[0], connectivity=conn, max_iters=bound)
            Jk, ik = Jk[None], ik.reshape(1)
        else:
            name = "morph_tile_solve_batched"
            Jk, ik = morph_tile.morph_tile_solve_batched(
                J, I, valid, connectivity=conn, max_iters=bound)
        torch.cuda.synchronize()
        err = max_abs_err(Jk, Jp)
        errs[name] = max(errs[name], err)
        check(err == 0.0 and torch.equal(ik, ip),
              f"{name} differs from plain: conn={conn} block={block} "
              f"dtype={dtype} K={K} max_iters={bound} err={err} "
              f"iters kernel={ik.tolist()[:8]} plain={ip.tolist()[:8]}")
        if starve:
            check(bool((ik == starve).all()), "starved case did not truncate")
        for cap in queue_caps(block):
            check_queued(morph_tile, qerrs, J, I, valid, conn, cap, bound,
                         dense=(Jk, ik))
            n_queued += 1
    # The serpentine at a starved bound truncates in the single-block form.
    J, I, valid = serpentine_block(64)
    Jk, ik = morph_tile.morph_tile_solve(J, I, valid, connectivity=8,
                                         max_iters=64)
    Jp, ip = morph_tile.morph_tile_solve_plain(J[None], I[None], valid[None],
                                               connectivity=8, max_iters=64)
    torch.cuda.synchronize()
    check(int(ik) == 64 and torch.equal(Jk, Jp[0]) and int(ip[0]) == 64,
          "serpentine truncation differs from plain")
    for cap in queue_caps(J.shape):
        _, iq, _ = check_queued(morph_tile, qerrs, J[None], I[None],
                                valid[None], 8, cap, 64,
                                dense=(Jk[None], ik.reshape(1)),
                                what="serpentine")
        check(int(iq[0]) == 64, "queued serpentine did not truncate")
        n_queued += 1
    n_queued += phase_seeded(morph_tile, qerrs, rng)
    emit({"phase": "kernel_vs_plain", "cases": len(cases) + 1,
          "max_abs_err": errs})
    emit({"phase": "queued_vs_plain", "cases": n_queued,
          "max_abs_err": qerrs})
    return {**errs, **qerrs}


def phase_seeded(morph_tile, qerrs, rng) -> int:
    """Resident seeds, queued kernel against plain: a count of 0 (returns at
    once), a count within the capacity (live slots shuffled among dead
    ones: the first round scans every slot) and a count above it (the
    first round spills)."""
    from repro_torch.kernels.ops import default_kernel_queue_capacity
    n_cases = 0
    for conn, block, dtype, K in ((8, (66, 66), torch.int32, 8),
                                  (4, (18, 18), torch.float32, 1),
                                  ("conn26", (18,) * 3, torch.int32, 8)):
        J, I, valid = block_case(rng, K, block, dtype)
        n = int(np.prod(block))
        for cap in sorted({33, default_kernel_queue_capacity(block)}):
            for count in (0, cap // 2, 2 * cap):
                idx = np.full((K, count + 3), -1, np.int32)
                for k in range(K):
                    idx[k, :count] = rng.choice(n, count, replace=False)
                    if count <= cap:
                        rng.shuffle(idx[k])
                seed = (torch.tensor(idx, device="cuda"),
                        torch.full((K,), count, dtype=torch.int32,
                                   device="cuda"))
                Jq, iq, sq = check_queued(morph_tile, qerrs, J, I, valid,
                                          conn, cap, n, seed=seed,
                                          what=f"seed count={count}")
                if count == 0:
                    check(bool((iq == 0).all() & (sq == 0).all()) and
                          torch.equal(Jq, torch.where(
                              valid, J, morph_tile._neutral(J.dtype))),
                          "a seed of count 0 did not return at once")
                if count > cap:
                    check(bool((sq >= 1).all()),
                          "a seed above the capacity did not spill")
                n_cases += 1
    return n_cases


def reference_reconstruct(marker, mask):
    """Independent numpy oracle: iterate J <- min(dilate_8(J), I) to its
    fixed point (the definition of reconstruction by dilation)."""
    J = np.minimum(marker, mask).astype(np.int32)
    I = mask.astype(np.int32)
    while True:
        P = np.pad(J, 1, constant_values=np.iinfo(np.int32).min)
        D = J.copy()
        H, W = J.shape
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                D = np.maximum(D, P[1 + dr:1 + dr + H, 1 + dc:1 + dc + W])
        Jn = np.minimum(D, I)
        if np.array_equal(Jn, J):
            return J
        J = Jn


COUNTERS = ("rounds", "sources_processed", "tiles_processed",
            "overflow_events", "tiles_requeued")


def run_main(name, marker, mask, morph_tile, dense_stats=None, **kw):
    """One main-path run through tiled-kernel, held against frontier and,
    given ``dense_stats``, against the dense drain's five counters."""
    from repro_torch.convert import stats_to_dict
    from repro_torch.morph.ops import reconstruct
    morph_tile.LAUNCHES.clear()
    Jk, sk = reconstruct(marker, mask, engine="tiled-kernel", **kw)
    torch.cuda.synchronize()
    launches = dict(morph_tile.LAUNCHES)
    if dense_stats is not None:
        got = {k: getattr(sk, k) for k in COUNTERS}
        want = {k: getattr(dense_stats, k) for k in COUNTERS}
        check(got == want, f"{name}: counters {got} differ from the dense "
              f"drain's {want}")
    Jf, sf = reconstruct(marker, mask, engine="frontier")
    check(Jk.shape == tuple(mask.shape) and Jk.dtype == torch.uint8,
          f"{name}: output shape/dtype {tuple(Jk.shape)} {Jk.dtype}")
    check(torch.equal(Jk, Jf), f"{name}: tiled-kernel J differs from frontier "
          f"({int((Jk != Jf).sum())} pixels)")
    m = torch.as_tensor(marker, device="cuda")
    I = torch.as_tensor(mask, device="cuda")
    check(bool((Jk <= I).all() & (Jk >= torch.minimum(m, I)).all()),
          f"{name}: J outside [min(marker, mask), mask]")
    emit({"phase": name, "shape": list(mask.shape), "launches": launches,
          "tiled_kernel": stats_to_dict(sk), "frontier": stats_to_dict(sf)})
    return launches, sk


def phase_profile(name, marker, mask, **kw):
    """One more tiled-kernel solve under torch.profiler: the card's busy
    time by kernel, and its idle share of the (profiled) wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.morph.ops import reconstruct
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        reconstruct(marker, mask, engine="tiled-kernel", **kw)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            busy[ev.key] = us / 1e6
    total = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": name, "wall_s_profiled": wall,
          "device_busy_s": total if busy else None,
          "idle_share": 1 - total / wall if busy else None,
          "top_device_s": dict(top)})


def first_full_chunk(marker, mask, tile, capacity, K):
    """The halo blocks of the first chunk of K live tiles that the main
    path's tiled-kernel run drains (int32, as the kernel gets them)."""
    from repro_torch.core import tiles
    from repro_torch.core.geometry import unravel_index
    from repro_torch.kernels.ops import (tile_solver_morph,
                                         tile_solver_morph_batched)
    from repro_torch.morph.ops import MorphReconstructOp
    op = MorphReconstructOp(connectivity=8)
    state = op.make_state(torch.as_tensor(marker, device="cuda"),
                          torch.as_tensor(mask, device="cuda"))
    bound = (tile + 2) ** 2
    plan, rs = tiles.prepare(op, state, tile=tile, queue_capacity=capacity,
                             drain_batch=K,
                             tile_solver=tile_solver_morph(8, bound),
                             batched_tile_solver=tile_solver_morph_batched(
                                 8, bound))
    while int(rs.active.sum()) < K and bool(rs.active.any()):
        rs = tiles.step(plan, rs)
    ids = torch.nonzero(rs.active.reshape(-1)).reshape(-1)[:K]
    tco = torch.stack(unravel_index(ids, plan.grid), 1)
    base = (tco * plan.index.tile_step).sum(1)
    gather = base[:, None] + plan.index.block
    shape = (ids.numel(), tile + 2, tile + 2)
    J, I, valid = (rs.padded[k].view(-1)[gather].view(shape)
                   for k in ("J", "I", "valid"))
    return J.to(torch.int32), I.to(torch.int32), valid


def kernel_row(morph_tile, name, replaces, J, I, valid, launches, err,
               reps):
    """Hold the kernel against its plain version on one chunk the main
    path drains (J and iters bit for bit), time both, compute the bound.
    The row's ``max_abs_err`` is the largest of this comparison and the
    listed cases' (``err``)."""
    bound_iters = int(J[0].numel())
    if name == "morph_tile_solve":
        def call():
            Jk, ik = morph_tile.morph_tile_solve(
                J[0], I[0], valid[0], connectivity=8, max_iters=bound_iters)
            return Jk[None], ik.reshape(1)
    else:
        def call():
            return morph_tile.morph_tile_solve_batched(
                J, I, valid, connectivity=8, max_iters=bound_iters)
    plain = lambda: morph_tile.morph_tile_solve_plain(   # noqa: E731
        J, I, valid, connectivity=8, max_iters=bound_iters)
    Jk, iters = call()
    Jp, iters_plain = plain()
    torch.cuda.synchronize()
    chunk_err = max_abs_err(Jk, Jp)
    check(chunk_err == 0.0 and torch.equal(iters, iters_plain),
          f"{name} differs from plain on the main path's chunk "
          f"{tuple(J.shape)}: err={chunk_err} iters kernel="
          f"{iters.tolist()[:8]} plain={iters_plain.tolist()[:8]}")
    cells = J[0].numel()
    n_bytes = J.shape[0] * cells * 13            # 9 B read + 4 B written
    ops = int(iters.sum()) * cells * (8 + 2)     # conn8: 8 max, 1 max, 1 min
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S
    ms = cuda_time_ms(call, reps)
    plain_ms = cuda_time_ms(plain, 2)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/morph_tile.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(err, chunk_err),
            "main_path_chunk_err": chunk_err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "shape": list(J.shape), "dtype": "int32", "connectivity": "conn8",
            "iters_sum": int(iters.sum()), "iters_max": int(iters.max())}


def queued_row(morph_tile, name, replaces, J, I, valid, launches, err, cap,
               reps):
    """The queued kernel on one chunk the main path drains, held against
    its plain version (J, iters, spills) and the dense kernel (J, iters);
    times of both and the bound.  The bound counts the dense rounds (the
    seeding round of each block and its spills) at cells * (8 + 2)
    operations, each push round at its live contributions (live slots * 8
    offsets, a min and a max each; the live slots as the plain version
    counts them), and 13 B a cell of device memory."""
    bound_iters = int(J[0].numel())
    kw = dict(connectivity=8, max_iters=bound_iters, queue_capacity=cap)
    call = lambda: queued_call(morph_tile, J, I, valid, **kw)[1:]  # noqa: E731
    plain = lambda: morph_tile.morph_tile_solve_queued_plain(  # noqa: E731
        J, I, valid, **kw)
    Jk, iters, spills = call()
    work = {}
    Jp, ip, sp = morph_tile.morph_tile_solve_queued_plain(J, I, valid,
                                                          work=work, **kw)
    Jd, idn = morph_tile.morph_tile_solve_plain(J, I, valid, connectivity=8,
                                                max_iters=bound_iters)
    torch.cuda.synchronize()
    chunk_err = max_abs_err(Jk, Jp)
    check(chunk_err == 0.0 and torch.equal(iters, ip)
          and torch.equal(spills, sp),
          f"{name} differs from plain on the main path's chunk "
          f"{tuple(J.shape)}: err={chunk_err} iters kernel="
          f"{iters.tolist()[:8]} plain={ip.tolist()[:8]} spills kernel="
          f"{spills.tolist()[:8]} plain={sp.tolist()[:8]}")
    check(torch.equal(Jk, Jd) and torch.equal(iters, idn),
          f"{name}: J or iters differ from the dense drain's on the chunk")
    K, cells = J.shape[0], J[0].numel()
    dense_rounds = K + int(spills.sum())
    pushed = int(work["pushed"].sum())
    n_bytes = K * cells * 13
    ops = dense_rounds * cells * (8 + 2) + pushed * 8 * 2
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S
    ms = cuda_time_ms(call, reps)
    plain_ms = cuda_time_ms(plain, 1)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/morph_tile_queued.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(err, chunk_err),
            "main_path_chunk_err": chunk_err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "shape": list(J.shape), "dtype": "int32", "connectivity": "conn8",
            "queue_capacity": cap, "iters_sum": int(iters.sum()),
            "iters_max": int(iters.max()), "spills_sum": int(spills.sum()),
            "dense_rounds": dense_rounds, "pushed_slots": pushed,
            "contributions": pushed * 8}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.images import seeded_marker, tissue_image
    from repro_torch.kernels import _build, morph_tile

    t_start = time.monotonic()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    gpu = smi.stdout.strip().splitlines()[0]
    t0 = time.monotonic()
    built = _build.build_all()
    build_s = time.monotonic() - t0
    ptxas = [line.strip() for b in built.values() for line in b.log.splitlines()
             if "registers" in line or "Compiling entry" in line]
    emit({"nvidia_smi": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "nvcc_s": {k: b.seconds for k, b in built.items()},
          "ptxas": ptxas})

    errs = phase_kernels_vs_plain(morph_tile)

    # Oracle check of the whole path on a small input against numpy.
    _, small_mask = tissue_image(96, 96, coverage=0.75, seed=3)
    small_marker = seeded_marker(small_mask, n_seeds=4, seed=3)
    from repro_torch.morph.ops import reconstruct
    Js, _ = reconstruct(small_marker, small_mask, engine="tiled-kernel",
                        tile=16, queue_capacity=8, drain_batch=4)
    check(np.array_equal(Js.cpu().numpy().astype(np.int32),
                         reference_reconstruct(small_marker, small_mask)),
          "96^2 tiled-kernel result differs from the numpy oracle")

    _, mask = tissue_image(4096, 4096, coverage=0.75, seed=0)
    marker = seeded_marker(mask, n_seeds=64, seed=0)
    seeded_kw = dict(tile=64, queue_capacity=256, drain_batch=256)
    launches_b2, stats_b2 = run_main("main_4096_seeded", marker, mask,
                                     morph_tile, **seeded_kw)
    phase_profile("profile_4096_seeded", marker, mask, **seeded_kw)
    dense_marker, dense_mask = tissue_image(1024, 1024, coverage=0.75, seed=0)
    dense_kw = dict(tile=128, drain_batch=1)
    launches_b1, stats_b1 = run_main("main_1024_dense", dense_marker,
                                     dense_mask, morph_tile, **dense_kw)
    n_b2 = launches_b2.get("morph_tile_solve_batched", 0)
    n_b1 = launches_b1.get("morph_tile_solve", 0)
    check(n_b2 > 0, "morph_tile_solve_batched never launched on the main path")
    check(n_b1 > 0, "morph_tile_solve never launched on the main path")

    # The same two runs with the in-kernel queue: the queued kernels only.
    launches_b4, stats_b4 = run_main("main_4096_seeded_queued", marker, mask,
                                     morph_tile, dense_stats=stats_b2,
                                     kernel_queue=True, **seeded_kw)
    phase_profile("profile_4096_seeded_queued", marker, mask,
                  kernel_queue=True, **seeded_kw)
    launches_b3, stats_b3 = run_main("main_1024_dense_queued", dense_marker,
                                     dense_mask, morph_tile,
                                     dense_stats=stats_b1, kernel_queue=True,
                                     **dense_kw)
    n_b4 = launches_b4.get("morph_tile_solve_queued_batched", 0)
    n_b3 = launches_b3.get("morph_tile_solve_queued", 0)
    check(n_b4 > 0, "morph_tile_solve_queued_batched never launched on the "
          "main path")
    check(n_b3 > 0, "morph_tile_solve_queued never launched on the main path")
    check(set(launches_b4) == {"morph_tile_solve_queued_batched"} and
          set(launches_b3) == {"morph_tile_solve_queued"},
          f"kernel_queue=True launched other kernels: {launches_b4} "
          f"{launches_b3}")
    cap_b4, cap_b3 = stats_b4.kernel_queue_capacity, stats_b3.kernel_queue_capacity
    check((cap_b4, cap_b3) == (66, 130),
          f"kernel queue capacities {cap_b4}, {cap_b3}, expected 66 and 130")

    J2, I2, v2 = first_full_chunk(marker, mask, 64, 256, 256)
    J1, I1, v1 = first_full_chunk(dense_marker, dense_mask, 128, 64, 1)
    rows = [
        kernel_row(morph_tile, "morph_tile_solve",
                   "src/repro/kernels/morph_tile.py:123", J1, I1, v1,
                   n_b1, errs["morph_tile_solve"], reps=10),
        kernel_row(morph_tile, "morph_tile_solve_batched",
                   "src/repro/kernels/morph_tile.py:347", J2, I2, v2,
                   n_b2, errs["morph_tile_solve_batched"], reps=10),
        queued_row(morph_tile, "morph_tile_solve_queued",
                   "src/repro/kernels/morph_tile.py:274", J1, I1, v1,
                   n_b3, errs["morph_tile_solve_queued"], cap_b3, reps=5),
        queued_row(morph_tile, "morph_tile_solve_queued_batched",
                   "src/repro/kernels/morph_tile.py:318", J2, I2, v2,
                   n_b4, errs["morph_tile_solve_queued_batched"], cap_b4,
                   reps=5),
    ]
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.monotonic() - t_start})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
