#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so any fault exits non-zero):
  1. the device: name, count, and nvidia-smi's name and power limit;
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, in parallel), printing the build time, ptxas's
     registers / shared memory / spills per kernel, and the count of
     tensor-core (HGMMA, HMMA) and TMA-load (UTMALDG) instructions in each
     library's SASS (``cuobjdump -sass``); the libraries of the three
     f32 top-2s (assign_top2, fused_nested_round, fused_round: the
     tensor-core top-2 of tc_top2.cuh) must have both HGMMA and UTMALDG;
  3. hold each kernel against its plain PyTorch version on the card, on
     inputs made from a numpy seed: at the main-path shape (n=400,000,
     d=784, k=50), at k=1, k=257 and an unaligned n, kernel 1 also in
     bf16. Kernel 4's top-2 is held to the plain version's with x.c,
     |x|^2 and |c|^2 taken in float64 and rounded once to f32 (an f32
     product is too far off where they cancel, as at kmeans_xl width);
     its distance from the plain version itself is logged. Kernels 1 (in
     f32) and 3 are held, beyond their plain versions, to the ref
     expression's top-2 taken that way (`assign_top2_exact`), within
     FULL_RTOL = 5e-7 of |x|^2 + max |c|^2 plus FULL_ATOL = 1e-5, and the
     largest gap is logged. The plain sums on the card
     (`ref.cluster_sum_ref`) must give the same bits twice and agree with
     ``index_add_``, at the main-path shape and at kmeans_xl's width.
     Tolerances
     are those of tests/test_kernels.py: f32 rtol 1e-5 (atol 1e-4), bf16 rtol 2e-2;
     labels may differ only where the two distances tie within 100x the
     tolerance. Sums over many rows are
     held to their rtol (1e-5 for cluster_sum, 1e-4 for the fused
     rounds' sums, as tests/test_kernels.py holds them) relative to their
     L1 mass (sum of |w x| per entry), the scale of f32 rounding in a
     sum of that many terms. Each kernel must give the same bits twice,
     and the sums of kernels 2-4 (the shared deterministic scatter) must
     have the bits of the order oracle `ref.ordered_sums` (rows of a chunk
     in row order, then the chunks in order) over the kernel's own labels;
  4. the main path at full size: ``NestedKMeans(FitConfig(k=50, b0=5000,
     algorithm="tb", rho=inf, bounds="hamerly2")).fit`` on 400,000
     ``infmnist_like`` rows (the paper's infMNIST experiment) with 10,000
     validation rows, then ``predict``. Each kernel's launch count is set
     to 0 just before and read just after; all three must be > 0. The
     profiled second fit logs the scatter's device time by pass, the
     tensor-core top-2s' device time (both must show), and the count of
     host calls that wait for the device. A second identical fit must
     give bit-identical centroids and labels, and the same fit with
     ``kernel_backend="ref"`` (plain versions on the card) must reach a
     final validation MSE within 1e-3 relative; it runs twice, and the
     two must give the same bits. The schedules of the cuda and ref fits
     are logged with the round where they part, and a shadowed cuda fit
     takes each round's step on the plain versions too, from the same
     state: the same recomputations, labels that differ only at
     near-ties (float64 gap within 1e-3 relative), and the cuda fit's
     bits;
  5. time each kernel at its main-path shape with CUDA events after a
     warm-up, beside its plain version, one PyTorch library call where
     one computes the same function, and its bound on an H100 SXM (the
     larger of bytes over 3.35 TB/s and the operations over their type's
     peak: the tensor-core top-2s' 3 x 2 n k_pad d in 3xTF32 at 495
     TFLOP/s, k_pad the k tiles they run, other adds in f32 at 67
     TFLOP/s); cuBLAS's f32 ``torch.mm`` of x.c^T at that shape is timed
     as a yardstick (not the same function);
  6. the kmeans_xl data-parallel round at full width on one card's share
     of the rows: n=2^22 (2^30 points over 256 chips), d=1024, k=4096,
     f32, Gaussian blobs made on the card. Kernel 4 (the one-shot round)
     is held against its plain version as in phase 3 on the last 65,536
     rows, and its sums over all rows against plain sums taken in row
     chunks and, bit for bit, against the order oracle (the one check at
     64 cluster tiles). Then, with the launch counts set to 0 just before
     and read just after: ``make_dp_round(mesh=None, fused=True)`` runs 3
     Lloyd steps (the batch MSE may not rise beyond 1e-6 relative), two
     steps under a one-rank NCCL `DeviceMesh` must give the same bits as
     ``mesh=None``, and one unfused step (kernels 1 and 2) must give the
     same labels but for near-ties, C bit-identical on every cluster no
     such row touches, and C within 1e-4 relative of the fused step's
     (kernel 1's top-2 runs the same tensor-core loop). The fused step's
     labels must equal the float64 argmin of every row but for
     near-ties, and its C must be within 1e-4 relative of the C those
     float64 labels give; the unfused C's gap to it is logged. The
     profiled fused step gives kernel 4's parts by kernel: the
     tensor-core top-2, the scatter's three passes (row lists, sums over
     the lists, chunk reduction), and the small passes; where the trace
     lost the step's kernels, as torch.profiler has in some runs on the
     card, the step is traced again, at most twice. Last, kernel 4
     is timed at that shape (mean of 3 after a warm-up) beside its plain
     version on a 2^18-row slice and its bound, the larger of the bytes
     over 3.35 TB/s and its operations at their type's peak (the
     distances in 3xTF32 at 495 TFLOP/s, the adds into S in f32), with
     the full-f32 CUDA-core bound and a yardstick beside it: cuBLAS's f32
     ``torch.mm`` of x.c^T on the slice, scaled to all rows;
  7. the paper's other algorithms and bound families at the infMNIST
     cell's width, on phase 4's rows: lloyd (to convergence, at most 100
     rounds), mb and mb-f (b0=2000, 400 rounds: two passes over the rows,
     one reshuffle), tb with ``bounds="elkan"`` and with
     ``bounds="exponion"`` (phase 4's config otherwise, to convergence)
     and lloyd-elkan (at most 100 rounds). For each, the launch counts
     are set to 0 just before the fit and read just after: assign_top2
     and cluster_sum must be > 0 on lloyd, mb and mb-f, cluster_sum on
     the elkan and exponion paths (their (b, k) distances are plain
     matrix products, as in the JAX package). A second identical fit
     must give bit-identical centroids and labels, and the same fit with
     ``kernel_backend="ref"`` must reach a final validation MSE within
     1e-3 relative. Rounds, wall, the sum of n_recomputed, the final
     validation MSE, peak device memory and the validation MSE against
     the rounds' time are logged (phase 4's tb fit beside them), and the
     second fit is profiled as phase 4's is. The two
     tb families run once more shadowed: each round's step is also taken
     with ``bounds="none"`` from the same state, and the labels may
     differ from it only at near-ties (float64 gap within 1e-3
     relative);
  8. out-of-core and kill-and-resume on phase 4's rows, under a
     ``tempfile.mkdtemp()`` directory that is removed at the end (its
     free disk space logged first): (a) the rows are written to a chunk
     store (65,536-row chunks) and fitted with phase 4's config through
     ``config.data_source``; C, labels and telemetry but ``t`` must be
     bit-equal to the in-memory fit of ``X[store_permutation(...)]``
     with ``shuffle=False``, and a second fit from an open `ChunkStore`
     must repeat them; the store write time, the fit's wall and peak
     device memory and the bytes read against one pass are logged. (b)
     Phase 4's fit with a checkpoint every 25 rounds is killed by an
     ``on_round`` that raises at round 137 (the last save is round 125),
     then resumed with ``fit(resume=True)``: C, labels and telemetry but
     ``t`` must be bit-equal to phase 4's unbroken fit. (c) The same for
     phase 7's tb-elkan and mb fits with a checkpoint every 50 rounds,
     each held to its unbroken fit. The saves, ms per save, restore ms
     and checkpoint bytes are logged. Each fit's launch counts are set to
     0 just before and read just after: kernels 1-3 must be launched in
     the phase, and each resumed part must launch its path's kernels;
  9. the streaming service (``repro_torch.serve.ClusterService``) on
     phase 4's rows and fit, adopted by fresh estimators, with a stream
     of ``infmnist_like(120_000, seed=2)`` rows. (a) The latency design of
     benchmarks/serve_latency.py: 2048-row predicts, 256 stream rows a
     request, 1,000 timed requests a mode after a warm-up with the
     refresh off (before and after the others; the worse p99 counts),
     inline (the serving thread folds 16,384 rows at a time) and in the
     background (a service with 256-row micro-batches); p50, p99, max
     and the background-to-off p99 ratio are logged beside the JAX
     package's 1.5x claim, with no limit on times. (b) 4 reader threads
     predict for 5 s while one producer delivers every row twice under
     one id into a dedup ``IngestQueue(max_rows=16384,
     policy="block")``, and goes on alone: every snapshot a reader loads
     must verify, its versions may not fall, at least 10 refreshes must
     run while they read, after ``stop(drain=True)`` the rows folded in
     must equal the unique rows delivered and the rise of sum(counts)
     (exactly once), and every 50th request's labels must equal
     ``ref.assign_top2_ref`` on its snapshot's C on the card but at
     near-ties. (c) The stream's first 32,768 rows, scaled x3 after the
     first 16,384, into a service with a 65,536-row history and a
     checkpointed estimator, readers reading throughout: at least one
     escalation, each followed by a newer snapshot that verifies; its
     wall and the readers' p99 during it are logged. (d)
     The same 20 ``partial_fit(256)`` batches from the adopted codebook
     on two fresh estimators give bit-equal C, counts and telemetry but
     ``t``, and C within 1e-5 relative (Frobenius) of the same batches on
     the plain versions (``kernel_backend="ref"``). The launch counts are
     set to 0 before (a) and read after (d): assign_top2 and
     fused_nested_round must be > 0. Last, a predict's time is split into
     the upload of its rows, the kernel and the rest (host).

The last two lines are a JSON object of the kernels and the JSON result
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import datetime
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N, D, K = 400_000, 784, 50           # KMEANS_INFMNIST
N_VAL = 10_000
PEAK_BYTES_S = 3.35e12               # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12               # H100 SXM f32, no tensor cores
PEAK_TF32_FLOPS = 495e12             # H100 SXM TF32 tensor cores, dense
TOL = {"f32": 1e-5, "bf16": 2e-2}
DEV = "cuda"
N_XL, D_XL, K_XL = 2 ** 22, 1024, 4096  # KMEANS_XL, one chip's rows
XL_PLAIN_ROWS = 2 ** 18               # rows the plain round is run on
XL_CHECK_ROWS = 65_536                # last rows whose top-2 is checked
REPLACES = {
    "assign_top2": "src/repro/kernels/kmeans_assign.py:73",
    "cluster_sum": "src/repro/kernels/cluster_sum.py:56",
    "fused_nested_round": "src/repro/kernels/fused_round.py:225",
    "fused_round": "src/repro/kernels/fused_round.py:78",
}
SOURCE = "src/repro_torch/kernels/csrc/{}.cu"
#: the libraries whose f32 top-2 is tc_top2.cuh's (TMA + wgmma)
TC_LIBS = ("assign_top2", "fused_nested_round", "fused_round")
#: the tensor-core top-2s of assign_top2 and the nested round against
#: `assign_top2_exact`: |err| <= FULL_RTOL * full_scale + FULL_ATOL (as
#: tests/torch_round_oracle.py states them)
FULL_RTOL, FULL_ATOL = 5e-7, 1e-5


def log(*a) -> None:
    print(*a, flush=True)


class Failure(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


# ---------------------------------------------------------------- phase 1

def device_phase() -> dict:
    need(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[1] device: {name} (count {count}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)
    need(not torch.backends.cuda.matmul.allow_tf32,
         "TF32 matmuls are on; the plain versions are f32")
    return {"name": name, "count": count, "smi": smi}


# ---------------------------------------------------------------- phase 2

def sass_counts(lib) -> dict:
    """Tensor-core (HGMMA, HMMA) and TMA-load (UTMALDG) instructions in a
    built library's SASS, as ``cuobjdump -sass`` lists them."""
    from pathlib import Path

    from repro_torch.kernels import _build
    exe = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(exe), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "HMMA", "UTMALDG")}


def build_phase() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build(force=True)
    log(f"[2] built {len(report)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s wall")
    for name, (secs, ptxas) in report.items():
        counts = sass_counts(_build.lib_path(name))
        log(f"    {name}.cu: nvcc {secs:.1f} s; SASS " + ", ".join(
            f"{op} {n}" for op, n in counts.items()))
        for line in ptxas.splitlines():
            if "Compiling entry" in line or "Used" in line \
                    or "spill" in line or "wgmma" in line:
                log("      " + line.split("ptxas info    : ")[-1])
        if name in TC_LIBS:
            need(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
                 f"{name}'s library has no HGMMA or no UTMALDG: its "
                 f"top-2 is not on the tensor cores fed by TMA")


# ---------------------------------------------------------------- phase 3

def _x_c(n, d, k, seed, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    c = torch.from_numpy((rng.normal(size=(k, d)) * 2).astype(np.float32))
    return x.to(DEV, dtype), c.to(DEV, dtype)


def _labels_ok(a_got, a_want, d2m, tol, relative=False) -> int:
    """Labels equal but for ties within 100x tol (times the distance if
    ``relative``); returns the count of tied rows that differ."""
    diff = torch.nonzero(a_got != a_want)[:, 0]
    if diff.numel():
        want = d2m[diff, a_want[diff].long()]
        gap = (d2m[diff, a_got[diff].long()] - want).abs()
        scale = want.abs().clamp_min(1.0) if relative else 1.0
        need(bool((gap < tol * 100 * scale).all()),
             f"labels differ beyond a tie at {diff.numel()} rows")
    return int(diff.numel())


def _close(got, want, rtol, atol, what) -> float:
    # equal values (+inf included) have no error
    err = torch.where(got == want, 0.0, (got - want).abs())
    top = float(err.max()) if err.numel() else 0.0
    need(bool((err <= atol + rtol * want.abs()).all()),
         f"{what}: max abs err {top}")
    return top


def same_bits(got, want) -> bool:
    """Every tensor of ``got`` has the shape and bits of ``want``'s."""
    return all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want))


def _mass_close(got, want, mass, what, rtol=1e-5) -> float:
    """|got - want| <= rtol * mass + 1e-4 (mass: sum of |terms|)."""
    err = (got - want).abs()
    top = float(err.max()) if err.numel() else 0.0
    need(bool((err <= rtol * mass + 1e-4).all()),
         f"{what}: max abs err {top}")
    return top


def check_assign(n, d, k, dtype) -> float:
    from repro_torch.kernels import kmeans_assign, ref
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, c = _x_c(n, d, k, n + k, tdt)
    got = kmeans_assign.assign_top2_cuda(x, c)
    torch.cuda.synchronize()
    want = ref.assign_top2_ref(x, c)
    tol = TOL[dtype]
    need(got[0].dtype == torch.int32, "labels are not int32")
    e1 = _close(got[1], want[1], tol, tol * 10, "d1")
    if k == 1:
        need(bool(torch.isinf(got[2]).all()), "k=1: d2 is not +inf")
        e2 = 0.0
    else:
        e2 = _close(got[2], want[2], tol, tol * 10, "d2")
    ties = _labels_ok(got[0], want[0], ref.pairwise_dist2(x, c), tol)
    oracle = ""
    if dtype == "f32":
        gap, plain_gap = check_full_oracle(*got, x, c, "assign_top2",
                                           plain=want[1])
        oracle = (f"; {gap:.3g} of the scale from the float64 oracle (held "
                  f"to {FULL_RTOL:g}; the plain version's f32 product "
                  f"{plain_gap:.3g})")
    again = kmeans_assign.assign_top2_cuda(x, c)
    need(same_bits(again, got), "assign_top2 is not deterministic")
    log(f"    assign_top2 {dtype} n={n} d={d} k={k}: max abs err d1 {e1:.3g}"
        f" d2 {e2:.3g}, tied labels {ties}{oracle}, second run "
        f"bit-identical")
    return max(e1, e2)


def _weights(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], n).astype(
        np.float32)).to(DEV)


def check_cluster_sum(n, d, k) -> float:
    from repro_torch.kernels import cluster_sum, ref
    x, _ = _x_c(n, d, 1, n + d, torch.float32)
    rng = np.random.default_rng(n + k)
    a = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).to(DEV)
    w = _weights(n, n)
    S, v = cluster_sum.cluster_sum_cuda(x, a, k, weights=w)
    torch.cuda.synchronize()
    S_r, v_r = ref.cluster_sum_ref(x, a, k, weights=w)
    mass, vmass = ref.cluster_sum_ref(x.abs(), a, k, weights=w.abs())
    e = max(_mass_close(S, S_r, mass, "S"),
            _mass_close(v, v_r, vmass, "v"))
    S2, v2 = cluster_sum.cluster_sum_cuda(x, a, k, weights=w)
    need(torch.equal(S, S2) and torch.equal(v, v2),
         "cluster_sum is not deterministic")
    need(same_bits((S, v), ref.ordered_sums(x, k, a, w)),
         "cluster_sum differs from the order oracle")
    log(f"    cluster_sum n={n} d={d} k={k} (+1/0/-1 weights): max abs err "
        f"{e:.3g}, second run and the order oracle bit-identical")
    return e


def _nested_inputs(n, d, k):
    """A mixed mask: ~20% unseen, ~30% of the seen settled, ~10% invalid."""
    x, c = _x_c(n, d, k, 7 * n + k, torch.float32)
    rng = np.random.default_rng(n * 3 + k)
    a_prev = rng.integers(0, k, n).astype(np.int32)
    a_prev[rng.random(n) < 0.2] = -1
    settled = (rng.random(n) < 0.3) & (a_prev >= 0)
    d_keep = rng.random(n).astype(np.float32)
    lb_keep = rng.random(n).astype(np.float32)
    valid = rng.random(n) < 0.9
    host = (a_prev, settled, d_keep, lb_keep, valid)
    return [x, c] + [torch.from_numpy(h).to(DEV) for h in host]


def check_fused(n, d, k) -> float:
    from repro_torch.kernels import fused_round, ref
    args = _nested_inputs(n, d, k)
    got = fused_round.fused_nested_round_cuda(*args)
    torch.cuda.synchronize()
    want = fused_round.fused_nested_round_ref(*args)
    x, c, a_prev = args[:3]
    ties = _labels_ok(got[0], want[0], ref.pairwise_dist2(x, c),
                      TOL["f32"])
    e = max(_close(got[1], want[1], 1e-5, 1e-4, "d_new"),
            _close(got[2], want[2], 1e-5, 1e-4, "lb_new"))
    # the sums against the plain sums over the kernel's own labels (one
    # may differ from the plain label at a tie, moving a whole row)
    sums = fused_round.delta_sums(x, a_prev, got[0], got[1], k)
    new, old = got[0].clamp(0, k - 1), a_prev.clamp(0, k - 1)
    mass = (ref.cluster_sum_ref(x.abs(), new, k)[0]
            + ref.cluster_sum_ref(x.abs(), old, k)[0],
            ref.cluster_sum_ref(x[:, :0], new, k)[1]
            + ref.cluster_sum_ref(x[:, :0], old, k)[1],
            sums[2])
    for g, w, m, what in zip(got[3:], sums, mass, ("dS", "dv", "sse")):
        e = max(e, _mass_close(g, w, m, what, rtol=1e-4))
    # which of the two f32 sums is nearer the float64 one
    exact = torch.zeros(k, dtype=torch.float64, device=x.device).index_add_(
        0, new.long(), got[1].double() ** 2)
    log(f"    fused sse vs float64: kernel max abs err "
        f"{float((got[5].double() - exact).abs().max()):.4g}, plain "
        f"{float((sums[2].double() - exact).abs().max()):.4g}")
    # the recomputed rows' top-2 against the float64 oracle; the rest
    # pass through bit for bit
    a_prev, settled, d_keep, lb_keep, valid = args[2:]
    keep = valid & settled
    need(bool((got[0][~valid] == -1).all()) and not bool(got[1][~valid].any())
         and torch.equal(got[0][keep], a_prev[keep])
         and torch.equal(got[1][keep], d_keep[keep])
         and torch.equal(got[2][keep], lb_keep[keep]),
         "fused_nested_round: invalid or settled rows not as given")
    new_rows = valid & ~settled
    gap, _ = check_full_oracle(got[0][new_rows], got[1][new_rows],
                               got[2][new_rows], x[new_rows], c,
                               "fused_nested_round", squared=False)
    log(f"    fused_nested_round's top-2 on its {int(new_rows.sum())} "
        f"recomputed rows: {gap:.3g} of the scale from the float64 oracle "
        f"(held to {FULL_RTOL:g})")
    again = fused_round.fused_nested_round_cuda(*args)
    need(all(torch.equal(g, a) for g, a in zip(got, again)),
         "fused_nested_round is not deterministic")
    need(same_bits(got[3:], ref.ordered_sums(x, k, a_prev=a_prev,
                                             a_new=got[0], d_new=got[1])),
         "fused_nested_round's sums differ from the order oracle")
    log(f"    fused_nested_round n={n} d={d} k={k}: max abs err {e:.3g}, "
        f"tied labels {ties}, second run and the order oracle (sums) "
        f"bit-identical")
    return e


def check_ref_sums(n, d, k) -> None:
    """The plain sums on the card (`ref.cluster_sum_ref`, which takes
    `ref.onehot_sums` there): the same bits twice, and within
    cluster_sum's tolerance of ``index_add_``."""
    from repro_torch.kernels import ref
    x, _ = _x_c(n, d, 1, 3 * n + d, torch.float32)
    rng = np.random.default_rng(n + 2 * k)
    a = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).to(DEV)
    w = _weights(n, n + 1)
    got = ref.cluster_sum_ref(x, a, k, weights=w)
    again = ref.cluster_sum_ref(x, a, k, weights=w)
    need(same_bits(again, got), "the plain sums on the card are not "
         "deterministic")
    idx = a.long()
    xw = x * w[:, None]
    want = torch.zeros(k, d, device=DEV).index_add_(0, idx, xw)
    mass = torch.zeros(k, d, device=DEV).index_add_(0, idx, xw.abs())
    e = _mass_close(got[0], want, mass, "plain S against index_add_")
    e = max(e, _mass_close(got[1], torch.zeros(k, device=DEV).index_add_(
        0, idx, w), torch.zeros(k, device=DEV).index_add_(0, idx, w.abs()),
        "plain v against index_add_"))
    log(f"    plain sums n={n} d={d} k={k}: second run bit-identical, "
        f"{e:.3g} from index_add_")


def _chunked_sums(x, a, d1, k, rows=XL_PLAIN_ROWS):
    """Plain S, v, sse and the L1 mass of S over all rows of x by label
    a, summed over row chunks (the plain version cannot take all rows of
    the full-width round at once)."""
    from repro_torch.kernels import ref
    S = torch.zeros(k, x.shape[1], device=DEV)
    mass = torch.zeros_like(S)
    v = torch.zeros(k, device=DEV)
    sse = torch.zeros(k, device=DEV)
    for lo in range(0, x.shape[0], rows):
        xs, al = x[lo:lo + rows], a[lo:lo + rows]
        s, vv = ref.cluster_sum_ref(xs, al, k)
        S += s
        v += vv
        mass += ref.cluster_sum_ref(xs.abs(), al, k)[0]
        sse += ref.cluster_sum_ref(xs[:, :0], al, k,
                                   weights=d1[lo:lo + rows])[1]
    return S, v, sse, mass


def round_top2_exact(x, c):
    """The top-2 of kernel 4's plain version with x.c, |x|^2 and |c|^2
    each taken in float64 and rounded once to f32, the values nearest the
    exact ones (as tests/torch_round_oracle.py computes it)."""
    x64, c64 = x.double(), c.double()
    xn = (x64 * x64).sum(1).float()
    cn = (c64 * c64).sum(1).float()
    pd = (x64 @ c64.T).float().mul_(-2.0).add_(cn)
    del x64
    a = torch.argmin(pd, dim=1)
    b1 = torch.gather(pd, 1, a[:, None])[:, 0]
    if c.shape[0] == 1:
        b2 = torch.full_like(b1, float("inf"))
    else:
        b2 = pd.scatter_(1, a[:, None], float("inf")).min(dim=1).values
    return (a.to(torch.int32), torch.clamp_min(b1 + xn, 0.0),
            torch.clamp_min(b2 + xn, 0.0))


def top2_of(pd):
    """(a int32, d1, d2) of an (n, k) distance matrix: the lower index
    wins a tie, a duplicate of the min counts as the 2nd, k == 1 gives
    +inf."""
    a = torch.argmin(pd, dim=1)
    d1 = torch.gather(pd, 1, a[:, None])[:, 0]
    if pd.shape[1] == 1:
        d2 = torch.full_like(d1, float("inf"))
    else:
        d2 = pd.scatter_(1, a[:, None], float("inf")).min(dim=1).values
    return a.to(torch.int32), d1, d2


def assign_top2_exact(x, c):
    """The top-2 of the ref expression max(|x|^2 - 2 x.c + |c|^2, 0) with
    x.c, |x|^2 and |c|^2 each taken in float64 and rounded once to f32,
    the rest in f32 (as tests/torch_round_oracle.py computes it): what
    kernels 1 and 3 are held to at FULL_RTOL."""
    x64, c64 = x.double(), c.double()
    xn = (x64 * x64).sum(1).float()
    cn = (c64 * c64).sum(1).float()
    dot = (x64 @ c64.T).float()
    del x64
    return top2_of(torch.clamp_min(dot.mul_(-2.0).add_(xn[:, None])
                                   .add_(cn), 0.0))


def full_scale(x, c):
    """|x|^2 + max_j |c_j|^2 per row, f32: the scale of FULL_RTOL."""
    c64 = c.double()
    return ((x.double() ** 2).sum(1) + (c64 * c64).sum(1).max()).float()


def check_full_oracle(a, d1, d2, x, c, what, squared=True, plain=None):
    """Kernel 1's or 3's top-2 (a, d1, d2; euclidean unless ``squared``)
    against `assign_top2_exact`: labels equal but for near-ties, d1 and
    d2 within FULL_RTOL of the scale plus FULL_ATOL (plus the sqrt's own
    rounding where they are euclidean). Returns the largest error over
    the scale, and the plain version's d1 (``plain``, squared) gap over
    the scale (None without it)."""
    from repro_torch.kernels import ref
    want = assign_top2_exact(x, c)
    sc = full_scale(x, c).double()
    plain_gap = None
    if plain is not None:
        plain_gap = float(((plain.double() - want[1].double()).abs()
                           / sc).max())
    _labels_ok(a, want[0], ref.pairwise_dist2(x, c),
               FULL_RTOL * float(sc.max()) / 100 + FULL_ATOL)
    top = 0.0
    for g, w in zip((d1, d2), want[1:]):
        g, w = g.double(), w.double()
        if not squared:
            g = g * g
        fin = torch.isfinite(w)
        need(torch.equal(torch.isfinite(g), fin), f"{what}: +inf differs")
        err = torch.where(g == w, 0.0, (g - w).abs())[fin]
        slack = FULL_RTOL * sc[fin] + FULL_ATOL \
            + (0.0 if squared else 2.4e-7 * w[fin])
        if not err.numel():
            continue
        need(bool((err <= slack).all()), f"{what}: beyond the float64 "
             f"oracle's tolerance by {float((err - slack).max()):.3g}")
        top = max(top, float((err / sc[fin]).max()))
    return top, plain_gap


def _max_gap(got, want) -> float:
    err = torch.where(got == want, 0.0, (got - want).abs())
    return float(err.max()) if err.numel() else 0.0


def check_fused_round(x, c, plain_rows=None) -> float:
    """Kernel 4's top-2 on the last ``plain_rows`` rows (all rows if None)
    against `round_top2_exact`, its sums over all rows against plain
    sums; the d1 gaps to the plain version (an f32 product) are logged."""
    from repro_torch.kernels import fused_round, ref
    n, k = x.shape[0], c.shape[0]
    got = fused_round.fused_round_cuda(x, c)
    torch.cuda.synchronize()
    lo = 0 if plain_rows is None else n - plain_rows
    plain_d1 = fused_round.fused_round_ref(x[lo:], c)[1]
    want = round_top2_exact(x[lo:], c)
    a, d1, d2 = (t[lo:] for t in got[:3])
    need(a.dtype == torch.int32, "labels are not int32")
    # the kernel's distances are the partial distance plus |x|^2, which
    # is what the tie gap is measured in
    pd = torch.mm(x[lo:], c.T).mul_(-2.0).add_((c * c).sum(1)).add_(
        (x[lo:] * x[lo:]).sum(1)[:, None])
    ties = _labels_ok(a, want[0], pd, TOL["f32"], relative=True)
    del pd
    e = e1 = _close(d1, want[1], TOL["f32"], 1e-4, "d1")
    e2 = 0.0
    if k == 1:
        need(bool(torch.isinf(d2).all()), "k=1: d2 is not +inf")
    else:
        e2 = _close(d2, want[2], TOL["f32"], 1e-4, "d2")
        e = max(e, e2)
    # the sums against plain sums over the kernel's own labels (one may
    # differ from the plain label at a tie, moving a whole row)
    S, v, sse, mass = _chunked_sums(x, got[0], got[1], k)
    for g, w, m, what in zip(got[3:], (S, v, sse), (mass, v, sse),
                             ("S", "v", "sse")):
        e = max(e, _mass_close(g, w, m, what, rtol=1e-4))
    again = fused_round.fused_round_cuda(x, c)
    need(all(torch.equal(g, a2) for g, a2 in zip(got, again)),
         "fused_round is not deterministic")
    del again
    need(same_bits(got[3:], ref.ordered_sums(x, k, got[0], d1sq=got[1])),
         "fused_round's sums differ from the order oracle")
    rows = "all" if plain_rows is None else f"the last {plain_rows}"
    log(f"    fused_round n={n} d={x.shape[1]} k={k} (top-2 on {rows} rows)"
        f": max abs err {e:.3g} (d1 {e1:.3g}, d2 {e2:.3g} from the "
        f"once-rounded float64 values), tied labels {ties}, second run "
        f"and the order oracle (S, v, sse) bit-identical; d1 "
        f"{_max_gap(d1, plain_d1):.3g} from the plain "
        f"version's f32 product, which is {_max_gap(plain_d1, want[1]):.3g}"
        f" from the once-rounded values")
    return e


def compare_phase() -> dict:
    log("[3] kernels against their plain versions on the card")
    err = {
        "assign_top2": check_assign(N, D, K, "f32"),
        "cluster_sum": check_cluster_sum(N, D, K),
        "fused_nested_round": check_fused(N, D, K),
    }
    check_assign(N, D, K, "bf16")
    for n, d, k in ((4099, D, 1), (4099, D, 257), (1000, 200, 257),
                    (777, 33, 50)):
        check_assign(n, d, k, "f32")
        check_cluster_sum(n, d, k)
        check_fused(n, d, k)
    check_cluster_sum(5000, 0, K)        # counts only
    check_ref_sums(N, D, K)
    check_ref_sums(2 ** 16, D_XL, K_XL)
    for n, d, k in ((4099, D, 1), (4099, D, 257), (777, 33, 50),
                    (N, D, K)):
        check_fused_round(*_x_c(n, d, k, 5 * n + k, torch.float32))
    return err


# ---------------------------------------------------------------- phase 4

def profile_report(prof, wall_s: float, wall_profiled_s: float,
                   what: str = "fit") -> None:
    """The profiled run's device work (kernels and copies, each counted
    once: an operator's own entry would count its kernels again), its
    share of the run's wall time, and the host calls that took longest.
    ``wall_s`` is the wall time of the same run unprofiled."""
    events = prof.key_averages()
    # a schedule's step span is a range on the device, not device work
    dev = sorted((e for e in events if str(e.device_type).endswith("CUDA")
                  and not e.key.startswith("ProfilerStep")),
                 key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    log(f"    profile: device busy {busy_ms:.1f} ms = "
        f"{busy_ms / 10 / wall_profiled_s:.1f} % of the profiled {what}'s "
        f"wall {wall_profiled_s:.2f} s ({busy_ms / 10 / wall_s:.1f} % of "
        f"the unprofiled {what}'s {wall_s:.2f} s)")
    for e in dev[:12]:
        log(f"      device {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:7d}x  {e.key[:90]}")
    host = sorted(events, key=lambda e: e.self_cpu_time_total,
                  reverse=True)
    for e in host[:8]:
        log(f"      host   {e.self_cpu_time_total / 1e3:9.2f} ms "
            f"{e.count:7d}x  {e.key[:90]}")


#: phase 4's config: the paper's infMNIST experiment
MAIN_CONFIG = dict(b0=5000, algorithm="tb", rho=math.inf, bounds="hamerly2",
                   seed=0)


def fit_once(X, Xv, **kw):
    """Phase 4's fit, with ``kw`` over its config."""
    from repro_torch.api import FitConfig, NestedKMeans
    cfg = FitConfig(k=K, **dict(MAIN_CONFIG, **kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    km = NestedKMeans(cfg, device=DEV).fit(X, X_val=Xv)
    torch.cuda.synchronize()
    return km, time.perf_counter() - t0


#: host calls that wait for the device, as torch.profiler names them
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
#: the fit's tensor-core top-2s by the name the profiler gives them:
#: assign_top2 (EPI_FULL) and the nested round (EPI_NESTED) at BN = 64
FIT_TOP2 = {"nkm::tc::tc_top2_kernel<64, 2>": "assign_top2's top-2",
            "nkm::tc::tc_top2_kernel<64, 3>": "the nested round's top-2",
            "nkm::tc::split_c_kernel": "c split and |c|^2"}


def sync_counts(prof) -> dict:
    """{host call: count} of the calls that wait for the device."""
    out = dict.fromkeys(SYNC_CALLS, 0)
    for e in prof.key_averages():
        if e.key in out:
            out[e.key] += e.count
    return out


def _schedule(km) -> str:
    return " ".join(f"{r.b}:{r.n_recomputed}" for r in km.telemetry_
                    if r.batch_mse is not None)


def main_path_phase() -> dict:
    from repro_torch.data.synthetic import infmnist_like
    from repro_torch.kernels import ops, ref
    t0 = time.perf_counter()
    X = infmnist_like(N, seed=0)
    Xv = infmnist_like(N_VAL, seed=1)
    log(f"[4] data: infmnist_like {X.shape} + {Xv.shape} in "
        f"{time.perf_counter() - t0:.1f} s (host)")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    km, wall = fit_once(X, Xv)
    labels = km.predict(X)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tel = [r for r in km.telemetry_ if r.batch_mse is not None]
    log(f"    cuda fit: {km.n_rounds_} records, {len(tel)} rounds, final b "
        f"{km.telemetry_[-1].b}, sum n_recomputed "
        f"{sum(r.n_recomputed for r in tel)}, converged {km.converged_}, "
        f"final val MSE {km.final_mse_!r}, wall {wall:.2f} s, peak device "
        f"memory {peak / 2 ** 30:.2f} GiB")
    log(f"    launches on the main path (fit + predict): {launches}")
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(launches[name] > 0, f"{name} was never launched on the main "
             f"path")

    C = km.cluster_centers_
    need(C.shape == (K, D) and bool(np.isfinite(C).all()),
         "centroids are not finite (k, d)")
    need(labels.shape == (N,) and labels.dtype == np.int32
         and labels.min() >= 0 and labels.max() < K, "predict labels")
    need(km.labels_.shape == (N,) and (km.labels_ >= 0).all(),
         "fit labels")
    agree = float((labels == km.labels_).mean())
    log(f"    predict(X) agrees with the fit's labels on {agree:.6f} of rows")
    need(km.converged_ is False or agree == 1.0,
         "a converged fit's labels differ from predict")
    # predict against the plain assignment on a small input
    xs = torch.from_numpy(X[:2000]).to(DEV)
    a_ref = ref.assign_top2_ref(xs, torch.from_numpy(C).to(DEV))[0]
    need(bool((a_ref.cpu().numpy() == labels[:2000]).mean() > 0.999),
         "predict disagrees with the plain assignment")

    # the second fit runs under torch.profiler: where the fit's time goes
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        km2, wall2 = fit_once(X, Xv)
    same = np.array_equal(km2.cluster_centers_, C) \
        and np.array_equal(km2.labels_, km.labels_)
    log(f"    second cuda fit (profiled): wall {wall2:.2f} s, bit-identical "
        f"centroids and labels: {same}")
    need(same, "a second identical fit is not bit-identical")
    profile_report(prof, wall, wall2)
    scatter_report(prof, "fit")
    syncs = sync_counts(prof)
    log(f"    host calls that wait for the device in the profiled fit: "
        f"{sum(syncs.values())} ({syncs}) in {len(tel)} rounds")
    parts = device_parts(prof, FIT_TOP2)
    log("    the tensor-core top-2s in the profiled fit: " + ", ".join(
        f"{what} ({name}) {parts[name][0]:.2f} ms in {parts[name][1]} "
        f"launches" for name, what in FIT_TOP2.items()))
    for name in list(FIT_TOP2)[:2]:
        need(parts[name][1] > 0, f"the profiled fit shows no {name}")

    kmr, wallr = fit_once(X, Xv, kernel_backend="ref")
    kmr2, wallr2 = fit_once(X, Xv, kernel_backend="ref")
    rel = abs(kmr.final_mse_ - km.final_mse_) / abs(kmr.final_mse_)
    same_ref = np.array_equal(kmr2.cluster_centers_, kmr.cluster_centers_) \
        and np.array_equal(kmr2.labels_, kmr.labels_)
    log(f"    ref fit (plain versions on the card): {kmr.n_rounds_} records,"
        f" final val MSE {kmr.final_mse_!r}, wall {wallr:.2f} s, relative "
        f"gap {rel:.3g}; a second ref fit (wall {wallr2:.2f} s): final val "
        f"MSE {kmr2.final_mse_!r}, bit-identical centroids and labels: "
        f"{same_ref}")
    log(f"    schedule cuda (b:n_recomputed): {_schedule(km)}")
    log(f"    schedule ref  (b:n_recomputed): {_schedule(kmr)}")
    split = next((i for i, (u, v) in enumerate(zip(
        [r for r in km.telemetry_ if r.batch_mse is not None],
        [r for r in kmr.telemetry_ if r.batch_mse is not None]))
        if (u.b, u.n_recomputed) != (v.b, v.n_recomputed)), None)
    log(f"    the cuda and ref schedules part at round {split}")
    need(rel <= 1e-3, "cuda and ref fits differ in val MSE beyond 1e-3")
    need(same_ref, "two ref fits on the card differ")
    shadow_fit(X, Xv, km)
    return {"launches": launches, "X": X, "Xv": Xv, "curve": _curve(km),
            "fit": fit_record(km), "outcome": km.outcome_}


def shadow_fit(X, Xv, km) -> None:
    """Where the kernels' fit parts from the plain versions': the cuda
    fit once more, each round's step also taken on the plain versions
    (``kernel_backend="ref"``) from the same input state. The bound
    decisions are the same code on the same state, so a round's
    recomputations agree; its outputs may differ only where the top-2s
    differ, and a label may differ only at a near-tie (float64 distances
    to the two centroids within 1e-3 relative). Those rows, and the last
    bits of d and lb, are what a later round's decisions then see. The
    fit itself must keep the cuda fit's bits."""
    import dataclasses

    from repro_torch.api import FitConfig
    from repro_torch.api.engines.local import LocalEngine
    from repro_torch.api.loop import run_loop
    from repro_torch.core import rounds
    cfg = FitConfig(k=K, b0=5000, algorithm="tb", rho=math.inf,
                    bounds="hamerly2", seed=0).resolve(N)
    run = LocalEngine().begin(X, cfg, X_val=Xv, device=DEV)
    plain = dataclasses.replace(run.kernel_plan, backend="ref")
    step = run.nested_step
    seen = {"rounds": 0, "rows": 0, "worst": 0, "lb_bits": 0, "top": 0.0}

    def both(state, b, capacity):
        out = step(state, b, capacity)
        alt = rounds.nested_round(
            run._Xd, state, b=b, rho=cfg.rho, bounds=cfg.bounds,
            capacity=capacity, use_shalf=cfg.use_shalf, plan=plain)
        need(int(out[1].n_recomputed) == int(alt[1].n_recomputed),
             "the cuda and plain steps recompute different rows from one "
             "state")
        rows, _, gap = _near_ties(run._Xd[:b], state.stats.C,
                                  out[0].points.a[:b], alt[0].points.a[:b])
        seen["top"] = max(seen["top"], gap)
        seen["rounds"] += 1
        seen["rows"] += rows
        seen["worst"] = max(seen["worst"], rows)
        seen["lb_bits"] += int((out[0].points.lb[:b]
                                != alt[0].points.lb[:b]).sum())
        return out

    run.nested_step = both
    out = run_loop(run, cfg)
    # break the cycle run -> both -> run, so that run's copy of X leaves
    # the card when this returns and not at the next garbage collection
    del run.nested_step
    need(np.array_equal(out.C, km.cluster_centers_),
         "the shadowed fit differs from the cuda fit")
    log(f"    shadow fit (each round's step also on the plain versions from "
        f"the same state): {seen['rounds']} steps, the same recomputations "
        f"in each; labels differ at {seen['rows']} rows in all (at most "
        f"{seen['worst']} in a step), every one a near-tie (largest float64 "
        f"gap {seen['top']:.3g} relative); lb differs in its last bits at "
        f"{seen['lb_bits']} rows in all")


# ---------------------------------------------------------------- phase 5

def time_ms(fn, iters: int = 10) -> float:
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


def bound(n_bytes: float, flops: float, tf32_flops: float = 0.0):
    """The least time (ms) for the work, and what bounds it: the larger of
    the bytes over the memory rate and the operations over the peak rate
    of their type (``flops`` f32 on the CUDA cores, ``tf32_flops`` TF32 on
    the tensor cores)."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = (flops / PEAK_F32_FLOPS + tf32_flops / PEAK_TF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing_phase(X) -> dict:
    from repro_torch.kernels import cluster_sum, fused_round, kmeans_assign
    from repro_torch.kernels import ref
    log("[5] kernel times at the main-path shape (CUDA events, mean of 10 "
        "after one warm-up)")
    x = torch.from_numpy(X).to(DEV)
    c = x[:K].clone()
    out = {}

    # the tensor-core top-2s' operations: 3xTF32 over the k tiles they
    # run (k = 50 runs one 64-wide tile)
    k_pad = 64 if K <= 64 else -(-K // 128) * 128
    tc_ops = 3 * 2.0 * N * k_pad * D
    mm_ms = time_ms(lambda: torch.mm(x, c.T))
    log(f"    yardstick: cuBLAS f32 torch.mm of x.c^T at ({N}, {D}) x ({K}, "
        f"{D}): {mm_ms:.3f} ms (not the same function; not in the kernels "
        f"line)")
    b, how = bound(N * D * 4 + K * D * 4 + N * 12, 0.0, tf32_flops=tc_ops)
    out["assign_top2"] = dict(
        ms=time_ms(lambda: kmeans_assign.assign_top2_cuda(x, c)),
        plain_ms=time_ms(lambda: ref.assign_top2_ref(x, c)),
        library_ms=None, bound_ms=b, bound_by=how)

    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(0, K, N).astype(np.int32)).to(DEV)
    w = _weights(N, 2)
    nz = int((w != 0).sum())
    b, how = bound(nz * D * 4 + N * 8 + (K * D + K) * 4, 2.0 * nz * D)
    a64 = a.long()
    xw = x * w[:, None]
    S0 = torch.zeros(K, D, device=DEV)
    out["cluster_sum"] = dict(
        ms=time_ms(lambda: cluster_sum.cluster_sum_cuda(
            x, a, K, weights=w)),
        plain_ms=time_ms(lambda: ref.cluster_sum_ref(
            x, a, K, weights=w)),
        library_ms=time_ms(lambda: S0.index_add_(0, a64, xw)),
        bound_ms=b, bound_by=how)
    del xw

    args = [x, c] + _nested_inputs(N, 1, K)[2:]
    a_prev = args[2]
    a_new = fused_round.fused_nested_round_cuda(*args)[0]
    # rows that add to dS: joins, new rows and leaves
    moved = int((((a_prev < 0) & (a_new >= 0))
                 | ((a_prev >= 0) & (a_new != a_prev))).sum())
    b, how = bound(N * D * 4 + K * D * 4 + N * (14 + 12)
                   + (K * D + 2 * K) * 4, 2.0 * moved * D, tf32_flops=tc_ops)
    out["fused_nested_round"] = dict(
        ms=time_ms(lambda: fused_round.fused_nested_round_cuda(*args)),
        plain_ms=time_ms(lambda: fused_round.fused_nested_round_ref(
            *args)),
        library_ms=None, bound_ms=b, bound_by=how)
    for name, r in out.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.3f} ms")
        log(f"    {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}"
            f" ms, library {lib}, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}), {r['bound_ms'] / r['ms'] * 100:.1f} % of "
            f"it")
    return out


# ---------------------------------------------------------------- phase 6

def xl_data(seed: int = 0):
    """Gaussian blobs on the card, the recipe of ``gaussian_blobs``
    (centres N(0, 5^2), unit noise): 4096 centres, then the labels, then
    the noise, to which each row's centre is added in place, so the peak
    stays near the 16 GiB of X. C0 is the first k rows (the paper's
    init)."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    centres = torch.randn(K_XL, D_XL, generator=g, device=DEV) * 5.0
    labels = torch.randint(0, K_XL, (N_XL,), generator=g, device=DEV)
    X = torch.randn(N_XL, D_XL, generator=g, device=DEV)
    for lo in range(0, N_XL, XL_PLAIN_ROWS):
        X[lo:lo + XL_PLAIN_ROWS] += centres[labels[lo:lo + XL_PLAIN_ROWS]]
    return X, X[:K_XL].clone()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _timed(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _near_ties(X, C, a, b):
    """Rows whose labels a and b differ must be near-ties: their float64
    distances to the two centroids within 1e-3 relative (100x the f32
    rtol). Returns the count of such rows, of those where a's centroid is
    the nearer in float64, and their largest relative gap."""
    diff = torch.nonzero(a != b)[:, 0]
    if not diff.numel():
        return 0, 0, 0.0
    x = X[diff].double()
    da = ((x - C[a[diff].long()].double()) ** 2).sum(1)
    db = ((x - C[b[diff].long()].double()) ** 2).sum(1)
    gap = (da - db).abs() / da
    need(bool((gap <= 1e-3).all()),
         f"two label sets differ beyond a near-tie at {diff.numel()} rows")
    return int(diff.numel()), int((da < db).sum()), float(gap.max())


def exact_labels(X, C, rows=XL_CHECK_ROWS):
    """The float64 argmin of |c|^2 - 2 x.c for every row of X (the lower
    index wins a tie), in row chunks."""
    C64 = C.double()
    cn = (C64 * C64).sum(1)
    a = torch.empty(X.shape[0], dtype=torch.int32, device=DEV)
    for lo in range(0, X.shape[0], rows):
        pd = torch.addmm(cn, X[lo:lo + rows].double(), C64.T, alpha=-2.0)
        a[lo:lo + rows] = pd.argmin(dim=1)
        del pd
    return a


def _rel_gap(C, C_ref) -> float:
    return float(torch.linalg.norm(C - C_ref) / torch.linalg.norm(C_ref))


#: kernel 4's device kernels, by the name the profiler gives them
TOP2_KERNEL = "nkm::tc::tc_top2_kernel<128, 1>"
SCATTER_KERNEL = "nkm::scatter_rows<2>"
ROUND_PARTS = {TOP2_KERNEL: "top-2 (tensor cores, 3xTF32)",
               "nkm::bucket_rows<2>": "scatter: row lists",
               SCATTER_KERNEL: "scatter: sums over the lists",
               "nkm::reduce_chunks": "scatter: chunk reduction",
               "nkm::tc::split_c_kernel": "c split and |c|^2",
               "nkm::tc::sqnorm_kernel": "|x|^2"}
#: the scatter's device kernels in all modes (cluster_sum is mode 0)
SCATTER_PARTS = {"nkm::bucket_rows": "row lists",
                 "nkm::scatter_rows": "sums over the lists",
                 "nkm::reduce_chunks": "chunk reduction"}


def device_parts(prof, names) -> dict:
    """{name: (device ms, launches)} of the device kernels whose name
    holds each of ``names``, in a profiled run."""
    out = dict.fromkeys(names, (0.0, 0))
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            for name in names:
                if name in e.key:
                    ms, count = out[name]
                    out[name] = (ms + e.self_device_time_total / 1e3,
                                 count + e.count)
    return out


def scatter_report(prof, run: str) -> None:
    """Logs the scatter's device time in a profiled run, by pass."""
    parts = device_parts(prof, SCATTER_PARTS)
    total = sum(ms for ms, _ in parts.values())
    log(f"    the scatter in the profiled {run}: {total:.2f} ms device ("
        + ", ".join(f"{what} {parts[name][0]:.2f} ms in "
                    f"{parts[name][1]} launches"
                    for name, what in SCATTER_PARTS.items()) + ")")


def fused_round_parts(prof) -> dict:
    """Device ms of each of kernel 4's kernels in a profiled run."""
    out = {name: ms for name, (ms, _) in
           device_parts(prof, ROUND_PARTS).items()}
    log("    fused_round's parts in the profiled dp step: " + ", ".join(
        f"{what} ({name}) {out[name]:.1f} ms"
        for name, what in ROUND_PARTS.items()))
    scatter = sum(out[name] for name in ROUND_PARTS
                  if name.split("<")[0] in SCATTER_PARTS)
    log(f"    the scatter's three passes together: {scatter:.1f} ms")
    return out


def trace_again(step, report) -> None:
    """Runs ``step`` twice under a new trace, the second time traced,
    after a pause; ``report`` reads the trace."""
    from torch.profiler import ProfilerActivity, profile, schedule
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1),
                   on_trace_ready=report)
    with prof:
        for i in range(2):
            if i == 1:
                time.sleep(0.2)
            step()
            prof.step()


def dp_round_phase(X, C0):
    """The data-parallel round at full width: 3 fused Lloyd steps, two
    steps under a one-rank NCCL mesh, one unfused step; returns the
    launch counts of that run."""
    import torch.distributed as dist
    from repro_torch.core.distributed import make_dp_round
    from repro_torch.core.state import ClusterStats, centroid_update
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    fused = make_dp_round(None, fused=True)
    C, mses, walls = C0, [], []
    # where the step's time goes: step 0 runs untraced, step 1 warms the
    # tracer up, step 2 is traced and reported. A step launched at the
    # very start of a trace lost its first kernels (the 1.3 s top-2
    # among them) in some runs, so the traced step waits a moment first.
    parts = {}

    def report(p):
        profile_report(p, walls[0], walls[-1], what="dp step")
        parts.update(fused_round_parts(p))

    prof = profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=1, warmup=1, active=1),
        on_trace_ready=report)
    with prof:
        for i in range(3):
            if i == 2:
                time.sleep(0.2)
            out, wall = _timed(fused, X, C)
            C_in, C = C, out[0]
            mses.append(float(out[7]))
            walls.append(wall)
            need(C.shape == (K_XL, D_XL) and bool(torch.isfinite(C).all()),
                 "dp round: centroids are not finite (k, d)")
            need(out[3].shape == (N_XL,) and int(out[3].min()) >= 0
                 and int(out[3].max()) < K_XL, "dp round: labels")
            log(f"    fused dp step {i}: batch MSE {mses[-1]!r}, wall "
                f"{wall:.3f} s")
            prof.step()
    for m0, m1 in zip(mses, mses[1:]):
        need(m1 <= m0 * (1 + 1e-6), "the batch MSE rose in a Lloyd step")
    # torch.profiler on the card has lost the kernels of a traced step in
    # some runs (the launch counts show they ran): the last step is traced
    # again, at most twice, until its trace holds the top-2 and the scatter
    retraced = 0
    while retraced < 2 and not all(parts.get(name, 0.0) > 0.0
                                   for name in (TOP2_KERNEL, SCATTER_KERNEL)):
        log("    the trace lost the step's kernels; the last step is traced "
            "again")
        trace_again(lambda: walls.append(_timed(fused, X, C_in)[1]), report)
        retraced += 1

    # one rank over NCCL: the collective path must give the same bits
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        mesh_step = make_dp_round(make_host_mesh((1,), ("data",)),
                                  fused=True)
        # the first collective also sets NCCL's communicator up
        runs = [_timed(mesh_step, X, C_in) for _ in range(2)]
    finally:
        dist.destroy_process_group()
    same = all(torch.equal(g, w) for on_mesh, _ in runs
               for g, w in zip(on_mesh, out))
    log(f"    one-rank NCCL mesh steps: wall {runs[0][1]:.3f} s (first, "
        f"with NCCL's set-up), {runs[1][1]:.3f} s; bit-identical to "
        f"mesh=None: {same}")
    need(same, "the one-rank NCCL dp step differs from mesh=None")

    unfused, wall_u = _timed(make_dp_round(None, fused=False), X, C_in)
    ties, nearer, _ = _near_ties(X, C_in, out[3], unfused[3])
    moved = torch.unique(torch.cat([out[3][out[3] != unfused[3]],
                                    unfused[3][out[3] != unfused[3]]]))
    kept = torch.ones(K_XL, dtype=torch.bool, device=DEV)
    kept[moved.long()] = False
    # the round the steps approximate: every row at its float64 argmin,
    # summed by the plain version in row chunks
    a64 = exact_labels(X, C_in)
    off_f = _near_ties(X, C_in, out[3], a64)[0]
    off_u = _near_ties(X, C_in, unfused[3], a64)[0]
    S, v = _chunked_sums(X, a64, out[4], K_XL)[:2]
    zero = torch.zeros_like(v)
    C64 = centroid_update(ClusterStats(C=C_in, S=S, v=v, sse=zero,
                                       p=zero)).C
    del a64, S
    gap_f, gap_u = _rel_gap(out[0], C64), _rel_gap(unfused[0], C64)
    gap_fu = _rel_gap(unfused[0], out[0])
    log(f"    unfused dp step (kernels 1 + 2): wall {wall_u:.3f} s, labels "
        f"differ from the fused step's at {ties} near-tied rows (the fused "
        f"label nearer in float64 at {nearer}), C bit-identical on the "
        f"{int(kept.sum())} clusters no such row touches, C relative gap "
        f"{gap_fu:.3g} (held to 1e-4)")
    log(f"    against the float64 argmin of every row: the fused labels "
        f"differ at {off_f} near-tied rows, the unfused at {off_u}; C "
        f"relative gap to the C of those labels: fused {gap_f:.3g} (held "
        f"to 1e-4), unfused {gap_u:.3g}")
    need(torch.equal(unfused[0][kept], out[0][kept]),
         "fused and unfused C differ on clusters with the same rows")
    need(gap_fu <= 1e-4, "the fused and unfused steps' C differ beyond "
         "1e-4 relative")
    need(gap_f <= 1e-4, "the fused step's C differs beyond 1e-4 relative "
         "from the C of the float64 labels")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"    launches on the dp path ({3 + 2 * retraced} fused + 2 mesh + 1 "
        f"unfused step): "
        f"{launches}; peak device memory {peak / 2 ** 30:.2f} GiB")
    need(launches["fused_round"] > 0,
         "fused_round was never launched on the dp path")
    for name in (TOP2_KERNEL, SCATTER_KERNEL):
        need(parts.get(name, 0.0) > 0.0,
             f"the profiled dp step shows no {name}")
    return launches, parts


def xl_phase() -> dict:
    from repro_torch.kernels import fused_round
    t0 = time.perf_counter()
    X, C0 = xl_data()
    torch.cuda.synchronize()
    log(f"[6] kmeans_xl: X {tuple(X.shape)} f32 "
        f"({X.numel() * 4 / 2 ** 30:.1f} GiB) made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    err = check_fused_round(X, C0, plain_rows=XL_CHECK_ROWS)
    launches, parts = dp_round_phase(X, C0)

    n, d, k = N_XL, D_XL, K_XL
    n_bytes = n * d * 4 + k * d * 4 + n * 12 + (k * d + 2 * k) * 4
    # the distances in 3xTF32 on the tensor cores, the adds into S in f32
    b, how = bound(n_bytes, 1.0 * n * d, tf32_flops=3 * 2.0 * n * k * d)
    b_f32, _ = bound(n_bytes, 2.0 * n * k * d + 1.0 * n * d)
    xs = X[:XL_PLAIN_ROWS]
    mm_ms = time_ms(lambda: torch.mm(xs, C0.T), iters=3) \
        * (n / XL_PLAIN_ROWS)
    log(f"    yardstick: cuBLAS f32 torch.mm of x.c^T on the "
        f"({XL_PLAIN_ROWS}, {d}) slice, scaled to n={n}: {mm_ms:.3f} ms "
        f"(not the same function; not in the kernels line)")
    t = dict(
        ms=time_ms(lambda: fused_round.fused_round_cuda(X, C0), iters=3),
        plain_ms=time_ms(lambda: fused_round.fused_round_ref(xs, C0),
                         iters=3),
        library_ms=None, bound_ms=b, bound_by=how)
    top2 = parts[TOP2_KERNEL]
    log(f"    fused_round at n={n} d={d} k={k}: kernel {t['ms']:.3f} ms "
        f"(mean of 3 after a warm-up), bound {b:.3f} ms ({how}: 3xTF32 at "
        f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s), {b / t['ms'] * 100:.1f} % "
        f"of it; the CUDA-core f32 bound {b_f32:.3f} ms; its top-2 "
        f"{top2:.1f} ms in the profile ({b / top2 * 100:.1f} % of the "
        f"bound); plain {t['plain_ms']:.3f} ms on a ({XL_PLAIN_ROWS}, {d}) "
        f"slice, library n/a")
    return {"err": err, "launches": launches, "times": t}


# ---------------------------------------------------------------- phase 7

#: the paper's other algorithms and bound families at the infMNIST cell's
#: width: (name, FitConfig over phase 4's, the kernels its fit must launch)
OTHER_PATHS = (
    ("lloyd", dict(algorithm="lloyd", max_rounds=100),
     ("assign_top2", "cluster_sum")),
    ("mb", dict(algorithm="mb", b0=2000, max_rounds=400),
     ("assign_top2", "cluster_sum")),
    ("mbf", dict(algorithm="mbf", b0=2000, max_rounds=400),
     ("assign_top2", "cluster_sum")),
    ("tb-elkan", dict(bounds="elkan"), ("cluster_sum",)),
    ("tb-exponion", dict(bounds="exponion"), ("cluster_sum",)),
    ("lloyd-elkan", dict(algorithm="lloyd-elkan", max_rounds=100),
     ("cluster_sum",)),
)


def _curve(km) -> list:
    """(time in the rounds, validation MSE) at each evaluation."""
    return [(r.t, r.val_mse) for r in km.telemetry_
            if r.val_mse is not None]


def _curve_text(curve) -> str:
    return " ".join(f"{t:.4f}:{m:.6f}" for t, m in curve)


def other_paths_phase(X, Xv, tb_curve) -> dict:
    """Fits each path of OTHER_PATHS; returns {name: `fit_record` of its
    first fit}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    log(f"[7] the other algorithms and bound families on phase 4's rows "
        f"({N}, {D}), k={K}")
    log(f"    tb (phase 4) val MSE against the rounds' time (s:MSE): "
        f"{_curve_text(tb_curve)}")
    fits = {}
    for name, kw, kernels in OTHER_PATHS:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        km, wall = fit_once(X, Xv, **kw)
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        tel = [r for r in km.telemetry_ if r.batch_mse is not None]
        log(f"    {name}: {len(tel)} rounds, converged {km.converged_}, "
            f"sum n_recomputed {sum(r.n_recomputed for r in tel)}, final "
            f"val MSE {km.final_mse_!r}, wall {wall:.2f} s (rounds "
            f"{km.telemetry_[-1].t:.3f} s), peak device memory "
            f"{peak / 2 ** 30:.2f} GiB")
        log(f"      launches: {launches}")
        for kern in kernels:
            need(launches[kern] > 0, f"{kern} was never launched on the "
                 f"{name} path")
        C, labels = km.cluster_centers_, km.labels_
        need(C.shape == (K, D) and bool(np.isfinite(C).all()),
             f"{name}: centroids are not finite (k, d)")
        need(labels.shape == (N,) and labels.min() >= 0
             and labels.max() < K, f"{name}: fit labels")
        # the second fit runs under torch.profiler: where its time goes
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            km2, wall2 = fit_once(X, Xv, **kw)
        same = np.array_equal(km2.cluster_centers_, C) \
            and np.array_equal(km2.labels_, labels)
        profile_report(prof, wall, wall2)
        syncs = sync_counts(prof)
        log(f"      host calls that wait for the device in the profiled "
            f"fit: {sum(syncs.values())} ({syncs})")
        kmr, wallr = fit_once(X, Xv, kernel_backend="ref", **kw)
        rel = abs(kmr.final_mse_ - km.final_mse_) / abs(kmr.final_mse_)
        n_ref = sum(r.batch_mse is not None for r in kmr.telemetry_)
        log(f"      second fit (wall {wall2:.2f} s) bit-identical: {same}; "
            f"ref fit: {n_ref} rounds, val MSE {kmr.final_mse_!r}, wall "
            f"{wallr:.2f} s, relative gap {rel:.3g}")
        log(f"      val MSE against the rounds' time (s:MSE): "
            f"{_curve_text(_curve(km))}")
        need(same, f"{name}: a second identical fit is not bit-identical")
        need(rel <= 1e-3, f"{name}: cuda and ref fits differ in val MSE "
             f"beyond 1e-3")
        if name.startswith("tb-"):
            shadow_bounds(X, Xv, km, kw)
        fits[name] = fit_record(km)
    return fits


def shadow_bounds(X, Xv, km, kw) -> None:
    """The bound family's fit once more, each round's step also taken
    with ``bounds="none"`` (every active row scans all k) from the same
    state: a bound only skips work that cannot change an assignment, so
    a label may differ from the exhaustive step's only at a near-tie
    (float64 distances to the two centroids within 1e-3 relative). The
    fit itself must keep its bits."""
    from repro_torch.api import FitConfig
    from repro_torch.api.engines.local import LocalEngine
    from repro_torch.api.loop import run_loop
    from repro_torch.core import rounds
    cfg = FitConfig(k=K, **dict(MAIN_CONFIG, **kw)).resolve(N)
    run = LocalEngine().begin(X, cfg, X_val=Xv, device=DEV)
    step = run.nested_step
    seen = {"rounds": 0, "rows": 0, "worst": 0, "top": 0.0}

    def both(state, b, capacity):
        out = step(state, b, capacity)
        alt = rounds.nested_round(
            run._Xd, state, b=b, rho=cfg.rho, bounds="none",
            capacity=capacity, use_shalf=cfg.use_shalf, plan=run.kernel_plan)
        rows, _, gap = _near_ties(run._Xd[:b], state.stats.C,
                                  out[0].points.a[:b], alt[0].points.a[:b])
        seen["top"] = max(seen["top"], gap)
        seen["rounds"] += 1
        seen["rows"] += rows
        seen["worst"] = max(seen["worst"], rows)
        return out

    run.nested_step = both
    out = run_loop(run, cfg)
    del run.nested_step       # the cycle run -> both -> run holds X
    need(np.array_equal(out.C, km.cluster_centers_),
         f"the shadowed {cfg.bounds} fit differs from its fit")
    log(f"      shadow fit (each round's step also with bounds='none' from "
        f"the same state): {seen['rounds']} steps; labels differ at "
        f"{seen['rows']} rows in all (at most {seen['worst']} in a step), "
        f"every one a near-tie (largest float64 gap {seen['top']:.3g} "
        f"relative)")


# ---------------------------------------------------------------- phase 8

#: the checkpointed fits of phase 8: (name, config over phase 4's,
#: save_every, the kernels the resumed part must launch)
RESUMED_PATHS = (
    ("tb-hamerly2", {}, 25, ("assign_top2", "cluster_sum")),
    ("tb-elkan", dict(bounds="elkan"), 50, ("cluster_sum",)),
    ("mb", dict(algorithm="mb", b0=2000, max_rounds=400), 50,
     ("assign_top2", "cluster_sum")),
)
#: the round whose ``on_round`` kills each checkpointed fit
KILL_ROUND = 137
STORE_CHUNK_ROWS = 65_536


class Killed(Exception):
    """Raised by ``on_round`` to kill a checkpointed fit mid-run."""


def _tel_minus_t(km) -> list:
    out = []
    for r in km.telemetry_:
        r = r.to_dict()
        r.pop("t")
        out.append(r)
    return out


def fit_record(km):
    """What phase 8 holds a fit to (C, labels, telemetry), on the host:
    the fit's state leaves the card."""
    import types
    return types.SimpleNamespace(cluster_centers_=km.cluster_centers_,
                                 labels_=km.labels_,
                                 telemetry_=km.telemetry_)


def _same_fit(got, want, labels_perm=None) -> bool:
    """C, labels and telemetry without ``t`` bit-equal; ``labels_perm``
    maps ``got``'s labels to ``want``'s rows."""
    labels = got.labels_ if labels_perm is None else got.labels_[labels_perm]
    return (np.array_equal(got.cluster_centers_, want.cluster_centers_)
            and np.array_equal(labels, want.labels_)
            and _tel_minus_t(got) == _tel_minus_t(want))


def _counted(launches: dict, fn):
    """Runs ``fn`` with the launch counts set to 0 just before and read
    just after; adds them into ``launches`` and returns (result, its
    counts)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name, n in counts.items():
        launches[name] += n
    return out, counts


def store_fit(X, Xv, root: str, launches: dict) -> None:
    """(a): phase 4's rows written to a chunk store, fitted from it
    through ``config.data_source``, and held bit for bit to the
    in-memory fit of the rows in `store_permutation`'s order."""
    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.data.store import (ChunkStore, store_permutation,
                                        write_store)
    path = os.path.join(root, "store")
    t0 = time.perf_counter()
    write_store(path, X, chunk_rows=STORE_CHUNK_ROWS)
    write_s = time.perf_counter() - t0
    with ChunkStore(path) as st:
        n_chunks = st.n_chunks
    log(f"    (a) store: {N} x {D} f32 rows in {n_chunks} chunks of "
        f"{STORE_CHUNK_ROWS} ({X.nbytes / 2 ** 30:.2f} GiB) written in "
        f"{write_s:.2f} s")
    cfg = FitConfig(k=K, data_source=path, **MAIN_CONFIG)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    km, counts = _counted(launches, lambda: NestedKMeans(
        cfg, device=DEV).fit(X_val=Xv))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"        fit through config.data_source: {km.n_rounds_} records, "
        f"wall {wall:.2f} s (rounds {km.telemetry_[-1].t:.3f} s), peak "
        f"device memory {peak / 2 ** 30:.2f} GiB, launches {counts}")
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(counts[name] > 0, f"{name} was never launched in the store fit")
    # the same fit from an open ChunkStore, whose read metrics we keep
    st = ChunkStore(path)
    t0 = time.perf_counter()
    km2, _ = _counted(launches, lambda: NestedKMeans(
        FitConfig(k=K, **MAIN_CONFIG), device=DEV).fit(st, X_val=Xv))
    wall2 = time.perf_counter() - t0
    m = st.metrics
    st.close()
    log(f"        the same fit from an open ChunkStore: wall {wall2:.2f} s, "
        f"read {m.bytes_read} bytes = {m.bytes_read / X.nbytes:.3f} of one "
        f"pass ({m.chunk_loads} chunk loads, {m.cache_hits} cache hits), "
        f"bit-identical: {_same_fit(km2, km)}")
    need(_same_fit(km2, km), "two fits from one store differ")
    perm = store_permutation(N, STORE_CHUNK_ROWS, MAIN_CONFIG["seed"])
    Xp = np.ascontiguousarray(X[perm])
    torch.cuda.reset_peak_memory_stats()
    km_m, wall_m = fit_once(Xp, Xv, shuffle=False)
    peak_m = torch.cuda.max_memory_allocated()
    same = _same_fit(km, km_m, labels_perm=perm)
    log(f"        in-memory fit of X[store_permutation(...)], shuffle=False: "
        f"wall {wall_m:.2f} s (rounds {km_m.telemetry_[-1].t:.3f} s), peak "
        f"device memory {peak_m / 2 ** 30:.2f} GiB; the store fit's C, "
        f"labels and telemetry (but t) are bit-equal to it: {same}")
    need(same, "the store fit differs from the in-memory fit of the "
         "permuted rows")


def _timed_method(cls, name: str, times: list):
    """Wraps ``cls.name`` to append each call's synchronised wall time
    to ``times``; returns the original."""
    orig = getattr(cls, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    setattr(cls, name, timed)
    return orig


def _step_bytes(store, step: int) -> int:
    d = store._step_dirs()[step]
    return sum(f.stat().st_size for f in d.iterdir())


def resumed_fit(X, Xv, root: str, name: str, kw: dict, save_every: int,
                kernels, unbroken, launches: dict) -> None:
    """(b), (c): the fit with a checkpoint every ``save_every`` rounds,
    killed by ``on_round`` at KILL_ROUND, then ``fit(resume=True)``; the
    resumed fit must have ``unbroken``'s bits."""
    from repro_torch.api import CheckpointConfig, FitConfig, NestedKMeans
    from repro_torch.api.engines.local import _LocalRun
    from repro_torch.checkpoint import CheckpointStore
    ck = CheckpointConfig(checkpoint_dir=os.path.join(root, name),
                          save_every=save_every)
    cfg = FitConfig(k=K, checkpoint=ck, **dict(MAIN_CONFIG, **kw))

    def kill(rec):
        if rec.round == KILL_ROUND:
            raise Killed

    saves, restores = [], []
    orig_save = _timed_method(CheckpointStore, "save", saves)
    orig_restore = _timed_method(_LocalRun, "restore", restores)
    try:
        t0 = time.perf_counter()
        try:
            NestedKMeans(cfg, device=DEV, on_round=kill).fit(X, X_val=Xv)
        except Killed:
            pass
        else:
            raise Failure(f"{name}: the fit ended before round "
                          f"{KILL_ROUND}")
        wall_killed = time.perf_counter() - t0
        store = CheckpointStore(ck.checkpoint_dir)
        last = store.latest_step()
        want_last = KILL_ROUND // save_every * save_every
        need(last == want_last, f"{name}: the last save is round {last}, "
             f"not {want_last}")
        n_bytes = _step_bytes(store, last)
        t0 = time.perf_counter()
        km, counts = _counted(launches, lambda: NestedKMeans(
            cfg, device=DEV).fit(X, X_val=Xv, resume=True))
        wall = time.perf_counter() - t0
    finally:
        CheckpointStore.save = orig_save
        _LocalRun.restore = orig_restore
    same = _same_fit(km, unbroken)
    log(f"    ({'b' if name == 'tb-hamerly2' else 'c'}) {name}, "
        f"save_every={save_every}: killed at round {KILL_ROUND} after "
        f"{wall_killed:.2f} s, last save round {last}; "
        f"{len(saves)} saves in the two runs, "
        f"{1e3 * sum(saves) / len(saves):.1f} ms a save (largest "
        f"{1e3 * max(saves):.1f}), {n_bytes / 2 ** 20:.1f} MiB a checkpoint; "
        f"restore {1e3 * restores[0]:.1f} ms; resumed fit: "
        f"{km.n_rounds_ - last} more records, wall {wall:.2f} s, launches "
        f"{counts}; bit-equal to the unbroken fit: {same}")
    need(len(restores) == 1, f"{name}: the resume restored "
         f"{len(restores)} times")
    for kern in kernels:
        need(counts[kern] > 0, f"{kern} was never launched in the resumed "
             f"{name} fit")
    need(same, f"{name}: the resumed fit differs from the unbroken fit")


def resume_phase(X, Xv, unbroken: dict) -> dict:
    """Phase 8: out-of-core and kill-and-resume at phase 4's width.
    ``unbroken``: {path name: its unbroken fit} from phases 4 and 7.
    Returns the launches of phase 8's fits."""
    import shutil
    import tempfile
    launches = dict.fromkeys(REPLACES, 0)
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        du = shutil.disk_usage(root)
        log(f"[8] chunk store and checkpoints under {root}: "
            f"{du.free / 2 ** 30:.1f} GiB free of {du.total / 2 ** 30:.1f}")
        store_fit(X, Xv, root, launches)
        for name, kw, every, kernels in RESUMED_PATHS:
            resumed_fit(X, Xv, root, name, kw, every, kernels,
                        unbroken[name], launches)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"    launches in phase 8's fits: {launches}; phase 8 took "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(launches[name] > 0, f"{name} was never launched in phase 8")
    return launches


# ---------------------------------------------------------------- phase 9

#: phase 9: the stream the service folds in, and the latency design of
#: benchmarks/serve_latency.py (its folder is not ported; this repeats it)
SERVE_ROWS = 120_000
QUERY_ROWS, ROWS_PER_REQ, MICRO, COARSE = 2048, 256, 256, 16384
N_REQ = 1000                 # timed requests a mode
P99_CLAIM = 1.5              # the JAX package's background/off p99 claim
READ_S = 5.0                 # (b)'s reading window
N_READERS = 4
CHECK_EVERY = 50             # (b): every 50th request's labels are checked
HISTORY_ROWS = 65_536
DRIFT_ROWS = 32_768          # (c): the stream's rows it feeds, of which
DRIFT_CLEAN_ROWS = 16_384    # the first are fed as they are, then x3
REPEAT_BATCHES = 20
SERVE_WAIT_S = 120.0         # deadline of every wait and join of phase 9


def _adopted(outcome, **kw):
    """A fresh estimator on phase 4's config (``kw`` over it) that has
    adopted phase 4's fit."""
    from repro_torch.api import FitConfig, NestedKMeans
    return NestedKMeans(FitConfig(k=K, **dict(MAIN_CONFIG, **kw)),
                        device=DEV).adopt(outcome)


def _pcts(lat) -> dict:
    lat = np.asarray(lat, dtype=np.float64) * 1e3
    if not lat.size:
        return {"p50_ms": float("nan"), "p99_ms": float("nan"),
                "max_ms": float("nan"), "n": 0}
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "max_ms": float(lat.max()), "n": int(lat.size)}


def _pcts_text(p: dict) -> str:
    return (f"p50 {p['p50_ms']:.3f} ms, p99 {p['p99_ms']:.3f} ms, max "
            f"{p['max_ms']:.3f} ms over {p['n']} requests")


def _join(threads, what: str) -> None:
    for t in threads:
        t.join(SERVE_WAIT_S)
    need(not any(t.is_alive() for t in threads), f"{what} did not end "
         f"within {SERVE_WAIT_S} s")


def _wait(pred, what: str) -> None:
    t0 = time.perf_counter()
    while not pred():
        need(time.perf_counter() - t0 < SERVE_WAIT_S,
             f"{what}: not reached within {SERVE_WAIT_S} s")
        time.sleep(0.005)


def _lat_off(km, Q) -> list:
    lat = []
    for _ in range(N_REQ):
        t0 = time.perf_counter()
        km.predict(Q)
        lat.append(time.perf_counter() - t0)
    return lat


def _lat_inline(km, Q, stream):
    """The serving thread folds each COARSE rows of stream in itself."""
    lat, pos, buf, folds = [], 0, 0, 0
    for _ in range(N_REQ):
        t0 = time.perf_counter()
        buf += ROWS_PER_REQ
        if buf >= COARSE:
            km.partial_fit(stream[pos:pos + COARSE])
            pos = (pos + COARSE) % (len(stream) - COARSE + 1)
            buf = 0
            folds += 1
        km.predict(Q)
        lat.append(time.perf_counter() - t0)
    return lat, folds


def _lat_background(km, Q, stream):
    """A `ClusterService` folds the stream in on its refresher thread
    while this thread serves."""
    from repro_torch.serve import ClusterService, IngestQueue
    queue = IngestQueue(max_rows=4 * COARSE, policy="drop-oldest")
    svc = ClusterService(km, micro_batch=MICRO, flush_after_s=0.02,
                         queue=queue).start()
    lat, pos = [], 0
    for _ in range(N_REQ):
        svc.ingest(stream[pos:pos + ROWS_PER_REQ])
        pos = (pos + ROWS_PER_REQ) % (len(stream) - ROWS_PER_REQ + 1)
        t0 = time.perf_counter()
        svc.predict(Q)
        lat.append(time.perf_counter() - t0)
    metrics = svc.export_metrics()
    svc.stop()
    return lat, metrics, queue.peak_depth


def predict_parts(snap, Q) -> None:
    """Where a request's time goes: the upload of its rows (host clock,
    synchronised), the kernel alone on rows already on the card (CUDA
    events), and the whole `CodebookSnapshot.predict` (host clock)."""
    from repro_torch.kernels import ops
    reps = 100
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        Qd = torch.from_numpy(Q).to(DEV)
        torch.cuda.synchronize()
    up = (time.perf_counter() - t0) / reps * 1e3
    Cd = torch.from_numpy(np.array(snap.centroids)).to(DEV)
    kern = time_ms(lambda: ops.assign_top2(Qd, Cd), iters=reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        snap.predict(Q)
    whole = (time.perf_counter() - t0) / reps * 1e3
    log(f"    a {QUERY_ROWS}-row predict: {whole:.3f} ms in all (host "
        f"clock), of which the upload of its {Q.nbytes / 2 ** 20:.1f} MiB "
        f"of rows {up:.3f} ms (host clock, synchronised) and the "
        f"assign_top2 kernel {kern:.3f} ms (CUDA events); the rest is the "
        f"host: C's upload, the plan, the wrapper and the copy back")


def serve_latency(outcome, Q, stream):
    """(a): refresh off, inline and in the background; returns the
    estimator of the off mode."""
    kms = [_adopted(outcome) for _ in range(3)]
    for km in kms:                       # first calls outside the timing
        km.predict(Q)
        km.partial_fit(stream[:MICRO])
        km.partial_fit(stream[:COARSE])
    torch.cuda.synchronize()
    # the off floor is taken before and after the other modes, and the
    # worse p99 is the denominator (as benchmarks/serve_latency.py does)
    off_a = _lat_off(kms[0], Q)
    inline, folds = _lat_inline(kms[1], Q, stream)
    bg, metrics, peak = _lat_background(kms[2], Q, stream)
    off_b = _lat_off(kms[0], Q)
    p_a, p_b = _pcts(off_a), _pcts(off_b)
    off = p_a if p_a["p99_ms"] >= p_b["p99_ms"] else p_b
    p_in, p_bg = _pcts(inline), _pcts(bg)
    r_in, r_bg = (p_in["p99_ms"] / off["p99_ms"],
                  p_bg["p99_ms"] / off["p99_ms"])
    log(f"    (a) latency of a {QUERY_ROWS}-row predict, {ROWS_PER_REQ} "
        f"stream rows a request:")
    log(f"        off:        {_pcts_text(off)} (the worse of two runs; "
        f"the other p99 {min(p_a['p99_ms'], p_b['p99_ms']):.3f} ms)")
    log(f"        inline:     {_pcts_text(p_in)}; {r_in:.3f}x the off "
        f"p99, {folds} folds of {COARSE} rows")
    log(f"        background: {_pcts_text(p_bg)}; {r_bg:.3f}x the off p99 "
        f"(the JAX package claims <= {P99_CLAIM}x), "
        f"{metrics['refresh']['count']} refreshes of {MICRO} rows (refresh "
        f"p50 {metrics['refresh']['latency']['p50_s'] * 1e3:.3f} ms, p99 "
        f"{metrics['refresh']['latency']['p99_s'] * 1e3:.3f} ms), queue "
        f"peak depth {peak}")
    need(metrics["refresh"]["count"] >= 3,
         "(a): the background refresher did not run while serving")
    return kms[0]


def _reader(svc, Q, stop, out: dict) -> None:
    """Reads until ``stop``: every loaded snapshot must verify, versions
    may not fall, and the first request at or after each CHECK_EVERY-th
    one that one known snapshot served has its labels held to
    `ref.assign_top2_ref` on that snapshot's C on the card."""
    from repro_torch.kernels import ref
    Qd = torch.from_numpy(Q).to(DEV)
    last, due = 0, False
    try:
        while not stop.is_set():
            snap = svc.snapshot
            need(snap.verify(), f"a torn read at version {snap.version}")
            need(snap.version >= last, f"version {snap.version} after "
                 f"{last}")
            last = snap.version
            t0 = time.perf_counter()
            labels = svc.predict(Q)
            out["lat"].append((t0, time.perf_counter() - t0))
            due = due or len(out["lat"]) % CHECK_EVERY == 0
            if due and svc.snapshot is snap:
                C = torch.from_numpy(np.array(snap.centroids)).to(DEV)
                want = ref.assign_top2_ref(Qd, C)[0]
                out["ties"] += _labels_ok(
                    torch.from_numpy(labels).to(DEV), want,
                    ref.pairwise_dist2(Qd, C), TOL["f32"], relative=True)
                out["checked"] += 1
                due = False
    except BaseException as e:           # noqa: BLE001 — reported below
        out["error"] = e


def _readers(svc, Xq):
    import threading
    stop = threading.Event()
    outs = [{"lat": [], "checked": 0, "ties": 0, "error": None}
            for _ in range(N_READERS)]
    threads = [threading.Thread(
        target=_reader, daemon=True,
        args=(svc, Xq[i * QUERY_ROWS:(i + 1) * QUERY_ROWS], stop, outs[i]))
        for i in range(N_READERS)]
    for t in threads:
        t.start()
    return stop, threads, outs


def _stop_readers(stop, threads, outs) -> None:
    stop.set()
    _join(threads, "a reader")
    for i, o in enumerate(outs):
        if o["error"] is not None:
            raise Failure(f"reader {i}: {o['error']!r}")


def serve_concurrency(outcome, Xq, stream) -> None:
    """(b): 4 readers while one producer delivers every row twice."""
    import threading

    from repro_torch.serve import ClusterService, IngestQueue
    km = _adopted(outcome)
    n0 = float(np.sum(km.counts_, dtype=np.float64))
    queue = IngestQueue(max_rows=16384, policy="block", dedup=True)
    svc = ClusterService(km, micro_batch=MICRO, flush_after_s=0.02,
                         queue=queue).start()
    v0 = svc.snapshot.version
    errors = []

    def produce():
        try:
            for lo in range(0, len(stream), ROWS_PER_REQ):
                rows = stream[lo:lo + ROWS_PER_REQ]
                ids = range(lo, lo + len(rows))
                for _ in range(2):       # at-least-once delivery
                    svc.ingest(rows, ids=ids)
        except BaseException as e:       # noqa: BLE001 — reported below
            errors.append(e)

    t0 = time.perf_counter()
    stop, readers, outs = _readers(svc, Xq)
    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    time.sleep(READ_S)
    refreshes_read = svc.metrics.refreshes
    _stop_readers(stop, readers, outs)
    read_s = time.perf_counter() - t0
    # the rest of the stream is folded in with no reader beside it
    _join([producer], "the producer")
    produce_s = time.perf_counter() - t0
    svc.stop(drain=True)
    need(not errors, f"the producer failed: {errors!r}")
    m = svc.export_metrics()
    rise = float(np.sum(km.counts_, dtype=np.float64)) - n0
    lat = [s for o in outs for _, s in o["lat"]]
    log(f"    (b) {N_READERS} readers for {read_s:.2f} s while one producer "
        f"delivered {len(stream)} rows twice (done after {produce_s:.2f} "
        f"s): {len(lat)} requests, {_pcts_text(_pcts(lat))}; "
        f"{refreshes_read} refreshes while they read, "
        f"{m['refresh']['count']} in all (versions {v0} to "
        f"{svc.snapshot.version}), refresh p50 "
        f"{m['refresh']['latency']['p50_s'] * 1e3:.3f} ms; queue "
        f"{m['queue']}")
    log(f"        refresh_rows {m['refresh']['rows']}, unique rows "
        f"delivered {len(stream)}, rise in sum(counts) {rise!r}; labels "
        f"checked against the plain assignment in "
        f"{sum(o['checked'] for o in outs)} requests "
        f"({sum(o['ties'] for o in outs)} near-tied rows differ)")
    need(refreshes_read >= 10, "(b): fewer than 10 refreshes while the "
         "readers read")
    need(m["refresh"]["rows"] == len(stream) == m["queue"]["accepted"]
         and rise == len(stream),
         "(b): the rows folded in are not the unique rows delivered")
    need(all(o["checked"] > 0 for o in outs),
         "(b): a reader had no request checked against the plain version")


def serve_drift(outcome, Xq, stream) -> None:
    """(c): the first DRIFT_ROWS rows of the stream, scaled x3 after the
    first DRIFT_CLEAN_ROWS; the service must escalate to a checkpointed
    re-fit while readers keep reading."""
    import shutil
    import tempfile

    from repro_torch.api import CheckpointConfig
    from repro_torch.serve import ClusterService, IngestQueue
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        km = _adopted(outcome, checkpoint=CheckpointConfig(
            checkpoint_dir=root, save_every=25))
        svc = ClusterService(
            km, micro_batch=MICRO, flush_after_s=0.02,
            queue=IngestQueue(max_rows=16384, policy="block"),
            history_rows=HISTORY_ROWS, drift_window=8, drift_factor=2.0)
        spans = []
        escalate = svc.escalate

        def timed(**kw):
            t0 = time.perf_counter()
            v, rows = svc.snapshot.version, len(svc._history)
            escalate(**kw)
            spans.append((t0, time.perf_counter(), v, svc.snapshot, rows,
                          km.n_rounds_))

        svc.escalate = timed
        svc.start()
        stop, readers, outs = _readers(svc, Xq)
        t0 = time.perf_counter()
        for lo in range(0, DRIFT_ROWS, ROWS_PER_REQ):
            rows = stream[lo:lo + ROWS_PER_REQ]
            svc.ingest(rows if lo < DRIFT_CLEAN_ROWS else 3.0 * rows)
        _wait(lambda: svc.queue.depth == 0, "(c): the queue drained")
        _stop_readers(stop, readers, outs)
        svc.stop(drain=True)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    m = svc.export_metrics()
    log(f"    (c) drift: {DRIFT_ROWS} rows, x3 after the first "
        f"{DRIFT_CLEAN_ROWS}, in {wall:.2f} s: {m['refresh']['count']} "
        f"refreshes, {m['refresh']['escalations']} escalations")
    need(m["refresh"]["escalations"] >= 1, "(c): no escalation")
    for t_start, t_end, v, snap, rows, records in spans:
        during = [s for o in outs for t, s in o["lat"]
                  if t_start <= t <= t_end]
        log(f"        escalation: a checkpointed fit of {rows} history rows "
            f"({records} records), wall {t_end - t_start:.3f} s; snapshot "
            f"{v} -> {snap.version}; readers during it: "
            f"{_pcts_text(_pcts(during))}")
        need(snap.version > v and snap.verify(),
             "(c): no newer snapshot that verifies after an escalation")
    lat = [s for o in outs for _, s in o["lat"]]
    log(f"        readers over the whole run: {_pcts_text(_pcts(lat))}")


def serve_repeat(outcome, stream) -> None:
    """(d): the same REPEAT_BATCHES micro-batches from the adopted
    codebook on two fresh estimators and on the plain versions."""
    batches = [stream[i * MICRO:(i + 1) * MICRO]
               for i in range(REPEAT_BATCHES)]
    runs, walls = [], []
    for kw in ({}, {}, {"kernel_backend": "ref"}):
        km = _adopted(outcome, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            km.partial_fit(b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / len(batches) * 1e3)
        runs.append(km)
    a, b, r = runs
    same = (np.array_equal(a.cluster_centers_, b.cluster_centers_)
            and np.array_equal(a.counts_, b.counts_)
            and _tel_minus_t(a) == _tel_minus_t(b))
    C, Cr = a.cluster_centers_, r.cluster_centers_
    rel = float(np.linalg.norm(C - Cr) / np.linalg.norm(Cr))
    log(f"    (d) {REPEAT_BATCHES} partial_fit({MICRO}) from the adopted "
        f"codebook twice: C, counts and telemetry but t bit-equal: {same}; "
        f"C against the same batches on the plain versions: {rel:.3g} "
        f"relative (Frobenius), counts equal: "
        f"{np.array_equal(a.counts_, r.counts_)}; a partial_fit takes "
        f"{walls[0]:.3f} / {walls[1]:.3f} ms on the kernels, {walls[2]:.3f} "
        f"ms on the plain versions (host clock, synchronised, no other "
        f"thread)")
    need(same, "(d): two runs of the same batches differ")
    need(rel <= 1e-5, "(d): C is not within 1e-5 of the plain versions'")


def serve_phase(X, outcome) -> dict:
    """Phase 9: the streaming service on the card, on phase 4's rows and
    fit. Returns its launches (the breakdown of a predict that follows
    them launches the kernel outside the count)."""
    from repro_torch.data.synthetic import infmnist_like
    from repro_torch.kernels import ops
    from repro_torch.serve import CodebookSnapshot
    t0 = time.perf_counter()
    stream = infmnist_like(SERVE_ROWS, seed=2)
    log(f"[9] the streaming service on phase 4's fit (adopted); stream "
        f"infmnist_like({SERVE_ROWS}, seed=2) made in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    Q = X[:QUERY_ROWS]
    ops.reset_launch_counts()
    km = serve_latency(outcome, Q, stream)
    serve_concurrency(outcome, X, stream)
    serve_drift(outcome, X, stream)
    serve_repeat(outcome, stream)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"    launches in phase 9: {launches}")
    for name in ("assign_top2", "fused_nested_round"):
        need(launches[name] > 0, f"{name} was never launched in phase 9")
    predict_parts(CodebookSnapshot.create(1, km.export_codebook(),
                                          device=DEV), Q)
    log(f"    phase 9 took {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails without the repository)

    t0 = time.perf_counter()
    dev = device_phase()
    build_phase()
    errs = compare_phase()
    main = main_path_phase()
    times = timing_phase(main["X"])
    xl = xl_phase()
    X, Xv = main.pop("X"), main.pop("Xv")
    unbroken = other_paths_phase(X, Xv, main.pop("curve"))
    resume_phase(X, Xv, dict(unbroken, **{"tb-hamerly2": main.pop("fit")}))
    serve_phase(X, main.pop("outcome"))
    # each kernel's launches come from the run of the path it serves
    launches = dict(main["launches"], fused_round=xl["launches"][
        "fused_round"])
    errs["fused_round"] = xl["err"]
    times["fused_round"] = xl["times"]
    kernels = [dict(name=name, route="cuda", source=SOURCE.format(name),
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=errs[name], **times[name])
               for name in REPLACES]
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    log(dev["smi"])
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
