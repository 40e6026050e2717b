#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``sir_gcn_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  env      the card's name and power limit, torch and CUDA versions
  build    nvcc of the port's CUDA sources (all started together), with the
           ptxas register, shared-memory and spill report
  kernels  each ELL kernel against its plain PyTorch version on the card:
           awkward small plans (hub stage 2, H = 24 and 200, O != H,
           De = 5 and 16, budget-1 pad rows, zero scales, a row with no
           valid slot, isolated nodes, row counts that are not a multiple
           of a block's, duplicated edges that tie exactly), then the
           ogbn-arxiv plan in f32 and bf16, with CUDA-event times of kernel
           and plain version beside the kernel's bound
  train    the arxiv trainer's entry point at full width (169,343 nodes,
           H = 96, 3 layers, bn, residual, bf16 edges), once with sym and
           once with max aggregation, 5 steps and evals each, with the
           launch counters set to 0 before and read after each run
  sireconv one SIREConv layer at full width on the arxiv graph (96 in,
           De = 16 edge features, 96 hidden and out, sym, bf16 edges):
           5 AdamW steps and 5 evals on the fused-edge route (dropout 0)
           and on the generic edge route (dropout 0.2), with exact launch
           counts for each
  e2e      one training step on a ~20k-node graph on the card (kernels)
           against the same step on the CPU (plain versions): the arxiv
           model with sym and with max, and the SIREConv layer on its fused
           and its generic route
  profile  device time by kernel over warm training steps of each train
           and sireconv configuration (torch.profiler), and the device's
           idle share

The last line is the JSON contract line; the line before it lists each
kernel's launches on the main path, error, times and bound. Needs a CUDA
card and the port beside this script; exits non-zero without either.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
# a per-slot g_z stored in bf16: values that agree in f32 can round to
# neighbouring bf16 values, one step apart (at most 2^-7 of the value)
BF16_STEP = dict(atol=3e-4, rtol=2.0 ** -7)
# g_W sums a product over every slot (2.65M at arxiv) in f32, in another
# order in the kernel than in the plain version; the rounding that order
# leaves scales with the terms, not with the sum, so an entry whose terms
# cancel carries the same absolute error as the largest: atol grows by
# 1e-5 of the largest entry
GW_TOL = dict(atol=3e-4, rtol=1e-3, amax=1e-5)
# (key, o) whose two largest slot products lie within this relative gap
# may pick another winner on the card than in the plain version: the two
# sum H products in another order
NEAR_TIE = 1e-5
# H100 SXM data sheet: HBM rate and the f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
ARXIV_NODES, ARXIV_EDGES = 169_343, 1_166_243
TRAIN_FLAGS = [
    "--synthetic-nodes", str(ARXIV_NODES), "--synthetic-edges",
    str(ARXIV_EDGES), "--nhidden", "96", "--nlayers", "3", "--agg-type",
    "sym", "--norm", "bn", "--residual", "--dropout", "0.2",
    "--feat-dropout", "0.2", "--add-reverse-edge", "--add-self-loop",
    "--edge-bf16", "--epochs", "5", "--nruns", "1", "--log-every", "1",
    "--seed", "0",
]
SOURCE = "sir_gcn_tpu_torch/csrc/ell_kernels.cu"
MAX_SOURCE = "sir_gcn_tpu_torch/csrc/ell_max_kernels.cu"
EDGE_SOURCE = "sir_gcn_tpu_torch/csrc/ell_edge_kernels.cu"
PALLAS = "sir_gcn_tpu/ops/pallas/kernels.py"
# kernel -> (source, TPU function it replaces, flops per slot and feature;
# for the max kernels per valid slot and per H*O; for the fused-edge
# kernels per valid slot and feature on top of 2 De (forward) or 4 De
# (backward) for the edge projection and g_WE)
KERNELS = {
    "ell_act_reduce": (SOURCE, f"{PALLAS}:55", 5),     # add, sigma, scale-add
    "ell_act_reduce2": (SOURCE, f"{PALLAS}:94", 8),    # + sigma', scale-add
    "ell_src_bwd": (SOURCE, f"{PALLAS}:198", 6),       # add, sigma', 2 mul, add
    "ell_act_reduce_edge": (SOURCE, f"{PALLAS}:55", 6),    # + the e add
    "ell_act_reduce2_edge": (SOURCE, f"{PALLAS}:94", 9),
    "ell_src_bwd_edge": (SOURCE, f"{PALLAS}:198", 7),
    "ell_edge_act_reduce2": (EDGE_SOURCE, f"{PALLAS}:399", 9),  # + 2 De
    "ell_edge_src_bwd": (EDGE_SOURCE, f"{PALLAS}:470", 7),      # + 4 De
    "ell_max_fwd": (MAX_SOURCE, f"{PALLAS}:574", 2),   # m = a @ W
    "ell_max_wincount": (MAX_SOURCE, f"{PALLAS}:625", 2),
    "ell_max_bwd": (MAX_SOURCE, f"{PALLAS}:679", 6),   # m, g_W, g_a
    "ell_scaled_reduce": (MAX_SOURCE, f"{PALLAS}:781", 2),  # mul, add
}
LINEAR = ("ell_act_reduce", "ell_act_reduce2", "ell_src_bwd")
EDGE = ("ell_act_reduce_edge", "ell_act_reduce2_edge", "ell_src_bwd_edge",
        "ell_edge_act_reduce2", "ell_edge_src_bwd")
MAX = ("ell_max_fwd", "ell_max_wincount", "ell_max_bwd", "ell_scaled_reduce")
EDGE_DIM = 16  # the edge basis width of the SIREConv configuration


def flags_for(agg: str) -> list:
    flags = list(TRAIN_FLAGS)
    flags[flags.index("--agg-type") + 1] = agg
    return flags


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(label, got, want, tol) -> float:
    """Max abs error of ``got`` against ``want``; raises past ``tol``."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite output")
    diff = (got - want).abs()
    err = float(diff.max())
    rel = float((diff / want.abs().clamp_min(1e-12)).max())
    atol = tol["atol"] + tol.get("amax", 0.0) * float(want.abs().max())
    ok = bool((diff <= atol + tol["rtol"] * want.abs()).all())
    log(f"  {label}: max abs err {err:.3e}, max rel err {rel:.3e} "
        f"(atol {atol:.3g}, rtol {tol['rtol']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` warm calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_env():
    import torch

    log("== env")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    # f32 products in full f32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from sir_gcn_tpu_torch.ops.cuda import build

    log("== build")
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"  built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name in build.SOURCES:
        regs, spills, n, fn = [], [], 0, None
        for line in build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn, n = m.group(1), n + 1
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.append(int(m.group(1)))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and int(m.group(1)) and fn:
                spills.append(f"{fn[:50]} {m.group(1)} B")
        log(f"  ptxas {name}: {n} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, "
            f"{len(spills)} with spill stores")
        for line in spills:
            log(f"    spill: {line}")


def small_case(graph: str, h: int, device):
    """Awkward plans: a hub above the chunk budget (stage 2), H = 24 or
    200, budget-1 pad rows, isolated nodes (nodes 30..59 of "isolated"
    have no edge), and a fifth of the scales zeroed."""
    import numpy as np
    import torch

    from sir_gcn_tpu_torch import build_fast_graph, build_graph

    rng = np.random.default_rng(h)
    if graph == "hub":
        n = 40
        src = rng.integers(0, n, 360)
        dst = np.concatenate([np.zeros(300, np.int64),
                              rng.integers(0, n, 60)])
        fg = build_fast_graph(build_graph(src, dst, n, device=device),
                              max_budget=64)
    elif graph == "isolated":
        fg = build_fast_graph(build_graph(rng.integers(0, 30, 150),
                                          rng.integers(0, 30, 150), 60,
                                          device=device), max_budget=16)
    else:
        n, e = 40, 203
        fg = build_fast_graph(build_graph(rng.integers(0, n, e),
                                          rng.integers(0, n, e), n,
                                          device=device), max_budget=16)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    eq, ek, g = (t(rng.normal(size=(fg.n_pad, h))) for _ in range(3))
    sd = fg.dst_slot_scales["sym"] * t(rng.random(fg.dst_plan.num_slots)
                                       > 0.2)
    ss = fg.src_slot_scales["sym"] * t(rng.random(fg.src_plan.num_slots)
                                       > 0.2)
    return fg, eq, ek, g, sd, ss


def kernel_args(fg, eq, ek, g, sd, ss, act, dtype):
    fwd = (eq, ek.to(dtype).contiguous(), fg.dst_slot_srcnode, sd,
           fg.dst_plan.row_key, fg.dst_plan.row_ptr, act)
    bwd = (eq.to(dtype).contiguous(), g.to(dtype).contiguous(), ek,
           fg.src_slot_dstnode, ss, fg.src_plan.row_key,
           fg.src_plan.row_ptr, act)
    return fwd, bwd


def check_kernels(label, fg, eq, ek, g, sd, ss, act, dtype, errs,
                  timing=None):
    import torch

    from sir_gcn_tpu_torch.ops import cuda as K

    fwd, bwd = kernel_args(fg, eq, ek, g, sd, ss, act, dtype)
    bd, bs = fg.dst_plan.buckets1, fg.src_plan.buckets1
    runs = {
        "ell_act_reduce": (
            fwd, lambda: K.ell_act_reduce(*fwd),
            lambda: K.ell_act_reduce_plain(*fwd, buckets=bd), FWD_TOL),
        "ell_act_reduce2": (
            fwd, lambda: K.ell_act_reduce2(*fwd),
            lambda: K.ell_act_reduce_plain(*fwd, buckets=bd,
                                           derivative=True), FWD_TOL),
        "ell_src_bwd": (
            bwd, lambda: K.ell_src_bwd(*bwd),
            lambda: K.ell_src_bwd_plain(*bwd, buckets=bs), BWD_TOL),
    }
    for name, (args, kernel, plain, tol) in runs.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for i, (a, b) in enumerate(zip(got, want)):
            err = compare(f"{label} {name}[{i}]", a, b, tol)
            errs[name] = max(errs.get(name, 0.0), err)
        if timing is not None:
            timing[name] = dict(ms=cuda_ms(kernel, 50),
                                plain_ms=cuda_ms(plain, 5, warmup=1),
                                bound=linear_bound(name, args, got))


def bound(args, outs, flops):
    """(least ms, what bounds it, bytes, flops): every input tensor read
    once and every output written once at the HBM rate, against ``flops``
    at the f32 rate. An int in ``args`` is the bytes the function needs of
    an input it reads only in part."""
    nbytes = sum(a if isinstance(a, int) else a.numel() * a.element_size()
                 for a in args if isinstance(a, int) or hasattr(a, "numel"))
    nbytes += sum(o.numel() * o.element_size() for o in outs)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def linear_bound(name, args, outs):
    node_tbl = args[0] if name == "ell_src_bwd" else args[1]
    slots = args[3].numel() if name == "ell_src_bwd" else args[2].numel()
    return bound(args, outs, slots * node_tbl.shape[1] * KERNELS[name][2])


def edge_tables(fg, h: int, de: int, seed: int):
    """An edge table e [E_pad, H], an edge basis [E_pad, De] and W_E
    [De, H] on the graph's device, from ``seed``."""
    import torch

    gen = torch.Generator(device=fg.graph.device).manual_seed(seed)
    dev = fg.graph.device
    e = torch.randn((fg.e_pad, h), generator=gen, device=dev)
    eb = torch.randn((fg.e_pad, de), generator=gen, device=dev)
    we = 0.3 * torch.randn((de, h), generator=gen, device=dev)
    return e, eb, we


def check_edge_kernels(label, fg, eq, ek, g, sd, ss, e, eb, we, act, dtype,
                       errs, timing=None):
    """The edge-term forms of #1, #2 and #4 (with its per-edge cotangent)
    and the fused-edge kernels #7 and #8 against their plain versions;
    g_WE at GW_TOL, a g_e stored in bf16 at one bf16 step."""
    import torch

    from sir_gcn_tpu_torch.ops import cuda as K

    fwd, bwd = kernel_args(fg, eq, ek, g, sd, ss, act, dtype)
    plan, splan = fg.dst_plan, fg.src_plan
    bd, bs = plan.buckets1, splan.buckets1
    et = e.to(dtype).contiguous()
    fe = (et, plan.slot_edge)
    be = (et, splan.slot_edge, fg.edge2src_slot, fg.edge_mask)
    ffwd = (eq, fwd[1], eb, we, fg.dst_slot_srcnode, plan.slot_edge) + fwd[3:]
    fbwd = bwd[:3] + (eb, we, fg.src_slot_dstnode, splan.slot_edge) + bwd[4:]
    ge_tol = BF16_STEP if dtype == torch.bfloat16 else BWD_TOL
    plain_fwd = dict(buckets=bd, e=et, slot_edge=plan.slot_edge)
    runs = {
        "ell_act_reduce_edge": (
            lambda: K.ell_act_reduce_edge(*fwd, *fe),
            lambda: K.ell_act_reduce_plain(*fwd, **plain_fwd), (FWD_TOL,)),
        "ell_act_reduce2_edge": (
            lambda: K.ell_act_reduce2_edge(*fwd, *fe),
            lambda: K.ell_act_reduce_plain(*fwd, derivative=True,
                                           **plain_fwd), (FWD_TOL,) * 2),
        "ell_src_bwd_edge": (
            lambda: K.ell_src_bwd_edge(*bwd, *be),
            lambda: K.ell_src_bwd_plain(
                *bwd, buckets=bs, e=et, slot_edge=splan.slot_edge,
                edge2slot=fg.edge2src_slot, edge_mask=fg.edge_mask),
            (BWD_TOL, ge_tol)),
        "ell_edge_act_reduce2": (
            lambda: K.ell_edge_act_reduce2(*ffwd),
            lambda: K.ell_edge_act_reduce2_plain(*ffwd, buckets=bd),
            (FWD_TOL,) * 2),
        "ell_edge_src_bwd": (
            lambda: K.ell_edge_src_bwd(*fbwd),
            lambda: K.ell_edge_src_bwd_plain(*fbwd, buckets=bs),
            (BWD_TOL, GW_TOL)),
    }
    outs = {}
    for name, (kernel, plain, tols) in runs.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for i, (a, b, tol) in enumerate(zip(got, want, tols)):
            err = compare(f"{label} {name}[{i}]", a, b, tol)
            errs[name] = max(errs.get(name, 0.0), err)
        outs[name] = got
    if timing is None:
        return
    h, de = eq.shape[1], eb.shape[1]
    valid_d, valid_s = int((sd != 0).sum()), int((ss != 0).sum())
    # what each kernel reads: the wrappers' inputs less edge2slot and
    # edge_mask, which only the plain version of #4's g_e reads
    needs = {
        "ell_act_reduce_edge": (fwd + fe, valid_d * h * KERNELS[
            "ell_act_reduce_edge"][2]),
        "ell_act_reduce2_edge": (fwd + fe, valid_d * h * KERNELS[
            "ell_act_reduce2_edge"][2]),
        "ell_src_bwd_edge": (bwd + be[:2], valid_s * h * KERNELS[
            "ell_src_bwd_edge"][2]),
        "ell_edge_act_reduce2": (ffwd, valid_d * h * (2 * de + KERNELS[
            "ell_edge_act_reduce2"][2])),
        "ell_edge_src_bwd": (fbwd, valid_s * h * (4 * de + KERNELS[
            "ell_edge_src_bwd"][2])),
    }
    for name, (kernel, plain, _) in runs.items():
        args, flops = needs[name]
        timing[name] = dict(ms=cuda_ms(kernel, 20),
                            plain_ms=cuda_ms(plain, 3, warmup=1),
                            bound=bound(args, outs[name], flops))


def max_case(graph: str, h: int, o: int, device):
    """Plans for the max kernels: the small cases' hub and random graphs
    with a whole row of invalid slots besides, or duplicated edges that
    tie exactly (two chunk rows of one key at budget 4); W [H, O] and a
    cotangent [N, O]."""
    import numpy as np
    import torch

    from sir_gcn_tpu_torch import build_fast_graph, build_graph

    if graph != "ties":
        fg, eq, ek, *_ = small_case(graph, h, device)
        rng = np.random.default_rng(h + o)
        valid = rng.random(fg.dst_plan.num_slots) > 0.2
        ptr = fg.dst_plan.host["row_ptr"]
        r = int(np.argmax(np.diff(ptr) > 1))
        valid[ptr[r]:ptr[r + 1]] = False
    else:
        rng = np.random.default_rng(h + o)
        fg = build_fast_graph(build_graph(
            np.array([0, 0, 1, 2, 2, 2, 3] * 2),
            np.array([5, 5, 6, 7, 7, 7, 8] * 2), 16, device=device),
            max_budget=4)
        valid = np.ones(fg.dst_plan.num_slots, bool)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    eq, ek = (t(rng.normal(size=(fg.n_pad, h))) for _ in range(2))
    w = t(rng.uniform(-1, 1, size=(h, o)) / np.sqrt(h))
    g = t(rng.normal(size=(fg.n_pad, o)))
    return fg, eq, ek, w, g, fg.dst_slot_scales["sum"] * t(valid)


def near_ties(fg, args, act):
    """[N, O] bool: (key, o) whose two largest valid slot products (the
    plain version's) lie within NEAR_TIE of each other, exact ties
    included; such a key may take another winner in the kernel."""
    import torch

    from sir_gcn_tpu_torch.ops.cuda import kernels as K

    plan = fg.dst_plan
    neg = K.NEG
    t1, t2 = [], []
    eq, ek, slot_src, scale, row_key, _, w = args
    for _, _, _, _, m, valid in K.bucket_products(
            eq, ek, slot_src, scale, row_key, w, act, plan.buckets1):
        mv = torch.where(valid, m, neg)
        if mv.shape[1] >= 2:
            top = mv.topk(2, dim=1).values
            t1.append(top[:, 0])
            t2.append(top[:, 1])
        else:
            t1.append(mv[:, 0])
            t2.append(torch.full_like(mv[:, 0], neg))
    t1, t2 = torch.cat(t1), torch.cat(t2)
    k1 = plan.finalize_rows_max(t1)
    k1_rows = k1.index_select(0, plan.row_key)
    # the key's second largest: a row's second, a row top below the key's
    # top, or the top itself where two chunk rows share it
    k2 = torch.maximum(plan.finalize_rows_max(t2), plan.finalize_rows_max(
        torch.where(t1 < k1_rows, t1, neg)))
    shared = plan.finalize_rows_sum((t1 == k1_rows).float()) >= 2
    k2 = torch.where(shared, k1, k2)
    return (k2 > neg / 2) & (k1 - k2 <= NEAR_TIE * (1 + k1.abs())), k1


def check_max_kernels(label, fg, eq, ek, w, g, scale, act, dtype, errs,
                      timing=None, mask_near_ties=False):
    """The four max kernels against their plain versions, each side's
    win counts and backward against its own forward's maxima. With
    ``mask_near_ties`` the cotangent is zeroed at near-tie (key, o), where
    the two may pick different winners, and win counts are compared
    elsewhere; without it every count must agree."""
    import torch

    from sir_gcn_tpu_torch.ops import cuda as K

    plan, splan = fg.dst_plan, fg.src_plan
    bd, bs = plan.buckets1, splan.buckets1
    args = (eq, ek.to(dtype).contiguous(), fg.dst_slot_srcnode, scale,
            plan.row_key, plan.row_ptr, w)
    rows = K.ell_max_fwd(*args, act)
    rows_p = K.ell_max_fwd_plain(*args, act, buckets=bd)
    torch.cuda.synchronize()
    err = {"ell_max_fwd": compare(f"{label} ell_max_fwd", rows, rows_p,
                                  FWD_TOL)}
    key_max, key_max_p = (plan.finalize_rows_max(r) for r in (rows, rows_p))
    near = torch.zeros_like(key_max, dtype=torch.bool)
    if mask_near_ties:
        near, _ = near_ties(fg, args, act)
    row_near = near.index_select(0, plan.row_key)

    counts = K.ell_max_wincount(*args, key_max, act)
    counts_p = K.ell_max_wincount_plain(*args, key_max_p, act, buckets=bd)
    torch.cuda.synchronize()
    differ = counts != counts_p
    bad = int((differ & ~row_near).sum())
    err["ell_max_wincount"] = float(
        torch.where(row_near, 0.0, (counts - counts_p).abs()).max())
    log(f"  {label} ell_max_wincount: counts differ at {int(differ.sum())} "
        f"of {counts.numel()} (row, o), {bad} outside the "
        f"{int(near.sum())} near-tie (key, o); max count "
        f"{float(counts.max()):.0f} {'ok' if bad == 0 else 'FAIL'}")
    if bad:
        raise AssertionError(f"{label}: win counts disagree")

    gsc = torch.where(near, 0.0, g).contiguous()
    outs = K.ell_max_bwd(*args, key_max, gsc, act)
    outs_p = K.ell_max_bwd_plain(*args, key_max_p, gsc, act, buckets=bd)
    torch.cuda.synchronize()
    tols = (BWD_TOL, BF16_STEP if dtype == torch.bfloat16 else BWD_TOL,
            GW_TOL)
    err["ell_max_bwd"] = max(
        compare(f"{label} ell_max_bwd[{i}]", a, b, tol)
        for i, (a, b, tol) in enumerate(zip(outs, outs_p, tols)))

    gz = outs[1]
    red_args = (gz, fg.src_slot_from_dst_slot, splan.slot_valid,
                splan.row_ptr)
    red = K.ell_scaled_reduce(*red_args)
    red_p = K.ell_scaled_reduce_plain(*red_args, buckets=bs)
    torch.cuda.synchronize()
    err["ell_scaled_reduce"] = compare(f"{label} ell_scaled_reduce", red,
                                       red_p, BWD_TOL)
    for name, e in err.items():
        errs[name] = max(errs.get(name, 0.0), e)
    if timing is None:
        return

    h, o = w.shape
    valid = int((scale > 0).sum())
    src_valid = int((splan.slot_valid > 0).sum())
    # the reduce skips zero-scale slots: it needs only the g_z rows that
    # valid src slots point at, besides every slot's index and scale
    red_need = (src_valid * h * gz.element_size(),) + red_args[1:]
    runs = {
        "ell_max_fwd": (args, lambda: K.ell_max_fwd(*args, act),
                        lambda: K.ell_max_fwd_plain(*args, act, buckets=bd),
                        (rows,), valid * h * o * 2),
        "ell_max_wincount": (
            args + (key_max,),
            lambda: K.ell_max_wincount(*args, key_max, act),
            lambda: K.ell_max_wincount_plain(*args, key_max, act,
                                             buckets=bd),
            (counts,), valid * h * o * 2),
        "ell_max_bwd": (
            args + (key_max, gsc),
            lambda: K.ell_max_bwd(*args, key_max, gsc, act),
            lambda: K.ell_max_bwd_plain(*args, key_max, gsc, act,
                                        buckets=bd),
            outs, valid * h * o * 6),
        "ell_scaled_reduce": (
            red_need, lambda: K.ell_scaled_reduce(*red_args),
            lambda: K.ell_scaled_reduce_plain(*red_args, buckets=bs),
            (red,), src_valid * h * 2),
    }
    for name, (targs, kernel, plain, touts, flops) in runs.items():
        timing[name] = dict(ms=cuda_ms(kernel, 10),
                            plain_ms=cuda_ms(plain, 3, warmup=1),
                            bound=bound(targs, touts, flops))
    # one PyTorch call computing ell_scaled_reduce: a CSR product
    n_src = splan.row_ptr.numel() - 1
    a = torch.sparse_csr_tensor(
        splan.row_ptr.long(), fg.src_slot_from_dst_slot.long(),
        splan.slot_valid.to(gz.dtype), size=(n_src, gz.shape[0]))
    try:
        lib_in = (a, gz)
        torch.sparse.mm(*lib_in)
    except RuntimeError:  # no CSR product in this type on this build
        lib_in = (a.to(torch.float32), gz.float())
    timing["ell_scaled_reduce"]["library_ms"] = cuda_ms(
        lambda: torch.sparse.mm(*lib_in), 10)
    log(f"  library: torch.sparse.mm (CSR [{n_src}, {gz.shape[0]}] x "
        f"{lib_in[1].dtype} [{gz.shape[0]}, {h}]) "
        f"{timing['ell_scaled_reduce']['library_ms']:.4f} ms")


def phase_kernels(device):
    import torch

    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.train import (
        build_arxiv_graph,
        get_args,
    )
    from sir_gcn_tpu_torch.ops.ell import leaky_relu, tanh

    log("== kernels")
    errs = {}
    acts = (leaky_relu(0.2), tanh)
    dtypes = (torch.float32, torch.bfloat16)
    for graph, h in (("hub", 24), ("random", 96), ("random", 200)):
        case = small_case(graph, h, device)
        for act in acts:
            for dtype in dtypes:
                check_kernels(f"{graph} H={h} {act.name} {dtype}", *case,
                              act, dtype, errs)
    for graph, h, de in (("hub", 24, 5), ("random", 96, 16),
                         ("isolated", 200, 16), ("isolated", 24, 16),
                         ("random", 200, 5)):
        case = small_case(graph, h, device)
        tables = edge_tables(case[0], h, de, seed=h + de)
        log(f"  {graph} H={h} De={de}: rows {case[0].dst_plan.num_rows} "
            f"(dst) {case[0].src_plan.num_rows} (src)")
        for act in acts:
            for dtype in dtypes:
                check_edge_kernels(f"{graph} H={h} De={de} {act.name} "
                                   f"{dtype}", *case, *tables, act, dtype,
                                   errs)
    for graph, h, o in (("hub", 24, 40), ("random", 96, 96),
                        ("random", 200, 200), ("ties", 32, 24)):
        case = max_case(graph, h, o, device)
        for act in acts:
            for dtype in dtypes:
                check_max_kernels(f"{graph} H={h} O={o} {act.name} {dtype}",
                                  *case, act, dtype, errs)

    args = get_args(TRAIN_FLAGS)
    data = synthetic_node_classification(
        ARXIV_NODES, ARXIV_EDGES, feat_dim=128, num_classes=40, seed=0)
    fg = build_arxiv_graph(data, args, device)
    gen = torch.Generator(device=device).manual_seed(0)
    eq, ek, g = (torch.randn((fg.n_pad, 96), generator=gen, device=device)
                 for _ in range(3))
    sd, ss = fg.dst_slot_scales["sym"], fg.src_slot_scales["sym"]
    w = (torch.rand((96, 96), generator=gen, device=device) * 2 - 1) / 96**0.5
    tables = edge_tables(fg, 96, EDGE_DIM, seed=0)
    log(f"  arxiv plan: N {fg.n_pad}, E_pad {fg.e_pad}, S_dst "
        f"{fg.dst_plan.num_slots}, S_src {fg.src_plan.num_slots}, R1 "
        f"{fg.dst_plan.num_rows}, H 96, O 96, De {EDGE_DIM}, stage 2 "
        f"{fg.dst_plan.s2_gather is not None}")
    timing = {}  # of the main path's bf16 edges
    for dtype in dtypes:
        keep = timing if dtype == torch.bfloat16 else None
        check_kernels(f"arxiv {dtype}", fg, eq, ek, g, sd, ss,
                      leaky_relu(0.2), dtype, errs, timing=keep)
        check_edge_kernels(f"arxiv {dtype}", fg, eq, ek, g, sd, ss, *tables,
                           leaky_relu(0.2), dtype, errs, timing=keep)
        check_max_kernels(f"arxiv {dtype}", fg, eq, ek, w, g,
                          fg.dst_slot_scales["sum"], leaky_relu(0.2), dtype,
                          errs, timing=keep, mask_near_ties=True)
    for name, t in timing.items():
        b_ms, by, nbytes, flops = t["bound"]
        log(f"  {name} (bf16 edges): {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.3f} ms, bound {b_ms:.4f} ms by {by} "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
            f"{100 * b_ms / t['ms']:.1f}% of bound")
    del eq, ek, g, w, tables
    return errs, timing, fg


def expected_launches(agg: str, steps: int) -> dict:
    """Launches of each kernel over ``steps`` training steps and evals of
    3 layers: the train step runs the forward and backward kernels once
    per layer, the eval the no-gradient forward once per layer."""
    want = dict.fromkeys(KERNELS, 0)
    if agg == "max":
        want.update(ell_max_fwd=6 * steps, ell_max_wincount=3 * steps,
                    ell_max_bwd=3 * steps, ell_scaled_reduce=3 * steps)
    else:
        want.update(ell_act_reduce2=3 * steps, ell_src_bwd=3 * steps,
                    ell_act_reduce=3 * steps)
    return want


def phase_train(agg: str):
    import numpy as np
    import torch

    from sir_gcn_tpu_torch.experiments.ogbn_arxiv import train
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts

    flags = flags_for(agg)
    log("== train: " + " ".join(flags))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    (result,) = train.main(flags)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = len(result["train_losses"])
    log(f"  plan build {result['plan_seconds']:.2f}s, edges "
        f"{result['num_edges']}, S_dst {result['dst_slots']}, S_src "
        f"{result['src_slots']}")
    log(f"  dst buckets {result['dst_buckets']}")
    log(f"  src buckets {result['src_buckets']}")
    ms = lambda key: [round(s * 1e3, 3) for s in result[key]]
    log(f"  train step ms {ms('step_seconds')}, eval ms "
        f"{ms('eval_seconds')}")
    log(f"  steady step (median of steps 2..{steps}) "
        f"{1e3 * float(np.median(result['step_seconds'][1:])):.3f} ms, "
        f"peak memory {peak / 2**30:.3f} GiB")
    log(f"  losses {result['train_losses']}, launches {launches}")
    if not all(math.isfinite(x) for x in result["train_losses"]):
        raise AssertionError("non-finite training loss")
    want = expected_launches(agg, steps)
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    return launches


def sireconv_inputs(fg, seed: int):
    """Node features [N, 96] and edge features [E, De] N(0, 1), in original
    edge order, and the loss weights [N, 96], on the graph's device."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((fg.n_pad, 96), generator=gen)
    ef = torch.randn((fg.graph.num_edges, EDGE_DIM), generator=gen)
    w = torch.randn((fg.n_pad, 96), generator=gen)
    dev = fg.graph.device
    return x.to(dev), ef.to(dev), w.to(dev)


def make_sireconv(dropout: float, edge_encoder=None):
    """The SIREConv of the sireconv phase: 96 in, De = 16, 96 hidden and
    out, leaky_relu(0.2), sym; weights from seed 0."""
    import torch

    from sir_gcn_tpu_torch.models import SIREConv
    from sir_gcn_tpu_torch.ops.ell import leaky_relu

    return SIREConv(96, EDGE_DIM, 96, 96, leaky_relu(0.2), dropout=dropout,
                    agg_type="sym", edge_encoder=edge_encoder,
                    generator=torch.Generator().manual_seed(0))


def sireconv_step(conv, fg, x, ef, w, opt, gen):
    """One training step: forward, loss = sum(out * w), backward, AdamW."""
    conv.train()
    opt.zero_grad(set_to_none=True)
    out = conv(fg, x, ef, generator=gen)
    loss = (out * w).sum()
    loss.backward()
    opt.step()
    return loss.detach()


def phase_sireconv(device, fg, steps: int = 5):
    """SIREConv at full width on the arxiv plan, bf16 edges: (a) dropout 0,
    the fused-edge route; (b) dropout 0.2 in training, the generic edge
    route. Each runs ``steps`` steps, each followed by a no-grad eval
    (eval mode: the fused route), with exact launch counts."""
    import numpy as np
    import torch

    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import make_adamw

    log(f"== sireconv: one SIREConv (96 -> 96, De {EDGE_DIM}, sym, bf16 "
        f"edges) on the arxiv plan, {steps} steps and evals per setting")
    set_edge_dtype(torch.bfloat16)
    x, ef, w = sireconv_inputs(fg, seed=0)
    total = dict.fromkeys(KERNELS, 0)
    expected = {
        "a": dict(ell_edge_act_reduce2=2 * steps, ell_edge_src_bwd=steps),
        "b": dict(ell_act_reduce2_edge=steps, ell_src_bwd_edge=steps,
                  ell_edge_act_reduce2=steps),
    }
    for setting, dropout in (("a", 0.0), ("b", 0.2)):
        conv = make_sireconv(dropout).to(device)
        opt = make_adamw(conv.parameters(), 1e-3, 0.0)
        gen = torch.Generator(device=device).manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        step_s, eval_s, losses = [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            loss = sireconv_step(conv, fg, x, ef, w, opt, gen)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
            conv.eval()
            t0 = time.perf_counter()
            with torch.no_grad():
                out = conv(fg, x, ef)
            torch.cuda.synchronize()
            eval_s.append(time.perf_counter() - t0)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"({setting}) non-finite eval output")
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        steady = 1e3 * float(np.median(step_s[1:]))
        log(f"  ({setting}) dropout {dropout}: step ms "
            f"{[round(t * 1e3, 3) for t in step_s]}, eval ms "
            f"{[round(t * 1e3, 3) for t in eval_s]}")
        log(f"  ({setting}) steady step (median of steps 2..{steps}) "
            f"{steady:.3f} ms, eval median "
            f"{1e3 * float(np.median(eval_s[1:])):.3f} ms, peak memory "
            f"{peak / 2**30:.3f} GiB, losses {losses}")
        log(f"  ({setting}) launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"({setting}) non-finite loss")
        want = dict.fromkeys(KERNELS, 0)
        want.update(expected[setting])
        if launches != want:
            raise AssertionError(f"({setting}) launch counts {launches}, "
                                 f"expected {want}")
        for k, v in launches.items():
            total[k] += v
    set_edge_dtype(None)
    return total


def step_inputs(data, n_pad, device):
    """Padded features, labels and the train-node loss weights."""
    import torch

    n = data.feat.shape[0]
    feats = torch.zeros((n_pad, data.feat.shape[1]), device=device)
    feats[:n] = torch.from_numpy(data.feat).to(device)
    labels = torch.zeros(n_pad, dtype=torch.long, device=device)
    labels[:n] = torch.from_numpy(data.labels).to(device)
    w = torch.zeros(n_pad, device=device)
    w[torch.from_numpy(data.train_idx).to(device)] = 1.0
    return feats, labels, w


def phase_profile(device, agg: str, steps: int = 3):
    """Device time by kernel over a few warm training steps of the train
    phase's configuration with ``agg``, and the device's busy share of the
    wall time. Informational: it fails only if the step itself fails."""
    import torch

    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv import train
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.model import SIRModel
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import make_adamw

    log(f"== profile {agg}: {steps} warm training steps of the train "
        f"configuration")
    args = train.get_args(flags_for(agg))
    set_edge_dtype(torch.bfloat16)
    data = synthetic_node_classification(
        ARXIV_NODES, ARXIV_EDGES, feat_dim=128, num_classes=40, seed=0)
    fg = train.build_arxiv_graph(data, args, device)
    model = SIRModel(128, 96, 40, num_layers=3, norm="bn", residual=True,
                     dropout=0.2, feat_dropout=0.2, agg_type=agg,
                     generator=torch.Generator().manual_seed(0)).to(device)
    step, _ = train.make_harness(model, fg, make_adamw(model.parameters(),
                                                       args.lr, args.wd))
    inputs = step_inputs(data, fg.n_pad, device)
    gen = torch.Generator(device=device).manual_seed(0)
    profile_steps(lambda: step(*inputs, gen), steps)
    set_edge_dtype(None)


def phase_profile_sireconv(device, fg, steps: int = 3):
    """The same breakdown for the sireconv phase's steps, on each route."""
    import torch

    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import make_adamw

    set_edge_dtype(torch.bfloat16)
    x, ef, w = sireconv_inputs(fg, seed=0)
    for setting, dropout in (("a", 0.0), ("b", 0.2)):
        log(f"== profile sireconv ({setting}), dropout {dropout}: {steps} "
            f"warm training steps")
        conv = make_sireconv(dropout).to(device)
        opt = make_adamw(conv.parameters(), 1e-3, 0.0)
        gen = torch.Generator(device=device).manual_seed(0)
        profile_steps(lambda: sireconv_step(conv, fg, x, ef, w, opt, gen),
                      steps)
    set_edge_dtype(None)


def profile_steps(step, steps: int):
    """Run ``step`` twice to warm up, then ``steps`` times under
    torch.profiler; log the wall and device-busy time per step, the idle
    share and the 15 largest device items."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side kernel and copy events only: an operator's CPU event
    # also carries the time of the kernels it launched, and a user range
    # (the optimizer's) the time of the kernels inside it
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    if not events:
        log("  the profiler recorded no device time")
        return
    log(f"  per step: wall {wall_ms:.3f} ms (profiled), device busy "
        f"{busy_ms:.3f} ms, idle share {100 * (1 - busy_ms / wall_ms):.1f}%")
    for e in sorted(events, key=dev_us, reverse=True)[:15]:
        log(f"  {dev_us(e) / 1e3 / steps:8.3f} ms/step "
            f"{100 * dev_us(e) / 1e3 / steps / busy_ms:5.1f}%  "
            f"x{e.count // steps:<4d} {e.key[:90]}")


def winner_flips(runs, act) -> int:
    """(key, o) per max layer whose winning slots differ between the card
    (kernels) and the CPU (plain versions), from the layers' inputs that
    each run saw. Only near-tie (key, o) of the CPU side can differ; for
    each, the kernel's product of every candidate slot is computed by
    ``ell_max_fwd`` on a plan of one-slot rows, which rounds each product
    as the layer did. Needs one row per key (no hub stage 2)."""
    import torch

    from sir_gcn_tpu_torch.ops.cuda import kernels as K

    cpu, card = runs["cpu"], runs["card"]
    flips = 0
    for i, (x_c, x_g) in enumerate(zip(cpu["inputs"], card["inputs"])):
        side = {}
        for name, run, x in (("cpu", cpu, x_c), ("card", card, x_g)):
            conv, fg = run["model"].convs[i], run["fg"]
            with torch.no_grad():
                side[name] = (fg, (
                    conv.linear_query(x), conv.linear_key(x),
                    fg.dst_slot_srcnode, fg.dst_slot_scales["sum"],
                    fg.dst_plan.row_key, fg.dst_plan.row_ptr,
                    conv.relation_kernel.detach()))
        fg_c, args_c = side["cpu"]
        fg_g, args_g = side["card"]
        plan = fg_c.dst_plan
        if plan.s2_gather is not None:
            raise AssertionError("the e2e graph has a hub stage 2")
        near, top = near_ties(fg_c, args_c, act)
        m = torch.cat([mm.reshape(-1, mm.shape[-1]) for *_, mm, _ in
                       K.bucket_products(*args_c[:5], args_c[6], act,
                                         plan.buckets1)])
        valid = args_c[3] > 0
        out_g = fg_g.dst_plan.finalize_rows_max(K.ell_max_fwd(*args_g, act))
        pairs = near.nonzero().tolist()
        cands = []
        for key, o in pairs:
            r = int(plan.key2row[key])
            s0, s1 = int(plan.row_ptr[r]), int(plan.row_ptr[r + 1])
            t = float(top[key, o])
            cands.append([s for s in range(s0, s1) if valid[s] and float(
                m[s, o]) >= t - 2 * NEAR_TIE * (1 + abs(t))])
        flat = [(key, s) for (key, _), ss in zip(pairs, cands) for s in ss]
        if not flat:
            log(f"  layer {i}: no near-tie (key, o)")
            continue
        dev = args_g[0].device
        keys = torch.tensor([k for k, _ in flat], dtype=torch.int32,
                            device=dev)
        slots = torch.tensor([s for _, s in flat], device=dev)
        one = K.ell_max_fwd(
            args_g[0], args_g[1], fg_g.dst_slot_srcnode[slots].contiguous(),
            torch.ones(len(flat), device=dev), keys,
            torch.arange(len(flat) + 1, dtype=torch.int32, device=dev),
            args_g[6], act).cpu()
        n_flip = uncovered = j = 0
        for (key, o), ss in zip(pairs, cands):
            mc = [float(m[s, o]) for s in ss]
            mg = one[j:j + len(ss), o].tolist()
            j += len(ss)
            if max(mg) != float(out_g[key, o]):
                uncovered += 1
            win_c = {s for s, v in zip(ss, mc) if v == max(mc)}
            win_g = {s for s, v in zip(ss, mg) if v == max(mg)}
            n_flip += win_c != win_g
        log(f"  layer {i}: {len(pairs)} near-tie (key, o) of "
            f"{near.numel()}, winners differ at {n_flip}")
        if uncovered:
            raise AssertionError(f"layer {i}: {uncovered} card maxima lie "
                                 f"outside the near-tie window")
        flips += n_flip
    return flips


def phase_e2e(device, agg: str):
    """One step on the card against the CPU. Logits and loss are held at
    the forward tolerance and every gradient at the backward tolerance
    (W_R's of a max conv at GW_TOL, a sum over every slot). With max, a
    (key, o) whose winning slot differs between the two (a near tie,
    rounded apart by the two summation orders) moves that entry's whole
    cotangent to another slot; such flips are counted and logged, and the
    gradients are held to the same elementwise tolerance all the same."""
    import copy

    import torch

    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.model import SIRModel
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.train import (
        build_arxiv_graph,
        get_args,
        soft_ce,
    )
    from sir_gcn_tpu_torch.ops.ell import leaky_relu
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype

    log(f"== e2e {agg}: one step on the card (kernels) against the CPU "
        f"(plain)")
    set_edge_dtype(None)
    args = get_args(["--add-reverse-edge", "--add-self-loop"])
    data = synthetic_node_classification(20_000, 140_000, feat_dim=128,
                                         num_classes=40, seed=1)
    model = SIRModel(128, 96, 40, num_layers=3, norm="bn", residual=True,
                     agg_type=agg,
                     generator=torch.Generator().manual_seed(1))
    runs = {}
    for name, dev in (("cpu", "cpu"), ("card", device)):
        fg = build_arxiv_graph(data, args, dev)
        m = copy.deepcopy(model).to(dev)
        m.train()
        inputs = []
        hooks = [c.register_forward_hook(
            lambda mod, inp, out: inputs.append(inp[1].detach()))
            for c in m.convs]
        feats, labels, w = step_inputs(data, fg.n_pad, dev)
        logits = m(fg, feats)
        loss = soft_ce(logits, labels, w)
        loss.backward()
        for hk in hooks:
            hk.remove()
        runs[name] = dict(
            fg=fg, model=m, inputs=inputs, logits=logits.detach().cpu(),
            loss=loss.detach().cpu(),
            grads={k: p.grad.cpu() for k, p in m.named_parameters()})
    c, g = runs["cpu"], runs["card"]
    log(f"  nodes 20000, edges {g['fg'].graph.num_edges}, loss card "
        f"{float(g['loss']):.6f} cpu {float(c['loss']):.6f}")
    compare("logits", g["logits"], c["logits"], FWD_TOL)
    compare("loss", g["loss"].reshape(1), c["loss"].reshape(1), FWD_TOL)
    if agg == "max":
        log(f"  winner flips, all layers: "
            f"{winner_flips(runs, leaky_relu(0.2))}")
    for k in c["grads"]:
        compare(f"grad {k}", g["grads"][k], c["grads"][k],
                GW_TOL if k.endswith("relation_kernel") else BWD_TOL)


def phase_e2e_sireconv(device):
    """One SIREConv training step on a ~20k-node graph on the card against
    the CPU, f32 edges: (fused) the default W_E, dropout 0; (generic) an
    Embed encoder of 8 discrete edge types, dropout 0, which takes the
    generic edge route and is as deterministic on both devices. The output
    at the forward tolerance and every parameter gradient at the backward
    tolerance, elementwise, and the card's launches exactly those of the
    route."""
    import copy

    import numpy as np
    import torch

    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.train import (
        build_arxiv_graph,
        get_args,
    )
    from sir_gcn_tpu_torch.models import Embed
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype

    set_edge_dtype(None)
    args = get_args(["--add-reverse-edge", "--add-self-loop"])
    data = synthetic_node_classification(20_000, 140_000, feat_dim=128,
                                         num_classes=40, seed=1)
    graphs = {name: build_arxiv_graph(data, args, dev)
              for name, dev in (("cpu", "cpu"), ("card", device))}
    x, ef, w = sireconv_inputs(graphs["cpu"], seed=1)
    types = torch.from_numpy(np.random.default_rng(1).integers(
        0, 8, graphs["cpu"].graph.num_edges))
    routes = {
        "fused": (lambda: make_sireconv(0.0), ef,
                  dict(ell_edge_act_reduce2=1, ell_edge_src_bwd=1)),
        "generic": (lambda: make_sireconv(0.0, edge_encoder=Embed(
            8, 96, generator=torch.Generator().manual_seed(2))), types,
            dict(ell_act_reduce2_edge=1, ell_src_bwd_edge=1)),
    }
    for route, (make, feats, want) in routes.items():
        log(f"== e2e sireconv {route}: one step on the card (kernels) "
            f"against the CPU (plain)")
        conv = make()
        runs = {}
        for name, fg in graphs.items():
            dev = fg.graph.device
            m = copy.deepcopy(conv).to(dev)
            m.train()
            reset_launch_counts()
            out = m(fg, x.to(dev), feats.to(dev))
            (out * w.to(dev)).sum().backward()
            if name == "card":
                torch.cuda.synchronize()
                launches = {k: v for k, v in LAUNCHES.items() if v}
                if launches != want:
                    raise AssertionError(f"{route}: card launches "
                                         f"{launches}, expected {want}")
            runs[name] = dict(out=out.detach().cpu(), grads={
                k: p.grad.cpu() for k, p in m.named_parameters()})
        c, g = runs["cpu"], runs["card"]
        log(f"  nodes 20000, edges {graphs['card'].graph.num_edges}, "
            f"launches {want}")
        compare("out", g["out"], c["out"], FWD_TOL)
        for k in c["grads"]:
            compare(f"grad {k}", g["grads"][k], c["grads"][k], BWD_TOL)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import sir_gcn_tpu_torch  # noqa: F401  (fails without the port)

    device = torch.device("cuda")
    t0 = time.perf_counter()
    smi = phase_env()
    phase_build()
    errs, timing, arxiv_fg = phase_kernels(device)
    launches = phase_train("sym")
    launches.update({k: v for k, v in phase_train("max").items()
                     if k in MAX})
    launches.update({k: v for k, v in phase_sireconv(device, arxiv_fg).items()
                     if k in EDGE})
    for agg in ("sym", "max"):
        phase_e2e(device, agg)
    phase_e2e_sireconv(device)
    for agg in ("sym", "max"):
        phase_profile(device, agg)
    phase_profile_sireconv(device, arxiv_fg)
    log(f"== all phases ok in {time.perf_counter() - t0:.1f}s")

    rows = []
    for name, (source, replaces, _) in KERNELS.items():
        t = timing[name]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
            bound_by=t["bound"][1], library_ms=t.get("library_ms")))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
