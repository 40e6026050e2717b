#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``sir_gcn_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  env      the card's name and power limit, torch and CUDA versions
  build    nvcc of the port's CUDA sources, with the ptxas register,
           shared-memory and spill report
  kernels  each ELL kernel against its plain PyTorch version on the card:
           awkward small plans (hub stage 2, H = 24 and 200, budget-1 pad
           rows, zero scales), then the ogbn-arxiv plan in f32 and bf16,
           with CUDA-event times of kernel and plain version beside the
           kernel's bound
  train    the arxiv trainer's entry point at full width (169,343 nodes,
           H = 96, 3 layers, sym, bn, residual, bf16 edges) for 5 steps
           and evals, with the launch counters read around it
  e2e      one training step on a ~20k-node graph on the card (kernels)
           against the same step on the CPU (plain versions)
  profile  device time by kernel over warm training steps of the train
           configuration (torch.profiler), and the device's idle share

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
PALLAS = "sir_gcn_tpu/ops/pallas/kernels.py"
# kernel -> (TPU function it replaces, flops per slot and feature)
KERNELS = {
    "ell_act_reduce": (f"{PALLAS}:55", 5),     # add, sigma, scale-add
    "ell_act_reduce2": (f"{PALLAS}:94", 8),    # + sigma', scale-add
    "ell_src_bwd": (f"{PALLAS}:198", 6),       # add, sigma', 2 mul, add
}


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
    ok = bool((diff <= tol["atol"] + tol["rtol"] * want.abs()).all())
    log(f"  {label}: max abs err {err:.3e}, max rel err {rel:.3e} "
        f"(atol {tol['atol']}, rtol {tol['rtol']}) {'ok' if ok else 'FAIL'}")
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
        fn = None
        for line in build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif fn and ("registers" in line or "spill" in line):
                log(f"  ptxas {fn[:60]}: {line.split(':', 1)[-1].strip()}")


def small_case(graph: str, h: int, device):
    """Awkward plans: a hub above the chunk budget (stage 2), H = 24 or
    200, budget-1 pad rows, and a fifth of the scales zeroed."""
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
                                bound=bound(name, args, got))


def bound(name, args, outs):
    """(least ms, what bounds it): every input read once and every output
    written once at the HBM rate, against the f32 flops at the f32 rate."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if hasattr(a, "numel"))
    nbytes += sum(o.numel() * o.element_size() for o in outs)
    node_tbl = args[0] if name == "ell_src_bwd" else args[1]
    slots = args[3].numel() if name == "ell_src_bwd" else args[2].numel()
    flops = slots * node_tbl.shape[1] * KERNELS[name][1]
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


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
    for graph, h in (("hub", 24), ("random", 96), ("random", 200)):
        case = small_case(graph, h, device)
        for act in (leaky_relu(0.2), tanh):
            for dtype in (torch.float32, torch.bfloat16):
                check_kernels(f"{graph} H={h} {act.name} {dtype}", *case,
                              act, dtype, errs)

    args = get_args(TRAIN_FLAGS)
    data = synthetic_node_classification(
        ARXIV_NODES, ARXIV_EDGES, feat_dim=128, num_classes=40, seed=0)
    fg = build_arxiv_graph(data, args, device)
    gen = torch.Generator(device=device).manual_seed(0)
    eq, ek, g = (torch.randn((fg.n_pad, 96), generator=gen, device=device)
                 for _ in range(3))
    sd, ss = fg.dst_slot_scales["sym"], fg.src_slot_scales["sym"]
    log(f"  arxiv plan: N {fg.n_pad}, S_dst {fg.dst_plan.num_slots}, "
        f"S_src {fg.src_plan.num_slots}, R1 {fg.dst_plan.num_rows}, H 96")
    timing = {}  # of the main path's bf16 edges
    for dtype in (torch.float32, torch.bfloat16):
        check_kernels(f"arxiv {dtype}", fg, eq, ek, g, sd, ss,
                      leaky_relu(0.2), dtype, errs,
                      timing=timing if dtype == torch.bfloat16 else None)
    for name, t in timing.items():
        b_ms, by, nbytes, flops = t["bound"]
        log(f"  {name} (bf16 edges): {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.3f} ms, bound {b_ms:.4f} ms by {by} "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
            f"{100 * b_ms / t['ms']:.1f}% of bound")
    return errs, timing


def phase_train():
    import numpy as np
    import torch

    from sir_gcn_tpu_torch.experiments.ogbn_arxiv import train
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts

    log("== train: " + " ".join(TRAIN_FLAGS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    (result,) = train.main(TRAIN_FLAGS)
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
    want = {"ell_act_reduce2": 3 * steps, "ell_src_bwd": 3 * steps,
            "ell_act_reduce": 3 * steps}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    return launches


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


def phase_profile(device, steps: int = 3):
    """Device time by kernel over a few warm training steps of the train
    phase's configuration, and the device's busy share of the wall time.
    Informational: it fails only if the step itself fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv import train
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.model import SIRModel
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import make_adamw

    log(f"== profile: {steps} warm training steps of the train configuration")
    args = train.get_args(TRAIN_FLAGS)
    set_edge_dtype(torch.bfloat16)
    data = synthetic_node_classification(
        ARXIV_NODES, ARXIV_EDGES, feat_dim=128, num_classes=40, seed=0)
    fg = train.build_arxiv_graph(data, args, device)
    model = SIRModel(128, 96, 40, num_layers=3, norm="bn", residual=True,
                     dropout=0.2, feat_dropout=0.2, agg_type="sym",
                     generator=torch.Generator().manual_seed(0)).to(device)
    step, _ = train.make_harness(model, fg, make_adamw(model.parameters(),
                                                       args.lr, args.wd))
    inputs = step_inputs(data, fg.n_pad, device)
    gen = torch.Generator(device=device).manual_seed(0)
    for _ in range(2):
        step(*inputs, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(*inputs, gen)
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


def phase_e2e(device):
    import copy

    import torch

    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.model import SIRModel
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.train import (
        build_arxiv_graph,
        get_args,
        soft_ce,
    )
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype

    log("== e2e: one step on the card (kernels) against the CPU (plain)")
    set_edge_dtype(None)
    args = get_args(["--add-reverse-edge", "--add-self-loop"])
    data = synthetic_node_classification(20_000, 140_000, feat_dim=128,
                                         num_classes=40, seed=1)
    model = SIRModel(128, 96, 40, num_layers=3, norm="bn", residual=True,
                     agg_type="sym",
                     generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", device):
        fg = build_arxiv_graph(data, args, dev)
        m = copy.deepcopy(model).to(dev)
        m.train()
        feats, labels, w = step_inputs(data, fg.n_pad, dev)
        logits = m(fg, feats)
        loss = soft_ce(logits, labels, w)
        loss.backward()
        out[str(dev)] = (logits.detach().cpu(), loss.detach().cpu(),
                         {k: p.grad.cpu() for k, p in m.named_parameters()})
    (lc, sc, gc), (lg, sg, gg) = out["cpu"], out[str(device)]
    log(f"  nodes 20000, edges {fg.graph.num_edges}, loss card "
        f"{float(sg):.6f} cpu {float(sc):.6f}")
    compare("logits", lg, lc, FWD_TOL)
    compare("loss", sg.reshape(1), sc.reshape(1), FWD_TOL)
    for k in gc:
        compare(f"grad {k}", gg[k], gc[k], BWD_TOL)


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
    errs, timing = phase_kernels(device)
    launches = phase_train()
    phase_e2e(device)
    phase_profile(device)
    log(f"== all phases ok in {time.perf_counter() - t0:.1f}s")

    rows = []
    for name, (replaces, _) in KERNELS.items():
        t = timing[name]
        rows.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
            bound_by=t["bound"][1], library_ms=None))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
