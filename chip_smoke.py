#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``sir_gcn_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it runs with its seconds (all of them again on
one line before the kernels line); any failure exits non-zero:
  env      the card's name and power limit, torch and CUDA versions
  build    nvcc of the port's CUDA sources (all started together), with the
           ptxas register, shared-memory and spill report
  kernels  each ELL kernel against its plain PyTorch version on the card
           (and the path of the max kernels #9-#11 for each W_R, which
           must be the tensor-core product at the arxiv plan):
           awkward small plans (hub stage 2, H = 20, 24, 96, 128 and 200, O != H,
           De = 5 and 16, budget-1 pad rows, zero scales, a row with no
           valid slot, isolated nodes, row counts that are not a multiple
           of a block's, duplicated edges that tie exactly; the general
           route's kernels with centered_relu, softmax and tanh sent down
           the general route), then the ogbn-arxiv plan in f32 and bf16
           (#1, #2 and #4 also on DropEdge's dynamic scales from a numpy
           mask at rate 0.2, bf16 timed beside the static scales),
           with CUDA-event times of kernel and plain version beside the
           kernel's bound (#12 and its CSR product in alternating turns,
           as in the lab phase); for #1, #2, #4 and their edge-term forms the
           path each launch took (the 16-byte vector path with its layout,
           which the arxiv plan must take, or the scalar loop), for #7
           and #8 theirs (W_E and g_WE in registers, which the arxiv plan
           must take, #7 on blocks of 128 columns past H = 128, or the
           shared-memory loop), and for #1r, #3, #4r,
           #5 and #6 theirs (the lane-group path, which the arxiv plan
           must take in f32 and bf16 with centered_relu and softmax, and
           #5 also with leaky_relu(0.2) and tanh, timed in bf16 with #6
           beside it on its first design; or the first design); where
           #3 and #6 both take the lane-group path, #6's rows must be #3's
           bits; the general route's new forms: the edge forms of #1r,
           #3 and #4r (#4r's g_e too) with centered_relu, softmax, and
           tanh and erf-GELU declared non-elementwise on the small plans
           (H = 20 to 200) and at the arxiv plan (centered_relu timed in
           bf16, the lane-group path required), erf-GELU declared
           non-elementwise on all five (timed at the arxiv plan in bf16),
           and a row-wise sigma past H = 256 in all five and the edge
           forms at H = 300, 512 and 520 on the small plans and at H =
           512 on the arxiv plan (centered_relu timed, near gates masked,
           then softmax): #1r and #4r (and their edge forms) on full-warp
           lane groups up to 512 on whole 16-byte chunks, the others on
           the wide path, each required; erf-GELU (the
           registry's gelu(), sigma id 4) on the
           small plans, at the arxiv plan in f32 and bf16 (bf16 timed
           beside leaky_relu) and at H = O = 512 on a plan of the
           heterophilous minesweeper's size (10,000 nodes, 78,804 edges),
           beside leaky_relu(0.2), for #1, #2, #4, their edge forms, #7,
           #8 and #9-#12 (near ties masked for max); the max kernels' new
           forms: the edge forms #9e-#11e with leaky_relu(0.2) and
           erf-GELU, the row-wise forms of #9-#11 with centered_relu(0.5)
           and softmax, and both at once (centered_relu with the edge
           term) on the small plans (H = 24 to 200; the row-wise forms
           also at H = 300, 512 and 520), at the arxiv plan in f32 and
           bf16 (the edge form with leaky_relu, the row-wise form with
           centered_relu and both at once timed in bf16, near ties and
           near gates masked) and the row-wise forms at H = O = 512 on the
           heterophilous plan (centered_relu timed in bf16); #7 and #8
           past a block's shared memory (the columns path, required): on
           the small plans at (H, De) = (100, 600), (40, 1024) and (40,
           2000) (W_E and #8's partials in device memory for the last
           two), and #8 with De = 16 on its tiles path (required) at the
           heterophilous plan and at H = 512 on the arxiv plan in bf16
           (timed, "[wide]"); every check of #7 and #8 launches each twice
           for the same bits
  train    the arxiv trainer's entry point at full width (169,343 nodes,
           H = 96, 3 layers, bn, residual, bf16 edges), once with sym and
           once with max aggregation, 5 steps and evals each, with the
           launch counters set to 0 before and read after each run (with
           max, the path of #9-#11 is logged and must be the tensor-core
           product)
  dropedge the sym run with --edge-dropout 0.2, twice, then sym once more
           (sym, max, dropedge, dropedge, sym): a fresh DropEdge mask per
           layer and step, #2 and #4 on dynamic slot scales, exactly the
           sym run's launches; the mean step, eval and peak beside sym's
  bench    bench_torch.run in-process at full size (169,343 nodes, 1,166,243
           raw edges, padded to 1024; 10 steps, then 2 timed blocks of 10):
           (a) random, (b) powerlaw with RCM reordering, (c) community, (d)
           random with the SIREConv lane; each record on its own line, the
           losses finite, exact launch counts and each step profiled; on
           (b)'s plan both plans with a stage 2, one aggregate (#2, #4;
           bf16, leaky_relu(0.2), H = 96) against its plain versions and
           #1, #2, #4 against theirs, timed beside (a)'s random plan; a
           second build of (d)'s graph a memo hit
  sireconv one SIREConv layer at full width on the arxiv graph (96 in,
           De = 16 edge features, 96 hidden and out, sym, bf16 edges):
           5 AdamW steps and 5 evals on the fused-edge route (dropout 0)
           and on the generic edge route (dropout 0.2), with exact launch
           counts for each
  general  one SIRConv with the row-wise sigma centered_relu(0.5) at full
           width on the arxiv graph (96 in, hidden and out, sym, bf16
           edges): 5 AdamW steps and 5 evals on the general route, with
           exact launch counts
  general_edge (a) one SIREConv at bench lane (d)'s shape with the
           row-wise centered_relu(0.5) on the arxiv plan (96 in, De = 16
           raw edge features, 96 hidden and out, sym, bf16 edges): 5 AdamW
           steps and 5 evals on the general route's edge forms, exactly
           #1r·e, #3e and #4r·e once a step and #1r·e once an eval, and a
           profile of 3 warm steps; (b) one step of it on a ~20k-node
           graph, card against CPU, f32 edges, dyadic inputs, out and
           every gradient (W_E's too)
  general_wide one SIRConv at the heterophilous width (512 in, hidden and
           out) on the arxiv plan, bf16 edges, 3 steps and evals each
           with exact launch counts, after the layout rule at 512 and
           520 in bf16 and f32 (required): (a) softmax, mean and (b)
           centered_relu(0.5), sym, #1r, #3 and #4r on full-warp lane
           groups ((b) profiled), (c)
           erf-GELU declared non-elementwise, sym; then one aggregate
           each with its exact launches: (d) erf-GELU at H = 96 with
           fuse_bwd_take (#2, #5), (e) centered_relu at H = 512 with
           fuse_bwd_take (#1r, #3, #5; #5 on full-warp lane groups), and
           the dst-major composition
           (#1r, #6, #12) with (f) centered_relu at H = 512 and (g)
           erf-GELU declared non-elementwise at H = 96
  sireconv_wide the SIREConv of the heterophilous default width (512 ->
           512, De = 16, sym, leaky_relu(0.2), dropout 0) on the fused
           edge route, #7 on the register path's blocks of 128 columns,
           #8 on its tiles path: (a) one step on the
           heterophilous plan, card against CPU, f32 edges, dyadic inputs,
           out and every gradient (W_E's too); (b) 3 AdamW steps and evals
           on the arxiv plan, bf16 edges, exactly #7 once a step and once
           an eval and #8 once a step, the step and eval times, the peak
           memory and one profiled step
  sireconv_max lane (d)'s SIREConv with max at full width on the arxiv
           plan (96 in, De = 16, 96 hidden and out, dropout 0.2, bf16
           edges) through SIREConv.forward: (a) leaky_relu(0.2) and (b)
           centered_relu(0.5) (the edge term and a row-wise sigma
           together), 5 AdamW steps and 5 evals each, exactly #9e, #10e,
           #11e and #12 once a step and #9e once an eval, the peak memory
           and one profiled step each; (c) one step of (b) on a ~20k-node
           graph, card against CPU, f32 edges, dyadic inputs, out and every
           gradient
  max_rowwise one SIRConv with max and a row-wise sigma, bf16 edges: (a)
           centered_relu(0.5) and (b) softmax at 96 -> 96 on the arxiv plan,
           5 steps and evals each; (c) centered_relu at 512 -> 512 on a
           graph of roman-empire's size (22,662 nodes, 32,927 undirected
           edges), 3 steps and evals, one more step profiled; (d) erf-GELU
           declared non-elementwise at 96, 3 steps and evals (the max
           kernels' erf-GELU forms); each with exact launches (#9, #10,
           #11 and #12 once a step, #9 once an eval) and its peak memory
  bwd      the forward and backward of one aggregate at the arxiv plan
           (H = 96, sym, tanh) three ways: src-major (#2, #4), fused take
           (#2, #5) and dst-major (#1, #6, #12); each design's time, the
           gradients of the other two against the src-major one, #5's
           path (the lane-group path required) and #6's, and the backward
           kernels alone (#4 and #5 with tanh and with leaky_relu)
  lab      the timing lab at the JAX tools' sizes: the entry points of
           sir_gcn_tpu_torch.tools.kernel_lab (every tag; R = 111,104 rows
           of B = 16 slots, H = 128) and .gather_dma (N = 169,984, S =
           2,752,512, T = 4096, TSUM = 8192), with the launch counters set
           to 0 before and read after; gather_dma once more with a table
           of N = 679,936 rows (174 MB, beyond the 50 MB L2); then each of
           #13-#24 against its plain version on the same inputs, with
           CUDA-event times of kernel, plain version and library call
           beside the bound (kernel and library call in 4 alternating
           turns of 20 launches, the median kept: #12 and #19-#24); #22
           with its persistent grid and #20 at each inflight held and
           timed the same way, and #20 and #23 launched twice for equal
           bits; its inputs are freed before the e2e and profile phases
  e2e      one training step on a ~20k-node graph on the card (kernels)
           against the same step on the CPU (plain versions): the arxiv
           model with sym and with max, the SIREConv layer on its fused
           and its generic route, and the general phase's SIRConv; then
           each route of sir_aggregate under one numpy DropEdge mask on
           the same graph (the five kernel routes on dynamic scales with
           their exact launches, the pure ELL route and the CSR aggregate
           with none), out and every gradient
  pure     one forward and backward of the pure ELL route with a sigma
           that holds a tensor (erf-GELU times a per-feature gain: JAX's
           XLA route) at the arxiv plan beside the kernel route's with
           leaky_relu; a parameter-free sigma outside the registry
           (F.gelu) raises
  profile  device time by kernel over warm training steps of each train,
           dropedge, sireconv and general configuration (torch.profiler;
           dropedge's beside sym's, kernel by kernel), and the device's
           idle share
  fullgraph the full-graph workloads through their entry points on
           synthetic stand-ins at the published sizes, the launch
           counters at 0 before and read after each run, each kernel's
           count exact: (b) heterophilous --dataset roman-empire
           --agg-type max (22,662 nodes, 65,854 edges; hidden 512, 5
           layers, 3 epochs: #9-#12 with erf-GELU), (a) heterophilous
           --dataset minesweeper --use-amp (10,000 nodes, 78,804 edges;
           5 epochs: #2, #4 and #1 with erf-GELU), (c) wiki-cs
           --jumping-knowledge --resid-layers 1 (11,701 nodes, 431,726
           edges; hidden 64, 4 layers, 5 epochs: #1, #2, #4 with
           leaky_relu) and its --model GAT (no kernel): epochs, run time,
           median synced train step and eval, peak memory, the test
           metric; a profiled warm train step of (a); (d) the
           heterophilous SIRModel (2 layers, hidden 512, ln, residual,
           bf16 inputs) with mean and with max, wiki-cs's JK
           GraphSIRModel and GATModel, one step card against CPU; then
           one SIREConv with erf-GELU on the arxiv plan, 2 steps and
           evals on each edge route (the edge kernels' erf-GELU forms)
  bot      the reference's best arxiv pipeline through the entry points,
           in a temporary working directory, the launch counters at 0
           before and read after each run: (a) the teacher, the train
           phase's sym configuration with the label trick, label reuse
           (1), mask-rate 0.5, FLAG (m = 3) and --save-pred, 5 epochs,
           exactly 18 #1, 12 #2 and 12 #4 a step and eval; (b) the
           student (--kd-mode student), the same; (c) C&S --use-sym on
           both files, no launch; (d) at one layer, 4 epochs straight
           against 2 with a checkpoint and a resume to 4: the same bits;
           (e) one FLAG + reuse + KD step of the teacher's model on a
           2,000-node graph, card against CPU from the same weights and
           initial perturbation; (f) --no-fast-path for 2 epochs, no
           launch; (g) two CSR aggregates on the HEC batch: the same
           bits, and its segment sum timed beside index_add's
  oracles  the two synthetic oracles through their entry points, with
           the launch counters at 0 before and after each run (their
           batches take the CSR aggregate, no kernel of the port): (a)
           DictionaryLookup SIR n=10 (h=40, 5000 samples, batch 256) to
           its early stop, test accuracy exactly 1.0; (b) its GCN for 15
           epochs, exactly 0.1; (c) HeteroEdgeCount SIR c=2 (h=20, 50
           nodes, unnormalized) to its early stop or epoch 500, test MSE
           under 2e-3; each run's epochs, wall time, median train step
           and HEC's collation time per batch; one profiled train step
           of DL SIR and of HEC SIR (with and without its collation); (d)
           the twelve models of both harnesses, two layers at full width,
           one forward and backward on the card against the CPU
  batched  the four batched-graph workloads through their entry points
           (their batches take the CSR aggregate, no kernel of the
           port): (a) the README commands zinc --norm gn
           --jumping-knowledge --residual (1,000 molecules, batch 128),
           ogbg_molhiv --virtual-node --flag (1,000 molecules, batch 512,
           m = 3), sbm --dataset PATTERN (500 graphs, batch 128) and
           super_pixel --dataset MNIST --use-feature (500 graphs, batch
           128), hidden 64, 4 layers, 3 epochs each: epochs, run time,
           median synced train step, the median batch wait with prefetch
           and collation without, peak memory; a profiled warm train step
           of each, with and without its batch's collation; (b) eleven
           models (the four, zinc edge max, molhiv centrality + edge +
           JK, molhiv GIN with a virtual node, zinc cn and ln, sbm GAT,
           zinc GIN) one step on the card against the CPU; (c) the launch
           counters at 0 around (a), the profiles and (b)'s card steps
  dist     the multi-GPU slice on the one card: (a) the bench graph
           (169,343 nodes, random, bidirected, self-loops, padded to
           128 x 4) planned by the native planner and by NumPy, the plans
           array-equal, seconds of each, then the halo and all-gather
           plans of 4 shards; (b) each of the 4 ranks' local forward and
           backward (H = 96, sym, bf16 edges, leaky_relu(0.2)) on #2 and
           #4 over its own plans, and its forward without a gradient on
           #1, the exchanged tables assembled by indexing the whole ek;
           out and both gradients against the single-card aggregate on the
           FastGraph, for the halo aggregate on static and on DropEdge
           scales and for the all-gather one, the launches exact (counters
           at 0 before each, read after); rank 0's forward and backward
           timed beside the single card's; (c) a one-rank NCCL group on
           the card (its mesh built): one arxiv-configuration step through
           a HaloGraph of one shard against the FastGraph's (loss and
           every weight), and one zinc --norm bn step through
           make_dp_train_step_stateful, bitwise the single-device step
  gspmd    the row-sharded full graph (parallel/full_graph.py), where no
           kernel of the port runs: (a) under a one-rank NCCL group, the
           heterophilous roman-empire --agg-type max (hidden 512, 5
           layers) and the wiki-cs --model GAT runs of the fullgraph
           phase, 3 epochs each, through the trainers' run_single on the
           plain graph and on a one-shard ShardedGraph of it: the synced
           step and eval, the peak memory, no launch (the counters at 0
           before and read after), the best epoch's losses of the two
           within FWD_TOL; (b) four row shards one after another on the
           card, each handed its gathered table: a SIRConv with max and
           erf-GELU at H = O = 512 on the roman-empire stand-in and a
           GATv2 layer of the wiki-cs GAT on the wiki-cs stand-in, the
           joined rows at FWD_TOL and the summed input and weight
           gradients at BWD_TOL against the single card, no launch; (c)
           bench_scaling_torch.py --devices 1 on the halo and the
           row-sharded path at its default size (16,384 nodes, 131,072
           edges, hidden 64, 2 layers), its JSON lines logged; (d)
           dryrun_multichip(1), the seven parts on one spawned NCCL rank

The last line is the JSON contract line; the line before it lists each
kernel's launches on the main path, error, times and bound: the edge forms
as "<name>[edge]" (the max kernels' with the sireconv_max phase's
leaky_relu launches), the general route's erf-GELU and wide forms as
"<name>[gelu]" and "<name>[wide]", their launches those of the
general_edge and general_wide phases, and the max kernels' row-wise forms
as "<name>[rowwise]", "<name>[rowwise,wide]" and "<name>[edge,rowwise]",
their launches those of the max_rowwise phase's 96- and 512-wide runs and
of the sireconv_max phase's centered_relu run; #7 and #8 at H = 512 as
"<name>[wide]", their launches the sireconv_wide phase's (b). Needs a CUDA
card and the port beside this script; exits non-zero without either.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

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
# the lab's gather and tile sums add 4096 or 8192 rows in f32, in another
# order in the kernel than in the plain version; each sum's error is at most
# (chain - 1) * 2^-24 * (sum of the terms' magnitudes) for its longest chain
# of rounded adds, and in practice far less (it grows as the chain's square
# root): allowed is that bound for a chain of 1024 adds
SUM_TOL = 2.0 ** -24 * 1024
# the passthrough rounds x + 1 to bf16 once on both sides
EXACT = dict(atol=0.0, rtol=0.0)
# a kernel with a library call is timed against it in TURNS alternating
# turns of LIBRARY_ITERS launches, and each side's median is kept
TURNS, LIBRARY_ITERS = 4, 20
# H100 SXM data sheet: HBM rate, the f32 rate outside the tensor cores and
# the dense TF32 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# #9-#11 do each f32 product as three TF32 products on the tensor cores
TF32_PASSES = 3
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
GENERAL_SOURCE = "sir_gcn_tpu_torch/csrc/ell_general_kernels.cu"
LAB_SOURCE = "sir_gcn_tpu_torch/csrc/lab_kernels.cu"
PALLAS = "sir_gcn_tpu/ops/pallas/kernels.py"
KERNEL_LAB, GATHER_DMA = "tools/kernel_lab.py", "tools/gather_dma.py"
# kernel -> (source, TPU function it replaces, flops per slot and feature;
# for the max kernels per valid slot and per H*O; for the fused-edge
# kernels per valid slot and feature on top of 2 De (forward) or 4 De
# (backward) for the edge projection and g_WE; for the general route's
# kernels per valid slot and feature with centered_relu; for the lab's
# kernels per element of the slot rows)
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
    # the max kernels' edge forms (#9e-#11e): the same products
    "ell_max_fwd_edge": (MAX_SOURCE, f"{PALLAS}:574", 2),
    "ell_max_wincount_edge": (MAX_SOURCE, f"{PALLAS}:625", 2),
    "ell_max_bwd_edge": (MAX_SOURCE, f"{PALLAS}:679", 6),
    # add, mean add, sub, max, scale-add
    "ell_act_reduce_rowwise": (GENERAL_SOURCE, f"{PALLAS}:55", 6),
    # z add, mean add, sub, gate, g*scale, sum add, mul-sub, add
    "ell_geq_reduce": (GENERAL_SOURCE, f"{PALLAS}:152", 9),
    "ell_src_bwd_rowwise": (GENERAL_SOURCE, f"{PALLAS}:198", 9),
    "ell_src_bwd_fused": (GENERAL_SOURCE, f"{PALLAS}:264", 9),
    "ell_act_reduce_bwd": (GENERAL_SOURCE, f"{PALLAS}:326", 9),
    # the general route's edge forms (#1r·e, #3e, #4r·e): + the e add
    "ell_act_reduce_rowwise_edge": (GENERAL_SOURCE, f"{PALLAS}:55", 7),
    "ell_geq_reduce_edge": (GENERAL_SOURCE, f"{PALLAS}:152", 10),
    "ell_src_bwd_rowwise_edge": (GENERAL_SOURCE, f"{PALLAS}:198", 10),
    # add, compare, mul, scale, add
    "lab_v1": (LAB_SOURCE, f"{KERNEL_LAB}:68", 5),
    "lab_v2": (LAB_SOURCE, f"{KERNEL_LAB}:99", 5),
    "lab_v3": (LAB_SOURCE, f"{KERNEL_LAB}:138", 5),
    "lab_v4": (LAB_SOURCE, f"{KERNEL_LAB}:171", 5),
    "lab_v5": (LAB_SOURCE, f"{KERNEL_LAB}:207", 5),
    "lab_v6": (LAB_SOURCE, f"{KERNEL_LAB}:238", 5),
    "lab_copy": (LAB_SOURCE, f"{KERNEL_LAB}:277", 1),   # add
    "lab_copy32": (LAB_SOURCE, f"{KERNEL_LAB}:300", 1),
    "lab_pass": (LAB_SOURCE, f"{KERNEL_LAB}:323", 1),
    "lab_pass2": (LAB_SOURCE, f"{KERNEL_LAB}:345", 1),
    "lab_gather": (LAB_SOURCE, f"{GATHER_DMA}:67", 1),
    "lab_tile_sum": (LAB_SOURCE, f"{GATHER_DMA}:166", 1),
}
LINEAR = ("ell_act_reduce", "ell_act_reduce2", "ell_src_bwd")
EDGE = ("ell_act_reduce_edge", "ell_act_reduce2_edge", "ell_src_bwd_edge",
        "ell_edge_act_reduce2", "ell_edge_src_bwd")
MAX = ("ell_max_fwd", "ell_max_wincount", "ell_max_bwd", "ell_scaled_reduce")
GENERAL = ("ell_act_reduce_rowwise", "ell_geq_reduce", "ell_src_bwd_rowwise")
BWD = ("ell_src_bwd_fused", "ell_act_reduce_bwd")
# the general route's edge forms; each is a row of the kernels line under
# its base kernel's name and "[edge]", its launches the general_edge
# phase's
GENERAL_EDGE = {"ell_act_reduce_rowwise_edge": "ell_act_reduce_rowwise",
                "ell_geq_reduce_edge": "ell_geq_reduce",
                "ell_src_bwd_rowwise_edge": "ell_src_bwd_rowwise"}
# the max kernels' edge forms, rows "<name>[edge]" of the kernels line,
# their launches the sireconv_max phase's leaky_relu run
MAX_EDGE = {"ell_max_fwd_edge": "ell_max_fwd",
            "ell_max_wincount_edge": "ell_max_wincount",
            "ell_max_bwd_edge": "ell_max_bwd"}
EDGE_FORMS = {**GENERAL_EDGE, **MAX_EDGE}
# the max kernels' forms, rows "<name>[<form>]": centered_relu at the
# arxiv width ("rowwise", the max_rowwise phase's 96-wide runs), at the
# heterophilous width ("rowwise,wide", its 512-wide run, the wide path)
# and with the edge term ("edge,rowwise", the sireconv_max phase's
# centered_relu run); erf-GELU at 512 on roman-empire's plan ("wide", the
# fullgraph phase's (b): the wide path)
MAX_FORMS = ("rowwise", "rowwise,wide", "edge,rowwise", "wide")
# the general route's kernels with an erf-GELU form and a wide form (a
# row-wise sigma past H = 256), each a row of its own, "<name>[gelu]" and
# "<name>[wide]", its launches the general_wide phase's
GENERAL_FORMS = GENERAL + BWD
# the general_wide phase's width: the heterophilous default
WIDE_H = 512
# #1r, #3 and #4r and their edge forms, and #5: past H = 256 on lane groups
# of the whole warp, up to 512 on whole 16-byte chunks; #6 takes the first
# design's wide path past 256
FULL_WARP = ("ell_act_reduce_rowwise", "ell_geq_reduce", "ell_src_bwd_rowwise",
             "ell_act_reduce_rowwise_edge", "ell_geq_reduce_edge",
             "ell_src_bwd_rowwise_edge", "ell_src_bwd_fused")
# the general kernels the general_wide phase's softmax SIRConv (a) runs,
# timed at WIDE_H under softmax too, each a row "<name>[wide,softmax]"
WIDE_SOFTMAX = ("ell_act_reduce_rowwise", "ell_geq_reduce",
                "ell_src_bwd_rowwise")
LAB = tuple(k for k in KERNELS if k.startswith("lab_"))
EDGE_DIM = 16  # the edge basis width of the SIREConv configuration
# the kernels with an erf-GELU form (sigma id 4): each is a row of its own
# in the kernels line, "<name>[gelu]", timed at the arxiv plan beside the
# leaky_relu form, its launches those of the fullgraph phase's (a) (#1,
# #2, #4), of the sireconv gelu run (the edge kernels) and of the
# max_rowwise phase's (d) (#9-#11 at the arxiv width)
GELU = LINEAR + EDGE + MAX[:3]
# the heterophilous plan of the kernels phase: minesweeper's size
# (10,000 nodes, 39,402 undirected edges: Platonov et al. 2023, Table 1),
# H = O = 512, the heterophilous default width
HETERO_NODES, HETERO_EDGES, HETERO_H = 10_000, 78_804, 512
# #7 and #8 at H = 512, De = EDGE_DIM (the sireconv_wide phase's): with De
# <= 16 the forward takes the register path on blocks of 128 columns (W_E's
# columns in registers, a slot's basis row broadcast from a ring), the
# backward, whose nine tables (288 KiB) pass a block's shared memory, the
# tiles path (W_E's columns in registers, g_WE on tensor-core tiles of 16
# slots)
WIDE_EDGE_PATHS = ("registers", "tiles")
# (H, De, the paths of #7 and #8) past a block's shared memory, checked on
# the small plans: #7's W_E too (100, 600); #8's partials in device memory
# (40, 1024); #7's W_E in device memory too (40, 2000)
LARGE_DE = ((100, 600, ("columns", "columns")),
            (40, 1024, ("shared", "columns")),
            (40, 2000, ("columns", "columns")))


def flags_for(agg: str) -> list:
    flags = list(TRAIN_FLAGS)
    flags[flags.index("--agg-type") + 1] = agg
    return flags


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(label, got, want, tol, keep=None, quiet=False) -> float:
    """Max abs error of ``got`` against ``want``; raises past ``tol``. With
    ``keep`` (bool over the first dim) only those rows are compared; with
    ``quiet`` it logs only a failure."""
    import torch

    got, want = got.float(), want.float()
    if keep is not None:
        got, want = got[keep], want[keep]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite output")
    diff = (got - want).abs()
    err = float(diff.max())
    rel = float((diff / want.abs().clamp_min(1e-12)).max())
    atol = tol["atol"] + tol.get("amax", 0.0) * float(want.abs().max())
    ok = bool((diff <= atol + tol["rtol"] * want.abs()).all())
    if not (quiet and ok):
        log(f"  {label}: max abs err {err:.3e}, max rel err {rel:.3e} "
            f"(atol {atol:.3g}, rtol {tol['rtol']}) "
            f"{'ok' if ok else 'FAIL'}")
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


def library_turns(name, kernel, library, tm, what="") -> None:
    """Times ``kernel`` and ``library`` (one PyTorch call computing the
    same function) in TURNS alternating turns of LIBRARY_ITERS launches
    each (kernel, library, library, kernel, ...), logs each side's median,
    spread and turns with the kernel's verdict, and puts the medians into
    ``tm`` as its ``ms`` and ``library_ms``."""
    from sir_gcn_tpu_torch.tools import alternating_ms, verdict

    ms = alternating_ms({"kernel": kernel, "library": library},
                        LIBRARY_ITERS, TURNS)
    tm.update(ms=statistics.median(ms["kernel"]),
              library_ms=statistics.median(ms["library"]))
    log(f"  {name} against {what or 'its library call'}, {TURNS} turns of "
        f"{LIBRARY_ITERS}: " + ", ".join(
            f"{k} median {statistics.median(v):.4f} ms [{min(v):.4f}-"
            f"{max(v):.4f}] ({' / '.join(f'{x:.4f}' for x in v)})"
            for k, v in ms.items())
        + f": {verdict(ms['kernel'], ms['library'])}")


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


def short_name(fn: str) -> str:
    """A mangled kernel name without its anonymous namespace and
    parameter list: the kernel and its template arguments."""
    m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?)(?:EEv|Ev)", fn)
    return m.group(1)[:80] if m else fn[:80]


def phase_build():
    from sir_gcn_tpu_torch.ops.cuda import build

    log("== build")
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"  built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name in build.SOURCES:
        entries = build.ptxas_entries(build.build_log(name))
        regs = [r for _, r, _ in entries]
        spills = [f"{short_name(fn)} {b} B" for fn, _, b in entries if b]
        log(f"  ptxas {name}: {len(entries)} kernels, registers "
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


def log_layout(label, name, args, outs, extra=(), require_vector=False):
    """Log the path a launch of ``name`` (a kernel of ell_kernels.cu, its
    wrapper's ``args`` and outputs ``outs``, an edge form's table in
    ``extra``) took: the vector path with its (C, G, U) or the scalar loop.
    With ``require_vector`` the scalar loop raises."""
    from sir_gcn_tpu_torch.ops import cuda as K

    bwd = "src_bwd" in name
    tables = (args[:3] if bwd else args[:2]) + tuple(extra)
    dtype = (args[0] if bwd else args[1]).dtype
    lay = K.ell_layout(name, args[0].shape[1], dtype, *tables, *outs)
    log(f"  {label} {name}: " + ("scalar path" if lay is None else
                                 "vector path, C {}, G {}, U {}".format(*lay)))
    if require_vector and lay is None:
        raise AssertionError(f"{label} {name} took the scalar path")


def log_max_layout(label, h, o, require=None):
    """Log the path #9-#11 take for W [h, o] (ell_max_layout: the
    tensor-core product on the first design or on the wide path, and the
    launch shapes). With ``require`` ("first" or "wide") any other path
    raises: a design must not be bypassed."""
    from sir_gcn_tpu_torch.ops import cuda as K

    lay = K.ell_max_layout(h, o)
    log(f"  {label} #9-#11 path (H {h}, O {o}): {lay}")
    took = None if lay is None else "wide" if lay.wide else "first"
    if require is not None and (took != require or lay.path != "tensor"):
        raise AssertionError(f"{label}: #9-#11 take {lay}, not the "
                             f"{require} design's tensor-core path")


def log_edge_layout(label, h, de, act, dtype, require=None):
    """Log the paths #7 and #8 take for rows of width h and a basis of
    width de (ell_edge_layout: registers, on blocks of 128 columns in #7
    past H = 128, the shared-memory loop or its
    columns path with the chunks, or #8's tiles path). With ``require``
    (the forward's and the backward's path) any other raises: a path must
    not be bypassed."""
    from sir_gcn_tpu_torch.ops import cuda as K

    lay = K.ell_edge_layout(h, de, act, dtype)
    log(f"  {label} #7/#8 paths (H {h}, De {de}): {lay}")
    if require is not None and (lay is None
                                or (lay.fwd, lay.bwd) != tuple(require)):
        raise AssertionError(f"{label}: #7 and #8 take {lay}, not the "
                             f"{require} paths")


def log_general_layout(label, name, args, outs, require_group=False,
                       require_wide=False):
    """Log the path a launch of ``name`` (#1r ``ell_act_reduce_rowwise``,
    #3 ``ell_geq_reduce``, #4r ``ell_src_bwd_rowwise``, their edge forms,
    #5 ``ell_src_bwd_fused`` or #6 ``ell_act_reduce_bwd``, its wrapper's
    ``args`` and outputs ``outs``) took (ell_general_layout: the lane-group
    path with its layout, the wide path, or the first design); returns the
    layout. With ``require_group`` any other path raises: the redesign must
    not be bypassed; with ``require_wide`` any but the wide path."""
    from sir_gcn_tpu_torch.ops import cuda as K

    h = args[1].shape[1] if name == "ell_src_bwd_fused" else args[0].shape[1]
    if name in ("ell_act_reduce_rowwise", "ell_geq_reduce",
                "ell_act_reduce_bwd", "ell_act_reduce_rowwise_edge",
                "ell_geq_reduce_edge"):
        # eq, ek (gathered), ..., act[, g][, e]
        tables, act, dtype = args[:2] + args[7:], args[6], args[1].dtype
    elif name == "ell_src_bwd_rowwise":  # eq, g (gathered), ek, ..., act
        tables, act, dtype = args[:3], args[-1], args[0].dtype
    elif name == "ell_src_bwd_rowwise_edge":  # ..., act, e
        tables, act, dtype = args[:3] + args[8:], args[7], args[0].dtype
    else:  # both [N, 2H] (gathered), ek, ..., act
        tables, act, dtype = args[:2], args[-1], args[0].dtype
    lay = K.ell_general_layout(name, h, dtype, act, *tables, *outs)
    wide = isinstance(lay, K.WideLayout)
    log(f"  {label} {name}: " + ("first design" if lay is None else
                                 f"wide path, {lay}" if wide else
                                 f"lane-group path, {lay}"))
    if require_group and (lay is None or wide):
        raise AssertionError(f"{label} {name} did not take the lane-group "
                             f"path")
    if require_wide and not wide:
        raise AssertionError(f"{label} {name} did not take the wide path")
    return lay


def check_kernels(label, fg, eq, ek, g, sd, ss, act, dtype, errs,
                  timing=None, require_vector=False):
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
        log_layout(label, name, args, got, require_vector=require_vector)
        if timing is not None:
            timing[name] = dict(ms=cuda_ms(kernel, 50),
                                plain_ms=cuda_ms(plain, 5, warmup=1),
                                bound=linear_bound(name, args, got))


def bound(args, outs, flops, rate=PEAK_F32_FLOPS):
    """(least ms, what bounds it, bytes, flops): every input tensor read
    once and every output written once at the HBM rate, against ``flops``
    at ``rate`` (the f32 rate unless given). An int in ``args`` is the
    bytes the function needs of an input it reads only in part."""
    nbytes = sum(a if isinstance(a, int) else a.numel() * a.element_size()
                 for a in args if isinstance(a, int) or hasattr(a, "numel"))
    nbytes += sum(o.numel() * o.element_size() for o in outs)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / rate
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
                       errs, timing=None, require_vector=False,
                       edge_paths=None, fused_only=False, tag=""):
    """The edge-term forms of #1, #2 and #4 (with its per-edge cotangent)
    and the fused-edge kernels #7 and #8 against their plain versions;
    g_WE at GW_TOL, a g_e stored in bf16 at one bf16 step. #7 and #8 must
    take ``edge_paths`` (the register path with ``require_vector``), and
    a second launch of each must give the first one's bits. With
    ``fused_only`` only #7 and #8 run; their errors and times go under
    their names and ``tag``."""
    import torch

    from sir_gcn_tpu_torch.ops import cuda as K

    fwd, bwd = kernel_args(fg, eq, ek, g, sd, ss, act, dtype)
    plan, splan = fg.dst_plan, fg.src_plan
    bd, bs = plan.buckets1, splan.buckets1
    et = None if fused_only else e.to(dtype).contiguous()
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
    if fused_only:
        runs = {k: v for k, v in runs.items() if k.startswith("ell_edge_")}
    layout_args = {"ell_act_reduce_edge": fwd, "ell_act_reduce2_edge": fwd,
                   "ell_src_bwd_edge": bwd}
    outs = {}
    for name, (kernel, plain, tols) in runs.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for i, (a, b, tol) in enumerate(zip(got, want, tols)):
            err = compare(f"{label} {name}[{i}]", a, b, tol)
            errs[name + tag] = max(errs.get(name + tag, 0.0), err)
        if name in layout_args:
            log_layout(label, name, layout_args[name], got, extra=(et,),
                       require_vector=require_vector)
        if name.startswith("ell_edge_"):
            again = kernel()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{label} {name}: a second launch "
                                     f"gave other bits")
        outs[name] = got
    log(f"  {label} #7, #8: a second launch gave the same bits")
    log_edge_layout(label, eq.shape[1], eb.shape[1], act, dtype,
                    require=("registers",) * 2 if require_vector
                    else edge_paths)
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
    tiles = K.ell_edge_layout(h, de, act, dtype).bwd == "tiles"
    for name, (kernel, plain, _) in runs.items():
        args, flops = needs[name]
        timing[name + tag] = dict(ms=cuda_ms(kernel, 20),
                                  plain_ms=cuda_ms(plain, 3, warmup=1),
                                  bound=bound(args, outs[name], flops))
        if name == "ell_edge_src_bwd" and tiles:
            # the tiles path runs g_WE's 2 De flops a slot and feature as
            # three-pass TF32 on the tensor cores, beside the rest on the
            # f32 pipe: the slower of the two bounds it
            tc = valid_s * h * 2 * de
            simt = bound(args, outs[name], flops - tc)
            mma = bound(args, outs[name], TF32_PASSES * tc, PEAK_TF32_FLOPS)
            f32 = timing[name + tag]["bound"][0]
            timing[name + tag]["bound"] = max(simt, mma)
            log(f"  {name}{tag}: bound {max(simt, mma)[0]:.4f} ms; its "
                f"f32 flops {(flops - tc) / PEAK_F32_FLOPS * 1e3:.4f} ms at "
                f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s, g_WE's "
                f"{TF32_PASSES * tc / PEAK_TF32_FLOPS * 1e3:.4f} ms as "
                f"{TF32_PASSES} x TF32 at {PEAK_TF32_FLOPS / 1e12:.0f} "
                f"TFLOP/s, its bytes {simt[2] / PEAK_BYTES_PER_S * 1e3:.4f} "
                f"ms; all at f32 {f32:.4f} ms")


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


def near_ties(fg, args, act, e=None):
    """[N, O] bool: (key, o) whose two largest valid slot products (the
    plain version's, with the edge table ``e`` where given) lie within
    NEAR_TIE of each other, exact ties included; such a key may take
    another winner in the kernel."""
    import torch

    from sir_gcn_tpu_torch.ops.cuda import kernels as K

    plan = fg.dst_plan
    neg = K.NEG
    t1, t2 = [], []
    eq, ek, slot_src, scale, row_key, _, w = args
    for _, _, _, _, m, valid in K.bucket_products(
            eq, ek, slot_src, scale, row_key, w, act, plan.buckets1, e,
            None if e is None else plan.slot_edge):
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
                      timing=None, mask_near_ties=False, e=None, tag="",
                      path=None):
    """The four max kernels against their plain versions, each side's
    win counts and backward against its own forward's maxima, after the
    path of #9-#11 is logged (with ``path``, "first" or "wide", it must be
    that design's). With ``mask_near_ties`` the cotangent is
    zeroed at near-tie (key, o), where the two may pick different winners,
    and win counts are compared elsewhere; without it every count must
    agree. With an edge table ``e`` [E_pad, H] the edge forms #9e-#11e
    run; with centered_relu the slots and rows that hold a near-gate
    (slot, feature) are left out of the g_z and g_eq comparisons and
    counted (the relu may take the other side there). Errors and times go
    under the kernel's name (the edge form's with ``e``) or, with ``tag``
    ("[rowwise]", "[rowwise,wide]", "[edge,rowwise]", "[wide]"), the base
    name plus the tag; #12 is checked and timed in the base form only."""
    import torch

    from sir_gcn_tpu_torch.ops import cuda as K
    from sir_gcn_tpu_torch.ops.cuda.kernels import add_cast

    log_max_layout(label, *w.shape, require=path)
    plan, splan = fg.dst_plan, fg.src_plan
    bd, bs = plan.buckets1, splan.buckets1
    edge = e is not None
    base = not edge and not tag
    args = (eq, ek.to(dtype).contiguous(), fg.dst_slot_srcnode, scale,
            plan.row_key, plan.row_ptr, w)
    et = e.to(dtype).contiguous() if edge else None
    ex = (et, plan.slot_edge) if edge else ()
    kw = dict(e=et, slot_edge=plan.slot_edge) if edge else {}
    fwd_k, count_k, bwd_k = (
        (K.ell_max_fwd_edge, K.ell_max_wincount_edge, K.ell_max_bwd_edge)
        if edge else (K.ell_max_fwd, K.ell_max_wincount, K.ell_max_bwd))
    key = lambda name: (name + tag if tag
                        else f"{name}_edge" if edge else name)

    keep_rows = keep_slots = None
    if act.name == "centered_relu":
        kd = args[1].index_select(0, fg.dst_slot_srcnode)
        if edge:  # the key side's add_cast
            kd = add_cast(kd, et.index_select(0, plan.slot_edge))
        z = kd.float() + eq.index_select(0, plan.slot_key)
        del kd
        slots, rows_near, n_near = near_gates(plan, z, scale, act)
        del z
        keep_rows, keep_slots = ~rows_near, ~slots
        log(f"  {label}: near-gate (slot, feature) {n_near}; left out "
            f"{int(slots.sum())} g_z rows, {int(rows_near.sum())} of "
            f"{rows_near.numel()} rows")

    rows = fwd_k(*args, act, *ex)
    rows_p = K.ell_max_fwd_plain(*args, act, buckets=bd, **kw)
    torch.cuda.synchronize()
    err = {"ell_max_fwd": compare(f"{label} {key('ell_max_fwd')}", rows,
                                  rows_p, FWD_TOL)}
    key_max, key_max_p = (plan.finalize_rows_max(r) for r in (rows, rows_p))
    near = torch.zeros_like(key_max, dtype=torch.bool)
    if mask_near_ties:
        near, _ = near_ties(fg, args, act, et)
    row_near = near.index_select(0, plan.row_key)

    counts = count_k(*args, key_max, act, *ex)
    counts_p = K.ell_max_wincount_plain(*args, key_max_p, act, buckets=bd,
                                        **kw)
    torch.cuda.synchronize()
    differ = counts != counts_p
    bad = int((differ & ~row_near).sum())
    err["ell_max_wincount"] = float(
        torch.where(row_near, 0.0, (counts - counts_p).abs()).max())
    log(f"  {label} {key('ell_max_wincount')}: counts differ at "
        f"{int(differ.sum())} of {counts.numel()} (row, o), {bad} outside "
        f"the {int(near.sum())} near-tie (key, o); max count "
        f"{float(counts.max()):.0f} {'ok' if bad == 0 else 'FAIL'}")
    if bad:
        raise AssertionError(f"{label}: win counts disagree")

    gsc = torch.where(near, 0.0, g).contiguous()
    outs = bwd_k(*args, key_max, gsc, act, *ex)
    outs_p = K.ell_max_bwd_plain(*args, key_max_p, gsc, act, buckets=bd,
                                 **kw)
    torch.cuda.synchronize()
    tols = ((BWD_TOL, keep_rows),
            (BF16_STEP if dtype == torch.bfloat16 else BWD_TOL, keep_slots),
            (GW_TOL, None))
    err["ell_max_bwd"] = max(
        compare(f"{label} {key('ell_max_bwd')}[{i}]", a, b, tol, keep)
        for i, (a, b, (tol, keep)) in enumerate(zip(outs, outs_p, tols)))

    gz = outs[1]
    red_args = (gz, fg.src_slot_from_dst_slot, splan.slot_valid,
                splan.row_ptr)
    if base:
        red = K.ell_scaled_reduce(*red_args)
        red_p = K.ell_scaled_reduce_plain(*red_args, buckets=bs)
        torch.cuda.synchronize()
        err["ell_scaled_reduce"] = compare(f"{label} ell_scaled_reduce",
                                           red, red_p, BWD_TOL)
    for name, x in err.items():
        k = name if name == "ell_scaled_reduce" else key(name)
        errs[k] = max(errs.get(k, 0.0), x)
    if timing is None:
        return

    h, o = w.shape
    valid = int((scale > 0).sum())
    # an edge form also reads the edge table and each slot's edge id
    need = args + ((et, plan.slot_edge) if edge else ())
    runs = {
        "ell_max_fwd": (need, lambda: fwd_k(*args, act, *ex),
                        lambda: K.ell_max_fwd_plain(*args, act, buckets=bd,
                                                    **kw),
                        (rows,), valid * h * o * 2),
        "ell_max_wincount": (
            need + (key_max,),
            lambda: count_k(*args, key_max, act, *ex),
            lambda: K.ell_max_wincount_plain(*args, key_max, act,
                                             buckets=bd, **kw),
            (counts,), valid * h * o * 2),
        "ell_max_bwd": (
            need + (key_max, gsc),
            lambda: bwd_k(*args, key_max, gsc, act, *ex),
            lambda: K.ell_max_bwd_plain(*args, key_max, gsc, act,
                                        buckets=bd, **kw),
            outs, valid * h * o * 6),
    }
    if base:
        src_valid = int((splan.slot_valid > 0).sum())
        # the reduce skips zero-scale slots: it needs only the g_z rows
        # that valid src slots point at, besides every slot's index and
        # scale
        red_need = (src_valid * h * gz.element_size(),) + red_args[1:]
        runs["ell_scaled_reduce"] = (
            red_need, lambda: K.ell_scaled_reduce(*red_args),
            lambda: K.ell_scaled_reduce_plain(*red_args, buckets=bs),
            (red,), src_valid * h * 2)
    for name, (targs, kernel, plain, touts, flops) in runs.items():
        k = name if name == "ell_scaled_reduce" else key(name)
        timing[k] = dict(ms=cuda_ms(kernel, 10),
                         plain_ms=cuda_ms(plain, 3, warmup=1),
                         bound=bound(targs, touts, flops))
        if name != "ell_scaled_reduce":
            # the f32 SIMT bound above, and the bound of the three-pass
            # TF32 product on the tensor cores, which the kernel runs
            f32 = timing[k]["bound"][0]
            timing[k]["bound"] = bound(targs, touts, TF32_PASSES * flops,
                                       PEAK_TF32_FLOPS)
            log(f"  {k}: {timing[k]['ms']:.4f} ms; bound "
                f"{timing[k]['bound'][0]:.4f} ms as {TF32_PASSES} x TF32 "
                f"at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s, {f32:.4f} ms as "
                f"f32 at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s")
    if not base:
        return
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
    library_turns("ell_scaled_reduce", runs["ell_scaled_reduce"][1],
                  lambda: torch.sparse.mm(*lib_in),
                  timing["ell_scaled_reduce"],
                  f"torch.sparse.mm (CSR [{n_src}, {gz.shape[0]}] x "
                  f"{lib_in[1].dtype} [{gz.shape[0]}, {h}])")


def general_case(graph: str, h: int, device):
    """The small cases, with every slot of one multi-slot row of each plan
    at scale 0 besides (a row with no valid slot)."""
    fg, eq, ek, g, sd, ss = small_case(graph, h, device)
    for plan, scale in ((fg.dst_plan, sd), (fg.src_plan, ss)):
        ptr = plan.host["row_ptr"]
        r = int((ptr[1:] - ptr[:-1] > 1).argmax())
        scale[int(ptr[r]):int(ptr[r + 1])] = 0.0
    return fg, eq, ek, g, sd, ss


def near_gates(plan, z, scale, act):
    """(slot flags [S], row flags [R], pairs): the valid slots of ``plan``
    with a feature whose centered_relu gate lies within ``NEAR_GATE`` of 0
    (``ops/cuda/checks.py``: the relu may take the other side on the card,
    which sums the mean in another order), at the slot values z [S, H] f32
    (the plain version's), the rows holding such a slot, and the number of
    such (slot, feature)."""
    from sir_gcn_tpu_torch.ops.cuda.checks import near_gate, slot_rows

    near = near_gate(z, scale, act)
    slots = near.any(1)
    return slots, slot_rows(plan, slots), int(near.sum())


def check_general_kernels(label, fg, eq, ek, g, sd, ss, act, dtype, errs,
                          timing=None, mask_gates=False, require_group=(),
                          names=None, e=None, tag="", require_wide=()):
    """The general route's kernels (#1r, #3, #6 on the dst plan; #4r and
    #5 on the src plan; only ``names`` where given) against their plain
    versions; with an edge table ``e`` [E_pad, H] instead the edge forms
    of #1r, #3 and #4r (#4r·e's g_e in f32 from g_z rounded to the edge
    type); a g_z stored in bf16 at one bf16 step. With ``mask_gates``
    (centered_relu) the rows and slots (and g_e rows) holding a near-gate
    (slot, feature) are left out of the backward comparisons and counted:
    the relu may take the other side there. Each kernel's path is logged;
    those named in ``require_group`` (True: all) must take the lane-group
    path, and those named in ``require_wide`` (True: all) the wide path.
    Where #3 and #6 both take the lane-group path, #6's rows must be #3's
    bits. Errors and times go under the kernel's name plus ``tag``
    ("[gelu]", "[wide]")."""
    import torch

    from sir_gcn_tpu_torch.ops import cuda as K
    from sir_gcn_tpu_torch.ops.cuda.kernels import add_cast

    fwd, bwd = kernel_args(fg, eq, ek, g, sd, ss, act, dtype)
    plan, splan = fg.dst_plan, fg.src_plan
    bd, bs = plan.buckets1, splan.buckets1
    et = None if e is None else e.to(dtype).contiguous()
    keep_d = keep_ds = keep_s = keep_e = None
    if mask_gates and act.name == "centered_relu":
        kd = fwd[1].index_select(0, fg.dst_slot_srcnode)
        ks = bwd[0].index_select(0, fg.src_slot_dstnode)
        if et is not None:  # the gathered side's add_cast
            kd = add_cast(kd, et.index_select(0, plan.slot_edge))
            ks = add_cast(ks, et.index_select(0, splan.slot_edge))
        zd = kd.float() + eq.index_select(0, plan.slot_key)
        del kd
        ds, dr, dn = near_gates(plan, zd, sd, act)
        del zd
        zs = ks.float() + ek.index_select(0, splan.slot_key)
        del ks
        s_slots, sr, sn = near_gates(splan, zs, ss, act)
        del zs
        keep_d, keep_ds, keep_s = ~dr, ~ds, ~sr
        keep_e = ~s_slots.index_select(0, fg.edge2src_slot.long())
        log(f"  {label}: near-gate (slot, feature): {dn} dst, {sn} src; "
            f"left out {int(dr.sum())} of {dr.numel()} dst rows, "
            f"{int(ds.sum())} g_slots rows, {int(sr.sum())} of "
            f"{sr.numel()} src rows")
    gz_tol = BF16_STEP if dtype == torch.bfloat16 else BWD_TOL
    if et is None:
        fbwd = (torch.cat([bwd[0], bwd[1]], 1),) + bwd[2:]
        runs = {
            "ell_act_reduce_rowwise": (
                fwd, lambda: K.ell_act_reduce_rowwise(*fwd),
                lambda: K.ell_act_reduce_plain(*fwd, buckets=bd),
                ((FWD_TOL, None),)),
            "ell_geq_reduce": (
                fwd + (g,), lambda: K.ell_geq_reduce(*fwd, g),
                lambda: K.ell_geq_reduce_plain(*fwd, g, buckets=bd),
                ((BWD_TOL, keep_d),)),
            "ell_act_reduce_bwd": (
                fwd + (g,),
                lambda: K.ell_act_reduce_bwd(*fwd, g, gz_dtype=dtype),
                lambda: K.ell_act_reduce_bwd_plain(*fwd, g, dtype,
                                                   buckets=bd),
                ((gz_tol, keep_ds), (BWD_TOL, keep_d))),
            "ell_src_bwd_rowwise": (
                bwd, lambda: K.ell_src_bwd_rowwise(*bwd),
                lambda: K.ell_src_bwd_plain(*bwd, buckets=bs),
                ((BWD_TOL, keep_s),)),
            "ell_src_bwd_fused": (
                fbwd, lambda: K.ell_src_bwd_fused(*fbwd),
                lambda: K.ell_src_bwd_fused_plain(*fbwd, buckets=bs),
                ((BWD_TOL, keep_s),)),
        }
    else:
        fe = (et, plan.slot_edge)
        be = (et, splan.slot_edge, fg.edge2src_slot, fg.edge_mask)
        runs = {
            "ell_act_reduce_rowwise_edge": (
                fwd + (et,), lambda: K.ell_act_reduce_rowwise_edge(*fwd, *fe),
                lambda: K.ell_act_reduce_plain(*fwd, buckets=bd, e=et,
                                               slot_edge=plan.slot_edge),
                ((FWD_TOL, None),)),
            "ell_geq_reduce_edge": (
                fwd + (g, et), lambda: K.ell_geq_reduce_edge(*fwd, g, *fe),
                lambda: K.ell_geq_reduce_plain(*fwd, g, buckets=bd, e=et,
                                               slot_edge=plan.slot_edge),
                ((BWD_TOL, keep_d),)),
            "ell_src_bwd_rowwise_edge": (
                bwd + (et,), lambda: K.ell_src_bwd_rowwise_edge(*bwd, *be),
                lambda: K.ell_src_bwd_plain(
                    *bwd, buckets=bs, e=et, slot_edge=splan.slot_edge,
                    edge2slot=fg.edge2src_slot, edge_mask=fg.edge_mask),
                ((BWD_TOL, keep_s), (gz_tol, keep_e))),
        }
    if names is not None:
        runs = {k: v for k, v in runs.items() if k in names}
    outs, lays = {}, {}
    for name, (_, kernel, plain, tols) in runs.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for i, (a, b, (tol, keep)) in enumerate(zip(got, want, tols)):
            err = compare(f"{label} {name}[{i}]", a, b, tol, keep)
            errs[name + tag] = max(errs.get(name + tag, 0.0), err)
        outs[name] = got
        del want
        lays[name] = log_general_layout(
            label, name, runs[name][0], got,
            require_group=require_group is True or name in require_group,
            require_wide=require_wide is True or name in require_wide)
    if (isinstance(lays.get("ell_geq_reduce"), K.GeneralLayout)
            and isinstance(lays.get("ell_act_reduce_bwd"), K.GeneralLayout)):
        if not torch.equal(outs["ell_act_reduce_bwd"][1],
                           outs["ell_geq_reduce"][0]):
            raise AssertionError(f"{label}: #6's rows are not #3's bits")
        log(f"  {label}: #6's rows are #3's bits")
    if timing is None:
        return
    valid_d, valid_s = int((sd != 0).sum()), int((ss != 0).sum())
    h = eq.shape[1]
    for name, (args, kernel, plain, _) in runs.items():
        src = name.startswith("ell_src_bwd")
        # what each edge form reads besides its node tables: its slots'
        # edge ids (the plain version of #4r·e's g_e also reads edge2slot
        # and edge_mask, which the kernel does not)
        need = args + ((splan.slot_edge if src else plan.slot_edge,)
                       if et is not None else ())
        timing[name + tag] = dict(
            ms=cuda_ms(kernel, 20), plain_ms=cuda_ms(plain, 3, warmup=1),
            bound=bound(need, outs[name],
                        (valid_s if src else valid_d) * h * KERNELS[name][2]))


def phase_kernels(device):
    import numpy as np
    import torch

    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.train import (
        build_arxiv_graph,
        get_args,
    )
    from sir_gcn_tpu_torch.ops.ell import (
        centered_relu,
        gelu,
        leaky_relu,
        slot_scale,
        softmax,
        tanh,
    )

    log("== kernels")
    errs, gelu_errs = {}, {}  # gelu_errs: the erf-GELU forms'
    acts = (leaky_relu(0.2), tanh, gelu())
    errs_for = lambda act: gelu_errs if act.name == "gelu" else errs
    dtypes = (torch.float32, torch.bfloat16)
    general_acts = (centered_relu(0.5), softmax,
                    dataclasses.replace(tanh, sir_elementwise=False),
                    dataclasses.replace(gelu(), sir_elementwise=False))
    # the general route's forms: erf-GELU's errors and times under
    # "<name>[gelu]", the wide path's under "<name>[wide]"
    gelu_tag = lambda act: "[gelu]" if act.name == "gelu" else ""
    for graph, h in (("hub", 24), ("random", 96), ("random", 200),
                     ("random", 20), ("random", 128), ("isolated", 96)):
        case = small_case(graph, h, device)
        for act in acts:
            for dtype in dtypes:
                check_kernels(f"{graph} H={h} {act.name} {dtype}", *case,
                              act, dtype, errs_for(act))
    for graph, h, de in (("hub", 24, 5), ("random", 96, 16),
                         ("isolated", 200, 16), ("isolated", 24, 16),
                         ("random", 200, 5), ("random", 20, 5),
                         ("random", 128, 16)):
        case = small_case(graph, h, device)
        tables = edge_tables(case[0], h, de, seed=h + de)
        log(f"  {graph} H={h} De={de}: rows {case[0].dst_plan.num_rows} "
            f"(dst) {case[0].src_plan.num_rows} (src)")
        for act in acts:
            for dtype in dtypes:
                check_edge_kernels(f"{graph} H={h} De={de} {act.name} "
                                   f"{dtype}", *case, *tables, act, dtype,
                                   errs_for(act))
    # past a block's shared memory: #7 and #8 on their columns path
    for h, de, paths in LARGE_DE:
        case = small_case("random", h, device)
        tables = edge_tables(case[0], h, de, seed=h + de)
        for act in acts:
            for dtype in dtypes:
                check_edge_kernels(f"random H={h} De={de} {act.name} "
                                   f"{dtype}", *case, *tables, act, dtype,
                                   errs_for(act), edge_paths=paths)
    # (200, 200) and the last three on the wide path
    for graph, h, o in (("hub", 24, 40), ("random", 96, 96),
                        ("random", 200, 200), ("ties", 32, 24),
                        ("random", 36, 100), ("hub", 512, 512),
                        ("ties", 264, 600), ("random", 512, 200)):
        case = max_case(graph, h, o, device)
        for act in acts:
            for dtype in dtypes:
                check_max_kernels(f"{graph} H={h} O={o} {act.name} {dtype}",
                                  *case, act, dtype, errs_for(act))
    # the max kernels' new forms: the edge forms with elementwise sigmas,
    # the row-wise forms (past H = 256 "[rowwise,wide]") and both at once
    for graph, h, o in (("hub", 24, 40), ("random", 96, 96),
                        ("random", 200, 200), ("ties", 32, 24),
                        ("random", 36, 100), ("hub", 300, 24),
                        ("random", 512, 512), ("isolated", 520, 40)):
        case = max_case(graph, h, o, device)
        e = edge_tables(case[0], h, 1, seed=h + o)[0]
        wide = ",wide" if h > 256 else ""
        for dtype in dtypes:
            label = f"{graph} H={h} O={o}"
            for act in (leaky_relu(0.2), gelu()):
                check_max_kernels(f"{label} {act.name} {dtype} edge",
                                  *case, act, dtype, errs, e=e)
            check_max_kernels(f"{label} centered_relu {dtype} edge",
                              *case, centered_relu(0.5), dtype, errs, e=e,
                              tag="[edge,rowwise]")
            for act in (centered_relu(0.5), softmax):
                check_max_kernels(f"{label} {act.name} {dtype}", *case, act,
                                  dtype, errs, tag=f"[rowwise{wide}]")
    for graph, h in (("hub", 24), ("random", 96), ("isolated", 200),
                     ("random", 20)):
        case = general_case(graph, h, device)
        e = edge_tables(case[0], h, 1, seed=h)[0]
        for act in general_acts:
            for dtype in dtypes:
                label = f"{graph} H={h} {act.name} {dtype}"
                check_general_kernels(label, *case, act, dtype, errs,
                                      tag=gelu_tag(act))
                check_general_kernels(f"{label} edge", *case, act, dtype,
                                      errs, e=e)
    # a row-wise sigma past H = 256, rows whole 16-byte chunks (512, 520;
    # 300 in f32) or not (300 in bf16): #1r and #4r (and their edge forms)
    # on full-warp lane groups up to 512 on whole chunks, the rest on the
    # wide path; the edge forms beside
    for graph, h in (("hub", 300), ("random", 512), ("isolated", 520)):
        case = general_case(graph, h, device)
        e = edge_tables(case[0], h, 1, seed=h)[0]
        for act in general_acts[:2]:
            for dtype in dtypes:
                label = f"{graph} H={h} {act.name} {dtype}"
                check_general_kernels(label, *case, act, dtype, errs,
                                      tag="[wide]", **wide_paths(h, dtype))
                check_general_kernels(f"{label} edge", *case, act, dtype,
                                      errs, e=e, **wide_paths(h, dtype))

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
    fused_timing = {}  # #5 with the elementwise sigmas, bf16
    forced_gelu = dataclasses.replace(gelu(), sir_elementwise=False)
    for dtype in dtypes:
        keep = timing if dtype == torch.bfloat16 else None
        check_kernels(f"arxiv {dtype}", fg, eq, ek, g, sd, ss,
                      leaky_relu(0.2), dtype, errs, timing=keep,
                      require_vector=True)
        check_edge_kernels(f"arxiv {dtype}", fg, eq, ek, g, sd, ss, *tables,
                           leaky_relu(0.2), dtype, errs, timing=keep,
                           require_vector=True)
        check_max_kernels(f"arxiv {dtype}", fg, eq, ek, w, g,
                          fg.dst_slot_scales["sum"], leaky_relu(0.2), dtype,
                          errs, timing=keep, mask_near_ties=True,
                          path="first")
        # the max kernels' new forms (timed in bf16): the edge form with
        # the sireconv_max phase's sigma and edge table, the row-wise form
        # with centered_relu (softmax beside it), and both at once
        check_max_kernels(f"arxiv {dtype} edge", fg, eq, ek, w, g,
                          fg.dst_slot_scales["sum"], leaky_relu(0.2), dtype,
                          errs, timing=keep, mask_near_ties=True,
                          e=tables[0])
        check_max_kernels(f"arxiv {dtype} centered_relu", fg, eq, ek, w, g,
                          fg.dst_slot_scales["sum"], centered_relu(0.5),
                          dtype, errs, timing=keep, mask_near_ties=True,
                          tag="[rowwise]")
        check_max_kernels(f"arxiv {dtype} softmax", fg, eq, ek, w, g,
                          fg.dst_slot_scales["sum"], softmax, dtype, errs,
                          mask_near_ties=True, tag="[rowwise]")
        check_max_kernels(f"arxiv {dtype} centered_relu edge", fg, eq, ek, w,
                          g, fg.dst_slot_scales["sum"], centered_relu(0.5),
                          dtype, errs, timing=keep, mask_near_ties=True,
                          e=tables[0], tag="[edge,rowwise]")
        check_general_kernels(f"arxiv {dtype} centered_relu", fg, eq, ek, g,
                              sd, ss, centered_relu(0.5), dtype, errs,
                              timing=keep, mask_gates=True,
                              require_group=True)
        check_general_kernels(f"arxiv {dtype} softmax", fg, eq, ek, g, sd,
                              ss, softmax, dtype, errs, require_group=True)
        # the edge forms (#1r·e, #3e, #4r·e) at the general_edge phase's
        # plan, H and sigma (timed in bf16), and with softmax
        check_general_kernels(f"arxiv {dtype} centered_relu edge", fg, eq,
                              ek, g, sd, ss, centered_relu(0.5), dtype, errs,
                              timing=keep, mask_gates=True,
                              require_group=True, e=tables[0])
        check_general_kernels(f"arxiv {dtype} softmax edge", fg, eq, ek, g,
                              sd, ss, softmax, dtype, errs,
                              require_group=True, e=tables[0])
        # erf-GELU declared non-elementwise on all five (#1r, #3, #4r and
        # #6 on the first design, #5 on its lane-group path), timed in bf16
        check_general_kernels(f"arxiv {dtype} gelu", fg, eq, ek, g, sd, ss,
                              forced_gelu, dtype, errs, timing=keep,
                              require_group=("ell_src_bwd_fused",),
                              tag="[gelu]")
        # #5 on its lane-group path for the elementwise sigmas too:
        # leaky_relu(0.2) is the arxiv SIRModel's, which JAX's fused
        # backward runs (the elementwise route, padded to 128 lanes); #6
        # beside it, its path logged (its first design there)
        for act in acts[:2]:
            check_general_kernels(
                f"arxiv {dtype} {act.name}", fg, eq, ek, g, sd, ss, act,
                dtype, errs, require_group=("ell_src_bwd_fused",),
                names=("ell_src_bwd_fused", "ell_act_reduce_bwd"),
                timing=fused_timing.setdefault(act.name, {}) if keep
                is not None else None)
    # #1, #2 and #4 on DropEdge's dynamic scales at the arxiv plan: a
    # numpy mask at rate 0.2 zeroes slots in the middle of rows
    mask = torch.from_numpy(np.random.default_rng(5).random(fg.e_pad)
                            >= 0.2).to(device)
    dsd, dss = (slot_scale(fg, side, "sym", mask) for side in ("dst", "src"))
    dyn_timing = {}
    for dtype in dtypes:
        check_kernels(f"arxiv {dtype} dropedge", fg, eq, ek, g, dsd, dss,
                      leaky_relu(0.2), dtype, errs, require_vector=True,
                      timing=dyn_timing if dtype == torch.bfloat16 else None)
    for name, t in dyn_timing.items():
        log(f"  {name} (bf16 edges, dynamic scales): {t['ms']:.4f} ms "
            f"against {timing[name]['ms']:.4f} ms on the static ones "
            f"({100 * (t['ms'] / timing[name]['ms'] - 1):+.1f}%)")
    del mask, dsd, dss
    # erf-GELU at the arxiv plan in f32 and bf16, the bf16 forms timed
    gelu_timing = {}
    for dtype in dtypes:
        keep = gelu_timing if dtype == torch.bfloat16 else None
        check_kernels(f"arxiv {dtype} gelu", fg, eq, ek, g, sd, ss, gelu(),
                      dtype, gelu_errs, timing=keep,
                      require_vector=True)
        check_edge_kernels(f"arxiv {dtype} gelu", fg, eq, ek, g, sd, ss,
                           *tables, gelu(), dtype, gelu_errs,
                           timing=keep, require_vector=True)
        check_max_kernels(f"arxiv {dtype} gelu", fg, eq, ek, w, g,
                          fg.dst_slot_scales["sum"], gelu(), dtype,
                          gelu_errs, timing=keep,
                          mask_near_ties=True)
    for name, t in gelu_timing.items():
        if name in GELU:
            log(f"  {name} (bf16 edges) gelu {t['ms']:.4f} ms against "
                f"leaky_relu {timing[name]['ms']:.4f} ms "
                f"({100 * (t['ms'] / timing[name]['ms'] - 1):+.1f}%), plain "
                f"{t['plain_ms']:.3f} ms")
    for name, t in timing.items():
        b_ms, by, nbytes, flops = t["bound"]
        log(f"  {name} (bf16 edges): {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.3f} ms, bound {b_ms:.4f} ms by {by} "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
            f"{100 * b_ms / t['ms']:.1f}% of bound")
    for act_name, ts in fused_timing.items():
        for name, t in ts.items():
            log(f"  {name} ({act_name}, bf16 edges): {t['ms']:.4f} ms, "
                f"plain {t['plain_ms']:.3f} ms, bound {t['bound'][0]:.4f} "
                f"ms, {100 * t['bound'][0] / t['ms']:.1f}% of bound")
    del eq, ek, g, w, tables
    hetero_kernels(device, errs, gelu_errs, timing)
    roman_kernels(device, errs, timing)
    wide_kernels(device, fg, errs, timing)
    wide_edge_kernels(device, fg, errs, timing)
    timing.update({f"{k}[gelu]": v for k, v in gelu_timing.items()
                   if k in GELU})
    errs.update({f"{k}[gelu]": v for k, v in gelu_errs.items() if k in GELU})
    return errs, timing, fg


def wide_paths(h: int, dtype) -> dict:
    """``check_general_kernels``' path requirements past H = 256: #1r, #3
    and #4r (and their edge forms) on the lane-group path up to 512 on
    whole 16-byte chunks, every other kernel on the wide path."""
    group = FULL_WARP if h <= 512 and h * dtype.itemsize % 16 == 0 else ()
    return dict(require_group=group, require_wide=tuple(
        k for k in GENERAL + BWD + tuple(GENERAL_EDGE) if k not in group))


def wide_kernels(device, fg, errs, timing):
    """The general route's five kernels at the arxiv plan, H = WIDE_H (the
    general_wide phase's), bf16 edges, each against its plain version
    (#1r, #3, #4r and #5 on full-warp lane groups, #6 on the wide path):
    centered_relu(0.5), near gates masked, timed under "<name>[wide]"; then
    softmax, #1r, #3 and #4r (``WIDE_SOFTMAX``) timed under
    "<name>[wide,softmax]"."""
    import torch

    from sir_gcn_tpu_torch.ops.ell import centered_relu, softmax

    h = WIDE_H
    gen = torch.Generator(device=device).manual_seed(5)
    eq, ek, g = (torch.randn((fg.n_pad, h), generator=gen, device=device)
                 for _ in range(3))
    sd, ss = fg.dst_slot_scales["sym"], fg.src_slot_scales["sym"]
    log(f"  arxiv plan at H {h}: full-warp lane groups and the wide path")
    paths = wide_paths(h, torch.bfloat16)
    check_general_kernels(f"arxiv H={h} bf16 centered_relu", fg, eq, ek, g,
                          sd, ss, centered_relu(0.5), torch.bfloat16, errs,
                          timing=timing, mask_gates=True, tag="[wide]",
                          **paths)
    soft_errs, soft_timing = {}, {}
    check_general_kernels(f"arxiv H={h} bf16 softmax", fg, eq, ek, g, sd, ss,
                          softmax, torch.bfloat16, soft_errs,
                          timing=soft_timing, tag="[wide,softmax]", **paths)
    for name in GENERAL_FORMS:  # every kernel held, WIDE_SOFTMAX's rows kept
        errs[f"{name}[wide]"] = max(errs[f"{name}[wide]"],
                                    soft_errs[f"{name}[wide,softmax]"])
    for name in WIDE_SOFTMAX:
        key = f"{name}[wide,softmax]"
        errs[key], timing[key] = soft_errs[key], soft_timing[key]
    for name in GENERAL_FORMS:
        t = timing[f"{name}[wide]"]
        path = "lane groups" if name in FULL_WARP else "wide path"
        log(f"  {name} at H={h} (bf16, {path}): {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound'][0]:.4f} ms by "
            f"{t['bound'][1]} ({t['bound'][2] / 1e6:.1f} MB), "
            f"{100 * t['bound'][0] / t['ms']:.1f}% of bound")
    for name in WIDE_SOFTMAX:
        t = timing[f"{name}[wide,softmax]"]
        log(f"  {name} at H={h} (bf16, softmax, lane groups): "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, "
            f"{100 * t['bound'][0] / t['ms']:.1f}% of bound")
    del eq, ek, g
    torch.cuda.empty_cache()


def wide_edge_kernels(device, fg, errs, timing):
    """#7 and #8 at the arxiv plan, H = WIDE_H, De = EDGE_DIM (the
    sireconv_wide phase's), bf16 edges, leaky_relu(0.2), against their
    plain versions, on the paths WIDE_EDGE_PATHS, timed under
    "<name>[wide]" and logged beside their bound and their no-L2-reuse
    estimate (``ell_ab.edge_no_reuse_estimate``: each valid slot's rows
    from device memory once)."""
    import torch

    from sir_gcn_tpu_torch.ops.ell import leaky_relu
    from sir_gcn_tpu_torch.tools.ell_ab import edge_no_reuse_estimate

    h = WIDE_H
    gen = torch.Generator(device=device).manual_seed(7)
    eq, ek, g = (torch.randn((fg.n_pad, h), generator=gen, device=device)
                 for _ in range(3))
    eb = torch.randn((fg.e_pad, EDGE_DIM), generator=gen, device=device)
    we = 0.3 * torch.randn((EDGE_DIM, h), generator=gen, device=device)
    log(f"  arxiv plan at H {h}, De {EDGE_DIM}: #7 and #8")
    check_edge_kernels(f"arxiv H={h} bf16", fg, eq, ek, g,
                       fg.dst_slot_scales["sym"], fg.src_slot_scales["sym"],
                       None, eb, we, leaky_relu(0.2), torch.bfloat16, errs,
                       timing=timing, edge_paths=WIDE_EDGE_PATHS,
                       fused_only=True, tag="[wide]")
    for name, side in (("ell_edge_act_reduce2", "fwd"),
                       ("ell_edge_src_bwd", "bwd")):
        t = timing[f"{name}[wide]"]
        est, gb = edge_no_reuse_estimate(dict(fg=fg, eq=eq), EDGE_DIM,
                                         torch.bfloat16, side)
        log(f"  {name} at H={h} (bf16): {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound'][0]:.4f} ms by "
            f"{t['bound'][1]} ({t['bound'][3] / 1e9:.2f} GFLOP), "
            f"{100 * t['bound'][0] / t['ms']:.1f}% of bound; no-L2-reuse "
            f"estimate {est:.4f} ms ({gb:.3f} GB), {100 * est / t['ms']:.1f}"
            f"% of it")
    del eq, ek, g, eb, we
    torch.cuda.empty_cache()


def hetero_kernels(device, errs, gelu_errs, timing):
    """The kernels with an erf-GELU form at H = O = 512 on a plan of the
    heterophilous minesweeper's size (its synthetic stand-in, no self
    loops): #1, #2 and #4 and their edge forms, #7 and #8 (De = EDGE_DIM:
    #7 on the register path's blocks of columns, #8 on its tiles path,
    required), #9-#12
    with near ties masked as at the arxiv plan, in f32 and bf16; erf-GELU against its plain versions,
    and leaky_relu(0.2) beside it, each timed (bf16) and logged with its
    path. Then #9-#11's row-wise forms there: centered_relu in bf16 (near
    ties and gates masked), timed into ``timing`` as "[rowwise,wide]",
    and softmax in f32."""
    import torch

    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.heterophilous import train as het
    from sir_gcn_tpu_torch.ops.ell import (
        centered_relu,
        gelu,
        leaky_relu,
        softmax,
    )

    h = HETERO_H
    args = het._parser().parse_args([
        "--dataset", "minesweeper", "--synthetic-nodes", str(HETERO_NODES),
        "--synthetic-edges", str(HETERO_EDGES)])
    fg = het.prepare(args, 0, 0, device)["graph"]
    gen = torch.Generator(device=device).manual_seed(4)
    eq, ek, g = (torch.randn((fg.n_pad, h), generator=gen, device=device)
                 for _ in range(3))
    sd, ss = fg.dst_slot_scales["mean"], fg.src_slot_scales["mean"]
    w = (torch.rand((h, h), generator=gen, device=device) * 2 - 1) / h**0.5
    tables = edge_tables(fg, h, EDGE_DIM, seed=4)
    log(f"  heterophilous plan (minesweeper's size): N {fg.n_pad}, E_pad "
        f"{fg.e_pad}, S_dst {fg.dst_plan.num_slots}, S_src "
        f"{fg.src_plan.num_slots}, R1 {fg.dst_plan.num_rows}, H {h}, O {h}, "
        f"De {EDGE_DIM}, stage 2 {fg.dst_plan.s2_gather is not None}")
    log_max_layout("heterophilous", h, h, require="wide")
    times = {}
    for act in (gelu(), leaky_relu(0.2)):
        tag = act.name
        for dtype in (torch.float32, torch.bfloat16):
            keep = (times.setdefault(tag, {}) if dtype == torch.bfloat16
                    else None)
            label = f"H={h} {dtype} {tag}"
            e = gelu_errs if tag == "gelu" else errs
            check_kernels(label, fg, eq, ek, g, sd, ss, act, dtype, e,
                          timing=keep, require_vector=True)
            check_edge_kernels(label, fg, eq, ek, g, sd, ss, *tables, act,
                               dtype, e, timing=keep,
                               edge_paths=WIDE_EDGE_PATHS)
            check_max_kernels(label, fg, eq, ek, w, g,
                              fg.dst_slot_scales["sum"], act, dtype, e,
                              timing=keep, mask_near_ties=True, path="wide")
    for name in GELU:
        t, lr = times["gelu"][name], times["leaky_relu"][name]
        log(f"  {name} at H={h} (bf16): gelu {t['ms']:.4f} ms against "
            f"leaky_relu {lr['ms']:.4f} ms "
            f"({100 * (t['ms'] / lr['ms'] - 1):+.1f}%), plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound'][0]:.4f} ms by "
            f"{t['bound'][1]}, {100 * t['bound'][0] / t['ms']:.1f}% of bound")
    for act, dtype, keep in ((centered_relu(0.5), torch.bfloat16, timing),
                             (softmax, torch.float32, None)):
        check_max_kernels(f"H={h} {dtype} {act.name}", fg, eq, ek, w, g,
                          fg.dst_slot_scales["sum"], act, dtype, errs,
                          timing=keep, mask_near_ties=True,
                          tag="[rowwise,wide]", path="wide")
    for name in MAX[:3]:
        t, lr = timing[f"{name}[rowwise,wide]"], times["leaky_relu"][name]
        log(f"  {name} at H={h} (bf16): centered_relu {t['ms']:.4f} ms "
            f"against leaky_relu {lr['ms']:.4f} ms "
            f"({100 * (t['ms'] / lr['ms'] - 1):+.1f}%), plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound'][0]:.4f} ms, "
            f"{100 * t['bound'][0] / t['ms']:.1f}% of bound")
    del eq, ek, g, w, tables


def roman_kernels(device, errs, timing):
    """#9-#11 on the wide path (required) at H = O = 512 on a plan of
    roman-empire's size (the fullgraph phase's (b): 22,662 nodes, 65,854
    edges) with erf-GELU, its sigma, against their plain versions, near
    ties masked: bf16 timed into ``timing`` as "<name>[wide]", f32
    beside."""
    import torch

    from sir_gcn_tpu_torch.experiments.heterophilous import train as het
    from sir_gcn_tpu_torch.ops.ell import gelu

    h = HETERO_H
    args = het._parser().parse_args(["--dataset", "roman-empire",
                                     *ROMAN_EMPIRE])
    fg = het.prepare(args, 0, 0, device)["graph"]
    gen = torch.Generator(device=device).manual_seed(6)
    eq, ek, g = (torch.randn((fg.n_pad, h), generator=gen, device=device)
                 for _ in range(3))
    w = (torch.rand((h, h), generator=gen, device=device) * 2 - 1) / h**0.5
    log(f"  roman-empire's plan: N {fg.n_pad}, S_dst "
        f"{fg.dst_plan.num_slots}, R1 {fg.dst_plan.num_rows}, valid slots "
        f"{int((fg.dst_slot_scales['sum'] > 0).sum())}, H {h}, O {h}")
    for dtype in (torch.bfloat16, torch.float32):
        check_max_kernels(f"roman-empire H={h} {dtype} gelu", fg, eq, ek, w,
                          g, fg.dst_slot_scales["sum"], gelu(), dtype, errs,
                          timing=timing if dtype == torch.bfloat16 else None,
                          mask_near_ties=True, tag="[wide]", path="wide")
    for name in MAX[:3]:
        t = timing[f"{name}[wide]"]
        log(f"  {name} at H={h} on roman-empire's plan (bf16, gelu, wide "
            f"path): {t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, bound "
            f"{t['bound'][0]:.4f} ms, "
            f"{100 * t['bound'][0] / t['ms']:.1f}% of bound")
    del eq, ek, g, w, fg
    torch.cuda.empty_cache()


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


def phase_train(agg: str, extra=(), label: str = ""):
    """The arxiv trainer at full width with ``agg`` (and the ``extra``
    flags), the launch counters set to 0 before and read after; the
    launches must be those of ``agg``'s steps and evals. Returns the
    launches and the run's steady step, eval times and peak memory."""
    import numpy as np
    import torch

    from sir_gcn_tpu_torch.experiments.ogbn_arxiv import train
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts

    flags = flags_for(agg) + list(extra)
    log(f"== {label or 'train'}: " + " ".join(flags))
    if agg == "max":  # W_R of each layer is [nhidden, nhidden]
        h = int(flags[flags.index("--nhidden") + 1])
        log_max_layout("train max", h, h, require="first")
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
    steady = 1e3 * float(np.median(result["step_seconds"][1:]))
    log(f"  train step ms {ms('step_seconds')}, eval ms "
        f"{ms('eval_seconds')}")
    log(f"  steady step (median of steps 2..{steps}) {steady:.3f} ms, "
        f"peak memory {peak / 2**30:.3f} GiB")
    log(f"  losses {result['train_losses']}, launches {launches}")
    if not all(math.isfinite(x) for x in result["train_losses"]):
        raise AssertionError("non-finite training loss")
    want = expected_launches(agg, steps)
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    return launches, dict(step_ms=steady, eval_ms=ms("eval_seconds"),
                          peak_gib=peak / 2**30)


def phase_dropedge(sym: dict):
    """The train phase's sym configuration with ``--edge-dropout 0.2``:
    each layer's step draws a DropEdge mask and runs #2 and #4 on dynamic
    slot scales, the eval keeps the static ones, so the launches are
    exactly the sym phase's. Runs dropedge twice and sym once more, so
    that with the sym phase's run (``sym``) and the max phase's the order
    is sym, max, dropedge, dropedge, sym, and logs the mean steady step, eval and peak memory of
    each beside the other's."""
    drop = [phase_train("sym", ["--edge-dropout", "0.2"],
                        label=f"dropedge {i + 1} of 2")[1] for i in range(2)]
    syms = [sym, phase_train("sym", label="sym again")[1]]
    mean = lambda runs, k: statistics.fmean(r[k] for r in runs)
    step_d, step_s = mean(drop, "step_ms"), mean(syms, "step_ms")
    peak_d, peak_s = mean(drop, "peak_gib"), mean(syms, "peak_gib")
    gap = step_d - step_s
    log(f"  dropedge against sym (sym, max, dropedge, dropedge, sym): step "
        f"{[round(r['step_ms'], 3) for r in drop]} against "
        f"{[round(r['step_ms'], 3) for r in syms]} ms, means {step_d:.3f} "
        f"against {step_s:.3f} ms ({gap:+.3f} ms, {100 * gap / step_s:+.1f}%)"
        f", eval {[r['eval_ms'] for r in drop]} against "
        f"{[r['eval_ms'] for r in syms]} ms, peak {peak_d:.3f} against "
        f"{peak_s:.3f} GiB ({peak_d - peak_s:+.3f})")


# bench_torch.run settings of the bench phase: (tag, --graph, --reorder,
# --edge-features); each runs a first block and BENCH_WINDOWS timed blocks
BENCH_RUNS = (("a", "random", False, False), ("b", "powerlaw", True, False),
              ("c", "community", False, False), ("d", "random", False, True))
BENCH_WINDOWS = 2


def bench_aggregate(label, fg, errs, h: int = 96):
    """One sym aggregate at ``fg``'s plan (bf16 edges, leaky_relu(0.2), H =
    ``h``): the output and both gradients through the kernels (#2, #4;
    ``ell_sir_aggregate``) against the same aggregate composed of their
    plain versions on the card, stage 2 and key lookup included."""
    import torch

    from sir_gcn_tpu_torch.ops import cuda as K
    from sir_gcn_tpu_torch.ops.ell import ell_sir_aggregate, leaky_relu

    act, dtype, dev = leaky_relu(0.2), torch.bfloat16, fg.graph.device
    gen = torch.Generator(device=dev).manual_seed(1)
    eq, ek, g = (torch.randn((fg.n_pad, h), generator=gen, device=dev)
                 for _ in range(3))
    eq_k, ek_k = eq.clone().requires_grad_(), ek.clone().requires_grad_()
    out = ell_sir_aggregate(fg, eq_k, ek_k, act, "sym", edge_dtype=dtype)
    out.backward(g)
    fwd, bwd = kernel_args(fg, eq, ek, g, fg.dst_slot_scales["sym"],
                           fg.src_slot_scales["sym"], act, dtype)
    rows, srows = K.ell_act_reduce_plain(*fwd, buckets=fg.dst_plan.buckets1,
                                         derivative=True)
    want = {
        "out": (out, fg.dst_plan.finalize_rows_sum(rows), FWD_TOL),
        "g_eq": (eq_k.grad, g * fg.dst_plan.finalize_rows_sum(srows),
                 BWD_TOL),
        "g_ek": (ek_k.grad, fg.src_plan.finalize_rows_sum(
            K.ell_src_bwd_plain(*bwd, buckets=fg.src_plan.buckets1)),
            BWD_TOL),
    }
    for name, (got, ref, tol) in want.items():
        err = compare(f"{label} aggregate {name}", got.detach(), ref, tol)
        kernel = "ell_act_reduce2" if name == "out" else "ell_src_bwd"
        errs[kernel] = max(errs.get(kernel, 0.0), err)


def phase_bench(device, errs):
    """``bench_torch.run`` in-process at full size for each of BENCH_RUNS,
    with the launch counters set to 0 before and read after each run; each
    record printed on its own line. Every loss finite and the launches
    exact (3 of #2 and #4, or of #7 and #8, per step); the profile of each
    lane's step; on (b)'s powerlaw plan a stage 2 in both plans, the
    aggregate through #2 and #4 against their plain versions, and #1, #2
    and #4 against theirs with times beside (a)'s random plan; a second
    build of (d)'s graph a memo hit."""
    import numpy as np
    import torch

    import bench_torch
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.ops.ell import (
        MAX_BUDGET,
        build_fast_graph,
        last_build_memo_hit,
        leaky_relu,
    )
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import make_adamw

    plans, steps = {}, bench_torch.STEPS * (1 + BENCH_WINDOWS)
    for tag, graph, reorder, edge in BENCH_RUNS:
        log(f"== bench ({tag}): --graph {graph}"
            + (" --reorder" if reorder else "")
            + (" --edge-features" if edge else "")
            + f" --windows {BENCH_WINDOWS}")
        details = {}
        torch.cuda.synchronize()
        reset_launch_counts()
        record = bench_torch.run(graph, reorder, edge, BENCH_WINDOWS, device,
                                 details=details)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        print(json.dumps(record), flush=True)
        fg = details["fg"]
        log(f"  ({tag}) plan {record['plan_seconds']:.3f}s, kernel build "
            f"{details['build_seconds']:.1f}s, first block "
            f"{details['first_block_seconds']:.3f}s, windows ms "
            f"{details['window_ms']}, peak memory "
            f"{details['peak_memory_bytes'] / 2**30:.3f} GiB, stage 2 dst "
            f"{fg.dst_plan.buckets2 is not None} src "
            f"{fg.src_plan.buckets2 is not None}, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if not all(math.isfinite(x) for x in details["losses"]):
            raise AssertionError(f"bench ({tag}): non-finite loss "
                                 f"{details['losses']}")
        pair = (("ell_edge_act_reduce2", "ell_edge_src_bwd") if edge
                else ("ell_act_reduce2", "ell_src_bwd"))
        want = dict.fromkeys(KERNELS, 0)
        want.update(dict.fromkeys(pair, 3 * steps))
        if launches != want:
            raise AssertionError(f"bench ({tag}): launch counts {launches}, "
                                 f"expected {want}")
        log(f"== profile bench ({tag})")
        set_edge_dtype(torch.bfloat16)
        model = bench_torch.make_model(
            edge, generator=torch.Generator().manual_seed(0)).to(device)
        opt = make_adamw(model.parameters(), 1e-2, 1e-3)
        inputs = bench_torch.bench_inputs(np.random.default_rng(1), fg, edge,
                                          device)
        gen = torch.Generator(device=device).manual_seed(0)
        profile_steps(lambda: bench_torch.train_step(model, opt, fg, *inputs,
                                                     gen), 3)
        set_edge_dtype(None)
        del model, opt, inputs
        if tag in ("a", "b"):
            plans[tag] = fg
    t0 = time.perf_counter()
    build_fast_graph(fg.graph)
    log(f"  a second build of ({tag})'s graph: memo hit "
        f"{last_build_memo_hit()}, {time.perf_counter() - t0:.3f}s")
    if not last_build_memo_hit():
        raise AssertionError("the same graph built twice missed the memo")

    fg = plans["b"]
    if fg.dst_plan.buckets2 is None or fg.src_plan.buckets2 is None:
        raise AssertionError("the powerlaw plans have no stage 2")
    hubs = {}
    for side, deg in (("dst", "in_deg"), ("src", "out_deg")):
        deg = fg.graph.host[deg]
        big = deg[deg > MAX_BUDGET]
        hubs[side] = (f"{len(big)} keys above {MAX_BUDGET} in "
                      f"{int(np.ceil(big / MAX_BUDGET).sum())} chunk rows")
    log(f"== bench plans: #2 and #4 at (b)'s powerlaw plan (dst "
        f"{hubs['dst']}, src {hubs['src']}), beside (a)'s random plan")
    bench_aggregate("bench (b)", fg, errs)
    gen = torch.Generator(device=device).manual_seed(0)
    times = {}
    for tag, fg in plans.items():
        eq, ek, g = (torch.randn((fg.n_pad, 96), generator=gen,
                                 device=device) for _ in range(3))
        times[tag] = {}
        check_kernels(f"bench ({tag}) bf16", fg, eq, ek, g,
                      fg.dst_slot_scales["sym"], fg.src_slot_scales["sym"],
                      leaky_relu(0.2), torch.bfloat16, errs,
                      timing=times[tag], require_vector=True)
    for name in LINEAR:
        log(f"  {name} (bf16 edges): " + ", ".join(
            f"({tag}) {t[name]['ms']:.4f} ms, plain "
            f"{t[name]['plain_ms']:.3f} ms, bound "
            f"{t[name]['bound'][0]:.4f} ms, "
            f"{100 * t[name]['bound'][0] / t[name]['ms']:.1f}% of bound"
            for tag, t in times.items()))


def sireconv_inputs(fg, seed: int, width: int = 96):
    """Node features [N, width] and edge features [E, De] N(0, 1), in
    original edge order, and the loss weights [N, width], on the graph's
    device."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((fg.n_pad, width), generator=gen)
    ef = torch.randn((fg.graph.num_edges, EDGE_DIM), generator=gen)
    w = torch.randn((fg.n_pad, width), generator=gen)
    dev = fg.graph.device
    return x.to(dev), ef.to(dev), w.to(dev)


def make_sireconv(dropout: float, edge_encoder=None, act=None,
                  agg_type: str = "sym", width: int = 96):
    """The SIREConv of the sireconv phase: ``width`` (96) in, De = 16,
    ``width`` hidden and out, ``act`` (leaky_relu(0.2) by default),
    ``agg_type`` (sym by default); weights from seed 0."""
    import torch

    from sir_gcn_tpu_torch.models import SIREConv
    from sir_gcn_tpu_torch.ops.ell import leaky_relu

    return SIREConv(width, EDGE_DIM, width, width, act or leaky_relu(0.2),
                    dropout=dropout, agg_type=agg_type,
                    edge_encoder=edge_encoder,
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


def phase_sireconv(device, fg, steps: int = 5, act=None):
    """SIREConv at full width on the arxiv plan, bf16 edges: (a) dropout 0,
    the fused-edge route; (b) dropout 0.2 in training, the generic edge
    route. Each runs ``steps`` steps, each followed by a no-grad eval
    (eval mode: the fused route), with exact launch counts. ``act`` is the
    conv's sigma (leaky_relu(0.2) by default)."""
    import torch

    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import make_adamw

    log(f"== sireconv: one SIREConv (96 -> 96, De {EDGE_DIM}, sym, bf16 "
        f"edges, {act.name if act else 'leaky_relu'}) on the arxiv plan, "
        f"{steps} steps and evals per setting")
    set_edge_dtype(torch.bfloat16)
    x, ef, w = sireconv_inputs(fg, seed=0)
    total = dict.fromkeys(KERNELS, 0)
    expected = {
        "a": dict(ell_edge_act_reduce2=2 * steps, ell_edge_src_bwd=steps),
        "b": dict(ell_act_reduce2_edge=steps, ell_src_bwd_edge=steps,
                  ell_edge_act_reduce2=steps),
    }
    for setting, dropout in (("a", 0.0), ("b", 0.2)):
        conv = make_sireconv(dropout, act=act).to(device)
        opt = make_adamw(conv.parameters(), 1e-3, 0.0)
        gen = torch.Generator(device=device).manual_seed(0)
        label = f"({setting}) dropout {dropout}"
        launches = conv_loop(
            label, conv, fg, x, w, steps,
            lambda: sireconv_step(conv, fg, x, ef, w, opt, gen),
            lambda: conv(fg, x, ef))
        if launches != expected[setting]:
            raise AssertionError(f"{label}: launch counts {launches}, "
                                 f"expected {expected[setting]}")
        for k, v in launches.items():
            total[k] += v
    set_edge_dtype(None)
    return total


def phase_sireconv_wide(device, fg, steps: int = 3):
    """The SIREConv of the heterophilous default width, 512 -> 512, De =
    EDGE_DIM, sym, leaky_relu(0.2), dropout 0: the fused edge route with
    #8 on its tiles path. (a) One training step on the heterophilous
    plan (minesweeper's size), f32 edges, on the card against the CPU
    (plain versions) from the same weights, on dyadic inputs (x and the
    edge features on multiples of 1/8, the weights on multiples of 1/128,
    so that every z is exact in f32 and both devices take the same side of
    leaky_relu's kink): out at FWD_TOL and every parameter's gradient, W_E's
    among them, at BWD_TOL; exactly one #7 and one #8 on the card. (b) On
    the arxiv plan, bf16 edges: ``steps`` AdamW steps, each followed by a
    no-grad eval, exactly #7 once a step and once an eval and #8 once a
    step, the step and eval times and the peak memory, then one profiled
    step. Returns (b)'s launches."""
    import copy

    import torch

    from sir_gcn_tpu_torch.experiments.heterophilous import train as het
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.ops.ell import leaky_relu
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import make_adamw

    h = WIDE_H
    log(f"== sireconv_wide (a): one SIREConv ({h} -> {h}, De {EDGE_DIM}, "
        f"sym, leaky_relu) step on the heterophilous plan, the card "
        f"(kernels) against the CPU (plain)")
    set_edge_dtype(None)
    args = het._parser().parse_args([
        "--dataset", "minesweeper", "--synthetic-nodes", str(HETERO_NODES),
        "--synthetic-edges", str(HETERO_EDGES)])
    graphs = {name: het.prepare(args, 0, 0, torch.device(dev))["graph"]
              for name, dev in (("cpu", "cpu"), ("card", device))}
    x, ef, w = sireconv_inputs(graphs["cpu"], seed=3, width=h)
    x, ef = dyadic(x, 8, 32), dyadic(ef, 8, 32)
    conv = make_sireconv(0.0, width=h)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(dyadic(p, 128, 1.0))
    want = {"ell_edge_act_reduce2": 1, "ell_edge_src_bwd": 1}
    runs = {}
    for name, g in graphs.items():
        dev = g.graph.device
        m = copy.deepcopy(conv).to(dev)
        m.train()
        reset_launch_counts()
        out = m(g, x.to(dev), ef.to(dev))
        (out * w.to(dev)).sum().backward()
        if name == "card":
            torch.cuda.synchronize()
            did = {k: v for k, v in LAUNCHES.items() if v}
            if did != want:
                raise AssertionError(f"(a) card launches {did}, expected "
                                     f"{want}")
        runs[name] = dict(out=out.detach().cpu(), grads={
            k: p.grad.cpu() for k, p in m.named_parameters()})
    c, g = runs["cpu"], runs["card"]
    log(f"  nodes {graphs['card'].graph.num_nodes}, edges "
        f"{graphs['card'].graph.num_edges}, launches {want}")
    compare("(a) out", g["out"], c["out"], FWD_TOL)
    for k in c["grads"]:
        compare(f"(a) grad {k}", g["grads"][k], c["grads"][k], BWD_TOL)
    del graphs, runs, conv

    log(f"== sireconv_wide (b): one SIREConv ({h} -> {h}, De {EDGE_DIM}, "
        f"sym, bf16 edges) on the arxiv plan, {steps} steps and evals")
    set_edge_dtype(torch.bfloat16)
    log_edge_layout("(b)", h, EDGE_DIM, leaky_relu(0.2), torch.bfloat16,
                    require=WIDE_EDGE_PATHS)
    x, ef, w = sireconv_inputs(fg, seed=0, width=h)
    conv = make_sireconv(0.0, width=h).to(device)
    opt = make_adamw(conv.parameters(), 1e-3, 0.0)
    gen = torch.Generator(device=device).manual_seed(0)
    launches = conv_loop(
        "(b)", conv, fg, x, w, steps,
        lambda: sireconv_step(conv, fg, x, ef, w, opt, gen),
        lambda: conv(fg, x, ef))
    want = {"ell_edge_act_reduce2": 2 * steps, "ell_edge_src_bwd": steps}
    if launches != want:
        raise AssertionError(f"(b) launch counts {launches}, expected "
                             f"{want}")
    log("== profile sireconv_wide (b): 1 warm training step")
    profile_steps(lambda: sireconv_step(conv, fg, x, ef, w, opt, gen), 1)
    del conv, opt, x, ef, w
    set_edge_dtype(None)
    torch.cuda.empty_cache()
    return launches


def max_launches(steps: int, edge: bool) -> dict:
    """A max conv's launches over ``steps`` steps, each followed by a
    no-grad eval: a step runs #9, #10, #11 and #12 once (the edge forms
    with ``edge``), an eval #9 once."""
    sfx = "_edge" if edge else ""
    return {f"ell_max_fwd{sfx}": 2 * steps, f"ell_max_wincount{sfx}": steps,
            f"ell_max_bwd{sfx}": steps, "ell_scaled_reduce": steps}


def phase_sireconv_max(device, fg, steps: int = 5):
    """Lane (d)'s SIREConv with max at full width on the arxiv plan (96 in,
    De = 16 raw edge features, 96 hidden and out, dropout 0.2, bf16
    edges), through ``SIREConv.forward``: (a) leaky_relu(0.2), (b)
    centered_relu(0.5), the edge term and a row-wise sigma together; each
    ``steps`` AdamW steps, each followed by a no-grad eval, with exact
    launch counts (``max_launches``: #9e-#11e and #12), the peak memory and
    one profiled step. Then (c) one step of (b) on a ~20k-node graph, card
    against CPU, f32 edges, dropout 0, on dyadic inputs and weights (eq,
    ek, e, z and each slot's sum over H exact in f32, so both devices take
    the same gates), with no cotangent at the near-tie (key, o) of the
    CPU's products (``near_ties``), where the devices may pick other
    winners: out at FWD_TOL, every gradient at BWD_TOL (W_R's at GW_TOL, a
    sum over every slot). Returns the launches of (a) and (b)."""
    import copy

    import torch

    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.train import (
        build_arxiv_graph,
        get_args,
    )
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.ops.ell import centered_relu, leaky_relu
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import make_adamw

    log(f"== sireconv_max: one SIREConv (96 -> 96, De {EDGE_DIM}, max, "
        f"dropout 0.2, bf16 edges) on the arxiv plan, {steps} steps and "
        f"evals per sigma")
    set_edge_dtype(torch.bfloat16)
    x, ef, w = sireconv_inputs(fg, seed=0)
    want = max_launches(steps, edge=True)
    runs = {}
    for setting, act in (("a", leaky_relu(0.2)), ("b", centered_relu(0.5))):
        conv = make_sireconv(0.2, act=act, agg_type="max").to(device)
        opt = make_adamw(conv.parameters(), 1e-3, 0.0)
        gen = torch.Generator(device=device).manual_seed(0)
        label = f"({setting}) {act.name}"
        step = lambda: sireconv_step(conv, fg, x, ef, w, opt, gen)
        runs[setting] = conv_loop(label, conv, fg, x, w, steps, step,
                                  lambda: conv(fg, x, ef))
        if runs[setting] != want:
            raise AssertionError(f"{label}: launch counts {runs[setting]}, "
                                 f"expected {want}")
        log(f"== profile sireconv_max ({setting}): 1 warm training step")
        profile_steps(step, 1)
        del conv, opt, step
    del x, ef, w

    log("== sireconv_max (c): one step of (b) on the card (kernels) against "
        "the CPU (plain)")
    set_edge_dtype(None)
    args = get_args(["--add-reverse-edge", "--add-self-loop"])
    data = synthetic_node_classification(20_000, 140_000, feat_dim=128,
                                         num_classes=40, seed=1)
    graphs = {name: build_arxiv_graph(data, args, dev)
              for name, dev in (("cpu", "cpu"), ("card", device))}
    x, ef, w = sireconv_inputs(graphs["cpu"], seed=1)
    x, ef = dyadic(x, 8, 4), dyadic(ef, 8, 4)
    act = centered_relu(0.5)
    conv = make_sireconv(0.0, act=act, agg_type="max")
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.round(p * 128) / 128)
        # no cotangent at the CPU's near-tie (key, o), where the two
        # devices may pick other winners and move its whole cotangent
        g = graphs["cpu"]
        plan = g.dst_plan
        e = conv.linear_edge(ef).index_select(0, g.graph.edge_perm)
        near, _ = near_ties(g, (conv.linear_query(x), conv.linear_key(x),
                                g.dst_slot_srcnode, g.dst_slot_scales["sum"],
                                plan.row_key, plan.row_ptr,
                                conv.relation_kernel), act, e)
        w = torch.where(near, 0.0, w)
    log(f"  {int(near.sum())} near-tie (key, o) of {near.numel()}: no "
        f"cotangent there")
    one = {k: v // (2 * steps) if k == "ell_max_fwd_edge" else v // steps
           for k, v in want.items()}
    out = {}
    for name, g in graphs.items():
        dev = g.graph.device
        m = copy.deepcopy(conv).to(dev)
        m.train()
        reset_launch_counts()
        y = m(g, x.to(dev), ef.to(dev))
        (y * w.to(dev)).sum().backward()
        if name == "card":
            torch.cuda.synchronize()
            did = {k: v for k, v in LAUNCHES.items() if v}
            if did != one:
                raise AssertionError(f"(c) card launches {did}, expected "
                                     f"{one}")
        out[name] = dict(out=y.detach().cpu(), grads={
            k: p.grad.cpu() for k, p in m.named_parameters()})
    c, g = out["cpu"], out["card"]
    log(f"  nodes 20000, edges {graphs['card'].graph.num_edges}, launches "
        f"{one}")
    compare("out", g["out"], c["out"], FWD_TOL)
    for k in c["grads"]:
        compare(f"grad {k}", g["grads"][k], c["grads"][k],
                GW_TOL if k == "relation_kernel" else BWD_TOL)
    return runs["a"], runs["b"]


def phase_max_rowwise(device, fg, steps: int = 5, wide_steps: int = 3):
    """One SIRConv with max and a row-wise sigma, bf16 edges, each step
    followed by a no-grad eval, with exact launch counts
    (``max_launches``) and the peak memory: (a) centered_relu(0.5) and (b)
    softmax at 96 -> 96 -> 96 on the arxiv plan, ``steps`` steps each; (c)
    centered_relu(0.5) at 512 -> 512 -> 512 on a graph of roman-empire's
    size (22,662 nodes, 32,927 undirected edges: the fullgraph phase's
    stand-in), ``wide_steps`` steps, one more profiled;
    (d) erf-GELU declared non-elementwise at 96 on the arxiv plan,
    ``wide_steps`` steps, on the max kernels' erf-GELU forms. Returns the
    launches of (a) and (b) together, of (c) and of (d)."""
    import torch

    from sir_gcn_tpu_torch.experiments.heterophilous import train as het
    from sir_gcn_tpu_torch.models import SIRConv
    from sir_gcn_tpu_torch.ops.ell import Activation, centered_relu, softmax
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import make_adamw

    log(f"== max_rowwise: one SIRConv with max and a row-wise sigma, bf16 "
        f"edges, {steps} (96 wide) or {wide_steps} (512 wide) steps and "
        f"evals")
    set_edge_dtype(torch.bfloat16)
    hargs = het._parser().parse_args([
        "--dataset", "roman-empire", *ROMAN_EMPIRE])
    roman = het.prepare(hargs, 0, 0, device)["graph"]
    log(f"  roman-empire's size: N {roman.n_pad}, E_pad {roman.e_pad}, "
        f"S_dst {roman.dst_plan.num_slots}")
    log_max_layout("max_rowwise (c)", 512, 512, require="wide")
    rowwise = dict.fromkeys(MAX, 0)
    wide = dict.fromkeys(MAX, 0)
    forced_gelu = dict.fromkeys(MAX, 0)
    for setting, act, graph, h, n, into in (
            ("a", centered_relu(0.5), fg, 96, steps, rowwise),
            ("b", softmax, fg, 96, steps, rowwise),
            ("c", centered_relu(0.5), roman, 512, wide_steps, wide),
            ("d", Activation("gelu", sir_elementwise=False), fg, 96,
             wide_steps, forced_gelu)):
        gen = torch.Generator(device=device).manual_seed(7)
        x = torch.randn((graph.n_pad, h), generator=gen, device=device)
        w = torch.randn((graph.n_pad, h), generator=gen, device=device)
        conv = SIRConv(h, h, h, act, agg_type="max",
                       generator=torch.Generator().manual_seed(0)).to(device)
        opt = make_adamw(conv.parameters(), 1e-3, 0.0)
        declared = " (declared non-elementwise)" if act.diagonal and \
            not act.elementwise else ""
        label = f"({setting}) {act.name}{declared} H={h}"
        step = lambda: conv_step(conv, graph, x, w, opt)
        launches = conv_loop(label, conv, graph, x, w, n, step,
                             lambda: conv(graph, x))
        want = max_launches(n, edge=False)
        if launches != want:
            raise AssertionError(f"{label}: launch counts {launches}, "
                                 f"expected {want}")
        for k, v in launches.items():
            into[k] += v
        if setting == "c":
            log("== profile max_rowwise (c): 1 warm training step")
            profile_steps(step, 1)
        del conv, opt, step, x, w
    set_edge_dtype(None)
    return rowwise, wide, forced_gelu


def make_general_conv():
    """The SIRConv of the general phase: 96 in, hidden and out, the
    row-wise centered_relu(0.5), sym; weights from seed 0."""
    import torch

    from sir_gcn_tpu_torch.models import SIRConv
    from sir_gcn_tpu_torch.ops.ell import centered_relu

    return SIRConv(96, 96, 96, centered_relu(0.5), agg_type="sym",
                   generator=torch.Generator().manual_seed(0))


def conv_step(conv, fg, x, w, opt):
    """One training step of a SIRConv: forward, loss = sum(out * w),
    backward, AdamW."""
    conv.train()
    opt.zero_grad(set_to_none=True)
    loss = (conv(fg, x) * w).sum()
    loss.backward()
    opt.step()
    return loss.detach()


def phase_general(device, fg, steps: int = 5):
    """One SIRConv with centered_relu(0.5) at full width on the arxiv plan,
    bf16 edges: ``steps`` AdamW steps, each followed by a no-grad eval,
    with exact launch counts (per step #1r, #3 and #4r once each, per eval
    #1r once, nothing else)."""
    import torch

    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import make_adamw

    log(f"== general: one SIRConv (96 -> 96, centered_relu(0.5), sym, bf16 "
        f"edges) on the arxiv plan, {steps} steps and evals")
    set_edge_dtype(torch.bfloat16)
    x, _, w = sireconv_inputs(fg, seed=0)
    conv = make_general_conv().to(device)
    opt = make_adamw(conv.parameters(), 1e-3, 0.0)
    launches = conv_loop("general", conv, fg, x, w, steps,
                         lambda: conv_step(conv, fg, x, w, opt),
                         lambda: conv(fg, x))
    want = dict(ell_act_reduce_rowwise=2 * steps, ell_geq_reduce=steps,
                ell_src_bwd_rowwise=steps)
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    set_edge_dtype(None)
    return launches


def conv_loop(label, conv, fg, x, w, steps, step_fn, eval_fn):
    """``steps`` training steps of ``conv``, each followed by a no-grad
    eval, every one synced and timed on the host clock; the launch counters
    set to 0 before and read after. Logs the times, the peak memory and the
    losses, and raises for a non-finite loss or eval output. Returns the
    launches (the counts that are not 0)."""
    import numpy as np
    import torch

    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_s, eval_s, losses = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step_fn()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        conv.eval()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = eval_fn()
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label}: non-finite eval output")
    launches = {k: v for k, v in LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    log(f"  {label}: step ms {[round(t * 1e3, 3) for t in step_s]}, eval "
        f"ms {[round(t * 1e3, 3) for t in eval_s]}")
    log(f"  {label}: steady step (median of steps 2..{steps}) "
        f"{1e3 * float(np.median(step_s[1:])):.3f} ms, eval median "
        f"{1e3 * float(np.median(eval_s[1:])):.3f} ms, peak memory "
        f"{peak / 2**30:.3f} GiB, losses {losses}")
    log(f"  {label}: launches {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite loss")
    return launches


def phase_general_edge(device, fg, steps: int = 5):
    """(a) One SIREConv at bench lane (d)'s shape with the row-wise
    centered_relu(0.5) on the arxiv plan, sym, bf16 edges (96 in, De = 16
    raw edge features, 96 hidden and out): ``steps`` AdamW steps, each
    followed by a no-grad eval, on the general route's edge forms, with
    exact launch counts (per step #1r·e, #3e and #4r·e once each, per eval
    #1r·e once, nothing else), then a profile of 3 warm steps; (b) one step
    of the same conv on a ~20k-node graph on the card against the CPU, f32
    edges, on dyadic inputs (as the e2e general phase: eq, ek, e, z and
    each row's sum exact in f32, so both devices take the same gates): out
    at the forward tolerance and every parameter gradient, W_E's among
    them, at the backward tolerance."""
    import copy

    import torch

    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.train import (
        build_arxiv_graph,
        get_args,
    )
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.ops.ell import centered_relu
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import make_adamw

    log(f"== general_edge: one SIREConv (96 -> 96, De {EDGE_DIM}, "
        f"centered_relu(0.5), sym, bf16 edges) on the arxiv plan, {steps} "
        f"steps and evals")
    set_edge_dtype(torch.bfloat16)
    x, ef, w = sireconv_inputs(fg, seed=0)
    conv = make_sireconv(0.0, act=centered_relu(0.5)).to(device)
    opt = make_adamw(conv.parameters(), 1e-3, 0.0)
    gen = torch.Generator(device=device).manual_seed(0)
    launches = conv_loop(
        "(a)", conv, fg, x, w, steps,
        lambda: sireconv_step(conv, fg, x, ef, w, opt, gen),
        lambda: conv(fg, x, ef))
    want = {"ell_act_reduce_rowwise_edge": 2 * steps,
            "ell_geq_reduce_edge": steps, "ell_src_bwd_rowwise_edge": steps}
    if launches != want:
        raise AssertionError(f"(a) launch counts {launches}, expected {want}")
    log("== profile general_edge: 3 warm training steps")
    profile_steps(lambda: sireconv_step(conv, fg, x, ef, w, opt, gen), 3)
    del conv, opt

    log("== general_edge (b): one step on the card (kernels) against the "
        "CPU (plain)")
    set_edge_dtype(None)
    args = get_args(["--add-reverse-edge", "--add-self-loop"])
    data = synthetic_node_classification(20_000, 140_000, feat_dim=128,
                                         num_classes=40, seed=1)
    graphs = {name: build_arxiv_graph(data, args, dev)
              for name, dev in (("cpu", "cpu"), ("card", device))}
    x, ef, w = sireconv_inputs(graphs["cpu"], seed=1)
    x = torch.round(x * 8).clamp(-32, 32) / 8
    ef = torch.round(ef * 8).clamp(-32, 32) / 8
    conv = make_sireconv(0.0, act=centered_relu(0.5))
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.round(p * 128) / 128)
    want = {"ell_act_reduce_rowwise_edge": 1, "ell_geq_reduce_edge": 1,
            "ell_src_bwd_rowwise_edge": 1}
    runs = {}
    for name, g in graphs.items():
        dev = g.graph.device
        m = copy.deepcopy(conv).to(dev)
        m.train()
        reset_launch_counts()
        out = m(g, x.to(dev), ef.to(dev))
        (out * w.to(dev)).sum().backward()
        if name == "card":
            torch.cuda.synchronize()
            did = {k: v for k, v in LAUNCHES.items() if v}
            if did != want:
                raise AssertionError(f"(b) card launches {did}, expected "
                                     f"{want}")
        runs[name] = dict(out=out.detach().cpu(), grads={
            k: p.grad.cpu() for k, p in m.named_parameters()})
    c, g = runs["cpu"], runs["card"]
    log(f"  nodes 20000, edges {graphs['card'].graph.num_edges}, launches "
        f"{want}")
    compare("out", g["out"], c["out"], FWD_TOL)
    for k in c["grads"]:
        compare(f"grad {k}", g["grads"][k], c["grads"][k], BWD_TOL)
    return launches


def require_wide_layouts(device, act):
    """The path ``ell_general_layout`` reports for each general kernel and
    edge form at WIDE_H and past it, on aligned tables: at WIDE_H (512)
    #1r, #3 and #4r and their edge forms and #5 on lane groups of the
    whole warp, GeneralLayout(64, 32, 1, 2, 1) in bf16 and (128, 32, 1, 4,
    1) in f32; #6 on the first design's wide path, WideLayout(16, 1); at
    520 every kernel on the wide path's passes, WideLayout(8, 3). Raises on
    any other path."""
    import torch

    from sir_gcn_tpu_torch.ops import cuda as K

    for h in (WIDE_H, 520):
        for dtype in (torch.bfloat16, torch.float32):
            f32 = torch.zeros((4, h), device=device)
            gath = torch.zeros((4, h), dtype=dtype, device=device)
            both = torch.zeros((4, 2 * h), dtype=dtype, device=device)
            chunks = h * dtype.itemsize // 16
            got = {}
            for name in GENERAL + BWD + tuple(GENERAL_EDGE):
                ts = ((both, f32, f32) if name == "ell_src_bwd_fused" else
                      (f32, gath, f32, gath, f32)
                      if name == "ell_act_reduce_bwd" else
                      (f32, gath, gath, f32))
                got[name] = K.ell_general_layout(name, h, dtype, act, *ts)
                want = (K.GeneralLayout(chunks, 32, 1, chunks // 32, 1)
                        if h <= 512 and name in FULL_WARP else
                        K.WideLayout(16, 1) if h <= 512 else
                        K.WideLayout(8, -(-h // 256)))
                if got[name] != want:
                    raise AssertionError(f"H={h} {dtype} {act.name} {name}: "
                                         f"{got[name]}, expected {want}")
            log(f"  layouts at H={h} ({dtype}, {act.name}): " + ", ".join(
                f"{k} {v}" for k, v in got.items()))


def phase_general_wide(device, fg, steps: int = 3):
    """First the paths the general kernels take at WIDE_H and past it, in
    bf16 and f32 (``require_wide_layouts``: #1r, #3 and #4r on full-warp
    lane groups at 512, the rest on the wide path). Then one SIRConv at the
    heterophilous width (WIDE_H in, hidden and out)
    on the arxiv plan, bf16 edges, three times: (a) softmax with mean, (b)
    centered_relu(0.5) with sym, both with #1r, #3 and #4r on full-warp
    lane groups, (c) erf-GELU
    declared non-elementwise (``Activation("gelu", sir_elementwise=
    False)``) with sym, on the general route's first design; each
    ``steps`` AdamW steps, each followed by a no-grad eval, with exact
    launch counts (per step #1r, #3 and #4r once each, per eval #1r once)
    and (b) profiled over 3 warm steps. Then single aggregates with a
    gradient, each launching exactly what it names: (d) erf-GELU at H = 96
    with fuse_bwd_take (#2, #5); (e) centered_relu at H = WIDE_H with
    fuse_bwd_take (#1r, #3, #5; #5 on full-warp lane groups); the dst-major
    composition (#1r, #6, #12) with (f) centered_relu at H = WIDE_H and (g)
    erf-GELU declared non-elementwise at H = 96. Returns the launches of
    the wide forms, of the erf-GELU forms and of (a)'s softmax forms
    (``WIDE_SOFTMAX``) by kernel."""
    import torch

    from sir_gcn_tpu_torch.models import SIRConv
    from sir_gcn_tpu_torch.ops import cuda as K
    from sir_gcn_tpu_torch.ops.ell import (
        Activation,
        centered_relu,
        ell_sir_aggregate,
        gelu,
        softmax,
    )
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import make_adamw

    h = WIDE_H
    log(f"== general_wide: one SIRConv ({h} -> {h} -> {h}, bf16 edges) on "
        f"the arxiv plan, {steps} steps and evals each")
    for act in (softmax, centered_relu(0.5)):
        require_wide_layouts(device, act)
    set_edge_dtype(torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(6)
    x = torch.randn((fg.n_pad, h), generator=gen, device=device)
    w = torch.randn((fg.n_pad, h), generator=gen, device=device)
    forced_gelu = Activation("gelu", sir_elementwise=False)
    wide = dict.fromkeys(GENERAL_FORMS, 0)
    gelu_launches = dict.fromkeys(GENERAL_FORMS, 0)
    wide_softmax = dict.fromkeys(WIDE_SOFTMAX, 0)  # (a)'s, of ``wide``
    per_run = {"ell_act_reduce_rowwise": 2 * steps,
               "ell_geq_reduce": steps, "ell_src_bwd_rowwise": steps}
    for setting, act, agg, into in (("a", softmax, "mean", wide),
                                    ("b", centered_relu(0.5), "sym", wide),
                                    ("c", forced_gelu, "sym",
                                     gelu_launches)):
        conv = SIRConv(h, h, h, act, agg_type=agg,
                       generator=torch.Generator().manual_seed(0)).to(device)
        opt = make_adamw(conv.parameters(), 1e-3, 0.0)
        label = f"({setting}) {act.name} {agg}"
        launches = conv_loop(label, conv, fg, x, w, steps,
                             lambda: conv_step(conv, fg, x, w, opt),
                             lambda: conv(fg, x))
        if launches != per_run:
            raise AssertionError(f"{label}: launch counts {launches}, "
                                 f"expected {per_run}")
        for k, v in launches.items():
            into[k] += v
            if setting == "a" and k in WIDE_SOFTMAX:
                wide_softmax[k] += v
        if setting == "b":
            log(f"== profile general_wide (b): 3 warm training steps")
            profile_steps(lambda: conv_step(conv, fg, x, w, opt), 3)
        del conv, opt
    del x, w

    plan, splan = fg.dst_plan, fg.src_plan

    def aggregate(label, act, width, fuse, into, want):
        """One aggregate's forward and backward, or with ``fuse`` None the
        dst-major composition; its launches must be ``want``."""
        g2 = torch.Generator(device=device).manual_seed(width)
        eq, ek, g = (torch.randn((fg.n_pad, width), generator=g2,
                                 device=device) for _ in range(3))
        K.reset_launch_counts()
        if fuse is None:
            bf = torch.bfloat16
            args = (eq, ek.to(bf), fg.dst_slot_srcnode,
                    fg.dst_slot_scales["sym"], plan.row_key, plan.row_ptr,
                    act)
            out = plan.finalize_rows_sum(K.ell_act_reduce_rowwise(*args))
            g_slots, geq = K.ell_act_reduce_bwd(*args, g, gz_dtype=bf)
            grads = (plan.finalize_rows_sum(geq),
                     splan.finalize_rows_sum(K.ell_scaled_reduce(
                         g_slots, fg.src_slot_from_dst_slot,
                         splan.slot_valid, splan.row_ptr)))
        else:
            eq.requires_grad_()
            ek.requires_grad_()
            out = ell_sir_aggregate(fg, eq, ek, act, "sym",
                                    edge_dtype=torch.bfloat16,
                                    fuse_bwd_take=fuse)
            grads = torch.autograd.grad(out, (eq, ek), g)
        torch.cuda.synchronize()
        did = {k: v for k, v in K.LAUNCHES.items() if v}
        finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
        log(f"  {label}: launches {did}, finite {finite}")
        if did != want or not finite:
            raise AssertionError(f"{label}: launches {did}, expected {want}; "
                                 f"finite {finite}")
        for k in GENERAL_FORMS:
            into[k] += did.get(k, 0)

    aggregate("(d) gelu H=96 fuse_bwd_take", gelu(), 96, True,
              gelu_launches, {"ell_act_reduce2": 1, "ell_src_bwd_fused": 1})
    aggregate(f"(e) centered_relu H={h} fuse_bwd_take", centered_relu(0.5),
              h, True, wide, {"ell_act_reduce_rowwise": 1,
                              "ell_geq_reduce": 1, "ell_src_bwd_fused": 1})
    dst_major = {"ell_act_reduce_rowwise": 1, "ell_act_reduce_bwd": 1,
                 "ell_scaled_reduce": 1}
    aggregate(f"(f) centered_relu H={h} dst-major", centered_relu(0.5), h,
              None, wide, dst_major)
    aggregate("(g) gelu (declared non-elementwise) H=96 dst-major",
              forced_gelu, 96, None, gelu_launches, dst_major)
    set_edge_dtype(None)
    torch.cuda.empty_cache()
    log(f"  launches of the wide forms {wide}, of the erf-GELU forms "
        f"{gelu_launches}; (a) softmax's {wide_softmax}")
    return wide, gelu_launches, wide_softmax


def phase_bwd(device, fg, iters: int = 10):
    """The forward and backward of one aggregate at the arxiv plan (H = 96,
    sym, tanh), three ways, each timed whole by CUDA events (casts, the
    [N, 2H] table and the finalizes included):
      (i)   src-major: #2, g_eq = g * sbar, #4 (the default);
      (ii)  fused take: #2, g * sbar, #5 over cat([eq, g], 1);
      (iii) dst-major: #1, #6 (g_z stored in the edge dtype), #12 over
            g_z through src_slot_from_dst_slot for g_ek.
    In f32 (g_z f32) every output of (ii) and (iii) is held against (i); in
    bf16 those of (ii), and out and g_eq of (iii). (iii)'s bf16 g_ek rounds
    other operands than (i) (ek and each slot's g_z, where (i) rounds eq and
    g), so its difference is logged. The launch counters run from the
    start of the phase to its end."""
    import torch

    from sir_gcn_tpu_torch.ops import cuda as K
    from sir_gcn_tpu_torch.ops.ell import ell_sir_aggregate, leaky_relu, tanh

    log("== bwd: forward + backward of one aggregate at the arxiv plan "
        "(H 96, sym, tanh), three designs")
    K.reset_launch_counts()
    plan, splan = fg.dst_plan, fg.src_plan
    gen = torch.Generator(device=device).manual_seed(1)
    eq0, ek0, w = (torch.randn((fg.n_pad, 96), generator=gen, device=device)
                   for _ in range(3))

    def src_major(dtype, fuse):
        def run():
            eq = eq0.detach().requires_grad_()
            ek = ek0.detach().requires_grad_()
            out = ell_sir_aggregate(fg, eq, ek, tanh, "sym", edge_dtype=dtype,
                                    fuse_bwd_take=fuse)
            return (out.detach(),) + torch.autograd.grad(out, (eq, ek), w)
        return run

    def dst_major(dtype):
        def run():
            args = (eq0, ek0.to(dtype), fg.dst_slot_srcnode,
                    fg.dst_slot_scales["sym"], plan.row_key, plan.row_ptr,
                    tanh)
            out = plan.finalize_rows_sum(K.ell_act_reduce(*args))
            g_slots, geq = K.ell_act_reduce_bwd(*args, w, gz_dtype=dtype)
            g_ek = splan.finalize_rows_sum(K.ell_scaled_reduce(
                g_slots, fg.src_slot_from_dst_slot, splan.slot_valid,
                splan.row_ptr))
            return out, plan.finalize_rows_sum(geq), g_ek
        return run

    names = ("out", "g_eq", "g_ek")
    tols = (FWD_TOL, BWD_TOL, BWD_TOL)
    want_launches = {
        "i": dict(ell_act_reduce2=1, ell_src_bwd=1),
        "ii": dict(ell_act_reduce2=1, ell_src_bwd_fused=1),
        "iii": dict(ell_act_reduce=1, ell_act_reduce_bwd=1,
                    ell_scaled_reduce=1)}
    for dtype in (torch.float32, torch.bfloat16):
        designs = {"i": src_major(dtype, False), "ii": src_major(dtype, True),
                   "iii": dst_major(dtype)}
        outs = {}
        for key, run in designs.items():
            before = dict(K.LAUNCHES)
            outs[key] = run()
            torch.cuda.synchronize()
            did = {k: v - before[k] for k, v in K.LAUNCHES.items()
                   if v != before[k]}
            if did != want_launches[key]:
                raise AssertionError(f"({key}) launched {did}, expected "
                                     f"{want_launches[key]}")
        for key in ("ii", "iii"):
            for i, (name, tol) in enumerate(zip(names, tols)):
                label = f"{dtype} ({key}) {name} against (i)"
                if key == "iii" and name == "g_ek" and dtype != torch.float32:
                    diff = (outs[key][i] - outs["i"][i]).abs()
                    log(f"  {label}: max abs diff {float(diff.max()):.3e}, "
                        f"max |g_ek| {float(outs['i'][i].abs().max()):.3e} "
                        f"(other rounding points, not held)")
                    continue
                compare(label, outs[key][i], outs["i"][i], tol)
        del outs
    ms = {key: [] for key in designs}
    for key in ("i", "ii", "iii", "iii", "ii", "i"):
        ms[key].append(cuda_ms(designs[key], iters))
    for key, label in (("i", "src-major (#2, #4)"),
                       ("ii", "fused take (#2, #5)"),
                       ("iii", "dst-major (#1, #6, #12)")):
        log(f"  ({key}) {label}: {ms[key][0]:.4f} / {ms[key][1]:.4f} ms "
            f"per forward + backward (bf16, two turns)")
    # the designs' backward kernels alone, on the same bf16 inputs
    bf = torch.bfloat16
    eqb, gb = eq0.to(bf), w.to(bf)
    rest = (ek0, fg.src_slot_dstnode, fg.src_slot_scales["sym"],
            splan.row_key, splan.row_ptr, tanh)
    both = torch.cat([eqb, gb], 1)
    fwd = (eq0, ek0.to(bf), fg.dst_slot_srcnode, fg.dst_slot_scales["sym"],
           plan.row_key, plan.row_ptr, tanh)
    g_slots, _ = K.ell_act_reduce_bwd(*fwd, w, gz_dtype=bf)
    leaky = rest[:-1] + (leaky_relu(0.2),)
    alone = {
        "#4 ell_src_bwd": lambda: K.ell_src_bwd(eqb, gb, *rest),
        "#4 with leaky_relu": lambda: K.ell_src_bwd(eqb, gb, *leaky),
        "#5 ell_src_bwd_fused": lambda: K.ell_src_bwd_fused(both, *rest),
        "#5 with leaky_relu": lambda: K.ell_src_bwd_fused(both, *leaky),
        "[N, 2H] table": lambda: torch.cat([eq0.to(bf), w.to(bf)], 1),
        "#6 ell_act_reduce_bwd": lambda: K.ell_act_reduce_bwd(
            *fwd, w, gz_dtype=bf),
        "#12 ell_scaled_reduce": lambda: K.ell_scaled_reduce(
            g_slots, fg.src_slot_from_dst_slot, splan.slot_valid,
            splan.row_ptr)}
    for act in (tanh, leaky[-1]):
        log_general_layout(f"bwd (ii) {act.name}", "ell_src_bwd_fused",
                           (both,) + rest[:-1] + (act,),
                           (K.ell_src_bwd_fused(both, *rest[:-1], act),),
                           require_group=True)
        args6 = fwd[:-1] + (act, w)
        log_general_layout(f"bwd (iii) {act.name}", "ell_act_reduce_bwd",
                           args6, K.ell_act_reduce_bwd(*args6, gz_dtype=bf))
    alone_ms = {name: cuda_ms(fn, 20) for name, fn in alone.items()}
    log("  backward kernels alone (bf16, tanh): " + ", ".join(
        f"{name} {ms:.4f} ms" for name, ms in alone_ms.items()))
    # #4 evaluates tanhf once per slot and feature
    count = fg.src_slot_dstnode.numel() * 96
    extra = alone_ms["#4 ell_src_bwd"] - alone_ms["#4 with leaky_relu"]
    log(f"  #4 tanh: {count / 1e6:.1f}M tanhf a launch; tanh costs "
        f"{extra:.4f} ms more than leaky_relu, {1e9 * extra / count:.4f} "
        f"ps a tanhf")
    return dict(K.LAUNCHES)


def compare_sum(label, got, want, mag) -> float:
    """Max abs error of the sums ``got`` against ``want``; raises where it
    passes SUM_TOL times ``mag``, the sum of the terms' magnitudes."""
    import torch

    diff = (got - want).abs()
    allowed = SUM_TOL * mag
    err = float(diff.max())
    ok = bool(torch.isfinite(got).all() and (diff <= allowed).all())
    log(f"  {label}: max abs err {err:.3e}, allowed {float(allowed.min()):.3g}"
        f"-{float(allowed.max()):.3g} (SUM_TOL x sum of |terms|) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def phase_lab(device):
    """The timing lab's main path: both tools' ``run`` at their full sizes
    (every line, each timed there), with the launch counters set to 0
    before and read after. Then each of #13-#24 at its default knob
    against its plain version on the same inputs (the gather and tile sums
    at SUM_TOL, the passthrough exactly, the rest at FWD_TOL), and its time
    beside the plain version's, the library call's and its bound; a kernel
    with a library call is timed against it in alternating turns. #22 with
    its persistent grid and #20 at each ``inflight`` are held against
    their plain versions and library calls too, and two launches of #20
    must give equal bits. Returns (launches, errors, timing) of the lab's
    kernels."""
    import torch
    import torch.nn.functional as F

    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.ops.cuda import lab as L
    from sir_gcn_tpu_torch.tools import gather_dma, kernel_lab

    log("== lab: tools.kernel_lab (all tags) and tools.gather_dma at the "
        "JAX tools' sizes")
    t0 = time.perf_counter()
    kin = kernel_lab.make_inputs(device)
    gin = gather_dma.make_inputs(device)
    torch.cuda.synchronize()
    log(f"  inputs made in {time.perf_counter() - t0:.1f}s")
    reset_launch_counts()
    kernel_lab.run(device, kernel_lab.TAGS, inputs=kin)
    gather_dma.run(device, inputs=gin)
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in LAB}
    log(f"  launches {launches}")
    missing = [k for k, v in launches.items() if not v]
    if missing:
        raise AssertionError(f"the lab launched no {missing}")
    log(f"  gather_dma with N = {gather_dma.BIG_N} rows "
        f"({gather_dma.BIG_N * gather_dma.SIZES['H'] * 2 / 1e6:.1f} MB of "
        f"bf16, beyond the 50 MB L2)")
    gather_dma.run(device, N=gather_dma.BIG_N)

    ekg, eq, sc, ekg3, sc3, ekg32 = (
        kin[k] for k in ("ekg", "eq", "sc", "ekg3", "sc3", "ekg32"))
    tbl, idx = gin["tbl"], gin["idx"]
    (r, h), b = eq.shape, ekg.shape[0] // eq.shape[0]
    t, tsum = gather_dma.SIZES["T"], gather_dma.SIZES["TSUM"]
    taken = tbl.index_select(0, idx)

    def embedding_bag(weight):
        return lambda: F.embedding_bag(idx.view(-1, t), weight, mode="sum")

    bag = embedding_bag(tbl)
    try:
        bag()
    except RuntimeError:  # no bf16 embedding_bag on this build
        bag = embedding_bag(tbl.float())
    # kernel -> (inputs, library call or None)
    cases = {
        **{k: ((ekg, eq, sc), None)
           for k in ("lab_v1", "lab_v2", "lab_v3", "lab_v4")},
        **{k: ((ekg3, eq, sc3), None) for k in ("lab_v5", "lab_v6")},
        "lab_copy": ((ekg, r), lambda: torch.sum(ekg.view(r, b, h), 1,
                                                  dtype=torch.float32)),
        "lab_copy32": ((ekg32, r), lambda: ekg32.view(r, b, h).sum(1)),
        "lab_pass": ((ekg,), lambda: torch.add(ekg, 1.0)),
        "lab_pass2": ((ekg,), lambda: torch.add(ekg, 1.0)),
        "lab_gather": ((tbl, idx, t), bag),
        "lab_tile_sum": ((taken, tsum), lambda: torch.sum(
            taken.view(-1, tsum, h), 1, dtype=torch.float32)),
    }
    errs, timing = {}, {}
    for name, (args, library) in cases.items():
        kernel = lambda name=name, args=args: getattr(L, name)(*args)
        plain = lambda name=name, args=args: L.PLAIN[name](*args)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if name in ("lab_gather", "lab_tile_sum"):
            mag = L.PLAIN[name](args[0].abs(), *args[1:])
            errs[name] = compare_sum(f"lab {name}", got, want, mag)
            del mag
        else:
            errs[name] = compare(f"lab {name}", got, want,
                                 EXACT if "pass" in name else FWD_TOL)
        del want
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        elems = idx.numel() * h if name == "lab_gather" else args[0].numel()
        tm = timing[name] = dict(
            plain_ms=cuda_ms(plain, 3, warmup=1),
            bound=bound(tensors, (got,), KERNELS[name][2] * elems))
        del got
        if library is None:
            tm.update(ms=cuda_ms(kernel, 20), library_ms=None)
        else:
            library_turns(name, kernel, library, tm)

    # the redesigned streams' other knobs against their plain versions and
    # their library calls, and #20 and #23 launched twice
    for name, knob in [("lab_pass2", dict(persistent=True))] + [
            ("lab_copy32", dict(inflight=u)) for u in L.INFLIGHT]:
        args, library = cases[name]
        got = getattr(L, name)(*args, **knob)
        err = compare(f"lab {name} {knob}", got, L.PLAIN[name](*args),
                      EXACT if "pass" in name else FWD_TOL)
        errs[name] = max(errs[name], err)
        del got
        library_turns(f"{name} {knob}",
                      lambda name=name, args=args, knob=knob: getattr(
                          L, name)(*args, **knob), library, {})
    for name, args in (("lab_copy32", (ekg32, r)),
                       ("lab_gather", (tbl, idx, t))):
        first, second = getattr(L, name)(*args), getattr(L, name)(*args)
        if not torch.equal(first, second):
            raise AssertionError(f"{name}: two launches differ")
        log(f"  {name} launched twice: equal bits")
        del first, second
    for name, tm in timing.items():
        b_ms, by, nbytes, flops = tm["bound"]
        lib = tm["library_ms"]
        log(f"  {name}: {tm['ms']:.4f} ms ({nbytes / tm['ms'] / 1e6:.0f} "
            f"GB/s), plain {tm['plain_ms']:.3f} ms, library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{b_ms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP), {100 * b_ms / tm['ms']:.1f}% of bound")
    log(f"  library of lab_gather: F.embedding_bag, output "
        f"{bag().dtype} (the kernel's is f32 [G, 8, H])")
    return launches, errs, timing


def phase_e2e_general(device):
    """One training step of the general phase's SIRConv on a ~20k-node
    graph on the card against the CPU, f32 edges: out at the forward
    tolerance, every parameter gradient at the backward tolerance,
    elementwise, and the card's launches exactly #1r, #3 and #4r once each.
    The features and weights lie on a dyadic grid (x on multiples of 2^-3
    in [-4, 4], weights on multiples of 2^-7), so eq, ek, z and each row's
    sum are exact in f32 in any order: both devices see the same z and the
    same centered_relu gates, and only the continuous parts differ."""
    import copy

    import torch

    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.train import (
        build_arxiv_graph,
        get_args,
    )
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype

    log("== e2e general: one SIRConv (centered_relu) step on the card "
        "(kernels) against the CPU (plain)")
    set_edge_dtype(None)
    args = get_args(["--add-reverse-edge", "--add-self-loop"])
    data = synthetic_node_classification(20_000, 140_000, feat_dim=128,
                                         num_classes=40, seed=1)
    graphs = {name: build_arxiv_graph(data, args, dev)
              for name, dev in (("cpu", "cpu"), ("card", device))}
    x, _, w = sireconv_inputs(graphs["cpu"], seed=1)
    x = torch.round(x * 8).clamp(-32, 32) / 8
    conv = make_general_conv()
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.round(p * 128) / 128)
    want = dict(ell_act_reduce_rowwise=1, ell_geq_reduce=1,
                ell_src_bwd_rowwise=1)
    runs = {}
    for name, fg in graphs.items():
        dev = fg.graph.device
        m = copy.deepcopy(conv).to(dev)
        m.train()
        reset_launch_counts()
        out = m(fg, x.to(dev))
        (out * w.to(dev)).sum().backward()
        if name == "card":
            torch.cuda.synchronize()
            launches = {k: v for k, v in LAUNCHES.items() if v}
            if launches != want:
                raise AssertionError(f"card launches {launches}, expected "
                                     f"{want}")
        runs[name] = dict(out=out.detach().cpu(), grads={
            k: p.grad.cpu() for k, p in m.named_parameters()})
    c, g = runs["cpu"], runs["card"]
    log(f"  nodes 20000, edges {graphs['card'].graph.num_edges}, launches "
        f"{want}")
    compare("out", g["out"], c["out"], FWD_TOL)
    for k in c["grads"]:
        compare(f"grad {k}", g["grads"][k], c["grads"][k], BWD_TOL)


def dyadic(t, step: int, bound: float):
    """``t`` rounded to multiples of 1/step in [-bound, bound]."""
    import torch

    return torch.round(t * step).clamp(-bound * step, bound * step) / step


def card_against_cpu(label, graphs, fn, arrays, gw, want, gw_keys=()):
    """Run ``fn(graph, tensors)`` on each of ``graphs`` ({"cpu": .., "card":
    ..}) with ``arrays`` as leaf tensors on its device, backward of
    sum(out * gw); the card's launches must be ``want`` exactly ({} for a
    route that runs no kernel); out is held at FWD_TOL, every gradient at
    BWD_TOL (GW_TOL for ``gw_keys``, sums over every slot)."""
    import torch

    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts

    runs = {}
    for name, graph in graphs.items():
        dev = graph.device
        ts = {k: v.detach().to(dev, copy=True).requires_grad_()
              for k, v in arrays.items()}
        reset_launch_counts()
        out = fn(graph, ts)
        (out * gw.to(dev)).sum().backward()
        if name == "card":
            torch.cuda.synchronize()
            launches = {k: v for k, v in LAUNCHES.items() if v}
            if launches != want:
                raise AssertionError(f"{label}: card launches {launches}, "
                                     f"expected {want}")
        runs[name] = (out.detach().cpu(),
                      {k: t.grad.cpu() for k, t in ts.items()})
    (c_out, c_grads), (g_out, g_grads) = runs["cpu"], runs["card"]
    log(f"  {label}: launches {want}")
    compare(f"{label} out", g_out, c_out, FWD_TOL)
    for k in c_grads:
        compare(f"{label} grad {k}", g_grads[k], c_grads[k],
                GW_TOL if k in gw_keys else BWD_TOL)


def route_inputs(fg, seed: int):
    """The route checks' inputs on the CPU: eq, ek [N, 96], e [E_pad, 96]
    and e_basis [E_pad, 16] on multiples of 2^-3 in [-4, 4]; W_E [16, 96]
    and W_R [96, 96] on multiples of 2^-7 in [-1/2, 1/2], b_R [96]; the
    loss weights [N, 96] N(0, 1); and a DropEdge mask [E_pad] drawn with
    numpy: a fifth of the edges and every in-edge of 200 nodes."""
    import numpy as np
    import torch

    gen = torch.Generator().manual_seed(seed)
    n, e = fg.n_pad, fg.e_pad
    x = lambda *shape: dyadic(torch.randn(shape, generator=gen), 8, 4.0)
    wt = lambda *shape: dyadic(0.2 * torch.randn(shape, generator=gen), 128,
                               0.5)
    rng = np.random.default_rng(seed)
    dst = fg.graph.host["dst"]
    mask = (rng.random(e) >= 0.2) & ~np.isin(
        dst, rng.choice(fg.graph.num_nodes, 200, replace=False))
    return dict(eq=x(n, 96), ek=x(n, 96), e=x(e, 96), eb=x(e, EDGE_DIM),
                we=wt(EDGE_DIM, 96), w=wt(96, 96), b=wt(96),
                gw=torch.randn((n, 96), generator=gen),
                mask=torch.from_numpy(mask))


def gain_sigma(base, h: int, device):
    """``base(z) * gain``, a per-feature gain [h] on a dyadic grid (1/2 to
    3/2 in quarters): a sigma that holds a tensor, which the JAX package
    sends to its XLA route (a Pallas kernel cannot hold a captured array),
    so the port's pure ELL route is its route on the card too."""
    import torch

    gain = ((torch.arange(h) % 5 + 2) / 4).to(device)

    def gained(z):
        return base(z) * gain

    gained.__name__ = f"gain_{base.__name__}"
    return gained


def phase_e2e_routes(device):
    """Each route of ``sir_aggregate`` once on the e2e phases' ~20k-node
    graph, on the card against the CPU, f32 edges, forward and every
    gradient:
      dropedge  one aggregate per kernel route under one numpy DropEdge
                mask (the kernels on dynamic slot scales): the elementwise
                route with mean, the general route (centered_relu(0.5))
                and the e route with sym, the fused-edge route with mean,
                max; exactly the route's kernels launch;
      pure      the pure ELL route under the same mask, with sigmas that
                hold a tensor (``gain_sigma``, JAX's XLA route): gained
                erf-GELU with sym and e, and max of gained relu with e; no
                kernel launches;
      csr       the CSR aggregate on the plain GraphBatch: sum, mean, sym
                (erf-GELU) and max (relu), with e and the mask; no kernel
                launches.
    Inputs and weights lie on a dyadic grid and the kernel routes'
    leaky_relu has slope 1/4, so z, sigma(z), e_basis @ W_E and the max's
    products are exact in f32 in any order: both devices see the same z,
    the same centered_relu gates and the same max winners, and the
    continuous parts (scales, sums, GELU) differ by rounding only."""
    import torch
    import torch.nn.functional as F

    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.train import (
        build_arxiv_graph,
        get_args,
    )
    from sir_gcn_tpu_torch.ops import message_passing as mp
    from sir_gcn_tpu_torch.ops.ell import centered_relu, leaky_relu

    log("== e2e routes: each route of sir_aggregate under one DropEdge mask, "
        "on the card against the CPU")
    mp.set_edge_dtype(None)
    args = get_args(["--add-reverse-edge", "--add-self-loop"])
    data = synthetic_node_classification(20_000, 140_000, feat_dim=128,
                                         num_classes=40, seed=1)
    graphs = {name: build_arxiv_graph(data, args, dev)
              for name, dev in (("cpu", "cpu"), ("card", device))}
    inp = route_inputs(graphs["cpu"], seed=2)
    mask, gw = inp["mask"], inp["gw"]
    log(f"  nodes 20000, edges {graphs['card'].graph.num_edges}, kept "
        f"{int(mask.sum())} of {int(graphs['card'].edge_mask.sum())}")
    act = leaky_relu(0.25)
    pick = lambda *keys: {k: inp[k] for k in keys}
    gained = lambda base: {"cpu": gain_sigma(base, 96, "cpu"),
                           "cuda": gain_sigma(base, 96, device)}

    def agg(sigma, kind, **fixed):
        """``sigma`` is a callable, or one per device type (a dict)."""
        def fn(graph, t):
            s = (sigma[graph.device.type] if isinstance(sigma, dict)
                 else sigma)
            kw = dict(fixed, edge_mask=mask.to(graph.device))
            if "e" in t:
                kw["e"] = t["e"]
            if "we" in t:
                kw.update(e_basis=inp["eb"].to(graph.device),
                          w_edge=t["we"])
            if "w" in t:
                kw.update(w_relation=t["w"], b_relation=t["b"])
            return mp.sir_aggregate(graph, t["eq"], t["ek"], s, kind, **kw)
        return fn

    checks = [  # W_R is [96, 96]: max's loss weights are gw too
        ("dropedge linear mean", agg(act, "mean"), pick("eq", "ek"),
         dict(ell_act_reduce2=1, ell_src_bwd=1), ()),
        ("dropedge general sym", agg(centered_relu(0.5), "sym"),
         pick("eq", "ek"), dict(ell_act_reduce_rowwise=1, ell_geq_reduce=1,
                                ell_src_bwd_rowwise=1), ()),
        ("dropedge e sym", agg(act, "sym"), pick("eq", "ek", "e"),
         dict(ell_act_reduce2_edge=1, ell_src_bwd_edge=1), ()),
        ("dropedge fused-edge mean", agg(act, "mean"),
         pick("eq", "ek", "we"),
         dict(ell_edge_act_reduce2=1, ell_edge_src_bwd=1), ("we",)),
        ("dropedge max", agg(act, "max"), pick("eq", "ek", "w", "b"),
         dict(ell_max_fwd=1, ell_max_wincount=1, ell_max_bwd=1,
              ell_scaled_reduce=1), ("w", "b")),
        ("pure gain-gelu sym", agg(gained(F.gelu), "sym"),
         pick("eq", "ek", "e"), {}, ()),
        ("pure gain-relu max", agg(gained(F.relu), "max"),
         pick("eq", "ek", "e", "w", "b"), {}, ("w", "b")),
    ]
    for label, fn, arrays, want, gw_keys in checks:
        card_against_cpu(label, graphs, fn, arrays, gw, want, gw_keys)
    plain = {name: fg.graph for name, fg in graphs.items()}
    for kind in ("sum", "mean", "sym", "max"):
        sigma = F.relu if kind == "max" else F.gelu
        keys = ("eq", "ek", "e") + (("w", "b") if kind == "max" else ())
        card_against_cpu(f"csr {kind}", plain, agg(sigma, kind),
                         pick(*keys), gw, {},
                         ("w", "b") if kind == "max" else ())


def phase_pure(device, fg, iters: int = 5):
    """One forward and backward of one aggregate at the arxiv plan (H = 96,
    sym), each timed whole by CUDA events over ``iters`` calls: the pure
    ELL route with erf-GELU times a per-feature gain (``gain_sigma``, a
    sigma that holds a tensor, which JAX also runs on its XLA route; f32,
    it launches no kernel) beside the kernel route with leaky_relu(0.2)
    (#2, #4) in f32 and in bf16 edges; each one's peak memory above what
    was allocated before it. Plain erf-GELU (``F.gelu``), which holds no
    tensor, must raise on the card: JAX runs it on its kernels, the port's
    kernels take the registry's ``gelu()`` (declared non-elementwise, the
    general route's kernels take it: the general_wide phase runs it)."""
    import torch
    import torch.nn.functional as F

    from sir_gcn_tpu_torch.ops import message_passing as mp
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.ops.ell import leaky_relu

    log(f"== pure: one aggregate's forward and backward at the arxiv plan "
        f"(H 96, sym), {iters} calls each")
    gen = torch.Generator(device=device).manual_seed(3)
    eq, ek, g = (torch.randn((fg.n_pad, 96), generator=gen, device=device)
                 for _ in range(3))
    eq.requires_grad_()
    ek.requires_grad_()
    try:
        mp.sir_aggregate(fg, eq, ek, F.gelu, "sym")
    except NotImplementedError as err:
        log(f"  plain erf-GELU on the card raises: {err}")
    else:
        raise AssertionError("plain erf-GELU took the pure route on the card")
    times = {}
    for label, sigma, dtype in (("pure gain-GELU f32",
                                 gain_sigma(F.gelu, 96, device), None),
                                ("kernels leaky_relu f32", leaky_relu(0.2),
                                 None),
                                ("kernels leaky_relu bf16", leaky_relu(0.2),
                                 torch.bfloat16)):
        mp.set_edge_dtype(dtype)

        def step():
            eq.grad = ek.grad = None
            mp.sir_aggregate(fg, eq, ek, sigma, "sym").backward(g)

        step()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times[label] = cuda_ms(step, iters, warmup=1)
        launches = {k: v for k, v in LAUNCHES.items() if v}
        extra = (torch.cuda.max_memory_allocated() - base) / 2**30
        finite = bool(torch.isfinite(eq.grad).all()
                      and torch.isfinite(ek.grad).all())
        log(f"  {label}: {times[label]:.4f} ms a forward and backward, "
            f"peak {extra:.3f} GiB above its inputs, launches {launches}")
        if not finite:
            raise AssertionError(f"{label}: non-finite gradient")
        if (launches != {}) != label.startswith("kernels"):
            raise AssertionError(f"{label}: launches {launches}")
    mp.set_edge_dtype(None)
    pure = times["pure gain-GELU f32"]
    log(f"  pure gain-GELU / kernels leaky_relu: "
        f"{pure / times['kernels leaky_relu f32']:.2f}x (f32), "
        f"{pure / times['kernels leaky_relu bf16']:.2f}x (bf16)")
    del eq, ek, g


def phase_profile_general(device, fg, steps: int = 3):
    """The profile breakdown of the general phase's step."""
    import torch

    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import make_adamw

    log(f"== profile general: {steps} warm training steps")
    set_edge_dtype(torch.bfloat16)
    x, _, w = sireconv_inputs(fg, seed=0)
    conv = make_general_conv().to(device)
    opt = make_adamw(conv.parameters(), 1e-3, 0.0)
    profile_steps(lambda: conv_step(conv, fg, x, w, opt), steps)
    set_edge_dtype(None)


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


def phase_profile(device, agg: str, steps: int = 3,
                  edge_dropout: float = 0.0, against=None):
    """Device time by kernel over a few warm training steps of the train
    phase's configuration with ``agg`` (and ``edge_dropout``, the dropedge
    phase's), and the device's busy share of the wall time; with
    ``against`` (another profile's per-kernel times) also the kernels
    whose time a step differs most from it. Returns the per-kernel times.
    Informational: it fails only if the step itself fails."""
    import torch

    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv import train
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.model import SIRModel
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import make_adamw

    log(f"== profile {agg}" + (f", edge dropout {edge_dropout}"
                               if edge_dropout else "")
        + f": {steps} warm training steps of the train configuration")
    args = train.get_args(flags_for(agg))
    set_edge_dtype(torch.bfloat16)
    data = synthetic_node_classification(
        ARXIV_NODES, ARXIV_EDGES, feat_dim=128, num_classes=40, seed=0)
    fg = train.build_arxiv_graph(data, args, device)
    model = SIRModel(128, 96, 40, num_layers=3, norm="bn", residual=True,
                     dropout=0.2, feat_dropout=0.2, agg_type=agg,
                     edge_dropout=edge_dropout,
                     generator=torch.Generator().manual_seed(0)).to(device)
    step, _ = train.make_harness(model, fg, make_adamw(model.parameters(),
                                                       args.lr, args.wd),
                                 args, 40)
    inputs = step_inputs(data, fg.n_pad, device)
    gen = torch.Generator(device=device).manual_seed(0)
    per_kernel = profile_steps(lambda: step(*inputs, gen), steps)
    set_edge_dtype(None)
    if against is not None and per_kernel:
        delta = {k: per_kernel.get(k, (0.0, 0))[0] - against.get(
            k, (0.0, 0))[0] for k in set(per_kernel) | set(against)}
        log(f"  against the profile without edge dropout: device "
            f"{sum(delta.values()):+.3f} ms a step; largest differences:")
        for k in sorted(delta, key=lambda k: -abs(delta[k]))[:8]:
            log(f"  {delta[k]:+8.3f} ms/step  x{against.get(k, (0, 0))[1]}"
                f" -> x{per_kernel.get(k, (0, 0))[1]}  {k[:90]}")
    return per_kernel


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


def profile_steps(step, steps: int) -> dict:
    """Run ``step`` twice to warm up, then ``steps`` times under
    torch.profiler; log the wall and device-busy time per step, the idle
    share and the 15 largest device items. Returns {kernel: (ms a step,
    launches a step)} ({} if the profiler saw no device time)."""
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
        return {}
    log(f"  per step: wall {wall_ms:.3f} ms (profiled), device busy "
        f"{busy_ms:.3f} ms, idle share {100 * (1 - busy_ms / wall_ms):.1f}%")
    for e in sorted(events, key=dev_us, reverse=True)[:15]:
        log(f"  {dev_us(e) / 1e3 / steps:8.3f} ms/step "
            f"{100 * dev_us(e) / 1e3 / steps / busy_ms:5.1f}%  "
            f"x{e.count // steps:<4d} {e.key[:90]}")
    return {e.key: (dev_us(e) / 1e3 / steps, e.count // steps)
            for e in events}


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


# the oracles phase: the README commands of the two synthetic oracles
DL_SIR_FLAGS = ["--nodes", "10", "--nhidden", "40", "--nruns", "1",
                "--seed", "0"]
DL_GCN_FLAGS = ["--model", "GCN", "--nodes", "10", "--nhidden", "40",
                "--epochs", "15", "--nruns", "1", "--seed", "0"]
HEC_SIR_FLAGS = ["--classes", "2", "--nhidden", "20", "--nruns", "1",
                 "--seed", "0"]
ORACLE_MODELS = ("SIR", "GCN", "SAGE", "GAT", "GIN", "PNA")


def oracle_run(label, main, flags, check):
    """One run of an oracle's entry point on the card with every train
    step timed between device syncs, the launch counters set to 0 before
    and read after (the CSR aggregate runs no kernel of the port, as JAX
    runs these batches on XLA); ``check(test)`` must hold. Returns the
    run's stats."""
    import torch

    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts

    log(f"== oracles {label}: " + " ".join(flags))
    stats = []
    reset_launch_counts()
    _, (test,) = main(flags, stats=stats, time_steps=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    (st,) = stats
    log(f"  {label}: test {test!r} after {st['epochs']} epochs in "
        f"{st['seconds']:.1f} s; train step median "
        f"{statistics.median(st['step_ms']):.3f} ms over "
        f"{len(st['step_ms'])} steps (min {min(st['step_ms']):.3f}, max "
        f"{max(st['step_ms']):.3f}); kernel launches {launches}")
    if "collate_ms" in st:
        c = st["collate_ms"]
        log(f"  {label}: collate ms per batch median "
            f"{statistics.median(c):.3f}, mean {statistics.fmean(c):.3f} "
            f"over {len(c)} batches ({sum(c) / 1e3:.1f} s of the run)")
    if launches:
        raise AssertionError(f"{label}: the CSR route launched {launches}")
    if not check(test):
        raise AssertionError(f"{label}: test {test!r} misses the oracle")
    return st


def oracle_batches(device):
    """The full-width first batch of each harness: DL (n=10, 5000 samples,
    batch 256) as (template graph, feats, labels, weights) and HEC (50
    nodes, c=2, 5000 samples, batch 256) as a collated batch on
    ``device``; the HEC collection and train indices too."""
    import numpy as np
    import torch

    from sir_gcn_tpu_torch.data import (
        DictionaryLookupDataset,
        GraphCollection,
        HeteroEdgeCountDataset,
    )
    from sir_gcn_tpu_torch.experiments.dictionary_lookup import train as dl

    ds = DictionaryLookupDataset(10, 5000, rng=np.random.default_rng(0))
    template = dl.make_batcher(ds, 256, device)
    f, lab, w = dl.pad_batch(ds.feats[:256], ds.labels[:256], 256, 10,
                             template.n_pad)
    dl_batch = (template, torch.from_numpy(f).to(device),
                torch.from_numpy(lab).to(device, torch.int64),
                torch.from_numpy(w).to(device))
    hds = HeteroEdgeCountDataset(50, 2, 5000, normalize=False,
                                 rng=np.random.default_rng(0))
    coll = GraphCollection(hds.graphs, node_feats=hds.feats,
                           labels=hds.labels)
    return dl_batch, coll, np.arange(4000)


def oracle_model(harness, name):
    """A two-layer model of ``harness`` at its README width (GAT with two
    heads), weights from seed 0."""
    import torch

    from sir_gcn_tpu_torch.experiments.dictionary_lookup import (
        model as dl_model,
    )
    from sir_gcn_tpu_torch.experiments.hetero_edge_count import (
        model as hec_model,
    )

    mods, dims = ((dl_model, (10, 40, 10)) if harness == "dl"
                  else (hec_model, (2, 20, 1)))
    kw = {} if name == "SIR" else {"num_heads": 2}
    return mods.MODELS[name](*dims, num_layers=2,
                             generator=torch.Generator().manual_seed(0),
                             **kw)


def oracle_card_against_cpu(device):
    """Each of the twelve models on one full-width batch, forward and
    backward of its harness's loss on the card and on the CPU from the
    same weights: out and loss at FWD_TOL, every weight gradient at
    GW_TOL (each sums over every node or edge of the batch, in the order
    of the card's atomic adds)."""
    import copy

    import torch

    from sir_gcn_tpu_torch.experiments.dictionary_lookup import train as dl
    from sir_gcn_tpu_torch.experiments.hetero_edge_count import train as hec

    log("== oracles (d): the twelve models, card against CPU")
    cpu = torch.device("cpu")
    (dl_cpu, coll, idx), (dl_card, _, _) = (oracle_batches(cpu),
                                            oracle_batches(device))
    hec_cpu = hec.batch_tensors(coll.collate(idx[:256], 256, cpu), cpu)
    hec_card = hec.batch_tensors(coll.collate(idx[:256], 256, device),
                                 device)
    for harness, batches in (("dl", (dl_cpu, dl_card)),
                             ("hec", (hec_cpu, hec_card))):
        for name in ORACLE_MODELS:
            model = oracle_model(harness, name)
            runs = []
            for graph, f, lab, w in batches:
                m = copy.deepcopy(model).to(f.device).train()
                out = m(graph, f)
                loss = (dl.weighted_ce(out, lab, w) if harness == "dl"
                        else hec.weighted_mse(out[:, 0], lab, w))
                loss.backward()
                runs.append((out.detach().cpu(), loss.detach().cpu(),
                             {k: p.grad.cpu()
                              for k, p in m.named_parameters()}))
            (o_c, l_c, g_c), (o_g, l_g, g_g) = runs
            label = f"{harness} {name}"
            compare(f"{label} out", o_g, o_c, FWD_TOL)
            compare(f"{label} loss", l_g[None], l_c[None], FWD_TOL)
            for k in g_c:
                compare(f"{label} grad {k}", g_g[k], g_c[k], GW_TOL)


def phase_oracles(device):
    """The two synthetic oracles on the card through their entry points:
    (a) DL SIR n=10 (README command) to its early stop, test accuracy
    exactly 1.0; (b) DL GCN n=10 for 15 epochs, exactly 0.1; (c) HEC SIR
    c=2 (README command, unnormalized) to its early stop or epoch 500,
    test MSE under 2e-3; then one profiled train step of DL SIR and of HEC
    SIR (with and without its batch's collation), and (d) the twelve
    models card against CPU."""
    import torch

    from sir_gcn_tpu_torch.experiments.dictionary_lookup import train as dl
    from sir_gcn_tpu_torch.experiments.hetero_edge_count import train as hec
    from sir_gcn_tpu_torch.train import make_adamw

    t0 = time.perf_counter()
    oracle_run("(a) DL SIR n=10", dl.main, DL_SIR_FLAGS,
               lambda acc: acc == 1.0)
    oracle_run("(b) DL GCN n=10", dl.main, DL_GCN_FLAGS,
               lambda acc: acc == 0.1)
    t_c = time.perf_counter()
    oracle_run("(c) HEC SIR c=2", hec.main, HEC_SIR_FLAGS,
               lambda mse: mse < 2e-3)
    log(f"  (c) took {time.perf_counter() - t_c:.1f} s")

    dl_batch, coll, idx = oracle_batches(device)
    for harness, label in (("dl", "DL SIR"), ("hec", "HEC SIR")):
        model = oracle_model(harness, "SIR").to(device)
        opt = make_adamw(model.parameters(), 1e-3)
        if harness == "dl":
            step = dl.make_harness(model, dl_batch[0], opt)[0]
            log(f"== profile oracles {label}: 5 warm train steps")
            profile_steps(lambda: step(*dl_batch[1:], None), 5)
            continue
        step = hec.make_harness(model, opt)[0]
        batch = hec.batch_tensors(coll.collate(idx[:256], 256, device),
                                  device)
        log(f"== profile oracles {label}: 5 warm train steps")
        profile_steps(lambda: step(*batch, None), 5)
        log(f"== profile oracles {label}: 5 warm train steps, each with "
            f"its batch's collation")
        profile_steps(lambda: step(*hec.batch_tensors(
            coll.collate(idx[:256], 256, device), device), None), 5)
    torch.cuda.empty_cache()
    oracle_card_against_cpu(device)
    log(f"== oracles ok in {time.perf_counter() - t0:.1f} s")


# the batched phase: the README commands of the four batched-graph
# workloads, 3 epochs each, at the harnesses' default widths (hidden 64,
# 4 layers) and synthetic sizes
BATCHED_EPOCHS = ["--epochs", "3", "--nruns", "1", "--log-every", "1",
                  "--seed", "0"]
BATCHED_RUNS = (
    ("zinc", ["--norm", "gn", "--jumping-knowledge", "--residual"]),
    ("ogbg_molhiv", ["--virtual-node", "--flag"]),
    ("sbm", ["--dataset", "PATTERN"]),
    ("super_pixel", ["--dataset", "MNIST", "--use-feature"]),
)
# (b): each README model and the other forms, one step card against CPU
BATCHED_MODELS = BATCHED_RUNS + (
    ("zinc", ["--use-edge-feats", "--agg-type", "max"]),
    ("ogbg_molhiv", ["--centrality-encoder", "--use-edge-feats",
                     "--readout-layers", "1", "--jumping-knowledge"]),
    ("ogbg_molhiv", ["--model", "GIN", "--virtual-node"]),
    ("zinc", ["--norm", "cn"]),
    ("zinc", ["--norm", "ln"]),
    ("sbm", ["--model", "GAT"]),
    ("zinc", ["--model", "GIN"]),
)


def batched_module(name):
    import importlib

    return importlib.import_module(
        f"sir_gcn_tpu_torch.experiments.{name}.train")


def batched_setup(name, flags, device, seed: int = 0):
    """The model of ``flags`` for harness ``name`` on ``device`` (weights
    from ``seed``), its first training batch of the default synthetic
    data as a host batch, and (model, batch -> (preds, loss), host batch,
    collection, train indices). Dropout rates are the flags' (0 in
    every flag set here)."""
    import torch

    from sir_gcn_tpu_torch.data import GraphCollection

    mod = batched_module(name)
    args = mod._parser().parse_args(flags)
    gen = torch.Generator().manual_seed(seed)
    if name == "zinc":
        graphs, nf, ef, lab, (tr, _, _), _ = mod.load_zinc(args, seed)
        coll = GraphCollection(graphs, node_feats=nf, edge_feats=ef,
                               labels=lab)
        model = mod.build_model(args, int(max(f.max() for f in nf)) + 1,
                                int(max(f.max() for f in ef)) + 1, gen)
        loss_fn, labels, edge = mod.l1_loss, "labels", args.use_edge_feats
    elif name == "ogbg_molhiv":
        graphs, nf, ef, lab, (tr, _, _), _ = mod.load_molhiv(args, seed)
        coll = GraphCollection(graphs, node_feats=nf, edge_feats=ef,
                               labels=lab)
        deg = (mod.dataset_max_degree(graphs) if args.centrality_encoder
               else args.max_degree)
        model = mod.build_model(args, deg, gen)
        loss_fn, labels, edge = mod.bce, "labels", True
    elif name == "sbm":
        graphs, nf, nl, (tr, _, _), vocab, classes = mod.load_sbm(args, seed)
        coll = GraphCollection(graphs, node_feats=nf, node_labels=nl)
        model = mod.build_model(args, vocab, classes, gen)
        loss_fn = mod.make_weighted_ce(classes)
        labels, edge = "node_labels", False
    else:
        graphs, nf, lab, (tr, _, _) = mod.load_superpixel(args, seed)
        coll = GraphCollection(graphs, node_feats=nf, labels=lab)
        model = mod.build_model(args, nf[0].shape[-1], mod.NUM_CLASSES, gen)
        loss_fn, labels, edge = mod.ce_loss, "labels", False
    weights = "node_weights" if labels == "node_labels" else "graph_weights"
    label_dtype = (torch.int64 if name in ("sbm", "super_pixel")
                   else torch.float32)

    def forward(m, db):
        a = [db["graph"], db["node_feats"]] + (
            [db["edge_feats"]] if edge else [])
        preds = m(*a)
        return preds, loss_fn(preds, db[labels].to(label_dtype),
                              db[weights])

    host = coll.collate(tr[:args.batch_size], args.batch_size)
    return SimpleNamespace(args=args, model=model.to(device),
                           forward=forward, host=host, coll=coll, tr=tr,
                           label_dtype=label_dtype, mod=mod)


def batched_run(name, flags):
    """(a) One README command through the port's entry point, every train
    step timed between device syncs, launch counters at 0 before and read
    after: no kernel may launch (the CSR aggregate, as JAX sends these
    batches to XLA). Logs the run's epochs, seconds, median step, the
    median wait for a prefetched batch and the median collation without
    prefetch, and the peak memory; the test metric must be finite."""
    import torch

    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts

    log(f"== batched (a) {name}: " + " ".join(flags + BATCHED_EPOCHS))
    stats = []
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    _, (test,) = batched_module(name).main(flags + BATCHED_EPOCHS,
                                           stats=stats, time_steps=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    (st,) = stats
    step, wait, coll = st["step_ms"], st["wait_ms"], st["collate_ms"]
    log(f"  {name}: test metric {test!r} after {st['epochs']} epochs in "
        f"{st['seconds']:.2f} s; train step median "
        f"{statistics.median(step):.3f} ms over {len(step)} steps (min "
        f"{min(step):.3f}, max {max(step):.3f}); batch wait with prefetch "
        f"median {statistics.median(wait):.3f} ms over {len(wait)}; "
        f"collation without prefetch median {statistics.median(coll):.3f} "
        f"ms over {len(coll)} (mean {statistics.fmean(coll):.3f}); peak "
        f"memory {peak:.3f} GiB; kernel launches {launches}")
    if launches:
        raise AssertionError(f"{name}: the CSR route launched {launches}")
    if not math.isfinite(test):
        raise AssertionError(f"{name}: test metric {test!r}")


def batched_profile(name, flags, device):
    """One profiled warm train step of a README command's model on its
    first batch, then the same with the batch's collation and copies in
    each step; with --flag the FLAG step."""
    import torch

    from sir_gcn_tpu_torch.experiments.batched_harness import to_device
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.train import make_adamw

    s = batched_setup(name, flags, device)
    opt = make_adamw(s.model.parameters(), 1e-3)
    gen = torch.Generator(device=device).manual_seed(0)
    if name == "ogbg_molhiv":
        flag_step = s.mod.make_train_step(s.model, opt, s.args)

        def step(db):
            flag_step(db, gen)
    else:
        def step(db):
            s.model.train()
            opt.zero_grad(set_to_none=True)
            s.forward(s.model, db)[1].backward()
            opt.step()

    db = to_device(s.host, device, s.label_dtype)
    bs = s.args.batch_size
    reset_launch_counts()
    log(f"== profile batched {name}: 5 warm train steps")
    profile_steps(lambda: step(db), 5)
    log(f"== profile batched {name}: 5 warm train steps, each with its "
        f"batch's collation and copies")
    profile_steps(lambda: step(to_device(s.coll.collate(s.tr[:bs], bs),
                                         device, s.label_dtype)), 5)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    if launches:
        raise AssertionError(f"{name}: the profiled steps launched "
                             f"{launches}")


def batched_card_against_cpu(device):
    """(b) Each model of BATCHED_MODELS at full width on its harness's
    first training batch: forward and backward of the harness's loss on
    the CPU and twice on the card from the same weights (seed 0), dropout
    off, in training mode. The card's first run is under
    ``torch.use_deterministic_algorithms``, whose index_add sums each
    segment in the CPU's order: out and loss at FWD_TOL, every weight
    gradient at GW_TOL. The second takes the atomic adds the training
    runs take: out and loss at FWD_TOL, and the gradients' largest
    difference logged with the tensors past GW_TOL, not held to it: in
    the atomics' order a sum can round to the other side of the leaky
    kink at an input within rounding of 0, which scales that one entry's
    gradient by 0.2 or 5 (seen on the zinc GraphNorm model). Neither card
    run launches a kernel of the port (c)."""
    import copy

    import torch

    from sir_gcn_tpu_torch.experiments.batched_harness import to_device
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts

    cpu = torch.device("cpu")
    log("== batched (b): one step card against CPU")
    for name, flags in BATCHED_MODELS:
        s = batched_setup(name, flags, cpu)
        label = f"{name} {' '.join(flags)}"
        runs = {}
        for run, dev in (("cpu", cpu), ("ordered", device),
                         ("atomic", device)):
            torch.use_deterministic_algorithms(run == "ordered",
                                               warn_only=True)
            m = copy.deepcopy(s.model).to(dev).train()
            reset_launch_counts()
            out, loss = s.forward(m, to_device(s.host, dev, s.label_dtype))
            loss.backward()
            if dev.type == "cuda":
                torch.cuda.synchronize()
                launches = {k: v for k, v in LAUNCHES.items() if v}
                if launches:
                    raise AssertionError(f"{label}: launched {launches}")
            runs[run] = (out.detach().cpu(), loss.detach().cpu(),
                         {k: p.grad.cpu() for k, p in m.named_parameters()
                          if p.grad is not None})
        torch.use_deterministic_algorithms(False)
        o_c, l_c, g_c = runs["cpu"]
        log(f"  {label}: out {tuple(o_c.shape)}, card launches none")
        for run in ("ordered", "atomic"):
            o_g, l_g, g_g = runs[run]
            if set(g_c) != set(g_g):
                raise AssertionError(f"{label}: gradients of {sorted(g_c)} "
                                     f"on the CPU, {sorted(g_g)} on the "
                                     f"card")
            compare(f"{label} {run} out", o_g, o_c, FWD_TOL)
            compare(f"{label} {run} loss", l_g[None], l_c[None], FWD_TOL)
            if run == "ordered":
                errs = {k: compare(f"{label} grad {k}", g_g[k], g_c[k],
                                   GW_TOL, quiet=True) for k in g_c}
            else:
                errs = {k: float((g_g[k] - g_c[k]).abs().max())
                        for k in g_c}
                past = [k for k in g_c if not gw_within(g_g[k], g_c[k])]
            worst = max(errs, key=errs.get)
            log(f"  {label} {run}: {len(errs)} weight gradients, the "
                f"largest abs err {errs[worst]:.3e} ({worst})"
                + (" within GW_TOL" if run == "ordered" else
                   f"; past GW_TOL: {past or 'none'}"))


def gw_within(got, want) -> bool:
    """``got`` within GW_TOL of ``want``, as ``compare`` holds it."""
    diff = (got.float() - want.float()).abs()
    atol = GW_TOL["atol"] + GW_TOL["amax"] * float(want.abs().max())
    return bool((diff <= atol + GW_TOL["rtol"] * want.abs()).all())


def phase_batched(device):
    """The batched-graph workloads on the card: (a) the four README
    commands through their entry points, 3 epochs each, with (c) their
    kernel launches at 0, and a profiled train step of each; (b) the
    models one step card against CPU."""
    import torch

    t0 = time.perf_counter()
    for name, flags in BATCHED_RUNS:
        batched_run(name, flags)
    for name, flags in BATCHED_RUNS:
        batched_profile(name, flags, device)
    torch.cuda.empty_cache()
    batched_card_against_cpu(device)
    log(f"== batched ok in {time.perf_counter() - t0:.1f} s")


# the fullgraph phase: the README commands of the two full-graph workloads
# through their entry points, on their synthetic stand-ins at the
# published datasets' sizes (nodes; directed edges, each undirected edge
# both ways): minesweeper 10,000 and 39,402 and roman-empire 22,662 and
# 32,927 (Platonov et al. 2023, Table 1), wiki-cs 11,701 and 431,726
# (DGL's WikiCSDataset)
FULLGRAPH_FLAGS = ["--nsplits", "1", "--nruns", "1", "--log-every", "1",
                   "--seed", "0"]
MINESWEEPER = ["--synthetic-nodes", "10000", "--synthetic-edges", "78804"]
ROMAN_EMPIRE = ["--synthetic-nodes", "22662", "--synthetic-edges", "65854"]
WIKI_CS = ["--synthetic-nodes", "11701", "--synthetic-edges", "431726"]
# (label, harness, flags, launches a train step and an eval): hidden 512
# and 5 layers (heterophilous), 64 and 4 (wiki-cs); the kernels launch once
# a layer in the step (forward and backward) and in the eval
FULLGRAPH_RUNS = (
    ("b", "heterophilous", ["--dataset", "roman-empire", "--agg-type",
                            "max", "--epochs", "3"] + ROMAN_EMPIRE,
     (dict(ell_max_fwd=5, ell_max_wincount=5, ell_max_bwd=5,
           ell_scaled_reduce=5), dict(ell_max_fwd=5))),
    ("a", "heterophilous", ["--dataset", "minesweeper", "--use-amp",
                            "--epochs", "5"] + MINESWEEPER,
     (dict(ell_act_reduce2=5, ell_src_bwd=5), dict(ell_act_reduce=5))),
    ("c", "wiki_cs", ["--jumping-knowledge", "--resid-layers", "1",
                      "--epochs", "5"] + WIKI_CS,
     (dict(ell_act_reduce2=4, ell_src_bwd=4), dict(ell_act_reduce=4))),
    ("c GAT", "wiki_cs", ["--jumping-knowledge", "--resid-layers", "1",
                          "--model", "GAT", "--epochs", "5"] + WIKI_CS,
     ({}, {})),
)


def fullgraph_module(name):
    import importlib

    return importlib.import_module(
        f"sir_gcn_tpu_torch.experiments.{name}.train")


def fullgraph_run(label, name, flags, per_epoch) -> dict:
    """One README command through the port's entry point, every train
    step and eval timed between device syncs, the launch counters at 0
    before and read after: each kernel must have launched exactly its
    ``per_epoch`` (train step, eval) counts times the epochs. Logs the
    epochs, the run's seconds, the median step and eval, the peak memory
    and the test metric, which must be finite. Returns the launches."""
    import torch

    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts

    flags = flags + FULLGRAPH_FLAGS
    log(f"== fullgraph ({label}) {name}: " + " ".join(flags))
    stats = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    _, (test,) = fullgraph_module(name).main(flags, stats=stats,
                                            time_steps=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    (st,) = stats
    step, ev = st["step_ms"], st["eval_ms"]
    log(f"  ({label}) test metric {test!r} after {st['epochs']} epochs in "
        f"{st['seconds']:.2f} s; train step median "
        f"{statistics.median(step):.3f} ms (first {step[0]:.3f}, min "
        f"{min(step):.3f}, max {max(step):.3f}); eval median "
        f"{statistics.median(ev):.3f} ms (first {ev[0]:.3f}); peak memory "
        f"{peak:.3f} GiB; launches {launches}")
    epochs = st["epochs"]
    want = {}
    for counts in per_epoch:
        for k, v in counts.items():
            want[k] = want.get(k, 0) + v * epochs
    if launches != want:
        raise AssertionError(f"({label}) launch counts {launches}, "
                             f"expected {want}")
    if not math.isfinite(test):
        raise AssertionError(f"({label}) test metric {test!r}")
    return launches


def fullgraph_profile(device, label: str):
    """One profiled warm train step of (``label``)'s model of
    FULLGRAPH_RUNS (heterophilous: (a) minesweeper, --use-amp, hidden 512,
    5 layers; (b) roman-empire, --agg-type max, the max kernels' wide
    path) on its graph: device time by kernel, the idle share."""
    import torch

    from sir_gcn_tpu_torch.experiments import fullgraph_harness as fh
    from sir_gcn_tpu_torch.train import make_adamw

    het = fullgraph_module("heterophilous")
    flags = next(f for lab, _, f, _ in FULLGRAPH_RUNS if lab == label)
    args = het._parser().parse_args(flags + FULLGRAPH_FLAGS)
    run = het.prepare(args, 0, 0, device)
    model = het.build_model(args, run["feats"].shape[1], run["num_classes"],
                            torch.Generator().manual_seed(0)).to(device)
    opt = make_adamw(model.parameters(), args.lr, args.wd)
    feats = torch.from_numpy(run["feats"]).to(device)
    labels = torch.from_numpy(run["labels"]).to(device)
    w = torch.from_numpy(run["masks"][0]).to(device)
    loss = fh.masked_bce_logits if run["num_classes"] == 1 else fh.masked_ce

    def step():
        model.train()
        opt.zero_grad(set_to_none=True)
        loss(model(run["graph"], feats), labels, w).backward()
        opt.step()

    log(f"== profile fullgraph ({label}): 3 warm train steps")
    profile_steps(step, 3)


def fullgraph_card_against_cpu(device):
    """(d) One training-mode forward and backward on the card (kernels)
    and on the CPU (plain versions) from the same weights (seed 0),
    dropout off: the heterophilous SIRModel (2 layers, hidden 512, ln,
    residual, use_bf16) with mean and with max, on a graph of 5,000 nodes
    and 39,402 edges (homophily 0.15, 128 features); wiki-cs's JK
    GraphSIRModel and the GATv2 GATModel of its README commands on 5,000
    nodes and 40,000 edges (300 features). The masked loss and the logits
    at FWD_TOL, every parameter gradient at GW_TOL (sums over the nodes);
    the card's launches exactly those of one step. GATModel's attention
    sums by index_add; it runs under torch.use_deterministic_algorithms so
    that its sums take the CPU's order, as the batched phase's (b)."""
    import copy

    import torch

    from sir_gcn_tpu_torch import build_fast_graph, build_graph
    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments import fullgraph_harness as fh
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype

    log("== fullgraph (d): one step card against CPU")
    set_edge_dtype(None)
    het, wiki = fullgraph_module("heterophilous"), fullgraph_module("wiki_cs")
    hargs = het._parser().parse_args(["--nlayers", "2", "--norm", "ln",
                                      "--residual", "--use-amp"])
    wflags = ["--jumping-knowledge", "--resid-layers", "1"]
    cases = []
    for agg, want in (("mean", dict(ell_act_reduce2=2, ell_src_bwd=2)),
                      ("max", dict(ell_max_fwd=2, ell_max_wincount=2,
                                   ell_max_bwd=2, ell_scaled_reduce=2))):
        hargs.agg_type = agg
        cases.append((f"heterophilous {agg}", het.build_model(
            hargs, 128, 1, torch.Generator().manual_seed(0)),
            (5000, 39_402, 128, 0.15, 2), fh.masked_bce_logits, want,
            False))
    for model, want in (("SIR", dict(ell_act_reduce2=4, ell_src_bwd=4)),
                        ("GAT", {})):
        wargs = wiki._parser().parse_args(wflags + ["--model", model])
        cases.append((f"wiki-cs {model}", wiki.build_model(
            wargs, 300, 10, torch.Generator().manual_seed(0)),
            (5000, 40_000, 300, 0.6, 10), fh.masked_ce, want,
            model == "GAT"))
    for label, model, (n, e, d, hom, c), loss_fn, want, ordered in cases:
        data = synthetic_node_classification(n, e, feat_dim=d,
                                             num_classes=c, homophily=hom,
                                             seed=0)
        n = data.feat.shape[0]
        runs = []
        for dev in (torch.device("cpu"), device):
            torch.use_deterministic_algorithms(ordered, warn_only=True)
            fg = build_fast_graph(build_graph(data.src, data.dst, n,
                                              pad_multiple=128, device=dev))
            feats = torch.zeros((fg.n_pad, d), device=dev)
            feats[:n] = torch.from_numpy(data.feat).to(dev)
            labels = torch.zeros(fg.n_pad, device=dev,
                                 dtype=torch.float32 if c == 2
                                 else torch.int64)
            labels[:n] = torch.from_numpy(data.labels).to(dev, labels.dtype)
            w = torch.zeros(fg.n_pad, device=dev)
            w[torch.from_numpy(data.train_idx).to(dev)] = 1.0
            m = copy.deepcopy(model).to(dev).train()
            reset_launch_counts()
            out = m(fg, feats)
            loss = loss_fn(out, labels, w)
            loss.backward()
            if dev.type == "cuda":
                torch.cuda.synchronize()
                launches = {k: v for k, v in LAUNCHES.items() if v}
                if launches != want:
                    raise AssertionError(f"{label}: card launches "
                                         f"{launches}, expected {want}")
            runs.append((out.detach().cpu(), loss.detach().cpu(), {
                k: p.grad.cpu() for k, p in m.named_parameters()
                if p.grad is not None}))
        torch.use_deterministic_algorithms(False)
        (o_c, l_c, g_c), (o_g, l_g, g_g) = runs
        log(f"  {label}: out {tuple(o_c.shape)}, loss card {float(l_g):.6f} "
            f"cpu {float(l_c):.6f}, card launches {want}")
        compare(f"{label} out", o_g, o_c, FWD_TOL)
        compare(f"{label} loss", l_g[None], l_c[None], FWD_TOL)
        if set(g_c) != set(g_g):
            raise AssertionError(f"{label}: gradients differ in keys")
        errs = {k: compare(f"{label} grad {k}", g_g[k], g_c[k], GW_TOL,
                           quiet=True) for k in g_c}
        worst = max(errs, key=errs.get)
        log(f"  {label}: {len(errs)} parameter gradients within GW_TOL, the "
            f"largest abs err {errs[worst]:.3e} ({worst})")


def phase_fullgraph(device) -> dict:
    """The full-graph workloads on the card: (b), (a) and (c) through
    their entry points with exact launch counts, profiled steps of (a) and
    (b),
    and (d) four models one step card against CPU. Returns the erf-GELU
    forms' launches of (a) (#1, #2, #4) and those of (b), #9-#11 on their
    wide path (required)."""
    import torch

    log_max_layout("fullgraph (b)", HETERO_H, HETERO_H, require="wide")
    t0 = time.perf_counter()
    runs = {label: fullgraph_run(label, name, flags, per_epoch)
            for label, name, flags, per_epoch in FULLGRAPH_RUNS}
    for label in ("a", "b"):
        fullgraph_profile(device, label)
    torch.cuda.empty_cache()
    fullgraph_card_against_cpu(device)
    log(f"== fullgraph ok in {time.perf_counter() - t0:.1f} s")
    return ({k: runs["a"].get(k, 0) for k in LINEAR},
            {k: runs["b"].get(k, 0) for k in MAX[:3]})


# the bot phase: the reference's best arxiv pipeline on the train phase's
# configuration (TRAIN_FLAGS, sym): a teacher with the label trick, label
# reuse (1 iteration), mask-rate 0.5 and FLAG (m = 3) saving its
# predictions, a student learning from them by KD, and C&S on both
BOT_FLAGS = ["--use-labels", "--label-iters", "1", "--mask-rate", "0.5",
             "--flag", "--m", "3"]
CS_FLAGS = ["--use-sym", "--add-reverse-edge", "--add-self-loop",
            "--synthetic-nodes", str(ARXIV_NODES), "--synthetic-edges",
            str(ARXIV_EDGES)]


def bot_launches(steps: int, m: int = 3, reuse: int = 1,
                 layers: int = 3) -> dict:
    """Launches of ``steps`` bag-of-tricks steps and evals: each of a
    step's m + 1 FLAG passes runs ``reuse`` forwards without a gradient
    (#1 a layer) and one with (#2), then its backward (#4); the eval runs
    reuse + 1 forwards without a gradient."""
    want = dict.fromkeys(KERNELS, 0)
    passes = m + 1
    want.update(ell_act_reduce=steps * layers * (passes * reuse + reuse + 1),
                ell_act_reduce2=steps * layers * passes,
                ell_src_bwd=steps * layers * passes)
    return want


def bot_run(label, main, flags, want=None):
    """One entry point's run on the card, the launch counters at 0 before
    and read after (exactly ``want`` if given); logs its steady step, eval,
    peak memory and plan seconds. Returns the run's results."""
    import torch

    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts

    log(f"== bot {label}: " + " ".join(flags))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = main(flags)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    r = results[0]
    if "train_losses" in r:
        steps = r["step_seconds"]
        steady = (1e3 * statistics.median(steps[1:]) if len(steps) > 1
                  else float("nan"))
        log(f"  {label}: {len(steps)} epochs in {seconds:.1f} s, plan "
            f"{r['plan_seconds']:.2f} s; train step ms "
            f"{[round(s * 1e3, 3) for s in steps]} (steady {steady:.3f}), "
            f"eval ms {[round(s * 1e3, 3) for s in r['eval_seconds']]}, "
            f"peak {peak:.3f} GiB; losses {r['train_losses']}; val_acc "
            f"{r['val_acc']:.6f}, test_acc {r['test_acc']:.6f}")
        if not all(math.isfinite(x) for x in r["train_losses"]):
            raise AssertionError(f"{label}: non-finite training loss")
    else:
        log(f"  {label}: {seconds:.1f} s, peak {peak:.3f} GiB: {results}")
    nonzero = {k: v for k, v in launches.items() if v}
    log(f"  {label}: launches {nonzero}")
    if want is not None and launches != want:
        raise AssertionError(f"{label}: launch counts {nonzero}, expected "
                             f"{ {k: v for k, v in want.items() if v} }")
    return results


def bot_resume(workdir):
    """(d) The teacher's configuration at one layer: 4 epochs straight,
    then 2 epochs with a checkpoint and a resume to 4; the resumed run
    must give the straight run's losses, metrics and logits bit for bit
    (the kernels and every other op of the step repeat their bits on the
    card, and the checkpoint restores the model, AdamW, the plateau, the
    best selection, the dropout generator and the mask-rate draws)."""
    import numpy as np

    from sir_gcn_tpu_torch.experiments.ogbn_arxiv import train

    flags = flags_for("sym") + BOT_FLAGS + ["--nlayers", "1"]
    ck = ["--ckpt-dir", os.path.join(workdir, "ck"), "--ckpt-every", "2"]

    def epochs(n):
        return flags + ["--epochs", str(n)]

    (a,) = bot_run("(d) 4 epochs straight", train.main, epochs(4),
                   bot_launches(4, layers=1))
    bot_run("(d) 2 epochs, checkpoint", train.main, epochs(2) + ck,
            bot_launches(2, layers=1))
    (b,) = bot_run("(d) resume to 4", train.main,
                   epochs(4) + ck + ["--resume"], bot_launches(2, layers=1))
    same = (b["train_losses"] == a["train_losses"][2:]
            and all(b[k] == a[k] for k in train.METRIC_KEYS)
            and np.array_equal(b["logits"], a["logits"]))
    log(f"  (d) resumed losses {b['train_losses']} against "
        f"{a['train_losses'][2:]}: bitwise {'equal' if same else 'UNEQUAL'}")
    if not same:
        raise AssertionError("(d) the resumed run is not the straight one")


def bot_card_against_cpu(device):
    """(e) One FLAG (m = 3) + label reuse + KD step of the teacher's model
    (3 layers, H = 96, bn, residual, sym, f32 edges, dropout 0) on a
    2,000-node graph on the card (kernels) and on the CPU (plain versions),
    from the same weights, masks, teacher and initial perturbation: the
    loss, the parameters after AdamW (entries with |g| >= 1e-6: Adam's
    first step is about lr * sign(g)) and the BatchNorm statistics at
    FWD_TOL; the eval logits with reuse from the CPU's updated state at
    FWD_TOL; the last perturbation (steps 1e-3 and 5e-4) at FWD_TOL but
    for entries a near-zero gradient's sign moved by a whole step, which
    must be under 0.1% of them."""
    import copy

    import numpy as np
    import torch

    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv import train
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.train import (
        make_adamw,
        set_lr_scale,
        warmup_scale,
    )

    log("== bot (e): one FLAG + label reuse + KD step, card against CPU")
    args = train.get_args(flags_for("sym") + BOT_FLAGS + [
        "--kd-mode", "student", "--dropout", "0", "--feat-dropout", "0",
        "--train-step-size", "1e-3", "--untrain-step-size", "5e-4"])
    set_edge_dtype(None)
    data = synthetic_node_classification(2000, 12_000, feat_dim=128,
                                         num_classes=40, seed=1)
    cpu = torch.device("cpu")
    graphs = {d: train.build_arxiv_graph(data, args, d)
              for d in (cpu, device)}
    n_pad = graphs[cpu].n_pad
    rng = np.random.default_rng(1)

    def mask_of(idx):
        w = np.zeros(n_pad, np.float32)
        w[idx] = 1.0
        return w

    feats = np.zeros((n_pad, 128), np.float32)
    feats[:2000] = data.feat
    labels = np.zeros(n_pad, np.int64)
    labels[:2000] = data.labels
    train_w = mask_of(data.train_idx)
    sub = rng.random(len(data.train_idx)) < args.mask_rate
    labeled = mask_of(data.train_idx[~sub])
    rest = np.clip(mask_of(data.val_idx) + mask_of(data.test_idx), 0, 1)
    teacher = rng.random((n_pad, 40)).astype(np.float32)
    teacher /= teacher.sum(-1, keepdims=True)
    u = args.untrain_step_size
    p0 = (rng.uniform(-u, u, (n_pad, 128)) * np.where(
        train_w[:, None] > 0, args.train_step_size / u, 1.0)).astype(
        np.float32)
    arrays = dict(feats=feats, labels=labels, loss_w=mask_of(
        data.train_idx[sub]), labeled=labeled,
        unlabeled=np.clip(train_w - labeled + rest, 0, 1),
        train_mask=train_w > 0, kd_teacher=teacher, perturb=p0,
        eval_labeled=train_w, eval_unlabeled=rest)
    model = train.build_model(args, 168, 40,
                              torch.Generator().manual_seed(0))
    runs = []
    for d in (cpu, device):
        t = {k: torch.from_numpy(v).to(d) for k, v in arrays.items()}
        m = copy.deepcopy(model).to(d)
        opt = make_adamw(m.parameters(), args.lr, args.wd)
        set_lr_scale(opt, warmup_scale(1, train.WARMUP))
        step, ev = train.make_harness(m, graphs[d], opt, args, 40)
        loss, pert = step(t["feats"], t["labels"], t["loss_w"], None,
                          labeled=t["labeled"], unlabeled=t["unlabeled"],
                          train_mask=t["train_mask"],
                          kd_teacher=t["kd_teacher"], perturb=t["perturb"])
        runs.append(dict(m=m, ev=ev, t=t, loss=loss.cpu(),
                            pert=pert.cpu(), state={
                                k: v.detach().cpu()
                                for k, v in m.state_dict().items()},
                            grads={k: p.grad.cpu()
                                   for k, p in m.named_parameters()}))
    c, g = runs
    compare("(e) loss", g["loss"][None], c["loss"][None], FWD_TOL)
    held = 0
    for k, want in c["state"].items():
        keep = (c["grads"][k].abs() >= 1e-6 if k in c["grads"]
                else torch.ones_like(want, dtype=torch.bool))
        if keep.any():
            compare(f"(e) {k}", g["state"][k][keep], want[keep], FWD_TOL,
                    quiet=True)
            held += int(keep.sum())
    log(f"  (e) {held} entries of {len(c['state'])} parameters and "
        f"statistics within FWD_TOL")
    diff = (g["pert"] - c["pert"]).abs()
    bad = diff > FWD_TOL["atol"] + FWD_TOL["rtol"] * c["pert"].abs()
    step = torch.where(c["t"]["train_mask"][:, None],
                       args.train_step_size, args.untrain_step_size)
    whole = (diff / (2 * step)).round() * (2 * step)
    flips = bool((whole[bad] - diff[bad]).abs().le(1e-6).all())
    log(f"  (e) perturbation: {int(bad.sum())} of {bad.numel()} entries "
        f"beyond FWD_TOL, each a whole step apart: {flips}")
    if not flips or int(bad.sum()) > bad.numel() // 1000:
        raise AssertionError("(e) the perturbations disagree")
    g["m"].load_state_dict(c["m"].state_dict())
    logits = [r["ev"](*(r["t"][k] for k in ("feats", "labels",
                                           "eval_labeled",
                                           "eval_unlabeled"))).cpu()
              for r in (c, g)]
    compare("(e) eval logits with reuse", logits[1], logits[0], FWD_TOL)


def bot_segment_sum(device):
    """(g) The CSR aggregate on the oracles' HEC batch (634,880 edges, 559k
    of them padding on one node): two calls give the same bits, forward
    and gradients; then the batch's segment sum of its [E, 20] messages,
    forward and backward, timed in alternating turns beside index_add's
    (its atomics, the sum before the fixed order)."""
    import torch

    from sir_gcn_tpu_torch.experiments.hetero_edge_count import train as hec
    from sir_gcn_tpu_torch.ops import message_passing as mp
    from sir_gcn_tpu_torch.ops import segment as seg
    from sir_gcn_tpu_torch.tools import alternating_ms, verdict

    log("== bot (g): the fixed-order segment sum on the HEC batch")
    _, coll, idx = oracle_batches(device)
    graph = hec.batch_tensors(coll.collate(idx[:256], 256, device),
                              device)[0]
    gen = torch.Generator(device=device).manual_seed(0)
    eq0 = torch.randn(graph.n_pad, 20, device=device, generator=gen)
    ek0 = torch.randn(graph.n_pad, 20, device=device, generator=gen)
    runs = []
    for _ in range(2):
        eq, ek = (x.clone().requires_grad_() for x in (eq0, ek0))
        out = mp.sir_aggregate(graph, eq, ek, torch.relu, "sum")
        out.square().sum().backward()
        runs.append((out.detach(), eq.grad, ek.grad))
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log(f"  (g) e_pad {graph.e_pad}, real edges {graph.num_edges}: two "
        f"calls bitwise {'equal' if same else 'UNEQUAL'}")
    if not same:
        raise AssertionError("(g) the CSR aggregate is not repeatable")
    msg = torch.randn(graph.e_pad, 20, device=device, generator=gen,
                      requires_grad=True)
    n, dst = graph.n_pad, graph.dst

    def index_add():
        msg.grad = None
        msg.new_zeros(n, 20).index_add(0, dst, msg).sum().backward()

    def fixed():
        msg.grad = None
        seg.segment_sum(msg, graph.dst_segments, n).sum().backward()

    ms = alternating_ms({"fixed order": fixed, "index_add": index_add},
                        20, 4)
    log("  (g) sum forward and backward, 4 turns of 20: " + ", ".join(
        f"{k} median {statistics.median(v):.4f} ms [{min(v):.4f}-"
        f"{max(v):.4f}]" for k, v in ms.items())
        + f": fixed order {verdict(ms['fixed order'], ms['index_add'])}")


def phase_bot(device):
    """The bag of tricks on the card through the entry points: (a) the
    teacher and (b) the student at full width (5 epochs each, exact
    launches), (c) C&S on both, (d) checkpoint resume, (e) a step card
    against CPU, (f) --no-fast-path launching no kernel, (g) the segment
    sum's repeatability."""
    import tempfile

    import torch

    from sir_gcn_tpu_torch.experiments.ogbn_arxiv import correct_and_smooth
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv import train

    t0 = time.perf_counter()
    here = os.getcwd()
    flags = flags_for("sym") + BOT_FLAGS + ["--save-pred"]
    with tempfile.TemporaryDirectory() as workdir:
        os.chdir(workdir)
        try:
            bot_run("(a) teacher", train.main, flags, bot_launches(5))
            bot_run("(b) student", train.main,
                    flags + ["--kd-mode", "student"], bot_launches(5))
            t_cs = time.perf_counter()
            res = bot_run("(c) C&S", correct_and_smooth.main, CS_FLAGS,
                          dict.fromkeys(KERNELS, 0))
            log(f"  (c) {time.perf_counter() - t_cs:.1f} s for "
                f"{len(res)} files")
            if len(res) != 2 or not all(
                    0.0 <= r[k] <= 1.0 for r in res for k in r):
                raise AssertionError(f"(c) C&S results {res}")
            bot_resume(workdir)
        finally:
            os.chdir(here)
    torch.cuda.empty_cache()
    bot_card_against_cpu(device)
    bot_run("(f) --no-fast-path", train.main,
            flags_for("sym") + ["--no-fast-path", "--epochs", "2"],
            dict.fromkeys(KERNELS, 0))
    torch.cuda.empty_cache()
    bot_segment_sum(device)
    log(f"== bot ok in {time.perf_counter() - t0:.1f} s")


DIST_SHARDS = 4


def dist_plans():
    """(a) of the dist phase: the bench graph (random, bidirected, with
    self-loops, padded to 128 x DIST_SHARDS nodes) on the host, its dst and
    src plans from the native planner and from NumPy, array-equal; then
    the halo and all-gather plans of DIST_SHARDS shards (sym)."""
    import numpy as np

    from bench_torch import E_RAW, N, bench_edges
    from sir_gcn_tpu_torch import build_graph, native
    from sir_gcn_tpu_torch.ops.ell import build_reduce_plan
    from sir_gcn_tpu_torch.parallel.ell_distributed import (
        build_sharded_fast_graph,
    )
    from sir_gcn_tpu_torch.parallel.halo import build_halo_fast_graph

    if not native.available():
        raise AssertionError("(a) the native planner did not build")
    src, dst = bench_edges("random", False, np.random.default_rng(0), N,
                           E_RAW)
    graph = build_graph(src, dst, N, pad_multiple=128 * DIST_SHARDS)
    h = graph.host
    valid = np.asarray(h["edge_mask"], bool)
    log(f"  (a) bench graph: {N} nodes, {graph.num_edges} edges with "
        f"self-loops, n_pad {graph.n_pad}, e_pad {graph.e_pad}; library "
        f"{native.library_path()}")
    for side in ("dst", "src"):
        keys = np.asarray(h[side], np.int64)
        plans, secs = {}, {}
        for name, flag in (("native", True), ("numpy", False)):
            t0 = time.perf_counter()
            plans[name] = build_reduce_plan(keys, valid, graph.n_pad,
                                            native=flag)
            secs[name] = time.perf_counter() - t0
        a, b = plans["native"], plans["numpy"]
        same = (a.host.keys() == b.host.keys() and all(
            np.array_equal(a.host[k], b.host[k]) for k in a.host)
            and (a.buckets1, a.buckets2) == (b.buckets1, b.buckets2))
        log(f"  (a) {side} plan: native {secs['native']:.3f} s, NumPy "
            f"{secs['numpy']:.3f} s, {a.num_slots} slots, array-equal "
            f"{same}")
        if not same:
            raise AssertionError(f"(a) the native {side} plan differs")
    t0 = time.perf_counter()
    hfg = build_halo_fast_graph(graph, DIST_SHARDS, "sym")
    t_halo = time.perf_counter() - t0
    t0 = time.perf_counter()
    sfg = build_sharded_fast_graph(graph, DIST_SHARDS, "sym")
    t_sharded = time.perf_counter() - t0
    boundary = [int(p.host["slot_valid"].sum()) for p in hfg.dst_plan_b]
    interior = [int(p.host["slot_valid"].sum()) for p in hfg.dst_plan_i]
    log(f"  (a) halo plans of {DIST_SHARDS} shards: {t_halo:.2f} s, h_max "
        f"{hfg.h_max} (halo table {hfg.halo_rows} rows a shard against "
        f"{graph.n_pad} gathered), interior edges {interior}, boundary "
        f"edges {boundary}; all-gather plans {t_sharded:.2f} s")
    return graph, hfg, sfg


def dist_ranks(device, graph, hfg, sfg, errs, timing, smi: str):
    """(b) of the dist phase: each of DIST_SHARDS ranks' local forward and
    backward on its own plans, one after another on the one card, the
    exchanged tables assembled here by indexing the whole ek; held against
    the single-card aggregate on the FastGraph. Returns the launches."""
    import numpy as np
    import torch

    from sir_gcn_tpu_torch.ops import message_passing as mp
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.ops.ell import _cast, build_fast_graph, leaky_relu
    from sir_gcn_tpu_torch.parallel import ell_distributed as ed
    from sir_gcn_tpu_torch.parallel import halo as hl

    act, dtype, h, S = leaky_relu(0.2), torch.bfloat16, 96, DIST_SHARDS
    mp.set_edge_dtype(dtype)
    gcard = graph.to(device)
    fg = build_fast_graph(gcard)
    n_local = hfg.n_local
    rows = [slice(r * n_local, (r + 1) * n_local) for r in range(S)]
    gen = torch.Generator(device=device).manual_seed(3)
    eq, ek, g = (torch.randn((graph.n_pad, h), generator=gen, device=device)
                 for _ in range(3))
    mask = torch.from_numpy(np.random.default_rng(4).random(graph.e_pad)
                            >= 0.2).to(device)
    locs = [hl.local_view(hfg, r, device) for r in range(S)]
    slocs = [ed.take_shard(sfg, r, device) for r in range(S)]
    hm = hfg.h_max

    def reference(edge_mask):
        eq_r, ek_r = eq.clone().requires_grad_(), ek.clone().requires_grad_()
        out = mp.sir_aggregate(fg, eq_r, ek_r, act, "sym",
                               edge_mask=edge_mask)
        out.backward(g)
        return out.detach(), eq_r.grad, ek_r.grad

    def halo_ranks(edge_mask, grad=True):
        scales = [hl.halo_slot_scales(loc, gcard, "sym", edge_mask)
                  for loc in locs]
        sends = [hl.halo_send(loc, ek[rows[r]], dtype)
                 for r, loc in enumerate(locs)]
        sends32 = [hl.halo_send(loc, ek[rows[r]])
                   for r, loc in enumerate(locs)]
        out, g_eq, g_halo, g_ek = [], [], [], []
        for r, loc in enumerate(locs):
            # the exchanges: block r of each sender, in bf16 and in f32
            halo = torch.cat([sends[j][r * hm:(r + 1) * hm]
                              for j in range(S)])
            halo32 = torch.cat([sends32[j][r * hm:(r + 1) * hm]
                                for j in range(S)])
            s_i, s_b, s_si, s_hp = scales[r]
            if not grad:
                out.append(hl.halo_local_forward(
                    loc, eq[rows[r]], ek[rows[r]], halo, s_i, s_b, act,
                    dtype, derivative=False))
                continue
            o, sbar = hl.halo_local_forward(loc, eq[rows[r]], ek[rows[r]],
                                            halo, s_i, s_b, act, dtype)
            gi, gh = hl.halo_local_backward(loc, g[rows[r]], eq[rows[r]],
                                            ek[rows[r]], halo32, s_si, s_hp,
                                            act, dtype)
            out.append(o)
            g_eq.append(g[rows[r]] * sbar)
            g_ek.append(gi)
            g_halo.append(gh)
        if not grad:
            return torch.cat(out)
        for r, loc in enumerate(locs):  # the cotangents' return exchange
            ret = torch.cat([g_halo[j][r * hm:(r + 1) * hm]
                             for j in range(S)])
            g_ek[r] = g_ek[r] + hl.halo_return(loc, ret)
        return torch.cat(out), torch.cat(g_eq), torch.cat(g_ek)

    def sharded_ranks(grad=True):
        ek_full = _cast(ek, dtype)  # the all-gathered table
        out, g_eq, g_full = [], [], 0.0
        for r, loc in enumerate(slocs):
            if not grad:
                out.append(ed.sharded_local_forward(loc, eq[rows[r]],
                                                    ek_full, act, False))
                continue
            o, sbar = ed.sharded_local_forward(loc, eq[rows[r]], ek_full,
                                               act, True)
            out.append(o)
            g_eq.append(g[rows[r]] * sbar)
            g_full = g_full + ed.sharded_local_backward(
                loc, g[rows[r]], eq[rows[r]], ek, act, dtype)
        if not grad:
            return torch.cat(out)
        return torch.cat(out), torch.cat(g_eq), g_full  # reduce-scattered

    launches = {}
    for label, run, edge_mask in (
            ("halo", lambda grad=True: halo_ranks(None, grad), None),
            ("halo dropedge", lambda grad=True: halo_ranks(mask, grad), mask),
            ("all-gather", sharded_ranks, None)):
        want = reference(edge_mask)
        torch.cuda.synchronize()
        reset_launch_counts()
        got = run()
        got_ng = run(grad=False)
        torch.cuda.synchronize()
        counts = {k: v for k, v in LAUNCHES.items() if v}
        per_rank = 2 if label.startswith("halo") else 1
        expect = {"ell_act_reduce2": per_rank * S, "ell_src_bwd": per_rank * S,
                  "ell_act_reduce": per_rank * S}
        log(f"  (b) {label}, {S} ranks: launches {counts}")
        if counts != expect:
            raise AssertionError(f"(b) {label} launches {counts}, expected "
                                 f"{expect}")
        launches[label] = counts
        for name, a, b, tol in (("out", got[0], want[0], FWD_TOL),
                                ("out without a gradient", got_ng, want[0],
                                 FWD_TOL),
                                ("g_eq", got[1], want[1], BWD_TOL),
                                ("g_ek", got[2], want[2], BWD_TOL)):
            err = compare(f"(b) {label} {name} against the single card",
                          a, b, tol)
            kernel = {"out": "ell_act_reduce2", "g_ek": "ell_src_bwd",
                      "g_eq": "ell_act_reduce2"}.get(name, "ell_act_reduce")
            errs[f"{kernel}[{label}]"] = max(
                errs.get(f"{kernel}[{label}]", 0.0), err)

    # the time of one rank's local forward and backward (rank 0) beside
    # the single-card aggregate's, in alternating turns
    from sir_gcn_tpu_torch.tools import alternating_ms

    loc, (s_i, s_b, s_si, s_hp) = locs[0], hl.halo_slot_scales(
        locs[0], gcard, "sym", None)
    halo0 = torch.cat([hl.halo_send(locs[j], ek[rows[j]], dtype)[:hm]
                       for j in range(S)])
    halo0_32 = torch.cat([hl.halo_send(locs[j], ek[rows[j]])[:hm]
                          for j in range(S)])
    eq_r, ek_r = eq.clone().requires_grad_(), ek.clone().requires_grad_()

    def single():
        mp.sir_aggregate(fg, eq_r, ek_r, act, "sym").backward(g)

    def rank0():
        hl.halo_local_forward(loc, eq[rows[0]], ek[rows[0]], halo0, s_i,
                              s_b, act, dtype)
        hl.halo_local_backward(loc, g[rows[0]], eq[rows[0]], ek[rows[0]],
                               halo0_32, s_si, s_hp, act, dtype)

    ek_full = _cast(ek, dtype)

    def sharded0():
        ed.sharded_local_forward(slocs[0], eq[rows[0]], ek_full, act, True)
        ed.sharded_local_backward(slocs[0], g[rows[0]], eq[rows[0]], ek,
                                  act, dtype)

    ms = alternating_ms({"single card": single, "halo rank 0": rank0,
                         "all-gather rank 0": sharded0}, 10, 4)
    med = {k: statistics.median(v) for k, v in ms.items()}
    log(f"  (b) forward + backward at {S} shards, 4 turns of 10 ({smi}): "
        + ", ".join(
        f"{k} median {v:.4f} ms [{min(ms[k]):.4f}-{max(ms[k]):.4f}]"
        for k, v in med.items()))
    timing["dist"] = med
    mp.set_edge_dtype(None)
    return launches


def dist_one_rank(device, smi: str):
    """(c) of the dist phase, under a one-rank NCCL group on the card:
    one arxiv-configuration training step through a HaloGraph of one
    shard against the same step on the FastGraph (loss and every weight at
    the tolerances), and one zinc --norm bn step through
    make_dp_train_step_stateful against the single-device step (bitwise,
    under deterministic algorithms)."""
    import copy
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from sir_gcn_tpu_torch.data import GraphCollection, synthetic_molecules
    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv import train
    from sir_gcn_tpu_torch.experiments.zinc.model import make_sir_model
    from sir_gcn_tpu_torch.experiments.zinc.train import l1_loss
    from sir_gcn_tpu_torch.ops import message_passing as mp
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.parallel.data_parallel import (
        make_dp_train_step_stateful,
    )
    from sir_gcn_tpu_torch.parallel.halo import build_halo_graph
    from sir_gcn_tpu_torch.parallel.mesh import make_mesh
    from sir_gcn_tpu_torch.parallel.multihost import initialize_multihost
    from sir_gcn_tpu_torch.train import make_adamw

    with tempfile.TemporaryDirectory() as store:
        initialize_multihost(cpu=False, init_method="file://" + os.path.join(
            store, "store"), rank=0, world_size=1, timeout_s=120)
        try:
            mesh = make_mesh((1,), ("graph",), "cuda")
            log(f"  (c) process group: {dist.get_backend()}, "
                f"{dist.get_world_size()} rank on {device}; mesh {mesh}")
            args = train.get_args(flags_for("sym"))
            mp.set_edge_dtype(torch.bfloat16)
            data = synthetic_node_classification(
                ARXIV_NODES, ARXIV_EDGES, feat_dim=128, num_classes=40,
                seed=0)
            fg = train.build_arxiv_graph(data, args, device)
            graphs = {"FastGraph": fg,
                      "HaloGraph": build_halo_graph(
                          fg.graph, 1, mesh.get_group("graph"), "sym")}
            feats, labels, w = step_inputs(data, fg.n_pad, device)
            results = {}
            for name, graph in graphs.items():
                model = train.build_model(args, 128, 40, torch.Generator()
                                          .manual_seed(0)).to(device)
                opt = make_adamw(model.parameters(), args.lr, args.wd)
                step, _ = train.make_harness(model, graph, opt, args, 40)
                gen = torch.Generator(device=device).manual_seed(0)
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.perf_counter()
                loss, _ = step(feats, labels, w, gen)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                counts = {k: v for k, v in LAUNCHES.items() if v}
                results[name] = (float(loss), {
                    k: v.detach().clone() for k, v in model.state_dict()
                    .items()})
                log(f"  (c) arxiv step on the {name}: loss "
                    f"{float(loss):.6f}, {dt * 1e3:.1f} ms (first step; "
                    f"{smi}), launches {counts}")
                layers = args.nlayers
                per = 2 if name == "HaloGraph" else 1
                want = {"ell_act_reduce2": per * layers,
                        "ell_src_bwd": per * layers}
                if counts != want:
                    raise AssertionError(f"(c) {name} launches {counts}, "
                                         f"expected {want}")
            (l_f, w_f), (l_h, w_h) = results.values()
            compare("(c) halo step loss", torch.tensor([l_h]),
                    torch.tensor([l_f]), FWD_TOL)
            err = max(compare(f"(c) halo step {k}", w_h[k], w_f[k], BWD_TOL,
                              quiet=True) for k in w_f
                      if w_f[k].is_floating_point())
            log(f"  (c) every weight after the step within BWD_TOL, max abs "
                f"err {err:.3e}")
            mp.set_edge_dtype(None)

            g_, nf, ef, lab = synthetic_molecules(64, seed=0)
            coll = GraphCollection(g_, node_feats=nf, edge_feats=ef,
                                   labels=lab)
            batch = coll.collate(np.arange(64), 64, device)
            model = make_sir_model(28, 4, 64, 1, num_layers=4, norm="bn",
                                   generator=torch.Generator().manual_seed(0)
                                   ).to(device)
            twin = copy.deepcopy(model)

            def loss_fn(m, b, gen):
                preds = m(b["graph"],
                          torch.from_numpy(b["node_feats"]).to(device),
                          torch.from_numpy(b["edge_feats"]).to(device),
                          generator=gen)
                return l1_loss(preds,
                               torch.from_numpy(b["labels"]).to(device),
                               torch.from_numpy(b["graph_weights"])
                               .to(device))

            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                opt = make_adamw(model.parameters(), 1e-3)
                opt.zero_grad()
                loss_fn(model, batch, None).backward()
                opt.step()
                dp = make_dp_train_step_stateful(
                    twin, loss_fn, make_adamw(twin.parameters(), 1e-3))
                dp(batch)
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
            a, b = model.state_dict(), twin.state_dict()
            same = all(torch.equal(a[k], b[k]) for k in a)
            log(f"  (c) zinc --norm bn step through "
                f"make_dp_train_step_stateful: {len(a)} weights and buffers "
                f"bitwise {'equal' if same else 'UNEQUAL'} to the "
                f"single-device step")
            if not same:
                raise AssertionError("(c) the one-rank data-parallel step "
                                     "differs from the single-device step")
        finally:
            dist.destroy_process_group()


def phase_dist(device, errs, timing, smi: str):
    """The multi-GPU slice on the one card: (a) the native planner against
    NumPy at the bench graph, and the halo and all-gather plans of 4
    shards; (b) each rank's local forward and backward on #2 and #4 (and
    #1 without a gradient) on its own plans, held against the single-card
    aggregate, static and DropEdge scales; (c) one-rank NCCL steps."""
    import torch

    t0 = time.perf_counter()
    log(f"== dist: {DIST_SHARDS} shards rank by rank on one card, then a "
        f"one-rank NCCL group")
    graph, hfg, sfg = dist_plans()
    launches = dist_ranks(device, graph, hfg, sfg, errs, timing, smi)
    del graph, hfg, sfg
    torch.cuda.empty_cache()
    dist_one_rank(device, smi)
    torch.cuda.empty_cache()
    log(f"== dist ok in {time.perf_counter() - t0:.1f} s")
    return launches


# the gspmd phase: the row-sharded full graph (parallel/full_graph.py) at
# the fullgraph phase's published sizes; GSPMD_SHARDS ranks for (b)
GSPMD_SHARDS = 4
GSPMD_RUNS = (
    ("heterophilous roman-empire max", "heterophilous",
     ["--dataset", "roman-empire", "--agg-type", "max", "--epochs", "3"]
     + ROMAN_EMPIRE),
    ("wiki-cs GAT", "wiki_cs",
     ["--jumping-knowledge", "--resid-layers", "1", "--model", "GAT",
      "--epochs", "3"] + WIKI_CS),
)

# (b)'s layers: (nodes, edges, input width) of their graphs
GSPMD_LAYERS = {"SIRConv max H = O = 512": (22_662, 65_854, 512),
                "GATv2 wiki-cs layer": (11_701, 431_726, 300)}


def gspmd_trainer_runs(device, smi: str):
    """(a) of the gspmd phase, under a one-rank NCCL group: each of
    GSPMD_RUNS through its trainer's ``run_single`` twice, on the plain
    graph (``--no-fast-path``) and on a one-shard ShardedGraph of it (the
    trainer's ``prepare`` wrapped to hand over the rank's graph): the
    epochs' step and eval (synced), the peak memory, no launch of any
    kernel of the port, and the best epoch's losses of the two within
    FWD_TOL."""
    import tempfile

    import torch
    import torch.distributed as dist

    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
    from sir_gcn_tpu_torch.parallel.full_graph import (
        ShardedGraph,
        shard_full_graph,
    )
    from sir_gcn_tpu_torch.parallel.mesh import make_mesh
    from sir_gcn_tpu_torch.parallel.multihost import initialize_multihost

    set_edge_dtype(None)
    with tempfile.TemporaryDirectory() as store:
        initialize_multihost(cpu=False, init_method="file://" + os.path.join(
            store, "store"), rank=0, world_size=1, timeout_s=120)
        try:
            group = make_mesh((1,), ("graph",), "cuda").get_group("graph")
            log(f"  (a) process group: {dist.get_backend()}, "
                f"{dist.get_world_size()} rank on {device}")
            for label, name, flags in GSPMD_RUNS:
                module = fullgraph_module(name)
                args = module._parser().parse_args(
                    flags + FULLGRAPH_FLAGS + ["--no-fast-path"])
                prepare = module.prepare
                best, made = {}, []
                for kind in ("plain graph", "row-sharded graph"):
                    def sharded(*a, **k):
                        run = prepare(*a, **k)
                        run["graph"] = shard_full_graph(run["graph"], 1, 0,
                                                        group)
                        made.append(type(run["graph"]))
                        return run

                    module.prepare = (prepare if kind == "plain graph"
                                      else sharded)
                    stats = {}
                    try:
                        torch.cuda.synchronize()
                        torch.cuda.empty_cache()
                        torch.cuda.reset_peak_memory_stats()
                        reset_launch_counts()
                        best[kind] = module.run_single(
                            args, 0, 0, device, stats, time_steps=True)
                        torch.cuda.synchronize()
                    finally:
                        module.prepare = prepare
                    launches = {k: v for k, v in LAUNCHES.items() if v}
                    peak = torch.cuda.max_memory_allocated() / 2 ** 30
                    step, ev = stats["step_ms"], stats["eval_ms"]
                    log(f"  (a) {label} on the {kind}: "
                        f"{stats['epochs']} epochs in "
                        f"{stats['seconds']:.2f} s; train step median "
                        f"{statistics.median(step):.3f} ms (first "
                        f"{step[0]:.3f}), eval median "
                        f"{statistics.median(ev):.3f} ms (first "
                        f"{ev[0]:.3f}); peak memory {peak:.3f} GiB "
                        f"({smi}); best epoch's loss "
                        f"{best[kind]['loss']:.6f}, val_loss "
                        f"{best[kind]['val_loss']:.6f}, test metric "
                        f"{best[kind]['test_metric']!r}; launches "
                        f"{launches}")
                    if launches:
                        raise AssertionError(f"(a) {label}: the {kind} "
                                             f"launched {launches}")
                if made != [ShardedGraph]:
                    raise AssertionError(f"(a) {label}: the rank's graphs "
                                         f"{made}")
                for key in ("loss", "val_loss", "test_loss"):
                    compare(f"(a) {label} {key}, row-sharded against plain",
                            torch.tensor([best["row-sharded graph"][key]]),
                            torch.tensor([best["plain graph"][key]]),
                            FWD_TOL)
        finally:
            dist.destroy_process_group()


def gspmd_ranks(device):
    """(b) of the gspmd phase: GSPMD_SHARDS row shards run one after
    another on the card, each handed the gathered table (its src
    projection of the whole input) in place of the all-gather: a SIRConv
    with max and erf-GELU at H = O = 512 on the roman-empire stand-in and
    a GATv2 layer of the wiki-cs GAT (300 features, 64 wide, its own dst
    weights) on the wiki-cs stand-in. The joined rows against the single
    card's at FWD_TOL, the summed input and weight gradients at BWD_TOL;
    no launch."""
    import numpy as np
    import torch

    from sir_gcn_tpu_torch import build_graph
    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.models import GATv2Conv, SIRConv
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.ops.ell import gelu
    from sir_gcn_tpu_torch.parallel.full_graph import shard_full_graph

    S = GSPMD_SHARDS
    for label, (n, e, d) in GSPMD_LAYERS.items():
        data = synthetic_node_classification(n, e, feat_dim=8,
                                             num_classes=2, seed=0)
        g = build_graph(data.src, data.dst, data.feat.shape[0],
                        pad_multiple=128 * S, device=device)
        gen = torch.Generator().manual_seed(0)
        if label.startswith("SIRConv"):
            conv = SIRConv(d, d, d, gelu(), agg_type="max", generator=gen)
            table = conv.linear_key
        else:
            conv = GATv2Conv(d, 64, 1, share_weights=False, generator=gen)
            table = conv.fc_src
        conv = conv.to(device)
        x = torch.randn((g.n_pad, d), generator=torch.Generator(
            device=device).manual_seed(1), device=device)
        gw = None
        torch.cuda.synchronize()
        reset_launch_counts()
        xr = x.clone().requires_grad_()
        want = conv(g, xr)
        gw = torch.randn(want.shape, generator=torch.Generator(
            device=device).manual_seed(2), device=device)
        (want * gw).sum().backward()
        want_g = {k: p.grad.clone() for k, p in conv.named_parameters()}
        conv.zero_grad()
        outs, g_x = [], torch.zeros_like(x)
        t0 = time.perf_counter()
        for r in range(S):
            xf = x.clone().requires_grad_()
            sg = shard_full_graph(g, S, r, gather=lambda t, xf=xf: table(xf)
                                  .reshape((-1,) + t.shape[1:]))
            xl = x[sg.rows].clone().requires_grad_()
            out = conv(sg, xl)
            (out * gw[sg.rows]).sum().backward()
            outs.append(out.detach())
            g_x += xf.grad
            g_x[sg.rows] += xl.grad
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v for k, v in LAUNCHES.items() if v}
        log(f"  (b) {label}: {g.n_pad} nodes, {g.e_pad} edges in {S} "
            f"shards of {g.n_pad // S} nodes (edge runs "
            f"{[shard_full_graph(g, S, r).e_pad for r in range(S)]}); the "
            f"{S} ranks' forward and backward {dt * 1e3:.1f} ms; launches "
            f"{launches}")
        if launches:
            raise AssertionError(f"(b) {label} launched {launches}")
        compare(f"(b) {label} out, {S} ranks joined against the single "
                f"card", torch.cat(outs), want.detach(), FWD_TOL)
        compare(f"(b) {label} input gradient, summed over the ranks", g_x,
                xr.grad, BWD_TOL)
        err = max(compare(f"(b) {label} grad {k}", p.grad, want_g[k],
                          BWD_TOL, quiet=True)
                  for k, p in conv.named_parameters())
        log(f"  (b) {label}: every weight gradient, summed over the ranks, "
            f"within BWD_TOL, max abs err {err:.3e}")
        del conv, x, xr, want, want_g, outs, g_x, gw
        torch.cuda.empty_cache()


def phase_gspmd(device, smi: str):
    """The row-sharded full graph on the card: (a) the two trainers'
    runs that JAX sends to its GSPMD path, through the trainers' code on
    a one-rank NCCL group; (b) four shards rank by rank against the single
    card; (c) bench_scaling_torch.py --devices 1 on both paths at its
    default size (a record); (d) the multi-device dry run on one NCCL
    rank."""
    import contextlib
    import io

    import torch

    import bench_scaling_torch
    from sir_gcn_tpu_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    log("== gspmd: the row-sharded full graph")
    gspmd_trainer_runs(device, smi)
    torch.cuda.empty_cache()
    log(f"  (a) done at {time.perf_counter() - t0:.1f} s")
    gspmd_ranks(device)
    log(f"  (b) done at {time.perf_counter() - t0:.1f} s")
    for path in ("halo", "gspmd"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            (record,) = bench_scaling_torch.main(["--devices", "1",
                                                  "--path", path])
        log(f"  (c) bench_scaling_torch.py --devices 1 --path {path} "
            f"({smi}): {out.getvalue().strip()}")
        if not record["value"] > 0:
            raise AssertionError(f"(c) {path}: {record}")
    log(f"  (c) done at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    from sir_gcn_tpu_torch.parallel import multihost

    multihost.DEFAULT_TIMEOUT_S, multihost.DEFAULT_DEADLINE_S = 120.0, 300.0
    lines = dryrun_multichip(1)
    log(f"  (d) dryrun_multichip(1) on one NCCL rank: {len(lines)} lines ok")
    if len(lines) != 8:
        raise AssertionError(f"(d) the dry run printed {lines}")
    log(f"== gspmd ok in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import sir_gcn_tpu_torch  # noqa: F401  (fails without the port)

    from sir_gcn_tpu_torch.ops.ell import gelu

    device = torch.device("cuda")
    t0 = time.perf_counter()
    seconds = {}

    def run(name, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, its seconds logged and kept by name."""
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = round(time.perf_counter() - t, 1)
        log(f"== {name}: {seconds[name]} s")
        return out

    smi = run("env", phase_env)
    run("build", phase_build)
    errs, timing, arxiv_fg = run("kernels", phase_kernels, device)
    launches, sym_run = run("train sym", phase_train, "sym")
    launches.update({k: v for k, v in run(
        "train max", phase_train, "max")[0].items() if k in MAX})
    run("dropedge", phase_dropedge, sym_run)
    run("bench", phase_bench, device, errs)
    launches.update({k: v for k, v in run(
        "sireconv", phase_sireconv, device, arxiv_fg).items() if k in EDGE})
    launches.update({k: v for k, v in run(
        "general", phase_general, device, arxiv_fg).items()
        if k in GENERAL})
    launches.update({k: v for k, v in run(
        "general_edge", phase_general_edge, device, arxiv_fg).items()
        if k in GENERAL_EDGE})
    general_wide, general_gelu, wide_softmax = run(
        "general_wide", phase_general_wide, device, arxiv_fg)
    sireconv_wide = run("sireconv_wide", phase_sireconv_wide, device,
                        arxiv_fg)
    max_edge, max_both = run("sireconv_max", phase_sireconv_max, device,
                             arxiv_fg)
    launches.update({k: v for k, v in max_edge.items() if k in MAX_EDGE})
    max_rowwise, max_wide, max_gelu = run("max_rowwise", phase_max_rowwise,
                                          device, arxiv_fg)
    max_forms = {"rowwise": max_rowwise, "rowwise,wide": max_wide,
                 "edge,rowwise": {MAX_EDGE[k]: v for k, v in max_both.items()
                                  if k in MAX_EDGE}}
    launches.update({k: v for k, v in run(
        "bwd", phase_bwd, device, arxiv_fg).items() if k in BWD})
    lab_launches, lab_errs, lab_timing = run("lab", phase_lab, device)
    launches.update(lab_launches)
    errs.update(lab_errs)
    timing.update(lab_timing)
    torch.cuda.empty_cache()  # the lab's ~3 GB, before e2e and profile
    for agg in ("sym", "max"):
        run(f"e2e {agg}", phase_e2e, device, agg)
    run("e2e sireconv", phase_e2e_sireconv, device)
    run("e2e general", phase_e2e_general, device)
    run("e2e routes", phase_e2e_routes, device)
    run("pure", phase_pure, device, arxiv_fg)
    sym_profile = run("profile sym", phase_profile, device, "sym")
    run("profile max", phase_profile, device, "max")
    run("profile dropedge", phase_profile, device, "sym", edge_dropout=0.2,
        against=sym_profile)
    run("profile sireconv", phase_profile_sireconv, device, arxiv_fg)
    run("profile general", phase_profile_general, device, arxiv_fg)
    gelu_launches, max_forms["wide"] = run("fullgraph", phase_fullgraph,
                                           device)
    # the max kernels' erf-GELU forms at 96: the max_rowwise phase's (d)
    gelu_launches.update({k: max_gelu[k] for k in MAX[:3]})
    # the edge kernels' erf-GELU forms: no workload runs a SIREConv with
    # erf-GELU; this one does, at the arxiv plan, 2 steps and evals a route
    gelu_launches.update({
        k: v for k, v in run("sireconv gelu", phase_sireconv, device,
                             arxiv_fg, steps=2, act=gelu()).items()
        if k in EDGE})
    run("bot", phase_bot, device)
    run("oracles", phase_oracles, device)
    run("batched", phase_batched, device)
    run("dist", phase_dist, device, errs, timing, smi)
    run("gspmd", phase_gspmd, device, smi)
    log(f"== phase seconds: {json.dumps(seconds)}")
    log(f"== all phases ok in {time.perf_counter() - t0:.1f}s")

    rows = []
    for name, (source, replaces, _) in KERNELS.items():
        t = timing[name]
        row = f"{EDGE_FORMS[name]}[edge]" if name in EDGE_FORMS else name
        rows.append(dict(
            name=row, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
            bound_by=t["bound"][1], library_ms=t.get("library_ms")))
    for name in GELU:
        source, replaces, _ = KERNELS[name]
        t = timing[f"{name}[gelu]"]
        rows.append(dict(
            name=f"{name}[gelu]", route="cuda", source=source,
            replaces=replaces, launches=gelu_launches[name],
            max_abs_err=errs[f"{name}[gelu]"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
            bound_by=t["bound"][1], library_ms=None))
    for form in MAX_FORMS:
        for name in MAX[:3]:
            source, replaces, _ = KERNELS[name]
            key = f"{name}[{form}]"
            t = timing[key]
            rows.append(dict(
                name=key, route="cuda", source=source, replaces=replaces,
                launches=max_forms[form][name], max_abs_err=errs[key],
                ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
                bound_by=t["bound"][1], library_ms=None))
    for form, counts in (("gelu", general_gelu), ("wide", general_wide)):
        for name in GENERAL_FORMS:
            source, replaces, _ = KERNELS[name]
            key = f"{name}[{form}]"
            t = timing[key]
            rows.append(dict(
                name=key, route="cuda", source=source, replaces=replaces,
                launches=counts[name], max_abs_err=errs[key], ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
                bound_by=t["bound"][1], library_ms=None))
    for name in WIDE_SOFTMAX:  # (a)'s softmax forms at H = WIDE_H
        source, replaces, _ = KERNELS[name]
        key = f"{name}[wide,softmax]"
        t = timing[key]
        rows.append(dict(
            name=key, route="cuda", source=source, replaces=replaces,
            launches=wide_softmax[name], max_abs_err=errs[key], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
            bound_by=t["bound"][1], library_ms=None))
    for name in EDGE[3:]:  # #7 and #8 at H = WIDE_H, sireconv_wide's
        source, replaces, _ = KERNELS[name]
        key = f"{name}[wide]"
        t = timing[key]
        rows.append(dict(
            name=key, route="cuda", source=source, replaces=replaces,
            launches=sireconv_wide[name], max_abs_err=errs[key], ms=t["ms"],
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
