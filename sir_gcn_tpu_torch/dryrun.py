"""The multi-device dry run of the port: the JAX package's
``dryrun_multichip``, seven parts on tiny shapes, each on N ranks (one card
each over NCCL, or gloo processes with ``cpu``):

1. one training step of the flagship arxiv SIRModel (sym, bn, residual,
   dropout 0.2) on the row-sharded full graph, and the same step on the
   boundary-only halo graph through the model;
2. one data-parallel step of a tiny batched-graph regressor (a SIRConv,
   a linear, sum pooling; each rank its own batch);
3. the all-gather ELL aggregate (sym, tanh), forward and backward;
4. the halo aggregate under a DropEdge mask, forward and backward;
5. the halo SIREConv aggregate (an edge term, sum), forward and backward;
6. the halo max aggregate (W_R per edge), forward and backward;
7. a checkpoint of part 1's state saved by rank 0 and restored on every
   rank, its parameters equal bit for bit, then one resumed step.

Each part prints one ``[dryrun] ... ok`` line on rank 0 and asserts a
finite loss.

    python -m sir_gcn_tpu_torch.dryrun --devices 2 --cpu
"""

from __future__ import annotations

import argparse
import copy
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .graph import (
    add_self_loops,
    batch_graphs,
    build_graph,
    to_bidirected,
)
from .parallel.multihost import check_devices, spawn_ranks


def _flagship(n_nodes: int, n_edges: int, device, seed: int = 0):
    """The flagship arxiv SIRModel at hidden 32 and 2 layers (sym, bn,
    residual, dropout and feature dropout 0.2) and its synthetic graph
    (bidirected, self-loops, padded to 128), features and labels."""
    from .data import synthetic_node_classification
    from .experiments.ogbn_arxiv.model import SIRModel

    data = synthetic_node_classification(
        num_nodes=n_nodes, num_edges=n_edges, feat_dim=128,
        num_classes=40, seed=seed)
    src, dst = to_bidirected(data.src, data.dst)
    src, dst = add_self_loops(src, dst, n_nodes)
    graph = build_graph(src, dst, n_nodes, pad_multiple=128, device=device)
    model = SIRModel(128, 32, 40, num_layers=2, dropout=0.2, norm="bn",
                     residual=True, feat_dropout=0.2, agg_type="sym",
                     generator=torch.Generator().manual_seed(seed))
    feats = np.zeros((graph.n_pad, 128), np.float32)
    feats[:n_nodes] = data.feat
    labels = np.zeros(graph.n_pad, np.int64)
    labels[:n_nodes] = data.labels
    return model.to(device), graph, feats, labels


def _finite(value: float, what: str) -> float:
    if not np.isfinite(value):
        raise FloatingPointError(f"{what}: the loss is {value}")
    return value


class _TinyGraphReg(nn.Module):
    def __init__(self):
        super().__init__()
        from .models import Linear, SIRConv
        from .ops.ell import tanh

        gen = torch.Generator().manual_seed(1)
        self.conv = SIRConv(16, 16, 16, tanh, generator=gen)
        self.linear = Linear(16, 1, generator=gen)

    def forward(self, graph, x):
        from .ops.pool import sum_pool

        return sum_pool(graph, self.linear(self.conv(graph, x)))


def rank_dryrun(cpu: bool) -> list:
    """This rank's seven parts; returns the lines rank 0 printed."""
    from .experiments.fullgraph_harness import rank_rows
    from .ops.ell import tanh
    from .parallel.collectives import all_reduce_sum, sum_gradients
    from .parallel.data_parallel import make_dp_train_step
    from .parallel.ell_distributed import (
        build_sharded_fast_graph,
        make_sharded_sir_aggregate,
    )
    from .parallel.full_graph import shard_full_graph
    from .parallel.halo import build_halo_graph, halo_sir_aggregate
    from .parallel.multihost import local_device
    from .train import make_adamw
    from .utils.checkpoint import load_checkpoint, save_checkpoint

    n, rank = dist.get_world_size(), dist.get_rank()
    device = local_device(cpu)
    lines = []

    def ok(msg: str) -> None:
        line = f"[dryrun] {msg} ok on {n} devices"
        print(line, flush=True)
        lines.append(line)

    def total(loss: torch.Tensor) -> float:
        return float(all_reduce_sum(loss.detach()))

    # ---- 1. the row-sharded full-graph training step, and the same step
    # through the model on the halo graph
    model, graph, feats, labels = _flagship(128 * n, 8 * 128 * n, device)
    init = copy.deepcopy(model.state_dict())

    def fg_step(model, opt, g, seed: int) -> float:
        rows = g.rows
        gen = torch.Generator(device=device).manual_seed(seed)
        model.train()
        opt.zero_grad(set_to_none=True)
        with rank_rows(g):
            logits = model(g, torch.from_numpy(feats[rows]).to(device),
                           generator=gen)
        ce = F.cross_entropy(logits, torch.from_numpy(labels[rows])
                             .to(device), reduction="sum")
        loss = ce / g.n_global
        loss.backward()
        sum_gradients(model, g.group)
        opt.step()
        return total(loss)

    sg = shard_full_graph(graph, n, rank)
    opt = make_adamw(model.parameters(), 1e-2)
    loss = _finite(fg_step(model, opt, sg, 0), "row-sharded step")
    ok(f"row-sharded full-graph step (loss {loss:.4f})")
    state = (copy.deepcopy(model.state_dict()),
             copy.deepcopy(opt.state_dict()))

    model_h = copy.deepcopy(model)
    model_h.load_state_dict(init)
    hg = build_halo_graph(graph, n, None, agg_type="sym")
    loss_h = _finite(fg_step(model_h, make_adamw(model_h.parameters(), 1e-2),
                             hg, 0), "halo model step")
    ok(f"halo-path model training step (loss {loss_h:.4f})")

    # ---- 2. a data-parallel batched-graph step, each rank its own batch
    r = np.random.default_rng(rank)
    gb = batch_graphs([(r.integers(0, 6, 10), r.integers(0, 6, 10), 6)
                       for _ in range(4)], n_pad=32, e_pad=48, g_pad=5,
                      device=device)
    x = torch.from_numpy(r.normal(size=(32, 16)).astype(np.float32)).to(
        device)
    y = torch.from_numpy(r.normal(size=(5,)).astype(np.float32)).to(device)
    reg = _TinyGraphReg().to(device)
    step = make_dp_train_step(
        reg, lambda m, b, _: ((m(b[0], b[1])[:, 0] - b[2]) ** 2).mean(),
        torch.optim.Adam(reg.parameters(), 1e-2))
    dploss = _finite(float(step((gb, x, y))), "data-parallel step")
    ok(f"data-parallel step (loss {dploss:.4f})")

    # ---- 3.-6. the distributed aggregates on a random graph
    rng = np.random.default_rng(0)
    n2 = 32 * n
    g2 = build_graph(rng.integers(0, n2, 8 * n2), rng.integers(0, n2, 8 * n2),
                     n2, n_pad=n2, e_pad=8 * n2, device=device)
    xq_all = torch.from_numpy(rng.normal(size=(n2, 16)).astype(np.float32))
    rows2 = slice(rank * (n2 // n), (rank + 1) * (n2 // n))

    def leaf():
        return xq_all[rows2].to(device).requires_grad_()

    def fwd_bwd(out: torch.Tensor, *grads, what: str) -> float:
        val = (out ** 2).sum()
        val.backward()
        for g in grads:
            _finite(float(g.grad.sum()), what + " gradient")
        return _finite(total(val), what)

    sfg = build_sharded_fast_graph(g2, n, agg_type="sym")
    agg = make_sharded_sir_aggregate(sfg, tanh, device)
    xq, xk = leaf(), leaf()
    fwd_bwd(agg(xq, xk), xq, xk, what="all-gather ELL aggregate")
    ok("all-gather ELL aggregate fwd+bwd")

    keep = torch.from_numpy(rng.random(g2.e_pad) < 0.8).to(device)
    hg2 = build_halo_graph(g2, n, None, agg_type="sym")
    xq, xk = leaf(), leaf()
    fwd_bwd(halo_sir_aggregate(hg2, xq, xk, tanh, "sym", edge_mask=keep),
            xq, xk, what="halo aggregate")
    ok("boundary-only halo (all_to_all) fwd+bwd")

    e_feat = torch.from_numpy(rng.normal(size=(g2.e_pad, 16)).astype(
        np.float32)).to(device).requires_grad_()
    hg_e = build_halo_graph(g2, n, None, agg_type="sum")
    xq = leaf()
    fwd_bwd(halo_sir_aggregate(hg_e, xq, xq, tanh, "sum", e=e_feat), xq,
            e_feat, what="halo SIREConv")
    ok("halo SIREConv (edge features) fwd+bwd")

    w_rel = torch.from_numpy((rng.normal(size=(16, 16)) * 0.1).astype(
        np.float32)).to(device).requires_grad_()
    hg_m = build_halo_graph(g2, n, None, agg_type="max")
    xq = leaf()
    fwd_bwd(halo_sir_aggregate(hg_m, xq, xq, tanh, "max", w_relation=w_rel,
                               b_relation=torch.zeros(16, device=device)),
            xq, w_rel, what="halo max aggregate")
    ok("halo max-aggregation fwd+bwd")

    # ---- 7. checkpoint save (rank 0) and restore (every rank), then one
    # resumed step on the row-sharded graph
    where = [tempfile.mkdtemp(prefix="dryrun_ckpt_") if rank == 0 else None]
    dist.broadcast_object_list(where)
    try:
        if rank == 0:
            save_checkpoint(where[0], {"model": state[0],
                                       "optimizer": state[1]}, step=1)
        dist.barrier()
        restored = load_checkpoint(where[0], 1)
        for k, v in state[0].items():
            if not torch.equal(restored["model"][k], v.cpu()):
                raise AssertionError(f"checkpoint round trip of {k} is not "
                                     f"bitwise")
        model.load_state_dict(restored["model"])
        opt = make_adamw(model.parameters(), 1e-2)
        opt.load_state_dict(restored["optimizer"])
        loss2 = _finite(fg_step(model, opt, sg, 1), "resumed step")
        dist.barrier()
    finally:
        if rank == 0:
            shutil.rmtree(where[0], ignore_errors=True)
    ok(f"sharded checkpoint save/restore + resumed step (loss {loss2:.4f})")
    return lines


def dryrun_multichip(n_devices: int, cpu: bool = False) -> list:
    """The seven parts on ``n_devices`` ranks spawned here (one card each,
    or gloo processes with ``cpu``); raises if a part fails, or for more
    ranks than visible cards. Returns the lines rank 0 printed."""
    check_devices(n_devices, cpu)
    return spawn_ranks(n_devices, rank_dryrun, cpu, cpu=cpu)


def main(argv=None) -> list:
    p = argparse.ArgumentParser("the port's multi-device dry run")
    p.add_argument("--devices", type=int, default=torch.cuda.device_count()
                   or 2)
    p.add_argument("--cpu", action="store_true",
                   help="gloo processes on the CPU")
    args = p.parse_args(argv)
    return dryrun_multichip(args.devices, args.cpu)


if __name__ == "__main__":
    main()
