"""Rank functions of the port's distributed CPU tests
(``tests/test_torch_dist_*.py``), spawned as gloo ranks by
``sir_gcn_tpu_torch.parallel.multihost.spawn_ranks``. They import no JAX:
each rank imports only this module and the port. Each returns, on rank 0,
the pieces of every rank (or their sum, for gradients of replicated
inputs) as NumPy arrays."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from sir_gcn_tpu_torch import build_graph
from sir_gcn_tpu_torch.ops import ell as tell
from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype


def skewed_edges(seed: int, n: int = 256, e: int = 2048):
    """A graph with a dst hub (40% of the edges into node 7) and a src
    hub, so that plans need the hub stage at max_budget 16, and the rest
    of the edges mostly within 32-node blocks."""
    rng = np.random.default_rng(seed)
    dst = np.where(rng.random(e) < 0.4, 7, rng.integers(0, n, e))
    local = rng.random(e) < 0.6
    src = np.where(local, (dst // 32) * 32 + rng.integers(0, 32, e),
                   rng.integers(0, n, e))
    src = np.where(rng.random(e) < 0.1, 200, src)
    return src.astype(np.int64), dst.astype(np.int64), n


def _gather(x: np.ndarray) -> np.ndarray:
    """Every rank's rows, concatenated in rank order."""
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, x)
    return np.concatenate(parts)


def _summed(x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(x))
    dist.all_reduce(t)
    return t.numpy()


def _sigma(name: str):
    """'leaky' is the registry entry (the kernel variant); 'tanh' a torch
    callable outside it (the pure variant)."""
    return tell.leaky_relu(0.2) if name == "leaky" else torch.tanh


def halo_rank(case: dict) -> dict:
    """One rank's halo aggregate of ``case`` (graph, inputs, sigma, agg,
    optional DropEdge mask, edge term and W_R), its forward and backward
    against the cotangent ``gw``."""
    from sir_gcn_tpu_torch.parallel.halo import (
        build_halo_graph,
        halo_sir_aggregate,
    )

    set_edge_dtype(case.get("edge_dtype"))
    graph = build_graph(case["src"], case["dst"], case["n"],
                        pad_multiple=case.get("pad", 128))
    hg = build_halo_graph(graph, dist.get_world_size(), None, case["agg"],
                          max_budget=case.get("max_budget", 256))
    rows = hg.rows
    eq = torch.from_numpy(case["eq"][rows]).requires_grad_()
    ek = torch.from_numpy(case["ek"][rows]).requires_grad_()
    kw, replicated = {}, {}
    if case.get("e") is not None:
        kw["e"] = replicated["g_e"] = torch.from_numpy(
            case["e"]).requires_grad_()
    if case.get("w") is not None:
        kw["w_relation"] = replicated["g_w"] = torch.from_numpy(
            case["w"]).requires_grad_()
        kw["b_relation"] = replicated["g_b"] = torch.from_numpy(
            case["b"]).requires_grad_()
    if case.get("edge_mask") is not None:
        kw["edge_mask"] = torch.from_numpy(case["edge_mask"])
    out = halo_sir_aggregate(hg, eq, ek, _sigma(case["act"]), case["agg"],
                             **kw)
    (out * torch.from_numpy(case["gw"][rows])).sum().backward()
    with torch.no_grad():
        out_ng = halo_sir_aggregate(hg, eq, ek, _sigma(case["act"]),
                                    case["agg"], **kw)
    res = {"out": _gather(out.detach().numpy()),
           "out_nograd": _gather(out_ng.numpy()),
           "g_eq": _gather(eq.grad.numpy()),
           "g_ek": _gather(ek.grad.numpy())}
    for name, leaf in replicated.items():  # each rank's part, summed
        res[name] = _summed(leaf.grad.numpy())
    return res


def sharded_rank(case: dict) -> dict:
    """One rank's all-gather aggregate of ``case``, forward and backward."""
    from sir_gcn_tpu_torch.parallel.ell_distributed import (
        build_sharded_fast_graph,
        make_sharded_sir_aggregate,
    )

    graph = build_graph(case["src"], case["dst"], case["n"],
                        pad_multiple=case.get("pad", 128))
    world = dist.get_world_size()
    sfg = build_sharded_fast_graph(graph, world, case["agg"],
                                   max_budget=case.get("max_budget", 256))
    f = make_sharded_sir_aggregate(sfg, _sigma(case["act"]), "cpu",
                                   edge_dtype=case.get("edge_dtype"))
    n_local = sfg.n_local
    rows = slice(dist.get_rank() * n_local, (dist.get_rank() + 1) * n_local)
    eq = torch.from_numpy(case["eq"][rows]).requires_grad_()
    ek = torch.from_numpy(case["ek"][rows]).requires_grad_()
    out = f(eq, ek)
    (out * torch.from_numpy(case["gw"][rows])).sum().backward()
    with torch.no_grad():
        out_ng = f(eq, ek)
    return {"out": _gather(out.detach().numpy()),
            "out_nograd": _gather(out_ng.numpy()),
            "g_eq": _gather(eq.grad.numpy()),
            "g_ek": _gather(ek.grad.numpy())}


def row_sharded_rank(case: dict) -> dict:
    """One rank's row-sharded CSR forward and backward of ``case``
    against the cotangent ``gw``: 'sym' (``sir_aggregate`` sym with tanh,
    eq = ek = x @ w), 'max' (max with tanh, an edge term, W_R, b_R and a
    DropEdge mask) or 'gat' (a GATv2 layer with its own dst weights and a
    residual, from ``case``'s weights). The output and the gradients of
    the rank's rows (and edges) are gathered in rank order, those of
    replicated inputs (w, W_R, b_R, the layer's weights) summed."""
    from sir_gcn_tpu_torch.models import GATv2Conv
    from sir_gcn_tpu_torch.ops.message_passing import sir_aggregate
    from sir_gcn_tpu_torch.parallel.full_graph import shard_full_graph

    graph = build_graph(case["src"], case["dst"], case["n"],
                        pad_multiple=128)
    sg = shard_full_graph(graph, dist.get_world_size(), dist.get_rank())
    rows, (lo, hi, _) = sg.rows, sg.edge_run

    def leaf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()

    if case["kind"] == "sym":
        local = {"g_x": leaf(case["x"][rows])}
        replicated = {"g_w": leaf(case["w"])}

        def run():
            h = local["g_x"] @ replicated["g_w"]
            return sir_aggregate(sg, h, h, torch.tanh, "sym")
    elif case["kind"] == "max":
        local = {"g_eq": leaf(case["eq"][rows]),
                 "g_ek": leaf(case["ek"][rows]),
                 "g_e": leaf(case["e"][lo:hi])}
        replicated = {"g_w": leaf(case["w"]), "g_b": leaf(case["b"])}
        mask = torch.from_numpy(case["edge_mask"][lo:hi])

        def run():
            return sir_aggregate(sg, local["g_eq"], local["g_ek"],
                                 torch.tanh, "max", e=local["g_e"],
                                 w_relation=replicated["g_w"],
                                 b_relation=replicated["g_b"],
                                 edge_mask=mask)
    else:
        conv = GATv2Conv(case["x"].shape[1], 4, 2, share_weights=False,
                         residual=True)
        conv.load_state_dict({k: torch.from_numpy(v)
                              for k, v in case["state"].items()})
        local = {"g_x": leaf(case["x"][rows])}
        replicated = {f"g_{k}": p for k, p in conv.named_parameters()}

        def run():
            return conv(sg, local["g_x"])

    out = run()
    (out * torch.from_numpy(case["gw"][rows])).sum().backward()
    with torch.no_grad():
        out_ng = run()
    res = {"out": _gather(out.detach().numpy()),
           "out_nograd": _gather(out_ng.numpy())}
    for name, t in local.items():
        res[name] = _gather(t.grad.numpy())
    for name, t in replicated.items():
        res[name] = _summed(t.grad.numpy())
    return res


def run_row_sharded(cases: list) -> list:
    """``row_sharded_rank`` for each case, in one spawn."""
    return [row_sharded_rank(c) for c in cases]


def main_rank(module: str, argv: list):
    """A trainer's ``main(argv)`` on this rank (a process group of
    ``--mesh-devices`` or ``--dp-devices`` ranks is already joined)."""
    import importlib

    return importlib.import_module(module).main(argv)


def run_cases(cases: list) -> list:
    """``halo_rank`` or ``sharded_rank`` for each case, in one spawn."""
    return [(halo_rank if c["kind"] == "halo" else sharded_rank)(c)
            for c in cases]


def fail_on_rank_one():
    """Raises on rank 1, after rank 0 has joined the group."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    return "rank 0 done"


def hang_on_rank_zero():
    """Rank 0 waits in a collective that rank 1 never joins."""
    import time

    if dist.get_rank() == 0:
        dist.all_reduce(torch.ones(1))
    else:
        time.sleep(600)


def dp_step_rank(case: dict) -> dict:
    """One ``make_dp_train_step_stateful`` step of the zinc GraphSIRModel
    (flax weights ``case["variables"]``) with SGD at rate 1 on this rank's
    batch ``case["sel"][rank]``: the weights after the step, the running
    statistics and the loss."""
    from sir_gcn_tpu_torch.data import GraphCollection
    from sir_gcn_tpu_torch.experiments.zinc.model import make_sir_model
    from sir_gcn_tpu_torch.experiments.zinc.train import l1_loss
    from sir_gcn_tpu_torch.parallel.data_parallel import (
        make_dp_train_step_stateful,
    )
    from sir_gcn_tpu_torch.utils import load_jax_variables
    from sir_gcn_tpu_torch.utils.convert import _slots

    coll = GraphCollection(case["graphs"], node_feats=case["nf"],
                           edge_feats=case["ef"], labels=case["labels"])
    model = make_sir_model(28, 4, case["hidden"], 1, num_layers=2,
                           norm="bn", generator=torch.Generator())
    load_jax_variables(model, case["variables"])
    opt = torch.optim.SGD(model.parameters(), lr=1.0)

    def loss_fn(m, b, gen):
        preds = m(b["graph"], torch.from_numpy(b["node_feats"]),
                  torch.from_numpy(b["edge_feats"]), generator=gen)
        return l1_loss(preds, torch.from_numpy(b["labels"]),
                       torch.from_numpy(b["graph_weights"]))

    step = make_dp_train_step_stateful(model, loss_fn, opt)
    batch = coll.collate(np.asarray(case["sel"][dist.get_rank()]), 4)
    loss = step(batch)
    slots = {"/".join(k): (t.detach().numpy().T if tr
                           else t.detach().numpy()).copy()
             for k, (t, tr) in _slots(model).items()}
    return {"loss": float(loss), "slots": slots}
