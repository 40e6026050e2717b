"""The port's distributed aggregates on gloo ranks spawned on the CPU
(``parallel/multihost.spawn_ranks``), against the JAX package's
``use_pallas=False`` programs on a mesh of as many devices: the halo
aggregate (``halo_sir_aggregate``: static scales, DropEdge's dynamic ones,
mean's counts, the edge term, max) and the all-gather aggregate
(``make_sharded_sir_aggregate``), forward (with and without a gradient)
and every gradient. A registry sigma (leaky_relu(0.2)) takes the kernel
variant, whose wrappers run their plain versions on the CPU; torch.tanh
the pure variant. The spawned ranks import no JAX
(``tests/torch_dist_workers.py``); each rank count is spawned once for all
cases."""

import numpy as np
import pytest

from sir_gcn_tpu_torch.parallel.multihost import spawn_ranks

try:  # pytest puts tests/ on the path; an import as tests.<name> does not
    import torch_dist_workers as workers
except ModuleNotFoundError:
    from tests import torch_dist_workers as workers

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
H, O = 8, 5
SHARDS = (2, 4)

# name -> (kind, agg, sigma, DropEdge mask, edge term)
CASES = {
    "halo_sum_leaky": ("halo", "sum", "leaky", False, False),
    "halo_mean_leaky": ("halo", "mean", "leaky", False, False),
    "halo_sym_leaky": ("halo", "sym", "leaky", False, False),
    "halo_sym_tanh": ("halo", "sym", "tanh", False, False),
    "halo_sym_leaky_dropedge": ("halo", "sym", "leaky", True, False),
    "halo_mean_tanh_dropedge": ("halo", "mean", "tanh", True, False),
    "halo_sym_leaky_edge": ("halo", "sym", "leaky", False, True),
    "halo_mean_tanh_edge_dropedge": ("halo", "mean", "tanh", True, True),
    "halo_max_leaky": ("halo", "max", "leaky", False, False),
    "halo_max_tanh_edge_dropedge": ("halo", "max", "tanh", True, True),
    "sharded_sym_leaky": ("sharded", "sym", "leaky", False, False),
    "sharded_mean_tanh": ("sharded", "mean", "tanh", False, False),
}
# every case on 2 ranks; a kernel-variant, a pure-variant and an
# all-gather case on 4
ON_FOUR = ("halo_sym_leaky_dropedge", "halo_mean_tanh_edge_dropedge",
           "sharded_sym_leaky")
RUNS = [(name, 2) for name in sorted(CASES)] + [(n, 4) for n in ON_FOUR]


def case_arrays(name: str) -> dict:
    kind, agg, act, mask, edge = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    src, dst, n = workers.skewed_edges(len(name))
    n_pad, e_pad = 256, 2048
    width = O if agg == "max" else H
    case = dict(kind=kind, agg=agg, act=act, src=src, dst=dst, n=n,
                max_budget=16,
                eq=rng.normal(size=(n_pad, H)).astype(np.float32),
                ek=rng.normal(size=(n_pad, H)).astype(np.float32),
                gw=rng.normal(size=(n_pad, width)).astype(np.float32))
    if mask:
        case["edge_mask"] = rng.random(e_pad) >= 0.3
    if edge:
        case["e"] = (0.5 * rng.normal(size=(e_pad, H))).astype(np.float32)
    if agg == "max":
        case["w"] = rng.normal(size=(H, O)).astype(np.float32)
        case["b"] = rng.normal(size=(O,)).astype(np.float32)
    return case


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """{n_shards: {case: result}}: one spawn a rank count."""
    out = {}
    for s in SHARDS:
        names = [n for n, k in RUNS if k == s]
        res = spawn_ranks(s, workers.run_cases,
                          [case_arrays(n) for n in names], cpu=True,
                          timeout_s=60, deadline_s=240,
                          store_dir=str(tmp_path_factory.mktemp("ranks")))
        out[s] = dict(zip(names, res))
    return out


def jax_reference(name: str, n_shards: int) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import sir_gcn_tpu as jsg
    from sir_gcn_tpu.parallel import make_mesh
    from sir_gcn_tpu.parallel.ell_distributed import (
        build_sharded_fast_graph,
        make_sharded_sir_aggregate,
    )
    from sir_gcn_tpu.parallel.halo import build_halo_graph, halo_sir_aggregate

    c = case_arrays(name)
    act = ((lambda z: jax.nn.leaky_relu(z, 0.2)) if c["act"] == "leaky"
           else jnp.tanh)
    g = jsg.build_graph(c["src"], c["dst"], c["n"], pad_multiple=128)
    mesh = make_mesh((n_shards,), ("graph",),
                     devices=jax.devices()[:n_shards])
    sh = NamedSharding(mesh, P("graph"))
    eq = jax.device_put(jnp.asarray(c["eq"]), sh)
    ek = jax.device_put(jnp.asarray(c["ek"]), sh)
    names = ["g_eq", "g_ek"]
    if c["kind"] == "sharded":
        sfg = build_sharded_fast_graph(g, n_shards, agg_type=c["agg"],
                                       max_budget=16)
        f = make_sharded_sir_aggregate(sfg, act, mesh, use_pallas=False)
        args, fn = (eq, ek), f
    else:
        hg = build_halo_graph(g, n_shards, mesh, agg_type=c["agg"],
                              max_budget=16)
        extra = {}
        if "edge_mask" in c:
            extra["edge_mask"] = jnp.asarray(c["edge_mask"])
        args = [eq, ek]
        if "e" in c:
            args.append(jnp.asarray(c["e"]))
            names.append("g_e")
        if "w" in c:
            args += [jnp.asarray(c["w"]), jnp.asarray(c["b"])]
            names += ["g_w", "g_b"]

        def fn(eq, ek, *rest):
            kw = dict(extra)
            rest = list(rest)
            if "e" in c:
                kw["e"] = rest.pop(0)
            if "w" in c:
                kw["w_relation"], kw["b_relation"] = rest
            return halo_sir_aggregate(hg, eq, ek, act, c["agg"], **kw)

    out, vjp = jax.vjp(fn, *args)
    grads = vjp(jnp.asarray(c["gw"]))
    want = {"out": np.asarray(out)}
    want.update({k: np.asarray(v) for k, v in zip(names, grads)})
    return want


@pytest.mark.parametrize("name,n_shards", RUNS)
def test_distributed_aggregate_matches_jax(port_results, name, n_shards):
    got = port_results[n_shards][name]
    want = jax_reference(name, n_shards)
    np.testing.assert_allclose(got["out"], want["out"], **FWD_TOL)
    np.testing.assert_allclose(got["out_nograd"], want["out"], **FWD_TOL)
    assert set(want) - {"out"} == set(got) - {"out", "out_nograd"}
    for k in set(want) - {"out"}:
        np.testing.assert_allclose(got[k], want[k], **BWD_TOL, err_msg=k)


def test_a_failed_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        spawn_ranks(2, workers.fail_on_rank_one, cpu=True, timeout_s=20,
                    deadline_s=60, store_dir=str(tmp_path))


def test_a_hung_collective_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="deadline|exit codes"):
        spawn_ranks(2, workers.hang_on_rank_zero, cpu=True, timeout_s=5,
                    deadline_s=30, store_dir=str(tmp_path))
