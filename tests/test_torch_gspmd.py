"""The port's row-sharded full graph (``parallel/full_graph.py``): one
rank's rows and in-edges of a graph partitioned by node ranges, on the CSR
aggregate, with the src gathers all-gathering every rank's rows.

On gloo ranks spawned on the CPU (``tests/torch_dist_workers.py``, no
JAX), against the JAX package's ``shard_full_graph`` on a mesh of as many
CPU devices, at the JAX suite's tolerances (forward atol 2e-4 / rtol 1e-4,
gradients atol 3e-4 / rtol 1e-3): the sym aggregate with tanh and its
weight gradient, max with an edge term and a DropEdge mask, and a GATv2
layer, on 2 and 4 ranks. Then rank by rank in one process (each rank
handed the gathered table) against the whole graph; the DropEdge and
attention-dropout draws of a rank against the whole graph's; the arxiv
trainer's two distributed paths against each other;
``bench_scaling_torch.py`` and the multi-device dry run on gloo ranks; and
what raises. The card tests run the rank-by-rank check on a CUDA device.
"""

import json

import numpy as np
import pytest
import torch

import bench_scaling_torch
import sir_gcn_tpu_torch.experiments.ogbn_arxiv.train as tatrain
import sir_gcn_tpu_torch.parallel.multihost as multihost
from sir_gcn_tpu_torch import build_graph, drop_edge_mask
from sir_gcn_tpu_torch.dryrun import dryrun_multichip
from sir_gcn_tpu_torch.models import GATv2Conv
from sir_gcn_tpu_torch.models.layers import dropout, row_shard
from sir_gcn_tpu_torch.ops.message_passing import sir_aggregate
from sir_gcn_tpu_torch.parallel.full_graph import shard_full_graph
from sir_gcn_tpu_torch.parallel.multihost import spawn_ranks
from sir_gcn_tpu_torch.utils import load_jax_variables
from sir_gcn_tpu_torch.utils.convert import _slots

try:  # pytest puts tests/ on the path; an import as tests.<name> does not
    import torch_dist_workers as workers
except ModuleNotFoundError:
    from tests import torch_dist_workers as workers

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
D, H, O = 6, 8, 5
CASES = ("sym", "max", "gat")
SHARDS = (2, 4)
JAX_KEYS = {"metric", "devices", "value", "unit", "efficiency_vs_1dev"}


@pytest.fixture(autouse=True)
def bounded_ranks(monkeypatch):
    """A hung collective fails in a minute, a spawned run in four: the
    entry points spawn their ranks with the module's defaults."""
    monkeypatch.setattr(multihost, "DEFAULT_TIMEOUT_S", 60.0)
    monkeypatch.setattr(multihost, "DEFAULT_DEADLINE_S", 240.0)


def _jax_gat():
    from sir_gcn_tpu.models import zoo as jzoo

    return jzoo.GATv2Conv(4, num_heads=2, share_weights=False,
                          residual=True)


def _port_gat(variables=None) -> GATv2Conv:
    conv = GATv2Conv(D, 4, 2, share_weights=False, residual=True)
    if variables is not None:
        load_jax_variables(conv, variables)
    return conv


def gat_variables(case: dict) -> dict:
    """The flax GATv2 layer's weights from PRNGKey(0), as NumPy."""
    import jax
    import jax.numpy as jnp

    from sir_gcn_tpu import build_graph as j_build_graph

    g = j_build_graph(case["src"], case["dst"], case["n"], pad_multiple=128)
    variables = _jax_gat().init(jax.random.PRNGKey(0), g,
                                jnp.asarray(case["x"]))
    return jax.tree_util.tree_map(np.asarray, variables)


def case_arrays(name: str, with_state: bool = False) -> dict:
    rng = np.random.default_rng(CASES.index(name))
    src, dst, n = workers.skewed_edges(10 + CASES.index(name))
    n_pad, e_pad = 256, 2048
    case = dict(kind=name, src=src, dst=dst, n=n)
    if name == "sym":
        case.update(x=rng.normal(size=(n_pad, D)).astype(np.float32),
                    w=rng.normal(size=(D, H)).astype(np.float32),
                    gw=rng.normal(size=(n_pad, H)).astype(np.float32))
    elif name == "max":
        case.update(eq=rng.normal(size=(n_pad, H)).astype(np.float32),
                    ek=rng.normal(size=(n_pad, H)).astype(np.float32),
                    e=(0.5 * rng.normal(size=(e_pad, H))).astype(np.float32),
                    w=rng.normal(size=(H, O)).astype(np.float32),
                    b=rng.normal(size=(O,)).astype(np.float32),
                    edge_mask=rng.random(e_pad) >= 0.3,
                    gw=rng.normal(size=(n_pad, O)).astype(np.float32))
    else:
        case.update(x=rng.normal(size=(n_pad, D)).astype(np.float32),
                    gw=rng.normal(size=(n_pad, 2, 4)).astype(np.float32))
        if with_state:
            conv = _port_gat(gat_variables(case))
            case["state"] = {k: v.detach().numpy()
                             for k, v in conv.state_dict().items()}
    return case


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """{n_shards: {case: result}}: one spawn a rank count."""
    cases = [case_arrays(name, with_state=True) for name in CASES]
    return {s: dict(zip(CASES, spawn_ranks(
        s, workers.run_row_sharded, cases, cpu=True, timeout_s=60,
        deadline_s=240, store_dir=str(tmp_path_factory.mktemp("ranks")))))
        for s in SHARDS}


def jax_reference(name: str, n_shards: int) -> dict:
    """The JAX package's aggregate (or GATv2 layer) on ``shard_full_graph``
    over a mesh of ``n_shards`` CPU devices: out and the vjp of the
    cotangent."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sir_gcn_tpu import build_graph as j_build_graph
    from sir_gcn_tpu.ops import sir_aggregate as j_sir_aggregate
    from sir_gcn_tpu.parallel import make_mesh, shard_full_graph as j_shard

    c = case_arrays(name)
    g = j_build_graph(c["src"], c["dst"], c["n"], pad_multiple=128)
    mesh = make_mesh((n_shards,), ("graph",),
                     devices=jax.devices()[:n_shards])
    gs = j_shard(g, mesh)
    rows = NamedSharding(mesh, P("graph"))

    def node(a):
        return jax.device_put(jnp.asarray(a), rows)

    if name == "sym":
        def fn(x, w):
            h = x @ w
            return j_sir_aggregate(gs, h, h, jnp.tanh, "sym")

        args, names = (node(c["x"]), jnp.asarray(c["w"])), ("g_x", "g_w")
    elif name == "max":
        mask = jnp.asarray(c["edge_mask"])

        def fn(eq, ek, e, w, b):
            return j_sir_aggregate(gs, eq, ek, jnp.tanh, "max", e=e,
                                   w_relation=w, b_relation=b,
                                   edge_mask=mask)

        args = (node(c["eq"]), node(c["ek"]), jnp.asarray(c["e"]),
                jnp.asarray(c["w"]), jnp.asarray(c["b"]))
        names = ("g_eq", "g_ek", "g_e", "g_w", "g_b")
    else:
        jconv = _jax_gat()
        variables = gat_variables(c)

        def fn(x, params):
            return jconv.apply({"params": params}, gs, x)

        args, names = (node(c["x"]), variables["params"]), ("g_x", "params")
    out, vjp = jax.vjp(jax.jit(fn), *args)
    grads = vjp(jnp.asarray(c["gw"]))
    want = {"out": np.asarray(out)}
    want.update({k: jax.tree_util.tree_map(np.asarray, v)
                 for k, v in zip(names, grads)})
    return want


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("name", CASES)
def test_row_sharded_matches_jax_shard_full_graph(port_results, name,
                                                  n_shards):
    got = port_results[n_shards][name]
    want = jax_reference(name, n_shards)
    np.testing.assert_allclose(got["out"], want["out"], **FWD_TOL)
    np.testing.assert_allclose(got["out_nograd"], want["out"], **FWD_TOL)
    if name != "gat":
        assert set(want) - {"out"} == set(got) - {"out", "out_nograd"}
        for k in set(want) - {"out"}:
            np.testing.assert_allclose(got[k], want[k], **BWD_TOL,
                                       err_msg=k)
        return
    np.testing.assert_allclose(got["g_x"], want["g_x"], **BWD_TOL)
    conv = _port_gat()  # the summed weight gradients, in flax's layout
    for k, p in conv.named_parameters():
        p.grad = torch.from_numpy(got[f"g_{k}"])
    slots = {k: v for k, v in _slots(conv).items() if k[0] == "params"}
    flat = {("params",) + tuple(k.key for k in path): np.asarray(v)
            for path, v in __import__("jax").tree_util
            .tree_flatten_with_path(want["params"])[0]}
    assert set(flat) == set(slots)
    for key, g in flat.items():
        tensor, transpose = slots[key]
        have = tensor.grad.numpy()
        np.testing.assert_allclose(have.T if transpose else have, g,
                                   **BWD_TOL, err_msg="/".join(key))


def _graph():
    src, dst, n = workers.skewed_edges(3)
    return build_graph(src, dst, n, pad_multiple=128)


@pytest.mark.parametrize("agg", ["sum", "mean", "sym", "max"])
def test_shards_rank_by_rank_match_the_whole_graph(agg):
    """Four ranks' aggregates run one after another, each handed the
    gathered table (``gather``): their rows joined are the whole graph's
    output, and their src gradients summed (the reduce-scatter) its
    gradient."""
    g = _graph()
    rng = np.random.default_rng(0)
    eq, ek = (torch.from_numpy(rng.normal(size=(g.n_pad, H)).astype(
        np.float32)) for _ in range(2))
    kw = {}
    if agg == "max":
        kw["w_relation"] = torch.from_numpy(rng.normal(size=(H, O)).astype(
            np.float32))
    ek_r = ek.clone().requires_grad_()
    want = sir_aggregate(g, eq, ek_r, torch.tanh, agg, **kw)
    want.square().sum().backward()
    out_norm = g.out_deg.clamp_min(1.0).pow(-0.5)
    outs, g_ek = [], 0.0
    for r in range(4):
        ek_f = ek.clone().requires_grad_()
        sg = shard_full_graph(
            g, 4, r, gather=lambda x, t=ek_f: t if x.dim() == 2 else out_norm)
        out = sir_aggregate(sg, eq[sg.rows], ek[sg.rows], torch.tanh, agg,
                            **kw)
        out.square().sum().backward()
        outs.append(out.detach())
        g_ek = g_ek + ek_f.grad
    torch.testing.assert_close(torch.cat(outs), want.detach(), **FWD_TOL)
    torch.testing.assert_close(g_ek, ek_r.grad, **BWD_TOL)


def test_rank_graph_owns_the_in_edges_of_its_rows():
    g = _graph()
    h = g.host
    runs = []
    for r in range(4):
        sg = shard_full_graph(g, 4, r)
        lo, hi, e = sg.edge_run
        assert e == g.e_pad and sg.n_global == g.n_pad
        assert (lo, hi) == (h["row_ptr"][sg.rows.start],
                            h["row_ptr"][sg.rows.stop])
        np.testing.assert_array_equal(sg.host["dst"] + sg.rows.start,
                                      h["dst"][lo:hi])
        np.testing.assert_array_equal(sg.host["src"], h["src"][lo:hi])
        assert sg.num_edges == int(h["edge_mask"][lo:hi].sum())
        np.testing.assert_array_equal(sg.host["in_deg"], h["in_deg"][sg.rows])
        runs.append((lo, hi))
    assert runs[0][0] == 0 and runs[-1][1] == g.e_pad  # padding: the last
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    with pytest.raises(ValueError, match="not a multiple"):
        shard_full_graph(g, 3, 0)


def test_rank_draws_are_the_whole_graphs():
    """A rank's DropEdge mask and (under ``row_shard`` with its edge run)
    its attention-dropout mask are its run of the single-device draws."""
    g = _graph()
    for r in range(4):
        sg = shard_full_graph(g, 4, r)
        lo, hi, _ = sg.edge_run
        want = drop_edge_mask(torch.Generator().manual_seed(r), g, 0.3)
        got = drop_edge_mask(torch.Generator().manual_seed(r), sg, 0.3)
        assert torch.equal(got, want[lo:hi])
        alpha = torch.rand(g.e_pad, 2, generator=torch.Generator()
                           .manual_seed(9))
        want = dropout(alpha, 0.4, True, torch.Generator().manual_seed(r),
                       edges=True)
        with row_shard(sg.rows.start, sg.rows.stop, g.n_pad, sg.edge_run):
            got = dropout(alpha[lo:hi], 0.4, True,
                          torch.Generator().manual_seed(r), edges=True)
        assert torch.equal(got, want[lo:hi])


def test_gat_layer_rank_by_rank_matches_the_whole_graph():
    """A GATv2 layer (its own dst weights, a residual) on four ranks one
    after another, each handed its gathered src projection: the rows and
    the summed weight gradients of the whole graph's."""
    g = _graph()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(g.n_pad, D)).astype(np.float32))
    conv = GATv2Conv(D, 4, 2, share_weights=False, residual=True,
                     generator=torch.Generator().manual_seed(0))
    want = conv(g, x)
    want.square().sum().backward()
    want_g = {k: p.grad.clone() for k, p in conv.named_parameters()}
    conv.zero_grad()
    outs = []
    for r in range(4):
        sg = shard_full_graph(g, 4, r, gather=lambda t: conv.fc_src(x)
                              .reshape((-1,) + t.shape[1:]))
        out = conv(sg, x[sg.rows])
        out.square().sum().backward()
        outs.append(out.detach())
    torch.testing.assert_close(torch.cat(outs), want.detach(), **FWD_TOL)
    for k, p in conv.named_parameters():
        torch.testing.assert_close(p.grad, want_g[k], **BWD_TOL)


GRAPH = ["--synthetic-nodes", "1000", "--synthetic-edges", "6000",
         "--log-every", "100", "--nruns", "1"]


def test_arxiv_gspmd_and_halo_paths_agree():
    """``--dist-path gspmd`` and the halo path on two ranks give the same
    losses (the JAX suite's rtol 2e-5 between its two paths)."""
    common = (["--cpu", "--epochs", "3", "--nhidden", "12", "--nlayers",
               "2", "--agg-type", "sym", "--norm", "bn", "--residual",
               "--dropout", "0.2", "--edge-dropout", "0.2",
               "--mesh-devices", "2"] + GRAPH)
    (halo,) = tatrain.main(common)
    (rows,) = tatrain.main(common + ["--dist-path", "gspmd"])
    np.testing.assert_allclose(rows["train_losses"], halo["train_losses"],
                               rtol=2e-5)
    np.testing.assert_allclose(rows["val_loss"], halo["val_loss"],
                               rtol=2e-5)


@pytest.mark.parametrize("path", ["halo", "gspmd"])
def test_bench_scaling_prints_a_line_per_device_count(path, capsys):
    records = bench_scaling_torch.main(
        ["--cpu", "--devices", "1", "2", "--nodes", "512", "--edges",
         "4096", "--hidden", "8", "--steps", "1", "--path", path])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert lines == records and len(lines) == 2
    assert [r["devices"] for r in lines] == [1, 2]
    for r in lines:
        assert set(r) == JAX_KEYS
        assert r["metric"] == "scaling_edge_layers_per_s"
        assert r["unit"] == "edge-layers/s" and r["value"] > 0
    assert lines[0]["efficiency_vs_1dev"] == 1.0


def test_dryrun_multichip_on_two_gloo_ranks():
    lines = dryrun_multichip(2, cpu=True)
    assert len(lines) == 8, lines
    assert all(s.startswith("[dryrun] ") and s.endswith("ok on 2 devices")
               for s in lines)


def test_more_devices_than_cards_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA devices"):
        bench_scaling_torch.main(["--devices", "1", "2"])
    with pytest.raises(RuntimeError, match="4 ranks need 4 CUDA devices"):
        dryrun_multichip(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_scaling_torch.main(["--devices", "1"])


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layer", ["sir_max", "gat"])
def test_four_shards_rank_by_rank_on_card(cuda_device, layer):
    """A SIR max layer (H = O = 64) and a GATv2 layer on four row shards
    of a 4,096-node graph, one rank after another on the card, each handed
    the gathered table: the joined rows against the single card's at
    FWD_TOL, the summed src and weight gradients at BWD_TOL. No kernel of
    the port launches."""
    from sir_gcn_tpu_torch.models import SIRConv
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from sir_gcn_tpu_torch.ops.ell import leaky_relu

    rng = np.random.default_rng(0)
    n, e, h = 4096, 32768, 64
    g = build_graph(rng.integers(0, n, e), rng.integers(0, n, e), n,
                    pad_multiple=512, device=cuda_device)
    x = torch.from_numpy(rng.normal(size=(g.n_pad, h)).astype(
        np.float32)).to(cuda_device)
    gen = torch.Generator().manual_seed(0)
    if layer == "sir_max":
        conv = SIRConv(h, h, h, leaky_relu(0.2), agg_type="max",
                       generator=gen).to(cuda_device)
        table = conv.linear_key
    else:
        conv = GATv2Conv(h, 16, 4, share_weights=False, residual=True,
                         generator=gen).to(cuda_device)
        table = conv.fc_src
    reset_launch_counts()
    xr = x.clone().requires_grad_()
    want = conv(g, xr)
    want.square().sum().backward()
    want_g = {k: p.grad.clone() for k, p in conv.named_parameters()}
    conv.zero_grad()
    outs, g_x = [], torch.zeros_like(x)
    for r in range(4):
        xf = x.clone().requires_grad_()
        sg = shard_full_graph(g, 4, r, gather=lambda t, xf=xf: table(xf)
                              .reshape((-1,) + t.shape[1:]))
        xl = x[sg.rows].clone().requires_grad_()
        out = conv(sg, xl)
        out.square().sum().backward()
        outs.append(out.detach())
        g_x = g_x + xf.grad
        g_x[sg.rows] += xl.grad
    torch.cuda.synchronize()
    assert not any(LAUNCHES.values()), dict(LAUNCHES)
    torch.testing.assert_close(torch.cat(outs), want.detach(), **FWD_TOL)
    torch.testing.assert_close(g_x, xr.grad, **BWD_TOL)
    for k, p in conv.named_parameters():
        torch.testing.assert_close(p.grad, want_g[k], **BWD_TOL)
