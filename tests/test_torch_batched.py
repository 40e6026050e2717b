"""The batched-graph workloads of the port (ZINC, ogbg-molhiv, SBM and
super-pixel: ``sir_gcn_tpu_torch/experiments/{batched_harness,
common_models,zinc,ogbg_molhiv,sbm,super_pixel}``, with VirtualNode,
CentralityEncoder, the OGB encoders, SIRConvBase/SIREConvBase, SIREConv
with max, ``data/prefetch.py`` and the batched-graph loaders) against the
JAX package's, with the flax weights carried across by
``load_jax_variables``: outputs and every weight gradient of each model,
three AdamW steps, one FLAG step from the same perturbation, the
synthetic datasets array-equal, the parameter counts of the README
commands, and the entry points on the CPU at a tiny size.

Tolerances are the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients
atol 3e-4 / rtol 1e-3. JAX is imported inside the tests, so the card
tests collect without flax.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

import sir_gcn_tpu_torch.experiments.ogbg_molhiv.model as tmol_model
import sir_gcn_tpu_torch.experiments.ogbg_molhiv.train as tmol
import sir_gcn_tpu_torch.experiments.sbm.train as tsbm
import sir_gcn_tpu_torch.experiments.super_pixel.train as tsp
import sir_gcn_tpu_torch.experiments.zinc.model as tzinc_model
import sir_gcn_tpu_torch.experiments.zinc.train as tzinc
from sir_gcn_tpu_torch import batch_graphs
from sir_gcn_tpu_torch.data import (
    GraphCollection,
    prefetch,
    synthetic_molecules,
    synthetic_ogb_molecules,
)
from sir_gcn_tpu_torch.experiments.batched_harness import apply_self_loops
from sir_gcn_tpu_torch.experiments.common_models import (
    GraphGATModel,
    GraphSIRModel,
)
from sir_gcn_tpu_torch.models import (
    MLP,
    AtomEncoder,
    BondEncoder,
    CentralityEncoder,
    Embed,
    SIRConvBase,
    SIREConv,
    SIREConvBase,
    VirtualNode,
)
from sir_gcn_tpu_torch.ops.ell import build_fast_graph, leaky_relu
from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
from sir_gcn_tpu_torch.train import make_adamw, param_count
from sir_gcn_tpu_torch.utils import load_jax_variables
from sir_gcn_tpu_torch.utils.convert import _slots

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
H = 8
ACT = leaky_relu(0.2)


@pytest.fixture(autouse=True)
def f32_edges_one_thread():
    """The trainers set the process-wide edge dtype: keep each test at f32;
    one intra-op thread for these tiny graphs under parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    set_edge_dtype(None)
    yield
    set_edge_dtype(None)
    torch.set_num_threads(threads)


def _flat(tree, prefix=("params",)):
    import jax

    return {prefix + tuple(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_grads_match(model, grads_j):
    """Every params-slot gradient of the port ``model`` against flax's."""
    slots = {k: v for k, v in _slots(model).items() if k[0] == "params"}
    flat = _flat(grads_j)
    assert set(flat) == set(slots)
    for key, g in flat.items():
        tensor, transpose = slots[key]
        have = tensor.grad.numpy()
        np.testing.assert_allclose(have.T if transpose else have, g,
                                   **BWD_TOL, err_msg="/".join(key))


def _jleaky(x):
    import jax

    return jax.nn.leaky_relu(x, 0.2)


# ---------------------------------------------------------------- data

def _datasets(seed):
    """{name: (port arrays, JAX arrays)} of the four synthetic sets."""
    from experiments.sbm.train import synthetic_sbm as j_sbm
    from experiments.super_pixel.train import synthetic_superpixel as j_sp
    from sir_gcn_tpu.data import loaders as jload

    return {
        "zinc": (synthetic_molecules(12, seed=seed),
                 jload.synthetic_molecules(12, seed=seed)),
        "molhiv": (synthetic_ogb_molecules(12, seed=seed),
                   jload.synthetic_ogb_molecules(12, seed=seed)),
        "sbm": (tsbm.synthetic_sbm(6, 20, 6, seed),
                j_sbm(6, 20, 6, seed)),
        "super_pixel": (tsp.synthetic_superpixel(5, 10, True, seed),
                        j_sp(5, 10, True, seed)),
        "super_pixel_1d": (tsp.synthetic_superpixel(5, 10, False, seed),
                           j_sp(5, 10, False, seed)),
    }


def _assert_equal_nested(a, b, where=""):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_nested(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
        assert a.dtype == np.asarray(b).dtype, where
    else:
        assert a == b, where


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_datasets_equal_jax(seed):
    for name, (t, j) in _datasets(seed).items():
        _assert_equal_nested(t, j, name)


def test_apply_self_loops_equals_jax():
    from experiments.batched_harness import apply_self_loops as j_loops

    graphs, _, efeats, _ = synthetic_ogb_molecules(6, seed=1)
    graphs = [(np.concatenate([s, [0, 2]]).astype(np.int32),
               np.concatenate([d, [0, 2]]).astype(np.int32), n)
              for s, d, n in graphs]  # existing loops to drop
    efeats = [np.concatenate([e, e[:2]]) for e in efeats]
    for ef in (efeats, None):
        _assert_equal_nested(apply_self_loops(graphs, ef),
                             j_loops(graphs, ef))


def test_graph_batch_num_nodes_and_broadcast_match_jax():
    from sir_gcn_tpu import batch_graphs as j_batch_graphs

    graphs = [(np.array([0, 1]), np.array([1, 0]), 3),
              (np.zeros(0, int), np.zeros(0, int), 0),
              (np.array([0]), np.array([1]), 2)]
    kw = dict(n_pad=8, e_pad=8, g_pad=5)
    jg, tg = j_batch_graphs(graphs, **kw), batch_graphs(graphs, **kw)
    np.testing.assert_array_equal(tg.batch_num_nodes().numpy(),
                                  np.asarray(jg.batch_num_nodes()))
    gf = np.arange(15, dtype=np.float32).reshape(5, 3)
    np.testing.assert_array_equal(
        tg.broadcast_nodes(torch.from_numpy(gf)).numpy(),
        np.asarray(jg.broadcast_nodes(gf)))
    assert tg.to("cpu") is tg


# ------------------------------------------------------------ prefetch

def test_prefetch_keeps_order():
    assert list(prefetch(iter(range(100)), size=4)) == list(range(100))


def test_prefetch_reraises_the_producers_exception():
    def gen():
        yield 1
        raise ValueError("boom")

    it = prefetch(gen(), size=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)


def test_prefetch_with_a_graph_collection():
    rng = np.random.default_rng(0)
    graphs = [(rng.integers(0, 5, 8), rng.integers(0, 5, 8), 5)
              for _ in range(20)]
    coll = GraphCollection(graphs, node_feats=[rng.normal(size=(5, 3))
                                               for _ in range(20)],
                           labels=np.arange(20, dtype=np.float32))
    direct = list(coll.loader(np.arange(20), 8, np.random.default_rng(1)))
    pre = list(prefetch(coll.loader(np.arange(20), 8,
                                    np.random.default_rng(1))))
    assert len(direct) == len(pre) == 3
    for a, b in zip(direct, pre):
        for k in ("labels", "node_feats", "graph_weights"):
            np.testing.assert_array_equal(a[k], b[k])
        for k in a["graph"].host:
            np.testing.assert_array_equal(a["graph"].host[k],
                                          b["graph"].host[k])


# -------------------------------------------------------------- layers

def _small_graphs():
    """Both packages' batch of four molecules (one partial-batch padding
    slot), with the OGB features and a node table [N_pad, H]."""
    from sir_gcn_tpu import batch_graphs as j_batch_graphs

    graphs, nf, ef, _ = synthetic_ogb_molecules(4, min_nodes=3,
                                                max_nodes=7, seed=2)
    kw = dict(n_pad=32, e_pad=48, g_pad=6)
    jg, tg = j_batch_graphs(graphs, **kw), batch_graphs(graphs, **kw)
    n, e = tg.num_nodes, tg.num_edges
    nfeat = np.zeros((32, 9), np.int32)
    nfeat[:n] = np.concatenate(nf)
    efeat = np.zeros((48, 3), np.int32)
    efeat[:e] = np.concatenate(ef)
    x = np.random.default_rng(3).normal(size=(32, H)).astype(np.float32)
    return SimpleNamespace(jg=jg, tg=tg, nfeat=nfeat, efeat=efeat, x=x,
                           graphs=graphs)


def _vjp_flax(module, args, variables, gw, train=False):
    """(out, param grads, grads of the float args) of sum(out * gw)."""
    import jax
    import jax.numpy as jnp

    floats = [i for i, a in enumerate(args)
              if isinstance(a, np.ndarray) and a.dtype == np.float32]

    def f(params, *fl):
        a = list(args)
        for i, v in zip(floats, fl):
            a[i] = v
        out = module.apply({**variables, "params": params}, *a)
        if isinstance(out, tuple):
            out = jnp.concatenate(out, 0)
        return jnp.sum(out * gw), out

    (_, out), grads = jax.value_and_grad(
        f, argnums=tuple(range(1 + len(floats))), has_aux=True)(
        variables["params"], *(jnp.asarray(args[i]) for i in floats))
    return np.asarray(out), grads[0], [np.asarray(g) for g in grads[1:]]


@pytest.mark.parametrize("residual", [False, True])
def test_virtual_node_matches_flax(residual):
    """One hook cycle (``node_emb`` then ``vn_emb``, flax's ``__call__``)
    with a two-layer MLP: the node table and the next VN state, and every
    gradient."""
    import jax
    from sir_gcn_tpu.models import MLP as JMLP
    from sir_gcn_tpu.models import VirtualNode as JVN

    s = _small_graphs()
    jvn = JVN(True, H, residual,
              mod_emb=JMLP(H, H, H, 2, activation=_jleaky, with_graph=True,
                           include_last=False))
    variables = jvn.init(jax.random.PRNGKey(0), s.jg, s.x)
    gw = np.random.default_rng(4).normal(
        size=(32 + 6, H)).astype(np.float32)
    out_j, gp, (gx,) = _vjp_flax(jvn, (s.jg, s.x), variables, gw)

    tvn = VirtualNode(True, H, residual,
                      mod_emb=MLP(H, H, H, 2, activation=ACT,
                                  with_graph=True, include_last=False))
    load_jax_variables(tvn, variables)
    xt = torch.from_numpy(s.x).requires_grad_()
    nodes, vn = tvn.node_emb(s.tg, xt)
    vn = tvn.vn_emb(s.tg, nodes, vn)
    out = torch.cat([nodes, vn])
    (out * torch.from_numpy(gw)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out_j, **FWD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), gx, **BWD_TOL)
    assert_grads_match(tvn, gp)
    off = VirtualNode(False, H, residual)
    assert off.node_emb(s.tg, xt, None) == (xt, None)
    assert off.vn_emb(s.tg, xt, None) is None
    assert param_count(off) == 0


@pytest.mark.parametrize("direction,max_degree", [
    ("in", 3), ("out", 2), ("both", 4), ("both", 0)])
def test_centrality_encoder_matches_flax(direction, max_degree):
    import jax
    from sir_gcn_tpu.models import CentralityEncoder as JCE

    s = _small_graphs()
    jce = JCE(max_degree, H, direction)
    variables = jce.init(jax.random.PRNGKey(1), s.jg, s.x)
    if not variables:
        variables = {"params": {}}
    gw = np.random.default_rng(5).normal(size=(32, H)).astype(np.float32)
    out_j, gp, _ = _vjp_flax(jce, (s.jg, s.x), variables, gw)
    tce = CentralityEncoder(max_degree, H, direction)
    load_jax_variables(tce, variables)
    out = tce(s.tg, torch.from_numpy(s.x))
    np.testing.assert_allclose(out.detach().numpy(), out_j, **FWD_TOL)
    if max_degree:
        (out * torch.from_numpy(gw)).sum().backward()
        assert_grads_match(tce, gp)
        assert tce.encoder_in is None or not tce.encoder_in.embedding[
            0].any()  # padding_idx 0 starts at zero
    else:
        assert param_count(tce) == 0


@pytest.mark.parametrize("enc", ["atom", "bond"])
def test_ogb_encoders_match_flax(enc):
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.models.encoders import AtomEncoder as JAtom
    from sir_gcn_tpu.models.encoders import BondEncoder as JBond

    s = _small_graphs()
    feats = s.nfeat if enc == "atom" else s.efeat
    jm, tm = ((JAtom(H), AtomEncoder(H)) if enc == "atom"
              else (JBond(H), BondEncoder(H)))
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(feats))
    gw = np.random.default_rng(6).normal(
        size=(feats.shape[0], H)).astype(np.float32)
    out_j, gp, _ = _vjp_flax(jm, (feats,), variables, gw)
    load_jax_variables(tm, variables)
    out = tm(torch.from_numpy(feats))
    (out * torch.from_numpy(gw)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out_j, **FWD_TOL)
    assert_grads_match(tm, gp)


@pytest.mark.parametrize("agg", ["sum", "max", "sym"])
@pytest.mark.parametrize("edge", [False, True], ids=["node", "edge"])
def test_conv_base_matches_flax(edge, agg):
    """SIRConvBase / SIREConvBase with a two-layer MLP as the message:
    the columns [h_u || h_v (|| h_uv)] in the reference code's order."""
    import jax
    from sir_gcn_tpu.models import MLP as JMLP
    from sir_gcn_tpu.models import SIRConvBase as JBase
    from sir_gcn_tpu.models import SIREConvBase as JEBase

    s = _small_graphs()
    ef = np.random.default_rng(7).normal(size=(48, 3)).astype(np.float32)
    width = 2 * H + (3 if edge else 0)
    jmsg = JMLP(width, 6, 5, 2, activation=_jleaky, with_graph=False)
    jconv = (JEBase(jmsg, agg) if edge else JBase(jmsg, agg))
    args = (s.jg, s.x, ef) if edge else (s.jg, s.x)
    variables = jconv.init(jax.random.PRNGKey(3), *args)
    gw = np.random.default_rng(8).normal(size=(32, 5)).astype(np.float32)
    out_j, gp, gx = _vjp_flax(jconv, args, variables, gw)

    tmsg = MLP(width, 6, 5, 2, activation=ACT, with_graph=False)
    load_jax_variables(tmsg, {"params": variables["params"]["message_func"]})
    tconv = SIREConvBase(tmsg, agg) if edge else SIRConvBase(tmsg, agg)
    ts = [torch.from_numpy(a).requires_grad_()
          for a in ((s.x, ef) if edge else (s.x,))]
    out = tconv(s.tg, *ts)
    (out * torch.from_numpy(gw)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out_j, **FWD_TOL)
    for t, g in zip(ts, gx):
        np.testing.assert_allclose(t.grad.numpy(), g, **BWD_TOL)
    assert_grads_match(tmsg, gp["message_func"])


@pytest.mark.parametrize("encoder", ["linear", "embed", "bond"])
def test_sireconv_max_on_a_graph_batch_matches_jax(encoder):
    """SIREConv with max on a plain GraphBatch (the CSR aggregate): W_R
    per edge before the reduce, ``relation_kernel`` and
    ``relation_bias``; output, node and edge-feature gradients and every
    weight gradient, without and with a DropEdge mask."""
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.models import Embed as JEmbed
    from sir_gcn_tpu.models import SIREConv as JSIREConv
    from sir_gcn_tpu.models.encoders import BondEncoder as JBond

    s = _small_graphs()
    if encoder == "linear":
        ef = np.random.default_rng(9).normal(size=(48, 3)).astype(np.float32)
        jenc, tenc = None, None
    elif encoder == "embed":
        ef = (s.efeat[:, 0] % 4).astype(np.int32)
        jenc, tenc = (lambda e: JEmbed(4, H, name="edge_encoder")(e),
                      Embed(4, H))
    else:
        ef = s.efeat
        jenc, tenc = (lambda e: JBond(H, name="edge_encoder")(e),
                      BondEncoder(H))
    jconv = JSIREConv(H, 6, _jleaky, agg_type="max", edge_encoder=jenc)
    variables = jconv.init(jax.random.PRNGKey(4), s.jg, s.x, ef)
    mask = np.random.default_rng(10).random(48) > 0.3
    gw = np.random.default_rng(11).normal(size=(32, 6)).astype(np.float32)
    tconv = SIREConv(H, 3, H, 6, ACT, agg_type="max", edge_encoder=tenc)
    load_jax_variables(tconv, variables)
    for emask in (None, mask):
        def f(params, x, e):
            out = jconv.apply({"params": params}, s.jg, x, e,
                              edge_mask=None if emask is None
                              else jnp.asarray(emask))
            return jnp.sum(out * gw), out

        argnums = (0, 1, 2) if encoder == "linear" else (0, 1)
        (_, out_j), grads = jax.value_and_grad(f, argnums=argnums,
                                               has_aux=True)(
            variables["params"], jnp.asarray(s.x), jnp.asarray(ef))
        tconv.zero_grad()
        xt = torch.from_numpy(s.x).requires_grad_()
        et = torch.from_numpy(ef).requires_grad_(encoder == "linear")
        out = tconv(s.tg, xt, et, edge_mask=None if emask is None
                    else torch.from_numpy(emask))
        (out * torch.from_numpy(gw)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                                   **FWD_TOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grads[1]),
                                   **BWD_TOL)
        if encoder == "linear":
            np.testing.assert_allclose(et.grad.numpy(),
                                       np.asarray(grads[2]), **BWD_TOL)
        assert_grads_match(tconv, grads[0])


def test_sireconv_max_raises_on_a_fast_graph():
    """On a FastGraph a registry σ with max and an edge term, which raised
    before the max kernels had their edge-term forms, now takes them: the
    same layer on the batch's FastGraph equals it on the plain batch (the
    CSR aggregate), out and every gradient."""
    s = _small_graphs()
    fg = build_fast_graph(s.tg)
    conv = SIREConv(H, 3, H, 6, ACT, agg_type="max",
                    generator=torch.Generator().manual_seed(4))
    ef = torch.from_numpy(np.random.default_rng(5).normal(
        size=(s.tg.num_edges, 3)).astype(np.float32))
    gw = torch.from_numpy(np.random.default_rng(6).normal(
        size=(32, 6)).astype(np.float32))
    runs = []
    for graph in (fg, s.tg):
        conv.zero_grad()
        x = torch.from_numpy(s.x).requires_grad_()
        out = conv(graph, x, ef)
        (out * gw).sum().backward()
        runs.append([out.detach(), x.grad] + [p.grad.clone()
                                              for p in conv.parameters()])
    for i, (a, b) in enumerate(zip(*runs)):
        torch.testing.assert_close(a, b, **(FWD_TOL if i == 0 else BWD_TOL))


# -------------------------------------------------------------- models

MODEL_CASES = {
    # harness, model, kwargs
    "zinc_gn_jk_res": ("zinc", "SIR", dict(
        norm="gn", jumping_knowledge=True, residual=True)),
    "zinc_bn_jk_res": ("zinc", "SIR", dict(
        norm="bn", jumping_knowledge=True, residual=True)),
    "zinc_edge_max": ("zinc", "SIR", dict(
        use_edge_feats=True, agg_type="max", residual=True, resid_layers=1,
        norm="bn")),
    "zinc_cn_sym": ("zinc", "SIR", dict(norm="cn", agg_type="sym")),
    "zinc_ln_mean": ("zinc", "SIR", dict(
        norm="ln", agg_type="mean", jumping_knowledge=True,
        readout_layers=2, readout_pooling="mean")),
    "zinc_gin": ("zinc", "GIN", dict(norm="gn", mlp_layers=2,
                                     jumping_knowledge=True, residual=True)),
    "sbm_sir": ("sbm", "SIR", dict(agg_type="mean", jumping_knowledge=True,
                                   norm="gn")),
    "sbm_gat": ("sbm", "GAT", dict(num_heads=2, residual=True, norm="bn",
                                   jumping_knowledge=True)),
    "super_pixel": ("super_pixel", "SIR", dict(jumping_knowledge=True,
                                               norm="ln")),
    "molhiv_vn": ("molhiv", "SIR", dict(virtual_node=True, vn_layers=2,
                                        norm="bn", vn_residual=True)),
    "molhiv_rich": ("molhiv", "SIR", dict(
        use_edge_feats=True, readout_layers=1, jumping_knowledge=True,
        residual=True, norm="gn", centrality=True)),
    "molhiv_gin_vn": ("molhiv", "GIN", dict(virtual_node=True, norm="bn")),
}


def _port_data(harness, n=9, nodes=12):
    """(port collection, its graphs and feature kwargs, feature dims) of
    ``n`` synthetic graphs of a harness (SBM graphs of up to ``nodes``
    nodes)."""
    if harness == "zinc":
        g, nf, ef, lab = synthetic_molecules(n, seed=0)
        kw = dict(node_feats=nf, edge_feats=ef, labels=lab)
        dims = dict(input_dim=28, edge_dim=4)
    elif harness == "molhiv":
        g, nf, ef, lab = synthetic_ogb_molecules(n, max_nodes=12, seed=0)
        kw = dict(node_feats=nf, edge_feats=ef, labels=lab)
        dims = dict(max_degree=tmol.dataset_max_degree(g))
    elif harness == "sbm":
        g, nf, nl = tsbm.synthetic_sbm(n, nodes, 2, 0)
        kw = dict(node_feats=nf, node_labels=nl)
        dims = dict(input_dim=3, classes=2)
    else:
        g, nf, lab = tsp.synthetic_superpixel(n, 10, True, 0)
        kw = dict(node_feats=nf, labels=lab)
        dims = dict(input_dim=3, classes=10)
    return GraphCollection(g, **kw), (g, kw), dims


def _harness_data(harness):
    """(port collection, JAX collection, feature dims) of nine graphs."""
    from sir_gcn_tpu.data.batching import GraphCollection as JColl

    coll, (g, kw), dims = _port_data(harness)
    return coll, JColl(g, **kw), dims


def _port_model(harness, name, kw, dims, layers=2):
    """The port's model of a case, hidden H, two layers, seeded."""
    kw = dict(kw)
    gen = torch.Generator().manual_seed(0)
    if harness == "zinc":
        make = tzinc_model.make_sir_model if name == "SIR" else \
            tzinc_model.make_gin_model
        return make(dims["input_dim"], dims["edge_dim"], H, 1,
                    num_layers=layers, generator=gen, **kw)
    if harness == "molhiv":
        if kw.pop("centrality", False):
            kw["max_degree"] = dims["max_degree"]
        return tmol_model.MODELS[name](H, 1, num_layers=layers,
                                       generator=gen, **kw)
    c = dims["classes"]
    if name == "GAT":
        return GraphGATModel(Embed(dims["input_dim"], kw["num_heads"] * H,
                                   generator=gen), H, c, num_layers=layers,
                             pool_after_readout=False, generator=gen, **kw)
    if harness == "sbm":
        return GraphSIRModel(Embed(dims["input_dim"], H, generator=gen), H,
                             H, c, num_layers=layers,
                             pool_after_readout=False, generator=gen, **kw)
    return GraphSIRModel(nn.Identity(), dims["input_dim"], H, c,
                         num_layers=layers, generator=gen, **kw)


def _model_pair(harness, name, kw, dims, layers=2):
    """(flax model, port model) of one case, hidden H."""
    from experiments.common_models import GraphGATModel as JGAT
    from experiments.common_models import GraphSIRModel as JGSIR
    from experiments.ogbg_molhiv import model as jmol
    from experiments.zinc import model as jzinc
    from sir_gcn_tpu.models import Embed as JEmbed

    tm = _port_model(harness, name, kw, dims, layers)
    kw = dict(kw)
    if harness == "zinc":
        jmake = jzinc.make_sir_model if name == "SIR" else \
            jzinc.make_gin_model
        return (jmake(dims["input_dim"], dims["edge_dim"], H, 1,
                      num_layers=layers, **kw), tm)
    if harness == "molhiv":
        if kw.pop("centrality", False):
            kw["max_degree"] = dims["max_degree"]
        return (getattr(jmol, f"{name}Model")(hidden_dim=H, output_dim=1,
                                              num_layers=layers, **kw), tm)
    c = dims["classes"]
    if name == "GAT":
        jenc = (lambda mdl, f: JEmbed(dims["input_dim"],
                                      kw["num_heads"] * H,
                                      name="node_encoder")(f))
        return (JGAT(encoder=jenc, hidden_dim=H, output_dim=c,
                     num_layers=layers, pool_after_readout=False, **kw), tm)
    if harness == "sbm":
        jenc = (lambda mdl, f: JEmbed(dims["input_dim"], H,
                                      name="node_encoder")(f))
        return (JGSIR(encoder=jenc, hidden_dim=H, output_dim=c,
                      num_layers=layers, pool_after_readout=False, **kw), tm)
    return (JGSIR(encoder=lambda mdl, f: f, hidden_dim=H, output_dim=c,
                  num_layers=layers, **kw), tm)


def _model_inputs(harness, batch):
    edge = harness in ("zinc", "molhiv")
    arrays = [batch["node_feats"]] + ([batch["edge_feats"]] if edge else [])
    return arrays


def _setup_model(case, idx=np.array([5, 0, 7])):
    import jax
    import jax.numpy as jnp

    harness, name, kw = MODEL_CASES[case]
    coll, jcoll, dims = _harness_data(harness)
    tb, jb = coll.collate(idx, 4), jcoll.collate(idx, 4)
    jm, tm = _model_pair(harness, name, kw, dims)
    arrays = _model_inputs(harness, tb)
    variables = jm.init(jax.random.PRNGKey(1), jb["graph"],
                        *(jnp.asarray(a) for a in arrays))
    load_jax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    return SimpleNamespace(jm=jm, tm=tm, variables=variables, jb=jb, tb=tb,
                           arrays=arrays, harness=harness)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_matches_flax(case):
    """Two layers at hidden 8 on a partial batch of three graphs (an
    empty graph slot before the padding one), in training mode with the
    dropouts at 0: the output on every row, every weight gradient of
    sum(out * gw), and the BatchNorms' running statistics after the
    step."""
    import jax
    import jax.numpy as jnp

    s = _setup_model(case)
    stats = s.variables.get("batch_stats", {})

    def f(params):
        out, upd = s.jm.apply(
            {"params": params, "batch_stats": stats}, s.jb["graph"],
            *(jnp.asarray(a) for a in s.arrays), deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(2)},
            mutable=["batch_stats"])
        gw = jnp.asarray(np.random.default_rng(3).normal(
            size=out.shape).astype(np.float32))
        return jnp.sum(out * gw), (out, gw, upd)

    (_, (out_j, gw, upd)), grads = jax.value_and_grad(f, has_aux=True)(
        s.variables["params"])
    s.tm.train()
    out = s.tm(s.tb["graph"], *(torch.from_numpy(a) for a in s.arrays))
    (out * torch.from_numpy(np.array(gw))).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **FWD_TOL)
    assert_grads_match(s.tm, grads)
    slots = _slots(s.tm)
    for key, v in _flat(upd.get("batch_stats", {}),
                        ("batch_stats",)).items():
        np.testing.assert_allclose(slots[key][0].numpy(), v, **FWD_TOL,
                                   err_msg="/".join(key))
    s.tm.eval()
    with torch.no_grad():
        out_e = s.tm(s.tb["graph"], *(torch.from_numpy(a)
                                      for a in s.arrays))
    want_e = s.jm.apply({"params": s.variables["params"],
                         "batch_stats": upd.get("batch_stats", {})},
                        s.jb["graph"], *(jnp.asarray(a) for a in s.arrays))
    np.testing.assert_allclose(out_e.numpy(), np.asarray(want_e), **FWD_TOL)


def _jax_losses():
    """The JAX harnesses' losses, as their train.py files write them."""
    import jax
    import jax.numpy as jnp

    def l1_loss(preds, labels, weights):
        err = jnp.abs(preds[:, 0] - labels)
        return jnp.sum(err * weights) / jnp.maximum(jnp.sum(weights), 1.0)

    def weighted_ce(preds, labels, weights, num_classes=3):
        labels = labels.astype(jnp.int32)
        n = jnp.maximum(jnp.sum(weights), 1.0)
        counts = jnp.zeros(num_classes).at[labels].add(weights)
        cw = (n - counts) * (counts > 0) / n
        logp = jax.nn.log_softmax(preds)
        ce = -jnp.take_along_axis(logp, labels[:, None], 1)[:, 0]
        w = weights * jnp.take(cw, labels)
        return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1e-9)

    def ce(preds, labels, weights):
        labels = labels.astype(jnp.int32)
        logp = jax.nn.log_softmax(preds)
        cel = -jnp.take_along_axis(logp, labels[:, None], 1)[:, 0]
        return jnp.sum(cel * weights) / jnp.maximum(jnp.sum(weights), 1.0)

    def bce(preds, labels, weights):
        p = jax.nn.sigmoid(preds[:, 0])
        eps = 1e-7
        c = -(labels * jnp.log(p + eps) + (1 - labels) * jnp.log(1 - p + eps))
        return jnp.sum(c * weights) / jnp.maximum(jnp.sum(weights), 1.0)

    return {"zinc": l1_loss, "sbm": weighted_ce, "super_pixel": ce,
            "molhiv": bce}


@pytest.mark.parametrize("harness", ["zinc", "sbm", "super_pixel",
                                     "molhiv"])
def test_losses_match_jax(harness):
    """Each harness's loss and its gradient on the predictions, with a
    padding row of weight 0 and, for SBM, a class absent from the
    batch."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    c = {"zinc": 1, "sbm": 3, "super_pixel": 4, "molhiv": 1}[harness]
    preds = rng.normal(size=(10, c)).astype(np.float32)
    w = (np.arange(10) < 8).astype(np.float32)
    if harness in ("sbm", "super_pixel"):
        labels = rng.integers(0, 2, 10).astype(np.int64)
    elif harness == "molhiv":
        labels = rng.integers(0, 2, 10).astype(np.float32)
    else:
        labels = rng.normal(size=10).astype(np.float32)
    port = {"zinc": tzinc.l1_loss, "sbm": tsbm.make_weighted_ce(3),
            "super_pixel": tsp.ce_loss, "molhiv": tmol.bce}[harness]
    jl, jg = jax.value_and_grad(_jax_losses()[harness])(
        jnp.asarray(preds), jnp.asarray(labels), jnp.asarray(w))
    pt = torch.from_numpy(preds).requires_grad_()
    loss = port(pt, torch.from_numpy(labels), torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **FWD_TOL)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jg), **BWD_TOL)


def test_three_adamw_steps_match_jax():
    """Three AdamW steps of the zinc GraphSIRModel (BatchNorm, JK,
    residual) on three batches, from the same weights: each step's loss
    and the final weights. Adam's first step is about lr * sign(g), so
    entries whose gradient at some step is under 1e-6 are left out. Such
    an entry must not move the loss either: the bias before a BatchNorm
    has none (with GraphNorm, whose mean_scale moves off 1 in the first
    step, it would, and the rounding noise of its zero gradient, which
    Adam scales up to lr, would part the two runs). For that reason the
    running means, which take that bias in, are not compared here;
    ``test_model_matches_flax`` holds them after one step."""
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.train import init_state
    from sir_gcn_tpu.train import make_adamw as j_make_adamw

    s = _setup_model("zinc_bn_jk_res")
    coll, jcoll, _ = _harness_data("zinc")
    lr = 1e-2
    tx = j_make_adamw(lr, 0.0)
    state = init_state(s.variables, tx)
    params, opt_state = state.params, state.opt_state
    stats = state.batch_stats
    opt = make_adamw(s.tm.parameters(), lr, 0.0)
    small = {}
    for sel in (np.arange(0, 3), np.arange(3, 6), np.arange(6, 9)):
        tb, jb = coll.collate(sel, 4), jcoll.collate(sel, 4)

        def loss_j(p):
            out, upd = s.jm.apply(
                {"params": p, "batch_stats": stats}, jb["graph"],
                jnp.asarray(tb["node_feats"]), deterministic=False,
                mutable=["batch_stats"])
            return _jax_losses()["zinc"](
                out, jnp.asarray(tb["labels"]),
                jnp.asarray(tb["graph_weights"])), upd["batch_stats"]

        (lj, stats), grads = jax.value_and_grad(loss_j, has_aux=True)(
            params)
        for k, g in _flat(grads).items():
            small[k] = small.get(k, False) | (np.abs(g) < 1e-6)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

        s.tm.train()
        opt.zero_grad()
        loss = tzinc.l1_loss(
            s.tm(tb["graph"], torch.from_numpy(tb["node_feats"])),
            torch.from_numpy(tb["labels"]),
            torch.from_numpy(tb["graph_weights"]))
        loss.backward()
        opt.step()
        np.testing.assert_allclose(float(loss.detach()), float(lj), **FWD_TOL)
    slots = _slots(s.tm)
    for key, p in _flat(params).items():
        tensor, transpose = slots[key]
        have = tensor.detach().numpy()
        have = have.T if transpose else have
        keep = ~small[key]
        np.testing.assert_allclose(have[keep], p[keep], **FWD_TOL,
                                   err_msg="/".join(key))


def test_flag_step_matches_jax():
    """One FLAG step of the molhiv SIR model (virtual node, BatchNorm),
    m = 2 so three passes, from one perturbation passed in on both sides:
    JAX's arithmetic of experiments/ogbg_molhiv/train.py:132-164 (each
    loss / (m + 1), parameter gradients summed, perturb += step *
    sign(d perturb), batch_stats threaded through the passes) against
    ``make_train_step``. Checked: the summed loss, the summed gradients
    (read before any update: the optimizer's rate is 0) and the running
    statistics after the three passes."""
    import jax
    import jax.numpy as jnp

    s = _setup_model("molhiv_vn")
    args = SimpleNamespace(flag=True, m=2, step_size=1e-2, nhidden=H,
                           l1=0.0, l2=0.0)
    m = args.m + 1
    tb = s.tb
    perturb0 = (np.random.default_rng(4).uniform(
        -args.step_size, args.step_size,
        size=(tb["node_feats"].shape[0], H))).astype(np.float32)

    labels = jnp.asarray(tb["labels"])
    weights = jnp.asarray(tb["graph_weights"])

    def lf(params, batch_stats, perturb):
        preds, upd = s.jm.apply(
            {"params": params, "batch_stats": batch_stats}, s.jb["graph"],
            jnp.asarray(tb["node_feats"]), jnp.asarray(tb["edge_feats"]),
            perturb, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        return (_jax_losses()["molhiv"](preds, labels, weights) / m,
                upd["batch_stats"])

    bs = s.variables["batch_stats"]
    perturb = jnp.asarray(perturb0)
    total = 0.0
    acc = jax.tree_util.tree_map(jnp.zeros_like, s.variables["params"])
    for _ in range(m):
        (loss, bs), (gp, gpert) = jax.value_and_grad(
            lf, argnums=(0, 2), has_aux=True)(s.variables["params"], bs,
                                              perturb)
        acc = jax.tree_util.tree_map(lambda a, b: a + b, acc, gp)
        total = total + loss
        perturb = perturb + args.step_size * jnp.sign(gpert)

    step = tmol.make_train_step(s.tm, torch.optim.SGD(s.tm.parameters(),
                                                      lr=0.0), args)
    batch = {k: (v if k == "graph" else torch.from_numpy(v))
             for k, v in tb.items()}
    got = step(batch, None, perturb=torch.from_numpy(perturb0))
    np.testing.assert_allclose(float(got), float(total), **FWD_TOL)
    assert_grads_match(s.tm, acc)
    slots = _slots(s.tm)
    for key, v in _flat(bs, ("batch_stats",)).items():
        np.testing.assert_allclose(slots[key][0].numpy(), v, **FWD_TOL,
                                   err_msg="/".join(key))


# ----------------------------------------------------- parameter counts

README = {
    "zinc": ["--norm", "gn", "--jumping-knowledge", "--residual"],
    "molhiv": ["--virtual-node", "--flag"],
    "sbm": ["--dataset", "PATTERN"],
    "super_pixel": ["--dataset", "MNIST", "--use-feature"],
}


@pytest.mark.parametrize("harness", list(README))
def test_param_counts_of_the_readme_commands(harness):
    """The port's model at each README command (hidden 64, 4 layers) has
    the flax model's parameter count, built as the JAX harness builds
    it."""
    import jax
    import jax.numpy as jnp
    from experiments.common_models import GraphSIRModel as JGSIR
    from experiments.ogbg_molhiv import model as jmol
    from experiments.zinc import model as jzinc
    from sir_gcn_tpu.models import Embed as JEmbed

    mod = {"zinc": tzinc, "molhiv": tmol, "sbm": tsbm,
           "super_pixel": tsp}[harness]
    args = mod._parser().parse_args(README[harness])
    coll, jcoll, dims = _harness_data(harness)
    b = jcoll.collate(np.arange(3), 4)
    if harness == "zinc":
        tm = tzinc.build_model(args, 28, 4)
        jm = jzinc.make_sir_model(
            28, 4, 64, 1, num_layers=4, norm="gn", jumping_knowledge=True,
            residual=True)
    elif harness == "molhiv":
        tm = tmol.build_model(args, 0)
        jm = jmol.SIRModel(hidden_dim=64, output_dim=1, num_layers=4,
                           virtual_node=True, vn_layers=2)
    elif harness == "sbm":
        tm = tsbm.build_model(args, 3, 2)
        jm = JGSIR(encoder=lambda mdl, f: JEmbed(3, 64,
                                                 name="node_encoder")(f),
                   hidden_dim=64, output_dim=2, num_layers=4,
                   agg_type="mean", jumping_knowledge=False,
                   pool_after_readout=False)
    else:
        tm = tsp.build_model(args, 3, 10)
        jm = JGSIR(encoder=lambda mdl, f: f, hidden_dim=64, output_dim=10,
                   num_layers=4, jumping_knowledge=False)
    arrays = _model_inputs(harness, b)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), b["graph"],
                            *(jnp.asarray(a) for a in arrays))
    want = sum(v.size for v in jax.tree_util.tree_leaves(shapes["params"]))
    assert param_count(tm) == want
    # every flax variable has its slot, of its shape
    load_jax_variables(tm, jax.tree_util.tree_map(
        lambda v: np.zeros(v.shape, np.float32), shapes))


def test_centrality_parameters_follow_the_dataset():
    """Under --centrality-encoder the in-degree table has max_degree + 1
    rows, max_degree from the data."""
    graphs = [(np.array([0, 1, 2]), np.array([3, 3, 3]), 4)]
    assert tmol.dataset_max_degree(graphs) == 3
    args = tmol._parser().parse_args(["--centrality-encoder",
                                      "--nhidden", "8", "--nlayers", "1"])
    base = param_count(tmol.build_model(args, 0))
    assert param_count(tmol.build_model(args, 3)) == base + 4 * 8


# -------------------------------------------------------- entry points

TINY = {
    "zinc": (tzinc.main, ["--nhidden", "8", "--nlayers", "2", "--norm",
                          "gn", "--jumping-knowledge", "--residual",
                          "--synthetic-samples", "40", "--batch-size",
                          "16"]),
    "molhiv": (tmol.main, ["--nhidden", "8", "--nlayers", "2",
                           "--virtual-node", "--flag",
                           "--synthetic-samples", "40", "--batch-size",
                           "16"]),
    "sbm": (tsbm.main, ["--nhidden", "8", "--nlayers", "2",
                        "--synthetic-samples", "30", "--batch-size", "8"]),
    "super_pixel": (tsp.main, ["--nhidden", "8", "--nlayers", "2",
                               "--use-feature", "--synthetic-samples", "30",
                               "--batch-size", "8"]),
}


@pytest.mark.parametrize("harness", list(TINY))
def test_entry_point_on_cpu(harness, capsys):
    main, argv = TINY[harness]
    stats = []
    val, test = main(["--cpu", "--epochs", "2", "--nruns", "1",
                      "--log-every", "1", "--edge-bf16"] + argv,
                     stats=stats, time_steps=True)
    assert len(val) == len(test) == 1
    assert np.isfinite(val + test).all()
    out = capsys.readouterr().out
    assert "Epoch 0002" in out and "Runned 1 times" in out
    assert "Params:" in out and "Average test" in out
    (st,) = stats
    assert st["epochs"] == 2 and st["seconds"] > 0
    assert len(st["step_ms"]) == len(st["wait_ms"]) > 0
    assert len(st["collate_ms"]) > 0


@pytest.mark.parametrize("harness", list(TINY))
def test_entry_points_raise_without_a_card(harness, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = TINY[harness]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--nruns", "1", "--epochs", "1"] + argv)


@pytest.mark.parametrize("harness", ["zinc", "sbm", "super_pixel"])
def test_data_parallel_raises(harness, monkeypatch):
    """--dp-devices runs (tests/test_torch_dist_train.py); without a card
    and without --cpu it raises before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = TINY[harness]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dp-devices", "2", "--nruns", "1", "--epochs", "1"] + argv)


def test_fingerprint_needs_rdkit():
    from sir_gcn_tpu_torch.experiments.ogbg_molhiv import fingerprint

    try:
        import rdkit  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="RDKit"):
            fingerprint.generate_fingerprint("CCO")


# ----------------------------------------------------- card against CPU

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_card_matches_cpu(cuda_device, case):
    """Each model case on the card against the same weights on the CPU
    (seeded, no flax there): the output and every weight gradient of
    sum(out * gw), on 8 graphs of its harness in a bucket of 16 (SBM
    graphs of up to 40 nodes). The card's segment sums add in the order
    of its atomics."""
    harness, name, kw = MODEL_CASES[case]
    coll, _, dims = _port_data(harness, n=8, nodes=40)
    model = _port_model(harness, name, kw, dims)
    runs = {}
    for dev in ("cpu", cuda_device):
        b = coll.collate(np.arange(8), 16, dev)
        m = copy.deepcopy(model).to(dev).train()
        out = m(b["graph"], *(torch.from_numpy(a).to(dev)
                              for a in _model_inputs(harness, b)))
        gw = torch.from_numpy(np.random.default_rng(1).normal(
            size=tuple(out.shape)).astype(np.float32)).to(dev)
        (out * gw).sum().backward()
        runs[str(dev)] = (out.detach().cpu(),
                          {k: p.grad.cpu() for k, p in m.named_parameters()
                           if p.grad is not None})
    (o_c, g_c), (o_g, g_g) = runs["cpu"], runs[str(cuda_device)]
    torch.testing.assert_close(o_g, o_c, **FWD_TOL)
    assert set(g_c) == set(g_g)
    for k in g_c:
        torch.testing.assert_close(g_g[k], g_c[k], **BWD_TOL, msg=k)
