"""The port's baseline conv zoo and MLP (``sir_gcn_tpu_torch/models/zoo.py``,
``models/utils.py``) against the JAX package's flax modules, with the flax
weights carried across by ``load_jax_variables``: the output, the input
gradient and every weight gradient of sum(out * cotangent).

The graph is a batch of four graphs with a duplicated edge (max ties), an
isolated node, nodes with no in-edge and a graph with one node and no
edge, padded; each conv also runs under a DropEdge mask that drops every
in-edge of one node. Tolerances are the JAX suite's: forward atol 2e-4 /
rtol 1e-4, gradients atol 3e-4 / rtol 1e-3. JAX is imported inside the
tests, so the card tests collect without flax.
"""

import copy

import numpy as np
import pytest
import torch

from sir_gcn_tpu_torch import batch_graphs
from sir_gcn_tpu_torch.models import (
    MLP,
    GATv2Conv,
    GINConv,
    GINEConv,
    GraphConv,
    PNAConv,
    SAGEConv,
    pna_delta,
)
from sir_gcn_tpu_torch.utils import load_jax_variables
from sir_gcn_tpu_torch.utils.convert import _slots

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
F_IN = 6

# (src, dst, num_nodes): a duplicated edge 0->1 and an isolated node 4;
# nodes 1..3 of the second graph have no in-edge; a one-node graph
GRAPHS = [
    (np.array([0, 0, 1, 2, 3, 2, 0]), np.array([1, 1, 2, 0, 0, 3, 3]), 5),
    (np.array([1, 2, 3, 0]), np.array([0, 0, 0, 0]), 4),
    (np.array([0]), np.array([0]), 1),
    (np.array([0, 1, 2, 2]), np.array([2, 2, 1, 0]), 3),
]
N_PAD, E_PAD, G_PAD = 16, 24, 5


def _graphs():
    from sir_gcn_tpu import batch_graphs as j_batch_graphs

    kw = dict(n_pad=N_PAD, e_pad=E_PAD, g_pad=G_PAD)
    return j_batch_graphs(GRAPHS, **kw), batch_graphs(GRAPHS, **kw)


def _edge_mask(tg):
    """A DropEdge mask over the sorted edges: drops node 2's every
    in-edge and one of node 0's."""
    dst = tg.host["dst"]
    keep = tg.host["edge_mask"].copy()
    keep[dst == 2] = False
    keep[np.flatnonzero(dst == 0)[0]] = False
    return keep


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


def _identity(h):
    return h


def _double(h):
    return 2.0 * h


def _cases():
    """(id, flax module factory, port module factory, takes edge feats)."""
    from sir_gcn_tpu.models import zoo as jzoo

    return {
        "gcn": (lambda: jzoo.GraphConv(5), lambda: GraphConv(F_IN, 5),
                False),
        "gcn_nobias": (lambda: jzoo.GraphConv(5, use_bias=False),
                       lambda: GraphConv(F_IN, 5, use_bias=False), False),
        "gat": (lambda: jzoo.GATv2Conv(4, num_heads=2),
                lambda: GATv2Conv(F_IN, 4, 2), False),
        "gat_dst_res": (
            lambda: jzoo.GATv2Conv(4, num_heads=2, share_weights=False,
                                   residual=True, negative_slope=0.1),
            lambda: GATv2Conv(F_IN, 4, 2, negative_slope=0.1,
                              share_weights=False, residual=True), False),
        "gat_res_identity": (
            lambda: jzoo.GATv2Conv(3, num_heads=2, residual=True,
                                   use_bias=False),
            lambda: GATv2Conv(F_IN, 3, 2, residual=True, use_bias=False),
            False),
        "gin_eps": (lambda: jzoo.GINConv(apply_func=_double, init_eps=0.3,
                                         learn_eps=True),
                    lambda: GINConv(_double, init_eps=0.3, learn_eps=True),
                    False),
        "gin_mean": (lambda: jzoo.GINConv(apply_func=_identity, agg="mean"),
                     lambda: GINConv(_identity, agg="mean"), False),
        "gine": (lambda: jzoo.GINEConv(apply_func=_double, init_eps=0.1),
                 lambda: GINEConv(_double, init_eps=0.1), True),
        "pna": (lambda: jzoo.PNAConv(5), lambda: PNAConv(F_IN, 5), False),
        "pna_full": (
            lambda: jzoo.PNAConv(
                4, aggregators=("sum", "mean", "max", "min", "std", "var"),
                scalers=("identity", "amplification", "attenuation"),
                num_towers=2, delta=0.8),
            lambda: PNAConv(
                F_IN, 4,
                aggregators=("sum", "mean", "max", "min", "std", "var"),
                scalers=("identity", "amplification", "attenuation"),
                num_towers=2, delta=0.8), False),
        "sage": (lambda: jzoo.SAGEConv(5), lambda: SAGEConv(F_IN, 5), False),
    }


CASES = ["gcn", "gcn_nobias", "gat", "gat_dst_res", "gat_res_identity",
         "gin_eps", "gin_mean", "gine", "pna", "pna_full", "sage"]


def _inputs(seed, with_edges):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_PAD, F_IN)).astype(np.float32)
    ef = (rng.normal(size=(E_PAD, F_IN)).astype(np.float32) if with_edges
          else None)
    return rng, x, ef


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "dropedge"])
@pytest.mark.parametrize("case", CASES)
def test_conv_matches_flax(case, masked):
    import jax
    import jax.numpy as jnp

    jg, tg = _graphs()
    make_j, make_t, with_edges = _cases()[case]
    rng, x, ef = _inputs(CASES.index(case), with_edges)
    mask = _edge_mask(tg) if masked else None
    jconv, tconv = make_j(), make_t()
    jargs = (jnp.asarray(ef),) if with_edges else ()
    jkw = {} if mask is None else {"edge_mask": jnp.asarray(mask)}
    variables = jconv.init(jax.random.PRNGKey(0), jg, jnp.asarray(x), *jargs)
    load_jax_variables(tconv, jax.tree_util.tree_map(np.asarray, variables))

    out_j = jconv.apply(variables, jg, jnp.asarray(x), *jargs, **jkw)
    gw = rng.normal(size=out_j.shape).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jconv.apply({"params": p}, jg, x, *jargs, **jkw) * gw)

    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        variables.get("params", {}), jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_()
    targs = (torch.from_numpy(ef),) if with_edges else ()
    tkw = {} if mask is None else {"edge_mask": torch.from_numpy(mask)}
    out = tconv(tg, xt, *targs, **tkw)
    (out * torch.from_numpy(gw)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **FWD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **BWD_TOL)
    assert_grads_match(tconv, g_params)


@pytest.mark.parametrize("norm,with_graph,include_last", [
    ("bn", True, False), ("bn", False, True), ("none", False, True),
    ("none", True, False)])
def test_mlp_matches_flax(norm, with_graph, include_last):
    """Both call signatures, in training mode (BatchNorm on the batch's
    statistics, running statistics updated) and in eval mode."""
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.models import MLP as JMLP

    jg, tg = _graphs()
    rng, x, _ = _inputs(7, False)
    jmlp = JMLP(F_IN, 8, 3, 3, 0.0, norm, jax.nn.relu,
                include_last=include_last, with_graph=with_graph)
    tmlp = MLP(F_IN, 8, 3, 3, 0.0, norm, torch.relu,
               include_last=include_last, with_graph=with_graph)
    jargs = (jg,) if with_graph else ()
    targs = (tg,) if with_graph else ()
    variables = jmlp.init(jax.random.PRNGKey(1), *jargs, jnp.asarray(x))
    load_jax_variables(tmlp, jax.tree_util.tree_map(np.asarray, variables))
    gw = rng.normal(size=(N_PAD, 3)).astype(np.float32)
    stats = variables.get("batch_stats", {})

    def loss(p, x):
        out, upd = jmlp.apply({"params": p, "batch_stats": stats}, *jargs, x,
                              deterministic=False, mutable=["batch_stats"])
        return jnp.sum(out * gw), (out, upd)

    (_, (out_j, upd)), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    tmlp.train()
    xt = torch.from_numpy(x).requires_grad_()
    out = tmlp(*targs, xt)
    (out * torch.from_numpy(gw)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **FWD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **BWD_TOL)
    assert_grads_match(tmlp, g_params)

    slots = _slots(tmlp)
    for key, v in _flat(upd.get("batch_stats", {}),
                        ("batch_stats",)).items():
        np.testing.assert_allclose(slots[key][0].numpy(), v, **FWD_TOL,
                                   err_msg="/".join(key))
    tmlp.eval()
    with torch.no_grad():
        ev = tmlp(*targs, torch.from_numpy(x))
    ev_j = jmlp.apply({"params": variables["params"],
                       "batch_stats": upd.get("batch_stats", {})},
                      *jargs, jnp.asarray(x), deterministic=True)
    np.testing.assert_allclose(ev.numpy(), np.asarray(ev_j), **FWD_TOL)


def test_gin_with_an_mlp_and_learned_eps_matches_flax():
    """A GINConv whose apply function is an MLP (params/apply_func/...)."""
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.models import MLP as JMLP
    from sir_gcn_tpu.models import zoo as jzoo

    jg, tg = _graphs()
    rng, x, _ = _inputs(9, False)
    jconv = jzoo.GINConv(apply_func=JMLP(F_IN, 8, 4, 2, 0.0, "none",
                                         jax.nn.relu, with_graph=False),
                         init_eps=0.2, learn_eps=True)
    tconv = GINConv(MLP(F_IN, 8, 4, 2, 0.0, "none", torch.relu,
                        with_graph=False), init_eps=0.2, learn_eps=True)
    variables = jconv.init(jax.random.PRNGKey(2), jg, jnp.asarray(x))
    load_jax_variables(tconv, jax.tree_util.tree_map(np.asarray, variables))
    gw = rng.normal(size=(N_PAD, 4)).astype(np.float32)

    def loss(p):
        return jnp.sum(jconv.apply({"params": p}, jg, jnp.asarray(x)) * gw)

    g_params = jax.grad(loss)(variables["params"])
    out = tconv(tg, torch.from_numpy(x))
    (out * torch.from_numpy(gw)).sum().backward()
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jconv.apply(variables, jg, jnp.asarray(x))), **FWD_TOL)
    assert_grads_match(tconv, g_params)


def test_gat_attention_dropout_draws_from_the_generator():
    """attn_dropout: eval mode and rate 0 give the same output; training
    mode drops attention weights from the generator, the same ones for
    the same seed."""
    _, tg = _graphs()
    _, x, _ = _inputs(3, False)
    x = torch.from_numpy(x)
    conv = GATv2Conv(F_IN, 4, 2, attn_dropout=0.5,
                     generator=torch.Generator().manual_seed(0))
    plain = copy.deepcopy(conv)
    plain.attn_dropout = 0.0
    conv.eval()
    with torch.no_grad():
        np.testing.assert_array_equal(conv(tg, x).numpy(),
                                      plain(tg, x).numpy())
        conv.train()
        a = conv(tg, x, generator=torch.Generator().manual_seed(5))
        b = conv(tg, x, generator=torch.Generator().manual_seed(5))
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert not np.allclose(a.numpy(), plain(tg, x).numpy())


def test_pna_delta_matches_jax():
    from sir_gcn_tpu.models.zoo import pna_delta as j_pna_delta

    degs = [np.array([0.0, 1.0, 3.0]), np.array([[2.0, 7.0], [0.0, 1.0]])]
    assert pna_delta(degs) == j_pna_delta(degs)


def test_pna_rejects_unknown_forms():
    with pytest.raises(NotImplementedError, match="median"):
        PNAConv(4, 4, aggregators=("median",))
    with pytest.raises(NotImplementedError, match="inverse"):
        PNAConv(4, 4, scalers=("inverse",))
    with pytest.raises(ValueError, match="num_towers"):
        PNAConv(5, 4, num_towers=2)


def test_mlp_rejects_unported_norms():
    """Every norm of the JAX package's ``get_norm`` is ported; what it
    rejects the port rejects: GraphNorm without a graph, an unknown
    name."""
    for norm in ("gn", "foo"):
        with pytest.raises(NotImplementedError, match=norm):
            MLP(4, 4, 4, 2, norm=norm, with_graph=False)
    for norm in ("cn", "ln"):
        assert len(MLP(4, 4, 4, 2, norm=norm, with_graph=False).norms) == 2


def test_bridge_rejects_missing_zoo_keys():
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.models import zoo as jzoo

    jg, _ = _graphs()
    variables = jax.tree_util.tree_map(np.asarray, jzoo.SAGEConv(5).init(
        jax.random.PRNGKey(0), jg, jnp.zeros((N_PAD, F_IN))))
    del variables["params"]["fc_neigh"]["Dense_0"]["bias"]
    with pytest.raises(KeyError, match="fc_neigh/Dense_0/bias"):
        load_jax_variables(SAGEConv(F_IN, 5), variables)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "dropedge"])
@pytest.mark.parametrize("case", CASES + ["mlp_bn"])
def test_conv_card_matches_cpu(cuda_device, case, masked):
    """Each zoo conv (and a BatchNorm MLP) on the card against the same
    weights on the CPU: the output and every gradient of sum(out * gw).
    The card's segment sums add in the order of its atomics."""
    factories = {
        "gcn": lambda: GraphConv(F_IN, 5),
        "gcn_nobias": lambda: GraphConv(F_IN, 5, use_bias=False),
        "gat": lambda: GATv2Conv(F_IN, 4, 2),
        "gat_dst_res": lambda: GATv2Conv(F_IN, 4, 2, negative_slope=0.1,
                                         share_weights=False, residual=True),
        "gat_res_identity": lambda: GATv2Conv(F_IN, 3, 2, residual=True,
                                              use_bias=False),
        "gin_eps": lambda: GINConv(_double, init_eps=0.3, learn_eps=True),
        "gin_mean": lambda: GINConv(_identity, agg="mean"),
        "gine": lambda: GINEConv(_double, init_eps=0.1),
        "pna": lambda: PNAConv(F_IN, 5),
        "pna_full": lambda: PNAConv(
            F_IN, 4, aggregators=("sum", "mean", "max", "min", "std", "var"),
            scalers=("identity", "amplification", "attenuation"),
            num_towers=2, delta=0.8),
        "sage": lambda: SAGEConv(F_IN, 5),
        "mlp_bn": lambda: MLP(F_IN, 8, 3, 3, 0.0, "bn", torch.relu,
                              include_last=False, with_graph=True),
    }
    torch.manual_seed(0)
    conv = factories[case]()
    rng, x, ef = _inputs(11, case == "gine")
    runs = {}
    for dev in ("cpu", cuda_device):
        graph = batch_graphs(GRAPHS, n_pad=N_PAD, e_pad=E_PAD, g_pad=G_PAD,
                             device=dev)
        mod = copy.deepcopy(conv).to(dev)
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        args = [graph, xt]
        if ef is not None:
            args.append(torch.from_numpy(ef).to(dev))
        kw = {}
        if masked and case != "mlp_bn":
            kw["edge_mask"] = torch.from_numpy(_edge_mask(graph)).to(dev)
        out = mod(*args, **kw)
        gw = torch.from_numpy(np.random.default_rng(1).normal(
            size=tuple(out.shape)).astype(np.float32)).to(dev)
        (out * gw).sum().backward()
        runs[str(dev)] = (out.detach().cpu(), xt.grad.cpu(),
                          {k: p.grad.cpu() for k, p in
                           mod.named_parameters()})
    (o_c, gx_c, gp_c), (o_g, gx_g, gp_g) = runs["cpu"], runs[str(cuda_device)]
    torch.testing.assert_close(o_g, o_c, **FWD_TOL)
    torch.testing.assert_close(gx_g, gx_c, **BWD_TOL)
    for k in gp_c:
        torch.testing.assert_close(gp_g[k], gp_c[k], **BWD_TOL, msg=k)
