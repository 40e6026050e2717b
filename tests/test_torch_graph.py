"""The port's graph runtime against the JAX package's: every GraphBatch
field array-equal, and the host-side edge transforms, batching, RCM
reordering and the powerlaw sampler identical; the DropEdge mask, whose
draws cannot match JAX's, held to its rate and its padding."""

import sys

import numpy as np
import pytest

import sir_gcn_tpu.graph as jg
import sir_gcn_tpu_torch.graph as tg

FIELDS = ("src", "dst", "edge_perm", "row_ptr", "node_mask", "edge_mask",
          "graph_mask", "node2graph", "in_deg", "out_deg")


def _edges(seed, n=37, e=150):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e), n


@pytest.mark.parametrize("pad", [
    {},
    {"n_pad": 64, "e_pad": 256},
    {"pad_multiple": 128},
    {"node2graph": "split", "num_graphs": 2, "g_pad": 3},
])
def test_build_graph_fields_match_jax(pad):
    src, dst, n = _edges(0)
    kw = dict(pad)
    if kw.get("node2graph") == "split":
        kw["node2graph"] = (np.arange(n) >= n // 2).astype(np.int32)
    ref = jg.build_graph(src, dst, n, **kw)
    got = tg.build_graph(src, dst, n, **kw)
    for f in FIELDS:
        want = np.asarray(getattr(ref, f))
        have = getattr(got, f).numpy()
        assert have.dtype == want.dtype, f
        np.testing.assert_array_equal(have, want, err_msg=f)
        np.testing.assert_array_equal(got.host[f], want, err_msg=f)
    for f in ("num_nodes", "num_edges", "num_graphs"):
        assert getattr(got, f) == int(getattr(ref, f)), f
    assert (got.n_pad, got.e_pad, got.g_pad) == (ref.n_pad, ref.e_pad,
                                                 ref.g_pad)


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_transforms_match_jax(seed):
    src, dst, n = _edges(seed)
    src = np.concatenate([src, [3, 5]])  # make sure self loops exist
    dst = np.concatenate([dst, [3, 5]])
    for name in ("reverse_edges", "to_bidirected", "remove_self_loops"):
        for a, b in zip(getattr(jg, name)(src, dst),
                        getattr(tg, name)(src, dst)):
            np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(jg.add_self_loops(src, dst, n),
                    tg.add_self_loops(src, dst, n)):
        np.testing.assert_array_equal(a, b)


def test_build_graph_places_tensors_on_device():
    src, dst, n = _edges(2)
    g = tg.build_graph(src, dst, n, device="cpu")
    assert all(getattr(g, f).device.type == "cpu" for f in FIELDS)
    with pytest.raises(ValueError):
        tg.build_graph(src, dst, n, n_pad=8)


@pytest.mark.parametrize("source", ["synthetic", "npz"])
def test_node_classification_data_matches_jax(source, tmp_path,
                                              monkeypatch):
    import sir_gcn_tpu.data.loaders as jl
    import sir_gcn_tpu_torch.data.loaders as tl

    kw = dict(num_nodes=300, num_edges=900, feat_dim=12, num_classes=7)
    if source == "npz":
        d = jl.synthetic_node_classification(seed=5, **kw)
        np.savez(tmp_path / "toy_set.npz", src=d.src, dst=d.dst,
                 feat=d.feat, labels=d.labels, train_idx=d.train_idx,
                 val_idx=d.val_idx, test_idx=d.test_idx)
        for mod in (jl, tl):
            monkeypatch.setattr(mod, "DATA_ROOT", str(tmp_path))
    ref = jl.load_node_classification("toy-set", synthetic_fallback=kw,
                                      seed=3)
    got = tl.load_node_classification("toy-set", synthetic_fallback=kw,
                                      seed=3)
    assert got.synthetic == ref.synthetic == (source == "synthetic")
    assert got.num_classes == ref.num_classes
    for f in ("src", "dst", "feat", "labels", "train_idx", "val_idx",
              "test_idx"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(ref, f).dtype, f


def _support(seed, n=60, e=150, isolated=10):
    # the last `isolated` nodes have no edge
    rng = np.random.default_rng(seed)
    return rng.integers(0, n - isolated, e), rng.integers(0, n - isolated, e), n


@pytest.fixture
def no_scipy(monkeypatch):
    """Block scipy's sparse graph module: rcm_order takes _rcm_numpy."""
    monkeypatch.setitem(sys.modules, "scipy.sparse.csgraph", None)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("path", ["scipy", "numpy"])
def test_rcm_order_matches_jax(seed, path, request):
    if path == "numpy":
        request.getfixturevalue("no_scipy")
    src, dst, n = _support(seed)
    want = jg.rcm_order(src, dst, n)
    got = tg.rcm_order(src, dst, n)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert sorted(got.tolist()) == list(range(n))
    if path == "numpy":
        np.testing.assert_array_equal(got, tg._rcm_numpy(src, dst, n))


@pytest.mark.parametrize("seed", [0, 1])
def test_rcm_numpy_permute_and_bandwidth_match_jax(seed):
    src, dst, n = _support(seed)
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    perm = tg._rcm_numpy(src, dst, n)
    np.testing.assert_array_equal(perm, jg._rcm_numpy(src, dst, n))
    for a, b in zip(tg.permute_nodes(src, dst, perm),
                    jg.permute_nodes(src, dst, perm)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    s2, d2, _ = tg.permute_nodes(src, dst, perm)
    assert tg.bandwidth(s2, d2) == jg.bandwidth(s2, d2)
    assert tg.bandwidth(src, dst) == jg.bandwidth(src, dst)
    assert tg.bandwidth(src[:0], dst[:0]) == jg.bandwidth(src[:0],
                                                          dst[:0]) == 0.0


@pytest.mark.parametrize("pad", [{}, {"n_pad": 64, "e_pad": 256, "g_pad": 5},
                                 {"pad_multiple": 128}])
def test_batch_graphs_matches_jax(pad):
    rng = np.random.default_rng(3)
    parts = [(rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n), n)
             for n in (5, 9, 1, 12)]
    ref = jg.batch_graphs(parts, **pad)
    got = tg.batch_graphs(parts, **pad)
    for f in FIELDS:
        want = np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(getattr(got, f).numpy(), want,
                                      err_msg=f)
        assert getattr(got, f).numpy().dtype == want.dtype, f
    for f in ("num_nodes", "num_edges", "num_graphs"):
        assert getattr(got, f) == int(getattr(ref, f)), f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_powerlaw_edges_match_jax(seed):
    from sir_gcn_tpu.data.synthetic import powerlaw_edges as j_powerlaw
    from sir_gcn_tpu_torch.data import powerlaw_edges

    for a, b in zip(powerlaw_edges(np.random.default_rng(seed), 500, 4000),
                    j_powerlaw(np.random.default_rng(seed), 500, 4000)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int64


def test_drop_edge_mask_rate_padding_and_seed():
    import torch

    src, dst, n = _edges(4, n=300, e=3000)
    g = tg.build_graph(src, dst, n, e_pad=4096)
    assert tg.drop_edge_mask(torch.Generator().manual_seed(0), g, 0.0) \
        is g.edge_mask
    rate = 0.3
    masks = [tg.drop_edge_mask(torch.Generator().manual_seed(s), g, rate)
             for s in (0, 0, 1)]
    for m in masks:
        assert m.dtype == torch.bool and m.shape == (g.e_pad,)
        assert not m[g.num_edges:].any()  # padding stays dropped
        # keep share within 5 standard deviations of Binomial(E, 1 - rate)
        sd = (g.num_edges * rate * (1 - rate)) ** 0.5
        assert abs(int(m.sum()) - g.num_edges * (1 - rate)) < 5 * sd
    assert torch.equal(masks[0], masks[1])  # one seed repeats
    assert not torch.equal(masks[0], masks[2])
