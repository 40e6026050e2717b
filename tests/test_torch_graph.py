"""The port's graph runtime against the JAX package's: every GraphBatch
field array-equal, and the host-side edge transforms identical."""

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
