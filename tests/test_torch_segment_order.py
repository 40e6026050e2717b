"""The fixed-order segment sum of ``sir_gcn_tpu_torch/ops/segment.py``.

On the CPU ``segment_sum`` keeps ``index_add`` in row order: its values
and gradients are today's bits. The card's plan (``Segments``: pieces of
at most ``PIECE`` rows summed by ``torch.segment_reduce``, level by
level) runs here on CPU tensors: on integer-valued data every order sums
exactly, so it must give ``index_add``'s bits; on random data it agrees
at the forward tolerance; its gradient is the cotangent's gather, bit
for bit. ``PIECE`` is cut to 4 so that a padding-like run of a few
hundred rows takes several levels, and the ids come sorted and shuffled.

The gathers' backward (``gather_rows`` on a card) is the same plan's sum
of the cotangent, held the same way.

The ``cuda`` tests ask two calls on the card for the same bits: the sum
in f32, bf16 and f16 over a padding-heavy batch, and the CSR aggregate
(sum, mean, sym) with its gradients.
"""

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.ops.message_passing as tmp
from sir_gcn_tpu_torch import batch_graphs, build_graph
from sir_gcn_tpu_torch.ops import segment as tseg

FWD_TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ids(rng, n, rows, pad_run, sort):
    ids = np.sort(rng.integers(0, max(n - 1, 1), rows - pad_run))
    ids = np.concatenate([ids, np.full(pad_run, n - 1)]).astype(np.int32)
    if not sort:
        rng.shuffle(ids)
    return torch.from_numpy(ids)


def _ids_tail(rng, n, rows, pad_run, sort):
    """``_ids`` with only the real rows shuffled: the padding run stays
    last, as a graph's padding edges do (and a stable sort keeps them)."""
    ids = _ids(rng, n, rows, pad_run, True)
    if not sort:
        head = rows - pad_run
        ids[:head] = ids[:head][torch.from_numpy(rng.permutation(head))]
    return ids


@pytest.mark.parametrize("told", [False, True], ids=["plain", "tail_run"])
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "shuffled"])
@pytest.mark.parametrize("shape", [(), (3,), (2, 4)])
def test_plan_sums_like_index_add(monkeypatch, shape, sort, told):
    """``told``: the plan knows the padding run (``tail``) and the longest
    other run (``max_run``), as a graph tells it."""
    monkeypatch.setattr(tseg, "PIECE", 4)
    rng = np.random.default_rng(len(shape) + sort)
    for n, rows, pad_run in ((1, 9, 0), (7, 0, 0), (12, 40, 3),
                             (30, 500, 300), (50, 257, 1)):
        ids = (_ids_tail if told else _ids)(rng, n, rows, pad_run, sort)
        kw = {}
        if told:
            head = ids[:rows - pad_run].long()
            kw = dict(tail=pad_run, max_run=int(torch.bincount(
                head, minlength=n).max()) if len(head) else 0)
        segs = tseg.Segments(ids, n, sorted_ids=sort, **kw)
        whole = torch.from_numpy(
            rng.integers(-64, 64, (rows,) + shape).astype(np.float32))
        want = torch.zeros((n,) + shape).index_add(0, ids, whole)
        assert torch.equal(segs.sum(whole), want)

        data = torch.from_numpy(rng.normal(size=(rows,) + shape).astype(
            np.float32)).requires_grad_()
        got = segs.sum(data)
        want = torch.zeros((n,) + shape).index_add(0, ids, data.detach())
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                                   **FWD_TOL)
        cot = torch.from_numpy(rng.normal(size=(n,) + shape).astype(
            np.float32))
        (got * cot).sum().backward()
        assert torch.equal(data.grad, cot[ids.long()])


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "shuffled"])
def test_fixed_order_gather(monkeypatch, sort):
    """The card's gather (``_Gather``, run here on CPU tensors): the rows
    of ``x[ids]`` forward, and a backward that sums the cotangent by the
    plan: ``index_add``'s bits on an integer-valued cotangent, its values
    at the forward tolerance on a random one."""
    monkeypatch.setattr(tseg, "PIECE", 4)
    rng = np.random.default_rng(3)
    ids = _ids(rng, 20, 300, 120, sort)
    x = torch.from_numpy(rng.normal(size=(20, 3)).astype(np.float32))
    for cot in (rng.integers(-64, 64, (300, 3)), rng.normal(size=(300, 3))):
        cot = torch.from_numpy(cot.astype(np.float32))
        xg = x.clone().requires_grad_()
        y = tseg._Gather.apply(xg, tseg.Segments(ids, 20, sort))
        assert torch.equal(y, x[ids.long()])
        (y * cot).sum().backward()
        want = torch.zeros(20, 3).index_add(0, ids, cot)
        np.testing.assert_allclose(xg.grad.numpy(), want.numpy(), **FWD_TOL)
    assert torch.equal(tseg.gather_rows(x, ids), x[ids.long()])


def test_cpu_segment_sum_keeps_index_add():
    """On the CPU the reducers add with ``index_add`` in row order, given
    ids or ``Segments`` alike, float or integer."""
    rng = np.random.default_rng(0)
    ids = _ids(rng, 20, 300, 100, True)
    segs = tseg.Segments(ids, 20, sorted_ids=True)
    data = torch.from_numpy(rng.normal(size=(300, 5)).astype(np.float32))
    want = torch.zeros(20, 5).index_add(0, ids, data)
    assert torch.equal(tseg.segment_sum(data, ids, 20), want)
    assert torch.equal(tseg.segment_sum(data, segs, 20), want)
    counts = torch.ones(300, dtype=torch.int64)
    assert torch.equal(tseg.segment_sum(counts, segs, 20),
                       torch.bincount(ids.long(), minlength=20))
    assert segs._plan is None  # the CPU never builds the card's plan


def test_graphs_keep_their_segments():
    """A graph builds its dst and node2graph ``Segments`` once; a copy on
    another device (here: a rebuilt graph) gets its own."""
    g = batch_graphs([(np.array([0, 1]), np.array([1, 0]), 2),
                      (np.array([0, 0]), np.array([2, 1]), 3)],
                     pad_multiple=8)
    assert (g.n_pad, g.e_pad, g.g_pad) == (8, 8, 3)
    assert g.dst_segments is g.dst_segments
    assert g.dst_segments.ids is g.dst and g.dst_segments.sorted_ids
    assert g.graph_segments.ids is g.node2graph
    assert g.graph_segments.num_segments == g.g_pad
    # the padding edges and nodes are the tails; the longest real runs
    assert (g.dst_segments.tail, g.src_segments.tail) == (4, 4)
    assert (g.dst_segments.max_run, g.src_segments.max_run) == (1, 2)
    assert (g.graph_segments.tail, g.graph_segments.max_run) == (3, 3)
    assert np.all(np.diff(g.host["node2graph"]) >= 0)
    g2 = build_graph(np.array([0]), np.array([1]), 2)
    assert g2.dst_segments is not g.dst_segments


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
def test_segment_sum_repeats_its_bits_on_card(cuda_device, dt):
    """A batch's padding run (half the rows on the last node), sorted and
    shuffled ids: two sums give the same bits (in f32 within 1e-3 of an f64
    sum), and the gradient is the cotangent's gather."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
             "f16": torch.float16}[dt]
    rng = np.random.default_rng(0)
    for sort in (True, False):
        ids = _ids(rng, 2000, 60_000, 30_000, sort).to(cuda_device)
        data = torch.from_numpy(rng.normal(size=(60_000, 20))).to(
            cuda_device, dtype).requires_grad_()
        a = tseg.segment_sum(data, ids, 2000)
        b = tseg.segment_sum(data, tseg.Segments(ids, 2000, sort), 2000)
        assert torch.equal(a, b)
        if dtype == torch.float32:
            want = torch.zeros(2000, 20, dtype=torch.float64,
                               device=cuda_device).index_add(
                                   0, ids, data.double())
            assert float((a.double() - want).abs().max()) < 1e-3
        cot = torch.randn_like(a)
        (a * cot).sum().backward()
        assert torch.equal(data.grad, cot[ids.long()])


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ["sum", "mean", "sym"])
def test_csr_aggregate_repeats_its_bits_on_card(cuda_device, agg):
    rng = np.random.default_rng(1)
    graphs = [(rng.integers(0, 30, 120), rng.integers(0, 30, 120), 30)
              for _ in range(64)]
    g = batch_graphs(graphs, e_pad=16_384, device=cuda_device)
    runs = []
    for _ in range(2):
        torch.manual_seed(0)
        eq = torch.randn(g.n_pad, 16, device=cuda_device,
                         requires_grad=True)
        ek = torch.randn(g.n_pad, 16, device=cuda_device,
                         requires_grad=True)
        out = tmp.sir_aggregate(g, eq, ek, torch.tanh, agg)
        out.square().sum().backward()
        runs.append((out.detach(), eq.grad, ek.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
