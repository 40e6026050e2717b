"""The native ELL planner (``sir_gcn_tpu_torch/csrc/ellplan.cpp``, loaded
by ``sir_gcn_tpu_torch/native.py``) against the NumPy planner: the same
slot arrays, buckets and plans, and against the JAX package's reference
bucketizer; the build lands under ``build/`` and the library loads. Also
the port's profiling helpers. Host only."""

import warnings

import numpy as np
import pytest
import torch

from sir_gcn_tpu_torch import native
from sir_gcn_tpu_torch.ops import ell as tell
from sir_gcn_tpu_torch.utils.profiling import StepTimer, profile_trace


def _keys(case: str, rng):
    """(keys, valid, num_keys, max_budget) of a planner case."""
    if case == "hubs":  # a key far above max_budget: chunks and stage 2
        keys = np.where(rng.random(3000) < 0.4, 5, rng.integers(0, 200, 3000))
        return keys, rng.random(3000) < 0.9, 200, 16
    if case == "uniform":
        return rng.integers(0, 500, 4000), np.ones(4000, bool), 500, 256
    if case == "one_key":
        return np.full(700, 3), np.ones(700, bool), 8, 64
    return np.zeros(0, np.int64), np.zeros(0, bool), 16, 256  # empty


CASES = ["hubs", "uniform", "one_key", "empty"]


def test_native_library_builds_and_loads():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.parent == native.BUILD_DIR
    assert "build" in path.parts


@pytest.mark.parametrize("case", CASES)
def test_native_bucketize_equals_numpy(case):
    rng = np.random.default_rng(CASES.index(case))
    keys, valid, nk, mb = _keys(case, rng)
    eids = np.nonzero(valid)[0]
    a = tell._bucketize(keys[eids], eids, nk, mb, native=True)
    b = tell._bucketize(keys[eids], eids, nk, mb, native=False)
    for x, y in zip(a[:3] + a[4:], b[:3] + b[4:]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a[3] == b[3]


@pytest.mark.parametrize("case", CASES)
def test_native_bucketize_equals_jax_reference(case):
    """Against ``_bucketize_numpy``, the JAX package's loop form."""
    from sir_gcn_tpu.ops.ell import _bucketize_numpy

    rng = np.random.default_rng(10 + CASES.index(case))
    keys, valid, nk, mb = _keys(case, rng)
    eids = np.nonzero(valid)[0]
    got = tell._bucketize(keys[eids], eids, nk, mb, native=True)
    want = _bucketize_numpy(keys[eids].astype(np.int64), eids, nk, mb)
    for x, y in zip(got[:3] + got[4:], want[:3] + want[4:]):
        np.testing.assert_array_equal(x, y)
    assert got[3] == want[3]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("force_stage2", [False, True])
def test_native_plans_equal_numpy_plans(case, force_stage2):
    rng = np.random.default_rng(20 + CASES.index(case))
    keys, valid, nk, mb = _keys(case, rng)
    a = tell.build_reduce_plan(keys, valid, nk, mb, native=True,
                               force_stage2=force_stage2)
    b = tell.build_reduce_plan(keys, valid, nk, mb, native=False,
                               force_stage2=force_stage2)
    assert a.host.keys() == b.host.keys()
    for k in a.host:
        np.testing.assert_array_equal(a.host[k], b.host[k], err_msg=k)
    assert (a.buckets1, a.buckets2) == (b.buckets1, b.buckets2)
    if force_stage2:
        assert a.s2_gather is not None


@pytest.mark.parametrize("force_stage2", [False, True])
def test_force_stage2_plan_equals_jax(force_stage2):
    from sir_gcn_tpu.ops.ell import build_reduce_plan as j_plan

    rng = np.random.default_rng(3)
    keys, valid, nk, mb = _keys("uniform", rng)
    got = tell.build_reduce_plan(keys, valid, nk, mb,
                                 force_stage2=force_stage2)
    want = j_plan(keys, valid, nk, mb, force_stage2=force_stage2)
    for k in ("slot_edge", "slot_valid", "slot_key", "row_key", "key2row",
              "s2_gather", "s2_valid"):
        w = getattr(want, k)
        if w is None:
            assert got.host.get(k) is None
        else:
            np.testing.assert_array_equal(got.host[k], np.asarray(w))
    assert got.buckets1 == tuple(want.buckets1)
    assert got.buckets2 == want.buckets2


def test_fill_slots_checks_its_inputs():
    gids = np.arange(4, dtype=np.int64)
    one = np.zeros(1, np.int64)
    with pytest.raises(ValueError, match="overrun"):
        native.ell_fill_slots(gids, one, np.array([5]), one, np.array([4]),
                              one, one, 4)
    with pytest.raises(TypeError, match="int64"):
        native.ell_chunks(gids.astype(np.int32), 4)


def test_step_timer_drops_warmup():
    timer = StepTimer(warmup=2, device=torch.device("cpu"))
    for _ in range(5):
        with timer:
            torch.ones(8).sum()
    assert len(timer.times) == 3 and timer.mean_ms >= 0.0


def test_profile_trace_writes_a_trace(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile_trace(str(tmp_path / "prof")) as prof:
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
