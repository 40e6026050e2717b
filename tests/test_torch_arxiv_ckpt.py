"""Checkpoint / resume on the port's arxiv trainer, in the shape of
``tests/test_checkpoint_resume.py``: a run cut at a checkpoint and resumed
must equal an uninterrupted one bit for bit (the model and AdamW, the
plateau scheduler, the best selection, the dropout generator's state and
the mask-rate host RNG's draws), with dropout, DropEdge, the label trick,
mask-rate and FLAG on, so that each stream is exercised; resuming past
the end returns the checkpointed best. Also the checkpoint module's own
contract: one file per step, the latest found, the write atomic.
"""

import os

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.experiments.ogbn_arxiv.train as ttrain
from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
from sir_gcn_tpu_torch.utils import checkpoint

COMMON = ["--cpu", "--nhidden", "12", "--nlayers", "2", "--agg-type", "sym",
          "--norm", "bn", "--residual", "--dropout", "0.2",
          "--feat-dropout", "0.1", "--edge-dropout", "0.1",
          "--use-labels", "--label-iters", "1", "--mask-rate", "0.5",
          "--flag", "--m", "1", "--epochs", "4", "--nruns", "1",
          "--log-every", "100", "--synthetic-nodes", "400",
          "--synthetic-edges", "2000"]


@pytest.fixture(autouse=True)
def f32_edges():
    set_edge_dtype(None)
    yield
    set_edge_dtype(None)


def _epochs(flags, n):
    flags = list(flags)
    flags[flags.index("--epochs") + 1] = str(n)
    return flags


def test_arxiv_checkpoint_resume_bitwise(tmp_path):
    (a,) = ttrain.main(COMMON)
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    ttrain.main(_epochs(COMMON, 2) + ck)  # stops after epoch 2's save
    (b,) = ttrain.main(COMMON + ck + ["--resume"])
    assert b["train_losses"] == a["train_losses"][2:]
    for k in ttrain.METRIC_KEYS:
        assert b[k] == a[k], k
    assert np.array_equal(b["logits"], a["logits"])


def test_arxiv_resume_past_end_returns_best(tmp_path):
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    (a,) = ttrain.main(COMMON + ck)
    (b,) = ttrain.main(COMMON + ck + ["--resume"])
    assert b["train_losses"] == []  # the loop is skipped
    for k in ttrain.METRIC_KEYS:
        assert b[k] == a[k], k
    assert np.array_equal(b["logits"], a["logits"])


def test_checkpoint_files(tmp_path, monkeypatch):
    path = str(tmp_path / "run")
    assert checkpoint.latest_step(path) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.load_checkpoint(path)
    for step in (2, 10, 4):
        checkpoint.save_checkpoint(path, {"w": torch.full((3,), step),
                                          "step": step}, step=step)
    assert sorted(os.listdir(path)) == ["step_10.pt", "step_2.pt",
                                        "step_4.pt"]
    assert checkpoint.latest_step(path) == 10
    assert checkpoint.load_checkpoint(path)["step"] == 10
    assert torch.equal(checkpoint.load_checkpoint(path, 4)["w"],
                       torch.full((3,), 4))

    # a save cut while writing leaves the earlier files as they were and
    # no temporary file behind
    def cut(obj, f):
        f.write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(checkpoint.torch, "save", cut)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_checkpoint(path, {"step": 12}, step=12)
    assert sorted(os.listdir(path)) == ["step_10.pt", "step_2.pt",
                                        "step_4.pt"]
    assert checkpoint.latest_step(path) == 10
