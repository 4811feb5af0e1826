"""The port's training checkpoints (``runtime.checkpoint``, on
``torch.distributed.checkpoint``): the mirror of ``tests/test_checkpoint.py``
on one gloo world of 4 CPU processes (rank cases in
``tests/torch_train_ranks.py``).

* Saved at dp 2 x tp 2 after two Adam steps and restored at dp 2 x tp 2
  into targets holding other weights: the step count, the leaves and
  Adam's ``exp_avg``/``exp_avg_sq``/``step`` come back bit for bit, and the
  next two steps' losses equal the uninterrupted run's at atol 0 (the
  second one depends on the restored optimiser state).
* Restored at tp 2 (two ranks) and at one rank: the same whole leaves and
  Adam state, equal to the saved ones bit for bit (every tp shard of every
  rank was written, none lost to a plain tensor's one-copy rule); the
  next loss at one rank equals ``lm_loss`` of the saved leaves on one
  device exactly, and both continuing losses are within 1e-6 of the
  uninterrupted run's.
* A save over an existing checkpoint replaces it: a restore returns the
  newer step. A save stopped between its two renames leaves the older
  checkpoint readable, and the next save completes.
"""

import os

import numpy as np
import pytest
import torch

from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.parallel.group import LocalWorld
from dllama_tpu_torch.runtime import checkpoint, train
from tests import torch_train_ranks as R
from tests.torch_train_ranks import assemble
from tests.torch_ports import store_address

CFG = ModelConfig(arch="llama", dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=4,
                  vocab_size=64, seq_len=32, head_size=16, kv_dim=64, dtype="float32")


def _host(seed: int) -> dict:
    p = llama.random_params(CFG, seed=seed, device="cpu")
    host = {k: v.numpy() for k, v in p.items() if k != "layers"}
    host["layers"] = {k: v.numpy() for k, v in p["layers"].items()}
    return host


def _batches() -> list:
    return [np.random.default_rng(s).integers(0, CFG.vocab_size, (2, 16)).astype(np.int32)
            for s in range(4)]


#: two steps before the save, two after it
BEFORE, AFTER = _batches()[:2], _batches()[2:]
MOMENTS = ("exp_avg", "exp_avg_sq")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A world, and the checkpoint its dp 2 x tp 2 run saved after two steps
    (with the leaves and Adam state it saved and its next two losses)."""
    path = str(tmp_path_factory.mktemp("ckpt") / "ckpt")
    with LocalWorld(4, threads=1, timeout_s=180, init_method=store_address()) as w:
        torch_n = torch.get_num_threads()
        torch.set_num_threads(1)
        ranks = w.run(R.checkpoint_save_case, {"dp": 2, "tp": 2}, _host(0), CFG, BEFORE, AFTER,
                      path)
        yield w, path, ranks
        torch.set_num_threads(torch_n)


def _assert_state_is_the_saved(got: list, ranks: list) -> None:
    """The restored leaves and Adam state, assembled, equal the saved ones
    bit for bit."""
    for got_key, want_key in (("params", "saved"),) + tuple(zip(MOMENTS, MOMENTS)):
        have, want = assemble(CFG, got, got_key), assemble(CFG, ranks, want_key)
        assert set(have) == set(want)
        for k in want:
            np.testing.assert_array_equal(have[k], want[k], err_msg=f"{got_key} {k}")
    for g in got:
        assert g["adam_step"] == ranks[0]["adam_step"]
        assert set(g["adam_step"].values()) == {2.0}


def test_restore_on_the_saving_grid_resumes_bit_for_bit(saved):
    world, path, ranks = saved
    got = world.run(R.checkpoint_restore_case, {"dp": 2, "tp": 2}, _host(9), CFG, AFTER, path)
    for g, r in zip(got, ranks):
        assert g["step"] == 2
        np.testing.assert_allclose(g["next_losses"], r["next_losses"], rtol=0, atol=0)
    _assert_state_is_the_saved(got, ranks)


def test_restore_on_other_grids_gives_the_saved_leaves(saved):
    world, path, ranks = saved
    at_tp2 = world.run(R.checkpoint_restore_case, {"tp": 2}, _host(9), CFG, AFTER, path, size=2)
    at_one = world.run(R.checkpoint_restore_case, {"tp": 1}, _host(9), CFG, AFTER, path, size=1)
    for got in (at_tp2, at_one):
        assert all(g["step"] == 2 for g in got)
        _assert_state_is_the_saved(got, ranks)
    want = assemble(CFG, ranks, "saved")
    loss = R.loss_case(None, {}, R.nest(want), CFG, AFTER[0])["loss"]
    assert at_one[0]["next_losses"][0] == loss
    assert abs(ranks[0]["next_losses"][0] - loss) < 1e-6
    for got in (at_tp2, at_one):
        for g in got:
            np.testing.assert_allclose(g["next_losses"], ranks[0]["next_losses"], rtol=0,
                                       atol=1e-6)


def test_checkpoint_overwrite(tmp_path):
    params = {"w": torch.ones(4), "layers": {}}
    opt_state = {"w": {"m": torch.zeros(4)}}
    p = checkpoint.save(str(tmp_path / "c"), params, opt_state, step=1)
    checkpoint.save(str(tmp_path / "c"), params, opt_state, step=2)
    _, _, s = checkpoint.restore(p, params, opt_state)
    assert s == 2
    assert sorted(x.name for x in tmp_path.iterdir()) == ["c"]


def test_a_save_stopped_between_its_renames_keeps_the_older_checkpoint(tmp_path, monkeypatch):
    params = {"w": torch.ones(4), "layers": {}}
    opt_state = {"w": {"m": torch.zeros(4)}}
    p = checkpoint.save(str(tmp_path / "c"), params, opt_state, step=1)
    rename = os.replace

    def stop_at_the_second(src, dst):
        if dst == p and src.endswith(".partial"):
            raise OSError("stopped between the renames")
        rename(src, dst)

    monkeypatch.setattr(checkpoint.os, "replace", stop_at_the_second)
    with pytest.raises(OSError, match="stopped"):
        checkpoint.save(p, {"w": torch.full((4,), 2.0), "layers": {}}, opt_state, step=2)
    monkeypatch.undo()
    assert not os.path.exists(p)
    got, _, s = checkpoint.restore(p, params, opt_state)
    assert s == 1 and torch.equal(got["w"], torch.ones(4))
    checkpoint.save(p, {"w": torch.full((4,), 3.0), "layers": {}}, opt_state, step=3)
    got, _, s = checkpoint.restore(p, params, opt_state)
    assert s == 3 and torch.equal(got["w"], torch.full((4,), 3.0))
    assert sorted(x.name for x in tmp_path.iterdir()) == ["c"]
