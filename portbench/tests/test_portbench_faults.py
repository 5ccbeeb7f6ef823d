"""Whole runs on the CPU at a 1024 bucket, past the harness's look for a
card: sound, `correct` is true and the result line has the contract's keys
with the compared numbers last; with the timed path broken underneath in
each way the cell can be, `correct` comes out false."""

import pytest

from portbench import harness
from portbench.tests.helpers import SEED, TINY, bench


def run(cell, seconds=0.2):
    res = harness.run_cell(bench(), cell, SEED, seconds, False, "cpu",
                           harness.process_age_s(), overrides=TINY, log=lambda *a: None)
    res.pop("_run")
    return res


def test_sound_run_is_correct_and_its_line_has_the_keys():
    res = run("3dmatch.match")
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "match_pairs_per_s", "match_ms.p90"}
    assert set(res["compared"]) == {"node_mismatch", "desc_err", "corr_mismatch", "conf_err"}
    assert all(set(v) == {"value", "limit"} for v in res["compared"].values())


def test_answer_altered_where_it_is_produced(monkeypatch):
    import roitr_torch.models.roitr as roitr

    real = roitr.fine_matching

    def altered(*a, **kw):
        out = real(*a, **kw)
        return out._replace(scores=out.scores * 1.01)

    monkeypatch.setattr(roitr, "fine_matching", altered)
    assert run("3dmatch.match")["correct"] is False


@pytest.mark.parametrize("cell", ["3dmatch.train", "4dmatch.train"])
def test_state_left_unchanged(monkeypatch, cell):
    from roitr_torch.parallel.train_step import TrainOptimizer

    def unchanged(self, grads_finite):
        self.inner.zero_grad(set_to_none=True)
        return False

    monkeypatch.setattr(TrainOptimizer, "step", unchanged)
    assert run(cell)["correct"] is False


def test_half_of_an_update_left_out(monkeypatch):
    from roitr_torch.parallel.train_step import TrainOptimizer

    real = TrainOptimizer._grads

    def half(self, finite):
        # the update's first half of pairs counted twice, the second half not at all
        scale = 2.0 if self.mini_step < self.iter_size // 2 else 0.0
        return [g * scale for g in real(self, finite)]

    monkeypatch.setattr(TrainOptimizer, "_grads", half)
    assert run("4dmatch.train")["correct"] is False


def test_data_parallel_sound_and_without_exchange(monkeypatch):
    """Four gloo ranks on the CPU: the sound run is correct; with the
    all-reduce left out on every rank, `correct` is false."""
    from portbench.drivers import train_dp
    from portbench.tests import dp_faults

    tiny = {"config": TINY["config"], "traffic": dict(TINY["traffic"], pool=8)}
    sound = harness.run_cell(bench(), "3dmatch.train_dp4", SEED, 0.2, False, "cpu",
                             harness.process_age_s(), overrides=tiny, log=lambda *a: None)
    assert sound["correct"] is True and sound["device"]["count"] == 4
    monkeypatch.setattr(train_dp, "_rank", dp_faults.rank_without_exchange)
    broken = harness.run_cell(bench(), "3dmatch.train_dp4", SEED, 0.2, False, "cpu",
                              harness.process_age_s(), overrides=tiny, log=lambda *a: None)
    assert broken["correct"] is False


def test_data_parallel_refused_when_a_rank_loads_jax(monkeypatch):
    """The parent holds no JAX; a rank that loaded a module named `jax`
    makes the run end without a result, naming it."""
    import sys

    from portbench.drivers import train_dp
    from portbench.tests import dp_faults

    tiny = {"config": TINY["config"], "traffic": dict(TINY["traffic"], pool=8)}
    monkeypatch.setattr(train_dp, "_rank", dp_faults.rank_loading_jax)
    with pytest.raises(SystemExit, match="jax"):
        harness.run_cell(bench(), "3dmatch.train_dp4", SEED, 0.2, False, "cpu",
                         harness.process_age_s(), overrides=tiny, log=lambda *a: None)
    assert "jax" not in sys.modules
