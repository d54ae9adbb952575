"""The comparison that decides ``correct`` fails what it must.

- The control, the reference in the program's place computed in TF32
  (the precision below the configurations' fp32 with TF32 off), fails at
  a size a CPU run holds.  On the card the control is read at each cell's
  own size by ``bench/readings.py --control-seeds``.
- A run driven through the harness on the CPU, with the chip's look
  skipped and the timed path broken underneath, reads ``correct`` false
  for each fault the cell can have: a step that returns its state
  unchanged, half of the samples left out (the mean taken over the rest),
  the exchange between nodes left out, and an answer altered where it is
  produced.
"""
import dataclasses

import pytest
import torch

from conftest import tiny_cell
from harness import cell as cell_mod
from harness import traffic
from systems import decsvm_check as check
from systems import decsvm_inputs as inputs
from repro_torch.kernels import ops
from repro_torch.serving import fit

# each cell cut to a tiny size; ``open`` drives table1's configuration
# through the open loop and the server's worker thread
MIX = {"gisette.dense": ("gisette.dense",
                         dict(pool=2, clients=2, max_batch=2)),
       "table1.closed": ("table1.closed",
                         dict(pool=4, clients=2, max_batch=2)),
       "open": ("table1.closed",
                dict(loop="open", pool=4, rate_per_s=8.0, max_batch=4))}


@pytest.mark.parametrize("name", ["gisette.dense", "table1.closed"])
@pytest.mark.parametrize("seed", [1, 2 ** 36 + 9, 123456789])
def test_control_fails(name, seed):
    c = tiny_cell(name, pool=3)
    pool = inputs.make_pool(c.config, c.traffic, seed, "cpu")
    used = range(3)
    exact = check.references(c.config, pool, used)
    low = check.references(c.config, pool, used, tf32=True)
    answers = [check.reference_answer(*low[i], pool.grid, i) for i in used]
    nums = check.numbers(answers, exact, pool.grid, c.config, c.limits, 0)
    assert not check.correct(nums, check.limits_of(c.limits)), nums
    # the reference judged against itself reads nothing
    same = [check.reference_answer(*exact[i], pool.grid, i) for i in used]
    assert check.numbers(same, exact, pool.grid, c.config, c.limits, 0) == \
        dict(est_gap=0.0, hinge_gap=0.0, supp_gap=0.0, grid_gap=0.0,
             failed=0.0)


def _run(name, **config):
    cell, mix = MIX[name]
    c = tiny_cell(cell, **mix)
    c.config = dict(c.config, max_iter=60, **config)
    line, _ = cell_mod.execute(c, 2 ** 34 + 1, 0.4, False, "cpu",
                               traffic.clock())
    return line


def _unchanged_round(X, y, B, P, *a, **k):
    return B.clone(), P.clone(), torch.zeros((), device=B.device)


def _half(original):
    def fn(X, y, *a, **k):
        n = X.shape[1] // 2
        return original(X[:, :n].contiguous(), y[:, :n].contiguous(), *a,
                        **k)
    return fn


def _no_exchange_round(original):
    def fn(X, y, B, P, W, *a, **k):
        return original(X, y, B, P, torch.zeros_like(W), *a, **k)
    return fn


def _altered_estimate(original):
    def fn(self, req, best_lam, B, *a, **k):
        res = original(self, req, best_lam, B, *a, **k)
        return dataclasses.replace(res, B=res.B * 1.01)
    return fn


def _altered_lambda(original):
    def fn(self, req, best_lam, B, table, *a, **k):
        lams = [row[0] for row in table]
        i = lams.index(float(best_lam))
        other = lams[i - 1] if i else lams[1]
        return original(self, req, other, B, table, *a, **k)
    return fn


def test_sound_runs_are_correct():
    for name in sorted(MIX):
        line = _run(name)
        assert line["correct"] is True, (name, line["compared"])


FAULTS = {
    "unchanged": (ops, "csvm_round_block", lambda o: _unchanged_round),
    "half_the_samples": (ops, "csvm_round_block", _half),
    "no_exchange": (ops, "csvm_round_block", _no_exchange_round),
    "altered_estimate": (fit.DecsvmFitServer, "_result", _altered_estimate),
    "altered_lambda": (fit.DecsvmFitServer, "_result", _altered_lambda),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(MIX))
def test_fault_reads_incorrect(monkeypatch, fault, name):
    owner, attr, make = FAULTS[fault]
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    line = _run(name)
    assert line["correct"] is False, line["compared"]
