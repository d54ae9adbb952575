"""Torch port, the rank cases of ``chip_smoke.py``'s phase 4d on the CPU:
every case of ``repro_torch.launch.ranks`` on four gloo ranks, with the
full-size problem shrunk to X (16, 64, 64) (``setup(small=True)``) and
the design-size warm paths and ghost rows as on the card, held by
``check_cases`` to the same calls at one rank and to the plain references
— among them ``lam_shard_warm``, the one-rank traversal of the warm
path's lam shards with and without the hand-off.  Each gate is then shown
to fail on a result moved past its tolerance.
"""
import copy

import pytest

from repro_torch.launch import ranks
from _torch_cases import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    """(setup, the four ranks' records, the one-rank runs, the plain
    references); the references run on one torch thread (``one_thread``),
    as the ranks do."""
    s = ranks.setup(4, "cpu", small=True)
    got = ranks.spawn(ranks.rank_cases, 4, (s,), device="cpu",
                      deadline_s=300.0)
    return (s, got, ranks.reference_cases(s),
            ranks.reference_cases(s, plain=True))


def _check(s, got, one, plain):
    return ranks.check_cases(s, got, one, plain, log=lambda *a: None)


def test_rank_cases_pass_their_gates(runs):
    s, got, one, plain = runs
    rec = _check(*runs)
    cases = rec["cases"]
    assert set(cases) == set(one["cases"])
    assert cases["fit gather pallas"]["launches"]["csvm_local_update"] == \
        ranks.MAX_ITER
    assert cases["fit chunked tol"]["launches"]["csvm_block_update"] < \
        ranks.MAX_ITER
    assert max(c["max_abs_dev_plain"] for c in cases.values()) <= ranks.TOL
    gap = rec["warm_gap"]
    assert gap["design warm handoff"] < gap["design warm no handoff"]
    # four ranks on the design size: m = 10 pads to 12 over 4 chunks
    assert got[0]["cases"]["design block ghost rows"]["result"].shape[0] \
        == 12


def _bump(t, by=1e-3):
    t = t.clone()
    t.view(-1)[0] += by
    return t


def _plain_fit(c):
    c["result"] = _bump(c["result"])


def _plain_stops(c):
    it = c["result"]["iters"].clone()
    it[-1] -= ranks.CHECK_EVERY
    c["result"]["iters"] = it


def _plain_warm_path(c):
    c["result"]["path"] = _bump(c["result"]["path"])


def _one_stop(c):
    B, t = c["result"]
    c["result"] = (B, t - ranks.CHECK_EVERY)


def _plain_best_lam(c):
    c["result"]["best_lam"] = c["result"]["best_lam"] * 0.5


def _rank_ghost_rows(c):
    B = c["result"].clone()
    B[-1, 0] = 1e-3
    c["result"] = B


@pytest.mark.parametrize("case, where, change, match", [
    ("fit gather megakernel", "plain", _plain_fit, "vs plain"),
    ("fit chunked tol", "one", _one_stop, "stopped at round"),
    ("path mesh batched bic", "plain", _plain_best_lam, "best lambda"),
    ("design warm handoff", "plain", _plain_stops, "stops"),
    ("design warm no handoff", "plain", _plain_warm_path, "vs plain"),
    ("design block ghost rows", "ranks", _rank_ghost_rows, "ghost rows"),
])
def test_a_result_past_its_tolerance_fails_its_gate(runs, case, where,
                                                     change, match):
    s, got, one, plain = copy.deepcopy(runs)
    targets = {"one": [one], "plain": [plain], "ranks": got}[where]
    for rec in targets:
        change(rec["cases"][case])
    with pytest.raises(ranks.RankFailure, match=match):
        _check(s, got, one, plain)
