"""The system ``decsvm_fit``: the port's fit server, ``DecsvmFitServer``,
with the configuration's solver settings, the requests it is sent, and the
comparison of its answers with the plain reference.

A configuration names its system by ``"system"``; the harness finds this
file by that name (``spec.system``) and reads from it:

- ``CHIPS``: the chip counts a cell of this system may ask for;
- ``make_inputs(config, mix, seed, device)``: the cell's inputs;
- ``System(config, mix, inputs, device)``: what the loops drive;
- ``counters()``: the program's counters, read before and after the
  window;
- ``answer(result, index)``: what the comparison reads of one answer;
- ``judge(config, limits, inputs, answers, failed)``: the numbers
  compared, their limits, and a line for the report;
- ``control(config, limits, mix, seed, device)``: the control's numbers
  (``bench/readings.py``; the benchmark's runs never call it).

A system that runs across ranks lists their count in ``CHIPS`` and
starts the other ranks in its ``System``: the harness drives rank 0 in
its own process.

This is the one module of the benchmark that imports the program
(``repro_torch``).  It takes from it only the server, the answers
(``FitResult``) and the kernels' launch counters.
"""
from __future__ import annotations

from typing import Dict, List

from harness.traffic import clock
from systems import decsvm_check as check
from systems import decsvm_inputs as inputs

CHIPS = (1,)


def make_inputs(config: dict, traffic: dict, seed: int,
                device) -> inputs.Pool:
    return inputs.make_pool(config, traffic, seed, device)


class System:
    """A ``DecsvmFitServer`` and the requests of one cell."""

    def __init__(self, config: dict, traffic: dict, pool: inputs.Pool,
                 device) -> None:
        from repro_torch.core.admm import ADMMConfig
        from repro_torch.serving.fit import DecsvmFitServer, FitRequest
        self._request = FitRequest
        self.cfg = ADMMConfig(lam=0.0, lam0=config["lam0"], tau=config["tau"],
                              h=inputs.bandwidth(config),
                              kernel=config["kernel"],
                              max_iter=config["max_iter"],
                              rho_safety=config["rho_safety"],
                              backend=config["backend"])
        self.traffic = traffic
        self.pool = pool
        self.server = DecsvmFitServer(max_batch=int(traffic["max_batch"]),
                                      device=device)
        self.grid = [float(v) for v in pool.grid]

    def request(self, rid: int, pool_index: int):
        return self._request(
            rid=rid, X=self.pool.X[pool_index], y=self.pool.y[pool_index],
            W=self.pool.W[pool_index], cfg=self.cfg, lams=self.grid,
            mode=self.traffic["mode"], criterion="bic",
            engine=self.traffic["engine"])

    def submit(self, rid: int, pool_index: int):
        return self.server.submit(self.request(rid, pool_index))

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()


def counters() -> Dict[str, int]:
    """The CSVM kernels' launches so far in this process, by wrapper."""
    from repro_torch.kernels import ops
    return {k: int(ops.launches[k]) for k in
            ("csvm_round_block", "csvm_block_update", "csvm_local_update")}


def answer(result, pool_index: int) -> dict:
    return check.answer_of(result, pool_index)


def judge(config: dict, limits: dict, pool: inputs.Pool, answers: List[dict],
          failed: int):
    """The reference once for each dataset the answers used, after the
    window; returns (numbers, limits, a report line)."""
    t0 = clock()
    refs = check.references(config, pool, [a["pool"] for a in answers])
    spent = clock() - t0
    nums = check.numbers(answers, refs, pool.grid, config, limits, failed)
    return (nums, check.limits_of(limits),
            f"{len(refs)} datasets checked, reference {spent:.3f} s")


def control(config: dict, limits: dict, traffic: dict, seed: int,
            device) -> Dict[str, float]:
    """The control's compared numbers at ``seed``: every dataset of the
    cell's pool, answered by the reference in TF32 and judged against the
    fp32 reference as the program's answers are."""
    pool = inputs.make_pool(config, traffic, seed, device)
    used = range(len(pool.X))
    exact = check.references(config, pool, used)
    low = check.references(config, pool, used, tf32=True)
    answers = [check.reference_answer(*low[i], pool.grid, i) for i in used]
    return check.numbers(answers, exact, pool.grid, config, limits, 0)
