"""Localizing numerics sanitizer for Algorithm 1 (``ADMMConfig(sanitize=True)``),
in torch.

Counterpart of ``repro.core.sanitize``.  A NaN that surfaces in the final
``B`` says nothing about *which* term of update (7a')/(7b) produced it or
*when*.  With ``sanitize=True`` the solver step is wrapped with checks in
dataflow order, so the first failing check names the producing term and
the round index:

  E1  margin weights      w = L_h'(y * X b) * y            (per node)
  E2  gradient            X^T w / n_l
  E3  neighbour sum       (W B)_l   (whatever ``neighbor_sum`` supplies)
  E4  primal update       b+ = S_{lam w}(omega z)          — update (7a')
  E5  bf16 range          |b+| <= finfo(bf16).max  (megakernel_bf16 only:
                          next round casts b+ to the bf16 dot operand,
                          where anything above that saturates to inf)
  E6  dual accumulator    p+ = p + tau (deg b+ - (W B+))   — update (7b)
  E7  KKT statistic       ``solver.kkt_residual`` output   (kkt stop rule)

The terms are recomputed from the step's own inputs and the untouched
step runs between them, so ``sanitize=False`` runs exactly the unchecked
program: ``solver.make_step`` returns the step itself, with its
``round_block``.  Under ``sanitize=True`` the step carries no
``round_block``, so every round is one two-pass kernel launch (or the
plain round), with the checks around it.

JAX functionalizes the checks with ``checkify`` under ``jit``; there is
no such transform and nothing to compile here, so ``checked_call`` and
``USER_CHECKS`` have no counterpart: the checks are eager.  Each checked
round reads its six finite flags and its round index back in ONE host
sync after the step (each E7 check in one more) and raises
``SanitizerError`` on the first failing term in E1..E6 order, with JAX's
message for that term and round — the first failure wins, as under
``checkify``.  The cost is the sanitizer's: one sync and two extra reads
of X (the recomputed margins and gradient) a round.

Engines that cannot thread the checks (the lambda-grid drivers of
``repro_torch.core.path``, the sharded engines of ``decentral``, fit
serving) call ``reject_unsupported`` up front, with JAX's message.
"""
from __future__ import annotations

import torch

from repro_torch.core import losses

_SUPPORTED = ("decsvm_fit", "decsvm_fit_tol", "decsvm_fit_uneven")

BF16_MAX = float(torch.finfo(torch.bfloat16).max)

MESSAGES = {
    "E1": "E1: non-finite margin weight L_h'(y*Xb)*y at round {t}",
    "E2": "E2: non-finite gradient X^T w / n at round {t}",
    "E3": "E3: non-finite neighbour sum (W B) at round {t}",
    "E4": "E4: non-finite primal update (7a') at round {t}",
    "E5": ("E5: primal iterate exceeds bf16 range at round {t} "
           "(next round's bf16 MXU operand cast saturates to inf)"),
    "E6": "E6: non-finite dual accumulator (7b) at round {t}",
    "E7": "E7: non-finite KKT stop statistic at round {t}",
}


class SanitizerError(RuntimeError):
    """A failed E1-E7 check; ``code`` names the term, ``round`` the round."""

    def __init__(self, code: str, t: int):
        super().__init__(MESSAGES[code].format(t=t))
        self.code, self.round = code, t


def wants_sanitize(cfg) -> bool:
    """True iff this config asks for the sanitizer.  ``getattr`` so configs
    predating the field (duck-typed ADMMConfigs) keep working unchanged."""
    return bool(getattr(cfg, "sanitize", False))


def reject_unsupported(cfg, where: str) -> None:
    """Fail fast on engines that cannot functionalize the checks."""
    if wants_sanitize(cfg):
        raise NotImplementedError(
            f"{where}: cfg.sanitize=True is only supported by the dense "
            f"single-process drivers {_SUPPORTED}; sharded/mesh and "
            "lambda-grid engines cannot thread checkify through their "
            "collectives/vmaps. Re-fit the offending problem with a dense "
            "driver to localize the failure.")


def _finite(x) -> torch.Tensor:
    return torch.all(torch.isfinite(x))


def _raise_first(codes, flags) -> None:
    """``flags``: the device booleans of ``codes`` in order, then the round
    index — read back in one sync."""
    *ok, t = torch.stack([f.to(torch.int64) for f in flags]).tolist()
    for code, good in zip(codes, ok):
        if not good:
            raise SanitizerError(code, int(t))


def checked_step(step, cfg, neighbor_sum):
    """Wrap one solver step with the E1-E6 term checks.

    The wrapper recomputes the (7a') intermediate terms from the inputs
    the step reads, runs the untouched step, checks its outputs, and
    raises on the first failing term (one host sync a round).
    """
    kern = losses.get_kernel(cfg.kernel)

    def wrapped(prob, state, lam, lam_weights=None):
        X32 = prob.X.to(torch.float32)
        marg = torch.bmm(X32, state.B[..., None])[..., 0]
        wts = kern.dloss(prob.y * marg, cfg.h) * prob.y
        e1 = _finite(wts)
        if prob.mask is None:
            n_eff = float(prob.X.shape[1])
        else:
            wts = wts * prob.mask
            n_eff = torch.clamp(torch.sum(prob.mask, dim=1, keepdim=True),
                                min=1.0)
        grad = torch.bmm(X32.transpose(1, 2), wts[..., None])[..., 0] / n_eff
        flags = [e1, _finite(grad), _finite(neighbor_sum(state.B))]
        codes = ["E1", "E2", "E3", "E4"]

        new = step(prob, state, lam, lam_weights)
        flags.append(_finite(new.B))
        if prob.X.dtype == torch.bfloat16:
            flags.append(torch.max(torch.abs(new.B)) <= BF16_MAX)
            codes.append("E5")
        flags += [_finite(new.P), torch.as_tensor(state.t,
                                                  device=new.B.device)]
        codes.append("E6")
        _raise_first(codes, flags)
        return new

    return wrapped


def checked_residual(fn, cfg):
    """Wrap a ``run_tol`` residual_fn with the E7 statistic check,
    preserving its ``kind`` tag."""

    def wrapped(prob, state, lam, lam_weights):
        stat = fn(prob, state, lam, lam_weights)
        _raise_first(["E7"], [_finite(stat), torch.as_tensor(
            state.t, device=stat.device)])
        return stat

    kind = getattr(fn, "kind", None)
    if kind is not None:
        wrapped.kind = kind
    return wrapped
