"""The sanitizer's config gate, in torch: ``wants_sanitize`` and
``reject_unsupported`` of ``repro.core.sanitize``, with the same message.

Engines that cannot thread the term checks (the lambda-grid drivers of
``repro_torch.core.path``, and later the sharded engines) call
``reject_unsupported`` up front instead of running a check-free program.
The E1-E7 term checks themselves (``checked_step``, ``checked_residual``,
``checked_call``) are a later slice of the port; until then the dense
drivers raise on ``sanitize=True`` too (``solver._reject_sanitize``).
"""
from __future__ import annotations

_SUPPORTED = ("decsvm_fit", "decsvm_fit_tol", "decsvm_fit_uneven")


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
