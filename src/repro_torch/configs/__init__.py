"""Assigned-architecture registry.

Each module defines ``config()`` (the exact assigned hyper-parameters, source
cited) and ``reduced()`` (a <=2-layer, d_model<=512, <=4-expert smoke variant
of the same family).  ``get(name)`` / ``get_reduced(name)`` look them up;
``ARCHS`` lists all ids.

A copy of ``repro.configs`` (data only, no JAX).  The port builds and
runs every family (``repro_torch.models.model.init_params``).
"""
from __future__ import annotations

import importlib

ARCHS = (
    "seamless_m4t_large_v2",
    "qwen3_14b",
    "granite_moe_3b_a800m",
    "qwen3_32b",
    "granite_moe_1b_a400m",
    "mamba2_370m",
    "glm4_9b",
    "command_r_35b",
    "internvl2_1b",
    "recurrentgemma_2b",
)

ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _mod(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; choose from {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str, **overrides):
    cfg = _mod(name).config()
    if overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_reduced(name: str, **overrides):
    cfg = _mod(name).reduced()
    if overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
