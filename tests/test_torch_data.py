"""Torch port, data layer: graph, simulate and metrics are NumPy-only copies
of the JAX package's modules and must give bit-equal output for the same
seeds; the port must import neither jax nor the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import graph as jgraph
from repro.core import metrics as jmetrics
from repro.core import simulate as jsim
from repro_torch.core import graph as tgraph
from repro_torch.core import metrics as tmetrics
from repro_torch.core import simulate as tsim
from _torch_cases import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kind,m", [("erdos_renyi", 10), ("ring", 7),
                                    ("star", 6), ("complete", 5),
                                    ("grid", 12), ("torus", 9)])
def test_make_graph_bit_equal(kind, m):
    for seed in (0, 3):
        a = jgraph.make_graph(kind, m, 0.5, seed)
        b = tgraph.make_graph(kind, m, 0.5, seed)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jgraph.degrees(a), tgraph.degrees(b))
        np.testing.assert_array_equal(jgraph.metropolis_weights(a),
                                      tgraph.metropolis_weights(b))


@pytest.mark.parametrize("builder", [
    lambda g: g.ring_of_cliques(4, 3),
    lambda g: g.k_regular(12, 4),
    lambda g: g.watts_strogatz(12, 4, 0.3, seed=2),
    lambda g: g.BlockTopology.from_dense(g.erdos_renyi(9, 0.4, seed=1)),
])
def test_block_topology_bit_equal(builder):
    a, b = builder(jgraph), builder(tgraph)
    np.testing.assert_array_equal(a.to_dense(), b.to_dense())
    np.testing.assert_array_equal(a.degrees(), b.degrees())
    assert a.n_edges == b.n_edges and a.is_connected() == b.is_connected()
    for n_chunks in (2, 3):
        np.testing.assert_array_equal(a.block_mask(n_chunks),
                                      b.block_mask(n_chunks))
        (da, oa, wa), (db, ob, wb) = (a.chunk_operands(n_chunks),
                                      b.chunk_operands(n_chunks))
        np.testing.assert_array_equal(da, db)
        assert oa == ob
        np.testing.assert_array_equal(wa, wb)


@pytest.mark.parametrize("cfg", [
    dict(p=20, s=4, m=4, n=60),
    dict(p=100, s=10, m=10, n=200),
    dict(p=9, s=9, m=3, n=7, mu=0.7, rho=0.2, p_flip=0.1),
])
def test_generate_and_true_beta_bit_equal(cfg):
    ja, ta = jsim.SimConfig(**cfg), tsim.SimConfig(**cfg)
    assert ja.n_total == ta.n_total
    for seed in (0, 5):
        Xj, yj, bj = jsim.generate(ja, seed)
        Xt, yt, bt = tsim.generate(ta, seed)
        for a, b in ((Xj, Xt), (yj, yt), (bj, bt)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jsim.true_beta(ja), tsim.true_beta(ta))


def test_metrics_bit_equal():
    rng = np.random.default_rng(0)
    beta_star = np.zeros(12)
    beta_star[[0, 3, 5]] = [0.5, -1.0, 2.0]
    B = rng.normal(size=(4, 12)) * (rng.random((4, 12)) < 0.4)
    X = rng.normal(size=(30, 12))
    y = rng.choice([-1.0, 1.0], 30)
    margins = np.concatenate([rng.normal(size=10), np.zeros(3)])
    labels = rng.choice([-1.0, 1.0], 13)
    for name, args in [
        ("estimation_error", (B, beta_star)),
        ("f1_score", (B[0], beta_star)),
        ("mean_f1", (B, beta_star)),
        ("consensus_gap", (B,)),
        ("margin_accuracy", (margins, labels)),
        ("accuracy", (B[1], X, y)),
        ("mean_support_size", (B,)),
    ]:
        assert getattr(jmetrics, name)(*args) == getattr(tmetrics, name)(*args), name
    np.testing.assert_array_equal(jmetrics.support(B[2]),
                                  tmetrics.support(B[2]))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port, and chip_smoke.py, leaves jax
    and ``repro`` out of ``sys.modules`` (run in a fresh interpreter)."""
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + [env["PYTHONPATH"]]
        if env.get("PYTHONPATH") else [str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 12
