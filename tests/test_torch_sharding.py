"""Torch port, the placement rules and the LM meshes on the CPU.

``launch.sharding.param_pspecs``, ``batch_pspecs`` and ``cache_pspecs``
against JAX's, leaf for leaf, on ``jax.sharding.AbstractMesh`` shapes (no
JAX multi-device run) and the port's ``mesh.AbstractMesh`` of the same
sizes: every registry config at full size (JAX's trees from
``jax.eval_shape``, the port's from ``model.abstract_params`` on the meta
device) and reduced, on meshes (1, 1), (2, 1), (1, 2), (2, 2), (4, 1),
(1, 4), (16, 16) and (2, 16, 16), ``fsdp`` on and off, and
``expert_parallel`` on both granite-moe configs.  A port leaf's spec is
JAX's for its stacked leaf with the leading L entry dropped (none for a
tail layer); trailing Nones carry no meaning and are dropped on both
sides.  Then the LM meshes over a group, ``shardctx.constrain`` and
``to_named``."""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
from repro.launch import sharding as jshd
from repro.models import model as jmodel
import repro_torch.configs as tconfigs
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as shd
from repro_torch.models import convert, model, shardctx
from _torch_cases import one_thread  # noqa: F401

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4), (16, 16),
          (2, 16, 16)]
SIZES = ("full", "reduced")
MOE = ("granite_moe_3b_a800m", "granite_moe_1b_a400m")


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _meshes(shape):
    return (AbstractMesh(shape, _names(shape)),
            M.abstract_mesh(shape, _names(shape)))


def _cfg(pkg, arch, size):
    return pkg.get(arch) if size == "full" else pkg.get_reduced(arch)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, size):
    return jax.eval_shape(functools.partial(jmodel.init_params,
                                            _cfg(jconfigs, arch, size)),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch, size):
    return model.abstract_params(_cfg(tconfigs, arch, size))


def _norm(spec):
    """A spec as a tuple: a lone axis in a tuple as its name, trailing
    Nones dropped."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in tuple(spec)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _by_path(tree, is_leaf=None):
    """{JAX's path string (as its sharding rules spell it): leaf}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


CASES = [(arch, size, shape, fsdp, ep)
         for arch in tconfigs.ARCHS for size in SIZES for shape in MESHES
         for fsdp in (True, False)
         for ep in ((False, True) if arch in MOE else (False,))]


@pytest.mark.parametrize("arch,size,shape,fsdp,ep", CASES)
def test_param_pspecs_match_jax(arch, size, shape, fsdp, ep):
    jmesh, tmesh = _meshes(shape)
    tcfg = _cfg(tconfigs, arch, size)
    want = _by_path(jshd.param_pspecs(_jax_params(arch, size), jmesh,
                                      fsdp=fsdp, expert_parallel=ep),
                    is_leaf=_is_spec)
    shapes = _by_path(_jax_params(arch, size))
    got = shd.param_pspecs(_port_params(arch, size), tmesh, fsdp=fsdp,
                           expert_parallel=ep)
    seen = set()
    for name, spec in got.items():
        path, depth = convert.jax_path(name, tcfg)
        jspec, jshape = tuple(want[path]), shapes[path].shape
        if depth:
            assert jshape[0] == depth
            jspec = jspec[1:]
        assert _norm(spec) == _norm(jspec), (name, path, spec, jspec)
        seen.add(path)
    assert seen == set(want)


def test_jax_path_is_the_mapping_of_flat_to_jax():
    """Each port name's JAX path and depth (``convert.jax_path``) locate
    its leaf in the tree ``convert.flat_to_jax`` builds; tail layers are
    unstacked."""
    for arch in tconfigs.ARCHS:
        cfg = tconfigs.get_reduced(arch, num_layers=5) if arch == \
            "recurrentgemma_2b" else tconfigs.get_reduced(arch)
        flat = {n: np.zeros(p.shape, np.float32) for n, p in
                model.abstract_params(cfg).named_parameters()}
        tree = _by_path(convert.flat_to_jax(flat, cfg))
        for name, a in flat.items():
            path, depth = convert.jax_path(name, cfg)
            assert tree[path].shape == ((depth, *a.shape) if depth
                                        else a.shape), (name, path)
        if arch == "recurrentgemma_2b":
            assert convert.jax_path("layers.4.mlp.w_in", cfg) == (
                "tail_layers/0/mlp/w_in", 0)


@pytest.mark.parametrize("shape", MESHES)
def test_batch_pspecs_match_jax(shape):
    jmesh, tmesh = _meshes(shape)
    for rows in (1, 2, 3, 4, 8, 12, 16, 32, 64, 512):
        batch = {"tokens": np.zeros((rows, 8), np.int32),
                 "labels": np.zeros((rows, 8), np.int32),
                 "media": np.zeros((rows, 4, 16), np.float32)}
        want = jshd.batch_pspecs(batch, jmesh)
        got = shd.batch_pspecs(batch, tmesh)
        assert {k: _norm(v) for k, v in got.items()} == {
            k: _norm(v) for k, v in want.items()}, rows
        # shapes serve as well as arrays
        assert shd.batch_pspecs({k: v.shape for k, v in batch.items()},
                                tmesh) == got


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_cache_pspecs_match_jax(arch, shape):
    """The decode cache of the full config, on the meta device, in both
    packages' shared layout: a batch of 32 that every mesh's data axes
    divide, and one of 3 that none beyond 1 does."""
    jmesh, tmesh = _meshes(shape)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for batch in (32, 3):
        jcache = jax.eval_shape(lambda: jmodel.init_cache(jcfg, batch, 256))
        want = _by_path(jshd.cache_pspecs(jcache, jcfg, jmesh),
                        is_leaf=_is_spec)
        tcache = model.init_cache(tcfg, batch, 256, device="meta")
        got = _by_path(shd.cache_pspecs(tcache, tcfg, tmesh),
                       is_leaf=lambda x: isinstance(x, M.P))
        assert set(got) == set(want)
        for path, spec in got.items():
            assert _norm(spec) == _norm(want[path]), (path, spec, want[path])


def test_lm_meshes_and_constrain():
    """Outside a group: ``make_host_mesh`` is (1, 1) over ("data",
    "model"), ``make_production_mesh`` the same and, over pods, raises
    for one rank; ``data_axes`` and ``use_mesh`` as JAX's;
    ``constrain`` is the identity; ``to_named`` pairs specs with their
    mesh."""
    host = M.make_host_mesh()
    assert host.shape == {"data": 1, "model": 1}
    assert M.make_production_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        M.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError):
        M.make_host_mesh(model_axis=2)
    assert M.data_axes(M.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
                       ) == ("pod", "data")
    assert M.data_axes(host) == ("data",)
    with M.use_mesh(host):
        assert M.axis_size(("data", "model")) == 1
        x = torch.ones(2, 3)
        assert shardctx.constrain(x, "data", None, "model") is x
    assert shardctx.constrain(x, "data") is x
    named = shd.to_named({"a": M.P("data"), "b": [M.P(), M.P(None, "model")]},
                         host)
    assert named["a"] == shd.NamedSharding(host, M.P("data"))
    assert named["b"][1].spec == M.P(None, "model")
    # a spec pickles as itself (specs cross ``ranks.spawn``)
    import pickle
    assert pickle.loads(pickle.dumps(M.P(("pod", "data"), None))) == \
        M.P(("pod", "data"), None)


def test_production_mesh_shapes_over_a_group(monkeypatch):
    """The declared difference from JAX's 16 x 16: "model" is 2 where the
    ranks it splits are an even count above 2, else 1."""
    for n, want, pods in ((1, (1, 1), (1, 1, 1)), (2, (2, 1), (2, 1, 1)),
                          (4, (2, 2), (2, 2, 1)), (8, (4, 2), (2, 2, 2)),
                          (6, (3, 2), (2, 3, 1))):
        monkeypatch.setattr(M, "device_count", lambda n=n: n)
        mesh = M.make_production_mesh()
        assert tuple(mesh.shape.values()) == want, n
        if n > 1:
            assert tuple(M.make_production_mesh(multi_pod=True).shape.values()
                         ) == pods, n
