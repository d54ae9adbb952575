"""Meshes of the deCSVM engines, and the one collective helper.

Counterpart of the deCSVM half of ``repro.launch.mesh``.  A ``Mesh`` here
is a description — named axes and their sizes — not a device handle: the
engines of ``repro_torch.core.decentral`` run at one rank, so every axis
a ``make_*`` function can build has size 1 (``device_count()`` is 1 on
one card and on the CPU, as ``len(jax.devices())`` is 1 on a host with
one device).  A mesh whose axis product exceeds ``device_count()``
raises.

``collective(op, x, axis_name)`` is the port's ``psum`` / ``pmax`` /
``pmean`` / ``all_gather`` / ``ppermute``: inside ``bound(mesh)`` (the
counterpart of running under ``shard_map``) it resolves the axis names
against the bound mesh, and over axes of size 1 it is the identity.  Any
named axis larger than 1 raises ``NotImplementedError`` naming ROADMAP
Queue 1 item 12, the multi-rank half of the engines (``torch.distributed``
collectives), which fills this function in.

The LM stack's meshes (``make_production_mesh``, ``make_host_mesh``,
``data_axes``, ``use_mesh``) belong to Queue 1 item 13.5 and are not here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

AxisName = Union[str, Sequence[str]]

MULTI_RANK = "(ROADMAP Queue 1 item 12: collectives across ranks)"

_bound = threading.local()


def device_count() -> int:
    """Ranks the engines can use: 1 — the engines run at one rank on one
    card or on the CPU until item 12 brings ``torch.distributed``."""
    return 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes, in order (hashable: the engines'
    builders are cached on it)."""
    axes: Tuple[Tuple[str, int], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(n for _, n in self.axes)


def _make(sizes, names) -> Mesh:
    mesh = Mesh(tuple(zip(names, (int(s) for s in sizes))))
    if min(mesh.shape.values()) < 1 or mesh.size > device_count():
        raise ValueError(f"mesh {mesh.shape} needs {mesh.size} ranks; "
                         f"{device_count()} available")
    return mesh


def make_node_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D ("node",) mesh of the sharded engines (gather / ring)."""
    return _make((n_devices or device_count(),), ("node",))


def make_node_lam_mesh(n_node: int, n_lam: Optional[int] = None) -> Mesh:
    """2-D mesh with named axes ("node", "lam") for the lambda-path engine
    (``decentral.decsvm_path_mesh``): network nodes over "node", lambda
    grid cells over "lam"."""
    n_lam = device_count() // n_node if n_lam is None else n_lam
    return _make((n_node, n_lam), ("node", "lam"))


def make_node_chunk_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh with named axis ("node_chunk",) for the chunked engines:
    each rank owns a contiguous chunk of ``ceil(m / n_devices)`` nodes."""
    n = device_count() if n_devices is None else n_devices
    return _make((n,), ("node_chunk",))


def make_chunk_lam_mesh(n_chunk: int, n_lam: Optional[int] = None) -> Mesh:
    """2-D mesh with named axes ("node_chunk", "lam"): the chunked
    analogue of ``make_node_lam_mesh``."""
    n_lam = device_count() // n_chunk if n_lam is None else n_lam
    return _make((n_chunk, n_lam), ("node_chunk", "lam"))


def multi_rank_error(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} spans more than one rank {MULTI_RANK}")


def require_one_rank(mesh: Mesh, where: str) -> None:
    """Raise unless every axis of ``mesh`` has size 1."""
    if mesh.size > 1:
        raise multi_rank_error(f"{where}: mesh {mesh.shape}")


@contextlib.contextmanager
def bound(mesh: Mesh):
    """Bind ``mesh`` for the collectives of the calling thread (the
    counterpart of the body of a ``shard_map``)."""
    stack = getattr(_bound, "stack", None)
    if stack is None:
        stack = _bound.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def axis_size(axis_name: AxisName) -> int:
    """Product of the sizes of the named axes of the innermost bound mesh."""
    stack = getattr(_bound, "stack", None)
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if not stack:
        raise ValueError(f"axis {axis_name!r}: no mesh is bound "
                         "(run inside launch.mesh.bound(mesh))")
    shape = stack[-1].shape
    missing = [a for a in names if a not in shape]
    if missing:
        raise ValueError(f"axes {missing} not in the bound mesh {shape}")
    return math.prod(shape[a] for a in names)


COLLECTIVES = ("psum", "pmax", "pmean", "all_gather", "ppermute")


def collective(op: str, x, axis_name: AxisName, perm=None):
    """``op`` of ``x`` over the named axes of the bound mesh: the identity
    over axes of size 1 (one rank holds the whole axis; a ``ppermute``'s
    permutation is then [(0, 0)]).  ``perm`` is the ``ppermute``'s
    (source, destination) pairs, kept for item 12."""
    if op not in COLLECTIVES:
        raise ValueError(f"collective {op!r} not in {COLLECTIVES}")
    n = axis_size(axis_name)
    if n > 1:
        raise multi_rank_error(f"{op} over axis {axis_name!r} of size {n}")
    return x
