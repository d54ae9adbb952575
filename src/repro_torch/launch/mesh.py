"""Meshes of the deCSVM engines, and their collectives across ranks.

Counterpart of the deCSVM half of ``repro.launch.mesh``.  A ``Mesh`` here
is a description — named axes and their sizes — laid over the ranks of
the ``torch.distributed`` group (``launch.ranks`` starts one): JAX's
``shard_map`` runs one program per device from one controller, the port
runs one process per rank, each calling the same entry point with the
same global arrays (SPMD).  ``device_count()`` is the size of the
initialised group, and 1 without one (one card, or the CPU).

A mesh of ``k`` ranks runs ``device_count() / k`` copies of itself, each
on ``k`` consecutive ranks (a mesh of one rank: every rank runs the whole
program alone).  Inside a copy a rank's coordinates are row-major over
the axes, as ``jax.make_mesh`` lays devices out.  A mesh larger than the
group, or one whose size does not divide it, raises ``ValueError`` at
construction, as JAX's ``assert n_node * n_lam <= n`` does.

``collective(op, x, axis_name)`` is the port's ``psum`` / ``pmax`` /
``pmean`` / ``all_gather`` / ``ppermute``: inside ``bound(mesh)`` (the
counterpart of running under ``shard_map``) it resolves the axis names
against the bound mesh and runs over the ranks that share this rank's
coordinates on every other axis; over axes of size 1 it is the identity.
``bound`` creates the mesh's subgroups the first time the mesh is bound:
one per line of every set of its axes, on every rank in one order
(``dist.new_group`` is itself collective).  ``block`` and ``assemble``
slice a rank's block of an operand and gather a global result by
partition specs (``P``), as ``shard_map``'s ``in_specs`` and
``out_specs`` do.

The backend follows the placement of the ranks (``launch.ranks``): NCCL
when each rank has its own card, gloo when ranks share a card or run on
the CPU.  Under gloo a CUDA tensor is staged through host memory (copied
to the CPU, reduced or exchanged there, copied back).  ``comm`` counts
the calls over more than one rank and the host seconds spent in them,
``comm_bytes`` the bytes of each by op, as nccl-tests sizes them: the
operand of a reduction or a ``ppermute`` and the input of a
``psum_scatter``, the gathered result of an ``all_gather``.

The LM stack's meshes: ``make_host_mesh`` and ``data_axes`` as JAX's,
``use_mesh`` is ``bound``.  ``make_production_mesh`` differs by design:
JAX's 16 x 16 (or 2 x 16 x 16) is a TPU pod with no H100 counterpart, so
the port lays ("data", "model") over the group it finds (see
``make_production_mesh``).  ``AbstractMesh`` is a mesh description that
no group backs (``launch.sharding`` computes the specs of a 16 x 16 mesh
in one process on it, as JAX's rules read only ``mesh.shape``).
``collective("psum_scatter", ...)`` is the reduce-scatter of the ZeRO-3
train step (``launch.train.make_jitted_train_step``); ``time_collectives``
records each collective's span on the card's stream with CUDA events.

Two exchanges span the whole group, outside any mesh: ``broadcast_from``
sends one rank's object and tensors to every rank (fit serving's front
end hands each chunked bucket to the followers), and
``same_on_every_rank`` tells every rank whether all of them hold the same
integer (the followers and the front end agree on a bucket's outcome).
``warm`` makes one exchange on every line of a mesh, so that a backend's
set-up on its first use falls outside a timed run.

``dry(mesh, rank)`` binds a mesh of any size to one virtual rank with no
group behind it (``launch.dryrun``): ``rank``, ``axis_size``,
``axis_index`` and ``block`` resolve against it, ``bound`` makes no
subgroup, and ``collective`` returns a tensor of its result's shape and
dtype on the operand's device (meta in a dry run) without a ``dist``
call, recording each call twice in the ``DryRecord`` it yields: under
the port's names and sizing, as ``comm_bytes`` counts, and under the
names XLA's HLO gives the collective, sized by its result as
``repro.launch.dryrun.collective_bytes`` sizes it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AxisName = Union[str, Sequence[str]]

_bound = threading.local()
# subgroups of the bound meshes: (axes, axis set) -> [(members, group)],
# and this rank's line of each (axes, axis names) -> (members in axis-index
# order, group, the device its backend reduces on); for the current world
# group, cleared when it changes
_groups: Dict[tuple, List[tuple]] = {}
_lines: Dict[tuple, tuple] = {}
_world = [None]

# collectives over more than one rank since the last ``reset_comm``:
# calls, and host seconds spent in them (staging included)
comm: Dict[str, float] = {"calls": 0, "seconds": 0.0}
# the same collectives' bytes by op (module docstring)
comm_bytes: Dict[str, int] = {}
# under ``time_collectives``: (op, start, end, host ms) — CUDA events on the
# current stream around each collective of a CUDA tensor; for a host
# tensor (gloo's widened gradients) no events and the host milliseconds
_spans: List[tuple] = []
_timing = [False]
# the ``DryRecord`` of the dry run in progress (``dry``), else None: one
# for the process, not the thread, as autograd may run a backward on a
# thread of its own
_dry: list = [None]


def reset_comm() -> None:
    comm["calls"] = 0
    comm["seconds"] = 0.0
    comm_bytes.clear()
    _spans.clear()


@contextlib.contextmanager
def time_collectives():
    """Within: each collective of a CUDA tensor over more than one rank
    records CUDA events on the current stream before and after it, so
    ``collective_ms`` reads the time the stream spent in collectives (the
    collective's own time where nothing overlaps it, as in the train
    step, whose compute waits on each one); a collective of a host tensor
    records its host time."""
    _timing[0] = True
    try:
        yield
    finally:
        _timing[0] = False


def collective_ms(by_op: bool = False):
    """Milliseconds in collectives recorded under ``time_collectives``
    since the last ``reset_comm`` (synchronizes the card); with ``by_op``
    a dict of them by collective."""
    out: Dict[str, float] = {}
    for op, ms in _span_ms():
        out[op] = out.get(op, 0.0) + ms
    return out if by_op else float(sum(out.values()))


def span_ms(op: str) -> List[float]:
    """The milliseconds of each ``op`` recorded under
    ``time_collectives`` since the last ``reset_comm``, in order
    (synchronizes the card)."""
    return [ms for name, ms in _span_ms() if name == op]


def _span_ms():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return [(op, host_ms if a is None else a.elapsed_time(b))
            for op, a, b, host_ms in _spans]


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def device_count() -> int:
    """Ranks the engines can use: the size of the initialised
    ``torch.distributed`` group, else 1; in a dry run the dry mesh's."""
    if _dry[0] is not None:
        return _dry[0].mesh.size
    return dist.get_world_size() if _in_group() else 1


def rank() -> int:
    """This process's rank in the group (0 without one); in a dry run the
    virtual rank."""
    if _dry[0] is not None:
        return _dry[0].rank
    return dist.get_rank() if _in_group() else 0


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Named mesh axes and their sizes, in order, with no group behind
    them: what the placement rules read (``shape``, ``axis_names``)."""
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


@dataclasses.dataclass(frozen=True)
class Mesh(AbstractMesh):
    """Named mesh axes and their sizes, in order (hashable: the engines
    cache what they build on it).  Checked against the group at
    construction."""

    def __post_init__(self):
        n, have = self.size, device_count()
        if min(self.shape.values(), default=1) < 1:
            raise ValueError(f"mesh {self.shape}: an axis of size < 1")
        if n > have or have % n:
            raise ValueError(f"mesh {self.shape} needs {n} ranks; the group "
                             f"has {have} ranks (a mesh must divide it)")


def abstract_mesh(sizes, names) -> AbstractMesh:
    """A mesh description of any size, checked against no group."""
    return AbstractMesh(tuple(zip(names, (int(s) for s in sizes))))


def _make(sizes, names) -> Mesh:
    return Mesh(tuple(zip(names, (int(s) for s in sizes))))


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


def make_host_mesh(model_axis: int = 1) -> Mesh:
    """("data", "model") over every rank of the group (tests, CPU runs)."""
    n = device_count()
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide {n} ranks")
    return _make((n // model_axis, model_axis), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The LM stack's mesh over the group, a declared difference from
    JAX: its 16 x 16 ("data", "model") and 2 x 16 x 16 ("pod", "data",
    "model") are TPU pod slices with no H100 counterpart.  Here "model" is
    2 where the ranks it splits are an even count above 2, else 1, and
    "data" takes the rest; with ``multi_pod`` a leading "pod" axis of 2
    splits the group first (four cards: (2, 2), or (2, 2, 1) over two
    pods)."""
    n = device_count()
    pods = 2 if multi_pod else 1
    if n % pods:
        raise ValueError(f"{n} ranks do not split into {pods} pods")
    per = n // pods
    model_axis = 2 if per % 2 == 0 and per > 2 else 1
    sizes = (per // model_axis, model_axis)
    if multi_pod:
        return _make((pods, *sizes), ("pod", "data", "model"))
    return _make(sizes, ("data", "model"))


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's batch axes, in order: "pod" and "data" where present."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _coords(mesh: Mesh, r: int) -> Dict[str, int]:
    """Rank ``r``'s coordinates on ``mesh`` (row-major within its copy)."""
    out, i = {}, r % mesh.size
    for name, n in reversed(mesh.axes):
        out[name], i = i % n, i // n
    return out


def _names(axis_name: AxisName) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def _index(mesh: Mesh, names, r: int) -> int:
    """Rank ``r``'s index along the named axes, row-major in their order."""
    c, shape, i = _coords(mesh, r), mesh.shape, 0
    for a in names:
        i = i * shape[a] + c[a]
    return i


def _make_groups(mesh: Mesh) -> None:
    """Create ``mesh``'s subgroups unless they exist: for each set of its
    axes (in mesh order), one group per line — the ranks of one copy that
    share their coordinates on the other axes.  Every rank creates every
    group, in the same order; lines of one rank need none."""
    world = dist.group.WORLD
    if _world[0] is not world:
        _groups.clear()
        _lines.clear()
        _world[0] = world
    names = mesh.axis_names
    if (mesh.axes, frozenset(names)) in _groups:
        return
    W = dist.get_world_size()
    for k in range(1, len(names) + 1):
        for subset in itertools.combinations(names, k):
            lines = {}
            for r in range(W):
                c = _coords(mesh, r)
                key = (r // mesh.size,) + tuple(
                    c[a] for a in names if a not in subset)
                lines.setdefault(key, []).append(r)
            made = []
            for key in sorted(lines):
                members = lines[key]
                if len(members) > 1:
                    made.append((members, dist.new_group(members)))
            _groups[(mesh.axes, frozenset(subset))] = made


@contextlib.contextmanager
def bound(mesh: Mesh):
    """Bind ``mesh`` for the collectives of the calling thread (the
    counterpart of the body of a ``shard_map``); a mesh of more than one
    rank gets its subgroups here, the first time it is bound (in a dry run
    none)."""
    if mesh.size > 1 and _dry[0] is None:
        _make_groups(mesh)
    stack = getattr(_bound, "stack", None)
    if stack is None:
        stack = _bound.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def use_mesh(mesh: Mesh):
    """JAX's ``use_mesh``: the port binds a mesh with ``bound``."""
    return bound(mesh)


def _mesh() -> Mesh:
    stack = getattr(_bound, "stack", None)
    if not stack:
        raise ValueError("no mesh is bound (run inside launch.mesh.bound(mesh))")
    return stack[-1]


def axis_size(axis_name: AxisName) -> int:
    """Product of the sizes of the named axes of the innermost bound mesh."""
    names = _names(axis_name)
    try:
        shape = _mesh().shape
    except ValueError:
        raise ValueError(f"axis {axis_name!r}: no mesh is bound "
                         "(run inside launch.mesh.bound(mesh))") from None
    missing = [a for a in names if a not in shape]
    if missing:
        raise ValueError(f"axes {missing} not in the bound mesh {shape}")
    return math.prod(shape[a] for a in names)


def axis_index(axis_name: AxisName) -> int:
    """This rank's index along the named axes of the bound mesh."""
    axis_size(axis_name)
    return _index(_mesh(), _names(axis_name), rank())


def _line(axis_name: AxisName):
    """(members in axis-index order, group, the device its backend reduces
    on: host memory under gloo, this rank's card under NCCL) of this
    rank's line along the named axes."""
    mesh, names = _mesh(), _names(axis_name)
    key = (mesh.axes, names)
    line = _lines.get(key)
    if line is None:
        r = rank()
        members, group = next(
            (ms, g) for ms, g in _groups[(mesh.axes, frozenset(names))]
            if r in ms)
        members = sorted(members, key=lambda q: _index(mesh, names, q))
        line = _lines[key] = (members, group, _backend_device(group))
    return line


def _backend_device(group=None) -> torch.device:
    """Where ``group``'s backend (the whole group's by default) exchanges
    tensors: host memory under gloo, this rank's card under NCCL."""
    return (torch.device("cpu") if dist.get_backend(group) == "gloo"
            else torch.device("cuda", torch.cuda.current_device()))


def comm_device(axis_name: AxisName) -> torch.device:
    """The device the backend of this rank's line along the named axes
    reduces on: host memory under gloo, this rank's card under NCCL; in a
    dry run the dry run's device (meta: one card a rank, as NCCL's)."""
    if _dry[0] is not None:
        return torch.device("meta")
    return _line(axis_name)[2]


def _to_comm(x, dev, copy: bool):
    """``x`` contiguous on ``dev`` (a copy where ``copy``: the
    reductions work in place)."""
    t = x.detach()
    if t.device != dev:
        return t.to(dev).contiguous()
    return t.clone(memory_format=torch.contiguous_format) if (
        copy or not t.is_contiguous()) else t


@contextlib.contextmanager
def _accounted(op: str, cuda: bool):
    """One exchange over more than one rank: its call and host seconds in
    ``comm``, and under ``time_collectives`` its span (CUDA events on the
    current stream around it where ``cuda``, else its host ms).  The
    caller adds its bytes to ``comm_bytes``."""
    t0 = time.perf_counter()
    span = None
    if _timing[0] and cuda:
        span = (op, torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        span[1].record()
    yield
    if span is not None:
        span[2].record()
        _spans.append(span + (None,))
    elif _timing[0]:
        _spans.append((op, None, None, 1e3 * (time.perf_counter() - t0)))
    comm["calls"] += 1
    comm["seconds"] += time.perf_counter() - t0


def broadcast_from(src: int, obj=None, tensors=()):
    """Rank ``src``'s ``obj`` (any picklable object) and ``tensors`` on
    every rank of the group; returns (obj, tensors).  The other ranks pass
    nothing: the object carries the tensors' shapes and dtypes, and each
    tensor travels on its own through the backend's device — the card
    under NCCL, host memory under gloo — where the receivers get theirs;
    ``src`` gets its own tensors back.  Counted as one call under
    "broadcast", with the tensors' bytes (not the object's pickle).
    Outside a group, the identity."""
    tensors = list(tensors)
    if device_count() == 1:
        return obj, tensors
    me, dev = rank(), _backend_device()
    with _accounted("broadcast", dev.type == "cuda"):
        meta = [(obj, [(tuple(t.shape), t.dtype) for t in tensors])
                if me == src else None]
        dist.broadcast_object_list(meta, src=src)
        obj, shapes = meta[0]
        out = []
        for i, (shape, dtype) in enumerate(shapes):
            t = (_to_comm(tensors[i], dev, copy=False) if me == src
                 else torch.empty(shape, dtype=dtype, device=dev))
            dist.broadcast(t, src=src)
            out.append(tensors[i] if me == src else t)
    comm_bytes["broadcast"] = comm_bytes.get("broadcast", 0) + sum(
        t.numel() * t.element_size() for t in out)
    return obj, out


def same_on_every_rank(value: int) -> bool:
    """Whether every rank of the group passed the same ``value`` (one
    all-reduce of (value, -value) by max over the whole group, counted
    under "pmax").  True outside a group."""
    if device_count() == 1:
        return True
    dev = _backend_device()
    t = torch.tensor([value, -value], dtype=torch.int64, device=dev)
    with _accounted("pmax", dev.type == "cuda"):
        dist.all_reduce(t, dist.ReduceOp.MAX)
    comm_bytes["pmax"] = comm_bytes.get("pmax", 0) + t.numel() * 8
    return int(t[0]) == -int(t[1])


COLLECTIVES = ("psum", "pmax", "pmean", "all_gather", "ppermute",
               "psum_scatter")


def collective(op: str, x, axis_name: AxisName, perm=None):
    """``op`` of ``x`` over the named axes of the bound mesh.

    ``psum`` / ``pmax`` reduce over the line, ``pmean`` is its sum over
    the axis size, ``all_gather`` concatenates the line's blocks along
    dim 0 in axis-index order, and ``ppermute`` sends ``x`` along
    ``perm`` ((source, destination) axis indices): a rank that no pair
    addresses receives zeros, as in JAX.  ``psum_scatter`` is the sum over
    the line split along dim 0 (which the axis size divides): the rank
    of axis index i keeps block i (gloo has no reduce-scatter: it sums,
    then slices).  Over axes of size 1 every op is the identity.  The
    result is on ``x``'s device.
    """
    if op not in COLLECTIVES:
        raise ValueError(f"collective {op!r} not in {COLLECTIVES}")
    n = axis_size(axis_name)
    if n == 1:
        return x
    if _dry[0] is not None:
        return _dry[0].collective(op, x, n)
    with _accounted(op, x.device.type == "cuda"):
        out = _exchange(op, x, axis_name, n, perm)
    comm_bytes[op] = comm_bytes.get(op, 0) + (
        out if op == "all_gather" else x).numel() * x.element_size()
    return out


def _exchange(op, x, axis_name, n, perm):
    """``collective``'s exchange itself, over this rank's line."""
    members, group, dev = _line(axis_name)
    if op in ("psum", "pmax", "pmean"):
        t = _to_comm(x, dev, copy=True)
        dist.all_reduce(t, dist.ReduceOp.MAX if op == "pmax"
                        else dist.ReduceOp.SUM, group=group)
        out = t.to(x.device)
        if op == "pmean":
            out = out / n
    elif op == "all_gather":
        t = _to_comm(x, dev, copy=False)
        parts = [torch.empty_like(t) for _ in members]
        dist.all_gather(parts, t, group=group)
        order = sorted(members)        # the group's ranks are sorted
        out = torch.cat([parts[order.index(q)] for q in members]).to(x.device)
    elif op == "psum_scatter":
        me, k = members.index(rank()), x.shape[0] // n
        if dist.get_backend(group) == "gloo":
            t = _to_comm(x, dev, copy=True)
            dist.all_reduce(t, group=group)
            out = t[me * k:(me + 1) * k].to(x.device)
        else:
            # the group's rank i receives chunk i; ours is axis index me
            order = sorted(members)
            t = _to_comm(x, dev, copy=False)
            if members != order:
                t = torch.cat([t[members.index(q) * k:
                                 (members.index(q) + 1) * k] for q in order])
            out = torch.empty_like(t[:k])
            dist.reduce_scatter_tensor(out, t, group=group)
            out = out.to(x.device)
    else:
        me = members.index(rank())
        t = _to_comm(x, dev, copy=False)
        srcs = [s for s, d in perm if d == me]
        buf = torch.zeros_like(t)
        p2p = [dist.P2POp(dist.isend, t, members[d], group)
               for s, d in perm if s == me and d != me]
        if srcs and srcs[0] != me:
            p2p.append(dist.P2POp(dist.irecv, buf, members[srcs[0]], group))
        elif srcs:
            buf = t.clone()
        for work in (dist.batch_isend_irecv(p2p) if p2p else ()):
            work.wait()
        out = buf.to(x.device)
    return out


# JAX's HLO names of the port's collectives (``dry``)
HLO_NAMES = {"psum": "all-reduce", "pmax": "all-reduce", "pmean": "all-reduce",
             "all_gather": "all-gather", "psum_scatter": "reduce-scatter",
             "ppermute": "collective-permute"}


@dataclasses.dataclass
class DryRecord:
    """The collectives of a dry run (``dry``): ``calls`` holds one (op, the
    port's bytes, HLO name, HLO bytes) a call, in order; ``moved``, where
    set, is called with each operand and its result (``launch.dryrun``
    follows which arguments a result holds)."""
    mesh: AbstractMesh
    rank: int
    calls: List[tuple] = dataclasses.field(default_factory=list)
    moved: Optional[object] = None

    def collective(self, op: str, x, n: int):
        """``op``'s result over a line of ``n`` ranks, shaped as the real
        one (``_exchange``) and allocated on ``x``'s device, unfilled."""
        shape = list(x.shape)
        if op == "all_gather":
            shape[0] *= n
        elif op == "psum_scatter":
            shape[0] //= n
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        if self.moved is not None:
            self.moved(x, out)
        size = x.element_size()
        self.calls.append((op, (out if op == "all_gather" else x).numel()
                           * size, HLO_NAMES[op], out.numel() * size))
        return out

    @staticmethod
    def comm_of(calls) -> Dict[str, int]:
        """{op: bytes} of ``calls``, as ``comm_bytes`` counts."""
        out: Dict[str, int] = {}
        for op, nbytes, _, _ in calls:
            out[op] = out.get(op, 0) + nbytes
        return out

    @staticmethod
    def hlo_of(calls) -> Dict[str, int]:
        """{HLO name: result bytes} of ``calls``, and "total", as
        ``repro.launch.dryrun.collective_bytes`` reads an HLO module."""
        out: Dict[str, int] = {}
        for _, _, name, nbytes in calls:
            out[name] = out.get(name, 0) + nbytes
        out["total"] = sum(out.values())
        return out


@contextlib.contextmanager
def dry(mesh, rank: int = 0):
    """Within: a dry run of one rank of ``mesh`` (any size: an
    ``AbstractMesh`` of 16 x 16 as well as a ``Mesh``), rank ``rank``,
    with no group (module docstring).  Yields the ``DryRecord``.  Outside
    it nothing here changes behaviour."""
    if _dry[0] is not None:
        raise RuntimeError("a dry run is in progress")
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} is not on mesh {mesh.shape}")
    rec = _dry[0] = DryRecord(mesh, rank)
    try:
        yield rec
    finally:
        _dry[0] = None


class P(tuple):
    """A partition spec: for each leading dim of an operand, the mesh axis
    that splits it, or None (``P()``: the whole operand on every rank)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):          # pickles as P(*axes)
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def block(a, spec):
    """This rank's block of ``a`` (a tensor, a numpy array, or a tuple of
    them under a tuple of specs) under the bound mesh.  A tensor block
    that is not contiguous or not 16-byte aligned is copied (the kernels'
    stream instances read aligned bases)."""
    if not isinstance(spec, P):
        return tuple(block(x, s) for x, s in zip(a, spec))
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        k = a.shape[d] // axis_size(ax)
        lo = axis_index(ax) * k
        if isinstance(a, torch.Tensor):
            a = a.narrow(d, lo, k)
        else:
            a = a[(slice(None),) * d + (slice(lo, lo + k),)]
    if isinstance(a, torch.Tensor) and (not a.is_contiguous()
                                        or a.data_ptr() % 16):
        a = a.clone(memory_format=torch.contiguous_format)
    return a


def assemble(out, spec):
    """The global result from this rank's block ``out`` (or a tuple of
    blocks under a tuple of specs): an ``all_gather`` along each split
    dim, so every rank returns the same global tensors."""
    if not isinstance(spec, P):
        return tuple(assemble(x, s) for x, s in zip(out, spec))
    for d, ax in enumerate(spec):
        if ax is not None and axis_size(ax) > 1:
            out = collective("all_gather", out.movedim(d, 0), ax).movedim(0, d)
    return out


def warm(mesh: Mesh) -> float:
    """One exchange (a one-element ``psum``) on every line of ``mesh``,
    each set of its axes in mesh order, on every rank, so that a
    backend's set-up on a line's first use (NCCL makes its communicator
    then) falls here and not in a timed run (``reset_comm`` after it).
    Returns the host seconds it took (the card synchronized)."""
    t0 = time.perf_counter()
    if mesh.size > 1:
        x = torch.zeros(1, device=_backend_device())
        with bound(mesh):
            for k in range(1, len(mesh.axes) + 1):
                for subset in itertools.combinations(mesh.axis_names, k):
                    collective("psum", x, subset)
        if x.is_cuda:
            torch.cuda.synchronize()
    return time.perf_counter() - t0
