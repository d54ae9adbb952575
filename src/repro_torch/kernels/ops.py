"""Wrappers of the CUDA kernels: checks, launch counters, residency rule.

For tensors on the CPU each wrapper computes its kernel's plain torch
version (``csvm_update.*_plain``, ``ref.mha``, ``ref.mha_backward``,
``ref.ssd_scan``, ``ref.ssd_scan_backward``); for CUDA tensors it launches
the CUDA kernel of ``csrc/csvm_update.cu``, ``csrc/flash_attention.cu``,
``csrc/flash_backward.cu``, ``csrc/ssd_scan.cu`` or
``csrc/ssd_backward.cu`` on ``torch.cuda.current_stream()`` or raises —
there is no fallback from one to the other.  For tensors on
``torch.device("meta")`` (the dry runs, ``launch.dryrun``) each wrapper
takes its meta route: the checks and the instance a card would run
(``flash_instance``, ``ssd_instance``, ``round_block_instance``,
``two_pass_instance``, ``flash_backward_instance``,
``ssd_backward_instance``; a stream instance's grid at an H100's
occupancy, ``cost.H100_SMS``), that instance's outputs and scratch
allocated on meta, and the kernel's flops and bytes added to
``cost.counts`` (``kernels.cost``) — no launch, no count in
``launches``.  Operands must be on one
device with the documented shapes and dtypes: the CSVM kernels take
contiguous fp32 (X may be bf16 where stated), ``flash_attention`` fp32 or
bf16 views with a unit stride over D (``flash_attention_backward``
likewise for o and do), ``ssd_scan`` fp32 or bf16 x/B/C views with a unit
stride over their last axis (``ssd_scan_backward`` likewise for dy);
anything else raises before launch.  ``FlashAttention`` and ``SSDScan`` are the
``torch.autograd.Function``s of the flash and SSD wrappers, which the
model trains through on the card; ``ssd_scan`` goes through ``SSDScan``
whenever an input requires grad.

``launches[name]`` counts the kernel launches of each wrapper (one per
call that reached the kernel, none for the plain version), so a run can
show that its path went through the kernels; ``flash_launches``,
``round_block_launches`` and ``ssd_launches`` split
``launches["flash_attention"]``, ``launches["csvm_round_block"]`` and
``launches["ssd_scan"]`` by the instance that ran (``flash_instance``,
``round_block_instance``, ``ssd_instance``), ``flash_backward_launches``
and ``ssd_backward_launches`` split ``launches["flash_attention_backward"]``
and ``launches["ssd_scan_backward"]`` (``flash_backward_instance``,
``ssd_backward_instance``), and ``two_pass_launches``
splits ``launches["csvm_block_update"]`` plus
``launches["csvm_local_update"]`` (``two_pass_instance``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.core.losses import KERNEL_IDS
from repro_torch.kernels import build, cost, ref
from repro_torch.kernels.csvm_update import (csvm_block_update_plain,
                                             csvm_local_update_plain,
                                             csvm_round_block_plain)

KERNELS = ("csvm_local_update", "csvm_block_update", "csvm_round_block",
           "flash_attention", "ssd_scan", "flash_attention_backward",
           "ssd_scan_backward")
launches: Dict[str, int] = {name: 0 for name in KERNELS}
# flash_attention's two instances: bf16 tensor cores (wgmma, TMA) and fp32
# FMAs on the CUDA cores
FLASH_INSTANCES = ("wgmma", "fma")
flash_launches: Dict[str, int] = {name: 0 for name in FLASH_INSTANCES}
# flash_attention_backward's two instances: bf16 tensor cores (wgmma, TMA;
# two kernels) and fp32 FMAs on the CUDA cores (three kernels)
FLASH_BACKWARD_INSTANCES = ("wgmma", "fma")
flash_backward_launches: Dict[str, int] = {
    name: 0 for name in FLASH_BACKWARD_INSTANCES}
# csvm_round_block's two instances: X streamed through shared memory once a
# round (TMA bulk copies) and X read twice a round with plain loads
ROUND_INSTANCES = ("stream", "direct")
round_block_launches: Dict[str, int] = {name: 0 for name in ROUND_INSTANCES}
# ssd_scan's two instances: chunk-parallel on the bf16 tensor cores (three
# passes) and the chunk walk in fp32 FMAs on the CUDA cores
SSD_INSTANCES = ("wgmma", "fma")
ssd_launches: Dict[str, int] = {name: 0 for name in SSD_INSTANCES}
# ssd_scan_backward's two instances: the products on the bf16 tensor cores
# (wgmma, the fp32 operands in three bf16 terms) and fp32 FMAs on the CUDA
# cores; four kernels each
SSD_BACKWARD_INSTANCES = ("wgmma", "fma")
ssd_backward_launches: Dict[str, int] = {
    name: 0 for name in SSD_BACKWARD_INSTANCES}
# the two-pass update's two instances (csvm_block_update and
# csvm_local_update): X read once through the round kernel's stream ring,
# then a reduction launch; and X read twice with plain loads
TWO_PASS_INSTANCES = ("stream", "direct")
two_pass_launches: Dict[str, int] = {name: 0 for name in TWO_PASS_INSTANCES}

_P, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
_SIGNATURES = {
    "csvm_block_update": [_P, _I] + [_P] * 9 + [_I, _I, _I, _F, _I, _F, _P],
    "csvm_local_update": [_P] * 10 + [_I, _I, _I, _F, _I, _F, _P],
    "csvm_round_block": ([_P, _I] + [_P] * 13 + [_I] * 5
                         + [_F, _F, _F, _I, _F, _F, _F, _P]),
    "csvm_round_block_occupancy": [_I, ctypes.POINTER(_I),
                                   ctypes.POINTER(_I)],
    "csvm_round_stream": ([_P, _I] + [_P] * 14 + [_I] * 9
                          + [_F, _F, _F, _I, _F, _F, _F, _P]),
    "csvm_round_stream_occupancy": [_I, _I, ctypes.POINTER(_I),
                                    ctypes.POINTER(_I)],
    "csvm_two_pass_stream": ([_P, _I] + [_P] * 10 + [_I] * 7
                             + [_F, _I, _F, _P]),
    "csvm_two_pass_stream_occupancy": [_I, _I, ctypes.POINTER(_I),
                                       ctypes.POINTER(_I)],
}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0
    for name in FLASH_INSTANCES:
        flash_launches[name] = 0
    for name in FLASH_BACKWARD_INSTANCES:
        flash_backward_launches[name] = 0
    for name in ROUND_INSTANCES:
        round_block_launches[name] = 0
    for name in SSD_INSTANCES:
        ssd_launches[name] = 0
    for name in SSD_BACKWARD_INSTANCES:
        ssd_backward_launches[name] = 0
    for name in TWO_PASS_INSTANCES:
        two_pass_launches[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("csvm_update")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.csvm_error_string.argtypes = [ctypes.c_int]
    lib.csvm_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _flash_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention.argtypes = [_P] * 4 + [_I] * 7 + [_LL] * 12 + [
        _F, _I, _I, _P, _P]
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_attention_tc.argtypes = [_P] * 4 + [_I] * 6 + [_LL] * 12 + [
        _F, _I, _I, _P, _P]
    lib.flash_attention_tc.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _flash_backward_lib() -> ctypes.CDLL:
    lib = build.load("flash_backward")
    lib.flash_attention_backward.argtypes = [_P] * 9 + [_I] * 7 + [
        _LL] * 24 + [_F, _I, _I, _P, _P]
    lib.flash_attention_backward.restype = ctypes.c_int
    lib.flash_attention_backward_tc.argtypes = [_P] * 10 + [_I] * 7 + [
        _LL] * 24 + [_F, _I, _I, _P, _P]
    lib.flash_attention_backward_tc.restype = ctypes.c_int
    lib.flash_attention_backward_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_backward_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _ssd_lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    lib.ssd_scan.argtypes = [_P] * 8 + [_I] * 7 + [_LL] * 10 + [_P]
    lib.ssd_scan.restype = ctypes.c_int
    lib.ssd_scan_tc.argtypes = [_P] * 10 + [_I] * 7 + [_LL] * 10 + [_P]
    lib.ssd_scan_tc.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _ssd_backward_lib() -> ctypes.CDLL:
    lib = build.load("ssd_backward")
    lib.ssd_scan_backward.argtypes = [_P] * 21 + [_I] * 8 + [_LL] * 13 + [
        _P]
    lib.ssd_scan_backward.restype = ctypes.c_int
    lib.ssd_scan_backward_tc.argtypes = [_P] * 21 + [_I] * 7 + [
        _LL] * 13 + [_P]
    lib.ssd_scan_backward_tc.restype = ctypes.c_int
    lib.ssd_backward_tc_occupancy.argtypes = [_I, _I]
    lib.ssd_backward_tc_occupancy.restype = ctypes.c_int
    lib.ssd_scan_backward_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_backward_error_string.restype = ctypes.c_char_p
    return lib


def _check_call(name: str, err: int, error_string=None) -> None:
    if err != 0:
        error_string = error_string or _lib().csvm_error_string
        msg = error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    launches[name] += 1


# the devices whose tensors take the card's route through the models: the
# card, and meta (a dry run, which takes each kernel's meta route)
CARD_ROUTE = ("cuda", "meta")


def _is_cuda(X: torch.Tensor, name: str) -> bool:
    """True on the card or on meta (the card's route, ``_launch`` or the
    meta route), False on the CPU (the plain version)."""
    if X.device.type == "cpu":
        return False
    if X.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: tensors on {X.device} are not supported")
    return True


def _meta_stream_grid(m: int, n: int, p: int, dtype) -> int:
    """A stream instance's grid on meta: ``round_stream_grid`` at an
    H100's occupancy (``cost.STREAM_BLOCKS_PER_SM`` blocks on each of its
    ``cost.H100_SMS`` SMs)."""
    return round_stream_grid(m, n, p, 2 if dtype == torch.bfloat16 else 4,
                             cost.STREAM_BLOCKS_PER_SM, cost.H100_SMS)


def _expect(name: str, what: str, t, shape, dtypes, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: {what} must be a tensor, got {type(t)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {what} has dtype {t.dtype}, expected one "
                        f"of {dtypes}")
    if t.device != device:
        raise ValueError(f"{name}: {what} is on {t.device}, X on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


_F32 = (torch.float32,)
_X_DTYPES = (torch.float32, torch.bfloat16)


def _kernel_id(kernel: str) -> int:
    try:
        return KERNEL_IDS[kernel]
    except KeyError:
        raise ValueError(f"unknown kernel {kernel!r}") from None


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_two_pass(name, X, y, B, P, neigh, rho, omega, lam_vec,
                    x_dtypes):
    if X.dim() != 3 or min(X.shape) < 1:
        raise ValueError(f"{name}: X must be a non-empty (m, n, p) tensor, "
                         f"got shape {tuple(X.shape)}")
    m, n, p = X.shape
    if m > 65535:
        raise ValueError(f"{name}: m={m} exceeds the grid's 65535 nodes")
    dev = X.device
    _expect(name, "X", X, (m, n, p), x_dtypes, dev)
    _expect(name, "y", y, (m, n), _F32, dev)
    for what, t in (("B", B), ("P", P), ("neigh", neigh)):
        _expect(name, what, t, (m, p), _F32, dev)
    _expect(name, "rho", rho, (m,), _F32, dev)
    _expect(name, "omega", omega, (m,), _F32, dev)
    _expect(name, "lam", lam_vec, (p,), _F32, dev)


# --------------------------------------------------------------------------
# Round kernel: residency rule, buffers, wrapper
# --------------------------------------------------------------------------

# The stream instance's layout (csrc/csvm_update.cu, round_stream_kernel):
# 512 consumer threads of up to 16 columns each, a ring of three stages of
# whole rows of X (about 64 KB each, at most 32 rows), and after the ring
# its mbarriers, per-warp row sums and row weights (kStreamFixedBytes).
_STREAM_CONSUMERS = 512
_STREAM_MAX_COLS = 16
STREAM_MAX_P = _STREAM_CONSUMERS * _STREAM_MAX_COLS
_STREAM_STAGES = 3
_STREAM_MAX_ROWS = 32
_STREAM_TILE_BYTES = 65536
_STREAM_FIXED_BYTES = (128 + _STREAM_MAX_ROWS * (_STREAM_CONSUMERS // 32) * 4
                       + _STREAM_MAX_ROWS * 4 + 128)
_SMEM_LIMIT = 232448   # an H100 block's dynamic shared memory, bytes
_STATIC_SMEM = 1024    # kept free for a kernel's static shared memory


def round_stream_tile_rows(p: int, itemsize: int) -> int:
    """Rows of X in one stage of the stream instance's ring: ~64 KB of
    whole rows, between 1 and 32."""
    return max(1, min(_STREAM_MAX_ROWS, _STREAM_TILE_BYTES // (p * itemsize)))


def round_stream_stage_bytes(p: int, itemsize: int) -> int:
    """Bytes of one stage: the tile's rows plus the 16-byte alignment of a
    span that starts or ends mid-row, rounded up to 128."""
    need = round_stream_tile_rows(p, itemsize) * p * itemsize + 32
    return -(-need // 128) * 128


def round_stream_smem_bytes(p: int, itemsize: int) -> int:
    """Dynamic shared memory of one stream-instance block."""
    return (_STREAM_STAGES * round_stream_stage_bytes(p, itemsize)
            + _STREAM_FIXED_BYTES)


def round_block_instance(m: int, n: int, p: int, dtype=torch.float32) -> str:
    """The instance of the round kernel a CUDA call runs, by shape alone:
    ``"stream"`` (X read once a round) while a consumer thread's registers
    hold its columns (p <= 8192) and the ring fits a block's shared memory,
    ``"direct"`` (X read twice a round) beyond."""
    itemsize = 2 if dtype == torch.bfloat16 else 4
    if (p <= STREAM_MAX_P and round_stream_smem_bytes(p, itemsize)
            <= _SMEM_LIMIT - _STATIC_SMEM):
        return "stream"
    return "direct"


def round_stream_plan(m: int, n: int, grid: int):
    """The stream instance's partition of the m*n rows of X (flattened) over
    ``grid`` blocks: ``rows`` (grid + 1) bounds block b's contiguous range
    [rows[b], rows[b+1]), which may cross node boundaries; a block's range
    splits at them into node segments, numbered in row order, so a node's
    segments are consecutive and in block order: ``seg0`` (grid) is each
    block's first segment and ``node_seg`` (m + 1) bounds each node's.
    Returns (rows, seg0, node_seg) as lists of ints."""
    total = m * n
    if not 1 <= grid <= total:
        raise ValueError(f"round_stream_plan: grid={grid} for {total} rows")
    rows = [b * total // grid for b in range(grid + 1)]
    seg0, node_seg, seg = [], [0] * (m + 1), 0
    for b in range(grid):
        seg0.append(seg)
        row = rows[b]
        while row < rows[b + 1]:
            end = min(rows[b + 1], (row // n + 1) * n)
            seg += 1
            node_seg[row // n + 1] = seg
            row = end
    return rows, seg0, node_seg


@functools.lru_cache(maxsize=256)
def _num_segments(m: int, n: int, grid: int) -> int:
    """Node segments of the ``grid``-block plan (cached: a loop of
    launches sizes its scratch without walking the plan each time)."""
    return round_stream_plan(m, n, grid)[2][-1]


def round_stream_grid(m: int, n: int, p: int, itemsize: int,
                      blocks_per_sm: int, num_sms: int) -> int:
    """Blocks of a stream launch: every co-resident block (one per SM on an
    H100: 512 threads of 128 registers fill its register file), and no
    more blocks than tiles' worth of rows."""
    tiles = -(-(m * n) // round_stream_tile_rows(p, itemsize))
    return max(1, min(blocks_per_sm * num_sms, tiles))


def round_block_scratch_floats(m: int, n: int, p: int, num_rounds: int,
                               instance: str = "direct",
                               grid: int = 1) -> int:
    """fp32 scratch of one round-kernel launch.  ``"direct"``: the margin
    weights w (m, n), the second B buffer (m, p), beta_bar (p,) and one
    reduction slot per round plus the KKT stationarity and consensus
    slots.  ``"stream"``: the same without w, plus one partial X^T w row
    (p,) per node segment of the ``grid``-block plan (at most grid + m -
    1)."""
    if instance == "direct":
        return m * n + m * p + p + num_rounds + 2
    return m * p + p + num_rounds + 2 + _num_segments(m, n, grid) * p


def round_block_bytes(m: int, n: int, p: int, itemsize: int = 4,
                      num_rounds: int = 1, instance: str = "direct",
                      grid: int = 1) -> int:
    """Device bytes one ``csvm_round_block`` launch touches: its operands
    (X in the compute dtype; y, B, P, W, deg, rho, omega, lam in fp32;
    the int32 active-round count), its outputs (B, P and the statistic),
    its scratch and, for the stream instance, its int32 plan.  Pinned to
    the wrapper's real buffers by ``tests/test_torch_kernels.py``."""
    f = 4
    operands = (m * n * p * itemsize + m * n * f + 2 * m * p * f
                + m * m * f + 3 * m * f + p * f + 4)
    outputs = 2 * m * p * f + f
    scratch = round_block_scratch_floats(m, n, p, num_rounds, instance,
                                         grid) * f
    plan = 4 * (2 * grid + m + 2) if instance == "stream" else 0
    return operands + outputs + scratch + plan


@functools.lru_cache(maxsize=None)
def round_block_occupancy(device_index: int, bf16: bool,
                          instance: str = "direct", p: int = 1):
    """(co-resident blocks per SM, SM count) of a round-kernel instance on
    a card; the blocks per SM are 0 where the card has no cooperative
    launch.  The stream instance's depend on its shared memory, so on p."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        if instance == "stream":
            err = _lib().csvm_round_stream_occupancy(
                int(bf16), round_stream_smem_bytes(p, 2 if bf16 else 4),
                ctypes.byref(per_sm), ctypes.byref(sms))
        else:
            err = _lib().csvm_round_block_occupancy(
                int(bf16), ctypes.byref(per_sm), ctypes.byref(sms))
    if err != 0:
        msg = _lib().csvm_error_string(err).decode()
        raise RuntimeError(f"csvm_round_block_occupancy ({instance}): CUDA "
                           f"error {err} ({msg})")
    return per_sm.value, sms.value


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def round_block_grid(device, m: int, n: int, p: int, dtype) -> int:
    """The grid of a stream-instance launch on a card (``round_stream_grid``
    at the card's occupancy)."""
    bf16 = dtype == torch.bfloat16
    per_sm, sms = round_block_occupancy(_device_index(torch.device(device)),
                                        bf16, "stream", p)
    return round_stream_grid(m, n, p, 2 if bf16 else 4, per_sm, sms)


def megakernel_supported(m: int, n: int, p: int, dtype=None, device=None,
                         num_rounds: int = 1) -> bool:
    """True when the round kernel can take the (m, n, p) problem on
    ``device``; drivers take the loop of single rounds otherwise.

    On the CPU the plain version takes any size.  On a card, decided from
    shapes before launch, for the instance ``round_block_instance`` picks:
    every byte the launch touches (``round_block_bytes``: X plus the other
    operands, outputs, scratch and plan, the stream instance's partial rows
    at the grid its occupancy gives) must fit the device's memory, and the
    cooperative grid must be co-resident (at least one block per SM).
    """
    device = torch.device("cpu" if device is None else device)
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"megakernel_supported: device {device}")
    index = _device_index(device)
    bf16 = dtype == torch.bfloat16
    instance = round_block_instance(m, n, p, dtype)
    per_sm, sms = round_block_occupancy(index, bf16, instance,
                                        p if instance == "stream" else 1)
    if per_sm < 1:
        return False
    itemsize = 2 if bf16 else 4
    grid = (round_stream_grid(m, n, p, itemsize, per_sm, sms)
            if instance == "stream" else 1)
    need = round_block_bytes(m, n, p, itemsize, num_rounds, instance, grid)
    return need <= torch.cuda.get_device_properties(index).total_memory


def _round_block_buffers(X, y, B, P, W, deg, rho, omega, lam_vec, nact,
                         num_rounds: int, instance: str = "direct",
                         grid: int = 1):
    """Check the round kernel's operands and allocate its outputs and
    scratch on X's device: (Bout, Pout, stat, scratch), and for the stream
    instance its int32 plan for ``grid`` blocks as a fifth buffer."""
    name = "csvm_round_block"
    if X.dim() != 3 or min(X.shape) < 1:
        raise ValueError(f"{name}: X must be a non-empty (m, n, p) tensor, "
                         f"got shape {tuple(X.shape)}")
    if num_rounds < 1:
        raise ValueError(f"{name}: num_rounds={num_rounds} must be >= 1")
    if instance not in ROUND_INSTANCES:
        raise ValueError(f"{name}: unknown instance {instance!r}")
    m, n, p = X.shape
    dev = X.device
    _expect(name, "X", X, (m, n, p), _X_DTYPES, dev)
    _expect(name, "y", y, (m, n), _F32, dev)
    _expect(name, "B", B, (m, p), _F32, dev)
    _expect(name, "P", P, (m, p), _F32, dev)
    _expect(name, "W", W, (m, m), _F32, dev)
    for what, t in (("deg", deg), ("rho", rho), ("omega", omega)):
        _expect(name, what, t, (m,), _F32, dev)
    _expect(name, "lam_vec", lam_vec, (p,), _F32, dev)
    _expect(name, "nact", nact, (), (torch.int32,), dev)
    f32 = torch.float32
    buffers = (torch.empty((m, p), dtype=f32, device=dev),
               torch.empty((m, p), dtype=f32, device=dev),
               torch.empty((), dtype=f32, device=dev),
               torch.empty(round_block_scratch_floats(
                   m, n, p, num_rounds, instance, grid), dtype=f32,
                   device=dev))
    if instance == "direct":
        return buffers
    if m * n > 2 ** 31 - 1:
        raise ValueError(f"{name}: m*n={m * n} rows exceed int32")
    return buffers + (_plan_tensor(m, n, grid, dev),)


@functools.lru_cache(maxsize=64)
def _plan_tensor(m: int, n: int, grid: int, device: torch.device):
    """``round_stream_plan`` as one int32 tensor on ``device`` (rows, seg0,
    node_seg), kept so that a loop of launches copies it once."""
    rows, seg0, node_seg = round_stream_plan(m, n, grid)
    return torch.tensor(rows + seg0 + node_seg, dtype=torch.int32).to(device)


def _round_block_launch(X, y, B, P, W, deg, rho, omega, lam_vec, nact,
                        instance: str, *, tau, lam0, h,
                        kernel="epanechnikov", num_rounds=1, want_kkt=False,
                        grid=None):
    """One launch of round-kernel ``instance`` on CUDA operands; returns
    (B, P, stat).  ``csvm_round_block`` calls it with
    ``round_block_instance``'s choice and the stream instance's grid from
    ``round_block_grid``; ``grid`` may name a smaller co-resident grid."""
    name = "csvm_round_block"
    m, n, p = X.shape
    if instance == "stream":
        if p > STREAM_MAX_P:
            raise ValueError(f"{name}: the stream instance takes p <= "
                             f"{STREAM_MAX_P}, got p={p}")
        if X.data_ptr() % 16:
            raise ValueError(f"{name}: X's base is not 16-byte aligned, as "
                             "the stream instance's bulk copies need")
        if grid is None:
            grid = (_meta_stream_grid(m, n, p, X.dtype) if X.is_meta
                    else round_block_grid(X.device, m, n, p, X.dtype))
    bufs = _round_block_buffers(X, y, B, P, W, deg, rho, omega, lam_vec,
                                nact, num_rounds, instance, grid or 1)
    Bout, Pout, stat, scratch = bufs[:4]
    if X.is_meta:
        cost.record(name, *cost.round_block_work(
            m, n, p, X.element_size(), num_rounds, want_kkt), instance,
            (X, y, B, P, W, deg, rho, omega, lam_vec, nact))
        return Bout, Pout, stat
    head = (X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(),
            B.data_ptr(), P.data_ptr(), W.data_ptr(), deg.data_ptr(),
            rho.data_ptr(), omega.data_ptr(), lam_vec.data_ptr(),
            nact.data_ptr(), Bout.data_ptr(), Pout.data_ptr(),
            stat.data_ptr(), scratch.data_ptr())
    tail = (float(tau), float(lam0), float(h), _kernel_id(kernel), 1.0 / n,
            1.0 / m, (1.0 / n) / m, _stream(X.device))
    with torch.cuda.device(X.device):
        if instance == "stream":
            isz = X.element_size()
            err = _lib().csvm_round_stream(
                *head, bufs[4].data_ptr(), m, n, p, int(num_rounds),
                int(bool(want_kkt)), int(grid),
                round_stream_tile_rows(p, isz),
                round_stream_stage_bytes(p, isz),
                round_stream_smem_bytes(p, isz), *tail)
        else:
            err = _lib().csvm_round_block(
                *head, m, n, p, int(num_rounds), int(bool(want_kkt)), *tail)
    _check_call(name, err)
    round_block_launches[instance] += 1
    return Bout, Pout, stat


def csvm_round_block(X, y, B, P, W, deg, rho, omega, lam_vec, nact, *,
                     tau, lam0, h, kernel="epanechnikov", num_rounds=1,
                     want_kkt=False):
    """``num_rounds`` fused ADMM rounds (margins, X^T w gradient, (7a')
    prox, dense W@B neighbour sums, dual update) in one launch, with the
    KKT stop statistic in the same launch when ``want_kkt``.

    X (m, n, p) fp32 or bf16; y (m, n); B/P (m, p); W (m, m);
    deg/rho/omega (m,); lam_vec (p,), all fp32; nact the active-round
    count, a 0-d int32 tensor on X's device (rounds past it are held).
    Returns (B, P, stat): fp32 B/P and the 0-d statistic — the KKT
    residual (``want_kkt``) or the last active round's max|dB|.  On the
    card ``round_block_instance`` picks the kernel: p <= 8192 streams X
    once a round (and needs X's base 16-byte aligned, or raises); larger p
    reads it twice.
    """
    if not _is_cuda(X, "csvm_round_block"):
        return csvm_round_block_plain(
            X, y, B, P, W, deg, rho, omega, lam_vec, nact, tau=tau,
            lam0=lam0, h=h, kernel=kernel, num_rounds=num_rounds,
            want_kkt=want_kkt)
    return _round_block_launch(
        X, y, B, P, W, deg, rho, omega, lam_vec, nact,
        round_block_instance(*X.shape, X.dtype), tau=tau, lam0=lam0, h=h,
        kernel=kernel, num_rounds=num_rounds, want_kkt=want_kkt)


# --------------------------------------------------------------------------
# Two-pass update: instances, buffers, wrappers
# --------------------------------------------------------------------------

def csvm_block_update(X, y, B, P, neigh, rho, omega, lam_vec, *, h,
                      kernel="epanechnikov"):
    """Fused (7a') primal update for a stacked (m, n, p) node block; X fp32
    or bf16, everything else fp32; the neighbour term is an operand.
    Returns B_new (m, p) fp32.  On the card ``two_pass_instance`` picks the
    kernel: X read once (p <= 8192, X's base 16-byte aligned) or twice."""
    if not _is_cuda(X, "csvm_block_update"):
        return csvm_block_update_plain(X, y, B, P, neigh, rho, omega,
                                       lam_vec, h=h, kernel=kernel)
    return _two_pass_launch("csvm_block_update", X, y, B, P, neigh, rho,
                            omega, lam_vec, None, h=h, kernel=kernel)


def csvm_local_update(X, y, beta, p_dual, neigh, rho, omega, lam, *, h,
                      kernel="epanechnikov"):
    """Fused deCSVM local update (the "pallas" backend).  One node (X
    (n, p), (p,) vectors, scalar rho/omega) or a node stack (X (m, n, p),
    (m, p) rows, (m,) rho/omega); lam a scalar or a (p,) vector.  On the
    card X must be fp32 (the Pallas wrapper casts it to fp32 too) and the
    rows fp32; the kernel instance is ``csvm_block_update``'s."""
    if X.dim() == 2:
        return csvm_local_update(
            X[None], y[None], beta[None], p_dual[None], neigh[None],
            torch.as_tensor(rho, dtype=torch.float32,
                            device=X.device).reshape(1),
            torch.as_tensor(omega, dtype=torch.float32,
                            device=X.device).reshape(1),
            lam, h=h, kernel=kernel)[0]
    if not _is_cuda(X, "csvm_local_update"):
        return csvm_local_update_plain(X, y, beta, p_dual, neigh, rho, omega,
                                       lam, h=h, kernel=kernel)
    p = X.shape[-1]
    lam_vec = torch.broadcast_to(torch.as_tensor(
        lam, dtype=torch.float32, device=X.device).reshape(-1), (p,))
    return _two_pass_launch("csvm_local_update", X, y, beta, p_dual, neigh,
                            rho, omega, lam_vec.contiguous(), None, h=h,
                            kernel=kernel)


def two_pass_instance(m: int, n: int, p: int, dtype=torch.float32,
                      x_ptr: int = 0) -> str:
    """The instance of the two-pass update a CUDA call runs:
    ``"stream"`` (X read once, through the round kernel's stream ring)
    where that instance takes the shape (``round_block_instance``: p <=
    8192, the ring fits a block's shared memory), the m*n rows fit int32
    and X's base ``x_ptr`` is 16-byte aligned, as its bulk copies need;
    ``"direct"`` (X read twice) otherwise."""
    if (round_block_instance(m, n, p, dtype) == "stream"
            and m * n <= 2 ** 31 - 1 and x_ptr % 16 == 0):
        return "stream"
    return "direct"


def two_pass_scratch_floats(m: int, n: int, p: int, grid: int = 1,
                            instance: str = "stream") -> int:
    """fp32 scratch of one two-pass update.  ``"stream"``: one partial
    X^T w row (p,) per node segment of the ``grid``-block plan (at most
    grid + m - 1); ``"direct"``: the margin weights w (m, n)."""
    if instance == "direct":
        return m * n
    return _num_segments(m, n, grid) * p


@functools.lru_cache(maxsize=None)
def two_pass_occupancy(device_index: int, bf16: bool, p: int):
    """(resident blocks per SM, SM count) of the two-pass stream kernel on
    a card, at the ring of p columns (an ordinary launch)."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().csvm_two_pass_stream_occupancy(
            int(bf16), round_stream_smem_bytes(p, 2 if bf16 else 4),
            ctypes.byref(per_sm), ctypes.byref(sms))
    if err != 0:
        msg = _lib().csvm_error_string(err).decode()
        raise RuntimeError(f"csvm_two_pass_stream_occupancy: CUDA error "
                           f"{err} ({msg})")
    return per_sm.value, sms.value


def two_pass_grid(device, m: int, n: int, p: int, dtype) -> int:
    """The grid of a two-pass stream launch on a card: ``round_stream_grid``
    at the card's ordinary occupancy (one block per SM on an H100)."""
    bf16 = dtype == torch.bfloat16
    per_sm, sms = two_pass_occupancy(_device_index(torch.device(device)),
                                     bf16, p)
    if per_sm < 1:
        raise RuntimeError(f"csvm two-pass stream kernel: no block of "
                           f"{round_stream_smem_bytes(p, 2 if bf16 else 4)}"
                           " bytes of shared memory fits an SM")
    return round_stream_grid(m, n, p, 2 if bf16 else 4, per_sm, sms)


def _two_pass_buffers(X, instance: str, grid: int = 1):
    """The two-pass update's output B+ (m, p) and fp32 scratch on X's
    device, and for the stream instance its int32 plan for ``grid``
    blocks as a third buffer."""
    m, n, p = X.shape
    out = torch.empty((m, p), dtype=torch.float32, device=X.device)
    scratch = torch.empty(two_pass_scratch_floats(m, n, p, grid, instance),
                          dtype=torch.float32, device=X.device)
    if instance == "direct":
        return out, scratch
    return out, scratch, _plan_tensor(m, n, grid, X.device)


def _two_pass_launch(name, X, y, B, P, neigh, rho, omega, lam_vec, instance,
                     *, h, kernel="epanechnikov", grid=None):
    """One two-pass update of ``instance`` on CUDA operands for wrapper
    ``name`` (``"csvm_block_update"``, X fp32 or bf16, or
    ``"csvm_local_update"``, X fp32); returns B+ (m, p).  The wrappers pass
    ``instance=None``, ``two_pass_instance``'s choice, and the stream
    instance's grid from ``two_pass_grid``; ``grid`` may name another."""
    _check_two_pass(name, X, y, B, P, neigh, rho, omega, lam_vec,
                    _F32 if name == "csvm_local_update" else _X_DTYPES)
    m, n, p = X.shape
    if instance is None:
        instance = two_pass_instance(m, n, p, X.dtype, X.data_ptr())
    elif instance not in TWO_PASS_INSTANCES:
        raise ValueError(f"{name}: unknown instance {instance!r}")
    if instance == "stream":
        if two_pass_instance(m, n, p, X.dtype) != "stream":
            raise ValueError(f"{name}: the stream instance takes p <= "
                             f"{STREAM_MAX_P} and m*n < 2^31, got X "
                             f"{tuple(X.shape)}")
        if X.data_ptr() % 16:
            raise ValueError(f"{name}: X's base is not 16-byte aligned, as "
                             "the stream instance's bulk copies need")
        if grid is None:
            grid = (_meta_stream_grid(m, n, p, X.dtype) if X.is_meta
                    else two_pass_grid(X.device, m, n, p, X.dtype))
    bufs = _two_pass_buffers(X, instance, grid or 1)
    out, scratch = bufs[:2]
    if X.is_meta:
        cost.record(name, *cost.two_pass_work(m, n, p, X.element_size()),
                    instance, (X, y, B, P, neigh, rho, omega, lam_vec))
        return out
    bf16 = int(X.dtype == torch.bfloat16)
    operands = (y.data_ptr(), B.data_ptr(), P.data_ptr(), neigh.data_ptr(),
                rho.data_ptr(), omega.data_ptr(), lam_vec.data_ptr())
    tail = (float(h), _kernel_id(kernel), 1.0 / n, _stream(X.device))
    with torch.cuda.device(X.device):
        if instance == "stream":
            isz = X.element_size()
            err = _lib().csvm_two_pass_stream(
                X.data_ptr(), bf16, *operands, scratch.data_ptr(),
                bufs[2].data_ptr(), out.data_ptr(), m, n, p, int(grid),
                round_stream_tile_rows(p, isz),
                round_stream_stage_bytes(p, isz),
                round_stream_smem_bytes(p, isz), *tail)
        elif name == "csvm_local_update":
            err = _lib().csvm_local_update(
                X.data_ptr(), *operands, scratch.data_ptr(), out.data_ptr(),
                m, n, p, *tail)
        else:
            err = _lib().csvm_block_update(
                X.data_ptr(), bf16, *operands, scratch.data_ptr(),
                out.data_ptr(), m, n, p, *tail)
    _check_call(name, err)
    two_pass_launches[instance] += 1
    return out


# --------------------------------------------------------------------------
# Flash attention
# --------------------------------------------------------------------------

_ATTN_DTYPES = (torch.float32, torch.bfloat16)
_TC_HEAD_DIMS = (64, 128, 256)   # csrc/flash_attention.cu flash_attention_tc


def _copies_aligned(*operands) -> bool:
    """Every operand is a tensor whose base lies on a 16-byte boundary and
    whose strides over its leading axes (those of size > 1) are multiples
    of 16 bytes, as the tensor-core instances' TMA loads and 16-byte
    copies need."""
    return all(
        isinstance(t, torch.Tensor) and t.data_ptr() % 16 == 0
        and all(n == 1 or st * t.element_size() % 16 == 0
                for n, st in zip(t.shape[:-1], t.stride()[:-1]))
        for t in operands)


def flash_instance(dtype: torch.dtype, head_dim: int, *operands) -> str:
    """The instance of the flash kernel that a CUDA call runs:
    ``"wgmma"`` (bf16 tensor cores, TMA) for bf16 at D = 64, 128 or 256,
    ``"fma"`` (fp32 FMAs on the CUDA cores, any dtype) otherwise.  Given
    the operands (q, k, v), a bf16 call whose bases or strides the tensor
    maps cannot take (``_copies_aligned``) goes to ``"fma"`` too."""
    if (dtype == torch.bfloat16 and head_dim in _TC_HEAD_DIMS
            and _copies_aligned(*operands)):
        return "wgmma"
    return "fma"


def _check_attention(q, k, v, window, instance=None, *, causal: bool):
    """Check the operands for ``instance`` (default: the one
    ``flash_instance`` names by dtype and head dim alone) under the mask
    ``causal`` and ``window`` name (the key-length rule depends on it);
    raises ValueError or TypeError before any launch."""
    name = "flash_attention"
    for what, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name}: {what} must be a 4-d tensor")
        if t.dtype != q.dtype or t.dtype not in _ATTN_DTYPES:
            raise TypeError(f"{name}: q, k, v must share one dtype of "
                            f"{_ATTN_DTYPES}, got {what} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, q on "
                             f"{q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {what} needs a unit stride over D")
    B, H, S, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, KV, Sk, D) or tuple(v.shape) != (B, KV, Sk, D):
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, KV, Sk, D) for q "
                         f"{tuple(q.shape)}")
    ref.check_key_length(S, Sk, causal, window)
    if min(B, H, S, Sk, KV) < 1 or H % KV or not 1 <= D <= 256:
        raise ValueError(f"{name}: needs H % KV == 0 and D <= 256, got "
                         f"q {tuple(q.shape)}, KV={KV}")
    if (S + 63) // 64 > 65535:
        raise ValueError(f"{name}: S={S} exceeds the grid's 65535 q tiles")
    if window is not None and int(window) < 1:
        raise ValueError(f"{name}: window={window} would mask every key")
    if instance not in (None,) + FLASH_INSTANCES:
        raise ValueError(f"{name}: unknown instance {instance!r}")
    if (instance or flash_instance(q.dtype, D)) == "wgmma":
        _check_tensor_core(name, q.dtype, D, q=q, k=k, v=v)


def _check_tensor_core(name, dtype, D, **operands):
    """The tensor-core instances' rules: bf16 at D = 64, 128 or 256, and
    operands that the tensor maps (and 16-byte loads) can take —
    16-byte-aligned bases, strides of 16 bytes over the dimensions of
    size > 1; raises ValueError."""
    if flash_instance(dtype, D) != "wgmma":
        raise ValueError(f"{name}: the tensor-core instance takes bf16 "
                         f"at D = 64, 128 or 256, got {dtype}, D={D}")
    for what, t in operands.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what}'s base is not 16-byte "
                             "aligned, as the bf16 kernel's TMA loads "
                             "need")
        if any(n > 1 and st % 8 for n, st in zip(t.shape[:3],
                                                 t.stride()[:3])):
            raise ValueError(f"{name}: {what}'s strides {t.stride()} "
                             "are not multiples of 16 bytes, as the "
                             "bf16 kernel's TMA loads need")


def _tma_strides(t):
    """t's element strides over (B, heads, S) for a tensor map; a dimension
    of size 1 is never stepped over, so its stride becomes the tensor's
    span (rounded up to 8 elements), which the map accepts."""
    span = -(-max(n * st for n, st in zip(t.shape, t.stride())) // 8) * 8
    return [st if n > 1 else span for n, st in zip(t.shape[:3],
                                                    t.stride()[:3])]


def _check_fp32_rows(name, what, t, shape, device):
    """``t`` must be a dense fp32 tensor of ``shape`` on ``device``."""
    if (not isinstance(t, torch.Tensor) or tuple(t.shape) != tuple(shape)
            or t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {what} must be a dense fp32 tensor of "
                         f"shape {tuple(shape)} on {device}")


def _flash_launch(q, k, v, instance, *, causal, window, sm_scale,
                  o32=None):
    """One launch of ``instance`` on CUDA operands (checked here); returns
    the output (and fills ``o32``, where given, as ``flash_attention``
    says).  ``flash_attention`` calls it with ``flash_instance``'s
    choice; the fp32-FMA instance also takes bf16."""
    _check_attention(q, k, v, window, instance, causal=causal)
    if o32 is not None:
        _check_fp32_rows("flash_attention", "o32", o32, q.shape, q.device)
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    if q.is_meta:
        cost.record("flash_attention", *cost.attention_work(
            B, H, k.shape[1], S, D, q.element_size(), window, k.shape[2],
            causal), instance, (q, k, v))
        return out
    scale = float(sm_scale) if sm_scale is not None else D ** -0.5
    lib = _flash_lib()
    shape = (B, H, k.shape[1], S, k.shape[2], D)
    tail = (*out.stride()[:3], scale, int(bool(causal)),
            int(window) if window is not None else 0,
            o32.data_ptr() if o32 is not None else None, _stream(q.device))
    with torch.cuda.device(q.device):
        if instance == "wgmma":
            err = lib.flash_attention_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *shape, *_tma_strides(q), *_tma_strides(k),
                *_tma_strides(v), *tail)
        else:
            err = lib.flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                int(q.dtype == torch.bfloat16), *shape, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], *tail)
    _check_call("flash_attention", err, lib.flash_attention_error_string)
    flash_launches[instance] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    sm_scale=None, o32=None):
    """Grouped-query attention with an online softmax: q (B, H, S, D),
    k and v (B, KV, Sk, D), fp32 or bf16, H % KV == 0, D <= 256; causal
    and sliding-window (``window``) masks; ``sm_scale`` defaults to
    D ** -0.5.  Returns (B, H, S, D) in q's dtype.  The keys may have a
    length of their own (Sk != S, cross-attention) only with
    ``causal=False`` and no window; such a call raises ValueError before
    any launch, on the CPU as on the card.

    On the card the inputs may be strided views (unit stride over D), so
    the model's (B, S, H, D) projections go in as ``.transpose(1, 2)``
    without a copy; the output takes q's strides when q is dense (a
    transposed (B, S, H, D) buffer), so it transposes back for free.
    ``flash_instance`` picks the kernel from the operands: bf16 at D = 64
    or 128 with 16-byte-aligned bases and strides of 16 bytes runs on the
    tensor cores; the rest, a misaligned bf16 view included, runs the
    fp32-FMA kernel.

    ``o32``, a dense fp32 (B, H, S, D) tensor, also gets the output before
    its rounding to q's dtype (the training path's, for the backward's
    delta: ``FlashAttention``).
    """
    if not _is_cuda(q, "flash_attention"):
        if o32 is None:
            return ref.mha(q, k, v, causal=causal, window=window,
                           sm_scale=sm_scale)
        _check_fp32_rows("flash_attention", "o32", o32, q.shape, q.device)
        # ref.mha computes in fp32 and rounds once: the same values
        full = ref.mha(q.float(), k.float(), v.float(), causal=causal,
                       window=window, sm_scale=sm_scale)
        o32.copy_(full)
        return full.to(q.dtype)
    instance = flash_instance(q.dtype, q.shape[-1], q, k, v)
    return _flash_launch(q, k, v, instance, causal=causal, window=window,
                         sm_scale=sm_scale, o32=o32)


def flash_backward_instance(dtype: torch.dtype, head_dim: int,
                            *operands) -> str:
    """The instance of the backward kernel that a CUDA call runs, by the
    forward's rule (``flash_instance``): ``"wgmma"`` (bf16 tensor cores,
    TMA) for bf16 at D = 64, 128 or 256, ``"fma"`` (fp32 FMAs, any dtype)
    otherwise; given the operands (q, k, v, o, do), a bf16 call whose
    bases or strides the tensor maps cannot take goes to ``"fma"`` too."""
    return flash_instance(dtype, head_dim, *operands)


def _check_backward(q, k, v, o, do, window, instance=None, *,
                    causal: bool):
    """The forward's checks on q, k, v (the fp32-FMA instance's rules),
    and o and do shaped, typed and placed as q, with a unit stride over D;
    for ``instance`` (default: the one ``flash_backward_instance`` names
    by dtype and head dim alone) ``"wgmma"``, the tensor-core rules on q,
    k, v, o and do.  Raises ValueError or TypeError before any launch."""
    name = "flash_attention_backward"
    _check_attention(q, k, v, window, "fma", causal=causal)
    for what, t in (("o", o), ("do", do)):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != tuple(
                q.shape):
            raise ValueError(f"{name}: {what} must have q's shape "
                             f"{tuple(q.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name}: {what} is {t.dtype} on {t.device}, q "
                            f"{q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {what} needs a unit stride over D")
    if instance not in (None,) + FLASH_BACKWARD_INSTANCES:
        raise ValueError(f"{name}: unknown instance {instance!r}")
    D = q.shape[-1]
    if (instance or flash_backward_instance(q.dtype, D)) == "wgmma":
        _check_tensor_core(name, q.dtype, D, q=q, k=k, v=v, o=o, do=do)


def backward_stats_floats(B: int, H: int, S: int, instance: str) -> int:
    """Floats of the fp32 scratch that one backward call of ``instance``
    needs: m, l and delta per query row for ``"fma"``; lse and delta per
    row, S rounded up to a multiple of 128 (the tensor-core instance's
    query tiles at D = 64 and 128; two of its 64-row tiles at D = 256),
    for ``"wgmma"``."""
    if instance == "wgmma":
        return 2 * B * H * (-(-S // 128) * 128)
    return 3 * B * H * S


# The longest chain of k16 tensor-core steps that one block of the
# tensor-core backward's pass B may sum dk and dv over at D = 64 and 128
# (csrc/flash_backward.cu): internvl2-1b's training shape, 7 query heads a
# kv head x 4096 queries / 16, which the H100 holds within the bf16 rule.
# glm4-9b's group of 16 at 4096 queries (4,096 steps) in one block read
# 1.68 of the rule at dk; split in 4 it reads 0.97.  command-r-35b's 2,048
# steps read 0.98 in one block, and split in 2 cost ~1 % of its time.
BACKWARD_CHAIN_B = 1792


def backward_splits(H: int, KV: int, S: int, D: int, instance: str) -> int:
    """Blocks a (b, kv head) of the tensor-core backward's pass B, each
    summing dk and dv over H / KV / splits query heads of S queries: one
    head a block at D = 256; at D = 64 and 128 the fewest splits (a divisor
    of the group) that keep a block's chain, heads x ceil(S / 64) x 4 k16
    steps, within BACKWARD_CHAIN_B.  1 for the fp32-FMA instance."""
    group = H // KV
    if instance != "wgmma":
        return 1
    if D == 256:
        return group
    steps = -(-S // 64) * 4
    for s in range(1, group):
        if group % s == 0 and group // s * steps <= BACKWARD_CHAIN_B:
            return s
    return group


def backward_partials_floats(B: int, KV: int, splits: int, Sk: int,
                             D: int) -> int:
    """Floats of the fp32 scratch that one tensor-core backward call keeps
    for dk and dv beside the row statistics where pass B splits the group
    (``backward_splits`` > 1): each block's sums, (2, B * KV * splits, Sk,
    D), added in order after; 0 otherwise."""
    return 2 * B * KV * splits * Sk * D if splits > 1 else 0


def _flash_backward_launch(q, k, v, o, do, instance, *, causal, window,
                           sm_scale, delta=None, splits=None):
    """One call of ``instance`` on CUDA operands (checked here); returns
    (dq, dk, dv).  ``flash_attention_backward`` calls it with
    ``flash_backward_instance``'s choice; the fp32-FMA instance also takes
    bf16.  ``splits`` overrides ``backward_splits`` for the tensor-core
    instance (a divisor of H / KV; 1: the whole group in one block)."""
    _check_backward(q, k, v, o, do, window, instance, causal=causal)
    if delta is not None:
        _check_fp32_rows("flash_attention_backward", "delta", delta,
                         q.shape[:3], q.device)
    B, H, S, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if splits is None:
        splits = backward_splits(H, KV, S, D, instance)
    elif instance != "wgmma" or splits < 1 or (H // KV) % splits:
        raise ValueError(f"flash_attention_backward: splits {splits} needs "
                         f"the tensor-core instance and a divisor of the "
                         f"group {H // KV}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stats = torch.empty(backward_stats_floats(B, H, S, instance),
                        dtype=torch.float32, device=q.device)
    n_partial = backward_partials_floats(B, KV, splits, Sk, D)
    partials = (torch.empty(n_partial, dtype=torch.float32, device=q.device)
                if n_partial else None)
    if q.is_meta:
        cost.record("flash_attention_backward", *cost.attention_backward_work(
            B, H, KV, S, Sk, D, causal, window, q.element_size())[:2],
            instance, (q, k, v, o, do))
        return dq, dk, dv
    scale = float(sm_scale) if sm_scale is not None else D ** -0.5
    lib = _flash_backward_lib()
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv, stats)]
    tail = (scale, int(bool(causal)),
            int(window) if window is not None else 0,
            delta.data_ptr() if delta is not None else None,
            _stream(q.device))
    with torch.cuda.device(q.device):
        if instance == "wgmma":
            strides = [st for t in (q, k, v, o, do, dq, dk, dv)
                       for st in _tma_strides(t)]
            err = lib.flash_attention_backward_tc(
                *ptrs, partials.data_ptr() if partials is not None else None,
                splits, B, H, KV, S, Sk, D, *strides, *tail)
        else:
            strides = [st for t in (q, k, v, o, do, dq, dk, dv)
                       for st in t.stride()[:3]]
            err = lib.flash_attention_backward(
                *ptrs, int(q.dtype == torch.bfloat16), B, H, KV, S, Sk, D,
                *strides, *tail)
    _check_call("flash_attention_backward", err,
                lib.flash_attention_backward_error_string)
    flash_backward_launches[instance] += 1
    return dq, dk, dv


def flash_attention_backward(q, k, v, o, do, *, causal: bool = True,
                             window=None, sm_scale=None, delta=None):
    """dq, dk, dv of ``o = flash_attention(q, k, v, causal=, window=,
    sm_scale=)`` given ``do`` = dL/do: q, o, do (B, H, S, D), k, v (B, KV,
    Sk, D), one dtype (fp32 or bf16), the forward's masks and rules (Sk !=
    S only unmasked).  Returns (dq, dk, dv) in the inputs' dtype, each laid
    out as its input (``torch.empty_like``: a transposed (B, S, heads, D)
    view gets a transposed result).

    On the card, the instance ``flash_backward_instance`` names from the
    operands: bf16 at D = 64, 128 or 256 with 16-byte-aligned bases and
    strides runs the two tensor-core kernels of ``csrc/flash_backward.cu`` (lse,
    delta and dq per head and query tile; dk and dv per kv head and key
    tile); the rest its three fp32-FMA passes.  Neither uses atomics, so
    two launches on the same inputs agree bit for bit.  On the CPU:
    ``ref.mha_backward``.

    ``delta``, a dense fp32 (B, H, S) tensor, stands for rowsum(do * o):
    the training path passes it from the forward's unrounded o
    (``FlashAttention``), since delta from the rounded o carries an error
    common to every key of a row (``csrc/flash_backward.cu``)."""
    if not _is_cuda(q, "flash_attention_backward"):
        if delta is not None:
            _check_fp32_rows("flash_attention_backward", "delta", delta,
                             q.shape[:3], q.device)
        return ref.mha_backward(q, k, v, o, do, causal=causal, window=window,
                                sm_scale=sm_scale, delta=delta)
    instance = flash_backward_instance(q.dtype, q.shape[-1], q, k, v, o, do)
    return _flash_backward_launch(q, k, v, o, do, instance, causal=causal,
                                  window=window, sm_scale=sm_scale,
                                  delta=delta)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward runs the wrapper
    (the kernel on the card) and keeps q, k, v and o; the backward runs
    ``flash_attention_backward`` on them.  Inputs (B, heads, rows, D) as
    the wrappers take them.  ``FlashAttention.apply(q, k, v, causal,
    window, sm_scale)``; where no input requires grad (serving) it is the
    one ``flash_attention`` launch, and its output has no graph.  Under
    grad a bf16 forward also writes its output unrounded (``o32``), and
    the backward takes delta = rowsum(do * o32) from it: the softmax's own
    row sum, as autograd of the plain attention has it, where the rounded
    o would put an error common to every key of the row into dS."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale):
        o32 = None
        if q.dtype != torch.float32 and any(ctx.needs_input_grad[:3]):
            o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        o = flash_attention(q, k, v, causal=causal, window=window,
                            sm_scale=sm_scale, o32=o32)
        ctx.save_for_backward(q, k, v, o, o32)
        ctx.mask = (causal, window, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, o32 = ctx.saved_tensors
        causal, window, sm_scale = ctx.mask
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = None
        if o32 is not None:
            delta = torch.sum(do.float() * o32, dim=-1).contiguous()
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, do, causal=causal, window=window, sm_scale=sm_scale,
            delta=delta)
        return dq, dk, dv, None, None, None


# --------------------------------------------------------------------------
# SSD scan (Mamba-2)
# --------------------------------------------------------------------------

_SSD_PT = 16           # columns of p per block (csrc/ssd_scan.cu kPT)
_SSD_MAX_CHUNK = 128
_SSD_TC_CHUNKS = (64, 128)   # csrc/ssd_scan.cu ssd_scan_tc
_SSD_TC_MAX_GROUP = 4        # heads per block of its passes (a) and (c)


def ssd_instance(dtype: torch.dtype, p: int, n: int, chunk: int,
                 *operands) -> str:
    """The instance of the SSD kernel that a CUDA call runs:
    ``"wgmma"`` (chunk-parallel, bf16 tensor cores) for bf16 at chunk 64
    or 128 with p and n multiples of 16 in [16, 256], ``"fma"`` (the chunk
    walk in fp32 FMAs, any dtype) otherwise.  Given the operands (x, B,
    C), a bf16 call whose bases or strides the 16-byte copies cannot take
    (``_copies_aligned``) goes to ``"fma"`` too."""
    if (dtype == torch.bfloat16 and chunk in _SSD_TC_CHUNKS
            and p % 16 == 0 and 16 <= p <= 256
            and n % 16 == 0 and 16 <= n <= 256
            and _copies_aligned(*operands)):
        return "wgmma"
    return "fma"


def ssd_head_group(b: int, s: int, h: int, chunk: int) -> int:
    """Heads per block of the tensor-core instance's chunk and output
    passes (each block forms C B^T once for its group): the largest of 4,
    2, 1 that still gives every SM of an H100 (132) a block, so that short
    prompts fill the card too (``python3 -m repro_torch.launch.profile_ssd``
    times each group at mamba2-370m's shapes)."""
    blocks = b * -(-s // chunk)
    group = _SSD_TC_MAX_GROUP
    while group > 1 and blocks * -(-h // group) < 132:
        group //= 2
    return group


def ssd_scratch_floats(b: int, s: int, h: int, p: int, n: int,
                       chunk: int) -> int:
    """fp32 scratch of one tensor-core ``ssd_scan`` launch: each chunk's
    local state, then its carried-in state (b, nc, h, n, p), and each
    chunk's last cumulative decay (b, nc, h)."""
    nc = -(-s // chunk)
    return b * nc * h * (n * p + 1)


def ssd_smem_bytes(chunk: int, n: int) -> int:
    """Shared memory of one ``ssd_scan`` block of the fp32-FMA instance
    (``smem_floats`` of ``csrc/ssd_scan.cu``): cum, dt and two decays (Q
    each), x and x*dt (Q x 16), B^T and C^T (n x (Q+8)), the decayed B
    (Q x (n+4)), the masked scores (Q x (Q+8)) and the state slice
    (n x 16), fp32."""
    Q = chunk
    return 4 * (4 * Q + 2 * Q * _SSD_PT + 2 * n * (Q + 8) + Q * (n + 4)
                + Q * (Q + 8) + n * _SSD_PT)


def _check_ssd_operands(name, x, dt, A, B, C, D, chunk):
    """The rules that the forward's and the backward's kernels share:
    devices, shapes, dtypes, unit strides over p and n, n a multiple of
    4, a chunk a multiple of 8 up to 128."""
    for what, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C),
                    ("D", D)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {what} must be a tensor, got {type(t)}")
        if t.device != x.device:
            raise ValueError(f"{name}: {what} is on {t.device}, x on "
                             f"{x.device}")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (b, s, h, p), got "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    if B.dim() != 3 or B.shape[:2] != (b, s) or C.shape != B.shape:
        raise ValueError(f"{name}: B {tuple(B.shape)} and C "
                         f"{tuple(C.shape)} must be (b, s, n) for x "
                         f"{tuple(x.shape)}")
    n = B.shape[2]
    if tuple(dt.shape) != (b, s, h):
        raise ValueError(f"{name}: dt has shape {tuple(dt.shape)}, expected "
                         f"{(b, s, h)}")
    for what, t in (("A", A), ("D", D)):
        if tuple(t.shape) != (h,) or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a dense ({h},) tensor")
    for what, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
    if x.dtype not in _ATTN_DTYPES or B.dtype != x.dtype or \
            C.dtype != x.dtype:
        raise TypeError(f"{name}: x, B, C must share one dtype of "
                        f"{_ATTN_DTYPES}, got {x.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    for what, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {what} needs a unit stride over its "
                             "last axis")
    if min(b, s, h, p) < 1 or n < 4 or n % 4:
        raise ValueError(f"{name}: needs non-empty x and n a multiple of 4,"
                         f" got x {tuple(x.shape)}, n={n}")
    if chunk % 8 or not 8 <= chunk <= _SSD_MAX_CHUNK:
        raise ValueError(f"{name}: chunk={chunk} must be a multiple of 8 in "
                         f"[8, {_SSD_MAX_CHUNK}]")


def _check_ssd(x, dt, A, B, C, D, chunk, instance="fma"):
    name = "ssd_scan"
    _check_ssd_operands(name, x, dt, A, B, C, D, chunk)
    b, s, h, p = x.shape
    n = B.shape[2]
    if instance == "wgmma":
        if ssd_instance(x.dtype, p, n, chunk) != "wgmma":
            raise ValueError(f"{name}: the tensor-core instance takes bf16 "
                             f"at chunk 64 or 128 with p and n multiples of "
                             f"16 in [16, 256], got {x.dtype}, p={p}, n={n},"
                             f" chunk={chunk}")
        # the 16-byte copies: aligned bases, strides of 16 bytes
        for what, t in (("x", x), ("B", B), ("C", C)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: {what}'s base is not 16-byte "
                                 "aligned, as the bf16 kernel's copies need")
            if any(size > 1 and st % 8 for size, st in zip(t.shape[:-1],
                                                          t.stride()[:-1])):
                raise ValueError(f"{name}: {what}'s strides {t.stride()} "
                                 "are not multiples of 16 bytes, as the bf16"
                                 " kernel's copies need")
        if b * -(-s // chunk) * h > 2 ** 31 - 1:
            raise ValueError(f"{name}: x {tuple(x.shape)} exceeds the grid")
        return
    if ssd_smem_bytes(chunk, n) > _SMEM_LIMIT:
        raise ValueError(f"{name}: chunk={chunk}, n={n} need "
                         f"{ssd_smem_bytes(chunk, n)} bytes of shared "
                         f"memory, over {_SMEM_LIMIT}")
    if b * h > 2 ** 31 - 1 or -(-p // _SSD_PT) > 65535:
        raise ValueError(f"{name}: x {tuple(x.shape)} exceeds the grid")


def _ssd_launch(x, dt, A, B, C, D, chunk: int, instance: str,
                group=None):
    """One launch of SSD instance ``instance`` on CUDA operands (checked
    here); returns (y, final_state).  ``ssd_scan`` calls it with
    ``ssd_instance``'s choice; the fp32-FMA instance also takes bf16.
    ``group`` overrides ``ssd_head_group`` for the tensor-core one."""
    if instance not in SSD_INSTANCES:
        raise ValueError(f"ssd_scan: unknown instance {instance!r}")
    chunk = int(chunk)
    _check_ssd(x, dt, A, B, C, D, chunk, instance)
    b, s, h, p = x.shape
    n = B.shape[2]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    scratch = (torch.empty(ssd_scratch_floats(b, s, h, p, n, chunk),
                           dtype=torch.float32, device=x.device)
               if instance == "wgmma" else None)
    if x.is_meta:
        cost.record("ssd_scan", *cost.ssd_work(b, s, h, p, n, chunk,
                                               x.element_size()), instance,
                    (x, dt, A, B, C, D))
        return y, final
    lib = _ssd_lib()
    strides = (x.stride(0), x.stride(1), x.stride(2), *dt.stride(),
               B.stride(0), B.stride(1), C.stride(0), C.stride(1),
               _stream(x.device))
    with torch.cuda.device(x.device):
        if instance == "wgmma":
            states = scratch[:b * -(-s // chunk) * h * n * p]
            cum_last = scratch[states.numel():]
            err = lib.ssd_scan_tc(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), y.data_ptr(), final.data_ptr(),
                states.data_ptr(), cum_last.data_ptr(), b, s, h, p, n, chunk,
                int(group or ssd_head_group(b, s, h, chunk)), *strides)
        else:
            err = lib.ssd_scan(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), y.data_ptr(), final.data_ptr(),
                int(x.dtype == torch.bfloat16), b, s, h, p, n, chunk,
                *strides)
    _check_call("ssd_scan", err, lib.ssd_scan_error_string)
    ssd_launches[instance] += 1
    return y, final


def _ssd_forward(x, dt, A, B, C, D, chunk):
    """The scan without a graph: ``ref.ssd_scan`` on the CPU, the kernel
    of ``ssd_instance``'s choice on the card."""
    if not _is_cuda(x, "ssd_scan"):
        return ref.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    p = x.shape[-1] if x.dim() == 4 else 0
    n = B.shape[-1] if isinstance(B, torch.Tensor) and B.dim() == 3 else 0
    instance = ssd_instance(x.dtype, p, n, int(chunk), x, B, C)
    return _ssd_launch(x, dt, A, B, C, D, chunk, instance)


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 64):
    """Mamba-2 SSD chunked scan with the final state: x (b, s, h, p) fp32
    or bf16; dt (b, s, h), A and D (h,) fp32; B and C (b, s, n) in x's
    dtype, shared by the heads.  Any s (a ragged tail is padded with
    dt = 0, an exact fixed point).  Returns (y (b, s, h, p) in x's dtype,
    dense; final_state (b, h, p, n) fp32).

    On the card x, B and C may be strided views with a unit stride over
    their last axis — the model's column slices of one conv output go in
    without a copy; dt may be strided too.  ``ssd_instance`` picks the
    kernel from the operands: bf16 at chunk 64 or 128 with p and n
    multiples of 16 up to 256 and 16-byte-aligned bases and strides of x,
    B and C runs chunk-parallel on the tensor cores; the rest, a
    misaligned bf16 view included, runs the fp32-FMA chunk walk, at a
    chunk that is a multiple of 8 up to 128 and n a multiple of 4 within
    the shared memory of a block.  With grad on and an input that requires
    grad, the call goes through ``SSDScan``: the same forward launch, and
    ``ssd_scan_backward`` (the ``csrc/ssd_backward.cu`` kernel on the
    card, ``ref.ssd_scan_backward`` on the CPU) for the gradient; without
    grad (serving) it is one launch and the outputs have no graph.
    """
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (x, dt, A, B, C, D)):
        return SSDScan.apply(x, dt, A, B, C, D, int(chunk))
    return _ssd_forward(x, dt, A, B, C, D, chunk)


_SSD_BACKWARD_THREADS = 512   # csrc/ssd_backward.cu kGradThreads
_SSD_BACKWARD_TC_CHUNK = 64   # csrc/ssd_backward.cu tc::kQ
_PANEL = 64 * 128             # bytes of one swizzled 64 x 64 bf16 panel


def _ssd_backward_tc_smem(p: int, n: int) -> int:
    """Bytes of the larger block of the tensor-core instance
    (``ssd_backward_tc_smem_bytes`` of ``csrc/ssd_backward.cu``): the chunk
    pass holds the B and C tiles (np panels of 64 x 64 bf16 each), one
    panel of x and one of dy, and four group x 64 fp32 vectors; the
    gradient pass the C and B tiles, x and dy (pp panels each), three
    bf16 terms of a 64 x 64 block of a state and three of S, S^T or M^T,
    two group vectors, five row vectors and four warps' column sums; each
    1,024 bytes of alignment slack."""
    np_, pp = -(-int(n) // 64), -(-int(p) // 64)
    vec = 4 * _SSD_TC_MAX_GROUP * 64
    chunk_pass = 2 * np_ * _PANEL + 2 * _PANEL + 4 * vec + 1024
    grad_pass = ((2 * np_ + 2 * pp + 6) * _PANEL + 2 * vec + 5 * 4 * 64
                 + 32 + 4 * 4 * 64 + 1024)
    return max(chunk_pass, grad_pass)


def ssd_backward_smem_bytes(chunk: int, p: int, n: int,
                            instance: str = "fma") -> int:
    """Shared memory of the larger block kernel of ``ssd_scan_backward``'s
    ``instance``.  ``"fma"`` (``ssd_backward_smem_bytes`` of
    ``csrc/ssd_backward.cu``), fp32: the chunk pass holds B and C (Q x
    (n+4)) and the decayed x dt and exp(cum) dy (Q x (p4+4), p4 = p
    rounded up to 4) and four Q-vectors; the gradient pass holds B, C, g
    or state_in (p4 x (n+4)), S and M (Q x (Q+4)), x dt and dy, eight
    Q-vectors, the tiles' partial sums (Q x (Q/4) twice, Q x (p4/4) twice,
    Q x (n/4)) and two reduction buffers of its 512 threads.  ``"wgmma"``:
    ``_ssd_backward_tc_smem`` (chunk 64; 103,712 bytes at mamba2-370m's p
    64, n 128, so two blocks share an SM)."""
    if instance == "wgmma":
        return _ssd_backward_tc_smem(p, n)
    Q, p4 = int(chunk), -(-int(p) // 4) * 4
    NS, QS, PS = n + 4, Q + 4, p4 + 4
    chunk_pass = 2 * Q * NS + 2 * Q * PS + 4 * Q
    grad_pass = (2 * Q * NS + p4 * NS + 2 * Q * QS + 2 * Q * PS + 8 * Q
                 + 2 * Q * (Q // 4) + 2 * Q * (p4 // 4) + Q * (n // 4)
                 + 2 * _SSD_BACKWARD_THREADS)
    return 4 * max(chunk_pass, grad_pass)


def _ssd_backward_tc_shape(dtype, p: int, n: int, chunk: int) -> bool:
    return (dtype == torch.bfloat16 and chunk == _SSD_BACKWARD_TC_CHUNK
            and p % 16 == 0 and 16 <= p <= 256
            and n % 16 == 0 and 16 <= n <= 256
            and _ssd_backward_tc_smem(p, n) <= _SMEM_LIMIT)


def ssd_backward_instance(dtype: torch.dtype, p: int, n: int, chunk: int,
                          *operands) -> str:
    """The instance of ``ssd_scan_backward`` that a CUDA call runs:
    ``"wgmma"`` (the products on the bf16 tensor cores) for bf16 at chunk
    64 with p and n multiples of 16 in [16, 256], ``"fma"``
    (fp32 FMAs, any dtype) otherwise.  Given the operands (x, B, C, dy), a
    bf16 call whose bases or strides the 16-byte copies cannot take
    (``_copies_aligned``) goes to ``"fma"`` too.  The forward's rule
    (``ssd_instance``) but for chunk 128, which the tensor-core backward
    does not take: its two row blocks' G and G^T do not fit the registers
    beside the products."""
    if _ssd_backward_tc_shape(dtype, p, n, int(chunk)) and _copies_aligned(
            *operands):
        return "wgmma"
    return "fma"


def ssd_backward_occupancy(device_index: int, p: int, n: int) -> int:
    """Resident blocks per SM of the tensor-core instance's gradient pass
    at (p, n) on a card (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    with its shared memory): 2 at mamba2-370m's p 64, n 128 is the
    design."""
    with torch.cuda.device(device_index):
        blocks = _ssd_backward_lib().ssd_backward_tc_occupancy(int(p), int(n))
    if blocks < 0:
        raise RuntimeError(f"ssd_scan_backward: no occupancy for p={p}, "
                           f"n={n}")
    return blocks


def _check_ssd_backward(x, dt, A, B, C, D, dy, dfinal, chunk,
                        instance=None):
    """The forward's operand rules, dy shaped, typed and placed as x with
    a unit stride over p, dfinal None or a dense (b, h, p, n) fp32 tensor,
    and for ``instance`` (default: the one ``ssd_backward_instance`` names
    by dtype and shape alone) its rules: ``"fma"``, the blocks within a
    block's shared memory; ``"wgmma"``, bf16 at chunk 64 with p and n
    multiples of 16 in [16, 256] within shared memory, and 16-byte-aligned
    bases and strides of x, B, C and dy.  Raises ValueError or TypeError
    before any launch."""
    name = "ssd_scan_backward"
    _check_ssd_operands(name, x, dt, A, B, C, D, chunk)
    b, s, h, p = x.shape
    n = B.shape[2]
    if not isinstance(dy, torch.Tensor) or tuple(dy.shape) != tuple(
            x.shape):
        raise ValueError(f"{name}: dy must have x's shape {tuple(x.shape)}")
    if dy.dtype != x.dtype or dy.device != x.device:
        raise TypeError(f"{name}: dy is {dy.dtype} on {dy.device}, x "
                        f"{x.dtype} on {x.device}")
    if dy.stride(-1) != 1:
        raise ValueError(f"{name}: dy needs a unit stride over p")
    if dfinal is not None:
        if not isinstance(dfinal, torch.Tensor) or tuple(
                dfinal.shape) != (b, h, p, n):
            raise ValueError(f"{name}: dfinal must be ({b}, {h}, {p}, {n})")
        if dfinal.dtype != torch.float32 or dfinal.device != x.device:
            raise TypeError(f"{name}: dfinal must be float32 on {x.device}")
        if not dfinal.is_contiguous():
            raise ValueError(f"{name}: dfinal must be contiguous")
    if instance not in (None,) + SSD_BACKWARD_INSTANCES:
        raise ValueError(f"{name}: unknown instance {instance!r}")
    instance = instance or ssd_backward_instance(x.dtype, p, n, chunk)
    if instance == "wgmma":
        if not _ssd_backward_tc_shape(x.dtype, p, n, chunk):
            raise ValueError(
                f"{name}: the tensor-core instance takes bf16 at chunk "
                f"{_SSD_BACKWARD_TC_CHUNK} with p and n multiples of 16 in "
                f"[16, 256] within {_SMEM_LIMIT} bytes of shared memory, got "
                f"{x.dtype}, p={p}, n={n}, chunk={chunk}")
        for what, t in (("x", x), ("B", B), ("C", C), ("dy", dy)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: {what}'s base is not 16-byte "
                                 "aligned, as the bf16 kernel's copies need")
            if any(size > 1 and st % 8 for size, st in zip(t.shape[:-1],
                                                          t.stride()[:-1])):
                raise ValueError(f"{name}: {what}'s strides {t.stride()} "
                                 "are not multiples of 16 bytes, as the bf16"
                                 " kernel's copies need")
    elif ssd_backward_smem_bytes(chunk, p, n) > _SMEM_LIMIT:
        raise ValueError(f"{name}: chunk={chunk}, p={p}, n={n} need "
                         f"{ssd_backward_smem_bytes(chunk, p, n)} bytes of "
                         f"shared memory, over {_SMEM_LIMIT}")
    groups = -(-h // ssd_head_group(b, s, h, chunk))
    if b * -(-s // chunk) * groups > 2 ** 31 - 1:
        raise ValueError(f"{name}: x {tuple(x.shape)} exceeds the grid")


def _ssd_backward_launch(x, dt, A, B, C, D, dy, dfinal, chunk: int,
                         instance: str):
    """One call of ``instance`` on CUDA operands (checked here first:
    nothing is launched on operands it does not take); returns (dx, ddt,
    dA, dB, dC, dD).  ``ssd_scan_backward`` calls it with
    ``ssd_backward_instance``'s choice; the fp32-FMA instance also takes
    bf16."""
    if instance not in SSD_BACKWARD_INSTANCES:
        raise ValueError(f"ssd_scan_backward: unknown instance {instance!r}")
    chunk = int(chunk)
    _check_ssd_backward(x, dt, A, B, C, D, dy, dfinal, chunk, instance)
    b, s, h, p = x.shape
    n = B.shape[2]
    nc = -(-s // chunk)
    group = ssd_head_group(b, s, h, chunk)
    groups = -(-h // group)
    dev, f32 = x.device, torch.float32
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, s, h), dtype=f32, device=dev)
    dA = torch.empty((h,), dtype=f32, device=dev)
    dD = torch.empty((h,), dtype=f32, device=dev)
    dB = torch.empty((b, s, n), dtype=x.dtype, device=dev)
    dC = torch.empty((b, s, n), dtype=x.dtype, device=dev)
    states = torch.empty(b * nc * h * p * n, dtype=f32, device=dev)
    grads = torch.empty_like(states)
    cum_last, partA, partD = (torch.empty(b * nc * h, dtype=f32, device=dev)
                              for _ in range(3))
    partB, partC = (torch.empty(groups * b * nc * chunk * n, dtype=f32,
                                device=dev) for _ in range(2))
    if dev.type == "meta":
        cost.record("ssd_scan_backward", *cost.ssd_backward_work(
            b, s, h, p, n, chunk, x.element_size(), dfinal is not None),
            instance, (x, dt, A, B, C, D, dy, dfinal))
        return dx, ddt, dA, dB, dC, dD
    lib = _ssd_backward_lib()
    ptrs = [t.data_ptr() for t in (x, dt, A, B, C, D, dy)]
    ptrs.append(dfinal.data_ptr() if dfinal is not None else None)
    ptrs += [t.data_ptr() for t in (dx, ddt, dA, dB, dC, dD, states, grads,
                                    cum_last, partB, partC, partA, partD)]
    strides = (*x.stride()[:3], *dy.stride()[:3], *dt.stride(),
               B.stride(0), B.stride(1), C.stride(0), C.stride(1))
    with torch.cuda.device(dev):
        if instance == "wgmma":
            err = lib.ssd_scan_backward_tc(*ptrs, b, s, h, p, n, chunk,
                                           group, *strides, _stream(dev))
        else:
            err = lib.ssd_scan_backward(
                *ptrs, int(x.dtype == torch.bfloat16), b, s, h, p, n, chunk,
                group, *strides, _stream(dev))
    _check_call("ssd_scan_backward", err, lib.ssd_scan_backward_error_string)
    ssd_backward_launches[instance] += 1
    return dx, ddt, dA, dB, dC, dD


def ssd_scan_backward(x, dt, A, B, C, D, dy, dfinal=None, *,
                      chunk: int = 64):
    """dx, ddt, dA, dB, dC, dD of ``(y, final) = ssd_scan(x, dt, A, B, C,
    D, chunk=chunk)`` given dy = dL/dy (b, s, h, p) in x's dtype and
    dfinal = dL/dfinal (b, h, p, n) fp32 or None (zeros).  Operands and
    rules as ``ssd_scan`` (the model's strided slices of one conv output
    go in without a copy; dy needs a unit stride over p).  Returns dx
    (b, s, h, p) and dB, dC (b, s, n) in x's dtype, ddt (b, s, h) and dA,
    dD (h,) fp32, all dense.

    On the card, the instance ``ssd_backward_instance`` names from the
    operands runs four kernels of ``csrc/ssd_backward.cu`` (the chunk
    pass, the state walk both ways, the gradient pass, the reduction),
    ``ssd_head_group`` heads a block:
      * ``"wgmma"`` — bf16 at chunk 64, p and n multiples of 16 in [16,
        256], 16-byte-aligned x, B, C, dy (every mamba2 layer in training):
        the products on the bf16 tensor cores, the fp32 operands in three
        bf16 terms; one warpgroup a block, two blocks an SM (103,712 bytes
        of shared memory at mamba2-370m's p 64, n 128).  Bound by the fp32
        scratch's traffic, then the products.
      * ``"fma"`` — the rest (fp32, misaligned bf16, other chunks within
        ``ssd_backward_smem_bytes``: mamba2-370m's chunk 64 at p = 64,
        n = 128 takes 201,728 bytes): fp32 FMAs on the CUDA cores, which
        bound it.
    Both allocate the same fp32 scratch: two (b, nc, h, p·n) arrays (268
    MB each at mamba2-370m's training shape, b 8 × s 2048), two per-group
    (b, nc·chunk, n) partials and three (b, nc, h) vectors; neither uses
    atomics, so two launches on the same inputs agree bit for bit.  On the
    CPU: ``ref.ssd_scan_backward``."""
    if not _is_cuda(x, "ssd_scan_backward"):
        return ref.ssd_scan_backward(x, dt, A, B, C, D, dy, dfinal,
                                     chunk=chunk)
    p = x.shape[-1] if x.dim() == 4 else 0
    n = B.shape[-1] if isinstance(B, torch.Tensor) and B.dim() == 3 else 0
    instance = ssd_backward_instance(x.dtype, p, n, int(chunk), x, B, C, dy)
    return _ssd_backward_launch(x, dt, A, B, C, D, dy, dfinal, chunk,
                                instance)


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` with its gradient: the forward runs the scan (the
    kernel on the card) and keeps x, dt, A, B, C and D; the backward runs
    ``ssd_scan_backward`` on them, on the card the instance
    ``ssd_backward_instance`` names (mamba2's bf16 layers: ``"wgmma"``,
    the tensor cores; fp32 copies: ``"fma"``), each with the fp32 scratch
    that docstring lists.  ``SSDScan.apply(x, dt, A, B, C, D,
    chunk)`` returns (y, final state); either cotangent may be None (the
    model's loss reads y only), and none gives no gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        y, final = _ssd_forward(x, dt, A, B, C, D, chunk)
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        if dy is None and dfinal is None:
            return (None,) * 7
        x, dt, A, B, C, D = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        elif dy.stride(-1) != 1:
            dy = dy.contiguous()
        if dfinal is not None:
            dfinal = dfinal.contiguous()
        grads = ssd_scan_backward(x, dt, A, B, C, D, dy, dfinal,
                                  chunk=ctx.chunk)
        return (*grads, None)
