"""Wrappers of the CUDA kernels: checks, launch counters, residency rule.

For tensors on the CPU each wrapper computes its kernel's plain torch
version (``csvm_update.*_plain``, ``ref.mha``, ``ref.ssd_scan``); for
CUDA tensors it launches the CUDA kernel of ``csrc/csvm_update.cu``,
``csrc/flash_attention.cu`` or ``csrc/ssd_scan.cu`` on
``torch.cuda.current_stream()`` or raises — there is no fallback from one
to the other.  Operands must be on one device with the documented shapes
and dtypes: the CSVM kernels take contiguous fp32 (X may be bf16 where
stated), ``flash_attention`` fp32 or bf16 views with a unit stride over
D, ``ssd_scan`` fp32 or bf16 x/B/C views with a unit stride over their
last axis; anything else raises before launch.

``launches[name]`` counts the kernel launches of each wrapper (one per
call that reached the kernel, none for the plain version), so a run can
show that its path went through the kernels; ``flash_launches`` and
``round_block_launches`` split ``launches["flash_attention"]`` and
``launches["csvm_round_block"]`` by the instance that ran
(``flash_instance``, ``round_block_instance``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.core.losses import KERNEL_IDS
from repro_torch.kernels import build, ref
from repro_torch.kernels.csvm_update import (csvm_block_update_plain,
                                             csvm_local_update_plain,
                                             csvm_round_block_plain)

KERNELS = ("csvm_local_update", "csvm_block_update", "csvm_round_block",
           "flash_attention", "ssd_scan")
launches: Dict[str, int] = {name: 0 for name in KERNELS}
# flash_attention's two instances: bf16 tensor cores (wgmma, TMA) and fp32
# FMAs on the CUDA cores
FLASH_INSTANCES = ("wgmma", "fma")
flash_launches: Dict[str, int] = {name: 0 for name in FLASH_INSTANCES}
# csvm_round_block's two instances: X streamed through shared memory once a
# round (TMA bulk copies) and X read twice a round with plain loads
ROUND_INSTANCES = ("stream", "direct")
round_block_launches: Dict[str, int] = {name: 0 for name in ROUND_INSTANCES}

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
}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0
    for name in FLASH_INSTANCES:
        flash_launches[name] = 0
    for name in ROUND_INSTANCES:
        round_block_launches[name] = 0


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
    lib.flash_attention.argtypes = [_P] * 4 + [_I] * 6 + [_LL] * 12 + [
        _F, _I, _I, _P]
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_attention_tc.argtypes = [_P] * 4 + [_I] * 5 + [_LL] * 12 + [
        _F, _I, _I, _P]
    lib.flash_attention_tc.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _ssd_lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    lib.ssd_scan.argtypes = [_P] * 8 + [_I] * 7 + [_LL] * 10 + [_P]
    lib.ssd_scan.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check_call(name: str, err: int, error_string=None) -> None:
    if err != 0:
        error_string = error_string or _lib().csvm_error_string
        msg = error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    launches[name] += 1


def _is_cuda(X: torch.Tensor, name: str) -> bool:
    if X.device.type == "cpu":
        return False
    if X.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {X.device} are not supported")
    return True


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


def csvm_block_update(X, y, B, P, neigh, rho, omega, lam_vec, *, h,
                      kernel="epanechnikov"):
    """Fused (7a') primal update for a stacked (m, n, p) node block; X fp32
    or bf16, everything else fp32; the neighbour term is an operand.
    Returns B_new (m, p) fp32."""
    if not _is_cuda(X, "csvm_block_update"):
        return csvm_block_update_plain(X, y, B, P, neigh, rho, omega,
                                       lam_vec, h=h, kernel=kernel)
    _check_two_pass("csvm_block_update", X, y, B, P, neigh, rho, omega,
                    lam_vec, _X_DTYPES)
    m, n, p = X.shape
    w = torch.empty((m, n), dtype=torch.float32, device=X.device)
    out = torch.empty((m, p), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        err = _lib().csvm_block_update(
            X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(),
            B.data_ptr(), P.data_ptr(), neigh.data_ptr(), rho.data_ptr(),
            omega.data_ptr(), lam_vec.data_ptr(), w.data_ptr(),
            out.data_ptr(), m, n, p, float(h), _kernel_id(kernel), 1.0 / n,
            _stream(X.device))
    _check_call("csvm_block_update", err)
    return out


def csvm_local_update(X, y, beta, p_dual, neigh, rho, omega, lam, *, h,
                      kernel="epanechnikov"):
    """Fused deCSVM local update (the "pallas" backend).  One node (X
    (n, p), (p,) vectors, scalar rho/omega) or a node stack (X (m, n, p),
    (m, p) rows, (m,) rho/omega); lam a scalar or a (p,) vector.  On the
    card X must be fp32 (the Pallas wrapper casts it to fp32 too) and the
    rows fp32."""
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
    lam_vec = lam_vec.contiguous()
    _check_two_pass("csvm_local_update", X, y, beta, p_dual, neigh, rho,
                    omega, lam_vec, _F32)
    m, n, p = X.shape
    w = torch.empty((m, n), dtype=torch.float32, device=X.device)
    out = torch.empty((m, p), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        err = _lib().csvm_local_update(
            X.data_ptr(), y.data_ptr(), beta.data_ptr(), p_dual.data_ptr(),
            neigh.data_ptr(), rho.data_ptr(), omega.data_ptr(),
            lam_vec.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, p,
            float(h), _kernel_id(kernel), 1.0 / n, _stream(X.device))
    _check_call("csvm_local_update", err)
    return out


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
    nseg = round_stream_plan(m, n, grid)[2][-1]
    return m * p + p + num_rounds + 2 + nseg * p


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
            grid = round_block_grid(X.device, m, n, p, X.dtype)
    bufs = _round_block_buffers(X, y, B, P, W, deg, rho, omega, lam_vec,
                                nact, num_rounds, instance, grid or 1)
    Bout, Pout, stat, scratch = bufs[:4]
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
# Flash attention
# --------------------------------------------------------------------------

_ATTN_DTYPES = (torch.float32, torch.bfloat16)
_TC_HEAD_DIMS = (64, 128)   # csrc/flash_attention.cu flash_attention_tc


def flash_instance(dtype: torch.dtype, head_dim: int) -> str:
    """The instance of the flash kernel that a CUDA call runs, by dtype and
    head dim alone: ``"wgmma"`` (bf16 tensor cores, TMA) for bf16 at
    D = 64 or 128, ``"fma"`` (fp32 FMAs on the CUDA cores) otherwise."""
    if dtype == torch.bfloat16 and head_dim in _TC_HEAD_DIMS:
        return "wgmma"
    return "fma"


def _check_attention(q, k, v, window):
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
    KV = k.shape[1]
    if tuple(k.shape) != (B, KV, S, D) or tuple(v.shape) != (B, KV, S, D):
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, KV, S, D) for q "
                         f"{tuple(q.shape)}")
    if min(B, H, S, KV) < 1 or H % KV or not 1 <= D <= 256:
        raise ValueError(f"{name}: needs H % KV == 0 and D <= 256, got "
                         f"q {tuple(q.shape)}, KV={KV}")
    if (S + 63) // 64 > 65535:
        raise ValueError(f"{name}: S={S} exceeds the grid's 65535 q tiles")
    if window is not None and int(window) < 1:
        raise ValueError(f"{name}: window={window} would mask every key")
    if flash_instance(q.dtype, D) == "wgmma":
        # the tensor maps: 16-byte-aligned bases, strides of 16 bytes
        for what, t in (("q", q), ("k", k), ("v", v)):
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


def _flash_launch(q, k, v, instance, *, causal, window, sm_scale):
    """One launch of ``instance`` on checked operands; returns the output.
    ``flash_attention`` calls it with ``flash_instance``'s choice."""
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    scale = float(sm_scale) if sm_scale is not None else D ** -0.5
    lib = _flash_lib()
    shape = (B, H, k.shape[1], S, D)
    tail = (*out.stride()[:3], scale, int(bool(causal)),
            int(window) if window is not None else 0, _stream(q.device))
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
                    sm_scale=None):
    """Grouped-query attention with an online softmax: q (B, H, S, D),
    k and v (B, KV, S, D), fp32 or bf16, H % KV == 0, D <= 256; causal
    and sliding-window (``window``) masks; ``sm_scale`` defaults to
    D ** -0.5.  Returns (B, H, S, D) in q's dtype.

    On the card the inputs may be strided views (unit stride over D), so
    the model's (B, S, H, D) projections go in as ``.transpose(1, 2)``
    without a copy; the output takes q's strides when q is dense (a
    transposed (B, S, H, D) buffer), so it transposes back for free.
    ``flash_instance`` picks the kernel: bf16 at D = 64 or 128 runs on the
    tensor cores and needs 16-byte-aligned bases and strides of 16 bytes
    (it raises otherwise); the rest runs the fp32-FMA kernel.
    """
    if not _is_cuda(q, "flash_attention"):
        return ref.mha(q, k, v, causal=causal, window=window,
                       sm_scale=sm_scale)
    _check_attention(q, k, v, window)
    return _flash_launch(q, k, v, flash_instance(q.dtype, q.shape[-1]),
                         causal=causal, window=window, sm_scale=sm_scale)


# --------------------------------------------------------------------------
# SSD scan (Mamba-2)
# --------------------------------------------------------------------------

_SSD_PT = 16           # columns of p per block (csrc/ssd_scan.cu kPT)
_SSD_MAX_CHUNK = 128


def ssd_smem_bytes(chunk: int, n: int) -> int:
    """Shared memory of one ``ssd_scan`` block (``smem_floats`` of
    ``csrc/ssd_scan.cu``): cum, dt and two decays (Q each), x and x*dt
    (Q x 16), B^T and C^T (n x (Q+8)), the decayed B (Q x (n+4)), the
    masked scores (Q x (Q+8)) and the state slice (n x 16), fp32."""
    Q = chunk
    return 4 * (4 * Q + 2 * Q * _SSD_PT + 2 * n * (Q + 8) + Q * (n + 4)
                + Q * (Q + 8) + n * _SSD_PT)


def _check_ssd(x, dt, A, B, C, D, chunk):
    name = "ssd_scan"
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
    if ssd_smem_bytes(chunk, n) > _SMEM_LIMIT:
        raise ValueError(f"{name}: chunk={chunk}, n={n} need "
                         f"{ssd_smem_bytes(chunk, n)} bytes of shared "
                         f"memory, over {_SMEM_LIMIT}")
    if b * h > 2 ** 31 - 1 or -(-p // _SSD_PT) > 65535:
        raise ValueError(f"{name}: x {tuple(x.shape)} exceeds the grid")


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 64):
    """Mamba-2 SSD chunked scan with the final state: x (b, s, h, p) fp32
    or bf16; dt (b, s, h), A and D (h,) fp32; B and C (b, s, n) in x's
    dtype, shared by the heads.  Any s (a ragged tail is padded with
    dt = 0, an exact fixed point).  Returns (y (b, s, h, p) in x's dtype,
    dense; final_state (b, h, p, n) fp32).

    On the card x, B and C may be strided views with a unit stride over
    their last axis — the model's column slices of one conv output go in
    without a copy; dt may be strided too.  The chunk is a multiple of 8
    up to 128 and n a multiple of 4 within the shared memory of a block.
    """
    if not _is_cuda(x, "ssd_scan"):
        return ref.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    chunk = int(chunk)
    _check_ssd(x, dt, A, B, C, D, chunk)
    b, s, h, p = x.shape
    n = B.shape[2]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = _ssd_lib()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), final.data_ptr(),
            int(x.dtype == torch.bfloat16), b, s, h, p, n, chunk,
            x.stride(0), x.stride(1), x.stride(2), *dt.stride(),
            B.stride(0), B.stride(1), C.stride(0), C.stride(1),
            _stream(x.device))
    _check_call("ssd_scan", err, lib.ssd_scan_error_string)
    return y, final
