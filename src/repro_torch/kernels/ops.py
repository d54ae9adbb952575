"""Wrappers of the CSVM kernels: checks, launch counters, residency rule.

For tensors on the CPU each wrapper computes its kernel's plain torch
version (``csvm_update.*_plain``); for CUDA tensors it launches the CUDA
kernel of ``csrc/csvm_update.cu`` on ``torch.cuda.current_stream()`` or
raises — there is no fallback from one to the other.  Operands must be
contiguous, on one device, fp32 (X may be bf16 where stated), with the
documented shapes; anything else raises before launch.

``launches[name]`` counts the kernel launches of each wrapper (one per
call that reached the kernel, none for the plain version), so a run can
show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.core.losses import KERNEL_IDS
from repro_torch.kernels import build
from repro_torch.kernels.csvm_update import (csvm_block_update_plain,
                                             csvm_local_update_plain,
                                             csvm_round_block_plain)

KERNELS = ("csvm_local_update", "csvm_block_update", "csvm_round_block")
launches: Dict[str, int] = {name: 0 for name in KERNELS}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "csvm_block_update": [_P, _I] + [_P] * 9 + [_I, _I, _I, _F, _I, _F, _P],
    "csvm_local_update": [_P] * 10 + [_I, _I, _I, _F, _I, _F, _P],
    "csvm_round_block": ([_P, _I] + [_P] * 13 + [_I] * 5
                         + [_F, _F, _F, _I, _F, _F, _F, _P]),
    "csvm_round_block_occupancy": [_I, ctypes.POINTER(_I),
                                   ctypes.POINTER(_I)],
}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


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


def _check_call(name: str, err: int) -> None:
    if err != 0:
        msg = _lib().csvm_error_string(err).decode()
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

def round_block_scratch_floats(m: int, n: int, p: int,
                               num_rounds: int) -> int:
    """fp32 scratch of one round-kernel launch: the margin weights w
    (m, n), the second B buffer (m, p), beta_bar (p,) and one reduction
    slot per round plus the KKT stationarity and consensus slots."""
    return m * n + m * p + p + num_rounds + 2


def round_block_bytes(m: int, n: int, p: int, itemsize: int = 4,
                      num_rounds: int = 1) -> int:
    """Device bytes one ``csvm_round_block`` launch touches: its operands
    (X in the compute dtype; y, B, P, W, deg, rho, omega, lam in fp32;
    the int32 active-round count), its outputs (B, P and the statistic)
    and its scratch.  Pinned to the wrapper's real buffers by
    ``tests/test_torch_kernels.py``."""
    f = 4
    operands = (m * n * p * itemsize + m * n * f + 2 * m * p * f
                + m * m * f + 3 * m * f + p * f + 4)
    outputs = 2 * m * p * f + f
    scratch = round_block_scratch_floats(m, n, p, num_rounds) * f
    return operands + outputs + scratch


@functools.lru_cache(maxsize=None)
def round_block_occupancy(device_index: int, bf16: bool):
    """(co-resident round-kernel blocks per SM, SM count) on a card; the
    blocks per SM are 0 where the card has no cooperative launch."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().csvm_round_block_occupancy(
            int(bf16), ctypes.byref(per_sm), ctypes.byref(sms))
    if err != 0:
        msg = _lib().csvm_error_string(err).decode()
        raise RuntimeError(f"csvm_round_block_occupancy: CUDA error {err} "
                           f"({msg})")
    return per_sm.value, sms.value


def megakernel_supported(m: int, n: int, p: int, dtype=None, device=None,
                         num_rounds: int = 1) -> bool:
    """True when the round kernel can take the (m, n, p) problem on
    ``device``; drivers take the loop of single rounds otherwise.

    On the CPU the plain version takes any size.  On a card, decided from
    shapes before launch: every byte the launch touches
    (``round_block_bytes``: X plus the other operands, outputs and
    scratch) must fit the device's memory, and the cooperative grid must
    be co-resident (at least one round-kernel block per SM).
    """
    device = torch.device("cpu" if device is None else device)
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"megakernel_supported: device {device}")
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    bf16 = dtype == torch.bfloat16
    need = round_block_bytes(m, n, p, 2 if bf16 else 4, num_rounds)
    if need > torch.cuda.get_device_properties(index).total_memory:
        return False
    return round_block_occupancy(index, bf16)[0] >= 1


def _round_block_buffers(X, y, B, P, W, deg, rho, omega, lam_vec, nact,
                         num_rounds: int):
    """Check the round kernel's operands and allocate its outputs and
    scratch on X's device: (Bout, Pout, stat, scratch)."""
    name = "csvm_round_block"
    if X.dim() != 3 or min(X.shape) < 1:
        raise ValueError(f"{name}: X must be a non-empty (m, n, p) tensor, "
                         f"got shape {tuple(X.shape)}")
    if num_rounds < 1:
        raise ValueError(f"{name}: num_rounds={num_rounds} must be >= 1")
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
    return (torch.empty((m, p), dtype=f32, device=dev),
            torch.empty((m, p), dtype=f32, device=dev),
            torch.empty((), dtype=f32, device=dev),
            torch.empty(round_block_scratch_floats(m, n, p, num_rounds),
                        dtype=f32, device=dev))


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
    residual (``want_kkt``) or the last active round's max|dB|.
    """
    if not _is_cuda(X, "csvm_round_block"):
        return csvm_round_block_plain(
            X, y, B, P, W, deg, rho, omega, lam_vec, nact, tau=tau,
            lam0=lam0, h=h, kernel=kernel, num_rounds=num_rounds,
            want_kkt=want_kkt)
    Bout, Pout, stat, scratch = _round_block_buffers(
        X, y, B, P, W, deg, rho, omega, lam_vec, nact, num_rounds)
    m, n, p = X.shape
    with torch.cuda.device(X.device):
        err = _lib().csvm_round_block(
            X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(),
            B.data_ptr(), P.data_ptr(), W.data_ptr(), deg.data_ptr(),
            rho.data_ptr(), omega.data_ptr(), lam_vec.data_ptr(),
            nact.data_ptr(), Bout.data_ptr(), Pout.data_ptr(),
            stat.data_ptr(), scratch.data_ptr(), m, n, p, int(num_rounds),
            int(bool(want_kkt)), float(tau), float(lam0), float(h),
            _kernel_id(kernel), 1.0 / n, 1.0 / m, (1.0 / n) / m,
            _stream(X.device))
    _check_call("csvm_round_block", err)
    return Bout, Pout, stat
