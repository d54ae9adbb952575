"""The work of each kernel: the flops and bytes of the function it computes.

One count serves two readers.  ``chip_smoke.py`` divides it by the
card's peaks for each kernel's bound (the least time the card could
take: each input read once, each output written once, the function's
useful operations at the peak of their type), and the kernels' meta
routes (``ops``, on ``torch.device("meta")``) add it to the dry run's
counts (``launch.dryrun``), because ``FlopCounterMode`` never sees a
ctypes launch.

``counts`` accumulates what the meta routes add since ``reset``: by
kernel its flops, bytes, calls and calls by the instance a card would
run.  A meta route also names the operands its kernel reads, and
``read_hook``, where set (``launch.dryrun``), is called with each: a
launch reads its operands through pointers, where no dispatched op
sees it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

# H100 SXM peaks (NVIDIA data sheet, dense, at its 700 W power limit):
# fp32 without the tensor cores, bf16 on the tensor cores, device-memory
# bandwidth, and NVLink's bandwidth each way
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
LINK_BYTES = 450e9
# the card's SMs, and the stream instances' co-resident blocks per SM on
# it (``ops.round_block_occupancy``, ``ops.two_pass_occupancy``: 512
# threads of 128 registers fill an SM's register file)
H100_SMS = 132
STREAM_BLOCKS_PER_SM = 1

counts: Dict[str, Dict[str, float]] = {}
read_hook: list = [None]


def reset() -> None:
    counts.clear()


def record(name: str, flops: float, nbytes: float, instance: str,
           reads=()) -> None:
    """One meta call of kernel ``name`` on ``instance``: its flops and
    bytes, and the operands it reads."""
    if read_hook[0] is not None:
        for t in reads:
            if t is not None:
                read_hook[0](t)
    c = counts.setdefault(name, {"flops": 0.0, "bytes": 0.0, "calls": 0,
                                 "instances": {}})
    c["flops"] += flops
    c["bytes"] += nbytes
    c["calls"] += 1
    c["instances"][instance] = c["instances"].get(instance, 0) + 1


def totals() -> Tuple[float, float]:
    """(flops, bytes) of every kernel recorded since ``reset``."""
    return (sum(c["flops"] for c in counts.values()),
            sum(c["bytes"] for c in counts.values()))


def attention_pairs(S: int, window: Optional[int] = None) -> int:
    """(query, key) pairs a causal attention over S tokens computes: key j
    for query i when 0 <= i - j < window (every j <= i without one)."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_work(B, H, KV, S, D, itemsize, window=None, Sk=None,
                   causal=True):
    """``flash_attention``: 4·D flops a (query, key) pair a head inside the
    mask; q, k, v read and o written once.  With ``causal=False`` every
    query sees all Sk keys (Sk defaults to S)."""
    Sk = S if Sk is None else Sk
    pairs = attention_pairs(S, window) if causal else S * Sk
    flops = 4 * B * H * D * pairs
    nbytes = (2 * B * H * S + 2 * B * KV * Sk) * D * itemsize
    return flops, nbytes


def attention_backward_work(B, H, KV, S, Sk, D, causal, window,
                            itemsize=2):
    """``flash_attention_backward``: 10·D flops a visible (query, key) pair
    a head (s, dP, dV, dK, dQ: two each); q, k, v, o, do read and dq, dk,
    dv written once.  Returns (flops, bytes, pairs)."""
    pairs = attention_pairs(S, window) if causal else S * Sk
    nbytes = (4 * B * H * S + 4 * B * KV * Sk) * D * itemsize
    return 10 * B * H * pairs * D, nbytes, pairs


def ssd_work(b, s, h, p, n, chunk, itemsize):
    """``ssd_scan``: 2·b·h·s·(Q·n + Q·p + 2·p·n) flops (C B^T and its
    product with x·dt over full Q x Q tiles, the carry-in and the state
    update); x read and y written (itemsize), B and C read (itemsize), dt
    read and the final state written (fp32), A and D read (fp32)."""
    flops = 2 * b * h * s * (chunk * n + chunk * p + 2 * p * n)
    nbytes = ((2 * b * s * h * p + 2 * b * s * n) * itemsize
              + b * s * h * 4 + 2 * h * 4 + b * h * p * n * 4)
    return flops, nbytes


def ssd_backward_work(b, s, h, p, n, chunk, itemsize, dfinal=True):
    """``ssd_scan_backward``.  Flops: two a multiply-add of the closed
    form, per (b, head) and chunk of v valid rows with t = v(v+1)/2 pairs
    j <= i: six v·p·n products (the chunk's local state and dy (x) C sum
    for the state walk, g B, state_in^T dy, g^T xdt and the carry-in's
    C . (state_in^T dy) share folded into them) and four t-pair products
    (M^T dy, dy . xdt, S B, S C: two over p, two over n), and per (b,
    chunk) G = C B^T over its t pairs.  Bytes: x, dy, dx (itemsize), B,
    C, dB, dC (itemsize), dt, ddt (fp32), A, D, dA, dD (fp32) and dfinal
    (fp32) once each; the fp32 state scratch is the kernel's choice, not
    the function's."""
    full, tail = divmod(s, chunk)
    rows = [chunk] * full + ([tail] if tail else [])
    pairs = sum(v * (v + 1) // 2 for v in rows)
    flops = 2 * b * (h * (6 * s * p * n + 2 * pairs * p + 2 * pairs * n)
                     + pairs * n)
    nbytes = ((3 * b * s * h * p + 4 * b * s * n) * itemsize
              + 2 * b * s * h * 4 + 4 * h * 4
              + (b * h * p * n * 4 if dfinal else 0))
    return flops, nbytes


def two_pass_work(m, n, p, itemsize):
    """One two-pass update (``csvm_block_update``, ``csvm_local_update``):
    4 flops an element of X (the margin dot and X^T w); X read once
    (itemsize), y, B, P, the neighbour term, rho, omega and lam read and
    B+ written once (fp32)."""
    f = 4
    nbytes = (m * n * p * itemsize + m * n * f + 3 * m * p * f + 2 * m * f
              + p * f + m * p * f)
    return 4 * m * n * p, nbytes


def round_block_work(m, n, p, itemsize, num_rounds, want_kkt):
    """One ``csvm_round_block`` launch of ``num_rounds`` rounds: 4 flops an
    element of X a round for the margins and X^T w, and once more at
    beta_bar for the KKT epilogue (the W@B sums, 2 m^2 p a round, left
    out); its operands and outputs read and written once
    (``ops.round_block_bytes`` without the scratch)."""
    from repro_torch.kernels import ops
    nbytes = (ops.round_block_bytes(m, n, p, itemsize, num_rounds)
              - 4 * ops.round_block_scratch_floats(m, n, p, num_rounds))
    passes = num_rounds + (1 if want_kkt else 0)
    return 4 * m * n * p * passes, nbytes
