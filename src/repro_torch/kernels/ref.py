"""Plain-torch oracles for the CSVM kernels of this package.

Counterpart of ``repro.kernels.ref``: each oracle is the exact math every
driver runs (``core.solver``), in fp32, independent of the kernels and of
their plain versions in ``csvm_update.py`` (which repeat the kernels'
bf16 rounding points).  ``mha`` is the oracle of ``flash_attention`` and
its plain version: ``ops.flash_attention`` runs it for CPU tensors, as
``ops.flash_attention_backward`` runs ``mha_backward``;
``ssd_scan`` is the plain version of the ``ssd_scan`` kernel, which
``ops.ssd_scan`` runs for CPU tensors, as ``ops.ssd_scan_backward`` runs
``ssd_scan_backward``.
"""
from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F

from repro_torch.core import solver

Tensor = torch.Tensor


def decsvm_local_update(X: Tensor, y: Tensor, beta: Tensor, p_dual: Tensor,
                        neigh: Tensor, rho, omega, lam,
                        h: float, kernel: str = "epanechnikov") -> Tensor:
    """Oracle for the fused ADMM local update (paper eq. 7a'): the unified
    Algorithm-1 update of ``repro_torch.core.solver``, verbatim.

    X: (n, p), y: (n,), beta/p_dual/neigh: (p,); rho/omega scalars; lam a
    scalar or (p,) per-coordinate penalty vector.  Returns beta_new (p,).
    """
    return solver.local_update(X, y, beta, p_dual, neigh, rho, omega, lam,
                               h=h, kernel=kernel)


def decsvm_round_block(X: Tensor, y: Tensor, B: Tensor, P: Tensor,
                       W: Tensor, deg: Tensor, rho: Tensor, omega: Tensor,
                       lam_vec, nact: int, *, tau: float, lam0: float,
                       h: float, kernel: str = "epanechnikov",
                       want_kkt: bool = False):
    """Oracle for the round kernel: ``nact`` dense Algorithm-1 rounds (each
    one exactly ``solver.local_update`` + the dense W@B neighbour sums)
    followed by the stop statistic the kernel emits — the KKT residual of
    ``solver.kkt_residual`` when ``want_kkt``, else the last round's
    max|dB| (+inf after no round).  Returns (B, P, stat), all fp32.
    """
    X = X.to(torch.float32)
    y = y.to(torch.float32)
    B, P = B.to(torch.float32), P.to(torch.float32)
    delta = torch.tensor(math.inf, dtype=torch.float32, device=B.device)
    for _ in range(int(nact)):
        neigh = tau * (deg[:, None] * B + W @ B)
        B_new = solver.local_update(X, y, B, P, neigh, rho, omega, lam_vec,
                                    h=h, kernel=kernel)
        P = P + tau * (deg[:, None] * B_new - W @ B_new)
        delta = torch.max(torch.abs(B_new - B))
        B = B_new
    if want_kkt:
        cfg = types.SimpleNamespace(kernel=kernel, h=h, lam0=lam0)
        prob = solver.Problem(X, y, deg, rho, omega, None)
        lam_arr = torch.as_tensor(lam_vec, dtype=torch.float32,
                                  device=B.device).reshape(-1)
        if lam_arr.shape[0] == 1:
            stat = solver.kkt_residual(prob, cfg, B, float(lam_arr[0]))
        else:
            stat = solver.kkt_residual(prob, cfg, B, 1.0, lam_arr)
        return B, P, stat
    return B, P, delta


NEG_INF = -1e30


def check_key_length(S: int, Sk: int, causal: bool, window) -> None:
    """Keys of their own length (Sk != S) have no positions that a causal
    or window mask could compare with the queries': such a call raises
    ValueError."""
    if Sk != S and (causal or window is not None):
        raise ValueError(f"flash_attention: keys of their own length (Sk = "
                         f"{Sk}, S = {S}) take neither a causal mask nor a "
                         f"window (causal={causal}, window={window})")


def mha(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
        window: int | None = None, sm_scale: float | None = None) -> Tensor:
    """Grouped-query attention oracle (port of ``repro.kernels.ref.mha``).

    q: (B, H, S, D); k, v: (B, KV, Sk, D) with H % KV == 0; query head h
    reads kv head h // (H // KV).  window: sliding-window width (attend to
    [i-window+1, i]); None = full.  Sk != S (cross-attention; the JAX
    oracle takes one S) only with ``causal=False`` and no window, else
    ValueError.  Logits, softmax and the product with v are fp32; the
    output is rounded once to q's dtype.

    Two choices follow the Pallas kernel rather than the JAX oracle, so that
    the kernel and this plain version round alike: the scale is the Python
    float ``D ** -0.5`` (the JAX oracle takes 1/sqrt(D) in q's dtype, a
    bf16-rounded scale for bf16 q), and masked logits are -1e30, not -inf
    (the same softmax wherever a row sees at least one key, as every row
    does under a causal mask or a window >= 1).
    """
    B, H, S, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    check_key_length(S, Sk, causal, window)
    g = H // KV
    scale = float(sm_scale) if sm_scale is not None else D ** -0.5
    f32 = torch.float32
    kr = k.to(f32).repeat_interleave(g, dim=1)
    vr = v.to(f32).repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), kr) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vr)
    return out.to(q.dtype)


def mha_backward(q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor, *,
                 causal: bool = True, window: int | None = None,
                 sm_scale: float | None = None, delta: Tensor | None = None):
    """dq, dk, dv of ``mha`` given its output o and do = dL/do: the closed
    form the ``flash_attention_backward`` kernel computes, in fp32, each
    result rounded once to its input's dtype.  P is recomputed as ``mha``
    computes it (the same scale and -1e30 mask), delta = rowsum(do * o),

        dv = P^T do,  dS = P * (do v^T - delta),
        dq = scale dS k,  dk = scale dS^T q,

    dk and dv summed over the g = H / KV query heads of each kv head.
    Shapes and rules as ``mha``: q, o, do (B, H, S, D); k, v (B, KV, Sk,
    D).  ``delta`` (B, H, S), where given, stands for rowsum(do * o)."""
    B, H, S, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    check_key_length(S, Sk, causal, window)
    g = H // KV
    scale = float(sm_scale) if sm_scale is not None else D ** -0.5
    f32 = torch.float32
    qf, dof = q.to(f32), do.to(f32)
    kr = k.to(f32).repeat_interleave(g, dim=1)
    vr = v.to(f32).repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    del logits
    if delta is None:
        delta = torch.sum(dof * o.to(f32), dim=-1)
    delta = delta.to(f32)[..., None]
    dv = torch.einsum("bhqk,bhqd->bhkd", probs, dof)
    ds = probs * (torch.einsum("bhqd,bhkd->bhqk", dof, vr) - delta)
    del probs
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale

    def group_sum(t):
        return t.reshape(B, KV, g, Sk, D).sum(dim=2)
    return dq.to(q.dtype), group_sum(dk).to(k.dtype), group_sum(dv).to(
        v.dtype)


def _sequential_cumsum(a: Tensor, dim: int) -> Tensor:
    """Inclusive prefix sum along ``dim``, one fp32 addition at a time in
    index order — the order of the ``ssd_scan`` kernel, so that both
    round the cumulative decays alike (``torch.cumsum`` may sum in
    another order on the card)."""
    out = a.clone()
    for i in range(1, a.shape[dim]):
        out.select(dim, i).add_(out.select(dim, i - 1))
    return out


def ssd_scan(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
             D: Tensor, *, chunk: int = 64):
    """Plain version of the ``ssd_scan`` kernel: the Mamba-2 SSD chunked
    scan of ``repro.kernels.ssd_scan._ssd_kernel``, plus the final state.

    x: (b, s, h, p); dt: (b, s, h) fp32 (softplus'd, > 0); A, D: (h,) fp32
    (A < 0); B, C: (b, s, n), shared by the heads.  Any s: a ragged tail
    is padded to a whole chunk with dt = 0, an exact fixed point (the
    decay is exp(0) = 1 and x*dt = 0, so the state does not move), and
    the padded rows of y are dropped.  For each chunk, with
    cum = cumsum(dt*A) (summed in index order, as the kernel sums):

        y     = ((C B^T) * exp(cum_i - cum_j) [j <= i]) @ (x*dt)
                + exp(cum) * (C @ state^T) + D * x
        state = state * exp(cum[-1]) + (x*dt)^T @ (B * exp(cum[-1] - cum))

    Every decay is formed from a difference of cumulative sums, never as a
    ratio of exp(cum) (which underflows to 0 over a chunk when A*dt is
    large).  All arithmetic is fp32; y is rounded once to x's dtype.
    Returns (y (b, s, h, p), final_state (b, h, p, n) fp32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    Q = int(chunk)
    nc = -(-s // Q)
    pad = nc * Q - s
    xf, dtf = x.to(f32), dt.to(f32)
    Bf, Cf = B.to(f32), C.to(f32)
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    xc = xf.reshape(b, nc, Q, h, p)
    dtc = dtf.reshape(b, nc, Q, h)
    Bc, Cc = Bf.reshape(b, nc, Q, n), Cf.reshape(b, nc, Q, n)
    cum = _sequential_cumsum(dtc * A.to(f32), dim=2)        # (b, nc, Q, h)
    xdt = xc * dtc[..., None]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b, nc, i, j, h)
    L = torch.where(tri[:, :, None], torch.exp(diff), 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None] * L
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xdt)
    decay_in = torch.exp(cum[:, :, -1:, :] - cum)           # (b, nc, Q, h)
    inputs = torch.einsum("bcjn,bcjhp->bchpn", Bc,
                          xdt * decay_in[..., None])
    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    carry = []
    for c in range(nc):
        carry.append(torch.einsum("bin,bhpn->bihp", Cc[:, c], state)
                     * torch.exp(cum[:, c])[..., None])
        state = (state * torch.exp(cum[:, c, -1])[..., None, None]
                 + inputs[:, c])
    y = y + torch.stack(carry, dim=1) + D.to(f32)[:, None] * xc
    return y.reshape(b, nc * Q, h, p)[:, :s].to(x.dtype), state


def ssd_scan_backward(x: Tensor, dt: Tensor, A: Tensor, B: Tensor,
                      C: Tensor, D: Tensor, dy: Tensor,
                      dfinal: Tensor | None = None, *, chunk: int = 64):
    """Plain version of the ``ssd_scan_backward`` kernel: the VJP of
    ``ssd_scan`` (y and the final state) given dy = dL/dy (b, s, h, p) in
    x's dtype and dfinal = dL/d(final state) (b, h, p, n) fp32, or None
    for zeros.  Shapes, padding of a ragged tail (dt = 0) and the index
    order of cum as ``ssd_scan``.  Per chunk, with L_ij = exp(cum_i -
    cum_j) [j <= i], G = C B^T, M = G * L, xdt = x dt, state_in[c] the
    forward's carried state and g[c] the gradient of the state leaving
    chunk c (g[nc-1] = dfinal, g[c-1] = exp(last_c) g[c] + sum_i
    exp(cum_i) dy_i (x) C_i):

        dxdt_j = sum_{i>=j} M_ij dy_i + exp(last - cum_j) g B_j
        dx     = D dy + dt dxdt,           dD = sum dy . x
        S_ij   = (dy_i . xdt_j) L_ij
        dC_i   = sum_h [sum_j S_ij B_j + exp(cum_i) state_in^T dy_i]
        dB_j   = sum_h [sum_i S_ij C_i + exp(last - cum_j) g^T xdt_j]
        dcum_t = sum_j R_tj - sum_i R_it + exp(cum_t) dy_t . (state_in C_t)
                 - u_t   (R = S * G, u_j = xdt_j . exp(last - cum_j) g B_j),
                 and the chunk's last row also exp(last) <g, state_in>
                 + sum_j u_j
        da     = reverse cumsum of dcum in the chunk
        ddt    = x . dxdt + A da,          dA = sum dt da

    Every decay is an exp of a difference of cumulative sums, never a
    ratio.  All arithmetic is fp32; dx, dB and dC are rounded once to
    their inputs' dtype, ddt, dA and dD are fp32.  Returns (dx, ddt, dA,
    dB, dC, dD)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    Q = int(chunk)
    nc = -(-s // Q)
    pad = nc * Q - s
    xf, dtf, dyf = x.to(f32), dt.to(f32), dy.to(f32)
    Bf, Cf = B.to(f32), C.to(f32)
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dyf = F.pad(dyf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    xc = xf.reshape(b, nc, Q, h, p)
    dyc = dyf.reshape(b, nc, Q, h, p)
    dtc = dtf.reshape(b, nc, Q, h)
    Bc, Cc = Bf.reshape(b, nc, Q, n), Cf.reshape(b, nc, Q, n)
    Af = A.to(f32)
    cum = _sequential_cumsum(dtc * Af, dim=2)               # (b, nc, Q, h)
    last = cum[:, :, -1]                                    # (b, nc, h)
    ecum = torch.exp(cum)
    decay_in = torch.exp(last[:, :, None] - cum)            # (b, nc, Q, h)
    xdt = xc * dtc[..., None]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b, nc, i, j, h)
    L = torch.where(tri[:, :, None], torch.exp(diff), 0.0)
    del diff
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None]
    # the forward's carried states, and the state gradients walked back
    local = torch.einsum("bcjn,bcjhp->bchpn", Bc, xdt * decay_in[..., None])
    back = torch.einsum("bcihp,bcin->bchpn", dyc * ecum[..., None], Cc)
    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    state_in = []
    for c in range(nc):
        state_in.append(state)
        state = state * torch.exp(last[:, c])[..., None, None] + local[:, c]
    grad = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
            if dfinal is None else dfinal.to(f32))
    gs = [None] * nc
    for c in reversed(range(nc)):
        gs[c] = grad
        grad = grad * torch.exp(last[:, c])[..., None, None] + back[:, c]
    del local, back, state, grad
    state_in = torch.stack(state_in, dim=1)                 # (b, nc, h, p, n)
    gs = torch.stack(gs, dim=1)
    # dxdt, dx, dD
    dxdt_state = (torch.einsum("bchpn,bcjn->bcjhp", gs, Bc)
                  * decay_in[..., None])
    dxdt = torch.einsum("bcijh,bcihp->bcjhp", G * L, dyc) + dxdt_state
    dx = D.to(f32)[:, None] * dyc + dtc[..., None] * dxdt
    dD = (dyc * xc).sum(dim=(0, 1, 2, 4))
    # S, dB, dC
    S = torch.einsum("bcihp,bcjhp->bcijh", dyc, xdt) * L
    del L
    dC = (torch.einsum("bcijh,bcjn->bcin", S, Bc)
          + torch.einsum("bcihp,bchpn->bcin", dyc * ecum[..., None],
                         state_in))
    dB = (torch.einsum("bcijh,bcin->bcjn", S, Cc)
          + torch.einsum("bcjhp,bchpn->bcjn", xdt * decay_in[..., None], gs))
    # dcum, its reverse cumsum da, ddt and dA
    R = S * G
    del S
    dcum = R.sum(dim=3) - R.sum(dim=2)                      # (b, nc, Q, h)
    del R
    carry = torch.einsum("bchpn,bctn->bcthp", state_in, Cc)
    dcum = dcum + ecum * (dyc * carry).sum(dim=-1)
    del carry
    u = (xdt * dxdt_state).sum(dim=-1)
    dcum = dcum - u
    dcum[:, :, -1] += (torch.exp(last) * (gs * state_in).sum(dim=(-2, -1))
                       + u.sum(dim=2))
    da = dcum.flip(2).cumsum(dim=2).flip(2)
    ddt = (xc * dxdt).sum(dim=-1) + Af * da
    dA = (dtc * da).sum(dim=(0, 1, 2))

    def rows(t):
        return t.reshape(b, nc * Q, *t.shape[3:])[:, :s]
    return (rows(dx).to(x.dtype), rows(ddt), dA, rows(dB).to(B.dtype),
            rows(dC).to(C.dtype), dD)
