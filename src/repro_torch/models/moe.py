"""Mixture-of-experts block (granite-moe family): a top-k router and
SwiGLU experts, with two routes.

Counterpart of ``repro.models.moe``.

- ``"dense"``: every expert runs on every token, with a masked combine.
  Exact; the default and the oracle.  Costs num_experts / top_k times the
  routed FLOPs.
- ``"scatter"``: capacity dispatch (GShard-style).  Expert e takes at
  most C = int(capacity_factor · T · k / E) + 1 tokens, slotted in token
  order; an assignment past C is dropped.

The router runs in fp32 and returns the Switch-style load-balance loss
beside the gates.  The JAX package's two ``.at[].add`` of the scatter
route become a plain index write and a fixed-order sum: a kept
(expert, slot) pair is unique, so the dispatch needs no accumulation (the
dropped assignments write a spare slot past C that is cut off), and each
token has exactly k contributions, summed over k in one reduction.  So no
atomic add is involved and a bf16 run repeats bit for bit.

``torch.topk`` and ``lax.top_k`` may break exact ties of router
probabilities differently; with random fp32 router logits a tie has
probability 0, and the tests rely on that.

Under ``rows_split(sum_rows)`` — the sharded train step, whose ranks each
run a share of the global batch's rows — the aux loss is not linear in
the rows: the first-choice counts and the token count are summed over
the ranks by ``sum_rows`` before the product, and each rank returns its
share, E · Σ_e frac_e · (its sum of probs_e) / T, whose sum over the
ranks is the global aux loss.  The scatter route's capacity and slot
order depend on the global T: there the router's choices are
all-gathered over the ranks (``gather_rows``, in row order), each
assignment takes its slot in global (token, choice) order under the
global capacity C(T_global), and each rank dispatches and combines its
own rows (ROADMAP Queue 1 item 13.7).  An expert's rows never mix, so a
rank's experts see the same kept tokens in the same slots as one rank
with the whole batch.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


class MoE(nn.Module):
    """router (d, E) fp32; w_gate and w_up (E, d, f), w_down (E, f, d) in
    the model dtype, under the names of ``repro.models.moe.init_moe``."""

    def __init__(self, cfg: ModelConfig, dtype, gen: torch.Generator):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.router = layers.dense_init(gen, (d, E), torch.float32)
        self.w_gate = layers.dense_init(gen, (E, d, f), dtype)
        self.w_up = layers.dense_init(gen, (E, d, f), dtype)
        self.w_down = layers.dense_init(gen, (E, f, d), dtype)


def init_moe(cfg: ModelConfig, dtype, gen: torch.Generator) -> MoE:
    return MoE(cfg, dtype, gen)


# the row splits in force, innermost last: (sum_rows, gather_rows, index)
_sum_rows: list = []


@contextlib.contextmanager
def rows_split(sum_rows, gather_rows=None, index: int = 0):
    """Within: the batch's rows are split over ranks (module docstring).
    ``sum_rows``: tensor -> its sum over those ranks, for the router's
    aux loss (each rank returns its share of the global one).
    ``gather_rows``: tensor -> the ranks' tensors concatenated on dim 0
    in row order, and ``index``: this rank's block of rows in it, for
    the scatter route's global slots; without them the scatter route
    raises ValueError."""
    _sum_rows.append((sum_rows, gather_rows, index))
    try:
        yield
    finally:
        _sum_rows.pop()


def _route(params: MoE, x2: Tensor, cfg: ModelConfig):
    """x2: (T, d) -> (gates (T, k) fp32, idx (T, k), aux_loss scalar)."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(x2.to(torch.float32) @ params.router, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / (torch.sum(gates, dim=-1, keepdim=True) + 1e-9)
    # Switch aux loss: E * sum_e (share of first choices to e) * (mean
    # router probability of e)
    onehot = torch.nn.functional.one_hot(idx[:, 0], E).to(torch.float32)
    if _sum_rows:
        sum_rows = _sum_rows[-1][0]
        total = sum_rows(probs.new_tensor(float(x2.shape[0])))
        frac = sum_rows(torch.sum(onehot, dim=0)) / total
        aux = E * torch.sum(frac * torch.sum(probs, dim=0)) / total
        return gates, idx, aux
    frac = torch.mean(onehot, dim=0)
    aux = E * torch.sum(frac * torch.mean(probs, dim=0))
    return gates, idx, aux


def _expert_ffn(xe: Tensor, params: MoE) -> Tensor:
    """xe: (E, C, d) -> (E, C, d), each expert's SwiGLU on its rows."""
    g = torch.bmm(xe, params.w_gate)
    u = torch.bmm(xe, params.w_up)
    return torch.bmm(layers.silu(g) * u, params.w_down)


def moe_forward_dense(params: MoE, x: Tensor, cfg: ModelConfig):
    """Every expert on every token; the gates combine them.  x: (B, S, d)
    -> ((B, S, d), aux)."""
    B, S, d = x.shape
    # f of the expert tensors held: d_ff, or a tensor-parallel block of it
    T, E, f = B * S, cfg.num_experts, params.w_down.shape[1]
    x2 = x.reshape(T, d)
    gates, idx, aux = _route(params, x2, cfg)
    comb = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    comb.scatter_(1, idx, gates)            # top-k indices are distinct
    g = torch.matmul(x2, params.w_gate)                         # (E, T, f)
    u = torch.matmul(x2, params.w_up)
    h = comb.T.to(x.dtype)[:, :, None] * (layers.silu(g) * u)
    # one contraction over (e, f), as the JAX package's einsum
    y = h.transpose(0, 1).reshape(T, E * f) @ params.w_down.reshape(E * f, d)
    return y.reshape(B, S, d), aux


def capacity(cfg: ModelConfig, T: int) -> int:
    """Rows of each expert in the scatter route for T tokens."""
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    return int(cfg.moe_capacity_factor * T * k / E) + 1


def _slots(idx: Tensor, cfg: ModelConfig):
    """(capacity C, slot of each of this rank's T·k assignments): the
    number of earlier assignments to the same expert in (token, choice)
    order, over the global batch under ``rows_split`` (module
    docstring)."""
    T, k = idx.shape
    every, first = idx, 0
    if _sum_rows:
        _, gather_rows, index = _sum_rows[-1]
        if gather_rows is None:
            raise ValueError("the scatter route under rows_split needs "
                             "gather_rows: its slots are global")
        every, first = gather_rows(idx), index * T * k
    flat = every.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, cfg.num_experts)
    slot = torch.sum((torch.cumsum(onehot, dim=0) - onehot) * onehot,
                     dim=-1)                                       # (Tg*k,)
    return capacity(cfg, every.shape[0]), slot[first:first + T * k]


def moe_forward_scatter(params: MoE, x: Tensor, cfg: ModelConfig):
    """Capacity dispatch: token t's j-th choice e takes slot = the number
    of earlier assignments (in (token, choice) order) to e, and is dropped
    when slot >= C; under ``rows_split`` both over the global batch.
    x: (B, S, d) -> ((B, S, d), aux)."""
    B, S, d = x.shape
    T, k, E = B * S, cfg.num_experts_per_tok, cfg.num_experts
    x2 = x.reshape(T, d)
    gates, idx, aux = _route(params, x2, cfg)
    flat_e = idx.reshape(T * k)
    C, slot = _slots(idx, cfg)
    keep = slot < C
    tok_id = torch.arange(T, device=x.device).repeat_interleave(k)
    # kept (expert, slot) pairs are distinct; dropped ones go to slot C,
    # which is cut off, so a plain index write is exact
    xe = torch.zeros((E, C + 1, d), dtype=x.dtype, device=x.device)
    xe[flat_e, torch.where(keep, slot, C)] = x2[tok_id]
    ye = _expert_ffn(xe[:, :C], params)                            # (E, C, d)
    slot = torch.where(keep, slot, C - 1)
    contrib = ye[flat_e, slot] * (gates.reshape(T * k) * keep)[:, None].to(
        x.dtype)
    y = contrib.reshape(T, k, d).sum(dim=1)
    return y.reshape(B, S, d), aux


def moe_forward(params: MoE, x: Tensor, cfg: ModelConfig):
    """The MoE mixer by ``cfg.moe_routing``.  Returns (y, aux_loss)."""
    if cfg.moe_routing == "scatter":
        return moe_forward_scatter(params, x, cfg)
    return moe_forward_dense(params, x, cfg)
