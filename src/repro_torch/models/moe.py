"""Mixture-of-Experts block (mixtral-8x22b, qwen2-moe-a2.7b).

The port of ``repro/models/moe.py``: GShard-style top-k capacity routing
with a switch load-balance loss and a router z-loss.  Tokens are routed
in groups of ``group_size`` (the flat tokens padded with zero rows to a
whole number of groups), each expert taking at most ``cap`` choices a
group.  The discrete decisions are the JAX package's:

* router logits are float32 sums of the activations times the router
  rounded to the activations' dtype; the top-k is taken on their
  float32 softmax, ties to the lower expert id (a stable descending
  sort: ``torch.topk`` promises no order, and the zero pad rows tie on
  every expert);
* a choice's slot in its expert's queue is its rank in token-major
  order — token 0's choices 0..K-1, then token 1's — so a token's
  second choice can take the slot a later token's first choice wanted;
  choices past ``cap`` are dropped, after the gates were renormalized;
* the pad rows count in the aux losses' means.

Where JAX dispatches and combines through (S, E, C) one-hots, this
gathers: each kept choice owns a unique (expert, slot) row of the
(E, C, d) expert input, and each token gathers its kept choices' expert
outputs back, weights them by the gate rounded to the activations'
dtype and sums over K in float32, rounded once.  No float atomics, so
the bits do not change from run to run.  The experts are batched matrix
products (``torch.bmm``), as JAX's einsums, which sit outside any Pallas
kernel.  ``moe_ref`` is a plain sequential version of the same function
(a loop over tokens and choices with per-expert counters) that the tests
hold ``apply_moe`` against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def init_moe(generator, d_model: int, moe_d_ff: int, num_experts: int,
             num_shared_experts: int = 0, shared_d_ff: int = 0, device=None,
             activation: str = "swiglu") -> dict:
    """The JAX package's tree: router (d, E), wi / [wg] (E, d, f), wo
    (E, f, d), and with shared experts ``shared`` (an MLP of width
    ``shared_d_ff``) and ``shared_gate`` (d, 1).  The expert kernels take
    the JAX fan-in, ``shape[0]`` = E (stddev 1/sqrt(E))."""
    p = {"router": layers.init_dense(generator, d_model, (num_experts,),
                                     device)}
    shape_in = (num_experts, d_model, moe_d_ff)
    p["wi"] = {"kernel": layers.truncated_normal_init(shape_in, 1.0,
                                                      generator, device)}
    if activation in ("swiglu", "geglu"):
        p["wg"] = {"kernel": layers.truncated_normal_init(shape_in, 1.0,
                                                          generator, device)}
    p["wo"] = {"kernel": layers.truncated_normal_init(
        (num_experts, moe_d_ff, d_model), 1.0, generator, device)}
    if num_shared_experts:
        p["shared"] = layers.init_mlp(generator, d_model, shared_d_ff, device,
                                      activation)
        p["shared_gate"] = layers.init_dense(generator, d_model, (1,), device)
    return p


def moe_axes(num_shared_experts: int = 0, activation: str = "swiglu") -> dict:
    a = {"router": layers.dense_axes("embed", (None,)),
         "wi": {"kernel": ("experts", "embed", "mlp")},
         "wo": {"kernel": ("experts", "mlp", "embed")}}
    if activation in ("swiglu", "geglu"):
        a["wg"] = {"kernel": ("experts", "embed", "mlp")}
    if num_shared_experts:
        a["shared"] = layers.mlp_axes(activation)
        a["shared_gate"] = layers.dense_axes("embed", (None,))
    return a


def _expert_ffn(params: dict, xe: torch.Tensor, activation: str) -> torch.Tensor:
    """xe (E, C, d) -> (E, C, d), batched over experts."""
    wi = params["wi"]["kernel"].to(xe.dtype)
    wo = params["wo"]["kernel"].to(xe.dtype)
    h = torch.bmm(xe, wi)
    if activation == "swiglu":
        h = F.silu(torch.bmm(xe, params["wg"]["kernel"].to(xe.dtype))) * h
    elif activation == "geglu":
        h = layers.gelu(torch.bmm(xe, params["wg"]["kernel"].to(xe.dtype))) * h
    else:
        h = layers.ACT[activation](h)
    return torch.bmm(h, wo)


def capacity(group: int, top_k: int, capacity_factor: float,
             num_experts: int) -> int:
    """Choices an expert takes a group (the JAX package's float arithmetic)."""
    return max(1, int(group * top_k * capacity_factor / num_experts))


def router_logits(router: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., E) float32: x times the router rounded to x's
    dtype, summed in float32 (never a GEMM rounded to x's dtype)."""
    return x.float() @ router.to(x.dtype).float()


class Routing(NamedTuple):
    """One call's routing, per group: ``logits`` / ``probs`` (G, S, E)
    float32, ``experts`` / ``gates`` / ``slot`` / ``keep`` (G, S, K) (the
    chosen ids best first, renormalized float32 gates, the slot in the
    expert's queue, kept), ``cap``, and ``n``: the first n of the flat
    (G·S) rows are the tokens, the rest padding."""
    logits: torch.Tensor
    probs: torch.Tensor
    experts: torch.Tensor
    gates: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    cap: int
    n: int


def _group(x: torch.Tensor, group_size: int) -> tuple[torch.Tensor, int]:
    """(..., d) -> (G, S, d), the flat tokens padded with zero rows."""
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    s = min(group_size, n)
    pad = -n % s
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, d))])
    return xf.reshape(-1, s, d), n


def route(params: dict, x: torch.Tensor, *, num_experts: int, top_k: int,
          capacity_factor: float = 1.25, group_size: int = 1024,
          renormalize: bool = True) -> Routing:
    """The routing decisions of ``apply_moe`` for x (..., d)."""
    xg, n = _group(x, group_size)
    g, s, _ = xg.shape
    cap = capacity(s, top_k, capacity_factor, num_experts)
    logits = router_logits(params["router"]["kernel"], xg)
    probs = torch.softmax(logits, dim=-1)
    experts = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[..., :top_k]
    gates = torch.gather(probs, -1, experts)
    if renormalize:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    oh = F.one_hot(experts.reshape(g, s * top_k), num_experts)
    slot = ((torch.cumsum(oh, dim=1) * oh).sum(-1) - 1).reshape(g, s, top_k)
    return Routing(logits, probs, experts, gates, slot, slot < cap, cap, n)


def _aux(r: Routing, num_experts: int) -> dict:
    density = F.one_hot(r.experts[..., 0], num_experts).float().mean(1)
    lb = num_experts * torch.sum(density * r.probs.mean(1), dim=-1)
    z = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2, dim=-1)
    return {"load_balance": lb.mean(), "router_z": z.mean()}


def _shared(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    sh = layers.apply_mlp(params["shared"], x, activation)
    return sh * torch.sigmoid(layers.dense(params["shared_gate"], x))


def apply_moe(params: dict, x: torch.Tensor, *, num_experts: int, top_k: int,
              activation: str = "swiglu", capacity_factor: float = 1.25,
              group_size: int = 1024, renormalize: bool = True):
    """x (B, T, d) -> (y (B, T, d), {"load_balance", "router_z"})."""
    b, t, d = x.shape
    r = route(params, x, num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor, group_size=group_size,
              renormalize=renormalize)
    xg, _ = _group(x, group_size)
    g, s, _ = xg.shape
    cap = r.cap
    # dispatch: each kept choice names its token in its own row e·cap +
    # slot of the group's (E·cap) expert rows; rows left unfilled name the
    # zero row s, dropped choices write to a sink column past the rows
    row = r.experts * cap + r.slot.clamp(max=cap - 1)             # (G, S, K)
    tok = torch.arange(s, device=x.device)[None, :, None].expand_as(row)
    owner = torch.full((g, num_experts * cap + 1), s, dtype=torch.long,
                       device=x.device)
    owner.scatter_(1, torch.where(r.keep, row, num_experts * cap)
                   .reshape(g, -1), tok.reshape(g, -1))
    xz = torch.cat([xg, xg.new_zeros((g, 1, d))], 1)              # (G, S+1, d)
    xe = torch.gather(xz, 1, owner[:, :-1, None].expand(-1, -1, d))
    xe = xe.reshape(g, num_experts, cap, d).transpose(0, 1) \
        .reshape(num_experts, g * cap, d)
    ye = _expert_ffn(params, xe, activation)                      # (E, G·cap, d)
    ye = ye.reshape(num_experts, g, cap, d).transpose(0, 1) \
        .reshape(g, num_experts * cap, d)
    # combine: each token's kept choices, gate rounded to x's dtype, summed
    # over K in float32 and rounded once
    picked = torch.gather(ye, 1, row.reshape(g, -1)[..., None]
                          .expand(-1, -1, d)).reshape(g, s, top_k, d)
    w = torch.where(r.keep, r.gates.to(x.dtype), 0).float()
    y = torch.sum(picked.float() * w[..., None], dim=2).to(x.dtype)
    y = y.reshape(g * s, d)[:r.n].reshape(b, t, d)
    if "shared" in params:
        y = y + _shared(params, x, activation)
    return y, _aux(r, num_experts)


def moe_ref(params: dict, x: torch.Tensor, *, num_experts: int, top_k: int,
            activation: str = "swiglu", capacity_factor: float = 1.25,
            group_size: int = 1024, renormalize: bool = True):
    """``apply_moe`` done plainly: per group, a Python loop over tokens and
    their choices (best first, ties to the lower id) with per-expert
    counters, and each kept choice's expert applied to its token's row
    alone.  The logits and softmax are ``route``'s (a GEMM and a GEMV
    may round differently; the decisions are what this holds).  Returns
    (y, aux, experts (G, S, K), keep (G, S, K))."""
    b, t, d = x.shape
    xg, n = _group(x, group_size)
    g, s, _ = xg.shape
    cap = capacity(s, top_k, capacity_factor, num_experts)
    logits = router_logits(params["router"]["kernel"], xg)
    probs = torch.softmax(logits, dim=-1)
    experts = torch.zeros((g, s, top_k), dtype=torch.long)
    keep = torch.zeros((g, s, top_k), dtype=torch.bool)
    y = torch.zeros((g, s, d), dtype=x.dtype, device=x.device)
    lb, z = [], []
    for gi in range(g):
        rows = probs[gi].tolist()
        counts = [0] * num_experts
        first = [0] * num_experts
        for si in range(s):
            row = rows[si]
            order = sorted(range(num_experts), key=lambda e: (-row[e], e))
            chosen = order[:top_k]
            first[chosen[0]] += 1
            gate = probs[gi, si, chosen]
            if renormalize:
                gate = gate / torch.clamp(gate.sum(), min=1e-9)
            acc = torch.zeros((d,), dtype=torch.float32, device=x.device)
            for k, e in enumerate(chosen):
                experts[gi, si, k] = e
                counts[e] += 1
                if counts[e] > cap:
                    continue
                keep[gi, si, k] = True
                out = _expert_ffn(
                    {key: {"kernel": params[key]["kernel"][e:e + 1]}
                     for key in ("wi", "wg", "wo") if key in params},
                    xg[gi, si][None, None], activation)[0, 0]
                acc += out.float() * gate[k].to(x.dtype).float()
            y[gi, si] = acc.to(x.dtype)
        density = torch.tensor(first, dtype=torch.float32,
                               device=x.device) / s
        lb.append(num_experts * torch.sum(density * probs[gi].mean(0)))
        z.append(torch.mean(torch.logsumexp(logits[gi], dim=-1) ** 2))
    y = y.reshape(g * s, d)[:n].reshape(b, t, d)
    if "shared" in params:
        y = y + _shared(params, x, activation)
    aux = {"load_balance": torch.stack(lb).mean(),
           "router_z": torch.stack(z).mean()}
    return y, aux, experts.to(x.device), keep.to(x.device)
