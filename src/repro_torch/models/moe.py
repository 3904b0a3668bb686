"""Mixture-of-Experts layer, in PyTorch: top-k router and capacity-based
dispatch, the function of ``repro.models.moe`` for one dispatch group.

The router is an fp32 ``dense`` even in a bf16 model; its softmax picks
the top-k experts of each token and renormalises their probabilities,
and the Switch load-balance loss is computed over all tokens. Each
expert takes at most ``cap`` (token, slot) pairs: a pair's place in its
expert's queue is the count of earlier pairs with that expert in the
token-major flattening ``[m*k]`` of the top-k ids, and a pair at or past
``cap`` is dropped (weight 0), as JAX's cumsum over the one-hot ids
decides. ``dropless`` sets ``cap = m``, so nothing drops (the serving
paths: a crowded prefill and a one-token decode then route alike).

JAX fills an expert-major buffer ``[E, cap, D]`` and runs the stacked
experts over all of it. The port runs each expert's swiglu only on the
rows routed to it: the (token, slot) pairs that are kept, sorted by
expert (one host sync a layer for the counts), gathered, multiplied and
scattered back. Each row's product is the one JAX computes for it; the
dense buffer at the generate prefill (8 x 512 tokens, ``cap = m``)
would be 1.07 GB a layer for deepseek-v2-lite and 64/6 times the
products. Outputs are combined per token in slot order, weighted by the
renormalised probabilities cast to the activations' dtype, and the
shared experts (one swiglu of width ``num_shared_experts * moe_d_ff``)
are added last. The expert products are ``torch.matmul``: JAX computes
them outside any Pallas kernel.

Dispatch groups, as JAX's: the tokens split into G groups, G the
ambient mesh's ``data`` size when it divides them (``shard_hints``; 1
outside a mesh), and each group takes its own capacity ``capacity(cfg,
n / G)`` and its own queue positions. Dropless serving is the same for
any G; under capacity (training) G changes which pairs drop, as in JAX.
On a mesh whose tokens are DTensors (``launch.specs``, ``train --mesh``)
each ``data`` rank's rows are its group, and the experts are sharded
over ``model`` (expert parallelism): each rank routes its rows, runs its
own experts on the pairs routed to them into a buffer of those pairs
only (``_experts_mine``: no [tokens, k, D] buffer of mostly zeros; one
card keeps the [m * k, D] buffer, whose combine takes fewer launches a
layer), and the ranks of a group sum their outputs. Fake tensors (the
dry-run) hold no routing, so there each expert takes an even share of
the pairs: for dropless serving that total is exact.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (Params, dense_params, normal, swiglu,
                                       swiglu_params)
from repro_torch.models.shard_hints import abstract, get_mesh, is_sharded, \
    keep, local_range, map_local


def moe_params(gen: torch.Generator, cfg: ModelConfig, dtype,
               stack: tuple = ()) -> Params:
    """``repro.models.moe.moe_params``'s tree: an fp32 router
    ``[D, E]``, stacked experts ``w_gate``/``w_up`` ``[E, D, F]`` and
    ``w_down`` ``[E, F, D]``, and ``shared`` when the config has shared
    experts. ``stack`` prepends leading dims."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": dense_params(gen, d, e, torch.float32, stack=stack),
        "w_gate": normal(gen, (*stack, e, d, f), dtype, 1.0 / math.sqrt(d)),
        "w_up": normal(gen, (*stack, e, d, f), dtype, 1.0 / math.sqrt(d)),
        "w_down": normal(gen, (*stack, e, f, d), dtype, 1.0 / math.sqrt(f)),
    }
    if cfg.num_shared_experts:
        p["shared"] = swiglu_params(gen, d, cfg.num_shared_experts * f,
                                    dtype, stack=stack)
    return p


def capacity(cfg: ModelConfig, m: int,
             capacity_factor: float | None = None) -> int:
    """Per-expert capacity for ``m`` tokens when pairs may drop:
    ``max(int(m * k * cf / E), 1)`` rounded up to a multiple of 8."""
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
    cap = max(int(m * cfg.num_experts_per_tok * cf / cfg.num_experts), 1)
    return (cap + 7) // 8 * 8


def route(cfg: ModelConfig, p: Params, xf: torch.Tensor):
    """xf: [m, D] -> (top_e [m, k] int64, top_p [m, k] fp32 renormalised,
    aux 0-d fp32, me [E] fp32): ``me``, the router's mean probabilities
    over the rows, is the balance loss's share of the one softmax."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = xf.float() @ p["router"]["w"].float()                # [m, E]
    probs = torch.softmax(logits, -1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    me = probs.mean(0)
    return top_e, top_p, e * torch.sum(me * _fractions(top_e, e)), me


def _fractions(top_e: torch.Tensor, e: int) -> torch.Tensor:
    """[E] fp32: each expert's share of the (token, slot) pairs, JAX's
    mean over tokens of the one-hot ids summed over the slots, made as
    an [m, E] 0/1 table (top-k picks distinct experts, so a token's
    slots set distinct columns) without the [m, k, E] one-hot."""
    m, k = top_e.shape
    hit = torch.zeros((m, e), device=top_e.device).scatter_(1, top_e, 1.0)
    return hit.mean(0) / k


def keep_mask(top_e: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """[m, k] bool: the (token, slot) pairs that fit their expert's
    capacity, in JAX's order (token-major, then slot)."""
    flat = top_e.reshape(-1)
    onehot = F.one_hot(flat, e)
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    return (pos < cap).reshape(top_e.shape)


def _dispatch_groups(n: int) -> int:
    """Number of dispatch groups = ambient `data` axis size (1 if absent
    or indivisible)."""
    mesh = get_mesh()
    if mesh is None or "data" not in mesh.axis_names:
        return 1
    g = mesh.shape["data"]
    return g if n % g == 0 else 1


def _experts(cfg: ModelConfig, p: Params, xf: torch.Tensor,
             top_e: torch.Tensor, keep: torch.Tensor, capacity_factor,
             dropless: bool) -> torch.Tensor:
    """Each kept (token, slot) pair's expert output, [m, k, D] (zero
    where dropped): the pairs sorted by expert, each expert's swiglu on
    its own rows. Fake tensors hold no routing: there each expert takes
    an even share of the pairs, at most its capacity."""
    m, k = top_e.shape
    e = p["w_gate"].shape[0]
    # one view per expert by unbind (indexing a leaf per expert would give
    # each expert's backward a zeroed gradient of the whole stack)
    wg, wu, wd = (p[n].unbind(0) for n in ("w_gate", "w_up", "w_down"))
    out = xf.new_zeros((m * k, xf.shape[-1]))
    flat = torch.where(keep, top_e, e).reshape(-1)      # dropped -> e
    order = torch.argsort(flat, stable=True)
    if abstract(flat):
        counts = [_share(cfg, m, capacity_factor, dropless)] * e
    else:
        counts = torch.bincount(flat, minlength=e + 1)[:e].tolist()
    rows = order // k
    start = 0
    for ex, n in enumerate(counts):
        if n:
            sel = order[start:start + n]
            xe = xf[rows[start:start + n]]
            out[sel] = (F.silu(xe @ wg[ex]) * (xe @ wu[ex])) @ wd[ex]
            start += n
    return out.reshape(m, k, -1)


def _experts_mine(cfg: ModelConfig, p: Params, xf: torch.Tensor,
                  top_e: torch.Tensor, w: torch.Tensor, keep: torch.Tensor,
                  capacity_factor, dropless: bool) -> torch.Tensor:
    """A rank's kept (token, slot) pairs' expert outputs weighted by
    ``w`` [m, k] (the activations' dtype) and summed per token in slot
    order: y [m, D], 0 for a token with none. ``top_e`` indexes ``p``'s
    experts (the rank's shard of the config's). Each expert's swiglu
    runs on its own pairs' rows; the outputs go into one buffer of the
    kept pairs only, slot-major, so that slot j's pairs are one block,
    added into y at its tokens (each at most once a slot: no order to
    decide): ``_combine``'s sums. Fake tensors hold no routing:
    there each expert takes an even share of the pairs, at most its
    capacity, spread evenly over the slots."""
    m, k = top_e.shape
    e = p["w_gate"].shape[0]
    # one view per expert by unbind (indexing a leaf per expert would give
    # each expert's backward a zeroed gradient of the whole stack)
    wg, wu, wd = (p[n].unbind(0) for n in ("w_gate", "w_up", "w_down"))
    flat = torch.where(keep, top_e, e).reshape(-1)      # dropped -> e
    # the kept pairs slot-major (pair index = token * k + slot), and each
    # one's place among them; then by expert, for the products
    slot_major = torch.where(keep.t(), 0, 1).reshape(-1)
    by_slot = torch.argsort(slot_major, stable=True)
    pair = by_slot % m * k + by_slot // m
    place = torch.empty_like(pair)
    place[pair] = torch.arange(m * k, device=pair.device)
    order = torch.argsort(flat, stable=True)
    if abstract(flat):
        counts = [_share(cfg, m, capacity_factor, dropless)] * e
        kept = sum(counts)
        per_slot = [kept // k + (j < kept % k) for j in range(k)]
    else:
        both = torch.cat([torch.bincount(flat, minlength=e + 1)[:e],
                          keep.sum(0)]).tolist()      # one host sync
        counts, per_slot = both[:e], both[e:]
    out = xf.new_empty((sum(counts), xf.shape[-1]))
    start = 0
    for ex, n in enumerate(counts):
        if n:
            sel = order[start:start + n]
            xe = xf[sel // k]
            out[place[sel]] = (F.silu(xe @ wg[ex]) * (xe @ wu[ex])) @ wd[ex]
            start += n
    y = xf.new_zeros((m, xf.shape[-1]))
    wp = w.reshape(-1)
    start = 0
    for j, n in enumerate(per_slot):                      # slot order
        if n:
            pj = pair[start:start + n]
            y.index_add_(0, pj // k, out[start:start + n] * wp[pj, None])
            start += n
    return y


def _keep(cfg: ModelConfig, top_e: torch.Tensor, groups: int,
          capacity_factor: float | None, dropless: bool) -> torch.Tensor:
    """The kept pairs of ``groups`` dispatch groups of the rows of
    ``top_e``, each with its own capacity and queue positions."""
    if dropless:    # cap = m: a pair's place in its queue is below m
        return torch.ones_like(top_e, dtype=torch.bool)
    m = top_e.shape[0] // groups
    cap = capacity(cfg, m, capacity_factor)
    return torch.cat([keep_mask(te, cfg.num_experts, cap)
                      for te in top_e.split(m)])


def _share(cfg: ModelConfig, m: int, capacity_factor, dropless) -> int:
    """An expert's even share of ``m`` rows' pairs, at most its
    capacity."""
    share = -(-m * cfg.num_experts_per_tok // cfg.num_experts)
    return share if dropless else min(share,
                                      capacity(cfg, m, capacity_factor))


def _combine(ye: torch.Tensor, top_p: torch.Tensor,
             keep: torch.Tensor) -> torch.Tensor:
    """Outputs per token in slot order, weighted by the renormalised
    probabilities cast to the activations' dtype."""
    w = (top_p * keep).to(ye.dtype)
    y = ye[:, 0] * w[:, :1]
    for j in range(1, ye.shape[1]):                       # slot order
        y = y + ye[:, j] * w[:, j:j + 1]
    return y


def moe_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                capacity_factor: float | None = None,
                dropless: bool = False):
    """x: [B, T, D] -> (y [B, T, D], aux_loss 0-d fp32)."""
    b, t, d = x.shape
    if is_sharded(x):
        y, aux = _moe_sharded(cfg, p, x, capacity_factor, dropless)
    else:
        xf = x.reshape(b * t, d)
        top_e, top_p, aux, _ = route(cfg, p, xf)
        keep = _keep(cfg, top_e, _dispatch_groups(b * t), capacity_factor,
                     dropless)
        y = _combine(_experts(cfg, p, xf, top_e, keep, capacity_factor,
                              dropless), top_p, keep)
    if "shared" in p:
        y = y + swiglu(p["shared"], x.reshape(b * t, d))
    return y.reshape(b, t, d), aux


def _moe_sharded(cfg: ModelConfig, p: Params, x, capacity_factor,
                 dropless):
    """``moe_forward``'s routed experts on a mesh: x [B, T, D] a DTensor.
    Each rank routes its rows (its dispatch group; the router is
    replicated), runs the experts of its shard of the expert dim on the
    pairs routed to them and sums their weighted outputs per token (the
    other pairs add nothing); the output is a partial sum over the mesh
    dims that shard the experts. The
    balance loss is JAX's, over all tokens: each group's mean
    probabilities (``route``'s, from its one router product) and routed
    fractions are averaged over the groups (a partial sum of each
    group's share over the row-sharding dims)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    xpl = keep(x, {0: 0})
    wpl = keep(p["w_gate"], {0: 0})          # the expert shard; FSDP gathered
    ws = [p[n] for n in ("w_gate", "w_up", "w_down")]
    ws = [w if list(w.placements) == wpl else w.redistribute(mesh, wpl)
          for w in ws]
    e0, ne = local_range(ws[0], 0)
    rows_pl = [Shard(0) if isinstance(q, Shard) else Replicate()
               for q in xpl]
    groups = math.prod(mesh.size(i) for i, q in enumerate(rows_pl)
                       if isinstance(q, Shard))
    # y: partial over the expert-sharding mesh dims; the means: partial
    # over the row-sharding ones
    ypl = [Partial() if isinstance(q, Shard) else r
           for q, r in zip(wpl, rows_pl)]
    mpl = [Partial() if isinstance(q, Shard) else Replicate()
           for q in rows_pl]

    def local(xl, rw, wg, wu, wd):
        xf = xl.reshape(-1, xl.shape[-1])
        top_e, top_p, _, me = route(cfg, {"router": {"w": rw}}, xf)
        keep_ = _keep(cfg, top_e, 1, capacity_factor, dropless)
        mine = (top_e >= e0) & (top_e < e0 + ne)
        lp = {"w_gate": wg, "w_up": wu, "w_down": wd}
        y = _experts_mine(cfg, lp, xf, torch.where(mine, top_e - e0, 0),
                          (top_p * keep_).to(xf.dtype), keep_ & mine,
                          capacity_factor, dropless)
        return y, me / groups, _fractions(top_e, e) / groups

    y, me, ce = map_local(
        local, mesh, [(x, xpl), (p["router"]["w"], [Replicate()] * mesh.ndim),
                      *((w, wpl) for w in ws)], (ypl, mpl, mpl))
    return y, e * torch.sum(me * ce)
