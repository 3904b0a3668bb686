"""Shared transformer building blocks, in PyTorch.

Plain functions over dict parameter trees in the JAX package's layout:
dense weights are ``[d_in, d_out]`` with ``y = x @ w + b`` (not the
``nn.Linear`` orientation), so a tree carried over by
``repro_torch.weights.params_from_jax`` drops in unchanged.

Numerics follow ``repro.models.layers``: norms compute in fp32 and cast
back; rope rotates the two HALVES of the head dim (not interleaved
pairs); the plain ``gqa_attention`` keeps logits and softmax in fp32 even
for bf16 inputs (JAX's ``preferred_element_type=f32``), rounds the
probabilities to the value dtype before the PV product, and accumulates
that product in fp32. ``attn_forward``, the train path's attention,
computes what JAX's does through the plain ``gqa_attention`` (under
autograd); the serving path's prefill attention in ``attn_prefill`` goes
through ``kernels.flash_attention`` and one-token attention over the
cache in ``attn_decode`` through ``kernels.decode_attention`` (the Hopper
kernels for a CUDA tensor, which have no backward).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attn
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.shard_hints import (batch_rank, get_mesh,
                                             is_sharded, keep, like,
                                             local_range, map_local,
                                             merge_heads, pin, project,
                                             split_heads, write_slot)

Params = dict


# --------------------------------------------------------------------------
# initialisation helpers (drawn on the generator's device, in the target
# dtype: a full-width bf16 model never needs an fp32 host copy)
# --------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, dtype, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype).mul_(scale)


def _dense_init(gen, shape, dtype, scale: float | None = None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return normal(gen, shape, dtype, scale)


def dense_params(gen: torch.Generator, d_in: int, d_out: int, dtype,
                 bias: bool = False, scale: float | None = None,
                 stack: tuple = ()) -> Params:
    """``stack`` prepends leading dims (``(L,)`` for stacked blocks)."""
    p = {"w": _dense_init(gen, (*stack, d_in, d_out), dtype, scale)}
    if bias:
        p["b"] = torch.zeros((*stack, d_out), dtype=dtype, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = project(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps)
    x = x * w.float()       # at most two fp32 copies of x held at once
    return x.to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.mean(torch.square(x - mu), -1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               num_groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over the last dim (RWKV6's output norm)."""
    dt = x.dtype
    *lead, d = x.shape
    x = x.float().reshape(*lead, num_groups, d // num_groups)
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.mean(torch.square(x - mu), -1, keepdim=True)
    y = ((x - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * w.float() + b.float()).to(dt)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, hd]; positions: broadcastable to [..., T]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    angles = positions[..., None].float() * freqs           # [..., T, hd/2]
    angles = angles[..., None, :]                           # [..., T, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA, optional sliding window / bias)
# --------------------------------------------------------------------------

def attention_params(gen, cfg: ModelConfig, dtype, stack: tuple = ()) -> Params:
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_params(gen, cfg.d_model, cfg.num_heads * hd, dtype,
                           bias=cfg.attn_bias, stack=stack),
        "wk": dense_params(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype,
                           bias=cfg.attn_bias, stack=stack),
        "wv": dense_params(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype,
                           bias=cfg.attn_bias, stack=stack),
        "wo": dense_params(gen, cfg.num_heads * hd, cfg.d_model, dtype,
                           stack=stack),
    }


_SCORES_FP32 = False    # ablation: the fp32 attention-score path


def set_scores_fp32(value: bool) -> None:
    """Toggle JAX's fp32 attention-score ablation (``repro.models.layers
    .set_scores_fp32``; ``analysis.perf --fp32-scores``): the softmax
    weights enter the PV product in fp32 instead of rounded to the
    values' dtype. The serving kernels are not affected."""
    global _SCORES_FP32
    _SCORES_FP32 = value


def scores_fp32() -> bool:
    return _SCORES_FP32


def _sdpa(q, k, v, mask, scale):
    """q:[B,Tq,K,G,hd] k,v:[B,S,K,hd] mask:[Tq,S] bool -> [B,Tq,K,G,hd]."""
    logits = torch.einsum("btkgh,bskh->bkgts", q.float(), k.float()) * scale
    logits = torch.where(mask[None, None, None], logits,
                         torch.tensor(-1e30, device=logits.device))
    w = torch.softmax(logits, -1)
    if not _SCORES_FP32:
        w = w.to(v.dtype).float()
    out = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return out.to(q.dtype)


def gqa_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                  window: int = 0, kv_len_valid=None, q_chunk: int = 1024):
    """Plain grouped-query attention, in query chunks of ``q_chunk`` rows.

    q: [B, Tq, H, hd]; k, v: [B, S, K, hd]. q_offset: absolute position of
    q[0]. kv_len_valid: number of valid cache slots (decode).
    """
    b, tq, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    q = q.reshape(b, tq, kh, g, hd)
    scale = 1.0 / math.sqrt(hd)
    kv_pos = torch.arange(s, device=q.device)

    def mask_for(q_pos):
        m = torch.ones((q_pos.shape[0], s), dtype=torch.bool, device=q.device)
        if causal:
            m &= kv_pos[None, :] <= q_pos[:, None]
        if window:
            m &= kv_pos[None, :] > q_pos[:, None] - window
        if kv_len_valid is not None:
            m &= kv_pos[None, :] < kv_len_valid
        return m

    outs = []
    for c0 in range(0, tq, q_chunk):
        qc = q[:, c0:c0 + q_chunk]
        q_pos = q_offset + c0 + torch.arange(qc.shape[1], device=q.device)
        outs.append(_sdpa(qc, k, v, mask_for(q_pos), scale))
    return torch.cat(outs, dim=1).reshape(b, tq, h, hd)


def _qkv(cfg: ModelConfig, p: Params, x, positions):
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    # on a mesh the query heads stay split as wq's output is, as GSPMD
    # keeps them; k and v are gathered along an axis their heads do not
    # divide (per_head_shard then reads only the KV heads a rank needs).
    # Heads that do not divide the axis (qwen2-7b's 28 on 16) split as
    # torch.chunk splits: whole heads, ceil(28 / 16) = 2 on the first
    # ranks. GSPMD splits head_dim there instead (each chip's logits a
    # partial sum of its share of hd, all-reduced): 1.75 heads' work a
    # chip, the port's first ranks 2
    q = split_heads(dense(p["wq"], x), cfg.num_heads, hd, split=True)
    k = split_heads(dense(p["wk"], x), cfg.num_kv_heads, hd)
    v = split_heads(dense(p["wv"], x), cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def per_head_shard(fn, q, *kv):
    """``fn(q, *kv)`` -> [B, T, H, ...]; on a mesh, run on this rank's
    rows and query heads (attention is independent across both;
    DTensor's einsum rules would gather around the grouped-head
    reshapes). ``q`` [B, T, H, hd] keeps its row and head shards, each
    of ``kv`` [B, S, K, hd] its row shards and any head shard (K
    dividing the axis, aligned with q's), every other dim gathered. A
    rank holding query heads [h0, h0 + n) reads KV heads h0 // G ..
    (h0 + n - 1) // G of what it holds (head h reads h // G); where its
    heads do not fall in whole groups of one size, each gets its KV
    head's copy (a group of 1: the same dots). The output keeps q's
    layout."""
    if not is_sharded(q):
        return fn(q, *kv)
    mesh = q.device_mesh
    qpl, kvpl = keep(q, {0: 0, 2: 2}), keep(kv[0], {0: 0, 2: 2})
    q = q if list(q.placements) == qpl else q.redistribute(mesh, qpl)
    kv = [x if list(x.placements) == kvpl else x.redistribute(mesh, kvpl)
          for x in kv]
    h0, n = local_range(q, 2)
    k0 = local_range(kv[0], 2)[0]
    g = q.shape[2] // kv[0].shape[2]
    reads = [(h0 + j) // g - k0 for j in range(n)]
    lo, hi = (reads[0], reads[-1] + 1) if n else (0, 0)
    grouped = n and n % (hi - lo) == 0 and reads == [
        lo + j // (n // (hi - lo)) for j in range(n)]

    def local(q, *kv):
        if not n:
            # no query heads here (28 heads on 16 ranks leave the last
            # two without): an empty output that still reads q, k and v,
            # so that backward reaches their gradients' collectives on
            # this rank as on the others (the gradients come back zero)
            out = q.new_zeros((*q.shape[:3], kv[-1].shape[-1]))
            return (out + sum(x[:, :, :0].sum() for x in (q, *kv)),)
        idx = None if grouped else torch.tensor(reads, device=q.device)
        kv = [x[:, :, lo:hi] if grouped else x.index_select(2, idx)
              for x in kv]
        return (fn(q, *kv),)

    shape = (*q.shape[:3], kv[-1].shape[-1])
    return map_local(local, mesh, [(x, x.placements) for x in (q, *kv)],
                     (qpl,), shapes=(shape,))[0]


def attn_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """Full-sequence attention (train / encoder), differentiable: the
    plain ``gqa_attention``, as ``repro.models.layers.attn_forward``."""
    b, t, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    out = per_head_shard(
        lambda q, k, v: gqa_attention(q, k, v, causal=causal,
                                      window=cfg.sliding_window), q, k, v)
    # pin: on a mesh, the gradient comes back through the head merge laid
    # out as the merged heads are
    return dense(p["wo"], pin(merge_heads(out)))


def attn_prefill(cfg: ModelConfig, p: Params, x, positions):
    """Returns (out, (k, v)) — caller stores k/v into the layer cache."""
    b, t, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    out = per_head_shard(
        lambda q, k, v: attention(q, k, v, causal=True,
                                  window=cfg.sliding_window), q, k, v)
    out = dense(p["wo"], merge_heads(out))
    if cfg.sliding_window and t > cfg.sliding_window:
        # keep only the window, rolled so position p lands at ring slot
        # p % window (the decode-side convention): torch.roll(x[:, -w:],
        # t % w, 1) as a cat of its two slices, which DTensor splits by
        # rows and heads (torch 2.11's has no sharding rule for roll)
        w, r = cfg.sliding_window, t % cfg.sliding_window
        k, v = (torch.cat([x[:, t - r:], x[:, t - w:t - r]], 1)
                for x in (k, v))
    return out, (k, v)


def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
                  layers: int | None = None,
                  device: torch.device) -> Params:
    """Contiguous zeroed KV cache [L, B, slots, K, hd] on ``device``
    (``layers`` defaults to the config's). SWA caches only the window
    (ring buffer of ``min(max_len, window)`` slots)."""
    slots = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    shape = (cfg.num_layers if layers is None else layers, batch, slots,
             cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_inputs(cfg: ModelConfig, pos, batch: int, slots: int,
                  device: torch.device):
    """A decode step's (positions [1], kv_len [B] int32, slot) for a new
    token at ``pos`` over a cache of ``slots``: built once per step,
    shared by every layer's ``attn_decode``. ``slot``, where the token's
    keys and values go, is ``pos % slots`` under SWA (the ring buffer) or
    ``pos``. ``pos`` is a host int, or a 0-d integer tensor on
    ``device``: then everything is computed on the device (the SWA
    count ``min(pos + 1, slots)`` too) and ``slot`` is a [1] int64
    tensor, so a CUDA graph of the step reads the position from memory
    and no host int is involved."""
    if isinstance(pos, torch.Tensor):
        at = pos.reshape(1).long()
        valid = at + 1
        if cfg.sliding_window:
            valid = valid.clamp(max=slots)
            at_slot = at % slots
        else:
            at_slot = at
        return at, valid.to(torch.int32).expand(batch).contiguous(), at_slot
    # ring buffer: every stored slot is within the window -> all valid
    valid = min(pos + 1, slots) if cfg.sliding_window else pos + 1
    return (torch.full((1,), pos, device=device),
            torch.full((batch,), valid, dtype=torch.int32, device=device),
            pos % slots if cfg.sliding_window else pos)


def attn_decode(cfg: ModelConfig, p: Params, x, k_cache, v_cache, slot,
                positions, kv_len):
    """One-token decode. x: [B,1,D]; caches [B,slots,K,hd]; ``slot``,
    ``positions`` and ``kv_len`` from ``decode_inputs``. The new k/v are
    written IN PLACE at ``slot``; returns (out, k_cache, v_cache) with
    the same cache tensors."""
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x, positions)
    write_slot(k_cache, slot, k[:, 0])
    write_slot(v_cache, slot, v[:, 0])
    if is_sharded(k_cache):
        out = _decode_attn_sharded(q[:, 0], k_cache, v_cache, kv_len)
    else:
        out = decode_attn(q[:, 0], k_cache, v_cache, kv_len)
    return dense(p["wo"], out.reshape(b, 1, -1)), k_cache, v_cache


def _decode_attn_sharded(q, k_cache, v_cache, kv_len):
    """``decode_attn`` on a mesh: q [B, H, hd], caches [B, S, K, hd] as
    DTensors. Each rank attends over its own shard of the cache: its
    rows, and its kv heads (with their query heads) or its slots. Over
    sharded slots each rank's softmax is partial, and the ranks combine
    their maxima and sums (flash-decoding's split-KV), as the production
    mesh shards the cache of a model whose kv heads do not divide the
    ``model`` axis (``launch.sharding.cache_spec``). The kernel has no
    split-KV form, so sharded slots decode on the CPU only: the
    dry-run's fake tensors. Where the batch leaves the batch axes idle
    (``_idle_heads``) the weighted sum of the values runs on a share of
    the heads and the output is [B, H * hd], split over those axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = k_cache.device_mesh
    q = like(k_cache, q)
    # q [B, H, hd] follows the cache's rows and kv heads (head h is in
    # kv group h // G, so a split of K is a split of H)
    qpl = [Shard({0: 0, 2: 1}[p.dim]) if isinstance(p, Shard)
           and p.dim in (0, 2) else Replicate() for p in k_cache.placements]
    if list(q.placements) != qpl:
        q = q.redistribute(mesh, qpl)
    b0, nb = local_range(k_cache, 0)
    lens = kv_len[b0:b0 + nb]
    ql, kl, vl = q.to_local(), k_cache.to_local(), v_cache.to_local()
    seq = [i for i, p in enumerate(k_cache.placements)
           if isinstance(p, Shard) and p.dim == 1]
    if not seq:
        return DTensor.from_local(decode_attn(ql, kl, vl, lens), mesh, qpl,
                                  run_check=False)
    if ql.device.type != "cpu":
        raise RuntimeError("decode attention over slot-sharded caches has "
                           "no kernel (no split-KV form); it runs on the "
                           "dry-run's CPU tensors only")
    b, h, hd = ql.shape
    s0, ns = local_range(k_cache, 1)
    kh = kl.shape[2]
    qr = ql.reshape(b, kh, h // kh, hd).float()
    lg = torch.einsum("bkgh,bskh->bkgs", qr, kl.float()) / math.sqrt(hd)
    valid = (s0 + torch.arange(ns, device=ql.device))[None, :] \
        < lens.to(ql.device)[:, None]
    lg = lg.masked_fill(~valid[:, None, None, :], -1e30)
    m = lg.amax(-1, keepdim=True)
    e = torch.exp(lg - m)

    def reduce(t, op):      # over the slot-sharding mesh dims
        pl = [Partial(op) if i in seq else p for i, p in enumerate(qpl)]
        return DTensor.from_local(t, mesh, pl, run_check=False) \
            .redistribute(mesh, qpl).to_local()

    scale = torch.exp(m - reduce(m, "max"))
    den = reduce(e.sum(-1, keepdim=True) * scale, "sum")
    idle = _idle_heads(k_cache, h, hd)
    if idle is None:
        num = reduce(torch.einsum("bkgs,bskh->bkgh", e * scale,
                                  vl.float()), "sum")
        out = (num / den).reshape(b, h, hd).to(ql.dtype)
        return DTensor.from_local(out, mesh, qpl, run_check=False)
    (h0, nh), (lo, n), opl = idle
    heads = torch.arange(h0, h0 + nh, device=ql.device)
    wts = (e * scale).reshape(b, h, ns)[:, h0:h0 + nh]
    vsel = vl.float().index_select(2, heads // (h // kh))
    num = torch.einsum("bjs,bsjd->bjd", wts, vsel).reshape(b, -1)
    num = reduce(num[:, lo - h0 * hd:lo - h0 * hd + n], "sum")
    den = den.reshape(b, h).repeat_interleave(hd, -1)[:, lo:lo + n]
    return DTensor.from_local((num / den).to(ql.dtype), mesh, opl,
                              run_check=False)


def _idle_heads(cache, h: int, hd: int):
    """The slot-sharded decode's share of the heads where the batch
    leaves the batch axes idle (``launch.sharding.width_axes`` of
    H * hd). GSPMD's chip then weights the values of gcd(H, model)-th
    of the heads (reduced h2o-danube on 4 x 4: 8 heads 2 a chip, 6
    heads 3, 12 heads 3; 8 heads on 4 x 2 and 8 x 2, 4; at full width
    32 heads 2 on both production meshes, qwen2-7b's 28 heads 7), a
    group of the batch axes' ranks the same heads. Each rank takes the
    group's heads and keeps its own (H * hd / N)-wide shard of the
    flattened output: ((first head, heads), (offset, width) of the kept
    shard, its placements: split over the batch axes); None where the
    rule does not apply."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.sharding import batch_axes, width_axes
    plan = get_mesh()
    if plan is None or "model" not in plan.axis_names:
        return None
    names = plan.axis_names
    ba = [names.index(a) for a in batch_axes(plan)]
    mesh = cache.device_mesh
    if not width_axes(plan, h * hd) or any(
            isinstance(cache.placements[i], Shard) for i in ba):
        return None
    g = math.gcd(h, mesh.size(names.index("model")))
    n, r = batch_rank(mesh, ba)
    nh = h // g
    width = h * hd // n
    opl = [Shard(1) if i in ba else Replicate() for i in range(mesh.ndim)]
    return (r // (n // g) * nh, nh), (r * width, width), opl


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def swiglu_params(gen, d_model: int, d_ff: int, dtype,
                  stack: tuple = ()) -> Params:
    return {
        "w_gate": dense_params(gen, d_model, d_ff, dtype, stack=stack),
        "w_up": dense_params(gen, d_model, d_ff, dtype, stack=stack),
        "w_down": dense_params(gen, d_ff, d_model, dtype, stack=stack),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return dense(p["w_down"],
                 F.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x))


def gelu_mlp_params(gen, d_model: int, d_ff: int, dtype) -> Params:
    return {"w_in": dense_params(gen, d_model, d_ff, dtype, bias=True),
            "w_out": dense_params(gen, d_ff, d_model, dtype, bias=True)}


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return dense(p["w_out"], F.gelu(dense(p["w_in"], x), approximate="tanh"))
