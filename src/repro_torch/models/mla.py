"""Multi-head Latent Attention (DeepSeek-V2), in PyTorch: the function of
``repro.models.mla``.

Train and prefill compute the naive (up-projected) form: keys and values
are expanded from the kv_norm'd latent ``c_kv`` and attended with one
roped key ``k_rope`` shared by all heads. Decode computes the absorbed
form: W_uk is folded into the query, so the scores run in latent space
against the cache, and W_uv is applied after the weighting. The cache
holds only ``c_kv [L, B, S, r]`` and ``k_rope [L, B, S, dr]``:
``r + dr`` values a token and layer (576 for deepseek-v2-lite, against
2 x 16 x 128 = 4096 for its heads as plain keys and values).

Products are bf16 with fp32 accumulation, as the JAX package's default
branch computes them (``preferred_element_type=float32``): the operands
go to fp32, where a bf16 product is exact, and the scores, softmax and
weighted sums stay fp32 until the value rounds back to the activations'
dtype. Scale ``1/sqrt(dn + dr)``. Plain PyTorch throughout: JAX runs
MLA in jnp, with no Pallas kernel.

``mla_decode`` writes the new token's latent and rope key into the cache
in place (JAX returns new caches; the port returns the same tensors).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (Params, apply_rope, dense,
                                       dense_params, rms_norm, scores_fp32)
from repro_torch.models.shard_hints import (is_sharded, keep, map_local,
                                            merge_heads, rows, split_heads)


def mla_params(gen: torch.Generator, cfg: ModelConfig, dtype,
               stack: tuple = ()) -> Params:
    """``repro.models.mla.mla_params``'s tree (queries full rank, as in
    V2-Lite); ``stack`` prepends leading dims."""
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r, d = cfg.kv_lora_rank, cfg.d_model
    return {
        "wq": dense_params(gen, d, h * (dn + dr), dtype, stack=stack),
        "w_dkv": dense_params(gen, d, r, dtype, stack=stack),
        "kv_norm": torch.ones((*stack, r), dtype=dtype, device=gen.device),
        "w_uk": dense_params(gen, r, h * dn, dtype, stack=stack),
        "w_uv": dense_params(gen, r, h * dv, dtype, stack=stack),
        "w_kr": dense_params(gen, d, dr, dtype, stack=stack),
        "wo": dense_params(gen, h * dv, d, dtype, stack=stack),
    }


def _split_q(cfg: ModelConfig, q: torch.Tensor):
    b, t, _ = q.shape
    dn = cfg.qk_nope_head_dim
    q = split_heads(q, cfg.num_heads, dn + cfg.qk_rope_head_dim, split=True)
    return q[..., :dn], q[..., dn:]


def _latents(cfg: ModelConfig, p: Params, x, positions):
    """(c_kv [B, T, r], k_rope [B, T, 1, dr]): exactly what is cached."""
    # on a mesh: the latent whole on every rank of a row shard, so the
    # head projections split it cleanly
    c_kv = rms_norm(rows(dense(p["w_dkv"], x), stream=False), p["kv_norm"],
                    cfg.norm_eps)
    k_r = dense(p["w_kr"], x)[:, :, None, :]    # one rope key for all heads
    return c_kv, apply_rope(k_r, positions, cfg.rope_theta)


def _scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def mla_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, positions, *,
                causal: bool = True, q_chunk: int = 1024):
    """Naive full-sequence MLA (train / prefill), differentiable, in
    query chunks of ``q_chunk`` rows. x: [B, T, D] -> (out [B, T, D],
    (c_kv [B, T, r], k_rope [B, T, dr]))."""
    b, t, _ = x.shape
    h, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    if t > q_chunk and t % q_chunk:
        raise ValueError(f"sequence length {t} is not a multiple of the "
                         f"query chunk {q_chunk}")
    q_n, q_r = _split_q(cfg, dense(p["wq"], x))
    q_r = apply_rope(q_r, positions, cfg.rope_theta)
    c_kv, k_r = _latents(cfg, p, x, positions)
    # on a mesh the heads of q, k and v stay split alike, unevenly where
    # they do not divide the axis (layers._qkv)
    k_n = split_heads(dense(p["w_uk"], c_kv), h, dn, split=True)
    v = split_heads(dense(p["w_uv"], c_kv), h, dv, split=True)

    def attend(q_n, q_r, k_n, k_r, v):
        return (_attend(cfg, q_n, q_r, k_n, k_r, v, causal, q_chunk),)

    if is_sharded(q_n):
        # on a mesh: each rank attends over its own rows and heads; the
        # rope key (one for all heads) follows the rows only
        pl = keep(q_n, {0: 0, 2: 2})
        out = map_local(attend, q_n.device_mesh,
                        [(q_n, pl), (q_r, pl), (k_n, pl),
                         (k_r, keep(q_n, {0: 0})), (v, pl)], (pl,),
                        shapes=((b, t, h, dv),))[0]
    else:
        out = attend(q_n, q_r, k_n, k_r, v)[0]
    return dense(p["wo"], merge_heads(out)), (c_kv, k_r[:, :, 0, :])


def _attend(cfg: ModelConfig, q_n, q_r, k_n, k_r, v, causal: bool,
            q_chunk: int):
    """The naive form's attention: q_n, k_n [B, T, H, dn], q_r [B, T, H,
    dr], k_r [B, T, 1, dr], v [B, T, H, dv] -> [B, T, H, dv]."""
    t = q_n.shape[1]
    k_n, k_rf, scale = k_n.float(), k_r.float(), _scale(cfg)
    kv_pos = torch.arange(t, device=q_n.device)
    outs = []
    for c0 in range(0, t, q_chunk):
        sl = slice(c0, c0 + q_chunk)
        qn, qr = q_n[:, sl].float(), q_r[:, sl].float()
        lg = (torch.einsum("btnd,bsnd->bnts", qn, k_n)
              + torch.einsum("btnd,bsod->bnts", qr, k_rf)) * scale
        if causal:
            q_pos = c0 + torch.arange(qn.shape[1], device=q_n.device)
            m = kv_pos[None, :] <= q_pos[:, None]
            lg = torch.where(m[None, None], lg,
                             torch.tensor(-1e30, device=q_n.device))
        w = torch.softmax(lg, -1)
        if not scores_fp32():       # the fp32-score ablation keeps w fp32
            w = w.to(v.dtype).float()
        outs.append(torch.einsum("bnts,bsnd->btnd", w,
                                 v.float()).to(q_n.dtype))
    return torch.cat(outs, 1)


def make_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
                   layers: int | None = None,
                   device: torch.device) -> Params:
    """Zeroed latent cache {"c_kv" [L, B, S, r], "k_rope" [L, B, S, dr]}
    on ``device`` (``layers`` defaults to the config's)."""
    n_l = cfg.num_layers if layers is None else layers
    return {
        "c_kv": torch.zeros((n_l, batch, max_len, cfg.kv_lora_rank),
                            dtype=dtype, device=device),
        "k_rope": torch.zeros((n_l, batch, max_len, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device),
    }


def mla_decode(cfg: ModelConfig, p: Params, x, c_kv_cache, kr_cache,
               pos: int, positions):
    """Absorbed one-token decode. x: [B, 1, D]; c_kv_cache [B, S, r];
    kr_cache [B, S, dr]; pos: the token's absolute position, with
    ``positions`` = [pos] on the device. The new latent and rope key are
    written IN PLACE at slot ``pos``; returns (out, c_kv_cache,
    kr_cache) with the same cache tensors."""
    b = x.shape[0]
    h, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    q_n, q_r = _split_q(cfg, dense(p["wq"], x))           # [B, 1, h, dn/dr]
    q_r = apply_rope(q_r, positions, cfg.rope_theta)
    c_kv, k_r = _latents(cfg, p, x, positions)
    c_kv_cache[:, pos] = c_kv[:, 0]
    kr_cache[:, pos] = k_r[:, 0, 0]
    dt = c_kv_cache.dtype
    # absorb: q_lat [B, 1, h, r] = q_n W_uk^T per head, fp32 accumulation
    w_uk = p["w_uk"]["w"].reshape(r, h, dn)
    q_lat = torch.einsum("bthd,rhd->bthr", q_n.float(), w_uk.float())
    cache = c_kv_cache.float()
    lg = (torch.einsum("bthr,bsr->bhts", q_lat.to(dt).float(), cache)
          + torch.einsum("bthd,bsd->bhts", q_r.float(), kr_cache.float())
          ) * _scale(cfg)
    valid = torch.arange(cache.shape[1], device=x.device) < pos + 1
    lg = torch.where(valid, lg, torch.tensor(-1e30, device=x.device))
    w = torch.softmax(lg, -1)
    ctx = torch.einsum("bhts,bsr->bthr", w.to(dt).float(), cache)
    w_uv = p["w_uv"]["w"].reshape(r, h, dv)
    out = torch.einsum("bthr,rhd->bthd", ctx.to(w_uv.dtype).float(),
                       w_uv.float())
    out = dense(p["wo"], out.reshape(b, 1, h * dv).to(x.dtype))
    return out, c_kv_cache, kr_cache
