"""Mamba2 (SSD) mixer, in PyTorch — the backbone block of Zamba2.

Scalar-decay state-space duality form, per head (head dim P, state N):
    h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t B_t^T     (h in R^{P x N})
    y_t = h_t C_t + D * x_t
with a < 0 learned per head, dt_t = softplus(dt_proj(u_t) + dt_bias) per
head, B_t, C_t in R^N shared across the head's channels, a depthwise
causal conv (width 4) on x and on (B, C), and a SiLU gate z. The state
is O(1) in the sequence length.

Same parameter tree and numerics as ``repro.models.mamba2``: the
in-projections unfused by role (``w_zx``, ``w_bc``, ``w_dt``); the
``d_inner`` channel axis flattened P-major (index ``p * h + head``), so
``w_zx``, the conv weights, ``out_norm`` and ``w_out`` carried over from
JAX line up; the conv state cast to the input's dtype and its four taps
summed in that dtype, in tap order, its new state returned in fp32; dt,
the decay, the SSM state [B, H, P, N] and y in fp32. JAX runs the
recurrence with ``lax.scan`` and no Pallas kernel; the port runs it as a
per-token loop in plain PyTorch (differentiable: the train path runs the
same function under autograd).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.shard_hints import (constrain, is_sharded, keep,
                                            local, map_local, pin, stepwise)
from repro_torch.models.layers import (Params, dense, dense_params, normal,
                                       rms_norm)

CONV_W = 4
HEAD_P = 64  # mamba2 head dim


def dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, heads, state dim N)."""
    d_inner = 2 * cfg.d_model
    return d_inner, d_inner // HEAD_P, cfg.ssm_state_dim


def mamba2_params(gen: torch.Generator, cfg: ModelConfig, dtype,
                  stack: tuple = ()) -> Params:
    """``stack`` prepends leading dims (``(L,)`` for stacked blocks); the
    per-head ``a_log``, ``dt_bias`` and ``d_skip`` are fp32, as in
    JAX."""
    d, dev = cfg.d_model, gen.device
    d_inner, h, n = dims(cfg)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    return {
        "w_zx": dense_params(gen, d, 2 * d_inner, dtype, stack=stack),
        "w_bc": dense_params(gen, d, 2 * n, dtype, stack=stack),
        "w_dt": dense_params(gen, d, h, dtype, stack=stack),
        "conv_x_w": normal(gen, (*stack, CONV_W, d_inner), dtype, 0.1),
        "conv_x_b": torch.zeros((*stack, d_inner), dtype=dtype, device=dev),
        "conv_bc_w": normal(gen, (*stack, CONV_W, 2 * n), dtype, 0.1),
        "conv_bc_b": torch.zeros((*stack, 2 * n), dtype=dtype, device=dev),
        "a_log": a_log.expand(*stack, h).clone(),
        "dt_bias": torch.zeros((*stack, h), device=dev),
        "d_skip": torch.ones((*stack, h), device=dev),
        "out_norm": torch.ones((*stack, d_inner), dtype=dtype, device=dev),
        "w_out": dense_params(gen, d_inner, d, dtype, stack=stack),
    }


def mamba2_state(cfg: ModelConfig, batch: int, layers: int | None = None,
                 device: torch.device | None = None) -> Params:
    """Zeroed fp32 state {"ssm" [L, B, H, P, N], "conv_x" [L, B, 3,
    d_inner], "conv_bc" [L, B, 3, 2N]} (``layers`` defaults to the
    config's)."""
    n_l = cfg.num_layers if layers is None else layers
    d_inner, h, n = dims(cfg)

    def zeros(*shape):
        return torch.zeros((n_l, batch, *shape), device=device)

    return {"ssm": zeros(h, HEAD_P, n), "conv_x": zeros(CONV_W - 1, d_inner),
            "conv_bc": zeros(CONV_W - 1, 2 * n)}


def _in_proj(w, x, d_inner: int):
    """(z, xi), the two halves of ``x @ w`` (``w_zx``), each split over
    ``model`` on a mesh where w's columns are. The halves of a product
    split over ``model`` lie on different ranks (z on the first half of
    them), and DTensor gathers the whole product to slice it; GSPMD
    moves the pieces by collective-permutes instead. The port moves the
    smaller operand: where a rank's shard of w is smaller than its
    share of the product (a prefill or a train step), w's halves are
    taken first, each laid out split over ``model``, and multiplied
    apart; else (a decode step's few rows) the product is sliced."""
    xs, ws = local(x), local(w)
    if is_sharded(w) and ws.numel() < xs.numel() // xs.shape[-1] \
            * ws.shape[-1]:
        return tuple(pin(dense({"w": constrain(w[..., lo:lo + d_inner],
                                               None, "model")}, x))
                     for lo in (0, d_inner))
    zx = pin(dense({"w": w}, x))
    return zx[..., :d_inner], zx[..., d_inner:]


def _conv(w, b, xbc, conv_state):
    """Depthwise causal conv of width 4. xbc: [B, T, C]; conv_state:
    [B, 3, C] fp32. Returns (silu(conv + b), the new state in fp32)."""
    t = xbc.shape[1]
    x_pad = torch.cat([conv_state.to(xbc.dtype), xbc], 1)
    out = x_pad[:, :t] * w[0]
    for i in range(1, CONV_W):
        out = out + x_pad[:, i:i + t] * w[i]
    return F.silu(out + b), x_pad[:, -(CONV_W - 1):].float()


@stepwise(4)
def _ssd(decay, dtx, bb, cc, s):
    """The SSD recurrence token by token: decay [B, T, H], dtx [B, T, H,
    P], bb/cc [B, T, N] fp32, s [B, H, P, N] -> (y [B, T, H, P], s_T)."""
    ys = []
    for i in range(dtx.shape[1]):
        upd = dtx[:, i, :, :, None] * bb[:, i, None, None, :]  # [B,H,P,N]
        s = decay[:, i, :, None, None] * s + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, cc[:, i]))
    return torch.stack(ys, 1), s


def mamba2_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   state: Params | None = None):
    """Full-sequence SSD mixer. x: [B, T, D] -> (y [B, T, D], final state
    {"ssm" [B, H, P, N], "conv_x", "conv_bc"}). ``state``: the initial
    state of that form (one layer's), zeros if None (a fresh sequence);
    it is read, never written."""
    b, t, _ = x.shape
    d_inner, h, n = dims(cfg)
    # pin: on a mesh, the gradients through the conv's slices along the
    # sequence come back laid out as these projections are
    z, xi = _in_proj(p["w_zx"]["w"], x, d_inner)
    bc = pin(dense(p["w_bc"], x))
    dt = pin(dense(p["w_dt"], x))
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = {"ssm": torch.zeros((b, h, HEAD_P, n), **f32),
                 "conv_x": torch.zeros((b, CONV_W - 1, d_inner), **f32),
                 "conv_bc": torch.zeros((b, CONV_W - 1, 2 * n), **f32)}
    # JAX's hint on xi, which GSPMD carries back through the conv: the
    # conv is per channel, so on a mesh it runs on xi's d_inner split
    # over ``model``, with its weights and state split to match.
    # d_inner is flattened P-major (index = p * h + head): the
    # column-parallel shards of w_zx line up with the P-sharding of the
    # recurrence (JAX's hints, kept where JAX has them)
    xi = constrain(xi, "data", None, "model")
    xi, conv_x = _conv(constrain(p["conv_x_w"], None, "model"),
                       constrain(p["conv_x_b"], "model"), xi,
                       constrain(state["conv_x"], "data", None, "model"))
    bc, conv_bc = _conv(p["conv_bc_w"], p["conv_bc_b"], bc, state["conv_bc"])
    bb, cc = bc[..., :n].float(), bc[..., n:].float()

    dt = F.softplus(dt.float() + p["dt_bias"])                # [B, T, H]
    decay = torch.exp(dt * -torch.exp(p["a_log"]))            # [B, T, H]
    x_h = xi.float().reshape(b, t, HEAD_P, h).transpose(2, 3)  # [B,T,H,P]
    x_h = constrain(x_h, "data", None, None, "model")
    dtx = dt[..., None] * x_h                                 # [B,T,H,P]
    s = constrain(state["ssm"].float(), "data", None, "model", None)
    if is_sharded(dtx):
        # on a mesh each rank runs the recurrence on its rows and its
        # shard of P (independent across both; N is reduced per rank)
        pl, rpl = keep(dtx, {0: 0, 3: 3}), keep(dtx, {0: 0})
        spl = [Shard({0: 0, 3: 2}[p.dim]) if isinstance(p, Shard) else p
               for p in pl]                       # s [B, H, P, N] alike
        ys, s = map_local(_ssd, dtx.device_mesh,
                          [(decay, rpl), (dtx, pl), (bb, rpl), (cc, rpl),
                           (s, spl)], (pl, spl))
    else:
        ys, s = _ssd(decay, dtx, bb, cc, s)
    y = ys + p["d_skip"][:, None] * x_h
    y = constrain(y, "data", None, None, "model")
    y = y.transpose(2, 3).reshape(b, t, d_inner).to(x.dtype)
    y = constrain(y, "data", None, "model")
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    return dense(p["w_out"], y), {"ssm": s, "conv_x": conv_x,
                                  "conv_bc": conv_bc}


def mamba2_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  state: Params):
    """One-token step. x: [B, 1, D]; state {"ssm" [B, H, P, N], "conv_x",
    "conv_bc"}: ``mamba2_forward`` from that state."""
    return mamba2_forward(cfg, p, x, state=state)

