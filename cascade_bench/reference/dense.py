"""The dense GQA decoder family (``"family": "dense"``): its widths, the
configuration keys it implements, the port's weight layout, the plain
fp32 forward and the model FLOPs.

The forward follows the published description of the Llama/Qwen2 block
(pre-norm RMSNorm, rotary embeddings on the two halves of the head
dimension, grouped-query causal attention with optional QKV bias, a
SwiGLU MLP, an untied head) and reads the weights in the port's layout
(``leaves``), upcast to fp32 one layer at a time so that a whole model
never needs an fp32 copy. Matrix products run with TF32 off. It imports
nothing of the program and uses no kernel, cache or batching of its own
beyond the rows it is given.

``prec="fp8"`` is the control: the same arithmetic with every matrix
product's operands (activations, weights, the attention scores'
operands and probabilities) rounded to float8 e4m3 with one scale per
tensor, the precision below the configuration's bfloat16.
"""

from __future__ import annotations

import math

import torch

from cascade_bench.reference import no_tf32

# keys the harness reads, and keys that only describe the model
READ = {"num_hidden_layers", "hidden_size", "num_attention_heads",
        "num_key_value_heads", "head_dim", "intermediate_size",
        "vocab_size", "rms_norm_eps", "rope_theta", "qkv_bias",
        "torch_dtype"}
ABOUT = {"name", "family", "source", "paper", "reduced", "architectures",
         "weights", "max_position_embeddings"}
# keys whose other values this family does not implement
FIXED = {"hidden_act": "silu", "tie_word_embeddings": False,
         "use_sliding_window": False}


def accept(config: dict) -> None:
    """Refuse a configuration that would run as another model: a key
    this family does not read, or a value of ``FIXED`` it does not
    implement (``sliding_window`` only beside ``use_sliding_window``
    false, where it is unused)."""
    known = READ | ABOUT | set(FIXED)
    if config.get("use_sliding_window") is False:
        known = known | {"sliding_window"}
    unknown = sorted(set(config) - known)
    other = sorted(k for k, v in FIXED.items() if config.get(k, v) != v)
    if unknown or other:
        raise ValueError(f"{config.get('name')!r}: the dense family does "
                         f"not implement {unknown + other}")


def widths(config: dict) -> dict:
    """The sizes the reference and the harness use, from a
    ``configs/*.json`` dict (Hugging Face key names)."""
    d, h = config["hidden_size"], config["num_attention_heads"]
    return {"layers": config["num_hidden_layers"], "d_model": d,
            "heads": h, "kv_heads": config["num_key_value_heads"],
            "head_dim": config.get("head_dim", d // h),
            "d_ff": config["intermediate_size"],
            "vocab": config["vocab_size"], "eps": config["rms_norm_eps"],
            "rope_theta": config["rope_theta"],
            "qkv_bias": bool(config.get("qkv_bias", False)),
            "dtype": config["torch_dtype"]}


def port_fields(config: dict) -> dict:
    """The fields of the port's ``ModelConfig`` that run this model."""
    w = widths(config)
    return {"name": config["name"], "family": "dense",
            "num_layers": w["layers"], "d_model": w["d_model"],
            "num_heads": w["heads"], "num_kv_heads": w["kv_heads"],
            "d_ff": w["d_ff"], "vocab_size": w["vocab"],
            "head_dim": w["head_dim"], "attn_bias": w["qkv_bias"],
            "rope_theta": w["rope_theta"], "norm_eps": w["eps"],
            "dtype": w["dtype"]}


def leaves(w: dict) -> list:
    """The port's layout (``models/transformer.py``'s ``init_params`` for
    a dense decoder), as (path, shape, scale) of every leaf: ``embed``
    [V, D], ``final_norm`` [D], ``head`` {"w" [D, V]}, and ``blocks``
    stacked over the L layers with ``norm1``/``norm2`` [L, D], ``attn``
    {"wq", "wk", "wv" {"w" [L, D, out], "b" [L, out] with QKV bias},
    "wo" {"w"}} and ``mlp`` {"w_gate", "w_up", "w_down" {"w"}}. Dense
    weights are [d_in, d_out] (y = x @ w + b). A scale "norm" or "bias"
    marks the leaves drawn around 1 or 0, a number the others'
    standard deviation."""
    L, D, F, V = w["layers"], w["d_model"], w["d_ff"], w["vocab"]
    q, kv = w["heads"] * w["head_dim"], w["kv_heads"] * w["head_dim"]
    out = [(("embed",), (V, D), 0.02),
           (("final_norm",), (D,), "norm"),
           (("head", "w"), (D, V), 1 / math.sqrt(D)),
           (("blocks", "norm1"), (L, D), "norm"),
           (("blocks", "norm2"), (L, D), "norm")]
    for name, d_in, d_out in (("wq", D, q), ("wk", D, kv), ("wv", D, kv),
                              ("wo", q, D)):
        out.append((("blocks", "attn", name, "w"), (L, d_in, d_out),
                    1 / math.sqrt(d_in)))
        if w["qkv_bias"] and name != "wo":
            out.append((("blocks", "attn", name, "b"), (L, d_out), "bias"))
    for name, d_in, d_out in (("w_gate", D, F), ("w_up", D, F),
                              ("w_down", F, D)):
        out.append((("blocks", "mlp", name, "w"), (L, d_in, d_out),
                    1 / math.sqrt(d_in)))
    return out


def _proj_flops_per_token(w: dict) -> float:
    """2 x the layers' matrix parameters: Q, K, V, O and the SwiGLU."""
    D, F = w["d_model"], w["d_ff"]
    q, kv = w["heads"] * w["head_dim"], w["kv_heads"] * w["head_dim"]
    return 2.0 * w["layers"] * (D * (q + 2 * kv) + q * D + 3 * D * F)


def attn_flops(w: dict, rows: int, q_len: int, kv_start: int = 0) -> float:
    """Scores and the probability-value product, all layers, for
    ``q_len`` causal queries at positions kv_start .. kv_start + q_len - 1:
    4 x heads x head_dim x (keys each query sees)."""
    keys = q_len * kv_start + q_len * (q_len + 1) / 2
    return 4.0 * w["layers"] * rows * w["heads"] * w["head_dim"] * keys


def head_flops(w: dict, rows: int) -> float:
    return 2.0 * rows * w["d_model"] * w["vocab"]


def prefill_flops(w: dict, rows: int, t: int) -> float:
    """A prefill of ``rows`` prompts of ``t`` tokens that returns the last
    position's logits (the port's ``transformer.prefill``)."""
    return (rows * t * _proj_flops_per_token(w) + attn_flops(w, rows, t)
            + head_flops(w, rows))


def decode_flops(w: dict, rows: int, pos: int) -> float:
    """One decode step of ``rows`` sequences, the new token at ``pos``
    (attending to pos + 1 keys), with the full-vocabulary head."""
    return (rows * _proj_flops_per_token(w)
            + attn_flops(w, rows, 1, kv_start=pos) + head_flops(w, rows))


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to 448), back in fp32."""
    s = x.abs().amax().float().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _rounder(prec: str):
    if prec == "fp32":
        return lambda x: x
    if prec == "fp8":
        return fp8
    raise ValueError(f"unknown precision {prec!r}")


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """x [B, T, heads, hd]; rotates the two halves of hd."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = (positions.float()[:, None] * freqs)[None, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _layer(w, lp, x, positions, r):
    b, t, _ = x.shape
    H, K, hd = w["heads"], w["kv_heads"], w["head_dim"]
    attn = lp["attn"]

    def proj(name, h):
        y = r(h) @ r(attn[name]["w"])
        return y + attn[name]["b"] if "b" in attn[name] else y

    h = rms_norm(x, lp["norm1"], w["eps"])
    q = rope(proj("wq", h).view(b, t, H, hd), positions, w["rope_theta"])
    k = rope(proj("wk", h).view(b, t, K, hd), positions, w["rope_theta"])
    v = proj("wv", h).view(b, t, K, hd)
    q = q.view(b, t, K, H // K, hd)
    s = torch.einsum("btkgh,bskh->bkgts", r(q), r(k)) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.softmax(s, -1)
    o = torch.einsum("bkgts,bskh->btkgh", r(p), r(v)).reshape(b, t, H * hd)
    x = x + r(o) @ r(attn["wo"]["w"])
    h = r(rms_norm(x, lp["norm2"], w["eps"]))
    mlp = lp["mlp"]
    g = torch.nn.functional.silu(h @ r(mlp["w_gate"]["w"]))
    u = h @ r(mlp["w_up"]["w"])
    return x + r(g * u) @ r(mlp["w_down"]["w"])


def _layer_params(blocks: dict, i: int) -> dict:
    return {k: (_layer_params(v, i) if isinstance(v, dict)
                else v[i].float())
            for k, v in blocks.items()}


@torch.no_grad()
def logits(config: dict, params: dict, tokens: torch.Tensor,
           positions, prec: str = "fp32") -> torch.Tensor:
    """tokens [B, T] (on the weights' device) -> fp32 logits
    [B, len(positions), V] at the given positions (the last one is T - 1).
    Layer by layer, each layer's weights upcast on its own."""
    w = widths(config)
    r = _rounder(prec)
    with no_tf32():
        tokens = tokens.long()
        t = tokens.shape[1]
        pos = torch.arange(t, device=tokens.device)
        x = params["embed"][tokens].float()
        for i in range(w["layers"]):
            x = _layer(w, _layer_params(params["blocks"], i), x, pos, r)
        x = rms_norm(x[:, list(positions)], params["final_norm"].float(),
                     w["eps"])
        return r(x) @ r(params["head"]["w"].float())

