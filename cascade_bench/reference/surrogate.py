"""The plain reference of the local tier, and the harness's trainer for it.

The paper's local model: one transformer block over the input-domain-
reduced tokens (token and position embeddings, pre-LayerNorm multi-head
attention over the non-pad tokens, a tanh-GELU MLP), mean pooling over
the non-pad tokens, a ReLU dense layer and the class logits. The
parameters are in the port's layout (``models/surrogate.py``): ``embed``
[V, D], ``pos`` [T, D], ``blocks`` [{"ln1_w", "ln1_b", "ln2_w", "ln2_b",
"wq", "wk", "wv", "wo" {"w"}, "mlp" {"w_in", "w_out" {"w", "b"}}}],
``hidden`` and ``out`` {"w", "b"}; fp32, dense weights [d_in, d_out].

``prec="tf32"`` is the control: every matrix product's operands rounded
to TF32's 10-bit mantissa, the precision below the local tier's fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cascade_bench.reference import no_tf32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest on TF32's 10-bit mantissa, kept in fp32."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _rounder(prec: str):
    if prec == "fp32":
        return lambda x: x
    if prec == "tf32":
        return tf32
    raise ValueError(f"unknown precision {prec!r}")


def init(spec: dict, gen: torch.Generator) -> dict:
    """Random fp32 parameters for ``spec`` (the mix's ``local`` entry:
    vocab, max_len, d_model, num_heads, d_ff, num_classes) on the
    generator's device."""
    d, f, dev = spec["d_model"], spec["d_ff"], gen.device

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def dense(d_in, d_out, bias=False):
        p = {"w": normal(d_in, d_out, scale=1 / math.sqrt(d_in))}
        if bias:
            p["b"] = torch.zeros(d_out, device=dev)
        return p

    return {
        "embed": normal(spec["vocab"], d, scale=0.02),
        "pos": normal(spec["max_len"], d, scale=0.02),
        "hidden": dense(d, f, bias=True),
        "out": dense(f, spec["num_classes"], bias=True),
        "blocks": [{
            "ln1_w": torch.ones(d, device=dev),
            "ln1_b": torch.zeros(d, device=dev),
            "ln2_w": torch.ones(d, device=dev),
            "ln2_b": torch.zeros(d, device=dev),
            "wq": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
            "wo": dense(d, d),
            "mlp": {"w_in": dense(d, f, bias=True),
                    "w_out": dense(f, d, bias=True)},
        }],
    }


def _ln(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def logits(spec: dict, params: dict, tokens: torch.Tensor,
           prec: str = "fp32") -> torch.Tensor:
    """tokens [B, T] (0 pads) -> class logits [B, C] in fp32."""
    r = _rounder(prec)

    def dense(p, x):
        y = r(x) @ r(p["w"])
        return y + p["b"] if "b" in p else y

    with no_tf32():
        tokens = tokens.long()
        mask = tokens > 0
        b, t = tokens.shape
        x = F.embedding(tokens, params["embed"]) + params["pos"][:t]
        h_n = spec["num_heads"]
        for bp in params["blocks"]:
            h = _ln(x, bp["ln1_w"], bp["ln1_b"])
            d = h.shape[-1]
            q, k, v = (dense(bp[n], h).view(b, t, h_n, d // h_n)
                       for n in ("wq", "wk", "wv"))
            s = torch.einsum("bthd,bshd->bhts", r(q), r(k)) / math.sqrt(
                d // h_n)
            s = s.masked_fill(~mask[:, None, None, :], -1e30)
            o = torch.einsum("bhts,bshd->bthd", r(torch.softmax(s, -1)),
                             r(v)).reshape(b, t, d)
            x = x + dense(bp["wo"], o)
            h = _ln(x, bp["ln2_w"], bp["ln2_b"])
            x = x + dense(bp["mlp"]["w_out"], F.gelu(
                dense(bp["mlp"]["w_in"], h), approximate="tanh"))
        pooled = (x * mask[..., None]).sum(1) / mask.sum(
            -1, keepdim=True).clamp(min=1)
        return dense(params["out"], torch.relu(dense(params["hidden"],
                                                     pooled)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def train(spec: dict, tokens: torch.Tensor, labels: torch.Tensor,
          seed: int) -> dict:
    """Adam on the cross-entropy of ``logits``, full batch, from weights
    drawn with ``seed`` on the tokens' device: ``spec``'s ``train_steps``
    steps at learning rate ``lr``. Returns the trained parameters,
    detached."""
    gen = torch.Generator(tokens.device).manual_seed(int(seed))
    params = init(spec, gen)
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=spec["lr"])
    for _ in range(spec["train_steps"]):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(logits(spec, params, tokens), labels.long())
        loss.backward()
        opt.step()
    for p in leaves:
        p.requires_grad_(False)
    return params
