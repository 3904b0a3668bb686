"""Public wrapper of the confidence gate.

Dispatches on the tensor's device: a CPU tensor goes to the plain version
(``ref.py``); a CUDA tensor launches the CUDA kernels (``kernel.py``) or
raises — no flag, variable or fallback sends a CUDA tensor to the plain
version. ``LAUNCHES`` counts the kernel launches, one per wrapper call.

A callable supervisor (e.g. a bound MDSA, paper §4.2) is scored by the
plain version on CPU tensors; on CUDA tensors it raises until its own
kernel is ported (the score kernel computes only the softmax family).

Early emit (DESIGN.md §11): pass ``emit`` and the triple is handed to
``emit(tag, conf, pred, idx)`` on the host, tagged with ``emit_tag`` (0
for None), through ``gate_fetch.emit_triple``. On CPU tensors it fires
once, synchronously, after the plain version. On CUDA tensors ``emit``
must be a ``gate_fetch.Emitter``: the triple's pinned non-blocking copy
is queued behind the select kernel and submitted to it, so the call
still returns without waiting. The returned dict then also holds
``fetch``, that copy's ``PendingTriple``: a caller that needs the triple
on the host waits on it, and no second copy is made. Emit adds a copy,
never a launch; the triple is the same with or without it.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import count_launch, refuse_grad
from repro_torch.kernels.confidence_gate import kernel
from repro_torch.kernels.confidence_gate.ref import confidence_gate_ref
from repro_torch.kernels.gate_fetch import emit_triple

LAUNCHES = {"gate_score": 0, "gate_select": 0}


def device_scalar(x, default, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """A 0-d tensor of ``dtype`` on ``device`` holding ``x`` (``default``
    for None); a tensor argument is cast, never moved across devices."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"scalar on {x.device}, expected {device}")
        return x.reshape(()).to(dtype)
    return torch.full((), default if x is None else x, dtype=dtype,
                      device=device)


def select(conf: torch.Tensor, t_local, n_valid, k: int) -> torch.Tensor:
    """Select kernel launch (CUDA conf) with its count."""
    refuse_grad("gate_select", conf)
    t = device_scalar(t_local, math.inf, torch.float32, conf.device)
    n = device_scalar(n_valid, conf.shape[0], torch.int32, conf.device)
    idx = kernel.gate_select(conf, t, n, k)
    count_launch(LAUNCHES, "gate_select")
    return idx


def confidence_gate(logits: torch.Tensor, t_local=None, n_valid=None, *,
                    supervisor="max_softmax", k: int | None = None,
                    emit=None, emit_tag=None) -> dict[str, torch.Tensor]:
    """logits [B, C] -> {conf [B] f32, pred [B] i32, idx [k] i32}.

    ``idx`` holds up to ``k`` escalation candidates: row indices ascending
    by confidence, only rows ``< n_valid`` with ``conf < t_local``
    (``t_local=None`` disables the threshold); unused slots are -1.
    ``t_local``/``n_valid`` may be numbers or 0-d tensors on the logits'
    device. ``emit``/``emit_tag``: early emit (module docstring).
    """
    b = logits.shape[0]
    k = b if k is None else min(int(k), b)
    if logits.device.type == "cpu":
        out = confidence_gate_ref(logits, t_local, n_valid,
                                  supervisor=supervisor, k=k)
    else:
        out = _gate_kernels(logits, t_local, n_valid, supervisor, k)
    if emit is not None:
        out["fetch"] = emit_triple(emit, emit_tag, out)
    return out


def _gate_kernels(logits, t_local, n_valid, supervisor, k: int):
    """The score and select kernels on CUDA logits."""
    if callable(supervisor):
        raise ValueError("the gate kernel scores the softmax family only; "
                         "a callable supervisor runs on CPU tensors")
    refuse_grad("gate_score", logits)
    conf, pred = kernel.gate_score(logits, supervisor)
    count_launch(LAUNCHES, "gate_score")
    return {"conf": conf, "pred": pred,
            "idx": select(conf, t_local, n_valid, k)}
