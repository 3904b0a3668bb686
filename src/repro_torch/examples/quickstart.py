"""Quickstart: BiSupervised in ~60 lines, on PyTorch.

Builds a tiny local classifier and a strong "remote" model on a synthetic
task, wires both supervisors through the cascade engine, and prints the
cost/accuracy trade-off — the paper's Figure 1 in miniature. The
counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.metrics import auc_rac, request_accuracy_curve
from repro_torch.core.supervisors import max_softmax
from repro_torch.data.synthetic import make_classification_task
from repro_torch.device import resolve_device
from repro_torch.launch.serve import train_surrogate
from repro_torch.models import surrogate as S
from repro_torch.serving import ServeConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ---- 1. a task + a small LOCAL surrogate model (paper §4.1) ---------
    vocab, seq, ncls, n = 256, 32, 4, 1024
    toks, labels, _ = make_classification_task(
        args.seed, n=n, vocab=vocab, seq_len=seq, num_classes=ncls)
    cfg = S.SurrogateConfig("local", vocab_size=vocab, max_len=seq,
                            d_model=32, num_heads=2, d_ff=32,
                            num_classes=ncls, dropout=0.0)
    params, loss = train_surrogate(cfg, toks[:512], labels[:512],
                                   steps=args.steps, seed=args.seed,
                                   device=dev)
    print(f"local model trained: loss {loss:.3f}")

    # ---- 2. the REMOTE model (here: an oracle stand-in for GPT-3) -------
    oracle = F.one_hot(torch.as_tensor(labels, device=dev).long(),
                       ncls).float() * 8.0

    # ---- 3. the cascade: local + 1st supervisor -> remote + 2nd ---------
    @torch.no_grad()
    def local_apply(x):
        return S.apply(cfg, params, x)

    eng = ServeConfig(batch_size=256, remote_fraction_budget=0.3,
                      t_remote=0.5, fused=True).build_engine(
        local_apply, lambda idx: oracle[idx[:, 0].long()], device=dev)
    out = eng.serve({"local": toks[512:768],
                     "remote": np.arange(512, 768)[:, None]})
    test_labels = labels[512:768]
    sys_acc = float((out["prediction"] == test_labels).mean())
    loc_acc = float((out["local_pred"] == test_labels).mean())
    print(f"local-only accuracy : {loc_acc:.3f}")
    print(f"cascade accuracy    : {sys_acc:.3f} "
          f"at {eng.stats.remote_fraction:.0%} remote calls "
          f"(cost saving {1 - eng.stats.remote_fraction:.0%})")

    # ---- 4. the paper's RQ1 curve on this system ------------------------
    logits = local_apply(torch.as_tensor(toks, device=dev))
    conf = max_softmax(logits).cpu().numpy()
    local_correct = logits.argmax(-1).cpu().numpy() == labels
    rac = request_accuracy_curve(conf, local_correct, np.ones_like(labels))
    auc = auc_rac(rac)
    print(f"AUC-RAC             : {auc:.3f} (random supervision = 0.5)")

    # the oracle answers every escalated row, and the 2nd supervisor
    # trusts it: the cascade can only gain on the local tier
    assert eng.stats.requests == 256
    assert eng.stats.remote_calls == int(out["escalated"].sum()) > 0
    assert sys_acc >= loc_acc
    assert 0.0 <= auc <= 1.0
    return {"local_accuracy": loc_acc, "cascade_accuracy": sys_acc,
            "remote_fraction": eng.stats.remote_fraction, "auc_rac": auc}


if __name__ == "__main__":
    main()
