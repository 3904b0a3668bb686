"""Cascade serving example — the wildlife-camera story (paper Example 4.1)
as a runnable system, on PyTorch.

A stream of synthetic "camera frames" (easy / rare / invalid) flows
through the full BiSupervised stack: local surrogate + MaxSoftmax
1st-level supervisor -> escalation -> remote tier (a real reduced yi-6b)
+ 2nd-level supervisor -> fallback ("notify the ranger"). The
counterpart of ``examples/serve_cascade.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_cascade [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.core.supervisors import max_softmax
from repro_torch.core.thresholds import nominal_quantile_threshold
from repro_torch.data.synthetic import make_classification_task
from repro_torch.device import resolve_device
from repro_torch.launch.serve import train_surrogate
from repro_torch.models import surrogate as S
from repro_torch.models import transformer as T
from repro_torch.serving import ServeConfig
from repro_torch.serving.engine import CostModel
from repro_torch.serving.scheduler import Request

NCLS = 5    # no-animal, deer, wolf, human, beaver
CLASSES = ["no-animal", "deer", "wolf", "human", "beaver"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)

    # ---- data: nominal frames + rare (hard) + invalid (mud on the lens) -
    vocab, seq = 256, 24
    toks, labels, _ = make_classification_task(
        3, n=1024, vocab=vocab, seq_len=seq, num_classes=NCLS)
    invalid = rng.random(1024) < 0.08
    toks[invalid] = rng.integers(vocab - 8, vocab, (invalid.sum(), seq))

    # ---- local tier: tiny surrogate trained on nominal frames only ------
    cfg = S.SurrogateConfig("camera", vocab_size=vocab, max_len=seq,
                            d_model=32, num_heads=2, d_ff=48,
                            num_classes=NCLS, dropout=0.1)
    nominal = ~invalid[:512]
    params, loss = train_surrogate(cfg, toks[:512][nominal],
                                   labels[:512][nominal], steps=args.steps,
                                   seed=args.seed, device=dev)
    print(f"[camera] local model trained (loss {loss:.3f})")

    # ---- remote tier: a real (reduced) yi-6b with an accurate task head -
    rcfg = get_config("yi-6b").reduced()
    rparams = T.init_params(rcfg, torch.Generator(dev).manual_seed(
        args.seed + 9))
    oracle = F.one_hot(torch.as_tensor(labels, device=dev).long(),
                       NCLS).float() * 6.0
    # the remote model CANNOT solve invalid frames either (paper: mud) —
    # its oracle head goes flat there
    oracle = torch.where(torch.as_tensor(invalid, device=dev)[:, None],
                         0.05 * oracle, oracle)

    @torch.no_grad()
    def local_apply(x):
        return S.apply(cfg, params, x)

    @torch.no_grad()
    def remote_apply(batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        idx = torch.as_tensor(batch["idx"], device=dev).long()
        logits, _ = T.prefill(rcfg, rparams, {"tokens": tokens})
        return oracle[idx[:, 0]] + 0.02 * logits[:, :NCLS].float()

    # ---- calibrate the 2nd supervisor on a nominal validation set (§4.5)
    rem = remote_apply({"tokens": toks[512:640] % rcfg.vocab_size,
                        "idx": np.arange(512, 640)[:, None]})
    rem_conf = max_softmax(rem).cpu().numpy()
    t_remote = nominal_quantile_threshold(rem_conf[~invalid[512:640]], 0.05)

    ranger_notifications = []
    eng, sched = ServeConfig(
        batch_size=64, remote_fraction_budget=0.35, t_remote=t_remote,
        cost=CostModel(), fused=True,
    ).build(local_apply, remote_apply,
            fallback=lambda req: ranger_notifications.append(req.uid) or -1,
            device=dev)

    # ---- serve the last 256 frames --------------------------------------
    for i in range(768, 1024):
        sched.submit(Request(
            uid=i, local_input=toks[i],
            remote_input={"tokens": toks[i] % rcfg.vocab_size,
                          "idx": np.array([i], np.int32)}))
    responses = sched.flush()

    by_src = {"local": [], "remote": [], "fallback": []}
    for r in responses:
        by_src[r.source].append(r)
    acc = {s: np.mean([r.prediction == labels[r.uid] for r in rs])
           if rs else float("nan") for s, rs in by_src.items()}
    inv_rate = {s: np.mean([invalid[r.uid] for r in rs]) if rs else 0.0
                for s, rs in by_src.items()}
    routing = {k: len(v) for k, v in by_src.items()}
    print(f"[camera] routing: {routing}")
    print(f"[camera] accuracy by source: local={acc['local']:.2f} "
          f"remote={acc['remote']:.2f}")
    print(f"[camera] invalid-frame share: local={inv_rate['local']:.2f} "
          f"remote={inv_rate['remote']:.2f} "
          f"fallback={inv_rate['fallback']:.2f} "
          f"(mud ends up at the ranger, as designed)")
    print(f"[camera] {len(ranger_notifications)} ranger notifications")
    st = eng.stats
    print(f"[camera] cost: ${st.total_cost:.4f} vs remote-only "
          f"${st.requests * eng.cost.remote_cost_per_request:.4f} "
          f"({1 - st.remote_fraction:.0%} saved); "
          f"mean latency {(st.mean_latency_s or 0.0) * 1e3:.0f}ms vs "
          f"{eng.cost.remote_latency_s * 1e3:.0f}ms remote-only")

    assert sorted(r.uid for r in responses) == list(range(768, 1024))
    assert sum(routing.values()) == st.requests == 256
    assert len(ranger_notifications) == routing["fallback"] == st.rejected
    assert routing["remote"] + routing["fallback"] == st.escalations > 0
    return {"routing": routing, "ranger_notifications":
            len(ranger_notifications), "total_cost": st.total_cost,
            "invalid_share": inv_rate}


if __name__ == "__main__":
    main()
