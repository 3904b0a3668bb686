"""Training entry point on PyTorch and one GPU.

The port of ``repro.launch.train`` for one device: the same flags
(``--arch`` defaults to yi-6b, where JAX requires it), the same
synthetic batch stream, warmup and schedule, the same remat'd train
step and the same log line, plus ``--device {cuda,cpu}`` (default
``cuda``; a missing GPU is an error, never a quiet fallback to the CPU).
Parameters are drawn on the device from ``torch.Generator(device)
.manual_seed(0)``; the step updates them and the optimizer state in place
(JAX's launcher donates their buffers). ``--mesh`` (a data x model mesh
over several devices) comes with the port's mesh slice.

``main`` is ``parse_args`` -> ``setup`` (config, parameters, optimizer
state, step function) -> the loop over ``make_batches``; callers that
time or inspect the steps (the chip smoke test) make those calls
themselves.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        --device cpu --smoke --steps 50 --batch 8 --seq 128
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.frontend import frontend_embeddings
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state


def make_batches(cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0) -> Iterator[dict]:
    """Synthetic LM / classification batch stream for the smoke path, as
    ``repro.launch.train.make_batches`` draws it: one numpy generator
    seeded by ``seed`` gives the tokens (host int32 [B, T]) and an
    encoder's labels, in JAX's order, so they are JAX's to the bit; a
    VLM batch holds ``seq // 2`` patch embeddings then ``seq // 2``
    tokens, an audio batch ``seq`` frame embeddings (and labels for an
    encoder). The embeddings are ``frontend_embeddings(cfg, batch, n,
    seed)`` in every batch, as JAX's are (host tensors in the config's
    dtype; JAX's bits differ, see ``models.frontend``)."""
    rng = np.random.default_rng(seed)
    while True:
        if cfg.family == "vlm":
            half = seq // 2
            yield {"embeds": frontend_embeddings(cfg, batch, half, seed,
                                                 device="cpu"),
                   "tokens": rng.integers(1, cfg.vocab_size,
                                          (batch, half)).astype(np.int32)}
        elif cfg.takes_embeddings:
            b = {"embeds": frontend_embeddings(cfg, batch, seq, seed,
                                               device="cpu")}
            if cfg.is_encoder:
                b["labels"] = rng.integers(0, cfg.num_classes,
                                           (batch, seq)).astype(np.int32)
            yield b
        else:
            yield {"tokens": rng.integers(1, cfg.vocab_size,
                                          (batch, seq)).astype(np.int32)}


def to_device(batch: dict, dev: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (default cuda)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="",
                    help="'data,model' sizes; not ported (one device)")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse the flags; ``args.device`` holds the resolved
    ``torch.device``."""
    args = _parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: training over a mesh of devices comes with the "
            "port's mesh slice (ROADMAP.md, queue A, item 8); the port "
            "trains on one device")
    args.device = resolve_device(args.device)
    return args


def opt_config(args) -> AdamWConfig:
    """The schedule of ``repro.launch.train``: warmup a tenth of the
    steps, cosine decay over all of them."""
    return AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps)


def setup(args) -> tuple[ModelConfig, dict, dict, Callable]:
    """(cfg, params, opt_state, train_step) for ``args``: parameters
    drawn on the device, zeroed fp32 moments, the remat'd step with
    ``opt_config(args)``."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    params = T.init_params(cfg, torch.Generator(args.device).manual_seed(0))
    return (cfg, params, init_opt_state(params),
            make_train_step(cfg, opt_config(args), remat=True))


def log_line(step: int, m: dict[str, float], s_per_step: float) -> str:
    return (f"[train] step {step:5d} loss={m['loss']:.4f} "
            f"ce={m['ce']:.4f} acc={m['acc']:.3f} "
            f"gnorm={m['grad_norm']:.2f} lr={m['lr']:.2e} "
            f"({s_per_step:.2f}s/step)")


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg, params, opt_state, step_fn = setup(args)
    print(f"[train] {cfg.name}: one device ({args.device})")
    batches = make_batches(cfg, args.batch, args.seq)
    t0 = time.perf_counter()
    for i in range(args.steps):
        params, opt_state, metrics = step_fn(
            params, opt_state, to_device(next(batches), args.device))
        if (i + 1) % args.log_every == 0 or i == 0:
            # float() waits for the device, as JAX's launcher does
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            print(log_line(i + 1, m, dt / (i + 1)))
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, step=args.steps)
        print(f"[train] saved {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
