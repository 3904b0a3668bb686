"""Training entry point on PyTorch and one GPU.

The port of ``repro.launch.train`` for one device: the same flags
(``--arch`` defaults to yi-6b, where JAX requires it), the same
synthetic batch stream, warmup and schedule, the same remat'd train
step and the same log line, plus ``--device {cuda,cpu}`` (default
``cuda``; a missing GPU is an error, never a quiet fallback to the CPU).
Parameters are drawn on the device from ``torch.Generator(device)
.manual_seed(0)``; the step updates them and the optimizer state in place
(JAX's launcher donates their buffers). ``--mesh data,model`` trains on
a mesh of devices, one process a device (``torchrun``; a group of one
without it): the parameters and moments are DTensors laid out by
``launch.sharding``'s rules (FSDP past 8 devices, as JAX's launcher
decides), each batch is sharded over ``data`` (``data.pipeline
.shard_batch``), and the step and AdamW run on them. The sizes must
multiply to the number of processes, or it raises ``ValueError``.

``main`` is ``parse_args`` -> ``setup`` (config, parameters, optimizer
state, step function) -> the loop over ``make_batches``; callers that
time or inspect the steps (the chip smoke test) make those calls
themselves.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        --steps 20
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --device cpu --smoke --steps 5 --mesh 2,1
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        --device cpu --smoke --steps 50 --batch 8 --seq 128
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import shard_batch
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import Mesh, batch_axes, device_mesh
from repro_torch.models import transformer as T
from repro_torch.models.frontend import frontend_embeddings
from repro_torch.models.shard_hints import gather, use_mesh
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.tree import tree_map


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
                    help="'data,model' sizes, e.g. '2,1'; they multiply "
                         "to the number of processes (default: one "
                         "device, no mesh)")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse the flags; ``args.device`` holds the resolved
    ``torch.device``."""
    args = _parser().parse_args(argv)
    args.device = resolve_device(args.device)
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", "1")))
        if len(shape) != 2 or shape[0] * shape[1] != world:
            raise ValueError(f"--mesh {args.mesh}: the data x model sizes "
                             f"must multiply to the {world} processes")
        args.mesh = Mesh({"data": shape[0], "model": shape[1]})
    return args


def opt_config(args) -> AdamWConfig:
    """The schedule of ``repro.launch.train``: warmup a tenth of the
    steps, cosine decay over all of them."""
    return AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps)


def setup(args) -> tuple[ModelConfig, dict, dict, Callable]:
    """(cfg, params, opt_state, train_step) for ``args``: parameters
    drawn on the device, zeroed fp32 moments, the remat'd step with
    ``opt_config(args)``. With ``--mesh`` it joins the process group
    (NCCL on CUDA, gloo on the CPU), attaches the ``DeviceMesh`` to
    ``args.mesh``, lays the parameters out as DTensors (each rank draws
    the same parameters and keeps its shards), and the step shards each
    batch over ``data`` and runs under the mesh."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.mesh:
        backend = "nccl" if args.device.type == "cuda" else "gloo"
        args.mesh = device_mesh(args.mesh, backend)
        if args.device.type == "cuda":
            args.device = torch.device("cuda", torch.cuda.current_device())
    params = T.init_params(cfg, torch.Generator(args.device).manual_seed(0))
    step = make_train_step(cfg, opt_config(args), remat=True)
    if args.mesh:
        params = sh.distribute_tree(params, sh.params_shardings(
            cfg, args.mesh, fsdp=args.mesh.size > 8))
        step = mesh_step(step, args.mesh, args.device)
    return cfg, params, init_opt_state(params), step


def mesh_step(step: Callable, mesh, device) -> Callable:
    """``step`` on ``mesh``: the host batch sharded over the batch axes,
    the step run under the mesh (``shard_hints.use_mesh``)."""
    def sharded(params, opt_state, batch):
        batch = shard_batch(batch, mesh, batch_axes(mesh), device=device)
        with use_mesh(mesh):
            return step(params, opt_state, batch)
    return sharded


def log_line(step: int, m: dict[str, float], s_per_step: float) -> str:
    return (f"[train] step {step:5d} loss={m['loss']:.4f} "
            f"ce={m['ce']:.4f} acc={m['acc']:.3f} "
            f"gnorm={m['grad_norm']:.2f} lr={m['lr']:.2e} "
            f"({s_per_step:.2f}s/step)")


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg, params, opt_state, step_fn = setup(args)
    if args.mesh:
        print(f"[train] {cfg.name}: mesh {dict(args.mesh.shape)} on "
              f"{args.mesh.size} device(s) ({args.device.type})")
    else:
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
        if args.mesh:       # the whole parameters, written by rank 0
            params = tree_map(gather, params)
        if not args.mesh or dist.get_rank() == 0:
            save_checkpoint(args.checkpoint, params, step=args.steps)
            print(f"[train] saved {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
