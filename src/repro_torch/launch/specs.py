"""Dry-run helpers: abstract input specs and step builders, as
``repro.launch.specs``.

Everything here works on fake tensors (``sharding.eval_shape``), so
building a step at full width allocates nothing. ``lower_step`` is the
counterpart of JAX's ``jit(...).lower(...)``: it lays the abstract
parameters, optimizer state and inputs out as DTensors on the mesh's
``DeviceMesh`` (plain fake tensors on a mesh without one: one chip) and
returns a ``Lowered`` whose ``run()`` executes the step on them, which
the dry-run and the roofline count (``analysis.roofline``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.launch import sharding as sh
from repro_torch.models import transformer as T
from repro_torch.models.shard_hints import use_mesh
from repro_torch.tree import tree_leaves, tree_map_with_path

# JAX's serving policy FSDPs when the TP-sharded weights pass 12e9 bytes a
# chip: three quarters of a TPU v5e's 16 GB. The port keeps the fraction
# and takes the H100's 80 GB (analysis.roofline.HBM_BYTES)
FSDP_HBM_FRACTION = 0.75


# --------------------------------------------------------------------------
# input specs
# --------------------------------------------------------------------------

def _fake(shape, dtype) -> torch.Tensor:
    return sh.eval_shape(lambda: torch.empty(shape, dtype=dtype))


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Fake-tensor stand-ins for every model input of this (arch,
    input-shape) pair, with JAX's shapes and dtypes.

    train/prefill: the full-sequence batch; decode: ONE new token plus a
    cache of seq_len slots and the 0-d position."""
    b, t = shape.global_batch, shape.seq_len
    dt = T.DTYPES[cfg.dtype]
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            # half image patches (frontend stub), half text
            batch = {"embeds": _fake((b, t // 2, cfg.d_model), dt),
                     "tokens": _fake((b, t // 2), torch.int32)}
        elif cfg.takes_embeddings:
            batch = {"embeds": _fake((b, t, cfg.d_model), dt)}
        else:
            batch = {"tokens": _fake((b, t), torch.int32)}
        if cfg.is_encoder and shape.kind == "train":
            batch["labels"] = _fake((b, t), torch.int32)
        return batch
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} has no decode step")
    cache = sh.eval_shape(lambda: T.make_cache(cfg, b, t, device="cpu"))
    return {"token": _fake((b,), torch.int32), "cache": cache,
            "pos": _fake((), torch.int32)}


def params_specs(cfg: ModelConfig) -> Any:
    """``init_params(cfg)``'s tree as fake tensors."""
    return sh.eval_shape(
        lambda: T.init_params(cfg, torch.Generator("cpu").manual_seed(0)))


# --------------------------------------------------------------------------
# step functions
# --------------------------------------------------------------------------

def make_steps(cfg: ModelConfig):
    """(train_step, prefill_step, decode_step) for cfg."""
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWConfig
    train_step = make_train_step(cfg, AdamWConfig(), remat=True)

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.is_encoder:
            # encoder "prefill" == full forward + per-frame classification
            x, _ = T.forward(cfg, params, batch)
            from repro_torch.models.layers import dense
            return dense(params["head"], x).float()
        return T.prefill(cfg, params, batch)

    @torch.no_grad()
    def decode_step(params, token, cache, pos: int):
        return T.decode_step(cfg, params, token, cache, pos)

    return train_step, prefill_step, decode_step


# --------------------------------------------------------------------------
# lowering
# --------------------------------------------------------------------------

def _tp_param_bytes_per_chip(cfg: ModelConfig, mesh) -> float:
    """Per-chip weight bytes under pure tensor parallelism (no FSDP).
    Works with any mesh-like object exposing .shape/.axis_names."""
    total = 0.0

    def visit(path, leaf):
        nonlocal total
        spec = sh.param_spec(path, leaf, mesh, fsdp=False)
        frac = 1.0
        for ax in spec:
            if ax is not None:
                frac /= mesh.shape[ax]
        total += int(np.prod(leaf.shape)) * leaf.element_size() * frac

    tree_map_with_path(visit, params_specs(cfg))
    return total


def fsdp_policy(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                hbm_bytes: float | None = None) -> bool:
    """Training always FSDPs (optimizer moments triple the weight
    footprint); serving (prefill/decode) FSDPs only when the TP-sharded
    weights pass ``FSDP_HBM_FRACTION`` of a chip's HBM (``hbm_bytes``,
    the H100's 80 GB by default): FSDP at decode costs a full weight
    all-gather per token."""
    if shape.kind == "train":
        return True
    if hbm_bytes is None:
        from repro_torch.analysis.roofline import HBM_BYTES
        hbm_bytes = HBM_BYTES
    return _tp_param_bytes_per_chip(cfg, mesh) > FSDP_HBM_FRACTION * hbm_bytes


@dataclass
class Lowered:
    """A step laid out on a mesh, ready to run on fake tensors: ``fn``
    called on ``args`` under the mesh (``run``)."""
    fn: Callable
    args: tuple
    mesh: Any
    kind: str
    fsdp: bool

    def run(self, mode=None):
        """Run the step on its fake tensors, under ``mode`` (a
        ``TorchDispatchMode`` that counts, e.g. ``roofline.OpTally``)
        when one is given."""
        with sh.fake_mode(), use_mesh(self.mesh), \
                (mode or contextlib.nullcontext()):
            return self.fn(*self.args)

    def argument_bytes(self) -> int:
        return local_bytes(self.args)


def local_bytes(tree: Any) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``, each
    storage once."""
    from repro_torch.models.shard_hints import local
    storages = [local(x).untyped_storage() for x in tree_leaves(tree)
                if isinstance(x, torch.Tensor)]      # held: ids stay unique
    return sum({id(s): s.nbytes() for s in storages}.values())


def lower_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               fsdp: bool | None = None, remat: bool = True) -> Lowered:
    """Lay out the right step for this (arch, shape) on ``mesh``: fake
    DTensors by the sharding rules on its ``DeviceMesh``, or plain fake
    tensors on a mesh without one (one chip). ``fsdp=None`` picks
    ``fsdp_policy``. ``remat`` is the train step's, as JAX's."""
    if fsdp is None:
        fsdp = fsdp_policy(cfg, shape, mesh)
    runs = mesh.device_mesh is not None
    with sh.fake_mode():
        return _lower(cfg, shape, mesh, fsdp, remat, runs)


def _lower(cfg, shape, mesh, fsdp, remat, runs) -> Lowered:
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    def place(tree, shardings):
        return sh.distribute_tree(tree, shardings) if runs else tree

    params = place(params_specs(cfg),
                   sh.params_shardings(cfg, mesh, fsdp=fsdp))
    ins = input_specs(cfg, shape)
    _, prefill_step, decode_step = make_steps(cfg)
    if shape.kind == "train":
        train_step = make_train_step(cfg, AdamWConfig(), remat=remat)
        opt = init_opt_state(params)
        batch = place(ins, sh.input_shardings(cfg, mesh, ins))
        return Lowered(train_step, (params, opt, batch), mesh, "train", fsdp)
    if shape.kind == "prefill":
        batch = place(ins, sh.input_shardings(cfg, mesh, ins))
        return Lowered(prefill_step, (params, batch), mesh, "prefill", fsdp)
    b = shape.global_batch
    cache = place(ins["cache"],
                  sh.cache_shardings(cfg, mesh, b, shape.seq_len))
    token = ins["token"]
    if runs:
        token = sh.distribute(token, sh.NamedSharding(
            mesh, sh.batch_spec(mesh, (b,))))
    # the last slot: every cache slot holds a token, as JAX's lowering
    # (an abstract position) charges them all
    return Lowered(decode_step, (params, token, cache, shape.seq_len - 1),
                   mesh, "decode", fsdp)


def shape_by_name(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]
