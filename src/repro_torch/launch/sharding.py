"""Sharding rules for the production mesh, as ``repro.launch.sharding``.

Megatron-style tensor parallelism over the ``model`` axis:

* column-parallel in-projections  -> (..., "model")          (last dim)
* row-parallel out-projections    -> (..., "model", None)    (contracting)
* vocab-parallel LM head; embedding sharded over d_model
* MoE expert weights sharded expert-major over ``model``     (EP)
* batch over ("pod", "data"); long_500k (batch=1) shards KV-cache slots
  over ``model`` instead

Every candidate dim is sharded only if divisible by the mesh axis size
(e.g. HuBERT's 504-class head stays replicated); this keeps one rule set
valid for all 10 architectures.

A spec is the port's ``PartitionSpec``: a tuple with one entry per dim,
an axis name, a tuple of axis names, or None. ``placements`` turns it
into DTensor placements on the mesh's ``DeviceMesh`` and ``spec_of``
turns them back. The rules take the port's parameter paths (the dict
keys and list indices ``tree.tree_map_with_path`` gives, as strings) and
read only shapes, so a plan is built from ``eval_shape``'s fake tensors
without allocating a byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import batch_axes
from repro_torch.models.shard_hints import is_sharded, use_mesh
from repro_torch.tree import tree_map, tree_map_with_path

# parents whose "w" (and "b") leaves are column-parallel (shard output dim)
_COL = {"wq", "wk", "wv", "wg", "wr", "w_gate", "w_up", "w_in", "w_zx",
        "w_bc", "w_dt", "w_dkv", "w_uk", "w_uv", "cm_wk", "cm_wr", "hidden"}
# parents whose "w" leaves are row-parallel (shard contracting dim)
_ROW = {"wo", "w_down", "w_out", "cm_wv", "out"}
# MoE stacked expert tensors (leaf IS the weight, expert dim leading)
_MOE_EXPERT = {"w_gate", "w_up", "w_down"}

_FSDP_MIN_ELEMS = 1 << 20       # only FSDP-shard leaves >= 1M elements


_FAKE = None


def fake_mode():
    """The one ``FakeTensorMode`` every abstract shape of the port is
    made in (fake tensors of two modes do not mix)."""
    global _FAKE
    if _FAKE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _FAKE = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE


def eval_shape(fn: Callable, *args) -> Any:
    """``fn(*args)`` on fake tensors: the shapes and dtypes of what it
    returns, with no memory allocated (JAX's ``jax.eval_shape``)."""
    with fake_mode():
        return fn(*args)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _axis(mesh, name: str) -> int:
    return mesh.shape[name]


def _put(spec: list, dim: int, axis: str, shape, axis_size: int) -> None:
    """Assign `axis` to `dim` if the dim size divides evenly."""
    if shape[dim] % axis_size == 0 and spec[dim] is None:
        spec[dim] = axis


def param_spec(path, leaf, mesh, *, fsdp: bool = False) -> tuple:
    """Spec for one parameter leaf (works for layer-stacked leaves:
    rules index dims from the right).

    With ``fsdp=True``, large 2D+ weights are additionally sharded over
    the ``data`` axis on their non-``model`` matmul dim (ZeRO-3 style).
    """
    names = [str(k) for k in path]
    last = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    shape = tuple(leaf.shape)
    nd = len(shape)
    spec: list = [None] * nd
    msize = _axis(mesh, "model")
    fsdp_dim = None                 # secondary (data-axis) shard candidate

    in_moe = "moe" in names
    if in_moe and last in _MOE_EXPERT and nd >= 3:
        # stacked experts [(L,) E, d, f] -> expert parallelism
        _put(spec, nd - 3, "model", shape, msize)
        fsdp_dim = nd - 2
    elif last == "embed":
        _put(spec, nd - 1, "model", shape, msize)       # d_model sharded
        fsdp_dim = nd - 2                               # vocab over data
    elif last == "w" and parent in _COL:
        _put(spec, nd - 1, "model", shape, msize)
        fsdp_dim = nd - 2
    elif last == "b" and parent in _COL:
        _put(spec, nd - 1, "model", shape, msize)
    elif last == "w" and parent == "head":
        _put(spec, nd - 1, "model", shape, msize)       # vocab-parallel
        fsdp_dim = nd - 2
    elif last == "b" and parent == "head":
        _put(spec, nd - 1, "model", shape, msize)
    elif last == "w" and parent in _ROW:
        _put(spec, nd - 2, "model", shape, msize)
        fsdp_dim = nd - 1
    # everything else (norms, router, loras, conv, decay, biases of
    # row-parallel projections) stays replicated
    if fsdp and fsdp_dim is not None and int(np.prod(shape)) \
            >= _FSDP_MIN_ELEMS and "data" in mesh.axis_names:
        _put(spec, fsdp_dim, "data", shape, _axis(mesh, "data"))
    return tuple(spec)


def params_shardings(cfg: ModelConfig, mesh, *, fsdp: bool = False) -> Any:
    """NamedSharding tree for ``init_params(cfg)``, from its shapes."""
    from repro_torch.launch.specs import params_specs
    return tree_map_with_path(
        lambda p, l: NamedSharding(mesh, param_spec(p, l, mesh, fsdp=fsdp)),
        params_specs(cfg))


def opt_shardings(cfg: ModelConfig, mesh, pspec: Any) -> dict:
    """Optimizer state inherits the params' shardings (moments are
    params-shaped; step is a replicated scalar)."""
    return {"m": pspec, "v": pspec, "step": NamedSharding(mesh, ())}


# --------------------------------------------------------------------------
# specs <-> DTensor placements
# --------------------------------------------------------------------------

def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh axis, in
    mesh order, ``Shard(d)`` where dim ``d``'s entry names the axis and
    ``Replicate()`` where none does."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for ax in mesh.axis_names:
        dims = [d for d, e in enumerate(spec)
                if e == ax or (isinstance(e, tuple) and ax in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def spec_of(pl, mesh, ndim: int) -> tuple:
    """The spec of placements ``pl`` on ``mesh`` for a tensor of
    ``ndim`` dims (``placements``' inverse)."""
    from torch.distributed.tensor import Shard
    spec: list = [[] for _ in range(ndim)]
    for ax, p in zip(mesh.axis_names, pl):
        if isinstance(p, Shard):
            spec[p.dim % ndim].append(ax)
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e)
                 for e in spec)


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (the same whole tensor on every rank) as a DTensor laid out
    by ``sharding``: each rank keeps its own shard, with no
    communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, sharding.mesh.device_mesh,
                             list(sharding.placements), src_data_rank=None)


def distribute_tree(tree: Any, shardings: Any) -> Any:
    return tree_map(distribute, tree, shardings)


# --------------------------------------------------------------------------
# activations / inputs
# --------------------------------------------------------------------------

def batch_spec(mesh, shape: tuple, *, batch_dim: int = 0) -> tuple:
    """Shard the batch dim over ("pod","data") when divisible."""
    ba = batch_axes(mesh)
    total = 1
    for a in ba:
        total *= _axis(mesh, a)
    spec: list = [None] * len(shape)
    if shape[batch_dim] % total == 0:
        spec[batch_dim] = ba if len(ba) > 1 else ba[0]
    return tuple(spec)


def width_axes(mesh, width: int) -> tuple:
    """The batch axes over which GSPMD lays the residual stream's
    d_model (``width``) out when a batch does not divide them, or ()
    where it keeps it whole.

    JAX's hints pin no activation there: the embedding's d_model split
    over ``model`` is all GSPMD starts from, and it moves that split onto
    the idle batch axes by a collective-permute where each of their
    shards lies inside one ``model`` shard, i.e. where their size is a
    multiple of ``model``'s. Per-chip dots of JAX's one-layer decode at
    batch 1 (reduced h2o-danube, yi-6b, rwkv6, zamba2; h2o-danube at
    full width), (contraction, output) a chip for d_model D, ``model``
    M and batch axes N:

    * 2 x 2, 4 x 2, 4 x 4, 8 x 2, 8 x 4, pod 2 x data 2 x model 4 and
      pod 2 x 4 x 2, 16 x 16 and 2 x 16 x 16: a column-parallel product
      of the stream contracts D / N (all batch axes: 80 for h2o-danube's
      ``w_gate`` on 2 x 16 x 16, [80] x [80, 432]) where its output a
      chip is below D, and takes the whole D (the stream gathered)
      where it is not: reduced yi-6b's ``w_gate`` (512 / 2 = 256 = D)
      on 2 x 2, its head (512 / 4 = 128) split on 4 x 4, a head of
      1024 / 4 = 256 whole and 960 / 4 = 240 split, at D = 512 a d_ff
      of 2040 / 4 = 510 split, a vocab of 2064 / 4 = 516 whole; the
      partial sums are all-reduced over the batch axes;
    * a row-parallel product into the stream gives D / M outputs a chip
      (h2o-danube's ``w_down`` [432] x [432, 160] on both production
      meshes, reduced [256] x [256, 128] on 4 x 2), all-reduced over
      ``model`` and permuted back;
    * 2 x 4, 3 x 4 (N not a multiple of M) and 4 x 1, 8 x 1 (``model``
      1, the embedding whole): no split; every product whole over the
      batch axes, as before.

    A prefill at batch 1 on 4 x 4 and 2 x 2 is laid out the same way
    (reduced h2o-danube, also with 2 KV heads on 4 and 1 on 2, rwkv6,
    zamba2; a one-layer step of the 2-on-4 case alone compiles with
    whole contractions, so read JAX's choice off two layers or more)."""
    ba = batch_axes(mesh)
    n = 1
    for a in ba:
        n *= _axis(mesh, a)
    m = _axis(mesh, "model") if "model" in mesh.axis_names else 1
    if m == 1 or n % m or width % n:
        return ()
    return ba


def stream_spec(mesh, shape: tuple) -> tuple:
    """The residual stream's spec for an activation ``[B, ..., D]``: the
    batch dim over ("pod","data") when it divides (``batch_spec``);
    else d_model over them where ``width_axes`` says GSPMD puts it
    there; else replicated."""
    spec = batch_spec(mesh, shape)
    if any(spec):
        return spec
    ax = width_axes(mesh, shape[-1])
    if not ax:
        return spec
    return (None,) * (len(shape) - 1) + (ax if len(ax) > 1 else ax[0],)


def input_shardings(cfg: ModelConfig, mesh, batch_shapes: Any) -> Any:
    """NamedSharding tree for a batch tree of (fake) tensors."""
    return tree_map(
        lambda l: NamedSharding(mesh, batch_spec(mesh, tuple(l.shape))),
        batch_shapes)


def cache_spec(path, leaf, mesh, *, seq_len: int) -> tuple:
    """KV/state cache leaf spec. Leaves are [L_or_G, B, ...]:

    * batch dim (1) over ("pod","data") when divisible;
    * attention KV caches additionally shard kv-heads over ``model`` when
      divisible, else the slot dim (long-context sequence sharding);
    * MLA latent caches shard the lora rank over ``model``;
    * recurrent states shard their head dim over ``model``.
    """
    names = [str(k) for k in path]
    last = names[-1]
    shape = tuple(leaf.shape)
    nd = len(shape)
    spec: list = [None] * nd
    msize = _axis(mesh, "model")
    ba = batch_axes(mesh)
    bsize = 1
    for a in ba:
        bsize *= _axis(mesh, a)
    if nd >= 2 and shape[1] % bsize == 0:
        spec[1] = ba if len(ba) > 1 else ba[0]

    if last in ("k", "v", "attn_k", "attn_v") and nd == 5:
        # [L, B, S, K, hd]
        if shape[3] % msize == 0:
            spec[3] = "model"
        elif shape[2] % msize == 0:
            spec[2] = "model"           # sequence-shard the cache
    elif last == "c_kv" and nd == 4:    # [L, B, S, r] MLA latent
        _put(spec, 3, "model", shape, msize)
    elif last == "wkv" and nd == 5:     # [L, B, H, M, M] rwkv state
        _put(spec, 2, "model", shape, msize)
    elif last == "ssm" and nd == 5:     # [L, B, h, p, n] mamba state
        _put(spec, 3, "model", shape, msize)   # P=128 divides; h may not
    return tuple(spec)


def cache_shardings(cfg: ModelConfig, mesh, batch: int, max_len: int) -> Any:
    from repro_torch.models import transformer as T
    shapes = eval_shape(lambda: T.make_cache(cfg, batch, max_len,
                                             device="cpu"))
    return tree_map_with_path(
        lambda p, l: NamedSharding(mesh, cache_spec(p, l, mesh,
                                                    seq_len=max_len)),
        shapes)


def logits_sharding(cfg: ModelConfig, mesh, batch: int) -> NamedSharding:
    out_dim = cfg.num_classes or cfg.vocab_size
    s = list(batch_spec(mesh, (batch, out_dim)))
    if out_dim % _axis(mesh, "model") == 0:
        s[1] = "model"
    return NamedSharding(mesh, tuple(s))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# --------------------------------------------------------------------------
# serving (DESIGN.md §12): data-parallel local forward
# --------------------------------------------------------------------------

def shard_batch(batch: Any, mesh) -> Any:
    """Every tensor leaf of a stacked request tree laid out batch-dim
    data parallel on ``mesh`` (leading dim over ("pod","data") when
    divisible, replicated otherwise). Leaves that are not tensors pass
    as they are."""
    def one(x):
        if not isinstance(x, torch.Tensor) or is_sharded(x):
            return x
        return distribute(x, NamedSharding(mesh,
                                           batch_spec(mesh, tuple(x.shape))))
    return tree_map(one, batch)


def shard_local_step(step: Callable, mesh) -> Callable:
    """Wrap a gated local step so its input batch is data-parallel on
    ``mesh``: each ``data`` rank runs the local forward on its own rows,
    with the parameters replicated, and the step gathers the whole
    window before its gate (``shard_hints.gather``), so the score, the
    argmax and the thresholded bottom-k are taken over every row, as
    the unsharded step takes them. The wrapper keeps the step's
    signature (positional ``(local_batch, t_local, n_valid, ...)``);
    thresholds and row counts stay plain replicated scalars. On a
    one-device mesh it computes what the unsharded step does."""
    def sharded_step(local_batch, *rest, **kw):
        with use_mesh(mesh):
            return step(shard_batch(local_batch, mesh), *rest, **kw)
    return sharded_step
