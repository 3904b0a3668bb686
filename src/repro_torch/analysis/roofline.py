"""Roofline terms of one step on one NVIDIA H100 of a mesh, as
``repro.analysis.roofline`` derives them for a TPU v5e chip:

    compute term    = dot FLOPs a chip / its peak FLOP/s (dtype-aware)
    memory term     = bytes a chip must move / its HBM bandwidth
    collective term = collective bytes a chip sends / its NVLink bandwidth

JAX reads the per-device FLOPs and bytes from ``compiled.cost_analysis()``
and the collectives and fp32 dots from the partitioned HLO text. PyTorch
has neither, so ``OpTally`` (a ``TorchDispatchMode``) counts the step's
local aten ops as they run, on fake tensors (``launch.specs.lower_step``:
nothing is allocated):

* dot FLOPs (matmuls, convolutions, attention) from
  ``torch.utils.flop_counter``'s formulas, split by operand dtype. A
  Hopper kernel on the step's path is one op on fake tensors, the
  kernel's own (``torch.ops.repro_torch.*``, reached through its
  wrapper: flash prefill, decode attention, the RWKV6 scan): its formula,
  kept beside the op in its ``ops.py``, credits it the plain version's
  dot FLOPs, and it holds its output and its scratch
  (``kernels.build.SCRATCH_BYTES``), never the plain version's scores;
  its bytes are its operands and output, as any op's. The
  plain paths take JAX's ``preferred_element_type=float32`` product of
  16-bit operands by widening them to fp32 first (the Hopper kernels take
  the 16-bit operands): a dot whose operands all hold exact widenings of
  16-bit values is charged as a 16-bit dot, any other fp32 dot as fp32;
* the bytes a step must move, the memory term: its arguments (this
  rank's shards of the weights, the optimizer state, the cache, the
  inputs) read once, its new outputs and the argument bytes it writes in
  place (a cache slot, the updated weights and moments) written once.
  Any path, kernels or plain, moves at least these;
* beside it, the plain path's unfused traffic (``unfused_bytes_per_chip``,
  ``unfused_memory_s``): every input and output of every op, views
  excepted, as XLA's "bytes accessed" counts a fused module's. The plain
  path runs one op at a time, widened to fp32 where a kernel reads 16-bit
  values, so this is no lower bound: it is what fusing would save;
* collective bytes, by kind, from the functional collectives
  (``_c10d_functional.*``) that DTensor issues, operand bytes as JAX's
  tally;
* the peak of the bytes the step holds live beyond its arguments (the
  dry-run's temp bytes).

A DTensor op is left to DTensor (the mode steps aside), and the local ops
it runs on this rank's shards are what is counted, so every number is a
chip's own: replicated work (norms, the router, a replicated head) is
charged to every chip, as JAX's per-device module charges it.

The port's layers run as a Python loop, not a scan, so every layer is
counted and no depth extrapolation is needed: ``roofline_extrapolated``
keeps its name and record and says ``method: "full-depth"``. A plain
recurrence over the sequence (RWKV6's in training, mamba2's SSD) is
charged per step: fake tensors hold no values to run it on, so two of
its steps
run and their ops, forward and backward, are charged T/2 times
(``models.shard_hints.stepwise``; ``method`` then says so). So
``repro.models.scan_config`` (the switch that unrolls JAX's scans for
``cost_analysis``) has no counterpart, nor has ``repro.kernels.compat``
(a Pallas rename shim).

The collective term divides by one GPU's NVLink bandwidth. The
production mesh's 16-wide ``model`` axis is wider than one 8-GPU NVLink
domain, so part of its traffic would cross the slower inter-node fabric:
the term is a lower bound.

MODEL_FLOPS uses the 6·N·D rule (6·N_active·D for MoE; 2·N·D forward-only
for prefill/decode) so the "useful compute" ratio catches remat/redundancy
waste.
"""

from __future__ import annotations

import weakref
import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.build import SCRATCH_BYTES

# ---- NVIDIA H100 SXM5 constants (NVIDIA H100 Tensor Core GPU data sheet;
# dense rates, without sparsity, at the 700 W power limit) ----------------
PEAK_FLOPS = 989e12          # bf16 / fp16 tensor-core FLOP/s per GPU
TF32_FLOPS = 495e12          # fp32 matmuls on the tensor cores (TF32)
FP32_FLOPS = 67e12           # fp32 outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s per GPU
HBM_BYTES = 80e9             # HBM3 capacity per GPU
NVLINK_BW = 450e9            # NVLink 4 bytes/s per direction per GPU

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_COLLECTIVE_OPS = {"all_gather_into_tensor": "all-gather",
                   "all_gather_into_tensor_coalesced": "all-gather",
                   "all_reduce": "all-reduce",
                   "all_reduce_coalesced": "all-reduce",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "reduce_scatter_tensor_coalesced": "reduce-scatter",
                   "all_to_all_single": "all-to-all",
                   "broadcast": "collective-permute"}
_SIXTEEN = (torch.bfloat16, torch.float16)
# ops that move data without changing it: a widened operand stays one
_MOVES = {"clone", "_to_copy", "cat", "stack", "index", "gather"}


def fp32_penalty() -> float:
    """How many times slower an fp32 dot runs than a bf16 one on the
    H100, under the port's matmul setting: TF32 tensor cores when
    ``torch.backends.cuda.matmul.allow_tf32`` is set, else the fp32
    units (989/67 = 14.8x; 989/495 = 2.0x with TF32)."""
    fp32 = TF32_FLOPS if torch.backends.cuda.matmul.allow_tf32 \
        else FP32_FLOPS
    return PEAK_FLOPS / fp32


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None \
        and not rets[0].alias_info.is_write


class OpTally(TorchDispatchMode):
    """Counts the local aten ops run under it (see the module
    docstring). ``dot_flops`` maps the charged dtype ("bf16", "fp32") to
    FLOPs; ``bytes`` (every op's operands), ``coll`` (kind -> bytes),
    ``peak_bytes`` (the most bytes held live by tensors the ops made),
    ``written_bytes`` (the bytes of ``args``' tensors written in place,
    each element once)."""

    def __init__(self, args=()):
        super().__init__()
        from repro_torch.models.shard_hints import charge, local
        self._charge = charge
        self._args = {id(local(t).untyped_storage()) for t in _tensors(args)}
        self._written = {}
        self.charged = False
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        from repro_torch.launch.sharding import fake_mode
        self._fake = fake_mode()
        self._propagating = 0
        self.dot_flops = {"bf16": 0.0, "fp32": 0.0}
        self.bytes = 0.0
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._widened = weakref.WeakKeyDictionary()   # storage -> True
        self._tracked = weakref.WeakKeyDictionary()

    # -- DTensor's metadata propagation is left out ------------------------
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        name = next(n for n in ("_propagate_tensor_meta_non_cached",
                                "_propagate_tensor_meta")
                    if hasattr(ShardingPropagator, n))
        orig = getattr(ShardingPropagator, name)
        tally = self

        def propagate(prop, *a, **k):
            tally._propagating += 1
            try:
                return orig(prop, *a, **k)
            finally:
                tally._propagating -= 1

        setattr(ShardingPropagator, name, propagate)
        self._restore = (ShardingPropagator, name, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, name, orig = self._restore
        setattr(cls, name, orig)
        return super().__exit__(*exc)

    # -- live bytes ------------------------------------------------------
    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _track(self, t: torch.Tensor, inputs: set) -> None:
        s = t.untyped_storage()
        if id(s) in inputs or s in self._tracked:
            return
        n = s.nbytes()
        self._tracked[s] = True
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._free, n)

    def _widens(self, t: torch.Tensor) -> bool:
        return t.dtype in _SIXTEEN or (
            t.dtype == torch.float32 and t.untyped_storage() in self._widened)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = [t for t in _tensors((args, kwargs))]
        # DTensor's sharding propagation runs ops on fake tensors of the
        # global shapes: those are not the chip's work
        if self._propagating or any(
                isinstance(t, FakeTensor) and t.fake_mode is not self._fake
                for t in ins):
            return out
        outs = list(_tensors(out))
        self._note_writes(func, args, kwargs)
        name = func.overloadpacket.__name__
        times = self._charge()
        self.charged |= times != 1.0
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional") \
                and name in _COLLECTIVE_OPS:
            self.coll[_COLLECTIVE_OPS[name]] += sum(
                t.numel() * t.element_size() for t in ins)
            return out
        if func.overloadpacket in self._flops:
            flops = self._flops[func.overloadpacket](*args, **kwargs,
                                                     out_val=out)
            operands = [t for t in ins if t.dim() >= 2]
            kind = "bf16" if operands and all(self._widens(t)
                                              for t in operands) else "fp32"
            self.dot_flops[kind] += float(flops) * times
        if _is_view(func) or ns == "prim" or name == "_unsafe_view" or (
                outs and all(t.device.type == "meta" for t in outs)):
            return out          # no data: a view, or shapes only
        in_storages = {id(t.untyped_storage()) for t in ins}
        if name.startswith("empty") or name == "new_empty":
            # an uninitialised buffer (a stacked cache, an output filled
            # chunk by chunk) moves no bytes, but it is held
            for t in outs:
                self._track(t, in_storages)
            return out
        self.bytes += sum(t.numel() * t.element_size()
                          for t in ins + outs) * times
        for t in outs:
            self._track(t, in_storages)
        scratch = SCRATCH_BYTES.get(func.overloadpacket)
        if scratch:         # a kernel's, held while it runs
            self.peak_bytes = max(self.peak_bytes, self.live_bytes
                                  + scratch(*args, **kwargs))
        # a widened operand: a 16-bit tensor cast to fp32, or one moved
        if outs and outs[0].dtype == torch.float32:
            src = [t for t in ins if t.dim() > 0 or len(ins) == 1]
            if (name in ("_to_copy", "to") and src
                    and src[0].dtype in _SIXTEEN) or (
                    name in _MOVES and src
                    and all(t.dtype == torch.float32
                            and t.untyped_storage() in self._widened
                            for t in src if t.is_floating_point())):
                for t in outs:
                    self._widened[t.untyped_storage()] = True
        return out

    def _note_writes(self, func, args, kwargs) -> None:
        """Record each view of an argument's storage that ``func`` writes
        in place (a view written again counts once)."""
        if not self._args or not func._schema.is_mutable:
            return
        vals = list(args) + [kwargs.get(a.name) for a in
                             func._schema.arguments[len(args):]]
        for a, v in zip(func._schema.arguments, vals):
            if not (a.alias_info is not None and a.alias_info.is_write
                    and isinstance(v, torch.Tensor)):
                continue
            st = v.untyped_storage()
            if id(st) in self._args:
                key = (id(st), v.storage_offset(), tuple(v.shape),
                       tuple(v.stride()))
                self._written[key] = v.numel() * v.element_size()

    @property
    def written_bytes(self) -> int:
        return sum(self._written.values())

    @property
    def total_dot_flops(self) -> float:
        return self.dot_flops["bf16"] + self.dot_flops["fp32"]


def measure(lowered) -> OpTally:
    """Run a ``launch.specs.Lowered`` step under a fresh ``OpTally``;
    ``outputs`` holds what the step returned, ``output_bytes`` the part
    of it the step allocated (this rank's shards) and ``io_bytes`` the
    bytes the step must move: its arguments read, its new outputs and
    its in-place writes written, each once."""
    from repro_torch.models.shard_hints import local
    t = OpTally(lowered.args)
    t.outputs = lowered.run(t)
    storages = [local(x).untyped_storage() for x in _tensors(t.outputs)]
    new = {id(s): s.nbytes() for s in storages if s in t._tracked}
    t.output_bytes = sum(new.values())
    t.io_bytes = lowered.argument_bytes() + t.output_bytes + t.written_bytes
    return t


def param_counts(cfg) -> tuple[int, int]:
    """(total params, active params). Active discounts routed experts by
    top_k/E (MoE); equal for dense archs."""
    from repro_torch.launch.specs import params_specs
    from repro_torch.tree import tree_map_with_path
    total = 0
    active = 0.0
    routed = {"w_gate", "w_up", "w_down"}

    def visit(path, leaf):
        nonlocal total, active
        n = int(np.prod(leaf.shape))
        total += n
        if cfg.is_moe and "moe" in path and path[-1] in routed:
            active += n * cfg.num_experts_per_tok / cfg.num_experts
        else:
            active += n

    tree_map_with_path(visit, params_specs(cfg))
    return total, int(active)


def model_flops(cfg, shape) -> float:
    """6·N·D (train), 2·N·D (forward-only prefill / decode); N = active."""
    _, n_active = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: ONE token per sequence
    return 2.0 * n_active * shape.global_batch


def roofline_record(tally: OpTally, cfg, shape, mesh) -> dict:
    """The roofline record of one counted step (the keys of JAX's
    ``roofline_extrapolated``)."""
    chips = mesh.size
    flops = tally.total_dot_flops
    f32 = tally.dot_flops["fp32"]
    coll_total = float(sum(tally.coll.values()))
    compute_s = (tally.dot_flops["bf16"] + f32 * fp32_penalty()) / PEAK_FLOPS
    memory_s = tally.io_bytes / HBM_BW
    collective_s = coll_total / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    mf = model_flops(cfg, shape)
    return {
        "chips": chips,
        "method": "full-depth; recurrences charged per step"
                  if tally.charged else "full-depth",
        "f32_dot_flops_per_chip": f32,
        "f32_dot_share": f32 / flops if flops else 0.0,
        "flops_per_chip": flops,
        "bytes_per_chip": tally.io_bytes,
        "unfused_bytes_per_chip": tally.bytes,
        "coll_bytes_per_chip": coll_total,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "unfused_memory_s": tally.bytes / HBM_BW,
        "collective_s": collective_s,
        "bottleneck": max(terms, key=terms.get),
        "model_flops": mf,
        "useful_ratio": mf / (flops * chips) if flops else float("nan"),
        "coll_breakdown": {k: int(v) for k, v in tally.coll.items() if v},
    }


def roofline_from_lowered(lowered, cfg, shape, mesh) -> dict:
    """The roofline record of a ``launch.specs.Lowered`` step."""
    return roofline_record(measure(lowered), cfg, shape, mesh)


def bound_step_time(rec: dict) -> float:
    """Lower-bound step time: max of the three terms (no overlap model;
    the memory term is the bytes the step must move, not the plain
    path's unfused traffic)."""
    return max(rec["compute_s"], rec["memory_s"], rec["collective_s"])


def roofline_extrapolated(cfg, shape, mesh, *, fsdp: bool | None = None,
                          remat: bool = True) -> dict:
    """The roofline record of (cfg, shape) on ``mesh``, every layer
    counted (``method: "full-depth"``)."""
    from repro_torch.launch.specs import lower_step
    return roofline_from_lowered(
        lower_step(cfg, shape, mesh, fsdp=fsdp, remat=remat), cfg, shape,
        mesh)
