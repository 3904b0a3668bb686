"""Activation-sharding hints, as ``repro.models.shard_hints``.

``constrain(x, *axes)`` redistributes a ``DTensor`` to the spec ``axes``
using only the mesh axes that (a) exist in the ambient mesh and (b)
divide the corresponding dim, so model code can pin the layout the
production mesh should take while staying a no-op on a plain tensor (CPU
tests, one device, the card's serving path). On the multi-pod mesh a
``"data"`` entry keeps a batch dim over ``("pod", "data")``, where JAX's
hint would gather the pod axis. No hint ever changes a value: it moves
shards, or does nothing.

JAX's SPMD partitioner reshards around an op that its operands' layout
does not fit; DTensor refuses such an op, or gathers around it, instead.
The other hints take the partitioner's place: ``split_heads``/``fit``
gather a head split whose heads do not divide the ``model`` axis (GQA
keys with 4 heads on 16 devices), or split it again unevenly (query
heads), and ``merge_heads`` undoes that split; ``map_local`` runs work
that is independent across sharded dims (attention, recurrences) on each
rank's shards; ``rows`` and ``pin`` fix a value's (and its gradient's)
layout; ``argmax``, ``take``, ``logsumexp`` and ``write_slot`` work
along a sharded last or slot dim; ``cache_like`` lays a state the model
makes out as a cache, and ``put_layer`` writes a layer's entry into a
stacked one; ``gather`` brings a DTensor back to one plain tensor where
a kernel or a host step needs the whole of it.

The ambient mesh is set by ``use_mesh`` (JAX: ``use_abstract_mesh`` /
``jax.set_mesh``) for the thread that enters it, as JAX's mesh context
is: a serving engine's transport threads, running a remote model's
prefill while the local step runs on the mesh, see none. Within it plain
tensors made inside the model (RoPE tables, masks, positions) mix with
DTensors as replicated ones.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)


def get_mesh():
    """The ambient ``launch.mesh.Mesh`` of this thread (None outside
    ``use_mesh``)."""
    return _MESH.get()


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's implicit replication on for this thread (and the
    autograd worker its backward runs on), and as it was after: torch's
    own ``implicit_replication()`` turns it off on exit, which would end
    an enclosing mesh's too (a layer's recompute re-enters the mesh)."""
    prev = torch._C._get_dtensor_allow_implicit_replication()
    torch._C._set_dtensor_allow_implicit_replication(True)
    try:
        yield
    finally:
        torch._C._set_dtensor_allow_implicit_replication(prev)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` this thread's ambient mesh within; when it runs (a
    ``DeviceMesh`` attached), plain tensors made inside mix with
    DTensors as replicated ones."""
    token = _MESH.set(mesh)
    try:
        if mesh is not None and mesh.device_mesh is not None:
            with _implicit_replication():
                yield mesh
        else:
            yield mesh
    finally:
        _MESH.reset(token)


def checkpoint(fn, *args):
    """``torch.utils.checkpoint(fn, *args)`` (non-reentrant, no RNG
    state kept), its recompute run under the forward's ambient mesh: the
    backward may run on another thread (CUDA's autograd worker), which
    has no mesh of its own."""
    from torch.utils import checkpoint as ckpt
    mesh = get_mesh()
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           preserve_rng_state=False,
                           context_fn=lambda: (contextlib.nullcontext(),
                                               use_mesh(mesh)))


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_sharded(x) -> bool:
    return isinstance(x, _dtensor())


def constrain(x, *axes):
    """``x`` redistributed to the spec ``axes`` (one entry per leading
    dim: an axis name or None), keeping only the axes of the ambient
    mesh that divide their dim; unchanged when none applies or when
    ``x`` is a plain tensor."""
    mesh = get_mesh()
    if mesh is None or not is_sharded(x):
        return x
    spec = []
    for want, dim in zip(axes, x.shape):
        ok = (want is not None and want in mesh.axis_names
              and dim % mesh.shape[want] == 0)
        spec.append(want if ok else None)
        if spec[-1] == "data" and "pod" in mesh.axis_names \
                and dim % (mesh.shape["pod"] * mesh.shape["data"]) == 0:
            # the batch dim stays over ("pod", "data"): DTensor cannot
            # take the pod shard off a dim that data shards within it
            spec[-1] = ("pod", "data")
    if not any(spec):
        return x
    from repro_torch.launch.sharding import placements
    want = placements(tuple(spec) + (None,) * (x.dim() - len(spec)),
                      mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def fit(x, dim: int, n: int):
    """``x`` with its dim ``dim`` gathered along every mesh axis that
    shards it and does not divide ``n`` (a size the dim is about to be
    split into: heads, or groups of heads), or that shards a dim of size
    1 (one head: DTensor cannot reshape such a dim, even over a mesh
    axis of 1); a plain tensor, or a DTensor that fits already, as it
    is."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.dim()
    mesh = x.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim % x.dim() == dim
          and (n % mesh.size(i) or x.shape[dim] == 1) else p
          for i, p in enumerate(x.placements)]
    if pl == list(x.placements):
        return x
    return x.redistribute(mesh, pl)


def split_heads(x, heads: int, hd: int, *, split: bool = False):
    """``x [..., heads * hd]`` viewed as ``[..., heads, hd]``, a DTensor
    first gathered along any axis that does not divide ``heads`` (JAX's
    partitioner reshards around that reshape itself). With ``split``
    those axes split the heads again, unevenly as ``torch.chunk`` splits
    (each rank slices its own: no communication), so every rank keeps
    whole heads and the first ranks ceil(heads / n) of them."""
    y = fit(x, -1, heads)
    y = y.reshape(*y.shape[:-1], heads, hd)
    return _split_again(x, y, -2) if split else y


def merge_heads(x):
    """``x [..., H, hd]`` flattened to ``[..., H * hd]``, a DTensor whose
    heads an axis splits unevenly first gathered along it (DTensor
    cannot flatten an uneven split) and the flattened dim split along
    it again where it divides (the row split of the out-projection that
    follows)."""
    y = fit(x, -2, x.shape[-2])
    y = y.reshape(*y.shape[:-2], -1)
    return _split_again(x, y, -1, even=True)


def _split_again(x, y, dim: int, even: bool = False):
    """``y`` (``x`` after ``fit`` and a reshape) with ``dim`` split along
    every mesh axis that ``fit`` gathered (only where it divides, with
    ``even``)."""
    if not is_sharded(x):
        return y
    from torch.distributed.tensor import Shard
    pl = [Shard(y.dim() + dim) if a != b and not (
        even and y.shape[dim] % y.device_mesh.size(i)) else b
        for i, (a, b) in enumerate(zip(x.placements, y.placements))]
    if pl == list(y.placements):
        return y
    return y.redistribute(y.device_mesh, pl)


def local_range(x, dim: int) -> tuple[int, int]:
    """(offset, size) of this rank's shard of DTensor ``x`` along
    ``dim`` (shards split as ``torch.chunk`` splits, mesh dims in
    order)."""
    from torch.distributed.tensor import Shard
    coord = x.device_mesh.get_coordinate()
    size, offset = x.shape[dim], 0
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.dim() == dim % x.dim():
            chunk = -(-size // x.device_mesh.size(i))
            offset += coord[i] * chunk
            size = max(0, min(chunk, size - coord[i] * chunk))
    return offset, size


def write_slot(cache, slot, value) -> None:
    """``cache[:, slot] = value`` in place. ``slot`` is a host int, or a
    [1] int64 tensor on a plain cache's device (a CUDA graph's step:
    ``index_copy_`` reads it from memory). On a DTensor each rank writes
    its own shard: ``value`` (the cache without its slot dim) is laid
    out as the cache's other dims, and only the rank whose shard of the
    slot dim holds ``slot`` (a host int there) writes."""
    if not is_sharded(cache):
        if isinstance(slot, torch.Tensor):
            cache.index_copy_(1, slot, value.unsqueeze(1))
        else:
            cache[:, slot] = value
        return
    if isinstance(slot, torch.Tensor):
        raise ValueError("a sharded cache takes its slot as a host int")
    from torch.distributed.tensor import Replicate, Shard
    pl = [Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard) and p.dim != 1
          else Replicate() for p in cache.placements]
    value = like(cache, value)
    if list(value.placements) != pl:
        value = value.redistribute(cache.device_mesh, pl)
    lo, n = local_range(cache, 1)
    if lo <= slot < lo + n:
        cache.to_local()[:, slot - lo] = value.to_local()


def put_layer(buf, i: int, n: int, t):
    """``buf[i] = t`` in place, ``buf`` the ``[n, *t.shape]`` stack of
    ``n`` layers' tensors that ``torch.stack`` would give: allocated
    uninitialised at the first call (``buf`` None) and laid out as
    ``t`` is, a DTensor's shards one dim down. Each layer's tensor is
    copied in as it is made, so the layers are never held beside their
    stack (JAX's layer scan writes its stacked cache once). Returns
    ``buf``."""
    if not is_sharded(t):
        if buf is None:
            buf = t.new_empty((n, *t.shape))
        buf[i].copy_(t)
        return buf
    from torch.distributed.tensor import DTensor, Shard
    mesh = t.device_mesh
    if buf is None:
        pl = [Shard(p.dim % t.dim() + 1) if isinstance(p, Shard) else p
              for p in t.placements]
        lt = t.to_local()
        shape = torch.Size((n, *t.shape))
        buf = DTensor.from_local(lt.new_empty((n, *lt.shape)), mesh, pl,
                                 run_check=False, shape=shape,
                                 stride=_contiguous_stride(shape))
    want = [Shard(p.dim - 1) if isinstance(p, Shard) else p
            for p in buf.placements]
    if list(t.placements) != want:
        t = t.redistribute(mesh, want)
    buf.to_local()[i].copy_(t.to_local())
    return buf


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous gradient: a shard's
    gradient from an einsum's backward may be a transposed view, which
    DTensor's own view ops (the backward of the reshape before a map)
    cannot flatten."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _ScaleGrad(torch.autograd.Function):
    """Identity whose backward scales the gradient by ``k``."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.k, None


def map_local(fn, mesh, ins, outs, shapes=None):
    """Run ``fn`` on this rank's shards: ``ins`` pairs each argument (a
    DTensor, a plain tensor taken as replicated, or None) with the
    placements it is laid out by first; ``fn`` returns plain tensors,
    made DTensors by the placements in ``outs`` (a ``Partial`` one: the
    ranks' results sum), of the global ``shapes`` where an output is
    split unevenly (else each shard is taken as an even one). For work
    that is independent across the sharded dims (a recurrence per row
    and head), where DTensor's own rules would gather.

    Gradients: along a mesh dim that splits the work (an input shard, or
    an output shard or partial output there), each rank's gradient of an
    input it holds whole is its own share, so it goes back as a partial
    sum; an output whole on such a dim is the same on every rank, so
    each rank takes 1/n of its gradient."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    split = {i for i in range(mesh.ndim)
             if any(x is not None and isinstance(pl[i], Shard)
                    for x, pl in ins)
             or any(isinstance(pl[i], (Partial, Shard)) for pl in outs)}
    args = []
    for x, pl in ins:
        if x is None:
            args.append(None)
            continue
        if not is_sharded(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if list(x.placements) != list(pl):
            x = x.redistribute(mesh, pl)
        grad = [Partial() if i in split and isinstance(p, Replicate) else p
                for i, p in enumerate(pl)]
        args.append(_ContiguousGrad.apply(x.to_local(grad_placements=grad)))
    res = fn(*args)
    out = []
    for j, (r, pl) in enumerate(zip(res, outs)):
        n = 1
        for i in split:
            n *= mesh.size(i) if isinstance(pl[i], Replicate) else 1
        if n > 1 and r.requires_grad:
            r = _ScaleGrad.apply(r, 1.0 / n)
        shape = None if shapes is None else torch.Size(shapes[j])
        out.append(DTensor.from_local(
            r, mesh, pl, run_check=False, shape=shape,
            stride=None if shape is None else _contiguous_stride(shape)))
    return tuple(out)


def _contiguous_stride(shape) -> tuple:
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))


def keep(x, dims: dict):
    """Placements of DTensor ``x`` that keep each mesh dim's shard of a
    dim in ``dims`` (renumbered by it: old dim -> new dim) and gather
    the others: the layout a per-shard map can take."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(dims[p.dim % x.dim()]) if isinstance(p, Shard)
            and p.dim % x.dim() in dims else Replicate()
            for p in x.placements]


def rows(x, *, stream: bool = True):
    """The residual stream's layout: dim 0 over the batch axes
    ("pod", "data") when it divides, every other dim replicated; a batch
    that does not divide them leaves them idle, and where GSPMD then
    lays d_model over them (``launch.sharding.width_axes``) the last dim
    goes there (``project`` then splits the products as GSPMD does).
    ``stream=False``: a value beside the stream (a low-rank hidden,
    MLA's latent), whose last dim is not d_model: rows only. Without it
    DTensor may settle a row-parallel product's partial sum by a
    reduce-scatter over a sequence dim, which later head and flatten
    reshapes cannot follow. A plain tensor is returned as it is."""
    mesh = get_mesh()
    if mesh is None or not is_sharded(x):
        return x
    from repro_torch.launch.sharding import (batch_spec, placements,
                                             stream_spec)
    spec = stream_spec if stream else batch_spec
    want = placements(spec(mesh, tuple(x.shape)), mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return _GradAs.apply(x, want)


def project(x, w):
    """``x @ w`` (``w`` [D_in, D_out]). Where x's rows and w's D_in are
    split over the same batch axis (an FSDP weight), w is gathered over
    it first, as ZeRO-3 gathers a weight before its use: DTensor's own
    choice may gather x's rows instead and contract the split, which for
    a large output (the loss head's vocabulary) holds every row's output
    on every chip. On a mesh whose idle batch axes
    hold the stream's d_model (``rows``), laid out as GSPMD lays JAX's
    product out there (``launch.sharding.width_axes``):

    * from the stream (x's last dim over those axes): where w's output
      a chip is below D_in, w's rows are sliced as x's last dim is (no
      collective) and the partial sums all-reduced over the axes; else
      x is gathered and the contraction runs whole;
    * a row-parallel product (x's last dim and w's rows over ``model``,
      x's rows not split), whose D_out is the stream's d_model: each
      rank multiplies the D_out / ``model`` columns that GSPMD gives its
      chip, the chunk that holds its own shard of the stream, and keeps
      that shard (a partial sum over ``model``; where the batch axes
      are wider than ``model``, as on the two-pod mesh, the rest of the
      chunk is the neighbours' shards, which JAX's chip hands on by a
      permute).

    Anything else is ``x @ w`` as DTensor lays it out."""
    plan = get_mesh()
    if plan is None or not (is_sharded(x) and is_sharded(w)):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.launch.sharding import batch_axes, width_axes
    mesh, names = x.device_mesh, plan.axis_names
    last = x.dim() - 1

    def on(t, i, d):
        p = t.placements[i]
        return isinstance(p, Shard) and p.dim % t.dim() == d

    ba = [names.index(a) for a in batch_axes(plan)]
    fsdp = [i for i in ba if on(w, i, w.dim() - 2) and on(x, i, 0)]
    if fsdp:
        w = w.redistribute(mesh, [Replicate() if i in fsdp else p
                                  for i, p in enumerate(w.placements)])
    if "model" in names and on(w, names.index("model"), w.dim() - 2) \
            and width_axes(plan, w.shape[-1]) \
            and not any(on(x, i, 0) for i in ba):
        return _row_product(x, w, names.index("model"), ba)
    if not (ba and all(on(x, i, last) for i in ba)):
        return x @ w
    out = w.shape[-1]
    for i in range(mesh.ndim):
        out //= mesh.size(i) if on(w, i, w.dim() - 1) else 1
    if out < x.shape[-1]:
        wpl = [Shard(w.dim() - 2) if i in ba else p
               for i, p in enumerate(w.placements)]
        if list(w.placements) != wpl:
            w = w.redistribute(mesh, wpl)
        y = x @ w
        return y.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                     else p for p in y.placements])
    x = x.redistribute(mesh, [Replicate() if i in ba else p
                              for i, p in enumerate(x.placements)])
    return x @ w


def batch_rank(mesh, ba: list) -> tuple[int, int]:
    """(N, r): the size of the batch axes (mesh dims ``ba``, in order)
    of DeviceMesh ``mesh`` and this rank's index over them."""
    coord = mesh.get_coordinate()
    n, r = 1, 0
    for i in ba:
        n, r = n * mesh.size(i), r * mesh.size(i) + coord[i]
    return n, r


def _row_product(x, w, mi: int, ba: list):
    """``project``'s row-parallel case: the chunk of D_out / M columns
    that holds this rank's shard (of D_out / N, N the batch axes'
    size), the shard kept: Shard(last) over the batch axes, Partial
    over ``model`` (mesh dim ``mi``; every other mesh dim is a batch
    axis)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, last = x.device_mesh, x.dim() - 1
    n, r = batch_rank(mesh, ba)
    d = w.shape[-1]
    chunk, piece = d // mesh.size(mi), d // n
    c0 = r * piece // chunk * chunk
    lo = r * piece - c0
    xpl = [Shard(last) if i == mi else Replicate() for i in range(mesh.ndim)]
    wpl = [Shard(w.dim() - 2) if i == mi else Replicate()
           for i in range(mesh.ndim)]
    ypl = [Partial() if i == mi else Shard(last) for i in range(mesh.ndim)]

    def local(xl, wl):
        return ((xl @ wl[..., c0:c0 + chunk])[..., lo:lo + piece],)

    return map_local(local, mesh, [(x, xpl), (w, wpl)], (ypl,))[0]


def pin(x):
    """``x`` as it is, its gradient laid out as ``x`` is (a DTensor's);
    a plain tensor as it is."""
    if not is_sharded(x):
        return x
    return _GradAs.apply(x, tuple(x.placements))


class _GradAs(torch.autograd.Function):
    """Identity whose backward lays the gradient out by ``want``: else
    DTensor may hand a partial gradient back as a shard of the sequence
    (the backward of a slice or a concatenation along it), which a later
    flatten cannot follow."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_sharded(g) and tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def _last_sharded(x) -> bool:
    """Whether a mesh axis of more than one rank splits ``x``'s last dim
    (on an axis of one the plain op on the DTensor is the same work, and
    keeps the plain path's arithmetic)."""
    from torch.distributed.tensor import Shard
    return is_sharded(x) and any(
        isinstance(p, Shard) and p.dim % x.dim() == x.dim() - 1
        and x.device_mesh.size(i) > 1 for i, p in enumerate(x.placements))


def _over_last(x, fn):
    """``fn(local x, offset of its last-dim shard, reduce)`` on this
    rank's shard of ``x`` (sharded along its last dim, partial sums
    settled first); ``reduce(t, op)`` combines a per-rank result over
    the mesh dims that shard the last dim and returns the DTensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, d = x.device_mesh, x.dim() - 1
    if any(isinstance(p, Partial) for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                  else p for p in x.placements])

    def reduce(t, op):
        pl = [Partial(op) if isinstance(p, Shard) and p.dim % x.dim() == d
              else p for p in x.placements]
        dt = DTensor.from_local(t, mesh, pl, run_check=False)
        return dt.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                      else p for p in pl])

    return fn(x, local_range(x, d)[0], reduce)


def argmax(x):
    """``x.argmax(-1)``. On a DTensor sharded along its last dim each
    rank takes its shard's maximum and first index of it, and the ranks
    keep the largest value's smallest index (two all-reduces of the
    leading dims), as ``argmax`` picks the first maximum."""
    if not _last_sharded(x):
        return x.argmax(-1)

    def fn(x, off, reduce):
        lmax, lidx = x.to_local().max(-1)
        gmax = reduce(lmax, "max").to_local()
        cand = torch.where(lmax == gmax, lidx + off,
                           torch.full_like(lidx, x.shape[-1]))
        return reduce(cand, "min")

    return _over_last(x, fn)


def logsumexp(x):
    """``torch.logsumexp(x, -1)``. On a DTensor sharded along its last
    dim each rank reduces its shard: the maximum all-reduced (held
    constant: the result does not depend on it), then the sum of its
    shard's exponentials all-reduced, so nothing of the last dim is
    gathered."""
    if not _last_sharded(x):
        return torch.logsumexp(x, -1)

    def fn(x, off, reduce):
        lx = x.to_local()
        m = reduce(lx.detach().amax(-1), "max")
        s = reduce(torch.exp(lx - m.to_local()[..., None]).sum(-1), "sum")
        return torch.log(s) + m

    return _over_last(x, fn)


def take(x, idx):
    """``x[..., idx]`` along the last dim (``torch.gather(x, -1,
    idx[..., None])[..., 0]``). On a DTensor sharded along its last dim
    the rank whose shard holds an index gives its value and the others
    0, summed over the ranks."""
    if not _last_sharded(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]

    def fn(x, off, reduce):
        from torch.distributed.tensor import Replicate, Shard
        lx = x.to_local()
        n = lx.shape[-1]
        pl = [p if isinstance(p, Shard) and p.dim % x.dim() < x.dim() - 1
              else Replicate() for p in x.placements]
        li = like(x, idx)
        if list(li.placements) != pl:
            li = li.redistribute(x.device_mesh, pl)
        li = li.to_local() - off
        inside = (li >= 0) & (li < n)
        val = torch.gather(lx, -1, li.clamp(0, n - 1)[..., None])[..., 0]
        return reduce(val * inside, "sum")

    return _over_last(x, fn)


def abstract(x) -> bool:
    """Whether ``x`` (or its shard) is a fake tensor: shapes without
    data (the dry-run, ``launch.specs``)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(local(x), FakeTensor)


# how many times ``analysis.roofline``'s tally charges an op run now
_CHARGE = contextvars.ContextVar("repro_torch_charge", default=1.0)
_BACKWARD_CHARGE = [1.0]


def charge() -> float:
    """How many times an op run now stands for itself: a fake
    recurrence's counted steps stand for all of its steps
    (``stepwise``)."""
    return _CHARGE.get() * _BACKWARD_CHARGE[0]


def stepwise(n_seq: int):
    """Decorate a recurrence over dim 1 of its first ``n_seq`` arguments
    (``[B, T, ...]``; the others whole), returning ``(y [B, T, ...],
    final state)``. On real tensors it runs as it is. Fake tensors (the
    dry-run, ``analysis.roofline``) hold no values to run T steps on:
    the first two steps run (so that each input reaches the output, as
    a gradient needs), their ops and their gradients' ops charged T/2
    times (``charge``), and y's last step stands for the rest (shapes
    right, values meaningless)."""
    def wrap(fn):
        def run(*args, **kw):
            t = args[0].shape[1]
            if t <= 2 or not abstract(args[0]):
                return fn(*args, **kw)
            cut = [a[:, :2] for a in args[:n_seq]]
            token = _CHARGE.set(_CHARGE.get() * t / 2)
            try:
                y, s = fn(*cut, *args[n_seq:], **kw)
            finally:
                _CHARGE.reset(token)
            _charge_backward((y, s), cut, t / 2)
            return torch.cat([y, y[:, -1:].expand(
                -1, t - 2, *y.shape[2:])], 1), s
        return run
    return wrap


def _charge_backward(outs, ins, times: float) -> None:
    """Charge ``times`` the ops of every autograd node between ``ins``
    and ``outs`` when the backward runs them."""
    stop = {x.grad_fn for x in ins if x.grad_fn is not None}
    todo = [x.grad_fn for x in outs if x.grad_fn is not None]
    seen = set()
    while todo:
        node = todo.pop()
        if node is None or node in seen or node in stop:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)

    def pre(_grads):
        _BACKWARD_CHARGE[0] = times

    def post(_grads_in, _grads_out):
        _BACKWARD_CHARGE[0] = 1.0

    for node in seen:
        node.register_prehook(pre)
        node.register_hook(post)


def cache_like(make, device):
    """The zeroed recurrent state ``make(device)`` that a prefill makes
    itself (RWKV6's or mamba2's, ``[L, B, ...]`` leaves) laid out on the
    ambient mesh as a cache of that kind is (``launch.sharding
    .cache_spec``), each rank allocating only its own shard, which it
    then updates in place; ``make(device)`` as it is outside a running
    mesh."""
    mesh = get_mesh()
    if mesh is None or mesh.device_mesh is None:
        return make(device)
    from torch.distributed.tensor import zeros
    from repro_torch.launch.sharding import cache_spec, placements
    from repro_torch.tree import tree_map_with_path
    return tree_map_with_path(lambda p, x: zeros(
        x.shape, dtype=x.dtype, device_mesh=mesh.device_mesh,
        placements=placements(cache_spec(p, x, mesh, seq_len=0), mesh)),
        make("meta"))


def gather(x):
    """A plain tensor holding the whole of ``x`` (a DTensor is gathered
    from its shards; a plain tensor is returned as it is)."""
    if is_sharded(x):
        return x.full_tensor()
    return x


def local(x):
    """This rank's shard of ``x`` (``x`` itself when plain)."""
    if is_sharded(x):
        return x.to_local()
    return x


def like(ref, x: torch.Tensor):
    """``x`` (a plain tensor, the same on every rank) as a replicated
    DTensor on ``ref``'s mesh when ``ref`` is a DTensor, else as it
    is."""
    if is_sharded(ref) and not is_sharded(x):
        from torch.distributed.tensor import DTensor, Replicate
        return DTensor.from_local(
            x, ref.device_mesh, [Replicate()] * ref.device_mesh.ndim,
            run_check=False)
    return x
