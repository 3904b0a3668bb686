"""Greedy generation over the port's model API (prefill + decode loop).

Returns per-token likelihoods of the chosen tokens so the sequence
supervisors (``core.supervisors.seq_min_likelihood`` — the paper's QA
reducer) apply directly: the generative analogue of the classification
cascade. On CUDA tensors the prefill runs the flash-attention kernel,
every decode step the decode-attention kernel once per layer (zamba: once
per group, its mamba2 layers in plain PyTorch; for RWKV6, the prefill and
every step the RWKV6 scan kernel once per layer), and
each token is picked by the maxconf kernel (argmax and max-softmax in one
pass over the vocabulary).

The decode loop takes one of two paths, chosen by what the call holds
(``_graphable``):

* **The graph path**: CUDA tensors, an unsharded cache of one dense or
  sliding-window GQA stack (``{"main": {"k", "v"}}``) and no MoE layer.
  One decode step and its token's pick run as a CUDA graph
  (``DecodeGraph``) over static buffers: the token, the position (a 0-d
  tensor that ``decode_step`` reads from memory), the KV cache (the
  prefill's copied into it each call) and the step's likelihood. Each
  step sets the position, replays the graph and copies the token and
  likelihood out, so the host no longer dispatches the step's ops one by
  one. A key's first call runs its first step eagerly on the capture
  stream, which loads and plans every kernel, then captures the step
  (``torch.cuda.graph`` synchronises the device and empties the
  allocator's cache, once); later calls of the key replay every step.
  So the path pays off where calls repeat a key: config, batch, prompt
  length plus new tokens, device and the parameters' storage
  (``decode_graph``); a graph never replays over other parameters or
  another cache. ``GRAPHS`` holds the last ``MAX_GRAPHS`` graphs, each
  with its static cache and graph pool, until a newer key pushes it out,
  its parameters are freed, or ``release_graphs`` drops them all.
* **The eager loop** (``_decode_eager``), for everything else: the CPU,
  fake tensors (the dry-run), DTensor meshes, RWKV6, zamba2, MLA and MoE
  (whose expert loop syncs with the host). It never synchronises.

Both run ``decode_step`` and ``_pick`` on the same kernels and give the
same tokens and likelihoods, bit for bit. ``runtime.observability.SPANS``
counts the decode steps of every call by path,
``generate_decode_steps_total{path="graph"|"eager"}``, profiler or not.
Under a recording profiler the prefill (with its token's pick), the
cache's graft and each decode step (with its pick; on the graph path a
replay) are the spans ``generate.prefill``, ``generate.graft`` and
``generate.step`` (``runtime.observability.span``).
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import add_launch_counts, launch_counts
from repro_torch.kernels.build import is_fake
from repro_torch.kernels.maxconf.ops import maxconf
from repro_torch.models.shard_hints import is_sharded
from repro_torch.models.transformer import decode_step, make_cache, prefill
from repro_torch.runtime.observability import SPANS, span
from repro_torch.tree import tree_map_with_path

MAX_GRAPHS = 4


def _pick(logits: torch.Tensor):
    out = maxconf(logits)
    return out["prediction"], out["max_softmax"]


def graft(cache: dict, pcache: dict) -> dict:
    """Copy a prefill's cache, covering positions [0, t), into a serving
    cache from ``make_cache``, along the slot axis (dim 2) of every leaf
    whose shape differs: the ``"main"`` and ``"dense"`` stacks' keys and
    values, MLA's latent ``c_kv`` and ``k_rope``, or zamba's per-group
    ``"attn_k"`` and ``"attn_v"`` (tensors at the top level). A group or
    leaf of the same shape in both is taken as it is: a recurrent state
    (RWKV6's, zamba's mamba2 state), and under SWA with t > window the
    prefill's whole ring, already rolled."""
    def put(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        if dst.shape == src.shape:
            return src
        dst[:, :, :src.shape[2]] = src
        return dst

    for key, src in pcache.items():
        dst = cache[key]
        if not isinstance(src, dict):
            cache[key] = put(dst, src)
        elif all(dst[n].shape == leaf.shape for n, leaf in src.items()):
            cache[key] = src
        else:
            for name, leaf in src.items():
                dst[name] = put(dst[name], leaf)
    return cache


def _decode_eager(cfg: ModelConfig, params, tok, lik, cache, t: int,
                  n: int):
    """``n`` decode steps after the prefill's token ``tok`` (likelihood
    ``lik``), the first at position ``t``, over the grafted ``cache``,
    each op dispatched by the host: (tokens [B, n + 1] int32,
    likelihoods [B, n + 1] f32)."""
    toks, liks = [tok], [lik]
    for i in range(n):
        with span("generate.step"):
            logits, cache = decode_step(cfg, params, tok, cache, t + i)
            tok, lik = _pick(logits)
        toks.append(tok)
        liks.append(lik)
    return torch.stack(toks, 1), torch.stack(liks, 1)


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` is a real CUDA tensor: neither fake nor a DTensor."""
    return x.is_cuda and not is_fake(x) and not is_sharded(x)


def _gqa_stack(params, pcache: dict) -> bool:
    """Whether the prefill cache is one GQA stack ``{"main": {"k",
    "v"}}`` (not RWKV6's or zamba's state, MLA's latents or a first dense
    stack) and no layer is MoE."""
    blocks = params["blocks"]
    first = blocks[0] if isinstance(blocks, list) else blocks
    return (set(pcache) == {"main"} and set(pcache["main"]) == {"k", "v"}
            and "moe" not in first)


def _graphable(params, logits: torch.Tensor, pcache: dict) -> bool:
    """Whether the call's decode loop can run as a CUDA graph."""
    return _gqa_stack(params, pcache) and all(
        _on_card(x) for x in (logits, *pcache["main"].values()))


def _storage(params) -> tuple:
    """Where each parameter lives and how it is laid out: what a graph
    captured over ``params`` reads."""
    leaves = []
    tree_map_with_path(lambda path, x: leaves.append(
        (path, x.data_ptr(), x.dtype, tuple(x.shape), x.stride())), params)
    return tuple(leaves)


class DecodeGraph:
    """One decode step and its token's pick, captured as a CUDA graph over
    static buffers: the token ``tok`` [B] int32, the position ``pos`` (0-d
    int64), the KV ``cache`` of ``max_len`` slots and, in the graph's
    pool, the step's likelihood. The parameters are not held: the key in
    ``GRAPHS`` ties a graph to their storage, and ``run`` takes them. The
    buffers serve one call at a time: hold ``lock`` from the graft to the
    end of ``run``."""

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int,
                 device: torch.device):
        self.cfg = cfg
        self.lock = threading.Lock()
        self.cache = make_cache(cfg, batch, max_len, device=device)
        self.tok = torch.zeros(batch, dtype=torch.int32, device=device)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.stream = torch.cuda.Stream(device)     # warm-up and capture
        self.graph: torch.cuda.CUDAGraph | None = None
        self.lik: torch.Tensor | None = None
        self.launches: dict[str, int] = {}   # kernel launches a replay makes
        self.release: weakref.finalize | None = None    # drops its key

    def graft(self, pcache: dict) -> None:
        """Copy the prefill's keys and values into the static cache, over
        slots [0, t) (under SWA with t past the window, its whole ring).
        The slots past t keep an earlier call's values: a step writes its
        slot before decode attention reads it, and reads none past it."""
        for name, src in pcache["main"].items():
            self.cache["main"][name][:, :, :src.shape[2]].copy_(src)

    def _step(self, params) -> torch.Tensor:
        """``decode_step`` at ``pos`` on ``tok`` and its pick, the token
        written back into ``tok``: the step's likelihood."""
        logits, _ = decode_step(self.cfg, params, self.tok, self.cache,
                                self.pos)
        tok, lik = _pick(logits)
        self.tok.copy_(tok)
        return lik

    def _capture(self, params) -> torch.Tensor:
        """Run the step eagerly on the side stream, then capture it;
        returns the eager step's likelihood. The wrappers count the
        captured launches once more, which nothing ran: they are taken
        off again and kept for each replay to add."""
        cur = torch.cuda.current_stream(self.tok.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            lik = self._step(params)
        cur.wait_stream(self.stream)
        lik.record_stream(cur)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            self.lik = self._step(params)
        after = launch_counts()
        self.launches = {k: v - before[k] for k, v in after.items()
                         if v != before[k]}
        add_launch_counts({k: -v for k, v in self.launches.items()})
        self.graph = graph
        return lik

    def replay(self, pos: int) -> torch.Tensor:
        """The captured step at position ``pos`` on ``tok``: the step's
        likelihood (the token is in ``tok``)."""
        self.pos.fill_(pos)
        self.graph.replay()
        add_launch_counts(self.launches)
        return self.lik

    def run(self, params, tok: torch.Tensor, lik: torch.Tensor, t: int,
            n: int):
        """``n`` decode steps after the prefill's token ``tok`` (likelihood
        ``lik``), the first at position ``t``, over the grafted cache:
        (tokens [B, n + 1] int32, likelihoods [B, n + 1] f32)."""
        b, dev = tok.shape[0], tok.device
        toks = torch.empty((b, n + 1), dtype=torch.int32, device=dev)
        liks = torch.empty((b, n + 1), dtype=torch.float32, device=dev)
        toks[:, 0] = tok
        liks[:, 0] = lik
        self.tok.copy_(tok)
        for i in range(n):
            with span("generate.step"):
                if self.graph is None:
                    self.pos.fill_(t + i)
                    step_lik = self._capture(params)
                else:
                    step_lik = self.replay(t + i)
                toks[:, i + 1] = self.tok
                liks[:, i + 1] = step_lik
        return toks, liks


# the last MAX_GRAPHS decode graphs by key, the least recently used first
GRAPHS: OrderedDict = OrderedDict()
_GRAPHS_LOCK = threading.RLock()    # re-entered by a release during a gc


def _drop(key) -> None:
    with _GRAPHS_LOCK:
        GRAPHS.pop(key, None)


def decode_graph(cfg: ModelConfig, params, batch: int, max_len: int,
                 device: torch.device) -> DecodeGraph:
    """The decode graph of this key: config, batch, cache length, device
    and the parameters' storage. A new key drops the least recently used
    graphs first, so that at most ``MAX_GRAPHS`` static caches are held,
    then makes its graph (captured at its first ``run``). A graph is
    dropped with its parameters (when ``params["final_norm"]`` is freed),
    or by ``release_graphs``."""
    key = (cfg, batch, max_len, device, _storage(params))
    with _GRAPHS_LOCK:
        graph = GRAPHS.pop(key, None)
        if graph is None:
            while len(GRAPHS) >= MAX_GRAPHS:
                GRAPHS.popitem(last=False)[1].release.detach()
            graph = DecodeGraph(cfg, batch, max_len, device)
            graph.release = weakref.finalize(params["final_norm"], _drop,
                                             key)
        GRAPHS[key] = graph
    return graph


def release_graphs() -> None:
    """Drop every decode graph, so that their caches and graph pools
    return to the allocator (once no call runs one)."""
    with _GRAPHS_LOCK:
        for graph in GRAPHS.values():
            graph.release.detach()
        GRAPHS.clear()


@torch.no_grad()
def greedy_generate(cfg: ModelConfig, params, prompt_batch: dict,
                    max_new_tokens: int):
    """prompt_batch: {"tokens": [B, T]}, {"embeds": [B, T, D]}, or both
    (a VLM: the embeddings first). Runs on the params' device with a
    cache of T + max_new_tokens slots (or the window, under SWA), T the
    whole prompt's length: decoding starts at position T. (JAX's
    ``greedy_generate`` takes T from the tokens alone when a prompt has
    both, so its decoding overwrites the patch prefix's slots; the port
    does not follow it there.) Returns (tokens [B, max_new_tokens]
    int32, likelihood [B, max_new_tokens] f32), both on that device."""
    with span("generate.prefill"):
        logits, pcache = prefill(cfg, params, prompt_batch)
        tok, lik = _pick(logits)
    parts = [prompt_batch[k].shape[:2] for k in ("embeds", "tokens")
             if k in prompt_batch]
    b, t = parts[0][0], sum(n for _, n in parts)
    n = max_new_tokens - 1
    dev = params["final_norm"].device
    if n > 0 and _graphable(params, logits, pcache):
        path = "graph"
        graph = decode_graph(cfg, params, b, t + max_new_tokens, dev)
        with graph.lock:
            with span("generate.graft"):
                graph.graft(pcache)
            del pcache
            toks, liks = graph.run(params, tok, lik, t, n)
    else:
        path = "eager"
        with span("generate.graft"):
            cache = graft(make_cache(cfg, b, t + max_new_tokens, device=dev),
                          pcache)
        toks, liks = _decode_eager(cfg, params, tok, lik, cache, t, n)
    SPANS.counter("generate_decode_steps_total", path=path).inc(max(n, 0))
    return toks, liks
