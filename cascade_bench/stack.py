"""The system under test, built from a cell's files and the run's seed.

``Classify`` builds the cascade the way ``repro_torch.launch.serve.run``
does: ``ServeConfig(...).build(local_apply, transport=router,
cache=cache, fallback=...)`` with ``build_router`` and a response cache
keyed on token content, and a ``MicrobatchScheduler`` in front. The
local tier is the port's surrogate (``models.surrogate.apply``) on the
weights the harness trained; the remote tier is the harness's closure
around ``models.transformer.prefill`` at full width, whose last-position
logits jitter a readout of the labels (as ``launch/serve.py`` does), so
that the 2nd supervisor sees an accurate remote.

``Generate`` drives ``serving.generate.greedy_generate`` and
``core.supervisors.seq_min_likelihood``: the remote half of the paper's
SQuAD v2 cascade.

The inputs and weights come from the seed and are made here: tokens and
labels from ``traffic/synthetic.py``, the remote weights from
``traffic/weights.py`` on the device, the surrogate from the reference's
trainer. What the program returns is recorded for the check after the
window: the local tier's logits of every window, the remote prefill's
logits of whole remote windows (a share drawn from the seed), and the
generated tokens and likelihoods.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from cascade_bench.reference import family
from cascade_bench.reference import surrogate as ref_surrogate
from cascade_bench.reference.supervisors import nominal_quantile_threshold
from cascade_bench.traffic import synthetic, weights

# rows drawn at once for the window (each block from a generator of its
# own, so that a run draws only what it serves)
BLOCK = 128
# the streams of the run's seed: np.random.default_rng([seed, STREAM, ...])
TEACHER, TRAIN, ARRIVALS, CHECK, WINDOW, RECORD, PROMPTS = range(7)


def model_config(config: dict):
    """The port's ``ModelConfig`` for a ``configs/*.json`` dict."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**family(config).port_fields(config))


def stream(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), *keys])


def torch_seed(seed: int, *keys: int) -> int:
    """A 64-bit seed for a ``torch.Generator`` from the run's seed."""
    return int(np.random.SeedSequence([int(seed), *keys])
               .generate_state(1, np.uint64)[0])


class Phases:
    """Seconds each step of set-up took (``mark`` closes a step)."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds: dict = {}

    def mark(self, name: str) -> None:
        now_ = time.perf_counter()
        self.seconds[name] = now_ - self.t
        self.t = now_


def _span(name: str):
    return torch.profiler.record_function(name)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Classify:
    """The classification cascade of one cell (see the module's doc)."""

    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device):
        from repro_torch.models import surrogate as S
        from repro_torch.models import transformer as T
        from repro_torch.runtime import content_key, content_keys
        from repro_torch.serving import ServeConfig
        from repro_torch.serving.engine import CostModel

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.phases = Phases()
        self.family = family(config)
        self.widths = self.family.widths(config)
        task, local, serve = mix["task"], mix["local"], mix["serve"]
        self.num_classes = task["num_classes"]
        self.seq_len = task["seq_len"]
        self.batch = serve["batch_size"]

        # ---- inputs: one teacher; the surrogate's training rows, then
        # the window's rows in blocks, each drawn when first served
        self.teacher = synthetic.teacher(
            stream(seed, TEACHER), vocab=task["token_vocab"],
            seq_len=self.seq_len, num_classes=self.num_classes)
        self.train_toks, self.train_labels = self._examples(
            stream(seed, TRAIN), local["train_examples"])
        self.train_local = self._local(self.train_toks)
        self._blocks: dict = {}
        self.phases.mark("inputs")

        # ---- weights: the remote drawn on the card, the surrogate trained
        self.local_spec = {**local, "num_classes": self.num_classes}
        self.sparams = ref_surrogate.train(
            self.local_spec, torch.as_tensor(self.train_local, device=device),
            torch.as_tensor(self.train_labels, device=device), seed)
        sync(device)
        self.phases.mark("surrogate_trained")
        self.rparams = weights.draw(config, seed, device)
        sync(device)
        self.phases.mark("weights")
        self.rcfg = model_config(config)
        self.scfg = S.SurrogateConfig(
            "local", vocab_size=local["vocab"], max_len=local["max_len"],
            d_model=local["d_model"], num_heads=local["num_heads"],
            d_ff=local["d_ff"], num_classes=self.num_classes, dropout=0.0)

        # ---- what the window records: every local call, and whole
        # remote windows (every row of each), a share drawn from the seed
        self._lock = threading.Lock()
        self.recording = False
        self.local_calls: list = []      # (uids, logits), dispatch order
        self.remote_rows: list = []      # rows of each remote prefill
        self.remote_windows: list = []   # (uids, logits [rows, V])
        record = stream(seed, RECORD)
        share = float(mix["check"]["record_share"])
        margin = float(mix["oracle_margin"])
        jitter = float(mix["jitter"])
        ncls = self.num_classes

        @torch.no_grad()
        def local_apply(x):
            with _span("bench.local_tier"):
                out = S.apply(self.scfg, self.sparams, x["tokens"])
            if self.recording:
                self.local_calls.append((x["uid"], out))
            return out

        @torch.no_grad()
        def remote_apply(batch):
            with _span("bench.remote_prefill"):
                tk = torch.as_tensor(batch["tokens"], device=device)
                lab = torch.as_tensor(batch["label"], device=device).long()
                logits, _ = T.prefill(self.rcfg, self.rparams, {"tokens": tk})
                out = (torch.nn.functional.one_hot(lab, ncls).float() * margin
                       + jitter * logits[:, :ncls].float())
            if self.recording:
                with self._lock:
                    self.remote_rows.append(int(tk.shape[0]))
                    if record.random() < share:
                        self.remote_windows.append(
                            (np.asarray(batch["uid"]).copy(), logits.clone()))
            return out

        self.local_apply, self.remote_apply = local_apply, remote_apply

        # ---- the 2nd supervisor's threshold, from a calibration sample
        # (rows the window never serves), in the transport's windows
        self.cfg = ServeConfig(
            batch_size=self.batch,
            remote_fraction_budget=serve["remote_fraction_budget"],
            target_rejection_rate=serve["fpr"],
            pipeline_depth=serve["pipeline_depth"],
            completion_mode=serve["completion_mode"], cost=CostModel())
        self.window_rows = self.cfg.transport.max_in_flight
        self.calibration = serve["calibration_rows"]
        w = self.window_rows
        outs = [self._remote_rows_out(self.train_toks[i:i + w],
                                      self.train_labels[i:i + w])
                for i in range(0, self.calibration, w)]
        conf = np.concatenate([torch.softmax(o, -1).amax(-1).cpu().numpy()
                               for o in outs])
        self.t_remote = nominal_quantile_threshold(conf, serve["fpr"])
        self.cfg = dataclasses.replace(self.cfg, t_remote=self.t_remote)
        self.phases.mark("calibration")

        self.router = self.cfg.build_router(remote_apply)
        cache = self.cfg.build_cache(
            key_fn=lambda row: content_key(row["tokens"]),
            key_batch_fn=lambda b, n: content_keys(b["tokens"], n))
        self.engine, self.scheduler = self.cfg.build(
            local_apply, transport=self.router, cache=cache,
            fallback=lambda r: -1, device=device)
        self.price = self.cfg.cost.remote_cost_per_request
        self.capacity = self.engine.capacity

    def _examples(self, rng, n: int):
        return synthetic.examples(rng, self.teacher, n=n,
                                  seq_len=self.seq_len)

    def _local(self, toks):
        local = self.mix["local"]
        return synthetic.local_view(toks, local["max_len"], local["vocab"])

    def block(self, b: int):
        """Window rows ``b * BLOCK`` .. : (tokens, local view, labels)."""
        if b not in self._blocks:
            toks, labels = self._examples(stream(self.seed, WINDOW, b), BLOCK)
            self._blocks[b] = (toks, self._local(toks), labels)
        return self._blocks[b]

    def rows(self, uids):
        """(tokens, local view, labels) of the window rows ``uids``."""
        got = [tuple(p[int(u) % BLOCK] for p in self.block(int(u) // BLOCK))
               for u in uids]
        return tuple(np.stack(col) for col in zip(*got))

    def _remote_rows_out(self, toks, labels):
        return self.remote_apply({"tokens": toks, "label": labels,
                                  "uid": np.zeros(len(toks), np.int64)})

    def request(self, uid: int, train: bool = False):
        """The ``Request`` of window row ``uid`` (of the training rows
        when ``train``: rows the window never serves)."""
        from repro_torch.serving.scheduler import Request
        if train:
            toks, lt, lab = (self.train_toks[uid], self.train_local[uid],
                             self.train_labels[uid])
            uid_v = np.int64(-1 - uid)
        else:
            toks, lt, lab = (p[uid % BLOCK] for p in self.block(uid // BLOCK))
            uid_v = np.int64(uid)
        return Request(uid=int(uid_v),
                       local_input={"tokens": lt, "uid": uid_v},
                       remote_input={"tokens": toks, "label": np.int32(lab),
                                     "uid": uid_v})

    def window_sizes(self) -> list:
        """The remote prefill's row counts that the window's traffic
        makes: each local window escalates ``min(capacity, real)`` rows,
        sent in transport windows of at most ``window_rows``; the backlog
        serves full local windows only, the open loop any number of
        real rows."""
        reals = ([self.batch] if self.mix["loop"] == "backlog"
                 else range(1, self.batch + 1))
        w, sizes = self.window_rows, set()
        for real in reals:
            k = min(self.capacity, real)
            sizes.update([w] * (k // w) + ([k % w] if k % w else []))
        return sorted(sizes)

    def warm_up(self) -> None:
        """The shapes the window uses: the remote prefill at every
        ``window_sizes``, then the serving path end to end on training
        rows."""
        for rows in self.window_sizes():
            self._remote_rows_out(self.train_toks[:rows],
                                  self.train_labels[:rows])
        n = min(len(self.train_toks), 4 * self.batch)
        for i in range(n):
            self.scheduler.submit(self.request(i, train=True))
        self.scheduler.flush()
        sync(self.device)
        self.phases.mark("warm_up")

    def close(self) -> None:
        self.engine.close()


class Generate:
    """Batches of greedy answers: ``greedy_generate`` on ``batch``
    prompts of ``prompt_len`` tokens, ``new_tokens`` answer tokens, then
    each answer's least token likelihood (``seq_min_likelihood``)."""

    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.phases = Phases()
        self.family = family(config)
        self.widths = self.family.widths(config)
        self.rcfg = model_config(config)
        self.batch, self.prompt_len = mix["batch"], mix["prompt_len"]
        self.new_tokens = mix["new_tokens"]
        self.rparams = weights.draw(config, seed, device)
        sync(device)
        self.phases.mark("weights")
        self.calls: list = []       # (call, tokens, likelihoods, minlik)

    def prompts(self, c: int) -> torch.Tensor:
        """Call ``c``'s prompts [batch, prompt_len], drawn on the device
        from a generator of their own (call 0 warms up)."""
        gen = torch.Generator(self.device).manual_seed(
            torch_seed(self.seed, PROMPTS, c))
        return torch.randint(1, self.mix["token_vocab"],
                             (self.batch, self.prompt_len), generator=gen,
                             device=self.device, dtype=torch.int32)

    def call(self, c: int):
        from repro_torch.core.supervisors import seq_min_likelihood
        from repro_torch.serving.generate import greedy_generate
        with _span("bench.generate"):
            toks, liks = greedy_generate(
                self.rcfg, self.rparams, {"tokens": self.prompts(c)},
                self.new_tokens)
            minlik = seq_min_likelihood(liks)
        with _span("bench.handback"):
            host = minlik.cpu()     # the answers reach the host
        return toks, liks, minlik, host

    def warm_up(self) -> None:
        self.call(0)
        sync(self.device)
        self.phases.mark("warm_up")


STACKS = {"backlog": Classify, "poisson": Classify, "qa": Generate}


def build(config: dict, mix: dict, seed: int, device):
    return STACKS[mix["loop"]](config, mix, seed, device)


def now() -> float:
    return time.perf_counter()
