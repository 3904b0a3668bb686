"""Serve-path throughput of two or more trees of this repo, in one call.

    python3 tools/serve_ab.py --tree parent=build/parent --tree change=. \
        [--variant change:nostream] [--rounds 3] [--out PATH]

Each tree (a checkout of this repo; its ``src`` goes first on the path)
serves the same stack in a process of its own: ``repro_torch.launch.serve``
at its defaults (yi-6b at full width, random weights from the seed, the
trained surrogate), 256 requests, batch 32, remote budget 0.3, as
``chip_smoke.py``'s serve phases. The trees run in the order A B B A for
each round, so a drift of the machine in the call falls on both alike.

In each process, after the stack is built:

- ``serve``: ``serve.run`` once, the launcher's path with its response
  cache, as ``chip_smoke.py``'s serve phase (the first run of the stack);
- then ``--reps`` times each: ``window`` (the window drain, no cache),
  ``streaming`` (streaming completion at pipeline depth 2),
  ``continuous`` (continuous batching, streaming, depth 2, observability
  on: ``chip_smoke.py``'s ``serve_early_emit`` settings, early emit as
  ``from_config`` picks it) and ``continuous_1worker`` (the same with one
  transport worker).

Each run reports requests/s over the flush and the mean remote window
latency (ms). A digest of every response and the billing must agree
across the modes of a process; whether it agrees across processes is
reported (on the CPU the stack's training is not bitwise repeatable from
one process to the next). ``--variant TREE:NAME`` adds a run of TREE with the
engine changed in process, to find what a difference comes from:
``syncfetch`` lands the gate triple with a synchronous copy instead of
the pinned non-blocking one; ``nostream``, for a tree whose engine runs
the gated local step on a CUDA stream of its own (``_stream``), runs it
on the current stream. Needs one GPU, or ``--device
cpu --smoke`` for a dry run of the script.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time

N_REQ = 256
SERVE_ARGV = ["--requests", str(N_REQ), "--batch", "32",
              "--remote-budget", "0.3"]
TIMEOUT = "transport.timeout_s=300"
MODES = {
    "window": [TIMEOUT],
    "streaming": ["pipeline_depth=2", "completion_mode=streaming", TIMEOUT],
    "continuous": ["batching=continuous", "completion_mode=streaming",
                   "pipeline_depth=2", "observability=True", TIMEOUT],
    "continuous_1worker": ["batching=continuous", "completion_mode=streaming",
                           "pipeline_depth=2", "observability=True",
                           "transport.max_concurrent=1", TIMEOUT],
}


def apply_variant(name: str) -> None:
    """Change the engine in this process (module docstring)."""
    import torch

    from repro_torch.serving import engine as E
    if name == "nostream":
        init = E.CascadeEngine.__init__

        def no_stream(self, *a, **kw):
            init(self, *a, **kw)
            if not hasattr(self, "_stream"):
                raise SystemExit("nostream: this engine has no stream of "
                                 "its own")
            self._stream = None

        E.CascadeEngine.__init__ = no_stream
    elif name == "syncfetch":
        from repro_torch.kernels.gate_fetch import TRIPLE, PendingTriple

        def sync_fetch(out):
            return PendingTriple(tuple(out[k].cpu() for k in TRIPLE), None)

        E.start_fetch = sync_fetch
    elif name:
        raise SystemExit(f"unknown variant {name!r}")
    torch.zeros(1)


def digest(rows, billing) -> str:
    return hashlib.sha256(json.dumps([rows, billing]).encode()).hexdigest()[:16]


def one(tree: str, variant: str, reps: int, device_argv: list) -> dict:
    """Serve every mode on ``tree``'s package (runs in its own process)."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch import serve
    from repro_torch.serving import Request
    from repro_torch.serving.engine import BILLING_FIELDS
    apply_variant(variant)

    args = serve.parse_args(SERVE_ARGV + device_argv)
    stack = serve.build_stack(args)
    cuda = stack.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def remote_ms(router):
        lat = [b.stats.mean_latency_s for b in router
               if b.stats.mean_latency_s is not None]
        return float(np.mean(lat)) * 1e3 if lat else None

    def billing(eng):
        return {f: getattr(eng.stats, f) for f in BILLING_FIELDS}

    sync()
    with contextlib.redirect_stdout(io.StringIO()):
        res = serve.run(args, stack)
    sync()
    rows = sorted((r.uid, int(r.prediction), r.source, r.disposition,
                   r.cost) for r in res.responses)
    out = {"serve": [{"req_per_s": N_REQ / res.wall_s,
                      "remote_ms": remote_ms(res.engine.router),
                      "digest": digest(rows, billing(res.engine))}]}
    for _ in range(reps):
        for mode, sets in MODES.items():
            cfg = stack.cfg.with_overrides(sets)
            router = cfg.build_router(stack.remote_apply)
            eng, sched = cfg.build(stack.local_apply, transport=router,
                                   cache=None, fallback=lambda r: -1,
                                   device=stack.device)
            sync()
            t0 = time.perf_counter()
            try:
                for i in range(N_REQ):
                    sched.submit(Request(
                        uid=i, local_input=stack.local_toks[i],
                        remote_input={"tokens": stack.toks[i]
                                      % stack.rcfg.vocab_size,
                                      "idx": np.int32(i)}))
                got = sched.flush()
            finally:
                eng.close()
            sync()
            wall = time.perf_counter() - t0
            rows = sorted((r.uid, int(r.prediction), r.source,
                           r.disposition, r.cost) for r in got)
            assert len(rows) == N_REQ, len(rows)
            out.setdefault(mode, []).append({
                "req_per_s": N_REQ / wall, "remote_ms": remote_ms(router),
                "early_emit": bool(getattr(eng, "early_emit", False)),
                "digest": digest(rows, billing(eng))})
    return out


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of a checkout (give two or more)")
    ap.add_argument("--variant", action="append", default=[],
                    help="TREE:NAME, a tree run with a changed engine")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None, help="write every run as JSON")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--one", nargs=2, metavar=("PATH", "VARIANT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device_argv = ["--device", args.device] + (["--smoke"] if args.smoke
                                               else [])
    if args.one:
        print(json.dumps(one(args.one[0], args.one[1], args.reps,
                             device_argv)), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    arms = [(name, name, "") for name in trees]
    for v in args.variant:
        tree, name = v.split(":", 1)
        arms.append((f"{tree}+{name}", tree, name))
    if len(arms) < 2:
        ap.error("give at least two trees, or a tree and a variant")
    here = os.path.abspath(__file__)
    print(card(), flush=True)
    runs = []
    for r in range(args.rounds):
        order = arms if r % 2 == 0 else arms[::-1]
        for arm, tree, variant in order:
            cmd = [sys.executable, here, "--one", trees[tree], variant,
                   "--reps", str(args.reps), "--device", args.device]
            cmd += ["--smoke"] if args.smoke else []
            p = subprocess.run(cmd, capture_output=True, text=True)
            if p.returncode != 0:
                sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
                raise SystemExit(f"{arm} failed (rc {p.returncode})")
            got = json.loads(p.stdout.strip().splitlines()[-1])
            runs.append({"round": r, "arm": arm, **got})
            print(json.dumps({"round": r, "arm": arm, **{
                m: [round(x["req_per_s"], 1) for x in xs]
                for m, xs in got.items()}}), flush=True)
    per_run = [{x["digest"] for xs in run.values() if isinstance(xs, list)
                for x in xs} for run in runs]
    same = all(len(d) == 1 for d in per_run)
    across = len(set().union(*per_run)) == 1
    summary = {}
    for arm, _, _ in arms:
        for m in ["serve", *MODES]:
            xs = [x for run in runs if run["arm"] == arm for x in run[m]]
            summary.setdefault(m, {})[arm] = {
                "req_per_s": [x["req_per_s"] for x in xs],
                "median_req_per_s": sorted(
                    x["req_per_s"] for x in xs)[len(xs) // 2],
                "remote_ms": [x["remote_ms"] for x in xs]}
    result = {"card": card(), "rounds": args.rounds, "reps": args.reps,
              "arms": [a for a, _, _ in arms], "same_answers": same,
              "same_answers_across_processes": across,
              "summary": summary, "runs": runs}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    for m, by_arm in summary.items():
        print(m, json.dumps({a: round(v["median_req_per_s"], 1)
                             for a, v in by_arm.items()}), flush=True)
    print(json.dumps({"same_answers": same,
                      "same_answers_across_processes": across}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
