"""A dry-run step's per-chip costs from both packages, side by side.

For each (arch, shape, mesh) it reports a chip's dot FLOPs, the bytes of
its temporaries and the bytes its collectives move, from

* JAX: the step lowered and compiled on forced host devices, as
  ``repro.launch.dryrun`` does. The temporaries are the compiled
  module's ``memory_analysis()`` (layers in a scan, full depth). The dot
  FLOPs (``analysis.roofline.fp32_dot_flops(text)[1]``) and collective
  bytes (``collective_bytes``) come from the partitioned HLO of
  unrolled lowerings (``scan_config.unrolled``): at the full depth when
  it is at most the second of ``_analysis_depths(cfg)``, else at both
  depths, extrapolated linearly to the full depth as
  ``roofline_extrapolated`` extrapolates;
* the port: the step run on fake tensors as rank 0 of a fake process
  group (``repro_torch.launch.specs.lower_step``), counted by
  ``analysis.roofline.measure`` (the dry-run's own numbers).

Each side runs in a subprocess of its own: jax fixes its device count
at its first import, and the port's fake process group is
process-global. Only this file imports both packages' names, and each
worker only its own.

Usage (from the repo root):
    PYTHONPATH=src:. python tests/dryrun_parity.py --arch yi-6b \\
        --shape prefill_32k [--mesh single|multi]
    PYTHONPATH=src:. python tests/dryrun_parity.py --all --both-meshes \\
        --json out.jsonl [--workers 3] [--port-before parent.jsonl]
    # --only jax|port: one side, no table (with --json, its records);
    # --port-before: another tree's ``repro_torch.launch.dryrun --json``
    # records, each port cell then read "before -> now"
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
ARCHS = ("deepseek-67b", "deepseek-v2-lite-16b", "h2o-danube-1.8b",
         "hubert-xlarge", "pixtral-12b", "qwen2-7b", "qwen3-moe-235b-a22b",
         "rwkv6-1.6b", "yi-6b", "zamba2-7b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def job(arch, shape, mesh="single", *, reduced=False, overrides=None):
    """One comparison: ``shape`` a name of ``INPUT_SHAPES`` or
    ``(seq_len, global_batch, kind)``; ``mesh`` "single", "multi" or an
    axis -> size dict; ``overrides`` ``dataclasses.replace`` fields of
    the (reduced) config, applied alike in both packages."""
    return {"arch": arch, "shape": shape if isinstance(shape, str)
            else list(shape), "mesh": mesh, "reduced": reduced,
            "set": dict(overrides or {})}


def key(j) -> str:
    return json.dumps([j["arch"], j["shape"], j["mesh"], j["reduced"],
                       j["set"]], sort_keys=True)


def _mesh_shape(mesh) -> dict:
    return MESHES[mesh] if isinstance(mesh, str) else dict(mesh)


def _size(mesh) -> int:
    n = 1
    for v in _mesh_shape(mesh).values():
        n *= v
    return n


# --------------------------------------------------------------------------
# the workers (one package each)
# --------------------------------------------------------------------------

def _config(pkg, j):
    import dataclasses
    cfg = pkg.get_config(j["arch"])
    if j["reduced"]:
        cfg = cfg.reduced()
    if j["set"]:
        cfg = dataclasses.replace(cfg, **j["set"])
    s = j["shape"]
    shape = pkg.INPUT_SHAPES[s] if isinstance(s, str) else \
        pkg.ShapeConfig("s", s[0], s[1], s[2])
    return cfg, shape


def _jax_one(j) -> dict:
    import dataclasses

    import jax

    from repro import configs
    from repro.analysis import roofline as jr
    from repro.launch.mesh import axis_type_kwargs
    from repro.launch.specs import lower_step
    from repro.models import scan_config
    cfg, shape = _config(configs, j)
    ok, why = configs.shape_applicable(cfg, shape)
    if not ok:
        return {"status": "skip", "reason": why}
    ms = _mesh_shape(j["mesh"])
    mesh = jax.make_mesh(tuple(ms.values()), tuple(ms),
                         **axis_type_kwargs(len(ms)))
    mem = lower_step(cfg, shape, mesh).compile().memory_analysis()

    def measure(layers):
        with scan_config.unrolled():
            text = lower_step(dataclasses.replace(cfg, num_layers=layers),
                              shape, mesh).compile().as_text()
        return (jr.fp32_dot_flops(text)[1], walked_dot_flops(jr, text),
                float(sum(jr.collective_bytes(text).values())))

    l1, l2 = jr._analysis_depths(cfg)
    full = cfg.num_layers
    if full <= l2:
        got = measure(full)
    else:
        m1, m2 = measure(l1), measure(l2)

        def extrap(v1, v2):         # roofline_extrapolated's, clamp kept
            b = (v2 - v1) / (l2 - l1)
            return max(v1 - b * l1 + b * full, v2)

        got = [extrap(a, b) for a, b in zip(m1, m2)]
    return {"status": "ok", "dot_flops": got[0], "walked_dot_flops": got[1],
            "temp_bytes": int(mem.temp_size_in_bytes),
            "argument_bytes": int(mem.argument_size_in_bytes),
            "coll_bytes": got[2]}


def walked_dot_flops(jr, text: str) -> float:
    """``jr.fp32_dot_flops(text)[1]`` with the whole HLO walked. JAX's
    walker misses dots in two places: its header pattern (``_COMP_HDR``)
    stops at a header's first ")", so a computation whose parameter is a
    tuple, as every ``while`` body's is (a scan's carry), is never found;
    and its instruction pattern (``_INSTR_RE``) takes no leading
    "ROOT", so a dot that ends its computation (a fusion of a bitcast
    and a dot, as a batch-1 decode's products are) counts zero. Under
    ``scan_config.unrolled`` the only loops left are the time
    recurrences (RWKV6's and mamba2's token scans). Both patterns are
    widened for this call only."""
    import re
    old = jr._COMP_HDR, jr._INSTR_RE
    jr._COMP_HDR = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->")
    jr._INSTR_RE = re.compile(
        r"^(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*([a-z0-9]+)\[([0-9,]*)\]")
    try:
        return jr.fp32_dot_flops(text)[1]
    finally:
        jr._COMP_HDR, jr._INSTR_RE = old


_PORT_MESH = {}


def _port_one(j) -> dict:
    from repro_torch import configs
    from repro_torch.analysis.roofline import measure
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.launch.specs import lower_step
    cfg, shape = _config(configs, j)
    ok, why = configs.shape_applicable(cfg, shape)
    if not ok:
        return {"status": "skip", "reason": why}
    ms = _mesh_shape(j["mesh"])
    name = json.dumps(ms)
    if name not in _PORT_MESH:      # one fake group a worker: one mesh
        _PORT_MESH[name] = device_mesh(Mesh(ms), "fake")
    lowered = lower_step(cfg, shape, _PORT_MESH[name])
    t = measure(lowered)
    return {"status": "ok", "dot_flops": t.total_dot_flops,
            "temp_bytes": max(t.peak_bytes - t.output_bytes, 0),
            "argument_bytes": lowered.argument_bytes(),
            "coll_bytes": float(sum(t.coll.values()))}


def _worker(side: str, jobs: list) -> None:
    one = _jax_one if side == "jax" else _port_one
    for j in jobs:
        t0 = time.perf_counter()
        try:
            rec = one(j)
        except Exception as e:      # a failed combo is a record, not a stop
            rec = {"status": "fail", "error": f"{type(e).__name__}: {e}"}
        rec.update(job=j, side=side,
                   seconds=round(time.perf_counter() - t0, 1))
        print(json.dumps(rec), flush=True)


# --------------------------------------------------------------------------
# driving both
# --------------------------------------------------------------------------

def _spawn(side: str, jobs: list, timeout: float) -> list:
    """Run ``jobs`` on one side in a subprocess; its records."""
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    if side == "jax":
        n = max(_size(j["mesh"]) for j in jobs)
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    r = subprocess.run([sys.executable, __file__, "--side", side,
                        "--jobs", json.dumps(jobs)], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=ROOT)
    recs = [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]
    if r.returncode or len(recs) != len(jobs):
        raise RuntimeError(f"{side} worker rc {r.returncode}, "
                           f"{len(recs)} of {len(jobs)} records:\n"
                           f"{r.stderr[-4000:]}")
    return recs


def run(jobs: list, *, sides=("jax", "port"), workers: int = 1,
        timeout: float = 7200) -> dict:
    """Each side's records of ``jobs``, keyed by side then by ``key``.
    The port's jobs go to one worker a mesh (its fake group), split
    further over ``workers``; JAX's over ``workers``."""
    tasks = []
    for side in sides:
        groups = {}
        for j in jobs:
            groups.setdefault(json.dumps(_mesh_shape(j["mesh"]))
                              if side == "port" else "", []).append(j)
        for g in groups.values():
            n = min(workers, len(g))
            tasks += [(side, g[i::n]) for i in range(n)]
    out = {s: {} for s in sides}
    if not tasks:
        return out
    with ThreadPoolExecutor(len(tasks)) as pool:
        for recs in pool.map(lambda t: _spawn(*t, timeout), tasks):
            for r in recs:
                out[r["side"]][key(r["job"])] = r
    return out


def load(path: str) -> dict:
    """The port's records from a JSONL: this tool's (``--only port
    --json``), or ``repro_torch.launch.dryrun --json``'s (production
    meshes)."""
    out = {}
    for ln in Path(path).read_text().splitlines():
        r = json.loads(ln)
        if "job" not in r:          # a repro_torch.launch.dryrun record
            j = job(r["arch"], r["shape"], r["mesh"])
            r = {"job": j, "side": "port", "status": r["status"],
                 **({"dot_flops": r["roofline"]["flops_per_chip"],
                     "temp_bytes": r["memory"]["temp_size_in_bytes"],
                     "argument_bytes":
                         r["memory"]["argument_size_in_bytes"],
                     "coll_bytes": r["roofline"]["coll_bytes_per_chip"]}
                    if r["status"] == "ok" else {})}
        if r["side"] == "port":
            out[key(r["job"])] = r
    return out


def table(jobs: list, recs: dict, before: dict | None = None) -> str:
    """A markdown table, one row per (arch, shape), each cell one value
    per mesh in the order run (joined by " / "): JAX's dot FLOPs a chip,
    the port's over JAX's (also over JAX's count with its loops walked,
    ``walked_dot_flops``), and both sides' temporaries and collective
    bytes a chip (GB). With ``before`` (the port's records of another
    tree) each port cell reads "before -> now"."""
    def name(v):
        return v if isinstance(v, str) else "x".join(map(str, (
            v.values() if isinstance(v, dict) else v)))

    groups = {}
    for j in jobs:
        groups.setdefault(json.dumps([j["arch"], j["shape"], j["reduced"],
                                      j["set"]]), []).append(j)
    meshes = " / ".join(dict.fromkeys(name(j["mesh"]) for j in jobs))
    rows = [f"| arch | shape | JAX dot FLOPs ({meshes}) | port / JAX "
            "| port / JAX, loops walked | JAX temp GB | port temp GB "
            "| JAX coll GB | port coll GB |",
            "| --- | --- | --- | --- | --- | --- | --- | --- | --- |"]

    def ok(r):
        return r.get("status") == "ok"

    for group in groups.values():
        cells = [[] for _ in range(7)]
        for j in group:
            a = recs["jax"].get(key(j), {})
            p = recs["port"].get(key(j), {})
            b = (before or {}).get(key(j), {})
            if not (ok(a) and ok(p)):
                continue

            def port(f, r=p):
                now = f(r)
                return f"{f(b)} \u2192 {now}" if ok(b) else now

            cells[0].append(f"{a['dot_flops']:.4g}")
            cells[1].append(port(
                lambda r: f"{r['dot_flops'] / a['dot_flops']:.3f}"))
            cells[2].append(port(
                lambda r: f"{r['dot_flops'] / a['walked_dot_flops']:.3f}")
                if a.get("walked_dot_flops") else "-")
            cells[3].append(f"{a['temp_bytes'] / 1e9:.2f}")
            cells[4].append(port(lambda r: f"{r['temp_bytes'] / 1e9:.2f}"))
            cells[5].append(f"{a['coll_bytes'] / 1e9:.2f}")
            cells[6].append(port(lambda r: f"{r['coll_bytes'] / 1e9:.2f}"))
        if cells[0]:
            j = group[0]
            rows.append(f"| {j['arch']} | {name(j['shape'])} | "
                        + " | ".join(" / ".join(c) for c in cells) + " |")
    return "\n".join(rows)


def over_hbm(side: dict, jobs: list, limit: float = 80e9) -> str:
    """"n of m": of the jobs ``side`` ran, those whose arguments and
    temporaries pass ``limit`` bytes a chip (the H100's 80 GB)."""
    rs = [side.get(key(j), {}) for j in jobs]
    rs = [r for r in rs if r.get("status") == "ok" and "argument_bytes" in r]
    n = sum(r["argument_bytes"] + r["temp_bytes"] > limit for r in rs)
    return f"{n} of {len(rs)}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", choices=("jax", "port"), help="worker mode")
    ap.add_argument("--jobs", help="worker mode: the jobs, as JSON")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=tuple(MESHES))
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape of the production matrix")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--port-before", help="the port's records of another "
                    "tree (``repro_torch.launch.dryrun --json``'s): port "
                    "cells read before -> now")
    ap.add_argument("--only", choices=("jax", "port"),
                    help="run this side only (no table)")
    ap.add_argument("--json", help="append every record run to this JSONL")
    args = ap.parse_args(argv)
    if args.side:
        _worker(args.side, json.loads(args.jobs))
        return 0

    meshes = ["single", "multi"] if args.both_meshes else [args.mesh]
    if args.all:
        combos = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    jobs = [job(a, s, m) for m in meshes for a, s in combos]
    sides = [args.only] if args.only else ["jax", "port"]
    recs = run(jobs, sides=sides, workers=args.workers)
    if args.json:
        with open(args.json, "a") as f:
            for side in recs.values():
                for r in side.values():
                    f.write(json.dumps(r) + "\n")
    if not args.only:
        before = args.port_before and load(args.port_before)
        print(table(jobs, recs, before))
        print("\nover 80 GB a chip (arguments + temporaries): JAX "
              f"{over_hbm(recs['jax'], jobs)}, "
              f"port {over_hbm(recs['port'], jobs)}"
              + (f" (before: {over_hbm(before, jobs)})" if before else ""))
    bad = [k for side in recs.values() for k, r in side.items()
           if r["status"] == "fail"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
