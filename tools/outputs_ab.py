"""The remote tier's outputs from two or more trees of this repo, bit for
bit, on one GPU.

    python3 tools/outputs_ab.py --tree parent=build/parent --tree change=. \
        [--arch yi-6b ...]

Each tree (a checkout of this repo; its ``src`` goes first on the path)
runs in a process of its own. For each arch, at full width with random
weights from a seed, it prefills 8 prompts of 512 tokens (seed 25, as
``chip_smoke.py``'s generate phases) and greedily generates 32 tokens
from them (``serving.greedy_generate``: the prefill, then a decode step
a token), and reports a SHA-256 digest of the bytes of every output: the
prefill's last-position logits and every leaf of its cache, and the
generated tokens and their likelihoods, with each tensor's dtype and
shape. Every tree's digests are then held to the first tree's: one JSON
line an arch with the outputs that differ, and a last line
``{"identical": true|false, ...}``. Exits 1 when any output differs.
Needs one GPU, or ``--device cpu --smoke`` (reduced configs) for a dry
run of the script.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ARCHS = ("yi-6b", "qwen2-7b", "h2o-danube-1.8b", "deepseek-v2-lite-16b",
         "rwkv6-1.6b", "zamba2-7b", "pixtral-12b")
ROWS, PROMPT, NEW = 8, 512, 32


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def _digest(t) -> str:
    import torch
    t = t.detach().contiguous().cpu()
    raw = t.view(torch.uint8) if t.dtype != torch.bool else t.to(torch.uint8)
    return (f"{str(t.dtype).replace('torch.', '')}{list(t.shape)} "
            + hashlib.sha256(raw.numpy().tobytes()).hexdigest())


def worker(archs, device: str, smoke: bool) -> None:
    """This tree's digests, one JSON line an arch."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serving.generate import greedy_generate
    dev = torch.device(device)
    rows, prompt_len, new = (2, 64, 4) if smoke else (ROWS, PROMPT, NEW)
    for arch in archs:
        cfg = configs.get_config(arch)
        if smoke:
            cfg = cfg.reduced()
        params = T.init_params(cfg, torch.Generator(dev).manual_seed(7))
        prompt = np.random.default_rng(25).integers(
            1, cfg.vocab_size, (rows, prompt_len))
        batch = {"tokens": torch.as_tensor(prompt, device=dev)}
        out = {}
        with torch.no_grad():
            logits, cache = T.prefill(cfg, params, batch)
            out["prefill/logits"] = _digest(logits)
            for name, leaf in _leaves(cache):
                out[f"prefill/cache/{name}"] = _digest(leaf)
            del logits, cache
            toks, liks = greedy_generate(cfg, params, batch, new)
            out["generate/tokens"] = _digest(toks)
            out["generate/likelihoods"] = _digest(liks)
        print(json.dumps({"arch": arch, "digests": out}), flush=True)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def run_tree(path: str, archs, device: str, smoke: bool) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.abspath(path),
                                                   "src"))
    argv = [sys.executable, os.path.abspath(__file__), "--worker",
            "--device", device, "--arch", *archs] + (["--smoke"] if smoke
                                                     else [])
    r = subprocess.run(argv, capture_output=True, text=True, env=env,
                       cwd=os.path.abspath(path))
    recs = [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]
    if r.returncode or len(recs) != len(archs):
        raise RuntimeError(f"{path}: rc {r.returncode}\n{r.stderr[-4000:]}")
    return {rec["arch"]: rec["digests"] for rec in recs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH, a checkout of this repo (two or more)")
    ap.add_argument("--arch", nargs="+", default=list(ARCHS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (a dry run of the script)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.arch, args.device, args.smoke)
        return 0
    if len(args.tree) < 2:
        ap.error("give two or more --tree NAME=PATH")
    trees = dict(t.split("=", 1) for t in args.tree)
    got = {name: run_tree(path, args.arch, args.device, args.smoke)
           for name, path in trees.items()}
    first, *others = got
    same = True
    for arch in args.arch:
        diff = {other: sorted(k for k, v in got[first][arch].items()
                              if got[other][arch].get(k) != v)
                for other in others}
        same &= not any(diff.values())
        print(json.dumps({"arch": arch, "outputs": len(got[first][arch]),
                          "differ_from_" + first: diff}), flush=True)
    print(json.dumps({"identical": same, "trees": list(trees),
                      "archs": list(args.arch)}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
