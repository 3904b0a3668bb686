"""Shared pieces of the benchmark's tests: the checkout's paths and the
tiny cells they run on the CPU."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# a dense GQA decoder in the yi-6b/qwen2-7b layout at tiny widths (group
# 2, QKV bias) for the CPU
TINY = {"name": "tiny", "family": "dense", "hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "num_hidden_layers": 2,
        "intermediate_size": 128, "vocab_size": 512, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "torch_dtype": "bfloat16", "qkv_bias": True}


def tiny_cell(workload: str):
    """``workload``'s cell with the tiny model and its mix cut to CPU
    sizes (the same loops, checks and limits). A workload that
    ``BENCHMARK.json`` does not list (the open loop, kept for a later
    cell) is made from its files: ``cells/<config>.<traffic>.json`` and
    ``traffic/<traffic>.json``."""
    from cascade_bench import spec
    try:
        cell = spec.cell(workload)
    except KeyError:
        traffic = workload.split(".", 1)[1]
        cell = spec.Cell(name=workload, config={},
                         traffic=spec.traffic(traffic),
                         limits=spec.limits(workload), chips=1,
                         end_to_end=[], per_layer=[])
    mix = copy.deepcopy(cell.traffic)
    if mix["loop"] == "qa":
        mix.update(batch=4, prompt_len=16, new_tokens=4, token_vocab=500)
    else:
        mix["task"].update(seq_len=32, token_vocab=500)
        mix["local"].update(max_len=16, vocab=64, train_steps=10)
        mix["serve"].update(batch_size=8, calibration_rows=16)
        mix.update(block=16)
        mix["check"].update(record_share=1.0, remote_rows=8)
        if mix["loop"] == "poisson":
            mix["rate"] = 40.0
    cell.config, cell.traffic = copy.deepcopy(TINY), mix
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
