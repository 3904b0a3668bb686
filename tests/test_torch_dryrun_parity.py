"""The dry-run's per-chip counts against JAX's partitioner, on a mesh
whose ``model`` axis the KV heads do not divide.

``tests/dryrun_parity.py`` runs each package's side in a subprocess of
its own: JAX's step compiled on 8 forced host devices, its dot FLOPs
read from the partitioned HLO (``fp32_dot_flops(text)[1]``); the port's
step run on fake tensors as rank 0 of a fake process group of 8 ranks
(``analysis.roofline.measure``). Reduced yi-6b with its (query, KV)
heads replaced alike in both packages by (8, 2), (8, 1) and (6, 2),
head_dim 32, on a data 2 x model 4 mesh, T = 64, batch 4 (2 rows a
chip). The reduced configs' own 4 / 4 heads never reach this case.

Tolerances. Prefill and decode: equal to the FLOP. Train: within 3%, the
margin of ``test_torch_analysis.test_dot_flops_agree_with_jax_hlo`` (the
CE chunk's recompute; equal at this size). One gap the partitioner
forces: 6 query heads in 2 groups of 3 on 4 ranks. GSPMD splits the KV
heads 2 ways and head_dim the other 2 ways (each chip's logits a partial
sum, all-reduced): 1.5 heads' work a chip. The port keeps whole heads,
split as ``torch.chunk`` splits them (2, 2, 2, 0), so rank 0 runs 2.
The test adds that half head's attention products to JAX's count:
4 rows T^2 hd a layer in the forward (QK^T and PV), 4 times that in the
remat'd train step (the forward, its recompute, and two products each in
the backward of QK^T and of PV).

The recurrences (production mesh, before this test: rwkv6 prefill 1.22x
JAX's count, zamba2 1.35x). Each package was off:

* JAX's count is short. ``fp32_dot_flops`` finds each computation by a
  header pattern that stops at the header's first ")", so a computation
  whose parameter is a tuple, as every ``while`` body's is (a scan's
  carry), is never found and its dots count zero times. Under
  ``scan_config.unrolled`` the only loops left are the time scans: the
  RWKV6 r.S products and mamba2's S.c, every step of them uncounted.
  Its instruction pattern also takes no leading "ROOT", so a dot that
  ends its computation counts zero: a batch-1 decode's products, fused
  with a bitcast (long_500k: rwkv6 556x, h2o-danube 8.4x). Walked whole
  (``dryrun_parity.walked_dot_flops``), JAX's count equals the port's,
  whose per-step charge of a recurrence equals a real run's
  (``test_recurrence_charged_per_step_counts_every_step``). At full
  width the loops are a small share (rwkv6 prefill_32k: 1.002x JAX's
  own count, 1.000x walked).
* The port did redundant work. zamba2's shared block, in prefill and
  decode, took the residual stream as a mamba2 layer leaves it, split
  over d_model: its head projections gave partial sums and every rank
  ran all heads. rwkv6's six LoRA pairs a layer ran whole on every rank
  where GSPMD splits them over ``model``. Both are repaired
  (``transformer._zamba_prefill``, ``rwkv6._lora_apply``) and pinned
  below on the same mesh.

At full width, yi-6b prefill_32k on the single-pod mesh is held to the
margin over JAX's count that ``chip_smoke.py``'s ``dryrun`` phase holds
the card's run to (its ``JAX_DOT_FLOPS``, from this tool), on every CPU
run too.

deepseek-v2-lite counts 0.35x JAX's in prefill_32k: the port's MoE
multiplies each expert's routed rows only (an even share of the pairs
on fake tensors, exact when dropless), where JAX multiplies a dense
[groups, experts, capacity, D] buffer whose capacity, dropless in
serving, is the group's whole token count.
"""

from __future__ import annotations

import math

import pytest

pytest.importorskip("torch")

from tests import dryrun_parity as dp  # noqa: E402

MESH = {"data": 2, "model": 4}
T, BATCH, HD, LAYERS = 64, 4, 32, 2
HEADS = [(8, 2), (8, 1), (6, 2)]
KINDS = ["train", "prefill", "decode"]
TRAIN_TOL = 0.03
# where JAX's own count misses dots, on the same mesh: the recurrences'
# prefill (loops) and a batch-1 decode (dots that end a fusion)
WALKED = {"rwkv6-1.6b prefill": ("rwkv6-1.6b", (T, BATCH, "prefill")),
          "zamba2-7b prefill": ("zamba2-7b", (T, BATCH, "prefill")),
          "yi-6b decode batch 1": ("yi-6b", (T, 1, "decode"))}
# a batch of one leaves the batch axes idle; where their size is a
# multiple of ``model``'s, GSPMD lays d_model over them
# (``launch.sharding.width_axes``), and a chip's count is JAX's walked
# whole. (arch, mesh, shape, config overrides): the 256-slot decode of
# the dry-run's ``long_500k`` cut to size; on 2 x 4 nothing splits; with
# 2 KV heads on 4 the cache shards its slots and each chip weights the
# values of a quarter of the heads (``layers._idle_heads``); a prefill
IDLE_DECODE = (256, 1, "decode")
IDLE = {
    **{f"{a} {m}": (a, m, IDLE_DECODE, {})
       for a in ("yi-6b", "h2o-danube-1.8b", "rwkv6-1.6b")
       for m in ("4x4", "4x2", "2x2")},
    "zamba2-7b 4x4": ("zamba2-7b", "4x4", IDLE_DECODE, {}),
    "h2o-danube-1.8b 2x4": ("h2o-danube-1.8b", "2x4", IDLE_DECODE, {}),
    "h2o-danube-1.8b 4x4 8q2kv": (
        "h2o-danube-1.8b", "4x4", IDLE_DECODE,
        {"num_heads": 8, "num_kv_heads": 2, "head_dim": 32}),
    "h2o-danube-1.8b pod 2x2x2": ("h2o-danube-1.8b", "2x2x2",
                                  IDLE_DECODE, {}),
    "h2o-danube-1.8b 4x4 prefill": ("h2o-danube-1.8b", "4x4",
                                    (T, 1, "prefill"), {}),
}


def _idle_job(case):
    arch, mesh, shape, over = IDLE[case]
    sizes = [int(n) for n in mesh.split("x")]
    names = ("pod", "data", "model")[-len(sizes):]
    return dp.job(arch, shape, dict(zip(names, sizes)), reduced=True,
                  overrides=over)


def _gqa_job(heads, kv, kind):
    return dp.job("yi-6b", (T, BATCH, kind), MESH, reduced=True,
                  overrides={"num_heads": heads, "num_kv_heads": kv,
                             "head_dim": HD})


def _forced(heads, kind) -> float:
    """The attention products rank 0 runs beyond JAX's chip: whole heads
    (ceil(H / m)) against GSPMD's H / m, 0 in decode (the slot-sharded
    cache splits the work evenly)."""
    m = MESH["model"]
    extra = math.ceil(heads / m) - heads / m
    rows = BATCH // MESH["data"]
    per_head = 4 * rows * T * T * HD * LAYERS
    return extra * per_head * {"train": 4, "prefill": 1, "decode": 0}[kind]


@pytest.fixture(scope="module")
def records():
    jobs = [_gqa_job(h, k, kind) for h, k in HEADS for kind in KINDS]
    jobs += [dp.job(*w, MESH, reduced=True) for w in WALKED.values()]
    jobs += [_idle_job(c) for c in IDLE]
    return dp.run(jobs, timeout=600)


def _pair(records, j):
    a, p = records["jax"][dp.key(j)], records["port"][dp.key(j)]
    assert a["status"] == p["status"] == "ok", (a, p)
    return a, p


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("heads,kv", HEADS)
def test_dot_flops_a_chip_are_jax_partitioners(records, heads, kv, kind):
    a, p = _pair(records, _gqa_job(heads, kv, kind))
    want = a["dot_flops"] + _forced(heads, kind)
    if kind == "train":
        assert p["dot_flops"] == pytest.approx(want, rel=TRAIN_TOL)
    else:
        assert p["dot_flops"] == want


@pytest.mark.parametrize("case", list(WALKED))
def test_counts_are_jax_with_its_hlo_walked_whole(records, case):
    a, p = _pair(records, dp.job(*WALKED[case], MESH, reduced=True))
    assert p["dot_flops"] == a["walked_dot_flops"]
    assert a["dot_flops"] < a["walked_dot_flops"]


@pytest.mark.parametrize("case", list(IDLE))
def test_batch_one_lays_d_model_over_the_idle_axes_as_jax(records, case):
    a, p = _pair(records, _idle_job(case))
    assert p["dot_flops"] == a["walked_dot_flops"]


def test_full_width_prefill_within_chip_smokes_margin_of_jax():
    """yi-6b prefill_32k at full width on the single-pod mesh (the port
    on 256 fake ranks): a chip's dot FLOPs at most ``chip_smoke``'s
    margin over JAX's count, the figure its ``dryrun`` phase holds the
    card's run to, and its temporaries at most 10 GB (38.9 when every
    rank ran every head)."""
    import chip_smoke
    combo = ("yi-6b", "prefill_32k")
    j = dp.job(*combo, "single")
    p = dp.run([j], sides=("port",), timeout=600)["port"][dp.key(j)]
    assert p["status"] == "ok", p
    want = chip_smoke.JAX_DOT_FLOPS[combo]
    assert p["dot_flops"] <= chip_smoke.DRYRUN_FLOPS_MARGIN * want
    assert p["temp_bytes"] <= 10e9
