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

The temporaries a chip (ROADMAP C.7's memory half): a reduced prefill
of two query chunks, a reduced zamba2 prefill and a reduced qwen3-moe
train step, on data 2 x model 4 and pod 2 x data 2 x model 2, each held
to a stated factor of JAX's (``TEMPS``), and, on the port alone without
a mesh, prefill's temporaries the same at 2 layers and at 8. ROADMAP
C.8 and C.9, two layouts decided against GSPMD's, are pinned by exact
counts: zamba2 on two pods (``_pod_replicated``) and whole heads'
collective bytes.

The sharded MoE runs one router product a layer (ROADMAP C.10): the
reduced qwen3-moe train step on data 2 x model 4 counts what the port
counted when it ran a second one for the balance loss, less that
product's four runs a layer, exactly. The three kernels on the serving
path (flash prefill, decode attention, the RWKV6 scan) are counted as
the kernels, never through their plain versions (ROADMAP C.11): the
plain version's dot FLOPs to the FLOP, and fewer temporaries, a
prefill's by at least one fp32 score buffer a query chunk.

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


# The temporaries a chip (ROADMAP C.7's memory half), each case's port
# temp bytes at most FACTOR times JAX's: (arch, shape, mesh, config
# overrides, FACTOR). Each fails on the slice before, where prefill held
# every layer's keys and values beside their stack and the plain
# attention four fp32 score buffers a chunk (2.02x and 2.06x JAX's), and
# the loss head took every row of a CE chunk with the whole vocabulary
# on every chip (5.41x; 1.20x on two pods). A prefill of two 1024-row
# query chunks; a train step at a vocabulary that FSDP-splits the head
# (its D rows over ``data``), the MoE experts over ``model`` and the
# rows over ``data`` (or ``pod`` x ``data``). Reduced train steps keep
# fp32 copies in the plain attention's and norms' backward that JAX
# fuses: 1.35x JAX's on data 2 x model 4 (at full width 0.998x)
POD = {"pod": 2, "data": 2, "model": 2}
MOE_TRAIN = ("qwen3-moe-235b-a22b", (512, 8, "train"))
TEMPS = {
    "yi-6b prefill, 2 query chunks": ("yi-6b", (2048, BATCH, "prefill"),
                                      MESH, {}, 1.0),
    "zamba2-7b prefill": ("zamba2-7b", (2048, BATCH, "prefill"), MESH, {},
                          1.0),
    "qwen3-moe train": (*MOE_TRAIN, MESH, {"vocab_size": 16384}, 1.4),
    "qwen3-moe train pod 2x2x2": (*MOE_TRAIN, POD, {"vocab_size": 16384},
                                  1.0),
}
# ROADMAP C.8: reduced zamba2's prefill, one group of two mamba2 layers,
# on data 2 x model 2 and on pod 2 x data 2 x model 2 (the same 8 x 64
# tokens)
C8_SHAPE = (T, 8, "prefill")
C8_MESHES = {"single": {"data": 2, "model": 2}, "two pods": POD}


def _temp_job(case):
    arch, shape, mesh, over, _ = TEMPS[case]
    return dp.job(arch, shape, mesh, reduced=True, overrides=over)


def _c8_job(mesh):
    return dp.job("zamba2-7b", C8_SHAPE, C8_MESHES[mesh], reduced=True)


@pytest.fixture(scope="module")
def records():
    jobs = [_gqa_job(h, k, kind) for h, k in HEADS for kind in KINDS]
    jobs += [dp.job(*w, MESH, reduced=True) for w in WALKED.values()]
    jobs += [_idle_job(c) for c in IDLE]
    jobs += [_temp_job(c) for c in TEMPS]
    jobs += [_c8_job(m) for m in C8_MESHES]
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


@pytest.mark.parametrize("kind", KINDS)
def test_whole_heads_move_fewer_bytes_than_gspmds_head_dim_split(records,
                                                                 kind):
    """ROADMAP C.9, decided: with 6 query heads on 4 ranks the port keeps
    whole heads (rank 0 runs ``_forced``'s half head more, pinned above)
    where GSPMD splits head_dim and all-reduces each chip's partial
    logits. That split moves more bytes than the head it saves: a chip's
    collectives stay below JAX's in every step (at full width qwen2-7b's
    28 heads on 16: 28.33 GB against JAX's 1819.87 at prefill_32k, for
    7.2% more dot FLOPs)."""
    a, p = _pair(records, _gqa_job(6, 2, kind))
    assert p["coll_bytes"] < a["coll_bytes"]


@pytest.mark.parametrize("case", list(TEMPS))
def test_temporaries_a_chip_within_jax_partitioners(records, case):
    a, p = _pair(records, _temp_job(case))
    assert p["temp_bytes"] <= TEMPS[case][-1] * a["temp_bytes"]


def _pod_replicated(cfg, shape, mesh) -> int:
    """The dot FLOPs a JAX chip runs on two pods beyond the port's chip
    (ROADMAP C.8). JAX's mamba2 hints name ``data`` alone
    (``repro/models/mamba2.py:127-143``), so on a mesh with ``pod`` they
    gather the rows over it: each pod runs the same rows. Its HLO on pod
    2 x data 2 x model 2 shows the SSD's per-step output product on
    twice the chip's rows in every mamba2 layer, and ``w_zx`` on twice
    the rows in every mamba2 layer but a group's first (whose input the
    shared attention block leaves split over ``pod``; the other products
    contract half of d_model instead: the same FLOPs). The port keeps
    the rows over (``pod``, ``data``)."""
    d_inner, n = 2 * cfg["d_model"], cfg["ssm_state_dim"]
    m = mesh["model"]
    rows = shape[1] // (mesh["pod"] * mesh["data"])
    ssd = shape[0] * 2 * rows * d_inner // m * n
    w_zx = 2 * rows * shape[0] * cfg["d_model"] * 2 * d_inner // m
    later = cfg["num_layers"] - cfg["num_layers"] // cfg["shared_attn_period"]
    return cfg["num_layers"] * ssd + later * w_zx


def test_two_pods_split_the_rows_jax_replicates_over_pod(records):
    """ROADMAP C.8, decided against following: on two pods a port chip
    runs half of its single-pod count (the rows split over ``pod`` x
    ``data``), which is JAX's count walked whole on one pod; JAX's
    chip runs that plus ``_pod_replicated``. Following JAX would double
    the mamba2 work a chip and raise its temporaries as JAX's (zamba2-7b
    train_4k: 137.54 GB a chip on one pod, 522.46 on two)."""
    from repro_torch.configs import get_config
    cfg = get_config("zamba2-7b").reduced()
    cfg = {f: getattr(cfg, f) for f in ("d_model", "ssm_state_dim",
                                        "num_layers", "shared_attn_period")}
    a1, p1 = _pair(records, _c8_job("single"))
    a2, p2 = _pair(records, _c8_job("two pods"))
    assert p1["dot_flops"] == a1["walked_dot_flops"]
    assert p2["dot_flops"] == p1["dot_flops"] / 2
    assert a2["walked_dot_flops"] == p2["dot_flops"] + _pod_replicated(
        cfg, C8_SHAPE, POD)


@pytest.mark.parametrize("case", list(WALKED))
def test_counts_are_jax_with_its_hlo_walked_whole(records, case):
    a, p = _pair(records, dp.job(*WALKED[case], MESH, reduced=True))
    assert p["dot_flops"] == a["walked_dot_flops"]
    assert a["dot_flops"] < a["walked_dot_flops"]


@pytest.mark.parametrize("case", list(IDLE))
def test_batch_one_lays_d_model_over_the_idle_axes_as_jax(records, case):
    a, p = _pair(records, _idle_job(case))
    assert p["dot_flops"] == a["walked_dot_flops"]


# ROADMAP C.10: the port's count of TEMPS' "qwen3-moe train" while its
# sharded MoE ran the router product twice, once for the routes and once
# more for the balance loss's mean probabilities
TWICE_ROUTED_DOT_FLOPS = 23152558080


def test_sharded_moe_runs_one_router_product(records):
    """Each MoE layer's second router product, [rows, D] x [D, E] in
    fp32, ran four times in the remat'd train step: its forward, its
    recompute and the two products of its backward (dx and d router.w).
    The count is the old one less those, to the FLOP."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_TRAIN[0]).reduced()
    seq, batch, _ = MOE_TRAIN[1]
    rows = seq * batch // MESH["data"]      # a data rank's dispatch group
    moe_layers = cfg.num_layers - cfg.first_dense_layers
    removed = 4 * 2 * rows * cfg.d_model * cfg.num_experts * moe_layers
    _, p = _pair(records, _temp_job("qwen3-moe train"))
    assert p["dot_flops"] == TWICE_ROUTED_DOT_FLOPS - removed


# ROADMAP C.11: (arch, seq_len, kind) on one chip, no mesh, batch BATCH;
# a prefill of two 1024-row query chunks (h2o-danube's far past its
# reduced 64-token window: the plain version's scores span every key),
# a decode over 256 slots
KERNEL_STEPS = {"yi-6b prefill": ("yi-6b", 2048, "prefill"),
                "h2o-danube-1.8b prefill": ("h2o-danube-1.8b", 2048,
                                            "prefill"),
                "yi-6b decode": ("yi-6b", 256, "decode"),
                "rwkv6-1.6b prefill": ("rwkv6-1.6b", T, "prefill"),
                "rwkv6-1.6b decode": ("rwkv6-1.6b", T, "decode")}


def _plain_scan(r, k, v, w, u, s0, s_out=None):
    """``rwkv6_scan``'s CPU branch: the plain version, s_T into ``s_out``
    when given."""
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    y, s_t = rwkv6_scan_ref(r, k, v, w, u, s0)
    return y, s_t if s_out is None else s_out.copy_(s_t)


@pytest.mark.parametrize("case", list(KERNEL_STEPS))
def test_dry_run_counts_the_kernels_not_their_plain_versions(case,
                                                             monkeypatch):
    """A dry-run step runs on fake tensors, which each kernel's wrapper
    hands to the kernel's op: counted with the plain version's dot FLOPs
    and holding only its output (and decode's scratch). Every plain
    version raises while the step is counted; then the step is counted
    again with the wrappers' callers sent to the plain versions."""
    from repro_torch.analysis.roofline import measure
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rwkv6_scan import ops as scan_ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import lower_step
    from repro_torch.models import layers, rwkv6
    arch, seq, kind = KERNEL_STEPS[case]
    cfg = get_config(arch).reduced()

    def count():
        t = measure(lower_step(cfg, ShapeConfig("k", seq, BATCH, kind),
                               Mesh({"data": 1, "model": 1})))
        return t.total_dot_flops, t.peak_bytes - t.output_bytes

    def refuse(*args, **kwargs):
        raise AssertionError("a dry-run step reached a plain version")

    with monkeypatch.context() as m:
        for mod, name in ((flash_ops, "attention_ref"),
                          (decode_ops, "decode_attention_ref"),
                          (scan_ops, "rwkv6_scan_ref")):
            m.setattr(mod, name, refuse)
        flops, temps = count()
    with monkeypatch.context() as m:
        m.setattr(layers, "attention", attention_ref)
        m.setattr(layers, "decode_attn", decode_attention_ref)
        m.setattr(rwkv6, "rwkv6_scan", _plain_scan)
        plain_flops, plain_temps = count()
    assert flops == plain_flops
    if kind == "prefill" and arch != "rwkv6-1.6b":
        scores = 4 * BATCH * cfg.num_heads * 1024 * seq   # fp32, a chunk
        assert plain_temps - temps >= scores
    else:
        assert temps < plain_temps


def test_full_width_prefill_within_chip_smokes_margin_of_jax():
    """yi-6b prefill_32k at full width on the single-pod mesh (the port
    on 256 fake ranks): a chip's dot FLOPs and temporaries at most
    ``chip_smoke``'s margins over JAX's, the figures its ``dryrun``
    phase holds the card's run to (temporaries: 38.9 GB when every rank
    ran every head, 8.59 while prefill held the keys and values twice)."""
    import chip_smoke
    combo = ("yi-6b", "prefill_32k")
    j = dp.job(*combo, "single")
    p = dp.run([j], sides=("port",), timeout=600)["port"][dp.key(j)]
    assert p["status"] == "ok", p
    want = chip_smoke.JAX_DOT_FLOPS[combo]
    assert p["dot_flops"] <= chip_smoke.DRYRUN_FLOPS_MARGIN * want
    assert p["temp_bytes"] <= (chip_smoke.DRYRUN_TEMP_MARGIN
                               * chip_smoke.JAX_TEMP_BYTES[combo])


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-235b-a22b",
                                  "pixtral-12b"])
def test_prefill_temporaries_do_not_grow_with_depth(arch):
    """The port alone, on fake tensors with no mesh (one chip): a reduced
    prefill's temporaries (its peak less the cache it returns) are the
    same at 2 layers and at 8. Each layer's keys and values go into the
    stacked cache as they are made; before, every layer's were held
    beside the stack, and each extra layer added its own."""
    import dataclasses

    from repro_torch.analysis.roofline import measure
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import lower_step
    shape = ShapeConfig("depth", 256, 2, "prefill")
    temps = []
    for layers in (2, 8):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  num_layers=layers)
        t = measure(lower_step(cfg, shape, Mesh({"data": 1, "model": 1})))
        temps.append(t.peak_bytes - t.output_bytes)
    assert temps[1] == temps[0]
