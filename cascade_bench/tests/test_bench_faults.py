"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run on the CPU at tiny sizes (``run.execute``,
past the look for a card), with one fault planted in the program where
an answer is produced: the local tier's answers (the gate's argmax), the
remote answers (the 2nd supervisor's scoring of the remote logits), a
generated token (the pick of each decode step), and the remote logits
or a generated token in one slot of a batch only. The clean runs of the
same cells judge the same numbers, with nothing counted against them."""

from __future__ import annotations

import pytest

from cascade_bench import run
from cascade_bench.tests.conftest import tiny_cell

SEED = 2 ** 31 + 777
CLASSIFY = "yi-6b.reviews512.backlog"
QA = "yi-6b.squad256.qa256"


def _run(workload):
    return run.execute(tiny_cell(workload), SEED, 1.5, False, "cpu")


@pytest.mark.parametrize("workload", [CLASSIFY, "yi-6b.reviews512.poisson"])
def test_clean_classification_run_counts_no_mismatch(workload):
    r = _run(workload)
    n = r["numbers"]["program"]
    assert r["attempted"] > 0 and r["failed"] == 0
    for key in ("pick_mismatch", "answer_mismatch", "verdict_mismatch",
                "billing_mismatch"):
        assert n[key] == 0, (key, n)
    assert r["numbers"]["sampled_remote_rows"] > 0


def test_local_answer_altered_at_the_gate(monkeypatch):
    import repro_torch.serving.engine as engine
    gate = engine.confidence_gate

    def altered(logits, *a, **kw):
        out = gate(logits, *a, **kw)
        out["pred"] = (out["pred"] + 1) % logits.shape[-1]
        return out

    monkeypatch.setattr(engine, "confidence_gate", altered)
    r = _run(CLASSIFY)
    assert r["numbers"]["program"]["answer_mismatch"] > 0
    assert r["correct"] is False


def test_remote_answer_altered_where_it_is_scored(monkeypatch):
    import repro_torch.serving.engine as engine
    score = engine._score_host

    def altered(supervisor, stacked):
        conf, pred = score(supervisor, stacked)
        return conf, (pred + 1) % stacked[0].shape[-1]

    monkeypatch.setattr(engine, "_score_host", altered)
    r = _run(CLASSIFY)
    assert r["numbers"]["program"]["answer_mismatch"] > 0
    assert r["correct"] is False


def test_clean_generate_run():
    r = _run(QA)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["numbers"]["program"]["token_gap"] < 0.1


def test_generated_token_altered_where_it_is_picked(monkeypatch):
    import repro_torch.serving.generate as generate
    pick = generate._pick

    def altered(logits):
        tok, lik = pick(logits)
        return (tok + 1) % logits.shape[-1], lik

    monkeypatch.setattr(generate, "_pick", altered)
    r = _run(QA)
    assert r["numbers"]["program"]["token_gap"] > 0.5
    assert r["correct"] is False


def test_remote_logits_altered_in_one_window_slot(monkeypatch):
    """The check compares whole remote windows, so a fault in one
    position of the transport's window shows though only a share of
    the windows is recorded."""
    import repro_torch.models.transformer as T
    prefill = T.prefill

    def altered(cfg, params, batch, *a, **kw):
        logits, cache = prefill(cfg, params, batch, *a, **kw)
        if logits.shape[0] > 1:
            logits = logits.clone()
            logits[-1] *= 1.5
        return logits, cache

    monkeypatch.setattr(T, "prefill", altered)
    cell = tiny_cell(CLASSIFY)
    cell.traffic["check"]["record_share"] = 0.5
    r = run.execute(cell, SEED, 1.5, False, "cpu")
    assert r["numbers"]["sampled_remote_rows"] > 0
    assert r["numbers"]["program"]["remote_logits_err"] > 0.3
    assert r["correct"] is False


def test_generated_token_altered_in_one_batch_slot(monkeypatch):
    import repro_torch.serving.generate as generate
    pick = generate._pick

    def altered(logits):
        tok, lik = pick(logits)
        tok = tok.clone()
        tok[-1] = (tok[-1] + 1) % logits.shape[-1]
        return tok, lik

    monkeypatch.setattr(generate, "_pick", altered)
    r = _run(QA)
    assert r["numbers"]["program"]["token_gap"] > 0.5
    assert r["correct"] is False
