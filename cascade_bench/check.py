"""``correct``: what the window produced, against the plain reference.

Run after the window has closed and the program's state is freed. The
reference (``reference/``) recomputes from the harness's own inputs and
from weights drawn again from the seed, never from what the program
made; it reads the program's outputs only to judge them. Every number
is a worst case over what it covers, and is held to the cell's limit
(``cells/<workload>.json``).

Classification cells (every request of the window unless said):

* ``local_logits_err``: the local tier's logits, every window row, max
  |program - reference| over the reference's RMS;
* ``gate_conf_err``: the gate's confidence, max |program - reference|;
* on whole remote windows drawn from the seed, every row of each (so
  every position of the transport's window), up to the mix's
  ``remote_rows``: ``remote_logits_err``, the remote prefill's last-position logits
  (whole vocabulary), max over rows of ||program - reference|| /
  ||reference||; ``remote_conf_err``, the 2nd supervisor's confidence,
  max |program - reference|;
* the decisions, counted where they differ from the reference's and the
  reference's own margin exceeds what the limits above allow its inputs
  to be off by (a near-tie is no fault). Exact: limit 0.
  ``pick_mismatch``: windows whose escalations are not the gate's
  thresholded bottom-k (their count is not ``min(eligible, capacity,
  real)``, or an escalated row's reference confidence lies above a kept
  row's by more than twice ``gate_conf_err``'s limit);
  ``answer_mismatch``: answers handed back whose reference logit lies
  below the reference's best by more than twice the logits' allowed error
  (every local answer; the sampled remote ones); ``verdict_mismatch``:
  sampled rows whose 2nd-supervisor verdict is not the reference's,
  which is taken against the reference's own ``t_remote``, fitted as
  the program's is on the reference's logits of the calibration rows,
  and whose confidence lies farther from it than twice
  ``remote_conf_err``'s limit;
* ``billing_mismatch``: the engine's billing counts over the window
  against the counts the windows imply (escalations ``min(capacity,
  real)`` a window, no cache hit among distinct inputs, the transport
  failures, ``price`` a remote call), summed absolute differences, the
  cost in calls. Exact: limit 0.

Generate cells, on a sample of the answers drawn from the seed (the
mix's ``sequences``, each in another batch slot): the reference runs once over each prompt with its served tokens and reads
the logits at the positions that produced them (the prefill's last, then
each decode step through the cache). ``token_gap``: the widest gap by
which a served token's logit lies below the reference's best;
``lik_relerr``: each served token's likelihood, relative to the
reference's probability of that token; ``minlik_relerr``: each answer's
least likelihood (``seq_min_likelihood``), the same way.

``control=True`` also reads the same numbers for the control: the
reference itself in the program's place, one precision down (the remote
in float8 e4m3, the local tier in TF32), at the same rows, with its
own ``t_remote`` fitted on its own calibration logits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cascade_bench.reference import supervisors as ref_sup
from cascade_bench.reference import surrogate as ref_surrogate
from cascade_bench.stack import CHECK, stream
from cascade_bench.traffic import weights

REMOTE, LOCAL = "REMOTE", "LOCAL"
REF_BLOCK = 8       # rows the reference runs at once


def _free(device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _windows(stack):
    """(uids [B] host, program logits [B, C] host, real rows) per window,
    in dispatch order."""
    out = []
    for uids, logits in stack.local_calls:
        u = uids.cpu().numpy()
        same = np.flatnonzero(u[1:] == u[:-1])
        real = int(same[0]) + 1 if same.size else u.size
        out.append((u, logits.float().cpu(), real))
    return out


def _gap(ref_logits: torch.Tensor, pred) -> torch.Tensor:
    """Per row: the reference's best logit less its logit at ``pred``."""
    pred = torch.as_tensor(np.asarray(pred), dtype=torch.long)
    return ref_logits.amax(-1) - ref_logits.gather(-1, pred[:, None])[:, 0]


def _local_numbers(stack, wins, by_uid, prec, limits):
    """local_logits_err, gate_conf_err, pick_mismatch, answer_mismatch
    (local answers) of the program (prec None) or of the control (prec
    "tf32")."""
    dev, spec = stack.device, stack.local_spec
    refs, outs = [], []
    for u, prog, real in wins:
        x = torch.as_tensor(stack.rows(u)[1], device=dev)
        refs.append(ref_surrogate.logits(spec, stack.sparams, x).cpu())
        outs.append(prog if prec is None else ref_surrogate.logits(
            spec, stack.sparams, x, prec=prec).cpu())
    rms = math.sqrt(float(torch.stack([(r * r).mean() for r in refs])
                          .mean())) if refs else 1.0
    conf_tol = 2 * limits["gate_conf_err"]
    logit_tol = 2 * limits["local_logits_err"] * rms
    errs, conf_errs, picks, answers = [0.0], [0.0], 0, 0
    for (u, _, real), ref, out in zip(wins, refs, outs):
        errs.append(float((out - ref).abs().max()) / (rms or 1.0))
        conf_ref = ref_sup.max_softmax(ref).numpy()[:real]
        if prec is None:
            rows = [by_uid[int(i)] for i in u[:real]]
            conf = np.array([r.local_conf for r in rows])
            local = np.array([r.disposition == LOCAL for r in rows])
            pred = np.array([r.prediction for r in rows])
        else:
            conf = ref_sup.max_softmax(out).numpy()[:real]
            local = np.ones(real, bool)
            local[ref_sup.escalations(conf, real, stack.capacity)] = False
            pred = out.argmax(-1).numpy()[:real]
        conf_errs.append(float(np.abs(conf - conf_ref).max()))
        k_ref = ref_sup.escalations(conf_ref, real, stack.capacity).size
        if (~local).sum() != k_ref or (
                local.any() and (~local).any()
                and conf_ref[~local].max() - conf_ref[local].min()
                > conf_tol):
            picks += 1
        if local.any():
            answers += int((_gap(ref[:real][local], pred[local])
                            > logit_tol).sum())
    return {"local_logits_err": max(errs), "gate_conf_err": max(conf_errs),
            "pick_mismatch": picks, "answer_mismatch": answers}


def _remote_out(stack, logits, labels):
    one = torch.nn.functional.one_hot(
        torch.as_tensor(labels).long(), stack.num_classes).float()
    return (one * float(stack.mix["oracle_margin"])
            + float(stack.mix["jitter"]) * logits[:, :stack.num_classes])


def _threshold(stack, cal_logits) -> float:
    """``t_remote`` fitted on the calibration rows' logits [cal, V], as
    the harness fits the program's (``stack.Classify``)."""
    labels = stack.train_labels[:cal_logits.shape[0]]
    conf = ref_sup.max_softmax(_remote_out(stack, cal_logits, labels))
    return ref_sup.nominal_quantile_threshold(
        conf.numpy(), stack.mix["serve"]["fpr"])


def _remote_numbers(stack, labels, prog_logits, ref_logits, prog_rows,
                    t_ref, t_side, limits):
    """remote_logits_err, remote_conf_err, verdict_mismatch,
    answer_mismatch (remote answers) of ``prog_logits`` [n, V];
    ``prog_rows`` the program's (remote_conf, accepted, prediction) per
    row, or None to derive them from ``prog_logits`` against ``t_side``
    (the control). The reference's verdicts are against its own
    threshold ``t_ref``; a row within twice ``remote_conf_err``'s limit
    of it (its own confidence and the threshold's order statistic may
    each be off by that much) is a near-tie."""
    ref_out = _remote_out(stack, ref_logits, labels)
    ref_conf = ref_sup.max_softmax(ref_out).numpy()
    err = ((prog_logits - ref_logits).norm(dim=-1)
           / ref_logits.norm(dim=-1)).max()
    if prog_rows is None:
        out = _remote_out(stack, prog_logits, labels)
        conf = ref_sup.max_softmax(out).numpy()
        accepted = conf > t_side
        pred = out.argmax(-1).numpy()
    else:
        conf, accepted, pred = (np.asarray(v) for v in zip(*prog_rows))
    far = np.abs(ref_conf - t_ref) > 2 * limits["remote_conf_err"]
    verdicts = int(((accepted != (ref_conf > t_ref)) & far).sum())
    tol = (2 * float(stack.mix["jitter"]) * limits["remote_logits_err"]
           * float(ref_logits.abs().max()))
    answers = (int((_gap(ref_out[accepted], pred[accepted]) > tol).sum())
               if accepted.any() else 0)
    return {"remote_logits_err": float(err),
            "remote_conf_err": float(np.abs(conf - ref_conf).max()),
            "verdict_mismatch": verdicts, "answer_mismatch": answers}


def _billing(stack, win, wins, failed) -> float:
    esc = sum(min(stack.capacity, real) for _, _, real in wins)
    rejected = sum(r.disposition == "REJECTED" for r in win.responses)
    calls = esc - failed
    want = {"requests": len(win.responses), "escalations": esc,
            "remote_calls": calls, "cache_hits": 0,
            "transport_failures": failed, "rejected": rejected}
    got = win.billing
    miss = sum(abs(got[k] - v) for k, v in want.items())
    return float(miss + round(abs(got["total_cost"] - calls * stack.price)
                              / stack.price, 6))


def transport_failed(resp) -> bool:
    """An escalated row the transport lost (no remote answer came)."""
    return resp.disposition == "REJECTED" and resp.remote_conf == -math.inf


def _sampled_windows(stack, by_uid, rows: int):
    """Whole recorded remote windows, in an order drawn from the seed,
    until they hold ``rows`` rows: (uids [n], program logits [n, V]).
    Every row of a window is taken, so every position of the transport's
    window is compared; a window with a row the transport lost is not."""
    def served(u):
        u = int(u)
        return (u in by_uid and by_uid[u].disposition != LOCAL
                and not transport_failed(by_uid[u]))

    wins = [(u, lg) for u, lg in stack.remote_windows
            if all(served(x) for x in u)]
    uids, logits, n = [], [], 0
    for i in stream(stack.seed, CHECK).permutation(len(wins)):
        if n >= rows:
            break
        u, lg = wins[i]
        uids.append(u)
        logits.append(lg.float().cpu())
        n += len(u)
    if not uids:
        return np.zeros(0, np.int64), None
    return np.concatenate(uids).astype(np.int64), torch.cat(logits)


def _reference_logits(stack, params, toks, prec: str = "fp32"):
    """The family's reference: last-position logits of ``toks`` [n, T],
    ``REF_BLOCK`` rows at a time, on the host."""
    t = toks.shape[1]
    return torch.cat([
        stack.family.logits(
            stack.config, params,
            torch.as_tensor(toks[i:i + REF_BLOCK], device=stack.device),
            [t - 1], prec=prec)[:, 0].cpu()
        for i in range(0, len(toks), REF_BLOCK)])


def classify(stack, win, limits: dict, control: bool = False) -> dict:
    """The numbers of a classification window ({"program": {...}} and,
    with ``control``, {"control": {...}})."""
    dev = stack.device
    by_uid = {r.uid: r for r in win.responses}
    failed = sum(transport_failed(r) for r in win.responses)
    wins = _windows(stack)
    uids, prog = _sampled_windows(stack, by_uid,
                                  stack.mix["check"]["remote_rows"])
    n = int(uids.size)
    rows = [(by_uid[int(u)].remote_conf,
             by_uid[int(u)].disposition == REMOTE,
             by_uid[int(u)].prediction) for u in uids]
    billing = _billing(stack, win, wins, failed)
    # the program's state goes before the reference runs
    stack.close()
    stack.rparams = None
    stack.remote_windows = []
    _free(dev)

    out = {"program": _local_numbers(stack, wins, by_uid, None, limits)}
    if control:
        out["control"] = _local_numbers(stack, wins, by_uid, "tf32", limits)
    if not n:
        remote = {k: math.nan for k in ("remote_logits_err",
                                         "remote_conf_err",
                                         "verdict_mismatch")}
        out["program"].update(remote)
        if control:
            out["control"].update(remote)
    else:
        params = weights.draw(stack.config, stack.seed, dev)
        toks, _, labels = stack.rows(uids)
        cal = stack.train_toks[:stack.calibration]
        ref = _reference_logits(stack, params, toks)
        t_ref = _threshold(stack, _reference_logits(stack, params, cal))
        sides = [("program", prog, rows, stack.t_remote)]
        if control:
            t_low = _threshold(stack, _reference_logits(stack, params, cal,
                                                        "fp8"))
            sides.append(("control",
                          _reference_logits(stack, params, toks, "fp8"),
                          None, t_low))
        del params
        _free(dev)
        for side, logits_, rows_, t_side in sides:
            r = _remote_numbers(stack, labels, logits_, ref, rows_, t_ref,
                                t_side, limits)
            out[side]["answer_mismatch"] += r.pop("answer_mismatch")
            out[side].update(r)
    out["program"]["billing_mismatch"] = billing
    out["failed"] = failed + max(0, win.attempted - len(win.responses))
    out["sampled_remote_rows"] = n
    return out


def generate(stack, win, limits: dict, control: bool = False) -> dict:
    """The numbers of a generate window (see the module's doc)."""
    dev, b = stack.device, stack.batch
    t, new = stack.prompt_len, stack.new_tokens
    rng = stream(stack.seed, CHECK)
    n = min(stack.mix["check"]["sequences"], len(stack.calls) * b)
    # distinct batch slots (all of them once n reaches the batch), each
    # from a call drawn from the seed
    slots = rng.permutation(b)[np.arange(n) % b]
    picks = rng.integers(0, len(stack.calls), n)
    toks, liks, minlik, prompts, drawn = [], [], [], [], {}
    for i, row in zip(picks, slots):
        c, tk, lk, ml = stack.calls[int(i)]
        if c not in drawn:
            drawn[c] = stack.prompts(c)
        toks.append(tk[row].long())
        liks.append(lk[row].float())
        minlik.append(ml[row].float())
        prompts.append(drawn[c][row].long())
    answered = sum(int(tk.shape[0]) for _, tk, _, _ in stack.calls)
    served = torch.stack(toks)                        # [n, new]
    liks, minlik = torch.stack(liks), torch.stack(minlik)
    inputs = torch.cat([torch.stack(prompts), served[:, :-1]], 1)
    stack.calls, drawn = [], None
    stack.rparams = None
    _free(dev)

    positions = range(t - 1, t + new - 1)
    params = weights.draw(stack.config, stack.seed, dev)
    sides = {"program": {}, "control": {}} if control else {"program": {}}

    def worst(side, name, v):
        sides[side][name] = max(sides[side].get(name, 0.0), float(v))

    def numbers(side, ref, p_ref, tokens, lik, least):
        at = ref.gather(-1, tokens[..., None])[..., 0]
        p = p_ref.gather(-1, tokens[..., None])[..., 0]
        worst(side, "token_gap", (ref.amax(-1) - at).max())
        worst(side, "lik_relerr", ((lik - p).abs() / p).max())
        worst(side, "minlik_relerr",
              ((least - p.amin(-1)).abs() / p.amin(-1)).max())

    for i in range(0, n, REF_BLOCK):
        blk = slice(i, i + REF_BLOCK)
        ref = stack.family.logits(stack.config, params, inputs[blk],
                                  positions)          # [rows, new, V]
        p_ref = torch.softmax(ref, -1)
        numbers("program", ref, p_ref, served[blk], liks[blk], minlik[blk])
        if control:
            low = torch.softmax(stack.family.logits(
                stack.config, params, inputs[blk], positions, prec="fp8"), -1)
            lik_low, tok_low = low.max(-1)
            numbers("control", ref, p_ref, tok_low, lik_low,
                    lik_low.amin(-1))
        del ref, p_ref
    del params
    _free(dev)
    out = dict(sides)
    out["failed"] = win.attempted - answered
    return out


CHECKS = {"backlog": classify, "poisson": classify, "qa": generate}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}). A
    number that is missing or not a number fails."""
    rows = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        rows[name] = {"value": v, "limit": limit}
        ok &= (not math.isnan(v)) and v <= limit
    return ok, rows
