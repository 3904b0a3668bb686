"""Synthetic analogues of the paper's four case studies (DESIGN.md §6).

Without network access to the datasets, IMDB / GitHub-issues / ImageNet /
SQuADv2 are reproduced as *calibrated generative processes* that preserve
the statistical structure the paper's claims rest on:

  * a per-example latent difficulty z ~ N(0, 1);
  * local tier:  correct ~ Bernoulli(sigmoid(a_l - b_l * z));
  * remote tier: correct ~ Bernoulli(sigmoid(a_r - b_r * z + c * w)),
    where w ~ N(0,1) is a *complementarity* component independent of z —
    inputs hard for the local model but easy for the remote one and vice
    versa (the paper's source of superaccurate performance);
  * supervisor confidences are noisy monotone functions of the same
    latents, so MaxSoftmax-style supervision is informative but imperfect;
  * a_l, a_r are calibrated so the marginal accuracies match Table 1.

An `invalid_rate` adds SQuADv2-style unanswerable inputs: neither tier can
be correct and both tiers' confidence distributions shift down (RQ2).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def calibrate_intercept(target_acc: float, slope: float, comp: float,
                        n: int = 200_000, seed: int = 0) -> float:
    """Find a s.t. E_z,w[sigmoid(a - slope*z + comp*w)] == target_acc."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(n)
    w = rng.standard_normal(n)
    lo, hi = -10.0, 10.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        acc = float(np.mean(_sigmoid(mid - slope * z + comp * w)))
        if acc < target_acc:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


@dataclass(frozen=True)
class CaseStudy:
    name: str
    metric: str                   # accuracy | micro_f1 | exact_match
    local_acc: float              # Table 1 values
    remote_acc: float
    num_classes: int
    difficulty_slope_local: float = 2.0
    difficulty_slope_remote: float = 1.2
    complementarity: float = 0.0  # >0 -> superaccuracy possible
    conf_noise: float = 0.6       # supervisor imperfection
    invalid_rate: float = 0.0     # unanswerable fraction (RQ2)
    seed: int = 0


# Table 1 calibration. IMDB and SQuAD get complementarity (the paper found
# superaccuracy exactly there); Issues and ImageNet get ~none.
IMDB = CaseStudy("imdb", "accuracy", 0.794, 0.895, 2,
                 complementarity=0.9, seed=1)
ISSUES = CaseStudy("issues", "micro_f1", 0.711, 0.823, 3,
                   complementarity=0.12, seed=2)
IMAGENET = CaseStudy("imagenet", "accuracy", 0.678, 0.852, 1000,
                     complementarity=0.10, seed=3)
SQUADV2 = CaseStudy("squadv2", "exact_match", 0.280, 0.308, 0,  # free text
                    difficulty_slope_local=1.6,
                    complementarity=0.55, conf_noise=0.8, seed=4)
SQUADV2_ALL = replace(SQUADV2, name="squadv2_all", invalid_rate=0.33, seed=5)

CASE_STUDIES = {c.name: c for c in (IMDB, ISSUES, IMAGENET, SQUADV2,
                                    SQUADV2_ALL)}


@dataclass
class CascadeSample:
    """Per-input simulation outputs consumed by RQ1/RQ2 evaluation."""
    local_correct: np.ndarray    # [n] 0/1
    remote_correct: np.ndarray   # [n] 0/1
    local_conf: np.ndarray       # [n] 1st-level supervisor confidence
    remote_conf: np.ndarray      # [n] 2nd-level supervisor confidence
    invalid: np.ndarray          # [n] bool


def sample_case_study(cs: CaseStudy, n: int, seed: int | None = None
                      ) -> CascadeSample:
    rng = np.random.default_rng(cs.seed if seed is None else seed)
    z = rng.standard_normal(n)                  # shared difficulty
    w = rng.standard_normal(n)                  # complementarity direction
    invalid = rng.random(n) < cs.invalid_rate

    a_l = calibrate_intercept(cs.local_acc, cs.difficulty_slope_local,
                              cs.complementarity)
    a_r = calibrate_intercept(cs.remote_acc, cs.difficulty_slope_remote,
                              cs.complementarity)

    p_loc = _sigmoid(a_l - cs.difficulty_slope_local * z
                     - cs.complementarity * w)
    p_rem = _sigmoid(a_r - cs.difficulty_slope_remote * z
                     + cs.complementarity * w)
    local_correct = (rng.random(n) < p_loc) & ~invalid
    remote_correct = (rng.random(n) < p_rem) & ~invalid

    # supervisor confidences: noisy monotone views of the same likelihoods,
    # shifted down for invalid inputs (both models are "confused").
    def conf(p, noise_scale, invalid_shift):
        raw = (np.log(p / (1 - p + 1e-9))
               + noise_scale * rng.standard_normal(n)
               - invalid_shift * invalid)
        return _sigmoid(raw)

    local_conf = conf(p_loc, cs.conf_noise, 1.5)
    remote_conf = conf(p_rem, cs.conf_noise, 1.5)
    return CascadeSample(local_correct.astype(np.float64),
                         remote_correct.astype(np.float64),
                         local_conf, remote_conf, invalid)


# --------------------------------------------------------------------------
# real-model task: teacher-labelled token classification, learnable by the
# in-framework surrogate + remote models (examples / integration tests)
# --------------------------------------------------------------------------

def make_classification_task(seed: int, *, n: int, vocab: int, seq_len: int,
                             num_classes: int, label_noise: float = 0.05):
    """Token sequences whose label is a (noisy) linear-teacher readout of
    bag-of-token features — small models learn it partially, bigger models
    better; mirrors the local/remote accuracy gap structurally."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, size=(n, seq_len), dtype=np.int32)
    teacher = rng.standard_normal((vocab, num_classes)) / np.sqrt(seq_len)
    feats = np.zeros((n, num_classes))
    for c in range(0, seq_len, 64):
        chunk = tokens[:, c:c + 64]
        feats += teacher[chunk].sum(axis=1)
    # second-order term makes the task non-trivial for linear/small models
    pair = teacher[tokens[:, ::2]].sum(1) * teacher[tokens[:, 1::2]].sum(1)
    logits = feats + 0.5 * pair
    labels = np.argmax(logits, axis=-1).astype(np.int32)
    flip = rng.random(n) < label_noise
    labels[flip] = rng.integers(0, num_classes, size=int(flip.sum()))
    margin = np.sort(logits, axis=-1)
    difficulty = -(margin[:, -1] - margin[:, -2])
    return tokens, labels, difficulty
