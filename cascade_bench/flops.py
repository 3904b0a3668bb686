"""The yardstick's arithmetic: kernel bounds and the peaks; a model's
FLOPs are its family module's (``reference/<family>.py``).

Counted from the widths and the shapes of the calls, never read from the
program. ``PEAKS`` holds the published dense rates of one card (NVIDIA's
data sheet, H100 SXM, 700 W); a share of a peak or of a roofline is the
least time the card could take over the time measured.
"""

from __future__ import annotations

PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                                   "hbm_bytes": 3.35e12}}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"
BF16 = 2        # bytes an element


def peak(kind: str | None = None) -> dict:
    return PEAKS.get(kind or DEFAULT_PEAK, PEAKS[DEFAULT_PEAK])


def generate_flops(fam, w: dict, rows: int, t: int, new_tokens: int) -> float:
    """``greedy_generate`` of the family module ``fam``: the prefill, then
    new_tokens - 1 decode steps."""
    return fam.prefill_flops(w, rows, t) + sum(
        fam.decode_flops(w, rows, t + i) for i in range(new_tokens - 1))


def roofline_s(flops: float, nbytes: float, kind: str | None = None) -> float:
    p = peak(kind)
    return max(flops / p["bf16_flops"], nbytes / p["hbm_bytes"])


def flash_bound_s(w: dict, rows: int, t: int, kind: str | None = None) -> float:
    """One causal flash-attention call over one layer: q and o [rows, t,
    heads, hd], k and v [rows, t, kv_heads, hd], bf16, each read or
    written once."""
    hd, H, K = w["head_dim"], w["heads"], w["kv_heads"]
    flops = 4.0 * rows * H * hd * t * (t + 1) / 2
    nbytes = BF16 * rows * t * hd * (2 * H + 2 * K)
    return roofline_s(flops, nbytes, kind)


def decode_attn_bound_s(w: dict, rows: int, kv_len: int,
                        kind: str | None = None) -> float:
    """One decode-attention call over one layer: q and o [rows, heads,
    hd], the kv_len valid slots of k and v [rows, kv_len, kv_heads, hd],
    bf16, each read or written once."""
    hd, H, K = w["head_dim"], w["heads"], w["kv_heads"]
    flops = 4.0 * rows * H * hd * kv_len
    nbytes = BF16 * rows * hd * (2 * H + 2 * K * kv_len)
    return roofline_s(flops, nbytes, kind)
