"""Pure-python text generation metrics used by the paper.

* Google-BLEU (GLEU): min(precision, recall) over 1..4-gram multisets —
  the sentence-level-friendly BLEU variant the paper reports as "BLEU".
* ROUGE-LSum ("RSUM"): LCS-based F-measure computed per sentence-split
  segment and aggregated (here sequences are token-id lists; SEP/EOS split).

Both operate on integer token sequences (our synthetic captions have no
surface text), which preserves the metrics' semantics exactly.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Sequence


def _ngrams(seq: Sequence[int], n: int) -> Counter:
    return Counter(tuple(seq[i: i + n]) for i in range(len(seq) - n + 1))


def google_bleu(hyp: Sequence[int], ref: Sequence[int], max_n: int = 4) -> float:
    """GLEU: overlap / max(len_hyp_ngrams, len_ref_ngrams) over all 1..N-grams."""
    hyp, ref = list(hyp), list(ref)
    if not hyp or not ref:
        return 0.0
    match = hyp_total = ref_total = 0
    for n in range(1, max_n + 1):
        hg, rg = _ngrams(hyp, n), _ngrams(ref, n)
        match += sum((hg & rg).values())
        hyp_total += max(len(hyp) - n + 1, 0)
        ref_total += max(len(ref) - n + 1, 0)
    denom = max(hyp_total, ref_total)
    return match / denom if denom else 0.0


def _lcs_len(a: Sequence[int], b: Sequence[int]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def _split_sentences(seq: Sequence[int], seps: Iterable[int]) -> list[list[int]]:
    seps = set(seps)
    out, cur = [], []
    for t in seq:
        if t in seps:
            if cur:
                out.append(cur)
            cur = []
        else:
            cur.append(t)
    if cur:
        out.append(cur)
    return out or [[]]


def rouge_lsum(hyp: Sequence[int], ref: Sequence[int], seps: Iterable[int] = (2, 3)) -> float:
    """ROUGE-LSum F1: union-LCS over sentence splits (SEP=3 / EOS=2 ids)."""
    hyp_s = _split_sentences(list(hyp), seps)
    ref_s = _split_sentences(list(ref), seps)
    # summary-level: for each ref sentence, union of LCS matches vs all hyp sents
    lcs_sum = sum(max((_lcs_len(r, h) for h in hyp_s), default=0) for r in ref_s)
    m = sum(len(r) for r in ref_s)
    n = sum(len(h) for h in hyp_s)
    if lcs_sum == 0 or m == 0 or n == 0:
        return 0.0
    p, r = lcs_sum / n, lcs_sum / m
    return 2 * p * r / (p + r)


def corpus_scores(hyps: list[Sequence[int]], refs: list[Sequence[int]]) -> dict:
    """Average sentence-level scores (scaled x100 as the paper reports)."""
    assert len(hyps) == len(refs)
    if not hyps:
        return {"bleu": 0.0, "rsum": 0.0}
    bleu = sum(google_bleu(h, r) for h, r in zip(hyps, refs)) / len(hyps)
    rsum = sum(rouge_lsum(h, r) for h, r in zip(hyps, refs)) / len(hyps)
    return {"bleu": 100.0 * bleu, "rsum": 100.0 * rsum}
