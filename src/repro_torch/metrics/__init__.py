"""Caption metrics (copy of ``repro/metrics``)."""

from repro_torch.metrics.text import google_bleu, rouge_lsum, corpus_scores  # noqa: F401
