"""Missing-modality simulation (FedMultimodal protocol, paper Sec. 4).

"we generate a certain sample of missing data for each dataset ... where text
inputs are set to None or image inputs are zeros (corresponding input shape)."

For a client with missing ratio ``mr``, a fraction ``mr`` of its examples
lose one modality (chosen uniformly between image and text unless forced):

* image missing → patch embeddings zeroed, ``image_mask = 0``;
* text missing  → prompt tokens replaced by PAD, ``text_mask = 0`` (BOS/SEP
  and the caption targets remain — the *supervision* is intact, the
  conditioning is not).
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import PAD


def apply_missing_modality(dataset: dict, missing_ratio: float, prompt_len: int,
                           seed: int = 0, mode: str = "both") -> dict:
    """Returns a new dataset dict with modality-dropped examples and masks."""
    rng = np.random.default_rng(seed)
    n = dataset["tokens"].shape[0]
    out = {k: np.array(v, copy=True) for k, v in dataset.items()}

    image_mask = np.ones((n,), np.float32)
    text_mask = np.ones((n,), np.float32)
    miss = rng.random(n) < missing_ratio
    which = rng.random(n)  # <0.5 → image, else text (when mode == both)

    for i in np.flatnonzero(miss):
        drop_image = mode == "image" or (mode == "both" and which[i] < 0.5)
        if drop_image:
            out["image"][i] = 0.0
            image_mask[i] = 0.0
        else:
            out["tokens"][i, 1: 1 + prompt_len] = PAD
            text_mask[i] = 0.0

    out["image_mask"] = image_mask
    out["text_mask"] = text_mask
    return out
