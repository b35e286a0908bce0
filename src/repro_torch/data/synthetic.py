"""Deterministic synthetic multimodal task family.

Copy of ``repro/data/synthetic.py`` (numpy only), so the port builds the
same corpora bit for bit.

The paper evaluates on image-text datasets (Recaps-118K, SAM-LLaVA,
Next-Preference) that are not bundled with this repository.  We substitute a *structured* synthetic captioning family that
preserves the mechanisms the paper's claims depend on:

* each example has an **image** (patch embeddings derived from a latent
  concept vector plus noise — standing in for the stubbed vision tower, cf.
  the system carve-out for VLM frontends) and a **text caption** generated
  from a per-concept token template with synonym/ordering jitter;
* the mapping concept → caption is *learnable only through the modalities*:
  with the image zeroed and the prompt masked, the caption is ambiguous
  (several concepts share templates), which is what makes missing modalities
  genuinely hurt, as in FedMultimodal's protocol;
* clients receive **non-IID concept mixtures** (Dirichlet partition) and
  differ in data size, producing the heterogeneous p_k of FedAvg.

Everything is generated from a numpy PRNG seed — runs are exactly
reproducible.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

# Reserved token ids
PAD, BOS, EOS, SEP = 0, 1, 2, 3
N_SPECIAL = 4


class MultimodalBatch(NamedTuple):
    """Arrays for one (mini)batch; leading dims may include client axes."""

    tokens: np.ndarray        # i32[B, S]   input token ids (teacher forcing)
    labels: np.ndarray        # i32[B, S]   next-token targets (PAD = ignored)
    loss_mask: np.ndarray     # f32[B, S]   1 on caption positions
    image_embeds: np.ndarray  # f32[B, P, D] stubbed vision-tower output
    image_mask: np.ndarray    # f32[B]      1 if image modality present
    text_mask: np.ndarray     # f32[B]      1 if text prompt modality present


@dataclasses.dataclass(frozen=True)
class SyntheticTaskConfig:
    vocab_size: int = 256
    num_concepts: int = 24
    # concepts share caption templates in groups of `ambiguity` — without the
    # image the caption cannot be disambiguated beyond the group.
    ambiguity: int = 3
    caption_len: int = 12
    prompt_len: int = 4
    seq_len: int = 32
    num_patches: int = 8
    image_dim: int = 32
    image_noise: float = 0.25
    seed: int = 0


def _concept_templates(cfg: SyntheticTaskConfig, rng: np.random.Generator) -> np.ndarray:
    """[num_concepts, caption_len] token templates.  Concepts in the same
    ambiguity group share all but the last `disambig` caption tokens; those
    final tokens are concept-specific and recoverable only from the image."""
    n_groups = (cfg.num_concepts + cfg.ambiguity - 1) // cfg.ambiguity
    disambig = max(cfg.caption_len // 3, 2)
    shared = rng.integers(N_SPECIAL, cfg.vocab_size,
                          size=(n_groups, cfg.caption_len - disambig))
    templates = np.zeros((cfg.num_concepts, cfg.caption_len), np.int64)
    for c in range(cfg.num_concepts):
        g = c // cfg.ambiguity
        spec = rng.integers(N_SPECIAL, cfg.vocab_size, size=(disambig,))
        templates[c, : cfg.caption_len - disambig] = shared[g]
        templates[c, cfg.caption_len - disambig:] = spec
    return templates


def _concept_image_basis(cfg: SyntheticTaskConfig, rng: np.random.Generator) -> np.ndarray:
    """[num_concepts, num_patches, image_dim] clean patch embeddings."""
    return rng.normal(size=(cfg.num_concepts, cfg.num_patches, cfg.image_dim)).astype(np.float32)


@dataclasses.dataclass
class SyntheticTask:
    cfg: SyntheticTaskConfig
    templates: np.ndarray
    image_basis: np.ndarray
    prompt_vocab: np.ndarray  # per-group prompt tokens

    def example(self, concept: int, rng: np.random.Generator) -> dict:
        cfg = self.cfg
        caption = self.templates[concept]
        g = concept // cfg.ambiguity
        prompt = self.prompt_vocab[g]
        # tokens: BOS, prompt..., SEP, caption..., EOS, PAD...
        seq = [BOS, *prompt.tolist(), SEP, *caption.tolist(), EOS]
        seq = seq[: cfg.seq_len]
        tokens = np.full((cfg.seq_len,), PAD, np.int64)
        tokens[: len(seq)] = seq
        labels = np.full((cfg.seq_len,), PAD, np.int64)
        labels[: len(seq) - 1] = seq[1:]
        loss_mask = np.zeros((cfg.seq_len,), np.float32)
        cap_start = 1 + cfg.prompt_len  # position of SEP; predict caption from here
        loss_mask[cap_start: cap_start + cfg.caption_len + 1] = 1.0
        img = self.image_basis[concept] + cfg.image_noise * rng.normal(
            size=self.image_basis[concept].shape).astype(np.float32)
        return dict(tokens=tokens, labels=labels, loss_mask=loss_mask, image=img)


def make_synthetic_task(cfg: SyntheticTaskConfig) -> SyntheticTask:
    rng = np.random.default_rng(cfg.seed)
    templates = _concept_templates(cfg, rng)
    basis = _concept_image_basis(cfg, rng)
    n_groups = (cfg.num_concepts + cfg.ambiguity - 1) // cfg.ambiguity
    prompt_vocab = rng.integers(N_SPECIAL, cfg.vocab_size, size=(n_groups, cfg.prompt_len))
    return SyntheticTask(cfg, templates, basis, prompt_vocab)


def make_synthetic_dataset(cfg: SyntheticTaskConfig, num_examples: int,
                           concept_probs: np.ndarray | None = None,
                           seed: int = 0) -> dict:
    """Materialise a dataset dict of stacked arrays (+ concept ids)."""
    task = make_synthetic_task(cfg)
    rng = np.random.default_rng(seed + 1000 * cfg.seed + 17)
    if concept_probs is None:
        concept_probs = np.full((cfg.num_concepts,), 1.0 / cfg.num_concepts)
    concepts = rng.choice(cfg.num_concepts, size=num_examples, p=concept_probs)
    exs = [task.example(int(c), rng) for c in concepts]
    return dict(
        tokens=np.stack([e["tokens"] for e in exs]),
        labels=np.stack([e["labels"] for e in exs]),
        loss_mask=np.stack([e["loss_mask"] for e in exs]),
        image=np.stack([e["image"] for e in exs]),
        concept=concepts,
    )


def make_federated_datasets(cfg: SyntheticTaskConfig, num_clients: int,
                            examples_per_client: np.ndarray, alpha: float = 0.5,
                            seed: int = 0) -> tuple[list[dict], dict]:
    """Per-client non-IID datasets + a held-out global test set.

    ``examples_per_client`` gives heterogeneous |D_k| (→ FedAvg weights p_k).
    Concept mixtures are Dirichlet(alpha) per client, as is standard for
    label-skew federated benchmarks.
    """
    rng = np.random.default_rng(seed)
    clients = []
    for k in range(num_clients):
        probs = rng.dirichlet(np.full((cfg.num_concepts,), alpha))
        clients.append(make_synthetic_dataset(cfg, int(examples_per_client[k]),
                                              probs, seed=seed + 31 * (k + 1)))
    global_test = make_synthetic_dataset(cfg, 256, None, seed=seed + 999)
    return clients, global_test


def batch_iterator(dataset: dict, batch_size: int, rng: np.random.Generator):
    """Infinite shuffled minibatch iterator over a materialised dataset."""
    n = dataset["tokens"].shape[0]
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i: i + batch_size]
            yield {k: v[idx] for k, v in dataset.items()}
