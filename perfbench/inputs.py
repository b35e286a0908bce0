"""The inputs a run hands to both the port and the reference, made from
``--seed``: the base weights (drawn on the device, leaf by stacked leaf,
in the type they are served in), the synthetic captioning corpus with its
missing modalities, and the tenants' adapters.

Weights are a flat ``{dotted name: tensor}`` dict whose names are the
reference's (``reference/*.py`` ``param_specs``), which are the port's
tree paths too: :func:`nest` gives the port its tree of the same tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# reserved token ids of the captioning task
PAD, BOS, EOS, SEP = 0, 1, 2, 3
N_SPECIAL = 4


def draw_params(specs: dict, seed: int, device, dtype) -> dict:
    """One tensor per spec ``name -> (shape, init, f32)``: ``init`` is a
    normal's standard deviation, or ``"ones"`` / ``"zeros"``, or a
    callable ``(shape, generator, device) -> tensor`` for the few leaves
    with a law of their own.  ``f32`` leaves stay f32 whatever ``dtype``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name, (shape, init, f32) in specs.items():
        dt = torch.float32 if f32 else dtype
        if init == "ones":
            t = torch.ones(shape, device=device, dtype=dt)
        elif init == "zeros":
            t = torch.zeros(shape, device=device, dtype=dt)
        elif callable(init):
            t = init(shape, g, device).to(dt)
        else:
            t = torch.randn(shape, generator=g, device=device, dtype=dt)
            t.mul_(init)
        out[name] = t
    return out


def nest(flat: dict) -> dict:
    """``{"a.b.c": t}`` -> ``{"a": {"b": {"c": t}}}`` (the same tensors)."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


# --------------------------------------------------------------- corpus
def captioning_corpus(task: dict, sizes, seed: int, missing: float,
                      device="cpu") -> list[dict]:
    """Per-client shards of the synthetic captioning task (the pattern of
    the port's ``data/synthetic.py``: concept templates shared within
    ambiguity groups, images = a concept's patch basis plus noise,
    Dirichlet concept mixtures per client), then FedMultimodal's missing
    modalities: a share ``missing`` of each client's examples loses its
    image or its prompt (PAD, ``text_mask`` 0), half and half.

    A lost image is a zero image at the input of the frozen vision tower,
    so the features the language model reads are the tower's features of
    a blank image (one fixed draw), not zeros, and ``image_mask`` stays 1.
    Zeroed features (``image_mask`` 0, which the port's loss zeroes) make
    the prefix rows exactly zero at every layer, and the gradient through
    their RMS norms grows by about ``eps^-1/2`` a layer: at minicpm-v-2's
    40 layers it overflows and the first local step's adapter gradients
    are NaN, in the port and in the reference alike.

    Arrays are numpy; images f32 ``[n, P, D]``, drawn on ``device`` and
    brought to the host."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 17]))
    V, S = task["vocab_size"], task["seq_len"]
    n_c, amb = task["num_concepts"], task["ambiguity"]
    P, D, pl = task["num_patches"], task["image_dim"], task["prompt_len"]
    cl = S - pl - 3                   # BOS, prompt, SEP, caption, EOS
    n_groups = -(-n_c // amb)
    disambig = max(cl // 3, 2)
    shared = rng.integers(N_SPECIAL, V, size=(n_groups, cl - disambig))
    spec = rng.integers(N_SPECIAL, V, size=(n_c, disambig))
    templates = np.concatenate([shared[np.arange(n_c) // amb], spec], 1)
    prompts = rng.integers(N_SPECIAL, V, size=(n_groups, pl))
    g = torch.Generator(device=device).manual_seed(int(seed))
    basis = torch.randn((n_c, P, D), generator=g, device=device)
    blank = torch.randn((P, D), generator=g, device=device)
    shards = []
    for n in sizes:
        probs = rng.dirichlet(np.full(n_c, task["alpha"]))
        concepts = rng.choice(n_c, size=int(n), p=probs)
        seq = np.concatenate([
            np.full((n, 1), BOS), prompts[concepts // amb],
            np.full((n, 1), SEP), templates[concepts],
            np.full((n, 1), EOS)], 1).astype(np.int64)
        labels = np.full_like(seq, PAD)
        labels[:, :-1] = seq[:, 1:]
        mask = np.zeros((n, S), np.float32)
        mask[:, 1 + pl: 1 + pl + cl + 1] = 1.0
        image = basis[torch.from_numpy(concepts).to(device)] \
            + task["image_noise"] * torch.randn((n, P, D), generator=g,
                                                device=device)
        text_mask = np.ones(n, np.float32)
        drop = rng.random(n) < missing
        img = rng.random(n) < 0.5
        lost = torch.from_numpy(drop & img).to(device)
        image = torch.where(lost[:, None, None], blank, image).cpu().numpy()
        seq[drop & ~img, 1:1 + pl] = PAD
        text_mask[drop & ~img] = 0.0
        shards.append({"tokens": seq, "labels": labels, "loss_mask": mask,
                       "image": image, "image_mask": np.ones(n, np.float32),
                       "text_mask": text_mask})
    return shards


# -------------------------------------------------------------- adapters
def lora_init(sites: dict, r_g: int, seed: int, device) -> dict:
    """A fresh global adapter at rank ``r_g``: ``A ~ N(0, 1/r_g)`` (std
    ``r_g^-1/2``), ``B = 0``, f32, per site ``name -> (in, out, layers)``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name, (d_in, d_out, n) in sites.items():
        a = torch.randn((n, r_g, d_in), generator=g, device=device)
        out[name] = {"A": a / math.sqrt(r_g),
                     "B": torch.zeros((n, d_out, r_g), device=device)}
    return out


def tenant_adapters(sites: dict, ranks, seed: int, device, dtype,
                    b_std: float) -> list[dict]:
    """One adapter per tenant at its own rank, as the federation would
    hand it to the server: ``A ~ N(0, 1/in)``, ``B ~ N(0, b_std²)``,
    drawn on the device and kept on the host (CPU tensors)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for r in ranks:
        lo = {}
        for name, (d_in, d_out, n) in sites.items():
            a = torch.randn((n, r, d_in), generator=g, device=device,
                            dtype=dtype) * (d_in ** -0.5)
            b = torch.randn((n, d_out, r), generator=g, device=device,
                            dtype=dtype) * b_std
            lo[name] = {"A": a.cpu(), "B": b.cpu()}
        out.append(lo)
    return out
