"""Abstract inputs for every (architecture × input shape) (port of
``repro/launch/specs.py``).

The reference describes its inputs as ``jax.ShapeDtypeStruct`` trees; the
port's are tensors on the ``meta`` device: shape, dtype and strides
without storage, so a full-size model's parameters, adapters and decode
cache cost no memory, and every op on them runs its shape function only
(the dry run traces its steps on them).  Modality frontends are stubs as
in the reference: VLM shapes carry precomputed patch embeddings, audio
shapes precomputed frame embeddings.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def _audio_len(seq: int) -> int:
    return max(seq // 4, 8)   # 4 tokens per frame (typical 40ms speech frames)


META = torch.device("meta")


def batch_specs(cfg: ModelConfig, batch: int, seq: int, *,
                with_labels: bool) -> dict:
    """Abstract training / prefill batch for one architecture."""
    dt = T.torch_dtype(cfg.dtype)
    empty = lambda shape, dtype: torch.empty(shape, dtype=dtype, device=META)
    sp: dict = {"tokens": empty((batch, seq), torch.int32)}
    if with_labels:
        sp["labels"] = empty((batch, seq), torch.int32)
        sp["loss_mask"] = empty((batch, seq), torch.float32)
    if cfg.family == "vlm":
        sp["image"] = empty((batch, cfg.num_vision_tokens, cfg.vision_dim),
                            dt)
        if with_labels:
            sp["image_mask"] = empty((batch,), torch.float32)
    if cfg.family == "encdec":
        sp["audio"] = empty((batch, _audio_len(seq), cfg.audio_dim), dt)
    return sp


def abstract_params(cfg: ModelConfig, tp=None):
    """The base weights (``tp``: a rank's pieces — its ``"model"`` cut and,
    under FSDP or expert parallelism, its ``"data"`` cut)."""
    return T.init_params(cfg, device=META, generator=torch.Generator(),
                         tp=tp)


def abstract_lora(cfg: ModelConfig, rank: int):
    from repro_torch.core.lora import LoRAConfig, init_lora_params
    return init_lora_params(T.lora_specs(cfg), LoRAConfig(rank=rank),
                            generator=torch.Generator(), device=META)


def abstract_cache(cfg: ModelConfig, params_abs, batch: int, max_len: int,
                   tp=None, cache_axis=None):
    """The decode cache; the vision / audio stand-ins are supplied
    abstractly, so a cross VLM's and an enc-dec's static caches are shaped,
    not computed.  ``tp``: ``params_abs`` are a rank's pieces and the cache
    holds its heads; ``cache_axis``: its positions split over that axis
    (``T.init_cache``)."""
    dt = T.torch_dtype(cfg.dtype)
    vision = audio = None
    if cfg.family == "vlm" and cfg.vision_mode == "cross":
        vision = torch.empty((batch, cfg.num_vision_tokens, cfg.vision_dim),
                             dtype=dt, device=META)
    if cfg.family == "encdec":
        audio = torch.empty((batch, _audio_len(max_len), cfg.audio_dim),
                            dtype=dt, device=META)
    return T.init_cache(cfg, params_abs, batch, max_len, vision=vision,
                        audio=audio, tp=tp, cache_axis=cache_axis)


def supports_shape(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Arch × shape applicability, as the reference decides it."""
    if shape.name == "long_500k" and shape.kind == "decode":
        if not cfg.supports_long_decode:
            return False, ("pure full-attention arch: long_500k decode skipped "
                           "(no sub-quadratic/bounded-state path; DESIGN.md §4)")
    return True, ""


def tree_bytes(tree) -> int:
    """The bytes of every tensor leaf of a nested dict / list."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


__all__ = ["INPUT_SHAPES", "InputShape", "META", "abstract_cache",
           "abstract_lora", "abstract_params", "batch_specs", "supports_shape",
           "tree_bytes"]
