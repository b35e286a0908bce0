"""Federated LoRA fine-tuning driver (CLI; port of
``repro/launch/train.py``, with the same flags and JSON lines).

Runs the paper's training loop — heterogeneous-rank clients, missing
modalities, dimension-wise aggregation and layer-wise editing — on a
registered architecture the port supports (the dense and prefix-VLM
families), in float32, on the CUDA device unless ``--device cpu``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch fedbench-tiny \
      --rounds 10 --aggregator fedilora --missing-ratio 0.6
  PYTHONPATH=src python -m repro_torch.launch.train --arch fedbench-100m \
      --rounds 1 --local-steps 2 --aggregator fedilora_kernel \
      --checkpoint-dir build/ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.editing import EditConfig
from repro_torch.data import (SyntheticTaskConfig, apply_missing_modality,
                              heterogeneous_sizes, make_federated_datasets)
from repro_torch.federated import FederatedConfig, FederatedTrainer
from repro_torch.optim import OptimizerConfig


def build_trainer(args) -> FederatedTrainer:
    mcfg = (get_reduced_config(args.arch) if args.reduced
            else get_config(args.arch))
    if mcfg.dtype != "float32":
        mcfg = dataclasses.replace(mcfg, dtype="float32")  # trainers run f32
    tcfg = SyntheticTaskConfig(vocab_size=min(mcfg.vocab_size, 256),
                               image_dim=mcfg.vision_dim or 32, seed=args.seed)
    sizes = heterogeneous_sizes(args.clients, args.examples, seed=args.seed)
    clients, gtest = make_federated_datasets(tcfg, args.clients, sizes,
                                             alpha=args.dirichlet_alpha,
                                             seed=args.seed)
    ctrain, ceval = [], []
    for k, d in enumerate(clients):
        n = d["tokens"].shape[0]
        ntr = max(int(n * 0.8), 1)
        tr = {kk: v[:ntr] for kk, v in d.items()}
        ev = {kk: v[ntr:] for kk, v in d.items()}
        tr = apply_missing_modality(tr, args.missing_ratio, tcfg.prompt_len,
                                    seed=args.seed + k)
        ctrain.append(tr)
        ceval.append(ev)

    ranks = tuple(int(r) for r in args.ranks.split(","))
    if len(ranks) == 1:
        ranks = ranks * args.clients
    fcfg = FederatedConfig(
        num_clients=args.clients, sample_rate=args.sample_rate, ranks=ranks,
        local_steps=args.local_steps, batch_size=args.batch_size,
        aggregator=args.aggregator, missing_ratio=args.missing_ratio,
        edit=EditConfig(enabled=not args.no_edit, k=args.edit_k,
                        matrices=args.edit_matrices,
                        gamma_mode=args.gamma_mode),
        seed=args.seed)
    ocfg = OptimizerConfig(peak_lr=args.lr, schedule=args.schedule,
                           total_steps=args.rounds * args.local_steps,
                           warmup_steps=args.warmup_steps)
    return FederatedTrainer(mcfg, fcfg, ocfg, ctrain, ceval, gtest,
                            seed=args.seed, device=args.device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fedbench-tiny")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--sample-rate", type=float, default=0.4)
    ap.add_argument("--ranks", default="4,8,8,12,12,16,16,24,32,32")
    ap.add_argument("--local-steps", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--examples", type=int, default=800)
    ap.add_argument("--aggregator", default="fedilora",
                    choices=["fedavg", "hetlora", "flora", "fedilora",
                             "fedilora_kernel"])
    ap.add_argument("--missing-ratio", type=float, default=0.0)
    ap.add_argument("--dirichlet-alpha", type=float, default=0.5)
    ap.add_argument("--no-edit", action="store_true")
    ap.add_argument("--edit-k", type=int, default=1)
    ap.add_argument("--edit-matrices", default="A",
                    choices=["A", "B", "both", "none"])
    ap.add_argument("--gamma-mode", default="similarity",
                    choices=["similarity", "full", "half"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="constant",
                    choices=["constant", "cosine", "wsd"])
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the trainer ('cpu' for tests)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    trainer = build_trainer(args)
    for r in range(args.rounds):
        rec = trainer.run_round()
        line = {"round": rec["round"],
                "train_loss": round(rec["train_loss"], 4),
                "edited_layers": rec["edited_layers"]}
        if (r + 1) % args.eval_every == 0 or r == args.rounds - 1:
            line["global"] = trainer.evaluate_global(n=32)
            line["personalized"] = trainer.evaluate_personalized(n=16)
        print(json.dumps(line), flush=True)
    if args.checkpoint_dir:
        from repro_torch.checkpoint import save_federated
        save_federated(args.checkpoint_dir, trainer)
        print(f"checkpoint written to {args.checkpoint_dir}")


if __name__ == "__main__":
    main()
