"""Quickstart: federated multimodal LoRA fine-tuning with FediLoRA.

Ten clients with heterogeneous LoRA ranks (4..32) fine-tune a tiny
prefix-VLM on a synthetic image-captioning task with 60% missing
modalities; the server aggregates with the paper's dimension-wise
reweighting and clients repair their least-similar LoRA layer from the
previous global round.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core.editing import EditConfig
from repro_torch.data.missing import apply_missing_modality
from repro_torch.data.partition import heterogeneous_sizes
from repro_torch.data.synthetic import (SyntheticTaskConfig,
                                        make_federated_datasets)
from repro_torch.examples import device_parser
from repro_torch.federated import FederatedConfig, FederatedTrainer
from repro_torch.optim import OptimizerConfig

ROUNDS = 8


def build(*, device=None) -> FederatedTrainer:
    task = SyntheticTaskConfig(seed=0)
    sizes = heterogeneous_sizes(10, 700, seed=0)
    clients, global_test = make_federated_datasets(task, 10, sizes, seed=0)

    train_shards, eval_shards = [], []
    for k, d in enumerate(clients):
        n_tr = int(d["tokens"].shape[0] * 0.8)
        shard = {kk: v[:n_tr] for kk, v in d.items()}
        # FedMultimodal protocol: 60% of examples lose image or text
        shard = apply_missing_modality(shard, 0.6, task.prompt_len, seed=k)
        train_shards.append(shard)
        eval_shards.append({kk: v[n_tr:] for kk, v in d.items()})

    fed = FederatedConfig(
        num_clients=10, sample_rate=0.4,
        ranks=(4, 8, 8, 12, 12, 16, 16, 24, 32, 32),   # heterogeneous capacity
        local_steps=6, batch_size=8,
        aggregator="fedilora",                          # the paper's method
        edit=EditConfig(k=1, matrices="A"))             # Min-1, A-only editing
    opt = OptimizerConfig(peak_lr=3e-3, total_steps=600)
    return FederatedTrainer(get_config("fedbench-tiny"), fed, opt,
                            train_shards, eval_shards, global_test,
                            device=device)


def train(trainer: FederatedTrainer, rounds: int = ROUNDS) -> list[dict]:
    """``rounds`` blocking rounds, one printed line each."""
    print("round  train_loss  edited_layer_modules")
    recs = []
    for _ in range(rounds):
        rec = trainer.run_round()
        print(f"{rec['round']:>5}  {rec['train_loss']:<10.4f}  "
              f"{rec['edited_layers']}")
        recs.append(rec)
    return recs


def evaluate(trainer: FederatedTrainer) -> tuple[dict, dict]:
    """The global (32 test rows) and personalized (8 rows a client)
    evaluations, printed."""
    g = trainer.evaluate_global(n=32)
    p = trainer.evaluate_personalized(n=8)
    print(f"\nglobal:        loss={g['loss']:.4f} acc={g['acc']:.3f} "
          f"BLEU={g['bleu']:.2f} RSUM={g['rsum']:.2f}")
    print(f"personalized:  loss={p['loss']:.4f} acc={p['acc']:.3f} "
          f"BLEU={p['bleu']:.2f} RSUM={p['rsum']:.2f}")
    return g, p


def main(argv=None) -> dict:
    args = device_parser(__doc__.splitlines()[0]).parse_args(argv)
    trainer = build(device=args.device)
    recs = train(trainer)
    g, p = evaluate(trainer)
    return {"rounds": recs, "global": g, "personalized": p}


if __name__ == "__main__":
    main()
