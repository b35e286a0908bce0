"""End-to-end driver: federated LoRA fine-tuning of the ~100M-parameter
LLaVA-proxy (``fedbench-100m``) for a few hundred client steps, comparing
FediLoRA against HetLoRA under 60% missing modalities.

Defaults: 8 rounds × 4 sampled clients × 10 local steps = 320 client steps
per method.  Use --rounds/--local-steps to scale.

Run:  PYTHONPATH=src python -m repro_torch.examples.federated_finetune
      [--rounds 8]
"""

from __future__ import annotations

import json
import time

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.editing import EditConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.data.missing import apply_missing_modality
from repro_torch.data.partition import heterogeneous_sizes
from repro_torch.data.synthetic import (SyntheticTaskConfig,
                                        make_federated_datasets)
from repro_torch.examples import device_parser
from repro_torch.federated import FederatedConfig, FederatedTrainer
from repro_torch.models import transformer as T
from repro_torch.optim import OptimizerConfig


def build(method: str, *, rounds: int = 8, local_steps: int = 10,
          batch_size: int = 8, config: str = "fedbench-100m",
          device=None) -> FederatedTrainer:
    task = SyntheticTaskConfig(seed=1)
    sizes = heterogeneous_sizes(10, 900, seed=1)
    clients, gtest = make_federated_datasets(task, 10, sizes, seed=1)
    tr_shards, ev_shards = [], []
    for k, d in enumerate(clients):
        n_tr = int(d["tokens"].shape[0] * 0.8)
        sh = apply_missing_modality({kk: v[:n_tr] for kk, v in d.items()},
                                    0.6, task.prompt_len, seed=k)
        tr_shards.append(sh)
        ev_shards.append({kk: v[n_tr:] for kk, v in d.items()})
    fed = FederatedConfig(num_clients=10, sample_rate=0.4,
                          ranks=(4, 8, 8, 12, 12, 16, 16, 24, 32, 32),
                          local_steps=local_steps, batch_size=batch_size,
                          aggregator=method,
                          edit=EditConfig(enabled=method == "fedilora"))
    opt = OptimizerConfig(peak_lr=1e-3, total_steps=rounds * local_steps)
    mcfg = get_config(config)
    device = resolve_device(device)
    base = T.init_params(mcfg, seed=42, device=device)  # shared foundation
    return FederatedTrainer(mcfg, fed, opt, tr_shards, ev_shards, gtest,
                            base_params=base, device=device)


def count_params(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def finetune(tr: FederatedTrainer, method: str, rounds: int,
             t0: float) -> dict:
    """``rounds`` rounds of ``tr`` (a JSON line each), then its global and
    personalized evaluation and the wall since ``t0`` (a JSON line)."""
    recs = []
    for _ in range(rounds):
        rec = tr.run_round()
        recs.append(rec)
        print(json.dumps({"method": method, **{k: rec[k] for k in
                                               ("round", "train_loss")}}),
              flush=True)
    g = tr.evaluate_global(n=32)
    p = tr.evaluate_personalized(n=8)
    wall_s = round(time.time() - t0, 1)
    print(json.dumps({"method": method, "global": g, "personalized": p,
                      "wall_s": wall_s}), flush=True)
    return {"rounds": recs, "global": g, "personalized": p, "wall_s": wall_s}


def main(argv=None) -> dict:
    ap = device_parser(__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--methods", default="fedilora,hetlora")
    args = ap.parse_args(argv)

    out = {}
    for method in args.methods.split(","):
        t0 = time.time()
        tr = build(method, rounds=args.rounds, local_steps=args.local_steps,
                   batch_size=args.batch_size, device=args.device)
        if not out:     # counted from the first trainer's base weights
            n_params = count_params(tr.base_params)
            print(f"model: fedbench-100m ({n_params/1e6:.0f}M params), "
                  f"{args.rounds} rounds × {args.local_steps} local steps, "
                  f"60% missing")
        out[method] = finetune(tr, method, args.rounds, t0)
    return out


if __name__ == "__main__":
    main()
