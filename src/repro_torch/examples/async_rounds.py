"""Async federated timelines: pipelined rounds and buffered FedBuff rounds.

Three drivers over the same fused round (fedbench-tiny scale):

1. ``run_round``           — blocking: dispatch round t, fetch its metrics.
2. ``run_round_pipelined`` — the host samples clients and builds batch
   indices for round t+1 while round t still executes on device; metrics
   arrive one round late (``None`` on the first call, ``flush_rounds()``
   drains the tail).
3. ``run_round_async``     — buffered asynchronous FL: each tick dispatches
   a cohort against the current global, slow clients (``async_delays``)
   retire late into a delta buffer, and every ``buffer_size`` deltas the
   server merges them with ``(1+staleness)^-decay`` discounting through the
   ``fedbuff`` aggregator — fast clients never wait for slow ones.

Run:  PYTHONPATH=src python -m repro_torch.examples.async_rounds
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.editing import EditConfig
from repro_torch.data.synthetic import (SyntheticTaskConfig,
                                        make_federated_datasets)
from repro_torch.examples import device_parser
from repro_torch.federated import FederatedConfig, FederatedTrainer
from repro_torch.optim import OptimizerConfig

ROUNDS = 6
ASYNC = dict(buffer_size=3,
             async_delays=(0, 0, 0, 0, 2, 3),   # two stragglers
             staleness_decay=0.5)


def build(aggregator: str, *, device=None, **fed_kw) -> FederatedTrainer:
    task = SyntheticTaskConfig(seed=3)
    clients, gtest = make_federated_datasets(task, 6, np.full(6, 64))
    fed = FederatedConfig(num_clients=6, sample_rate=0.5,
                          ranks=(4, 8, 8, 16, 16, 32), local_steps=4,
                          batch_size=8, aggregator=aggregator,
                          edit=EditConfig(enabled=True), **fed_kw)
    opt = OptimizerConfig(peak_lr=3e-3, total_steps=ROUNDS * 4)
    return FederatedTrainer(get_config("fedbench-tiny"), fed, opt,
                            clients, clients, gtest, seed=0, device=device)


def blocking_vs_pipelined(blocking: FederatedTrainer,
                          pipelined: FederatedTrainer) -> dict:
    """One warm-up round on each, then ``ROUNDS`` blocking and ``ROUNDS``
    pipelined rounds, timed.  Returns every record (the pipelined ones as
    they arrive: ``None`` first, the flushed tail last) and the rates."""
    blocking_recs = [blocking.run_round()]                 # warm-up
    pipelined_recs = [pipelined.run_round_pipelined()]
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        rec = blocking.run_round()
        blocking_recs.append(rec)
    t_block = (time.perf_counter() - t0) / ROUNDS
    print(f"blocking : {1 / t_block:6.2f} rounds/s   "
          f"(last loss {rec['train_loss']:.3f})")

    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        pipelined_recs.append(pipelined.run_round_pipelined())
    pipelined_recs.append(pipelined.flush_rounds())     # the final fetch
    t_pipe = (time.perf_counter() - t0) / ROUNDS
    print(f"pipelined: {1 / t_pipe:6.2f} rounds/s   "
          f"(metrics one round stale by design)")
    return {"blocking": blocking_recs, "pipelined": pipelined_recs,
            "rounds_per_s": {"blocking": 1 / t_block,
                             "pipelined": 1 / t_pipe}}


def buffered(asy: FederatedTrainer) -> dict:
    """``2 * ROUNDS`` buffered-async ticks (a line for each that merged),
    then the personalized evaluation."""
    recs = []
    for _ in range(2 * ROUNDS):
        rec = asy.run_round_async()
        recs.append(rec)
        if rec["merges"]:
            print(f"tick {rec['tick']:2d}: merged {rec['merges']} "
                  f"buffer(s), staleness {rec['staleness']}, "
                  f"loss {rec.get('train_loss', float('nan')):.3f}")
    print(f"server versions applied: {asy._global_version}")
    ev = asy.evaluate_personalized(n=8)
    print("personalized eval (ONE vmapped dispatch):",
          {k: round(v, 4) for k, v in ev.items()})
    return {"ticks": recs, "versions": asy._global_version, "eval": ev}


def main(argv=None) -> dict:
    args = device_parser(__doc__.splitlines()[0]).parse_args(argv)
    # ---- blocking vs pipelined: identical maths, overlapped timeline ------
    timeline = blocking_vs_pipelined(build("fedilora", device=args.device),
                                     build("fedilora", device=args.device))
    # ---- buffered async: slow clients don't stall fast ones ---------------
    asy = buffered(build("fedbuff", device=args.device, **ASYNC))
    return {"timeline": timeline, "async": asy}


if __name__ == "__main__":
    main()
