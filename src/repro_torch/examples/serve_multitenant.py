"""Multi-tenant adapter serving demo: train a small federated population,
page its heterogeneous-rank personalized adapters into an AdapterStore and
serve a mixed request stream with the continuous-batching engine.

Walks the whole loop the serving subsystem closes:

1. two FediLoRA rounds leave every client with its own adapter (ranks 4..32);
2. the adapters are registered in an ``AdapterStore`` smaller than the
   population, so cold tenants LRU-page in and out of the device bank;
3. a request stream mixing all tenants and generation lengths is served —
   one multi-adapter dispatch per decode step, requests admitted into
   freed slots mid-flight with chunked multi-token prefill (⌈P/chunk⌉
   ``serve_prefill`` dispatches per prompt instead of P streamed decode
   steps) — and compared against per-client single-tenant decode
   (token-identical) plus the static drain-then-refill baseline;
4. the same stream is re-served with temperature/top-k sampling
   (per-slot generator state carried in the engine).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_multitenant
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import (SyntheticTaskConfig,
                                        make_federated_datasets)
from repro_torch.examples import device_parser
from repro_torch.federated import FederatedConfig, FederatedTrainer
from repro_torch.optim import OptimizerConfig
from repro_torch.serving import (AdapterStore, Request, SamplingConfig,
                                 ServingEngine)

NUM_CLIENTS = 6
RANKS = (4, 8, 8, 16, 24, 32)
ROUNDS = 2
SAMPLING = dict(sampling=SamplingConfig(temperature=1.5, top_k=20),
                sample_seed=7)


def build(*, device=None) -> tuple[FederatedTrainer, list[dict]]:
    """The trainer and its clients' corpora."""
    tcfg = SyntheticTaskConfig(caption_len=12)
    clients, gtest = make_federated_datasets(
        tcfg, NUM_CLIENTS, np.full((NUM_CLIENTS,), 40))
    fcfg = FederatedConfig(num_clients=NUM_CLIENTS, sample_rate=1.0,
                           ranks=RANKS, local_steps=2, batch_size=4,
                           aggregator="fedilora")
    tr = FederatedTrainer(get_config("fedbench-tiny"), fcfg,
                          OptimizerConfig(peak_lr=3e-3, total_steps=60),
                          clients, clients, gtest, seed=0, device=device)
    return tr, clients


def train(tr: FederatedTrainer) -> list[dict]:
    recs = [tr.run_round() for _ in range(ROUNDS)]
    print(f"trained {NUM_CLIENTS} clients (ranks {RANKS}), "
          f"last train loss {recs[-1]['train_loss']:.3f}")
    return recs


def caption_window(clients: list[dict]) -> tuple[int, int]:
    """``(cap_start, gen_len)`` of the clients' captions."""
    lm = np.asarray(clients[0]["loss_mask"])
    return int(np.argmax(lm[0] > 0)), int(lm[0].sum())


def requests(clients: list[dict]) -> list[Request]:
    """Twelve requests over every tenant, generation lengths mixed."""
    cap_start, gen_len = caption_window(clients)
    reqs = []
    for i in range(12):
        k = i % NUM_CLIENTS
        reqs.append(Request(
            adapter_id=f"client{k}",
            prompt_tokens=np.asarray(
                clients[k]["tokens"][i % 4][:cap_start + 1]),
            gen_len=(gen_len, 4, 8)[i % 3],
            vision=np.asarray(clients[k]["image"][i % 4])))
    return reqs


def serve(tr: FederatedTrainer, clients: list[dict], continuous: bool,
          **kw) -> tuple[ServingEngine, AdapterStore, list[dict]]:
    store = AdapterStore.from_trainer(tr, slots=3,     # bank < population
                                      device=tr.device)
    eng = ServingEngine(tr.mcfg, tr.base_params, store,
                        lora_scale=tr.lora_scale, max_slots=3,
                        max_prompt=8, max_gen=caption_window(clients)[1],
                        continuous=continuous, prefill_chunk=8,
                        device=tr.device, **kw)
    done = eng.run(requests(clients))
    return eng, store, done


def serve_all(tr: FederatedTrainer, clients: list[dict]) -> dict:
    """Serve the stream continuously (spot-checked against the
    single-tenant decode), statically, and continuously with sampling."""
    cap_start, _ = caption_window(clients)
    eng, store, done = serve(tr, clients, continuous=True)
    ttft = sorted(d["ttft_s"] for d in done)[len(done) // 2]
    print(f"continuous: {len(done)} requests in {eng.steps} decode steps "
          f"({dict(eng.dispatch_count)}); p50 TTFT {ttft * 1e3:.1f}ms; "
          f"adapter pages in/out: {store.loads}/{store.evictions}")

    # token-exactness vs the single-tenant cached greedy decode
    for d in done[:3]:
        k = int(d["adapter_id"][len("client"):])
        row = next(i % 4 for i in range(12)
                   if i % NUM_CLIENTS == k)       # first request row of k
        image = torch.from_numpy(np.asarray(
            clients[k]["image"][row:row + 1])).to(tr.device)
        ref = tr._generate_cached(
            tr.clients[k].lora, np.asarray(clients[k]["tokens"][row:row + 1]),
            image, cap_start, len(d["tokens"]))
        if not np.array_equal(d["tokens"], ref[0]):
            raise AssertionError(f"client{k}: engine tokens {d['tokens']} "
                                 f"!= single-tenant decode {ref[0]}")
    print("spot-checked tokens == per-client make_greedy_generate ✓")

    eng_s, store_s, done_s = serve(tr, clients, continuous=False)
    print(f"static baseline: {len(done_s)} requests in {eng_s.steps} steps "
          f"→ continuous saves {eng_s.steps - eng.steps} steps")

    _, _, done_t = serve(tr, clients, continuous=True, **SAMPLING)
    # uids increase in submission order, so sorting aligns the two runs
    # request-for-request
    changed = sum(
        not np.array_equal(a["tokens"], b["tokens"])
        for a, b in zip(sorted(done, key=lambda d: d["uid"]),
                        sorted(done_t, key=lambda d: d["uid"])))
    print(f"sampled rerun (T=1.5, top-20): {changed}/{len(done_t)} requests "
          "diverge from greedy")
    return {"continuous": (eng, store, done),
            "static": (eng_s, store_s, done_s), "sampled": done_t,
            "changed": changed}


def main(argv=None) -> dict:
    args = device_parser(__doc__.splitlines()[0]).parse_args(argv)
    tr, clients = build(device=args.device)
    return {"train": train(tr), **serve_all(tr, clients)}


if __name__ == "__main__":
    main()
