"""A checkpoint written by the JAX package's federated trainer serves the
same tokens through the port: one ``FederatedTrainer`` round on
``fedbench-tiny`` (3 clients of ranks 4/8/16), ``save_federated``, then
``AdapterStore.from_checkpoint`` in both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread beats oversubscribing the test workers
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.checkpoint import load_pytree as j_load_pytree  # noqa: E402
from repro.checkpoint import save_federated  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.editing import EditConfig  # noqa: E402
from repro.data.synthetic import (SyntheticTaskConfig,  # noqa: E402
                                  make_federated_datasets)
from repro.federated import FederatedConfig, FederatedTrainer  # noqa: E402
from repro.optim import OptimizerConfig  # noqa: E402
from repro.serving import AdapterStore as JStore  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.checkpoint import load_pytree  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import AdapterStore, Request, ServingEngine  # noqa: E402


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    tcfg = SyntheticTaskConfig(caption_len=8)
    clients, gtest = make_federated_datasets(tcfg, 3, np.array([40, 50, 60]))
    fcfg = FederatedConfig(num_clients=3, sample_rate=1.0, ranks=(4, 8, 16),
                           local_steps=2, batch_size=4, aggregator="fedilora",
                           edit=EditConfig(enabled=True))
    tr = FederatedTrainer(get_config("fedbench-tiny"), fcfg,
                          OptimizerConfig(peak_lr=3e-3, total_steps=50),
                          clients, clients, gtest, seed=0)
    tr.run_round()
    d = str(tmp_path_factory.mktemp("fed") / "ckpt")
    save_federated(d, tr)
    cap = int(np.argmax(np.asarray(clients[0]["loss_mask"])[0] > 0))
    reqs = [(f"client{k}", np.asarray(clients[k]["tokens"][i][:cap + 1]),
             6, np.asarray(clients[k]["image"][i]))
            for i in range(2) for k in range(3)]
    return d, tr, reqs


def test_port_reads_reference_npz(checkpoint):
    d, _, _ = checkpoint
    for k in range(3):
        ref = jax.device_get(j_load_pytree(f"{d}/client_{k}.npz"))
        got = load_pytree(f"{d}/client_{k}.npz")
        assert set(got) == set(ref)
        for name in ref:
            for p in ("A", "B"):
                np.testing.assert_array_equal(got[name][p], ref[name][p])


@pytest.mark.parametrize("backend", ["gather", "grouped"])
def test_from_checkpoint_serves_reference_tokens(checkpoint, backend):
    d, tr, reqs = checkpoint
    js = JStore.from_checkpoint(d, slots=2)
    ts = AdapterStore.from_checkpoint(d, slots=2, device="cpu")
    assert ts.ranks == js.ranks == {"client0": 4, "client1": 8,
                                    "client2": 16}
    assert ts.rank == js.rank
    kw = dict(lora_scale=tr.lora_scale, max_slots=4, max_prompt=8, max_gen=6,
              prefill_chunk=4, lora_backend=backend)
    je = JEngine(tr.mcfg, tr.base_params, js, **kw)
    cfg = t_config("fedbench-tiny")
    te = ServingEngine(cfg, params_from_numpy(cfg, jax.device_get(
        tr.base_params), device="cpu"), ts, device="cpu", **kw)
    jreqs = [JRequest(a, p, g, vision=v) for a, p, g, v in reqs]
    treqs = [Request(a, p, g, vision=v) for a, p, g, v in reqs]
    jd = {d["uid"]: d for d in je.run(jreqs)}
    td = {d["uid"]: d for d in te.run(treqs)}
    for jq, tq in zip(jreqs, treqs):
        assert td[tq.uid]["status"] == jd[jq.uid]["status"] == "ok"
        np.testing.assert_array_equal(td[tq.uid]["tokens"],
                                      jd[jq.uid]["tokens"])
    assert dict(te.dispatch_count) == dict(je.dispatch_count)
    assert ts.loads == js.loads > 2
