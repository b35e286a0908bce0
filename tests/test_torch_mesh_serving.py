"""The port's serving meshes on the CPU: ``AdapterStore`` /
``ServingEngine(mesh=...)`` over a gloo group of 2 spawned ranks — slots
split over a ``("data",)`` mesh (streamed and chunked prefill) and a 1×2
``("data", "model")`` mesh (tensor-parallel, ``gather`` and ``grouped``
backends, and ``top_k=1`` sampling, which draws from the gathered logits)
— must serve the unmeshed port engine's tokens and the JAX package's
engine's, request for request (the case of ``tests/test_mesh2d.py:216``,
on fedbench-tiny's prefix VLM and the reduced qwen2-0.5b, whose QKV bias
splits with its heads).  Then the reference's in-process validations
(``tests/test_mesh2d.py:282-477``, ``tests/test_client_store.py:207``) in
a gloo group of one rank.

The ranks import this module (spawn), so JAX is imported only inside the
functions that run the reference."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_mesh_round import join_mesh, spawn  # noqa: E402

TENANTS = (4, 8, 16, 8, 4)
BANK_SLOTS, RANK, SCALE = 2, 16, 2.0
ENGINE_KW = dict(lora_scale=SCALE, max_slots=4, max_prompt=8, max_gen=6)


def _world(name, seed=0):
    """Reference params (biases nonzero), adapters and requests."""
    import jax

    from repro.configs import get_reduced_config
    from repro.models import transformer as JT

    cfg = get_reduced_config(name)
    tree = jax.device_get(JT.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    attn = tree["blocks"]["s0"]["attn"]
    for p in [p for p in attn if p.startswith("b")]:
        attn[p] = (0.1 * rng.standard_normal(attn[p].shape)).astype(
            attn[p].dtype)
    adapters = {}
    for t, r in enumerate(TENANTS):
        adapters[f"t{t}"] = ({s.name: {
            "A": (0.2 * rng.standard_normal((s.num_layers, r, s.in_dim))
                  ).astype(np.float32),
            "B": (0.2 * rng.standard_normal((s.num_layers, s.out_dim, r))
                  ).astype(np.float32)} for s in JT.lora_specs(cfg)}, r)
    reqs = []
    for i in range(9):
        vis = (rng.standard_normal((cfg.num_vision_tokens, cfg.vision_dim))
               .astype(np.float32) if cfg.vision_mode == "prefix"
               and cfg.num_vision_tokens else None)
        reqs.append((f"t{int(rng.integers(0, len(TENANTS)))}",
                     rng.integers(0, cfg.vocab_size,
                                  size=int(rng.integers(1, 9))),
                     int(rng.integers(1, 7)), vis))
    return tree, adapters, reqs


def _reference_tokens(name, tree, adapters, reqs):
    from repro.configs import get_reduced_config
    from repro.serving import AdapterStore, Request, ServingEngine

    store = AdapterStore(slots=BANK_SLOTS, rank=RANK)
    for t, (a, r) in adapters.items():
        store.register(t, a, r)
    eng = ServingEngine(get_reduced_config(name), tree, store, **ENGINE_KW)
    return _bags(eng, Request, reqs)


def _bags(engine, request_cls, reqs):
    """Each request's tokens, in submission order."""
    rs = [request_cls(adapter_id=a, prompt_tokens=p, gen_len=g, vision=v)
          for a, p, g, v in reqs]
    order = {r.uid: i for i, r in enumerate(rs)}
    out = [None] * len(rs)
    for d in engine.run(rs):
        out[order[d["uid"]]] = np.asarray(d["tokens"]).tolist()
    return out


def _port_engine(name, tree, adapters, mesh=None, **kw):
    from repro_torch.configs import get_reduced_config
    from repro_torch.interop import adapters_from_numpy, params_from_numpy
    from repro_torch.serving import AdapterStore, ServingEngine

    store = AdapterStore(slots=BANK_SLOTS, rank=RANK, device="cpu",
                         mesh=mesh)
    for t, (a, r) in adapters.items():
        store.register(t, adapters_from_numpy(a), r)
    cfg = get_reduced_config(name)
    return ServingEngine(cfg, params_from_numpy(cfg, tree, device="cpu"),
                         store, device="cpu", mesh=mesh, **kw)


def _rank_serve(rank, world, rdv, name, tree, adapters, reqs, out):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serving import Request, SamplingConfig

    data = join_mesh(rank, world, rdv, (2,), ("data",))
    tp = Mesh((1, 2), ("data", "model"))
    runs = {}
    for what, mesh, kw in [
            ("unmeshed", None, {}),
            ("data", data, {}),
            ("data.chunk3", data, {"prefill_chunk": 3}),
            ("tp", tp, {}),
            ("tp.grouped", tp, {"lora_backend": "grouped"}),
            ("tp.grouped.chunk3", tp, {"lora_backend": "grouped",
                                       "prefill_chunk": 3}),
            ("tp.top_k1", tp, {"sampling": SamplingConfig(top_k=1)})]:
        eng = _port_engine(name, tree, adapters, mesh, **ENGINE_KW, **kw)
        runs[what] = (_bags(eng, Request, reqs), dict(eng.dispatch_count))
    shapes = {k: tuple(v.shape) for k, v in
              eng.params["blocks"]["s0"]["attn"].items()}
    try:                                 # 3 slots do not split over 2 ranks
        _port_engine(name, tree, adapters, data, **dict(ENGINE_KW,
                                                        max_slots=3))
        odd = None
    except ValueError as e:
        odd = str(e)
    torch.save({"runs": runs, "params": shapes, "odd_slots": odd},
               os.path.join(out, f"rank{rank}.pt"))


@pytest.mark.parametrize("name", ["fedbench-tiny", "qwen2-0.5b"])
def test_meshed_engines_serve_the_reference_tokens(name, tmp_path):
    tree, adapters, reqs = _world(name)
    want = _reference_tokens(name, tree, adapters, reqs)
    spawn(_rank_serve, 2, name, tree, adapters, reqs, str(tmp_path))
    outs = [torch.load(os.path.join(tmp_path, f"rank{r}.pt"),
                       weights_only=False) for r in range(2)]
    plain_bags, plain_counts = outs[0]["runs"]["unmeshed"]
    assert plain_bags == want
    for o in outs:
        for what, (bags, counts) in o["runs"].items():
            assert bags == want, (what, bags, want)
            # the host loop is the unmeshed engine's: same dispatches
            if "chunk" not in what:
                assert counts == plain_counts, (what, counts, plain_counts)
    # the TP engine holds half of each head-split weight
    from repro_torch.configs import get_reduced_config
    cfg = get_reduced_config(name)
    hd = cfg.resolved_head_dim
    assert outs[0]["params"]["wq"][-1] == cfg.num_heads * hd // 2
    assert outs[0]["params"]["wo"][-2] == cfg.num_heads * hd // 2
    assert "max_slots=3" in outs[0]["odd_slots"]


# -------------------------------------------------- in-process validation
@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo process group of one rank in this process."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed
    rdv = tmp_path_factory.mktemp("rdv") / "file"
    init_distributed(init_method=f"file://{rdv}", world_size=1, rank=0,
                     device="cpu")
    yield
    dist.destroy_process_group()


def _tiny_trainer(mesh=None, paged=False, client_mesh=None):
    from repro_torch import data as TD
    from repro_torch.configs import get_config
    from repro_torch.federated import FederatedConfig, FederatedTrainer
    from repro_torch.optim import OptimizerConfig
    clients, gtest = TD.make_federated_datasets(TD.SyntheticTaskConfig(), 3,
                                                np.array([24] * 3))
    fcfg = FederatedConfig(num_clients=3, sample_rate=0.67, ranks=(4, 8, 16),
                           local_steps=1, batch_size=4, paged=paged)
    return FederatedTrainer(get_config("fedbench-tiny"), fcfg,
                            OptimizerConfig(), clients, clients, gtest,
                            mesh=mesh, client_mesh=client_mesh, device="cpu")


def test_mesh_validation(world1):
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.core.editing import EditConfig
    from repro_torch.launch.fedround import make_round_engine
    from repro_torch.launch.mesh import Mesh, make_round_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptimizerConfig
    from repro_torch.serving import AdapterStore, ServingEngine

    m = Mesh((1,), ("clients",))
    with pytest.raises(ValueError, match="not both"):
        _tiny_trainer(mesh=m, client_mesh=m)
    # paged state and a mesh exclude each other (test_client_store.py:207)
    with pytest.raises(NotImplementedError, match="mesh"):
        _tiny_trainer(mesh=Mesh((1, 1), ("client", "model")), paged=True)
    # make_round_mesh needs as many ranks as the mesh has devices
    for args in ((2,), (2, 2)):
        with pytest.raises(ValueError, match="needs"):
            make_round_mesh(*args)
    # the round engine: a mesh needs n_sample; "model" must come last
    cfg = get_config("fedbench-tiny")
    eng = dict(lora_scale=1.0, r_g=8, edit=EditConfig())
    with pytest.raises(ValueError, match="n_sample"):
        make_round_engine(cfg, OptimizerConfig(), mesh=m, **eng)
    with pytest.raises(ValueError, match="round mesh"):
        make_round_engine(cfg, OptimizerConfig(), n_sample=2,
                          mesh=Mesh((1, 1), ("model", "client")), **eng)
    # a 2-D mesh takes the dense and prefix-VLM stacks only
    with pytest.raises(NotImplementedError, match="item 1.1"):
        make_round_engine(get_config("mamba2-130m"), OptimizerConfig(),
                          n_sample=2, mesh=Mesh((1, 1), ("client", "model")),
                          **eng)

    # serving: a "data" axis; the store on the engine's mesh or on none
    tiny = get_reduced_config("fedbench-tiny")
    params = T.init_params(tiny, device="cpu")
    with pytest.raises(ValueError, match="'data' axis"):
        ServingEngine(tiny, params, AdapterStore(slots=1, rank=4,
                                                 device="cpu"),
                      lora_scale=1.0, device="cpu",
                      mesh=Mesh((1,), ("slots",)))
    mesh = Mesh((1,), ("data",))
    store = AdapterStore(slots=1, rank=4, device="cpu",
                         mesh=Mesh((1,), ("data",)))
    with pytest.raises(ValueError, match="different mesh"):
        ServingEngine(tiny, params, store, lora_scale=1.0, max_slots=1,
                      device="cpu", mesh=mesh)
    store2 = AdapterStore(slots=1, rank=4, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="unsharded"):
        ServingEngine(tiny, params, store2, lora_scale=1.0, max_slots=1,
                      device="cpu")


def test_client_mesh_takes_every_family(world1):
    """The 1-D client mesh needs no tensor parallelism, so it runs every
    family: a round of the reduced mamba2-130m on a one-rank client mesh
    is the unmeshed round bit for bit; a 2-D mesh raises for it."""
    from repro_torch import data as TD
    from repro_torch.configs import get_reduced_config
    from repro_torch.federated import FederatedConfig, FederatedTrainer
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import OptimizerConfig

    cfg = get_reduced_config("mamba2-130m")
    clients, gtest = TD.make_federated_datasets(
        TD.SyntheticTaskConfig(vocab_size=cfg.vocab_size), 2,
        np.array([16, 16]))
    clients = [{k: v for k, v in c.items() if k in ("tokens", "labels",
                                                    "loss_mask")}
               for c in clients]

    def trainer(mesh):
        fcfg = FederatedConfig(num_clients=2, sample_rate=1.0, ranks=(4, 8),
                               local_steps=1, batch_size=4)
        return FederatedTrainer(cfg, fcfg, OptimizerConfig(), clients,
                                clients, gtest, mesh=mesh, device="cpu")

    tm, ts = trainer(Mesh((1,), ("clients",))), trainer(None)
    assert tm.run_round() == ts.run_round()
    for n, e in ts.server.global_lora.items():
        for m in ("A", "B"):
            assert torch.equal(tm.server.global_lora[n][m], e[m])
    with pytest.raises(NotImplementedError, match="item 1.1"):
        trainer(Mesh((1, 1), ("client", "model")))


def test_mesh_reassignment_and_store_set_mesh(world1):
    """A new mesh drops the trainer's built round steps (the same mesh
    keeps them), and a store adopting a mesh after its bank was built
    rebuilds the bank under it with the residents' rows."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    from repro_torch.serving import AdapterStore, ServingEngine

    tr = _tiny_trainer()
    tr._get_round_step()
    assert tr._round_step is not None
    tr.mesh = Mesh((1,), ("clients",))
    assert tr._round_step is None
    tr._get_round_step()
    tr.mesh = tr.mesh
    assert tr._round_step is not None

    tiny = get_reduced_config("fedbench-tiny")
    store = AdapterStore(slots=2, rank=8, device="cpu")
    lora = {s.name: {"A": torch.randn(s.num_layers, 4, s.in_dim),
                     "B": torch.randn(s.num_layers, s.out_dim, 4)}
            for s in T.lora_specs(tiny)}
    store.register("a", lora, 4)
    slot = store.acquire("a")
    before = {n: {p: x.clone() for p, x in e.items()}
              for n, e in store.scan_stack.items()}
    old = store.scan_stack
    mesh = Mesh((1, 1), ("data", "model"))
    eng = ServingEngine(tiny, T.init_params(tiny, device="cpu"), store,
                        lora_scale=1.0, max_slots=2, device="cpu", mesh=mesh)
    assert store.mesh is mesh and store.scan_stack is not old
    for n, e in store.scan_stack.items():
        for p, x in e.items():
            assert torch.equal(x[:, slot], before[n][p][:, slot])
    # frozen base weights are never split over the slot axis
    from repro_torch import sharding as SH
    for path, leaf in _leaves(eng.params):
        spec = SH.param_spec_tp(path, tuple(leaf.shape), mesh)
        assert "data" not in spec, (path, spec)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree
