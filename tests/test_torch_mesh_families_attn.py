"""Round meshes for the attention families DeepSeek-V2 (MLA + MoE),
llama4-scout (MoE) and llama-3.2-vision (gated cross layers, the gates
opened to 0.5) on the CPU: the cases, limits and harness of
``tests/test_torch_mesh_families.py``, which runs the two SSM families;
each file spawns its own (1, 2) and 2×2 ``("client", "model")`` groups of
gloo ranks for its families."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("torch.multiprocessing")

import test_torch_mesh_families as MF  # noqa: E402
from test_torch_mesh_families import world1  # noqa: E402, F401

HERE = [n for n in MF.FAMILIES if n not in MF.HERE]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return MF.make_runs(tmp_path_factory, HERE)


@pytest.mark.parametrize("mesh", list(MF.MESHES))
@pytest.mark.parametrize("name", HERE)
def test_family_rounds_on_mesh_match_reference(name, mesh, runs):
    MF.test_family_rounds_on_mesh_match_reference(name, mesh, runs)


@pytest.mark.parametrize("mesh", list(MF.MESHES))
@pytest.mark.parametrize("name", [n for n in MF.MOE if n in HERE])
def test_moe_routes_agree_on_every_rank(name, mesh, runs):
    MF.test_moe_routes_agree_on_every_rank(name, mesh, runs)


@pytest.mark.parametrize("name", HERE)
def test_population_eval_on_2x2_mesh(name, runs):
    MF.test_population_eval_on_2x2_mesh(name, runs)


@pytest.mark.parametrize("name", HERE)
def test_async_update_on_1x2_mesh(name, runs):
    MF.test_async_update_on_1x2_mesh(name, runs)


@pytest.mark.parametrize("name", HERE)
def test_family_round_1x1_is_the_unmeshed_round(name, runs, world1):
    MF.test_family_round_1x1_is_the_unmeshed_round(name, runs, world1)
