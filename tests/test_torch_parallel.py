"""The port's parallel layer in one process (``nf_tpu_torch.parallel``):
meshes, layouts, ``shard_batch``, the data-parallel step against the
JAX package's sharded step and against the mesh-less step, the sharded
sampler, ``log_normalizer`` and ``prefetch_to_device(sharding=)``.

The JAX side runs its sharded step on its conftest's 8-device CPU mesh,
the port on a mesh of one, on the same exported weights and batch:
loss and updated parameters within 1e-4 (the JAX bar). A one-rank gloo
process group, brought up for a test and torn down after it, makes the
port's all-reduce run at world size 1, where it must change nothing.
Several processes are ``tests/test_torch_distributed.py``'s.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import nf_tpu.parallel as jpar
import nf_tpu_torch as nt
from nf_tpu.compat_export import export_state_dict
from nf_tpu_torch import data as tdata
from nf_tpu_torch import distributions as tdist
from nf_tpu_torch.compat_export import export_state_dict as texport
from nf_tpu_torch.parallel import (
    Mesh,
    data_sharding,
    log_normalizer,
    make_hybrid_mesh,
    make_mesh,
    make_sharded_sampler,
    process_slice,
    replicated,
    shard_batch,
)
from nf_tpu_torch.sampling import HAIS
from test_torch_train import _perturbed_pair

TOL = 1e-4
BATCH = 304  # divides over the JAX conftest's 8 devices


def _cpu_mesh():
    return make_mesh(devices=["cpu"])


def _rank_of_two(rank):
    """A mesh that describes rank ``rank`` of two, for the layouts alone
    (no process group)."""
    return Mesh(("data",), np.arange(2), torch.device("cpu"), rank)


@pytest.fixture
def world_of_one():
    """A one-rank gloo process group for the test, torn down after it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def test_meshes_and_layouts():
    mesh = _cpu_mesh()
    assert mesh.shape == {"data": 1} and mesh.size == 1
    assert mesh.device == torch.device("cpu") and mesh.axis_index("data") == 0
    assert make_mesh(("data", "model"), shape=(1, 1),
                     devices=["cpu"]).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="device count"):
        make_mesh(shape=(2,), devices=["cpu"])
    with pytest.raises(ValueError, match="shape required"):
        make_mesh(("data", "model"), devices=["cpu"])
    with pytest.raises(ValueError, match="one device per rank"):
        make_mesh(devices=["cpu", "cpu"])
    assert data_sharding(mesh, 3).spec == ("data", None, None)
    assert data_sharding(mesh, 3, dim=1).spec == (None, "data", None)
    assert data_sharding(mesh, 0).spec == () == replicated(mesh).spec
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(data_sharding(_rank_of_two(1), 2).local(x), x[3:])
    assert torch.equal(data_sharding(_rank_of_two(0), 1).local(x), x[:3])
    with pytest.raises(ValueError, match="divide"):
        data_sharding(_rank_of_two(0), 1).local(torch.zeros(5))


def test_process_slice_math():
    assert process_slice(64, 0, 4) == slice(0, 16)
    assert process_slice(64, 3, 4) == slice(48, 64)
    assert process_slice(64) == slice(0, 64)
    with pytest.raises(ValueError):
        process_slice(65, 0, 4)


def test_hybrid_mesh(monkeypatch):
    mesh = make_hybrid_mesh(("data", "model"), ici_shape=(1, 1),
                            devices=["cpu"])
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="lengths differ"):
        make_hybrid_mesh(("data",), ici_shape=(1, 1), devices=["cpu"])
    # four ranks in two groups of two: a group's ranks are consecutive,
    # and each axis takes its group coordinate as the outer factor
    import nf_tpu_torch.parallel.mesh as tmesh

    monkeypatch.setattr(tmesh, "world", lambda: (3, 4))
    mesh = make_hybrid_mesh(("data", "sample"), ici_shape=(1, 2),
                            dcn_shape=(2, 1), devices=["cpu"] * 4)
    np.testing.assert_array_equal(mesh.ranks, [[0, 1], [2, 3]])
    mesh = make_hybrid_mesh(("data", "sample"), ici_shape=(2, 1),
                            dcn_shape=(1, 2), devices=["cpu"] * 4)
    np.testing.assert_array_equal(mesh.ranks, [[0, 2], [1, 3]])
    assert (mesh.axis_index("data"), mesh.axis_index("sample")) == (1, 1)


def test_shard_batch_with_and_without_accum():
    x, y = torch.arange(16.0).reshape(8, 2), torch.arange(8)
    xs, ys = shard_batch(_rank_of_two(1), (x, y))
    assert torch.equal(xs, x[4:]) and torch.equal(ys, y[4:])
    micro = nt.reshape_for_accum(x, 2)  # (2, 4, 2)
    assert torch.equal(shard_batch(_rank_of_two(1), micro, accum=True),
                       micro[:, 2:])
    assert torch.equal(shard_batch(_cpu_mesh(), x), x)


def _steps(tmodel, opt, x, **kw):
    state = nt.init_train_state(tmodel, opt)
    loss = nt.make_forward_kld_step(opt, **kw)(state, x)
    return float(loss), [p.detach().clone() for p in tmodel.parameters()]


def test_forward_step_at_world_one_is_the_mesh_less_step(world_of_one):
    _, a = _perturbed_pair(2, seed=1)
    _, b = _perturbed_pair(2, seed=1)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (BATCH, 2)).astype(np.float32))
    la, pa = _steps(a, torch.optim.Adam(a.parameters(), lr=1e-2), x)
    lb, pb = _steps(b, torch.optim.Adam(b.parameters(), lr=1e-2),
                    shard_batch(world_of_one, x), mesh=world_of_one,
                    donate=True)
    assert la == lb
    assert all(torch.equal(p, q) for p, q in zip(pa, pb))


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_data_parallel_step_matches_jax(kind, world_of_one, monkeypatch):
    """JAX's sharded step on its 8-device mesh against the port's on a
    one-rank gloo group, so that the port's all-reduce of the flattened
    loss and gradients runs: the loss, and every updated parameter under
    the reference's names."""
    jmodel, tmodel = _perturbed_pair(2, seed=7)
    x = (np.random.default_rng(8).standard_normal((BATCH, 2)) * 1.5).astype(
        np.float32)
    jopt = optax.sgd(1e-2) if kind == "sgd" else optax.adam(1e-3)
    topt = (torch.optim.SGD(tmodel.parameters(), lr=1e-2) if kind == "sgd"
            else torch.optim.Adam(tmodel.parameters(), lr=1e-3))
    jmesh = jpar.make_mesh()
    assert jmesh.shape["data"] == 8
    state, static = jpar.init_train_state(jmodel, jopt)
    jstep = jpar.make_forward_kld_step(static, jopt, mesh=jmesh)
    state, jloss = jstep(state, jpar.shard_batch(jmesh, jnp.asarray(x)))
    want = export_state_dict(jpar.model_of_state(state, static))

    reduced = []

    def all_reduce(tensor, *args, **kw):
        reduced.append(tensor.numel())
        return real_all_reduce(tensor, *args, **kw)

    real_all_reduce = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    mesh = world_of_one
    tstate = nt.init_train_state(tmodel, topt)
    tloss = nt.make_forward_kld_step(topt, mesh=mesh)(
        tstate, shard_batch(mesh, torch.from_numpy(x)))
    got = texport(tmodel)
    # one all-reduce of the loss and every gradient, flattened together
    assert reduced == [1 + sum(p.numel() for p in tmodel.parameters())]
    assert abs(float(tloss) - float(jloss)) <= TOL
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=TOL,
                                   rtol=0, err_msg=k)


def _hais():
    return HAIS.create(np.linspace(1.0, 0.0, 6), tdist.DiagGaussian(2),
                       tdist.TwoModes(), num_leapfrog=3, step_size=0.2,
                       log_mass=torch.zeros(2), device="cpu")


def test_sharded_sampler_at_world_one_is_the_unsharded_hais():
    hais = _hais()
    sample = make_sharded_sampler(_cpu_mesh(), 128, with_stats=True)
    z, log_w, acc = sample(hais, torch.Generator().manual_seed(3))
    wz, wlog_w, wacc = hais.sample_with_stats(
        128, torch.Generator().manual_seed(3))
    assert torch.equal(z, wz) and torch.equal(log_w, wlog_w)
    assert torch.equal(acc, wacc)
    z2, log_w2 = make_sharded_sampler(_cpu_mesh(), 128)(
        hais, torch.Generator().manual_seed(3))
    assert torch.equal(z2, wz) and torch.equal(log_w2, wlog_w)
    want = torch.logsumexp(wlog_w, 0) - np.log(128)
    assert torch.equal(log_normalizer(log_w), want)
    assert torch.equal(log_normalizer(log_w, _cpu_mesh()), want)
    with pytest.raises(ValueError, match="divide"):
        make_sharded_sampler(_rank_of_two(0), 127)


def test_log_normalizer_over_a_world_of_one(world_of_one):
    log_w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        100).astype(np.float32) * 30)
    want = torch.logsumexp(log_w, 0) - np.log(100)
    np.testing.assert_allclose(float(log_normalizer(log_w, world_of_one)),
                               float(want), rtol=1e-6)


def test_prefetch_to_device_lands_the_ranks_shard():
    batches = [(np.arange(8.0).reshape(4, 2) + i, np.arange(4) + i)
               for i in range(3)]
    got = list(tdata.prefetch_to_device(
        iter(batches), sharding=data_sharding(_rank_of_two(1), 1)))
    for (x, y), (gx, gy) in zip(batches, got):
        assert gx.device == torch.device("cpu")
        np.testing.assert_array_equal(gx.numpy(), x[2:])
        np.testing.assert_array_equal(gy.numpy(), y[2:])
    whole = list(tdata.prefetch_to_device(
        iter(batches), sharding=data_sharding(_cpu_mesh(), 1),
        device="cpu"))
    np.testing.assert_array_equal(whole[2][0].numpy(), batches[2][0])
    with pytest.raises(ValueError, match="mesh's device"):
        next(tdata.prefetch_to_device(
            iter(batches), sharding=data_sharding(_cpu_mesh(), 1),
            device="meta"))
