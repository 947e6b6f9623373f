"""The port's tensor-parallel layouts (``nf_tpu_torch.parallel.tp``), the
forward step's ``state_shardings`` and batch statistics over the global
batch (``nets/_batch_stats.py``), on the CPU in one process.

``param_shardings`` is held against JAX's ``param_shardings`` on JAX's
8-device CPU mesh for the same model's tensors (the port's parameters as
JAX arrays) at axis sizes 1, 2 and 4: the same split dim for every
tensor. The steps run on a one-rank gloo group: ``state_shardings`` at
(data 1, model 1) is bitwise the mesh step, and a ``use_batch_norm``
model's sharded step bitwise the mesh-less one. Several ranks are
``tests/test_torch_distributed.py``'s (a 2 x 2 dp x tp run at world size
4, batch statistics at world size 2).
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import nf_tpu.parallel.tp as jtp
import nf_tpu_torch as nt
from nf_tpu_torch.nets import _batch_stats
from nf_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    param_shardings,
    shard_batch,
    shard_params,
)
from test_torch_distributed import bn_flow_model, bn_nsf_model


def _mesh(n, rank=0, axes=("model",)):
    """A mesh describing rank ``rank`` of ``n`` along one axis (no process
    group: for the layouts alone)."""
    return Mesh(axes, np.arange(n), torch.device("cpu"), rank)


def _jax_spec(spec, ndim):
    """A JAX ``PartitionSpec`` as the port's tuple: trailing Nones
    dropped."""
    parts = list(spec) + [None] * (ndim - len(spec))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("min_size", [2, 8])
def test_param_shardings_match_jax(size, min_size):
    model = nt.build_nsf(dim=4, K=2, hidden=24, num_bins=4, device="cpu")
    tensors = dict(model.named_parameters())
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:size]), ("model",))
    jshard = jtp.param_shardings(
        {n: jnp.zeros(tuple(t.shape)) for n, t in tensors.items()}, jmesh,
        min_size=min_size)
    got = param_shardings(model, _mesh(size), min_size=min_size)
    assert set(got) == set(tensors)
    split = 0
    for name, t in tensors.items():
        want = _jax_spec(jshard[name].spec, t.ndim)
        assert got[name].spec == want, name
        split += bool(want)
    assert (split == 0) == (size == 1 or min_size == 8 and size == 4)


def test_param_shardings_take_a_train_state():
    model = nt.build_realnvp(dim=2, K=2, hidden=[32, 32], device="cpu")
    state = nt.init_train_state(model, torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
    assert {n: s.spec for n, s in param_shardings(state, _mesh(2)).items()} \
        == {n: s.spec for n, s in param_shardings(model, _mesh(2)).items()}


def test_shard_params_keeps_each_ranks_block():
    model = nt.build_realnvp(dim=2, K=2, hidden=[32, 32], device="cpu")
    tensors = dict(model.named_parameters())
    blocks = [shard_params(model, _mesh(2, r)) for r in range(2)]
    for name, t in tensors.items():
        spec = param_shardings(model, _mesh(2))[name].spec
        if not spec:
            assert all(torch.equal(b[name], t) for b in blocks)
            continue
        dim = len(spec) - 1
        assert torch.equal(torch.cat([b[name] for b in blocks], dim), t)
        assert blocks[1][name].data_ptr() != t.data_ptr() or \
            t.shape[dim] == 0


def test_mesh_groups_without_a_process_group():
    mesh = make_mesh(("data", "model"), shape=(1, 1), devices=["cpu"])
    assert not mesh.collective_over("model")
    assert mesh.group("data") is None and mesh.group("model") is None
    with pytest.raises(ValueError, match="no axis"):
        mesh.collective_over("sample")


@pytest.fixture
def world_of_one():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _steps(model, batch, **kw):
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    state = nt.init_train_state(model, opt)
    step = nt.make_forward_kld_step(opt, **kw)
    losses = [float(step(state, batch)) for _ in range(3)]
    return losses, _params(model), opt


def test_state_shardings_at_one_rank_are_the_mesh_step(world_of_one):
    """On a (data 1, model 1) mesh every parameter replicates, and the
    step with ``state_shardings`` is bitwise the mesh step."""
    mesh = make_mesh(("data", "model"), shape=(1, 1))
    assert mesh.collective_over("model") and mesh.group("model") is None
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 2)).astype(np.float32))
    a = nt.build_realnvp(dim=2, K=4, hidden=[32, 32], device="cpu", seed=2)
    b = nt.build_realnvp(dim=2, K=4, hidden=[32, 32], device="cpu", seed=2)
    sh = param_shardings(b, mesh)
    assert all(s.spec == () for s in sh.values())
    la, pa, _ = _steps(a, shard_batch(mesh, x), mesh=mesh)
    lb, pb, _ = _steps(b, shard_batch(mesh, x), mesh=mesh,
                       state_shardings=sh)
    assert la == lb and torch.equal(pa, pb)


def test_state_shardings_need_a_mesh_and_known_names():
    model = nt.build_realnvp(dim=2, K=2, hidden=[8, 8], device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(ValueError, match="mesh"):
        nt.make_forward_kld_step(opt, state_shardings={})
    mesh = make_mesh(("data", "model"), shape=(1, 1), devices=["cpu"])
    step = nt.make_forward_kld_step(
        opt, mesh=mesh,
        state_shardings={"no.such.weight": param_shardings(
            model, mesh)["flows.0.s.net.0.weight"]})
    with pytest.raises(ValueError, match="names no parameter"):
        step(nt.init_train_state(model, opt), torch.zeros(4, 2))


@pytest.mark.parametrize("build", [bn_nsf_model, bn_flow_model])
def test_batch_statistics_at_one_rank_are_the_local_ones(world_of_one,
                                                         build):
    """A sharded step at world size 1 trains a batch-norm model (no
    refusal) and is bitwise the mesh-less step: over one rank the layers
    keep their local statistics."""
    mesh = make_mesh()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (64, 2)).astype(np.float32))
    loss_fn = getattr(build, "loss_fn", None)
    a, b = build(), build()
    la, pa, _ = _steps(a, x, loss_fn=loss_fn)
    lb, pb, _ = _steps(b, shard_batch(mesh, x), mesh=mesh, loss_fn=loss_fn)
    assert la == lb and torch.equal(pa, pb)


@pytest.mark.parametrize("dims,correction", [((0,), 0), ((0,), 1),
                                             ((1,), 0), ((0, 2, 3), 0)])
def test_global_moments_are_the_sums_formula(world_of_one, dims,
                                             correction):
    """``moments`` from the all-reduced sum, sum of squares and count:
    over one rank (declared as two, so the all-reduce runs) they are
    ``torch.mean`` / ``torch.var``'s within 1e-6 (means) and 1e-5
    (variances, gradients) relative."""
    shape = (6, 3, 4, 5) if len(dims) == 3 else (7, 5)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(shape)
                         .astype(np.float32) + 0.5).requires_grad_()
    with _batch_stats.global_batch(None, 2):
        mean, var = _batch_stats.moments(x, dims, correction)
    want_mean = torch.mean(x, dim=dims, keepdim=True)
    want_var = torch.var(x, dim=dims, keepdim=True, correction=correction)
    torch.testing.assert_close(mean, want_mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(var, want_var, rtol=1e-5, atol=1e-6)
    g = torch.autograd.grad((mean * 2 + var).sum(), x)[0]
    w = torch.autograd.grad((want_mean * 2 + want_var).sum(), x)[0]
    torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert _batch_stats.moments(x, dims, correction) is None
