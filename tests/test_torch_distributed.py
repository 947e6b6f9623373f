"""The port's multi-process layer on the CPU: two OS processes join a gloo
process group and train through ``nf_tpu_torch.parallel`` and the
training binary, against one process running the same global recipe
(the port's twin of ``tests/test_multihost.py``).

The workers are this file run as a script (``--worker``). Each writes a
JSON of what it saw; the tests compare rank 0 with rank 1 (bitwise: the
replicas take identical updates) and the two processes with the one
(within 1e-5 relative: gloo's sum of two halves against one process's
sum over the whole batch differs in the order of additions). Four more
processes run ``__graft_entry__.dryrun_multichip``'s dp x tp step on a
(data 2, model 2) mesh with ``state_shardings``, and the two processes
also train batch-norm models, whose statistics span the ranks; both are
held against the one process on the whole batch within 1e-5. Three more
processes (two ranks and one) take the batch statistics of a ``BatchNorm``
flow and a ``ResidualNet(use_batch_norm=True)`` on data at mean 300 and
standard deviation 0.01, in float32 and bfloat16, against JAX's layers on
the whole batch: a one-pass variance across the ranks cancels there.
"""

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
GLOBAL_BATCH = 64
REVERSE_SAMPLES = 64
SAMPLER_N = 64
LR = 1e-2
REV_LR = 1e-2
BINARY_2D = ["--model", "realnvp", "--loss", "forward_kld", "--target",
             "two_moons", "--iters", str(STEPS), "--num_layers", "2",
             "--hidden", "16", "--batch_size", str(GLOBAL_BATCH),
             "--log_every", "1"]
BINARY_GLOW = ["--model", "glow", "--iters", str(STEPS), "--levels", "1",
               "--num_layers", "1", "--hidden", "8", "--image_size", "8",
               "--batch_size", str(GLOBAL_BATCH), "--log_every", "100"]
BINARY_RESIDUAL = ["--model", "residual", "--loss", "forward_kld",
                   "--target", "two_moons", "--iters", "2", "--num_layers",
                   "2", "--hidden", "16", "--batch_size", "32"]


def _nsf():
    import nf_tpu_torch as nt

    return nt.build_nsf(dim=2, K=2, hidden=16, num_bins=4,
                        target=nt.TwoModes(), device="cpu", seed=3)


def _dataset():
    rng = np.random.default_rng(5)
    theta = rng.random(512) * 2 * np.pi
    return (np.stack([2 * np.cos(theta), np.sin(theta)], 1)
            + rng.normal(0, 0.1, (512, 2))).astype(np.float32)


def _params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _summary(model):
    flat = _params(model).numpy()
    return {"params": flat.tolist(),
            "param_sum": float(np.sum(np.abs(flat.astype(np.float64)))),
            "param_hash": hashlib.sha256(flat.tobytes()).hexdigest()}


def _forward_runs(mesh, accum):
    """Five data-parallel steps on the same global batches."""
    import nf_tpu_torch as nt
    from nf_tpu_torch.parallel import shard_batch

    model = _nsf()
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    state = nt.init_train_state(model, opt)
    step = nt.make_forward_kld_step(opt, mesh=mesh, accum_steps=accum)
    data = _dataset()
    rng = np.random.default_rng(9)
    losses = []
    for _ in range(STEPS):
        batch = torch.from_numpy(data[rng.integers(0, len(data),
                                                   GLOBAL_BATCH)])
        if accum > 1:
            batch = nt.reshape_for_accum(batch, accum)
        losses.append(float(step(state, shard_batch(mesh, batch,
                                                    accum=accum > 1))))
    return dict(losses=losses, **_summary(model))


def _reverse_run(mesh):
    """One sample-parallel SGD step; the rank's base draws recorded."""
    import nf_tpu_torch as nt

    model = _nsf()
    drawn = []
    base = model.q0.forward

    def recording(num_samples, generator=None, context=None):
        z, log_q = base(num_samples, generator=generator)
        drawn.append(z.tolist())
        return z, log_q

    model.q0.forward = recording
    opt = torch.optim.SGD(model.parameters(), lr=REV_LR)
    state = nt.init_train_state(model, opt)
    step = nt.make_reverse_kld_step(opt, num_samples=REVERSE_SAMPLES,
                                    mesh=mesh)
    loss = step(state, torch.Generator().manual_seed(11))
    return {"draws": drawn[0], "loss": float(loss),
            "params": _params(model).tolist()}


class _Recorder:
    """A sampler that records each rank's own accept rates."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.own = None

    def sample_with_stats(self, n, generator):
        z, log_w, acc = self.sampler.sample_with_stats(n, generator)
        self.own = acc.tolist()
        return z, log_w, acc


def _sampler_run(mesh):
    from nf_tpu_torch import distributions as dist
    from nf_tpu_torch.parallel import log_normalizer, make_sharded_sampler
    from nf_tpu_torch.sampling import HAIS

    hais = HAIS.create(np.linspace(1.0, 0.0, 5), dist.DiagGaussian(2),
                       dist.TwoModes(), num_leapfrog=3, step_size=0.2,
                       log_mass=torch.zeros(2), device="cpu")
    rec = _Recorder(hais)
    sample = make_sharded_sampler(mesh, SAMPLER_N, with_stats=True)
    z, log_w, acc = sample(rec, torch.Generator().manual_seed(4))
    return {"z": z.tolist(), "log_w": log_w.tolist(), "own": rec.own,
            "pooled": acc.tolist(),
            "log_z": float(log_normalizer(log_w, mesh))}


# __graft_entry__.dryrun_multichip's dp x tp step: build_realnvp(dim 2, K 4,
# hidden [32, 32]), Adam(1e-3), one step on 8 rows per rank
TP_BATCH = 32
TP_LR = 1e-3
BN_LR = 1e-2


def _tp_batch():
    return np.random.default_rng(13).standard_normal(
        (TP_BATCH, 2)).astype(np.float32)


def _tp_run(mesh=None):
    """The dp x tp step on a (data 2, model 2) mesh with ``param_shardings``
    over ``model`` (the whole batch, mesh-less, without ``mesh``): the
    loss, the whole parameters after the step, and how many elements of
    Adam's state the rank holds."""
    import nf_tpu_torch as nt
    from nf_tpu_torch.parallel import param_shardings, shard_batch

    model = nt.build_realnvp(dim=2, K=4, hidden=[32, 32], device="cpu",
                             seed=7)
    with torch.no_grad():  # the zero-initialised last layers moved
        gen = torch.Generator().manual_seed(8)
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    opt = torch.optim.Adam(model.parameters(), lr=TP_LR)
    state = nt.init_train_state(model, opt)
    batch = torch.from_numpy(_tp_batch())
    if mesh is None:
        loss = nt.make_forward_kld_step(opt)(state, batch)
    else:
        sh = param_shardings(state, mesh, axis="model")
        step = nt.make_forward_kld_step(opt, mesh=mesh, state_shardings=sh)
        loss = step(state, shard_batch(mesh, batch))
    held = sum(v.numel() for st in opt.state.values() for k, v in st.items()
               if k == "exp_avg")
    return {"loss": float(loss), "params": _params(model).tolist(),
            "opt_state": held,
            "full": sum(p.numel() for p in model.parameters())}


def bn_nsf_model():
    """A ``build_nsf``-shaped model whose coupling trunks have
    ``use_batch_norm=True`` (``chip_smoke.batch_norm_nsf_model`` at K 2,
    hidden 16, 4 bins), its weights moved from the identity by seeded
    noise."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import distributions as tdist
    from nf_tpu_torch import flows as tflows
    from nf_tpu_torch.nets import ResidualNet
    from nf_tpu_torch.utils import create_alternating_binary_mask

    gen = torch.Generator().manual_seed(21)

    def net_fn(n_in, n_out):
        return ResidualNet(n_in, n_out, 16, num_blocks=2, use_batch_norm=True,
                           bin_major_head=(1, 3 * 4 - 1), generator=gen)

    flows = []
    for i in range(2):
        mask = create_alternating_binary_mask(2, even=i % 2 == 1)
        flows += [tflows.Reverse(tflows.PiecewiseRationalQuadraticCoupling(
                      mask, net_fn, num_bins=4, tails="linear",
                      tail_bound=3.0, apply_unconditional_transform=True)),
                  tflows.LULinearPermute(2, generator=gen)]
    model = nt.NormalizingFlow(tdist.DiagGaussian(2, trainable=False), flows)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=gen))
    return model


def _latent_kld(model, z):
    """The reverse KLD on given base draws ``z`` (a batch): a
    ``BatchNorm`` stack has only the sampling direction."""
    x, log_det = model.forward_and_log_det(z)
    return torch.mean(model.q0.log_prob(z) - log_det - model.p.log_prob(x))


def bn_flow_model():
    """A RealNVP-shaped stack with ``BatchNorm`` after each coupling
    (``chip_smoke``'s phase 21 stack at 2 couplings, MLPs [2, 16, 2]) on
    TwoModes; trained through :func:`_latent_kld` (``loss_fn``)."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import distributions as tdist
    from nf_tpu_torch import flows as tflows
    from nf_tpu_torch.nets import MLP

    gen = torch.Generator().manual_seed(22)
    flows = []
    for i in range(2):
        b = torch.tensor([1.0, 0.0] if i % 2 == 0 else [0.0, 1.0])
        flows += [tflows.MaskedAffineFlow(b, t=MLP([2, 16, 2], generator=gen),
                                          s=MLP([2, 16, 2], generator=gen)),
                  tflows.BatchNorm()]
    model = nt.NormalizingFlow(tdist.DiagGaussian(2), flows,
                               p=tdist.TwoModes())
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=gen))
    return model


bn_flow_model.loss_fn = _latent_kld


def _bn_run(build, mesh=None):
    """One SGD step of a batch-norm model on the global batch (this
    rank's shard of it with ``mesh``): its loss and parameters."""
    import nf_tpu_torch as nt
    from nf_tpu_torch.parallel import shard_batch

    model = build()
    opt = torch.optim.SGD(model.parameters(), lr=BN_LR)
    state = nt.init_train_state(model, opt)
    batch = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (GLOBAL_BATCH, 2)).astype(np.float32))
    kw = dict(loss_fn=getattr(build, "loss_fn", None))
    if mesh is not None:
        batch = shard_batch(mesh, batch)
        kw["mesh"] = mesh
    loss = nt.make_forward_kld_step(opt, **kw)(state, batch)
    return {"loss": float(loss), "params": _params(model).tolist()}


BN_STATS_SEED = 31
BN_STATS_HIDDEN = 16
# rows of the batch-statistics data: 501 per rank, a count bfloat16 cannot
# hold (it rounds to 500)
BN_STATS_BATCH = 1002


def bn_stats_data():
    """(BN_STATS_BATCH, 2) float32 draws at mean 300 and standard
    deviation 0.01: the sum of squares less the square of the sum cancels
    there."""
    rng = np.random.default_rng(BN_STATS_SEED)
    return (300.0 + 0.01 * rng.standard_normal((BN_STATS_BATCH, 2))).astype(
        np.float32)


def _bn_stats_run(weights, world, rank, dtype):
    """This rank's shard (the whole batch at world size 1) of
    :func:`bn_stats_data` in ``dtype`` through the batch statistics, a
    ``BatchNorm`` flow and a batch-norm ``ResidualNet`` loaded from
    ``weights``, inside ``global_batch`` over ``world`` ranks; the
    ResidualNet's parameter gradients of the mean squared output over the
    global batch, summed over the ranks."""
    import contextlib

    import torch.distributed as dist

    import nf_tpu_torch as nt
    from nf_tpu_torch import flows as tflows
    from nf_tpu_torch.nets import ResidualNet
    from nf_tpu_torch.nets import _batch_stats

    x = torch.from_numpy(bn_stats_data()).to(dtype).chunk(world)[rank]
    net = nt.load_reference_state_dict(
        ResidualNet(2, 2, BN_STATS_HIDDEN, num_blocks=2, use_batch_norm=True,
                    dtype=dtype), dict(np.load(weights)))
    ctx = (_batch_stats.global_batch(None, world) if world > 1
           else contextlib.nullcontext())
    with ctx:
        stats = _batch_stats.moments(x, (0,), 1) if world > 1 else (
            torch.mean(x, 0, keepdim=True),
            torch.var(x.double(), 0, keepdim=True).to(dtype))
        z, log_det = tflows.BatchNorm()(x)
        y = net(x)
        loss = torch.sum(y.float() ** 2) / BN_STATS_BATCH
    loss.backward()
    grads = torch.cat([p.grad.float().reshape(-1) for p in net.parameters()])
    if world > 1:
        dist.all_reduce(grads)
    return {"mean": stats[0].float().tolist(),
            "var": stats[1].float().tolist(), "z": z.float().tolist(),
            "log_det": log_det.float().tolist(), "y": y.float().tolist(),
            "grads": grads.tolist()}


def bn_stats_worker(args):
    from nf_tpu_torch.parallel import initialize_distributed

    if args.num_processes > 1:
        initialize_distributed(
            coordinator_address=f"127.0.0.1:{args.port}",
            num_processes=args.num_processes, process_id=args.process_id,
            platform="cpu")
    out = {str(dtype).split(".")[-1]: _bn_stats_run(
               args.bn_stats, args.num_processes, args.process_id, dtype)
           for dtype in (torch.float32, torch.bfloat16)}
    with open(args.out, "w") as f:
        json.dump(out, f)


def _binary(argv):
    from nf_tpu_torch import train

    state = train.main(argv, device="cpu")
    return dict(final_step=state.step, **_summary(state.model))


def worker(args):
    sys.path.insert(0, ROOT)
    if args.bn_stats:
        return bn_stats_worker(args)
    from nf_tpu_torch.parallel import (
        initialize_distributed,
        make_hybrid_mesh,
        make_mesh,
        per_process_batches,
    )

    distributed = args.num_processes > 1
    if distributed:
        rank, world = initialize_distributed(
            coordinator_address=f"127.0.0.1:{args.port}",
            num_processes=args.num_processes, process_id=args.process_id,
            platform="cpu")
        assert (rank, world) == (args.process_id, args.num_processes)
    if args.num_processes == 4:
        mesh = make_mesh(("data", "model"), shape=(2, 2))
        out = {"tp": _tp_run(mesh), "coords": [mesh.axis_index("data"),
                                               mesh.axis_index("model")]}
        with open(args.out, "w") as f:
            json.dump(out, f)
        return
    mesh = make_mesh(devices=None if distributed else ["cpu"])
    out = {"mesh": mesh.shape,
           "hybrid": make_hybrid_mesh(
               ("data", "sample"), ici_shape=(1, 1),
               dcn_shape=(args.num_processes, 1),
               devices=None if distributed else ["cpu"]).shape,
           "batches": [b.tolist() for b in per_process_batches(
               _dataset(), 8, mesh, num_iters=2, seed=9)],
           "forward": _forward_runs(mesh, 1),
           "accum": _forward_runs(mesh, 2),
           "reverse": _reverse_run(mesh),
           "sampler": _sampler_run(mesh),
           "bn_nsf": _bn_run(bn_nsf_model, mesh),
           "bn_flow": _bn_run(bn_flow_model, mesh)}
    if not distributed:
        out.update(tp_single=_tp_run(), bn_nsf_single=_bn_run(bn_nsf_model),
                   bn_flow_single=_bn_run(bn_flow_model))
    flag = ["--distributed"] if distributed else []
    out["binary"] = _binary(BINARY_2D + flag)
    out["binary_accum"] = _binary(BINARY_2D + ["--accum_steps", "2"] + flag)
    out["binary_glow"] = _binary(BINARY_GLOW + flag)
    if not distributed:
        out["binary_glow_accum"] = _binary(BINARY_GLOW + ["--accum_steps",
                                                          "2"])
    if distributed:
        out["binary_residual"] = _binary(BINARY_RESIDUAL + flag)
    with open(args.out, "w") as f:
        json.dump(out, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(tmp_path, num_processes, port, extra=(), tag="worker"):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    runs = []
    for pid in range(num_processes):
        out = tmp_path / f"{tag}{num_processes}_{pid}.json"
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               "--process-id", str(pid), "--num-processes",
               str(num_processes), "--port", str(port), "--out", str(out),
               *extra]
        runs.append((subprocess.Popen(cmd, cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     out))
    return runs


def _finish(runs, timeout=300):
    results = []
    for proc, out in runs:
        try:
            stdout, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p, _ in runs:
                p.kill()
            raise
        assert proc.returncode == 0, f"worker failed:\n{stdout[-4000:]}"
        with open(out) as f:
            results.append(json.load(f))
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_distributed")
    two = _start(tmp, 2, _free_port())
    one = _start(tmp, 1, _free_port())
    four = _start(tmp, 4, _free_port())
    return _finish(two), _finish(one)[0], _finish(four)


@pytest.fixture(scope="module")
def bn_stats(tmp_path_factory):
    """The batch statistics at mean 300 / std 0.01 on two ranks and on one
    process, and JAX's ``BatchNorm`` flow and batch-norm ``ResidualNet``
    (whose weights the workers load) on the whole batch, in float32."""
    import jax
    import jax.numpy as jnp

    import nf_tpu.flows as jflows
    from nf_tpu.nets.resnet import ResidualNet as JResidualNet
    from test_torch_autoregressive import perturb_jax
    from test_torch_batch_norm import bn_state_dict

    tmp = tmp_path_factory.mktemp("torch_bn_stats")
    jnet = perturb_jax(JResidualNet.create(
        jax.random.PRNGKey(BN_STATS_SEED), 2, 2, BN_STATS_HIDDEN,
        num_blocks=2, use_batch_norm=True), BN_STATS_SEED, scale=0.2)
    weights = tmp / "bn_stats_weights.npz"
    np.savez(weights, **bn_state_dict(jnet))
    extra = ("--bn-stats", str(weights))
    two = _start(tmp, 2, _free_port(), extra, "bn_stats")
    one = _start(tmp, 1, _free_port(), extra, "bn_stats")
    reference = {}
    for name, dtype in (("float32", np.float32), ("bfloat16", None)):
        x = bn_stats_data()
        if dtype is None:  # the bfloat16 data, in float32
            x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        z, log_det = jflows.BatchNorm().forward(jnp.asarray(x))
        reference[name] = {"x": x, "z": np.asarray(z),
                           "log_det": np.asarray(log_det),
                           "y": np.asarray(jnet(jnp.asarray(x)))}
    return _finish(two), _finish(one)[0], reference


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_statistics_are_two_pass_across_ranks(bn_stats, dtype):
    """At mean 300 and standard deviation 0.01 the variance over two ranks
    is the whole batch's, as JAX's ``jnp.var`` / ``jnp.std(ddof=1)`` take
    it. In float32: within 1e-4 relative of numpy's float64 variance and of
    one process's, the ``BatchNorm`` log-det finite and within 1e-4 of
    JAX's; the normalised values within 1e-2 of one process's and JAX's
    (float32 rounds x - mean by ~3e-5 at 300, against a deviation of
    0.01), the batch-norm ``ResidualNet``'s outputs and gradients within
    1e-3 of the largest (its hidden batch norms see the same cancellation,
    amplified by its weights; 1.3e-4 and 1.8e-4 measured). In bfloat16,
    where every datum rounds to 300 and the variance is 0, at the bfloat16
    bar, 0.05 abs plus 0.05 relative. A one-pass variance fails both: 0 or
    below in float32, and a count of 501 rounded to 500 in bfloat16."""
    multi, single, reference = bn_stats
    ref = reference[dtype]
    ranks = [r[dtype] for r in multi]
    assert ranks[0]["var"] == ranks[1]["var"]
    var64 = np.var(ref["x"].astype(np.float64), axis=0, ddof=1)
    f32 = dtype == "float32"
    tol = dict(rtol=1e-4, atol=0.0) if f32 else dict(rtol=0.05, atol=0.05)
    for got in (ranks[0]["var"], single[dtype]["var"]):
        np.testing.assert_allclose(np.asarray(got)[0], var64, **tol)
    for r in ranks + [single[dtype]]:
        assert np.all(np.isfinite(r["log_det"]))
        np.testing.assert_allclose(r["log_det"], ref["log_det"][:len(
            r["log_det"])], **tol)
    z = np.concatenate([r["z"] for r in ranks])
    y = np.concatenate([r["y"] for r in ranks])
    g = np.asarray(ranks[0]["grads"])
    g1 = np.asarray(single[dtype]["grads"])
    assert np.all(np.isfinite(g))

    def scaled(a, b):
        scale = max(float(np.max(np.abs(b))), 1.0)
        return np.asarray(a) / scale, np.asarray(b) / scale

    for want in (single[dtype]["z"], ref["z"]):
        np.testing.assert_allclose(z, want, **(dict(atol=1e-2) if f32
                                               else tol))
    for got, want in ((y, single[dtype]["y"]), (y, ref["y"]), (g, g1)):
        np.testing.assert_allclose(*scaled(got, want),
                                   **(dict(atol=1e-3) if f32 else tol))


def test_dp_by_tp_step_is_the_single_process_step(runs):
    """``__graft_entry__.dryrun_multichip``'s dp x tp step at world size 4
    on a (data 2, model 2) mesh: every rank ends with the whole
    parameters of the single-process step on the whole batch (1e-5), the
    same loss, and holds Adam's state for its blocks only."""
    _, single, four = runs
    want = single["tp_single"]
    assert sorted(tuple(r["coords"]) for r in four) == [(0, 0), (0, 1),
                                                        (1, 0), (1, 1)]
    for r in four:
        np.testing.assert_allclose(r["tp"]["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["tp"]["params"], want["params"],
                                   atol=1e-5, rtol=0)
        assert r["tp"]["opt_state"] < want["opt_state"] == want["full"]
    assert four[0]["tp"]["params"] == four[3]["tp"]["params"]


@pytest.mark.parametrize("kind", ["bn_nsf", "bn_flow"])
def test_batch_statistics_span_the_ranks(runs, kind):
    """A batch-norm ``build_nsf`` and a ``BatchNorm`` stack trained at
    world size 2, each rank on its half of the batch, equal the one
    process on the whole batch (1e-5): the layers' statistics are the
    global batch's. The ranks hold bitwise the same parameters."""
    multi, single, _ = runs
    assert multi[0][kind]["params"] == multi[1][kind]["params"]
    want = single[f"{kind}_single"]
    np.testing.assert_allclose(multi[0][kind]["loss"], want["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(multi[0][kind]["params"], want["params"],
                               atol=1e-5, rtol=0)
    # and the one process on a mesh of one is the mesh-less step
    assert single[kind]["params"] == want["params"]


def test_meshes_span_the_ranks(runs):
    multi, single, _ = runs
    for r in multi:
        assert r["mesh"] == {"data": 2}
        assert r["hybrid"] == {"data": 2, "sample": 1}
    assert single["mesh"] == {"data": 1}


def test_per_process_batches_make_the_same_global_batches(runs):
    multi, single, _ = runs
    for i in range(2):
        glued = np.concatenate([np.asarray(r["batches"][i]) for r in multi])
        np.testing.assert_array_equal(glued, np.asarray(single["batches"][i]))


@pytest.mark.parametrize("kind", ["forward", "accum", "binary",
                                  "binary_accum", "binary_glow"])
def test_two_processes_match_one(runs, kind):
    """Rank 0 and rank 1 hold bitwise the same parameters; the two
    processes land where one process lands (and the first loss, before
    any update, is the same global batch's)."""
    multi, single, _ = runs
    assert multi[0][kind]["param_hash"] == multi[1][kind]["param_hash"]
    np.testing.assert_allclose(multi[0][kind]["param_sum"],
                               single[kind]["param_sum"], rtol=1e-5)
    if "losses" in single[kind]:
        np.testing.assert_allclose(multi[0][kind]["losses"][0],
                                   single[kind]["losses"][0], rtol=1e-6)
        np.testing.assert_allclose(multi[0][kind]["losses"],
                                   single[kind]["losses"], rtol=1e-5)
    else:
        assert multi[0][kind]["final_step"] == STEPS
        assert single[kind]["final_step"] == STEPS


@pytest.mark.parametrize("kind,micro", [("forward", "accum"),
                                        ("binary", "binary_accum"),
                                        ("binary_glow", "binary_glow_accum")])
def test_two_processes_are_one_process_on_their_shards(runs, kind, micro):
    """Two ranks, each on its half of the global batch, hold element by
    element the parameters that one process reaches on the two halves as
    microbatches: the all-reduce averages the loss and the gradients as
    accumulation does, in the same order of additions. (Against the
    full batch, test_two_processes_match_one, the order differs, and Adam,
    dividing by the root of each gradient's square, moves elements whose
    gradient is near zero by up to ~1e-4 in five steps.)"""
    multi, single, _ = runs
    np.testing.assert_array_equal(multi[0][kind]["params"],
                                  single[micro]["params"])
    if "losses" in single[kind]:
        assert multi[0][kind]["losses"] == single[micro]["losses"]


def test_accumulation_is_the_full_batch_step(runs):
    _, single, _ = runs
    np.testing.assert_allclose(single["accum"]["param_sum"],
                               single["forward"]["param_sum"], rtol=1e-5)
    np.testing.assert_allclose(single["binary_accum"]["param_sum"],
                               single["binary"]["param_sum"], rtol=1e-5)


def test_keyed_residual_replicas_agree(runs):
    multi, _, _ = runs
    assert multi[0]["binary_residual"]["final_step"] == 2
    assert (multi[0]["binary_residual"]["param_hash"]
            == multi[1]["binary_residual"]["param_hash"])


def test_sample_parallel_step_is_one_step_on_the_pooled_draws(runs):
    """The ranks draw apart, and their averaged update is one process's
    update on their draws concatenated."""
    import nf_tpu_torch as nt

    multi, _, _ = runs
    d0, d1 = (np.asarray(r["reverse"]["draws"], np.float32) for r in multi)
    assert d0.shape == (REVERSE_SAMPLES // 2, 2)
    assert not np.allclose(d0, d1)
    assert multi[0]["reverse"]["params"] == multi[1]["reverse"]["params"]

    model = _nsf()
    pooled = torch.from_numpy(np.concatenate([d0, d1]))
    base = model.q0

    def fixed(num_samples, generator=None, context=None):
        assert num_samples == REVERSE_SAMPLES
        return pooled, base.log_prob(pooled)

    model.q0.forward = fixed
    opt = torch.optim.SGD(model.parameters(), lr=REV_LR)
    loss = nt.make_reverse_kld_step(opt, num_samples=REVERSE_SAMPLES)(
        nt.init_train_state(model, opt), torch.Generator())
    np.testing.assert_allclose(multi[0]["reverse"]["loss"], float(loss),
                               rtol=1e-5)
    np.testing.assert_allclose(multi[0]["reverse"]["params"],
                               _params(model).numpy(), rtol=1e-5, atol=1e-7)


def test_sharded_sampler_pools_the_ranks(runs):
    multi, _, _ = runs
    own = np.asarray([r["sampler"]["own"] for r in multi])
    for r in multi:
        np.testing.assert_allclose(r["sampler"]["pooled"], own.mean(0),
                                   rtol=1e-6)
        assert len(r["sampler"]["z"]) == SAMPLER_N // 2
    log_w = torch.tensor(sum((r["sampler"]["log_w"] for r in multi), []),
                         dtype=torch.float64)
    want = float(torch.logsumexp(log_w, 0) - np.log(SAMPLER_N))
    for r in multi:
        np.testing.assert_allclose(r["sampler"]["log_z"], want, rtol=1e-5)
    assert not np.allclose(multi[0]["sampler"]["z"], multi[1]["sampler"]["z"])


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--bn-stats", default=None)
    worker(parser.parse_args())
