"""The port's infrastructure (``utils.logging``, ``utils.serialization``,
``utils.config``, ``utils.profiling``, ``utils.debug`` and ``data``)
against the JAX package where both compute the same thing, on the CPU.

The metrics match JAX's within 1e-6 relative; ``TrainConfig`` parses an
argv to the same fields and JSON; ``ArrayDataset`` yields the JAX
package's batches in the JAX package's order for a seed (both shuffle
with numpy's ``default_rng``); ``load_npz_images`` reads what the JAX
package reads. Checkpoints round-trip bitwise (bfloat16 through float32),
an interrupted write leaves the last complete step the latest, and a
restore copies into the tensors a captured step would hold.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu.data as jdata
import nf_tpu.utils as jutils
import nf_tpu_torch as nt
from nf_tpu_torch import data as tdata
from nf_tpu_torch import flows as tflows
from nf_tpu_torch import utils as tutils
from nf_tpu_torch.ops import _build
from nf_tpu_torch.parallel import data_sharding, make_mesh


def _model(dtype=torch.float32):
    model = nt.build_realnvp(dim=2, K=2, hidden=[8], device="cpu",
                             dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=gen).to(p.dtype))
    return model


# --- metrics and the logger --------------------------------------------------

def test_effective_sample_size_matches_jax():
    lw = np.random.default_rng(0).standard_normal(1000).astype(
        np.float32) * 3.0
    got = float(tutils.effective_sample_size(torch.from_numpy(lw)))
    want = float(jutils.effective_sample_size(jnp.asarray(lw)))
    assert abs(got - want) <= 1e-6 * want


def test_mcmc_acceptance_rate_matches_jax():
    rng = np.random.default_rng(1)
    before = rng.standard_normal((500, 2, 3)).astype(np.float32)
    after = before.copy()
    moved = rng.random(500) < 0.37
    after[moved, 1, 2] += 1.0
    got = tutils.mcmc_acceptance_rate(torch.from_numpy(before),
                                      torch.from_numpy(after))
    want = jutils.mcmc_acceptance_rate(jnp.asarray(before),
                                       jnp.asarray(after))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)
    assert abs(float(got) - moved.mean()) <= 1e-6


def test_metric_logger_writes_the_jax_records(tmp_path):
    """The same JSONL and CSV records as the JAX logger (the time field
    aside); a 0-d tensor is read when it is logged."""
    rows = []
    for logger_cls, name in ((tutils.MetricLogger, "port"),
                             (jutils.MetricLogger, "jax")):
        path = str(tmp_path / name / "log.jsonl")
        log = logger_cls(path, also_csv=True)
        log.log(1, loss=1.5, ess=np.float32(3.25))
        log.log(2, loss=0.5, note="x")
        log.close()
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        with open(os.path.splitext(path)[0] + ".csv") as f:
            csv_text = f.read().splitlines()
        rows.append(([{k: v for k, v in r.items() if k != "time"}
                      for r in recs], csv_text[0]))
    assert rows[0] == rows[1]
    log = tutils.MetricLogger(str(tmp_path / "t.jsonl"))
    rec = log.log(3, loss=torch.tensor(0.25))
    log.close()
    assert rec["loss"] == 0.25 and rec["step"] == 3


# --- save / load -------------------------------------------------------------

def test_save_load_round_trip(tmp_path):
    model = _model()
    path = str(tmp_path / "m.npz")
    tutils.save(path, model)
    fresh = nt.build_realnvp(dim=2, K=2, hidden=[8], device="cpu")
    assert tutils.load(path, fresh) is fresh
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), n
    with np.load(path) as data:
        assert sorted(data.files) == sorted(model.state_dict())


def test_load_casts_to_the_template_dtype(tmp_path):
    """bfloat16 is stored as float32 and cast back; a float32 file loads
    into a bfloat16 template as bfloat16."""
    bf = _model(torch.bfloat16)
    path = str(tmp_path / "bf.npz")
    tutils.save(path, bf)
    with np.load(path) as data:
        assert all(data[k].dtype != np.dtype("V2") for k in data.files)
        assert data["flows.0.s.net.0.weight"].dtype == np.float32
    back = tutils.load(path, nt.build_realnvp(dim=2, K=2, hidden=[8],
                                              device="cpu",
                                              dtype=torch.bfloat16))
    for (n, a), (_, b) in zip(bf.state_dict().items(),
                              back.state_dict().items()):
        assert b.dtype == a.dtype and torch.equal(a, b), n
    f32 = str(tmp_path / "f32.npz")
    tutils.save(f32, _model())
    cast = tutils.load(f32, nt.build_realnvp(dim=2, K=2, hidden=[8],
                                             device="cpu",
                                             dtype=torch.bfloat16))
    assert cast.flows[0].s.net[0].weight.dtype == torch.bfloat16


def test_load_checks_shapes(tmp_path):
    path = str(tmp_path / "m.npz")
    tutils.save(path, _model())
    wider = nt.build_realnvp(dim=2, K=2, hidden=[16], device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tutils.load(path, wider)


# --- CheckpointManager -------------------------------------------------------

def _state():
    model = _model()
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    return nt.init_train_state(model, opt, with_ema=True)


def _train(state, step, gen, n):
    return [float(step(state, gen)) for _ in range(n)]


def test_checkpoint_manager_keeps_restores_and_resumes(tmp_path):
    state = _state()
    step = nt.make_reverse_kld_step(state.optimizer, num_samples=64,
                                    ema_decay=0.9)
    gen = torch.Generator().manual_seed(0)
    manager = tutils.CheckpointManager(tmp_path / "ck", max_to_keep=2)
    assert manager.latest_step() is None
    assert manager.restore(state) == (None, None)
    for _ in range(3):
        _train(state, step, gen, 1)
        manager.save(state.step, state, generator=gen)
    assert manager.all_steps() == [2, 3] and manager.latest_step() == 3
    after = _train(state, step, gen, 2)
    params = [p.detach().clone() for p in state.model.parameters()]
    exp_avg = [v["exp_avg"].clone()
               for v in state.optimizer.state.values()]
    held = [v["exp_avg"] for v in state.optimizer.state.values()]
    _, at = manager.restore(state, generator=gen)
    assert at == 3 and state.step == 3
    # in place: the optimizer keeps its tensors (a captured step's)
    assert all(a is b for a, b in zip(
        held, [v["exp_avg"] for v in state.optimizer.state.values()]))
    assert _train(state, step, gen, 2) == after
    for p, q in zip(params, state.model.parameters()):
        assert torch.equal(p, q.detach())
    for a, v in zip(exp_avg, state.optimizer.state.values()):
        assert torch.equal(a, v["exp_avg"])
    # an earlier step, into a fresh state whose optimizer has no state yet
    fresh = _state()
    _, at = manager.restore(fresh, step=2)
    assert at == 2 and fresh.step == 2
    assert len(fresh.optimizer.state) == len(state.optimizer.state)


def test_checkpoint_write_cut_leaves_the_last_good_step(tmp_path,
                                                        monkeypatch):
    state = _state()
    manager = tutils.CheckpointManager(tmp_path, max_to_keep=3)
    manager.save(1, state)

    def cut(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", cut)
    with pytest.raises(OSError):
        manager.save(2, state)
    monkeypatch.undo()
    assert manager.latest_step() == 1
    assert any(n.startswith(".tmp_") for n in os.listdir(tmp_path))
    again = tutils.CheckpointManager(tmp_path)
    assert not any(n.startswith(".tmp_") for n in os.listdir(tmp_path))
    assert again.restore(_state())[1] == 1
    with pytest.raises(ValueError, match="generator"):
        again.restore(_state(), generator=torch.Generator())


# --- TrainConfig -------------------------------------------------------------

@pytest.mark.parametrize("argv", [[], ["--model", "nsf", "--lr", "3e-4",
                                       "--no_scan", "--bf16",
                                       "--checkpoint_dir", "ck",
                                       "--iters", "7"]])
def test_train_config_matches_jax(argv):
    got = tutils.TrainConfig.from_args(argv)
    want = jutils.TrainConfig.from_args(argv)
    assert got.to_json() == want.to_json()
    assert [f for f in vars(got)] == [f for f in vars(want)]


# --- profiling ---------------------------------------------------------------

def test_named_is_transparent():
    model = _model()
    named = nt.NormalizingFlow(model.q0, [
        tutils.Named(f, f"layer_{i}") for i, f in enumerate(model.flows)],
        p=model.p)
    x = torch.randn(64, 2, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(named.log_prob(x), model.log_prob(x))
        a = named.sample(64, generator=torch.Generator().manual_seed(2))
        b = model.sample(64, generator=torch.Generator().manual_seed(2))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    named.init_from_data(x)
    assert isinstance(named.flows[1], tutils.Named)
    assert isinstance(named.flows[1].flow, tflows.ActNorm)


def test_trace_writes_a_chrome_trace_with_the_named_ranges(tmp_path):
    model = _model()
    named = tutils.Named(model.flows[0], "coupling_0")
    x = torch.randn(32, 2)
    with tutils.trace(str(tmp_path)) as prof:
        named.forward(x)
        named.inverse(x)
    keys = {e.key for e in prof.key_averages()}
    assert {"coupling_0", "coupling_0_inv"} <= keys
    with open(tmp_path / "trace.json") as f:
        assert "coupling_0_inv" in f.read()


def test_throughput_counts_items_per_second():
    rate = tutils.throughput(lambda x: x * 1.0001, torch.ones(1000),
                             iters=5, items_per_call=1000)
    assert rate > 0


def test_enable_compilation_cache_moves_the_build_dir(tmp_path):
    before = _build.BUILD_DIR
    try:
        tutils.enable_compilation_cache(str(tmp_path / "kernels"))
        assert _build.BUILD_DIR == str(tmp_path / "kernels")
        assert _build._lib_path("rqs_fwd").startswith(str(tmp_path))
    finally:
        _build.set_build_dir(before)


# --- debug -------------------------------------------------------------------

def test_checked_names_the_first_non_finite_output():
    fn = tutils.checked(lambda x: (x * 2, {"lp": torch.log(x)}))
    value, err = fn(torch.tensor([1.0, 2.0]))
    assert err.get() is None
    err.throw()
    assert torch.equal(value[0], torch.tensor([2.0, 4.0]))
    _, err = fn(torch.tensor([1.0, -1.0]))
    with pytest.raises(FloatingPointError, match=r"output\[1\]\['lp'\]"):
        err.throw()


def test_debug_nans_toggles_anomaly_detection_and_restores_it():
    assert not torch.is_anomaly_enabled()
    with tutils.debug_nans():
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).backward()
        with tutils.debug_nans(False):
            assert not torch.is_anomaly_enabled()
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()


# --- data --------------------------------------------------------------------

@pytest.mark.parametrize("drop_last", [True, False])
def test_array_dataset_order_matches_jax(drop_last):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((103, 3)).astype(np.float32)
    y = np.arange(103)
    kw = dict(batch_size=16, seed=7, drop_last=drop_last)
    got = list(tdata.ArrayDataset(x, y, **kw).epochs(2))
    want = list(jdata.ArrayDataset(x, y, **kw).epochs(2))
    assert len(got) == len(want) == 2 * (6 if drop_last else 7)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    one = tdata.ArrayDataset(x, batch_size=16, shuffle=False,
                             transform=lambda b: (b[0] * 2,))
    np.testing.assert_array_equal(next(iter(one)), x[:16] * 2)
    with pytest.raises(ValueError, match="0 batches"):
        next(tdata.ArrayDataset(x[:3], batch_size=16).epochs())


def test_prefetch_to_device_on_the_cpu_keeps_order_and_count():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.arange(20)
    ds = tdata.ArrayDataset(x, y, batch_size=4, seed=3)
    want = list(tdata.ArrayDataset(x, y, batch_size=4, seed=3))
    got = list(tdata.prefetch_to_device(iter(ds), size=2, device="cpu"))
    assert len(got) == len(want) == 5
    for (gx, gy), (wx, wy) in zip(got, want):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        np.testing.assert_array_equal(gx.numpy(), wx)
        np.testing.assert_array_equal(gy.numpy(), wy)


def test_prefetch_to_device_propagates_errors_and_stops_its_worker():
    def broken():
        yield np.zeros(2)
        raise KeyError("source")

    it = tdata.prefetch_to_device(broken(), device="cpu")
    next(it)
    with pytest.raises(KeyError, match="source"):
        next(it)
    endless = tdata.prefetch_to_device(
        (np.full(2, i) for i in range(10 ** 9)), size=1, device="cpu")
    assert float(next(endless)[0]) == 0.0
    endless.close()
    # a sharding places the batch on its mesh's device, no other
    mesh = make_mesh(devices=["cpu"])
    with pytest.raises(ValueError, match="mesh's device"):
        next(tdata.prefetch_to_device(iter([]),
                                      sharding=data_sharding(mesh, 1),
                                      device="meta"))
    with pytest.raises(ValueError):
        next(tdata.prefetch_to_device(iter([]), size=0, device="cpu"))


def test_prefetch_to_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(tdata.prefetch_to_device(iter([np.zeros(2)])))


def test_load_npz_images_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "img.npz")
    np.savez(path, x=rng.integers(0, 256, (5, 3, 4, 4), dtype=np.uint8),
             y=np.arange(5))
    gx, gy = tdata.load_npz_images(path)
    wx, wy = jdata.load_npz_images(path)
    assert gx.dtype == np.float32 and float(gx.max()) < 1.0
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    only_x = tdata.load_npz_images(path, keys=("x",), to_unit_interval=False)
    assert only_x.dtype == np.uint8
    with pytest.raises(ValueError, match="none of"):
        tdata.load_npz_images(path, keys=("z",))
