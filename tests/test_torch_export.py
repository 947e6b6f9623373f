"""The port's deployment surface (``nf_tpu_torch.serving``: the artifacts of
``export_log_prob`` / ``export_sampler``, ``load_exported``, and
``CompiledFn.cost_analysis`` / ``flops`` / ``memory_analysis``) and the
kernels' ``torch.library`` ops, on the CPU.

A small ``build_nsf`` (K = 2, hidden 16, 4 bins) carries the same perturbed
weights in both frameworks (``test_torch_serving._pair``); the reloaded
port artifact is held against the reloaded JAX artifact within 1e-4 abs
(the port's bar for a whole model), frozen and with a refreshed weight
list. The reloaded sampler is held bitwise against ``compile_sampler`` and
the eager ``model.sample`` at one seed, and its ``log_q`` against
``log_prob`` of its samples within 1e-4. The class-conditional Glow of
``test_torch_glow`` is held against JAX's export within 1e-4 after
dividing by ``max(|log p|, 1)``. Each op's CPU implementation goes through
``torch.library.opcheck`` (schema, fake implementation, autograd
registration), and the ops' values on the CPU are the plain versions'.
The card's side (the artifact's A and B nodes, the graph of a reloaded
program, moving a card artifact to the CPU) is ``chip_smoke.py``'s phase
27 and ``tests/test_torch_cuda.py``.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import nf_tpu.serving as jserving
import nf_tpu_torch as nt
from nf_tpu.compat import import_state_dict
from nf_tpu.utils.module import partition
from nf_tpu_torch import ops, serving
from nf_tpu_torch.ops import cost
from nf_tpu_torch.ops import spline_head_fused as shf
from nf_tpu_torch.ops import splines_kernel as tk
from test_torch_serving import SMALL, _close, _inputs, _pair, \
    _perturbed_state_dict

N = 16
TOL = 1e-4


def _refreshed(seed=0):
    """(JAX model, port model) with the weights of ``_pair(seed)`` moved by
    another draw of noise: the refreshed weights of a deployment."""
    jmodel, _ = _pair(seed)
    sd = _perturbed_state_dict(jmodel, seed + 100, scale=0.05)
    return (import_state_dict(jmodel, sd),
            nt.load_reference_state_dict(nt.build_nsf(device="cpu", **SMALL),
                                         sd))


def test_export_log_prob_frozen_matches_jax():
    jmodel, tmodel = _pair()
    x = _inputs(N, seed=21)
    jfn = jserving.load_exported(jserving.export_log_prob(jmodel, (N, 2)))
    blob = serving.export_log_prob(tmodel, (N, 2))
    assert isinstance(blob, bytes) and blob
    fn = serving.load_exported(blob)
    got = fn(torch.from_numpy(x))
    assert got.shape == (N,) and got.dtype == torch.float32
    _close(got, jfn(jnp.asarray(x)))
    with torch.no_grad():
        assert torch.equal(got, tmodel.log_prob(torch.from_numpy(x)))
    assert fn.platforms == ("cpu",)
    assert fn.in_avals == [serving.TensorSpec((N, 2), torch.float32)]


def test_export_log_prob_takes_refreshed_weights_as_jax_does(tmp_path):
    """``freeze_params=False``: one artifact, the weights a leading flat
    list (``serving._tensors``' order, JAX's ``tree_leaves``): the model's
    own weights, then refreshed ones, against JAX's artifact with its
    leaves and a model holding the refreshed weights. Reloaded from a
    file."""
    jmodel, tmodel = _pair()
    j2, t2 = _refreshed()
    x = _inputs(N, seed=22)
    path = tmp_path / "log_prob.pt2"
    path.write_bytes(serving.export_log_prob(tmodel, (N, 2),
                                             freeze_params=False))
    fn = serving.load_exported(str(path))
    jfn = jserving.load_exported(jserving.export_log_prob(
        jmodel, (N, 2), freeze_params=False))
    for j, tm in ((jmodel, tmodel), (j2, t2)):
        weights = [w.detach() for w in serving._tensors(tm).values()]
        got = fn(weights, torch.from_numpy(x))
        leaves = jax.tree_util.tree_leaves(partition(j)[0])
        _close(got, jfn(leaves, jnp.asarray(x)))
        with torch.no_grad():
            _close(got, tm.log_prob(torch.from_numpy(x)), 1e-5)
    assert len(fn.in_avals) == len(weights) + 1
    with pytest.raises(TypeError, match="tensors"):
        fn(torch.from_numpy(x))


def test_exported_sampler_is_the_compiled_and_the_eager_sampler():
    _, tmodel = _pair()
    fn = serving.load_exported(serving.export_sampler(tmodel, 64))
    compiled = nt.compile_sampler(tmodel, 64)
    for seed in (3, 11, 3):
        z, log_q = fn(seed)
        zc, lqc = compiled(seed)
        with torch.no_grad():
            ze, lqe = tmodel.sample(
                64, generator=torch.Generator().manual_seed(seed))
        assert torch.equal(z, zc) and torch.equal(log_q, lqc)
        assert torch.equal(z, ze) and torch.equal(log_q, lqe)
        with torch.no_grad():
            _close(tmodel.log_prob(z), log_q)
    with pytest.raises(TypeError, match="integer seed"):
        fn(torch.Generator())


def test_exported_sampler_leaves_the_callers_generator_alone():
    """The artifact draws from the default generator in a forked state:
    the caller's stream goes on as if the call had not drawn."""
    _, tmodel = _pair()
    fn = serving.load_exported(serving.export_sampler(tmodel, 8))
    torch.manual_seed(5)
    want = torch.rand(3)
    torch.manual_seed(5)
    fn(1)
    assert torch.equal(torch.rand(3), want)


def test_exported_sampler_with_refreshed_weights():
    _, tmodel = _pair()
    _, t2 = _refreshed()
    fn = serving.load_exported(serving.export_sampler(
        tmodel, 32, freeze_params=False))
    for tm in (tmodel, t2):
        weights = [w.detach() for w in serving._tensors(tm).values()]
        z, log_q = fn(7, weights)
        zc, lqc = nt.compile_sampler(tm, 32)(7)
        assert torch.equal(z, zc) and torch.equal(log_q, lqc)


def _glow_pair():
    from test_torch_glow import _pair as glow_pair

    jmodel, tmodel, _ = glow_pair()
    return jmodel, tmodel


def test_class_conditional_export_matches_jax():
    """As ``tests/test_serving.py:239``: a class-conditional Glow exported
    with labels. ``log_prob(x, y)`` against JAX's artifact; the tempered
    sampler with labels against the compiled sampler, bitwise, and its
    ``log_q`` against the tempered model's ``log_prob``."""
    from test_torch_image import labels, pixels, rel_close

    jmodel, tmodel = _glow_pair()
    x, y = pixels(8, seed=31), labels(seed=32)[:8]
    shape = (8,) + tuple(x.shape[1:])
    jfn = jserving.load_exported(jserving.export_log_prob(
        jmodel, shape, class_cond=True))
    fn = serving.load_exported(serving.export_log_prob(
        tmodel, shape, class_cond=True))
    got = fn(torch.from_numpy(x), torch.from_numpy(y).long())
    rel_close(got, jfn(jnp.asarray(x), jnp.asarray(y, jnp.int32)))
    sampler = serving.load_exported(serving.export_sampler(
        tmodel, 8, class_cond=True, temperature=0.7))
    yt = torch.from_numpy(y).long()
    z, log_q = sampler(4, yt)
    zc, lqc = nt.compile_sampler(tmodel, 8, class_cond=True,
                                 temperature=0.7)(4, yt)
    assert torch.equal(z, zc) and torch.equal(log_q, lqc)
    assert torch.isfinite(log_q).all()


def test_platforms_name_where_an_artifact_runs():
    """A CPU artifact may run on the CPU only: ``platforms`` naming the
    card is refused at export (a CPU trace holds the CPU's path), and a
    reload elsewhere than the platforms raises."""
    _, tmodel = _pair()
    with pytest.raises(ValueError, match="card"):
        serving.export_log_prob(tmodel, (4, 2), platforms=("cuda", "cpu"))
    with pytest.raises(ValueError, match="unknown platforms"):
        serving.export_log_prob(tmodel, (4, 2), platforms=("tpu",))
    fn = serving.load_exported(serving.export_log_prob(
        tmodel, (4, 2), platforms=("cpu",)))
    assert fn.platforms == ("cpu",)
    with pytest.raises(ValueError, match="shape"):
        fn(torch.zeros(3, 2))


def test_reload_needs_no_model_code(tmp_path):
    """A fresh interpreter reloads the artifact with every builder and the
    flow container's constructor made to raise: the artifact pickles no
    model, only the op library (imported with ``nf_tpu_torch.serving``)
    is needed."""
    _, tmodel = _pair()
    x = torch.from_numpy(_inputs(N, seed=23))
    (tmp_path / "a.pt2").write_bytes(serving.export_log_prob(tmodel,
                                                             (N, 2)))
    torch.save(x, tmp_path / "x.pt")
    script = (
        "import sys, torch\n"
        "import nf_tpu_torch.serving as s\n"
        "import nf_tpu_torch.models.builders as b\n"
        "import nf_tpu_torch.core as c\n"
        "def no(*a, **k): raise AssertionError('model code ran')\n"
        "for n in dir(b):\n"
        "    if n.startswith('build_'): setattr(b, n, no)\n"
        "c.NormalizingFlow.__init__ = no\n"
        "fn = s.load_exported(sys.argv[1])\n"
        "torch.save(fn(torch.load(sys.argv[2])), sys.argv[3])\n")
    out = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path / "a.pt2"),
         str(tmp_path / "x.pt"), str(tmp_path / "y.pt")],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    with torch.no_grad():
        assert torch.equal(torch.load(tmp_path / "y.pt"), tmodel.log_prob(x))


def test_an_export_through_the_ops_holds_their_nodes():
    """Inside ``ops.cpu_through_ops`` the CPU model takes the kernels' ops
    as the card does: the artifact holds one ``rqs_fwd`` node per half of
    each coupling (the identity half's CDF, and the transformed half below
    the fused-head gate) and reloads to the plain path's values."""
    _, tmodel = _pair()
    x = torch.from_numpy(_inputs(N, seed=24))
    with ops.cpu_through_ops():
        blob = serving.export_log_prob(tmodel, (N, 2))
        with torch.no_grad():
            want = tmodel.log_prob(x)
    fn = serving.load_exported(blob)
    assert fn.kernel_nodes() == {"rqs_fwd": 2 * SMALL["K"]}
    _close(fn(x), want, 1e-5)
    assert not tk._CPU_THROUGH_OPS[0]


class _OpCalls(TorchDispatchMode):
    """The kernels' op calls of a run, with their arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name().split("::")
        if name[0] == "nf_tpu_torch":
            self.calls.append((name[1].split(".")[0], args))
        return func(*args, **(kwargs or {}))


def _linear_flops(rows):
    """Hand count of the products of one ``log_prob`` of a dim-2
    ``build_nsf``: each coupling's trunk (initial 1 -> H, 2 blocks of two
    H x H, head H -> 3K-1 for K bins), 2 flops per multiply-add, and each
    ``LULinearPermute``'s two 2 x 2 products (its lower and upper
    factors)."""
    H, K = SMALL["hidden"], SMALL["num_bins"]
    trunk = 1 * H + 2 * 2 * H * H + H * (3 * K - 1)
    return SMALL["K"] * 2 * rows * (trunk + 2 * 2 * 2)


def test_flops_are_the_products_plus_the_kernels_formulas():
    """``flops()`` counts ``FlopCounterMode``'s products (by hand here)
    and each kernel op by ``ops.cost``: 2 K ``rqs_fwd`` calls, the CDF of
    each identity half (x (rows, 1), parameters shared by the rows) and
    each transformed half (the bin-major feed, x (1, rows)), both on
    kernel A's shared-parameter count (work per column, then per
    element)."""
    _, tmodel = _pair()
    fn = nt.compile_log_prob(tmodel, (N, 2))
    calls = _OpCalls()
    with torch.no_grad(), ops.cpu_through_ops(), calls:
        tmodel.log_prob(torch.zeros(N, 2))
    assert [c[0] for c in calls.calls] == ["rqs_fwd"] * 2 * SMALL["K"]
    K = SMALL["num_bins"]
    kernel = [cost.rqs_fwd(*args) for _, args in calls.calls]
    for (_, args), (n_ops, _) in zip(calls.calls, kernel):
        x, inverse = args[0], args[6]
        assert n_ops == tk.rqs_shared_ops(K, inverse, x.shape[-1], N)
    want = _linear_flops(N) + sum(n for n, _ in kernel)
    analysis = fn.cost_analysis()
    assert fn.flops() == analysis["flops"] == want
    assert analysis["bytes accessed"] > sum(b for _, b in kernel)
    assert nt.compile_sampler(tmodel, N).flops() > 0


def test_memory_analysis_counts_inputs_weights_and_outputs():
    _, tmodel = _pair()
    fn = nt.compile_log_prob(tmodel, (N, 2))
    stats = fn.memory_analysis()
    weights = sum(t.numel() * t.element_size()
                  for t in serving._tensors(tmodel).values())
    assert stats.argument_size_in_bytes == N * 2 * 4 + weights
    assert stats.output_size_in_bytes == N * 4
    assert stats.temp_size_in_bytes is None  # no graph on the CPU
    assert stats.generated_code_size_in_bytes is None


# --- the ops -------------------------------------------------------------------

def _spline_args(rng, rows, cols, K, grad):
    def draw(*shape, scale=1.0):
        t = torch.from_numpy((rng.standard_normal(shape) * scale)
                             .astype(np.float32))
        return t.requires_grad_(grad)
    return (draw(rows, cols, scale=1.5), draw(K, 1, cols, scale=0.5),
            draw(K, 1, cols, scale=0.5), draw(K + 1, 1, cols, scale=0.5))


def _op_cases():
    rng = np.random.default_rng(7)
    K, rows, cols = 4, 6, 3
    minima = (1e-3, 1e-3, 1e-3)
    x, w, h, d = _spline_args(rng, rows, cols, K, True)
    tb = torch.full((rows, cols), 2.0)
    plain = [t.detach() for t in (x, w, h, d)]
    cts = [torch.from_numpy(rng.standard_normal((rows, cols))
                            .astype(np.float32)) for _ in range(2)]
    D, B, H = 2, 5, 4
    m = (3 * K - 1) * D
    x_t = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).T
    h_t = torch.from_numpy(rng.standard_normal((H, B)).astype(np.float32))
    hw = torch.from_numpy((rng.standard_normal((m, H)) * 0.3)
                          .astype(np.float32))
    hb = torch.from_numpy((rng.standard_normal(m) * 0.1).astype(np.float32))
    htb = torch.full((D,), 3.0)
    head = [t.clone().requires_grad_() for t in (x_t, h_t, hw, hb)]
    hct = [torch.from_numpy(rng.standard_normal((D, B)).astype(np.float32))
           for _ in range(2)]
    return {
        "rqs_fwd": (x, w, h, d, None, 2.0, False) + minima,
        "rqs_fwd_tensor_tb": (x, w, h, d, tb, 0.0, True) + minima,
        "rqs_bwd": (*plain, None, 2.0, *cts, False) + minima,
        "rqs_bwd_shared": (*plain, None, 2.0, *cts, True) + minima,
        "rqs_bwd_autodiff": (*plain, None, 2.0, *cts, True) + minima,
        "head_rqs_fwd": (*head, htb, K, False, False) + minima,
        "head_rqs_bwd": (x_t, h_t, hw, hb, htb, K, False, *hct,
                         True) + minima,
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_opcheck(case):
    """Schema, fake implementation, autograd registration (and, for the two
    forward ops, their backward under AOT autograd) of each op on the
    CPU."""
    args = _op_cases()[case]
    name = case.replace("_tensor_tb", "")
    result = torch.library.opcheck(
        getattr(torch.ops.nf_tpu_torch, name).default, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_ops_compute_the_plain_versions_and_their_gradients():
    """On the CPU ``rqs_fwd`` and ``head_rqs_fwd`` are the plain versions,
    bitwise, and their registered backward (the ops of kernels C and E,
    whose CPU implementations are ``rqs_bwd_plain`` / ``head_rqs_bwd_plain``)
    gives autograd's gradients of the plain versions within 1e-5 relative;
    the backward refuses a second differentiation."""
    cases = _op_cases()
    x, w, h, d, *_ = cases["rqs_fwd"]
    y, ld = torch.ops.nf_tpu_torch.rqs_fwd(*cases["rqs_fwd"])
    yp, ldp = tk.rqs_plain(x, w, h, d, 2.0, inverse=False)
    assert torch.equal(y, yp) and torch.equal(ld, ldp)
    cty, ctl = torch.randn_like(y), torch.randn_like(y)
    got = torch.autograd.grad((y * cty).sum() + (ld * ctl).sum(),
                              (x, w, h, d))
    want = torch.autograd.grad((yp * cty).sum() + (ldp * ctl).sum(),
                               (x, w, h, d))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1.0)
    head = cases["head_rqs_fwd"]
    y, ld = torch.ops.nf_tpu_torch.head_rqs_fwd(*head)
    kw = dict(num_bins=4, tails="linear", inverse=False)
    yp, ldp = shf.head_rqs_plain(*head[:5], **kw)
    assert torch.equal(y, yp) and torch.equal(ld, ldp)
    got = torch.autograd.grad(y.sum() + ld.sum(), head[:4], create_graph=True)
    want = torch.autograd.grad(yp.sum() + ldp.sum(), head[:4])
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1.0)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(got[0].sum(), head[0])


def test_backward_mode_is_read_at_the_forward_call():
    """C or D follows ``set_pallas_bwd_kernel`` as it stood when the
    forward ran (the per-element path, a parameter per element): on the
    CPU the two ops give the analytic and the autodiff plain versions."""
    rng = np.random.default_rng(9)
    x, w, h, d = _spline_args(rng, 5, 70, 4, False)
    full = [t.expand(t.shape[0], 5, 70).clone().requires_grad_()
            for t in (w, h, d)]
    outs = {}
    for mode in ("analytic", "autodiff"):
        tk.set_pallas_bwd_kernel(mode)
        try:
            y, ld = torch.ops.nf_tpu_torch.rqs_fwd(
                x, *full, None, 3.0, False, 1e-3, 1e-3, 1e-3)
        finally:
            tk.set_pallas_bwd_kernel("analytic" if mode == "autodiff"
                                     else "autodiff")
        outs[mode] = torch.autograd.grad(y.sum() + ld.sum(), full)
    tk.set_pallas_bwd_kernel("analytic")
    ct = torch.ones(5, 70)
    want_c = tk.rqs_bwd_plain(x, *[t.detach() for t in full], 3.0, ct, ct,
                              inverse=False)[1:]
    want_d = tk.rqs_vjp_plain(x, *[t.detach() for t in full], 3.0, ct, ct,
                              inverse=False)[1:]
    for got, want in ((outs["analytic"], want_c), (outs["autodiff"],
                                                    want_d)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
