"""The port's ``compat.import_state_dict`` (``strict``) and its ``.npz``
helpers against the JAX package's, on the CPU: a JAX ``build_nsf``'s
export written by each side's ``save_state_dict_npz`` and read by the
other's ``load_state_dict_npz`` gives the same arrays, bitwise, and the
port model loaded from either file is the one loaded from the dict."""

import jax
import numpy as np
import pytest
import torch

import nf_tpu.compat as jcompat
import nf_tpu.models as jmodels
import nf_tpu_torch as nt
from nf_tpu.compat_export import export_state_dict
from nf_tpu_torch import compat as tcompat

KW = dict(dim=2, K=2, hidden=8, num_bins=4)


def _pair():
    jmodel = jmodels.build_nsf(jax.random.PRNGKey(40), **KW)
    sd = {k: np.asarray(v) for k, v in export_state_dict(jmodel).items()}
    return jmodel, sd


def test_import_state_dict_strict():
    _, sd = _pair()
    model = nt.build_nsf(device="cpu", seed=1, **KW)
    assert tcompat.import_state_dict(model, sd) is model
    extra = dict(sd, **{"no.such.key": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="unused"):
        tcompat.import_state_dict(nt.build_nsf(device="cpu", **KW), extra)
    loaded = tcompat.import_state_dict(nt.build_nsf(device="cpu", **KW),
                                       extra, strict=False)
    for a, b in zip(loaded.state_dict().values(),
                    model.state_dict().values()):
        assert torch.equal(a, b)
    missing = {k: v for k, v in sd.items() if k != sorted(sd)[0]}
    for strict in (True, False):
        with pytest.raises(KeyError, match="missing"):
            tcompat.import_state_dict(nt.build_nsf(device="cpu", **KW),
                                      missing, strict=strict)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_round_trip_between_the_packages(tmp_path, writer):
    _, sd = _pair()
    path = str(tmp_path / "weights.npz")
    (jcompat if writer == "jax" else tcompat).save_state_dict_npz(sd, path)
    for reader in (jcompat, tcompat):
        got = reader.load_state_dict_npz(path)
        assert sorted(got) == sorted(sd)
        for k in sd:
            np.testing.assert_array_equal(got[k], sd[k])
    want = tcompat.import_state_dict(nt.build_nsf(device="cpu", **KW), sd)
    got = tcompat.import_state_dict(nt.build_nsf(device="cpu", **KW),
                                    tcompat.load_state_dict_npz(path))
    for a, b in zip(got.state_dict().values(), want.state_dict().values()):
        assert torch.equal(a, b)


def test_port_state_dict_npz_feeds_the_jax_importer(tmp_path):
    """A port model's own state dict (tensors) through the port's writer
    and JAX's reader into JAX's ``import_state_dict``: the JAX model's
    log-density is the port's (1e-4)."""
    jmodel, sd = _pair()
    tmodel = tcompat.import_state_dict(nt.build_nsf(device="cpu", **KW), sd)
    with torch.no_grad():
        for p in tmodel.parameters():
            p.add_(0.05)
    path = str(tmp_path / "port.npz")
    tcompat.save_state_dict_npz(
        {k: v for k, v in nt.compat_export.export_state_dict(tmodel).items()},
        path)
    jloaded = jcompat.import_state_dict(jmodel,
                                        jcompat.load_state_dict_npz(path))
    x = np.random.default_rng(41).standard_normal((16, 2)).astype(np.float32)
    want = tmodel.log_prob(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(np.asarray(jloaded.log_prob(x)), want,
                               atol=1e-4)
