"""How often the ``change_base_distribution`` and ``image`` recipes leave
float32, their batch drawn inside the captured step or fed before it.

    python tests/recipe_overflow_seeds.py [--device cpu] [--twins cb im]
        [--modes instep host] [--seeds 0 10] [--iters 100] [--save DIR]

For each twin, seed and mode it trains the twin's model at its defaults
(``examples_torch/change_base_distribution.py``: 8 affine couplings over
a Gaussian mixture, batch 512, Adam 3e-3; ``examples_torch/image.py``:
``build_realnvp`` K 16, hidden [64, 64], batch 512, Adam 1e-3) for
``--iters`` iterations through ``examples_torch._utils.train``:
``instep`` draws each batch inside the step (``_utils.target_draw``, as
``neural_spline_flow`` does), ``host`` feeds it before the step (what the
two twins do). Prints one line per run: the first iteration whose loss
is not finite (None: none). With ``--save DIR``, an in-step run that
leaves float32 is run again to that iteration, and its weights
(``compat_export.export_state_dict``) and the batch of that iteration go
to ``DIR/{twin}_seed{seed}_it{iteration}.npz``, with the rows where the
model's ``log_prob`` is not finite printed.
"""

import argparse
import contextlib
import io
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import nf_tpu_torch as nt  # noqa: E402
from examples_torch import _utils  # noqa: E402
from examples_torch import change_base_distribution as cb  # noqa: E402
from examples_torch import image as im  # noqa: E402
from nf_tpu_torch.compat_export import export_state_dict  # noqa: E402
from nf_tpu_torch.distributions import (  # noqa: E402
    GaussianMixture,
    ImagePrior,
)


def build(twin, seed, dev):
    """The twin's model, as its ``main()`` builds it."""
    if twin == "cb":
        q0 = GaussianMixture(n_modes=2, dim=2, loc=[[-1.0, 0.0], [1.0, 0.0]])
        return cb.build(q0, seed).to(dev)
    target = ImagePrior(im.procedural_image(), device=dev)
    return nt.build_realnvp(dim=2, K=16, hidden=[64, 64], target=target,
                            device=dev, seed=seed)


def run(twin, seed, mode, iters, dev):
    """Train ``iters`` iterations; returns the model, every loss and the
    in-step draw (None when host-fed)."""
    mod = cb if twin == "cb" else im
    args = mod.parser().parse_args(["--device", dev.type, "--iters",
                                    str(iters), "--seed", str(seed)])
    model = build(twin, seed, dev)
    draw = None
    if mode == "instep":
        draw = _utils.target_draw(model.p, args, dev)
        loss = _utils.ForwardKLD(draw=draw)
    else:
        loss = _utils.ForwardKLD(
            lambda gen, it: model.p.sample(args.num_samples, generator=gen))
    with contextlib.redirect_stdout(io.StringIO()):
        _, hist = _utils.train(model, loss, args)
    return model, hist.losses.cpu(), draw


def save(twin, seed, first, dev, out):
    """Run again to ``first``, then write the weights and that
    iteration's batch to ``out``."""
    model, losses, draw = run(twin, seed, "instep", first, dev)
    gen = torch.Generator(device=dev).manual_seed(
        _utils.keyed_seed(seed, first))
    x, full = draw(gen)
    with torch.no_grad():
        lp = model.log_prob(x).cpu().numpy()
    print(f"  run again to {first}: losses finite "
          f"{bool(torch.isfinite(losses).all())}, batch full {bool(full)}, "
          f"rows where log_prob is not finite "
          f"{np.nonzero(~np.isfinite(lp))[0].tolist()}", flush=True)
    state = {k: np.asarray(v) for k, v in export_state_dict(model).items()}
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, f"{twin}_seed{seed}_it{first}.npz"),
             batch=x.cpu().numpy(), **state)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--twins", nargs="+", default=["cb", "im"],
                   choices=["cb", "im"])
    p.add_argument("--modes", nargs="+", default=["instep", "host"],
                   choices=["instep", "host"])
    p.add_argument("--seeds", nargs=2, type=int, default=[0, 10],
                   metavar=("FIRST", "END"))
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--save", default=None)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    for twin in args.twins:
        for seed in range(*args.seeds):
            for mode in args.modes:
                _, losses, _ = run(twin, seed, mode, args.iters, dev)
                bad = (~torch.isfinite(losses)).nonzero().flatten()
                first = int(bad[0]) if len(bad) else None
                print(f"{twin} {mode} seed {seed}: first non-finite loss "
                      f"{first}; loss {float(losses[0]):.4f} -> "
                      f"{float(losses[-1]):.4f}", flush=True)
                if first is not None and mode == "instep" and args.save:
                    save(twin, seed, first, dev, args.save)


if __name__ == "__main__":
    main()
