"""The bar for ``examples_torch/neural_spline_flow.py``'s full recipe
(2000 iterations of ``build_nsf(dim=2, K=4, hidden=64, num_bins=8)`` at
batch 512, Adam 3e-3, forward KLD on TwoMoons), measured on the CPU.

    JAX_PLATFORMS=cpu python tests/recipe_bar_nsf.py [--seeds 0 1 2]

For each seed it runs the JAX example (``examples/neural_spline_flow.py``,
its ``main()`` with ``--log-every 1`` so that every iteration's loss is
read) and the twin (``examples_torch.neural_spline_flow.main`` with
``--device cpu``), and takes each run's final loss: the mean of its last
100 iterations' losses. The bar is the JAX example's mean over the seeds
plus or minus three times the larger seed-to-seed spread (max - min over
the seeds) of the JAX example and the twin. Prints one JSON line.
``chip_smoke.py`` holds the twin's full recipe on the card to this bar
(``NSF_RECIPE_BAR``).
"""

import argparse
import contextlib
import importlib
import io
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAST = 100


def jax_final_loss(seed):
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        mod = importlib.import_module("neural_spline_flow")
    finally:
        sys.path.pop(0)
    runs = []
    train = mod.train

    def recording(*args, **kwargs):
        runs.append(train(*args, **kwargs))
        return runs[-1]

    mod.train = recording
    sys.argv = ["neural_spline_flow.py", "--seed", str(seed),
                "--log-every", "1"]
    with contextlib.redirect_stdout(io.StringIO()):
        mod.main()
    hist = runs[-1][1]
    return float(np.mean([loss for _, loss in hist[-LAST:]]))


def twin_final_loss(seed):
    sys.path.insert(0, ROOT)
    from examples_torch import neural_spline_flow

    with contextlib.redirect_stdout(io.StringIO()):
        out = neural_spline_flow.main(["--device", "cpu", "--seed",
                                       str(seed)])
    return out["hist"].final_loss(LAST)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    args = p.parse_args()
    out = {"jax": {}, "twin": {}, "seconds": {}}
    for name, fn in (("jax", jax_final_loss), ("twin", twin_final_loss)):
        t0 = time.time()
        for s in args.seeds:
            out[name][s] = fn(s)
        out["seconds"][name] = time.time() - t0
    jax_losses = np.array(list(out["jax"].values()))
    twin_losses = np.array(list(out["twin"].values()))
    spread = max(np.ptp(jax_losses), np.ptp(twin_losses))
    mean = float(jax_losses.mean())
    out.update(jax_mean=mean, twin_mean=float(twin_losses.mean()),
               spread_jax=float(np.ptp(jax_losses)),
               spread_twin=float(np.ptp(twin_losses)),
               bar=[mean - 3 * spread, mean + 3 * spread])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
