"""Learn the 2D density given by an image's intensities with Real NVP
(reference ``examples/image.ipynb``: ImagePrior target, forward KLD on
rejection-sampled pixels), on ``nf_tpu_torch``. With no --image given, a
procedural smiley is used so the example runs with zero assets."""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import numpy as np

import nf_tpu_torch as nt
from nf_tpu_torch.distributions import ImagePrior

from examples_torch._utils import (
    ForwardKLD,
    base_parser,
    device_of,
    out_path,
    plot_density,
    train,
)


def procedural_image(size=128):
    """Smiley-face intensity grid (stand-in for the notebook's img.png)."""
    y, x = np.mgrid[-1:1:size * 1j, -1:1:size * 1j]
    face = np.exp(-((np.hypot(x, y) - 0.8) / 0.08) ** 2)
    eyes = (np.exp(-(((x + 0.35) ** 2 + (y + 0.3) ** 2) / 0.02))
            + np.exp(-(((x - 0.35) ** 2 + (y + 0.3) ** 2) / 0.02)))
    r = np.hypot(x, y - 0.15)
    mouth = np.exp(-((r - 0.45) / 0.06) ** 2) * (y > 0.25)
    return face + eyes + mouth


def parser():
    p = base_parser(__doc__, iters=2000, lr=1e-3, num_samples=512)
    p.add_argument("--image", type=str, default=None,
                   help="path to a grayscale image (defaults to procedural)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    if args.image:
        import matplotlib.pyplot as plt
        img = 1.0 - plt.imread(args.image)[:, :, 0]
    else:
        img = procedural_image()
    target = ImagePrior(img, device=dev)
    model = nt.build_realnvp(dim=2, K=16, hidden=[64, 64], target=target,
                             device=dev, seed=args.seed)

    def batch(gen, it):
        return model.p.sample(args.num_samples, generator=gen)

    model, hist = train(model, ForwardKLD(batch), args)
    if args.plot:
        plot_density(model.log_prob, out_path("image_model.png"), dev,
                     title="Real NVP fit of image density")
        plot_density(target.log_prob, out_path("image_target.png"), dev,
                     title="image target")
    return {"hist": hist}


if __name__ == "__main__":
    main()
