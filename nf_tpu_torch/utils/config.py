"""The flag/config system of training scripts (``nf_tpu/utils/config.py``;
the reference's only CLI is argparse in one example). The port keeps its
own copy of the JAX package's dataclass, field for field, so one argv
gives the same config and the same JSON in both packages."""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    model: str = "realnvp"
    # realnvp | nsf | circular_nsf | maf | residual   (2D targets)
    # glow | image_nsf                                 (image stack)
    target: str = "two_modes"  # two_modes | two_moons | circular_gmm | rings
    # --- image-stack options (model = glow | image_nsf) ---
    data: Optional[str] = None  # .npz with x (N,C,H,W) uint8 [, y (N,)];
    # None = procedural class-structured images (nf_tpu_torch.data)
    levels: int = 2  # multi-scale levels L
    image_size: int = 32
    class_cond: bool = True
    scan: bool = True  # group the K blocks per level into one Scanned
    loss: str = "reverse_kld"  # reverse_kld | forward_kld
    dim: int = 2
    num_layers: int = 8
    hidden: int = 128
    num_bins: int = 8
    batch_size: int = 1024
    num_samples: int = 1024
    iters: int = 5000
    lr: float = 1e-3
    weight_decay: float = 0.0
    beta_anneal_iters: int = 0
    accum_steps: int = 1  # gradient accumulation (microbatching)
    ema_decay: float = 0.0  # >0 tracks an EMA of the params (eval weights)
    skip_nonfinite: bool = False  # discard updates with NaN/inf loss/grads
    distributed: bool = False  # multi-process run
    seed: int = 0
    bf16: bool = False
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1000
    log_path: Optional[str] = None
    log_every: int = 100

    @classmethod
    def from_args(cls, argv=None):
        parser = argparse.ArgumentParser()
        for f in dataclasses.fields(cls):
            # dispatch on the default's type (``from __future__ import
            # annotations`` makes f.type a string); bool before int, as
            # isinstance(True, int) holds
            if isinstance(f.default, bool):
                if f.default:
                    parser.add_argument(f"--no_{f.name}", dest=f.name,
                                        action="store_false")
                else:
                    parser.add_argument(f"--{f.name}", action="store_true")
            elif isinstance(f.default, (int, float, str)):
                parser.add_argument(f"--{f.name}", type=type(f.default),
                                    default=f.default)
            elif f.default is None:
                parser.add_argument(f"--{f.name}", type=str, default=None)
        args = parser.parse_args(argv)
        return cls(**vars(args))

    def to_json(self):
        return json.dumps(dataclasses.asdict(self), indent=2)
