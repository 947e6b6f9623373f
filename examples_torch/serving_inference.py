"""Production-style inference: train briefly, then serve with compiled
functions (nf_tpu_torch.serving) fed by the input pipeline
(nf_tpu_torch.data).

    python examples_torch/serving_inference.py [--iters 300]

The serving path captures `sample` and `log_prob` once for fixed batch
shapes as CUDA graphs; parameter updates rebind without recapturing
(`with_model`), and the cost analysis reports FLOPs per call for roofline
accounting. At --serve-batch 4096 the couplings' transformed halves take
kernel B (B*D >= 4096); training at --batch 512 runs kernels A and C.
"""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import copy
import time

import torch

import nf_tpu_torch as nt
from nf_tpu_torch.data import ArrayDataset, prefetch_to_device
from nf_tpu_torch.serving import (
    compile_log_prob,
    compile_sampler,
    export_log_prob,
    load_exported,
)

from examples_torch._utils import (
    DATA_STREAM,
    History,
    base_parser,
    device_of,
    generator,
    optimizer,
    sync,
)


def parser():
    p = base_parser(__doc__, iters=300, lr=3e-3)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--serve-batch", type=int, default=4096)
    return p


def build_model(args, device):
    """``build_nsf(dim=2, K=4, hidden=64, num_bins=8)``."""
    return nt.build_nsf(dim=2, K=4, hidden=64, num_bins=8, device=device,
                        seed=args.seed)


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)

    # --- train a small NSF on TwoMoons data through the input pipeline ---
    x_all = nt.TwoMoons().sample(
        1 << 15, generator=generator(dev, args.seed, DATA_STREAM)).cpu()
    ds = ArrayDataset(x_all.numpy(), batch_size=args.batch, shuffle=True)
    model = build_model(args, dev)
    state = nt.init_train_state(model, optimizer(model, args.lr))
    step = nt.make_forward_kld_step(state.optimizer)

    hist = History(max(args.iters, 1), dev)
    it = 0
    t0 = time.time()
    for x in prefetch_to_device(ds.epochs(), size=2, device=dev):
        loss = step(state, x)
        hist.record(it, loss)
        it += 1
        if it >= args.iters:
            break
    sync(dev)
    hist.seconds = time.time() - t0
    print(f"trained {it} steps, final NLL {float(loss):.3f}")

    # --- compile the serving executables once ---
    sampler = compile_sampler(model, num_samples=args.serve_batch)
    density = compile_log_prob(model, (args.serve_batch, 2))
    fl = density.flops()
    if fl:
        print(f"log_prob executable: {fl/1e6:.1f} MFLOP/call")

    seed = args.seed + 1
    z, log_q = sampler(seed)
    lp = density(z)
    err = float(torch.max(torch.abs(lp - log_q)))
    print(f"served {args.serve_batch} samples; sample/log_prob max err "
          f"{err:.3f} (trained NSFs have sharp spline bins; ~1 nat max "
          "over 4k samples is the expected f32 tail, see docs/accuracy.md)")

    # --- parameter refresh without recapture ---
    model2 = copy.deepcopy(model)
    with torch.no_grad():
        for p in model2.parameters():
            p.mul_(0.999)
    sampler2 = sampler.with_model(model2)
    z2, _ = sampler2(seed)
    print("rebind without recompile:",
          bool(torch.any(z2 != z)), "(outputs changed)")

    # --- serialized artifact: export, reload, serve without model code ---
    blob = export_log_prob(model, (args.serve_batch, 2))
    reloaded = load_exported(blob)
    err_art = float(torch.max(torch.abs(reloaded(z) - lp)))
    print(f"torch.export artifact: {len(blob)/1e3:.0f} kB, reload max err "
          f"{err_art:.2e} vs the in-process executable")

    # throughput of the compiled sampler (amortized over many calls), each
    # call synchronised by a host read of one of its values, each with its
    # own seed
    float(sampler(seed)[1][0])  # warmup
    t0 = time.perf_counter()
    n_calls = 20
    for i in range(n_calls):
        float(sampler(seed + 1 + i)[1][0])
    dt = (time.perf_counter() - t0) / n_calls
    print(f"compiled sampler: {args.serve_batch/dt:,.0f} samples/s "
          f"({dt*1e3:.2f} ms/call incl. dispatch)")
    return {"hist": hist, "served": {
        "log_prob": density.launches, "sample": sampler.launches,
        "exported log_prob": reloaded.launches},
        "sample_log_prob_err": err, "artifact_err": err_art,
        "samples_per_s": args.serve_batch / dt}


if __name__ == "__main__":
    main()
