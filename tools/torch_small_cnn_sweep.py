"""How far the small CNN runs of ``chip_smoke.py`` part between devices.

    python3 tools/torch_small_cnn_sweep.py [--seeds 12] [--lr 0.1 0.01]

Needs one NVIDIA GPU.  For each learning rate, each of the small runs
(``chip_smoke.small_sims``: sync, trimmed-mean, multi-Krum; the CNN at
hidden 16, two rounds) and each seed of the SynthFEMNIST data (16
clients), it runs the port twice on the GPU and once on the CPU, and
prints:

* the gap between the two GPU runs (cuDNN's default algorithms);
* the gap, GPU against CPU, at the end of the run, and whether every
  round holds ``chip_smoke.rounds_agree``'s tolerances (parameters at
  rtol 1e-4 / atol 1e-5);
* the same with the GPU's convolutions off cuDNN (PyTorch's own CUDA
  convolution), and the gap between the two GPU paths;
* the same when the CPU replays each GPU round from the state the GPU
  entered it with;
* whether every local step's gradients, recomputed on the CPU from the
  GPU step's own parameters and batch, hold at rtol 1e-4 / atol 1e-5.

Then the CNN's gradient on one batch, in the vmapped form local training
uses and for a single model, on the GPU (cuDNN's default and its
deterministic algorithms) and on the CPU in f32, each against f64 on the
CPU: the relative error ``||g - g64|| / ||g64||`` per convolution tensor;
and whether the paper-scale vmapped gradient (37 clients, B = 10, hidden
2048) repeats bit for bit on the GPU.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch
from torch.func import grad, vmap

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (SMALL_RUNS, drive_rounds, rounds_agree,  # noqa: E402
                        small_sims)
from repro_torch.data.synthetic import make_synth_femnist  # noqa: E402
from repro_torch.models.cnn import cnn_loss, init_cnn_params  # noqa: E402

ROUNDS = 2


def record_grads(sim) -> list:
    """Make ``sim`` record every local-training gradient it computes:
    one ``(params, images, labels, grads)`` per step, in order."""
    steps, grad_fn = [], sim._grad

    def recording(params, images, labels):
        grads = grad_fn(params, images, labels)
        steps.append((params, images, labels, grads))
        return grads

    sim._grad = recording
    return steps


def grads_agree(steps: list, cpu_sim) -> float:
    """Recompute each recorded step's gradients with ``cpu_sim`` from the
    same parameters and batch, hold them at rtol 1e-4 / atol 1e-5, and
    return the largest gap."""
    gap = 0.0
    for i, (params, images, labels, grads) in enumerate(steps):
        want = cpu_sim._grad({k: v.cpu() for k, v in params.items()},
                             images.cpu(), labels.cpu())
        for k, g in grads.items():
            torch.testing.assert_close(g.cpu(), want[k], rtol=1e-4,
                                       atol=1e-5,
                                       msg=lambda m: f"step {i} {k}: {m}")
            gap = max(gap, (g.cpu() - want[k]).abs().max().item())
    return gap


def held(check, *args) -> tuple:
    """``check``'s result and ``"held"``, or ``nan`` and why it failed."""
    try:
        return check(*args), "held"
    except AssertionError as err:
        return float("nan"), "NOT (" + str(err).strip().splitlines()[0] + ")"


def final_gap(a: list, b: list) -> float:
    return (a[-1]["after"].params.cpu()
            - b[-1]["after"].params.cpu()).abs().max().item()


def sweep(seeds: int, lrs: list) -> None:
    for lr in lrs:
        for run in SMALL_RUNS:
            tally = dict(free=0, native=0, replay=0, steps=0)
            for seed in range(seeds):
                data = make_synth_femnist(num_clients=16, mean_samples=24,
                                          seed=seed)
                sims = small_sims(data, run, "CNN", lr)
                grad_fn = sims["cuda"]._grad
                steps = record_grads(sims["cuda"])
                gpu = drive_rounds(sims["cuda"], ROUNDS)
                sims["cuda"]._grad = grad_fn
                again = drive_rounds(sims["cuda"], ROUNDS)
                with torch.backends.cudnn.flags(enabled=False):
                    native = drive_rounds(sims["cuda"], ROUNDS)
                cpu = drive_rounds(sims["cpu"], ROUNDS)
                replay = drive_rounds(sims["cpu"], ROUNDS,
                                      [g["before"] for g in gpu])
                results = {
                    "free": held(rounds_agree, gpu, cpu),
                    "native": held(rounds_agree, native, cpu),
                    "replay": held(rounds_agree, gpu, replay),
                    "steps": held(grads_agree, steps, sims["cpu"])}
                for k, (_, verdict) in results.items():
                    tally[k] += verdict == "held"
                print(f"lr {lr} {run} seed {seed}: GPU repeat gap "
                      f"{final_gap(gpu, again):.2e}, GPU vs CPU "
                      f"{final_gap(gpu, cpu):.2e} {results['free'][1]}; "
                      f"cuDNN off vs CPU {final_gap(native, cpu):.2e} "
                      f"{results['native'][1]}; cuDNN vs cuDNN off "
                      f"{final_gap(gpu, native):.2e}; replayed rounds "
                      f"{final_gap(gpu, replay):.2e} {results['replay'][1]}"
                      f"; replayed steps {results['steps'][0]:.2e} "
                      f"{results['steps'][1]}", flush=True)
            print(f"lr {lr} {run}, of {seeds} seeds held: GPU vs CPU "
                  f"{tally['free']} (cuDNN), {tally['native']} (cuDNN off);"
                  f" replayed rounds {tally['replay']}; replayed steps "
                  f"{tally['steps']}", flush=True)


def gradient_precision() -> None:
    data = make_synth_femnist(num_clients=16, mean_samples=24, seed=3)
    images = torch.as_tensor(data.images[:4, :8])
    labels = torch.as_tensor(data.labels[:4, :8]).long()
    params = init_cnn_params(torch.Generator().manual_seed(1), hidden=16,
                             device="cpu")
    keys = ("conv1_w", "conv1_b", "conv2_w", "conv2_b")

    def grads(dev, dtype, vmapped):
        p = {k: v.to(dev, dtype) for k, v in params.items()}
        x, y = images.to(dev, dtype), labels.to(dev)
        if vmapped:
            p = {k: v.expand(4, *v.shape).contiguous() for k, v in p.items()}
            return vmap(grad(cnn_loss))(p, x, y)
        return grad(cnn_loss)(p, x[0], y[0])

    for vmapped in (True, False):
        exact = grads("cpu", torch.float64, vmapped)
        form = "vmapped, 4 clients" if vmapped else "single model"
        for label, dev, det in [("CPU f32", "cpu", False),
                                ("GPU cuDNN default", "cuda", False),
                                ("GPU cuDNN deterministic", "cuda", True)]:
            with torch.backends.cudnn.flags(enabled=True, deterministic=det,
                                            benchmark=False,
                                            allow_tf32=False):
                g = grads(dev, torch.float32, vmapped)
            err = {k: (g[k].double().cpu() - exact[k]).norm().item()
                   / exact[k].norm().item() for k in keys}
            print(f"gradient ({form}, B = 8) {label}: relative error "
                  + ", ".join(f"{k} {v:.2e}" for k, v in err.items()),
                  flush=True)
    big = init_cnn_params(torch.Generator().manual_seed(1), hidden=2048)
    big = {k: v.expand(37, *v.shape).contiguous() for k, v in big.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(37, 10, 28, 28, generator=gen, device="cuda")
    y = torch.randint(0, 62, (37, 10), generator=gen, device="cuda")
    a, b = (vmap(grad(cnn_loss))(big, x, y) for _ in range(2))
    print(f"paper-scale vmapped gradient (37 clients, B = 10) repeats bit "
          f"for bit on the GPU: {all(torch.equal(a[k], b[k]) for k in a)}",
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--lr", type=float, nargs="+", default=[0.1, 0.01])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_small_cnn_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, cuDNN "
          f"{torch.backends.cudnn.version()}")
    # as chip_smoke.py runs: f32 throughout, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sweep(args.seeds, args.lr)
    gradient_precision()
    return 0


if __name__ == "__main__":
    sys.exit(main())
