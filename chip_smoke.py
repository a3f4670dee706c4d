"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), the torch and CUDA versions, and
   builds every CUDA kernel of the port from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, all at once), timing the build.
2. Holds each kernel against its plain PyTorch version on the card, at
   the main path's shape ``[37, 6603710]`` and at edge shapes, and times
   kernel, plain version, a one-call PyTorch yardstick and the bound.
3. Runs a small synchronous simulation on the GPU and on the CPU with the
   same draws and weights, and holds the two to each other.
4. Drives the main path through its entry point: three synchronous rounds
   of the paper's setup at paper scale (SynthFEMNIST with 371 clients,
   the 6,603,710-parameter CNN, 10% of clients per round, B = 10, E = 5,
   lr = 0.01), checking that each round launched each kernel once.
5. Profiles one more such round: device time by kernel, idle share.

Prints a JSON line with every kernel's numbers, and as its last line
``{"ok": true, "device": {...}}``.  Any failure raises, so the exit code
is nonzero; with no GPU it exits nonzero before printing any result.
Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Data-sheet peaks of the H100 SXM at its full 700 W limit (the card this
# script was written for prints "NVIDIA H100 80GB HBM3, 700.00 W"): HBM
# bandwidth and the f32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

MAIN_K, MAIN_N = 37, 6_603_710        # S clients x CNN-2048 parameters


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes: int, flops: int):
    """Least time (ms) the card could take, and what sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(gen: torch.Generator) -> dict:
    from repro_torch.kernels import divergence as kdiv
    from repro_torch.kernels import ref
    from repro_torch.kernels import weighted_agg as kagg

    tol = {torch.float32: dict(rtol=1e-5, atol=1e-6),
           torch.bfloat16: dict(rtol=1e-2, atol=1e-6)}
    shapes_agg = [(MAIN_K, MAIN_N, torch.float32), (1, 1, torch.float32),
                  (3, 257, torch.float32), (MAIN_K, MAIN_N, torch.bfloat16),
                  (3, 257, torch.bfloat16)]
    shapes_div = [(MAIN_K, MAIN_N, torch.float32), (1, 487, torch.float32),
                  (MAIN_K, MAIN_N, torch.bfloat16), (1, 487, torch.bfloat16)]

    def inputs(K, N, dtype):
        x = torch.randn(K, N, generator=gen, device="cuda").to(dtype)
        g = torch.randn(N, generator=gen, device="cuda").to(dtype)
        w = torch.rand(K, generator=gen, device="cuda") + 0.1
        return x, g, w / w.sum()

    err = {}
    for K, N, dt in shapes_agg:
        x, _, w = inputs(K, N, dt)
        out, want = kagg.weighted_agg(x, w), ref.weighted_agg_ref(x, w)
        torch.cuda.synchronize()
        assert out.dtype == dt and out.shape == (N,)
        torch.testing.assert_close(out.float(), want.float(), **tol[dt])
        e = (out.float() - want.float()).abs().max().item()
        log(f"weighted_agg [{K}, {N}] {dt}: max |kernel - plain| = {e:.3e}")
        err.setdefault("weighted_agg", e)
    for K, N, dt in shapes_div:
        x, g, _ = inputs(K, N, dt)
        out, want = kdiv.divergence_sq(x, g), ref.divergence_ref(x, g)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32 and out.shape == (K,)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=0.0)
        e = (out - want).abs().max().item()
        log(f"divergence_sq [{K}, {N}] {dt}: max |kernel - plain| = {e:.3e}")
        err.setdefault("divergence_sq", e)

    # times at the main path's shape and type
    x, g, w = inputs(MAIN_K, MAIN_N, torch.float32)
    wave = x.numel() * 4
    rows = []
    for name, source, kernel, plain, library, nbytes, flops, replaces in [
        ("weighted_agg", "src/repro_torch/kernels/csrc/weighted_agg.cu",
         lambda: kagg.weighted_agg(x, w),
         lambda: ref.weighted_agg_ref(x, w), lambda: w @ x,
         wave + MAIN_K * 4 + MAIN_N * 4, 2 * x.numel(),
         "src/repro/kernels/weighted_agg.py:33"),
        ("divergence_sq", "src/repro_torch/kernels/csrc/divergence.cu",
         lambda: kdiv.divergence_sq(x, g),
         lambda: ref.divergence_ref(x, g),
         lambda: torch.cdist(x, g[None], compute_mode=
                             "donot_use_mm_for_euclid_dist") ** 2,
         wave + MAIN_N * 4 + MAIN_K * 4, 3 * x.numel(),
         "src/repro/kernels/divergence.py:33"),
    ]:
        ms, plain_ms, lib_ms = time_ms(kernel), time_ms(plain), time_ms(library)
        bound_ms, bound_by = bound(nbytes, flops)
        log(f"{name} [{MAIN_K}, {MAIN_N}] f32: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}); kernel reaches "
            f"{bound_ms / ms:.1%} of the bound")
        rows.append({"name": name, "route": "cuda",
                     "source": source,
                     "replaces": replaces, "launches": None,
                     "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms})
    del x, g, w
    torch.cuda.empty_cache()
    return {r["name"]: r for r in rows}


def phase_small_sim() -> None:
    """GPU against CPU on a small run: same data, weights and draws."""
    from repro_torch.data.synthetic import make_synth_femnist
    from repro_torch.federated.draws import TorchDraws
    from repro_torch.federated.simulation import (FederatedSimulation,
                                                  FedSimConfig)
    from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn_params

    data = make_synth_femnist(num_clients=16, mean_samples=24, seed=3)
    cfg = FedSimConfig(fraction=0.25, batch_size=8, local_epochs=1, lr=0.1,
                       max_rounds=2, eval_every=1)
    results = {}
    for dev in ("cuda", "cpu"):
        params = init_cnn_params(torch.Generator().manual_seed(1), hidden=16,
                                 device=dev)
        sim = FederatedSimulation(data, params, cnn_loss, cnn_accuracy, cfg,
                                  draws=TorchDraws(0, "cpu"), device=dev)
        results[dev] = sim.run(verbose=False)
    gpu, cpu = results["cuda"], results["cpu"]
    # f32 on both sides (TF32 off); every local step sums in another order
    torch.testing.assert_close(gpu.final_state.params.cpu(),
                               cpu.final_state.params, rtol=1e-4, atol=1e-5)
    for a, b in zip(gpu.metrics, cpu.metrics):
        assert math.isclose(a.global_acc, b.global_acc, rel_tol=1e-5), (a, b)
        assert math.isclose(a.weights_entropy, b.weights_entropy,
                            rel_tol=1e-5), (a, b)
    gap = (gpu.final_state.params.cpu() - cpu.final_state.params).abs().max()
    log(f"small run, GPU vs CPU: max |params gap| = {gap.item():.3e}, "
        f"acc {[m.global_acc for m in gpu.metrics]}")


def phase_main_path():
    from repro_torch.core.aggregate import AggregationConfig
    from repro_torch.data.synthetic import make_synth_femnist
    from repro_torch.federated.simulation import (FederatedSimulation,
                                                  FedSimConfig)
    from repro_torch.kernels import divergence as kdiv
    from repro_torch.kernels import weighted_agg as kagg
    from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn_params

    t0 = time.perf_counter()
    data = make_synth_femnist(num_clients=371, mean_samples=60, seed=0)
    params = init_cnn_params(torch.Generator().manual_seed(0), hidden=2048)
    cfg = FedSimConfig(fraction=0.1, batch_size=10, local_epochs=5, lr=0.01,
                       max_rounds=3, eval_every=1,
                       aggregation=AggregationConfig(priority=(2, 0, 1)))
    sim = FederatedSimulation(data, params, cnn_loss, cnn_accuracy, cfg)
    n_params = sum(v.numel() for v in sim.params.values())
    steps = int(data.counts.max()) // cfg.batch_size * cfg.local_epochs
    log(f"main path set-up {time.perf_counter() - t0:.1f} s: N = {n_params}, "
        f"{steps} local steps per round")
    assert n_params == MAIN_N

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kagg.weighted_agg.launches = 0
    kdiv.divergence_sq.launches = 0
    res = sim.run(targets=(0.75,), device_fracs=(0.5,), verbose=False)
    launches = {"weighted_agg": kagg.weighted_agg.launches,
                "divergence_sq": kdiv.divergence_sq.launches}
    peak = torch.cuda.max_memory_allocated()

    rounds = len(res.metrics)
    assert rounds == 3, [m.round for m in res.metrics]
    assert launches == {"weighted_agg": rounds, "divergence_sq": rounds}, \
        launches
    prev = 0.0
    for m in res.metrics:
        assert math.isfinite(m.global_acc) and 0.0 <= m.global_acc <= 1.0
        assert math.isfinite(m.weights_entropy)
        assert 0.0 < m.weights_entropy <= math.log(MAIN_K) + 1e-5
        assert m.participants == MAIN_K and m.commits == m.round
        log(f"round {m.round}: {m.wall_time - prev:.2f} s (with its "
            f"evaluation), global_acc {m.global_acc:.4f}, weights entropy "
            f"{m.weights_entropy:.4f}")
        prev = m.wall_time
    final = res.final_state.params
    assert final.shape == (MAIN_N,) and bool(torch.isfinite(final).all())
    log(f"main path: {rounds} rounds in {res.metrics[-1].wall_time:.2f} s, "
        f"peak device memory {peak / 2**30:.2f} GiB, launches {launches}")
    return launches, data, cfg


def phase_profile(data, cfg) -> None:
    """One more paper-scale round, with its evaluation, under
    ``torch.profiler``: device time by kernel and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.federated.simulation import FederatedSimulation
    from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn_params

    sim = FederatedSimulation(
        data, init_cnn_params(torch.Generator().manual_seed(0), hidden=2048),
        cnn_loss, cnn_accuracy, replace(cfg, max_rounds=1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(targets=(0.75,), device_fracs=(0.5,), verbose=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device busy time: the union of the kernels' intervals on the device
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                     key=dev_us, reverse=True)
    summed = sum(dev_us(e) for e in kernels)
    if not spans:
        log("profiled round: the profiler saw no device activity")
        return
    log(f"profiled round: wall {wall_us / 1e3:.1f} ms, {len(spans)} device "
        f"events, device busy {busy / 1e3:.1f} ms (union of intervals), "
        f"device idle share {1 - busy / wall_us:.1%}; device time summed "
        f"by kernel {summed / 1e3:.1f} ms")
    for e in kernels[:12]:
        log(f"  {dev_us(e) / 1e3:9.2f} ms {e.count:6d} x  {e.key[:90]}")
    ours = sum(dev_us(e) for e in kernels
               if "weighted_agg_kernel" in e.key or "divergence_" in e.key)
    log(f"  weighted_agg + divergence_sq kernels: {ours / 1e3:.3f} ms "
        f"({ours / summed:.2%} of the summed device time)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, lib in sorted(libs.items()):
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rows = phase_kernels(torch.Generator(device="cuda").manual_seed(0))
    phase_small_sim()
    launches, data, cfg = phase_main_path()
    phase_profile(data, cfg)
    for name, n in launches.items():
        rows[name]["launches"] = n
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
