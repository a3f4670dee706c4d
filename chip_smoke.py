"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), the torch and CUDA versions, and
   builds every CUDA kernel of the port from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, all at once), timing the build.
2. Holds each kernel against its plain PyTorch version on the card, at
   the main path's shape ``[37, 6603710]`` and at edge shapes, and times
   kernel, plain version, a one-call PyTorch yardstick and the bound.
3. Runs small simulations on the GPU and on the CPU with the same fleet,
   draws and weights, and holds the two to each other: the MLP's
   synchronous, trimmed-mean and multi-Krum runs, round by round; and
   the first slice's small synchronous run of the paper's CNN.
4. Drives the main path through its entry point: three synchronous rounds
   of the paper's setup at paper scale (SynthFEMNIST with 371 clients,
   the 6,603,710-parameter CNN, 10% of clients per round, B = 10, E = 5,
   lr = 0.01), checking that each round launched each kernel once.
5. Profiles one more such round: device time by kernel, idle share.
6. Drives the hostile path at the same scale, two rounds each: the
   ``byzantine`` fleet (25 % sign-flip attackers) under trimmed-mean
   (trim 9), and ``byzantine-colluding`` (colluding-flip at scale 4)
   under Krum and multi-Krum, checking each round's kernel launches.

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
from dataclasses import fields, replace
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
MAIN_TRIM = MAIN_K // 4               # the robust study's trim = cohort // 4
F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)


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


def phase_robust_kernels(gen: torch.Generator) -> dict:
    """K4 ``trimmed_agg`` and K5 ``pairwise_sq_dists`` against their plain
    versions, and their times at the hostile path's shape."""
    from repro_torch.kernels import krum as kkrum
    from repro_torch.kernels import ref
    from repro_torch.kernels import trimmed as ktrim

    def inputs(S, N, dtype):
        x = torch.randn(S, N, generator=gen, device="cuda").to(dtype)
        w = torch.rand(S, generator=gen, device="cuda") + 0.1
        return x, w / w.sum()

    err = {}
    for S, N, trim, dt in [(MAIN_K, MAIN_N, MAIN_TRIM, torch.float32),
                           (MAIN_K, MAIN_N, MAIN_TRIM, torch.bfloat16),
                           (3, 1, 1, torch.float32), (5, 300, 0, torch.float32),
                           (70, 4099, 20, torch.bfloat16)]:
        x, w = inputs(S, N, dt)
        out, want = ktrim.trimmed_agg(x, w, trim), ref.trimmed_agg_ref(x, w,
                                                                      trim)
        torch.cuda.synchronize()
        assert out.dtype == dt and out.shape == (N,)
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        torch.testing.assert_close(out.float(), want.float(), **tol)
        assert torch.equal(out, ktrim.trimmed_agg(x, w, trim))
        e = (out.float() - want.float()).abs().max().item()
        log(f"trimmed_agg [{S}, {N}] trim {trim} {dt}: max |kernel - plain| "
            f"= {e:.3e}")
        err.setdefault("trimmed_agg", e)
    # duplicate-heavy columns and distinct weights within a factor of 2:
    # trimming another of two equal values changes the result by ~1e-3
    # relative, so the keep sets must agree
    x = torch.randint(-2, 3, (MAIN_K, 1 << 16), generator=gen,
                      device="cuda").float()
    w = 1.0 + torch.arange(MAIN_K, device="cuda") / MAIN_K
    w = w / w.sum()
    torch.testing.assert_close(ktrim.trimmed_agg(x, w, MAIN_TRIM),
                               ref.trimmed_agg_ref(x, w, MAIN_TRIM),
                               **F32_TOL)
    # non-finite values: NaN wherever the plain version gives NaN
    x[:, :8] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0,
                             -0.0, 1.0, -1.0, 2.0], device="cuda")
    x[0, 8], x[1, 9], x[-1, 10] = float("nan"), float("inf"), -float("inf")
    torch.testing.assert_close(ktrim.trimmed_agg(x, w, MAIN_TRIM),
                               ref.trimmed_agg_ref(x, w, MAIN_TRIM),
                               equal_nan=True, **F32_TOL)
    for S, N, dt in [(MAIN_K, MAIN_N, torch.float32), (1, 1, torch.float32),
                     (1, 487, torch.float32), (70, 5000, torch.float32),
                     (MAIN_K, 3001, torch.bfloat16)]:
        x, _ = inputs(S, N, dt)
        d2, gram = kkrum.pairwise_sq_dists(x, with_gram=True)
        xf = x.float()
        want_gram = xf @ xf.T
        want = kkrum.gram_sq_dists(want_gram)
        torch.cuda.synchronize()
        torch.testing.assert_close(gram, want_gram, rtol=1e-5,
                                   atol=1e-5 * N ** 0.5)
        atol = 1e-5 * float(torch.diagonal(want_gram).max())
        torch.testing.assert_close(d2, want, rtol=1e-5, atol=atol)
        assert torch.equal(d2, kkrum.pairwise_sq_dists(x))
        e = (d2 - want).abs().max().item()
        log(f"pairwise_sq_dists [{S}, {N}] {dt}: max |kernel - plain| = "
            f"{e:.3e} (d2 atol {atol:.3e}), max |G - x x^T| = "
            f"{(gram - want_gram).abs().max().item():.3e}")
        err.setdefault("pairwise_sq_dists", e)

    rows = []
    for dt in (torch.float32, torch.bfloat16):
        x, w = inputs(MAIN_K, MAIN_N, dt)
        item = x.element_size()
        kept = sum(MAIN_K - 2 * r for r in range(MAIN_TRIM))
        ops_col = 2 * kept + 3 * (MAIN_K - 2 * MAIN_TRIM)
        rows.append(("trimmed_agg" if dt == torch.float32
                     else "trimmed_agg_bf16",
                     "src/repro_torch/kernels/csrc/trimmed.cu",
                     lambda x=x, w=w: ktrim.trimmed_agg(x, w, MAIN_TRIM),
                     lambda x=x, w=w: ref.trimmed_agg_ref(x, w, MAIN_TRIM),
                     lambda x=x: torch.sort(x, dim=0, stable=True),
                     "torch.sort(x, dim=0, stable=True), the sort step of a "
                     "sort-based version",
                     x.numel() * item + MAIN_K * 4 + MAIN_N * item,
                     ops_col * MAIN_N, "src/repro/kernels/trimmed.py:55",
                     str(dt).replace("torch.", "")))
        del x, w
    x, _ = inputs(MAIN_K, MAIN_N, torch.float32)
    rows.append(("pairwise_sq_dists", "src/repro_torch/kernels/csrc/krum.cu",
                 lambda: kkrum.pairwise_sq_dists(x),
                 lambda: kkrum.gram_sq_dists(x @ x.T),
                 lambda: x @ x.T, "x @ x.T (cuBLAS, TF32 off)",
                 x.numel() * 4 + MAIN_K * MAIN_K * 4,
                 MAIN_K * (MAIN_K + 1) * MAIN_N,
                 "src/repro/kernels/krum.py:53", "float32"))
    out = {}
    for (name, source, kernel, plain, library, library_label, nbytes, flops,
         replaces, dtype) in rows:
        ms, plain_ms, lib_ms = time_ms(kernel), time_ms(plain), time_ms(library)
        bound_ms, bound_by = bound(nbytes, flops)
        log(f"{name} [{MAIN_K}, {MAIN_N}] {dtype}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms ({library_label}), "
            f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, {flops} "
            f"operations); kernel reaches {bound_ms / ms:.1%} of the bound")
        out[name] = {"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": None,
                     "max_abs_err": err[name.replace("_bf16", "")],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms}
    del x
    torch.cuda.empty_cache()
    # the bf16 timing is printed; the JSON line carries one row per kernel
    out.pop("trimmed_agg_bf16")
    return out


def drive_rounds(sim, rounds: int, entering=None) -> list:
    """Step ``sim`` through rounds ``1..rounds`` as ``run`` steps them,
    evaluating after each.  Round ``r`` starts from the previous round's
    result, or, given ``entering``, from ``entering[r - 1]`` (a state of
    another run, moved to this device).  Returns one dict per round: the
    state entering it and after it, its outputs and the global accuracy.
    """
    state = sim.init_state()
    out = []
    for r in range(1, rounds + 1):
        if entering is not None:
            state = replace(entering[r - 1], **{
                f.name: getattr(entering[r - 1], f.name).to(sim.device)
                for f in fields(state)})
        after, ys = sim._round_step(state, r)
        out.append({"before": state, "after": after, "ys": ys,
                    "acc": float(sim._evaluate(after.params)[1])})
        state = after
    return out


def rounds_agree(gpu: list, cpu: list) -> float:
    """Hold two runs' rounds to each other and return the largest
    parameter gap: parameters at rtol 1e-4 / atol 1e-5 (every local step
    sums in another order on the two devices), accuracy and weights
    entropy at rtol 1e-5, the virtual clock at rtol 1e-6 (it passes
    through ``exp``), participants, commits, last syncs and Krum's
    selected clients exactly."""
    gap = 0.0
    for r, (a, b) in enumerate(zip(gpu, cpu), start=1):
        pa, pb = a["after"].params.cpu(), b["after"].params
        torch.testing.assert_close(pa, pb, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"round {r}: {m}")
        gap = max(gap, (pa - pb).abs().max().item())
        assert torch.equal(a["after"].last_sync.cpu(),
                           b["after"].last_sync), f"round {r}: last_sync"
        assert int(a["after"].commits) == int(b["after"].commits), \
            f"round {r}: commits"
        assert (int(a["ys"]["participants"])
                == int(b["ys"]["participants"])), f"round {r}: participants"
        if "selected" in a["ys"]:
            assert (sorted(a["ys"]["selected"].tolist())
                    == sorted(b["ys"]["selected"].tolist())), \
                f"round {r}: selected {a['ys']['selected']} " \
                f"{b['ys']['selected']}"
        assert math.isclose(float(a["after"].sim_time),
                            float(b["after"].sim_time), rel_tol=1e-6), \
            f"round {r}: sim_time"
        assert math.isclose(a["acc"], b["acc"], rel_tol=1e-5), \
            f"round {r}: global_acc {a['acc']} {b['acc']}"
        assert math.isclose(float(a["ys"]["entropy"]),
                            float(b["ys"]["entropy"]), rel_tol=1e-5), \
            f"round {r}: weights_entropy"
    return gap


SMALL_RUNS = ("sync", "trimmed-mean", "multi-krum")


def small_sims(data, run: str, model: str, lr: float) -> dict:
    """The GPU and the CPU simulation of one small run, with the same
    data, fleet, draws and weights: ``run`` is the synchronous round, or
    trimmed-mean (trim 2) on the ``byzantine`` fleet, or multi-Krum on the
    colluding one (colluding-flip at scale 4); ``model`` the MLP at
    hidden 48 or the paper's CNN at hidden 16.  A quarter of the 16
    clients per round on the sync run, half on the hostile ones (Krum
    needs S > 2f + 2); B = 8, E = 1."""
    from repro_torch.federated.draws import TorchDraws
    from repro_torch.federated.engine import make_strategy
    from repro_torch.federated.scenarios import ScenarioConfig, make_fleet
    from repro_torch.federated.simulation import (FederatedSimulation,
                                                  FedSimConfig)
    from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn_params
    from repro_torch.models.mlp import init_mlp_params, mlp_accuracy, mlp_loss

    scen, strategy = {
        "sync": (None, lambda: None),
        "trimmed-mean": (ScenarioConfig(preset="byzantine"),
                         lambda: make_strategy("trimmed-mean", trim=2)),
        "multi-krum": (ScenarioConfig(preset="byzantine-colluding",
                                      attack="colluding-flip",
                                      attack_scale=4.0),
                       lambda: make_strategy("multi-krum"))}[run]
    init, loss, acc, hidden = {
        "MLP": (init_mlp_params, mlp_loss, mlp_accuracy, 48),
        "CNN": (init_cnn_params, cnn_loss, cnn_accuracy, 16)}[model]
    fleet = (make_fleet(scen, data.num_clients, device="cpu")
             if scen is not None else None)
    sims = {}
    for dev in ("cuda", "cpu"):
        cfg = FedSimConfig(fraction=0.25 if scen is None else 0.5,
                           batch_size=8, local_epochs=1, lr=lr,
                           scenario=scen, strategy=strategy())
        sims[dev] = FederatedSimulation(
            data, init(torch.Generator().manual_seed(1), hidden=hidden,
                       device=dev),
            loss, acc, cfg, draws=TorchDraws(0, "cpu"), fleet=fleet,
            device=dev)
    return sims


def phase_small_runs() -> None:
    """GPU against CPU on the MLP's small runs (:func:`small_sims`), three
    rounds each, each device running on its own, held to each other
    round by round (:func:`rounds_agree`), Krum's selections included."""
    from repro_torch.data.synthetic import make_synth_femnist

    data = make_synth_femnist(num_clients=16, mean_samples=24, seed=3)
    for run in SMALL_RUNS:
        sims = small_sims(data, run, "MLP", lr=0.1)
        gpu = drive_rounds(sims["cuda"], 3)
        gap = rounds_agree(gpu, drive_rounds(sims["cpu"], 3))
        sel = [sorted(g["ys"]["selected"].tolist()) for g in gpu
               if "selected" in g["ys"]]
        log(f"small MLP {run} run, GPU vs CPU: max |params gap| = "
            f"{gap:.3e}, acc {[round(g['acc'], 4) for g in gpu]}, "
            f"participants {[int(g['ys']['participants']) for g in gpu]}"
            + (f", selections {sel}" if sel else ""))


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


def phase_hostile_path(data) -> dict:
    """The hostile path at paper scale, two rounds per configuration,
    each driven through ``FederatedSimulation.run`` with every launch
    count set to 0 just before it and read just after."""
    from repro_torch.core.aggregate import AggregationConfig
    from repro_torch.federated.engine import make_strategy
    from repro_torch.federated.scenarios import ScenarioConfig
    from repro_torch.federated.simulation import (FederatedSimulation,
                                                  FedSimConfig)
    from repro_torch.kernels import divergence as kdiv
    from repro_torch.kernels import krum as kkrum
    from repro_torch.kernels import trimmed as ktrim
    from repro_torch.kernels import weighted_agg as kagg
    from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn_params

    wrappers = {"weighted_agg": kagg.weighted_agg,
                "divergence_sq": kdiv.divergence_sq,
                "trimmed_agg": ktrim.trimmed_agg,
                "pairwise_sq_dists": kkrum.pairwise_sq_dists}
    totals = dict.fromkeys(wrappers, 0)
    rounds = 2
    for preset, attack, scale, name, kwargs in [
            ("byzantine", "sign-flip", 1.0, "trimmed-mean",
             dict(trim=MAIN_TRIM)),
            ("byzantine-colluding", "colluding-flip", 4.0, "krum", {}),
            ("byzantine-colluding", "colluding-flip", 4.0, "multi-krum", {})]:
        cfg = FedSimConfig(
            fraction=0.1, batch_size=10, local_epochs=5, lr=0.01,
            max_rounds=rounds, eval_every=1,
            aggregation=AggregationConfig(priority=(2, 0, 1)),
            scenario=ScenarioConfig(preset=preset, attack=attack,
                                    attack_scale=scale, corrupt_frac=0.25),
            strategy=make_strategy(name, **kwargs))
        sim = FederatedSimulation(
            data, init_cnn_params(torch.Generator().manual_seed(0),
                                  hidden=2048),
            cnn_loss, cnn_accuracy, cfg)
        n_corrupt = int(sim.fleet.corrupt.sum())
        assert n_corrupt == math.ceil(0.25 * data.num_clients)
        assert sim.fleet.attack == attack
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        res = sim.run(targets=(0.75,), device_fracs=(0.5,), verbose=False)
        launches = {k: fn.launches for k, fn in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()

        krum = name != "trimmed-mean"
        assert [m.round for m in res.metrics] == list(range(1, rounds + 1))
        assert launches == {"weighted_agg": rounds if krum else 0,
                            "divergence_sq": rounds,
                            "trimmed_agg": 0 if krum else rounds,
                            "pairwise_sq_dists": rounds if krum else 0}, \
            launches
        prev = 0.0
        for m in res.metrics:
            assert math.isfinite(m.global_acc) and 0.0 <= m.global_acc <= 1.0
            assert 0 < m.participants <= MAIN_K and m.commits == m.round
            assert math.isfinite(m.weights_entropy) and m.sim_time > 0
            log(f"hostile {name} ({preset}, {attack} x{scale:g}) round "
                f"{m.round}: {m.wall_time - prev:.2f} s (with its "
                f"evaluation), global_acc {m.global_acc:.4f}, participants "
                f"{m.participants}, sim_time {m.sim_time:.3f}")
            prev = m.wall_time
        final = res.final_state.params
        assert final.shape == (MAIN_N,) and bool(torch.isfinite(final).all())
        per_round = {k: v / rounds for k, v in launches.items()}
        log(f"hostile {name}: {rounds} rounds in "
            f"{res.metrics[-1].wall_time:.2f} s, {n_corrupt} corrupt clients "
            f"of {data.num_clients}, peak device memory "
            f"{peak / 2**30:.2f} GiB, launches {launches} ({per_round} per "
            f"round)")
        for k, v in launches.items():
            totals[k] += v
    return totals


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

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernels(gen)
    rows.update(phase_robust_kernels(gen))
    phase_small_runs()
    phase_small_sim()
    launches, data, cfg = phase_main_path()
    phase_profile(data, cfg)
    hostile = phase_hostile_path(data)
    # each kernel's launches from the path that runs it: the sync main
    # path for K1 and K2, the hostile runs for K4 and K5
    launches.update(trimmed_agg=hostile["trimmed_agg"],
                    pairwise_sq_dists=hostile["pairwise_sq_dists"])
    for name, n in launches.items():
        assert n > 0, (name, n)
        rows[name]["launches"] = n
    assert sorted(rows) == sorted(launches)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
