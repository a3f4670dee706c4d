"""Shared helpers of the port's tests, and the port's guard tests.

This file is the only place where the JAX package meets ``repro_torch``:

* :class:`ReplayDraws` hands the port's round engine the reference's own
  random draws, rebuilt with public ``jax.random`` calls exactly as
  ``repro.federated.simulation`` derives them, so a port run can be held
  to a live reference run trajectory for trajectory;
* :func:`numpy_params` makes one parameter set with numpy from a seed,
  in the reference's names and shapes, for both packages.

The guard tests prove that the port imports neither ``jax`` nor
``repro`` and that its default device is the GPU, with no quiet CPU
fallback.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import device_batch_plans
from repro.federated.sampler import sample_clients_jax
from repro.models.cnn import init_cnn_params
from repro.models.mlp import init_mlp_params

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


class ReplayDraws:
    """The reference's per-round draws, as the port's ``Draws`` protocol.

    ``repro.federated.simulation`` folds the round into the seed's key and
    splits it three ways (``simulation.py:831-835``): the first key draws
    the cohort (``sample_clients_jax``), the second the batch plans
    (``device_batch_plans``).  Returns CPU int64 tensors.
    """

    def __init__(self, seed: int):
        self._base = jax.random.key(seed)

    def _keys(self, rnd: int):
        key = jax.random.fold_in(self._base, jnp.int32(rnd))
        k_sel, k_batch, _k_scen = jax.random.split(key, 3)
        return k_sel, k_batch

    def select(self, rnd, num_clients, n):
        sel = sample_clients_jax(self._keys(rnd)[0], num_clients, n)
        return torch.from_numpy(np.asarray(sel).astype(np.int64))

    def batch_plans(self, rnd, counts_sel, steps, batch_size):
        counts = jnp.asarray(counts_sel.cpu().numpy().astype(np.int32))
        plans = device_batch_plans(self._keys(rnd)[1], counts, steps,
                                   batch_size)
        return torch.from_numpy(np.asarray(plans).astype(np.int64))


def numpy_params(model: str, hidden: int, seed: int) -> dict:
    """He-scaled normal weights and small biases, made with numpy from
    ``seed``, in the reference's names and shapes (``"cnn"`` or ``"mlp"``)."""
    init = {"cnn": init_cnn_params, "mlp": init_mlp_params}[model]
    shapes = jax.eval_shape(lambda: init(jax.random.key(0), hidden=hidden))
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(shapes):
        shape = shapes[name].shape
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        scale = np.sqrt(2.0 / fan_in) if len(shape) > 1 else 0.01
        out[name] = (rng.standard_normal(shape) * scale).astype(np.float32)
    return out


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port's tests on one torch thread.

    They share the host with the suite's other xdist workers, whose
    hypothesis property tests carry wall-clock deadlines; a torch op
    spread over every core would slow those tests down.  The port test
    modules that train models import this fixture, which makes it
    autouse there.
    """
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# Guard tests
# ---------------------------------------------------------------------------

def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    """Top-level package names a file imports, statically or through
    ``importlib.import_module`` / ``__import__`` with a literal name."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            roots.add(node.args[0].value.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax_or_reference(path):
    assert path.is_file(), path
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules "
              "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
              "assert not bad, bad\n"
              "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_default_device_raises_without_a_gpu(monkeypatch):
    from repro_torch.data.synthetic import make_synth_femnist
    from repro_torch.federated.simulation import (FederatedSimulation,
                                                  FedSimConfig)
    from repro_torch.models.mlp import mlp_accuracy, mlp_loss

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = make_synth_femnist(num_clients=4, mean_samples=8, seed=0)
    params = {k: torch.from_numpy(v)
              for k, v in numpy_params("mlp", 8, 0).items()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederatedSimulation(data, params, mlp_loss, mlp_accuracy,
                            FedSimConfig(max_rounds=1))


def test_torch_draws_are_valid_and_repeatable():
    from repro_torch.federated.draws import TorchDraws

    draws = TorchDraws(seed=7, device="cpu")
    counts = torch.tensor([1, 5, 30])
    for rnd in (1, 2):
        sel = draws.select(rnd, 50, 5)
        assert sel.dtype == torch.int64 and sel.shape == (5,)
        assert torch.equal(sel, torch.sort(sel).values)
        assert len(set(sel.tolist())) == 5 and 0 <= sel.min() < sel.max() < 50
        plans = draws.batch_plans(rnd, counts, 6, 4)
        assert plans.shape == (3, 6, 4) and plans.dtype == torch.int64
        assert (plans >= 0).all() and (plans < counts[:, None, None]).all()
        assert torch.equal(sel, TorchDraws(7, "cpu").select(rnd, 50, 5))
        assert torch.equal(plans, TorchDraws(7, "cpu").batch_plans(
            rnd, counts, 6, 4))
    assert not torch.equal(draws.batch_plans(1, counts, 6, 4),
                           draws.batch_plans(2, counts, 6, 4))


def test_replay_draws_match_the_reference_sampler():
    replay = ReplayDraws(seed=0)
    key = jax.random.fold_in(jax.random.key(0), 3)
    k_sel, _, _ = jax.random.split(key, 3)
    expected = np.asarray(sample_clients_jax(k_sel, 20, 6))
    np.testing.assert_array_equal(replay.select(3, 20, 6).numpy(), expected)
