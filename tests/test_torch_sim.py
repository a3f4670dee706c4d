"""The slice as a whole: the port's synchronous round against a live run
of the JAX package on the same data, weights and draws.

Both sides get byte-equal SynthFEMNIST, the same numpy weights (through
``repro_torch.convert``) and the same per-round draws (the port under
:class:`test_torch_support.ReplayDraws`).  The reference runs its flat
path (``flat_params=True``), whose commit and divergence are the Pallas
kernels' jnp/BLAS forms on the CPU; the port runs the plain versions of
its CUDA kernels.  The recorded goldens in ``tests/golden`` are not
used: they no longer match the installed jax.

Tolerances, with their reasons:

* final flat parameters at rtol 1e-4 / atol 1e-5: every local SGD step
  of every client sums in another order in XLA and PyTorch (f32, a few
  1e-7 relative per step), and the gap grows over the run's steps (the
  largest gap measured on these cases was 2.4e-7 absolute);
* ``global_acc`` and ``weights_entropy`` at rtol 1e-5: the accuracies
  are ratios of equal counts unless an argmax flips, and the entropy is
  a sum of a few f32 terms;
* the round counters (``participants``, ``sim_time``, ``commits``) and
  ``rounds_to_target`` exactly, but for the hostile runs' ``sim_time``
  (rtol 1e-6: it passes through ``exp``).

The hostile runs hold the port's trimmed mean to the reference's on
inputs that agree only to rtol ~1e-7, so a coordinate where two clients'
values nearly tie could be trimmed differently on the two sides; no such
flip occurs at these sizes and round counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AggregationConfig as JaxAggregationConfig
from repro.data.synthetic import make_synth_femnist as jax_make_data
from repro.federated import simulation as jsim
from repro.federated.engine import make_strategy as jax_make_strategy
from repro.federated.scenarios import ScenarioConfig as JaxScenarioConfig
from repro.models import cnn as jcnn
from repro.models import mlp as jmlp
from repro.utils.pytree import FlatSpec as JaxFlatSpec
from repro_torch.convert import fleet_from_jax, params_from_jax
from repro_torch.core.aggregate import AggregationConfig
from repro_torch.data.synthetic import make_synth_femnist
from repro_torch.federated import simulation as tsim
from repro_torch.federated.engine import make_strategy
from repro_torch.federated.scenarios import ScenarioConfig
from repro_torch.kernels import divergence as kdiv
from repro_torch.kernels import krum as kkrum
from repro_torch.kernels import trimmed as ktrim
from repro_torch.kernels import weighted_agg as kagg
from repro_torch.models import cnn, mlp
from test_torch_support import ReplayDraws, fleet_arrays, numpy_params
from test_torch_support import one_torch_thread  # noqa: F401 (autouse)

MODELS = {
    "cnn": (jcnn.cnn_loss, jcnn.cnn_accuracy, cnn.cnn_loss, cnn.cnn_accuracy),
    "mlp": (jmlp.mlp_loss, jmlp.mlp_accuracy, mlp.mlp_loss, mlp.mlp_accuracy),
}

# The slice's CNN case, and the engine-golden MLP case
# (tests/golden/engine_uniform.json's config without its scenario), whose
# accuracy is far from zero.
CASES = {
    "cnn": dict(model="cnn", hidden=16, num_clients=8, mean_samples=8,
                data_seed=0, fraction=0.5, batch_size=4, local_epochs=1,
                lr=0.1, max_rounds=2, eval_every=1, priority=(2, 0, 1)),
    "mlp": dict(model="mlp", hidden=48, num_clients=16, mean_samples=24,
                data_seed=3, fraction=0.25, batch_size=8, local_epochs=2,
                lr=0.1, max_rounds=6, eval_every=2, priority=(2, 0, 1)),
}
TARGETS, FRACS = (0.2, 0.3), (0.1, 0.3)


# The hostile round: the robust study's configurations
# (benchmarks/roundloop.py's `robust` section), at test size.  Each runs
# on the MLP at hidden 48 (16 clients, fraction 0.5, so S = 8) and on a
# small CNN (12 clients, fraction 0.5, so S = 6).
HOSTILE = {
    "trimmed-mean": dict(preset="byzantine", attack="sign-flip",
                         attack_scale=1.0, strategy="trimmed-mean",
                         kwargs=dict(trim=2)),
    "krum": dict(preset="byzantine-colluding", attack="colluding-flip",
                 attack_scale=4.0, strategy="krum", kwargs={}),
    "multi-krum": dict(preset="byzantine-colluding",
                       attack="colluding-flip", attack_scale=4.0,
                       strategy="multi-krum", kwargs={}),
}
HOSTILE_CASES = {
    "mlp": dict(CASES["mlp"], fraction=0.5, max_rounds=4),
    "cnn": dict(CASES["cnn"], num_clients=12, max_rounds=2),
}


def _run_both(case, hostile=None):
    """A live reference run on its flat path and a port run on the CPU,
    with the same data, weights and draws (and, for a ``hostile`` case,
    the reference's own fleet carried across)."""
    jloss, jacc, tloss, tacc = MODELS[case["model"]]
    np_params = numpy_params(case["model"], case["hidden"], seed=0)
    hyper = {k: case[k] for k in ("fraction", "batch_size", "local_epochs",
                                  "lr", "max_rounds", "eval_every")}
    data_args = dict(num_clients=case["num_clients"],
                     mean_samples=case["mean_samples"],
                     seed=case["data_seed"])
    jextra, textra = {}, {}
    if hostile is not None:
        scen = {k: hostile[k] for k in ("preset", "attack", "attack_scale")}
        jextra = dict(scenario=JaxScenarioConfig(**scen, seed=0),
                      strategy=jax_make_strategy(hostile["strategy"],
                                                 **hostile["kwargs"]))
        textra = dict(scenario=ScenarioConfig(**scen, seed=0),
                      strategy=make_strategy(hostile["strategy"],
                                             **hostile["kwargs"]))

    jcfg = jsim.FedSimConfig(
        **hyper, seed=0, flat_params=True,
        aggregation=JaxAggregationConfig(priority=case["priority"]),
        **jextra)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    jsim_run = jsim.FederatedSimulation(jax_make_data(**data_args), jparams,
                                        jloss, jacc, jcfg)
    ref = jsim_run.run(targets=TARGETS, device_fracs=FRACS, verbose=False)

    tcfg = tsim.FedSimConfig(
        **hyper, seed=0,
        aggregation=AggregationConfig(priority=case["priority"]), **textra)
    fleet = None
    if hostile is not None:
        arrays, static = fleet_arrays(jsim_run.fleet)
        fleet = fleet_from_jax(arrays, device="cpu", **static)
    port = tsim.FederatedSimulation(
        make_synth_femnist(**data_args),
        params_from_jax(np_params, device="cpu"), tloss, tacc, tcfg,
        draws=ReplayDraws(seed=0), fleet=fleet, device="cpu").run(
        targets=TARGETS, device_fracs=FRACS, verbose=False)
    return ref, port


def _assert_same_run(ref, port, sim_time_rtol=0.0):
    assert [m.round for m in port.metrics] == [m.round for m in ref.metrics]
    for rm, pm in zip(ref.metrics, port.metrics):
        assert pm.participants == rm.participants
        np.testing.assert_allclose(pm.sim_time, rm.sim_time,
                                   rtol=sim_time_rtol, atol=0.0)
        assert pm.commits == rm.commits
        assert pm.frac_above == rm.frac_above
        np.testing.assert_allclose(pm.global_acc, rm.global_acc, rtol=1e-5)
        np.testing.assert_allclose(pm.weights_entropy, rm.weights_entropy,
                                   rtol=1e-5)
    assert port.rounds_to_target == ref.rounds_to_target

    jspec = JaxFlatSpec(ref.final_params)
    np.testing.assert_allclose(port.final_state.params.numpy(),
                               np.asarray(jspec.ravel(ref.final_params)),
                               rtol=1e-4, atol=1e-5)
    for k, v in ref.final_params.items():
        assert port.final_params[k].shape == v.shape


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_round_matches_live_reference(case):
    launches = (kagg.weighted_agg.launches, kdiv.divergence_sq.launches)
    ref, port = _run_both(CASES[case])
    _assert_same_run(ref, port)
    # on the CPU the commit and Md run the plain versions, not the kernels
    assert (kagg.weighted_agg.launches,
            kdiv.divergence_sq.launches) == launches


@pytest.mark.parametrize("strategy", sorted(HOSTILE))
@pytest.mark.parametrize("case", sorted(HOSTILE_CASES))
def test_hostile_round_matches_live_reference(case, strategy):
    """The reference's byzantine fleet, attack and robust strategy against
    the port's, run for run.  The virtual clock passes through ``exp``
    (the completion times), which XLA and PyTorch round apart by an ulp:
    ``sim_time`` at rtol 1e-6."""
    launches = (kagg.weighted_agg.launches, kdiv.divergence_sq.launches,
                ktrim.trimmed_agg.launches,
                kkrum.pairwise_sq_dists.launches)
    ref, port = _run_both(HOSTILE_CASES[case], HOSTILE[strategy])
    _assert_same_run(ref, port, sim_time_rtol=1e-6)
    assert (kagg.weighted_agg.launches, kdiv.divergence_sq.launches,
            ktrim.trimmed_agg.launches,
            kkrum.pairwise_sq_dists.launches) == launches


def test_torch_draws_run_the_slice():
    """The package's own draws: a run that learns, with the counters of
    a synchronous round and finite metrics."""
    data = make_synth_femnist(num_clients=16, mean_samples=24, seed=3)
    params = params_from_jax(numpy_params("mlp", 48, seed=0), device="cpu")
    cfg = tsim.FedSimConfig(fraction=0.25, batch_size=8, local_epochs=2,
                            lr=0.1, max_rounds=4, eval_every=2, seed=5)
    sim = tsim.FederatedSimulation(data, params, mlp.mlp_loss,
                                   mlp.mlp_accuracy, cfg, device="cpu")
    res = sim.run(targets=(0.99,), device_fracs=(0.99,), verbose=False)
    assert [m.round for m in res.metrics] == [2, 4]
    assert [m.commits for m in res.metrics] == [2, 4]
    assert [m.sim_time for m in res.metrics] == [2.0, 4.0]
    assert all(m.participants == 4 for m in res.metrics)
    assert all(np.isfinite(m.weights_entropy) and 0 < m.weights_entropy
               <= np.log(4) + 1e-6 for m in res.metrics)
    assert res.metrics[-1].global_acc > 0.05
    assert res.rounds_to_target == {(0.99, 0.99): None}
    last = res.final_state.last_sync
    assert int((last == 4).sum()) == 4 and int(last.max()) == 4
    assert torch.isfinite(res.final_state.params).all()


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        tsim.FedSimConfig(online_adjust=True)
    with pytest.raises(TypeError):
        tsim.FedSimConfig(compress="int8")
    with pytest.raises(NotImplementedError, match="churn"):
        tsim.FedSimConfig(scenario=ScenarioConfig(preset="churn"))
    with pytest.raises(NotImplementedError, match="bias_sampling"):
        tsim.FedSimConfig(scenario=ScenarioConfig(preset="tiered-fleet",
                                                  bias_sampling=True))
    with pytest.raises(KeyError, match="available"):
        tsim.FedSimConfig(strategy=make_strategy("clipped-dp"))
