"""The port's device fleets and attacks against the JAX package.

* The presets' invariants (tiers, corrupt counts, the promotion of every
  attacker to the fastest tier), which hold whatever the generator.
* ``participation`` and ``completion_time`` on a reference fleet carried
  across with ``repro_torch.convert.fleet_from_jax``, under the
  reference's own draws (``ReplayDraws``): masks and contributions
  exactly, completion times at rtol 1e-6 (``exp`` may round an ulp apart
  in XLA and PyTorch).
* Every attack on the port's flat ``[S, N]`` rows against the
  reference's attack on each client's parameter dict, raveled; the noise
  of ``random`` and ``colluding-alie`` rebuilt from the reference's
  keys.  Values at rtol 1e-6 (elementwise f32 arithmetic; a compiler may
  fuse a multiply-add), the colluding payloads at rtol 1e-5 (the cohort
  statistics sum in other orders), and honest rows bit for bit.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated import attacks as jattacks
from repro.federated import scenarios as jscen
from repro.utils.pytree import FlatSpec as JaxFlatSpec
from repro_torch.convert import fleet_from_jax
from repro_torch.federated import attacks, scenarios
from repro_torch.federated.draws import TorchDraws
from test_torch_support import ReplayDraws, fleet_arrays, numpy_params
from test_torch_support import one_torch_thread  # noqa: F401 (autouse)

PRESETS = ("uniform", "tiered-fleet", "byzantine", "byzantine-colluding")


def _fleet(preset, K=40, **kw):
    return scenarios.make_fleet(scenarios.ScenarioConfig(preset=preset, **kw),
                                K, device="cpu")


@pytest.mark.parametrize("K", [16, 371])
@pytest.mark.parametrize("preset", PRESETS)
def test_preset_invariants(preset, K):
    fleet = _fleet(preset, K, seed=3, period=12)
    assert fleet.num_clients == K and fleet.period == 12
    assert fleet.tier.dtype == fleet.phase.dtype == torch.int32
    for name in ("slowdown", "dropout_prob", "duty_cycle"):
        assert getattr(fleet, name).dtype == torch.float32
    tier = fleet.tier.long()
    assert set(tier.tolist()) <= {0, 1, 2}
    assert torch.equal(fleet.slowdown,
                       torch.tensor(scenarios.TIER_SLOWDOWN)[tier])
    assert ((fleet.phase >= 0) & (fleet.phase < 12)).all()
    if preset == "uniform":
        assert (tier == 0).all() and (fleet.dropout_prob == 0).all()
        assert (fleet.duty_cycle == 1).all() and (fleet.phase == 0).all()
        assert fleet.corrupt is None
        return
    base = _fleet("tiered-fleet", K, seed=3, period=12)
    honest = (torch.ones(K, dtype=torch.bool) if fleet.corrupt is None
              else fleet.corrupt == 0)
    # honest clients keep the tiered fleet's profile
    assert torch.equal(fleet.tier[honest], base.tier[honest])
    assert torch.equal(fleet.phase, base.phase)
    np.testing.assert_allclose(fleet.dropout_prob[honest],
                               0.02 * (1 + base.tier[honest].float()))
    np.testing.assert_allclose(fleet.duty_cycle[honest],
                               1.0 - 0.2 * base.tier[honest].float())
    if preset == "tiered-fleet":
        assert fleet.corrupt is None
        if K == 371:                     # 50/30/20 % tiers
            counts = torch.bincount(tier, minlength=3).float() / K
            np.testing.assert_allclose(counts, [0.5, 0.3, 0.2], atol=0.08)
        return
    bad = fleet.corrupt > 0
    assert set(fleet.corrupt.tolist()) <= {0.0, 1.0}
    assert int(bad.sum()) == math.ceil(0.25 * K)
    assert (tier[bad] == 0).all() and (fleet.slowdown[bad] == 1).all()
    assert (fleet.dropout_prob[bad] == 0).all()
    assert (fleet.duty_cycle[bad] == 1).all()
    want = "sign-flip" if preset == "byzantine" else "colluding-alie"
    assert fleet.attack == want and fleet.attack_scale == 1.0


def test_fleets_repeat_by_seed_and_device_placement():
    a, b = _fleet("byzantine", seed=5), _fleet("byzantine", seed=5)
    c = _fleet("byzantine", seed=6)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(va, vb) if isinstance(va, torch.Tensor) \
            else va == vb
    assert not torch.equal(a.corrupt, c.corrupt)
    moved = a.to("cpu")
    assert torch.equal(moved.corrupt, a.corrupt) and moved.attack == a.attack


def test_byzantine_colluding_keeps_a_colluding_attack_and_frac_zero_clears():
    fleet = _fleet("byzantine-colluding", attack="colluding-flip",
                   attack_scale=4.0)
    assert fleet.attack == "colluding-flip" and fleet.attack_scale == 4.0
    assert _fleet("byzantine", corrupt_frac=0.0).corrupt is None
    with pytest.raises(KeyError, match="available"):
        _fleet("byzantine", attack="no-such-attack")


def test_unported_and_unknown_presets_raise():
    for preset in ("mobile-heavy", "flaky-network", "churn", "diurnal",
                   "outage"):
        assert preset in jscen.PRESETS
        with pytest.raises(NotImplementedError, match=preset):
            scenarios.ScenarioConfig(preset=preset)
    with pytest.raises(NotImplementedError, match="bias_sampling"):
        scenarios.ScenarioConfig(bias_sampling=True)
    with pytest.raises(KeyError, match="available"):
        scenarios.make_fleet(scenarios.ScenarioConfig(preset="x"), 8, "cpu")
    assert set(scenarios.PRESETS) < set(jscen.PRESETS)


@pytest.mark.parametrize("preset", ["tiered-fleet", "byzantine"])
def test_participation_and_completion_time_match_the_reference(preset):
    K, S = 40, 12
    jfleet = jscen.make_fleet(jscen.ScenarioConfig(preset=preset, seed=1,
                                                   period=6), K)
    arrays, static = fleet_arrays(jfleet)
    fleet = fleet_from_jax(arrays, device="cpu", **static)
    replay = ReplayDraws(seed=2)
    base = jax.random.key(2)
    seen_drop = seen_off = False
    for rnd in range(1, 9):
        sel = replay.select(rnd, K, S)
        jsel = jnp.asarray(sel.numpy().astype(np.int32))
        key = jax.random.fold_in(base, jnp.int32(rnd))
        _, _, k_scen = jax.random.split(key, 3)
        jmask, jcontrib = jscen.participation(jfleet, jsel, jnp.int32(rnd),
                                              k_scen)
        jdt = jscen.completion_time(jfleet, jsel, jax.random.fold_in(key, 3))

        drop = replay.dropout(rnd, fleet.dropout_prob[sel])
        mask, contrib = scenarios.participation(fleet, sel, rnd, drop)
        dt = scenarios.completion_time(fleet, sel,
                                       replay.completion_eps(rnd, S))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(contrib.numpy(), np.asarray(jcontrib))
        np.testing.assert_allclose(dt.numpy(), np.asarray(jdt), rtol=1e-6)
        seen_drop |= bool(drop.sum() > 0)
        seen_off |= bool((mask == 0).sum() > drop.sum())
    assert seen_drop and seen_off      # both gates were exercised


# ---------------------------------------------------------------------------
# Attacks
# ---------------------------------------------------------------------------

def _wave(S=6, seed=0):
    """A small MLP's global parameters and ``S`` trained copies, as
    reference dicts and as port flat tensors, and a corrupt mask."""
    g = numpy_params("mlp", 8, seed)
    rng = np.random.default_rng(seed + 1)
    trained = {k: (v[None] + 0.1 * rng.standard_normal((S,) + v.shape))
               .astype(np.float32) for k, v in g.items()}
    corrupt = np.asarray([1, 0, 1, 0, 0, 1][:S], np.float32)
    spec = JaxFlatSpec({k: jnp.asarray(v) for k, v in g.items()})
    flat_g = torch.from_numpy(np.array(spec.ravel(g)))
    flat_t = torch.from_numpy(np.stack([
        np.asarray(spec.ravel({k: v[s] for k, v in trained.items()}))
        for s in range(S)]))
    shapes = [g[k].shape for k in sorted(g)]
    return g, trained, corrupt, spec, flat_g, flat_t, shapes


def _ravel_rows(spec, tree, S):
    return np.stack([np.asarray(spec.ravel({k: v[s] for k, v in
                                            tree.items()}))
                     for s in range(S)])


@pytest.mark.parametrize("name,scale", [("sign-flip", 1.0), ("sign-flip", 3.0),
                                        ("scale", 5.0), ("random", 0.5)])
def test_static_attacks_match_the_reference(name, scale):
    S, rnd = 6, 4
    g, trained, corrupt, spec, flat_g, flat_t, shapes = _wave(S)
    keys = jax.random.split(jax.random.fold_in(
        jax.random.fold_in(jax.random.key(0), jnp.int32(rnd)), 4), S)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    jout = jax.vmap(lambda p, c, k: jattacks.apply_attack(
        name, p, jg, c, scale, k))(
        {k: jnp.asarray(v) for k, v in trained.items()},
        jnp.asarray(corrupt), keys)
    want = _ravel_rows(spec, jout, S)

    noise = (ReplayDraws(0, noise_leaves=shapes).attack_noise(
        rnd, S, flat_t.shape[1]) if name in attacks.NOISY else None)
    out = attacks.apply_attack(name, flat_t, flat_g, torch.from_numpy(corrupt),
                               scale, noise)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-7)
    honest = corrupt == 0
    assert torch.equal(out[honest], flat_t[honest])
    assert not torch.equal(out[~honest], flat_t[~honest])


@pytest.mark.parametrize("name,scale", [("colluding-flip", 4.0),
                                        ("colluding-alie", 1.5)])
def test_colluding_attacks_match_the_reference(name, scale):
    """The reference's flat path pools the corrupt rows' deltas
    (``cohort_stats``) and swaps each payload in, one key per client."""
    S, rnd = 6, 2
    _, _, corrupt, _, flat_g, flat_t, _ = _wave(S, seed=3)
    jg, jt, jc = (jnp.asarray(flat_g.numpy()), jnp.asarray(flat_t.numpy()),
                  jnp.asarray(corrupt))
    mu, sigma = jattacks.cohort_stats(jt - jg[None], jc, total=jnp.sum(jc))
    keys = jax.random.split(jax.random.fold_in(
        jax.random.fold_in(jax.random.key(0), jnp.int32(rnd)), 4), S)
    want = jax.vmap(lambda p, c, k: jattacks.apply_colluding_attack(
        name, p, jg, c, scale, k, mu, sigma))(jt, jc, keys)

    t_mu, t_sigma = attacks.cohort_stats(flat_t - flat_g[None],
                                         torch.from_numpy(corrupt))
    np.testing.assert_allclose(t_mu.numpy(), np.asarray(mu), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(t_sigma.numpy(), np.asarray(sigma), rtol=1e-5,
                               atol=1e-6)
    noise = (ReplayDraws(0).attack_noise(rnd, S, flat_t.shape[1])
             if name in attacks.NOISY else None)
    out = attacks.apply_colluding_attack(name, flat_t, flat_g,
                                         torch.from_numpy(corrupt), scale,
                                         noise, t_mu, t_sigma)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    honest = corrupt == 0
    assert torch.equal(out[honest], flat_t[honest])


def test_cohort_stats_match_the_reference_and_numpy():
    rng = np.random.default_rng(7)
    delta = rng.standard_normal((9, 50)).astype(np.float32)
    corrupt = (rng.uniform(size=9) < 0.5).astype(np.float32)
    mu, sigma = attacks.cohort_stats(torch.from_numpy(delta),
                                     torch.from_numpy(corrupt))
    j_mu, j_sigma = jattacks.cohort_stats(jnp.asarray(delta),
                                          jnp.asarray(corrupt))
    np.testing.assert_allclose(mu.numpy(), np.asarray(j_mu), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(j_sigma), rtol=1e-5,
                               atol=1e-6)
    rows = delta[corrupt > 0]
    np.testing.assert_allclose(mu.numpy(), rows.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), rows.std(0), rtol=1e-4,
                               atol=1e-5)
    none = attacks.cohort_stats(torch.from_numpy(delta), torch.zeros(9))
    assert all(torch.equal(t, torch.zeros(50)) for t in none)


def test_attack_registries_and_corrupt_fleet():
    assert attacks.ATTACKS.keys() == jattacks.ATTACKS.keys()
    assert attacks.COLLUDING.keys() == jattacks.COLLUDING.keys()
    assert attacks.ALIE_JITTER == jattacks.ALIE_JITTER
    for name in ("sign-flip", "colluding-alie"):
        attacks.validate_attack(name)
    with pytest.raises(KeyError, match="available"):
        attacks.validate_attack("nope")
    base = _fleet("tiered-fleet", K=20)
    hit = attacks.corrupt_fleet(base, 0.3, attack="scale", scale=2.0, seed=4)
    assert int(hit.corrupt.sum()) == 6 and hit.attack == "scale"
    assert hit.attack_scale == 2.0
    assert attacks.corrupt_fleet(hit, 0.0).corrupt is None
    with pytest.raises(ValueError, match="out of range"):
        attacks.corrupt_fleet(base, 1.5)


def test_torch_draws_give_the_hostile_draws():
    draws = TorchDraws(seed=3, device="cpu")
    probs = torch.tensor([0.0, 1.0, 0.5, 0.5])
    drop = draws.dropout(1, probs)
    assert drop.dtype == torch.float32 and drop[0] == 0 and drop[1] == 1
    assert torch.equal(drop, TorchDraws(3, "cpu").dropout(1, probs))
    eps = draws.completion_eps(1, 5)
    assert eps.shape == (5,) and torch.equal(eps, draws.completion_eps(1, 5))
    assert not torch.equal(eps, draws.completion_eps(2, 5))
    noise = draws.attack_noise(1, 3, 7)
    assert noise.shape == (3, 7) and noise.dtype == torch.float32
    assert torch.equal(noise, draws.attack_noise(1, 3, 7))
