"""The port's paper core (operators, criteria, weights, the commit)
against ``repro.core`` on the same numpy inputs.

All values are small f32 vectors; the operators agree at rtol 1e-6 (a
few f32 operations each).  The commit is a sum over K clients taken in
another order than the reference's BLAS matvec: rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregate as jagg
from repro.core import criteria as jcrit
from repro.core import operators as jops
from repro_torch.core import aggregate as tagg
from repro_torch.core import criteria as tcrit
from repro_torch.core import operators as tops

TOL = dict(rtol=1e-6, atol=1e-7)


def _criteria(K, m, seed):
    c = np.random.default_rng(seed).uniform(0, 1, (K, m)).astype(np.float32)
    c[0, 1] = 0.0                       # an unfulfilled criterion
    return c


def test_all_permutations_in_reference_order():
    for m in (1, 2, 3, 4):
        assert tops.all_permutations(m) == jops.all_permutations(m)


@pytest.mark.parametrize("priority", jops.all_permutations(3))
def test_prioritized_score(priority):
    c = _criteria(9, 3, seed=1)
    np.testing.assert_allclose(
        tops.prioritized_score(torch.from_numpy(c), priority).numpy(),
        np.asarray(jops.prioritized_score(jnp.asarray(c), priority)), **TOL)
    np.testing.assert_allclose(
        tops.prioritized_score(torch.from_numpy(c[2]), priority).numpy(),
        np.asarray(jops.prioritized_score(jnp.asarray(c[2]), priority)),
        **TOL)


def test_other_operators():
    c = _criteria(7, 3, seed=2)
    tc, jc = torch.from_numpy(c), jnp.asarray(c)
    imp = np.array([3.0, 1.0, 2.0], np.float32)
    np.testing.assert_allclose(
        tops.weighted_average_score(tc, torch.from_numpy(imp)).numpy(),
        np.asarray(jops.weighted_average_score(jc, jnp.asarray(imp))), **TOL)
    for alpha in (0.5, 2.0):
        tw = tops.owa_quantifier_weights(3, alpha)
        np.testing.assert_allclose(
            tw.numpy(), np.asarray(jops.owa_quantifier_weights(3, alpha)),
            **TOL)
        np.testing.assert_allclose(
            tops.owa_score(tc, tw).numpy(),
            np.asarray(jops.owa_score(jc, jops.owa_quantifier_weights(
                3, alpha))), **TOL)
    for lam in (-0.5, 0.0, 2.0):
        mu = tops.lambda_fuzzy_measure((0.2, 0.5, 0.3), lam)
        jmu = jops.lambda_fuzzy_measure((0.2, 0.5, 0.3), lam)
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **TOL)
        np.testing.assert_allclose(tops.choquet_score(tc, mu).numpy(),
                                   np.asarray(jops.choquet_score(jc, jmu)),
                                   **TOL)


@pytest.mark.parametrize("scores", [[0.2, 0.0, 0.5, 0.3], [0.0, 0.0, 0.0]])
def test_scores_to_weights(scores):
    s = np.asarray(scores, np.float32)
    np.testing.assert_allclose(
        tops.scores_to_weights(torch.from_numpy(s)).numpy(),
        np.asarray(jops.scores_to_weights(jnp.asarray(s))), **TOL)


def _context(S, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(8, 300, S).astype(np.int32)
    labels = (rng.integers(0, 4, (S, 62))
              * (rng.uniform(size=(S, 62)) < 0.3)).astype(np.float32)
    sq = rng.uniform(0, 50, S).astype(np.float32)
    return counts, labels, sq


@pytest.mark.parametrize("mask", [None, [1, 0, 1, 1, 0, 1]])
def test_criteria_and_normalization(mask):
    names = ("Ds", "Ld", "Md")
    counts, labels, sq = _context(6, seed=3)
    ctx = jcrit.ClientContext(num_examples=jnp.asarray(counts),
                              label_counts=jnp.asarray(labels),
                              update_sq_norm=jnp.asarray(sq))
    raw = jax.vmap(lambda c: jcrit.measure_criteria(names, c))(ctx)
    traw = tcrit.measure_criteria(names, tcrit.ClientContext(
        num_examples=torch.from_numpy(counts),
        label_counts=torch.from_numpy(labels),
        update_sq_norm=torch.from_numpy(sq)))
    np.testing.assert_allclose(traw.numpy(), np.asarray(raw), **TOL)
    m = None if mask is None else np.asarray(mask, np.float32)
    expected = jcrit.normalize_criteria(raw, None if m is None
                                        else jnp.asarray(m))
    got = tcrit.normalize_criteria(traw, None if m is None
                                   else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)
    # a degenerate all-zero column falls back to uniform over participants
    zero = np.zeros(6, np.float32)
    np.testing.assert_allclose(
        tcrit.normalize_criteria(torch.from_numpy(zero),
                                 None if m is None else torch.from_numpy(m)
                                 ).numpy(),
        np.asarray(jcrit.normalize_criteria(
            jnp.asarray(zero), None if m is None else jnp.asarray(m))),
        **TOL)


def test_criteria_registry():
    assert tcrit.criterion_needs("Md") == ("update",)
    assert tcrit.criterion_needs("Ds") == () == tcrit.criterion_needs("Ld")
    assert tcrit.get_criterion("Md") is tcrit.model_divergence
    with pytest.raises(KeyError):
        tcrit.get_criterion("nope")
    with pytest.raises(ValueError):
        tcrit.register_criterion("dataset_size", tcrit.dataset_size)


@pytest.mark.parametrize("operator", ["prioritized", "weighted_average",
                                      "owa", "choquet"])
@pytest.mark.parametrize("mask", [None, [1.0, 0.0, 0.5, 1.0, 1.0],
                                  [0.0] * 5])
def test_compute_weights(operator, mask):
    c = _criteria(5, 3, seed=4)
    cfg_args = dict(operator=operator, priority=(2, 0, 1))
    m = None if mask is None else np.asarray(mask, np.float32)
    expected = jagg.compute_weights(
        jnp.asarray(c), jagg.AggregationConfig(**cfg_args),
        mask=None if m is None else jnp.asarray(m))
    got = tagg.compute_weights(
        torch.from_numpy(c), tagg.AggregationConfig(**cfg_args),
        mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


def test_aggregate_models_flat():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 1000)).astype(np.float32)
    p = rng.uniform(size=6).astype(np.float32)
    p /= p.sum()
    expected = jagg.aggregate_models(jnp.asarray(x), jnp.asarray(p))
    got = tagg.aggregate_models(torch.from_numpy(x), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError):
        tagg.aggregate_models({"w": torch.from_numpy(x)}, torch.from_numpy(p))
