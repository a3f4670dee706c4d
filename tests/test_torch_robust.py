"""The port's robust reductions and strategies against the JAX package.

On the same numpy-made inputs, each port function is held to its JAX
counterpart: the Pallas kernels run in interpret mode (as
``tests/test_robust.py`` runs them) and the jnp oracles of
``repro.kernels.ref``.  On the CPU the port runs the plain versions of
its CUDA kernels (``kernels.ops`` dispatches by the tensor's device).

Tolerances, with their reasons:

* f32 values (aggregates, Gram entries, scores) at rtol 1e-5: the sums
  run in other orders on the two sides;
* squared distances at ``atol = 1e-5 * max_i G[i, i]``: they come from
  the Gram identity ``G_ii + G_jj - 2 G_ij``, whose cancellation leaves
  an absolute error of order ``eps * ||x||^2``;
* keep sets and selections exactly.  The trimmed mean is discontinuous
  where two values tie, so it is held to the reference on identical
  inputs; the duplicate-heavy cases give every client a distinct
  power-of-two weight, which makes any difference in the trimmed rows
  change the result by far more than the tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _attacks import hostile_matrix
from _propcheck import given, settings, st
from repro.core import AggregationConfig as JaxAggregationConfig
from repro.core import compute_weights as jcompute_weights
from repro.federated import engine as jengine
from repro.kernels import krum as jkrum
from repro.kernels import ref as jref
from repro.kernels.trimmed import trimmed_agg as pallas_trimmed_agg
from repro_torch.core.aggregate import AggregationConfig
from repro_torch.federated import engine
from repro_torch.kernels import krum, ops, ref
from test_torch_support import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-5, atol=1e-6)


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _weights(rng, S):
    w = rng.uniform(0.1, 1.0, S).astype(np.float32)
    return w / w.sum()


# ---------------------------------------------------------------------------
# K4 · trimmed mean
# ---------------------------------------------------------------------------

def _trimmed_cases():
    rng = np.random.default_rng(0)
    cases = {}
    for S, N, trim in ((3, 1, 1), (5, 300, 0), (8, 257, 2), (37, 1000, 9)):
        cases[f"random-S{S}-N{N}-trim{trim}"] = (
            rng.standard_normal((S, N)).astype(np.float32),
            _weights(rng, S), trim)
    # duplicate-heavy columns with distinct power-of-two weights: the
    # result tells which rows were trimmed
    for S, trim in ((8, 3), (12, 5)):
        x = rng.integers(-2, 3, size=(S, 96)).astype(np.float32)
        w = (2.0 ** np.arange(S)).astype(np.float32)
        cases[f"ties-S{S}-trim{trim}"] = (x, w / w.sum(), trim)
    cases["all-equal"] = (np.ones((7, 5), np.float32), _weights(rng, 7), 3)
    return cases


TRIMMED = _trimmed_cases()


@pytest.mark.parametrize("name", sorted(TRIMMED))
def test_trimmed_plain_matches_pallas_and_oracle(name):
    x, w, trim = TRIMMED[name]
    out = ops.flat_trimmed_agg(_t(x), _t(w), trim)
    assert out.dtype == torch.float32 and out.shape == (x.shape[1],)
    want = _np(pallas_trimmed_agg(jnp.asarray(x), jnp.asarray(w), trim,
                                  interpret=True))
    np.testing.assert_allclose(out.numpy(), want, **F32)
    np.testing.assert_allclose(
        out.numpy(), _np(jref.trimmed_agg_ref(jnp.asarray(x),
                                              jnp.asarray(w), trim)), **F32)


NONFINITE = np.asarray([[np.nan, 0.0, -1.0, 1.0, 4.0],
                        [1.0, -0.0, -np.inf, 2.0, 1.0],
                        [2.0, 0.0, 3.0, np.nan, 2.0],
                        [-3.0, -0.0, np.inf, np.nan, 3.0],
                        [5.0, 0.0, 0.5, 0.25, np.inf]], np.float32)


def test_trimmed_nonfinite_values_match_the_reference():
    """A NaN anywhere in a column, or a trimmed inf, makes that column
    NaN (``x * 0`` over every row, as ``trimmed.py:44-48`` sums); signed
    zeros tie."""
    w = np.asarray([0.1, 0.3, 0.2, 0.25, 0.15], np.float32)
    out = ops.flat_trimmed_agg(_t(NONFINITE), _t(w), 1).numpy()
    for want in (pallas_trimmed_agg(jnp.asarray(NONFINITE), jnp.asarray(w),
                                    1, interpret=True),
                 jref.trimmed_agg_ref(jnp.asarray(NONFINITE),
                                      jnp.asarray(w), 1)):
        np.testing.assert_allclose(out, _np(want), **F32)
    assert np.isnan(out[[0, 2, 3, 4]]).all() and out[1] == 0.0


def test_trimmed_zero_surviving_weight_falls_back_to_kept_mean():
    x = np.asarray([[0.0], [1.0], [2.0], [3.0], [4.0]], np.float32)
    w = np.asarray([0.5, 0.0, 0.0, 0.0, 0.5], np.float32)
    out = ops.flat_trimmed_agg(_t(x), _t(w), 1)
    np.testing.assert_allclose(out.numpy(), [2.0], rtol=1e-6)
    np.testing.assert_allclose(
        out.numpy(), _np(pallas_trimmed_agg(jnp.asarray(x), jnp.asarray(w),
                                            1, interpret=True)), rtol=1e-6)


def test_trimmed_trim_zero_is_the_weighted_mean():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 33)).astype(np.float32)
    w = _weights(rng, 5)
    out = ops.flat_trimmed_agg(_t(x), _t(w), 0)
    np.testing.assert_allclose(out.numpy(), w @ x, **F32)


def test_trimmed_bf16_keeps_its_dtype():
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((9, 130))).to(torch.bfloat16)
    w = _t(_weights(rng, 9))
    out = ops.flat_trimmed_agg(x, w, 2)
    assert out.dtype == torch.bfloat16
    want = _np(jref.trimmed_agg_ref(jnp.asarray(x.float().numpy()),
                                    jnp.asarray(w.numpy()), 2))
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("S,trim", [(4, 2), (5, 3), (3, -1)])
def test_invalid_trim_raises_like_the_reference(S, trim):
    x, w = torch.zeros((S, 8)), torch.full((S,), 1.0 / S)
    with pytest.raises(ValueError):
        jref.trimmed_agg_ref(jnp.zeros((S, 8)), jnp.full((S,), 1.0 / S), trim)
    with pytest.raises(ValueError, match="2\\*trim"):
        ops.flat_trimmed_agg(x, w, trim)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000), st.integers(5, 9), st.integers(1, 2),
       st.integers(0, 2))
def test_trimmed_breakdown_point_property(seed, S, trim, raw_bad):
    """Up to ``trim`` outliers per coordinate cannot drag the commit
    outside the honest value range."""
    trim = min(trim, (S - 1) // 2)
    x, honest = hostile_matrix(seed, S, 32, min(raw_bad, trim), outlier=1e4)
    w = _weights(np.random.default_rng(seed + 1), S)
    out = ops.flat_trimmed_agg(_t(x), _t(w), trim).numpy()
    assert np.all(out >= x[honest].min(axis=0) - 1e-5)
    assert np.all(out <= x[honest].max(axis=0) + 1e-5)


# ---------------------------------------------------------------------------
# K5 · pairwise squared distances and Krum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,N", [(1, 1), (3, 257), (8, 1000), (37, 500),
                                 (40, 130)])
def test_sq_dists_plain_matches_pallas(S, N):
    rng = np.random.default_rng(S * 7 + N)
    x = rng.standard_normal((S, N)).astype(np.float32)
    gram = _t(x) @ _t(x).T
    np.testing.assert_allclose(gram.numpy(), x.astype(np.float64)
                               @ x.T.astype(np.float64), rtol=1e-5,
                               atol=1e-5 * N ** 0.5)
    d2 = krum.gram_sq_dists(gram)
    assert d2.shape == (S, S) and torch.equal(torch.diagonal(d2),
                                              torch.zeros(S))
    atol = 1e-5 * float(torch.diagonal(gram).max())
    want = _np(jkrum.pairwise_sq_dists(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(d2.numpy(), want, rtol=1e-5, atol=atol)
    explicit = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d2.numpy(), explicit, rtol=1e-5, atol=atol)


KRUM = [(6, 40, 1), (16, 300, 5), (37, 200, 17)]


@pytest.mark.parametrize("S,N,f", KRUM)
@pytest.mark.parametrize("multi", [False, True], ids=["krum", "multi"])
def test_krum_matches_pallas_and_oracle(S, N, f, multi):
    rng = np.random.default_rng(S + N + f)
    x = rng.standard_normal((S, N)).astype(np.float32)
    w = _weights(rng, S)
    m = S - f - 2 if multi else 1
    out, scores = ops.flat_krum_agg(_t(x), _t(w), f, m)
    k_out, k_scores = jkrum.krum_agg(jnp.asarray(x), jnp.asarray(w), f, m,
                                     interpret=True)
    np.testing.assert_allclose(scores.numpy(), _np(k_scores), **F32)
    np.testing.assert_allclose(out.numpy(), _np(k_out), **F32)
    # the same clients selected, exactly
    sel = np.sort(torch.sort(scores, stable=True).indices[:m].numpy())
    np.testing.assert_array_equal(sel, np.sort(np.argsort(_np(k_scores),
                                                          kind="stable")[:m]))
    r_out, r_scores = jref.krum_agg_ref(jnp.asarray(x), jnp.asarray(w), f, m)
    np.testing.assert_allclose(scores.numpy(), _np(r_scores), **F32)
    np.testing.assert_allclose(out.numpy(), _np(r_out), **F32)


@pytest.mark.parametrize("S,N,f", KRUM)
def test_plain_versions_match_the_oracles(S, N, f):
    """``krum_agg_ref`` and ``trimmed_agg_ref`` against
    ``repro.kernels.ref`` on the same inputs."""
    rng = np.random.default_rng(S * N)
    x = rng.standard_normal((S, N)).astype(np.float32)
    w = _weights(rng, S)
    for m in (1, S - f - 2):
        out, scores = ref.krum_agg_ref(_t(x), _t(w), f, m)
        j_out, j_scores = jref.krum_agg_ref(jnp.asarray(x), jnp.asarray(w),
                                            f, m)
        np.testing.assert_allclose(scores.numpy(), _np(j_scores), **F32)
        np.testing.assert_allclose(out.numpy(), _np(j_out), **F32)
    trim = (S - 1) // 4
    np.testing.assert_allclose(
        ref.trimmed_agg_ref(_t(x), _t(w), trim).numpy(),
        _np(jref.trimmed_agg_ref(jnp.asarray(x), jnp.asarray(w), trim)),
        **F32)


def test_zero_weight_rows_are_never_selected():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    w = np.asarray([1, 1, 0, 1, 1, 0, 1, 1], np.float32)
    w = w / w.sum()
    for fn in (ops.flat_krum_agg, ref.krum_agg_ref):
        out, scores = fn(_t(x), _t(w), 1, 5)
        assert torch.isinf(scores[[2, 5]]).all()
        assert torch.isfinite(scores[[0, 1, 3, 4, 6, 7]]).all()
        _, sel = krum.krum_select(scores, _t(w), 5)
        assert sel[[2, 5]].sum() == 0 and sel.sum() == 5


def test_krum_select_breaks_ties_toward_the_lower_index():
    scores = torch.tensor([3.0, 1.0, 1.0, 0.5, 1.0, torch.inf])
    w = torch.full((6,), 1.0 / 6)
    _, sel = krum.krum_select(scores, w, 3)
    np.testing.assert_array_equal(sel.numpy(), [0, 1, 1, 1, 0, 0])
    j_wsel, j_sel = jkrum.krum_select(jnp.asarray(scores.numpy()),
                                      jnp.asarray(w.numpy()), 3)
    np.testing.assert_array_equal(sel.numpy(), _np(j_sel))


def test_starved_selection_gives_the_zero_vector():
    x = np.random.default_rng(5).standard_normal((5, 9)).astype(np.float32)
    w = np.zeros(5, np.float32)
    out, scores = ops.flat_krum_agg(_t(x), _t(w), 0, 2)
    assert torch.equal(out, torch.zeros(9)) and torch.isinf(scores).all()
    j_out, _ = jkrum.krum_agg(jnp.asarray(x), jnp.asarray(w), 0, 2,
                              interpret=True)
    np.testing.assert_array_equal(out.numpy(), _np(j_out))


@pytest.mark.parametrize("S,f,m", [(6, 4, 1), (6, 1, 0), (6, 1, 7)])
def test_invalid_f_and_m_raise_like_the_reference(S, f, m):
    d2, w = np.zeros((S, S), np.float32), np.full(S, 1.0 / S, np.float32)
    with pytest.raises(ValueError):
        scores = jkrum.krum_scores(jnp.asarray(d2), jnp.asarray(w), f)
        jkrum.krum_select(scores, jnp.asarray(w), m)
    with pytest.raises(ValueError, match="need"):
        scores = krum.krum_scores(_t(d2), _t(w), f)
        krum.krum_select(scores, _t(w), m)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000), st.integers(6, 12), st.integers(0, 3))
def test_krum_breakdown_point_property(seed, S, raw_bad):
    """With ``f < (S - 2) / 2`` planted outliers, neither Krum nor
    multi-Krum selects an outlier row."""
    f = max(1, (S - 3) // 2)
    x, honest = hostile_matrix(seed, S, 32, min(raw_bad, f), outlier=1e3)
    w = _weights(np.random.default_rng(seed + 1), S)
    m = S - f - 2
    out, scores = ops.flat_krum_agg(_t(x), _t(w), f, m)
    sel = torch.sort(scores, stable=True).indices[:m].numpy()
    assert honest[sel].all(), (sel, honest)
    out = out.numpy()
    assert np.all(out >= x[honest].min(axis=0) - 1e-4)
    assert np.all(out <= x[honest].max(axis=0) + 1e-4)


# ---------------------------------------------------------------------------
# The strategies' step on a shared RoundInputs
# ---------------------------------------------------------------------------

def _round(S=8, N=300, K=20, dropped=(2,), seed=0):
    rng = np.random.default_rng(seed)
    sel = np.sort(rng.choice(K, S, replace=False)).astype(np.int32)
    stacked = rng.standard_normal((S, N)).astype(np.float32)
    criteria = rng.uniform(0.0, 1.0, (S, 3)).astype(np.float32)
    mask = np.ones(S, np.float32)
    mask[list(dropped)] = 0.0
    slowdown = rng.choice([1.0, 2.0, 4.0], S).astype(np.float32)
    dt = (slowdown * rng.uniform(0.8, 1.2, S)).astype(np.float32)
    params = rng.standard_normal(N).astype(np.float32)
    return dict(sel=sel, stacked=stacked, criteria=criteria, mask=mask,
                contrib=mask / slowdown, dt=dt), params


STRATEGIES = [("trimmed-mean", dict(trim=2)), ("trimmed-mean", dict(trim=0)),
              ("krum", {}), ("krum", dict(f=1)), ("multi-krum", {}),
              ("multi-krum", dict(f=1, m=3)), ("sync", {})]


@pytest.mark.parametrize("dropped", [(2,), (), tuple(range(8))],
                         ids=["one-dropped", "none-dropped", "all-dropped"])
@pytest.mark.parametrize("name,kwargs", STRATEGIES,
                         ids=[f"{n}-{kw}" for n, kw in STRATEGIES])
def test_strategy_step_matches_the_reference(name, kwargs, dropped):
    arrays, params = _round(dropped=dropped)
    K, rnd = 20, 3
    jstrat = jengine.make_strategy(name, **kwargs)
    jstate = jstrat.init_state(jnp.asarray(params), K, 0)
    jinp = jengine.RoundInputs(rnd=jnp.int32(rnd), **{
        k: jnp.asarray(v) for k, v in arrays.items()})
    jnew, jys = jstrat.step(jstate, jinp, JaxAggregationConfig(
        priority=(2, 0, 1)), False, None)

    strat = engine.make_strategy(name, **kwargs)
    state = strat.init_state(_t(params), K)
    inp = engine.RoundInputs(rnd=rnd, sel=torch.from_numpy(arrays["sel"]).long(),
                             **{k: _t(v) for k, v in arrays.items()
                                if k != "sel"})
    new, ys = strat.step(state, inp, AggregationConfig(priority=(2, 0, 1)))

    np.testing.assert_allclose(new.params.numpy(), _np(jnew.params), **F32)
    np.testing.assert_array_equal(new.last_sync.numpy(),
                                  np.asarray(jnew.last_sync))
    assert float(new.sim_time) == float(jnew.sim_time)
    assert int(new.commits) == int(jnew.commits)
    np.testing.assert_allclose(float(ys["entropy"]), float(jys["entropy"]),
                               rtol=1e-5)
    if "krum" in name:
        # the clients averaged: the reference's m lowest scores, exactly
        f, m = strat._resolve(8)
        jp = jcompute_weights(jnp.asarray(arrays["criteria"]),
                              JaxAggregationConfig(priority=(2, 0, 1)),
                              (2, 0, 1), mask=jnp.asarray(arrays["contrib"]))
        _, jscores = jref.krum_agg_ref(jnp.asarray(arrays["stacked"]), jp, f,
                                       m)
        np.testing.assert_array_equal(
            ys["selected"].numpy(),
            np.argsort(_np(jscores), kind="stable")[:m])
    if len(dropped) == 8:                          # a no-op round
        assert torch.equal(new.params, _t(params))


@pytest.mark.parametrize("strategy", [engine.TrimmedMeanStrategy(trim=4),
                                      engine.KrumStrategy(f=3),
                                      engine.KrumStrategy(f=1, m=6),
                                      engine.MultiKrumStrategy(m=0)],
                         ids=["trim", "f", "m", "m0"])
def test_strategy_rejects_what_the_reference_rejects(strategy):
    arrays, params = _round()
    jstrat = getattr(jengine, type(strategy).__name__)(
        **{k: getattr(strategy, k) for k in strategy.__dataclass_fields__})
    jinp = jengine.RoundInputs(rnd=jnp.int32(1), **{
        k: jnp.asarray(v) for k, v in arrays.items()})
    with pytest.raises(ValueError):
        jstrat.step(jstrat.init_state(jnp.asarray(params), 20, 0), jinp,
                    JaxAggregationConfig(priority=(2, 0, 1)), False, None)
    inp = engine.RoundInputs(rnd=1, sel=torch.from_numpy(arrays["sel"]).long(),
                             **{k: _t(v) for k, v in arrays.items()
                                if k != "sel"})
    with pytest.raises(ValueError, match="needs"):
        strategy.step(strategy.init_state(_t(params), 20), inp,
                      AggregationConfig(priority=(2, 0, 1)))


def test_strategy_registry_holds_the_ported_names_only():
    assert sorted(engine.STRATEGIES) == ["krum", "multi-krum", "sync",
                                         "trimmed-mean"]
    assert set(engine.STRATEGIES) < set(jengine.STRATEGIES)
    with pytest.raises(KeyError, match="available"):
        engine.make_strategy("buffered-async")
    assert engine.make_strategy("multi-krum").m is None
    assert not engine.TrimmedMeanStrategy.supports_online_adjust
    assert not engine.KrumStrategy.supports_online_adjust
