"""The port's models, optimizer and FlatSpec against the JAX package.

The same numpy weights and batch go through ``repro.models`` and
``repro_torch.models``.  Loss and gradients agree at rtol 1e-5 / atol
1e-6: both are f32, but XLA's and PyTorch's CPU convolutions and matmuls
sum in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.models import cnn as jcnn
from repro.models import mlp as jmlp
from repro.optim.optimizers import apply_updates
from repro.optim.optimizers import sgd as jsgd
from repro.utils.pytree import FlatSpec as JaxFlatSpec
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models import cnn, mlp
from repro_torch.optim.optimizers import sgd
from repro_torch.utils.pytree import FlatSpec
from test_torch_support import numpy_params
from test_torch_support import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)

MODELS = {
    "cnn": (jcnn.cnn_loss, jcnn.cnn_accuracy, cnn.cnn_loss, cnn.cnn_accuracy),
    "mlp": (jmlp.mlp_loss, jmlp.mlp_accuracy, mlp.mlp_loss, mlp.mlp_accuracy),
}


def _batch(B, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, 28, 28)).astype(np.float32)
    y = rng.integers(0, 62, B).astype(np.int32)
    return x, y


@pytest.mark.parametrize("model,hidden", [("cnn", 16), ("mlp", 48)])
def test_loss_and_grads_match_reference(model, hidden):
    jloss, _, tloss, _ = MODELS[model]
    np_params = numpy_params(model, hidden, seed=1)
    x, y = _batch(6, seed=2)
    jl, jg = jax.value_and_grad(jloss)(
        {k: jnp.asarray(v) for k, v in np_params.items()},
        jnp.asarray(x), jnp.asarray(y))
    tp = params_from_jax(np_params, device="cpu")
    tg = grad(tloss)(tp, torch.from_numpy(x), torch.from_numpy(y))
    tl = tloss(tp, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("model,hidden", [("cnn", 16), ("mlp", 48)])
def test_accuracy_matches_reference(model, hidden):
    _, jacc, _, tacc = MODELS[model]
    np_params = numpy_params(model, hidden, seed=3)
    x, y = _batch(40, seed=4)
    # make some labels right, so the accuracy is not trivially zero
    logits = (jcnn.cnn_apply if model == "cnn" else jmlp.mlp_apply)(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(x))
    y[::3] = np.asarray(jnp.argmax(logits, axis=-1))[::3]
    mask = (np.arange(40) < 31).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    tp = params_from_jax(np_params, device="cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for m in (None, mask):
        expected = float(jacc(jp, jnp.asarray(x), jnp.asarray(y),
                              None if m is None else jnp.asarray(m)))
        got = tacc(tp, tx, ty, None if m is None else torch.from_numpy(m))
        assert got.item() == pytest.approx(expected, abs=0)
        assert expected > 0


def test_vmapped_sgd_step_matches_reference():
    """One local step of S clients at once: the port's vmap(grad) and SGD
    against the reference's per-client grad and sgd update."""
    np_params = numpy_params("cnn", 16, seed=5)
    S, lr = 3, 0.05
    xs, ys = zip(*(_batch(4, seed=10 + s) for s in range(S)))
    opt = jsgd(lr)
    expected = []
    for s in range(S):
        jp = {k: jnp.asarray(v) for k, v in np_params.items()}
        g = jax.grad(jcnn.cnn_loss)(jp, jnp.asarray(xs[s]), jnp.asarray(ys[s]))
        upd, _ = opt.update(g, opt.init(jp), jp)
        expected.append(apply_updates(jp, upd))
    tp = params_from_jax(np_params, device="cpu")
    stacked = {k: v.expand(S, *v.shape).contiguous() for k, v in tp.items()}
    grads = vmap(grad(cnn.cnn_loss))(stacked, torch.from_numpy(np.stack(xs)),
                                     torch.from_numpy(np.stack(ys)))
    new = sgd(lr)(stacked, grads)
    for s in range(S):
        for k in np_params:
            np.testing.assert_allclose(new[k][s].numpy(),
                                       np.asarray(expected[s][k]),
                                       err_msg=f"client {s} {k}", **TOL)


@pytest.mark.parametrize("model,hidden", [("cnn", 16), ("mlp", 48)])
def test_flatspec_lines_up_with_reference(model, hidden):
    np_params = numpy_params(model, hidden, seed=6)
    jspec = JaxFlatSpec({k: jnp.asarray(v) for k, v in np_params.items()})
    tp = params_from_jax(np_params, device="cpu")
    spec = FlatSpec(tp)
    assert spec.num_params == jspec.num_params
    vec = spec.ravel(tp)
    np.testing.assert_array_equal(
        vec.numpy(),
        np.asarray(jspec.ravel({k: jnp.asarray(v)
                                for k, v in np_params.items()})))
    back = params_to_numpy(spec.unravel(vec))
    for k, v in np_params.items():
        np.testing.assert_array_equal(back[k], v)
    stacked = {k: torch.stack([v, 2 * v]) for k, v in tp.items()}
    rows = spec.stack_ravel(stacked)
    assert torch.equal(rows[0], vec) and torch.equal(rows[1], 2 * vec)
    with pytest.raises(ValueError):
        spec.unravel(vec[:-1])


def test_paper_cnn_has_the_paper_parameter_count():
    params = cnn.init_cnn_params(torch.Generator().manual_seed(0),
                                 hidden=2048, device="cpu")
    assert sum(v.numel() for v in params.values()) == 6_603_710
    shapes = jax.eval_shape(
        lambda: jcnn.init_cnn_params(jax.random.key(0), hidden=2048))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in shapes.items()}
    # He init: weights carry variance 2 / fan_in
    assert params["fc_w"].std().item() == pytest.approx((2 / 3136) ** 0.5,
                                                        rel=0.01)


def test_init_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")
    with pytest.raises((RuntimeError, AssertionError)):
        mlp.init_mlp_params(torch.Generator().manual_seed(0), hidden=4)
