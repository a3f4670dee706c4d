"""The port's kernel layer against the JAX package's Pallas kernels.

On the CPU the port runs each kernel's plain PyTorch version; these
tests hold it to the Pallas kernel run in interpret mode and to the
reference's jnp oracle, on the same numpy inputs.  Tolerances: f32
results at rtol 1e-5 (the reference's own flat-path gate; the sums run
in other orders), bf16 outputs at one bf16 ulp (2**-7 relative: both
sides sum in f32 and round once, so a last-bit difference in the f32
sum can move the rounding by one ulp).

The CUDA kernels run only on a GPU: their test skips elsewhere.  A GPU
host need not have JAX, so this module imports the JAX package only in
the tests that compare with it, and those skip without it; on such a
host run ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_kernels.py`` (the suite's conftest imports JAX).
``chip_smoke.py`` also holds the kernels to their plain versions on the
card, at the main path's shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import divergence as kdiv
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import weighted_agg as kagg

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2.0 ** -7, atol=1e-6)
TORCH_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}

SHAPES = [(1, 1), (1, 487), (3, 257), (37, 3001)]


def _inputs(K, N, dtype, seed):
    """``(x [K, N], g [N], w [K])`` made with numpy, as torch tensors;
    ``w`` is f32 and sums to 1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, N)).astype(np.float32)
    g = rng.standard_normal(N).astype(np.float32)
    w = rng.uniform(0.1, 1.0, K).astype(np.float32)
    w /= w.sum()
    tdt = TORCH_DTYPE[dtype]
    return (torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt),
            torch.from_numpy(w))


def _reference():
    """The JAX package's kernels and oracles (skips without JAX)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.divergence import divergence_sq
    from repro.kernels.weighted_agg import weighted_agg

    def to_jax(t):
        dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
        return jnp.asarray(t.to(torch.float32).numpy(), dt)

    def to_np(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    return jref, weighted_agg, divergence_sq, to_jax, to_np


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("K,N", SHAPES)
def test_weighted_agg_plain_matches_pallas(K, N, dtype):
    jref, pallas_weighted_agg, _, to_jax, to_np = _reference()
    tx, _, tw = _inputs(K, N, dtype, seed=K * 1000 + N)
    jx, jw = to_jax(tx), to_jax(tw)
    out = ref.weighted_agg_ref(tx, tw)
    assert out.dtype == tx.dtype and out.shape == (N,)
    tol = BF16 if dtype == "bf16" else F32
    got = out.to(torch.float32).numpy()
    np.testing.assert_allclose(
        got, to_np(pallas_weighted_agg(jx, jw, interpret=True)), **tol)
    np.testing.assert_allclose(got, to_np(jref.weighted_agg_ref(jx, jw)),
                               **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("K,N", SHAPES)
def test_divergence_plain_matches_pallas(K, N, dtype):
    jref, _, pallas_divergence_sq, to_jax, to_np = _reference()
    tx, tg, _ = _inputs(K, N, dtype, seed=K * 1000 + N + 1)
    jx, jg = to_jax(tx), to_jax(tg)
    out = ref.divergence_ref(tx, tg)
    assert out.dtype == torch.float32 and out.shape == (K,)
    np.testing.assert_allclose(
        out.numpy(), to_np(pallas_divergence_sq(jx, jg, interpret=True)),
        **F32)
    np.testing.assert_allclose(out.numpy(), to_np(jref.divergence_ref(jx, jg)),
                               **F32)


def test_ops_take_the_plain_version_for_cpu_tensors(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("a CPU tensor reached the CUDA kernel wrapper")

    monkeypatch.setattr(ops, "weighted_agg", no_kernel)
    monkeypatch.setattr(ops, "divergence_sq", no_kernel)
    tx, tg, tw = _inputs(5, 300, "f32", seed=3)
    assert torch.equal(ops.flat_weighted_agg(tx, tw),
                       ref.weighted_agg_ref(tx, tw))
    assert torch.equal(ops.flat_divergence_sq(tx, tg),
                       ref.divergence_ref(tx, tg))


def test_ops_never_fall_back_off_the_cpu():
    """A tensor on any device but the CPU goes to the kernel wrapper,
    which launches or raises: it never takes the plain version."""
    x = torch.empty((3, 8), device="meta")
    w = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flat_weighted_agg(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flat_divergence_sq(x, torch.empty(8, device="meta"))


def test_wrappers_refuse_cpu_tensors_and_count_nothing():
    tx, tg, tw = _inputs(2, 16, "f32", seed=4)
    before = (kagg.weighted_agg.launches, kdiv.divergence_sq.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kagg.weighted_agg(tx, tw)
    with pytest.raises(ValueError, match="CUDA"):
        kdiv.divergence_sq(tx, tg)
    assert (kagg.weighted_agg.launches, kdiv.divergence_sq.launches) == before


def test_each_kernel_module_keeps_its_plain_version():
    assert kagg.weighted_agg_ref is ref.weighted_agg_ref
    assert kdiv.divergence_ref is ref.divergence_ref


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a GPU")
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("K,N", SHAPES + [(37, 1 << 20)])
def test_cuda_kernels_match_plain_versions(K, N, dtype):
    tx, tg, tw = (t.cuda() for t in _inputs(K, N, dtype, seed=K + N))
    n_agg, n_div = kagg.weighted_agg.launches, kdiv.divergence_sq.launches
    agg = kagg.weighted_agg(tx, tw)
    div = kdiv.divergence_sq(tx, tg)
    torch.cuda.synchronize()
    assert kagg.weighted_agg.launches == n_agg + 1
    assert kdiv.divergence_sq.launches == n_div + 1
    assert agg.dtype == tx.dtype and div.dtype == torch.float32
    tol = BF16 if dtype == "bf16" else F32
    torch.testing.assert_close(agg.float(),
                               ref.weighted_agg_ref(tx, tw).float(), **tol)
    torch.testing.assert_close(div, ref.divergence_ref(tx, tg), **F32)
    # no atomics: the same inputs give the same bits
    assert torch.equal(agg, kagg.weighted_agg(tx, tw))
    assert torch.equal(div, kdiv.divergence_sq(tx, tg))
