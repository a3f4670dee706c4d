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
from repro_torch.kernels import krum as kkrum
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import trimmed as ktrim
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


def _counts():
    return (kagg.weighted_agg.launches, kdiv.divergence_sq.launches,
            ktrim.trimmed_agg.launches, kkrum.pairwise_sq_dists.launches)


def test_ops_take_the_plain_version_for_cpu_tensors(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("a CPU tensor reached the CUDA kernel wrapper")

    monkeypatch.setattr(ops, "weighted_agg", no_kernel)
    monkeypatch.setattr(ops, "divergence_sq", no_kernel)
    monkeypatch.setattr(ops, "trimmed_agg", no_kernel)
    monkeypatch.setattr(kkrum, "pairwise_sq_dists", no_kernel)
    monkeypatch.setattr(kkrum, "krum_agg", no_kernel)
    tx, tg, tw = _inputs(5, 300, "f32", seed=3)
    assert torch.equal(ops.flat_weighted_agg(tx, tw),
                       ref.weighted_agg_ref(tx, tw))
    assert torch.equal(ops.flat_divergence_sq(tx, tg),
                       ref.divergence_ref(tx, tg))
    assert torch.equal(ops.flat_trimmed_agg(tx, tw, 1),
                       ref.trimmed_agg_ref(tx, tw, 1))
    out, scores = ops.flat_krum_agg(tx, tw, 1, 2)
    assert out.shape == (300,) and scores.shape == (5,)


def test_ops_never_fall_back_off_the_cpu():
    """A tensor on any device but the CPU goes to the kernel wrapper,
    which launches or raises: it never takes the plain version."""
    x = torch.empty((3, 8), device="meta")
    w = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flat_weighted_agg(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flat_divergence_sq(x, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flat_trimmed_agg(x, w, 1)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flat_krum_agg(x, w, 0, 1)


def test_wrappers_refuse_cpu_tensors_and_count_nothing():
    tx, tg, tw = _inputs(5, 16, "f32", seed=4)
    before = _counts()
    with pytest.raises(ValueError, match="CUDA"):
        kagg.weighted_agg(tx, tw)
    with pytest.raises(ValueError, match="CUDA"):
        kdiv.divergence_sq(tx, tg)
    with pytest.raises(ValueError, match="CUDA"):
        ktrim.trimmed_agg(tx, tw, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kkrum.pairwise_sq_dists(tx)
    with pytest.raises(ValueError, match="CUDA"):
        kkrum.krum_agg(tx, tw, 1, 1)
    assert _counts() == before


def test_each_kernel_module_keeps_its_plain_version():
    assert kagg.weighted_agg_ref is ref.weighted_agg_ref
    assert kdiv.divergence_ref is ref.divergence_ref
    assert ktrim.trimmed_agg_ref is ref.trimmed_agg_ref


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a GPU")
def test_trimmed_row_limit_fits_shared_memory():
    """The largest S the K4 kernel takes (its [S, 32] tile in the 227 KB
    a block may use on an H100) launches and agrees with the plain
    version."""
    S = ktrim.max_rows()
    assert 1600 < S < 1900
    tx, _, tw = (t.cuda() for t in _inputs(S, 70, "f32", seed=S))
    torch.testing.assert_close(ktrim.trimmed_agg(tx, tw, S // 4),
                               ref.trimmed_agg_ref(tx, tw, S // 4), **F32)


@pytest.mark.parametrize("S,N", [(1, 1), (37, 6_603_710), (40, 33),
                                 (1000, 10 ** 6)])
def test_krum_chunking_covers_every_column_once(S, N):
    """The K5 kernel's split of N: whole 32-column sub-tiles, no empty
    chunk, every column in exactly one chunk, fixed by (S, N) alone."""
    chunk, parts = kkrum._chunking(S, N)
    assert chunk % 32 == 0 and 1 <= parts <= 1024
    assert (parts - 1) * chunk < N <= parts * chunk
    assert parts * S * S <= max(1 << 24, S * S)


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


def _ties(S, N, seed):
    """Duplicate-heavy values and distinct weights within a factor of 2:
    trimming another of two equal values changes the result by ~1e-3
    relative, far above the tolerance."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-2, 3, (S, N)).astype(np.float32))
    w = 1.0 + torch.arange(S, dtype=torch.float32) / S
    return x, w / w.sum()


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a GPU")
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S,N,trim", [(3, 1, 1), (5, 300, 0), (37, 3001, 9),
                                      (37, 1 << 20, 9), (70, 1000, 20)])
def test_cuda_trimmed_matches_plain_version(S, N, trim, dtype):
    tx, _, tw = (t.cuda() for t in _inputs(S, N, dtype, seed=S + N))
    n = ktrim.trimmed_agg.launches
    out = ktrim.trimmed_agg(tx, tw, trim)
    torch.cuda.synchronize()
    assert ktrim.trimmed_agg.launches == n + 1
    assert out.dtype == tx.dtype and out.shape == (N,)
    tol = BF16 if dtype == "bf16" else F32
    torch.testing.assert_close(out.float(),
                               ref.trimmed_agg_ref(tx, tw, trim).float(),
                               **tol)
    assert torch.equal(out, ktrim.trimmed_agg(tx, tw, trim))


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a GPU")
@pytest.mark.parametrize("S,trim", [(8, 3), (37, 9)])
def test_cuda_trimmed_keeps_the_plain_versions_rows_on_ties(S, trim):
    x, w = (t.cuda() for t in _ties(S, 4099, seed=S))
    torch.testing.assert_close(ktrim.trimmed_agg(x, w, trim),
                               ref.trimmed_agg_ref(x, w, trim), **F32)
    # the zero-weight fallback: all weight on the rows that are trimmed
    x5 = torch.tensor([[0.0], [1.0], [2.0], [3.0], [4.0]], device="cuda")
    w5 = torch.tensor([0.5, 0.0, 0.0, 0.0, 0.5], device="cuda")
    assert ktrim.trimmed_agg(x5, w5, 1).item() == 2.0


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a GPU")
def test_cuda_trimmed_nonfinite_values_match_plain_version():
    """NaN and inf columns: NaN wherever the plain version gives NaN."""
    nan, inf = float("nan"), float("inf")
    x = torch.tensor([[nan, 0.0, -1.0, 1.0, 4.0], [1.0, -0.0, -inf, 2.0, 1.0],
                      [2.0, 0.0, 3.0, nan, 2.0], [-3.0, -0.0, inf, nan, 3.0],
                      [5.0, 0.0, 0.5, 0.25, inf]], device="cuda")
    w = torch.tensor([0.1, 0.3, 0.2, 0.25, 0.15], device="cuda")
    torch.testing.assert_close(ktrim.trimmed_agg(x, w, 1),
                               ref.trimmed_agg_ref(x, w, 1), equal_nan=True,
                               **F32)


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a GPU")
def test_cuda_trimmed_refuses_too_many_rows():
    S = ktrim.max_rows() + 1
    x = torch.zeros((S, 4), device="cuda")
    with pytest.raises(ValueError, match=f"at most S={S - 1}"):
        ktrim.trimmed_agg(x, torch.full((S,), 1.0 / S, device="cuda"), 1)


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a GPU")
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S,N", [(1, 1), (1, 487), (3, 257), (37, 3001),
                                 (37, 1 << 20), (70, 5000), (130, 3000)])
def test_cuda_pairwise_sq_dists_match_plain_version(S, N, dtype):
    tx, _, tw = (t.cuda() for t in _inputs(S, N, dtype, seed=S * N))
    n = kkrum.pairwise_sq_dists.launches
    d2, gram = kkrum.pairwise_sq_dists(tx, with_gram=True)
    torch.cuda.synchronize()
    assert kkrum.pairwise_sq_dists.launches == n + 1
    assert d2.dtype == gram.dtype == torch.float32 and d2.shape == (S, S)
    x = tx.float()
    want_gram = x @ x.T                    # f32: TF32 is off by default
    torch.testing.assert_close(gram, want_gram, rtol=1e-5,
                               atol=1e-5 * N ** 0.5)
    assert torch.equal(gram, gram.T)
    assert torch.equal(torch.diagonal(d2), torch.zeros(S, device="cuda"))
    atol = 1e-5 * float(torch.diagonal(want_gram).max())
    torch.testing.assert_close(d2, kkrum.gram_sq_dists(want_gram), rtol=1e-5,
                               atol=atol)
    assert torch.equal(d2, kkrum.pairwise_sq_dists(tx))
    if S >= 3:
        # well-separated rows (row i scaled by i + 1): the kernel path and
        # the plain one select the same clients
        scale = torch.arange(1, S + 1, device="cuda")[:, None]
        sep = (tx.float() * scale).to(tx.dtype)
        f = (S - 3) // 2
        m = S - f - 2
        out, scores = kkrum.krum_agg(sep, tw, f, m)
        want, want_scores = ops.flat_krum_agg(sep.cpu(), tw.cpu(), f, m)
        np.testing.assert_array_equal(
            torch.sort(scores, stable=True).indices[:m].cpu(),
            torch.sort(want_scores, stable=True).indices[:m])
        # the weighted mean of m rows cancels where they differ in sign,
        # so its error scales with sum_k wsel_k |x_k| per column: each
        # side's f32 sum of m products, with weights renormalized in f32,
        # is within (m + 2) * 2^-24 of that, the two sides within twice it
        wsel, _ = kkrum.krum_select(want_scores, tw.cpu(), m)
        atol = (2 * (m + 2) * 2.0 ** -24
                * (wsel[:, None] * sep.float().cpu().abs()).sum(0))
        rtol = (BF16 if dtype == "bf16" else F32)["rtol"]
        err = (out.float().cpu() - want.float()).abs()
        worst = int(torch.argmax(err - rtol * want.float().abs() - atol))
        assert bool((err <= atol + rtol * want.float().abs()).all()), (
            worst, float(err[worst]), float(want[worst]), float(atol[worst]))
