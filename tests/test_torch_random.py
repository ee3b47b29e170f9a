"""The port's threefry2x32 PRNG against jax.random, in both of jax's
threefry streams (``jax_threefry_partitionable`` True, jax's default, and
False, the legacy stream the committed golden trajectories were drawn from).

Contract: keys, ``split``, ``fold_in``, ``bits``, ``uniform`` and
``permutation`` are bitwise equal; ``normal`` is bitwise too (its erfinv repeats XLA's float32
arithmetic on the CPU, fused multiply-adds included; it was 3 ulp apart
with torch's log1p, sqrt and unfused products), and is still held to the
older 4-ulp check; ``gumbel`` is within 4 ulp of ``max(|g|, 1)`` (two
float32 logs from another library; 2 measured).
"""

import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

from repro_torch import random as prng  # noqa: E402

SEEDS = [0, 1, 42, 2**31 - 1, -7]
SHAPES = [(), (1,), (7,), (3, 5), (2, 3, 4), (561,)]


MODES = pytest.mark.parametrize("partitionable", [True, False], ids=["partitionable", "legacy"])


@contextlib.contextmanager
def both(partitionable):
    """The same threefry stream in jax and in the port."""
    with jax.threefry_partitionable(partitionable), prng.threefry_partitionable(partitionable):
        yield


def _key_words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _ulp_gap(a, b) -> int:
    """Largest distance in float32 ulps (monotone integer mapping)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def test_default_stream_is_jax_default():
    assert jax.config.jax_threefry_partitionable
    np.testing.assert_array_equal(
        _key_words(jax.random.split(jax.random.PRNGKey(0), 3)), prng.split(prng.PRNGKey(0), 3).numpy())


@MODES
@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in_bitwise(seed, partitionable):
    with both(partitionable):
        _check_keys(seed)


def _check_keys(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert (_key_words(kj) == kt.numpy()).all()
    for num in (2, 3, 4, 30):
        assert (_key_words(jax.random.split(kj, num)) == prng.split(kt, num).numpy()).all()
    for data in (0, 1, 3, 99, 2**32 - 1):
        assert (_key_words(jax.random.fold_in(kj, data)) == prng.fold_in(kt, data).numpy()).all()
    # chains of derivations stay equal (the round's key schedule)
    kj2 = jax.random.fold_in(jax.random.split(kj, 4)[3], 2)
    kt2 = prng.fold_in(prng.split(kt, 4)[3], 2)
    assert (_key_words(kj2) == kt2.numpy()).all()


@MODES
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_bitwise(seed, shape, partitionable):
    with both(partitionable):
        _check_bits(seed, shape)


def _check_bits(seed, shape):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    bj = np.asarray(jax.random.bits(kj, shape)).astype(np.int64)
    assert bj.shape == tuple(prng.bits(kt, shape).shape)
    assert (bj == prng.bits(kt, shape).numpy()).all()
    uj = np.asarray(jax.random.uniform(kj, shape))
    ut = prng.uniform(kt, shape).numpy()
    assert uj.dtype == ut.dtype == np.float32
    np.testing.assert_array_equal(uj, ut)
    uj = np.asarray(jax.random.uniform(kj, shape, minval=0.5, maxval=2.0))
    np.testing.assert_array_equal(uj, prng.uniform(kt, shape, minval=0.5, maxval=2.0).numpy())


@MODES
def test_batched_keys_are_vmapped_draws(partitionable):
    """A (K, 2) key batch draws what jax.vmap over the K keys draws."""
    with both(partitionable):
        _check_batched()


def _check_batched():
    kj = jax.random.split(jax.random.PRNGKey(3), 5)
    kt = prng.split(prng.PRNGKey(3), 5)
    for n in (9, 10):
        uj = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(kj))
        np.testing.assert_array_equal(uj, prng.uniform(kt, (n,)).numpy())
    sj = _key_words(jax.vmap(lambda k: jax.random.split(k, 3))(kj))
    assert (sj == prng.split(kt, 3).numpy()).all()
    fj = _key_words(jax.vmap(lambda k: jax.random.fold_in(k, 6))(kj))
    assert (fj == prng.fold_in(kt, 6).numpy()).all()


@MODES
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_4_ulp(seed, partitionable):
    with both(partitionable):
        _check_normal(seed)


def _check_normal(seed):
    for shape in [(7,), (561, 256), (256, 6)]:
        nj = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        nt = prng.normal(prng.PRNGKey(seed), shape).numpy()
        assert _ulp_gap(nj, nt) <= 4


@MODES
@pytest.mark.parametrize("seed", [0, 7])
def test_normal_is_bitwise_jax(seed, partitionable):
    """Half a million draws (the vision stub's bfloat16 embeddings round
    these, so a last-bit gap would flip a few of them)."""
    with both(partitionable):
        nj = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (512, 1024)))
        nt = prng.normal(prng.PRNGKey(seed), (512, 1024)).numpy()
    np.testing.assert_array_equal(nt, nj)


def test_erfinv_is_bitwise_xla_at_the_edges():
    lo = np.nextafter(np.float32(-1), np.float32(0))
    x = np.float32([0.0, -0.0, lo, -lo, 1.0, -1.0, 2**-24, -(2**-24), 1e-30, 0.41, 0.4142,
                    0.5, 0.9, 0.99, 0.999, 0.9999, np.nan])
    x = np.concatenate([x, np.linspace(-1, 1, 100_001, dtype=np.float32)])
    want = np.asarray(jax.lax.erf_inv(jax.numpy.asarray(x)))
    np.testing.assert_array_equal(prng.erfinv(torch.from_numpy(x)).numpy(), want)


@MODES
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_4_ulp_of_unit_scale(seed, partitionable):
    with both(partitionable):
        _check_gumbel(seed)


def _check_gumbel(seed):
    for shape in [(8,), (1000,)]:
        gj = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
        gt = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
        unit = np.spacing(np.maximum(np.abs(gj), 1.0).astype(np.float32))
        assert (np.abs(gj - gt) <= 4 * unit).all()


@MODES
@pytest.mark.parametrize("n", [1, 7, 256, 8192])
def test_permutation_bitwise(n, partitionable):
    """``permutation(key, n)`` is ``jax.random.permutation(key, n)``: 0, 1,
    1 and 2 rounds of a stable sort by 32-bit draws for these n."""
    with both(partitionable):
        for seed in (0, 777, -7):
            kj = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
            kt = prng.fold_in(prng.PRNGKey(seed), 3)
            want = np.asarray(jax.random.permutation(kj, n))
            got = prng.permutation(kt, n)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def test_seed_out_of_int32_range_raises():
    with pytest.raises(ValueError, match="int32"):
        prng.PRNGKey(2**31)
