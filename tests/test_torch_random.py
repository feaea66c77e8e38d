"""Port vs JAX package: ``repro_torch.random`` is a numpy mirror of
``jax.random`` on legacy uint32[2] threefry keys, exact to the bit, in
the ``jax_threefry_partitionable=True`` mode (pinned here), and
``hashing._seed_of`` derives the same int seeds as the JAX package."""
import jax
import numpy as np
import pytest

from repro.core import hashing as jhash
from repro_torch import random as jr
from repro_torch.core import hashing as thash


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _keys(n=300, seed=0):
    seeds = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)
    return [int(s) for s in seeds] + [0, 1, 2**31 - 1, 2**32 - 1]


def test_prng_key_and_key_data():
    for s in _keys(50):
        want = np.asarray(jax.random.key_data(jax.random.PRNGKey(s)))
        got = jr.key_data(jr.PRNGKey(s))
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_bit_exact(num):
    for s in _keys(100, seed=num):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(s), num))
        np.testing.assert_array_equal(jr.split(jr.PRNGKey(s), num), want)


def test_split_default_is_two():
    np.testing.assert_array_equal(
        jr.split(jr.PRNGKey(5)), np.asarray(jax.random.split(jax.random.PRNGKey(5))))


@pytest.mark.parametrize("data", [0, 1, 2, 3, 17, 25, 777, 10_007, 2**31 - 1, 2**32 - 1])
def test_fold_in_bit_exact(data):
    """The transition's fold_in data: epochs, feature indices, 777 (the
    fresh helper hashes) and 10_007 (the sampling seed)."""
    for s in _keys(100, seed=data % 97):
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(s), data))
        np.testing.assert_array_equal(jr.fold_in(jr.PRNGKey(s), data), want)


def test_fold_in_takes_numpy_and_zero_d_values():
    import torch

    key = jr.PRNGKey(11)
    want = jr.fold_in(key, 3)
    np.testing.assert_array_equal(jr.fold_in(key, np.int32(3)), want)
    np.testing.assert_array_equal(jr.fold_in(key, torch.tensor(3, dtype=torch.int32)), want)


def test_chained_schedule_bit_exact():
    """``CCE.cluster``'s schedule: fold_in(epoch), split, fold_in(feature),
    fold_in(777)."""
    for s in _keys(60, seed=9):
        jk, tk = jax.random.PRNGKey(s), jr.PRNGKey(s)
        for epoch in range(3):
            j1, j2 = jax.random.split(jax.random.fold_in(jk, epoch))
            t1, t2 = jr.split(jr.fold_in(tk, epoch))
            np.testing.assert_array_equal(t1, np.asarray(j1))
            np.testing.assert_array_equal(t2, np.asarray(j2))
            for i in (0, 5):
                np.testing.assert_array_equal(
                    jr.fold_in(jr.fold_in(t2, i), 777),
                    np.asarray(jax.random.fold_in(jax.random.fold_in(j2, i), 777)))


@pytest.mark.parametrize("shape", [(), (1,), (5,), (3, 4)])
def test_randint_bit_exact(shape):
    for s in _keys(100, seed=len(shape)):
        key = jax.random.fold_in(jax.random.PRNGKey(s), 10_007)
        want = np.asarray(jax.random.randint(key, shape, 0, 2**31 - 1))
        got = jr.randint(jr.fold_in(jr.PRNGKey(s), 10_007), shape, 0, 2**31 - 1)
        assert got.dtype == np.int32 and got.shape == shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(0, 10), (-5, 5), (0, 1), (7, 7), (-(2**31), 2**31 - 1)])
def test_randint_other_bounds(lo, hi):
    for s in _keys(30, seed=hi & 0xFF):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(s), (6,), lo, hi))
        np.testing.assert_array_equal(jr.randint(jr.PRNGKey(s), (6,), lo, hi), want)


def test_seed_of_agrees():
    for s in _keys(100, seed=4):
        jk = jax.random.fold_in(jax.random.PRNGKey(s), 777)
        tk = jr.fold_in(jr.PRNGKey(s), 777)
        assert thash._seed_of(tk) == jhash._seed_of(jk)
        assert [(h.a, h.b) for h in thash.make_hashes(thash._seed_of(tk), 4, 250)] == [
            (h.a, h.b) for h in jhash.make_hashes(jk, 4, 250)]
