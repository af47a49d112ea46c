"""Tests for packed binary descriptor ops (the matching substrate)."""

import jax.numpy as jnp
import numpy as np

from corbslam.ops import descriptors as D


def np_hamming(a, b):
    """Reference popcount-xor implementation in NumPy."""
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    return np.unpackbits(x, axis=-1).sum(-1)


class TestPacking:
    def test_roundtrip(self, rng):
        packed = rng.integers(0, 256, size=(64, 32), dtype=np.uint8)
        bits = D.unpack_bits(jnp.asarray(packed))
        repacked = np.asarray(D.pack_bits(bits))
        np.testing.assert_array_equal(repacked, packed)

    def test_popcount(self, rng):
        packed = rng.integers(0, 256, size=(100, 32), dtype=np.uint8)
        pc = np.asarray(D.popcount_desc(jnp.asarray(packed)))
        expected = np.unpackbits(packed, axis=-1).sum(-1)
        np.testing.assert_array_equal(pc, expected)


class TestHamming:
    def test_matrix_matches_numpy(self, rng):
        a = rng.integers(0, 256, size=(37, 32), dtype=np.uint8)
        b = rng.integers(0, 256, size=(53, 32), dtype=np.uint8)
        d = np.asarray(D.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(d, np_hamming(a, b))

    def test_self_distance_zero(self, rng):
        a = rng.integers(0, 256, size=(16, 32), dtype=np.uint8)
        d = np.asarray(D.hamming_matrix(jnp.asarray(a), jnp.asarray(a)))
        np.testing.assert_array_equal(np.diag(d), np.zeros(16))

    def test_pairwise(self, rng):
        a = rng.integers(0, 256, size=(20, 32), dtype=np.uint8)
        b = rng.integers(0, 256, size=(20, 32), dtype=np.uint8)
        d = np.asarray(D.hamming_pairwise(jnp.asarray(a), jnp.asarray(b)))
        expected = np.unpackbits(np.bitwise_xor(a, b), axis=-1).sum(-1)
        np.testing.assert_array_equal(d, expected)

    def test_masked(self, rng):
        a = rng.integers(0, 256, size=(8, 32), dtype=np.uint8)
        b = rng.integers(0, 256, size=(9, 32), dtype=np.uint8)
        valid_a = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
        d = np.asarray(
            D.masked_hamming_matrix(jnp.asarray(a), jnp.asarray(b), valid_a=jnp.asarray(valid_a))
        )
        assert (d[~valid_a] == D.INF_DIST).all()
        np.testing.assert_array_equal(d[valid_a], np_hamming(a, b)[valid_a])


class TestMatching:
    def test_best_match_with_planted_pairs(self, rng):
        # b = permuted copies of a with k bit flips; best match must recover
        # the permutation when flips are few.
        n = 40
        a = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
        perm = rng.permutation(n)
        b = a[perm].copy()
        # flip 5 random bits in each b row
        for i in range(n):
            for bit in rng.integers(0, 256, size=5):
                b[i, bit // 8] ^= 1 << (bit % 8)
        d = D.hamming_matrix(jnp.asarray(b), jnp.asarray(a))
        idx, dist, ok = D.best_match(d, max_dist=30, ratio=0.9)
        idx, dist, ok = np.asarray(idx), np.asarray(dist), np.asarray(ok)
        # Random 256-bit codes are ~128 apart; 5 flips stay well below ratio.
        assert ok.mean() > 0.9
        np.testing.assert_array_equal(idx[ok], perm[ok])
        assert (dist[ok] <= 10).all()

    def test_ratio_test_rejects_ambiguous(self, rng):
        a = rng.integers(0, 256, size=(4, 32), dtype=np.uint8)
        b = np.concatenate([a, a])  # every query has two equally good matches
        d = D.hamming_matrix(jnp.asarray(a), jnp.asarray(b))
        _, _, ok = D.best_match(d, max_dist=50, ratio=0.9)
        assert not np.asarray(ok).any()

    def test_mutual_best(self, rng):
        a = rng.integers(0, 256, size=(30, 32), dtype=np.uint8)
        b = a[::-1].copy()
        d = D.hamming_matrix(jnp.asarray(a), jnp.asarray(b))
        idx, _, ok = D.mutual_best(d, max_dist=10)
        idx, ok = np.asarray(idx), np.asarray(ok)
        assert ok.all()
        np.testing.assert_array_equal(idx, np.arange(30)[::-1])
