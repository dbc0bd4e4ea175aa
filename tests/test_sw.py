"""True Smith-Waterman: batched anti-diagonal JAX path vs NumPy golden DP."""

import numpy as np
import jax.numpy as jnp
import pytest

from mini_parallel.ops import encode, sw
from tests.conftest import random_dna


def test_readme_worked_example():
    # README.md:5-12: per-position match table; a true SW of identical strings
    # scores 2 * len.
    assert sw.sw_score_numpy("ACGT", "ACGT") == 8
    assert sw.sw_score_pair("ACGT", "ACGT") == 8


def test_known_small_cases():
    # Hand-checkable: one mismatch inside an exact flank.
    # "ACGTT" vs "ACGAT": best local path = ACG (6) then extend through
    # mismatch (-1 -> 5) then T match (+2 -> 7).
    assert sw.sw_score_numpy("ACGTT", "ACGAT") == 7
    assert sw.sw_score_pair("ACGTT", "ACGAT") == 7
    # Gap case: deletion of one base, gap -2 beats mismatch chain.
    # a=ACGT, b=AGT: A(+2) then gap(-2)=0... best is GT exact = 4; full path
    # A + gap + GT = 2-2+4 = 4 as well.
    assert sw.sw_score_numpy("ACGT", "AGT") == 4
    assert sw.sw_score_numpy("", "ACGT") == 0
    assert sw.sw_score_numpy("AAAA", "TTTT") == 0


def test_batch_matches_numpy_random(rng):
    B = 16
    seqs_a = [random_dna(rng, int(rng.integers(1, 80))) for _ in range(B)]
    seqs_b = [random_dna(rng, int(rng.integers(1, 60))) for _ in range(B)]
    arr_a, _ = encode.pad_batch(seqs_a, pad_to=96, pad_value=int(encode.PAD_A))
    arr_b, _ = encode.pad_batch(seqs_b, pad_to=64, pad_value=int(encode.PAD_B))
    got = np.asarray(sw.sw_score_batch(jnp.asarray(arr_a), jnp.asarray(arr_b)))
    for i in range(B):
        assert got[i] == sw.sw_score_numpy(seqs_a[i], seqs_b[i]), i


def test_batch_ragged_padding_is_inert(rng):
    # Same pair at two different pad widths must score identically.
    a, b = b"ACGTACGTAC", b"ACGGACGTTC"
    for pad in (16, 64):
        arr_a, _ = encode.pad_batch([a], pad_to=pad, pad_value=int(encode.PAD_A))
        arr_b, _ = encode.pad_batch([b], pad_to=pad, pad_value=int(encode.PAD_B))
        got = int(sw.sw_score_batch(jnp.asarray(arr_a), jnp.asarray(arr_b))[0])
        assert got == sw.sw_score_numpy(a, b)


def test_batch_long_sequences(rng):
    a = random_dna(rng, 300)
    b = bytearray(a)
    # introduce mutations + an insertion to force gap usage
    b[50] = ord("A") if b[50] != ord("A") else ord("C")
    b = bytes(b[:100]) + b"G" + bytes(b[100:])
    arr_a, _ = encode.pad_batch([a], pad_to=320, pad_value=int(encode.PAD_A))
    arr_b, _ = encode.pad_batch([bytes(b)], pad_to=320, pad_value=int(encode.PAD_B))
    got = int(sw.sw_score_batch(jnp.asarray(arr_a), jnp.asarray(arr_b))[0])
    assert got == sw.sw_score_numpy(a, bytes(b))
