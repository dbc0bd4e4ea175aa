"""Parity-mode scorer tests: JAX batched path vs bit-exact NumPy emulation
of the reference kernel (smith_waterman.cl:11-71 + aligner.rs:410-531)."""

import numpy as np
import jax.numpy as jnp
import pytest

from mini_parallel.ops import encode, kadane
from tests.conftest import random_dna


def _py_kadane(scores):
    best = cur = 0
    for s in scores:
        cur = max(cur + s, 0)
        best = max(best, cur)
    return best


def test_reference_emulation_tiny_strided():
    # With wgs=2, max_groups=1: one group, chunk = len, two strided lanes.
    a = b"AATTAA"
    b = b"AAAAAA"
    # scores: +2 +2 -1 -1 +2 +2; lane0 = idx 0,2,4 -> [2,-1,2]; lane1 -> same
    expect = max(_py_kadane([2, -1, 2]), _py_kadane([2, -1, 2]))
    got = kadane.reference_align_score(a, b, work_group_size=2, max_work_groups=1)
    assert got == expect == 3


def test_reference_emulation_degenerate_equals_any_match():
    rng = np.random.default_rng(1)
    for _ in range(20):
        n = int(rng.integers(0, 50))
        a = random_dna(rng, n)
        b = random_dna(rng, n)
        ref = kadane.reference_align_score(a, b, work_group_size=8, max_work_groups=10**6)
        anym = 2 if any(x == y for x, y in zip(a, b)) else 0
        assert ref == anym


def test_reference_vs_brute_force_general_regime():
    # Small wgs + tight group cap => multi-element strided runs; compare to a
    # direct per-(group, lane) brute force.
    rng = np.random.default_rng(2)
    for trial in range(10):
        n = int(rng.integers(1, 200))
        a = random_dna(rng, n)
        b = random_dna(rng, n)
        wgs, mg = 4, 3
        scores = [2 if a[i] == b[i] else -1 for i in range(n)]
        num_groups = min(-(-n // wgs), mg)
        chunk = -(-n // num_groups)
        best = 0
        for g in range(num_groups):
            start, end = g * chunk, min((g + 1) * chunk, n)
            if start >= n:
                break
            for lid in range(wgs):
                run = scores[start + lid:end:wgs]
                best = max(best, _py_kadane(run))
        assert kadane.reference_align_score(a, b, wgs, mg) == best


def test_batch_matches_reference_default_constants(rng):
    seqs_a, seqs_b = [], []
    for _ in range(64):
        n = int(rng.integers(1, 300))
        seqs_a.append(random_dna(rng, n))
        seqs_b.append(random_dna(rng, int(rng.integers(1, 300))))
    arr_a, len_a = encode.pad_batch(seqs_a, pad_to=512, pad_value=int(encode.PAD_A))
    arr_b, len_b = encode.pad_batch(seqs_b, pad_to=512, pad_value=int(encode.PAD_B))
    got = np.asarray(
        kadane.kadane_score_batch(
            jnp.asarray(arr_a), jnp.asarray(arr_b), jnp.asarray(len_a), jnp.asarray(len_b)
        )
    )
    for i in range(64):
        assert kadane.degenerate_regime(min(len(seqs_a[i]), len(seqs_b[i])))
        expect = kadane.reference_align_score(seqs_a[i], seqs_b[i])
        assert got[i] == expect, i


def test_self_alignment_scores_two():
    # Self-alignment: every position matches -> score 2 in the degenerate
    # regime (what --full-wgs accumulates per chunk, aligner.rs:274-276).
    a, la = encode.pad_batch([b"ACGT" * 300], pad_to=2048)
    got = kadane.kadane_score_batch(
        jnp.asarray(a), jnp.asarray(a), jnp.asarray(la), jnp.asarray(la)
    )
    assert int(got[0]) == 2
    assert kadane.reference_align_score(b"ACGT" * 300, b"ACGT" * 300) == 2


def test_empty_sequence_scores_zero():
    a, la = encode.pad_batch([b""], pad_to=8, pad_value=int(encode.PAD_A))
    b, lb = encode.pad_batch([b"ACGT"], pad_to=8, pad_value=int(encode.PAD_B))
    got = kadane.kadane_score_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb)
    )
    assert int(got[0]) == 0


def test_contiguous_kadane_monoid(rng):
    for _ in range(10):
        n = int(rng.integers(1, 400))
        a = random_dna(rng, n)
        b = random_dna(rng, n)
        scores = [2 if a[i] == b[i] else -1 for i in range(n)]
        expect = _py_kadane(scores)
        arr_a, la = encode.pad_batch([a], pad_to=512, pad_value=int(encode.PAD_A))
        arr_b, lb = encode.pad_batch([b], pad_to=512, pad_value=int(encode.PAD_B))
        got = kadane.kadane_contiguous_batch(
            jnp.asarray(arr_a), jnp.asarray(arr_b), jnp.asarray(la), jnp.asarray(lb)
        )
        assert int(got[0]) == expect


def test_kadane_combine_associative(rng):
    # Split a score sequence at two points; fold summaries both ways.
    scores = rng.integers(-3, 3, size=90)
    segs = np.split(scores, [30, 60])
    summs = [
        kadane.kadane_summary(jnp.asarray(s)[None, :], jnp.ones((1, len(s)), bool))
        for s in segs
    ]
    left = kadane.kadane_combine(kadane.kadane_combine(summs[0], summs[1]), summs[2])
    right = kadane.kadane_combine(summs[0], kadane.kadane_combine(summs[1], summs[2]))
    whole = kadane.kadane_summary(
        jnp.asarray(scores)[None, :], jnp.ones((1, 90), bool)
    )
    for f in ("total", "best", "prefix", "suffix"):
        assert int(getattr(left, f)[0]) == int(getattr(right, f)[0])
    assert int(left.best[0]) == int(whole.best[0]) == max(0, _py_kadane(scores))
