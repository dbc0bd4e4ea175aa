"""Reads-vs-reference exhaustive SW scan vs the quadratic golden DP."""

import numpy as np
import jax.numpy as jnp
import pytest

from mini_parallel.ops import encode, sw
from tests.conftest import random_dna


def _run(reads, ref, pad=64):
    arr, _ = encode.pad_batch(reads, pad_to=pad, pad_value=int(encode.PAD_A))
    ref_arr = np.frombuffer(ref, np.uint8)
    s, p = sw.sw_vs_ref_batch(jnp.asarray(arr), jnp.asarray(ref_arr))
    return np.asarray(s), np.asarray(p)


def test_exact_substring_maps_to_position(rng):
    ref = random_dna(rng, 300)
    reads = [ref[37 : 37 + 50], ref[0:40], ref[260:300]]
    s, p = _run(reads, ref)
    assert s.tolist() == [100, 80, 80]
    # perfect matches end at their true last base (unless an earlier tie)
    golden = [sw.sw_vs_ref_numpy(r, ref) for r in reads]
    assert p.tolist() == [g[1] for g in golden]
    assert golden[0][1] <= 37 + 49  # ties can only move it earlier


def test_matches_golden_on_random_and_mutated(rng):
    ref = random_dna(rng, 200)
    reads = []
    for i in range(9):
        start = int(rng.integers(0, 150))
        r = bytearray(ref[start : start + 40])
        if i % 3 == 0:
            r[7] = ord("A") if r[7] != ord("A") else ord("C")  # SNP
        if i % 3 == 1:
            del r[20:22]  # deletion
        reads.append(bytes(r))
    reads.append(random_dna(rng, 40))  # unrelated read
    s, p = _run(reads, ref)
    for k, r in enumerate(reads):
        gs, gp = sw.sw_vs_ref_numpy(r, ref)
        assert s[k] == gs, (k, s[k], gs)
        assert p[k] == gp, (k, p[k], gp)


def test_no_alignment_position_is_minus_one():
    # read that cannot score > 0 against the ref
    s, p = _run([b"TTTT"], b"CCCCCCCCCCCC", pad=8)
    assert s[0] == 0 and p[0] == -1


def test_empty_read(rng):
    ref = random_dna(rng, 64)
    s, p = _run([b"", ref[10:30]], ref)
    assert s[0] == 0 and p[0] == -1
    assert s[1] == 40


@pytest.mark.parametrize("m,n,B", [(8, 200, 5), (40, 41, 7), (64, 33, 3)])
def test_scan_matches_golden_geometries(rng, m, n, B):
    """Reads longer or shorter than the reference, ragged lengths, and a
    planted copy per read: scores and smallest end positions exact."""
    ref = random_dna(rng, n)
    reads = []
    for i in range(B):
        L = int(rng.integers(1, m + 1))
        if i % 2 == 0 and L <= n:
            s0 = int(rng.integers(0, n - L + 1))
            reads.append(ref[s0:s0 + L])
        else:
            reads.append(random_dna(rng, L))
    s, p = _run(reads, ref, pad=m)
    for k, r in enumerate(reads):
        assert (s[k], p[k]) == sw.sw_vs_ref_numpy(r, ref), k


def test_tied_ends_take_smallest_position():
    """A read that matches twice scores once, at the earlier end."""
    ref = b"ACGTTT" + b"GGCCAGT" + b"TTTT" + b"GGCCAGT" + b"A"
    s, p = _run([b"GGCCAGT"], ref, pad=8)
    assert (s[0], p[0]) == sw.sw_vs_ref_numpy(b"GGCCAGT", ref) == (14, 12)
