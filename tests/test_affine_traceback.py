"""Affine-gap (Gotoh) traceback: batched scan + device walk vs golden DP."""

import numpy as np
import jax.numpy as jnp

from mini_parallel.ops import encode, sw
from mini_parallel.ops.sw_traceback import (
    sw_affine_align_batch,
    sw_affine_align_numpy,
    sw_affine_positions_batch,
)
from tests.conftest import random_dna


def _pad(reads_a, reads_b, pad=64):
    arr_a, _ = encode.pad_batch(reads_a, pad_to=pad, pad_value=int(encode.PAD_A))
    arr_b, _ = encode.pad_batch(reads_b, pad_to=pad, pad_value=int(encode.PAD_B))
    return jnp.asarray(arr_a), jnp.asarray(arr_b)


def _indel_pairs(rng, n=14):
    pairs = []
    for i in range(n):
        b = random_dna(rng, 56)
        a = bytearray(b[4:52])
        if i % 4 == 0:
            del a[20:24]  # 4bp deletion: affine strongly prefers ONE gap run
        if i % 4 == 1:
            a[12:12] = b"TTCGA"  # 5bp insertion
        if i % 4 == 2:
            a[8] = ord("T") if a[8] != ord("T") else ord("G")
            del a[30:32]
        pairs.append((bytes(a), b))
    pairs.append((b"", random_dna(rng, 30)))  # empty query
    pairs.append((random_dna(rng, 30), random_dna(rng, 30)))  # unrelated
    return pairs


def test_affine_cigar_matches_golden():
    # local rng: exact-CIGAR checks are alignment-shape sensitive
    rng = np.random.default_rng(555)
    pairs = _indel_pairs(rng)
    a, b = _pad([p[0] for p in pairs], [p[1] for p in pairs])
    alns = sw_affine_align_batch(a, b)
    for k, (qa, qb) in enumerate(pairs):
        want = sw_affine_align_numpy(qa, qb)
        got = alns[k]
        assert got.score == want.score, (k, got, want)
        # the device (diagonal-major) and golden (row-major) argmax can pick
        # different equally-optimal endpoints; the exact-CIGAR check only
        # applies when the tied endpoints agree
        if (got.query_end, got.ref_end) == (want.query_end, want.ref_end):
            assert got.cigar == want.cigar, (k, got.cigar, want.cigar)
            assert (got.query_start, got.ref_start) == (
                want.query_start, want.ref_start)


def test_affine_score_matches_scan_scorer():
    rng = np.random.default_rng(556)
    pairs = _indel_pairs(rng, n=10)
    a, b = _pad([p[0] for p in pairs], [p[1] for p in pairs])
    alns = sw_affine_align_batch(a, b)
    scores = np.asarray(sw.sw_affine_batch(a, b))
    assert [al.score for al in alns] == scores.tolist()


def test_affine_gap_run_is_one_event():
    """Under affine costs a 4bp deletion is one 4D run, not alternating ops."""
    rng = np.random.default_rng(557)
    b = random_dna(rng, 50)
    a = b[:20] + b[24:]  # clean 4bp deletion
    arr_a, arr_b = _pad([a], [b])
    aln = sw_affine_align_batch(arr_a, arr_b)[0]
    assert "4D" in aln.cigar
    assert aln.cigar.count("D") == 1


def test_affine_positions_match_host_walk():
    rng = np.random.default_rng(558)
    pairs = _indel_pairs(rng)
    a, b = _pad([p[0] for p in pairs], [p[1] for p in pairs])
    score, pos = sw_affine_positions_batch(a, b)
    score, pos = np.asarray(score), np.asarray(pos)
    alns = sw_affine_align_batch(a, b)
    for k, aln in enumerate(alns):
        want = np.full(64, -1, np.int32)
        if aln.score > 0:
            qi, rj = aln.query_start, aln.ref_start
            for count, op in aln.cigar_ops():
                if op == "M":
                    want[qi : qi + count] = np.arange(rj, rj + count)
                    qi += count
                    rj += count
                elif op == "I":
                    qi += count
                else:
                    rj += count
        assert score[k] == aln.score
        np.testing.assert_array_equal(pos[k], want, err_msg=f"pair {k}")


def _positions_from_cigar(aln, width=64):
    want = np.full(width, -1, np.int32)
    if aln.score > 0:
        qi, rj = aln.query_start, aln.ref_start
        for count, op in aln.cigar_ops():
            if op == "M":
                want[qi:qi + count] = np.arange(rj, rj + count)
                qi += count
                rj += count
            elif op == "I":
                qi += count
            else:
                rj += count
    return want


def test_affine_argmax_matches_golden_endpoint():
    """sw_affine_moves_batch's (best, diagonal, row) argmax is the golden
    DP's best cell under the shared tie-break (first diagonal, then
    smallest row)."""
    from mini_parallel.ops.sw_traceback import sw_affine_moves_batch

    rng = np.random.default_rng(559)
    pairs = _indel_pairs(rng)
    a, b = _pad([p[0] for p in pairs], [p[1] for p in pairs])
    best, bd, bi, _ = (np.asarray(x) for x in sw_affine_moves_batch(a, b))
    for k, (qa, qb) in enumerate(pairs):
        want = sw_affine_align_numpy(qa, qb)
        assert best[k] == want.score, k
        if want.score > 0:
            assert bi[k] == want.query_end - 1, k
            assert bd[k] == want.query_end + want.ref_end - 2, k


def test_affine_positions_match_golden_walk():
    """sw_affine_positions_batch (the gapped-affine pipeline's traceback)
    == the golden Gotoh walk on indel-bearing pairs."""
    rng = np.random.default_rng(560)
    pairs = _indel_pairs(rng)
    a, b = _pad([p[0] for p in pairs], [p[1] for p in pairs])
    s, pos = (np.asarray(x) for x in sw_affine_positions_batch(a, b))
    for k, (qa, qb) in enumerate(pairs):
        want = sw_affine_align_numpy(qa, qb)
        assert s[k] == want.score, k
        np.testing.assert_array_equal(pos[k], _positions_from_cigar(want),
                                      err_msg=f"pair {k}")


def test_affine_positions_nondefault_gaps():
    """The same parity holds for non-default (gap_open, gap_extend)."""
    rng = np.random.default_rng(561)
    pairs = _indel_pairs(rng, n=8)
    a, b = _pad([p[0] for p in pairs], [p[1] for p in pairs])
    s, pos = (np.asarray(x) for x in sw_affine_positions_batch(
        a, b, gap_open=-5, gap_extend=-2))
    for k, (qa, qb) in enumerate(pairs):
        want = sw_affine_align_numpy(qa, qb, gap_open=-5, gap_extend=-2)
        assert s[k] == want.score, k
        np.testing.assert_array_equal(pos[k], _positions_from_cigar(want),
                                      err_msg=f"pair {k}")
