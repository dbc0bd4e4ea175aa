"""SW traceback/CIGAR: batched device path vs golden, plus re-scoring checks."""

import numpy as np
import jax.numpy as jnp
import pytest

from mini_parallel.ops import encode, sw
from mini_parallel.ops.sw_traceback import (
    Alignment,
    sw_align_batch,
    sw_align_numpy,
)
from tests.conftest import random_dna


def rescore(aln: Alignment, a: bytes, b: bytes) -> int:
    """Recompute the score implied by the CIGAR path — validates any
    tie-broken variant, not just the golden's choice."""
    qi, ji = aln.query_start, aln.ref_start
    score = 0
    for count, op in aln.cigar_ops():
        for _ in range(count):
            if op == "M":
                score += 2 if a[qi] == b[ji] else -1
                qi += 1
                ji += 1
            elif op == "I":
                score += -2
                qi += 1
            else:
                score += -2
                ji += 1
    assert qi == aln.query_end and ji == aln.ref_end
    return score


def _batchify(ra, rb, pad=64):
    A, _ = encode.pad_batch(ra, pad_to=pad, pad_value=int(encode.PAD_A))
    B, _ = encode.pad_batch(rb, pad_to=pad, pad_value=int(encode.PAD_B))
    return jnp.asarray(A), jnp.asarray(B)


def test_golden_simple_match():
    aln = sw_align_numpy("ACGT", "ACGT")
    assert aln.score == 8 and aln.cigar == "4M"
    assert (aln.query_start, aln.query_end) == (0, 4)


def test_golden_gap():
    # AAAATTTCCCC vs AAAACCCC: linear gap -2 each; best path 8M? golden DP
    aln = sw_align_numpy("AAAATTTCCCC", "AAAACCCC")
    assert aln.score == sw.sw_score_numpy("AAAATTTCCCC", "AAAACCCC")
    assert rescore(aln, b"AAAATTTCCCC", b"AAAACCCC") == aln.score


def test_batch_scores_and_cigars_match_golden(rng):
    ra = [random_dna(rng, int(rng.integers(5, 60))) for _ in range(20)]
    rb = [random_dna(rng, int(rng.integers(5, 60))) for _ in range(20)]
    A, B = _batchify(ra, rb)
    alns = sw_align_batch(A, B)
    for k, aln in enumerate(alns):
        gold = sw_align_numpy(ra[k], rb[k])
        assert aln.score == gold.score, k
        # NOTE: when several cells tie for the best score, the golden (row-
        # major) and batched (diagonal-major) argmaxes may pick different,
        # equally-optimal endpoints — so exact CIGAR equality is only
        # guaranteed when the endpoints agree. Every path must re-score to
        # the reported score regardless.
        if (aln.query_end, aln.ref_end) == (gold.query_end, gold.ref_end):
            assert aln.cigar == gold.cigar, k
            assert (aln.query_start, aln.ref_start) == (
                gold.query_start, gold.ref_start), k
        if aln.score > 0:
            assert rescore(aln, ra[k], rb[k]) == aln.score


def test_batch_with_indel_structure(rng):
    # reads derived from a template with an insertion: CIGAR must contain I/D
    t = random_dna(rng, 80)
    q = t[:40] + b"GGGG" + t[40:]  # 4-base insertion in the query
    A, B = _batchify([q], [t], pad=96)
    aln = sw_align_batch(A, B)[0]
    assert aln.score == sw.sw_score_numpy(q, t)
    assert "I" in aln.cigar
    assert rescore(aln, q, t) == aln.score


def test_no_alignment():
    A, B = _batchify([b"AAAA"], [b"TTTT"], pad=8)
    aln = sw_align_batch(A, B)[0]
    assert aln.score == 0 and aln.cigar == ""


def test_sw_positions_batch_matches_host_walk(rng):
    """Device traceback positions == host CIGAR application, incl. indels."""
    from mini_parallel.ops.sw_traceback import (
        sw_align_batch, sw_positions_batch)

    reads_a, reads_b = [], []
    for i in range(12):
        b = random_dna(rng, 60)
        a = bytearray(b[5:55])
        if i % 3 == 0:
            del a[20:23]  # deletion in query -> I/D structure
        if i % 3 == 1:
            a[10:10] = b"GGG"  # insertion
        if i % 4 == 0:
            a[5] = ord("T") if a[5] != ord("T") else ord("A")  # SNP
        reads_a.append(bytes(a))
        reads_b.append(b)
    arr_a, len_a = encode.pad_batch(reads_a, pad_to=64, pad_value=int(encode.PAD_A))
    arr_b, len_b = encode.pad_batch(reads_b, pad_to=64, pad_value=int(encode.PAD_B))
    a, b = jnp.asarray(arr_a), jnp.asarray(arr_b)

    score, pos = sw_positions_batch(a, b)
    score, pos = np.asarray(score), np.asarray(pos)
    alns = sw_align_batch(a, b)
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
        np.testing.assert_array_equal(pos[k], want, err_msg=f"read {k}")


def _positions_from_cigar(aln, width):
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


def _related_batch(rng, B, M, N):
    base = np.frombuffer(b"ACGT", np.uint8)
    a = np.full((B, M), int(encode.PAD_A), np.uint8)
    b = np.full((B, N), int(encode.PAD_B), np.uint8)
    ra, rb = [], []
    for i in range(B):
        la = int(rng.integers(5, M)); lb = int(rng.integers(5, N))
        a[i, :la] = rng.choice(base, la)
        if rng.random() < 0.7:  # related pair -> real gapped walks
            mut = bytearray(a[i, :la].tobytes() * 2)[:lb]
            for _ in range(3):
                p = int(rng.integers(0, max(1, len(mut))))
                mut[p:p + 1] = b""
            seg = np.frombuffer(bytes(mut), np.uint8)[:lb]
            b[i, :len(seg)] = seg
            lb = len(seg)
        else:
            b[i, :lb] = rng.choice(base, lb)
        ra.append(a[i, :la].tobytes())
        rb.append(b[i, :lb].tobytes())
    return ra, rb, jnp.asarray(a), jnp.asarray(b)


def test_moves_match_golden_move_matrix(rng):
    """Every valid move code sw_moves_batch emits equals the golden DP's
    move for that cell (priority diag > up > left, stop at the floor)."""
    from mini_parallel.ops.sw_traceback import DIAG, LEFT, STOP, UP, \
        sw_moves_batch

    ra, rb, a, b = _related_batch(rng, 12, 24, 40)
    best, bd, bi, moves = (np.asarray(x) for x in sw_moves_batch(a, b))
    for k, (qa, qb) in enumerate(zip(ra, rb)):
        m, n = len(qa), len(qb)
        H = np.zeros((m + 1, n + 1), np.int64)
        for i in range(1, m + 1):
            for j in range(1, n + 1):
                s = 2 if qa[i - 1] == qb[j - 1] else -1
                diag, up = H[i - 1, j - 1] + s, H[i - 1, j] - 2
                left = H[i, j - 1] - 2
                h = max(0, diag, up, left)
                H[i, j] = h
                want = (STOP if h == 0 else DIAG if h == diag
                        else UP if h == up else LEFT)
                assert moves[i + j - 2, k, i - 1] == want, (k, i, j)
        assert best[k] == H.max()


@pytest.mark.parametrize("B,M,N", [(16, 24, 40), (5, 40, 24)])
def test_positions_match_golden_walk_gapped_pairs(rng, B, M, N):
    """sw_positions_batch (the gapped pipeline's traceback) == the golden
    DP's walk: scores and per-base reference positions."""
    from mini_parallel.ops.sw_traceback import sw_positions_batch

    ra, rb, a, b = _related_batch(rng, B, M, N)
    score, pos = (np.asarray(x) for x in sw_positions_batch(a, b))
    for k, (qa, qb) in enumerate(zip(ra, rb)):
        want = sw_align_numpy(qa, qb)
        assert score[k] == want.score, k
        np.testing.assert_array_equal(pos[k], _positions_from_cigar(want, M),
                                      err_msg=f"pair {k}")
