"""Hypothesis fuzz tests for the bit-exactness contracts.

Each property pins the core invariant the framework is built on: the packed
wire format reproduces bytes exactly, the device scorers agree with the
quadratic golden DPs, and parity mode matches the reference-dispatch
emulation — over arbitrary generated inputs, not just seeded fixtures.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from mini_parallel.ops import encode, kadane, packed, sw

settings.register_profile("ci", max_examples=25, deadline=None)
settings.register_profile("deep", max_examples=200, deadline=None)
# MPT_HYPOTHESIS_PROFILE=deep for an extended fuzz burst (e.g. round end)
import os  # noqa: E402

settings.load_profile(os.environ.get("MPT_HYPOTHESIS_PROFILE", "ci"))

dna = st.text(alphabet="ACGT", min_size=0, max_size=48)
messy = st.text(
    alphabet="ACGTNacgtnRYKM", min_size=0, max_size=48
)  # IUPAC/lowercase: exception-list territory


@given(st.lists(messy, min_size=1, max_size=12))
def test_packed_roundtrip_any_bytes(seqs):
    reads = [s.encode() for s in seqs]
    pad = -(-max(max((len(r) for r in reads), default=1), 4) // 4) * 4
    arr, lens = encode.pad_batch(reads, pad_to=pad, pad_value=int(encode.PAD_A))
    pb = packed.pack_batch(arr, lens)
    out = np.asarray(
        packed.unpack_device(*packed.device_args(pb), int(encode.PAD_A))
    )
    np.testing.assert_array_equal(out, arr)


@given(dna, dna)
def test_sw_batch_matches_golden(a, b):
    want = sw.sw_score_numpy(a, b)
    arr_a, _ = encode.pad_batch([a], pad_to=48, pad_value=int(encode.PAD_A))
    arr_b, _ = encode.pad_batch([b], pad_to=48, pad_value=int(encode.PAD_B))
    got = int(sw.sw_score_batch(jnp.asarray(arr_a), jnp.asarray(arr_b))[0])
    assert got == want


@given(dna, dna)
def test_affine_batch_matches_golden(a, b):
    want = sw.sw_affine_numpy(a, b)
    arr_a, _ = encode.pad_batch([a], pad_to=48, pad_value=int(encode.PAD_A))
    arr_b, _ = encode.pad_batch([b], pad_to=48, pad_value=int(encode.PAD_B))
    got = int(sw.sw_affine_batch(jnp.asarray(arr_a), jnp.asarray(arr_b))[0])
    assert got == want


@given(messy, messy)
def test_kadane_parity_matches_reference_emulation(a, b):
    """Device kadane == the NumPy emulation of the reference's OpenCL
    dispatch, for arbitrary byte content (parity is byte-equality based)."""
    a, b = a.encode(), b.encode()
    want = kadane.reference_align_score(a, b)
    arr_a, la = encode.pad_batch([a], pad_to=64, pad_value=int(encode.PAD_A))
    arr_b, lb = encode.pad_batch([b], pad_to=64, pad_value=int(encode.PAD_B))
    got = int(
        kadane.kadane_score_batch(
            jnp.asarray(arr_a), jnp.asarray(arr_b),
            jnp.asarray(la), jnp.asarray(lb),
        )[0]
    )
    assert got == want


@given(st.lists(dna, min_size=1, max_size=8), st.integers(3, 8))
def test_kmer_counts_match_golden(seqs, k):
    from mini_parallel.ops import kmer

    reads = [s.encode() for s in seqs]
    pad = -(-max(max((len(r) for r in reads), default=1), k + 1) // 8) * 8
    arr, lens = encode.pad_batch(reads, pad_to=pad, pad_value=int(encode.PAD_A))
    codes = encode.ascii_to_code(jnp.asarray(arr))
    hi, lo, counts, nu = kmer.unique_counts_batch(codes, jnp.asarray(lens), k=k)
    hi, lo, counts = np.asarray(hi), np.asarray(lo), np.asarray(counts)
    got = {}
    kmer.merge_device_counts(got, hi, lo, counts)
    got_str = {kmer.key_to_string(h, l, k): c for (h, l), c in got.items()}
    assert got_str == dict(kmer.count_kmers_python(reads, k=k))


dna1 = st.text(alphabet="ACGT", min_size=1, max_size=32)


@given(dna1, dna1, st.lists(st.integers(5, 42), min_size=32, max_size=32))
def test_pairhmm_kernel_matches_oracle(read, hap, qlist):
    from mini_parallel.ops import pairhmm
    from mini_parallel.ops.pairhmm import pairhmm_log10_batch

    q = np.asarray(qlist[: len(read)], np.float64)
    want = pairhmm.pairhmm_forward_numpy(read.encode(), q, hap.encode())
    got = pairhmm_log10_batch([read.encode()], [q], [hap.encode()])[0]
    if want == float("-inf"):
        assert got == float("-inf") or got < -70
    else:
        assert got == __import__("pytest").approx(want, abs=3e-3)


@given(dna, dna)
def test_sw_long_strips_match_quadratic(a, b):
    """Column-strip engine == quadratic golden on arbitrary small pairs
    (wavefront never filling the strip, ragged geometry, empty inputs)."""
    from mini_parallel.ops.sw_long import sw_score_long

    got = sw_score_long(a.encode(), b.encode(), width=1024, blk=512)
    assert got == sw.sw_score_numpy(a, b)


@given(dna, dna)
def test_sw_affine_long_strips_match_gotoh(a, b):
    from mini_parallel.ops.sw_long import sw_affine_score_long

    got = sw_affine_score_long(a.encode(), b.encode(), width=1024, blk=512)
    assert got == sw.sw_affine_numpy(a, b)


@given(
    st.lists(st.tuples(st.integers(0, 60), st.integers(1, 5)),
             min_size=0, max_size=40),
    st.lists(st.tuples(st.integers(0, 60), st.integers(1, 5)),
             min_size=0, max_size=40),
    st.booleans(),
)
def test_merge_sorted_arrays_counter_oracle(ta, tb, sort_b):
    """Host k-mer fold == Counter over arbitrary key overlap, including the
    duplicate-fold fast path (both sides sorted-unique) and the lexsort
    fallback (one side unsorted / duplicated)."""
    from collections import Counter

    from mini_parallel.models.kmer_model import (
        _combined_keys, merge_sorted_arrays)

    def triple(items, sort):
        hi = np.asarray([k % 8 - 4 for k, _ in items], np.int32)
        lo = np.asarray([k // 8 for k, _ in items], np.int32)
        ct = np.asarray([c for _, c in items], np.int64)
        if sort:
            order = np.argsort(_combined_keys(hi, lo), kind="stable")
            hi, lo, ct = hi[order], lo[order], ct[order]
        return hi, lo, ct

    a = triple(ta, True)
    b = triple(tb, sort_b)
    want = Counter()
    for t in (a, b):
        for h, l, c in zip(*t):
            want[(int(h), int(l))] += int(c)
    hi, lo, ct = merge_sorted_arrays(a, b)
    got = {(int(hi[i]), int(lo[i])): int(ct[i]) for i in range(hi.size)}
    assert got == dict(+want)
    keys = _combined_keys(hi, lo)
    assert (keys[1:] > keys[:-1]).all()


@given(st.lists(st.binary(min_size=0, max_size=40), min_size=1, max_size=20),
       st.integers(0, 1))
def test_pad_batch_flat_matches_pad_batch_fuzz(rows, which_pad):
    """Flat padding == list padding for arbitrary (incl. empty/ragged)
    rows, both pad sentinels, with and without row padding."""
    pad_value = int(encode.PAD_A) if which_pad else int(encode.PAD_B)
    flat = np.frombuffer(b"".join(rows), np.uint8)
    offs = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    L = max(max((len(r) for r in rows), default=1), 1)
    want, wlen = encode.pad_batch(rows, pad_to=L, pad_value=pad_value)
    got, glen = encode.pad_batch_flat(flat, offs, pad_to=L,
                                      pad_value=pad_value)
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(wlen, glen)
    # rows_to: extra rows are all-pad, zero-length
    got2, glen2 = encode.pad_batch_flat(flat, offs, pad_to=L,
                                        pad_value=pad_value,
                                        rows_to=len(rows) + 3)
    np.testing.assert_array_equal(got2[: len(rows)], want)
    assert (got2[len(rows):] == pad_value).all()
    assert (glen2[len(rows):] == 0).all()


@given(st.lists(st.binary(min_size=0, max_size=30), min_size=1, max_size=12),
       st.integers(1, 40), st.integers(8, 24))
def test_qual_mask_flat_matches_list_path_fuzz(quals, minq, pad):
    """Vectorized flat qual mask == the per-read list path, incl. quals
    longer and shorter than pad and empty quals."""
    from mini_parallel.models.variant_prep import VariantPrepEngine

    eng = VariantPrepEngine.__new__(VariantPrepEngine)
    eng.min_base_quality = minq
    reads = [b"A" * pad for _ in quals]  # only the mask geometry matters
    want = VariantPrepEngine._qual_mask(eng, reads, quals, pad)
    qflat = np.frombuffer(b"".join(quals), np.uint8)
    qoffs = np.zeros(len(quals) + 1, np.int64)
    np.cumsum([len(q) for q in quals], out=qoffs[1:])
    got = VariantPrepEngine._qual_mask_flat(eng, qflat, qoffs, pad)
    np.testing.assert_array_equal(want, got)
