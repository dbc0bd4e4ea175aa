"""Pair-HMM forward: kernel vs float64 oracle, genotype likelihood model."""

import numpy as np
import pytest

from mini_parallel.ops import pairhmm
from mini_parallel.ops.pairhmm import pairhmm_log10_batch
from tests.conftest import random_dna


def _quals(rng, n, lo=15, hi=40):
    return rng.integers(lo, hi, n).astype(np.float64)


def test_oracle_perfect_match_dominates(rng):
    hap = random_dna(rng, 40)
    q = np.full(20, 30.0)
    read = hap[10:30]
    ll_match = pairhmm.pairhmm_forward_numpy(read, q, hap)
    ll_mismatch = pairhmm.pairhmm_forward_numpy(
        random_dna(rng, 20), q, hap)
    assert ll_match > ll_mismatch
    # perfect 20bp read: ~ (1-2δ)^19 * Π(1-err) * (1-ε)/n -> near -log10(n)
    assert -4.0 < ll_match < -1.0


def test_oracle_single_mismatch_costs_base_quality(rng):
    hap = random_dna(rng, 60)
    read = bytearray(hap[20:50])
    q = np.full(30, 20.0)
    clean = pairhmm.pairhmm_forward_numpy(bytes(read), q, hap)
    read[15] = ord("A") if read[15] != ord("A") else ord("C")
    dirty = pairhmm.pairhmm_forward_numpy(bytes(read), q, hap)
    # one Q20 mismatch ~ err/3 vs (1-err): ~ -(2 + log10(3)) log10 units
    assert pytest.approx(clean - dirty, abs=0.35) == 2.0 + np.log10(3)


def test_kernel_matches_oracle_random(rng):
    reads, quals, haps, want = [], [], [], []
    for i in range(9):  # mixed lengths, mixed error content
        hap = random_dna(rng, int(rng.integers(30, 90)))
        m = int(rng.integers(10, min(40, len(hap))))
        s = int(rng.integers(0, len(hap) - m))
        read = bytearray(hap[s : s + m])
        for _ in range(int(rng.integers(0, 3))):  # sprinkle mismatches
            read[int(rng.integers(0, m))] = ord("ACGT"[int(rng.integers(4))])
        q = _quals(rng, m)
        reads.append(bytes(read))
        quals.append(q)
        haps.append(hap)
        want.append(pairhmm.pairhmm_forward_numpy(bytes(read), q, hap))
    got = pairhmm_log10_batch(reads, quals, haps)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_kernel_ascii_quals_and_indel_reads(rng):
    hap = random_dna(rng, 80)
    read_del = hap[10:30] + hap[33:55]  # 3bp deletion
    read_ins = hap[10:30] + b"ACGT" + hap[30:48]  # 4bp insertion
    reads = [read_del, read_ins]
    quals = [bytes([33 + 25] * len(r)) for r in reads]  # Phred+33 ASCII
    want = [
        pairhmm.pairhmm_forward_numpy(r, np.full(len(r), 25.0), hap)
        for r in reads
    ]
    got = pairhmm_log10_batch(reads, quals, [hap, hap])
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    # gapped reads still vastly more likely than a random read
    ll_rand = pairhmm_log10_batch(
        [random_dna(rng, 40)], [bytes([33 + 25] * 40)], [hap])[0]
    assert min(got) > ll_rand


def test_kernel_empty_inputs():
    got = pairhmm_log10_batch([b""], [b""], [b"ACGT"])
    assert got[0] == -np.inf
    assert pairhmm_log10_batch([], [], []).size == 0


def test_underflow_falls_back_to_oracle(rng):
    # 120 mismatches at Q40: the best path is all-gaps (~delta*eps^119,
    # ll ~ -123), far below the scaled-fp32 floor (~-74) -> the kernel
    # underflows to 0 and the float64 oracle fallback must kick in
    hap = random_dna(rng, 140)
    read = bytes(
        {65: 67, 67: 65, 71: 84, 84: 71}[b] for b in hap[:120]
    )  # every base mismatched
    q = np.full(120, 40.0)
    want = pairhmm.pairhmm_forward_numpy(read, q, hap)
    got = pairhmm_log10_batch([read], [q], [hap])[0]
    assert np.isfinite(got) and got < -100
    assert got == pytest.approx(want, abs=1e-9)  # exactly the oracle's value


def test_genotype_likelihoods_model():
    # reads strongly supporting alt: AA >> RA >> RR
    ref_ll = np.array([-30.0, -28.0, -31.0])
    alt_ll = np.array([-3.0, -2.5, -3.2])
    rr, ra, aa = pairhmm.genotype_likelihoods(ref_ll, alt_ll)
    assert aa > ra > rr
    # het: half the reads support each allele -> RA beats both homs
    ref_ll = np.array([-3.0, -30.0, -3.1, -29.0])
    alt_ll = np.array([-30.0, -3.0, -28.0, -3.2])
    rr, ra, aa = pairhmm.genotype_likelihoods(ref_ll, alt_ll)
    assert ra > rr and ra > aa


def test_pairhmm_sharded_matches_local(rng, mesh8):
    import jax.numpy as jnp

    from mini_parallel.ops import encode
    from mini_parallel.ops.pairhmm import make_pairhmm_sharded, pairhmm_batch

    B = 16  # 2 rows per device on the 8-device mesh
    reads, haps = [], []
    for _ in range(B):
        hap = random_dna(rng, 48)
        reads.append(hap[8:40])
        haps.append(hap)
    arr_r, la = encode.pad_batch(reads, pad_to=32, pad_value=int(encode.PAD_A))
    arr_h, lb = encode.pad_batch(haps, pad_to=48, pad_value=int(encode.PAD_B))
    err = np.full((B, 32), 1e-2, np.float32)
    args = (jnp.asarray(arr_r), jnp.asarray(err), jnp.asarray(arr_h),
            jnp.asarray(la), jnp.asarray(lb))
    local = np.asarray(pairhmm_batch(*args))
    sharded = np.asarray(make_pairhmm_sharded(mesh8)(*args))
    np.testing.assert_allclose(sharded, local, rtol=0, atol=1e-6)


def test_pairhmm_log10_batch_mesh_matches_local(rng, mesh8):
    reads, quals, haps = [], [], []
    for _ in range(11):  # deliberately not divisible by 8 (padding path)
        hap = random_dna(rng, 60)
        reads.append(hap[10:42])
        quals.append(bytes([33 + 30] * 32))
        haps.append(hap)
    local = pairhmm_log10_batch(reads, quals, haps)
    sharded = pairhmm_log10_batch(reads, quals, haps, mesh=mesh8)
    np.testing.assert_allclose(sharded, local, rtol=0, atol=1e-6)


def test_genotype_likelihoods_survives_double_underflow():
    # a read that explains NEITHER haplotype (-inf from both) must not
    # produce NaN genotype likelihoods (it carries no GT information)
    ref_ll = np.array([-3.0, -np.inf])
    alt_ll = np.array([-30.0, -np.inf])
    rr, ra, aa = pairhmm.genotype_likelihoods(ref_ll, alt_ll)
    assert np.isfinite([rr, ra, aa]).all()
    assert rr > aa  # the informative read still dominates
