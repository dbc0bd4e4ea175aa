"""Sharding tests on the 8-device virtual CPU mesh: sharded step == local math."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mini_parallel.ops import encode, kadane, sw
from mini_parallel.parallel import mesh as mesh_mod
from mini_parallel.parallel import pipeline
from tests.conftest import random_dna


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(42)
    B, pad = 64, 64
    ra = [random_dna(rng, int(rng.integers(20, 60))) for _ in range(B)]
    rb = [random_dna(rng, int(rng.integers(20, 60))) for _ in range(B)]
    arr_a, len_a = encode.pad_batch(ra, pad_to=pad, pad_value=int(encode.PAD_A))
    arr_b, len_b = encode.pad_batch(rb, pad_to=pad, pad_value=int(encode.PAD_B))
    return ra, rb, arr_a, arr_b, len_a, len_b


def test_mesh_default_covers_all_devices():
    m = mesh_mod.make_mesh()
    assert m.devices.size == 8 and m.axis_names == ("data",)


def test_mesh_2d():
    m = mesh_mod.make_mesh((4, 2))
    assert m.axis_names == ("data", "seq")


def test_mesh_bad_shape():
    with pytest.raises(ValueError):
        mesh_mod.make_mesh((3,))


def test_wgs_step_matches_local(batch, mesh8):
    ra, rb, arr_a, arr_b, len_a, len_b = batch
    step = pipeline.make_wgs_step(mesh8)
    ja, jb, la, lb = pipeline.shard_batch(
        mesh8, (jnp.asarray(arr_a), jnp.asarray(arr_b),
                jnp.asarray(len_a), jnp.asarray(len_b))
    )
    stats = jax.device_get(step(ja, jb, la, lb))

    # local (unsharded) ground truth
    parity = kadane.kadane_score_batch(
        jnp.asarray(arr_a), jnp.asarray(arr_b), jnp.asarray(len_a), jnp.asarray(len_b)
    )
    sw_scores = np.array([sw.sw_score_numpy(a, b) for a, b in zip(ra, rb)])
    assert int(stats["parity_score"]) == int(np.asarray(parity).sum())
    assert int(stats["sw_score_sum"]) == int(sw_scores.sum())
    assert int(stats["sw_score_max"]) == int(sw_scores.max())
    assert int(stats["pairs"]) == len(ra)
    assert int(stats["bases"]) == sum(len(r) for r in ra)
    # histogram counts every valid base of reads_a
    assert int(np.asarray(stats["base_hist"]).sum()) == sum(len(r) for r in ra)


def test_wgs_step_complementarity(mesh8):
    rng = np.random.default_rng(5)
    # 8 perfectly complementary pairs + 8 random pairs
    perf_a = [random_dna(rng, 40) for _ in range(8)]
    import numpy as _np
    comp_table = _np.arange(256, dtype=_np.uint8)
    for x, y in ((ord("A"), ord("T")), (ord("C"), ord("G"))):
        comp_table[x], comp_table[y] = y, x
    perf_b = [comp_table[_np.frombuffer(a, _np.uint8)][::-1].tobytes() for a in perf_a]
    rand_a = [random_dna(rng, 40) for _ in range(8)]
    rand_b = [random_dna(rng, 40) for _ in range(8)]
    ra, rb = perf_a + rand_a, perf_b + rand_b
    arr_a, la = encode.pad_batch(ra, pad_to=64, pad_value=int(encode.PAD_A))
    arr_b, lb = encode.pad_batch(rb, pad_to=64, pad_value=int(encode.PAD_B))
    step = pipeline.make_wgs_step(mesh8)
    args = pipeline.shard_batch(
        mesh8, (jnp.asarray(arr_a), jnp.asarray(arr_b), jnp.asarray(la), jnp.asarray(lb))
    )
    stats = jax.device_get(step(*args))
    # ground truth: SW(a, revcomp(b)) == 2*minlen
    n_perfect = 0
    for a, b in zip(ra, rb):
        rc = comp_table[_np.frombuffer(b, _np.uint8)][::-1].tobytes()
        if sw.sw_score_numpy(a, rc) == 2 * min(len(a), len(b)):
            n_perfect += 1
    assert int(stats["complementary_pairs"]) == n_perfect
    assert n_perfect >= 8  # the constructed pairs must all qualify


def test_seq_parallel_kadane_exact(mesh8):
    rng = np.random.default_rng(9)
    B, L = 4, 512  # L divisible by 8 shards
    scores = rng.integers(-2, 3, size=(B, L)).astype(np.int32)
    valid = np.ones((B, L), bool)
    fn = pipeline.make_seq_parallel_kadane(mesh_mod.make_mesh((1, 8)))
    got = np.asarray(fn(jnp.asarray(scores), jnp.asarray(valid)))

    def py_best(row):
        best = cur = 0
        for s in row:
            cur = max(cur + int(s), 0)
            best = max(best, cur)
        return best

    expect = np.array([py_best(scores[i]) for i in range(B)])
    assert (got == expect).all()


def test_seq_parallel_matches_single_device(mesh8):
    rng = np.random.default_rng(11)
    B, L = 2, 256
    scores = rng.integers(-3, 4, size=(B, L)).astype(np.int32)
    valid = np.ones((B, L), bool)
    sharded = pipeline.make_seq_parallel_kadane(mesh_mod.make_mesh((1, 8)))
    local = kadane.kadane_summary(jnp.asarray(scores), jnp.asarray(valid))
    got = np.asarray(sharded(jnp.asarray(scores), jnp.asarray(valid)))
    assert (got == np.asarray(local.best)).all()


def test_wgs_step_kmer_hist(mesh8):
    """kmer_hist counts every clean k=21 window exactly once, sharded ==
    unsharded."""
    rng = np.random.default_rng(42)
    reads_a = [random_dna(rng, int(rng.integers(25, 60))) for _ in range(16)]
    reads_b = [random_dna(rng, 30) for _ in range(16)]
    reads_a[2] = reads_a[2][:10] + b"N" + reads_a[2][11:]  # kills 21 windows max
    arr_a, len_a = encode.pad_batch(reads_a, pad_to=64, pad_value=int(encode.PAD_A))
    arr_b, len_b = encode.pad_batch(reads_b, pad_to=64, pad_value=int(encode.PAD_B))
    step = pipeline.make_wgs_step(mesh8)
    args = pipeline.shard_batch(
        mesh8, (jnp.asarray(arr_a), jnp.asarray(arr_b),
                jnp.asarray(len_a), jnp.asarray(len_b)))
    stats = jax.device_get(step(*args))
    from mini_parallel.ops.kmer import count_kmers_python

    golden = count_kmers_python(reads_a, k=21)
    assert int(np.asarray(stats["kmer_hist"]).sum()) == sum(golden.values())
    assert stats["kmer_hist"].shape == (pipeline.KMER_HIST_BUCKETS,)
    # single-device mesh gives the identical histogram
    mesh1 = mesh_mod.make_mesh((1,), ("data",), devices=jax.devices()[:1])
    args1 = pipeline.shard_batch(
        mesh1, (jnp.asarray(arr_a), jnp.asarray(arr_b),
                jnp.asarray(len_a), jnp.asarray(len_b)))
    stats1 = jax.device_get(pipeline.make_wgs_step(mesh1)(*args1))
    np.testing.assert_array_equal(stats["kmer_hist"], stats1["kmer_hist"])
