"""k-mer counting: device path vs pure-Python golden Counter."""

import numpy as np
import jax.numpy as jnp
import pytest

from mini_parallel.io import fastq
from mini_parallel.models.kmer_model import KmerEngine
from mini_parallel.ops import encode, kmer
from mini_parallel.utils.config import Config
from tests.conftest import random_dna


def _device_counter(reads, k, canonical=False, pad=64):
    arr, lens = encode.pad_batch(reads, pad_to=pad, pad_value=int(encode.PAD_A))
    codes = encode.ascii_to_code(jnp.asarray(arr))
    hi, lo, counts, nu = kmer.unique_counts_batch(
        codes, jnp.asarray(lens), k=k, canonical=canonical
    )
    hi, lo, counts = np.asarray(hi), np.asarray(lo), np.asarray(counts)
    assert int(nu) == int((counts > 0).sum())
    # unique keys must be compacted to the front (the prefix-fetch contract)
    assert (counts[int(nu):] == 0).all()
    out = {}
    kmer.merge_device_counts(out, hi, lo, counts)
    return {kmer.key_to_string(h, l, k): c for (h, l), c in out.items()}


def test_pack_roundtrip_small():
    reads = [b"ACGTACGTAC"]
    got = _device_counter(reads, k=4, pad=16)
    golden = kmer.count_kmers_python(reads, k=4)
    assert got == dict(golden)
    assert got["ACGT"] == 2


def test_exact_counts_k21_random(rng):
    reads = [random_dna(rng, int(rng.integers(21, 60))) for _ in range(40)]
    got = _device_counter(reads, k=21)
    golden = kmer.count_kmers_python(reads, k=21)
    assert got == dict(golden)
    assert sum(got.values()) == sum(len(r) - 20 for r in reads)


def test_n_bases_masked(rng):
    reads = [b"ACGTNACGTACGT", b"NNNNNNNNNNNNN", b"ACGTACGTACGTA"]
    got = _device_counter(reads, k=5, pad=16)
    golden = kmer.count_kmers_python(reads, k=5)
    assert got == dict(golden)


def test_short_reads_no_windows():
    got = _device_counter([b"ACG", b"A"], k=5, pad=16)
    assert got == {}


def test_canonical_folding(rng):
    reads = [random_dna(rng, 40) for _ in range(10)]
    got = _device_counter(reads, k=7, canonical=True)
    golden = kmer.count_kmers_python(reads, k=7, canonical=True)
    assert got == dict(golden)


def test_canonical_counts_strand_neutral():
    fwd = b"ACGTACG"
    rc = b"CGTACGT"  # revcomp of ACGTACG
    got = _device_counter([fwd, rc], k=7, canonical=True, pad=16)
    assert got == {"ACGTACG": 2}


def test_kmer_engine_file(tmp_path, rng):
    reads = [random_dna(rng, 50) for _ in range(30)]
    path = str(tmp_path / "lane.fastq.gz")
    fastq.write_fastq(path, reads)
    eng = KmerEngine(Config(chunk_size_reads=7, read_pad=64), k=21)
    res = eng.count_file(path)
    golden = kmer.count_kmers_python(reads, k=21)
    assert res.total_kmers == sum(golden.values())
    assert res.distinct_kmers == len(golden)
    assert res.total_reads == 30
    as_str = {kmer.key_to_string(h, l, 21): c for (h, l), c in res.counts.items()}
    assert as_str == dict(golden)
    top = res.top(3)
    assert all(isinstance(s, str) and len(s) == 21 for s, _ in top)


def test_key_to_string_roundtrip(rng):
    reads = [random_dna(rng, 30)]
    arr, lens = encode.pad_batch(reads, pad_to=32, pad_value=int(encode.PAD_A))
    codes = encode.ascii_to_code(jnp.asarray(arr))
    hi, lo, ok = kmer.pack_kmers(codes, jnp.asarray(lens), k=21)
    hi, lo, ok = np.asarray(hi), np.asarray(lo), np.asarray(ok)
    for j in range(ok.shape[1]):
        if ok[0, j]:
            assert kmer.key_to_string(hi[0, j], lo[0, j], 21) == reads[0][j : j + 21].decode()


def test_kmer_engine_packed_matches_unpacked(tmp_path, rng):
    reads = [random_dna(rng, 40) for _ in range(25)]
    reads[3] = reads[3][:10] + b"N" + reads[3][11:]  # N -> exception path
    path = str(tmp_path / "lane.fastq.gz")
    fastq.write_fastq(path, reads)
    on = KmerEngine(Config(chunk_size_reads=9, read_pad=48, packed_transfer=True), k=21)
    off = KmerEngine(Config(chunk_size_reads=9, read_pad=48, packed_transfer=False), k=21)
    r_on, r_off = on.count_file(path), off.count_file(path)
    assert r_on.total_kmers == r_off.total_kmers
    assert r_on.distinct_kmers == r_off.distinct_kmers
    assert r_on.counts == r_off.counts


def test_kmer_engine_sharded_matches_local(tmp_path, rng, mesh8):
    """Mesh-sharded exact counting == single-device, non-multiple batches."""
    reads = [random_dna(rng, int(rng.integers(25, 50))) for _ in range(35)]
    reads[4] = reads[4][:8] + b"N" + reads[4][9:]
    path = str(tmp_path / "sk.fastq.gz")
    fastq.write_fastq(path, reads)
    cfg = Config(chunk_size_reads=13, read_pad=56)
    local = KmerEngine(cfg, k=21).count_file(path)
    shard = KmerEngine(cfg, k=21, mesh=mesh8).count_file(path)
    assert shard.total_kmers == local.total_kmers
    assert shard.distinct_kmers == local.distinct_kmers
    assert shard.counts == local.counts


def test_device_accumulator_matches_host_merge(rng):
    """DeviceKmerAccumulator == dict merge across batches, incl. a staging
    flush, a shape change, and duplicate keys across batches."""
    import jax.numpy as jnp

    from mini_parallel.ops.kmer import DeviceKmerAccumulator

    acc = DeviceKmerAccumulator(capacity=1 << 12, staging_batches=2)
    want: dict = {}
    for bi, (B, pad) in enumerate([(6, 32), (6, 32), (6, 32), (4, 40)]):
        reads = [random_dna(rng, int(rng.integers(9, pad - 2)))
                 for _ in range(B)]
        if bi:
            reads[0] = reads0  # duplicate keys across batches
        else:
            reads0 = reads[0]
        arr, lens = encode.pad_batch(reads, pad_to=pad,
                                     pad_value=int(encode.PAD_A))
        codes = encode.ascii_to_code(jnp.asarray(arr))
        hi, lo, ct, nu = kmer.unique_counts_batch(codes, jnp.asarray(lens), k=9)
        acc.add(hi, lo, ct)
        kmer.merge_device_counts(want, np.asarray(hi), np.asarray(lo),
                                 np.asarray(ct))
    hi, lo, ct = acc.drain()
    got = {(int(h), int(l)): int(c) for h, l, c in zip(hi, lo, ct)}
    assert got == want
    # sorted, compacted output
    keys = list(zip(hi.tolist(), lo.tolist()))
    assert keys == sorted(keys)


def test_device_accumulator_spill_exact(rng):
    """Overflowing the device capacity spills to host and stays exact."""
    import jax.numpy as jnp

    from mini_parallel.ops.kmer import DeviceKmerAccumulator

    acc = DeviceKmerAccumulator(capacity=64, staging_batches=1)
    want: dict = {}
    for _ in range(4):
        reads = [random_dna(rng, 20) for _ in range(8)]
        arr, lens = encode.pad_batch(reads, pad_to=24,
                                     pad_value=int(encode.PAD_A))
        codes = encode.ascii_to_code(jnp.asarray(arr))
        hi, lo, ct, nu = kmer.unique_counts_batch(codes, jnp.asarray(lens), k=9)
        acc.add(hi, lo, ct)
        kmer.merge_device_counts(want, np.asarray(hi), np.asarray(lo),
                                 np.asarray(ct))
    assert acc.spilled or len(want) <= 64  # capacity 64 << distinct keys
    hi, lo, ct = acc.drain()
    got = {(int(h), int(l)): int(c) for h, l, c in zip(hi, lo, ct)}
    assert got == want


def test_kmer_engine_device_accumulate_matches_host(tmp_path, rng):
    reads = [random_dna(rng, int(rng.integers(25, 50))) for _ in range(40)]
    path = str(tmp_path / "da.fastq.gz")
    fastq.write_fastq(path, reads)
    cfg = Config(chunk_size_reads=13, read_pad=56)
    dev = KmerEngine(cfg, k=21, device_accumulate=True,
                     device_capacity=1 << 12).count_file(path)
    host = KmerEngine(cfg, k=21, device_accumulate=False).count_file(path)
    assert dev.total_kmers == host.total_kmers
    assert dev.distinct_kmers == host.distinct_kmers
    assert dev.counts == host.counts


def test_kmer_engine_device_accumulate_spill_matches(tmp_path, rng):
    """Capacity far below the distinct count: spill path stays exact."""
    reads = [random_dna(rng, 40) for _ in range(30)]
    path = str(tmp_path / "sp.fastq.gz")
    fastq.write_fastq(path, reads)
    cfg = Config(chunk_size_reads=10, read_pad=48)
    dev = KmerEngine(cfg, k=21, device_capacity=64).count_file(path)
    host = KmerEngine(cfg, k=21, device_accumulate=False).count_file(path)
    assert dev.counts == host.counts
    assert dev.total_kmers == host.total_kmers


# ---------------------------------------------------------------------------
# checkpoint / resume (crash-resumable counting)
# ---------------------------------------------------------------------------

def test_merge_sorted_arrays_matches_counter(rng):
    from collections import Counter

    from mini_parallel.models.kmer_model import merge_sorted_arrays

    def rand_triple(n):
        hi = rng.integers(0, 50, n).astype(np.int32)
        lo = rng.integers(0, 50, n).astype(np.int32)
        ct = rng.integers(1, 9, n).astype(np.int64)
        return hi, lo, ct

    a, b = rand_triple(40), rand_triple(25)
    hi, lo, ct = merge_sorted_arrays(a, b)
    want = Counter()
    for t in (a, b):
        for h, l, c in zip(*t):
            want[(int(h), int(l))] += int(c)
    got = {(int(hi[i]), int(lo[i])): int(ct[i]) for i in range(hi.size)}
    assert got == dict(want)
    # sorted + deduplicated
    keys = list(zip(hi.tolist(), lo.tolist()))
    assert keys == sorted(set(keys))


def test_merge_sorted_arrays_rank_merge_and_fast_paths(rng):
    """Sorted-unique inputs take the searchsorted rank merge / empty-side
    fast path; both must equal the lexsort fold. Includes k=31-style hi
    limbs with the int32 sign bit set (device order is SIGNED)."""
    from collections import Counter

    from mini_parallel.models.kmer_model import merge_sorted_arrays

    def sorted_triple(n):
        # signed int32 hi limbs spanning negative (k=31) and positive
        hi = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int64)
        lo = rng.integers(0, 1 << 30, n).astype(np.int64)
        k = np.unique(hi * (1 << 30) + lo)
        hi = (k >> 30).astype(np.int32)
        lo = (k & ((1 << 30) - 1)).astype(np.int32)
        ct = rng.integers(1, 9, k.size).astype(np.int64)
        return hi, lo, ct

    a, b = sorted_triple(300), sorted_triple(200)
    empty = (np.empty(0, np.int32), np.empty(0, np.int32),
             np.empty(0, np.int64))
    want = Counter()
    for t in (a, b):
        for h, l, c in zip(*t):
            want[(int(h), int(l))] += int(c)
    hi, lo, ct = merge_sorted_arrays(a, b)
    got = {(int(hi[i]), int(lo[i])): int(ct[i]) for i in range(hi.size)}
    assert got == dict(want)
    # signed lex order (device store order)
    keys = list(zip(hi.tolist(), lo.tolist()))
    assert keys == sorted(set(keys))
    # empty-side fast paths return the other side verbatim
    for x, y in ((a, empty), (empty, a)):
        hi, lo, ct = merge_sorted_arrays(x, y)
        assert (hi == a[0]).all() and (lo == a[1]).all() and (ct == a[2]).all()

    # cross-side DUPLICATE keys on the sorted-unique path: random 2^61-key
    # triples never collide, so force overlap — half of b's keys are a's
    # (the duplicate-fold branch adds a-counts into b slots directly)
    o = np.arange(0, a[0].size, 2)
    b_hi = np.concatenate([a[0][o], b[0]])
    b_lo = np.concatenate([a[1][o], b[1]])
    b_ct = np.concatenate([a[2][o] * 10, b[2]])
    from mini_parallel.models.kmer_model import _combined_keys

    srt = np.argsort(_combined_keys(b_hi.astype(np.int32),
                                    b_lo.astype(np.int32)))
    bo = (b_hi[srt].astype(np.int32), b_lo[srt].astype(np.int32),
          b_ct[srt].astype(np.int64))
    want = Counter()
    for t in (a, bo):
        for h, l, c in zip(*t):
            want[(int(h), int(l))] += int(c)
    hi, lo, ct = merge_sorted_arrays(a, bo)
    got = {(int(hi[i]), int(lo[i])): int(ct[i]) for i in range(hi.size)}
    assert got == dict(want)
    keys = list(zip(hi.tolist(), lo.tolist()))
    assert keys == sorted(set(keys))


@pytest.mark.parametrize("device_acc", [True, False])
def test_kmer_checkpoint_resume_exact(tmp_path, rng, device_acc):
    reads = [random_dna(rng, 50) for _ in range(40)]  # 8 chunks of 5
    path = str(tmp_path / "lane.fastq.gz")
    fastq.write_fastq(path, reads)
    cfg = Config(chunk_size_reads=5, read_pad=64)

    clean = KmerEngine(cfg, k=21, device_accumulate=device_acc).count_file(path)

    # first run dies after 5 chunks; snapshots every 2 chunks
    ckpt = str(tmp_path / "kmer_ckpt.npz")
    real_iter = fastq.iter_read_chunks
    real_flat = fastq.iter_flat_chunks

    def dying_iter(p, n, progress=None):
        for i, c in enumerate(real_iter(p, n, progress=progress)):
            if i == 5:
                raise RuntimeError("injected crash")
            yield c

    def dying_flat(p, n, **kw):
        for i, c in enumerate(real_flat(p, n, **kw)):
            if i == 5:
                raise RuntimeError("injected crash")
            yield c

    fastq.iter_read_chunks = dying_iter
    fastq.iter_flat_chunks = dying_flat
    try:
        with pytest.raises(RuntimeError, match="injected crash"):
            KmerEngine(cfg, k=21, device_accumulate=device_acc).count_file(
                path, checkpoint_path=ckpt, checkpoint_every=2)
    finally:
        fastq.iter_read_chunks = real_iter
        fastq.iter_flat_chunks = real_flat

    from mini_parallel.models.kmer_model import load_kmer_checkpoint

    arrays, meta = load_kmer_checkpoint(ckpt)
    assert meta["chunks_done"] == 4 and meta["total_reads"] == 20

    res = KmerEngine(cfg, k=21, device_accumulate=device_acc).count_file(
        path, checkpoint_path=ckpt, checkpoint_every=2)
    assert res.total_kmers == clean.total_kmers
    assert res.total_reads == clean.total_reads == 40
    assert res.distinct_kmers == clean.distinct_kmers
    assert res.counts == clean.counts


def test_kmer_checkpoint_param_mismatch_refuses(tmp_path, rng):
    reads = [random_dna(rng, 40) for _ in range(10)]
    path = str(tmp_path / "lane.fastq.gz")
    fastq.write_fastq(path, reads)
    ckpt = str(tmp_path / "c.npz")
    cfg = Config(chunk_size_reads=5, read_pad=64)
    KmerEngine(cfg, k=21).count_file(path, checkpoint_path=ckpt,
                                     checkpoint_every=1)
    with pytest.raises(ValueError, match="k=21"):
        KmerEngine(cfg, k=15).count_file(path, checkpoint_path=ckpt,
                                         checkpoint_every=1)
    import dataclasses

    cfg2 = dataclasses.replace(cfg, chunk_size_reads=7)
    with pytest.raises(ValueError, match="chunk_size_reads"):
        KmerEngine(cfg2, k=21).count_file(path, checkpoint_path=ckpt,
                                          checkpoint_every=1)


def test_kmer_checkpoint_file_mismatch_refuses(tmp_path, rng):
    lane1 = str(tmp_path / "l1.fastq.gz")
    lane2 = str(tmp_path / "l2.fastq.gz")
    fastq.write_fastq(lane1, [random_dna(rng, 40) for _ in range(10)])
    fastq.write_fastq(lane2, [random_dna(rng, 40) for _ in range(10)])
    cfg = Config(chunk_size_reads=5, read_pad=64)
    ckpt = str(tmp_path / "c.npz")
    KmerEngine(cfg, k=21).count_file(lane1, checkpoint_path=ckpt,
                                     checkpoint_every=1)
    with pytest.raises(ValueError, match="file_path"):
        KmerEngine(cfg, k=21).count_file(lane2, checkpoint_path=ckpt,
                                         checkpoint_every=1)


def test_kmer_write_counts_dump(tmp_path, rng):
    reads = [random_dna(rng, 40) for _ in range(12)]
    path = str(tmp_path / "lane.fastq.gz")
    fastq.write_fastq(path, reads)
    res = KmerEngine(Config(chunk_size_reads=5, read_pad=64), k=21).count_file(path)
    out = str(tmp_path / "counts.tsv.gz")
    n = res.write_counts(out)
    assert n == res.distinct_kmers
    import gzip

    lines = gzip.open(out, "rt").read().splitlines()
    golden = kmer.count_kmers_python(reads, k=21)
    got = {l.split("\t")[0]: int(l.split("\t")[1]) for l in lines}
    assert got == dict(golden)
    assert lines == sorted(lines)  # key-sorted dump


def test_kmer_multi_file_sample(tmp_path, rng):
    r1 = [random_dna(rng, 40) for _ in range(12)]
    r2 = [random_dna(rng, 40) for _ in range(9)]
    p1, p2 = str(tmp_path / "l1.fastq.gz"), str(tmp_path / "l2.fastq.gz")
    fastq.write_fastq(p1, r1)
    fastq.write_fastq(p2, r2)
    cfg = Config(chunk_size_reads=5, read_pad=64)
    res = KmerEngine(cfg, k=21).count_file([p1, p2])
    golden = kmer.count_kmers_python(r1 + r2, k=21)
    assert res.total_reads == 21
    assert res.total_kmers == sum(golden.values())
    as_str = {kmer.key_to_string(h, l, 21): c
              for (h, l), c in res.counts.items()}
    assert as_str == dict(golden)

    # crash-resume across the file boundary is exact
    ckpt = str(tmp_path / "mc.npz")
    real_iter = fastq.iter_read_chunks
    real_flat = fastq.iter_flat_chunks
    fails = {"left": 1}

    def dying(p, n, progress=None):
        for i, c in enumerate(real_iter(p, n, progress=progress)):
            if p == p2 and i == 0 and fails["left"]:
                fails["left"] -= 1
                raise RuntimeError("boom")
            yield c

    def dying_flat(p, n, **kw):
        for i, c in enumerate(real_flat(p, n, **kw)):
            if p == p2 and i == 0 and fails["left"]:
                fails["left"] -= 1
                raise RuntimeError("boom")
            yield c

    fastq.iter_read_chunks = dying
    fastq.iter_flat_chunks = dying_flat
    try:
        with pytest.raises(RuntimeError):
            KmerEngine(cfg, k=21).count_file([p1, p2], checkpoint_path=ckpt,
                                             checkpoint_every=1)
    finally:
        fastq.iter_read_chunks = real_iter
        fastq.iter_flat_chunks = real_flat
    res2 = KmerEngine(cfg, k=21).count_file([p1, p2], checkpoint_path=ckpt,
                                            checkpoint_every=1)
    assert res2.counts == res.counts and res2.total_reads == 21


def test_compressed_drain_exact(rng, monkeypatch):
    """DeviceKmerAccumulator.drain with byte-plane compression is exact vs
    the raw fetch and the Python Counter golden."""
    monkeypatch.setattr(kmer, "COMPRESS_MIN_KEYS", 0)
    reads = [random_dna(rng, 60) for _ in range(300)]
    acc = kmer.DeviceKmerAccumulator(capacity=1 << 16, staging_batches=2)
    for i in range(0, len(reads), 100):
        batch = reads[i : i + 100]
        arr, lens = encode.pad_batch(batch, pad_to=64,
                                     pad_value=int(encode.PAD_A))
        codes = encode.ascii_to_code(jnp.asarray(arr))
        hi, lo, ct, _ = kmer.unique_counts_batch(codes, jnp.asarray(lens),
                                                 k=21)
        acc.add(hi, lo, ct)
    hi, lo, ct = acc.drain()
    got = {}
    kmer.merge_device_counts(got, hi, lo, ct)
    got = {kmer.key_to_string(h, l, 21): c for (h, l), c in got.items()}
    assert got == kmer.count_kmers_python(reads, k=21)


@pytest.mark.parametrize("k,s", [(21, 20), (13, 12), (31, 30), (8, 8)])
def test_compressed_drain_tight_embedding(rng, monkeypatch, k, s):
    """drain() with lo_bits = 2*(k//2) (the tight key embedding the engine
    passes) is exact, and for sorted stores the tight deltas need no
    high-limb plane (kp <= 4)."""
    monkeypatch.setattr(kmer, "COMPRESS_MIN_KEYS", 0)
    reads = [random_dna(rng, 60) for _ in range(200)]
    acc = kmer.DeviceKmerAccumulator(capacity=1 << 16, staging_batches=2,
                                     lo_bits=s)
    for i in range(0, len(reads), 100):
        arr, lens = encode.pad_batch(reads[i : i + 100], pad_to=64,
                                     pad_value=int(encode.PAD_A))
        codes = encode.ascii_to_code(jnp.asarray(arr))
        hi, lo, ct, _ = kmer.unique_counts_batch(codes, jnp.asarray(lens),
                                                 k=k)
        acc.add(hi, lo, ct)
    hi, lo, ct = acc.drain()
    got = {}
    kmer.merge_device_counts(got, hi, lo, ct)
    got = {kmer.key_to_string(h, l, k): c for (h, l), c in got.items()}
    assert got == kmer.count_kmers_python(reads, k=k)


def test_plane_codec_roundtrip_any_order(rng):
    """The delta codec is exact for UNSORTED stores too (mod-2^64 wrap
    contract), at tight and limb embeddings."""
    for s in (20, 30, 32):
        n = 500
        max_lo = (1 << min(s, 31)) - 1
        hi = rng.integers(-(1 << 31), 1 << 31, size=n).astype(np.int32)
        lo = rng.integers(0, max_lo, size=n, endpoint=True).astype(np.int32)
        ct = rng.integers(1, 1000, size=n).astype(np.int32)
        import jax.numpy as jnp_
        mx = np.asarray(kmer._plane_maxima(
            jnp_.asarray(hi), jnp_.asarray(lo), jnp_.asarray(ct), s=s))
        # force full planes: unsorted deltas can need anything up to 8
        kp, cp = 8, 4
        planes = np.asarray(kmer._plane_pack(
            jnp_.asarray(hi), jnp_.asarray(lo), jnp_.asarray(ct), kp, cp,
            s=s))
        key0 = (int(mx[3]) << 32) | int(mx[4])
        dh, dl, dc = kmer._decode_planes(planes, n, kp, cp, key0, s=s)
        assert (dh == hi).all() and (dl == lo).all() and (dc == ct).all()


def test_rank_merge_fold_matches_sort_fold(rng, monkeypatch):
    """The lax.sort fold (default) and the rank-merge fold
    (MPT_KMER_RANK_FOLD, kept as a measured negative result) must produce
    identical drains."""
    import jax.numpy as jnp

    reads = [random_dna(rng, 40) for _ in range(64)]
    reads[10] = reads[0]  # cross-batch duplicates

    def run():
        acc = kmer.DeviceKmerAccumulator(capacity=1 << 14, staging_batches=3)
        for i in range(0, len(reads), 16):
            arr, lens = encode.pad_batch(reads[i : i + 16], pad_to=40,
                                         pad_value=int(encode.PAD_A))
            codes = encode.ascii_to_code(jnp.asarray(arr))
            hi, lo, ct, _ = kmer.unique_counts_batch(
                codes, jnp.asarray(lens), k=13)
            acc.add(hi, lo, ct)
        return acc.drain()

    monkeypatch.delenv("MPT_KMER_RANK_FOLD", raising=False)
    sort = run()
    monkeypatch.setenv("MPT_KMER_RANK_FOLD", "1")
    rank = run()
    for a, b in zip(rank, sort):
        assert (a == b).all()


def test_rank_merge_runs_exact(rng):
    """Tree rank-merge of R sorted runs == a full sort (duplicates kept)."""
    import jax.numpy as jnp

    from mini_parallel.ops.kmer import _rank_merge_runs

    R, L = 8, 64
    hi = rng.integers(0, 5, (R, L)).astype(np.int32)
    lo = rng.integers(0, 4, (R, L)).astype(np.int32)
    key = hi.astype(np.int64) * 4 + lo
    key.sort(axis=1)
    hi, lo = (key // 4).astype(np.int32), (key % 4).astype(np.int32)
    ct = rng.integers(1, 9, (R, L)).astype(np.int32)
    oh, ol, oc = (np.asarray(x) for x in _rank_merge_runs(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(ct)))
    got = oh.astype(np.int64) * 4 + ol
    assert (got == np.sort(key.reshape(-1))).all()
    # counts are a permutation grouped with their keys
    import collections
    want = collections.Counter()
    for k_, c_ in zip(key.reshape(-1), ct.reshape(-1)):
        want[int(k_)] += int(c_)
    got_sum = collections.Counter()
    for k_, c_ in zip(got, oc):
        got_sum[int(k_)] += int(c_)
    assert got_sum == want


def test_summary_mode_matches_python_oracle(tmp_path):
    from mini_parallel.io import fastq as fq
    from mini_parallel.models.kmer_model import KmerEngine
    from mini_parallel.utils.config import Config

    rng = np.random.default_rng(17)
    reads = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(300)]
    reads += reads[:40]  # repeats: multi-count histogram bins
    path = str(tmp_path / "s.fastq.gz")
    fq.write_fastq(path, reads)
    cfg = Config(chunk_size_reads=128)
    eng = KmerEngine(cfg, k=11)
    res = eng.count_file(path, result_mode="summary")
    oracle = kmer.count_kmers_python([r.encode() for r in reads], k=11)
    assert res.arrays == ()  # nothing drained
    assert res.distinct_kmers == len(oracle)
    assert res.total_kmers == sum(oracle.values())
    # histogram parity
    import collections
    mult = collections.Counter(oracle.values())
    hist = res.histogram(64)
    for c in range(1, 64):
        assert hist[c - 1] == mult.get(c, 0)
    # top-N parity incl. deterministic tie-break (count desc, key asc)
    full = eng.count_file(path)  # full drain on a fresh engine pass
    assert res.top(10) == full.top(10)
    assert {s: c for s, c in res.top(10)}.items() <= dict(
        (k_, v) for k_, v in oracle.items()).items()


def test_summary_mode_spill_falls_back_to_exact_drain(tmp_path):
    from mini_parallel.io import fastq as fq
    from mini_parallel.models.kmer_model import KmerEngine
    from mini_parallel.utils.config import Config

    rng = np.random.default_rng(19)
    reads = ["".join(rng.choice(list("ACGT"), size=40)) for _ in range(200)]
    path = str(tmp_path / "sp.fastq.gz")
    fq.write_fastq(path, reads)
    cfg = Config(chunk_size_reads=64)
    eng = KmerEngine(cfg, k=9, device_capacity=256)  # forces spill
    res = eng.count_file(path, result_mode="summary")
    oracle = kmer.count_kmers_python([r.encode() for r in reads], k=9)
    assert len(res.arrays) == 3  # fell back to the full exact drain
    assert res.distinct_kmers == len(oracle)


def test_spill_fold_failure_poisons_accumulator(rng, monkeypatch):
    """A failed background spill fold must make EVERY drain raise — a
    retry returning partial counts would be a silent undercount."""
    acc = kmer.DeviceKmerAccumulator(capacity=64, staging_batches=2)
    monkeypatch.setattr(
        kmer.DeviceKmerAccumulator, "_fetch_triple",
        lambda self, *a: (_ for _ in ()).throw(RuntimeError("wire died")))
    reads = [random_dna(rng, 40) for _ in range(50)]
    arr, lens = encode.pad_batch(reads, pad_to=48,
                                 pad_value=int(encode.PAD_A))
    codes = encode.ascii_to_code(jnp.asarray(arr))
    hi, lo, ct, _ = kmer.unique_counts_batch(codes, jnp.asarray(lens), k=9)
    acc.add(hi, lo, ct)
    acc.flush()  # overflows capacity 64 -> spill on the worker thread
    assert acc.spilled
    with pytest.raises(RuntimeError, match="incomplete"):
        acc.drain()
    with pytest.raises(RuntimeError, match="incomplete"):  # still poisoned
        acc.drain()


def test_summary_mode_counts_and_dump_raise(tmp_path):
    from mini_parallel.io import fastq as fq
    from mini_parallel.models.kmer_model import KmerEngine
    from mini_parallel.utils.config import Config

    reads = ["ACGTACGTACGTACGT"] * 30
    path = str(tmp_path / "c.fastq.gz")
    fq.write_fastq(path, reads)
    res = KmerEngine(Config(chunk_size_reads=16), k=11).count_file(
        path, result_mode="summary")
    assert res.distinct_kmers > 0 and res.arrays == ()
    with pytest.raises(ValueError, match="summary-mode"):
        res.counts
    with pytest.raises(ValueError, match="summary-mode"):
        res.write_counts(str(tmp_path / "dump.tsv"))
    assert res.top(5)  # summary accessors still work
    assert int(res.histogram(64).sum()) == res.distinct_kmers


@pytest.mark.parametrize("bytes_limit,want", [
    (None, 1 << 20),               # runtime reports no limit
    (1 << 28, 1 << 20),            # small device: the floor
    (16 * (1 << 30), 1 << 25),     # 16 GiB
    (60_000_000_000, 1 << 26),     # an 80 GB card at 3/4 reserved
])
def test_capacity_from_bytes_limit(bytes_limit, want):
    from mini_parallel.models.kmer_model import capacity_for

    assert capacity_for(bytes_limit) == want
