"""Native C++ data plane: parity with the Python FASTQ reader + kmer dict."""

import numpy as np
import pytest

from mini_parallel.io import fastq
from tests.conftest import random_dna

native = pytest.importorskip("mini_parallel.native")
if not native.available():
    pytest.skip("native toolchain unavailable", allow_module_level=True)

from mini_parallel.native import fastq_native, kmer_store  # noqa: E402


@pytest.fixture
def fqgz(tmp_path, rng):
    reads = [random_dna(rng, int(rng.integers(10, 200))) for _ in range(123)]
    path = str(tmp_path / "native.fastq.gz")
    fastq.write_fastq(path, reads)
    return path, reads


def test_native_chunks_match_python(fqgz):
    path, reads = fqgz
    py = [r for c in fastq.iter_read_chunks(path, 17) for r in c]
    nat = [r for c in fastq_native.iter_reads_native(path, 17) for r in c]
    assert nat == py == reads


def test_native_chunk_sizes(fqgz):
    path, reads = fqgz
    sizes = [len(c) for c in fastq_native.iter_reads_native(path, 50)]
    assert sizes == [50, 50, 23]


def test_native_flat_offsets(fqgz):
    path, reads = fqgz
    seen = []
    for flat, offs in fastq_native.iter_read_chunks_native(path, 40):
        data = flat.tobytes()
        assert offs[0] == 0 and offs[-1] == len(data)
        seen += [data[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
    assert seen == reads


def test_native_plain_fastq(tmp_path, rng):
    reads = [random_dna(rng, 30) for _ in range(5)]
    path = str(tmp_path / "plain.fastq")
    fastq.write_fastq(path, reads)  # zlib gzopen reads plain files too
    nat = [r for c in fastq_native.iter_reads_native(path, 2) for r in c]
    assert nat == reads


def test_native_count_lines(fqgz):
    path, reads = fqgz
    assert fastq_native.count_lines_native(path) == 4 * len(reads)


def test_native_missing_file():
    with pytest.raises(IOError):
        list(fastq_native.iter_reads_native("/nonexistent.fastq.gz", 10))


def test_native_buffer_growth(tmp_path, rng):
    # force the -2 grow-and-retry path with a tiny hint
    reads = [random_dna(rng, 5000) for _ in range(10)]
    path = str(tmp_path / "big.fastq.gz")
    fastq.write_fastq(path, reads)
    got = [
        r
        for c in fastq_native.iter_read_chunks_native(path, 4, avg_read_len_hint=8)
        for r in [c[0].tobytes()[c[1][i]:c[1][i + 1]] for i in range(len(c[1]) - 1)]
    ]
    assert got == reads


def test_kmer_store_merge_and_dump(rng):
    ks = kmer_store.KmerStore(16)
    hi = np.array([1, 2, 1, 3], np.int32)
    lo = np.array([10, 20, 10, 30], np.int32)
    ct = np.array([2, 5, 3, 0], np.int32)  # count 0 = padding, skipped
    ks.merge(hi, lo, ct)
    assert len(ks) == 2
    assert ks.get(1, 10) == 5 and ks.get(2, 20) == 5 and ks.get(3, 30) == 0
    assert ks.total() == 10
    assert ks.items() == {(1, 10): 5, (2, 20): 5}


def test_kmer_store_growth(rng):
    ks = kmer_store.KmerStore(16)
    n = 10_000
    hi = rng.integers(0, 2**20, n).astype(np.int32)
    lo = rng.integers(0, 2**20, n).astype(np.int32)
    ct = np.ones(n, np.int32)
    ks.merge(hi, lo, ct)
    import collections

    golden = collections.Counter(zip(hi.tolist(), lo.tolist()))
    assert len(ks) == len(golden)
    assert ks.total() == n
    items = ks.items()
    assert items == dict(golden)


def test_native_quals_matches_python(tmp_path, rng):
    import gzip

    from mini_parallel.io import fastq
    from mini_parallel.native import available, fastq_native

    if not available():
        import pytest

        pytest.skip("native plane not built")
    # varied read lengths + varied quals
    path = str(tmp_path / "q.fastq.gz")
    with gzip.open(path, "wt") as f:
        for i in range(23):
            n = 20 + (i * 7) % 50
            seq = "".join("ACGT"[(i + j) % 4] for j in range(n))
            qual = "".join(chr(33 + (i + j) % 40) for j in range(n))
            f.write(f"@r{i}\n{seq}\n+\n{qual}\n")
    native = list(fastq_native.iter_reads_with_quals_native(path, 5))
    python = []
    seqs, quals = [], []
    for s, q in fastq.iter_read_chunks_with_quals(path, 5, engine="python"):
        python.append((s, q))
    assert len(native) == len(python)
    for (ns, nq), (ps, pq) in zip(native, python):
        assert ns == ps and nq == pq
    # the public iterator prefers the native path and matches too
    pub = list(fastq.iter_read_chunks_with_quals(path, 5))
    assert pub == python


def test_native_quals_truncated_final_record(tmp_path):
    import gzip

    from mini_parallel.io import fastq
    from mini_parallel.native import available

    if not available():
        import pytest

        pytest.skip("native plane not built")
    path = str(tmp_path / "trunc.fastq.gz")
    with gzip.open(path, "wt") as f:
        f.write("@a\nACGTACGT\n+\nIIIIIIII\n@b\nTTTTGGGG\n")  # no qual for b
    chunks = list(fastq.iter_read_chunks_with_quals(path, 10))
    (seqs, quals), = chunks
    assert seqs == [b"ACGTACGT", b"TTTTGGGG"]
    assert quals == [b"IIIIIIII", b""]  # padded empty -> downstream passes


def test_quals_iter_falls_back_when_native_unavailable(tmp_path, monkeypatch):
    # a LOADER failure (NativeUnavailable) must fall through to the Python
    # decoder; only real file-I/O errors abort
    from mini_parallel.io import fastq
    from mini_parallel.native import fastq_native

    path = str(tmp_path / "x.fastq.gz")
    fastq.write_fastq(path, [b"ACGTACGT", b"TTTTCCCC"])

    def boom(*a, **k):
        raise fastq_native.NativeUnavailable("stale .so")

    monkeypatch.setattr(fastq_native, "iter_reads_with_quals_native", boom)
    chunks = list(fastq.iter_read_chunks_with_quals(path, 10))
    assert chunks[0][0] == [b"ACGTACGT", b"TTTTCCCC"]


def _open_handle(path, chunk):
    """Low-level handle for counter assertions (the iterators hide it)."""
    import ctypes

    lib = fastq_native._load()
    h = lib.fq_open(str(path).encode(), chunk)
    assert h
    return lib, h


def test_native_skips_malformed_lines(tmp_path):
    """<=10 non-UTF-8 lines are skipped without advancing the line counter
    (aligner.rs:155-163 parity: the Err arm does not bump line_count, so
    framing shifts by exactly the skipped lines)."""
    reads = [b"ACGTACGT", b"GGGGCCCC", b"TTTTAAAA"]
    path = tmp_path / "bad.fastq"
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            if i == 1:
                f.write(b"\xff\xfe garbage \x80\n")  # invalid UTF-8: skipped
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)))
    got = [r for c in fastq_native.iter_reads_native(str(path), 10)
           for r in c]
    assert got == reads

    lib, h = _open_handle(path, 10)
    try:
        # drain
        import ctypes

        buf = np.empty(1 << 16, np.uint8)
        offs = np.empty(64, np.int64)
        nb, nr = ctypes.c_int64(), ctypes.c_int64()
        while lib.fq_next_chunk(
            h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), offs.size,
            ctypes.byref(nb), ctypes.byref(nr),
        ) > 0:
            pass
        if getattr(lib, "fq_error_count", None) is not None:
            assert lib.fq_error_count(h) == 1
        assert lib.fq_line_count(h) == 12  # 3 records; bad line not counted
    finally:
        lib.fq_close(h)


def test_native_aborts_after_ten_errors(tmp_path):
    """>10 malformed lines abort the file with an error (aligner.rs:161)."""
    path = tmp_path / "verybad.fastq"
    with open(path, "wb") as f:
        f.write(b"@r0\nACGT\n+\nIIII\n")
        for _ in range(11):
            f.write(b"\xffjunk\n")
        f.write(b"@r1\nGGGG\n+\nIIII\n")
    with pytest.raises(IOError, match="Too many read errors"):
        list(fastq_native.iter_reads_native(str(path), 10))


def test_native_corrupt_gzip_aborts(tmp_path):
    """A corrupted gzip STREAM is not a per-line error: zlib cannot resync,
    so the read aborts (stricter than the reference, whose zcat child dying
    silently truncates the stream)."""
    import gzip

    path = tmp_path / "trunc.fastq.gz"
    payload = b"".join(
        b"@r%d\n%s\n+\n%s\n" % (i, b"ACGT" * 30, b"I" * 120)
        for i in range(200)
    )
    blob = gzip.compress(payload)
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])  # truncate mid-stream
    with pytest.raises(IOError):
        list(fastq_native.iter_reads_native(str(path), 10))


def test_decode_planes_native_matches_numpy(rng):
    """ks_decode_planes == the NumPy reference decoder on sorted stores
    (tight + limb embeddings, with and without count planes)."""
    import jax.numpy as jnp
    import numpy as np

    from mini_parallel.ops import kmer

    for s, allones in [(20, True), (20, False), (32, False)]:
        n = 4096
        hi = np.sort(rng.integers(0, 1 << 10, size=n).astype(np.int32))
        lo = rng.integers(0, (1 << min(s, 31)) - 1, size=n).astype(np.int32)
        order = np.lexsort((lo, hi))
        hi, lo = hi[order], lo[order]
        ct = (np.ones(n, np.int32) if allones
              else rng.integers(1, 300, size=n).astype(np.int32))
        mx = np.asarray(kmer._plane_maxima(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(ct), s=s))
        kp = ((4 + kmer._planes_needed(int(mx[1]))) if int(mx[1])
              else kmer._planes_needed(int(mx[0])))
        cp = 0 if int(mx[2]) == 1 else kmer._planes_needed(int(mx[2]))
        planes = np.asarray(kmer._plane_pack(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(ct), kp, cp, s=s))
        key0 = (int(mx[3]) << 32) | int(mx[4])
        try:
            from mini_parallel.native.kmer_store import (
                decode_planes_native)
            nat = decode_planes_native(planes, n, kp, cp,
                                       kmer._biased_key0(key0, s), s)
        except Exception:
            continue  # no toolchain: dispatcher falls back anyway
        ref = kmer._decode_planes_np(planes, n, kp, cp, key0, s=s)
        for a, b in zip(nat, ref):
            assert (a == b).all()
