import gzip
import io

import pytest

from mini_parallel.io import fastq


@pytest.fixture
def fq(tmp_path):
    reads = [b"ACGT" * 10, b"TTTT" * 5, b"ACGTACG", b"GGGCCC"]
    path = str(tmp_path / "sample.fastq")
    fastq.write_fastq(path, reads)
    return path, reads


@pytest.fixture
def fqgz(tmp_path):
    reads = [("ACGT" * (i + 1)).encode() for i in range(25)]
    path = str(tmp_path / "sample.fastq.gz")
    fastq.write_fastq(path, reads)
    return path, reads


def test_iter_chunks_plain(fq):
    path, reads = fq
    chunks = list(fastq.iter_read_chunks(path, chunk_size_reads=3))
    assert [len(c) for c in chunks] == [3, 1]  # final partial chunk kept
    assert [r for c in chunks for r in c] == reads


def test_iter_chunks_gz(fqgz):
    path, reads = fqgz
    got = [r for c in fastq.iter_read_chunks(path, 10) for r in c]
    assert got == reads


def test_zcat_engine_parity(fqgz):
    path, reads = fqgz
    via_zcat = [r for c in fastq.iter_read_chunks(path, 7, engine="zcat") for r in c]
    via_py = [r for c in fastq.iter_read_chunks(path, 7, engine="python") for r in c]
    assert via_zcat == via_py == reads


def test_count_bases_and_reads(fqgz):
    path, reads = fqgz
    assert fastq.count_bases(path, 8) == sum(len(r) for r in reads)
    assert fastq.count_reads(path, 8) == len(reads)


def test_count_lines(fq, fqgz):
    # 4 lines per record — linecount.rs parity
    assert fastq.count_lines(fq[0]) == 4 * len(fq[1])
    assert fastq.count_lines(fqgz[0]) == 4 * len(fqgz[1])


def test_count_lines_stdin():
    assert fastq.count_lines_stdin(io.BytesIO(b"a\nb\nc\n")) == 3


def test_sequence_line_selection(tmp_path):
    # Hand-built FASTQ: only line 2 of each record is a read, even when
    # header/quality lines look like DNA.
    path = str(tmp_path / "tricky.fastq")
    with open(path, "w") as f:
        f.write("@ACGT\nAAAA\n+\nACGT\n@r2\nCCCC\n+\nIIII\n")
    got = [r for c in fastq.iter_read_chunks(path, 10) for r in c]
    assert got == [b"AAAA", b"CCCC"]


def test_truncated_gz_raises(tmp_path):
    # Corrupt gzip: errors surface (after tolerance) rather than silently EOF.
    path = str(tmp_path / "bad.fastq.gz")
    blob = gzip.compress(b"@r\nACGT\n+\nIIII\n" * 100)
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises((IOError, EOFError)):
        list(fastq.iter_read_chunks(path, 10))


def test_zcat_engine_missing_file_raises(tmp_path):
    import pytest

    with pytest.raises(IOError, match="zcat exited"):
        list(fastq.open_lines(str(tmp_path / "nope.fastq.gz"), engine="zcat"))


def test_zcat_engine_corrupt_gz_raises(tmp_path):
    import pytest

    bad = tmp_path / "bad.fastq.gz"
    bad.write_bytes(b"this is not gzip data")
    with pytest.raises(IOError, match="zcat exited"):
        list(fastq.open_lines(str(bad), engine="zcat"))


def test_iter_flat_chunks_matches_list_path(tmp_path):
    import numpy as np

    path = str(tmp_path / "flat.fastq.gz")
    rng = np.random.default_rng(3)
    reads = ["".join(rng.choice(list("ACGT"), size=int(n)))
             for n in rng.integers(20, 180, size=257)]
    fastq.write_fastq(path, reads)
    lists = list(fastq.iter_read_chunks(path, 100))
    flats = list(fastq.iter_flat_chunks(path, 100))
    assert len(lists) == len(flats)
    for chunk, (flat, offs) in zip(lists, flats):
        assert offs[0] == 0 and offs[-1] == flat.size
        got = [flat[offs[i]:offs[i + 1]].tobytes()
               for i in range(len(offs) - 1)]
        assert got == chunk


def test_iter_flat_chunks_python_fallback(tmp_path):
    import numpy as np

    path = str(tmp_path / "flat2.fastq")
    with open(path, "w") as f:
        f.write("@a\nACGT\n+\nIIII\n@b\nTTGCA\n+\nIIIII\n")
    (flat, offs), = list(fastq.iter_flat_chunks(path, 10, engine="python"))
    assert flat.tobytes() == b"ACGTTTGCA"
    assert list(offs) == [0, 4, 9]
    assert flat.dtype == np.uint8


def test_prefetch_preserves_order_and_exceptions():
    import pytest

    assert list(fastq.prefetch(iter(range(100)), depth=3)) == list(range(100))

    def boom():
        yield 1
        raise ValueError("producer died")

    it = fastq.prefetch(boom())
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer died"):
        next(it)


def test_prefetch_abandoned_consumer_stops_producer():
    import threading
    import time as _time

    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = fastq.prefetch(gen(), depth=2)
    next(it)
    it.close()  # abandon: producer must stop, not block forever
    deadline = _time.time() + 5.0
    while _time.time() < deadline:
        n_threads = sum(1 for t in threading.enumerate()
                        if t.name == "mpt-prefetch" and t.is_alive())
        if n_threads == 0:
            break
        _time.sleep(0.05)
    assert len(produced) < 10_000


def test_iter_flat_chunks_with_quals_matches_list_path(tmp_path):
    import gzip as _gz

    import numpy as np

    path = str(tmp_path / "fq.fastq.gz")
    rng = np.random.default_rng(7)
    with _gz.open(path, "wt") as f:
        for i in range(137):
            n = int(rng.integers(10, 90))
            seq = "".join(rng.choice(list("ACGT"), size=n))
            qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 42, n))
            f.write(f"@r{i}\n{seq}\n+\n{qual}\n")
    lists = list(fastq.iter_read_chunks_with_quals(path, 50))
    flats = list(fastq.iter_flat_chunks_with_quals(path, 50))
    assert len(lists) == len(flats)
    for (seqs, quals), (flat, offs, qflat, qoffs) in zip(lists, flats):
        got_s = [flat[offs[i]:offs[i + 1]].tobytes()
                 for i in range(len(offs) - 1)]
        got_q = [qflat[qoffs[i]:qoffs[i + 1]].tobytes()
                 for i in range(len(qoffs) - 1)]
        assert got_s == seqs and got_q == quals
    # python fallback parity
    pflats = list(fastq.iter_flat_chunks_with_quals(path, 50,
                                                    engine="python"))
    for (f1, o1, q1, qo1), (f2, o2, q2, qo2) in zip(flats, pflats):
        import numpy as np
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_array_equal(q1, q2)
        np.testing.assert_array_equal(qo1, qo2)
