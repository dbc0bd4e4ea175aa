"""2-bit packed transfer (ops/packed.py): exact round-trip + score parity."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest

from mini_parallel.ops import encode, kadane, packed, sw
from mini_parallel.models.alignment import AlignmentEngine
from mini_parallel.utils.config import Config


def _random_batch(rng, B, L, pad_value, n_frac=0.05, lower_frac=0.02):
    """Padded batch with Ns, lowercase, and varied lengths (worst cases)."""
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    lens[0] = 0  # empty row
    lens[1] = L  # full row
    arr = np.full((B, L), pad_value, np.uint8)
    for i in range(B):
        row = rng.choice(alphabet, size=lens[i])
        noise = rng.random(lens[i])
        row = np.where(noise < n_frac, ord("N"), row)
        row = np.where(noise > 1 - lower_frac, ord("a"), row)
        arr[i, : lens[i]] = row
    return arr, lens


def test_roundtrip_exact():
    rng = np.random.default_rng(0)
    arr, lens = _random_batch(rng, 33, 64, int(encode.PAD_A))
    pb = packed.pack_batch(arr, lens)
    out = np.asarray(
        packed.unpack_device(*packed.device_args(pb), int(encode.PAD_A))
    )
    np.testing.assert_array_equal(out, arr)


def test_wire_bytes_4x_on_realistic_reads():
    """150bp reads with rare Ns: wire bytes ~4x below raw uint8."""
    rng = np.random.default_rng(9)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    arr = rng.choice(alphabet, size=(1000, 152)).astype(np.uint8)
    arr[rng.random((1000, 152)) < 0.001] = ord("N")
    lens = np.full(1000, 150, np.int32)
    pb = packed.pack_batch(arr, lens)
    assert pb.packed.nbytes * 4 == arr.nbytes
    assert pb.wire_bytes() < arr.nbytes * 0.4


def test_roundtrip_no_exceptions():
    rng = np.random.default_rng(1)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    arr = rng.choice(alphabet, size=(8, 32)).astype(np.uint8)
    lens = np.full(8, 32, np.int32)
    pb = packed.pack_batch(arr, lens)
    assert (pb.exc_col == 32).all()
    out = np.asarray(
        packed.unpack_device(*packed.device_args(pb), int(encode.PAD_B))
    )
    np.testing.assert_array_equal(out, arr)


def test_pad_rows():
    rng = np.random.default_rng(2)
    arr, lens = _random_batch(rng, 5, 16, int(encode.PAD_A))
    pb = packed.pad_rows(packed.pack_batch(arr, lens), 8)
    assert pb.batch == 8
    out = np.asarray(
        packed.unpack_device(*packed.device_args(pb), int(encode.PAD_A))
    )
    np.testing.assert_array_equal(out[:5], arr)
    assert (out[5:] == encode.PAD_A).all()
    assert (pb.lengths[5:] == 0).all()


def test_width_not_multiple_of_4_rejected():
    with pytest.raises(ValueError):
        packed.pack_batch(np.zeros((2, 9), np.uint8), np.zeros(2, np.int32))


@pytest.mark.parametrize("mode", ["kadane", "sw", "sw-affine", "contiguous"])
def test_packed_scores_match_direct(mode):
    """Engine scores must be identical with packed_transfer on and off."""
    rng = np.random.default_rng(3)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for i in range(17):
        r = rng.choice(alphabet, size=int(rng.integers(20, 40))).tobytes()
        if i % 5 == 0:
            r = r[:3] + b"N" + r[4:]  # sprinkle exceptions
        reads.append(r)
    a = [bytes(r) for r in reads]
    b = [bytes(r[::-1]) for r in reads]

    on = AlignmentEngine(Config(chunk_size_reads=10, packed_transfer=True), mode=mode)
    off = AlignmentEngine(Config(chunk_size_reads=10, packed_transfer=False), mode=mode)
    np.testing.assert_array_equal(on.score_read_batch(a, b),
                                  off.score_read_batch(a, b))


def test_packed_self_align_file_matches(tmp_path):
    import gzip

    rng = np.random.default_rng(4)
    alphabet = "ACGT"
    path = tmp_path / "reads.fastq.gz"
    recs = []
    for i in range(100):
        seq = "".join(rng.choice(list(alphabet), size=30))
        if i % 7 == 0:
            seq = seq[:5] + "N" + seq[6:]
        recs.append(f"@r{i}\n{seq}\n+\n{'I'*len(seq)}\n")
    path.write_bytes(gzip.compress("".join(recs).encode()))

    for mode in ("kadane", "sw"):
        on = AlignmentEngine(Config(chunk_size_reads=16, packed_transfer=True), mode=mode)
        off = AlignmentEngine(Config(chunk_size_reads=16, packed_transfer=False), mode=mode)
        r_on = on.self_align_file(str(path))
        r_off = off.self_align_file(str(path))
        assert r_on.score == r_off.score
        assert r_on.total_bases == r_off.total_bases


def test_packed_sharded_matches(mesh8):
    rng = np.random.default_rng(5)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    reads = [rng.choice(alphabet, size=24).tobytes() for _ in range(32)]
    on = AlignmentEngine(
        Config(chunk_size_reads=8, packed_transfer=True), mode="sw", mesh=mesh8
    )
    arr, lens = encode.pad_batch(reads, pad_to=24, pad_value=int(encode.PAD_A))
    got = int(np.asarray(on._packed_self_sum("sw", arr, lens)))
    want = sum(2 * len(r) for r in reads)  # self-alignment: all-match
    assert got == want


def test_packed_wgs_step_matches_unpacked(mesh8):
    from mini_parallel.parallel import pipeline

    rng = np.random.default_rng(6)
    arr_a, len_a = _random_batch(rng, 16, 32, int(encode.PAD_A), n_frac=0.1)
    arr_b, len_b = _random_batch(rng, 16, 32, int(encode.PAD_B), n_frac=0.1)
    len_a = np.maximum(len_a, 1)  # make_wgs_step "pairs" counts minlen>0
    step = pipeline.make_wgs_step(mesh8)
    args = pipeline.shard_batch(
        mesh8,
        (jnp.asarray(arr_a), jnp.asarray(arr_b),
         jnp.asarray(len_a), jnp.asarray(len_b)),
    )
    want = {k: np.asarray(v) for k, v in step(*args).items()}

    pa = packed.pack_batch(arr_a, len_a)
    pb = packed.pack_batch(arr_b, len_b)
    pstep = pipeline.make_wgs_step_packed(mesh8)
    pargs = pipeline.shard_batch(
        mesh8, packed.device_args(pa) + packed.device_args(pb)
    )
    got = {k: np.asarray(v) for k, v in pstep(*pargs).items()}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_native_packer_matches_numpy():
    """libpack2bit.so output must be identical to the NumPy fallback."""
    from mini_parallel.ops import packed as pk

    lib = pk._native()
    if lib is None:
        pytest.skip("native packer not built")
    rng = np.random.default_rng(11)
    alphabet = np.frombuffer(b"ACGTNacgt@", np.uint8)
    arr = rng.choice(alphabet, size=(21, 48)).astype(np.uint8)
    lens = rng.integers(0, 49, size=21).astype(np.int32)
    nat = pk._pack_batch_native(arr, lens, lib)
    # force the NumPy path
    saved = pk._native_failed
    pk._native_failed, pk._native_lib = True, None
    try:
        ref = pk.pack_batch(arr, lens)
    finally:
        pk._native_failed, pk._native_lib = saved, lib
    np.testing.assert_array_equal(nat.packed, ref.packed)
    np.testing.assert_array_equal(nat.exc_col, ref.exc_col)
    np.testing.assert_array_equal(nat.exc_val, ref.exc_val)
    np.testing.assert_array_equal(nat.lengths, ref.lengths)


def test_pair_mode_grouped_matches_per_pair(tmp_path):
    """Grouped packed pair-mode kadane == the reference per-pair dispatch."""
    import gzip

    rng = np.random.default_rng(12)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    for name, n in (("p1", 23), ("p2", 17)):
        recs = []
        for i in range(n):
            seq = rng.choice(alphabet, size=80).tobytes().decode()
            recs.append(f"@r{i}\n{seq}\n+\n{'I'*80}\n")
        (tmp_path / f"{name}.fastq.gz").write_bytes(
            gzip.compress("".join(recs).encode())
        )
    f1, f2 = str(tmp_path / "p1.fastq.gz"), str(tmp_path / "p2.fastq.gz")
    for mode in ("kadane", "contiguous"):
        on = AlignmentEngine(Config(chunk_size_reads=5, packed_transfer=True), mode=mode)
        off = AlignmentEngine(Config(chunk_size_reads=5, packed_transfer=False), mode=mode)
        assert on.pair_align_files(f1, f2).score == off.pair_align_files(f1, f2).score
