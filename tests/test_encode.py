import numpy as np
import jax.numpy as jnp

from mini_parallel.ops import encode


def test_pad_batch_shapes_and_lengths():
    arr, lens = encode.pad_batch(["ACGT", "AC", "ACGTACGT"])
    assert arr.shape == (3, 8)
    assert lens.tolist() == [4, 2, 8]
    assert bytes(arr[0, :4]) == b"ACGT"
    assert (arr[1, 2:] == encode.PAD_A).all()


def test_pad_batch_bucket():
    arr, _ = encode.pad_batch(["ACG"], pad_to=16)
    assert arr.shape == (1, 16)


def test_ascii_to_code_roundtrip():
    arr, _ = encode.pad_batch(["ACGTNacgtn"])
    codes = np.asarray(encode.ascii_to_code(jnp.asarray(arr)))
    assert codes[0, :10].tolist() == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4]
    # pads map to distinct code pads
    a = np.full((1, 2), encode.PAD_A, np.uint8)
    b = np.full((1, 2), encode.PAD_B, np.uint8)
    assert (np.asarray(encode.ascii_to_code(jnp.asarray(a))) == encode.CODE_PAD_A).all()
    assert (np.asarray(encode.ascii_to_code(jnp.asarray(b))) == encode.CODE_PAD_B).all()


def test_complement_and_revcomp():
    arr, _ = encode.pad_batch(["ACGTN"])
    comp = np.asarray(encode.complement_ascii(jnp.asarray(arr)))
    assert bytes(comp[0, :5]) == b"TGCAN"
    rc = np.asarray(encode.reverse_complement_ascii(jnp.asarray(arr[:, :5])))
    assert bytes(rc[0]) == b"NACGT"


def test_complement_code_involution():
    codes = jnp.asarray(np.arange(7, dtype=np.uint8)[None])
    twice = np.asarray(encode.complement_code(encode.complement_code(codes)))
    assert (twice == np.arange(7)).all()


def test_pad_batch_flat_matches_pad_batch():
    rng = np.random.default_rng(11)
    reads = [bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=int(n)))
             for n in rng.integers(1, 60, size=37)]
    flat = np.frombuffer(b"".join(reads), np.uint8)
    offs = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=offs[1:])
    want, wlen = encode.pad_batch(reads, pad_to=64, pad_value=int(encode.PAD_A))
    got, glen = encode.pad_batch_flat(flat, offs, pad_to=64,
                                      pad_value=int(encode.PAD_A))
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(wlen, glen)


def test_pad_batch_flat_uniform_fast_path():
    reads = [b"ACGT", b"TTTT", b"GGCC"]
    flat = np.frombuffer(b"".join(reads), np.uint8)
    offs = np.arange(0, 13, 4, np.int64)
    got, lens = encode.pad_batch_flat(flat, offs, pad_to=8,
                                      pad_value=int(encode.PAD_B))
    want, _ = encode.pad_batch(reads, pad_to=8, pad_value=int(encode.PAD_B))
    np.testing.assert_array_equal(want, got)
    assert list(lens) == [4, 4, 4]


def test_pad_batch_flat_empty():
    got, lens = encode.pad_batch_flat(np.empty(0, np.uint8),
                                      np.zeros(1, np.int64), pad_to=4)
    assert got.shape == (0, 4) and lens.size == 0
