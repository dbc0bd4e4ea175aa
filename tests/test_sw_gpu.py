"""The hot-path SW scorer (ops/sw_gpu.py): the CUDA kernel's schedule, the
wrapper's padding and route choice, and the scorer against the oracles.

The CUDA kernel has no interpret mode, so its arithmetic is checked here
through a NumPy model of its schedule (thread groups sweeping columns, pairs
packed two to a register, query chunks run in passes), and on the card by
the tests marked ``gpu`` (``python chip_smoke.py`` runs them).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mini_parallel.ops import encode, sw, sw_gpu
from mini_parallel.ops.sw_gpu import sw_score_batch_best
from tests.conftest import random_dna


def _batch(rng, B, max_a=80, max_b=60, pad_a=96, pad_b=64):
    ra = [random_dna(rng, int(rng.integers(1, max_a))) for _ in range(B)]
    rb = [random_dna(rng, int(rng.integers(1, max_b))) for _ in range(B)]
    arr_a, _ = encode.pad_batch(ra, pad_to=pad_a, pad_value=int(encode.PAD_A))
    arr_b, _ = encode.pad_batch(rb, pad_to=pad_b, pad_value=int(encode.PAD_B))
    return ra, rb, jnp.asarray(arr_a), jnp.asarray(arr_b)


def kernel_model(a: np.ndarray, b: np.ndarray, G: int, R: int) -> np.ndarray:
    """native/sw_score.cu step for step, one pair at a time: thread t of a
    group owns rows [t*R, t*R + R) of each G*R-row chunk and computes column
    s - t at step s from its left neighbour's previous-step bottom row; the
    last thread stores its bottom row for the next chunk's thread 0."""
    B, M = a.shape
    N = b.shape[1]
    chunk = G * R
    passes = -(-M // chunk)
    out = np.zeros(B, np.int64)
    for p in range(B):
        best = 0
        top = np.zeros(N, np.int64)
        for k in range(passes):
            rows = np.full(chunk, encode.PAD_A, np.int64)
            seg = a[p, k * chunk:(k + 1) * chunk]
            rows[:seg.size] = seg
            H = np.zeros((G, R), np.int64)
            sent = np.zeros(G, np.int64)       # bottom row handed on
            up = np.zeros(G, np.int64)          # H[row0 - 1][j]
            diag = np.zeros(G, np.int64)        # H[row0 - 1][j - 1]
            up[0] = top[0] if k else 0
            new_top = np.zeros(N, np.int64)
            for s in range(N + G - 1):
                for t in range(G):
                    j = s - t
                    if not 0 <= j < N:
                        continue
                    d_in, u_in = diag[t], up[t]
                    for r in range(R):
                        sc = 2 if rows[t * R + r] == b[p, j] else -1
                        left = H[t, r]
                        h = max(0, d_in + sc, left - 2, u_in - 2)
                        best = max(best, h)
                        d_in, u_in = left, h
                        H[t, r] = h
                    if t == G - 1:
                        new_top[j] = H[t, R - 1]
                # shuffle up: thread t receives thread t-1's bottom row
                sent[:] = H[:, R - 1]
                diag[:] = up
                up[1:] = sent[:-1]
                up[0] = top[s + 1] if k and s + 1 < N else 0
            top = new_top
        out[p] = best
    return out


@pytest.mark.parametrize("G,R,M,N", [
    (4, 5, 17, 23),    # one pass, rows padded past M
    (4, 2, 21, 19),    # three passes carry the boundary row
    (8, 1, 30, 9),     # long query, short subject
    (2, 3, 6, 40),     # short query, long subject
])
def test_kernel_schedule_matches_golden(rng, G, R, M, N):
    ra, rb, a, b = _batch(rng, 6, max_a=M + 1, max_b=N + 1, pad_a=M, pad_b=N)
    got = kernel_model(np.asarray(a), np.asarray(b), G, R)
    want = [sw.sw_score_numpy(x, y) for x, y in zip(ra, rb)]
    assert got.tolist() == want


def test_scorer_matches_golden_small(rng):
    ra, rb, a, b = _batch(rng, 8)
    got = np.asarray(sw_score_batch_best(a, b))
    for i in range(8):
        assert got[i] == sw.sw_score_numpy(ra[i], rb[i]), i


def test_scorer_matches_jax_scan(rng):
    ra, rb, a, b = _batch(rng, 32, max_a=150, max_b=150, pad_a=160, pad_b=160)
    got = np.asarray(sw_score_batch_best(a, b))
    ref = np.asarray(sw.sw_score_batch(a, b))
    assert (got == ref).all()


def test_scorer_identical_strings():
    arr, _ = encode.pad_batch([b"ACGT" * 20], pad_to=96,
                              pad_value=int(encode.PAD_A))
    brr, _ = encode.pad_batch([b"ACGT" * 20], pad_to=96,
                              pad_value=int(encode.PAD_B))
    got = sw_score_batch_best(jnp.asarray(arr), jnp.asarray(brr))
    assert int(got[0]) == 160


def test_scorer_odd_batch(rng):
    # an odd pair count leaves the kernel's last register half empty
    ra, rb, a, b = _batch(rng, 3)
    got = np.asarray(sw_score_batch_best(a, b))
    assert got.shape == (3,)
    for i in range(3):
        assert got[i] == sw.sw_score_numpy(ra[i], rb[i])


def test_scorer_empty_and_disjoint():
    arr_a, _ = encode.pad_batch([b"", b"AAAA"], pad_to=16,
                                pad_value=int(encode.PAD_A))
    arr_b, _ = encode.pad_batch([b"ACGT", b"TTTT"], pad_to=16,
                                pad_value=int(encode.PAD_B))
    got = sw_score_batch_best(jnp.asarray(arr_a), jnp.asarray(arr_b))
    assert np.asarray(got).tolist() == [0, 0]


@pytest.mark.parametrize("platform,M,N,want", [
    ("gpu", 152, 152, "cuda"),
    ("gpu", 2048, 2048, "cuda"),
    ("gpu", 20_000, 16_383, "cuda"),   # best score 2 * 16383 fits int16
    ("gpu", 20_000, 16_384, "scan"),   # 2 * 16384 does not
    ("cpu", 152, 152, "scan"),
])
def test_route_by_platform_and_shape(platform, M, N, want):
    assert sw_gpu.route(platform, M, N) == want


def test_kernel_fits_int16_bound():
    assert sw_gpu.kernel_fits(16_383, 10**6)
    assert not sw_gpu.kernel_fits(16_384, 10**6)
    assert not sw_gpu.kernel_fits(0, 10)


@pytest.mark.parametrize("M,want", [
    (152, (16, 10)),   # the headline: one 160-row pass
    (1, (16, 10)),     # the shortest chunk holds any short query
    (161, (32, 8)),    # one row past 160 takes the 256-row chunk
    (256, (32, 8)),
    (512, (32, 16)),
    (1024, (32, 32)),  # exactly one 1024-row chunk
    (2048, (32, 32)),  # two passes of the tallest chunk
])
def test_pick_config_fewest_padded_rows(M, want):
    assert sw_gpu.pick_config(M) == want


def test_configs_match_compiled_variants():
    """Every (group, rows) the wrapper may pick is compiled into the
    library, and each group size divides a warp."""
    import re

    src = open(sw_gpu.SOURCE).read()
    compiled = {(int(g), int(r)) for g, r in
                re.findall(r"MPT_SW_CASE\((\d+), (\d+)\)", src)}
    assert compiled == set(sw_gpu.CONFIGS)
    assert all(32 % g == 0 for g, _ in sw_gpu.CONFIGS)


def test_cuda_path_rejects_int16_overflow():
    a = jnp.zeros((1, 16_384), jnp.uint8)
    with pytest.raises(ValueError, match="16 bits"):
        sw_gpu.sw_score_batch_cuda(a, a)


@pytest.mark.gpu
@pytest.mark.parametrize("B,M,N", [
    (10_000, 152, 152), (511, 600, 500), (257, 37, 45), (64, 1500, 1300),
    (3, 5, 3),
    # several passes with a ragged last thread block: the groups past the
    # batch must leave the boundary buffer alone
    (3, 2048, 2048), (1001, 1500, 1300),
])
def test_cuda_kernel_matches_scan(gpu, rng, B, M, N):
    ra, rb, a, b = _batch(rng, B, max_a=M + 1, max_b=N + 1, pad_a=M,
                          pad_b=N)
    want = np.asarray(sw.sw_score_batch(a, b))
    assert (np.asarray(sw_gpu.sw_score_batch_cuda(a, b)) == want).all()
    for cfg in sw_gpu.CONFIGS:
        got = np.asarray(sw_gpu._cuda_scores(a, b, cfg))
        assert (got == want).all(), cfg


@pytest.mark.gpu
def test_cuda_kernel_under_shard_map(gpu, rng):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    ra, rb, a, b = _batch(rng, 64 * len(jax.devices()), max_a=150,
                          max_b=150, pad_a=152, pad_b=152)
    mesh = Mesh(np.array(jax.devices()), ("data",))
    fn = jax.jit(jax.shard_map(sw_score_batch_best, mesh=mesh,
                               in_specs=(P("data"), P("data")),
                               out_specs=P("data"), check_vma=False))
    assert (np.asarray(fn(a, b)) == np.asarray(sw.sw_score_batch(a, b))).all()
