"""Long-sequence column-strip SW (ops/sw_long.py) vs golden oracles.

The capability the reference errors out of (aligner.rs:436-456); scores
must be EXACT vs the quadratic golden at every geometry: single strip,
multiple strips, multiple row blocks, ragged edges, adversarial inputs.
The same sweep runs on every platform; tools/kernel_check repeats the
parity check on the card at real widths.
"""

import numpy as np
import pytest

from mini_parallel.ops.sw import sw_score_numpy
from mini_parallel.ops.sw_long import (sw_score_long,
                                           sw_score_numpy_blocked)
from tests.conftest import random_dna

# small strips keep CPU runtime sane; geometry invariance tests confirm
# results don't depend on (width, blk)
WIDTH, BLK = 1024, 512


def _long(a, b, **kw):
    kw.setdefault("width", WIDTH)
    kw.setdefault("blk", BLK)
    return sw_score_long(a, b, **kw)


def test_blocked_golden_matches_quadratic(rng):
    for m, n in [(1, 1), (7, 13), (80, 64), (200, 150)]:
        a, b = random_dna(rng, m), random_dna(rng, n)
        assert sw_score_numpy_blocked(a, b) == sw_score_numpy(a, b)


@pytest.mark.parametrize(
    "m,n",
    [
        (30, 20),          # tiny: wavefront never fills the strip
        (200, 150),        # single strip, multiple 128-windows
        (600, 1500),       # multiple strips (width 1024)
        (1100, 2100),      # strips AND multiple row blocks (blk=512)
        (513, 1024),       # exact strip-width edge
        (512, 1025),       # one column past the strip edge
    ],
)
def test_exact_vs_golden(rng, m, n):
    a, b = random_dna(rng, m), random_dna(rng, n)
    assert _long(a, b) == sw_score_numpy_blocked(a, b)


def test_identical_strings_score_2n(rng):
    a = random_dna(rng, 3000)
    assert _long(a, a) == 2 * len(a)


def test_embedded_common_segment_crossing_strips(rng):
    # a strong alignment whose optimal path crosses a strip boundary —
    # exercises the carried boundary column
    a = np.frombuffer(random_dna(rng, 2500), np.uint8).copy()
    b = np.frombuffer(random_dna(rng, 2500), np.uint8).copy()
    seg = np.frombuffer(random_dna(rng, 400), np.uint8)
    a[700:1100] = seg
    b[900:1300] = seg  # spans columns 900-1300: crosses the 1024 boundary
    got = _long(bytes(a), bytes(b))
    assert got == sw_score_numpy_blocked(bytes(a), bytes(b))
    assert got >= 2 * 400 - 50  # sanity: the planted signal dominates


def test_geometry_invariance(rng):
    a, b = random_dna(rng, 900), random_dna(rng, 1700)
    want = sw_score_numpy_blocked(a, b)
    assert _long(a, b, width=1024, blk=512) == want
    assert _long(a, b, width=1024, blk=1024) == want
    assert _long(a, b, width=2048, blk=512) == want


def test_empty_inputs():
    assert _long(b"", b"ACGT") == 0
    assert _long(b"ACGT", b"") == 0


def test_score_strings_routes_long_pairs(rng, monkeypatch):
    """AlignmentEngine sw mode must route big pairs to the strip engine
    instead of raising/choking; scores stay exact."""
    from mini_parallel.models import alignment

    eng = alignment.AlignmentEngine(mode="sw")
    monkeypatch.setattr(eng, "LONG_PAIR_THRESHOLD", 1000)
    a, b = random_dna(rng, 1600), random_dna(rng, 1200)
    assert eng.score_strings(a, b) == sw_score_numpy_blocked(a, b)


class TestSharded:
    """Seq-axis halo-exchange pipeline on the virtual CPU mesh."""

    @pytest.fixture
    def mesh2(self):
        import jax
        from jax.sharding import Mesh

        if len(jax.devices()) < 2:
            pytest.skip("needs multi-device mesh")
        return Mesh(np.array(jax.devices()[:2]), ("seq",))

    def test_matches_golden_2chip(self, rng, mesh2):
        from mini_parallel.ops.sw_long import sw_score_long_sharded

        a, b = random_dna(rng, 2200), random_dna(rng, 2600)
        want = sw_score_numpy_blocked(a, b)
        got = sw_score_long_sharded(a, b, mesh2, width=WIDTH, blk=BLK)
        assert got == want

    def test_signal_crossing_band_and_strip(self, rng, mesh2):
        """Optimal path crosses BOTH a strip boundary (carried column) and
        a band boundary (halo state handoff)."""
        from mini_parallel.ops.sw_long import sw_score_long_sharded

        a = np.frombuffer(random_dna(rng, 3000), np.uint8).copy()
        b = np.frombuffer(random_dna(rng, 2200), np.uint8).copy()
        seg = np.frombuffer(random_dna(rng, 600), np.uint8)
        # band boundary for C=2/blk=512: T=4096, band=2048 -> plant across
        a[1700:2300] = seg
        b[800:1400] = seg  # crosses the 1024-column strip edge
        got = sw_score_long_sharded(bytes(a), bytes(b), mesh2, width=WIDTH,
                                    blk=BLK)
        assert got == sw_score_numpy_blocked(bytes(a), bytes(b))
        assert got >= 2 * 600 - 60

    def test_4chip_matches_2chip(self, rng):
        import jax
        from jax.sharding import Mesh

        from mini_parallel.ops.sw_long import sw_score_long_sharded

        if len(jax.devices()) < 4:
            pytest.skip("needs 4 devices")
        a, b = random_dna(rng, 2500), random_dna(rng, 1800)
        want = sw_score_numpy_blocked(a, b)
        for C in (2, 4):
            mesh = Mesh(np.array(jax.devices()[:C]), ("seq",))
            assert sw_score_long_sharded(a, b, mesh, width=WIDTH,
                                         blk=BLK) == want


def _strip_inputs(rng, m, n, W=WIDTH):
    """One strip's device inputs for a (m x n) pair, n <= W: the query
    padded to a whole number of 128 steps past m + W, the strip's columns."""
    import jax.numpy as jnp

    from mini_parallel.ops.encode import PAD_A, PAD_B

    a, b = random_dna(rng, m), random_dna(rng, n)
    T = -(-(m + W) // 128) * 128
    a_pad = np.full(T, PAD_A, np.int32)
    a_pad[:m] = np.frombuffer(a, np.uint8)
    bt = np.full(W, PAD_B, np.int32)
    bt[:n] = np.frombuffer(b, np.uint8)
    return a, b, jnp.asarray(a_pad), jnp.asarray(bt)


@pytest.mark.parametrize("width,n,want", [
    (1 << 18, 1, 1024),          # short subjects round up to one step
    (1 << 18, 9000, 9216),       # narrowed to the subject, rounded up
    (1 << 18, 10**6, 1 << 18),   # long subjects take the full width
    (1024, 1025, 1024),          # an explicit width is a ceiling
])
def test_strip_width_narrows_to_subject(width, n, want):
    from mini_parallel.ops.sw_long import strip_width

    assert strip_width(width, n) == want


def test_rightcol_is_strip_last_column(rng):
    """The sweep emits H[i][W-1] at flat step i + W - 1 (the skew the
    next strip's leftcol shift undoes)."""
    import jax.numpy as jnp

    from mini_parallel.ops.sw_long import _run_strip

    m, W = 300, WIDTH
    a, b, a_col, b_cols = _strip_inputs(rng, m, W)
    best, rc, _ = _run_strip(b_cols, a_col, jnp.zeros_like(a_col))
    H = np.zeros((m + 1, W + 1), np.int64)
    av, bv = np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8)
    for i in range(1, m + 1):
        for j in range(1, W + 1):
            s = 2 if av[i - 1] == bv[j - 1] else -1
            H[i, j] = max(0, H[i - 1, j - 1] + s, H[i - 1, j] - 2,
                          H[i, j - 1] - 2)
    rc = np.asarray(rc)
    assert (rc[W - 1 : W - 1 + m] == H[1:, W]).all()
    assert int(best) == H.max()


def test_state_threading_resumes_sweep(rng):
    """Sweeping a strip in two halves, the second resuming from the
    first's exported state, equals one sweep (the halo-exchange invariant
    the sharded pipeline rests on)."""
    import jax.numpy as jnp

    from mini_parallel.ops.sw_long import _run_strip

    _, _, a_col, b_cols = _strip_inputs(rng, 700, 900)
    lc = jnp.zeros_like(a_col)
    best, rc, st = _run_strip(b_cols, a_col, lc)
    h = a_col.shape[0] // 2
    best1, rc1, st1 = _run_strip(b_cols, a_col[:h], lc[:h])
    best2, rc2, st2 = _run_strip(b_cols, a_col[h:], lc[h:], state=st1)
    assert max(int(best1), int(best2)) == int(best)
    assert (np.concatenate([np.asarray(rc1), np.asarray(rc2)])
            == np.asarray(rc)).all()
    for x, y in zip(st2, st):
        assert (np.asarray(x) == np.asarray(y)).all()


class TestAffineLong:
    def test_exact_vs_goldens(self, rng):
        from mini_parallel.ops.sw import sw_affine_numpy
        from mini_parallel.ops.sw_long import (sw_affine_numpy_blocked,
                                                   sw_affine_score_long)

        for m, n in [(60, 40), (300, 700), (1100, 2100)]:
            a, b = random_dna(rng, m), random_dna(rng, n)
            got = sw_affine_score_long(a, b, width=WIDTH, blk=BLK)
            assert got == sw_affine_numpy_blocked(a, b)
            if m * n <= 300 * 700:
                assert got == sw_affine_numpy(a, b)

    def test_f_boundary_carries_across_strips(self, rng):
        """A long deletion whose F-state must survive a strip boundary:
        affine scores differ from linear exactly when the gap is long."""
        from mini_parallel.ops.sw_long import (sw_affine_numpy_blocked,
                                                   sw_affine_score_long)

        a = np.frombuffer(random_dna(rng, 2600), np.uint8).copy()
        b = np.frombuffer(random_dna(rng, 2600), np.uint8).copy()
        seg = np.frombuffer(random_dna(rng, 500), np.uint8)
        a[500:1000] = seg
        # b carries the segment split by a 40bp insertion right at the
        # 1024-column strip edge, so the affine gap run crosses strips
        ins = np.frombuffer(random_dna(rng, 40), np.uint8)
        bseg = np.concatenate([seg[:220], ins, seg[220:]])
        b[800:800 + bseg.size] = bseg
        got = sw_affine_score_long(bytes(a), bytes(b), width=WIDTH, blk=BLK)
        assert got == sw_affine_numpy_blocked(bytes(a), bytes(b))

    def test_routed_through_engine(self, rng, monkeypatch):
        from mini_parallel.models import alignment
        from mini_parallel.ops.sw_long import sw_affine_numpy_blocked

        eng = alignment.AlignmentEngine(mode="sw-affine")
        monkeypatch.setattr(eng, "LONG_PAIR_THRESHOLD", 1000)
        a, b = random_dna(rng, 1600), random_dna(rng, 1300)
        assert eng.score_strings(a, b) == sw_affine_numpy_blocked(a, b)

    def test_state_threading_resumes_sweep(self, rng):
        import jax.numpy as jnp

        from mini_parallel.ops.sw_long import _NEG_LONG, _run_strip_affine

        _, _, a_col, b_cols = _strip_inputs(rng, 600, 1000)
        lch = jnp.zeros_like(a_col)
        lcf = lch + _NEG_LONG
        whole = _run_strip_affine(b_cols, a_col, lch, lcf, -2, -1)
        h = a_col.shape[0] // 2
        first = _run_strip_affine(b_cols, a_col[:h], lch[:h], lcf[:h],
                                  -2, -1)
        second = _run_strip_affine(b_cols, a_col[h:], lch[h:], lcf[h:],
                                   -2, -1, state=first[3])
        assert max(int(first[0]), int(second[0])) == int(whole[0])
        for k in (1, 2):  # H and F right columns
            assert (np.concatenate([np.asarray(first[k]),
                                    np.asarray(second[k])])
                    == np.asarray(whole[k])).all()
        for x, y in zip(second[3], whole[3]):
            assert (np.asarray(x) == np.asarray(y)).all()


class TestAffineSharded:
    def test_matches_golden_with_boundary_crossing_gap(self, rng):
        import jax
        from jax.sharding import Mesh

        from mini_parallel.ops.sw_long import (
            sw_affine_numpy_blocked, sw_affine_score_long_sharded)

        if len(jax.devices()) < 4:
            pytest.skip("needs 4 devices")
        a = np.frombuffer(random_dna(rng, 2600), np.uint8).copy()
        b = np.frombuffer(random_dna(rng, 2600), np.uint8).copy()
        seg = np.frombuffer(random_dna(rng, 500), np.uint8)
        a[1700:2200] = seg  # crosses the C=2 band boundary (2048)
        ins = np.frombuffer(random_dna(rng, 30), np.uint8)
        bseg = np.concatenate([seg[:230], ins, seg[230:]])
        b[800:800 + bseg.size] = bseg  # affine gap crossing the strip edge
        want = sw_affine_numpy_blocked(bytes(a), bytes(b))
        for C in (2, 4):
            mesh = Mesh(np.array(jax.devices()[:C]), ("seq",))
            got = sw_affine_score_long_sharded(
                bytes(a), bytes(b), mesh, width=WIDTH, blk=BLK)
            assert got == want, (C, got, want)
