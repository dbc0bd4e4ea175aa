"""Smith-Waterman with traceback: batched CIGAR alignment.

Beyond the reference (which only ever produced a single int score), a usable
aligner must report *where* and *how* reads align — start/end coordinates and
a CIGAR string — which is also what downstream variant calling consumes.

Device design: the batched anti-diagonal scan (ops/sw.py) additionally
emits a per-cell 2-bit **move code** for every diagonal (0=stop, 1=diag, 2=up/query-
gap, 3=left/ref-gap). The moves tensor (D, B, M) uint8 stays a device-side
scan output (HBM); the argmax cell per pair is tracked on-device as
(best, d*, i*). Traceback is an O(path length) host walk over the fetched
moves — the classic split: O(B·M·N) vectorized scoring on the accelerator,
O(B·(M+N)) pointer chasing on the host.

Conventions: ``a`` is the query (CIGAR I consumes query), ``b`` the
reference (D consumes reference), M consumes both. Local alignment: the walk
stops at the first stop-move (H floor), yielding soft-clippable start/end
coordinates. Tie-breaking priority diag > up > left everywhere (golden and
batched paths agree, so CIGARs match exactly in tests).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from mini_parallel.ops.encode import PAD_B
from mini_parallel.ops.sw import GAP_PENALTY, MATCH_SCORE, MISMATCH_PENALTY

STOP, DIAG, UP, LEFT = 0, 1, 2, 3


@dataclass
class Alignment:
    score: int
    # 0-based inclusive start, exclusive end, in query (a) / reference (b)
    query_start: int
    query_end: int
    ref_start: int
    ref_end: int
    cigar: str

    def cigar_ops(self) -> list[tuple[int, str]]:
        out, num = [], ""
        for ch in self.cigar:
            if ch.isdigit():
                num += ch
            else:
                out.append((int(num), ch))
                num = ""
        return out


def sw_align_numpy(a, b) -> Alignment:
    """Golden scoring + traceback (host-only, tests)."""
    if isinstance(a, str):
        a = a.encode("ascii")
    if isinstance(b, str):
        b = b.encode("ascii")
    a = np.frombuffer(bytes(a), np.uint8)
    b = np.frombuffer(bytes(b), np.uint8)
    m, n = len(a), len(b)
    H = np.zeros((m + 1, n + 1), np.int64)
    move = np.zeros((m + 1, n + 1), np.uint8)
    best, bi, bj = 0, 0, 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            s = MATCH_SCORE if a[i - 1] == b[j - 1] else MISMATCH_PENALTY
            diag = H[i - 1, j - 1] + s
            up = H[i - 1, j] + GAP_PENALTY
            left = H[i, j - 1] + GAP_PENALTY
            h = max(0, diag, up, left)
            H[i, j] = h
            if h == 0:
                move[i, j] = STOP
            elif h == diag:  # priority diag > up > left
                move[i, j] = DIAG
            elif h == up:
                move[i, j] = UP
            else:
                move[i, j] = LEFT
            # tie-break matches the batched scan (sw_moves_batch): first
            # diagonal reaching the max, then smallest i within it
            if h > best or (h == best and h > 0
                            and (i + j, i) < (bi + bj, bi)):
                best, bi, bj = h, i, j
    # walk
    ops = []
    i, j = bi, bj
    while i > 0 and j > 0 and move[i, j] != STOP:
        mv = move[i, j]
        if mv == DIAG:
            ops.append("M")
            i, j = i - 1, j - 1
        elif mv == UP:
            ops.append("I")
            i -= 1
        else:
            ops.append("D")
            j -= 1
    return Alignment(
        score=int(best), query_start=i, query_end=bi, ref_start=j, ref_end=bj,
        cigar=_rle("".join(reversed(ops))),
    )


def _rle(ops: str) -> str:
    if not ops:
        return ""
    out = []
    cur, count = ops[0], 1
    for ch in ops[1:]:
        if ch == cur:
            count += 1
        else:
            out.append(f"{count}{cur}")
            cur, count = ch, 1
    out.append(f"{count}{cur}")
    return "".join(out)


WALK_UNROLL = 4  # traceback actions per scan step (see sw_positions_batch)

@functools.partial(jax.jit)
def sw_moves_batch(seq_a: jnp.ndarray, seq_b: jnp.ndarray):
    """Batched scoring scan that also emits per-diagonal move codes.

    Returns (best (B,), best_d (B,), best_i (B,), moves (Dp, B, M) uint8)
    where Dp = D rounded up to WALK_UNROLL: the scan takes WALK_UNROLL
    diagonals per step (measured: per-step overhead dominated the D-step
    version; overshoot diagonals are all-invalid so neither the argmax nor
    the walk can touch them).
    """
    B, M = seq_a.shape
    N = seq_b.shape[1]
    D = M + N - 1
    steps = -(-D // WALK_UNROLL)
    a = seq_a.astype(jnp.int32)
    bp = jnp.concatenate(
        [
            jnp.full((B, M - 1), PAD_B, jnp.int32),
            seq_b.astype(jnp.int32),
            jnp.full((B, M + WALK_UNROLL), PAD_B, jnp.int32),
        ],
        axis=1,
    )

    def shift_down(x):
        return jnp.concatenate([jnp.zeros((B, 1), jnp.int32), x[:, :-1]], axis=1)

    i_idx = jnp.arange(M, dtype=jnp.int32)[None, :]

    def one_diag(carry, d):
        d1, d2, best, bd, bi = carry
        w = jax.lax.dynamic_slice_in_dim(bp, d, M, axis=1)[:, ::-1]
        s = jnp.where(a == w, MATCH_SCORE, MISMATCH_PENALTY)
        diag = shift_down(d2) + s
        up = shift_down(d1) + GAP_PENALTY
        left = d1 + GAP_PENALTY
        cand = jnp.maximum(jnp.maximum(diag, up), jnp.maximum(left, 0))
        move = jnp.where(
            cand <= 0,
            STOP,
            jnp.where(cand == diag, DIAG, jnp.where(cand == up, UP, LEFT)),
        ).astype(jnp.uint8)
        # cells outside the valid j range must not win the argmax
        j = d - i_idx
        valid = (j >= 0) & (j < N)
        cand_v = jnp.where(valid, cand, 0)
        row_best = jnp.max(cand_v, axis=1)
        row_arg = jnp.argmax(cand_v, axis=1).astype(jnp.int32)
        better = row_best > best
        best = jnp.where(better, row_best, best)
        bd = jnp.where(better, d, bd)
        bi = jnp.where(better, row_arg, bi)
        return (cand, d1, best, bd, bi), move

    def step(carry, d0):
        mvs = []
        for u in range(WALK_UNROLL):
            carry, mv = one_diag(carry, d0 + u)
            mvs.append(mv)
        return carry, jnp.stack(mvs)

    z = a * 0
    zb = a[:, 0] * 0
    (d1, d2, best, bd, bi), moves = jax.lax.scan(
        step, (z, z, zb, zb, zb),
        WALK_UNROLL * jnp.arange(steps, dtype=jnp.int32),
    )
    return best, bd, bi, moves.reshape(steps * WALK_UNROLL, B, M)


def traceback_host(
    best: np.ndarray, bd: np.ndarray, bi: np.ndarray, moves: np.ndarray
) -> list[Alignment]:
    """Walk the fetched move codes to CIGAR alignments (one per pair)."""
    out = []
    B = best.shape[0]
    for k in range(B):
        score = int(best[k])
        if score <= 0:
            out.append(Alignment(0, 0, 0, 0, 0, ""))
            continue
        d, i = int(bd[k]), int(bi[k])
        # matrix coords: query index qi = i (0-based cell), ref ji = d - i
        qi, ji = i, d - i
        ops = []
        while qi >= 0 and ji >= 0:
            mv = int(moves[qi + ji, k, qi])
            if mv == STOP:
                break
            if mv == DIAG:
                ops.append("M")
                qi -= 1
                ji -= 1
            elif mv == UP:
                ops.append("I")
                qi -= 1
            else:
                ops.append("D")
                ji -= 1
        out.append(
            Alignment(
                score=score,
                query_start=qi + 1,
                query_end=i + 1,
                ref_start=ji + 1,
                ref_end=d - i + 1,
                cigar=_rle("".join(reversed(ops))),
            )
        )
    return out


def sw_align_batch(seq_a: jnp.ndarray, seq_b: jnp.ndarray) -> list[Alignment]:
    """Batched local alignment with CIGARs (device scoring + host walk)."""
    best, bd, bi, moves = sw_moves_batch(seq_a, seq_b)
    return traceback_host(
        np.asarray(best), np.asarray(bd), np.asarray(bi), np.asarray(moves)
    )


# ---------------------------------------------------------------------------
# Affine-gap (Gotoh) traceback. Per-cell move byte: bits 0-1 = H source
# (STOP/DIAG/E/F), bit 2 = E extended from E (vs opened from H), bit 3 = F
# extended from F. Tie conventions (must match the golden oracle exactly):
# H prefers DIAG > E > F; E/F prefer EXTEND on ties.
# ---------------------------------------------------------------------------

E_SRC, F_SRC = 2, 3  # H-source codes (STOP=0, DIAG=1 shared with linear)
_NEG_TB = -(2**24)


def sw_affine_align_numpy(a, b, gap_open: int | None = None,
                          gap_extend: int | None = None,
                          match: int = MATCH_SCORE,
                          mismatch: int = MISMATCH_PENALTY) -> Alignment:
    """Golden Gotoh scoring + traceback (host-only, tests). Tie conventions
    identical to sw_affine_moves_batch: H prefers DIAG > E > F; E/F prefer
    EXTEND."""
    if isinstance(a, str):
        a = a.encode("ascii")
    if isinstance(b, str):
        b = b.encode("ascii")
    # defaults come from the one place the batched path reads them too
    gap_open = GAP_OPEN if gap_open is None else gap_open
    gap_extend = GAP_EXTEND if gap_extend is None else gap_extend
    a = np.frombuffer(bytes(a), np.uint8)
    b = np.frombuffer(bytes(b), np.uint8)
    m, n = len(a), len(b)
    NEG = -(10**9)
    H = np.zeros((m + 1, n + 1), np.int64)
    E = np.full((m + 1, n + 1), NEG, np.int64)
    F = np.full((m + 1, n + 1), NEG, np.int64)
    hsrc = np.zeros((m + 1, n + 1), np.uint8)
    eext = np.zeros((m + 1, n + 1), bool)
    fext = np.zeros((m + 1, n + 1), bool)
    best, bi, bj = 0, 0, 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            s = match if a[i - 1] == b[j - 1] else mismatch
            e_open = H[i, j - 1] + gap_open
            eext[i, j] = E[i, j - 1] >= e_open
            E[i, j] = max(E[i, j - 1], e_open) + gap_extend
            f_open = H[i - 1, j] + gap_open
            fext[i, j] = F[i - 1, j] >= f_open
            F[i, j] = max(F[i - 1, j], f_open) + gap_extend
            diag = H[i - 1, j - 1] + s
            h = max(0, diag, E[i, j], F[i, j])
            H[i, j] = h
            if h <= 0:
                hsrc[i, j] = STOP
            elif h == diag:
                hsrc[i, j] = DIAG
            elif h == E[i, j]:
                hsrc[i, j] = E_SRC
            else:
                hsrc[i, j] = F_SRC
            # tie-break matches sw_affine_moves_batch: first diagonal
            # reaching the max, then smallest i within it
            if h > best or (h == best and h > 0
                            and (i + j, i) < (bi + bj, bi)):
                best, bi, bj = h, i, j
    if best <= 0:
        return Alignment(0, 0, 0, 0, 0, "")
    ops = []
    i, j, state = bi, bj, "H"
    while i > 0 and j > 0:
        if state == "H":
            src = hsrc[i, j]
            if src == STOP:
                break
            if src == DIAG:
                ops.append("M")
                i, j = i - 1, j - 1
            elif src == E_SRC:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            ops.append("D")
            state = "E" if eext[i, j] else "H"
            j -= 1
        else:
            ops.append("I")
            state = "F" if fext[i, j] else "H"
            i -= 1
    return Alignment(
        score=int(best), query_start=i, query_end=bi, ref_start=j, ref_end=bj,
        cigar=_rle("".join(reversed(ops))),
    )

from mini_parallel.ops.sw import GAP_EXTEND, GAP_OPEN  # noqa: E402


@functools.partial(jax.jit, static_argnames=("gap_open", "gap_extend"))
def sw_affine_moves_batch(seq_a, seq_b, gap_open: int = GAP_OPEN,
                          gap_extend: int = GAP_EXTEND):
    """Batched Gotoh scoring scan emitting per-diagonal move bytes.

    Returns (best (B,), best_d (B,), best_i (B,), moves (Dp, B, M) uint8)
    with Dp = D rounded up to WALK_UNROLL (unrolled scan; overshoot
    diagonals are all-invalid, see sw_moves_batch).
    Scoring matches ops/sw.py:sw_affine_batch (first gap base costs
    open+extend, each further base extend).
    """
    B, M = seq_a.shape
    N = seq_b.shape[1]
    D = M + N - 1
    steps = -(-D // WALK_UNROLL)
    a = seq_a.astype(jnp.int32)
    bp = jnp.concatenate(
        [
            jnp.full((B, M - 1), PAD_B, jnp.int32),
            seq_b.astype(jnp.int32),
            jnp.full((B, M + WALK_UNROLL), PAD_B, jnp.int32),
        ],
        axis=1,
    )

    def shift_down(x, fill=0):
        return jnp.concatenate(
            [jnp.full((B, 1), fill, jnp.int32), x[:, :-1]], axis=1
        )

    i_idx = jnp.arange(M, dtype=jnp.int32)[None, :]

    def one_diag(carry, d):
        h1, h2, e1, f1, best, bd, bi = carry
        w = jax.lax.dynamic_slice_in_dim(bp, d, M, axis=1)[:, ::-1]
        s = jnp.where(a == w, MATCH_SCORE, MISMATCH_PENALTY)
        e_open = h1 + gap_open
        e_ext = e1 >= e_open  # tie -> extend
        e = jnp.maximum(e1, e_open) + gap_extend
        f_prev_f = shift_down(f1, _NEG_TB)
        f_prev_h = shift_down(h1)
        f_open = f_prev_h + gap_open
        f_ext = f_prev_f >= f_open
        f = jnp.maximum(f_prev_f, f_open) + gap_extend
        diag = shift_down(h2) + s
        h = jnp.maximum(jnp.maximum(diag, 0), jnp.maximum(e, f))
        h_src = jnp.where(
            h <= 0, STOP,
            jnp.where(h == diag, DIAG, jnp.where(h == e, E_SRC, F_SRC)),
        )
        move = (
            h_src | (e_ext.astype(jnp.int32) << 2)
            | (f_ext.astype(jnp.int32) << 3)
        ).astype(jnp.uint8)
        j = d - i_idx
        valid = (j >= 0) & (j < N)
        cand_v = jnp.where(valid, h, 0)
        row_best = jnp.max(cand_v, axis=1)
        row_arg = jnp.argmax(cand_v, axis=1).astype(jnp.int32)
        better = row_best > best
        best = jnp.where(better, row_best, best)
        bd = jnp.where(better, d, bd)
        bi = jnp.where(better, row_arg, bi)
        return (h, h1, e, f, best, bd, bi), move

    def step(carry, d0):
        mvs = []
        for u in range(WALK_UNROLL):
            carry, mv = one_diag(carry, d0 + u)
            mvs.append(mv)
        return carry, jnp.stack(mvs)

    z = a * 0
    neg = jnp.full((B, M), _NEG_TB, jnp.int32)
    zb = a[:, 0] * 0
    (h1, h2, e1, f1, best, bd, bi), moves = jax.lax.scan(
        step, (z, z, neg, neg, zb, zb, zb),
        WALK_UNROLL * jnp.arange(steps, dtype=jnp.int32),
    )
    return best, bd, bi, moves.reshape(steps * WALK_UNROLL, B, M)


def traceback_affine_host(best, bd, bi, moves) -> list[Alignment]:
    """Gotoh traceback: 3-state walk over the fetched move bytes."""
    out = []
    for k in range(best.shape[0]):
        score = int(best[k])
        if score <= 0:
            out.append(Alignment(0, 0, 0, 0, 0, ""))
            continue
        d, i = int(bd[k]), int(bi[k])
        qi, ji = i, d - i
        ops = []
        state = "H"
        while qi >= 0 and ji >= 0:
            mv = int(moves[qi + ji, k, qi])
            if state == "H":
                src = mv & 3
                if src == STOP:
                    break
                if src == DIAG:
                    ops.append("M")
                    qi -= 1
                    ji -= 1
                elif src == E_SRC:
                    state = "E"
                else:
                    state = "F"
            elif state == "E":  # gap consumes reference -> D
                ops.append("D")
                state = "E" if (mv >> 2) & 1 else "H"
                ji -= 1
            else:  # F: gap consumes query -> I
                ops.append("I")
                state = "F" if (mv >> 3) & 1 else "H"
                qi -= 1
        out.append(
            Alignment(
                score=score, query_start=qi + 1, query_end=i + 1,
                ref_start=ji + 1, ref_end=d - i + 1,
                cigar=_rle("".join(reversed(ops))),
            )
        )
    return out


def sw_affine_align_batch(seq_a, seq_b, gap_open: int = GAP_OPEN,
                          gap_extend: int = GAP_EXTEND) -> list[Alignment]:
    """Batched affine-gap local alignment with CIGARs."""
    best, bd, bi, moves = sw_affine_moves_batch(seq_a, seq_b, gap_open,
                                                gap_extend)
    return traceback_affine_host(
        np.asarray(best), np.asarray(bd), np.asarray(bi), np.asarray(moves)
    )


@functools.partial(jax.jit, static_argnames=("gap_open", "gap_extend"))
def sw_affine_positions_batch(seq_a, seq_b, gap_open: int = GAP_OPEN,
                              gap_extend: int = GAP_EXTEND):
    """Fully on-device Gotoh traceback -> per-base reference positions.

    Affine analogue of sw_positions_batch (same dense diagonal sweep — see
    its docstring for why this beats the per-step gather chain). The walk's
    3-state machine (H / E / F) fuses every H->E / H->F switch with the gap
    emit it mandates: in state H with source E_SRC, the walker emits the D
    op and adopts state from THIS cell's extend bit in one action — exactly
    the two-action sequence of the host walker collapsed, so the current
    diagonal qi+ji still strictly decreases per action and the descending
    sweep visits each action's diagonal exactly once.
    """
    best, bd, bi, moves = sw_affine_moves_batch(seq_a, seq_b, gap_open,
                                                gap_extend)
    B, M = seq_a.shape
    D = moves.shape[0]  # padded to a WALK_UNROLL multiple by the producer
    iota_m = jnp.arange(M, dtype=jnp.int32)[None, :]
    S_H, S_E, S_F = 0, 1, 2

    def one_diag(carry, d):
        qi, ji, state, done, pos = carry
        dc = jnp.clip(d, 0, D - 1)
        slab = jax.lax.dynamic_slice_in_dim(moves, dc, 1, axis=0)[0]
        onehot = iota_m == qi[:, None]  # (B, M)
        mv = jnp.max(jnp.where(onehot, slab.astype(jnp.int32), 0), axis=1)
        active = (~done) & (qi + ji == d) & (qi >= 0) & (ji >= 0)
        src = mv & 3
        eext = ((mv >> 2) & 1) == 1
        fext = ((mv >> 3) & 1) == 1
        in_h = active & (state == S_H)
        h_diag = in_h & (src == DIAG)
        emit_d = (in_h & (src == E_SRC)) | (active & (state == S_E))
        emit_i = (in_h & (src == F_SRC)) | (active & (state == S_F))
        pos = jnp.where(onehot & h_diag[:, None], ji[:, None], pos)
        state = jnp.where(
            h_diag, S_H,
            jnp.where(emit_d, jnp.where(eext, S_E, S_H),
                      jnp.where(emit_i, jnp.where(fext, S_F, S_H), state)),
        )
        qi = qi - h_diag.astype(jnp.int32) - emit_i.astype(jnp.int32)
        ji = ji - h_diag.astype(jnp.int32) - emit_d.astype(jnp.int32)
        done = done | (in_h & (src == STOP))
        return (qi, ji, state, done, pos), None

    def step(carry, d_hi):
        for u in range(WALK_UNROLL):
            carry, _ = one_diag(carry, d_hi - u)
        return carry, None

    pos0 = jnp.full((B, M), -1, jnp.int32)
    carry0 = (bi, bd - bi, jnp.zeros((B,), jnp.int32), best <= 0, pos0)
    steps = -(-D // WALK_UNROLL)
    d_starts = D - 1 - WALK_UNROLL * jnp.arange(steps, dtype=jnp.int32)
    (qi, ji, state, done, pos), _ = jax.lax.scan(step, carry0, d_starts)
    return best, pos


@jax.jit
def sw_positions_batch(
    seq_a: jnp.ndarray, seq_b: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fully on-device traceback: per-base reference positions.

    Returns (score (B,), positions (B, M) int32) where positions[b, i] is the
    0-based index in seq_b that query base i aligns to under the best local
    alignment (M ops only), or -1 for unaligned/inserted/clipped bases —
    exactly what a pileup consumes. The (D, B, M) moves tensor stays in HBM.

    Walk structure (the round-3 rewrite of the serial gather chain): every
    traceback action strictly DECREASES the walker's current anti-diagonal
    qi+ji (DIAG by 2, UP/LEFT by 1), so sweeping diagonals d = D-1..0 and
    letting each read act only when qi+ji == d visits every action exactly
    once. Each sweep step reads the dense (B, M) moves slice for d and
    selects each read's move with a one-hot compare-and-reduce — pure
    elementwise work, ZERO gathers/scatters, where a record-then-scatter
    walk would chain D serial (B,)-gathers; the dense sweep is
    bandwidth-bound on one full read of the moves tensor instead.

    Same move codes and tie-breaking as traceback_host, so positions match
    the host CIGAR application bit-for-bit (tested).
    """
    best, bd, bi, moves = sw_moves_batch(seq_a, seq_b)
    B, M = seq_a.shape
    D = moves.shape[0]  # padded to a WALK_UNROLL multiple by the producer
    iota_m = jnp.arange(M, dtype=jnp.int32)[None, :]

    def one_diag(carry, d):
        qi, ji, done, pos = carry
        dc = jnp.clip(d, 0, D - 1)
        slab = jax.lax.dynamic_slice_in_dim(moves, dc, 1, axis=0)[0]
        onehot = iota_m == qi[:, None]  # (B, M)
        mv = jnp.max(jnp.where(onehot, slab.astype(jnp.int32), 0), axis=1)
        active = (~done) & (qi + ji == d) & (qi >= 0) & (ji >= 0)
        act = jnp.where(active, mv, STOP)
        is_diag = act == DIAG
        pos = jnp.where(onehot & is_diag[:, None], ji[:, None], pos)
        qi = qi - is_diag.astype(jnp.int32) - (act == UP).astype(jnp.int32)
        ji = ji - is_diag.astype(jnp.int32) - (act == LEFT).astype(jnp.int32)
        done = done | (active & (mv == STOP))
        return (qi, ji, done, pos), None

    def step(carry, d_hi):
        for u in range(WALK_UNROLL):
            carry, _ = one_diag(carry, d_hi - u)
        return carry, None

    pos0 = jnp.full((B, M), -1, jnp.int32)
    carry0 = (bi, bd - bi, best <= 0, pos0)
    steps = -(-D // WALK_UNROLL)
    d_starts = D - 1 - WALK_UNROLL * jnp.arange(steps, dtype=jnp.int32)
    (qi, ji, done, pos), _ = jax.lax.scan(step, carry0, d_starts)
    return best, pos
