"""Pair-HMM forward algorithm: P(read | haplotype) for genotype likelihoods.

The core likelihood kernel of GATK-HaplotypeCaller-style variant calling —
the natural companion of this framework's variant-prep stage (the reference
advertises "variant calling (with DeepVariant)", `README.md:2`, with an
empty directory behind it; SURVEY.md §2 #14). Model (the standard GATK
formulation, e.g. the gpuPairHMM literature):

states M (match/mismatch), I (insertion in read), D (deletion from read);

    M[i,j] = prior(i,j) * (tMM*M[i-1,j-1] + tIM*I[i-1,j-1] + tDM*D[i-1,j-1])
    I[i,j] = tMI*M[i-1,j] + tII*I[i-1,j]
    D[i,j] = tMD*M[i,j-1] + tDD*D[i,j-1]

with prior = 1-err if read[i-1]==hap[j-1] else err/3 (err from the base's
Phred quality), transitions from gap-open/extend Phreds
(tMM=1-2δ, tMI=tMD=δ, tII=tDD=ε, tIM=tDM=1-ε), free start anywhere on the
haplotype via the boundary row D[0,j] = 1/hap_len, and free end:

    P(read|hap) = Σ_j M[m,j] + I[m,j].

Numerics: the device path (:func:`pairhmm_batch`) works in float32 scaled
by 2^120 (the standard fp32 Pair-HMM trick); pairs whose float32 result
underflows to 0 are recomputed by the same scan in float64, unscaled — the
recurrence of this module's float64 NumPy oracle. log10-likelihoods are
returned everywhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mini_parallel.ops.encode import PAD_A, PAD_B

DEFAULT_GAP_OPEN_PHRED = 45.0
DEFAULT_GAP_EXT_PHRED = 10.0
SCALE_LOG2 = 120.0  # fp32 initial-condition scale, 2**120
LOG10_2 = float(np.log10(2.0))


def transition_probs(gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
                     gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED):
    """(tMM, tMI, tII, tIM) with tMD=tMI and tDD=tII, tDM=tIM."""
    delta = 10.0 ** (-gap_open_phred / 10.0)
    eps = 10.0 ** (-gap_ext_phred / 10.0)
    return 1.0 - 2.0 * delta, delta, eps, 1.0 - eps


def pairhmm_forward_numpy(read: bytes, qual_phred: np.ndarray, hap: bytes,
                          gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
                          gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED,
                          ) -> float:
    """Golden float64 oracle. Returns log10 P(read | hap).

    ``qual_phred``: per-base Phred scores (ints or floats, len == len(read)).
    """
    m, n = len(read), len(hap)
    if m == 0 or n == 0:
        return float("-inf")
    tMM, tMI, tII, tIM = transition_probs(gap_open_phred, gap_ext_phred)
    tMD, tDD, tDM = tMI, tII, tIM
    err = 10.0 ** (-np.asarray(qual_phred, np.float64) / 10.0)

    M = np.zeros((m + 1, n + 1))
    I = np.zeros((m + 1, n + 1))
    D = np.zeros((m + 1, n + 1))
    D[0, :] = 1.0 / n
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            prior = 1.0 - err[i - 1] if read[i - 1] == hap[j - 1] \
                else err[i - 1] / 3.0
            M[i, j] = prior * (tMM * M[i - 1, j - 1]
                               + tIM * I[i - 1, j - 1]
                               + tDM * D[i - 1, j - 1])
            I[i, j] = tMI * M[i - 1, j] + tII * I[i - 1, j]
            D[i, j] = tMD * M[i, j - 1] + tDD * D[i, j - 1]
    total = float(M[m, 1:].sum() + I[m, 1:].sum())
    return float(np.log10(total)) if total > 0 else float("-inf")


LL_FLOOR = -300.0  # per-read log10 floor: even float64 can underflow to -inf
# (a read mismatching both haplotypes badly enough); flooring keeps the
# genotype algebra finite — a read that explains NEITHER haplotype carries
# no genotype information, so the exact value below the floor is irrelevant


def genotype_likelihoods(read_ll_ref: np.ndarray, read_ll_alt: np.ndarray,
                         ) -> tuple[float, float, float]:
    """Diploid genotype log10-likelihoods (RR, RA, AA) from per-read
    log10 P(read|ref-hap) and P(read|alt-hap) (GATK's model: each read drawn
    from one of the two genotype haplotypes with probability 1/2)."""
    ref = np.maximum(np.asarray(read_ll_ref, np.float64), LL_FLOOR)
    alt = np.maximum(np.asarray(read_ll_alt, np.float64), LL_FLOOR)
    rr = float(ref.sum())
    aa = float(alt.sum())
    # log10((10^ref + 10^alt) / 2) per read, summed — stable via max-factoring
    hi = np.maximum(ref, alt)
    lo = np.minimum(ref, alt)
    ra = float((hi + np.log10(1.0 + 10.0 ** (lo - hi)) - LOG10_2).sum())
    return rr, ra, aa


# ---------------------------------------------------------------------------
# Device path: a float32 anti-diagonal scan over (read, haplotype) pairs.
#
# Diagonal d holds cells (i, j = d - i): the read row i on axis 1 and one
# pair per batch row. M and I of diagonal d need diagonal d-2 shifted down
# one row (M[i-1, j-1] and friends, carried pre-shifted as ms2/is2/ds2) and
# diagonal d-1 (I from [i-1, j], D from [i, j-1]). The free-start boundary
# D[0, j] = 1/hap_len enters as the shift-in row of D, scaled by 2^120.
# Cells left of the haplotype start stay exactly 0 (their every predecessor
# is 0); cells past a pair's read or haplotype end are computed but never
# read. The final read row's M + I is summed over the valid haplotype
# columns as the wavefront passes it.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit,
                   static_argnames=("gap_open_phred", "gap_ext_phred"))
def pairhmm_batch(reads, err, haps, read_lens, hap_lens,
                  gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
                  gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED):
    """Batched forward pass -> (B,) log10 P(read | hap); -inf where a pair
    is empty or its likelihood underflows.

    reads (B, M) uint8 padded with PAD_A; err (B, M) per-base error
    probabilities, float32 (scaled by 2^120) or float64 (unscaled, the
    oracle's numbers; needs x64 enabled); haps (B, N) uint8 padded with
    PAD_B; read_lens and hap_lens (B,) int32.
    """
    B, M = reads.shape
    N = haps.shape[1]
    tMM, tMI, tII, tIM = transition_probs(gap_open_phred, gap_ext_phred)
    tMD, tDD, tDM = tMI, tII, tIM
    a = reads.astype(jnp.int32)
    e = err
    scale_log2 = SCALE_LOG2 if e.dtype == jnp.float32 else 0.0
    hp = jnp.concatenate([
        jnp.full((B, M - 1), PAD_B, jnp.int32),
        haps.astype(jnp.int32),
        jnp.full((B, M), PAD_B, jnp.int32),
    ], axis=1)
    match_p = 1.0 - e
    mism_p = e * (1.0 / 3.0)
    z = e * 0.0
    drow = z[:, :1] + float(2.0 ** scale_log2) / jnp.maximum(
        hap_lens, 1).astype(e.dtype)[:, None]
    la1 = (read_lens - 1)[:, None]
    lb = hap_lens[:, None]
    last_row = jnp.arange(M, dtype=jnp.int32)[None, :] == la1

    def shift(x, fill):
        return jnp.concatenate([fill, x[:, :-1]], axis=1)

    zcol = z[:, :1]

    def step(carry, d):
        m1, i1, d1, ms2, is2, ds2, acc = carry
        w = jax.lax.dynamic_slice_in_dim(hp, d, M, axis=1)[:, ::-1]
        prior = jnp.where(a == w, match_p, mism_p)
        mnew = prior * (tMM * ms2 + tIM * is2 + tDM * ds2)
        sh_m = shift(m1, zcol)
        sh_i = shift(i1, zcol)
        inew = tMI * sh_m + tII * sh_i
        dnew = tMD * m1 + tDD * d1
        valid = last_row & ((d - la1) < lb)
        acc = acc + jnp.where(valid, mnew + inew, 0.0)
        return (mnew, inew, dnew, sh_m, sh_i, shift(d1, drow), acc), None

    ds2 = shift(z, drow)  # the first diagonal's [i-1, j-1] is D[0, 0]
    carry = (z, z, z, z, z, ds2, z)
    carry, _ = jax.lax.scan(step, carry, jnp.arange(M + N - 1), unroll=4)
    total = jnp.sum(carry[-1], axis=1)
    ok = (total > 0) & jnp.isfinite(total)
    return jnp.where(ok, jnp.log10(jnp.where(ok, total, 1.0))
                     - scale_log2 * LOG10_2, -jnp.inf)


def make_pairhmm_sharded(mesh, data_axis: str | None = None,
                         gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
                         gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED):
    """shard_map Pair-HMM: the batch axis shards across the mesh and each
    device runs :func:`pairhmm_batch` on its rows (likelihoods are per pair,
    so no collective is needed). -> jitted fn(reads, err, haps, la, lb) ->
    (B,) log10 likelihoods. B must be divisible by the mesh size."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    axis = data_axis or mesh.axis_names[0]

    def local(reads, err, haps, la, lb):
        return pairhmm_batch(reads, err, haps, la, lb,
                             gap_open_phred=gap_open_phred,
                             gap_ext_phred=gap_ext_phred)

    spec2, spec1 = P(axis, None), P(axis)
    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(spec2, spec2, spec2, spec1, spec1),
        out_specs=spec1,
    ))


_SHARDED_CACHE: dict = {}


def pairhmm_log10_batch(
    reads: list[bytes],
    quals: list[bytes | np.ndarray],
    haps: list[bytes],
    gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
    gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED,
    mesh=None,
) -> np.ndarray:
    """Host-facing batch API. ``quals``: Phred+33 ASCII bytes or numeric
    Phred arrays, one per read. Pairs that underflow the float32 pass are
    scored again in float64 (:func:`_rescue_float64`) — the oracle's
    numbers at any quality.
    With ``mesh``, the batch shards over the data axis (padded to the mesh
    size; the jitted sharded fn is cached per mesh/scoring)."""
    from mini_parallel.ops import encode

    B = len(reads)
    if B == 0:
        return np.empty(0, np.float64)
    phreds = [
        np.frombuffer(q, np.uint8).astype(np.float64) - 33.0
        if isinstance(q, (bytes, bytearray)) else np.asarray(q, np.float64)
        for q in quals
    ]
    M = 1 << max(int(np.ceil(np.log2(max(len(r) for r in reads) or 1))), 3)
    N = 1 << max(int(np.ceil(np.log2(max(len(h) for h in haps) or 1))), 3)
    # bucket B too: the pair count is data-dependent and every new shape
    # compiles — pad pairs are empty -> -inf, sliced off below
    Bp = 1 << max(int(np.ceil(np.log2(B))), 7)
    if mesh is not None:
        Bp = -(-Bp // mesh.devices.size) * mesh.devices.size
    pad_n = Bp - B
    arr_r, la = encode.pad_batch(reads + [b""] * pad_n, pad_to=M,
                                 pad_value=int(PAD_A))
    arr_h, lb = encode.pad_batch(haps + [b""] * pad_n, pad_to=N,
                                 pad_value=int(PAD_B))
    err = np.zeros((Bp, M), np.float32)
    for i, p in enumerate(phreds):
        err[i, : len(p)] = 10.0 ** (-p / 10.0)
    if mesh is not None:
        key = (mesh, gap_open_phred, gap_ext_phred)
        fn = _SHARDED_CACHE.get(key)
        if fn is None:
            fn = _SHARDED_CACHE[key] = make_pairhmm_sharded(
                mesh, gap_open_phred=gap_open_phred,
                gap_ext_phred=gap_ext_phred,
            )
    else:
        fn = functools.partial(pairhmm_batch, gap_open_phred=gap_open_phred,
                               gap_ext_phred=gap_ext_phred)
    ll = np.asarray(
        fn(jnp.asarray(arr_r), jnp.asarray(err), jnp.asarray(arr_h),
           jnp.asarray(la), jnp.asarray(lb)),
        np.float64,
    )[:B]
    redo = np.flatnonzero(~np.isfinite(ll) & (la[:B] > 0) & (lb[:B] > 0))
    if redo.size:
        ll[redo] = _rescue_float64(arr_r[redo], [phreds[i] for i in redo],
                                   arr_h[redo], la[redo], lb[redo],
                                   gap_open_phred, gap_ext_phred)
    return ll


def _rescue_float64(arr_r, phreds, arr_h, la, lb, gap_open_phred,
                    gap_ext_phred) -> np.ndarray:
    """Score pairs that underflowed float32 again in float64 on the
    device, unscaled (the oracle's recurrence and range); the pair count
    is bucketed to a power of two so the compile is reused."""
    n = len(la)
    Bp = 1 << max(int(np.ceil(np.log2(n))), 4)
    pad = Bp - n
    err = np.zeros((Bp, arr_r.shape[1]), np.float64)
    for i, p in enumerate(phreds):
        err[i, : len(p)] = 10.0 ** (-p / 10.0)
    with jax.enable_x64(True):
        ll = pairhmm_batch(
            jnp.asarray(np.pad(arr_r, ((0, pad), (0, 0)),
                               constant_values=int(PAD_A))),
            jnp.asarray(err),
            jnp.asarray(np.pad(arr_h, ((0, pad), (0, 0)),
                               constant_values=int(PAD_B))),
            jnp.asarray(np.pad(la, (0, pad))), jnp.asarray(np.pad(lb, (0, pad))),
            gap_open_phred=gap_open_phred, gap_ext_phred=gap_ext_phred)
        return np.asarray(ll, np.float64)[:n]
