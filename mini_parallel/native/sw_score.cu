// Batched linear-gap Smith-Waterman scores for Hopper (sm_90a), called from
// JAX through the XLA FFI (ops/sw_gpu.py builds and registers it).
//
// Design (after CUDASW++ 4.0): inter-sequence parallelism with the DP
// column held in registers.
//   - Two pairs share one thread group: their cells ride the two 16-bit
//     halves of every 32-bit register, so each DPX instruction
//     (__viaddmax_s16x2 / __viaddmax_s16x2_relu) updates two cells.
//   - A group of G threads owns a chunk of G*R query rows; thread t holds
//     rows [t*R, t*R + R). The group sweeps the subject column by column
//     as a wavefront over its threads: at step s thread t computes column
//     j = s - t and hands its bottom-row H and the subject character on to
//     thread t + 1 with one warp shuffle each.
//   - Queries longer than G*R run in passes; the last thread of a pass
//     stores its bottom row per column, and thread 0 of the next pass
//     reads it back as the top boundary.
// Scores are bounded by match * min(M, N), so 16 bits hold them whenever
// the wrapper routes here (it checks the bound).

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ uint32_t pack2(uint32_t lo, uint32_t hi) {
  return (lo & 0xffffu) | (hi << 16);
}

template <int G, int R>
__global__ void __launch_bounds__(256)
sw_score_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                int32_t* __restrict__ out, uint32_t* __restrict__ top,
                int B, int M, int N, int passes, uint32_t match2,
                uint32_t mism2, uint32_t gap2, uint32_t pad_a,
                uint32_t pad_b) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int grp = tid / G;
  const int t = tid % G;
  const int p0 = 2 * grp, p1 = 2 * grp + 1;
  const bool v0 = p0 < B, v1 = p1 < B;
  const uint8_t* a0 = a + (size_t)(v0 ? p0 : 0) * M;
  const uint8_t* a1 = a + (size_t)(v1 ? p1 : 0) * M;
  // subject rows are padded to a multiple of 4 bytes by the wrapper
  const uint32_t* b0 =
      reinterpret_cast<const uint32_t*>(b + (size_t)(v0 ? p0 : 0) * N);
  const uint32_t* b1 =
      reinterpret_cast<const uint32_t*>(b + (size_t)(v1 ? p1 : 0) * N);
  const uint32_t pad_b4 = pad_b * 0x01010101u;
  // the grid is rounded up to whole blocks, so the last block may hold
  // groups past the batch: they run the shuffles (full-mask syncs) but
  // never touch the boundary buffer, which holds ceil(B/2) rows
  uint32_t* top_row = top + (size_t)(v0 ? grp : 0) * N;
  const int steps = N + G - 1;
  uint32_t best = 0;

  for (int pass = 0; pass < passes; ++pass) {
    uint32_t qa[R];
    uint32_t H[R];
    const int row0 = pass * G * R + t * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + r;
      const uint32_t c0 = (v0 && i < M) ? a0[i] : pad_a;
      const uint32_t c1 = (v1 && i < M) ? a1[i] : pad_a;
      qa[r] = pack2(c0, c1);
      H[r] = 0;
    }
    const bool read_top = v0 && pass > 0;
    const bool write_top = v0 && pass + 1 < passes;
    // thread 0's subject words: current (columns 4w..4w+3) and next
    uint32_t w0 = pad_b4, w1 = pad_b4, n0 = pad_b4, n1 = pad_b4;
    if (t == 0) {
      w0 = v0 ? __ldg(b0) : pad_b4;
      w1 = v1 ? __ldg(b1) : pad_b4;
      if (N > 4) {
        n0 = v0 ? __ldg(b0 + 1) : pad_b4;
        n1 = v1 ? __ldg(b1 + 1) : pad_b4;
      }
    }
    uint32_t bc = pack2(w0 & 0xffu, w1 & 0xffu);
    uint32_t up = (t == 0 && read_top) ? top_row[0] : 0u;
    uint32_t diag = 0;

    for (int s = 0; s < steps; ++s) {
      const int j = s - t;
      if (j >= 0 && j < N) {
        uint32_t d_in = diag, u_in = up;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint32_t eq = __vcmpeq2(qa[r], bc);
          const uint32_t sc = (eq & match2) | (~eq & mism2);
          const uint32_t left = H[r];
          const uint32_t dg = __vadd2(d_in, sc);
          const uint32_t u = __viaddmax_s16x2(left, gap2, dg);
          const uint32_t h = __viaddmax_s16x2_relu(u_in, gap2, u);
          best = __vmaxs2(best, h);
          d_in = left;
          u_in = h;
          H[r] = h;
        }
        if (write_top && t == G - 1) top_row[j] = H[R - 1];
      }
      const uint32_t recv_h = __shfl_up_sync(kFull, H[R - 1], 1, G);
      const uint32_t recv_c = __shfl_up_sync(kFull, bc, 1, G);
      diag = up;
      if (t == 0) {
        const int nxt = s + 1;
        if ((nxt & 3) == 0) {
          w0 = n0;
          w1 = n1;
          const int wi = (nxt >> 2) + 1;
          n0 = (v0 && 4 * wi < N) ? __ldg(b0 + wi) : pad_b4;
          n1 = (v1 && 4 * wi < N) ? __ldg(b1 + wi) : pad_b4;
        }
        const int sh = 8 * (nxt & 3);
        bc = pack2((w0 >> sh) & 0xffu, (w1 >> sh) & 0xffu);
        up = (read_top && nxt < N) ? top_row[nxt] : 0u;
      } else {
        up = recv_h;
        bc = recv_c;
      }
    }
    // the next pass's thread 0 reads what this pass's last thread wrote
    __syncwarp();
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    best = __vmaxs2(best, __shfl_xor_sync(kFull, best, off, G));
  if (t == 0) {
    if (v0) out[p0] = (int32_t)(int16_t)(best & 0xffffu);
    if (v1) out[p1] = (int32_t)(int16_t)(best >> 16);
  }
}

template <int G, int R>
cudaError_t launch(cudaStream_t stream, const uint8_t* a, const uint8_t* b,
                   int32_t* out, uint32_t* top, int B, int M, int N,
                   int passes, uint32_t match2, uint32_t mism2, uint32_t gap2,
                   uint32_t pad_a, uint32_t pad_b) {
  const long long groups = (B + 1) / 2;
  const long long threads = groups * G;
  const int block = 256;
  const int grid = (int)((threads + block - 1) / block);
  sw_score_kernel<G, R><<<grid, block, 0, stream>>>(
      a, b, out, top, B, M, N, passes, match2, mism2, gap2, pad_a, pad_b);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(cudaStream_t, const uint8_t*,
                                 const uint8_t*, int32_t*, uint32_t*, int,
                                 int, int, int, uint32_t, uint32_t, uint32_t,
                                 uint32_t, uint32_t);

// (G, R) variants the wrapper may ask for; keep in step with
// ops/sw_gpu.py:CONFIGS.
LaunchFn pick(int64_t g, int64_t r) {
#define MPT_SW_CASE(GG, RR) \
  if (g == GG && r == RR) return &launch<GG, RR>;
  MPT_SW_CASE(16, 10)
  MPT_SW_CASE(32, 8)
  MPT_SW_CASE(32, 16)
  MPT_SW_CASE(32, 32)
#undef MPT_SW_CASE
  return nullptr;
}

uint32_t splat16(int64_t v) { return pack2((uint32_t)v, (uint32_t)v); }

ffi::Error SwScoreImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> a,
                       ffi::Buffer<ffi::U8> b,
                       ffi::ResultBuffer<ffi::S32> out,
                       ffi::ResultBuffer<ffi::U32> top, int64_t group,
                       int64_t rows, int64_t match, int64_t mismatch,
                       int64_t gap, int64_t pad_a, int64_t pad_b) {
  const auto da = a.dimensions();
  const auto db = b.dimensions();
  if (da.size() != 2 || db.size() != 2 || da[0] != db[0])
    return ffi::Error::InvalidArgument("sw_score: want (B, M) and (B, N)");
  const int B = (int)da[0], M = (int)da[1], N = (int)db[1];
  if (N % 4 != 0)
    return ffi::Error::InvalidArgument("sw_score: N must be a multiple of 4");
  LaunchFn fn = pick(group, rows);
  if (fn == nullptr)
    return ffi::Error::InvalidArgument("sw_score: unsupported (group, rows)");
  if (B == 0) return ffi::Error::Success();
  const int chunk = (int)(group * rows);
  const int passes = (M + chunk - 1) / chunk;
  if (passes > 1 &&
      top->element_count() < (size_t)((B + 1) / 2) * (size_t)N)
    return ffi::Error::InvalidArgument("sw_score: boundary buffer too small");
  cudaError_t err = fn(stream, a.typed_data(), b.typed_data(),
                       out->typed_data(), top->typed_data(), B, M, N,
                       passes > 0 ? passes : 1, splat16(match),
                       splat16(mismatch), splat16(gap), (uint32_t)pad_a,
                       (uint32_t)pad_b);
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(MptSwScore, SwScoreImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int64_t>("group")
                                  .Attr<int64_t>("rows")
                                  .Attr<int64_t>("match")
                                  .Attr<int64_t>("mismatch")
                                  .Attr<int64_t>("gap")
                                  .Attr<int64_t>("pad_a")
                                  .Attr<int64_t>("pad_b"));
