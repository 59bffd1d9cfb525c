// K6: the weight gradient of the Spectral2DCNN trunk conv for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// mod_extraction_tpu_torch/ops/conv_kernels.py.
//
// Replaces mod_extraction_tpu/ops/pallas_conv.py::_wgrad_kernel
// (conv2d_wgrad_tapcat).  For the 'same'-padded conv with bin dilation 1 and
// time dilation `dil`, odd kernel (kf, kt):
//
//   dW[co, ci, a, j] = sum_{b, f, t} x[b, ci, f + a - kf/2, t + (j - kt/2) dil]
//                                    * dy[b, co, f, t]
//
// with x read as zero outside [0, F) x [0, T).  Layouts (row-major): x
// (B, Ci, F, T) and dy (B, Co, F, T) in bf16, partial (n_split, kf, kt, Ci,
// Co) and the result (Co, Ci, kf, kt) in float32.  bf16 products are exact
// in float32 and the accumulation is float32, as in the TPU kernel.
//
// What bounds it on the H100: 2 B F T kf kt Ci Co operations against
// 2 B F T (Ci + Co) bytes read once, about 4000 operations per byte at the
// trunk's 64 channels, so the tensor cores bind, not the memory.  This first
// version is far from that bound (PERF.md has its times): it waits for the
// element-wise copy into shared memory more than for its products.
//
// Design.  For one row (b, f) both operands are contiguous along t, the
// contraction axis, so tap (a, j) is the product of a (Ci x t) row-major
// tile of x, shifted by (j - kt/2) dil in t, with a (t x Co) column-major
// tile of dy: exactly the operand layouts of mma.sync m16n8k16 (bf16 in,
// float32 accumulators), with no transpose anywhere.  A block owns one time
// tap j and all kf frequency taps, one warp per tap a, each warp holding a
// 64 x 64 (Ci x Co) accumulator in registers for the whole launch.  Because
// the block's shift is one number, it is applied while a tile is copied from
// device memory into shared memory (element by element: rows of odd T are
// only 2-byte aligned anyway), so shared memory is aligned for 32-bit
// fragment reads, the zero padding is a mask in that copy, and neither x nor
// dy needs a padded copy.  A block walks f for a (b, time tile) unit: step f
// needs x rows f - kf/2 .. f + kf/2, of which all but one are already in a
// ring of kf + 1 row tiles, and dy row f, double buffered, so a step is one
// barrier, and the loads of the next step's two tiles are started before this
// step's products and stored after them.  The dy fragments are shared by a
// warp's 64 x 64 products and loaded once per 16 steps of t.  Two blocks
// share an SM, so one's products cover the other's barrier and stores.
//
// The TPU kernel sums into one resident output block across its sequential
// grid; here the contraction is split over blocks (each takes every
// n_split-th unit), each block writes its partial sum, and a second kernel
// adds the partial sums in a fixed order and writes the (Co, Ci, kf, kt)
// result: the same bits from launch to launch, no float atomics.  The TPU
// kernel's halo copies of dy, its time-tile ladder and chunk_f serve VMEM
// and BlockSpec and have no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChanTile = 64;             // Ci and Co per block
constexpr int kTimeTile = 64;             // t per staged tile
constexpr int kRowWords = kTimeTile / 2 + 4;  // 36 words: fragment reads hit 32 banks
constexpr int kTileWords = kChanTile * kRowWords;
constexpr int kMaxKf = 7;

__device__ __forceinline__ void mma_bf16_m16n8k16(float (&d)[4], const uint32_t (&a)[4],
                                                  const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A tile is staged by all warps: warp w takes channels w, w + KF, ..., each
// lane one pair of neighbouring t.  `fetch_tile` reads src[c][t_start + 2
// lane + {0, 1}] into registers (channels >= n_ch and times outside [0,
// t_len) read as 0), `stash_tile` writes them to the shared tile.  Keeping
// the two apart lets the loads of step f + 1 fly while step f's products
// run.  Every load is unconditional, from an address clamped into the
// tensor, and masked afterwards: a branch around a load would make each one
// wait for the one before.
template <int KF>
struct TileRegs {
  static constexpr int kIters = (kChanTile + KF - 1) / KF;
  uint32_t v[kIters];
};

template <int KF>
__device__ __forceinline__ void fetch_tile(TileRegs<KF>& regs,
                                           const unsigned short* __restrict__ src,
                                           long long chan_stride, int n_ch, int t_start,
                                           int t_len, int k_max, int warp, int lane) {
  const int col = 2 * lane;
  const int t = t_start + col;
  const bool lo_ok = col < k_max && t >= 0 && t < t_len;
  const bool hi_ok = col < k_max && t + 1 >= 0 && t + 1 < t_len;
  const int t_lo = min(max(t, 0), t_len - 1);
  const int t_hi = min(max(t + 1, 0), t_len - 1);
  unsigned short lo[TileRegs<KF>::kIters], hi[TileRegs<KF>::kIters];
#pragma unroll
  for (int it = 0; it < TileRegs<KF>::kIters; ++it) {
    const unsigned short* row = src + min(warp + KF * it, n_ch - 1) * chan_stride;
    lo[it] = __ldg(row + t_lo);
    hi[it] = __ldg(row + t_hi);
  }
#pragma unroll
  for (int it = 0; it < TileRegs<KF>::kIters; ++it) {
    const bool ch_ok = warp + KF * it < n_ch;
    const uint32_t l = (ch_ok && lo_ok) ? lo[it] : 0u;
    const uint32_t h = (ch_ok && hi_ok) ? hi[it] : 0u;
    regs.v[it] = l | (h << 16);
  }
}

template <int KF>
__device__ __forceinline__ void stash_tile(uint32_t* dst, const TileRegs<KF>& regs, int k_max,
                                           int warp, int lane) {
  if (2 * lane >= k_max) return;
#pragma unroll
  for (int it = 0; it < TileRegs<KF>::kIters; ++it) {
    const int c = warp + KF * it;
    if (c < kChanTile) dst[c * kRowWords + lane] = regs.v[it];
  }
}

template <int KF>
__global__ void __launch_bounds__(32 * KF, (KF <= 5) ? 2 : 1)
conv_wgrad_partial_kernel(const unsigned short* __restrict__ x,
                          const unsigned short* __restrict__ dy, float* __restrict__ partial,
                          int batch, int ci_n, int co_n, int f_n, int t_n, int kt, int dil,
                          int n_tt, int n_split, int n_ci_tiles) {
  constexpr int kRing = KF + 1;
  constexpr int kHalf = KF / 2;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* xs = smem;                        // [kRing][kChanTile][kRowWords]
  uint32_t* dys = smem + kRing * kTileWords;  // [2][kChanTile][kRowWords]

  const int j = blockIdx.x;
  const int split = blockIdx.y;
  const int ci0 = (blockIdx.z % n_ci_tiles) * kChanTile;
  const int co0 = (blockIdx.z / n_ci_tiles) * kChanTile;
  const int n_ci = min(kChanTile, ci_n - ci0);
  const int n_co = min(kChanTile, co_n - co0);
  const int a = threadIdx.x >> 5;  // this warp's frequency tap
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int shift = (j - kt / 2) * dil;
  const long long plane = static_cast<long long>(f_n) * t_n;

  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  const int n_units = batch * n_tt;
  for (int u = split; u < n_units; u += n_split) {
    const int b = u / n_tt;
    const int t0 = (u % n_tt) * kTimeTile;
    const int k_max = min(kTimeTile, ((t_n - t0 + 15) / 16) * 16);
    const unsigned short* xb = x + (static_cast<long long>(b) * ci_n + ci0) * plane;
    const unsigned short* dyb = dy + (static_cast<long long>(b) * co_n + co0) * plane;

    // step 0 reads x rows 0 .. kHalf (rows < 0 are skipped) and dy row 0;
    // the barrier that ended the previous unit freed every tile
    TileRegs<KF> xr, dr;
    for (int r = 0; r <= kHalf && r < f_n; ++r) {
      fetch_tile<KF>(xr, xb + r * t_n, plane, n_ci, t0 + shift, t_n, k_max, a, lane);
      stash_tile<KF>(xs + ((r + kHalf) % kRing) * kTileWords, xr, k_max, a, lane);
    }
    fetch_tile<KF>(dr, dyb, plane, n_co, t0, t_n, k_max, a, lane);
    stash_tile<KF>(dys, dr, k_max, a, lane);
    __syncthreads();

    for (int f = 0; f < f_n; ++f) {
      // step f + 1 is staged into the ring slot and the dy buffer that step
      // f does not read: its loads are started before this step's products
      // and written to shared memory after them
      const int rn = f + 1 + kHalf;
      const bool next = f + 1 < f_n;
      if (next) {
        if (rn < f_n)
          fetch_tile<KF>(xr, xb + rn * t_n, plane, n_ci, t0 + shift, t_n, k_max, a, lane);
        fetch_tile<KF>(dr, dyb + (f + 1) * t_n, plane, n_co, t0, t_n, k_max, a, lane);
      }
      const int r = f + a - kHalf;  // x row of this warp's tap
      if (r >= 0 && r < f_n) {
        const uint32_t* xw = xs + ((f + a) % kRing) * kTileWords;
        const uint32_t* dw = dys + (f & 1) * kTileWords;
        for (int k0 = 0; k0 < k_max; k0 += 16) {
          const int kw = (k0 >> 1) + tg;
          uint32_t bfr[8][2];
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            bfr[ni][0] = dw[(ni * 8 + g) * kRowWords + kw];
            bfr[ni][1] = dw[(ni * 8 + g) * kRowWords + kw + 4];
          }
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            uint32_t afr[4];
            afr[0] = xw[(mi * 16 + g) * kRowWords + kw];
            afr[1] = xw[(mi * 16 + g + 8) * kRowWords + kw];
            afr[2] = xw[(mi * 16 + g) * kRowWords + kw + 4];
            afr[3] = xw[(mi * 16 + g + 8) * kRowWords + kw + 4];
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) mma_bf16_m16n8k16(acc[mi][ni], afr, bfr[ni]);
          }
        }
      }
      if (next) {
        if (rn < f_n) stash_tile<KF>(xs + ((rn + kHalf) % kRing) * kTileWords, xr, k_max, a, lane);
        stash_tile<KF>(dys + ((f + 1) & 1) * kTileWords, dr, k_max, a, lane);
      }
      __syncthreads();
    }
  }

  float* out = partial +
               ((static_cast<long long>(split) * KF + a) * kt + j) * ci_n * co_n;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int co = co0 + ni * 8 + tg * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci0 + mi * 16 + g + 8 * h;
        if (ci < ci_n) {
          if (co < co_n) out[static_cast<long long>(ci) * co_n + co] = acc[mi][ni][2 * h];
          if (co + 1 < co_n) out[static_cast<long long>(ci) * co_n + co + 1] = acc[mi][ni][2 * h + 1];
        }
      }
    }
  }
}

// out[co][ci][tap] = sum over the splits, in order, of partial[s][tap][ci][co]
__global__ void conv_wgrad_final_kernel(const float* __restrict__ partial,
                                        float* __restrict__ out, int n_split, int n_taps,
                                        int ci_n, int co_n) {
  const int n = n_taps * ci_n * co_n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int sp = 0; sp < n_split; ++sp) s += partial[static_cast<long long>(sp) * n + i];
  const int co = i % co_n;
  const int ci = (i / co_n) % ci_n;
  const int tap = i / (co_n * ci_n);
  out[(static_cast<long long>(co) * ci_n + ci) * n_taps + tap] = s;
}

template <int KF>
cudaError_t launch_partial(const unsigned short* x, const unsigned short* dy, float* partial,
                           int batch, int ci_n, int co_n, int f_n, int t_n, int kt, int dil,
                           int n_split, cudaStream_t s) {
  const int bytes = (KF + 1 + 2) * kTileWords * static_cast<int>(sizeof(uint32_t));
  cudaError_t e = cudaFuncSetAttribute(conv_wgrad_partial_kernel<KF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const int n_tt = (t_n + kTimeTile - 1) / kTimeTile;
  const int n_ci_tiles = (ci_n + kChanTile - 1) / kChanTile;
  const int n_co_tiles = (co_n + kChanTile - 1) / kChanTile;
  dim3 grid(kt, n_split, n_ci_tiles * n_co_tiles);
  conv_wgrad_partial_kernel<KF><<<grid, 32 * KF, bytes, s>>>(
      x, dy, partial, batch, ci_n, co_n, f_n, t_n, kt, dil, n_tt, n_split, n_ci_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int conv_wgrad_max_kf() { return kMaxKf; }
int conv_wgrad_time_tile() { return kTimeTile; }
int conv_wgrad_chan_tile() { return kChanTile; }

// K6.  x (B, Ci, F, T), dy (B, Co, F, T): bf16.  partial: (n_split, kf, kt,
// Ci, Co) float32 scratch, n_split <= B * ceil(T / time tile).  out: (Co,
// Ci, kf, kt) float32.  kf odd and <= conv_wgrad_max_kf(), kt odd.
int conv_wgrad(const void* x, const void* dy, void* partial, void* out, int batch, int ci_n,
               int co_n, int f_n, int t_n, int kf, int kt, int dil, int n_split,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned short* xp = static_cast<const unsigned short*>(x);
  const unsigned short* dyp = static_cast<const unsigned short*>(dy);
  float* pp = static_cast<float*>(partial);
  cudaError_t e;
  switch (kf) {
    case 1: e = launch_partial<1>(xp, dyp, pp, batch, ci_n, co_n, f_n, t_n, kt, dil, n_split, s); break;
    case 3: e = launch_partial<3>(xp, dyp, pp, batch, ci_n, co_n, f_n, t_n, kt, dil, n_split, s); break;
    case 5: e = launch_partial<5>(xp, dyp, pp, batch, ci_n, co_n, f_n, t_n, kt, dil, n_split, s); break;
    case 7: e = launch_partial<7>(xp, dyp, pp, batch, ci_n, co_n, f_n, t_n, kt, dil, n_split, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = kf * kt * ci_n * co_n;
  conv_wgrad_final_kernel<<<(n_out + 255) / 256, 256, 0, s>>>(
      pp, static_cast<float*>(out), n_split, kf * kt, ci_n, co_n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
