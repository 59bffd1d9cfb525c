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
// with x read as zero outside [0, F) x [0, T).  Layouts: x (B, F, T, Ci) and
// dy (B, F, T, Co) in bf16, channels last (the wrapper makes that copy from
// torch's NCHW), partial (n_split, kf, kt, Co, Ci) and the result (Co, Ci,
// kf, kt) in float32.  bf16 products are exact in float32 and the
// accumulation is float32, as in the TPU kernel.
//
// What bounds it on the H100: 2 B F T kf kt Ci Co operations against
// 2 B F T (Ci + Co) bytes read once, about 4000 operations per byte at the
// trunk's 64 channels: the tensor cores bind, not the memory.
//
// Design (Hopper's: TMA, mbarriers, wgmma, one producer thread).  Tap (a,
// j) for one row (b, f) is the product of the dy tile (64 t x 64 co) with
// the x tile of row f + a - kf/2 shifted by (j - kt/2) dil in t (64 t x 64
// ci), contracted over t.  One 4-D tensor map per operand over (C, T, F,
// B); a box is 64 c x 64 t x 1 f x 1 b (8 KB, 128-byte swizzle), and wgmma
// reads both boxes MN-major (the channels contiguous, t along K).  Channels
// last is what lets TMA apply the time shift: the shift is the box's t
// coordinate, which may be odd, negative or past T.  Over a time-innermost
// layout (rows padded to 16 bytes) the same loads faulted on the H100
// ("illegal instruction") once a shift moved the innermost coordinate;
// here it stays a multiple of 64 and the shift moves an outer one.  TMA
// fills zeros outside the tensor, so the 'same' padding, the ragged t tail
// and channels past Ci / Co need no mask.  Rows f + a - kf/2 outside [0, F) are not loaded; their
// products read a zero tile.
//
// A block owns J time taps (2 for kf <= 5, 1 for kf 7) and walks f for a
// (b, 64-frame tile) unit: x rows sit in a ring of 8 slots (per time tap),
// each loaded once per unit and used by every frequency tap, and dy rows in
// a ring of 4.  The block is three
// warpgroups.  The third gives its registers to the other two
// (setmaxnreg 40 / 232) and one of its threads issues the TMA loads in the
// order the consumers use them, each slot guarded by a "full" mbarrier
// (bytes arrived) and an "empty" one (every consumer warp done).  The
// first two are the consumers.  With J = 2 each takes one time tap and all
// kf frequency taps (kf 64 x 64 float32 accumulators in registers, 32 a tap
// a thread); with kf 7 they share one time tap and split the frequency taps
// 4 + 3.  Both read the same dy tile.  A step issues kf x 4 wgmma
// m64n64k16 (dy the A operand, x the B), commits them as a group and waits
// for the previous step's group before releasing its slots, so one group is
// always in flight.
//
// The channels-last copies are made by the conv_wgrad_channels_last
// kernels below (tile transposes through shared memory); they are part of
// K6's time on the card.  The copy also reads an operand over time phases,
// as the trunk's dilated convs leave their output's cotangent, and puts
// the frames back in order as it writes.
//
// The TPU kernel sums into one resident output block across its sequential
// grid; here the contraction is split over blocks (each takes every
// n_split-th unit), each block writes its partial sum, and a second kernel
// adds the partial sums in a fixed order and writes the (Co, Ci, kf, kt)
// result: the same bits from launch to launch, no float atomics.  The TPU
// kernel's halo copies of dy, its time-tile ladder and chunk_f serve VMEM
// and BlockSpec and have no counterpart.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kChanTile = 64;                          // Ci and Co per block
constexpr int kTimeTile = 64;                          // t per box (its rows)
constexpr int kTileBytes = kChanTile * kTimeTile * 2;  // one box, 8 KB: 64 rows of 128 bytes
constexpr int kMaxKf = 7;
constexpr int kXRing = 8;     // x row slots per time tap (>= kf + 1)
constexpr int kDyStages = 4;  // dy row slots
constexpr int kConsumers = 2;  // warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;  // and the producer's warpgroup
constexpr uint32_t kReleases = 4 * kConsumers;  // each consumer warp's lane 0

template <int KF>
struct Cfg {
  static constexpr int J = KF <= 5 ? 2 : 1;               // time taps a block owns
  static constexpr int NA = J == 2 ? KF : (KF + 1) / 2;   // frequency taps a warpgroup holds
  static constexpr int kXBytes = J * kXRing * kTileBytes;
  static constexpr int kBarBytes = 8 * 2 * (kXRing + kDyStages);
  // 1 KB to align the tiles, the zero tile, the x rings, the dy ring, barriers
  static constexpr int kSmem = 1024 + kTileBytes + kXBytes + kDyStages * kTileBytes + kBarBytes;
};

template <int KF>
__global__ void __launch_bounds__(kThreads, 1)
conv_wgrad_partial_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap dy_map, float* __restrict__ partial,
                          int batch, int ci_n, int co_n, int f_n, int kt, int dil, int n_tt,
                          int n_split, int n_ci_tiles) {
  using C = Cfg<KF>;
  constexpr int kHalf = KF / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t zero_tile = (raw + 1023) & ~1023u;
  const uint32_t x_tiles = zero_tile + kTileBytes;  // [J][kXRing] boxes
  const uint32_t dy_tiles = x_tiles + C::kXBytes;   // [kDyStages] boxes
  const uint32_t bars = dy_tiles + kDyStages * kTileBytes;
  auto x_full = [&](uint32_t s) { return bars + 8 * s; };
  auto x_empty = [&](uint32_t s) { return bars + 8 * (kXRing + s); };
  auto dy_full = [&](uint32_t s) { return bars + 8 * (2 * kXRing + s); };
  auto dy_empty = [&](uint32_t s) { return bars + 8 * (2 * kXRing + kDyStages + s); };

  const int jg = blockIdx.x;
  const int split = blockIdx.y;
  const int ci0 = (blockIdx.z % n_ci_tiles) * kChanTile;
  const int co0 = (blockIdx.z / n_ci_tiles) * kChanTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  uint4* zt = reinterpret_cast<uint4*>(smem_raw + (zero_tile - raw));
  for (int i = threadIdx.x; i < kTileBytes / 16; i += kThreads) zt[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    for (uint32_t s = 0; s < kXRing; ++s) {
      mbar_init(x_full(s), 1);
      mbar_init(x_empty(s), kReleases);
    }
    for (uint32_t s = 0; s < kDyStages; ++s) {
      mbar_init(dy_full(s), 1);
      mbar_init(dy_empty(s), kReleases);
    }
    fence_barrier_init();
  }
  fence_proxy_async();  // the zero tile, for wgmma
  __syncthreads();

  const int n_units = batch * n_tt;
  const int n_mine = split < n_units ? (n_units - split + n_split - 1) / n_split : 0;

  if (warp >= 4 * kConsumers) {
    // producer: x rows f - kf/2 .. f + kf/2 and dy row f before step f, in
    // the consumers' order; load i of a ring goes to slot i % size.  Its
    // warpgroup gives its registers to the consumers; one thread works.
    setmaxnreg_dec<40>();
    if (threadIdx.x != 4 * kConsumers * 32) return;
    for (int ul = 0; ul < n_mine; ++ul) {
      const int u = split + ul * n_split;
      const int b = u / n_tt;
      const int t0 = (u % n_tt) * kTimeTile;
      for (int f = 0; f < f_n; ++f) {
        const int r_hi = min(f + kHalf, f_n - 1);
        for (int r = f == 0 ? 0 : f + kHalf; r <= r_hi; ++r) {
          const uint32_t i = static_cast<uint32_t>(ul * f_n + r);
          const uint32_t s = i % kXRing;
          mbar_wait(x_empty(s), ((i / kXRing) & 1) ^ 1);
          mbar_expect_tx(x_full(s), C::J * kTileBytes);
#pragma unroll
          for (int jj = 0; jj < C::J; ++jj) {
            const int shift = (jg * C::J + jj - kt / 2) * dil;
            tma_load_4d(x_tiles + (jj * kXRing + s) * kTileBytes, &x_map, x_full(s), ci0,
                        t0 + shift, r, b);
          }
        }
        const uint32_t i = static_cast<uint32_t>(ul * f_n + f);
        const uint32_t s = i % kDyStages;
        mbar_wait(dy_empty(s), ((i / kDyStages) & 1) ^ 1);
        mbar_expect_tx(dy_full(s), kTileBytes);
        tma_load_4d(dy_tiles + s * kTileBytes, &dy_map, dy_full(s), co0, t0, f, b);
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<232>();
  const int wg = warp >> 2;
  const int jj = C::J == 2 ? wg : 0;
  const int a0 = C::J == 2 ? 0 : wg * C::NA;  // this warpgroup's first frequency tap
  const uint32_t my_x = x_tiles + jj * kXRing * kTileBytes;
  float acc[C::NA][32];
#pragma unroll
  for (int a = 0; a < C::NA; ++a)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[a][e] = 0.0f;

  // releases the slots whose last reader was step f of unit ul
  auto release = [&](int ul, int f) {
    if (lane != 0) return;
    mbar_arrive(dy_empty(static_cast<uint32_t>(ul * f_n + f) % kDyStages));
    if (f - kHalf >= 0) mbar_arrive(x_empty(static_cast<uint32_t>(ul * f_n + f - kHalf) % kXRing));
    if (f == f_n - 1)
      for (int r = max(0, f - kHalf + 1); r < f_n; ++r)
        mbar_arrive(x_empty(static_cast<uint32_t>(ul * f_n + r) % kXRing));
  };

  int prev_ul = -1, prev_f = 0;
  for (int ul = 0; ul < n_mine; ++ul) {
    for (int f = 0; f < f_n; ++f) {
      const uint32_t di = static_cast<uint32_t>(ul * f_n + f);
      mbar_wait(dy_full(di % kDyStages), (di / kDyStages) & 1);
      const int r_hi = min(f + kHalf, f_n - 1);
      for (int r = f == 0 ? 0 : f + kHalf; r <= r_hi; ++r) {
        const uint32_t i = static_cast<uint32_t>(ul * f_n + r);
        mbar_wait(x_full(i % kXRing), (i / kXRing) & 1);
      }
      __syncwarp();  // wgmma is .aligned: the warp issues it together
      uint32_t xt[C::NA];
#pragma unroll
      for (int a = 0; a < C::NA; ++a) {
        const int r = f + a0 + a - kHalf;
        xt[a] = (a0 + a < KF && r >= 0 && r < f_n)
                    ? my_x + (static_cast<uint32_t>(ul * f_n + r) % kXRing) * kTileBytes
                    : zero_tile;
      }
      const uint32_t dt = dy_tiles + (di % kDyStages) * kTileBytes;
#pragma unroll
      for (int a = 0; a < C::NA; ++a) fence_regs(acc[a]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kTimeTile / 16; ++k) {
        const uint64_t da = desc_sw128(dt + 2048 * k);
#pragma unroll
        for (int a = 0; a < C::NA; ++a)
          wgmma_m64n64k16_bf16<1>(acc[a], da, desc_sw128(xt[a] + 2048 * k));
      }
      wgmma_commit();
#pragma unroll
      for (int a = 0; a < C::NA; ++a) fence_regs(acc[a]);
      if (prev_ul >= 0) {
        wgmma_wait<1>();
        release(prev_ul, prev_f);
      }
      prev_ul = ul;
      prev_f = f;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < C::NA; ++a) fence_regs(acc[a]);

  const int j = jg * C::J + jj;
  if (j >= kt) return;
  const int w4 = warp & 3;
#pragma unroll
  for (int a = 0; a < C::NA; ++a) {
    if (a0 + a >= KF) continue;
    float* out = partial + ((static_cast<long long>(split) * KF + a0 + a) * kt + j) *
                               static_cast<long long>(ci_n) * co_n;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int ci = ci0 + 8 * c + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + 16 * w4 + (lane >> 2) + 8 * h;
        if (co < co_n && ci < ci_n)  // ci_n is a multiple of 8: ci + 1 < ci_n too
          *reinterpret_cast<float2*>(out + static_cast<long long>(co) * ci_n + ci) =
              make_float2(acc[a][4 * c + 2 * h], acc[a][4 * c + 2 * h + 1]);
      }
    }
  }
}

// K6's operand copy: src (B P, C, F, ceil(T / P)), float32 or bf16, the
// tensor over P time phases as ops/conv.py::time_phases lays them out (P =
// 1: (B, C, F, T)), -> dst (B, F, T, C) bf16 (round to nearest even, as
// torch's cast), frame t = q P + r from phase r's position q; the phases'
// padded tail (t >= T) is dropped.  A block moves a 64 c x 64 q tile of one
// (b P + r, f) through shared memory: reads along q, writes two channels a
// thread, 128 contiguous bytes a warp.  It does none of the product's
// arithmetic.
template <typename T>
__global__ void __launch_bounds__(256)
conv_wgrad_channels_last_kernel(const T* __restrict__ src, uint32_t* __restrict__ dst, int c_n,
                                int f_n, int t_n, int phases) {
  __shared__ unsigned short tile[64][66];
  const int q_n = (t_n + phases - 1) / phases;  // positions a phase
  const int pf = blockIdx.x;                    // (b P + r) F + f
  const int c0 = blockIdx.y * 64;
  const int q0 = blockIdx.z * 64;
  const int f = pf % f_n, bp = pf / f_n;
  const int b = bp / phases, r = bp % phases;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int idx = tid + 256 * i;
    const int c = idx >> 6, q = idx & 63;
    float v = 0.0f;
    if (c0 + c < c_n && q0 + q < q_n) {
      const long long at = ((static_cast<long long>(bp) * c_n + c0 + c) * f_n + f) * q_n + q0 + q;
      if constexpr (sizeof(T) == 4)
        v = src[at];
      else
        v = __uint_as_float(static_cast<uint32_t>(src[at]) << 16);
    }
    tile[c][q] = static_cast<unsigned short>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = tid + 256 * i;
    const int q = idx >> 5, cp = idx & 31;
    const int t = (q0 + q) * phases + r;
    if (q0 + q < q_n && t < t_n && c0 + 2 * cp < c_n)  // c_n is even
      dst[(((static_cast<long long>(b) * f_n + f) * t_n + t) * c_n + c0 + 2 * cp) / 2] =
          static_cast<uint32_t>(tile[2 * cp][q]) | (static_cast<uint32_t>(tile[2 * cp + 1][q]) << 16);
  }
}

// The same copy for bf16 input whose (f, t) planes are whole 16-byte words
// (F T a multiple of 8): (B, C, F T) -> (B, F T, C) as a transpose of 64 c
// x 128 (f, t) tiles, read 16 bytes a thread.
__global__ void __launch_bounds__(256)
conv_wgrad_channels_last_vec_kernel(const uint4* __restrict__ src, uint32_t* __restrict__ dst,
                                    int c_n, int ft_n) {
  __shared__ __align__(16) unsigned short tile[64][136];
  const int p0 = blockIdx.x * 128;
  const int c0 = blockIdx.y * 64;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + 256 * i;
    const int c = idx >> 4, q = idx & 15;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (c0 + c < c_n && p0 + 8 * q < ft_n)  // ft_n is a multiple of 8
      v = src[((static_cast<long long>(b) * c_n + c0 + c) * ft_n + p0 + 8 * q) / 8];
    *reinterpret_cast<uint4*>(&tile[c][8 * q]) = v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int idx = tid + 256 * i;
    const int p = idx >> 5, cp = idx & 31;
    if (p0 + p < ft_n && c0 + 2 * cp < c_n)
      dst[((static_cast<long long>(b) * ft_n + p0 + p) * c_n + c0 + 2 * cp) / 2] =
          static_cast<uint32_t>(tile[2 * cp][p]) | (static_cast<uint32_t>(tile[2 * cp + 1][p]) << 16);
  }
}

// out[co][ci][tap] = sum over the splits, in order, of partial[s][tap][co][ci]
__global__ void conv_wgrad_final_kernel(const float* __restrict__ partial,
                                        float* __restrict__ out, int n_split, int n_taps,
                                        int ci_n, int co_n) {
  const int n = n_taps * ci_n * co_n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int sp = 0; sp < n_split; ++sp) s += partial[static_cast<long long>(sp) * n + i];
  const int ci = i % ci_n;
  const int co = (i / ci_n) % co_n;
  const int tap = i / (co_n * ci_n);
  out[(static_cast<long long>(co) * ci_n + ci) * n_taps + tap] = s;
}

template <int KF>
int launch_partial(const void* x, const void* dy, float* partial, int batch, int ci_n, int co_n,
                   int f_n, int t_n, int kt, int dil, int n_split, cudaStream_t s) {
  using C = Cfg<KF>;
  // (C, T, F, B), innermost first; boxes of 64 channels x 64 frames
  CUtensorMap x_map, dy_map;
  const uint32_t box[4] = {kChanTile, kTimeTile, 1, 1};
  const uint64_t tb = static_cast<uint64_t>(t_n) * 2;
  int e = encode_bf16_4d(&x_map, x, {uint64_t(ci_n), uint64_t(t_n), uint64_t(f_n), uint64_t(batch)},
                         {ci_n * 2ull, ci_n * tb, ci_n * tb * f_n}, box);
  if (e != 0) return e < 0 ? e : -1000 - e;
  e = encode_bf16_4d(&dy_map, dy, {uint64_t(co_n), uint64_t(t_n), uint64_t(f_n), uint64_t(batch)},
                     {co_n * 2ull, co_n * tb, co_n * tb * f_n}, box);
  if (e != 0) return e < 0 ? e : -1000 - e;
  cudaError_t ce = cudaFuncSetAttribute(conv_wgrad_partial_kernel<KF>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const int n_tt = (t_n + kTimeTile - 1) / kTimeTile;
  const int n_ci_tiles = (ci_n + kChanTile - 1) / kChanTile;
  const int n_co_tiles = (co_n + kChanTile - 1) / kChanTile;
  dim3 grid((kt + C::J - 1) / C::J, n_split, n_ci_tiles * n_co_tiles);
  conv_wgrad_partial_kernel<KF><<<grid, kThreads, C::kSmem, s>>>(
      x_map, dy_map, partial, batch, ci_n, co_n, f_n, kt, dil, n_tt, n_split, n_ci_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int conv_wgrad_max_kf() { return kMaxKf; }
int conv_wgrad_time_tile() { return kTimeTile; }
int conv_wgrad_chan_tile() { return kChanTile; }
// Time taps one block owns for kernel height kf (the grid has ceil(kt / it)
// blocks along the taps).
int conv_wgrad_taps_per_block(int kf) { return kf <= 5 ? 2 : 1; }

// K6's operand copy: src (B P, C, F, ceil(T / P)), contiguous, over P time
// phases (P = 1: (B, C, F, T)), float32 when is_f32 else bf16 -> dst (B, F,
// T, C) bf16.  C a multiple of 8.
int conv_wgrad_channels_last(const void* src, void* dst, int batch, int c_n, int f_n, int t_n,
                             int phases, int is_f32, void* stream) {
  if (c_n % 8 != 0 || phases < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int q_n = (t_n + phases - 1) / phases;
  const dim3 grid(batch * phases * f_n, (c_n + 63) / 64, (q_n + 63) / 64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* d = static_cast<uint32_t*>(dst);
  const int ft_n = f_n * t_n;
  if (!is_f32 && phases == 1 && ft_n % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const dim3 vgrid((ft_n + 127) / 128, (c_n + 63) / 64, batch);
    conv_wgrad_channels_last_vec_kernel<<<vgrid, 256, 0, s>>>(static_cast<const uint4*>(src), d,
                                                              c_n, ft_n);
  } else if (is_f32)
    conv_wgrad_channels_last_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(src), d,
                                                               c_n, f_n, t_n, phases);
  else
    conv_wgrad_channels_last_kernel<unsigned short><<<grid, 256, 0, s>>>(
        static_cast<const unsigned short*>(src), d, c_n, f_n, t_n, phases);
  return static_cast<int>(cudaGetLastError());
}

// K6.  x (B, F, T, Ci), dy (B, F, T, Co): bf16, contiguous, 16-byte
// aligned.  partial:
// (n_split, kf, kt, Co, Ci) float32 scratch, n_split <= B * ceil(T / time
// tile).  out: (Co, Ci, kf, kt) float32.  kf odd and <= conv_wgrad_max_kf(),
// kt odd, Ci and Co multiples of 8.  Returns 0, a cudaError, -1 when
// libcuda has no cuTensorMapEncodeTiled, or -1000 - the CUresult it returned.
int conv_wgrad(const void* x, const void* dy, void* partial, void* out, int batch, int ci_n,
               int co_n, int f_n, int t_n, int kf, int kt, int dil, int n_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  if (ci_n % 8 != 0 || co_n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  int e;
  switch (kf) {
    case 1: e = launch_partial<1>(x, dy, pp, batch, ci_n, co_n, f_n, t_n, kt, dil, n_split, s); break;
    case 3: e = launch_partial<3>(x, dy, pp, batch, ci_n, co_n, f_n, t_n, kt, dil, n_split, s); break;
    case 5: e = launch_partial<5>(x, dy, pp, batch, ci_n, co_n, f_n, t_n, kt, dil, n_split, s); break;
    case 7: e = launch_partial<7>(x, dy, pp, batch, ci_n, co_n, f_n, t_n, kt, dil, n_split, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != 0) return e;
  const int n_out = kf * kt * ci_n * co_n;
  conv_wgrad_final_kernel<<<(n_out + 255) / 256, 256, 0, s>>>(
      pp, static_cast<float*>(out), n_split, kf * kt, ci_n, co_n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
