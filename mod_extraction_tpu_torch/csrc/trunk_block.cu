// The Spectral2DCNN trunk's block between two convs (K7) for Hopper (sm_90a),
// forward and backward.  Plain C interface, loaded with ctypes by
// mod_extraction_tpu_torch/ops/trunk_kernels.py.
//
// The block takes conv i's output (without its bias) to conv i+1's input:
//   1. conv i's bias, rounded to the conv's dtype and added as the card's
//      library adds it after the product (the float32 sum rounded back);
//   2. the floor-mode (p, 1) max pool, whose backward sends the cotangent
//      to every element equal to its window's max (eq mask);
//   3. the per-channel PReLU, its float32 alpha promoting (act I/O float32)
//      or rounded to the conv's dtype (act I/O "compute");
//   4. the affine-free LayerNorm over (freq, frames) of each (b, c) plane,
//      statistics in float32: (x - mean) / sqrt(var + eps) (act float32) or
//      (x - mean) * rsqrt(var + eps) rounded to the conv's dtype (compute);
//   5. the cast to the next conv's dtype.
// Reference: ops/trunk_kernels.py::trunk_block_plain, which composes
// models/common.py's functions.  The kernels round at the same points.
//
// It replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it.  Eager PyTorch runs it as about twenty passes over each conv
// output; at the paper's shapes that is about 125 GB a stage-1 step.
//
// What bounds it on the H100: bytes.  Backward: the conv output and the
// output cotangent read once, the conv output's cotangent written once,
// everything between on chip.  Forward: the conv output read once; where
// LayerNorm follows, PReLU's float32 output is written, torch takes the
// planes' mean and variance of it with the reductions the eager chain uses
// (so the forward gives the eager chain's bits: the TBPTT conditioning
// turns the LFO into corners and a validity mask, where a bf16 rounding
// that flips moves a loss by whole per cent), and the norm kernel reads it
// once and writes the next conv's input.
//
// Work split.  The backward's LayerNorm sums reduce over a plane's
// (H / p) x W values, so a plane belongs to one thread-block cluster of
// 1-8 CTAs, each over a band of pooled rows; the CTAs add their partial
// sums through distributed shared memory in rank order, so no reduction
// crosses the grid, none uses atomics, and a relaunch gives the same bits.
// Each CTA stages its band of the conv output (and of the cotangent) in
// shared memory with 16-byte cp.async copies issued all at once, then makes
// its passes there; the first keeps each window's max (exact in the conv's
// dtype) for the second.  The cluster size is the least that keeps a CTA's
// shared memory near kSmemTarget, so several CTAs share an SM and one
// stages while another computes.
//
// Layout.  The conv output is read where it lies: (B*d, C, H, wq) over d
// time phases (frame t = q*d + r lies in batch row b*d + r at position q;
// d = 1 is the plain (B, C, H, W)), any batch and channel strides, frames
// innermost, rows sF apart (sF >= wq).  The time-phased convs of the dilated
// layers are thus read without putting their phases back first, and the
// backward writes the cotangent in the same phase form, zero at the pool's
// floor-mode tail rows and at the phases' padding past W.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRedBytes = 256;        // warp sums and the cluster's partial sums
constexpr int kSmemTarget = 57344;    // a CTA's shared memory the cluster size aims under
constexpr int kSmemMax = 232448;      // a block's shared memory on the H100
constexpr int kMaxCluster = 8;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
// v rounded to T and back: what a tensor of dtype T holds
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// The block's shape.  Strides are in elements of the conv output.
struct Geometry {
  long long sB, sC, sF;  // batch-phase row, channel, frequency row (frames are innermost)
  int B, C, H, W;        // batch, channels, conv rows, frames
  int d, wq;             // time phases, positions a phase
  int p, Hp;             // pool rows, pooled rows (floor)
  int rows;              // pooled rows a CTA
  int cluster;           // CTAs a plane
};

struct Mode {
  int narrow;  // PReLU (and LayerNorm's result) in the conv's dtype
  int ln;      // backward: 0 none, 1 (x - mean) / sqrt(var + eps), 2 (x - mean) * rsqrt(var + eps)
};

// Shared memory of one phase's staged band: its span of rows, rounded up
// to 16 bytes, with room for the shift that keeps shared and global
// addresses equal modulo 16, and a pad that moves the next phase to other
// banks.
__host__ __device__ inline long long region_bytes(const Geometry& g, int esize) {
  const long long span = static_cast<long long>(g.rows * g.p - 1) * g.sF + g.wq;
  return (span * esize + 15) / 16 * 16 + 32;
}
// a band of pooled positions: the cotangent's (backward), or the windows' maxima
__host__ __device__ inline long long pband_bytes(const Geometry& g, int size) {
  return (static_cast<long long>(g.rows) * g.W * size + 15) / 16 * 16 + 32;
}
// the per-frame tables: smem offset of row 0 (forward); and the
// cotangent's offset (backward)
__host__ __device__ inline long long table_bytes(const Geometry& g) {
  return (static_cast<long long>(g.W) * 8 + 15) / 16 * 16;
}
// [red | tables | d phase regions | backward: maxima | cotangent]
__host__ __device__ inline long long smem_bytes(const Geometry& g, int esize, int osize, bool bwd) {
  return kRedBytes + table_bytes(g) + g.d * region_bytes(g, esize) +
         (bwd ? pband_bytes(g, esize) + pband_bytes(g, osize) : 0);
}

// Copies the 16-byte chunks that hold n elements from global src, whole,
// into the 16-byte aligned region dst by cp.async (not waited for here):
// element 0 lands (src mod 16) bytes in.  The bytes around the elements
// lie in the same aligned chunks, so on the same page of the same
// allocation, and are read but not used.
template <typename T>
__device__ T* stage(unsigned char* dst, const T* src, long long n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~static_cast<uintptr_t>(15);
  const uintptr_t hi = (a + n * sizeof(T) + 15) & ~static_cast<uintptr_t>(15);
  const long long chunks = n > 0 ? static_cast<long long>(hi - lo) / 16 : 0;
  const char* s = reinterpret_cast<const char*>(lo);
  for (long long i = threadIdx.x; i < chunks; i += kThreads) cp_async16(dst + 16 * i, s + 16 * i);
  return reinterpret_cast<T*>(dst + (a & 15));
}

// Sums of (a, b) over the block, the same in every thread (fixed order).
__device__ float2 block_sum2(float a, float b, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int w = threadIdx.x >> 5;
  __syncthreads();  // the previous sum's readers are done with red
  if ((threadIdx.x & 31) == 0) {
    red[2 * w] = a;
    red[2 * w + 1] = b;
  }
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
  for (int i = 0; i < kWarps; ++i) {
    r.x += red[2 * i];
    r.y += red[2 * i + 1];
  }
  return r;
}

// The block sums of the cluster's CTAs added in rank order through
// distributed shared memory, the same in every thread of the cluster.
__device__ float2 cluster_sum2(cg::cluster_group& cl, float2 v, float* red) {
  float* mine = red + 2 * kWarps;
  if (threadIdx.x == 0) {
    mine[0] = v.x;
    mine[1] = v.y;
  }
  cl.sync();
  float2 r = make_float2(0.f, 0.f);
  for (unsigned k = 0; k < cl.num_blocks(); ++k) {
    const float* peer = cl.map_shared_rank(mine, k);
    r.x += peer[0];
    r.y += peer[1];
  }
  return r;
}

// What a CTA of the plane's cluster holds and how it reads it.
template <typename TIn>
struct Band {
  const TIn* raw;  // staged conv rows; element (row f of the band, frame t) at raw[col[t] + f * sF]
  const int* col;
  TIn* vmax;       // the windows' maxima, at the band's pooled positions j = il * W + t
  int i0, i1;      // pooled rows [i0, i1)
  int sF;
  int p;
  float bias;      // 0 with no bias
  bool has_bias;
  float alpha;

  // conv output + bias at band row f, frame t: the tensor the pool saw
  __device__ __forceinline__ float biased(int f, int t) const {
    const float x = to_f(raw[col[t] + f * sF]);
    return has_bias ? round_to<TIn>(x + bias) : x;
  }
  // the pool's max over window il (local pooled row), NaN propagating as amax
  __device__ __forceinline__ float pooled(int il, int t) const {
    float v = biased(il * p, t);
    for (int k = 1; k < p; ++k) {
      const float x = biased(il * p + k, t);
      v = (x > v || x != x) ? x : v;
    }
    return v;
  }
};

template <typename TIn>
__device__ __forceinline__ float prelu(float v, float alpha, int narrow) {
  return v >= 0.f ? v : (narrow ? round_to<TIn>(alpha * v) : alpha * v);
}

// Calls f(il, t, j) for each pooled position j = il * W + t of a band of
// n positions, kThreads apart.
template <typename F>
__device__ __forceinline__ void for_pooled(int n, int W, F&& f) {
  int il = threadIdx.x / W, t = threadIdx.x - il * W;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    f(il, t, j);
    t += kThreads;
    while (t >= W) {
      t -= W;
      ++il;
    }
  }
}

// Stages this CTA's band of the plane and fills its frame table; returns
// the band.  Shared memory: [red | table | d phase regions | ...].
template <typename TIn>
__device__ Band<TIn> load_band(const TIn* y, const float* bias, const float* alpha, const Geometry& g,
                               const Mode& m, int plane, int rank, unsigned char* smem) {
  const int b = plane / g.C, c = plane - b * g.C;
  Band<TIn> band;
  band.i0 = min(g.Hp, rank * g.rows);
  band.i1 = min(g.Hp, band.i0 + g.rows);
  band.sF = static_cast<int>(g.sF);
  band.p = g.p;
  band.has_bias = bias != nullptr;
  band.bias = band.has_bias ? round_to<TIn>(bias[c]) : 0.f;
  band.alpha = m.narrow ? round_to<TIn>(alpha[c]) : alpha[c];
  int* col = reinterpret_cast<int*>(smem + kRedBytes);
  unsigned char* regions = smem + kRedBytes + table_bytes(g);
  const long long rb = region_bytes(g, sizeof(TIn));
  band.vmax = reinterpret_cast<TIn*>(regions + g.d * rb);  // the backward's
  const int n_rows = (band.i1 - band.i0) * g.p;
  const long long n = n_rows > 0 ? static_cast<long long>(n_rows - 1) * g.sF + g.wq : 0;
  auto src = [&](int r) {
    return y + (static_cast<long long>(b) * g.d + r) * g.sB + static_cast<long long>(c) * g.sC +
           static_cast<long long>(band.i0) * g.p * g.sF;
  };
  const TIn* base = reinterpret_cast<const TIn*>(regions);
  for (int r = 0; r < g.d; ++r) stage(regions + r * rb, src(r), n);
  for (int t = threadIdx.x; t < g.W; t += kThreads) {
    const int r = t % g.d, q = t / g.d;
    const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src(r)) & 15);
    col[t] = static_cast<int>((r * rb + shift) / static_cast<long long>(sizeof(TIn))) + q;
  }
  band.raw = base;
  band.col = col;
  return band;
}

// Forward, before LayerNorm: bias, pool, PReLU and the cast to out's dtype
// (float32 where LayerNorm follows, its statistics taken by torch).
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    trunk_block_fwd_kernel(const TIn* __restrict__ y, const float* __restrict__ bias,
                           const float* __restrict__ alpha, TOut* __restrict__ out, Geometry g, Mode m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int plane = blockIdx.x / g.cluster;
  const int rank = blockIdx.x - plane * g.cluster;
  const Band<TIn> band = load_band(y, bias, alpha, g, m, plane, rank, smem);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  TOut* o = out + (static_cast<long long>(plane) * g.Hp + band.i0) * g.W;
  for_pooled((band.i1 - band.i0) * g.W, g.W, [&](int il, int t, int j) {
    // PReLU's output as its dtype holds it: float32, or the conv's dtype (narrow)
    const float v = prelu<TIn>(band.pooled(il, t), band.alpha, m.narrow);
    o[j] = from_f<TOut>(v);
  });
}

// Forward, LayerNorm: x (PReLU's output in float32) normalised with its
// plane's statistics as torch's expression computes them elementwise
// (ln 1: (x - mean) / den, den = sqrt(var + eps); ln 2: (x - mean) * den,
// den = rsqrt(var + eps), the result rounded to the conv's dtype when
// narrow), then cast to out's dtype.  One CTA a plane of n values, read 16
// bytes a thread where n is a multiple of 4.
template <typename TOut>
__global__ void __launch_bounds__(kThreads)
    trunk_block_norm_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                            const float* __restrict__ den, TOut* __restrict__ out, long long n, int ln,
                            int round_bf16) {
  const long long base = static_cast<long long>(blockIdx.x) * n;
  const float mu = mean[blockIdx.x], dn = den[blockIdx.x];
  auto norm = [&](float v) {
    v = ln == 1 ? __fdiv_rn(v - mu, dn) : (v - mu) * dn;
    return from_f<TOut>(round_bf16 ? round_to<bf16>(v) : v);
  };
  if ((n & 3) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
#pragma unroll 4
    for (long long i = threadIdx.x; i < n / 4; i += kThreads) {
      const float4 v = x4[i];
      TOut* o = out + base + 4 * i;
      o[0] = norm(v.x);
      o[1] = norm(v.y);
      o[2] = norm(v.z);
      o[3] = norm(v.w);
    }
  } else {
    for (long long i = threadIdx.x; i < n; i += kThreads) out[base + i] = norm(x[base + i]);
  }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    trunk_block_bwd_kernel(const TIn* __restrict__ y, const float* __restrict__ bias,
                           const float* __restrict__ alpha, const float* __restrict__ mean_p,
                           const float* __restrict__ den_p, const TOut* __restrict__ gout, TIn* __restrict__ dy,
                           float* __restrict__ part, Geometry g, Mode m) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int plane = blockIdx.x / g.cluster;
  const int b = plane / g.C, c = plane - b * g.C;
  float* red = reinterpret_cast<float*>(smem);
  const Band<TIn> band = load_band(y, bias, alpha, g, m, plane, rank, smem);
  unsigned char* gregion = reinterpret_cast<unsigned char*>(band.vmax) + pband_bytes(g, sizeof(TIn));
  const int n_local = (band.i1 - band.i0) * g.W;
  const TOut* gs = stage(gregion, gout + (static_cast<long long>(plane) * g.Hp + band.i0) * g.W,
                         static_cast<long long>(n_local));
  cp_async_commit();
  // the cotangent's offset of each frame within the plane's phase rows
  int* dcol = reinterpret_cast<int*>(smem + kRedBytes) + g.W;
  const long long phase_stride = static_cast<long long>(g.C) * g.H * g.wq;
  for (int t = threadIdx.x; t < g.W; t += kThreads)
    dcol[t] = static_cast<int>((t % g.d) * phase_stride) + t / g.d;
  cp_async_wait_all();
  __syncthreads();

  TIn* dplane = dy + (static_cast<long long>(b) * g.d * g.C + c) * g.H * g.wq;
  const float n_plane = static_cast<float>(g.Hp) * static_cast<float>(g.W);
  // LayerNorm's 1/std: x-hat and the closed-form backward multiply by it
  // (the forward divides where torch divides; here it only scales
  // gradients, whose sums are reordered anyway)
  float mean = 0.f, inv = 1.f, mg = 0.f, mgx = 0.f;
  if (m.ln) {
    mean = mean_p[plane];
    inv = m.ln == 1 ? 1.f / den_p[plane] : den_p[plane];
    float sg = 0.f, sgx = 0.f;
    for_pooled(n_local, g.W, [&](int il, int t, int j) {
      const float v = band.pooled(il, t);
      band.vmax[j] = from_f<TIn>(v);
      const float xh = (prelu<TIn>(v, band.alpha, m.narrow) - mean) * inv;
      const float gv = to_f(gs[j]);
      sg += gv;
      sgx += gv * xh;
    });
    const float2 r = cluster_sum2(cl, block_sum2(sg, sgx, red), red);
    mg = r.x / n_plane;
    mgx = r.y / n_plane;
  }
  cl.sync();  // no CTA reads a peer's shared memory past here

  float sa = 0.f, sb = 0.f;
  for_pooled(n_local, g.W, [&](int il, int t, int j) {
    // a thread's maxima from the first pass are its own (same positions)
    const float v = m.ln ? to_f(band.vmax[j]) : band.pooled(il, t);
    const float gv = to_f(gs[j]);
    float dp = gv;
    if (m.ln) {
      const float xh = (prelu<TIn>(v, band.alpha, m.narrow) - mean) * inv;
      dp = (gv - mg - xh * mgx) * inv;
    }
    if (m.narrow) dp = round_to<TIn>(dp);  // LayerNorm's float32 input cast back
    float dv;
    if (v >= 0.f) {
      dv = round_to<TIn>(dp);
    } else {
      dv = round_to<TIn>(dp * band.alpha);
      sa += m.narrow ? round_to<TIn>(dp * v) : dp * v;
    }
    int hits = 0;
    TIn* drow = dplane + dcol[t] + static_cast<long long>(band.i0 + il) * g.p * g.wq;
    for (int k = 0; k < g.p; ++k) {
      const bool hit = band.biased(il * g.p + k, t) == v;
      hits += hit;
      drow[k * g.wq] = from_f<TIn>(hit ? dv : 0.f);
    }
    sb += dv * static_cast<float>(hits);
  });

  // zeros: the phases' padding past W in this band's rows; the last CTA
  // also the floor-mode tail rows
  const int pad = g.d * g.wq - g.W;
  const int band_rows = (band.i1 - band.i0) * g.p;
  for (int e = threadIdx.x; e < band_rows * pad; e += kThreads) {
    const int f = band.i0 * g.p + e / pad, t = g.W + e % pad;
    dplane[(t % g.d) * phase_stride + static_cast<long long>(f) * g.wq + t / g.d] = from_f<TIn>(0.f);
  }
  if (rank == g.cluster - 1) {
    const int tail = g.H - g.Hp * g.p;
    for (int e = threadIdx.x; e < g.d * tail * g.wq; e += kThreads) {
      const int q = e % g.wq, rest = e / g.wq;
      const int f = g.Hp * g.p + rest % tail, r = rest / tail;
      dplane[r * phase_stride + static_cast<long long>(f) * g.wq + q] = from_f<TIn>(0.f);
    }
  }
  const float2 s = block_sum2(sa, sb, red);
  if (threadIdx.x == 0) {
    float* pp = part + (static_cast<long long>(plane) * g.cluster + rank) * 2;
    pp[0] = s.x;
    pp[1] = s.y;
  }
}

// dalpha and the bias gradient of each channel: the planes' partial sums
// over the batch and the cluster in a fixed order, rounded to the conv's
// dtype where autograd's sum rounds them (a parameter cast to it).
__global__ void trunk_block_reduce_kernel(const float* __restrict__ part, float* __restrict__ dalpha,
                                          float* __restrict__ dbias, int B, int C, int cluster,
                                          int alpha_bf16, int bias_bf16) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sa = 0.f, sb = 0.f;
  for (int b = 0; b < B; ++b)
    for (int k = 0; k < cluster; ++k) {
      const float* pp = part + ((static_cast<long long>(b) * C + c) * cluster + k) * 2;
      sa += pp[0];
      sb += pp[1];
    }
  dalpha[c] = alpha_bf16 ? round_to<bf16>(sa) : sa;
  if (dbias != nullptr) dbias[c] = bias_bf16 ? round_to<bf16>(sb) : sb;
}

// The least cluster size (1, 2, 4, 8, at most Hp) whose CTAs stay under
// kSmemTarget, else the largest, if its CTAs fit a block's shared memory;
// 0 if not.  Fills g.rows and g.cluster.
int plan(Geometry& g, int esize, int osize, bool bwd) {
  int k = 1;
  for (;; k *= 2) {
    g.rows = (g.Hp + k - 1) / k;
    g.cluster = k;
    if (smem_bytes(g, esize, osize, bwd) <= kSmemTarget || 2 * k > kMaxCluster || 2 * k > g.Hp) break;
  }
  return smem_bytes(g, esize, osize, bwd) <= kSmemMax ? k : 0;
}

Geometry geometry(long long sB, long long sC, long long sF, int B, int C, int H, int W, int d, int wq,
                  int p) {
  Geometry g{};
  g.sB = sB;
  g.sC = sC;
  g.sF = sF;
  g.B = B;
  g.C = C;
  g.H = H;
  g.W = W;
  g.d = d;
  g.wq = wq;
  g.p = p;
  g.Hp = H / p;
  return g;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, const Geometry& g, long long smem, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(g.B) * g.C * g.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t forward_typed(const void* y, const float* bias, const float* alpha, void* out, Geometry g, Mode m,
                          cudaStream_t stream) {
  const long long smem = smem_bytes(g, sizeof(TIn), sizeof(TOut), false);
  return launch(trunk_block_fwd_kernel<TIn, TOut>, g, smem, stream, static_cast<const TIn*>(y), bias, alpha,
                static_cast<TOut*>(out), g, m);
}

template <typename TIn, typename TOut>
cudaError_t backward_typed(const void* y, const float* bias, const float* alpha, const float* mean,
                           const float* den, const void* gout, void* dy, float* part, float* dalpha, float* dbias,
                           Geometry g, Mode m, cudaStream_t stream) {
  const long long smem = smem_bytes(g, sizeof(TIn), sizeof(TOut), true);
  cudaError_t e = launch(trunk_block_bwd_kernel<TIn, TOut>, g, smem, stream, static_cast<const TIn*>(y), bias,
                         alpha, mean, den, static_cast<const TOut*>(gout), static_cast<TIn*>(dy), part, g, m);
  if (e != cudaSuccess) return e;
  const int in_bf16 = sizeof(TIn) == 2;
  trunk_block_reduce_kernel<<<(g.C + 127) / 128, 128, 0, stream>>>(part, dalpha, dbias, g.B, g.C, g.cluster,
                                                                   m.narrow && in_bf16, in_bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// CTAs a plane takes (its cluster size), forward (bwd 0) or backward
// (bwd 1), for a conv output of dtype size esize and a block output (the
// backward's cotangent) of size osize; 0 if a plane does not fit.
int trunk_block_cluster(long long sF, int H, int W, int d, int wq, int p, int esize, int osize, int bwd) {
  Geometry g = geometry(0, 0, sF, 1, 1, H, W, d, wq, p);
  if (g.Hp < 1) return 0;
  return plan(g, esize, osize, bwd != 0);
}

// Bias, pool and PReLU.  y: the conv output, dtype in_bf16 ? bf16 :
// float32, element (b, c, f, t) at (b*d + t%d)*sB + c*sC + f*sF + t/d
// (t < W <= d*wq); bias (C,) float32 or null; alpha (C,) float32; out (B,
// C, H/p, W) contiguous, dtype out_bf16 ? bf16 : float32.  narrow: PReLU
// in the conv's dtype.
int trunk_block_forward(const void* y, const float* bias, const float* alpha, void* out, int in_bf16,
                        int out_bf16, int narrow, long long sB, long long sC, long long sF, int B, int C, int H,
                        int W, int d, int wq, int p, void* stream) {
  Geometry g = geometry(sB, sC, sF, B, C, H, W, d, wq, p);
  if (g.Hp < 1 || plan(g, in_bf16 ? 2 : 4, out_bf16 ? 2 : 4, false) == 0) return cudaErrorInvalidValue;
  const Mode m{narrow, 0};
  auto st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16 ? forward_typed<bf16, bf16>(y, bias, alpha, out, g, m, st)
                    : forward_typed<bf16, float>(y, bias, alpha, out, g, m, st);
  return out_bf16 ? forward_typed<float, bf16>(y, bias, alpha, out, g, m, st)
                  : forward_typed<float, float>(y, bias, alpha, out, g, m, st);
}

// LayerNorm of the forward's float32 output x, n_planes planes of n
// values, contiguous: out (same layout, out_bf16 ? bf16 : float32) from
// each plane's mean and den (n_planes,) float32; ln and round_bf16 as the
// norm kernel takes them.
int trunk_block_norm(const float* x, const float* mean, const float* den, void* out, int out_bf16, int ln,
                     int round_bf16, int n_planes, long long n, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    trunk_block_norm_kernel<bf16><<<n_planes, kThreads, 0, st>>>(x, mean, den, static_cast<bf16*>(out), n, ln,
                                                                 round_bf16);
  else
    trunk_block_norm_kernel<float><<<n_planes, kThreads, 0, st>>>(x, mean, den, static_cast<float*>(out), n, ln,
                                                                  round_bf16);
  return cudaGetLastError();
}

// The backward.  As the forward, plus: mean and den (B*C,) float32, the
// planes' LayerNorm statistics (den: sqrt(var + eps) for ln 1, rsqrt(var +
// eps) for ln 2; read with ln only); gout (B, C, H/p, W) contiguous in the
// output's dtype; dy (B*d, C, H, wq) contiguous in the conv's dtype; part
// (B*C*8*2) float32 scratch; dalpha (C,) float32; dbias (C,) float32 or
// null (with bias null).
int trunk_block_backward(const void* y, const float* bias, const float* alpha, const float* mean,
                         const float* den, const void* gout, void* dy, float* part, float* dalpha, float* dbias,
                         int in_bf16, int out_bf16, int narrow, int ln, long long sB, long long sC, long long sF,
                         int B, int C, int H, int W, int d, int wq, int p, void* stream) {
  Geometry g = geometry(sB, sC, sF, B, C, H, W, d, wq, p);
  if (g.Hp < 1 || plan(g, in_bf16 ? 2 : 4, out_bf16 ? 2 : 4, true) == 0) return cudaErrorInvalidValue;
  const Mode m{narrow, ln};
  auto st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16
               ? backward_typed<bf16, bf16>(y, bias, alpha, mean, den, gout, dy, part, dalpha, dbias, g, m, st)
               : backward_typed<bf16, float>(y, bias, alpha, mean, den, gout, dy, part, dalpha, dbias, g, m, st);
  return out_bf16
             ? backward_typed<float, bf16>(y, bias, alpha, mean, den, gout, dy, part, dalpha, dbias, g, m, st)
             : backward_typed<float, float>(y, bias, alpha, mean, den, gout, dy, part, dalpha, dbias, g, m, st);
}

int trunk_block_max_cluster() { return kMaxCluster; }

}  // extern "C"
