// Sample-rate recurrent effects for Hopper (sm_90a): the flanger/chorus
// fractional delay line with feedback (K1) and the six-stage TPT allpass
// phaser cascade (K2).  Plain C interface, loaded with ctypes by
// mod_extraction_tpu_torch/ops/fx_kernels.py.
//
// K1 replaces mod_extraction_tpu/ops/pallas_fx.py::_flanger_kernel
// (flanger_pallas); K2 replaces ::_phaser_kernel (phaser_pallas).
//
// What bounds them on the H100: the bytes they move (x and delay or g read
// once, out written once: ~34 MB at (32, 88200)) take ~10 us at 3.35 TB/s.
// Each is a per-sample recurrence over T = 88200 samples, and the main path
// has only B*C = 32 of them against 132 SMs, so a sequential walk runs for
// the length of one thread's dependency chain, about T times the latency of
// one step, far above that bound.
//
// K1 (and K2 above 8 stages): one warp per recurrence (one block of 32
// threads).  The warp stages kChunk samples of the inputs from device
// memory into shared memory with coalesced loads, lane 0 walks them (all
// state in registers and, for K1, the circular delay line in shared memory,
// which Hopper indexes directly; the TPU kernel's one-hot masked-sum read
// existed only because Mosaic has no per-lane gather), and the warp writes
// the outputs back coalesced.  So the walking lane never waits on device
// memory, only on its own arithmetic and shared-memory reads.  Work that
// does not depend on the recurrence (K2's G = g/(1+g)) is done by the whole
// warp while staging.  K1's feedback read can be one sample back, so it
// stays a walk.
//
// K2 up to 8 stages is a chunked affine scan over time (see its section).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 2048;  // samples staged per pass (8 KB per stream)

// ---------------------------------------------------------------------------
// K1: flanger / chorus delay line
// ---------------------------------------------------------------------------
//
// Per recurrence r and sample t (reference: ops/fx.py::_flanger_scan):
//   w      = t mod d
//   read   = mod(w - delay[t] + d, d)          (float32, delay in [0, d))
//   prev   = floor(read), frac = read - prev, next = (prev + 1) mod d
//   interp = frac * buf[next] + (1 - frac) * buf[prev]
//   buf[w] = x[t] + fb * interp
//   wet    = x[t] + depth * interp
//   out[t] = clip((1 - mix) * x[t] + mix * wet, -1, 1)
__global__ void flanger_kernel(const float* __restrict__ x,
                               const float* __restrict__ delay,
                               const float* __restrict__ fb,
                               const float* __restrict__ depth,
                               const float* __restrict__ mix, float* __restrict__ out,
                               int t_len, int d) {
  extern __shared__ float smem[];
  float* buf = smem;              // [d] circular delay line
  float* xs = buf + d;            // [kChunk] staged x
  float* ds = xs + kChunk;        // [kChunk] staged delay
  float* os = ds + kChunk;        // [kChunk] outputs of the chunk

  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(r) * t_len;
  const float fb_r = fb[r], depth_r = depth[r], mix_r = mix[r];
  const float d_f = static_cast<float>(d);

  for (int i = lane; i < d; i += kWarp) buf[i] = 0.0f;
  int w = 0;  // t mod d, carried by lane 0

  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int n = min(kChunk, t_len - t0);
    for (int i = lane; i < n; i += kWarp) {
      xs[i] = x[base + t0 + i];
      ds[i] = delay[base + t0 + i];
    }
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        // same float32 operation order as the reference: (w - delay) + d
        float rp = __fadd_rn(__fsub_rn(static_cast<float>(w), ds[i]), d_f);
        if (rp >= d_f) rp = __fsub_rn(rp, d_f);  // exact (Sterbenz)
        const float pf = floorf(rp);
        const float frac = __fsub_rn(rp, pf);
        const int prev = static_cast<int>(pf);
        const int next = prev + 1 == d ? 0 : prev + 1;
        const float interp = frac * buf[next] + (1.0f - frac) * buf[prev];
        const float xt = xs[i];
        buf[w] = xt + fb_r * interp;
        const float wet = xt + depth_r * interp;
        const float y = (1.0f - mix_r) * xt + mix_r * wet;
        os[i] = fminf(fmaxf(y, -1.0f), 1.0f);
        w = w + 1 == d ? 0 : w + 1;
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += kWarp) out[base + t0 + i] = os[i];
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K2: phaser allpass cascade
// ---------------------------------------------------------------------------
//
// Per recurrence and sample (reference: ops/fx.py::_phaser_scan):
//   G = g / (1 + g);  u = x + fb * last
//   per stage: v = G (u - s);  lp = v + s;  s <- lp + v;  u <- 2 lp - u
//   last <- u;  out = (1 - mix) x + mix u        (the clip stays in torch)
//
// The walk is linear in its state z = (s_1 .. s_n, last): one sample maps
// it as z' = A(G_t, fb) z + b(G_t) x_t.  So for n_stages <= kScanMaxStages
// K2 is a chunked affine scan, three launches on the caller's stream:
//
//   1. phaser_scan_chunk_kernel: one thread per chunk of L samples
//      walks the chunk from z = 0 driven by x (its offset q_c) and from the
//      n + 1 unit states with x = 0 (its transition P_c).  The n + 2 walks
//      share G and are independent chains, so they overlap where one walk
//      would queue on its own latency.
//   2. phaser_scan_join_kernel: one warp per row joins the chunks in order,
//      z_{c+1} = P_c z_c + q_c (z_{c+1}[i] = q_c[i] + sum_j P_c[i][j] z_c[j],
//      j upwards, fused multiply-adds), the same bits on every launch.
//      Lane i forms component i, reading z_c from the other lanes by
//      shuffle; the warp fetches the next 32 chunks' (P, q) into registers
//      while it joins the current 32.
//   3. phaser_scan_walk_kernel: one thread per chunk walks it again from
//      z_c, driven by x, exactly as the plain walk does, and writes out.
//
// Passes 1 and 3 stage a warp's 32 chunks of x and G through shared memory
// (coalesced, 16 bytes a lane where rows allow it; rows of L + 1
// floats so the 32 walking lanes read 32 banks).  At (32, 88200) that is 22
// one-warp blocks a row, 704 in all, against the sequential walk's 32.
//
// Numerics.  Each stage's 2 x 2 map of (s, u) has eigenvalues +-1: lossless
// but not orthogonal, so P_c is not a contraction in general.  Measured
// with tests/test_torch_phaser_scan.py's float32 model of these passes at T
// 88200, feedback 0.7 and g swept over [0.001, 32] (tan(0.49 pi) ~ 32):
// max|P_c| 1.1-1.6 and max|z_c| below 17 for every chunk length from 32 to
// 512, and the output within 1e-5 of a float64 walk at every length (the
// float32 walk's own distance is of the same size).  The chunk length is
// therefore chosen for speed: 128 balances pass 1 (which wants many chunks
// in flight) against pass 2 (690 sequential joins a row at 88200), and was
// the fastest of 32-512 on the H100 (scripts/bench_torch_fx.py).
//
// The sequential walk, phaser_walk_kernel, serves kScanMaxStages <
// n_stages <= kMaxStages: one warp per recurrence stages the inputs, lane 0
// walks.
constexpr int kMaxStages = 16;
constexpr int kScanMaxStages = 8;
constexpr int kScanChunk = 128;  // samples a thread walks (scripts/bench_torch_fx.py sweeps it)

// Shared memory of a pass-1 or pass-3 block for chunks of L: x and G of 32
// chunks, rows of L + 1 floats.
constexpr int scan_smem_bytes(int L) { return 2 * kWarp * (L + 1) * static_cast<int>(sizeof(float)); }

// Stage samples [base, base + n) into xs and their G = g / (1 + g) into gs,
// chunk c of the span at [c (L + 1) ..]; samples past n read as 0.  Whole
// warp.
template <int L>
__device__ __forceinline__ void scan_stage(const float* __restrict__ x,
                                           const float* __restrict__ g, float* xs,
                                           float* gs, size_t base, int n, bool vec,
                                           int lane) {
  if (vec) {  // rows start 16-byte aligned and n is a multiple of 4
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    const float4* g4 = reinterpret_cast<const float4*>(g + base);
    for (int i4 = lane; i4 < kWarp * L / 4; i4 += kWarp) {
      const int i = 4 * i4;
      const int at = (i / L) * (L + 1) + i % L;
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), gv = xv;
      if (i < n) {
        xv = x4[i4];
        gv = g4[i4];
      }
      xs[at] = xv.x; xs[at + 1] = xv.y; xs[at + 2] = xv.z; xs[at + 3] = xv.w;
      gs[at] = gv.x / (1.0f + gv.x);
      gs[at + 1] = gv.y / (1.0f + gv.y);
      gs[at + 2] = gv.z / (1.0f + gv.z);
      gs[at + 3] = gv.w / (1.0f + gv.w);
    }
  } else {
    for (int i = lane; i < kWarp * L; i += kWarp) {
      const int at = (i / L) * (L + 1) + i % L;
      const float gv = i < n ? g[base + i] : 0.0f;
      xs[at] = i < n ? x[base + i] : 0.0f;
      gs[at] = gv / (1.0f + gv);
    }
  }
}

// One sample of the cascade on state (s[0..N), last) with input xt: the
// plain walk's operations in its order.
template <int N>
__device__ __forceinline__ float phaser_step(float (&z)[N + 1], float xt, float big_g,
                                             float fb) {
  float u = xt + fb * z[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float v = big_g * (u - z[k]);
    const float lp = v + z[k];
    z[k] = lp + v;
    u = 2.0f * lp - u;
  }
  z[N] = u;
  return u;
}

// Pass 1.  pq: (rows, n_chunks, (N + 1) (N + 2)): P_c row-major, then q_c.
template <int N, int L>
__global__ void __launch_bounds__(kWarp)
phaser_scan_chunk_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         const float* __restrict__ fb, float* __restrict__ pq, int t_len,
                         int n_chunks, bool vec) {
  constexpr int Z = N + 1;
  constexpr int S = Z * (Z + 1);
  extern __shared__ float smem[];
  float* xs = smem;                   // [32][L + 1]
  float* gs = smem + kWarp * (L + 1);  // [32][L + 1], G
  const int r = blockIdx.y;
  const int lane = threadIdx.x;
  const int t0 = blockIdx.x * kWarp * L;
  scan_stage<L>(x, g, xs, gs, static_cast<size_t>(r) * t_len + t0, min(kWarp * L, t_len - t0),
                vec, lane);
  __syncwarp();
  const int c = blockIdx.x * kWarp + lane;
  if (c >= n_chunks) return;
  const float fb_r = fb[r];
  float w[Z + 1][Z];  // walk 0: from zero, driven by x; walk 1 + j: from unit j
#pragma unroll
  for (int k = 0; k <= Z; ++k)
#pragma unroll
    for (int i = 0; i < Z; ++i) w[k][i] = (k == i + 1) ? 1.0f : 0.0f;
  const float* xr = xs + lane * (L + 1);
  const float* gr = gs + lane * (L + 1);
#pragma unroll 2
  for (int i = 0; i < L; ++i) {
    const float big_g = gr[i];
    phaser_step<N>(w[0], xr[i], big_g, fb_r);
#pragma unroll
    for (int k = 1; k <= Z; ++k) phaser_step<N>(w[k], 0.0f, big_g, fb_r);
  }
  float* out = pq + (static_cast<size_t>(r) * n_chunks + c) * S;
#pragma unroll
  for (int i = 0; i < Z; ++i) {
#pragma unroll
    for (int j = 0; j < Z; ++j) out[i * Z + j] = w[j + 1][i];
    out[Z * Z + i] = w[0][i];
  }
}

// Pass 2.  zs: (rows, n_chunks, N + 1), the state entering each chunk.
template <int N>
__global__ void __launch_bounds__(kWarp)
phaser_scan_join_kernel(const float* __restrict__ pq, float* __restrict__ zs, int n_chunks) {
  constexpr int Z = N + 1;
  constexpr int S = Z * (Z + 1);
  __shared__ float buf[kWarp * S];
  __shared__ float zb[kWarp * Z];
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const float* src = pq + static_cast<size_t>(r) * n_chunks * S;
  float* dst = zs + static_cast<size_t>(r) * n_chunks * Z;
  const int total = n_chunks * S;
  float pre[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int i = lane + kWarp * k;
    pre[k] = i < total ? src[i] : 0.0f;
  }
  const int me = min(lane, Z - 1);  // the state component this lane joins
  float z = 0.0f;                    // component `me` of the running state
  for (int c0 = 0; c0 < n_chunks; c0 += kWarp) {
#pragma unroll
    for (int k = 0; k < S; ++k) buf[lane + kWarp * k] = pre[k];
    __syncwarp();
    if (c0 + kWarp < n_chunks) {  // the next 32 chunks, in flight while the warp joins
      const int next = (c0 + kWarp) * S;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int i = next + lane + kWarp * k;
        pre[k] = i < total ? src[i] : 0.0f;
      }
    }
    const int cnt = min(kWarp, n_chunks - c0);
    for (int c = 0; c < cnt; ++c) {
      const float* p = buf + c * S + me * Z;
      if (lane < Z) zb[c * Z + lane] = z;
      float acc = buf[c * S + Z * Z + me];
#pragma unroll
      for (int j = 0; j < Z; ++j) acc = fmaf(p[j], __shfl_sync(0xffffffffu, z, j), acc);
      z = acc;
    }
    __syncwarp();
    for (int i = lane; i < cnt * Z; i += kWarp) dst[static_cast<size_t>(c0) * Z + i] = zb[i];
    __syncwarp();
  }
}

// Pass 3.
template <int N, int L>
__global__ void __launch_bounds__(kWarp)
phaser_scan_walk_kernel(const float* __restrict__ x, const float* __restrict__ g,
                        const float* __restrict__ fb, const float* __restrict__ mix,
                        const float* __restrict__ zs, float* __restrict__ out, int t_len,
                        int n_chunks, bool vec) {
  constexpr int Z = N + 1;
  extern __shared__ float smem[];
  float* xs = smem;                   // [32][L + 1], x, then the outputs
  float* gs = smem + kWarp * (L + 1);  // [32][L + 1], G
  const int r = blockIdx.y;
  const int lane = threadIdx.x;
  const int t0 = blockIdx.x * kWarp * L;
  const int n = min(kWarp * L, t_len - t0);
  const size_t base = static_cast<size_t>(r) * t_len + t0;
  scan_stage<L>(x, g, xs, gs, base, n, vec, lane);
  __syncwarp();
  const int c = blockIdx.x * kWarp + lane;
  if (c < n_chunks) {
    const float fb_r = fb[r], mix_r = mix[r];
    float z[Z];
    const float* zc = zs + (static_cast<size_t>(r) * n_chunks + c) * Z;
#pragma unroll
    for (int i = 0; i < Z; ++i) z[i] = zc[i];
    float* xr = xs + lane * (L + 1);
    const float* gr = gs + lane * (L + 1);
#pragma unroll 4
    for (int i = 0; i < L; ++i) {
      const float xt = xr[i];
      const float u = phaser_step<N>(z, xt, gr[i], fb_r);
      xr[i] = (1.0f - mix_r) * xt + mix_r * u;  // in place: this lane's row only
    }
  }
  __syncwarp();
  if (vec) {
    float4* o4 = reinterpret_cast<float4*>(out + base);
    for (int i4 = lane; 4 * i4 < n; i4 += kWarp) {
      const int at = (4 * i4 / L) * (L + 1) + (4 * i4) % L;
      o4[i4] = make_float4(xs[at], xs[at + 1], xs[at + 2], xs[at + 3]);
    }
  } else {
    for (int i = lane; i < n; i += kWarp)
      out[base + i] = xs[(i / L) * (L + 1) + i % L];
  }
}

template <int N, int L>
cudaError_t launch_phaser_scan(const float* x, const float* g, const float* fb,
                               const float* mix, float* out, float* scratch, int rows,
                               int t_len, cudaStream_t s) {
  constexpr int smem = scan_smem_bytes(L);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(phaser_scan_chunk_kernel<N, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(phaser_scan_walk_kernel<N, L>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int n_chunks = (t_len + L - 1) / L;
  const int n_blocks = (t_len + kWarp * L - 1) / (kWarp * L);
  float* pq = scratch;
  float* zs = scratch + static_cast<size_t>(rows) * n_chunks * (N + 1) * (N + 2);
  const bool vec = t_len % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(n_blocks, rows);
  phaser_scan_chunk_kernel<N, L><<<grid, kWarp, smem, s>>>(x, g, fb, pq, t_len, n_chunks, vec);
  phaser_scan_join_kernel<N><<<rows, kWarp, 0, s>>>(pq, zs, n_chunks);
  phaser_scan_walk_kernel<N, L><<<grid, kWarp, smem, s>>>(x, g, fb, mix, zs, out, t_len,
                                                          n_chunks, vec);
  return cudaGetLastError();
}

__global__ void phaser_walk_kernel(const float* __restrict__ x,
                                   const float* __restrict__ g,
                                   const float* __restrict__ fb,
                                   const float* __restrict__ mix, float* __restrict__ out,
                                   int t_len, int n_stages) {
  __shared__ float xs[kChunk];
  __shared__ float gs[kChunk];  // holds G = g / (1 + g)
  __shared__ float os[kChunk];

  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(r) * t_len;
  const float fb_r = fb[r], mix_r = mix[r];

  float s[kMaxStages];
#pragma unroll
  for (int k = 0; k < kMaxStages; ++k) s[k] = 0.0f;
  float last = 0.0f;

  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int n = min(kChunk, t_len - t0);
    for (int i = lane; i < n; i += kWarp) {
      xs[i] = x[base + t0 + i];
      const float gi = g[base + t0 + i];
      gs[i] = gi / (1.0f + gi);
    }
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const float xt = xs[i];
        const float big_g = gs[i];
        float u = xt + fb_r * last;
#pragma unroll
        for (int k = 0; k < kMaxStages; ++k) {
          if (k < n_stages) {
            const float v = big_g * (u - s[k]);
            const float lp = v + s[k];
            s[k] = lp + v;
            u = 2.0f * lp - u;
          }
        }
        last = u;
        os[i] = (1.0f - mix_r) * xt + mix_r * u;
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += kWarp) out[base + t0 + i] = os[i];
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Shared memory K1 needs for a delay line of d samples.
int flanger_smem_bytes(int d) {
  return static_cast<int>((d + 3 * kChunk) * sizeof(float));
}

int phaser_max_stages() { return kMaxStages; }
int phaser_scan_max_stages() { return kScanMaxStages; }
int phaser_chunk() { return kScanChunk; }
// Chunk lengths the scan is built for: kScanChunk at every stage count,
// these others (for the bench's sweep) at 6 stages; 0 asks for the walk.
int phaser_chunk_ok(int n_stages, int chunk) {
  return chunk == kScanChunk || chunk == 0 ||
         (n_stages == 6 && (chunk == 32 || chunk == 64 || chunk == 256 || chunk == 512));
}

// Floats of scratch K2 needs for n rows of t samples in chunks of `chunk`:
// the chunks' (P, q) and entry states of the scan, none for the walk.
long long phaser_scratch_floats(int n, int t, int n_stages, int chunk) {
  if (n_stages > kScanMaxStages || chunk == 0) return 0;
  const long long n_chunks = (t + chunk - 1) / chunk;
  return static_cast<long long>(n) * n_chunks * (n_stages + 1) * (n_stages + 3);
}

// x, delay, out: (n, t) float32, contiguous; fb, depth, mix: (n,) float32.
int flanger_forward(const float* x, const float* delay, const float* fb,
                    const float* depth, const float* mix, float* out, int n,
                    int t, int d, void* stream) {
  const int smem = flanger_smem_bytes(d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flanger_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flanger_kernel<<<n, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      x, delay, fb, depth, mix, out, t, d);
  return static_cast<int>(cudaGetLastError());
}

// x, g, out: (n, t) float32, contiguous; fb, mix: (n,) float32; scratch:
// phaser_scratch_floats(n, t, n_stages, chunk) floats; chunk: the scan's
// chunk length (phaser_chunk_ok), 0 for the sequential walk at any stage
// count.  1 <= n_stages <=
// phaser_max_stages(): the scan up to phaser_scan_max_stages(), the walk
// above it.
int phaser_forward(const float* x, const float* g, const float* fb,
                   const float* mix, float* out, float* scratch, int n, int t,
                   int n_stages, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_stages < 1 || n_stages > kMaxStages) return static_cast<int>(cudaErrorInvalidValue);
  if (n_stages > kScanMaxStages || chunk == 0) {
    phaser_walk_kernel<<<n, kWarp, 0, s>>>(x, g, fb, mix, out, t, n_stages);
    return static_cast<int>(cudaGetLastError());
  }
  if (!phaser_chunk_ok(n_stages, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (chunk != kScanChunk) {
    switch (chunk) {
      case 32: e = launch_phaser_scan<6, 32>(x, g, fb, mix, out, scratch, n, t, s); break;
      case 64: e = launch_phaser_scan<6, 64>(x, g, fb, mix, out, scratch, n, t, s); break;
      case 256: e = launch_phaser_scan<6, 256>(x, g, fb, mix, out, scratch, n, t, s); break;
      default: e = launch_phaser_scan<6, 512>(x, g, fb, mix, out, scratch, n, t, s); break;
    }
    return static_cast<int>(e);
  }
  switch (n_stages) {
    case 1: e = launch_phaser_scan<1, kScanChunk>(x, g, fb, mix, out, scratch, n, t, s); break;
    case 2: e = launch_phaser_scan<2, kScanChunk>(x, g, fb, mix, out, scratch, n, t, s); break;
    case 3: e = launch_phaser_scan<3, kScanChunk>(x, g, fb, mix, out, scratch, n, t, s); break;
    case 4: e = launch_phaser_scan<4, kScanChunk>(x, g, fb, mix, out, scratch, n, t, s); break;
    case 5: e = launch_phaser_scan<5, kScanChunk>(x, g, fb, mix, out, scratch, n, t, s); break;
    case 6: e = launch_phaser_scan<6, kScanChunk>(x, g, fb, mix, out, scratch, n, t, s); break;
    case 7: e = launch_phaser_scan<7, kScanChunk>(x, g, fb, mix, out, scratch, n, t, s); break;
    default: e = launch_phaser_scan<8, kScanChunk>(x, g, fb, mix, out, scratch, n, t, s); break;
  }
  return static_cast<int>(e);
}

}  // extern "C"
