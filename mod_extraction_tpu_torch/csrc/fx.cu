// Sample-rate recurrent effects for Hopper (sm_90a): the flanger/chorus
// fractional delay line with feedback (K1) and the six-stage TPT allpass
// phaser cascade (K2).  Plain C interface, loaded with ctypes by
// mod_extraction_tpu_torch/ops/fx_kernels.py.
//
// K1 replaces mod_extraction_tpu/ops/pallas_fx.py::_flanger_kernel
// (flanger_pallas); K2 replaces ::_phaser_kernel (phaser_pallas).
//
// What bounds them on the H100: each is a strict per-sample recurrence over
// T = 88200 samples, and the main path has only B*C = 32 of them (mono
// audio, batch 32) against 132 SMs.  The bytes they move (x and delay or g
// read once, out written once: ~34 MB) take ~10 us at 3.35 TB/s; the
// kernels instead run for the length of one thread's dependency chain,
// about T times the latency of one step.  They are latency-bound.
//
// Design: one warp per recurrence (one block of 32 threads).  The warp
// stages a chunk of CHUNK samples of the inputs from device memory into
// shared memory with coalesced loads, lane 0 walks the chunk (all state in
// registers and, for K1, the circular delay line in shared memory, which
// Hopper indexes directly — the TPU kernel's one-hot masked-sum read
// existed only because Mosaic has no per-lane gather), and the warp writes
// the chunk's outputs back coalesced.  So the walking lane never waits on
// device memory; it waits only on its own arithmetic and shared-memory
// reads.  Work that does not depend on the recurrence (K2's G = g/(1+g))
// is done by the whole warp while staging.

#include <cuda_runtime.h>

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
constexpr int kMaxStages = 16;

__global__ void phaser_kernel(const float* __restrict__ x,
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

// x, g, out: (n, t) float32, contiguous; fb, mix: (n,) float32.
int phaser_forward(const float* x, const float* g, const float* fb,
                   const float* mix, float* out, int n, int t, int n_stages,
                   void* stream) {
  phaser_kernel<<<n, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      x, g, fb, mix, out, t, n_stages);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
