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
// has only B*C = 32 of them against 132 SMs, so what sets the time is the
// length of a row's chain of dependent steps times the latency of one step,
// far above that bound.
//
// K1 runs as many samples of a row at once as its feedback allows (see its
// section): one warp walks the row in steps of up to 32 samples, with
// nothing on its path but shared memory and its own arithmetic, while other
// warps of the block stage the inputs and write the outputs.
//
// K2 up to 8 stages is a chunked affine scan over time (see its section);
// above 8 stages it keeps a sequential walk: one warp per recurrence stages
// kChunk samples of the inputs in shared memory, lane 0 walks them, the
// warp writes the outputs back.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 2048;  // samples a sequential walk stages per pass (8 KB per stream)

// ---------------------------------------------------------------------------
// K1: flanger / chorus delay line
// ---------------------------------------------------------------------------
//
// Per recurrence r and sample t (reference: ops/fx.py::_flanger_scan):
//   w      = t mod d
//   read   = mod((w - delay[t]) + d, d)         (float32, as jnp.mod: any delay)
//   prev   = floor(read), frac = read - prev, next = (prev + 1) mod d
//   interp = frac * buf[next] + (1 - frac) * buf[prev]
//   buf[w] = x[t] + fb * interp
//   wet    = x[t] + depth * interp
//   out[t] = clip((1 - mix) * x[t] + mix * wet, -1, 1)
//
// Steps.  Sample t reads slots prev and next.  Call a slot's age the
// samples since it was last written: (w - slot) mod d, and d for slot w
// itself (written d samples ago, about to be overwritten).  dep(t) is the
// lesser age of the two slots.  Samples t0 .. t0 + s - 1 can run at once,
// all reads before all writes, exactly when dep(t0 + j) > j for every
// j < s: each then reads a value written before t0, or an old value that a
// later sample of the same step overwrites.  The arithmetic of each sample
// is unchanged, so a step gives the walk's bits.  dep is taken from the
// same float32 prev/next the arithmetic uses, never from an idealised
// delay, so rounding cannot let a sample read a slot its step writes.
// dep <= d, so a step never writes a slot twice.  On the path's data most
// rows take 32 samples a step (a chorus keeps hundreds of samples of delay;
// a phaser row has delay 0, so dep = d - 1 or d); flanger rows whose delay
// sweeps near 0 take short steps there (PERF.md).
//
// The block (flanger_step_kernel, 4 warps, one SM each of the 32 rows of
// the path) for one row:
//   warp 0, the walker: lanes j < s of a step read buf[prev], buf[next],
//     form interp and write buf[(w + j) mod d] and interp; all lanes load
//     the next step's inputs and its length meanwhile.  It touches only
//     shared memory, by addresses it keeps in registers; its loop body has
//     about 46 instructions and no branch but its back edge.
//   warps 1-3, the producers (one per remaining scheduler): each stages
//     whole chunks of kFlChunk samples into a ring of kFlRing chunks, a
//     float4 record a sample (x, frac, &buf[prev], &buf[next]) and the
//     length s(t) of a step that starts at the sample (the first j with
//     dep(t + j) <= j, from ballots over the chunk and the next 32 samples;
//     32 for a whole chunk at once where no dep is below 32), from
//     coalesced loads of x and the delay.  So the walker's chain from one
//     step start to the next is one shared load, not a ballot and a bit
//     scan.  Before it restages a slot, a producer writes out the chunk the
//     walker has finished there (mix, clip, coalesced stores).
// mbarriers pass each chunk on: full (producer to walker) and walked
// (walker back to the producers).  The walker counts the times it found
// the next chunk not yet staged (stats).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/bench_torch_fx.py,
// PERF.md): the walker takes about 120-150 cycles a step, and at 32
// samples a step the producers fall behind it now and then.
constexpr int kFlChunk = 512;
constexpr int kFlRing = 8;
constexpr int kFlRingSamples = kFlChunk * kFlRing;  // a power of two
constexpr int kFlPerLane = kFlChunk / kWarp;
constexpr int kFlWarps = 4;  // the walker (warp 0) and kFlWarps - 1 producers
constexpr int kFlProducers = kFlWarps - 1;
constexpr int kFlThreads = kFlWarps * kWarp;

// Shared memory of flanger_step_kernel for a line of d samples: the ring
// (a float4 record and an int step length per sample), 2 x kFlRing
// mbarriers, the delay line and past it kWarp + 1 words where lanes
// outside a step store.
constexpr int flanger_step_smem(int d) {
  return kFlRingSamples * (16 + 4) + 2 * kFlRing * 8 + (d + kWarp + 1) * 4;
}

// Shared-memory accesses by 32-bit shared address: the walker keeps its
// addresses in registers (through generic pointers nvcc rebuilds them
// from a special register at each access).
__device__ __forceinline__ float lds32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ int lds32i(uint32_t a) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts32(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}

// read = mod((w - delay) + d, d), reduced as torch.remainder and jnp.mod
// reduce it (fmod, exact, then + d where negative), and its slots.  For an
// integer d it lies in [0, d): (w - delay) + d is a multiple of d's ulp, so
// fmod's negative results are at least an ulp below 0 and adding d stays
// below d.  A NaN delay reads slot 0 (float-to-int of NaN gives 0).
struct FlangerRead {
  int prev, next;
  float frac;
};

__device__ __forceinline__ float flanger_reduce(int w, float delay, float d_f) {
  float rp = __fadd_rn(__fsub_rn(static_cast<float>(w), delay), d_f);
  if (rp >= d_f && rp < 2.0f * d_f) {
    rp = __fsub_rn(rp, d_f);  // fmod's result there, exact (Sterbenz)
  } else if (!(rp >= 0.0f && rp < d_f)) {
    rp = fmodf(rp, d_f);
    if (rp < 0.0f) rp = __fadd_rn(rp, d_f);
  }
  return rp;
}

__device__ __forceinline__ FlangerRead flanger_read(int w, float delay, int d, float d_f) {
  const float rp = flanger_reduce(w, delay, d_f);
  const float pf = floorf(rp);
  FlangerRead r;
  r.prev = static_cast<int>(pf);
  r.next = r.prev + 1 == d ? 0 : r.prev + 1;
  r.frac = __fsub_rn(rp, pf);
  return r;
}

// The plain version's float32 operations, each rounded on its own (no
// contraction), so the walk and the steps give the same bits.
__device__ __forceinline__ float flanger_interp(float frac, float bp, float bn) {
  return __fadd_rn(__fmul_rn(frac, bn), __fmul_rn(__fsub_rn(1.0f, frac), bp));
}

__device__ __forceinline__ float flanger_mix(float xt, float interp, float depth, float mix) {
  const float wet = __fadd_rn(xt, __fmul_rn(depth, interp));
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, mix), xt), __fmul_rn(mix, wet));
  return fminf(fmaxf(y, -1.0f), 1.0f);
}

// The sequential walk, kept for the bench and the bit-identity check: one
// warp per recurrence stages kChunk samples, lane 0 walks them.
__global__ void __launch_bounds__(kWarp)
flanger_walk_kernel(const float* __restrict__ x, const float* __restrict__ delay,
                    const float* __restrict__ fb, const float* __restrict__ depth,
                    const float* __restrict__ mix, float* __restrict__ out, int t_len, int d) {
  extern __shared__ float smem[];
  float* buf = smem;        // [d] circular delay line
  float* xs = buf + d;      // [kChunk] staged x
  float* ds = xs + kChunk;  // [kChunk] staged delay
  float* os = ds + kChunk;  // [kChunk] outputs of the chunk

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
        const FlangerRead rd = flanger_read(w, ds[i], d, d_f);
        const float interp = flanger_interp(rd.frac, buf[rd.prev], buf[rd.next]);
        const float xt = xs[i];
        buf[w] = __fadd_rn(xt, __fmul_rn(fb_r, interp));
        os[i] = flanger_mix(xt, interp, depth_r, mix_r);
        w = w + 1 == d ? 0 : w + 1;
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += kWarp) out[base + t0 + i] = os[i];
    __syncwarp();
  }
}

// The samples a step starting at sample base + lane may run (1 .. 32),
// from dep of samples base + lane (here) and base + 32 + lane (next); a
// sample past the row has dep 0, so no step runs past the row.  The first
// j with dep(t + j) <= j ends the step: lane t reads bit t + j of the
// 64-sample mask of dep <= j.
__device__ __forceinline__ int flanger_step_from(int dep_here, int dep_next, int lane) {
  const int least = __reduce_min_sync(0xffffffffu, min(dep_here, dep_next));
  if (least >= kWarp) return kWarp;
  int s = kWarp;
  for (int j = kWarp - 1; j >= least; --j) {  // no j below the least dep ends a step
    const unsigned lo = __ballot_sync(0xffffffffu, dep_here <= j);
    const unsigned hi = __ballot_sync(0xffffffffu, dep_next <= j);
    const unsigned long long win = static_cast<unsigned long long>(hi) << 32 | lo;
    if ((win >> (lane + j)) & 1) s = j;
  }
  return s;
}

__global__ void __launch_bounds__(kFlThreads, 1)
flanger_step_kernel(const float* __restrict__ x, const float* __restrict__ delay,
                    const float* __restrict__ fb, const float* __restrict__ depth,
                    const float* __restrict__ mix, float* __restrict__ out,
                    int* __restrict__ stats, int t_len, int d, int fixed) {
  // ring: per sample {x, frac (interp once walked), &buf[prev], &buf[next]}
  extern __shared__ float4 fl_smem[];
  float4* ring = fl_smem;                                           // [kFlRingSamples]
  int* step_len = reinterpret_cast<int*>(ring + kFlRingSamples);    // [kFlRingSamples]
  uint64_t* bars = reinterpret_cast<uint64_t*>(step_len + kFlRingSamples);
  float* buf = reinterpret_cast<float*>(bars + 2 * kFlRing);        // [d + kWarp + 1]
  const uint32_t full0 = hopper::smem_u32(bars);
  const uint32_t walked0 = full0 + 8 * kFlRing;
  const uint32_t buf_a = hopper::smem_u32(buf);

  const int r = blockIdx.x;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const size_t base = static_cast<size_t>(r) * t_len;
  const int n_chunks = (t_len + kFlChunk - 1) / kFlChunk;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kFlRing; ++i) hopper::mbar_init(full0 + 8 * i, kWarp);
    hopper::fence_barrier_init();
  }
  for (int i = threadIdx.x; i < d; i += kFlThreads) buf[i] = 0.0f;
  __syncthreads();

  if (warp == 0) {
    // The steps run in stretches between checkpoints.  At a checkpoint the
    // walker hands the chunks it has finished back to the producers and
    // takes the chunks they have staged (waiting only for what the next
    // step reads).  Within a stretch every sample a step reads is staged,
    // and the loop body has no branch but its back edge.  Two chains run
    // through it: the step starts (t, then the step length staged at t)
    // and the delay line (read, four float32 operations, write).
    const float fb_r = fb[r];
    const uint32_t ring_a = hopper::smem_u32(ring), len_a = hopper::smem_u32(step_len);
    const uint32_t buf_end = buf_a + 4 * d;
    const uint32_t sink = buf_end + 4 * lane;  // where lanes outside a step store
    int t = 0, steps = 0, waits = 0;
    int staged = 0;  // samples [0, staged) are in the ring
    int handed = 0;  // chunks handed back to the producers
    auto take_chunk = [&](bool wait) {
      const int c = staged / kFlChunk;
      const uint32_t bar = full0 + 8 * (c % kFlRing);
      const uint32_t parity = (c / kFlRing) & 1;
      if (!hopper::mbar_test(bar, parity)) {
        if (!wait) return false;
        ++waits;
        hopper::mbar_wait(bar, parity);
      }
      staged = min(staged + kFlChunk, t_len);
      return true;
    };
    auto record = [&](int t0) { return ring_a + 16 * ((t0 + lane) & (kFlRingSamples - 1)); };
    // lane j's record for the step at t0, inside the line past the row
    auto inputs = [&](int t0, uint32_t at) {
      float4 v = lds128(at);
      if (t0 + lane >= t_len) v.z = v.w = __uint_as_float(buf_a);
      return v;
    };
    auto step_at = [&](int t0) {
      const int s_t = lds32i(len_a + 4 * (t0 & (kFlRingSamples - 1)));
      return fixed > 0 ? min(fixed, t_len - t0) : s_t;
    };
    while (staged < min(kWarp, t_len)) take_chunk(true);
    uint32_t cur_a = record(0);
    float4 cur = inputs(0, cur_a);
    int s = step_at(0);
    uint32_t wa = buf_a + 4 * (lane % d);  // &buf[(t + lane) mod d]
    while (t < t_len) {
      while (handed < n_chunks && min((handed + 1) * kFlChunk, t_len) <= t) {
        hopper::mbar_arrive(walked0 + 8 * (handed % kFlRing));
        ++handed;
      }
      while (staged < min(t + 3 * kWarp, t_len)) take_chunk(true);
      while (staged < t_len && take_chunk(false)) {
      }
      // t + s + 32 <= staged whenever t < end: the next step's inputs are staged
      const int end = staged == t_len ? t_len : staged - 2 * kWarp;
      do {
        const int tn = t + s;
        const uint32_t nxt_a = record(tn);
        const float4 nxt = inputs(tn, nxt_a);
        const int s_next = step_at(tn);
        const float interp = flanger_interp(cur.y, lds32(__float_as_uint(cur.z)),
                                            lds32(__float_as_uint(cur.w)));
        const float val = __fadd_rn(cur.x, __fmul_rn(fb_r, interp));
        const bool in_step = lane < s;
        __syncwarp();  // every read of the step before any write
        sts32(in_step ? wa : sink, val);
        sts32((in_step ? cur_a : sink) + 4, interp);  // the record's frac becomes its interp
        __syncwarp();
        ++steps;
        wa += 4 * s;
        if (wa >= buf_end) wa -= 4 * d;
        t = tn;
        s = s_next;
        cur = nxt;
        cur_a = nxt_a;
      } while (t < end);
    }
    while (handed < n_chunks) {
      hopper::mbar_arrive(walked0 + 8 * (handed % kFlRing));
      ++handed;
    }
    if (stats != nullptr && lane == 0) {
      stats[2 * r] = steps;
      stats[2 * r + 1] = waits;
    }
  } else {
    // Producer p stages chunks p, p + kFlProducers, ...  The slot of chunk
    // c held chunk c - kFlRing: once the walker has handed that chunk on,
    // the producer first writes it out (mix, clip, coalesced stores), then
    // stages chunk c.  Its loads of chunk c are in flight meanwhile.  The
    // last kFlRing chunks are written out by the producers whose turn
    // would have come next.
    const int p = warp - 1;
    const float d_f = static_cast<float>(d);
    const float depth_r = depth[r], mix_r = mix[r];
    const int stride_w = kWarp % d;  // w advances by this from one of a lane's samples to the next
    for (int c = p; c < n_chunks + kFlRing; c += kFlProducers) {
      const int slot = c % kFlRing;
      const int c0 = c * kFlChunk;
      // the chunk's samples and the next kWarp, whose dep the chunk's last
      // steps need
      float xv[kFlPerLane], dv[kFlPerLane + 1];
#pragma unroll
      for (int k = 0; k <= kFlPerLane; ++k) {
        const int u = c0 + k * kWarp + lane;
        if (k < kFlPerLane) xv[k] = u < t_len ? x[base + u] : 0.0f;
        dv[k] = u < t_len ? delay[base + u] : 0.0f;
      }
      if (c >= kFlRing) {  // write out chunk c - kFlRing
        hopper::mbar_wait(walked0 + 8 * slot, ((c / kFlRing) & 1) ^ 1);
        const int e0 = c0 - kFlRing * kFlChunk;
#pragma unroll
        for (int k = 0; k < kFlPerLane; ++k) {
          const int i = k * kWarp + lane;
          const float2 v = *reinterpret_cast<const float2*>(ring + slot * kFlChunk + i);
          if (e0 + i < t_len) out[base + e0 + i] = flanger_mix(v.x, v.y, depth_r, mix_r);
        }
      }
      if (c >= n_chunks) continue;
      // read positions, with fmod's result taken where (w - delay) + d lies
      // in [0, 2d) (the path's delays) and fmod itself elsewhere
      float rp[kFlPerLane + 1];
      int wk[kFlPerLane + 1];
      bool off = false;
      int w = (c0 + lane) % d;
#pragma unroll
      for (int k = 0; k <= kFlPerLane; ++k) {
        wk[k] = w;
        const float a = __fadd_rn(__fsub_rn(static_cast<float>(w), dv[k]), d_f);
        rp[k] = a >= d_f ? __fsub_rn(a, d_f) : a;
        off |= !(rp[k] >= 0.0f && rp[k] < d_f);
        w += stride_w;
        if (w >= d) w -= d;
      }
      if (__any_sync(0xffffffffu, off)) {
#pragma unroll
        for (int k = 0; k <= kFlPerLane; ++k) rp[k] = flanger_reduce(wk[k], dv[k], d_f);
      }
      float fr[kFlPerLane];
      uint32_t pa[kFlPerLane], na[kFlPerLane];
      int dep[kFlPerLane + 1];
      int least = kWarp;
#pragma unroll
      for (int k = 0; k <= kFlPerLane; ++k) {
        const float pf = floorf(rp[k]);
        const int prev = static_cast<int>(pf);
        const int next = prev + 1 == d ? 0 : prev + 1;
        int ap = wk[k] - prev, an = wk[k] - next;  // the slots' ages
        if (ap <= 0) ap += d;
        if (an <= 0) an += d;
        dep[k] = c0 + k * kWarp + lane < t_len ? min(min(ap, an), kWarp) : 0;
        least = min(least, dep[k]);
        if (k < kFlPerLane) {
          fr[k] = __fsub_rn(rp[k], pf);
          pa[k] = buf_a + 4 * prev;
          na[k] = buf_a + 4 * next;
        }
      }
      const bool all_whole = __reduce_min_sync(0xffffffffu, least) >= kWarp;
#pragma unroll
      for (int k = 0; k < kFlPerLane; ++k) {
        const int at = slot * kFlChunk + k * kWarp + lane;
        ring[at] = make_float4(xv[k], fr[k], __uint_as_float(pa[k]), __uint_as_float(na[k]));
        step_len[at] = all_whole ? kWarp : flanger_step_from(dep[k], dep[k + 1], lane);
      }
      hopper::mbar_arrive(full0 + 8 * slot);
    }
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

// Shared memory K1's stepped kernel needs for a delay line of d samples
// (the walk needs less).
int flanger_smem_bytes(int d) { return flanger_step_smem(d); }

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

// x, delay, out: (n, t) float32, contiguous; fb, depth, mix: (n,) float32;
// 2 <= d, flanger_smem_bytes(d) within a block's shared memory.  walk != 0:
// the sequential walk.  Else the stepped kernel; stats (or null): (n, 2)
// int32, per row the steps taken and the times the walker found the next
// chunk not yet staged; fixed (bench only; 0 < fixed <= min(32, d)): every
// step runs fixed samples whatever the delay allows, which times the
// staging apart from the steps and leaves the output wrong.
int flanger_forward(const float* x, const float* delay, const float* fb,
                    const float* depth, const float* mix, float* out, int* stats, int n,
                    int t, int d, int walk, int fixed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 2 || d > 0xffff || fixed < 0 || fixed > kWarp || fixed > d)
    return static_cast<int>(cudaErrorInvalidValue);
  if (walk) {
    const int smem = (d + 3 * kChunk) * static_cast<int>(sizeof(float));
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(flanger_walk_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    flanger_walk_kernel<<<n, kWarp, smem, s>>>(x, delay, fb, depth, mix, out, t, d);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = flanger_step_smem(d);
  cudaError_t e = cudaFuncSetAttribute(flanger_step_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flanger_step_kernel<<<n, kFlThreads, smem, s>>>(x, delay, fb, depth, mix, out, stats, t, d,
                                                  fixed);
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
