// The conditional LSTM effect model for Hopper (sm_90a): the no-gradient
// forward (K3), the training forward that also saves every step's (h, c) and
// gate activations (K4) and the reverse-time backward (K5).  Plain C
// interface, loaded with ctypes by mod_extraction_tpu_torch/ops/lstm_kernels.py.
//
// K3 replaces mod_extraction_tpu/ops/pallas_lstm.py::_lstm_kernel
// (lstm_effect_model_pallas), K4 ::_lstm_fwd_train_kernel (_train_fwd_impl)
// and K5 ::_lstm_bwd_kernel (_lstm_train_bwd).
//
// Per batch row and step t (gate order i, f, g, o as torch's):
//   gates = W_ih^T [latent; x]_t + W_hh^T h + b      (4H)
//   c = sig(f) c + sig(i) tanh(g);  h = sig(o) tanh(c)
//   y_t = tanh(fc_k^T h + fc_b + x_t)
// Layouts (row-major): seq (B, in_dim, T) = [latent; x], x residual
// (B, out_ch, T), h0/c0 (B, H), w_ih (in_dim, 4H), w_hh (H, 4H), b (4H),
// fc_k (H, out_ch), fc_b (out_ch), y (B, out_ch, T), saved hs/cs (B, T, H),
// saved gate activations (B, T, 4H): sig(i), sig(f), tanh(g), sig(o).
//
// What bounds them on the H100 (NVIDIA H100 80GB HBM3, 700 W, 1980 MHz under
// load; scripts/bench_torch_lstm.py at the TBPTT path's shape B 32, T 1024,
// H 64).  A launch does 1.1 GFLOP (K3/K4) or 2.3 GFLOP (K5) of float32 work
// (0.017 / 0.034 ms at 67 TFLOP/s) and moves at most 51 / 59 MB (0.015 /
// 0.018 ms), but every step depends on the one before, and the batch gives
// only 32 independent recurrences, one block each on 32 of the 132 SMs.  The
// walks run for T times one step, and a step is bound by how fast one block
// can start and finish its instructions, not by the card's rates: the 8
// warps of a block sit two to a scheduler and run the same dependent chain
// in step, so what one waits for, the other waits for too.  A forward step is about
// 120 instructions a warp (64 multiply-adds, 4 16-byte shared loads, 7
// shuffles, 4 special-function instructions, one barrier) and takes 540
// cycles without the saves (K3 0.28 ms; 22.7 ms over 86016 steps) and 615
// with them (K4 0.32 ms); a backward step is about 110 instructions (65
// multiply-adds, 4 16-byte and 5 4-byte shared loads, 5 shuffles in four
// dependent stages, one barrier) and takes 600 cycles (walk 0.31 ms), of
// which about 100 are the per-chunk pass that forms the step's coefficients.
// K5 as a whole is 0.41 ms: walk 0.31, partial sums 0.052, dseq 0.016, final
// sum 0.004.  The floor of this design is 128 cycles a step, the 16384
// multiply-adds of a step at an SM's 128 a cycle; below that a row would
// have to be split over several SMs (a cluster with distributed shared
// memory).  torch.nn.LSTM (cuDNN, no fc head) takes 0.54 ms forward and
// 1.5-2.0 ms forward + backward at the same shape.
//
// Which kernels (ops/lstm_kernels.py::forward_plan / backward_plan pick;
// lstm_forward / lstm_backward launch that plan or refuse it):
// H 16, 32 and 64 take the fast walks below (W_hh in registers, one barrier
// a step, activations by ex2.approx / rcp.approx).  H 160, the shipped
// chorus model's width, takes the cluster kernels for K3, K4 and K5's walk:
// 4 H^2 = 102,400 weights (400 KB) fit neither one SM's registers (640
// threads x 160 weights) nor its shared memory, so each batch row is split
// over a thread-block cluster of 4 or 8 CTAs that keep W_hh in their
// registers and trade h (lstm_fwd_cluster_kernel) or the partial sums of
// W_hh dgates (lstm_bwd_cluster_kernel) through distributed shared memory.
// Every other H <= 256 takes the generic walks (one thread per gate column,
// W_hh in shared memory up to H 64-odd and through L2 above, libm
// activations, two barriers a step forward and three backward: 1.2 / 1.5 ms
// for K4 / K5 at H 64).  At H 160 (same card, same script with --hidden
// 160): the generic K3 11.37 / K4 4.80 / K5 8.05 ms at B 32, T 1024; the
// cluster kernels K3 0.81 / K4 0.88 / K5 1.34-1.37 ms there (4 CTAs for 2
// rows, 16 clusters: the card holds 30 clusters of 4, and 15 of 8 of the
// forward, so one row a cluster would take two or three waves at B 32),
// 1520-1710 cycles a forward step and 1900-1960 a backward one (K5's walk
// 0.98-1.01 ms of it; the partial sums 0.27); at B 2 and 3 (T 1024) K5
// 0.57-0.58 ms on 8 CTAs a row (walk 0.49, 942-952 cycles a step) against
// 1.07 on 4 x 2; at the serving shape (2, T) K3 0.0693 / 0.2542 / 0.9949
// ms at T 128 / 512 / 2048 (8 CTAs a row, about 970 cycles a step, against
// the multiply-adds' 100), where torch.nn.LSTM(2, 160) takes 0.63 / 2.32 /
// 9.09.
// A step is latency: 8 CTAs a row instead of 4 halve the multiply-adds and
// save 9%, while a second row on the cluster adds 500 cycles to 1060.
// torch.nn.LSTM(2, 160) takes 19-25 ms forward + backward at (32, 1024)
// and 19-24 its backward alone, from call to call.
//
// Registers and spills (ptxas -v for sm_90a), fast walks at
// H 64 / 32 / 16: forward without saves (in_dim 2) 120 / 64 / 72, with saves
// 160 / 72 / 96, in_dim read at run time 126-169; backward 128 / 116 / 95;
// no spills but 8-12 bytes in the H 32 forward with saves.  Cluster forward
// (in_dim 2, without / with saves): 8 CTAs x 1 row 119 / 118, 4 x 2 138 /
// 142; in_dim read at run time 123-167.  Cluster backward walk: 8 x 1 96,
// 4 x 2 144 (30 clusters of either shape fit the card at once).  Generic
// forward 58-64, backward 32; partial sums 43 / 76 / 106 / 124 / 128 for
// kAIt 1 .. 5; dseq 64.  No kernel spills otherwise.
//
// What was tried and lost, same card and script: every thread one gate
// column and all 64 rows of W_hh (16 16-byte broadcast loads a step, no
// exchange of partial sums): K4 0.52 ms, K5's walk 0.58 ms; shared memory
// through ordinary pointers (the compiler re-derives the shared window's
// base, a special-register read, in front of the step's stores, and branches
// around them): K3 0.36-0.40 ms; the saved tensors stored to device memory
// in the step instead of at the chunk's end: K4 0.43 ms; the backward step's
// coefficients formed in the step (two special functions and four shuffles
// on every warp's in-order stream): walk 0.34-0.35 ms; dseq formed inside the
// walk at the chunk's end: walk 0.37 ms against 0.31 + 0.016 apart.  In a
// one-off build with libm activations in the fast walks K3 took 0.33 and K4
// 0.36 ms, and the K4/K5 pair's gradients at the shipped weights were 1.0e-5
// of the leaf's largest magnitude from the plain version's against 1.7e-5
// with the fast ones: the order of the sums, not the activations, is most
// of that distance.  K5's cluster walk on 8 CTAs for two rows (two CTAs an
// SM, B 32 in one wave) was no faster than on 4 CTAs for two at B 32: a
// second row costs the walk about as much at 8 CTAs as at 4.
//
// The weight gradients: the TPU kernel accumulates them in resident output
// blocks across its sequential grid; blocks on the card run in parallel, so
// the walk writes the gate cotangents (B, T, 4H) and two more kernels reduce
// them in a fixed order (per-slice partial sums, then the sum of the
// slices): dW_hh, dW_ih and db are the same bits from run to run, with no
// float atomics.  The partial sums keep a register tile per thread (4 gate
// columns x 4 rows of A = [h_{t-1} | seq_t | 1], kAIt such tiles a thread,
// chosen for the launch's H), float32 multiply-adds, operand tiles brought a
// pass ahead with cp.async.  A last kernel forms dseq = W_ih dgates.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxIn = 16;          // in_dim = latent_dim + in_ch
constexpr int kMaxHidden = 256;     // 4H threads per block
constexpr int kFwdChunk = 64;       // forward steps staged per pass
constexpr int kBwdChunk = 32;       // backward steps staged per pass
constexpr int kMaxSmem = 232448;    // a block's shared memory on sm_90
constexpr int kColTile = 64;        // wgrad: gate columns per block (16 threads x 4)
constexpr int kRowTile = 32;        // wgrad: rows staged per pass
constexpr int kMaxAIt = 5;          // wgrad: 4-row groups of A per thread, at most
constexpr int kClusterHidden = 160; // the width of the cluster forward

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// The fast walks' activations, two special-function instructions each:
// 1 / (1 + 2^z) through ex2.approx and rcp.approx (absolute error near 1e-7;
// a denormal 2^z is flushed to zero, which 1 + 2^z rounds away anyway).
//   sigmoid(x) = rcp_1p_exp2(-log2(e) x),  tanh(x) = 2 rcp_1p_exp2(-2 log2(e) x) - 1
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float rcp_1p_exp2(float z) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(z));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return r;
}
__device__ __forceinline__ float tanh_fast(float x) {
  return fmaf(2.0f, rcp_1p_exp2(-2.0f * kLog2e * x), -1.0f);
}

// Shared memory by 32-bit address: the walks compute their addresses once,
// outside the step loop.  The empty asm keeps the compiler from forming the
// address anew (a special-register read and three more instructions) in
// front of every access.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("" : "+r"(a));
  return a;
}
__device__ __forceinline__ float lds32(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ float4 lds128(unsigned a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void sts32(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}
// a predicated store: no branch, no reconvergence point in the step
__device__ __forceinline__ void sts32_if(bool on, unsigned a, float v) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p st.shared.f32 [%0], %1;\n}" ::"r"(a),
      "f"(v), "r"(static_cast<int>(on))
      : "memory");
}

__device__ __forceinline__ float2 lds64(unsigned a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(a) : "memory");
  return v;
}

// Thread-block clusters: this CTA's rank, the cluster's index, the address
// of a shared-memory location in CTA `rank` (distributed shared memory), and
// the cluster-wide barrier in its two halves.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned mapa(unsigned a, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// How the CTAs of a cluster meet each step: each CTA's mbarriers, told to
// expect a step's bytes, and st.async, which stores into a peer's shared
// memory and counts the bytes on that peer's mbarrier once they have landed.
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait_cluster(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void st_async_if(bool on, unsigned a, float v, unsigned bar) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
      " @p st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n}" ::"r"(a),
      "r"(__float_as_uint(v)), "r"(bar), "r"(static_cast<int>(on))
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// K3 / K4, fast path (H in {16, 32, 64}): W_hh in registers, one barrier a step
// ---------------------------------------------------------------------------
// The four threads 4u .. 4u + 3 own hidden unit u.  Lane q of them keeps, for
// all four gate columns of the unit, the rows k of W_hh that lie in the
// float4s 4i + q of h: H weights in registers for the whole walk.  A step
// reads those H / 16 float4s of h (double-buffered in shared memory; the four
// lanes read neighbouring 16 bytes), forms four partial sums, and a two-stage
// exchange by shuffle leaves lane q with the whole pre-activation of gate q.
// The lanes exchange their activations, each computes c and h (c stays in a
// register in all four), and a step ends in one barrier.  kIn > 0 fixes
// in_dim at compile time.  The inputs of the next chunk arrive by cp.async
// while this chunk is walked.
template <int H, bool kSave, int kIn>
__global__ void __launch_bounds__(4 * H) lstm_fwd_fast_kernel(
    const float* __restrict__ seq, const float* __restrict__ xres,
    const float* __restrict__ h0, const float* __restrict__ c0,
    const float* __restrict__ w_ih, const float* __restrict__ w_hh,
    const float* __restrict__ bias, const float* __restrict__ fc_k,
    const float* __restrict__ fc_b, float* __restrict__ y,
    float* __restrict__ hn, float* __restrict__ cn,
    float* __restrict__ hs, float* __restrict__ cs, float* __restrict__ gates,
    int t_len, int in_dim_arg, int out_ch) {
  extern __shared__ float4 smem4[];
  constexpr int G4 = 4 * H;
  constexpr int kV = H / 16;      // float4s of h a lane reads a step
  constexpr int kRingLd = H + 4;  // the head's four lanes a step read four banks apart
  constexpr int kGq = H + 8;      // gate block pitch of a saved row: the lanes of a warp hit 32 banks
  constexpr int kGLd = 4 * kGq;
  constexpr int kW = kIn > 0 ? kIn : kMaxIn;
  constexpr unsigned kFull = 0xffffffffu;
  const int in_dim = kIn > 0 ? kIn : in_dim_arg;
  const int j = threadIdx.x;
  const int u = j >> 2, q = j & 3;
  const int col = q * H + u;  // the gate column whose activation this lane forms
  const int b = blockIdx.x;
  float* h_s = reinterpret_cast<float*>(smem4);  // [2][H]
  float* ring = h_s + 2 * H;                      // [kFwdChunk][kRingLd]: the chunk's h
  float* cring = ring + kFwdChunk * kRingLd;      // kSave: the chunk's c, as ring
  float* gring = cring + (kSave ? kFwdChunk * kRingLd : 0);  // kSave: [kFwdChunk][kGLd] activations
  float* seq_s = gring + (kSave ? kFwdChunk * kGLd : 0);     // [2][in_dim][kFwdChunk]
  float* x_s = seq_s + 2 * in_dim * kFwdChunk;    // [2][out_ch][kFwdChunk]

  float w[4][4 * kV];  // [gate][4 i + e] = W_hh[4 (4 i + q) + e, gate H + u]
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int i = 0; i < kV; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) w[g][4 * i + e] = w_hh[(4 * (4 * i + q) + e) * G4 + g * H + u];
    }
  }
  float wih[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) wih[i] = i < in_dim ? w_ih[i * G4 + col] : 0.0f;
  const float bj = bias[col];
  // act = s / (1 + 2^(sl a)) + o: the sigmoid, or tanh for gate g
  const float s = q == 2 ? 2.0f : 1.0f;
  const float sl = -kLog2e * s;
  const float o = q == 2 ? -1.0f : 0.0f;
  const int quad = (j & 31) & ~3;
  const bool odd = (q & 1) != 0, high = (q & 2) != 0;
  float c = c0[b * H + u];
  float h = h0[b * H + u];
  if (q == 0) h_s[u] = h;

  auto stage = [&](int t0, int buf) {
    const int n = min(kFwdChunk, t_len - t0);
    float* sd = seq_s + buf * in_dim * kFwdChunk;
    for (int i = j; i < in_dim * kFwdChunk; i += G4) {
      const int ch = i / kFwdChunk, tt = i - ch * kFwdChunk;
      if (tt < n) {
        cp_async4(sd + i, seq + (static_cast<size_t>(b) * in_dim + ch) * t_len + t0 + tt);
      } else {
        sd[i] = 0.0f;
      }
    }
    float* xd = x_s + buf * out_ch * kFwdChunk;
    for (int i = j; i < out_ch * kFwdChunk; i += G4) {
      const int ch = i / kFwdChunk, tt = i - ch * kFwdChunk;
      if (tt < n) {
        cp_async4(xd + i, xres + (static_cast<size_t>(b) * out_ch + ch) * t_len + t0 + tt);
      } else {
        xd[i] = 0.0f;
      }
    }
    cp_async_commit();
  };

  stage(0, 0);
  cp_async_wait_all();
  __syncthreads();
  // byte addresses in shared memory of what the step loop touches
  const unsigned h_rd = smem_addr(h_s) + 16 * q;  // this lane's float4s of h, buffer 0
  const unsigned h_wr = smem_addr(h_s) + 4 * u;   // this unit's h, buffer 0
  const unsigned ring_wr = smem_addr(ring) + 4 * u;
  const unsigned cring_wr = smem_addr(cring) + 4 * u;
  const unsigned gring_wr = smem_addr(gring) + 4 * (q * kGq + u);
  const unsigned seq_rd = smem_addr(seq_s);
  unsigned cur = 0;  // byte offset of the h_s buffer holding h_{t-1}: 0 or 4 H
  int sb = 0;        // staging buffer of this chunk
  for (int t0 = 0; t0 < t_len; t0 += kFwdChunk, sb ^= 1) {
    const int n = min(kFwdChunk, t_len - t0);
    if (t0 + kFwdChunk < t_len) stage(t0 + kFwdChunk, sb ^ 1);
    const unsigned sq = seq_rd + 4 * sb * in_dim * kFwdChunk;
    auto input_proj = [&](int tt) {
      float a = bj;
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        if (kIn > 0 || i < in_dim) a = fmaf(wih[i], lds32(sq + 4 * (i * kFwdChunk + tt)), a);
      }
      return a;
    };
    float ax = input_proj(0);
    for (int tt = 0; tt < n; ++tt) {
      float4 hv[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) hv[i] = lds128(h_rd + cur + 64 * i);
      float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;  // gates i, f, g, o over this lane's k
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const float4 v = hv[i];
        const float ve[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p0 = fmaf(w[0][4 * i + e], ve[e], p0);
          p1 = fmaf(w[1][4 * i + e], ve[e], p1);
          p2 = fmaf(w[2][4 * i + e], ve[e], p2);
          p3 = fmaf(w[3][4 * i + e], ve[e], p3);
        }
      }
      // lane q ends with gate q: first the lanes q ^ 1 trade the gates of the
      // other parity, then the lanes q ^ 2 the other half
      float k0 = odd ? p1 : p0, k1 = odd ? p3 : p2;
      k0 += __shfl_xor_sync(kFull, odd ? p0 : p1, 1);
      k1 += __shfl_xor_sync(kFull, odd ? p2 : p3, 1);
      float a = high ? k1 : k0;
      a += __shfl_xor_sync(kFull, high ? k0 : k1, 2);
      a += ax;
      ax = input_proj(min(tt + 1, kFwdChunk - 1));  // off the recurrence's chain
      const float act = fmaf(s, rcp_1p_exp2(sl * a), o);
      const float gi = __shfl_sync(kFull, act, quad + 0);
      const float gf = __shfl_sync(kFull, act, quad + 1);
      const float gg = __shfl_sync(kFull, act, quad + 2);
      const float go = __shfl_sync(kFull, act, quad + 3);
      c = fmaf(gf, c, gi * gg);
      h = go * tanh_fast(c);
      cur ^= 4 * H;
      sts32_if(q == 0, h_wr + cur, h);
      sts32_if(q == 0, ring_wr + 4 * kRingLd * tt, h);
      if (kSave) {  // kept for the chunk's end, off the step's path
        sts32(gring_wr + 4 * kGLd * tt, act);
        sts32_if(q == 1, cring_wr + 4 * kRingLd * tt, c);
      }
      __syncthreads();
    }
    if (kSave) {  // the chunk's h, c and activations, 16 bytes a store
      const size_t row = static_cast<size_t>(b) * t_len + t0;
      for (int i = j; i < n * (H / 4); i += G4) {
        const int tt = i / (H / 4), r = i - tt * (H / 4);
        reinterpret_cast<float4*>(hs + (row + tt) * H)[r] =
            *reinterpret_cast<const float4*>(ring + tt * kRingLd + 4 * r);
        reinterpret_cast<float4*>(cs + (row + tt) * H)[r] =
            *reinterpret_cast<const float4*>(cring + tt * kRingLd + 4 * r);
      }
      for (int i = j; i < n * H; i += G4) {
        const int tt = i / H, p = i - tt * H;
        const int qq = p / (H / 4), r = p - qq * (H / 4);
        reinterpret_cast<float4*>(gates + (row + tt) * G4)[p] =
            *reinterpret_cast<const float4*>(gring + tt * kGLd + qq * kGq + 4 * r);
      }
    }
    // fc head + residual + tanh for the chunk's steps, four lanes an output
    const float* xq = x_s + sb * out_ch * kFwdChunk;
    const int total = out_ch * n;
    for (int p0 = 0; p0 < total; p0 += H) {
      const int p = min(p0 + u, total - 1);
      const int oc = p / n, tt = p - oc * n;
      float z = 0.0f;
      for (int kk = q; kk < H; kk += 4) z = fmaf(ring[tt * kRingLd + kk], fc_k[kk * out_ch + oc], z);
      z += __shfl_xor_sync(kFull, z, 1);
      z += __shfl_xor_sync(kFull, z, 2);
      if (q == 0 && p0 + u < total) {
        y[(static_cast<size_t>(b) * out_ch + oc) * t_len + t0 + tt] =
            tanhf(z + fc_b[oc] + xq[oc * kFwdChunk + tt]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  if (q == 0) {
    hn[b * H + u] = h;
    cn[b * H + u] = c;
  }
}

// ---------------------------------------------------------------------------
// K3 / K4 at H 160: one thread-block cluster of N CTAs for R batch rows,
// W_hh split over the cluster
// ---------------------------------------------------------------------------
// CTA r of a cluster owns the U = H / N hidden units r U .. r U + U - 1 of
// its R rows, with all four of their gate columns, so c and the activations
// stay local.  The L = 2 N lanes of a unit keep in registers, for its four
// columns, the rows k of W_hh that lie in the vectors l + L i (kVec floats
// each) of h: 4 H / L weights a lane (80 at N 4, 40 at N 8; 400 KB a
// cluster, which neither one SM's registers nor its shared memory hold),
// used for each of the R rows.  A step reads h_{t-1} of each row from this
// CTA's ring (all lanes of a warp read the same 128 bytes), forms four
// partial sums, and a shuffle exchange (the fast kernel's two stages, then
// xor-adds over the lanes 4, 8 apart) leaves every lane with the whole
// pre-activation of gate l & 3.  c and h follow as there; lane l < N sends
// the unit's h into CTA l's ring by st.async (distributed shared memory),
// which counts its 4 bytes on CTA l's mbarrier of the step's parity, and
// each CTA waits until that barrier has the step's R x 4 H bytes (a phase a
// step; one thread re-arms it for step t + 2).  The cluster barrier in its
// place (release/acquire, every CTA waiting for every other) took twice as
// long a step (1950 against 970 cycles at N 8, B 2).  The ring holds two
// chunks of kChunk steps of each row's whole h in every CTA: step t writes
// slot t and reads slot t - 1, and a chunk's fc head reads its half while
// the next chunk fills the other.  No warp can be more than one step ahead
// of any other in the cluster (a step needs every unit's h of the step
// before), so no slot is written while it may still be read, and no
// barrier's phase is reached twice ahead of its waiters.  The head's
// outputs are spread over the cluster's H unit groups, L lanes an output.
// R > 1 puts more rows on a cluster where one cluster a row would take a
// second wave (the H100 holds 30 clusters of 4, and B 32 is the TBPTT
// batch); a row past the batch (odd B) walks the last row again and writes
// nothing.
template <int H, int N, int R, bool kSave, int kIn>
__global__ void __launch_bounds__(2 * H, 1) lstm_fwd_cluster_kernel(
    const float* __restrict__ seq, const float* __restrict__ xres,
    const float* __restrict__ h0, const float* __restrict__ c0,
    const float* __restrict__ w_ih, const float* __restrict__ w_hh,
    const float* __restrict__ bias, const float* __restrict__ fc_k,
    const float* __restrict__ fc_b, float* __restrict__ y,
    float* __restrict__ hn, float* __restrict__ cn,
    float* __restrict__ hs, float* __restrict__ cs, float* __restrict__ gates,
    int batch, int t_len, int in_dim_arg, int out_ch) {
  extern __shared__ float4 smem4[];
  __shared__ alignas(8) unsigned long long bars[2];  // steps t with t & 1 = 0, 1
  constexpr int G4 = 4 * H;
  constexpr int U = H / N;                        // units of this CTA
  constexpr int L = 2 * N;                        // lanes a unit
  constexpr int kThreads = U * L;                 // 2 H
  constexpr int kVec = (H / 4) % L == 0 ? 4 : 2;  // floats a load of h
  constexpr int kNv = H / (L * kVec);             // loads of h a lane a step
  constexpr int kK = kNv * kVec;                  // rows of W_hh a lane holds: H / L
  constexpr int kChunk = kFwdChunk / R;           // steps staged a pass: R rows' rings fit
  constexpr int kSlots = 2 * kChunk;
  constexpr int kRingLd = H + 4;
  constexpr int kGq = U + 4;  // gate block pitch of a saved row: the storing lanes hit distinct banks
  constexpr int kGLd = 4 * kGq;
  constexpr int kW = kIn > 0 ? kIn : kMaxIn;
  constexpr unsigned kFull = 0xffffffffu;
  static_assert(H % N == 0 && U % 4 == 0 && 32 % L == 0 && H % (L * kVec) == 0, "cluster split");
  static_assert((kSlots & (kSlots - 1)) == 0, "ring slots: a power of two");
  const int in_dim = kIn > 0 ? kIn : in_dim_arg;
  const int j = threadIdx.x;
  const int ul = j / L, l = j % L, q = l & 3;
  const int r = static_cast<int>(cluster_rank());
  const int u = r * U + ul;
  const int col = q * H + u;  // the gate column whose activation this lane forms
  // the batch rows of this cluster (past the batch: the last row again, not written)
  const int row0 = static_cast<int>(cluster_id()) * R;
  auto row_of = [&](int rr) { return min(row0 + rr, batch - 1); };
  auto valid = [&](int rr) { return row0 + rr < batch; };
  float* ring = reinterpret_cast<float*>(smem4);               // [R][kSlots][kRingLd]: h of every unit
  float* cring = ring + R * kSlots * kRingLd;                    // kSave: [R][kChunk][U] this CTA's c
  float* gring = cring + (kSave ? R * kChunk * U : 0);           // kSave: [R][kChunk][kGLd] activations
  float* seq_s = gring + (kSave ? R * kChunk * kGLd : 0);        // [2][R][in_dim][kChunk]
  float* x_s = seq_s + 2 * R * in_dim * kChunk;                  // [2][R][out_ch][kChunk]

  float w[4][kK];  // [gate][kVec i + e] = W_hh[kVec (l + L i) + e, gate H + u]
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int i = 0; i < kNv; ++i) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) w[g][kVec * i + e] = w_hh[(kVec * (l + L * i) + e) * G4 + g * H + u];
    }
  }
  float wih[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) wih[i] = i < in_dim ? w_ih[i * G4 + col] : 0.0f;
  const float bj = bias[col];
  // act = s / (1 + 2^(sl a)) + o: the sigmoid, or tanh for gate g
  const float s = q == 2 ? 2.0f : 1.0f;
  const float sl = -kLog2e * s;
  const float o = q == 2 ? -1.0f : 0.0f;
  const int quad = (j & 31) & ~3;
  const bool odd = (q & 1) != 0, high = (q & 2) != 0;
  float c[R], h[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    c[rr] = c0[row_of(rr) * H + u];
    h[rr] = h0[row_of(rr) * H + u];
    // h_{-1} = h0 in the slot before step 0, the whole row in every CTA
    for (int i = j; i < H; i += kThreads) {
      ring[(rr * kSlots + kSlots - 1) * kRingLd + i] = h0[row_of(rr) * H + i];
    }
  }

  auto stage = [&](int t0, int buf) {
    const int n = min(kChunk, t_len - t0);
    float* sd = seq_s + buf * R * in_dim * kChunk;
    for (int i = j; i < R * in_dim * kChunk; i += kThreads) {
      const int rc = i / kChunk, tt = i - rc * kChunk;  // rc = rr in_dim + ch
      const int rr = rc / in_dim, ch = rc - rr * in_dim;
      if (tt < n) {
        cp_async4(sd + i, seq + (static_cast<size_t>(row_of(rr)) * in_dim + ch) * t_len + t0 + tt);
      } else {
        sd[i] = 0.0f;
      }
    }
    float* xd = x_s + buf * R * out_ch * kChunk;
    for (int i = j; i < R * out_ch * kChunk; i += kThreads) {
      const int rc = i / kChunk, tt = i - rc * kChunk;
      const int rr = rc / out_ch, ch = rc - rr * out_ch;
      if (tt < n) {
        cp_async4(xd + i, xres + (static_cast<size_t>(row_of(rr)) * out_ch + ch) * t_len + t0 + tt);
      } else {
        xd[i] = 0.0f;
      }
    }
    cp_async_commit();
  };

  const unsigned bar_loc = smem_addr(bars);
  constexpr unsigned kStepBytes = R * 4 * H;  // what lands in each CTA a step
  if (j == 0) {
    mbar_init(bar_loc, 1);
    mbar_init(bar_loc + 8, 1);
    mbar_expect_tx(bar_loc, kStepBytes);
    if (t_len > 1) mbar_expect_tx(bar_loc + 8, kStepBytes);
  }
  stage(0, 0);
  cp_async_wait_all();
  // every CTA of the cluster has started and holds h0 and its barriers
  // before the first remote store (this also stands for the block's barrier)
  cluster_arrive();
  cluster_wait();
  const unsigned bar_rem = mapa(bar_loc, l < N ? l : 0);  // CTA l's barriers
  // byte addresses in shared memory of what the step loop touches
  const unsigned ring_loc = smem_addr(ring);
  const unsigned h_rd = ring_loc + 4 * kVec * l;                  // this lane's vectors of a slot
  const unsigned h_wr = mapa(ring_loc + 4 * u, l < N ? l : 0);    // unit u's h in CTA l's ring
  const unsigned cring_wr = smem_addr(cring) + 4 * ul;
  const unsigned gring_wr = smem_addr(gring) + 4 * (q * kGq + ul);
  const unsigned seq_rd = smem_addr(seq_s);
  int sb = 0;  // staging buffer of this chunk
  for (int t0 = 0; t0 < t_len; t0 += kChunk, sb ^= 1) {
    const int n = min(kChunk, t_len - t0);
    if (t0 + kChunk < t_len) stage(t0 + kChunk, sb ^ 1);
    const unsigned sq = seq_rd + 4 * sb * R * in_dim * kChunk;
    auto input_proj = [&](int rr, int tt) {
      float a = bj;
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        if (kIn > 0 || i < in_dim) a = fmaf(wih[i], lds32(sq + 4 * ((rr * in_dim + i) * kChunk + tt)), a);
      }
      return a;
    };
    float ax[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) ax[rr] = input_proj(rr, 0);
    for (int tt = 0; tt < n; ++tt) {
      const int t = t0 + tt;
      const unsigned rd = h_rd + 4 * kRingLd * ((t - 1) & (kSlots - 1));
      const unsigned wr = h_wr + 4 * kRingLd * (t & (kSlots - 1));
      // each phase for all R rows at once, so that the rows' chains overlap
      float hv[R][kK];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
#pragma unroll
        for (int i = 0; i < kNv; ++i) {
          const unsigned ra = rd + 4 * rr * kSlots * kRingLd;
          if constexpr (kVec == 4) {
            const float4 v = lds128(ra + 16 * L * i);
            hv[rr][4 * i] = v.x;
            hv[rr][4 * i + 1] = v.y;
            hv[rr][4 * i + 2] = v.z;
            hv[rr][4 * i + 3] = v.w;
          } else {
            const float2 v = lds64(ra + 8 * L * i);
            hv[rr][2 * i] = v.x;
            hv[rr][2 * i + 1] = v.y;
          }
        }
      }
      float a[R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;  // gates i, f, g, o over this lane's k
#pragma unroll
        for (int i = 0; i < kK; ++i) {
          p0 = fmaf(w[0][i], hv[rr][i], p0);
          p1 = fmaf(w[1][i], hv[rr][i], p1);
          p2 = fmaf(w[2][i], hv[rr][i], p2);
          p3 = fmaf(w[3][i], hv[rr][i], p3);
        }
        // lane q of each four ends with gate q over the four's k (as in the
        // fast kernel), then the fours of a unit add theirs: every lane of
        // the unit holds the same sum
        float k0 = odd ? p1 : p0, k1 = odd ? p3 : p2;
        k0 += __shfl_xor_sync(kFull, odd ? p0 : p1, 1);
        k1 += __shfl_xor_sync(kFull, odd ? p2 : p3, 1);
        a[rr] = high ? k1 : k0;
        a[rr] += __shfl_xor_sync(kFull, high ? k0 : k1, 2);
#pragma unroll
        for (int m = 4; m < L; m *= 2) a[rr] += __shfl_xor_sync(kFull, a[rr], m);
        a[rr] += ax[rr];
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) ax[rr] = input_proj(rr, min(tt + 1, kChunk - 1));  // off the chain
      float act[R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        act[rr] = fmaf(s, rcp_1p_exp2(sl * a[rr]), o);
        const float gi = __shfl_sync(kFull, act[rr], quad + 0);
        const float gf = __shfl_sync(kFull, act[rr], quad + 1);
        const float gg = __shfl_sync(kFull, act[rr], quad + 2);
        const float go = __shfl_sync(kFull, act[rr], quad + 3);
        c[rr] = fmaf(gf, c[rr], gi * gg);
        h[rr] = go * tanh_fast(c[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        st_async_if(l < N, wr + 4 * rr * kSlots * kRingLd, h[rr], bar_rem + 8 * (t & 1));
      }
      if (kSave) {  // kept for the chunk's end, off the step's path
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          sts32_if(l < 4, gring_wr + 4 * (rr * kChunk + tt) * kGLd, act[rr]);
          sts32_if(l == 0, cring_wr + 4 * (rr * kChunk + tt) * U, c[rr]);
        }
      }
      // the step's R x H values have all landed here; the barrier's next
      // phase is step t + 2's
      mbar_wait_cluster(bar_loc + 8 * (t & 1), (t >> 1) & 1);
      if (j == 0 && t + 2 < t_len) mbar_expect_tx(bar_loc + 8 * (t & 1), kStepBytes);
    }
    __syncthreads();  // every warp is past the chunk's last step, and its saves
    if (kSave) {  // this CTA's units of the chunk's h, c and activations, 16 bytes a store
      constexpr int U4 = U / 4;
      for (int i = j; i < R * n * U4; i += kThreads) {
        const int rt = i / U4, p = i - rt * U4;
        const int rr = rt / n, tt = rt - rr * n;
        if (!valid(rr)) continue;
        const size_t row = static_cast<size_t>(row_of(rr)) * t_len + t0 + tt;
        const float* hr = ring + (rr * kSlots + ((t0 + tt) & (kSlots - 1))) * kRingLd + r * U;
        reinterpret_cast<float4*>(hs + row * H + r * U)[p] = reinterpret_cast<const float4*>(hr)[p];
        reinterpret_cast<float4*>(cs + row * H + r * U)[p] =
            reinterpret_cast<const float4*>(cring + (rr * kChunk + tt) * U)[p];
      }
      for (int i = j; i < R * n * 4 * U4; i += kThreads) {
        const int rt = i / (4 * U4), p = i - rt * (4 * U4);
        const int rr = rt / n, tt = rt - rr * n;
        const int qq = p / U4, pr = p - qq * U4;
        if (!valid(rr)) continue;
        const size_t row = static_cast<size_t>(row_of(rr)) * t_len + t0 + tt;
        reinterpret_cast<float4*>(gates + row * G4 + qq * H + r * U)[pr] =
            reinterpret_cast<const float4*>(gring + (rr * kChunk + tt) * kGLd + qq * kGq)[pr];
      }
    }
    // fc head + residual + tanh for the chunk's steps: output p goes to the
    // cluster's unit group p mod H, L lanes an output
    const float* xq = x_s + sb * R * out_ch * kChunk;
    const int total = R * out_ch * n;
    for (int p0 = 0; p0 < total; p0 += H) {
      const int p = min(p0 + u, total - 1);
      const int ro = p / n, tt = p - ro * n;  // ro = rr out_ch + oc
      const int rr = ro / out_ch, oc = ro - rr * out_ch;
      const float* hr = ring + (rr * kSlots + ((t0 + tt) & (kSlots - 1))) * kRingLd;
      float z = 0.0f;
      for (int kk = l; kk < H; kk += L) z = fmaf(hr[kk], fc_k[kk * out_ch + oc], z);
#pragma unroll
      for (int m = 1; m < L; m *= 2) z += __shfl_xor_sync(kFull, z, m);
      if (l == 0 && p0 + u < total && valid(rr)) {
        y[(static_cast<size_t>(row_of(rr)) * out_ch + oc) * t_len + t0 + tt] =
            tanhf(z + fc_b[oc] + xq[ro * kChunk + tt]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  if (l == 0) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      if (valid(rr)) {
        hn[row_of(rr) * H + u] = h[rr];
        cn[row_of(rr) * H + u] = c[rr];
      }
    }
  }
  // no CTA leaves while its stores to a peer may be in flight
  cluster_arrive();
  cluster_wait();
}

// ---------------------------------------------------------------------------
// K3 / K4, any H <= kMaxHidden: one thread per gate column, W_hh in shared
// memory when it fits (through L2 otherwise), two barriers a step
// ---------------------------------------------------------------------------
template <bool kSave>
__global__ void __launch_bounds__(1024) lstm_fwd_kernel(
    const float* __restrict__ seq, const float* __restrict__ xres,
    const float* __restrict__ h0, const float* __restrict__ c0,
    const float* __restrict__ w_ih, const float* __restrict__ w_hh,
    const float* __restrict__ bias, const float* __restrict__ fc_k,
    const float* __restrict__ fc_b, float* __restrict__ y,
    float* __restrict__ hn, float* __restrict__ cn,
    float* __restrict__ hs, float* __restrict__ cs, float* __restrict__ gates,
    int t_len, int hid, int in_dim, int out_ch, int whh_in_smem) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int g4 = 4 * hid;
  const int j = threadIdx.x;  // gate column
  const int b = blockIdx.x;
  const int ring_ld = hid + 1;  // padded: the head reads a column per thread
  float* w_s = smem;
  float* h_s = w_s + (whh_in_smem ? hid * g4 : 0);  // [hid]
  float* act_s = h_s + hid;                          // [g4]
  float* ring = act_s + g4;                          // [kFwdChunk][hid + 1]
  float* seq_s = ring + kFwdChunk * ring_ld;         // [in_dim][kFwdChunk]
  float* x_s = seq_s + in_dim * kFwdChunk;           // [out_ch][kFwdChunk]

  if (whh_in_smem) {
    for (int i = j; i < hid * g4; i += blockDim.x) w_s[i] = w_hh[i];
  }
  const float* W = whh_in_smem ? w_s : w_hh;
  float wih[kMaxIn];
#pragma unroll
  for (int i = 0; i < kMaxIn; ++i) wih[i] = i < in_dim ? w_ih[i * g4 + j] : 0.0f;
  const float bj = bias[j];
  const int gate = j / hid;
  float c = 0.0f;
  if (j < hid) {
    c = c0[b * hid + j];
    h_s[j] = h0[b * hid + j];
  }

  for (int t0 = 0; t0 < t_len; t0 += kFwdChunk) {
    const int n = min(kFwdChunk, t_len - t0);
    for (int i = j; i < in_dim * kFwdChunk; i += blockDim.x) {
      const int ch = i / kFwdChunk, tt = i - ch * kFwdChunk;
      seq_s[i] = tt < n ? seq[(static_cast<size_t>(b) * in_dim + ch) * t_len + t0 + tt] : 0.0f;
    }
    for (int i = j; i < out_ch * kFwdChunk; i += blockDim.x) {
      const int ch = i / kFwdChunk, tt = i - ch * kFwdChunk;
      x_s[i] = tt < n ? xres[(static_cast<size_t>(b) * out_ch + ch) * t_len + t0 + tt] : 0.0f;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      float a0 = bj, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxIn; ++i) {
        if (i < in_dim) a0 += wih[i] * seq_s[i * kFwdChunk + tt];
      }
      int k = 0;
      for (; k + 4 <= hid; k += 4) {
        a0 += W[(k + 0) * g4 + j] * h_s[k + 0];
        a1 += W[(k + 1) * g4 + j] * h_s[k + 1];
        a2 += W[(k + 2) * g4 + j] * h_s[k + 2];
        a3 += W[(k + 3) * g4 + j] * h_s[k + 3];
      }
      for (; k < hid; ++k) a0 += W[k * g4 + j] * h_s[k];
      const float a = (a0 + a1) + (a2 + a3);
      const float act = gate == 2 ? tanhf(a) : sigmoid_f(a);
      act_s[j] = act;
      if (kSave) gates[(static_cast<size_t>(b) * t_len + t0 + tt) * g4 + j] = act;
      __syncthreads();
      if (j < hid) {
        const float gi = act_s[j], gf = act_s[hid + j];
        const float gg = act_s[2 * hid + j], go = act_s[3 * hid + j];
        c = gf * c + gi * gg;
        const float h = go * tanhf(c);
        h_s[j] = h;
        ring[tt * ring_ld + j] = h;
        if (kSave) {
          const size_t o = (static_cast<size_t>(b) * t_len + t0 + tt) * hid + j;
          hs[o] = h;
          cs[o] = c;
        }
      }
      __syncthreads();
    }
    // fc head + residual + tanh for the chunk's steps
    for (int p = j; p < out_ch * n; p += blockDim.x) {
      const int oc = p / n, tt = p - oc * n;
      float z = fc_b[oc];
      for (int k = 0; k < hid; ++k) z += ring[tt * ring_ld + k] * fc_k[k * out_ch + oc];
      y[(static_cast<size_t>(b) * out_ch + oc) * t_len + t0 + tt] =
          tanhf(z + x_s[oc * kFwdChunk + tt]);
    }
    __syncthreads();
  }
  if (j < hid) {
    hn[b * hid + j] = h_s[j];
    cn[b * hid + j] = c;
  }
}

// ---------------------------------------------------------------------------
// K5 (1/4), fast path: reverse walk -> gate cotangents, dh0, dc0
// ---------------------------------------------------------------------------
// Thread 4k + q forms the cotangent of gate q of unit k from K4's saved gate
// activations, c_t, c_{t-1} and dL/dh_t, staged a chunk ahead by 16-byte
// cp.async; everything that does not depend on the running cotangents is
// computed for the whole chunk before its walk.  The chunk's gate cotangents are kept
// in shared memory, a row a step, and written out at the chunk's end, 16
// bytes a store.  For the recurrent cotangent dh_{t-1} = W_hh dgates, the 16
// lanes of a half warp own four rows of W_hh (the units of their four
// quads); lane l of them keeps those rows' weights for the float4s l + 16 i
// of the step's row in registers (H weights), reads H / 16 float4s a step,
// and a two-stage exchange over the quads plus two xor-shuffles inside the
// quad leave every lane of a quad with its unit's sum, added in one fixed
// order.  One barrier a step.
template <int H>
__global__ void __launch_bounds__(4 * H) lstm_bwd_walk_fast_kernel(
    const float* __restrict__ gates, const float* __restrict__ cs,
    const float* __restrict__ c0, const float* __restrict__ w_hh,
    const float* __restrict__ dh_in, const float* __restrict__ dhn,
    const float* __restrict__ dcn, float* __restrict__ dgates,
    float* __restrict__ dh0, float* __restrict__ dc0, int t_len) {
  extern __shared__ float4 smem4[];
  constexpr int G4 = 4 * H;
  constexpr int kGq = H + 8;     // gate block pitch of a staged row: the lanes of a warp hit 32 banks
  constexpr int kGLd = 4 * kGq;
  constexpr int kH4 = H / 4;
  constexpr int kV = H / 16;     // float4s of dg_s a lane reads a step
  constexpr int kPre = 8;        // steps whose coefficients are formed together
  constexpr unsigned kFull = 0xffffffffu;
  const int j = threadIdx.x;
  const int k = j >> 2, q = j & 3;
  const int b = blockIdx.x;
  const int quad = (j & 31) & ~3;
  const int l16 = j & 15;            // lane of the half warp
  const int row_base = (j >> 4) * 4; // first of the half warp's four units
  const bool odd = (k & 1) != 0, high = (k & 2) != 0;  // this lane's unit among the four
  float* g_s = reinterpret_cast<float*>(smem4);        // [2][kBwdChunk][kGLd]
  float* c_s = g_s + 2 * kBwdChunk * kGLd;              // [2][kBwdChunk + 1][H]: rows t0-1 .. t0+n-1
  float* dhin_s = c_s + 2 * (kBwdChunk + 1) * H;        // [2][kBwdChunk][H]
  float* dg_s = dhin_s + 2 * kBwdChunk * H;             // [kBwdChunk][kGLd], laid out as g_s
  float* ao_s = dg_s + kBwdChunk * kGLd;                // [kBwdChunk][H]: go (1 - tanh(c_t)^2)
  float* gf_s = ao_s + kBwdChunk * H;                   // [kBwdChunk][H]: the forget gate

  // float4 l16 + 16 i of a row of 4H gate cotangents: gate block and place in it
  float wr[4][4 * kV];  // [r][4 i + e] = W_hh[row_base + r, 4 (l16 + 16 i) + e]
  unsigned dg_off[kV];  // byte offset of that float4 in a row of dg_s
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int f = l16 + 16 * i;
    dg_off[i] = 4 * ((f / kH4) * kGq + 4 * (f % kH4));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) wr[r][4 * i + e] = w_hh[(row_base + r) * G4 + 4 * f + e];
    }
  }
  float dh_run = dhn[b * H + k];
  float dc_run = dcn[b * H + k];
  const size_t row0 = static_cast<size_t>(b) * t_len;

  auto stage = [&](int ci, int buf) {
    const int t0 = ci * kBwdChunk;
    const int n = min(kBwdChunk, t_len - t0);
    float* gd = g_s + buf * kBwdChunk * kGLd;
    for (int i = j; i < n * H; i += G4) {  // n rows of 4H floats = n * H pieces of 16 bytes
      const int tt = i / H, p = i - tt * H;
      const int qq = p / kH4, r = p - qq * kH4;
      cp_async16(gd + tt * kGLd + qq * kGq + 4 * r, gates + (row0 + t0 + tt) * G4 + 4 * p);
    }
    float* cd = c_s + buf * (kBwdChunk + 1) * H;
    for (int i = j; i < (n + 1) * kH4; i += G4) {
      const int tt = i / kH4, r = i - tt * kH4;
      const int t = t0 + tt - 1;
      const float* src = t < 0 ? c0 + b * H : cs + (row0 + t) * H;
      cp_async16(cd + tt * H + 4 * r, src + 4 * r);
    }
    float* dd = dhin_s + buf * kBwdChunk * H;
    for (int i = j; i < n * kH4; i += G4) {
      cp_async16(dd + 4 * i, dh_in + (row0 + t0) * H + 4 * i);
    }
    cp_async_commit();
  };

  const int n_chunks = (t_len + kBwdChunk - 1) / kBwdChunk;
  stage(n_chunks - 1, 0);
  cp_async_wait_all();
  __syncthreads();
  // byte addresses in shared memory of what the step loop touches
  const unsigned g_rd = smem_addr(g_s) + 4 * (q * kGq + k);
  const unsigned c_rd = smem_addr(c_s) + 4 * k;
  const unsigned dhin_rd = smem_addr(dhin_s) + 4 * k;
  const unsigned dg_wr = smem_addr(dg_s) + 4 * (q * kGq + k);
  const unsigned dg_rd = smem_addr(dg_s);
  const unsigned ao_rw = smem_addr(ao_s) + 4 * k;
  const unsigned gf_rw = smem_addr(gf_s) + 4 * k;
  int sb = 0;  // staging buffer of this chunk
  for (int ci = n_chunks - 1; ci >= 0; --ci, sb ^= 1) {
    const int t0 = ci * kBwdChunk;
    const int n = min(kBwdChunk, t_len - t0);
    if (ci > 0) stage(ci - 1, sb ^ 1);
    const unsigned gq = g_rd + 4 * sb * kBwdChunk * kGLd;
    const unsigned cq = c_rd + 4 * sb * (kBwdChunk + 1) * H;
    const unsigned dq = dhin_rd + 4 * sb * kBwdChunk * H;
    // What a step needs beside the running cotangents,
    //   dc = dc_run + dh * a_o;  dg = (q == 3 ? dh : dc) * coef;  dc_run = dc * gf
    // with a_o = go (1 - tanh(c_t)^2) and coef = gg gi (1 - gi), c_{t-1} gf (1 - gf),
    // gi (1 - gg^2), tanh(c_t) go (1 - go) for q = 0 .. 3 (a factor from another lane
    // times a function of this lane's own gate), does not depend on the walk: it is
    // formed for the whole chunk here, kPre steps at a time so that the loads, special
    // functions and shuffles of different steps overlap.  coef takes the place of the
    // lane's activation in g_s; a_o and gf go to rows of their own.
    for (int tt0 = 0; tt0 < n; tt0 += kPre) {
      float act[kPre], cp[kPre], ct[kPre];
#pragma unroll
      for (int v = 0; v < kPre; ++v) {
        const int tt = min(tt0 + v, n - 1);
        act[v] = lds32(gq + 4 * kGLd * tt);
        cp[v] = lds32(cq + 4 * H * tt);
        ct[v] = lds32(cq + 4 * H * (tt + 1));
      }
      float coef4[kPre], ao4[kPre], gf4[kPre];
#pragma unroll
      for (int v = 0; v < kPre; ++v) {
        const float tc = tanh_fast(ct[v]);
        const float gi = __shfl_sync(kFull, act[v], quad + 0);
        gf4[v] = __shfl_sync(kFull, act[v], quad + 1);
        const float gg = __shfl_sync(kFull, act[v], quad + 2);
        const float go = __shfl_sync(kFull, act[v], quad + 3);
        ao4[v] = go * (1.0f - tc * tc);
        const float other = q == 0 ? gg : q == 1 ? cp[v] : q == 2 ? gi : tc;
        coef4[v] = other * (1.0f - act[v]) * (q == 2 ? 1.0f + act[v] : act[v]);
      }
#pragma unroll
      for (int v = 0; v < kPre; ++v) {
        const int tt = min(tt0 + v, n - 1);
        sts32(gq + 4 * kGLd * tt, coef4[v]);
        sts32_if(q == 0, ao_rw + 4 * H * tt, ao4[v]);
        sts32_if(q == 1, gf_rw + 4 * H * tt, gf4[v]);
      }
    }
    __syncwarp();  // a_o and gf come from lanes of this thread's own quad
    float coef = lds32(gq + 4 * kGLd * (n - 1)), a_o = lds32(ao_rw + 4 * H * (n - 1));
    float gf = lds32(gf_rw + 4 * H * (n - 1)), dhi = lds32(dq + 4 * H * (n - 1));
    for (int tt = n - 1; tt >= 0; --tt) {
      const float dh = dh_run + dhi;
      const float dc = fmaf(dh, a_o, dc_run);
      const float dg = (q == 3 ? dh : dc) * coef;
      dc_run = dc * gf;
      sts32(dg_wr + 4 * kGLd * tt, dg);
      __syncthreads();
      // dh_{t-1} of the half warp's four units over this lane's float4s
      float4 dv[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) dv[i] = lds128(dg_rd + 4 * kGLd * tt + dg_off[i]);
      const int tn = max(tt - 1, 0);  // the next step's operands arrive under the product
      coef = lds32(gq + 4 * kGLd * tn);
      a_o = lds32(ao_rw + 4 * H * tn);
      gf = lds32(gf_rw + 4 * H * tn);
      dhi = lds32(dq + 4 * H * tn);
      float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const float4 v = dv[i];
        const float ve[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p0 = fmaf(wr[0][4 * i + e], ve[e], p0);
          p1 = fmaf(wr[1][4 * i + e], ve[e], p1);
          p2 = fmaf(wr[2][4 * i + e], ve[e], p2);
          p3 = fmaf(wr[3][4 * i + e], ve[e], p3);
        }
      }
      // a quad ends with its own unit's row: the quads 4 lanes apart trade
      // the rows of the other parity, the quads 8 lanes apart the other half
      float k0 = odd ? p1 : p0, k1 = odd ? p3 : p2;
      k0 += __shfl_xor_sync(kFull, odd ? p0 : p1, 4);
      k1 += __shfl_xor_sync(kFull, odd ? p2 : p3, 4);
      float part = high ? k1 : k0;
      part += __shfl_xor_sync(kFull, high ? k0 : k1, 8);
      part += __shfl_xor_sync(kFull, part, 1);
      part += __shfl_xor_sync(kFull, part, 2);
      dh_run = part;
    }
    for (int i = j; i < n * H; i += G4) {  // the chunk's gate cotangents, 16 bytes a store
      const int tt = i / H, p = i - tt * H;
      const int qq = p / kH4, r = p - qq * kH4;
      reinterpret_cast<float4*>(dgates + (row0 + t0 + tt) * G4)[p] =
          *reinterpret_cast<const float4*>(dg_s + tt * kGLd + qq * kGq + 4 * r);
    }
    cp_async_wait_all();
    __syncthreads();
  }
  if (q == 0) {
    dh0[b * H + k] = dh_run;
    dc0[b * H + k] = dc_run;
  }
}

// ---------------------------------------------------------------------------
// K5 (1/4) at H 160: one thread-block cluster of N CTAs for R batch rows,
// W_hh split over the cluster
// ---------------------------------------------------------------------------
// CTA r owns the U = H / N hidden units r U .. r U + U - 1 and their C = 4 U
// gate columns (laid out [gate][unit] in shared memory), as in the cluster
// forward.  The cell's backward is local to a unit: thread j < R C forms the
// cotangent of column j % C of row j / C from dh = dh_run + dh_in, a_o, its
// coefficient, gf and its own copy of dc_run, all formed for the chunk
// before its walk (the fast walk's precompute).  The recurrent product
// dh_{t-1} = W_hh dgates is the one step that crosses CTAs: CTA r keeps
// W_hh[:, its C columns] in registers, the 8 lanes of an output quad (units
// 4 g .. 4 g + 3) the columns in the vectors l + 8 i (kVec floats each), C /
// 8 columns and 4 C / 8 weights a lane (80 at N 4, 40 at N 8).  A lane forms
// four partial sums from the step's dgates (read from shared memory, the
// lanes of a quad on neighbouring addresses), the fast kernel's two-stage
// exchange and an xor-add over the lanes 4 apart leave lane l with unit 4 g
// + (l & 3)'s partial over this CTA's columns, and lane l < 4 sends it by
// st.async into the ring of the CTA that owns the unit, counted in bytes on
// that CTA's mbarrier of the step's parity.  The owner waits for the step's
// R x N x U partials and adds them in rank order, so the sum is the same
// bits from launch to launch; one thread re-arms the barrier for the step
// two ahead.  A CTA receives H floats a row a step, the forward's bytes.
// Safety of the two ring slots and barrier phases: a CTA's product of step
// n needs every CTA's partials of step n - 1, and a CTA sends its partials
// of step n only after the block barrier that follows its reads of step n -
// 1's slot, so no slot is written while it may still be read and no phase
// is reached twice ahead of a waiter (no warp of the cluster is more than
// one step ahead of any other).  The last step's partials are dh0.  The
// chunk's gate cotangents stay in shared memory and go out at its end, 16
// bytes a store.  A row past the batch (odd B) walks the last row again and
// writes nothing.
template <int H, int N, int R>
__global__ void __launch_bounds__(2 * H, 1) lstm_bwd_cluster_kernel(
    const float* __restrict__ gates, const float* __restrict__ cs,
    const float* __restrict__ c0, const float* __restrict__ w_hh,
    const float* __restrict__ dh_in, const float* __restrict__ dhn,
    const float* __restrict__ dcn, float* __restrict__ dgates,
    float* __restrict__ dh0, float* __restrict__ dc0, int batch, int t_len) {
  extern __shared__ float4 smem4[];
  __shared__ alignas(8) unsigned long long bars[2];  // partials of steps n with n & 1 = 0, 1
  constexpr int G4 = 4 * H;
  constexpr int U = H / N;                 // units of this CTA
  constexpr int U4 = U / 4;
  constexpr int C = 4 * U;                 // gate columns of this CTA
  constexpr int kThreads = 2 * H;
  constexpr int kLanes = 8;                // lanes of an output quad
  constexpr int kKI = C / kLanes;          // columns a lane multiplies
  constexpr int kVec = kKI % 4 == 0 ? 4 : 2;
  constexpr int kNv = kKI / kVec;          // loads of dgates a lane a step
  constexpr int kChunk = kBwdChunk / R;    // steps staged a pass
  constexpr int kCells = R * C;            // threads of the cell's backward
  constexpr unsigned kFull = 0xffffffffu;
  static_assert(H % N == 0 && U % 4 == 0 && kThreads == kLanes * H / 4 && kKI % kVec == 0 &&
                kCells <= kThreads, "cluster split");
  const int j = threadIdx.x;
  const int r = static_cast<int>(cluster_rank());
  const int row0 = static_cast<int>(cluster_id()) * R;
  auto row_of = [&](int rr) { return min(row0 + rr, batch - 1); };
  auto valid = [&](int rr) { return row0 + rr < batch; };
  float* g_st = reinterpret_cast<float*>(smem4);  // [2][R][kChunk][C] staged gate activations
  float* c_st = g_st + 2 * R * kChunk * C;         // [2][R][kChunk + 1][U] c_{t0-1} .. c_{t0+n-1}
  float* d_st = c_st + 2 * R * (kChunk + 1) * U;   // [2][R][kChunk][U] dh_in
  float* coef_s = d_st + 2 * R * kChunk * U;       // [R][kChunk][C] coefficients
  float* ao_s = coef_s + R * kChunk * C;           // [R][kChunk][U] go (1 - tanh(c_t)^2)
  float* gf_s = ao_s + R * kChunk * U;             // [R][kChunk][U] the forget gate
  float* dg_s = gf_s + R * kChunk * U;             // [R][kChunk][C] the chunk's gate cotangents
  float* part = dg_s + R * kChunk * C;             // [2][R][N][U] partial dh from each CTA

  // the product: lane l of quad g, outputs 4 g .. 4 g + 3
  const int g = j / kLanes, l = j % kLanes;
  const bool odd = (l & 1) != 0, high = (l & 2) != 0;
  float w[4][kKI];  // [o][kVec i + e] = W_hh[4 g + o, the column of c = kVec (l + 8 i) + e]
#pragma unroll
  for (int o = 0; o < 4; ++o) {
#pragma unroll
    for (int i = 0; i < kNv; ++i) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int c = kVec * (l + kLanes * i) + e;
        w[o][kVec * i + e] = w_hh[(4 * g + o) * G4 + (c / U) * H + r * U + c % U];
      }
    }
  }
  // the cell: column cc (gate q, unit ul) of row rc
  const bool cell = j < kCells;
  const int rc = cell ? j / C : 0;
  const int cc = j % C;
  const int q = cc / U, ul = cc % U;
  float dh_run = 0.0f, dc_run = 0.0f;
  if (cell) {
    dh_run = dhn[row_of(rc) * H + r * U + ul];
    dc_run = dcn[row_of(rc) * H + r * U + ul];
  }

  auto stage = [&](int ci, int buf) {
    const int t0 = ci * kChunk;
    const int n = min(kChunk, t_len - t0);
    float* gd = g_st + buf * R * kChunk * C;
    for (int i = j; i < R * n * 4 * U4; i += kThreads) {
      const int p = i % U4, qq = (i / U4) % 4, rt = i / (4 * U4);
      const int rr = rt / n, tt = rt - rr * n;
      cp_async16(gd + (rr * kChunk + tt) * C + qq * U + 4 * p,
                 gates + (static_cast<size_t>(row_of(rr)) * t_len + t0 + tt) * G4 + qq * H + r * U + 4 * p);
    }
    float* cd = c_st + buf * R * (kChunk + 1) * U;
    for (int i = j; i < R * (n + 1) * U4; i += kThreads) {
      const int p = i % U4, rt = i / U4;
      const int rr = rt / (n + 1), tt = rt - rr * (n + 1);
      const int t = t0 + tt - 1;
      const float* src = t < 0 ? c0 + static_cast<size_t>(row_of(rr)) * H
                               : cs + (static_cast<size_t>(row_of(rr)) * t_len + t) * H;
      cp_async16(cd + (rr * (kChunk + 1) + tt) * U + 4 * p, src + r * U + 4 * p);
    }
    float* dd = d_st + buf * R * kChunk * U;
    for (int i = j; i < R * n * U4; i += kThreads) {
      const int p = i % U4, rt = i / U4;
      const int rr = rt / n, tt = rt - rr * n;
      cp_async16(dd + (rr * kChunk + tt) * U + 4 * p,
                 dh_in + (static_cast<size_t>(row_of(rr)) * t_len + t0 + tt) * H + r * U + 4 * p);
    }
    cp_async_commit();
  };

  // What a step needs beside the running cotangents (as in the fast walk),
  //   dc = dc_run + dh a_o;  dg = (q == 3 ? dh : dc) coef;  dc_run = dc gf
  // with a_o = go (1 - tanh(c_t)^2) and coef = gg gi (1 - gi), c_{t-1} gf (1 - gf),
  // gi (1 - gg^2), tanh(c_t) go (1 - go) for q = 0 .. 3, for the whole chunk
  auto precompute = [&](int buf, int n) {
    const float* gb = g_st + buf * R * kChunk * C;
    const float* cb = c_st + buf * R * (kChunk + 1) * U;
    for (int i = j; i < R * n * C; i += kThreads) {
      const int c = i % C, rt = i / C;
      const int rr = rt / n, tt = rt - rr * n;
      const int qq = c / U, uu = c % U;
      const float* ga = gb + (rr * kChunk + tt) * C + uu;
      const float gi = ga[0], gf = ga[U], gg = ga[2 * U], go = ga[3 * U];
      const float cp = cb[(rr * (kChunk + 1) + tt) * U + uu];
      const float tc = tanh_fast(cb[(rr * (kChunk + 1) + tt + 1) * U + uu]);
      const float act = ga[qq * U];
      const float other = qq == 0 ? gg : qq == 1 ? cp : qq == 2 ? gi : tc;
      coef_s[(rr * kChunk + tt) * C + c] = other * (1.0f - act) * (qq == 2 ? 1.0f + act : act);
      if (qq == 0) ao_s[(rr * kChunk + tt) * U + uu] = go * (1.0f - tc * tc);
      if (qq == 1) gf_s[(rr * kChunk + tt) * U + uu] = gf;
    }
  };

  const unsigned bar_loc = smem_addr(bars);
  constexpr unsigned kStepBytes = R * 4 * H;   // what lands in each CTA a step
  constexpr unsigned kSlotBytes = 4 * R * N * U;
  if (j == 0) {
    mbar_init(bar_loc, 1);
    mbar_init(bar_loc + 8, 1);
    mbar_expect_tx(bar_loc, kStepBytes);
    if (t_len > 1) mbar_expect_tx(bar_loc + 8, kStepBytes);
  }
  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  stage(n_chunks - 1, 0);
  cp_async_wait_all();
  // every CTA of the cluster has started and holds its barriers before the
  // first remote store (this also stands for the block's barrier)
  cluster_arrive();
  cluster_wait();
  // byte addresses in shared memory of what the step loop touches
  const int k_out = 4 * g + (l & 3);  // the unit whose partial this lane sends (l < 4)
  const unsigned part_loc = smem_addr(part);
  const unsigned part_wr = mapa(part_loc + 4 * (r * U + k_out % U), k_out / U);
  const unsigned bar_rem = mapa(bar_loc, k_out / U);
  const unsigned part_rd = part_loc + 4 * (rc * N * U + ul);
  const unsigned dg_rd = smem_addr(dg_s) + 4 * kVec * l;
  const unsigned dg_wr = smem_addr(dg_s) + 4 * (rc * kChunk * C + cc);
  const unsigned coef_rd = smem_addr(coef_s) + 4 * (rc * kChunk * C + cc);
  const unsigned ao_rd = smem_addr(ao_s) + 4 * (rc * kChunk * U + ul);
  const unsigned gf_rd = smem_addr(gf_s) + 4 * (rc * kChunk * U + ul);
  const unsigned dhin_rd = smem_addr(d_st) + 4 * (rc * kChunk * U + ul);
  int step = 0;  // steps walked so far: step n is t = t_len - 1 - n
  int sb = 0;    // staging buffer of this chunk
  for (int ci = n_chunks - 1; ci >= 0; --ci, sb ^= 1) {
    const int t0 = ci * kChunk;
    const int n = min(kChunk, t_len - t0);
    if (ci > 0) stage(ci - 1, sb ^ 1);
    precompute(sb, n);
    __syncthreads();
    const unsigned dq = dhin_rd + 4 * sb * R * kChunk * U;
    float coef = 0.0f, a_o = 0.0f, gf = 0.0f, dhi = 0.0f;
    if (cell) {
      coef = lds32(coef_rd + 4 * C * (n - 1));
      a_o = lds32(ao_rd + 4 * U * (n - 1));
      gf = lds32(gf_rd + 4 * U * (n - 1));
      dhi = lds32(dq + 4 * U * (n - 1));
    }
    for (int tt = n - 1; tt >= 0; --tt, ++step) {
      if (cell) {
        if (step > 0) {  // the partials of step - 1 have all landed here
          const int m = step - 1;
          mbar_wait_cluster(bar_loc + 8 * (m & 1), (m >> 1) & 1);
          if (j == 0 && m + 2 < t_len) mbar_expect_tx(bar_loc + 8 * (m & 1), kStepBytes);
          const unsigned pr = part_rd + kSlotBytes * (m & 1);
          float s = lds32(pr);
#pragma unroll
          for (int src = 1; src < N; ++src) s += lds32(pr + 4 * U * src);
          dh_run = s;
        }
        const float dh = dh_run + dhi;
        const float dc = fmaf(dh, a_o, dc_run);
        const float dg = (q == 3 ? dh : dc) * coef;
        dc_run = dc * gf;
        sts32(dg_wr + 4 * C * tt, dg);
      }
      __syncthreads();
      if (cell) {  // the next step's operands arrive under the product
        const int tn = max(tt - 1, 0);
        coef = lds32(coef_rd + 4 * C * tn);
        a_o = lds32(ao_rd + 4 * U * tn);
        gf = lds32(gf_rd + 4 * U * tn);
        dhi = lds32(dq + 4 * U * tn);
      }
      // each phase for all R rows at once, so that the rows' chains overlap
      float dv[R][kKI];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const unsigned ra = dg_rd + 4 * (rr * kChunk + tt) * C;
#pragma unroll
        for (int i = 0; i < kNv; ++i) {
          if constexpr (kVec == 4) {
            const float4 v = lds128(ra + 16 * kLanes * i);
            dv[rr][4 * i] = v.x;
            dv[rr][4 * i + 1] = v.y;
            dv[rr][4 * i + 2] = v.z;
            dv[rr][4 * i + 3] = v.w;
          } else {
            const float2 v = lds64(ra + 8 * kLanes * i);
            dv[rr][2 * i] = v.x;
            dv[rr][2 * i + 1] = v.y;
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;  // units 4 g .. 4 g + 3 over this lane's columns
#pragma unroll
        for (int i = 0; i < kKI; ++i) {
          p0 = fmaf(w[0][i], dv[rr][i], p0);
          p1 = fmaf(w[1][i], dv[rr][i], p1);
          p2 = fmaf(w[2][i], dv[rr][i], p2);
          p3 = fmaf(w[3][i], dv[rr][i], p3);
        }
        // lane l ends with unit 4 g + (l & 3) over the four lanes l & ~3 ..
        // (as in the forward), then the lanes 4 apart add theirs
        float k0 = odd ? p1 : p0, k1 = odd ? p3 : p2;
        k0 += __shfl_xor_sync(kFull, odd ? p0 : p1, 1);
        k1 += __shfl_xor_sync(kFull, odd ? p2 : p3, 1);
        float a = high ? k1 : k0;
        a += __shfl_xor_sync(kFull, high ? k0 : k1, 2);
        a += __shfl_xor_sync(kFull, a, 4);
        st_async_if(l < 4, part_wr + kSlotBytes * (step & 1) + 4 * rr * N * U, a, bar_rem + 8 * (step & 1));
      }
    }
    __syncthreads();  // the chunk's cotangents are all in dg_s
    for (int i = j; i < R * n * 4 * U4; i += kThreads) {  // this CTA's columns, 16 bytes a store
      const int p = i % U4, qq = (i / U4) % 4, rt = i / (4 * U4);
      const int rr = rt / n, tt = rt - rr * n;
      if (!valid(rr)) continue;
      reinterpret_cast<float4*>(dgates + (static_cast<size_t>(row_of(rr)) * t_len + t0 + tt) * G4 + qq * H +
                                r * U)[p] = reinterpret_cast<const float4*>(dg_s + (rr * kChunk + tt) * C + qq * U)[p];
    }
    cp_async_wait_all();
    __syncthreads();
  }
  if (cell && q == 0) {  // the last step's partials are dh0
    const int m = t_len - 1;
    mbar_wait_cluster(bar_loc + 8 * (m & 1), (m >> 1) & 1);
    const unsigned pr = part_rd + kSlotBytes * (m & 1);
    float s = lds32(pr);
#pragma unroll
    for (int src = 1; src < N; ++src) s += lds32(pr + 4 * U * src);
    if (valid(rc)) {
      dh0[row_of(rc) * H + r * U + ul] = s;
      dc0[row_of(rc) * H + r * U + ul] = dc_run;
    }
  }
  // no CTA leaves while its peers' stores to it may be in flight
  cluster_arrive();
  cluster_wait();
}

// ---------------------------------------------------------------------------
// K5 (1/4), any H <= kMaxHidden: one thread per gate column
// ---------------------------------------------------------------------------
// Reads K4's saved gate activations as well (each thread brings its own a
// step ahead, from device memory).  Each gate thread of unit k computes the
// cell's backward redundantly; the recurrent cotangent W_hh dgates is split
// over the four gate blocks and added through shared memory.  Three barriers
// a step.  Where W_hh does not fit shared memory it is read through L2 from
// a transposed copy (w_t, (4H, H)), so that the threads of a warp, which own
// neighbouring units k, read neighbouring addresses.
__global__ void __launch_bounds__(1024) lstm_bwd_walk_kernel(
    const float* __restrict__ gates, const float* __restrict__ cs,
    const float* __restrict__ c0, const float* __restrict__ w_hh,
    const float* __restrict__ w_t, const float* __restrict__ dh_in,
    const float* __restrict__ dhn, const float* __restrict__ dcn,
    float* __restrict__ dgates, float* __restrict__ dh0, float* __restrict__ dc0,
    int t_len, int hid, int whh_in_smem) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int g4 = 4 * hid;
  const int j = threadIdx.x;
  const int q = j / hid;        // gate block of this thread
  const int k = j - q * hid;    // hidden unit of this thread
  const int b = blockIdx.x;
  // padded rows: the reads of a row (fixed k, varying j) are free of bank
  // conflicts across the four gate blocks
  const int ldw = whh_in_smem ? g4 + 1 : g4;
  float* w_s = smem;
  float* act_s = w_s + (whh_in_smem ? hid * ldw : 0);  // [g4]
  float* dg_s = act_s + g4;                             // [g4]
  float* part_s = dg_s + g4;                            // [g4]
  float* cp_s = part_s + g4;                            // [kBwdChunk][hid] c_{t-1}
  float* ct_s = cp_s + kBwdChunk * hid;                 // c_t
  float* dhin_s = ct_s + kBwdChunk * hid;               // dL/dh_t from the head

  if (whh_in_smem) {
    for (int i = j; i < hid * g4; i += blockDim.x) {
      const int r = i / g4;
      w_s[r * ldw + (i - r * g4)] = w_hh[i];
    }
  }
  // W_hh[k, q hid + jj] for jj = 0 .. hid - 1: wk[jj * wk_stride]
  const float* wk = whh_in_smem ? w_s + k * ldw + q * hid : w_t + static_cast<size_t>(q) * hid * hid + k;
  const int wk_stride = whh_in_smem ? 1 : hid;
  float dh_run = dhn[b * hid + k];
  float dc_run = dcn[b * hid + k];
  const size_t row0 = static_cast<size_t>(b) * t_len;
  float act_next = gates[(row0 + t_len - 1) * g4 + j];

  const int n_chunks = (t_len + kBwdChunk - 1) / kBwdChunk;
  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * kBwdChunk;
    const int n = min(kBwdChunk, t_len - t0);
    __syncthreads();
    for (int i = j; i < n * hid; i += blockDim.x) {
      const int tt = i / hid, kk = i - tt * hid;
      const int t = t0 + tt;
      cp_s[i] = t == 0 ? c0[b * hid + kk] : cs[(row0 + t - 1) * hid + kk];
      ct_s[i] = cs[(row0 + t) * hid + kk];
      dhin_s[i] = dh_in[(row0 + t) * hid + kk];
    }
    for (int tt = n - 1; tt >= 0; --tt) {
      const int t = t0 + tt;
      act_s[j] = act_next;
      if (t > 0) act_next = gates[(row0 + t - 1) * g4 + j];
      __syncthreads();
      // cell backward at unit k (each of its four gate threads computes it)
      const float gi = act_s[k], gf = act_s[hid + k];
      const float gg = act_s[2 * hid + k], go = act_s[3 * hid + k];
      const float dh = dh_run + dhin_s[tt * hid + k];
      const float tc = tanhf(ct_s[tt * hid + k]);
      const float dc = dc_run + dh * go * (1.0f - tc * tc);
      float dg;
      if (q == 0) {
        dg = dc * gg * gi * (1.0f - gi);
      } else if (q == 1) {
        dg = dc * cp_s[tt * hid + k] * gf * (1.0f - gf);
      } else if (q == 2) {
        dg = dc * gi * (1.0f - gg * gg);
      } else {
        dg = dh * tc * go * (1.0f - go);
      }
      dc_run = dc * gf;
      dg_s[j] = dg;
      dgates[(row0 + t) * g4 + j] = dg;
      __syncthreads();
      // dh_{t-1}[k] = sum_j W_hh[k, j] dgates[j], split over the gate blocks
      const float* dgq = dg_s + q * hid;
      float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
      int jj = 0;
      for (; jj + 4 <= hid; jj += 4) {
        p0 += wk[(jj + 0) * wk_stride] * dgq[jj + 0];
        p1 += wk[(jj + 1) * wk_stride] * dgq[jj + 1];
        p2 += wk[(jj + 2) * wk_stride] * dgq[jj + 2];
        p3 += wk[(jj + 3) * wk_stride] * dgq[jj + 3];
      }
      for (; jj < hid; ++jj) p0 += wk[jj * wk_stride] * dgq[jj];
      part_s[j] = (p0 + p1) + (p2 + p3);
      __syncthreads();
      dh_run = (part_s[k] + part_s[hid + k]) + (part_s[2 * hid + k] + part_s[3 * hid + k]);
    }
  }
  if (q == 0) {
    dh0[b * hid + k] = dh_run;
    dc0[b * hid + k] = dc_run;
  }
}

// ---------------------------------------------------------------------------
// K5 (2/4): weight-gradient partial sums over one slice of rows r = (b, t)
//   acc[a][j] = sum_r A[r][a] dgates[r][j],  A[r] = [h_{t-1} | seq_t | 1]
// ---------------------------------------------------------------------------
// A block owns kColTile gate columns and all rows of A; thread (tx, ty) owns
// columns 4 tx .. 4 tx + 3 and the rows 4 (ty + ny m) .. + 3 for m < kAIt:
// 16 products for every two float4 read from shared memory.  blockDim =
// (16, ny) with kAIt ny >= ceil(na / 4).  The next pass's tiles arrive by
// cp.async while this pass is summed.  Rows are walked in order, so the sum
// is the same from launch to launch.
template <int kAIt>
__global__ void __launch_bounds__(256) lstm_wgrad_partial_kernel(
    const float* __restrict__ dgates, const float* __restrict__ hs,
    const float* __restrict__ h0, const float* __restrict__ seq,
    float* __restrict__ partial, int batch, int t_len, int hid, int in_dim,
    int rows_per_slice) {
  extern __shared__ float4 smem4[];
  const int g4 = 4 * hid;
  const int na = hid + in_dim + 1;
  const int ny = blockDim.y;
  const int lda = 4 * kAIt * ny;  // >= na, rows of A padded with zeros
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx;
  const int n_threads = blockDim.x * ny;
  const int j0 = blockIdx.x * kColTile;
  const int n_rows = batch * t_len;
  const int r_begin = blockIdx.y * rows_per_slice;
  const int r_end = min(n_rows, r_begin + rows_per_slice);
  float* a_s = reinterpret_cast<float*>(smem4);  // [2][kRowTile][lda]
  float* g_s = a_s + 2 * kRowTile * lda;          // [2][kRowTile][kColTile]

  // A's rows start as zeros, with the 1 of the bias: the padding stays so,
  // and a pass's rows past the slice's end keep finite values that meet zeros
  for (int i = tid; i < 2 * kRowTile * lda; i += n_threads) {
    a_s[i] = i % lda == na - 1 ? 1.0f : 0.0f;
  }
  __syncthreads();

  auto stage = [&](int r0, int buf) {
    const int nr = min(kRowTile, r_end - r0);
    float* ad = a_s + buf * kRowTile * lda;
    const int hw = (hid & 3) == 0 ? 4 : 1;  // floats a copy of h_{t-1} moves
    const int hp = hid / hw;
    for (int i = tid; i < nr * hp; i += n_threads) {
      const int rr = i / hp, a = hw * (i - rr * hp);
      const int r = r0 + rr;
      const int bb = r / t_len, t = r - bb * t_len;
      const float* src = t == 0 ? h0 + bb * hid + a : hs + static_cast<size_t>(r - 1) * hid + a;
      if (hw == 4) {
        cp_async16(ad + rr * lda + a, src);
      } else {
        cp_async4(ad + rr * lda + a, src);
      }
    }
    for (int i = tid; i < nr * in_dim; i += n_threads) {
      const int rr = i / in_dim, a = i - rr * in_dim;
      const int r = r0 + rr;
      const int bb = r / t_len, t = r - bb * t_len;
      cp_async4(ad + rr * lda + hid + a, seq + (static_cast<size_t>(bb) * in_dim + a) * t_len + t);
    }
    float* gd = g_s + buf * kRowTile * kColTile;
    for (int i = tid; i < nr * (kColTile / 4); i += n_threads) {
      const int rr = i / (kColTile / 4), c4 = i - rr * (kColTile / 4);
      const int jc = j0 + 4 * c4;
      float* dst = gd + rr * kColTile + 4 * c4;
      if (jc < g4) {  // g4 is a multiple of 4: a float4 never straddles the edge
        cp_async16(dst, dgates + static_cast<size_t>(r0 + rr) * g4 + jc);
      } else {
        dst[0] = dst[1] = dst[2] = dst[3] = 0.0f;
      }
    }
    // rows past the slice's end add zeros: every pass sums kRowTile rows
    for (int i = nr * kColTile + tid; i < kRowTile * kColTile; i += n_threads) gd[i] = 0.0f;
    cp_async_commit();
  };

  float acc[kAIt][4][4];
#pragma unroll
  for (int m = 0; m < kAIt; ++m) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[m][u][v] = 0.0f;
    }
  }

  if (r_begin < r_end) stage(r_begin, 0);
  cp_async_wait_all();
  __syncthreads();
  int buf = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += kRowTile, buf ^= 1) {
    if (r0 + kRowTile < r_end) stage(r0 + kRowTile, buf ^ 1);
    const float* ab = a_s + buf * kRowTile * lda;
    const float* gb = g_s + buf * kRowTile * kColTile + 4 * tx;
#pragma unroll 4
    for (int rr = 0; rr < kRowTile; ++rr) {
      const float4 g = *reinterpret_cast<const float4*>(gb + rr * kColTile);
#pragma unroll
      for (int m = 0; m < kAIt; ++m) {
        const float4 a = *reinterpret_cast<const float4*>(ab + rr * lda + 4 * (ty + ny * m));
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[m][u][0] = fmaf(av[u], g.x, acc[m][u][0]);
          acc[m][u][1] = fmaf(av[u], g.y, acc[m][u][1]);
          acc[m][u][2] = fmaf(av[u], g.z, acc[m][u][2]);
          acc[m][u][3] = fmaf(av[u], g.w, acc[m][u][3]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  const int jc = j0 + 4 * tx;
  if (jc < g4) {
#pragma unroll
    for (int m = 0; m < kAIt; ++m) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int a = 4 * (ty + ny * m) + u;
        if (a < na) {
          *reinterpret_cast<float4*>(partial + (static_cast<size_t>(blockIdx.y) * na + a) * g4 + jc) =
              make_float4(acc[m][u][0], acc[m][u][1], acc[m][u][2], acc[m][u][3]);
        }
      }
    }
  }
}

// out (cols, rows) = in (rows, cols)^T
__global__ void transpose_kernel(const float* __restrict__ in, float* __restrict__ out,
                                 int rows, int cols) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows * cols) out[i] = in[(i % rows) * cols + i / rows];
}

// K5 (3/4): sum of the slices' partials, slice 0 first
__global__ void lstm_wgrad_final_kernel(const float* __restrict__ partial,
                                        float* __restrict__ out, int n_slices,
                                        int n_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  float s = 0.0f;
  for (int sl = 0; sl < n_slices; ++sl) s += partial[static_cast<size_t>(sl) * n_out + i];
  out[i] = s;
}

// K5 (4/4): dseq[b, i, t] = sum_j w_ih[i, j] dgates[b, t, j].  W_ih sits in
// shared memory; a warp takes two rows of dgates at a time, 16 bytes a load.
__global__ void __launch_bounds__(256) lstm_dseq_kernel(
    const float* __restrict__ dgates, const float* __restrict__ w_ih,
    float* __restrict__ dseq, int n_rows, int t_len, int hid, int in_dim) {
  extern __shared__ float4 smem4[];
  float4* w_s = smem4;  // [in_dim][hid] float4s
  const float4* w4 = reinterpret_cast<const float4*>(w_ih);
  for (int i = threadIdx.x; i < in_dim * hid; i += blockDim.x) w_s[i] = w4[i];
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int n_warps = gridDim.x * (blockDim.x / 32);
  const int pairs = (n_rows + 1) / 2;
  for (int pr = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; pr < pairs; pr += n_warps) {
    const int r0 = 2 * pr;
    const int r1 = min(r0 + 1, n_rows - 1);
    const float4* g0 = reinterpret_cast<const float4*>(dgates + static_cast<size_t>(r0) * 4 * hid);
    const float4* g1 = reinterpret_cast<const float4*>(dgates + static_cast<size_t>(r1) * 4 * hid);
    float acc0[kMaxIn], acc1[kMaxIn];
#pragma unroll
    for (int i = 0; i < kMaxIn; ++i) acc0[i] = acc1[i] = 0.0f;
    for (int c = lane; c < hid; c += 32) {  // a row of 4 hid floats is hid float4s
      const float4 a = g0[c], d = g1[c];
#pragma unroll
      for (int i = 0; i < kMaxIn; ++i) {
        if (i < in_dim) {
          const float4 w = w_s[i * hid + c];
          acc0[i] += (w.x * a.x + w.y * a.y) + (w.z * a.z + w.w * a.w);
          acc1[i] += (w.x * d.x + w.y * d.y) + (w.z * d.z + w.w * d.w);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxIn; ++i) {
      if (i < in_dim) {
        float v0 = acc0[i], v1 = acc1[i];
        for (int off = 16; off > 0; off >>= 1) {
          v0 += __shfl_xor_sync(0xffffffffu, v0, off);
          v1 += __shfl_xor_sync(0xffffffffu, v1, off);
        }
        if (lane == 0) {
          const int b0 = r0 / t_len, b1 = r1 / t_len;
          dseq[(static_cast<size_t>(b0) * in_dim + i) * t_len + (r0 - b0 * t_len)] = v0;
          dseq[(static_cast<size_t>(b1) * in_dim + i) * t_len + (r1 - b1 * t_len)] = v1;
        }
      }
    }
  }
}

int fwd_smem_floats(int hid, int in_dim, int out_ch, bool whh_in_smem) {
  return (whh_in_smem ? hid * 4 * hid : 0) + hid + 4 * hid + kFwdChunk * (hid + 1) +
         (in_dim + out_ch) * kFwdChunk;
}

int fwd_fast_smem_floats(int hid, int in_dim, int out_ch, bool save) {
  return 2 * hid + kFwdChunk * (hid + 4) + (save ? kFwdChunk * (hid + 4 + 4 * (hid + 8)) : 0) +
         2 * (in_dim + out_ch) * kFwdChunk;
}

int bwd_smem_floats(int hid, bool whh_in_smem) {
  return (whh_in_smem ? hid * (4 * hid + 1) : 0) + 3 * 4 * hid + 3 * kBwdChunk * hid;
}

int bwd_fast_smem_floats(int hid) {
  return 3 * kBwdChunk * 4 * (hid + 8) + 2 * (kBwdChunk + 1) * hid + 4 * kBwdChunk * hid;
}

int fwd_cluster_smem_floats(int hid, int n, int rows, int in_dim, int out_ch, bool save) {
  const int u = hid / n;
  const int chunk = kFwdChunk / rows;
  return rows * (2 * chunk * (hid + 4) + (save ? chunk * (u + 4 * (u + 4)) : 0) +
                 2 * (in_dim + out_ch) * chunk);
}

int bwd_cluster_smem_floats(int hid, int n, int rows) {
  const int u = hid / n;
  const int chunk = kBwdChunk / rows;
  return rows * (4 * chunk * 4 * u + 2 * (chunk + 1) * u + 4 * chunk * u + 2 * hid);
}

bool is_fast_width(int hid) { return hid == 16 || hid == 32 || hid == 64; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct FwdArgs {
  const float *seq, *xres, *h0, *c0, *w_ih, *w_hh, *bias, *fc_k, *fc_b;
  float *y, *hn, *cn, *hs, *cs, *gates;
  int batch, t_len, hid, in_dim, out_ch;
  cudaStream_t stream;
};

template <int H, bool kSave, int kIn>
cudaError_t launch_fwd_fast_in(const FwdArgs& a) {
  const int bytes =
      fwd_fast_smem_floats(H, a.in_dim, a.out_ch, kSave) * static_cast<int>(sizeof(float));
  cudaError_t e = allow_smem(lstm_fwd_fast_kernel<H, kSave, kIn>, bytes);
  if (e != cudaSuccess) return e;
  lstm_fwd_fast_kernel<H, kSave, kIn><<<a.batch, 4 * H, bytes, a.stream>>>(
      a.seq, a.xres, a.h0, a.c0, a.w_ih, a.w_hh, a.bias, a.fc_k, a.fc_b, a.y, a.hn, a.cn, a.hs,
      a.cs, a.gates, a.t_len, a.in_dim, a.out_ch);
  return cudaGetLastError();
}

// in_dim 2 (one latent and one audio channel, every shipped model) is fixed
// at compile time; any other takes the kernel that reads it at run time
template <int H, bool kSave>
cudaError_t launch_fwd_fast(const FwdArgs& a) {
  return a.in_dim == 2 ? launch_fwd_fast_in<H, kSave, 2>(a) : launch_fwd_fast_in<H, kSave, 0>(a);
}

// The cluster forward: launched, or with `max_clusters` the most of its
// clusters the card holds at once (cudaOccupancyMaxActiveClusters) instead.
template <int H, int N, int R, bool kSave, int kIn>
cudaError_t launch_fwd_cluster_in(const FwdArgs& a, int* max_clusters) {
  auto kernel = lstm_fwd_cluster_kernel<H, N, R, kSave, kIn>;
  const int bytes =
      fwd_cluster_smem_floats(H, N, R, a.in_dim, a.out_ch, kSave) * static_cast<int>(sizeof(float));
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.batch + R - 1) / R * N);
  cfg.blockDim = dim3(2 * H);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  e = cudaLaunchKernelEx(&cfg, kernel, a.seq, a.xres, a.h0, a.c0, a.w_ih, a.w_hh, a.bias, a.fc_k,
                         a.fc_b, a.y, a.hn, a.cn, a.hs, a.cs, a.gates, a.batch, a.t_len, a.in_dim,
                         a.out_ch);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// (CTAs a cluster, rows a cluster): (8, 1) or (4, 2)
template <bool kSave, int kIn>
cudaError_t launch_fwd_cluster_nr(const FwdArgs& a, int n, int* max_clusters) {
  constexpr int H = kClusterHidden;
  return n == 8 ? launch_fwd_cluster_in<H, 8, 1, kSave, kIn>(a, max_clusters)
                : launch_fwd_cluster_in<H, 4, 2, kSave, kIn>(a, max_clusters);
}

template <bool kSave>
cudaError_t launch_fwd_cluster(const FwdArgs& a, int n, int* max_clusters) {
  return a.in_dim == 2 ? launch_fwd_cluster_nr<kSave, 2>(a, n, max_clusters)
                       : launch_fwd_cluster_nr<kSave, 0>(a, n, max_clusters);
}

bool is_cluster_shape(int n, int rows) { return (n == 8 && rows == 1) || (n == 4 && rows == 2); }

template <bool kSave>
cudaError_t launch_fwd(const FwdArgs& a, bool registers) {
  if (registers) {
    if (!is_fast_width(a.hid) ||
        fwd_fast_smem_floats(a.hid, a.in_dim, a.out_ch, kSave) * 4 > kMaxSmem) {
      return cudaErrorInvalidValue;
    }
    if (a.hid == 16) return launch_fwd_fast<16, kSave>(a);
    if (a.hid == 32) return launch_fwd_fast<32, kSave>(a);
    return launch_fwd_fast<64, kSave>(a);
  }
  bool whh_in_smem = true;
  int bytes = fwd_smem_floats(a.hid, a.in_dim, a.out_ch, true) * static_cast<int>(sizeof(float));
  if (bytes > kMaxSmem) {
    whh_in_smem = false;
    bytes = fwd_smem_floats(a.hid, a.in_dim, a.out_ch, false) * static_cast<int>(sizeof(float));
  }
  cudaError_t e = allow_smem(lstm_fwd_kernel<kSave>, bytes);
  if (e != cudaSuccess) return e;
  lstm_fwd_kernel<kSave><<<a.batch, 4 * a.hid, bytes, a.stream>>>(
      a.seq, a.xres, a.h0, a.c0, a.w_ih, a.w_hh, a.bias, a.fc_k, a.fc_b, a.y, a.hn, a.cn, a.hs,
      a.cs, a.gates, a.t_len, a.hid, a.in_dim, a.out_ch, whh_in_smem ? 1 : 0);
  return cudaGetLastError();
}

struct WalkArgs {
  const float *gates, *cs, *c0, *w_hh, *dh_in, *dhn, *dcn;
  float *dgates, *dh0, *dc0;
  int batch, t_len;
  cudaStream_t stream;
};

template <int H>
cudaError_t launch_walk_fast(const WalkArgs& a) {
  const int bytes = bwd_fast_smem_floats(H) * static_cast<int>(sizeof(float));
  cudaError_t e = allow_smem(lstm_bwd_walk_fast_kernel<H>, bytes);
  if (e != cudaSuccess) return e;
  lstm_bwd_walk_fast_kernel<H><<<a.batch, 4 * H, bytes, a.stream>>>(
      a.gates, a.cs, a.c0, a.w_hh, a.dh_in, a.dhn, a.dcn, a.dgates, a.dh0, a.dc0, a.t_len);
  return cudaGetLastError();
}

// The cluster walk of K5: launched, or with `max_clusters` the most of its
// clusters the card holds at once (cudaOccupancyMaxActiveClusters) instead.
template <int H, int N, int R>
cudaError_t launch_walk_cluster_nr(const WalkArgs& a, int* max_clusters) {
  auto kernel = lstm_bwd_cluster_kernel<H, N, R>;
  const int bytes = bwd_cluster_smem_floats(H, N, R) * static_cast<int>(sizeof(float));
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.batch + R - 1) / R * N);
  cfg.blockDim = dim3(2 * H);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  e = cudaLaunchKernelEx(&cfg, kernel, a.gates, a.cs, a.c0, a.w_hh, a.dh_in, a.dhn, a.dcn, a.dgates,
                         a.dh0, a.dc0, a.batch, a.t_len);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// (CTAs a cluster, rows a cluster): (8, 1) or (4, 2), as the forward
cudaError_t launch_walk_cluster(const WalkArgs& a, int n, int* max_clusters) {
  constexpr int H = kClusterHidden;
  return n == 8 ? launch_walk_cluster_nr<H, 8, 1>(a, max_clusters)
                : launch_walk_cluster_nr<H, 4, 2>(a, max_clusters);
}

struct WgradArgs {
  const float *dgates, *hs, *h0, *seq;
  float* partial;
  int batch, t_len, hid, in_dim, n_slices, rows_per_slice;
  cudaStream_t stream;
};

template <int kAIt>
cudaError_t launch_wgrad(const WgradArgs& a) {
  const int g4 = 4 * a.hid;
  const int n_groups = (a.hid + a.in_dim + 1 + 3) / 4;
  const int ny = (n_groups + kAIt - 1) / kAIt;
  const int bytes =
      2 * kRowTile * (4 * kAIt * ny + kColTile) * static_cast<int>(sizeof(float));
  cudaError_t e = allow_smem(lstm_wgrad_partial_kernel<kAIt>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((g4 + kColTile - 1) / kColTile, a.n_slices);
  dim3 block(kColTile / 4, ny);
  lstm_wgrad_partial_kernel<kAIt><<<grid, block, bytes, a.stream>>>(
      a.dgates, a.hs, a.h0, a.seq, a.partial, a.batch, a.t_len, a.hid, a.in_dim,
      a.rows_per_slice);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int lstm_max_in_dim() { return kMaxIn; }
int lstm_max_hidden() { return kMaxHidden; }

// K3 (hs == cs == gates == nullptr) or K4, on the caller's plan: cluster >
// 0, the cluster forward, `cluster` CTAs for `cluster_rows` batch rows (8
// for 1 or 4 for 2, H 160 only); registers != 0, the register-resident walk
// (H 16/32/64 only); both 0, the generic walk.  A plan the kernels lack is
// refused.  Returns a cudaError_t.
int lstm_forward(const float* seq, const float* xres, const float* h0, const float* c0,
                 const float* w_ih, const float* w_hh, const float* bias,
                 const float* fc_k, const float* fc_b, float* y, float* hn, float* cn,
                 float* hs, float* cs, float* gates, int batch, int t_len, int hid,
                 int in_dim, int out_ch, int registers, int cluster, int cluster_rows,
                 void* stream) {
  if (hid < 1 || hid > kMaxHidden || in_dim < 1 || in_dim > kMaxIn || out_ch < 1 ||
      t_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdArgs a{seq, xres, h0, c0, w_ih, w_hh, bias, fc_k, fc_b, y, hn, cn, hs, cs, gates,
                  batch, t_len, hid, in_dim, out_ch, static_cast<cudaStream_t>(stream)};
  if (cluster != 0) {
    if (registers != 0 || hid != kClusterHidden || !is_cluster_shape(cluster, cluster_rows)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(hs != nullptr ? launch_fwd_cluster<true>(a, cluster, nullptr)
                                          : launch_fwd_cluster<false>(a, cluster, nullptr));
  }
  return static_cast<int>(hs != nullptr ? launch_fwd<true>(a, registers != 0)
                                        : launch_fwd<false>(a, registers != 0));
}

// The most clusters of `cluster` CTAs for `cluster_rows` rows of the H 160
// forward (K4 with save, K3 without) that the card holds at once, in *out.
// Returns a cudaError_t.
int lstm_cluster_occupancy(int cluster, int cluster_rows, int in_dim, int out_ch, int save, int* out) {
  if (!is_cluster_shape(cluster, cluster_rows) || in_dim < 1 || in_dim > kMaxIn || out_ch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdArgs a{};
  a.batch = 1;
  a.t_len = 1;
  a.hid = kClusterHidden;
  a.in_dim = in_dim;
  a.out_ch = out_ch;
  return static_cast<int>(save != 0 ? launch_fwd_cluster<true>(a, cluster, out)
                                    : launch_fwd_cluster<false>(a, cluster, out));
}

// The most clusters of `cluster` CTAs for `cluster_rows` rows of the H 160
// backward walk (K5) that the card holds at once, in *out.  Returns a
// cudaError_t.
int lstm_bwd_cluster_occupancy(int cluster, int cluster_rows, int* out) {
  if (!is_cluster_shape(cluster, cluster_rows)) return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a{};
  a.batch = 1;
  a.t_len = 1;
  return static_cast<int>(launch_walk_cluster(a, cluster, out));
}

// K5, on the caller's plan: cluster > 0, the cluster walk, `cluster` CTAs
// for `cluster_rows` batch rows (8 for 1 or 4 for 2, H 160 only); registers
// != 0, the register-resident walk (H 16/32/64 only); both 0, the generic
// walk.  A plan the kernels lack is refused.  gates: K4's saved
// activations.  dgates: (batch * t_len, 4H) scratch; w_hh_t: (4H, H)
// scratch, needed only by the generic walk (may be null otherwise);
// partial: (n_slices, na, 4H) scratch; dwcat: (na, 4H) out, rows
// [dW_hh (H) | dW_ih (in_dim) | db]; dseq (B, in_dim, T), dh0/dc0 (B, H) out.
// na = H + in_dim + 1.
int lstm_backward(const float* seq, const float* hs, const float* cs, const float* gates,
                  const float* h0, const float* c0, const float* w_ih, const float* w_hh,
                  const float* dh_in, const float* dhn, const float* dcn, float* dgates,
                  float* w_hh_t, float* partial, float* dwcat, float* dseq, float* dh0, float* dc0,
                  int batch, int t_len, int hid, int in_dim, int n_slices,
                  int rows_per_slice, int registers, int cluster, int cluster_rows, void* stream) {
  if (hid < 1 || hid > kMaxHidden || in_dim < 1 || in_dim > kMaxIn || t_len < 1 ||
      (registers != 0 && !is_fast_width(hid)) ||
      (cluster != 0 && (registers != 0 || hid != kClusterHidden || !is_cluster_shape(cluster, cluster_rows)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_rows = batch * t_len;
  if (static_cast<long long>(n_slices) * rows_per_slice < n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  const WalkArgs wk{gates, cs, c0, w_hh, dh_in, dhn, dcn, dgates, dh0, dc0, batch, t_len, s};
  if (cluster != 0) {
    e = launch_walk_cluster(wk, cluster, nullptr);
  } else if (registers != 0) {
    e = hid == 16 ? launch_walk_fast<16>(wk)
                  : hid == 32 ? launch_walk_fast<32>(wk) : launch_walk_fast<64>(wk);
  } else {
    bool whh_in_smem = true;
    int bytes = bwd_smem_floats(hid, true) * static_cast<int>(sizeof(float));
    if (bytes > kMaxSmem) {
      whh_in_smem = false;
      bytes = bwd_smem_floats(hid, false) * static_cast<int>(sizeof(float));
    }
    e = allow_smem(lstm_bwd_walk_kernel, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!whh_in_smem) {
      if (w_hh_t == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      transpose_kernel<<<(4 * hid * hid + 255) / 256, 256, 0, s>>>(w_hh, w_hh_t, hid, 4 * hid);
    }
    lstm_bwd_walk_kernel<<<batch, 4 * hid, bytes, s>>>(
        gates, cs, c0, w_hh, w_hh_t, dh_in, dhn, dcn, dgates, dh0, dc0, t_len, hid,
        whh_in_smem ? 1 : 0);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return static_cast<int>(e);

  const int g4 = 4 * hid;
  const int na = hid + in_dim + 1;
  const WgradArgs wa{dgates, hs, h0, seq, partial, batch, t_len, hid, in_dim, n_slices,
                     rows_per_slice, s};
  // accumulators for this launch's na: 4-row groups of A over at most 16 thread rows
  const int a_it = ((na + 3) / 4 + 15) / 16;
  switch (a_it) {
    case 1: e = launch_wgrad<1>(wa); break;
    case 2: e = launch_wgrad<2>(wa); break;
    case 3: e = launch_wgrad<3>(wa); break;
    case 4: e = launch_wgrad<4>(wa); break;
    default: e = launch_wgrad<kMaxAIt>(wa); break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = na * g4;
  lstm_wgrad_final_kernel<<<(n_out + 255) / 256, 256, 0, s>>>(partial, dwcat, n_slices, n_out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // each warp takes about four pairs of rows; W_ih is at most 16 x 1024 floats
  const int dseq_blocks = min(4096, (n_rows + 63) / 64);
  const int dseq_bytes = in_dim * g4 * static_cast<int>(sizeof(float));
  e = allow_smem(lstm_dseq_kernel, dseq_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  lstm_dseq_kernel<<<dseq_blocks, 256, dseq_bytes, s>>>(
      dgates, w_ih, dseq, n_rows, t_len, hid, in_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
