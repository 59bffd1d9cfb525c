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
// Which kernels: H 16, 32 and 64 take the fast walks below (W_hh in
// registers, one barrier a step, activations by ex2.approx / rcp.approx);
// every other H <= 256 takes the generic walks (one thread per gate column,
// W_hh in shared memory up to H 64-odd and through L2 above, libm
// activations, two barriers a step forward and three backward: 1.2 / 1.5 ms
// for K4 / K5 at H 64; at H 160, the shipped chorus model's width, K3 11.4,
// K4 4.8, K5 8.1 ms).  640 threads x 160 weights do not fit the register
// file, so H 160 cannot take the fast design as it is.
//
// Registers and spills (ptxas -v for sm_90a), fast walks at
// H 64 / 32 / 16: forward without saves (in_dim 2) 120 / 64 / 72, with saves
// 160 / 72 / 96, in_dim read at run time 126-169; backward 128 / 116 / 95;
// no spills but 8-12 bytes in the H 32 forward with saves.  Generic forward
// 58-64, backward 32; partial sums 43 / 76 / 106 / 124 / 128 for kAIt 1 .. 5;
// dseq 64.  No kernel spills otherwise.
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
// of that distance.
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

template <bool kSave>
cudaError_t launch_fwd(const FwdArgs& a, bool fast) {
  if (fast && fwd_fast_smem_floats(a.hid, a.in_dim, a.out_ch, kSave) * 4 <= kMaxSmem) {
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
// 1 where the register-resident walks serve this width
int lstm_fast_width(int hid) { return is_fast_width(hid) ? 1 : 0; }

// K3 (hs == cs == gates == nullptr) or K4.  allow_fast == 0 keeps a width
// of the fast path on the generic kernels (for comparison).  Returns a
// cudaError_t.
int lstm_forward(const float* seq, const float* xres, const float* h0, const float* c0,
                 const float* w_ih, const float* w_hh, const float* bias,
                 const float* fc_k, const float* fc_b, float* y, float* hn, float* cn,
                 float* hs, float* cs, float* gates, int batch, int t_len, int hid,
                 int in_dim, int out_ch, int allow_fast, void* stream) {
  if (hid < 1 || hid > kMaxHidden || in_dim < 1 || in_dim > kMaxIn || out_ch < 1 ||
      t_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdArgs a{seq, xres, h0, c0, w_ih, w_hh, bias, fc_k, fc_b, y, hn, cn, hs, cs, gates,
                  batch, t_len, hid, in_dim, out_ch, static_cast<cudaStream_t>(stream)};
  const bool fast = allow_fast != 0 && is_fast_width(hid);
  return static_cast<int>(hs != nullptr ? launch_fwd<true>(a, fast) : launch_fwd<false>(a, fast));
}

// K5.  gates: K4's saved activations.  dgates: (batch * t_len, 4H) scratch;
// w_hh_t: (4H, H) scratch, needed only off the fast path (may be null on it);
// partial: (n_slices, na, 4H) scratch; dwcat: (na, 4H) out, rows
// [dW_hh (H) | dW_ih (in_dim) | db]; dseq (B, in_dim, T), dh0/dc0 (B, H) out.
// na = H + in_dim + 1.
int lstm_backward(const float* seq, const float* hs, const float* cs, const float* gates,
                  const float* h0, const float* c0, const float* w_ih, const float* w_hh,
                  const float* dh_in, const float* dhn, const float* dcn, float* dgates,
                  float* w_hh_t, float* partial, float* dwcat, float* dseq, float* dh0, float* dc0,
                  int batch, int t_len, int hid, int in_dim, int n_slices,
                  int rows_per_slice, int allow_fast, void* stream) {
  if (hid < 1 || hid > kMaxHidden || in_dim < 1 || in_dim > kMaxIn || t_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_rows = batch * t_len;
  if (static_cast<long long>(n_slices) * rows_per_slice < n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (allow_fast != 0 && is_fast_width(hid)) {
    const WalkArgs a{gates, cs, c0, w_hh, dh_in, dhn, dcn, dgates, dh0, dc0, batch, t_len, s};
    e = hid == 16 ? launch_walk_fast<16>(a)
                  : hid == 32 ? launch_walk_fast<32>(a) : launch_walk_fast<64>(a);
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
