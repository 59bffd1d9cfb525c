// The conditional LSTM effect model for Hopper (sm_90a): the no-gradient
// forward (K3), the training forward that also saves every step's (h, c)
// (K4) and the reverse-time backward (K5).  Plain C interface, loaded with
// ctypes by mod_extraction_tpu_torch/ops/lstm_kernels.py.
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
// fc_k (H, out_ch), fc_b (out_ch), y (B, out_ch, T), saved hs/cs (B, T, H).
//
// What bounds them on the H100: at the main path's shapes (B 32, H 64,
// T 1024) a launch does ~1.1 GFLOP of float32 work (0.017 ms at 67
// TFLOP/s) and moves ~17 MB (5 us), but every step depends on the one
// before, and the batch gives only 32 independent recurrences.  The kernels
// run for T times the latency of one step: they are latency-bound.
//
// Design: one block per batch row, one thread per gate row (4H threads).
// W_hh stays in shared memory for the whole walk when it fits (H <= 64 at
// 64 KB; above that it is read through L2), W_ih's row and the bias stay in
// registers, and h is broadcast from shared memory.  The input projection
// W_ih [latent; x] is computed in the step.  A forward step is two block
// barriers: gates, then the c/h update by H threads.  Inputs are staged a
// chunk of steps at a time with coalesced loads; the fc head does not feed
// the recurrence, so the chunk's h are kept in a ring in shared memory and
// the head runs once per chunk across all threads.  The TPU kernel's
// batch-on-lanes padding, time-chunk grid and per-chunk entry states are
// Mosaic layout and have no counterpart: one block walks the whole T.
//
// K5 walks time in reverse and recomputes each step's gates from the saved
// h_{t-1}, as the TPU kernel does.  Each gate thread of unit k recomputes
// the cell's backward redundantly, so a step is three barriers: gates,
// gate cotangents, and the recurrent cotangent W_hh dgates split over the
// four gate blocks.  The TPU kernel accumulates the weight gradients in
// resident output blocks across its sequential grid; blocks on the card run
// in parallel, so the walk writes the gate cotangents (B, T, 4H) and two
// more kernels reduce them in a fixed order (per-slice partial sums, then
// the sum of the slices): dW_hh, dW_ih and db are the same bits from run to
// run, with no float atomics.  A last kernel forms dseq = W_ih dgates.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxIn = 16;          // in_dim = latent_dim + in_ch
constexpr int kMaxHidden = 256;     // 4H threads per block
constexpr int kFwdChunk = 64;       // forward steps staged per pass
constexpr int kBwdChunk = 32;       // backward steps staged per pass
constexpr int kMaxSmem = 232448;    // a block's shared memory on sm_90
constexpr int kColTile = 32;        // wgrad: gate columns per block
constexpr int kRowTile = 32;        // wgrad: rows staged per pass
constexpr int kRowGroups = 8;       // wgrad: 256 threads = 32 x 8
constexpr int kMaxA = kMaxHidden + kMaxIn + 1;
constexpr int kMaxAcc = (kMaxA + kRowGroups - 1) / kRowGroups;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// ---------------------------------------------------------------------------
// K3 / K4: forward walk (kSave: also write every step's h and c)
// ---------------------------------------------------------------------------
template <bool kSave>
__global__ void __launch_bounds__(1024) lstm_fwd_kernel(
    const float* __restrict__ seq, const float* __restrict__ xres,
    const float* __restrict__ h0, const float* __restrict__ c0,
    const float* __restrict__ w_ih, const float* __restrict__ w_hh,
    const float* __restrict__ bias, const float* __restrict__ fc_k,
    const float* __restrict__ fc_b, float* __restrict__ y,
    float* __restrict__ hn, float* __restrict__ cn,
    float* __restrict__ hs, float* __restrict__ cs,
    int t_len, int hid, int in_dim, int out_ch, int whh_in_smem) {
  extern __shared__ float smem[];
  const int g4 = 4 * hid;
  const int j = threadIdx.x;  // gate row
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
      act_s[j] = gate == 2 ? tanhf(a) : sigmoid_f(a);
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
// K5 (1/4): reverse walk -> gate cotangents, dh0, dc0
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(1024) lstm_bwd_walk_kernel(
    const float* __restrict__ seq, const float* __restrict__ hs,
    const float* __restrict__ cs, const float* __restrict__ h0,
    const float* __restrict__ c0, const float* __restrict__ w_ih,
    const float* __restrict__ w_hh, const float* __restrict__ bias,
    const float* __restrict__ dh_in, const float* __restrict__ dhn,
    const float* __restrict__ dcn, float* __restrict__ dgates,
    float* __restrict__ dh0, float* __restrict__ dc0,
    int t_len, int hid, int in_dim, int whh_in_smem) {
  extern __shared__ float smem[];
  const int g4 = 4 * hid;
  const int j = threadIdx.x;
  const int q = j / hid;        // gate block of this thread
  const int k = j - q * hid;    // hidden unit of this thread
  const int b = blockIdx.x;
  // padded rows: row reads (fixed k, varying j) and column reads (fixed j,
  // varying k) are both free of bank conflicts
  const int ldw = whh_in_smem ? g4 + 1 : g4;
  float* w_s = smem;
  float* act_s = w_s + (whh_in_smem ? hid * ldw : 0);  // [g4]
  float* dg_s = act_s + g4;                             // [g4]
  float* part_s = dg_s + g4;                            // [g4]
  float* hp_s = part_s + g4;                            // [kBwdChunk][hid] h_{t-1}
  float* cp_s = hp_s + kBwdChunk * hid;                 // c_{t-1}
  float* ct_s = cp_s + kBwdChunk * hid;                 // c_t
  float* dhin_s = ct_s + kBwdChunk * hid;               // dL/dh_t from the head
  float* seq_s = dhin_s + kBwdChunk * hid;              // [in_dim][kBwdChunk]

  if (whh_in_smem) {
    for (int i = j; i < hid * g4; i += blockDim.x) {
      const int r = i / g4;
      w_s[r * ldw + (i - r * g4)] = w_hh[i];
    }
  }
  const float* W = whh_in_smem ? w_s : w_hh;
  float wih[kMaxIn];
#pragma unroll
  for (int i = 0; i < kMaxIn; ++i) wih[i] = i < in_dim ? w_ih[i * g4 + j] : 0.0f;
  const float bj = bias[j];
  float dh_run = dhn[b * hid + k];
  float dc_run = dcn[b * hid + k];
  const size_t row0 = static_cast<size_t>(b) * t_len;

  const int n_chunks = (t_len + kBwdChunk - 1) / kBwdChunk;
  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * kBwdChunk;
    const int n = min(kBwdChunk, t_len - t0);
    __syncthreads();
    for (int i = j; i < n * hid; i += blockDim.x) {
      const int tt = i / hid, kk = i - tt * hid;
      const int t = t0 + tt;
      hp_s[i] = t == 0 ? h0[b * hid + kk] : hs[(row0 + t - 1) * hid + kk];
      cp_s[i] = t == 0 ? c0[b * hid + kk] : cs[(row0 + t - 1) * hid + kk];
      ct_s[i] = cs[(row0 + t) * hid + kk];
      dhin_s[i] = dh_in[(row0 + t) * hid + kk];
    }
    for (int i = j; i < in_dim * kBwdChunk; i += blockDim.x) {
      const int ch = i / kBwdChunk, tt = i - ch * kBwdChunk;
      seq_s[i] = tt < n ? seq[(static_cast<size_t>(b) * in_dim + ch) * t_len + t0 + tt] : 0.0f;
    }
    __syncthreads();
    for (int tt = n - 1; tt >= 0; --tt) {
      // gates of step t, recomputed from h_{t-1}
      float a0 = bj, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxIn; ++i) {
        if (i < in_dim) a0 += wih[i] * seq_s[i * kBwdChunk + tt];
      }
      const float* hp = hp_s + tt * hid;
      int kk = 0;
      for (; kk + 4 <= hid; kk += 4) {
        a0 += W[(kk + 0) * ldw + j] * hp[kk + 0];
        a1 += W[(kk + 1) * ldw + j] * hp[kk + 1];
        a2 += W[(kk + 2) * ldw + j] * hp[kk + 2];
        a3 += W[(kk + 3) * ldw + j] * hp[kk + 3];
      }
      for (; kk < hid; ++kk) a0 += W[kk * ldw + j] * hp[kk];
      const float a = (a0 + a1) + (a2 + a3);
      act_s[j] = q == 2 ? tanhf(a) : sigmoid_f(a);
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
      dgates[(row0 + t0 + tt) * g4 + j] = dg;
      __syncthreads();
      // dh_{t-1}[k] = sum_j W_hh[k, j] dgates[j], split over the gate blocks
      const float* wk = W + k * ldw + q * hid;
      const float* dgq = dg_s + q * hid;
      float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
      int jj = 0;
      for (; jj + 4 <= hid; jj += 4) {
        p0 += wk[jj + 0] * dgq[jj + 0];
        p1 += wk[jj + 1] * dgq[jj + 1];
        p2 += wk[jj + 2] * dgq[jj + 2];
        p3 += wk[jj + 3] * dgq[jj + 3];
      }
      for (; jj < hid; ++jj) p0 += wk[jj] * dgq[jj];
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
__global__ void __launch_bounds__(256) lstm_wgrad_partial_kernel(
    const float* __restrict__ dgates, const float* __restrict__ hs,
    const float* __restrict__ h0, const float* __restrict__ seq,
    float* __restrict__ partial, int batch, int t_len, int hid, int in_dim,
    int rows_per_slice) {
  __shared__ float a_s[kRowTile * kMaxA];
  __shared__ float g_s[kRowTile * kColTile];
  const int g4 = 4 * hid;
  const int na = hid + in_dim + 1;
  const int tx = threadIdx.x % kColTile, ty = threadIdx.x / kColTile;
  const int j = blockIdx.x * kColTile + tx;
  const int n_rows = batch * t_len;
  const int r_begin = blockIdx.y * rows_per_slice;
  const int r_end = min(n_rows, r_begin + rows_per_slice);

  float acc[kMaxAcc];
#pragma unroll
  for (int m = 0; m < kMaxAcc; ++m) acc[m] = 0.0f;

  for (int r0 = r_begin; r0 < r_end; r0 += kRowTile) {
    const int nr = min(kRowTile, r_end - r0);
    for (int i = threadIdx.x; i < nr * na; i += blockDim.x) {
      const int rr = i / na, a = i - rr * na;
      const int r = r0 + rr;
      const int bb = r / t_len, t = r - bb * t_len;
      float v;
      if (a < hid) {
        v = t == 0 ? h0[bb * hid + a] : hs[static_cast<size_t>(r - 1) * hid + a];
      } else if (a < hid + in_dim) {
        v = seq[(static_cast<size_t>(bb) * in_dim + (a - hid)) * t_len + t];
      } else {
        v = 1.0f;
      }
      a_s[rr * na + a] = v;
    }
    for (int i = threadIdx.x; i < nr * kColTile; i += blockDim.x) {
      const int rr = i / kColTile, cc = i - rr * kColTile;
      const int jc = blockIdx.x * kColTile + cc;
      g_s[i] = jc < g4 ? dgates[static_cast<size_t>(r0 + rr) * g4 + jc] : 0.0f;
    }
    __syncthreads();
    for (int rr = 0; rr < nr; ++rr) {
      const float g = g_s[rr * kColTile + tx];
      const float* ar = a_s + rr * na;
#pragma unroll
      for (int m = 0; m < kMaxAcc; ++m) {
        const int a = ty + kRowGroups * m;
        if (a < na) acc[m] += ar[a] * g;
      }
    }
    __syncthreads();
  }
  if (j < g4) {
#pragma unroll
    for (int m = 0; m < kMaxAcc; ++m) {
      const int a = ty + kRowGroups * m;
      if (a < na) partial[(static_cast<size_t>(blockIdx.y) * na + a) * g4 + j] = acc[m];
    }
  }
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

// K5 (4/4): dseq[b, i, t] = sum_j w_ih[i, j] dgates[b, t, j], a warp per row
__global__ void __launch_bounds__(256) lstm_dseq_kernel(
    const float* __restrict__ dgates, const float* __restrict__ w_ih,
    float* __restrict__ dseq, int n_rows, int t_len, int hid, int in_dim) {
  const int g4 = 4 * hid;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (r >= n_rows) return;
  float acc[kMaxIn];
#pragma unroll
  for (int i = 0; i < kMaxIn; ++i) acc[i] = 0.0f;
  for (int jj = lane; jj < g4; jj += 32) {
    const float g = dgates[static_cast<size_t>(r) * g4 + jj];
#pragma unroll
    for (int i = 0; i < kMaxIn; ++i) {
      if (i < in_dim) acc[i] += w_ih[i * g4 + jj] * g;
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxIn; ++i) {
    if (i < in_dim) {
      float v = acc[i];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[i] = v;
    }
  }
  if (lane == 0) {
    const int bb = r / t_len, t = r - bb * t_len;
    for (int i = 0; i < in_dim; ++i) {
      dseq[(static_cast<size_t>(bb) * in_dim + i) * t_len + t] = acc[i];
    }
  }
}

int fwd_smem_floats(int hid, int in_dim, int out_ch, bool whh_in_smem) {
  return (whh_in_smem ? hid * 4 * hid : 0) + hid + 4 * hid + kFwdChunk * (hid + 1) +
         (in_dim + out_ch) * kFwdChunk;
}

int bwd_smem_floats(int hid, int in_dim, bool whh_in_smem) {
  return (whh_in_smem ? hid * (4 * hid + 1) : 0) + 3 * 4 * hid + 4 * kBwdChunk * hid +
         in_dim * kBwdChunk;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

int lstm_max_in_dim() { return kMaxIn; }
int lstm_max_hidden() { return kMaxHidden; }

// K3 (hs == cs == nullptr) or K4.  Returns a cudaError_t.
int lstm_forward(const float* seq, const float* xres, const float* h0, const float* c0,
                 const float* w_ih, const float* w_hh, const float* bias,
                 const float* fc_k, const float* fc_b, float* y, float* hn, float* cn,
                 float* hs, float* cs, int batch, int t_len, int hid, int in_dim,
                 int out_ch, void* stream) {
  if (hid < 1 || hid > kMaxHidden || in_dim < 1 || in_dim > kMaxIn || out_ch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bool whh_in_smem = true;
  int bytes = fwd_smem_floats(hid, in_dim, out_ch, true) * static_cast<int>(sizeof(float));
  if (bytes > kMaxSmem) {
    whh_in_smem = false;
    bytes = fwd_smem_floats(hid, in_dim, out_ch, false) * static_cast<int>(sizeof(float));
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (hs != nullptr) {
    e = allow_smem(lstm_fwd_kernel<true>, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    lstm_fwd_kernel<true><<<batch, 4 * hid, bytes, s>>>(
        seq, xres, h0, c0, w_ih, w_hh, bias, fc_k, fc_b, y, hn, cn, hs, cs, t_len, hid,
        in_dim, out_ch, whh_in_smem ? 1 : 0);
  } else {
    e = allow_smem(lstm_fwd_kernel<false>, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    lstm_fwd_kernel<false><<<batch, 4 * hid, bytes, s>>>(
        seq, xres, h0, c0, w_ih, w_hh, bias, fc_k, fc_b, y, hn, cn, nullptr, nullptr,
        t_len, hid, in_dim, out_ch, whh_in_smem ? 1 : 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5.  dgates: (batch * t_len, 4H) scratch; partial: (n_slices, na, 4H)
// scratch; dwcat: (na, 4H) out, rows [dW_hh (H) | dW_ih (in_dim) | db];
// dseq (B, in_dim, T), dh0/dc0 (B, H) out.  na = H + in_dim + 1.
int lstm_backward(const float* seq, const float* hs, const float* cs, const float* h0,
                  const float* c0, const float* w_ih, const float* w_hh,
                  const float* bias, const float* dh_in, const float* dhn,
                  const float* dcn, float* dgates, float* partial, float* dwcat,
                  float* dseq, float* dh0, float* dc0, int batch, int t_len, int hid,
                  int in_dim, int n_slices, int rows_per_slice, void* stream) {
  if (hid < 1 || hid > kMaxHidden || in_dim < 1 || in_dim > kMaxIn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_rows = batch * t_len;
  if (static_cast<long long>(n_slices) * rows_per_slice < n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bool whh_in_smem = true;
  int bytes = bwd_smem_floats(hid, in_dim, true) * static_cast<int>(sizeof(float));
  if (bytes > kMaxSmem) {
    whh_in_smem = false;
    bytes = bwd_smem_floats(hid, in_dim, false) * static_cast<int>(sizeof(float));
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = allow_smem(lstm_bwd_walk_kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  lstm_bwd_walk_kernel<<<batch, 4 * hid, bytes, s>>>(
      seq, hs, cs, h0, c0, w_ih, w_hh, bias, dh_in, dhn, dcn, dgates, dh0, dc0, t_len, hid,
      in_dim, whh_in_smem ? 1 : 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int g4 = 4 * hid;
  const int na = hid + in_dim + 1;
  dim3 grid((g4 + kColTile - 1) / kColTile, n_slices);
  lstm_wgrad_partial_kernel<<<grid, kColTile * kRowGroups, 0, s>>>(
      dgates, hs, h0, seq, partial, batch, t_len, hid, in_dim, rows_per_slice);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = na * g4;
  lstm_wgrad_final_kernel<<<(n_out + 255) / 256, 256, 0, s>>>(partial, dwcat, n_slices, n_out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lstm_dseq_kernel<<<(n_rows + 7) / 8, 256, 0, s>>>(dgates, w_ih, dseq, n_rows, t_len, hid,
                                                     in_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
