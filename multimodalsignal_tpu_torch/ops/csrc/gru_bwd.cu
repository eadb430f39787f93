// GRU backward (adjoint) recurrence for Hopper (sm_90a), one kernel with a
// lane axis plus a small fixed-order reduction kernel.
//
// Replaces two Pallas TPU kernels of multimodalsignal_tpu/ops/gru_pallas.py:
//   * _bwd_kernel    (called by _gru_backward)    -> C entry gru_bwd    (one lane)
//   * _fb_bwd_kernel (called by _gru_backward_fb) -> C entry gru_bwd_fb (F lanes)
//
// What it computes, per lane f (time-major, as the TPU kernels take it):
//   xg [F, T, B, 3H]  input gates of the forward (gate blocks r | z | n)
//   w  [F, 3H, H]     recurrent weights in torch layout; bh [F, 3H]
//   h0 [F, B, H]      initial state, float32
//   ys [F, T, B, H]   the forward's states; dy [F, T, B, H] their cotangent
// -> dxg [F, T, B, 3H] in xg's dtype; dw [F, 3H, H], db [F, 3H], dh0 [F, B, H]
//    all float32.
// The walk runs opposite to the forward: from T-1 down for reverse=0, from 0
// up for reverse=1. h_prev[t], the state entering forward step t, is
// ys[t-1] (ys[t+1] for reverse) or h0 at the forward's first step, read in
// the stream dtype (h0 rounded to it). Each step:
//   hg = h_prev @ w^T + bh; r, z, n as in the forward
//   dht = dh + dy[t]
//   dz = dht (h_prev - n); dn = dht (1 - z); dn_pre = dn (1 - n^2)
//   dr_pre = dn_pre hn r (1 - r); dz_pre = dz z (1 - z)
//   dxg[t] = [dr_pre | dz_pre | dn_pre]; dg = [dr_pre | dz_pre | dn_pre r]
//   dw^T += h_prev^T @ dg_lo; db += sum_rows dg; dh = dht z + dg_lo @ w
// and dh0 = dh at the end. dg_lo is dg rounded to the stream dtype; with
// bf16 streams every product takes bf16 operands and sums in float32, db
// sums the float32 dg, as the TPU kernels' bf16 mode does (so the bf16
// backward is not the exact adjoint of the bf16 forward, whose carry is f32).
//
// Design. Batch rows and lanes are independent, so one block owns one lane
// and a tile of kRows batch rows and walks all T steps, as the forward
// kernel does. Shared memory holds W^T [H, 3H+1] in the stream dtype (the
// row padded by one element, so that both reading it by rows for hg and by
// columns for dg @ W is free of bank conflicts), the block's float32 dW^T
// partial [H, 3H], and the step's small buffers. Per step: load h_prev;
// thread c forms hg[:, c]; the threads do the gate adjoint per (row, unit)
// and write dxg; thread c adds column c of h_prev^T @ dg_lo into the dW^T
// partial and keeps its db partial in a register, while the threads form
// dh per (row, unit). Four barriers a step.
// dW and db are sums over all row tiles: each block writes its partial to a
// workspace the wrapper allocates, and gru_bwd_reduce sums the tiles in a
// fixed order, so the result is the same from run to run (no atomics).
//
// What bounds it on the card: latency, as in the forward. At the training
// shape (T=480, B=64, H=64) a step is two [4, 64] x [64, 192]-sized products
// and one [4, 192] x [192, 64] product in shared memory per block, plus four
// barriers, and the 480 steps depend on one another; the bytes (xg, ys, dy
// read once, dxg written once) and FLOPs are far below what the card could
// move in that time. A faster version would hold a whole batch per block and
// run the products on the tensor cores (mma), prefetch the next step's
// xg/dy/h_prev during the current one, and keep dW^T in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 4;  // batch rows per block (BWD_ROWS_PER_BLOCK in gru_cuda.py)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Value rounded to the stream dtype, back in float.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Dynamic shared memory of one block: W^T [H][3H+1] in the stream dtype,
// the float32 dW^T partial [H][3H], then h_prev, dh and dht*z [kRows][H] and
// hg and dg [kRows][3H] in float32.
__host__ __device__ constexpr size_t shared_bytes(int hidden, size_t itemsize) {
  return align16(size_t(hidden) * (3 * hidden + 1) * itemsize) +
         (size_t(hidden) * 3 * hidden + size_t(3) * kRows * hidden +
          size_t(2) * kRows * 3 * hidden) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(1024)
    gru_bwd_kernel(const T* __restrict__ xg, const T* __restrict__ w_hh,
                   const T* __restrict__ b_hh, const float* __restrict__ h0,
                   const T* __restrict__ ys, const T* __restrict__ dy, T* __restrict__ dxg,
                   float* __restrict__ dw_part, float* __restrict__ db_part,
                   float* __restrict__ dh0, int n_steps, int batch, int hidden, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = hidden;
  const int G = 3 * hidden;
  const int GP = G + 1;  // padded row of W^T
  const int lane = blockIdx.y;
  const int tile = blockIdx.x;
  const int row0 = tile * kRows;
  const int rows = min(kRows, batch - row0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  T* w_t = reinterpret_cast<T*>(smem);                                          // [H][GP]
  float* dw = reinterpret_cast<float*>(smem + align16(size_t(H) * GP * sizeof(T)));  // [H][G]
  float* hp = dw + H * G;        // [kRows][H] h_prev in the stream dtype's values
  float* dh = hp + kRows * H;    // [kRows][H] the adjoint carry
  float* dhz = dh + kRows * H;   // [kRows][H] dht * z
  float* hg = dhz + kRows * H;   // [kRows][G]
  float* dg = hg + kRows * G;    // [kRows][G] float32 dgates_h

  const T* w = w_hh + size_t(lane) * G * H;
  for (int e = tid; e < G * H; e += nt) {
    const int c = e / H;
    const int k = e - c * H;
    w_t[k * GP + c] = w[e];
  }
  for (int e = tid; e < H * G; e += nt) dw[e] = 0.0f;
  for (int e = tid; e < kRows * H; e += nt) dh[e] = 0.0f;
  const float bias = tid < G ? to_float(b_hh[size_t(lane) * G + tid]) : 0.0f;
  float db_acc = 0.0f;  // thread c's column of db
  __syncthreads();

  const size_t lane_h = size_t(lane) * n_steps * batch * H;
  const size_t lane_g = size_t(lane) * n_steps * batch * G;
  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? s : n_steps - 1 - s;
    const int tp = reverse ? t + 1 : t - 1;  // forward step whose output enters t
    for (int e = tid; e < kRows * H; e += nt) {
      const int r = e / H;
      const int j = e - r * H;
      float v = 0.0f;
      if (r < rows) {
        v = (tp >= 0 && tp < n_steps)
                ? to_float(ys[lane_h + (size_t(tp) * batch + row0 + r) * H + j])
                : round_to<T>(h0[(size_t(lane) * batch + row0 + r) * H + j]);
      }
      hp[e] = v;
    }
    __syncthreads();

    // hg[:, c] = h_prev @ W^T[:, c] + bh[c]
    if (tid < G) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      for (int k = 0; k < H; ++k) {
        const float wv = to_float(w_t[k * GP + tid]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(hp[r * H + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) hg[r * G + tid] = acc[r] + bias;
    }
    __syncthreads();

    // Gate adjoint per (row, unit); rows past the batch give zeros.
    for (int e = tid; e < kRows * H; e += nt) {
      const int r = e / H;
      const int j = e - r * H;
      float* d = dg + r * G;
      if (r >= rows) {
        d[j] = d[H + j] = d[2 * H + j] = 0.0f;
        dhz[e] = 0.0f;
        continue;
      }
      const size_t at = size_t(t) * batch + row0 + r;
      const T* x = xg + lane_g + at * G;
      const float* g = hg + r * G;
      const float rg = sigmoid(to_float(x[j]) + g[j]);
      const float zg = sigmoid(to_float(x[H + j]) + g[H + j]);
      const float hn = g[2 * H + j];
      const float ng = tanhf(to_float(x[2 * H + j]) + rg * hn);
      const float dht = dh[e] + to_float(dy[lane_h + at * H + j]);
      const float dz = dht * (hp[e] - ng);
      const float dn = dht * (1.0f - zg);
      const float dn_pre = dn * (1.0f - ng * ng);
      const float dr_pre = dn_pre * hn * rg * (1.0f - rg);
      const float dz_pre = dz * zg * (1.0f - zg);
      T* out = dxg + lane_g + at * G;
      out[j] = from_float<T>(dr_pre);
      out[H + j] = from_float<T>(dz_pre);
      out[2 * H + j] = from_float<T>(dn_pre);
      d[j] = dr_pre;
      d[H + j] = dz_pre;
      d[2 * H + j] = dn_pre * rg;
      dhz[e] = dht * zg;
    }
    __syncthreads();

    // dW^T[:, c] += h_prev^T @ dg_lo[:, c]; db[c] += sum_rows dg[:, c]
    if (tid < G) {
      float lo[kRows];
      float col = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float v = dg[r * G + tid];
        col += v;
        lo[r] = round_to<T>(v);
      }
      db_acc += col;
      for (int k = 0; k < H; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc = fmaf(hp[r * H + k], lo[r], acc);
        dw[k * G + tid] += acc;
      }
    }
    // dh[r, k] = dht z + dg_lo[r, :] @ W[:, k]
    for (int e = tid; e < kRows * H; e += nt) {
      const int r = e / H;
      const int k = e - r * H;
      const float* d = dg + r * G;
      const T* wk = w_t + k * GP;
      float acc = 0.0f;
      for (int c = 0; c < G; ++c) acc = fmaf(round_to<T>(d[c]), to_float(wk[c]), acc);
      dh[e] = dhz[e] + acc;
    }
    __syncthreads();
  }

  for (int e = tid; e < rows * H; e += nt) {
    const int r = e / H;
    dh0[(size_t(lane) * batch + row0 + r) * H + (e - r * H)] = dh[e];
  }
  const size_t part = size_t(lane) * gridDim.x + tile;
  for (int e = tid; e < H * G; e += nt) dw_part[part * H * G + e] = dw[e];
  if (tid < G) db_part[part * G + tid] = db_acc;
}

// Sums the row tiles' partials in tile order: dw [F, 3H, H] (torch layout,
// transposed from the partials' [H, 3H]) and db [F, 3H].
__global__ void gru_bwd_reduce(const float* __restrict__ dw_part,
                               const float* __restrict__ db_part, float* __restrict__ dw,
                               float* __restrict__ db, int lanes, int tiles, int hidden) {
  const int H = hidden;
  const int G = 3 * hidden;
  const size_t n_w = size_t(lanes) * G * H;
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_w) {
    const size_t f = i / (size_t(G) * H);
    const int rem = int(i - f * G * H);
    const int c = rem / H;
    const int k = rem - c * H;
    float acc = 0.0f;
    for (int tile = 0; tile < tiles; ++tile) {
      acc += dw_part[((f * tiles + tile) * H + k) * G + c];
    }
    dw[i] = acc;
  } else if (i < n_w + size_t(lanes) * G) {
    const size_t j = i - n_w;
    const size_t f = j / G;
    const int c = int(j - f * G);
    float acc = 0.0f;
    for (int tile = 0; tile < tiles; ++tile) acc += db_part[(f * tiles + tile) * G + c];
    db[j] = acc;
  }
}

template <typename T>
int launch(const void* xg, const void* w_hh, const void* b_hh, const void* h0, const void* ys,
           const void* dy, void* dxg, void* dw, void* db, void* dh0, void* dw_part,
           void* db_part, int lanes, int n_steps, int batch, int hidden, int reverse,
           void* stream) {
  const size_t smem = shared_bytes(hidden, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (batch + kRows - 1) / kRows;
  const int threads = (max(3 * hidden, kRows * hidden) + 31) / 32 * 32;
  gru_bwd_kernel<T><<<dim3(tiles, lanes), threads, smem, s>>>(
      static_cast<const T*>(xg), static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
      static_cast<const float*>(h0), static_cast<const T*>(ys), static_cast<const T*>(dy),
      static_cast<T*>(dxg), static_cast<float*>(dw_part), static_cast<float*>(db_part),
      static_cast<float*>(dh0), n_steps, batch, hidden, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const size_t n_out = size_t(lanes) * 3 * hidden * (hidden + 1);
  const int red_threads = 256;
  const unsigned red_blocks = unsigned((n_out + red_threads - 1) / red_threads);
  gru_bwd_reduce<<<red_blocks, red_threads, 0, s>>>(
      static_cast<const float*>(dw_part), static_cast<const float*>(db_part),
      static_cast<float*>(dw), static_cast<float*>(db), lanes, tiles, hidden);
  return int(cudaGetLastError());
}

int dispatch(const void* xg, const void* w_hh, const void* b_hh, const void* h0, const void* ys,
             const void* dy, void* dxg, void* dw, void* db, void* dh0, void* dw_part,
             void* db_part, int lanes, int n_steps, int batch, int hidden, int reverse,
             int bf16, void* stream) {
  if (bf16) {
    return launch<__nv_bfloat16>(xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0, dw_part,
                                 db_part, lanes, n_steps, batch, hidden, reverse, stream);
  }
  return launch<float>(xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0, dw_part, db_part, lanes,
                       n_steps, batch, hidden, reverse, stream);
}

}  // namespace

extern "C" {

// Shared memory one block of the adjoint kernel needs; the wrapper checks it
// against the card's limit.
long long gru_bwd_shared_bytes(int hidden, int bf16) {
  return (long long)shared_bytes(hidden, bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
}

// Counterpart of _gru_backward: one lane. The workspaces hold
// ceil(B / kRows) partials of [H, 3H] (dw_part) and [3H] (db_part) floats.
int gru_bwd(const void* xg, const void* w_hh, const void* b_hh, const void* h0, const void* ys,
            const void* dy, void* dxg, void* dw, void* db, void* dh0, void* dw_part,
            void* db_part, int n_steps, int batch, int hidden, int reverse, int bf16,
            void* stream) {
  return dispatch(xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0, dw_part, db_part, 1, n_steps,
                  batch, hidden, reverse, bf16, stream);
}

// Counterpart of _gru_backward_fb: F lanes, each with its own dw/db/dh0; the
// workspaces hold F * ceil(B / kRows) partials.
int gru_bwd_fb(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
               const void* ys, const void* dy, void* dxg, void* dw, void* db, void* dh0,
               void* dw_part, void* db_part, int lanes, int n_steps, int batch, int hidden,
               int reverse, int bf16, void* stream) {
  return dispatch(xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0, dw_part, db_part, lanes,
                  n_steps, batch, hidden, reverse, bf16, stream);
}

}  // extern "C"
