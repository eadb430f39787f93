// GRU forward recurrence for Hopper (sm_90a), one kernel with a lane axis.
//
// Replaces three Pallas TPU kernels of multimodalsignal_tpu/ops/gru_pallas.py:
//   * _fwd_kernel    (called by _gru_forward)    -> C entry gru_fwd    (one lane)
//   * _fb_fwd_kernel (called by _gru_forward_fb) -> C entry gru_fwd_fb (F lanes)
//   * _bifwd_kernel  (called by _bigru_forward)  -> C entry gru_bifwd  (2 lanes,
//     the two directions of a BiGRU layer, float32 only)
//
// What it computes, per lane f and batch row b (time-major, as the TPU
// kernels take it):
//   xg [F, T, B, 3H]  input gates x @ W_ih^T + b_ih, gate blocks r | z | n
//                     ([T, 2, B, 3H] for gru_bifwd: the lane inside time)
//   w  [F, 3H, H]     recurrent weights in torch layout (rows r | z | n)
//   bh [F, 3H]        recurrent bias
//   h0 [F, B, H]      initial state, always float32
//   ys [F, T, B, H]   every step's state, in xg's dtype ([T, 2, B, H] for
//                     gru_bifwd)
//     hg = h @ w^T + bh
//     r = sigmoid(xr + hr); z = sigmoid(xz + hz); n = tanh(xn + r * hn)
//     h = (1 - z) * n + z * h
// `reverse` walks time from T-1 down to 0; ys stays in original time order.
// The carry h is float32. With bf16 streams (xg, w, bh, ys) the product
// operands are bf16 (h is rounded to bf16 before the product) and the sums
// are float32, as the TPU kernels' bf16 mode does; otherwise all is float32.
//
// Design. Batch rows and lanes are independent recurrences, so one block
// owns one lane and a tile of kRows batch rows and walks all T steps in a
// loop; that loop takes the place of the TPU's sequential time grid and its
// VMEM chunking. The layout is a template parameter: the block finds its
// rows through Layout::row, so gru_bifwd reads the fused [T, 2, B, 3H]
// gates in place (direction stride B*3H, time stride 2*B*3H) and the
// wrapper copies nothing into a lane-major layout; the TPU kernel's time
// chunks and `valid` masks have no counterpart. The block copies its lane's
// W^T [H, 3H] into dynamic shared memory once. Each step: thread c (one per
// gate column, 3H threads) forms hg[r][c] for the tile's rows from shared h
// and W^T; barrier; the threads then do the gate math per (row, unit),
// write y[t] and update h; barrier.
//
// What bounds it on the card: latency. At the serving shape (T=480, B=64,
// H=64) each step is a shared-memory product of [4, 64] x [64, 192] per block
// and two barriers, and the 480 steps depend on one another, so the walk
// costs T times one step's latency; the bytes (xg read once, ys written
// once) and the FLOPs are far below what the card could move in that time.
// A later version would put a whole batch into one block and run the step's
// product on the tensor cores (mma / wgmma, W^T held in registers or shared
// memory as the B operand), prefetch xg[t+1] while step t runs, and cut the
// barriers per step from two to one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 4;  // batch rows per block (ROWS_PER_BLOCK in gru_cuda.py)

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

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Row index of (lane, step t, batch row b) in a [.., B, width] stream; the
// element offset is row * width.
struct LaneMajor {  // [F, T, B, width]: gru_fwd, gru_fwd_fb
  __device__ static size_t row(int lane, int t, int b, int lanes, int n_steps, int batch) {
    return (size_t(lane) * n_steps + t) * batch + b;
  }
};
struct TimeMajor {  // [T, F, B, width]: gru_bifwd
  __device__ static size_t row(int lane, int t, int b, int lanes, int n_steps, int batch) {
    return (size_t(t) * lanes + lane) * batch + b;
  }
};

// Dynamic shared memory of one block: W^T in the stream dtype, then the f32
// carry, the carry rounded to the operand dtype, and the step's hg.
__host__ __device__ constexpr size_t shared_bytes(int hidden, size_t itemsize) {
  return align16(size_t(hidden) * 3 * hidden * itemsize) +
         (size_t(2) * kRows * hidden + size_t(kRows) * 3 * hidden) * sizeof(float);
}

template <typename T, typename Layout>
__global__ void __launch_bounds__(1024)
    gru_fwd_kernel(const T* __restrict__ xg, const T* __restrict__ w_hh,
                   const T* __restrict__ b_hh, const float* __restrict__ h0,
                   T* __restrict__ ys, int n_steps, int batch, int hidden, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = hidden;
  const int G = 3 * hidden;
  const int lane = blockIdx.y;
  const int lanes = gridDim.y;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - row0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  T* w_t = reinterpret_cast<T*>(smem);                                    // [H][G]
  float* h = reinterpret_cast<float*>(smem + align16(size_t(H) * G * sizeof(T)));  // [kRows][H]
  float* h_op = h + kRows * H;                                            // [kRows][H]
  float* hg = h_op + kRows * H;                                           // [kRows][G]

  const T* w = w_hh + size_t(lane) * G * H;
  for (int e = tid; e < G * H; e += nt) {
    const int c = e / H;
    const int k = e - c * H;
    w_t[k * G + c] = w[e];
  }
  for (int e = tid; e < kRows * H; e += nt) {
    const int r = e / H;
    const float v = r < rows ? h0[(size_t(lane) * batch + row0 + r) * H + (e - r * H)] : 0.0f;
    h[e] = v;
    h_op[e] = to_float(from_float<T>(v));
  }
  const float bias = tid < G ? to_float(b_hh[size_t(lane) * G + tid]) : 0.0f;
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    if (tid < G) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      for (int k = 0; k < H; ++k) {
        const float wv = to_float(w_t[k * G + tid]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(h_op[r * H + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) hg[r * G + tid] = acc[r] + bias;
    }
    __syncthreads();
    for (int e = tid; e < rows * H; e += nt) {
      const int r = e / H;
      const int j = e - r * H;
      const size_t at = Layout::row(lane, t, row0 + r, lanes, n_steps, batch);
      const T* x = xg + at * G;
      const float* g = hg + r * G;
      const float rg = sigmoid(to_float(x[j]) + g[j]);
      const float zg = sigmoid(to_float(x[H + j]) + g[H + j]);
      const float ng = tanhf(to_float(x[2 * H + j]) + rg * g[2 * H + j]);
      const float hn = (1.0f - zg) * ng + zg * h[e];
      h[e] = hn;
      const T out = from_float<T>(hn);
      h_op[e] = to_float(out);
      ys[at * H + j] = out;
    }
    __syncthreads();
  }
}

template <typename T, typename Layout = LaneMajor>
int launch(const void* xg, const void* w_hh, const void* b_hh, const void* h0, void* ys,
           int lanes, int n_steps, int batch, int hidden, int reverse, void* stream) {
  const size_t smem = shared_bytes(hidden, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel<T, Layout>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((batch + kRows - 1) / kRows, lanes);
  const int threads = (3 * hidden + 31) / 32 * 32;
  gru_fwd_kernel<T, Layout><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xg), static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
      static_cast<const float*>(h0), static_cast<T*>(ys), n_steps, batch, hidden, reverse);
  return int(cudaGetLastError());
}

int dispatch(const void* xg, const void* w_hh, const void* b_hh, const void* h0, void* ys,
             int lanes, int n_steps, int batch, int hidden, int reverse, int bf16,
             void* stream) {
  if (bf16) {
    return launch<__nv_bfloat16>(xg, w_hh, b_hh, h0, ys, lanes, n_steps, batch, hidden,
                                 reverse, stream);
  }
  return launch<float>(xg, w_hh, b_hh, h0, ys, lanes, n_steps, batch, hidden, reverse,
                       stream);
}

}  // namespace

extern "C" {

// Shared memory one block needs; the wrapper checks it against the card's limit.
long long gru_fwd_shared_bytes(int hidden, int bf16) {
  return (long long)shared_bytes(hidden, bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
}

// Counterpart of _gru_forward: xg [T, B, 3H] -> ys [T, B, H].
int gru_fwd(const void* xg, const void* w_hh, const void* b_hh, const void* h0, void* ys,
            int n_steps, int batch, int hidden, int reverse, int bf16, void* stream) {
  return dispatch(xg, w_hh, b_hh, h0, ys, 1, n_steps, batch, hidden, reverse, bf16, stream);
}

// Counterpart of _gru_forward_fb: xg [F, T, B, 3H] -> ys [F, T, B, H].
int gru_fwd_fb(const void* xg, const void* w_hh, const void* b_hh, const void* h0, void* ys,
               int lanes, int n_steps, int batch, int hidden, int reverse, int bf16,
               void* stream) {
  return dispatch(xg, w_hh, b_hh, h0, ys, lanes, n_steps, batch, hidden, reverse, bf16,
                  stream);
}

// Counterpart of _bigru_forward: both directions of one BiGRU layer, float32,
// direction 1's gates already flipped in time, so both walk forward:
// xg [T, 2, B, 3H], w [2, 3H, H], bh [2, 3H], h0 [2, B, H] -> ys [T, 2, B, H].
int gru_bifwd(const void* xg, const void* w_hh, const void* b_hh, const void* h0, void* ys,
              int n_steps, int batch, int hidden, void* stream) {
  return launch<float, TimeMajor>(xg, w_hh, b_hh, h0, ys, 2, n_steps, batch, hidden, 0,
                                  stream);
}

}  // extern "C"
