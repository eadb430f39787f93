// GRU backward (adjoint) recurrence for Hopper (sm_90a): two designs with a
// lane axis, each with a fixed-order reduction of its dW / db partials.
//
// Replaces three Pallas TPU kernels of multimodalsignal_tpu/ops/gru_pallas.py:
//   * _bwd_kernel    (called by _gru_backward)    -> C entry gru_bwd    (one lane)
//   * _fb_bwd_kernel (called by _gru_backward_fb) -> C entry gru_bwd_fb (F lanes)
//   * _bibwd_kernel  (called by _bigru_backward)  -> C entry gru_bibwd  (2 lanes,
//     the adjoint of gru_bifwd's fused BiGRU walk, float32 only)
//
// What it computes, per lane f (time-major, as the TPU kernels take it):
//   xg [F, T, B, 3H]  input gates of the forward (gate blocks r | z | n)
//   w  [F, 3H, H]     recurrent weights in torch layout; bh [F, 3H]
//   h0 [F, B, H]      initial state, float32
//   ys [F, T, B, H]   the forward's states; dy [F, T, B, H] their cotangent
// -> dxg [F, T, B, 3H] in xg's dtype; dw [F, 3H, H], db [F, 3H], dh0 [F, B, H]
//    all float32.
// gru_bibwd takes the streams xg, ys, dy and dxg as [T, 2, B, .] (the lane
// inside time, as gru_bifwd writes them), walks with reverse=0 and is
// float32 throughout; its dw comes back in torch layout [2, 3H, H], the
// transpose of the TPU kernel's dW^T [2, H, 3H].
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
// gru_bwd runs the adjoint walk (gru_adj_* below), gru_bwd_fb and gru_bibwd
// the first port's template (gru_bwd_kernel).
//
// The adjoint walk (C entry gru_bwd, replaces _bwd_kernel). What bounds it
// on the card is latency: at the training shape (T=480, B=64, H=64) the
// bytes and FLOPs take ~0.035 ms, but the 480 steps depend on one another.
// Only one chain does: dh -> dht = dh + dy[t] -> the gate adjoint -> dg_lo
// -> dh' = dht z + dg_lo @ W. Everything else moves off it, into kernels
// that run over all T at once:
//   * gru_adj_gates_kernel (pre-pass): hg = h_prev @ W^T + bh for every
//     (t, b) as a [T*B, H] x [H, 3H] product (a block: 32 rows x 32 units,
//     W's slice and h_prev staged in shared memory), then r, z, n and six
//     f32 factors per (t, b, unit): a_r = cn cr, cz, a_n = cn r, z, dy[t]
//     and cn, where cz = (h_prev - n) z (1 - z), cn = (1 - z)(1 - n^2),
//     cr = hn r (1 - r). A step of the walk is then dr_pre = dht a_r,
//     dz_pre = dht cz, dg_n = dht a_n and dht z.
//   * gru_adj_walk_kernel: one block per (lane, tile of R batch rows), R
//     chosen before the launch from (B, lanes) (adj_row_tile: R = 1 at
//     B=64, 64 blocks; R <= 2 with W in registers, 1 with W in shared
//     memory). With H <= 64 each dot thread holds 4 units' slices of W's
//     columns in registers (K = 3H in 4-wide chunks, 8 sub-lanes: 96
//     floats a thread), so each dg_lo value it reads from shared memory
//     feeds 4 FMAs; above that W^T [H][3H padded to 4] sits in dynamic
//     shared memory (one unit a thread, 4 sub-lanes). Sub-lane s < R U owns
//     one (row, unit) pair: it turns dht into dg_lo in the buffer of the
//     step's parity and keeps dht z; one barrier; every dot thread dots its
//     slice of each row's dg_lo with its W slice, an xor butterfly of
//     __shfl_xor_sync sums the slices, and the pair's lane adds dht z.
//     A barrier waits for the device memory accesses its threads have in
//     flight (cp.async copies and stores too, see below), so no dot
//     thread touches device memory inside the walk: a producer warp copies
//     the next chunk of P steps' factors into shared memory (cp.async) and
//     stores the last chunk's dht, and meets the dot warps at a named
//     barrier once per chunk (P = 16, 4 with W in shared memory); the dot
//     warps' barrier of each step is another named barrier without it.
//   * gru_adj_wgrad_kernel (post-pass): rebuilds dg = dht x (a_r, cz, a_n)
//     with the walk's own products, writes dxg (dn_pre = dht cn), and sums
//     dW^T = h_prev^T @ dg_lo and db = sum dg over chunks of rows (t, b) in
//     row order (blocks of 64 units x 64 gate columns), each chunk's
//     partial written in torch layout; gru_adj_reduce sums the chunks in
//     chunk order. dW and db are the same bits from run to run (no atomics).
// The workspace (the factors, dht and the dW partials) comes from the
// wrapper as dw_part, the db partials as db_part.
// Per-step budget at H=64, R=1 (cycles, roughly): the pair lane's five
// shared loads, add and four multiplies with the dg_lo stores ~60, the
// barrier ~40, six 16-byte shared loads per dot thread and 96 FMAs in four
// chains of 24 ~120, three shuffle rounds of four sums ~90: ~0.17 us a
// step. Measured on an H100 (700 W): ~0.41 us a step (0.197 ms for the
// walk, 0.19 ms more for the two passes), against ~7.6 us for
// gru_bwd_kernel, which kept h_prev's load, the hg product, three
// transcendentals and the dW^T accumulation on the chain with four
// barriers a step. A first version, one unit a thread (512 threads) with
// the factor loads and the dxg / dg stores in the gate lanes, ran about
// twice as long a step: its stores and its loads each held the barrier,
// whether the loads went through a register ring or cp.async, and one unit
// a thread made the dot read 48 KB of shared memory a step.
//
// gru_bwd_kernel (C entries gru_bwd_fb, gru_bibwd; replaces _fb_bwd_kernel
// and _bibwd_kernel). Batch rows and lanes are independent, so one block
// owns one lane and a tile of kRows batch rows and walks all T steps; the
// stream layout is a template parameter (Layout::row), so gru_bibwd reads
// the fused layout in place and reads h_prev from ys and h0 directly, where
// the TPU kernel gets a shifted [T, 2, B, H] copy built by its wrapper, and
// its time chunks and `valid` masks have no counterpart. Shared memory
// holds W^T [H, 3H+1] in the stream dtype (the row padded by one element,
// so that both reading it by rows for hg and by columns for dg @ W is free
// of bank conflicts), the block's float32 dW^T
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
// move in that time. Its next version is the adjoint walk above.

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

// Row index of (lane, step t, batch row b) in a [.., B, width] stream; the
// element offset is row * width.
struct LaneMajor {  // [F, T, B, width]: gru_bwd, gru_bwd_fb
  __device__ static size_t row(int lane, int t, int b, int lanes, int n_steps, int batch) {
    return (size_t(lane) * n_steps + t) * batch + b;
  }
};
struct TimeMajor {  // [T, F, B, width]: gru_bibwd
  __device__ static size_t row(int lane, int t, int b, int lanes, int n_steps, int batch) {
    return (size_t(t) * lanes + lane) * batch + b;
  }
};

// Dynamic shared memory of one block: W^T [H][3H+1] in the stream dtype,
// the float32 dW^T partial [H][3H], then h_prev, dh and dht*z [kRows][H] and
// hg and dg [kRows][3H] in float32.
__host__ __device__ constexpr size_t shared_bytes(int hidden, size_t itemsize) {
  return align16(size_t(hidden) * (3 * hidden + 1) * itemsize) +
         (size_t(hidden) * 3 * hidden + size_t(3) * kRows * hidden +
          size_t(2) * kRows * 3 * hidden) * sizeof(float);
}

template <typename T, typename Layout>
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
  const int lanes = gridDim.y;
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

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? s : n_steps - 1 - s;
    const int tp = reverse ? t + 1 : t - 1;  // forward step whose output enters t
    for (int e = tid; e < kRows * H; e += nt) {
      const int r = e / H;
      const int j = e - r * H;
      float v = 0.0f;
      if (r < rows) {
        v = (tp >= 0 && tp < n_steps)
                ? to_float(ys[Layout::row(lane, tp, row0 + r, lanes, n_steps, batch) * H + j])
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
      const size_t at = Layout::row(lane, t, row0 + r, lanes, n_steps, batch);
      const T* x = xg + at * G;
      const float* g = hg + r * G;
      const float rg = sigmoid(to_float(x[j]) + g[j]);
      const float zg = sigmoid(to_float(x[H + j]) + g[H + j]);
      const float hn = g[2 * H + j];
      const float ng = tanhf(to_float(x[2 * H + j]) + rg * hn);
      const float dht = dh[e] + to_float(dy[at * H + j]);
      const float dz = dht * (hp[e] - ng);
      const float dn = dht * (1.0f - zg);
      const float dn_pre = dn * (1.0f - ng * ng);
      const float dr_pre = dn_pre * hn * rg * (1.0f - rg);
      const float dz_pre = dz * zg * (1.0f - zg);
      T* out = dxg + at * G;
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

template <typename T, typename Layout = LaneMajor>
int launch(const void* xg, const void* w_hh, const void* b_hh, const void* h0, const void* ys,
           const void* dy, void* dxg, void* dw, void* db, void* dh0, void* dw_part,
           void* db_part, int lanes, int n_steps, int batch, int hidden, int reverse,
           void* stream) {
  const size_t smem = shared_bytes(hidden, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel<T, Layout>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (batch + kRows - 1) / kRows;
  const int threads = (max(3 * hidden, kRows * hidden) + 31) / 32 * 32;
  gru_bwd_kernel<T, Layout><<<dim3(tiles, lanes), threads, smem, s>>>(
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

// ---------------------------------------------------------------------------
// The adjoint walk: gru_bwd (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kNumSMs = 132;          // H100 SXM
constexpr int kRegMaxHidden = 64;     // W's columns in registers up to this H
constexpr int kRegUnits = 4;          // hidden units per dot thread, W in registers
constexpr int kRegSub = 8;            // dot threads per group of units, W in registers
constexpr int kRegChunks = 6;         // 4-wide chunks of K = 3H per thread: 3 * 64 / (8 * 4)
constexpr int kRegMostRows = 2;       // rows per block, W in registers: a pair a sub-lane
constexpr int kSmemSub = 4;           // dot threads per unit, W in shared memory (one row a block)
constexpr int kRegChunk = 16;         // steps the producer moves at a time, W in registers
constexpr int kSmemChunk = 4;         // steps the producer moves at a time, W in shared memory
constexpr int kProducer = 32;         // the producer warp
constexpr int kMaxThreads = 768;
constexpr int kFactors = 6;           // a_r, cz, a_n, z, dy, cn per (step, row, unit)
constexpr int kWalkFactors = 5;       // the first five: what the walk reads
constexpr int kGateRows = 32;         // (t, b) rows per block of the gate pre-pass
constexpr int kGateUnits = 32;        // hidden units per block of the gate pre-pass
constexpr int kGateThreads = kGateRows / 4 * kGateUnits;  // 4 rows a thread
constexpr int kGradTile = 64;         // k and c extent of a weight-gradient block
constexpr int kGradStage = 32;        // rows staged per round of the weight-gradient pass
constexpr int kGradThreads = 256;     // 16 x 16 threads of 4 x 4 outputs
constexpr int kMaxPartials = 128;     // row chunks of the weight-gradient pass
constexpr size_t kMaxShared = 232448;

__host__ __device__ constexpr bool adj_in_registers(int hidden) {
  return hidden <= kRegMaxHidden;
}
// K = 3H of the dh product as the walk lays it out: padded to the register
// slices, or to 4.
__host__ __device__ constexpr int adj_kpad(int hidden, bool regs) {
  return regs ? kRegSub * kRegChunks * 4 : (3 * hidden + 3) / 4 * 4;
}
// The walk's dot threads (whole warps), then the producer warp.
__host__ __device__ constexpr int adj_dot_threads(int hidden) {
  return ((adj_in_registers(hidden) ? (hidden + kRegUnits - 1) / kRegUnits * kRegSub
                                    : hidden * kSmemSub) +
          31) / 32 * 32;
}
__host__ __device__ constexpr int adj_threads(int hidden) {
  return adj_dot_threads(hidden) + kProducer;
}

// Rows per block of the walk: with W in registers, the least power of two
// (at most 2) that brings ceil(B/R) * lanes blocks down to the SM count,
// more blocks sharing the SMs beyond that (a block of 160 threads leaves
// room for several on one SM); with W in shared memory one (a block needs
// most of an SM's shared memory, so two rows would cost what two waves of
// blocks cost).
int adj_row_tile(int batch, int lanes, int hidden) {
  if (!adj_in_registers(hidden)) return 1;
  const long long want = (static_cast<long long>(batch) * lanes + kNumSMs - 1) / kNumSMs;
  int rows = 1;
  while (rows < want && rows < kRegMostRows) rows *= 2;
  return rows;
}

__host__ __device__ constexpr int adj_chunk(bool regs) { return regs ? kRegChunk : kSmemChunk; }
// Dynamic shared memory of the walk: W^T [H][kpad] in the stream dtype
// (shared-memory instantiation only, padded to 16 bytes), then float32: the
// two parity buffers of the tile's dg_lo [2][rows][kpad], and for two
// chunks of steps the factors [2 chunk][rows][kWalkFactors][H] and dht
// [2 chunk][rows][H].
__host__ __device__ constexpr size_t adj_walk_shared_bytes(int hidden, size_t itemsize,
                                                           int rows) {
  return (adj_in_registers(hidden)
              ? 0
              : align16(size_t(hidden) * adj_kpad(hidden, false) * itemsize)) +
         (size_t(2) * rows * adj_kpad(hidden, adj_in_registers(hidden)) +
          size_t(2) * adj_chunk(adj_in_registers(hidden)) * rows * (kWalkFactors + 1) * hidden) *
             sizeof(float);
}
// Dynamic shared memory of the gate pre-pass: the block's W rows as
// [H][3 * kGateUnits + 1], padded to 16 bytes, and its h_prev rows as
// [H][kGateRows], float32.
__host__ __device__ constexpr int adj_gates_w_floats(int hidden) {
  return (hidden * (3 * kGateUnits + 1) + 3) / 4 * 4;
}
__host__ __device__ constexpr size_t adj_gates_shared_bytes(int hidden) {
  return (size_t(adj_gates_w_floats(hidden)) + size_t(hidden) * kGateRows) * sizeof(float);
}
// The most any kernel of gru_bwd takes; the wrapper checks it.
__host__ __device__ constexpr size_t adj_shared_bytes(int hidden, size_t itemsize, int rows) {
  return adj_walk_shared_bytes(hidden, itemsize, rows) > adj_gates_shared_bytes(hidden)
             ? adj_walk_shared_bytes(hidden, itemsize, rows)
             : adj_gates_shared_bytes(hidden);
}

// Rows (t, b) of one lane per chunk of the weight-gradient pass: M / 128
// rounded up to a whole stage, at least one stage; the chunk count is the
// number of dW / db partials.
long long adj_chunk_rows(int n_steps, int batch) {
  const long long rows = static_cast<long long>(n_steps) * batch;
  const long long per = rows > kMaxPartials ? (rows + kMaxPartials - 1) / kMaxPartials : 1;
  return (per + kGradStage - 1) / kGradStage * kGradStage;
}
int adj_partials(int n_steps, int batch) {
  const long long rows = static_cast<long long>(n_steps) * batch;
  const long long chunk = adj_chunk_rows(n_steps, batch);
  return int((rows + chunk - 1) / chunk);
}
// The f32 workspace gru_bwd takes as dw_part: the factors [rows][6][H] and
// dht [rows][H] (rows = lanes * T * B, in the streams' order), then the dW
// partials [lanes][partials][3H][H].
long long adj_workspace_floats(int lanes, int n_steps, int batch, int hidden) {
  const long long rows = static_cast<long long>(lanes) * n_steps * batch;
  return rows * hidden * (kFactors + 1) +
         static_cast<long long>(lanes) * adj_partials(n_steps, batch) * 3 * hidden * hidden;
}

// h_prev of (lane, step t, row b, unit k): the state entering forward step
// t, in the stream dtype's values.
template <typename T, typename Layout>
__device__ __forceinline__ float adj_h_prev(const T* __restrict__ ys,
                                            const float* __restrict__ h0, int lane, int t, int b,
                                            int k, int lanes, int n_steps, int batch,
                                            int hidden, int reverse) {
  const int tp = reverse ? t + 1 : t - 1;
  if (tp >= 0 && tp < n_steps)
    return to_float(ys[Layout::row(lane, tp, b, lanes, n_steps, batch) * hidden + k]);
  return round_to<T>(h0[(size_t(lane) * batch + b) * hidden + k]);
}

// Gate pre-pass, every (lane, t, b, unit j) at once: hg = h_prev @ W^T + bh
// for a tile of kGateRows rows and kGateUnits units (thread: 4 rows x 1
// unit x 3 gates), then r, z, n and the gate adjoint's factors
//   cz = (h_prev - n) z (1 - z), cn = (1 - z)(1 - n^2), cr = hn r (1 - r),
//   a_r = cn cr, a_n = cn r,
// stored as a_r, cz, a_n, z, dy[t] (f32), cn: the walk turns dht into
// dr_pre = dht a_r, dz_pre = dht cz, dg_n = dht a_n and dht z, and the
// weight-gradient pass repeats those products and adds dn_pre = dht cn.
template <typename T, typename Layout>
__global__ void __launch_bounds__(kGateThreads)
    gru_adj_gates_kernel(const T* __restrict__ xg, const T* __restrict__ w_hh,
                         const T* __restrict__ b_hh, const float* __restrict__ h0,
                         const T* __restrict__ ys, const T* __restrict__ dy,
                         float* __restrict__ fac, int n_steps, int batch, int hidden,
                         int reverse) {
  constexpr int WS = 3 * kGateUnits + 1;  // row of the W slice, padded against bank conflicts
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = hidden;
  const int G = 3 * hidden;
  float* ws = reinterpret_cast<float*>(smem);  // [H][WS]: ws[k][g*32 + jj] = W[g*H + j0 + jj][k]
  float* hs = ws + adj_gates_w_floats(H);      // [H][kGateRows]: h_prev of unit k, row m0 + m
  const int lane = blockIdx.z;
  const int lanes = gridDim.z;
  const long long n_rows = static_cast<long long>(n_steps) * batch;
  const long long m0 = static_cast<long long>(blockIdx.x) * kGateRows;
  const int j0 = blockIdx.y * kGateUnits;
  const int tid = threadIdx.x;

  const T* w = w_hh + size_t(lane) * G * H;
  for (int e = tid; e < 3 * kGateUnits * H; e += kGateThreads) {
    const int gj = e / H;
    const int k = e - gj * H;
    const int g = gj / kGateUnits;
    const int j = j0 + gj - g * kGateUnits;
    ws[k * WS + gj] = j < H ? to_float(w[(size_t(g) * H + j) * H + k]) : 0.0f;
  }
  for (int e = tid; e < kGateRows * H; e += kGateThreads) {
    const int k = e / kGateRows;
    const int m = e - k * kGateRows;
    float v = 0.0f;
    if (m0 + m < n_rows) {
      const int t = int((m0 + m) / batch);
      const int b = int(m0 + m - static_cast<long long>(t) * batch);
      v = adj_h_prev<T, Layout>(ys, h0, lane, t, b, k, lanes, n_steps, batch, H, reverse);
    }
    hs[e] = v;
  }
  __syncthreads();

  const int jj = tid % kGateUnits;
  const int rg = tid / kGateUnits;  // rows 4 rg .. 4 rg + 3, the same for the whole warp
  float acc[3][4];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0.0f;
  for (int k = 0; k < H; ++k) {
    const float4 h4 = *reinterpret_cast<const float4*>(hs + k * kGateRows + 4 * rg);
    const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float wv = ws[k * WS + g * kGateUnits + jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = fmaf(hv[i], wv, acc[g][i]);
    }
  }
  const int j = j0 + jj;
  if (j >= H) return;
  const T* bias = b_hh + size_t(lane) * G;
  const float br = to_float(bias[j]);
  const float bz = to_float(bias[H + j]);
  const float bn = to_float(bias[2 * H + j]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + 4 * rg + i;
    if (m >= n_rows) break;
    const int t = int(m / batch);
    const int b = int(m - static_cast<long long>(t) * batch);
    const size_t at = Layout::row(lane, t, b, lanes, n_steps, batch);
    const T* x = xg + at * G;
    const float r = sigmoid(to_float(x[j]) + (acc[0][i] + br));
    const float z = sigmoid(to_float(x[H + j]) + (acc[1][i] + bz));
    const float hn = acc[2][i] + bn;
    const float n = tanhf(to_float(x[2 * H + j]) + r * hn);
    const float hp = hs[j * kGateRows + 4 * rg + i];
    const float cn = (1.0f - z) * (1.0f - n * n);
    float* f = fac + at * kFactors * H + j;
    f[0] = cn * (hn * r * (1.0f - r));
    f[H] = (hp - n) * z * (1.0f - z);
    f[2 * H] = cn * r;
    f[3 * H] = z;
    f[4 * H] = to_float(dy[at * H + j]);
    f[5 * H] = cn;
  }
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Asynchronous copies from device to shared memory (cp.async, sm_80+); the
// issuing thread waits for them with cp.async.wait_group.
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
// A barrier among `threads` threads (whole warps) of the block; id 0 is
// __syncthreads'.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
constexpr int kDotBarrier = 1;    // the dot warps, every step
constexpr int kChunkBarrier = 2;  // the whole block, once per chunk of steps

// The walk: only the dh chain, one block per (lane, tile of R rows).
// Dot threads: U hidden units and S sub-lanes a group; each holds rows
// c = 4 (s + S i) + e of W's columns for its units (K = 3H in 4-wide
// chunks), in registers for H <= 64 (U = 4, S = 8: 96 floats a thread, so
// each dg_lo value read from shared memory feeds 4 FMAs), or reads W^T from
// shared memory above (U = 1, S = 4). Sub-lane s < R U owns the pair
// (row s / U, unit g U + s % U); it turns dht = dh + dy into dg_lo
// (into the parity buffer) and keeps dht z; barrier; each dot thread dots
// its slice of every row's dg_lo with its W slice, an xor butterfly sums
// the S slices, and the pair's lane adds dht z: dh for the next step.
// A barrier waits for the device memory accesses its threads still have in
// flight, cp.async copies and stores included, so no dot thread touches
// device memory inside the walk, and the dot warps' barrier of each step
// (kDotBarrier) leaves out the producer warp. The producer moves P steps at
// a time: while the dot warps walk chunk c it copies chunk c + 1's factors
// (dy among them) into shared memory with cp.async and stores chunk c - 1's
// dht, then waits for its copies and meets the dot warps at the chunk
// barrier (kChunkBarrier), once per P steps.
// One block an SM is what the launch bounds ask for: without the minimum,
// ptxas trades registers for a second block (which shared memory rules out
// with W in shared memory) and spills.
template <typename T, typename Layout, int R, bool kRegs>
__global__ void __launch_bounds__(kRegs ? kRegSub * kRegMaxHidden / kRegUnits + kProducer
                                        : kMaxThreads, 1)
    gru_adj_walk_kernel(const float* __restrict__ fac, const T* __restrict__ w_hh,
                        float* __restrict__ dht_out, float* __restrict__ dh0, int n_steps,
                        int batch, int hidden, int reverse) {
  constexpr int U = kRegs ? kRegUnits : 1;
  constexpr int S = kRegs ? kRegSub : kSmemSub;
  constexpr int P = adj_chunk(kRegs);
  constexpr int kAcc = kRegs ? 1 : 4;  // partial sums per (row, unit)
  static_assert(R * U <= S, "one (row, unit) pair a sub-lane");
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = hidden;
  const int G = 3 * hidden;
  const int kpad = adj_kpad(H, kRegs);
  const int lane = blockIdx.y;
  const int lanes = gridDim.y;
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int dot_threads = adj_dot_threads(H);
  const bool producer = tid >= dot_threads;
  const int pl = tid - dot_threads;  // producer lane
  const int groups = (H + U - 1) / U;
  const int g = tid / S;  // group of units g U .. g U + U - 1
  const int s = tid % S;  // sub-lane: chunks s, s + S, ...; pair s
  const int gu = g < groups ? g : 0;  // padding threads read group 0 and write nothing

  T* w_s = reinterpret_cast<T*>(smem);  // [H][kpad]: w_s[k][c] = W[c][k], shared instantiation
  float* dgbuf = reinterpret_cast<float*>(
      smem + (kRegs ? 0 : align16(size_t(H) * kpad * sizeof(T))));  // [2][R][kpad]
  float* fbuf = dgbuf + 2 * R * kpad;                      // [2P][R][kWalkFactors][H]
  float* dhtbuf = fbuf + 2 * P * R * kWalkFactors * H;     // [2P][R][H]

  const T* w = w_hh + size_t(lane) * G * H;
  for (int e = tid; e < 2 * R * kpad; e += blockDim.x) dgbuf[e] = 0.0f;
  float wreg[kRegs ? U * kRegChunks * 4 : 1];
  if constexpr (kRegs) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int ci = 0; ci < kRegChunks; ++ci)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * (s + S * ci) + e;
          const int k = g * U + u;
          wreg[(u * kRegChunks + ci) * 4 + e] =
              !producer && k < H && c < G ? to_float(w[size_t(c) * H + k]) : 0.0f;
        }
  } else {
    for (int e = tid; e < H * kpad; e += blockDim.x) {
      const int c = e / H;  // read W row by row, write it transposed
      const int kk = e - c * H;
      w_s[size_t(kk) * kpad + c] = c < G ? w[e] : from_float<T>(0.0f);
    }
  }

  auto at_step = [&](int step, int row) {
    const int t = reverse ? step : n_steps - 1 - step;
    return Layout::row(lane, t, row, lanes, n_steps, batch);
  };
  // Factors and dht of (step, tile row r) in shared memory.
  auto fac_at = [&](int step, int r) {
    return fbuf + ((step % (2 * P)) * R + r) * kWalkFactors * H;
  };
  auto dht_at = [&](int step, int r) { return dhtbuf + ((step % (2 * P)) * R + r) * H; };
  const bool vec = H % 4 == 0;  // 16-byte moves: every row of the factors and of dht is aligned
  auto load_chunk = [&](int c) {  // producer: cp.async of chunk c's factors
    const int last = min((c + 1) * P, n_steps);
    for (int i = c * P; i < last; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (row0 + r >= batch) break;
        const float* src = fac + at_step(i, row0 + r) * kFactors * H;
        float* dst = fac_at(i, r);
        if (vec) {
          for (int u = 4 * pl; u < kWalkFactors * H; u += 4 * kProducer)
            cp_async16(dst + u, src + u);
        } else {
          for (int u = pl; u < kWalkFactors * H; u += kProducer) cp_async4(dst + u, src + u);
        }
      }
    cp_async_commit();
  };
  auto store_chunk = [&](int c) {  // producer: chunk c's dht to device memory
    const int last = min((c + 1) * P, n_steps);
    for (int i = c * P; i < last; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (row0 + r >= batch) break;
        float* out = dht_out + at_step(i, row0 + r) * H;
        const float* in = dht_at(i, r);
        if (vec) {
          for (int u = 4 * pl; u < H; u += 4 * kProducer)
            *reinterpret_cast<float4*>(out + u) = *reinterpret_cast<const float4*>(in + u);
        } else {
          for (int u = pl; u < H; u += kProducer) out[u] = in[u];
        }
      }
  };

  const int n_chunks = (n_steps + P - 1) / P;
  if (producer) {
    load_chunk(0);
    cp_async_wait_all();
  }
  __syncthreads();
  if (producer) {
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) load_chunk(c + 1);
      if (c > 0) store_chunk(c - 1);
      cp_async_wait_all();
      if (c + 1 < n_chunks) named_barrier(kChunkBarrier, blockDim.x);
    }
    __syncthreads();  // the last chunk's dht is written
    store_chunk(n_chunks - 1);
    return;
  }

  // The (row, unit) pair of this sub-lane.
  const int pr = s / U;
  const int pk = g * U + s % U;
  const bool pair = g < groups && s < R * U && pk < H && row0 + pr < batch;
  float dh = 0.0f;
  const int nchunks = kpad / 4;
  for (int step = 0; step < n_steps; ++step) {
    if (step > 0 && step % P == 0) named_barrier(kChunkBarrier, blockDim.x);
    float* buf = dgbuf + (step & 1) * R * kpad;
    float dhz = 0.0f;
    if (pair) {
      const float* f = fac_at(step, pr) + pk;
      const float dht = dh + f[4 * H];
      const float dr_pre = dht * f[0];
      const float dz_pre = dht * f[H];
      const float dg_n = dht * f[2 * H];
      dhz = dht * f[3 * H];
      float* out = buf + pr * kpad;
      out[pk] = round_to<T>(dr_pre);
      out[H + pk] = round_to<T>(dz_pre);
      out[2 * H + pk] = round_to<T>(dg_n);
      dht_at(step, pr)[pk] = dht;
    }
    named_barrier(kDotBarrier, dot_threads);
    // dh[r][k] = dg_lo[r] @ W[:, k] for the group's units.
    float acc[R][U][kAcc];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < kAcc; ++e) acc[r][u][e] = 0.0f;
    if constexpr (kRegs) {
#pragma unroll
      for (int ci = 0; ci < kRegChunks; ++ci)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float dv[4];
          load4(buf + r * kpad + 4 * (s + S * ci), dv);
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[r][u][0] = fmaf(dv[e], wreg[(u * kRegChunks + ci) * 4 + e], acc[r][u][0]);
        }
    } else {
#pragma unroll 2
      for (int c = s; c < nchunks; c += S) {
        float wv[4];
        load4(w_s + size_t(gu) * kpad + 4 * c, wv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float dv[4];
          load4(buf + r * kpad + 4 * c, dv);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][0][e % kAcc] = fmaf(dv[e], wv[e], acc[r][0][e % kAcc]);
        }
      }
    }
    float sum[R][U];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sum[r][u] = acc[r][u][0];
#pragma unroll
        for (int e = 1; e < kAcc; ++e) sum[r][u] += acc[r][u][e];
      }
#pragma unroll
    for (int off = S / 2; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u) sum[r][u] += __shfl_xor_sync(0xffffffffu, sum[r][u], off);
    if (pair) {
      float mine = sum[0][0];
#pragma unroll
      for (int q = 1; q < R * U; ++q)
        if (s == q) mine = sum[q / U][q % U];
      dh = dhz + mine;
    }
  }
  __syncthreads();
  if (pair) dh0[(size_t(lane) * batch + row0 + pr) * H + pk] = dh;
}

// Weight-gradient pass: dW^T[k][c] = sum over rows of h_prev[k] dg_lo[c]
// and db[c] = sum of the f32 dg[c], for one chunk of rows (t, b) of one
// lane, in row order, where dg is rebuilt from dht and the factors with the
// walk's own products; blocks of k-tile 0 also write dxg. A block holds
// kGradTile units x kGradTile gate columns (thread: 4 x 4), stages
// kGradStage rows of h_prev and dg at a time in shared memory, and writes
// its partial in torch layout [3H][H]; gru_adj_reduce sums the chunks in a
// fixed order.
template <typename T, typename Layout>
__global__ void __launch_bounds__(kGradThreads)
    gru_adj_wgrad_kernel(const float* __restrict__ fac, const float* __restrict__ dht,
                         const T* __restrict__ ys, const float* __restrict__ h0,
                         T* __restrict__ dxg, float* __restrict__ dw_part,
                         float* __restrict__ db_part, int n_steps, int batch, int hidden,
                         int reverse, int chunk_rows) {
  __shared__ __align__(16) float hs[kGradStage][kGradTile];
  __shared__ __align__(16) float ds[kGradStage][kGradTile];
  const int H = hidden;
  const int G = 3 * hidden;
  const int part = blockIdx.x;
  const int parts = gridDim.x;
  const int c0 = blockIdx.y * kGradTile;
  const int k_tiles = (H + kGradTile - 1) / kGradTile;
  const int lane = blockIdx.z / k_tiles;
  const int lanes = gridDim.z / k_tiles;
  const int k0 = (blockIdx.z - lane * k_tiles) * kGradTile;
  const long long n_rows = static_cast<long long>(n_steps) * batch;
  const long long m_begin = static_cast<long long>(part) * chunk_rows;
  const long long m_end = m_begin + chunk_rows < n_rows ? m_begin + chunk_rows : n_rows;
  const int tid = threadIdx.x;
  const int kg = tid / 16;  // units k0 + 4 kg ..
  const int cg = tid % 16;  // columns c0 + 4 cg ..

  float acc[4][4], dbacc[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    dbacc[a] = 0.0f;
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  }
  for (long long m0 = m_begin; m0 < m_end; m0 += kGradStage) {
    for (int e = tid; e < kGradStage * kGradTile; e += kGradThreads) {
      const int i = e / kGradTile;
      const int x = e - i * kGradTile;
      float hv = 0.0f, dv = 0.0f;
      if (m0 + i < m_end) {
        const int t = int((m0 + i) / batch);
        const int b = int(m0 + i - static_cast<long long>(t) * batch);
        if (k0 + x < H)
          hv = adj_h_prev<T, Layout>(ys, h0, lane, t, b, k0 + x, lanes, n_steps, batch, H,
                                     reverse);
        const int c = c0 + x;
        if (c < G) {
          const size_t at = Layout::row(lane, t, b, lanes, n_steps, batch);
          const int gate = c / H;  // factor a_r, cz or a_n
          const int j = c - gate * H;
          const float d = dht[at * H + j];
          const float* f = fac + at * kFactors * H + j;
          dv = d * f[gate * H];
          if (k0 == 0) dxg[at * G + c] = from_float<T>(gate == 2 ? d * f[5 * H] : dv);
        }
      }
      hs[i][x] = hv;
      ds[i][x] = dv;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kGradStage; ++i) {
      float hv[4], dv[4];
      load4(&hs[i][4 * kg], hv);
      load4(&ds[i][4 * cg], dv);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        dbacc[b] += dv[b];
        const float lo = round_to<T>(dv[b]);
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][b] = fmaf(hv[a], lo, acc[a][b]);
      }
    }
    __syncthreads();
  }
  float* out = dw_part + (size_t(lane) * parts + part) * G * H;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int k = k0 + 4 * kg + a;
      const int c = c0 + 4 * cg + b;
      if (k < H && c < G) out[size_t(c) * H + k] = acc[a][b];
    }
  if (k0 == 0 && kg == 0) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + 4 * cg + b;
      if (c < G) db_part[(size_t(lane) * parts + part) * G + c] = dbacc[b];
    }
  }
}

// Sums the chunks' partials in chunk order: dw [F, 3H, H] and db [F, 3H].
__global__ void gru_adj_reduce(const float* __restrict__ dw_part,
                               const float* __restrict__ db_part, float* __restrict__ dw,
                               float* __restrict__ db, int lanes, int parts, int hidden) {
  const size_t n_w = size_t(3) * hidden * hidden;
  const size_t G = size_t(3) * hidden;
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < lanes * n_w) {
    const size_t f = i / n_w;
    const size_t e = i - f * n_w;
    float acc = 0.0f;
    for (int p = 0; p < parts; ++p) acc += dw_part[(f * parts + p) * n_w + e];
    dw[i] = acc;
  } else if (i < lanes * (n_w + G)) {
    const size_t j = i - lanes * n_w;
    const size_t f = j / G;
    const size_t c = j - f * G;
    float acc = 0.0f;
    for (int p = 0; p < parts; ++p) acc += db_part[(f * parts + p) * G + c];
    db[j] = acc;
  }
}

template <typename T, typename Layout, int R, bool kRegs>
int adj_walk_tile(const float* fac, const void* w_hh, float* dht, void* dh0, int lanes,
                  int n_steps, int batch, int hidden, int reverse, cudaStream_t stream) {
  const size_t smem = adj_walk_shared_bytes(hidden, sizeof(T), R);
  cudaError_t err = cudaFuncSetAttribute(gru_adj_walk_kernel<T, Layout, R, kRegs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  gru_adj_walk_kernel<T, Layout, R, kRegs>
      <<<dim3((batch + R - 1) / R, lanes), adj_threads(hidden), smem, stream>>>(
          fac, static_cast<const T*>(w_hh), dht, static_cast<float*>(dh0), n_steps, batch,
          hidden, reverse);
  return int(cudaGetLastError());
}

template <typename T, typename Layout>
int adj_walk(const float* fac, const void* w_hh, float* dht, void* dh0, int lanes, int n_steps,
             int batch, int hidden, int reverse, cudaStream_t stream) {
  if (!adj_in_registers(hidden))
    return adj_walk_tile<T, Layout, 1, false>(fac, w_hh, dht, dh0, lanes, n_steps, batch,
                                              hidden, reverse, stream);
  if (adj_row_tile(batch, lanes, hidden) == 1)
    return adj_walk_tile<T, Layout, 1, true>(fac, w_hh, dht, dh0, lanes, n_steps, batch,
                                             hidden, reverse, stream);
  return adj_walk_tile<T, Layout, 2, true>(fac, w_hh, dht, dh0, lanes, n_steps, batch, hidden,
                                           reverse, stream);
}

// gru_bwd's four kernels on one stream: the gate pre-pass, the walk, the
// weight-gradient pass and the reduction. The instantiation is chosen from
// H before any launch; a shape the wrapper would have refused is refused
// here too, not launched.
template <typename T, typename Layout>
int adj_launch(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
               const void* ys, const void* dy, void* dxg, void* dw, void* db, void* dh0,
               void* workspace, void* db_part, int lanes, int n_steps, int batch, int hidden,
               int reverse, void* stream) {
  const int rows = adj_row_tile(batch, lanes, hidden);
  if (adj_threads(hidden) > kMaxThreads ||
      adj_shared_bytes(hidden, sizeof(T), rows) > kMaxShared)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n_rows = size_t(lanes) * n_steps * batch;
  float* fac = static_cast<float*>(workspace);
  float* dht = fac + n_rows * kFactors * hidden;
  float* dw_part = dht + n_rows * hidden;

  const size_t gates_smem = adj_gates_shared_bytes(hidden);
  cudaError_t err = cudaFuncSetAttribute(gru_adj_gates_kernel<T, Layout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(gates_smem));
  if (err != cudaSuccess) return int(err);
  const long long lane_rows = static_cast<long long>(n_steps) * batch;
  gru_adj_gates_kernel<T, Layout>
      <<<dim3(unsigned((lane_rows + kGateRows - 1) / kGateRows),
              (hidden + kGateUnits - 1) / kGateUnits, lanes),
         kGateThreads, gates_smem, s>>>(
          static_cast<const T*>(xg), static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
          static_cast<const float*>(h0), static_cast<const T*>(ys), static_cast<const T*>(dy),
          fac, n_steps, batch, hidden, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const int e = adj_walk<T, Layout>(fac, w_hh, dht, dh0, lanes, n_steps, batch, hidden,
                                    reverse, s);
  if (e != 0) return e;

  const int parts = adj_partials(n_steps, batch);
  const int k_tiles = (hidden + kGradTile - 1) / kGradTile;
  gru_adj_wgrad_kernel<T, Layout>
      <<<dim3(parts, (3 * hidden + kGradTile - 1) / kGradTile, k_tiles * lanes), kGradThreads,
         0, s>>>(fac, dht, static_cast<const T*>(ys), static_cast<const float*>(h0),
                 static_cast<T*>(dxg), dw_part, static_cast<float*>(db_part), n_steps, batch,
                 hidden, reverse, int(adj_chunk_rows(n_steps, batch)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const size_t n_out = size_t(lanes) * 3 * hidden * (hidden + 1);
  const int red_threads = 256;
  gru_adj_reduce<<<unsigned((n_out + red_threads - 1) / red_threads), red_threads, 0, s>>>(
      dw_part, static_cast<const float*>(db_part), static_cast<float*>(dw),
      static_cast<float*>(db), lanes, parts, hidden);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block of gru_bwd_kernel (gru_bwd_fb, gru_bibwd) needs;
// the wrapper checks it against the card's limit.
long long gru_bwd_shared_bytes(int hidden, int bf16) {
  return (long long)shared_bytes(hidden, bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
}

// Shared memory the most demanding kernel of gru_bwd needs for a walk tile
// of `rows`; the wrapper checks it against the card's limit.
long long gru_adj_shared_bytes(int hidden, int bf16, int rows) {
  return (long long)adj_shared_bytes(hidden, bf16 ? sizeof(__nv_bfloat16) : sizeof(float),
                                     rows);
}

// Rows per block of gru_bwd's walk for this shape.
int gru_adj_row_tile(int batch, int lanes, int hidden) {
  return adj_row_tile(batch, lanes, hidden);
}

// Rows (t, b) per chunk of gru_bwd's weight-gradient pass, and the chunk
// count: the dW / db partials per lane.
long long gru_adj_chunk_rows(int n_steps, int batch) { return adj_chunk_rows(n_steps, batch); }
int gru_adj_partials(int n_steps, int batch) { return adj_partials(n_steps, batch); }

// Floats of the workspace gru_bwd takes as dw_part.
long long gru_adj_workspace_floats(int lanes, int n_steps, int batch, int hidden) {
  return adj_workspace_floats(lanes, n_steps, batch, hidden);
}

// Counterpart of _gru_backward: one lane, on the adjoint walk. dw_part is
// the workspace of gru_adj_workspace_floats(1, T, B, H) floats, db_part
// holds gru_adj_partials(T, B) partials of [3H] floats.
int gru_bwd(const void* xg, const void* w_hh, const void* b_hh, const void* h0, const void* ys,
            const void* dy, void* dxg, void* dw, void* db, void* dh0, void* dw_part,
            void* db_part, int n_steps, int batch, int hidden, int reverse, int bf16,
            void* stream) {
  if (bf16) {
    return adj_launch<__nv_bfloat16, LaneMajor>(xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0,
                                                dw_part, db_part, 1, n_steps, batch, hidden,
                                                reverse, stream);
  }
  return adj_launch<float, LaneMajor>(xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0, dw_part,
                                      db_part, 1, n_steps, batch, hidden, reverse, stream);
}

// Counterpart of _gru_backward_fb: F lanes, each with its own dw/db/dh0; the
// workspaces hold F * ceil(B / kRows) partials.
int gru_bwd_fb(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
               const void* ys, const void* dy, void* dxg, void* dw, void* db, void* dh0,
               void* dw_part, void* db_part, int lanes, int n_steps, int batch, int hidden,
               int reverse, int bf16, void* stream) {
  if (bf16) {
    return launch<__nv_bfloat16>(xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0, dw_part,
                                 db_part, lanes, n_steps, batch, hidden, reverse, stream);
  }
  return launch<float>(xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0, dw_part, db_part, lanes,
                       n_steps, batch, hidden, reverse, stream);
}

// Counterpart of _bigru_backward: the adjoint of gru_bifwd, float32, walking
// time backward. xg, ys, dy, dxg [T, 2, B, .]; w [2, 3H, H], bh [2, 3H],
// h0 [2, B, H] -> dw [2, 3H, H], db [2, 3H], dh0 [2, B, H] per direction.
// The workspaces hold 2 * ceil(B / kRows) partials.
int gru_bibwd(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
              const void* ys, const void* dy, void* dxg, void* dw, void* db, void* dh0,
              void* dw_part, void* db_part, int n_steps, int batch, int hidden,
              void* stream) {
  return launch<float, TimeMajor>(xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0, dw_part,
                                  db_part, 2, n_steps, batch, hidden, 0, stream);
}

}  // extern "C"
