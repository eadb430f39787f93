// GRU forward recurrence for Hopper (sm_90a), kernels with a lane axis.
//
// Replaces three Pallas TPU kernels of multimodalsignal_tpu/ops/gru_pallas.py:
//   * _fwd_kernel    (called by _gru_forward)    -> C entry gru_fwd    (one lane)
//   * _fb_fwd_kernel (called by _gru_forward_fb) -> C entry gru_fwd_fb (F lanes)
//   * _bifwd_kernel  (called by _bigru_forward)  -> C entry gru_bifwd  (2 lanes,
//     the two directions of a BiGRU layer, float32 only)
// The layout of the streams is a type (LaneMajor, TimeMajor below): gru_bifwd
// reads the fused [T, 2, B, 3H] gates in place, direction stride B*3H, time
// stride 2*B*3H; the TPU kernels' time chunks and `valid` masks have no
// counterpart.
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
// One kernel walks that recurrence for all three entries, gru_walk_kernel.
// What bounds it on the card is latency: at the serving shape (T=480, B=64,
// H=64) the bytes (xg read once, ys written once) and the FLOPs take
// ~0.01 ms, but the 480 steps depend on one another, so the walk costs T
// times one step's critical path. The design shortens that path:
//   * One block per (lane, tile of R batch rows); R is chosen per (B, lanes)
//     before the launch (walk_row_tile) so that ceil(B/R) * lanes blocks
//     fill the 132 SMs (R = 1 at B=64: 64 blocks, 128 for two lanes); rows
//     past B are masked.
//   * S threads per hidden unit j, K split across them in 4-wide chunks
//     (chunk c = s, s + S, ...). Each thread forms the r, z and n partial
//     dot products of its K slice for the tile's rows; an xor butterfly of
//     __shfl_xor_sync over the S lanes gives every lane the full sums, and
//     lane s < R does the gate math of row s right there, so hg never goes
//     through shared memory. That lane keeps the row's f32 carry in a
//     register for the whole walk.
//   * W^T stays in registers for the whole walk when H <= 64 (S = 8, two
//     chunks: 24 floats a thread); above that, W (torch layout, K padded to
//     4) sits in dynamic shared memory and each thread reads its slices as
//     16-byte (f32) or 8-byte (bf16) loads (S = 4, R <= 4).
//   * h (rounded to the operand dtype) is read from shared memory as 16-byte
//     loads, broadcast to the units that share a chunk, from one buffer per
//     step parity: step s reads buffer s & 1 and writes the other, so one
//     __syncthreads per step suffices.
//   * The gate lanes load xg kPrefetch - 1 steps ahead, in walk order, into
//     a register ring, each load issued right after a barrier so that it
//     has a whole step to land before the next one; ys is stored and never
//     read back.
// Per-step budget at H=64, R=1 (cycles, roughly): two 16-byte shared loads
// ~30, 24 FMAs in three chains of 8 ~40, three shuffle rounds ~80, the gate
// math (two expf, a tanhf, IEEE divisions) ~200, the h store and barrier
// ~50: ~0.25 us a step. chip_smoke.py measures ~0.6 us a step in float32
// on an H100 (700 W), against ~3-4 us for the first port's template (four
// rows a block, W^T and h read from shared memory every step, two barriers
// a step), which this kernel replaced. A larger R lengthens the FMA chains
// and the shuffles, hence R grows only when B * lanes leaves no SM free
// (F = 4 lanes at B = 128 take R = 4, F = 15 at B = 64 take R = 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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

// ---------------------------------------------------------------------------
// gru_walk_kernel: gru_fwd, gru_fwd_fb and gru_bifwd (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kNumSMs = 132;          // H100 SXM
constexpr int kRegMaxHidden = 64;     // W^T in registers up to this H
constexpr int kRegSub = 8;            // threads per hidden unit, W in registers
constexpr int kRegChunks = 2;         // 4-wide K chunks per thread, W in registers
constexpr int kSmemSub = 4;           // threads per hidden unit, W in shared memory
constexpr int kPrefetch = 4;          // xg ring slots: steps loaded kPrefetch - 1 ahead
constexpr int kMaxThreads = 768;      // 192 units x kSmemSub: the largest H admitted

__host__ __device__ constexpr bool walk_in_registers(int hidden) {
  return hidden <= kRegMaxHidden;
}
__host__ __device__ constexpr int walk_sub(bool regs) { return regs ? kRegSub : kSmemSub; }
// K as the kernel lays it out: padded to the register slices, or to 4.
__host__ __device__ constexpr int walk_kpad(int hidden, bool regs) {
  return regs ? kRegSub * kRegChunks * 4 : (hidden + 3) / 4 * 4;
}
__host__ __device__ constexpr int walk_threads(int hidden) {
  return (hidden * walk_sub(walk_in_registers(hidden)) + 31) / 32 * 32;
}

// Rows per block: the least power of two that brings ceil(B/R) * lanes
// blocks down to the SM count, at most the threads per unit (one gate lane
// per row).
int walk_row_tile(int batch, int lanes, int hidden) {
  const int most = walk_sub(walk_in_registers(hidden));
  const long long want = (static_cast<long long>(batch) * lanes + kNumSMs - 1) / kNumSMs;
  int rows = 1;
  while (rows < want && rows < most) rows *= 2;
  return rows;
}

// Dynamic shared memory: W (shared-memory instantiation only, [3H][kpad] in
// the stream dtype, padded to 16 bytes), then the two parity buffers of the
// tile's h operand, [2][rows][kpad] float32.
__host__ __device__ constexpr size_t walk_shared_bytes(int hidden, size_t itemsize, int rows) {
  return (walk_in_registers(hidden)
              ? 0
              : align16(size_t(3) * hidden * walk_kpad(hidden, false) * itemsize)) +
         size_t(2) * rows * walk_kpad(hidden, walk_in_registers(hidden)) * sizeof(float);
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

template <typename T, typename Layout, int R, bool kRegs>
__global__ void __launch_bounds__(kRegs ? kRegSub * kRegMaxHidden : kMaxThreads)
    gru_walk_kernel(const T* __restrict__ xg, const T* __restrict__ w_hh,
                    const T* __restrict__ b_hh, const float* __restrict__ h0,
                    T* __restrict__ ys, int n_steps, int batch, int hidden, int reverse) {
  constexpr int S = kRegs ? kRegSub : kSmemSub;
  static_assert(R <= S, "one gate lane per row");
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = hidden;
  const int kpad = walk_kpad(H, kRegs);
  const int lane = blockIdx.y;
  const int lanes = gridDim.y;
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int j = tid / S;   // hidden unit
  const int s = tid % S;   // sub-lane: K chunks s, s + S, ...; gate lane of row s
  const bool unit = j < H;
  const int ju = unit ? j : 0;  // padding threads read unit 0 and write nothing

  T* w_s = reinterpret_cast<T*>(smem);  // [3H][kpad], shared-memory instantiation
  float* hbuf = reinterpret_cast<float*>(
      smem + (kRegs ? 0 : align16(size_t(3) * H * kpad * sizeof(T))));  // [2][R][kpad]

  const T* w = w_hh + size_t(lane) * 3 * H * H;
  for (int e = tid; e < 2 * R * kpad; e += blockDim.x) {
    const int r = e / kpad;
    const int k = e - r * kpad;
    float v = 0.0f;
    if (r < R && k < H && row0 + r < batch)
      v = to_float(from_float<T>(h0[(size_t(lane) * batch + row0 + r) * H + k]));
    hbuf[e] = v;
  }
  float wreg[kRegs ? 3 * kRegChunks * 4 : 1];
  if constexpr (kRegs) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int ci = 0; ci < kRegChunks; ++ci)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * (s + S * ci) + e;
          wreg[(g * kRegChunks + ci) * 4 + e] =
              unit && k < H ? to_float(w[(size_t(g) * H + j) * H + k]) : 0.0f;
        }
  } else {
    for (int e = tid; e < 3 * H * kpad; e += blockDim.x) {
      const int row = e / kpad;
      const int k = e - row * kpad;
      w_s[e] = k < H ? w[size_t(row) * H + k] : from_float<T>(0.0f);
    }
  }

  // The gate lane of (row s, unit j): bias, f32 carry, and the xg ring.
  const int row = row0 + s;
  const bool gate = unit && s < R && row < batch;
  float br = 0.0f, bz = 0.0f, bn = 0.0f, hc = 0.0f;
  // The ring keeps the stream dtype: a conversion right after the load
  // would wait for it there.
  T xr[kPrefetch], xz[kPrefetch], xn[kPrefetch];
  auto fetch = [&](int step, int slot) {
    const int t = reverse ? n_steps - 1 - step : step;
    const T* x = xg + Layout::row(lane, t, row, lanes, n_steps, batch) * 3 * H;
    xr[slot] = x[j];
    xz[slot] = x[H + j];
    xn[slot] = x[2 * H + j];
  };
  if (gate) {
    const T* b = b_hh + size_t(lane) * 3 * H;
    br = to_float(b[j]);
    bz = to_float(b[H + j]);
    bn = to_float(b[2 * H + j]);
    hc = h0[(size_t(lane) * batch + row) * H + j];
#pragma unroll
    for (int d = 0; d < kPrefetch - 1; ++d)
      if (d < n_steps) fetch(d, d);
  }
  __syncthreads();

  const int nchunks = kpad / 4;
  for (int base = 0; base < n_steps; base += kPrefetch) {
#pragma unroll
    for (int d = 0; d < kPrefetch; ++d) {
      const int step = base + d;
      if (step >= n_steps) continue;  // the same for every thread
      // Refill the slot the last step emptied, right after the barrier: a
      // load still in flight at __syncthreads holds the barrier until it
      // lands, so a load issued just before it would put its whole latency
      // on the step's path.
      if (gate && step + kPrefetch - 1 < n_steps)
        fetch(step + kPrefetch - 1, (d + kPrefetch - 1) % kPrefetch);
      const float* hb = hbuf + (step & 1) * R * kpad;
      float acc[3][R];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[g][r] = 0.0f;
      auto chunk = [&](int c, const float (&wv)[3][4]) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float hv[4];
          load4(hb + r * kpad + 4 * c, hv);
#pragma unroll
          for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][r] = fmaf(hv[e], wv[g][e], acc[g][r]);
        }
      };
      if constexpr (kRegs) {
#pragma unroll
        for (int ci = 0; ci < kRegChunks; ++ci) {
          float wv[3][4];
#pragma unroll
          for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) wv[g][e] = wreg[(g * kRegChunks + ci) * 4 + e];
          chunk(s + S * ci, wv);
        }
      } else {
#pragma unroll(R >= 4 ? 1 : 2)  // more unrolling spills under the 768-thread bound
        for (int c = s; c < nchunks; c += S) {
          float wv[3][4];
#pragma unroll
          for (int g = 0; g < 3; ++g) load4(w_s + (size_t(g) * H + ju) * kpad + 4 * c, wv[g]);
          chunk(c, wv);
        }
      }
#pragma unroll
      for (int off = S / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], off);
      if (gate) {
        float hr = acc[0][0], hz = acc[1][0], hn = acc[2][0];
#pragma unroll
        for (int r = 1; r < R; ++r)
          if (s == r) {
            hr = acc[0][r];
            hz = acc[1][r];
            hn = acc[2][r];
          }
        const float rg = sigmoid(to_float(xr[d]) + (hr + br));
        const float zg = sigmoid(to_float(xz[d]) + (hz + bz));
        const float ng = tanhf(to_float(xn[d]) + rg * (hn + bn));
        hc = (1.0f - zg) * ng + zg * hc;
        const T out = from_float<T>(hc);
        hbuf[((step + 1) & 1) * R * kpad + s * kpad + j] = to_float(out);
        const int t = reverse ? n_steps - 1 - step : step;
        ys[Layout::row(lane, t, row, lanes, n_steps, batch) * H + j] = out;
      }
      __syncthreads();
    }
  }
}

template <typename T, typename Layout, int R, bool kRegs>
int walk_launch_tile(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
                     void* ys, int lanes, int n_steps, int batch, int hidden, int reverse,
                     void* stream) {
  const size_t smem = walk_shared_bytes(hidden, sizeof(T), R);
  cudaError_t err = cudaFuncSetAttribute(gru_walk_kernel<T, Layout, R, kRegs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((batch + R - 1) / R, lanes);
  gru_walk_kernel<T, Layout, R, kRegs>
      <<<grid, walk_threads(hidden), smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(xg), static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
          static_cast<const float*>(h0), static_cast<T*>(ys), n_steps, batch, hidden, reverse);
  return int(cudaGetLastError());
}

template <typename T, typename Layout, bool kRegs>
int walk_launch_path(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
                     void* ys, int lanes, int n_steps, int batch, int hidden, int reverse,
                     void* stream) {
  switch (walk_row_tile(batch, lanes, hidden)) {
    case 1:
      return walk_launch_tile<T, Layout, 1, kRegs>(xg, w_hh, b_hh, h0, ys, lanes, n_steps,
                                                   batch, hidden, reverse, stream);
    case 2:
      return walk_launch_tile<T, Layout, 2, kRegs>(xg, w_hh, b_hh, h0, ys, lanes, n_steps,
                                                   batch, hidden, reverse, stream);
    case 4:
      return walk_launch_tile<T, Layout, 4, kRegs>(xg, w_hh, b_hh, h0, ys, lanes, n_steps,
                                                   batch, hidden, reverse, stream);
    default:
      if constexpr (kRegs)
        return walk_launch_tile<T, Layout, 8, kRegs>(xg, w_hh, b_hh, h0, ys, lanes, n_steps,
                                                     batch, hidden, reverse, stream);
      return int(cudaErrorInvalidValue);
  }
}

// The instantiation is chosen from H before any launch; a shape the wrapper
// would have refused is refused here too, not launched.
template <typename T, typename Layout>
int walk_launch(const void* xg, const void* w_hh, const void* b_hh, const void* h0, void* ys,
                int lanes, int n_steps, int batch, int hidden, int reverse, void* stream) {
  const int rows = walk_row_tile(batch, lanes, hidden);
  if (walk_threads(hidden) > kMaxThreads ||
      walk_shared_bytes(hidden, sizeof(T), rows) > size_t(232448))
    return int(cudaErrorInvalidValue);
  if (walk_in_registers(hidden))
    return walk_launch_path<T, Layout, true>(xg, w_hh, b_hh, h0, ys, lanes, n_steps, batch,
                                             hidden, reverse, stream);
  return walk_launch_path<T, Layout, false>(xg, w_hh, b_hh, h0, ys, lanes, n_steps, batch,
                                            hidden, reverse, stream);
}

}  // namespace

extern "C" {

// Shared memory one block of gru_fwd / gru_fwd_fb / gru_bifwd needs for a
// tile of `rows`.
long long gru_walk_shared_bytes(int hidden, int bf16, int rows) {
  return (long long)walk_shared_bytes(hidden, bf16 ? sizeof(__nv_bfloat16) : sizeof(float),
                                      rows);
}

// Rows per block gru_fwd / gru_fwd_fb / gru_bifwd take for this shape.
int gru_walk_row_tile(int batch, int lanes, int hidden) {
  return walk_row_tile(batch, lanes, hidden);
}

// Counterpart of _gru_forward: xg [T, B, 3H] -> ys [T, B, H].
int gru_fwd(const void* xg, const void* w_hh, const void* b_hh, const void* h0, void* ys,
            int n_steps, int batch, int hidden, int reverse, int bf16, void* stream) {
  if (bf16) {
    return walk_launch<__nv_bfloat16, LaneMajor>(xg, w_hh, b_hh, h0, ys, 1, n_steps, batch,
                                                 hidden, reverse, stream);
  }
  return walk_launch<float, LaneMajor>(xg, w_hh, b_hh, h0, ys, 1, n_steps, batch, hidden,
                                       reverse, stream);
}

// Counterpart of _gru_forward_fb: xg [F, T, B, 3H] -> ys [F, T, B, H].
int gru_fwd_fb(const void* xg, const void* w_hh, const void* b_hh, const void* h0, void* ys,
               int lanes, int n_steps, int batch, int hidden, int reverse, int bf16,
               void* stream) {
  if (bf16) {
    return walk_launch<__nv_bfloat16, LaneMajor>(xg, w_hh, b_hh, h0, ys, lanes, n_steps,
                                                 batch, hidden, reverse, stream);
  }
  return walk_launch<float, LaneMajor>(xg, w_hh, b_hh, h0, ys, lanes, n_steps, batch, hidden,
                                       reverse, stream);
}

// Counterpart of _bigru_forward: both directions of one BiGRU layer, float32,
// direction 1's gates already flipped in time, so both walk forward:
// xg [T, 2, B, 3H], w [2, 3H, H], bh [2, 3H], h0 [2, B, H] -> ys [T, 2, B, H].
int gru_bifwd(const void* xg, const void* w_hh, const void* b_hh, const void* h0, void* ys,
              int n_steps, int batch, int hidden, void* stream) {
  return walk_launch<float, TimeMajor>(xg, w_hh, b_hh, h0, ys, 2, n_steps, batch, hidden, 0,
                                       stream);
}

}  // extern "C"
