// GRU forward recurrence for Hopper (sm_90a), kernels with a lane axis.
//
// Replaces three Pallas TPU kernels of multimodalsignal_tpu/ops/gru_pallas.py:
//   * _fwd_kernel    (called by _gru_forward)    -> C entry gru_fwd    (one lane)
//   * _fb_fwd_kernel (called by _gru_forward_fb) -> C entry gru_fwd_fb (F lanes)
//   * _bifwd_kernel  (called by _bigru_forward)  -> C entry gru_bifwd  (2 lanes,
//     the two directions of a BiGRU layer, float32 only; 2F lanes for F folds
//     of it under the fold axis)
// The layout of the streams is a type (LaneMajor, TimeMajor below): gru_bifwd
// reads the fused [T, L, B, 3H] gates in place, lane stride B*3H, time
// stride L*B*3H; the TPU kernels' time chunks and `valid` masks have no
// counterpart.
//
// What it computes, per lane f and batch row b (time-major, as the TPU
// kernels take it):
//   xg [F, T, B, 3H]  input gates x @ W_ih^T + b_ih, gate blocks r | z | n
//                     ([T, L, B, 3H] for gru_bifwd: the lane inside time)
//   w  [F, 3H, H]     recurrent weights in torch layout (rows r | z | n)
//   bh [F, 3H]        recurrent bias
//   h0 [F, B, H]      initial state, always float32
//   ys [F, T, B, H]   every step's state, in xg's dtype ([T, L, B, H] for
//                     gru_bifwd)
//     hg = h @ w^T + bh
//     r = sigmoid(xr + hr); z = sigmoid(xz + hz); n = tanh(xn + r * hn)
//     h = (1 - z) * n + z * h
// `reverse` walks time from T-1 down to 0; ys stays in original time order.
// The carry h is float32. With bf16 streams (xg, w, bh, ys) the product
// operands are bf16 (h is rounded to bf16 before the product) and the sums
// are float32, as the TPU kernels' bf16 mode does; otherwise all is float32.
//
// One kernel walks that recurrence for all three entries, gru_walk_kernel
// (gru_walk_cluster_kernel where W does not fit one block, below).
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
//
// The cluster walk: an H whose W does not fit one block's shared memory
// (f32 above H = 136, bf16 above 192) is split over a thread block cluster
// of K CTAs (walk_cluster_size: the least K <= 8, the portable cluster
// size, whose per-CTA share fits). The K CTAs of a cluster own one (lane,
// row tile); CTA `rank` keeps in its shared memory the rows of W of its
// own ceil(H/K) hidden units, all three gates, [3][units][K padded to 4],
// and the whole h operand [2][R][kpad], as the one-block walk does. Each
// step it forms its units' r, z, n and h' exactly as above, then stores its
// slice of h' into the next parity buffer of every CTA of the cluster
// through distributed shared memory (mapa / st.shared::cluster), and one cluster
// barrier (barrier.cluster arrive-release / wait-acquire) takes the place of
// __syncthreads. A first cluster barrier lets no CTA write a peer's buffer
// before the peer has started and laid out h0; a last one lets no CTA exit
// while a peer could still write into it. The row tile counts K CTAs for
// each (lane, tile) (walk_row_tile), and the launch (cudaLaunchKernelEx
// with the cluster dimension) is refused, not run, when
// cudaOccupancyMaxActiveClusters says no cluster of that size fits.
// The per-step path adds the remote stores (K a gate lane) and the cluster
// barrier's round trip to the one-block walk's; it is the only way this
// design holds W on chip at all past H = 136 f32 / 192 bf16, up to
// H = 380 f32 / 532 bf16 (K = 8).
//
// The grid walk: past the cluster's limit, wherever one lane's W fits the
// card's aggregate shared memory (f32 to H = 1408, bf16 to 2112 at B = 64,
// one lane: grid_plan), gru_walk_grid_kernel replaces the streamed walk
// below, which re-read from L2 every step the part of W its clusters could
// not hold (93.6 MB a step at f32 H = 1024, chip_smoke.py 16b) and ran in
// waves of the 15 clusters the card holds. A group of G CTAs, one CTA an SM, walks one
// work item (a lane and up to 64 batch rows); CTA `rank` keeps the W rows of
// its ceil(H / G) units in shared memory, loaded once an item and never
// re-read from device memory. What must cross between CTAs each step is the
// state: each CTA writes its units' slice of h' (rounded to the stream
// dtype) into an exchange buffer in device memory, [2 parity][rows][K padded
// to a tile], and after a group barrier (a counter in device memory: a
// release add, then acquire loads until all G arrivals are in; in place of
// barrier.cluster, since a group is larger than a cluster) every CTA reads
// the item's whole h back from L2, a K tile (128 or 64 columns, grid_plan)
// at a time, into a ring of up to 8 tiles in shared memory that every
// thread keeps filled with cp.async (.cg: in the generic proxy, so the
// acquire orders it without a proxy fence; TMA bulk copies would need
// one). In f32, thread (row group, unit, sub-lane s) forms its unit's r,
// z, n sums for 8 rows over chunks s, s + 8, ... of each tile on CUDA cores
// (TF32 would break the f32 tolerance); in bf16 the warps take 16-row x
// 8-unit tiles of the products on the tensor cores (mma.sync m16n8k16 from
// ldmatrix of the h tile and W's rows, f32 sums, K split over the warps and
// the slices' partials summed in a fixed order), the FMAs only where the
// pass makes no whole 16-row tile. Sub-lane s does row s's gate math. The
// G CTAs wait on each other every step, so the kernel is launched
// cooperatively (cudaLaunchAttributeCooperative: admitted only with every
// block resident) after the plan's groups are checked against the card's
// occupancy; a shape the plan cannot place is planned onto the streamed walk,
// statically, never launched to hang. G is the least group whose CTAs' share
// of W fits beside the tile ring and the carry; that sets how many groups
// run at once (at most the work items, which they take in turn), and the
// groups then spread over the 132 SMs. What bounds it: the state bytes
// every CTA reads each step (G x rows x H in the stream dtype, 33.5 MB at f32
// H = 1024: L2 bandwidth) and a fixed cost a step (the group barrier's
// round trips and the first tile's L2 latency, which chip_smoke.py 16b
// shows at H = 381, where the FMAs are few), not W's bytes.
//
// The streamed walk: past the grid walk's limit (gru_walk_stream_kernel) a
// cluster of kMaxCluster CTAs still owns one (lane, row tile) and exchanges h' over
// distributed shared memory with one cluster barrier a step, but a CTA no
// longer holds all of its units' W rows. It keeps as many units' rows
// [resident][3][kpad] in shared memory as fit beside its h buffers, its
// units' f32 carry and its threads' copy rings (stream_resident), and reads
// the other units' rows from device memory every step: W_hh is 12.6 MB at
// H = 1024 in f32, a quarter of the H100's 50 MB L2, so after the first
// step those reads hit L2. They go through a padded copy of W ([3H][kpad],
// written by gru_pad_rows_kernel before the walk, so that every 4-value
// chunk is aligned), each thread copying its own chunks with cp.async into
// a ring of two slots in shared memory: the next chunk is in flight while
// the thread's FMAs consume this one, and no barrier waits for the copies.
// What bounds it is those bytes: every (lane, row tile) reads the streamed
// part of W once a step, so a CTA takes as many batch rows as its gate
// lanes carry (kStreamMostRows, two a gate lane, fewer where the h buffers
// do not fit), and each byte read from L2 serves the whole row tile. A CTA
// walks its units in passes of blockDim / kSmemSub units (one pass up to
// H = 1024), so the only limit on H is its h buffers, its carry and its
// rings: f32 up to H = walk_max_hidden in gru_cuda.py.

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
constexpr int kMaxThreads = 768;      // 192 units x kSmemSub: the most units a block takes
constexpr int kMaxCluster = 8;        // the portable thread block cluster size
// The most threads a CTA of the cluster walk takes (544 is the most any H
// asks for): a lower launch bound than kMaxThreads leaves ptxas the
// registers its cluster bookkeeping needs without spilling.
constexpr int kClusterMaxThreads = 576;
constexpr size_t kMaxShared = 232448;
constexpr int kNoCluster = -1;        // returned when no cluster of the size fits the card
// The streamed walk: the most threads of a CTA, the most rows of a tile
// (two a gate lane), and the slots of each thread's cp.async ring.
constexpr int kStreamThreads = 512;
constexpr int kStreamMostRows = 8;
constexpr int kStreamStages = 2;
// Clusters of kMaxCluster CTAs of one CTA an SM that an H100 runs at once
// (cudaOccupancyMaxActiveClusters: 15, not 132 / 8).
constexpr int kStreamClusters = 15;

#include "gru_grid.cuh"

__host__ __device__ constexpr bool walk_in_registers(int hidden) {
  return hidden <= kRegMaxHidden;
}
__host__ __device__ constexpr int walk_sub(bool regs) { return regs ? kRegSub : kSmemSub; }
// K as the kernel lays it out: padded to the register slices, or to 4.
__host__ __device__ constexpr int walk_kpad(int hidden, bool regs) {
  return regs ? kRegSub * kRegChunks * 4 : (hidden + 3) / 4 * 4;
}
// Hidden units a CTA owns in a cluster of `cluster` CTAs (all H for one).
__host__ __device__ constexpr int walk_units(int hidden, int cluster) {
  return (hidden + cluster - 1) / cluster;
}
__host__ __device__ constexpr int walk_threads(int hidden, int cluster) {
  return (walk_units(hidden, cluster) * walk_sub(walk_in_registers(hidden)) + 31) / 32 * 32;
}

// Dynamic shared memory of one CTA: its W rows (shared-memory
// instantiations only, [3][units][kpad] in the stream dtype, padded to 16
// bytes), then the two parity buffers of the tile's whole h operand,
// [2][rows][kpad] float32.
__host__ __device__ constexpr size_t walk_shared_bytes(int hidden, size_t itemsize, int rows,
                                                       int cluster) {
  return (walk_in_registers(hidden)
              ? 0
              : align16(size_t(3) * walk_units(hidden, cluster) * walk_kpad(hidden, false) *
                        itemsize)) +
         size_t(2) * rows * walk_kpad(hidden, walk_in_registers(hidden)) * sizeof(float);
}

// CTAs per (lane, row tile): 1 while W fits one block (at the most rows a
// block takes, so for every batch), else the least cluster whose per-CTA
// share and threads fit; 0 where not even kMaxCluster does.
int walk_cluster_size(int hidden, size_t itemsize) {
  if (walk_in_registers(hidden)) return 1;
  for (int k = 1; k <= kMaxCluster; ++k)
    if (walk_threads(hidden, k) <= (k == 1 ? kMaxThreads : kClusterMaxThreads) &&
        walk_shared_bytes(hidden, itemsize, kSmemSub, k) <= kMaxShared)
      return k;
  return 0;
}

// Rows per (lane, tile): the least power of two that brings ceil(B/R) *
// lanes * cluster CTAs down to the SM count, at most the threads per unit
// (one gate lane per row).
int walk_row_tile(int batch, int lanes, int hidden, int cluster) {
  const int most = walk_sub(walk_in_registers(hidden));
  const long long want =
      (static_cast<long long>(batch) * lanes * cluster + kNumSMs - 1) / kNumSMs;
  int rows = 1;
  while (rows < want && rows < most) rows *= 2;
  return rows;
}

// The streamed walk (past walk_cluster_size's limit): kMaxCluster CTAs per
// (lane, row tile), each owning ceil(H / kMaxCluster) units.
__host__ __device__ constexpr int stream_units(int hidden) {
  return walk_units(hidden, kMaxCluster);
}
__host__ __device__ constexpr int stream_threads(int hidden) {
  return (stream_units(hidden) * kSmemSub + 31) / 32 * 32 < kStreamThreads
             ? (stream_units(hidden) * kSmemSub + 31) / 32 * 32
             : kStreamThreads;
}
// Shared memory of a streamed CTA beside its resident W rows: the two
// parity buffers of the tile's whole h operand [2][rows][kpad] f32, its
// units' f32 carry [rows][units] (padded to 16 bytes), and every thread's
// ring of kStreamStages slots of 3 gates x 4 values in the stream dtype.
__host__ __device__ constexpr size_t stream_fixed_bytes(int hidden, size_t itemsize, int rows) {
  return size_t(2) * rows * walk_kpad(hidden, false) * sizeof(float) +
         align16(size_t(rows) * stream_units(hidden) * sizeof(float)) +
         size_t(stream_threads(hidden)) * kStreamStages * 3 * 4 * itemsize;
}
// One unit's three W rows, K padded to 4, in the stream dtype.
__host__ __device__ constexpr size_t stream_unit_bytes(int hidden, size_t itemsize) {
  return size_t(3) * walk_kpad(hidden, false) * itemsize;
}
// Units of a CTA whose W rows stay in shared memory: as many as fit beside
// the fixed part (all of its units at most); -1 where not even that fits.
int stream_resident(int hidden, size_t itemsize, int rows) {
  const size_t fixed = stream_fixed_bytes(hidden, itemsize, rows);
  if (fixed > kMaxShared) return -1;
  const size_t unit = stream_unit_bytes(hidden, itemsize);
  long long res = static_cast<long long>((kMaxShared - fixed) / unit);
  if (res > stream_units(hidden)) res = stream_units(hidden);
  while (res > 0 && align16(size_t(res) * unit) + fixed > kMaxShared) --res;
  return int(res);
}
// Dynamic shared memory of a streamed CTA for a tile of `rows`: its
// resident W rows, padded to 16 bytes, then the fixed part.
size_t stream_shared_bytes(int hidden, size_t itemsize, int rows) {
  const int res = stream_resident(hidden, itemsize, rows);
  return (res > 0 ? align16(size_t(res) * stream_unit_bytes(hidden, itemsize)) : 0) +
         stream_fixed_bytes(hidden, itemsize, rows);
}
// The most rows a streamed tile takes at this H: the largest power of two up
// to kStreamMostRows whose fixed part fits; 1 where none does.
int stream_most_rows(int hidden, size_t itemsize) {
  for (int r = kStreamMostRows; r > 1; r /= 2)
    if (stream_fixed_bytes(hidden, itemsize, r) <= kMaxShared) return r;
  return 1;
}
// Rows per (lane, tile) of the streamed walk: the least power of two that
// brings ceil(B/R) * lanes clusters down to those the card runs at once
// (one wave), at most stream_most_rows.
int stream_row_tile(int batch, int lanes, int hidden, size_t itemsize) {
  const int most = stream_most_rows(hidden, itemsize);
  const long long want =
      (static_cast<long long>(batch) * lanes + kStreamClusters - 1) / kStreamClusters;
  int rows = 1;
  while (rows < want && rows < most) rows *= 2;
  return rows;
}
// Elements, in the stream dtype, of the workspace the forward entries take
// as w_pad: the grid walk's exchange buffers and counters, or the padded
// copy of W the streamed walk reads ([lanes][3H][kpad]); 0 for the other
// instantiations.
long long walk_workspace_elems(int batch, int lanes, int hidden, size_t itemsize) {
  if (walk_cluster_size(hidden, itemsize) != 0) return 0;
  const GridPlan g = grid_plan(batch, lanes, hidden, itemsize, false);
  if (g.ctas > 0) return static_cast<long long>(grid_workspace_bytes(g, itemsize) / itemsize);
  return static_cast<long long>(lanes) * 3 * hidden * walk_kpad(hidden, false);
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

// Thread block cluster primitives in PTX (sm_90): this CTA's rank in its
// cluster and the cluster's size, and a store into the shared memory of
// CTA `rank` at the address `p` has in this CTA (distributed shared memory).
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return int(r);
}
__device__ __forceinline__ int cluster_ctas() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return int(n);
}
__device__ __forceinline__ void store_cluster(float* p, int rank, float v) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}

// cp.async of 4 values of the stream dtype (16 bytes f32, 8 bytes bf16) from
// device into this thread's own shared memory; the thread waits for its
// copies with cp.async.wait_all.
__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_4(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The cluster barrier: every thread of every CTA of the cluster arrives
// (release: its shared and distributed shared memory stores are seen) and
// waits (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The walk's body, for gru_walk_kernel (one block per (lane, row tile)) and
// gru_walk_cluster_kernel (kCluster: a cluster per (lane, row tile)).
template <typename T, typename Layout, int R, bool kRegs, bool kCluster>
__device__ __forceinline__ void walk_body(const T* __restrict__ xg, const T* __restrict__ w_hh,
                                          const T* __restrict__ b_hh,
                                          const float* __restrict__ h0, T* __restrict__ ys,
                                          int n_steps, int batch, int hidden, int reverse) {
  constexpr int S = kRegs ? kRegSub : kSmemSub;
  static_assert(R <= S, "one gate lane per row");
  static_assert(!(kRegs && kCluster), "the cluster walk keeps W in shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = hidden;
  const int kpad = walk_kpad(H, kRegs);
  // The cluster walk: CTA `rank` of the `csize` sharing a (lane, row tile)
  // owns units unit0 .. unit0 + units - 1; one block owns all H.
  const int csize = kCluster ? cluster_ctas() : 1;
  const int rank = kCluster ? cluster_rank() : 0;
  const int units = kCluster ? walk_units(H, csize) : H;
  const int unit0 = rank * units;
  const int lane = blockIdx.y;
  const int lanes = gridDim.y;
  const int row0 = (kCluster ? blockIdx.x / csize : blockIdx.x) * R;
  const int tid = threadIdx.x;
  const int jl = tid / S;      // hidden unit of this CTA
  const int j = unit0 + jl;    // ... of the layer
  const int s = tid % S;       // sub-lane: K chunks s, s + S, ...; gate lane of row s
  const bool unit = jl < units && j < H;
  const int ju = unit ? jl : 0;  // padding threads read unit 0 and write nothing

  T* w_s = reinterpret_cast<T*>(smem);  // [3][units][kpad], shared-memory instantiations
  float* hbuf = reinterpret_cast<float*>(
      smem + (kRegs ? 0 : align16(size_t(3) * units * kpad * sizeof(T))));  // [2][R][kpad]

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
  } else if constexpr (kCluster) {
    for (int e = tid; e < 3 * units * kpad; e += blockDim.x) {
      const int row = e / kpad;  // gate g, unit unit0 + u
      const int k = e - row * kpad;
      const int g = row / units;
      const int u = unit0 + row - g * units;
      w_s[e] = k < H && u < H ? w[(size_t(g) * H + u) * H + k] : from_float<T>(0.0f);
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
  if constexpr (kCluster)
    cluster_sync();  // every CTA of the cluster has started and laid out h0
  else
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
          for (int g = 0; g < 3; ++g) load4(w_s + (size_t(g) * units + ju) * kpad + 4 * c, wv[g]);
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
        const int at = ((step + 1) & 1) * R * kpad + s * kpad + j;
        const int t = reverse ? n_steps - 1 - step : step;
        if constexpr (kCluster) {
          ys[Layout::row(lane, t, row, lanes, n_steps, batch) * H + j] = out;
          // This CTA's slice of h' into every CTA's next buffer (its own too).
          for (int p = 0; p < csize; ++p) store_cluster(hbuf + at, p, to_float(out));
        } else {
          hbuf[at] = to_float(out);
          ys[Layout::row(lane, t, row, lanes, n_steps, batch) * H + j] = out;
        }
      }
      if constexpr (kCluster)
        cluster_sync();
      else
        __syncthreads();
    }
  }
  if constexpr (kCluster) cluster_sync();  // no peer writes into this CTA after it exits
}

template <typename T, typename Layout, int R, bool kRegs>
__global__ void __launch_bounds__(kRegs ? kRegSub * kRegMaxHidden : kMaxThreads)
    gru_walk_kernel(const T* __restrict__ xg, const T* __restrict__ w_hh,
                    const T* __restrict__ b_hh, const float* __restrict__ h0,
                    T* __restrict__ ys, int n_steps, int batch, int hidden, int reverse) {
  walk_body<T, Layout, R, kRegs, false>(xg, w_hh, b_hh, h0, ys, n_steps, batch, hidden,
                                        reverse);
}

// The cluster walk: its own launch bound, with one block an SM (without the
// minimum, ptxas trades registers for a second block and spills).
template <typename T, typename Layout, int R>
__global__ void __launch_bounds__(kClusterMaxThreads, 1)
    gru_walk_cluster_kernel(const T* __restrict__ xg, const T* __restrict__ w_hh,
                            const T* __restrict__ b_hh, const float* __restrict__ h0,
                            T* __restrict__ ys, int n_steps, int batch, int hidden,
                            int reverse) {
  walk_body<T, Layout, R, false, true>(xg, w_hh, b_hh, h0, ys, n_steps, batch, hidden,
                                       reverse);
}

// The streamed walk (see the note at the top): a cluster of kMaxCluster
// CTAs per (lane, tile of R rows). CTA `rank` owns units unit0 .. unit0 +
// units - 1 and walks them in passes of blockDim / S units, S = kSmemSub
// threads a unit with K split across them as in the cluster walk. Units
// below `resident` read their rows of W from shared memory, the others from
// w_pad in device memory through the thread's cp.async ring. Gate lane s
// does the gate math of rows s, s + S, ..., reading xg (loaded before the
// dot) and the f32 carry of (row, unit) from shared memory.
template <typename T, typename Layout, int R>
__global__ void __launch_bounds__(kStreamThreads, 1)
    gru_walk_stream_kernel(const T* __restrict__ xg, const T* __restrict__ w_pad,
                           const T* __restrict__ b_hh, const float* __restrict__ h0,
                           T* __restrict__ ys, int n_steps, int batch, int hidden, int reverse,
                           int resident) {
  constexpr int S = kSmemSub;
  constexpr int RG = (R + S - 1) / S;  // rows per gate lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = hidden;
  const int kpad = walk_kpad(H, false);
  const int nchunks = kpad / 4;
  const int csize = cluster_ctas();
  const int rank = cluster_rank();
  const int units = walk_units(H, csize);
  const int unit0 = rank * units;
  const int mine = H - unit0 < units ? (H > unit0 ? H - unit0 : 0) : units;  // inside H
  const int lane = blockIdx.y;
  const int lanes = gridDim.y;
  const int row0 = blockIdx.x / csize * R;
  const int tid = threadIdx.x;
  const int per_pass = blockDim.x / S;
  const int s = tid % S;

  const size_t w_bytes = resident > 0 ? align16(size_t(resident) * 3 * kpad * sizeof(T)) : 0;
  T* w_s = reinterpret_cast<T*>(smem);                        // [resident][3][kpad]
  float* hbuf = reinterpret_cast<float*>(smem + w_bytes);     // [2][R][kpad]
  float* carry = hbuf + 2 * R * kpad;                          // [R][units]
  T* ring = reinterpret_cast<T*>(smem + w_bytes + size_t(2) * R * kpad * sizeof(float) +
                                 align16(size_t(R) * units * sizeof(float))) +
            size_t(tid) * kStreamStages * 12;                  // [kStreamStages][3][4]
  const T* w = w_pad + size_t(lane) * 3 * H * kpad;            // [3H][kpad]

  for (int e = tid; e < 2 * R * kpad; e += blockDim.x) {
    const int r = e / kpad;
    const int k = e - r * kpad;
    float v = 0.0f;
    if (r < R && k < H && row0 + r < batch)
      v = to_float(from_float<T>(h0[(size_t(lane) * batch + row0 + r) * H + k]));
    hbuf[e] = v;
  }
  for (int e = tid; e < R * units; e += blockDim.x) {
    const int r = e / units;
    const int u = e - r * units;
    carry[e] = u < mine && row0 + r < batch
                   ? h0[(size_t(lane) * batch + row0 + r) * H + unit0 + u]
                   : 0.0f;
  }
  for (int e = tid; e < resident * 3 * kpad; e += blockDim.x) {
    const int rw = e / kpad;  // unit rw / 3, gate rw % 3
    const int k = e - rw * kpad;
    const int u = rw / 3;
    const int g = rw - 3 * u;
    w_s[e] = u < mine ? w[(size_t(g) * H + unit0 + u) * kpad + k] : from_float<T>(0.0f);
  }
  cluster_sync();  // every CTA of the cluster has started and laid out h0

  for (int step = 0; step < n_steps; ++step) {
    const int t = reverse ? n_steps - 1 - step : step;
    const float* hb = hbuf + (step & 1) * R * kpad;
    float* hnext = hbuf + ((step + 1) & 1) * R * kpad;
    for (int p0 = 0; p0 < units; p0 += per_pass) {  // the same bounds for every thread
      const int jl = p0 + tid / S;
      const bool unit = jl < mine;
      const int j = unit0 + jl;
      // The gate lane's bias and xg, loaded before the dot that hides them.
      float br = 0.0f, bz = 0.0f, bn = 0.0f;
      T xr[RG], xz[RG], xn[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        xr[i] = xz[i] = xn[i] = from_float<T>(0.0f);
        const int r = s + S * i;
        if (unit && r < R && row0 + r < batch) {
          const T* x = xg + Layout::row(lane, t, row0 + r, lanes, n_steps, batch) * 3 * H;
          xr[i] = x[j];
          xz[i] = x[H + j];
          xn[i] = x[2 * H + j];
        }
      }
      if (unit && s < R) {
        const T* b = b_hh + size_t(lane) * 3 * H;
        br = to_float(b[j]);
        bz = to_float(b[H + j]);
        bn = to_float(b[2 * H + j]);
      }
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
      if (unit && jl < resident) {
        const T* wu = w_s + size_t(jl) * 3 * kpad;
#pragma unroll(R >= 8 ? 1 : 2)  // more unrolling spills under the 512-thread bound
        for (int c = s; c < nchunks; c += S) {
          float wv[3][4];
#pragma unroll
          for (int g = 0; g < 3; ++g) load4(wu + g * kpad + 4 * c, wv[g]);
          chunk(c, wv);
        }
      } else if (unit) {
        // Chunks s, s + S, ... of the unit's three rows, each copied into the
        // ring one chunk ahead of its FMAs; a slot is refilled one iteration
        // after it was read.
        const T* wu = w + size_t(j) * kpad;
        const int n = (nchunks - s + S - 1) / S;
        auto issue = [&](int i) {
          T* slot = ring + (i % kStreamStages) * 12;
#pragma unroll
          for (int g = 0; g < 3; ++g)
            cp_async_4(slot + 4 * g, wu + size_t(g) * H * kpad + 4 * (s + S * i));
        };
        if (n > 0) issue(0);
        for (int i = 0; i < n; ++i) {
          cp_async_wait_all();  // chunk i has landed
          float wv[3][4];
          const T* slot = ring + (i % kStreamStages) * 12;
#pragma unroll
          for (int g = 0; g < 3; ++g) load4(slot + 4 * g, wv[g]);
          if (i + 1 < n) issue(i + 1);
          chunk(s + S * i, wv);
        }
      }
#pragma unroll
      for (int off = S / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int r = 0; r < R; ++r) acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], off);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!unit || r % S != s || row0 + r >= batch) continue;
        const int i = r / S;
        const float rg = sigmoid(to_float(xr[i]) + (acc[0][r] + br));
        const float zg = sigmoid(to_float(xz[i]) + (acc[1][r] + bz));
        const float ng = tanhf(to_float(xn[i]) + rg * (acc[2][r] + bn));
        float* hc = carry + r * units + jl;
        *hc = (1.0f - zg) * ng + zg * *hc;
        const T out = from_float<T>(*hc);
        ys[Layout::row(lane, t, row0 + r, lanes, n_steps, batch) * H + j] = out;
        // This CTA's slice of h' into every CTA's next buffer (its own too).
        for (int p = 0; p < csize; ++p) store_cluster(hnext + r * kpad + j, p, to_float(out));
      }
    }
    cluster_sync();
  }
  cluster_sync();  // no peer writes into this CTA after it exits
}

// W [rows][cols] -> w_pad [rows][kpad], zeros past cols: the aligned copy
// the streamed walk reads its streamed rows from.
template <typename T>
__global__ void gru_pad_rows_kernel(const T* __restrict__ w, T* __restrict__ w_pad,
                                    long long rows, int cols, int kpad) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * kpad) return;
  const long long row = i / kpad;
  const int k = int(i - row * kpad);
  w_pad[i] = k < cols ? w[row * cols + k] : from_float<T>(0.0f);
}

// The grid walk (see the note at the top): a group of p.ctas CTAs, one an
// SM, walks one work item (a lane and up to p.rows batch rows) at a time;
// p.groups groups run at once and take the items in turn. CTA `rank` keeps
// the W rows of its p.units units, [3][units][kx + pad], in shared memory
// for the whole item. A step reads the whole h operand of the item's rows
// from the exchange buffer of its parity in device memory (L2), p.kt
// columns at a time through a ring of p.stages tiles that every thread
// fills with cp.async, passes of p.pass_rows rows; thread (row group, unit,
// sub-lane s) sums the r, z and n products of its kGridRows rows (row i of
// the pass's row groups interleaved: i x row groups + its own) over K
// chunks s, s + kGridSub, ... of each tile, an xor butterfly completes
// them, and sub-lane s does the gate math of its row s, writing h' to ys
// and to the other parity buffer; then the group barrier.
template <typename T, typename Layout>
__global__ void __launch_bounds__(grid_max_threads(false), 1)
    gru_walk_grid_kernel(const T* __restrict__ xg, const T* __restrict__ w_hh,
                         const T* __restrict__ b_hh, const float* __restrict__ h0,
                         T* __restrict__ ys, T* __restrict__ exch, unsigned* __restrict__ counters,
                         int lanes, int n_steps, int batch, int hidden, int reverse, GridPlan p) {
  constexpr int S = kGridSub;
  constexpr int R = kGridRows;
  constexpr int RS = R / S;                 // rows a gate lane
  constexpr int CH = 16 / int(sizeof(T));   // elements of one 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = hidden;
  const int kx = grid_kx(H, p.kt);
  const int kw = kx + kGridPad;
  const int kt = p.kt + kGridPad;
  const int u = p.units;
  const int group = blockIdx.x / p.ctas;
  const int rank = blockIdx.x - group * p.ctas;
  const int unit0 = rank * u;
  const int mine = H - unit0 < u ? (H > unit0 ? H - unit0 : 0) : u;  // inside H
  const int tid = threadIdx.x;
  const int s = tid % S;
  const int jl = tid / S % u;
  const int rg = tid / (S * u);
  const int row_groups_pass = p.pass_rows / R;
  const bool worker = rg < row_groups_pass;  // the others only copy
  const bool unit = worker && jl < mine;
  const int j = unit0 + jl;

  T* w_s = reinterpret_cast<T*>(smem);  // [3][u][kw]
  unsigned char* after_w = smem + align16(size_t(3) * u * kw * sizeof(T));
  T* tiles = reinterpret_cast<T*>(after_w);  // [stages][pass_rows][kt]
  float* carry = reinterpret_cast<float*>(
      after_w + size_t(p.stages) * p.pass_rows * kt * sizeof(T));  // [rows][u]
  T* ex = exch + size_t(group) * 2 * p.rows * kx;  // [2][rows][kx]
  unsigned* counter = counters + group;
  unsigned arrivals = 0;
  const int row_groups = (batch + p.rows - 1) / p.rows;
  const int items = lanes * row_groups;
  const int passes = (p.rows + p.pass_rows - 1) / p.pass_rows;
  const int ntiles = kx / p.kt;
  // The 16-byte chunk of every tile row this thread copies, and its rows: a
  // tile row is p.kt / CH chunks (8, 16 or 32), which divides the block.
  const int copy_col = tid % (p.kt / CH) * CH;
  const int copy_row = tid / (p.kt / CH);
  const int copy_rows = blockDim.x / (p.kt / CH);
  // bf16: the products on the tensor cores. Warp (m, n, k) takes 16-row
  // tile m of the pass, unit octet n (its three gates' 8-column tiles) and
  // every kslices-th 16-column step of each K tile; its f32 sums live in
  // acc[g][0..3], go to the ring's memory as partials after the K loop and
  // are summed over the K slices in a fixed order by the gate lanes. Where
  // the pass's rows make no whole 16-row tile, the warps cannot take every
  // (m, n) or the partials do not fit the ring, the FMAs run instead.
  const int warp = tid / 32;
  const int lane32 = tid % 32;
  const int mtiles = p.pass_rows / 16;
  const int octets = (u + 7) / 8;
  int kslices = mtiles > 0 ? int(blockDim.x / 32) / (mtiles * octets) : 0;
  if (kslices > p.kt / 16) kslices = p.kt / 16;
  const bool tensor = sizeof(T) == 2 && p.pass_rows % 16 == 0 && kslices > 0 &&
                      size_t(kslices) * p.pass_rows * 3 * u * sizeof(float) <=
                          size_t(p.stages) * p.pass_rows * kt * sizeof(T);
  const int mma_m = mtiles > 0 ? warp % mtiles : 0;
  const int mma_n = mtiles > 0 ? warp / mtiles % octets : 0;
  const int mma_k = mtiles > 0 ? warp / (mtiles * octets) : 0;
  const bool mma_warp = tensor && mma_k < kslices;

  for (int item = group; item < items; item += p.groups) {
    const int lane = item / row_groups;
    const int b0 = (item - lane * row_groups) * p.rows;
    const int nb = batch - b0 < p.rows ? batch - b0 : p.rows;
    const T* w = w_hh + size_t(lane) * 3 * H * H;
    for (int e = tid; e < 3 * u * kw; e += blockDim.x) {
      const int row = e / kw;  // gate row / u, unit row % u
      const int k = e - row * kw;
      const int g = row / u;
      const int ul = row - g * u;
      w_s[e] = k < H && ul < mine ? w[(size_t(g) * H + unit0 + ul) * H + k] : from_float<T>(0.0f);
    }
    // The carry, and h0 rounded to the stream dtype as step 0's operand (the
    // other parity's rows zeroed, so rows past the batch stay finite).
    for (int e = tid; e < p.rows * u; e += blockDim.x) {
      const int r = e / u;
      const int ul = e - r * u;
      const float v =
          r < nb && ul < mine ? h0[(size_t(lane) * batch + b0 + r) * H + unit0 + ul] : 0.0f;
      carry[e] = v;
      if (ul < mine) {
        ex[size_t(r) * kx + unit0 + ul] = from_float<T>(v);
        ex[size_t(p.rows + r) * kx + unit0 + ul] = from_float<T>(0.0f);
      }
    }
    float br = 0.0f, bz = 0.0f, bn = 0.0f;
    if (unit) {
      const T* b = b_hh + size_t(lane) * 3 * H;
      br = to_float(b[j]);
      bz = to_float(b[H + j]);
      bn = to_float(b[2 * H + j]);
    }
    group_sync(counter, arrivals += p.ctas);

    for (int step = 0; step < n_steps; ++step) {
      const int t = reverse ? n_steps - 1 - step : step;
      const T* cur = ex + size_t(step & 1) * p.rows * kx;
      T* nxt = ex + size_t((step + 1) & 1) * p.rows * kx;
      for (int pass = 0; pass < passes; ++pass) {
        const int pr0 = pass * p.pass_rows;
        // The gate lane's xg, loaded before the K loop that hides them.
        T xr[RS], xz[RS], xn[RS];
#pragma unroll
        for (int i = 0; i < RS; ++i) {
          xr[i] = xz[i] = xn[i] = from_float<T>(0.0f);
          const int r = pr0 + (s + S * i) * row_groups_pass + rg;
          if (unit && r < nb) {
            const T* x = xg + Layout::row(lane, t, b0 + r, lanes, n_steps, batch) * 3 * H;
            xr[i] = x[j];
            xz[i] = x[H + j];
            xn[i] = x[2 * H + j];
          }
        }
        auto load_tile = [&](int tile) {  // tile `tile` of this pass into its ring slot
          if (tile < ntiles) {
            T* dst = tiles + size_t(tile % p.stages) * p.pass_rows * kt + copy_col;
            const T* src = cur + size_t(tile) * p.kt + copy_col;
            for (int r = copy_row; r < p.pass_rows; r += copy_rows) {
              const bool valid = pr0 + r < p.rows;
              cp_async16_zfill(dst + r * kt, src + (valid ? size_t(pr0 + r) * kx : 0), valid);
            }
          }
          cp_async_commit();
        };
        float acc[3][R];
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int i = 0; i < R; ++i) acc[g][i] = 0.0f;
        for (int tile = 0; tile < p.stages - 1; ++tile) load_tile(tile);
        for (int tile = 0; tile < ntiles; ++tile) {
          cp_async_wait_pending(p.stages - 2);
          __syncthreads();  // the tile is in; the slot refilled next is read by no one
          load_tile(tile + p.stages - 1);
          if (tensor) {
            if (mma_warp) {
              const T* hs = tiles + size_t(tile % p.stages) * p.pass_rows * kt;
              const T* a_row = hs + size_t(mma_m * 16 + lane32 % 16) * kt + lane32 / 16 * 8;
              // W's row of this lane's unit of the octet (a unit past u
              // reads the last one: its columns are dropped below).
              int b_unit = mma_n * 8 + lane32 % 8;
              if (b_unit > u - 1) b_unit = u - 1;
              const T* b_row = w_s + size_t(b_unit) * kw + tile * p.kt + lane32 / 8 % 2 * 8;
              for (int kk = mma_k; kk < p.kt / 16; kk += kslices) {
                unsigned a[4];
                ldmatrix_x4(a, a_row + kk * 16);
#pragma unroll
                for (int g = 0; g < 3; ++g) {
                  unsigned b[2];
                  ldmatrix_x2(b, b_row + size_t(g) * u * kw + kk * 16);
                  mma_bf16_16816(acc[g], a, b);
                }
              }
            }
          } else if (worker) {
            const T* hs = tiles + size_t(tile % p.stages) * p.pass_rows * kt + size_t(rg) * kt;
            const T* ws = w_s + size_t(jl) * kw + tile * p.kt;
#pragma unroll 1  // unrolled, the chunks' loads spill under the 512-thread bound
            for (int cc = 0; cc < p.kt / (4 * S); ++cc) {
              const int c = 4 * (s + S * cc);
              float wv[3][4];
#pragma unroll
              for (int g = 0; g < 3; ++g) load4(ws + size_t(g) * u * kw + c, wv[g]);
#pragma unroll
              for (int i = 0; i < R; ++i) {
                float hv[4];
                load4(hs + size_t(i) * row_groups_pass * kt + c, hv);
#pragma unroll
                for (int g = 0; g < 3; ++g)
#pragma unroll
                  for (int e = 0; e < 4; ++e) acc[g][i] = fmaf(hv[e], wv[g][e], acc[g][i]);
              }
            }
          }
        }
        if (tensor) {
          __syncthreads();  // no warp reads the ring any more: it takes the partials
          float* part = reinterpret_cast<float*>(tiles);  // [kslices][pass_rows][3 u]
          if (mma_warp) {
#pragma unroll
            for (int g = 0; g < 3; ++g)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int row = mma_m * 16 + lane32 / 4 + e / 2 * 8;
                const int col = mma_n * 8 + lane32 % 4 * 2 + e % 2;
                if (col < u) part[(size_t(mma_k) * p.pass_rows + row) * 3 * u + g * u + col] = acc[g][e];
              }
          }
          __syncthreads();
#pragma unroll
          for (int i8 = 0; i8 < R; ++i8) {
            if (!worker || i8 % S != s) continue;
            const int rl = i8 * row_groups_pass + rg;
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              float sum = 0.0f;
              for (int k = 0; k < kslices; ++k) sum += part[(size_t(k) * p.pass_rows + rl) * 3 * u + g * u + jl];
              acc[g][i8] = sum;
            }
          }
        } else {
#pragma unroll
          for (int off = S / 2; off > 0; off >>= 1)
#pragma unroll
            for (int g = 0; g < 3; ++g)
#pragma unroll
              for (int i = 0; i < R; ++i) acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        }
#pragma unroll
        for (int i8 = 0; i8 < R; ++i8) {
          const int r = pr0 + i8 * row_groups_pass + rg;
          if (!unit || i8 % S != s || r >= nb) continue;
          const int i = i8 / S;
          const float rgate = sigmoid(to_float(xr[i]) + (acc[0][i8] + br));
          const float zg = sigmoid(to_float(xz[i]) + (acc[1][i8] + bz));
          const float ng = tanhf(to_float(xn[i]) + rgate * (acc[2][i8] + bn));
          float* hc = carry + r * u + jl;
          *hc = (1.0f - zg) * ng + zg * *hc;
          const T out = from_float<T>(*hc);
          ys[Layout::row(lane, t, b0 + r, lanes, n_steps, batch) * H + j] = out;
          nxt[size_t(r) * kx + j] = out;
        }
        __syncthreads();  // the ring's slots are free for the next pass
      }
      group_sync(counter, arrivals += p.ctas);
    }
  }
}

template <typename T, typename Layout, int R, bool kRegs, bool kCluster>
constexpr auto walk_kernel() {
  if constexpr (kCluster)
    return gru_walk_cluster_kernel<T, Layout, R>;
  else
    return gru_walk_kernel<T, Layout, R, kRegs>;
}

template <typename T, typename Layout, int R, bool kRegs>
int walk_launch_tile(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
                     void* ys, int lanes, int n_steps, int batch, int hidden, int reverse,
                     void* stream) {
  const size_t smem = walk_shared_bytes(hidden, sizeof(T), R, 1);
  cudaError_t err = cudaFuncSetAttribute(gru_walk_kernel<T, Layout, R, kRegs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((batch + R - 1) / R, lanes);
  gru_walk_kernel<T, Layout, R, kRegs>
      <<<grid, walk_threads(hidden, 1), smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(xg), static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
          static_cast<const float*>(h0), static_cast<T*>(ys), n_steps, batch, hidden, reverse);
  return int(cudaGetLastError());
}

// The launch of the cluster walk for a tile of R rows: the grid's x holds
// `cluster` CTAs for each row tile, one cluster apiece.
template <int R>
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int lanes, int batch, int hidden, int cluster, size_t smem, void* stream) {
    cfg.gridDim = dim3((batch + R - 1) / R * cluster, lanes);
    cfg.blockDim = dim3(walk_threads(hidden, cluster));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of the cluster walk the card holds at once for this shape, or a
// negative CUDA error.
template <typename T, typename Layout, int R>
int walk_active_clusters_tile(int lanes, int batch, int hidden, int cluster) {
  const auto kernel = gru_walk_cluster_kernel<T, Layout, R>;
  const size_t smem = walk_shared_bytes(hidden, sizeof(T), R, cluster);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int clusters = 0;
  if (err == cudaSuccess) {
    const ClusterLaunch<R> launch(lanes, batch, hidden, cluster, smem, nullptr);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.cfg);
  }
  return err == cudaSuccess ? clusters : -int(err);
}

// The cluster walk: refused (kNoCluster) before the launch when no cluster
// of its size fits the card; cudaLaunchKernelEx's result is returned.
template <typename T, typename Layout, int R>
int walk_launch_cluster(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
                        void* ys, int lanes, int n_steps, int batch, int hidden, int reverse,
                        int cluster, void* stream) {
  const int clusters = walk_active_clusters_tile<T, Layout, R>(lanes, batch, hidden, cluster);
  if (clusters < 0) return -clusters;
  if (clusters == 0) return kNoCluster;
  const ClusterLaunch<R> launch(lanes, batch, hidden, cluster,
                                           walk_shared_bytes(hidden, sizeof(T), R, cluster),
                                           stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &launch.cfg, gru_walk_cluster_kernel<T, Layout, R>, static_cast<const T*>(xg),
      static_cast<const T*>(w_hh), static_cast<const T*>(b_hh), static_cast<const float*>(h0),
      static_cast<T*>(ys), n_steps, batch, hidden, reverse);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// The launch of the streamed walk for a tile of R rows: the grid's x holds
// kMaxCluster CTAs for each row tile, one cluster apiece.
template <int R>
struct StreamLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  StreamLaunch(int lanes, int batch, int hidden, size_t smem, void* stream) {
    cfg.gridDim = dim3((batch + R - 1) / R * kMaxCluster, lanes);
    cfg.blockDim = dim3(stream_threads(hidden));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kMaxCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of the streamed walk the card holds at once for this shape, or a
// negative CUDA error.
template <typename T, typename Layout, int R>
int stream_active_clusters_tile(int lanes, int batch, int hidden) {
  const auto kernel = gru_walk_stream_kernel<T, Layout, R>;
  const size_t smem = stream_shared_bytes(hidden, sizeof(T), R);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int clusters = 0;
  if (err == cudaSuccess) {
    const StreamLaunch<R> launch(lanes, batch, hidden, smem, nullptr);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.cfg);
  }
  return err == cudaSuccess ? clusters : -int(err);
}

// The streamed walk: W padded into w_pad, then the walk; refused
// (kNoCluster) before the launch when no cluster fits the card.
template <typename T, typename Layout, int R>
int walk_launch_stream(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
                       void* ys, void* w_pad, int lanes, int n_steps, int batch, int hidden,
                       int reverse, void* stream) {
  const int resident = stream_resident(hidden, sizeof(T), R);
  if (resident < 0) return int(cudaErrorInvalidValue);
  const int clusters = stream_active_clusters_tile<T, Layout, R>(lanes, batch, hidden);
  if (clusters < 0) return -clusters;
  if (clusters == 0) return kNoCluster;
  const int kpad = walk_kpad(hidden, false);
  const long long rows = static_cast<long long>(lanes) * 3 * hidden;
  const int pad_threads = 256;
  gru_pad_rows_kernel<T><<<unsigned((rows * kpad + pad_threads - 1) / pad_threads), pad_threads,
                           0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w_hh), static_cast<T*>(w_pad), rows, hidden, kpad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const StreamLaunch<R> launch(lanes, batch, hidden, stream_shared_bytes(hidden, sizeof(T), R),
                               stream);
  err = cudaLaunchKernelEx(&launch.cfg, gru_walk_stream_kernel<T, Layout, R>,
                           static_cast<const T*>(xg), static_cast<const T*>(w_pad),
                           static_cast<const T*>(b_hh), static_cast<const float*>(h0),
                           static_cast<T*>(ys), n_steps, batch, hidden, reverse, resident);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <typename T, typename Layout>
int walk_launch_stream_path(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
                            void* ys, void* w_pad, int lanes, int n_steps, int batch,
                            int hidden, int reverse, void* stream) {
  switch (stream_row_tile(batch, lanes, hidden, sizeof(T))) {
    case 1:
      return walk_launch_stream<T, Layout, 1>(xg, w_hh, b_hh, h0, ys, w_pad, lanes, n_steps,
                                              batch, hidden, reverse, stream);
    case 2:
      return walk_launch_stream<T, Layout, 2>(xg, w_hh, b_hh, h0, ys, w_pad, lanes, n_steps,
                                              batch, hidden, reverse, stream);
    case 4:
      return walk_launch_stream<T, Layout, 4>(xg, w_hh, b_hh, h0, ys, w_pad, lanes, n_steps,
                                              batch, hidden, reverse, stream);
    default:
      return walk_launch_stream<T, Layout, 8>(xg, w_hh, b_hh, h0, ys, w_pad, lanes, n_steps,
                                              batch, hidden, reverse, stream);
  }
}

template <typename T, typename Layout, bool kRegs>
int walk_launch_path(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
                     void* ys, int lanes, int n_steps, int batch, int hidden, int reverse,
                     void* stream) {
  switch (walk_row_tile(batch, lanes, hidden, 1)) {
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

template <typename T, typename Layout>
int walk_launch_cluster_path(const void* xg, const void* w_hh, const void* b_hh,
                             const void* h0, void* ys, int lanes, int n_steps, int batch,
                             int hidden, int reverse, int cluster, void* stream) {
  switch (walk_row_tile(batch, lanes, hidden, cluster)) {
    case 1:
      return walk_launch_cluster<T, Layout, 1>(xg, w_hh, b_hh, h0, ys, lanes, n_steps, batch,
                                               hidden, reverse, cluster, stream);
    case 2:
      return walk_launch_cluster<T, Layout, 2>(xg, w_hh, b_hh, h0, ys, lanes, n_steps, batch,
                                               hidden, reverse, cluster, stream);
    default:
      return walk_launch_cluster<T, Layout, 4>(xg, w_hh, b_hh, h0, ys, lanes, n_steps, batch,
                                               hidden, reverse, cluster, stream);
  }
}

// The instantiation is chosen from the shape and the dtype before any
// launch: W in registers, W in one block's shared memory, split over a
// cluster, held across a group of CTAs spanning the card past the cluster's
// limit, or streamed where not even that holds one lane's W; an H the
// wrapper would have refused is refused here too, not launched. w_pad is
// the grid walk's exchange workspace or the streamed walk's padded W.
template <typename T, typename Layout>
int walk_launch(const void* xg, const void* w_hh, const void* b_hh, const void* h0, void* ys,
                void* w_pad, int lanes, int n_steps, int batch, int hidden, int reverse,
                void* stream) {
  const int cluster = walk_cluster_size(hidden, sizeof(T));
  if (cluster == 0) {
    const GridPlan grid = grid_plan(batch, lanes, hidden, sizeof(T), false);
    if (grid.ctas > 0)
      return grid_launch<T>(gru_walk_grid_kernel<T, Layout>, grid, w_pad,
                            static_cast<cudaStream_t>(stream), lanes, n_steps, batch, hidden,
                            reverse, static_cast<const T*>(xg), static_cast<const T*>(w_hh),
                            static_cast<const T*>(b_hh), static_cast<const float*>(h0),
                            static_cast<T*>(ys));
    if (stream_shared_bytes(hidden, sizeof(T), stream_most_rows(hidden, sizeof(T))) > kMaxShared)
      return int(cudaErrorInvalidValue);
    return walk_launch_stream_path<T, Layout>(xg, w_hh, b_hh, h0, ys, w_pad, lanes, n_steps,
                                              batch, hidden, reverse, stream);
  }
  if (cluster > 1)
    return walk_launch_cluster_path<T, Layout>(xg, w_hh, b_hh, h0, ys, lanes, n_steps, batch,
                                               hidden, reverse, cluster, stream);
  if (walk_in_registers(hidden))
    return walk_launch_path<T, Layout, true>(xg, w_hh, b_hh, h0, ys, lanes, n_steps, batch,
                                             hidden, reverse, stream);
  return walk_launch_path<T, Layout, false>(xg, w_hh, b_hh, h0, ys, lanes, n_steps, batch,
                                            hidden, reverse, stream);
}

// Blocks of the walk kernel (LaneMajor) one SM holds at once for a tile of R
// rows, from CUDA's occupancy calculator; a negative CUDA error if it fails.
template <typename T, int R, bool kRegs, bool kCluster>
int walk_blocks_tile(int hidden, int cluster) {
  const auto kernel = walk_kernel<T, LaneMajor, R, kRegs, kCluster>();
  const size_t smem = walk_shared_bytes(hidden, sizeof(T), R, cluster);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        walk_threads(hidden, cluster), smem);
  return err == cudaSuccess ? blocks : -int(err);
}

template <typename T, int R>
int stream_blocks_tile(int hidden) {
  const auto kernel = gru_walk_stream_kernel<T, LaneMajor, R>;
  const size_t smem = stream_shared_bytes(hidden, sizeof(T), R);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, stream_threads(hidden),
                                                        smem);
  return err == cudaSuccess ? blocks : -int(err);
}

template <typename T>
int walk_blocks_per_sm(int batch, int lanes, int hidden) {
  const int cluster = walk_cluster_size(hidden, sizeof(T));
  const GridPlan grid = grid_plan(batch, lanes, hidden, sizeof(T), false);
  if (cluster == 0 && grid.ctas > 0) {
    int per_sm = 0;
    const auto kernel = gru_walk_grid_kernel<T, LaneMajor>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(grid.smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, grid.threads,
                                                          size_t(grid.smem));
    return err == cudaSuccess ? per_sm : -int(err);
  }
  if (cluster == 0) {
    switch (stream_row_tile(batch, lanes, hidden, sizeof(T))) {
      case 1: return stream_blocks_tile<T, 1>(hidden);
      case 2: return stream_blocks_tile<T, 2>(hidden);
      case 4: return stream_blocks_tile<T, 4>(hidden);
      default: return stream_blocks_tile<T, 8>(hidden);
    }
  }
  const int rows = walk_row_tile(batch, lanes, hidden, cluster);
  if (cluster > 1) {
    switch (rows) {
      case 1: return walk_blocks_tile<T, 1, false, true>(hidden, cluster);
      case 2: return walk_blocks_tile<T, 2, false, true>(hidden, cluster);
      default: return walk_blocks_tile<T, 4, false, true>(hidden, cluster);
    }
  }
  const bool regs = walk_in_registers(hidden);
  switch (rows) {
    case 1:
      return regs ? walk_blocks_tile<T, 1, true, false>(hidden, 1)
                  : walk_blocks_tile<T, 1, false, false>(hidden, 1);
    case 2:
      return regs ? walk_blocks_tile<T, 2, true, false>(hidden, 1)
                  : walk_blocks_tile<T, 2, false, false>(hidden, 1);
    case 4:
      return regs ? walk_blocks_tile<T, 4, true, false>(hidden, 1)
                  : walk_blocks_tile<T, 4, false, false>(hidden, 1);
    default:
      return regs ? walk_blocks_tile<T, 8, true, false>(hidden, 1) : -int(cudaErrorInvalidValue);
  }
}

// Clusters of the walk (LaneMajor) the card holds at once for this shape;
// without a cluster, the blocks it holds (blocks per SM times the SMs).
template <typename T>
int walk_active_clusters(int batch, int lanes, int hidden) {
  const int cluster = walk_cluster_size(hidden, sizeof(T));
  const GridPlan grid = grid_plan(batch, lanes, hidden, sizeof(T), false);
  if (cluster == 0 && grid.ctas > 0) {
    const int resident = grid_resident_ctas(gru_walk_grid_kernel<T, LaneMajor>, grid);
    return resident < 0 ? resident : resident / grid.ctas;
  }
  if (cluster == 0) {
    switch (stream_row_tile(batch, lanes, hidden, sizeof(T))) {
      case 1: return stream_active_clusters_tile<T, LaneMajor, 1>(lanes, batch, hidden);
      case 2: return stream_active_clusters_tile<T, LaneMajor, 2>(lanes, batch, hidden);
      case 4: return stream_active_clusters_tile<T, LaneMajor, 4>(lanes, batch, hidden);
      default: return stream_active_clusters_tile<T, LaneMajor, 8>(lanes, batch, hidden);
    }
  }
  if (cluster == 1) {
    const int per_sm = walk_blocks_per_sm<T>(batch, lanes, hidden);
    return per_sm < 0 ? per_sm : per_sm * kNumSMs;
  }
  switch (walk_row_tile(batch, lanes, hidden, cluster)) {
    case 1: return walk_active_clusters_tile<T, LaneMajor, 1>(lanes, batch, hidden, cluster);
    case 2: return walk_active_clusters_tile<T, LaneMajor, 2>(lanes, batch, hidden, cluster);
    default: return walk_active_clusters_tile<T, LaneMajor, 4>(lanes, batch, hidden, cluster);
  }
}

}  // namespace

extern "C" {

// Walk blocks one SM holds at once for this shape (gru_fwd_fb's wave count
// of ceil(B / R) * lanes blocks follows).
int gru_walk_blocks_per_sm(int batch, int lanes, int hidden, int bf16) {
  return bf16 ? walk_blocks_per_sm<__nv_bfloat16>(batch, lanes, hidden)
              : walk_blocks_per_sm<float>(batch, lanes, hidden);
}

// Clusters of the walk the card holds at once for this shape (blocks,
// without a cluster; the grid walk's groups); the wave count of
// ceil(B / R) * lanes clusters follows.
int gru_walk_active_clusters(int batch, int lanes, int hidden, int bf16) {
  return bf16 ? walk_active_clusters<__nv_bfloat16>(batch, lanes, hidden)
              : walk_active_clusters<float>(batch, lanes, hidden);
}

// CTAs of gru_fwd / gru_fwd_fb / gru_bifwd per (lane, row tile) at this H:
// 1 while W fits one block, up to 8 for the cluster walk, 0 past the limit.
int gru_walk_cluster_size(int hidden, int bf16) {
  return walk_cluster_size(hidden, bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
}

// Shared memory one CTA of gru_fwd / gru_fwd_fb / gru_bifwd needs for a
// tile of `rows` at this H's cluster size, or the streamed walk's past the
// cluster's limit (the grid walk's, which depends on the batch and lanes,
// is gru_walk_plan's).
long long gru_walk_shared_bytes(int hidden, int bf16, int rows) {
  const size_t item = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const int cluster = walk_cluster_size(hidden, item);
  if (cluster == 0) return (long long)stream_shared_bytes(hidden, item, rows);
  return (long long)walk_shared_bytes(hidden, item, rows, cluster);
}

// Rows per (lane, tile) gru_fwd / gru_fwd_fb / gru_bifwd take for this
// shape (the streamed walk's past the cluster's limit).
int gru_walk_row_tile(int batch, int lanes, int hidden, int bf16) {
  const size_t item = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const int cluster = walk_cluster_size(hidden, item);
  if (cluster == 0) return stream_row_tile(batch, lanes, hidden, item);
  return walk_row_tile(batch, lanes, hidden, cluster);
}

// The walk's plan for this shape, as nine numbers: the instantiation (0 W
// in registers, 1 W in one block's shared memory, 2 the cluster walk, 3 the
// grid walk, 4 the streamed walk), the CTAs per (lane, row tile) (the grid
// walk: of a group), the row tile (the grid walk: rows of a work item), a
// CTA's units whose W rows are resident in shared memory and those streamed
// from device memory, the CTA's dynamic shared bytes, the elements of the
// w_pad workspace, and for the grid walk the groups at once and a CTA's
// threads (0 otherwise).
void gru_walk_plan(int batch, int lanes, int hidden, int bf16, long long* out) {
  const size_t item = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const int cluster = walk_cluster_size(hidden, item);
  const GridPlan grid = grid_plan(batch, lanes, hidden, item, false);
  out[7] = out[8] = 0;
  if (cluster == 0 && grid.ctas > 0) {
    out[0] = 3;
    out[1] = grid.ctas;
    out[2] = grid.rows;
    out[3] = grid.units;
    out[4] = 0;
    out[5] = grid.smem;
    out[7] = grid.groups;
    out[8] = grid.threads;
  } else {
    const int rows = gru_walk_row_tile(batch, lanes, hidden, bf16);
    if (cluster == 0) {
      const int res = stream_resident(hidden, item, rows);
      out[0] = 4;
      out[1] = kMaxCluster;
      out[3] = res;
      out[4] = stream_units(hidden) - (res > 0 ? res : 0);
    } else {
      out[0] = walk_in_registers(hidden) ? 0 : cluster == 1 ? 1 : 2;
      out[1] = cluster;
      out[3] = walk_units(hidden, cluster);
      out[4] = 0;
    }
    out[2] = rows;
    out[5] = gru_walk_shared_bytes(hidden, bf16, rows);
  }
  out[6] = walk_workspace_elems(batch, lanes, hidden, item);
}

// Counterpart of _gru_forward: xg [T, B, 3H] -> ys [T, B, H]. w_pad is the
// grid or streamed walk's workspace of gru_walk_plan's elements in xg's
// dtype (unread by the other instantiations).
int gru_fwd(const void* xg, const void* w_hh, const void* b_hh, const void* h0, void* ys,
            void* w_pad, int n_steps, int batch, int hidden, int reverse, int bf16,
            void* stream) {
  if (bf16) {
    return walk_launch<__nv_bfloat16, LaneMajor>(xg, w_hh, b_hh, h0, ys, w_pad, 1, n_steps,
                                                 batch, hidden, reverse, stream);
  }
  return walk_launch<float, LaneMajor>(xg, w_hh, b_hh, h0, ys, w_pad, 1, n_steps, batch, hidden,
                                       reverse, stream);
}

// Counterpart of _gru_forward_fb: xg [F, T, B, 3H] -> ys [F, T, B, H].
int gru_fwd_fb(const void* xg, const void* w_hh, const void* b_hh, const void* h0, void* ys,
               void* w_pad, int lanes, int n_steps, int batch, int hidden, int reverse,
               int bf16, void* stream) {
  if (bf16) {
    return walk_launch<__nv_bfloat16, LaneMajor>(xg, w_hh, b_hh, h0, ys, w_pad, lanes,
                                                 n_steps, batch, hidden, reverse, stream);
  }
  return walk_launch<float, LaneMajor>(xg, w_hh, b_hh, h0, ys, w_pad, lanes, n_steps, batch,
                                       hidden, reverse, stream);
}

// Counterpart of _bigru_forward: both directions of BiGRU layers, float32,
// each backward direction's gates already flipped in time, so every lane
// walks forward: xg [T, L, B, 3H], w [L, 3H, H], bh [L, 3H], h0 [L, B, H]
// -> ys [T, L, B, H]. One layer is L = 2 (lane 0 forward, lane 1 backward);
// F folds of one layer under the fold axis are L = 2F, lane 2f fold f's
// forward direction and lane 2f + 1 its backward one ([T, F, 2, B, .]
// viewed as [T, 2F, B, .]), each with its own weights.
int gru_bifwd(const void* xg, const void* w_hh, const void* b_hh, const void* h0, void* ys,
              void* w_pad, int lanes, int n_steps, int batch, int hidden, void* stream) {
  return walk_launch<float, TimeMajor>(xg, w_hh, b_hh, h0, ys, w_pad, lanes, n_steps, batch,
                                       hidden, 0, stream);
}

}  // extern "C"
