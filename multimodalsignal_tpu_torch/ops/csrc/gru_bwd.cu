// GRU backward (adjoint) recurrence for Hopper (sm_90a): one design, the
// adjoint walk, with a lane axis, a stream layout as a type, and a
// fixed-order reduction of its dW / db partials.
//
// Replaces three Pallas TPU kernels of multimodalsignal_tpu/ops/gru_pallas.py:
//   * _bwd_kernel    (called by _gru_backward)    -> C entry gru_bwd    (one lane)
//   * _fb_bwd_kernel (called by _gru_backward_fb) -> C entry gru_bwd_fb (F lanes)
//   * _bibwd_kernel  (called by _bigru_backward)  -> C entry gru_bibwd  (2 lanes,
//     the adjoint of gru_bifwd's fused BiGRU walk, float32 only; 2F lanes
//     for F folds under the fold axis)
//
// What it computes, per lane f (time-major, as the TPU kernels take it):
//   xg [F, T, B, 3H]  input gates of the forward (gate blocks r | z | n)
//   w  [F, 3H, H]     recurrent weights in torch layout; bh [F, 3H]
//   h0 [F, B, H]      initial state, float32
//   ys [F, T, B, H]   the forward's states; dy [F, T, B, H] their cotangent
// -> dxg [F, T, B, 3H] in xg's dtype; dw [F, 3H, H], db [F, 3H], dh0 [F, B, H]
//    all float32.
// gru_bibwd takes the streams xg, ys, dy and dxg as [T, L, B, .] (the lane
// inside time, as gru_bifwd writes them), walks with reverse=0 and is
// float32 throughout; its dw comes back in torch layout [L, 3H, H], the
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
// All three entries run the adjoint walk (gru_adj_* below): gru_bwd with
// one lane, gru_bwd_fb with F lanes of the LaneMajor layout, gru_bibwd with
// L lanes of the TimeMajor layout (2 a layer, 2F for F folds), where each odd
// lane is a backward direction, already flipped in time, so every lane walks
// with reverse=0 and h_prev at the first forward step is h0[lane].
//
// The adjoint walk. What bounds it
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
//     B=64, 64 blocks a lane while B * lanes <= 132; R <= 2 with W in
//     registers, 1 with W in shared memory). With H <= 64 each dot thread holds 4 units' slices of W's
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
// walk, 0.19 ms more for the two passes), against ~7.6 us for the first
// adjoint template it replaced, which kept h_prev's load, the hg product,
// three transcendentals and the dW^T accumulation on the chain with four
// barriers a step. A first version, one unit a thread (512 threads) with
// the factor loads and the dxg / dg stores in the gate lanes, ran about
// twice as long a step: its stores and its loads each held the barrier,
// whether the loads went through a register ring or cp.async, and one unit
// a thread made the dot read 48 KB of shared memory a step.
//
// The cluster walk: an H whose W^T does not fit one block (f32 above
// H = 130, bf16 above 179) is split over a thread block cluster of K CTAs
// (adj_cluster_size: the least K <= 8 whose per-CTA share fits), which own
// one (lane, batch row) together. CTA `rank` keeps the columns of W for its
// own ceil(H/K) units, as W^T rows [units][3H padded to 4], and moves only
// its units' factors and dht (its producer warp's copies shrink to that
// slice). Each step its pair lanes turn their units' dht into dg_lo and store
// those three values into the step's parity buffer of every CTA of the
// cluster through distributed shared memory (mapa / st.shared::cluster); one cluster
// barrier (barrier.cluster: the dot warps arrive with release, the producer
// warp arrives relaxed, so its copies in flight hold nothing, and every
// thread waits with acquire) takes the place of the dot warps' named
// barrier; then every CTA holds the step's whole dg_lo [3H] and computes
// its own units' slice of dh_prev = dg_lo @ W + dht z as above. The gate
// pre-pass and the weight-gradient pass run over all T at once and are
// unchanged: the pre-pass's shared memory ([H][97] + [H][32] floats) bounds
// bf16 at H = 450; the cluster walk bounds f32 at H = 376 (K = 8).
//
// The streamed walk: past those limits (adj_streamed) the walk is
// gru_adj_stream_kernel, a cluster of kMaxCluster CTAs per (lane, tile of R
// <= 4 rows) that exchanges dg_lo over distributed shared memory with one
// cluster barrier a step, as the cluster walk does, but keeps only as many
// of its units' W^T rows in shared memory as fit beside its dg buffers, its
// factor and dht chunks, its units' dh and its threads' copy rings
// (adj_stream_resident). The others are read every step from a padded W^T
// [H][3H padded to 4] that gru_adj_transpose_kernel writes into the
// workspace before the walk (12.6 MB at H = 1024 in f32, so after the first
// step the reads hit the H100's 50 MB L2), each dot thread copying its own
// 4-value chunks with cp.async into a ring of two slots in shared memory,
// one chunk ahead of its FMAs. Every byte streamed serves the tile's R rows
// (a (row, unit) pair a sub-lane). A CTA walks its units in passes of
// (dot threads) / kSmemSub units, with each pair's dh in shared memory, so
// H is bounded only by those buffers (adj_max_hidden in gru_cuda.py). Its
// gate pre-pass is gru_adj_gates_kernel with the K loop tiled (kTiled:
// kGateK units of W and h_prev at a time, static shared memory that does
// not grow with H, the same sums in the same order), and the
// weight-gradient pass and the reduction are the same kernels, whose tiles
// are static: at F = 15, T = 480, B = 64 the workspace is ~12 GB at
// H = 512 and ~36 GB at H = 1024 (adj_workspace_floats).

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

// ---------------------------------------------------------------------------
// The adjoint walk: gru_bwd, gru_bwd_fb, gru_bibwd (see the note at the top)
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
constexpr int kMaxCluster = 8;        // the portable thread block cluster size
// The most threads a CTA of the cluster walk takes (576 is the most any H
// asks for): its launch bound, below kMaxThreads, leaves ptxas registers.
constexpr int kClusterMaxThreads = 576;
constexpr int kNoCluster = -1;        // returned when no cluster of the size fits the card
// The streamed walk: the most dot threads of a CTA, the most rows of a tile
// (a (row, unit) pair a sub-lane), the slots of each dot thread's cp.async
// ring; and the K tile of the streamed walk's gate pre-pass.
constexpr int kStreamDotThreads = 512;
constexpr int kStreamMostRows = 4;
constexpr int kStreamStages = 2;
constexpr int kGateK = 64;
// Clusters of kMaxCluster CTAs of one CTA an SM that an H100 runs at once
// (cudaOccupancyMaxActiveClusters: 15, not 132 / 8).
constexpr int kStreamClusters = 15;

__host__ __device__ constexpr bool adj_in_registers(int hidden) {
  return hidden <= kRegMaxHidden;
}
// K = 3H of the dh product as the walk lays it out: padded to the register
// slices, or to 4.
__host__ __device__ constexpr int adj_kpad(int hidden, bool regs) {
  return regs ? kRegSub * kRegChunks * 4 : (3 * hidden + 3) / 4 * 4;
}
// Hidden units a CTA owns in a cluster of `cluster` CTAs (all H for one).
__host__ __device__ constexpr int adj_units(int hidden, int cluster) {
  return (hidden + cluster - 1) / cluster;
}
// The walk's dot threads (whole warps), then the producer warp.
__host__ __device__ constexpr int adj_dot_threads(int hidden, int cluster) {
  return ((adj_in_registers(hidden) ? (hidden + kRegUnits - 1) / kRegUnits * kRegSub
                                    : adj_units(hidden, cluster) * kSmemSub) +
          31) / 32 * 32;
}
__host__ __device__ constexpr int adj_threads(int hidden, int cluster) {
  return adj_dot_threads(hidden, cluster) + kProducer;
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
// Dynamic shared memory of one CTA of the walk: its W^T rows [units][kpad]
// in the stream dtype (shared-memory instantiations only, padded to 16
// bytes), then float32: the two parity buffers of the tile's whole dg_lo
// [2][rows][kpad], and for two chunks of steps its units' factors
// [2 chunk][rows][kWalkFactors][units] and dht [2 chunk][rows][units].
__host__ __device__ constexpr size_t adj_walk_shared_bytes(int hidden, size_t itemsize,
                                                           int rows, int cluster) {
  return (adj_in_registers(hidden)
              ? 0
              : align16(size_t(adj_units(hidden, cluster)) * adj_kpad(hidden, false) *
                        itemsize)) +
         (size_t(2) * rows * adj_kpad(hidden, adj_in_registers(hidden)) +
          size_t(2) * adj_chunk(adj_in_registers(hidden)) * rows * (kWalkFactors + 1) *
              adj_units(hidden, cluster)) *
             sizeof(float);
}
// CTAs per (lane, batch row) of the walk: 1 while W^T fits one block, else
// the least cluster whose per-CTA share and threads fit; 0 where not even
// kMaxCluster does.
int adj_cluster_size(int hidden, size_t itemsize) {
  if (adj_in_registers(hidden)) return 1;
  for (int k = 1; k <= kMaxCluster; ++k)
    if (adj_threads(hidden, k) <= (k == 1 ? kMaxThreads : kClusterMaxThreads) &&
        adj_walk_shared_bytes(hidden, itemsize, 1, k) <= kMaxShared)
      return k;
  return 0;
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
// The most any kernel of the one-block or cluster design takes of one
// block's or CTA's shared memory at this H's cluster size (kMaxCluster past
// the walk's limit).
size_t adj_cluster_shared_bytes(int hidden, size_t itemsize, int rows) {
  const int cluster = adj_cluster_size(hidden, itemsize);
  const size_t walk = adj_walk_shared_bytes(hidden, itemsize, rows, cluster ? cluster : kMaxCluster);
  return walk > adj_gates_shared_bytes(hidden) ? walk : adj_gates_shared_bytes(hidden);
}
// Whether this H runs the streamed walk: past the one-block and cluster
// design's limit (its walk's or its gate pre-pass's shared memory).
bool adj_streamed(int hidden, size_t itemsize) {
  return adj_cluster_size(hidden, itemsize) == 0 ||
         adj_cluster_shared_bytes(hidden, itemsize,
                                  adj_in_registers(hidden) ? kRegMostRows : 1) > kMaxShared;
}
// The streamed walk: kMaxCluster CTAs, ceil(H / kMaxCluster) units each.
__host__ __device__ constexpr int adj_stream_units(int hidden) {
  return adj_units(hidden, kMaxCluster);
}
__host__ __device__ constexpr int adj_stream_dot_threads(int hidden) {
  return (adj_stream_units(hidden) * kSmemSub + 31) / 32 * 32 < kStreamDotThreads
             ? (adj_stream_units(hidden) * kSmemSub + 31) / 32 * 32
             : kStreamDotThreads;
}
// Shared memory of a streamed CTA beside its resident W^T rows, float32:
// the two parity buffers of the tile's whole dg_lo [2][rows][kpad], for two
// chunks of steps its units' factors [2P][rows][5][units] and dht
// [2P][rows][units], its pairs' dh [rows][units], padded to 16 bytes; then
// every dot thread's ring of kStreamStages slots of 4 values in the stream
// dtype.
__host__ __device__ constexpr size_t adj_stream_fixed_bytes(int hidden, size_t itemsize,
                                                            int rows) {
  return align16((size_t(2) * rows * adj_kpad(hidden, false) +
                  (size_t(2) * kSmemChunk * (kWalkFactors + 1) + 1) * rows *
                      adj_stream_units(hidden)) *
                 sizeof(float)) +
         size_t(adj_stream_dot_threads(hidden)) * kStreamStages * 4 * itemsize;
}
// Units of a streamed CTA whose W^T rows [kpad] stay in shared memory; -1
// where not even the fixed part fits.
int adj_stream_resident(int hidden, size_t itemsize, int rows) {
  const size_t fixed = adj_stream_fixed_bytes(hidden, itemsize, rows);
  if (fixed > kMaxShared) return -1;
  const size_t unit = size_t(adj_kpad(hidden, false)) * itemsize;
  long long res = static_cast<long long>((kMaxShared - fixed) / unit);
  if (res > adj_stream_units(hidden)) res = adj_stream_units(hidden);
  while (res > 0 && align16(size_t(res) * unit) + fixed > kMaxShared) --res;
  return int(res);
}
size_t adj_stream_shared_bytes(int hidden, size_t itemsize, int rows) {
  const int res = adj_stream_resident(hidden, itemsize, rows);
  return (res > 0 ? align16(size_t(res) * adj_kpad(hidden, false) * itemsize) : 0) +
         adj_stream_fixed_bytes(hidden, itemsize, rows);
}
// The most rows a streamed tile takes at this H (a power of two up to
// kStreamMostRows whose fixed part fits; 1 where none does), and the row
// tile: the least power of two that brings ceil(B/R) * lanes clusters down
// to those the card runs at once (one wave), at most that.
int adj_stream_most_rows(int hidden, size_t itemsize) {
  for (int r = kStreamMostRows; r > 1; r /= 2)
    if (adj_stream_fixed_bytes(hidden, itemsize, r) <= kMaxShared) return r;
  return 1;
}
int adj_stream_row_tile(int batch, int lanes, int hidden, size_t itemsize) {
  const int most = adj_stream_most_rows(hidden, itemsize);
  const long long want =
      (static_cast<long long>(batch) * lanes + kStreamClusters - 1) / kStreamClusters;
  int rows = 1;
  while (rows < want && rows < most) rows *= 2;
  return rows;
}
// Shared memory of the streamed walk's gate pre-pass (static).
constexpr size_t kGateTiledBytes = size_t(kGateK) * (3 * kGateUnits + 1 + kGateRows) * sizeof(float);
// The most any kernel of the adjoint walk takes of one block's or CTA's
// shared memory for a walk tile of `rows`; the wrapper checks it.
size_t adj_shared_bytes(int hidden, size_t itemsize, int rows) {
  if (!adj_streamed(hidden, itemsize)) return adj_cluster_shared_bytes(hidden, itemsize, rows);
  const size_t walk = adj_stream_shared_bytes(hidden, itemsize, rows);
  return walk > kGateTiledBytes ? walk : kGateTiledBytes;
}
// Rows per block (or streamed tile) of the walk for this shape.
int adj_rows(int batch, int lanes, int hidden, size_t itemsize) {
  return adj_streamed(hidden, itemsize) ? adj_stream_row_tile(batch, lanes, hidden, itemsize)
                                        : adj_row_tile(batch, lanes, hidden);
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
// The f32 workspace each entry takes as dw_part: the factors [rows][6][H] and
// dht [rows][H] (rows = lanes * T * B, in the streams' order), then the dW
// partials [lanes][partials][3H][H]; for the streamed walk then, from a
// 16-byte boundary, W^T padded [lanes][H][kpad] in the stream dtype.
long long adj_wt_offset(int lanes, int n_steps, int batch, int hidden) {
  const long long rows = static_cast<long long>(lanes) * n_steps * batch;
  const long long base = rows * hidden * (kFactors + 1) +
      static_cast<long long>(lanes) * adj_partials(n_steps, batch) * 3 * hidden * hidden;
  return (base + 3) / 4 * 4;
}
long long adj_workspace_floats(int lanes, int n_steps, int batch, int hidden, size_t itemsize) {
  const long long rows = static_cast<long long>(lanes) * n_steps * batch;
  const long long base = rows * hidden * (kFactors + 1) +
      static_cast<long long>(lanes) * adj_partials(n_steps, batch) * 3 * hidden * hidden;
  if (!adj_streamed(hidden, itemsize)) return base;
  const long long wt = static_cast<long long>(lanes) * hidden * adj_kpad(hidden, false) *
                       static_cast<long long>(itemsize);
  return adj_wt_offset(lanes, n_steps, batch, hidden) + (wt + 15) / 16 * 4;
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

// gru_adj_gates_kernel for the streamed walk: the same tile of kGateRows
// rows x kGateUnits units and the same sums in the same order, with the K
// loop taken kGateK units at a time through static shared memory, so that
// its shared memory does not grow with H; h_prev of the block's own units
// (for cz) comes from device memory.
template <typename T, typename Layout>
__global__ void __launch_bounds__(kGateThreads)
    gru_adj_gates_tiled_kernel(const T* __restrict__ xg, const T* __restrict__ w_hh,
                               const T* __restrict__ b_hh, const float* __restrict__ h0,
                               const T* __restrict__ ys, const T* __restrict__ dy,
                               float* __restrict__ fac, int n_steps, int batch, int hidden,
                               int reverse) {
  constexpr int WS = 3 * kGateUnits + 1;
  __shared__ __align__(16) float ws[kGateK * WS];        // ws[kk][g*32 + jj] = W[g*H + j0 + jj][k0 + kk]
  __shared__ __align__(16) float hs[kGateK * kGateRows];  // h_prev of unit k0 + kk, row m0 + m
  const int H = hidden;
  const int G = 3 * hidden;
  const int lane = blockIdx.z;
  const int lanes = gridDim.z;
  const long long n_rows = static_cast<long long>(n_steps) * batch;
  const long long m0 = static_cast<long long>(blockIdx.x) * kGateRows;
  const int j0 = blockIdx.y * kGateUnits;
  const int tid = threadIdx.x;
  const T* w = w_hh + size_t(lane) * G * H;

  const int jj = tid % kGateUnits;
  const int rg = tid / kGateUnits;
  float acc[3][4];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0.0f;
  for (int k0 = 0; k0 < H; k0 += kGateK) {
    for (int e = tid; e < 3 * kGateUnits * kGateK; e += kGateThreads) {
      const int gj = e / kGateK;
      const int kk = e - gj * kGateK;
      const int g = gj / kGateUnits;
      const int j = j0 + gj - g * kGateUnits;
      ws[kk * WS + gj] =
          j < H && k0 + kk < H ? to_float(w[(size_t(g) * H + j) * H + k0 + kk]) : 0.0f;
    }
    for (int e = tid; e < kGateRows * kGateK; e += kGateThreads) {
      const int kk = e / kGateRows;
      const int m = e - kk * kGateRows;
      float v = 0.0f;
      if (m0 + m < n_rows && k0 + kk < H) {
        const int t = int((m0 + m) / batch);
        const int b = int(m0 + m - static_cast<long long>(t) * batch);
        v = adj_h_prev<T, Layout>(ys, h0, lane, t, b, k0 + kk, lanes, n_steps, batch, H,
                                  reverse);
      }
      hs[e] = v;
    }
    __syncthreads();
    const int kn = H - k0 < kGateK ? H - k0 : kGateK;
    for (int kk = 0; kk < kn; ++kk) {
      const float4 h4 = *reinterpret_cast<const float4*>(hs + kk * kGateRows + 4 * rg);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float wv = ws[kk * WS + g * kGateUnits + jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = fmaf(hv[i], wv, acc[g][i]);
      }
    }
    __syncthreads();
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
    const float hp = adj_h_prev<T, Layout>(ys, h0, lane, t, b, j, lanes, n_steps, batch, H,
                                           reverse);
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

// w [lanes][3H][H] -> w_t [lanes][H][kpad], w_t[k][c] = w[c][k], zeros past
// 3H: the W^T rows the streamed walk reads.
template <typename T>
__global__ void gru_adj_transpose_kernel(const T* __restrict__ w, T* __restrict__ w_t,
                                         int lanes, int hidden, int kpad) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long per_lane = static_cast<long long>(hidden) * kpad;
  if (i >= lanes * per_lane) return;
  const long long lane = i / per_lane;
  const long long rest = i - lane * per_lane;
  const int k = int(rest / kpad);
  const int c = int(rest - static_cast<long long>(k) * kpad);
  w_t[i] = c < 3 * hidden ? w[(lane * 3 * hidden + c) * hidden + k] : from_float<T>(0.0f);
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
// cp.async of 4 values of the stream dtype (16 bytes f32, 8 bytes bf16).
__device__ __forceinline__ void cp_async_4(float* dst, const float* src) { cp_async16(dst, src); }
__device__ __forceinline__ void cp_async_4(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
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

// The cluster barrier in two halves. Every thread of every CTA of the
// cluster arrives, with release (its shared and distributed shared memory
// stores are seen) or relaxed (no ordering: its memory accesses in flight
// do not hold the arrival), then waits with acquire.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_all() {
  cluster_arrive();
  cluster_wait();
}

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
// The cluster instantiation (kCluster, W in shared memory, one row): CTA
// `rank` of the `csize` sharing a (lane, row) owns units unit0 .. unit0 +
// units - 1; its pair lanes store dg_lo into every CTA's buffer, and the
// cluster barrier replaces the dot warps' named barrier (see the note at
// the top).
template <typename T, typename Layout, int R, bool kRegs, bool kCluster>
__global__ void __launch_bounds__(kRegs ? kRegSub * kRegMaxHidden / kRegUnits + kProducer
                                  : kCluster ? kClusterMaxThreads : kMaxThreads, 1)
    gru_adj_walk_kernel(const float* __restrict__ fac, const T* __restrict__ w_hh,
                        float* __restrict__ dht_out, float* __restrict__ dh0, int n_steps,
                        int batch, int hidden, int reverse) {
  constexpr int U = kRegs ? kRegUnits : 1;
  constexpr int S = kRegs ? kRegSub : kSmemSub;
  constexpr int P = adj_chunk(kRegs);
  constexpr int kAcc = kRegs ? 1 : 4;  // partial sums per (row, unit)
  static_assert(R * U <= S, "one (row, unit) pair a sub-lane");
  static_assert(!(kCluster && (kRegs || R != 1)), "the cluster walk: W in shared memory, one row");
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = hidden;
  const int G = 3 * hidden;
  const int kpad = adj_kpad(H, kRegs);
  const int csize = kCluster ? cluster_ctas() : 1;
  const int rank = kCluster ? cluster_rank() : 0;
  const int units = kCluster ? adj_units(H, csize) : H;
  const int unit0 = rank * units;
  const int lane = blockIdx.y;
  const int lanes = gridDim.y;
  const int row0 = (kCluster ? blockIdx.x / csize : blockIdx.x) * R;
  const int tid = threadIdx.x;
  const int dot_threads = adj_dot_threads(H, csize);
  const bool producer = tid >= dot_threads;
  const int pl = tid - dot_threads;  // producer lane
  const int groups = (units + U - 1) / U;
  const int g = tid / S;  // group of units g U .. g U + U - 1 (of this CTA's)
  const int s = tid % S;  // sub-lane: chunks s, s + S, ...; pair s
  const int gu = g < groups ? g : 0;  // padding threads read group 0 and write nothing
  const int mine = H - unit0 < units ? H - unit0 : units;  // this CTA's units inside H

  T* w_s = reinterpret_cast<T*>(smem);  // [units][kpad]: w_s[k][c] = W[c][unit0 + k]
  float* dgbuf = reinterpret_cast<float*>(
      smem + (kRegs ? 0 : align16(size_t(units) * kpad * sizeof(T))));  // [2][R][kpad]
  float* fbuf = dgbuf + 2 * R * kpad;                      // [2P][R][kWalkFactors][units]
  float* dhtbuf = fbuf + 2 * P * R * kWalkFactors * units; // [2P][R][units]

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
  } else if constexpr (kCluster) {
    for (int e = tid; e < units * kpad; e += blockDim.x) {
      const int c = e / units;  // read W's columns of this CTA's units row by row
      const int kk = e - c * units;
      w_s[size_t(kk) * kpad + c] =
          c < G && kk < mine ? w[size_t(c) * H + unit0 + kk] : from_float<T>(0.0f);
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
    return fbuf + ((step % (2 * P)) * R + r) * kWalkFactors * units;
  };
  auto dht_at = [&](int step, int r) { return dhtbuf + ((step % (2 * P)) * R + r) * units; };
  // 16-byte moves: every row of the factors and of dht, and in a cluster
  // every CTA's slice of one, is aligned.
  const bool vec = H % 4 == 0 && units % 4 == 0;
  auto load_chunk = [&](int c) {  // producer: cp.async of chunk c's factors
    const int last = min((c + 1) * P, n_steps);
    for (int i = c * P; i < last; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (row0 + r >= batch) break;
        const float* src = fac + at_step(i, row0 + r) * kFactors * H;
        float* dst = fac_at(i, r);
        if constexpr (kCluster) {  // this CTA's units of each factor
          for (int f = 0; f < kWalkFactors; ++f) {
            if (vec) {
              for (int u = 4 * pl; u < mine; u += 4 * kProducer)
                cp_async16(dst + f * units + u, src + f * H + unit0 + u);
            } else {
              for (int u = pl; u < mine; u += kProducer)
                cp_async4(dst + f * units + u, src + f * H + unit0 + u);
            }
          }
        } else if (vec) {
          for (int u = 4 * pl; u < kWalkFactors * H; u += 4 * kProducer)
            cp_async16(dst + u, src + u);
        } else {
          for (int u = pl; u < kWalkFactors * H; u += kProducer) cp_async4(dst + u, src + u);
        }
      }
    cp_async_commit();
  };
  auto store_chunk = [&](int c) {  // producer: chunk c's dht (of this CTA's units) to device memory
    const int last = min((c + 1) * P, n_steps);
    for (int i = c * P; i < last; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (row0 + r >= batch) break;
        float* out = dht_out + at_step(i, row0 + r) * H + unit0;
        const float* in = dht_at(i, r);
        if (vec) {
          for (int u = 4 * pl; u < mine; u += 4 * kProducer)
            *reinterpret_cast<float4*>(out + u) = *reinterpret_cast<const float4*>(in + u);
        } else {
          for (int u = pl; u < mine; u += kProducer) out[u] = in[u];
        }
      }
  };

  const int n_chunks = (n_steps + P - 1) / P;
  if (producer) {
    load_chunk(0);
    cp_async_wait_all();
  }
  if constexpr (kCluster)
    cluster_sync_all();  // every CTA of the cluster has started and zeroed its dg_lo buffers
  else
    __syncthreads();
  if (producer) {
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) load_chunk(c + 1);
      if (c > 0) store_chunk(c - 1);
      if constexpr (kCluster) {  // the chunk's steps' cluster barriers, arriving relaxed
        const int last = min((c + 1) * P, n_steps);
        for (int i = c * P; i < last; ++i) {
          cluster_arrive_relaxed();
          cluster_wait();
        }
      }
      cp_async_wait_all();
      if (c + 1 < n_chunks) named_barrier(kChunkBarrier, blockDim.x);
    }
    if constexpr (kCluster)
      cluster_sync_all();  // the last chunk's dht is written; no peer writes into this CTA after
    else
      __syncthreads();  // the last chunk's dht is written
    store_chunk(n_chunks - 1);
    return;
  }

  // The (row, unit) pair of this sub-lane: pk a unit of the layer, pkl of this CTA.
  const int pr = s / U;
  const int pkl = g * U + s % U;
  const int pk = unit0 + pkl;
  const bool pair = g < groups && s < R * U && pkl < units && pk < H && row0 + pr < batch;
  float dh = 0.0f;
  const int nchunks = kpad / 4;
  for (int step = 0; step < n_steps; ++step) {
    if (step > 0 && step % P == 0) named_barrier(kChunkBarrier, blockDim.x);
    float* buf = dgbuf + (step & 1) * R * kpad;
    float dhz = 0.0f;
    if (pair) {
      const float* f = fac_at(step, pr) + pkl;
      const float dht = dh + f[4 * units];
      const float dr_pre = dht * f[0];
      const float dz_pre = dht * f[units];
      const float dg_n = dht * f[2 * units];
      dhz = dht * f[3 * units];
      const float lo[3] = {round_to<T>(dr_pre), round_to<T>(dz_pre), round_to<T>(dg_n)};
      if constexpr (kCluster) {  // into every CTA's buffer (its own too)
        float* out = buf + pr * kpad;
        for (int p = 0; p < csize; ++p) {
          store_cluster(out + pk, p, lo[0]);
          store_cluster(out + H + pk, p, lo[1]);
          store_cluster(out + 2 * H + pk, p, lo[2]);
        }
      } else {
        float* out = buf + pr * kpad;
        out[pk] = lo[0];
        out[H + pk] = lo[1];
        out[2 * H + pk] = lo[2];
      }
      dht_at(step, pr)[pkl] = dht;
    }
    if constexpr (kCluster) {
      cluster_arrive();
      cluster_wait();
    } else {
      named_barrier(kDotBarrier, dot_threads);
    }
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
      float own = sum[0][0];
#pragma unroll
      for (int q = 1; q < R * U; ++q)
        if (s == q) own = sum[q / U][q % U];
      dh = dhz + own;
    }
  }
  if constexpr (kCluster)
    cluster_sync_all();
  else
    __syncthreads();
  if (pair) dh0[(size_t(lane) * batch + row0 + pr) * H + pk] = dh;
}

// The streamed walk (see the note at the top): a cluster of kMaxCluster
// CTAs per (lane, tile of R rows), the dot threads and a producer warp as
// in the cluster walk. CTA `rank` owns units unit0 .. unit0 + units - 1 and
// walks them in passes of (dot threads) / S units, S = kSmemSub: first every
// pass's pairs (sub-lane s < R: row s of the pass's unit) turn dht into
// dg_lo, stored into every CTA's buffer, and keep dht z as the pair's dh in
// shared memory; one cluster barrier; then every pass's dot, W^T of units
// below `resident` from shared memory, of the others from w_t in device
// memory through the thread's cp.async ring, and the pair adds its sum to
// its dh.
template <typename T, typename Layout, int R>
__global__ void __launch_bounds__(kStreamDotThreads + kProducer, 1)
    gru_adj_stream_kernel(const float* __restrict__ fac, const T* __restrict__ w_t,
                          float* __restrict__ dht_out, float* __restrict__ dh0, int n_steps,
                          int batch, int hidden, int reverse, int resident) {
  constexpr int S = kSmemSub;
  constexpr int P = kSmemChunk;
  static_assert(R <= S, "one (row, unit) pair a sub-lane");
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = hidden;
  const int kpad = adj_kpad(H, false);
  const int nchunks = kpad / 4;
  const int csize = cluster_ctas();
  const int rank = cluster_rank();
  const int units = adj_units(H, csize);
  const int unit0 = rank * units;
  const int mine = H - unit0 < units ? (H > unit0 ? H - unit0 : 0) : units;  // inside H
  const int lane = blockIdx.y;
  const int lanes = gridDim.y;
  const int row0 = blockIdx.x / csize * R;
  const int tid = threadIdx.x;
  const int dot_threads = blockDim.x - kProducer;
  const bool producer = tid >= dot_threads;
  const int pl = tid - dot_threads;  // producer lane
  const int per_pass = dot_threads / S;
  const int s = tid % S;

  const size_t w_bytes = resident > 0 ? align16(size_t(resident) * kpad * sizeof(T)) : 0;
  T* w_s = reinterpret_cast<T*>(smem);  // [resident][kpad]: w_s[kk][c] = W[c][unit0 + kk]
  float* dgbuf = reinterpret_cast<float*>(smem + w_bytes);   // [2][R][kpad]
  float* fbuf = dgbuf + 2 * R * kpad;                         // [2P][R][kWalkFactors][units]
  float* dhtbuf = fbuf + 2 * P * R * kWalkFactors * units;    // [2P][R][units]
  float* dhc = dhtbuf + 2 * P * R * units;                    // [R][units]: the pairs' dh
  T* ring = reinterpret_cast<T*>(
                smem + w_bytes +
                align16((size_t(2) * R * kpad + (size_t(2) * P * (kWalkFactors + 1) + 1) * R *
                                                     units) * sizeof(float))) +
            size_t(tid) * kStreamStages * 4;                  // [kStreamStages][4]
  const T* wt = w_t + size_t(lane) * H * kpad;                // [H][kpad]

  for (int e = tid; e < 2 * R * kpad; e += blockDim.x) dgbuf[e] = 0.0f;
  for (int e = tid; e < R * units; e += blockDim.x) dhc[e] = 0.0f;
  for (int e = tid; e < resident * kpad; e += blockDim.x) {
    const int kk = e / kpad;
    w_s[e] = kk < mine ? wt[size_t(unit0) * kpad + e] : from_float<T>(0.0f);
  }

  auto at_step = [&](int step, int row) {
    const int t = reverse ? step : n_steps - 1 - step;
    return Layout::row(lane, t, row, lanes, n_steps, batch);
  };
  auto fac_at = [&](int step, int r) {
    return fbuf + ((step % (2 * P)) * R + r) * kWalkFactors * units;
  };
  auto dht_at = [&](int step, int r) { return dhtbuf + ((step % (2 * P)) * R + r) * units; };
  const bool vec = H % 4 == 0 && units % 4 == 0;
  auto load_chunk = [&](int c) {  // producer: cp.async of chunk c's factors (this CTA's units)
    const int last = min((c + 1) * P, n_steps);
    for (int i = c * P; i < last; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (row0 + r >= batch) break;
        const float* src = fac + at_step(i, row0 + r) * kFactors * H;
        float* dst = fac_at(i, r);
        for (int f = 0; f < kWalkFactors; ++f) {
          if (vec) {
            for (int u = 4 * pl; u < mine; u += 4 * kProducer)
              cp_async16(dst + f * units + u, src + f * H + unit0 + u);
          } else {
            for (int u = pl; u < mine; u += kProducer)
              cp_async4(dst + f * units + u, src + f * H + unit0 + u);
          }
        }
      }
    cp_async_commit();
  };
  auto store_chunk = [&](int c) {  // producer: chunk c's dht (this CTA's units) to device memory
    const int last = min((c + 1) * P, n_steps);
    for (int i = c * P; i < last; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (row0 + r >= batch) break;
        float* out = dht_out + at_step(i, row0 + r) * H + unit0;
        const float* in = dht_at(i, r);
        if (vec) {
          for (int u = 4 * pl; u < mine; u += 4 * kProducer)
            *reinterpret_cast<float4*>(out + u) = *reinterpret_cast<const float4*>(in + u);
        } else {
          for (int u = pl; u < mine; u += kProducer) out[u] = in[u];
        }
      }
  };

  const int n_chunks = (n_steps + P - 1) / P;
  if (producer) {
    load_chunk(0);
    cp_async_wait_all();
  }
  cluster_sync_all();  // every CTA of the cluster has started and zeroed its dg_lo buffers
  if (producer) {
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) load_chunk(c + 1);
      if (c > 0) store_chunk(c - 1);
      const int last = min((c + 1) * P, n_steps);
      for (int i = c * P; i < last; ++i) {  // the chunk's steps' cluster barriers, relaxed
        cluster_arrive_relaxed();
        cluster_wait();
      }
      cp_async_wait_all();
      if (c + 1 < n_chunks) named_barrier(kChunkBarrier, blockDim.x);
    }
    cluster_sync_all();  // the last chunk's dht is written; no peer writes into this CTA after
    store_chunk(n_chunks - 1);
    return;
  }

  for (int step = 0; step < n_steps; ++step) {
    if (step > 0 && step % P == 0) named_barrier(kChunkBarrier, blockDim.x);
    float* buf = dgbuf + (step & 1) * R * kpad;
    for (int p0 = 0; p0 < units; p0 += per_pass) {
      const int jl = p0 + tid / S;
      if (jl < mine && s < R && row0 + s < batch) {
        const float* f = fac_at(step, s) + jl;
        const float dht = dhc[s * units + jl] + f[4 * units];
        const float lo[3] = {round_to<T>(dht * f[0]), round_to<T>(dht * f[units]),
                             round_to<T>(dht * f[2 * units])};
        dhc[s * units + jl] = dht * f[3 * units];
        float* out = buf + s * kpad + unit0 + jl;
        for (int p = 0; p < csize; ++p) {  // into every CTA's buffer (its own too)
          store_cluster(out, p, lo[0]);
          store_cluster(out + H, p, lo[1]);
          store_cluster(out + 2 * H, p, lo[2]);
        }
        dht_at(step, s)[jl] = dht;
      }
    }
    cluster_arrive();
    cluster_wait();
    for (int p0 = 0; p0 < units; p0 += per_pass) {  // the same bounds for every dot thread
      const int jl = p0 + tid / S;
      const bool unit = jl < mine;
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
      auto chunk = [&](int c, const float (&wv)[4]) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float dv[4];
          load4(buf + r * kpad + 4 * c, dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(dv[e], wv[e], acc[r][e]);
        }
      };
      if (unit && jl < resident) {
#pragma unroll 2
        for (int c = s; c < nchunks; c += S) {
          float wv[4];
          load4(w_s + size_t(jl) * kpad + 4 * c, wv);
          chunk(c, wv);
        }
      } else if (unit) {
        // Chunks s, s + S, ... of the unit's W^T row, each copied into the
        // ring one chunk ahead of its FMAs; a slot is refilled one iteration
        // after it was read.
        const T* wu = wt + size_t(unit0 + jl) * kpad;
        const int n = (nchunks - s + S - 1) / S;
        auto issue = [&](int i) {  // one commit group a chunk, which wait_group 0 waits for
          cp_async_4(ring + (i % kStreamStages) * 4, wu + 4 * (s + S * i));
          cp_async_commit();
        };
        if (n > 0) issue(0);
        for (int i = 0; i < n; ++i) {
          cp_async_wait_all();  // chunk i has landed
          float wv[4];
          load4(ring + (i % kStreamStages) * 4, wv);
          if (i + 1 < n) issue(i + 1);
          chunk(s + S * i, wv);
        }
      }
      float sum[R];
#pragma unroll
      for (int r = 0; r < R; ++r) sum[r] = ((acc[r][0] + acc[r][1]) + acc[r][2]) + acc[r][3];
#pragma unroll
      for (int off = S / 2; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
      if (unit && s < R && row0 + s < batch) {
        float own = sum[0];
#pragma unroll
        for (int q = 1; q < R; ++q)
          if (s == q) own = sum[q];
        dhc[s * units + jl] += own;
      }
    }
  }
  cluster_sync_all();
  for (int p0 = 0; p0 < units; p0 += per_pass) {
    const int jl = p0 + tid / S;
    if (jl < mine && s < R && row0 + s < batch)
      dh0[(size_t(lane) * batch + row0 + s) * H + unit0 + jl] = dhc[s * units + jl];
  }
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

// The walk's instantiation for a shape: split over a cluster where W^T
// does not fit one block, W in shared memory above H = 64 (one row a
// block), else W in registers with `rows` (adj_row_tile) rows.
template <typename T>
using AdjWalkKernel = void (*)(const float*, const T*, float*, float*, int, int, int, int);
template <typename T, typename Layout>
AdjWalkKernel<T> adj_walk_kernel(int rows, int hidden, int cluster) {
  if (cluster > 1) return gru_adj_walk_kernel<T, Layout, 1, false, true>;
  if (!adj_in_registers(hidden)) return gru_adj_walk_kernel<T, Layout, 1, false, false>;
  return rows == 1 ? gru_adj_walk_kernel<T, Layout, 1, true, false>
                   : gru_adj_walk_kernel<T, Layout, 2, true, false>;
}

// The cluster walk's launch: `cluster` CTAs per (lane, row) along the
// grid's x, one cluster apiece.
struct AdjWalkLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  AdjWalkLaunch(int lanes, int batch, int hidden, int rows, int cluster, size_t smem,
                cudaStream_t stream) {
    cfg.gridDim = dim3((batch + rows - 1) / rows * cluster, lanes);
    cfg.blockDim = dim3(adj_threads(hidden, cluster));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The streamed walk's launch: kMaxCluster CTAs per (lane, row tile) along
// the grid's x, one cluster apiece.
struct AdjStreamLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  AdjStreamLaunch(int lanes, int batch, int hidden, int rows, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3((batch + rows - 1) / rows * kMaxCluster, lanes);
    cfg.blockDim = dim3(adj_stream_dot_threads(hidden) + kProducer);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kMaxCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T>
using AdjStreamKernel = void (*)(const float*, const T*, float*, float*, int, int, int, int, int);
template <typename T, typename Layout>
AdjStreamKernel<T> adj_stream_kernel(int rows) {
  return rows == 1 ? gru_adj_stream_kernel<T, Layout, 1>
                   : rows == 2 ? gru_adj_stream_kernel<T, Layout, 2>
                               : gru_adj_stream_kernel<T, Layout, 4>;
}

// Clusters of the streamed walk the card holds at once for this shape, or a
// negative CUDA error.
template <typename T, typename Layout>
int adj_stream_active_clusters(int batch, int lanes, int hidden) {
  const int rows = adj_stream_row_tile(batch, lanes, hidden, sizeof(T));
  const AdjStreamKernel<T> kernel = adj_stream_kernel<T, Layout>(rows);
  const size_t smem = adj_stream_shared_bytes(hidden, sizeof(T), rows);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int count = 0;
  if (err == cudaSuccess) {
    const AdjStreamLaunch launch(lanes, batch, hidden, rows, smem, nullptr);
    err = cudaOccupancyMaxActiveClusters(&count, kernel, &launch.cfg);
  }
  return err == cudaSuccess ? count : -int(err);
}

// The streamed walk, after its W^T is written into the workspace (w_t);
// refused (kNoCluster) before the launch when no cluster fits the card.
template <typename T, typename Layout>
int adj_stream_walk(const float* fac, const void* w_hh, void* w_t, float* dht, void* dh0,
                    int lanes, int n_steps, int batch, int hidden, int reverse,
                    cudaStream_t stream) {
  const int rows = adj_stream_row_tile(batch, lanes, hidden, sizeof(T));
  const int resident = adj_stream_resident(hidden, sizeof(T), rows);
  if (resident < 0) return int(cudaErrorInvalidValue);
  const int clusters = adj_stream_active_clusters<T, Layout>(batch, lanes, hidden);
  if (clusters < 0) return -clusters;
  if (clusters == 0) return kNoCluster;
  const int kpad = adj_kpad(hidden, false);
  const long long n = static_cast<long long>(lanes) * hidden * kpad;
  gru_adj_transpose_kernel<T><<<unsigned((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(w_hh), static_cast<T*>(w_t), lanes, hidden, kpad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const AdjStreamLaunch launch(lanes, batch, hidden, rows,
                               adj_stream_shared_bytes(hidden, sizeof(T), rows), stream);
  err = cudaLaunchKernelEx(&launch.cfg, adj_stream_kernel<T, Layout>(rows), fac,
                           static_cast<const T*>(w_t), dht, static_cast<float*>(dh0), n_steps,
                           batch, hidden, reverse, resident);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// Clusters of the walk (of one CTA without a cluster: blocks) the card
// holds at once for this shape, from CUDA's occupancy calculator; a
// negative CUDA error if it fails.
template <typename T, typename Layout>
int adj_walk_active_clusters(int batch, int lanes, int hidden) {
  if (adj_streamed(hidden, sizeof(T)))
    return adj_stream_active_clusters<T, Layout>(batch, lanes, hidden);
  const int cluster = adj_cluster_size(hidden, sizeof(T));
  if (cluster == 0) return -int(cudaErrorInvalidValue);
  const int rows = adj_row_tile(batch, lanes, hidden);
  const AdjWalkKernel<T> kernel = adj_walk_kernel<T, Layout>(rows, hidden, cluster);
  const size_t smem = adj_walk_shared_bytes(hidden, sizeof(T), rows, cluster);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int count = 0;
  if (err == cudaSuccess) {
    if (cluster > 1) {
      const AdjWalkLaunch launch(lanes, batch, hidden, rows, cluster, smem, nullptr);
      err = cudaOccupancyMaxActiveClusters(&count, kernel, &launch.cfg);
    } else {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, kernel,
                                                          adj_threads(hidden, 1), smem);
      count *= kNumSMs;
    }
  }
  return err == cudaSuccess ? count : -int(err);
}

// The walk; a cluster launch is refused (kNoCluster) before it is made when
// no cluster of its size fits the card, and cudaLaunchKernelEx's result is
// returned.
template <typename T, typename Layout>
int adj_walk(const float* fac, const void* w_hh, float* dht, void* dh0, int lanes, int n_steps,
             int batch, int hidden, int reverse, cudaStream_t stream) {
  const int cluster = adj_cluster_size(hidden, sizeof(T));
  const int rows = adj_row_tile(batch, lanes, hidden);
  const AdjWalkKernel<T> kernel = adj_walk_kernel<T, Layout>(rows, hidden, cluster);
  const size_t smem = adj_walk_shared_bytes(hidden, sizeof(T), rows, cluster);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (cluster == 1) {
    kernel<<<dim3((batch + rows - 1) / rows, lanes), adj_threads(hidden, 1), smem, stream>>>(
        fac, static_cast<const T*>(w_hh), dht, static_cast<float*>(dh0), n_steps, batch,
        hidden, reverse);
    return int(cudaGetLastError());
  }
  const int clusters = adj_walk_active_clusters<T, Layout>(batch, lanes, hidden);
  if (clusters < 0) return -clusters;
  if (clusters == 0) return kNoCluster;
  const AdjWalkLaunch launch(lanes, batch, hidden, rows, cluster, smem, stream);
  err = cudaLaunchKernelEx(&launch.cfg, kernel, fac, static_cast<const T*>(w_hh), dht,
                           static_cast<float*>(dh0), n_steps, batch, hidden, reverse);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// Blocks of the walk (LaneMajor) one SM holds at once for this shape, from
// CUDA's occupancy calculator; a negative CUDA error if it fails.
template <typename T>
int adj_walk_blocks_per_sm(int batch, int lanes, int hidden) {
  if (adj_streamed(hidden, sizeof(T))) {
    const int rows = adj_stream_row_tile(batch, lanes, hidden, sizeof(T));
    const AdjStreamKernel<T> kernel = adj_stream_kernel<T, LaneMajor>(rows);
    const size_t smem = adj_stream_shared_bytes(hidden, sizeof(T), rows);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, adj_stream_dot_threads(hidden) + kProducer, smem);
    return err == cudaSuccess ? blocks : -int(err);
  }
  const int cluster = adj_cluster_size(hidden, sizeof(T));
  if (cluster == 0) return -int(cudaErrorInvalidValue);
  const int rows = adj_row_tile(batch, lanes, hidden);
  const AdjWalkKernel<T> kernel = adj_walk_kernel<T, LaneMajor>(rows, hidden, cluster);
  const size_t smem = adj_walk_shared_bytes(hidden, sizeof(T), rows, cluster);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        adj_threads(hidden, cluster), smem);
  return err == cudaSuccess ? blocks : -int(err);
}

// The adjoint walk's four kernels on one stream: the gate pre-pass, the
// walk, the weight-gradient pass and the reduction. The instantiation is chosen from
// H before any launch; a shape the wrapper would have refused is refused
// here too, not launched.
template <typename T, typename Layout>
int adj_launch(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
               const void* ys, const void* dy, void* dxg, void* dw, void* db, void* dh0,
               void* workspace, void* db_part, int lanes, int n_steps, int batch, int hidden,
               int reverse, void* stream) {
  const bool streamed = adj_streamed(hidden, sizeof(T));
  const int rows = adj_rows(batch, lanes, hidden, sizeof(T));
  if ((!streamed && adj_cluster_size(hidden, sizeof(T)) == 0) ||
      adj_shared_bytes(hidden, sizeof(T), rows) > kMaxShared)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n_rows = size_t(lanes) * n_steps * batch;
  float* fac = static_cast<float*>(workspace);
  float* dht = fac + n_rows * kFactors * hidden;
  float* dw_part = dht + n_rows * hidden;

  const long long lane_rows = static_cast<long long>(n_steps) * batch;
  const dim3 gates_grid(unsigned((lane_rows + kGateRows - 1) / kGateRows),
                        (hidden + kGateUnits - 1) / kGateUnits, lanes);
  cudaError_t err = cudaSuccess;
  if (streamed) {
    gru_adj_gates_tiled_kernel<T, Layout><<<gates_grid, kGateThreads, 0, s>>>(
        static_cast<const T*>(xg), static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
        static_cast<const float*>(h0), static_cast<const T*>(ys), static_cast<const T*>(dy),
        fac, n_steps, batch, hidden, reverse);
  } else {
    const size_t gates_smem = adj_gates_shared_bytes(hidden);
    err = cudaFuncSetAttribute(gru_adj_gates_kernel<T, Layout>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(gates_smem));
    if (err != cudaSuccess) return int(err);
    gru_adj_gates_kernel<T, Layout><<<gates_grid, kGateThreads, gates_smem, s>>>(
        static_cast<const T*>(xg), static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
        static_cast<const float*>(h0), static_cast<const T*>(ys), static_cast<const T*>(dy),
        fac, n_steps, batch, hidden, reverse);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const int e =
      streamed
          ? adj_stream_walk<T, Layout>(
                fac, w_hh,
                static_cast<float*>(workspace) + adj_wt_offset(lanes, n_steps, batch, hidden),
                dht, dh0, lanes, n_steps, batch, hidden, reverse, s)
          : adj_walk<T, Layout>(fac, w_hh, dht, dh0, lanes, n_steps, batch, hidden, reverse, s);
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

// Shared memory the most demanding kernel of the adjoint walk needs of
// one block or CTA for a walk tile of `rows`; the wrapper checks it against
// the card's limit.
long long gru_adj_shared_bytes(int hidden, int bf16, int rows) {
  return (long long)adj_shared_bytes(hidden, bf16 ? sizeof(__nv_bfloat16) : sizeof(float),
                                     rows);
}

// CTAs of the adjoint walk per (lane, batch row) at this H: 1 while W^T
// fits one block, up to 8 for the cluster walk, 0 past the cluster walk's
// limit.
int gru_adj_cluster_size(int hidden, int bf16) {
  return adj_cluster_size(hidden, bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
}

// The adjoint walk's plan for this shape, as seven numbers: the
// instantiation (0 W in registers, 1 one block, 2 the cluster walk, 3 the
// streamed walk), the CTAs per (lane, row tile), the row tile, a CTA's units
// whose W^T rows are resident in shared memory and those streamed from
// device memory, the most shared bytes a block or CTA of its kernels takes,
// and the floats of its workspace at T = n_steps.
void gru_adj_plan(int batch, int lanes, int n_steps, int hidden, int bf16, long long* out) {
  const size_t item = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const int rows = adj_rows(batch, lanes, hidden, item);
  if (adj_streamed(hidden, item)) {
    const int res = adj_stream_resident(hidden, item, rows);
    out[0] = 3;
    out[1] = kMaxCluster;
    out[3] = res;
    out[4] = adj_stream_units(hidden) - (res > 0 ? res : 0);
  } else {
    const int cluster = adj_cluster_size(hidden, item);
    out[0] = adj_in_registers(hidden) ? 0 : cluster == 1 ? 1 : 2;
    out[1] = cluster;
    out[3] = adj_units(hidden, cluster);
    out[4] = 0;
  }
  out[2] = rows;
  out[5] = (long long)adj_shared_bytes(hidden, item, rows);
  out[6] = adj_workspace_floats(lanes, n_steps, batch, hidden, item);
}

// Clusters (blocks, without a cluster) of the adjoint walk the card holds at
// once for this shape.
int gru_adj_walk_active_clusters(int batch, int lanes, int hidden, int bf16) {
  return bf16 ? adj_walk_active_clusters<__nv_bfloat16, LaneMajor>(batch, lanes, hidden)
              : adj_walk_active_clusters<float, LaneMajor>(batch, lanes, hidden);
}

// Rows per block (or streamed tile) of the adjoint walk for this shape.
int gru_adj_row_tile(int batch, int lanes, int hidden, int bf16) {
  return adj_rows(batch, lanes, hidden, bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
}

// Walk blocks one SM holds at once for this shape (the wave count of
// ceil(B / R) * lanes blocks follows).
int gru_adj_walk_blocks_per_sm(int batch, int lanes, int hidden, int bf16) {
  return bf16 ? adj_walk_blocks_per_sm<__nv_bfloat16>(batch, lanes, hidden)
              : adj_walk_blocks_per_sm<float>(batch, lanes, hidden);
}

// Rows (t, b) per chunk of the weight-gradient pass, and the chunk
// count: the dW / db partials per lane.
long long gru_adj_chunk_rows(int n_steps, int batch) { return adj_chunk_rows(n_steps, batch); }
int gru_adj_partials(int n_steps, int batch) { return adj_partials(n_steps, batch); }

// Floats of the workspace an entry with `lanes` lanes takes as dw_part.
long long gru_adj_workspace_floats(int lanes, int n_steps, int batch, int hidden, int bf16) {
  return adj_workspace_floats(lanes, n_steps, batch, hidden,
                              bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
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

// Counterpart of _gru_backward_fb: F lanes of the [F, T, B, .] streams, each
// with its own dw/db/dh0, on the adjoint walk. dw_part is the workspace of
// gru_adj_workspace_floats(F, T, B, H) floats, db_part holds
// F * gru_adj_partials(T, B) partials of [3H] floats.
int gru_bwd_fb(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
               const void* ys, const void* dy, void* dxg, void* dw, void* db, void* dh0,
               void* dw_part, void* db_part, int lanes, int n_steps, int batch, int hidden,
               int reverse, int bf16, void* stream) {
  if (bf16) {
    return adj_launch<__nv_bfloat16, LaneMajor>(xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0,
                                                dw_part, db_part, lanes, n_steps, batch,
                                                hidden, reverse, stream);
  }
  return adj_launch<float, LaneMajor>(xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0, dw_part,
                                      db_part, lanes, n_steps, batch, hidden, reverse, stream);
}

// Counterpart of _bigru_backward: the adjoint of gru_bifwd, float32, walking
// time backward. xg, ys, dy, dxg [T, L, B, .]; w [L, 3H, H], bh [L, 3H],
// h0 [L, B, H] -> dw [L, 3H, H], db [L, 3H], dh0 [L, B, H] per lane (L = 2
// for one layer's two directions, 2F for F folds of it, as gru_bifwd lays
// them out), on the adjoint walk with L lanes of the TimeMajor layout and
// reverse=0. dw_part is the workspace of gru_adj_workspace_floats(L, T, B, H)
// floats, db_part holds L * gru_adj_partials(T, B) partials of [3H] floats.
int gru_bibwd(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
              const void* ys, const void* dy, void* dxg, void* dw, void* db, void* dh0,
              void* dw_part, void* db_part, int lanes, int n_steps, int batch, int hidden,
              void* stream) {
  return adj_launch<float, TimeMajor>(xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0, dw_part,
                                      db_part, lanes, n_steps, batch, hidden, 0, stream);
}

}  // extern "C"
