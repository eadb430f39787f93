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
//     (t, b) as a [T*B, H] x [H, 3H] product on the tensor cores, then r,
//     z, n and six f32 factors per (t, b, unit): a_r = cn cr, cz, a_n =
//     cn r, z, dy[t] and cn, where cz = (h_prev - n) z (1 - z), cn = (1 -
//     z)(1 - n^2), cr = hn r (1 - r). A step of the walk is then dr_pre =
//     dht a_r, dz_pre = dht cz, dg_n = dht a_n and dht z.
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
//     dW = dg_lo^T @ h_prev and db = sum dg over chunks of rows (t, b) on
//     the tensor cores, each chunk's partial written in torch layout;
//     gru_adj_reduce sums the chunks in chunk order. dW and db are the same
//     bits from run to run (no atomics, a fixed order of sums).
// The workspace (the factors, dht and the dW partials) comes from the
// wrapper as dw_part, the db partials as db_part.
//
// The two passes over all T. Both are [T*B, H] x [H, 3H] products with an
// elementwise prologue or epilogue: 6 T B H^2 FLOPs a lane each (193 GFLOP
// at T=480, B=64, H=1024), against ~11 H (pre-pass) and ~9 H (weight
// gradient) f32 words a row of device memory, so they are bound by bytes
// at the sweep's H=64 and by the tensor cores from H of a few hundred up.
// Both take their products on the tensor cores with f32 sums: bf16 streams
// through mma.sync m16n8k16 (bf16 operands, as the TPU kernels' bf16 mode
// takes them), f32 streams as 3xTF32 through m16n8k8 (each operand split
// into a TF32 head and a TF32 residual, three products summed in f32:
// ~1e-6 relative where one TF32 product leaves ~5e-4, too far for the
// adjoint's 1e-4; each K step's products start from zero and join the
// f32 sum by a rounded add, as the tensor cores' own accumulation over a
// chunk's thousands of rows drifted). Their shared memory does not grow
// with H: the pre-pass's leaves room for two blocks an SM, the
// weight-gradient pass's ring takes one.
//   * The pre-pass: a block owns one lane's 32 units (all three gates'
//     columns of W, so one thread's sums hold r, z and n of its (row, unit)
//     pairs and it writes their six factors) and walks row tiles of 128
//     rows, blockIdx.x, + gridDim.x, ... (as many blocks as the card holds
//     at once, split over the lanes' unit tiles). Its work is one sequence
//     of (row tile, K chunk of 32) items through a cp.async ring of three
//     stages, so the next tile's first chunks are in flight during a
//     tile's epilogue. Up to H = 128 the block's W slice is loaded once and
//     stays in shared memory; past it each item brings its W chunk.
//   * The weight-gradient pass: a block holds a 128 x 128 tile of dW (gate
//     columns x units) and takes one chunk's rows 32 at a time through a
//     ring of three stages: cp.async brings the next stages' h_prev,
//     factors, dht (and cn) while the block rebuilds this stage's dg (db's
//     compensated sums and dxg in the same sweep, by the blocks of unit
//     tile 0) and sums its products. The rows are split into chunks only as
//     far as the lanes' tiles take to fill the SMs (adj_chunk_rows): one
//     chunk at H >= 256 and 15 lanes, or at H = 1024 and one lane (192
//     tiles). What bounds them on the card (chip_smoke.py passes_phase,
//     PERF.md): bytes at H=64, where they run at 2-4x that bound; past a
//     few hundred the weight-gradient pass's re-reads of the factors and
//     dht from L2, once a unit tile.
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
// its own units' slice of dh_prev = dg_lo @ W + dht z as above. The
// cluster walk bounds f32 at H = 376 (K = 8); bf16 leaves it past H = 450
// (kAdjClusterMostBf16), where the gate pre-pass's shared memory ended it
// before the passes were redesigned.
//
// The grid walk: past those limits (adj_streamed), wherever one lane's W
// fits the card's aggregate shared memory (f32 to H = 1320, bf16 to 2112 at
// B = 64, one lane: grid_plan), gru_adj_grid_kernel replaces the streamed
// walk below, which re-read from L2 every step the W^T rows its clusters
// could not hold (199.8 MB a step at f32 H = 1024, chip_smoke.py 16b) and
// ran its 16 clusters in two waves. As the forward's grid walk: a group of G CTAs, one
// CTA an SM, walks a work item (a lane and up to 64 rows); CTA `rank` keeps
// the W^T rows of its ceil(H / G) units, loaded once an item. Each step the
// pairs' dg_lo goes into an exchange buffer in device memory [2 parity]
// [rows][3H padded to a tile], a group barrier (a counter in device memory,
// release add, acquire loads), then every CTA reads the item's whole dg_lo
// back from L2 a K tile at a time through a cp.async ring of up to 8 tiles
// and sums its units' dg_lo @ W, in f32 on CUDA cores, in bf16 on the
// tensor cores as the forward's grid walk (f32 sums in both). The
// exchange moves dg_lo, G x rows x 3H values a step; exchanging per-CTA
// partials of dh_prev instead would move 2 x G x rows x H, two thirds of it
// in f32 but more in bf16 (the partials stay f32), and needs a second pass
// over G partials a step in a fixed order; dg_lo keeps one kernel skeleton
// with the forward's and one read a step. The next step's factors are
// loaded before the K loop that hides them, and the next step's dg_lo is
// formed right after it. Launched cooperatively after the plan's groups are
// checked against the card's occupancy, as the forward's; dW and db come
// from the same weight-gradient pass and reduction, so they stay the same
// bits from run to run. What bounds it: the dg_lo bytes every CTA reads each
// step (100.7 MB at f32 H = 1024) and the group barrier, not W's bytes.
//
// The streamed walk: past the grid walk's limit the walk is
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
// H is bounded only by those buffers (adj_max_hidden in gru_cuda.py). The
// passes are the same kernels at every H: at F = 15, T = 480, B = 64 the
// workspace is ~6.7 GB at H = 512 and ~13.4 GB at H = 1024, the factors and
// dht with one dW partial a lane (adj_workspace_floats).

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
// The gate pre-pass (gru_adj_gates_kernel): a tile of kGateRows rows (t, b)
// x kGateUnits units (their 3 x kGateUnits gate columns of W), K = H in
// chunks of kGateK through a ring of kGateStages stages; W's slice stays in
// shared memory for the block's whole run up to H = kGateResidentK.
constexpr int kGateRows = 128;
constexpr int kGateUnits = 32;
constexpr int kGateCols = 3 * kGateUnits;
constexpr int kGateK = 32;
constexpr int kGateStages = 3;
constexpr int kGateResidentK = 128;
constexpr int kGateThreads = 256;     // 8 warps: 4 row groups x 2 unit halves
// The weight-gradient pass (gru_adj_wgrad_kernel): a block's tile of dW,
// kGradTile gate columns x kGradTile units, its rows (t, b) kGradStage at
// a time through a ring of kGradStages stages.
constexpr int kGradTile = 128;
constexpr int kGradStage = 32;
constexpr int kGradStages = 3;
constexpr int kGradThreads = 256;     // 8 warps: 2 column groups x 4 unit groups
constexpr size_t kMaxShared = 232448;
constexpr int kMaxCluster = 8;        // the portable thread block cluster size
// The most threads a CTA of the cluster walk takes (576 is the most any H
// asks for): its launch bound, below kMaxThreads, leaves ptxas registers.
constexpr int kClusterMaxThreads = 576;
constexpr int kNoCluster = -1;        // returned when no cluster of the size fits the card
// The streamed walk: the most dot threads of a CTA, the most rows of a tile
// (a (row, unit) pair a sub-lane), the slots of each dot thread's cp.async
// ring.
constexpr int kStreamDotThreads = 512;
constexpr int kStreamMostRows = 4;
constexpr int kStreamStages = 2;
// Clusters of kMaxCluster CTAs of one CTA an SM that an H100 runs at once
// (cudaOccupancyMaxActiveClusters: 15, not 132 / 8).
constexpr int kStreamClusters = 15;

#include "gru_grid.cuh"

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
// Dynamic shared memory of the two passes over all T, which does not grow
// with H. The gate pre-pass: W's slice [3 x kGateUnits][kGateResidentK + 16
// bytes] in the stream dtype (resident up to H = kGateResidentK; past it the
// same bytes hold the ring's kGateStages W chunks [3 x kGateUnits][kGateK +
// 16 bytes]), then the ring's h_prev chunks [kGateStages][kGateRows][kGateK
// + 16 bytes]. The weight-gradient pass: kGradStages stages of kGradStage rows, each
// h_prev [rows][kGradTile + 8] in the stream dtype and the factors (then
// f32 dg) [rows][kGradTile + 8], dht and cn [rows][kGradTile] in f32; in bf16
// one tile of dg_lo [rows][kGradTile + 8]; kGradTile f32 for db; each
// stage's rows' places in the streams, [kGradStages][rows] int.
__host__ __device__ constexpr int adj_gate_a_stride(size_t itemsize) {
  return kGateK + int(16 / itemsize);
}
__host__ __device__ constexpr int adj_gate_w_stride(size_t itemsize) {
  return kGateResidentK + int(16 / itemsize);
}
__host__ __device__ constexpr size_t adj_gates_shared_bytes(size_t itemsize) {
  return (size_t(kGateCols) * adj_gate_w_stride(itemsize) +
          size_t(kGateStages) * kGateRows * adj_gate_a_stride(itemsize)) *
         itemsize;
}
static_assert(kGateStages * (kGateK + 4) <= kGateResidentK + 4 &&
                  kGateStages * (kGateK + 8) <= kGateResidentK + 8,
              "the streamed W chunks fit where the resident W slice lies");
__host__ __device__ constexpr size_t adj_grad_stage_bytes(size_t itemsize) {
  return size_t(kGradStage) * ((kGradTile + 8) * itemsize + (kGradTile + 8) * sizeof(float) +
                               2 * kGradTile * sizeof(float));
}
__host__ __device__ constexpr size_t adj_grad_shared_bytes(size_t itemsize) {
  return kGradStages * adj_grad_stage_bytes(itemsize) +
         (itemsize == sizeof(float) ? 0 : size_t(kGradStage) * (kGradTile + 8) * itemsize) +
         kGradTile * sizeof(float) + kGradStages * kGradStage * sizeof(int);
}
__host__ __device__ constexpr size_t adj_pass_shared_bytes(size_t itemsize) {
  return adj_gates_shared_bytes(itemsize) > adj_grad_shared_bytes(itemsize)
             ? adj_gates_shared_bytes(itemsize)
             : adj_grad_shared_bytes(itemsize);
}
// The most any kernel of the one-block or cluster design takes of one
// block's or CTA's shared memory at this H's cluster size (kMaxCluster past
// the walk's limit).
size_t adj_cluster_shared_bytes(int hidden, size_t itemsize, int rows) {
  const int cluster = adj_cluster_size(hidden, itemsize);
  const size_t walk = adj_walk_shared_bytes(hidden, itemsize, rows, cluster ? cluster : kMaxCluster);
  return walk > adj_pass_shared_bytes(itemsize) ? walk : adj_pass_shared_bytes(itemsize);
}
// The bf16 adjoint leaves the cluster walk past this H, where the gate
// pre-pass's shared memory ended it before the passes were redesigned; the
// cluster walk beyond it (to ~515) has not been timed against the grid walk.
constexpr int kAdjClusterMostBf16 = 450;
// Whether this H runs the streamed walk: past the one-block and cluster
// design's limit.
bool adj_streamed(int hidden, size_t itemsize) {
  return adj_cluster_size(hidden, itemsize) == 0 ||
         (itemsize != sizeof(float) && hidden > kAdjClusterMostBf16) ||
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
// The most any kernel of the adjoint walk takes of one block's or CTA's
// shared memory for a walk tile of `rows`; the wrapper checks it.
size_t adj_shared_bytes(int hidden, size_t itemsize, int rows) {
  if (!adj_streamed(hidden, itemsize)) return adj_cluster_shared_bytes(hidden, itemsize, rows);
  const size_t walk = adj_stream_shared_bytes(hidden, itemsize, rows);
  return walk > adj_pass_shared_bytes(itemsize) ? walk : adj_pass_shared_bytes(itemsize);
}
// The grid walk's plan where it takes the shape: past the one-block and
// cluster design's limit, wherever one lane's W fits the card (ctas 0
// elsewhere).
GridPlan adj_grid(int batch, int lanes, int hidden, size_t itemsize) {
  return adj_streamed(hidden, itemsize) ? grid_plan(batch, lanes, hidden, itemsize, true)
                                        : GridPlan{};
}
// Rows per block (or streamed tile) of the walk for this shape.
int adj_rows(int batch, int lanes, int hidden, size_t itemsize) {
  return adj_streamed(hidden, itemsize) ? adj_stream_row_tile(batch, lanes, hidden, itemsize)
                                        : adj_row_tile(batch, lanes, hidden);
}

// Rows (t, b) of one lane per chunk of the weight-gradient pass: as many
// chunks as the lanes' dW tiles (kGradTile x kGradTile of [3H, H]) take to
// fill the SMs without passing their count, one where the tiles alone fill
// them; whole stages of kGradStage rows. The chunk count is the number of
// dW / db partials.
long long adj_chunk_rows(int lanes, int n_steps, int batch, int hidden) {
  const long long rows = static_cast<long long>(n_steps) * batch;
  const long long tiles = static_cast<long long>(lanes) * ((hidden + kGradTile - 1) / kGradTile) *
                          ((3 * hidden + kGradTile - 1) / kGradTile);
  const long long want = tiles >= kNumSMs ? 1 : kNumSMs / tiles;
  const long long per = (rows + want - 1) / want;
  return per > kGradStage ? (per + kGradStage - 1) / kGradStage * kGradStage : kGradStage;
}
int adj_partials(int lanes, int n_steps, int batch, int hidden) {
  const long long rows = static_cast<long long>(n_steps) * batch;
  const long long chunk = adj_chunk_rows(lanes, n_steps, batch, hidden);
  return int((rows + chunk - 1) / chunk);
}
// The f32 workspace each entry takes as dw_part: the factors [rows][6][H] and
// dht [rows][H] (rows = lanes * T * B, in the streams' order), then the dW
// partials [lanes][partials][3H][H]; then, from a 16-byte boundary, the grid
// walk's exchange buffers and counters (grid_workspace_bytes) or the
// streamed walk's W^T padded [lanes][H][kpad] in the stream dtype.
long long adj_wt_offset(int lanes, int n_steps, int batch, int hidden) {
  const long long rows = static_cast<long long>(lanes) * n_steps * batch;
  const long long base = rows * hidden * (kFactors + 1) +
      static_cast<long long>(lanes) * adj_partials(lanes, n_steps, batch, hidden) * 3 * hidden *
          hidden;
  return (base + 3) / 4 * 4;
}
long long adj_workspace_floats(int lanes, int n_steps, int batch, int hidden, size_t itemsize) {
  const long long rows = static_cast<long long>(lanes) * n_steps * batch;
  const long long base = rows * hidden * (kFactors + 1) +
      static_cast<long long>(lanes) * adj_partials(lanes, n_steps, batch, hidden) * 3 * hidden *
          hidden;
  if (!adj_streamed(hidden, itemsize)) return base;
  const GridPlan grid = grid_plan(batch, lanes, hidden, itemsize, true);
  if (grid.ctas > 0)
    return adj_wt_offset(lanes, n_steps, batch, hidden) +
           static_cast<long long>(grid_workspace_bytes(grid, itemsize) / 4);
  const long long wt = static_cast<long long>(lanes) * hidden * adj_kpad(hidden, false) *
                       static_cast<long long>(itemsize);
  return adj_wt_offset(lanes, n_steps, batch, hidden) + (wt + 15) / 16 * 4;
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

// The grid walk (see the note at the top): a group of p.ctas CTAs, one an
// SM, walks one work item (a lane and up to p.rows batch rows) at a time;
// p.groups groups run at once and take the items in turn. CTA `rank` keeps
// the W^T rows of its p.units units (w_s[row][c] = W[c][unit0 + k], row
// v x unit pairs + q for unit k = q U + v), in shared memory for the whole
// item. Thread (row group, unit pair, sub-lane s) owns the (row, unit) pairs
// of its row s and its two units (its kGridRows rows interleave with the
// pass's other row groups'). A step: the pairs' dg_lo (their dht times the
// factors, rounded to the stream dtype) goes into the exchange buffer of the
// step's parity in device memory, dht to dht_out, dht z into shared memory;
// the group barrier; then the whole dg_lo of the item's rows is read back
// p.kt columns at a time through a ring of p.stages tiles that every thread
// fills with cp.async, each thread sums
// its rows x units over K chunks s, s + kGridSub, ... of each tile, an xor
// butterfly completes the sums, and dh = dht z + sum is the pair's; the
// next step's factors are loaded before that K loop, which hides them, and
// the next step's dg_lo follows right after it.
template <typename T, typename Layout>
__global__ void __launch_bounds__(grid_max_threads(true), 1)
    gru_adj_grid_kernel(const float* __restrict__ fac, const T* __restrict__ w_hh,
                        float* __restrict__ dht_out, float* __restrict__ dh0,
                        T* __restrict__ exch, unsigned* __restrict__ counters, int lanes,
                        int n_steps, int batch, int hidden, int reverse, GridPlan p) {
  constexpr int S = kGridSub;
  constexpr int R = kGridRows;
  constexpr int U = grid_thread_units(true);
  constexpr int RS = R / S;                 // rows of a pair lane
  constexpr int CH = 16 / int(sizeof(T));   // elements of one 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = hidden;
  const int kx = grid_kx(3 * H, p.kt);
  const int kw = kx + kGridPad;
  const int kt = p.kt + kGridPad;
  const int u = p.units;
  const int pairs = (u + U - 1) / U;  // unit pairs of the CTA
  const int group = blockIdx.x / p.ctas;
  const int rank = blockIdx.x - group * p.ctas;
  const int unit0 = rank * u;
  const int mine = H - unit0 < u ? (H > unit0 ? H - unit0 : 0) : u;  // inside H
  const int tid = threadIdx.x;
  const int s = tid % S;
  const int q = tid / S % pairs;
  const int rg = tid / (S * pairs);
  const int row_groups_pass = p.pass_rows / R;
  const bool worker = rg < row_groups_pass;  // the others only copy

  T* w_s = reinterpret_cast<T*>(smem);  // [U][pairs][kw]: unit q U + v at row v pairs + q
  unsigned char* after_w = smem + align16(size_t(pairs) * U * kw * sizeof(T));
  T* tiles = reinterpret_cast<T*>(after_w);  // [stages][pass_rows][kt]
  float* dhz = reinterpret_cast<float*>(
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
  // bf16: the products on the tensor cores, as the forward's grid walk does:
  // warp (m, n, k) takes 16-row tile m of the pass, unit octet n and every
  // kslices-th 16-column step of each K tile; its f32 sums (the first four
  // floats of acc) go to the ring's memory as partials after the K loop and
  // are summed over the K slices in a fixed order by the pair lanes; the
  // FMAs run where the pass or the partials do not suit it.
  const int warp = tid / 32;
  const int lane32 = tid % 32;
  const int mtiles = p.pass_rows / 16;
  const int octets = (u + 7) / 8;
  int kslices = mtiles > 0 ? int(blockDim.x / 32) / (mtiles * octets) : 0;
  if (kslices > p.kt / 16) kslices = p.kt / 16;
  const bool tensor = sizeof(T) == 2 && p.pass_rows % 16 == 0 && kslices > 0 &&
                      size_t(kslices) * p.pass_rows * u * sizeof(float) <=
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
    const int wrows = pairs * U;
    for (int e = tid; e < wrows * kw; e += blockDim.x) {
      const int c = e / wrows;  // read W's columns of this CTA's units row by row
      const int kk = e - c * wrows;
      w_s[(size_t(kk % U) * pairs + kk / U) * kw + c] =
          c < 3 * H && kk < mine ? w[size_t(c) * H + unit0 + kk] : from_float<T>(0.0f);
    }
    // Rows past the batch stay zero in both parity buffers.
    for (int e = tid; e < (p.rows - nb) * 3 * H; e += blockDim.x) {
      const int r = nb + e / (3 * H);
      const int c = e - (r - nb) * 3 * H;
      const int k = c % H;
      if (k >= unit0 && k < unit0 + mine) {
        ex[size_t(r) * kx + c] = from_float<T>(0.0f);
        ex[size_t(p.rows + r) * kx + c] = from_float<T>(0.0f);
      }
    }
    auto at_step = [&](int step, int r) {
      const int t = reverse ? step : n_steps - 1 - step;
      return Layout::row(lane, t, b0 + r, lanes, n_steps, batch);
    };
    // The pair (row pr0 + (s + S i) RG + rg, unit q U + v) of this thread,
    // RG the pass's row groups (rows of a thread interleave with the other
    // row groups', so a warp's loads of neighbouring rows meet other banks).
    auto pair_row = [&](int pr0, int i) { return pr0 + (s + S * i) * row_groups_pass + rg; };
    auto pair_ok = [&](int pr0, int i, int v) {
      return worker && pair_row(pr0, i) < nb && q * U + v < mine;
    };
    // Factors a_r, cz, a_n, z, dy of `step` for the thread's pairs of a pass.
    auto fetch = [&](int step, int pr0, float (&fv)[RS][U][kWalkFactors]) {
#pragma unroll
      for (int i = 0; i < RS; ++i)
#pragma unroll
        for (int v = 0; v < U; ++v) {
          const bool ok = step < n_steps && pair_ok(pr0, i, v);
          const float* f =
              ok ? fac + at_step(step, pair_row(pr0, i)) * kFactors * H + unit0 + q * U + v
                 : nullptr;
#pragma unroll
          for (int k = 0; k < kWalkFactors; ++k) fv[i][v][k] = ok ? f[k * H] : 0.0f;
        }
    };
    // dht = dh + dy; dg_lo into the step's parity buffer, dht out, dht z kept.
    auto front = [&](int step, int pr0, const float (&dh)[RS][U],
                     const float (&fv)[RS][U][kWalkFactors]) {
      T* buf = ex + size_t(step & 1) * p.rows * kx;
#pragma unroll
      for (int i = 0; i < RS; ++i)
#pragma unroll
        for (int v = 0; v < U; ++v) {
          if (!pair_ok(pr0, i, v)) continue;
          const int r = pair_row(pr0, i);
          const int kk = unit0 + q * U + v;
          const float dht = dh[i][v] + fv[i][v][4];
          T* out = buf + size_t(r) * kx + kk;
          out[0] = from_float<T>(dht * fv[i][v][0]);
          out[H] = from_float<T>(dht * fv[i][v][1]);
          out[2 * H] = from_float<T>(dht * fv[i][v][2]);
          dhz[r * u + q * U + v] = dht * fv[i][v][3];
          dht_out[at_step(step, r) * H + kk] = dht;
        }
    };
    for (int pass = 0; pass < passes; ++pass) {
      float fv[RS][U][kWalkFactors];
      float zero[RS][U];
#pragma unroll
      for (int i = 0; i < RS; ++i)
#pragma unroll
        for (int v = 0; v < U; ++v) zero[i][v] = 0.0f;
      fetch(0, pass * p.pass_rows, fv);
      front(0, pass * p.pass_rows, zero, fv);
    }
    group_sync(counter, arrivals += p.ctas);

    for (int step = 0; step < n_steps; ++step) {
      const T* cur = ex + size_t(step & 1) * p.rows * kx;
      for (int pass = 0; pass < passes; ++pass) {
        const int pr0 = pass * p.pass_rows;
        float fv[RS][U][kWalkFactors];
        fetch(step + 1, pr0, fv);
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
        float acc[R][U];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int v = 0; v < U; ++v) acc[i][v] = 0.0f;
        for (int tile = 0; tile < p.stages - 1; ++tile) load_tile(tile);
        for (int tile = 0; tile < ntiles; ++tile) {
          cp_async_wait_pending(p.stages - 2);
          __syncthreads();  // the tile is in; the slot refilled next is read by no one
          load_tile(tile + p.stages - 1);
          if (tensor) {
            if (mma_warp) {
              const T* ds = tiles + size_t(tile % p.stages) * p.pass_rows * kt;
              const T* a_row = ds + size_t(mma_m * 16 + lane32 % 16) * kt + lane32 / 16 * 8;
              // W^T's row of this lane's unit of the octet (a unit past u
              // reads the last one: its columns are dropped below).
              int b_unit = mma_n * 8 + lane32 % 8;
              if (b_unit > u - 1) b_unit = u - 1;
              const T* b_row = w_s + (size_t(b_unit % U) * pairs + b_unit / U) * kw +
                               tile * p.kt + lane32 / 8 % 2 * 8;
              for (int kk = mma_k; kk < p.kt / 16; kk += kslices) {
                unsigned a[4], b[2];
                ldmatrix_x4(a, a_row + kk * 16);
                ldmatrix_x2(b, b_row + kk * 16);
                mma_bf16_16816(&acc[0][0], a, b);
              }
            }
          } else if (worker) {
            const T* ds = tiles + size_t(tile % p.stages) * p.pass_rows * kt + size_t(rg) * kt;
            const T* ws = w_s + size_t(q) * kw + tile * p.kt;
#pragma unroll 1  // unrolled, the chunks' loads spilled under a 512-thread bound
            for (int cc = 0; cc < p.kt / (4 * S); ++cc) {
              const int c = 4 * (s + S * cc);
              float wv[U][4];
#pragma unroll
              for (int v = 0; v < U; ++v) load4(ws + size_t(v) * pairs * kw + c, wv[v]);
#pragma unroll
              for (int i = 0; i < R; ++i) {
                float dv[4];
                load4(ds + size_t(i) * row_groups_pass * kt + c, dv);
#pragma unroll
                for (int v = 0; v < U; ++v)
#pragma unroll
                  for (int e = 0; e < 4; ++e) acc[i][v] = fmaf(dv[e], wv[v][e], acc[i][v]);
              }
            }
          }
        }
        float dh[RS][U];
#pragma unroll
        for (int i = 0; i < RS; ++i)
#pragma unroll
          for (int v = 0; v < U; ++v) dh[i][v] = 0.0f;
        if (tensor) {
          __syncthreads();  // no warp reads the ring any more: it takes the partials
          float* part = reinterpret_cast<float*>(tiles);  // [kslices][pass_rows][u]
          if (mma_warp) {
            const float* c = &acc[0][0];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = mma_m * 16 + lane32 / 4 + e / 2 * 8;
              const int col = mma_n * 8 + lane32 % 4 * 2 + e % 2;
              if (col < u) part[(size_t(mma_k) * p.pass_rows + row) * u + col] = c[e];
            }
          }
          __syncthreads();
#pragma unroll
          for (int i8 = 0; i8 < R; ++i8) {
            if (i8 % S != s) continue;
            const int i = i8 / S;
#pragma unroll
            for (int v = 0; v < U; ++v) {
              if (!pair_ok(pr0, i, v)) continue;
              const int rl = pair_row(pr0, i) - pr0;
              float sum = 0.0f;
              for (int k = 0; k < kslices; ++k)
                sum += part[(size_t(k) * p.pass_rows + rl) * u + q * U + v];
              dh[i][v] = dhz[pair_row(pr0, i) * u + q * U + v] + sum;
            }
          }
        } else {
#pragma unroll
          for (int off = S / 2; off > 0; off >>= 1)
#pragma unroll
            for (int i = 0; i < R; ++i)
#pragma unroll
              for (int v = 0; v < U; ++v) acc[i][v] += __shfl_xor_sync(0xffffffffu, acc[i][v], off);
#pragma unroll
          for (int i8 = 0; i8 < R; ++i8) {
            if (i8 % S != s) continue;
            const int i = i8 / S;
#pragma unroll
            for (int v = 0; v < U; ++v)
              if (pair_ok(pr0, i, v))
                dh[i][v] = dhz[pair_row(pr0, i) * u + q * U + v] + acc[i8][v];
          }
        }
        if (step + 1 < n_steps) {
          front(step + 1, pr0, dh, fv);
        } else {
#pragma unroll
          for (int i = 0; i < RS; ++i)
#pragma unroll
            for (int v = 0; v < U; ++v)
              if (pair_ok(pr0, i, v))
                dh0[(size_t(lane) * batch + b0 + pair_row(pr0, i)) * H + unit0 + q * U + v] =
                    dh[i][v];
        }
        __syncthreads();  // the ring's slots are free for the next pass
      }
      // The next step's dg_lo is in; after the last step, no CTA of the
      // group starts the next item's writes while a peer still reads.
      group_sync(counter, arrivals += p.ctas);
    }
  }
}

// ---------------------------------------------------------------------------
// The two passes over all T: the gate pre-pass and the weight-gradient pass,
// on the tensor cores (see the note at the top)
// ---------------------------------------------------------------------------

// 16 bytes of a pass's tile: 4 f32 or 8 bf16 values, from device memory by
// cp.async where the source is a whole aligned piece of the same type,
// else value by value (zeros past `left` values, a float source rounded to
// the tile's type).
__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}
__device__ __forceinline__ void piece_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
template <typename T>
__device__ __forceinline__ void zero_piece(T* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}
template <typename T, typename S>
__device__ __forceinline__ void copy_piece(T* dst, const S* src, int left, bool vec) {
  constexpr int E = 16 / sizeof(T);
  if constexpr (sizeof(T) == sizeof(S)) {
    if (vec) {
      piece_async(dst, src);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = from_float<T>(e < left ? to_float(src[e]) : 0.0f);
}

// Two consecutive values (8-byte aligned f32, 4-byte aligned bf16) as floats,
// and two f32 stores.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The h_prev row of (lane, step t, row b): ys at the step the forward took
// before t, or nullptr at the forward's first step, whose h_prev is h0.
template <typename T, typename Layout>
__device__ __forceinline__ const T* h_prev_row(const T* __restrict__ ys, int lane, int t, int b,
                                               int lanes, int n_steps, int batch, int hidden,
                                               int reverse) {
  const int tp = reverse ? t + 1 : t - 1;
  return tp >= 0 && tp < n_steps ? ys + Layout::row(lane, tp, b, lanes, n_steps, batch) * hidden
                                 : nullptr;
}

// 3xTF32 products of f32 operands: x = hi + lo, each with TF32's 10-bit
// mantissa (the low 13 bits masked off), and a b ~ a_hi b_hi + a_hi b_lo +
// a_lo b_hi (the small terms first), summed in f32 by mma.sync m16n8k8:
// ~1e-6 relative where one TF32 product leaves ~5e-4.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
__device__ __forceinline__ void mma_tf32_1688(float* d, unsigned a0, unsigned a1, unsigned a2,
                                              unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// d += a b: a as [hi 0-3][lo 4-7] (the m16n8k8 A fragment), b as [hi 0-1][lo 2-3].
__device__ __forceinline__ void mma_3xtf32(float* d, const unsigned (&a)[8],
                                           const unsigned (&b)[4]) {
  mma_tf32_1688(d, a[4], a[5], a[6], a[7], b[0], b[1]);
  mma_tf32_1688(d, a[0], a[1], a[2], a[3], b[2], b[3]);
  mma_tf32_1688(d, a[0], a[1], a[2], a[3], b[0], b[1]);
}
// The m16n8k8 A fragment of rows (r, r + 8) x columns (k, k + 4) of a
// row-major f32 tile (p at row r, column k), split.
__device__ __forceinline__ void a_frag_tf32(unsigned (&a)[8], const float* p, int stride) {
  split_tf32(p[0], a[0], a[4]);
  split_tf32(p[8 * stride], a[1], a[5]);
  split_tf32(p[4], a[2], a[6]);
  split_tf32(p[8 * stride + 4], a[3], a[7]);
}
// ldmatrix of four transposed 8x8 b16 tiles: lane l gets two values of
// column l / 4 of each, rows 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Gate pre-pass, every (lane, t, b, unit j) at once: hg = h_prev @ W^T + bh
// as a [T*B, H] x [H, 3H] product on the tensor cores, then r, z, n and the
// gate adjoint's factors
//   cz = (h_prev - n) z (1 - z), cn = (1 - z)(1 - n^2), cr = hn r (1 - r),
//   a_r = cn cr, a_n = cn r,
// stored as a_r, cz, a_n, z, dy[t] (f32), cn: the walk turns dht into
// dr_pre = dht a_r, dz_pre = dht cz, dg_n = dht a_n and dht z, and the
// weight-gradient pass repeats those products and adds dn_pre = dht cn.
// A block owns one lane's kGateUnits units (all three gates' columns of W,
// so one thread's sums hold r, z and n of its (row, unit) pairs) and walks
// row tiles blockIdx.x, + gridDim.x, ...; its work is one sequence of (row
// tile, K chunk) items through a cp.async ring of kGateStages stages, so
// the next tile's first chunks are in flight during a tile's epilogue. Up
// to H = kGateResidentK W's slice is loaded once and stays; past it each
// item brings its own W chunk. Warp w: rows 32 (w % 4) .. + 31 (two m16
// tiles), units 16 (w / 4) .. + 15 of each gate (two n8 tiles a gate).
// f32: 3xTF32 (mma m16n8k8); bf16: mma m16n8k16, f32 sums.
template <typename T, typename Layout>
__global__ void __launch_bounds__(kGateThreads, 2)
    gru_adj_gates_kernel(const T* __restrict__ xg, const T* __restrict__ w_hh,
                         const T* __restrict__ b_hh, const float* __restrict__ h0,
                         const T* __restrict__ ys, const T* __restrict__ dy,
                         float* __restrict__ fac, int n_steps, int batch, int hidden,
                         int reverse) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int E = 16 / sizeof(T);                  // values of a 16-byte piece
  constexpr int AS = adj_gate_a_stride(sizeof(T));   // row of an h_prev chunk (and a W chunk)
  constexpr int WR = adj_gate_w_stride(sizeof(T));   // row of the resident W slice
  extern __shared__ __align__(16) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);  // [kGateCols][WR], or kGateStages x [kGateCols][AS]
  T* a_s = w_s + kGateCols * WR;        // kGateStages x [kGateRows][AS]
  const int H = hidden;
  const int G = 3 * hidden;
  const int lane = blockIdx.z;
  const int lanes = gridDim.z;
  const int j0 = blockIdx.y * kGateUnits;
  const int n_rows = n_steps * batch;  // a lane's rows (t, b); adj_launch keeps row indices ints
  const int tiles = (n_rows + kGateRows - 1) / kGateRows;
  const int nk = (H + kGateK - 1) / kGateK;
  const bool resident = H <= kGateResidentK;
  const int mine = int(blockIdx.x) < tiles ? (tiles - 1 - int(blockIdx.x)) / int(gridDim.x) + 1 : 0;
  const int items = mine * nk;
  const int tid = threadIdx.x;
  const T* w = w_hh + size_t(lane) * G * H;
  const bool vec = H % E == 0 && aligned16(ys) && aligned16(w_hh) && aligned16(h0);
  // Two units at a time in the epilogue: every row of every stream then
  // starts 8-byte (f32) or 4-byte (bf16) aligned, as the tensors' bases are.
  const bool pairs = H % 2 == 0 && aligned16(xg) && aligned16(b_hh) && aligned16(ys) &&
                     aligned16(dy) && aligned16(h0) && aligned16(fac);

  // W's rows of the tile's units, K columns k0 .. k0 + kGateK - 1, into rows
  // [gate * kGateUnits + unit] of `dst`.
  auto load_w = [&](T* dst, int stride, int k0) {
    for (int p = tid; p < kGateCols * (kGateK / E); p += kGateThreads) {
      const int cc = p / (kGateK / E);
      const int kk = (p - cc * (kGateK / E)) * E;
      const int gate = cc / kGateUnits;
      const int j = j0 + cc - gate * kGateUnits;
      const int k = k0 + kk;
      T* d = dst + cc * stride + kk;
      if (j < H && k < H)
        copy_piece(d, w + (size_t(gate) * H + j) * H + k, H - k, vec);
      else
        zero_piece(d);
    }
  };
  // h_prev of a tile's rows, K columns k0 .. k0 + kGateK - 1. A thread
  // copies the same kRowsA rows of every tile at the same K offset; their
  // sources are found once a tile: a row of ys (>= 0), h0's row b (-1 - b),
  // or none past the lane's rows.
  constexpr int kPiecesRow = kGateK / E;
  constexpr int kRowStep = kGateThreads / kPiecesRow;
  constexpr int kRowsA = kGateRows / kRowStep;
  constexpr int kNoRow = -0x7fffffff;
  const int a_rr = tid / kPiecesRow;
  const int a_kk = (tid % kPiecesRow) * E;
  int a_tile = -1;
  int a_src[kRowsA];
  auto load_a = [&](T* dst, int tile, int k0) {
    if (tile != a_tile) {
      a_tile = tile;
#pragma unroll
      for (int r = 0; r < kRowsA; ++r) {
        const int m = tile * kGateRows + a_rr + r * kRowStep;
        const int t = m / batch;
        const int b = m - t * batch;
        const int tp = reverse ? t + 1 : t - 1;
        a_src[r] = m >= n_rows ? kNoRow
                   : tp >= 0 && tp < n_steps ? int(Layout::row(lane, tp, b, lanes, n_steps, batch))
                                             : -1 - b;
      }
    }
    const int k = k0 + a_kk;
#pragma unroll
    for (int r = 0; r < kRowsA; ++r) {
      T* d = dst + (a_rr + r * kRowStep) * AS + a_kk;
      if (a_src[r] == kNoRow || k >= H)
        zero_piece(d);
      else if (a_src[r] >= 0)
        copy_piece(d, ys + size_t(a_src[r]) * H + k, H - k, vec);
      else
        copy_piece(d, h0 + (size_t(lane) * batch - 1 - a_src[r]) * H + k, H - k, vec);
    }
  };
  auto load_item = [&](int q) {
    const int i = q / nk;
    const int kc = q - i * nk;
    const int slot = q % kGateStages;
    load_a(a_s + slot * kGateRows * AS, int(blockIdx.x + i * gridDim.x), kc * kGateK);
    if (!resident) load_w(w_s + slot * kGateCols * AS, AS, kc * kGateK);
  };

  if (resident && items > 0)  // committed with the first item
    for (int kc = 0; kc < nk; ++kc) load_w(w_s + kc * kGateK, WR, kc * kGateK);
#pragma unroll
  for (int q = 0; q < kGateStages - 1; ++q) {
    if (q < items) load_item(q);
    cp_async_commit();
  }

  const int warp = tid / 32;
  const int wl = tid % 32;
  const int wm = warp % 4;  // rows 32 wm .. 32 wm + 31 of the tile
  const int wn = warp / 4;  // units 16 wn .. 16 wn + 15 of each gate
  const int g = wl / 4;
  const int tig = wl % 4;
  float acc[2][3][2][4];  // [m16 tile][gate][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int gt = 0; gt < 3; ++gt)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][gt][s][e] = 0.0f;

  for (int q = 0; q < items; ++q) {
    cp_async_wait<kGateStages - 2>();
    __syncthreads();  // item q is in; every warp is done with item q - 1's stage
    if (q + kGateStages - 1 < items) load_item(q + kGateStages - 1);
    cp_async_commit();
    const int i_tile = q / nk;
    const int kc = q - i_tile * nk;
    const int slot = q % kGateStages;
    const T* a = a_s + slot * kGateRows * AS;
    const T* wk = resident ? w_s + kc * kGateK : w_s + slot * kGateCols * AS;
    const int ws = resident ? WR : AS;
    if constexpr (kBf16) {
#pragma unroll
      for (int ks = 0; ks < kGateK / 16; ++ks) {
        unsigned af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4(af[i], a + (wm * 32 + i * 16 + (wl & 7) + ((wl >> 3) & 1) * 8) * AS +
                                 ks * 16 + (wl >> 4) * 8);
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) {
          unsigned bf[4];
          ldmatrix_x4(bf, wk + (gt * kGateUnits + wn * 16 + (wl & 7) + (wl >> 4) * 8) * ws +
                              ks * 16 + ((wl >> 3) & 1) * 8);
          const unsigned b0[2] = {bf[0], bf[1]};
          const unsigned b1[2] = {bf[2], bf[3]};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16_16816(acc[i][gt][0], af[i], b0);
            mma_bf16_16816(acc[i][gt][1], af[i], b1);
          }
        }
      }
    } else {
#pragma unroll 1  // as the weight-gradient pass's: unrolled, the split fragments spilled
      for (int ks = 0; ks < kGateK / 8; ++ks) {
        unsigned af[2][8];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          a_frag_tf32(af[i], reinterpret_cast<const float*>(a) + (wm * 32 + i * 16 + g) * AS +
                                 ks * 8 + tig, AS);
#pragma unroll
        for (int gt = 0; gt < 3; ++gt)
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const float* bp = reinterpret_cast<const float*>(wk) +
                              (gt * kGateUnits + wn * 16 + s * 8 + g) * ws + ks * 8 + tig;
            unsigned bf[4];
            split_tf32(bp[0], bf[0], bf[2]);
            split_tf32(bp[4], bf[1], bf[3]);
#pragma unroll
            for (int i = 0; i < 2; ++i) mma_3xtf32(acc[i][gt][s], af[i], bf);
          }
      }
    }
    if (kc < nk - 1) continue;

    // The tile's epilogue: r, z, n and the six factors of each (row, unit)
    // pair this thread's sums hold (rows g, g + 8 of each m16 tile, units
    // 2 tig, 2 tig + 1 of each n8 tile), two units at a time where H is
    // even. Loads read a row inside the lane (past its last, the last), so
    // that the compiler may issue them all before the stores.
    const int m0 = int(blockIdx.x + i_tile * gridDim.x) * kGateRows;
    const T* bias = b_hh + size_t(lane) * G;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm * 32 + i * 16 + g + 8 * hh;
        const bool row_in = m < n_rows;
        const int mc = row_in ? m : n_rows - 1;
        const int t = mc / batch;
        const int b = mc - t * batch;
        const size_t at = Layout::row(lane, t, b, lanes, n_steps, batch);
        const T* x = xg + at * G;
        const T* hrow = h_prev_row<T, Layout>(ys, lane, t, b, lanes, n_steps, batch, H, reverse);
        const float* h0row = h0 + (size_t(lane) * batch + b) * H;
        const T* dyrow = dy + at * H;
        float* f = fac + at * kFactors * H;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int j = j0 + wn * 16 + s * 8 + 2 * tig;
          const float* hg_r = &acc[i][0][s][2 * hh];
          const float* hg_z = &acc[i][1][s][2 * hh];
          const float* hg_n = &acc[i][2][s][2 * hh];
          auto gate = [&](float xr, float xz, float xn, float br, float bz, float bn, float hp,
                          float dyv, int e, float* out) {
            const float r = sigmoid(xr + (hg_r[e] + br));
            const float z = sigmoid(xz + (hg_z[e] + bz));
            const float hn = hg_n[e] + bn;
            const float n = tanhf(xn + r * hn);
            const float cn = (1.0f - z) * (1.0f - n * n);
            out[0] = cn * (hn * r * (1.0f - r));
            out[1] = (hp - n) * z * (1.0f - z);
            out[2] = cn * r;
            out[3] = z;
            out[4] = dyv;
            out[5] = cn;
          };
          if (pairs) {
            if (j >= H) continue;
            const float2 xr = load2(x + j), xz = load2(x + H + j), xn = load2(x + 2 * H + j);
            const float2 br = load2(bias + j), bz = load2(bias + H + j),
                         bn = load2(bias + 2 * H + j);
            const float2 dyv = load2(dyrow + j);
            float2 hp;
            if (hrow) {
              hp = load2(hrow + j);
            } else {
              hp = load2(h0row + j);
              hp = make_float2(round_to<T>(hp.x), round_to<T>(hp.y));
            }
            float o0[kFactors], o1[kFactors];
            gate(xr.x, xz.x, xn.x, br.x, bz.x, bn.x, hp.x, dyv.x, 0, o0);
            gate(xr.y, xz.y, xn.y, br.y, bz.y, bn.y, hp.y, dyv.y, 1, o1);
            if (row_in)
#pragma unroll
              for (int q = 0; q < kFactors; ++q) store2(f + q * H + j, o0[q], o1[q]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int je = j + e;
              if (je >= H) continue;
              const float hp = hrow ? to_float(hrow[je]) : round_to<T>(h0row[je]);
              float o[kFactors];
              gate(to_float(x[je]), to_float(x[H + je]), to_float(x[2 * H + je]),
                   to_float(bias[je]), to_float(bias[H + je]), to_float(bias[2 * H + je]), hp,
                   to_float(dyrow[je]), e, o);
              if (row_in)
#pragma unroll
                for (int q = 0; q < kFactors; ++q) f[q * H + je] = o[q];
            }
          }
        }
        asm volatile("" ::: "memory");  // one row's loads in flight at a time: no spills
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int gt = 0; gt < 3; ++gt)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][gt][s][e] = 0.0f;
  }
  cp_async_wait<0>();
}

// Weight-gradient pass: dW[c][k] = sum over rows of dg_lo[c] h_prev[k] and
// db[c] = sum of the f32 dg[c], for one chunk of rows (t, b) of one lane,
// where dg is rebuilt from dht and the factors with the walk's own products
// (dg = dht x (a_r | cz | a_n), dg_lo rounded to the stream dtype); blocks
// of unit tile 0 also write dxg (dn_pre = dht cn) and db. A block holds
// kGradTile gate columns x kGradTile units of dW and takes its chunk's rows
// kGradStage at a time through kGradStages stages: while one stage's dg and
// products are computed, cp.async brings the next stages' h_prev, factors
// and dht (and cn, for dxg). Warp w: columns 64 (w / 4) .. + 63 (four m16
// tiles), units 32 (w % 4) .. + 31 (four n8 tiles); f32: 3xTF32, bf16: mma
// m16n8k16 (the operands bf16 already, so the products are exact), f32
// sums. Each chunk's partial is written in torch layout [3H][H];
// gru_adj_reduce sums the chunks in chunk order.
// One block an SM: its ring of three stages takes most of the SM's shared
// memory (and in f32 the 3xTF32 split fragments beside the 64 sums a thread
// take more than 128 registers).
template <typename T, typename Layout>
__global__ void __launch_bounds__(kGradThreads, 1)
    gru_adj_wgrad_kernel(const float* __restrict__ fac, const float* __restrict__ dht,
                         const T* __restrict__ ys, const float* __restrict__ h0,
                         T* __restrict__ dxg, float* __restrict__ dw_part,
                         float* __restrict__ db_part, int n_steps, int batch, int hidden,
                         int reverse, int chunk_rows) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int E = 16 / sizeof(T);
  constexpr int HS = kGradTile + 8;  // row of an h_prev stage (and of bf16 dg_lo)
  constexpr int FS = kGradTile + 8;  // row of a factor / f32 dg stage
  constexpr int DS = kGradTile;      // row of a dht stage
  constexpr size_t kStage = adj_grad_stage_bytes(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  auto h_at = [&](int slot) { return reinterpret_cast<T*>(smem + slot * kStage); };
  auto f_at = [&](int slot) {
    return reinterpret_cast<float*>(smem + slot * kStage + kGradStage * HS * sizeof(T));
  };
  auto d_at = [&](int slot) { return f_at(slot) + kGradStage * FS; };
  auto cn_at = [&](int slot) { return d_at(slot) + kGradStage * DS; };  // unit tile 0: dxg's cn
  T* dg_s = reinterpret_cast<T*>(smem + kGradStages * kStage);  // bf16: [kGradStage][HS]
  float* db_x = reinterpret_cast<float*>(smem + kGradStages * kStage +
                                         (kBf16 ? kGradStage * HS * sizeof(T) : 0));
  // Each stage's rows' places in the streams ([kGradStages][kGradStage]; -1 past the
  // chunk): row indices, which adj_launch keeps inside an int.
  int* at_s = reinterpret_cast<int*>(db_x + kGradTile);
  const int H = hidden;
  const int G = 3 * hidden;
  const int part = blockIdx.x;
  const int parts = gridDim.x;
  const int c0 = blockIdx.y * kGradTile;
  const int k_tiles = (H + kGradTile - 1) / kGradTile;
  const int lane = blockIdx.z / k_tiles;
  const int lanes = gridDim.z / k_tiles;
  const int k0 = (blockIdx.z - lane * k_tiles) * kGradTile;
  const int n_rows = n_steps * batch;  // a lane's rows (t, b); adj_launch keeps row indices ints
  const int m_begin = part * chunk_rows;
  const int m_end = m_begin + chunk_rows < n_rows ? m_begin + chunk_rows : n_rows;
  const int n_stages = m_end > m_begin ? (m_end - m_begin + kGradStage - 1) / kGradStage : 0;
  const int tid = threadIdx.x;
  const bool hvec = H % E == 0 && aligned16(ys) && aligned16(h0);
  const bool fvec = H % 4 == 0 && aligned16(fac) && aligned16(dht);

  // Columns past 3H, units past H and bf16 dg_lo stay zero unless written.
  for (size_t e = tid; e < adj_grad_shared_bytes(sizeof(T)) / 16; e += kGradThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // A stage's row is loaded by kRowThreads threads: its h_prev pieces, its
  // factor and dht pieces, and (its first thread) its place in the streams.
  constexpr int kRowThreads = kGradThreads / kGradStage;
  const int lrow = tid / kRowThreads;
  const int lsub = tid % kRowThreads;
  auto load_stage = [&](int st) {
    const int slot = st % kGradStages;
    const int m = m_begin + st * kGradStage + lrow;
    T* hs = h_at(slot) + lrow * HS;
    float* fs = f_at(slot) + lrow * FS;
    float* ds = d_at(slot) + lrow * DS;
    if (m >= m_end) {  // zeros: no dg, no db, no dxg
      for (int cc = lsub * 4; cc < kGradTile && c0 + cc < G; cc += kRowThreads * 4) {
        zero_piece(fs + cc);
        zero_piece(ds + cc);
      }
      if (lsub == 0) at_s[slot * kGradStage + lrow] = -1;
      return;
    }
    const int t = m / batch;
    const int b = m - t * batch;
    const size_t at = Layout::row(lane, t, b, lanes, n_steps, batch);
    if (lsub == 0) at_s[slot * kGradStage + lrow] = int(at);
    const T* src = h_prev_row<T, Layout>(ys, lane, t, b, lanes, n_steps, batch, H, reverse);
    const float* src0 = h0 + (size_t(lane) * batch + b) * H;
    for (int kk = lsub * E; kk < kGradTile && k0 + kk < H; kk += kRowThreads * E) {
      const int k = k0 + kk;
      if (src)
        copy_piece(hs + kk, src + k, H - k, hvec);
      else
        copy_piece(hs + kk, src0 + k, H - k, hvec);
    }
    const float* fsrc = fac + at * kFactors * H;  // a_r | cz | a_n, by gate column; cn at 3H on
    const float* dsrc = dht + at * H;
    float* cs = cn_at(slot) + lrow * DS;
    for (int cc = lsub * 4; cc < kGradTile && c0 + cc < G; cc += kRowThreads * 4) {
      const int c = c0 + cc;
      if (fvec) {
        piece_async(fs + cc, fsrc + c);
        piece_async(ds + cc, dsrc + c % H);
        if (k0 == 0 && c >= 2 * H) piece_async(cs + cc, fsrc + 3 * H + c);
      } else {
        for (int e = 0; e < 4 && c + e < G; ++e) {
          cp_async4(fs + cc + e, fsrc + c + e);
          cp_async4(ds + cc + e, dsrc + (c + e) % H);
          if (k0 == 0 && c + e >= 2 * H) cp_async4(cs + cc + e, fsrc + 3 * H + c + e);
        }
      }
    }
  };

  // dg of the stage, a column a thread and half its rows: db's sums, dxg
  // (the blocks of unit tile 0), and dg_lo where the products read it (f32:
  // in place of the factors).
  constexpr int kHalf = kGradStage / 2;
  const int cc = tid % kGradTile;
  const int half = tid / kGradTile;
  const int c = c0 + cc;
  const bool col = c < G;
  const int gate = col ? c / H : 0;
  const int j = c - gate * H;
  // db's sum over a chunk's rows, compensated (Kahan): a plain f32 sum of
  // tens of thousands of rows in one chunk drifted past BWD_TOL.
  float db_sum = 0.0f, db_err = 0.0f;
  auto convert = [&](int st) {
    if (!col) return;
    const int slot = st % kGradStages;
    float* fs = f_at(slot);
    const float* ds = d_at(slot);
    const float* cs = cn_at(slot);
    const int* ats = at_s + slot * kGradStage;
#pragma unroll 4
    for (int r = half * kHalf; r < (half + 1) * kHalf; ++r) {
      const float d = ds[r * DS + cc];
      const float dv = d * fs[r * FS + cc];
      const float y = dv - db_err;
      const float sum = db_sum + y;
      db_err = (sum - db_sum) - y;
      db_sum = sum;
      if constexpr (kBf16)
        dg_s[r * HS + cc] = from_float<T>(dv);
      else
        fs[r * FS + cc] = dv;
      if (k0 == 0 && ats[r] >= 0)
        dxg[size_t(ats[r]) * G + c] = from_float<T>(gate == 2 ? d * cs[r * DS + cc] : dv);
    }
  };

  const int warp = tid / 32;
  const int wl = tid % 32;
  const int wc = warp / 4;  // gate columns 64 wc .. 64 wc + 63 of the tile
  const int wk = warp % 4;  // units 32 wk .. 32 wk + 31 of the tile
  const int g = wl / 4;
  const int tig = wl % 4;
  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < kGradStages - 1; ++st) {
    if (st < n_stages) load_stage(st);
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kGradStages - 2>();
    __syncthreads();  // stage st is in; every warp is done with stage st - 1's products
    if (st + kGradStages - 1 < n_stages) load_stage(st + kGradStages - 1);
    cp_async_commit();
    convert(st);
    __syncthreads();  // the stage's dg_lo is in shared memory
    const T* hs = h_at(st % kGradStages);
    if constexpr (kBf16) {
#pragma unroll
      for (int ks = 0; ks < kGradStage / 16; ++ks) {
        unsigned bf[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned r[4];
          ldmatrix_x4_trans(r, hs + (ks * 16 + (wl & 7) + ((wl >> 3) & 1) * 8) * HS + wk * 32 +
                                   np * 16 + (wl >> 4) * 8);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          unsigned af[4];
          ldmatrix_x4_trans(af, dg_s + (ks * 16 + (wl & 7) + (wl >> 4) * 8) * HS + wc * 64 +
                                    mi * 16 + ((wl >> 3) & 1) * 8);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af, bf[ni]);
        }
      }
    } else {
      const float* hf = reinterpret_cast<const float*>(hs);
      const float* fs = f_at(st % kGradStages);
      // One K step at a time (unrolled steps' split fragments spilled at the
      // 128-register bound), and in it two units' n8 tiles at a time, each
      // m16 tile's A fragment split twice.
#pragma unroll 1
      for (int ks = 0; ks < kGradStage / 8; ++ks) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned bf[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float* bp = hf + (ks * 8 + tig) * HS + wk * 32 + (2 * np + q) * 8 + g;
            split_tf32(bp[0], bf[q][0], bf[q][2]);
            split_tf32(bp[4 * HS], bf[q][1], bf[q][3]);
          }
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            // A = dg^T: rows c, columns the stage's rows (held as [row][c]).
            const float* ap = fs + (ks * 8 + tig) * FS + wc * 64 + mi * 16 + g;
            unsigned af[8];
            split_tf32(ap[0], af[0], af[4]);
            split_tf32(ap[8], af[1], af[5]);
            split_tf32(ap[4 * FS], af[2], af[6]);
            split_tf32(ap[4 * FS + 8], af[3], af[7]);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              // The K step's products from zero, then added to the sum with a
              // rounded f32 add: the tensor cores' own accumulation, carried
              // over a chunk's thousands of rows, drifted past BWD_TOL.
              float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma_3xtf32(d, af, bf[q]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mi][2 * np + q][e] += d[e];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* out = dw_part + (size_t(lane) * parts + part) * G * H;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int cr = c0 + wc * 64 + mi * 16 + g + 8 * hh;
        const int k = k0 + wk * 32 + ni * 8 + 2 * tig;
        if (cr >= G) continue;
        if (k < H) out[size_t(cr) * H + k] = acc[mi][ni][2 * hh];
        if (k + 1 < H) out[size_t(cr) * H + k + 1] = acc[mi][ni][2 * hh + 1];
      }
  if (k0 == 0) {  // db: the two halves of each column's rows, in a fixed order
    __syncthreads();
    if (half == 1) db_x[cc] = db_sum;
    __syncthreads();
    if (half == 0 && col) db_part[(size_t(lane) * parts + part) * G + c] = db_sum + db_x[cc];
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
  const GridPlan grid = adj_grid(batch, lanes, hidden, sizeof(T));
  if (grid.ctas > 0) {
    const int resident = grid_resident_ctas(gru_adj_grid_kernel<T, Layout>, grid);
    return resident < 0 ? resident : resident / grid.ctas;
  }
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
  const GridPlan grid = adj_grid(batch, lanes, hidden, sizeof(T));
  if (grid.ctas > 0) {
    int per_sm = 0;
    const auto kernel = gru_adj_grid_kernel<T, LaneMajor>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(grid.smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, grid.threads,
                                                          size_t(grid.smem));
    return err == cudaSuccess ? per_sm : -int(err);
  }
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

// Blocks of a pass the card holds at once (blocks an SM times the SMs), or
// a negative CUDA error; it sets the kernel's shared-memory attribute.
template <typename Kernel>
int pass_capacity(Kernel kernel, int threads, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess && per_sm == 0) err = cudaErrorInvalidConfiguration;
  return err == cudaSuccess ? per_sm * kNumSMs : -int(err);
}
// Each pass's capacity, found (and its attribute set) once a process.
template <typename T, typename Layout>
int adj_gates_capacity() {
  static const int blocks = pass_capacity(gru_adj_gates_kernel<T, Layout>, kGateThreads,
                                          adj_gates_shared_bytes(sizeof(T)));
  return blocks;
}
template <typename T, typename Layout>
int adj_grad_capacity() {
  static const int blocks = pass_capacity(gru_adj_wgrad_kernel<T, Layout>, kGradThreads,
                                          adj_grad_shared_bytes(sizeof(T)));
  return blocks;
}

// The pre-pass's grid: each block keeps one lane's unit tile and takes row
// tiles blockIdx.x, + gridDim.x, ...; as many blocks as the card holds at
// once (`capacity`), split evenly over the lanes' unit tiles, at least one
// and at most one a row tile.
dim3 adj_gates_grid(int lanes, int n_steps, int batch, int hidden, int capacity) {
  const long long row_tiles = (static_cast<long long>(n_steps) * batch + kGateRows - 1) / kGateRows;
  const int unit_tiles = (hidden + kGateUnits - 1) / kGateUnits;
  long long groups = capacity / (static_cast<long long>(lanes) * unit_tiles);
  groups = groups < row_tiles ? groups : row_tiles;
  return dim3(unsigned(groups > 1 ? groups : 1), unit_tiles, lanes);
}
// The weight-gradient pass's grid: (chunk, column tile, unit tile x lanes).
dim3 adj_grad_grid(int lanes, int n_steps, int batch, int hidden) {
  return dim3(adj_partials(lanes, n_steps, batch, hidden), (3 * hidden + kGradTile - 1) / kGradTile,
              (hidden + kGradTile - 1) / kGradTile * lanes);
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
      adj_shared_bytes(hidden, sizeof(T), rows) > kMaxShared ||
      static_cast<long long>(lanes) * n_steps * batch > 0x7fffffffLL)  // rows an int
    return int(cudaErrorInvalidValue);
  const int gates_cap = adj_gates_capacity<T, Layout>();
  if (gates_cap < 0) return -gates_cap;
  const int grad_cap = adj_grad_capacity<T, Layout>();
  if (grad_cap < 0) return -grad_cap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n_rows = size_t(lanes) * n_steps * batch;
  float* fac = static_cast<float*>(workspace);
  float* dht = fac + n_rows * kFactors * hidden;
  float* dw_part = dht + n_rows * hidden;

  gru_adj_gates_kernel<T, Layout>
      <<<adj_gates_grid(lanes, n_steps, batch, hidden, gates_cap), kGateThreads,
         adj_gates_shared_bytes(sizeof(T)), s>>>(
          static_cast<const T*>(xg), static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
          static_cast<const float*>(h0), static_cast<const T*>(ys), static_cast<const T*>(dy),
          fac, n_steps, batch, hidden, reverse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  float* aux = static_cast<float*>(workspace) + adj_wt_offset(lanes, n_steps, batch, hidden);
  const GridPlan grid = adj_grid(batch, lanes, hidden, sizeof(T));
  const int e =
      grid.ctas > 0
          ? grid_launch<T>(gru_adj_grid_kernel<T, Layout>, grid, aux, s, lanes, n_steps, batch,
                           hidden, reverse, static_cast<const float*>(fac),
                           static_cast<const T*>(w_hh), dht, static_cast<float*>(dh0))
      : streamed
          ? adj_stream_walk<T, Layout>(fac, w_hh, aux, dht, dh0, lanes, n_steps, batch, hidden,
                                       reverse, s)
          : adj_walk<T, Layout>(fac, w_hh, dht, dh0, lanes, n_steps, batch, hidden, reverse, s);
  if (e != 0) return e;

  const int parts = adj_partials(lanes, n_steps, batch, hidden);
  gru_adj_wgrad_kernel<T, Layout>
      <<<adj_grad_grid(lanes, n_steps, batch, hidden), kGradThreads,
         adj_grad_shared_bytes(sizeof(T)), s>>>(
          fac, dht, static_cast<const T*>(ys), static_cast<const float*>(h0),
          static_cast<T*>(dxg), dw_part, static_cast<float*>(db_part), n_steps, batch, hidden,
          reverse, int(adj_chunk_rows(lanes, n_steps, batch, hidden)));
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

// The adjoint walk's plan for this shape, as nine numbers: the
// instantiation (0 W in registers, 1 one block, 2 the cluster walk, 3 the
// grid walk, 4 the streamed walk), the CTAs per (lane, row tile) (the grid
// walk: of a group), the row tile (the grid walk: rows of a work item), a
// CTA's units whose W^T rows are resident in shared memory and those
// streamed from device memory, the most shared bytes a block or CTA of its
// kernels takes, the floats of its workspace at T = n_steps, and for the
// grid walk the groups at once and a CTA's threads (0 otherwise).
void gru_adj_plan(int batch, int lanes, int n_steps, int hidden, int bf16, long long* out) {
  const size_t item = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const GridPlan grid = adj_grid(batch, lanes, hidden, item);
  out[7] = out[8] = 0;
  if (grid.ctas > 0) {
    out[0] = 3;
    out[1] = grid.ctas;
    out[2] = grid.rows;
    out[3] = grid.units;
    out[4] = 0;
    out[5] = grid.smem > (long long)adj_pass_shared_bytes(item) ? grid.smem
                                                          : (long long)adj_pass_shared_bytes(item);
    out[7] = grid.groups;
    out[8] = grid.threads;
  } else {
    const int rows = adj_rows(batch, lanes, hidden, item);
    if (adj_streamed(hidden, item)) {
      const int res = adj_stream_resident(hidden, item, rows);
      out[0] = 4;
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
  }
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
long long gru_adj_chunk_rows(int lanes, int n_steps, int batch, int hidden) {
  return adj_chunk_rows(lanes, n_steps, batch, hidden);
}
int gru_adj_partials(int lanes, int n_steps, int batch, int hidden) {
  return adj_partials(lanes, n_steps, batch, hidden);
}

// The two passes' launches for this shape (LaneMajor): the pre-pass's
// blocks at once on this card (its capacity), its grid (x, y, z) and shared
// bytes; the weight-gradient pass's grid, rows a chunk and shared bytes.
void gru_adj_pass_plan(int lanes, int n_steps, int batch, int hidden, int bf16, long long* out) {
  const size_t item = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const int capacity = bf16 ? adj_gates_capacity<__nv_bfloat16, LaneMajor>()
                            : adj_gates_capacity<float, LaneMajor>();
  const dim3 gates = adj_gates_grid(lanes, n_steps, batch, hidden, capacity);
  const dim3 grad = adj_grad_grid(lanes, n_steps, batch, hidden);
  const long long v[10] = {capacity, gates.x, gates.y, gates.z,
                           (long long)adj_gates_shared_bytes(item), grad.x, grad.y, grad.z,
                           adj_chunk_rows(lanes, n_steps, batch, hidden),
                           (long long)adj_grad_shared_bytes(item)};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

// Floats of the workspace an entry with `lanes` lanes takes as dw_part.
long long gru_adj_workspace_floats(int lanes, int n_steps, int batch, int hidden, int bf16) {
  return adj_workspace_floats(lanes, n_steps, batch, hidden,
                              bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
}

// Counterpart of _gru_backward: one lane, on the adjoint walk. dw_part is
// the workspace of gru_adj_workspace_floats(1, T, B, H) floats, db_part
// holds gru_adj_partials(1, T, B, H) partials of [3H] floats.
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
// F * gru_adj_partials(F, T, B, H) partials of [3H] floats.
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
// floats, db_part holds L * gru_adj_partials(L, T, B, H) partials of [3H] floats.
int gru_bibwd(const void* xg, const void* w_hh, const void* b_hh, const void* h0,
              const void* ys, const void* dy, void* dxg, void* dw, void* db, void* dh0,
              void* dw_part, void* db_part, int lanes, int n_steps, int batch, int hidden,
              void* stream) {
  return adj_launch<float, TimeMajor>(xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0, dw_part,
                                      db_part, lanes, n_steps, batch, hidden, 0, stream);
}

}  // extern "C"
