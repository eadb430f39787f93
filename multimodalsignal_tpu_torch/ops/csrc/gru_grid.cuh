// The grid walks' shared plan and primitives, for gru_walk_grid_kernel
// (gru_fwd.cu) and gru_adj_grid_kernel (gru_bwd.cu); the notes at the top of
// those files describe the design. Included inside each file's anonymous
// namespace, after its kNumSMs, kMaxShared and align16.
//
// The plan: a group of `ctas` CTAs, one an SM, walks one work item (a lane
// and up to kGridItemRows batch rows) at a time; `groups` groups run at once
// and take the items in turn. CTA `rank` owns `units` hidden units and keeps
// their rows of W (the forward: [3][units][kx + pad]; the adjoint: W^T, the
// units in pairs, [pairs x 2][kx + pad]) in shared memory for the whole
// item, beside f32 [rows][units] (the forward's carry, the adjoint's dht z)
// and a ring of `stages` tiles [pass_rows][kt + pad] of the exchanged state
// (h, K = H, or dg_lo, K = 3H), whose exchange buffers in device memory are
// [groups][2 parity][rows][kx], kx = K padded to kt. f32 products run on
// CUDA cores, bf16 ones on the tensor cores (ldmatrix / mma.sync below).

// The K tiles a plan may take (the wider preferred: fewer tiles, so fewer
// barriers a step), elements past every shared row (they spread a warp's
// loads over the banks), the least and the most tiles in the cp.async ring,
// sub-lanes splitting K, batch rows a thread, the most batch rows of one
// work item; and what the entries return when the card cannot hold a plan's
// groups at once.
constexpr int kGridKTs[2] = {128, 64};
constexpr int kGridPad = 16;
constexpr int kGridMinStages = 3;
constexpr int kGridMaxStages = 8;
constexpr int kGridSub = 8;
constexpr int kGridRows = 8;
constexpr int kGridItemRows = 64;
constexpr int kNoGroup = -2;
// Hidden units a thread sums: one (three gate rows) forward, a pair adjoint.
__host__ __device__ constexpr int grid_thread_units(bool adjoint) { return adjoint ? 2 : 1; }
// The most threads of a CTA, its launch bound: the adjoint's holds the next
// step's factors across the K loop, and spills at 512 threads' 128 registers.
__host__ __device__ constexpr int grid_max_threads(bool adjoint) { return adjoint ? 384 : 512; }

struct GridPlan {
  int ctas;
  int groups;
  int units;
  int rows;
  int pass_rows;
  int kt;
  int stages;
  int threads;
  long long smem;
  long long exchange;
};
// K of the exchanged state padded to whole tiles.
__host__ __device__ constexpr int grid_kx(int k, int kt) { return (k + kt - 1) / kt * kt; }
__host__ __device__ constexpr int grid_k(int hidden, bool adjoint) {
  return adjoint ? 3 * hidden : hidden;
}

// A CTA owning `units` units for work items of `rows` rows and K tiles of
// kt: its threads (kGridSub a (group of grid_thread_units units, group of
// kGridRows rows), whole warps, at most grid_max_threads; 0 where not even one
// row group fits), the rows of a pass, the tiles of its ring and its shared
// bytes: W's rows and the f32 [rows][units], each padded to 16 bytes, then
// as many tiles as fit, at most kGridMaxStages (the bytes count
// kGridMinStages where fewer fit, which grid_fits refuses).
struct GridCta {
  int threads;
  int pass_rows;
  int stages;
  size_t smem;
};
inline GridCta grid_cta(int hidden, size_t itemsize, int rows, int units, int kt, bool adjoint) {
  GridCta c = {0, 0, 0, 0};
  const int thread_units = (units + grid_thread_units(adjoint) - 1) / grid_thread_units(adjoint);
  const int per_group = kGridSub * thread_units;
  int groups = (rows + kGridRows - 1) / kGridRows;
  if (groups > grid_max_threads(adjoint) / per_group) groups = grid_max_threads(adjoint) / per_group;
  if (groups < 1) return c;
  c.threads = (per_group * groups + 31) / 32 * 32;
  c.pass_rows = kGridRows * groups;
  const size_t w_rows = adjoint ? size_t(thread_units) * 2 : size_t(3) * units;
  const size_t fixed =
      align16(w_rows * (grid_kx(grid_k(hidden, adjoint), kt) + kGridPad) * itemsize) +
      align16(size_t(rows) * units * sizeof(float));
  const size_t stage = size_t(c.pass_rows) * (kt + kGridPad) * itemsize;
  const size_t room = fixed < kMaxShared ? (kMaxShared - fixed) / stage : 0;
  c.stages = static_cast<int>(room < kGridMaxStages ? room : kGridMaxStages);
  c.smem = fixed + size_t(c.stages < kGridMinStages ? kGridMinStages : c.stages) * stage;
  return c;
}
inline bool grid_fits(const GridCta& c) {
  return c.threads > 0 && c.stages >= kGridMinStages && c.smem <= kMaxShared;
}

// The plan with K tiles of kt: the least group whose CTAs' share of one
// lane's W fits gives the most groups the card holds at once (at most the
// work items: lanes x row groups of at most kGridItemRows rows); the groups
// then spread over the card, each CTA owning as few units as that leaves;
// ctas is 0 where not even a group of kNumSMs CTAs holds one lane's W.
inline GridPlan grid_plan_kt(int batch, int lanes, int hidden, size_t itemsize, int kt,
                             bool adjoint) {
  GridPlan p = {};
  if (batch < 1 || lanes < 1) return p;
  const int rows = batch < kGridItemRows ? batch : kGridItemRows;
  const long long items = static_cast<long long>(lanes) * ((batch + rows - 1) / rows);
  int least = 0;
  for (int g = 1; g <= kNumSMs && least == 0; ++g)
    if (grid_fits(grid_cta(hidden, itemsize, rows, (hidden + g - 1) / g, kt, adjoint))) least = g;
  if (least == 0) return p;
  const int groups = static_cast<int>(items < kNumSMs / least ? items : kNumSMs / least);
  int units = (hidden + kNumSMs / groups - 1) / (kNumSMs / groups);
  GridCta c = grid_cta(hidden, itemsize, rows, units, kt, adjoint);
  if (!grid_fits(c)) {
    units = (hidden + least - 1) / least;
    c = grid_cta(hidden, itemsize, rows, units, kt, adjoint);
  }
  p.ctas = (hidden + units - 1) / units;
  p.groups = groups;
  p.units = units;
  p.rows = rows;
  p.pass_rows = c.pass_rows;
  p.kt = kt;
  p.stages = c.stages;
  p.threads = c.threads;
  p.smem = static_cast<long long>(c.smem);
  p.exchange = static_cast<long long>(groups) * 2 * rows * grid_kx(grid_k(hidden, adjoint), kt);
  return p;
}
// Rounds of work items a plan's groups take.
inline long long grid_rounds(const GridPlan& p, int batch, int lanes) {
  const long long items = static_cast<long long>(lanes) * ((batch + p.rows - 1) / p.rows);
  return (items + p.groups - 1) / p.groups;
}
// The plan with the wider K tile unless the narrower one takes the shape in
// fewer rounds or the wider one does not take it at all.
inline GridPlan grid_plan(int batch, int lanes, int hidden, size_t itemsize, bool adjoint) {
  const GridPlan wide = grid_plan_kt(batch, lanes, hidden, itemsize, kGridKTs[0], adjoint);
  const GridPlan narrow = grid_plan_kt(batch, lanes, hidden, itemsize, kGridKTs[1], adjoint);
  if (wide.ctas == 0) return narrow;
  if (narrow.ctas == 0) return wide;
  return grid_rounds(wide, batch, lanes) <= grid_rounds(narrow, batch, lanes) ? wide : narrow;
}
// Bytes of a grid walk's workspace: the exchange buffers, then a counter a
// group, each from a 16-byte boundary.
inline size_t grid_workspace_bytes(const GridPlan& p, size_t itemsize) {
  return align16(size_t(p.exchange) * itemsize) + align16(size_t(p.groups) * sizeof(unsigned));
}

// 16 bytes from device into shared memory with cp.async at L2 (.cg: the
// source was written by other SMs this step), zeros where `valid` is false;
// the ring's commit and waits (the count of groups left in flight is an
// immediate of the instruction: kGridMaxStages - 2 at most).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<0>(); break;
  }
}
__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// The group barrier: every thread of the CTA, then its thread 0 adds one to
// the group's counter after a fence (release) and reads it with acquire
// loads until all `target` arrivals are in, as a grid-wide barrier does.
__device__ __forceinline__ void group_sync(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (ld_acquire_gpu(counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// bf16 products on the tensor cores: ldmatrix of 8x8 b16 tiles from shared
// memory (lane l gives the address of row l % 8 of matrix l / 8) and
// mma.sync m16n8k16 with f32 sums, d += a b (a: 16 rows x 16 k, row major;
// b: 16 k x 8 columns, given as 8 rows of 16 k).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16_16816(float* d, const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Blocks of a grid kernel the card holds at once (blocks an SM times the
// SMs), or a negative CUDA error.
template <typename Kernel>
int grid_resident_ctas(Kernel kernel, const GridPlan& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(p.smem));
  int per_sm = 0, device = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.threads, size_t(p.smem));
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return err == cudaSuccess ? per_sm * sms : -int(err);
}

// A grid kernel's launch: refused (kNoGroup) before it is made when the card
// cannot hold every CTA of the plan's groups at once; otherwise the exchange
// buffers and counters at `ws` (in elements of T) are zeroed and the kernel
// is launched cooperatively (the runtime admits it only with all its blocks
// resident, so no group barrier can wait on a CTA that is not running), its
// arguments followed by the exchange, the counters and the plan.
template <typename T, typename Kernel, typename... Args>
int grid_launch(Kernel kernel, const GridPlan& p, void* ws, cudaStream_t stream, int lanes,
                int n_steps, int batch, int hidden, int reverse, Args... args) {
  const int resident = grid_resident_ctas(kernel, p);
  if (resident < 0) return -resident;
  if (resident < p.ctas * p.groups) return kNoGroup;
  cudaError_t err = cudaMemsetAsync(ws, 0, grid_workspace_bytes(p, sizeof(T)), stream);
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas * p.groups);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = size_t(p.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  unsigned* counters = reinterpret_cast<unsigned*>(static_cast<unsigned char*>(ws) +
                                                   align16(size_t(p.exchange) * sizeof(T)));
  err = cudaLaunchKernelEx(&cfg, kernel, args..., static_cast<T*>(ws), counters, lanes, n_steps,
                           batch, hidden, reverse, p);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
