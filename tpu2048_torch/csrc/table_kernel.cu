// Bucket gather and bucket scatter on the packed Q-table, for Hopper (sm_90a).
//
// Replaces tpu2048/ops/table_kernel.py::_gather_kernel (out[i] =
// data[buckets[i]]) and ::_scatter_kernel (data[buckets[i]] = rows[i], in
// place). The table is (n_rows, 128) 32-bit words: one row is one bucket of
// 16 slots of 8 words, 512 bytes; the last row is the write-only trash row.
//
// What bounds them: bytes. Each row moved is 512 bytes read and 512 bytes
// written plus a 4-byte index; there is no arithmetic. The rows lie at random
// places in a table of up to 1 GiB, far beyond the 50 MB L2, so every row is
// a fresh trip to device memory, and the rate depends on how many bytes are
// in flight: at 3.35 TB/s and about a microsecond of latency, some 25 KB on
// each SM. At the tabular step's 1024 rows the cost is a chain of latencies
// instead: launch, index, load, store.
//
// Design: the TPU kernels' ring of in-flight row DMAs becomes a ring of TMA
// bulk copies (cp.async.bulk, no tensor map: a row is one contiguous,
// 16-byte aligned 512-byte piece). Each warp of a block owns a ring of
// kStages stages of kRows rows in dynamic shared memory, with one mbarrier
// a stage. Chunk c of the batch is rows [c * kRows, c * kRows + kRows). A
// persistent grid of at most kMaxBlocks blocks (two on each of the H100's
// 132 SMs, so kWarps * 2 rings an SM) walks the chunks: ring r takes chunks
// r, r + rings, ... and puts its k-th into stage k % kStages. Loads go
// global -> shared and complete on the stage's mbarrier (expect_tx of the
// chunk's bytes); stores go shared -> global as bulk groups. A stage is
// refilled one chunk late: after the store of chunk k is issued, the stage
// of chunk k - 1 is reloaded once that store has read it (wait_group.read
// 1), so kStages - 1 loads of each ring stay in flight while its warp
// waits. Each index is read a chunk or more ahead of its use, so its
// latency hides behind a wait as well (the TPU's scalar prefetch of the
// indices). One lane issues a chunk's contiguous copy; lane j issues row j's.
//
// - Gather: lane j reads index j and issues the 512-byte load of that row
//   into slot j; the chunk then leaves as one contiguous store of
//   rows * 512 bytes into out.
// - Scatter: the chunk's source rows are contiguous, so they arrive as one
//   load of rows * 512 bytes; lane j then stores slot j to its bucket row.
//
// The geometry was chosen on the card among rings of 2-8 stages of 4-32
// rows and 1-8 rings a block: many small rings beat few deep ones.
//
// A bulk copy without a tensor map has no bounds check, so the guards come
// before the copy: the gather clamps an index into the real rows
// [0, n_rows - 1), the scatter issues no copy for an index outside
// [0, n_rows). (The callers' indices come from the hash and are always in
// range; the plain versions raise on such an index.) The scatter's buckets
// are distinct except for the trash row, which several lanes and blocks may
// bulk-store at once, their 16-byte pieces in any mix. The row is never
// read, so that is allowed.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// The launch geometry; tpu2048_torch/ops/table_kernel.py::launch_geometry
// mirrors these constants (a test reads them from this file).
constexpr int kWarps = 4;      // warps a block, each with a ring of its own
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;       // rows a stage: lanes [0, kRows) copy
constexpr int kStages = 3;     // stages in a ring
constexpr int kMaxBlocks = 264;  // two blocks on each of 132 SMs
constexpr int kRowWords = 128;
constexpr int kRowBytes = kRowWords * 4;
constexpr int kStageBytes = kRows * kRowBytes;
// The warps' rings, then one 8-byte mbarrier a stage of each ring.
constexpr int kSharedBytes = kWarps * kStages * (kStageBytes + 8);
static_assert(kRows <= 32, "a lane of the ring's warp a row");
static_assert(kStageBytes % 16 == 0, "bulk copies need 16-byte alignment");
static_assert(kSharedBytes <= 232448, "a block has at most 227 KB");
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

// The one arrival of a phase, which then waits for `bytes` of copies.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void load_bulk(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void store_bulk(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void commit_stores() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// This thread's store groups but the newest have read their shared memory.
__device__ __forceinline__ void wait_stores_read_but_newest() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

// This thread's store groups are complete.
__device__ __forceinline__ void wait_stores() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// A warp's ring: its stages, their barriers, and its walk of the chunks.
// Ring r = warp * gridDim.x + blockIdx.x takes chunks r, r + rings, ...
// (rings = gridDim.x * kWarps), so that a small batch spreads over the
// blocks' first warps, one block on each SM.
struct Ring {
  uint32_t ring;  // shared address of stage 0
  uint32_t bars;  // shared address of stage 0's mbarrier
  long long id;   // the ring's number
  long long rings;
  int n;          // chunks of this ring
  int batch;

  __device__ Ring(unsigned char* smem, int batch_) : batch(batch_) {
    const int warp = threadIdx.x / 32;
    ring = shared_addr(smem) + warp * kStages * kStageBytes;
    bars = shared_addr(smem) + kWarps * kStages * kStageBytes +
           warp * kStages * 8;
    id = static_cast<long long>(warp) * gridDim.x + blockIdx.x;
    rings = static_cast<long long>(gridDim.x) * kWarps;
    const long long chunks = (batch + kRows - 1) / kRows;
    n = id < chunks ? static_cast<int>((chunks - id + rings - 1) / rings) : 0;
  }
  // Sets up the barriers of every ring of the block; each warp issues its
  // first index reads before it, so that their latency covers it.
  __device__ void init() const {
    if (threadIdx.x % 32 == 0) {
      for (int s = 0; s < kStages; ++s) bar_init(bars + 8 * s);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  // First row of the ring's k-th chunk, and its rows (the last is ragged).
  __device__ long long first(int k) const {
    return (id + static_cast<long long>(k) * rings) * kRows;
  }
  __device__ int rows(int k) const {
    const long long left = batch - first(k);
    return left < kRows ? static_cast<int>(left) : kRows;
  }
  __device__ uint32_t stage(int k) const {
    return ring + (k % kStages) * kStageBytes;
  }
  __device__ uint32_t bar(int k) const { return bars + 8 * (k % kStages); }
  // Waits for the ring's k-th chunk to arrive in its stage.
  __device__ void wait(int k) const { bar_wait(bar(k), (k / kStages) & 1); }
};

__global__ void __launch_bounds__(kThreads)
gather_kernel(const int32_t* __restrict__ data,
              const int32_t* __restrict__ buckets, int32_t* __restrict__ out,
              long long n_rows, int batch) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring r(smem, batch);
  const int lane = threadIdx.x % 32;
  const long long last_real = n_rows - 2;
  // This lane's bucket row in the ring's k-th chunk; 0 past the batch.
  auto index = [&](int k) -> long long {
    if (k >= r.n || lane >= r.rows(k)) return 0;
    return __ldg(buckets + r.first(k) + lane);
  };
  // Loads the ring's k-th chunk; `row` is clamped into the real rows.
  auto load = [&](int k, long long row) {
    const int rows = r.rows(k);
    if (lane == 0) bar_expect(r.bar(k), rows * kRowBytes);
    __syncwarp();
    if (lane < rows) {
      row = row < 0 ? 0 : (row > last_real ? last_real : row);
      load_bulk(r.stage(k) + lane * kRowBytes, data + row * kRowWords,
                kRowBytes, r.bar(k));
    }
  };

  long long head[kStages];
#pragma unroll
  for (int k = 0; k < kStages; ++k) head[k] = index(k);
  r.init();
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    if (k < r.n) load(k, head[k]);
  }
  long long pending = index(kStages);  // the refill of iteration 1
  for (int k = 0; k < r.n; ++k) {
    // The refill of iteration k + 1, read while this iteration waits.
    const long long ahead = k >= 1 ? index(k + kStages) : pending;
    r.wait(k);
    if (lane == 0) {
      store_bulk(out + r.first(k) * kRowWords, r.stage(k),
                 r.rows(k) * kRowBytes);
      commit_stores();
    }
    const int refill = k - 1 + kStages;
    if (k >= 1 && refill < r.n) {
      if (lane == 0) wait_stores_read_but_newest();
      __syncwarp();
      load(refill, pending);
    }
    pending = ahead;
  }
  wait_stores();
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(int32_t* __restrict__ data,
               const int32_t* __restrict__ buckets,
               const int32_t* __restrict__ rows, long long n_rows,
               int batch) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring r(smem, batch);
  const int lane = threadIdx.x % 32;
  // This lane's bucket row in the ring's k-th chunk; -1 past the batch.
  auto index = [&](int k) -> long long {
    if (k >= r.n || lane >= r.rows(k)) return -1;
    return __ldg(buckets + r.first(k) + lane);
  };
  auto load = [&](int k) {
    if (lane == 0) {
      const uint32_t bytes = r.rows(k) * kRowBytes;
      bar_expect(r.bar(k), bytes);
      load_bulk(r.stage(k), rows + r.first(k) * kRowWords, bytes, r.bar(k));
    }
  };

  long long row = index(0);
  r.init();
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    if (k < r.n) load(k);
  }
  for (int k = 0; k < r.n; ++k) {
    const long long next = index(k + 1);  // read while this chunk waits
    r.wait(k);
    if (row >= 0 && row < n_rows) {
      store_bulk(data + row * kRowWords, r.stage(k) + lane * kRowBytes,
                 kRowBytes);
    }
    commit_stores();  // one group a chunk on every lane, empty or not
    const int refill = k - 1 + kStages;
    if (k >= 1 && refill < r.n) {
      wait_stores_read_but_newest();
      __syncwarp();
      load(refill);
    }
    row = next;
  }
  wait_stores();
}

int blocks_for(int batch) {
  const int chunks = (batch + kRows - 1) / kRows;
  return chunks < kMaxBlocks ? chunks : kMaxBlocks;
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

// Makes `device` current and lets `kernel` use kSharedBytes of shared memory,
// above the 48 KB a launch gets without asking (once a device: the attribute
// stays set).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int device, bool* opted_in) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSharedBytes);
    opted_in[device] = err == cudaSuccess;
  }
  return err;
}

bool gather_opted_in[kMaxDevices];
bool scatter_opted_in[kMaxDevices];

}  // namespace

// out (batch, 128) <- data[buckets] on `stream` (a cudaStream_t) of device
// `device`. data is (n_rows, 128) with n_rows >= 2, batch >= 1; data and
// out are 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int tpu2048_bucket_gather(const void* data, const void* buckets,
                                     void* out, long long n_rows, int batch,
                                     int device, void* stream) {
  cudaError_t err = prepare(gather_kernel, device, gather_opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_kernel<<<blocks_for(batch), kThreads, kSharedBytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(data), static_cast<const int32_t*>(buckets),
      static_cast<int32_t*>(out), n_rows, batch);
  return static_cast<int>(cudaGetLastError());
}

// data[buckets] <- rows (batch, 128), in place, on `stream` of `device`.
// data and rows are 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int tpu2048_bucket_scatter(void* data, const void* buckets,
                                      const void* rows, long long n_rows,
                                      int batch, int device, void* stream) {
  cudaError_t err = prepare(scatter_kernel, device, scatter_opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<blocks_for(batch), kThreads, kSharedBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(data), static_cast<const int32_t*>(buckets),
      static_cast<const int32_t*>(rows), n_rows, batch);
  return static_cast<int>(cudaGetLastError());
}
