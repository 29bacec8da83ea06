// Bucket gather and bucket scatter on the packed Q-table, for Hopper (sm_90a).
//
// Replaces tpu2048/ops/table_kernel.py::_gather_kernel (out[i] =
// data[buckets[i]]) and ::_scatter_kernel (data[buckets[i]] = rows[i], in
// place). The table is (n_rows, 128) 32-bit words: one row is one bucket of
// 16 slots of 8 words, 512 bytes; the last row is the write-only trash row.
//
// What bounds them: bytes. Each row moved is 512 bytes read and 512 bytes
// written plus a 4-byte index; there is no arithmetic. The rows are at random
// places in a table of up to 1 GiB, far beyond the 50 MB L2, so every row is a
// fresh trip to device memory. At the tabular train step's batch (1024 rows,
// about 1 MB each way) the launch latency and one round trip of memory
// latency are the cost, not the bandwidth.
//
// Design: one warp per row, each lane moving 16 bytes (a uint4), so the 32
// lanes of a warp move the 512-byte row in one coalesced load and one
// coalesced store. 256 threads (8 warps) a block and a grid-stride loop over
// the batch. The TPU kernels' ring of in-flight DMA copies has no counterpart:
// the many resident warps keep many rows in flight. An index outside the
// table cannot touch memory outside it: the gather clamps it into the real
// rows [0, n_rows - 1), the scatter skips it. (The callers' indices come from
// the hash and are always in range; the plain versions raise on such an
// index.)
//
// The scatter's buckets are distinct except for the trash row, which several
// warps may write at once, so its 16-byte pieces may mix images. The row is
// never read, so that is allowed.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kRowVecs = 128 / 4;  // uint4 pieces in a row: one per lane
constexpr int kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint4* __restrict__ data,
              const int32_t* __restrict__ buckets, uint4* __restrict__ out,
              long long n_rows, int batch) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarpsPerBlock;
  const long long last_real = n_rows - 2;
  for (int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); i < batch;
       i += warps) {
    long long row = __ldg(buckets + i);
    row = row < 0 ? 0 : (row > last_real ? last_real : row);
    out[static_cast<long long>(i) * kRowVecs + lane] =
        data[row * kRowVecs + lane];
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(uint4* __restrict__ data, const int32_t* __restrict__ buckets,
               const uint4* __restrict__ rows, long long n_rows, int batch) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarpsPerBlock;
  for (int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); i < batch;
       i += warps) {
    const long long row = __ldg(buckets + i);
    if (row < 0 || row >= n_rows) continue;
    data[row * kRowVecs + lane] =
        rows[static_cast<long long>(i) * kRowVecs + lane];
  }
}

int blocks_for(int batch) {
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

}  // namespace

// out (batch, 128) <- data[buckets] on `stream` (a cudaStream_t) of device
// `device`. data is (n_rows, 128) with n_rows >= 2. Returns the cudaError_t
// of the launch.
extern "C" int tpu2048_bucket_gather(const void* data, const void* buckets,
                                     void* out, long long n_rows, int batch,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_kernel<<<blocks_for(batch), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(data), static_cast<const int32_t*>(buckets),
      static_cast<uint4*>(out), n_rows, batch);
  return static_cast<int>(cudaGetLastError());
}

// data[buckets] <- rows (batch, 128), in place, on `stream` of `device`.
// Returns the cudaError_t of the launch.
extern "C" int tpu2048_bucket_scatter(void* data, const void* buckets,
                                      const void* rows, long long n_rows,
                                      int batch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<blocks_for(batch), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(data), static_cast<const int32_t*>(buckets),
      static_cast<const uint4*>(rows), n_rows, batch);
  return static_cast<int>(cudaGetLastError());
}
