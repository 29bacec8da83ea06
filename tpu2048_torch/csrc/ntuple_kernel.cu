// The n-tuple network's kernels, for Hopper (sm_90a): the afterstate value
// of every move of every lane (afterstate_kernel), and the TD(0) update of
// the lanes' previous afterstates (td_update_kernel). They replace no TPU
// kernel: the JAX package has no n-tuple network. The port added them for
// the 4x6-tuple configuration (models/ntuple.py, agents/ntuple.py).
//
// The network: a pattern of k cells has a table of 16**k float32 weights,
// one flat array pattern after pattern; lookup l reads pattern l / 8 on the
// l % 8-th symmetry of the board, at the cells maps[l][0..k) give, and the
// index sum_j e[maps[l][j]] * 16**j of the cells' exponents clipped at 15.
// The value of a board is the sum of its n_lookups weights.
//
// afterstate_kernel, per lane: the four moves' afterstates (slid, no
// spawn), their merge rewards and legality, V of each legal afterstate
// (-inf where illegal), V of the lane's previous afterstate (0 where it has
// none), the greedy action argmax(reward + V) over the legal moves (ties to
// the lowest index, 0 where none is legal), the previous afterstate's TD
// target (0 where the previous step ended its game or no move is legal,
// else the best reward + V) and the chosen afterstate. Every value is read
// at the weights before the step.
//
// td_update_kernel, for each lane with a previous afterstate: the update
// alpha * (target - V(prev)) / n_lookups of each of its lookups. The lanes'
// updates that land on one weight in one step are averaged: summed over
// their count (counts, an int32 array the size of the weights, all zero
// between calls). A summed batch of 8,192 lanes diverges at alpha = 0.1,
// since the weights that near-empty boards read are hit by hundreds of
// lanes at once; averaged, a weight moves by at most one lane's update a
// step. One call is three launches of the kernel over the same lookups:
// phase 0 counts each weight's hits, phase 1 adds update / count to it
// (float atomics: the sum's order, and so its rounding, follows the
// schedule), phase 2 sets the counts back to zero.
//
// What bounds them: latency of dependent random gathers. A lane reads 160
// weights of 4 bytes (5 boards x 32 lookups at the 4x6 set) scattered over
// 256 MiB, 5 MiB a step at 8,192 lanes, and the update touches 32 weights a
// lane three times. Useful bytes at the HBM rate take ~2 us a step; every
// gather pulls a 32-byte sector, from HBM where the touched set outgrows the
// 50 MB L2. So each thread issues its gathers kBatch at a time before it
// sums them, and a lane has four threads (kLaneThreads), one a direction:
// thread t slides direction t with step_kernel.cu's warp-uniform merge
// (merge_dir), reads its afterstate's lookups and a quarter of the previous
// afterstate's, and the quad exchanges the sums by shuffles. The pattern
// maps are staged in shared memory as shift amounts, and a board is packed
// a nibble a cell into 64 bits, so a lookup's cells come from shifts of one
// register with run-time amounts (an array indexed at run time would live
// in local memory).

#include <math_constants.h>

#include "step_kernel.cu"

namespace {

constexpr int kLaneThreads = 4;   // a lane's threads: thread t slides t
constexpr int kNtThreads = 128;   // threads a block: 32 lanes
constexpr int kMaxLookups = 64;   // 8 patterns x 8 symmetries
constexpr int kMaxCells = 7;      // a table of at most 16**7 weights
constexpr int kBatch = 8;         // a thread's gathers issued together

// The block's copy of the maps, as shift amounts (4 x cell).
struct Maps {
  uint8_t shift[kMaxLookups][kMaxCells];
};

__device__ __forceinline__ void stage_maps(Maps& sh, const uint8_t* maps,
                                           int n, int k) {
  for (int i = threadIdx.x; i < n * k; i += blockDim.x) {
    sh.shift[i / k][i % k] = static_cast<uint8_t>(4 * maps[i]);
  }
  __syncthreads();
}

// The board's 16 exponents, clipped at 15, a nibble a cell (cell 0 lowest).
__device__ __forceinline__ uint64_t pack(const int c[16]) {
  uint64_t b = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    b |= static_cast<uint64_t>(c[i] < 15 ? c[i] : 15) << (4 * i);
  }
  return b;
}

// The flat weight index of lookup l on the packed board b.
__device__ __forceinline__ size_t lut_index(uint64_t b, const Maps& sh,
                                            int l, int k) {
  uint32_t local = 0;
  for (int j = 0; j < k; ++j) {
    local |= static_cast<uint32_t>((b >> sh.shift[l][j]) & 15u) << (4 * j);
  }
  return (static_cast<size_t>(l >> 3) << (4 * k)) + local;
}

// The sum of lookups first, first + stride, ... below n on board b.
__device__ __forceinline__ float sum_lookups(const float* __restrict__ w,
                                             uint64_t b, const Maps& sh,
                                             int first, int stride, int n,
                                             int k) {
  float acc = 0.f;
  for (int base = first; base < n; base += kBatch * stride) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int l = base + j * stride;
      v[j] = l < n ? __ldg(w + lut_index(b, sh, l, k)) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) acc += v[j];
  }
  return acc;
}

__device__ __forceinline__ void load_board(int c[16],
                                           const int8_t* __restrict__ boards,
                                           size_t B, int lane) {
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = boards[i * B + lane];
}

__global__ void __launch_bounds__(kNtThreads)
afterstate_kernel(const int8_t* __restrict__ boards,
                  const int8_t* __restrict__ prev_after,
                  const uint8_t* __restrict__ prev_valid,
                  const uint8_t* __restrict__ prev_terminal,
                  const float* __restrict__ w,
                  const uint8_t* __restrict__ maps, int n_lookups, int k,
                  int8_t* __restrict__ out_after,
                  int32_t* __restrict__ out_reward,
                  uint8_t* __restrict__ out_legal,
                  float* __restrict__ out_values,
                  float* __restrict__ out_v_prev,
                  int32_t* __restrict__ out_action,
                  float* __restrict__ out_target,
                  int8_t* __restrict__ out_chosen, int batch) {
  __shared__ Maps sh;
  stage_maps(sh, maps, n_lookups, k);
  const int gid = blockIdx.x * kNtThreads + threadIdx.x;
  const int d = gid % kLaneThreads;
  // A lane past the batch computes lane 0's values and writes nothing: the
  // quad's shuffles need all of its threads.
  const bool live = gid / kLaneThreads < batch;
  const int lane = live ? gid / kLaneThreads : 0;
  const size_t B = static_cast<size_t>(batch);

  int c[16], nc[16];
  load_board(c, boards, B, lane);
#pragma unroll
  for (int i = 0; i < 16; ++i) nc[i] = c[i];
  const int reward = merge_dir(nc, d);
  bool moved = false;
#pragma unroll
  for (int i = 0; i < 16; ++i) moved = moved || nc[i] != c[i];
  const float value = moved ? sum_lookups(w, pack(nc), sh, 0, 1, n_lookups, k)
                            : -CUDART_INF_F;

  float v_prev = 0.f;
  if (prev_valid[lane]) {  // uniform over the quad
    int p[16];
    load_board(p, prev_after, B, lane);
    v_prev = sum_lookups(w, pack(p), sh, d, kLaneThreads, n_lookups, k);
  }
  constexpr unsigned kAll = 0xffffffffu;
  v_prev += __shfl_xor_sync(kAll, v_prev, 1);
  v_prev += __shfl_xor_sync(kAll, v_prev, 2);

  // The quad's four reward + V, in direction order; the first maximum.
  const float q = moved ? static_cast<float>(reward) + value : -CUDART_INF_F;
  int action = 0;
  float best = __shfl_sync(kAll, q, 0, kLaneThreads);
#pragma unroll
  for (int a = 1; a < 4; ++a) {
    const float qa = __shfl_sync(kAll, q, a, kLaneThreads);
    if (qa > best) {
      best = qa;
      action = a;
    }
  }
  if (!live) return;
  out_reward[d * B + lane] = reward;
  out_legal[d * B + lane] = moved;
  out_values[d * B + lane] = value;
#pragma unroll
  for (int i = 0; i < 16; ++i) out_after[(d * 16 + i) * B + lane] = nc[i];
  if (d == action) {
#pragma unroll
    for (int i = 0; i < 16; ++i) out_chosen[i * B + lane] = nc[i];
  }
  if (d == 0) {
    const bool ends = prev_terminal[lane] || best == -CUDART_INF_F;
    out_v_prev[lane] = v_prev;
    out_action[lane] = action;
    out_target[lane] = ends ? 0.f : best;
  }
}

__global__ void __launch_bounds__(kNtThreads)
td_update_kernel(float* __restrict__ w, int32_t* __restrict__ counts,
                 const uint8_t* __restrict__ maps, int n_lookups, int k,
                 const int8_t* __restrict__ prev_after,
                 const uint8_t* __restrict__ prev_valid,
                 const float* __restrict__ v_prev,
                 const float* __restrict__ target, float alpha, int phase,
                 int batch) {
  __shared__ Maps sh;
  stage_maps(sh, maps, n_lookups, k);
  const int gid = blockIdx.x * kNtThreads + threadIdx.x;
  const int lane = gid / kLaneThreads;
  if (lane >= batch || !prev_valid[lane]) return;
  const size_t B = static_cast<size_t>(batch);
  int p[16];
  load_board(p, prev_after, B, lane);
  const uint64_t b = pack(p);
  const float step = alpha * (target[lane] - v_prev[lane]) / n_lookups;
  for (int l = gid % kLaneThreads; l < n_lookups; l += kLaneThreads) {
    const size_t i = lut_index(b, sh, l, k);
    if (phase == 0) {
      atomicAdd(counts + i, 1);
    } else if (phase == 1) {
      atomicAdd(w + i, step / static_cast<float>(counts[i]));
    } else {
      counts[i] = 0;
    }
  }
}

int nt_blocks(int batch) {
  return static_cast<int>(
      (static_cast<long long>(batch) * kLaneThreads + kNtThreads - 1) /
      kNtThreads);
}

bool maps_fit(int n_lookups, int k) {
  return n_lookups > 0 && n_lookups <= kMaxLookups && n_lookups % 8 == 0 &&
         k > 0 && k <= kMaxCells;
}

}  // namespace

// Launches afterstate_kernel on `stream` of device `device`. Boards are
// cell-major (16, B) int8; the outputs: after (4, 16, B) int8, reward
// (4, B) int32, legal (4, B) uint8, values (4, B) float32, v_prev, action
// (int32), target (B,) and chosen (16, B) int8. Returns the cudaError_t of
// the launch.
extern "C" int tpu2048_ntuple_value(
    const void* boards, const void* prev_after, const void* prev_valid,
    const void* prev_terminal, const void* weights, const void* maps,
    int n_lookups, int k, void* after, void* reward, void* legal,
    void* values, void* v_prev, void* action, void* target, void* chosen,
    int batch, int device, void* stream) {
  if (!maps_fit(n_lookups, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  afterstate_kernel<<<nt_blocks(batch), kNtThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(boards),
      static_cast<const int8_t*>(prev_after),
      static_cast<const uint8_t*>(prev_valid),
      static_cast<const uint8_t*>(prev_terminal),
      static_cast<const float*>(weights), static_cast<const uint8_t*>(maps),
      n_lookups, k, static_cast<int8_t*>(after),
      static_cast<int32_t*>(reward), static_cast<uint8_t*>(legal),
      static_cast<float*>(values), static_cast<float*>(v_prev),
      static_cast<int32_t*>(action), static_cast<float*>(target),
      static_cast<int8_t*>(chosen), batch);
  return static_cast<int>(cudaGetLastError());
}

// Launches the three phases of td_update_kernel on `stream` of device
// `device`: the weights (float32) updated in place, `counts` (int32, as
// many as the weights, zero on entry and on return). Returns the first
// cudaError_t of the launches.
extern "C" int tpu2048_ntuple_update(
    void* weights, void* counts, const void* maps, int n_lookups, int k,
    const void* prev_after, const void* prev_valid, const void* v_prev,
    const void* target, float alpha, int batch, int device, void* stream) {
  if (!maps_fit(n_lookups, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int phase = 0; phase < 3; ++phase) {
    td_update_kernel<<<nt_blocks(batch), kNtThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(weights), static_cast<int32_t*>(counts),
        static_cast<const uint8_t*>(maps), n_lookups, k,
        static_cast<const int8_t*>(prev_after),
        static_cast<const uint8_t*>(prev_valid),
        static_cast<const float*>(v_prev),
        static_cast<const float*>(target), alpha, phase, batch);
    const cudaError_t launch = cudaGetLastError();
    if (launch != cudaSuccess) return static_cast<int>(launch);
  }
  return 0;
}
