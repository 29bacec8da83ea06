// Depth-D expectimax over the n-tuple network, for Hopper (sm_90a): the
// chance-node search that the published n-tuple agents play under (Yeh et
// al., arXiv:1606.07374; Jaskowski, IEEE ToG 2018). It replaces no TPU
// kernel: the JAX package has no n-tuple network. The port added it for the
// 4x6-tuple network played by search (agents/ntuple.py::expectimax_actions).
//
// The tree, exact, with no pruning, probability cut-off or transposition
// table. V is the network's afterstate value, r(s, a) a move's merge score,
// and a spawn puts exponent 1 (a 2) with p = 0.9 or exponent 2 (a 4) with
// p = 0.1 (step_kernel.cu's tile_value) on an empty cell drawn uniformly:
//   M_k(s) = max over legal a of r(s, a) + C_k(after(s, a)), 0 where no move
//            is legal;
//   C_k(b) = V(b) at k = D, else the sum over the n empty cells e of b and
//            t in {1, 2} of (p_t / n) * M_{k+1}(b with t at e).
// The root's values are r + C_1 of its four moves (-inf where illegal) and
// its action the first maximum (0 where no move is legal). D = 1 is the
// greedy policy, which eval plays through afterstate_kernel; these kernels
// take D = 2 and 3.
//
// Layout of one search (depth D in [2, 3]), two launches:
// - expectimax_unit_kernel: a unit is one first-level chance child s2, the
//   board after root move a1 and a spawn (child j1 in [0, kChildren): tile
//   j1 % 2 + 1 on the (j1 / 2)-th empty cell). A warp computes M_2(s2) and
//   writes it to the scratch, (4 * kChildren, B) float32: scratch is sized
//   by the roots and their first-level children, never by leaves. At D = 2
//   lanes 0-3 take one move of s2 each. At D = 3 the warp lists s2's
//   second-level chance children s3 over its legal moves (up to 4 x 30),
//   32 at a time, a lane each: the lane computes M_3(s3), the max over the
//   moves of s3 of r + V (up to 4 leaves), and the warp sums each move's
//   children weighted by p_t / n with shuffles. A unit that does not exist
//   (illegal a1, or j1 past the afterstate's empty cells) does nothing.
// - expectimax_root_kernel: a thread a root; C_1 from the scratch, the four
//   values and the action.
//
// The leaves: every legal move of a max node at depth D is one afterstate
// valued by V (32 lookups at the 4x6 set), counted into a device int64
// counter by one atomic add a block.
//
// What bounds it: a D = 3 tree has up to 4 x 30 x 4 x 30 x 4 = 57,600
// leaves, so a 512-root step values up to ~30M afterstates, each a move
// (step_kernel.cu's merge_dir) and 32 lookups (ntuple_kernel.cu's
// lut_index and sum_lookups: a few integer operations a cell, and a random
// 4-byte gather into the table). The touched part of a trained table fits
// the 50 MB L2, so the leaves' integer work and the gathers' latency bound
// it; the lanes keep sum_lookups' kBatch gathers in flight and the warps
// of an SM hide the rest. Sibling leaves share most of their lookups,
// which the kernel reads again (from L1 or L2).

#include "ntuple_kernel.cu"

namespace {

constexpr int kChildren = 30;        // a chance node's children, at most
constexpr int kUnitWarps = 4;        // units a block: one a warp
constexpr int kUnitThreads = 32 * kUnitWarps;
constexpr int kRootThreads = 128;    // roots a block
constexpr int kMinDepth = 2;
constexpr int kMaxDepth = 3;
constexpr float kP2 = 0.9f;          // a spawned 2 (exponent 1)
constexpr float kP4 = 0.1f;          // a spawned 4 (exponent 2)
constexpr unsigned kWarp = 0xffffffffu;

__device__ __forceinline__ int empties(const int c[16]) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) n += c[i] == 0;
  return n;
}

// Exponent t on the e-th empty cell (row-major) of c, in place.
__device__ __forceinline__ void spawn_nth(int c[16], int e, int t) {
  int seen = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const bool empty = c[i] == 0;
    if (empty && seen == e) c[i] = t;
    seen += empty;
  }
}

// Chance child j of a node with n empty cells: its spawn's probability
// over n.
__device__ __forceinline__ float child_weight(int j, int n) {
  return ((j & 1) ? kP4 : kP2) / static_cast<float>(n);
}

// Board c moved in direction d into nc: returns the merge score; *moved
// says whether the move changed the board.
__device__ __forceinline__ int move_to(const int c[16], int nc[16], int d,
                                       bool* moved) {
#pragma unroll
  for (int i = 0; i < 16; ++i) nc[i] = c[i];
  const int reward = merge_dir(nc, d);
  bool any = false;
#pragma unroll
  for (int i = 0; i < 16; ++i) any = any || nc[i] != c[i];
  *moved = any;
  return reward;
}

// M at the last max layer: the first maximum over the legal moves of c of
// reward + V(after), 0 where none is legal; *leaves counts the legal
// moves.
__device__ __forceinline__ float max_leaf(const int c[16],
                                          const float* __restrict__ w,
                                          const Maps& sh, int n, int k,
                                          int* leaves) {
  float best = -CUDART_INF_F;
  for (int d = 0; d < 4; ++d) {
    int nc[16];
    bool moved;
    const int reward = move_to(c, nc, d, &moved);
    if (moved) {
      const float q = static_cast<float>(reward) +
                      sum_lookups(w, pack(nc), sh, 0, 1, n, k);
      if (q > best) best = q;
      ++*leaves;
    }
  }
  return best == -CUDART_INF_F ? 0.f : best;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kWarp, x, o);
  return x;
}

// Adds the block's count to the counter: one atomic add a block (none
// where the block counted nothing). Every thread of the block calls it.
__device__ __forceinline__ void count_block(unsigned long long* counter,
                                            unsigned count) {
  __shared__ unsigned long long total;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  count = __reduce_add_sync(kWarp, count);
  if (threadIdx.x % 32 == 0 && count) {
    atomicAdd(&total, static_cast<unsigned long long>(count));
  }
  __syncthreads();
  if (threadIdx.x == 0 && total) atomicAdd(counter, total);
}

__global__ void __launch_bounds__(kUnitThreads)
expectimax_unit_kernel(const int8_t* __restrict__ boards,
                       const float* __restrict__ w,
                       const uint8_t* __restrict__ maps, int n_lookups, int k,
                       int depth, float* __restrict__ scratch,
                       unsigned long long* __restrict__ leaves, int batch) {
  __shared__ Maps sh;
  stage_maps(sh, maps, n_lookups, k);
  const int lane = threadIdx.x % 32;
  const long long unit =
      static_cast<long long>(blockIdx.x) * kUnitWarps + threadIdx.x / 32;
  const int j1 = static_cast<int>(unit % kChildren);
  const int a1 = static_cast<int>(unit / kChildren % 4);
  const int root = static_cast<int>(unit / (4 * kChildren));
  const size_t B = static_cast<size_t>(batch);
  int count = 0;  // this lane's leaves

  // The unit's board s2, uniform over the warp.
  int s2[16];
  bool live = root < batch;
  if (live) {
    int c[16];
    load_board(c, boards, B, root);
    move_to(c, s2, a1, &live);
    const int n1 = empties(s2);
    live = live && (j1 >> 1) < n1;
    if (live) spawn_nth(s2, j1 >> 1, (j1 & 1) + 1);
  }
  if (live && depth == 2) {
    // Lane d < 4 values move d of s2; the warp takes the first maximum.
    float q = -CUDART_INF_F;
    if (lane < 4) {
      int nc[16];
      bool moved;
      const int reward = move_to(s2, nc, lane, &moved);
      if (moved) {
        q = static_cast<float>(reward) +
            sum_lookups(w, pack(nc), sh, 0, 1, n_lookups, k);
        ++count;
      }
    }
    float best = __shfl_sync(kWarp, q, 0);
#pragma unroll
    for (int a = 1; a < 4; ++a) {
      const float qa = __shfl_sync(kWarp, q, a);
      if (qa > best) best = qa;
    }
    if (lane == 0) {
      scratch[(a1 * kChildren + j1) * B + root] =
          best == -CUDART_INF_F ? 0.f : best;
    }
  } else if (live) {
    // The moves of s2: reward, children (2 a legal move's empty cell) and
    // where each move's children start in the warp's list.
    int reward2[4], n2[4], first[5];
    first[0] = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      int nc[16];
      bool moved;
      reward2[d] = move_to(s2, nc, d, &moved);
      n2[d] = empties(nc);
      first[d + 1] = first[d] + (moved ? 2 * n2[d] : 0);
    }
    float chance[4] = {0.f, 0.f, 0.f, 0.f};
    for (int base = 0; base < first[4]; base += 32) {
      const int i = base + lane;
      int d = 0;
#pragma unroll
      for (int a = 1; a < 4; ++a) d += i >= first[a];
      float x = 0.f;
      if (i < first[4]) {
        int s3[16];
        bool moved;
        move_to(s2, s3, d, &moved);
        const int j = i - by_dir(d, first[0], first[1], first[2], first[3]);
        spawn_nth(s3, j >> 1, (j & 1) + 1);
        const int n = by_dir(d, n2[0], n2[1], n2[2], n2[3]);
        x = child_weight(j, n) * max_leaf(s3, w, sh, n_lookups, k, &count);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        chance[a] += warp_sum(d == a ? x : 0.f);
      }
    }
    if (lane == 0) {
      float best = -CUDART_INF_F;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (first[a + 1] > first[a]) {
          const float q = static_cast<float>(reward2[a]) + chance[a];
          if (q > best) best = q;
        }
      }
      scratch[(a1 * kChildren + j1) * B + root] =
          best == -CUDART_INF_F ? 0.f : best;
    }
  }
  count_block(leaves, static_cast<unsigned>(count));
}

__global__ void __launch_bounds__(kRootThreads)
expectimax_root_kernel(const int8_t* __restrict__ boards,
                       const float* __restrict__ scratch,
                       float* __restrict__ out_values,
                       int32_t* __restrict__ out_action, int batch) {
  const int root = blockIdx.x * kRootThreads + threadIdx.x;
  if (root >= batch) return;
  const size_t B = static_cast<size_t>(batch);
  int c[16];
  load_board(c, boards, B, root);
  float best = -CUDART_INF_F;
  int action = 0;
  for (int a = 0; a < 4; ++a) {
    int nc[16];
    bool moved;
    const int reward = move_to(c, nc, a, &moved);
    float q = -CUDART_INF_F;
    if (moved) {
      const int n = empties(nc);
      float chance = 0.f;
      const float* child = scratch + a * kChildren * B + root;
      for (int j = 0; j < 2 * n; ++j) {
        chance += child_weight(j, n) * child[j * B];
      }
      q = static_cast<float>(reward) + chance;
    }
    out_values[a * B + root] = q;
    if (q > best) {
      best = q;
      action = a;
    }
  }
  out_action[root] = action;
}

}  // namespace

// Runs one search of depth 2 or 3 on `stream` of device `device`: boards
// cell-major (16, B) int8; scratch (4 * 30, B) float32; values (4, B)
// float32 and action (B,) int32 out; `leaves` one uint64 that the search
// adds its leaves to. Returns the first cudaError_t of the launches.
extern "C" int tpu2048_ntuple_search(const void* boards, const void* weights,
                                     const void* maps, int n_lookups, int k,
                                     int depth, void* scratch, void* values,
                                     void* action, void* leaves, int batch,
                                     int device, void* stream) {
  if (!maps_fit(n_lookups, k) || depth < kMinDepth || depth > kMaxDepth ||
      batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* b = static_cast<const int8_t*>(boards);
  const float* w = static_cast<const float*>(weights);
  const uint8_t* m = static_cast<const uint8_t*>(maps);
  unsigned long long* n = static_cast<unsigned long long*>(leaves);
  const long long units = static_cast<long long>(batch) * 4 * kChildren;
  float* child = static_cast<float*>(scratch);
  expectimax_unit_kernel<<<static_cast<int>(units / kUnitWarps), kUnitThreads,
                           0, s>>>(b, w, m, n_lookups, k, depth, child, n,
                                   batch);
  const cudaError_t launch = cudaGetLastError();
  if (launch != cudaSuccess) return static_cast<int>(launch);
  expectimax_root_kernel<<<(batch + kRootThreads - 1) / kRootThreads,
                           kRootThreads, 0, s>>>(
      b, child, static_cast<float*>(values), static_cast<int32_t*>(action),
      batch);
  return static_cast<int>(cudaGetLastError());
}
