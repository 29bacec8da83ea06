// One whole 2048 env step per lane, for Hopper (sm_90a).
//
// Replaces tpu2048/ops/pallas_step.py::_step_kernel (its core is
// _env_step_core): all four direction merges, the uniform random-legal pick
// for lanes whose action is < 0, the spawn, game over, done, the max and
// second-max exponents, the auto-reset, and optionally the pre-reset board
// and the post-reset legal mask. Simple mode (done = game_over) and shaped
// mode (done = (~moved & game_over) | force_done, with a game_over output)
// are both here; force_done == nullptr selects simple mode.
//
// What bounds it: at large batches, memory and integer throughput about
// equally. A lane moves the board in and out, the action, the bit rows it
// needs and the lane outputs -- at most 80 bytes in simple mode with the
// legal mask -- and does some 1,300-1,500 32-bit operations in registers
// (counted at source level; chip_smoke.py computes both bounds from its
// inputs). At eval
// batch sizes (512 lanes, ~29 KB) neither matters: a launch costs the launch
// latency plus one thread's chain of dependent operations, so a later
// version would fuse steps or split a lane's work, not shave bytes.
//
// Design: one thread per lane, 256 threads a block, ceil(B / 256) blocks;
// the ragged last block is masked, so any B works (the TPU kernel needed
// B % block == 0). Boards are cell-major (16, B) int8: row i holds cell i of
// every lane, so neighbouring threads read and write neighbouring bytes.
// The 16 cells live in int32 registers (every index below is a compile-time
// constant after unrolling). Only the chosen direction is merged; legality
// of all four comes from the hole/pair test, which equals "the merge changes
// the row". A bit row is read only by the lanes that need it: row 0 where
// the action is < 0, rows 2-3 where the move is valid, rows 4-7 where the
// episode ends.
//
// Bits: (8, B) uint32 rows in the TPU kernel's order (pallas_step.py:393):
// action-pick, unused, spawn-pos, spawn-val, reset-p1, reset-p2, reset-v1,
// reset-v2. The callers hold them as int32 storage of the same pattern.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Board cell at position k of row r when sliding in direction d
// (0 = left, 1 = up, 2 = right, 3 = down), counted from the wall the row
// slides toward: pallas_step.py's ROWS table.
__host__ __device__ constexpr int cell(int d, int r, int k) {
  return d == 0 ? 4 * r + k
       : d == 1 ? 4 * k + r
       : d == 2 ? 4 * r + 3 - k
                : 4 * (3 - k) + r;
}

// One comparator of the stable zeros-right sorting network.
__device__ __forceinline__ void cswap(int& a, int& b) {
  if (a == 0 && b != 0) {
    a = b;
    b = 0;
  }
}

__device__ __forceinline__ void compact(int& x0, int& x1, int& x2, int& x3) {
  cswap(x0, x1);
  cswap(x1, x2);
  cswap(x2, x3);
  cswap(x0, x1);
  cswap(x1, x2);
  cswap(x0, x1);
}

// Slide and merge the four rows of direction D in place; returns the merge
// score (a cell made by a merge does not merge again).
template <int D>
__device__ __forceinline__ int merge_dir(int c[16]) {
  int score = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int x0 = c[cell(D, r, 0)], x1 = c[cell(D, r, 1)];
    int x2 = c[cell(D, r, 2)], x3 = c[cell(D, r, 3)];
    compact(x0, x1, x2, x3);
    const bool m01 = x0 == x1 && x0 > 0;
    const bool m12 = x1 == x2 && x1 > 0 && !m01;
    const bool m23 = x2 == x3 && x2 > 0 && !m12;
    score += (m01 ? 1 << (x0 + 1) : 0) + (m12 ? 1 << (x1 + 1) : 0) +
             (m23 ? 1 << (x2 + 1) : 0);
    int y0 = x0 + (m01 ? 1 : 0);
    int y1 = m01 ? 0 : x1 + (m12 ? 1 : 0);
    int y2 = m12 ? 0 : x2 + (m23 ? 1 : 0);
    int y3 = m23 ? 0 : x3;
    compact(y0, y1, y2, y3);
    c[cell(D, r, 0)] = y0;
    c[cell(D, r, 1)] = y1;
    c[cell(D, r, 2)] = y2;
    c[cell(D, r, 3)] = y3;
  }
  return score;
}

// Direction d changes the board iff some row has a zero nearer the wall
// than a nonzero, or an adjacent equal nonzero pair (pallas_step.py's
// _legal_dirs).
__device__ __forceinline__ void legal_dirs(const int c[16], bool legal[4]) {
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    bool any = false;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int a0 = c[cell(d, r, 0)], a1 = c[cell(d, r, 1)];
      const int a2 = c[cell(d, r, 2)], a3 = c[cell(d, r, 3)];
      const bool n0 = a0 != 0, n1 = a1 != 0, n2 = a2 != 0, n3 = a3 != 0;
      const bool hole =
          (!n0 && (n1 || n2 || n3)) || (!n1 && (n2 || n3)) || (!n2 && n3);
      const bool pair =
          (a0 == a1 && n0) || (a1 == a2 && n1) || (a2 == a3 && n2);
      any = any || hole || pair;
    }
    legal[d] = any;
  }
}

// Uniform draw in [0, n) from the top 31 bits (pallas_step.py::_uniform_mod).
__device__ __forceinline__ int uniform_mod(uint32_t bits, int n) {
  return static_cast<int>(bits >> 1) % (n > 1 ? n : 1);
}

// Exponent 1 (a "2") with p = 0.9, else 2 (pallas_step.py::_tile_value):
// the modulus of the full unsigned 32-bit value.
__device__ __forceinline__ int tile_value(uint32_t bits) {
  return bits % 10u < 9u ? 1 : 2;
}

__global__ void __launch_bounds__(kThreads)
step_kernel(const int8_t* __restrict__ boards,
            const int32_t* __restrict__ actions,
            const uint32_t* __restrict__ bits,
            const uint8_t* __restrict__ force_done,
            int8_t* __restrict__ out_boards, int32_t* __restrict__ out_score,
            uint8_t* __restrict__ out_valid, uint8_t* __restrict__ out_done,
            int8_t* __restrict__ out_max, int8_t* __restrict__ out_second,
            uint8_t* __restrict__ out_game_over,
            int8_t* __restrict__ out_pre_reset,
            int8_t* __restrict__ out_legal, int batch) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= batch) return;
  const size_t B = static_cast<size_t>(batch);

  int c[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = boards[i * B + lane];

  bool legal[4];
  legal_dirs(c, legal);
  int action = actions[lane];
  if (action < 0) {
    // The pick-th legal direction in order, uniform over the legal ones.
    const int n_legal = legal[0] + legal[1] + legal[2] + legal[3];
    const int pick = uniform_mod(bits[lane], n_legal);
    int csum = 0, chosen = 0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (legal[a] && csum == pick) chosen = a;
      csum += legal[a];
    }
    action = chosen;
  }

  // Merge the chosen direction only. An illegal direction leaves the board
  // as it was with a zero score, and so does an action outside [0, 4).
  int nc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) nc[i] = c[i];
  int score = 0;
  bool moved = false;
  switch (action) {
    case 0: score = merge_dir<0>(nc); moved = legal[0]; break;
    case 1: score = merge_dir<1>(nc); moved = legal[1]; break;
    case 2: score = merge_dir<2>(nc); moved = legal[2]; break;
    case 3: score = merge_dir<3>(nc); moved = legal[3]; break;
    default: break;
  }

  if (moved) {
    // Spawn on a uniformly random empty cell of the merged board.
    int n_empty = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) n_empty += nc[i] == 0;
    const int idx = uniform_mod(bits[2 * B + lane], n_empty);
    const int val = tile_value(bits[3 * B + lane]);
    int csum = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const bool empty = nc[i] == 0;
      if (empty && csum == idx) nc[i] = val;
      csum += empty;
    }
  }

  // Game over on the post-move, post-spawn board: no empty cell and no
  // adjacent equal pair.
  bool open = false;
#pragma unroll
  for (int i = 0; i < 16; ++i) open = open || nc[i] == 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      open = open || nc[4 * r + k] == nc[4 * r + k + 1] ||
             nc[4 * k + r] == nc[4 * k + r + 4];
    }
  }
  const bool game_over = !open;
  const bool done = force_done == nullptr
                        ? game_over
                        : (!moved && game_over) || force_done[lane] != 0;

  // Max exponent, and the second max that skips only the FIRST max cell in
  // cell order (two equal maxima give second == max).
  int mx = nc[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) mx = nc[i] > mx ? nc[i] : mx;
  int second = 0;
  bool taken = false;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const bool first_max = nc[i] == mx && !taken;
    taken = taken || first_max;
    if (!first_max && nc[i] > second) second = nc[i];
  }

  if (out_pre_reset != nullptr) {
#pragma unroll
    for (int i = 0; i < 16; ++i) out_pre_reset[i * B + lane] = nc[i];
  }

  if (done) {
    // Auto-reset to a fresh two-tile board.
    const int p1 = uniform_mod(bits[4 * B + lane], 16);
    const int p2r = uniform_mod(bits[5 * B + lane], 15);
    const int p2 = p2r >= p1 ? p2r + 1 : p2r;
    const int v1 = tile_value(bits[6 * B + lane]);
    const int v2 = tile_value(bits[7 * B + lane]);
#pragma unroll
    for (int i = 0; i < 16; ++i) nc[i] = i == p1 ? v1 : (i == p2 ? v2 : 0);
  }

#pragma unroll
  for (int i = 0; i < 16; ++i) out_boards[i * B + lane] = nc[i];
  out_score[lane] = score;
  out_valid[lane] = moved;
  out_done[lane] = done;
  out_max[lane] = mx;
  out_second[lane] = second;
  if (out_game_over != nullptr) out_game_over[lane] = game_over;
  if (out_legal != nullptr) {
    // Legality of the post-reset board: the next step's action mask.
    legal_dirs(nc, legal);
#pragma unroll
    for (int d = 0; d < 4; ++d) out_legal[d * B + lane] = legal[d];
  }
}

}  // namespace

// Launches one step on `stream` (a cudaStream_t) of device `device`.
// Optional pointers (force_done, game_over, pre_reset, legal) may be null;
// game_over must be given exactly when force_done is. Returns the
// cudaError_t of the launch.
extern "C" int tpu2048_step_kernel(
    const void* boards, const void* actions, const void* bits,
    const void* force_done, void* out_boards, void* out_score,
    void* out_valid, void* out_done, void* out_max, void* out_second,
    void* out_game_over, void* out_pre_reset, void* out_legal, int batch,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + kThreads - 1) / kThreads;
  step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(boards),
      static_cast<const int32_t*>(actions),
      static_cast<const uint32_t*>(bits),
      static_cast<const uint8_t*>(force_done),
      static_cast<int8_t*>(out_boards), static_cast<int32_t*>(out_score),
      static_cast<uint8_t*>(out_valid), static_cast<uint8_t*>(out_done),
      static_cast<int8_t*>(out_max), static_cast<int8_t*>(out_second),
      static_cast<uint8_t*>(out_game_over),
      static_cast<int8_t*>(out_pre_reset), static_cast<int8_t*>(out_legal),
      batch);
  return static_cast<int>(cudaGetLastError());
}
