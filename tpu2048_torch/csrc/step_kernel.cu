// The env kernels of the port, for Hopper (sm_90a): one whole 2048 env step
// per lane (step_kernel), and k random-legal steps per lane in one launch
// (rollout_kernel, one thread a lane, and rollout_quad_kernel, four). The
// first two run the same device function, env_step; the quad runs
// quad_env_step, on the same helpers, bit for bit the same function.
//
// step_kernel replaces tpu2048/ops/pallas_step.py::_step_kernel (its core is
// _env_step_core): all four direction merges, the uniform random-legal pick
// for lanes whose action is < 0, the spawn, game over, done, the max and
// second-max exponents, the auto-reset, and optionally the pre-reset board
// and the post-reset legal mask. Simple mode (done = game_over) and shaped
// mode (done = (~moved & game_over) | force_done, with a game_over output)
// are both here; force_done == nullptr selects simple mode.
//
// rollout_kernel replaces pallas_step.py::_rollout_kernel: k_steps steps of
// env_step with action -1 per launch, the board and the lane's episode score,
// steps and return held in registers across the window, with the window sums
// reward_sum and done_count. Template switches add the eval latches (first
// completion's score, steps and max exponent, live-step action counts) and
// the shaped stall lanes (the count advances on the resolved action and
// force-ends the episode past stall_limit); a switch that is off costs no
// registers. The bits come from memory, 8 rows a step, or from Philox4x32-10
// inside the kernel (the counterpart of the TPU's on-core PRNG).
//
// What bounds them: integer operations. A lane-step does some 1,100-1,500
// 32-bit operations in registers (legality of four directions, one merge,
// game over, the maxima, the pick; the spawn where the move is valid and
// the reset where the episode ends; ~200 more for Philox). The step kernel
// moves at most 98 bytes a lane (53 in, with all 32 bytes of bits, and 45
// out); the rollout kernel 64 bytes a lane a launch
// with Philox bits (28 in, 36 out), plus 512 a lane with k = 16 rows of bits
// from memory, so at k = 16 it is bound by operations in both modes
// (chip_smoke.py computes both bounds from its inputs). At the paths' batch
// sizes (512-4,096 lanes, 4-32 blocks on 132 SMs) a launch costs the launch
// latency plus one thread's chain of dependent operations, k times over in
// the rollout: hence one round of loads, and no divergent merge.
//
// Design: one thread per lane, kThreads threads a block, ceil(B / kThreads)
// blocks; the ragged last block is masked, so any B works (the TPU kernels
// needed B % block == 0). Boards are cell-major (16, B) int8: row i holds
// cell i of every lane, so neighbouring threads read and write neighbouring
// bytes. The 16 cells live in int32 registers, and every index into them is
// a compile-time constant after unrolling (a runtime index would put the
// array in local memory). Legality of all four directions comes from the
// hole/pair test, which equals "the merge changes the row". Only the chosen
// direction is merged, and the same code runs for every direction, so a
// warp whose lanes chose different directions does not diverge: each row is
// gathered into slide-left order by three selects a cell on the direction
// (cell()), merged by the left merge, and written back by three selects a
// cell on the inverse order (slot()). The step kernel issues all of its
// loads at the top, the board, the action, force_done and all eight bit
// rows, so that they travel in one round; the rollout reads a bit row only
// where a lane needs it: row 0 where the action is < 0, rows 2-3 where the
// move is valid, rows 4-7 where the episode ends (with Philox, half of them
// computed only there).
//
// The rollout has a second layout for small batches. Below kQuadBatch
// lanes one thread a lane leaves most of the card idle: 512 lanes fill 4
// blocks, one warp on each scheduler of 4 SMs, and a launch takes one
// thread's serial chain of k steps. There rollout_quad_kernel gives a lane
// four threads of a warp (a quad; 8 lanes a warp, 4 times the warps and
// SMs) and splits the chain where it splits cleanly. Every thread keeps the
// whole board and every lane value, so the pick, the spawn, the maxima, the
// reset and the window sums run alike in all four and need no exchange.
// Thread t keeps row t and column t of the board (own_lines): it tests
// them in the four directions, and the quad ORs the masks (two shuffles):
// a quarter of the legality test. It merges row t of the chosen direction,
// and the quad gathers the four merged rows, packed a byte a cell into one
// word each (four shuffles), and sums the score (two). The max and second
// max come from each thread's row of the post-step board (six shuffles, a
// quarter of the scan; 6% faster than all four scanning the board at 16384
// lanes). The post-step legal mask gives game over (no legal direction on
// a board with a tile) and, unless the episode ends, the next step's pick
// mask, so the explicit game-over test goes. With Philox, threads 0 and 1
// draw the two halves of a step's words at once and swap them (four
// shuffles); with bits from memory thread t loads rows t and t + 4 and the
// quad exchanges them. Some 600-700 operations a thread a step remain, and
// ~18 shuffles. Above the threshold the quad's duplicated work costs
// throughput, and rollout_kernel runs.
//
// Bits: 8 uint32 rows a step in the TPU kernel's order (pallas_step.py:393):
// action-pick, unused, spawn-pos, spawn-val, reset-p1, reset-p2, reset-v1,
// reset-v2. The callers hold them as int32 storage of the same pattern.
// Philox4x32-10 (Random123) is keyed by the 64-bit seed and counts by
// (lane, step_lo, step_hi, half): half 0 gives rows 0-3 and half 1 rows 4-7
// of step `step`, the bit source's running step counter, so the stream does
// not depend on k or on how a run splits into launches.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// The rollout's layouts: a batch below kQuadBatch lanes runs kQuadThreads
// threads a lane (rollout_quad_kernel), a larger one one thread a lane
// (rollout_kernel); both kThreads threads a block. The wrapper picks the
// layout (ops/step_kernel.py mirrors these constants in rollout_geometry)
// and passes it to the C entry. kQuadBatch is one wave of random eval's
// quad kernel (latches, Philox) on an H100 SXM: at its 96 registers an SM
// holds 5 blocks of 32 lanes, x 132 SMs. Past it the quad runs a second
// wave and one thread a lane is faster (chip_smoke.py phase 12 at 20480
// and 24576 lanes).
constexpr int kQuadThreads = 4;
[[maybe_unused]] constexpr int kQuadBatch = 21120;

// Board cell at position k of row r when sliding in direction d
// (0 = left, 1 = up, 2 = right, 3 = down), counted from the wall the row
// slides toward: pallas_step.py's ROWS table.
__host__ __device__ constexpr int cell(int d, int r, int k) {
  return d == 0 ? 4 * r + k
       : d == 1 ? 4 * k + r
       : d == 2 ? 4 * r + 3 - k
                : 4 * (3 - k) + r;
}

// The inverse of cell(): the position 4 * r + k of board cell i in the
// slide-left order of direction d.
__host__ __device__ constexpr int slot(int d, int i) {
  return d == 0 ? i
       : d == 1 ? 4 * (i % 4) + i / 4
       : d == 2 ? 4 * (i / 4) + 3 - i % 4
                : 4 * (i % 4) + 3 - i / 4;
}

// The one of v0..v3 that direction d in [0, 4), known only at run time,
// picks: three selects, no indexing.
__device__ __forceinline__ int by_dir(int d, int v0, int v1, int v2,
                                      int v3) {
  return d == 0 ? v0 : d == 1 ? v1 : d == 2 ? v2 : v3;
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

// Slide and merge one row toward x[0] in place; returns the merge score (a
// cell made by a merge does not merge again).
__device__ __forceinline__ int merge_left(int x[4]) {
  compact(x[0], x[1], x[2], x[3]);
  const bool m01 = x[0] == x[1] && x[0] > 0;
  const bool m12 = x[1] == x[2] && x[1] > 0 && !m01;
  const bool m23 = x[2] == x[3] && x[2] > 0 && !m12;
  const int score = (m01 ? 1 << (x[0] + 1) : 0) +
                    (m12 ? 1 << (x[1] + 1) : 0) +
                    (m23 ? 1 << (x[2] + 1) : 0);
  int y0 = x[0] + (m01 ? 1 : 0);
  int y1 = m01 ? 0 : x[1] + (m12 ? 1 : 0);
  int y2 = m12 ? 0 : x[2] + (m23 ? 1 : 0);
  int y3 = m23 ? 0 : x[3];
  compact(y0, y1, y2, y3);
  x[0] = y0;
  x[1] = y1;
  x[2] = y2;
  x[3] = y3;
  return score;
}

// Slide and merge the four rows of direction d in [0, 4) in place; returns
// the merge score. Every lane runs the same instructions whatever its d.
__device__ __forceinline__ int merge_dir(int c[16], int d) {
  int y[16];
  int score = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = by_dir(d, c[cell(0, r, k)], c[cell(1, r, k)], c[cell(2, r, k)],
                    c[cell(3, r, k)]);
    }
    score += merge_left(x);
#pragma unroll
    for (int k = 0; k < 4; ++k) y[4 * r + k] = x[k];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    c[i] = by_dir(d, y[slot(0, i)], y[slot(1, i)], y[slot(2, i)],
                  y[slot(3, i)]);
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

// Philox4x32-10: ten rounds of two 32x32->64 products, the key bumped by
// the Weyl constants between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      key.x += 0x9E3779B9u;
      key.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, ctr.x);
    const uint32_t lo0 = 0xD2511F53u * ctr.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One step's bit rows from memory: row r of this lane at rows[r * B + lane].
struct RowBits {
  const uint32_t* rows;
  size_t B;
  int lane;
  __device__ __forceinline__ uint32_t operator()(int r) const {
    return rows[r * B + lane];
  }
};

// One step's bit rows, all eight loaded at once into registers (the step
// kernel's source: every call site names its row by a constant).
struct LoadedBits {
  uint32_t row[8];
  __device__ __forceinline__ LoadedBits(const uint32_t* rows, size_t B,
                                        int lane) {
#pragma unroll
    for (int r = 0; r < 8; ++r) row[r] = rows[r * B + lane];
  }
  __device__ __forceinline__ uint32_t operator()(int r) const {
    return row[r];
  }
};

// One step's bit rows from Philox: half 0 at once, half 1 at its first use.
struct PhiloxBits {
  uint2 key;
  uint4 ctr;
  uint4 lo, hi;
  bool have_hi;
  __device__ __forceinline__ PhiloxBits(uint2 key_, uint32_t lane,
                                        uint64_t step)
      : key(key_),
        ctr(make_uint4(lane, static_cast<uint32_t>(step),
                       static_cast<uint32_t>(step >> 32), 0u)),
        have_hi(false) {
    lo = philox4x32_10(ctr, key);
  }
  __device__ __forceinline__ uint32_t operator()(int r) {
    if (r < 4) return word(lo, r);
    if (!have_hi) {
      ctr.w = 1u;
      hi = philox4x32_10(ctr, key);
      have_hi = true;
    }
    return word(hi, r - 4);
  }
};

struct StepResult {
  int score;     // merge score of the move
  int mx;        // max exponent of the post-step, pre-reset board
  int second;    // second max, skipping only the first max cell
  int action;    // the resolved action
  bool moved;    // the move changed the board
  bool done;     // the episode ended (the board was reset)
  bool game_over;
};

// The pick-th legal direction in order, uniform over the legal ones (0
// where none is legal).
__device__ __forceinline__ int random_legal(const bool legal[4],
                                            uint32_t bits) {
  const int n_legal = legal[0] + legal[1] + legal[2] + legal[3];
  const int pick = uniform_mod(bits, n_legal);
  int csum = 0, chosen = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (legal[a] && csum == pick) chosen = a;
    csum += legal[a];
  }
  return chosen;
}

// Spawn on a uniformly random empty cell of the merged board.
__device__ __forceinline__ void spawn(int nc[16], uint32_t pos_bits,
                                      uint32_t val_bits) {
  int n_empty = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) n_empty += nc[i] == 0;
  const int idx = uniform_mod(pos_bits, n_empty);
  const int val = tile_value(val_bits);
  int csum = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const bool empty = nc[i] == 0;
    if (empty && csum == idx) nc[i] = val;
    csum += empty;
  }
}

// Max exponent, and the second max that skips only the FIRST max cell in
// cell order (two equal maxima give second == max).
__device__ __forceinline__ void max_two(const int nc[16], StepResult& s) {
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
  s.mx = mx;
  s.second = second;
}

// The auto-reset: a fresh two-tile board.
__device__ __forceinline__ void fresh_board(int nc[16], uint32_t p1_bits,
                                            uint32_t p2_bits,
                                            uint32_t v1_bits,
                                            uint32_t v2_bits) {
  const int p1 = uniform_mod(p1_bits, 16);
  const int p2r = uniform_mod(p2_bits, 15);
  const int p2 = p2r >= p1 ? p2r + 1 : p2r;
  const int v1 = tile_value(v1_bits);
  const int v2 = tile_value(v2_bits);
#pragma unroll
  for (int i = 0; i < 16; ++i) nc[i] = i == p1 ? v1 : (i == p2 ? v2 : 0);
}

// One env step of one lane (pallas_step.py::_env_step_core). `c` holds the
// board and becomes the post-reset board. An action < 0 is resolved to a
// uniformly random legal one (0 where none is legal). In shaped mode
// `force_done(action)` is called once with the resolved action, and
// done = (~moved & game_over) | force_done; else done = game_over.
// `pre_reset`, if not null, receives the post-step board before the reset.
template <class Bits, class ForceDone>
__device__ __forceinline__ StepResult env_step(int c[16], int action,
                                               bool shaped,
                                               ForceDone force_done,
                                               Bits& bits, int8_t* pre_reset,
                                               size_t B, int lane) {
  bool legal[4];
  legal_dirs(c, legal);
  if (action < 0) action = random_legal(legal, bits(0));
  const bool forced = shaped && force_done(action);

  // Merge the chosen direction only. An illegal direction leaves the board
  // as it was with a zero score, and so does an action outside [0, 4).
  int nc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) nc[i] = c[i];
  StepResult s;
  s.action = action;
  s.score = 0;
  s.moved = false;
  if (action >= 0 && action < 4) {
    s.score = merge_dir(nc, action);
    s.moved = by_dir(action, legal[0], legal[1], legal[2], legal[3]);
  }

  if (s.moved) spawn(nc, bits(2), bits(3));

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
  s.game_over = !open;
  s.done = shaped ? (!s.moved && s.game_over) || forced : s.game_over;

  max_two(nc, s);

  if (pre_reset != nullptr) {
#pragma unroll
    for (int i = 0; i < 16; ++i) pre_reset[i * B + lane] = nc[i];
  }

  if (s.done) fresh_board(nc, bits(4), bits(5), bits(6), bits(7));
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = nc[i];
  return s;
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

  // Every load in one round, before any arithmetic.
  int c[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = boards[i * B + lane];
  const int action = actions[lane];
  const bool forced = force_done != nullptr && force_done[lane] != 0;
  LoadedBits rows(bits, B, lane);
  const StepResult s =
      env_step(c, action, force_done != nullptr,
               [forced](int) { return forced; }, rows, out_pre_reset, B,
               lane);

#pragma unroll
  for (int i = 0; i < 16; ++i) out_boards[i * B + lane] = c[i];
  out_score[lane] = s.score;
  out_valid[lane] = s.moved;
  out_done[lane] = s.done;
  out_max[lane] = s.mx;
  out_second[lane] = s.second;
  if (out_game_over != nullptr) out_game_over[lane] = s.game_over;
  if (out_legal != nullptr) {
    // Legality of the post-reset board: the next step's action mask.
    bool legal[4];
    legal_dirs(c, legal);
#pragma unroll
    for (int d = 0; d < 4; ++d) out_legal[d * B + lane] = legal[d];
  }
}

// The rollout's inputs and outputs. The stall lanes are read and written
// only in shaped mode, the latch lanes only in latch mode, `bits` only
// without Philox.
struct RolloutArgs {
  const int8_t* boards;
  const int32_t* score;
  const int32_t* steps;
  const float* ret;
  const uint32_t* bits;  // (8 * k, B)
  const int32_t* consec_action;
  const int32_t* consec_count;
  const int8_t* latched;
  const int32_t* fscore;
  const int32_t* fsteps;
  const int8_t* fmax;
  const int32_t* acnt;  // (4, B)
  int8_t* out_boards;
  int32_t* out_score;
  int32_t* out_steps;
  float* out_ret;
  int32_t* out_reward_sum;
  int32_t* out_done_count;
  int32_t* out_consec_action;
  int32_t* out_consec_count;
  int8_t* out_latched;
  int32_t* out_fscore;
  int32_t* out_fsteps;
  int8_t* out_fmax;
  int32_t* out_acnt;
  int k;
  bool terminal_bonus;
  int stall_limit;
  bool reset_shaping;
  uint64_t seed;
  uint64_t step;
  int batch;
};

// A rollout lane's episode, window, stall and latch lanes, held in
// registers across the window: read from `a` at the start, advanced by one
// step's result, written at the end.
template <bool kShaped, bool kLatch>
struct Window {
  int ep_score, ep_steps;
  float ep_ret;
  int reward_sum = 0, done_count = 0;
  int consec_action = 0, consec_count = 0, new_count = 0;
  int latched = 0, fscore = 0, fsteps = 0, fmax = 0;
  int acnt[4] = {0, 0, 0, 0};

  __device__ __forceinline__ Window(const RolloutArgs& a, size_t B,
                                    int lane)
      : ep_score(a.score[lane]), ep_steps(a.steps[lane]),
        ep_ret(a.ret[lane]) {
    if (kShaped) {
      consec_action = a.consec_action[lane];
      consec_count = a.consec_count[lane];
    }
    if (kLatch) {
      latched = a.latched[lane];
      fscore = a.fscore[lane];
      fsteps = a.fsteps[lane];
      fmax = a.fmax[lane];
#pragma unroll
      for (int d = 0; d < 4; ++d) acnt[d] = a.acnt[d * B + lane];
    }
  }

  // The stall count advances on the resolved action; past the limit the
  // episode is forced to end (shaped mode only).
  __device__ __forceinline__ bool stall(int action, int stall_limit) {
    new_count = action == consec_action ? consec_count + 1 : 1;
    return new_count > stall_limit;
  }

  __device__ __forceinline__ void update(const StepResult& s,
                                         const RolloutArgs& a) {
    int reward = 0;
    if (kShaped) {
      // The stall lanes carry across episodes unless reset_shaping; a
      // shaped window keeps no reward sums (its rewards are float shaping
      // outside the kernel).
      consec_action = s.action;
      consec_count = new_count;
      if (a.reset_shaping && s.done) {
        consec_action = -1;
        consec_count = 0;
      }
    } else {
      // Simple reward, and the training loop's terminal bonus on the top
      // two exponents of the finished board.
      reward = !s.moved && !s.done ? -10 : s.score;
      if (a.terminal_bonus && s.done) {
        reward += s.mx >= 11                      ? 100
                  : s.mx >= 10 && s.second >= 10 ? 50
                                                  : 0;
      }
      reward_sum += reward;
    }
    done_count += s.done;
    if (kLatch) {
      // A lane's first completion, from the pre-reset episode values; its
      // actions count while it is live, this step's included.
      const bool live = latched == 0;
      if (live && s.done) {
        fscore = ep_score + s.score;
        fsteps = ep_steps + 1;
        fmax = s.mx;
        latched = 1;
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) acnt[d] += live && s.action == d;
    }
    ep_score = s.done ? 0 : ep_score + s.score;
    ep_steps = s.done ? 0 : ep_steps + 1;
    const float new_ret = ep_ret + static_cast<float>(reward);
    ep_ret = s.done ? 0.0f : new_ret;
  }

  // Writes the lane outputs; output j is written by the thread t with
  // j % nt == t of the lane's nt threads.
  __device__ __forceinline__ void store(const RolloutArgs& a, size_t B,
                                        int lane, int t, int nt) const {
    if (0 % nt == t) a.out_score[lane] = ep_score;
    if (1 % nt == t) a.out_steps[lane] = ep_steps;
    if (2 % nt == t) a.out_ret[lane] = ep_ret;
    if (3 % nt == t) a.out_reward_sum[lane] = reward_sum;
    if (4 % nt == t) a.out_done_count[lane] = done_count;
    if (kShaped) {
      if (5 % nt == t) a.out_consec_action[lane] = consec_action;
      if (6 % nt == t) a.out_consec_count[lane] = consec_count;
    }
    if (kLatch) {
      if (7 % nt == t) a.out_latched[lane] = latched;
      if (8 % nt == t) a.out_fscore[lane] = fscore;
      if (9 % nt == t) a.out_fsteps[lane] = fsteps;
      if (10 % nt == t) a.out_fmax[lane] = fmax;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        if ((11 + d) % nt == t) a.out_acnt[d * B + lane] = acnt[d];
      }
    }
  }
};

// One thread a lane: the layout for large batches, where the card is full.
template <bool kShaped, bool kLatch, bool kPhilox>
__global__ void __launch_bounds__(kThreads) rollout_kernel(RolloutArgs a) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.batch) return;
  const size_t B = static_cast<size_t>(a.batch);

  int c[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = a.boards[i * B + lane];
  Window<kShaped, kLatch> w(a, B, lane);
  const uint2 key = make_uint2(static_cast<uint32_t>(a.seed),
                               static_cast<uint32_t>(a.seed >> 32));

  for (int it = 0; it < a.k; ++it) {
    auto stall = [&](int action) { return w.stall(action, a.stall_limit); };
    StepResult s;
    if (kPhilox) {
      PhiloxBits bits(key, static_cast<uint32_t>(lane), a.step + it);
      s = env_step(c, -1, kShaped, stall, bits, nullptr, B, lane);
    } else {
      RowBits bits{a.bits + static_cast<size_t>(8 * it) * B, B, lane};
      s = env_step(c, -1, kShaped, stall, bits, nullptr, B, lane);
    }
    w.update(s, a);
  }

#pragma unroll
  for (int i = 0; i < 16; ++i) a.out_boards[i * B + lane] = c[i];
  w.store(a, B, lane, 0, 1);
}

// Four threads a lane (a quad of neighbouring threads of a warp): the
// layout for small batches. Each thread holds the whole board and every
// lane value; thread t also holds row t and column t of the board
// (own_lines), merges row t of the chosen direction and takes the maxima of
// row t.

// Row t of the board, h[k] = c[cell(0, t, k)], and column t, v[k] =
// c[cell(1, t, k)], each from the wall that left and up slide toward; then
// row t of direction d is cell(d, t, k): h[k], v[k], h[3 - k], v[3 - k].
__device__ __forceinline__ void own_lines(const int c[16], int t, int h[4],
                                          int v[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    h[k] = by_dir(t, c[cell(0, 0, k)], c[cell(0, 1, k)], c[cell(0, 2, k)],
                  c[cell(0, 3, k)]);
    v[k] = by_dir(t, c[cell(1, 0, k)], c[cell(1, 1, k)], c[cell(1, 2, k)],
                  c[cell(1, 3, k)]);
  }
}

// Whether a line moves when slid toward a[0] (bit 0) and toward a[3] (bit
// 1): a zero nearer that wall than a nonzero, or an adjacent equal nonzero
// pair (legal_dirs' test).
__device__ __forceinline__ int line_moves(const int a[4]) {
  const bool n0 = a[0] != 0, n1 = a[1] != 0, n2 = a[2] != 0, n3 = a[3] != 0;
  const bool pair =
      (a[0] == a[1] && n0) || (a[1] == a[2] && n1) || (a[2] == a[3] && n2);
  const bool hole0 =
      (!n0 && (n1 || n2 || n3)) || (!n1 && (n2 || n3)) || (!n2 && n3);
  const bool hole3 =
      (!n3 && (n2 || n1 || n0)) || (!n2 && (n1 || n0)) || (!n1 && n0);
  return (hole0 || pair) | (hole3 || pair) << 1;
}

// The legal mask of the board, bit d for direction d: thread t tests its row
// (left, right) and column (up, down), and the quad ORs the four masks.
__device__ __forceinline__ int quad_legal(const int h[4], const int v[4],
                                          unsigned quad) {
  const int mh = line_moves(h), mv = line_moves(v);
  int m = (mh & 1) | (mv & 1) << 1 | (mh & 2) << 1 | (mv & 2) << 2;
  m |= __shfl_xor_sync(quad, m, 1);
  return m | __shfl_xor_sync(quad, m, 2);
}

// The low bytes of four ints in one word, x0 in the low byte.
__device__ __forceinline__ int pack_bytes(int x0, int x1, int x2, int x3) {
  return static_cast<int>(__byte_perm(__byte_perm(x0, x1, 0x0040),
                                      __byte_perm(x2, x3, 0x0040), 0x5410));
}

// Byte k of a packed word, sign-extended as the int8 board's values are.
__device__ __forceinline__ int byte_at(int word, int k) {
  return static_cast<int8_t>(word >> (8 * k));
}

// A step's eight bit rows, shared by the quad.
struct QuadBits {
  uint32_t row[8];
  __device__ __forceinline__ uint32_t operator()(int r) const {
    return row[r];
  }
};

// Philox: thread t draws half t % 2 of the step's words, its partner the
// other half, at the same time; the pair swaps them (the counter and key of
// PhiloxBits, so the stream is the one-thread layout's).
__device__ __forceinline__ QuadBits quad_philox(uint2 key, uint32_t lane,
                                                uint64_t step, int t,
                                                unsigned quad) {
  const uint32_t half = t & 1;
  const uint4 mine = philox4x32_10(
      make_uint4(lane, static_cast<uint32_t>(step),
                 static_cast<uint32_t>(step >> 32), half),
      key);
  uint4 other;
  other.x = __shfl_xor_sync(quad, mine.x, 1);
  other.y = __shfl_xor_sync(quad, mine.y, 1);
  other.z = __shfl_xor_sync(quad, mine.z, 1);
  other.w = __shfl_xor_sync(quad, mine.w, 1);
  const uint4 lo = half ? other : mine, hi = half ? mine : other;
  QuadBits b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b.row[i] = word(lo, i);
    b.row[4 + i] = word(hi, i);
  }
  return b;
}

// Bits from memory: thread t loads rows t and t + 4 of the step (the rows
// at rows[r * B + lane]), and the quad exchanges them.
__device__ __forceinline__ QuadBits quad_rows(const uint32_t* rows, size_t B,
                                              int lane, int t,
                                              unsigned quad) {
  const uint32_t lo = rows[t * B + lane], hi = rows[(t + 4) * B + lane];
  QuadBits b;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    b.row[r] = __shfl_sync(quad, lo, r, kQuadThreads);
    b.row[4 + r] = __shfl_sync(quad, hi, r, kQuadThreads);
  }
  return b;
}

// One random-legal env step of one lane on its quad: env_step with action
// -1, bit for bit. `c` holds the board, h and v thread t's row and column
// of it, `legal` its legal mask; all become those of the post-reset board.
// Thread t merges row t of the chosen direction; the quad gathers the four
// merged rows, a packed word each. Game over comes from the legal mask of
// the post-step board (on a board with a tile, game over is "no legal
// direction"; the empty board is neither), which is also the next step's
// pick mask unless the episode ends; the maxima from each thread's row of
// the post-step board, reduced over the quad.
template <class ForceDone>
__device__ __forceinline__ StepResult quad_env_step(int c[16], int h[4],
                                                    int v[4], int& legal,
                                                    bool shaped,
                                                    ForceDone force_done,
                                                    const QuadBits& bits,
                                                    int t, unsigned quad) {
  bool can[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) can[d] = legal >> d & 1;
  StepResult s;
  s.action = random_legal(can, bits(0));
  const int d = s.action;
  const bool forced = shaped && force_done(d);
  s.moved = legal >> d & 1;

  int x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = by_dir(d, h[k], v[k], h[3 - k], v[3 - k]);
  int score = merge_left(x);
  score += __shfl_xor_sync(quad, score, 1);
  s.score = score + __shfl_xor_sync(quad, score, 2);
  const int packed = pack_bytes(x[0], x[1], x[2], x[3]);
  int y[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = __shfl_sync(quad, packed, r, kQuadThreads);
#pragma unroll
    for (int k = 0; k < 4; ++k) y[4 * r + k] = byte_at(row, k);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    c[i] = by_dir(d, y[slot(0, i)], y[slot(1, i)], y[slot(2, i)],
                  y[slot(3, i)]);
  }

  if (s.moved) spawn(c, bits(2), bits(3));
  own_lines(c, t, h, v);
  legal = quad_legal(h, v, quad);
  bool tile = false;
#pragma unroll
  for (int i = 0; i < 16; ++i) tile = tile || c[i] != 0;
  s.game_over = legal == 0 && tile;
  s.done = shaped ? (!s.moved && s.game_over) || forced : s.game_over;

  // The maxima from the own row: the quad's max, how many cells hold it,
  // and the largest cell below it (max_two's second: the max itself where
  // two cells hold it).
  int mx = max(max(h[0], h[1]), max(h[2], h[3]));
  mx = max(mx, __shfl_xor_sync(quad, mx, 1));
  mx = max(mx, __shfl_xor_sync(quad, mx, 2));
  int cnt = (h[0] == mx) + (h[1] == mx) + (h[2] == mx) + (h[3] == mx);
  int below = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) below = h[k] < mx && h[k] > below ? h[k] : below;
  cnt += __shfl_xor_sync(quad, cnt, 1);
  below = max(below, __shfl_xor_sync(quad, below, 1));
  cnt += __shfl_xor_sync(quad, cnt, 2);
  below = max(below, __shfl_xor_sync(quad, below, 2));
  s.mx = mx;
  s.second = cnt >= 2 ? max(mx, 0) : below;

  if (s.done) {
    // The whole quad takes this branch.
    fresh_board(c, bits(4), bits(5), bits(6), bits(7));
    own_lines(c, t, h, v);
    legal = quad_legal(h, v, quad);
  }
  return s;
}

template <bool kShaped, bool kLatch, bool kPhilox>
__global__ void __launch_bounds__(kThreads)
rollout_quad_kernel(RolloutArgs a) {
  const int lane = (blockIdx.x * kThreads + threadIdx.x) / kQuadThreads;
  if (lane >= a.batch) return;  // the whole quad: it shares the lane
  const int t = threadIdx.x % kQuadThreads;
  const unsigned quad = 0xFu << (threadIdx.x % 32 / kQuadThreads *
                                 kQuadThreads);
  const size_t B = static_cast<size_t>(a.batch);

  int c[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = a.boards[i * B + lane];
  Window<kShaped, kLatch> w(a, B, lane);
  const uint2 key = make_uint2(static_cast<uint32_t>(a.seed),
                               static_cast<uint32_t>(a.seed >> 32));
  int h[4], v[4];
  own_lines(c, t, h, v);
  int legal = quad_legal(h, v, quad);

  for (int it = 0; it < a.k; ++it) {
    const QuadBits bits =
        kPhilox ? quad_philox(key, static_cast<uint32_t>(lane), a.step + it,
                              t, quad)
                : quad_rows(a.bits + static_cast<size_t>(8 * it) * B, B,
                            lane, t, quad);
    auto stall = [&](int action) { return w.stall(action, a.stall_limit); };
    w.update(quad_env_step(c, h, v, legal, kShaped, stall, bits, t, quad),
             a);
  }

  // Thread t writes row t of the board and its share of the lane outputs.
#pragma unroll
  for (int k = 0; k < 4; ++k) a.out_boards[(4 * t + k) * B + lane] = h[k];
  w.store(a, B, lane, t, kQuadThreads);
}

template <bool kShaped, bool kLatch>
void launch_rollout(const RolloutArgs& a, bool quad, int blocks,
                    cudaStream_t stream) {
  if (quad && a.bits == nullptr) {
    rollout_quad_kernel<kShaped, kLatch, true>
        <<<blocks, kThreads, 0, stream>>>(a);
  } else if (quad) {
    rollout_quad_kernel<kShaped, kLatch, false>
        <<<blocks, kThreads, 0, stream>>>(a);
  } else if (a.bits == nullptr) {
    rollout_kernel<kShaped, kLatch, true><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    rollout_kernel<kShaped, kLatch, false><<<blocks, kThreads, 0, stream>>>(a);
  }
}

// An empty kernel at the step kernel's geometry: the least time any launch
// of it takes, for reading the step kernel's time against.
__global__ void __launch_bounds__(kThreads) noop_kernel() {}

int blocks_for(int batch) { return (batch + kThreads - 1) / kThreads; }

// The rollout's blocks at `lane_threads` threads a lane.
int rollout_blocks(int batch, int lane_threads) {
  return static_cast<int>(
      (static_cast<long long>(batch) * lane_threads + kThreads - 1) /
      kThreads);
}

// Makes `device` current, calling cudaSetDevice only when it is not.
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
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
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  step_kernel<<<blocks_for(batch), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
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

// Launches one rollout window of k steps on `stream` of device `device`,
// at `lane_threads` threads a lane: 1 (rollout_kernel) or kQuadThreads
// (rollout_quad_kernel); the wrapper picks it from the batch at kQuadBatch.
// bits == nullptr selects Philox bits keyed by `seed` from step `step`;
// consec_action == nullptr turns off shaped mode (its four lane pointers
// are then not read), latched == nullptr the latches (ten pointers). Returns
// the cudaError_t of the launch.
extern "C" int tpu2048_rollout_kernel(
    const void* boards, const void* score, const void* steps, const void* ret,
    const void* bits, const void* consec_action, const void* consec_count,
    const void* latched, const void* fscore, const void* fsteps,
    const void* fmax, const void* acnt, void* out_boards, void* out_score,
    void* out_steps, void* out_ret, void* out_reward_sum,
    void* out_done_count, void* out_consec_action, void* out_consec_count,
    void* out_latched, void* out_fscore, void* out_fsteps, void* out_fmax,
    void* out_acnt, int k, int terminal_bonus, int stall_limit,
    int reset_shaping, unsigned long long seed, unsigned long long step,
    int batch, int lane_threads, int device, void* stream) {
  if (lane_threads != 1 && lane_threads != kQuadThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  RolloutArgs a;
  a.boards = static_cast<const int8_t*>(boards);
  a.score = static_cast<const int32_t*>(score);
  a.steps = static_cast<const int32_t*>(steps);
  a.ret = static_cast<const float*>(ret);
  a.bits = static_cast<const uint32_t*>(bits);
  a.consec_action = static_cast<const int32_t*>(consec_action);
  a.consec_count = static_cast<const int32_t*>(consec_count);
  a.latched = static_cast<const int8_t*>(latched);
  a.fscore = static_cast<const int32_t*>(fscore);
  a.fsteps = static_cast<const int32_t*>(fsteps);
  a.fmax = static_cast<const int8_t*>(fmax);
  a.acnt = static_cast<const int32_t*>(acnt);
  a.out_boards = static_cast<int8_t*>(out_boards);
  a.out_score = static_cast<int32_t*>(out_score);
  a.out_steps = static_cast<int32_t*>(out_steps);
  a.out_ret = static_cast<float*>(out_ret);
  a.out_reward_sum = static_cast<int32_t*>(out_reward_sum);
  a.out_done_count = static_cast<int32_t*>(out_done_count);
  a.out_consec_action = static_cast<int32_t*>(out_consec_action);
  a.out_consec_count = static_cast<int32_t*>(out_consec_count);
  a.out_latched = static_cast<int8_t*>(out_latched);
  a.out_fscore = static_cast<int32_t*>(out_fscore);
  a.out_fsteps = static_cast<int32_t*>(out_fsteps);
  a.out_fmax = static_cast<int8_t*>(out_fmax);
  a.out_acnt = static_cast<int32_t*>(out_acnt);
  a.k = k;
  a.terminal_bonus = terminal_bonus != 0;
  a.stall_limit = stall_limit;
  a.reset_shaping = reset_shaping != 0;
  a.seed = seed;
  a.step = step;
  a.batch = batch;
  const int blocks = rollout_blocks(batch, lane_threads);
  const bool quad = lane_threads == kQuadThreads;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool shaped = consec_action != nullptr;
  const bool latch = latched != nullptr;
  if (shaped && latch) {
    launch_rollout<true, true>(a, quad, blocks, st);
  } else if (shaped) {
    launch_rollout<true, false>(a, quad, blocks, st);
  } else if (latch) {
    launch_rollout<false, true>(a, quad, blocks, st);
  } else {
    launch_rollout<false, false>(a, quad, blocks, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches noop_kernel over `batch` lanes on `stream` of device `device`,
// by the step kernel's path. Returns the cudaError_t of the launch.
extern "C" int tpu2048_noop_kernel(int batch, int device, void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  noop_kernel<<<blocks_for(batch), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
