// The env kernels of the port, for Hopper (sm_90a): one whole 2048 env step
// per lane (step_kernel), and k random-legal steps per lane in one launch
// (rollout_kernel). Both run the same device function, env_step.
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
// sizes (512-4,096 lanes, 2-32 blocks on 132 SMs) a launch costs the launch
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

// Slide and merge the four rows of direction d in [0, 4) in place; returns
// the merge score (a cell made by a merge does not merge again). Every lane
// runs the same instructions whatever its d.
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
    compact(x[0], x[1], x[2], x[3]);
    const bool m01 = x[0] == x[1] && x[0] > 0;
    const bool m12 = x[1] == x[2] && x[1] > 0 && !m01;
    const bool m23 = x[2] == x[3] && x[2] > 0 && !m12;
    score += (m01 ? 1 << (x[0] + 1) : 0) + (m12 ? 1 << (x[1] + 1) : 0) +
             (m23 ? 1 << (x[2] + 1) : 0);
    int y0 = x[0] + (m01 ? 1 : 0);
    int y1 = m01 ? 0 : x[1] + (m12 ? 1 : 0);
    int y2 = m12 ? 0 : x[2] + (m23 ? 1 : 0);
    int y3 = m23 ? 0 : x[3];
    compact(y0, y1, y2, y3);
    y[4 * r] = y0;
    y[4 * r + 1] = y1;
    y[4 * r + 2] = y2;
    y[4 * r + 3] = y3;
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
  if (action < 0) {
    // The pick-th legal direction in order, uniform over the legal ones.
    const int n_legal = legal[0] + legal[1] + legal[2] + legal[3];
    const int pick = uniform_mod(bits(0), n_legal);
    int csum = 0, chosen = 0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (legal[a] && csum == pick) chosen = a;
      csum += legal[a];
    }
    action = chosen;
  }
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

  if (s.moved) {
    // Spawn on a uniformly random empty cell of the merged board.
    int n_empty = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) n_empty += nc[i] == 0;
    const int idx = uniform_mod(bits(2), n_empty);
    const int val = tile_value(bits(3));
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
  s.game_over = !open;
  s.done = shaped ? (!s.moved && s.game_over) || forced : s.game_over;

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
  s.mx = mx;
  s.second = second;

  if (pre_reset != nullptr) {
#pragma unroll
    for (int i = 0; i < 16; ++i) pre_reset[i * B + lane] = nc[i];
  }

  if (s.done) {
    // Auto-reset to a fresh two-tile board.
    const int p1 = uniform_mod(bits(4), 16);
    const int p2r = uniform_mod(bits(5), 15);
    const int p2 = p2r >= p1 ? p2r + 1 : p2r;
    const int v1 = tile_value(bits(6));
    const int v2 = tile_value(bits(7));
#pragma unroll
    for (int i = 0; i < 16; ++i) nc[i] = i == p1 ? v1 : (i == p2 ? v2 : 0);
  }
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

template <bool kShaped, bool kLatch, bool kPhilox>
__global__ void __launch_bounds__(kThreads) rollout_kernel(RolloutArgs a) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.batch) return;
  const size_t B = static_cast<size_t>(a.batch);

  int c[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = a.boards[i * B + lane];
  int ep_score = a.score[lane], ep_steps = a.steps[lane];
  float ep_ret = a.ret[lane];
  int reward_sum = 0, done_count = 0;
  int consec_action = 0, consec_count = 0;
  if (kShaped) {
    consec_action = a.consec_action[lane];
    consec_count = a.consec_count[lane];
  }
  int latched = 0, fscore = 0, fsteps = 0, fmax = 0;
  int acnt[4] = {0, 0, 0, 0};
  if (kLatch) {
    latched = a.latched[lane];
    fscore = a.fscore[lane];
    fsteps = a.fsteps[lane];
    fmax = a.fmax[lane];
#pragma unroll
    for (int d = 0; d < 4; ++d) acnt[d] = a.acnt[d * B + lane];
  }
  const uint2 key = make_uint2(static_cast<uint32_t>(a.seed),
                               static_cast<uint32_t>(a.seed >> 32));

  for (int it = 0; it < a.k; ++it) {
    // The stall count advances on the resolved action; past the limit the
    // episode is forced to end (shaped mode only).
    int new_count = 0;
    auto stall = [&](int action) {
      new_count = action == consec_action ? consec_count + 1 : 1;
      return new_count > a.stall_limit;
    };
    StepResult s;
    if (kPhilox) {
      PhiloxBits bits(key, static_cast<uint32_t>(lane), a.step + it);
      s = env_step(c, -1, kShaped, stall, bits, nullptr, B, lane);
    } else {
      RowBits bits{a.bits + static_cast<size_t>(8 * it) * B, B, lane};
      s = env_step(c, -1, kShaped, stall, bits, nullptr, B, lane);
    }

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

#pragma unroll
  for (int i = 0; i < 16; ++i) a.out_boards[i * B + lane] = c[i];
  a.out_score[lane] = ep_score;
  a.out_steps[lane] = ep_steps;
  a.out_ret[lane] = ep_ret;
  a.out_reward_sum[lane] = reward_sum;
  a.out_done_count[lane] = done_count;
  if (kShaped) {
    a.out_consec_action[lane] = consec_action;
    a.out_consec_count[lane] = consec_count;
  }
  if (kLatch) {
    a.out_latched[lane] = latched;
    a.out_fscore[lane] = fscore;
    a.out_fsteps[lane] = fsteps;
    a.out_fmax[lane] = fmax;
#pragma unroll
    for (int d = 0; d < 4; ++d) a.out_acnt[d * B + lane] = acnt[d];
  }
}

template <bool kShaped, bool kLatch>
void launch_rollout(const RolloutArgs& a, int blocks, cudaStream_t stream) {
  if (a.bits == nullptr) {
    rollout_kernel<kShaped, kLatch, true><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    rollout_kernel<kShaped, kLatch, false><<<blocks, kThreads, 0, stream>>>(a);
  }
}

// An empty kernel at the step kernel's geometry: the least time any launch
// of it takes, for reading the step kernel's time against.
__global__ void __launch_bounds__(kThreads) noop_kernel() {}

int blocks_for(int batch) { return (batch + kThreads - 1) / kThreads; }

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

// Launches one rollout window of k steps on `stream` of device `device`.
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
    int batch, int device, void* stream) {
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
  const int blocks = blocks_for(batch);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool shaped = consec_action != nullptr;
  const bool latch = latched != nullptr;
  if (shaped && latch) {
    launch_rollout<true, true>(a, blocks, st);
  } else if (shaped) {
    launch_rollout<true, false>(a, blocks, st);
  } else if (latch) {
    launch_rollout<false, true>(a, blocks, st);
  } else {
    launch_rollout<false, false>(a, blocks, st);
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
