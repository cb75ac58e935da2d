// Tensor-core online-softmax read of the RMem bank, shared by kernel B1
// (memory_read.cu) and kernel B3 (memory_read_attention.cu). It replaces
// the Pallas TPU kernels `memory_read_fused`
// (rmem_ocu_tpu/ops/pallas/memory_read.py:281) and `memory_read_attention`
// (:88).
//
// What bounds it on the H100: operations. At the VOST cells' shape (8
// streams, 2,442 queries against 9 live slots of 2,442 keys, D 128, V||ID_V
// 1,024 columns) one read is 0.99 TFLOP against 0.45 GB: 1.0 ms at the
// bf16 tensor-core rate, 0.14 ms for its bytes. The products have to keep
// the tensor cores busy, and the loads, the online softmax and the slot
// mass have to hide behind them.
//
// The wide-head kernel (`memory_read_ws`: one head a block, D in {16, 32,
// 64, 128}, any value width) is warp-specialised for sm_90a:
// - A producer warpgroup, one thread of which keeps three stages of
//   64-key K tiles and of V tiles in flight with TMA, K a tile ahead of
//   V; a tile is a set of 64 x 64 panels in the 128-byte swizzled layout,
//   its arrival counted on an mbarrier, and the consumers free a stage on
//   another. setmaxnreg hands the producer's registers to the consumers.
// - Two consumer warpgroups, each with its own 64 query rows of the
//   block's 128, share the K and V tiles. A consumer runs Q.K^T as wgmma
//   (both operands in shared memory), its online softmax in registers,
//   and P.V as wgmma with P in registers (bf16, rounded at once) and V in
//   shared memory, into 64 rows x the block's value columns of f32. The
//   consumers take turns on the tensor cores (two named barriers): in its
//   turn a consumer issues P.V of tile n and Q.K^T of tile n + 1, and its
//   softmax of tile n + 1 runs in the other's turn.
// - Why the columns split where they do: a block takes 128 value columns
//   (64 where a head has no more), so V||ID_V takes 8 blocks and Q.K^T
//   runs 8 times per key tile (56% of the executed operations useful at
//   the cells' shape). ptxas keeps the accumulators of wgmma in flight
//   within the registers a thread has at entry (168 at 12 warps), and
//   setmaxnreg does not lift that: with 256 columns (O 128 registers a
//   thread, S 32) it spills and serialises every wgmma (C7512). Measured
//   on the H100 at the r50 cell's shape, one read: 6.08 ms with 256-column
//   blocks, 4.71 ms for 64 rows x 512 columns with Q.K^T shared through P
//   in shared memory (serialised too), 3.88 ms for this design.
// - The work of a query tile is the sequence of its live slots' 64-key
//   tiles; a unit takes a contiguous 1/n_split share of it (balanced
//   whatever the number of live slots; a slot may be shared by two units).
//   Where one unit covers the bank (n_split == 1: the wrapper's choice
//   whenever the blocks fill the card without a split) the kernel finishes
//   the read: it normalises, writes the outputs and the per-slot mass, in
//   one launch. Else each unit writes its running max m, its unnormalised
//   f32 accumulator and, where its share of a slot ends, (m, l_t) to
//   scratch, and `memory_read_combine` merges the units of a query row:
//   M = max m_t, L = sum e^(m_t - M) l_t, out = sum_u e^(m_u - M) acc_u /
//   max(L, 1e-30), mass_t = e^(m_t - M) l_t / max(L, 1e-30).
// The small-head kernel (`memory_read_heads`: D <= 32 and Dv <= 32, >= 4
// heads) keeps the earlier design: one block owns 8 heads of a 64-row
// query tile, each warp 16 rows of two heads with S, P and the online
// softmax in registers (mma.sync m16n8k16, a two-stage cp.async ring), and
// it always writes partials for the combine.
//
// The values are the VIRTUAL channel-wise concatenation [v1 | v2] of up to
// two banks (row widths wv1, wv2; v2 may be null): head h owns columns
// [h * cph, (h + 1) * cph), and every column of a head shares the head's
// probabilities. This covers DeAOT's V and ID_V under one head (B1), heads
// by channel slicing of one bank (B1, AOT) and heads over V||ID_V without
// a concatenation (B3). Outputs are laid out the same way over [o1 | o2].
//
// Rounding follows the Pallas kernels: q, k, v and p are bf16 operands
// (the wrappers round f32 storage to bf16 before the launch), the optional
// temporal-PE term sums q.pe in f32 from the rounded q, p is rounded
// relative to its unit's running max, l and the mass use the f32 p-sums,
// outputs are divided by max(L, 1e-30). The tail of a slot's last key tile
// (HWk = 920 tiles by no power of two) gets logit -inf, never 0; TMA's
// zero fill only keeps its bytes finite. Dead slots (valid == 0) may sit
// anywhere and are skipped.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace rmem {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int MAX_T = 32;          // bank slots
constexpr float M_INIT = -1e30f;   // the Pallas kernels' running-max init
constexpr float LOG2E = 1.4426950408889634f;  // e^x = 2^(x log2e)
constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per tile
constexpr int NT = 512;            // threads of a small-head block
constexpr int PAD = 8;             // row padding: conflict-free ldmatrix

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte asynchronous copy; with ok == false nothing is read and the 16
// bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// barrier over `n` threads (a multiple of 32) of the block; id 0 is
// __syncthreads'
__device__ __forceinline__ void named_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Row-major, contiguous, bf16 operands: q [B, HWq, H*D] (pre-scaled),
// k [B, T, HWk, H*D], pe [B, T, H*D] f32 or null, v1 [B, T, HWk, wv1],
// v2 [B, T, HWk, wv2] or null, valid [B, T]. Scratch (f32): part_acc
// [B, n_split, HWq, H*cph], part_m [B, H, n_split, HWq], slot_ml
// [B, H, n_split, HWq, T] (m, l_t), unused by the wide-head kernel at
// n_split == 1. wv1 + wv2 == H * cph; widths are multiples of 8.
struct ReadArgs {
  const bf16* q;
  const bf16* k;
  const float* pe;
  const bf16* v1;
  const bf16* v2;
  const int* valid;
  float* part_acc;
  float* part_m;
  float2* slot_ml;
  int H, T_cap, HWq, HWk, D;
  int cph;        // value columns per head
  int wv1, wv2;
  int n_split;
  int ncb;        // column blocks of a head (wide-head kernel; dispatch's)
};

// o1 [B, HWq, wo1], o2 [B, HWq, wo2] or null, bf16 or f32; mass
// [B, H, HWq, T] f32; wo1 + wo2 == H * cph.
struct OutArgs {
  void* o1;
  void* o2;
  float* mass;
  int wo1, wo2;
  int bf16;       // outputs bf16, else f32
};

__host__ __device__ constexpr int imin(int x, int y) { return x < y ? x : y; }
__host__ __device__ constexpr int imax(int x, int y) { return x > y ? x : y; }

constexpr int MAX_H = 64;          // heads (the combine's shared memory)

// The live slots of batch row b, in physical order, into shared memory;
// returns their count (block-uniform).
__device__ __forceinline__ int live_slots(const ReadArgs& a, int b,
                                          int* live, int* n_live) {
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t < a.T_cap; ++t)
      if (a.valid[b * a.T_cap + t] != 0) live[n++] = t;
    *n_live = n;
  }
  __syncthreads();
  return *n_live;
}

// The work of a query tile is the sequence of its live slots' key tiles,
// n_live * n_kt of them; unit u of n_split takes the contiguous share
// [w0, w1), so the units are balanced whatever the number of live slots
// and a slot may be shared by two units.
__device__ __forceinline__ void unit_range(int n_work, int n_split, int u,
                                           int& w0, int& w1) {
  w0 = static_cast<int>(static_cast<long long>(u) * n_work / n_split);
  w1 = static_cast<int>(static_cast<long long>(u + 1) * n_work / n_split);
}

// (m, l_t) record of slot t for unit u of head h, query row `row`
__device__ __forceinline__ float2* slot_rec(const ReadArgs& a, int b, int h,
                                            int u, int row, int t) {
  return a.slot_ml +
         ((((size_t)b * a.H + h) * a.n_split + u) * a.HWq + row) * a.T_cap +
         t;
}

// Source of the 8 value columns starting at column gc of [v1 | v2] in key
// row `key` (a bank-wide row index), or v1 itself when !ok.
__device__ __forceinline__ const bf16* v_src(const ReadArgs& a, int gc,
                                             size_t key, bool ok) {
  if (!ok) return a.v1;
  return gc < a.wv1 ? a.v1 + key * a.wv1 + gc
                    : a.v2 + key * a.wv2 + (gc - a.wv1);
}

// Temporal-PE logit term of query row r of the tile (q in shared memory at
// row stride ld, this head's D columns from qh), summed over the quad.
__device__ __forceinline__ float pe_term(const bf16* qh, int ld, int r,
                                         const float* pe_t, int D,
                                         int lane) {
  float s = 0.f;
  for (int d = lane % 4; d < D; d += 4)
    s += __bfloat162float(qh[r * ld + d]) * pe_t[d];
  return quad_sum(s);
}

// ------------------------------------------- wide heads (warp-specialised)
constexpr int NCONS = 2;           // consumer warpgroups: 64 rows each
constexpr int WS_ROWS = 64 * NCONS;            // query rows of a block
constexpr int WS_THREADS = 128 * (NCONS + 1);  // and a producer warpgroup
constexpr int PRODUCER_REGS = 24;
// a sub-partition's 16,384 registers over its warps: one producer warp
// at 24 and NCONS consumer warps
constexpr int CONSUMER_REGS = (512 - PRODUCER_REGS) / NCONS / 8 * 8;
constexpr int STAGES = 3;          // K and V tiles in flight
constexpr int PANEL = 64;          // bf16 columns of a 128-byte swizzled row
constexpr int TILE = 64 * PANEL * 2;     // bytes of a 64 x 64 panel

// TMA descriptors: q [B, HWq, H*D], k [B*T, HWk, H*D], v1 [B*T, HWk, wv1],
// v2 [B*T, HWk, wv2] (v1 again when there is no second bank)
struct Maps {
  CUtensorMap q, k, v1, v2;
};

// Where value panel gp of head h comes from. A head's columns are
// [h * cph, (h + 1) * cph) of [v1 | v2]: n1 of them in v1, the rest in
// v2, each part cut into 64-column panels from its start, so that a panel
// lies in one bank. bank: 0 v1, 1 v2; src: its first column in that bank;
// col: its first column within the head; width: its columns (0: none).
struct Panel {
  int bank, src, col, width;
};

__host__ __device__ __forceinline__ Panel panel_of(const ReadArgs& a, int h,
                                                   int gp) {
  const int c0 = h * a.cph;
  const int n1 = imax(0, imin(c0 + a.cph, a.wv1) - c0), n2 = a.cph - n1;
  const int np1 = (n1 + PANEL - 1) / PANEL;
  if (gp < np1) return {0, c0 + gp * PANEL, gp * PANEL,
                        imin(PANEL, n1 - gp * PANEL)};
  const int i = gp - np1;
  return {1, c0 + n1 - a.wv1 + i * PANEL, n1 + i * PANEL,
          imax(0, imin(PANEL, n2 - i * PANEL))};
}

// value panels of the widest head
inline int value_panels(const ReadArgs& a) {
  int most = 0;
  for (int h = 0; h < a.H; ++h) {
    int n = 0;
    while (panel_of(a, h, n).width > 0) ++n;
    most = imax(most, n);
  }
  return most;
}

// KP: 64-column panels of Q and K (D = 128: 2; D <= 64: 1, the columns
// past D zeroed in Q); NC: value columns of a block, 64 or 128
template <int KP, int NC>
struct WsSmem {
  static constexpr int NPV = NC / PANEL;       // value panels of a block
  static constexpr int q = 0;                  // [NCONS][KP] panels
  static constexpr int k = q + NCONS * KP * TILE;   // [STAGES][KP]
  static constexpr int v = k + STAGES * KP * TILE;    // [STAGES][NPV]
  // each live slot's (m, l_t) where the unit's share of it ends, and its
  // PE logit term, [live slot][row]
  static constexpr int ml = v + STAGES * NPV * TILE;
  static constexpr int pc = ml + MAX_T * WS_ROWS * 8;
  static constexpr int bar = pc + MAX_T * WS_ROWS * 4;
  static constexpr int n_bars = 1 + 4 * STAGES;
  // the base is aligned to 1024 bytes at run time
  static constexpr int bytes = bar + 8 * n_bars + 1024;
};

// S (the consumer's 64 rows x 64 keys) = Q K^T over KP panels of its Q
// rows (at q_s) and of the K tile (at k_s)
template <int KP>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_s,
                                         uint32_t k_s) {
  using namespace hopper;
  reg_fence(s);
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < KP; ++p)
#pragma unroll
    for (int kk = 0; kk < PANEL / 16; ++kk)
      wgmma_ss_m64n64<0>(s, desc128(q_s + p * TILE + kk * 32, 16, 1024),
                         desc128(k_s + p * TILE + kk * 32, 16, 1024), p + kk);
  wgmma_commit();
  reg_fence(s);
}

// O (64 rows x NC columns) += P (bf16 in registers: the A fragments of
// the tile's four 16-key parts) V (NC / 64 panels at v_s)
template <int NC>
__device__ __forceinline__ void issue_pv(float (&acc)[NC / 2],
                                         const uint32_t (&pa)[4][4],
                                         uint32_t v_s) {
  using namespace hopper;
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<NC, 1>(acc, pa[kk], desc128(v_s + kk * 16 * 128, TILE, 1024),
                    1);
  wgmma_commit();
  reg_fence(acc);
}

// 2^x on the SFU (ex2.approx.ftz, as exp2f is for normal results; a
// result below 2^-126 flushes to 0 instead of taking exp2f's slow path)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the rows' accumulators times the rescale factors of their new maxima
template <int NC>
__device__ __forceinline__ void rescale(float (&acc)[NC / 2], float al_lo,
                                        float al_hi) {
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    acc[4 * j] *= al_lo;
    acc[4 * j + 1] *= al_lo;
    acc[4 * j + 2] *= al_hi;
    acc[4 * j + 3] *= al_hi;
  }
}

// named barriers 1 .. NCONS: consumer c may issue its wgmma (the one
// before it has issued its own); they take turns, so that one consumer's
// softmax runs while another's products keep the tensor cores busy
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (c + 1) % NCONS)
               : "memory");
}

// grid (query tiles of 128 rows, n_split, B * H * column blocks)
template <typename Tag, int KP, int NC>
__global__ void __launch_bounds__(WS_THREADS, 1)
    memory_read_ws(__grid_constant__ const Maps maps, const ReadArgs a,
                   const OutArgs o) {
  using namespace hopper;
  using S = WsSmem<KP, NC>;
  constexpr int NPV = S::NPV;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ int live[MAX_T], slot_pos[MAX_T];
  __shared__ int n_live_s;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + S::bar);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int H = a.H, T_cap = a.T_cap, HWq = a.HWq, HWk = a.HWk, D = a.D;
  const int cb = blockIdx.z % a.ncb, bh = blockIdx.z / a.ncb;
  const int b = bh / H, h = bh % H, u = blockIdx.y;
  const int q0 = blockIdx.x * WS_ROWS;
  const int n_kt = (HWk + BK - 1) / BK;
  const bool direct = a.n_split == 1;   // this unit covers the bank
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t < T_cap; ++t) {
      const bool on = a.valid[b * T_cap + t] != 0;
      slot_pos[t] = on ? n : -1;
      if (on) live[n++] = t;
    }
    n_live_s = n;
    bar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full_k[s], 1);
      bar_init(&full_v[s], 1);
      bar_init(&empty_k[s], 4 * NCONS);   // one arrival a consumer warp
      bar_init(&empty_v[s], 4 * NCONS);
    }
    bar_init_fence();
  }
  __syncthreads();
  int w0, w1;
  unit_range(n_live_s * n_kt, a.n_split, u, w0, w1);
  if (w0 == w1 && !direct) return;          // block-uniform
  const int n_tiles = w1 - w0;

  // the warpgroup's role, warp-uniform as the compiler sees it (so that
  // it allocates each role's registers after its setmaxnreg)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == NCONS) {
    // -------------------------------------------- producer warpgroup
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x % 128 != 0) return;
    bar_expect(full_q, NCONS * KP * TILE);
#pragma unroll
    for (int r = 0; r < NCONS; ++r)
#pragma unroll
      for (int p = 0; p < KP; ++p)
        tma_load_3d(smem + S::q + (r * KP + p) * TILE, &maps.q, full_q,
                    h * D + p * PANEL, q0 + r * 64, b);
    int n_panels = 0;
    for (int j = 0; j < NPV; ++j)
      n_panels += panel_of(a, h, cb * NPV + j).width > 0;
    // K runs a tile ahead of V: a consumer's turn takes V of tile n and
    // K of tile n + 1
    for (int n = 0; n <= n_tiles; ++n) {
      if (n < n_tiles) {
        const int s = n % STAGES, w = w0 + n;
        bar_wait(&empty_k[s], ((n / STAGES) & 1) ^ 1);
        bar_expect(&full_k[s], KP * TILE);
#pragma unroll
        for (int p = 0; p < KP; ++p)
          tma_load_3d(smem + S::k + (s * KP + p) * TILE, &maps.k, &full_k[s],
                      h * D + p * PANEL, (w % n_kt) * BK,
                      b * T_cap + live[w / n_kt]);
      }
      if (n > 0) {
        const int m = n - 1, s = m % STAGES, w = w0 + m;
        const int kbase = (w % n_kt) * BK, slot = b * T_cap + live[w / n_kt];
        bar_wait(&empty_v[s], ((m / STAGES) & 1) ^ 1);
        bar_expect(&full_v[s], n_panels * TILE);
        for (int j = 0; j < NPV; ++j) {
          const Panel pn = panel_of(a, h, cb * NPV + j);
          if (pn.width > 0)
            tma_load_3d(smem + S::v + (s * NPV + j) * TILE,
                        pn.bank ? &maps.v2 : &maps.v1, &full_v[s], pn.src,
                        kbase, slot);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    regs_inc<CONSUMER_REGS>();
    const int c = role, tid = threadIdx.x % 128;
    const int lane = tid % 32, warp = tid / 32;
    // this thread's rows within the block, and in the read
    const int r_lo = c * 64 + warp * 16 + lane / 4, r_hi = r_lo + 8;
    const int HD = H * D;
    const bool keeper = cb == 0;    // writes m and the slot records
    const uint32_t q_s = smem_u32(smem + S::q) + c * KP * TILE;
    const uint32_t k_s = smem_u32(smem + S::k), v_s = smem_u32(smem + S::v);
    float2* ml_s = reinterpret_cast<float2*>(smem + S::ml);

    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
    float s[32];          // S of a tile
    uint32_t pa[4][4];    // its p as the bf16 A fragments of its P.V
    float m_lo = M_INIT, m_hi = M_INIT, l_lo = 0.f, l_hi = 0.f;
    float lt_lo = 0.f, lt_hi = 0.f, pc_lo = 0.f, pc_hi = 0.f;
    float al_lo = 1.f, al_hi = 1.f;   // the rescale P.V of a tile waits for

    bar_wait(full_q, 0);
    if (D < PANEL) {    // Q's columns past D, the next heads' or zeros: 0
      const int chunks = (PANEL - D) / 8;
      for (int i = tid; i < 64 * chunks; i += 128) {
        const int r = i / chunks, col = D + (i % chunks) * 8;
        *reinterpret_cast<uint4*>(smem + S::q + c * KP * TILE +
                                  swizzle128(r, col)) = make_uint4(0, 0, 0, 0);
      }
      fence_proxy_async();
      named_bar(1 + NCONS + c, 128);
    }

    // The temporal-PE logit terms of this thread's rows for the live
    // slots of the unit: q.pe_t in f32 from the bf16 q, summed over the
    // quad, into shared memory ahead of the loop
    float* pc_s = reinterpret_cast<float*>(smem + S::pc);
    if (a.pe != nullptr && n_tiles > 0) {
      for (int pos = w0 / n_kt; pos <= (w1 - 1) / n_kt; ++pos) {
        const float* pe_t =
            a.pe + ((size_t)b * T_cap + live[pos]) * HD + h * D;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? r_hi : r_lo, row = q0 + r;
          float sum = 0.f;
          if (row < HWq) {
            const bf16* qr = a.q + ((size_t)b * HWq + row) * HD + h * D;
            for (int d = lane % 4; d < D; d += 4)
              sum += __bfloat162float(qr[d]) * pe_t[d];
          }
          sum = quad_sum(sum);
          if (lane % 4 == 0) pc_s[pos * WS_ROWS + r] = sum;
        }
      }
      __syncwarp();
    }

    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) bar_arrive(bar);
    };

    // The online softmax of tile k, S in s: p into pa, the new running
    // max, sums and rescale factor, the slot record where a slot ends
    // (live slot, key tile) of the tile the next softmax takes, stepped
    // along without a division
    int pos = w0 / n_kt, kt = w0 % n_kt;
    auto softmax = [&](int k) {
      const int kbase = kt * BK;
      if (k == 0 || kt == 0) {     // a slot starts: its p-sum and PE term
        lt_lo = lt_hi = 0.f;
        if (a.pe != nullptr) {
          pc_lo = pc_s[pos * WS_ROWS + r_lo];
          pc_hi = pc_s[pos * WS_ROWS + r_hi];
        }
      }
      if (kbase + BK > HWk) {      // the ragged tail: logit -inf, never 0
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (kbase + j * 8 + (lane % 4) * 2 + e >= HWk)
              s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx_lo = fmaxf(mx_lo, s[4 * j + e]);
          mx_hi = fmaxf(mx_hi, s[4 * j + 2 + e]);
        }
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo) + pc_lo);
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi) + pc_hi);
      // p = e^(s + pc - m) = 2^(s log2e + (pc - m) log2e), rounded to
      // bf16 at once into the A fragments of P.V: 16-key part kk holds
      // keys 16 kk + {2 (lane % 4), + 8} of both rows
      const float c_lo = (pc_lo - mn_lo) * LOG2E;
      const float c_hi = (pc_hi - mn_hi) * LOG2E;
      float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float* sj = s + 8 * kk + 4 * jj;
          const float p0 = exp2_ftz(fmaf(sj[0], LOG2E, c_lo));
          const float p1 = exp2_ftz(fmaf(sj[1], LOG2E, c_lo));
          const float p2 = exp2_ftz(fmaf(sj[2], LOG2E, c_hi));
          const float p3 = exp2_ftz(fmaf(sj[3], LOG2E, c_hi));
          ps_lo += p0;
          ps_hi += p2;
          ps_lo += p1;
          ps_hi += p3;
          pa[kk][2 * jj] = pack_bf16(p0, p1);
          pa[kk][2 * jj + 1] = pack_bf16(p2, p3);
        }
      ps_lo = quad_sum(ps_lo);
      ps_hi = quad_sum(ps_hi);
      al_lo = exp2_ftz((m_lo - mn_lo) * LOG2E);
      al_hi = exp2_ftz((m_hi - mn_hi) * LOG2E);
      l_lo = l_lo * al_lo + ps_lo;
      l_hi = l_hi * al_hi + ps_hi;
      lt_lo = lt_lo * al_lo + ps_lo;
      lt_hi = lt_hi * al_hi + ps_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
      if ((kt == n_kt - 1 || k == n_tiles - 1) && lane % 4 == 0) {
        // the slot's share in this unit ends
        ml_s[pos * WS_ROWS + r_lo] = make_float2(m_lo, lt_lo);
        ml_s[pos * WS_ROWS + r_hi] = make_float2(m_hi, lt_hi);
      }
      if (++kt == n_kt) {
        kt = 0;
        ++pos;
      }
    };

    // P.V of tile n and Q.K^T of tile n + 1 go to the tensor cores
    // together, in this consumer's turn; its softmax of tile n + 1 runs
    // in the other consumers' turns
    if (c == NCONS - 1) turn_pass(c);     // consumer 0 issues first
    if (n_tiles > 0) {
      turn_wait(c);
      bar_wait(&full_k[0], 0);
      issue_qk<KP>(s, q_s, k_s);
      turn_pass(c);
      wgmma_wait<0>();
      reg_fence(s);
      release(&empty_k[0]);
      softmax(0);
    }
    for (int n = 0; n + 1 < n_tiles; ++n) {
      const int st = n % STAGES, st1 = (n + 1) % STAGES;
      turn_wait(c);
      rescale<NC>(acc, al_lo, al_hi);
      bar_wait(&full_v[st], (n / STAGES) & 1);
      issue_pv<NC>(acc, pa, v_s + st * NPV * TILE);
      bar_wait(&full_k[st1], ((n + 1) / STAGES) & 1);
      issue_qk<KP>(s, q_s, k_s + st1 * KP * TILE);
      turn_pass(c);
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(s);
      release(&empty_v[st]);
      release(&empty_k[st1]);
      softmax(n + 1);
    }
    if (n_tiles > 0) {
      const int n = n_tiles - 1, st = n % STAGES;
      turn_wait(c);
      rescale<NC>(acc, al_lo, al_hi);
      bar_wait(&full_v[st], (n / STAGES) & 1);
      issue_pv<NC>(acc, pa, v_s + st * NPV * TILE);
      turn_pass(c);
      wgmma_wait<0>();
      reg_fence(acc);
      release(&empty_v[st]);
    }
    if (c == 0) turn_wait(0);     // takes the last consumer's last pass

    // -------------------------------------------------------- epilogue
    // The slot records, and the mass or the unit's m
    if (keeper) {
      __syncwarp();      // the slot records of this warp's rows are in
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r_hi : r_lo, row = q0 + r;
        const float m = half ? m_hi : m_lo;
        const float d = fmaxf(half ? l_hi : l_lo, 1e-30f);
        if (row >= HWq) continue;
        if (direct) {
          float* mass = o.mass + (((size_t)b * H + h) * HWq + row) * T_cap;
          for (int t = lane % 4; t < T_cap; t += 4) {
            const int p = slot_pos[t];
            float v = 0.f;
            if (p >= 0) {
              const float2 ml = ml_s[p * WS_ROWS + r];
              v = expf(ml.x - m) * ml.y / d;
            }
            mass[t] = v;
          }
        } else if (lane % 4 == 0) {
          a.part_m[(((size_t)b * H + h) * a.n_split + u) * HWq + row] = m;
          for (int pos = w0 / n_kt; pos <= (w1 - 1) / n_kt; ++pos)
            *slot_rec(a, b, h, u, row, live[pos]) = ml_s[pos * WS_ROWS + r];
        }
      }
    }
    // O through shared memory (the Q, K and V tiles, free now), 64
    // columns at a time: normalised outputs in the output type, or the
    // unit's f32 partial accumulator; rows of contiguous 16-byte stores
    constexpr int EW = 64;
    constexpr int LDO = EW + 8;    // floats a staged row
    static_assert(NCONS * 64 * LDO * 4 <= S::ml - S::q, "staging fits");
    float* stage = reinterpret_cast<float*>(smem + S::q) + c * 64 * LDO;
    const float d_lo = direct ? fmaxf(l_lo, 1e-30f) : 1.f;
    const float d_hi = direct ? fmaxf(l_hi, 1e-30f) : 1.f;
    const int HC = H * a.cph;
    float* part = a.part_acc + ((size_t)b * a.n_split + u) * HWq * HC;
    named_bar(2 * NCONS + 1, 128 * NCONS);   // all products are done
#pragma unroll
    for (int i = 0; i < NC / EW; ++i) {
#pragma unroll
      for (int jj = 0; jj < EW / 8; ++jj) {
        const int j = i * (EW / 8) + jj;        // 8-column group of O
        const int col = jj * 8 + (lane % 4) * 2;
        const int rl = r_lo - c * 64, rh = r_hi - c * 64;
        *reinterpret_cast<float2*>(stage + rl * LDO + col) =
            make_float2(acc[4 * j] / d_lo, acc[4 * j + 1] / d_lo);
        *reinterpret_cast<float2*>(stage + rh * LDO + col) =
            make_float2(acc[4 * j + 2] / d_hi, acc[4 * j + 3] / d_hi);
      }
      named_bar(1 + NCONS + c, 128);   // this consumer's rows are in
      for (int e = tid; e < 64 * (EW / 4); e += 128) {
        const int r = e / (EW / 4), cc = (e % (EW / 4)) * 4;
        const int row = q0 + c * 64 + r;
        const int bc = i * EW + cc;             // column of the block
        const Panel pn = panel_of(a, h, cb * NPV + bc / PANEL);
        if (row >= HWq || bc % PANEL >= pn.width) continue;
        const int hc = h * a.cph + pn.col + bc % PANEL;  // of [o1 | o2]
        float v[4];
        load4(stage + r * LDO + cc, v);
        if (!direct) {
          store4(part + (size_t)row * HC + hc, v);
          continue;
        }
        const bool first = hc < o.wo1;
        const int ld = first ? o.wo1 : o.wo2, x = first ? hc : hc - o.wo1;
        const size_t at = ((size_t)b * HWq + row) * ld + x;
        if (o.bf16)
          store4(static_cast<bf16*>(first ? o.o1 : o.o2) + at, v);
        else
          store4(static_cast<float*>(first ? o.o1 : o.o2) + at, v);
      }
      named_bar(1 + NCONS + c, 128);   // read out before the next part
    }
  }
}

// ----------------------------------------------------------- small heads
namespace heads {

constexpr int RW = 4;              // row warps, 16 query rows each
constexpr int HWN = 4;             // head warps
constexpr int HPW = 2;             // heads per warp
constexpr int HPB = HWN * HPW;     // heads per block

// KD = D / 16, NP = padded value width per head / 16
template <int KD, int NP>
struct Smem {
  static constexpr int D = 16 * KD;
  static constexpr int CP = 16 * NP;
  static constexpr int LDK = HPB * D + PAD;
  static constexpr int LDV = HPB * CP + PAD;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * BQ * LDK;
  static constexpr size_t v = k + sizeof(bf16) * 2 * BK * LDK;
  static constexpr size_t bytes = v + sizeof(bf16) * 2 * BK * LDV;
};

// grid (query tiles, n_split, B * head groups)
template <typename Tag, int KD, int NP>
__global__ void __launch_bounds__(NT, 1)
    memory_read_heads(const ReadArgs a) {
  using S = Smem<KD, NP>;
  constexpr int D = S::D, CP = S::CP, LDK = S::LDK, LDV = S::LDV;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + S::q);
  bf16* ks = reinterpret_cast<bf16*>(smem + S::k);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::v);
  __shared__ int live[MAX_T];
  __shared__ int n_live_s;

  const int H = a.H, T_cap = a.T_cap, HWq = a.HWq, HWk = a.HWk;
  const int cph = a.cph;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % RW, hw = warp / RW;
  const int n_hg = (H + HPB - 1) / HPB;
  const int b = blockIdx.z / n_hg, hg = blockIdx.z % n_hg, u = blockIdx.y;
  const int h0 = hg * HPB;                // the block's first head
  const int q0 = blockIdx.x * BQ;
  const int HD = H * D;
  const int n_kt = (HWk + BK - 1) / BK;
  int w0, w1;
  unit_range(live_slots(a, b, live, &n_live_s) * n_kt, a.n_split, u, w0, w1);
  if (w0 == w1) return;                   // block-uniform

  for (int i = tid; i < BQ * HPB * (D / 8); i += NT) {
    const int r = i / (HPB * (D / 8)), c = (i % (HPB * (D / 8))) * 8;
    const bool ok = q0 + r < HWq && h0 * D + c < HD;
    cp_async16(&qs[r * LDK + c],
               ok ? a.q + ((size_t)b * HWq + q0 + r) * HD + h0 * D + c : a.q,
               ok);
  }
  if (cph < CP)  // the padding columns of each head stay zero
    for (int i = tid; i < 2 * BK * HPB * (CP - cph); i += NT) {
      const int row = i / (HPB * (CP - cph)), rest = i % (HPB * (CP - cph));
      vs[row * LDV + (rest / (CP - cph)) * CP + cph + rest % (CP - cph)] =
          __float2bfloat16(0.f);
    }

  const int n_tiles = w1 - w0;
  // value chunks of 8 columns per key row; when they divide the block, a
  // thread stages the same chunk of every row (no division in the loop)
  const int vchunks = HPB * (cph / 8);
  const bool v_fixed = NT % vchunks == 0;
  const int vq = tid % vchunks, v_hl = vq / (cph / 8);
  const int v_c = (vq % (cph / 8)) * 8;
  const bool v_head = h0 + v_hl < H;
  const int v_gc = (h0 + v_hl) * cph + v_c;
  auto issue = [&](int n) {
    const int t = live[(w0 + n) / n_kt], kbase = ((w0 + n) % n_kt) * BK;
    const size_t key0 = ((size_t)b * T_cap + t) * HWk;
    bf16* kst = ks + (n % 2) * BK * LDK;
    bf16* vst = vs + (n % 2) * BK * LDV;
    for (int i = tid; i < BK * HPB * (D / 8); i += NT) {
      const int j = i / (HPB * (D / 8)), c = (i % (HPB * (D / 8))) * 8;
      const bool ok = kbase + j < HWk && h0 * D + c < HD;
      cp_async16(&kst[j * LDK + c],
                 ok ? a.k + (key0 + kbase + j) * HD + h0 * D + c : a.k, ok);
    }
    if (v_fixed) {
      for (int j = tid / vchunks; j < BK; j += NT / vchunks) {
        const bool ok = v_head && kbase + j < HWk;
        cp_async16(&vst[j * LDV + v_hl * CP + v_c],
                   v_src(a, v_gc, key0 + kbase + j, ok), ok);
      }
    } else {
      for (int i = tid; i < BK * vchunks; i += NT) {
        const int j = i / vchunks, hl = (i % vchunks) / (cph / 8);
        const int c = (i % (cph / 8)) * 8;
        const bool ok = kbase + j < HWk && h0 + hl < H;
        cp_async16(&vst[j * LDV + hl * CP + c],
                   v_src(a, (h0 + hl) * cph + c, key0 + kbase + j, ok), ok);
      }
    }
  };

  const int r_lo = rw * 16 + lane / 4, r_hi = r_lo + 8;
  float m[HPW][2], l[HPW][2], lt[HPW][2], pc[HPW][2];
  float acc[HPW][2 * NP][4];
#pragma unroll
  for (int hp = 0; hp < HPW; ++hp) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[hp][r] = M_INIT;
      l[hp][r] = lt[hp][r] = pc[hp][r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hp][j][e] = 0.f;
  }

  issue(0);
  cp_async_commit();
  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<0>();
    // tile n (and the q tile) is in shared memory, and every warp is done
    // with tile n - 1, whose stage the copy of tile n + 1 now refills
    __syncthreads();
    if (n + 1 < n_tiles) {
      issue(n + 1);
      cp_async_commit();
    }
    const int w = w0 + n, kt = w % n_kt, kbase = kt * BK;
    const int t = live[w / n_kt];
    const bf16* kst = ks + (n % 2) * BK * LDK;
    const bf16* vst = vs + (n % 2) * BK * LDV;
#pragma unroll
    for (int hp = 0; hp < HPW; ++hp) {
      const int hl = hw * HPW + hp, hh = h0 + hl;
      if (hh >= H) continue;                // warp-uniform
      if (n == 0 || kt == 0) {  // a slot starts
        lt[hp][0] = lt[hp][1] = 0.f;
        if (a.pe != nullptr) {
          const float* pe_t = a.pe + ((size_t)b * T_cap + t) * HD + hh * D;
          pc[hp][0] = pe_term(qs + hl * D, LDK, r_lo, pe_t, D, lane);
          pc[hp][1] = pe_term(qs + hl * D, LDK, r_hi, pe_t, D, lane);
        }
      }
      // S = Q K^T: 16 rows x 64 keys, eight n-tiles of 8
      float s[BK / 8][4];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qa[4];
        ldmatrix_x4(qa, &qs[(rw * 16 + (lane % 16)) * LDK + hl * D +
                            kk * 16 + (lane / 16) * 8]);
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t kb[4];
          ldmatrix_x4(kb, &kst[(np * 16 + (lane % 8) + (lane / 16) * 8) *
                                   LDK +
                               hl * D + kk * 16 + ((lane / 8) % 2) * 8]);
          mma(s[2 * np], qa, kb[0], kb[1]);
          mma(s[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
      // online softmax over the tile, in registers; the PE term is
      // constant along a row, so it joins at the row maximum
      if (kbase + BK > HWk) {  // the ragged tail: logit -inf, never 0
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (kbase + nt * 8 + (lane % 4) * 2 + e >= HWk)
              s[nt][e] = s[nt][2 + e] = -INFINITY;
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx_lo = fmaxf(mx_lo, s[nt][e]);
          mx_hi = fmaxf(mx_hi, s[nt][2 + e]);
        }
      const float mn_lo = fmaxf(m[hp][0], quad_max(mx_lo) + pc[hp][0]);
      const float mn_hi = fmaxf(m[hp][1], quad_max(mx_hi) + pc[hp][1]);
      // p = e^(s + pc - m) = 2^(s log2e + (pc - m) log2e)
      const float c_lo = (pc[hp][0] - mn_lo) * LOG2E;
      const float c_hi = (pc[hp][1] - mn_hi) * LOG2E;
      float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] = exp2f(fmaf(s[nt][e], LOG2E, c_lo));
          s[nt][2 + e] = exp2f(fmaf(s[nt][2 + e], LOG2E, c_hi));
          ps_lo += s[nt][e];
          ps_hi += s[nt][2 + e];
        }
      ps_lo = quad_sum(ps_lo);
      ps_hi = quad_sum(ps_hi);
      const float a_lo = exp2f((m[hp][0] - mn_lo) * LOG2E);
      const float a_hi = exp2f((m[hp][1] - mn_hi) * LOG2E);
      l[hp][0] = l[hp][0] * a_lo + ps_lo;
      l[hp][1] = l[hp][1] * a_hi + ps_hi;
      lt[hp][0] = lt[hp][0] * a_lo + ps_lo;
      lt[hp][1] = lt[hp][1] * a_hi + ps_hi;
      m[hp][0] = mn_lo;
      m[hp][1] = mn_hi;
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j) {
        acc[hp][j][0] *= a_lo;
        acc[hp][j][1] *= a_lo;
        acc[hp][j][2] *= a_hi;
        acc[hp][j][3] *= a_hi;
      }
      // O += P V, P rounded to bf16 straight from the S fragments
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int jp = 0; jp < NP; ++jp) {
          uint32_t vb[4];
          ldmatrix_x4_trans(
              vb, &vst[(kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDV +
                       hl * CP + jp * 16 + (lane / 16) * 8]);
          mma(acc[hp][2 * jp], pa, vb[0], vb[1]);
          mma(acc[hp][2 * jp + 1], pa, vb[2], vb[3]);
        }
      }
      if ((kt == n_kt - 1 || n == n_tiles - 1) && lane % 4 == 0) {
        if (q0 + r_lo < HWq)
          *slot_rec(a, b, hh, u, q0 + r_lo, t) =
              make_float2(m[hp][0], lt[hp][0]);
        if (q0 + r_hi < HWq)
          *slot_rec(a, b, hh, u, q0 + r_hi, t) =
              make_float2(m[hp][1], lt[hp][1]);
      }
    }
  }

  const int HC = H * cph;
  const int row_lo = q0 + r_lo, row_hi = q0 + r_hi;
  float* pa_ = a.part_acc + ((size_t)b * a.n_split + u) * HWq * HC;
#pragma unroll
  for (int hp = 0; hp < HPW; ++hp) {
    const int hh = h0 + hw * HPW + hp;
    if (hh >= H) continue;
    if (lane % 4 == 0) {
      float* pm = a.part_m + (((size_t)b * H + hh) * a.n_split + u) * HWq;
      if (row_lo < HWq) pm[row_lo] = m[hp][0];
      if (row_hi < HWq) pm[row_hi] = m[hp][1];
    }
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) {
      const int c = j * 8 + (lane % 4) * 2;
      if (c < cph) {
        const int gc = hh * cph + c;
        if (row_lo < HWq)
          store2(pa_ + (size_t)row_lo * HC + gc, acc[hp][j][0],
                 acc[hp][j][1]);
        if (row_hi < HWq)
          store2(pa_ + (size_t)row_hi * HC + gc, acc[hp][j][2],
                 acc[hp][j][3]);
      }
    }
  }
}

}  // namespace heads

// --------------------------------------------------------------- combine
constexpr int NT_COMBINE = 256;

// grid (HWq, B): one block per query row. Per head, M = max m_t and
// L = sum e^(m_t - M) l_t over the slot records of every unit; then the
// threads run over 4-column groups of [o1 | o2] and over (head, slot) for
// the mass.
template <typename Tag, typename TO>
__global__ void __launch_bounds__(NT_COMBINE)
    memory_read_combine(const ReadArgs a, const OutArgs o) {
  __shared__ int live[MAX_T];
  __shared__ int n_live_s;
  __shared__ float M_s[MAX_H], L_s[MAX_H];
  const int row = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int H = a.H, HWq = a.HWq, T_cap = a.T_cap, HC = H * a.cph;
  const int ns = a.n_split, n_kt = (a.HWk + BK - 1) / BK;
  const int n_work = live_slots(a, b, live, &n_live_s) * n_kt;
  for (int h = tid; h < H; h += NT_COMBINE) {
    float M = M_INIT, L = 0.f;
    for (int pass = 0; pass < 2; ++pass)
      for (int u = 0; u < ns; ++u) {
        int w0, w1;
        unit_range(n_work, ns, u, w0, w1);
        if (w0 == w1) continue;
        for (int r = w0 / n_kt; r <= (w1 - 1) / n_kt; ++r) {
          const float2 ml = *slot_rec(a, b, h, u, row, live[r]);
          if (pass == 0)
            M = fmaxf(M, ml.x);
          else
            L += expf(ml.x - M) * ml.y;
        }
      }
    M_s[h] = M;
    L_s[h] = L;
  }
  __syncthreads();
  for (int c = tid * 4; c < HC; c += NT_COMBINE * 4) {
    const int h = c / a.cph;
    float out[4] = {0.f, 0.f, 0.f, 0.f};
    for (int u = 0; u < ns; ++u) {
      int w0, w1;
      unit_range(n_work, ns, u, w0, w1);
      if (w0 == w1) continue;               // the unit did not run
      const float w = expf(
          a.part_m[(((size_t)b * H + h) * ns + u) * HWq + row] - M_s[h]);
      const float4 p = *reinterpret_cast<const float4*>(
          a.part_acc + (((size_t)b * ns + u) * HWq + row) * HC + c);
      out[0] += w * p.x;
      out[1] += w * p.y;
      out[2] += w * p.z;
      out[3] += w * p.w;
    }
    const float d = fmaxf(L_s[h], 1e-30f);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] /= d;
    if (c < o.wo1)
      store4(static_cast<TO*>(o.o1) + ((size_t)b * HWq + row) * o.wo1 + c,
             out);
    else
      store4(static_cast<TO*>(o.o2) + ((size_t)b * HWq + row) * o.wo2 +
                 (c - o.wo1),
             out);
  }
  for (int i = tid; i < H * T_cap; i += NT_COMBINE) {
    const int h = i / T_cap, t = i % T_cap;
    float mass = 0.f;
    for (int u = 0; u < ns; ++u) {
      int w0, w1;
      unit_range(n_work, ns, u, w0, w1);
      if (w0 == w1) continue;
      for (int r = w0 / n_kt; r <= (w1 - 1) / n_kt; ++r)
        if (live[r] == t) {
          const float2 ml = *slot_rec(a, b, h, u, row, t);
          mass += expf(ml.x - M_s[h]) * ml.y;
        }
    }
    o.mass[(((size_t)b * H + h) * HWq + row) * T_cap + t] =
        mass / fmaxf(L_s[h], 1e-30f);
  }
}

// The kernel proper. Tag names the caller (FusedRead: B1, AttentionRead:
// B3) so that each shows under its own name in a profile.
struct FusedRead {};
struct AttentionRead {};

// Raise kernel K's dynamic shared-memory limit once, then launch it.
template <auto K, typename... Args>
cudaError_t launch_dyn(dim3 grid, int threads, size_t smem, cudaStream_t st,
                       const Args&... args) {
  static bool raised = false;  // one flag per kernel instantiation
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        K, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised = true;
  }
  K<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// Registers, shared memory (static + dynamic) and local (spill) bytes per
// thread of kernel K.
template <auto K>
cudaError_t info_of(size_t smem, int out[3]) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, K);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes + smem);
  out[2] = static_cast<int>(fa.localSizeBytes);
  return cudaSuccess;
}

// The wide-head kernel's block width NC for a head of `panels` value
// panels: 64 columns where one panel holds the head, else 128 over as
// many column blocks as it takes.
inline int block_cols(int panels) { return panels <= 1 ? 64 : 128; }

// One body for launching and for reporting the kernel a set of arguments
// selects: heads_per_block 8 picks memory_read_heads (D <= 32, cph <= 32),
// 0 memory_read_ws (D in {16, 32, 64, 128}). `maps` is read only to
// launch memory_read_ws.
template <typename Tag, bool INFO>
cudaError_t dispatch(const ReadArgs& a, const Maps& maps, const OutArgs& o,
                     int B, int heads_per_block, cudaStream_t st,
                     int info[3]) {
  const int n_qt = (a.HWq + BQ - 1) / BQ;
  if (heads_per_block == heads::HPB && a.cph <= 32) {
#define RMEM_GO(KERNEL, SMEM)                                     \
  return INFO ? info_of<KERNEL>(SMEM, info)                       \
              : launch_dyn<KERNEL>(grid, NT, SMEM, st, a)
    const dim3 grid(n_qt, a.n_split,
                    B * ((a.H + heads::HPB - 1) / heads::HPB));
    if (a.D == 16 && a.cph <= 16)
      RMEM_GO((heads::memory_read_heads<Tag, 1, 1>),
              (heads::Smem<1, 1>::bytes));
    if (a.D == 16)
      RMEM_GO((heads::memory_read_heads<Tag, 1, 2>),
              (heads::Smem<1, 2>::bytes));
    if (a.D == 32 && a.cph <= 16)
      RMEM_GO((heads::memory_read_heads<Tag, 2, 1>),
              (heads::Smem<2, 1>::bytes));
    if (a.D == 32)
      RMEM_GO((heads::memory_read_heads<Tag, 2, 2>),
              (heads::Smem<2, 2>::bytes));
#undef RMEM_GO
    return cudaErrorInvalidValue;
  }
  if (heads_per_block != 0 ||
      (a.D != 16 && a.D != 32 && a.D != 64 && a.D != 128))
    return cudaErrorInvalidValue;
  ReadArgs w = a;
  const int panels = value_panels(a), nc = block_cols(panels);
  w.ncb = (panels + nc / PANEL - 1) / (nc / PANEL);
  const dim3 grid((a.HWq + WS_ROWS - 1) / WS_ROWS, a.n_split,
                  B * a.H * w.ncb);
#define RMEM_WS(KP, NC)                                                 \
  return INFO ? info_of<memory_read_ws<Tag, KP, NC>>(                   \
                    WsSmem<KP, NC>::bytes, info)                        \
              : launch_dyn<memory_read_ws<Tag, KP, NC>>(                \
                    grid, WS_THREADS, WsSmem<KP, NC>::bytes, st, maps, w, o)
  if (a.D == 128) {
    if (nc == 64) RMEM_WS(2, 64);
    RMEM_WS(2, 128);
  }
  if (nc == 64) RMEM_WS(1, 64);
  RMEM_WS(1, 128);
#undef RMEM_WS
  return cudaErrorInvalidValue;
}

// The read on `st`: one launch of the wide-head kernel at n_split == 1,
// else the split read and its combine.
template <typename Tag>
cudaError_t launch(const ReadArgs& a, const OutArgs& o, int B,
                   int heads_per_block, cudaStream_t st) {
  if (a.T_cap > MAX_T || a.H > MAX_H || a.n_split < 1 || a.cph % 8 ||
      a.wv1 % 8 || a.wv2 % 8 || o.wo1 % 8 || a.wv1 + a.wv2 != a.H * a.cph ||
      o.wo1 + o.wo2 != a.H * a.cph)
    return cudaErrorInvalidValue;
  Maps maps = {};
  if (heads_per_block == 0) {
    using hopper::tensor_map;
    const uint64_t hd = (uint64_t)a.H * a.D, bt = (uint64_t)B * a.T_cap;
    cudaError_t err = tensor_map(&maps.q, a.q, hd, a.HWq, B);
    if (err == cudaSuccess) err = tensor_map(&maps.k, a.k, hd, a.HWk, bt);
    if (err == cudaSuccess)
      err = tensor_map(&maps.v1, a.v1, a.wv1, a.HWk, bt);
    if (err == cudaSuccess)
      err = a.v2 != nullptr ? tensor_map(&maps.v2, a.v2, a.wv2, a.HWk, bt)
                            : tensor_map(&maps.v2, a.v1, a.wv1, a.HWk, bt);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err =
      dispatch<Tag, false>(a, maps, o, B, heads_per_block, st, nullptr);
  if (err != cudaSuccess || (heads_per_block == 0 && a.n_split == 1))
    return err;
  if (o.bf16)
    memory_read_combine<Tag, bf16>
        <<<dim3(a.HWq, B), NT_COMBINE, 0, st>>>(a, o);
  else
    memory_read_combine<Tag, float>
        <<<dim3(a.HWq, B), NT_COMBINE, 0, st>>>(a, o);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace rmem
