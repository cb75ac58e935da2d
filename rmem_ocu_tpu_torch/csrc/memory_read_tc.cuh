// Tensor-core online-softmax read of the RMem bank, shared by kernel B1
// (memory_read.cu) and kernel B3 (memory_read_attention.cu).
//
// What bounds it on the H100: the main-path shapes do 7.8-19.5 GFLOP on
// 20-40 MB of bank, so the products are the bound (0.008-0.02 ms at the
// bf16 tensor-core rate). What held the first design 30-66x off it: 120
// blocks of 4 warps at B=1 (one per SM, nothing to hide a load behind),
// 32-key tiles loaded by the computing threads between two barriers, Q.K^T
// and the K loads repeated for each of 8 value chunks, 3/4 of the value
// tile zero at 8 heads of 32, and a per-tile walk over every slot's mass.
//
// The design here:
// - Split over slots, then combine. The work of a query tile is the
//   sequence of its live slots' 64-key tiles; a work unit is (b, head or
//   head group, 64 query rows, a contiguous 1/n_split share of that
//   sequence), so units are balanced whatever the number of live slots. A
//   unit keeps its own running max m, sum l and f32 output accumulator and
//   writes them unnormalised to scratch the wrapper allocates; where its
//   share of a slot ends it writes (m, l_t), l_t the p-sum of its share at
//   its running max. A second launch (`memory_read_combine`) merges the
//   units of a query row: M = max m_t, L = sum e^(m_t - M) l_t, out =
//   sum_u e^(m_u - M) acc_u / max(L, 1e-30), and the per-slot mass is
//   exactly the sum of e^(m_t - M) l_t over the slot's shares, over L,
//   with no per-tile bookkeeping. The wrapper picks n_split so that the
//   blocks fill the card's SMs in one round where the shape allows.
// - A cp.async ring: 64-key tiles of K and V, two stages in shared memory,
//   the copies of tile i+1 in flight while the tensor cores (mma.sync
//   m16n8k16, bf16 in, f32 accumulate) work on tile i. Ragged key rows and
//   columns outside a head are zero-filled by the copy itself.
// - Wide heads (`memory_read_wide`, D in {16..128}, any value width): 16
//   warps own 64 query rows x 512 value columns of one head. Q.K^T is
//   issued once per key tile and block: 4 row warps x 4 key warps each
//   compute 16 rows x 16 keys, exchange row maxima and sums through shared
//   memory and stage P once as bf16. P.V is then 2 row warps x 8 column
//   warps of 32 rows x 64 columns, so that each value fragment read from
//   shared memory feeds two products (shared-memory reads, not the tensor
//   cores, bound mma.sync here). DeAOT's V||ID_V (1024 columns) takes two
//   blocks, so Q.K^T runs twice per key tile, not eight times.
// - Small heads (`memory_read_heads`, D <= 32 and Dv <= 32, >= 4 heads):
//   one block owns 8 heads of a 64-row query tile, each warp 16 rows of
//   two heads with S, P and the online softmax in registers. A K or V row
//   of the 8 heads is one contiguous run (512 bytes at the AOT shape) and
//   the value tile is as wide as the heads, with no zero columns.
// - Products are mma.sync, not wgmma, in this design: each 16-row warp
//   reads its fragments from shared memory, and those reads, with one
//   block per SM (197 KB and 169 KB of ring) and a block barrier per
//   tile, bound a tile (PERF.md section 6). wgmma, which reads B from
//   shared memory once per 64-row warpgroup, fed by a TMA ring and a
//   producer warp, is the next step (ROADMAP queue B).
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
// outputs are divided by max(L, 1e-30). The tail of the last key tile
// (HWk = 920 tiles by no power of two) gets logit -inf, never 0. Dead
// slots (valid == 0) may sit anywhere and are skipped.
#pragma once

#include "common.cuh"

namespace rmem {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int MAX_T = 32;          // bank slots
constexpr float M_INIT = -1e30f;   // the Pallas kernels' running-max init
constexpr float LOG2E = 1.4426950408889634f;  // e^x = 2^(x log2e)
constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per tile
constexpr int NT = 512;            // threads per block (16 warps)
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
// [B, H, n_split, HWq, T] (m, l_t). wv1 + wv2 == H * cph; widths are
// multiples of 8.
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
};

// o1 [B, HWq, wo1], o2 [B, HWq, wo2] or null, mass [B, H, HWq, T] f32;
// wo1 + wo2 == H * cph.
template <typename TO>
struct OutArgs {
  TO* o1;
  TO* o2;
  float* mass;
  int wo1, wo2;
};

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

// ------------------------------------------------------------ wide heads
namespace wide {

// Q.K^T: 4 row warps x 4 key warps, each 16 rows x 16 keys of the tile
constexpr int RW = 4;
constexpr int KWN = 4;
constexpr int KPW = BK / KWN;
// P.V: 2 row warps x 8 column warps, each 32 rows x 64 columns, so that a
// value fragment read from shared memory serves two 16-row products
constexpr int PRW = 2;
constexpr int PCW = 8;
constexpr int PR = BQ / PRW;       // 32
constexpr int CW = 64;             // value columns per P.V warp
constexpr int BN = CW * PCW;       // value columns per block
constexpr int LDV = BN + PAD;
constexpr int LDP = BK + PAD;

template <int KD>
struct Smem {
  static constexpr int D = 16 * KD;
  static constexpr int LDK = D + PAD;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * BQ * LDK;
  static constexpr size_t v = k + sizeof(bf16) * 2 * BK * LDK;
  static constexpr size_t p = v + sizeof(bf16) * 2 * BK * LDV;
  static constexpr size_t red = p + sizeof(bf16) * BQ * LDP;
  // row maxima and sums of the key warps, then each row's rescale factor
  static constexpr size_t bytes = red + sizeof(float) * (2 * KWN + 1) * BQ;
};

// grid (query tiles, n_split, B * H * column blocks)
template <typename Tag, int KD>
__global__ void __launch_bounds__(NT, 1)
    memory_read_wide(const ReadArgs a) {
  using S = Smem<KD>;
  constexpr int D = S::D, LDK = S::LDK;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + S::q);
  bf16* ks = reinterpret_cast<bf16*>(smem + S::k);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::v);
  bf16* ps = reinterpret_cast<bf16*>(smem + S::p);
  float* red_max = reinterpret_cast<float*>(smem + S::red);
  float* red_sum = red_max + KWN * BQ;
  float* alpha_s = red_sum + KWN * BQ;
  __shared__ int live[MAX_T];
  __shared__ int n_live_s;

  const int H = a.H, T_cap = a.T_cap, HWq = a.HWq, HWk = a.HWk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % RW, kw = warp / RW;       // Q.K^T role
  const int prw = warp % PRW, pcw = warp / PRW;   // P.V role
  const int ncb = (a.cph + BN - 1) / BN;
  const int cb = blockIdx.z % ncb, bh = blockIdx.z / ncb;
  const int b = bh / H, h = bh % H, u = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int col0 = cb * BN;               // within the head's columns
  const int HD = H * D;
  const int n_kt = (HWk + BK - 1) / BK;
  int w0, w1;
  unit_range(live_slots(a, b, live, &n_live_s) * n_kt, a.n_split, u, w0, w1);
  if (w0 == w1) return;                   // block-uniform

  for (int i = tid; i < BQ * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool ok = q0 + r < HWq;
    cp_async16(&qs[r * LDK + c],
               ok ? a.q + ((size_t)b * HWq + q0 + r) * HD + h * D + c : a.q,
               ok);
  }
  // a thread stages the same 8 value columns of every tile
  static_assert(NT % (BN / 8) == 0, "a thread's value columns are fixed");
  const int vc = (tid % (BN / 8)) * 8;
  const bool v_cols = col0 + vc < a.cph;
  const int gvc = h * a.cph + col0 + vc;  // within [v1 | v2]

  const int n_tiles = w1 - w0;
  auto issue = [&](int n) {
    const int t = live[(w0 + n) / n_kt], kbase = ((w0 + n) % n_kt) * BK;
    const size_t key0 = ((size_t)b * T_cap + t) * HWk;
    bf16* kst = ks + (n % 2) * BK * LDK;
    bf16* vst = vs + (n % 2) * BK * LDV;
    for (int i = tid; i < BK * (D / 8); i += NT) {
      const int j = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = kbase + j < HWk;
      cp_async16(&kst[j * LDK + c],
                 ok ? a.k + (key0 + kbase + j) * HD + h * D + c : a.k, ok);
    }
    for (int j = tid / (BN / 8); j < BK; j += NT / (BN / 8)) {
      const bool ok = v_cols && kbase + j < HWk;
      cp_async16(&vst[j * LDV + vc], v_src(a, gvc, key0 + kbase + j, ok),
                 ok);
    }
  };

  // Q.K^T role: running max m, sum l and slot sum lt of rows r_lo, r_hi
  // (the four key warps of a row group keep identical copies)
  const int r_lo = rw * 16 + lane / 4, r_hi = r_lo + 8;
  float m_lo = M_INIT, m_hi = M_INIT, l_lo = 0.f, l_hi = 0.f;
  float lt_lo = 0.f, lt_hi = 0.f, pc_lo = 0.f, pc_hi = 0.f;
  // P.V role: rows prw * 32 + mi * 16 + {lane / 4, + 8}
  float acc[2][CW / 8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < CW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

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
    if (n == 0 || kt == 0) {  // a slot starts: its own p-sum and PE term
      lt_lo = lt_hi = 0.f;
      if (a.pe != nullptr) {
        const float* pe_t = a.pe + ((size_t)b * T_cap + t) * HD + h * D;
        pc_lo = pe_term(qs, LDK, r_lo, pe_t, D, lane);
        pc_hi = pe_term(qs, LDK, r_hi, pe_t, D, lane);
      }
    }
    const bf16* kst = ks + (n % 2) * BK * LDK;
    const bf16* vst = vs + (n % 2) * BK * LDV;

    // S = Q K^T for this warp's 16 rows and 16 keys (two n-tiles of 8),
    // without the PE term, which is constant along a row
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], kb[4];
      ldmatrix_x4(qa, &qs[(rw * 16 + (lane % 16)) * LDK + kk * 16 +
                          (lane / 16) * 8]);
      ldmatrix_x4(kb, &kst[(kw * KPW + (lane % 8) + (lane / 16) * 8) * LDK +
                           kk * 16 + ((lane / 8) % 2) * 8]);
      mma(s[0], qa, kb[0], kb[1]);
      mma(s[1], qa, kb[2], kb[3]);
    }
    if (kbase + BK > HWk) {  // the ragged tail: logit -inf, never 0
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (kbase + kw * KPW + nt * 8 + (lane % 4) * 2 + e >= HWk)
            s[nt][e] = s[nt][2 + e] = -INFINITY;
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx_lo = fmaxf(mx_lo, s[nt][e]);
        mx_hi = fmaxf(mx_hi, s[nt][2 + e]);
      }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    if (lane % 4 == 0) {
      red_max[kw * BQ + r_lo] = mx_lo;
      red_max[kw * BQ + r_hi] = mx_hi;
    }
    __syncthreads();  // every key warp's row maxima are in
#pragma unroll
    for (int c = 0; c < KWN; ++c) {
      mx_lo = fmaxf(mx_lo, red_max[c * BQ + r_lo]);
      mx_hi = fmaxf(mx_hi, red_max[c * BQ + r_hi]);
    }
    const float mn_lo = fmaxf(m_lo, mx_lo + pc_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi + pc_hi);
    // p = e^(s + pc - m) = 2^(s log2e + (pc - m) log2e)
    const float c_lo = (pc_lo - mn_lo) * LOG2E, c_hi = (pc_hi - mn_hi) * LOG2E;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = exp2f(fmaf(s[nt][e], LOG2E, c_lo));
        s[nt][2 + e] = exp2f(fmaf(s[nt][2 + e], LOG2E, c_hi));
        ps_lo += s[nt][e];
        ps_hi += s[nt][2 + e];
      }
      const int c = kw * KPW + nt * 8 + (lane % 4) * 2;
      *reinterpret_cast<uint32_t*>(&ps[r_lo * LDP + c]) =
          pack_bf16(s[nt][0], s[nt][1]);
      *reinterpret_cast<uint32_t*>(&ps[r_hi * LDP + c]) =
          pack_bf16(s[nt][2], s[nt][3]);
    }
    ps_lo = quad_sum(ps_lo);
    ps_hi = quad_sum(ps_hi);
    const float a_lo = exp2f((m_lo - mn_lo) * LOG2E);
    const float a_hi = exp2f((m_hi - mn_hi) * LOG2E);
    if (lane % 4 == 0) {
      red_sum[kw * BQ + r_lo] = ps_lo;
      red_sum[kw * BQ + r_hi] = ps_hi;
      if (kw == 0) {
        alpha_s[r_lo] = a_lo;
        alpha_s[r_hi] = a_hi;
      }
    }
    m_lo = mn_lo;
    m_hi = mn_hi;
    __syncthreads();  // P, the row sums and the rescale factors are in
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int c = 0; c < KWN; ++c) {
      sum_lo += red_sum[c * BQ + r_lo];
      sum_hi += red_sum[c * BQ + r_hi];
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
    lt_lo = lt_lo * a_lo + sum_lo;
    lt_hi = lt_hi * a_hi + sum_hi;
    if ((kt == n_kt - 1 || n == n_tiles - 1) && kw == 0 && cb == 0 &&
        lane % 4 == 0) {     // the slot's share in this unit ends
      if (q0 + r_lo < HWq)
        *slot_rec(a, b, h, u, q0 + r_lo, t) = make_float2(m_lo, lt_lo);
      if (q0 + r_hi < HWq)
        *slot_rec(a, b, h, u, q0 + r_hi, t) = make_float2(m_hi, lt_hi);
    }

    // O = O * alpha + P V over this warp's 32 rows and 64 columns
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = prw * PR + mi * 16 + lane / 4;
      const float al = alpha_s[r], ah = alpha_s[r + 8];
#pragma unroll
      for (int j = 0; j < CW / 8; ++j) {
        acc[mi][j][0] *= al;
        acc[mi][j][1] *= al;
        acc[mi][j][2] *= ah;
        acc[mi][j][3] *= ah;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(pa[mi], &ps[(prw * PR + mi * 16 + (lane % 16)) * LDP +
                                kk * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int jp = 0; jp < CW / 16; ++jp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, &vst[(kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDV +
                     pcw * CW + jp * 16 + (lane / 16) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[mi][2 * jp], pa[mi], vb[0], vb[1]);
          mma(acc[mi][2 * jp + 1], pa[mi], vb[2], vb[3]);
        }
      }
    }
  }

  if (kw == 0 && cb == 0 && lane % 4 == 0) {
    float* pm = a.part_m + (((size_t)b * H + h) * a.n_split + u) * HWq;
    if (q0 + r_lo < HWq) pm[q0 + r_lo] = m_lo;
    if (q0 + r_hi < HWq) pm[q0 + r_hi] = m_hi;
  }
  const int HC = H * a.cph;
  float* pa_ = a.part_acc + ((size_t)b * a.n_split + u) * HWq * HC;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int row = q0 + prw * PR + mi * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < CW / 8; ++j) {
      const int c = col0 + pcw * CW + j * 8 + (lane % 4) * 2;
      if (c < a.cph) {
        const int gc = h * a.cph + c;
        if (row < HWq)
          store2(pa_ + (size_t)row * HC + gc, acc[mi][j][0], acc[mi][j][1]);
        if (row + 8 < HWq)
          store2(pa_ + (size_t)(row + 8) * HC + gc, acc[mi][j][2],
                 acc[mi][j][3]);
      }
    }
  }
}

}  // namespace wide

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
    memory_read_combine(const ReadArgs a, const OutArgs<TO> o) {
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
      store4(o.o1 + ((size_t)b * HWq + row) * o.wo1 + c, out);
    else
      store4(o.o2 + ((size_t)b * HWq + row) * o.wo2 + (c - o.wo1), out);
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
template <auto K>
cudaError_t launch_dyn(dim3 grid, size_t smem, cudaStream_t st,
                       const ReadArgs& a) {
  static bool raised = false;  // one flag per kernel instantiation
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        K, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised = true;
  }
  K<<<grid, NT, smem, st>>>(a);
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

// One body for launching and for reporting the kernel a set of arguments
// selects: heads_per_block 8 picks memory_read_heads (D <= 32, cph <= 32),
// 0 memory_read_wide (D in {16, 32, 64, 128}).
template <typename Tag, bool INFO>
cudaError_t dispatch(const ReadArgs& a, int B, int heads_per_block,
                     cudaStream_t st, int info[3]) {
#define RMEM_GO(KERNEL, SMEM, GRID)                                     \
  return INFO ? info_of<KERNEL>(SMEM, info)                             \
              : launch_dyn<KERNEL>(GRID, SMEM, st, a)
  const int n_qt = (a.HWq + BQ - 1) / BQ;
  if (heads_per_block == heads::HPB && a.cph <= 32) {
    const dim3 grid(n_qt, a.n_split,
                    B * ((a.H + heads::HPB - 1) / heads::HPB));
    if (a.D == 16 && a.cph <= 16)
      RMEM_GO((heads::memory_read_heads<Tag, 1, 1>),
              (heads::Smem<1, 1>::bytes), grid);
    if (a.D == 16)
      RMEM_GO((heads::memory_read_heads<Tag, 1, 2>),
              (heads::Smem<1, 2>::bytes), grid);
    if (a.D == 32 && a.cph <= 16)
      RMEM_GO((heads::memory_read_heads<Tag, 2, 1>),
              (heads::Smem<2, 1>::bytes), grid);
    if (a.D == 32)
      RMEM_GO((heads::memory_read_heads<Tag, 2, 2>),
              (heads::Smem<2, 2>::bytes), grid);
    return cudaErrorInvalidValue;
  }
  if (heads_per_block != 0) return cudaErrorInvalidValue;
  const dim3 grid(n_qt, a.n_split,
                  B * a.H * ((a.cph + wide::BN - 1) / wide::BN));
  if (a.D == 16)
    RMEM_GO((wide::memory_read_wide<Tag, 1>), (wide::Smem<1>::bytes), grid);
  if (a.D == 32)
    RMEM_GO((wide::memory_read_wide<Tag, 2>), (wide::Smem<2>::bytes), grid);
  if (a.D == 64)
    RMEM_GO((wide::memory_read_wide<Tag, 4>), (wide::Smem<4>::bytes), grid);
  if (a.D == 128)
    RMEM_GO((wide::memory_read_wide<Tag, 8>), (wide::Smem<8>::bytes), grid);
  return cudaErrorInvalidValue;
#undef RMEM_GO
}

// The read and its combine, on `st`.
template <typename Tag, typename TO>
cudaError_t launch(const ReadArgs& a, const OutArgs<TO>& o, int B,
                   int heads_per_block, cudaStream_t st) {
  if (a.T_cap > MAX_T || a.H > MAX_H || a.n_split < 1 || a.cph % 8 ||
      a.wv1 % 8 ||
      a.wv2 % 8 || o.wo1 % 8 || a.wv1 + a.wv2 != a.H * a.cph ||
      o.wo1 + o.wo2 != a.H * a.cph)
    return cudaErrorInvalidValue;
  const cudaError_t err =
      dispatch<Tag, false>(a, B, heads_per_block, st, nullptr);
  if (err != cudaSuccess) return err;
  memory_read_combine<Tag, TO><<<dim3(a.HWq, B), NT_COMBINE, 0, st>>>(a, o);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace rmem
