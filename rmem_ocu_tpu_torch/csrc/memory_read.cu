// Kernel B1: fused long-term memory read of the RMem bank.
//
// Replaces the Pallas TPU kernel `memory_read_fused`
// (rmem_ocu_tpu/ops/pallas/memory_read.py:281, body _make_fused_kernel).
// One pass of online-softmax attention of the queries over every live slot
// of the position-indirected bank, returning P.V for one or two value
// banks that share P (DeAOT's V and ID_V) and the per-slot attention mass
// sum(p)/l that drives eviction. The temporal PE enters as the rank-1
// logit term q.pe_t. Dead slots (valid == 0) may sit anywhere and are
// skipped.
//
// What bounds it on the H100: at the main-path shape (1 head, D=128, two
// 512-wide banks, 9 live slots of 920 keys, 920 queries) one launch is
// ~17.6 GFLOP against ~20 MB of operands, so it is bound by operations:
// the products belong on the tensor cores.
//
// Two paths, chosen by the operand precision the caller asks for:
// - bf16 operands (the main path, and the reference's bank read on f32
//   inputs): `tc`, warp-level bf16 tensor-core products (mma.sync
//   m16n8k16, f32 accumulation) in the FlashAttention-2 arrangement. Each
//   warp owns 16 query rows and keeps its running max, sum and output
//   accumulators in registers; the logits' accumulator fragments become
//   the A operand of P.V without a trip through shared memory. `wgmma`,
//   TMA and a pipelined K/V ring are later work.
// - f32 operands (precise): `simt`, the same online softmax on the FP32
//   pipes, one block per 16 query rows.
//
// Design points shared by both:
// - The Pallas grid (b*h, q-block, slot, k-block) carries m, l, acc and the
//   slot mass across sequential grid steps. GPU blocks share nothing, so
//   one block owns (b, h, a query tile, a chunk of value columns) and loops
//   over slots and 32-key tiles itself.
// - A query row's two 512-wide f32 accumulators do not fit one block's
//   registers, so the value columns are split over grid axis y; QK (~1/9
//   of the work) is recomputed per chunk and only chunk 0 writes the mass.
// - HWk = 920 does not tile by a power of two: the tail of the last key
//   tile gets logit -inf (never 0, which would leak softmax mass).
// - Rounding follows the reference: q, k, v and p are rounded to bf16
//   before the products (tc), the PE term sums q.pe in f32 from the rounded
//   q, l and the slot mass use the f32 p-sum, the mass is rescaled like l,
//   and outputs are divided by max(l, 1e-30) at the end.
#include "common.cuh"

namespace {

using rmem::load4;
using rmem::store4;
using rmem::to_f;
using rmem::warp_max;
using rmem::warp_sum;

constexpr int MAX_T = 32;
constexpr float M_INIT = -1e30f;   // the Pallas kernel's running-max init

namespace simt {

constexpr int BQ = 16;             // query rows per block
constexpr int BK = 32;             // keys per tile, one per lane
constexpr int NT = 128;            // threads per block (4 warps)
constexpr int COLS = 4;            // value columns per thread
constexpr int CHUNK = NT * COLS;   // value columns per block
constexpr int ROWS_PER_WARP = BQ / (NT / 32);

template <typename T>
__global__ void __launch_bounds__(NT) memory_read_simt(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ pe, const T* __restrict__ v1,
    const T* __restrict__ v2, const int* __restrict__ valid,
    T* __restrict__ o1, T* __restrict__ o2, float* __restrict__ mass,
    int H, int T_cap, int HWq, int HWk, int D, int Cv1, int Cv2,
    int n_chunks1) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][D]
  float* ks = qs + BQ * D;             // [BK][D + 1], padded: no conflicts
  float* ps = ks + BK * (D + 1);       // [BK][BQ], p of the current tile
  __shared__ float m_s[BQ], l_s[BQ], alpha_s[BQ], pc_s[BQ];
  __shared__ float mass_s[BQ][MAX_T];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int chunk = blockIdx.y;
  const bool first_bank = chunk < n_chunks1;
  const int Cv = first_bank ? Cv1 : Cv2;
  const T* v = first_bank ? v1 : v2;
  T* o = first_bank ? o1 : o2;
  const int col =
      (first_bank ? chunk : chunk - n_chunks1) * CHUNK + tid * COLS;
  const bool has_cols = col < Cv;
  const int HD = H * D;
  const int HCv = H * Cv;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - (i / D) * D;
    const int row = q0 + r;
    qs[i] = row < HWq
                ? to_f(q[((size_t)b * HWq + row) * HD + h * D + d])
                : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = M_INIT;
    l_s[tid] = 0.f;
  }
  for (int i = tid; i < BQ * MAX_T; i += NT) (&mass_s[0][0])[i] = 0.f;

  float acc[BQ][COLS];
#pragma unroll
  for (int r = 0; r < BQ; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;
  __syncthreads();

  const int n_kt = (HWk + BK - 1) / BK;
  for (int t = 0; t < T_cap; ++t) {
    if (valid[b * T_cap + t] == 0) continue;  // block-uniform
    // temporal-PE logit term, once per (row, slot)
    if (pe != nullptr) {
      const T* pe_t = pe + ((size_t)b * T_cap + t) * HD + h * D;
#pragma unroll
      for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
        const int r = warp + (NT / 32) * rr;
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += qs[r * D + d] * to_f(pe_t[d]);
        s = warp_sum(s);
        if (lane == 0) pc_s[r] = s;
      }
    } else if (tid < BQ) {
      pc_s[tid] = 0.f;
    }
    const T* k_t = k + ((size_t)b * T_cap + t) * HWk * HD + h * D;
    const T* v_t = v + ((size_t)b * T_cap + t) * HWk * HCv + h * Cv + col;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int kbase = kt * BK;
      __syncthreads();  // last tile's readers of ks/ps are done
      for (int i = tid; i < BK * D; i += NT) {
        const int j = i / D, d = i - (i / D) * D;
        const int key = kbase + j;
        ks[j * (D + 1) + d] =
            key < HWk ? to_f(k_t[(size_t)key * HD + d]) : 0.f;
      }
      __syncthreads();

      // logits: lane = key, rows warp + 4 * rr
      float s[ROWS_PER_WARP];
#pragma unroll
      for (int rr = 0; rr < ROWS_PER_WARP; ++rr) s[rr] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = ks[lane * (D + 1) + d];
#pragma unroll
        for (int rr = 0; rr < ROWS_PER_WARP; ++rr)
          s[rr] += qs[(warp + (NT / 32) * rr) * D + d] * kv;
      }
      const bool key_ok = kbase + lane < HWk;
#pragma unroll
      for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
        const int r = warp + (NT / 32) * rr;
        const float logit = key_ok ? s[rr] + pc_s[r] : -INFINITY;
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, warp_max(logit));
        const float p = expf(logit - m_new);
        const float p_sum = warp_sum(p);
        const float alpha = expf(m_prev - m_new);
        ps[lane * BQ + r] = p;
        if (lane < T_cap)
          mass_s[r][lane] = mass_s[r][lane] * alpha + (lane == t ? p_sum : 0.f);
        __syncwarp();  // every lane has read m_s[r] before it changes
        if (lane == 0) {
          m_s[r] = m_new;
          l_s[r] = l_s[r] * alpha + p_sum;
          alpha_s[r] = alpha;
        }
      }
      __syncthreads();

      if (has_cols) {
#pragma unroll
        for (int r = 0; r < BQ; ++r) {
          const float a = alpha_s[r];
#pragma unroll
          for (int c = 0; c < COLS; ++c) acc[r][c] *= a;
        }
        const int nk = min(BK, HWk - kbase);
        for (int j = 0; j < nk; ++j) {
          float vv[COLS];
          load4(v_t + (size_t)(kbase + j) * HCv, vv);
          const float4* pj = reinterpret_cast<const float4*>(ps + j * BQ);
#pragma unroll
          for (int r4 = 0; r4 < BQ / 4; ++r4) {
            const float4 p4 = pj[r4];
#pragma unroll
            for (int c = 0; c < COLS; ++c) {
              acc[4 * r4 + 0][c] += p4.x * vv[c];
              acc[4 * r4 + 1][c] += p4.y * vv[c];
              acc[4 * r4 + 2][c] += p4.z * vv[c];
              acc[4 * r4 + 3][c] += p4.w * vv[c];
            }
          }
        }
      }
    }
  }
  __syncthreads();

  if (has_cols) {
#pragma unroll
    for (int r = 0; r < BQ; ++r) {
      const int row = q0 + r;
      if (row < HWq) {
        const float denom = fmaxf(l_s[r], 1e-30f);
        float out[COLS];
#pragma unroll
        for (int c = 0; c < COLS; ++c) out[c] = acc[r][c] / denom;
        store4(o + ((size_t)b * HWq + row) * HCv + h * Cv + col, out);
      }
    }
  }
  if (chunk == 0) {
    for (int i = tid; i < BQ * T_cap; i += NT) {
      const int r = i / T_cap, tt = i - (i / T_cap) * T_cap;
      const int row = q0 + r;
      if (row < HWq)
        mass[(((size_t)b * H + h) * HWq + row) * T_cap + tt] =
            mass_s[r][tt] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

template <typename T>
void launch_simt(const void* q, const void* k, const void* pe, const void* v1,
            const void* v2, const int* valid, void* o1, void* o2,
            float* mass, int B, int H, int T_cap, int HWq, int HWk, int D,
            int Cv1, int Cv2, cudaStream_t stream) {
  const int n1 = (Cv1 + CHUNK - 1) / CHUNK;
  const int n2 = v2 != nullptr ? (Cv2 + CHUNK - 1) / CHUNK : 0;
  const dim3 grid((HWq + BQ - 1) / BQ, n1 + n2, B * H);
  const size_t smem = sizeof(float) * (BQ * D + BK * (D + 1) + BK * BQ);
  memory_read_simt<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(pe), static_cast<const T*>(v1),
      static_cast<const T*>(v2), valid, static_cast<T*>(o1),
      static_cast<T*>(o2), mass, H, T_cap, HWq, HWk, D, Cv1, Cv2, n1);
}

}  // namespace simt

namespace tc {

constexpr int WARPS = 4;
constexpr int BQ = 16 * WARPS;     // query rows per block, 16 per warp
constexpr int BK = 32;             // keys per tile
constexpr int BN = 128;            // value columns per block
constexpr int NT = 32 * WARPS;
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

// 8 consecutive elements as 8 bf16 (round-to-nearest from f32)
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// KD = D / 16. Accumulator fragment layout (m16n8): c[0], c[1] are row
// lane/4, columns 2*(lane%4) + {0, 1}; c[2], c[3] the same columns of row
// lane/4 + 8.
template <typename T, int KD>
__global__ void __launch_bounds__(NT) memory_read_tc(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ pe, const T* __restrict__ v1,
    const T* __restrict__ v2, const int* __restrict__ valid,
    T* __restrict__ o1, T* __restrict__ o2, float* __restrict__ mass,
    int H, int T_cap, int HWq, int HWk, int Cv1, int Cv2, int n_chunks1) {
  constexpr int D = 16 * KD;
  constexpr int LDK = D + PAD;
  constexpr int LDV = BN + PAD;
  __shared__ __align__(16) __nv_bfloat16 qs[BQ * LDK];
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LDK];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LDV];
  __shared__ float mass_s[BQ][MAX_T];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int chunk = blockIdx.y;
  const bool first_bank = chunk < n_chunks1;
  const int Cv = first_bank ? Cv1 : Cv2;
  const T* v = first_bank ? v1 : v2;
  T* o = first_bank ? o1 : o2;
  const int col0 = (first_bank ? chunk : chunk - n_chunks1) * BN;
  const bool write_mass = chunk == 0;
  const int HD = H * D;
  const int HCv = H * Cv;

  for (int i = tid; i < BQ * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int row = q0 + r;
    *reinterpret_cast<uint4*>(&qs[r * LDK + c]) =
        row < HWq ? load8(q + ((size_t)b * HWq + row) * HD + h * D + c)
                  : make_uint4(0, 0, 0, 0);
  }
  for (int i = tid; i < BQ * MAX_T; i += NT) (&mass_s[0][0])[i] = 0.f;
  __syncthreads();

  // this warp's 16 query rows as A fragments, for the whole kernel
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], &qs[(warp * 16 + (lane % 16)) * LDK + kk * 16 +
                            (lane / 16) * 8]);
  const int r_lo = warp * 16 + lane / 4, r_hi = r_lo + 8;
  float m_lo = M_INIT, m_hi = M_INIT, l_lo = 0.f, l_hi = 0.f;
  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < T_cap; ++t) {
    if (valid[b * T_cap + t] == 0) continue;  // block-uniform
    // temporal-PE logit term of this thread's two rows
    float pc_lo = 0.f, pc_hi = 0.f;
    if (pe != nullptr) {
      const T* pe_t = pe + ((size_t)b * T_cap + t) * HD + h * D;
      for (int d = lane % 4; d < D; d += 4) {
        const float p = to_f(pe_t[d]);
        pc_lo += __bfloat162float(qs[r_lo * LDK + d]) * p;
        pc_hi += __bfloat162float(qs[r_hi * LDK + d]) * p;
      }
      pc_lo = quad_sum(pc_lo);
      pc_hi = quad_sum(pc_hi);
    }
    const T* k_t = k + ((size_t)b * T_cap + t) * HWk * HD + h * D;
    const T* v_t = v + ((size_t)b * T_cap + t) * HWk * HCv + h * Cv + col0;
    for (int kbase = 0; kbase < HWk; kbase += BK) {
      __syncthreads();  // every warp is done with the last tile
      for (int i = tid; i < BK * (D / 8); i += NT) {
        const int j = i / (D / 8), c = (i % (D / 8)) * 8;
        *reinterpret_cast<uint4*>(&ks[j * LDK + c]) =
            kbase + j < HWk ? load8(k_t + (size_t)(kbase + j) * HD + c)
                            : make_uint4(0, 0, 0, 0);
      }
      for (int i = tid; i < BK * (BN / 8); i += NT) {
        const int j = i / (BN / 8), c = (i % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(&vs[j * LDV + c]) =
            (kbase + j < HWk && col0 + c < Cv)
                ? load8(v_t + (size_t)(kbase + j) * HCv + c)
                : make_uint4(0, 0, 0, 0);
      }
      __syncthreads();

      // S = Q K^T: 16 rows x 32 keys, four n-tiles of 8 keys
      float s[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, &ks[(np * 16 + (lane % 8) + (lane / 16) * 8) * LDK +
                              kk * 16 + ((lane / 8) % 2) * 8]);
          mma(s[2 * np], qf[kk], bf[0], bf[1]);
          mma(s[2 * np + 1], qf[kk], bf[2], bf[3]);
        }
      }

      // online softmax over the tile
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = kbase + n * 8 + (lane % 4) * 2 + e < HWk;
          s[n][e] = ok ? s[n][e] + pc_lo : -INFINITY;
          s[n][2 + e] = ok ? s[n][2 + e] + pc_hi : -INFINITY;
          mx_lo = fmaxf(mx_lo, s[n][e]);
          mx_hi = fmaxf(mx_hi, s[n][2 + e]);
        }
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
      const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
      float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[n][e] = expf(s[n][e] - mn_lo);
          s[n][2 + e] = expf(s[n][2 + e] - mn_hi);
          ps_lo += s[n][e];
          ps_hi += s[n][2 + e];
        }
      ps_lo = quad_sum(ps_lo);
      ps_hi = quad_sum(ps_hi);
      l_lo = l_lo * a_lo + ps_lo;
      l_hi = l_hi * a_hi + ps_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        acc[j][0] *= a_lo;
        acc[j][1] *= a_lo;
        acc[j][2] *= a_hi;
        acc[j][3] *= a_hi;
      }
      if (write_mass && lane % 4 == 0) {
        for (int tt = 0; tt < T_cap; ++tt) {
          mass_s[r_lo][tt] = mass_s[r_lo][tt] * a_lo + (tt == t ? ps_lo : 0.f);
          mass_s[r_hi][tt] = mass_s[r_hi][tt] * a_hi + (tt == t ? ps_hi : 0.f);
        }
      }

      // O += P V, P rounded to bf16 straight from the S fragments
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int jp = 0; jp < BN / 16; ++jp) {
          uint32_t bf[4];
          ldmatrix_x4_trans(
              bf, &vs[(kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDV +
                      jp * 16 + (lane / 16) * 8]);
          mma(acc[2 * jp], pa, bf[0], bf[1]);
          mma(acc[2 * jp + 1], pa, bf[2], bf[3]);
        }
      }
    }
  }

  const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
  const int row_lo = q0 + r_lo, row_hi = q0 + r_hi;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = col0 + j * 8 + (lane % 4) * 2;
    if (c < Cv) {
      if (row_lo < HWq)
        store2(o + ((size_t)b * HWq + row_lo) * HCv + h * Cv + c,
               acc[j][0] / d_lo, acc[j][1] / d_lo);
      if (row_hi < HWq)
        store2(o + ((size_t)b * HWq + row_hi) * HCv + h * Cv + c,
               acc[j][2] / d_hi, acc[j][3] / d_hi);
    }
  }
  if (write_mass && lane % 4 == 0) {
    for (int tt = 0; tt < T_cap; ++tt) {
      if (row_lo < HWq)
        mass[(((size_t)b * H + h) * HWq + row_lo) * T_cap + tt] =
            mass_s[r_lo][tt] / d_lo;
      if (row_hi < HWq)
        mass[(((size_t)b * H + h) * HWq + row_hi) * T_cap + tt] =
            mass_s[r_hi][tt] / d_hi;
    }
  }
}

template <typename T, int KD>
void launch_tc(const void* q, const void* k, const void* pe, const void* v1,
               const void* v2, const int* valid, void* o1, void* o2,
               float* mass, int B, int H, int T_cap, int HWq, int HWk,
               int Cv1, int Cv2, cudaStream_t stream) {
  const int n1 = (Cv1 + BN - 1) / BN;
  const int n2 = v2 != nullptr ? (Cv2 + BN - 1) / BN : 0;
  const dim3 grid((HWq + BQ - 1) / BQ, n1 + n2, B * H);
  memory_read_tc<T, KD><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(pe), static_cast<const T*>(v1),
      static_cast<const T*>(v2), valid, static_cast<T*>(o1),
      static_cast<T*>(o2), mass, H, T_cap, HWq, HWk, Cv1, Cv2, n1);
}

template <typename T>
bool dispatch_tc(const void* q, const void* k, const void* pe,
                 const void* v1, const void* v2, const int* valid, void* o1,
                 void* o2, float* mass, int B, int H, int T_cap, int HWq,
                 int HWk, int D, int Cv1, int Cv2, cudaStream_t s) {
  switch (D) {
    case 16:
      launch_tc<T, 1>(q, k, pe, v1, v2, valid, o1, o2, mass, B, H, T_cap,
                      HWq, HWk, Cv1, Cv2, s);
      return true;
    case 32:
      launch_tc<T, 2>(q, k, pe, v1, v2, valid, o1, o2, mass, B, H, T_cap,
                      HWq, HWk, Cv1, Cv2, s);
      return true;
    case 64:
      launch_tc<T, 4>(q, k, pe, v1, v2, valid, o1, o2, mass, B, H, T_cap,
                      HWq, HWk, Cv1, Cv2, s);
      return true;
    case 128:
      launch_tc<T, 8>(q, k, pe, v1, v2, valid, o1, o2, mass, B, H, T_cap,
                      HWq, HWk, Cv1, Cv2, s);
      return true;
    default:
      return false;
  }
}

}  // namespace tc
}  // namespace

// C interface, bound with ctypes. Layouts (row-major, contiguous):
// q [B, HWq, H*D] (pre-scaled), k [B, T, HWk, H*D], pe [B, T, H*D] or
// null, v1 [B, T, HWk, H*Cv1], v2 [B, T, HWk, H*Cv2] or null (two banks
// need H == 1), valid [B, T] int32, o1/o2 like q with the value widths,
// mass [B, H, HWq, T] f32. round_bf16 selects bf16 operands (tensor cores;
// D in {16, 32, 64, 128}, Cv % 8 == 0), else f32 operands (D <= 128,
// Cv % 4 == 0). Returns cudaGetLastError() after the launch.
extern "C" int rmem_memory_read_fused(
    const void* q, const void* k, const void* pe, const void* v1,
    const void* v2, const int* valid, void* o1, void* o2, float* mass,
    int B, int H, int T_cap, int HWq, int HWk, int D, int Cv1, int Cv2,
    int is_bf16, int round_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_cap > MAX_T) return static_cast<int>(cudaErrorInvalidValue);
  if (round_bf16) {
    const bool ok =
        is_bf16 ? tc::dispatch_tc<__nv_bfloat16>(q, k, pe, v1, v2, valid, o1,
                                                 o2, mass, B, H, T_cap, HWq,
                                                 HWk, D, Cv1, Cv2, s)
                : tc::dispatch_tc<float>(q, k, pe, v1, v2, valid, o1, o2,
                                         mass, B, H, T_cap, HWq, HWk, D, Cv1,
                                         Cv2, s);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (D > 128) return static_cast<int>(cudaErrorInvalidValue);
    if (is_bf16)
      simt::launch_simt<__nv_bfloat16>(q, k, pe, v1, v2, valid, o1, o2, mass,
                                       B, H, T_cap, HWq, HWk, D, Cv1, Cv2, s);
    else
      simt::launch_simt<float>(q, k, pe, v1, v2, valid, o1, o2, mass, B, H,
                               T_cap, HWq, HWk, D, Cv1, Cv2, s);
  }
  return static_cast<int>(cudaGetLastError());
}
