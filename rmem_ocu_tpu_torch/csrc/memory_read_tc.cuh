// Tensor-core online-softmax read of the RMem bank, shared by kernel B1
// (memory_read.cu) and kernel B3 (memory_read_attention.cu).
//
// One block owns (batch b, head h, 64 query rows, 128 value columns) and
// walks every live slot and 32-key tile itself, in the FlashAttention-2
// arrangement: warp-level bf16 products (mma.sync m16n8k16, f32
// accumulation), each warp keeping its 16 rows' running max, sum and
// output accumulators in registers; the logits' accumulator fragments
// become the A operand of P.V without a trip through shared memory.
//
// The values are the VIRTUAL channel-wise concatenation [v1 | v2] of up to
// two banks (row widths wv1, wv2; v2 may be null), read in their storage
// layout: head h owns columns [h * cph, (h + 1) * cph) of the concatenation
// and every column of a head shares that head's probability matrix. This
// covers DeAOT's V and ID_V under one head (B1: cph = wv1 + wv2), heads by
// channel slicing of one bank (B1, AOT), and heads over V||ID_V without
// materialising the concatenation (B3). Outputs are laid out the same way
// over [o1 | o2] (widths wo1, wo2). The value columns of a head are split
// in chunks of 128 over grid axis y; Q.K^T is recomputed per chunk and only
// chunk 0 writes the per-slot mass.
//
// Rounding follows the Pallas kernels: q, k, v and p are rounded to bf16
// before the products whatever the storage type, the optional temporal-PE
// term sums q.pe in f32 from the rounded q, l and the slot mass use the f32
// p-sum, the mass is rescaled like l, and outputs are divided by
// max(l, 1e-30) at the end. The tail of the last key tile (HWk = 920 tiles
// by no power of two) gets logit -inf, never 0, which would leak softmax
// mass. Dead slots (valid == 0) may sit anywhere and are skipped.
#pragma once

#include "common.cuh"

namespace rmem {
namespace tc {

constexpr int MAX_T = 32;          // bank slots
constexpr float M_INIT = -1e30f;   // the Pallas kernels' running-max init
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

// Row-major, contiguous: q [B, HWq, H*D] (pre-scaled), k [B, T, HWk, H*D],
// pe [B, T, H*D] or null, v1 [B, T, HWk, wv1], v2 [B, T, HWk, wv2] or null,
// valid [B, T], o1 [B, HWq, wo1], o2 [B, HWq, wo2] or null,
// mass [B, H, HWq, T]. wv1 + wv2 == wo1 + wo2 == H * cph; all widths are
// multiples of 8.
template <typename T, typename TO>
struct ReadArgs {
  const T* q;
  const T* k;
  const T* pe;
  const T* v1;
  const T* v2;
  const int* valid;
  TO* o1;
  TO* o2;
  float* mass;
  int H, T_cap, HWq, HWk;
  int cph;        // value columns per head
  int wv1, wv2, wo1, wo2;
};

// KD = D / 16. Accumulator fragment layout (m16n8): c[0], c[1] are row
// lane/4, columns 2*(lane%4) + {0, 1}; c[2], c[3] the same columns of row
// lane/4 + 8.
template <typename T, typename TO, int KD>
__device__ __forceinline__ void memory_read_body(const ReadArgs<T, TO>& a) {
  constexpr int D = 16 * KD;
  constexpr int LDK = D + PAD;
  constexpr int LDV = BN + PAD;
  __shared__ __align__(16) __nv_bfloat16 qs[BQ * LDK];
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LDK];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LDV];
  __shared__ float mass_s[BQ][MAX_T];

  const int H = a.H, T_cap = a.T_cap, HWq = a.HWq, HWk = a.HWk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int col0 = blockIdx.y * BN;        // within the head's columns
  const int gcol0 = h * a.cph + col0;      // within [v1 | v2] and [o1 | o2]
  const bool write_mass = blockIdx.y == 0;
  const int HD = H * D;

  for (int i = tid; i < BQ * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int row = q0 + r;
    *reinterpret_cast<uint4*>(&qs[r * LDK + c]) =
        row < HWq ? load8(a.q + ((size_t)b * HWq + row) * HD + h * D + c)
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

  // A thread stages the same 8 value columns of every key tile: resolve
  // their bank once, so that the tile loop's loads carry no branch and the
  // compiler can keep them all in flight.
  static_assert(NT % (BN / 8) == 0, "a thread's value columns are fixed");
  const int vc = (tid % (BN / 8)) * 8;
  const bool v_cols = col0 + vc < a.cph;
  const bool v_first = gcol0 + vc < a.wv1;
  const T* v_src = v_first ? a.v1 + (gcol0 + vc) : a.v2 + (gcol0 + vc - a.wv1);
  const int v_ld = v_first ? a.wv1 : a.wv2;

  for (int t = 0; t < T_cap; ++t) {
    if (a.valid[b * T_cap + t] == 0) continue;  // block-uniform
    // temporal-PE logit term of this thread's two rows
    float pc_lo = 0.f, pc_hi = 0.f;
    if (a.pe != nullptr) {
      const T* pe_t = a.pe + ((size_t)b * T_cap + t) * HD + h * D;
      for (int d = lane % 4; d < D; d += 4) {
        const float p = to_f(pe_t[d]);
        pc_lo += __bfloat162float(qs[r_lo * LDK + d]) * p;
        pc_hi += __bfloat162float(qs[r_hi * LDK + d]) * p;
      }
      pc_lo = quad_sum(pc_lo);
      pc_hi = quad_sum(pc_hi);
    }
    const size_t key0 = ((size_t)b * T_cap + t) * HWk;  // slot's first key
    const T* k_t = a.k + key0 * HD + h * D;
    for (int kbase = 0; kbase < HWk; kbase += BK) {
      __syncthreads();  // every warp is done with the last tile
      for (int i = tid; i < BK * (D / 8); i += NT) {
        const int j = i / (D / 8), c = (i % (D / 8)) * 8;
        *reinterpret_cast<uint4*>(&ks[j * LDK + c]) =
            kbase + j < HWk ? load8(k_t + (size_t)(kbase + j) * HD + c)
                            : make_uint4(0, 0, 0, 0);
      }
      for (int j = tid / (BN / 8); j < BK; j += NT / (BN / 8))
        *reinterpret_cast<uint4*>(&vs[j * LDV + vc]) =
            (v_cols && kbase + j < HWk)
                ? load8(v_src + (key0 + kbase + j) * v_ld)
                : make_uint4(0, 0, 0, 0);
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
    const int c = j * 8 + (lane % 4) * 2;
    if (col0 + c < a.cph) {
      const int gc = gcol0 + c;
      const bool first = gc < a.wo1;
      TO* o = first ? a.o1 : a.o2;
      const int wo = first ? a.wo1 : a.wo2;
      const int oc = first ? gc : gc - a.wo1;
      if (row_lo < HWq)
        store2(o + ((size_t)b * HWq + row_lo) * wo + oc, acc[j][0] / d_lo,
               acc[j][1] / d_lo);
      if (row_hi < HWq)
        store2(o + ((size_t)b * HWq + row_hi) * wo + oc, acc[j][2] / d_hi,
               acc[j][3] / d_hi);
    }
  }
  if (write_mass && lane % 4 == 0) {
    for (int tt = 0; tt < T_cap; ++tt) {
      if (row_lo < HWq)
        a.mass[(((size_t)b * H + h) * HWq + row_lo) * T_cap + tt] =
            mass_s[r_lo][tt] / d_lo;
      if (row_hi < HWq)
        a.mass[(((size_t)b * H + h) * HWq + row_hi) * T_cap + tt] =
            mass_s[r_hi][tt] / d_hi;
    }
  }
}

// The kernel proper. Tag names the caller (FusedRead: B1, AttentionRead:
// B3) so that each shows under its own name in a profile.
struct FusedRead {};
struct AttentionRead {};

template <typename Tag, typename T, typename TO, int KD>
__global__ void __launch_bounds__(NT) memory_read_tc(
    const ReadArgs<T, TO> a) {
  memory_read_body<T, TO, KD>(a);
}

// Launch for head dim D in {16, 32, 64, 128}; false for any other.
template <typename Tag, typename T, typename TO>
bool launch(const ReadArgs<T, TO>& a, int B, int D, cudaStream_t stream) {
  const dim3 grid((a.HWq + BQ - 1) / BQ, (a.cph + BN - 1) / BN, B * a.H);
  switch (D) {
    case 16:
      memory_read_tc<Tag, T, TO, 1><<<grid, NT, 0, stream>>>(a);
      return true;
    case 32:
      memory_read_tc<Tag, T, TO, 2><<<grid, NT, 0, stream>>>(a);
      return true;
    case 64:
      memory_read_tc<Tag, T, TO, 4><<<grid, NT, 0, stream>>>(a);
      return true;
    case 128:
      memory_read_tc<Tag, T, TO, 8><<<grid, NT, 0, stream>>>(a);
      return true;
    default:
      return false;
  }
}

}  // namespace tc
}  // namespace rmem
