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
// What bounds it on the H100: operations. At the VOST cells' shape (8
// streams, one head of D=128, V and ID_V 512 wide each, 9 live slots of
// 2,442 keys, 2,442 queries) one read is 0.99 TFLOP against 0.45 GB: 1.0
// ms at the bf16 tensor-core rate against 0.14 ms for its bytes. So the
// products belong on the tensor cores at their full rate, and everything
// else (loads, softmax, the slot mass, the normalisation) has to hide
// behind them.
//
// Two paths, chosen by the operand precision the caller asks for:
// - bf16 operands (the main path, and the reference's bank read on f32
//   inputs): the read of memory_read_tc.cuh, which kernel B3 shares. For
//   wide heads a warp-specialised Hopper kernel: a producer warpgroup
//   keeps K and V tiles in flight with TMA, two consumer warpgroups of 64
//   query rows each run Q.K^T and P.V as wgmma, with P in registers, over
//   blocks of 128 value columns (the registers that ptxas keeps a wgmma's
//   accumulators in bound the width; V||ID_V takes 8 blocks), and where
//   one unit covers a query tile's bank (the cells' shapes) the kernel
//   normalises and writes the outputs and the mass itself, in one launch;
//   where the blocks would not fill the card (one stream, a TP shard) the
//   bank is split over blocks by slot and merged by a second launch that
//   also yields the mass. 8 heads of 32 share one block (mma.sync). The
//   header says why.
// - f32 operands (precise): `simt` below, the same online softmax on the
//   FP32 pipes, one block per 16 query rows. No path calls it.
//
// Design points shared by both:
// - The Pallas grid (b*h, q-block, slot, k-block) carries m, l, acc and the
//   slot mass across sequential grid steps. GPU blocks share nothing: a
//   block loops over its share of the slots' key tiles; shares of one
//   query tile, where there are several, are merged afterwards; `simt`
//   loops over every slot inside one block.
// - HWk = 920 does not tile by a power of two: the tail of the last key
//   tile gets logit -inf (never 0, which would leak softmax mass).
// - Rounding follows the reference: q, k, v and p are rounded to bf16
//   before the products (bf16 path), the PE term sums q.pe in f32 from the
//   rounded q, l and the slot mass use the f32 p-sum, and outputs are
//   divided by max(l, 1e-30) at the end.
#include "memory_read_tc.cuh"

namespace {

using rmem::load4;
using rmem::store4;
using rmem::to_f;
using rmem::warp_max;
using rmem::warp_sum;

using rmem::tc::M_INIT;
using rmem::tc::MAX_T;

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

// One or two banks sharing P (H == 1), or heads by channel slicing of one
// bank: head h owns columns [h * (Cv1 + Cv2), ...) of [v1 | v2]. q, k, v
// are bf16, pe f32; outputs bf16 (is_bf16) or f32.
int launch_tc(const void* q, const void* k, const void* pe, const void* v1,
              const void* v2, const int* valid, void* o1, void* o2,
              float* mass, float* part_acc, float* part_m, void* slot_ml,
              int B, int H, int T_cap, int HWq, int HWk, int D, int Cv1,
              int Cv2, int is_bf16, int n_split, int heads_per_block,
              cudaStream_t stream) {
  using rmem::tc::bf16;
  if (v2 == nullptr) Cv2 = 0;
  const rmem::tc::ReadArgs a = {
      static_cast<const bf16*>(q),   static_cast<const bf16*>(k),
      static_cast<const float*>(pe), static_cast<const bf16*>(v1),
      static_cast<const bf16*>(v2),  valid,
      part_acc,                      part_m,
      static_cast<float2*>(slot_ml), H,
      T_cap,                         HWq,
      HWk,                           D,
      Cv1 + Cv2,                     H * Cv1,
      H * Cv2,                       n_split};
  const rmem::tc::OutArgs o = {o1, o2, mass, H * Cv1, H * Cv2, is_bf16};
  return static_cast<int>(rmem::tc::launch<rmem::tc::FusedRead>(
      a, o, B, heads_per_block, stream));
}

}  // namespace

// C interface, bound with ctypes. Layouts (row-major, contiguous):
// q [B, HWq, H*D] (pre-scaled), k [B, T, HWk, H*D], pe [B, T, H*D] or
// null, v1 [B, T, HWk, H*Cv1], v2 [B, T, HWk, H*Cv2] or null (two banks
// need H == 1), valid [B, T] int32, o1/o2 like q with the value widths,
// mass [B, H, HWq, T] f32.
// - round_bf16: bf16 operands on the tensor cores. q, k, v are bf16 and pe
//   f32 whatever the output type (is_bf16: bf16 outputs, else f32); the
//   f32 scratch is part_acc [B, n_split, HWq, H*(Cv1+Cv2)], part_m
//   [B, H, n_split, HWq], slot_ml [B, H, n_split, HWq, T, 2];
//   heads_per_block (8) picks the several-heads-per-block kernel
//   (D <= 32, Cv1 <= 32), 0 the one-head kernel (D in {16, 32, 64, 128}).
//   The one-head kernel at n_split == 1 is one launch and reads no
//   scratch (it may be null); else two: the split read and its combine.
// - else f32 operands in the storage type (is_bf16) on the FP32 pipes
//   (D <= 128, Cv % 4 == 0), one launch; the scratch is unused.
// Returns cudaGetLastError() after the launches.
extern "C" int rmem_memory_read_fused(
    const void* q, const void* k, const void* pe, const void* v1,
    const void* v2, const int* valid, void* o1, void* o2, float* mass,
    float* part_acc, float* part_m, void* slot_ml, int B, int H, int T_cap,
    int HWq, int HWk, int D, int Cv1, int Cv2, int is_bf16, int round_bf16,
    int n_split, int heads_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_cap > MAX_T) return static_cast<int>(cudaErrorInvalidValue);
  if (v2 != nullptr && H != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (round_bf16)
    return launch_tc(q, k, pe, v1, v2, valid, o1, o2, mass, part_acc, part_m,
                     slot_ml, B, H, T_cap, HWq, HWk, D, Cv1, Cv2, is_bf16,
                     n_split, heads_per_block, s);
  if (D > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    simt::launch_simt<__nv_bfloat16>(q, k, pe, v1, v2, valid, o1, o2, mass,
                                     B, H, T_cap, HWq, HWk, D, Cv1, Cv2, s);
  else
    simt::launch_simt<float>(q, k, pe, v1, v2, valid, o1, o2, mass, B, H,
                             T_cap, HWq, HWk, D, Cv1, Cv2, s);
  return static_cast<int>(cudaGetLastError());
}

// Registers, shared memory bytes and local (spill) bytes per thread of the
// bf16 read kernel that D, the per-head value width and heads_per_block
// select, into out[3]. Returns the CUDA error of the query.
extern "C" int rmem_memory_read_info(int D, int cph, int heads_per_block,
                                     int* out) {
  rmem::tc::ReadArgs a = {};
  a.H = 1;
  a.D = D;
  a.cph = a.wv1 = cph;
  a.n_split = 1;
  return static_cast<int>(rmem::tc::dispatch<rmem::tc::FusedRead, true>(
      a, rmem::tc::Maps{}, rmem::tc::OutArgs{}, 1, heads_per_block, nullptr,
      out));
}
