// Kernel B2: one-head local-window attention (DeAOT short-term memory).
//
// Replaces the Pallas TPU kernel `local_window_attention`
// (rmem_ocu_tpu/ops/pallas/local_attn.py:91, body _kernel, called from
// LocalGatedPropagation._pallas_core in rmem_ocu_tpu/ops/attention.py).
// Each query attends the keys of its (2*max_dis+1)^2 window (15x15 at
// max_dis=7) with logits q.k + rel[q, dy*ws + dx], softmax in f32 and
// output P.V in v's dtype.
//
// What bounds it on the H100: at the main-path shape (23x40 grid, D=128,
// E=1024) one launch moves ~5 MB (q, k, v, the f32 bias, the output) for
// ~0.4 GFLOP of in-window products, so it is bound by bytes.
//
// Design:
// - The Pallas kernel scatters the bias into a padded row-band layout
//   outside the kernel because Mosaic cannot gather. Here the kernel reads
//   rel[b, q, dy*ws + dx] directly and visits only in-window keys.
// - Keys inside the window but outside the image get logit -1e8 in the
//   reference, which is exactly probability 0 in f32, and a query's own key
//   is always present; so such keys are skipped.
// - One block owns 8 consecutive queries of one image row. The keys of
//   their windows, one image row at a time, are a contiguous run of tokens:
//   the block stages that run in shared memory with coalesced 16-byte
//   loads, first the keys (logits, one warp per query, one lane per window
//   column), then after the softmax the values (P.V, each thread keeping
//   8 queries x 4 value columns in registers). Every key and value row is
//   read from device memory once per block.
// - Rounding follows the reference: q, k, v and the normalised p are
//   rounded to bf16 (ROUND) unless the caller asks for f32 precision.
#include "common.cuh"

namespace {

using rmem::load4;
using rmem::mm;
using rmem::store4;
using rmem::to_f;
using rmem::warp_max;
using rmem::warp_sum;

constexpr int TQ = 8;              // queries per block, one warp each
constexpr int NT = TQ * 32;        // threads per block
constexpr int COLS = 4;            // value columns per thread
constexpr int MAX_E = NT * COLS;   // value width one block covers

template <typename T, bool ROUND>
__global__ void __launch_bounds__(NT) local_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ rel,
    T* __restrict__ out, int h, int w, int D, int E, int md) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ws = 2 * md + 1, ws2 = ws * ws, kw = TQ + 2 * md;
  T* vs = reinterpret_cast<T*>(smem_raw);             // [kw][E] value run
  float* qs = reinterpret_cast<float*>(vs + kw * E);  // [TQ][D] rounded q
  float* ks = qs + TQ * D;                            // [kw][D + 1] key run
  float* P = ks + kw * (D + 1);                       // [TQ][ws2]
  const int tiles_x = (w + TQ - 1) / TQ;
  const int qy = blockIdx.x / tiles_x;
  const int qx0 = (blockIdx.x - qy * tiles_x) * TQ;
  const int b = blockIdx.y;
  const int HW = h * w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ky0 = max(qy - md, 0), ky1 = min(qy + md, h - 1);
  const int kx0 = max(qx0 - md, 0), kx1 = min(qx0 + TQ - 1 + md, w - 1);
  const int nkx = kx1 - kx0 + 1;
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // per 16-byte load

  for (int i = tid; i < TQ * D; i += NT) {
    const int r = i / D, d = i - (i / D) * D;
    const int qx = qx0 + r;
    qs[i] = qx < w
                ? mm<ROUND>(to_f(q[((size_t)b * HW + qy * w + qx) * D + d]))
                : 0.f;
  }
  for (int i = tid; i < TQ * ws2; i += NT) P[i] = -INFINITY;

  // logits: warp = query, lane = window column
  const int qx = qx0 + warp;
  const int kx = qx + lane - md;
  const bool active = qx < w && lane < ws && kx >= 0 && kx < w;
  for (int ky = ky0; ky <= ky1; ++ky) {
    __syncthreads();  // the previous key run is consumed
    const T* krow = k + ((size_t)b * HW + ky * w + kx0) * D;
    for (int i = tid; i < nkx * D; i += NT) {
      const int j = i / D, d = i - (i / D) * D;
      ks[j * (D + 1) + d] = mm<ROUND>(to_f(krow[i]));
    }
    __syncthreads();
    if (active) {
      const float* qv = qs + warp * D;
      const float* kv = ks + (kx - kx0) * (D + 1);
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qv[d] * kv[d];
      const int j = (ky - qy + md) * ws + lane;
      P[warp * ws2 + j] = s + rel[((size_t)b * HW + qy * w + qx) * ws2 + j];
    }
  }
  __syncthreads();

  if (qx < w) {
    float* Pi = P + warp * ws2;
    float mx = -INFINITY;
    for (int j = lane; j < ws2; j += 32) mx = fmaxf(mx, Pi[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < ws2; j += 32) {
      const float e = expf(Pi[j] - mx);
      Pi[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < ws2; j += 32) Pi[j] = mm<ROUND>(Pi[j] / sum);
  }

  // P.V over the same runs of keys, now their values
  const int c0 = tid * COLS;
  float acc[TQ][COLS];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
  for (int ky = ky0; ky <= ky1; ++ky) {
    __syncthreads();  // P is final; the previous value run is consumed
    const T* vrow = v + ((size_t)b * HW + ky * w + kx0) * E;
    for (int i = tid * VEC; i < nkx * E; i += NT * VEC)
      *reinterpret_cast<uint4*>(vs + i) =
          *reinterpret_cast<const uint4*>(vrow + i);
    __syncthreads();
    if (c0 < E) {
      const int prow = (ky - qy + md) * ws;
      for (int x = kx0; x <= kx1; ++x) {
        float vv[COLS];
        load4(vs + (x - kx0) * E + c0, vv);
#pragma unroll
        for (int c = 0; c < COLS; ++c) vv[c] = mm<ROUND>(vv[c]);
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const int dx = x - (qx0 + i) + md;
          if (dx >= 0 && dx < ws && qx0 + i < w) {
            const float p = P[i * ws2 + prow + dx];
#pragma unroll
            for (int c = 0; c < COLS; ++c) acc[i][c] += p * vv[c];
          }
        }
      }
    }
  }
  if (c0 < E) {
#pragma unroll
    for (int i = 0; i < TQ; ++i)
      if (qx0 + i < w)
        store4(out + ((size_t)b * HW + qy * w + qx0 + i) * E + c0, acc[i]);
  }
}

template <typename T, bool ROUND>
int launch(const void* q, const void* k, const void* v, const float* rel,
           void* out, int B, int h, int w, int D, int E, int md,
           cudaStream_t stream) {
  const int ws = 2 * md + 1, kw = TQ + 2 * md;
  const size_t smem = sizeof(T) * kw * E +
                      sizeof(float) * (TQ * D + kw * (D + 1) + TQ * ws * ws);
  const cudaError_t err = cudaFuncSetAttribute(
      local_attn_kernel<T, ROUND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h * ((w + TQ - 1) / TQ), B);
  local_attn_kernel<T, ROUND><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), rel, static_cast<T*>(out), h, w, D, E, md);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. Layouts (row-major, contiguous):
// q, k [B, h*w, D] (q pre-scaled), v and out [B, h*w, E], rel
// [B, h*w, (2*max_dis+1)^2] f32. Takes D <= 128, E <= 1024 with E % 8 == 0
// and max_dis <= 7. Returns the launch's CUDA error (0 on success).
extern "C" int rmem_local_window_attention(
    const void* q, const void* k, const void* v, const float* rel, void* out,
    int B, int h, int w, int D, int E, int max_dis, int is_bf16,
    int round_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 128 || E > MAX_E || E % 8 || max_dis > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return round_bf16 ? launch<__nv_bfloat16, true>(q, k, v, rel, out, B, h,
                                                    w, D, E, max_dis, s)
                      : launch<__nv_bfloat16, false>(q, k, v, rel, out, B, h,
                                                     w, D, E, max_dis, s);
  return round_bf16
             ? launch<float, true>(q, k, v, rel, out, B, h, w, D, E, max_dis, s)
             : launch<float, false>(q, k, v, rel, out, B, h, w, D, E, max_dis,
                                    s);
}
