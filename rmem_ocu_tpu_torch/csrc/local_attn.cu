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
// ~0.4 GFLOP of in-window products, so it is bound by bytes (1.5 us). The
// first design ran the logits as serial 128-term dot products in 15 of 32
// lanes and P.V on the FP32 pipes, in 115 blocks of 8 queries that read
// each value row ~40 times over the grid.
//
// The design here (`local_attn_tc`, bf16 operands):
// - A block owns a patch of 4 image rows x 16 columns (64 queries, one
//   warp per image row and value half) and 128 value columns (grid y). It
//   walks the key rows of the union of its queries' windows, (4 + 2*md)
//   rows of a (16 + 2*md)-token run each, through a two-stage cp.async
//   ring: first the key runs, then the value runs, the copy of run i+1 in
//   flight while the tensor cores work on run i. Keys outside the image
//   are zero-filled by the copy.
// - Q.K^T over each key run on the tensor cores (mma.sync m16n8k16, f32
//   accumulate); the entries inside a query's window are added, by gather
//   of their offset, onto that query's bias row rel[q, dy*ws + dx] staged
//   in shared memory. The union wastes ~2x the products; the kernel is
//   bound by bytes, not products.
// - The softmax runs over each query's ws*ws entries in shared memory in
//   f32. Entries whose key lies outside the image get probability exactly
//   0, as the reference's -1e8 bias gives; the normalised p is rounded to
//   bf16 as the reference rounds it.
// - P.V over the same value runs on the tensor cores, the A operand read
//   from the window rows (0 outside a query's window), f32 accumulators in
//   registers, one store per output element.
// The f32 mode (round_bf16 = 0, no caller on any path) keeps the first
// design, `scalar::local_attn_kernel`, on the FP32 pipes.
#include "memory_read_tc.cuh"

namespace scalar {

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

}  // namespace scalar

namespace {

using rmem::tc::bf16;
using rmem::tc::cp_async16;
using rmem::tc::cp_async_commit;
using rmem::tc::cp_async_wait;
using rmem::tc::ldmatrix_x4;
using rmem::tc::ldmatrix_x4_trans;
using rmem::tc::mma;
using rmem::tc::pack_bf16;
using rmem::tc::store2;

constexpr int PR = 4;              // query image rows per block
constexpr int PC = 16;             // query image columns per block
constexpr int NQ = PR * PC;        // queries per block
constexpr int RUN = 32;            // key run staged per key row (>= PC + 2*md)
constexpr int BN = 128;            // value columns per block
constexpr int NW = 8;              // warps: PR rows x 2 halves
constexpr int NTC = 32 * NW;
constexpr int LDV = BN + 8;

struct TcSmem {
  int ldq;                         // D + 8
  size_t q, k, v, p, bytes;
  __host__ __device__ TcSmem(int D, int ws2) : ldq(D + 8) {
    q = 0;
    k = q + sizeof(bf16) * NQ * ldq;
    v = k + sizeof(bf16) * 2 * RUN * ldq;
    p = v + sizeof(bf16) * 2 * RUN * LDV;
    bytes = p + sizeof(float) * NQ * ws2;
  }
};

// grid (patches, value chunks of BN, B). q, k, v bf16, rel f32.
template <typename TO>
__global__ void __launch_bounds__(NTC) local_attn_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ rel,
    TO* __restrict__ out, int h, int w, int D, int E, int md) {
  const int ws = 2 * md + 1, ws2 = ws * ws, HW = h * w;
  const TcSmem S(D, ws2);
  const int LDQ = S.ldq;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + S.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + S.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + S.v);
  float* ps = reinterpret_cast<float*>(smem + S.p);  // [NQ][ws2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % PR, cw = warp / PR;
  const int tiles_x = (w + PC - 1) / PC;
  const int qy0 = (blockIdx.x / tiles_x) * PR;
  const int qx0 = (blockIdx.x % tiles_x) * PC;
  const int col0 = blockIdx.y * BN, b = blockIdx.z;
  const int ky_lo = max(qy0 - md, 0), ky_hi = min(qy0 + PR - 1 + md, h - 1);
  const int n_rows = ky_hi - ky_lo + 1;
  const int kx0 = qx0 - md;        // key column of run position 0
  const size_t tok0 = (size_t)b * HW;

  for (int i = tid; i < NQ * (D / 8); i += NTC) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int qy = qy0 + r / PC, qx = qx0 + r % PC;
    const bool ok = qy < h && qx < w;
    cp_async16(&qs[r * LDQ + c], ok ? q + (tok0 + qy * w + qx) * D + c : q,
               ok);
  }
  // tiles 0..n_rows-1 are key runs, n_rows..2*n_rows-1 value runs. A
  // thread copies the same 8 columns of every key (D / 8 divides NTC).
  const int kc = (tid % (D / 8)) * 8, kj0 = tid / (D / 8);
  const int kstep = NTC / (D / 8);
  auto issue = [&](int n) {
    const int ky = ky_lo + (n < n_rows ? n : n - n_rows);
    const size_t row0 = tok0 + (size_t)ky * w;
    if (n < n_rows) {
      bf16* kst = ks + (n % 2) * RUN * LDQ;
      for (int j = kj0; j < RUN; j += kstep) {
        const int kx = kx0 + j;
        const bool ok = kx >= 0 && kx < w;
        cp_async16(&kst[j * LDQ + kc], ok ? k + (row0 + kx) * D + kc : k,
                   ok);
      }
    } else {
      bf16* vst = vs + ((n - n_rows) % 2) * RUN * LDV;
      for (int i = tid; i < RUN * (BN / 8); i += NTC) {
        const int j = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const int kx = kx0 + j;
        const bool ok = kx >= 0 && kx < w && col0 + c < E;
        cp_async16(&vst[j * LDV + c],
                   ok ? v + (row0 + kx) * E + col0 + c : v, ok);
      }
    }
  };
  issue(0);
  cp_async_commit();
  // the bias rows of the block's queries, a warp per row
  for (int r = warp; r < NQ; r += NW) {
    const int qy = qy0 + r / PC, qx = qx0 + r % PC;
    const bool in_img = qy < h && qx < w;
    const float* src = rel + (tok0 + (in_img ? qy * w + qx : 0)) * ws2;
    for (int j = lane; j < ws2; j += 32)
      ps[r * ws2 + j] = in_img ? src[j] : 0.f;
  }

  const int qy = qy0 + rw;         // this warp's query image row
  const int i_lo = lane / 4, i_hi = i_lo + 8;  // its fragment rows
  float* p_lo = ps + (rw * PC + i_lo) * ws2;
  float* p_hi = ps + (rw * PC + i_hi) * ws2;
  float acc[BN / 2 / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 2 / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int n = 0; n < 2 * n_rows; ++n) {
    cp_async_wait<0>();
    // run n (and the q tile, the bias rows) is in, and every warp is done
    // with run n - 1, whose stage the copy of run n + 1 now refills
    __syncthreads();
    if (n + 1 < 2 * n_rows) {
      issue(n + 1);
      cp_async_commit();
    }
    const int ky = ky_lo + (n < n_rows ? n : n - n_rows);
    const int dy = ky - qy + md;
    const bool in_win = qy < h && dy >= 0 && dy < ws;  // warp-uniform
    if (n < n_rows) {
      if (in_win) {
        // logits of the 16 queries against run keys cw*16 .. cw*16+15
        const bf16* kst = ks + (n % 2) * RUN * LDQ;
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qa[4], kb[4];
          ldmatrix_x4(qa, &qs[(rw * PC + (lane % 16)) * LDQ + kk * 16 +
                              (lane / 16) * 8]);
          ldmatrix_x4(kb, &kst[(cw * 16 + (lane % 8) + (lane / 16) * 8) *
                                   LDQ +
                               kk * 16 + ((lane / 8) % 2) * 8]);
          mma(s[0], qa, kb[0], kb[1]);
          mma(s[1], qa, kb[2], kb[3]);
        }
        // add each in-window logit onto its query's bias entry
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = cw * 16 + nt * 8 + (lane % 4) * 2 + e;
            const int dx_lo = j - i_lo, dx_hi = j - i_hi;
            if (dx_lo >= 0 && dx_lo < ws) p_lo[dy * ws + dx_lo] += s[nt][e];
            if (dx_hi >= 0 && dx_hi < ws)
              p_hi[dy * ws + dx_hi] += s[nt][2 + e];
          }
      }
      if (n == n_rows - 1) {
        __syncthreads();  // every logit is in
        // softmax over each query's window; keys outside the image get 0
        for (int r = warp; r < NQ; r += NW) {
          const int ry = qy0 + r / PC, rx = qx0 + r % PC;
          float* pr = ps + r * ws2;
          if (ry >= h || rx >= w) {
            for (int j = lane; j < ws2; j += 32) pr[j] = 0.f;
            continue;
          }
          // window offset (dy, dx) of entry j, stepped by 32 entries
          float mx = -INFINITY;
          int wy = lane / ws, wx = lane % ws;
          for (int j = lane; j < ws2; j += 32) {
            const int y = ry + wy - md, x = rx + wx - md;
            const bool img = y >= 0 && y < h && x >= 0 && x < w;
            pr[j] = img ? pr[j] : -INFINITY;
            mx = fmaxf(mx, pr[j]);
            wy += 32 / ws;
            wx += 32 % ws;
            if (wx >= ws) {
              wx -= ws;
              ++wy;
            }
          }
          mx = rmem::warp_max(mx);
          float sum = 0.f;
          for (int j = lane; j < ws2; j += 32) {
            const float e = expf(pr[j] - mx);
            pr[j] = e;
            sum += e;
          }
          sum = rmem::warp_sum(sum);
          for (int j = lane; j < ws2; j += 32)
            pr[j] = __bfloat162float(__float2bfloat16_rn(pr[j] / sum));
        }
      }
    } else if (in_win) {
      // O += P V over this warp's 64 value columns
      const bf16* vst = vs + ((n - n_rows) % 2) * RUN * LDV;
#pragma unroll
      for (int kk = 0; kk < RUN / 16; ++kk) {
        float pv[2][2][2];  // [row lo/hi][key +0/+8][pair]
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = hi ? i_hi : i_lo;
              const int dx = kk * 16 + kh * 8 + (lane % 4) * 2 + e - i;
              pv[hi][kh][e] = (dx >= 0 && dx < ws)
                                  ? (hi ? p_hi : p_lo)[dy * ws + dx]
                                  : 0.f;
            }
        const uint32_t pa[4] = {pack_bf16(pv[0][0][0], pv[0][0][1]),
                                pack_bf16(pv[1][0][0], pv[1][0][1]),
                                pack_bf16(pv[0][1][0], pv[0][1][1]),
                                pack_bf16(pv[1][1][0], pv[1][1][1])};
#pragma unroll
        for (int jp = 0; jp < BN / 2 / 16; ++jp) {
          uint32_t vb[4];
          ldmatrix_x4_trans(
              vb, &vst[(kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDV +
                       cw * (BN / 2) + jp * 16 + (lane / 16) * 8]);
          mma(acc[2 * jp], pa, vb[0], vb[1]);
          mma(acc[2 * jp + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }

  if (qy >= h) return;
#pragma unroll
  for (int j = 0; j < BN / 2 / 8; ++j) {
    const int c = col0 + cw * (BN / 2) + j * 8 + (lane % 4) * 2;
    if (c >= E) continue;
    if (qx0 + i_lo < w)
      store2(out + (tok0 + qy * w + qx0 + i_lo) * E + c, acc[j][0],
             acc[j][1]);
    if (qx0 + i_hi < w)
      store2(out + (tok0 + qy * w + qx0 + i_hi) * E + c, acc[j][2],
             acc[j][3]);
  }
}

template <typename TO>
int launch_tc(const void* q, const void* k, const void* v, const float* rel,
              void* out, int B, int h, int w, int D, int E, int md,
              cudaStream_t stream) {
  const int ws = 2 * md + 1;
  const size_t smem = TcSmem(D, ws * ws).bytes;
  static bool raised = false;  // to the largest size, once per TO
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        local_attn_tc<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(TcSmem(128, 15 * 15).bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid(((h + PR - 1) / PR) * ((w + PC - 1) / PC),
                  (E + BN - 1) / BN, B);
  local_attn_tc<TO><<<grid, NTC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), rel, static_cast<TO*>(out), h, w, D, E,
      md);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. Layouts (row-major, contiguous):
// q, k [B, h*w, D] (q pre-scaled), v and out [B, h*w, E], rel
// [B, h*w, (2*max_dis+1)^2] f32; max_dis <= 7, E % 8 == 0.
// - round_bf16: the tensor-core kernel; q, k, v are bf16 whatever the
//   output type (is_bf16: bf16 output, else f32); D in {16, 32, 64, 128}.
// - else the f32 kernel in the storage type (is_bf16); D <= 128,
//   E <= 1024.
// Returns the launch's CUDA error (0 on success).
extern "C" int rmem_local_window_attention(
    const void* q, const void* k, const void* v, const float* rel, void* out,
    int B, int h, int w, int D, int E, int max_dis, int is_bf16,
    int round_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 128 || E % 8 || max_dis > 7 || 2 * max_dis + PC > RUN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (round_bf16) {
    if (D != 16 && D != 32 && D != 64 && D != 128)
      return static_cast<int>(cudaErrorInvalidValue);
    return is_bf16 ? launch_tc<__nv_bfloat16>(q, k, v, rel, out, B, h, w, D,
                                              E, max_dis, s)
                   : launch_tc<float>(q, k, v, rel, out, B, h, w, D, E,
                                      max_dis, s);
  }
  if (E > scalar::MAX_E) return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? scalar::launch<__nv_bfloat16, false>(q, k, v, rel, out, B,
                                                        h, w, D, E, max_dis, s)
                 : scalar::launch<float, false>(q, k, v, rel, out, B, h, w, D,
                                                E, max_dis, s);
}

// Registers, shared memory bytes (static + dynamic) and local (spill)
// bytes per thread of the tensor-core kernel at head dim D and max_dis,
// into out[3]. Returns the CUDA error of the query.
extern "C" int rmem_local_attn_info(int D, int max_dis, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, local_attn_tc<bf16>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ws = 2 * max_dis + 1;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes + TcSmem(D, ws * ws).bytes);
  out[2] = static_cast<int>(fa.localSizeBytes);
  return 0;
}
