// Kernel B3: multi-head long-term memory read of the RMem bank.
//
// Replaces the Pallas TPU kernel `memory_read_attention`
// (rmem_ocu_tpu/ops/pallas/memory_read.py:88, body _kernel :29-83) and the
// head folding of its caller `memory_read_multihead` (:427-463): one pass of
// online-softmax attention of every head's queries over every live slot of
// the position-indirected bank, returning P.V in f32 and the per-slot,
// per-head attention mass sum(p)/l that drives eviction. There is no
// temporal-PE term: the caller adds the PE to the keys first. DeAOT with
// two attention heads (no_memory_gap) reads its bank through it.
//
// What bounds it on the H100: at that path's shape (2 heads, D=128, Dv=512
// per head, 9 live slots of 920 keys, 920 queries) one launch is ~19.5
// GFLOP against ~21 MB of operands, so it is bound by operations and the
// products run on the tensor cores: the device code is the read of
// memory_read_tc.cuh, shared with kernel B1.
//
// What the design does about the Pallas kernel's layout needs:
// - The Pallas caller transposes q, K and V into a head-folded [B*H, ...]
//   layout and concatenates V||ID_V first, both bank-sized copies. Here the
//   heads are read by stride from the storage layout [B, T, HWk, H*D], and
//   the value may be given as two banks whose channel-wise concatenation is
//   meant: head h owns columns [h*Dv, (h+1)*Dv) of [v1 | v2]. The folded
//   layout is the case H == 1.
// - The sequential Pallas grid (slot, key block) becomes loops inside one
//   block; `valid` is per batch row and shared by its heads.
#include "memory_read_tc.cuh"

namespace {

template <typename T>
bool launch(const void* q, const void* k, const void* v1, const void* v2,
            const int* valid, float* out, float* mass, int B, int H,
            int T_cap, int HWq, int HWk, int D, int Dv, int wv1,
            cudaStream_t stream) {
  const rmem::tc::ReadArgs<T, float> a = {
      static_cast<const T*>(q),  static_cast<const T*>(k),
      nullptr,                   static_cast<const T*>(v1),
      static_cast<const T*>(v2), valid,
      out,                       nullptr,
      mass,                      H,
      T_cap,                     HWq,
      HWk,                       Dv,
      wv1,                       H * Dv - wv1,
      H * Dv,                    0};
  return rmem::tc::launch<rmem::tc::AttentionRead>(a, B, D, stream);
}

}  // namespace

// C interface, bound with ctypes. Layouts (row-major, contiguous):
// q [B, HWq, H*D] (pre-scaled), k [B, T, HWk, H*D], v1 [B, T, HWk, wv1],
// v2 [B, T, HWk, H*Dv - wv1] or null (then wv1 == H*Dv), valid [B, T]
// int32, out [B, HWq, H*Dv] f32, mass [B, H, HWq, T] f32. Operands are
// rounded to bf16 whatever the storage type (is_bf16: bf16 storage, else
// f32). D in {16, 32, 64, 128}; Dv and wv1 multiples of 8. Returns
// cudaGetLastError() after the launch.
extern "C" int rmem_memory_read_attention(
    const void* q, const void* k, const void* v1, const void* v2,
    const int* valid, float* out, float* mass, int B, int H, int T_cap,
    int HWq, int HWk, int D, int Dv, int wv1, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wv2 = H * Dv - wv1;
  if (T_cap > rmem::tc::MAX_T || Dv % 8 || wv1 % 8 || wv1 <= 0 || wv2 < 0 ||
      (wv2 > 0) != (v2 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ok =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v1, v2, valid, out, mass, B, H,
                                      T_cap, HWq, HWk, D, Dv, wv1, s)
              : launch<float>(q, k, v1, v2, valid, out, mass, B, H, T_cap,
                              HWq, HWk, D, Dv, wv1, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
