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
// What bounds it on the H100: at that path's shape (2 heads, D=128,
// Dv=512 per head, 9 live slots of 920 keys, 920 queries) one launch is
// ~19.5 GFLOP against ~21 MB of operands, so it is bound by operations and
// the products run on the tensor cores. The device code is the read of
// memory_read_tc.cuh, shared with kernel B1: a warp-specialised Hopper
// kernel (a TMA ring filled by a producer warpgroup, wgmma consumer
// warpgroups with P in registers), one launch where one unit covers a
// query tile's bank, else the bank split over blocks by slot and merged by
// a second launch that yields the mass. The header says why.
//
// What the design does about the Pallas kernel's layout needs:
// - The Pallas caller transposes q, K and V into a head-folded [B*H, ...]
//   layout and concatenates V||ID_V first, both bank-sized copies. Here the
//   heads are read by stride from the storage layout [B, T, HWk, H*D], and
//   the value may be given as two banks whose channel-wise concatenation is
//   meant: head h owns columns [h*Dv, (h+1)*Dv) of [v1 | v2]. The folded
//   layout is the case H == 1.
// - The sequential Pallas grid (slot, key block) becomes a split over
//   blocks and a merge; `valid` is per batch row and shared by its heads.
#include "memory_read_tc.cuh"

// C interface, bound with ctypes. Layouts (row-major, contiguous), all
// operands bf16 (the wrapper rounds f32 storage first): q [B, HWq, H*D]
// (pre-scaled), k [B, T, HWk, H*D], v1 [B, T, HWk, wv1], v2 [B, T, HWk,
// H*Dv - wv1] or null (then wv1 == H*Dv), valid [B, T] int32, out
// [B, HWq, H*Dv] f32, mass [B, H, HWq, T] f32; f32 scratch part_acc
// [B, n_split, HWq, H*Dv], part_m [B, H, n_split, HWq], slot_ml
// [B, H, n_split, HWq, T, 2]. heads_per_block (8) picks the
// several-heads-per-block kernel (D <= 32, Dv <= 32), 0 the one-head
// kernel (D in {16, 32, 64, 128}). Dv and wv1 are multiples of 8. The
// one-head kernel at n_split == 1 is one launch and reads no scratch (it
// may be null); else two: the split read and its combine. Returns
// cudaGetLastError() after them.
extern "C" int rmem_memory_read_attention(
    const void* q, const void* k, const void* v1, const void* v2,
    const int* valid, float* out, float* mass, float* part_acc,
    float* part_m, void* slot_ml, int B, int H, int T_cap, int HWq, int HWk,
    int D, int Dv, int wv1, int n_split, int heads_per_block, void* stream) {
  using rmem::tc::bf16;
  const int wv2 = H * Dv - wv1;
  if (wv1 <= 0 || wv2 < 0 || (wv2 > 0) != (v2 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const rmem::tc::ReadArgs a = {
      static_cast<const bf16*>(q),  static_cast<const bf16*>(k),
      nullptr,                      static_cast<const bf16*>(v1),
      static_cast<const bf16*>(v2), valid,
      part_acc,                     part_m,
      static_cast<float2*>(slot_ml), H,
      T_cap,                        HWq,
      HWk,                          D,
      Dv,                           wv1,
      wv2,                          n_split};
  const rmem::tc::OutArgs o = {out, nullptr, mass, H * Dv, 0, 0};
  return static_cast<int>(rmem::tc::launch<rmem::tc::AttentionRead>(
      a, o, B, heads_per_block, static_cast<cudaStream_t>(stream)));
}
