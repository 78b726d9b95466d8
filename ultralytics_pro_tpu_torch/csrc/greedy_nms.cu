// K1: batched exact greedy NMS for Hopper (sm_90a), as a tile scan over rows
// sorted by score.
//
// Replaces ultralytics_pro_tpu/kernels/nms_pallas.py:pallas_greedy_nms (body
// _nms_kernel). Semantics are those of ultralytics_pro_tpu/ops/nms.py
// _greedy_nms_scores applied to every batch row (the argmax form: each step
// takes the highest live score, ties to the lowest index, and sets to -1 every
// score whose IoU with it exceeds iou_thres), on rows whose scores do not
// increase along K, with ties in index order: what a stable descending sort
// gives, and what every caller on the main path hands over (ops/nms.py _topk).
//
// On such a row the argmax form's winner at each step is the first live
// candidate, so exact greedy NMS is an in-order scan: candidate t is kept iff
// no box kept before it has IoU(kept, t) > iou_thres. Only kept boxes
// suppress, so a box suppressed by a suppressed box survives, as in the
// reference. The scan stops at max_det keeps, or at the first score that is
// not > 0 (every later one is <= 0 too). The argmax form relies on
// IoU(j, j) > iou_thres to retire a winner; a kept box that fails it (zero
// area, inverted, iou_thres >= 1) stays the argmax and is picked again in every
// remaining slot, so the scan fills them with it. A row that stops early keeps
// (0, 0) in its remaining slots.
//
// Bound: exact greedy needs, for each candidate ahead of the row's stop, the
// IoU tests against the keeps before it up to the first that suppresses it
// (some 17 float operations each) and one read of its box and score: a few
// microseconds of operations at most for a row of 300 keeps. What bounds this
// design is its dependent chain: ceil(stop / kTile) tile rounds of four block
// barriers each, the keep tests of a tile on one SM, and the rounds that
// settle its contested candidates.
// Design: one block per row, so rows run in parallel on separate SMs and each
// stops on its own. The row's keeps (box and area, 20 B each) sit in dynamic
// shared memory. Sorted candidates stream through shared memory in tiles of
// kTile = 64 by cp.async, double-buffered: the next tile loads while this one
// is tested, and only the tiles ahead of the stop are read, so K is not
// limited by shared memory. For each tile:
//   (a) each warp tests two candidates against all keeps so far, lanes over
//       the keeps, four tests in flight, with an early exit once a keep
//       suppresses both;
//   (b) each warp computes, for its two surviving candidates i, the column
//       mask col[i] of earlier survivors j of the tile with IoU(j, i) > thres
//       (ballots), and whether i suppresses itself;
//   (c) warp 0 resolves the tile: a survivor with col == 0 wins outright; the
//       others win iff no earlier winner is in their col, settled in rounds
//       of ballots (a round settles at least the lowest open one, and most
//       tiles need one or two). The winners are appended in order, up to
//       max_det or up to the first one that does not suppress itself, which
//       then fills the remaining slots.
//
// Exactness: every float operation is written with an explicit round-to-
// nearest intrinsic in the order of ops/nms.py:40-45, always with the earlier
// (winning) box in the winner's place, so no FMA contraction can change a bit
// (the build also passes -fmad=false) and each test equals the argmax form's.
// keep and valid then equal the plain PyTorch version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // candidates per tile: one 64-bit mask per candidate
static_assert(kTile == 2 * kWarps, "each warp owns two candidates of a tile");
constexpr int kKeepBytes = 16 + 4;  // a keep's box (float4) and area (float) in shared memory
using u64 = unsigned long long;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// The argmax form's test of candidate t against winner j (ops/nms.py:40-45):
// inter = clip(min(x2) - max(x1), 0) * clip(min(y2) - max(y1), 0)
// iou = inter / (area_j + area_t - inter + 1e-7) > thres
// Most pairs do not overlap. Where inter is +-0 the quotient is +-0 unless
// denom is +-0 or NaN (then NaN), so the test is decided without dividing.
__device__ __forceinline__ bool suppresses(float4 bj, float aj, float4 bt, float at, float thres) {
  const float w = fmaxf(__fsub_rn(fminf(bj.z, bt.z), fmaxf(bj.x, bt.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(bj.w, bt.w), fmaxf(bj.y, bt.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(aj, at), inter), 1e-7f);
  if (inter == 0.f) return 0.f > thres && fabsf(denom) > 0.f;
  return __fdiv_rn(inter, denom) > thres;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Tile [base, base + kTile) of the row into one buffer: threads 0..63 copy a
// box each, threads 64..127 a score each. Candidates past K are not copied;
// every reader checks base + i < k first.
__device__ __forceinline__ void load_tile(float4* tb, float* ts, const float4* row_boxes,
                                          const float* row_scores, int base, int k, int tid) {
  if (tid < kTile) {
    if (base + tid < k) cp_async16(tb + tid, row_boxes + base + tid);
  } else if (tid < 2 * kTile) {
    const int i = tid - kTile;
    if (base + i < k) cp_async4(ts + i, row_scores + base + i);
  }
}

__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores, int k,
                  int max_det, float iou_thres, int32_t* __restrict__ keep,
                  uint8_t* __restrict__ valid) {
  extern __shared__ float4 keep_box[];  // max_det boxes, then max_det areas
  float* keep_area = reinterpret_cast<float*>(keep_box + max_det);
  __shared__ float4 tile_box[2][kTile];
  __shared__ float tile_score[2][kTile];
  __shared__ u64 col[kTile];            // earlier survivors of the tile that suppress i
  __shared__ uint8_t survives[kTile];   // live and not suppressed by an earlier keep
  __shared__ uint8_t self_supp[kTile];  // IoU(i, i) > thres
  __shared__ int n_keep, done, fill;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4* row_boxes = boxes + static_cast<size_t>(row) * k;
  const float* row_scores = scores + static_cast<size_t>(row) * k;
  int32_t* row_keep = keep + static_cast<size_t>(row) * max_det;
  uint8_t* row_valid = valid + static_cast<size_t>(row) * max_det;

  if (tid == 0) {
    n_keep = 0;
    done = 0;
    fill = -1;
  }
  load_tile(tile_box[0], tile_score[0], row_boxes, row_scores, 0, k, tid);
  cp_async_commit();

  for (int base = 0, it = 0; base < k; base += kTile, ++it) {
    const int cur = it & 1;
    // Prefetch the next tile into the other buffer; the barrier that ended the
    // previous round guarantees nobody reads it any more.
    if (base + kTile < k)
      load_tile(tile_box[cur ^ 1], tile_score[cur ^ 1], row_boxes, row_scores, base + kTile, k, tid);
    cp_async_commit();
    cp_async_wait_one();  // this thread's copies of tile `cur` have landed
    __syncthreads();      // ... and everyone's
    const float4* tb = tile_box[cur];
    const float* ts = tile_score[cur];
    const int nk = n_keep;

    // (a) Each warp: its two candidates a = warp and b = warp + 32 against
    // the keeps so far, 64 keeps a step (lane and lane + 32): four
    // independent tests in flight, and an early exit once both are settled.
    const int ia = warp, ib = warp + kWarps;
    {
      bool live_a = base + ia < k && ts[ia] > 0.f;
      bool live_b = base + ib < k && ts[ib] > 0.f;
      const float4 ba = tb[ia], bb = tb[ib];
      const float aa = box_area(ba), ab = box_area(bb);
      for (int k0 = 0; k0 < nk && (live_a || live_b); k0 += 64) {
        const int k1 = k0 + lane, k2 = k0 + 32 + lane;
        const bool v1 = k1 < nk, v2 = k2 < nk;
        const float4 q1 = keep_box[v1 ? k1 : 0], q2 = keep_box[v2 ? k2 : 0];
        const float r1 = keep_area[v1 ? k1 : 0], r2 = keep_area[v2 ? k2 : 0];
        const bool s1a = suppresses(q1, r1, ba, aa, iou_thres);
        const bool s2a = suppresses(q2, r2, ba, aa, iou_thres);
        const bool s1b = suppresses(q1, r1, bb, ab, iou_thres);
        const bool s2b = suppresses(q2, r2, bb, ab, iou_thres);
        if (__any_sync(0xffffffffu, (v1 && s1a) || (v2 && s2a))) live_a = false;
        if (__any_sync(0xffffffffu, (v1 && s1b) || (v2 && s2b))) live_b = false;
      }
      if (lane == 0) {
        survives[ia] = live_a;
        survives[ib] = live_b;
      }
    }
    __syncthreads();

    // (b) Each warp: for its surviving candidates a and b, the earlier
    // survivors j of the tile that suppress them (lane and lane + 32), and
    // whether each suppresses itself.
    {
      const int j0 = lane, j1 = lane + 32;
      const bool sa = survives[ia], sb = survives[ib], s0 = survives[j0], s1 = survives[j1];
      const float4 ba = tb[ia], bb = tb[ib], b0 = tb[j0], b1 = tb[j1];
      const float aa = box_area(ba), ab = box_area(bb), a0 = box_area(b0), a1 = box_area(b1);
      const bool h0a = sa && s0 && j0 < ia && suppresses(b0, a0, ba, aa, iou_thres);
      const bool h0b = sb && s0 && suppresses(b0, a0, bb, ab, iou_thres);  // j0 < 32 <= ib
      const bool h1b = sb && s1 && j1 < ib && suppresses(b1, a1, bb, ab, iou_thres);
      const u64 mask_a = __ballot_sync(0xffffffffu, h0a);  // j1 >= 32 > ia
      const u64 mask_b = static_cast<u64>(__ballot_sync(0xffffffffu, h0b)) |
                         (static_cast<u64>(__ballot_sync(0xffffffffu, h1b)) << 32);
      if (lane == 0) {
        col[ia] = mask_a;
        col[ib] = mask_b;
        self_supp[ia] = sa && suppresses(ba, aa, ba, aa, iou_thres);
        self_supp[ib] = sb && suppresses(bb, ab, bb, ab, iou_thres);
      }
    }
    __syncthreads();

    // (c) Warp 0 resolves the tile and appends its winners in order.
    if (warp == 0) {
      const int i0 = lane, i1 = lane + 32;
      const u64 c0 = col[i0], c1 = col[i1];
      const u64 surv = static_cast<u64>(__ballot_sync(0xffffffffu, survives[i0])) |
                       (static_cast<u64>(__ballot_sync(0xffffffffu, survives[i1])) << 32);
      const u64 contested = static_cast<u64>(__ballot_sync(0xffffffffu, c0 != 0)) |
                            (static_cast<u64>(__ballot_sync(0xffffffffu, c1 != 0)) << 32);
      const u64 selfm = static_cast<u64>(__ballot_sync(0xffffffffu, self_supp[i0])) |
                        (static_cast<u64>(__ballot_sync(0xffffffffu, self_supp[i1])) << 32);
      // The row ends in this tile if a candidate here is past K or has a score
      // that is not > 0: every later score is <= 0 too.
      const bool end0 = !(base + i0 < k && ts[i0] > 0.f);
      const bool end1 = !(base + i1 < k && ts[i1] > 0.f);
      const bool ends = __any_sync(0xffffffffu, end0 || end1);

      // A survivor wins iff none of the earlier survivors in its col wins.
      // Those with an empty col win outright; the rest are settled in rounds:
      // a candidate loses once a winner is in its col and wins once all of
      // its col lost. The lowest undecided one is settled in every round.
      u64 won = surv & ~contested, lost = 0, undecided = contested;
      while (undecided) {  // uniform across the warp
        const bool o0 = (undecided >> i0) & 1, o1 = (undecided >> i1) & 1;
        const u64 w = static_cast<u64>(__ballot_sync(0xffffffffu, o0 && (c0 & ~lost) == 0)) |
                      (static_cast<u64>(__ballot_sync(0xffffffffu, o1 && (c1 & ~lost) == 0)) << 32);
        const u64 l = static_cast<u64>(__ballot_sync(0xffffffffu, o0 && (c0 & won) != 0)) |
                      (static_cast<u64>(__ballot_sync(0xffffffffu, o1 && (c1 & won) != 0)) << 32);
        won |= w;
        lost |= l;
        undecided &= ~(w | l);
      }
      // A winner that does not suppress itself ends the row: it fills every
      // slot left after the winners before it.
      const u64 lazy = won & ~selfm;
      int fill_pos = -1;
      if (lazy) {
        fill_pos = __ffsll(static_cast<long long>(lazy)) - 1;
        won &= (1ull << fill_pos) - 1;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = lane + half * 32;
        if ((won >> i) & 1) {
          const int slot = nk + __popcll(won & ((1ull << i) - 1));
          if (slot < max_det) {
            row_keep[slot] = base + i;
            row_valid[slot] = 1;
            keep_box[slot] = tb[i];
            keep_area[slot] = box_area(tb[i]);
          }
        }
      }
      const int nk_new = min(max_det, nk + __popcll(won));
      if (lane == 0) {
        n_keep = nk_new;
        if (fill_pos >= 0 && nk_new < max_det) fill = base + fill_pos;
        done = ends || fill_pos >= 0 || nk_new == max_det;
      }
    }
    __syncthreads();  // keeps, n_keep and done visible; tile `cur` free for reuse
    if (done) break;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // no copy outlives the block

  // Slots after the keeps: the lazy winner, or (0, 0) where the row ran out.
  const int nk = n_keep;
  const int f = fill;
  for (int s = nk + tid; s < max_det; s += kThreads) {
    row_keep[s] = f >= 0 ? f : 0;
    row_valid[s] = f >= 0;
  }
}

}  // namespace

extern "C" {

// Once per device, before the first launch on it: opts the kernel in to the
// device's whole per-block shared memory and writes the largest max_det whose
// keeps fit there to *max_keep. Launches with a larger max_det fail; the
// caller checks.
int upt_greedy_nms_init(int* max_keep) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, greedy_nms_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dynamic = optin - static_cast<int>(attr.sharedSizeBytes);
  err = cudaFuncSetAttribute(greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dynamic);
  if (err != cudaSuccess) return static_cast<int>(err);
  *max_keep = dynamic / kKeepBytes;
  return static_cast<int>(cudaSuccess);
}

// boxes (batch, k, 4) f32 xyxy, class offset applied, 16-byte aligned;
// scores (batch, k) f32, each row non-increasing with ties in index order
// (invalid candidates < 0 at the end); keep (batch, max_det) int32 and valid
// (batch, max_det) uint8 are written in full. The caller has run
// upt_greedy_nms_init on this device and checked max_det against its
// max_keep. Returns the cudaError_t of the launch; never falls back.
int upt_greedy_nms(const void* boxes, const void* scores, void* keep, void* valid, int batch,
                   int k, int max_det, float iou_thres, void* stream) {
  const size_t smem = static_cast<size_t>(max_det) * kKeepBytes;
  greedy_nms_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores), k, max_det,
      iou_thres, static_cast<int32_t*>(keep), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

const char* upt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
