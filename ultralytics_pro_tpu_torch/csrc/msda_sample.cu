// K2: multiscale deformable-attention gather-accumulate for Hopper (sm_90a).
//
// Replaces ultralytics_pro_tpu/kernels/msda_pallas.py:msda_sample_pallas
// (body _msda_kernel). For every (batch*head bh, query q):
//
//     out[bh, q, :] = sum_{s < S} w[bh, q, s] * val[bh, idx[bh, q, s], :]
//
// over the S = L*P*4 bilinear corners that msda_flatten_coords produced. An
// index outside [0, V) adds nothing and is never read, as in the Pallas
// kernel, where such an index matches no column of its one-hot tile.
//
// What it computes, not how the TPU did it: the Pallas body builds a weighted
// one-hot (64, V) tile and multiplies it by the VMEM-resident (V, hd) table on
// the MXU, a workaround for slow TPU gathers. Hopper gathers directly.
//
// Bound: bytes. Each (bh, q, s) costs 2*hd operations (one multiply-add per
// channel), against hd*4 bytes of the value row it gathers plus 8 bytes of
// idx and w. At the rtdetr-l predict shape (B=1: bh = 8, V = 8400, hd = 32,
// Q = 300, S = 48) that is about 9.8 MB: the 8.6 MB table if every row is
// touched, 0.92 MB of idx + w and 0.31 MB of out, about 3 us at 3.35 TB/s.
// Design: one warp per (bh, q), lanes over the hd channels (a loop for
// hd > 32, a mask for hd < 32). Each lane walks s = 0..S-1 in that fixed
// order with an f32 accumulator; at hd = 32 the warp reads one coalesced
// 128-byte value row per step and stores its out row coalesced. idx and w of
// a step are the same address for the whole warp (one broadcast load). Rows
// of one bh are gathered by 300 neighbouring warps, so the table stays in
// L2 (8.6 MB of 50 MB) and device memory sees each row about once.
// At B = 1 the bytes take ~3 us, about one kernel launch: launch latency,
// not bytes, sets the time. The design's answer is to launch once per
// decoder layer on the current stream with no host synchronisation and no
// allocation but the output, so the launch queues behind the layer's earlier
// kernels while the host runs ahead; removing the remaining per-launch cost
// (a CUDA graph over the decoder, msda_flatten_coords fused into this
// kernel) is later work.
//
// Offsets are 64-bit. The sum is a fused multiply-add per step, so it may
// differ from the plain version's rounding in the last bits; the tests hold
// it at 1e-5.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
msda_sample_kernel(const float* __restrict__ val, const int32_t* __restrict__ idx,
                   const float* __restrict__ w, float* __restrict__ out, int64_t rows, int v,
                   int q, int s, int hd) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // row = bh * q + query
  const int lane = threadIdx.x & 31;
  const int64_t bh = row / q;
  const float* table = val + bh * static_cast<int64_t>(v) * hd;
  const int32_t* ip = idx + row * s;
  const float* wp = w + row * s;
  float* op = out + row * hd;
  for (int c = lane; c - lane < hd; c += 32) {
    const bool live = c < hd;
    float acc = 0.0f;
    for (int k = 0; k < s; ++k) {
      const int r = __ldg(ip + k);
      const float wk = __ldg(wp + k);
      if (live && r >= 0 && r < v) {
        acc = __fmaf_rn(wk, __ldg(table + static_cast<int64_t>(r) * hd + c), acc);
      }
    }
    if (live) op[c] = acc;
  }
}

}  // namespace

extern "C" {

// val (bh, v, hd) f32, idx (bh, q, s) int32, w (bh, q, s) f32, out (bh, q, hd)
// f32, all contiguous on the current device; bh = batch * heads. out is
// written in full. Returns the cudaError_t of the launch; never falls back.
int upt_msda_sample(const void* val, const void* idx, const void* w, void* out, int bh, int v,
                    int q, int s, int hd, void* stream) {
  const int64_t rows = static_cast<int64_t>(bh) * q;
  if (rows == 0 || hd == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  msda_sample_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(val), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<float*>(out), rows, v, q, s, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
