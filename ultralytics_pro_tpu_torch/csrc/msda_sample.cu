// K2: multiscale deformable-attention sampling for Hopper (sm_90a), with the
// bilinear coordinate math fused in.
//
// Replaces ultralytics_pro_tpu/kernels/msda_pallas.py:msda_sample_pallas
// (body _msda_kernel) together with the corner math that feeds it there
// (msda_flatten_coords:83). For every (batch b, query q, head h):
//
//     out[b, q, h, :] = sum over levels l, points p, corners c of
//                       w[l, p, c] * value[b, start_l + row[l, p, c], h, :]
//
// where the corners and weights are those of grid_sample with
// align_corners=False on level l's (H_l, W_l) map: pixel x = loc_x * W_l - 0.5,
// x0 = floor(x), dx = x - x0, corner weights (1-dx)(1-dy), dx(1-dy), (1-dx)dy,
// dx dy, each times attn[b, q, h, l, p]. A corner outside the map weighs 0 and
// is never read, as its clipped row adds 0 in the Pallas kernel.
//
// Arithmetic: the coordinate math runs in the order of the port's
// msda_flatten_coords (kernels/msda_cuda.py) with explicit round-to-nearest
// intrinsics, so floor(x * W - 0.5) cannot flip under contraction (the build
// also passes -fmad=false) and every corner row and weight equals the plain
// version's. The sum is an f32 fused multiply-add per corner in the fixed
// (level, point, corner) order; against the plain version's sum, which rounds
// each product, the tests allow 1e-5.
//
// Bound: bytes. Each corner costs 2*hd operations against hd*4 bytes of the
// value row it gathers; the inputs are the distinct value rows the locations
// touch, locs (8 B a point) and attn (4 B a point), and out. At the rtdetr-l
// predict shape (B = 1, 8 heads of hd = 32, V = 8400, Q = 300, 3 levels of 4
// points) that is about 5 MB, some 1.5 us at 3.35 TB/s.
// Design: one warp per (b, q, h), lanes over the hd channels (a loop for
// hd > 32, a mask below). Lane p first computes sampling point p's four
// corners (row, weight) in registers; __shfl_sync then hands each corner to
// the channel lanes, which read one coalesced 128-byte value row per corner
// (hd = 32). The warp issues the gathers of kBatch points (4 * kBatch rows)
// before it consumes any, so they are in flight together instead of a chain
// of dependent loads. The value table is read in place in the (B, V, nh, hd)
// layout that value_proj produces, and out is written as (B, Q, nh, hd), the
// (B, Q, C) that output_proj takes: no corner tensors, no transpose copies,
// one launch per decoder layer. Offsets are 64-bit.
//
// The backward (msda_sample_fused_backward_kernel) is the gradient that
// autograd takes through the plain version, for training. The JAX package has
// no backward kernel: it differentiates its XLA gather. For every (b, q, h)
// and every corner k of point (l, p) inside its map, with wt = cw * attn and
// dot_k = <value[b, row_k, h, :], grad_out[b, q, h, :]>:
//
//     grad_value[b, row_k, h, :] += wt_k * grad_out[b, q, h, :]
//     grad_attn[b, q, h, l, p]    = sum_k cw_k * dot_k
//     grad_locs[..., 0] = attn * W_l * ((1-dy) (dot_1 - dot_0) + dy (dot_3 - dot_2))
//     grad_locs[..., 1] = attn * H_l * ((1-dx) (dot_2 - dot_0) + dx (dot_3 - dot_1))
//
// floor() and the in-map test pass no gradient, and a corner outside the map
// contributes nothing, as in autograd. Design, first and simple: one warp per
// (b, q, h), as the forward; lane p recomputes point p's corners exactly as
// the forward does, each corner is handed to the channel lanes, which read
// its value row, take dot_k by a warp-shuffle reduction and atomicAdd
// wt_k * grad_out into grad_value (zeroed by the wrapper). The point's owner
// lane then writes its grad_attn and grad_locs once. grad_value's sums land
// in an order that changes from run to run (the atomics); the tests hold it
// to the plain version within a tolerance, not bit for bit.
// Bound: bytes. grad_value is zero-filled and written in full (B*V*nh*hd*4
// bytes, 137.6 MB at rtdetr-l's train shape, B = 16), against the distinct
// value rows, grad_out, locs and attn read and grad_locs, grad_attn written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxLevels = 8;
constexpr int kBatch = 4;  // points whose gathers a warp keeps in flight together

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];  // first row of the level in the concatenated table
};

// Sampling point `pt`'s four corners: rows into the table (-1 outside the map)
// and weights, in msda_flatten_coords' corner order.
__device__ __forceinline__ void corners(const float* __restrict__ locs,
                                        const float* __restrict__ attn, int pt, int npl,
                                        const Levels& lv, int (&row)[4], float (&wt)[4]) {
  const int l = pt / npl;
  int hl = 0, wl = 0, start = 0;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {  // constant indices keep lv in the parameter bank
    if (i == l) {
      hl = lv.h[i];
      wl = lv.w[i];
      start = lv.start[i];
    }
  }
  const float x = __fsub_rn(__fmul_rn(__ldg(locs + 2 * pt), static_cast<float>(wl)), 0.5f);
  const float y = __fsub_rn(__fmul_rn(__ldg(locs + 2 * pt + 1), static_cast<float>(hl)), 0.5f);
  const float a = __ldg(attn + pt);
  const float x0 = floorf(x), y0 = floorf(y);
  const float dx = __fsub_rn(x, x0), dy = __fsub_rn(y, y0);
  const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
  const float ox = __fsub_rn(1.f, dx), oy = __fsub_rn(1.f, dy);
  const float cx[4] = {x0, x1, x0, x1};
  const float cy[4] = {y0, y0, y1, y1};
  const float cw[4] = {__fmul_rn(ox, oy), __fmul_rn(dx, oy), __fmul_rn(ox, dy), __fmul_rn(dx, dy)};
  const float xmax = static_cast<float>(wl - 1), ymax = static_cast<float>(hl - 1);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const bool in = cx[c] >= 0.f && cx[c] <= xmax && cy[c] >= 0.f && cy[c] <= ymax;
    row[c] = in ? start + static_cast<int>(cy[c]) * wl + static_cast<int>(cx[c]) : -1;
    wt[c] = in ? __fmul_rn(cw[c], a) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
msda_sample_fused_kernel(const float* __restrict__ value, const float* __restrict__ locs,
                         const float* __restrict__ attn, float* __restrict__ out, int64_t units,
                         int q, int nh, int hd, int v, int npts, int npl, Levels lv) {
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (unit >= units) return;  // unit = (b * q + query) * nh + head
  const int lane = threadIdx.x & 31;
  const int64_t b = unit / (static_cast<int64_t>(q) * nh);
  const int h = static_cast<int>(unit % nh);
  const int64_t row_stride = static_cast<int64_t>(nh) * hd;
  const float* table = value + b * v * row_stride + static_cast<int64_t>(h) * hd;
  const float* lp = locs + unit * npts * 2;
  const float* ap = attn + unit * npts;
  float* op = out + unit * hd;

  for (int c0 = 0; c0 < hd; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < hd;
    float acc = 0.f;
    for (int p0 = 0; p0 < npts; p0 += 32) {
      int row[4] = {-1, -1, -1, -1};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (p0 + lane < npts) corners(lp, ap, p0 + lane, npl, lv, row, wt);
      const int n = min(32, npts - p0);
      for (int s = 0; s < n; s += kBatch) {
        int r[kBatch][4];
        float wk[kBatch][4], g[kBatch][4];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            r[u][k] = __shfl_sync(0xffffffffu, row[k], s + u);
            wk[u][k] = __shfl_sync(0xffffffffu, wt[k], s + u);
            g[u][k] = live && r[u][k] >= 0 ? __ldg(table + r[u][k] * row_stride + c) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (r[u][k] >= 0) acc = __fmaf_rn(wk[u][k], g[u][k], acc);
          }
        }
      }
    }
    if (live) op[c] = acc;
  }
}

// Sampling point `pt`'s corners as corners() computes them, for the backward:
// rows (-1 outside the map), the bilinear weights cw before attn (kept for a
// corner outside the map, whose dot is 0), attn, dx, dy and the level's size.
__device__ __forceinline__ void corners_for_grad(const float* __restrict__ locs,
                                                 const float* __restrict__ attn, int pt, int npl,
                                                 const Levels& lv, int (&row)[4], float (&cw)[4],
                                                 float& a, float& dx, float& dy, float& fw,
                                                 float& fh) {
  const int l = pt / npl;
  int hl = 0, wl = 0, start = 0;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    if (i == l) {
      hl = lv.h[i];
      wl = lv.w[i];
      start = lv.start[i];
    }
  }
  fw = static_cast<float>(wl);
  fh = static_cast<float>(hl);
  const float x = __fsub_rn(__fmul_rn(__ldg(locs + 2 * pt), fw), 0.5f);
  const float y = __fsub_rn(__fmul_rn(__ldg(locs + 2 * pt + 1), fh), 0.5f);
  a = __ldg(attn + pt);
  const float x0 = floorf(x), y0 = floorf(y);
  dx = __fsub_rn(x, x0);
  dy = __fsub_rn(y, y0);
  const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
  const float ox = __fsub_rn(1.f, dx), oy = __fsub_rn(1.f, dy);
  const float cx[4] = {x0, x1, x0, x1};
  const float cy[4] = {y0, y0, y1, y1};
  cw[0] = __fmul_rn(ox, oy);
  cw[1] = __fmul_rn(dx, oy);
  cw[2] = __fmul_rn(ox, dy);
  cw[3] = __fmul_rn(dx, dy);
  const float xmax = static_cast<float>(wl - 1), ymax = static_cast<float>(hl - 1);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const bool in = cx[c] >= 0.f && cx[c] <= xmax && cy[c] >= 0.f && cy[c] <= ymax;
    row[c] = in ? start + static_cast<int>(cy[c]) * wl + static_cast<int>(cx[c]) : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
msda_sample_fused_backward_kernel(const float* __restrict__ value, const float* __restrict__ locs,
                                  const float* __restrict__ attn,
                                  const float* __restrict__ grad_out, float* grad_value,
                                  float* __restrict__ grad_locs, float* __restrict__ grad_attn,
                                  int64_t units, int q, int nh, int hd, int v, int npts, int npl,
                                  Levels lv) {
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (unit >= units) return;  // the whole warp leaves together: unit is the warp's
  const int lane = threadIdx.x & 31;
  const int64_t b = unit / (static_cast<int64_t>(q) * nh);
  const int h = static_cast<int>(unit % nh);
  const int64_t row_stride = static_cast<int64_t>(nh) * hd;
  const int64_t table_off = b * v * row_stride + static_cast<int64_t>(h) * hd;
  const float* table = value + table_off;
  float* gtable = grad_value + table_off;
  const float* lp = locs + unit * npts * 2;
  const float* ap = attn + unit * npts;
  const float* go = grad_out + unit * hd;
  float* glp = grad_locs + unit * npts * 2;
  float* gap = grad_attn + unit * npts;

  for (int p0 = 0; p0 < npts; p0 += 32) {
    const int pt = p0 + lane;
    int row[4] = {-1, -1, -1, -1};
    float cw[4] = {0.f, 0.f, 0.f, 0.f};
    float a = 0.f, dx = 0.f, dy = 0.f, fw = 0.f, fh = 0.f;
    if (pt < npts) corners_for_grad(lp, ap, pt, npl, lv, row, cw, a, dx, dy, fw, fh);
    float wt[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) wt[k] = __fmul_rn(cw[k], a);
    float own[4] = {0.f, 0.f, 0.f, 0.f};  // dot_k of this lane's own point
    const int n = min(32, npts - p0);
    for (int s = 0; s < n; ++s) {
      int r[4];
      float w[4], part[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        r[k] = __shfl_sync(0xffffffffu, row[k], s);
        w[k] = __shfl_sync(0xffffffffu, wt[k], s);
        part[k] = 0.f;
      }
      for (int c0 = 0; c0 < hd; c0 += 32) {
        const int c = c0 + lane;
        if (c < hd) {
          const float g = __ldg(go + c);
          float val[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) val[k] = r[k] >= 0 ? __ldg(table + r[k] * row_stride + c) : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (r[k] >= 0) {
              part[k] = __fmaf_rn(val[k], g, part[k]);
              atomicAdd(gtable + r[k] * row_stride + c, __fmul_rn(w[k], g));
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
        if (lane == s) own[k] = part[k];
      }
    }
    if (pt < npts) {
      float d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = row[k] >= 0 ? own[k] : 0.f;
      const float ox = __fsub_rn(1.f, dx), oy = __fsub_rn(1.f, dy);
      const float gx = __fadd_rn(__fmul_rn(oy, __fsub_rn(d[1], d[0])), __fmul_rn(dy, __fsub_rn(d[3], d[2])));
      const float gy = __fadd_rn(__fmul_rn(ox, __fsub_rn(d[2], d[0])), __fmul_rn(dx, __fsub_rn(d[3], d[1])));
      glp[2 * pt] = __fmul_rn(__fmul_rn(gx, a), fw);
      glp[2 * pt + 1] = __fmul_rn(__fmul_rn(gy, a), fh);
      gap[pt] = __fadd_rn(__fadd_rn(__fmul_rn(cw[0], d[0]), __fmul_rn(cw[1], d[1])),
                          __fadd_rn(__fmul_rn(cw[2], d[2]), __fmul_rn(cw[3], d[3])));
    }
  }
}

// Levels of the launch from the caller's (H, W) pairs; false unless their
// areas sum to v and 1 <= nl <= kMaxLevels.
bool make_levels(const int* level_hw, int nl, int v, Levels& lv) {
  if (nl < 1 || nl > kMaxLevels) return false;
  lv = Levels{};
  int start = 0;
  for (int l = 0; l < nl; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  return start == v;
}

}  // namespace

extern "C" {

// value (b, v, nh, hd) f32, locs (b, q, nh, nl, npl, 2) f32 in [0, 1] (others
// allowed: their corners fall outside), attn (b, q, nh, nl, npl) f32, out
// (b, q, nh, hd) f32, all contiguous on the current device; level_hw holds nl
// (H, W) pairs whose areas sum to v, nl <= 8. out is written in full. Returns
// the cudaError_t of the launch; never falls back.
int upt_msda_sample_fused(const void* value, const void* locs, const void* attn, void* out,
                          int b, int q, int nh, int hd, int v, int nl, int npl,
                          const int* level_hw, void* stream) {
  Levels lv;
  if (npl < 1 || !make_levels(level_hw, nl, v, lv)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t units = static_cast<int64_t>(b) * q * nh;
  if (units == 0 || hd == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (units + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  msda_sample_fused_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(locs),
      static_cast<const float*>(attn), static_cast<float*>(out), units, q, nh, hd, v, nl * npl,
      npl, lv);
  return static_cast<int>(cudaGetLastError());
}

// The gradients of upt_msda_sample_fused's out for grad_out (b, q, nh, hd)
// f32: grad_value (b, v, nh, hd), which the caller zero-fills and the kernel
// adds into; grad_locs (b, q, nh, nl, npl, 2) and grad_attn (b, q, nh, nl,
// npl), which the kernel writes in full. The other arguments as for
// upt_msda_sample_fused. Returns the cudaError_t of the launch.
int upt_msda_sample_fused_backward(const void* value, const void* locs, const void* attn,
                                   const void* grad_out, void* grad_value, void* grad_locs,
                                   void* grad_attn, int b, int q, int nh, int hd, int v, int nl,
                                   int npl, const int* level_hw, void* stream) {
  Levels lv;
  if (npl < 1 || !make_levels(level_hw, nl, v, lv)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t units = static_cast<int64_t>(b) * q * nh;
  if (units == 0 || hd == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (units + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  msda_sample_fused_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(locs),
      static_cast<const float*>(attn), static_cast<const float*>(grad_out),
      static_cast<float*>(grad_value), static_cast<float*>(grad_locs),
      static_cast<float*>(grad_attn), units, q, nh, hd, v, nl * npl, npl, lv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
