// Split scan for Hopper (sm_90a): one wave's best numerical split of each
// candidate leaf, in one launch.
//
// Replaces no Pallas kernel: the JAX package's scan is XLA
// (lightgbm_tpu/core/splitter.py best_split).  It was added because the
// eager form of that scan (lightgbm_tpu_torch/core/splitter.py
// best_split, on [n, F, B] tensors) is some hundred small launches a
// wave, each a few microseconds of work behind tens of microseconds of
// host dispatch, so the card idles under it.  The work itself is small:
// the bound is the candidate histograms' bytes read once, 12 n F B bytes
// (10.8 MB at n = 126, F = 28, B = 256: 3.2 us at 3.35 TB/s), and the
// result rows written once.
//
// Design.  One block a candidate leaf (n <= 126 blocks on 132 SMs),
// kWarps warps striding over the features (a feature the mask leaves out
// is not read).  A warp reads a feature's bins 32 at a time (lane = bin,
// 12 contiguous bytes a lane, so a chunk is 384 contiguous bytes), masks
// the bins the reference skips (past num_bins, the default bin under
// MISSING_ZERO and the NaN bin under MISSING_NAN when both directions
// are scanned), dequantizes with the [s_g, s_h, 1] scales in f32 as the
// plain version does, and forms the running sums with warp-shuffle scans
// in f64 (LightGBM's FindBestThresholdSequence sums in double).  A first pass over the
// feature's bins gives its totals T (each lane's bins, then a butterfly
// over the lanes, which leaves T on every lane), the second the prefix
// P(t) at every bin up to the last threshold.  At threshold t:
//
//   dir +1 (missing values go right): left = P(t), right = leaf - left;
//   dir -1 (missing values go left):  right = T - P(t), left = leaf - right;
//
// each guarded by min_data_in_leaf / min_sum_hessian_in_leaf and scored
// with the reference's gain (L1, L2, max_delta_step, the monotone window
// and rejection), kept if above the parent's gain plus
// min_gain_to_split, shifted and scaled by the feature's penalty.
// Every lane keeps its best (value, key); key orders the candidates as
// the reference tries them: dir -1 from high t to low (key B-1-t), then
// dir +1 from low t to high (key B+t); the first strict maximum wins, so
// equal values go to the lower key.  A warp shuffle reduction gives the
// feature's best, CEGB's penalty applies, each warp
// keeps its best feature (the lower index wins a tie) and one thread
// reduces the warps and writes the leaf's row: gain, feature, threshold,
// default_left, left g / h / count, left and right outputs, then W zero
// bitset words (the numerical splits' empty category set), in f64 holding
// f32 values.  Gains and outputs are computed in f64 and rounded to f32
// once.  The kernel allocates nothing and does not synchronize.
//
// Categorical features are not scanned here: the wave grower takes the
// plain scan (lightgbm_tpu_torch/ops/split_scan.py split_scan_plain) for
// a dataset that has one.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMissingNone = 0;   // io/binning.py MISSING_*
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
constexpr double kEpsilon = 1e-15;  // core/splitter.py K_EPSILON
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* hist;        // [L + 1][F][B][3]
  const float* blk;         // [7][n]: leaf id (int32 bits), g, h, count,
                            // min_c, max_c, depth (int32 bits)
  const float* scales;      // [3] or null
  const int* num_bins;      // [F]
  const int* default_bins;  // [F]
  const int* missing_types; // [F]
  const int* monotone;      // [F]
  const float* penalties;   // [F]
  const uint8_t* feature_mask;  // [F] bool or null
  const float* coupled;     // [F] CEGB's pending coupled penalties or null
  double* out;              // [n][9 + W]
  int rows, n, F, B, W, max_depth;  // rows: L + 1, hist's leading extent
  float split_pen;
  double l1, l2, min_data, min_hess, min_gain, max_delta;
};

// torch.clamp / torch.minimum(torch.maximum(...)): NaN stays NaN
__device__ __forceinline__ double clip(double x, double lo, double hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// ThresholdL1 (feature_histogram.hpp:446-449)
__device__ __forceinline__ double threshold_l1(double s, double l1) {
  if (l1 <= 0.0) return s;
  const double a = fmax(fabs(s) - l1, 0.0);
  return s > 0.0 ? a : (s < 0.0 ? -a : 0.0);
}

// CalculateSplittedLeafOutput (feature_histogram.hpp:450-457)
__device__ __forceinline__ double leaf_output(double g, double h,
                                              const Params& p) {
  const double r = -threshold_l1(g, p.l1) / (h + p.l2);
  return p.max_delta > 0.0 ? clip(r, -p.max_delta, p.max_delta) : r;
}

// GetLeafSplitGainGivenOutput (feature_histogram.hpp:503-506)
__device__ __forceinline__ double gain_given_output(double g, double h,
                                                    double out,
                                                    const Params& p) {
  const double sg = threshold_l1(g, p.l1);
  return -(2.0 * sg * out + (h + p.l2) * out * out);
}

// GetSplitGains with the monotone rejection (feature_histogram.hpp:459-472)
__device__ __forceinline__ double split_gain(double gl, double hl, double gr,
                                             double hr, double lo, double hi,
                                             int mono, const Params& p) {
  const double ol = clip(leaf_output(gl, hl, p), lo, hi);
  const double orr = clip(leaf_output(gr, hr, p), lo, hi);
  const double gain = gain_given_output(gl, hl, ol, p)
                      + gain_given_output(gr, hr, orr, p);
  const bool violates = (mono > 0 && ol > orr) || (mono < 0 && ol < orr);
  return violates ? 0.0 : gain;
}

__device__ __forceinline__ double scan_warp(double v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// A candidate split: its value, its key in the reference's visiting
// order, and its left side's sums (the hessian with its epsilon).
struct Cand {
  double val, lg, lh, lc;
  int key;
};

__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
  return a.val > b.val || (a.val == b.val && a.key < b.key);
}

__device__ __forceinline__ Cand shfl_cand(const Cand& c, int mask) {
  Cand o;
  o.val = __shfl_xor_sync(kFull, c.val, mask);
  o.lg = __shfl_xor_sync(kFull, c.lg, mask);
  o.lh = __shfl_xor_sync(kFull, c.lh, mask);
  o.lc = __shfl_xor_sync(kFull, c.lc, mask);
  o.key = __shfl_xor_sync(kFull, c.key, mask);
  return o;
}

struct Leaf {
  double sg, sh, sc, total_h, lo, hi, shift;
};

// The masked, dequantized (g, h, count) of bin b of one feature's row.
__device__ __forceinline__ void load_bin(const float* row, int b, int B,
                                         int nb, int skip, const Params& p,
                                         double* v) {
  v[0] = v[1] = v[2] = 0.0;
  if (b >= B || b >= nb || b == skip) return;
  const float* q = row + 3 * b;
  float g = q[0], h = q[1], c = q[2];
  if (p.scales != nullptr) {
    g = g * p.scales[0];
    h = h * p.scales[1];
    c = c * p.scales[2];
  }
  v[0] = g;
  v[1] = h;
  v[2] = c;
}

__global__ void __launch_bounds__(kThreads)
split_scan_kernel(const Params p) {
  __shared__ double s_val[kWarps], s_lg[kWarps], s_lh[kWarps],
      s_lc[kWarps];
  __shared__ int s_f[kWarps], s_key[kWarps];
  const int i = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = p.n, F = p.F, B = p.B;
  // an id outside hist reads nothing: the leaf scans as empty
  const int id = __float_as_int(p.blk[i]);
  const bool in_hist = id >= 0 && id < p.rows;
  const int leaf = in_hist ? id : 0;
  Leaf lf;
  lf.sg = p.blk[n + i];
  lf.sh = p.blk[2 * n + i];
  lf.sc = p.blk[3 * n + i];
  lf.lo = p.blk[4 * n + i];
  lf.hi = p.blk[5 * n + i];
  lf.total_h = lf.sh + 2.0 * kEpsilon;
  {
    const double out = leaf_output(lf.sg, lf.total_h, p);
    lf.shift = gain_given_output(lf.sg, lf.total_h, out, p) + p.min_gain;
  }

  Cand wbest;                 // this warp's best feature so far
  wbest.val = -INFINITY;
  wbest.key = 0;
  wbest.lg = wbest.lh = wbest.lc = 0.0;
  int wf = 0x7fffffff;
  for (int f = warp; in_hist && f < F; f += kWarps) {
    if (p.feature_mask != nullptr && !p.feature_mask[f]) continue;
    const int nb = p.num_bins[f];
    const int miss = p.missing_types[f];
    const int mono = p.monotone[f];
    const double pen = p.penalties[f];
    const bool use_both = nb > 2 && miss != kMissingNone;
    int skip = -1;            // the bin left out of both running sums
    if (use_both && miss == kMissingZero) skip = p.default_bins[f];
    if (use_both && miss == kMissingNan) skip = nb - 1;
    const int t_max1 = use_both ? nb - 2 : -1;
    const int t_max2 = nb - 2 - ((use_both && miss == kMissingNan) ? 1 : 0);
    const int t_hi = t_max1 > t_max2 ? t_max1 : t_max2;
    const float* row = p.hist + ((size_t)leaf * F + f) * (size_t)B * 3;

    // pass 1: the totals, each lane's bins summed, then the lanes
    double tot[3] = {0.0, 0.0, 0.0};
    for (int base = 0; base < nb; base += 32) {
      double v[3];
      load_bin(row, base + lane, B, nb, skip, p, v);
#pragma unroll
      for (int k = 0; k < 3; ++k) tot[k] += v[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      for (int m = 16; m > 0; m >>= 1)
        tot[k] += __shfl_xor_sync(kFull, tot[k], m);

    // pass 2: both directions at every threshold
    Cand best;
    best.val = -INFINITY;
    best.key = 0x7fffffff;
    best.lg = best.lh = best.lc = 0.0;
    double carry[3] = {0.0, 0.0, 0.0};
    for (int base = 0; base <= t_hi; base += 32) {
      const int t = base + lane;
      double v[3], pre[3];
      load_bin(row, t, B, nb, skip, p, v);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const double s = scan_warp(v[k], lane);
        pre[k] = carry[k] + s;
        carry[k] += __shfl_sync(kFull, s, 31);
      }
      if (t <= t_max2) {      // dir -1
        const double rg = tot[0] - pre[0];
        const double rh = (tot[1] - pre[1]) + kEpsilon;
        const double rc = tot[2] - pre[2];
        const double lg = lf.sg - rg, lh = lf.total_h - rh, lc = lf.sc - rc;
        if (lc >= p.min_data && rc >= p.min_data && lh >= p.min_hess
            && rh >= p.min_hess) {
          const double gain = split_gain(lg, lh, rg, rh, lf.lo, lf.hi, mono, p);
          if (gain > lf.shift) {
            Cand c{(gain - lf.shift) * pen, lg, lh, lc, B - 1 - t};
            if (better(c, best)) best = c;
          }
        }
      }
      if (t <= t_max1) {      // dir +1
        const double lg = pre[0], lh = pre[1] + kEpsilon, lc = pre[2];
        const double rg = lf.sg - lg, rh = lf.total_h - lh, rc = lf.sc - lc;
        if (lc >= p.min_data && rc >= p.min_data && lh >= p.min_hess
            && rh >= p.min_hess) {
          const double gain = split_gain(lg, lh, rg, rh, lf.lo, lf.hi, mono, p);
          if (gain > lf.shift) {
            Cand c{(gain - lf.shift) * pen, lg, lh, lc, B + t};
            if (better(c, best)) best = c;
          }
        }
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      const Cand o = shfl_cand(best, m);
      if (better(o, best)) best = o;
    }
    if (p.coupled != nullptr && best.val > -INFINITY) {
      // CEGB (cost_effective_gradient_boosting.hpp:50-61), in f32 as the
      // plain version's penalty_sub
      const float sub = (float)lf.sc * p.split_pen + p.coupled[f];
      best.val -= (double)sub;
    }
    if (best.val > wbest.val) {   // features ascend: a tie keeps the lower
      wbest = best;
      wf = f;
    }
  }
  if (lane == 0) {
    s_val[warp] = wbest.val;
    s_lg[warp] = wbest.lg;
    s_lh[warp] = wbest.lh;
    s_lc[warp] = wbest.lc;
    s_key[warp] = wbest.key;
    s_f[warp] = wf;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  double val = -INFINITY, lg = 0.0, lh = 0.0, lc = 0.0;
  int f = 0x7fffffff, key = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (s_val[w] > val || (s_val[w] == val && s_f[w] < f)) {
      val = s_val[w];
      f = s_f[w];
      key = s_key[w];
      lg = s_lg[w];
      lh = s_lh[w];
      lc = s_lc[w];
    }
  }
  const bool found = val > -INFINITY;
  double left_g, left_h, left_c;
  int thr = 0;
  bool dir2;
  if (found) {
    dir2 = key < B;
    thr = dir2 ? B - 1 - key : key - B;
    left_g = lg;
    left_h = lh - kEpsilon;
    left_c = lc;
  } else {
    // the plain version's payload at feature 0's first key (dir -1 at
    // t = B - 1): the whole leaf on the left
    f = 0;
    dir2 = true;
    left_g = lf.sg;
    left_h = lf.sh;
    left_c = lf.sc;
  }
  const int miss = p.missing_types[f];
  const bool use_both = p.num_bins[f] > 2 && miss != kMissingNone;
  const bool default_left = use_both ? dir2 : miss != kMissingNan;
  const double left_out = clip(leaf_output(left_g, left_h, p), lf.lo, lf.hi);
  const double right_out =
      clip(leaf_output(lf.sg - left_g, lf.sh - left_h, p), lf.lo, lf.hi);
  double gain = found ? val : -INFINITY;
  const int depth = __float_as_int(p.blk[6 * n + i]);
  if (p.max_depth > 0 && depth >= p.max_depth) gain = -INFINITY;

  double* o = p.out + (size_t)i * (9 + p.W);
  o[0] = (double)(float)gain;
  o[1] = found ? (double)f : -1.0;
  o[2] = found ? (double)thr : 0.0;
  o[3] = default_left ? 1.0 : 0.0;
  o[4] = (double)(float)left_g;
  o[5] = (double)(float)left_h;
  o[6] = (double)(float)left_c;
  o[7] = (double)(float)left_out;
  o[8] = (double)(float)right_out;
  for (int w = 0; w < p.W; ++w) o[9 + w] = 0.0;
}

}  // namespace

extern "C" int lgbm_split_scan(
    const float* hist, const float* blk, const float* scales,
    const int* num_bins, const int* default_bins, const int* missing_types,
    const int* monotone, const float* penalties, const uint8_t* feature_mask,
    const float* coupled, int rows, int n, int F, int B, int W,
    int max_depth,
    double split_pen, double l1, double l2, double min_data,
    double min_hess, double min_gain, double max_delta, double* out,
    void* stream) {
  if (n <= 0) return 0;
  Params p;
  p.hist = hist;
  p.blk = blk;
  p.scales = scales;
  p.num_bins = num_bins;
  p.default_bins = default_bins;
  p.missing_types = missing_types;
  p.monotone = monotone;
  p.penalties = penalties;
  p.feature_mask = feature_mask;
  p.coupled = coupled;
  p.out = out;
  p.rows = rows;
  p.n = n;
  p.F = F;
  p.B = B;
  p.W = W;
  p.max_depth = max_depth;
  p.split_pen = (float)split_pen;
  p.l1 = l1;
  p.l2 = l2;
  p.min_data = min_data;
  p.min_hess = min_hess;
  p.min_gain = min_gain;
  p.max_delta = max_delta;
  split_scan_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}
