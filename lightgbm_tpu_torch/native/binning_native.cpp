// Native hot loops of the host-side binning and text-loading pipeline
// (a copy of lightgbm_tpu/native/binning_native.cpp, cut to the entry
// points the port calls: distinct_with_zero, greedy_find_bin,
// binarize_numerical, binarize_numerical_u8, csv_count_lines, csv_parse,
// csv_line_offsets).
//
// Each is an exact transcription of the numpy implementation in
// io/binning.py, which transcribes the reference (GreedyFindBin
// bin.cpp:78-155, BinMapper::FindBin bin.cpp:353-389,
// BinMapper::ValueToBin bin.h:472), so both paths give the same bounds
// and the same bin bytes.
//
// Build: g++ -O3 -fopenmp -shared -fPIC (see native/__init__.py); loaded
// through ctypes, with the numpy implementation as the fallback.
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

static inline double upper_bound_d(double v) {
    return std::nextafter(v, std::numeric_limits<double>::infinity());
}

static inline bool close_ordered(double a, double b) {
    return b <= upper_bound_d(a);
}

// Sorted distinct values + counts with implicit zeros inserted at their
// ordered position. values: sorted, no zeros/NaNs. out buffers: >= n + 2.
// Returns the number of distinct entries.
int64_t distinct_with_zero(const double* values, int64_t n, int64_t zero_cnt,
                           double* out_vals, int64_t* out_cnts) {
    if (n == 0) {
        out_vals[0] = 0.0;
        out_cnts[0] = zero_cnt;
        return 1;
    }
    int64_t m = 0;
    out_vals[m] = values[0];
    out_cnts[m] = 1;
    for (int64_t i = 1; i < n; ++i) {
        double v = values[i];
        if (close_ordered(out_vals[m], v)) {
            out_vals[m] = v;  // keep the larger value, sum counts
            out_cnts[m] += 1;
        } else {
            if (out_vals[m] < 0.0 && v > 0.0) {
                ++m;
                out_vals[m] = 0.0;
                out_cnts[m] = zero_cnt;
            }
            ++m;
            out_vals[m] = v;
            out_cnts[m] = 1;
        }
    }
    ++m;  // m is now the entry count
    if (values[0] > 0.0 && zero_cnt > 0) {
        for (int64_t i = m; i > 0; --i) {
            out_vals[i] = out_vals[i - 1];
            out_cnts[i] = out_cnts[i - 1];
        }
        out_vals[0] = 0.0;
        out_cnts[0] = zero_cnt;
        ++m;
    }
    if (values[n - 1] < 0.0 && zero_cnt > 0) {
        out_vals[m] = 0.0;
        out_cnts[m] = zero_cnt;
        ++m;
    }
    return m;
}

// Greedy near-equal-count bin upper bounds (reference: GreedyFindBin,
// bin.cpp:78-155). out_bounds sized >= max_bin + 1. Returns the bound
// count; the last bound is +inf.
int64_t greedy_find_bin(const double* distinct, const int64_t* counts,
                        int64_t n, int64_t max_bin, int64_t total_cnt,
                        int64_t min_data_in_bin, double* out_bounds) {
    const double inf = std::numeric_limits<double>::infinity();
    int64_t nb = 0;
    if (n == 0) {
        out_bounds[nb++] = inf;
        return nb;
    }
    if (n <= max_bin) {
        int64_t cur = 0;
        for (int64_t i = 0; i + 1 < n; ++i) {
            cur += counts[i];
            if (cur >= min_data_in_bin) {
                double val =
                    upper_bound_d((distinct[i] + distinct[i + 1]) / 2.0);
                if (nb == 0 || !close_ordered(out_bounds[nb - 1], val)) {
                    out_bounds[nb++] = val;
                    cur = 0;
                }
            }
        }
        out_bounds[nb++] = inf;
        return nb;
    }

    if (min_data_in_bin > 0) {
        int64_t cap = total_cnt / min_data_in_bin;
        if (cap < max_bin) max_bin = cap;
        if (max_bin < 1) max_bin = 1;
    }
    // the is_big predicate uses the ORIGINAL mean size (total/max_bin);
    // the packing threshold updates as bins close — matching the reference
    const double mean_size_orig = static_cast<double>(total_cnt) / max_bin;
    int64_t rest_bins = max_bin;
    int64_t rest_cnt = total_cnt;
    for (int64_t i = 0; i < n; ++i) {
        if (static_cast<double>(counts[i]) >= mean_size_orig) {
            --rest_bins;
            rest_cnt -= counts[i];
        }
    }
    double mean_size =
        rest_bins > 0 ? static_cast<double>(rest_cnt) / rest_bins : inf;

    std::vector<double> uppers;
    std::vector<double> lowers;
    uppers.reserve(max_bin + 2);
    lowers.reserve(max_bin + 2);
    lowers.push_back(distinct[0]);
    int64_t cur = 0;
    for (int64_t i = 0; i + 1 < n; ++i) {
        bool big_i = static_cast<double>(counts[i]) >= mean_size_orig;
        bool big_n = static_cast<double>(counts[i + 1]) >= mean_size_orig;
        if (!big_i) rest_cnt -= counts[i];
        cur += counts[i];
        double half = mean_size * 0.5;
        if (half < 1.0) half = 1.0;
        if (big_i || static_cast<double>(cur) >= mean_size ||
            (big_n && static_cast<double>(cur) >= half)) {
            uppers.push_back(distinct[i]);
            lowers.push_back(distinct[i + 1]);
            if (static_cast<int64_t>(uppers.size()) >= max_bin - 1) break;
            cur = 0;
            if (!big_i) {
                --rest_bins;
                mean_size = rest_bins > 0
                    ? static_cast<double>(rest_cnt) / rest_bins : inf;
            }
        }
    }
    for (size_t i = 0; i < uppers.size(); ++i) {
        double val = upper_bound_d((uppers[i] + lowers[i + 1]) / 2.0);
        if (nb == 0 || !close_ordered(out_bounds[nb - 1], val)) {
            out_bounds[nb++] = val;
        }
    }
    out_bounds[nb++] = inf;
    return nb;
}

// Batch numerical value->bin: first bin i with value <= bounds[i] over the
// first n_bounds ascending bounds (the bound after them is +inf), NaN to
// the trailing NaN bin when missing_type==2 (reference: bin.h:472).
void binarize_numerical(const double* col, int64_t n, int64_t stride,
                        const double* bounds, int64_t n_bounds,
                        int32_t missing_type, int32_t num_bin, int32_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
        double v = col[r * stride];
        if (std::isnan(v)) {
            if (missing_type == 2) {
                out[r] = num_bin - 1;
                continue;
            }
            v = 0.0;
        }
        // lower_bound over bounds[0..n_bounds)
        int64_t lo = 0, len = n_bounds;
        while (len > 0) {
            int64_t half = len / 2;
            if (bounds[lo + half] < v) {
                lo += half + 1;
                len -= half + 1;
            } else {
                len = half;
            }
        }
        out[r] = static_cast<int32_t>(lo);
    }
}

// uint8 variant writing straight into a strided [N, F] bin matrix column —
// skips the int32 intermediate + cast + strided numpy assignment, and
// replaces the per-value binary search with a direct-mapped grid: a
// 2048-cell uniform grid over [bounds[0], bounds[last]] stores the first
// candidate bin per cell (8KB, L1-resident), so the common case is one
// multiply + a 0-2 step walk instead of ~8 dependent-branch probe levels.
void binarize_numerical_u8(const double* col, int64_t n, int64_t stride,
                           const double* bounds, int64_t n_bounds,
                           int32_t missing_type, int32_t num_bin,
                           uint8_t* out, int64_t out_stride) {
    constexpr int kCells = 2048;
    uint16_t start[kCells];
    double lo_b = n_bounds > 0 ? bounds[0] : 0.0;
    double hi_b = n_bounds > 0 ? bounds[n_bounds - 1] : 0.0;
    bool use_grid = n_bounds >= 8 && hi_b > lo_b && std::isfinite(lo_b) &&
                    std::isfinite(hi_b);
    double inv = 0.0;
    if (use_grid) {
        inv = kCells / (hi_b - lo_b);
        // bounds spanning beyond double range make hi_b - lo_b overflow
        // to inf -> inv 0 -> NaN cell positions; fall back to search
        if (!(std::isfinite(inv) && inv > 0.0)) use_grid = false;
    }
    if (use_grid) {
        int64_t b = 0;
        for (int c = 0; c < kCells; ++c) {
            double cell_lo = lo_b + c / inv;
            while (b < n_bounds && bounds[b] < cell_lo) ++b;
            start[c] = static_cast<uint16_t>(b);
        }
    }
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
        double v = col[r * stride];
        if (std::isnan(v)) {
            if (missing_type == 2) {
                out[r * out_stride] = static_cast<uint8_t>(num_bin - 1);
                continue;
            }
            v = 0.0;
        }
        int64_t b;
        if (use_grid) {
            double pos = (v - lo_b) * inv;
            int c = pos <= 0.0 ? 0
                  : pos >= kCells ? kCells - 1 : static_cast<int>(pos);
            b = start[c];
            while (b < n_bounds && bounds[b] < v) ++b;
            // FP rounding can differ between the cell index (from
            // (v-lo)*inv) and the cell base (from lo + c/inv), so start[c]
            // may overshoot by one near cell edges — walk back to the true
            // lower bound
            while (b > 0 && bounds[b - 1] >= v) --b;
        } else {
            int64_t l = 0, len = n_bounds;
            while (len > 0) {
                int64_t half = len / 2;
                if (bounds[l + half] < v) {
                    l += half + 1;
                    len -= half + 1;
                } else {
                    len = half;
                }
            }
            b = l;
        }
        out[r * out_stride] = static_cast<uint8_t>(b);
    }
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------
// Chunked text parsing — the reference reads big files through a buffered
// sampling reader and a double-buffered pipeline
// (include/LightGBM/utils/text_reader.h:1-341, utils/pipeline_reader.h);
// its field parser is Common::Atof (utils/common.h).  The loader
// (io/text_loader.py) passes newline-aligned windows of an mmap, and each
// is parsed here: one serial newline scan, then OpenMP-parallel strtod
// over lines.

// Exact powers of ten representable in double (Clinger fast-path bound).
static const double kPow10[] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10,
    1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

// Fast decimal field parse (Clinger's fast path: mantissa <= 2^53 and
// |exp10| <= 22 makes one multiply/divide CORRECTLY ROUNDED, so the result
// is bit-identical to strtod).  Anything outside that — long mantissas,
// huge exponents, inf, hex floats — falls back to strtod.  ~5x strtod on
// typical ML data (short decimal fields).
static inline double parse_field(const char* p, const char* end) {
    const char* q = p;
    while (q < end && (*q == ' ' || *q == '\t')) ++q;
    bool neg = false;
    if (q < end && (*q == '+' || *q == '-')) { neg = (*q == '-'); ++q; }
    uint64_t mant = 0;
    int digits = 0, frac = 0, exp10 = 0;
    bool any = false, truncated = false;
    while (q < end && *q >= '0' && *q <= '9') {
        any = true;
        if (digits < 19) { mant = mant * 10 + (*q - '0'); ++digits; }
        else { ++exp10; truncated = true; }
        ++q;
    }
    if (q < end && *q == '.') {
        ++q;
        while (q < end && *q >= '0' && *q <= '9') {
            any = true;
            if (digits < 19) { mant = mant * 10 + (*q - '0'); ++digits; ++frac; }
            else truncated = true;
            ++q;
        }
    }
    exp10 -= frac;
    if (q < end && (*q == 'e' || *q == 'E')) {
        ++q;
        bool eneg = false;
        if (q < end && (*q == '+' || *q == '-')) { eneg = (*q == '-'); ++q; }
        int ev = 0;
        bool edig = false;
        while (q < end && *q >= '0' && *q <= '9') {
            edig = true;
            if (ev < 100000) ev = ev * 10 + (*q - '0');
            ++q;
        }
        if (!edig) goto fallback;
        exp10 += eneg ? -ev : ev;
    }
    while (q < end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (!any || q != end || truncated) goto fallback;
    if (mant > (1ULL << 53) || exp10 > 22 || exp10 < -22) goto fallback;
    {
        double v = static_cast<double>(mant);
        v = exp10 >= 0 ? v * kPow10[exp10] : v / kPow10[-exp10];
        return neg ? -v : v;
    }
fallback: {
        // Bounded copy: the input may be an mmap with no terminator after
        // the last byte (strtod on it would run off the mapping), and
        // strtod must not accept garbage-prefixed fields ("3.14.15") that
        // the fast path rejected — unparseable fields become NaN.
        char tmp[512];
        size_t len = static_cast<size_t>(end - p);
        if (len >= sizeof(tmp)) return std::numeric_limits<double>::quiet_NaN();
        memcpy(tmp, p, len);
        tmp[len] = '\0';
        char* ep = nullptr;
        double v = strtod(tmp, &ep);
        if (ep == tmp) return std::numeric_limits<double>::quiet_NaN();
        while (*ep == ' ' || *ep == '\t' || *ep == '\r') ++ep;
        if (*ep != '\0') return std::numeric_limits<double>::quiet_NaN();
        return v;
    }
}

static inline bool is_na_token(const char* p, const char* end) {
    // EXACT missing-value token set, case-insensitive: "", ?, na, nan,
    // null, n/a.  The old heuristic treated ANY field starting with n/N
    // as missing, so typo'd fields ("n0.5", "none3") were silently
    // blessed as NAs.  Now such fields reach parse_field instead, whose
    // NaN result aborts the strict parse — CSV rows via the malformed-
    // row return, LibSVM labels via the unconditional NaN label check —
    // so the lenient fallback surfaces the real error.
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    while (end > p &&
           (end[-1] == ' ' || end[-1] == '\t' || end[-1] == '\r')) --end;
    size_t len = static_cast<size_t>(end - p);
    if (len == 0) return true;
    if (len == 1 && *p == '?') return true;
    // signed nan ("-nan" is glibc printf's rendering of negative NaN);
    // the sign applies to nan ONLY — "-na"/"-n/a"/"+null" stay malformed
    if (len == 4 && (*p == '+' || *p == '-') && (p[1] | 0x20) == 'n' &&
        (p[2] | 0x20) == 'a' && (p[3] | 0x20) == 'n')
        return true;
    if (len > 4) return false;
    char buf[4];
    for (size_t i = 0; i < len; ++i) buf[i] = p[i] | 0x20;  // ascii lower
    if (len == 2 && buf[0] == 'n' && buf[1] == 'a') return true;
    if (len == 3 && memcmp(buf, "nan", 3) == 0) return true;
    if (len == 3 && buf[0] == 'n' && buf[1] == '/' && buf[2] == 'a')
        return true;
    if (len == 4 && memcmp(buf, "null", 4) == 0) return true;
    return false;
}

// Parse ncol delimiter-separated doubles per line.  buf[0:len] must end at
// a line boundary (the Python side carries the partial tail line over to
// the next chunk).  delim == ' ' means "any run of spaces/tabs" (the
// np.loadtxt whitespace mode); otherwise fields split on exactly delim.
// Exact NA tokens (is_na_token) and empty fields become NaN.  Rows with a
// DIFFERENT number of fields — or an unparseable non-NA field — abort the
// parse: returns -(line_index+1); otherwise the number of rows written to
// out (row-major [rows, ncol]).
int64_t csv_parse(const char* buf, int64_t len, char delim, int64_t ncol,
                  double* out, int64_t max_rows) {
    // line index (serial scan; memchr runs at ~GB/s)
    std::vector<int64_t> starts;
    starts.reserve(1 + len / 32);
    int64_t pos = 0;
    while (pos < len) {
        starts.push_back(pos);
        const char* nl = static_cast<const char*>(
            memchr(buf + pos, '\n', len - pos));
        pos = nl ? (nl - buf) + 1 : len;
    }
    int64_t rows = static_cast<int64_t>(starts.size());
    if (rows > max_rows) return -1;
    starts.push_back(len);

    // atomics, not volatile: concurrent writes from the parallel loop
    // would otherwise be a formal data race
    std::atomic<int64_t> bad{0};   // a malformed line (1-based), 0 = none
    std::atomic<int> drop_last{0};  // trailing blank line tolerated, dropped
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < rows; ++r) {
        if (bad) continue;
        const char* p = buf + starts[r];
        const char* end = buf + starts[r + 1];
        // trim trailing newline / CR
        while (end > p && (end[-1] == '\n' || end[-1] == '\r')) --end;
        double* orow = out + r * ncol;
        int64_t c = 0;
        const char* fp = p;
        while (p < end) {  // an empty line parses as 0 fields, not 1
            const char* fe;  // field end
            if (delim == ' ') {
                while (fp < end && (*fp == ' ' || *fp == '\t')) ++fp;
                fe = fp;
                while (fe < end && *fe != ' ' && *fe != '\t') ++fe;
                if (fp == end) break;  // trailing whitespace
            } else {
                fe = static_cast<const char*>(memchr(fp, delim, end - fp));
                if (!fe) fe = end;
            }
            if (c >= ncol) { bad = r + 1; break; }
            if (is_na_token(fp, fe)) {
                orow[c++] = std::numeric_limits<double>::quiet_NaN();
            } else {
                double v = parse_field(fp, fe);
                // not an NA token and not a number: a typo'd field
                // ("3.14.15", "n0.5") aborts the strict parse instead of
                // silently training on a fabricated missing value; the
                // lenient fallback surfaces the real error
                if (std::isnan(v)) { bad = r + 1; break; }
                orow[c++] = v;
            }
            if (fe >= end) break;
            fp = fe + 1;
            if (delim != ' ' && fp == end) {
                // trailing delimiter: one final empty field
                if (c >= ncol) { bad = r + 1; break; }
                orow[c++] = std::numeric_limits<double>::quiet_NaN();
                break;
            }
        }
        if (!bad && c != ncol) {
            // blank line at EOF is tolerated as "no row" only if last
            if (c == 0 && r == rows - 1) {
                drop_last = 1;
            } else {
                bad = r + 1;
            }
        }
    }
    if (bad > 0) return -bad;
    return drop_last ? rows - 1 : rows;
}

}  // extern "C"

extern "C" {

// Newline count — lets Python size the csv_parse output exactly without
// copying mmap'd bytes into a Python bytes object to .count() them.
int64_t csv_count_lines(const char* buf, int64_t len) {
    int64_t n = 0;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        if (!nl) { ++n; break; }  // unterminated final line
        ++n;
        p = nl + 1;
    }
    return n;
}

}  // extern "C"

extern "C" {

// Line start offsets (relative to buf).  Returns the line count.
int64_t csv_line_offsets(const char* buf, int64_t len, int64_t* out,
                         int64_t max_rows) {
    int64_t n = 0;
    int64_t pos = 0;
    while (pos < len && n < max_rows) {
        out[n++] = pos;
        const char* nl = static_cast<const char*>(
            memchr(buf + pos, '\n', len - pos));
        pos = nl ? (nl - buf) + 1 : len;
    }
    return n;
}

}  // extern "C"

extern "C" {

// LibSVM parser: "label [qid:Q] idx:val idx:val ..." lines -> CSR triplets
// (the reference parses this via Common::Split + Atof in
// dataset_loader.cpp's sparse path; MSLR-WEB30K ships this format with qid:
// tokens; copied from lightgbm_tpu/native/binning_native.cpp).  buf must end
// at a line boundary.  Serial by design — CSR output needs sequential nnz
// offsets; the field parse reuses the Clinger fast path.  Returns rows
// parsed, or -(line+1) on a malformed line.  qids[r] = -1 when the line has
// no qid token.  *out_nnz gets the pair count, *max_feat the largest feature
// index seen.
int64_t libsvm_parse(const char* buf, int64_t len, double* labels,
                     int64_t* qids, int64_t* indptr, int32_t* out_idx,
                     double* out_val, int64_t max_rows, int64_t max_nnz,
                     int64_t* out_nnz, int64_t* max_feat) {
    int64_t row = 0, nnz = 0, mf = -1;
    const char* p = buf;
    const char* bend = buf + len;
    indptr[0] = 0;
    while (p < bend) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', bend - p));
        const char* end = nl ? nl : bend;
        while (end > p && (end[-1] == '\r' || end[-1] == ' ')) --end;
        while (p < end && (*p == ' ' || *p == '\t')) ++p;
        if (p >= end) {  // blank line: tolerated at EOF only
            p = nl ? nl + 1 : bend;
            if (p < bend) return -(row + 1);
            break;
        }
        if (row >= max_rows) return -(row + 1);
        // label = first whitespace-delimited token
        const char* fe = p;
        while (fe < end && *fe != ' ' && *fe != '\t') ++fe;
        labels[row] = parse_field(p, fe);
        // a NaN label — garbage OR a literal na/nan token — would
        // silently train on NaN targets; reject the chunk
        // unconditionally so the lenient Python fallback surfaces the
        // real error (feature VALUES stay NaN-tolerant — "na" there is
        // a missing value)
        if (std::isnan(labels[row]))
            return -(row + 1);
        qids[row] = -1;
        p = fe;
        while (p < end) {
            while (p < end && (*p == ' ' || *p == '\t')) ++p;
            if (p >= end) break;
            const char* tokend = p;
            while (tokend < end && *tokend != ' ' && *tokend != '\t')
                ++tokend;
            const char* colon = static_cast<const char*>(
                memchr(p, ':', tokend - p));
            if (!colon) return -(row + 1);
            if (colon - p == 3 && p[0] == 'q' && p[1] == 'i' && p[2] == 'd') {
                char* ep = nullptr;
                char tmp[32];
                size_t ql = static_cast<size_t>(tokend - colon - 1);
                if (ql == 0 || ql >= sizeof(tmp)) return -(row + 1);
                memcpy(tmp, colon + 1, ql);
                tmp[ql] = '\0';
                qids[row] = strtoll(tmp, &ep, 10);
                if (ep == tmp || *ep != '\0') return -(row + 1);
            } else {
                if (nnz >= max_nnz) return -(row + 1);
                char* ep = nullptr;
                char tmp[24];
                size_t il = static_cast<size_t>(colon - p);
                if (il == 0 || il >= sizeof(tmp)) return -(row + 1);
                memcpy(tmp, p, il);
                tmp[il] = '\0';
                int64_t idx = strtoll(tmp, &ep, 10);
                if (ep == tmp || *ep != '\0' || idx < 0 || idx > INT32_MAX)
                    return -(row + 1);
                out_idx[nnz] = static_cast<int32_t>(idx);
                out_val[nnz] = parse_field(colon + 1, tokend);
                if (idx > mf) mf = idx;
                ++nnz;
            }
            p = tokend;
        }
        ++row;
        indptr[row] = nnz;
        p = nl ? nl + 1 : bend;
    }
    *out_nnz = nnz;
    *max_feat = mf;
    return row;
}

}  // extern "C"
