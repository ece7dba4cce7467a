// Native host engine for minnow-tpu.
//
// The reference ships a Go bit kernel (ref go/bit/bit.go) and a Cython twin
// (ref python/cy_bit.pyx); this C++ engine is their counterpart for the
// host side of the framework: fast fixed-width bit pack/unpack, the
// exact greedy periodic-window scan (normative for out-of-range inputs),
// float32 quantization, and the multithreaded text-catalog field parser
// (ref go/text/parse.go + go/thread/thread.go).
//
// Exposed as a plain C ABI consumed via ctypes (minnow_tpu/native.py).
//
// Layout contract (ref go/bit/bit.go): element i occupies bits
// [i*b, (i+1)*b) of the byte stream, LSB-first within each byte; values
// masked to b bits; b == 0 packs nothing / decodes zeros.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <thread>
#include <vector>
#include <algorithm>

#ifdef __AVX512DQ__
#include <immintrin.h>
#endif

extern "C" {

static inline uint64_t width_mask(int bits) {
    return bits >= 64 ? ~0ULL : ((1ULL << bits) - 1);
}

// Pack n values at the given width into out. out must be zero-initialized
// and have array_bytes(bits, n) + 16 bytes of writable slack (the fast path
// stores whole 64-bit words).
// Carry-accumulator pack: gather masked values into a 64-bit register
// and store each word ONCE when full.  The previous per-element 8-byte
// read-OR-write loop serialized on store-to-load forwarding of the
// overlapping words (~0.95 GB/s at bits<=32 on this host); one aligned
// store per 64 output bits runs ~3-4x faster (tools/ref_algo_baseline.py
// records the comparison).  Requires i0*bits % 8 == 0 (chunk starts are
// 8-element-aligned) and a zeroed output with >= 8 bytes of slack.
static void pack_range(const uint64_t* x, int64_t i0, int64_t i1, int bits,
                       uint8_t* out) {
    const uint64_t mask = width_mask(bits);
    uint8_t* p = out + ((i0 * (int64_t)bits) >> 3);
    uint64_t acc = 0;
    int fill = 0;
    for (int64_t i = i0; i < i1; i++) {
        uint64_t v = x[i] & mask;
        acc |= v << fill;
        fill += bits;
        if (fill >= 64) {
            std::memcpy(p, &acc, 8);
            p += 8;
            fill -= 64;
            int done = bits - fill;           // bits already stored
            acc = (fill && done < 64) ? (v >> done) : 0;
        }
    }
    // tail flush: fill is a multiple of 8 at internal chunk boundaries
    // (chunks are 8-element multiples); only the array's ragged final
    // bits can end mid-byte, where the zeroed buffer makes OR exact
    for (int k = 0; fill > 0; k++, fill -= 8)
        p[k] |= (uint8_t)(acc >> (8 * k));
}

void mnw_pack(const uint64_t* x, int64_t n, int bits, uint8_t* out,
              int threads) {
    if (bits <= 0 || n <= 0) return;
    if (threads <= 1 || n < (1 << 16)) {
        pack_range(x, 0, n, bits, out);
        return;
    }
    // Chunks start at multiples of 8 elements: bit offsets there are
    // byte-aligned, so chunks touch disjoint byte ranges.
    int64_t chunk = ((n / threads) / 8 + 1) * 8;
    std::vector<std::thread> ts;
    for (int64_t start = 0; start < n; start += chunk) {
        int64_t end = std::min(n, start + chunk);
        ts.emplace_back(pack_range, x, start, end, bits, out);
    }
    for (auto& t : ts) t.join();
}

// Streaming-window unpack: keep the not-yet-consumed packed bits in a
// 64-bit register and load each input word ONCE (the per-element
// unaligned 8-byte load repeated ~64/bits times per word was the old
// cost).  Requires i0*bits % 8 == 0 (chunk starts are 8-element
// aligned) and the documented 16 bytes of readable slack.
static void unpack_range(const uint8_t* in, int64_t i0, int64_t i1, int bits,
                         uint64_t* out) {
    const uint64_t mask = width_mask(bits);
    const uint8_t* p = in + ((i0 * (int64_t)bits) >> 3);
    uint64_t cur;
    std::memcpy(&cur, p, 8);
    p += 8;
    int avail = 64;
    for (int64_t i = i0; i < i1; i++) {
        if (avail >= bits) {
            out[i] = cur & mask;
            cur = (bits < 64) ? (cur >> bits) : 0;
            avail -= bits;
        } else {
            uint64_t nxt;
            std::memcpy(&nxt, p, 8);
            p += 8;
            out[i] = (cur | (avail ? (nxt << avail) : nxt)) & mask;
            int need = bits - avail;          // in [1, 64]
            cur = (need < 64) ? (nxt >> need) : 0;
            avail = 64 - need;
        }
    }
}

// in must have array_bytes(bits, n) + 16 bytes of readable slack.
void mnw_unpack(const uint8_t* in, int64_t n, int bits, uint64_t* out,
                int threads) {
    if (n <= 0) return;
    if (bits == 0) {
        std::memset(out, 0, (size_t)n * 8);
        return;
    }
    if (threads <= 1 || n < (1 << 16)) {
        unpack_range(in, 0, n, bits, out);
        return;
    }
    int64_t chunk = ((n / threads) / 8 + 1) * 8;
    std::vector<std::thread> ts;
    for (int64_t start = 0; start < n; start += chunk) {
        int64_t end = std::min(n, start + chunk);
        ts.emplace_back(unpack_range, in, start, end, bits, out);
    }
    for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// Periodic window scan (ref go/group.go:374-420) -- exact transcription of
// the greedy algorithm, normative for all inputs including out-of-range.
// ---------------------------------------------------------------------------

static inline int64_t periodic_distance(int64_t x, int64_t x0,
                                        int64_t pixels) {
    int64_t d = x - x0;
    if (d >= 0) {
        if (d > pixels - d) return d - pixels;
    } else {
        if (d < -(d + pixels)) return pixels + d;
    }
    return d;
}

int64_t mnw_periodic_min(const int64_t* x, int64_t n, int64_t pixels) {
    if (n <= 0) return 0;
    int64_t x0 = x[0], width = 1;
    const int64_t half = pixels / 2;
    for (int64_t i = 0; i < n; i++) {
        int64_t xi = x[i];
        int64_t x1 = x0 + width - 1;
        if (x1 >= pixels) x1 -= pixels;
        int64_t d0 = periodic_distance(xi, x0, pixels);
        int64_t d1 = periodic_distance(xi, x1, pixels);
        if (d0 > 0 && d1 < 0) continue;
        if (d1 > -d0) {
            width += d1;
        } else {
            x0 += d0;
            if (x0 < 0) x0 += pixels;
            width -= d0;
        }
        if (width > half) return 0;
    }
    return x0;
}

void mnw_bound(int64_t* x, int64_t n, int64_t mn, int64_t pixels) {
    for (int64_t i = 0; i < n; i++) {
        if (x[i] < mn) x[i] += pixels;
        else if (x[i] >= mn + pixels) x[i] -= pixels;
    }
}

// ---------------------------------------------------------------------------
// Quantize (ref go/group.go:312-320): q = floor(f32(x - low) / dx), exact
// IEEE float32 on the host CPU.
// ---------------------------------------------------------------------------

void mnw_quantize(const float* x, int64_t n, float low, float dx,
                  int64_t* q) {
    int64_t i = 0;
#ifdef __AVX512DQ__
    // 16 lanes/iter, same semantics as the scalar tail bit-for-bit:
    // f32 subtract, f32 divide (vdivps is IEEE-exact), floor
    // (f32 round-to-neg-inf == floor in f64: every f32 is exactly a
    // f64), truncating convert to int64 (out-of-range -> the same
    // 0x8000... sentinel as cvttsd2si).  gcc will not auto-vectorize
    // the f32->int64 convert, so the scalar loop ran ~2.6x slower.
    __m512 vlow = _mm512_set1_ps(low), vdx = _mm512_set1_ps(dx);
    for (; i + 16 <= n; i += 16) {
        __m512 z = _mm512_div_ps(
            _mm512_sub_ps(_mm512_loadu_ps(x + i), vlow), vdx);
        z = _mm512_roundscale_ps(
            z, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
        __m256 lo = _mm512_castps512_ps256(z);
        __m256 hi = _mm512_extractf32x8_ps(z, 1);
        _mm512_storeu_si512(q + i, _mm512_cvttps_epi64(lo));
        _mm512_storeu_si512(q + i + 8, _mm512_cvttps_epi64(hi));
    }
#endif
    for (; i < n; i++) {
        float z = (x[i] - low) / dx;
        q[i] = (int64_t)std::floor((double)z);
    }
}

// min-subtraction stats (ref go/group.go:242-255): deltas, min, max delta.
void mnw_delta_stats(const int64_t* x, int64_t n, uint64_t* deltas,
                     int64_t* mn_out, uint64_t* maxd_out) {
    if (n <= 0) { *mn_out = 0; *maxd_out = 0; return; }
    int64_t mn = x[0];
    for (int64_t i = 1; i < n; i++) if (x[i] < mn) mn = x[i];
    uint64_t maxd = 0;
    for (int64_t i = 0; i < n; i++) {
        uint64_t d = (uint64_t)(x[i] - mn);
        deltas[i] = d;
        if (d > maxd) maxd = d;
    }
    *mn_out = mn;
    *maxd_out = maxd;
}

// ---------------------------------------------------------------------------
// Text catalog field parser (ref go/text/parse.go:80-211).
//
// Input: a byte buffer of whitespace-separated columns, one item per line
// ('\n'); comment lines removed by the caller.  line_starts/line_ends give
// the [start, end) byte range of each of n_lines lines.  For each requested
// column index, parses that field of every line into float64 (the caller
// narrows to f32/i64).  Parallel over line ranges with std::thread -- the
// native equivalent of the reference's goroutine WorkerQueue
// (ref go/thread/thread.go:150-169).
// Returns 0 on success, 1 + (line index) on parse failure.
// ---------------------------------------------------------------------------

// Clinger fast path for decimal -> double: when the significand fits
// 53 bits and the decimal exponent is within +-22, value = w * 10^q is
// ONE exactly-representable IEEE multiply/divide away, so a single
// hardware op is correctly rounded -- bit-identical to strtod by
// construction (W. Clinger, "How to read floating point numbers
// accurately", PLDI '90; the same fast path glibc itself short-cuts).
// Catalog fields (%.5f positions, %.6e masses, integer IDs) all land
// here; anything else (>= 19 digits, big exponents, inf/nan, hex)
// falls back to strtod.  Returns false when the slow path must run.
static const double kPow10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10,
    1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21,
    1e22};

static inline bool fast_field_to_double(const char* s, int64_t len,
                                        double* out) {
    const char* p = s;
    const char* end = s + len;
    if (p >= end) return false;
    bool neg = false;
    if (*p == '-' || *p == '+') {
        neg = (*p == '-');
        p++;
    }
    // single-compare digit loops (d > 9 rejects in one branch); the
    // <= 19-total-span check AFTER the loops replaces the per-char
    // significant-digit counter: 19 decimal digits never wrap u64
    // (10^19 - 1 < 2^64), and a conservatively-bailed field (leading
    // zeros pushing the span past 19) just takes the exact strtod
    // path.  ~1.5x the old 4-branch/char loop on catalog fields.
    uint64_t w = 0;
    const char* ds = p;
    while (p < end) {
        unsigned d = (unsigned char)(*p) - '0';
        if (d > 9) break;
        w = w * 10 + d;
        p++;
    }
    int64_t ndig = p - ds;
    int64_t frac = 0;
    if (p < end && *p == '.') {
        p++;
        const char* fs = p;
        while (p < end) {
            unsigned d = (unsigned char)(*p) - '0';
            if (d > 9) break;
            w = w * 10 + d;
            p++;
        }
        frac = p - fs;
        ndig += frac;
    }
    if (ndig == 0 || ndig > 19) return false;  // "", "inf", huge: slow
    int64_t q = -frac;
    if (p < end && (*p == 'e' || *p == 'E')) {
        p++;
        bool eneg = false;
        if (p < end && (*p == '-' || *p == '+')) {
            eneg = (*p == '-');
            p++;
        }
        if (p >= end || *p < '0' || *p > '9') return false;
        int64_t ex = 0;
        while (p < end && *p >= '0' && *p <= '9') {
            if (ex < 10000) ex = ex * 10 + (*p - '0');
            p++;
        }
        q += eneg ? -ex : ex;
    }
    if (p != end) return false;  // trailing junk: let strtod decide
    if (w == 0) {
        *out = neg ? -0.0 : 0.0;
        return true;
    }
    if (w >= (1ULL << 53) || q < -22 || q > 22) return false;
    double v = (double)w;  // exact: w < 2^53
    v = q < 0 ? v / kPow10[-q] : v * kPow10[q];  // one rounding
    *out = neg ? -v : v;
    return true;
}

// Exact base-10 int64 parse (reference strconv.Atoi semantics, ref
// go/text/parse.go:118-121): optional sign, >= 1 digits, nothing else.
// Exact at every magnitude inside int64 (IDs above 2^53 keep their low
// bits); float syntax ("1.5", "1e5"), junk, and overflow all fail --
// never a silent truncation or wrap.
static inline bool field_to_int64(const char* s, int64_t len,
                                  int64_t* out) {
    const char* p = s;
    const char* end = s + len;
    if (p >= end) return false;
    bool neg = false;
    if (*p == '-' || *p == '+') {
        neg = (*p == '-');
        p++;
    }
    if (p >= end) return false;
    uint64_t v = 0;
    const uint64_t lim = neg ? (1ULL << 63) : (1ULL << 63) - 1;
    while (p < end) {
        char c = *p;
        if (c < '0' || c > '9') return false;
        uint64_t d = (uint64_t)(c - '0');
        if (v > (lim - d) / 10) return false;  // would exceed int64
        v = v * 10 + d;
        p++;
    }
    *out = (int64_t)(neg ? (0 - v) : v);  // two's-complement negate
    return true;
}

// Fused scan+parse walk: one pass over the line, parsing wanted fields
// in place and skipping the rest -- no field-pointer staging arrays.
// ~1.7x the staged loop on catalog lines (the parse is the flagship
// pipeline's biggest CPU consumer).  Requires distinct col_idx values
// (mnw_parse_columns_typed falls back to the staged loop otherwise).
// slot[fi] is the output column for field index fi, or -1.
static int64_t parse_lines_fused(
    const char* buf, const int64_t* line_starts, const int64_t* line_ends,
    int64_t l0, int64_t l1, const int32_t* slot,
    const int64_t* col_kind, int64_t max_col, double** out, char sep) {
    for (int64_t li = l0; li < l1; li++) {
        const char* p = buf + line_starts[li];
        const char* end = buf + line_ends[li];
        for (int64_t fi = 0; fi <= max_col; fi++) {
            while (p < end && (*p == sep || *p == '\t' || *p == '\r'))
                p++;
            if (p >= end) return 1 + li;  // missing requested column
            const char* fs = p;
            while (p < end && *p != sep && *p != '\t' && *p != '\r')
                p++;
            int32_t c = slot[fi];
            if (c < 0) continue;
            if (col_kind != nullptr && col_kind[c] == 1) {
                int64_t iv;
                if (!field_to_int64(fs, p - fs, &iv)) return 1 + li;
                ((int64_t*)out[c])[li] = iv;
                continue;
            }
            double v;
            if (!fast_field_to_double(fs, p - fs, &v)) {
                char tmp[64];
                int64_t m = std::min<int64_t>(p - fs, 63);
                std::memcpy(tmp, fs, m);
                tmp[m] = 0;
                char* endp = nullptr;
                v = std::strtod(tmp, &endp);
                if (endp == tmp) return 1 + li;
            }
            if (col_kind != nullptr && col_kind[c] == 2) {
                // float32 column: narrow here (one rounding, identical
                // to numpy's float64 -> float32 astype), skipping the
                // caller's whole-array conversion pass
                ((float*)out[c])[li] = (float)v;
            } else {
                out[c][li] = v;
            }
        }
    }
    return 0;
}

static int64_t parse_lines_range(
    const char* buf, const int64_t* line_starts, const int64_t* line_ends,
    int64_t l0, int64_t l1, const int64_t* col_idx,
    const int64_t* col_kind, int64_t n_cols,
    int64_t max_col, double** out, int64_t n_lines, char sep) {
    std::vector<const char*> fields(max_col + 1);
    std::vector<int64_t> flen(max_col + 1);
    for (int64_t li = l0; li < l1; li++) {
        const char* p = buf + line_starts[li];
        const char* end = buf + line_ends[li];
        int64_t nf = 0;
        while (p < end && nf <= max_col) {
            while (p < end && (*p == sep || *p == '\t' || *p == '\r')) p++;
            if (p >= end) break;
            const char* fs = p;
            while (p < end && *p != sep && *p != '\t' && *p != '\r') p++;
            fields[nf] = fs;
            flen[nf] = p - fs;
            nf++;
        }
        for (int64_t c = 0; c < n_cols; c++) {
            int64_t ci = col_idx[c];
            if (ci >= nf) return 1 + li;
            if (col_kind != nullptr && col_kind[c] == 1) {
                // int64 column: exact integer parse, no float detour
                int64_t iv;
                if (!field_to_int64(fields[ci], flen[ci], &iv))
                    return 1 + li;
                ((int64_t*)out[c])[li] = iv;
                continue;
            }
            double v;
            if (!fast_field_to_double(fields[ci], flen[ci], &v)) {
                // slow path: NUL-terminate a copy for strtod
                char tmp[64];
                int64_t m = std::min<int64_t>(flen[ci], 63);
                std::memcpy(tmp, fields[ci], m);
                tmp[m] = 0;
                char* endp = nullptr;
                v = std::strtod(tmp, &endp);
                if (endp == tmp) return 1 + li;
            }
            if (col_kind != nullptr && col_kind[c] == 2) {
                ((float*)out[c])[li] = (float)v;
            } else {
                out[c][li] = v;
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Go math.Log10 (FDLIBM e_log.c scheme), f32 in / f32 out, for minh
// log-column preprocessing: float32(math.Log10(float64(x)))
// (ref go/minh/minh.go:141-149).  Same algorithm as the vectorized
// replication in minnow_tpu/core/gomath.py; every op is IEEE f64, so the
// results are bit-identical.  Special cases follow Go.
// ---------------------------------------------------------------------------

static const double kLn2Hi = 6.93147180369123816490e-01;
static const double kLn2Lo = 1.90821492927058770002e-10;
static const double kL1 = 6.666666666666735130e-01;
static const double kL2 = 3.999999999940941908e-01;
static const double kL3 = 2.857142874366239149e-01;
static const double kL4 = 2.222219843214978396e-01;
static const double kL5 = 1.818357216161805012e-01;
static const double kL6 = 1.531383769920937332e-01;
static const double kL7 = 1.479819860511658591e-01;
static const double kSqrt2 = 1.4142135623730951;
static const double kLn2 = 0.6931471805599453;
static const double kLn10 = 2.302585092994046;
static const double kLog2E = 1.4426950408889634;

static inline double fdlibm_log(double x) {
    int ki;
    double f1 = std::frexp(x, &ki);
    if (f1 < kSqrt2 / 2) {
        f1 *= 2;
        ki--;
    }
    double k = (double)ki;
    double f = f1 - 1.0;
    double s = f / (2.0 + f);
    double s2 = s * s;
    double s4 = s2 * s2;
    double t1 = s2 * (kL1 + s4 * (kL3 + s4 * (kL5 + s4 * kL7)));
    double t2 = s4 * (kL2 + s4 * (kL4 + s4 * kL6));
    double r = t1 + t2;
    double hfsq = 0.5 * f * f;
    return k * kLn2Hi - ((hfsq - (s * (hfsq + r) + k * kLn2Lo)) - f);
}

static inline double go_log2(double x) {
    if (std::isnan(x) || x == HUGE_VAL) return x;
    if (x < 0) return NAN;
    if (x == 0) return -HUGE_VAL;
    int exp;
    double frac = std::frexp(x, &exp);
    if (frac == 0.5) return (double)exp - 1.0;  // exact powers of two
    return fdlibm_log(frac) * kLog2E + (double)exp;
}

void mnw_log10_f32(const float* x, int64_t n, float* out) {
    const double c = kLn2 / kLn10;
    int64_t i = 0;
#ifdef __AVX512DQ__
    // 8 f64 lanes/iter, BIT-IDENTICAL to the scalar tail: every
    // arithmetic op is the same IEEE f64 mul/add/sub/div in the same
    // association (explicit intrinsics -- no FMA contraction), frexp
    // is exact bit manipulation, and the special cases (NaN, +-0,
    // +Inf, x<0, exact powers of two) are blended per lane to the
    // scalar results.  The scalar loop ran ~224 MB/s and dominated
    // minh log-column encode (ref go/minh/minh.go:141-149 preprocessing).
    const __m512d vZero = _mm512_setzero_pd();
    const __m512d vOne = _mm512_set1_pd(1.0);
    const __m512d vTwo = _mm512_set1_pd(2.0);
    const __m512d vHalfd = _mm512_set1_pd(0.5);
    const __m512d vSqrt2h = _mm512_set1_pd(kSqrt2 / 2);
    const __m512d vL1 = _mm512_set1_pd(kL1), vL2 = _mm512_set1_pd(kL2);
    const __m512d vL3 = _mm512_set1_pd(kL3), vL4 = _mm512_set1_pd(kL4);
    const __m512d vL5 = _mm512_set1_pd(kL5), vL6 = _mm512_set1_pd(kL6);
    const __m512d vL7 = _mm512_set1_pd(kL7);
    const __m512d vLn2Hi = _mm512_set1_pd(kLn2Hi);
    const __m512d vLn2Lo = _mm512_set1_pd(kLn2Lo);
    const __m512d vLog2E = _mm512_set1_pd(kLog2E);
    const __m512d vC = _mm512_set1_pd(c);
    const __m512d vNan = _mm512_set1_pd(NAN);
    const __m512d vNegInf = _mm512_set1_pd(-HUGE_VAL);
    const __m512i vMant = _mm512_set1_epi64(0x000FFFFFFFFFFFFFLL);
    const __m512i vHalfBits = _mm512_set1_epi64(0x3FE0000000000000LL);
    const __m512i vExpMask = _mm512_set1_epi64(0x7FF);
    const __m512i v1022 = _mm512_set1_epi64(1022);
    for (; i + 8 <= n; i += 8) {
        __m512d v = _mm512_cvtps_pd(_mm256_loadu_ps(x + i));
        __m512i bits = _mm512_castpd_si512(v);
        // frexp: e = biased_exp - 1022, frac in [0.5, 1)
        __m512i e64 = _mm512_sub_epi64(
            _mm512_and_si512(_mm512_srli_epi64(bits, 52), vExpMask),
            v1022);
        __m512d frac = _mm512_castsi512_pd(_mm512_or_si512(
            _mm512_and_si512(bits, vMant), vHalfBits));
        // inner frexp of fdlibm_log is the identity on [0.5, 1);
        // f1 < sqrt2/2 -> f1 *= 2, k -= 1
        __mmask8 mlt = _mm512_cmp_pd_mask(frac, vSqrt2h, _CMP_LT_OQ);
        __m512d f1 = _mm512_mask_mul_pd(frac, mlt, frac, vTwo);
        __m512d k = _mm512_mask_sub_pd(vZero, mlt, vZero, vOne);
        __m512d f = _mm512_sub_pd(f1, vOne);
        __m512d s = _mm512_div_pd(f, _mm512_add_pd(vTwo, f));
        __m512d s2 = _mm512_mul_pd(s, s);
        __m512d s4 = _mm512_mul_pd(s2, s2);
        // t1 = s2*(L1 + s4*(L3 + s4*(L5 + s4*L7)))
        __m512d t1 = _mm512_mul_pd(s2, _mm512_add_pd(vL1,
            _mm512_mul_pd(s4, _mm512_add_pd(vL3,
                _mm512_mul_pd(s4, _mm512_add_pd(vL5,
                    _mm512_mul_pd(s4, vL7)))))));
        // t2 = s4*(L2 + s4*(L4 + s4*L6))
        __m512d t2 = _mm512_mul_pd(s4, _mm512_add_pd(vL2,
            _mm512_mul_pd(s4, _mm512_add_pd(vL4,
                _mm512_mul_pd(s4, vL6)))));
        __m512d r = _mm512_add_pd(t1, t2);
        __m512d hfsq = _mm512_mul_pd(_mm512_mul_pd(vHalfd, f), f);
        // k*Ln2Hi - ((hfsq - (s*(hfsq+r) + k*Ln2Lo)) - f)
        __m512d inner = _mm512_add_pd(
            _mm512_mul_pd(s, _mm512_add_pd(hfsq, r)),
            _mm512_mul_pd(k, vLn2Lo));
        __m512d lg = _mm512_sub_pd(_mm512_mul_pd(k, vLn2Hi),
            _mm512_sub_pd(_mm512_sub_pd(hfsq, inner), f));
        __m512d expd = _mm512_cvtepi64_pd(e64);
        __m512d lg2 = _mm512_add_pd(_mm512_mul_pd(lg, vLog2E), expd);
        // exact powers of two: frac == 0.5 -> exp - 1
        __mmask8 pw2 = _mm512_cmp_pd_mask(frac, vHalfd, _CMP_EQ_OQ);
        lg2 = _mm512_mask_sub_pd(lg2, pw2, expd, vOne);
        // specials, matching go_log2's order: NaN/+Inf -> x,
        // x < 0 -> NaN, x == +-0 -> -Inf
        __mmask8 mneg = _mm512_cmp_pd_mask(v, vZero, _CMP_LT_OQ);
        lg2 = _mm512_mask_mov_pd(lg2, mneg, vNan);
        __mmask8 mzero = _mm512_cmp_pd_mask(v, vZero, _CMP_EQ_OQ);
        lg2 = _mm512_mask_mov_pd(lg2, mzero, vNegInf);
        __mmask8 mpass = _mm512_kor(
            _mm512_cmp_pd_mask(v, v, _CMP_NEQ_UQ),           // NaN
            _mm512_cmp_pd_mask(v, _mm512_set1_pd(HUGE_VAL),
                               _CMP_EQ_OQ));                  // +Inf
        lg2 = _mm512_mask_mov_pd(lg2, mpass, v);
        _mm256_storeu_ps(out + i,
                         _mm512_cvtpd_ps(_mm512_mul_pd(lg2, vC)));
    }
#endif
    for (; i < n; i++) {
        out[i] = (float)(go_log2((double)x[i]) * c);
    }
}

// ---------------------------------------------------------------------------
// Data-line span scanner (ref go/text/parse.go:16-78).
//
// Splits buf at '\n', truncates each line at its first `comment` byte,
// drops empty and whitespace-only lines, and emits the [start, end) byte
// span of every surviving data line.  This is the single-pass native
// replacement for the numpy span builder (its whole-buffer cumsum ran at
// ~100 MB/s on this host and dominated end-to-end conversion).
// starts/ends must have capacity for (#newlines in buf) + 1 entries.
// Returns the number of spans written.
// ---------------------------------------------------------------------------

static int64_t scan_lines_range(const char* buf, int64_t r0, int64_t r1,
                                char comment, int64_t* starts,
                                int64_t* ends) {
    int64_t cnt = 0;
    const char* p = buf + r0;
    const char* lim = buf + r1;
    while (p < lim) {
        const char* ls = p;
        const char* nl = (const char*)std::memchr(p, '\n', lim - p);
        const char* le = nl ? nl : lim;
        const char* cm = (const char*)std::memchr(ls, comment, le - ls);
        const char* de = cm ? cm : le;
        const char* q = ls;
        while (q < de && (*q == ' ' || *q == '\t' || *q == '\r')) q++;
        if (q < de) {
            starts[cnt] = ls - buf;
            ends[cnt] = de - buf;
            cnt++;
        }
        p = nl ? nl + 1 : lim;
    }
    return cnt;
}

int64_t mnw_count_newlines(const char* buf, int64_t n, int threads) {
    // threaded memchr count; sizes the caller's span arrays (CPython's
    // bytes.count ran at only ~0.7 GB/s on the 4-core host -- it was
    // the scan stage's actual bottleneck)
    if (n <= 0) return 0;
    if (threads <= 1 || n < (1 << 20)) threads = 1;
    std::vector<int64_t> cnts(threads, 0);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; t++) {
        int64_t lo = n * (int64_t)t / threads;
        int64_t hi = n * (int64_t)(t + 1) / threads;
        ts.emplace_back([=, &cnts]() {
            int64_t c = 0;
            const char* p = buf + lo;
            const char* lim = buf + hi;
            while ((p = (const char*)std::memchr(
                        p, '\n', lim - p)) != nullptr) {
                c++;
                p++;
            }
            cnts[t] = c;
        });
    }
    for (auto& t : ts) t.join();
    int64_t total = 0;
    for (auto c : cnts) total += c;
    return total;
}

int64_t mnw_scan_lines(const char* buf, int64_t n, char comment,
                       int64_t* starts, int64_t* ends, int threads) {
    if (n <= 0) return 0;
    if (threads <= 1 || n < (1 << 20)) {
        return scan_lines_range(buf, 0, n, comment, starts, ends);
    }
    // chunk boundaries snapped forward to just past a newline
    std::vector<int64_t> bnd;
    bnd.push_back(0);
    for (int t = 1; t < threads; t++) {
        int64_t pos = n * (int64_t)t / threads;
        if (pos <= bnd.back()) continue;
        const char* nl = (const char*)std::memchr(buf + pos, '\n', n - pos);
        if (!nl) break;
        int64_t b = (nl - buf) + 1;
        if (b > bnd.back() && b < n) bnd.push_back(b);
    }
    bnd.push_back(n);
    int nch = (int)bnd.size() - 1;

    // each chunk scans into its own slice of the output arrays at the
    // chunk's worst-case offset (#newlines before it + 1), then results
    // are compacted left in order.  Phase 1 counts newlines PER CHUNK
    // in parallel (a serial whole-buffer pre-count capped the threaded
    // scan at single-thread speed: measured flat ~670 MB/s at 1-8
    // threads before this); phase 2 prefix-sums the worst-case offsets
    // and scans in parallel.
    std::vector<int64_t> cnts(nch, 0), offs(nch, 0), lines(nch, 0);
    {
        std::vector<std::thread> ts;
        for (int c = 0; c < nch; c++) {
            ts.emplace_back([=, &lines]() {
                // worst case: one span per line.  Interior chunks end
                // just past a newline, so their line count equals their
                // newline count; only the last chunk can have a
                // trailing unterminated line.  Summed over chunks this
                // stays within the caller's (#newlines + 1) capacity.
                int64_t cnt = (c == nch - 1) ? 1 : 0;
                const char* p = buf + bnd[c];
                const char* lim = buf + bnd[c + 1];
                while ((p = (const char*)std::memchr(
                            p, '\n', lim - p)) != nullptr) {
                    cnt++;
                    p++;
                }
                lines[c] = cnt;
            });
        }
        for (auto& t : ts) t.join();
    }
    {
        int64_t off = 0;
        std::vector<std::thread> ts;
        for (int c = 0; c < nch; c++) {
            offs[c] = off;
            off += lines[c];
            ts.emplace_back([=, &cnts]() {
                cnts[c] = scan_lines_range(buf, bnd[c], bnd[c + 1], comment,
                                           starts + offs[c],
                                           ends + offs[c]);
            });
        }
        for (auto& t : ts) t.join();
    }
    int64_t total = cnts[0];
    for (int c = 1; c < nch; c++) {
        if (offs[c] != total) {
            std::memmove(starts + total, starts + offs[c],
                         sizeof(int64_t) * cnts[c]);
            std::memmove(ends + total, ends + offs[c],
                         sizeof(int64_t) * cnts[c]);
        }
        total += cnts[c];
    }
    return total;
}

// col_kind (may be NULL = all float64): 0 -> float64 out, 1 -> the out
// slot is an int64 buffer filled by the exact integer parser.
int64_t mnw_parse_columns_typed(
    const char* buf, const int64_t* line_starts, const int64_t* line_ends,
    int64_t n_lines, const int64_t* col_idx, const int64_t* col_kind,
    int64_t n_cols, double** out, int threads, char sep) {
    if (n_lines <= 0 || n_cols <= 0) return 0;
    int64_t max_col = 0;
    for (int64_t c = 0; c < n_cols; c++)
        max_col = std::max(max_col, col_idx[c]);
    // fused fast path needs distinct column indices (slot map)
    std::vector<int32_t> slot(max_col + 1, -1);
    bool fused = true;
    for (int64_t c = 0; c < n_cols; c++) {
        if (slot[col_idx[c]] != -1) { fused = false; break; }
        slot[col_idx[c]] = (int32_t)c;
    }
    const int32_t* sl = slot.data();

    auto run_range = [=](int64_t start, int64_t end) -> int64_t {
        if (fused)
            return parse_lines_fused(buf, line_starts, line_ends, start,
                                     end, sl, col_kind, max_col, out, sep);
        return parse_lines_range(buf, line_starts, line_ends, start, end,
                                 col_idx, col_kind, n_cols, max_col, out,
                                 n_lines, sep);
    };
    if (threads <= 1 || n_lines < 1024) {
        return run_range(0, n_lines);
    }
    int64_t chunk = (n_lines + threads - 1) / threads;
    std::vector<std::thread> ts;
    std::vector<int64_t> results((n_lines + chunk - 1) / chunk, 0);
    int64_t w = 0;
    for (int64_t start = 0; start < n_lines; start += chunk, w++) {
        int64_t end = std::min(n_lines, start + chunk);
        int64_t* res = &results[w];
        ts.emplace_back([=]() { *res = run_range(start, end); });
    }
    for (auto& t : ts) t.join();
    for (int64_t r : results) if (r != 0) return r;
    return 0;
}

int64_t mnw_parse_columns(const char* buf, const int64_t* line_starts,
                          const int64_t* line_ends, int64_t n_lines,
                          const int64_t* col_idx, int64_t n_cols,
                          double** out, int threads, char sep) {
    return mnw_parse_columns_typed(buf, line_starts, line_ends, n_lines,
                                   col_idx, nullptr, n_cols, out, threads,
                                   sep);
}

}  // extern "C"
