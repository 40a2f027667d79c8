// Native C core of the PyTorch/CUDA port: counter-based RNG, local sketch
// applies, C API, LIBSVM parser.
//
// The port's own copy of the JAX package's C core (the same C code, so
// both packages' native results agree bitwise), the counterpart of the
// reference's C API layer (capi/sketchc.hpp:21-54, capi/basec.hpp:36-58)
// and chunked LIBSVM reader (utility/io/libsvm_io.hpp:529+).  The port's
// compute path is PyTorch and its CUDA kernels; this library provides (a)
// a standalone C entry point for host applications (the reference's capi
// is the same bridge), and (b) a fast multithreaded parser feeding the
// Python IO layer (libskylark_tpu_torch.io).
//
// RNG compatibility contract: Threefry-2x32 with the same key schedule and
// counter layout as libskylark_tpu_torch.core.random (sample i of a stream
// is a pure function of (seed, lane, base+i)); integer-derived draws
// (rademacher, uniform_int, uniform bits) are BIT-identical to the torch
// path, transcendental ones (normal via Box-Muller, cauchy, exp) match
// to ~1 ulp in float64.
//
// Build: g++ -O3 -shared -fPIC -fopenmp -std=c++17, by
// libskylark_tpu_torch/native/__init__.py at first use, into build/native/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <complex>
#include <string>
#include <vector>
#include <algorithm>
#include <thread>

extern "C" {

// ---------------------------------------------------------------------------
// Threefry-2x32 (matches jax.extend.random.threefry_2x32)
// ---------------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

static void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                         uint32_t* o0, uint32_t* o1) {
    static const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
    uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
    uint32_t x0 = c0 + k0, x1 = c1 + k1;

#define SK_ROUND4(a, b, c, d)                                                 \
    x0 += x1; x1 = rotl32(x1, a); x1 ^= x0;                                   \
    x0 += x1; x1 = rotl32(x1, b); x1 ^= x0;                                   \
    x0 += x1; x1 = rotl32(x1, c); x1 ^= x0;                                   \
    x0 += x1; x1 = rotl32(x1, d); x1 ^= x0;

    SK_ROUND4(rot[0], rot[1], rot[2], rot[3]);
    x0 += k1; x1 += ks2 + 1u;
    SK_ROUND4(rot[4], rot[5], rot[6], rot[7]);
    x0 += ks2; x1 += k0 + 2u;
    SK_ROUND4(rot[0], rot[1], rot[2], rot[3]);
    x0 += k0; x1 += k1 + 3u;
    SK_ROUND4(rot[4], rot[5], rot[6], rot[7]);
    x0 += k1; x1 += ks2 + 4u;
    SK_ROUND4(rot[0], rot[1], rot[2], rot[3]);
    x0 += ks2; x1 += k0 + 5u;
#undef SK_ROUND4

    *o0 = x0;
    *o1 = x1;
}

static const uint32_t SK_GOLDEN = 0x9E3779B9u;

// 64 random bits for counter `ctr` under (seed, lane).
static inline void sk_bits(uint64_t seed, uint32_t lane, uint64_t ctr,
                           uint32_t* hi, uint32_t* lo) {
    uint32_t k0 = (uint32_t)(seed & 0xFFFFFFFFu);
    uint32_t k1 = (uint32_t)((seed >> 32) ^ (uint64_t)(lane * SK_GOLDEN));
    threefry2x32(k0, k1, (uint32_t)(ctr >> 32), (uint32_t)(ctr & 0xFFFFFFFFu),
                 hi, lo);
}

// ---------------------------------------------------------------------------
// bits -> distributions (matching core/random.py)
// ---------------------------------------------------------------------------

static inline double sk_uniform01(uint32_t hi, uint32_t lo) {
    uint64_t top = (uint64_t)(hi >> 7);   // 25 bits
    uint64_t bot = (uint64_t)(lo >> 5);   // 27 bits
    uint64_t k = (top << 27) | bot;       // 52 bits
    return ((double)k + 0.5) * 0x1p-52;
}

static inline float sk_uniform01_f32(uint32_t hi) {
    // HI's top bits — the same leading bits as sk_uniform01's f64 value,
    // so f32 and f64 streams agree to ~2^-24 (cross-precision parity;
    // mirrors core/random.py::_uniform01).
    uint32_t k = hi >> 8;  // 24 bits
    return ((float)k + 0.5f) * 0x1p-24f;
}

// Cephes ndtri (inverse normal CDF) — same algorithm jax.scipy.special
// uses, so float64 values agree to ~1 ulp.  Used by the QMC (inverse-CDF)
// feature maps.
static double sk_ndtri(double y0) {
    static const double P0[5] = {
        -5.99633501014107895267e1, 9.80010754185999661536e1,
        -5.66762857469070293439e1, 1.39312609387279679503e1,
        -1.23916583867381258016e0};
    static const double Q0[8] = {
        1.95448858338141759834e0, 4.67627912898881538453e0,
        8.63602421390890590575e1, -2.25462687854119370527e2,
        2.00260212380060660359e2, -8.20372256168538034e1,
        1.59056225126211695515e1, -1.18331621121330003142e0};
    static const double P1[9] = {
        4.05544892305962419923e0, 3.15251094599893866154e1,
        5.71628192246421288162e1, 4.408050738932008347e1,
        1.46849561928858024014e1, 2.18663306850790267539e0,
        -1.40256079171354495875e-1, -3.50424626827848203418e-2,
        -8.57456785154685413611e-4};
    static const double Q1[8] = {
        1.57799883256466749731e1, 4.53907635128879210584e1,
        4.13172038254672030440e1, 1.50425385692907503408e1,
        2.50464946208309415979e0, -1.42182922854787788574e-1,
        -3.80806407691578277194e-2, -9.33259480895457427372e-4};
    static const double P2[9] = {
        3.23774891776946035970e0, 6.91522889068984211695e0,
        3.93881025292474443415e0, 1.33303460815807542389e0,
        2.01485389549179081538e-1, 1.23716634817820021358e-2,
        3.01581553508235416007e-4, 2.65806974686737550832e-6,
        6.23974539184983651783e-9};
    static const double Q2[8] = {
        6.02427039364742014255e0, 3.67983563856160859403e0,
        1.37702099489081330271e0, 2.16236993594496635890e-1,
        1.34204006088543189037e-2, 3.28014464682127739104e-4,
        2.89247864745380683936e-6, 6.79019408009981274425e-9};

    const double s2pi = 2.50662827463100050242;
    if (y0 <= 0.0) return -INFINITY;
    if (y0 >= 1.0) return INFINITY;
    int code = 1;
    double y = y0;
    if (y > 1.0 - 0.13533528323661269189) {  // 1 - exp(-2)
        y = 1.0 - y;
        code = 0;
    }
    if (y > 0.13533528323661269189) {
        y = y - 0.5;
        double y2 = y * y;
        double num = P0[0], den = 1.0;
        for (int i = 1; i < 5; i++) num = num * y2 + P0[i];
        for (int i = 0; i < 8; i++) den = den * y2 + Q0[i];
        double x = y + y * (y2 * num / den);
        return x * s2pi;
    }
    double x = std::sqrt(-2.0 * std::log(y));
    double x0 = x - std::log(x) / x;
    double z = 1.0 / x;
    double x1;
    if (x < 8.0) {
        double num = P1[0], den = 1.0;
        for (int i = 1; i < 9; i++) num = num * z + P1[i];
        for (int i = 0; i < 8; i++) den = den * z + Q1[i];
        x1 = z * num / den;
    } else {
        double num = P2[0], den = 1.0;
        for (int i = 1; i < 9; i++) num = num * z + P2[i];
        for (int i = 0; i < 8; i++) den = den * z + Q2[i];
        x1 = z * num / den;
    }
    x = x0 - x1;
    if (code) x = -x;
    return x;
}


static inline uint32_t sk_uniform_int(uint32_t hi, uint32_t lo, uint32_t lo_b,
                                      uint32_t hi_b) {
    uint64_t span = (uint64_t)(hi_b - lo_b) + 1;
    uint64_t p1 = (uint64_t)hi * span;
    uint64_t p2 = (uint64_t)lo * span;
    uint64_t s = p1 + (p2 >> 32);
    return lo_b + (uint32_t)(s >> 32);
}

// dist codes
enum { SK_DIST_NORMAL = 0, SK_DIST_CAUCHY = 1, SK_DIST_RADEMACHER = 2,
       SK_DIST_EXP = 3, SK_DIST_UNIFORM = 4 };

// Box-Muller normal from the two counter words (matches core/random.py
// _normal: f64 path, 32 uniform bits per word).
static inline double sk_normal(uint32_t hi, uint32_t lo) {
    double u1 = ((double)hi + 0.5) * 0x1p-32;
    double u2 = ((double)lo + 0.5) * 0x1p-32;
    return std::sqrt(-2.0 * std::log(u1)) * std::cos(2.0 * M_PI * u2);
}

static inline double sk_draw(int dist, uint32_t hi, uint32_t lo) {
    switch (dist) {
        case SK_DIST_NORMAL: return sk_normal(hi, lo);
        case SK_DIST_CAUCHY: return std::tan(M_PI * (sk_uniform01(hi, lo) - 0.5));
        case SK_DIST_RADEMACHER: return (lo & 1u) ? 1.0 : -1.0;
        case SK_DIST_EXP: return -std::log(sk_uniform01(hi, lo));
        default: return sk_uniform01(hi, lo);
    }
}

int sl_sample(uint64_t seed, uint64_t base, long num, int dist, uint32_t lane,
              double* out) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < num; i++) {
        uint32_t hi, lo;
        sk_bits(seed, lane, base + (uint64_t)i, &hi, &lo);
        out[i] = sk_draw(dist, hi, lo);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Context + sketch transforms (C API ≙ capi/sketchc.hpp)
// ---------------------------------------------------------------------------

struct sl_context_t {
    uint64_t seed;
    uint64_t counter;
};

enum sl_type_t { SL_JLT = 0, SL_CT = 1, SL_CWT = 2, SL_MMT = 3, SL_WZT = 4,
                 SL_UST = 5, SL_FJLT = 6, SL_GRFT = 7, SL_LRFT = 8,
                 SL_RLT = 9, SL_MRFT = 10, SL_FGRFT = 11, SL_FMRFT = 12,
                 SL_GQRFT = 13, SL_LQRFT = 14, SL_QRLT = 15, SL_PPT = 16,
                 SL_NUM_SKETCH_TYPES = 17 };

// ---------------------------------------------------------------------------
// Leaped Halton QMC (≙ core/quasirand.py)
// ---------------------------------------------------------------------------

static void sk_primes(int k, std::vector<long>& out) {
    out.clear();
    long c = 2;
    while ((int)out.size() < k) {
        bool p = true;
        for (long d = 2; d * d <= c; d++)
            if (c % d == 0) { p = false; break; }
        if (p) out.push_back(c);
        c++;
    }
}

// Van der Corput radical inverse of (idx + 1) in `base`, 41 digits —
// identical accumulation order to core/quasirand.radical_inverse (f64).
static double sk_radical_inverse(long base, unsigned long long idx) {
    unsigned long long res = idx + 1ull;
    double r = 0.0, m = 1.0;
    for (int d = 0; d < 41; d++) {
        m /= (double)base;
        r += m * (double)(res % (unsigned long long)base);
        res /= (unsigned long long)base;
    }
    return r;
}

// ---------------------------------------------------------------------------
// Complex FFT matching jnp.fft.fft's sign convention
// (X_k = sum_n x_n e^{-2*pi*i*n*k/N}).  sk_fft is the radix-2 kernel;
// sk_fft_any extends it to ARBITRARY length via Bluestein's chirp-z
// (round 3 — removes the former pow2-S restriction on native PPT, whose
// FFTW-backed reference handles any S).
// ---------------------------------------------------------------------------

static void sk_fft(std::complex<double>* x, long nfft, bool inverse) {
    // bit reversal
    for (long i = 1, j = 0; i < nfft; i++) {
        long bit = nfft >> 1;
        for (; j & bit; bit >>= 1) j ^= bit;
        j ^= bit;
        if (i < j) std::swap(x[i], x[j]);
    }
    for (long len = 2; len <= nfft; len <<= 1) {
        double ang = 2.0 * M_PI / (double)len * (inverse ? 1.0 : -1.0);
        std::complex<double> wl(std::cos(ang), std::sin(ang));
        for (long i = 0; i < nfft; i += len) {
            std::complex<double> w(1.0, 0.0);
            for (long j = 0; j < len / 2; j++) {
                std::complex<double> u = x[i + j];
                std::complex<double> v = x[i + j + len / 2] * w;
                x[i + j] = u + v;
                x[i + j + len / 2] = u - v;
                w *= wl;
            }
        }
    }
    if (inverse)
        for (long i = 0; i < nfft; i++) x[i] /= (double)nfft;
}

static long sk_next_pow2(long n);  // defined below

// Bluestein chirp-z: length-n DFT as a pow2 circular convolution.
// X_k = w_k * IFFT(FFT(x.w padded) * FFT(chirp))_k with w_k =
// e^{-pi i k^2/n}; k^2 is reduced mod 2n (the chirp's true period)
// before the angle computation so large n keeps full double-precision
// phase accuracy.  inverse rides the conj identity ifft(x) =
// conj(fft(conj(x)))/n.
static void sk_fft_any(std::complex<double>* x, long n, bool inverse) {
    if (n <= 1) return;
    if ((n & (n - 1)) == 0) {
        sk_fft(x, n, inverse);
        return;
    }
    if (inverse) {
        for (long i = 0; i < n; i++) x[i] = std::conj(x[i]);
        sk_fft_any(x, n, false);
        for (long i = 0; i < n; i++) x[i] = std::conj(x[i]) / (double)n;
        return;
    }
    const long m = sk_next_pow2(2 * n - 1);
    // The chirp table and FFT(b) depend only on n: cache them
    // per-thread (PPT applies call this q+1 times per column under the
    // OpenMP loop — rebuilding them per call would double the FFT work).
    thread_local long plan_n = -1;
    thread_local std::vector<std::complex<double>> w, Bf;
    if (plan_n != n) {
        w.assign(n, {});
        Bf.assign(m, {});
        for (long k = 0; k < n; k++) {
            long long k2 = ((long long)k * k) % (2LL * n);
            double ang = -M_PI * (double)k2 / (double)n;
            w[k] = std::complex<double>(std::cos(ang), std::sin(ang));
        }
        Bf[0] = std::conj(w[0]);
        for (long k = 1; k < n; k++) Bf[k] = Bf[m - k] = std::conj(w[k]);
        sk_fft(Bf.data(), m, false);
        plan_n = n;
    }
    std::vector<std::complex<double>> a(m);
    for (long k = 0; k < n; k++) a[k] = x[k] * w[k];
    sk_fft(a.data(), m, false);
    for (long i = 0; i < m; i++) a[i] *= Bf[i];
    sk_fft(a.data(), m, true);
    for (long k = 0; k < n; k++) x[k] = a[k] * w[k];
}

struct sl_sketch_t {
    int type;
    long n, s;
    long nb;  // FJLT/Fastfood: padded pow2 size
    uint64_t seed;
    uint64_t ctx_counter;  // creation-time counter (serialization)
    // reserved counter bases
    uint64_t base0, base1, base2, base3;
    double param;   // CT: C, WZT: p, UST: replace, RFT: sigma, RLT: beta,
                    // Matern: nu
    double param2;  // Matern: l
};

void* sl_create_context(uint64_t seed) {
    sl_context_t* c = new sl_context_t{seed, 0};
    return c;
}

void sl_free_context(void* ctx) { delete (sl_context_t*)ctx; }

uint64_t sl_context_counter(void* ctx) {
    return ((sl_context_t*)ctx)->counter;
}

static int sk_type_from_name(const char* name) {
    if (!strcmp(name, "JLT")) return SL_JLT;
    if (!strcmp(name, "CT")) return SL_CT;
    if (!strcmp(name, "CWT")) return SL_CWT;
    if (!strcmp(name, "MMT")) return SL_MMT;
    if (!strcmp(name, "WZT")) return SL_WZT;
    if (!strcmp(name, "UST")) return SL_UST;
    if (!strcmp(name, "FJLT")) return SL_FJLT;
    if (!strcmp(name, "GaussianRFT")) return SL_GRFT;
    if (!strcmp(name, "LaplacianRFT")) return SL_LRFT;
    if (!strcmp(name, "ExpSemigroupRLT")) return SL_RLT;
    if (!strcmp(name, "MaternRFT")) return SL_MRFT;
    if (!strcmp(name, "FastGaussianRFT")) return SL_FGRFT;
    if (!strcmp(name, "FastMaternRFT")) return SL_FMRFT;
    if (!strcmp(name, "GaussianQRFT")) return SL_GQRFT;
    if (!strcmp(name, "LaplacianQRFT")) return SL_LQRFT;
    if (!strcmp(name, "ExpSemigroupQRLT")) return SL_QRLT;
    if (!strcmp(name, "PPT")) return SL_PPT;
    return -1;
}

static const char* sk_name_from_type(int t) {
    static const char* names[SL_NUM_SKETCH_TYPES] = {
        "JLT", "CT", "CWT", "MMT", "WZT", "UST",
        "FJLT", "GaussianRFT", "LaplacianRFT",
        "ExpSemigroupRLT", "MaternRFT",
        "FastGaussianRFT", "FastMaternRFT",
        "GaussianQRFT", "LaplacianQRFT",
        "ExpSemigroupQRLT", "PPT"};
    return (t >= 0 && t < SL_NUM_SKETCH_TYPES) ? names[t] : "?";
}

static long sk_next_pow2(long n) {
    long p = 1;
    while (p < n) p *= 2;
    return p;
}

// Reservation schedule mirrors the Python classes exactly.
static void sk_reserve(sl_sketch_t* t, sl_context_t* ctx) {
    switch (t->type) {
        case SL_JLT:
        case SL_CT:
            t->base0 = ctx->counter;
            ctx->counter += (uint64_t)t->n * t->s;
            break;
        case SL_CWT:
        case SL_MMT:
            t->base0 = ctx->counter; ctx->counter += t->n;  // idx
            t->base1 = ctx->counter; ctx->counter += t->n;  // val
            break;
        case SL_WZT:
            t->base0 = ctx->counter; ctx->counter += t->n;
            t->base1 = ctx->counter; ctx->counter += t->n;
            t->base2 = ctx->counter; ctx->counter += t->n;  // rademacher
            break;
        case SL_UST:
            t->base0 = ctx->counter;
            ctx->counter += (t->param != 0.0) ? t->s : t->n;
            break;
        case SL_FJLT:
            // RFUT diagonal (N), then UST(replace) samples (S).
            t->base0 = ctx->counter; ctx->counter += t->n;
            t->base1 = ctx->counter; ctx->counter += t->s;
            break;
        case SL_GRFT:
        case SL_LRFT:
            // dense W (N·S), then shifts (S) — ≙ RFT_data_t::build.
            t->base0 = ctx->counter;
            ctx->counter += (uint64_t)t->n * t->s;
            t->base1 = ctx->counter; ctx->counter += t->s;
            break;
        case SL_RLT:
            t->base0 = ctx->counter;
            ctx->counter += (uint64_t)t->n * t->s;
            break;
        case SL_MRFT:
            // W (N·S), shifts (S), chi2 scales (S; lanes 1..2nu).
            t->base0 = ctx->counter;
            ctx->counter += (uint64_t)t->n * t->s;
            t->base1 = ctx->counter; ctx->counter += t->s;
            t->base2 = ctx->counter; ctx->counter += t->s;
            break;
        case SL_GQRFT:
        case SL_LQRFT:
        case SL_QRLT:
            break;  // QMC types consume no counters (skip-based)
        case SL_PPT: {
            // q CWTs (2N each), then hash idx (q) and val (q)
            // (≙ sketch/ppt.py reservation order).
            long q = (long)t->nb;  // q stashed in nb for PPT
            t->base0 = ctx->counter;
            ctx->counter += (uint64_t)(2 * t->n) * q;
            t->base1 = ctx->counter; ctx->counter += q;
            t->base2 = ctx->counter; ctx->counter += q;
            break;
        }
        case SL_FGRFT:
        case SL_FMRFT: {
            // ≙ FastRFT_data_t::build: shifts (S), B, G, P (numblks·NB
            // each); FastMatern adds chi2 (numblks·NB).
            long numblks = 1 + (t->s - 1) / t->nb;
            t->base0 = ctx->counter; ctx->counter += t->s;
            t->base1 = ctx->counter; ctx->counter += numblks * t->nb;  // B
            t->base2 = ctx->counter; ctx->counter += numblks * t->nb;  // G
            t->base3 = ctx->counter; ctx->counter += numblks * t->nb;  // P
            if (t->type == SL_FMRFT) {
                // chi base stored by re-deriving: it is base3 + blk·NB.
                ctx->counter += numblks * t->nb;
            }
            break;
        }
    }
}

int sl_create_sketch_transform_ex(void* ctx_, const char* type, long n,
                                  long s, double param, double param2,
                                  double param3, void** out) {
    int ty = sk_type_from_name(type);
    if (ty < 0) return 103;  // SketchError
    sl_context_t* ctx = (sl_context_t*)ctx_;
    sl_sketch_t* t = new sl_sketch_t();
    t->type = ty;
    t->n = n;
    t->s = s;
    t->nb = (ty == SL_FJLT || ty == SL_FGRFT || ty == SL_FMRFT)
                ? sk_next_pow2(n)
                : n;
    if (ty == SL_PPT) {
        // c (param) and gamma (param2) may legitimately be 0 — no
        // zero-means-default coercion here (unlike sigma/beta, where 0 is
        // invalid).  q=0 is invalid, so 0 selects the reference default.
        long q = (long)(param3 != 0.0 ? param3 : 3.0);
        if (q < 1 || s < 1) { delete t; return 104; }
        t->nb = q;  // PPT stashes q here
    }
    t->seed = ctx->seed;
    t->ctx_counter = ctx->counter;
    t->param = param;
    t->param2 = param2;
    if ((ty == SL_GRFT || ty == SL_LRFT || ty == SL_FGRFT ||
         ty == SL_GQRFT || ty == SL_LQRFT) && param == 0.0)
        t->param = 1.0;
    if ((ty == SL_RLT || ty == SL_QRLT) && param == 0.0) t->param = 1.0;
    if (ty == SL_MRFT || ty == SL_FMRFT) {
        if (t->param == 0.0) t->param = 1.0;   // nu
        if (t->param2 == 0.0) t->param2 = 1.0; // l
        double two_nu = 2.0 * t->param;
        if (std::fabs(two_nu - std::round(two_nu)) > 1e-9 ||
            std::round(two_nu) < 1) {
            delete t;
            return 102;
        }
    }
    if (ty == SL_UST && param == 0.0 && s > n) { delete t; return 102; }
    sk_reserve(t, ctx);
    *out = t;
    return 0;
}

int sl_create_sketch_transform2(void* ctx_, const char* type, long n, long s,
                                double param, double param2, void** out) {
    return sl_create_sketch_transform_ex(ctx_, type, n, s, param, param2, 0.0,
                                         out);
}

int sl_create_sketch_transform(void* ctx_, const char* type, long n, long s,
                               double param, void** out) {
    return sl_create_sketch_transform_ex(ctx_, type, n, s, param, 0.0, 0.0,
                                         out);
}

void sl_free_sketch_transform(void* t) { delete (sl_sketch_t*)t; }

// Dense columnwise apply: out (s, m) = Omega (s, n) @ A (n, m), row-major.
static void sk_apply_dense_cw(const sl_sketch_t* t, const double* A, long m,
                              double* out) {
    const long n = t->n, s = t->s;
    const int dist = (t->type == SL_JLT) ? SK_DIST_NORMAL : SK_DIST_CAUCHY;
    const double scale =
        (t->type == SL_JLT) ? 1.0 / std::sqrt((double)s) : t->param / (double)s;
#pragma omp parallel for schedule(static)
    for (long i = 0; i < s; i++) {
        double* orow = out + i * m;
        for (long c = 0; c < m; c++) orow[c] = 0.0;
        for (long j = 0; j < n; j++) {
            uint32_t hi, lo;
            sk_bits(t->seed, 0, t->base0 + (uint64_t)(i * n + j), &hi, &lo);
            double w = sk_draw(dist, hi, lo) * scale;
            const double* arow = A + j * m;
            for (long c = 0; c < m; c++) orow[c] += w * arow[c];
        }
    }
}

static double sk_hash_value(const sl_sketch_t* t, long i) {
    uint32_t hi, lo;
    switch (t->type) {
        case SL_CWT:
            sk_bits(t->seed, 0, t->base1 + (uint64_t)i, &hi, &lo);
            return (lo & 1u) ? 1.0 : -1.0;
        case SL_MMT:
            sk_bits(t->seed, 0, t->base1 + (uint64_t)i, &hi, &lo);
            return std::tan(M_PI * (sk_uniform01(hi, lo) - 0.5));
        case SL_WZT: {
            sk_bits(t->seed, 0, t->base1 + (uint64_t)i, &hi, &lo);
            double e = -std::log(sk_uniform01(hi, lo));
            uint32_t h2, l2;
            sk_bits(t->seed, 0, t->base2 + (uint64_t)i, &h2, &l2);
            double pm = (l2 & 1u) ? 1.0 : -1.0;
            return pm * std::pow(1.0 / e, 1.0 / t->param);
        }
    }
    return 0.0;
}

static void sk_apply_hash_cw(const sl_sketch_t* t, const double* A, long m,
                             double* out) {
    const long n = t->n, s = t->s;
    std::memset(out, 0, sizeof(double) * s * m);
    for (long i = 0; i < n; i++) {
        uint32_t hi, lo;
        sk_bits(t->seed, 0, t->base0 + (uint64_t)i, &hi, &lo);
        long b = (long)sk_uniform_int(hi, lo, 0, (uint32_t)(s - 1));
        double v = sk_hash_value(t, i);
        const double* arow = A + i * m;
        double* orow = out + b * m;
        for (long c = 0; c < m; c++) orow[c] += v * arow[c];
    }
}

static void sk_ust_samples(const sl_sketch_t* t, std::vector<long>& idx) {
    idx.resize(t->s);
    if (t->param != 0.0) {  // with replacement
        for (long i = 0; i < t->s; i++) {
            uint32_t hi, lo;
            sk_bits(t->seed, 0, t->base0 + (uint64_t)i, &hi, &lo);
            idx[i] = (long)sk_uniform_int(hi, lo, 0, (uint32_t)(t->n - 1));
        }
    } else {  // argsort of n f32 keys, keep first s (matches UST)
        std::vector<std::pair<float, long>> keys(t->n);
        for (long i = 0; i < t->n; i++) {
            uint32_t hi, lo;
            sk_bits(t->seed, 0, t->base0 + (uint64_t)i, &hi, &lo);
            keys[i] = {sk_uniform01_f32(hi), i};
        }
        std::stable_sort(keys.begin(), keys.end(),
                         [](const std::pair<float, long>& a,
                            const std::pair<float, long>& b) {
                             return a.first < b.first;
                         });
        for (long i = 0; i < t->s; i++) idx[i] = keys[i].second;
    }
}

static void sk_apply_ust_cw(const sl_sketch_t* t, const double* A, long m,
                            double* out) {
    std::vector<long> idx;
    sk_ust_samples(t, idx);
    for (long i = 0; i < t->s; i++)
        std::memcpy(out + i * m, A + idx[i] * m, sizeof(double) * m);
}

// In-place orthonormal FWHT over a length-nb (pow2) buffer, Sylvester
// (natural) order — matches sketch/fut.py wht().
static void sk_fwht(double* x, long nb) {
    for (long h = 1; h < nb; h *= 2)
        for (long i = 0; i < nb; i += 2 * h)
            for (long j = i; j < i + h; j++) {
                double a = x[j], b = x[j + h];
                x[j] = a + b;
                x[j + h] = a - b;
            }
    double scale = 1.0 / std::sqrt((double)nb);
    for (long i = 0; i < nb; i++) x[i] *= scale;
}

// FJLT columnwise: out (s, m) = sqrt(nb/s) · sample(H·(D ⊙ A)) per column.
static void sk_apply_fjlt_cw(const sl_sketch_t* t, const double* A, long m,
                             double* out) {
    const long n = t->n, nb = t->nb, s = t->s;
    std::vector<double> D(n);
    std::vector<long> samples(s);
    for (long i = 0; i < n; i++) {
        uint32_t hi, lo;
        sk_bits(t->seed, 0, t->base0 + (uint64_t)i, &hi, &lo);
        D[i] = (lo & 1u) ? 1.0 : -1.0;
    }
    for (long i = 0; i < s; i++) {
        uint32_t hi, lo;
        sk_bits(t->seed, 0, t->base1 + (uint64_t)i, &hi, &lo);
        samples[i] = (long)sk_uniform_int(hi, lo, 0, (uint32_t)(nb - 1));
    }
    const double scale = std::sqrt((double)nb / (double)s);
#pragma omp parallel
    {
        std::vector<double> work(nb);
#pragma omp for schedule(static)
        for (long c = 0; c < m; c++) {
            for (long i = 0; i < n; i++) work[i] = D[i] * A[i * m + c];
            std::fill(work.begin() + n, work.end(), 0.0);
            sk_fwht(work.data(), nb);
            for (long i = 0; i < s; i++)
                out[i * m + c] = scale * work[samples[i]];
        }
    }
}

// χ²_{2ν}(i) as a sum over lanes 1..2ν — MUST match
// core.random.chi2_lanes (shared by Matérn and Fastfood-Matérn).
static double sk_chi2(uint64_t seed, uint64_t base, uint64_t i, int two_nu) {
    double chi2 = 0.0;
    for (int lane = 1; lane <= two_nu; lane++) {
        uint32_t hi, lo;
        sk_bits(seed, (uint32_t)lane, base + i, &hi, &lo);
        double z = sk_normal(hi, lo);
        chi2 += z * z;
    }
    return chi2;
}

// RFT columnwise: out = outscale·cos(scale_i·(inscale·W·A)_i + shift);
// W normal (Gaussian/Matérn) or cauchy (Laplacian); Matérn multiplies
// per-row multivariate-t corrections sqrt(2ν/χ²_{2ν}) (chi2 from lanes
// 1..2ν on base2, matching core.random.chi2_lanes).  RLT:
// out = outscale·exp(−inscale·W·A) with W ~ Lévy.
// ≙ RFT_Elemental.hpp:85-120 / RFT_data.hpp:336-345 / RLT_Elemental.hpp:77.
static void sk_apply_rft_cw(const sl_sketch_t* t, const double* A, long m,
                            double* out) {
    const long n = t->n, s = t->s;
    const bool rlt = t->type == SL_RLT;  // rlt branch never reads dist
    const bool matern = t->type == SL_MRFT;
    const int dist =
        (t->type == SL_LRFT) ? SK_DIST_CAUCHY : SK_DIST_NORMAL;
    const double inscale =
        rlt ? (t->param * t->param / 2.0)
            : (1.0 / (matern ? t->param2 : t->param));
    const double outscale =
        rlt ? std::sqrt(1.0 / (double)s) : std::sqrt(2.0 / (double)s);
#pragma omp parallel for schedule(static)
    for (long i = 0; i < s; i++) {
        double* orow = out + i * m;
        for (long c = 0; c < m; c++) orow[c] = 0.0;
        for (long j = 0; j < n; j++) {
            uint32_t hi, lo;
            sk_bits(t->seed, 0, t->base0 + (uint64_t)(i * n + j), &hi, &lo);
            double w;
            if (rlt) {
                double z = sk_normal(hi, lo);
                w = 1.0 / (z * z);  // standard Lévy = 1/Z²
            } else {
                w = sk_draw(dist, hi, lo);
            }
            w *= inscale;
            const double* arow = A + j * m;
            for (long c = 0; c < m; c++) orow[c] += w * arow[c];
        }
        if (rlt) {
            for (long c = 0; c < m; c++)
                orow[c] = outscale * std::exp(-orow[c]);
        } else {
            if (matern) {
                int two_nu = (int)std::llround(2.0 * t->param);
                double chi2 = sk_chi2(t->seed, t->base2, (uint64_t)i, two_nu);
                double sc = std::sqrt(2.0 * t->param / chi2);
                for (long c = 0; c < m; c++) orow[c] *= sc;
            }
            uint32_t hi, lo;
            sk_bits(t->seed, 0, t->base1 + (uint64_t)i, &hi, &lo);
            double shift = sk_uniform01(hi, lo) * 2.0 * M_PI;
            for (long c = 0; c < m; c++)
                orow[c] = outscale * std::cos(orow[c] + shift);
        }
    }
}

// QMC feature maps (≙ sketch/rft.py QRFT / sketch/rlt.py QRLT): W rows
// from the leaped Halton sequence through inverse CDFs; no counters.
static void sk_apply_qmc_cw(const sl_sketch_t* t, const double* A, long m,
                            double* out) {
    const long n = t->n, s = t->s;
    const bool rlt = t->type == SL_QRLT;
    const long seq_d = rlt ? n : n + 1;  // QRFT uses dim n for the shift
    const long skip = (long)t->param2;
    std::vector<long> primes;
    sk_primes((int)seq_d + 1, primes);
    const long leap = primes[seq_d];  // (d+1)-th prime ≙ quasirand.py
    const double inscale =
        rlt ? (t->param * t->param / 2.0) : (1.0 / t->param);
    const double outscale =
        rlt ? std::sqrt(1.0 / (double)s) : std::sqrt(2.0 / (double)s);
#pragma omp parallel for schedule(static)
    for (long i = 0; i < s; i++) {
        double* orow = out + i * m;
        for (long c = 0; c < m; c++) orow[c] = 0.0;
        unsigned long long idx = (unsigned long long)(skip + i) *
                                 (unsigned long long)leap;
        for (long j = 0; j < n; j++) {
            double u = sk_radical_inverse(primes[j], idx);
            double w;
            if (rlt) {
                double z = sk_ndtri(u / 2.0);
                w = 1.0 / (z * z);  // Lévy quantile
            } else if (t->type == SL_LQRFT) {
                w = std::tan(M_PI * (u - 0.5));
            } else {
                w = sk_ndtri(u);
            }
            w *= inscale;
            const double* arow = A + j * m;
            for (long c = 0; c < m; c++) orow[c] += w * arow[c];
        }
        if (rlt) {
            for (long c = 0; c < m; c++)
                orow[c] = outscale * std::exp(-orow[c]);
        } else {
            double shift =
                2.0 * M_PI * sk_radical_inverse(primes[n], idx);
            for (long c = 0; c < m; c++)
                orow[c] = outscale * std::cos(orow[c] + shift);
        }
    }
}

// PPT / TensorSketch columnwise (≙ sketch/ppt.py): q CountSketches
// composed in the FFT domain; any S (Bluestein for non-pow2).
static void sk_apply_ppt_cw(const sl_sketch_t* t, const double* A, long m,
                            double* out) {
    const long n = t->n, s = t->s, q = (long)t->nb;
    const double sqrt_c = std::sqrt(t->param);
    const double sqrt_g = std::sqrt(t->param2);
    // Per-level CWT hash arrays + the constant-term hash.
    std::vector<long> buckets(q * n);
    std::vector<double> values(q * n);
    std::vector<long> hidx(q);
    std::vector<double> hval(q);
    for (long l = 0; l < q; l++) {
        uint64_t idx_base = t->base0 + (uint64_t)(l * 2 * n);
        uint64_t val_base = idx_base + (uint64_t)n;
        for (long i = 0; i < n; i++) {
            uint32_t hi, lo;
            sk_bits(t->seed, 0, idx_base + (uint64_t)i, &hi, &lo);
            buckets[l * n + i] =
                (long)sk_uniform_int(hi, lo, 0, (uint32_t)(s - 1));
            sk_bits(t->seed, 0, val_base + (uint64_t)i, &hi, &lo);
            values[l * n + i] = (lo & 1u) ? 1.0 : -1.0;
        }
        uint32_t hi, lo;
        sk_bits(t->seed, 0, t->base1 + (uint64_t)l, &hi, &lo);
        hidx[l] = (long)sk_uniform_int(hi, lo, 0, (uint32_t)(s - 1));
        sk_bits(t->seed, 0, t->base2 + (uint64_t)l, &hi, &lo);
        hval[l] = (lo & 1u) ? 1.0 : -1.0;
    }
#pragma omp parallel
    {
        std::vector<std::complex<double>> P(s), W(s);
#pragma omp for schedule(static)
        for (long c = 0; c < m; c++) {
            for (long k = 0; k < s; k++) P[k] = {1.0, 0.0};
            for (long l = 0; l < q; l++) {
                for (long k = 0; k < s; k++) W[k] = {0.0, 0.0};
                for (long i = 0; i < n; i++)
                    W[buckets[l * n + i]] +=
                        sqrt_g * values[l * n + i] * A[i * m + c];
                W[hidx[l]] += sqrt_c * hval[l];
                sk_fft_any(W.data(), s, false);
                for (long k = 0; k < s; k++) P[k] *= W[k];
            }
            sk_fft_any(P.data(), s, true);
            for (long k = 0; k < s; k++) out[k * m + c] = P[k].real();
        }
    }
}

// Fastfood columnwise (≙ FRFT_Elemental.hpp / sketch/frft.py _features):
// per block: H·(B⊙x) → permute → G⊙ → H → Sm⊙; first S coords; cos.
static void sk_apply_frft_cw(const sl_sketch_t* t, const double* A, long m,
                             double* out) {
    const long n = t->n, nb = t->nb, s = t->s;
    const long numblks = 1 + (s - 1) / nb;
    const bool matern = t->type == SL_FMRFT;
    const uint64_t chi_base = t->base3 + (uint64_t)(numblks * nb);

    // Counter-derived per-block data.
    std::vector<double> B(numblks * nb), G(numblks * nb);
    std::vector<long> perm(numblks * nb);
    std::vector<double> Sm(numblks * nb);
    for (long i = 0; i < numblks * nb; i++) {
        uint32_t hi, lo;
        sk_bits(t->seed, 0, t->base1 + (uint64_t)i, &hi, &lo);
        B[i] = (lo & 1u) ? 1.0 : -1.0;
        sk_bits(t->seed, 0, t->base2 + (uint64_t)i, &hi, &lo);
        G[i] = sk_normal(hi, lo);
    }
    for (long b = 0; b < numblks; b++) {
        // argsort (stable) of f32 uniform keys, matching jnp.argsort.
        std::vector<std::pair<float, long>> keys(nb);
        for (long j = 0; j < nb; j++) {
            uint32_t hi, lo;
            sk_bits(t->seed, 0, t->base3 + (uint64_t)(b * nb + j), &hi, &lo);
            keys[j] = {sk_uniform01_f32(hi), j};
        }
        std::stable_sort(keys.begin(), keys.end(),
                         [](const std::pair<float, long>& a,
                            const std::pair<float, long>& x) {
                             return a.first < x.first;
                         });
        for (long j = 0; j < nb; j++) perm[b * nb + j] = keys[j].second;
    }
    for (long i = 0; i < numblks * nb; i++) {
        if (matern) {
            int two_nu = (int)std::llround(2.0 * t->param);
            double chi2 = sk_chi2(t->seed, chi_base, (uint64_t)i, two_nu);
            Sm[i] = std::sqrt(2.0 * t->param / chi2) *
                    (std::sqrt((double)nb) / t->param2);
        } else {
            Sm[i] = std::sqrt((double)nb) / t->param;  // sqrt(NB)/sigma
        }
    }
    std::vector<double> shifts(s);
    for (long i = 0; i < s; i++) {
        uint32_t hi, lo;
        sk_bits(t->seed, 0, t->base0 + (uint64_t)i, &hi, &lo);
        shifts[i] = sk_uniform01(hi, lo) * 2.0 * M_PI;
    }
    const double outscale = std::sqrt(2.0 / (double)s);
#pragma omp parallel
    {
        std::vector<double> work(nb), tmp(nb);
#pragma omp for schedule(static)
        for (long c = 0; c < m; c++) {
            // The block writes below cover exactly rows [0, s).
            for (long b = 0; b < numblks; b++) {
                for (long j = 0; j < n; j++)
                    work[j] = B[b * nb + j] * A[j * m + c];
                std::fill(work.begin() + n, work.end(), 0.0);
                sk_fwht(work.data(), nb);
                for (long j = 0; j < nb; j++)
                    tmp[j] = G[b * nb + j] * work[perm[b * nb + j]];
                sk_fwht(tmp.data(), nb);
                for (long j = 0; j < nb && b * nb + j < s; j++)
                    out[(b * nb + j) * m + c] =
                        outscale * std::cos(tmp[j] * Sm[b * nb + j] +
                                            shifts[b * nb + j]);
            }
        }
    }
}

// dim: 0 = columnwise (A (n, m) -> (s, m)), 1 = rowwise (A (m, n) -> (m, s)).
int sl_apply_sketch_transform(void* t_, const double* A, long rows, long cols,
                              int dim, double* out) {
    const sl_sketch_t* t = (sl_sketch_t*)t_;
    if (dim == 0) {
        if (rows != t->n) return 102;
        switch (t->type) {
            case SL_JLT: case SL_CT: sk_apply_dense_cw(t, A, cols, out); break;
            case SL_UST: sk_apply_ust_cw(t, A, cols, out); break;
            case SL_FJLT: sk_apply_fjlt_cw(t, A, cols, out); break;
            case SL_GRFT: case SL_LRFT: case SL_RLT: case SL_MRFT:
                sk_apply_rft_cw(t, A, cols, out); break;
            case SL_FGRFT: case SL_FMRFT:
                sk_apply_frft_cw(t, A, cols, out); break;
            case SL_GQRFT: case SL_LQRFT: case SL_QRLT:
                sk_apply_qmc_cw(t, A, cols, out); break;
            case SL_PPT: sk_apply_ppt_cw(t, A, cols, out); break;
            default: sk_apply_hash_cw(t, A, cols, out); break;
        }
        return 0;
    }
    if (cols != t->n) return 102;
    // rowwise = columnwise on the transpose.
    std::vector<double> AT((size_t)rows * cols), OT((size_t)t->s * rows);
    for (long r = 0; r < rows; r++)
        for (long c = 0; c < cols; c++) AT[(size_t)c * rows + r] = A[(size_t)r * cols + c];
    int rc = sl_apply_sketch_transform((void*)t, AT.data(), cols, rows, 0,
                                       OT.data());
    if (rc) return rc;
    for (long r = 0; r < rows; r++)
        for (long i = 0; i < t->s; i++)
            out[(size_t)r * t->s + i] = OT[(size_t)i * rows + r];
    return 0;
}

// JSON schema identical to sketch.base.SketchTransform.to_dict().
int sl_serialize_sketch_transform(void* t_, char** out) {
    const sl_sketch_t* t = (sl_sketch_t*)t_;
    char extra[96] = "";
    if (t->type == SL_CT)
        snprintf(extra, sizeof extra, ", \"C\": %.17g", t->param);
    else if (t->type == SL_WZT)
        snprintf(extra, sizeof extra, ", \"P\": %.17g", t->param);
    else if (t->type == SL_UST)
        snprintf(extra, sizeof extra, ", \"replace\": %s",
                 t->param != 0.0 ? "true" : "false");
    else if (t->type == SL_FJLT)
        snprintf(extra, sizeof extra, ", \"fut\": \"wht\"");
    else if (t->type == SL_GRFT || t->type == SL_LRFT ||
             t->type == SL_FGRFT)
        snprintf(extra, sizeof extra, ", \"sigma\": %.17g", t->param);
    else if (t->type == SL_RLT)
        snprintf(extra, sizeof extra, ", \"beta\": %.17g", t->param);
    else if (t->type == SL_MRFT || t->type == SL_FMRFT)
        snprintf(extra, sizeof extra, ", \"nu\": %.17g, \"l\": %.17g",
                 t->param, t->param2);
    else if (t->type == SL_GQRFT || t->type == SL_LQRFT)
        snprintf(extra, sizeof extra, ", \"sigma\": %.17g, \"skip\": %ld",
                 t->param, (long)t->param2);
    else if (t->type == SL_QRLT)
        snprintf(extra, sizeof extra, ", \"beta\": %.17g, \"skip\": %ld",
                 t->param, (long)t->param2);
    else if (t->type == SL_PPT)
        snprintf(extra, sizeof extra,
                 ", \"q\": %ld, \"c\": %.17g, \"gamma\": %.17g", (long)t->nb,
                 t->param, t->param2);
    char* buf = (char*)malloc(512);
    snprintf(buf, 512,
             "{\"skylark_object_type\": \"sketch\", \"skylark_version\": 2, "
             "\"sketch_type\": \"%s\", \"N\": %ld, \"S\": %ld, "
             "\"creation_context\": {\"skylark_object_type\": \"context\", "
             "\"skylark_version\": 2, \"seed\": %llu, \"counter\": %llu}%s}",
             sk_name_from_type(t->type), t->n, t->s,
             (unsigned long long)t->seed, (unsigned long long)t->ctx_counter,
             extra);
    *out = buf;
    return 0;
}

void sl_free_str(char* s) { free(s); }

// Introspection (≙ sl_supported_sketch_transforms, capi/csketch.cpp:74+).
// The reference enumerates ~190 (type, input-dist, output-dist) combos;
// per-distribution specializations collapse here (host arrays, sharding
// handled by the JAX layer), so each type supports one matrix kind in
// both directions.  One "TYPE Matrix Matrix direction" line per combo.
int sl_supported_sketch_transforms(char** out) {
    std::string s;
    for (int t = 0; t < SL_NUM_SKETCH_TYPES; ++t) {
        s += sk_name_from_type(t);
        s += " Matrix Matrix columnwise\n";
        s += sk_name_from_type(t);
        s += " Matrix Matrix rowwise\n";
    }
    char* buf = (char*)malloc(s.size() + 1);
    if (!buf) return 101;
    memcpy(buf, s.c_str(), s.size() + 1);
    *out = buf;
    return 0;
}

// Minimal JSON field extraction (flat schema written by ourselves/Python).
static bool js_find_num(const char* js, const char* key, double* val) {
    std::string pat = std::string("\"") + key + "\":";
    const char* p = strstr(js, pat.c_str());
    if (!p) return false;
    p += pat.size();
    *val = strtod(p, nullptr);
    return true;
}

// Span of the "maps": [ ... ] array: *key_pos = start of the "maps" key,
// *arr_open / *arr_close = the bracket positions.  Shared by the map-
// object splitter and the top-level-key scoping below so the two never
// drift on bracket-matching rules.  Returns false when no complete array
// exists; an unterminated array reports close = npos with key/open set.
static bool js_maps_span(const std::string& js, size_t* key_pos,
                         size_t* arr_open, size_t* arr_close) {
    *arr_open = *arr_close = std::string::npos;
    *key_pos = js.find("\"maps\":");
    if (*key_pos == std::string::npos) return false;
    *arr_open = js.find('[', *key_pos);
    if (*arr_open == std::string::npos) return false;
    int depth = 0;
    for (size_t i = *arr_open + 1; i < js.size(); i++) {
        char ch = js[i];
        if (ch == '{') depth++;
        else if (ch == '}') depth--;
        else if (ch == ']' && depth == 0) {
            *arr_close = i;
            return true;
        }
    }
    return false;
}

// Model JSON with the "maps" array excised: top-level keys only.  A
// per-map "skylark_version" in a hand-edited / foreign-writer file whose
// top-level key is absent or ordered after "maps" must not masquerade as
// the model's stream version (round-2 advisor finding).
static std::string js_without_maps(const std::string& js) {
    size_t key, open, close;
    if (!js_maps_span(js, &key, &open, &close))
        // No maps key/bracket: nothing to excise.  Unterminated array:
        // keep the prefix only (close == npos distinguishes the cases).
        return key == std::string::npos || open == std::string::npos
                   ? js
                   : js.substr(0, key);
    return js.substr(0, key) + js.substr(close + 1);
}

// Full 64-bit precision (seed/counter can exceed 2^53).
static bool js_find_u64(const char* js, const char* key, uint64_t* val) {
    std::string pat = std::string("\"") + key + "\":";
    const char* p = strstr(js, pat.c_str());
    if (!p) return false;
    p += pat.size();
    *val = strtoull(p, nullptr, 10);
    return true;
}

static bool js_find_str(const char* js, const char* key, char* out, size_t cap) {
    std::string pat = std::string("\"") + key + "\":";
    const char* p = strstr(js, pat.c_str());
    if (!p) return false;
    p += pat.size();
    while (*p == ' ') p++;
    if (*p != '"') return false;
    p++;
    size_t i = 0;
    while (*p && *p != '"' && i + 1 < cap) out[i++] = *p++;
    out[i] = 0;
    return true;
}

int sl_deserialize_sketch_transform(const char* json, void** out) {
    // Python json.dumps uses ", " / ": " separators; normalize spaces.
    std::string norm;
    norm.reserve(strlen(json));
    for (const char* p = json; *p; p++)
        if (*p != ' ' && *p != '\n') norm.push_back(*p);
    char type[32];
    double n, s;
    uint64_t seed, counter;
    if (!js_find_str(norm.c_str(), "sketch_type", type, sizeof type) ||
        !js_find_num(norm.c_str(), "N", &n) ||
        !js_find_num(norm.c_str(), "S", &s) ||
        !js_find_u64(norm.c_str(), "seed", &seed) ||
        !js_find_u64(norm.c_str(), "counter", &counter))
        return 103;
    double param = 0.0;
    if (!strcmp(type, "CT")) { js_find_num(norm.c_str(), "C", &param); if (param == 0) param = 1.0; }
    else if (!strcmp(type, "WZT")) { js_find_num(norm.c_str(), "P", &param); if (param == 0) param = 2.0; }
    else if (!strcmp(type, "UST")) {
        param = strstr(norm.c_str(), "\"replace\":false") ? 0.0 : 1.0;
    }
    double param2 = 0.0;
    if (!strcmp(type, "GaussianRFT") || !strcmp(type, "LaplacianRFT") ||
        !strcmp(type, "FastGaussianRFT")) {
        js_find_num(norm.c_str(), "sigma", &param);
        if (param == 0) param = 1.0;
    }
    else if (!strcmp(type, "ExpSemigroupRLT")) {
        js_find_num(norm.c_str(), "beta", &param);
        if (param == 0) param = 1.0;
    }
    else if (!strcmp(type, "MaternRFT") || !strcmp(type, "FastMaternRFT")) {
        js_find_num(norm.c_str(), "nu", &param);
        js_find_num(norm.c_str(), "l", &param2);
    }
    else if (!strcmp(type, "FJLT")) {
        if (strstr(norm.c_str(), "\"fut\":\"dct\"")) return 104;  // wht only
    }
    double param3 = 0.0;
    if (!strcmp(type, "GaussianQRFT") || !strcmp(type, "LaplacianQRFT")) {
        js_find_num(norm.c_str(), "sigma", &param);
        if (param == 0) param = 1.0;
        js_find_num(norm.c_str(), "skip", &param2);
    }
    else if (!strcmp(type, "ExpSemigroupQRLT")) {
        js_find_num(norm.c_str(), "beta", &param);
        if (param == 0) param = 1.0;
        js_find_num(norm.c_str(), "skip", &param2);
    }
    else if (!strcmp(type, "PPT")) {
        // Absent keys default to the reference's (c=1, gamma=1, q=3);
        // present zeros are preserved (c=0 / gamma=0 are legal).
        if (!js_find_num(norm.c_str(), "c", &param)) param = 1.0;
        if (!js_find_num(norm.c_str(), "gamma", &param2)) param2 = 1.0;
        if (!js_find_num(norm.c_str(), "q", &param3)) param3 = 3.0;
    }
    sl_context_t ctx{seed, counter};
    return sl_create_sketch_transform_ex(&ctx, type, (long)n, (long)s, param,
                                         param2, param3, out);
}

const char* sl_error_string(int code) {
    switch (code) {
        case 0: return "ok";
        case 100: return "skylark error";
        case 101: return "allocation error";
        case 102: return "invalid parameters";
        case 103: return "sketch error";
        case 104: return "unsupported";
        case 105: return "io error";
    }
    return "unknown";
}

// ---------------------------------------------------------------------------
// LIBSVM parser (multithreaded two-pass; ≙ utility/io/libsvm_io.hpp)
// ---------------------------------------------------------------------------

struct sk_chunk_stats { long rows, nnz, max_col; };

static void sk_count_chunk(const char* buf, size_t lo, size_t hi,
                           sk_chunk_stats* st) {
    long rows = 0, nnz = 0, max_col = 0;
    for (size_t i = lo; i < hi;) {
        // one line
        size_t eol = i;
        while (eol < hi && buf[eol] != '\n') eol++;
        // skip blank / comment-only
        size_t j = i;
        while (j < eol && (buf[j] == ' ' || buf[j] == '\t')) j++;
        if (j < eol && buf[j] != '#') {
            rows++;
            for (size_t p = j; p < eol; p++) {
                if (buf[p] == '#') break;
                if (buf[p] == ':') {
                    nnz++;
                    // walk back to read the column index
                    size_t q = p;
                    while (q > j && buf[q - 1] >= '0' && buf[q - 1] <= '9') q--;
                    long col = strtol(buf + q, nullptr, 10);
                    if (col > max_col) max_col = col;
                }
            }
        }
        i = eol + 1;
    }
    st->rows = rows;
    st->nnz = nnz;
    st->max_col = max_col;
}

int sl_libsvm_count(const char* buf, long len, long* n_rows, long* n_nnz,
                    long* max_col) {
    int nt = std::max(1u, std::thread::hardware_concurrency());
    if (len < 1 << 16) nt = 1;
    std::vector<size_t> bounds(nt + 1, 0);
    bounds[nt] = (size_t)len;
    for (int t = 1; t < nt; t++) {
        size_t pos = (size_t)len * t / nt;
        while (pos < (size_t)len && buf[pos] != '\n') pos++;
        bounds[t] = pos < (size_t)len ? pos + 1 : (size_t)len;
    }
    std::vector<sk_chunk_stats> stats(nt);
    std::vector<std::thread> th;
    for (int t = 0; t < nt; t++)
        th.emplace_back(sk_count_chunk, buf, bounds[t], bounds[t + 1],
                        &stats[t]);
    for (auto& x : th) x.join();
    long rows = 0, nnz = 0, mc = 0;
    for (auto& s : stats) {
        rows += s.rows;
        nnz += s.nnz;
        mc = std::max(mc, s.max_col);
    }
    *n_rows = rows;
    *n_nnz = nnz;
    *max_col = mc;
    return 0;
}

// Parse into preallocated arrays.  Row order is file order; two passes
// (count per chunk, then fill with per-chunk offsets).
struct sk_parse_job {
    const char* buf;
    size_t lo, hi;
    long row0, nnz0;
    double* labels;
    long* rows;
    long* cols;
    double* vals;
    long expect_nnz;
    int* status;  // 0 ok, nonzero = malformed chunk
};

static void sk_parse_chunk(sk_parse_job job) {
    long r = job.row0, k = job.nnz0;
    const char* buf = job.buf;
    int bad = 0;
    for (size_t i = job.lo; i < job.hi;) {
        size_t eol = i;
        while (eol < job.hi && buf[eol] != '\n') eol++;
        size_t j = i;
        while (j < eol && (buf[j] == ' ' || buf[j] == '\t')) j++;
        if (j < eol && buf[j] != '#') {
            char* end;
            job.labels[r] = strtod(buf + j, &end);
            const char* p = end;
            while (p < buf + eol) {
                while (p < buf + eol && (*p == ' ' || *p == '\t')) p++;
                if (p >= buf + eol || *p == '#') break;
                long col = strtol(p, &end, 10);
                if (end == p) { bad = 1; break; }  // non-numeric token
                p = end;
                if (*p != ':') { bad = 1; break; }
                if (col < 1) bad = 1;  // 1-based indices only
                p++;
                double v = strtod(p, &end);
                p = end;
                job.rows[k] = r;
                job.cols[k] = col - 1;
                job.vals[k] = v;
                k++;
            }
            r++;
        }
        i = eol + 1;
    }
    // Any count/parse disagreement (malformed tokens) invalidates the
    // chunk: the caller falls back to the strict Python parser.
    if (k - job.nnz0 != job.expect_nnz) bad = 1;
    *job.status = bad;
}

int sl_libsvm_parse(const char* buf, long len, double* labels, long* rows,
                    long* cols, double* vals) {
    int nt = std::max(1u, std::thread::hardware_concurrency());
    if (len < 1 << 16) nt = 1;
    std::vector<size_t> bounds(nt + 1, 0);
    bounds[nt] = (size_t)len;
    for (int t = 1; t < nt; t++) {
        size_t pos = (size_t)len * t / nt;
        while (pos < (size_t)len && buf[pos] != '\n') pos++;
        bounds[t] = pos < (size_t)len ? pos + 1 : (size_t)len;
    }
    std::vector<sk_chunk_stats> stats(nt);
    {
        std::vector<std::thread> th;
        for (int t = 0; t < nt; t++)
            th.emplace_back(sk_count_chunk, buf, bounds[t], bounds[t + 1],
                            &stats[t]);
        for (auto& x : th) x.join();
    }
    std::vector<std::thread> th;
    std::vector<int> status(nt, 0);
    long row0 = 0, nnz0 = 0;
    for (int t = 0; t < nt; t++) {
        sk_parse_job job{buf,  bounds[t], bounds[t + 1], row0, nnz0,
                         labels, rows,     cols,          vals,
                         stats[t].nnz, &status[t]};
        th.emplace_back(sk_parse_chunk, job);
        row0 += stats[t].rows;
        nnz0 += stats[t].nnz;
    }
    for (auto& x : th) x.join();
    for (int t = 0; t < nt; t++)
        if (status[t]) return 105;  // IO error -> caller falls back
    return 0;
}



// ---------------------------------------------------------------------------
// Kernel grams + randomized NLA (≙ capi/ckernel.cpp, capi/cnla.cpp).
// Dense row-major f64 host arrays; OpenMP loops (the C consumers the
// reference serves are CPU-side; the card's path lives in the torch layer).
// ---------------------------------------------------------------------------

static void sk_matmul(const double* A, const double* B, double* C,
                      long m, long k, long n, bool transA, bool transB) {
    // C (m x n) = op(A) op(B), all row-major.
#pragma omp parallel for schedule(static)
    for (long i = 0; i < m; i++) {
        double* crow = C + i * n;
        for (long j = 0; j < n; j++) crow[j] = 0.0;
        for (long p = 0; p < k; p++) {
            double a = transA ? A[p * m + i] : A[i * k + p];
            if (a == 0.0) continue;
            for (long j = 0; j < n; j++) {
                double b = transB ? B[j * k + p] : B[p * n + j];
                crow[j] += a * b;
            }
        }
    }
}

static int sk_cholesky(double* G, long s) {
    // In-place lower Cholesky of s x s row-major G; 0 on success.
    for (long j = 0; j < s; j++) {
        double d = G[j * s + j];
        for (long p = 0; p < j; p++) d -= G[j * s + p] * G[j * s + p];
        if (d <= 0.0) return 103;
        d = std::sqrt(d);
        G[j * s + j] = d;
        for (long i = j + 1; i < s; i++) {
            double v = G[i * s + j];
            for (long p = 0; p < j; p++) v -= G[i * s + p] * G[j * s + p];
            G[i * s + j] = v / d;
        }
    }
    return 0;
}

static void sk_chol_solve_inplace(const double* L, double* B, long s, long t) {
    // Solve (L L^T) X = B for X in-place; B is s x t row-major.
    for (long c = 0; c < t; c++) {
        for (long i = 0; i < s; i++) {
            double v = B[i * t + c];
            for (long p = 0; p < i; p++) v -= L[i * s + p] * B[p * t + c];
            B[i * t + c] = v / L[i * s + i];
        }
        for (long i = s - 1; i >= 0; i--) {
            double v = B[i * t + c];
            for (long p = i + 1; p < s; p++) v -= L[p * s + i] * B[p * t + c];
            B[i * t + c] = v / L[i * s + i];
        }
    }
}

static int sk_cholqr(double* Y, long m, long s) {
    // Orthonormalize columns of Y (m x s row-major) via CholeskyQR2 with
    // a relative ridge: exactly rank-deficient Y (sketches of low-rank A)
    // would break plain Cholesky; ridged null directions come out with
    // ~zero singular content and are dropped by the rank-k truncation
    // (same rationale as the JAX layer's eigh floor in gram_orth).
    std::vector<double> G(s * s);
    for (int pass = 0; pass < 2; pass++) {
        sk_matmul(Y, Y, G.data(), s, m, s, true, false);
        double trace = 0.0;
        for (long i = 0; i < s; i++) trace += G[i * s + i];
        double ridge = 1e-12 * (trace > 0 ? trace / s : 1.0);
        for (long i = 0; i < s; i++) G[i * s + i] += ridge;
        int rc = sk_cholesky(G.data(), s);
        if (rc) return rc;
        // Y <- Y L^{-T}: solve row-wise x L^T = y.
#pragma omp parallel for schedule(static)
        for (long i = 0; i < m; i++) {
            double* row = Y + i * s;
            for (long j = 0; j < s; j++) {
                double v = row[j];
                for (long p = 0; p < j; p++) v -= G[j * s + p] * row[p];
                row[j] = v / G[j * s + j];
            }
        }
    }
    return 0;
}

static void sk_jacobi_svd(double* M, double* V, double* sig, long n, long s) {
    // One-sided Jacobi: M (n x s, row-major) -> M = U diag(sig) V^T with
    // the orthonormal U overwriting M's columns and V (s x s) accumulated.
    for (long i = 0; i < s; i++)
        for (long j = 0; j < s; j++) V[i * s + j] = (i == j) ? 1.0 : 0.0;
    const double tol = 1e-14;
    for (int sweep = 0; sweep < 60; sweep++) {
        double off = 0.0;
        for (long p = 0; p < s - 1; p++)
            for (long q = p + 1; q < s; q++) {
                double app = 0, aqq = 0, apq = 0;
                for (long i = 0; i < n; i++) {
                    double x = M[i * s + p], y = M[i * s + q];
                    app += x * x; aqq += y * y; apq += x * y;
                }
                if (std::fabs(apq) <= tol * std::sqrt(app * aqq)) continue;
                off = std::max(off, std::fabs(apq));
                double tau = (aqq - app) / (2.0 * apq);
                double t = (tau >= 0 ? 1.0 : -1.0) /
                           (std::fabs(tau) + std::sqrt(1.0 + tau * tau));
                double c = 1.0 / std::sqrt(1.0 + t * t), sn = c * t;
                for (long i = 0; i < n; i++) {
                    double x = M[i * s + p], y = M[i * s + q];
                    M[i * s + p] = c * x - sn * y;
                    M[i * s + q] = sn * x + c * y;
                }
                for (long i = 0; i < s; i++) {
                    double x = V[i * s + p], y = V[i * s + q];
                    V[i * s + p] = c * x - sn * y;
                    V[i * s + q] = sn * x + c * y;
                }
            }
        if (off == 0.0) break;
    }
    for (long j = 0; j < s; j++) {
        double nrm = 0.0;
        for (long i = 0; i < n; i++) nrm += M[i * s + j] * M[i * s + j];
        sig[j] = std::sqrt(nrm);
        if (sig[j] > 0)
            for (long i = 0; i < n; i++) M[i * s + j] /= sig[j];
    }
}

int sl_kernel_gram(int kernel_type, double p1, double p2, double p3,
                   const double* X, long nx, const double* Y, long ny,
                   long d, double* K) {
    // K[i, j] = k(X[i], Y[j]); X (nx x d), Y (ny x d) row-major.
    if (!X || !Y || !K || nx <= 0 || ny <= 0 || d <= 0) return 102;
    if (kernel_type < 0 || kernel_type > 5) return 104;
    // Matern coefficients depend only on p = floor(nu): hoist the
    // factorial table out of the entry loops.
    long mat_p = 0;
    double mat_scale = 1.0;
    std::vector<double> mat_coef;
    if (kernel_type == 5) {
        mat_p = (long)std::floor(p1);  // nu = p + 1/2
        double fact_p = 1.0, fact_2p = 1.0;
        for (long u = 2; u <= mat_p; u++) fact_p *= u;
        for (long u = 2; u <= 2 * mat_p; u++) fact_2p *= u;
        mat_scale = fact_p / fact_2p;
        mat_coef.resize(mat_p + 1);
        for (long i2 = 0; i2 <= mat_p; i2++) {
            double num = 1.0, di = 1.0, dpi = 1.0;
            for (long u = 2; u <= mat_p + i2; u++) num *= u;
            for (long u = 2; u <= i2; u++) di *= u;
            for (long u = 2; u <= mat_p - i2; u++) dpi *= u;
            mat_coef[i2] = num / (di * dpi);
        }
    }
#pragma omp parallel for schedule(static)
    for (long i = 0; i < nx; i++) {
        const double* xi = X + i * d;
        for (long j = 0; j < ny; j++) {
            const double* yj = Y + j * d;
            double v = 0.0;
            switch (kernel_type) {
                case 0: {  // linear
                    for (long c = 0; c < d; c++) v += xi[c] * yj[c];
                    break;
                }
                case 1: {  // gaussian, p1 = sigma
                    double d2 = 0.0;
                    for (long c = 0; c < d; c++) {
                        double t = xi[c] - yj[c]; d2 += t * t;
                    }
                    v = std::exp(-d2 / (2.0 * p1 * p1));
                    break;
                }
                case 2: {  // polynomial, p1 = q, p2 = c, p3 = gamma
                    double ip = 0.0;
                    for (long c = 0; c < d; c++) ip += xi[c] * yj[c];
                    v = std::pow(p3 * ip + p2, p1);
                    break;
                }
                case 3: {  // laplacian, p1 = sigma
                    double l1 = 0.0;
                    for (long c = 0; c < d; c++) l1 += std::fabs(xi[c] - yj[c]);
                    v = std::exp(-l1 / p1);
                    break;
                }
                case 4: {  // expsemigroup, p1 = beta (nonnegative inputs)
                    double sg = 0.0;
                    for (long c = 0; c < d; c++) {
                        double a = xi[c] + yj[c];
                        sg += std::sqrt(a > 0 ? a : 0.0);
                    }
                    v = std::exp(-p1 * sg);
                    break;
                }
                case 5: {  // matern, p1 = nu (half-integer), p2 = l
                    double d2 = 0.0;
                    for (long c = 0; c < d; c++) {
                        double t = xi[c] - yj[c]; d2 += t * t;
                    }
                    double a = std::sqrt(2.0 * p1) * std::sqrt(d2) / p2;
                    // k = exp(-a) * p!/(2p)! * sum_i coef[i] (2a)^{p-i}
                    double sum = 0.0;
                    for (long i2 = 0; i2 <= mat_p; i2++)
                        sum += mat_coef[i2] *
                               std::pow(2.0 * a, (double)(mat_p - i2));
                    v = std::exp(-a) * mat_scale * sum;
                    break;
                }
            }
            K[i * ny + j] = v;
        }
    }
    return 0;
}

int sl_approximate_svd(void* vctx, const double* A, long m, long n, long k,
                       int num_iterations, double* U, double* S, double* V) {
    // Randomized truncated SVD (≙ capi/cnla.cpp ApproximateSVD): A (m x n)
    // row-major; U (m x k), S (k), V (n x k).  Oversampling 2k, CholQR2,
    // one-sided Jacobi on the small factor.
    if (!vctx || !A || !U || !S || !V) return 102;
    if (k <= 0 || k > (m < n ? m : n)) return 102;
    sl_context_t* ctx = (sl_context_t*)vctx;
    long s = 2 * k; if (s > n) s = n;
    // Omega (n x s) from the context stream (counter-deterministic).
    std::vector<double> Om((size_t)n * s);
    uint64_t base = ctx->counter; ctx->counter += (uint64_t)(n * s);
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n * s; i++) {
        uint32_t hi, lo;
        sk_bits(ctx->seed, 0, base + (uint64_t)i, &hi, &lo);
        Om[i] = sk_draw(SK_DIST_NORMAL, hi, lo);
    }
    std::vector<double> Y((size_t)m * s), W((size_t)n * s);
    sk_matmul(A, Om.data(), Y.data(), m, n, s, false, false);
    for (int it = 0; it < num_iterations; it++) {
        sk_matmul(A, Y.data(), W.data(), n, m, s, true, false);  // W = A^T Y
        int rc = sk_cholqr(W.data(), n, s);
        if (rc) return rc;
        sk_matmul(A, W.data(), Y.data(), m, n, s, false, false);  // Y = A W
    }
    int rc = sk_cholqr(Y.data(), m, s);  // Q in Y
    if (rc) return rc;
    // B = Q^T A (s x n); Jacobi on B^T (n x s).
    std::vector<double> Bt((size_t)n * s), Vs((size_t)s * s), sig(s);
    {
        std::vector<double> B((size_t)s * n);
        sk_matmul(Y.data(), A, B.data(), s, m, n, true, false);
        for (long i = 0; i < s; i++)
            for (long j = 0; j < n; j++) Bt[j * s + i] = B[i * n + j];
    }
    sk_jacobi_svd(Bt.data(), Vs.data(), sig.data(), n, s);
    // B = Vs diag(sig) Bt^T: left vectors Vs, right vectors Bt columns.
    std::vector<long> ord(s);
    for (long i = 0; i < s; i++) ord[i] = i;
    std::sort(ord.begin(), ord.end(),
              [&](long a, long b) { return sig[a] > sig[b]; });
    for (long j = 0; j < k; j++) {
        long c = ord[j];
        S[j] = sig[c];
        for (long i = 0; i < n; i++) V[i * k + j] = Bt[i * s + c];
    }
    // U = Q (m x s) * Vs[:, ord[:k]]
#pragma omp parallel for schedule(static)
    for (long i = 0; i < m; i++) {
        for (long j = 0; j < k; j++) {
            long c = ord[j];
            double v = 0.0;
            for (long p = 0; p < s; p++) v += Y[i * s + p] * Vs[p * s + c];
            U[i * k + j] = v;
        }
    }
    return 0;
}

int sl_approximate_least_squares(void* vctx, const double* A, const double* b,
                                 long m, long n, long t, long sketch_size,
                                 double* x) {
    // Sketch-and-solve LS (≙ capi/cnla.cpp): CWT sketch of [A b] to
    // sketch_size rows, then normal equations on the small problem.
    // A (m x n), b (m x t), x (n x t), all row-major.
    if (!vctx || !A || !b || !x) return 102;
    if (m <= 0 || n <= 0 || t <= 0) return 102;
    long ss = sketch_size > 0 ? sketch_size : 4 * n;
    if (ss > m) ss = m;
    sl_context_t* ctx = (sl_context_t*)vctx;
    void* st = nullptr;
    int rc = sl_create_sketch_transform(vctx, "CWT", m, ss, 0.0, &st);
    if (rc || !st) return rc ? rc : 103;
    std::vector<double> SA((size_t)ss * n), Sb((size_t)ss * t);
    // Columnwise apply: inputs are (m x cols) row-major, exactly A and b.
    rc = sl_apply_sketch_transform(st, A, m, n, 0, SA.data());
    if (!rc) rc = sl_apply_sketch_transform(st, b, m, t, 0, Sb.data());
    sl_free_sketch_transform(st);
    if (rc) return rc;
    std::vector<double> G((size_t)n * n), rhs((size_t)n * t);
    sk_matmul(SA.data(), SA.data(), G.data(), n, ss, n, true, false);
    sk_matmul(SA.data(), Sb.data(), rhs.data(), n, ss, t, true, false);
    // Tiny ridge for numerical safety on rank-deficient sketches.
    double trace = 0.0;
    for (long i = 0; i < n; i++) trace += G[i * n + i];
    double eps = 1e-12 * (trace > 0 ? trace / n : 1.0);
    for (long i = 0; i < n; i++) G[i * n + i] += eps;
    rc = sk_cholesky(G.data(), n);
    if (rc) return rc;
    sk_chol_solve_inplace(G.data(), rhs.data(), n, t);
    std::copy(rhs.begin(), rhs.end(), x);
    return 0;
}



// ---------------------------------------------------------------------------
// Model IO + prediction (≙ capi/cml.cpp + ml/model.hpp:50-276 predict path
// and python-skylark ml/modeling.py LinearizedKernelModel).  Reads the
// FeatureMapModel JSON (+ .coef.npy), rebuilds the feature-map chain with
// the native sketch core, and predicts: out = [Z_1 .. Z_J] @ W.
// ---------------------------------------------------------------------------

static bool sk_read_file(const char* path, std::string& out) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    long sz = -1;
    if (fseek(f, 0, SEEK_END) == 0) sz = ftell(f);
    if (sz < 0 || fseek(f, 0, SEEK_SET) != 0) {  // pipes/FIFOs/ftell failure
        fclose(f);
        return false;
    }
    out.resize(sz);
    bool ok = sz == 0 || fread(&out[0], 1, sz, f) == (size_t)sz;
    fclose(f);
    return ok;
}

static bool sk_npy_header(const std::string& buf, bool* f32,
                          size_t* data_off, long* rows, long* cols) {
    if (buf.size() < 10) return false;
    if (memcmp(buf.data(), "\x93NUMPY", 6) != 0) return false;
    int major = (unsigned char)buf[6];
    size_t hlen, hoff;
    if (major == 1) {
        hlen = (unsigned char)buf[8] | ((unsigned char)buf[9] << 8);
        hoff = 10;
    } else {
        if (buf.size() < 12) return false;
        hlen = (unsigned char)buf[8] | ((unsigned char)buf[9] << 8) |
               ((size_t)(unsigned char)buf[10] << 16) |
               ((size_t)(unsigned char)buf[11] << 24);
        hoff = 12;
    }
    if (buf.size() < hoff + hlen) return false;
    std::string hdr = buf.substr(hoff, hlen);
    *f32 = hdr.find("'<f4'") != std::string::npos;
    if (!*f32 && hdr.find("'<f8'") == std::string::npos) return false;
    if (hdr.find("'fortran_order': False") == std::string::npos) return false;
    const char* sh = strstr(hdr.c_str(), "'shape':");
    if (!sh) return false;
    long r = 0, c = 1;
    if (sscanf(sh, "'shape': (%ld, %ld)", &r, &c) < 1) return false;
    if (r <= 0 || c <= 0) return false;
    *data_off = hoff + hlen;
    *rows = r;
    *cols = c;
    return true;
}

static bool sk_npy_read_f64(const char* path, std::vector<double>& data,
                            long* rows, long* cols) {
    // Minimal NumPy v1/v2 .npy reader for C-order f64/f32 2-D arrays
    // (models trained without x64 save float32 coefficients).
    std::string buf;
    if (!sk_read_file(path, buf)) return false;
    bool f32; size_t off;
    if (!sk_npy_header(buf, &f32, &off, rows, cols)) return false;
    size_t cnt = (size_t)(*rows) * (*cols);
    size_t need = cnt * (f32 ? sizeof(float) : sizeof(double));
    if (buf.size() < off + need) return false;
    data.resize(cnt);
    if (f32) {
        const float* src = (const float*)(buf.data() + off);
        for (size_t i = 0; i < cnt; i++) data[i] = src[i];
    } else {
        memcpy(data.data(), buf.data() + off, need);
    }
    return true;
}

static bool sk_json_map_objects(const std::string& js,
                                std::vector<std::string>& out) {
    // Split the top-level {...} objects inside "maps": [ ... ] (bounds
    // from js_maps_span — the one bracket-matching implementation).
    size_t key, open, close;
    if (!js_maps_span(js, &key, &open, &close)) return false;
    int depth = 0;
    size_t start = 0;
    for (size_t i = open + 1; i < close; i++) {
        char ch = js[i];
        if (ch == '{') {
            if (depth == 0) start = i;
            depth++;
        } else if (ch == '}') {
            depth--;
            if (depth == 0) out.push_back(js.substr(start, i - start + 1));
        }
    }
    return true;
}

int sl_model_info(const char* path, long* input_dim, long* num_outputs) {
    if (!path || !input_dim || !num_outputs) return 102;
    std::string js;
    if (!sk_read_file(path, js)) return 105;
    double v = 0.0;
    // -1 = input_dim absent/null in the JSON (linear models constructed
    // without input_dim); callers must treat it as unknown, not a width.
    *input_dim = js_find_num(js.c_str(), "input_dim", &v) ? (long)v : -1;
    // Header-only peek at the coefficients: no full-file read here.
    FILE* f = fopen((std::string(path) + ".coef.npy").c_str(), "rb");
    if (!f) return 105;
    std::string head(4096, '\0');
    size_t got = fread(&head[0], 1, head.size(), f);
    fclose(f);
    head.resize(got);
    bool f32; size_t off; long r, c;
    if (!sk_npy_header(head, &f32, &off, &r, &c)) return 105;
    *num_outputs = c;
    return 0;
}

struct sl_model_t {
    std::vector<void*> maps;   // deserialized sketch handles (owned)
    std::vector<double> W;     // (D, k) row-major
    long D, k;
    bool scale_maps;
    int version;               // skylark_version the model was saved under
};

// Current RNG stream revision: revision 2 made the f32 uniform stream
// share the f64 value's leading bits.  Models saved under revision 1
// reproduce f32-uniform-derived map internals (UST/NURST selections,
// Fastfood permutations) differently; consumers should compare
// sl_model_stream_version() against sl_stream_revision() and warn, as
// the Python NativeModel wrapper does.
static const int SL_STREAM_REVISION = 2;

int sl_stream_revision(void) { return SL_STREAM_REVISION; }

int sl_model_stream_version(void* m_) {
    // Stream revision the loaded model was serialized under (1 when the
    // JSON predates version tagging); < 0 on a null handle.
    if (!m_) return -1;
    return ((sl_model_t*)m_)->version;
}

void sl_model_free(void* m_) {
    sl_model_t* m = (sl_model_t*)m_;
    if (!m) return;
    for (void* st : m->maps) sl_free_sketch_transform(st);
    delete m;
}

int sl_model_load(const char* path, void** out) {
    // Load-once handle: JSON + coefficients parsed a single time, feature
    // maps deserialized once; batch consumers predict repeatedly
    // (≙ the reference CLI loading the model once for streaming predict).
    if (!path || !out) return 102;
    std::string js;
    if (!sk_read_file(path, js)) return 105;
    sl_model_t* m = new sl_model_t{};
    if (!sk_npy_read_f64((std::string(path) + ".coef.npy").c_str(), m->W,
                         &m->D, &m->k)) {
        delete m;
        return 105;
    }
    double ver = 0.0;
    std::string toplevel = js_without_maps(js);
    m->version =
        js_find_num(toplevel.c_str(), "skylark_version", &ver) ? (int)ver : 1;
    std::vector<std::string> mapjs;
    if (!sk_json_map_objects(js, mapjs)) {
        delete m;
        return 105;
    }
    m->scale_maps =
        toplevel.find("\"scale_maps\": true") != std::string::npos ||
        toplevel.find("\"scale_maps\":true") != std::string::npos;
    long off = 0;
    for (const std::string& mjs : mapjs) {
        void* st = nullptr;
        int rc = sl_deserialize_sketch_transform(mjs.c_str(), &st);
        if (rc) {
            sl_model_free(m);
            return rc;
        }
        off += ((sl_sketch_t*)st)->s;
        m->maps.push_back(st);
    }
    if (!m->maps.empty() && off != m->D) {
        sl_model_free(m);
        return 102;
    }
    *out = m;
    return 0;
}

int sl_model_predict_handle(void* m_, const double* X, long n, long d,
                            double* out) {
    // out (n x k) = features(X) @ W, row-major.
    if (!m_ || !X || !out || n <= 0 || d <= 0) return 102;
    sl_model_t* m = (sl_model_t*)m_;
    long k = m->k;
    for (long i = 0; i < n * k; i++) out[i] = 0.0;
    if (m->maps.empty()) {
        if (m->D != d) return 102;  // linear model on raw features
        sk_matmul(X, m->W.data(), out, n, d, k, false, false);
        return 0;
    }
    long off = 0;
    for (void* st : m->maps) {
        sl_sketch_t* t = (sl_sketch_t*)st;
        long sj = t->s;
        if (t->n != d) return 102;
        std::vector<double> Z((size_t)n * sj);
        int rc = sl_apply_sketch_transform(st, X, n, d, 1, Z.data());
        if (rc) return rc;
        double blk = m->scale_maps ? std::sqrt((double)sj / (double)d) : 1.0;
        // out += blk * Z @ W[off:off+sj]
#pragma omp parallel for schedule(static)
        for (long i = 0; i < n; i++) {
            const double* zrow = Z.data() + (size_t)i * sj;
            double* orow = out + (size_t)i * k;
            for (long p = 0; p < sj; p++) {
                double zv = blk * zrow[p];
                const double* wrow = m->W.data() + (size_t)(off + p) * k;
                for (long j = 0; j < k; j++) orow[j] += zv * wrow[j];
            }
        }
        off += sj;
    }
    return 0;
}

int sl_model_predict(const char* path, const double* X, long n, long d,
                     double* out) {
    // One-shot convenience: load, predict, free.
    void* m = nullptr;
    int rc = sl_model_load(path, &m);
    if (rc) return rc;
    rc = sl_model_predict_handle(m, X, n, d, out);
    sl_model_free(m);
    return rc;
}

}  // extern "C"
