// The port's host repacker: GGUF wire-format blocks -> K-major arrays.
//
// C++ counterpart of ops/repack.py's numpy extraction for Q8_0, Q4_0 (K %
// 256 == 0), Q4_K, Q5_K and Q6_K, a copy of the JAX package's OpenMP
// repacker. native.py builds it with g++ at first use into build/ and calls
// it through ctypes; its outputs are byte-identical to the numpy path (the
// scale products are single f32 multiplies, built with -ffp-contract=off).
// OpenMP-parallel over output rows, the thread count set by the caller
// (repack_set_num_threads). Every function writes the transposed (K-major)
// layout the kernels read:
//   qs    int8 [K, N]  (or uint8 [K/2, N] nibble-planar per 256-superblock)
//   scale f32 [K/g, N]
//   bias  f32 [K/g, N] (formats with mins)
// The q4b hi-plane fold (_fold_hi_plane) is the caller's.

#include <cstdint>
#include <cstring>
#include <cmath>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

static inline float fp16_to_fp32(uint16_t h) {
    // IEEE binary16 -> binary32 (bit-exact, matches GGML_FP16_TO_FP32)
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {                        // subnormal
            exp = 127 - 15 + 1;
            while (!(man & 0x400)) { man <<= 1; exp--; }
            man &= 0x3FF;
            bits = sign | (exp << 23) | (man << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000 | (man << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

static inline uint16_t rd16(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return v;
}

// K-quant 6-bit scale/min unpack (reference get_scale_min_k4)
static inline void scale_min_k4(int j, const uint8_t* q, uint8_t* d, uint8_t* m) {
    if (j < 4) {
        *d = q[j] & 63; *m = q[j + 4] & 63;
    } else {
        *d = (uint8_t)((q[j + 4] & 0xF) | ((q[j - 4] >> 6) << 4));
        *m = (uint8_t)((q[j + 4] >> 4) | ((q[j] >> 6) << 4));
    }
}

}  // namespace

extern "C" {

// Every function: blocks = raw bytes for row-major W[N, K]; outputs K-major.
// qT is int8[K*N] (or uint8[(K/2)*N] when packed4), aT/bT are float[(K/g)*N].

void repack_q8_0(const uint8_t* blocks, int64_t n, int64_t k,
                 int8_t* qT, float* aT) {
    const int64_t bpr = k / 32;               // blocks per row
#pragma omp parallel for schedule(static)
    for (int64_t row = 0; row < n; row++) {
        const uint8_t* src = blocks + row * bpr * 34;
        for (int64_t b = 0; b < bpr; b++) {
            const uint8_t* blk = src + b * 34;
            aT[b * n + row] = fp16_to_fp32(rd16(blk));
            const int8_t* qs = (const int8_t*)(blk + 2);
            int8_t* dst = qT + (b * 32) * n + row;
            for (int i = 0; i < 32; i++) dst[i * n] = qs[i];
        }
    }
}

void repack_q4_0(const uint8_t* blocks, int64_t n, int64_t k,
                 uint8_t* qT, float* aT, float* bT) {
    // output packed nibble-planar per 256-superblock along K: row 128*sb+i of
    // qT holds (q[256sb+i] | q[256sb+128+i]<<4)
    const int64_t bpr = k / 32;
#pragma omp parallel for schedule(static)
    for (int64_t row = 0; row < n; row++) {
        const uint8_t* src = blocks + row * bpr * 18;
        uint8_t tmp[256];
        for (int64_t sb = 0; sb < k / 256; sb++) {
            for (int sub = 0; sub < 8; sub++) {            // 8 32-blocks per sb
                const uint8_t* blk = src + (sb * 8 + sub) * 18;
                float d = fp16_to_fp32(rd16(blk));
                aT[(sb * 8 + sub) * n + row] = d;
                bT[(sb * 8 + sub) * n + row] = -8.0f * d;
                const uint8_t* qs = blk + 2;
                for (int i = 0; i < 16; i++) {
                    tmp[sub * 32 + i] = qs[i] & 0xF;
                    tmp[sub * 32 + 16 + i] = qs[i] >> 4;
                }
            }
            uint8_t* dst = qT + (sb * 128) * n + row;
            for (int i = 0; i < 128; i++)
                dst[i * n] = (uint8_t)(tmp[i] | (tmp[128 + i] << 4));
        }
    }
}

void repack_q4_k(const uint8_t* blocks, int64_t n, int64_t k,
                 uint8_t* qT, float* aT, float* bT) {
    const int64_t spr = k / 256;              // superblocks per row
#pragma omp parallel for schedule(static)
    for (int64_t row = 0; row < n; row++) {
        const uint8_t* src = blocks + row * spr * 144;
        uint8_t tmp[256];
        for (int64_t sb = 0; sb < spr; sb++) {
            const uint8_t* blk = src + sb * 144;
            float d = fp16_to_fp32(rd16(blk));
            float dmin = fp16_to_fp32(rd16(blk + 2));
            const uint8_t* scales = blk + 4;
            const uint8_t* qs = blk + 16;
            for (int g = 0; g < 8; g++) {
                uint8_t sc, mn;
                scale_min_k4(g, scales, &sc, &mn);
                aT[(sb * 8 + g) * n + row] = d * sc;
                bT[(sb * 8 + g) * n + row] = -dmin * mn;
            }
            for (int blk4 = 0; blk4 < 4; blk4++) {
                const uint8_t* q = qs + 32 * blk4;
                for (int i = 0; i < 32; i++) {
                    tmp[64 * blk4 + i] = q[i] & 0xF;
                    tmp[64 * blk4 + 32 + i] = q[i] >> 4;
                }
            }
            uint8_t* dst = qT + (sb * 128) * n + row;
            for (int i = 0; i < 128; i++)
                dst[i * n] = (uint8_t)(tmp[i] | (tmp[128 + i] << 4));
        }
    }
}

void repack_q5_k(const uint8_t* blocks, int64_t n, int64_t k,
                 int8_t* qT, float* aT, float* bT) {
    const int64_t spr = k / 256;
#pragma omp parallel for schedule(static)
    for (int64_t row = 0; row < n; row++) {
        const uint8_t* src = blocks + row * spr * 176;
        for (int64_t sb = 0; sb < spr; sb++) {
            const uint8_t* blk = src + sb * 176;
            float d = fp16_to_fp32(rd16(blk));
            float dmin = fp16_to_fp32(rd16(blk + 2));
            const uint8_t* scales = blk + 4;
            const uint8_t* qh = blk + 16;
            const uint8_t* qs = blk + 48;
            for (int g = 0; g < 8; g++) {
                uint8_t sc, mn;
                scale_min_k4(g, scales, &sc, &mn);
                aT[(sb * 8 + g) * n + row] = d * sc;
                bT[(sb * 8 + g) * n + row] = -dmin * mn;
            }
            int8_t* dst = qT + (sb * 256) * n + row;
            for (int blk4 = 0; blk4 < 4; blk4++) {
                const uint8_t* q = qs + 32 * blk4;
                for (int i = 0; i < 32; i++) {
                    int lo = (q[i] & 0xF) | (((qh[i] >> (2 * blk4)) & 1) << 4);
                    int hi = (q[i] >> 4) | (((qh[i] >> (2 * blk4 + 1)) & 1) << 4);
                    dst[(64 * blk4 + i) * n] = (int8_t)lo;
                    dst[(64 * blk4 + 32 + i) * n] = (int8_t)hi;
                }
            }
        }
    }
}

void repack_q6_k(const uint8_t* blocks, int64_t n, int64_t k,
                 int8_t* qT, float* aT) {
    const int64_t spr = k / 256;
#pragma omp parallel for schedule(static)
    for (int64_t row = 0; row < n; row++) {
        const uint8_t* src = blocks + row * spr * 210;
        for (int64_t sb = 0; sb < spr; sb++) {
            const uint8_t* blk = src + sb * 210;
            const uint8_t* ql = blk;
            const uint8_t* qh = blk + 128;
            const int8_t* sc = (const int8_t*)(blk + 192);
            float d = fp16_to_fp32(rd16(blk + 208));
            for (int g = 0; g < 16; g++)
                aT[(sb * 16 + g) * n + row] = d * sc[g];
            int8_t* dst = qT + (sb * 256) * n + row;
            for (int half = 0; half < 2; half++) {
                const uint8_t* lq = ql + 64 * half;
                const uint8_t* hq = qh + 32 * half;
                for (int i = 0; i < 32; i++) {
                    int q1 = ((lq[i] & 0xF) | (((hq[i] >> 0) & 3) << 4)) - 32;
                    int q2 = ((lq[32 + i] & 0xF) | (((hq[i] >> 2) & 3) << 4)) - 32;
                    int q3 = ((lq[i] >> 4) | (((hq[i] >> 4) & 3) << 4)) - 32;
                    int q4 = ((lq[32 + i] >> 4) | (((hq[i] >> 6) & 3) << 4)) - 32;
                    dst[(128 * half + i) * n] = (int8_t)q1;
                    dst[(128 * half + 32 + i) * n] = (int8_t)q2;
                    dst[(128 * half + 64 + i) * n] = (int8_t)q3;
                    dst[(128 * half + 96 + i) * n] = (int8_t)q4;
                }
            }
        }
    }
}

void repack_set_num_threads(int n) {
#ifdef _OPENMP
    if (n > 0) omp_set_num_threads(n);
#else
    (void)n;
#endif
}

int repack_num_threads(void) {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
