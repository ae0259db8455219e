// Batched ECDSA-P256 verification for Hopper (sm_90a): one thread verifies
// one lane, end to end.
//
// Replaces, in the JAX package:
//   fabric_tpu/ops/p256_kernel.py  verify_batch_device / verify_batch_jit
//     (K1: (20, B) 13-bit limb inputs)                  -> p256_verify_limbs
//   fabric_tpu/ops/p256_kernel.py  verify_batch_bytes_device /
//     verify_batch_bytes_jit with bytes_to_limbs_device
//     (K2: (B, 32) big-endian bytes, a distinct-key limb table and a per-lane
//     key index)                                          -> p256_verify_bytes
// Both entry points share one __device__ routine, verify_lane.
//
// Math. Field elements are 8 native 32-bit words, Montgomery with R = 2^256
// for both p and n (the JAX package uses 13-bit limbs and R = 2^260; only the
// verdict is observable). Products are 32x32->64 (IMAD.WIDE), CIOS
// reduction, every result fully reduced. Point arithmetic is the complete
// projective Renes-Costello-Batina 2016 formulas for a = -3 (algorithm 4 for
// addition, 6 for doubling), step for step as in the JAX package, so
// Q = G, u1 = u2 and u1*G = -u2*Q need no special case. The scalars are
// w = s^(n-2) (Fermat, 4-bit fixed window), u1 = e*w, u2 = r*w mod n; e >= n
// is reduced first. The ladder is the JAX package's 4-bit-window Horner
// loop from the identity: R = 16R + d2*Q + d1*G, MSB first, with the 16
// multiples of Q built per lane (local memory) and the 16 multiples of G
// from a host table staged in shared memory. The final check is projective:
// accept iff Z != 0 and X == r*Z, or X == (r+n)*Z when r < p - n; the
// result is AND-ed with the host's valid_in mask (lanes with valid_in
// false skip the arithmetic).
//
// Bound. The kernel is bound by 32-bit integer multiply throughput (IMAD):
// it reads 102 bytes and does ~0.77 million IMAD issue slots per lane.
// Per verify it runs 332 Montgomery multiplies mod n (1 to_mont, 329 in the
// Fermat inverse, 2 for u1 and u2) and 5,322 mod p (2 to_mont of Q, 14
// complete additions of 14 multiplies for the Q table, 64 windows of 4
// doublings of 13 and 2 additions of 14, and 4 in the final check).
// A multiply mod n has 128 32x32->64 word products plus 8 32-bit low
// products; one mod p has 64 word products (p's words are 0, 1 and
// 2^32 - 1, so its reduction needs no multiplier). That is 383,104 word
// products and 2,656 low products per verify; counting a word product as
// two IMAD issue slots, 768,864 slots. PERF.md's bound is computed from
// these counts (ops/p256_kernel.py IMAD_PER_VERIFY).
//
// Interface: plain C, raw pointers, a cudaStream_t; each launcher returns
// cudaGetLastError(). Limb inputs are int64, canonical 13-bit limbs of
// values below 2^256 (bits at or above 2^256 are ignored).

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

struct Fe {
    u32 w[8];
};

struct Pt {
    Fe x, y, z;
};

struct ModP {
    static constexpr u32 minv = 1u;  // -p^-1 mod 2^32
    __device__ static __forceinline__ u32 w(int i) {
        constexpr u32 W[8] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u,
                              0x00000000u, 0x00000000u, 0x00000001u, 0xFFFFFFFFu};
        return W[i];
    }
};

struct ModN {
    static constexpr u32 minv = 0xEE00BC4Fu;  // -n^-1 mod 2^32
    __device__ static __forceinline__ u32 w(int i) {
        constexpr u32 W[8] = {0xFC632551u, 0xF3B9CAC2u, 0xA7179E84u, 0xBCE6FAADu,
                              0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu};
        return W[i];
    }
};

// R^2 mod p, R^2 mod n, R mod p (Montgomery one), R mod n, b*R mod p,
// p - n, and the Fermat exponent n - 2; little-endian words.
__constant__ u32 R2P[8] = {0x00000003u, 0x00000000u, 0xFFFFFFFFu, 0xFFFFFFFBu,
                           0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFDu, 0x00000004u};
__constant__ u32 R2N[8] = {0xBE79EEA2u, 0x83244C95u, 0x49BD6FA6u, 0x4699799Cu,
                           0x2B6BEC59u, 0x2845B239u, 0xF3D95620u, 0x66E12D94u};
__constant__ u32 ONEP[8] = {0x00000001u, 0x00000000u, 0x00000000u, 0xFFFFFFFFu,
                            0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFEu, 0x00000000u};
__constant__ u32 ONEN[8] = {0x039CDAAFu, 0x0C46353Du, 0x58E8617Bu, 0x43190552u,
                            0x00000000u, 0x00000000u, 0xFFFFFFFFu, 0x00000000u};
__constant__ u32 BMONT[8] = {0x29C4BDDFu, 0xD89CDF62u, 0x78843090u, 0xACF005CDu,
                             0xF7212ED6u, 0xE5A220ABu, 0x04874834u, 0xDC30061Du};
__constant__ u32 P_MINUS_N[8] = {0x039CDAAEu, 0x0C46353Du, 0x58E8617Bu, 0x43190553u,
                                 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u};
__constant__ u32 N_WORDS[8] = {0xFC632551u, 0xF3B9CAC2u, 0xA7179E84u, 0xBCE6FAADu,
                               0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu};
__constant__ u32 N_MINUS_2[8] = {0xFC63254Fu, 0xF3B9CAC2u, 0xA7179E84u, 0xBCE6FAADu,
                                 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu};

__device__ __forceinline__ Fe fe_const(const u32 c[8]) {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = c[j];
    return r;
}

__device__ __forceinline__ Fe fe_zero() {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = 0u;
    return r;
}

// t (9 words, t < 2m) -> t mod m.
template <class M>
__device__ __forceinline__ Fe reduce9(const u32 t[9]) {
    u32 d[8];
    u32 br = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        u64 x = (u64)t[j] - M::w(j) - br;
        d[j] = (u32)x;
        br = (u32)(x >> 63);
    }
    const bool take = (t[8] != 0u) || (br == 0u);
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = take ? d[j] : t[j];
    return r;
}

// a < 2^256 < 2m -> a mod m.
template <class M>
__device__ __forceinline__ Fe reduce_once(const Fe& a) {
    u32 t[9];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = a.w[j];
    t[8] = 0u;
    return reduce9<M>(t);
}

// a * b * 2^-256 mod m for a, b < m (CIOS; t stays below 2m).
template <class M>
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
    u32 t[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) t[j] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        u64 c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            c = (u64)a.w[j] * b.w[i] + t[j] + (c >> 32);
            t[j] = (u32)c;
        }
        c = (u64)t[8] + (c >> 32);
        t[8] = (u32)c;
        t[9] = (u32)(c >> 32);
        const u32 q = t[0] * M::minv;
        c = (u64)q * M::w(0) + t[0];
#pragma unroll
        for (int j = 1; j < 8; ++j) {
            c = (u64)q * M::w(j) + t[j] + (c >> 32);
            t[j - 1] = (u32)c;
        }
        c = (u64)t[8] + (c >> 32);
        t[7] = (u32)c;
        t[8] = t[9] + (u32)(c >> 32);
    }
    return reduce9<M>(t);
}

template <class M>
__device__ __forceinline__ Fe add_mod(const Fe& a, const Fe& b) {
    u32 t[9];
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        c = (u64)a.w[j] + b.w[j] + (c >> 32);
        t[j] = (u32)c;
    }
    t[8] = (u32)(c >> 32);
    return reduce9<M>(t);
}

template <class M>
__device__ __forceinline__ Fe sub_mod(const Fe& a, const Fe& b) {
    Fe d;
    u32 br = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        u64 x = (u64)a.w[j] - b.w[j] - br;
        d.w[j] = (u32)x;
        br = (u32)(x >> 63);
    }
    const u32 mask = 0u - br;  // add m back on a borrow
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        c = (u64)d.w[j] + (M::w(j) & mask) + (c >> 32);
        d.w[j] = (u32)c;
    }
    return d;
}

__device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& b) {
    u32 acc = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc |= a.w[j] ^ b.w[j];
    return acc == 0u;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
    u32 acc = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc |= a.w[j];
    return acc == 0u;
}

// a < b as 256-bit integers.
__device__ __forceinline__ bool fe_lt(const Fe& a, const u32 b[8]) {
    u32 br = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        u64 x = (u64)a.w[j] - b[j] - br;
        br = (u32)(x >> 63);
    }
    return br != 0u;
}

#define FMUL mont_mul<ModP>
#define FADD add_mod<ModP>
#define FSUB sub_mod<ModP>

// Complete addition, RCB 2016 algorithm 4 (a = -3). out may alias p or q.
__device__ __noinline__ void point_add(Pt& out, const Pt& p, const Pt& q) {
    const Fe x1 = p.x, y1 = p.y, z1 = p.z;
    const Fe x2 = q.x, y2 = q.y, z2 = q.z;
    const Fe bb = fe_const(BMONT);
    Fe t0, t1, t2, t3, t4, t5, x3, y3, z3;
    t0 = FMUL(x1, x2);
    t1 = FMUL(y1, y2);
    t2 = FMUL(z1, z2);
    t3 = FADD(x1, y1);
    t4 = FADD(x2, y2);
    t3 = FMUL(t3, t4);
    t4 = FADD(t0, t1);
    t3 = FSUB(t3, t4);
    t4 = FADD(y1, z1);
    t5 = FADD(y2, z2);
    t4 = FMUL(t4, t5);
    t5 = FADD(t1, t2);
    t4 = FSUB(t4, t5);
    x3 = FADD(x1, z1);
    y3 = FADD(x2, z2);
    x3 = FMUL(x3, y3);
    y3 = FADD(t0, t2);
    y3 = FSUB(x3, y3);
    z3 = FMUL(bb, t2);
    x3 = FSUB(y3, z3);
    z3 = FADD(x3, x3);
    x3 = FADD(x3, z3);
    z3 = FSUB(t1, x3);
    x3 = FADD(t1, x3);
    y3 = FMUL(bb, y3);
    t1 = FADD(t2, t2);
    t2 = FADD(t1, t2);
    y3 = FSUB(y3, t2);
    y3 = FSUB(y3, t0);
    t1 = FADD(y3, y3);
    y3 = FADD(t1, y3);
    t1 = FADD(t0, t0);
    t0 = FADD(t1, t0);
    t0 = FSUB(t0, t2);
    t1 = FMUL(t4, y3);
    t2 = FMUL(t0, y3);
    y3 = FMUL(x3, z3);
    y3 = FADD(y3, t2);
    x3 = FMUL(t3, x3);
    x3 = FSUB(x3, t1);
    z3 = FMUL(t4, z3);
    t1 = FMUL(t3, t0);
    z3 = FADD(z3, t1);
    out.x = x3;
    out.y = y3;
    out.z = z3;
}

// Complete doubling, RCB 2016 algorithm 6 (a = -3). out may alias p.
__device__ __noinline__ void point_double(Pt& out, const Pt& p) {
    const Fe x = p.x, y = p.y, z = p.z;
    const Fe bb = fe_const(BMONT);
    Fe t0, t1, t2, t3, x3, y3, z3;
    t0 = FMUL(x, x);
    t1 = FMUL(y, y);
    t2 = FMUL(z, z);
    t3 = FMUL(x, y);
    t3 = FADD(t3, t3);
    z3 = FMUL(x, z);
    z3 = FADD(z3, z3);
    y3 = FMUL(bb, t2);
    y3 = FSUB(y3, z3);
    x3 = FADD(y3, y3);
    y3 = FADD(x3, y3);
    x3 = FSUB(t1, y3);
    y3 = FADD(t1, y3);
    y3 = FMUL(x3, y3);
    x3 = FMUL(x3, t3);
    t3 = FADD(t2, t2);
    t2 = FADD(t2, t3);
    z3 = FMUL(bb, z3);
    z3 = FSUB(z3, t2);
    z3 = FSUB(z3, t0);
    t3 = FADD(z3, z3);
    z3 = FADD(z3, t3);
    t3 = FADD(t0, t0);
    t0 = FADD(t3, t0);
    t0 = FSUB(t0, t2);
    t0 = FMUL(t0, z3);
    y3 = FADD(y3, t0);
    t0 = FMUL(y, z);
    t0 = FADD(t0, t0);
    z3 = FMUL(t0, z3);
    x3 = FSUB(x3, z3);
    z3 = FMUL(t0, t1);
    z3 = FADD(z3, z3);
    z3 = FADD(z3, z3);
    out.x = x3;
    out.y = y3;
    out.z = z3;
}

__device__ __forceinline__ u32 nibble(const u32 words[8], int i) {
    return (words[i >> 3] >> (4 * (i & 7))) & 15u;
}

// x^(n-2) mod n in the Montgomery domain (4-bit fixed window, MSB first).
__device__ __noinline__ Fe inv_mod_n(const Fe& x) {
    Fe tab[16];
    tab[0] = fe_const(ONEN);
    tab[1] = x;
#pragma unroll 1
    for (int k = 2; k < 16; ++k) tab[k] = mont_mul<ModN>(tab[k - 1], x);
    Fe acc = tab[nibble(N_MINUS_2, 63)];
#pragma unroll 1
    for (int i = 62; i >= 0; --i) {
#pragma unroll 1
        for (int k = 0; k < 4; ++k) acc = mont_mul<ModN>(acc, acc);
        acc = mont_mul<ModN>(acc, tab[nibble(N_MINUS_2, i)]);
    }
    return acc;
}

// The verdict of one lane, before the valid_in mask. e, r, s, qx, qy are
// integers below 2^256; g is the 16-entry table of d*G (shared memory).
__device__ __noinline__ bool verify_lane(const Fe& e, const Fe& r, const Fe& s,
                                         const Fe& qx, const Fe& qy, const Pt* g) {
    // --- scalars mod n: w = s^-1 (Montgomery), u1 = e*w, u2 = r*w ---
    const Fe s_m = mont_mul<ModN>(reduce_once<ModN>(s), fe_const(R2N));
    const Fe w_m = inv_mod_n(s_m);
    Fe u1 = mont_mul<ModN>(reduce_once<ModN>(e), w_m);
    Fe u2 = mont_mul<ModN>(reduce_once<ModN>(r), w_m);

    // --- per-lane table of 0..15 * Q ---
    Pt q;
    q.x = FMUL(reduce_once<ModP>(qx), fe_const(R2P));
    q.y = FMUL(reduce_once<ModP>(qy), fe_const(R2P));
    q.z = fe_const(ONEP);
    Pt ident;
    ident.x = fe_zero();
    ident.y = fe_const(ONEP);
    ident.z = fe_zero();
    Pt qt[16];
    qt[0] = ident;
    qt[1] = q;
#pragma unroll 1
    for (int k = 2; k < 16; ++k) point_add(qt[k], qt[k - 1], q);

    // --- Horner: R = 16R + d2*Q + d1*G, MSB window first ---
    Pt acc = ident;
#pragma unroll 1
    for (int i = 63; i >= 0; --i) {
#pragma unroll 1
        for (int k = 0; k < 4; ++k) point_double(acc, acc);
        point_add(acc, acc, qt[nibble(u2.w, i)]);
        const Pt gd = g[nibble(u1.w, i)];
        point_add(acc, acc, gd);
    }

    // --- projective final check: X == r*Z, or X == (r+n)*Z if r < p-n ---
    const Fe rz = FMUL(FMUL(reduce_once<ModP>(r), fe_const(R2P)), acc.z);
    Fe rpn;
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        c = (u64)r.w[j] + N_WORDS[j] + (c >> 32);
        rpn.w[j] = (u32)c;
    }
    const Fe rpnz = FMUL(FMUL(rpn, fe_const(R2P)), acc.z);
    const bool rpn_in_range = fe_lt(r, P_MINUS_N);
    const bool matches = fe_eq(acc.x, rz) || (rpn_in_range && fe_eq(acc.x, rpnz));
    return matches && !fe_is_zero(acc.z);
}

// 32 big-endian bytes -> words.
__device__ __forceinline__ Fe fe_from_bytes(const uint8_t* b) {
    Fe f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int o = 28 - 4 * j;
        f.w[j] = ((u32)b[o] << 24) | ((u32)b[o + 1] << 16) | ((u32)b[o + 2] << 8) |
                 (u32)b[o + 3];
    }
    return f;
}

// 20 canonical 13-bit limbs (limb l at p[l * stride]) -> words.
__device__ __forceinline__ Fe fe_from_limbs(const long long* p, long long stride) {
    Fe f = fe_zero();
#pragma unroll
    for (int l = 0; l < 20; ++l) {
        const u32 v = (u32)p[l * stride] & 0x1FFFu;
        const int bit = 13 * l;
        const int wi = bit >> 5, sh = bit & 31;
        f.w[wi] |= v << sh;
        if (sh > 19 && wi + 1 < 8) f.w[wi + 1] |= v >> (32 - sh);
    }
    return f;
}

__device__ __forceinline__ void stage_g_table(Pt* g_s, const u32* g_table) {
    u32* dst = reinterpret_cast<u32*>(g_s);
    for (int i = threadIdx.x; i < 16 * 24; i += blockDim.x) dst[i] = g_table[i];
    __syncthreads();
}

constexpr int THREADS = 128;

// K2: e, r, s are (B, 32) big-endian bytes; kx, ky are (20, K) limbs of the
// distinct keys; key_idx (B,) picks a lane's key; a lane whose index is out
// of range is rejected.
extern "C" __global__ void __launch_bounds__(THREADS)
p256_verify_bytes(const uint8_t* __restrict__ e, const uint8_t* __restrict__ r,
                  const uint8_t* __restrict__ s, const long long* __restrict__ kx,
                  const long long* __restrict__ ky, const int* __restrict__ key_idx,
                  const uint8_t* __restrict__ valid_in, const u32* __restrict__ g_table,
                  uint8_t* __restrict__ out, int B, int K) {
    __shared__ Pt g_s[16];
    stage_g_table(g_s, g_table);
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    const int k = key_idx[lane];
    if (!valid_in[lane] || k < 0 || k >= K) {
        out[lane] = 0;
        return;
    }
    const Fe ew = fe_from_bytes(e + 32 * (long long)lane);
    const Fe rw = fe_from_bytes(r + 32 * (long long)lane);
    const Fe sw = fe_from_bytes(s + 32 * (long long)lane);
    const Fe qx = fe_from_limbs(kx + k, K);
    const Fe qy = fe_from_limbs(ky + k, K);
    out[lane] = verify_lane(ew, rw, sw, qx, qy, g_s) ? 1 : 0;
}

// K1: e, r, s, qx, qy are (20, B) limbs.
extern "C" __global__ void __launch_bounds__(THREADS)
p256_verify_limbs(const long long* __restrict__ e, const long long* __restrict__ r,
                  const long long* __restrict__ s, const long long* __restrict__ qx,
                  const long long* __restrict__ qy, const uint8_t* __restrict__ valid_in,
                  const u32* __restrict__ g_table, uint8_t* __restrict__ out, int B) {
    __shared__ Pt g_s[16];
    stage_g_table(g_s, g_table);
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    if (!valid_in[lane]) {
        out[lane] = 0;
        return;
    }
    const Fe ew = fe_from_limbs(e + lane, B);
    const Fe rw = fe_from_limbs(r + lane, B);
    const Fe sw = fe_from_limbs(s + lane, B);
    const Fe xw = fe_from_limbs(qx + lane, B);
    const Fe yw = fe_from_limbs(qy + lane, B);
    out[lane] = verify_lane(ew, rw, sw, xw, yw, g_s) ? 1 : 0;
}

extern "C" int p256_verify_bytes_launch(const void* e, const void* r, const void* s,
                                        const void* kx, const void* ky, const void* key_idx,
                                        const void* valid_in, const void* g_table, void* out,
                                        int B, int K, void* stream) {
    if (B > 0) {
        p256_verify_bytes<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)e, (const uint8_t*)r, (const uint8_t*)s, (const long long*)kx,
            (const long long*)ky, (const int*)key_idx, (const uint8_t*)valid_in,
            (const u32*)g_table, (uint8_t*)out, B, K);
    }
    return (int)cudaGetLastError();
}

extern "C" int p256_verify_limbs_launch(const void* e, const void* r, const void* s,
                                        const void* qx, const void* qy, const void* valid_in,
                                        const void* g_table, void* out, int B, void* stream) {
    if (B > 0) {
        p256_verify_limbs<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
            (const long long*)e, (const long long*)r, (const long long*)s, (const long long*)qx,
            (const long long*)qy, (const uint8_t*)valid_in, (const u32*)g_table, (uint8_t*)out,
            B);
    }
    return (int)cudaGetLastError();
}
