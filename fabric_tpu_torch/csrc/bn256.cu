// FP256BN kernels for Hopper (sm_90a): the Idemix batch's G1 multi-scalar
// multiply and its Ate2 pairing structure check, one thread a lane.
//
// Replaces, in the JAX package:
//   fabric_tpu/ops/bn256_kernel.py    msm_batch_device / msm_batch_jit (K3)
//                                                          -> bn256_msm
//   fabric_tpu/ops/pairing_kernel.py  _unity_check behind _shared_fn, with
//     the tower of fabric_tpu/ops/fp12.py (K4)              -> ate2_unity
// plus ate2_debug, which writes the values the test hook miller2_values
// returns (the two Miller values and the final-exponentiated value).
//
// Field. p is FP256BN's modulus, not a special form: 8 native 32-bit words,
// Montgomery with R = 2^256, CIOS with a generic reduction (m' = -p^-1 mod
// 2^32); every result fully reduced, so a value has one representation and
// the kernels agree word for word with the plain versions (13-bit limbs,
// R = 2^260) after the change of radix. The wrappers hand over the JAX
// package's Montgomery limbs (R = 2^260); a kernel reads them and multiplies
// by 2^252 (x * 2^260 * 2^252 / 2^256 = x * 2^256), and bn256_msm writes its
// result back the same way with 2^260.
//
// K3, bn256_msm. Per lane the sum of K scalar multiples, as the JAX program
// computes it: per-base tables {O, B, 2B, 3B} (2B = double(B), 3B = add(2B,
// B)) in local memory, then 128 windows of 2 bits, most significant first,
// each two doublings of the accumulator and K complete additions of a table
// entry (the identity for a zero digit). The point formulas are the
// complete Renes-Costello-Batina 2016 ones for a = 0 (algorithm 7 for
// addition, 9 for doubling, b3 = 9), so identity bases, zero scalars and
// equal points need no special case. The output is projective.
//
// K4, ate2_unity. Per lane both Miller loops in one pass over the 65 steps
// of |6u + 2| (an addition line where the has_add mask says so), with the
// line coefficients l(P) = A + B*px + py (py on row 0) read from the
// issuer's and the generator's schedules in global memory; conjugation
// (6u + 2 < 0), the two Frobenius correction lines, m = f1 * inv(f2); the
// final exponentiation as the host oracle computes it: conj(m) * inv(m),
// times its p^2 Frobenius, then square and multiply over the 768-bit hard
// part (408 ones). The Fp12 inverse is the norm chain down to one Fp
// inverse (Fermat, 4-bit fixed window). Fp12 = Fp2[w]/(w^6 - xi), xi = 1 + i,
// multiplied schoolbook in w with Karatsuba Fp2 products (36 of them; 21 for
// a square). A lane whose ok flag is false is rejected without arithmetic.
//
// Bound. Both kernels are bound by 32-bit integer multiply throughput
// (IMAD): a Montgomery multiply has 64 word products for a * b and 64 for
// q * p, and 8 32-bit low products, 2 * 128 + 8 = 264 IMAD issue slots.
// K3 lane with K bases: 3K + 3 multiplies for the radix change, K tables of
// one doubling (9 multiplies) and one addition (14), 128 windows of 2
// doublings and K additions: 16,851 multiplies at K = 8. The K3 bound
// counts each lane's real bases only (7,761 multiplies at the 3 bases of a
// t1 or t3 job, whatever the padding). K4 lane: 4 for the
// radix change; 65 steps of (square 63 + line 12 + multiply 108) for each
// loop, 22 addition steps of (line 12 + multiply 108) for each, 2 correction
// lines for each; 2 inverses of 585 (2 Fp12 multiplies, 9 Fp2 products, 4
// multiplies, Fermat 329) and 3 Fp12 multiplies and a Frobenius of 18 around
// them; the hard part 768 squares and 408 multiplies: 123,514 multiplies.
// That hard part is the replaced program's algorithm; the x-power chain
// computes the same value in 51,847 multiplies a lane
// (ops/pairing_kernel.IMAD_PER_LANE_XCHAIN), a lever not taken yet.
// The bytes are small beside that (K3 reads 8K * 60 + 8 * 60 bytes a lane;
// K4 reads 4 * 160 bytes a lane and the schedules once). PERF.md's bounds
// are computed from these counts (ops/bn256_kernel.muls_per_lane,
// ops/pairing_kernel.MULS_PER_LANE). Both kernels run one thread a lane in
// blocks of 32, so lanes spread over the SMs; at the Idemix batch's 64-768
// lanes they are latency bound, far from that bound.
//
// Interface: plain C, raw pointers, a cudaStream_t; each launcher returns
// cudaGetLastError().

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

struct Fp2 {
    Fe re, im;
};

// rows [c0.re, c0.im, c1.re, ..., c5.im]
struct Fp12 {
    Fe v[12];
};

constexpr u32 MINV = 0x0537E5E5u;  // -p^-1 mod 2^32

__device__ __forceinline__ u32 pw(int i) {
    constexpr u32 W[8] = {0xAED33013u, 0xD3292DDBu, 0x12980A82u, 0x0CDC65FBu,
                          0xEE71A49Fu, 0x46E5F25Eu, 0xFFFCF0CDu, 0xFFFFFFFFu};
    return W[i];
}

// R mod p (Montgomery one), 9R mod p (b3 = 3b), 2^252 and 2^260 mod p,
// p - 2, the hard part (p^4 - p^2 + 1) / r, gamma_{2,k} = xi^(k(p^2-1)/6)
// times R (all in Fp); little-endian words.
__constant__ u32 ONE[8] = {0x512CCFEDu, 0x2CD6D224u, 0xED67F57Du, 0xF3239A04u,
                           0x118E5B60u, 0xB91A0DA1u, 0x00030F32u, 0x00000000u};
__constant__ u32 B3M[8] = {0xDA934F55u, 0x938D6346u, 0x58A7A166u, 0x8C406A2Cu,
                           0x9E013668u, 0x81EA7AA9u, 0x001B88C8u, 0x00000000u};
__constant__ u32 C252[8] = {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
                            0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u};
__constant__ u32 C260[8] = {0x12CCFED0u, 0xCD6D2245u, 0xD67F57D2u, 0x3239A04Eu,
                            0x18E5B60Fu, 0x91A0DA11u, 0x0030F32Bu, 0x00000000u};
__constant__ u32 P_MINUS_2[8] = {0xAED33011u, 0xD3292DDBu, 0x12980A82u, 0x0CDC65FBu,
                                 0xEE71A49Fu, 0x46E5F25Eu, 0xFFFCF0CDu, 0xFFFFFFFFu};
constexpr int HARD_WORDS = 24;
constexpr int HARD_BITS = 768;
__constant__ u32 HARD[HARD_WORDS] = {
    0x1D2C770Du, 0x622DF289u, 0x5C1E5904u, 0x9F4876E4u, 0xB32231A8u, 0x135A5781u,
    0xFA6C2D59u, 0x9D796D1Bu, 0xAB5232DCu, 0x93291FB9u, 0x5ECEEC5Fu, 0x4578B6C9u,
    0x48E171C7u, 0xDF8760F0u, 0x30F50B57u, 0x97C0B4F7u, 0x0377A680u, 0xE170F689u,
    0xE007463Au, 0xC0A26366u, 0xDF9AE4ECu, 0xD4B1D738u, 0xFFF6D267u, 0xFFFFFFFFu};
__constant__ u32 GAMMA2[6][8] = {
    {0x512CCFEDu, 0x2CD6D224u, 0xED67F57Du, 0xF3239A04u, 0x118E5B60u, 0xB91A0DA1u,
     0x00030F32u, 0x00000000u},
    {0x2AD2A3E7u, 0x26E51DA3u, 0x1D732F01u, 0xE5F4FEF4u, 0x3952F4A6u, 0xFD19A437u,
     0xC3BD53CDu, 0xD999B78Du},
    {0xD9A5D3FAu, 0xFA0E4B7Eu, 0x300B3983u, 0xF2D164EFu, 0x27C49945u, 0x43FF9696u,
     0xC3BA449Bu, 0xD999B78Du},
    {0x5DA66026u, 0xA6525BB7u, 0x25301505u, 0x19B8CBF6u, 0xDCE3493Eu, 0x8DCBE4BDu,
     0xFFF9E19Au, 0xFFFFFFFFu},
    {0x84008C2Cu, 0xAC441038u, 0xF524DB81u, 0x26E76706u, 0xB51EAFF8u, 0x49CC4E27u,
     0x3C3F9CFFu, 0x26664872u},
    {0xD52D5C19u, 0xD91AE25Cu, 0xE28CD0FEu, 0x1A0B010Bu, 0xC6AD0B59u, 0x02E65BC8u,
     0x3C42AC32u, 0x26664872u}};

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

// t (9 words, t < 2p) -> t mod p.
__device__ __forceinline__ Fe reduce9(const u32 t[9]) {
    u32 d[8];
    u32 br = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        u64 x = (u64)t[j] - pw(j) - br;
        d[j] = (u32)x;
        br = (u32)(x >> 63);
    }
    const bool take = (t[8] != 0u) || (br == 0u);
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = take ? d[j] : t[j];
    return r;
}

// a < 2^256 < 2p -> a mod p.
__device__ __forceinline__ Fe reduce_once(const Fe& a) {
    u32 t[9];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = a.w[j];
    t[8] = 0u;
    return reduce9(t);
}

// a * b * 2^-256 mod p for a, b < p (CIOS; t stays below 2p).
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
        const u32 q = t[0] * MINV;
        c = (u64)q * pw(0) + t[0];
#pragma unroll
        for (int j = 1; j < 8; ++j) {
            c = (u64)q * pw(j) + t[j] + (c >> 32);
            t[j - 1] = (u32)c;
        }
        c = (u64)t[8] + (c >> 32);
        t[7] = (u32)c;
        t[8] = t[9] + (u32)(c >> 32);
    }
    return reduce9(t);
}

__device__ __forceinline__ Fe add_mod(const Fe& a, const Fe& b) {
    u32 t[9];
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        c = (u64)a.w[j] + b.w[j] + (c >> 32);
        t[j] = (u32)c;
    }
    t[8] = (u32)(c >> 32);
    return reduce9(t);
}

__device__ __forceinline__ Fe sub_mod(const Fe& a, const Fe& b) {
    Fe d;
    u32 br = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        u64 x = (u64)a.w[j] - b.w[j] - br;
        d.w[j] = (u32)x;
        br = (u32)(x >> 63);
    }
    const u32 mask = 0u - br;  // add p back on a borrow
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        c = (u64)d.w[j] + (pw(j) & mask) + (c >> 32);
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

#define FMUL mont_mul
#define FADD add_mod
#define FSUB sub_mod

// 20 canonical 13-bit limbs (limb l at p[l * stride]) -> words; bits at or
// above 2^256 are dropped.
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

__device__ __forceinline__ void fe_to_limbs(const Fe& f, long long* p, long long stride) {
#pragma unroll
    for (int l = 0; l < 20; ++l) {
        const int bit = 13 * l;
        const int wi = bit >> 5, sh = bit & 31;
        u32 v = f.w[wi] >> sh;
        if (sh > 19 && wi + 1 < 8) v |= f.w[wi + 1] << (32 - sh);
        p[l * stride] = (long long)(v & 0x1FFFu);
    }
}

// A Montgomery residue in the JAX package's limbs (R = 2^260) -> R = 2^256.
__device__ __forceinline__ Fe from_mont260(const long long* p, long long stride) {
    return FMUL(reduce_once(fe_from_limbs(p, stride)), fe_const(C252));
}

// ---------------------------------------------------------------------------
// K3: G1 points, RCB 2016 for a = 0
// ---------------------------------------------------------------------------

// Complete addition, algorithm 7. out may alias p or q.
__device__ __noinline__ void point_add(Pt& out, const Pt& p, const Pt& q) {
    const Fe x1 = p.x, y1 = p.y, z1 = p.z;
    const Fe x2 = q.x, y2 = q.y, z2 = q.z;
    const Fe b3 = fe_const(B3M);
    Fe t0, t1, t2, t3, t4, x3, y3, z3;
    t0 = FMUL(x1, x2);
    t1 = FMUL(y1, y2);
    t2 = FMUL(z1, z2);
    t3 = FADD(x1, y1);
    t4 = FADD(x2, y2);
    t3 = FMUL(t3, t4);
    t4 = FADD(t0, t1);
    t3 = FSUB(t3, t4);
    t4 = FADD(y1, z1);
    x3 = FADD(y2, z2);
    t4 = FMUL(t4, x3);
    x3 = FADD(t1, t2);
    t4 = FSUB(t4, x3);
    x3 = FADD(x1, z1);
    y3 = FADD(x2, z2);
    x3 = FMUL(x3, y3);
    y3 = FADD(t0, t2);
    y3 = FSUB(x3, y3);
    x3 = FADD(t0, t0);
    t0 = FADD(x3, t0);
    t2 = FMUL(b3, t2);
    z3 = FADD(t1, t2);
    t1 = FSUB(t1, t2);
    y3 = FMUL(b3, y3);
    x3 = FMUL(t4, y3);
    t2 = FMUL(t3, t1);
    x3 = FSUB(t2, x3);
    y3 = FMUL(y3, t0);
    t1 = FMUL(t1, z3);
    y3 = FADD(t1, y3);
    t0 = FMUL(t0, t3);
    z3 = FMUL(z3, t4);
    z3 = FADD(z3, t0);
    out.x = x3;
    out.y = y3;
    out.z = z3;
}

// Complete doubling, algorithm 9. out may alias p.
__device__ __noinline__ void point_double(Pt& out, const Pt& p) {
    const Fe x = p.x, y = p.y, z = p.z;
    const Fe b3 = fe_const(B3M);
    Fe t0, t1, t2, x3, y3, z3;
    t0 = FMUL(y, y);
    z3 = FADD(t0, t0);
    z3 = FADD(z3, z3);
    z3 = FADD(z3, z3);
    t1 = FMUL(y, z);
    t2 = FMUL(z, z);
    t2 = FMUL(b3, t2);
    x3 = FMUL(t2, z3);
    y3 = FADD(t0, t2);
    z3 = FMUL(t1, z3);
    t1 = FADD(t2, t2);
    t2 = FADD(t1, t2);
    t0 = FSUB(t0, t2);
    y3 = FMUL(t0, y3);
    y3 = FADD(x3, y3);
    t1 = FMUL(x, y);
    x3 = FMUL(t0, t1);
    x3 = FADD(x3, x3);
    out.x = x3;
    out.y = y3;
    out.z = z3;
}

constexpr int THREADS = 32;
constexpr int MSM_MAX_K = 16;

// bases (K, 3, 20, B) and the result (3, 20, B): projective Montgomery
// limbs (R = 2^260); scalars (K, 20, B) limbs of integers below 2^256.
extern "C" __global__ void __launch_bounds__(THREADS)
bn256_msm(const long long* __restrict__ bases, const long long* __restrict__ scalars,
          long long* __restrict__ out, int K, int B) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    const long long stride = B;
    Pt ident;
    ident.x = fe_zero();
    ident.y = fe_const(ONE);
    ident.z = fe_zero();
    Pt tab[MSM_MAX_K][4];
    Fe sc[MSM_MAX_K];
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
        const long long* b = bases + (long long)k * 60 * stride + lane;
        Pt p;
        p.x = from_mont260(b, stride);
        p.y = from_mont260(b + 20 * stride, stride);
        p.z = from_mont260(b + 40 * stride, stride);
        tab[k][0] = ident;
        tab[k][1] = p;
        point_double(tab[k][2], p);
        point_add(tab[k][3], tab[k][2], p);
        sc[k] = fe_from_limbs(scalars + (long long)k * 20 * stride + lane, stride);
    }
    Pt acc = ident;
#pragma unroll 1
    for (int w = 0; w < 128; ++w) {
        point_double(acc, acc);
        point_double(acc, acc);
        const int bit = 254 - 2 * w;
#pragma unroll 1
        for (int k = 0; k < K; ++k) {
            const u32 d = (sc[k].w[bit >> 5] >> (bit & 31)) & 3u;
            point_add(acc, acc, tab[k][d]);
        }
    }
    const Fe c260 = fe_const(C260);
    fe_to_limbs(FMUL(acc.x, c260), out + lane, stride);
    fe_to_limbs(FMUL(acc.y, c260), out + 20 * stride + lane, stride);
    fe_to_limbs(FMUL(acc.z, c260), out + 40 * stride + lane, stride);
}

extern "C" int bn256_msm_launch(const void* bases, const void* scalars, void* out, int K, int B,
                                void* stream) {
    if (K < 1 || K > MSM_MAX_K) return (int)cudaErrorInvalidValue;
    if (B > 0) {
        bn256_msm<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
            (const long long*)bases, (const long long*)scalars, (long long*)out, K, B);
    }
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4: the Fp2 / Fp12 tower
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fp2 fp2_at(const Fp12& f, int k) {
    Fp2 r;
    r.re = f.v[2 * k];
    r.im = f.v[2 * k + 1];
    return r;
}

__device__ __forceinline__ void fp2_put(Fp12& f, int k, const Fp2& x) {
    f.v[2 * k] = x.re;
    f.v[2 * k + 1] = x.im;
}

__device__ __forceinline__ Fp2 fp2_add(const Fp2& x, const Fp2& y) {
    Fp2 r;
    r.re = FADD(x.re, y.re);
    r.im = FADD(x.im, y.im);
    return r;
}

__device__ __forceinline__ Fp2 fp2_sub(const Fp2& x, const Fp2& y) {
    Fp2 r;
    r.re = FSUB(x.re, y.re);
    r.im = FSUB(x.im, y.im);
    return r;
}

// x * xi with xi = 1 + i: (re - im) + (re + im) i.
__device__ __forceinline__ Fp2 fp2_mul_xi(const Fp2& x) {
    Fp2 r;
    r.re = FSUB(x.re, x.im);
    r.im = FADD(x.re, x.im);
    return r;
}

// Karatsuba: 3 multiplies. out may alias x or y.
__device__ __noinline__ void fp2_mul(Fp2& out, const Fp2& x, const Fp2& y) {
    const Fe ac = FMUL(x.re, y.re);
    const Fe bd = FMUL(x.im, y.im);
    const Fe s = FMUL(FADD(x.re, x.im), FADD(y.re, y.im));
    out.re = FSUB(ac, bd);
    out.im = FSUB(FSUB(s, ac), bd);
}

__device__ __forceinline__ void fp12_one(Fp12& f) {
    f.v[0] = fe_const(ONE);
#pragma unroll 1
    for (int r = 1; r < 12; ++r) f.v[r] = fe_zero();
}

// acc[0..10] (Fp2 coefficients of w^0..w^10) -> out with w^6 = xi.
__device__ __forceinline__ void fp12_fold(Fp12& out, Fp2 acc[11]) {
#pragma unroll 1
    for (int k = 0; k < 5; ++k) fp2_put(out, k, fp2_add(acc[k], fp2_mul_xi(acc[k + 6])));
    fp2_put(out, 5, acc[5]);
}

// out = x * y (schoolbook in w, 36 Fp2 products). out may alias x or y.
__device__ __noinline__ void fp12_mul(Fp12& out, const Fp12& x, const Fp12& y) {
    Fp2 acc[11];
#pragma unroll 1
    for (int k = 0; k < 11; ++k) acc[k].re = acc[k].im = fe_zero();
#pragma unroll 1
    for (int i = 0; i < 6; ++i) {
        const Fp2 xi = fp2_at(x, i);
#pragma unroll 1
        for (int j = 0; j < 6; ++j) {
            Fp2 t;
            fp2_mul(t, xi, fp2_at(y, j));
            acc[i + j] = fp2_add(acc[i + j], t);
        }
    }
    fp12_fold(out, acc);
}

// out = x^2 (21 distinct Fp2 products, the off-diagonal ones doubled).
__device__ __noinline__ void fp12_sqr(Fp12& out, const Fp12& x) {
    Fp2 acc[11];
#pragma unroll 1
    for (int k = 0; k < 11; ++k) acc[k].re = acc[k].im = fe_zero();
#pragma unroll 1
    for (int i = 0; i < 6; ++i) {
        const Fp2 xi = fp2_at(x, i);
#pragma unroll 1
        for (int j = i; j < 6; ++j) {
            Fp2 t;
            fp2_mul(t, xi, fp2_at(x, j));
            if (j != i) t = fp2_add(t, t);
            acc[i + j] = fp2_add(acc[i + j], t);
        }
    }
    fp12_fold(out, acc);
}

// Negate the odd-w coefficients (x^(p^6)). out may alias x.
__device__ __forceinline__ void fp12_conj(Fp12& out, const Fp12& x) {
#pragma unroll 1
    for (int k = 0; k < 6; ++k) {
        if (k & 1) {
            out.v[2 * k] = FSUB(fe_zero(), x.v[2 * k]);
            out.v[2 * k + 1] = FSUB(fe_zero(), x.v[2 * k + 1]);
        } else {
            out.v[2 * k] = x.v[2 * k];
            out.v[2 * k + 1] = x.v[2 * k + 1];
        }
    }
}

// x^(p^2): coefficient k times gamma_{2,k}. out may alias x.
__device__ __noinline__ void fp12_frob2(Fp12& out, const Fp12& x) {
#pragma unroll 1
    for (int k = 0; k < 6; ++k) {
        Fp2 g;
        g.re = fe_const(GAMMA2[k]);
        g.im = fe_zero();
        Fp2 t;
        fp2_mul(t, fp2_at(x, k), g);
        fp2_put(out, k, t);
    }
}

__device__ __forceinline__ u32 nibble(const u32 words[8], int i) {
    return (words[i >> 3] >> (4 * (i & 7))) & 15u;
}

// x^(p-2) (Fermat, 4-bit fixed window, most significant first); 0 -> 0.
__device__ __noinline__ Fe fe_inv(const Fe& x) {
    Fe tab[16];
    tab[0] = fe_const(ONE);
    tab[1] = x;
#pragma unroll 1
    for (int k = 2; k < 16; ++k) tab[k] = FMUL(tab[k - 1], x);
    Fe acc = tab[nibble(P_MINUS_2, 63)];
#pragma unroll 1
    for (int i = 62; i >= 0; --i) {
#pragma unroll 1
        for (int k = 0; k < 4; ++k) acc = FMUL(acc, acc);
        acc = FMUL(acc, tab[nibble(P_MINUS_2, i)]);
    }
    return acc;
}

// conj(x) * (x * conj(x))^-1 (host fp12_inv / _fp6_inv / fp2_inv). out may
// alias x.
__device__ __noinline__ void fp12_inv(Fp12& out, const Fp12& x) {
    Fp12 xc, ac;
    fp12_conj(xc, x);
    fp12_mul(ac, x, xc);
    // Fp6 over v = w^2: (ac_0, ac_2, ac_4)
    const Fp2 a0 = fp2_at(ac, 0), a1 = fp2_at(ac, 2), a2 = fp2_at(ac, 4);
    Fp2 a0sq, a1sq, a2sq, a1a2, a0a1, a0a2;
    fp2_mul(a0sq, a0, a0);
    fp2_mul(a2sq, a2, a2);
    fp2_mul(a1sq, a1, a1);
    fp2_mul(a1a2, a1, a2);
    fp2_mul(a0a1, a0, a1);
    fp2_mul(a0a2, a0, a2);
    const Fp2 c0 = fp2_sub(a0sq, fp2_mul_xi(a1a2));
    const Fp2 c1 = fp2_sub(fp2_mul_xi(a2sq), a0a1);
    const Fp2 c2 = fp2_sub(a1sq, a0a2);
    Fp2 u, v, s;
    fp2_mul(u, a2, c1);
    fp2_mul(v, a1, c2);
    fp2_mul(s, a0, c0);
    const Fp2 t = fp2_add(fp2_mul_xi(fp2_add(u, v)), s);
    // fp2_inv: conj(t) / (re^2 + im^2)
    const Fe ninv = fe_inv(FADD(FMUL(t.re, t.re), FMUL(t.im, t.im)));
    Fp2 ti;
    ti.re = FMUL(t.re, ninv);
    ti.im = FSUB(fe_zero(), FMUL(t.im, ninv));
    Fp12 inv12;
#pragma unroll 1
    for (int r = 0; r < 12; ++r) inv12.v[r] = fe_zero();
    Fp2 e;
    fp2_mul(e, c0, ti);
    fp2_put(inv12, 0, e);
    fp2_mul(e, c1, ti);
    fp2_put(inv12, 2, e);
    fp2_mul(e, c2, ti);
    fp2_put(inv12, 4, e);
    fp12_mul(out, xc, inv12);
}

__device__ __forceinline__ bool fp12_is_one(const Fp12& f) {
    bool one = fe_eq(f.v[0], fe_const(ONE));
#pragma unroll 1
    for (int r = 1; r < 12; ++r) one = one && fe_eq(f.v[r], fe_zero());
    return one;
}

// ---------------------------------------------------------------------------
// K4: Miller loops and the final exponentiation
// ---------------------------------------------------------------------------

constexpr int ROW_WORDS = 12 * 8;  // one Fp12 coefficient row of a schedule

__device__ __forceinline__ Fe fe_load(const u32* p) {
    Fe f;
#pragma unroll
    for (int j = 0; j < 8; ++j) f.w[j] = p[j];
    return f;
}

// l = A + B * px + py (py on row 0), A and B rows ra and ra + 1 of `sched`.
__device__ __noinline__ void line_eval(Fp12& l, const u32* __restrict__ sched, int ra,
                                       const Fe& px, const Fe& py) {
    const u32* a = sched + (long long)ra * ROW_WORDS;
    const u32* b = a + ROW_WORDS;
#pragma unroll 1
    for (int r = 0; r < 12; ++r) {
        Fe v = FADD(fe_load(a + 8 * r), FMUL(fe_load(b + 8 * r), px));
        if (r == 0) v = FADD(v, py);
        l.v[r] = v;
    }
}

// f1 = Miller value of (W, P1), f2 of (g2, P2). A schedule holds 4S + 4
// rows: step s's doubling line at 2s, its addition line at 2S + 2s, the
// corrections at 4S and 4S + 2.
__device__ __noinline__ void miller2(Fp12& f1, Fp12& f2, const u32* __restrict__ sw,
                                     const u32* __restrict__ sg, const int* __restrict__ has_add,
                                     int S, const Fe& p1x, const Fe& p1y, const Fe& p2x,
                                     const Fe& p2y) {
    Fp12 l;
    fp12_one(f1);
    fp12_one(f2);
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
        fp12_sqr(f1, f1);
        line_eval(l, sw, 2 * s, p1x, p1y);
        fp12_mul(f1, f1, l);
        fp12_sqr(f2, f2);
        line_eval(l, sg, 2 * s, p2x, p2y);
        fp12_mul(f2, f2, l);
        if (has_add[s]) {
            line_eval(l, sw, 2 * S + 2 * s, p1x, p1y);
            fp12_mul(f1, f1, l);
            line_eval(l, sg, 2 * S + 2 * s, p2x, p2y);
            fp12_mul(f2, f2, l);
        }
    }
    fp12_conj(f1, f1);
    fp12_conj(f2, f2);
#pragma unroll 1
    for (int c = 0; c < 2; ++c) {
        line_eval(l, sw, 4 * S + 2 * c, p1x, p1y);
        fp12_mul(f1, f1, l);
        line_eval(l, sg, 4 * S + 2 * c, p2x, p2y);
        fp12_mul(f2, f2, l);
    }
}

// The host oracle's final_exp: easy part, then the hard power.
__device__ __noinline__ void final_exp(Fp12& out, const Fp12& m) {
    Fp12 a, b;
    fp12_conj(a, m);
    fp12_inv(b, m);
    fp12_mul(a, a, b);
    fp12_frob2(b, a);
    fp12_mul(a, b, a);
    fp12_one(out);
#pragma unroll 1
    for (int i = HARD_BITS - 1; i >= 0; --i) {
        fp12_sqr(out, out);
        if ((HARD[i >> 5] >> (i & 31)) & 1u) fp12_mul(out, out, a);
    }
}

// f1, f2 and fexp(f1 * inv(f2)) of one lane.
__device__ __noinline__ void ate2_lane(Fp12& f1, Fp12& f2, Fp12& fe, const u32* sw,
                                       const u32* sg, const int* has_add, int S,
                                       const long long* p1x, const long long* p1y,
                                       const long long* p2x, const long long* p2y, int lane,
                                       long long stride) {
    const Fe x1 = from_mont260(p1x + lane, stride);
    const Fe y1 = from_mont260(p1y + lane, stride);
    const Fe x2 = from_mont260(p2x + lane, stride);
    const Fe y2 = from_mont260(p2y + lane, stride);
    miller2(f1, f2, sw, sg, has_add, S, x1, y1, x2, y2);
    Fp12 m;
    fp12_inv(m, f2);
    fp12_mul(m, f1, m);
    final_exp(fe, m);
}

// sw, sg: the issuer's and the generator's schedules, (4S + 4, 12, 8)
// words with R = 2^256; has_add (S,); p1x..p2y (20, B) Montgomery limbs
// (R = 2^260) of A' and ABar; ok (B,); out (B,) the verdicts.
extern "C" __global__ void __launch_bounds__(THREADS)
ate2_unity(const u32* __restrict__ sw, const u32* __restrict__ sg,
           const int* __restrict__ has_add, int S, const long long* __restrict__ p1x,
           const long long* __restrict__ p1y, const long long* __restrict__ p2x,
           const long long* __restrict__ p2y, const uint8_t* __restrict__ ok,
           uint8_t* __restrict__ out, int B) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    if (!ok[lane]) {
        out[lane] = 0;
        return;
    }
    Fp12 f1, f2, fe;
    ate2_lane(f1, f2, fe, sw, sg, has_add, S, p1x, p1y, p2x, p2y, lane, B);
    out[lane] = fp12_is_one(fe) ? 1 : 0;
}

// The same lanes, every lane computed: vals (3, 12, 8, B) words of f1, f2
// and fexp(f1 * inv(f2)) (R = 2^256).
extern "C" __global__ void __launch_bounds__(THREADS)
ate2_debug(const u32* __restrict__ sw, const u32* __restrict__ sg,
           const int* __restrict__ has_add, int S, const long long* __restrict__ p1x,
           const long long* __restrict__ p1y, const long long* __restrict__ p2x,
           const long long* __restrict__ p2y, const uint8_t* __restrict__ ok,
           u32* __restrict__ vals, int B) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    Fp12 f[3];
    ate2_lane(f[0], f[1], f[2], sw, sg, has_add, S, p1x, p1y, p2x, p2y, lane, B);
    const long long stride = B;
#pragma unroll 1
    for (int k = 0; k < 3; ++k)
#pragma unroll 1
        for (int r = 0; r < 12; ++r)
#pragma unroll
            for (int j = 0; j < 8; ++j)
                vals[((k * 12 + r) * 8 + j) * stride + lane] = f[k].v[r].w[j];
}

extern "C" int ate2_unity_launch(const void* sw, const void* sg, const void* has_add, int S,
                                 const void* p1x, const void* p1y, const void* p2x,
                                 const void* p2y, const void* ok, void* out, int B,
                                 void* stream) {
    if (B > 0) {
        ate2_unity<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
            (const u32*)sw, (const u32*)sg, (const int*)has_add, S, (const long long*)p1x,
            (const long long*)p1y, (const long long*)p2x, (const long long*)p2y,
            (const uint8_t*)ok, (uint8_t*)out, B);
    }
    return (int)cudaGetLastError();
}

extern "C" int ate2_debug_launch(const void* sw, const void* sg, const void* has_add, int S,
                                 const void* p1x, const void* p1y, const void* p2x,
                                 const void* p2y, const void* ok, void* vals, int B,
                                 void* stream) {
    if (B > 0) {
        ate2_debug<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
            (const u32*)sw, (const u32*)sg, (const int*)has_add, S, (const long long*)p1x,
            (const long long*)p1y, (const long long*)p2x, (const long long*)p2y,
            (const uint8_t*)ok, (u32*)vals, B);
    }
    return (int)cudaGetLastError();
}
