// FP256BN kernels for Hopper (sm_90a): the Idemix batch's G1 multi-scalar
// multiply and its Ate2 pairing structure check, a group of threads a lane.
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
// What bounds them. At the Idemix batch's 64-768 lanes neither kernel comes
// near the card's multiply throughput: a lane is a chain of dependent
// Montgomery multiplies, so its time is that chain's latency. The design
// therefore spreads each lane over a group of threads of one warp, cuts the
// chain (and the work) with cheaper algorithms, and keeps values in
// registers and shared memory: no local-memory structs on the hot path.
// The operations (tower multiplies, point formulas) are __noinline__
// functions taking only indices, their operands in shared memory, so each
// exists once in the code; inside them every field operation is inlined.
//
// K3, bn256_msm. Per lane the sum of s_k * B_k over K bases, a lane a group
// of G threads (G the power of two at or above K, at most 32; 8 at the
// Idemix batch's K, 32 for a key of 13 to 28 attributes). Thread k
// multiplies bases k, k + G, ...: for each, a table {O, B, 2B, 3B} (2B =
// double(B), 3B = add(2B, B)) in its slice of shared memory, then 128
// windows of 2 bits, most significant first, each two doublings and one
// complete addition of a table entry (O for a zero digit); a thread's later
// bases (K > 32 only) run their windows apart and are added to its sum. A
// base that is the identity (Z = 0) or has a zero scalar contributes O and
// does no arithmetic, so the batch's t1 and t3 jobs (3 real bases padded to
// 8) pay for 3. The G partial sums are added by a shuffle tree of complete
// additions (log2 G levels). The formulas are the complete
// Renes-Costello-Batina 2016 ones for
// a = 0 (algorithm 7 for addition, 9 for doubling, b3 = 9), so the identity
// and equal points need no special case. The output is the same point as
// the plain version's, not the same projective words: the addition order
// differs, and so does the representative (X : Y : Z).
//
// K4, ate2_unity. Per lane fexp(f1 * conj(f2)) == 1, f1 the Miller value of
// (W, A') and f2 of (g2, ABar), a lane a group of 12 threads (two lanes a
// warp). The lane's Fp12 values live in shared memory (12 Fp rows of 8
// words); the threads synchronise with __syncwarp(mask) between operations.
//   Miller loops: two teams of six, one a loop, side by side over the 65
//     steps of |6u + 2| (an addition line where has_add says so), then
//     conjugation (6u + 2 < 0) and the two Frobenius correction lines.
//     Thread k of a team computes coefficient k of each product. Lines are
//     sparse: the untwist puts x at w^4 and y at w^3, so a line's A is
//     nonzero only at w^3 and its B only at w^5 (ops/pairing_kernel
//     .LineSchedule raises otherwise), and the wrapper hands over those four
//     Fp values a line. l(P) = py + A3 w^3 + (B5 px) w^5; f * l takes 8
//     multiplies a thread. A square takes four Fp2 products a thread: the
//     three odd coefficients have three, and their fourth product computes
//     the step's B5 * px for the next product.
//   m = f1 * conj(f2): conj(f2) = f2^(p^6), and fexp of a p^6-th power is
//     the inverse of fexp (r divides p^6 + 1), so the verdict and fexp(m)
//     are those of f1 * inv(f2), as the replaced program computes them.
//   Final exponentiation, all twelve threads on each operation: the easy
//     part conj(m) * inv(m), times its p^2 Frobenius (the inverse by the norm
//     chain down to one Fermat inverse on one thread, 4-bit fixed window);
//     the hard part (p^4 - p^2 + 1) / r = lam0 + lam1 p + lam2 p^2 + p^3 by
//     the x-power chain of the JAX package's crypto/hostbn.py: three
//     |u|-power chains and 10 more squares (all cyclotomic, Granger-Scott:
//     nine Fp2 squares, one a thread), 77 multiplies (three Fp2 products a
//     thread, two threads an output coefficient) and the p, p^2, p^3
//     Frobenius maps (one Fp row a thread).
// A lane whose ok flag is false is rejected without arithmetic.
//
// Bound. Both kernels are bound by 32-bit integer multiply throughput
// (IMAD) if by anything: a Montgomery multiply has 64 word products for
// a * b and 64 for q * p, and 8 32-bit low products, 2 * 128 + 8 = 264
// IMAD issue slots. The bound counts the least work known for the same
// function; the kernels run more, for a shorter chain.
//   K3 lane with k real bases of K: the kernel runs, for each real base, 3
//     multiplies for the radix change, a doubling (9) and an addition (14)
//     for the table and 128 windows of 2 doublings and an addition, then
//     K - G additions of threads' later bases (K > 32 only), G - 1
//     additions in the tree and 3 for the result's radix: 33,077
//     multiplies at k = K = 8, 12,467 at 3 of 8 (ops/bn256_kernel
//     .muls_per_lane). The longest thread's chain is 4,167 multiplies (its
//     base, three tree additions, the result). The least work shares one
//     accumulator's doublings among the bases: 16,851 and 7,761
//     (muls_least).
//   K4 live lane: the kernel runs 30,774 multiplies (ops/pairing_kernel
//     .MULS_PER_LANE: 4 for the radix change; each Miller loop 65 steps of
//     72 (the square and the step's line evaluations) and 89 lines of 48;
//     f1 * conj(f2) 108; the inverse 594; the easy part 2 multiplies and a
//     Frobenius (24); the hard part 196 cyclotomic squares (18), 77
//     multiplies and 3 Frobenius maps). A lane's chain is about 2,980
//     multiplies: 12 + 8 (+ 8) a Miller step, 9 a multiply, 2 a cyclotomic
//     square, and the 329 of the Fermat inverse. The least work, with
//     Karatsuba Fp12 multiplies (54), complex squares (36) and the other
//     operations at their least cost (pairing_kernel.LEAST), is 20,836;
//     the replaced program ran 123,514 (MULS_PER_LANE_REPLACED).
// The bytes are small beside that (K3 reads 8K * 60 + 8 * 60 bytes a
// lane; K4 reads 4 * 160 bytes a lane and the compact schedules once).
//
// Interface: plain C, raw pointers, a cudaStream_t; each launcher returns
// cudaGetLastError(). Defining BN256_KERNELS_ONLY leaves out the launchers
// and the CUDA runtime, so that the kernels can be compiled for the CPU
// under stand-ins for the CUDA constructs (tests/cuda_emu); such a build
// may also define FMUL, to count the Montgomery multiplies.

#include <cstdint>
#ifndef BN256_KERNELS_ONLY
#include <cuda_runtime.h>
#endif

typedef uint32_t u32;
typedef uint64_t u64;

struct __align__(16) Fe {
    u32 w[8];
};

struct Pt {
    Fe x, y, z;
};

struct Fp2 {
    Fe re, im;
};

constexpr u32 MINV = 0x0537E5E5u;  // -p^-1 mod 2^32

__device__ __forceinline__ u32 pw(int i) {
    constexpr u32 W[8] = {0xAED33013u, 0xD3292DDBu, 0x12980A82u, 0x0CDC65FBu,
                          0xEE71A49Fu, 0x46E5F25Eu, 0xFFFCF0CDu, 0xFFFFFFFFu};
    return W[i];
}

// R mod p (Montgomery one), 9R mod p (b3 = 3b), 2^252 and 2^260 mod p,
// p - 2 (all in Fp); little-endian words.
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

// |u| for the BN parameter u = -0x6882F5C030B0A801 (63 bits).
constexpr u64 U_ABS = 0x6882F5C030B0A801ull;
constexpr int U_TOP = 62;

// gamma_{n,k} = xi^(k(p^n - 1)/6) for n = 1, 2, 3 (common/fp256bn._FROB_GAMMA),
// [n - 1][k][re, im] times R; in global memory, since the threads of an
// operation read different k.
__device__ const u32 GAMMA[3][6][2][8] = {
    {{{0x512CCFEDu, 0x2CD6D224u, 0xED67F57Du, 0xF3239A04u, 0x118E5B60u, 0xB91A0DA1u,
       0x00030F32u, 0x00000000u},
      {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}},
     {{0x9F5752E0u, 0x77F4336Cu, 0x415EE3E9u, 0xE3BDB82Du, 0x47E2E741u, 0x1DB98D94u,
       0xC29F09A5u, 0x18511E53u},
      {0x0F7BDD33u, 0x5B34FA6Fu, 0xD1392699u, 0x291EADCDu, 0xA68EBD5Du, 0x292C64CAu,
       0x3D5DE728u, 0xE7AEE1ACu}},
     {{0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u},
      {0x84008C2Cu, 0xAC441038u, 0xF524DB81u, 0x26E76706u, 0xB51EAFF8u, 0x49CC4E27u,
       0x3C3F9CFFu, 0x26664872u}},
     {{0x589425D3u, 0x5EDCF655u, 0xCB8ED0C3u, 0x15149D62u, 0xD8B38DF6u, 0x1EDDC85Du,
       0x803FA480u, 0x90DB7F10u},
      {0x589425D3u, 0x5EDCF655u, 0xCB8ED0C3u, 0x15149D62u, 0xD8B38DF6u, 0x1EDDC85Du,
       0x803FA480u, 0x90DB7F10u}},
     {{0xD52D5C19u, 0xD91AE25Cu, 0xE28CD0FEu, 0x1A0B010Bu, 0xC6AD0B59u, 0x02E65BC8u,
       0x3C42AC32u, 0x26664872u},
      {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}},
     {{0xF7EB78B3u, 0xD6D129C1u, 0x0CEDB4ACu, 0xF8D25590u, 0x20967537u, 0x3C9755F2u,
       0x42DEAE25u, 0xA92C9D64u},
      {0xB6E7B760u, 0xFC580419u, 0x05AA55D5u, 0x140A106Bu, 0xCDDB2F67u, 0x0A4E9C6Cu,
       0xBD1E42A8u, 0x56D3629Bu}}},
    {{{0x512CCFEDu, 0x2CD6D224u, 0xED67F57Du, 0xF3239A04u, 0x118E5B60u, 0xB91A0DA1u,
       0x00030F32u, 0x00000000u},
      {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}},
     {{0x2AD2A3E7u, 0x26E51DA3u, 0x1D732F01u, 0xE5F4FEF4u, 0x3952F4A6u, 0xFD19A437u,
       0xC3BD53CDu, 0xD999B78Du},
      {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}},
     {{0xD9A5D3FAu, 0xFA0E4B7Eu, 0x300B3983u, 0xF2D164EFu, 0x27C49945u, 0x43FF9696u,
       0xC3BA449Bu, 0xD999B78Du},
      {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}},
     {{0x5DA66026u, 0xA6525BB7u, 0x25301505u, 0x19B8CBF6u, 0xDCE3493Eu, 0x8DCBE4BDu,
       0xFFF9E19Au, 0xFFFFFFFFu},
      {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}},
     {{0x84008C2Cu, 0xAC441038u, 0xF524DB81u, 0x26E76706u, 0xB51EAFF8u, 0x49CC4E27u,
       0x3C3F9CFFu, 0x26664872u},
      {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}},
     {{0xD52D5C19u, 0xD91AE25Cu, 0xE28CD0FEu, 0x1A0B010Bu, 0xC6AD0B59u, 0x02E65BC8u,
       0x3C42AC32u, 0x26664872u},
      {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}}},
    {{{0x512CCFEDu, 0x2CD6D224u, 0xED67F57Du, 0xF3239A04u, 0x118E5B60u, 0xB91A0DA1u,
       0x00030F32u, 0x00000000u},
      {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}},
     {{0x563F0A40u, 0x744C3786u, 0x470939BFu, 0xF7C7C898u, 0x15BE16A8u, 0x28082A01u,
       0x7FBD4C4Du, 0x6F2480EFu},
      {0x589425D3u, 0x5EDCF655u, 0xCB8ED0C3u, 0x15149D62u, 0xD8B38DF6u, 0x1EDDC85Du,
       0x803FA480u, 0x90DB7F10u}},
     {{0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u},
      {0x512CCFEDu, 0x2CD6D224u, 0xED67F57Du, 0xF3239A04u, 0x118E5B60u, 0xB91A0DA1u,
       0x00030F32u, 0x00000000u}},
     {{0x563F0A40u, 0x744C3786u, 0x470939BFu, 0xF7C7C898u, 0x15BE16A8u, 0x28082A01u,
       0x7FBD4C4Du, 0x6F2480EFu},
      {0x563F0A40u, 0x744C3786u, 0x470939BFu, 0xF7C7C898u, 0x15BE16A8u, 0x28082A01u,
       0x7FBD4C4Du, 0x6F2480EFu}},
     {{0x5DA66026u, 0xA6525BB7u, 0x25301505u, 0x19B8CBF6u, 0xDCE3493Eu, 0x8DCBE4BDu,
       0xFFF9E19Au, 0xFFFFFFFFu},
      {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}},
     {{0x589425D3u, 0x5EDCF655u, 0xCB8ED0C3u, 0x15149D62u, 0xD8B38DF6u, 0x1EDDC85Du,
       0x803FA480u, 0x90DB7F10u},
      {0x563F0A40u, 0x744C3786u, 0x470939BFu, 0xF7C7C898u, 0x15BE16A8u, 0x28082A01u,
       0x7FBD4C4Du, 0x6F2480EFu}}}};

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

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
    u32 acc = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc |= a.w[j];
    return acc == 0u;
}

__device__ __forceinline__ Fe fe_sel(bool c, const Fe& a, const Fe& b) {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = c ? a.w[j] : b.w[j];
    return r;
}

#ifndef FMUL
#define FMUL mont_mul
#endif
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

__device__ __forceinline__ Fe fe_load(const u32* p) {
    Fe f;
#pragma unroll
    for (int j = 0; j < 8; ++j) f.w[j] = p[j];
    return f;
}

// ---------------------------------------------------------------------------
// K3: G1 points, RCB 2016 for a = 0, a lane a group of G threads
// ---------------------------------------------------------------------------

constexpr int THREADS3 = 32;  // one warp a block: 32 / G lanes

// log2 G for K bases: the power of two at or above K, at most a warp.
inline int msm_log_g(int K) {
    int log_g = 0;
    while ((1 << log_g) < K && (1 << log_g) < THREADS3) ++log_g;
    return log_g;
}
constexpr int SLOT_ACC = 4;   // slots 0-3 hold the table {O, B, 2B, 3B}
constexpr int SLOT_TMP = 5;

// A thread's points and scalar; runtime indices (the digit, the scalar
// word) address shared memory, never a local array.
struct Msm3 {
    Pt pt[6];
    u32 sc[8];
};

__shared__ Msm3 g_msm[THREADS3];

// pt[d] = pt[a] + pt[b], complete addition (algorithm 7); d may be a or b.
__device__ __noinline__ void point_add(int d, int a, int b) {
    Msm3& m = g_msm[threadIdx.x];
    const Fe x1 = m.pt[a].x, y1 = m.pt[a].y, z1 = m.pt[a].z;
    const Fe x2 = m.pt[b].x, y2 = m.pt[b].y, z2 = m.pt[b].z;
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
    m.pt[d].x = x3;
    m.pt[d].y = y3;
    m.pt[d].z = z3;
}

// pt[d] = 2 pt[a], complete doubling (algorithm 9); d may be a.
__device__ __noinline__ void point_double(int d, int a) {
    Msm3& m = g_msm[threadIdx.x];
    const Fe x = m.pt[a].x, y = m.pt[a].y, z = m.pt[a].z;
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
    m.pt[d].x = x3;
    m.pt[d].y = y3;
    m.pt[d].z = z3;
}

__device__ __forceinline__ void point_set_identity(Pt& p) {
    p.x = fe_zero();
    p.y = fe_const(ONE);
    p.z = fe_zero();
}

// bases (K, 3, 20, B) and the result (3, 20, B): projective Montgomery
// limbs (R = 2^260); scalars (K, 20, B) limbs of integers below 2^256.
// G = 2^log_g threads a lane (msm_log_g).
extern "C" __global__ void __launch_bounds__(THREADS3)
bn256_msm(const long long* __restrict__ bases, const long long* __restrict__ scalars,
          long long* __restrict__ out, int K, int log_g, int B) {
    const int G = 1 << log_g;
    const int gid = blockIdx.x * THREADS3 + threadIdx.x;
    const int lane = gid >> log_g;
    const int k = gid & (G - 1);
    const long long stride = B;
    Msm3& m = g_msm[threadIdx.x];
    point_set_identity(m.pt[SLOT_ACC]);
#pragma unroll 1
    for (int kb = k; lane < B && kb < K; kb += G) {
        // the thread's first base sums into its accumulator, a later one
        // into SLOT_TMP, which is then added to it
        const int dst = kb == k ? SLOT_ACC : SLOT_TMP;
        point_set_identity(m.pt[dst]);
        const long long* b = bases + (long long)kb * 60 * stride + lane;
        const Fe z = reduce_once(fe_from_limbs(b + 40 * stride, stride));
        const Fe s = fe_from_limbs(scalars + (long long)kb * 20 * stride + lane, stride);
        if (!fe_is_zero(z) && !fe_is_zero(s)) {
            const Fe c252 = fe_const(C252);
            point_set_identity(m.pt[0]);
            m.pt[1].x = FMUL(reduce_once(fe_from_limbs(b, stride)), c252);
            m.pt[1].y = FMUL(reduce_once(fe_from_limbs(b + 20 * stride, stride)), c252);
            m.pt[1].z = FMUL(z, c252);
#pragma unroll
            for (int j = 0; j < 8; ++j) m.sc[j] = s.w[j];
            point_double(2, 1);
            point_add(3, 2, 1);
#pragma unroll 1
            for (int w = 0; w < 128; ++w) {
#pragma unroll 1
                for (int i = 0; i < 2; ++i) point_double(dst, dst);
                const int bit = 254 - 2 * w;
                point_add(dst, dst, (m.sc[bit >> 5] >> (bit & 31)) & 3u);
            }
        }
        if (dst == SLOT_TMP) point_add(SLOT_ACC, SLOT_ACC, SLOT_TMP);
    }
    // the group's partial sums by a shuffle tree; every thread of the warp
    // takes part in each shuffle
#pragma unroll 1
    for (int d = G >> 1; d >= 1; d >>= 1) {
        const Pt& acc = m.pt[SLOT_ACC];
        Pt& tmp = m.pt[SLOT_TMP];
#pragma unroll
        for (int w = 0; w < 8; ++w) {
            tmp.x.w[w] = __shfl_down_sync(0xFFFFFFFFu, acc.x.w[w], d, G);
            tmp.y.w[w] = __shfl_down_sync(0xFFFFFFFFu, acc.y.w[w], d, G);
            tmp.z.w[w] = __shfl_down_sync(0xFFFFFFFFu, acc.z.w[w], d, G);
        }
        if (k < d) point_add(SLOT_ACC, SLOT_ACC, SLOT_TMP);
    }
    if (lane < B && k == 0) {
        const Fe c260 = fe_const(C260);
        fe_to_limbs(FMUL(m.pt[SLOT_ACC].x, c260), out + lane, stride);
        fe_to_limbs(FMUL(m.pt[SLOT_ACC].y, c260), out + 20 * stride + lane, stride);
        fe_to_limbs(FMUL(m.pt[SLOT_ACC].z, c260), out + 40 * stride + lane, stride);
    }
}

// ---------------------------------------------------------------------------
// K4: Fp2 in registers
// ---------------------------------------------------------------------------

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

// Karatsuba: 3 multiplies.
__device__ __forceinline__ Fp2 fp2_mul(const Fp2& x, const Fp2& y) {
    const Fe ac = FMUL(x.re, y.re);
    const Fe bd = FMUL(x.im, y.im);
    const Fe s = FMUL(FADD(x.re, x.im), FADD(y.re, y.im));
    Fp2 r;
    r.re = FSUB(ac, bd);
    r.im = FSUB(FSUB(s, ac), bd);
    return r;
}

// (re + im)(re - im) + 2 re im i: 2 multiplies.
__device__ __forceinline__ Fp2 fp2_sqr(const Fp2& x) {
    Fp2 r;
    r.re = FMUL(FADD(x.re, x.im), FSUB(x.re, x.im));
    r.im = FMUL(FADD(x.re, x.re), x.im);
    return r;
}

__device__ __forceinline__ Fp2 fp2_neg_if(bool c, const Fp2& x) {
    Fp2 r;
    r.re = fe_sel(c, FSUB(fe_zero(), x.re), x.re);
    r.im = fe_sel(c, FSUB(fe_zero(), x.im), x.im);
    return r;
}

__device__ __forceinline__ Fp2 fp2_sel(bool c, const Fp2& a, const Fp2& b) {
    Fp2 r;
    r.re = fe_sel(c, a.re, b.re);
    r.im = fe_sel(c, a.im, b.im);
    return r;
}

__device__ __forceinline__ Fp2 fp2_zero() {
    Fp2 r;
    r.re = fe_zero();
    r.im = fe_zero();
    return r;
}

__device__ __forceinline__ Fp2 fp2_load(const u32* p) {
    Fp2 r;
    r.re = fe_load(p);
    r.im = fe_load(p + 8);
    return r;
}

// ---------------------------------------------------------------------------
// K4: a lane's values in shared memory, operations of its thread group
// ---------------------------------------------------------------------------

constexpr int GROUP4 = 12;  // threads a lane
constexpr int TEAM = 6;     // threads a Miller loop
constexpr int LANES4 = 2;   // lanes a block (24 of one warp's 32 threads)
constexpr int THREADS4 = 32;
constexpr int NSLOT = 12;
constexpr int LINE_WORDS = 32;  // a compact schedule line: A[6], A[7], B[10], B[11]
constexpr int CONJ_X = 1, CONJ_Y = 2;

// Fp12 value: rows [c0.re, c0.im, c1.re, ..., c5.im].
struct Lane4 {
    Fe v[NSLOT][12];
    Fe part[12];      // a multiply's partial sums, the inverse's Fp6 products
    Fe sq[18];        // a cyclotomic square's nine Fp2 squares; the inverse's chain
    Fe l5[2][2][2];   // [team][doubling or addition line] B5 * px
    Fe pxy[2][2];     // [team][px, py]
    Fe tab[16];       // the Fermat inverse's window
    u32 flag[GROUP4];
};

__shared__ Lane4 g_lane4[LANES4];

__device__ __forceinline__ Fp2 coeff(int g, int s, int c) {
    Fp2 r;
    r.re = g_lane4[g].v[s][2 * c];
    r.im = g_lane4[g].v[s][2 * c + 1];
    return r;
}

__device__ __forceinline__ void put_coeff(int g, int s, int c, const Fp2& x) {
    g_lane4[g].v[s][2 * c] = x.re;
    g_lane4[g].v[s][2 * c + 1] = x.im;
}

// The (i, j) Fp2 products of a square's coefficient k (code 8 i + j), and
// -1 for the slot in which an odd coefficient's thread computes B5 * px.
__constant__ int SQR_PAIRS[TEAM][4] = {{0 * 8 + 0, 1 * 8 + 5, 2 * 8 + 4, 3 * 8 + 3},
                                       {0 * 8 + 1, 2 * 8 + 5, 3 * 8 + 4, -1},
                                       {0 * 8 + 2, 1 * 8 + 1, 3 * 8 + 5, 4 * 8 + 4},
                                       {0 * 8 + 3, 1 * 8 + 2, 4 * 8 + 5, -1},
                                       {0 * 8 + 4, 1 * 8 + 3, 2 * 8 + 2, 5 * 8 + 5},
                                       {0 * 8 + 5, 1 * 8 + 4, 2 * 8 + 3, -1}};

// Miller phase, a team: slot dst = slot src squared, thread k computing
// coefficient k. In its fourth product thread 1 computes the doubling
// line's B5 * px (line ldbl) and thread 3 the addition line's (line ladd,
// when ladd >= 0); thread 5's is not kept.
__device__ __noinline__ void miller_sqr(int g, int team, int k, u32 mask, int dst, int src,
                                        const u32* __restrict__ sched, int ldbl, int ladd) {
    const int lk = (k == 3 && ladd >= 0) ? ladd : ldbl;
    const Fp2 lb = fp2_load(sched + (long long)lk * LINE_WORDS + 16);
    Fp2 px;
    px.re = g_lane4[g].pxy[team][0];
    px.im = fe_zero();
    Fp2 lo = fp2_zero(), hi = fp2_zero(), ln = fp2_zero();
#pragma unroll 1
    for (int n = 0; n < 4; ++n) {
        const int code = SQR_PAIRS[k][n];
        const bool line = code < 0;
        const int i = line ? 0 : code >> 3, j = line ? 0 : code & 7;
        const Fp2 p = fp2_mul(fp2_sel(line, lb, coeff(g, src, i)),
                              fp2_sel(line, px, coeff(g, src, j)));
        const Fp2 t = fp2_sel(i != j, fp2_add(p, p), p);
        const bool wrap = i + j >= TEAM;
        lo = fp2_sel(!line && !wrap, fp2_add(lo, t), lo);
        hi = fp2_sel(wrap, fp2_add(hi, t), hi);
        ln = fp2_sel(line, p, ln);
    }
    put_coeff(g, dst, k, fp2_add(lo, fp2_mul_xi(hi)));
    if (k == 1 || (k == 3 && ladd >= 0)) {
        g_lane4[g].l5[team][k == 3][0] = ln.re;
        g_lane4[g].l5[team][k == 3][1] = ln.im;
    }
    __syncwarp(mask);
}

// Miller phase, a team: slot dst = slot src (conjugated if conj) times the
// line l = py + A3 w^3 + l5 w^5, l5 = l5[team][which]; thread k:
// f_k py + f_(k-3) A3 + f_(k-5) l5, a negative index wrapping with xi.
__device__ __noinline__ void miller_line(int g, int team, int k, u32 mask, int dst, int src,
                                         const u32* __restrict__ sched, int line, int which,
                                         bool conj) {
    const Fe py = g_lane4[g].pxy[team][1];
    const int k3 = (k + 3) % TEAM, k5 = (k + 1) % TEAM;
    const Fp2 f0 = fp2_neg_if(conj && (k & 1), coeff(g, src, k));
    const Fp2 f3 = fp2_neg_if(conj && (k3 & 1), coeff(g, src, k3));
    const Fp2 f5 = fp2_neg_if(conj && (k5 & 1), coeff(g, src, k5));
    const Fp2 a3 = fp2_load(sched + (long long)line * LINE_WORDS);
    Fp2 l5;
    l5.re = g_lane4[g].l5[team][which][0];
    l5.im = g_lane4[g].l5[team][which][1];
    Fp2 r;
    r.re = FMUL(f0.re, py);
    r.im = FMUL(f0.im, py);
    const Fp2 t3 = fp2_mul(f3, a3);
    const Fp2 t5 = fp2_mul(f5, l5);
    r = fp2_add(r, fp2_sel(k < 3, fp2_mul_xi(t3), t3));
    r = fp2_add(r, fp2_sel(k < 5, fp2_mul_xi(t5), t5));
    put_coeff(g, dst, k, r);
    __syncwarp(mask);
}

// Miller phase, a team: thread 1 puts the correction line c0's B5 * px in
// l5[team][0], thread 3 line c1's in l5[team][1].
__device__ __noinline__ void miller_corr_l5(int g, int team, int k, u32 mask,
                                            const u32* __restrict__ sched, int c0, int c1) {
    const int line = k == 3 ? c1 : c0;
    const Fp2 b5 = fp2_load(sched + (long long)line * LINE_WORDS + 16);
    const Fe px = g_lane4[g].pxy[team][0];
    if (k == 1 || k == 3) {
        g_lane4[g].l5[team][k == 3][0] = FMUL(b5.re, px);
        g_lane4[g].l5[team][k == 3][1] = FMUL(b5.im, px);
    }
    __syncwarp(mask);
}

// Slot dst = x * y (conjugated as flags say), the 12 threads: thread j
// sums three of output coefficient j % 6's six products, i in
// {3 (j / 6), ..., 3 (j / 6) + 2}; the second half adds in through part.
// dst differs from x and y.
__device__ __noinline__ void mul12(int g, int j, u32 mask, int dst, int x, int y, int flags) {
    const int k = j % TEAM, h = j / TEAM;
    Fp2 lo = fp2_zero(), hi = fp2_zero();
#pragma unroll 1
    for (int t = 0; t < 3; ++t) {
        const int i = 3 * h + t, jj = (k - i + TEAM) % TEAM;
        const Fp2 a = fp2_neg_if((flags & CONJ_X) && (i & 1), coeff(g, x, i));
        const Fp2 b = fp2_neg_if((flags & CONJ_Y) && (jj & 1), coeff(g, y, jj));
        const Fp2 p = fp2_mul(a, b);
        lo = fp2_sel(i <= k, fp2_add(lo, p), lo);
        hi = fp2_sel(i > k, fp2_add(hi, p), hi);
    }
    const Fp2 r = fp2_add(lo, fp2_mul_xi(hi));
    if (h == 1) {
        g_lane4[g].part[2 * k] = r.re;
        g_lane4[g].part[2 * k + 1] = r.im;
    }
    __syncwarp(mask);
    if (h == 0) {
        Fp2 o;
        o.re = g_lane4[g].part[2 * k];
        o.im = g_lane4[g].part[2 * k + 1];
        put_coeff(g, dst, k, fp2_add(r, o));
    }
    __syncwarp(mask);
}

// Slot dst = x^2 for x in the cyclotomic subgroup (Granger-Scott 2010, as
// ops/fp12.cyc_sqr): x = a + b w + c w^2 over Fp4 = Fp2[s]/(s^2 - xi),
// s = w^3, a = (c0, c3), b = (c1, c4), c = (c2, c5);
//   x^2 = (3 a^2 - 2 conj(a)) + (3 s c^2 + 2 conj(b)) w + (3 b^2 - 2 conj(c)) w^2.
// Threads 0-8 take one of the nine Fp2 squares u^2, v^2, (u + v)^2 of the
// pairs (u, v) = (c_q, c_(q+3)); then thread j writes row j.
// q, A-type (3 t0 - 2 g) or B-type (3 t1 + 2 g), times xi, for each output
// coefficient.
__constant__ int CYC_Q[TEAM] = {0, 2, 1, 0, 2, 1};
__constant__ int CYC_B[TEAM] = {0, 1, 0, 1, 0, 1};
__constant__ int CYC_XI[TEAM] = {0, 1, 0, 0, 0, 0};

__device__ __noinline__ void cyc12(int g, int j, u32 mask, int dst, int x) {
    const int c = j >> 1;
    const Fe own = g_lane4[g].v[x][j];
    if (j < 9) {
        const int q = j / 3, which = j % 3;
        const Fp2 u = coeff(g, x, q), v = coeff(g, x, q + 3);
        const Fp2 s = fp2_sqr(which == 0 ? u : which == 1 ? v : fp2_add(u, v));
        g_lane4[g].sq[2 * j] = s.re;
        g_lane4[g].sq[2 * j + 1] = s.im;
    }
    __syncwarp(mask);
    const int q = CYC_Q[c];
    Fp2 s0, s1, s2;
    s0.re = g_lane4[g].sq[6 * q];
    s0.im = g_lane4[g].sq[6 * q + 1];
    s1.re = g_lane4[g].sq[6 * q + 2];
    s1.im = g_lane4[g].sq[6 * q + 3];
    s2.re = g_lane4[g].sq[6 * q + 4];
    s2.im = g_lane4[g].sq[6 * q + 5];
    const Fp2 t0 = fp2_add(s0, fp2_mul_xi(s1));
    Fp2 t1 = fp2_sub(fp2_sub(s2, s0), s1);
    t1 = fp2_sel(CYC_XI[c] != 0, fp2_mul_xi(t1), t1);
    const Fp2 t = fp2_sel(CYC_B[c] != 0, t1, t0);
    const Fe tj = (j & 1) ? t.im : t.re;
    const Fe t3 = FADD(FADD(tj, tj), tj);
    const Fe g2 = FADD(own, own);
    g_lane4[g].v[dst][j] = CYC_B[c] ? FADD(t3, g2) : FSUB(t3, g2);
    __syncwarp(mask);
}

// Slot dst = x^(p^n), n in {1, 2, 3}: coefficient c conjugated for odd n,
// times gamma_{n,c}; thread j computes row j.
__device__ __noinline__ void frob12(int g, int j, u32 mask, int dst, int x, int n) {
    const int c = j >> 1;
    const Fe re = g_lane4[g].v[x][2 * c];
    Fe im = g_lane4[g].v[x][2 * c + 1];
    if (n & 1) im = FSUB(fe_zero(), im);
    const Fe gr = fe_load(GAMMA[n - 1][c][0]), gi = fe_load(GAMMA[n - 1][c][1]);
    // re: re gr - im gi; im: re gi + im gr
    const Fe a = FMUL(re, (j & 1) ? gi : gr);
    const Fe b = FMUL(im, (j & 1) ? gr : gi);
    g_lane4[g].v[dst][j] = (j & 1) ? FADD(a, b) : FSUB(a, b);
    __syncwarp(mask);
}

// Slot dst = conj(x) (x^(p^6)).
__device__ __noinline__ void conj12(int g, int j, u32 mask, int dst, int x) {
    const Fe r = g_lane4[g].v[x][j];
    g_lane4[g].v[dst][j] = ((j >> 1) & 1) ? FSUB(fe_zero(), r) : r;
    __syncwarp(mask);
}

__device__ __forceinline__ u32 nibble(const u32 words[8], int i) {
    return (words[i >> 3] >> (4 * (i & 7))) & 15u;
}

// x^(p-2) (Fermat, 4-bit fixed window, most significant first, the window
// in shared memory); 0 -> 0. One thread.
__device__ __noinline__ Fe fe_inv(int g, const Fe& x) {
    Fe* tab = g_lane4[g].tab;
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

// The Fp6 chain of the inverse: the six products of a = (ac_0, ac_2, ac_4),
// thread j: ac_(2 INV_X[j]) * ac_(2 INV_Y[j]) -> a0^2, a2^2, a1^2, a1 a2,
// a0 a1, a0 a2.
__constant__ int INV_X[TEAM] = {0, 2, 1, 1, 0, 0};
__constant__ int INV_Y[TEAM] = {0, 2, 1, 2, 1, 2};

// Slot dst = x^-1 = conj(x) * (x conj(x))^-1 by the host's norm chain
// (common/fp256bn fp12_inv, _fp6_inv, fp2_inv); slots ac and iv are
// scratch. 0 -> 0.
__device__ __noinline__ void inv12(int g, int j, u32 mask, int dst, int x, int ac, int iv) {
    Lane4& L = g_lane4[g];
    mul12(g, j, mask, ac, x, x, CONJ_Y);  // x * conj(x), in Fp6 over w^2
    if (j < TEAM) {
        const Fp2 p = fp2_mul(coeff(g, ac, 2 * INV_X[j]), coeff(g, ac, 2 * INV_Y[j]));
        L.part[2 * j] = p.re;
        L.part[2 * j + 1] = p.im;
    }
    __syncwarp(mask);
    if (j < 3) {
        // thread 0: c1 = xi a2^2 - a0 a1, u = a2 c1; thread 1: c2 = a1^2 -
        // a0 a2, v = a1 c2; thread 2: c0 = a0^2 - xi a1 a2, s = a0 c0
        const int xs = j == 0 ? 1 : j == 1 ? 2 : 0, ys = j == 0 ? 4 : j == 1 ? 5 : 3;
        Fp2 px, py;
        px.re = L.part[2 * xs];
        px.im = L.part[2 * xs + 1];
        py.re = L.part[2 * ys];
        py.im = L.part[2 * ys + 1];
        px = fp2_sel(j == 0, fp2_mul_xi(px), px);
        py = fp2_sel(j == 2, fp2_mul_xi(py), py);
        const Fp2 cj = fp2_sub(px, py);
        const Fp2 p = fp2_mul(coeff(g, ac, 2 * (2 - j)), cj);
        const int ci = (j + 1) % 3;
        L.sq[2 * ci] = cj.re;
        L.sq[2 * ci + 1] = cj.im;
        L.sq[6 + 2 * j] = p.re;
        L.sq[6 + 2 * j + 1] = p.im;
    }
    __syncwarp(mask);
    if (j == 0) {
        Fp2 u, v, s;
        u.re = L.sq[6];
        u.im = L.sq[7];
        v.re = L.sq[8];
        v.im = L.sq[9];
        s.re = L.sq[10];
        s.im = L.sq[11];
        const Fp2 t = fp2_add(fp2_mul_xi(fp2_add(u, v)), s);
        // fp2_inv: conj(t) / (re^2 + im^2)
        const Fe ninv = fe_inv(g, FADD(FMUL(t.re, t.re), FMUL(t.im, t.im)));
        L.sq[12] = FMUL(t.re, ninv);
        L.sq[13] = FSUB(fe_zero(), FMUL(t.im, ninv));
    }
    __syncwarp(mask);
    if (j < TEAM) {
        Fp2 c, ti;
        c.re = L.sq[2 * (j >> 1)];
        c.im = L.sq[2 * (j >> 1) + 1];
        ti.re = L.sq[12];
        ti.im = L.sq[13];
        const Fp2 p = fp2_mul(c, ti);
        put_coeff(g, iv, j, fp2_sel(j & 1, fp2_zero(), p));
    }
    __syncwarp(mask);
    mul12(g, j, mask, dst, x, iv, CONJ_X);
}

// Slot dst = conj(x^|u|) = x^u for x in the cyclotomic subgroup; slots 0
// and 1 are scratch.
__device__ __noinline__ void pow_u(int g, int j, u32 mask, int dst, int x) {
    int cur = x;
#pragma unroll 1
    for (int i = U_TOP - 1; i >= 0; --i) {
        int nxt = cur == 0 ? 1 : 0;
        cyc12(g, j, mask, nxt, cur);
        cur = nxt;
        if ((U_ABS >> i) & 1u) {
            nxt = cur ^ 1;
            mul12(g, j, mask, nxt, cur, x, 0);
            cur = nxt;
        }
    }
    conj12(g, j, mask, dst, cur);
}

// The final exponentiation of slot m (slots 0-3 free) into slot 11: the
// easy part, then the hard part by the x-power chain (slot numbers in the
// comments' names: s 8, sx 9, sx2 10, sx3 11, x2s 2, c3 4, c3sq 5).
__device__ __forceinline__ void final_exp(int g, int j, u32 mask, int m) {
    inv12(g, j, mask, 7, m, 5, 6);
    mul12(g, j, mask, 5, m, 7, CONJ_X);  // conj(m) * inv(m)
    frob12(g, j, mask, 6, 5, 2);
    mul12(g, j, mask, 8, 6, 5, 0);  // s: the easy part
    pow_u(g, j, mask, 9, 8);        // sx
    pow_u(g, j, mask, 10, 9);       // sx2
    pow_u(g, j, mask, 11, 10);      // sx3
    cyc12(g, j, mask, 2, 9);        // x2s = sx^2
    cyc12(g, j, mask, 3, 10);
    mul12(g, j, mask, 4, 3, 10, 0);  // c3 = sx2^3
    cyc12(g, j, mask, 5, 4);         // c3sq
    cyc12(g, j, mask, 3, 11);
    cyc12(g, j, mask, 6, 3);
    mul12(g, j, mask, 7, 6, 3, 0);  // sx3^6
    mul12(g, j, mask, 6, 7, 4, 0);
    mul12(g, j, mask, 7, 6, 2, 0);  // a3 = sx3^6 c3 x2s
    cyc12(g, j, mask, 3, 7);
    cyc12(g, j, mask, 6, 3);
    mul12(g, j, mask, 9, 6, 3, 0);  // A = a3^6
    cyc12(g, j, mask, 6, 5);        // c3^4
    cyc12(g, j, mask, 3, 2);
    mul12(g, j, mask, 7, 3, 2, 0);  // x2s^3
    mul12(g, j, mask, 3, 6, 7, 0);
    cyc12(g, j, mask, 6, 8);        // s^2
    mul12(g, j, mask, 7, 3, 6, 0);  // B
    mul12(g, j, mask, 3, 9, 8, CONJ_X);           // y_l1 = conj(A) s
    mul12(g, j, mask, 6, 9, 7, CONJ_X | CONJ_Y);  // y_l0 = conj(A) conj(B)
    mul12(g, j, mask, 7, 5, 8, 0);                // y_l2 = c3sq s
    frob12(g, j, mask, 10, 3, 1);
    mul12(g, j, mask, 11, 6, 10, 0);
    frob12(g, j, mask, 10, 7, 2);
    mul12(g, j, mask, 6, 11, 10, 0);
    frob12(g, j, mask, 10, 8, 3);
    mul12(g, j, mask, 11, 6, 10, 0);
}

// One lane, thread j of its group g: the Miller values into slots
// f1 = cur and f2 = 2 + cur (returned: cur), f1 * conj(f2) in slot 4, the
// final exponentiation in slot 11. vals, when not null, gets f1, f2 and
// fexp (3, 12, 8, B).
__device__ __forceinline__ void ate2_lane(int g, int j, u32 mask, const u32* __restrict__ sw,
                                          const u32* __restrict__ sg,
                                          const int* __restrict__ has_add, int S,
                                          const long long* __restrict__ p1x,
                                          const long long* __restrict__ p1y,
                                          const long long* __restrict__ p2x,
                                          const long long* __restrict__ p2y, int lane, int B,
                                          u32* __restrict__ vals) {
    const int team = j / TEAM, k = j % TEAM;
    const u32* sched = team ? sg : sw;
    if (k < 2) {
        const long long* col = team ? (k ? p2y : p2x) : (k ? p1y : p1x);
        g_lane4[g].pxy[team][k] = from_mont260(col + lane, B);
    }
    Fp2 init = fp2_zero();
    if (k == 0) init.re = fe_const(ONE);
    put_coeff(g, 2 * team, k, init);
    __syncwarp(mask);
    int cur = 0;
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
        const bool add = has_add[s] != 0;
        miller_sqr(g, team, k, mask, 2 * team + 1 - cur, 2 * team + cur, sched, s,
                   add ? S + s : -1);
        cur ^= 1;
        miller_line(g, team, k, mask, 2 * team + 1 - cur, 2 * team + cur, sched, s, 0, false);
        cur ^= 1;
        if (add) {
            miller_line(g, team, k, mask, 2 * team + 1 - cur, 2 * team + cur, sched, S + s, 1,
                        false);
            cur ^= 1;
        }
    }
    miller_corr_l5(g, team, k, mask, sched, 2 * S, 2 * S + 1);
    miller_line(g, team, k, mask, 2 * team + 1 - cur, 2 * team + cur, sched, 2 * S, 0, true);
    cur ^= 1;
    miller_line(g, team, k, mask, 2 * team + 1 - cur, 2 * team + cur, sched, 2 * S + 1, 1,
                false);
    cur ^= 1;
    if (vals) {
#pragma unroll 1
        for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int w = 0; w < 8; ++w)
                vals[((f * 12 + j) * 8 + w) * (long long)B + lane] =
                    g_lane4[g].v[2 * f + cur][j].w[w];
    }
    mul12(g, j, mask, 4, cur, 2 + cur, CONJ_Y);  // m = f1 * conj(f2)
    final_exp(g, j, mask, 4);
    if (vals) {
#pragma unroll
        for (int w = 0; w < 8; ++w)
            vals[((2 * 12 + j) * 8 + w) * (long long)B + lane] = g_lane4[g].v[11][j].w[w];
    }
}

// sw, sg: the issuer's and the generator's compact schedules, (2S + 2, 4,
// 8) words with R = 2^256 (step s's doubling line at s, its addition line
// at S + s, the corrections at 2S and 2S + 1); has_add (S,); p1x..p2y
// (20, B) Montgomery limbs (R = 2^260) of A' and ABar; ok (B,); out (B,)
// the verdicts.
extern "C" __global__ void __launch_bounds__(THREADS4)
ate2_unity(const u32* __restrict__ sw, const u32* __restrict__ sg,
           const int* __restrict__ has_add, int S, const long long* __restrict__ p1x,
           const long long* __restrict__ p1y, const long long* __restrict__ p2x,
           const long long* __restrict__ p2y, const uint8_t* __restrict__ ok,
           uint8_t* __restrict__ out, int B) {
    const int g = threadIdx.x / GROUP4, j = threadIdx.x % GROUP4;
    const int lane = blockIdx.x * LANES4 + g;
    if (g >= LANES4 || lane >= B) return;
    if (!ok[lane]) {
        if (j == 0) out[lane] = 0;
        return;
    }
    const u32 mask = 0xFFFu << (GROUP4 * g);
    ate2_lane(g, j, mask, sw, sg, has_add, S, p1x, p1y, p2x, p2y, lane, B, nullptr);
    const Fe r = g_lane4[g].v[11][j];
    g_lane4[g].flag[j] = (j == 0 ? fe_eq(r, fe_const(ONE)) : fe_is_zero(r)) ? 1u : 0u;
    __syncwarp(mask);
    if (j == 0) {
        u32 all = 1u;
#pragma unroll 1
        for (int i = 0; i < GROUP4; ++i) all &= g_lane4[g].flag[i];
        out[lane] = (uint8_t)all;
    }
}

// The same lanes, every lane computed: vals (3, 12, 8, B) words of f1, f2
// and fexp(f1 * conj(f2)) (R = 2^256).
extern "C" __global__ void __launch_bounds__(THREADS4)
ate2_debug(const u32* __restrict__ sw, const u32* __restrict__ sg,
           const int* __restrict__ has_add, int S, const long long* __restrict__ p1x,
           const long long* __restrict__ p1y, const long long* __restrict__ p2x,
           const long long* __restrict__ p2y, const uint8_t* __restrict__ ok,
           u32* __restrict__ vals, int B) {
    const int g = threadIdx.x / GROUP4, j = threadIdx.x % GROUP4;
    const int lane = blockIdx.x * LANES4 + g;
    if (g >= LANES4 || lane >= B) return;
    ate2_lane(g, j, 0xFFFu << (GROUP4 * g), sw, sg, has_add, S, p1x, p1y, p2x, p2y, lane, B,
              vals);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

#ifndef BN256_KERNELS_ONLY

extern "C" int bn256_msm_launch(const void* bases, const void* scalars, void* out, int K, int B,
                                void* stream) {
    if (K < 1) return (int)cudaErrorInvalidValue;
    const int log_g = msm_log_g(K);
    if (B > 0) {
        const long long threads = (long long)B << log_g;
        bn256_msm<<<(unsigned)((threads + THREADS3 - 1) / THREADS3), THREADS3, 0,
                    (cudaStream_t)stream>>>((const long long*)bases, (const long long*)scalars,
                                            (long long*)out, K, log_g, B);
    }
    return (int)cudaGetLastError();
}

extern "C" int ate2_unity_launch(const void* sw, const void* sg, const void* has_add, int S,
                                 const void* p1x, const void* p1y, const void* p2x,
                                 const void* p2y, const void* ok, void* out, int B,
                                 void* stream) {
    if (B > 0) {
        ate2_unity<<<(B + LANES4 - 1) / LANES4, THREADS4, 0, (cudaStream_t)stream>>>(
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
        ate2_debug<<<(B + LANES4 - 1) / LANES4, THREADS4, 0, (cudaStream_t)stream>>>(
            (const u32*)sw, (const u32*)sg, (const int*)has_add, S, (const long long*)p1x,
            (const long long*)p1y, (const long long*)p2x, (const long long*)p2y,
            (const uint8_t*)ok, (u32*)vals, B);
    }
    return (int)cudaGetLastError();
}

#endif  // BN256_KERNELS_ONLY
