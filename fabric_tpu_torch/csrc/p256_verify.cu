// Batched ECDSA-P256 verification for Hopper (sm_90a): a lane is a group of
// eight threads, the generator's and each key's multiples come from shared
// fixed-base tables, and nothing lives on the stack.
//
// Replaces, in the JAX package:
//   fabric_tpu/ops/p256_kernel.py  verify_batch_device / verify_batch_jit
//     (K1: (20, B) 13-bit limb inputs)                  -> p256_verify_limbs
//   fabric_tpu/ops/p256_kernel.py  verify_batch_bytes_device /
//     verify_batch_bytes_jit with bytes_to_limbs_device
//     (K2: (B, 32) big-endian bytes, a distinct-key limb table and a per-lane
//     key index)                          -> p256_key_tables, p256_verify_bytes
//
// What bounds them. A verify is a chain of dependent Montgomery multiplies;
// at the block's 3,000 lanes the card's multiply throughput is far off and
// the time is the length of a lane's chain times a multiply's latency. The
// replaced design ran a lane on one thread (5,322 multiplies mod p and 332
// mod n in one chain, per-lane tables of Q on a 2,496-byte stack). This one
// cuts the chain and the work:
//
// Tables the lanes share. The comb of a point P is, for each of the 64
// four-bit windows w of a scalar and each digit d, the projective point
// d * 16^w * P (d = 0 the identity (0 : 1 : 0)): 64 x 16 x 3 x 8 words,
// 98,304 bytes. With it u * P is the sum of 64 table entries, no doubling.
//   G: built once on the host (ops/p256_kernel.g_comb_words), read through
//     the read-only cache; it stays in L2.
//   Q (K2): one comb per distinct key column, built on the card by
//     p256_key_tables (a block of four warps a key). The chain Q, 2Q, ...,
//     2^255 Q (the entries of digits 1, 2, 4, 8 of every window) cannot be
//     cut, so the kernel shortens each of its 255 doublings: warp 0 runs
//     algorithm 6 rearranged into two levels of products (8, then 6) with
//     W = b Z, 2X - W and 2W - X carried along, on plain field elements: a
//     product on a quad of threads (partial rows, a shuffle sum, and NIST's
//     reduction for p's special form: word sums, two carry chains, one
//     subtraction, where Montgomery's takes eight dependent steps), and the
//     additions between the levels as one small linear combination a lane
//     by the same word sums, the lanes side by side; no thread funnels the
//     others' work.
//     Warps 1-3 put a window's chain entries into Montgomery form and fill
//     its other eleven digits (12 complete additions in chains of at most
//     3) as soon as the chain has passed it, so only the last windows' fill
//     is left after the chain. Its stored words are the ones of algorithm 6
//     and of the additions key_tables_ref forms.
//     The provider keeps the tables of each key it has seen (by SKI), so a
//     key is built once, not once a batch.
//   Q (K1): every lane brings its own key, so u2 * Q stays a Horner ladder
//     over Q's 16 multiples (in shared memory), and u1's digits are added
//     into the same accumulator from window 0 of G's comb (d * G), which
//     shares the ladder's doublings.
// The additions are the complete Renes-Costello-Batina 2016 formulas for
// a = -3 (algorithm 4, 14 multiplies; doubling algorithm 6, 13), so the
// identity entries of zero digits, Q = G, u1 = u2 and u1 G = -u2 Q need no
// case of their own. Mixed additions with affine entries would save one
// multiply of 14 but need a branch-free select for the identity and an
// inversion per table entry; this design does not take them.
//
// A lane as a thread group (8 threads, 16 lanes a 128-thread block).
//   K2: thread j sums the 16 entries of windows j, j + 8, ..., j + 56 of both
//     combs (15 additions), and a shuffle tree of complete additions joins
//     the eight partial sums (7 additions in 3 levels). A lane's chain is
//     about 18 additions after the inverse.
//   K1: a team. Each formula is three levels of
//     independent multiplies (addition 6, 2, 6; doubling 6, 3, 4); thread k
//     of the team computes product k of a level from operands the team's
//     leader (thread 0) wrote to shared memory, and the leader does the
//     additions between levels. A formula's chain is three multiplies.
//
// The inverse. s^-1 mod n as s^(n-2) by an addition chain: x^(2^k - 1) for
// k = 2, 4, 8, 16, 32 (the ones of the top 128 bits of n - 2, which read
// ffffffff 00000000 ffffffff ffffffff), then a sliding window of width 4
// over the low 128 bits with the odd powers x, x^3, ..., x^15 (27 windows):
// 255 squarings and 40 multiplies, 295 in all (INV_CHAIN).
//   K2 runs it once a block: Montgomery's batch trick over the block's 16
//     lanes on warp 0, a product tree up (15 multiplies in 4 levels), the
//     chain at the root, the inverses down (2 a node, 30 in 4 levels): 340
//     multiplies a block for a chain of 303, where 16 lane-by-lane chains
//     would cost 16 x 295 issue slots of the warps that the point work
//     needs at the headline's size. A dead lane and s = 0 put 1 into the
//     tree; s = 0 gets w = 0, as 0^(n-2) is.
//   K1's leader runs it for its lane: the ladder, not the inverse, sets K1's
//     time.
// The lane's leader hands u1 = e w and u2 = r w to its group through shared
// memory.
//
// Field arithmetic. Elements are 8 native 32-bit words, Montgomery with
// R = 2^256, every result fully reduced (the JAX package uses 13-bit limbs
// and R = 2^260; only the verdict is observable). On the card the carry
// chains are inline PTX (mad.lo.cc / madc.hi.cc / addc); mod p the
// reduction is written for p's form: -p^-1 = 1 mod 2^32, so q = t0, and
// (t + q p) / 2^32 = t / 2^32 + q 2^64 + q 2^160 + q (2^32 - 1) 2^192, seven
// additions and no multiplier. Mod n is generic CIOS. Compiled for the CPU
// (P256_KERNELS_ONLY, tests/cuda_emu) the same functions use 64-bit C++
// arithmetic; the values are the same.
//
// Final check, projective: accept iff Z != 0 and X == r Z, or X == (r + n) Z
// when r < p - n; the result is AND-ed with the host's valid_in (lanes with
// valid_in false, or a key index out of range, skip the arithmetic).
//
// Bound. The kernels are bound by 32-bit integer multiply throughput, if by
// anything: a multiply mod p has 64 32x32->64 word products (two IMAD issue
// slots each), mod n 128 and 8 low products. Per live lane K2 runs 1,782
// multiplies mod p (8 threads x 15 additions, 7 in the tree, 4 in the check)
// and 3 mod n (s to Montgomery, u1, u2), and 340 mod n a block with a live
// lane; each key table 15,090 mod p (255 doublings of 14, 768 entry
// coordinates into Montgomery form, 64 x 12 additions), of which the
// chain's 3,570 set its time: 255 x 2 levels of products, each a quad's
// rows, shuffle sum and reduction.
// K1 runs 5,256 mod p (2, 14 additions for Q's multiples, one addition and
// 63 windows of 4 doublings and 2 additions, 4) and 298 mod n (1, 295, 2).
// The least work known for the function, from which PERF.md's bound_ms is
// counted, is in ops/p256_kernel.py beside these counts (KERNEL_*): Jacobian
// formulas for a = -3 and the widest combs the L2 holds (least_lane_mod_p,
// LEAST_*), with the combs' building left to the table kernel's own entry.
//
// Interface: plain C, raw pointers, a cudaStream_t; each launcher returns
// cudaGetLastError(). Limb inputs are int64, canonical 13-bit limbs of
// values below 2^256 (bits at or above 2^256 are ignored). Defining
// P256_KERNELS_ONLY leaves out the launchers and the CUDA runtime, so that
// the kernels compile for the CPU under stand-ins for the CUDA constructs
// (tests/cuda_emu); such a build may define FMUL and NMUL to count the
// multiplies mod p and mod n.

#include <cstdint>
#ifndef P256_KERNELS_ONLY
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

// R^2 mod p, R^2 mod n, R mod p and R mod n (Montgomery ones), b*R mod p,
// p - n, n; little-endian words.
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
// b itself (plain)
__constant__ u32 B_PLAIN[8] = {0x27D2604Bu, 0x3BCE3C3Eu, 0xCC53B0F6u, 0x651D06B0u,
                               0x769886BCu, 0xB3EBBD55u, 0xAA3A93E7u, 0x5AC635D8u};
__constant__ u32 P_MINUS_N[8] = {0x039CDAAEu, 0x0C46353Du, 0x58E8617Bu, 0x43190553u,
                                 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u};
__constant__ u32 N_WORDS[8] = {0xFC632551u, 0xF3B9CAC2u, 0xA7179E84u, 0xBCE6FAADu,
                               0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu};

// The inverse's chain after x^2 and the odd powers x^(2i+1) in slots 0-7:
// {squarings, slot to multiply by, slot to store the result in or -1}.
// Slots 8-11 hold x^(2^k - 1) for k = 4, 8, 16, 32 (slot 1, x^3, is k = 2).
constexpr int INV_STEPS = 33;
__constant__ signed char INV_CHAIN[INV_STEPS][3] = {
    {2, 1, 8}, {4, 8, 9}, {8, 9, 10}, {16, 10, 11}, {64, 11, -1}, {32, 11, -1},
    {4, 5, -1}, {2, 1, -1}, {5, 3, -1}, {6, 6, -1}, {4, 7, -1}, {4, 2, -1},
    {5, 5, -1}, {5, 6, -1}, {5, 3, -1}, {7, 5, -1}, {2, 1, -1}, {6, 7, -1},
    {2, 0, -1}, {8, 4, -1}, {3, 3, -1}, {5, 3, -1}, {4, 3, -1}, {5, 3, -1},
    {5, 2, -1}, {3, 1, -1}, {8, 5, -1}, {4, 7, -1}, {5, 1, -1}, {5, 1, -1},
    {6, 4, -1}, {4, 2, -1}, {6, 7, -1}};

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

// ---------------------------------------------------------------------------
// Carry chains: PTX on the card, 64-bit C++ elsewhere
// ---------------------------------------------------------------------------

#ifdef __CUDACC__
#define P256_PTX2(name, op)                                                   \
    __device__ __forceinline__ u32 name(u32 a, u32 b) {                       \
        u32 r;                                                                \
        asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));           \
        return r;                                                             \
    }
#define P256_PTX3(name, op)                                                   \
    __device__ __forceinline__ u32 name(u32 a, u32 b, u32 c) {                \
        u32 r;                                                                \
        asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
        return r;                                                             \
    }
P256_PTX2(add_cc, "add.cc.u32")
P256_PTX2(addc_cc, "addc.cc.u32")
P256_PTX2(addc, "addc.u32")
P256_PTX2(sub_cc, "sub.cc.u32")
P256_PTX2(subc_cc, "subc.cc.u32")
P256_PTX2(subc, "subc.u32")
P256_PTX3(madlo_cc, "mad.lo.cc.u32")
P256_PTX3(madclo_cc, "madc.lo.cc.u32")
P256_PTX3(madhi_cc, "mad.hi.cc.u32")
P256_PTX3(madchi_cc, "madc.hi.cc.u32")

// t[0..9] += a * bi (t[9] is 0 on entry).
__device__ __forceinline__ void mul_row(u32 t[10], const Fe& a, u32 bi) {
    t[0] = madlo_cc(a.w[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j] = madclo_cc(a.w[j], bi, t[j]);
    t[8] = addc_cc(t[8], 0u);
    t[9] = addc(0u, 0u);
    t[1] = madhi_cc(a.w[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j + 1] = madchi_cc(a.w[j], bi, t[j + 1]);
    t[9] = addc(t[9], 0u);
}
#endif

// t (9 words, t < 2m) -> t mod m.
template <class M>
__device__ __forceinline__ Fe reduce9(const u32 t[9]) {
    u32 d[8];
    bool take;
#ifdef __CUDACC__
    d[0] = sub_cc(t[0], M::w(0));
#pragma unroll
    for (int j = 1; j < 8; ++j) d[j] = subc_cc(t[j], M::w(j));
    take = subc(t[8], 0u) != 0xFFFFFFFFu;
#else
    u32 br = 0;
    for (int j = 0; j < 8; ++j) {
        const u64 x = (u64)t[j] - M::w(j) - br;
        d[j] = (u32)x;
        br = (u32)(x >> 63);
    }
    take = (t[8] != 0u) || (br == 0u);
#endif
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = take ? d[j] : t[j];
    return r;
}

#ifndef __CUDACC__
// a * b * 2^-256 mod m for a, b < m (CIOS; t stays below 2m).
template <class M>
inline Fe cios(const Fe& a, const Fe& b) {
    u32 t[10] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    for (int i = 0; i < 8; ++i) {
        u64 c = 0;
        for (int j = 0; j < 8; ++j) {
            c = (u64)a.w[j] * b.w[i] + t[j] + (c >> 32);
            t[j] = (u32)c;
        }
        c = (u64)t[8] + (c >> 32);
        t[8] = (u32)c;
        t[9] = (u32)(c >> 32);
        const u32 q = t[0] * M::minv;
        c = (u64)q * M::w(0) + t[0];
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
#endif

// a * b * 2^-256 mod p for a, b < p.
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
#ifdef __CUDACC__
    u32 t[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) t[j] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        mul_row(t, a, b.w[i]);
        // q = t0; (t + q p) / 2^32 = t / 2^32 + q 2^64 + q 2^160
        // + q (2^32 - 1) 2^192, the last as the words (lo, hi) at 6 and 7
        const u32 q = t[0];
        const u32 lo = 0u - q, hi = q - (q != 0u ? 1u : 0u);
        t[0] = t[1];
        t[1] = t[2];
        t[2] = add_cc(t[3], q);
        t[3] = addc_cc(t[4], 0u);
        t[4] = addc_cc(t[5], 0u);
        t[5] = addc_cc(t[6], q);
        t[6] = addc_cc(t[7], lo);
        t[7] = addc_cc(t[8], hi);
        t[8] = addc(t[9], 0u);
    }
    return reduce9<ModP>(t);
#else
    return cios<ModP>(a, b);
#endif
}

// a * b * 2^-256 mod n for a, b < n (CIOS).
__device__ __forceinline__ Fe mont_mul_n(const Fe& a, const Fe& b) {
#ifdef __CUDACC__
    u32 t[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) t[j] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        mul_row(t, a, b.w[i]);
        const u32 q = t[0] * ModN::minv;
        t[0] = madlo_cc(q, ModN::w(0), t[0]);
#pragma unroll
        for (int j = 1; j < 8; ++j) t[j] = madclo_cc(q, ModN::w(j), t[j]);
        t[8] = addc_cc(t[8], 0u);
        t[9] = addc(t[9], 0u);
        t[1] = madhi_cc(q, ModN::w(0), t[1]);
#pragma unroll
        for (int j = 1; j < 8; ++j) t[j + 1] = madchi_cc(q, ModN::w(j), t[j + 1]);
        t[9] = addc(t[9], 0u);
#pragma unroll
        for (int j = 0; j < 9; ++j) t[j] = t[j + 1];
    }
    return reduce9<ModN>(t);
#else
    return cios<ModN>(a, b);
#endif
}

// a + b mod m, a - b mod m, for a, b < m.
template <class M>
__device__ __forceinline__ Fe add_mod(const Fe& a, const Fe& b) {
    u32 t[9];
#ifdef __CUDACC__
    t[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j] = addc_cc(a.w[j], b.w[j]);
    t[8] = addc(0u, 0u);
#else
    u64 c = 0;
    for (int j = 0; j < 8; ++j) {
        c = (u64)a.w[j] + b.w[j] + (c >> 32);
        t[j] = (u32)c;
    }
    t[8] = (u32)(c >> 32);
#endif
    return reduce9<M>(t);
}

template <class M>
__device__ __forceinline__ Fe sub_mod(const Fe& a, const Fe& b) {
    Fe d;
#ifdef __CUDACC__
    d.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) d.w[j] = subc_cc(a.w[j], b.w[j]);
    const u32 mask = subc(0u, 0u);  // all ones on a borrow: add m back
    d.w[0] = add_cc(d.w[0], M::w(0) & mask);
#pragma unroll
    for (int j = 1; j < 7; ++j) d.w[j] = addc_cc(d.w[j], M::w(j) & mask);
    d.w[7] = addc(d.w[7], M::w(7) & mask);
#else
    u32 br = 0;
    for (int j = 0; j < 8; ++j) {
        const u64 x = (u64)a.w[j] - b.w[j] - br;
        d.w[j] = (u32)x;
        br = (u32)(x >> 63);
    }
    const u32 mask = 0u - br;
    u64 c = 0;
    for (int j = 0; j < 8; ++j) {
        c = (u64)d.w[j] + (M::w(j) & mask) + (c >> 32);
        d.w[j] = (u32)c;
    }
#endif
    return d;
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
        const u64 x = (u64)a.w[j] - b[j] - br;
        br = (u32)(x >> 63);
    }
    return br != 0u;
}

#ifndef FMUL
#define FMUL mont_mul
#endif
#ifndef NMUL
#define NMUL mont_mul_n
#endif
#define FADD add_mod<ModP>
#define FSUB sub_mod<ModP>

// ---------------------------------------------------------------------------
// Points
// ---------------------------------------------------------------------------

constexpr int TABLE_WORDS = 64 * 16 * 24;  // a comb: [window][digit][x, y, z][8]

__device__ __forceinline__ Pt pt_identity() {
    Pt r;
    r.x = fe_zero();
    r.y = fe_const(ONEP);
    r.z = fe_zero();
    return r;
}

#ifdef __CUDACC__
__device__ __forceinline__ void ld_fe(Fe& f, const uint4* v) {
    const uint4 a = __ldg(v), b = __ldg(v + 1);
    f.w[0] = a.x, f.w[1] = a.y, f.w[2] = a.z, f.w[3] = a.w;
    f.w[4] = b.x, f.w[5] = b.y, f.w[6] = b.z, f.w[7] = b.w;
}
#endif

__device__ __forceinline__ Pt load_pt(const u32* __restrict__ p) {
    Pt r;
#ifdef __CUDACC__
    const uint4* v = reinterpret_cast<const uint4*>(p);
    ld_fe(r.x, v);
    ld_fe(r.y, v + 2);
    ld_fe(r.z, v + 4);
#else
    for (int j = 0; j < 8; ++j) {
        r.x.w[j] = p[j];
        r.y.w[j] = p[8 + j];
        r.z.w[j] = p[16 + j];
    }
#endif
    return r;
}

__device__ __forceinline__ void store_pt(u32* p, const Pt& a) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        p[j] = a.x.w[j];
        p[8 + j] = a.y.w[j];
        p[16 + j] = a.z.w[j];
    }
}

// Complete addition, RCB 2016 algorithm 4 (a = -3), in registers.
__device__ __forceinline__ Pt pt_add(const Pt& p, const Pt& q) {
    const Fe bb = fe_const(BMONT);
    Fe t0, t1, t2, t3, t4, t5, x3, y3, z3;
    t0 = FMUL(p.x, q.x);
    t1 = FMUL(p.y, q.y);
    t2 = FMUL(p.z, q.z);
    t3 = FMUL(FADD(p.x, p.y), FADD(q.x, q.y));
    t3 = FSUB(t3, FADD(t0, t1));
    t4 = FMUL(FADD(p.y, p.z), FADD(q.y, q.z));
    t4 = FSUB(t4, FADD(t1, t2));
    x3 = FMUL(FADD(p.x, p.z), FADD(q.x, q.z));
    y3 = FSUB(x3, FADD(t0, t2));
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
    t5 = FMUL(x3, z3);
    Pt r;
    r.y = FADD(t5, t2);
    t5 = FMUL(t3, x3);
    r.x = FSUB(t5, t1);
    t5 = FMUL(t4, z3);
    t1 = FMUL(t3, t0);
    r.z = FADD(t5, t1);
    return r;
}

// ---------------------------------------------------------------------------
// A team: the independent multiplies of a formula's level spread over the
// threads of a lane (or a warp), the additions on the leader (thread 0)
// ---------------------------------------------------------------------------

struct Team {
    Fe op[6][2];
    Fe pr[6];
};

// Products 0..n-1 of the operand pairs the leader wrote; thread k computes
// product k. Every thread of the team calls it.
__device__ __forceinline__ void team_mul(Team& tm, int k, int n, u32 mask) {
    __syncwarp(mask);
    if (k < n) tm.pr[k] = FMUL(tm.op[k][0], tm.op[k][1]);
    __syncwarp(mask);
}

__device__ __forceinline__ void put(Team& tm, int i, const Fe& a, const Fe& b) {
    tm.op[i][0] = a;
    tm.op[i][1] = b;
}

// acc = acc + q (algorithm 4 in levels of 6, 2 and 6 multiplies); acc and q
// are the leader's.
__device__ __forceinline__ void team_add(Team& tm, int k, u32 mask, Pt& acc, const Pt& q) {
    Fe t0, t1, t2, t3, t4, x3, y3, z3;
    if (k == 0) {
        put(tm, 0, acc.x, q.x);
        put(tm, 1, acc.y, q.y);
        put(tm, 2, acc.z, q.z);
        put(tm, 3, FADD(acc.x, acc.y), FADD(q.x, q.y));
        put(tm, 4, FADD(acc.y, acc.z), FADD(q.y, q.z));
        put(tm, 5, FADD(acc.x, acc.z), FADD(q.x, q.z));
    }
    team_mul(tm, k, 6, mask);
    if (k == 0) {
        const Fe bb = fe_const(BMONT);
        t0 = tm.pr[0];
        t1 = tm.pr[1];
        t2 = tm.pr[2];
        t3 = FSUB(tm.pr[3], FADD(t0, t1));
        t4 = FSUB(tm.pr[4], FADD(t1, t2));
        y3 = FSUB(tm.pr[5], FADD(t0, t2));
        put(tm, 0, bb, t2);
        put(tm, 1, bb, y3);
    }
    team_mul(tm, k, 2, mask);
    if (k == 0) {
        z3 = tm.pr[0];
        x3 = FSUB(y3, z3);
        z3 = FADD(x3, x3);
        x3 = FADD(x3, z3);
        z3 = FSUB(t1, x3);
        x3 = FADD(t1, x3);
        y3 = tm.pr[1];
        t1 = FADD(t2, t2);
        t2 = FADD(t1, t2);
        y3 = FSUB(y3, t2);
        y3 = FSUB(y3, t0);
        t1 = FADD(y3, y3);
        y3 = FADD(t1, y3);
        t1 = FADD(t0, t0);
        t0 = FADD(t1, t0);
        t0 = FSUB(t0, t2);
        put(tm, 0, t4, y3);
        put(tm, 1, t0, y3);
        put(tm, 2, x3, z3);
        put(tm, 3, t3, x3);
        put(tm, 4, t4, z3);
        put(tm, 5, t3, t0);
    }
    team_mul(tm, k, 6, mask);
    if (k == 0) {
        acc.y = FADD(tm.pr[2], tm.pr[1]);
        acc.x = FSUB(tm.pr[3], tm.pr[0]);
        acc.z = FADD(tm.pr[4], tm.pr[5]);
    }
}

// acc = 2 acc (algorithm 6 in levels of 6, 3 and 4 multiplies).
__device__ __forceinline__ void team_double(Team& tm, int k, u32 mask, Pt& acc) {
    Fe t0, t1, t2, t3, yz2, x3, y3, z3, w;
    if (k == 0) {
        put(tm, 0, acc.x, acc.x);
        put(tm, 1, acc.y, acc.y);
        put(tm, 2, acc.z, acc.z);
        put(tm, 3, acc.x, acc.y);
        put(tm, 4, acc.x, acc.z);
        put(tm, 5, acc.y, acc.z);
    }
    team_mul(tm, k, 6, mask);
    if (k == 0) {
        const Fe bb = fe_const(BMONT);
        t0 = tm.pr[0];
        t1 = tm.pr[1];
        t2 = tm.pr[2];
        t3 = FADD(tm.pr[3], tm.pr[3]);
        z3 = FADD(tm.pr[4], tm.pr[4]);
        yz2 = FADD(tm.pr[5], tm.pr[5]);
        put(tm, 0, bb, t2);
        put(tm, 1, bb, z3);
        put(tm, 2, yz2, t1);
    }
    team_mul(tm, k, 3, mask);
    if (k == 0) {
        y3 = FSUB(tm.pr[0], z3);
        x3 = FADD(y3, y3);
        y3 = FADD(x3, y3);
        x3 = FSUB(t1, y3);
        y3 = FADD(t1, y3);
        w = tm.pr[2];
        t2 = FADD(t2, FADD(t2, t2));
        z3 = FSUB(FSUB(tm.pr[1], t2), t0);
        z3 = FADD(z3, FADD(z3, z3));
        t0 = FSUB(FADD(t0, FADD(t0, t0)), t2);
        put(tm, 0, x3, y3);
        put(tm, 1, x3, t3);
        put(tm, 2, t0, z3);
        put(tm, 3, yz2, z3);
    }
    team_mul(tm, k, 4, mask);
    if (k == 0) {
        acc.y = FADD(tm.pr[0], tm.pr[2]);
        acc.x = FSUB(tm.pr[1], tm.pr[3]);
        w = FADD(w, w);
        acc.z = FADD(w, w);
    }
}

// ---------------------------------------------------------------------------
// Scalars and the final check (a lane's leader)
// ---------------------------------------------------------------------------

// x^(n-2) mod n in the Montgomery domain; slots: 12 Fe of shared memory.
__device__ __forceinline__ Fe inv_mod_n(const Fe& x, Fe* slots) {
    const Fe x2 = NMUL(x, x);
    slots[0] = x;
#pragma unroll 1
    for (int i = 1; i < 8; ++i) slots[i] = NMUL(slots[i - 1], x2);
    Fe t = slots[1];
#pragma unroll 1
    for (int s = 0; s < INV_STEPS; ++s) {
#pragma unroll 1
        for (int q = 0; q < INV_CHAIN[s][0]; ++q) t = NMUL(t, t);
        t = NMUL(t, slots[INV_CHAIN[s][1]]);
        if (INV_CHAIN[s][2] >= 0) slots[INV_CHAIN[s][2]] = t;
    }
    return t;
}

// u1 = e / s, u2 = r / s mod n (plain integers; e, r, s below 2^256).
__device__ __forceinline__ void lane_scalars(const Fe& e, const Fe& r, const Fe& s, Fe* slots,
                                             Fe& u1, Fe& u2) {
    const Fe s_m = NMUL(reduce_once<ModN>(s), fe_const(R2N));
    const Fe w_m = inv_mod_n(s_m, slots);
    u1 = NMUL(reduce_once<ModN>(e), w_m);
    u2 = NMUL(reduce_once<ModN>(r), w_m);
}

// X == r Z, or X == (r + n) Z if r < p - n; and Z != 0.
__device__ __forceinline__ bool final_check(const Pt& acc, const Fe& r) {
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

__device__ __forceinline__ u32 nibble(const Fe& u, int i) {
    return (u.w[i >> 3] >> (4 * (i & 7))) & 15u;
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

// (x, y) limbs -> projective Montgomery (x R : y R : R).
__device__ __forceinline__ Pt key_point(const long long* x, const long long* y,
                                        long long stride) {
    Pt q;
    q.x = FMUL(reduce_once<ModP>(fe_from_limbs(x, stride)), fe_const(R2P));
    q.y = FMUL(reduce_once<ModP>(fe_from_limbs(y, stride)), fe_const(R2P));
    q.z = fe_const(ONEP);
    return q;
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

constexpr int GROUP = 8;                // threads a lane
constexpr int THREADS = 128;            // K1, K2: 16 lanes a block
constexpr int LANES = THREADS / GROUP;
// ---------------------------------------------------------------------------
// The key combs: the doubling chain on warp 0, its products by quads and its
// additions spread over lanes; the fill on warps 1-3 beside it
// ---------------------------------------------------------------------------

constexpr int TABLE_THREADS = 128;  // p256_key_tables: a block a key
constexpr unsigned FULL = 0xFFFFFFFFu;

#ifndef FMUL_COUNT
#define FMUL_COUNT() ((void)0)
#endif

// t[0..10] = a * (b0 + b1 2^32); t[10] is 0.
__device__ __forceinline__ void rows2(u32 t[11], const Fe& a, u32 b0, u32 b1) {
#pragma unroll
    for (int j = 0; j < 11; ++j) t[j] = 0u;
#ifdef __CUDACC__
    mul_row(t, a, b0);
    mul_row(t + 1, a, b1);
#else
    for (int i = 0; i < 2; ++i) {
        const u32 bi = i ? b1 : b0;
        u64 c = 0;
        for (int j = 0; j < 8; ++j) {
            c = (u64)a.w[j] * bi + t[i + j] + (c >> 32);
            t[i + j] = (u32)c;
        }
        c = (u64)t[i + 8] + (c >> 32);
        t[i + 8] = (u32)c;
        t[i + 9] += (u32)(c >> 32);
    }
#endif
}

// t[OFF..OFF+N) += u[0..N), the carry out of the last word dropped (the
// callers' sums fit).
template <int OFF, int N>
__device__ __forceinline__ void add_at(u32 t[16], const u32 u[N]) {
#ifdef __CUDACC__
    t[OFF] = add_cc(t[OFF], u[0]);
#pragma unroll
    for (int j = 1; j < N - 1; ++j) t[OFF + j] = addc_cc(t[OFF + j], u[j]);
    t[OFF + N - 1] = addc(t[OFF + N - 1], u[N - 1]);
#else
    u64 c = 0;
    for (int j = 0; j < N; ++j) {
        c = (u64)t[OFF + j] + u[j] + (c >> 32);
        t[OFF + j] = (u32)c;
    }
#endif
}

// Word sums (each below 2^40, word j at 32 j) -> 9 words: one carry chain
// over each sum's low word and the high part of the sum below it.
__device__ __forceinline__ void carry_words(const u64 acc[8], u32 out[9]) {
#ifdef __CUDACC__
    out[0] = (u32)acc[0];
    out[1] = add_cc((u32)acc[1], (u32)(acc[0] >> 32));
#pragma unroll
    for (int j = 2; j < 8; ++j) out[j] = addc_cc((u32)acc[j], (u32)(acc[j - 1] >> 32));
    out[8] = addc((u32)(acc[7] >> 32), 0u);
#else
    u64 c = acc[0] >> 32;
    out[0] = (u32)acc[0];
    for (int j = 1; j < 8; ++j) {
        c += (u32)acc[j];
        out[j] = (u32)c;
        c = (c >> 32) + (acc[j] >> 32);
    }
    out[8] = (u32)c;
#endif
}

// 33 p in redundant digits of at least 2^37 (words 0-7, nothing above):
// added to word sums of small signed multiples of 32-bit words, it keeps
// each sum positive.
__constant__ u64 BIAS_33P[8] = {0x20FFFFFFDFull, 0x20FFFFFFDFull, 0x20FFFFFFDFull,
                                0x2000000000ull, 0x20FFFFFFE0ull, 0x20FFFFFFDFull,
                                0x2000000000ull, 0x20FFFFFFBFull};

// Word sums acc (each positive, below 2^40; their value a multiple of p
// apart from the wanted one) -> the value mod p: carried into nine words
// S = L + h 2^256 (h < 2^8), then S - h p = L + h (2^256 - p), below 2p,
// carried again and reduced once.
__device__ __forceinline__ Fe fold_p(u64 acc[8]) {
    constexpr u32 CP[8] = {1u, 0u, 0u, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFEu, 0u};
    u32 t[9];
    carry_words(acc, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = (u64)t[j] + (u64)t[8] * CP[j];
    carry_words(acc, t);
    return reduce9<ModP>(t);
}

// (cx x + cy y + cz z) mod p for x, y, z < p and small signed constants
// whose negative ones sum to at most 15 in size, in about the time of two
// additions: each word's sum is formed apart, then folded (fold_p).
__device__ __forceinline__ Fe lincomb(const Fe& x, int cx, const Fe& y, int cy, const Fe& z,
                                      int cz) {
    u64 acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
        acc[j] = (u64)((long long)BIAS_33P[j] + (long long)cx * x.w[j] +
                       (long long)cy * y.w[j] + (long long)cz * z.w[j]);
    return fold_p(acc);
}

// t mod p for t < 2^512 (16 words) by p's special form (NIST's reduction
// for P-256): word j of the result is a small signed sum of t's words,
// each formed apart, then folded (fold_p).
__device__ __forceinline__ Fe reduce_p512(const u32 t[16]) {
    long long c[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) c[j] = t[j];
    u64 acc[8];
    acc[0] = (u64)((long long)BIAS_33P[0] + c[0] + c[8] + c[9] - c[11] - c[12] - c[13] - c[14]);
    acc[1] = (u64)((long long)BIAS_33P[1] + c[1] + c[9] + c[10] - c[12] - c[13] - c[14] - c[15]);
    acc[2] = (u64)((long long)BIAS_33P[2] + c[2] + c[10] + c[11] - c[13] - c[14] - c[15]);
    acc[3] = (u64)((long long)BIAS_33P[3] + c[3] + 2 * (c[11] + c[12]) + c[13] - c[8] - c[9] -
                   c[15]);
    acc[4] = (u64)((long long)BIAS_33P[4] + c[4] + 2 * (c[12] + c[13]) + c[14] - c[9] - c[10]);
    acc[5] = (u64)((long long)BIAS_33P[5] + c[5] + 2 * (c[13] + c[14]) + c[15] - c[10] - c[11]);
    acc[6] = (u64)((long long)BIAS_33P[6] + c[6] + c[13] + 3 * c[14] + 2 * c[15] - c[8] - c[9]);
    acc[7] = (u64)((long long)BIAS_33P[7] + c[7] + c[8] + 3 * c[15] - c[10] - c[11] - c[12] -
                   c[13]);
    return fold_p(acc);
}

// a * b mod p (plain, not Montgomery) by the four threads of a quad (r =
// lane & 3): thread r forms the 320-bit partial product a (b_2r + b_2r+1
// 2^32) (b0, b1), two shuffle levels sum the four into the 512-bit product,
// and p's special form reduces it (reduce_p512). The result is the one of
// the quad's thread 0. Every thread of the warp calls it (the shuffles take
// the full mask).
__device__ __forceinline__ Fe quad_mul(const Fe& a, u32 b0, u32 b1) {
    u32 row[11], t[16], o[12];
    rows2(row, a, b0, b1);
#pragma unroll
    for (int j = 0; j < 11; ++j) t[j] = row[j];
#pragma unroll
    for (int j = 11; j < 16; ++j) t[j] = 0u;
    // thread r + 1's partial product, two words up: r even holds r, r + 1
#pragma unroll
    for (int j = 0; j < 10; ++j) o[j] = __shfl_down_sync(FULL, row[j], 1, 4);
    add_at<2, 10>(t, o);
    // thread r + 2's pair, four words up: thread 0 holds the product
#pragma unroll
    for (int j = 0; j < 12; ++j) o[j] = __shfl_down_sync(FULL, t[j], 2, 4);
    add_at<4, 12>(t, o);
    return reduce_p512(t);
}

// The chain's values in shared memory, by slot: the current point X, Y, Z,
// W = b Z, U = 2X - W and V = 2W - X; the first level's products s0..s7;
// A, B, C, D, 2 s3, 2 s4 and 8 s1; the second level's p0..p3 (its other
// two products are the next Z and W); zero.
enum { SX, SY, SZ, SW, SU, SV, SS = 6, SA = 14, SB, SC, SD, S2S3, S2S4, S8S1, SP = 21,
       SZERO = 25, NSLOTS };

// Operand slots of quad k (byte k) for the two levels, and where the
// second level's products go.
constexpr u64 slots8(int s0, int s1, int s2, int s3, int s4, int s5, int s6, int s7) {
    return (u64)s0 | (u64)s1 << 8 | (u64)s2 << 16 | (u64)s3 << 24 | (u64)s4 << 32 |
           (u64)s5 << 40 | (u64)s6 << 48 | (u64)s7 << 56;
}
constexpr u64 L1_A = slots8(SX, SY, SZ, SX, SY, SY, SU, SV);
constexpr u64 L1_B = slots8(SX, SY, SZ, SY, SZ, SW, SZ, SX);
constexpr u64 L2_A = slots8(SA, SA, SC, S2S4, SS + 4, SS + 5, SZERO, SZERO);
constexpr u64 L2_B = slots8(SB, S2S3, SD, SD, S8S1, S8S1, SZERO, SZERO);
constexpr u64 L2_OUT = slots8(SP, SP + 1, SP + 2, SP + 3, SZ, SW, SZERO, SZERO);
constexpr u64 MID_OUT = slots8(SA, SB, SC, SD, S2S3, S2S4, S8S1, SZERO);
constexpr u64 POINT_OUT = slots8(SX, SY, SU, SV, SZERO, SZERO, SZERO, SZERO);

__device__ __forceinline__ int slot_of(u64 table, int k) { return (int)(table >> (8 * k)) & 0xFF; }

// A lane's linear combination: three slots and their constants (5 bits
// each, the constants biased by 16).
constexpr u32 lc(int sx, int cx, int sy = SZERO, int cy = 0, int sz = SZERO, int cz = 0) {
    return (u32)sx | (u32)(cx + 16) << 5 | (u32)sy << 10 | (u32)(cy + 16) << 15 |
           (u32)sz << 20 | (u32)(cz + 16) << 25;
}
// A = s1 + 3 s6, B = s1 - 3 s6, C = 3 s0 - 3 s2, D = 3 s7 - 9 s2, 2 s3,
// 2 s4, 8 s1 (lanes 0-6)
__constant__ u32 MID_LC[8] = {lc(SS + 1, 1, SS + 6, 3), lc(SS + 1, 1, SS + 6, -3),
                              lc(SS + 0, 3, SS + 2, -3), lc(SS + 7, 3, SS + 2, -9),
                              lc(SS + 3, 2), lc(SS + 4, 2), lc(SS + 1, 8), lc(SZERO, 0)};
// X' = p1 - p3, Y' = p0 + p2, U' = 2 p1 - 2 p3 - W', V' = -p1 + p3 + 2 W'
// (lanes 0-3)
__constant__ u32 POINT_LC[4] = {lc(SP + 1, 1, SP + 3, -1), lc(SP + 0, 1, SP + 2, 1),
                                lc(SP + 1, 2, SP + 3, -2, SW, -1),
                                lc(SP + 1, -1, SP + 3, 1, SW, 2)};

__device__ __forceinline__ Fe run_lc(const Fe* f, u32 c) {
    return lincomb(f[c & 31u], (int)((c >> 5) & 31u) - 16, f[(c >> 10) & 31u],
                   (int)((c >> 15) & 31u) - 16, f[(c >> 20) & 31u], (int)((c >> 25) & 31u) - 16);
}

struct Chain {
    Pt pts[256];      // 2^i Q: digit 2^(i % 4) of window i / 4
    Fe f[NSLOTS];
    int ready;        // windows whose four chain entries are stored
};

// The doubling 2 (X : Y : Z), equal as a point representation to RCB 2016
// algorithm 6 (a = -3), on plain field elements (the fill puts the chain's
// entries into Montgomery form), in two levels of products, W = b Z,
// U = 2X - W and V = 2W - X carried along:
//   s0..s7 = X^2, Y^2, Z^2, X Y, Y Z, Y W, U Z, V X;
//   A = s1 + 3 s6, B = s1 - 3 s6, C = 3 (s0 - s2), D = 3 (s7 - 3 s2);
//   p0..p5 = A B, A (2 s3), C D, (2 s4) D, s4 (8 s1), s5 (8 s1);
//   X' = p1 - p3, Y' = p0 + p2, Z' = p4, W' = p5 (= b Z'),
//   U' = 2X' - W', V' = 2W' - X'.
// (Algorithm 6's 3 (b Z^2 - 2 X Z) is -3 s6, its 3 (2 b X Z - 3 Z^2 - X^2)
// is D, its 2 X Y and 2 Y Z times A and D give X'.) Quad k computes product
// k of a level; between the levels lanes 0-6 each form one linear
// combination (MID_LC), after the second lanes 0-3 (POINT_LC), by one code
// path (lincomb), so that the lanes run side by side. Every thread of warp
// 0 calls it; the new point is in f and pts[i]. With split, lane 0 writes
// clock64 at the start and after each of the four steps.
__device__ __forceinline__ void chain_double(Chain& ch, int i, int lane, u32 mid, u32 point,
                                             long long* split) {
    Fe* f = ch.f;
    if (split && lane == 0) split[0] = clock64();
    const int k = lane >> 2, r4 = lane & 3;
    // level 1
    {
        const Fe& a = f[slot_of(L1_A, k)];
        const Fe& b = f[slot_of(L1_B, k)];
        const Fe prod = quad_mul(a, b.w[2 * r4], b.w[2 * r4 + 1]);
        if (r4 == 0) {
            FMUL_COUNT();
            f[SS + k] = prod;
        }
    }
    __syncwarp(FULL);
    if (split && lane == 0) split[1] = clock64();
    {
        const Fe r = run_lc(f, mid);
        if (lane < 7) f[slot_of(MID_OUT, lane)] = r;
    }
    __syncwarp(FULL);
    if (split && lane == 0) split[2] = clock64();
    // level 2 (quads 6 and 7 multiply zeros)
    {
        const Fe& a = f[slot_of(L2_A, k)];
        const Fe& b = f[slot_of(L2_B, k)];
        const Fe prod = quad_mul(a, b.w[2 * r4], b.w[2 * r4 + 1]);
        if (r4 == 0 && k < 6) {
            FMUL_COUNT();
            f[slot_of(L2_OUT, k)] = prod;
            if (k == 4) ch.pts[i].z = prod;
        }
    }
    __syncwarp(FULL);
    if (split && lane == 0) split[3] = clock64();
    {
        const Fe r = run_lc(f, point);
        if (lane < 4) f[slot_of(POINT_OUT, lane)] = r;
        if (lane == 0) ch.pts[i].x = r;
        if (lane == 1) ch.pts[i].y = r;
    }
    __syncwarp(FULL);
    if (split && lane == 0) split[4] = clock64();
}

// A flag between the chain's warp and the fill's warps.
__device__ __forceinline__ void publish(int* flag, int v) {
#ifdef __CUDACC__
    __threadfence_block();
    *(volatile int*)flag = v;
#else
    __atomic_store_n(flag, v, __ATOMIC_RELEASE);
#endif
}

__device__ __forceinline__ int observe(int* flag) {
#ifdef __CUDACC__
    const int v = *(volatile int*)flag;
    __threadfence_block();
    return v;
#else
    return __atomic_load_n(flag, __ATOMIC_ACQUIRE);
#endif
}

// The fill's jobs, 7 a window, each a chain of complete additions from a
// chain entry, every sum the one key_tables_ref forms (a digit's bits
// added lowest first to the lowest): nibbles of FILL_JOB[j] are the start
// bit, then for each step the bit added and the digit stored (0: none).
//   3, 7, 15 | 5, 13 | 6, 14 | 9 | 10 | 12 | (3), 11
constexpr int FILL_JOBS = 7;
constexpr int FILL_STEPS = 3;
constexpr int GROUP_WINDOWS = 4;  // a fill warp's windows at a time
__constant__ u32 FILL_JOB[FILL_JOBS] = {
    0x0F372310u, 0x000D3520u, 0x000E3621u, 0x00000930u, 0x00000A31u, 0x00000C32u, 0x000B3010u};

// The comb of each key column: kx, ky (20, K) limbs -> tables (K, 64, 16,
// 3, 8) words. A block a key: warp 0 runs the chain 2^i Q (i = 0..255,
// digit 2^(i % 4) of window i / 4) into shared memory and counts the
// windows done; warps 1-3 each take four windows at a time once the chain
// has passed them, put its entries into Montgomery form, store their
// digits 0, 1, 2, 4 and 8 and add the other eleven (lanes 0-27: seven jobs
// a window; lanes 28-31: the copies). With
// stamps, the block writes clock64 into stamps[STAMPS b ..]: at its start,
// at the chain's end, (the latest of the fill warps') at the fill's end,
// and at the start of doubling 128 and after each of its four steps.
constexpr int STAMPS = 8;
extern "C" __global__ void __launch_bounds__(TABLE_THREADS, 1)
p256_key_tables(const long long* __restrict__ kx, const long long* __restrict__ ky,
                u32* __restrict__ tables, int K, long long* __restrict__ stamps) {
    __shared__ Chain ch;
    u32* tab = tables + (long long)blockIdx.x * TABLE_WORDS;
    long long* stamp = stamps ? stamps + STAMPS * blockIdx.x : nullptr;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) ch.ready = 0;
    __syncthreads();
    if (warp == 0) {
        if (stamp && lane == 0) stamp[0] = clock64();
        if (lane < 4) {
            // Q, plain: X, Y, Z = 1, W = b; and zero
            Fe v = fe_zero();
            if (lane < 2) v = reduce_once<ModP>(fe_from_limbs((lane ? ky : kx) + blockIdx.x, K));
            else if (lane == 2) v.w[0] = 1u;
            else v = fe_const(B_PLAIN);
            ch.f[lane] = v;
            Pt& pt = ch.pts[0];
            if (lane < 3) (lane == 0 ? pt.x : lane == 1 ? pt.y : pt.z) = v;
            if (lane == 0) ch.f[SZERO] = fe_zero();
        }
        __syncwarp(FULL);
        if (lane < 2) {  // U = 2X - W, V = 2W - X
            const Fe& m = ch.f[lane ? SW : SX];
            ch.f[SU + lane] = FSUB(FADD(m, m), ch.f[lane ? SX : SW]);
        }
        __syncwarp(FULL);
        const u32 mid = MID_LC[lane < 8 ? lane : 7], point = POINT_LC[lane & 3];
#pragma unroll 1
        for (int i = 1; i < 256; ++i) {
            chain_double(ch, i, lane, mid, point, stamp && i == 128 ? stamp + 3 : nullptr);
            if ((i & 3) == 3 && lane == 0) publish(&ch.ready, (i >> 2) + 1);
        }
        if (stamp && lane == 0) stamp[1] = clock64();
        return;
    }
    const int w_in = lane / FILL_JOBS, job = lane % FILL_JOBS;
#pragma unroll 1
    for (int g = warp - 1; g < 64 / GROUP_WINDOWS; g += TABLE_THREADS / 32 - 1) {
        const int w0 = g * GROUP_WINDOWS;
        while (observe(&ch.ready) < w0 + GROUP_WINDOWS) __nanosleep(256);
        // the group's 16 chain entries into Montgomery form, in place (the
        // chain works on plain values and never reads them again)
#pragma unroll 1
        for (int c = lane; c < 3 * 4 * GROUP_WINDOWS; c += 32) {
            Pt& e = ch.pts[4 * w0 + c / 3];
            Fe& v = c % 3 == 0 ? e.x : c % 3 == 1 ? e.y : e.z;
            v = FMUL(v, fe_const(R2P));
        }
        __syncwarp(FULL);
        if (lane < GROUP_WINDOWS * FILL_JOBS) {
            const int w = w0 + w_in;
            const Pt* pw = ch.pts + 4 * w;  // digits 1, 2, 4, 8
            u32* row = tab + w * 16 * 24;
            const u32 code = FILL_JOB[job];
            Pt acc = pw[code & 15u];
#pragma unroll 1
            for (int st = 0; st < FILL_STEPS; ++st) {
                const u32 bit = (code >> (4 + 8 * st)) & 15u, d = (code >> (8 + 8 * st)) & 15u;
                if (bit == 0u) break;
                acc = pt_add(acc, pw[bit]);
                if (d) store_pt(row + d * 24, acc);
            }
        } else {
            // lanes 28-31: each a window's identity and chain entries
            const int w = w0 + lane - GROUP_WINDOWS * FILL_JOBS;
            u32* row = tab + w * 16 * 24;
            store_pt(row, pt_identity());
#pragma unroll 1
            for (int b = 0; b < 4; ++b) store_pt(row + (1 << b) * 24, ch.pts[4 * w + b]);
        }
    }
    if (stamp && lane == 0)
        atomicMax((unsigned long long*)stamp + 2, (unsigned long long)clock64());
}

// K2's shared memory: the block's product tree of its lanes' s (leaves at
// LANES + g) and their inverses, the chain's slots, each lane's u1 and u2.
struct Block2 {
    Fe tree[2 * LANES];
    Fe inv[2 * LANES];
    Fe slots[12];
    Fe u1[LANES], u2[LANES];
};

// K2: e, r, s are (B, 32) big-endian bytes; tables (K, 64, 16, 3, 8) the
// combs of the key columns (p256_key_tables); key_idx (B,) picks a lane's
// column; a lane whose index is out of range is rejected. g_comb is G's
// comb.
extern "C" __global__ void __launch_bounds__(THREADS)
p256_verify_bytes(const uint8_t* __restrict__ e, const uint8_t* __restrict__ r,
                  const uint8_t* __restrict__ s, const u32* __restrict__ tables,
                  const int* __restrict__ key_idx, const uint8_t* __restrict__ valid_in,
                  const u32* __restrict__ g_comb, uint8_t* __restrict__ out, int B, int K) {
    __shared__ Block2 sb;
    const int g = threadIdx.x / GROUP, j = threadIdx.x % GROUP;
    const int lane = blockIdx.x * LANES + g;
    int kc = -1;
    bool live = false;
    if (lane < B) {
        kc = key_idx[lane];
        live = valid_in[lane] && kc >= 0 && kc < K;
    }
    // s to Montgomery; a dead lane or s = 0 puts 1 into the tree
    Fe s_m = fe_zero();
    if (j == 0) {
        if (live) s_m = NMUL(reduce_once<ModN>(fe_from_bytes(s + 32 * (long long)lane)),
                             fe_const(R2N));
        sb.tree[LANES + g] = fe_is_zero(s_m) ? fe_const(ONEN) : s_m;
    }
    if (!__syncthreads_or(live)) {
        if (j == 0 && lane < B) out[lane] = 0;
        return;
    }
    // Montgomery's batch inversion over the block's lanes, on warp 0: the
    // product tree up, one inverse (the chain), the inverses down
    if (threadIdx.x < 32) {
        const int t = threadIdx.x;
#pragma unroll 1
        for (int lo = LANES / 2; lo >= 1; lo >>= 1) {
            if (t >= lo && t < 2 * lo) sb.tree[t] = NMUL(sb.tree[2 * t], sb.tree[2 * t + 1]);
            __syncwarp(0xFFFFFFFFu);
        }
        if (t == 0) sb.inv[1] = inv_mod_n(sb.tree[1], sb.slots);
        __syncwarp(0xFFFFFFFFu);
#pragma unroll 1
        for (int lo = 2; lo < 2 * LANES; lo <<= 1) {
            if (t >= lo && t < 2 * lo) sb.inv[t] = NMUL(sb.inv[t >> 1], sb.tree[t ^ 1]);
            __syncwarp(0xFFFFFFFFu);
        }
    }
    __syncthreads();
    if (!live) {
        if (j == 0 && lane < B) out[lane] = 0;
        return;
    }
    const u32 mask = 0xFFu << (threadIdx.x & 24);
    if (j == 0) {
        const Fe w = fe_is_zero(s_m) ? fe_zero() : sb.inv[LANES + g];  // 0^(n-2) = 0
        sb.u1[g] = NMUL(reduce_once<ModN>(fe_from_bytes(e + 32 * (long long)lane)), w);
        sb.u2[g] = NMUL(reduce_once<ModN>(fe_from_bytes(r + 32 * (long long)lane)), w);
    }
    __syncwarp(mask);
    // thread j: windows j, j + 8, ..., j + 56 of u1 G and u2 Q, in turns.
    // One call site of pt_add keeps the kernel at 128 registers with no
    // spill (two sites spill 16 bytes at 128, and more registers cost a
    // block an SM: 3.1 against 2.6 ms at 32,768 lanes).
    const Fe& u1 = sb.u1[g];
    const Fe& u2 = sb.u2[g];
    const u32* qt = tables + (long long)kc * TABLE_WORDS;
    const int sh = 4 * j;
    Pt acc = load_pt(g_comb + (j * 16 + ((u1.w[0] >> sh) & 15u)) * 24);
#pragma unroll 1
    for (int i = 1; i < 16; ++i) {
        const bool q = i & 1;
        const int w = j + 8 * (i >> 1);
        const u32 word = q ? u2.w[i >> 1] : u1.w[i >> 1];
        acc = pt_add(acc, load_pt((q ? qt : g_comb) + (w * 16 + ((word >> sh) & 15u)) * 24));
    }
    // the group's partial sums by a shuffle tree
#pragma unroll 1
    for (int d = GROUP / 2; d >= 1; d >>= 1) {
        Pt other;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            other.x.w[i] = __shfl_down_sync(mask, acc.x.w[i], d, GROUP);
            other.y.w[i] = __shfl_down_sync(mask, acc.y.w[i], d, GROUP);
            other.z.w[i] = __shfl_down_sync(mask, acc.z.w[i], d, GROUP);
        }
        if (j < d) acc = pt_add(acc, other);
    }
    if (j == 0) out[lane] = final_check(acc, fe_from_bytes(r + 32 * (long long)lane)) ? 1 : 0;
}

struct Lane1 {
    Team tm;
    Pt qt[16];
    Fe slots[12];
    Fe u1, u2;
};

// K1: e, r, s, qx, qy are (20, B) limbs.
extern "C" __global__ void __launch_bounds__(THREADS)
p256_verify_limbs(const long long* __restrict__ e, const long long* __restrict__ r,
                  const long long* __restrict__ s, const long long* __restrict__ qx,
                  const long long* __restrict__ qy, const uint8_t* __restrict__ valid_in,
                  const u32* __restrict__ g_comb, uint8_t* __restrict__ out, int B) {
    __shared__ Lane1 lanes[LANES];
    const int g = threadIdx.x / GROUP, k = threadIdx.x % GROUP;
    const int lane = blockIdx.x * LANES + g;
    if (lane >= B) return;
    if (!valid_in[lane]) {
        if (k == 0) out[lane] = 0;
        return;
    }
    const u32 mask = 0xFFu << (threadIdx.x & 24);
    Lane1& L = lanes[g];
    Pt q, acc;
    if (k == 0) {
        lane_scalars(fe_from_limbs(e + lane, B), fe_from_limbs(r + lane, B),
                     fe_from_limbs(s + lane, B), L.slots, L.u1, L.u2);
        q = key_point(qx + lane, qy + lane, B);
        acc = q;
        L.qt[0] = pt_identity();
        L.qt[1] = q;
    }
    // d Q for d = 2..15
#pragma unroll 1
    for (int d = 2; d < 16; ++d) {
        team_add(L.tm, k, mask, acc, q);
        if (k == 0) L.qt[d] = acc;
    }
    // Horner, MSB window first: R = 16 R + d2 Q + d1 G (G from comb window 0)
    if (k == 0) acc = L.qt[nibble(L.u2, 63)];
    Pt gd;
    if (k == 0) gd = load_pt(g_comb + nibble(L.u1, 63) * 24);
    team_add(L.tm, k, mask, acc, gd);
#pragma unroll 1
    for (int i = 62; i >= 0; --i) {
#pragma unroll 1
        for (int n = 0; n < 4; ++n) team_double(L.tm, k, mask, acc);
        if (k == 0) q = L.qt[nibble(L.u2, i)];
        team_add(L.tm, k, mask, acc, q);
        if (k == 0) q = load_pt(g_comb + nibble(L.u1, i) * 24);
        team_add(L.tm, k, mask, acc, q);
    }
    if (k == 0) out[lane] = final_check(acc, fe_from_limbs(r + lane, B)) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

#ifndef P256_KERNELS_ONLY

extern "C" int p256_key_tables_launch(const void* kx, const void* ky, void* tables, int K,
                                      void* stream) {
    if (K > 0) {
        p256_key_tables<<<K, TABLE_THREADS, 0, (cudaStream_t)stream>>>(
            (const long long*)kx, (const long long*)ky, (u32*)tables, K, nullptr);
    }
    return (int)cudaGetLastError();
}

// The same launch, each block also writing the SM clock (clock64) into
// stamps (K, STAMPS) int64 (p256_key_tables).
extern "C" int p256_key_tables_stamped_launch(const void* kx, const void* ky, void* tables,
                                              void* stamps, int K, void* stream) {
    if (K > 0) {
        p256_key_tables<<<K, TABLE_THREADS, 0, (cudaStream_t)stream>>>(
            (const long long*)kx, (const long long*)ky, (u32*)tables, K, (long long*)stamps);
    }
    return (int)cudaGetLastError();
}

extern "C" int p256_verify_bytes_launch(const void* e, const void* r, const void* s,
                                        const void* tables, const void* key_idx,
                                        const void* valid_in, const void* g_comb, void* out,
                                        int B, int K, void* stream) {
    if (B > 0) {
        p256_verify_bytes<<<(B + LANES - 1) / LANES, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)e, (const uint8_t*)r, (const uint8_t*)s, (const u32*)tables,
            (const int*)key_idx, (const uint8_t*)valid_in, (const u32*)g_comb, (uint8_t*)out,
            B, K);
    }
    return (int)cudaGetLastError();
}

extern "C" int p256_verify_limbs_launch(const void* e, const void* r, const void* s,
                                        const void* qx, const void* qy, const void* valid_in,
                                        const void* g_comb, void* out, int B, void* stream) {
    if (B > 0) {
        p256_verify_limbs<<<(B + LANES - 1) / LANES, THREADS, 0, (cudaStream_t)stream>>>(
            (const long long*)e, (const long long*)r, (const long long*)s, (const long long*)qx,
            (const long long*)qy, (const uint8_t*)valid_in, (const u32*)g_comb, (uint8_t*)out,
            B);
    }
    return (int)cudaGetLastError();
}

#endif  // P256_KERNELS_ONLY
