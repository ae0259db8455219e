// MVCC validity resolution for Hopper (sm_90a): the block's read/write
// columns in, each transaction's validity out, in one thread block.
//
// Replaces, in the JAX package:
//   fabric_tpu/ledger/mvcc_device.py  _resolve (jit)           -> mvcc_resolve,
//                                                                 mvcc_resolve_global
//     (K5: the Jacobi fixpoint over a block's read and write columns; two
//     routes, chosen by size alone)
//   fabric_tpu/ledger/mvcc_device.py  _resolve_resident (jit,
//     donate_argnums=(0,))                     -> mvcc_resolve_resident,
//                                                 mvcc_resolve_resident_global
//     (K6: K5 over a device-resident (cap, 2) version table, which it
//     seeds, reads and updates; two routes, chosen by size alone)
//
// What it computes. Transaction t of a block is valid iff it arrived valid,
// every read it made saw the committed version, and no earlier valid
// transaction of the block wrote a key it read. With
//   base[t]  = no read of t is statically bad,
//   valid⁰   = base,
//   validⁱ⁺¹[t] = base[t] and no read (t, k) has
//                 min{u : u writes k, validⁱ[u]} < t,
// each sweep is a scatter-min of live writers by key and a scatter-max of
// bad reads by transaction. t depends only on u < t, so after sweep i the
// first i transactions are final: the loop ends at the first sweep that
// changes nothing, after at most T + 1 sweeps. A run that reaches sweep
// T + 1 still changing writes -1 to the status word, and one given an index
// outside [0, T) or [0, K) writes -2; the wrapper raises on either, so a
// mask that has not converged never leaves the host wrapper unchecked.
//
// K6 adds, before the fixpoint, the scatter of the init versions into the
// table (index outside [0, cap) dropped; the host deduplicates the indices)
// and the gather of each read's committed version at clip(r_gid, 0, cap-1),
// compared with the version the read claims; and after it, the commit: per
// key, the last valid writer (scatter-max), whose version is scattered into
// the table at w_gid (outside [0, cap) dropped). The table is updated in
// place, which stands for the JAX program's donated buffer. Where several
// lanes of that last writer target one slot, the smallest version wins
// (lexicographic; a delete, (-1, -1), over a put), which is the host
// oracle's rule that a transaction's delete of a key wins over its put.
//
// Bound. The kernels move few bytes and do almost no arithmetic. The
// function needs each column once: at a 5,000-transaction block with one
// read and one write a transaction, K5's r_tx, r_key, w_tx, w_key, flags
// and mask are about 90 KB, 27 ns at 3.35 TB/s. What sets the time is
// latency: each phase is a dependent round trip behind a block-wide
// barrier, and the launch itself. One launch runs every sweep (no host
// round trip between sweeps) on one block of 1,024 threads, so a barrier
// is a __syncthreads; it uses 1 of the card's 132 SMs.
//
// The global routes (mvcc_resolve_global, mvcc_resolve_resident_global)
// keep their scratch (min_writer, bad, base, valid; K6's static_bad and
// best) in device memory: every phase is a round trip to L2 with global
// atomics, four barriers a sweep, the columns read again each sweep.
//
// The shared routes (mvcc_resolve, mvcc_resolve_resident), for the blocks
// that fit:
//   - scratch in shared memory: the min/last writer word (4 bytes a key;
//     K6 also best, 8 bytes a key), a bad stamp (4 bytes) and base (1 byte)
//     a transaction; atomics hit shared memory, not L2;
//   - the columns loaded once, (tx << 16 | key): each thread's reads in
//     registers (COLS = 12 of its 1,024 threads' strided share), the
//     writes in shared memory (4 bytes each), so a sweep reads no device
//     memory; every phase that does (the columns, K6's versions' check and
//     its commit's versions) issues a thread's loads before it uses one.
//     K5 reads its static flags in the same load, where they clear base,
//     issues a thread's reads and writes of six columns together, and runs
//     its second six only for a block past 6,144 reads or writes: straight
//     code that a launch runs once costs time even where its loads are all
//     predicated off (thread 0's clock stamps on the card: about 2,000
//     cycles for the second six at config #4's block), as if each launch
//     fetched its code anew;
//   - no clearing: the writer word of sweep i holds (i + 1) << 16 |
//     (0xFFFF - t) (an atomicMax keeps the smallest live writer t of the
//     sweep, a stamp from an earlier sweep loses), and a read that finds
//     an earlier writer stamps its transaction's bad word with i + 2 by an
//     atomicMax, whose old value feeds two counts (marked, newly marked):
//     the sweep has converged when none is new and as many are marked as
//     in the sweep before, so a sweep is two barriers (writers, readers),
//     and no sweep runs only to find that nothing changed (shared_sweeps,
//     one function for both);
//   - K6's commit's last writer is one more stamped atomicMax into the
//     same word. At config #4's block (2 sweeps) K6 passes 7 barriers and
//     K5 6, against 16 and 10 on the global routes.
// Their limits (resolve_fits, resident_fits): R and W at most 1,024 * COLS
// = 12,288; T at most 65,532 (stamps and tx ids in 16 bits, sweeps at most
// T + 1); K below 65,536; and 4 K + 4 W + 5 T + 16 bytes (K5) or 12 K +
// 4 W + 5 T + 16 (K6) within the 227 KB a block may have (232,448 bytes).
// A block past any of them takes the global route; a shared route's
// launcher refuses one (cudaErrorInvalidValue), and its wrapper raises.
//
// Interface: plain C, raw pointers, a cudaStream_t; each launcher returns
// cudaGetLastError(). Columns are int32, masks uint8 (torch.bool), the
// version table and the version columns (n, 2) int32 rows. Scratch of the
// global routes comes from the wrapper; the kernels allocate nothing.
// Defining MVCC_KERNELS_ONLY leaves out the launchers and the CUDA
// runtime, so that the kernels compile for the CPU under stand-ins for the
// CUDA constructs (tests/cuda_emu).

#include <climits>
#include <cstdint>
#ifndef MVCC_KERNELS_ONLY
#include <cuda_runtime.h>
#endif

namespace {

constexpr int THREADS = 1024;

struct Columns {
    const int* r_tx;
    const int* r_key;
    const int* w_tx;
    const int* w_key;
    int R, W, T, K;
};

struct Scratch {
    int* min_writer;  // K
    int* bad;         // T
    uint8_t* base;    // T
    uint8_t* valid;   // T, the output mask
};

// The fixpoint. static_bad[r] says read r saw another version than the
// committed one. Returns, in every thread, the number of sweeps run (> 0),
// -1 if it did not converge within T + 1 sweeps, -2 on an index outside
// its range. static_bad may have been written earlier in the same launch,
// so it is not read through the read-only path.
__device__ int fixpoint(const Columns& c, const uint8_t* static_bad,
                        const Scratch& s) {
    const int tid = threadIdx.x;
    int oob = 0;
    for (int t = tid; t < c.T; t += THREADS) s.base[t] = 1;
    __syncthreads();
    for (int r = tid; r < c.R; r += THREADS) {
        const int t = c.r_tx[r];
        const int k = c.r_key[r];
        if (t < 0 || t >= c.T || k < 0 || k >= c.K) {
            oob = 1;
        } else if (static_bad[r]) {
            s.base[t] = 0;
        }
    }
    for (int w = tid; w < c.W; w += THREADS) {
        const int t = c.w_tx[w];
        const int k = c.w_key[w];
        if (t < 0 || t >= c.T || k < 0 || k >= c.K) oob = 1;
    }
    if (__syncthreads_or(oob)) return -2;
    for (int t = tid; t < c.T; t += THREADS) s.valid[t] = s.base[t];

    int sweeps = 0;
    for (;;) {
        ++sweeps;
        for (int k = tid; k < c.K; k += THREADS) s.min_writer[k] = INT_MAX;
        for (int t = tid; t < c.T; t += THREADS) s.bad[t] = 0;
        __syncthreads();
        for (int w = tid; w < c.W; w += THREADS) {
            const int t = c.w_tx[w];
            if (s.valid[t]) atomicMin(&s.min_writer[c.w_key[w]], t);
        }
        __syncthreads();
        for (int r = tid; r < c.R; r += THREADS) {
            const int t = c.r_tx[r];
            if (s.min_writer[c.r_key[r]] < t) s.bad[t] = 1;
        }
        __syncthreads();
        int changed = 0;
        for (int t = tid; t < c.T; t += THREADS) {
            const uint8_t v = (s.base[t] && !s.bad[t]) ? 1 : 0;
            if (v != s.valid[t]) {
                s.valid[t] = v;
                changed = 1;
            }
        }
        if (!__syncthreads_or(changed)) return sweeps;
        if (sweeps > c.T) return -1;
    }
}

// Order-preserving key of a signed (block, tx) pair, for a 64-bit atomicMin.
__device__ __forceinline__ unsigned long long version_key(int v0, int v1) {
    return (static_cast<unsigned long long>(static_cast<unsigned>(v0) ^ 0x80000000u) << 32) |
           (static_cast<unsigned>(v1) ^ 0x80000000u);
}

}  // namespace

// K5's global route.
extern "C" __global__ void __launch_bounds__(THREADS)
mvcc_resolve_global(const int* __restrict__ r_tx, const int* __restrict__ r_key,
                    const uint8_t* __restrict__ r_static_bad, const int* __restrict__ w_tx,
                    const int* __restrict__ w_key, int R, int W, int T, int K,
                    int* min_writer, int* bad, uint8_t* base, uint8_t* valid, int* status) {
    const Columns c{r_tx, r_key, w_tx, w_key, R, W, T, K};
    const Scratch s{min_writer, bad, base, valid};
    const int sweeps = fixpoint(c, r_static_bad, s);
    if (threadIdx.x == 0) *status = sweeps;
}

// K6's global route. versions, init_ver, r_ver and w_ver are (n, 2) int32
// rows.
extern "C" __global__ void __launch_bounds__(THREADS)
mvcc_resolve_resident_global(int* __restrict__ versions, int cap, const int* __restrict__ init_idx,
                      const int* __restrict__ init_ver, int I, const int* __restrict__ r_gid,
                      const int* __restrict__ r_ver, const int* __restrict__ r_tx,
                      const int* __restrict__ r_key, const int* __restrict__ w_tx,
                      const int* __restrict__ w_key, const int* __restrict__ w_gid,
                      const int* __restrict__ w_ver, int R, int W, int T, int K,
                      uint8_t* static_bad, int* min_writer, unsigned long long* best, int* bad,
                      uint8_t* base, uint8_t* valid, int* status) {
    const int tid = threadIdx.x;
    for (int i = tid; i < I; i += THREADS) {
        const int slot = init_idx[i];
        if (slot >= 0 && slot < cap) {
            versions[2 * slot] = init_ver[2 * i];
            versions[2 * slot + 1] = init_ver[2 * i + 1];
        }
    }
    __syncthreads();
    for (int r = tid; r < R; r += THREADS) {
        const int slot = min(max(r_gid[r], 0), cap - 1);
        static_bad[r] = (versions[2 * slot] != r_ver[2 * r] ||
                         versions[2 * slot + 1] != r_ver[2 * r + 1]) ? 1 : 0;
    }
    __syncthreads();

    const Columns c{r_tx, r_key, w_tx, w_key, R, W, T, K};
    const Scratch s{min_writer, bad, base, valid};
    const int sweeps = fixpoint(c, static_bad, s);
    if (tid == 0) *status = sweeps;
    if (sweeps < 0) return;  // uniform across the block: no commit

    // commit: the last valid writer of each key; min_writer is free again
    // and holds it
    int* last_writer = min_writer;
    for (int k = tid; k < K; k += THREADS) {
        last_writer[k] = -1;
        best[k] = ~0ull;
    }
    __syncthreads();
    for (int w = tid; w < W; w += THREADS) {
        const int t = w_tx[w];
        if (valid[t]) atomicMax(&last_writer[w_key[w]], t);
    }
    __syncthreads();
    for (int w = tid; w < W; w += THREADS) {
        const int t = w_tx[w];
        const int slot = w_gid[w];
        if (valid[t] && t == last_writer[w_key[w]] && slot >= 0 && slot < cap)
            atomicMin(&best[w_key[w]], version_key(w_ver[2 * w], w_ver[2 * w + 1]));
    }
    __syncthreads();
    for (int w = tid; w < W; w += THREADS) {
        const int t = w_tx[w];
        const int slot = w_gid[w];
        if (valid[t] && t == last_writer[w_key[w]] && slot >= 0 && slot < cap &&
            version_key(w_ver[2 * w], w_ver[2 * w + 1]) == best[w_key[w]]) {
            versions[2 * slot] = w_ver[2 * w];
            versions[2 * slot + 1] = w_ver[2 * w + 1];
        }
    }
}

// ---------------------------------------------------------------------------
// The shared routes
// ---------------------------------------------------------------------------

constexpr int RES_THREADS = THREADS;         // the shared routes' block
constexpr int COLS = 12;                     // reads a thread holds in registers
constexpr int HALF = COLS / 2;               // K5's columns loaded together
constexpr int SHARED_BYTES_MAX = 232448;     // a block's shared memory, opted in
constexpr int T_MAX = 65532;                 // stamps and tx ids in 16 bits
constexpr int STAMPS = 18;                   // K6's clock stamps
constexpr int K5_STAMPS = 16;                // K5's

// Shared bytes K5's shared route needs for T transactions, K keys and W
// writes, and its limits.
constexpr long long resolve_shared_bytes(long long T, long long K, long long W) {
    return 4 * K + 4 * W + 5 * T + 16;
}

constexpr bool resolve_fits(long long R, long long W, long long T, long long K) {
    return R <= (long long)RES_THREADS * COLS && W <= (long long)RES_THREADS * COLS &&
           T <= T_MAX && K < 65536 && resolve_shared_bytes(T, K, W) <= SHARED_BYTES_MAX;
}

// The same for K6's.
constexpr long long resident_shared_bytes(long long T, long long K, long long W) {
    return 12 * K + 4 * W + 5 * T + 16;
}

constexpr bool resident_fits(long long R, long long W, long long T, long long K) {
    return R <= (long long)RES_THREADS * COLS && W <= (long long)RES_THREADS * COLS &&
           T <= T_MAX && K < 65536 && resident_shared_bytes(T, K, W) <= SHARED_BYTES_MAX;
}

#ifdef __CUDACC__
#define MVCC_DYNAMIC_SHARED extern __shared__
#else
#define MVCC_DYNAMIC_SHARED extern  // the CPU harness defines the array
#endif
MVCC_DYNAMIC_SHARED unsigned long long mvcc_shared[];

__device__ __forceinline__ unsigned pack(int t, int k) { return (unsigned)t << 16 | (unsigned)k; }

// The sweeps of both shared routes and the mask they leave. rd holds this
// thread's reads (tx << 16 | key, read tid + j * RES_THREADS in rd[j]),
// wcol the block's writes; writer (K), bad (T) and cnt (4) start at 0 and
// base (T) holds the static verdicts, all behind a barrier. Sweep i: the
// writers of valid_i transactions (base[t] and bad[t] != i + 1: sweep
// i - 1 stamped t with i + 1) stamp their keys' words with i + 1; the
// readers that find an earlier writer stamp their transaction's bad word
// with i + 2 by an atomicMax, whose old value says whether t was marked
// already in this sweep, in the last one, or not. valid_(i+1) equals
// valid_i iff no transaction was newly marked and as many were marked as
// in sweep i - 1: the counts, kept by parity, decide after the readers'
// barrier. Writes valid_(i+1) of the last sweep i (returned in `last`) and
// returns the sweep count, or -1 past T + 1 sweeps. With stamps, thread 0
// writes clock64 after each barrier of sweeps 0-4 (stamp[2 i] writers,
// stamp[2 i + 1] readers).
__device__ __forceinline__ int shared_sweeps(const unsigned (&rd)[COLS], const unsigned* wcol,
                                             unsigned* writer, unsigned* bad, unsigned* cnt,
                                             const uint8_t* base, int R, int W, int T,
                                             uint8_t* __restrict__ valid, long long* stamp,
                                             int& last) {
    const int tid = threadIdx.x;
    unsigned* marked = cnt;     // [i & 1]: transactions marked in sweep i
    unsigned* fresh = cnt + 2;  // [i & 1]: of those, not marked in sweep i - 1
    unsigned before = 0u;
    int sweeps = 0, i = 0;
#pragma unroll 1
    for (;; ++i) {
        const unsigned stale = (unsigned)(i + 1), mark = (unsigned)(i + 1) << 16;
#pragma unroll 4
        for (int w = tid; w < W; w += RES_THREADS) {
            const unsigned c = wcol[w], t = c >> 16;
            if (base[t] && bad[t] != stale) atomicMax(&writer[c & 0xFFFFu], mark | (0xFFFFu - t));
        }
        __syncthreads();
        if (stamp && i < 5) stamp[2 * i] = clock64();
        if (tid == 0) marked[(i + 1) & 1] = fresh[(i + 1) & 1] = 0u;
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            if (j * RES_THREADS >= R) break;
            if (tid + j * RES_THREADS < R) {
                const unsigned t = rd[j] >> 16, v = writer[rd[j] & 0xFFFFu];
                if ((v >> 16) == (unsigned)(i + 1) && 0xFFFFu - (v & 0xFFFFu) < t && base[t]) {
                    const unsigned old = atomicMax(&bad[t], (unsigned)(i + 2));
                    if (old != (unsigned)(i + 2)) {
                        atomicAdd(&marked[i & 1], 1u);
                        if (old != stale) atomicAdd(&fresh[i & 1], 1u);
                    }
                }
            }
        }
        __syncthreads();
        if (stamp && i < 5) stamp[2 * i + 1] = clock64();
        const unsigned now = marked[i & 1];
        if (fresh[i & 1] == 0u && now == before) {
            sweeps = i + 1;
            break;
        }
        before = now;
        if (i + 1 > T) {
            sweeps = -1;
            break;
        }
    }
    // valid_(i+1): base[t] and no stamp i + 2
#pragma unroll 1
    for (int t = tid; t < T; t += RES_THREADS) valid[t] = base[t] && bad[t] != (unsigned)(i + 2);
    last = i;
    return sweeps;
}

// Six columns of a thread's reads (tx, key, static flag) and writes (tx,
// key): K5's shared route loads them together.
struct Half {
    int rt[HALF], rk[HALF], wt[HALF], wk[HALF];
    uint8_t rb[HALF];
};

// Issues the loads of columns H .. H + HALF - 1 of this thread.
template <int H>
__device__ __forceinline__ void load_half(Half& h, const int* __restrict__ r_tx,
                                          const int* __restrict__ r_key,
                                          const uint8_t* __restrict__ r_static_bad,
                                          const int* __restrict__ w_tx,
                                          const int* __restrict__ w_key, int R, int W) {
#pragma unroll
    for (int q = 0; q < HALF; ++q) {
        const int c = threadIdx.x + (H + q) * RES_THREADS;
        h.rt[q] = c < R ? r_tx[c] : 0;
        h.rk[q] = c < R ? r_key[c] : 0;
        h.rb[q] = c < R ? r_static_bad[c] : 0;
        h.wt[q] = c < W ? w_tx[c] : 0;
        h.wk[q] = c < W ? w_key[c] : 0;
    }
}

// Uses them, after base is set: the reads into rd (a statically bad one
// clears its transaction's base), the writes into wcol. Returns 1 if an
// index is out of range (and then writes nothing out of range).
template <int H>
__device__ __forceinline__ int use_half(const Half& h, unsigned (&rd)[COLS], unsigned* wcol,
                                        uint8_t* base, int R, int W, int T, int K) {
    int oob = 0;
#pragma unroll
    for (int q = 0; q < HALF; ++q) {
        const int c = threadIdx.x + (H + q) * RES_THREADS;
        if (c < R) {
            if ((unsigned)h.rt[q] >= (unsigned)T || (unsigned)h.rk[q] >= (unsigned)K)
                oob = 1;
            else if (h.rb[q])
                base[h.rt[q]] = 0;
        }
        rd[H + q] = pack(h.rt[q], h.rk[q]);
        if (c < W) {
            if ((unsigned)h.wt[q] >= (unsigned)T || (unsigned)h.wk[q] >= (unsigned)K) oob = 1;
            wcol[c] = pack(h.wt[q], h.wk[q]);
        }
    }
    return oob;
}

// K5's shared route: as K5's global route, its scratch in shared memory,
// its reads in registers and its writes in shared memory (the header); the
// launch's dynamic shared memory is resolve_shared_bytes(T, K, W). Each
// thread issues the loads of its first six columns of reads and writes
// before it uses one, and clears the scratch while they are in flight; the
// second six are loaded, used and even fetched as code only by a block of
// more than 6,144 reads or writes. With stamps, thread 0 writes clock64 at
// its start (slot 0), after the scratch's barrier (1), after each half of
// its columns is in (2, 3), after the columns' barrier (4), after each
// barrier of sweeps 0-4 (5-14: writers, then readers) and at its end (15);
// those of sweeps not run stay 0.
extern "C" __global__ void __launch_bounds__(RES_THREADS)
mvcc_resolve(const int* __restrict__ r_tx, const int* __restrict__ r_key,
             const uint8_t* __restrict__ r_static_bad, const int* __restrict__ w_tx,
             const int* __restrict__ w_key, int R, int W, int T, int K,
             uint8_t* __restrict__ valid, int* __restrict__ status,
             long long* __restrict__ stamps) {
    unsigned* writer = reinterpret_cast<unsigned*>(mvcc_shared);  // K: stamped writer words
    unsigned* wcol = writer + K;                                    // W: the writes, t << 16 | k
    unsigned* bad = wcol + W;                                       // T: bad stamps
    unsigned* cnt = bad + T;                                        // 4: the sweeps' counts
    uint8_t* base = reinterpret_cast<uint8_t*>(cnt + 4);            // T
    const int tid = threadIdx.x;
    long long* stamp = tid == 0 ? stamps : nullptr;
    if (stamp) stamp[0] = clock64();
    unsigned rd[COLS] = {};
    Half first;
    load_half<0>(first, r_tx, r_key, r_static_bad, w_tx, w_key, R, W);
    for (int t = tid; t < T; t += RES_THREADS) {
        base[t] = 1;
        bad[t] = 0u;
    }
    if (tid < 4) cnt[tid] = 0u;
    for (int k = tid; k < K; k += RES_THREADS) writer[k] = 0u;
    __syncthreads();
    if (stamp) stamp[1] = clock64();
    int oob = use_half<0>(first, rd, wcol, base, R, W, T, K);
    if (stamp) stamp[2] = clock64();
    if (HALF * RES_THREADS < max(R, W)) {  // uniform across the block
        Half second;
        load_half<HALF>(second, r_tx, r_key, r_static_bad, w_tx, w_key, R, W);
        oob |= use_half<HALF>(second, rd, wcol, base, R, W, T, K);
    }
    if (stamp) stamp[3] = clock64();
    if (__syncthreads_or(oob)) {
        for (int t = tid; t < T; t += RES_THREADS) valid[t] = 0;
        if (tid == 0) *status = -2;
        return;
    }
    if (stamp) stamp[4] = clock64();
    int last;
    const int sweeps = shared_sweeps(rd, wcol, writer, bad, cnt, base, R, W, T, valid,
                                     stamp ? stamp + 5 : nullptr, last);
    if (tid == 0) *status = sweeps;
    if (stamp) stamp[15] = clock64();
}

// K6's shared route: as K6's global route, its scratch in shared memory,
// its reads in registers and its writes in shared memory (the header).
// versions, init_ver, r_ver and w_ver are (n, 2) int32 rows; the launch's
// dynamic shared memory is resident_shared_bytes(T, K, W). Each phase that
// reads device memory issues all of a thread's loads before it uses one.
// With stamps, thread 0 writes clock64 at its start (slot 0), after its
// reads' and its writes' columns are in (16, 17), after the columns'
// barrier (1), after the versions' check (2), after each barrier of sweeps
// 0-4 (3-12: writers, then readers), after the commit's two barriers and
// at its end (13-15); those of sweeps not run stay 0.
extern "C" __global__ void __launch_bounds__(RES_THREADS)
mvcc_resolve_resident(int* __restrict__ versions, int cap, const int* __restrict__ init_idx,
                      const int* __restrict__ init_ver, int I, const int* __restrict__ r_gid,
                      const int* __restrict__ r_ver, const int* __restrict__ r_tx,
                      const int* __restrict__ r_key, const int* __restrict__ w_tx,
                      const int* __restrict__ w_key, const int* __restrict__ w_gid,
                      const int* __restrict__ w_ver, int R, int W, int T, int K,
                      uint8_t* __restrict__ valid, int* __restrict__ status,
                      long long* __restrict__ stamps) {
    unsigned long long* best = mvcc_shared;                    // K: the commit's least version
    unsigned* writer = reinterpret_cast<unsigned*>(best + K);  // K: stamped writer words
    unsigned* wcol = writer + K;                                // W: the writes, t << 16 | k
    unsigned* bad = wcol + W;                                   // T: bad stamps
    unsigned* cnt = bad + T;                                    // 4: the sweeps' counts
    uint8_t* base = reinterpret_cast<uint8_t*>(cnt + 4);        // T
    const int2* vrows = reinterpret_cast<const int2*>(versions);
    const int tid = threadIdx.x;
    long long* stamp = tid == 0 ? stamps : nullptr;
    if (stamp) stamp[0] = clock64();
    // the columns: reads into registers, writes into shared memory; the
    // reads' loads are in flight while the scratch is cleared and the
    // table seeded
    unsigned rd[COLS];
    int oob = 0;
    {
        int tt[COLS], kk[COLS];
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            const int r = tid + j * RES_THREADS;
            tt[j] = r < R ? r_tx[r] : 0;
            kk[j] = r < R ? r_key[r] : 0;
        }
        for (int t = tid; t < T; t += RES_THREADS) {
            base[t] = 1;
            bad[t] = 0u;
        }
        if (tid < 4) cnt[tid] = 0u;
        for (int k = tid; k < K; k += RES_THREADS) {
            writer[k] = 0u;
            best[k] = ~0ull;
        }
        for (int i = tid; i < I; i += RES_THREADS) {
            const int slot = init_idx[i];
            if (slot >= 0 && slot < cap)
                reinterpret_cast<int2*>(versions)[slot] = reinterpret_cast<const int2*>(init_ver)[i];
        }
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            if (tt[j] < 0 || tt[j] >= T || kk[j] < 0 || kk[j] >= K) oob |= tid + j * RES_THREADS < R;
            rd[j] = pack(tt[j], kk[j]);
        }
        if (stamp) stamp[16] = clock64();
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            const int w = tid + j * RES_THREADS;
            tt[j] = w < W ? w_tx[w] : 0;
            kk[j] = w < W ? w_key[w] : 0;
        }
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            const int w = tid + j * RES_THREADS;
            if (tt[j] < 0 || tt[j] >= T || kk[j] < 0 || kk[j] >= K) oob |= w < W;
            if (w < W) wcol[w] = pack(tt[j], kk[j]);
        }
        if (stamp) stamp[17] = clock64();
    }
    if (__syncthreads_or(oob)) {
        for (int t = tid; t < T; t += RES_THREADS) valid[t] = 0;
        if (tid == 0) *status = -2;
        return;
    }
    if (stamp) stamp[1] = clock64();
    // committed versions against the claimed ones (after the init scatter)
    {
        int g[COLS];
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            const int r = tid + j * RES_THREADS;
            g[j] = r < R ? min(max(r_gid[r], 0), cap - 1) : 0;
        }
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            const int r = tid + j * RES_THREADS;
            if (r < R) {
                const int2 have = vrows[g[j]];
                const int2 want = reinterpret_cast<const int2*>(r_ver)[r];
                if (have.x != want.x || have.y != want.y) base[rd[j] >> 16] = 0;
            }
        }
    }
    __syncthreads();
    if (stamp) stamp[2] = clock64();

    int i;
    const int sweeps = shared_sweeps(rd, wcol, writer, bad, cnt, base, R, W, T, valid,
                                     stamp ? stamp + 3 : nullptr, i);
    if (tid == 0) *status = sweeps;
    if (sweeps < 0) return;  // uniform across the block: no commit

    // commit: each key's last valid writer, stamped sweeps + 1 (max t)
    const unsigned stale = (unsigned)(i + 2), last = (unsigned)(sweeps + 1) << 16;
#pragma unroll 4
    for (int w = tid; w < W; w += RES_THREADS) {
        const unsigned c = wcol[w], t = c >> 16;
        if (base[t] && bad[t] != stale) atomicMax(&writer[c & 0xFFFFu], last | t);
    }
    __syncthreads();
    if (stamp) stamp[13] = clock64();
    // among its lanes with a slot in range, the least version, then its
    // write; the lanes of this thread that are their key's last writer's
    unsigned mask = 0u;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
        const int w = tid + j * RES_THREADS;
        if (w < W && writer[wcol[w] & 0xFFFFu] == (last | (wcol[w] >> 16))) mask |= 1u << j;
    }
    {
        int g[COLS];
        int2 v[COLS];
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            const int w = tid + j * RES_THREADS;
            const bool on = (mask >> j) & 1u;
            g[j] = on ? w_gid[w] : -1;
            v[j] = on ? reinterpret_cast<const int2*>(w_ver)[w] : make_int2(0, 0);
        }
#pragma unroll
        for (int j = 0; j < COLS; ++j)
            if (g[j] >= 0 && g[j] < cap)
                atomicMin(&best[wcol[tid + j * RES_THREADS] & 0xFFFFu], version_key(v[j].x, v[j].y));
        __syncthreads();
        if (stamp) stamp[14] = clock64();
#pragma unroll
        for (int j = 0; j < COLS; ++j)
            if (g[j] >= 0 && g[j] < cap &&
                version_key(v[j].x, v[j].y) == best[wcol[tid + j * RES_THREADS] & 0xFFFFu])
                reinterpret_cast<int2*>(versions)[g[j]] = v[j];
    }
    if (stamp) stamp[15] = clock64();
}

#ifndef MVCC_KERNELS_ONLY

extern "C" int mvcc_resolve_global_launch(const void* r_tx, const void* r_key,
                                          const void* r_static_bad, const void* w_tx,
                                          const void* w_key, int R, int W, int T, int K,
                                          void* min_writer, void* bad, void* base, void* valid,
                                          void* status, void* stream) {
    mvcc_resolve_global<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(r_tx), static_cast<const int*>(r_key),
        static_cast<const uint8_t*>(r_static_bad), static_cast<const int*>(w_tx),
        static_cast<const int*>(w_key), R, W, T, K, static_cast<int*>(min_writer),
        static_cast<int*>(bad), static_cast<uint8_t*>(base), static_cast<uint8_t*>(valid),
        static_cast<int*>(status));
    return static_cast<int>(cudaGetLastError());
}

// K5's shared route; a block past resolve_fits is refused. stamps may be
// null (K5_STAMPS int64 otherwise).
extern "C" int mvcc_resolve_launch(const void* r_tx, const void* r_key, const void* r_static_bad,
                                   const void* w_tx, const void* w_key, int R, int W, int T,
                                   int K, void* valid, void* status, void* stamps, void* stream) {
    if (!resolve_fits(R, W, T, K)) return static_cast<int>(cudaErrorInvalidValue);
    static const cudaError_t opted = cudaFuncSetAttribute(
        mvcc_resolve, cudaFuncAttributeMaxDynamicSharedMemorySize, SHARED_BYTES_MAX);
    if (opted != cudaSuccess) return static_cast<int>(opted);
    const size_t bytes = static_cast<size_t>(resolve_shared_bytes(T, K, W));
    mvcc_resolve<<<1, RES_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(r_tx), static_cast<const int*>(r_key),
        static_cast<const uint8_t*>(r_static_bad), static_cast<const int*>(w_tx),
        static_cast<const int*>(w_key), R, W, T, K, static_cast<uint8_t*>(valid),
        static_cast<int*>(status), static_cast<long long*>(stamps));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int mvcc_resolve_resident_global_launch(
    void* versions, int cap, const void* init_idx, const void* init_ver, int I,
    const void* r_gid, const void* r_ver, const void* r_tx, const void* r_key, const void* w_tx,
    const void* w_key, const void* w_gid, const void* w_ver, int R, int W, int T, int K,
    void* static_bad, void* min_writer, void* best, void* bad, void* base, void* valid,
    void* status, void* stream) {
    mvcc_resolve_resident_global<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(versions), cap, static_cast<const int*>(init_idx),
        static_cast<const int*>(init_ver), I, static_cast<const int*>(r_gid),
        static_cast<const int*>(r_ver), static_cast<const int*>(r_tx),
        static_cast<const int*>(r_key), static_cast<const int*>(w_tx),
        static_cast<const int*>(w_key), static_cast<const int*>(w_gid),
        static_cast<const int*>(w_ver), R, W, T, K, static_cast<uint8_t*>(static_bad),
        static_cast<int*>(min_writer), static_cast<unsigned long long*>(best),
        static_cast<int*>(bad), static_cast<uint8_t*>(base), static_cast<uint8_t*>(valid),
        static_cast<int*>(status));
    return static_cast<int>(cudaGetLastError());
}

// K6's shared route; a block past resident_fits is refused. stamps may be
// null (STAMPS int64 otherwise).
static int resident_launch(void* versions, int cap, const void* init_idx, const void* init_ver,
                           int I, const void* r_gid, const void* r_ver, const void* r_tx,
                           const void* r_key, const void* w_tx, const void* w_key,
                           const void* w_gid, const void* w_ver, int R, int W, int T, int K,
                           void* valid, void* status, void* stamps, void* stream) {
    if (!resident_fits(R, W, T, K)) return static_cast<int>(cudaErrorInvalidValue);
    static const cudaError_t opted = cudaFuncSetAttribute(
        mvcc_resolve_resident, cudaFuncAttributeMaxDynamicSharedMemorySize, SHARED_BYTES_MAX);
    if (opted != cudaSuccess) return static_cast<int>(opted);
    const size_t bytes = static_cast<size_t>(resident_shared_bytes(T, K, W));
    mvcc_resolve_resident<<<1, RES_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(versions), cap, static_cast<const int*>(init_idx),
        static_cast<const int*>(init_ver), I, static_cast<const int*>(r_gid),
        static_cast<const int*>(r_ver), static_cast<const int*>(r_tx),
        static_cast<const int*>(r_key), static_cast<const int*>(w_tx),
        static_cast<const int*>(w_key), static_cast<const int*>(w_gid),
        static_cast<const int*>(w_ver), R, W, T, K, static_cast<uint8_t*>(valid),
        static_cast<int*>(status), static_cast<long long*>(stamps));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int mvcc_resolve_resident_launch(
    void* versions, int cap, const void* init_idx, const void* init_ver, int I,
    const void* r_gid, const void* r_ver, const void* r_tx, const void* r_key, const void* w_tx,
    const void* w_key, const void* w_gid, const void* w_ver, int R, int W, int T, int K,
    void* valid, void* status, void* stream) {
    return resident_launch(versions, cap, init_idx, init_ver, I, r_gid, r_ver, r_tx, r_key, w_tx,
                           w_key, w_gid, w_ver, R, W, T, K, valid, status, nullptr, stream);
}

// The same launch with thread 0's clock stamps (the kernel's STAMPS).
extern "C" int mvcc_resolve_resident_stamped_launch(
    void* versions, int cap, const void* init_idx, const void* init_ver, int I,
    const void* r_gid, const void* r_ver, const void* r_tx, const void* r_key, const void* w_tx,
    const void* w_key, const void* w_gid, const void* w_ver, int R, int W, int T, int K,
    void* valid, void* status, void* stamps, void* stream) {
    return resident_launch(versions, cap, init_idx, init_ver, I, r_gid, r_ver, r_tx, r_key, w_tx,
                           w_key, w_gid, w_ver, R, W, T, K, valid, status, stamps, stream);
}

#endif  // MVCC_KERNELS_ONLY
