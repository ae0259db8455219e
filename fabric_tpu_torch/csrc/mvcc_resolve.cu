// MVCC validity resolution for Hopper (sm_90a): the block's read/write
// columns in, each transaction's validity out, in one thread block.
//
// Replaces, in the JAX package:
//   fabric_tpu/ledger/mvcc_device.py  _resolve (jit)           -> mvcc_resolve
//     (K5: the Jacobi fixpoint over a block's read and write columns)
//   fabric_tpu/ledger/mvcc_device.py  _resolve_resident (jit,
//     donate_argnums=(0,))                                    -> mvcc_resolve_resident
//     (K6: K5 over a device-resident (cap, 2) version table, which it
//     seeds, reads and updates)
// Both kernels share one __device__ routine, fixpoint.
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
// Bound. Both kernels move few bytes and do almost no arithmetic. The
// function needs each column once: at a 5,000-transaction block with one
// read and one write a transaction, K5's r_tx, r_key, w_tx, w_key, flags
// and mask are about 90 KB, 27 ns at 3.35 TB/s. This design reads the
// columns again in every sweep, which is one reason it sits above that
// bound; the larger one is latency: each phase is a dependent round trip
// to L2 or device memory behind a block-wide barrier,
// four barriers a sweep, and the launch itself. The design takes that
// head on in the simplest form: one launch runs every sweep (no host round
// trip between sweeps), and one block of 1,024 threads makes the barrier a
// __syncthreads. It uses 1 of the card's 132 SMs. The levers a later change
// has: the scratch arrays (min_writer, bad, base, valid) in shared memory
// while K and T fit its 227 KB (about 56k keys of min_writer alone), and a
// cooperative grid for blocks that do not.
//
// Interface: plain C, raw pointers, a cudaStream_t; each launcher returns
// cudaGetLastError(). Columns are int32, masks uint8 (torch.bool), the
// version table and the version columns (n, 2) int32 rows. Scratch comes
// from the wrapper; the kernels allocate nothing.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

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

// K5.
extern "C" __global__ void __launch_bounds__(THREADS)
mvcc_resolve(const int* __restrict__ r_tx, const int* __restrict__ r_key,
             const uint8_t* __restrict__ r_static_bad, const int* __restrict__ w_tx,
             const int* __restrict__ w_key, int R, int W, int T, int K, int* min_writer,
             int* bad, uint8_t* base, uint8_t* valid, int* status) {
    const Columns c{r_tx, r_key, w_tx, w_key, R, W, T, K};
    const Scratch s{min_writer, bad, base, valid};
    const int sweeps = fixpoint(c, r_static_bad, s);
    if (threadIdx.x == 0) *status = sweeps;
}

// K6. versions, init_ver, r_ver and w_ver are (n, 2) int32 rows.
extern "C" __global__ void __launch_bounds__(THREADS)
mvcc_resolve_resident(int* __restrict__ versions, int cap, const int* __restrict__ init_idx,
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

extern "C" int mvcc_resolve_launch(const void* r_tx, const void* r_key, const void* r_static_bad,
                                   const void* w_tx, const void* w_key, int R, int W, int T,
                                   int K, void* min_writer, void* bad, void* base, void* valid,
                                   void* status, void* stream) {
    mvcc_resolve<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(r_tx), static_cast<const int*>(r_key),
        static_cast<const uint8_t*>(r_static_bad), static_cast<const int*>(w_tx),
        static_cast<const int*>(w_key), R, W, T, K, static_cast<int*>(min_writer),
        static_cast<int*>(bad), static_cast<uint8_t*>(base), static_cast<uint8_t*>(valid),
        static_cast<int*>(status));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int mvcc_resolve_resident_launch(
    void* versions, int cap, const void* init_idx, const void* init_ver, int I,
    const void* r_gid, const void* r_ver, const void* r_tx, const void* r_key, const void* w_tx,
    const void* w_key, const void* w_gid, const void* w_ver, int R, int W, int T, int K,
    void* static_bad, void* min_writer, void* best, void* bad, void* base, void* valid,
    void* status, void* stream) {
    mvcc_resolve_resident<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
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
