// Stand-ins for the CUDA constructs of fabric_tpu_torch/csrc/bn256.cu,
// p256_verify.cu, mvcc_resolve.cu and policy_eval.cu, so that g++ compiles their kernels
// for the CPU: a block runs as std::threads, one a CUDA thread; __syncwarp
// is a barrier over the live threads of the caller's warp and
// __syncthreads (and its _or form) one over the block's (a thread that
// returns drops out of both), __shfl_down_sync an exchange through a
// shared array between two warp barriers; __shared__ variables are
// statics, which the blocks, run one after another, reuse, and a kernel's
// extern __shared__ array is one its harness defines, int2 and int4 a pair
// and a quad of ints;
// atomicMin and atomicMax are compare-and-swap loops and atomicAdd a
// fetch-and-add, clock64 the host's clock. FMUL and NMUL count the calling
// thread's Montgomery multiplies (mod p and, in p256_verify.cu, mod n),
// FMUL_COUNT one that a quad of threads computes, and launch() keeps each
// thread's counts.
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cstdint>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __constant__
#define __shared__ static
#define __restrict__ __restrict
#define __align__(n) alignas(n)

using std::max;
using std::min;

struct alignas(8) int2 {
    int x, y;
};
inline int2 make_int2(int x, int y) { return {x, y}; }
struct alignas(16) int4 {
    int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }

struct Dim3 {
    unsigned x = 0;
};
thread_local Dim3 threadIdx, blockIdx;
static std::barrier<>* g_block_barrier;
static std::vector<std::unique_ptr<std::barrier<>>> g_warp_barriers;
static uint32_t g_exchange[1024];
thread_local long long g_fmuls, g_nmuls;
// [block * blockDim + thread] of the last launch
static std::vector<long long> g_thread_fmuls, g_thread_nmuls;

#define FMUL(a, b) (++g_fmuls, mont_mul(a, b))
#define NMUL(a, b) (++g_nmuls, mont_mul_n(a, b))
// a multiply mod p that several threads compute together, counted once
#define FMUL_COUNT() (++g_fmuls)

// The SM clock: nanoseconds of the host's steady clock.
inline long long clock64() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

inline std::barrier<>& warp_barrier() { return *g_warp_barriers[threadIdx.x / 32]; }

inline void __syncwarp(unsigned) { warp_barrier().arrive_and_wait(); }

inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }

// Two flags used in turns: a call sets its own, every thread reads it and
// clears the other (no thread sets that one before the second barrier);
// launch() clears both and each block's threads start with the first.
static std::atomic<int> g_block_or[2];
thread_local unsigned g_or_calls;
inline int __syncthreads_or(int p) {
    const unsigned turn = g_or_calls++ & 1u;
    if (p) g_block_or[turn].store(1);
    g_block_barrier->arrive_and_wait();
    const int r = g_block_or[turn].load();
    g_block_or[turn ^ 1u].store(0);
    g_block_barrier->arrive_and_wait();
    return r;
}

inline uint32_t __shfl_down_sync(unsigned, uint32_t v, int delta, int width) {
    const int t = threadIdx.x;
    g_exchange[t] = v;
    warp_barrier().arrive_and_wait();
    const int end = t / width * width + width, src = t + delta;
    const uint32_t r = src < end ? g_exchange[src] : v;
    warp_barrier().arrive_and_wait();
    return r;
}

inline void __nanosleep(unsigned) { std::this_thread::yield(); }

// atomicMin / atomicMax on int and unsigned long long, atomicMax and
// atomicAdd on unsigned, in shared or global memory; each returns the old
// value.
template <class T>
inline T atomic_extreme(T* p, T v, bool take_min) {
    std::atomic_ref<T> a(*p);
    T old = a.load();
    while ((take_min ? v < old : v > old) && !a.compare_exchange_weak(old, v)) {
    }
    return old;
}
inline int atomicMin(int* p, int v) { return atomic_extreme(p, v, true); }
inline int atomicMax(int* p, int v) { return atomic_extreme(p, v, false); }
inline unsigned atomicMax(unsigned* p, unsigned v) { return atomic_extreme(p, v, false); }
inline unsigned long long atomicMin(unsigned long long* p, unsigned long long v) {
    return atomic_extreme(p, v, true);
}
inline unsigned long long atomicMax(unsigned long long* p, unsigned long long v) {
    return atomic_extreme(p, v, false);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) { return std::atomic_ref<unsigned>(*p).fetch_add(v); }

// Runs `body` for every thread of `grid` blocks of `block` threads.
static void launch(int grid, int block, const std::function<void()>& body) {
    g_thread_fmuls.assign((size_t)grid * block, 0);
    g_thread_nmuls.assign((size_t)grid * block, 0);
    for (int b = 0; b < grid; ++b) {
        std::barrier<> bar(block);
        g_block_barrier = &bar;
        g_block_or[0].store(0);
        g_block_or[1].store(0);
        g_warp_barriers.clear();
        for (int w = 0; w * 32 < block; ++w)
            g_warp_barriers.push_back(
                std::make_unique<std::barrier<>>(block - 32 * w < 32 ? block - 32 * w : 32));
        std::vector<std::thread> threads;
        for (int t = 0; t < block; ++t)
            threads.emplace_back([&, t, b] {
                threadIdx.x = t;
                blockIdx.x = b;
                g_or_calls = 0;
                g_fmuls = g_nmuls = 0;
                body();
                g_thread_fmuls[(size_t)b * block + t] = g_fmuls;
                g_thread_nmuls[(size_t)b * block + t] = g_nmuls;
                warp_barrier().arrive_and_drop();
                bar.arrive_and_drop();
            });
        for (auto& th : threads) th.join();
    }
}
