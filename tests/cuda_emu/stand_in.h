// Stand-ins for the CUDA constructs of fabric_tpu_torch/csrc/bn256.cu and
// p256_verify.cu, so that g++ compiles their kernels for the CPU: a block
// runs as std::threads, one a CUDA thread; __syncwarp is a barrier over the
// live threads of the caller's warp and __syncthreads (and its _or form,
// once a block) one over the block's (a thread that returns drops out of
// both), __shfl_down_sync an exchange
// through a shared array between two warp barriers; __shared__ variables
// are statics, which the blocks, run one after another, reuse. FMUL and
// NMUL count the calling thread's Montgomery multiplies (mod p and, in
// p256_verify.cu, mod n), and launch() keeps each thread's counts.
#include <atomic>
#include <barrier>
#include <cstdint>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __constant__
#define __shared__ static
#define __restrict__ __restrict
#define __align__(n) alignas(n)

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

inline std::barrier<>& warp_barrier() { return *g_warp_barriers[threadIdx.x / 32]; }

inline void __syncwarp(unsigned) { warp_barrier().arrive_and_wait(); }

inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }

// Once a block (launch() clears the flag before each block).
static std::atomic<int> g_block_or;
inline int __syncthreads_or(int p) {
    if (p) g_block_or.store(1);
    g_block_barrier->arrive_and_wait();
    const int r = g_block_or.load();
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

// Runs `body` for every thread of `grid` blocks of `block` threads.
static void launch(int grid, int block, const std::function<void()>& body) {
    g_thread_fmuls.assign((size_t)grid * block, 0);
    g_thread_nmuls.assign((size_t)grid * block, 0);
    for (int b = 0; b < grid; ++b) {
        std::barrier<> bar(block);
        g_block_barrier = &bar;
        g_block_or.store(0);
        g_warp_barriers.clear();
        for (int w = 0; w * 32 < block; ++w)
            g_warp_barriers.push_back(
                std::make_unique<std::barrier<>>(block - 32 * w < 32 ? block - 32 * w : 32));
        std::vector<std::thread> threads;
        for (int t = 0; t < block; ++t)
            threads.emplace_back([&, t, b] {
                threadIdx.x = t;
                blockIdx.x = b;
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
