// Stand-ins for the CUDA constructs of fabric_tpu_torch/csrc/bn256.cu, so
// that g++ compiles its kernels for the CPU: a block runs as std::threads,
// one a CUDA thread; __syncwarp is a barrier over the block's live threads
// (a thread that returns drops out), __shfl_down_sync an exchange through
// a shared array between two barriers; __shared__ variables are statics,
// which the blocks, run one after another, reuse. FMUL counts the calling
// thread's Montgomery multiplies, and launch() keeps each thread's count.
#include <barrier>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(x)
#define __constant__
#define __shared__ static
#define __restrict__ __restrict
#define __align__(n) alignas(n)

struct Dim3 {
    unsigned x = 0;
};
thread_local Dim3 threadIdx, blockIdx;
static std::barrier<>* g_block_barrier;
static uint32_t g_exchange[1024];
thread_local long long g_fmuls;
static std::vector<long long> g_thread_fmuls;  // [block * blockDim + thread] of the last launch

#define FMUL(a, b) (++g_fmuls, mont_mul(a, b))

inline void __syncwarp(unsigned) { g_block_barrier->arrive_and_wait(); }

inline uint32_t __shfl_down_sync(unsigned, uint32_t v, int delta, int width) {
    const int t = threadIdx.x;
    g_exchange[t] = v;
    g_block_barrier->arrive_and_wait();
    const int end = t / width * width + width, src = t + delta;
    const uint32_t r = src < end ? g_exchange[src] : v;
    g_block_barrier->arrive_and_wait();
    return r;
}

// Runs `body` for every thread of `grid` blocks of `block` threads.
static void launch(int grid, int block, const std::function<void()>& body) {
    g_thread_fmuls.assign((size_t)grid * block, 0);
    for (int b = 0; b < grid; ++b) {
        std::barrier<> bar(block);
        g_block_barrier = &bar;
        std::vector<std::thread> threads;
        for (int t = 0; t < block; ++t)
            threads.emplace_back([&, t, b] {
                threadIdx.x = t;
                blockIdx.x = b;
                g_fmuls = 0;
                body();
                g_thread_fmuls[(size_t)b * block + t] = g_fmuls;
                bar.arrive_and_drop();
            });
        for (auto& th : threads) th.join();
    }
}
