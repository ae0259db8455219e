// Stand-ins for the CUDA constructs of fabric_tpu_torch/csrc/bn256.cu,
// p256_verify.cu, mvcc_resolve.cu and policy_eval.cu, so that g++ compiles their kernels
// for the CPU: a block's threads are fibers (ucontext) that take turns on
// the calling OS thread, each running until it waits at a barrier or in
// __nanosleep; __syncwarp is a barrier over the live threads of the
// caller's warp and __syncthreads (and its _or form) one over the block's
// (a thread that returns drops out of both), __shfl_down_sync an exchange
// through a shared array between two warp barriers; __shared__ variables are
// statics, which the blocks, run one after another, reuse, and a kernel's
// extern __shared__ array is one its harness defines, int2 and int4 a pair
// and a quad of ints;
// atomicMin and atomicMax are compare-and-swap loops and atomicAdd a
// fetch-and-add, clock64 the host's clock. FMUL and NMUL count the calling
// thread's Montgomery multiplies (mod p and, in p256_verify.cu, mod n),
// FMUL_COUNT one that a quad of threads computes, and launch() keeps each
// thread's counts.
//
// One OS thread runs a whole launch, and no thread spins while it waits:
// a waiting fiber is not resumed until its barrier opens. A host busy with
// other work slows the emulation by its share of one core, no more (with a
// block as std::threads, a wait cost a round of futex wake-ups across the
// block, and the waits that spun took the cores the others needed).
#include <algorithm>
#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <chrono>
#include <cstdint>
#include <functional>
#include <memory>
#include <vector>

#include <sys/mman.h>
#include <ucontext.h>

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
// the running thread's; launch() swaps them in and out with the fiber
static Dim3 threadIdx, blockIdx;
static long long g_fmuls, g_nmuls;
static unsigned g_or_calls;

struct Fiber {
    ucontext_t ctx;
    char* stack = nullptr;
    unsigned tid = 0;
    long long fmuls = 0, nmuls = 0;
    unsigned or_calls = 0;
    bool done = false;
    bool napping = false;  // in __nanosleep: resumed when no other thread can run
    // while it waits at a barrier: the barrier's phase, and its value then
    const unsigned long* wait_phase = nullptr;
    unsigned long wait_from = 0;
};
static ucontext_t g_scheduler;
static std::vector<Fiber> g_fibers;
static size_t g_running;

// Back to the scheduler; the running fiber resumes here on its next turn.
inline void fiber_yield() { swapcontext(&g_fibers[g_running].ctx, &g_scheduler); }

// std::barrier's arrive_and_wait and arrive_and_drop, for fibers.
struct Barrier {
    int expected;
    int arrived = 0;
    unsigned long phase = 0;
    explicit Barrier(int n) : expected(n) {}
    void open() {
        arrived = 0;
        ++phase;
    }
    void arrive_and_wait() {
        if (++arrived == expected) {
            open();
            return;
        }
        Fiber& f = g_fibers[g_running];
        f.wait_phase = &phase;
        f.wait_from = phase;
        fiber_yield();
    }
    void arrive_and_drop() {
        if (--expected == arrived && arrived) open();
    }
};
static std::unique_ptr<Barrier> g_block_barrier;
static std::vector<std::unique_ptr<Barrier>> g_warp_barriers;
static uint32_t g_exchange[1024];
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

inline Barrier& warp_barrier() { return *g_warp_barriers[threadIdx.x / 32]; }

inline void __syncwarp(unsigned) { warp_barrier().arrive_and_wait(); }

inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }

// Two flags used in turns: a call sets its own, every thread reads it and
// clears the other (no thread sets that one before the second barrier);
// launch() clears both and each block's threads start with the first.
static std::atomic<int> g_block_or[2];
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

inline void __nanosleep(unsigned) {
    g_fibers[g_running].napping = true;
    fiber_yield();
}

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

// Runs `body` for every thread of `grid` blocks of `block` threads, a block
// at a time, its threads in turns.
static const std::function<void()>* g_body;
constexpr size_t FIBER_STACK = 8u << 20;  // a std::thread's default; pages touched on use

static void fiber_main() {
    (*g_body)();
    Fiber& f = g_fibers[g_running];
    f.done = true;
    warp_barrier().arrive_and_drop();
    g_block_barrier->arrive_and_drop();
}  // returns to g_scheduler through uc_link

static void launch(int grid, int block, const std::function<void()>& body) {
    g_thread_fmuls.assign((size_t)grid * block, 0);
    g_thread_nmuls.assign((size_t)grid * block, 0);
    g_body = &body;
    if (g_fibers.size() < (size_t)block) g_fibers.resize(block);
    for (int t = 0; t < block; ++t) {
        Fiber& f = g_fibers[t];
        if (!f.stack) {
            void* p = mmap(nullptr, FIBER_STACK, PROT_READ | PROT_WRITE,
                           MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE | MAP_STACK, -1, 0);
            if (p == MAP_FAILED) {
                perror("mmap");
                exit(5);
            }
            f.stack = static_cast<char*>(p);
        }
    }
    for (int b = 0; b < grid; ++b) {
        g_block_barrier = std::make_unique<Barrier>(block);
        g_block_or[0].store(0);
        g_block_or[1].store(0);
        g_warp_barriers.clear();
        for (int w = 0; w * 32 < block; ++w)
            g_warp_barriers.push_back(
                std::make_unique<Barrier>(block - 32 * w < 32 ? block - 32 * w : 32));
        for (int t = 0; t < block; ++t) {
            Fiber& f = g_fibers[t];
            f.tid = t;
            f.fmuls = f.nmuls = 0;
            f.or_calls = 0;
            f.done = false;
            f.wait_phase = nullptr;
            getcontext(&f.ctx);
            f.ctx.uc_stack.ss_sp = f.stack;
            f.ctx.uc_stack.ss_size = FIBER_STACK;
            f.ctx.uc_link = &g_scheduler;
            makecontext(&f.ctx, fiber_main, 0);
        }
        blockIdx.x = b;
        // a round runs every thread that can run, the napping ones only
        // in a round where no other could
        for (int live = block, naps = 0; live;) {
            bool ran = false;
            for (int t = 0; t < block; ++t) {
                Fiber& f = g_fibers[t];
                if (f.done || (f.napping && !naps)) continue;
                if (f.wait_phase) {
                    if (*f.wait_phase == f.wait_from) continue;
                    f.wait_phase = nullptr;
                }
                ran = true;
                f.napping = false;
                threadIdx.x = f.tid;
                g_fmuls = f.fmuls;
                g_nmuls = f.nmuls;
                g_or_calls = f.or_calls;
                g_running = t;
                swapcontext(&g_scheduler, &f.ctx);
                f.fmuls = g_fmuls;
                f.nmuls = g_nmuls;
                f.or_calls = g_or_calls;
                if (f.done) {
                    g_thread_fmuls[(size_t)b * block + t] = f.fmuls;
                    g_thread_nmuls[(size_t)b * block + t] = f.nmuls;
                    --live;
                }
            }
            if (ran) {
                naps = 0;
            } else if (!naps++) {
                continue;
            } else {
                fprintf(stderr, "launch: block %d deadlocked, %d threads waiting\n", b, live);
                exit(6);
            }
        }
    }
}
