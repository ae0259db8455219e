// The greedy cauthdsl policy circuit for Hopper (sm_90a): one signature
// policy over a batch of transactions, each with its own signer x principal
// satisfaction matrix, one verdict a transaction.
//
// Replaces, in the JAX package:
//   fabric_tpu/policy/evaluator.py:68  compile_batched     -> policy_eval,
//                                                             policy_eval_kernel
//     (K7: the greedy walk over sat (B, S, P) bool -> (B,) bool; two
//     routes, chosen by shape alone)
//
// What it computes (evaluator.py:72-95, the reference's cauthdsl.go:24-92):
//   SignedBy(p):  elig = sat[:, :, p] & ~used; ok = any(elig); the first
//                 eligible signer (lowest index) is claimed into used.
//   NOutOf(n, rules): every child in order against the current used (no
//                 short cut); a child that succeeds commits its used, one
//                 that fails leaves used as it was; ok = successes >= n.
//                 The used handed back is the committed one even when the
//                 NOutOf fails; its parent then discards it.
//
// The program. The host (ops/policy_kernel.encode_program) compiles the
// envelope once into preorder nodes of four int32 words: kind (0 SignedBy,
// 1 NOutOf), argument (principal index, or n), child count, and the index
// just past the node's subtree. The host has checked every principal index
// against P.
//
// Bound. The function reads each of the B x S x P bools once, writes B
// verdict bytes and reads the program (16 bytes a node): at BASELINE config
// #2 (B = 1,000, S = 2, P = 3, 4 nodes) 7,064 bytes, 2.1 ns at 3.35 TB/s.
// Its arithmetic is a few word operations a node and a signer word. Either
// bound is far below a kernel launch (a few microseconds): what a launch
// can save is device-memory round trips, each about a microsecond.
//
// The shared route (policy_eval), for S <= 32 (one signer word), at most
// 65,535 nodes and a block's shared memory within 232,448 bytes
// (shared_fits): a block of LANES threads, a thread a lane.
//   - Load first: the block's threads copy the program (16 bytes a node)
//     and the block's contiguous tile of sat (LANES x S x P bytes, from
//     lane0 x S x P, which need not be 4-byte aligned) into shared memory,
//     the tile as the aligned words that cover it. A thread issues its
//     program row and TILE_LOADS tile words before it stores one, so the
//     block pays one device-memory round trip for a program of up to
//     LANES nodes and a tile of up to 4 KB (S x P <= 31), one more for
//     each further 4 KB.
//   - Then walk: each lane packs its P signer masks (signer s at bit s)
//     from the tile into shared memory, then walks the program from shared
//     memory in preorder, node after node: the control flow (which node,
//     when a frame closes) is the same for every lane, only the claims and
//     counts differ, so the warp does not diverge. The innermost NOutOf's
//     used word, count, node and threshold are in registers; the frames
//     below it (used, node << 16 | count) in shared memory, [level][lane].
//     Nothing is kept in an array indexed at run time outside shared
//     memory.
//   - The verdicts leave as one coalesced store of a byte a lane.
// The global route (policy_eval_kernel) takes any other shape: one
// thread a lane walking the program with an explicit stack from device
// memory, its masks, used rows and frames in local memory when (P + depth)
// x ceil(S / 32) + 4 x depth words fit LOCAL_WORDS, and otherwise in a
// scratch row of the wrapper's (B, words) tensor, so no count of signers,
// principals or depth is capped on that route.
//
// launch_floor is a kernel that does nothing: the measurement of what one
// launch (of one thread, or of a block shaped like K5's) costs between two
// events on the card, read beside the kernels' times. No wrapper calls it.
//
// Interface: plain C, raw pointers, a cudaStream_t; the launchers return
// cudaGetLastError(). sat is uint8 (torch.bool), (B, S, P) contiguous; the
// program int32 (nodes, 4), 16-byte aligned; the verdicts uint8 (B,).
// scratch is null for the global route's local-memory variant. The kernels allocate
// nothing. Defining POLICY_KERNELS_ONLY leaves out the launchers and the
// CUDA runtime, so that the kernels compile for the CPU under stand-ins for
// the CUDA constructs (tests/cuda_emu).

#include <cstdint>

#ifndef POLICY_KERNELS_ONLY
#include <cuda_runtime.h>
#endif

namespace {

constexpr int THREADS = 128;
constexpr int LOCAL_WORDS = 64;
constexpr int SIGNED_BY = 0;

struct Frame {
    int node, next, left, count;
};

__device__ __forceinline__ bool claim(const uint32_t* mask, uint32_t* used, int words) {
    for (int w = 0; w < words; ++w) {
        uint32_t e = mask[w] & ~used[w];
        if (e) {
            used[w] |= e & (0u - e);  // the lowest eligible signer
            return true;
        }
    }
    return false;
}

__device__ bool walk(const uint8_t* sat, const int4* prog, int S, int P, int depth, uint32_t* buf) {
    const int W = (S + 31) >> 5;
    uint32_t* masks = buf;                        // P x W
    uint32_t* used = buf + P * W;                 // depth x W
    Frame* frames = reinterpret_cast<Frame*>(buf + (P + depth) * W);  // depth
    for (int i = 0; i < P * W; ++i) masks[i] = 0;
    for (int s = 0; s < S; ++s) {
        const uint8_t* row = sat + static_cast<long long>(s) * P;
        for (int p = 0; p < P; ++p)
            if (row[p]) masks[p * W + (s >> 5)] |= 1u << (s & 31);
    }
    const int4 root = prog[0];
    if (root.x == SIGNED_BY) {
        for (int w = 0; w < W; ++w)
            if (masks[root.y * W + w]) return true;
        return false;
    }
    int top = 0;
    frames[0] = Frame{0, 1, root.z, 0};
    for (int w = 0; w < W; ++w) used[w] = 0;
    for (;;) {
        Frame& f = frames[top];
        if (f.left == 0) {
            const bool ok = f.count >= prog[f.node].y;
            if (top == 0) return ok;
            --top;
            if (ok) {
                for (int w = 0; w < W; ++w) used[top * W + w] = used[(top + 1) * W + w];
                frames[top].count += 1;
            }
            continue;
        }
        const int c = f.next;
        const int4 child = prog[c];
        f.next = child.w;
        f.left -= 1;
        if (child.x == SIGNED_BY) {
            if (claim(masks + child.y * W, used + top * W, W)) f.count += 1;
        } else {
            for (int w = 0; w < W; ++w) used[(top + 1) * W + w] = used[top * W + w];
            ++top;
            frames[top] = Frame{c, c + 1, child.z, 0};
        }
    }
}

// The global route: a thread a lane, its state in local memory (LOCAL) or in a
// scratch row of `words` words.
template <bool LOCAL>
__global__ void __launch_bounds__(THREADS)
policy_eval_kernel(const uint8_t* __restrict__ sat, const int4* __restrict__ prog, int B, int S,
                   int P, int depth, uint8_t* __restrict__ out, uint32_t* scratch, int words) {
    const int lane = blockIdx.x * THREADS + threadIdx.x;
    if (lane >= B) return;
    uint32_t local[LOCAL ? LOCAL_WORDS : 1];
    uint32_t* buf = LOCAL ? local : scratch + static_cast<long long>(lane) * words;
    out[lane] = walk(sat + static_cast<long long>(lane) * S * P, prog, S, P, depth, buf);
}

}  // namespace

// ---------------------------------------------------------------------------
// The shared route
// ---------------------------------------------------------------------------

constexpr int LANES = 128;               // the shared route's block: a thread a lane
constexpr int TILE_LOADS = 8;            // tile words a thread issues before it stores one
constexpr int MAX_SIGNERS = 32;          // one signer word
constexpr int MAX_NODES = 65535;         // node indices and counts in 16 bits
constexpr int SHARED_BYTES_MAX = 232448; // a block's shared memory, opted in

// 32-bit words of a block's tile: LANES x S x P bytes from any byte offset.
__host__ __device__ constexpr long long tile_words(long long S, long long P) {
    return LANES * S * P / 4 + 2;
}

// Shared bytes of the shared route: the program, the tile, P masks and
// `depth` frames of two words a lane.
constexpr long long shared_bytes(long long S, long long P, long long depth, long long nodes) {
    return 16 * nodes + 4 * tile_words(S, P) + 4 * LANES * (P + 2 * depth);
}

constexpr bool shared_fits(long long S, long long P, long long depth, long long nodes) {
    return S <= MAX_SIGNERS && nodes >= 1 && nodes <= MAX_NODES &&
           shared_bytes(S, P, depth, nodes) <= SHARED_BYTES_MAX;
}

#ifdef __CUDACC__
#define POLICY_DYNAMIC_SHARED extern __shared__
#else
#define POLICY_DYNAMIC_SHARED extern  // the CPU harness defines the array
#endif
POLICY_DYNAMIC_SHARED int4 policy_shared[];

// The shared route (the header). The launch's dynamic shared memory is
// shared_bytes(S, P, depth, nodes).
extern "C" __global__ void __launch_bounds__(LANES)
policy_eval(const uint8_t* __restrict__ sat, const int4* __restrict__ prog, int B, int S, int P,
            int depth, int nodes, uint8_t* __restrict__ out) {
    int4* sprog = policy_shared;                                      // nodes
    uint32_t* tile = reinterpret_cast<uint32_t*>(sprog + nodes);      // tile_words(S, P)
    uint32_t* smask = tile + tile_words(S, P);                        // P x LANES
    uint32_t* sused = smask + P * LANES;                              // depth x LANES
    uint32_t* sframe = sused + depth * LANES;                         // depth x LANES
    const int tid = threadIdx.x;
    const int lane0 = blockIdx.x * LANES;
    const int lanes = min(LANES, B - lane0);
    const int SP = S * P;
    // the block's bytes [first, first + lanes * SP) of sat, as the aligned
    // words that cover them
    const uintptr_t first = reinterpret_cast<uintptr_t>(sat) + static_cast<uintptr_t>(lane0) * SP;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(first & ~static_cast<uintptr_t>(3));
    const int skew = static_cast<int>(first & 3);
    const int words = lanes * SP > 0 ? (skew + lanes * SP + 3) >> 2 : 0;
    {
        const int4 row = tid < nodes ? prog[tid] : make_int4(0, 0, 0, 0);
        uint32_t v[TILE_LOADS];
#pragma unroll
        for (int j = 0; j < TILE_LOADS; ++j) {
            const int w = tid + j * LANES;
            v[j] = w < words ? src[w] : 0u;
        }
        if (tid < nodes) sprog[tid] = row;
#pragma unroll
        for (int j = 0; j < TILE_LOADS; ++j) {
            const int w = tid + j * LANES;
            if (w < words) tile[w] = v[j];
        }
    }
    for (int i = tid + LANES; i < nodes; i += LANES) sprog[i] = prog[i];
    for (int w0 = TILE_LOADS * LANES; w0 < words; w0 += TILE_LOADS * LANES) {
        uint32_t v[TILE_LOADS];
#pragma unroll
        for (int j = 0; j < TILE_LOADS; ++j) {
            const int w = w0 + tid + j * LANES;
            v[j] = w < words ? src[w] : 0u;
        }
#pragma unroll
        for (int j = 0; j < TILE_LOADS; ++j) {
            const int w = w0 + tid + j * LANES;
            if (w < words) tile[w] = v[j];
        }
    }
    __syncthreads();
    if (tid >= lanes) return;  // no barrier follows

    // the lane's signer masks
    const uint8_t* row = reinterpret_cast<const uint8_t*>(tile) + skew + tid * SP;
    for (int p = 0; p < P; ++p) {
        uint32_t m = 0u;
        for (int s = 0; s < S; ++s) m |= (row[s * P + p] ? 1u : 0u) << s;
        smask[p * LANES + tid] = m;
    }

    // the walk, node after node in preorder; before node i, every frame
    // whose subtree ends at i closes (the innermost first)
    const int4 root = sprog[0];
    bool verdict;
    if (root.x == SIGNED_BY) {
        verdict = smask[root.y * LANES + tid] != 0u;
    } else {
        uint32_t used = 0u;                      // the innermost frame's
        int count = 0, node = 0, end = root.w, need = root.y;
        int top = 0;                             // frames below it
        for (int i = 1;; ++i) {
            while (i == end && top > 0) {
                const bool ok = count >= need;
                --top;
                const uint32_t pu = sused[top * LANES + tid];
                const uint32_t pf = sframe[top * LANES + tid];
                if (!ok) used = pu;              // a failed child's claims are dropped
                node = static_cast<int>(pf >> 16);
                count = static_cast<int>(pf & 0xFFFFu) + (ok ? 1 : 0);
                const int4 pn = sprog[node];
                end = pn.w;
                need = pn.y;
            }
            if (i == end) {                      // the root closed
                verdict = count >= need;
                break;
            }
            const int4 nd = sprog[i];
            if (nd.x == SIGNED_BY) {
                const uint32_t e = smask[nd.y * LANES + tid] & ~used;
                if (e) {
                    used |= e & (0u - e);        // the lowest eligible signer
                    ++count;
                }
            } else {                             // a frame opens on a copy of used
                sused[top * LANES + tid] = used;
                sframe[top * LANES + tid] = static_cast<uint32_t>(node) << 16 |
                                            static_cast<uint32_t>(count);
                ++top;
                node = i;
                count = 0;
                end = nd.w;
                need = nd.y;
            }
        }
    }
    out[lane0 + tid] = verdict ? 1 : 0;
}

// One launch and nothing else.
extern "C" __global__ void launch_floor() {}

#ifndef POLICY_KERNELS_ONLY

extern "C" int policy_eval_local_words() { return LOCAL_WORDS; }

// The global route. `words` is the wrapper's count of a lane's state words,
// (P + depth) x W + 4 x depth: at most LOCAL_WORDS when scratch is null,
// else the row length of the (B, words) scratch tensor.
extern "C" int policy_eval_global_launch(const void* sat, const void* prog, int B, int S, int P,
                                         int depth, int words, void* out, void* scratch,
                                         cudaStream_t stream) {
    const int grid = (B + THREADS - 1) / THREADS;
    auto* s = static_cast<const uint8_t*>(sat);
    auto* g = static_cast<const int4*>(prog);
    auto* o = static_cast<uint8_t*>(out);
    if (scratch == nullptr)
        policy_eval_kernel<true><<<grid, THREADS, 0, stream>>>(s, g, B, S, P, depth, o, nullptr, words);
    else
        policy_eval_kernel<false><<<grid, THREADS, 0, stream>>>(
            s, g, B, S, P, depth, o, static_cast<uint32_t*>(scratch), words);
    return static_cast<int>(cudaGetLastError());
}

// The shared route; a shape past shared_fits is refused.
extern "C" int policy_eval_launch(const void* sat, const void* prog, int B, int S, int P,
                                  int depth, int nodes, void* out, cudaStream_t stream) {
    if (!shared_fits(S, P, depth, nodes)) return static_cast<int>(cudaErrorInvalidValue);
    static const cudaError_t opted = cudaFuncSetAttribute(
        policy_eval, cudaFuncAttributeMaxDynamicSharedMemorySize, SHARED_BYTES_MAX);
    if (opted != cudaSuccess) return static_cast<int>(opted);
    const int grid = (B + LANES - 1) / LANES;
    const size_t bytes = static_cast<size_t>(shared_bytes(S, P, depth, nodes));
    policy_eval<<<grid, LANES, bytes, stream>>>(static_cast<const uint8_t*>(sat),
                                                 static_cast<const int4*>(prog), B, S, P, depth,
                                                 nodes, static_cast<uint8_t*>(out));
    return static_cast<int>(cudaGetLastError());
}

// One block of `threads` threads with `shared_bytes` of dynamic shared
// memory (up to SHARED_BYTES_MAX): the floor of a launch of that shape.
extern "C" int launch_floor_launch(int threads, int shared_bytes, cudaStream_t stream) {
    static const cudaError_t opted = cudaFuncSetAttribute(
        launch_floor, cudaFuncAttributeMaxDynamicSharedMemorySize, SHARED_BYTES_MAX);
    if (opted != cudaSuccess) return static_cast<int>(opted);
    launch_floor<<<1, threads, static_cast<size_t>(shared_bytes), stream>>>();
    return static_cast<int>(cudaGetLastError());
}

#endif  // POLICY_KERNELS_ONLY
