// The greedy cauthdsl policy circuit for Hopper (sm_90a): one signature
// policy over a batch of transactions, each with its own signer x principal
// satisfaction matrix, one verdict a transaction.
//
// Replaces, in the JAX package:
//   fabric_tpu/policy/evaluator.py:68  compile_batched             -> policy_eval
//     (K7: the greedy walk over sat (B, S, P) bool -> (B,) bool)
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
// just past the node's subtree, which is how a walk steps from one child to
// the next. The host has checked every principal index against P.
//
// The design: one thread a lane. The thread packs its lane's S x P bools
// into P signer bitmasks of W = ceil(S / 32) words (signer s at bit s % 32
// of word s / 32), then walks the program with an explicit stack, one frame
// for each NOutOf in progress: (node, next child, children left, successes)
// and that frame's committed used (W words). A SignedBy child claims into
// its parent's used in place, since a leaf that fails changes nothing; an
// NOutOf child starts from a copy of its parent's used, and its used is
// copied back when it succeeds. Masks, used words and frames live in local
// memory when (P + depth) x W + 4 x depth words fit LOCAL_WORDS, and
// otherwise in a scratch row of the wrapper's (B, words) tensor, so no
// count of signers, principals or depth is capped here.
//
// Bound. The function reads each of the B x S x P bools once, writes B
// verdict bytes and reads the program (16 bytes a node): at BASELINE config
// #2 (B = 1,000, S = 2, P = 3, 4 nodes) 7,064 bytes, 2.1 ns at 3.35 TB/s.
// Its arithmetic is a few word operations a node and a signer word. Either
// bound is far below a kernel launch (a few microseconds), so at config
// #2's shapes the kernel is launch bound; each thread's walk is a chain of
// dependent local-memory steps, and its byte reads are not coalesced (one
// lane's S x P bools are contiguous, lanes apart by S x P bytes). The
// levers a later change has: a warp a lane with the signer words across
// its threads, and sat loaded through shared memory in coalesced tiles.
//
// Interface: plain C, raw pointers, a cudaStream_t; the launcher returns
// cudaGetLastError(). sat is uint8 (torch.bool), (B, S, P) contiguous; the
// program int32 (nodes, 4); the verdicts uint8 (B,). scratch is null for
// the local-memory variant. The kernel allocates nothing.

#include <cstdint>

#include <cuda_runtime.h>

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

extern "C" int policy_eval_local_words() { return LOCAL_WORDS; }

// `words` is the wrapper's count of a lane's state words, (P + depth) x W +
// 4 x depth: at most LOCAL_WORDS when scratch is null, else the row length
// of the (B, words) scratch tensor.
extern "C" int policy_eval_launch(const void* sat, const void* prog, int B, int S, int P, int depth,
                                  int words, void* out, void* scratch, cudaStream_t stream) {
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
