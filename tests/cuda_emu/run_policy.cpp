// Calls the emulated K7 kernels on the cases of a file, in the wrapper's
// layouts: cases.bin holds, for each case, int32 B, S, P, depth, nodes and
// the byte offset (0-3) at which its sat starts past a 16-byte boundary,
// then the (nodes, 4) int32 program and the (B, S, P) sat bytes. Runs the
// shared route (policy_eval) on every case within shared_fits and the global
// route (policy_eval_kernel, local or scratch state as the wrapper picks)
// on every case, and writes verdicts_shared.bin and verdicts_global.bin,
// B bytes a case in order (2 where the shared route's launcher would
// refuse the case). Prints shared_fits (0 or 1) a case, a line each.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

int4 policy_shared[SHARED_BYTES_MAX / 16];

static std::vector<char> read_file(const std::string& path) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) {
        perror(path.c_str());
        exit(2);
    }
    fseek(f, 0, SEEK_END);
    const long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf(n);
    if (n && fread(buf.data(), 1, n, f) != (size_t)n) exit(3);
    fclose(f);
    return buf;
}

static void write_file(const std::string& path, const std::vector<uint8_t>& v) {
    FILE* f = fopen(path.c_str(), "wb");
    if (!f || (!v.empty() && fwrite(v.data(), 1, v.size(), f) != v.size())) exit(4);
    fclose(f);
}

int main(int argc, char** argv) {
    if (argc != 2) return 1;
    const std::string dir = std::string(argv[1]) + "/";
    const auto buf = read_file(dir + "cases.bin");
    std::vector<uint8_t> shared_out, global_out;
    size_t at = 0;
    while (at < buf.size()) {
        int h[6];
        memcpy(h, buf.data() + at, sizeof h);
        at += sizeof h;
        const int B = h[0], S = h[1], P = h[2], depth = h[3], nodes = h[4], offset = h[5];
        std::vector<int4> prog(nodes);
        memcpy(prog.data(), buf.data() + at, 16 * (size_t)nodes);
        at += 16 * (size_t)nodes;
        const size_t n = (size_t)B * S * P;
        std::vector<int4> store(n / 16 + 2);  // 16-byte aligned
        uint8_t* sat = reinterpret_cast<uint8_t*>(store.data()) + offset;
        memcpy(sat, buf.data() + at, n);
        at += n;

        std::vector<uint8_t> out(B, 2);
        const bool fits = shared_fits(S, P, depth, nodes);
        if (fits && B > 0)
            launch((B + LANES - 1) / LANES, LANES,
                   [&] { policy_eval(sat, prog.data(), B, S, P, depth, nodes, out.data()); });
        shared_out.insert(shared_out.end(), out.begin(), out.end());

        std::fill(out.begin(), out.end(), 2);
        const int words = (P + depth) * ((S + 31) / 32) + 4 * depth;
        std::vector<uint32_t> scratch(words > LOCAL_WORDS ? (size_t)B * words : 0);
        if (B > 0)
            launch((B + THREADS - 1) / THREADS, THREADS, [&] {
                if (words > LOCAL_WORDS)
                    policy_eval_kernel<false>(sat, prog.data(), B, S, P, depth, out.data(),
                                              scratch.data(), words);
                else
                    policy_eval_kernel<true>(sat, prog.data(), B, S, P, depth, out.data(), nullptr,
                                             words);
            });
        global_out.insert(global_out.end(), out.begin(), out.end());
        printf("%d\n", fits ? 1 : 0);
    }
    write_file(dir + "verdicts_shared.bin", shared_out);
    write_file(dir + "verdicts_global.bin", global_out);
    return 0;
}
