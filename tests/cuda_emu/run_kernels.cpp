// Calls the emulated kernels on inputs saved as raw files in a directory:
//   run_kernels msm DIR K B   bases.bin scalars.bin          -> out.bin muls.bin
//   run_kernels ate DIR S B   sw.bin sg.bin has_add.bin ok.bin p1x.bin p1y.bin
//                        p2x.bin p2y.bin                -> vals.bin verdict.bin
//                                                          muls_debug.bin muls_unity.bin
// (ate2_debug, then ate2_unity). The layouts are the wrappers'; muls*.bin
// hold each launched thread's Montgomery multiplies (int64, block-major),
// and the ate mode prints its threads a lane, lanes a block and block size.
#include <cstdio>
#include <cstdlib>
#include <string>

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
    if (fread(buf.data(), 1, n, f) != (size_t)n) exit(3);
    fclose(f);
    return buf;
}

static void write_file(const std::string& path, const void* p, size_t n) {
    FILE* f = fopen(path.c_str(), "wb");
    if (!f || fwrite(p, 1, n, f) != n) exit(4);
    fclose(f);
}

static void write_muls(const std::string& path) {
    write_file(path, g_thread_fmuls.data(), g_thread_fmuls.size() * sizeof(long long));
}

int main(int argc, char** argv) {
    if (argc != 5) return 1;
    const std::string mode = argv[1], dir = std::string(argv[2]) + "/";
    const int n = atoi(argv[3]), B = atoi(argv[4]);
    if (mode == "msm") {
        const auto bases = read_file(dir + "bases.bin"), scalars = read_file(dir + "scalars.bin");
        std::vector<long long> out(3 * 20 * (size_t)B);
        const int log_g = msm_log_g(n);
        const long long threads = (long long)B << log_g;
        launch((int)((threads + THREADS3 - 1) / THREADS3), THREADS3, [&] {
            bn256_msm((const long long*)bases.data(), (const long long*)scalars.data(), out.data(),
                      n, log_g, B);
        });
        write_file(dir + "out.bin", out.data(), out.size() * sizeof(long long));
        write_muls(dir + "muls.bin");
        return 0;
    }
    const auto sw = read_file(dir + "sw.bin"), sg = read_file(dir + "sg.bin");
    const auto has_add = read_file(dir + "has_add.bin"), ok = read_file(dir + "ok.bin");
    const auto p1x = read_file(dir + "p1x.bin"), p1y = read_file(dir + "p1y.bin");
    const auto p2x = read_file(dir + "p2x.bin"), p2y = read_file(dir + "p2y.bin");
    std::vector<uint32_t> vals(3 * 12 * 8 * (size_t)B);
    std::vector<uint8_t> verdict(B, 2);
    const int grid = (B + LANES4 - 1) / LANES4;
    launch(grid, THREADS4, [&] {
        ate2_debug((const u32*)sw.data(), (const u32*)sg.data(), (const int*)has_add.data(), n,
                   (const long long*)p1x.data(), (const long long*)p1y.data(),
                   (const long long*)p2x.data(), (const long long*)p2y.data(),
                   (const uint8_t*)ok.data(), vals.data(), B);
    });
    write_muls(dir + "muls_debug.bin");
    launch(grid, THREADS4, [&] {
        ate2_unity((const u32*)sw.data(), (const u32*)sg.data(), (const int*)has_add.data(), n,
                   (const long long*)p1x.data(), (const long long*)p1y.data(),
                   (const long long*)p2x.data(), (const long long*)p2y.data(),
                   (const uint8_t*)ok.data(), verdict.data(), B);
    });
    write_muls(dir + "muls_unity.bin");
    printf("%d %d %d\n", GROUP4, LANES4, THREADS4);
    write_file(dir + "vals.bin", vals.data(), vals.size() * sizeof(uint32_t));
    write_file(dir + "verdict.bin", verdict.data(), verdict.size());
    return 0;
}
