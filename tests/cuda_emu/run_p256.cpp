// Calls the emulated P-256 kernels on inputs saved as raw files in a
// directory, in the wrappers' layouts:
//   run_p256 DIR B K   kx.bin ky.bin (20, K) int64, gcomb.bin (64, 16, 3, 8)
//                      u32; bytes route: e_b.bin r_b.bin s_b.bin (B, 32) u8,
//                      idx.bin (B,) int32; limb route: e.bin r.bin s.bin
//                      qx.bin qy.bin (20, B) int64; valid.bin (B,) u8
// runs p256_key_tables, p256_verify_bytes on its tables, then
// p256_verify_limbs, and writes tables.bin, out_bytes.bin, out_limbs.bin and
// each launched thread's multiplies (int64, block-major):
// {fmuls,nmuls}_{tables,bytes,limbs}.bin. It prints the threads a lane and
// a verify block, and a table block's threads.
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

static void write_counts(const std::string& dir, const std::string& what) {
    write_file(dir + "fmuls_" + what + ".bin", g_thread_fmuls.data(),
               g_thread_fmuls.size() * sizeof(long long));
    write_file(dir + "nmuls_" + what + ".bin", g_thread_nmuls.data(),
               g_thread_nmuls.size() * sizeof(long long));
}

int main(int argc, char** argv) {
    if (argc != 4) return 1;
    const std::string dir = std::string(argv[1]) + "/";
    const int B = atoi(argv[2]), K = atoi(argv[3]);
    const auto kx = read_file(dir + "kx.bin"), ky = read_file(dir + "ky.bin");
    const auto gcomb = read_file(dir + "gcomb.bin"), valid = read_file(dir + "valid.bin");
    std::vector<u32> tables((size_t)K * TABLE_WORDS);
    std::vector<long long> stamps((size_t)K * STAMPS, 0);
    launch(K, TABLE_THREADS, [&] {
        p256_key_tables((const long long*)kx.data(), (const long long*)ky.data(), tables.data(), K,
                        stamps.data());
    });
    write_file(dir + "stamps.bin", stamps.data(), stamps.size() * sizeof(long long));
    write_counts(dir, "tables");
    write_file(dir + "tables.bin", tables.data(), tables.size() * sizeof(u32));

    const auto eb = read_file(dir + "e_b.bin"), rb = read_file(dir + "r_b.bin");
    const auto sb = read_file(dir + "s_b.bin"), idx = read_file(dir + "idx.bin");
    std::vector<uint8_t> out(B, 2);
    const int grid = (B + LANES - 1) / LANES;
    launch(grid, THREADS, [&] {
        p256_verify_bytes((const uint8_t*)eb.data(), (const uint8_t*)rb.data(),
                          (const uint8_t*)sb.data(), tables.data(), (const int*)idx.data(),
                          (const uint8_t*)valid.data(), (const u32*)gcomb.data(), out.data(), B, K);
    });
    write_counts(dir, "bytes");
    write_file(dir + "out_bytes.bin", out.data(), out.size());

    const auto e = read_file(dir + "e.bin"), r = read_file(dir + "r.bin");
    const auto s = read_file(dir + "s.bin"), qx = read_file(dir + "qx.bin");
    const auto qy = read_file(dir + "qy.bin");
    std::fill(out.begin(), out.end(), 2);
    launch(grid, THREADS, [&] {
        p256_verify_limbs((const long long*)e.data(), (const long long*)r.data(),
                          (const long long*)s.data(), (const long long*)qx.data(),
                          (const long long*)qy.data(), (const uint8_t*)valid.data(),
                          (const u32*)gcomb.data(), out.data(), B);
    });
    write_counts(dir, "limbs");
    write_file(dir + "out_limbs.bin", out.data(), out.size());
    printf("%d %d %d\n", GROUP, THREADS, TABLE_THREADS);
    return 0;
}
