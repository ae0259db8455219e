// Calls the emulated MVCC kernels on columns saved as raw files in a
// directory, in the wrappers' layouts: sizes.txt holds R W T K I cap;
// r_tx.bin r_key.bin r_gid.bin (R,) int32, r_bad.bin (R,) u8, r_ver.bin
// (R, 2) int32; w_tx.bin w_key.bin w_gid.bin (W,) int32, w_ver.bin (W, 2)
// int32; versions.bin (cap, 2), init_idx.bin (I,), init_ver.bin (I, 2)
// int32. Runs K5's two routes (mvcc_resolve, mvcc_resolve_global) and
// K6's two routes on copies of the table, and writes
// valid_{k5,k5global,shared,global}.bin (T,) u8,
// status_{k5,k5global,shared,global}.bin int32, versions_{shared,global}.bin
// and the shared routes' clock stamps stamps_k5.bin (K5_STAMPS int64) and
// stamps_shared.bin (STAMPS int64). A block past resolve_fits gets no K5
// shared launch (status_k5 99), one past resident_fits no K6 shared launch
// (status_shared 99), as their launchers refuse them. Prints THREADS and
// COLS.
//
//     run_mvcc fits R W T K
//
// prints resolve_fits and resident_fits (0 or 1) of those sizes instead.
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <string>

unsigned long long mvcc_shared[SHARED_BYTES_MAX / 8];

static std::vector<char> read_file(const std::string& path) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) {
        perror(path.c_str());
        exit(2);
    }
    fseek(f, 0, SEEK_END);
    const long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf(n + 8);
    if (n && fread(buf.data(), 1, n, f) != (size_t)n) exit(3);
    fclose(f);
    return buf;
}

static void write_file(const std::string& path, const void* p, size_t n) {
    FILE* f = fopen(path.c_str(), "wb");
    if (!f || (n && fwrite(p, 1, n, f) != n)) exit(4);
    fclose(f);
}

template <class T>
static const T* as(const std::vector<char>& v) {
    return reinterpret_cast<const T*>(v.data());
}

int main(int argc, char** argv) {
    if (argc == 6 && std::string(argv[1]) == "fits") {
        const long long R = atoll(argv[2]), W = atoll(argv[3]), T = atoll(argv[4]),
                        K = atoll(argv[5]);
        printf("%d %d\n", (int)resolve_fits(R, W, T, K), (int)resident_fits(R, W, T, K));
        return 0;
    }
    if (argc != 2) return 1;
    const std::string dir = std::string(argv[1]) + "/";
    int R, W, T, K, I, cap;
    std::ifstream sizes(dir + "sizes.txt");
    if (!(sizes >> R >> W >> T >> K >> I >> cap)) return 5;
    const auto r_tx = read_file(dir + "r_tx.bin"), r_key = read_file(dir + "r_key.bin");
    const auto r_bad = read_file(dir + "r_bad.bin"), r_gid = read_file(dir + "r_gid.bin");
    const auto r_ver = read_file(dir + "r_ver.bin"), w_tx = read_file(dir + "w_tx.bin");
    const auto w_key = read_file(dir + "w_key.bin"), w_gid = read_file(dir + "w_gid.bin");
    const auto w_ver = read_file(dir + "w_ver.bin"), table = read_file(dir + "versions.bin");
    const auto init_idx = read_file(dir + "init_idx.bin");
    const auto init_ver = read_file(dir + "init_ver.bin");

    std::vector<int> min_writer(K + 1), bad(T + 1);
    std::vector<uint8_t> base(T + 1), valid(T + 1), static_bad(R + 1);
    std::vector<unsigned long long> best(K + 1);
    int status = 99;
    std::fill(valid.begin(), valid.end(), 2);
    if (resolve_fits(R, W, T, K)) {
        std::vector<long long> stamps(K5_STAMPS, 0);
        launch(1, RES_THREADS, [&] {
            mvcc_resolve(as<int>(r_tx), as<int>(r_key), as<uint8_t>(r_bad), as<int>(w_tx),
                         as<int>(w_key), R, W, T, K, valid.data(), &status, stamps.data());
        });
        write_file(dir + "stamps_k5.bin", stamps.data(), stamps.size() * sizeof(long long));
    }
    write_file(dir + "valid_k5.bin", valid.data(), T);
    write_file(dir + "status_k5.bin", &status, sizeof status);

    launch(1, THREADS, [&] {
        mvcc_resolve_global(as<int>(r_tx), as<int>(r_key), as<uint8_t>(r_bad), as<int>(w_tx),
                            as<int>(w_key), R, W, T, K, min_writer.data(), bad.data(),
                            base.data(), valid.data(), &status);
    });
    write_file(dir + "valid_k5global.bin", valid.data(), T);
    write_file(dir + "status_k5global.bin", &status, sizeof status);

    std::vector<int> versions(2 * (size_t)cap);
    std::copy(as<int>(table), as<int>(table) + 2 * (size_t)cap, versions.begin());
    launch(1, THREADS, [&] {
        mvcc_resolve_resident_global(
            versions.data(), cap, as<int>(init_idx), as<int>(init_ver), I, as<int>(r_gid),
            as<int>(r_ver), as<int>(r_tx), as<int>(r_key), as<int>(w_tx), as<int>(w_key),
            as<int>(w_gid), as<int>(w_ver), R, W, T, K, static_bad.data(), min_writer.data(),
            best.data(), bad.data(), base.data(), valid.data(), &status);
    });
    write_file(dir + "valid_global.bin", valid.data(), T);
    write_file(dir + "status_global.bin", &status, sizeof status);
    write_file(dir + "versions_global.bin", versions.data(), versions.size() * sizeof(int));

    std::copy(as<int>(table), as<int>(table) + 2 * (size_t)cap, versions.begin());
    std::fill(valid.begin(), valid.end(), 2);
    status = 99;
    if (resident_fits(R, W, T, K)) {
        std::vector<long long> stamps(STAMPS, 0);
        launch(1, RES_THREADS, [&] {
            mvcc_resolve_resident(versions.data(), cap, as<int>(init_idx), as<int>(init_ver), I,
                                  as<int>(r_gid), as<int>(r_ver), as<int>(r_tx), as<int>(r_key),
                                  as<int>(w_tx), as<int>(w_key), as<int>(w_gid), as<int>(w_ver),
                                  R, W, T, K, valid.data(), &status, stamps.data());
        });
        write_file(dir + "stamps_shared.bin", stamps.data(), stamps.size() * sizeof(long long));
    }
    write_file(dir + "valid_shared.bin", valid.data(), T);
    write_file(dir + "status_shared.bin", &status, sizeof status);
    write_file(dir + "versions_shared.bin", versions.data(), versions.size() * sizeof(int));
    printf("%d %d\n", RES_THREADS, COLS);
    return 0;
}
