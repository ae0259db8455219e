// Streaming SHA-256 for the native host runtime. At startup it dlopen()s
// libcrypto.so.3 (OpenSSL's assembly and SHA-NI paths); when libcrypto is
// absent it falls back to the portable FIPS 180-4 implementation, so the
// port's native library has no hard dependency beyond libc.
#pragma once

#include <cstddef>
#include <cstdint>

// Opaque context: large enough for OpenSSL's SHA256_CTX (112 bytes) or
// the portable state.
struct ShaCtx {
  alignas(8) uint8_t space[160];
};

void sha256c_init(ShaCtx* c);
void sha256c_update(ShaCtx* c, const uint8_t* p, size_t len);
void sha256c_final(ShaCtx* c, uint8_t out[32]);
void sha256c_oneshot(const uint8_t* p, size_t len, uint8_t out[32]);
// 1 = OpenSSL backend active (for tests / diagnostics)
int sha256c_backend();
