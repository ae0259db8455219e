// fabric_native — the port's C++ host runtime for the irregular byte work
// that feeds the P-256 kernels on the card (K1 and K2 of
// fabric_tpu_torch/csrc/p256_verify.cu): the digests of the block
// validator's signature jobs and the DER parse of
// crypto/cuda_provider.CUDAProvider's host prep. Exposed as a plain C ABI
// bound with ctypes by fabric_tpu_torch/utils/native.py.
//
//  * fn_batch_sha256: digest N variable-length messages.
//  * fn_batch_der_parse: unmarshal N ECDSA-P256 DER signatures into
//    fixed-width (r, s) big-endian 32-byte words with per-lane validity
//    + low-S flags, matching fabric_tpu_torch/common/der.py (strict
//    DER: minimal integer encoding).
//
// Built on first use by fabric_tpu_torch/utils/native.py with this file,
// blockparse.cc and sha256c.cc: g++ -O3 -fPIC -std=c++17 -shared ... -ldl

#include <cstdint>
#include <cstring>

#include "sha256c.h"

extern "C" {

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4), straightforward portable implementation.
// (Retained as documentation/fallback; fn_batch_sha256 routes through
// sha256c, which picks up libcrypto's assembly paths when present.)
// ---------------------------------------------------------------------------

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static void sha256_one(const uint8_t* msg, uint64_t len, uint8_t out[32]) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  uint64_t total = len;
  uint8_t block[64];
  uint64_t off = 0;
  bool appended_one = false, appended_len = false;
  while (!appended_len) {
    uint64_t take = (len > off) ? (len - off) : 0;
    if (take > 64) take = 64;
    std::memcpy(block, msg + off, (size_t)take);
    uint64_t pos = take;
    if (pos < 64 && !appended_one) {
      block[pos++] = 0x80;
      appended_one = true;
    }
    if (pos <= 56) {
      std::memset(block + pos, 0, 56 - (size_t)pos);
      uint64_t bits = total * 8;
      for (int i = 0; i < 8; i++)
        block[56 + i] = (uint8_t)(bits >> (56 - 8 * i));
      appended_len = true;
    } else {
      std::memset(block + pos, 0, 64 - (size_t)pos);
    }
    // compress
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = ((uint32_t)block[4 * i] << 24) | ((uint32_t)block[4 * i + 1] << 16) |
             ((uint32_t)block[4 * i + 2] << 8) | (uint32_t)block[4 * i + 3];
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    off += 64;
  }
  for (int i = 0; i < 8; i++) {
    out[4 * i] = (uint8_t)(h[i] >> 24);
    out[4 * i + 1] = (uint8_t)(h[i] >> 16);
    out[4 * i + 2] = (uint8_t)(h[i] >> 8);
    out[4 * i + 3] = (uint8_t)h[i];
  }
}

// msgs: concatenated bytes; offsets[i], lens[i] describe message i.
// out: n * 32 bytes.
void fn_batch_sha256(const uint8_t* msgs, const uint64_t* offsets,
                     const uint64_t* lens, int64_t n, uint8_t* out) {
  if (sha256c_backend()) {
    for (int64_t i = 0; i < n; i++)
      sha256c_oneshot(msgs + offsets[i], lens[i], out + 32 * i);
  } else {
    for (int64_t i = 0; i < n; i++)
      sha256_one(msgs + offsets[i], lens[i], out + 32 * i);
  }
}

// ---------------------------------------------------------------------------
// Strict-DER ECDSA signature parse (mirrors fabric_tpu_torch/common/der.py):
//   SEQUENCE { INTEGER r, INTEGER s } — minimal lengths (trailing bytes: below).
// P-256 group order for the low-S check.
// ---------------------------------------------------------------------------

static const uint8_t N_BE[32] = {
    0xff, 0xff, 0xff, 0xff, 0x00, 0x00, 0x00, 0x00, 0xff, 0xff, 0xff,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xbc, 0xe6, 0xfa, 0xad, 0xa7, 0x17,
    0x9e, 0x84, 0xf3, 0xb9, 0xca, 0xc2, 0xfc, 0x63, 0x25, 0x51};

static const uint8_t HALF_N_BE[32] = {
    0x7f, 0xff, 0xff, 0xff, 0x80, 0x00, 0x00, 0x00, 0x7f, 0xff, 0xff,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xde, 0x73, 0x7d, 0x56, 0xd3, 0x8b,
    0xcf, 0x42, 0x79, 0xdc, 0xe5, 0x61, 0x7e, 0x31, 0x92, 0xa8};

// -1, 0, 1 for a < b, a == b, a > b over 32-byte big-endian words
static int cmp_be(const uint8_t* a, const uint8_t* b) {
  for (int i = 0; i < 32; i++) {
    if (a[i] < b[i]) return -1;
    if (a[i] > b[i]) return 1;
  }
  return 0;
}

static bool is_zero_be(const uint8_t* a) {
  for (int i = 0; i < 32; i++)
    if (a[i]) return false;
  return true;
}

// DER length parse mirroring fabric_tpu_torch/common/der.py _parse_length:
// short form, or minimal long form (no indefinite, no leading zeros,
// long form only for lengths >= 0x80). Returns false on malformed.
static bool parse_length(const uint8_t* buf, uint64_t len, uint64_t* pos,
                         uint64_t* out_len) {
  if (*pos >= len) return false;
  uint8_t b = buf[(*pos)++];
  if (!(b & 0x80)) {
    *out_len = b;
    return true;
  }
  uint64_t num = b & 0x7f;
  if (num == 0 || num > 8) return false;  // indefinite / absurd
  uint64_t value = 0;
  for (uint64_t i = 0; i < num; i++) {
    if (*pos >= len) return false;
    if (value >= (1ull << 23)) return false;
    value = (value << 8) | buf[(*pos)++];
    if (value == 0) return false;  // superfluous leading zero byte
  }
  if (value < 0x80) return false;  // non-minimal long form
  *out_len = value;
  return true;
}

// Parse one INTEGER at buf[*pos] within [.., end); write 32-byte BE
// value. Mirrors der.py _parse_int + the r>0 / range gates: rejects
// negative, non-minimal, zero, and values >= 2^256 (which could never
// pass the r,s < n check anyway).
static bool parse_int(const uint8_t* buf, uint64_t end, uint64_t* pos,
                      uint8_t out[32]) {
  if (*pos >= end) return false;
  if (buf[*pos] != 0x02) return false;
  (*pos)++;
  uint64_t ilen;
  if (!parse_length(buf, end, pos, &ilen)) return false;
  if (*pos + ilen > end || ilen == 0) return false;
  const uint8_t* p = buf + *pos;
  // negative => r/s <= 0 reject; non-minimal 0x00 prefix reject
  // (the 0xFF-prefix non-minimal case is already negative)
  if (p[0] & 0x80) return false;
  if (ilen > 1 && p[0] == 0x00 && !(p[1] & 0x80)) return false;
  uint64_t skip = (p[0] == 0x00) ? 1 : 0;
  uint64_t vlen = ilen - skip;
  if (vlen > 32) return false;
  std::memset(out, 0, 32);
  std::memcpy(out + (32 - vlen), p + skip, (size_t)vlen);
  *pos += ilen;
  return true;
}

// sigs: concatenated DER; offsets/lens per signature.
// out_r/out_s: n*32 bytes; out_ok[i]: 1 = well-formed; out_low_s[i]:
// 1 = s <= n/2 (callers reject high-S like the reference's IsLowS gate).
// Trailing bytes inside and after the SEQUENCE are tolerated, exactly
// like der.py unmarshal_signature (the Go asn1 quirk) — the two parsers
// MUST agree or peers with/without the native library diverge.
void fn_batch_der_parse(const uint8_t* sigs, const uint64_t* offsets,
                        const uint64_t* lens, int64_t n, uint8_t* out_r,
                        uint8_t* out_s, uint8_t* out_ok, uint8_t* out_low_s) {
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* buf = sigs + offsets[i];
    uint64_t len = lens[i];
    uint8_t* r = out_r + 32 * i;
    uint8_t* s = out_s + 32 * i;
    out_ok[i] = 0;
    out_low_s[i] = 0;
    if (len == 0 || buf[0] != 0x30) continue;
    uint64_t pos = 1;
    uint64_t seq_len;
    if (!parse_length(buf, len, &pos, &seq_len)) continue;
    uint64_t end = pos + seq_len;
    if (end > len) continue;  // sequence overruns input
    if (!parse_int(buf, end, &pos, r)) continue;
    if (!parse_int(buf, end, &pos, s)) continue;
    // 1 <= r,s < n
    if (is_zero_be(r) || is_zero_be(s)) continue;
    if (cmp_be(r, N_BE) >= 0 || cmp_be(s, N_BE) >= 0) continue;
    out_ok[i] = 1;
    out_low_s[i] = (cmp_be(s, HALF_N_BE) <= 0) ? 1 : 0;
  }
}

}  // extern "C"
