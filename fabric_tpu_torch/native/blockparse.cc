// Native block-structure parser: the host-side hot loop of commit-time
// validation (reference core/common/validation/msgvalidation.go
// ValidateTransaction :248-330 plus the artifact extraction of
// core/handlers/validation/builtin/v20/validation_logic.go:109-177),
// executed over EVERY envelope of a block in one C++ pass.
//
// It re-implements exactly the protobuf WIRE semantics (google.protobuf's
// upb ParseFromString) that the port's Python path applies
// (fabric_tpu_torch/protos/wire.py, through ledger/txparse.py), verified
// by differential fuzzers (tests/test_torch_blockparse_native.py):
//   * unknown fields skipped (varint/64-bit/length-delimited/32-bit and
//     balanced groups); known field with mismatched wire type is
//     treated as unknown;
//   * repeated occurrences of a singular scalar field: last wins;
//     repeated occurrences of a singular MESSAGE field: merge
//     (sub-fields overwrite, repeated sub-fields append);
//   * string fields must be valid UTF-8 (strict: no surrogates, no
//     overlongs, <= U+10FFFF);
//   * varints are at most 10 bytes; truncation, field number 0 and wire
//     types 6/7 are parse errors; submessages are validated eagerly.
//
// Outputs are columnar arrays: per-tx validation codes + field slices
// (offsets into the caller's concatenated buffer), a flattened
// signature-job table with per-job SHA-256 digests (creator signature
// over the payload bytes; endorsement signatures over
// proposal_response_payload || endorser, statebased
// validator_keylevel.go:243-251), a deduplicated serialized-identity
// table, per-namespace write flags, and the written-keys table used by
// the state-based endorsement gate.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "sha256c.h"

namespace {

// TxValidationCode values (fabric-protos peer/transaction.proto).
enum Code : int32_t {
  OK = 254,  // NOT_VALIDATED: structurally valid, later phases decide
  NIL_ENVELOPE = 1,
  BAD_PAYLOAD = 2,
  BAD_COMMON_HEADER = 3,
  INVALID_ENDORSER_TRANSACTION = 5,
  BAD_PROPOSAL_TXID = 8,
  BAD_RESPONSE_PAYLOAD = 21,
  BAD_RWSET = 22,
  INVALID_OTHER_REASON = 255,
};

// common.proto HeaderType
enum : int32_t { HT_CONFIG = 1, HT_CONFIG_UPDATE = 2, HT_ENDORSER = 3 };

struct Slice {
  uint64_t off = 0;
  uint64_t len = 0;
};

struct Rd {
  const uint8_t* base;
  uint64_t pos, end;
};

bool rd_varint(Rd& r, uint64_t* v) {
  uint64_t result = 0;
  for (int i = 0; i < 10; i++) {
    if (r.pos >= r.end) return false;
    uint8_t b = r.base[r.pos++];
    result |= (uint64_t)(b & 0x7f) << (7 * i);
    if (!(b & 0x80)) {
      *v = result;
      return true;
    }
  }
  return false;  // 11+ byte varint
}

bool rd_tag(Rd& r, uint32_t* fn, uint32_t* wt) {
  uint64_t tag;
  if (!rd_varint(r, &tag)) return false;
  *fn = (uint32_t)(tag >> 3);
  *wt = (uint32_t)(tag & 7);
  // field number 1..2^29-1 (upb rejects 0 and anything larger)
  if (tag >> 3 == 0 || (tag >> 3) > 536870911ull) return false;
  return true;
}

bool rd_len_delim(Rd& r, Slice* s) {
  uint64_t len;
  if (!rd_varint(r, &len)) return false;
  if (len > r.end - r.pos) return false;
  s->off = r.pos;
  s->len = len;
  r.pos += len;
  return true;
}

bool skip_field(Rd& r, uint32_t fn, uint32_t wt, int depth) {
  switch (wt) {
    case 0: {
      uint64_t v;
      return rd_varint(r, &v);
    }
    case 1:
      if (r.end - r.pos < 8) return false;
      r.pos += 8;
      return true;
    case 2: {
      Slice s;
      return rd_len_delim(r, &s);
    }
    case 5:
      if (r.end - r.pos < 4) return false;
      r.pos += 4;
      return true;
    case 3: {  // group: skip until matching end-group tag
      // a group at nesting level d enters here with depth == d-1; reject
      // at level 101 exactly like python-protobuf (upb recursion limit
      // 100: 100-deep balanced groups parse, 101 raise DecodeError) so
      // native and fallback deployments accept identical envelopes
      if (depth > 99) return false;
      for (;;) {
        uint32_t f2, w2;
        if (!rd_tag(r, &f2, &w2)) return false;
        if (w2 == 4) return f2 == fn;
        if (!skip_field(r, f2, w2, depth + 1)) return false;
      }
    }
    default:
      return false;  // wt 4 unmatched, 6, 7
  }
}

// Structural validation for submessages with no string-typed fields
// (Timestamp, Version, QueryReadsMerkleSummary, ...): for those, upb
// acceptance == generic wire well-formedness.
bool validate_wire(const uint8_t* base, Slice s, int depth) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (!skip_field(r, f, w, depth)) return false;
  }
  return true;
}

// Strict UTF-8 (what upb enforces on proto3 string fields).
bool utf8_ok(const uint8_t* p, uint64_t len) {
  uint64_t i = 0;
  while (i < len) {
    uint8_t c = p[i];
    if (c < 0x80) {
      i++;
    } else if (c < 0xC2) {
      return false;  // bare continuation / overlong 2-byte
    } else if (c < 0xE0) {
      if (i + 1 >= len || (p[i + 1] & 0xC0) != 0x80) return false;
      i += 2;
    } else if (c < 0xF0) {
      if (i + 2 >= len) return false;
      uint8_t c1 = p[i + 1], c2 = p[i + 2];
      if ((c1 & 0xC0) != 0x80 || (c2 & 0xC0) != 0x80) return false;
      if (c == 0xE0 && c1 < 0xA0) return false;   // overlong
      if (c == 0xED && c1 >= 0xA0) return false;  // surrogate
      i += 3;
    } else if (c < 0xF5) {
      if (i + 3 >= len) return false;
      uint8_t c1 = p[i + 1], c2 = p[i + 2], c3 = p[i + 3];
      if ((c1 & 0xC0) != 0x80 || (c2 & 0xC0) != 0x80 || (c3 & 0xC0) != 0x80)
        return false;
      if (c == 0xF0 && c1 < 0x90) return false;   // overlong
      if (c == 0xF4 && c1 >= 0x90) return false;  // > U+10FFFF
      i += 4;
    } else {
      return false;
    }
  }
  return true;
}

bool utf8_slice(const uint8_t* base, Slice s) {
  return utf8_ok(base + s.off, s.len);
}

// ---------------------------------------------------------------------------
// Per-message walkers. Each returns false when upb ParseFromString on
// the same bytes would raise. "Merge" targets are passed by reference so
// a repeated singular-message occurrence continues filling the same
// logical struct (proto3 merge semantics).
// ---------------------------------------------------------------------------

struct Envelope {
  Slice payload, signature;
};

bool parse_envelope(const uint8_t* base, Slice s, Envelope* out) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 2) {
      if (!rd_len_delim(r, &out->payload)) return false;
    } else if (f == 2 && w == 2) {
      if (!rd_len_delim(r, &out->signature)) return false;
    } else if (!skip_field(r, f, w, 0)) {
      return false;
    }
  }
  return true;
}

struct Header {
  Slice channel_header, signature_header;
};

// Header sits one level below the Payload ParseFromString root
bool parse_header(const uint8_t* base, Slice s, Header* out) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 2) {
      if (!rd_len_delim(r, &out->channel_header)) return false;
    } else if (f == 2 && w == 2) {
      if (!rd_len_delim(r, &out->signature_header)) return false;
    } else if (!skip_field(r, f, w, 1)) {
      return false;
    }
  }
  return true;
}

struct Payload {
  bool has_header = false;
  Header header;
  Slice data;
};

bool parse_payload(const uint8_t* base, Slice s, Payload* out) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 2) {
      Slice hs;
      if (!rd_len_delim(r, &hs)) return false;
      if (!parse_header(base, hs, &out->header)) return false;
      out->has_header = true;
    } else if (f == 2 && w == 2) {
      if (!rd_len_delim(r, &out->data)) return false;
    } else if (!skip_field(r, f, w, 0)) {
      return false;
    }
  }
  return true;
}

struct ChannelHeader {
  int32_t type = 0;
  Slice channel_id, tx_id;
  uint64_t epoch = 0;
};

bool parse_channel_header(const uint8_t* base, Slice s, ChannelHeader* out) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 0) {
      uint64_t v;
      if (!rd_varint(r, &v)) return false;
      out->type = (int32_t)(uint32_t)v;
    } else if (f == 3 && w == 2) {  // Timestamp: eager submessage check
      Slice ts;
      if (!rd_len_delim(r, &ts)) return false;
      if (!validate_wire(base, ts, 1)) return false;
    } else if (f == 4 && w == 2) {
      if (!rd_len_delim(r, &out->channel_id)) return false;
      if (!utf8_slice(base, out->channel_id)) return false;
    } else if (f == 5 && w == 2) {
      if (!rd_len_delim(r, &out->tx_id)) return false;
      if (!utf8_slice(base, out->tx_id)) return false;
    } else if (f == 6 && w == 0) {
      if (!rd_varint(r, &out->epoch)) return false;
    } else if (!skip_field(r, f, w, 0)) {
      return false;
    }
  }
  return true;
}

struct SignatureHeader {
  Slice creator, nonce;
};

bool parse_signature_header(const uint8_t* base, Slice s,
                            SignatureHeader* out) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 2) {
      if (!rd_len_delim(r, &out->creator)) return false;
    } else if (f == 2 && w == 2) {
      if (!rd_len_delim(r, &out->nonce)) return false;
    } else if (!skip_field(r, f, w, 0)) {
      return false;
    }
  }
  return true;
}

struct TransactionAction {
  Slice header, payload;
};

bool parse_transaction_action(const uint8_t* base, Slice s,
                              TransactionAction* out) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 2) {
      if (!rd_len_delim(r, &out->header)) return false;
    } else if (f == 2 && w == 2) {
      if (!rd_len_delim(r, &out->payload)) return false;
    } else if (!skip_field(r, f, w, 1)) {
      return false;
    }
  }
  return true;
}

struct Transaction {
  std::vector<TransactionAction> actions;
};

bool parse_transaction_msg(const uint8_t* base, Slice s, Transaction* out) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 2) {
      Slice as;
      if (!rd_len_delim(r, &as)) return false;
      TransactionAction a;
      if (!parse_transaction_action(base, as, &a)) return false;
      out->actions.push_back(a);
    } else if (!skip_field(r, f, w, 0)) {
      return false;
    }
  }
  return true;
}

struct EndorsementMsg {
  Slice endorser, signature;
};

struct ChaincodeEndorsedAction {  // merge target across occurrences
  Slice prp;                      // proposal_response_payload
  std::vector<EndorsementMsg> endorsements;
};

bool parse_endorsed_action(const uint8_t* base, Slice s,
                           ChaincodeEndorsedAction* out) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 2) {
      if (!rd_len_delim(r, &out->prp)) return false;
    } else if (f == 2 && w == 2) {
      Slice es;
      if (!rd_len_delim(r, &es)) return false;
      EndorsementMsg e;
      Rd r2{base, es.off, es.off + es.len};
      while (r2.pos < r2.end) {
        uint32_t f2, w2;
        if (!rd_tag(r2, &f2, &w2)) return false;
        if (w2 == 4) return false;
        if (f2 == 1 && w2 == 2) {
          if (!rd_len_delim(r2, &e.endorser)) return false;
        } else if (f2 == 2 && w2 == 2) {
          if (!rd_len_delim(r2, &e.signature)) return false;
        } else if (!skip_field(r2, f2, w2, 2)) {
          return false;
        }
      }
      out->endorsements.push_back(e);
    } else if (!skip_field(r, f, w, 1)) {
      return false;
    }
  }
  return true;
}

struct ChaincodeActionPayload {
  Slice chaincode_proposal_payload;
  ChaincodeEndorsedAction action;  // proto3 merge across occurrences
};

bool parse_cap(const uint8_t* base, Slice s, ChaincodeActionPayload* out) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 2) {
      if (!rd_len_delim(r, &out->chaincode_proposal_payload)) return false;
    } else if (f == 2 && w == 2) {
      Slice as;
      if (!rd_len_delim(r, &as)) return false;
      if (!parse_endorsed_action(base, as, &out->action)) return false;
    } else if (!skip_field(r, f, w, 0)) {
      return false;
    }
  }
  return true;
}

struct ProposalResponsePayload {
  Slice proposal_hash, extension;
};

bool parse_prp(const uint8_t* base, Slice s, ProposalResponsePayload* out) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 2) {
      if (!rd_len_delim(r, &out->proposal_hash)) return false;
    } else if (f == 2 && w == 2) {
      if (!rd_len_delim(r, &out->extension)) return false;
    } else if (!skip_field(r, f, w, 0)) {
      return false;
    }
  }
  return true;
}

// Response { int32 status = 1; string message = 2; bytes payload = 3; }
bool validate_response(const uint8_t* base, Slice s) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 2 && w == 2) {
      Slice m;
      if (!rd_len_delim(r, &m)) return false;
      if (!utf8_slice(base, m)) return false;
    } else if (!skip_field(r, f, w, 1)) {
      return false;
    }
  }
  return true;
}

struct ChaincodeID {  // merge target
  Slice name;
};

bool parse_chaincode_id(const uint8_t* base, Slice s, ChaincodeID* out) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if ((f == 1 || f == 3) && w == 2) {  // path / version: utf8 only
      Slice v;
      if (!rd_len_delim(r, &v)) return false;
      if (!utf8_slice(base, v)) return false;
    } else if (f == 2 && w == 2) {
      if (!rd_len_delim(r, &out->name)) return false;
      if (!utf8_slice(base, out->name)) return false;
    } else if (!skip_field(r, f, w, 1)) {
      return false;
    }
  }
  return true;
}

struct ChaincodeAction {
  Slice results, events;
  bool has_chaincode_id = false;
  ChaincodeID chaincode_id;
};

bool parse_chaincode_action(const uint8_t* base, Slice s,
                            ChaincodeAction* out) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 2) {
      if (!rd_len_delim(r, &out->results)) return false;
    } else if (f == 2 && w == 2) {
      if (!rd_len_delim(r, &out->events)) return false;
    } else if (f == 3 && w == 2) {
      Slice resp;
      if (!rd_len_delim(r, &resp)) return false;
      if (!validate_response(base, resp)) return false;
    } else if (f == 4 && w == 2) {
      Slice cid;
      if (!rd_len_delim(r, &cid)) return false;
      if (!parse_chaincode_id(base, cid, &out->chaincode_id)) return false;
      out->has_chaincode_id = true;
    } else if (!skip_field(r, f, w, 0)) {
      return false;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// rwset tree walk: structural validation (what Python's eager
// parse_tx_rwset would accept) + namespace/write-key harvesting.
// ---------------------------------------------------------------------------

struct WKey {
  Slice coll;       // empty for public writes
  Slice key;        // public: string key; hashed: key_hash bytes
  uint8_t hashed;   // 1 = collection hashed write (bytes key)
};

struct NsEntry {
  Slice name;
  uint8_t writes = 0;  // txWritesToNamespace (dispatcher.go:174-218)
  std::vector<WKey> wkeys;
  bool has_md = false;
};

// KVRead { string key = 1; Version version = 2; }  `depth` = this
// message's nesting level below the enclosing python ParseFromString
// root (upb's recursion limit counts message levels AND group levels
// from that root, budget 100 — parity demands the native walker track
// the same accumulated depth, not restart at 0 per submessage).
bool validate_kvread(const uint8_t* base, Slice s, int depth) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 2) {
      Slice k;
      if (!rd_len_delim(r, &k)) return false;
      if (!utf8_slice(base, k)) return false;
    } else if (f == 2 && w == 2) {
      Slice v;
      if (!rd_len_delim(r, &v)) return false;
      if (!validate_wire(base, v, depth + 1)) return false;
    } else if (!skip_field(r, f, w, depth)) {
      return false;
    }
  }
  return true;
}

// KVMetadataWrite / KVMetadataWriteHash share shape:
// { key(1: string|bytes); repeated KVMetadataEntry entries = 2 }
// KVMetadataEntry { string name = 1; bytes value = 2; }
bool validate_md_write(const uint8_t* base, Slice s, bool key_is_string,
                       int depth) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 2) {
      Slice k;
      if (!rd_len_delim(r, &k)) return false;
      if (key_is_string && !utf8_slice(base, k)) return false;
    } else if (f == 2 && w == 2) {
      Slice e;
      if (!rd_len_delim(r, &e)) return false;
      Rd r2{base, e.off, e.off + e.len};
      while (r2.pos < r2.end) {
        uint32_t f2, w2;
        if (!rd_tag(r2, &f2, &w2)) return false;
        if (w2 == 4) return false;
        if (f2 == 1 && w2 == 2) {
          Slice nm;
          if (!rd_len_delim(r2, &nm)) return false;
          if (!utf8_slice(base, nm)) return false;
        } else if (!skip_field(r2, f2, w2, depth + 1)) {
          return false;
        }
      }
    } else if (!skip_field(r, f, w, depth)) {
      return false;
    }
  }
  return true;
}

// RangeQueryInfo { start/end(1,2: string); itr(3); raw_reads(4);
// reads_merkle_hashes(5) }
bool validate_rqi(const uint8_t* base, Slice s, int depth) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if ((f == 1 || f == 2) && w == 2) {
      Slice k;
      if (!rd_len_delim(r, &k)) return false;
      if (!utf8_slice(base, k)) return false;
    } else if (f == 4 && w == 2) {  // QueryReads { repeated KVRead = 1 }
      Slice q;
      if (!rd_len_delim(r, &q)) return false;
      Rd r2{base, q.off, q.off + q.len};
      while (r2.pos < r2.end) {
        uint32_t f2, w2;
        if (!rd_tag(r2, &f2, &w2)) return false;
        if (w2 == 4) return false;
        if (f2 == 1 && w2 == 2) {
          Slice kr;
          if (!rd_len_delim(r2, &kr)) return false;
          if (!validate_kvread(base, kr, depth + 2)) return false;
        } else if (!skip_field(r2, f2, w2, depth + 1)) {
          return false;
        }
      }
    } else if (f == 5 && w == 2) {  // merkle summary: no strings
      Slice m;
      if (!rd_len_delim(r, &m)) return false;
      if (!validate_wire(base, m, depth + 1)) return false;
    } else if (!skip_field(r, f, w, depth)) {
      return false;
    }
  }
  return true;
}

// KVRWSet { reads=1; range_queries_info=2; writes=3; metadata_writes=4 }
bool walk_kvrwset(const uint8_t* base, Slice s, NsEntry* ns) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 2) {
      Slice kr;
      if (!rd_len_delim(r, &kr)) return false;
      if (!validate_kvread(base, kr, 1)) return false;
    } else if (f == 2 && w == 2) {
      Slice q;
      if (!rd_len_delim(r, &q)) return false;
      if (!validate_rqi(base, q, 1)) return false;
    } else if (f == 3 && w == 2) {  // KVWrite { key=1; is_delete=2; value=3 }
      Slice ws;
      if (!rd_len_delim(r, &ws)) return false;
      Slice key{0, 0};
      Rd r2{base, ws.off, ws.off + ws.len};
      while (r2.pos < r2.end) {
        uint32_t f2, w2;
        if (!rd_tag(r2, &f2, &w2)) return false;
        if (w2 == 4) return false;
        if (f2 == 1 && w2 == 2) {
          if (!rd_len_delim(r2, &key)) return false;
          if (!utf8_slice(base, key)) return false;
        } else if (!skip_field(r2, f2, w2, 1)) {
          return false;
        }
      }
      ns->writes = 1;
      ns->wkeys.push_back(WKey{Slice{0, 0}, key, 0});
    } else if (f == 4 && w == 2) {
      Slice mw;
      if (!rd_len_delim(r, &mw)) return false;
      if (!validate_md_write(base, mw, true, 1)) return false;
      ns->writes = 1;
      ns->has_md = true;
    } else if (!skip_field(r, f, w, 0)) {
      return false;
    }
  }
  return true;
}

// HashedRWSet { hashed_reads=1; hashed_writes=2; metadata_writes=3 }
bool walk_hashed_rwset(const uint8_t* base, Slice s, Slice coll_name,
                       NsEntry* ns) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 1 && w == 2) {  // KVReadHash { key_hash=1; version=2 }
      Slice hr;
      if (!rd_len_delim(r, &hr)) return false;
      Rd r2{base, hr.off, hr.off + hr.len};
      while (r2.pos < r2.end) {
        uint32_t f2, w2;
        if (!rd_tag(r2, &f2, &w2)) return false;
        if (w2 == 4) return false;
        if (f2 == 2 && w2 == 2) {
          Slice v;
          if (!rd_len_delim(r2, &v)) return false;
          if (!validate_wire(base, v, 2)) return false;
        } else if (!skip_field(r2, f2, w2, 1)) {
          return false;
        }
      }
    } else if (f == 2 && w == 2) {  // KVWriteHash { key_hash=1 }
      Slice hw;
      if (!rd_len_delim(r, &hw)) return false;
      Slice key{0, 0};
      Rd r2{base, hw.off, hw.off + hw.len};
      while (r2.pos < r2.end) {
        uint32_t f2, w2;
        if (!rd_tag(r2, &f2, &w2)) return false;
        if (w2 == 4) return false;
        if (f2 == 1 && w2 == 2) {
          if (!rd_len_delim(r2, &key)) return false;
        } else if (!skip_field(r2, f2, w2, 1)) {
          return false;
        }
      }
      ns->writes = 1;
      ns->wkeys.push_back(WKey{coll_name, key, 1});
    } else if (f == 3 && w == 2) {
      Slice mw;
      if (!rd_len_delim(r, &mw)) return false;
      if (!validate_md_write(base, mw, false, 1)) return false;
      ns->writes = 1;
      ns->has_md = true;
    } else if (!skip_field(r, f, w, 0)) {
      return false;
    }
  }
  return true;
}

// TxReadWriteSet { data_model=1; repeated NsReadWriteSet ns_rwset=2 }
// NsReadWriteSet { namespace=1; rwset=2(KVRWSet bytes);
//                  repeated CollectionHashedReadWriteSet=3 }
bool walk_tx_rwset(const uint8_t* base, Slice s, std::vector<NsEntry>* out,
                   bool* has_md) {
  Rd r{base, s.off, s.off + s.len};
  while (r.pos < r.end) {
    uint32_t f, w;
    if (!rd_tag(r, &f, &w)) return false;
    if (w == 4) return false;
    if (f == 2 && w == 2) {
      Slice nss;
      if (!rd_len_delim(r, &nss)) return false;
      NsEntry ns;
      Slice kv{0, 0};
      struct Coll {
        Slice name, hashed;
      };
      std::vector<Coll> colls;
      Rd r2{base, nss.off, nss.off + nss.len};
      while (r2.pos < r2.end) {
        uint32_t f2, w2;
        if (!rd_tag(r2, &f2, &w2)) return false;
        if (w2 == 4) return false;
        if (f2 == 1 && w2 == 2) {
          if (!rd_len_delim(r2, &ns.name)) return false;
          if (!utf8_slice(base, ns.name)) return false;
        } else if (f2 == 2 && w2 == 2) {
          if (!rd_len_delim(r2, &kv)) return false;
        } else if (f2 == 3 && w2 == 2) {
          Slice cs;
          if (!rd_len_delim(r2, &cs)) return false;
          Coll c{{0, 0}, {0, 0}};
          Rd r3{base, cs.off, cs.off + cs.len};
          while (r3.pos < r3.end) {
            uint32_t f3, w3;
            if (!rd_tag(r3, &f3, &w3)) return false;
            if (w3 == 4) return false;
            if (f3 == 1 && w3 == 2) {
              if (!rd_len_delim(r3, &c.name)) return false;
              if (!utf8_slice(base, c.name)) return false;
            } else if (f3 == 2 && w3 == 2) {
              if (!rd_len_delim(r3, &c.hashed)) return false;
            } else if (!skip_field(r3, f3, w3, 2)) {
              return false;
            }
          }
          colls.push_back(c);
        } else if (!skip_field(r2, f2, w2, 1)) {
          return false;
        }
      }
      // final (merged) kv rwset + per-collection hashed walks
      if (!walk_kvrwset(base, kv, &ns)) return false;
      for (const Coll& c : colls) {
        if (!walk_hashed_rwset(base, c.hashed, c.name, &ns)) return false;
      }
      if (ns.has_md) *has_md = true;
      out->push_back(std::move(ns));
    } else if (!skip_field(r, f, w, 0)) {
      return false;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// Result container (opaque handle returned to Python).
// ---------------------------------------------------------------------------

struct BlockParseResult {
  int64_t n_txs;
  std::vector<int32_t> code, header_type;
  std::vector<uint8_t> has_md;
  std::vector<uint64_t> strs;  // n*12: chan, txid, creator, config, ns, results
  std::vector<int64_t> job_tx, job_ident;
  std::vector<uint8_t> job_is_creator;
  std::vector<uint64_t> job_sig, job_data;  // *2 (off, len)
  std::vector<uint8_t> job_digest;          // *32
  std::vector<uint64_t> uniq;               // *2
  std::vector<int64_t> ns_tx;
  std::vector<uint8_t> ns_writes;
  std::vector<uint64_t> ns_str;  // *2
  std::vector<int64_t> wk_tx, wk_ns;
  std::vector<uint8_t> wk_hashed;
  std::vector<uint64_t> wk_coll, wk_key;  // *2 each
};

struct SliceKey {
  const uint8_t* p;
  uint64_t len;
  bool operator==(const SliceKey& o) const {
    return len == o.len && std::memcmp(p, o.p, len) == 0;
  }
};

struct SliceKeyHash {
  size_t operator()(const SliceKey& k) const {
    // FNV-1a over the bytes
    uint64_t h = 1469598103934665603ull;
    for (uint64_t i = 0; i < k.len; i++) {
      h ^= k.p[i];
      h *= 1099511628211ull;
    }
    return (size_t)h;
  }
};

void hex32(const uint8_t d[32], char out[64]) {
  static const char* hexd = "0123456789abcdef";
  for (int i = 0; i < 32; i++) {
    out[2 * i] = hexd[d[i] >> 4];
    out[2 * i + 1] = hexd[d[i] & 0xf];
  }
}

}  // namespace

extern "C" {

void* fn_block_parse(const uint8_t* buf, const uint64_t* offs,
                     const uint64_t* lens, int64_t n_txs) {
  auto* res = new BlockParseResult();
  res->n_txs = n_txs;
  res->code.assign(n_txs, OK);
  res->header_type.assign(n_txs, -1);
  res->has_md.assign(n_txs, 0);
  res->strs.assign((size_t)n_txs * 12, 0);

  std::unordered_map<SliceKey, int64_t, SliceKeyHash> uniq_map;
  auto intern = [&](Slice s) -> int64_t {
    SliceKey k{buf + s.off, s.len};
    auto it = uniq_map.find(k);
    if (it != uniq_map.end()) return it->second;
    int64_t idx = (int64_t)uniq_map.size();
    uniq_map.emplace(k, idx);
    res->uniq.push_back(s.off);
    res->uniq.push_back(s.len);
    return idx;
  };

  for (int64_t i = 0; i < n_txs; i++) {
    Slice env_s{offs[i], lens[i]};
    uint64_t* strs = &res->strs[(size_t)i * 12];
    if (env_s.len == 0) {
      res->code[i] = NIL_ENVELOPE;
      continue;
    }
    Envelope env;
    if (!parse_envelope(buf, env_s, &env)) {
      res->code[i] = INVALID_OTHER_REASON;
      continue;
    }
    if (env.payload.len == 0) {
      res->code[i] = BAD_PAYLOAD;
      continue;
    }
    Payload payload;
    if (!parse_payload(buf, env.payload, &payload)) {
      res->code[i] = BAD_PAYLOAD;
      continue;
    }
    // validateCommonHeader (msgvalidation.go)
    if (!payload.has_header) {
      res->code[i] = BAD_COMMON_HEADER;
      continue;
    }
    ChannelHeader chdr;
    SignatureHeader shdr;
    if (!parse_channel_header(buf, payload.header.channel_header, &chdr) ||
        !parse_signature_header(buf, payload.header.signature_header, &shdr)) {
      res->code[i] = BAD_COMMON_HEADER;
      continue;
    }
    if ((chdr.type != HT_ENDORSER && chdr.type != HT_CONFIG &&
         chdr.type != HT_CONFIG_UPDATE) ||
        chdr.epoch != 0) {
      res->code[i] = BAD_COMMON_HEADER;
      continue;
    }
    if (shdr.nonce.len == 0 || shdr.creator.len == 0) {
      res->code[i] = BAD_COMMON_HEADER;
      continue;
    }
    res->header_type[i] = chdr.type;
    strs[0] = chdr.channel_id.off;
    strs[1] = chdr.channel_id.len;
    strs[2] = chdr.tx_id.off;
    strs[3] = chdr.tx_id.len;
    strs[4] = shdr.creator.off;
    strs[5] = shdr.creator.len;

    // creator signature job: env.Signature over env.Payload
    // (checkSignatureFromCreator, msgvalidation.go:284)
    {
      res->job_tx.push_back(i);
      res->job_ident.push_back(intern(shdr.creator));
      res->job_is_creator.push_back(1);
      res->job_sig.push_back(env.signature.off);
      res->job_sig.push_back(env.signature.len);
      res->job_data.push_back(env.payload.off);
      res->job_data.push_back(env.payload.len);
      uint8_t d[32];
      sha256c_oneshot(buf + env.payload.off, env.payload.len, d);
      res->job_digest.insert(res->job_digest.end(), d, d + 32);
    }

    if (chdr.type == HT_CONFIG) {
      strs[6] = payload.data.off;
      strs[7] = payload.data.len;
      continue;
    }
    if (chdr.type == HT_CONFIG_UPDATE) continue;

    // --- ENDORSER_TRANSACTION ---
    // TxID recompute: sha256(nonce || creator) hex (protoutil.CheckTxID)
    {
      ShaCtx c;
      sha256c_init(&c);
      sha256c_update(&c, buf + shdr.nonce.off, shdr.nonce.len);
      sha256c_update(&c, buf + shdr.creator.off, shdr.creator.len);
      uint8_t d[32];
      sha256c_final(&c, d);
      char hex[64];
      hex32(d, hex);
      if (chdr.tx_id.len != 64 ||
          std::memcmp(buf + chdr.tx_id.off, hex, 64) != 0) {
        res->code[i] = BAD_PROPOSAL_TXID;
        continue;
      }
    }
    Transaction tx;
    if (!parse_transaction_msg(buf, payload.data, &tx) ||
        tx.actions.size() != 1) {
      res->code[i] = INVALID_ENDORSER_TRANSACTION;
      continue;
    }
    const TransactionAction& action = tx.actions[0];
    SignatureHeader act_shdr;
    if (!parse_signature_header(buf, action.header, &act_shdr) ||
        act_shdr.nonce.len == 0 || act_shdr.creator.len == 0) {
      res->code[i] = INVALID_ENDORSER_TRANSACTION;
      continue;
    }
    ChaincodeActionPayload cap;
    ProposalResponsePayload prp;
    if (!parse_cap(buf, action.payload, &cap) ||
        !parse_prp(buf, cap.action.prp, &prp)) {
      res->code[i] = INVALID_ENDORSER_TRANSACTION;
      continue;
    }
    // proposal-hash binding: sha256(channel_header || action sig header
    // || chaincode proposal payload) == prp.proposal_hash
    // (GetProposalHash2, protoutil/txutils.go:431)
    {
      ShaCtx c;
      sha256c_init(&c);
      sha256c_update(&c, buf + payload.header.channel_header.off,
                     payload.header.channel_header.len);
      sha256c_update(&c, buf + action.header.off, action.header.len);
      sha256c_update(&c, buf + cap.chaincode_proposal_payload.off,
                     cap.chaincode_proposal_payload.len);
      uint8_t d[32];
      sha256c_final(&c, d);
      if (prp.proposal_hash.len != 32 ||
          std::memcmp(buf + prp.proposal_hash.off, d, 32) != 0) {
        res->code[i] = INVALID_ENDORSER_TRANSACTION;
        continue;
      }
    }
    ChaincodeAction cc_action;
    if (!parse_chaincode_action(buf, prp.extension, &cc_action)) {
      res->code[i] = BAD_RESPONSE_PAYLOAD;
      continue;
    }
    if (!cc_action.has_chaincode_id || cc_action.chaincode_id.name.len == 0) {
      res->code[i] = INVALID_OTHER_REASON;
      continue;
    }
    std::vector<NsEntry> ns_entries;
    bool has_md = false;
    if (!walk_tx_rwset(buf, cc_action.results, &ns_entries, &has_md)) {
      res->code[i] = BAD_RWSET;
      continue;
    }
    // fully valid endorser tx: commit artifacts + endorsement jobs
    strs[8] = cc_action.chaincode_id.name.off;
    strs[9] = cc_action.chaincode_id.name.len;
    strs[10] = cc_action.results.off;
    strs[11] = cc_action.results.len;
    res->has_md[i] = has_md ? 1 : 0;
    for (NsEntry& ns : ns_entries) {
      int64_t ns_idx = (int64_t)res->ns_tx.size();
      res->ns_tx.push_back(i);
      res->ns_writes.push_back(ns.writes);
      res->ns_str.push_back(ns.name.off);
      res->ns_str.push_back(ns.name.len);
      for (const WKey& wk : ns.wkeys) {
        res->wk_tx.push_back(i);
        res->wk_ns.push_back(ns_idx);
        res->wk_hashed.push_back(wk.hashed);
        res->wk_coll.push_back(wk.coll.off);
        res->wk_coll.push_back(wk.coll.len);
        res->wk_key.push_back(wk.key.off);
        res->wk_key.push_back(wk.key.len);
      }
    }
    for (const EndorsementMsg& e : cap.action.endorsements) {
      res->job_tx.push_back(i);
      res->job_ident.push_back(intern(e.endorser));
      res->job_is_creator.push_back(0);
      res->job_sig.push_back(e.signature.off);
      res->job_sig.push_back(e.signature.len);
      res->job_data.push_back(cap.action.prp.off);
      res->job_data.push_back(cap.action.prp.len);
      // endorsement verifies over prp_bytes || endorser
      // (validator_keylevel.go:243-251)
      ShaCtx c;
      sha256c_init(&c);
      sha256c_update(&c, buf + cap.action.prp.off, cap.action.prp.len);
      sha256c_update(&c, buf + e.endorser.off, e.endorser.len);
      uint8_t d[32];
      sha256c_final(&c, d);
      res->job_digest.insert(res->job_digest.end(), d, d + 32);
    }
  }
  return res;
}

void fn_block_counts(const void* h, int64_t* out) {
  const auto* r = static_cast<const BlockParseResult*>(h);
  out[0] = (int64_t)r->job_tx.size();
  out[1] = (int64_t)(r->uniq.size() / 2);
  out[2] = (int64_t)r->ns_tx.size();
  out[3] = (int64_t)r->wk_tx.size();
}

void fn_block_pertx(const void* h, int32_t* code, int32_t* header_type,
                    uint8_t* has_md, uint64_t* strs) {
  const auto* r = static_cast<const BlockParseResult*>(h);
  std::memcpy(code, r->code.data(), r->code.size() * sizeof(int32_t));
  std::memcpy(header_type, r->header_type.data(),
              r->header_type.size() * sizeof(int32_t));
  std::memcpy(has_md, r->has_md.data(), r->has_md.size());
  std::memcpy(strs, r->strs.data(), r->strs.size() * sizeof(uint64_t));
}

void fn_block_jobs(const void* h, int64_t* job_tx, int64_t* job_ident,
                   uint8_t* job_is_creator, uint64_t* job_sig,
                   uint64_t* job_data, uint8_t* job_digest) {
  const auto* r = static_cast<const BlockParseResult*>(h);
  std::memcpy(job_tx, r->job_tx.data(), r->job_tx.size() * sizeof(int64_t));
  std::memcpy(job_ident, r->job_ident.data(),
              r->job_ident.size() * sizeof(int64_t));
  std::memcpy(job_is_creator, r->job_is_creator.data(),
              r->job_is_creator.size());
  std::memcpy(job_sig, r->job_sig.data(),
              r->job_sig.size() * sizeof(uint64_t));
  std::memcpy(job_data, r->job_data.data(),
              r->job_data.size() * sizeof(uint64_t));
  std::memcpy(job_digest, r->job_digest.data(), r->job_digest.size());
}

void fn_block_uniq(const void* h, uint64_t* uniq) {
  const auto* r = static_cast<const BlockParseResult*>(h);
  std::memcpy(uniq, r->uniq.data(), r->uniq.size() * sizeof(uint64_t));
}

void fn_block_ns(const void* h, int64_t* ns_tx, uint8_t* ns_writes,
                 uint64_t* ns_str) {
  const auto* r = static_cast<const BlockParseResult*>(h);
  std::memcpy(ns_tx, r->ns_tx.data(), r->ns_tx.size() * sizeof(int64_t));
  std::memcpy(ns_writes, r->ns_writes.data(), r->ns_writes.size());
  std::memcpy(ns_str, r->ns_str.data(), r->ns_str.size() * sizeof(uint64_t));
}

void fn_block_wkeys(const void* h, int64_t* wk_tx, int64_t* wk_ns,
                    uint8_t* wk_hashed, uint64_t* wk_coll, uint64_t* wk_key) {
  const auto* r = static_cast<const BlockParseResult*>(h);
  std::memcpy(wk_tx, r->wk_tx.data(), r->wk_tx.size() * sizeof(int64_t));
  std::memcpy(wk_ns, r->wk_ns.data(), r->wk_ns.size() * sizeof(int64_t));
  std::memcpy(wk_hashed, r->wk_hashed.data(), r->wk_hashed.size());
  std::memcpy(wk_coll, r->wk_coll.data(),
              r->wk_coll.size() * sizeof(uint64_t));
  std::memcpy(wk_key, r->wk_key.data(), r->wk_key.size() * sizeof(uint64_t));
}

void fn_block_free(void* h) { delete static_cast<BlockParseResult*>(h); }

int fn_sha256_backend() { return sha256c_backend(); }

}  // extern "C"
