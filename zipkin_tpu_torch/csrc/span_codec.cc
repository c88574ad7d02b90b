// Native thrift-binary span parser → columnar arrays.
//
// Plays the role of scrooge's generated BinaryThriftStructSerializer on
// the reference's hot decode path (ScribeSpanReceiver.scala:96-107) —
// but emits structure-of-arrays output directly, so the host python
// layer only interns strings and uploads numpy arrays.
//
// Layout parsed: zipkinCore.thrift Span/Annotation/BinaryAnnotation/
// Endpoint (see zipkin_tpu/wire/thrift.py for the field table). Unknown
// fields are skipped. All output numeric columns are caller-allocated
// numpy arrays passed as raw pointers; strings come back as (offset,
// length) pairs into the input buffer.
//
// Build: g++ -O3 -shared -fPIC -o libzipkin_native.so span_codec.cc
// Entry points are exported with C linkage for ctypes.

#include <cstdint>
#include <cstring>

namespace {

constexpr int T_STOP = 0;
constexpr int T_BOOL = 2;
constexpr int T_BYTE = 3;
constexpr int T_DOUBLE = 4;
constexpr int T_I16 = 6;
constexpr int T_I32 = 8;
constexpr int T_I64 = 10;
constexpr int T_STRING = 11;
constexpr int T_STRUCT = 12;
constexpr int T_MAP = 13;
constexpr int T_SET = 14;
constexpr int T_LIST = 15;

struct Reader {
  const uint8_t* data;
  size_t len;
  size_t pos;
  bool ok;

  bool need(size_t n) {
    if (pos + n > len) { ok = false; return false; }
    return true;
  }
  uint8_t u8() { if (!need(1)) return 0; return data[pos++]; }
  int16_t i16() {
    if (!need(2)) return 0;
    int16_t v = (int16_t)((data[pos] << 8) | data[pos + 1]);
    pos += 2; return v;
  }
  int32_t i32() {
    if (!need(4)) return 0;
    uint32_t v = ((uint32_t)data[pos] << 24) | ((uint32_t)data[pos+1] << 16) |
                 ((uint32_t)data[pos+2] << 8) | (uint32_t)data[pos+3];
    pos += 4; return (int32_t)v;
  }
  int64_t i64() {
    if (!need(8)) return 0;
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | data[pos + i];
    pos += 8; return (int64_t)v;
  }
  // Returns offset of string payload; fills n.
  int64_t str(int32_t* n) {
    int32_t sz = i32();
    if (sz < 0 || !need((size_t)sz)) { ok = false; *n = 0; return 0; }
    int64_t off = (int64_t)pos;
    pos += (size_t)sz;
    *n = sz;
    return off;
  }
  // Depth-bounded: a crafted payload of deeply nested containers on the
  // network-facing ingest path must fail the parse, not blow the C stack.
  static constexpr int kMaxSkipDepth = 64;

  void skip(int t, int depth = 0) {
    if (depth > kMaxSkipDepth) { ok = false; return; }
    switch (t) {
      case T_BOOL: case T_BYTE: need(1); pos += 1; break;
      case T_I16: need(2); pos += 2; break;
      case T_I32: need(4); pos += 4; break;
      case T_I64: case T_DOUBLE: need(8); pos += 8; break;
      case T_STRING: { int32_t n; str(&n); break; }
      case T_STRUCT: {
        while (ok) {
          uint8_t ft = u8();
          if (ft == T_STOP) break;
          i16();
          skip(ft, depth + 1);
        }
        break;
      }
      case T_LIST: case T_SET: {
        uint8_t et = u8();
        int32_t n = i32();
        for (int32_t i = 0; i < n && ok; i++) skip(et, depth + 1);
        break;
      }
      case T_MAP: {
        uint8_t kt = u8(), vt = u8();
        int32_t n = i32();
        for (int32_t i = 0; i < n && ok; i++) {
          skip(kt, depth + 1); skip(vt, depth + 1);
        }
        break;
      }
      default: ok = false;
    }
  }
};

struct Endpoint {
  int32_t ipv4 = 0;
  int32_t port = 0;
  int64_t svc_off = 0;
  int32_t svc_len = -1;  // -1: no endpoint; -2: endpoint w/o service_name
};

Endpoint read_endpoint(Reader& r) {
  Endpoint ep;
  ep.svc_len = -2;
  while (r.ok) {
    uint8_t ft = r.u8();
    if (ft == T_STOP) break;
    int16_t fid = r.i16();
    if (fid == 1 && ft == T_I32) ep.ipv4 = r.i32();
    else if (fid == 2 && ft == T_I16) ep.port = (int32_t)(uint16_t)r.i16();
    else if (fid == 3 && ft == T_STRING) ep.svc_off = r.str(&ep.svc_len);
    else r.skip(ft);
  }
  return ep;
}

}  // namespace

// Output bundle: parallel arrays, caller-allocated. String columns are
// (off, len) into the input buffer; len -1 means absent.
extern "C" {

struct SpanColumns {
  // span table
  int64_t* trace_id;
  int64_t* span_id;
  int64_t* parent_id;
  uint8_t* has_parent;
  uint8_t* debug;
  int64_t* name_off;
  int32_t* name_len;
  // annotation table
  int32_t* ann_span_idx;
  int64_t* ann_ts;
  int64_t* ann_value_off;
  int32_t* ann_value_len;
  int32_t* ann_ipv4;
  int32_t* ann_port;
  int64_t* ann_svc_off;
  int32_t* ann_svc_len;  // -1: no host; -2: host w/o service_name
  // binary annotation table
  int32_t* bann_span_idx;
  int64_t* bann_key_off;
  int32_t* bann_key_len;
  int64_t* bann_value_off;
  int32_t* bann_value_len;
  int32_t* bann_type;
  int32_t* bann_ipv4;
  int32_t* bann_port;
  int64_t* bann_svc_off;
  int32_t* bann_svc_len;  // -1: no host; -2: host w/o service_name
};

// Parse a back-to-back sequence of thrift Span structs.
// Returns 0 on success, negative on error:
//   -1 malformed thrift   -2 span capacity   -3 ann capacity
//   -4 binary capacity
// Fills n_spans/n_anns/n_banns with the counts consumed.
int zk_parse_spans(
    const uint8_t* data, int64_t len,
    SpanColumns* out,
    int32_t max_spans, int32_t max_anns, int32_t max_banns,
    int32_t* n_spans, int32_t* n_anns, int32_t* n_banns) {
  Reader r{data, (size_t)len, 0, true};
  int32_t si = 0, ai = 0, bi = 0;
  while (r.pos < r.len) {
    if (si >= max_spans) return -2;
    int64_t trace_id = 0, span_id = 0, parent_id = 0;
    uint8_t has_parent = 0, debug = 0;
    int64_t name_off = 0;
    int32_t name_len = 0;
    while (r.ok) {
      uint8_t ft = r.u8();
      if (ft == T_STOP) break;
      int16_t fid = r.i16();
      if (fid == 1 && ft == T_I64) trace_id = r.i64();
      else if (fid == 3 && ft == T_STRING) name_off = r.str(&name_len);
      else if (fid == 4 && ft == T_I64) span_id = r.i64();
      else if (fid == 5 && ft == T_I64) { parent_id = r.i64(); has_parent = 1; }
      else if (fid == 9 && ft == T_BOOL) debug = r.u8() != 0;
      else if (fid == 6 && ft == T_LIST) {
        uint8_t et = r.u8();
        int32_t n = r.i32();
        if (et != T_STRUCT) return -1;
        for (int32_t i = 0; i < n && r.ok; i++) {
          if (ai >= max_anns) return -3;
          int64_t ts = 0, voff = 0;
          int32_t vlen = 0;
          Endpoint ep; ep.svc_len = -1;
          while (r.ok) {
            uint8_t aft = r.u8();
            if (aft == T_STOP) break;
            int16_t afid = r.i16();
            if (afid == 1 && aft == T_I64) ts = r.i64();
            else if (afid == 2 && aft == T_STRING) voff = r.str(&vlen);
            else if (afid == 3 && aft == T_STRUCT) ep = read_endpoint(r);
            else r.skip(aft);
          }
          out->ann_span_idx[ai] = si;
          out->ann_ts[ai] = ts;
          out->ann_value_off[ai] = voff;
          out->ann_value_len[ai] = vlen;
          out->ann_ipv4[ai] = ep.ipv4;
          out->ann_port[ai] = ep.port;
          out->ann_svc_off[ai] = ep.svc_off;
          out->ann_svc_len[ai] = ep.svc_len;
          ai++;
        }
      } else if (fid == 8 && ft == T_LIST) {
        uint8_t et = r.u8();
        int32_t n = r.i32();
        if (et != T_STRUCT) return -1;
        for (int32_t i = 0; i < n && r.ok; i++) {
          if (bi >= max_banns) return -4;
          int64_t koff = 0, voff = 0;
          int32_t klen = 0, vlen = 0, btype = 1;  // default BYTES
          Endpoint ep; ep.svc_len = -1;
          while (r.ok) {
            uint8_t bft = r.u8();
            if (bft == T_STOP) break;
            int16_t bfid = r.i16();
            if (bfid == 1 && bft == T_STRING) koff = r.str(&klen);
            else if (bfid == 2 && bft == T_STRING) voff = r.str(&vlen);
            else if (bfid == 3 && bft == T_I32) btype = r.i32();
            else if (bfid == 4 && bft == T_STRUCT) ep = read_endpoint(r);
            else r.skip(bft);
          }
          out->bann_span_idx[bi] = si;
          out->bann_key_off[bi] = koff;
          out->bann_key_len[bi] = klen;
          out->bann_value_off[bi] = voff;
          out->bann_value_len[bi] = vlen;
          out->bann_type[bi] = btype;
          out->bann_ipv4[bi] = ep.ipv4;
          out->bann_port[bi] = ep.port;
          out->bann_svc_off[bi] = ep.svc_off;
          out->bann_svc_len[bi] = ep.svc_len;
          bi++;
        }
      } else {
        r.skip(ft);
      }
    }
    if (!r.ok) return -1;
    out->trace_id[si] = trace_id;
    out->span_id[si] = span_id;
    out->parent_id[si] = parent_id;
    out->has_parent[si] = has_parent;
    out->debug[si] = debug;
    out->name_off[si] = name_off;
    out->name_len[si] = name_len;
    si++;
  }
  *n_spans = si;
  *n_anns = ai;
  *n_banns = bi;
  return 0;
}

// Content-dedup of string slices: assign each (offset, length) slice of
// ``buf`` a group id such that byte-identical slices share a group, and
// record one representative slice per group. The python layer then
// interns each UNIQUE string once and builds dictionary-id columns by
// vectorized lookup — removing the per-row intern loop from the hot
// decode (scrooge decodes each struct once; our dictionary encoding
// makes per-unique work the natural unit).
//
// Rows with len < 0 (absent field sentinels) get group -1.
// Open-addressing FNV-1a table sized to the next power of two >= 2n;
// returns the number of groups, or -1 if max_groups is exceeded.
int32_t zk_group_strings(
    const uint8_t* buf,
    const int64_t* offs, const int32_t* lens, int32_t n,
    int32_t* group_of,            // [n] out
    int64_t* rep_off, int32_t* rep_len,  // [max_groups] out
    int32_t max_groups) {
  if (n <= 0) return 0;
  uint32_t cap = 16;
  while (cap < (uint32_t)n * 2u) cap <<= 1;
  // slots hold group index + 1 (0 = empty).
  int32_t* slots = new int32_t[cap]();
  int32_t n_groups = 0;
  for (int32_t i = 0; i < n; i++) {
    int32_t len = lens[i];
    if (len < 0) { group_of[i] = -1; continue; }
    const uint8_t* s = buf + offs[i];
    uint64_t h = 1469598103934665603ull;  // FNV-1a 64
    for (int32_t k = 0; k < len; k++) h = (h ^ s[k]) * 1099511628211ull;
    uint32_t slot = (uint32_t)h & (cap - 1);
    for (;;) {
      int32_t g = slots[slot];
      if (g == 0) {
        if (n_groups >= max_groups) { delete[] slots; return -1; }
        rep_off[n_groups] = offs[i];
        rep_len[n_groups] = len;
        slots[slot] = n_groups + 1;
        group_of[i] = n_groups++;
        break;
      }
      int32_t gi = g - 1;
      if (rep_len[gi] == len &&
          memcmp(buf + rep_off[gi], s, (size_t)len) == 0) {
        group_of[i] = gi;
        break;
      }
      slot = (slot + 1) & (cap - 1);
    }
  }
  delete[] slots;
  return n_groups;
}

// Standard base64 decode (for scribe LogEntry payloads); returns output
// length or -1 on bad input. Skips whitespace; handles padding.
int64_t zk_base64_decode(const uint8_t* in, int64_t in_len, uint8_t* out) {
  static int8_t lut[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; i++) lut[i] = -1;
    const char* tbl =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    for (int i = 0; i < 64; i++) lut[(uint8_t)tbl[i]] = (int8_t)i;
    init = true;
  }
  uint32_t acc = 0;
  int bits = 0;
  int64_t o = 0;
  for (int64_t i = 0; i < in_len; i++) {
    uint8_t c = in[i];
    if (c == '=' || c == '\n' || c == '\r' || c == ' ') continue;
    int8_t v = lut[c];
    if (v < 0) return -1;
    acc = (acc << 6) | (uint32_t)v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out[o++] = (uint8_t)((acc >> bits) & 0xFF);
    }
  }
  return o;
}

}  // extern "C"
