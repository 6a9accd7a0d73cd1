// zkstark_tpu native runtime: SHA-256, Fiat-Shamir channel, and a fully
// independent proof verifier.
//
// The reference's native surface is its Rust crate plus two native dependency
// crates: num-modular (Montgomery F_p arithmetic, field.rs:2) and sha2
// (merkle.rs:1, channel.rs:4), with bincode framing (channel.rs:20). This
// library is the framework's host-runtime equivalent: the serial channel
// spine and the verifier's point checks are scalar host work (the wrong shape
// for a vector device), so they live here in C++, exposed to Python over a C
// ABI via ctypes. The verifier is a from-scratch twin of proof.rs:15-149
// semantics (with challenge replay, which the reference omits) and serves as
// the independent cross-check of the Python verifier and the prover's bytes.
//
// Build: make -C native   (produces libzkstark_native.so)

#include <cstdint>
#include <cstring>
#include <cstdio>

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4), scalar
// ---------------------------------------------------------------------------

namespace sha256 {

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

struct Ctx {
  uint32_t h[8];
  uint8_t buf[64];
  uint64_t total;
  size_t fill;
};

static void init(Ctx &c) {
  static const uint32_t H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                 0xa54ff53a, 0x510e527f, 0x9b05688c,
                                 0x1f83d9ab, 0x5be0cd19};
  memcpy(c.h, H0, sizeof(H0));
  c.total = 0;
  c.fill = 0;
}

static void compress(Ctx &c, const uint8_t *p) {
  uint32_t w[64];
  for (int t = 0; t < 16; t++)
    w[t] = (uint32_t(p[4 * t]) << 24) | (uint32_t(p[4 * t + 1]) << 16) |
           (uint32_t(p[4 * t + 2]) << 8) | uint32_t(p[4 * t + 3]);
  for (int t = 16; t < 64; t++) {
    uint32_t s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3);
    uint32_t s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10);
    w[t] = w[t - 16] + s0 + w[t - 7] + s1;
  }
  uint32_t a = c.h[0], b = c.h[1], cc = c.h[2], d = c.h[3], e = c.h[4],
           f = c.h[5], g = c.h[6], h = c.h[7];
  for (int t = 0; t < 64; t++) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + K[t] + w[t];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & cc) ^ (b & cc);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = cc; cc = b; b = a; a = t1 + t2;
  }
  c.h[0] += a; c.h[1] += b; c.h[2] += cc; c.h[3] += d;
  c.h[4] += e; c.h[5] += f; c.h[6] += g; c.h[7] += h;
}

static void update(Ctx &c, const uint8_t *data, size_t len) {
  c.total += len;
  while (len) {
    size_t take = 64 - c.fill;
    if (take > len) take = len;
    memcpy(c.buf + c.fill, data, take);
    c.fill += take;
    data += take;
    len -= take;
    if (c.fill == 64) {
      compress(c, c.buf);
      c.fill = 0;
    }
  }
}

static void final(Ctx &c, uint8_t out[32]) {
  uint64_t bits = c.total * 8;
  uint8_t pad = 0x80;
  update(c, &pad, 1);
  uint8_t zero = 0;
  while (c.fill != 56) update(c, &zero, 1);
  uint8_t lenb[8];
  for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bits >> (56 - 8 * i));
  update(c, lenb, 8);
  for (int i = 0; i < 8; i++) {
    out[4 * i] = uint8_t(c.h[i] >> 24);
    out[4 * i + 1] = uint8_t(c.h[i] >> 16);
    out[4 * i + 2] = uint8_t(c.h[i] >> 8);
    out[4 * i + 3] = uint8_t(c.h[i]);
  }
}

static void digest(const uint8_t *data, size_t len, uint8_t out[32]) {
  Ctx c;
  init(c);
  update(c, data, len);
  final(c, out);
}

}  // namespace sha256

// ---------------------------------------------------------------------------
// F_p scalar arithmetic, p = 3*2^30 + 1
// ---------------------------------------------------------------------------

namespace field {

// The protocol prime — a RUNTIME parameter (zk_verify) mirroring the
// reference's Gf<const P: u32> genericity (field.rs:8); defaults to the
// stark-101 field (main.rs:13). Set once at the top of each zk_verify call
// (the library is not re-entrant across concurrent verifies with DIFFERENT
// primes; all other state is per-call).
static uint64_t P = 3221225473ULL;

static inline uint64_t mulmod(uint64_t a, uint64_t b) { return a * b % P; }

static uint64_t powmod(uint64_t b, uint64_t e) {
  uint64_t r = 1;
  b %= P;
  while (e) {
    if (e & 1) r = mulmod(r, b);
    b = mulmod(b, b);
    e >>= 1;
  }
  return r;
}

static inline uint64_t inv(uint64_t a) { return powmod(a, P - 2); }
static inline uint64_t sub(uint64_t a, uint64_t b) { return (a + P - b % P) % P; }

// Smallest multiplicative generator of F_P^* by the reference's trial
// algorithm (field.rs:52-86): unique prime factors q of P-1 via trial
// division, first x >= 2 with x^((P-1)/q) != 1 for all q.
static uint64_t find_generator() {
  uint64_t m = P - 1;
  uint64_t factors[16];
  size_t nf = 0;
  for (uint64_t q = 2; q * q <= m && nf < 16; q += (q == 2 ? 1 : 2)) {
    if (m % q == 0) {
      factors[nf++] = q;
      while (m % q == 0) m /= q;
    }
  }
  if (m > 1 && nf < 16) factors[nf++] = m;
  for (uint64_t x = 2;; x++) {
    bool ok = true;
    for (size_t i = 0; i < nf; i++)
      if (powmod(x, (P - 1) / factors[i]) == 1) { ok = false; break; }
    if (ok) return x;
  }
}

}  // namespace field

// ---------------------------------------------------------------------------
// Fiat-Shamir channel (channel.rs:6-37 semantics)
// ---------------------------------------------------------------------------

extern "C" {

// state = SHA256(state || payload)
void zk_channel_commit(uint8_t state[32], const uint8_t *payload, size_t len) {
  sha256::Ctx c;
  sha256::init(c);
  sha256::update(c, state, 32);
  sha256::update(c, payload, len);
  sha256::final(c, state);
}

// draw = BE(state[0..4]); self-commit the LE-serialized draw; return draw.
uint32_t zk_channel_draw(uint8_t state[32]) {
  uint32_t draw = (uint32_t(state[0]) << 24) | (uint32_t(state[1]) << 16) |
                  (uint32_t(state[2]) << 8) | uint32_t(state[3]);
  uint8_t le[4] = {uint8_t(draw), uint8_t(draw >> 8), uint8_t(draw >> 16),
                   uint8_t(draw >> 24)};
  zk_channel_commit(state, le, 4);
  return draw;
}

// Batch SHA-256: n independent 4-byte big-endian u32 leaf hashes (merkle.rs:30).
void zk_leaf_hashes(const uint32_t *values, size_t n, uint8_t *out) {
  for (size_t i = 0; i < n; i++) {
    uint8_t be[4] = {uint8_t(values[i] >> 24), uint8_t(values[i] >> 16),
                     uint8_t(values[i] >> 8), uint8_t(values[i])};
    sha256::digest(be, 4, out + 32 * i);
  }
}

// One Merkle level: out[i] = SHA256(left_i || right_i) over 2n input hashes.
void zk_node_hashes(const uint8_t *children, size_t n_pairs, uint8_t *out) {
  for (size_t i = 0; i < n_pairs; i++)
    sha256::digest(children + 64 * i, 64, out + 32 * i);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Transcript reader (bincode 1.3 fixint-LE framing, channel.rs:20)
// ---------------------------------------------------------------------------

namespace {

struct Reader {
  const uint8_t *p;
  size_t len, pos;
  bool fail = false;

  const uint8_t *take(size_t n) {
    if (pos + n > len) {
      fail = true;
      return nullptr;
    }
    const uint8_t *r = p + pos;
    pos += n;
    return r;
  }
  uint32_t u32() {
    const uint8_t *b = take(4);
    if (!b) return 0;
    return uint32_t(b[0]) | (uint32_t(b[1]) << 8) | (uint32_t(b[2]) << 16) |
           (uint32_t(b[3]) << 24);
  }
  uint64_t u64() {
    const uint8_t *b = take(8);
    if (!b) return 0;
    uint64_t v = 0;
    for (int i = 7; i >= 0; i--) v = (v << 8) | b[i];
    return v;
  }
};

static bool compute_root_from_path(uint32_t element, size_t index,
                                   const uint8_t *path, size_t path_len,
                                   uint8_t out[32]) {
  // merkle.rs:82-110 semantics: hash BE(u32), then fold siblings by parity.
  uint8_t be[4] = {uint8_t(element >> 24), uint8_t(element >> 16),
                   uint8_t(element >> 8), uint8_t(element)};
  uint8_t cur[32];
  sha256::digest(be, 4, cur);
  for (size_t level = 0; level < path_len; level++) {
    uint8_t cat[64];
    const uint8_t *sib = path + 32 * level;
    if (index & 1) {
      memcpy(cat, sib, 32);
      memcpy(cat + 32, cur, 32);
    } else {
      memcpy(cat, cur, 32);
      memcpy(cat + 32, sib, 32);
    }
    sha256::digest(cat, 64, cur);
    index >>= 1;
  }
  memcpy(out, cur, 32);
  return true;
}

struct Replay {
  Reader r;
  uint8_t state[32];

  void absorb(const uint8_t *payload, size_t n) {
    zk_channel_commit(state, payload, n);
  }
  const uint8_t *hash32() {
    const uint8_t *h = r.take(32);
    if (h) absorb(h, 32);
    return h;
  }
  uint32_t u32_absorb() {
    size_t at = r.pos;
    uint32_t v = r.u32();
    if (!r.fail) absorb(r.p + at, 4);
    return v;
  }
  // self-committed challenge: value must equal BE(state[0..4]) pre-absorb
  bool expect_u32(uint32_t *out) {
    uint32_t expected = (uint32_t(state[0]) << 24) | (uint32_t(state[1]) << 16) |
                        (uint32_t(state[2]) << 8) | uint32_t(state[3]);
    uint32_t v = u32_absorb();
    if (r.fail || v != expected) return false;
    *out = v;
    return true;
  }
  // (u32, AuthPath): absorbed as one commit (prover.rs:274-277)
  bool opening(uint32_t *val, const uint8_t **path, size_t *path_len) {
    size_t at = r.pos;
    *val = r.u32();
    uint64_t n = r.u64();
    if (r.fail || n > 64) return false;
    *path = r.take(size_t(n) * 32);
    if (r.fail) return false;
    *path_len = size_t(n);
    absorb(r.p + at, r.pos - at);
    return true;
  }
  bool fri_opening(uint32_t *v0, uint32_t *v1, const uint8_t **p0, size_t *l0,
                   const uint8_t **p1, size_t *l1) {
    size_t at = r.pos;
    *v0 = r.u32();
    *v1 = r.u32();
    uint64_t n0 = r.u64();
    if (r.fail || n0 > 64) return false;
    *p0 = r.take(size_t(n0) * 32);
    uint64_t n1 = r.u64();
    if (r.fail || n1 > 64) return false;
    *p1 = r.take(size_t(n1) * 32);
    if (r.fail) return false;
    *l0 = size_t(n0);
    *l1 = size_t(n1);
    absorb(r.p + at, r.pos - at);
    return true;
  }
};

static void seterr(char *err, size_t cap, const char *msg) {
  if (err && cap) snprintf(err, cap, "%s", msg);
}

}  // namespace

// ---------------------------------------------------------------------------
// AIR constraint system (deserialized from protocol/air.py serialize_air)
// ---------------------------------------------------------------------------

namespace airdesc {

// RPN opcodes — keep in sync with protocol/air.py (OP_F … OP_MUL)
enum { OP_F = 0, OP_X = 1, OP_CONST = 2, OP_ADD = 3, OP_SUB = 4, OP_MUL = 5 };

constexpr size_t MAX_SHIFTS = 16;
constexpr size_t MAX_CONSTRAINTS = 32;
constexpr size_t MAX_EXEMPT = 16;
constexpr size_t MAX_PROG = 256;

struct Constraint {
  bool boundary;
  // boundary
  uint64_t step, value;
  // transition
  size_t n_exempt;
  uint64_t exempt[MAX_EXEMPT];
  size_t n_ops;
  uint32_t ops[MAX_PROG][2];
};

struct Air {
  size_t n_shifts;
  uint32_t shifts[MAX_SHIFTS];
  size_t n_constraints;
  Constraint cons[MAX_CONSTRAINTS];
  uint32_t max_shift;
  int shift0;  // index of shift 0 in shifts (boundary constraints read f(x))
};

// Parse the flat uint32 blob: [n_shifts, shifts…, n_constraints] then per
// constraint [0, step, value] or [1, n_exempt, exempt…, n_ops, (op,arg)…].
static bool parse(const uint32_t *w, size_t len, Air &air) {
  size_t pos = 0;
  auto next = [&](uint32_t *out) {
    if (pos >= len) return false;
    *out = w[pos++];
    return true;
  };
  uint32_t v;
  if (!next(&v) || v == 0 || v > MAX_SHIFTS) return false;
  air.n_shifts = v;
  air.max_shift = 0;
  air.shift0 = -1;
  for (size_t i = 0; i < air.n_shifts; i++) {
    if (!next(&air.shifts[i])) return false;
    if (air.shifts[i] > air.max_shift) air.max_shift = air.shifts[i];
    if (air.shifts[i] == 0) air.shift0 = int(i);
  }
  if (air.shift0 < 0) return false;
  if (!next(&v) || v == 0 || v > MAX_CONSTRAINTS) return false;
  air.n_constraints = v;
  for (size_t c = 0; c < air.n_constraints; c++) {
    Constraint &con = air.cons[c];
    uint32_t kind;
    if (!next(&kind)) return false;
    if (kind == 0) {
      con.boundary = true;
      uint32_t step, value;
      if (!next(&step) || !next(&value)) return false;
      con.step = step;
      con.value = value;
    } else if (kind == 1) {
      con.boundary = false;
      if (!next(&v) || v > MAX_EXEMPT) return false;
      con.n_exempt = v;
      for (size_t e = 0; e < con.n_exempt; e++) {
        uint32_t ex;
        if (!next(&ex)) return false;
        con.exempt[e] = ex;
      }
      if (!next(&v) || v == 0 || v > MAX_PROG) return false;
      con.n_ops = v;
      for (size_t o = 0; o < con.n_ops; o++)
        if (!next(&con.ops[o][0]) || !next(&con.ops[o][1])) return false;
    } else {
      return false;
    }
  }
  return pos == len;
}

// Evaluate a transition numerator's RPN program with exact field scalars.
static bool eval_program(const Constraint &con, const uint64_t *f_vals,
                         uint64_t x, uint64_t *out) {
  using namespace field;
  uint64_t stack[MAX_PROG];
  size_t sp = 0;
  for (size_t i = 0; i < con.n_ops; i++) {
    uint32_t op = con.ops[i][0], arg = con.ops[i][1];
    switch (op) {
      case OP_F:
        if (sp >= MAX_PROG) return false;
        stack[sp++] = f_vals[arg];
        break;
      case OP_X:
        if (sp >= MAX_PROG) return false;
        stack[sp++] = x;
        break;
      case OP_CONST:
        if (sp >= MAX_PROG) return false;
        stack[sp++] = arg % P;
        break;
      case OP_ADD:
      case OP_SUB:
      case OP_MUL: {
        if (sp < 2) return false;
        uint64_t b = stack[--sp];
        uint64_t a = stack[--sp];
        stack[sp++] = (op == OP_ADD)   ? (a + b) % P
                      : (op == OP_SUB) ? sub(a, b)
                                       : mulmod(a, b);
        break;
      }
      default:
        return false;
    }
  }
  if (sp != 1) return false;
  *out = stack[0];
  return true;
}

}  // namespace airdesc

// ---------------------------------------------------------------------------
// Independent verifier (proof.rs:15-149 semantics + challenge replay,
// generalized to a pluggable AIR and n_queries)
// ---------------------------------------------------------------------------

extern "C" {

// Returns 0 on success; nonzero error code with message in err.
// Config mirrors StarkConfig (protocol/config.py); `air_blob`/`air_len` is
// the uint32 constraint-system description from protocol/air.py
// serialize_air() — one constraint definition shared with prover + verifier.
int zk_verify(const uint8_t *final_state, const uint8_t *data, size_t data_len,
              uint32_t trace_len, uint32_t blowup, uint32_t coset_offset,
              uint32_t n_queries, uint32_t prime, const uint32_t *air_blob,
              size_t air_len, char *err, size_t err_cap) {
  using namespace field;
  if (prime < 3 || (prime & 1) == 0) {
    seterr(err, err_cap, "bad prime");
    return 7;
  }
  field::P = prime;
  airdesc::Air air;
  if (!airdesc::parse(air_blob, air_len, air)) {
    seterr(err, err_cap, "malformed AIR description");
    return 7;
  }
  if (n_queries == 0 || n_queries > 1024) {
    seterr(err, err_cap, "bad query count");
    return 7;
  }
  const uint64_t n = uint64_t(trace_len) + 1;          // trace domain
  const uint64_t d = n * blowup;                       // eval domain
  // fri_rounds = log2(n)
  uint32_t rounds = 0;
  for (uint64_t t = n; t > 1; t >>= 1) rounds++;
  const uint64_t query_range = d - uint64_t(air.max_shift) * blowup;

  Replay ch{};
  ch.r = Reader{data, data_len, 0};
  memset(ch.state, 0, 32);

  // ---- parse + replay ----
  const uint8_t *f_root = ch.hash32();
  uint64_t alphas[airdesc::MAX_CONSTRAINTS];
  for (size_t i = 0; i < air.n_constraints; i++) {
    uint32_t a;
    if (!ch.expect_u32(&a)) {
      seterr(err, err_cap, "alpha challenge replay mismatch");
      return 2;
    }
    alphas[i] = a % P;
  }
  // roots[0] = cp root; betas[0] unused dummy (proof.rs:27)
  const size_t max_rounds = 40;
  if (rounds > max_rounds) {
    seterr(err, err_cap, "too many FRI rounds");
    return 1;
  }
  const uint8_t *roots[max_rounds + 1];
  uint32_t betas[max_rounds + 1];
  betas[0] = 0;
  roots[0] = ch.hash32();
  for (uint32_t i = 1; i <= rounds; i++) {
    if (!ch.expect_u32(&betas[i])) {
      seterr(err, err_cap, "beta challenge replay mismatch");
      return 2;
    }
    roots[i] = ch.hash32();
  }
  uint32_t free_term = ch.u32_absorb();
  // all query draws precede the openings (prover.rs:263 generalized)
  const size_t max_queries = 1024;
  uint32_t query_raw[max_queries];
  for (uint32_t q = 0; q < n_queries; q++)
    if (!ch.expect_u32(&query_raw[q])) {
      seterr(err, err_cap, "query challenge replay mismatch");
      return 2;
    }

  if (ch.r.fail || !f_root) {  // a nullptr root must never reach memcmp
    seterr(err, err_cap, "transcript truncated");
    return 1;
  }

  const size_t n_open = air.n_shifts + 1;  // f(g^k·x) per shift, then cp0(x)
  const uint64_t inv2 = inv(2);
  const uint64_t gen = find_generator();  // field.rs:52-86 (5 for stark-101)
  const uint64_t g = powmod(gen, (P - 1) / n);
  const uint64_t h = powmod(gen, (P - 1) / d);

  for (uint32_t q = 0; q < n_queries; q++) {
    uint32_t trace_vals[airdesc::MAX_SHIFTS + 1];
    const uint8_t *trace_paths[airdesc::MAX_SHIFTS + 1];
    size_t trace_plens[airdesc::MAX_SHIFTS + 1];
    for (size_t i = 0; i < n_open; i++)
      if (!ch.opening(&trace_vals[i], &trace_paths[i], &trace_plens[i])) {
        seterr(err, err_cap, "bad trace opening");
        return 1;
      }
    uint32_t fv0[max_rounds], fv1[max_rounds];
    const uint8_t *fp0[max_rounds], *fp1[max_rounds];
    size_t fl0[max_rounds], fl1[max_rounds];
    for (uint32_t i = 0; i < rounds; i++)
      if (!ch.fri_opening(&fv0[i], &fv1[i], &fp0[i], &fl0[i], &fp1[i],
                          &fl1[i])) {
        seterr(err, err_cap, "bad FRI opening");
        return 1;
      }

    const uint64_t test_point = query_raw[q] % query_range;
    const uint64_t x = mulmod(coset_offset, powmod(h, test_point));

    // ---- composition identity (proof.rs:63-77), AIR-driven ----
    {
      uint64_t f_vals[airdesc::MAX_SHIFTS];
      for (size_t i = 0; i < air.n_shifts; i++) f_vals[i] = trace_vals[i] % P;
      uint64_t cp0 = 0;
      for (size_t c = 0; c < air.n_constraints; c++) {
        const airdesc::Constraint &con = air.cons[c];
        uint64_t num, den;
        if (con.boundary) {
          num = sub(f_vals[air.shift0], con.value % P);
          den = sub(x, powmod(g, con.step));
        } else {
          if (!airdesc::eval_program(con, f_vals, x, &num)) {
            seterr(err, err_cap, "bad constraint program");
            return 7;
          }
          uint64_t prod = 1;
          for (size_t e = 0; e < con.n_exempt; e++)
            prod = mulmod(prod, sub(x, powmod(g, con.exempt[e])));
          den = mulmod(sub(powmod(x, n), 1), inv(prod));
        }
        cp0 = (cp0 + mulmod(mulmod(alphas[c], num), inv(den))) % P;
      }
      if (cp0 != trace_vals[n_open - 1] % P) {
        seterr(err, err_cap, "composition identity failed at query point");
        return 3;
      }
    }

    // ---- trace auth paths (proof.rs:80-95) ----
    {
      uint8_t root[32];
      for (size_t i = 0; i < n_open; i++) {
        size_t idx = (i < air.n_shifts)
                         ? size_t(test_point + air.shifts[i] * blowup)
                         : size_t(test_point);
        const uint8_t *want = (i < air.n_shifts) ? f_root : roots[0];
        compute_root_from_path(trace_vals[i], idx, trace_paths[i],
                               trace_plens[i], root);
        if (memcmp(root, want, 32) != 0) {
          seterr(err, err_cap, "trace auth path mismatch");
          return 4;
        }
      }
    }

    // ---- FRI consistency (proof.rs:101-126) ----
    for (uint32_t layer = 0; layer < rounds; layer++) {
      uint64_t xl = powmod(x, 1ULL << layer);
      uint64_t cpx = fv0[layer] % P, cpnx = fv1[layer] % P;
      uint64_t g_xx = mulmod((cpx + cpnx) % P, inv2);
      uint64_t h_xx = mulmod(mulmod(sub(cpx, cpnx), inv2), inv(xl));
      uint64_t calc = (g_xx + mulmod(betas[layer + 1] % P, h_xx)) % P;
      uint64_t nxt = (layer + 1 < rounds) ? fv0[layer + 1] % P : free_term % P;
      if (nxt != calc) {
        seterr(err, err_cap, "FRI consistency failed");
        return 5;
      }
    }

    // ---- FRI auth paths (proof.rs:129-148) ----
    {
      uint8_t root[32];
      for (uint32_t layer = 0; layer < rounds; layer++) {
        uint64_t size = d >> layer;
        size_t i0 = size_t(test_point % size);
        size_t i1 = size_t((test_point + size / 2) % size);
        compute_root_from_path(fv0[layer], i0, fp0[layer], fl0[layer], root);
        if (memcmp(root, roots[layer], 32) != 0) {
          seterr(err, err_cap, "FRI auth path mismatch (x)");
          return 6;
        }
        compute_root_from_path(fv1[layer], i1, fp1[layer], fl1[layer], root);
        if (memcmp(root, roots[layer], 32) != 0) {
          seterr(err, err_cap, "FRI auth path mismatch (-x)");
          return 6;
        }
      }
    }
  }

  if (ch.r.fail || !f_root) {
    seterr(err, err_cap, "transcript truncated");
    return 1;
  }
  if (ch.r.pos != data_len) {
    seterr(err, err_cap, "trailing bytes in transcript");
    return 1;
  }
  if (final_state && memcmp(ch.state, final_state, 32) != 0) {
    seterr(err, err_cap, "final channel state mismatch");
    return 2;
  }

  return 0;
}

}  // extern "C"
