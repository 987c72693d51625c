// Fused decode -> docid chaining -> score -> select for a batch of queries,
// each query's docids split into R ranges, one CUDA block per (range, query).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/fused_query/kernel.py,
// fused_query_kernel (body _tile_kernel -> ref.fused_tile), which answered a
// tile of queries per grid step with the (tq, cap+1) accumulator in VMEM.
// The plain PyTorch version of the same function is ../ref.py:fused_tile.
//
// What bounds it on an H100: bytes.  A launch must read each query's packed
// chain blocks and their per-slot metadata about once and write the outputs
// (the (Q, cap+1) bitmap, or Q x kk pairs): a few MB, a few microseconds at
// 3.35 TB/s.  The dense (cap+1)-entry accumulator of a query (512 KB at
// cap = 2^17, 4 MB at the paper's 2^20 documents) is not part of that bound
// as long as it never leaves the SM, and the decode is a few integer
// operations per byte.  The design aims at that bound by keeping the
// accumulator on chip and spreading each query over the card; what keeps
// it above the bound is the serial decode of a block by one thread, the
// walk over the slots that every range repeats, and the barriers between
// term segments:
//   * the grid is (R, Q).  Block (r, q) owns docids [r*W, min((r+1)*W,
//     cap+1)) of query q, and their accumulator (int32 hits or float32
//     scores, W x 4 bytes) lives in shared memory.  The wrapper (../kernel.py
//     ranges_for) picks R so that the Q*R blocks fill the card, two per SM,
//     in one wave, and a range fits in 80 KB;
//   * every block walks its query's slots once per image part, 1,024 slots
//     a pass, two per thread in stride, every load of a pass issued before
//     any is used.  A segmented scan of the blocks' first gaps (the first
//     code of each block's payload, read from one 16-byte load) gives every
//     chain block's first docid, as the plain version's segmented sums do.
//     Block s of a term segment covers [first_s, first_{s+1}); the blocks
//     that meet the range are listed in shared memory, in slot order, and
//     only they are decoded, each by one thread, with only their postings
//     inside the range added.  So each posting is decoded about once across
//     the R blocks of its query.  The list holds up to 2,048 blocks across
//     passes and is decoded when full and at the end of the part;
//   * a 64-byte block is read with four 16-byte loads and decoded from
//     registers, eight bytes a step, branch-free, so that the lanes of a
//     warp (each on its own block) run one instruction stream; a step's
//     postings are added as one batch of independent loads, weights and
//     stores.  log1pf of the small term frequencies comes from a table the
//     block fills with the same log1pf;
//   * adds keep the plain version's order, bit for bit: the listed blocks
//     are added one term segment after another, separated by
//     __syncthreads(), frozen part before delta part.  Within a doc-level
//     term segment every docid occurs at most once, so the adds of one
//     segment need no atomics and every docid receives its weights in
//     term-major order on every run.
//     Conjunctive hits are integers and use shared-memory atomics in any
//     order.  The float arithmetic uses the round-to-nearest intrinsics, so
//     no multiply-add is contracted into an FMA the plain version does not
//     do;
//   * selection is one pass over the range in shared memory: tombstoned
//     docids read as 0.0 (select, as the plain version masks), entries below
//     a floor (the kk-th best of the warps' best entries) are dropped by one
//     comparison, each thread keeps a sorted list of its best kTop entries
//     in registers, and the lists are merged, warp by warp and then across
//     warps, in canonical order (score descending, docid ascending).  Each
//     range writes its top kk to scratch; the last block of a query to
//     finish (a ticket counter per query, zeroed by fq_launch) merges the R
//     lists the same way.  A range's top kk holds every global winner from
//     that range, so the merge is exact.  For kk > kTop the pass repeats,
//     each round taking the next kTop entries after the last one chosen;
//   * a conjunctive block writes its own columns of the bitmap;
//   * each mode is its own instantiation of the kernel, so that no posting
//     branches on the mode.
//
// Interface: a plain C function, fq_launch, which launches on the caller's
// stream and returns the first CUDA error.  Outputs and scratch are
// allocated by the Python wrapper (../kernel.py); the kernel allocates
// nothing.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 2;                    // slots per thread per pass
constexpr int kPass = kThreads * kSlots;     // slots per pass
constexpr int kGroups = kSlots * kWarps;     // warp-sized groups of a pass
static_assert(kGroups == 32, "warp 0 scans the groups, one a lane");
constexpr int kMinBlocks = 2;                // blocks per SM: 64 registers
constexpr int kTop = 16;                     // entries a list keeps per round
constexpr int kStep = 8;                     // bytes decoded per batch of adds
constexpr int kTodo = 2048;                  // listed blocks held at most
static_assert(kPass <= kTodo, "a pass's blocks fit the list");
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kConjunctive = 0, kRankedTfidf = 1, kBm25 = 2 };

struct Part {
  const uint8_t* gat;     // (Q, pb, B) packed chain blocks
  const int32_t* start;   // (Q, pb) first payload byte
  const int32_t* end;     // (Q, pb) one past the last payload byte (0 = pad)
  const int32_t* seg;     // (Q, pb) owning term segment
  const int32_t* lastd0;  // (Q, pb) docid base of the segment's head block
  const int32_t* dnum0;   // (Q, pb) b-gap base (-1: frozen, absolute chain)
  const float* widf;      // (Q, pb) idf weight of the owning term
  int pb;
};

struct Args {
  Part part[2];
  int nparts;
  int B, F, cap, kk;
  int fshift;               // log2(F) when F is a power of two, else -1
  bool vec;                 // 64-byte blocks on 16-byte boundaries
  int W;                    // docids per range (a multiple of 32)
  int R;                    // ranges per query
  const int32_t* nterms;    // (Q,)
  const float* doclens;     // (ndoclens,)
  int ndoclens;
  const float* norm;        // (2,) bm25 normalisation
  const uint32_t* alive;    // packed liveness bits, or null
  uint8_t* matches;         // (Q, cap+1) out, conjunctive
  int32_t* top_d;           // (Q, kk) out, ranked
  float* top_s;             // (Q, kk) out, ranked
  int32_t* cand_d;          // (Q, R, kk) scratch: each range's top kk
  float* cand_s;            // (Q, R, kk) scratch
  unsigned* ticket;         // (Q,) scratch, zero at launch
};

// log1pf(f) for the small term frequencies, computed once per block by
// the same log1pf, so a lookup gives the same bits as the call
constexpr int kLogs = 64;
__shared__ float s_log1p[kLogs];

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Canonical order: higher score first, then lower docid.
__device__ __forceinline__ bool better(float s, int d, float bs, int bd) {
  return s > bs || (s == bs && d < bd);
}

// The value v of a primary code: its gap and its frequency (0 for an
// escape, whose frequency is the next value).
__device__ __forceinline__ void unfold(const Args& a, int v, int& g, int& m) {
  if (a.fshift >= 0) {            // F a power of two (doc-level: 4)
    m = v & (a.F - 1);
    g = (v >> a.fshift) + (m > 0);
  } else {
    m = v % a.F;
    g = v / a.F + (m > 0);
  }
}

// Gap of the first value of a block: the leading code is always a primary.
// For 64-byte blocks ``chunk`` holds the 16 block bytes from st & ~15 and
// the code is read from it while it lasts; other bytes are read one by one.
__device__ __forceinline__ int first_gap(const Args& a, const uint8_t* row,
                                         uint4 chunk, int st, int en) {
  const int c = st & ~15;
  uint32_t acc = 0;
  int k = 0;
  for (int p = st; p < en; ++p) {
    const int i = p - c;
    uint32_t b;
    if (a.vec && i < 16) {
      const uint32_t w = i < 8 ? (i < 4 ? chunk.x : chunk.y)
                               : (i < 12 ? chunk.z : chunk.w);
      b = (w >> (8 * (i & 3))) & 0xffu;
    } else {
      b = __ldg(row + p);
    }
    acc += (b & 0x7fu) << (7 * min(k, 4));
    if (b & 0x80u) {
      ++k;
      continue;
    }
    const int v = static_cast<int>(acc);
    acc = 0;
    k = 0;
    if (v > 0) {
      int g, m;
      unfold(a, v, g, m);
      return g;
    }
  }
  return 0;
}

// Add the postings (e[k], d[k], f[k]) that fall in [lo, lo + n) to the
// range's accumulator.  The docids are distinct (one block of one term
// segment), so every load, weight and store of the batch is independent:
// they are issued together rather than as a chain of dependent ones.
template <int kMode, int N>
__device__ __forceinline__ void add_postings(const Args& a, float2 nrm,
                                             const bool (&e)[N],
                                             const int (&d)[N],
                                             const int (&f)[N], float widf,
                                             int lo, int n, int32_t* hits,
                                             float* score) {
  int i[N];
  bool in[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    i[k] = d[k] - lo;
    in[k] = e[k] && static_cast<unsigned>(i[k]) < static_cast<unsigned>(n);
  }
  if (kMode == kConjunctive) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (in[k]) atomicAdd(hits + i[k], 1);
    return;
  }
  float w[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    w[k] = 0.f;
    if (!in[k]) continue;
    const float fv = static_cast<float>(f[k]);
    if (kMode == kBm25) {
      const float dl = __ldg(a.doclens + min(d[k], a.ndoclens - 1));
      const float den = __fadd_rn(__fadd_rn(fv, nrm.x), __fmul_rn(nrm.y, dl));
      w[k] = __fmul_rn(__fdiv_rn(__fmul_rn(fv, 1.9f), den), widf);
    } else {
      w[k] = __fmul_rn(f[k] < kLogs ? s_log1p[f[k]] : log1pf(fv), widf);
    }
  }
  float old[N];
#pragma unroll
  for (int k = 0; k < N; ++k) old[k] = in[k] ? score[i[k]] : 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (in[k]) score[i[k]] = __fadd_rn(old[k], w[k]);
}

// Algorithm 2 with escape pairing, one byte at a time; ``d`` runs from the
// block's first docid minus its first gap.  A byte completes at most one
// posting: a primary with f > 0, or the value that completes an escape
// (whose primary set the docid and completed nothing).
struct Decoder {
  uint32_t acc = 0;
  int k = 0;
  int d;
  bool pending = false;   // an escape primary awaiting its pair

  // Branch-free, so that the lanes of a warp, each on its own block, run
  // one instruction stream.
  __device__ __forceinline__ void byte(const Args& a, uint32_t b, bool inside,
                                       bool& e, int& od, int& of) {
    const bool term = inside && !(b & 0x80u);
    acc += inside ? (b & 0x7fu) << (7 * min(k, 4)) : 0u;
    k = term ? 0 : k + inside;
    const int v = term ? static_cast<int>(acc) : 0;
    acc = term ? 0u : acc;
    const bool val = v > 0;           // a null byte is not a value
    const bool consumed = val && pending;   // completes the escape
    const bool primary = val && !pending;
    int g, m;
    unfold(a, v, g, m);
    d += primary ? g : 0;
    e = consumed || (primary && m > 0);
    od = d;
    of = consumed ? a.F + v - 1 : m;
    pending = primary ? m == 0 : pending && !consumed;
  }
};

// Decode block s of part P (row: the query's first slot) and add its
// postings that fall in [lo, lo + n); ``base`` is its first docid minus its
// first gap.  A 64-byte block on a 16-byte boundary is read with four
// 16-byte loads and decoded from registers, kStep bytes a step, each step's
// postings added as one batch; other blocks byte by byte.
template <int kMode>
__device__ __forceinline__ void decode_block(const Args& a, float2 nrm,
                                             const Part& P, size_t row, int s,
                                             int base, int lo, int n,
                                             int32_t* hits, float* score) {
  const uint8_t* blk = P.gat + (row + s) * a.B;
  const int st = P.start[row + s];
  const int en = P.end[row + s];
  const float widf = kMode == kConjunctive ? 0.f : P.widf[row + s];
  Decoder D;
  D.d = base;
  if (a.vec) {
    uint32_t w[16];
    const uint4* p4 = reinterpret_cast<const uint4*>(blk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = __ldg(p4 + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
#pragma unroll 1
    for (int p0 = 0; p0 < 64; p0 += kStep) {
      uint32_t cur[kStep / 4];
#pragma unroll
      for (int i = 0; i < kStep / 4; ++i) cur[i] = w[i];
#pragma unroll
      for (int i = 0; i < 16 - kStep / 4; ++i) w[i] = w[i + kStep / 4];
      if (p0 + kStep <= st || p0 >= en) continue;
      bool e[kStep];
      int od[kStep], of[kStep];
#pragma unroll
      for (int k = 0; k < kStep; ++k) {
        const int p = p0 + k;
        const uint32_t b = (cur[k >> 2] >> (8 * (k & 3))) & 0xffu;
        D.byte(a, b, p >= st && p < en, e[k], od[k], of[k]);
      }
      add_postings<kMode, kStep>(a, nrm, e, od, of, widf, lo, n, hits,
                                 score);
    }
  } else {
    for (int p = st; p < en; ++p) {
      bool e[1];
      int od[1], of[1];
      D.byte(a, __ldg(blk + p), true, e[0], od[0], of[0]);
      add_postings<kMode, 1>(a, nrm, e, od, of, widf, lo, n, hits, score);
    }
  }
  if (D.pending) {
    const bool e[1] = {true};
    const int od[1] = {D.d}, of[1] = {0};
    add_postings<kMode, 1>(a, nrm, e, od, of, widf, lo, n, hits, score);
  }
}

// Element of the segmented scan over a part's slots.  ``head``: a segment
// starts in the span; ``sum``: the first gaps after the span's last segment
// start (mod 2^32); ``base``: that start's chaining base.  Seg{0, 0, 0} is
// the identity.
struct Seg {
  int head;
  unsigned sum;
  int base;
};

__device__ __forceinline__ Seg combine(const Seg& x, const Seg& y) {
  return y.head ? y : Seg{x.head, x.sum + y.sum, x.base};
}

__device__ __forceinline__ Seg shfl_up(const Seg& x, int o) {
  return Seg{__shfl_up_sync(kFull, x.head, o),
             __shfl_up_sync(kFull, x.sum, o),
             __shfl_up_sync(kFull, x.base, o)};
}

__device__ __forceinline__ void warp_scan(Seg& x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Seg y = shfl_up(x, o);
    if (lane >= o) x = combine(y, x);
  }
}

// Inclusive segmented scan of a pass, in slot order (stride group j, then
// thread), after ``carry``; ``carry`` becomes the scan of everything so
// far.  The kSlots groups are scanned together: two barriers a pass.
__device__ __forceinline__ void pass_scan(Seg (&x)[kSlots], Seg& carry,
                                          Seg* s_warp) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) warp_scan(x[j], lane);
  if (lane == 31) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) s_warp[j * kWarps + w] = x[j];
  }
  __syncthreads();
  if (w == 0) {             // lane i scans group i's total
    Seg t = s_warp[lane];
    warp_scan(t, lane);
    s_warp[lane] = t;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = j * kWarps + w;
    x[j] = combine(i > 0 ? combine(carry, s_warp[i - 1]) : carry, x[j]);
  }
  carry = combine(carry, s_warp[kGroups - 1]);
}

// A slot whose block meets the range: its index in the part, its segment
// and its decoder start docid.
struct Todo {
  int slot;
  int seg;
  int base;
};

// Shared memory of accumulate_part.
struct Walk {
  Seg warp[kGroups];             // pass_scan's group totals
  int4 edge[kGroups];            // each group's first slot: first, seg, gap
  int cnt[kGroups];              // flagged slots per group, then offsets
  int count;                     // flagged slots in the pass
  Todo todo[kTodo];              // the flagged slots not yet decoded, in
                                 // slot order
};

// Decode the ``held`` listed blocks of part P: all at once (conjunctive
// hits add in any order) or one term segment after another, in order.
template <int kMode>
__device__ void drain(const Args& a, float2 nrm, const Part& P, size_t row,
                      int held, int lo, int n, int32_t* hits, float* score,
                      Walk& S) {
  if (kMode == kConjunctive) {
    for (int i = threadIdx.x; i < held; i += kThreads) {
      const Todo t = S.todo[i];
      decode_block<kMode>(a, nrm, P, row, t.slot, t.base, lo, n, hits,
                          score);
    }
    __syncthreads();
    return;
  }
  for (int sid = S.todo[0].seg; sid <= S.todo[held - 1].seg; ++sid) {
    for (int i = threadIdx.x; i < held; i += kThreads) {
      const Todo t = S.todo[i];
      if (t.seg == sid)
        decode_block<kMode>(a, nrm, P, row, t.slot, t.base, lo, n, hits,
                            score);
    }
    __syncthreads();
  }
}

// Add one image part's postings that fall in [lo, lo + n) of query q.
template <int kMode>
__device__ void accumulate_part(const Args& a, const Part& P, int q, int lo,
                                int n, int32_t* hits, float* score,
                                Walk& S) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const size_t row = static_cast<size_t>(q) * P.pb;
  const int hi = lo + n;
  const float2 nrm = make_float2(__ldg(a.norm), __ldg(a.norm + 1));
  Seg carry{0, 0u, 0};
  int held = 0;             // listed blocks not yet decoded
  for (int pass = 0; pass < P.pb; pass += kPass) {
    if (P.end[row + pass] == 0) break;         // pad slots fill the rest
    int st[kSlots], en[kSlots], sg[kSlots], prev[kSlots], dn0[kSlots],
        ld0[kSlots], fg[kSlots];
    // every load of the pass first, then the first gaps
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int s = pass + j * kThreads + tid;
      const bool in = s < P.pb;
      st[j] = in ? P.start[row + s] : 0;
      en[j] = in ? P.end[row + s] : 0;
      sg[j] = in ? P.seg[row + s] : -1;
      prev[j] = in && s > 0 ? P.seg[row + s - 1] : -2;
      dn0[j] = in ? P.dnum0[row + s] : 0;
      ld0[j] = in ? P.lastd0[row + s] : 0;
    }
    uint4 chunk[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int s = pass + j * kThreads + tid;
      chunk[j] = a.vec && en[j] > st[j]
                     ? __ldg(reinterpret_cast<const uint4*>(
                           P.gat + (row + s) * a.B + (st[j] & ~15)))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int s = pass + j * kThreads + tid;
      fg[j] = en[j] > st[j] ? first_gap(a, P.gat + (row + s) * a.B, chunk[j],
                                        st[j], en[j])
                            : 0;
    }
    // first docid of each block: the head's from lastd0, the others from
    // the segment's base plus the first gaps after the head
    Seg x[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const bool head = sg[j] >= 0 && prev[j] != sg[j];
      x[j] = Seg{head, head ? 0u : static_cast<unsigned>(fg[j]),
                 dn0[j] < 0 ? fg[j] : dn0[j]};
    }
    pass_scan(x, carry, S.warp);
    int first[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const bool head = sg[j] >= 0 && prev[j] != sg[j];
      first[j] = head ? ld0[j] + fg[j]
                      : static_cast<int>(static_cast<unsigned>(x[j].base) +
                                         x[j].sum);
      if (lane == 0)
        S.edge[j * kWarps + w] = make_int4(first[j], sg[j], fg[j], 0);
    }
    __syncthreads();
    // a block meets [lo, hi) unless it starts at or above hi, or the next
    // slot is a non-empty block of the same segment starting at or below lo
    // (it bounds this block's docids from above).  The next slot is lane + 1
    // of the same stride group, or the next warp's first; the pass's last
    // slot has none and decodes whenever it starts below hi
    unsigned bal[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int gi = j * kWarps + w;
      int nfirst = __shfl_down_sync(kFull, first[j], 1);
      int nsg = __shfl_down_sync(kFull, sg[j], 1);
      int nfg = __shfl_down_sync(kFull, fg[j], 1);
      bool known = lane < 31;
      if (!known && gi + 1 < kGroups) {
        const int4 e = S.edge[gi + 1];
        nfirst = e.x;
        nsg = e.y;
        nfg = e.z;
        known = true;
      }
      const bool below = known && nsg == sg[j] && nfg > 0 && nfirst <= lo;
      bal[j] = __ballot_sync(kFull, en[j] > st[j] && first[j] < hi && !below);
      if (lane == 0) S.cnt[gi] = __popc(bal[j]);
    }
    __syncthreads();
    if (w == 0) {             // exclusive offsets of the group counts
      const int c = S.cnt[lane];
      int t = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, t, o);
        if (lane >= o) t += y;
      }
      if (lane == 31) S.count = t;
      S.cnt[lane] = t - c;
    }
    __syncthreads();
    // the list grows pass by pass and is decoded when the next pass would
    // overflow it and at the end of the part, so that a segment that spans
    // passes is added in one round rather than one per pass
    const int fresh = S.count;
    if (held + fresh > kTodo) {
      drain<kMode>(a, nrm, P, row, held, lo, n, hits, score, S);
      held = 0;
    }
    const unsigned below_me = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if ((bal[j] >> lane) & 1u) {
        const int i = held + S.cnt[j * kWarps + w] + __popc(bal[j] & below_me);
        S.todo[i] = Todo{pass + j * kThreads + tid, sg[j], first[j] - fg[j]};
      }
    }
    held += fresh;
    __syncthreads();
  }
  if (held > 0) drain<kMode>(a, nrm, P, row, held, lo, n, hits, score, S);
}

// A sorted list of a thread's best kTop (score, docid) entries.
struct List {
  float s[kTop];
  int d[kTop];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < kTop; ++i) {
      s[i] = neg_inf();
      d[i] = INT_MAX;
    }
  }

  // Insert (vs, vd) in canonical order, dropping the last entry.
  __device__ __forceinline__ void insert(float vs, int vd) {
    if (!better(vs, vd, s[kTop - 1], d[kTop - 1])) return;
    bool prev = true;   // the entry above slot i moves down
#pragma unroll
    for (int i = kTop - 1; i > 0; --i) {
      const bool up = better(vs, vd, s[i - 1], d[i - 1]);
      const float ns = up ? s[i - 1] : (prev ? vs : s[i]);
      const int nd = up ? d[i - 1] : (prev ? vd : d[i]);
      s[i] = ns;
      d[i] = nd;
      prev = up;
    }
    if (prev) {
      s[0] = vs;
      d[0] = vd;
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int i = 0; i < kTop - 1; ++i) {
      s[i] = s[i + 1];
      d[i] = d[i + 1];
    }
    s[kTop - 1] = neg_inf();
    d[kTop - 1] = INT_MAX;
  }
};

// The warp's best m entries in canonical order, merged from the lanes'
// sorted lists; lane 0 writes them to out_s/out_d.
__device__ __forceinline__ void warp_merge(List& L, int m, float* out_s,
                                           int* out_d) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < m; ++r) {
    float bs = L.s[0];
    int bd = L.d[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(kFull, bs, o);
      const int od = __shfl_xor_sync(kFull, bd, o);
      if (better(os, od, bs, bd)) {
        bs = os;
        bd = od;
      }
    }
    if (bd == INT_MAX) {          // every list is empty: sentinels follow
      if (lane == 0) {
        for (; r < m; ++r) {
          out_s[r] = bs;
          out_d[r] = bd;
        }
      }
      break;
    }
    if (lane == 0) {
      out_s[r] = bs;
      out_d[r] = bd;
    }
    if (L.s[0] == bs && L.d[0] == bd) L.pop();
  }
}

// The top kk of n candidates get(i) = (score, docid), i in [0, n), in
// canonical order, into out_s/out_d (sentinels past the n-th), by rounds of
// kTop: one pass over the candidates per round.
template <class Get>
__device__ __forceinline__ void block_top(Get get, int n, int kk,
                                          float* out_s, int* out_d,
                                          float* s_ws, int* s_wd,
                                          float* s_last_s, int* s_last_d) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  // a floor: the kk-th best of the warps' best entries.  Those kk distinct
  // entries are at or above it, so nothing below it is in the top kk, and
  // most candidates are dropped by one comparison (a sentinel floor, when
  // fewer than kk warps have candidates, drops none)
  float fs = neg_inf();
  int fd = INT_MAX;
  if (kk <= kWarps) {
    float bs = neg_inf();
    int bd = INT_MAX;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      float s;
      int d;
      get(i, s, d);
      if (better(s, d, bs, bd)) {
        bs = s;
        bd = d;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(kFull, bs, o);
      const int od = __shfl_xor_sync(kFull, bd, o);
      if (better(os, od, bs, bd)) {
        bs = os;
        bd = od;
      }
    }
    if (lane == 0) {
      s_ws[w] = bs;
      s_wd[w] = bd;
    }
    if (threadIdx.x == 0) {
      *s_last_s = neg_inf();
      *s_last_d = INT_MAX;
    }
    __syncthreads();
    if (w == 0 && lane < kWarps) {
      const float vs = s_ws[lane];
      const int vd = s_wd[lane];
      int rank = 0;
#pragma unroll
      for (int o = 0; o < kWarps; ++o) rank += better(s_ws[o], s_wd[o], vs, vd);
      if (rank == kk - 1) {
        *s_last_s = vs;
        *s_last_d = vd;
      }
    }
    __syncthreads();
    fs = *s_last_s;
    fd = *s_last_d;
  }
  float ls = 0.f;
  int ld = -1;
  for (int done = 0; done < kk; done += kTop) {
    const int m = min(kTop, kk - done);
    List L;
    L.clear();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      float s;
      int d;
      get(i, s, d);
      if ((done == 0 || better(ls, ld, s, d)) && !better(fs, fd, s, d))
        L.insert(s, d);
    }
    warp_merge(L, m, s_ws + w * kTop, s_wd + w * kTop);
    __syncthreads();
    if (w == 0) {
      L.clear();
#pragma unroll
      for (int i = 0; i < kTop; ++i) {
        if (lane < kWarps && i < m) {
          L.s[i] = s_ws[lane * kTop + i];
          L.d[i] = s_wd[lane * kTop + i];
        }
      }
      warp_merge(L, m, out_s + done, out_d + done);
      if (lane == 0) {
        *s_last_s = out_s[done + m - 1];
        *s_last_d = out_d[done + m - 1];
      }
    }
    __syncthreads();
    ls = *s_last_s;
    ld = *s_last_d;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_query_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint8_t s_acc[];
  __shared__ Walk s_walk;
  __shared__ float s_ws[kWarps * kTop];
  __shared__ int s_wd[kWarps * kTop];
  __shared__ float s_last_s;
  __shared__ int s_last_d;
  __shared__ int s_final;

  const int r = blockIdx.x;
  const int q = blockIdx.y;
  const int tid = threadIdx.x;
  const int lo = r * a.W;
  const int n = min(a.W, a.cap + 1 - lo);
  constexpr bool conj = kMode == kConjunctive;
  int32_t* hits = reinterpret_cast<int32_t*>(s_acc);
  float* score = reinterpret_cast<float*>(s_acc);

  for (int i = tid; i < n; i += kThreads) {
    if (conj) hits[i] = 0;
    else score[i] = 0.f;
  }
  if (tid < kLogs) s_log1p[tid] = log1pf(static_cast<float>(tid));
  __syncthreads();
  for (int pi = 0; pi < a.nparts; ++pi)
    accumulate_part<kMode>(a, a.part[pi], q, lo, n, hits, score, s_walk);
  // the range's liveness words, staged where the walk kept its slots (lo is
  // a multiple of 32); all ones without deletes
  uint32_t* alive = reinterpret_cast<uint32_t*>(s_walk.todo);
  for (int i = tid; i < (n + 31) / 32; i += kThreads)
    alive[i] = a.alive == nullptr ? ~0u : __ldg(a.alive + (lo >> 5) + i);
  __syncthreads();
  const auto live = [&](int i) { return (alive[i >> 5] >> (i & 31)) & 1u; };

  if (conj) {
    const int nt = a.nterms[q];
    uint8_t* out = a.matches + static_cast<size_t>(q) * (a.cap + 1) + lo;
    for (int i = tid; i < n; i += kThreads)
      out[i] = lo + i > 0 && nt > 0 && hits[i] == nt && live(i);
    return;
  }

  // this range's top kk, tombstoned docids reading as 0.0
  const size_t c0 = (static_cast<size_t>(q) * a.R + r) * a.kk;
  block_top([&](int i, float& s, int& d) {
              d = lo + i;
              s = live(i) ? score[i] : 0.f;
            },
            n, a.kk, a.cand_s + c0, a.cand_d + c0, s_ws, s_wd, &s_last_s,
            &s_last_d);
  // the last range of query q to finish merges the R lists
  if (tid == 0) {
    __threadfence();
    s_final = atomicAdd(a.ticket + q, 1u) == static_cast<unsigned>(a.R - 1);
  }
  __syncthreads();
  if (!s_final) return;
  __threadfence();
  const size_t q0 = static_cast<size_t>(q) * a.R * a.kk;
  const int32_t* cd = a.cand_d + q0;
  const float* cs = a.cand_s + q0;
  block_top([&](int i, float& s, int& d) {
              s = __ldcg(cs + i);
              d = __ldcg(cd + i);
            },
            a.R * a.kk, a.kk, a.top_s + static_cast<size_t>(q) * a.kk,
            a.top_d + static_cast<size_t>(q) * a.kk, s_ws, s_wd, &s_last_s,
            &s_last_d);
}

// Launch the kernel of one mode on ``st``: its shared-memory attributes
// first, then the ticket counters (ranked modes), then the (R, Q) grid.
template <int kMode>
cudaError_t launch(const Args& a, int Q, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_query_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // the least shared-memory carveout that holds two blocks, so that the
  // rest of the SM's 256 KB stays L1
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, fused_query_kernel<kMode>);
  if (e != cudaSuccess) return e;
  const size_t all = kMinBlocks * (smem + fa.sharedSizeBytes + 1024);
  const size_t pct = (all * 100 + 233471) / 233472;
  e = cudaFuncSetAttribute(fused_query_kernel<kMode>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           pct < 100 ? static_cast<int>(pct) : 100);
  if (e != cudaSuccess || Q == 0) return e;
  if (kMode != kConjunctive) {
    e = cudaMemsetAsync(a.ticket, 0, static_cast<size_t>(Q) * 4, st);
    if (e != cudaSuccess) return e;
  }
  fused_query_kernel<kMode><<<dim3(a.R, Q), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fq_launch(const void* const* part_ptrs, const int* part_pb,
                         int nparts, int Q, int B, int F, int cap, int mode,
                         int kk, int R, int W, const void* nterms,
                         const void* doclens, int ndoclens, const void* norm,
                         const void* alive, void* matches, void* top_d,
                         void* top_s, void* cand_d, void* cand_s,
                         void* ticket, void* stream) {
  const bool conj = mode == kConjunctive;
  if (nparts < 1 || nparts > 2 || F < 1 || R < 1 || W < 32 || W % 32 != 0 ||
      static_cast<long long>(R - 1) * W >= cap + 1 ||
      static_cast<long long>(R) * W < cap + 1 || R > 65535 || Q > 65535 ||
      (W + 31) / 32 * 4 > static_cast<int>(sizeof(Walk::todo)) ||
      (!conj && (kk < 1 || kk > cap + 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  bool aligned = true;
  for (int i = 0; i < nparts; ++i) {
    const void* const* p = part_ptrs + 7 * i;
    a.part[i].gat = static_cast<const uint8_t*>(p[0]);
    a.part[i].start = static_cast<const int32_t*>(p[1]);
    a.part[i].end = static_cast<const int32_t*>(p[2]);
    a.part[i].seg = static_cast<const int32_t*>(p[3]);
    a.part[i].lastd0 = static_cast<const int32_t*>(p[4]);
    a.part[i].dnum0 = static_cast<const int32_t*>(p[5]);
    a.part[i].widf = static_cast<const float*>(p[6]);
    a.part[i].pb = part_pb[i];
    if (reinterpret_cast<uintptr_t>(p[0]) % 16 != 0) aligned = false;
  }
  a.nparts = nparts;
  a.B = B;
  a.F = F;
  a.cap = cap;
  a.kk = kk;
  a.fshift = (F & (F - 1)) == 0 ? __builtin_ctz(static_cast<unsigned>(F)) : -1;
  a.vec = B == 64 && aligned;
  a.W = W;
  a.R = R;
  a.nterms = static_cast<const int32_t*>(nterms);
  a.doclens = static_cast<const float*>(doclens);
  a.ndoclens = ndoclens;
  a.norm = static_cast<const float*>(norm);
  a.alive = static_cast<const uint32_t*>(alive);
  a.matches = static_cast<uint8_t*>(matches);
  a.top_d = static_cast<int32_t*>(top_d);
  a.top_s = static_cast<float*>(top_s);
  a.cand_d = static_cast<int32_t*>(cand_d);
  a.cand_s = static_cast<float*>(cand_s);
  a.ticket = static_cast<unsigned*>(ticket);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(W) * 4;
  cudaError_t e;
  switch (mode) {
    case kConjunctive:
      e = launch<kConjunctive>(a, Q, smem, st);
      break;
    case kRankedTfidf:
      e = launch<kRankedTfidf>(a, Q, smem, st);
      break;
    case kBm25:
      e = launch<kBm25>(a, Q, smem, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
