// Pairwise DUOT causality audit (paper eq. 1a-1d + timed bound) for Hopper.
//
// Replaces: repro/kernels/vclock_audit.py :: vclock_audit (the Pallas TPU
// kernel, body _audit_kernel).  Same contract as
// repro/kernels/ref.py :: vclock_audit_ref: an (M, M) int32 code matrix
//
//   code[i][j] = phase | viol << 8 | timed << 9
//
// with happens-before(a, b) <=> max_n(a_n - b_n) <= 0 and min_n(a_n - b_n) < 0
// over N-component vector clocks, and the phase / violation / timed rules
// of the reference (phase 1..4 same-client MR/MW/RYW/WFR, 5 cross-client
// TCC, 6 concurrent; delta <= 0 disables the timed flag).  Given
// max_n(a_n - b_n) <= 0, min_n(a_n - b_n) < 0 holds iff sum(a) < sum(b),
// so the kernel reduces one max per component and compares the rows'
// int64 sums once per pair.  Clock components are non-negative counts, so
// no difference overflows.
//
// Bound on the H100: the output is 4 M^2 bytes (16.8 MB at M = 2048, 1.07 GB
// at M = 16384), written once.  The code of a pair is 0 unless
//
//   base = valid_i && valid_j && resource_i == resource_j && seq_i < seq_j,
//
// and only base pairs need the N-component happens-before.  So the floor
// is the larger of the output bytes and the base pairs' compares, and the
// design pays the compare for base pairs only:
//
//   1. a CTA owns a TI x TJ output tile; it stages both tiles' meta (six
//      columns read by pointer) in shared memory and, per pair, evaluates
//      base into a byte per pair (0, or BASE_BIT for a base pair).  Base
//      pairs also go into a shared list (a prefix sum per 8-lane group,
//      one shared atomic per group and row);
//   2. only if the tile has base pairs, the clock rows are staged (16-byte
//      loads, the row stride padded to an odd word count, so rows fall on
//      distinct banks; the j rows negated, so one DPX __viaddmax_s32 per
//      component and pair reduces max_n(a_n - b_n); a chunk whose values
//      all lie in [0, 32767] is stored as int16 pairs and reduced by one
//      __viaddmax_s16x2 per two components) and compared:
//        - compact: one thread per listed pair, the lanes of a warp busy
//          on 32 pairs whatever the mix.  The list is kept by 32 x 32
//          sub-tiles, so the 32 pairs of a warp's step come from one
//          sub-tile: distinct rows on distinct banks, no conflicts;
//        - dense: every pair, each thread a register tile of 8 rows x 4
//          columns, so one staged component feeds 32 pairs; a warp whose
//          rows hold no base pair skips the compare;
//      "auto" takes dense when the tile's base pairs reach
//      DENSE_NUM / DENSE_DEN of its pairs.  Then, a thread per listed pair
//      whichever design ran, each base pair's byte becomes its code
//      (phase, viol << 3, timed << 4; a base pair without happens-before
//      is phase 6, never a violation);
//   3. the byte tile is expanded to int32 codes and written once, with
//      streaming stores (int4 runs along j where M allows).
// Clocks wider than KC components are staged and compared in chunks.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int TI = 128;           // output rows per CTA
constexpr int TJ = 128;           // output columns per CTA
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 32;            // clock components staged at once
constexpr int EPT = 8;            // listed pairs per thread per compact batch
constexpr int V4 = (TI + TJ) * KC / 4 / THREADS;   // int4 loads per thread per chunk
constexpr int ROWS_PER_WARP = TI / WARPS;   // dense register tile rows
constexpr int SUB = 32;           // list sub-tiles: SUB x SUB pairs each
constexpr int SUBS_J = TJ / SUB, N_SUBS = (TI / SUB) * SUBS_J;
constexpr unsigned FULL = 0xffffffffu;
static_assert(TJ == 4 * 32 && TI % WARPS == 0 && TI * TJ <= 65536,
              "a lane owns 4 columns; a list entry is il << 7 | jl in 16 bits");
static_assert((TI + TJ) * KC % (4 * THREADS) == 0 && TI + TJ <= THREADS,
              "a chunk's int4 loads and the meta rows split evenly over the CTA");

// The byte of a pair: phase (3 bits) | viol << 3 | timed << 4 | base << 5;
// before it is settled, a base pair's byte is BASE_BIT, plus LE_BIT once
// its max_n(a_n - b_n) <= 0.
constexpr int VIOL_BIT = 0x08, TIMED_BIT = 0x10, BASE_BIT = 0x20, LE_BIT = 0x40;
constexpr int PHASE_CONCURRENT = 6;

enum { AUTO = 0, DENSE = 1, COMPACT = 2 };
// auto: the dense compare when base pairs >= DENSE_NUM / DENSE_DEN of a
// tile's pairs, the crossover of the two designs that chip_smoke.py's
// kernels phase times on the H100 (uniform mixes of 1, 2, 3 and 6
// resources at (M, N) = (16384, 64); PERF.md section 6).
constexpr int DENSE_NUM = 1, DENSE_DEN = 4;

// Meta columns staged per tile row.
constexpr int CLIENT = 0, KIND = 1, RESOURCE = 2, VERSION = 3, SEQ = 4,
              VALID = 5, META = 6;

struct Columns {
  const int* client;
  const int* kind;
  const int* resource;
  const int* version;
  const int* seq;
  const unsigned char* valid;
};

// Shared bytes ahead of the clock tiles.
constexpr int ROWSUM_BYTES = (TI + TJ) * 8;
constexpr int META_BYTES = META * (TI + TJ) * 4;
constexpr int ROWCNT_BYTES = TI * 4;
constexpr int CODE_BYTES = TI * TJ;
constexpr int LIST_BYTES = TI * TJ * 2;
constexpr int FIXED_BYTES =
    ROWSUM_BYTES + META_BYTES + ROWCNT_BYTES + CODE_BYTES + LIST_BYTES;

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// The code byte of base pair (i, j) if i happens before j.
__device__ __forceinline__ int code_if_hb(int ci, int ki, int vi, int si, int cj,
                                          int kj, int vj, int sj, int delta) {
  int phase = 5;                                   // b1 TCC
  if (ci == cj) {
    phase = 0;
    if (ki == 0 && kj == 0) phase = 1;             // a1 MR
    if (ki == 1 && kj == 1) phase = 2;             // a2 MW
    if (ki == 1 && kj == 0) phase = 3;             // a3 RYW
    if (ki == 0 && kj == 1) phase = 4;             // a4 WFR
  }
  const bool viol = (phase == 1 && vj < vi) || (phase == 2 && vj <= vi) ||
                    (phase == 3 && vj < vi) || (phase == 4 && vj <= vi) ||
                    (phase == 5 && ki == 1 && kj == 0 && vj < vi);
  const bool timed = delta > 0 && ki == 1 && kj == 0 &&
                     wrap_sub(sj, si) > delta && vj < vi;
  return BASE_BIT | phase | (viol ? VIOL_BIT : 0) | (timed ? TIMED_BIT : 0);
}

// The code byte of base pair (il, jl) of the tile once it is known
// whether max_n(a_n - b_n) <= 0 (le) and the rows' sums (sum_nb: the j
// row's sum, negated); the meta come from the staged columns.
__device__ __forceinline__ unsigned char settle(const int* mi, const int* mj, int il,
                                                int jl, bool le, long long sum_a,
                                                long long sum_nb, int delta) {
  const int ki = mi[KIND * TI + il], kj = mj[KIND * TJ + jl];
  const int vi = mi[VERSION * TI + il], vj = mj[VERSION * TJ + jl];
  const int si = mi[SEQ * TI + il], sj = mj[SEQ * TJ + jl];
  if (le && sum_a + sum_nb < 0)
    return (unsigned char)code_if_hb(mi[CLIENT * TI + il], ki, vi, si,
                                     mj[CLIENT * TJ + jl], kj, vj, sj, delta);
  const bool timed = delta > 0 && ki == 1 && kj == 0 &&
                     wrap_sub(sj, si) > delta && vj < vi;
  return (unsigned char)(BASE_BIT | PHASE_CONCURRENT | (timed ? TIMED_BIT : 0));
}

// Int16 pair words: component 2w in the low half, 2w + 1 in the high.
__device__ __forceinline__ int pack16(int lo, int hi) {
  return (int)(((unsigned)lo & 0xffffu) | ((unsigned)hi << 16));
}
__device__ __forceinline__ int lo16(unsigned w) { return (short)(w & 0xffff); }
__device__ __forceinline__ int hi16(unsigned w) { return (short)(w >> 16); }
// A running max_n(a_n - b_n) as an int16 pair accumulator.  Only its sign
// is read at the end, and a chunk's int16 differences lie in
// [-32767, 32767], so clamping the running value keeps the result's sign.
__device__ __forceinline__ unsigned pack_clamped(int x) {
  const int c = min(max(x, -32768), 32767);
  return (unsigned)pack16(c, c);
}

// A chunk's layout in shared memory: int16 pairs or int32 words, words
// per row and the row stride (odd).
struct Chunk {
  bool packed;
  int words;
  int stride;
};

// Listed pair e's place in the list: sub-tile t's pairs sit at
// [t * SUB * SUB, ...), off holding the running counts.
__device__ __forceinline__ int list_at(const int (&off)[N_SUBS + 1], int e) {
  int at = e;
#pragma unroll
  for (int u = 1; u < N_SUBS; ++u)
    if (e >= off[u]) at = u * SUB * SUB + e - off[u];
  return at;
}

__device__ __forceinline__ int expand(unsigned byte) {
  return (byte & 7) | ((byte >> 3) & 1) << 8 | ((byte >> 4) & 1) << 9;
}

__global__ void __launch_bounds__(THREADS, 2)
audit_kernel(const int* __restrict__ vc, Columns col, int m, int n, int delta,
             int design, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* rowsum = reinterpret_cast<long long*>(smem);   // [TI + TJ]
  int* mi = reinterpret_cast<int*>(rowsum + TI + TJ);       // [META][TI]
  int* mj = mi + META * TI;                                 // [META][TJ]
  int* rowcnt = mj + META * TJ;                             // [TI]
  unsigned char* code = reinterpret_cast<unsigned char*>(rowcnt + TI);  // [TI][TJ]
  unsigned short* list = reinterpret_cast<unsigned short*>(code + CODE_BYTES);
  const int kc = min(n, KC), ks = kc | 1;                   // odd row stride
  int* ci = reinterpret_cast<int*>(smem + FIXED_BYTES);     // [TI][ks]
  int* cj = ci + TI * ks;                                   // [TJ][ks], negated
  __shared__ int subcnt[N_SUBS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;

  // -- meta of both tiles; rows past M are invalid -------------------------
  if (tid < TI + TJ) {
    const bool is_i = tid < TI;
    const int r = is_i ? tid : tid - TI, stride = is_i ? TI : TJ;
    const int g = (is_i ? i0 : j0) + r;
    int* dst = (is_i ? mi : mj) + r;
    const bool in = g < m;
    dst[CLIENT * stride] = in ? col.client[g] : 0;
    dst[KIND * stride] = in ? col.kind[g] : 0;
    dst[RESOURCE * stride] = in ? col.resource[g] : 0;
    dst[VERSION * stride] = in ? col.version[g] : 0;
    dst[SEQ * stride] = in ? col.seq[g] : 0;
    dst[VALID * stride] = in ? (col.valid[g] != 0) : 0;
  }
  if (tid < N_SUBS) subcnt[tid] = 0;
  __syncthreads();

  // -- 1. base, marked in the byte tile; the base list ---------------------
  // Thread: columns 4 lane .. 4 lane + 3 (their meta in registers), rows
  // warp + WARPS s.  The list holds sub-tile t's pairs at [t * SUB * SUB, ...).
  int jres[4], js[4], jval[4];
  {
    const int4 c = *reinterpret_cast<const int4*>(mj + RESOURCE * TJ + 4 * lane);
    const int4 e = *reinterpret_cast<const int4*>(mj + SEQ * TJ + 4 * lane);
    const int4 f = *reinterpret_cast<const int4*>(mj + VALID * TJ + 4 * lane);
    jres[0] = c.x; jres[1] = c.y; jres[2] = c.z; jres[3] = c.w;
    js[0] = e.x; js[1] = e.y; js[2] = e.z; js[3] = e.w;
    jval[0] = f.x; jval[1] = f.y; jval[2] = f.z; jval[3] = f.w;
  }
  const int seg = lane & 7;                // lane within its 8-lane (32-column) group
  for (int s = 0; s < TI / WARPS; ++s) {
    const int il = warp + WARPS * s;
    const int ival = mi[VALID * TI + il], ires = mi[RESOURCE * TI + il];
    const int iseq = mi[SEQ * TI + il];
    unsigned word = 0;
    int nb = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool base = ival && jval[q] && ires == jres[q] && iseq < js[q];
      word |= base ? (unsigned)BASE_BIT << (8 * q) : 0u;
      nb += base;
    }
    *reinterpret_cast<unsigned*>(code + il * TJ + 4 * lane) = word;
    int incl = nb;                       // prefix sum within the 8-lane group
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o, 8);
      if (seg >= o) incl += v;
    }
    const int total = __shfl_sync(FULL, incl, 7, 8);
    const int sub = (il / SUB) * SUBS_J + (lane >> 3);
    int start = 0;
    if (seg == 7 && total) start = atomicAdd(&subcnt[sub], total);
    start = __shfl_sync(FULL, start, 7, 8);
    const int row_total = __reduce_add_sync(FULL, nb);
    if (lane == 0) rowcnt[il] = row_total;
    int pos = sub * SUB * SUB + start + incl - nb;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if ((word >> (8 * q)) & BASE_BIT)
        list[pos++] = (unsigned short)(il << 7 | (4 * lane + q));
  }
  __syncthreads();
  int off[N_SUBS + 1];                     // list offsets of the sub-tiles
  off[0] = 0;
#pragma unroll
  for (int t = 0; t < N_SUBS; ++t) off[t + 1] = off[t] + subcnt[t];
  const int nbase = off[N_SUBS];

  // -- 2. happens-before of the base pairs ---------------------------------
  if (nbase > 0) {
    const int nchunks = (n + kc - 1) / kc;
    const bool vec_rows =
        (n & 3) == 0 && (reinterpret_cast<uintptr_t>(vc) & 15) == 0;
    // Chunk [k0, k0 + kn) of both tiles' clocks into shared memory, its
    // sums into rowsum (set on the first chunk).  With 16-byte loads, a
    // chunk whose values all lie in [0, 32767] is stored as int16 pairs:
    // half the shared words, and one __viaddmax_s16x2 per two components.
    auto stage = [&](int k0) -> Chunk {
      const int kn = min(kc, n - k0);
      bool pk = false;
      if (vec_rows) {
        const int kq = kn >> 2, total = (TI + TJ) * kq;
        int4 v[V4];
        bool fits = true;
#pragma unroll
        for (int u = 0; u < V4; ++u) {
          const int t = tid + u * THREADS, r = t / kq;
          const int g = (r < TI ? i0 + r : j0 + r - TI);
          v[u] = t < total && g < m
                     ? __ldg(reinterpret_cast<const int4*>(
                           vc + (size_t)g * n + k0 + 4 * (t - r * kq)))
                     : make_int4(0, 0, 0, 0);
          fits &= (unsigned)(v[u].x | v[u].y | v[u].z | v[u].w) <= 0x7fffu;
        }
        pk = __syncthreads_and(fits);
        const int kst = pk ? (kn >> 1) | 1 : ks;
#pragma unroll
        for (int u = 0; u < V4; ++u) {
          const int t = tid + u * THREADS;
          if (t >= total) break;
          const int r = t / kq, k4 = t - r * kq;
          const int sg = r < TI ? 1 : -1;          // the j rows negated
          int* d = (r < TI ? ci + r * kst : cj + (r - TI) * kst);
          if (pk) {
            d += 2 * k4;
            d[0] = pack16(sg * v[u].x, sg * v[u].y);
            d[1] = pack16(sg * v[u].z, sg * v[u].w);
          } else {
            d += 4 * k4;
            d[0] = sg * v[u].x, d[1] = sg * v[u].y, d[2] = sg * v[u].z,
            d[3] = sg * v[u].w;
          }
        }
      } else {
        for (int t = tid; t < (TI + TJ) * kn; t += THREADS) {
          const int r = t / kn, k = t - r * kn;
          if (r < TI) {
            const int g = i0 + r;
            ci[r * ks + k] = g < m ? __ldg(vc + (size_t)g * n + k0 + k) : 0;
          } else {
            const int g = j0 + r - TI;
            cj[(r - TI) * ks + k] = g < m ? -__ldg(vc + (size_t)g * n + k0 + k) : 0;
          }
        }
      }
      const Chunk ch{pk, pk ? kn >> 1 : kn, pk ? (kn >> 1) | 1 : ks};
      __syncthreads();
      // Row sums: a thread per row (the odd stride keeps them on distinct
      // banks), two accumulators.
      if (tid < TI + TJ) {
        const int* row = tid < TI ? ci + tid * ch.stride : cj + (tid - TI) * ch.stride;
        long long s0 = 0, s1 = 0;
        if (pk) {
#pragma unroll 4
          for (int w = 0; w < ch.words; ++w)
            s0 += lo16(row[w]), s1 += hi16(row[w]);
        } else {
          int k = 0;
#pragma unroll 4
          for (; k + 1 < kn; k += 2) s0 += row[k], s1 += row[k + 1];
          if (k < kn) s0 += row[k];
        }
        rowsum[tid] = (k0 == 0 ? 0 : rowsum[tid]) + s0 + s1;
      }
      __syncthreads();
      return ch;
    };
    Chunk ch = nchunks == 1 ? stage(0) : Chunk{};
    const bool dense = design == DENSE ||
        (design == AUTO && nbase * DENSE_DEN >= TI * TJ * DENSE_NUM);
    if (dense) {
      // Thread: rows warp * 8 + r, columns lane + 32 q.
      const int r0 = warp * ROWS_PER_WARP;
      int any = 0;
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) any |= rowcnt[r0 + r];
      int mx[ROWS_PER_WARP][4];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) mx[r][q] = INT_MIN;
      for (int c = 0; c < nchunks; ++c) {
        if (nchunks > 1) {
          __syncthreads();
          ch = stage(c * kc);
        }
        if (!any) continue;                           // uniform per warp
        const int* a0 = ci + r0 * ch.stride;
        const int* b0 = cj + lane * ch.stride;
        if (ch.packed) {
          unsigned x[ROWS_PER_WARP][4];
#pragma unroll
          for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) x[r][q] = pack_clamped(mx[r][q]);
#pragma unroll 2
          for (int w = 0; w < ch.words; ++w) {
            unsigned a[ROWS_PER_WARP], b[4];
#pragma unroll
            for (int r = 0; r < ROWS_PER_WARP; ++r) a[r] = a0[r * ch.stride + w];
#pragma unroll
            for (int q = 0; q < 4; ++q) b[q] = b0[32 * q * ch.stride + w];
#pragma unroll
            for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                x[r][q] = __viaddmax_s16x2(a[r], b[q], x[r][q]);
          }
#pragma unroll
          for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) mx[r][q] = max(lo16(x[r][q]), hi16(x[r][q]));
        } else {
#pragma unroll 2
          for (int k = 0; k < ch.words; ++k) {
            int a[ROWS_PER_WARP], b[4];
#pragma unroll
            for (int r = 0; r < ROWS_PER_WARP; ++r) a[r] = a0[r * ch.stride + k];
#pragma unroll
            for (int q = 0; q < 4; ++q) b[q] = b0[32 * q * ch.stride + k];
#pragma unroll
            for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                mx[r][q] = __viaddmax_s32(a[r], b[q], mx[r][q]);
          }
        }
      }
      if (any) {
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            unsigned char* p = code + (r0 + r) * TJ + lane + 32 * q;
            const unsigned char b = *p;
            if (b && mx[r][q] <= 0) *p = b | LE_BIT;
          }
      }
    } else {
      for (int e0 = 0; e0 < nbase; e0 += THREADS * EPT) {
        unsigned ent[EPT];
        int mx[EPT];
#pragma unroll
        for (int s = 0; s < EPT; ++s) {
          const int e = e0 + s * THREADS + tid;
          ent[s] = e < nbase ? list[list_at(off, e)] : 0;
          mx[s] = INT_MIN;
        }
        for (int c = 0; c < nchunks; ++c) {
          if (nchunks > 1) {
            __syncthreads();
            ch = stage(c * kc);
          }
#pragma unroll
          for (int s = 0; s < EPT; ++s) {
            if (e0 + s * THREADS + tid >= nbase) break;
            const int* a = ci + (ent[s] >> 7) * ch.stride;
            const int* b = cj + (ent[s] & 127) * ch.stride;
            int w = 0;
            if (ch.packed) {
              unsigned y0 = pack_clamped(mx[s]), y1 = y0;
#pragma unroll 4
              for (; w + 1 < ch.words; w += 2) {
                y0 = __viaddmax_s16x2(a[w], b[w], y0);
                y1 = __viaddmax_s16x2(a[w + 1], b[w + 1], y1);
              }
              if (w < ch.words) y0 = __viaddmax_s16x2(a[w], b[w], y0);
              mx[s] = max(max(lo16(y0), hi16(y0)), max(lo16(y1), hi16(y1)));
            } else {
              int x0 = mx[s], x1 = INT_MIN;
#pragma unroll 4
              for (; w + 1 < ch.words; w += 2) {
                x0 = __viaddmax_s32(a[w], b[w], x0);
                x1 = __viaddmax_s32(a[w + 1], b[w + 1], x1);
              }
              if (w < ch.words) x0 = __viaddmax_s32(a[w], b[w], x0);
              mx[s] = max(x0, x1);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < EPT; ++s) {
          if (e0 + s * THREADS + tid >= nbase) break;
          if (mx[s] <= 0) code[(ent[s] >> 7) * TJ + (ent[s] & 127)] |= LE_BIT;
        }
      }
    }
    __syncthreads();
    // Every listed pair's code: a thread per pair, whichever design ran.
    for (int e = tid; e < nbase; e += THREADS) {
      const unsigned ent = list[list_at(off, e)];
      const int il = ent >> 7, jl = ent & 127;
      unsigned char* p = code + il * TJ + jl;
      *p = settle(mi, mj, il, jl, *p & LE_BIT, rowsum[il], rowsum[TI + jl], delta);
    }
    __syncthreads();
  }

  // -- 3. the codes, written once --------------------------------------------
  const int j = j0 + 4 * lane;
  const bool vec = (m & 3) == 0 && j + 3 < m;
  for (int s = 0; s < TI / WARPS; ++s) {
    const int il = warp + WARPS * s, i = i0 + il;
    if (i >= m) break;
    const unsigned word = *reinterpret_cast<const unsigned*>(code + il * TJ + 4 * lane);
    const int4 v = make_int4(expand(word & 0xff), expand((word >> 8) & 0xff),
                             expand((word >> 16) & 0xff), expand(word >> 24));
    int* dst = out + (size_t)i * m + j;
    if (vec) {
      __stcs(reinterpret_cast<int4*>(dst), v);
    } else {
      if (j < m) __stcs(dst, v.x);
      if (j + 1 < m) __stcs(dst + 1, v.y);
      if (j + 2 < m) __stcs(dst + 2, v.z);
      if (j + 3 < m) __stcs(dst + 3, v.w);
    }
  }
}

int smem_bytes(int n) { return FIXED_BYTES + (TI + TJ) * (min(n, KC) | 1) * 4; }

}  // namespace

// vc: (m, n) int32, 16-byte aligned; client, kind, resource, version, seq:
// (m,) int32; valid: (m,) bool; out: (m, m) int32, 16-byte aligned.
// design: 0 auto, 1 dense, 2 compact.
extern "C" int vclock_audit_launch(const int* vc, const int* client,
                                   const int* kind, const int* resource,
                                   const int* version, const int* seq,
                                   const unsigned char* valid, int* out,
                                   void* stream, int m, int n, int delta,
                                   int design) {
  if (m <= 0 || n <= 0 || design < AUTO || design > COMPACT)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        audit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(KC));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const Columns col{client, kind, resource, version, seq, valid};
  dim3 grid((m + TJ - 1) / TJ, (m + TI - 1) / TI);
  audit_kernel<<<grid, THREADS, smem_bytes(n), static_cast<cudaStream_t>(stream)>>>(
      vc, col, m, n, delta, design, out);
  return (int)cudaGetLastError();
}
