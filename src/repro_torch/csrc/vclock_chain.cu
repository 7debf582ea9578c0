// The vector-clock chain of one op batch, for Hopper (sm_90a).
//
// Replaces: the lax.scan ``clock_step`` of
// repro/core/xstcc.py :: apply_op_batch, src/repro/core/xstcc.py:356-370
// (not a Pallas kernel: an XLA scan that is serial over the batch).  For
// op i of the batch, in order:
//
//   svc             = max(session_vc[c_i], replica_vc[p_i]);  svc[c_i] += 1
//   session_vc[c_i] = svc
//   if is_write[i]: replica_vc[p_i] = max(replica_vc[p_i], svc)  (= svc)
//   vcs[i]          = svc
//
// Every step is a component-wise integer max or +1, so component n of
// every clock depends only on component n of earlier ops, and any order
// of evaluation that respects the dependences is exact.  Clock values
// are assumed to stay below 2^31 - B (no clock overflows int32).
//
// Bound on the H100: 3 B index words, the clocks read once and written
// once, and the (B, C) op clocks written: (3 B + 2 (C^2 + P C) + B C) * 4
// bytes over 3.35 TB/s, and 4 B C integer operations.  Both are
// microseconds or less up to C = 64; at the serving engine's one
// component per session (C = 16,384) the 1 GiB vcs, read and written
// clocks make it ~0.96 ms.  What held the first design back was the
// serial dependence: B steps of a few dependent shared-memory (or, for
// wide clocks, device-memory) accesses.  Three designs, chosen per call
// by the wrapper (kernels/vclock_chain.py :: design_for):
//
//  * small (B <= SMALL_MAX, clocks in one block's shared memory): ONE
//    CTA, one launch.  Thread n walks the batch on column n of the
//    clocks, staged in shared memory; the op rows live in their own
//    shared arrays, so their loads run ahead of the chain.
//
//  * segments (C <= 256, P <= 64): max-plus maps.  For component n one
//    op is a max-plus linear map on column n of the C + P clock rows
//    (row c_i takes max(row c_i, row C + p_i), + 1 when n = c_i; a write
//    copies row c_i into row C + p_i), so a segment of L ops composes
//    into one such map over the rows it touches (its distinct clients
//    and the P replica rows: U <= min(L, C) + P).  One CTA per component
//    (columns are independent, so CTAs never talk), the batch in chunks
//    of S segments: (1) the S maps in parallel, one thread per (segment,
//    source row), entries 1 + the largest count of client-n ops on a
//    path (0 = no path) as bytes in shared memory, four source rows to a
//    word, so one __vmaxu4 steps four map columns; (2) a serial pass
//    over the S segments carries the column's state through the maps
//    (U x U max-plus products, eight lanes per output row); (3) one
//    thread per segment replays its L ops from its entry state and
//    writes the vcs rows.  Critical path 2 L + S steps per chunk instead
//    of S L.  One launch.
//
//  * levels (wide clocks, C > 256 or P > 64): dependence levels.  Op i
//    depends on the previous op of client c_i and on the last earlier
//    write to replica p_i; a write also on every earlier read of p_i.
//    level_plan_kernel (one CTA) ranks the ops into levels with one
//    serial pass of scalar steps in shared memory, sorts them by level,
//    and lists the session rows the batch never touches.
//    level_exec_kernel runs the levels in order, one CTA per 128
//    components (32 lanes x an int4; their columns are independent, so a
//    level ends at a __syncthreads, not a grid barrier) and one warp per
//    op, eight ops in flight per warp: a level's
//    ops touch distinct session rows, and a written replica row is
//    touched by no other op of its level.  An op whose client has no
//    earlier op reads the input clocks, the rest the running output, so
//    each session row is read once and written once: the serving read
//    batch (reads only, each session once) is ONE level and a pass
//    bound by its 3 GiB.  Two launches.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr size_t SMEM_MAX = 232448;  // shared memory one H100 block can use
constexpr unsigned FULL = 0xFFFFFFFFu;   // all lanes, as a shuffle mask

// -- small: one CTA -----------------------------------------------------------

constexpr int SMALL_CAP = 1024;      // ops the small kernel stages at once

__global__ void chain_small_kernel(const int* __restrict__ client,
                                   const int* __restrict__ replica,
                                   const int* __restrict__ is_write, int b,
                                   const int* __restrict__ session_vc,
                                   const int* __restrict__ replica_vc, int c,
                                   int p, int* __restrict__ vcs,
                                   int* __restrict__ new_session_vc,
                                   int* __restrict__ new_replica_vc) {
  extern __shared__ int smem[];
  __shared__ int s_co[SMALL_CAP];    // c_i * C
  __shared__ int s_ro[SMALL_CAP];    // p_i * C, sign bit = is_write
  int* s_svc = smem;                 // [c][c]
  int* s_rvc = s_svc + c * c;        // [p][c]

  for (int k = threadIdx.x; k < c * c; k += blockDim.x) s_svc[k] = session_vc[k];
  for (int k = threadIdx.x; k < p * c; k += blockDim.x) s_rvc[k] = replica_vc[k];
  const int n = threadIdx.x;
  const int nc = n * c;
  for (int base = 0; base < b; base += SMALL_CAP) {
    const int len = min(SMALL_CAP, b - base);
    __syncthreads();
    for (int k = threadIdx.x; k < len; k += blockDim.x) {
      s_co[k] = client[base + k] * c;
      s_ro[k] = (replica[base + k] * c) | (is_write[base + k] ? INT_MIN : 0);
    }
    __syncthreads();
    if (n < c) {
#pragma unroll 4
      for (int k = 0; k < len; ++k) {
        const int co = s_co[k], ro = s_ro[k];
        int* sp = s_svc + co + n;
        int* rp = s_rvc + (ro & INT_MAX) + n;
        const int v = max(*sp, *rp) + (co == nc);
        *sp = v;
        if (ro < 0) *rp = v;
        vcs[(size_t)(base + k) * c + n] = v;
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < c * c; k += blockDim.x) new_session_vc[k] = s_svc[k];
  for (int k = threadIdx.x; k < p * c; k += blockDim.x) new_replica_vc[k] = s_rvc[k];
}

// -- segments: max-plus maps, one CTA per component ---------------------------

constexpr int SEG_THREADS = 1024;
constexpr int PAIRS = 4;   // (segment, source row) map columns per thread

// Packed op: local client row (bits 0-7), local replica row (8-15), write
// (16), client (17-).
__device__ __forceinline__ int op_lc(int op) { return op & 0xFF; }
__device__ __forceinline__ int op_lp(int op) { return (op >> 8) & 0xFF; }
__device__ __forceinline__ bool op_w(int op) { return (op >> 16) & 1; }
__device__ __forceinline__ int op_client(int op) { return op >> 17; }

__global__ void __launch_bounds__(SEG_THREADS, 1)
chain_seg_kernel(const int* __restrict__ client, const int* __restrict__ replica,
                 const int* __restrict__ is_write, int b,
                 const int* __restrict__ session_vc,
                 const int* __restrict__ replica_vc, int c, int p, int seg_len,
                 int n_seg, int umax, int* __restrict__ vcs,
                 int* __restrict__ new_session_vc,
                 int* __restrict__ new_replica_vc) {
  extern __shared__ __align__(16) int seg_sm[];
  int* x = seg_sm;                          // [c + p] column n's running state
  int* pk = x + c + p;                      // [n_seg * seg_len] packed ops
  int* glob = pk + n_seg * seg_len;         // [n_seg][umax] local -> global row
  int* ent = glob + n_seg * umax;           // [n_seg][umax] entry state
  int* nloc = ent + n_seg * umax;           // [n_seg] distinct clients
  unsigned char* tbl = reinterpret_cast<unsigned char*>(nloc + n_seg);  // [n_seg][c]
  // [n_seg][umax][uw] words: row j of a segment's map, source rows
  // 4 kw .. 4 kw + 3 as the bytes of word kw.
  unsigned* map = reinterpret_cast<unsigned*>(tbl + ((n_seg * c + 15) & ~15));

  const int n = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int uw = (umax + 3) / 4;      // words per map row
  const int msize = umax * uw;        // words per segment map
  for (int j = tid; j < c; j += nthr) x[j] = session_vc[(size_t)j * c + n];
  for (int q = tid; q < p; q += nthr) x[c + q] = replica_vc[(size_t)q * c + n];

  const int chunk = n_seg * seg_len;
  for (int base = 0; base < b; base += chunk) {
    const int len = min(chunk, b - base);
    const int ns = (len + seg_len - 1) / seg_len;
    __syncthreads();
    // Local rows: each segment's distinct clients in client order, then
    // the P replica rows.
    for (int k = tid; k < ns * c; k += nthr) tbl[k] = 0xFF;
    __syncthreads();
    for (int k = tid; k < len; k += nthr) tbl[(k / seg_len) * c + client[base + k]] = 0;
    __syncthreads();
    for (int s = warp; s < ns; s += nwarps) {
      int cnt = 0;
      for (int cb = 0; cb < c; cb += 32) {
        const int cl = cb + lane;
        const bool present = cl < c && tbl[s * c + cl] == 0;
        const unsigned bal = __ballot_sync(FULL, present);
        if (present) {
          const int id = cnt + __popc(bal & ((1u << lane) - 1u));
          tbl[s * c + cl] = (unsigned char)id;
          glob[s * umax + id] = cl;
        }
        cnt += __popc(bal);
      }
      for (int q = lane; q < p; q += 32) glob[s * umax + cnt + q] = c + q;
      if (lane == 0) nloc[s] = cnt;
    }
    __syncthreads();
    for (int k = tid; k < len; k += nthr) {
      const int s = k / seg_len;
      const int cl = client[base + k];
      pk[k] = tbl[s * c + cl] | ((nloc[s] + replica[base + k]) << 8) |
              ((is_write[base + k] != 0) << 16) | (cl << 17);
    }
    __syncthreads();

    // (1) The maps: thread t owns map words (segment, source rows 4 kw ..
    // 4 kw + 3) t, t + nthr, ...; its PAIRS chains run interleaved, four
    // source columns per word (__vmaxu4; the +1 goes to nonzero bytes).
    {
      int seg[PAIRS], colw[PAIRS], slen[PAIRS];
#pragma unroll
      for (int r = 0; r < PAIRS; ++r) {
        const int pr = tid + r * nthr;
        const int s = pr / uw, kw = pr - (pr / uw) * uw;
        const bool on = s < ns && 4 * kw < nloc[s] + p;
        seg[r] = s;
        colw[r] = kw;
        slen[r] = on ? min(seg_len, len - s * seg_len) : 0;
        if (on) {
          unsigned* m = map + s * msize + kw;
          const int u = nloc[s] + p;
          for (int j = 0; j < u; ++j)
            m[j * uw] = (j >> 2) == kw ? 1u << (8 * (j & 3)) : 0u;
        }
      }
      for (int step = 0; step < seg_len; ++step) {
#pragma unroll
        for (int r = 0; r < PAIRS; ++r) {
          if (step < slen[r]) {
            const int op = pk[seg[r] * seg_len + step];
            unsigned* m = map + seg[r] * msize + colw[r];
            unsigned* mc = m + op_lc(op) * uw;
            unsigned* mp = m + op_lp(op) * uw;
            unsigned e = __vmaxu4(*mc, *mp);
            if (op_client(op) == n) e += __vcmpne4(e, 0u) & 0x01010101u;
            *mc = e;
            if (op_w(op)) *mp = e;
          }
        }
      }
    }
    __syncthreads();

    // (2) Carry column n's state across the segments: entry state of
    // segment s, then x[row j] = max_k (entry[k] + map[j][k] - 1).
    for (int s = 0; s < ns; ++s) {
      const int u = nloc[s] + p;
      const int* g = glob + s * umax;
      int* e0 = ent + s * umax;
      for (int k = tid; k < u; k += nthr) e0[k] = x[g[k]];
      __syncthreads();
      const unsigned* ms = map + s * msize;
      for (int jb = 0; jb < u; jb += nthr / 8) {
        const int j = jb + tid / 8, sub = tid & 7;
        int best = INT_MIN;
        if (j < u) {
          const unsigned* row = ms + j * uw;
          for (int kw = sub; 4 * kw < u; kw += 8) {
            const unsigned e4 = row[kw];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int e = (e4 >> (8 * t)) & 0xFF;
              if (e) best = max(best, e0[4 * kw + t] + e - 1);
            }
          }
        }
        best = max(best, __shfl_xor_sync(FULL, best, 1));
        best = max(best, __shfl_xor_sync(FULL, best, 2));
        best = max(best, __shfl_xor_sync(FULL, best, 4));
        if (j < u && sub == 0) x[g[j]] = best;
      }
      __syncthreads();
    }

    // (3) Replay: one thread per segment, from its entry state.
    for (int s = tid; s < ns; s += nthr) {
      int* st = ent + s * umax;
      const int k1 = min(len, (s + 1) * seg_len);
      for (int k = s * seg_len; k < k1; ++k) {
        const int op = pk[k];
        const int lc = op_lc(op), lp = op_lp(op);
        const int v = max(st[lc], st[lp]) + (op_client(op) == n);
        st[lc] = v;
        if (op_w(op)) st[lp] = v;
        vcs[(size_t)(base + k) * c + n] = v;
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < c; j += nthr) new_session_vc[(size_t)j * c + n] = x[j];
  for (int q = tid; q < p; q += nthr) new_replica_vc[(size_t)q * c + n] = x[c + q];
}

// -- levels: dependence levels, one CTA per tile of components ---------------

constexpr int PLAN_THREADS = 1024;
constexpr int PLAN_CHUNK = 2048;     // ops staged per serial pass
constexpr int EXEC_THREADS = 512;
constexpr int EXEC_UNROLL = 8;       // ops a warp has in flight

// The scratch the wrapper allocates (int32 words): sorted (int4 per op),
// level code per op, level ends, untouched rows, meta, client table.
struct LevelScratch {
  int4* sorted;     // [b] {op, client, replica, write | first << 1} by level
  int* code;        // [b] level << 1 | first touch
  int* ends;        // [b + 2] after the plan: ends[l] = end of level l
  int* untouched;   // [c] session rows no op touches
  int* meta;        // [4] depth, number of untouched rows
  int* gtbl;        // [c] client table in device memory, or null
};

__device__ __forceinline__ int lanemask_lt() {
  return (int)((1u << (threadIdx.x & 31)) - 1u);
}

// TBL_SMEM: the client table in shared memory (typed shared accesses, so
// the walk's loads of the staged ops never wait on its table stores), or
// in device memory for clients beyond LEVEL_TBL_SMEM.
template <bool TBL_SMEM>
__global__ void __launch_bounds__(PLAN_THREADS)
level_plan_kernel(const int* __restrict__ client, const int* __restrict__ replica,
                  const int* __restrict__ is_write, int b, int c, int p,
                  LevelScratch sc) {
  extern __shared__ int plan_sm[];
  __shared__ int s_c[PLAN_CHUNK + 2];
  __shared__ int s_p[PLAN_CHUNK + 2];   // 2 p_i + is_write: R[] or W[] index
  __shared__ int s_l[PLAN_CHUNK];
  __shared__ int s_depth, s_nu;
  int* rw = plan_sm;                 // [2p]: W[q] = rw[2q], R[q] = rw[2q + 1]
  int* tbl = TBL_SMEM ? plan_sm + 2 * p : sc.gtbl;   // [c] last level of each client
  const int tid = threadIdx.x, nthr = blockDim.x;

  for (int j = tid; j < c; j += nthr) tbl[j] = 0;
  for (int q = tid; q < 2 * p; q += nthr) rw[q] = 0;
  for (int l = tid; l < b + 2; l += nthr) sc.ends[l] = 0;
  if (tid == 0) {
    s_depth = 0;
    s_nu = 0;
  }
  // Level of op i: 1 + max(level of client c_i's previous op, level of
  // the last write to p_i; for a write, of every read of p_i since).
  // R[q] >= W[q] always, so a write needs R[p_i] only.
  for (int base = 0; base < b; base += PLAN_CHUNK) {
    const int len = min(PLAN_CHUNK, b - base);
    __syncthreads();
    for (int k = tid; k < len + 2; k += nthr) {   // two padding ops: client 0, replica 0
      s_c[k] = k < len ? client[base + k] : 0;
      s_p[k] = k < len ? 2 * replica[base + k] + (is_write[base + k] != 0) : 0;
    }
    __syncthreads();
    if (tid == 0) {
      // Pipelined by one op: op k + 1's table reads are issued before op
      // k's writes, then corrected from op k's level where they alias,
      // so the chain from level to level is a few register operations.
      // The op rows run two ahead, so each step waits on one load; the
      // padding ops' reads are never used.
      int depth = s_depth;
      int ci = s_c[0], pw = s_p[0];
      int t = tbl[ci], d = rw[pw], rr = rw[pw | 1];
      int cn = s_c[1], pn = s_p[1];
#pragma unroll 4
      for (int k = 0; k < len; ++k) {
        const int c2 = s_c[k + 2], p2 = s_p[k + 2];
        int tn = tbl[cn], dn = rw[pn], rn = rw[pn | 1];
        const int l = 1 + max(t, d);
        const int rnew = (pw & 1) ? l : max(rr, l);   // R[p] after op k
        tbl[ci] = l;
        if (pw & 1) rw[pw - 1] = l;                   // a write: W[p] = l
        rw[pw | 1] = rnew;
        s_l[k] = (l << 1) | (t == 0);
        depth = max(depth, l);
        if (cn == ci) tn = l;
        if ((pn >> 1) == (pw >> 1)) {
          dn = (pn & 1) ? rnew : ((pw & 1) ? l : dn);
          rn = rnew;
        }
        ci = cn;
        pw = pn;
        t = tn;
        d = dn;
        rr = rn;
        cn = c2;
        pn = p2;
      }
      s_depth = depth;
    }
    __syncthreads();
    for (int k = tid; k < len; k += nthr) sc.code[base + k] = s_l[k];
  }
  __syncthreads();
  const int depth = s_depth;

  // Count the ops of each level (one atomic per distinct level per warp).
  for (int i0 = 0; i0 < b; i0 += nthr) {
    const int i = i0 + tid;
    const int l = i < b ? sc.code[i] >> 1 : 0;
    const unsigned peers = __match_any_sync(FULL, l);
    if (i < b && (int)(__ffs(peers) - 1) == (tid & 31))
      atomicAdd(&sc.ends[l], __popc(peers));
  }
  __syncthreads();
  // Exclusive scan of the counts over levels 1..depth: ends[l] = start.
  __shared__ int s_warp[PLAN_THREADS / 32];
  __shared__ int s_carry;
  if (tid == 0) s_carry = 0;
  __syncthreads();
  for (int l0 = 1; l0 <= depth; l0 += nthr) {
    const int l = l0 + tid;
    const int v = l <= depth ? sc.ends[l] : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, d);
      if ((tid & 31) >= d) incl += y;
    }
    if ((tid & 31) == 31) s_warp[tid >> 5] = incl;
    __syncthreads();
    if (tid < 32) {
      int w = tid < nthr / 32 ? s_warp[tid] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, w, d);
        if (tid >= d) w += y;
      }
      s_warp[tid] = w;   // inclusive prefix of the warp totals
    }
    __syncthreads();
    const int before = s_carry + ((tid >> 5) ? s_warp[(tid >> 5) - 1] : 0);
    if (l <= depth) sc.ends[l] = before + incl - v;
    __syncthreads();
    if (tid == nthr - 1) s_carry = before + incl;
    __syncthreads();
  }
  // Scatter the ops into level order; ends[l] moves to the level's end.
  for (int i0 = 0; i0 < b; i0 += nthr) {
    const int i = i0 + tid;
    const int code = i < b ? sc.code[i] : 0;
    const int l = code >> 1;
    const unsigned peers = __match_any_sync(FULL, l);
    const int leader = __ffs(peers) - 1;
    int pos = 0;
    if (i < b && leader == (tid & 31)) pos = atomicAdd(&sc.ends[l], __popc(peers));
    pos = __shfl_sync(FULL, pos, leader);
    if (i < b) {
      pos += __popc(peers & lanemask_lt());
      sc.sorted[pos] = make_int4(i, client[i], replica[i],
                                 (is_write[i] != 0) | ((code & 1) << 1));
    }
  }
  // The session rows no op touches, for the executor to copy.
  for (int j0 = 0; j0 < c; j0 += nthr) {
    const int j = j0 + tid;
    const bool un = j < c && tbl[j] == 0;
    const unsigned bal = __ballot_sync(FULL, un);
    int at = 0;
    if ((tid & 31) == 0 && bal) at = atomicAdd(&s_nu, __popc(bal));
    at = __shfl_sync(FULL, at, 0);
    if (un) sc.untouched[at + __popc(bal & lanemask_lt())] = j;
  }
  __syncthreads();
  if (tid == 0) {
    sc.meta[0] = depth;
    sc.meta[1] = s_nu;
  }
}

// VEC consecutive components per lane: int4 loads and stores where C is a
// multiple of 4 (a warp moves 512 contiguous bytes of a row), int else.
template <int VEC> struct Lanes;
template <> struct Lanes<1> {
  using T = int;
  static __device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }
  static __device__ __forceinline__ int bump(int v, int n0, int ci) { return v + (n0 == ci); }
};
template <> struct Lanes<4> {
  using T = int4;
  static __device__ __forceinline__ int4 vmax(int4 a, int4 b) {
    return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z), max(a.w, b.w));
  }
  static __device__ __forceinline__ int4 bump(int4 v, int n0, int ci) {
    return make_int4(v.x + (n0 == ci), v.y + (n0 + 1 == ci), v.z + (n0 + 2 == ci),
                     v.w + (n0 + 3 == ci));
  }
};

template <int VEC>
__global__ void __launch_bounds__(EXEC_THREADS)
level_exec_kernel(const int4* __restrict__ sorted, const int* __restrict__ ends,
                  const int* __restrict__ untouched, const int* __restrict__ meta,
                  int c, int p, const int* __restrict__ session_vc,
                  const int* __restrict__ replica_vc, int* __restrict__ vcs,
                  int* new_session_vc, int* __restrict__ new_replica_vc) {
  using L = Lanes<VEC>;
  using T = typename L::T;
  constexpr int TILE = 32 * VEC;
  extern __shared__ __align__(16) int r_sh[];   // [p][TILE] the tile's replica columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int n0 = blockIdx.x * TILE + lane * VEC;   // this lane's first component
  const bool on = n0 < c;
  T* rt = reinterpret_cast<T*>(r_sh) + lane;       // row q at rt[q * 32]
  if (on) {
    for (int q = warp; q < p; q += nw)
      rt[q * 32] = *reinterpret_cast<const T*>(replica_vc + (size_t)q * c + n0);
  }
  const int depth = meta[0], nu = meta[1];
  if (on) {
    for (int u = warp; u < nu; u += nw) {
      const size_t j = untouched[u];
      *reinterpret_cast<T*>(new_session_vc + j * c + n0) =
          *reinterpret_cast<const T*>(session_vc + j * c + n0);
    }
  }
  __syncthreads();
  int start = 0;
  int end = depth >= 1 ? ends[1] : 0;
  for (int l = 1; l <= depth; ++l) {
    const int next_end = l < depth ? ends[l + 1] : 0;
    for (int k0 = start + warp * EXEC_UNROLL; k0 < end; k0 += nw * EXEC_UNROLL) {
      int4 op[EXEC_UNROLL];
      T sv[EXEC_UNROLL];
#pragma unroll
      for (int u = 0; u < EXEC_UNROLL; ++u)
        op[u] = k0 + u < end ? sorted[k0 + u] : make_int4(-1, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < EXEC_UNROLL; ++u) {
        if (op[u].x >= 0 && on) {
          const int* src = (op[u].w & 2) ? session_vc : new_session_vc;
          sv[u] = *reinterpret_cast<const T*>(src + (size_t)op[u].y * c + n0);
        }
      }
#pragma unroll
      for (int u = 0; u < EXEC_UNROLL; ++u) {
        if (op[u].x >= 0 && on) {
          T* rp = rt + op[u].z * 32;
          const T v = L::bump(L::vmax(sv[u], *rp), n0, op[u].y);
          *reinterpret_cast<T*>(new_session_vc + (size_t)op[u].y * c + n0) = v;
          *reinterpret_cast<T*>(vcs + (size_t)op[u].x * c + n0) = v;
          if (op[u].w & 1) *rp = v;
        }
      }
    }
    start = end;
    end = next_end;
    __syncthreads();
  }
  if (on) {
    for (int q = warp; q < p; q += nw)
      *reinterpret_cast<T*>(new_replica_vc + (size_t)q * c + n0) = rt[q * 32];
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// client/replica/is_write: (b,) int32; session_vc: (c, c); replica_vc:
// (p, c); outputs vcs (b, c), new_session_vc (c, c), new_replica_vc (p, c).
// shape packs b (bits 0-31) and c (32-63); plan packs p (bits 0-19), the
// design (20-21: 0 small, 1 segments, 2 levels), the level design's
// client table in shared memory (22), and the segment plan's seg_len
// (24-31), n_seg (32-47) and umax (48-55) from the wrapper.  scratch: the
// level design's int32 buffer, laid out as kernels/vclock_chain.py ::
// level_scratch_words says.  The fewer arguments, the cheaper the call
// from Python.
extern "C" int vclock_chain_launch(const int* client, const int* replica,
                                   const int* is_write, const int* session_vc,
                                   const int* replica_vc, int* vcs,
                                   int* new_session_vc, int* new_replica_vc,
                                   int* scratch, void* stream, long long shape,
                                   long long plan) {
  const int b = (int)(shape & 0xFFFFFFFFll), c = (int)(shape >> 32);
  const int p = (int)(plan & 0xFFFFF), design = (int)((plan >> 20) & 3);
  const int tbl_in_smem = (int)((plan >> 22) & 1);
  const int seg_len = (int)((plan >> 24) & 0xFF), n_seg = (int)((plan >> 32) & 0xFFFF);
  const int umax = (int)((plan >> 48) & 0xFF);
  if (c <= 0 || p <= 0 || b <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    const size_t smem = ((size_t)c * c + (size_t)p * c) * sizeof(int);
    if (c > 1024 || smem + 2 * SMALL_CAP * sizeof(int) > SMEM_MAX)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = set_smem((const void*)chain_small_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const int threads = ((c + 31) / 32) * 32;
    chain_small_kernel<<<1, threads, smem, s>>>(client, replica, is_write, b,
                                                session_vc, replica_vc, c, p, vcs,
                                                new_session_vc, new_replica_vc);
    return (int)cudaGetLastError();
  }
  if (design == 1) {
    if (c > 256 || p > 64 || seg_len < 1 || seg_len > 128 || n_seg < 1 ||
        umax < (seg_len < c ? seg_len : c) + p || umax > 255 ||
        n_seg * ((umax + 3) / 4) > SEG_THREADS * PAIRS)
      return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(c + p) * 4 + (size_t)n_seg * seg_len * 4 +
                        (size_t)n_seg * umax * 8 + (size_t)n_seg * 4 +
                        (((size_t)n_seg * c + 15) & ~(size_t)15) +
                        (size_t)n_seg * umax * ((umax + 3) / 4) * 4;
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t e = set_smem((const void*)chain_seg_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    chain_seg_kernel<<<c, SEG_THREADS, smem, s>>>(
        client, replica, is_write, b, session_vc, replica_vc, c, p, seg_len,
        n_seg, umax, vcs, new_session_vc, new_replica_vc);
    return (int)cudaGetLastError();
  }
  if (design != 2) return (int)cudaErrorInvalidValue;
  LevelScratch sc;
  sc.sorted = reinterpret_cast<int4*>(scratch);
  sc.code = scratch + 4 * (size_t)b;
  sc.ends = sc.code + b;
  sc.untouched = sc.ends + (b + 2);
  sc.meta = sc.untouched + c;
  sc.gtbl = tbl_in_smem ? nullptr : sc.meta + 4;
  const auto al16 = [](const void* ptr) { return ((size_t)ptr & 15) == 0; };
  const int vec = c % 4 == 0 && al16(session_vc) && al16(replica_vc) && al16(vcs) &&
                  al16(new_session_vc) && al16(new_replica_vc) ? 4 : 1;
  const size_t plan_smem = (2 * (size_t)p + (tbl_in_smem ? (size_t)c : 0)) * sizeof(int);
  const size_t exec_smem = (size_t)p * 32 * vec * sizeof(int);
  if (plan_smem + (3 * PLAN_CHUNK + 4) * sizeof(int) + 64 * 4 > SMEM_MAX ||
      exec_smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const void* exec = vec == 4 ? (const void*)level_exec_kernel<4>
                              : (const void*)level_exec_kernel<1>;
  const void* plan_fn = tbl_in_smem ? (const void*)level_plan_kernel<true>
                                     : (const void*)level_plan_kernel<false>;
  cudaError_t e = set_smem(plan_fn, plan_smem);
  if (e == cudaSuccess) e = set_smem(exec, exec_smem);
  if (e != cudaSuccess) return (int)e;
  if (tbl_in_smem)
    level_plan_kernel<true><<<1, PLAN_THREADS, plan_smem, s>>>(client, replica,
                                                                is_write, b, c, p, sc);
  else
    level_plan_kernel<false><<<1, PLAN_THREADS, plan_smem, s>>>(client, replica,
                                                                 is_write, b, c, p, sc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = (c + 32 * vec - 1) / (32 * vec);
  if (vec == 4)
    level_exec_kernel<4><<<tiles, EXEC_THREADS, exec_smem, s>>>(
        sc.sorted, sc.ends, sc.untouched, sc.meta, c, p, session_vc, replica_vc,
        vcs, new_session_vc, new_replica_vc);
  else
    level_exec_kernel<1><<<tiles, EXEC_THREADS, exec_smem, s>>>(
        sc.sorted, sc.ends, sc.untouched, sc.meta, c, p, session_vc, replica_vc,
        vcs, new_session_vc, new_replica_vc);
  return (int)cudaGetLastError();
}
