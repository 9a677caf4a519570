// Exact y-drop chunk kernel for NVIDIA Hopper (sm_90a), called from JAX
// through the XLA FFI (lastz_tpu/ops/ydrop_cuda.py builds and binds it).
//
// It computes exactly what ops/ydrop_exact._chunk_one computes: up to
// `rows` DP rows of the reference's one-sided y-drop sweep
// (gapped_extend.c:3388-3860) for each (anchor, direction) lane,
// resuming from and returning the same per-lane state, and emitting
// the same per-row traceback link bytes.  Every value is int32 with
// two's-complement wraparound, as in the XLA program, so results are
// bit-identical.
//
// Layout: one thread block per lane; the lane's `lanes`-wide row
// window lives in registers (CPT contiguous cells per thread), and the
// whole row loop runs inside the block.  Each row is the two-pass row
// of docs/two_pass_exact_row.md:
//   pass 1: exclusive prefix max of the reset-free decayed I chain,
//           then exclusive prefix max of the substitution cells (the
//           running best) -> gap / pruned decisions;
//   pass 2: one segmented ("decayed max with resets") inclusive scan
//           -> the exact I values and the row's exit insertion value.
// Each block-wide scan is a per-thread serial scan, a warp-shuffle
// scan over the thread totals and one shared-memory pass over the warp
// totals: one __syncthreads per scan, four per row in all.  The
// compact-alphabet substitution table sits in shared memory, and each
// row's link bytes are staged in shared memory and stored as 16-byte
// coalesced row writes.
//
// Packed per-lane scalars (column order, shared with ydrop_cuda.py):
// SCAL_IN: b_off shift M N LY RY row best end1 end2 bscore bflag tbp rows_used maxRY status done
// SCAL_OUT: LY RY row best end1 end2 bscore bflag tbp rows_used maxRY status done

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int NEG = -1932735283;      // reference negInfinity
constexpr int SENT32 = -(1 << 30);    // "no candidate" sentinel
constexpr int ISENT = -2080000000;    // I-chain identity
constexpr int C_FROM_I = 1;
constexpr int C_FROM_D = 2;
constexpr int I_EXTEND = 4;
constexpr int D_EXTEND = 8;
constexpr int ST_WIDTH_OVERFLOW = 1;
constexpr int ST_TRUNCATED = 8;
constexpr int NSIN = 17;
constexpr int NSOUT = 13;
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_ALPHA = 16;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
// floor division for b > 0 (jnp.floor_divide semantics)
__device__ __forceinline__ int floordiv_pos(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
// segmented-scan operator: (s1,r1) x (s2,r2) = (r2 ? s2 : max(s1,s2), r1|r2)
__device__ __forceinline__ void seg_combine(int& s, int& r, int s2, int r2) {
  s = r2 ? s2 : max(s, s2);
  r = r | r2;
}

struct Params {
  const int* a;        // (B, rows) compact row codes
  const int* b;        // (B, W) compact column codes
  const int* cc_in;    // (B, W)
  const int* dd_in;    // (B, W)
  const int* scal_in;  // (B, NSIN)
  const int* sub;      // (K, K) compact substitution scores
  int* cc_out;
  int* dd_out;
  int* scal_out;       // (B, NSOUT)
  uint8_t* tb;         // (B, rows + 1, W)
  int W, rows, K;
  int gap_e, gap_oe, y_drop, y_drop_tail, tb_cap, trim;
};

// Store bytes [0, W) of `src` (shared) to `dst` (global): 16-byte
// vectors when both are aligned, bytes otherwise.
__device__ __forceinline__ void store_row(uint8_t* dst, const uint8_t* src,
                                          int W, bool vec) {
  if (vec) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int j = threadIdx.x; j < W / 16; j += blockDim.x) d[j] = s[j];
  } else {
    for (int j = threadIdx.x; j < W; j += blockDim.x) dst[j] = src[j];
  }
}

template <int CPT>
__global__ void __launch_bounds__(MAX_THREADS)
    ydrop_chunk_kernel(Params p) {
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const int wl = t & 31;
  const int wid = t >> 5;
  const int nw = blockDim.x >> 5;
  const int W = p.W;
  const int K = p.K;
  const int gap_e = p.gap_e, gap_oe = p.gap_oe, y_drop = p.y_drop;

  extern __shared__ __align__(16) uint8_t stage[];  // one row of links
  __shared__ int sub_s[MAX_ALPHA * MAX_ALPHA];
  __shared__ int sw1[MAX_WARPS], sw2[MAX_WARPS];
  __shared__ int sw3s[MAX_WARPS], sw3r[MAX_WARPS];
  __shared__ long long skbest[MAX_WARPS], skb[MAX_WARPS];
  __shared__ int sfirst[MAX_WARPS], snpk[MAX_WARPS];
  __shared__ int sedge[MAX_WARPS];
  __shared__ int sq_s, sq_r;

  for (int j = t; j < K * K; j += blockDim.x) sub_s[j] = p.sub[j];

  const int* sc = p.scal_in + (size_t)lane * NSIN;
  const int b_off = sc[0], shift = sc[1], M = sc[2], N = sc[3];
  int LY = sc[4], RY = sc[5], row = sc[6], best = sc[7];
  int end1 = sc[8], end2 = sc[9], bscore = sc[10], bflag = sc[11];
  int tbp = sc[12], rows_used = sc[13], maxRY = sc[14];
  int status = sc[15], done = sc[16];
  int stop = done;

  // window re-anchor: the state arrives with origin b_off - shift
  // (dynamic_slice semantics: the start index is clamped to [0, W])
  const int sh = min(max(shift, 0), W);
  int cc[CPT], dd[CPT], bc[CPT];
  const size_t lw = (size_t)lane * W;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int l = t * CPT + i;
    cc[i] = NEG;
    dd[i] = NEG;
    bc[i] = 0;
    if (l < W) {
      if (sh + l < W) {
        cc[i] = p.cc_in[lw + sh + l];
        dd[i] = p.dd_in[lw + sh + l];
      }
      bc[i] = p.b[lw + l];
    }
  }
  if (wl == 31) sedge[wid] = cc[CPT - 1];

  uint8_t* tb_lane = p.tb + (size_t)lane * (p.rows + 1) * W;
  const bool vec = (W % 16) == 0;
  const int* a_lane = p.a + (size_t)lane * p.rows;
  int next_row = 1;   // next tb row to store (row 0 stays zero)
  int pending = 0;    // staged row waiting to be stored
  __syncthreads();

  for (int r = 0; r < p.rows; ++r) {
    if (stop) break;
    // truncation check (gapped_extend.c:3621-3660), before the row
    const int tb_needed = wadd(max(wsub(RY, LY), 0), p.y_drop_tail);
    if (wadd(tbp, tb_needed) >= p.tb_cap) {
      status |= ST_TRUNCATED;
      done = 1;
      stop = 1;
      break;
    }
    const int a_code = min(max(a_lane[r], 0), K - 1);
    const int* srow = sub_s + a_code * K;
    const int LYr = wsub(LY, b_off);
    const int RYr = wsub(RY, b_off);

    // ---- pass 1a: substitution candidates + reset-free I chain ----
    int left = __shfl_up_sync(FULL, cc[CPT - 1], 1);
    if (wl == 0) left = wid > 0 ? sedge[wid - 1] : NEG;
    int csub[CPT], dv[CPT], eff[CPT];
    unsigned act = 0;
    int tot = ISENT;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int l = t * CPT + i;
      const bool a_ok = (l < W) && (l >= LYr) && (l < RYr);
      if (a_ok) act |= 1u << i;
      const int ccl = (l == 0) ? NEG : (i == 0 ? left : cc[i - 1]);
      const int s = (bc[i] >= 0 && bc[i] < K) ? srow[bc[i]] : 0;
      const int d = a_ok ? dd[i] : NEG;
      const int c = (a_ok && l > LYr) ? wadd(ccl, s) : NEG;
      const int comp = wmul(l + 1, gap_e);
      eff[i] = (a_ok && d <= c) ? wadd(wsub(c, gap_oe), comp) : ISENT;
      csub[i] = c;
      dv[i] = d;
      tot = max(tot, eff[i]);
    }
    // store the previous row's staged links (visible since the last
    // barrier of that row)
    if (pending) {
      store_row(tb_lane + (size_t)next_row * W, stage, W, vec);
      ++next_row;
      pending = 0;
    }
    int incl = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(FULL, incl, o);
      if (wl >= o) incl = max(incl, n);
    }
    int excl = __shfl_up_sync(FULL, incl, 1);
    if (wl == 0) excl = ISENT;
    if (wl == 31) sw1[wid] = incl;
    __syncthreads();  // S1

    // ---- pass 1b: gap decisions, running-best candidates ----
    int run = excl;
    for (int w = 0; w < wid; ++w) run = max(run, sw1[w]);
    int cand[CPT], cb[CPT];
    unsigned gapm = 0;
    tot = SENT32;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int l = t * CPT + i;
      const bool a_ok = (act >> i) & 1u;
      const int sff = run;
      run = max(run, eff[i]);
      const int iff = max(wsub(sff, wmul(l, gap_e)), NEG);
      const bool g = a_ok && (dv[i] > csub[i] || iff > csub[i]);
      if (g) gapm |= 1u << i;
      cand[i] = max(max(csub[i], dv[i]), iff);
      cb[i] = (a_ok && !g) ? csub[i] : SENT32;
      tot = max(tot, cb[i]);
    }
    incl = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(FULL, incl, o);
      if (wl >= o) incl = max(incl, n);
    }
    excl = __shfl_up_sync(FULL, incl, 1);
    if (wl == 0) excl = SENT32;
    if (wl == 31) sw2[wid] = incl;
    __syncthreads();  // S2

    // ---- pass 1c: pruning; pass 2 elements; row reductions ----
    run = excl;
    for (int w = 0; w < wid; ++w) run = max(run, sw2[w]);
    int es[CPT];
    unsigned prm = 0, rsm = 0;
    long long kbest = LLONG_MIN, kb = LLONG_MIN;
    int first = INT_MAX, npk = -1;
    int ts = ISENT, tr = 0;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int l = t * CPT + i;
      const bool a_ok = (act >> i) & 1u;
      const bool g = (gapm >> i) & 1u;
      const int pm = run;
      run = max(run, cb[i]);
      const int bb = max(best, pm);
      const bool pr = a_ok && cand[i] < wsub(bb, y_drop);
      if (pr) prm |= 1u << i;
      const bool rs = pr || (l < LYr);
      if (rs) rsm |= 1u << i;
      const bool seed = a_ok && !pr && !g;
      const int comp = wmul(l + 1, gap_e);
      es[i] = rs ? wadd(NEG, comp)
                 : (seed ? wadd(wsub(csub[i], gap_oe), comp) : ISENT);
      seg_combine(ts, tr, es[i], rs ? 1 : 0);
      if (seed) {  // eligible for best / boundary updates
        // (score, lane) ordered lexicographically: the max is the row
        // maximum at its last (rightmost) attaining cell
        const long long key = (long long)csub[i] * 4294967296LL + l;
        kbest = max(kbest, key);
        if (!p.trim && (row == M || wadd(b_off, l) == N)) kb = max(kb, key);
      }
      if (a_ok && !pr) {
        first = min(first, l);
        npk = max(npk, l);
      }
    }
    int wi_s = ts, wi_r = tr;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int ns = __shfl_up_sync(FULL, wi_s, o);
      const int nr = __shfl_up_sync(FULL, wi_r, o);
      if (wl >= o) {
        int s2 = ns, r2 = nr;
        seg_combine(s2, r2, wi_s, wi_r);
        wi_s = s2;
        wi_r = r2;
      }
    }
    int we_s = __shfl_up_sync(FULL, wi_s, 1);
    int we_r = __shfl_up_sync(FULL, wi_r, 1);
    if (wl == 0) {
      we_s = ISENT;
      we_r = 0;
    }
    if (wl == 31) {
      sw3s[wid] = wi_s;
      sw3r[wid] = wi_r;
    }
    // the row's exit cell q: its owner publishes the warp-local
    // inclusive scan value there
    const int q = min(max(RYr - 1, 0), W - 1);
    if (q / CPT == t) {
      int s = we_s, rr = we_r;
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        if (t * CPT + i <= q) seg_combine(s, rr, es[i], (rsm >> i) & 1u);
      sq_s = s;
      sq_r = rr;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      kbest = max(kbest, __shfl_xor_sync(FULL, kbest, o));
      kb = max(kb, __shfl_xor_sync(FULL, kb, o));
      first = min(first, __shfl_xor_sync(FULL, first, o));
      npk = max(npk, __shfl_xor_sync(FULL, npk, o));
    }
    if (wl == 0) {
      skbest[wid] = kbest;
      skb[wid] = kb;
      sfirst[wid] = first;
      snpk[wid] = npk;
    }
    __syncthreads();  // S3

    // ---- pass 2: exact I values; row scalars; cell updates ----
    int ps = ISENT, pr_ = 0;
    for (int w = 0; w < wid; ++w) seg_combine(ps, pr_, sw3s[w], sw3r[w]);
    seg_combine(ps, pr_, we_s, we_r);
    kbest = skbest[0];
    kb = skb[0];
    first = sfirst[0];
    npk = snpk[0];
    for (int w = 1; w < nw; ++w) {
      kbest = max(kbest, skbest[w]);
      kb = max(kb, skb[w]);
      first = min(first, sfirst[w]);
      npk = max(npk, snpk[w]);
    }
    int qs = ISENT, qr = 0;
    const int wq = (q / CPT) >> 5;
    for (int w = 0; w < wq; ++w) seg_combine(qs, qr, sw3s[w], sw3r[w]);
    seg_combine(qs, qr, sq_s, sq_r);
    const int i_exit = wsub(qs, wmul(RYr, gap_e));

    const bool any_best = kbest != LLONG_MIN;
    const int row_max = any_best ? (int)(kbest >> 32) : SENT32;
    const int k_best = any_best ? (int)(kbest & 0x7fffffff) : -1;
    const bool fires_best = any_best && row_max >= best;
    const bool any_b = kb != LLONG_MIN;
    const int b_max = any_b ? (int)(kb >> 32) : SENT32;
    const int k_b = any_b ? (int)(kb & 0x7fffffff) : -1;
    const bool fires_b = any_b && b_max >= bscore;
    const bool use_b = fires_b && (!fires_best || k_b >= k_best);
    const bool use_best = fires_best && !use_b;
    if (use_b || use_best) end1 = row;
    if (use_b) {
      end2 = wadd(b_off, k_b);
      bflag = 1;
    } else if (use_best) {
      end2 = wadd(b_off, k_best);
      bflag = 0;
    }
    if (fires_best) best = row_max;
    if (fires_b) bscore = b_max;

    const int first_live = (first != INT_MAX) ? first : RYr;
    const int LY_new = wadd(b_off, first_live);
    const int np_col = wadd(b_off, npk);
    const bool dead = LY_new >= RY;
    const int Kw = wsub(RY, LY);
    const bool shrink = RY > wadd(np_col, 1);
    const int thresh = wsub(best, y_drop);
    const int p_raw = gap_e != 0
        ? wadd(floordiv_pos(wsub(i_exit, thresh), gap_e), 1) : (1 << 30);
    const int p_hi = max(wsub(wadd(N, 1), RY), 0);
    const int pl = (shrink || i_exit < thresh) ? 0
                                               : min(max(p_raw, 0), p_hi);
    const int RY_shrunk = shrink ? wadd(np_col, 1) : wadd(RY, pl);
    const bool has_sent = RY_shrunk <= N;
    const int RY_final = wadd(RY_shrunk, has_sent ? 1 : 0);
    const int sent_l = wsub(RY_shrunk, b_off);

#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int l = t * CPT + i;
      const bool a_ok = (act >> i) & 1u;
      const bool g = (gapm >> i) & 1u;
      const bool prn = (prm >> i) & 1u;
      const int s_excl = (l == 0) ? NEG : ps;
      seg_combine(ps, pr_, es[i], (rsm >> i) & 1u);
      const int i_vec = wsub(s_excl, wmul(l, gap_e));
      const int c = csub[i];
      const int d = dv[i];
      const int c_open = wsub(c, gap_oe);
      const int d_dec = wsub(d, gap_e);
      const int i_dec = wsub(i_vec, gap_e);
      const bool dead_cell = prn || !a_ok;
      int link;
      if (dead_cell) {
        link = 0;
      } else if (g) {
        link = (d >= i_vec ? C_FROM_D : C_FROM_I) | I_EXTEND | D_EXTEND;
      } else {
        link = (c_open > d_dec ? 0 : D_EXTEND) | (c_open > i_dec ? 0 : I_EXTEND);
      }
      int cc_new = dead_cell ? NEG : (g ? max(d, i_vec) : c);
      int dd_new = dead_cell ? NEG : (g ? d_dec : max(c_open, d_dec));
      const int pj = wsub(l, RYr);
      const bool prolong = pj >= 0 && pj < pl;
      if (prolong) {
        cc_new = wsub(i_exit, wmul(pj, gap_e));
        dd_new = wsub(cc_new, gap_oe);
        link = C_FROM_I;
      }
      if (has_sent && l == sent_l) {
        cc_new = NEG;
        dd_new = NEG;
      }
      cc[i] = cc_new;
      dd[i] = dd_new;
      if (l < W) stage[l] = (uint8_t)link;
    }
    if (wl == 31) sedge[wid] = cc[CPT - 1];
    pending = 1;

    const bool window_end = wsub(RY_final, b_off) > W;
    const bool width_over =
        (wsub(RY_final, LY_new) > W) || (wadd(Kw, pl) > W);
    if (width_over && !dead) status |= ST_WIDTH_OVERFLOW;
    done = done || dead || row >= M || width_over;
    stop = done || window_end;
    tbp = wadd(wadd(tbp, Kw), pl);
    LY = LY_new;
    RY = RY_final;
    rows_used = row;
    row = row + 1;
    maxRY = max(maxRY, RY_final);
    __syncthreads();  // S4
  }

  __syncthreads();
  if (pending) {
    store_row(tb_lane + (size_t)next_row * W, stage, W, vec);
    ++next_row;
  }
  // rows never computed (and row 0) carry zero links
  if (vec) {
    uint4* d = reinterpret_cast<uint4*>(tb_lane);
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (int j = t; j < W / 16; j += blockDim.x) d[j] = z;
    const size_t lo = (size_t)next_row * (W / 16);
    const size_t hi = (size_t)(p.rows + 1) * (W / 16);
    for (size_t j = lo + t; j < hi; j += blockDim.x) d[j] = z;
  } else {
    for (int j = t; j < W; j += blockDim.x) tb_lane[j] = 0;
    const size_t lo = (size_t)next_row * W;
    const size_t hi = (size_t)(p.rows + 1) * W;
    for (size_t j = lo + t; j < hi; j += blockDim.x) tb_lane[j] = 0;
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int l = t * CPT + i;
    if (l < W) {
      p.cc_out[lw + l] = cc[i];
      p.dd_out[lw + l] = dd[i];
    }
  }
  if (t == 0) {
    int* so = p.scal_out + (size_t)lane * NSOUT;
    so[0] = LY;
    so[1] = RY;
    so[2] = row;
    so[3] = best;
    so[4] = end1;
    so[5] = end2;
    so[6] = bscore;
    so[7] = bflag;
    so[8] = tbp;
    so[9] = rows_used;
    so[10] = maxRY;
    so[11] = status;
    so[12] = done;
  }
}

template <int CPT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  int threads = (p.W + CPT - 1) / CPT;
  threads = ((threads + 31) / 32) * 32;
  ydrop_chunk_kernel<CPT><<<B, threads, p.W, stream>>>(p);
  return cudaGetLastError();
}

int64_t leading(const ffi::Buffer<ffi::S32>& x, int trailing) {
  auto d = x.dimensions();
  int64_t n = 1;
  for (size_t i = 0; i + trailing < d.size(); ++i) n *= d[i];
  return n;
}

ffi::Error YdropChunkImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> a,
                          ffi::Buffer<ffi::S32> b, ffi::Buffer<ffi::S32> cc,
                          ffi::Buffer<ffi::S32> dd,
                          ffi::Buffer<ffi::S32> scal,
                          ffi::Buffer<ffi::S32> sub,
                          ffi::ResultBuffer<ffi::S32> cc_out,
                          ffi::ResultBuffer<ffi::S32> dd_out,
                          ffi::ResultBuffer<ffi::S32> scal_out,
                          ffi::ResultBuffer<ffi::U8> tb, int32_t gap_e,
                          int32_t gap_oe, int32_t y_drop,
                          int32_t y_drop_tail, int32_t tb_cap,
                          int32_t trim) {
  auto ad = a.dimensions();
  auto bd = b.dimensions();
  auto sd = sub.dimensions();
  if (ad.size() < 1 || bd.size() < 1 || sd.size() < 2)
    return ffi::Error::InvalidArgument("ydrop_chunk: bad ranks");
  Params p;
  p.rows = (int)ad.back();
  p.W = (int)bd.back();
  p.K = (int)sd.back();
  const int64_t B = leading(a, 1);
  if (leading(b, 1) != B || leading(cc, 1) != B || leading(dd, 1) != B ||
      leading(scal, 1) != B)
    return ffi::Error::InvalidArgument("ydrop_chunk: batch mismatch");
  if (scal.dimensions().back() != NSIN)
    return ffi::Error::InvalidArgument("ydrop_chunk: scalar columns");
  if (p.K < 1 || p.K > MAX_ALPHA || sd[sd.size() - 2] != p.K)
    return ffi::Error::InvalidArgument("ydrop_chunk: alphabet size");
  if (p.W < 1 || p.W > 8 * MAX_THREADS || p.rows < 1)
    return ffi::Error::InvalidArgument("ydrop_chunk: window shape");
  p.a = a.typed_data();
  p.b = b.typed_data();
  p.cc_in = cc.typed_data();
  p.dd_in = dd.typed_data();
  p.scal_in = scal.typed_data();
  p.sub = sub.typed_data();
  p.cc_out = cc_out->typed_data();
  p.dd_out = dd_out->typed_data();
  p.scal_out = scal_out->typed_data();
  p.tb = tb->typed_data();
  p.gap_e = gap_e;
  p.gap_oe = gap_oe;
  p.y_drop = y_drop;
  p.y_drop_tail = y_drop_tail;
  p.tb_cap = tb_cap;
  p.trim = trim;
  if (B == 0) return ffi::Error::Success();
  const int cpt = (p.W + MAX_THREADS - 1) / MAX_THREADS;
  cudaError_t err;
  switch (cpt) {
    case 1: err = launch<1>(p, (int)B, stream); break;
    case 2: err = launch<2>(p, (int)B, stream); break;
    case 3: err = launch<3>(p, (int)B, stream); break;
    case 4: err = launch<4>(p, (int)B, stream); break;
    case 5: err = launch<5>(p, (int)B, stream); break;
    case 6: err = launch<6>(p, (int)B, stream); break;
    case 7: err = launch<7>(p, (int)B, stream); break;
    default: err = launch<8>(p, (int)B, stream); break;
  }
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    YdropChunk, YdropChunkImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()  // a
        .Arg<ffi::Buffer<ffi::S32>>()  // b
        .Arg<ffi::Buffer<ffi::S32>>()  // cc
        .Arg<ffi::Buffer<ffi::S32>>()  // dd
        .Arg<ffi::Buffer<ffi::S32>>()  // scal
        .Arg<ffi::Buffer<ffi::S32>>()  // sub
        .Ret<ffi::Buffer<ffi::S32>>()  // cc_out
        .Ret<ffi::Buffer<ffi::S32>>()  // dd_out
        .Ret<ffi::Buffer<ffi::S32>>()  // scal_out
        .Ret<ffi::Buffer<ffi::U8>>()   // tb
        .Attr<int32_t>("gap_e")
        .Attr<int32_t>("gap_oe")
        .Attr<int32_t>("y_drop")
        .Attr<int32_t>("y_drop_tail")
        .Attr<int32_t>("tb_cap")
        .Attr<int32_t>("trim"));
