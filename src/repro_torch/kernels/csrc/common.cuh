// Device code shared by the k-means kernels (sm_90a).
//
//  * the running top-2 (Top2, top2_push, top2_merge) and the outputs of
//    the top-2 epilogues (Top2Out, NestedArgs); the top-2s themselves are
//    the tensor-core kernel of tc_top2.cuh (and assign_top2.cu's bf16
//    kernel);
//  * the deterministic weighted per-cluster sum (launch_scatter<MODE>),
//    the sums of cluster_sum, fused_nested_round and fused_round. The rows
//    are split into chunks whose size is fixed by the row count (never by
//    the device), the clusters into tiles of SK. Three passes:
//    bucket_rows, one block per chunk, lists the chunk's rows that add
//    anything to each cluster tile, in increasing row order (a row that
//    adds to two tiles is in both; integer counts, a scan and a stable
//    placement, no sort); scatter_rows, one block per (feature tile,
//    chunk, cluster tile), adds the rows of its own list alone into shared
//    memory, each thread one feature column in list order; reduce_chunks
//    sums the chunk partials in chunk order, leaving out empty lists.
//    The order contract: each cluster's column takes its rows within a
//    chunk in row order, as `acc += w * x` in f32, and the chunks in chunk
//    order; v and sse likewise. So the bits depend on the chunk size
//    alone, not on the tiles or the lists. No float atomics: two runs
//    give the same bits. Bound: one read of x for the rows that add
//    something, plus writing and reading the partials (n_chunks *
//    (k*d + 2k) floats each way); the lists are 4 bytes a row.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace nkm {

// ---------------------------------------------------------------- top-2

struct Top2 {
  float m1;  // smallest squared distance
  int i1;    // its index (the lower index on a tie)
  float m2;  // smallest over every other index (a duplicate of m1 counts)
};

__device__ __forceinline__ Top2 top2_empty() { return {INFINITY, INT_MAX, INFINITY}; }

// Columns pushed in increasing index order: strict < keeps the lower index
// on a tie, and the tied value falls through to the 2nd-min.
__device__ __forceinline__ void top2_push(Top2& t, float v, int i) {
  if (v < t.m1) {
    t.m2 = t.m1;
    t.m1 = v;
    t.i1 = i;
  } else if (v < t.m2) {
    t.m2 = v;
  }
}

// Symmetric merge of two partial results over disjoint index sets.
__device__ __forceinline__ Top2 top2_merge(Top2 a, Top2 b) {
  const bool bw = (b.m1 < a.m1) || (b.m1 == a.m1 && b.i1 < a.i1);
  Top2 r;
  r.m1 = bw ? b.m1 : a.m1;
  r.i1 = bw ? b.i1 : a.i1;
  r.m2 = fminf(fmaxf(a.m1, b.m1), fminf(a.m2, b.m2));
  return r;
}

// ------------------------------------------------------------- outputs

struct Top2Out {
  int* a;
  float* d1;
  float* d2;
};

struct NestedArgs {
  const int* a_prev;
  const uint8_t* settled;
  const float* d_keep;
  const float* lb_keep;
  const uint8_t* valid;
  int* a_new;
  float* d_new;
  float* lb_new;
};

// ------------------------------------------------ deterministic scatter

constexpr int SD = 128;      // feature columns per sum block (one a thread)
constexpr int SK = 64;       // clusters per tile
constexpr int SU = 8;        // rows whose loads of x are in flight together
constexpr int BWARPS = 8;    // warps of a bucketing block
constexpr int BTILES = 1024; // cluster tiles a bucketing pass takes at once

enum ScatterMode { SCATTER_SUM = 0, SCATTER_NESTED = 1, SCATTER_ROUND = 2 };

// List entries a row may have: in SCATTER_NESTED one in a_new's tile and
// one in a leaver's a_prev tile, otherwise one.
template <int MODE>
__host__ __device__ constexpr int scatter_slots() {
  return MODE == SCATTER_NESTED ? 2 : 1;
}

struct ScatterArgs {
  const float* x;
  int n, k, d;
  // SCATTER_SUM: row r adds w[r] * x[r] to cluster a[r]
  const int* a;
  const float* w;
  // SCATTER_NESTED: +x at a_new for joins and new rows, -x at a_prev for
  // leaves, and d_new^2 to sse at a_new for every row
  const int* a_prev;
  const int* a_new;
  const float* d_new;
  // SCATTER_ROUND: row r adds x[r] and 1 to cluster a[r], and d1sq[r] (a
  // squared distance, added as it is) to sse
  const float* d1sq;
  float* partial;  // (n_chunks, stride): [S (k*d) | v (k) | sse (k)]
  // [counts | offsets], each (n_chunks, n_tiles), then the entries: chunk
  // c's from c * chunk_rows * scatter_slots<MODE>()
  int* lists;
  int chunk_rows;
  int stride;
  int n_tiles;
};

// What row r adds to the tile of clusters [k0, k0 + SK): wa to S and v at
// local cluster la and wb at lb, sq to sse at ls (-1: nothing here).
struct RowAdds {
  int la, lb, ls;
  float wa, wb, sq;
};

template <int MODE>
__device__ __forceinline__ RowAdds row_adds(const ScatterArgs& p, int r,
                                            int k0) {
  int la, lb = -1, ls = -1;
  float wa, wb = 0.f, sq = 0.f;
  if constexpr (MODE == SCATTER_SUM) {
    la = p.a[r] - k0;
    wa = p.w[r];
  } else if constexpr (MODE == SCATTER_ROUND) {
    la = p.a[r] - k0;
    wa = 1.f;
    ls = la;
    sq = p.d1sq[r];
  } else {
    const int ap = p.a_prev[r], an = p.a_new[r];
    const bool seen = ap >= 0;
    const bool changed = seen && an != ap;
    wa = ((changed || !seen) && an >= 0) ? 1.f : 0.f;
    wb = changed ? -1.f : 0.f;
    la = min(max(an, 0), p.k - 1) - k0;
    lb = min(max(ap, 0), p.k - 1) - k0;
    ls = la;
    const float dn = p.d_new[r];
    sq = dn * dn;
  }
  const int kt = min(SK, p.k - k0);
  RowAdds o;
  o.la = (wa != 0.f && la >= 0 && la < kt) ? la : -1;
  o.lb = (wb != 0.f && lb >= 0 && lb < kt) ? lb : -1;
  o.ls = (MODE != SCATTER_SUM && ls >= 0 && ls < kt) ? ls : -1;
  o.wa = wa;
  o.wb = wb;
  o.sq = sq;
  return o;
}

// The cluster tiles whose lists take row r (-1: none): every tile in which
// row_adds gives it something. Rows of weight 0 or with a label outside
// [0, k) take none in SCATTER_SUM.
template <int MODE>
__device__ __forceinline__ void row_tiles(const ScatterArgs& p, int r,
                                          int& ta, int& tb) {
  ta = tb = -1;
  if constexpr (MODE == SCATTER_SUM) {
    const int a = p.a[r];
    if (p.w[r] != 0.f && a >= 0 && a < p.k) ta = a / SK;
  } else if constexpr (MODE == SCATTER_ROUND) {
    const int a = p.a[r];
    if (a >= 0 && a < p.k) ta = a / SK;
  } else {
    const int ap = p.a_prev[r], an = p.a_new[r];
    ta = min(max(an, 0), p.k - 1) / SK;  // its sse, and +x if it joins
    if (ap >= 0 && an != ap) {           // -x: it leaves a_prev
      const int t = min(ap, p.k - 1) / SK;
      if (t != ta) tb = t;
    }
  }
}

// Calls f(T, m, hit) once for each distinct tile T that the warp's lanes
// hold in ta or tb (-1: none); m is the mask of the lanes holding T, hit
// says whether this lane does. Every lane of the warp must call it.
template <typename F>
__device__ __forceinline__ void for_each_tile(int ta, int tb, F f) {
  while (true) {
    const int mine = ta >= 0 ? ta : tb;
    const unsigned act = __ballot_sync(0xffffffffu, mine >= 0);
    if (act == 0) break;
    const int T = __shfl_sync(0xffffffffu, mine, __ffs(act) - 1);
    const bool hit = ta == T || tb == T;
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    f(T, m, hit);
    if (ta == T) {
      ta = -1;
    } else if (tb == T) {
      tb = -1;
    }
  }
}

// Pass 1, one block per row chunk: the chunk's list for each cluster tile,
// the rows that add anything to it, in increasing row order. Warp w takes
// the w-th run of the chunk's rows; the warps count their entries by tile,
// an exclusive scan in (tile, warp) order gives each warp its cursor in
// each list, and the warps place their rows, 32 at a time in lane order.
// Integer counts only; the same inputs give the same lists.
template <int MODE>
__global__ void __launch_bounds__(BWARPS * 32) bucket_rows(ScatterArgs p) {
  __shared__ int cur[BWARPS][BTILES];
  __shared__ int wtot[BWARPS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * p.chunk_rows;
  const int r1 = min(p.n, r0 + p.chunk_rows);
  const int run = (r1 - r0 + BWARPS * 32 - 1) / (BWARPS * 32) * 32;
  const int s0 = min(r1, r0 + warp * run), s1 = min(r1, s0 + run);
  const size_t n_pairs = (size_t)gridDim.x * p.n_tiles;
  int* counts = p.lists + (size_t)blockIdx.x * p.n_tiles;
  int* offsets = counts + n_pairs;
  int* entries =
      p.lists + 2 * n_pairs + (size_t)r0 * scatter_slots<MODE>();
  int placed = 0;  // the chunk's entries in earlier windows of tiles
  for (int t0 = 0; t0 < p.n_tiles; t0 += BTILES) {
    const int tw = min(BTILES, p.n_tiles - t0);
    for (int t = lane; t < tw; t += 32) cur[warp][t] = 0;
    __syncwarp();
    for (int base = s0; base < s1; base += 32) {
      const int r = base + lane;
      int ta = -1, tb = -1;
      if (r < s1) row_tiles<MODE>(p, r, ta, tb);
      ta = (ta >= t0 && ta < t0 + tw) ? ta - t0 : -1;
      tb = (tb >= t0 && tb < t0 + tw) ? tb - t0 : -1;
      for_each_tile(ta, tb, [&](int T, unsigned m, bool) {
        if (lane == __ffs(m) - 1) cur[warp][T] += __popc(m);
      });
    }
    __syncthreads();
    for (int g = 0; g < tw; g += BWARPS * 32) {
      const int t = g + threadIdx.x;
      int tot = 0;
      if (t < tw) {
#pragma unroll
        for (int w = 0; w < BWARPS; ++w) {
          const int c = cur[w][t];
          cur[w][t] = tot;
          tot += c;
        }
      }
      int inc = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += v;
      }
      if (lane == 31) wtot[warp] = inc;
      __syncthreads();
      int before = placed, all = 0;
#pragma unroll
      for (int w = 0; w < BWARPS; ++w) {
        if (w < warp) before += wtot[w];
        all += wtot[w];
      }
      if (t < tw) {
        const int off = before + inc - tot;
#pragma unroll
        for (int w = 0; w < BWARPS; ++w) cur[w][t] += off;
        counts[t0 + t] = tot;
        offsets[t0 + t] = off;
      }
      placed += all;
      __syncthreads();  // wtot is read before the next group writes it
    }
    for (int base = s0; base < s1; base += 32) {
      const int r = base + lane;
      int ta = -1, tb = -1;
      if (r < s1) row_tiles<MODE>(p, r, ta, tb);
      ta = (ta >= t0 && ta < t0 + tw) ? ta - t0 : -1;
      tb = (tb >= t0 && tb < t0 + tw) ? tb - t0 : -1;
      for_each_tile(ta, tb, [&](int T, unsigned m, bool hit) {
        const int leader = __ffs(m) - 1;
        int pos = 0;
        if (lane == leader) {
          pos = cur[warp][T];
          cur[warp][T] = pos + __popc(m);
        }
        pos = __shfl_sync(0xffffffffu, pos, leader);
        if (hit) entries[pos + __popc(m & ((1u << lane) - 1u))] = r;
      });
    }
    __syncthreads();  // cur is read before the next window clears it
  }
}

// Pass 2, one block per (feature tile, chunk, cluster tile), the feature
// tiles of one list side by side in launch order: the partial sums of the
// chunk's rows over that tile's list alone. The block stages SD entries
// at a time in shared memory, 16 bytes each (row, la, lb, wa), loading
// the next batch while it works on this one. Each thread owns a feature
// column and adds the list's rows into shared memory in list (= row)
// order, SU rows' loads of x in flight at once; a warp with no column
// (the ragged last feature tile) skips that loop. In the first feature
// tile, thread j also sums v and sse of the tile's cluster j, in
// registers, in the same order. An empty list costs one read of its
// count: the block writes nothing.
//
// What holds it back at k=50, d=784: the partials of all chunks (k * SD
// floats a block) exceed the card's shared memory, so the blocks run in
// about one and a half waves, and x is read in scattered 128-byte pieces.
// Neither more rows in flight nor 16-byte loads made it faster.
template <int MODE>
__global__ void __launch_bounds__(SD) scatter_rows(ScatterArgs p) {
  extern __shared__ float Sp[];  // [min(SK, k)][SD]
  __shared__ int4 ent[SD];       // row, la, lb, wa (bits)
  __shared__ float wbs[SD];
  __shared__ int2 sse[SD];       // ls, sq (bits)

  const int ch = blockIdx.y;
  const size_t n_pairs = (size_t)gridDim.y * p.n_tiles;
  const size_t pair = (size_t)ch * p.n_tiles + blockIdx.z;
  const int cnt = p.lists[pair];
  if (cnt == 0) return;
  const int* list = p.lists + 2 * n_pairs +
                    (size_t)ch * p.chunk_rows * scatter_slots<MODE>() +
                    p.lists[n_pairs + pair];

  const int tid = threadIdx.x;
  const int col = blockIdx.x * SD + tid;
  const int k0 = blockIdx.z * SK;
  const int kt = min(SK, p.k - k0);
  const bool owner = blockIdx.x == 0 && tid < kt;  // of cluster k0 + tid
  const bool has_col = col < p.d;
  const bool warp_cols = blockIdx.x * SD + (tid & ~31) < p.d;
  float vsum = 0.f, ssum = 0.f;

  // the next batch's entry of this thread, loaded a batch ahead
  RowAdds o{-1, -1, -1, 0.f, 0.f, 0.f};
  int r = 0;
  if (tid < cnt) {
    r = list[tid];
    o = row_adds<MODE>(p, r, k0);
  }
  for (int kk = 0; kk < kt; ++kk) Sp[kk * SD + tid] = 0.f;
  for (int base = 0; base < cnt; base += SD) {
    __syncthreads();  // zeroing done / previous batch consumed
    if (base + tid < cnt) {
      ent[tid] = make_int4(r, o.la, o.lb, __float_as_int(o.wa));
      wbs[tid] = o.wb;
      if (MODE != SCATTER_SUM)
        sse[tid] = make_int2(o.ls, __float_as_int(o.sq));
    }
    __syncthreads();
    if (base + SD + tid < cnt) {
      r = list[base + SD + tid];
      o = row_adds<MODE>(p, r, k0);
    }
    const int m = min(SD, cnt - base);
    if (warp_cols) {
      for (int j0 = 0; j0 < m; j0 += SU) {
        int4 e[SU];
        float xv[SU];
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          e[u] = j0 + u < m ? ent[j0 + u] : make_int4(0, -1, -1, 0);
          xv[u] = 0.f;
          if (has_col && (e[u].y >= 0 || e[u].z >= 0))
            xv[u] = __ldg(p.x + (size_t)e[u].x * p.d + col);
        }
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          if (e[u].y >= 0)
            Sp[e[u].y * SD + tid] += __int_as_float(e[u].w) * xv[u];
          if (e[u].z >= 0) Sp[e[u].z * SD + tid] += wbs[j0 + u] * xv[u];
        }
      }
    }
    if (owner) {
#pragma unroll 8
      for (int j = 0; j < m; ++j) {
        const int4 e = ent[j];
        if (e.y == tid) vsum += __int_as_float(e.w);
        if (e.z == tid) vsum += wbs[j];
        if (MODE != SCATTER_SUM) {
          const int2 q = sse[j];
          if (q.x == tid) ssum += __int_as_float(q.y);
        }
      }
    }
  }
  __syncthreads();

  float* slab = p.partial + (size_t)ch * p.stride;
  if (has_col) {
    for (int kk = 0; kk < kt; ++kk)
      slab[(size_t)(k0 + kk) * p.d + col] = Sp[kk * SD + tid];
  }
  if (owner) {
    const size_t kd = (size_t)p.k * p.d;
    slab[kd + k0 + tid] = vsum;
    if (MODE != SCATTER_SUM) slab[kd + p.k + k0 + tid] = ssum;
  }
}

// Pass 3: out[i] = the sum over chunks, in chunk order, of
// partial[chunk][i], leaving out each chunk whose list for i's cluster
// tile is empty (its block wrote nothing). Adding that chunk's zeros
// would change no bit: the sum starts at +0, so it is never -0.
__global__ void reduce_chunks(const float* __restrict__ partial,
                              const int* __restrict__ counts, int n_chunks,
                              int n_tiles, int stride, int k, int d,
                              float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)stride) return;
  const size_t kd = (size_t)k * d;
  const int j = i < kd ? (int)(i / d) : (int)((i - kd) % k);
  const int* c = counts + j / SK;
  float s = 0.f;
#pragma unroll 8
  for (int ch = 0; ch < n_chunks; ++ch)
    if (c[(size_t)ch * n_tiles] != 0) s += partial[(size_t)ch * stride + i];
  out[i] = s;
}

template <int MODE>
void launch_scatter(ScatterArgs p, float* out, cudaStream_t s) {
  if (p.n <= 0 || p.k <= 0) return;
  const int n_chunks = (p.n + p.chunk_rows - 1) / p.chunk_rows;
  p.n_tiles = (p.k + SK - 1) / SK;
  bucket_rows<MODE><<<n_chunks, BWARPS * 32, 0, s>>>(p);
  const dim3 grid((max(p.d, 1) + SD - 1) / SD, n_chunks, p.n_tiles);
  scatter_rows<MODE><<<grid, SD, min(SK, p.k) * SD * sizeof(float), s>>>(p);
  reduce_chunks<<<(p.stride + 255) / 256, 256, 0, s>>>(
      p.partial, p.lists, n_chunks, p.n_tiles, p.stride, p.k, p.d, out);
}

}  // namespace nkm

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
