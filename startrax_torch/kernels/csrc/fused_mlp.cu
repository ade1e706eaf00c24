// Fused radiance-field MLP for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (startrax/kernels/fused_mlp.py:291)
// and `_bwd_kernel` (startrax/kernels/fused_mlp.py:343).
//
// What it computes, per point: optional SE(3) warp M p + t, M d (packed [16]);
// NeRF positional encoding of points (multires 10 -> 63 columns) and view
// directions (multires_views 4 -> 27 columns), both zero-padded to EW = 64
// columns; optional BARF per-column mask; trunk lin_in -> n_blocks x (relu ->
// fc0 -> relu -> fc1, residual add) -> relu -> lin_out; heads alpha (W -> 1),
// feature (W -> W), views feat @ Wv_top + d_emb @ Wv_bot -> relu (W/2), rgb
// (W/2 -> 3). Output [N, 4] f32 = (raw alpha, raw rgb).
//
// Rounding follows the TPU kernel: matmul operands bf16, f32 accumulation,
// biases added in f32, the residual stream h kept in f32 shared memory, saved
// activations bf16 (the backward's relu masks read those bf16 values), and the
// backward's pre-activation grads rounded to bf16 where they feed a matmul.
// One deliberate difference: the pose sums G = DX^T X + DD^T D, s = sum DX are
// accumulated in f32 (the TPU kernel rounds DX and X to bf16 there).
//
// What bounds it on the card: the fields do ~1.23e12 multiply-adds per
// training step forward (about 3x that with the backward) against ~6 KB of
// saved bf16 activations a point, so the arithmetic intensity is far above the
// card's balance point and bytes are not the bound. The measured rate is
// about 5% of the bf16 tensor-core peak; the working hypothesis, not yet
// backed by a trace, is latency at the weight-chunk barriers with one CTA of
// 8 warps per SM. This first version uses warp-level bf16 mma (WMMA 16x16x16)
// from shared memory, a tile of T = 64 points per CTA, and one CTA per SM
// (~210 KB of shared memory); weight chunks are double-buffered with
// cp.async so that a chunk's copy overlaps the previous chunk's matmuls. It
// is not tuned further (no wgmma, no TMA).
//
// Design against what differs from the TPU:
// - Weights do not fit in shared memory (1.5 MB bf16 for 8x256). The point
//   tile's activations stay in shared memory (h in f32, one bf16 operand
//   copy) and each layer streams its weights through shared memory in
//   KC-row chunks from global memory, where they stay L2-resident.
// - The TPU backward carried dW += ... across its sequential grid. CTAs here
//   run in no order, so the backward is three launches, all deterministic:
//   (A) bwd_kernel walks the chain backward per point tile and writes every
//       layer's bf16 pre-activation grad dY plus per-CTA f32 partials of the
//       bias grads, the two narrow heads' weight grads and the 12 pose sums;
//   (B) wgrad_kernel computes dW = X^T dY for every wide layer as a split-N
//       GEMM, one f32 partial per split;
//   (C) sum_rows_kernel sums partials in a fixed order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int T = 64;      // points per CTA
constexpr int NT = 256;    // threads per CTA (8 warps: 4 row strips x 2 column groups)
constexpr int KC = 32;     // weight rows streamed through shared memory per chunk
constexpr int EW = 64;     // padded encoding width (63 point columns, 27 direction columns)
constexpr int LDE = EW + 8;
constexpr int MAXB = 8;    // most residual blocks a field may have

struct Inputs {
  const float* x;       // [n, 3] world points
  const float* d;       // [n, 3] view directions
  const float* warp;    // [16] M row-major, t; or null
  const float* mask_x;  // [EW] BARF column mask; or null
  const float* mask_d;  // [EW]; or null
  int n, width, n_blocks, fx, fd;
};

// Matmul weights, bf16 row-major [in, out]. The backward receives the
// transposes [out, in] of every matrix it multiplies by, and w_a, w_r as is.
struct Net {
  const bf16* w_in; const float* b_in;
  const bf16* w0[MAXB]; const float* b0[MAXB];
  const bf16* w1[MAXB]; const float* b1[MAXB];
  const bf16* w_out; const float* b_out;
  const bf16* w_a; const float* b_a;
  const bf16* w_f; const float* b_f;
  const bf16* wv_top; const bf16* wv_bot; const float* b_v;
  const bf16* w_r; const float* b_r;
};

// Saved activations, bf16 [n, W] (hv_in [n, W/2]).
struct Acts {
  bf16* h[MAXB]; bf16* nn[MAXB]; bf16* h_last; bf16* ho; bf16* feat; bf16* hv_in;
};

// Backward outputs: bf16 pre-activation grads (the dY of each wide layer), the
// encodings (the X of lin_in and Wv_bot), and per-CTA f32 partials.
struct Grads {
  bf16* d_in; bf16* d0[MAXB]; bf16* d1[MAXB]; bf16* d_out; bf16* d_f; bf16* d_v;
  bf16* xe; bf16* de; float* part;
};

// Layout of one CTA's partial vector. The Python wrapper reads it through
// stx_partial_offset, by field name.
struct POff { int b_in, b_blocks, b_out, b_f, b_v, b_a, b_r, w_a, w_r, pose, total; };

__host__ __device__ inline POff partial_offsets(int W, int nb) {
  POff o; int k = 0;
  o.b_in = k; k += W;
  o.b_blocks = k; k += 2 * W * nb;   // block i: db0 at +2Wi, db1 at +2Wi+W
  o.b_out = k; k += W;
  o.b_f = k; k += W;
  o.b_v = k; k += W / 2;
  o.b_a = k; k += 1;
  o.b_r = k; k += 3;
  o.w_a = k; k += W;
  o.w_r = k; k += (W / 2) * 3;
  o.pose = k; k += 12;               // G row-major [0:9], s [9:12]
  o.total = k;
  return o;
}

struct Cursor {
  void** p; int i;
  template <class X> X* next() { return reinterpret_cast<X*>(p[i++]); }
};

void parse_inputs(Cursor& c, const int* ints, Inputs& in) {
  in.x = c.next<const float>(); in.d = c.next<const float>();
  in.warp = c.next<const float>();
  in.mask_x = c.next<const float>(); in.mask_d = c.next<const float>();
  in.n = ints[0]; in.width = ints[1]; in.n_blocks = ints[2]; in.fx = ints[3]; in.fd = ints[4];
}

void parse_net(Cursor& c, int nb, Net& w) {
  w.w_in = c.next<const bf16>(); w.b_in = c.next<const float>();
  for (int i = 0; i < nb; ++i) {
    w.w0[i] = c.next<const bf16>(); w.b0[i] = c.next<const float>();
    w.w1[i] = c.next<const bf16>(); w.b1[i] = c.next<const float>();
  }
  w.w_out = c.next<const bf16>(); w.b_out = c.next<const float>();
  w.w_a = c.next<const bf16>(); w.b_a = c.next<const float>();
  w.w_f = c.next<const bf16>(); w.b_f = c.next<const float>();
  w.wv_top = c.next<const bf16>(); w.wv_bot = c.next<const bf16>(); w.b_v = c.next<const float>();
  w.w_r = c.next<const bf16>(); w.b_r = c.next<const float>();
}

void parse_acts(Cursor& c, int nb, Acts& a) {
  for (int i = 0; i < nb; ++i) { a.h[i] = c.next<bf16>(); a.nn[i] = c.next<bf16>(); }
  a.h_last = c.next<bf16>(); a.ho = c.next<bf16>(); a.feat = c.next<bf16>(); a.hv_in = c.next<bf16>();
}

__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// Saved activation at (p, c), 0 outside the batch.
__device__ __forceinline__ float ld_act(const bf16* a, long p, int c, int ld, bool ok) {
  return ok ? __bfloat162float(a[p * ld + c]) : 0.f;
}

// y = M v (+ t), in the reference's operation order and without FMA
// contraction, so that the plain PyTorch version gives the same bits.
__device__ __forceinline__ void warp3(const float* w, const float* v, bool with_t, float* y) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float s = __fadd_rn(__fadd_rn(__fmul_rn(w[3 * r], v[0]), __fmul_rn(w[3 * r + 1], v[1])),
                        __fmul_rn(w[3 * r + 2], v[2]));
    y[r] = with_t ? __fadd_rn(s, w[9 + r]) : s;
  }
}

// Column j of the encoding: v[j] for j < 3, else sin/cos(v[dim] 2^freq) with
// j = 3 + 6 freq + 3 phase + dim (the ops.encoding layout); 0 past 3 + 6F.
__device__ __forceinline__ float pe_val(const float* v, int j, int F) {
  if (j < 3) return v[j];
  const int jj = j - 3;
  if (jj >= 6 * F) return 0.f;
  const int freq = jj / 6, rem = jj - 6 * freq;
  const float val = ldexpf(v[rem % 3], freq);
  return rem < 3 ? sinf(val) : cosf(val);
}

// d enc[j] / d v[dim]; dim is returned through *dim.
__device__ __forceinline__ float pe_dval(const float* v, int j, int F, int* dim) {
  if (j < 3) { *dim = j; return 1.f; }
  const int jj = j - 3;
  if (jj >= 6 * F) { *dim = 0; return 0.f; }
  const int freq = jj / 6, rem = jj - 6 * freq;
  *dim = rem % 3;
  const float s = ldexpf(1.f, freq);
  const float val = v[*dim] * s;
  return rem < 3 ? cosf(val) * s : -sinf(val) * s;
}

struct Seg { const bf16* a; int lda; const bf16* b; int k; };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Starts copying rows [k0, k0 + KC) of B [k][nout] into buf (row stride nout + 8).
__device__ __forceinline__ void load_chunk(const bf16* b, int k0, int nout, bf16* buf) {
  const int vec_per_row = nout >> 3, ldb = nout + 8;
  for (int i = threadIdx.x; i < KC * vec_per_row; i += NT) {
    const int r = i / vec_per_row, cc = (i - r * vec_per_row) << 3;
    cp_async16(buf + r * ldb + cc, b + (size_t)(k0 + r) * nout + cc);
  }
  cp_commit();
}

// C[T][nout] (f32, shared) = sum over segments of A[T][k] (bf16, shared) @
// B[k][nout] (bf16, global, row-major). B streams through two KC-row
// buffers in `bs` (2 * KC * (nout + 8) elements): the copy of the next chunk
// (cp.async) overlaps the matmuls on the current one. Warp w owns row strip
// w % 4 and the column tiles w / 4 + 2j. Requires nout % 32 == 0,
// nout <= 256, k % KC == 0. Ends synchronised.
__device__ void tile_gemm(const Seg* segs, int nseg, int nout, bf16* bs, float* c, int ldc) {
  const int warp = threadIdx.x >> 5;
  const int rt = warp & 3, cg = warp >> 2;
  const int nct = nout >> 5;
  const int ldb = nout + 8;
  bf16* bufs[2] = {bs, bs + KC * ldb};
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);
  int total = 0;
  for (int s = 0; s < nseg; ++s) total += segs[s].k / KC;
  load_chunk(segs[0].b, 0, nout, bufs[0]);
  int s = 0, k0 = 0;   // segment and row of the chunk being multiplied
  for (int ci = 0; ci < total; ++ci) {
    const Seg sg = segs[s];
    if (ci + 1 < total) {  // start the next chunk, then wait for this one
      const bool next_seg = k0 + KC >= sg.k;
      load_chunk(next_seg ? segs[s + 1].b : sg.b, next_seg ? 0 : k0 + KC, nout, bufs[(ci + 1) & 1]);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* buf = bufs[ci & 1];
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sg.a + rt * 16 * sg.lda + k0 + kk, sg.lda);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nct) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, buf + kk * ldb + (cg + 2 * j) * 16, ldb);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two chunks from now
    k0 += KC;
    if (k0 >= sg.k) { ++s; k0 = 0; }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < nct)
      wmma::store_matrix_sync(c + rt * 16 * ldc + (cg + 2 * j) * 16, acc[j], ldc, wmma::mem_row_major);
  __syncthreads();
}

__device__ __forceinline__ void gemm1(const bf16* a, int lda, const bf16* b, int k, int nout,
                                      bf16* bs, float* c, int ldc) {
  Seg s = {a, lda, b, k};
  tile_gemm(&s, 1, nout, bs, c, ldc);
}

// Sum of rows [0, T) of column c of buf, for c < ncols, into out[c].
__device__ __forceinline__ void colsum(const float* buf, int ld, int ncols, float* out) {
  for (int c = threadIdx.x; c < ncols; c += NT) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += buf[t * ld + c];
    out[c] = s;
  }
}

// Encoding backward for one tile: dv[dim] = sum_j g[j] mask[j] d enc[j]/d v[dim],
// four threads per point (tid = 4 t + q), reduced with warp shuffles. Returns
// the three grads in every lane of the point's quad.
__device__ __forceinline__ void pe_bwd(const float* g, int ld, const float* v, const float* mask,
                                       int F, float* out3) {
  const int t = threadIdx.x >> 2, q = threadIdx.x & 3;
  float a[3] = {0.f, 0.f, 0.f};
  for (int j = q; j < EW; j += 4) {
    int dim;
    const float dv = pe_dval(v + t * 6, j, F, &dim);
    float gj = g[t * ld + j];
    if (mask) gj *= mask[j];
    a[dim] += gj * dv;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a[i] += __shfl_xor_sync(0xffffffffu, a[i], 1);
    a[i] += __shfl_xor_sync(0xffffffffu, a[i], 2);
    out3[i] = a[i];
  }
}

size_t fwd_smem(int W) {
  return sizeof(float) * 2 * T * (W + 4) + sizeof(bf16) * (T * (W + 8) + T * LDE + 2 * KC * (W + 8)) +
         sizeof(float) * (T * 6 + T);
}

size_t bwd_smem(int W) {
  return sizeof(float) * 2 * T * (W + 4) + sizeof(bf16) * (T * (W + 8) + 2 * KC * (W + 8)) +
         sizeof(float) * (T * 6 * 2 + T * 4 + T * 3 + T * 12);
}

// Loads a point tile's raw and warped inputs: raw[t*6 + 0..5] = (x, d),
// wp[t*6 + 0..5] = (M x + t, M d); zeros past the batch.
__device__ __forceinline__ void load_points(const Inputs& in, long row0, float* raw, float* wp) {
  const int t = threadIdx.x;
  if (t >= T) return;
  const long p = row0 + t;
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (p < in.n) {
#pragma unroll
    for (int i = 0; i < 3; ++i) { v[i] = in.x[p * 3 + i]; v[3 + i] = in.d[p * 3 + i]; }
  }
  if (raw) for (int i = 0; i < 6; ++i) raw[t * 6 + i] = v[i];
  if (in.warp) {
    warp3(in.warp, v, true, wp + t * 6);
    warp3(in.warp, v + 3, false, wp + t * 6 + 3);
  } else {
    for (int i = 0; i < 6; ++i) wp[t * 6 + i] = v[i];
  }
}

// Eight saved bf16 activations at (row0 + t, c .. c + 7) as floats; zeros
// past the batch. c is a multiple of 8.
__device__ __forceinline__ void ld_act8(const bf16* a, long row0, int t, int c, int ld, int nrow,
                                        float* v) {
  uint4 u = make_uint4(0, 0, 0, 0);
  if (t < nrow) u = __ldg(reinterpret_cast<const uint4*>(a + (row0 + t) * ld + c));
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = __bfloat162float(e[q]);
}

// Rounds eight floats to bf16 and stores them to shared memory and, unless
// gdst is null, to global memory (16-byte stores).
__device__ __forceinline__ void st_bf8(const float* v, bf16* sdst, bf16* gdst) {
  uint4 u;
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int q = 0; q < 8; ++q) e[q] = __float2bfloat16(v[q]);
  *reinterpret_cast<uint4*>(sdst) = u;
  if (gdst) *reinterpret_cast<uint4*>(gdst) = u;
}

__device__ __forceinline__ void ld_f8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void st_f8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// Rounds eight floats to bf16 and stores them to global memory (16 bytes).
__device__ __forceinline__ void st_bf8g(const float* v, bf16* gdst) {
  uint4 u;
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int q = 0; q < 8; ++q) e[q] = __float2bfloat16(v[q]);
  *reinterpret_cast<uint4*>(gdst) = u;
}

__device__ __forceinline__ void relu8(const float* v, float* r) {
#pragma unroll
  for (int q = 0; q < 8; ++q) r[q] = fmaxf(v[q], 0.f);
}

__device__ __forceinline__ void add_bias8(float* v, const float* b) {
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] += b[q];
}

__global__ void __launch_bounds__(NT, 1) fwd_kernel(Inputs in, Net w, Acts act, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = in.width, W2 = W / 2, LDF = W + 4, LDA = W + 8;
  float* hs = reinterpret_cast<float*>(smem);            // [T][LDF] residual stream h (f32)
  float* cs = hs + T * LDF;                              // [T][LDF] matmul result
  bf16* as = reinterpret_cast<bf16*>(cs + T * LDF);      // [T][LDA] bf16 operand
  bf16* es = as + T * LDA;                               // [T][LDE] direction encoding
  bf16* bs = es + T * LDE;                               // [2][KC][LDA] weight chunks
  float* ps = reinterpret_cast<float*>(bs + 2 * KC * LDA);  // [T][6] warped x, d
  float* al = ps + T * 6;                                // [T] alpha
  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * T;
  const int nrow = (int)min((long)T, (long)in.n - row0);

  load_points(in, row0, nullptr, ps);
  __syncthreads();
  for (int i = tid; i < T * EW; i += NT) {
    const int t = i / EW, j = i - t * EW;
    float vx = pe_val(ps + t * 6, j, in.fx), vd = pe_val(ps + t * 6 + 3, j, in.fd);
    if (in.mask_x) vx *= in.mask_x[j];
    if (in.mask_d) vd *= in.mask_d[j];
    as[t * LDA + j] = __float2bfloat16(vx);
    es[t * LDE + j] = __float2bfloat16(vd);
  }

  // The elementwise passes give each thread the same eight-column groups of
  // the tile (16-byte stores of the saved bf16 activations), so a pass may
  // read what the previous W-wide pass wrote without a barrier.
  const int V = W / 8, V2 = W2 / 8;
  gemm1(as, LDA, w.w_in, EW, W, bs, hs, LDF);
  for (int b = 0; b < in.n_blocks; ++b) {
    for (int i = tid; i < T * V; i += NT) {
      const int t = i / V, c = (i - t * V) * 8;
      float h[8], r[8];
      ld_f8(hs + t * LDF + c, h);
      if (b == 0) {
        add_bias8(h, w.b_in + c);
        st_f8(hs + t * LDF + c, h);
      }
      if (t < nrow) st_bf8g(h, act.h[b] + (row0 + t) * W + c);
      relu8(h, r);
      st_bf8(r, as + t * LDA + c, nullptr);
    }
    gemm1(as, LDA, w.w0[b], W, W, bs, cs, LDF);
    for (int i = tid; i < T * V; i += NT) {
      const int t = i / V, c = (i - t * V) * 8;
      float v[8], r[8];
      ld_f8(cs + t * LDF + c, v);
      add_bias8(v, w.b0[b] + c);
      if (t < nrow) st_bf8g(v, act.nn[b] + (row0 + t) * W + c);
      relu8(v, r);
      st_bf8(r, as + t * LDA + c, nullptr);
    }
    gemm1(as, LDA, w.w1[b], W, W, bs, cs, LDF);
    for (int i = tid; i < T * V; i += NT) {  // h = h + (fc1 + b1)
      const int t = i / V, c = (i - t * V) * 8;
      float v[8], h[8];
      ld_f8(cs + t * LDF + c, v);
      add_bias8(v, w.b1[b] + c);
      ld_f8(hs + t * LDF + c, h);
      add_bias8(h, v);
      st_f8(hs + t * LDF + c, h);
    }
  }
  for (int i = tid; i < T * V; i += NT) {
    const int t = i / V, c = (i - t * V) * 8;
    float h[8], r[8];
    ld_f8(hs + t * LDF + c, h);
    if (in.n_blocks == 0) add_bias8(h, w.b_in + c);
    if (t < nrow) st_bf8g(h, act.h_last + (row0 + t) * W + c);
    relu8(h, r);
    st_bf8(r, as + t * LDA + c, nullptr);
  }
  gemm1(as, LDA, w.w_out, W, W, bs, cs, LDF);
  for (int i = tid; i < T * V; i += NT) {
    const int t = i / V, c = (i - t * V) * 8;
    float v[8];
    ld_f8(cs + t * LDF + c, v);
    add_bias8(v, w.b_out + c);
    st_bf8(v, as + t * LDA + c, t < nrow ? act.ho + (row0 + t) * W + c : nullptr);
  }
  __syncthreads();
  {  // alpha head (W -> 1): one warp per 8 points, lanes across columns
    const int warp = tid >> 5, lane = tid & 31;
    for (int t = warp * 8; t < warp * 8 + 8; ++t) {
      float s = 0.f;
      for (int c = lane; c < W; c += 32) s += bf(as[t * LDA + c]) * bf(w.w_a[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) al[t] = s + w.b_a[0];
    }
  }
  gemm1(as, LDA, w.w_f, W, W, bs, cs, LDF);
  for (int i = tid; i < T * V; i += NT) {
    const int t = i / V, c = (i - t * V) * 8;
    float v[8];
    ld_f8(cs + t * LDF + c, v);
    add_bias8(v, w.b_f + c);
    st_bf8(v, as + t * LDA + c, t < nrow ? act.feat + (row0 + t) * W + c : nullptr);
  }
  {
    Seg s[2] = {{as, LDA, w.wv_top, W}, {es, LDE, w.wv_bot, EW}};
    tile_gemm(s, 2, W2, bs, cs, LDF);
  }
  for (int i = tid; i < T * V2; i += NT) {
    const int t = i / V2, c = (i - t * V2) * 8;
    float v[8], r[8];
    ld_f8(cs + t * LDF + c, v);
    add_bias8(v, w.b_v + c);
    if (t < nrow) st_bf8g(v, act.hv_in + (row0 + t) * W2 + c);
    relu8(v, r);
    st_bf8(r, as + t * LDA + c, nullptr);
  }
  __syncthreads();
  for (int i = tid; i < T * 3; i += NT) {  // rgb head (W/2 -> 3)
    const int t = i / 3, j = i - t * 3;
    float s = 0.f;
    for (int c = 0; c < W2; ++c) s += bf(as[t * LDA + c]) * bf(w.w_r[c * 3 + j]);
    if (t < nrow) {
      out[(row0 + t) * 4 + 1 + j] = s + w.b_r[j];
      if (j == 0) out[(row0 + t) * 4] = al[t];
    }
  }
}

__global__ void __launch_bounds__(NT, 1) bwd_kernel(Inputs in, Net w, Acts act, const float* g, Grads gr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = in.width, W2 = W / 2, LDF = W + 4, LDA = W + 8, nb = in.n_blocks;
  float* dhs = reinterpret_cast<float*>(smem);           // [T][LDF] residual grad dh (f32)
  float* cs = dhs + T * LDF;                             // [T][LDF] matmul result
  bf16* as = reinterpret_cast<bf16*>(cs + T * LDF);      // [T][LDA] bf16 operand
  bf16* bs = as + T * LDA;                               // [2][KC][LDA] weight chunks
  float* raw = reinterpret_cast<float*>(bs + 2 * KC * LDA);  // [T][6] world x, d
  float* ps = raw + T * 6;                               // [T][6] warped x, d
  float* gs = ps + T * 6;                                // [T][4] cotangent
  float* pd = gs + T * 4;                                // [T][3] world-frame d grads
  float* pose = pd + T * 3;                              // [T][12] per-point pose terms
  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * T;
  const int nrow = (int)min((long)T, (long)in.n - row0);
  const bool warped = in.warp != nullptr;
  const POff o = partial_offsets(W, nb);
  float* part = gr.part + (size_t)blockIdx.x * o.total;

  load_points(in, row0, raw, ps);
  if (tid < T)
    for (int j = 0; j < 4; ++j) gs[tid * 4 + j] = tid < nrow ? g[(row0 + tid) * 4 + j] : 0.f;
  __syncthreads();
  for (int i = tid; i < T * EW; i += NT) {  // encodings: the X of lin_in and Wv_bot
    const int t = i / EW, j = i - t * EW;
    if (t >= nrow) continue;
    float vx = pe_val(ps + t * 6, j, in.fx), vd = pe_val(ps + t * 6 + 3, j, in.fd);
    if (in.mask_x) vx *= in.mask_x[j];
    if (in.mask_d) vd *= in.mask_d[j];
    gr.xe[(row0 + t) * EW + j] = __float2bfloat16(vx);
    gr.de[(row0 + t) * EW + j] = __float2bfloat16(vd);
  }

  // The elementwise passes below give each thread the same eight-column
  // groups of the tile (16-byte loads of saved bf16 activations), so a pass
  // may read what the previous W-wide pass wrote without a barrier.
  const int V = W / 8, V2 = W2 / 8;

  // rgb head: dhv = drgb @ W_r^T, dhv_in = dhv * (hv_in > 0)
  for (int i = tid; i < T * V2; i += NT) {
    const int t = i / V2, c = (i - t * V2) * 8;
    float hv[8], v[8];
    ld_act8(act.hv_in, row0, t, c, W2, nrow, hv);
    const float g1 = bfr(gs[t * 4 + 1]), g2 = bfr(gs[t * 4 + 2]), g3 = bfr(gs[t * 4 + 3]);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const bf16* wr = w.w_r + (c + q) * 3;
      const float dhv = g1 * bf(wr[0]) + g2 * bf(wr[1]) + g3 * bf(wr[2]);
      v[q] = hv[q] > 0.f ? dhv : 0.f;
    }
    st_f8(cs + t * LDF + c, v);
    st_bf8(v, as + t * LDA + c, t < nrow ? gr.d_v + (row0 + t) * W2 + c : nullptr);
  }
  __syncthreads();
  colsum(cs, LDF, W2, part + o.b_v);
  for (int c = tid; c < W2; c += NT) {  // dW_r = relu(hv_in)^T drgb
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll 8
    for (int t = 0; t < T; ++t) {
      const float hv = fmaxf(ld_act(act.hv_in, row0 + t, c, W2, t < nrow), 0.f);
      a0 += hv * bfr(gs[t * 4 + 1]);
      a1 += hv * bfr(gs[t * 4 + 2]);
      a2 += hv * bfr(gs[t * 4 + 3]);
    }
    part[o.w_r + c * 3] = a0; part[o.w_r + c * 3 + 1] = a1; part[o.w_r + c * 3 + 2] = a2;
  }
  if (tid < 4) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += gs[t * 4 + tid];
    part[tid == 0 ? o.b_a : o.b_r + tid - 1] = s;
  }

  if (warped) {  // dd_emb = dhv_in @ Wv_bot^T, then the encoding backward, unwarped by M^T
    gemm1(as, LDA, w.wv_bot, W2, EW, bs, dhs, LDF);
    float dw[3];
    pe_bwd(dhs, LDF, ps + 3, in.mask_d, in.fd, dw);
    if ((tid & 3) == 0) {
      const int t = tid >> 2;
      for (int c = 0; c < 3; ++c)
        pd[t * 3 + c] = in.warp[c] * dw[0] + in.warp[3 + c] * dw[1] + in.warp[6 + c] * dw[2];
    }
  }

  // dfeat = dhv_in @ Wv_top^T
  gemm1(as, LDA, w.wv_top, W2, W, bs, cs, LDF);
  for (int i = tid; i < T * V; i += NT) {
    const int t = i / V, c = (i - t * V) * 8;
    float v[8];
    ld_f8(cs + t * LDF + c, v);
    st_bf8(v, as + t * LDA + c, t < nrow ? gr.d_f + (row0 + t) * W + c : nullptr);
  }
  __syncthreads();
  colsum(cs, LDF, W, part + o.b_f);

  // dho = dfeat @ W_f^T + dalpha W_a^T
  gemm1(as, LDA, w.w_f, W, W, bs, cs, LDF);
  for (int i = tid; i < T * V; i += NT) {
    const int t = i / V, c = (i - t * V) * 8;
    float v[8];
    ld_f8(cs + t * LDF + c, v);
    const float da = bfr(gs[t * 4]);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] += da * bf(w.w_a[c + q]);
    st_f8(cs + t * LDF + c, v);
    st_bf8(v, as + t * LDA + c, t < nrow ? gr.d_out + (row0 + t) * W + c : nullptr);
  }
  __syncthreads();
  colsum(cs, LDF, W, part + o.b_out);
  __syncthreads();
  for (int i = tid; i < T * V; i += NT) {  // dW_a = ho^T dalpha, as a column sum of ho * dalpha
    const int t = i / V, c = (i - t * V) * 8;
    float v[8];
    ld_act8(act.ho, row0, t, c, W, nrow, v);
    const float da = bfr(gs[t * 4]);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] *= da;
    st_f8(cs + t * LDF + c, v);
  }
  __syncthreads();
  colsum(cs, LDF, W, part + o.w_a);

  // dr = dho @ W_out^T, dh = dr * (h_last > 0)
  gemm1(as, LDA, w.w_out, W, W, bs, cs, LDF);
  for (int i = tid; i < T * V; i += NT) {
    const int t = i / V, c = (i - t * V) * 8;
    float a[8], v[8];
    ld_act8(act.h_last, row0, t, c, W, nrow, a);
    ld_f8(cs + t * LDF + c, v);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = a[q] > 0.f ? v[q] : 0.f;
    st_f8(dhs + t * LDF + c, v);
  }
  for (int b = nb - 1; b >= 0; --b) {
    for (int i = tid; i < T * V; i += NT) {  // h_out = h_in + fc1(relu(n)): dY of fc1 is dh
      const int t = i / V, c = (i - t * V) * 8;
      float v[8];
      ld_f8(dhs + t * LDF + c, v);
      st_bf8(v, as + t * LDA + c, t < nrow ? gr.d1[b] + (row0 + t) * W + c : nullptr);
    }
    __syncthreads();
    colsum(dhs, LDF, W, part + o.b_blocks + 2 * W * b + W);
    gemm1(as, LDA, w.w1[b], W, W, bs, cs, LDF);
    for (int i = tid; i < T * V; i += NT) {  // dn = da1 * (n > 0)
      const int t = i / V, c = (i - t * V) * 8;
      float a[8], v[8];
      ld_act8(act.nn[b], row0, t, c, W, nrow, a);
      ld_f8(cs + t * LDF + c, v);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = a[q] > 0.f ? v[q] : 0.f;
      st_f8(cs + t * LDF + c, v);
      st_bf8(v, as + t * LDA + c, t < nrow ? gr.d0[b] + (row0 + t) * W + c : nullptr);
    }
    __syncthreads();
    colsum(cs, LDF, W, part + o.b_blocks + 2 * W * b);
    gemm1(as, LDA, w.w0[b], W, W, bs, cs, LDF);
    for (int i = tid; i < T * V; i += NT) {  // dh += da0 * (h_in > 0)
      const int t = i / V, c = (i - t * V) * 8;
      float a[8], v[8], dh[8];
      ld_act8(act.h[b], row0, t, c, W, nrow, a);
      ld_f8(cs + t * LDF + c, v);
      ld_f8(dhs + t * LDF + c, dh);
#pragma unroll
      for (int q = 0; q < 8; ++q) dh[q] += a[q] > 0.f ? v[q] : 0.f;
      st_f8(dhs + t * LDF + c, dh);
    }
  }
  for (int i = tid; i < T * V; i += NT) {
    const int t = i / V, c = (i - t * V) * 8;
    float v[8];
    ld_f8(dhs + t * LDF + c, v);
    st_bf8(v, as + t * LDA + c, t < nrow ? gr.d_in + (row0 + t) * W + c : nullptr);
  }
  __syncthreads();
  colsum(dhs, LDF, W, part + o.b_in);

  if (warped) {  // dx_emb = dh @ W_in^T -> encoding backward -> unwarp -> pose sums
    gemm1(as, LDA, w.w_in, W, EW, bs, cs, LDF);
    float dw[3];
    pe_bwd(cs, LDF, ps, in.mask_x, in.fx, dw);
    if ((tid & 3) == 0) {
      const int t = tid >> 2;
      float dx[3];
      for (int c = 0; c < 3; ++c)
        dx[c] = in.warp[c] * dw[0] + in.warp[3 + c] * dw[1] + in.warp[6 + c] * dw[2];
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j)
          pose[t * 12 + 3 * i + j] = dx[i] * raw[t * 6 + j] + pd[t * 3 + i] * raw[t * 6 + 3 + j];
        pose[t * 12 + 9 + i] = dx[i];
      }
    }
    __syncthreads();
  }
  if (tid < 12) {
    float s = 0.f;
    if (warped)
      for (int t = 0; t < T; ++t) s += pose[t * 12 + tid];
    part[o.pose + tid] = s;
  }
}

// part[split][tm*64 + i][tn*64 + j] = sum over this split's points p of
// X[p][tm*64 + i] * dY[p][tn*64 + j] (X through relu when relu_x).
__global__ void __launch_bounds__(NT) wgrad_kernel(const bf16* X, int k_in, int relu_x, const bf16* dY,
                                                   int n_out, long n, long per_split, float* part,
                                                   long part_stride) {
  __shared__ __align__(128) bf16 xs[32 * 72];
  __shared__ __align__(128) bf16 ys[32 * 72];
  const int tiles_n = n_out / 64;
  const int tm = blockIdx.x / tiles_n, tn = blockIdx.x - tm * tiles_n;
  const long p_begin = (long)blockIdx.y * per_split;
  const long p_end = min(n, p_begin + per_split);
  const int warp = threadIdx.x >> 5, rt = warp & 3, cg = warp >> 2;
  const int lr = threadIdx.x >> 3, lc = (threadIdx.x & 7) * 8;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (long p0 = p_begin; p0 < p_end; p0 += 32) {
    const long p = p0 + lr;
    uint4 vx = make_uint4(0, 0, 0, 0), vy = make_uint4(0, 0, 0, 0);
    if (p < p_end) {
      vx = *reinterpret_cast<const uint4*>(X + p * k_in + tm * 64 + lc);
      vy = *reinterpret_cast<const uint4*>(dY + p * n_out + tn * 64 + lc);
    }
    if (relu_x) {
      bf16* e = reinterpret_cast<bf16*>(&vx);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (!(__bfloat162float(e[q]) > 0.f)) e[q] = __float2bfloat16(0.f);
    }
    __syncthreads();
    *reinterpret_cast<uint4*>(xs + lr * 72 + lc) = vx;
    *reinterpret_cast<uint4*>(ys + lr * 72 + lc) = vy;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 32; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, xs + kk * 72 + rt * 16, 72);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, ys + kk * 72 + (cg * 2 + j) * 16, 72);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  float* dst = part + blockIdx.y * part_stride + (long)(tm * 64 + rt * 16) * n_out + tn * 64;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(dst + (cg * 2 + j) * 16, acc[j], n_out, wmma::mem_row_major);
}

// out[chunk][c] = sum of in[r][c] over rows r of the chunk, in row order.
__global__ void sum_rows_kernel(const float* in, int rows, long cols, int rows_per_chunk, float* out) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += in[(long)r * cols + c];
  out[(long)blockIdx.y * cols + c] = s;
}

}  // namespace

extern "C" {

// ptrs: x, d, warp, mask_x, mask_d, net (forward layout), acts, out.
// ints: n, width, n_blocks, multires, multires_views.
int stx_fused_fwd(void** ptrs, const int* ints, void* stream) {
  Cursor cur{ptrs, 0};
  Inputs in; Net w; Acts act;
  parse_inputs(cur, ints, in);
  parse_net(cur, in.n_blocks, w);
  parse_acts(cur, in.n_blocks, act);
  float* out = cur.next<float>();
  const size_t smem = fwd_smem(in.width);
  cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int grid = (in.n + T - 1) / T;
  if (grid > 0) fwd_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(in, w, act, out);
  return (int)cudaGetLastError();
}

// ptrs: x, d, warp, mask_x, mask_d, net (backward layout), acts, g,
//       d_in, (d0, d1) x n_blocks, d_out, d_f, d_v, xe, de, part.
int stx_fused_bwd(void** ptrs, const int* ints, void* stream) {
  Cursor cur{ptrs, 0};
  Inputs in; Net w; Acts act; Grads gr;
  parse_inputs(cur, ints, in);
  parse_net(cur, in.n_blocks, w);
  parse_acts(cur, in.n_blocks, act);
  const float* g = cur.next<const float>();
  gr.d_in = cur.next<bf16>();
  for (int i = 0; i < in.n_blocks; ++i) { gr.d0[i] = cur.next<bf16>(); gr.d1[i] = cur.next<bf16>(); }
  gr.d_out = cur.next<bf16>(); gr.d_f = cur.next<bf16>(); gr.d_v = cur.next<bf16>();
  gr.xe = cur.next<bf16>(); gr.de = cur.next<bf16>(); gr.part = cur.next<float>();
  const size_t smem = bwd_smem(in.width);
  cudaFuncSetAttribute(bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int grid = (in.n + T - 1) / T;
  if (grid > 0) bwd_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(in, w, act, g, gr);
  return (int)cudaGetLastError();
}

// Offset of a named field of a CTA's partial vector (a POff member name), or
// -1 for an unknown name.
int stx_partial_offset(int width, int n_blocks, const char* name) {
  const POff o = partial_offsets(width, n_blocks);
  const struct { const char* name; int off; } fields[] = {
      {"b_in", o.b_in}, {"b_blocks", o.b_blocks}, {"b_out", o.b_out}, {"b_f", o.b_f},
      {"b_v", o.b_v},   {"b_a", o.b_a},           {"b_r", o.b_r},     {"w_a", o.w_a},
      {"w_r", o.w_r},   {"pose", o.pose},         {"total", o.total}};
  for (const auto& f : fields)
    if (strcmp(f.name, name) == 0) return f.off;
  return -1;
}

// Points per CTA of fwd_kernel and bwd_kernel (the rows of a partials array).
int stx_tile_points() { return T; }

// Padded encoding width of the lin_in and Wv_bot operands.
int stx_enc_width() { return EW; }

int stx_wgrad(const void* X, int k_in, int relu_x, const void* dY, int n_out, long long n, int splits,
              void* part, long long part_stride, void* stream) {
  const long per_split = (long)((n + splits - 1) / splits);
  dim3 grid((k_in / 64) * (n_out / 64), splits);
  wgrad_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const bf16*>(X), k_in, relu_x, reinterpret_cast<const bf16*>(dY), n_out, (long)n,
      per_split, reinterpret_cast<float*>(part), (long)part_stride);
  return (int)cudaGetLastError();
}

int stx_sum_rows(const void* in, int rows, long long cols, int rows_per_chunk, void* out, void* stream) {
  const int chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  dim3 grid((unsigned)((cols + 255) / 256), chunks);
  if (cols > 0 && chunks > 0)
    sum_rows_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float*>(in), rows, (long)cols, rows_per_chunk, reinterpret_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
