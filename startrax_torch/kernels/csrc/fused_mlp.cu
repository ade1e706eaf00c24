// Fused radiance-field MLP for Hopper (sm_90a): forward and backward, over a
// stack of K fields of one shape.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (startrax/kernels/fused_mlp.py:291),
// `_bwd_kernel` (startrax/kernels/fused_mlp.py:343), `_stacked_fwd_kernel`
// (startrax/kernels/fused_mlp.py:1027) and `_stacked_bwd_kernel`
// (startrax/kernels/fused_mlp.py:1040). One field is the K = 1 case.
//
// Field axis: the grid's y index (z for the partial sums) is the field.
// Every stacked operand is a contiguous stack of K equal per-field blocks
// ([K, n, 3] points, [K, in, out] weights, [K, n, W] activations, [K, tiles,
// total] partials, ...), so field k's block starts k block sizes in; the
// kernels derive those offsets from n and W (the weight-gradient GEMM from
// n and each layer's widths).
// The BARF masks are shared by all fields.
//
// Backward modes: the pose-sum mode (a warped field whose points carry no
// gradient) reduces the 12 pose sums per CTA; the input-gradient mode (dx, dd
// given) writes per-point dx, dd [K, n, 3] f32 through the mask, the encoding
// backward and, with a warp, the M^T unwarp (as `_bwd_kernel` with
// input_grads=True and `_stacked_bwd_kernel` do).
//
// Input modes (the template flag ENC, fixed at compile time so that the
// raw-point instances keep their code): raw points and directions, encoded
// in the kernel (below); or pre-encoded features, `_fwd_kernel` /
// `_bwd_kernel` with pe=None (nerf_time's 4-D points with time, 84 columns):
// x_emb [n, in_ch] with in_ch <= XW = 96, d_emb [n, view_ch] with view_ch <=
// EW, staged to shared memory as bf16 with the pad columns zeroed, and lin_in
// streams an [XW, W] weight whose rows past in_ch are zero. No warp, mask or
// pose sums in that mode; its input-gradient mode writes dx_emb = dh W_in^T
// [n, in_ch] and dd_emb = dhv_in Wv_bot^T [n, view_ch] f32. On the field
// axis (`_stacked_fwd_kernel` / `_stacked_bwd_kernel` with pe=None,
// startrax/kernels/fused_mlp.py:1033, :1061, :1129) the same code runs with
// field k's blocks [K, n, in_ch], [K, n, view_ch], [K, XW, W] lin_in and
// [K, n, XW] encodings, k block sizes in.
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
// card's balance point and device-memory bytes are not the bound. A tile of
// T = 64 points per CTA, one CTA of 8 warps per SM (~227 KB of shared
// memory), keeps its activations in shared memory and streams every layer's
// weights from L2 in KC-row chunks: 16 KB a chunk at W = 256, about 1.5 MB of
// weights a tile for 8x256. The GEMM core (tile_gemm) multiplies with wgmma:
// the two warpgroups split the output columns, A comes from the bf16 tile by
// ldmatrix, B straight from a slot of a three-slot weight ring that thread 0
// fills with one bulk copy (cp.async.bulk, no tensor map) per chunk, from a
// copy the host packed in the order the wgmma descriptor reads. The ring
// runs ahead across GEMMs: the sequence of chunks a kernel consumes is fixed
// at its start (Ring), so the next layer's first chunks load while an
// epilogue runs. Consumers wait on a slot's "full" mbarrier; each warp
// releases the slot on its "empty" mbarrier once wgmma.wait_group has retired
// the chunk. With the matrix loop at wgmma speed, what bounds a CTA is the L2
// rate of the weight chunks (all SMs pull every chunk of every layer, per 64
// points) and the elementwise epilogues between the GEMMs, which run on the
// f32 tile in shared memory (PERF.md has the stamps).
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
//   (B) wgrad_kernel computes dW = relu?(X)^T dY for every wide layer of
//       the call in one grouped launch, one f32 partial per split of the
//       points (bound by bytes; its design is at the kernel);
//   (C) sum_rows_kernel sums the per-CTA partials, and then the split
//       partials, each in one launch and in a fixed order.
//   The TPU's stacked backward zeroed each field's weight grads at its first
//   tile and relied on the grid's order; here each field has its own partials
//   and its own sums, so the weight grads keep a zero run-to-run spread.
// - The TPU's stacked backward recomputed the forward. Here the forward
//   saves bf16 activations for every field, as the per-field call does: the
//   backward then runs no second forward (about a third of its matmuls), for
//   about 3 KB a point and field of device memory.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int T = 64;      // points per CTA
constexpr int NT = 256;    // threads per CTA (two warpgroups of 4 warps: 16-row strips, half the columns each)
constexpr int KC = 32;     // weight rows streamed through shared memory per chunk
constexpr int EW = 64;     // padded encoding width (63 point columns, 27 direction columns)
constexpr int XW = 3 * KC; // padded width of pre-encoded point features (nerf_time: 84 columns)
constexpr int LDE = EW + 8;
constexpr int MAXB = 8;    // most residual blocks a field may have

// Rows of lin_in's weight, the padded width of the point encoding.
template <bool ENC>
__host__ __device__ constexpr int in_rows() { return ENC ? XW : EW; }

struct Inputs {
  const float* x;       // [K, n, 3] world points; [K, n, fx] encoded (ENC)
  const float* d;       // [K, n, 3] view directions; [K, n, fd] encoded (ENC)
  const float* warp;    // [K, 16] M row-major, t; or null
  const float* mask_x;  // [EW] BARF column mask, shared by the fields; or null
  const float* mask_d;  // [EW]; or null
  // fx, fd: multires of the points and the directions; with ENC, the
  // encoded widths in_ch and view_ch
  int n, width, n_blocks, fx, fd, fields;
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
// encodings (the X of lin_in and Wv_bot), per-CTA f32 partials, and in the
// input-gradient mode the per-point input grads (null otherwise).
struct Grads {
  bf16* d_in; bf16* d0[MAXB]; bf16* d1[MAXB]; bf16* d_out; bf16* d_f; bf16* d_v;
  bf16* xe; bf16* de; float* part; float* dx; float* dd;
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
  in.fields = ints[5];
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

// Field k's blocks of the stacked operands (see the header). The forward's
// and the backward's weight layouts have the same block sizes. Only the
// scalar members move: a copy whose arrays were indexed at run time would
// live in local memory, so the per-block arrays (w0, b0, w1, b1 of Net, h, nn
// of Acts, d0, d1 of Grads) are read from the kernel parameters and offset
// where they are used (FieldOff).
struct FieldOff {
  size_t b, ww, act;  // a [W] bias, a [W, W] matrix, a [n, W] activation
};

__device__ __forceinline__ FieldOff field_off(int k, int n, int W) {
  FieldOff f;
  f.b = (size_t)k * W; f.ww = f.b * W; f.act = (size_t)k * n * W;
  return f;
}

template <bool ENC>
__device__ __forceinline__ Inputs field_inputs(Inputs in, int k) {
  const size_t pts = (size_t)k * in.n;
  in.x += pts * (ENC ? in.fx : 3); in.d += pts * (ENC ? in.fd : 3);
  if (in.warp) in.warp += 16 * k;
  return in;
}

template <bool ENC>
__device__ __forceinline__ Net field_net(Net w, int k, int W) {
  const size_t WW = (size_t)W * W, W2 = W / 2;
  w.w_in += (size_t)k * in_rows<ENC>() * W; w.b_in += (size_t)k * W;
  w.w_out += k * WW; w.b_out += (size_t)k * W;
  w.w_a += (size_t)k * W; w.b_a += k;
  w.w_f += k * WW; w.b_f += (size_t)k * W;
  w.wv_top += k * W * W2; w.wv_bot += k * EW * W2; w.b_v += k * W2;
  w.w_r += k * W2 * 3; w.b_r += 3 * k;
  return w;
}

__device__ __forceinline__ Acts field_acts(Acts a, int k, int n, int W) {
  const size_t o = (size_t)k * n * W;
  a.h_last += o; a.ho += o; a.feat += o; a.hv_in += o / 2;
  return a;
}

// cx, cd: the columns of a point's dx and dd (3, or in_ch and view_ch with ENC).
template <bool ENC>
__device__ __forceinline__ Grads field_grads(Grads g, int k, int n, int W, size_t part_per_field,
                                             int cx, int cd) {
  const size_t o = (size_t)k * n * W;
  g.d_in += o; g.d_out += o; g.d_f += o; g.d_v += o / 2;
  g.xe += (size_t)k * n * in_rows<ENC>(); g.de += (size_t)k * n * EW;
  g.part += k * part_per_field;
  if (g.dx) { g.dx += (size_t)k * n * cx; g.dd += (size_t)k * n * cd; }
  return g;
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

// y = M^T v (a grad in the warped frame back to the world frame), or v
// without a warp.
__device__ __forceinline__ void unwarp3(const float* w, const float* v, float* y) {
#pragma unroll
  for (int c = 0; c < 3; ++c) y[c] = w ? w[c] * v[0] + w[3 + c] * v[1] + w[6 + c] * v[2] : v[c];
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

// ---------------------------------------------------------------------------
// The GEMM core: wgmma on a three-slot weight ring.
//
// Every weight matrix a kernel multiplies by is a B [k][nout] (the forward's
// [in, out], the backward's transposes) that the host packs chunk by chunk:
// chunk c holds rows [KC c, KC c + KC) as wgmma's K-major core matrices of
// 8 columns x 8 rows (128 contiguous bytes: column n % 8 at 16 bytes, row
// k % 8 at 2), core (n / 8, (k % KC) / 8) at (n / 8) SBO + ((k % KC) / 8) LBO
// bytes (fused_mlp.py, pack_offset). So one chunk is one contiguous run
// of KC * nout * 2 bytes, which one bulk copy moves into a ring slot.
//
// The chunks a kernel consumes form a fixed sequence, known at its start:
// the stream (Ring::mats). Thread 0 starts the first NSLOT copies at the
// kernel's start; after thread 0 has consumed chunk g, it waits for every
// warp to release g's slot ("empty") and starts chunk g + NSLOT there, which
// may belong to the next GEMM. So the next layer's first chunks load while
// the current epilogue runs. Consumers wait on a slot's "full" barrier.
// ---------------------------------------------------------------------------

constexpr int NSLOT = 3;              // ring slots of KC x W bf16
constexpr int LBO = 128;              // bytes from a core matrix of B to the next along K
constexpr int SBO = (KC / 8) * 128;   // and along N (fused_mlp.py, DESC_LBO / DESC_SBO)
constexpr int MAXM = 2 * MAXB + 6;    // most matrices in a kernel's stream

struct Mat { const bf16* p; int chunks, bytes; };  // bytes: one chunk's

// The ring's state in shared memory. The stream and the cursor are thread
// 0's; the barriers everyone's.
struct Ring {
  unsigned long long full[NSLOT], empty[NSLOT];
  Mat mats[MAXM];
  bf16* slots;            // NSLOT slots of slot_elems
  int slot_elems, n_mats;
  int m, c;               // the next chunk to copy: chunk c of mats[m]
  unsigned total, head;   // chunks in the stream; chunks copied so far
};

// One thread's view of the ring: the ring, and the chunks it has consumed.
struct Feed { Ring* r; unsigned g; };

struct Seg { const bf16* a; int lda; int k; };  // A [T][k] (bf16, shared), row stride lda

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Waits for the completion of the barrier's phase of this parity. A ring
// that never fills traps after about ten seconds rather than hang the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(a, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Starts copying chunk `head` of the stream into its slot (thread 0). A cursor
// that has lost count and run past the stream traps.
__device__ void ring_issue(Ring* r) {
  if (r->m >= r->n_mats) __trap();
  const Mat mt = r->mats[r->m];
  const int slot = r->head % NSLOT;
  const uint32_t bar = smem_u32(&r->full[slot]);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(mt.bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(r->slots + slot * r->slot_elems)), "l"(mt.p + (size_t)r->c * (mt.bytes / 2)),
        "r"(mt.bytes), "r"(bar)
      : "memory");
  ++r->head;
  if (++r->c == mt.chunks) {
    r->c = 0;
    ++r->m;
  }
}

// Appends B [k][nout] (packed) to the stream (thread 0, at the kernel's start).
__device__ __forceinline__ void ring_add(Ring* r, const bf16* p, int k, int nout) {
  r->mats[r->n_mats++] = {p, k / KC, KC * nout * (int)sizeof(bf16)};
  r->total += k / KC;
}

__device__ __forceinline__ void ring_init(Ring* r, bf16* slots, int slot_elems) {
  for (int s = 0; s < NSLOT; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&r->full[s])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&r->empty[s])), "n"(NT / 32)
                 : "memory");
  }
  r->slots = slots; r->slot_elems = slot_elems;
  r->n_mats = 0; r->m = 0; r->c = 0; r->total = 0; r->head = 0;
}

// After the stream is complete (thread 0): the first NSLOT copies.
__device__ __forceinline__ void ring_start(Ring* r) {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  while (r->head < min(r->total, (unsigned)NSLOT)) ring_issue(r);
}

// At the kernel's end (thread 0): waits for any copy still in flight, so
// that none lands in the shared memory of a finished CTA.
__device__ __forceinline__ void ring_drain(Ring* r, unsigned consumed) {
  for (unsigned h = consumed; h < r->head; ++h) mbar_wait(&r->full[h % NSLOT], (h / NSLOT) & 1);
}

// wgmma m64nNk16, D (f32, registers) += A (bf16, registers) B (bf16, shared
// memory through desc), for the N that the GEMMs use.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Shared-memory descriptor of B at p: K-major core matrices without swizzle,
// the next core along K at LBO bytes, along N at SBO bytes.
__device__ __forceinline__ uint64_t b_desc(const bf16* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void fence_acc(float* acc) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// Releases chunk g's slot: each warp arrives on its "empty" barrier once its
// wgmma.wait_group has retired the chunk; thread 0 waits for all of them and
// refills the slot with chunk g + NSLOT.
__device__ __forceinline__ void release(Ring* r, unsigned g) {
  const int slot = g % NSLOT;
  if ((threadIdx.x & 31) == 0) mbar_arrive(&r->empty[slot]);
  if (threadIdx.x == 0 && g + NSLOT < r->total) {
    mbar_wait(&r->empty[slot], (g / NSLOT) & 1);
    ring_issue(r);
  }
  __syncwarp();
}

// C [T][2N] = the segments' A @ B, each warpgroup computing the columns
// [N wg, N wg + N) with the tile's 64 rows (warp w % 4 holds rows 16 (w % 4)
// .. + 15 of A and of D). Per chunk: A from ldmatrix, the slot's "full"
// wait, two wgmma k16 steps, wait_group 0, then the slot's release. (Keeping
// one chunk's wgmma in flight while the next is issued measured slower: the
// second A register set pushed the backward to 255 registers and spills.)
template <int N>
__device__ void gemm_core(const Seg* segs, int nseg, Feed& f, float* c, int ldc) {
  Ring* r = f.r;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2, wr = warp & 3;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  unsigned g = f.g;
  for (int s = 0; s < nseg; ++s) {
    const Seg sg = segs[s];
    const bf16* arow = sg.a + (16 * wr + (lane & 15)) * sg.lda + (lane >> 4) * 8;
    for (int k0 = 0; k0 < sg.k; k0 += KC, ++g) {
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(a[h][0]), "=r"(a[h][1]), "=r"(a[h][2]), "=r"(a[h][3])
                     : "r"(smem_u32(arow + k0 + 16 * h)));
      const int slot = g % NSLOT;
      mbar_wait(&r->full[slot], (g / NSLOT) & 1);
      // this warpgroup's N / 8 cores along N; the second k16 step 2 cores along K on
      const bf16* b = r->slots + slot * r->slot_elems + wg * (N / 8) * (SBO / 2);
      fence_acc<N>(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      wgmma_rs<N>(acc, a[0], b_desc(b));
      wgmma_rs<N>(acc, a[1], b_desc(b + 2 * (LBO / 2)));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc<N>(acc);
#pragma unroll
      for (int h = 0; h < 2; ++h)  // the A registers live until the wgmma retired
        asm volatile("" ::"r"(a[h][0]), "r"(a[h][1]), "r"(a[h][2]), "r"(a[h][3]) : "memory");
      release(r, g);
    }
  }
  f.g = g;
  const int row = 16 * wr + (lane >> 2), col = wg * N + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    *reinterpret_cast<float2*>(c + row * ldc + col + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(c + (row + 8) * ldc + col + 8 * j) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// C[T][nout] (f32, shared) = sum over segments of A[T][k] (bf16, shared) @
// the stream's next sum(k) / KC chunks, B [k][nout]. All NT threads call it
// with the same arguments; nout is 256, 128, 96 or 64 and each k a multiple
// of KC. Starts and ends synchronised.
__device__ void tile_gemm(const Seg* segs, int nseg, int nout, Feed& f, float* c, int ldc) {
  __syncthreads();  // A written, C free
  switch (nout) {
    case 256: gemm_core<128>(segs, nseg, f, c, ldc); break;
    case 128: gemm_core<64>(segs, nseg, f, c, ldc); break;
    case 96: gemm_core<48>(segs, nseg, f, c, ldc); break;
    default: gemm_core<32>(segs, nseg, f, c, ldc); break;
  }
  __syncthreads();
}

__device__ __forceinline__ void gemm1(const bf16* a, int lda, int k, int nout, Feed& f, float* c,
                                      int ldc) {
  Seg s = {a, lda, k};
  tile_gemm(&s, 1, nout, f, c, ldc);
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

// Shared memory of the kernels at width W; every region's size is a
// multiple of 16 bytes, so the Ring at the end is aligned.
size_t fwd_smem(int W) {
  return sizeof(float) * 2 * T * (W + 4) + sizeof(bf16) * (T * (W + 8) + T * LDE + NSLOT * KC * W) +
         sizeof(float) * (T * 6 + T) + sizeof(Ring);
}

size_t bwd_smem(int W) {
  return sizeof(float) * 2 * T * (W + 4) + sizeof(bf16) * (T * (W + 8) + NSLOT * KC * W) +
         sizeof(float) * (T * 6 * 2 + T * 4 + T * 3 + T * 12) + sizeof(Ring);
}

// Loads a point tile's raw and warped inputs: raw[t*6 + 0..5] = (x, d),
// wp[t*6 + 0..5] = (M x + t, M d); zeros past the batch.
// (The field's pointers come by value: a reference to the kernel's local
// Inputs copy would put that copy in local memory.)
__device__ __forceinline__ void load_points(const float* x, const float* d, const float* warp, int n,
                                            long row0, float* raw, float* wp) {
  const int t = threadIdx.x;
  if (t >= T) return;
  const long p = row0 + t;
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (p < n) {
#pragma unroll
    for (int i = 0; i < 3; ++i) { v[i] = x[p * 3 + i]; v[3 + i] = d[p * 3 + i]; }
  }
  if (raw) for (int i = 0; i < 6; ++i) raw[t * 6 + i] = v[i];
  if (warp) {
    warp3(warp, v, true, wp + t * 6);
    warp3(warp, v + 3, false, wp + t * 6 + 3);
  } else {
    for (int i = 0; i < 6; ++i) wp[t * 6 + i] = v[i];
  }
}

// Copies a tile of pre-encoded features, rounded to bf16, into dst [T][ld]
// (ld may be a global row stride): dst[t][j] = src[row0 + t][j] for j < cols
// (the row stride of src), 0 for cols <= j < width and past the batch; rows
// past the batch are left out when skip_tail is set.
__device__ __forceinline__ void stage_encoded(const float* src, int cols, int width, int n, long row0,
                                              bf16* dst, int ld, bool skip_tail) {
  for (int i = threadIdx.x; i < T * width; i += NT) {
    const int t = i / width, j = i - t * width;
    const long p = row0 + t;
    if (skip_tail && p >= n) continue;
    dst[t * ld + j] = __float2bfloat16(p < n && j < cols ? src[p * cols + j] : 0.f);
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

// STACKED = false is the one-field launch: its field index is the constant 0,
// and it reads the kernel parameters themselves, not field copies of them.
// (With copies, ptxas allocated the one-field kernel 152 registers against
// 168 and recomputed 64-bit weight addresses in every GEMM segment: 3% of
// the forward.) ENC selects the pre-encoded input mode (see the header).
template <bool STACKED, bool ENC>
__global__ void __launch_bounds__(NT, 1) fwd_kernel(Inputs all_in, Net net, Acts all_act, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = all_in.width, W2 = W / 2, LDF = W + 4, LDA = W + 8, k = STACKED ? blockIdx.y : 0;
  const Inputs in_k = field_inputs<ENC>(all_in, k);
  const Net w_k = field_net<ENC>(net, k, W);
  const Acts act_k = field_acts(all_act, k, all_in.n, W);
  const Inputs& in = STACKED ? in_k : all_in;
  const Net& w = STACKED ? w_k : net;
  const Acts& act = STACKED ? act_k : all_act;
  const FieldOff f = field_off(k, in.n, W);
  out += (size_t)k * in.n * 4;
  float* hs = reinterpret_cast<float*>(smem);            // [T][LDF] residual stream h (f32)
  float* cs = hs + T * LDF;                              // [T][LDF] matmul result
  bf16* as = reinterpret_cast<bf16*>(cs + T * LDF);      // [T][LDA] bf16 operand
  bf16* es = as + T * LDA;                               // [T][LDE] direction encoding
  bf16* bs = es + T * LDE;                               // [NSLOT][KC * W] weight ring
  float* ps = reinterpret_cast<float*>(bs + NSLOT * KC * W);  // [T][6] warped x, d
  float* al = ps + T * 6;                                // [T] alpha
  Ring* ring = reinterpret_cast<Ring*>(al + T);
  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * T;
  const int nrow = (int)min((long)T, (long)in.n - row0);
  if (tid == 0) {  // the stream, in the order of the GEMMs below
    ring_init(ring, bs, KC * W);
    ring_add(ring, w.w_in, in_rows<ENC>(), W);
    for (int b = 0; b < in.n_blocks; ++b) {
      ring_add(ring, net.w0[b] + f.ww, W, W);
      ring_add(ring, net.w1[b] + f.ww, W, W);
    }
    ring_add(ring, w.w_out, W, W);
    ring_add(ring, w.w_f, W, W);
    ring_add(ring, w.wv_top, W, W2);
    ring_add(ring, w.wv_bot, EW, W2);
    ring_start(ring);
  }
  Feed feed = {ring, 0};

  if constexpr (ENC) {
    stage_encoded(in.x, in.fx, XW, in.n, row0, as, LDA, false);
    stage_encoded(in.d, in.fd, EW, in.n, row0, es, LDE, false);
  } else {
    load_points(in.x, in.d, in.warp, in.n, row0, nullptr, ps);
    __syncthreads();
    for (int i = tid; i < T * EW; i += NT) {
      const int t = i / EW, j = i - t * EW;
      float vx = pe_val(ps + t * 6, j, in.fx), vd = pe_val(ps + t * 6 + 3, j, in.fd);
      if (in.mask_x) vx *= in.mask_x[j];
      if (in.mask_d) vd *= in.mask_d[j];
      as[t * LDA + j] = __float2bfloat16(vx);
      es[t * LDE + j] = __float2bfloat16(vd);
    }
  }

  // The elementwise passes give each thread the same eight-column groups of
  // the tile (16-byte stores of the saved bf16 activations), so a pass may
  // read what the previous W-wide pass wrote without a barrier.
  const int V = W / 8, V2 = W2 / 8;
  gemm1(as, LDA, in_rows<ENC>(), W, feed, hs, LDF);
  for (int b = 0; b < in.n_blocks; ++b) {
    for (int i = tid; i < T * V; i += NT) {
      const int t = i / V, c = (i - t * V) * 8;
      float h[8], r[8];
      ld_f8(hs + t * LDF + c, h);
      if (b == 0) {
        add_bias8(h, w.b_in + c);
        st_f8(hs + t * LDF + c, h);
      }
      if (t < nrow) st_bf8g(h, (all_act.h[b] + f.act) + (row0 + t) * W + c);
      relu8(h, r);
      st_bf8(r, as + t * LDA + c, nullptr);
    }
    gemm1(as, LDA, W, W, feed, cs, LDF);
    for (int i = tid; i < T * V; i += NT) {
      const int t = i / V, c = (i - t * V) * 8;
      float v[8], r[8];
      ld_f8(cs + t * LDF + c, v);
      add_bias8(v, (net.b0[b] + f.b) + c);
      if (t < nrow) st_bf8g(v, (all_act.nn[b] + f.act) + (row0 + t) * W + c);
      relu8(v, r);
      st_bf8(r, as + t * LDA + c, nullptr);
    }
    gemm1(as, LDA, W, W, feed, cs, LDF);
    for (int i = tid; i < T * V; i += NT) {  // h = h + (fc1 + b1)
      const int t = i / V, c = (i - t * V) * 8;
      float v[8], h[8];
      ld_f8(cs + t * LDF + c, v);
      add_bias8(v, (net.b1[b] + f.b) + c);
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
  gemm1(as, LDA, W, W, feed, cs, LDF);
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
  gemm1(as, LDA, W, W, feed, cs, LDF);
  for (int i = tid; i < T * V; i += NT) {
    const int t = i / V, c = (i - t * V) * 8;
    float v[8];
    ld_f8(cs + t * LDF + c, v);
    add_bias8(v, w.b_f + c);
    st_bf8(v, as + t * LDA + c, t < nrow ? act.feat + (row0 + t) * W + c : nullptr);
  }
  {
    Seg s[2] = {{as, LDA, W}, {es, LDE, EW}};
    tile_gemm(s, 2, W2, feed, cs, LDF);
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
  if (tid == 0) ring_drain(ring, feed.g);
}

template <bool STACKED, bool ENC>  // as fwd_kernel
__global__ void __launch_bounds__(NT, 1) bwd_kernel(Inputs all_in, Net net, Acts all_act, const float* g,
                                                     Grads all_gr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = all_in.width, W2 = W / 2, LDF = W + 4, LDA = W + 8, nb = all_in.n_blocks;
  const int k = STACKED ? blockIdx.y : 0;
  const POff o = partial_offsets(W, nb);
  const Inputs in_k = field_inputs<ENC>(all_in, k);
  const Net w_k = field_net<ENC>(net, k, W);
  const Acts act_k = field_acts(all_act, k, all_in.n, W);
  const Grads gr_k = field_grads<ENC>(all_gr, k, all_in.n, W, (size_t)gridDim.x * o.total,
                                      ENC ? all_in.fx : 3, ENC ? all_in.fd : 3);
  const Inputs& in = STACKED ? in_k : all_in;
  const Net& w = STACKED ? w_k : net;
  const Acts& act = STACKED ? act_k : all_act;
  const Grads& gr = STACKED ? gr_k : all_gr;
  const FieldOff f = field_off(k, in.n, W);
  g += (size_t)k * in.n * 4;
  float* dhs = reinterpret_cast<float*>(smem);           // [T][LDF] residual grad dh (f32)
  float* cs = dhs + T * LDF;                             // [T][LDF] matmul result
  bf16* as = reinterpret_cast<bf16*>(cs + T * LDF);      // [T][LDA] bf16 operand
  bf16* bs = as + T * LDA;                               // [NSLOT][KC * W] weight ring
  float* raw = reinterpret_cast<float*>(bs + NSLOT * KC * W);  // [T][6] world x, d
  float* ps = raw + T * 6;                               // [T][6] warped x, d
  float* gs = ps + T * 6;                                // [T][4] cotangent
  float* pd = gs + T * 4;                                // [T][3] world-frame d grads
  float* pose = pd + T * 3;                              // [T][12] per-point pose terms
  Ring* ring = reinterpret_cast<Ring*>(pose + T * 12);
  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * T;
  const int nrow = (int)min((long)T, (long)in.n - row0);
  const bool warped = in.warp != nullptr;
  const bool in_grads = gr.dx != nullptr;  // else the pose sums, when warped
  float* part = gr.part + (size_t)blockIdx.x * o.total;
  if (tid == 0) {  // the stream: the transposes, in the order of the GEMMs below
    ring_init(ring, bs, KC * W);
    if (warped || in_grads) ring_add(ring, w.wv_bot, W2, EW);
    ring_add(ring, w.wv_top, W2, W);
    ring_add(ring, w.w_f, W, W);
    ring_add(ring, w.w_out, W, W);
    for (int b = nb - 1; b >= 0; --b) {
      ring_add(ring, net.w1[b] + f.ww, W, W);
      ring_add(ring, net.w0[b] + f.ww, W, W);
    }
    if (warped || in_grads) ring_add(ring, w.w_in, W, in_rows<ENC>());
    ring_start(ring);
  }
  Feed feed = {ring, 0};

  if constexpr (!ENC) load_points(in.x, in.d, in.warp, in.n, row0, raw, ps);
  if (tid < T)
    for (int j = 0; j < 4; ++j) gs[tid * 4 + j] = tid < nrow ? g[(row0 + tid) * 4 + j] : 0.f;
  __syncthreads();
  // encodings: the X of lin_in and Wv_bot
  if constexpr (ENC) {
    stage_encoded(in.x, in.fx, XW, in.n, row0, gr.xe + row0 * XW, XW, true);
    stage_encoded(in.d, in.fd, EW, in.n, row0, gr.de + row0 * EW, EW, true);
  } else {
    for (int i = tid; i < T * EW; i += NT) {
      const int t = i / EW, j = i - t * EW;
      if (t >= nrow) continue;
      float vx = pe_val(ps + t * 6, j, in.fx), vd = pe_val(ps + t * 6 + 3, j, in.fd);
      if (in.mask_x) vx *= in.mask_x[j];
      if (in.mask_d) vd *= in.mask_d[j];
      gr.xe[(row0 + t) * EW + j] = __float2bfloat16(vx);
      gr.de[(row0 + t) * EW + j] = __float2bfloat16(vd);
    }
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

  if (warped || in_grads) {  // dd_emb = dhv_in @ Wv_bot^T -> mask -> encoding backward -> M^T
    gemm1(as, LDA, W2, EW, feed, dhs, LDF);
    if constexpr (ENC) {  // dd_emb is the input grad
      for (int i = tid; i < T * in.fd; i += NT) {
        const int t = i / in.fd, c = i - t * in.fd;
        if (t < nrow) gr.dd[(row0 + t) * in.fd + c] = dhs[t * LDF + c];
      }
    } else {
      float dw[3];
      pe_bwd(dhs, LDF, ps + 3, in.mask_d, in.fd, dw);
      if ((tid & 3) == 0) {
        const int t = tid >> 2;
        unwarp3(in.warp, dw, pd + t * 3);
        if (in_grads && t < nrow)
          for (int c = 0; c < 3; ++c) gr.dd[(row0 + t) * 3 + c] = pd[t * 3 + c];
      }
    }
  }

  // dfeat = dhv_in @ Wv_top^T
  gemm1(as, LDA, W2, W, feed, cs, LDF);
  for (int i = tid; i < T * V; i += NT) {
    const int t = i / V, c = (i - t * V) * 8;
    float v[8];
    ld_f8(cs + t * LDF + c, v);
    st_bf8(v, as + t * LDA + c, t < nrow ? gr.d_f + (row0 + t) * W + c : nullptr);
  }
  __syncthreads();
  colsum(cs, LDF, W, part + o.b_f);

  // dho = dfeat @ W_f^T + dalpha W_a^T
  gemm1(as, LDA, W, W, feed, cs, LDF);
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
  gemm1(as, LDA, W, W, feed, cs, LDF);
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
      st_bf8(v, as + t * LDA + c, t < nrow ? (all_gr.d1[b] + f.act) + (row0 + t) * W + c : nullptr);
    }
    __syncthreads();
    colsum(dhs, LDF, W, part + o.b_blocks + 2 * W * b + W);
    gemm1(as, LDA, W, W, feed, cs, LDF);
    for (int i = tid; i < T * V; i += NT) {  // dn = da1 * (n > 0)
      const int t = i / V, c = (i - t * V) * 8;
      float a[8], v[8];
      ld_act8(all_act.nn[b] + f.act, row0, t, c, W, nrow, a);
      ld_f8(cs + t * LDF + c, v);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = a[q] > 0.f ? v[q] : 0.f;
      st_f8(cs + t * LDF + c, v);
      st_bf8(v, as + t * LDA + c, t < nrow ? (all_gr.d0[b] + f.act) + (row0 + t) * W + c : nullptr);
    }
    __syncthreads();
    colsum(cs, LDF, W, part + o.b_blocks + 2 * W * b);
    gemm1(as, LDA, W, W, feed, cs, LDF);
    for (int i = tid; i < T * V; i += NT) {  // dh += da0 * (h_in > 0)
      const int t = i / V, c = (i - t * V) * 8;
      float a[8], v[8], dh[8];
      ld_act8(all_act.h[b] + f.act, row0, t, c, W, nrow, a);
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

  // dx_emb = dh @ W_in^T -> mask -> encoding backward -> M^T -> dx, or the pose sums
  const bool pose_sums = warped && !in_grads;
  if (warped || in_grads) {
    gemm1(as, LDA, W, in_rows<ENC>(), feed, cs, LDF);
    if constexpr (ENC) {  // dx_emb is the input grad
      for (int i = tid; i < T * in.fx; i += NT) {
        const int t = i / in.fx, c = i - t * in.fx;
        if (t < nrow) gr.dx[(row0 + t) * in.fx + c] = cs[t * LDF + c];
      }
    } else {
      float dw[3];
      pe_bwd(cs, LDF, ps, in.mask_x, in.fx, dw);
      if ((tid & 3) == 0) {
        const int t = tid >> 2;
        float dx[3];
        unwarp3(in.warp, dw, dx);
        if (in_grads) {
          if (t < nrow)
            for (int c = 0; c < 3; ++c) gr.dx[(row0 + t) * 3 + c] = dx[c];
        } else {
          for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j)
              pose[t * 12 + 3 * i + j] = dx[i] * raw[t * 6 + j] + pd[t * 3 + i] * raw[t * 6 + 3 + j];
            pose[t * 12 + 9 + i] = dx[i];
          }
        }
      }
    }
    __syncthreads();
  }
  if (tid < 12) {
    float s = 0.f;
    if (pose_sums)
      for (int t = 0; t < T; ++t) s += pose[t * 12 + tid];
    part[o.pose + tid] = s;
  }
  if (tid == 0) ring_drain(ring, feed.g);
}

// ---------------------------------------------------------------------------
// (B) The weight-gradient GEMM: dW = relu?(X)^T dY for every wide layer of
// one backward call, in one launch (wgrad_kernel).
//
// The work is bound by bytes: X and dY are read once, 2 n (k_in + n_out)
// bf16 a layer, against k_in n_out multiply-adds a point, about 120
// operations a byte at W = 256 where the card balances at ~295. So the
// design reads each operand once, at close to device-memory rate:
// - A CTA owns up to WG_ROWS = 128 rows of one layer's k_in and all its
//   n_out (<= 256) columns, over one split of the points; its two
//   warpgroups hold an m64 x n_out f32 accumulator each (128 registers a
//   thread at n_out = 256). A 256-row layer thus reads its X once and its
//   dY twice; the two row tiles of a split are neighbours in the grid, so
//   the second read of dY comes from L2.
// - Points stream through a WG_STAGES-deep ring of WG_P-point slabs,
//   WG_STAGES - 1 slabs ahead of the math, with one block barrier a slab.
//   Thread 0 fills a slab, while its warpgroup's wgmma run, with a few
//   tensor-memory-accelerator copies of
//   64 points x 64 columns (X's, then dY's), 128-byte swizzled, under the
//   stage's "full" mbarrier. (Filling it with 16-byte cp.async instead, or
//   with copies of 16-byte rows, left the SMs taking in ~2.3 TB/s in all,
//   most of a CTA's cycles spent issuing copies; PERF.md, PR 6.) A slab may
//   reach past the split's end into real rows of the next split or field,
//   or past the tensor, where the copy fills zeros; the A registers of
//   points past the split's end are zeroed, so they add nothing.
// - A = X^T comes from the slab's X tiles [point][64 columns] by
//   ldmatrix.trans into registers, where relu is applied; B = dY is
//   point-major, that is MN-major for wgmma, read in place from its
//   swizzled tiles by a descriptor with the transpose bit set.
// - Every (field, layer, row tile, split) is one CTA of one launch; the
//   layer table (WgTable) is the kernel's parameter, by value. Each split
//   writes its own f32 partial, so the sums (C) fix the order and the
//   weight grads keep a zero run-to-run spread.
// ---------------------------------------------------------------------------

constexpr int WG_MAXL = 2 * MAXB + 5;  // wide layers of a backward call, at most
constexpr int WG_P = 64;               // points a slab
constexpr int WG_STAGES = 4;           // slabs in the ring
constexpr int WG_ROWS = 128;           // output rows (columns of X) a CTA: two warpgroups of 64
constexpr int WG_NMAX = 256;           // widest dY
constexpr int WG_BLK = WG_P * 64;      // elements of a tile: 64 points x 64 columns, 128-byte rows
constexpr int WG_STAGE = (WG_ROWS + WG_NMAX) / 64 * WG_BLK;  // elements of a stage: X, then dY tiles

// One wide layer: X [fields, n, k_in] and dY [fields, n, n_out] bf16; its
// [k_in][n_out] partial sits wofs floats into each split's row of wpart.
// tile0: the row tiles (ceil(k_in / WG_ROWS)) of the layers before it.
struct WgLayer {
  const bf16* x;
  const bf16* dy;
  long long wofs;
  int k_in, n_out, relu, tile0;
};

// The layer table of one launch (the Python wrapper builds it, fused_mlp.py
// _WgTable). per_split = ceil(n / splits); wtotal: floats in a split's row;
// tiles: the row tiles of all layers, the CTAs of one split and field.
struct WgTable {
  WgLayer l[WG_MAXL];
  long long n, per_split, wtotal;
  int n_layers, splits, tiles;
};

// The kernel's parameter: the table and, for each layer, the tensor maps of
// its X [fields * n][k_in] and dY [fields * n][n_out]. A copy moves a tile
// of 64 points x 64 columns into 64 rows of 128 bytes, 128-byte swizzled:
// the 16-byte chunk c of row r lands at chunk c ^ (r % 8).
struct WgParams {
  WgTable t;
  CUtensorMap x_map[WG_MAXL], dy_map[WG_MAXL];
};

// 1 KB of slack to align the ring to the swizzle's 1,024-byte pattern.
size_t wgrad_smem() {
  return sizeof(bf16) * WG_STAGES * WG_STAGE + sizeof(unsigned long long) * WG_STAGES + 1024;
}

// wgmma m64nNk16, D (f32, registers) += A (bf16, registers) B (bf16, shared
// memory through desc), B MN-major (the transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float* d, const uint32_t* a, uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<256>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


// Shared-memory descriptor of an MN-major operand in 128-byte swizzled
// tiles: the next 64 columns (the next tile) at lbo bytes, the next 8 rows
// along K at sbo bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// Starts copying the slab of rows [row, row + WG_P) (thread 0): X's columns
// [c0, c0 + kc) as ceil(kc / 64) tiles (zeros past k_in), then dY's N / 64
// tiles, under the stage's "full" barrier.
template <int N>
__device__ __forceinline__ void wg_load(const CUtensorMap* x_map, const CUtensorMap* dy_map, int c0, int kc,
                                        int row, bf16* stage, unsigned long long* full) {
  const uint32_t bar = smem_u32(full);
  const int xt = (kc + 63) / 64;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"((xt + N / 64) * WG_BLK * (int)sizeof(bf16))
               : "memory");
  for (int i = 0; i < xt; ++i) tma_tile(stage + i * WG_BLK, x_map, c0 + 64 * i, row, bar);
#pragma unroll
  for (int j = 0; j < N / 64; ++j) tma_tile(stage + (WG_ROWS / 64 + j) * WG_BLK, dy_map, 64 * j, row, bar);
}

// One CTA's tile: rows [c0, c0 + 128) of layer L's dW for one field and
// split, written to its partial in wpart. Warpgroup wg computes rows
// c0 + 64 wg .. + 63 (warp wr of it 16 of them, as gemm_core) from X tile
// wg of each slab.
template <int N>
__device__ void wg_tile(const WgTable& t, const WgLayer& L, const CUtensorMap* x_map, const CUtensorMap* dy_map,
                        int field, int split, int rt, bf16* ring, unsigned long long* full, float* wpart) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2, wr = warp & 3;
  const int c0 = rt * WG_ROWS, kc = min(WG_ROWS, L.k_in - c0);
  const bool active = 64 * wg < kc;
  const long p_begin = min((long)t.n, (long)(split * t.per_split));
  const long p_end = min((long)t.n, p_begin + (long)t.per_split);
  const int slabs = (int)((p_end - p_begin + WG_P - 1) / WG_P);
  const int row0 = (int)((long)field * t.n + p_begin);  // the split's first row of the maps
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  if (threadIdx.x == 0)
    for (int s = 0; s < WG_STAGES - 1 && s < slabs; ++s)
      wg_load<N>(x_map, dy_map, c0, kc, row0 + s * WG_P, ring + s * WG_STAGE, full + s);
  // this lane's ldmatrix row of a k16 step: point (lane % 8) + 8 (lane / 16),
  // columns 16 wr + 8 ((lane / 8) % 2) of X tile wg, its chunk swizzled by the point
  const int xoff = wg * WG_BLK + ((lane & 7) + 8 * (lane >> 4)) * 64 +
                   8 * ((2 * wr + ((lane >> 3) & 1)) ^ (lane & 7));
  // the points of this thread's A registers: 2 (lane % 4) + 8 (q / 2) + {0, 1} of each k16 step
  const int pt = 2 * (lane & 3);
  for (int s = 0; s < slabs; ++s) {
    const int b = s % WG_STAGES;
    mbar_wait(full + b, (s / WG_STAGES) & 1);  // slab s has landed
    __syncthreads();  // slab s - 1's stage is free
    if (!active) continue;  // (thread 0 is always active)
    const bf16* xs = ring + b * WG_STAGE + xoff;
    const bf16* ys = ring + b * WG_STAGE + (WG_ROWS / 64) * WG_BLK;
    // points of the slab past the split's end (the last slab) hold rows of
    // the next split or zeros: their X is zeroed, so they add nothing
    const int valid = (int)min((long)WG_P, p_end - p_begin - (long)s * WG_P);
    uint32_t a[WG_P / 16][4];
#pragma unroll
    for (int k = 0; k < WG_P / 16; ++k) {
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(a[k][0]), "=r"(a[k][1]), "=r"(a[k][2]), "=r"(a[k][3])
                   : "r"(smem_u32(xs + 16 * k * 64)));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&a[k][q]);
        if (L.relu) v = __hmax2(v, __float2bfloat162_rn(0.f));
        const int p = 16 * k + 8 * (q >> 1) + pt;
        if (p >= valid) v.x = __float2bfloat16(0.f);
        if (p + 1 >= valid) v.y = __float2bfloat16(0.f);
        a[k][q] = *reinterpret_cast<uint32_t*>(&v);
      }
    }
    fence_acc<N>(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < WG_P / 16; ++k)  // k16 step k: rows 16 k .. + 15 of each dY tile, 2 x 1,024 bytes
      wgmma_rs_tb<N>(acc, a[k], sw128_desc(ys + 16 * k * 64, WG_BLK * (int)sizeof(bf16), 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    {  // while the wgmma run, the copies of slab s + WG_STAGES - 1 into slab s - 1's stage
      const int s2 = s + WG_STAGES - 1, b2 = s2 % WG_STAGES;
      if (threadIdx.x == 0 && s2 < slabs)
        wg_load<N>(x_map, dy_map, c0, kc, row0 + s2 * WG_P, ring + b2 * WG_STAGE, full + b2);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc<N>(acc);
#pragma unroll
    for (int k = 0; k < WG_P / 16; ++k)  // the A registers live until the wgmma retired
      asm volatile("" ::"r"(a[k][0]), "r"(a[k][1]), "r"(a[k][2]), "r"(a[k][3]) : "memory");
  }
  if (!active) return;
  float* dst = wpart + ((size_t)field * t.splits + split) * t.wtotal + L.wofs;
  const int row = c0 + 64 * wg + 16 * wr + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= L.k_in) continue;
    float* d = dst + (size_t)(row + 8 * h) * N + col;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(d + 8 * j) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// wpart [field][split][t.wtotal]: blockIdx.y is the field; blockIdx.x runs
// over the layers in table order, each over its splits, each split over its
// row tiles (the two row tiles of a split side by side).
__global__ void __launch_bounds__(NT, 1) wgrad_kernel(const __grid_constant__ WgParams prm, float* wpart) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WgTable& t = prm.t;
  // [WG_STAGES][WG_STAGE] slabs, 1,024-byte aligned: X tiles, then dY tiles
  bf16* ring = reinterpret_cast<bf16*>(smem + ((1024 - (smem_u32(smem) & 1023)) & 1023));
  unsigned long long* full = reinterpret_cast<unsigned long long*>(ring + WG_STAGES * WG_STAGE);
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int bid = blockIdx.x;
  int l = 0;
  while (l + 1 < t.n_layers && bid >= t.l[l + 1].tile0 * t.splits) ++l;
  const WgLayer L = t.l[l];
  const int rows = (L.k_in + WG_ROWS - 1) / WG_ROWS;
  const int local = bid - L.tile0 * t.splits, split = local / rows, rt = local - split * rows;
  const CUtensorMap *xm = prm.x_map + l, *ym = prm.dy_map + l;
  switch (L.n_out) {
    case 256: wg_tile<256>(t, L, xm, ym, blockIdx.y, split, rt, ring, full, wpart); break;
    case 128: wg_tile<128>(t, L, xm, ym, blockIdx.y, split, rt, ring, full, wpart); break;
    default: wg_tile<64>(t, L, xm, ym, blockIdx.y, split, rt, ring, full, wpart); break;
  }
}

// ---------------------------------------------------------------------------
// (C) Ordered sums: out[field][c] = the sum over rows r of in[field][r][c],
// one launch a sum (sum_rows_kernel).
//
// Bound by bytes: each input float is read once. A CTA owns a slab of
// SR_COLS columns (a float4 a thread) and a chunk of rows, and sums it with
// SR_ACC independent accumulators (row r0 + SR_ACC i + j into the j-th),
// added in a fixed order. With one chunk it writes the result; otherwise it
// writes its chunk's sum to scratch, and the last CTA of the slab to arrive
// (a counter the wrapper keeps zeroed; that CTA sets it back to 0) adds the
// chunk sums in chunk order. The order depends only on the shapes, so the
// result does not depend on scheduling.
// ---------------------------------------------------------------------------

constexpr int SR_T = 256;         // threads of a CTA
constexpr int SR_COLS = 4 * SR_T;  // columns of a slab
constexpr int SR_ACC = 8;         // independent accumulators a thread

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7)), componentwise
__device__ __forceinline__ float4 sum_acc(float4* a) {
#pragma unroll
  for (int step = 1; step < SR_ACC; step *= 2)
#pragma unroll
    for (int j = 0; j < SR_ACC; j += 2 * step) add4(a[j], a[j + step]);
  return a[0];
}

__global__ void __launch_bounds__(SR_T) sum_rows_kernel(const float* in, int rows, long long cols,
                                                         int rows_per_chunk, float* scratch,
                                                         unsigned* counters, float* out) {
  const int slab = blockIdx.x, chunk = blockIdx.y, field = blockIdx.z, chunks = gridDim.y;
  const long long c = (long long)slab * SR_COLS + 4 * threadIdx.x;
  const bool ok = c < cols;
  in += (size_t)field * rows * cols;
  const int r0 = min(rows, chunk * rows_per_chunk), r1 = min(rows, r0 + rows_per_chunk);
  float4 a[SR_ACC];
#pragma unroll
  for (int j = 0; j < SR_ACC; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok) {
    int r = r0;
    for (; r + SR_ACC <= r1; r += SR_ACC)
#pragma unroll
      for (int j = 0; j < SR_ACC; ++j) add4(a[j], __ldg(reinterpret_cast<const float4*>(in + (size_t)(r + j) * cols + c)));
#pragma unroll
    for (int j = 0; j < SR_ACC - 1; ++j)
      if (r + j < r1) add4(a[j], __ldg(reinterpret_cast<const float4*>(in + (size_t)(r + j) * cols + c)));
  }
  const float4 s = sum_acc(a);
  if (chunks == 1) {
    if (ok) *reinterpret_cast<float4*>(out + (size_t)field * cols + c) = s;
    return;
  }
  if (ok) __stcg(reinterpret_cast<float4*>(scratch + ((size_t)field * chunks + chunk) * cols + c), s);
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  unsigned* counter = counters + (size_t)field * gridDim.x + slab;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == (unsigned)chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (ok) {
#pragma unroll
    for (int j = 0; j < SR_ACC; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* sc = scratch + (size_t)field * chunks * cols + c;
    int k = 0;
    for (; k + SR_ACC <= chunks; k += SR_ACC)
#pragma unroll
      for (int j = 0; j < SR_ACC; ++j) add4(a[j], __ldcg(reinterpret_cast<const float4*>(sc + (size_t)(k + j) * cols)));
#pragma unroll
    for (int j = 0; j < SR_ACC - 1; ++j)
      if (k + j < chunks) add4(a[j], __ldcg(reinterpret_cast<const float4*>(sc + (size_t)(k + j) * cols)));
    *reinterpret_cast<float4*>(out + (size_t)field * cols + c) = sum_acc(a);
  }
  if (threadIdx.x == 0) *counter = 0;
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no link
// against libcuda); null where the driver lacks it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The pre-encoded mode takes no warp or mask, and encoded widths within the
// padded ones.
bool enc_inputs_ok(const Inputs& in) {
  return in.warp == nullptr && in.mask_x == nullptr && in.mask_d == nullptr &&
         in.fx > 0 && in.fx <= XW && in.fd > 0 && in.fd <= EW;
}

}  // namespace

extern "C" {

// Every operand is a stack over the fields (see the header).
// ptrs: x, d, warp, mask_x, mask_d, net (forward layout), acts, out.
// ints: n (points per field), width, n_blocks, multires, multires_views, fields,
// pre-encoded (0 or 1; then in_ch and view_ch stand in for the multires).
int stx_fused_fwd(void** ptrs, const int* ints, void* stream) {
  Cursor cur{ptrs, 0};
  Inputs in; Net w; Acts act;
  parse_inputs(cur, ints, in);
  parse_net(cur, in.n_blocks, w);
  parse_acts(cur, in.n_blocks, act);
  float* out = cur.next<float>();
  const bool enc = ints[6] != 0;
  if (enc && !enc_inputs_ok(in)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(in.width);
  const auto kernel = in.fields > 1 ? (enc ? fwd_kernel<true, true> : fwd_kernel<true, false>)
                                     : (enc ? fwd_kernel<false, true> : fwd_kernel<false, false>);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((in.n + T - 1) / T, in.fields);
  if (grid.x > 0 && grid.y > 0) kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(in, w, act, out);
  return (int)cudaGetLastError();
}

// ptrs: x, d, warp, mask_x, mask_d, net (backward layout), acts, g,
//       d_in, (d0, d1) x n_blocks, d_out, d_f, d_v, xe, de, part, dx, dd.
// dx and dd are null except in the input-gradient mode. ints as stx_fused_fwd.
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
  gr.dx = cur.next<float>(); gr.dd = cur.next<float>();
  if ((gr.dx == nullptr) != (gr.dd == nullptr)) return (int)cudaErrorInvalidValue;
  const bool enc = ints[6] != 0;
  if (enc && !enc_inputs_ok(in)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(in.width);
  const auto kernel = in.fields > 1 ? (enc ? bwd_kernel<true, true> : bwd_kernel<true, false>)
                                     : (enc ? bwd_kernel<false, true> : bwd_kernel<false, false>);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((in.n + T - 1) / T, in.fields);
  if (grid.x > 0 && grid.y > 0) kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(in, w, act, g, gr);
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

// Padded width of the pre-encoded point features (lin_in's rows in that mode).
int stx_enc_in_width() { return XW; }

// The weight-gradient GEMM of one backward call: the table's (a WgTable) layers over
// `fields` fields -> wpart [fields, t.splits, t.wtotal] f32. Checks the
// table's shapes and bookkeeping and refuses one it does not take.
int stx_wgrad(const void* table, int fields, void* wpart, void* stream) {
  WgParams prm;  // the launch copies it
  prm.t = *reinterpret_cast<const WgTable*>(table);
  const WgTable* t = &prm.t;
  if (t->n_layers < 1 || t->n_layers > WG_MAXL || t->splits < 1 || t->n < 0 || fields < 1 ||
      t->per_split * t->splits < t->n)
    return (int)cudaErrorInvalidValue;
  long long wofs = 0;
  int tile0 = 0;
  for (int i = 0; i < t->n_layers; ++i) {
    const WgLayer& L = t->l[i];
    const int n_out = L.n_out;
    if ((n_out != 64 && n_out != 128 && n_out != 256) || L.k_in <= 0 || L.k_in % 16 != 0 ||
        L.wofs != wofs || L.tile0 != tile0 || L.x == nullptr || L.dy == nullptr)
      return (int)cudaErrorInvalidValue;
    wofs += (long long)L.k_in * n_out;
    tile0 += (L.k_in + WG_ROWS - 1) / WG_ROWS;
  }
  if (wofs != t->wtotal || tile0 != t->tiles) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  for (int i = 0; i < t->n_layers && t->n > 0; ++i) {  // without points, the CTAs only write zeros
    const WgLayer& L = t->l[i];
    const struct { CUtensorMap* map; const bf16* p; int cols; } ops[2] = {{&prm.x_map[i], L.x, L.k_in},
                                                                          {&prm.dy_map[i], L.dy, L.n_out}};
    for (const auto& op : ops) {
      const cuuint64_t dims[2] = {(cuuint64_t)op.cols, (cuuint64_t)fields * t->n};
      const cuuint64_t strides[1] = {(cuuint64_t)op.cols * sizeof(bf16)};
      const cuuint32_t box[2] = {64, WG_P}, one[2] = {1, 1};
      if (encode(op.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(op.p), dims, strides, box, one,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    }
  }
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wgrad_smem());
    attr = true;
  }
  const dim3 grid((unsigned)(t->tiles * t->splits), (unsigned)fields);
  wgrad_kernel<<<grid, NT, wgrad_smem(), (cudaStream_t)stream>>>(prm, reinterpret_cast<float*>(wpart));
  return (int)cudaGetLastError();
}

// in [fields, rows, cols] f32 (cols a multiple of 4, 16-byte aligned) -> out
// [fields, cols], the rows summed in `chunks` chunks. With chunks > 1,
// scratch holds [fields, chunks, cols] floats and counters fields *
// ceil(cols / SR_COLS) zeros (left zero again).
int stx_sum_rows(const void* in, int rows, long long cols, int fields, int chunks, void* scratch,
                 void* counters, void* out, void* stream) {
  if (cols % 4 != 0 || rows < 0 || chunks < 1 || (chunks > 1 && (scratch == nullptr || counters == nullptr)) ||
      reinterpret_cast<uintptr_t>(in) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int rows_per_chunk = rows > chunks ? (rows + chunks - 1) / chunks : 1;
  const dim3 grid((unsigned)((cols + SR_COLS - 1) / SR_COLS), chunks, fields);
  if (cols > 0 && fields > 0)
    sum_rows_kernel<<<grid, SR_T, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float*>(in), rows, cols, rows_per_chunk, reinterpret_cast<float*>(scratch),
        reinterpret_cast<unsigned*>(counters), reinterpret_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
