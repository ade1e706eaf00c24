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
// points) and the work between the GEMMs (PERF.md has the stamps).
//
// The epilogues run in registers on the wgmma accumulators: gemm_core hands
// its fragment (rows 16 (warp % 4) + lane / 4 and + 8, columns N (warp / 4)
// + 2 (lane % 4) + 8 j) to an epilogue functor, which adds the bias (staged
// once a CTA in shared memory by cp.async while the input is encoded),
// keeps the residual stream h (the backward's dh) in f32 at the thread's own
// fragment positions, rounds to bf16 and writes the next GEMM's A into the
// other of two operand tiles. An operand
// tile holds the pre-relu value, which is the saved activation; the relu is
// applied to the A registers after ldmatrix (relu(bf16(v)) = bf16(relu(v)),
// so the products are the TPU kernel's). No f32 tile goes through shared
// memory between GEMMs, and the residual update and the next block's first
// pass are one epilogue.
// - Barriers: only the two warps of a 16-row strip (w and w + 4) read its
//   rows of an operand tile and write them, so a layer needs one named
//   barrier of the strip's 64 threads, no block barrier: with two tiles, it
//   orders both the next GEMM's reads after the epilogue's writes and the
//   next-but-one epilogue's writes after the partner's reads.
//   __syncthreads stays where a pass crosses strips: the input encoding,
//   the encoding backward, the heads' final sum.
// - After the strip's barrier, 16 lanes copy its rows of the new tile to
//   the saved activation (forward) or the dY (backward), one bulk copy
//   (cp.async.bulk, shared -> global) a row that nobody waits for until the
//   tile is due to be rewritten two layers on.
// - The heads live in the epilogues: alpha = ho w_a in lin_out's, rgb in the
//   views layer's (three partial dot products), each summed over the quad
//   by shuffles and across the two warpgroups through a few floats of
//   shared memory.
// - The backward prefetches each layer's saved activation (hv_in, ho,
//   h_last, then n and h of each block) into a padded tile while the GEMM
//   runs: one bulk copy a row issued by the lanes of warp 0 on a "full"
//   mbarrier, the tile released by every warp on an "empty" one, so the
//   relu masks come from shared memory at the fragment's positions.
// - Column sums (the bias grads, dW_a, dW_r) come from the registers: the 8
//   lanes that share a column halve their values in three shuffle rounds,
//   then the four row strips are added in order through a [4][W] buffer
//   under one warpgroup barrier (two buffers in turn, so none needs a
//   second barrier before its reuse). The 12 pose sums are a shuffle tree
//   over a warp's points, then over the warps in order. Every order is
//   fixed, so the partials are the same run to run.
// - The encoding computes sin and cos of each (frequency, dim) with one
//   sincosf, which gives sinf's and cosf's bits; the backward writes its
//   encodings (the weight-gradient GEMM's X of lin_in and Wv_bot) straight
//   to global memory.
// Shared memory is laid out region by region at fwd_smem and bwd_smem.
//
// Design against what differs from the TPU:
// - Weights do not fit in shared memory (1.5 MB bf16 for 8x256). The point
//   tile's activations stay in shared memory (h in f32, two bf16 operand
//   tiles) and each layer streams its weights through shared memory in
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

// A [T][k] (bf16, shared), row stride lda; relu applied to it in registers
struct Seg { const bf16* a; int lda; int k; bool relu; };

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

// relu on a chunk's A registers (bf16 pairs): relu(bf16(v)) = bf16(relu(v)),
// so an operand tile may hold the pre-relu value that is also the saved
// activation.
__device__ __forceinline__ void relu_a(uint32_t (&a)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&a[h][q]);
      v = __hmax2(v, __float2bfloat162_rn(0.f));
      a[h][q] = *reinterpret_cast<uint32_t*>(&v);
    }
}

// The accumulators of the segments' A @ B, each warpgroup computing the
// columns [N wg, N wg + N) with the tile's 64 rows (warp w % 4 holds rows
// 16 (w % 4) .. + 15 of A and of D), handed to the epilogue in registers
// (epi.run<N>(acc); Frag says where each accumulator sits). Per chunk: A
// from ldmatrix (relu applied in registers for a segment that asks for it),
// the slot's "full" wait, two wgmma k16 steps, wait_group 0, then the slot's
// release. (Keeping one chunk's wgmma in flight while the next is issued
// measured slower: the second A register set pushed the backward to 255
// registers and spills.) No block barrier: the caller orders the tiles.
template <int N, class Epi>
__device__ void gemm_core(const Seg* segs, int nseg, Feed& f, const Epi epi) {
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
      if (sg.relu) relu_a(a);
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
  epi.template run<N>(acc);
}

// gemm_core for an output width nout of 2 NB or 2 NS (the two widths a
// layer may have: W in {256, 128}, W / 2 in {128, 64}).
template <int NB, int NS, class Epi>
__device__ __forceinline__ void tile_gemm(const Seg* segs, int nseg, int nout, Feed& f, const Epi epi) {
  if (nout == 2 * NB)
    gemm_core<NB>(segs, nseg, f, epi);
  else
    gemm_core<NS>(segs, nseg, f, epi);
}

// ---------------------------------------------------------------------------
// Barriers, the fragment and the copies of the epilogues.
// ---------------------------------------------------------------------------

// Named barrier id (1 to 15; 0 is __syncthreads) over n threads.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// The two warps that share row strip wr of an operand tile (wr and wr + 4):
// the only readers of its rows in a GEMM and their only writers in an
// epilogue.
__device__ __forceinline__ void strip_sync(int wr) { bar_sync(1 + wr, 64); }

// The four warps of warpgroup wg, which hold every row of its columns.
__device__ __forceinline__ void wg_sync(int wg) { bar_sync(5 + wg, 128); }

// Where gemm_core<N>'s accumulators sit: acc[4 j + 2 h + e] is row r0 + 8 h,
// column c0 + 8 j + e, for j < N / 8.
struct Frag {
  int r0, c0;
  __device__ __forceinline__ explicit Frag(int N) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    r0 = 16 * (warp & 3) + (lane >> 2);
    c0 = (warp >> 2) * N + 2 * (lane & 3);
  }
};

__device__ __forceinline__ void st_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// After an epilogue wrote strip wr of `tile`: the strip's barrier, then its
// rows (t < nrow) are copied to rows row0 + t of dst [n, cols], the saved
// activation or dY. Rows of 512 bytes or more (W = 256) go by bulk copy,
// one a row issued by lanes 0-15 of the strip's warpgroup-0 warp (shared
// -> global; every thread first fences its writes for the async proxy),
// and nobody waits for them: a tile is rewritten two layers after it is
// copied, so before the barrier of every save_strip those lanes wait
// until their earlier copies have read their rows, and the writers of the
// next-but-one epilogue pass that barrier first. Narrower rows (W = 128, or
// W / 2 wide) go by 16-byte stores of the strip's two warps, which measured
// faster there than a bulk copy a 256-byte row (PERF.md).
__device__ __forceinline__ void save_strip(const bf16* tile, int ld, int cols, bf16* dst, long row0, int nrow) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wr = warp & 3;
  const bool issuer = warp < 4 && lane < 16;
  if (issuer) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  if (cols < 256) {
    strip_sync(wr);
    const int sh = __ffs(cols / 8) - 1;  // cols / 8 is a power of 2
    for (int i = (warp >> 2) * 32 + lane; i < 16 << sh; i += 64) {
      const int t = 16 * wr + (i >> sh), c = (i & ((1 << sh) - 1)) * 8;
      if (t < nrow)
        *reinterpret_cast<uint4*>(dst + (row0 + t) * cols + c) = *reinterpret_cast<const uint4*>(tile + t * ld + c);
    }
    return;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  strip_sync(wr);
  const int t = 16 * wr + lane;
  if (issuer && t < nrow) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 ::"l"(dst + (row0 + t) * cols), "r"(smem_u32(tile + t * ld)), "r"(cols * 2)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// At a kernel's end: the issuing lanes wait for their copies, so that
// none reads the shared memory of a finished CTA.
__device__ __forceinline__ void save_drain() {
  if (threadIdx.x < 128 && (threadIdx.x & 31) < 16) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Column sums over the tile's 64 rows of values held in gemm_core<N>'s
// fragment layout (N = 4 M): v[2 j + e] is the sum of this thread's two rows
// at column c0 + 8 j + e. The 8 lanes that share those columns halve the
// values each keeps in three shuffle rounds (xor 16, 8, 4); each warp then
// writes its row strip's sums to cb[strip][column], and after a warpgroup
// barrier thread i of the warpgroup adds the four strips in order and writes
// out[column * stride]. The order is fixed, so the sums are the same run to
// run. Consecutive calls alternate between two buffers cb (ColBufs): a
// call's barrier orders the previous call's reads of the other buffer
// before the next call writes it.
template <int HALF>
__device__ __forceinline__ void halve_xor(float* v, int mask) {
  const bool up = (threadIdx.x & mask) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF], keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

template <int M>
__device__ __forceinline__ void colsum_frag(float* v, int c0, float* cb, int ldcb, float* out, int stride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  halve_xor<M / 2>(v, 16);
  halve_xor<M / 4>(v, 8);
  halve_xor<M / 8>(v, 4);
#pragma unroll
  for (int i = 0; i < M / 8; ++i) {  // lane l keeps the values (l / 4) M / 8 + i
    const int k = (lane >> 2) * (M / 8) + i;
    cb[(warp & 3) * ldcb + c0 + 8 * (k >> 1) + (k & 1)] = v[i];
  }
  wg_sync(wg);
  for (int c = threadIdx.x & 127; c < 4 * M; c += 128) {
    const int col = wg * 4 * M + c;
    out[col * stride] = ((cb[col] + cb[ldcb + col]) + cb[2 * ldcb + col]) + cb[3 * ldcb + col];
  }
}

// The two column-sum buffers [4][ld] and whose turn it is (the same in
// every thread: every thread makes the same calls).
struct ColBufs {
  float* b[2];
  int ld, n;
  __device__ __forceinline__ float* next() { return b[(n++) & 1]; }
};

// ---------------------------------------------------------------------------
// The forward's epilogues. Each adds the layer's bias (staged once a CTA in
// shared memory) to the accumulators in f32 and writes the bf16 result at
// the fragment's positions of `dst`, the other operand tile (row stride ld):
// the next GEMM's A (with relu in its registers where the layer has one) and
// the saved activation that save_strip copies out.
// ---------------------------------------------------------------------------

// The residual stream: h = acc + b (first) or h + (acc + b), kept in f32 at
// the thread's own fragment positions of hs ([N / 8][NT] float4: column
// pair j's rows r0 and r0 + 8 at j NT + tid).
struct EpiResidual {
  const float* b;
  float4* hs;
  bf16* dst;
  int ld;
  bool first;
  template <int N>
  __device__ __forceinline__ void run(float* acc) const {
    const Frag f(N);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = f.c0 + 8 * j;
      const float2 bj = *reinterpret_cast<const float2*>(b + c);
      float4 v = make_float4(acc[4 * j] + bj.x, acc[4 * j + 1] + bj.y, acc[4 * j + 2] + bj.x,
                             acc[4 * j + 3] + bj.y);
      float4* p = hs + j * NT + threadIdx.x;
      if (!first) {
        const float4 o = *p;
        v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
      }
      *p = v;
      st_bf2(dst + f.r0 * ld + c, v.x, v.y);
      st_bf2(dst + (f.r0 + 8) * ld + c, v.z, v.w);
    }
  }
};

// The quad's sums of a head's row partials (s[h][q]: row r0 + 8 h, output
// q) to hp [2][T][HEADS] at this warpgroup.
template <int HEADS>
__device__ __forceinline__ void head_rows(float (*s)[HEADS], int r0, float* hp) {
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < HEADS; ++q) {
      float x = s[h][q];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if ((lane & 3) == 0) hp[(wg * T + r0 + 8 * h) * HEADS + q] = x;
    }
}

// v = acc + b into dst. With a head (HEADS outputs, weights w [cols][HEADS]
// in f32): the thread's partial dot products of the rounded values (after
// relu for the rgb head, HEADS = 3) with w, summed over the quad that shares
// a row (xor 1, 2) and written per warpgroup and row to hp [2][T][HEADS].
template <int HEADS>
struct EpiBias {
  const float* b;
  bf16* dst;
  int ld;
  const float* w;
  float* hp;
  template <int N>
  __device__ __forceinline__ void run(float* acc) const {
    const Frag f(N);
    float s[2][HEADS > 0 ? HEADS : 1] = {};
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = f.c0 + 8 * j;
      const float2 bj = *reinterpret_cast<const float2*>(b + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 r = __floats2bfloat162_rn(acc[4 * j + 2 * h] + bj.x, acc[4 * j + 2 * h + 1] + bj.y);
        *reinterpret_cast<__nv_bfloat162*>(dst + (f.r0 + 8 * h) * ld + c) = r;
        if constexpr (HEADS > 0) {
          float2 v = __bfloat1622float2(r);
          if constexpr (HEADS == 3) v = make_float2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
#pragma unroll
          for (int q = 0; q < HEADS; ++q) s[h][q] += v.x * w[c * HEADS + q] + v.y * w[(c + 1) * HEADS + q];
        }
      }
    }
    if constexpr (HEADS > 0) head_rows<HEADS>(s, f.r0, hp);
  }
};

// acc -> c [T][ld] f32: the narrow results (dd_emb, dx_emb) that the
// encoding backward reads across row strips.
struct EpiF32 {
  float* c;
  int ld;
  template <int N>
  __device__ __forceinline__ void run(float* acc) const {
    const Frag f(N);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(c + (f.r0 + 8 * h) * ld + f.c0 + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
};

// ---------------------------------------------------------------------------
// The backward's prefetch of saved activations: one tile [T][LDA] in shared
// memory, filled from the sequence of loads that a kernel fixes at its start
// (ActPipe: hv_in, ho, h_last, then n and h of each block from the last),
// and an mbarrier "full" (one arrival and the bytes a load). Load 0 is
// issued at the start; load n + 1 by the last of the 8 warps to release
// load n (a counter in shared memory), as soon as every warp has read the
// tile, with no warp waiting for the others. A load copies the batch's
// rows, one bulk copy a row issued by the lanes of the issuing warp (the
// tile keeps its padded rows, so the epilogues' reads of the fragment's
// positions are free of bank conflicts). Rows past the batch are not
// written: the epilogues select on them or zero them, and their grads are
// zero.
// ---------------------------------------------------------------------------

constexpr int MAXLOADS = 3 + 2 * MAXB;

struct ActPipe {
  const bf16* src[MAXLOADS];  // load n's saved activation [n, cols]
  int cols[MAXLOADS];
  unsigned count, released;   // loads in the sequence; warps that released the current one
  unsigned pad[5];            // to 256 bytes
};

// Appends src [n, cols] to the sequence (thread 0, at the kernel's start).
__device__ __forceinline__ void act_add(ActPipe* p, const bf16* src, int cols) {
  p->src[p->count] = src;
  p->cols[p->count++] = cols;
}

// One warp: starts load n of the sequence into dst (row stride ld).
__device__ __forceinline__ void act_issue(const ActPipe* p, unsigned n, long row0, int nrow, bf16* dst, int ld,
                                          unsigned long long* full) {
  const int lane = threadIdx.x & 31, cols = p->cols[n];
  const bf16* src = p->src[n];
  const uint32_t bar = smem_u32(full);
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(nrow * cols * 2)
                 : "memory");
  __syncwarp();
  for (int t = lane; t < nrow; t += 32)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst + t * ld)), "l"(src + (row0 + t) * cols), "r"(cols * 2), "r"(bar)
        : "memory");
}

__device__ __forceinline__ void act_wait(unsigned long long* full, unsigned n) { mbar_wait(full, n & 1); }

// Every warp, after its last read of load n: the last to arrive resets the
// count and starts load n + 1 into the same tile.
__device__ __forceinline__ void act_release(ActPipe* p, unsigned n, long row0, int nrow, bf16* dst, int ld,
                                            unsigned long long* full) {
  __syncwarp();
  unsigned last = 0;
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();
    last = atomicAdd(&p->released, 1u) == NT / 32 - 1;
  }
  if (__shfl_sync(0xffffffffu, last, 0)) {
    if ((threadIdx.x & 31) == 0) p->released = 0;
    __threadfence_block();
    if (n + 1 < p->count) act_issue(p, n + 1, row0, nrow, dst, ld, full);
  }
}

// ---------------------------------------------------------------------------
// The backward's epilogues. v comes from the accumulators; bf16(v), or of
// the updated dh, goes to dst (row stride ld): the next GEMM's A and the
// layer's dY, which save_strip copies out; the column sums go to the CTA's
// partials.
//   DY:     v = acc (dfeat)                               sums of v -> out
//   DHO:    v = acc + dalpha w_a (dho)                     sums of v -> out,
//           and of ho dalpha (dW_a) -> out2
//   MASKED: v = acc (act > 0): the dn of a block, or with dh the residual
//           dh = (first ? 0 : dh) + v                      sums of v (dh) -> out
// act is the prefetched tile (load `load` of pipe): the relu mask, or ho for
// DHO.
// The masked layers share one instance (the residual chosen at run time),
// so that the GEMM and epilogue code of the blocks' layers stays one.
// dh holds the thread's 4 values of each column pair j (rows r0, r0 + 8)
// as one float4 at j NT + tid.
// ---------------------------------------------------------------------------

enum { BW_DY, BW_DHO, BW_MASKED };

template <int MODE>
struct EpiBwd {
  bf16* dst;
  int ld;
  bf16* act;                 // the prefetch's tile (row stride ld)
  unsigned long long* full;  // its barrier
  ActPipe* pipe;
  unsigned load;
  long row0;
  float4* dh;
  bool first;
  const float* gs;  // DHO: the cotangent [T][4]
  const bf16* wa;   // DHO: w_a [W]
  int nrow;
  float* cb;   // the column-sum buffer of the first sums
  float* cb2;  // DHO: of the second
  int ldcb;
  float* out;
  float* out2;
  template <int N>
  __device__ __forceinline__ void run(float* acc) const {
    const Frag f(N);
    float s[N / 4], s2[MODE == BW_DHO ? N / 4 : 1];
    float da[2] = {0.f, 0.f};
    bool ok[2] = {true, true};
    if constexpr (MODE != BW_DY) {
      act_wait(full, load);
    }
    if constexpr (MODE == BW_DHO) {
      for (int h = 0; h < 2; ++h) {
        da[h] = bfr(gs[(f.r0 + 8 * h) * 4]);
        ok[h] = f.r0 + 8 * h < nrow;
      }
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = f.c0 + 8 * j;
      float v[4];  // rows r0, r0 + 8 at columns c, c + 1
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = acc[4 * j + i];
      if constexpr (MODE == BW_MASKED) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 a = ld_bf2(act + (f.r0 + 8 * h) * ld + c);
          v[2 * h] = a.x > 0.f ? v[2 * h] : 0.f;
          v[2 * h + 1] = a.y > 0.f ? v[2 * h + 1] : 0.f;
        }
        if (dh) {
          float4* p = dh + j * NT + threadIdx.x;
          if (!first) {
            const float4 o = *p;
            v[0] = o.x + v[0];
            v[1] = o.y + v[1];
            v[2] = o.z + v[2];
            v[3] = o.w + v[3];
          }
          *p = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      if constexpr (MODE == BW_DHO) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 wc = ld_bf2(wa + c);
          v[2 * h] += da[h] * wc.x;
          v[2 * h + 1] += da[h] * wc.y;
          const float2 ho = ok[h] ? ld_bf2(act + (f.r0 + 8 * h) * ld + c) : make_float2(0.f, 0.f);
          s2[2 * j] = (h ? s2[2 * j] : 0.f) + ho.x * da[h];
          s2[2 * j + 1] = (h ? s2[2 * j + 1] : 0.f) + ho.y * da[h];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) st_bf2(dst + (f.r0 + 8 * h) * ld + c, v[2 * h], v[2 * h + 1]);
      s[2 * j] = v[0] + v[2];
      s[2 * j + 1] = v[1] + v[3];
    }
    if constexpr (MODE != BW_DY) {
      act_release(pipe, load, row0, nrow, act, ld, full);
    }
    colsum_frag<N / 4>(s, f.c0, cb, ldcb, out, 1);
    if constexpr (MODE == BW_DHO) {
      colsum_frag<N / 4>(s2, f.c0, cb2, ldcb, out2, 1);
    }
  }
};

// The backward's rgb head and its sums, in gemm_core<N>'s fragment layout
// (N = W2 / 2): dhv_in = (drgb W_r^T) (hv_in > 0) into dst (bf16: the A of
// the next two GEMMs and the views layer's dY), b_v = its column sums, dW_r
// = relu(hv_in)^T drgb (three column sums), and b_a, b_r = the cotangent's
// sums (warps 0 and 1, a shuffle tree into red [2][4]). hv is the
// prefetched hv_in tile (load 0 of pipe); rows past the batch count as zero.
template <int N>
__device__ __forceinline__ void bwd_rgb_head(bf16* hv, int ld, unsigned long long* full, ActPipe* pipe, long row0,
                                             const float* gs, const bf16* wr, int nrow, bf16* dst,
                                             ColBufs& cbs, float* red, float* part, const POff& o) {
  const Frag f(N);
  if (threadIdx.x < 64) {  // the cotangent's column sums, point threadIdx.x
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = gs[threadIdx.x * 4 + q];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] += __shfl_xor_sync(0xffffffffu, v[q], m);
    if ((threadIdx.x & 31) == 0) {
      for (int q = 0; q < 4; ++q) red[96 + (threadIdx.x >> 5) * 4 + q] = v[q];
    }
  }
  float g[2][3];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = f.r0 + 8 * h;
    ok[h] = r < nrow;
#pragma unroll
    for (int q = 0; q < 3; ++q) g[h][q] = bfr(gs[r * 4 + 1 + q]);
  }
  float sb[N / 4], sr[3][N / 4];
  act_wait(full, 0);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = f.c0 + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.r0 + 8 * h;
      const float2 a = ok[h] ? ld_bf2(hv + r * ld + c) : make_float2(0.f, 0.f);
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bf16* w3 = wr + (c + e) * 3;
        const float w[3] = {bf(w3[0]), bf(w3[1]), bf(w3[2])};
        const float x = e ? a.y : a.x;
        const float dhv = g[h][0] * w[0] + g[h][1] * w[1] + g[h][2] * w[2];
        v[e] = x > 0.f ? dhv : 0.f;
        const float rx = fmaxf(x, 0.f);
        sb[2 * j + e] = (h ? sb[2 * j + e] : 0.f) + v[e];
#pragma unroll
        for (int q = 0; q < 3; ++q) sr[q][2 * j + e] = (h ? sr[q][2 * j + e] : 0.f) + rx * g[h][q];
      }
      st_bf2(dst + r * ld + c, v[0], v[1]);
    }
  }
  act_release(pipe, 0, row0, nrow, hv, ld, full);
  colsum_frag<N / 4>(sb, f.c0, cbs.next(), cbs.ld, part + o.b_v, 1);
#pragma unroll
  for (int q = 0; q < 3; ++q) colsum_frag<N / 4>(sr[q], f.c0, cbs.next(), cbs.ld, part + o.w_r + q, 3);
  if (threadIdx.x < 4)  // after the warpgroup barriers above (threads 0-3 and warps 0, 1 are warpgroup 0)
    part[threadIdx.x == 0 ? o.b_a : o.b_r + threadIdx.x - 1] = red[96 + threadIdx.x] + red[100 + threadIdx.x];
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

// The forward's staged vectors, in floats from the start of their region:
// the biases b_in, (b0, b1) of each block, b_out, b_f, b_v, then the heads'
// weights w_a [W] and w_r [W2][3] in f32, b_a and b_r.
struct FwdVecs { int b_in, b_blk, b_out, b_f, b_v, w_a, w_r, b_a, b_r, total; };

__host__ __device__ inline FwdVecs fwd_vecs(int W, int nb) {
  FwdVecs o; int k = 0;
  o.b_in = k; k += W;
  o.b_blk = k; k += 2 * W * nb;
  o.b_out = k; k += W;
  o.b_f = k; k += W;
  o.b_v = k; k += W / 2;
  o.w_a = k; k += W;
  o.w_r = k; k += 3 * (W / 2);
  o.b_a = k; k += 1;
  o.b_r = k; k += 3;
  o.total = k;
  return o;
}

constexpr int RED = 8 * 12 + 2 * 4;  // the backward's reductions: pose terms a warp, the cotangent's sums

// Shared memory of the kernels at width W, region by region (the kernels
// carve it in this order; every region is a multiple of 16 bytes, so the
// Ring at the end is aligned). Forward: h [W/16][NT] float4 (f32, each
// thread's fragment positions), two bf16 operand tiles [T][W+8], the
// direction encoding [T][LDE], the weight ring, the warped points [T][6],
// the staged vectors (fwd_vecs for MAXB blocks), the heads' partials
// [2][T][1 + 3]. Backward: dh [W/16][NT] float4 (the narrow f32 results
// [T][<= XW + 8] in its place before and after dh lives), two operand tiles,
// the prefetched activation tile [T][W+8], the weight ring, the warped x,
// d [T][6], the cotangent [T][4], the world-frame d grads [T][3], two
// column-sum buffers [2][4][W], w_a [W] and w_r [W2][3] in bf16, the
// reductions [RED], the prefetch's mbarrier (two words) and its loads
// (ActPipe).
size_t fwd_smem(int W) {
  return sizeof(float) * T * W + sizeof(bf16) * (2 * T * (W + 8) + T * LDE + NSLOT * KC * W) +
         sizeof(float) * (T * 6 + fwd_vecs(W, MAXB).total + 2 * T * 4) + sizeof(Ring);
}

size_t bwd_smem(int W) {
  return sizeof(float) * T * W + sizeof(bf16) * (3 * T * (W + 8) + NSLOT * KC * W) +
         sizeof(float) * (T * (6 + 4 + 3) + 8 * W) + sizeof(bf16) * (W + 3 * (W / 2)) +
         sizeof(float) * RED + 2 * sizeof(unsigned long long) + sizeof(ActPipe) + sizeof(Ring);
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

// A tile's encoding of v (three values a point at v + 6 t) into dst [T][ld]
// bf16, columns [0, EW) in the ops.encoding layout (column 3 + 6 freq + 3
// phase + dim is sin (phase 0) or cos (phase 1) of v[dim] 2^freq; 0 past
// 3 + 6F), each times mask[column] when a mask is given. Four threads a
// point (point tid / 4): thread q of the four writes identity column q < 3,
// computes one sincosf for each (freq, dim) pair q, q + 4, ... < 3F and
// writes both its columns, then the zero columns 3 + 6F + q, + 4, ... Rows
// t < nrow only (dst may be a global row stride).
static_assert(NT == 4 * T, "encode_tile and pe_bwd take four threads a point");

__device__ __forceinline__ void encode_tile(const float* v, int F, const float* mask, bf16* dst, int ld,
                                            int nrow) {
  const int t = threadIdx.x >> 2, q = threadIdx.x & 3;
  if (t >= nrow) return;
  const float* p = v + t * 6;
  bf16* row = dst + t * ld;
  if (q < 3) row[q] = __float2bfloat16(mask ? p[q] * mask[q] : p[q]);
  for (int k = q; k < 3 * F; k += 4) {
    const int freq = k / 3, dim = k - 3 * freq, js = 3 + 6 * freq + dim;
    float sn, cn;
    sincosf(ldexpf(p[dim], freq), &sn, &cn);
    if (mask) {
      sn *= mask[js];
      cn *= mask[js + 3];
    }
    row[js] = __float2bfloat16(sn);
    row[js + 3] = __float2bfloat16(cn);
  }
  for (int j = 3 + 6 * F + q; j < EW; j += 4) row[j] = __float2bfloat16(0.f);
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

__device__ __forceinline__ void stage_f32(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) dst[i] = src[i];
}

// Starts copying n floats (n a multiple of 4) from src to dst in shared
// memory, 16 bytes a thread and step (cp.async), so that the loads of
// several vectors are in flight at once; stage_wait completes them. A
// source that is not 16-byte aligned is copied by stage_f32 instead.
__device__ __forceinline__ void stage_async(float* dst, const float* src, int n) {
  if (reinterpret_cast<uintptr_t>(src) & 15) {
    stage_f32(dst, src, n);
    return;
  }
  for (int i = 4 * threadIdx.x; i < n; i += 4 * NT)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst + i)), "l"(src + i)
                 : "memory");
}

__device__ __forceinline__ void stage_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The same for n bf16 values (n a multiple of 8), kept as bf16.
__device__ __forceinline__ void stage_async_bf16(bf16* dst, const bf16* src, int n) {
  if (reinterpret_cast<uintptr_t>(src) & 15) {
    for (int i = threadIdx.x; i < n; i += NT) dst[i] = src[i];
    return;
  }
  for (int i = 8 * threadIdx.x; i < n; i += 8 * NT)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst + i)), "l"(src + i)
                 : "memory");
}

__device__ __forceinline__ void stage_bf16(float* dst, const bf16* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) dst[i] = bf(src[i]);
}

template <class X>
__device__ __forceinline__ void swap_ptr(X*& a, X*& b) {
  X* t = a;
  a = b;
  b = t;
}

// STACKED = false is the one-field launch: its field index is the constant 0,
// and it reads the kernel parameters themselves, not field copies of them.
// (With copies, ptxas allocated the one-field kernel 152 registers against
// 168 and recomputed 64-bit weight addresses in every GEMM segment: 3% of
// the forward.) ENC selects the pre-encoded input mode (see the header).
//
// Each layer: the GEMM on the operand tile `cur`, its epilogue writing the
// next operand into `nxt`, then save_strip (the strip's barrier and the
// saved activation's copy); the tiles swap. One barrier a layer orders both
// hazards of a strip: its rows of nxt are complete before the next GEMM
// reads them, and the partner warp has finished reading a tile before it is
// written again two layers on.
template <bool STACKED, bool ENC>
__global__ void __launch_bounds__(NT, 1) fwd_kernel(Inputs all_in, Net net, Acts all_act, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = all_in.width, W2 = W / 2, LDA = W + 8, k = STACKED ? blockIdx.y : 0;
  const Inputs in_k = field_inputs<ENC>(all_in, k);
  const Net w_k = field_net<ENC>(net, k, W);
  const Acts act_k = field_acts(all_act, k, all_in.n, W);
  const Inputs& in = STACKED ? in_k : all_in;
  const Net& w = STACKED ? w_k : net;
  const Acts& act = STACKED ? act_k : all_act;
  const FieldOff f = field_off(k, in.n, W);
  const int nb = in.n_blocks;
  const FwdVecs vo = fwd_vecs(W, nb);
  out += (size_t)k * in.n * 4;
  float4* hs = reinterpret_cast<float4*>(smem);          // [W/16][NT] residual stream h (f32)
  bf16* as0 = reinterpret_cast<bf16*>(hs + T * W / 4);   // [T][LDA] bf16 operand tiles, two
  bf16* as1 = as0 + T * LDA;
  bf16* es = as1 + T * LDA;                              // [T][LDE] direction encoding
  bf16* bs = es + T * LDE;                               // [NSLOT][KC * W] weight ring
  float* ps = reinterpret_cast<float*>(bs + NSLOT * KC * W);  // [T][6] warped x, d
  float* vec = ps + T * 6;                               // fwd_vecs
  float* hp = vec + fwd_vecs(W, MAXB).total;             // [2][T] alpha, [2][T][3] rgb partials
  Ring* ring = reinterpret_cast<Ring*>(hp + 2 * T * 4);
  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * T;
  const int nrow = (int)min((long)T, (long)in.n - row0);
  if (tid == 0) {  // the stream, in the order of the GEMMs below
    ring_init(ring, bs, KC * W);
    ring_add(ring, w.w_in, in_rows<ENC>(), W);
    for (int b = 0; b < nb; ++b) {
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
  stage_async(vec + vo.b_in, w.b_in, W);  // completed before the barrier after the encoding
  for (int b = 0; b < nb; ++b) {
    stage_async(vec + vo.b_blk + 2 * W * b, net.b0[b] + f.b, W);
    stage_async(vec + vo.b_blk + 2 * W * b + W, net.b1[b] + f.b, W);
  }
  stage_async(vec + vo.b_out, w.b_out, W);
  stage_async(vec + vo.b_f, w.b_f, W);
  stage_async(vec + vo.b_v, w.b_v, W2);

  if constexpr (ENC) {
    stage_encoded(in.x, in.fx, XW, in.n, row0, as0, LDA, false);
    stage_encoded(in.d, in.fd, EW, in.n, row0, es, LDE, false);
  } else {
    load_points(in.x, in.d, in.warp, in.n, row0, nullptr, ps);
    __syncthreads();
    encode_tile(ps, in.fx, in.mask_x, as0, LDA, T);
    encode_tile(ps + 3, in.fd, in.mask_d, es, LDE, T);
  }
  stage_bf16(vec + vo.w_a, w.w_a, W);
  stage_bf16(vec + vo.w_r, w.w_r, 3 * W2);
  stage_f32(vec + vo.b_a, w.b_a, 1);
  stage_f32(vec + vo.b_r, w.b_r, 3);
  stage_wait();
  __syncthreads();  // the encodings and the staged vectors, read across row strips

  bf16 *cur = as0, *nxt = as1;
  {
    const Seg s = {cur, LDA, in_rows<ENC>(), false};
    tile_gemm<128, 64>(&s, 1, W, feed, EpiResidual{vec + vo.b_in, hs, nxt, LDA, true});
    save_strip(nxt, LDA, W, nb > 0 ? all_act.h[0] + f.act : act.h_last, row0, nrow);
    swap_ptr(cur, nxt);
  }
  for (int b = 0; b < nb; ++b) {
    const Seg s0 = {cur, LDA, W, true};  // n = relu(h) W0 + b0
    tile_gemm<128, 64>(&s0, 1, W, feed, EpiBias<0>{vec + vo.b_blk + 2 * W * b, nxt, LDA, nullptr, nullptr});
    save_strip(nxt, LDA, W, all_act.nn[b] + f.act, row0, nrow);
    swap_ptr(cur, nxt);
    const Seg s1 = {cur, LDA, W, true};  // h = h + (relu(n) W1 + b1)
    tile_gemm<128, 64>(&s1, 1, W, feed, EpiResidual{vec + vo.b_blk + 2 * W * b + W, hs, nxt, LDA, false});
    save_strip(nxt, LDA, W, b + 1 < nb ? all_act.h[b + 1] + f.act : act.h_last, row0, nrow);
    swap_ptr(cur, nxt);
  }
  {
    const Seg s = {cur, LDA, W, true};  // ho = relu(h) W_out + b_out; alpha = ho w_a
    tile_gemm<128, 64>(&s, 1, W, feed, EpiBias<1>{vec + vo.b_out, nxt, LDA, vec + vo.w_a, hp});
    save_strip(nxt, LDA, W, act.ho, row0, nrow);
    swap_ptr(cur, nxt);
  }
  {
    const Seg s = {cur, LDA, W, false};  // feat = ho W_f + b_f
    tile_gemm<128, 64>(&s, 1, W, feed, EpiBias<0>{vec + vo.b_f, nxt, LDA, nullptr, nullptr});
    save_strip(nxt, LDA, W, act.feat, row0, nrow);
    swap_ptr(cur, nxt);
  }
  {
    const Seg s[2] = {{cur, LDA, W, false}, {es, LDE, EW, false}};  // hv_in; rgb = relu(hv_in) w_r
    tile_gemm<64, 32>(s, 2, W2, feed, EpiBias<3>{vec + vo.b_v, nxt, LDA, vec + vo.w_r, hp + 2 * T});
    save_strip(nxt, LDA, W2, act.hv_in, row0, nrow);
  }
  __syncthreads();  // the heads' partials of both warpgroups
  if (tid < nrow) {  // out = (alpha, rgb) + their biases
    const float* al = hp;
    const float* rg = hp + 2 * T;
    *reinterpret_cast<float4*>(out + (row0 + tid) * 4) =
        make_float4((al[tid] + al[T + tid]) + vec[vo.b_a], (rg[tid * 3] + rg[(T + tid) * 3]) + vec[vo.b_r],
                    (rg[tid * 3 + 1] + rg[(T + tid) * 3 + 1]) + vec[vo.b_r + 1],
                    (rg[tid * 3 + 2] + rg[(T + tid) * 3 + 2]) + vec[vo.b_r + 2]);
  }
  save_drain();
  if (tid == 0) ring_drain(ring, feed.g);
}

// As fwd_kernel, walking the chain backward: each GEMM's epilogue applies
// the relu mask from the saved activation prefetched into shared memory
// while the GEMM ran (ActPipe), writes the layer's dY to the
// other operand tile and sums its columns from registers.
template <bool STACKED, bool ENC>
__global__ void __launch_bounds__(NT, 1) bwd_kernel(Inputs all_in, Net net, Acts all_act, const float* g,
                                                     Grads all_gr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = all_in.width, W2 = W / 2, LDA = W + 8, nb = all_in.n_blocks;
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
  // [W/16][NT] float4: the residual grad dh (f32); before and after dh, the narrow results
  float* dhs = reinterpret_cast<float*>(smem);
  bf16* as0 = reinterpret_cast<bf16*>(dhs + T * W);      // [T][LDA] bf16 operand tiles, two
  bf16* as1 = as0 + T * LDA;
  bf16* acts = as1 + T * LDA;                            // [T][LDA] the prefetched saved activation
  bf16* bs = acts + T * LDA;                             // [NSLOT][KC * W] weight ring
  float* ps = reinterpret_cast<float*>(bs + NSLOT * KC * W);  // [T][6] warped x, d
  float* gs = ps + T * 6;                                // [T][4] cotangent
  float* pd = gs + T * 4;                                // [T][3] world-frame d grads
  ColBufs cbs = {{pd + T * 3, pd + T * 3 + 4 * W}, W, 0};  // [2][4][W] column-sum strips
  bf16* wa = reinterpret_cast<bf16*>(pd + T * 3 + 8 * W);  // [W] w_a
  bf16* wr = wa + W;                                     // [W2][3] w_r
  float* red = reinterpret_cast<float*>(wr + 3 * W2);    // [RED] reductions
  unsigned long long* abar = reinterpret_cast<unsigned long long*>(red + RED);  // the prefetch's "full" (2 words)
  ActPipe* pipe = reinterpret_cast<ActPipe*>(abar + 2);  // its loads
  Ring* ring = reinterpret_cast<Ring*>(pipe + 1);
  const int tid = threadIdx.x, warp = tid >> 5;
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
    pipe->count = pipe->released = 0;  // the prefetch's loads, in the order of the epilogues below
    act_add(pipe, act.hv_in, W2);
    act_add(pipe, act.ho, W);
    act_add(pipe, act.h_last, W);
    for (int b = nb - 1; b >= 0; --b) {
      act_add(pipe, all_act.nn[b] + f.act, W);
      act_add(pipe, all_act.h[b] + f.act, W);
    }
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(abar)) : "memory");
    ring_start(ring);
  }
  Feed feed = {ring, 0};
  if (warp == 0) {
    __syncwarp();
    act_issue(pipe, 0, row0, nrow, acts, LDA, abar);
  }
  unsigned loads = 1;  // the next load an epilogue reads (the same in every thread); hv_in is load 0

  if constexpr (!ENC) load_points(in.x, in.d, in.warp, in.n, row0, nullptr, ps);
  if (tid < T)
    for (int j = 0; j < 4; ++j) gs[tid * 4 + j] = tid < nrow ? g[(row0 + tid) * 4 + j] : 0.f;
  stage_async_bf16(wa, w.w_a, W);
  stage_async_bf16(wr, w.w_r, 3 * W2);
  stage_wait();
  __syncthreads();
  // encodings: the X of lin_in and Wv_bot
  if constexpr (ENC) {
    stage_encoded(in.x, in.fx, XW, in.n, row0, gr.xe + row0 * XW, XW, true);
    stage_encoded(in.d, in.fd, EW, in.n, row0, gr.de + row0 * EW, EW, true);
  } else {
    encode_tile(ps, in.fx, in.mask_x, gr.xe + row0 * EW, EW, nrow);
    encode_tile(ps + 3, in.fd, in.mask_d, gr.de + row0 * EW, EW, nrow);
  }

  // rgb head: dhv = drgb @ W_r^T, dhv_in = dhv * (hv_in > 0), into as0
  if (W2 == 128)
    bwd_rgb_head<64>(acts, LDA, abar, pipe, row0, gs, wr, nrow, as0, cbs, red, part, o);
  else
    bwd_rgb_head<32>(acts, LDA, abar, pipe, row0, gs, wr, nrow, as0, cbs, red, part, o);
  save_strip(as0, LDA, W2, gr.d_v, row0, nrow);

  if (warped || in_grads) {  // dd_emb = dhv_in @ Wv_bot^T -> mask -> encoding backward -> M^T
    const Seg s = {as0, LDA, W2, false};
    gemm_core<EW / 2>(&s, 1, feed, EpiF32{dhs, EW + 8});
    __syncthreads();
    if constexpr (ENC) {  // dd_emb is the input grad
      for (int i = tid; i < T * in.fd; i += NT) {
        const int t = i / in.fd, c = i - t * in.fd;
        if (t < nrow) gr.dd[(row0 + t) * in.fd + c] = dhs[t * (EW + 8) + c];
      }
    } else {
      float dw[3];
      pe_bwd(dhs, EW + 8, ps + 3, in.mask_d, in.fd, dw);
      if ((tid & 3) == 0) {
        const int t = tid >> 2;
        unwarp3(in.warp, dw, pd + t * 3);
        if (in_grads && t < nrow)
          for (int c = 0; c < 3; ++c) gr.dd[(row0 + t) * 3 + c] = pd[t * 3 + c];
      }
    }
    __syncthreads();  // the narrow result is read; dh takes its place
  }

  // Each layer's epilogue, as EpiBwd's members: its dY tile, the prefetched
  // tile, its load, the residual dh, the column-sum buffers and outputs.
  {  // dfeat = dhv_in @ Wv_top^T
    const Seg s = {as0, LDA, W2, false};
    const EpiBwd<BW_DY> e = {as1, LDA, nullptr, abar, pipe, 0, row0, nullptr, false, gs, wa, nrow,
                             cbs.next(), nullptr, W, part + o.b_f, nullptr};
    tile_gemm<128, 64>(&s, 1, W, feed, e);
    save_strip(as1, LDA, W, gr.d_f, row0, nrow);
  }
  {  // dho = dfeat @ W_f^T + dalpha W_a^T; dW_a = ho^T dalpha
    const Seg s = {as1, LDA, W, false};
    float* cb = cbs.next();
    const EpiBwd<BW_DHO> e = {as0, LDA, acts, abar, pipe, loads++, row0, nullptr, false, gs, wa, nrow,
                              cb, cbs.next(), W, part + o.b_out, part + o.w_a};
    tile_gemm<128, 64>(&s, 1, W, feed, e);
    save_strip(as0, LDA, W, gr.d_out, row0, nrow);
  }
  float4* dh = reinterpret_cast<float4*>(dhs);
  bf16 *cur = as0, *nxt = as1;
  {  // dr = dho @ W_out^T, dh = dr * (h_last > 0): the dY of the last fc1 (or of lin_in)
    const Seg s = {cur, LDA, W, false};
    const EpiBwd<BW_MASKED> e = {nxt, LDA, acts, abar, pipe, loads++, row0, dh, true, gs, wa, nrow,
                                 cbs.next(), nullptr, W,
                                 part + (nb > 0 ? o.b_blocks + 2 * W * (nb - 1) + W : o.b_in), nullptr};
    tile_gemm<128, 64>(&s, 1, W, feed, e);
    save_strip(nxt, LDA, W, nb > 0 ? all_gr.d1[nb - 1] + f.act : gr.d_in, row0, nrow);
    swap_ptr(cur, nxt);
  }
  for (int b = nb - 1; b >= 0; --b) {
    {  // dn = (dh @ W1^T) * (n > 0)
      const Seg s = {cur, LDA, W, false};
      const EpiBwd<BW_MASKED> e = {nxt, LDA, acts, abar, pipe, loads++, row0, nullptr, false, gs, wa, nrow,
                                   cbs.next(), nullptr, W, part + o.b_blocks + 2 * W * b, nullptr};
      tile_gemm<128, 64>(&s, 1, W, feed, e);
      save_strip(nxt, LDA, W, all_gr.d0[b] + f.act, row0, nrow);
      swap_ptr(cur, nxt);
    }
    {  // dh += (dn @ W0^T) * (h_in > 0): the dY of the previous fc1 (or of lin_in)
      const Seg s = {cur, LDA, W, false};
      const EpiBwd<BW_MASKED> e = {nxt, LDA, acts, abar, pipe, loads++, row0, dh, false, gs, wa, nrow,
                                   cbs.next(), nullptr, W,
                                   part + (b > 0 ? o.b_blocks + 2 * W * (b - 1) + W : o.b_in), nullptr};
      tile_gemm<128, 64>(&s, 1, W, feed, e);
      save_strip(nxt, LDA, W, b > 0 ? all_gr.d1[b - 1] + f.act : gr.d_in, row0, nrow);
      swap_ptr(cur, nxt);
    }
  }

  // dx_emb = dh @ W_in^T -> mask -> encoding backward -> M^T -> dx, or the pose sums
  const bool pose_sums = warped && !in_grads;
  if (warped || in_grads) {
    constexpr int LDN = in_rows<ENC>() + 8;
    __syncthreads();  // dh is read; the narrow result takes its place
    const Seg s = {cur, LDA, W, false};
    gemm_core<in_rows<ENC>() / 2>(&s, 1, feed, EpiF32{dhs, LDN});
    __syncthreads();
    if constexpr (ENC) {  // dx_emb is the input grad
      for (int i = tid; i < T * in.fx; i += NT) {
        const int t = i / in.fx, c = i - t * in.fx;
        if (t < nrow) gr.dx[(row0 + t) * in.fx + c] = dhs[t * LDN + c];
      }
    } else {
      float dw[3];
      pe_bwd(dhs, LDN, ps, in.mask_x, in.fx, dw);
      const int t = tid >> 2;
      float dx[3];
      unwarp3(in.warp, dw, dx);
      if (in_grads) {
        if ((tid & 3) == 0 && t < nrow)
          for (int c = 0; c < 3; ++c) gr.dx[(row0 + t) * 3 + c] = dx[c];
      } else {  // point t's 12 pose terms (each lane of its quad), summed over the warp's 8 points
        float raw[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // world x, d
        if (t < nrow)
          for (int j = 0; j < 3; ++j) {
            raw[j] = in.x[(row0 + t) * 3 + j];
            raw[3 + j] = in.d[(row0 + t) * 3 + j];
          }
        float pv[12];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j) pv[3 * i + j] = dx[i] * raw[j] + pd[t * 3 + i] * raw[3 + j];
          pv[9 + i] = dx[i];
        }
#pragma unroll
        for (int m = 4; m < 32; m <<= 1)
#pragma unroll
          for (int i = 0; i < 12; ++i) pv[i] += __shfl_xor_sync(0xffffffffu, pv[i], m);
        if ((tid & 31) == 0) {
          for (int i = 0; i < 12; ++i) red[warp * 12 + i] = pv[i];
        }
      }
    }
    __syncthreads();
  }
  if (tid < 12) {  // the warps' pose sums, in warp order
    float s = 0.f;
    if (pose_sums)
      for (int i = 0; i < NT / 32; ++i) s += red[i * 12 + tid];
    part[o.pose + tid] = s;
  }
  save_drain();
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

// Raises a kernel's dynamic shared memory limit to smem bytes on the
// current device, once per kernel, device and size (allowed[device]: the
// largest size allowed so far). Returns the call's error, cleared from the
// runtime's last error so that the launch's check reads the launch alone.
constexpr int MAX_DEVICES = 64;

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t* allowed) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev < 0 || dev >= MAX_DEVICES)) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && smem > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) allowed[dev] = smem;
  }
  if (e != cudaSuccess) cudaGetLastError();
  return e;
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
  static size_t allowed[4][MAX_DEVICES];
  const cudaError_t e = allow_smem(kernel, smem, allowed[2 * (in.fields > 1) + enc]);
  if (e != cudaSuccess) return (int)e;
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
  static size_t allowed[4][MAX_DEVICES];
  const cudaError_t e = allow_smem(kernel, smem, allowed[2 * (in.fields > 1) + enc]);
  if (e != cudaSuccess) return (int)e;
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
  static size_t allowed[MAX_DEVICES];
  const cudaError_t e = allow_smem(wgrad_kernel, wgrad_smem(), allowed);
  if (e != cudaSuccess) return (int)e;
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
