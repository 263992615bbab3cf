// Key-masked multi-head attention core for the acoustic FFT blocks (Hopper).
//
// Replaces the TPU kernel visual_onoma_to_wave_tpu/ops/pallas_attention.py::
// flash_mha (body _mha_kernel). Per batch item b and head h:
//
//     ctx = softmax(Q K^T / sqrt(dk) + keymask(-inf)) V
//
// with logits and softmax in fp32, fully-masked query rows exactly 0, padded
// query rows computed like any other, and Q/K/V/ctx in the packed
// (B, T, H*dk) layout of the projection outputs (head h occupies features
// [h*dk, (h+1)*dk)), so no transposes are needed.
//
// Two kernels: fp32 (one pass, 3xTF32) and bf16 (two passes, the TPU
// kernel's rounding point). Both stream keys in 64-key tiles: the TPU kernel
// keeps the whole (T, T) score tile in VMEM, and at the serving decoder's
// T = 1000 that does not fit in a block's 227 KB of shared memory. Both skip
// dead key tiles: each warp scans the item's (T,) uint8 mask with ballots for
// the next 64-key tile that holds a valid key (the scan gives that tile's
// 64-bit validity mask too), so the key loop visits only live tiles, for any
// mask. A tile whose keys are all padding would change nothing, so skipping
// it is exact. An item with no valid key writes exact zeros. The tensor
// cores' own fp32 accumulation truncates, so in both no tensor-core sum runs
// over more than 64 of K (as in csrc/convnext.cu, where one chain over K
// 1536 broke the bound): S is two fresh sums at dk 128, and each key tile's
// P V is a fresh sum per 64 columns of dk, added to the fp32 O registers on
// the CUDA cores.
//
// The fp32 kernel (mha_fwd_kernel): one online-softmax pass with both
// products on the tensor cores (wgmma):
//   * one CTA of 256 threads per (item, head, 128-query block): two
//     warpgroups, each owning 64 query rows (wgmma's M), share every staged
//     key tile;
//   * S = Q K^T per tile: wgmma m64n64, A = Q from registers (loaded from a
//     fp32 copy of the CTA's Q rows in shared memory per k-step), B = the K
//     tile in shared memory. Q and K rows are dk-contiguous, which is the
//     K-major layout tf32 wgmma requires; the K tile is stored as 8-row x
//     16-byte core matrices;
//   * O += P V: the reduction axis is keys and V arrives (keys, dk), which is
//     MN-major, but tf32 wgmma takes only K-major operands, so V is stored
//     transposed (dk rows, keys along K) as it is staged. P is the A operand
//     straight from the S accumulator registers: the accumulator gives a
//     thread keys 2q and 2q + 1 of each 8-key group (q = lane % 4) where
//     tf32's A fragment wants k = q and q + 4, so V's keys are staged in
//     that permuted order inside each group of 8 (k q <-> key 2q, k q + 4 <->
//     key 2q + 1) and P needs no shuffle;
//   * fp32 operands run as 3xTF32: x = hi + lo with hi = cvt.rna.tf32(x) and
//     lo the exact fp32 remainder, three wgmma per k-step (hi*lo, lo*hi,
//     hi*hi). One TF32 product lands 3.4e-4 off the fp32 result at T 1000,
//     dk 128 (a CPU emulation of this kernel's tiles, in
//     tests/test_torch_attention_tc.py), past the 1e-5 bound; three land
//     4.8e-7. K and V are split into hi and lo planes as they are staged, Q
//     and P in registers;
//   * each tile's fresh P V sum joins O with the online-softmax rescale,
//     O = alpha O + fresh, and O is divided by the running sum at the end;
//   * staging (below, "staging"): the next live tile is copied by cp.async
//     while the warpgroups run this tile's softmax and P V, then split and
//     transposed into its planes between two barriers. Two other forms were
//     slower on the H100: the warpgroups loading the next tile into
//     registers ahead of time (those registers pushed fp32 into spills), and
//     a third, producer warpgroup staging through registers while the two
//     multiplied (its loads, a few registers' worth at a time, could not
//     keep up).
//
// What bounds it. Per (item, head) the two products cost 4*T*Tk*dk FLOPs
// over the Tk valid keys (0.5 GFLOP at T = Tk = 1000, dk = 128), three times
// that on the tensor cores in fp32 (3xTF32), against 4*T*dk*4 bytes of
// unique Q/K/V/ctx traffic: far above the card's ridge, so the tensor cores'
// TF32 rate bounds it. The (T, T) scores never touch device memory. On the
// H100 at the served decoder's shape it runs at about a third of the 3xTF32
// bound: the warpgroups run S, softmax and P V in step and stage between
// barriers, so the tensor cores idle through each softmax, copy wait and
// pass.
//
// Budgets (dk 128): shared memory 66 KB for the fp32 Q rows of the CTA
// (padded rows, conflict-free fragment loads), 64 KB for the K tile's hi
// and lo planes, 64 KB for V^T's and 32 KB for the raw V copy: 226 KB of the
// 227, one CTA per SM, one stage (no room for a second). Per thread: O 64
// registers, S / P 32, a fresh sum 32, fragments; holding Q's fragments (128
// more) does not fit, hence Q in shared memory.
//
// The bf16 kernel (mha_bf16_kernel) computes what the TPU kernel computes in
// bf16 (pallas_attention.py:73-83), per row:
//
//     s   = (Q K^T) * 1/sqrt(dk)               fp32 sums of exact products
//     m   = max s, l = sum exp(s - m)          over the valid keys, fp32
//     P   = bf16_rn(exp(s - m) * (1/l))        l == 0 -> exact zeros
//     ctx = bf16_rn(P V)                       fp32 sums, one rounding
//
// The probabilities are normalised before they are rounded, so each row's m
// and l must be known before any P V product: two passes over the live key
// tiles of each 128-query block. Pass 1 reads K only and keeps m and l
// online (l rescaled as m grows: it differs from the TPU kernel's
// sum(exp(s - m_final)) by roundoff only). Pass 2 reads K and V, recomputes
// S (bit-identical to pass 1's), forms P in registers (the bf16 A fragment
// of wgmma matches the S accumulator as it is, so P needs no shuffle) and
// adds each tile's fresh P V sums to O; the output is O rounded once, with
// no division. S is computed twice because the block's score tile does not
// fit on chip (128 rows x 1000 keys x 4 B = 512 KB). expf, not __expf, and
// the reciprocal once per row, as the TPU kernel multiplies by 1/s.
//
// Design, for the H100:
//   * one CTA of 384 threads per (item, head, 128-query block): two consumer
//     warpgroups of 64 query rows and a producer warpgroup, of which one
//     warp works; `setmaxnreg` moves the producer's registers to the
//     consumers;
//   * every copy is a TMA box of 64 dk values (128 bytes) by 64 or 128 rows,
//     written with the 128-byte swizzle that wgmma reads: Q once, then a ring
//     of STAGES stages (a K and a V tile each), one full and one empty
//     mbarrier a stage. The producer walks the live tiles twice (pass 1
//     copies K, pass 2 K and V); each consumer warp releases a stage when
//     its wgmma are done with it. (16-byte copies into the unswizzled
//     core-matrix layout, by TMA boxes or by a producer warp of cp.async,
//     read half of each 32-byte L2 sector and cost far more);
//   * Q's A fragments are held in registers (32 a thread at dk 128), so S
//     reads only K from shared memory; K is K-major for S, and V, (keys, dk),
//     is read MN-major by P V's wgmma through its transpose bit, so nothing
//     is transposed;
//   * the two warpgroups take turns to issue their S products (two named
//     barriers), so that one's softmax runs under the other's products;
//   * P V runs one 64-column slab of dk at a time: O (64 registers), the
//     fresh sum (32), Q's fragments (32) and P (16) fit in the 168 registers
//     a thread, where two slabs at once spilled.
//
// What bounds it. The function's work is the same 4*T*Tk*dk FLOPs, now at
// the bf16 tensor rate, against 4*T*dk*2 bytes: near the card's ridge, and
// the tensor cores' rate bounds it (the recomputed S, another 2*T*Tk*dk, is
// the design's cost, not the function's). On the H100 at the served
// decoder's shape it is bound by neither: the CUDA cores' work (two expf a
// score, against one in a one-pass kernel), the L2 traffic of reading K twice
// and V once for every 128-query block, and the products take their turns
// more than they overlap. Budgets (dk 128): Q 32 KB and 5 stages of 32 KB,
// 192 KB of the 227, one CTA per SM.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 128;  // queries per CTA: two warpgroups of 64 (wgmma's M)
constexpr int BLOCK_N = 64;   // keys per tile
constexpr int THREADS = 256;  // two warpgroups
constexpr int SLAB = 64;      // dk columns per tensor-core sum

template <typename T>
struct Operand;
template <>
struct Operand<float> {           // 3xTF32: hi and lo planes, wgmma k 8
  static constexpr int E = 4, KSTEP = 8, SPLIT = 2, PAD = 4, COL = 1;
};

// Shared memory: Q (BLOCK_M rows of fp32, LDQ floats apart), then the K
// tile's planes, then V^T's, then V's raw copy (row-major, as copied). A
// plane holds BLOCK_N x DK values of T as core matrices: K element (key n,
// d) at byte (d / E * BLOCK_N + n) * 16 + d % E * sizeof(T); V^T element
// (d, key slot s) at (s / E * DK + d) * 16 + s % E * sizeof(T). fp32 keeps
// the lo plane PLANE bytes after the hi plane.
template <typename T, int DK>
struct Geom {
  using Op = Operand<T>;
  static constexpr int LDQ = DK + Op::PAD;
  static constexpr int PLANE = BLOCK_N * DK * (int)sizeof(T);
  static constexpr int K_OFF = BLOCK_M * LDQ * 4;
  static constexpr int V_OFF = K_OFF + Op::SPLIT * PLANE;
  static constexpr int RAW_OFF = V_OFF + Op::SPLIT * PLANE;
  static constexpr int SMEM = RAW_OFF + PLANE;
  static constexpr int LBO_K = BLOCK_N * 16;   // K: next 16-byte column of dk
  static constexpr int LBO_V = DK * 16;        // V^T: next 16-byte column of keys
  static constexpr int CHUNKS = BLOCK_N * DK / Op::E / THREADS;  // 16-byte chunks a thread
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(K_OFF % 128 == 0 && PLANE % 128 == 0, "plane alignment");
  static_assert(DK % SLAB == 0 && (DK / Op::E) % 4 == 0, "dk");
};

// ---- shared-memory fences, wgmma -------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// this thread's st.shared become visible to the tensor cores' (async proxy)
// reads; the barrier that follows makes them visible to every warpgroup
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across a wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand without swizzle: 8-row
// x 16-byte core matrices of 128 contiguous bytes, `lbo` bytes apart along K
// and 128 bytes apart along N.
__device__ __forceinline__ uint64_t desc_of(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// wgmma m64n64k8 (tf32), A from registers, B from shared memory (K-major),
// fp32 accumulators d[32]: d = A B^T + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc,
                                           int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
               "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
               "%24, %25, %26, %27, %28, %29, %30, %31"
               "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                 "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                 "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                 "+f"(d[30]), "+f"(d[31])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
// ---- A fragments --------------------------------------------------------------
//
// A thread's share of one k-step of A: rows r and r + 8 (r = 16 * its warp in
// the warpgroup + lane / 4); tf32 columns q and q + 4 (q = lane % 4).
struct FragTF32 {
  uint32_t hi[4], lo[4];
};
template <typename T>
struct FragOf {
  using type = FragTF32;
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(const float (&v)[4], FragTF32& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32_rna(v[i]);
    f.lo[i] = __float_as_uint(v[i] - __uint_as_float(f.hi[i]));  // exact
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f.hi[i]), "+r"(f.lo[i])::"memory");
}

// Q: `p` points at row r, column q of the fp32 Q rows
__device__ __forceinline__ void q_frag(const float* p, int ld, FragTF32& f) {
  const float v[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
  split(v, f);
}
// P: k-step kk of the probabilities held as the S accumulator, p[4j + e]
// (row r) and p[4j + 2 + e] (row r + 8) at keys 8j + 2q + e. k = q is key
// 8kk + 2q and k = q + 4 is key 8kk + 2q + 1 (V^T is staged in that order).
__device__ __forceinline__ void p_frag(const float (&p)[32], int kk, FragTF32& f) {
  const float v[4] = {p[4 * kk], p[4 * kk + 2], p[4 * kk + 1], p[4 * kk + 3]};
  split(v, f);
}
// One k-step: 3xTF32 (the lo plane `lo` bytes after the hi plane).
__device__ __forceinline__ void mma(float* d, const FragTF32& a, uint32_t b, uint32_t lbo,
                                    uint32_t lo, int scale_d) {
  wgmma_tf32(d, a.hi, desc_of(b + lo, lbo), scale_d);  // hi * lo
  wgmma_tf32(d, a.lo, desc_of(b, lbo), 1);             // lo * hi
  wgmma_tf32(d, a.hi, desc_of(b, lbo), 1);             // hi * hi
}

// d (64 x 64) = a fresh tensor-core sum over 64 of K: A from the Q rows in
// shared memory (`q`) or from the P registers, B at shared address `b`, one
// wgmma group per k-step, at most two in flight (A's registers stay in use
// until their group is done).
template <typename T, int LD>
__device__ __forceinline__ void mma_q(float (&d)[32], const float* q, uint32_t b, uint32_t lbo,
                                      uint32_t lo) {
  constexpr int KSTEP = Operand<T>::KSTEP;
  reg_fence(d);
#pragma unroll
  for (int kk = 0; kk < SLAB / KSTEP; ++kk) {
    typename FragOf<T>::type f;
    q_frag(q + kk * KSTEP, LD, f);
    wg_fence();
    mma(d, f, b + kk * 2 * lbo, lbo, lo, kk > 0);
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  reg_fence(d);
}

template <typename T>
__device__ __forceinline__ void mma_p(float (&d)[32], const float (&p)[32], uint32_t b,
                                      uint32_t lbo, uint32_t lo) {
  constexpr int KSTEP = Operand<T>::KSTEP;
  reg_fence(d);
#pragma unroll
  for (int kk = 0; kk < BLOCK_N / KSTEP; ++kk) {
    typename FragOf<T>::type f;
    p_frag(p, kk, f);
    wg_fence();
    mma(d, f, b + kk * 2 * lbo, lbo, lo, kk > 0);
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  reg_fence(d);
}

// ---- epilogue and rounding -----------------------------------------------------

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ---- staging ------------------------------------------------------------------------
//
// A key tile reaches its planes in two steps. First cp.async copies it from
// device memory, 16 bytes at a time and without registers, while the
// warpgroups still work on the tile before: K straight into its hi plane (its
// core matrices are 16-byte runs of a key row), V row by row into a raw
// buffer. Then, between two barriers, a pass splits fp32 K in place into hi
// and lo and transposes V from the raw buffer into its planes (split for
// fp32). Rows past seq are zero-filled by the copy.

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K chunk e is key n, dk columns [c E, c E + E): lanes 0-7 on 8 keys of one
// chunk column (128 contiguous bytes of the plane), lanes 8-31 on the next
// three columns (64 contiguous bytes of a key row)
__device__ __forceinline__ void k_chunk(int e, int& n, int& c) {
  n = (e & 7) + 8 * ((e >> 5) & 7);
  c = ((e >> 3) & 3) + 4 * (e >> 8);
}

// issue the copies of key tile [k0, k0 + BLOCK_N): K into its (hi) plane, V
// into the raw buffer; one cp.async group
template <typename T, int DK>
__device__ __forceinline__ void copy_tile(const T* k, const T* v, size_t base, size_t stride,
                                          int k0, int seq, uint8_t* k_planes, uint8_t* v_raw) {
  using G = Geom<T, DK>;
  constexpr int E = Operand<T>::E;
#pragma unroll
  for (int i = 0; i < G::CHUNKS; ++i) {
    const int e = i * THREADS + threadIdx.x;
    int n, c;
    k_chunk(e, n, c);
    const bool in = k0 + n < seq;
    const size_t src = base + (size_t)(in ? k0 + n : 0) * stride + c * E;
    cp_async16(k_planes + (c * BLOCK_N + n) * 16, k + src, in);
    // V: chunk e is key e / (DK / E), columns (e % (DK / E)) E.., row-major
    const int nv = e / (DK / E), cv = e % (DK / E);
    const bool in_v = k0 + nv < seq;
    cp_async16(v_raw + (nv * DK + cv * E) * sizeof(T),
               v + base + (size_t)(in_v ? k0 + nv : 0) * stride + cv * E, in_v);
  }
  cp_async_commit();
}

// fp32 x as hi = tf32(x) at `hi` and lo = x - hi one plane further
__device__ __forceinline__ void split_store(uint8_t* hi, int plane, const float (&x)[4]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = tf32_rna(x[i]);
    l[i] = __float_as_uint(x[i] - __uint_as_float(h[i]));  // exact
  }
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(hi + plane) = make_uint4(l[0], l[1], l[2], l[3]);
}

// the pass over a copied tile. V^T chunk j of dk column d holds E key slots:
// fp32 slots 4j..4j+3 of group j / 2 are keys 8 (j / 2) + 2m + j % 2 (the
// order p_frag reads P in), bf16 chunk j keys 8j..8j+7; lanes on consecutive
// d read consecutive words of a raw row and write consecutive 16 bytes
template <typename T, int DK>
__device__ __forceinline__ void split_tile(uint8_t* k_planes, uint8_t* v_planes,
                                           const uint8_t* v_raw) {
  using G = Geom<T, DK>;
  const T* raw = reinterpret_cast<const T*>(v_raw);
#pragma unroll
  for (int i = 0; i < G::CHUNKS; ++i) {
    const int e = i * THREADS + threadIdx.x;
    if constexpr (sizeof(T) == 4) {
      int n, c;
      k_chunk(e, n, c);
      uint8_t* hi = k_planes + (c * BLOCK_N + n) * 16;
      const float4 x = *reinterpret_cast<const float4*>(hi);
      split_store(hi, G::PLANE, {x.x, x.y, x.z, x.w});
    }
    const int d = e % DK, j = e / DK;
    uint8_t* dst = v_planes + (j * DK + d) * 16;
    if constexpr (sizeof(T) == 4) {
      float x[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) x[m] = raw[(8 * (j >> 1) + 2 * m + (j & 1)) * DK + d];
      split_store(dst, G::PLANE, x);
    }
  }
}

// Q rows [q0, q0 + BLOCK_M) as fp32 (zero past seq), row r at qs + r * LDQ
template <typename T, int DK>
__device__ __forceinline__ void stage_q(const T* q, size_t base, size_t stride, int q0, int seq,
                                        float* qs) {
  using G = Geom<T, DK>;
  constexpr int E = Operand<T>::E, PER_ROW = DK / E;
  for (int e = threadIdx.x; e < BLOCK_M * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW, c = e % PER_ROW, t = q0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (t < seq)
      raw = __ldg(reinterpret_cast<const uint4*>(q + base + (size_t)t * stride + c * E));
    float* dst = qs + r * G::LDQ + c * E;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<uint4*>(dst) = raw;
    }
  }
}

// The first key tile at or after `from` that holds a valid key (n_tiles if
// none), and its validity bits (bit i: key tile * BLOCK_N + i is valid). Every
// warp computes the same answer from its own ballots.
__device__ __forceinline__ int next_live(const uint8_t* mask, int seq, int from, int n_tiles,
                                         uint64_t& bits) {
  const int lane = threadIdx.x & 31;
  for (int kt = from; kt < n_tiles; ++kt) {
    const int t = kt * BLOCK_N + lane;
    const bool a = t < seq && (mask == nullptr || __ldg(mask + t) == 0);
    const bool b = t + 32 < seq && (mask == nullptr || __ldg(mask + t + 32) == 0);
    const uint32_t lo = __ballot_sync(0xffffffffu, a), hi = __ballot_sync(0xffffffffu, b);
    if (lo | hi) {
      bits = (uint64_t)hi << 32 | lo;
      return kt;
    }
  }
  bits = 0;
  return n_tiles;
}

// ---- the kernel -------------------------------------------------------------------

template <typename T, int DK>
__global__ void __launch_bounds__(THREADS, 1)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const uint8_t* __restrict__ mask, T* __restrict__ out, int seq, int n_head,
               float scale) {
  using G = Geom<T, DK>;
  constexpr int SLABS = DK / SLAB;
  extern __shared__ __align__(128) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);
  uint8_t* k_planes = smem + G::K_OFF;
  uint8_t* v_planes = smem + G::V_OFF;
  uint8_t* v_raw = smem + G::RAW_OFF;
  const uint32_t kb = smem_addr(k_planes), vb = smem_addr(v_planes);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wg = warp >> 2;
  const int r = 16 * (warp & 3) + (lane >> 2);  // accumulator rows r, r + 8
  const int qd = lane & 3;
  const int q0 = blockIdx.x * BLOCK_M, h = blockIdx.y, b = blockIdx.z;
  const size_t stride = (size_t)n_head * DK;
  const size_t base = (size_t)b * seq * stride + (size_t)h * DK;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * seq;
  const int n_tiles = (seq + BLOCK_N - 1) / BLOCK_N;
  // a warpgroup whose 64 rows all lie past seq stages tiles but computes nothing
  const bool rows_live = q0 + 64 * wg < seq;
  const float* q_frag_row =
      qs + (64 * wg + r) * G::LDQ + Operand<T>::COL * qd;  // + column of the k-step

  float o[DK / 2];  // SLABS m64n64 accumulators: o[32 s + 4j + e] row r (+8 for e + 2)
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  uint64_t bits;
  int cur = next_live(mask_b, seq, 0, n_tiles, bits);
  if (cur < n_tiles) {
    copy_tile<T, DK>(k, v, base, stride, cur * BLOCK_N, seq, k_planes, v_raw);
    stage_q<T, DK>(q, base, stride, q0, seq, qs);
    cp_async_wait_all();
    __syncthreads();
    split_tile<T, DK>(k_planes, v_planes, v_raw);
    fence_proxy_async();
    __syncthreads();
  }

  while (cur < n_tiles) {
    uint64_t next_bits;
    const int next = next_live(mask_b, seq, cur + 1, n_tiles, next_bits);
    const bool more = next < n_tiles;

    // S = Q K^T, a fresh sum per 64 of dk
    float s[32];
    if (rows_live) {
      mma_q<T, G::LDQ>(s, q_frag_row, kb, G::LBO_K, G::PLANE);
#pragma unroll
      for (int sl = 1; sl < SLABS; ++sl) {
        float t[32];
        mma_q<T, G::LDQ>(t, q_frag_row + sl * SLAB,
                         kb + sl * (SLAB / Operand<T>::E) * G::LBO_K, G::LBO_K, G::PLANE);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] += t[i];
      }
    }
    __syncthreads();  // both warpgroups are done reading the K tile
    // the next tile's copies run under the softmax and P V
    if (more) copy_tile<T, DK>(k, v, base, stride, next * BLOCK_N, seq, k_planes, v_raw);

    if (rows_live) {
      // this thread's 16 keys of the tile: bit 2j + e is key 8j + 2qd + e
      uint32_t ok = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) ok |= (uint32_t)((bits >> (8 * j + 2 * qd)) & 3u) << (2 * j);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = (ok >> (2 * j + e)) & 1u;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float& x = s[4 * j + 2 * rr + e];
            x = valid ? x * scale : -INFINITY;
            mx[rr] = fmaxf(mx[rr], x);
          }
        }
      float alpha[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        // the 4 threads sharing a row are lanes differing in bits 0..1
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        // a live tile has a valid key for every row, so the max is finite;
        // the first tile's alpha is exp(-inf) = 0 (o and l are 0 then)
        const float m_new = fmaxf(m_run[rr], mx[rr]);
        alpha[rr] = expf(m_run[rr] - m_new);
        m_run[rr] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * rr + e];
            const float p = expf(x - m_run[rr]);  // masked: exp(-inf) = 0
            sum[rr] += p;
            x = p;
          }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
        sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
        l_run[rr] = l_run[rr] * alpha[rr] + sum[rr];
      }

      // O = alpha O + P V, a fresh sum per 64 columns of dk
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl) {
        float f[32];
        mma_p<T>(f, s, vb + sl * SLAB * 16, G::LBO_V, G::PLANE);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float& acc = o[32 * sl + i];
          acc = fmaf(acc, alpha[(i >> 1) & 1], f[i]);
        }
      }
    }
    if (more) cp_async_wait_all();
    __syncthreads();  // the V planes are read; the next tile's copies have landed
    if (more) {
      split_tile<T, DK>(k_planes, v_planes, v_raw);
      fence_proxy_async();
    }
    __syncthreads();  // the next tile's planes are in place
    cur = next;
    bits = next_bits;
  }

  // fully-masked item: l == 0 -> exactly 0 (the reference's nan_to_num)
  const float inv[2] = {l_run[0] > 0.f ? 1.f / l_run[0] : 0.f,
                        l_run[1] > 0.f ? 1.f / l_run[1] : 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int t = q0 + 64 * wg + r + 8 * rr;
    if (t >= seq) continue;
    T* row = out + base + (size_t)t * stride;
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 32 * sl + 4 * j + 2 * rr;
        store2(row + SLAB * sl + 8 * j + 2 * qd, o[i] * inv[rr], o[i + 1] * inv[rr]);
      }
  }
}

template <typename T, int DK>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
                   int batch, int seq, int n_head, float scale, cudaStream_t stream) {
  constexpr int smem = Geom<T, DK>::SMEM;
  // above 48 KB of dynamic shared memory needs an opt-in (set per device;
  // cheap enough to repeat on every launch)
  cudaError_t err = cudaFuncSetAttribute(mha_fwd_kernel<T, DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((seq + BLOCK_M - 1) / BLOCK_M, n_head, batch);
  mha_fwd_kernel<T, DK><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), seq, n_head, scale);
  return cudaGetLastError();
}

// ---- the bf16 kernel: two passes -------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int STAGES = 5;                       // the ring's stages
constexpr int CONSUMERS = 256;                  // two warpgroups of 64 query rows
constexpr int BF16_THREADS = CONSUMERS + 128;   // and a producer warpgroup (one warp copies)
// registers a thread after the producer gives its own up: 128 x 24 + 256 x
// 240 = 64,512 of the SM's 65,536 (the launch gives each of the 384 threads 168)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// Shared memory: Q (BLOCK_M rows), then STAGES stages of a K tile and a V
// tile (BLOCK_N keys each), then the mbarriers (full and empty a stage, and
// Q's). A plane of ROWS rows is DK / 64 regions, one a 64-column slab of dk:
// ROWS rows of 128 bytes with the 128-byte swizzle (16-byte chunk c of row n
// at n * 128 + ((c ^ n % 8) * 16)), as one TMA box writes it and as wgmma
// reads it, in 1024-byte atoms of 8 rows.
template <int DK>
struct Ring {
  static constexpr int TILE = BLOCK_N * DK * 2;   // a K or a V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int Q_BYTES = BLOCK_M * DK * 2;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8;
  static constexpr uint32_t REGION = BLOCK_N * 128;  // one 64-column slab of a tile
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(DK % SLAB == 0 && TILE % 1024 == 0 && Q_BYTES % 1024 == 0, "dk");
};

// Shared-memory matrix descriptor, 128-byte swizzle: 8-row groups `sbo`
// bytes apart (along N for a K-major operand, along K for an MN-major one);
// `lbo` the next 64-column slab of an MN-major operand.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// wgmma m64n64k16 bf16, A from registers, B from shared memory, K-major
// (TRANS_B 0) or MN-major (1), fp32 accumulators d[32]:
// d = A B + (scale_d ? d : 0)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
               "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
               "%24, %25, %26, %27, %28, %29, %30, %31"
               "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                 "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                 "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                 "+f"(d[30]), "+f"(d[31])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
                 "n"(TRANS_B));
}

// mbarriers (shared memory, CTA scope): arrive releases, wait acquires
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared.b64 state, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// one arrival that also expects `bytes` of TMA copies to complete the phase
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared.b64 state, [%0], %1;\n}\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed; called by whole warps,
// which leave it converged (the wgmma that follow are .aligned)
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(smem_addr(bar)), "r"(parity)
                 : "memory");
  __syncwarp();
}

// TMA: the box of `map` at (feature x, row y, item z) -- 64 features (128
// bytes) by ROWS rows, swizzled -- to shared address `dst`, counted on `bar`
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int x, int y, int z,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar))
      : "memory");
}
// rows [r0, r0 + ROWS) of head h of item b into a plane, one box a region
template <int ROWS, int DK>
__device__ __forceinline__ void tma_rows(uint32_t plane, const CUtensorMap* map, int h, int r0,
                                         int b, uint64_t* bar) {
#pragma unroll
  for (int c = 0; c < DK / SLAB; ++c)
    tma_box(plane + c * ROWS * 128, map, h * DK + SLAB * c, r0, b, bar);
}

template <int N>
__device__ __forceinline__ void set_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void set_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Ping-pong: consumer warpgroup w issues its S products only in its turn
// (named barrier 1 + w, both warpgroups' 256 threads) and then hands the turn
// to the other, so that one's softmax runs under the other's products
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(CONSUMERS) : "memory");
}

// s (64 x 64) = this warpgroup's Q rows (A fragments qf) times one K tile
// (shared address ka): a fresh tensor-core sum per 64 of dk, added in fp32;
// issued in this warpgroup's turn
template <int DK>
__device__ __forceinline__ void qk(float (&s)[32], const uint32_t (&qf)[DK / 4], uint32_t ka,
                                   int wg) {
  using R = Ring<DK>;
  turn_wait(wg);
  reg_fence(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < SLAB / 16; ++kk)  // k-step kk: 32 bytes into each row
    wgmma_rs<0>(s, qf + 4 * kk, desc_sw128(ka + 32 * kk, 16, 1024), kk > 0);
  if constexpr (DK == 2 * SLAB) {
    float t[32];
    reg_fence(t);
#pragma unroll
    for (int kk = 0; kk < SLAB / 16; ++kk)
      wgmma_rs<0>(t, qf + 4 * (SLAB / 16 + kk), desc_sw128(ka + R::REGION + 32 * kk, 16, 1024),
                  kk > 0);
    wg_commit();
    turn_pass(wg);
    wg_wait<0>();
    reg_fence(s);
    reg_fence(t);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] += t[i];
  } else {
    wg_commit();
    turn_pass(wg);
    wg_wait<0>();
    reg_fence(s);
  }
}

// o (64 x DK) += P (bf16 A fragments, p[4 kk + i] for k-step kk) times one
// V tile (va): a fresh tensor-core sum over the tile's 64 keys per 64 of dk,
// one slab after the other (two slabs' sums at once would not fit in the
// registers beside o, Q's fragments and P), added in fp32
template <int DK>
__device__ __forceinline__ void pv(float (&o)[DK / 2], const uint32_t (&p)[16], uint32_t va) {
#pragma unroll
  for (int sl = 0; sl < DK / SLAB; ++sl) {
    float f[32];
    reg_fence(f);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk)
      wgmma_rs<1>(f, p + 4 * kk,  // k-step kk: keys 16 kk.., 16 rows of 128 bytes
                  desc_sw128(va + sl * Ring<DK>::REGION + 2048 * kk, Ring<DK>::REGION, 1024),
                  kk > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(f);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[32 * sl + i] += f[i];
  }
}

// this thread's 16 keys of a tile as the S accumulator holds them: bit 2j + e
// is key 8j + 2qd + e (s[4j + 2rr + e], rows r and r + 8)
__device__ __forceinline__ uint32_t own_keys(uint64_t bits, int qd) {
  uint32_t ok = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) ok |= (uint32_t)((bits >> (8 * j + 2 * qd)) & 3u) << (2 * j);
  return ok;
}

// a consumer warp is done with a stage once its wgmma have completed
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(empty);
}

template <int DK>
__global__ void __launch_bounds__(BF16_THREADS, 1)
mha_bf16_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const uint8_t* __restrict__ mask,
                bf16* __restrict__ out, int seq, int n_head, float scale) {
  using R = Ring<DK>;
  extern __shared__ __align__(1024) uint8_t ring_smem[];  // the swizzle's atoms are 1024-aligned
  const uint32_t q_a = smem_addr(ring_smem), ring_a = q_a + R::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem + R::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BLOCK_M, h = blockIdx.y, b = blockIdx.z;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * seq;
  const int n_tiles = (seq + BLOCK_N - 1) / BLOCK_N;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      bar_init(full + i, 1);                     // the producer's expect_tx
      bar_init(empty + i, CONSUMERS / 32);       // one arrival a consumer warp
    }
    bar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    set_regs_dec<PRODUCER_REGS>();
    if (warp > CONSUMERS / 32) return;
    // the producer: Q, then item j of the sequence (pass 1's live tiles, then
    // pass 2's) to stage j % STAGES once the consumers have released that
    // stage's item j - STAGES; the TMA copies complete the stage's phase
    if (lane == 0) {
      bar_expect(q_full, R::Q_BYTES);
      tma_rows<BLOCK_M, DK>(q_a, &map_q, h, q0, b, q_full);
    }
    int j = 0;
    uint64_t bits;
    for (int pass = 0; pass < 2; ++pass)
      for (int kt = next_live(mask_b, seq, 0, n_tiles, bits); kt < n_tiles;
           kt = next_live(mask_b, seq, kt + 1, n_tiles, bits), ++j) {
        const int slot = j % STAGES;
        if (j >= STAGES) bar_wait(empty + slot, (j / STAGES - 1) & 1);
        if (lane == 0) {
          const uint32_t stage = ring_a + slot * R::STAGE;
          bar_expect(full + slot, pass ? R::STAGE : R::TILE);
          tma_rows<BLOCK_N, DK>(stage, &map_k, h, kt * BLOCK_N, b, full + slot);
          if (pass) tma_rows<BLOCK_N, DK>(stage + R::TILE, &map_v, h, kt * BLOCK_N, b, full + slot);
        }
      }
    return;
  }

  set_regs_inc<CONSUMER_REGS>();
  const int wg = warp >> 2;
  const int r = 16 * (warp & 3) + (lane >> 2);  // accumulator rows r, r + 8
  const int qd = lane & 3;
  // a warpgroup whose 64 rows all lie past seq releases stages and takes its
  // turns but computes nothing
  const bool rows_live = q0 + 64 * wg < seq;
  if (wg == 1) turn_pass(wg);  // warpgroup 0 goes first

  // Q's A fragments, k-step kk at qf[4 kk ..]: rows r and r + 8, columns
  // 2qd (+1) and 2qd + 8 (+1) of the step, read through the swizzle
  uint32_t qf[DK / 4];
  bar_wait(q_full, 0);
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 64 * wg + r + 8 * (i & 1), c = 2 * (kk % 4) + (i >> 1);
      qf[4 * kk + i] = *reinterpret_cast<const uint32_t*>(
          ring_smem + (kk / 4) * BLOCK_M * 128 + row * 128 + ((c ^ (row & 7)) * 16) + 4 * qd);
    }

  // pass 1: the rows' max m and sum l over the live tiles, online; each
  // thread keeps the sum of its own keys, rescaled as m grows
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int j = 0;
  uint64_t bits;
  for (int kt = next_live(mask_b, seq, 0, n_tiles, bits); kt < n_tiles;
       kt = next_live(mask_b, seq, kt + 1, n_tiles, bits), ++j) {
    const int slot = j % STAGES;
    bar_wait(full + slot, (j / STAGES) & 1);
    float s[32];
    if (rows_live) {
      qk<DK>(s, qf, ring_a + slot * R::STAGE, wg);
    } else {
      turn_wait(wg);
      turn_pass(wg);
    }
    release(empty + slot, lane);
    if (!rows_live) continue;
    const uint32_t ok = own_keys(bits, qd);
    float mx[2] = {-INFINITY, -INFINITY};
    if (ok == 0xFFFFFFFFu) {  // every key of the tile valid: no masking
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = __fmul_rn(s[i], scale);
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = (ok >> (2 * (i >> 2) + (i & 1))) & 1u ? __fmul_rn(s[i], scale) : -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      // the 4 threads sharing a row are lanes differing in bits 0..1; a live
      // tile has a valid key for every row, so the max is finite, and the
      // first tile's rescale is exp(-inf) = 0
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      l[rr] *= expf(m[rr] - m_new);
      m[rr] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) l[(i >> 1) & 1] += expf(s[i] - m[(i >> 1) & 1]);  // masked: 0
  }
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    inv[rr] = l[rr] > 0.f ? 1.f / l[rr] : 0.f;  // no valid key: exact zeros
  }

  // pass 2: P = bf16(exp(s - m) / l), O += P V
  float o[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) o[i] = 0.f;
  for (int kt = next_live(mask_b, seq, 0, n_tiles, bits); kt < n_tiles;
       kt = next_live(mask_b, seq, kt + 1, n_tiles, bits), ++j) {
    const int slot = j % STAGES;
    bar_wait(full + slot, (j / STAGES) & 1);
    if (!rows_live) {
      turn_wait(wg);
      turn_pass(wg);
      release(empty + slot, lane);
      continue;
    }
    const uint32_t stage = ring_a + slot * R::STAGE;
    float s[32];
    qk<DK>(s, qf, stage, wg);
    const uint32_t ok = own_keys(bits, qd);
    // the logit rounded before the subtraction, as in pass 1 (no FMA)
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = expf(__fmul_rn(s[i], scale) - m[(i >> 1) & 1]);
    if (ok != 0xFFFFFFFFu) {  // padding keys: exactly 0
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!((ok >> (2 * (i >> 2) + (i & 1))) & 1u)) s[i] = 0.f;
    }
    uint32_t p[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int rr = (i >> 1) & 1;
      __nv_bfloat162 pair = __floats2bfloat162_rn(s[i] * inv[rr], s[i + 1] * inv[rr]);
      p[i / 2] = *reinterpret_cast<uint32_t*>(&pair);
    }
    pv<DK>(o, p, stage + R::TILE);
    release(empty + slot, lane);
  }

  if (!rows_live) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int t = q0 + 64 * wg + r + 8 * rr;
    if (t >= seq) continue;
    bf16* row = out + ((size_t)b * seq + t) * n_head * DK + (size_t)h * DK;
#pragma unroll
    for (int sl = 0; sl < DK / SLAB; ++sl)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int i = 32 * sl + 4 * jj + 2 * rr;
        store2(row + SLAB * sl + 8 * jj + 2 * qd, o[i], o[i + 1]);
      }
  }
}

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  return encode;
}

// x (batch, seq, n_head * dk) bf16 as a 3-D tensor (features, rows, items)
// read in boxes of 64 features (128 bytes) by `rows` rows, 128-byte
// swizzled; rows past seq read as zeros
bool tensor_map(CUtensorMap* map, const void* x, int batch, int seq, int features, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)features, (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)features * 2, (cuuint64_t)features * seq * 2};
  const cuuint32_t box[3] = {SLAB, (cuuint32_t)rows, 1}, step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const uint8_t* mask,
                        void* out, int batch, int seq, int n_head, float scale,
                        cudaStream_t stream) {
  constexpr int smem = Ring<DK>::SMEM;
  CUtensorMap map_q, map_k, map_v;
  if (!tensor_map(&map_q, q, batch, seq, n_head * DK, BLOCK_M) ||
      !tensor_map(&map_k, k, batch, seq, n_head * DK, BLOCK_N) ||
      !tensor_map(&map_v, v, batch, seq, n_head * DK, BLOCK_N))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mha_bf16_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((seq + BLOCK_M - 1) / BLOCK_M, n_head, batch);
  mha_bf16_kernel<DK><<<grid, BF16_THREADS, smem, stream>>>(
      map_q, map_k, map_v, mask, static_cast<bf16*>(out), seq, n_head, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16. q, k, v
// and out 16-byte aligned. mask: (batch, seq) uint8, nonzero = padding key;
// may be null (no mask). Returns a cudaError_t (0 = launched).
extern "C" int flash_mha_fwd(const void* q, const void* k, const void* v, const void* mask,
                             void* out, int batch, int seq, int n_head, int dk, int dtype,
                             float scale, void* stream) {
  if (seq <= 0 || batch <= 0 || n_head <= 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dk == 64)
    return (int)launch<float, 64>(q, k, v, m, out, batch, seq, n_head, scale, s);
  if (dtype == 0 && dk == 128)
    return (int)launch<float, 128>(q, k, v, m, out, batch, seq, n_head, scale, s);
  if (dtype == 1 && dk == 64)
    return (int)launch_bf16<64>(q, k, v, m, out, batch, seq, n_head, scale, s);
  if (dtype == 1 && dk == 128)
    return (int)launch_bf16<128>(q, k, v, m, out, batch, seq, n_head, scale, s);
  return (int)cudaErrorInvalidValue;
}
