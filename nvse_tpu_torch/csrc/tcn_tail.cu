// ConvTasNet's fused TCN block tail and its gLN statistics, for Hopper (sm_90a).
//
// Replaces the TPU kernel of nvse_tpu/ops/pallas_tcn.py: `_tcn_kernel`,
// launched by `_pallas_tail` (pallas_tcn.py:136). The gLN statistics are what
// the JAX package computes in XLA outside its kernel (pallas_tcn.py:168-182).
//
// Contract (channels-last, per batch element b, time step t):
//   gLN fold (tcn_gln_stats_launch): m1 = mean(c[b]), m2 = mean(c[b]^2) over (T, H),
//     summed in float32; rstd = rsqrt(max(m2 - m1^2, 0) + eps);
//     a[b, k] = gln_w[k] rstd, b2[b, k] = gln_b[k] - m1 a[b, k]
//   n[t, k]   = c[t, k] * a[k] + b2[k]  for 0 <= t < T, and exactly 0 outside
//               (the conv's zero padding applies AFTER the norm: a tap outside
//               [0, T) reads 0, not b2)
//   q[t, k]   = n[t - d, k] w_dw[0, k] + n[t, k] w_dw[1, k] + n[t + d, k] w_dw[2, k]
//               + b_dw[k]                          (float32)
//   out[t, j] = sum_k round(q[t, k]) w_rs[k, j] + b_rs[j]   (float32 sums)
//   e[t, j]   = x[t, j] + out[t, j]                for j < Bc
//   skip[t, j - Bc] = out[t, j]                    for Bc <= j < 2 Bc
// round() is the rounding to w_rs's type (a no-op in float32). c, x, w_dw,
// b_dw, w_rs, b_rs, e and skip are all float32, all bfloat16 or all float16; a and b2 are
// float32. Shapes: c (B, T, H), x (B, T, Bc), w_dw (3, H), b_dw (H),
// w_rs (H, 2 Bc), b_rs (2 Bc), a and b2 (B, H), e and skip (B, T, Bc). Any
// B, T, H, Bc and dilation d >= 1.
//
// What bounds it. At ConvTasNet's decode shape (B = 8, T = 32,735 encoder
// frames, H = 512, Bc = 128) one call is 68.7 GFLOP of res|skip product on
// 0.94 GB (float32): 1.03 ms of operations at the card's 67 TFLOP/s float32
// rate against 0.28 ms of bytes. In bfloat16 the tensor cores take the
// product in 0.07 ms and the call is bound by its 0.47 GB of bytes (0.14 ms).
// The statistics read c once: 0.08 ms (bfloat16) or 0.16 ms (float32).
//
// Design of the tail. Tiles of BM = 128 time steps of one batch element x BN =
// 256 output columns (all of res|skip at Bc = 128); one persistent block an SM
// walks the tiles in T order (block i takes tiles i, i + grid, ...), so that
// neighbouring tiles run at once and their tap rows meet in L2. A tile walks H
// in K-chunks of KC channels through a ring of shared-memory stages, each
// filled by cp.async a chunk or two ahead of its use:
//   - the chunk of w_rs (KC x 256): w_rs is read from L2 once a tile, 256 KB
//     in bfloat16 (512 KB in float32) a tile: 2,048 tiles read 0.54 GB (1.07 GB)
//     of it at the decode shape, where the first layout (64-row blocks that
//     staged all of w_rs each) read about 2 GB;
//   - the tile's rows of c for the chunk's channels: rows [t0 - d, t0 + BM + d)
//     when d < BM, else three boxes of BM rows at t0 - d, t0 and t0 + d (rows
//     outside [0, T) zero-filled, and masked from the taps);
//   - the chunk's a, b2, w_dw and b_dw.
// q is built from the staged rows (each element of c read once from L2 per
// tile and per tap from shared memory), with the constants loaded once a chunk.
//   - bfloat16: the product runs on the tensor cores as wgmma m64n256k16 with
//     A from registers: two consumer warpgroups own 64 rows each, and each warp
//     builds q for its 16 rows straight into the A fragments (rounded once to
//     bf16); B, the w_rs chunk, sits in shared memory in the 128-byte swizzle
//     layout (MN-major: w_rs rows copied as they are, 16 bytes at a time, and
//     read transposed; the no-swizzle layout ran 8-way bank conflicts). A
//     warpgroup waits for its chunk's wgmma before it builds the next chunk's
//     fragments (building registers that a wgmma in flight reads makes ptxas
//     serialize every wgmma); the two warpgroups' builds and products
//     interleave; 3 stages.
//   - float32: true float32 FMAs on the CUDA cores (no TF32): q is built into a
//     [k][row] tile in shared memory, and each of 256 threads accumulates an
//     8 x 16 register tile of the 128 x 256 output; 2 stages.
//   - float16 takes the bfloat16 kernel (tcn_tail_wgmma_kernel<T>) with the
//     wgmma's f16 operand type: its staging, swizzle, fragments and epilogue
//     are those of any 16-bit type, and the tensor cores take f16 at bf16's
//     rate, where the float32 FMA kernel would first widen every operand.
// The epilogue adds b_rs and the residual (x prefetched into L2 at the tile's
// first chunk, then loaded into registers all at once before any store) and
// writes both outputs, 16 bytes a lane (16-bit types: the C fragments turned around
// within each quad of lanes). Ragged ends in T, H and 2 Bc are
// masked; 16-byte copies where the rows are 16-byte aligned, element copies
// elsewhere.
//
// Design of the statistics (tcn_gln_stats_launch, tcn_gln_stats_kernel): one
// launch, no float atomics, so that two runs give the same bits. It is bound by
// the bytes of c. P blocks a batch element (about four an SM over the batch:
// ops/tcn.py gln_stats_partials) each sum a contiguous run of c[b] into a float32
// sum and sum of squares, each thread with four 16-byte loads in flight and an
// accumulator pair a load; the last block of b to finish, found by an integer
// ticket, adds the P partials in a fixed order with one warp and writes a and b2.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (tcn_tail_launch, tcn_gln_stats_launch), loaded through ctypes;
// ops/tcn.py `tail_plan` picks the chunk, the stages and the blocks.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int BM = 128;       // time steps of a tile
constexpr int BN = 256;       // output columns of a tile
constexpr int THREADS = 256;  // bfloat16: 2 warpgroups of 64 rows; float32: 16 x 16 threads

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// Two 16-bit values (bfloat16 or float16) of one 32-bit word: unpacked to
// float32, and packed from float32 rounded to nearest even.
template <typename T> __device__ __forceinline__ float2 unpack2(const void* p) {
  if constexpr (std::is_same<T, __half>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <typename T> __device__ __forceinline__ unsigned pack2(float a, float b) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&v);
  }
}

__host__ __device__ constexpr long round128(long v) { return (v + 127) / 128 * 128; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared without a register round trip; bytes past src_bytes
// are zero-filled (0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<2>();
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// One 16-byte unit of E = 16 / sizeof(V) elements, of which `n` exist at src
// (n >= E: all; n <= 0: none): by cp.async where `vec` (16-byte aligned rows,
// n is E or <= 0), else element by element; the missing ones are zeros.
template <typename V>
__device__ __forceinline__ void copy_unit(V* dst, const V* src, int n, int vec) {
  constexpr int E = 16 / sizeof(V);
  if (vec) {
    cp_async16(dst, src, n > 0 ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = e < n ? src[e] : from_f<V>(0.0f);
  }
}

struct Args {
  const void* c;          // (B, T, H)
  const void* x;          // (B, T, Bc)
  const float* a;         // (B, H)
  const float* b2;        // (B, H)
  const void* w_dw;       // (3, H)
  const void* b_dw;       // (H)
  const void* w_rs;       // (H, 2 Bc)
  const void* b_rs;       // (2 Bc)
  void* e;                // (B, T, Bc)
  void* s;                // (B, T, Bc)
  int B, T, H, Bc, d;
  int tiles_t;            // row tiles of a batch element
  int tiles_n;            // column tiles
  int ntiles;             // B * tiles_t * tiles_n
  int stages;             // the ring
  int vec;                // 16-byte copies (every row 16-byte aligned)
};

// One ring stage: the w_rs chunk, the staged rows of c (SR rows of pitch CP) and
// the chunk's constants (a, b2 float32; w_dw's three rows and b_dw in T), each
// 128-byte aligned. ops/tcn.py `_tail_smem` mirrors it.
// In bfloat16 each stage starts on 1024 bytes (the w_rs chunk is made of
// 1024-byte swizzle atoms), and the dynamic shared memory has 1024 bytes of
// slack to align its start.
template <typename T, int KC>
struct Stage {
  static constexpr int CP = KC + 16 / (int)sizeof(T);   // rows 16 bytes longer
  __host__ __device__ static constexpr long wbytes() { return (long)KC * BN * sizeof(T); }
  __host__ __device__ static constexpr long cbytes(int SR) { return round128((long)SR * CP * sizeof(T)); }
  __host__ __device__ static constexpr long kbytes() { return round128(2L * KC * 4 + 4L * KC * sizeof(T)); }
  __host__ __device__ static constexpr long bytes(int SR) {
    const long b = wbytes() + cbytes(SR) + kbytes();
    return sizeof(T) == 2 ? (b + 1023) / 1024 * 1024 : b;
  }
};
constexpr int QP = BM + 4;     // float32: pitch of the q tile [k][row]

template <typename T, int KC>
__host__ __device__ constexpr long smem_bytes(int d, int stages) {
  const int SR = BM + 2 * (d < BM ? d : BM);
  return stages * Stage<T, KC>::bytes(SR) + (sizeof(T) == 4 ? (long)KC * QP * 4 : 1024);
}

// The staging row of tap j (0, 1, 2: t - d, t, t + d) of tile row r is r + j S,
// S = min(d, BM); staging row i holds time t0 - d + i (d < BM) or, in box i / BM,
// t0 + (i / BM - 1) d + i % BM.
__device__ __forceinline__ long long staged_time(int i, int t0, int d) {
  return d < BM ? (long long)t0 - d + i : (long long)t0 + (long long)(i / BM - 1) * d + i % BM;
}

// Stages chunk (b, t0, n0, k0) into `st`: cp.async copies, not committed here.
// bfloat16: the w_rs chunk lands in wgmma's 128-byte swizzle layout, MN-major,
// in 1024-byte atoms of 8 rows x 128 bytes (a row: 64 columns of one k) whose
// 16-byte chunk c of row r sits at chunk c ^ r; atoms of 8 k at SBO = 1024, of
// 64 columns at LBO = KC / 8 x 1024.
template <typename T, int KC>
__device__ __forceinline__ void stage_chunk(const Args& A, char* st, int SR, int b, int t0, int n0,
                                            int k0) {
  constexpr int E = 16 / sizeof(T);
  using SG = Stage<T, KC>;
  T* wb = reinterpret_cast<T*>(st);
  T* cs = reinterpret_cast<T*>(st + SG::wbytes());
  float* ka = reinterpret_cast<float*>(st + SG::wbytes() + SG::cbytes(SR));
  T* kw = reinterpret_cast<T*>(ka + 2 * KC);
  const int tid = threadIdx.x, H = A.H, Tn = A.T, N2 = 2 * A.Bc, vec = A.vec;
  const T* c = static_cast<const T*>(A.c) + (size_t)b * Tn * H;
  const T* w = static_cast<const T*>(A.w_rs);

  constexpr int UPR = KC / E;                      // 16-byte units of a staged row
  for (int i = tid; i < SR * UPR; i += THREADS) {
    const int r = i / UPR, u = i - r * UPR, k = k0 + u * E;
    const long long t = staged_time(r, t0, A.d);
    const bool ok = t >= 0 && t < Tn;
    copy_unit<T>(cs + r * SG::CP + u * E, c + (size_t)(ok ? t : 0) * H + k, ok ? H - k : 0, vec);
  }
  if constexpr (sizeof(T) == 2) {
    constexpr int NG = BN / 8, LBO = KC / 8 * 1024;
    for (int i = tid; i < KC * NG; i += THREADS) {   // a unit: 8 columns of one k
      const int k = i / NG, ng = i - k * NG, gk = k0 + k, gn = n0 + ng * 8;
      T* dst = reinterpret_cast<T*>(reinterpret_cast<char*>(wb) + (ng >> 3) * LBO +
                                    (k >> 3) * 1024 + (k & 7) * 128 + (((ng ^ k) & 7) * 16));
      copy_unit<T>(dst, w + (size_t)(gk < H ? gk : 0) * N2 + gn, gk < H ? N2 - gn : 0, vec);
    }
  } else {                                         // [k][BN]
    for (int i = tid; i < KC * (BN / 4); i += THREADS) {
      const int k = i / (BN / 4), u = i - k * (BN / 4), gk = k0 + k, gn = n0 + 4 * u;
      copy_unit<T>(wb + k * BN + 4 * u, w + (size_t)(gk < H ? gk : 0) * N2 + gn,
                   gk < H ? N2 - gn : 0, vec);
    }
  }
  const float* ag = A.a + (size_t)b * H;
  const float* bg = A.b2 + (size_t)b * H;
  for (int i = tid; i < 2 * (KC / 4); i += THREADS) {
    const int which = i / (KC / 4), k = k0 + 4 * (i - which * (KC / 4));
    copy_unit<float>(ka + which * KC + (k - k0), (which ? bg : ag) + k, H - k, vec);
  }
  const T* wd = static_cast<const T*>(A.w_dw);
  const T* bd = static_cast<const T*>(A.b_dw);
  for (int i = tid; i < 4 * (KC / E); i += THREADS) {
    const int row = i / (KC / E), k = k0 + E * (i - row * (KC / E));
    copy_unit<T>(kw + row * KC + (k - k0), (row < 3 ? wd + (size_t)row * H : bd) + k, H - k, vec);
  }
}

// (b, t0, n0, k0) of this block's chunk j: tile j / NK of the block, chunk j % NK
__device__ __forceinline__ void chunk_at(const Args& A, int NK, int KC, int j, int& b, int& t0,
                                         int& n0, int& k0) {
  const int it = j / NK, kc = j - it * NK;
  const int id = blockIdx.x + it * gridDim.x;
  const int nt = id % A.tiles_n, rest = id / A.tiles_n;
  b = rest / A.tiles_t;
  t0 = (rest - b * A.tiles_t) * BM;
  n0 = nt * BN;
  k0 = kc * KC;
}

// x of the tile's rows into L2 ahead of the epilogue: warp w the rows of its 16
__device__ __forceinline__ void prefetch_x(const Args& A, int b, int t0, int rb, int rows, int esz) {
  const int lane = threadIdx.x & 31;
  const long long bytes = (long long)A.Bc * esz;
  for (int i = lane; i < rows * ((bytes + 127) / 128); i += 32) {
    const int r = i % rows;
    const long long off = (long long)(i / rows) * 128;
    const long long t = (long long)t0 + rb + r;
    if (t < A.T)
      prefetch_l2(static_cast<const char*>(A.x) + ((size_t)b * A.T + t) * bytes + off);
  }
}

// out (v0, v1 at columns col, col + 1; col + 1 only where `two`) into e or skip
template <typename T>
__device__ __forceinline__ void store_pair(const Args& A, size_t row, int col, float v0, float v1,
                                           bool two) {
  const int Bc = A.Bc;
  const T* x = static_cast<const T*>(A.x);
  T* e = static_cast<T*>(A.e);
  T* s = static_cast<T*>(A.s);
  if constexpr (sizeof(T) == 2) {
    if (A.vec && two && !(Bc & 1)) {
      if (col < Bc) {
        const size_t o = row * Bc + col;
        const float2 xv = unpack2<T>(x + o);
        *reinterpret_cast<unsigned*>(e + o) = pack2<T>(xv.x + v0, xv.y + v1);
      } else {
        *reinterpret_cast<unsigned*>(s + row * Bc + col - Bc) = pack2<T>(v0, v1);
      }
      return;
    }
  }
  for (int i = 0; i < (two ? 2 : 1); ++i) {
    const int cc = col + i;
    const float v = i ? v1 : v0;
    if (cc < Bc) e[row * Bc + cc] = from_f<T>(to_f<T>(x[row * Bc + cc]) + v);
    else s[row * Bc + cc - Bc] = from_f<T>(v);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 and float16: wgmma with A (q) from registers
// ---------------------------------------------------------------------------

// the operands of wgmma_rs: 128 float32 sums, the A fragments, B's descriptor, scale_d
#define WGMMA_RS_OPERANDS \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, " \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)

// d (+)= a (64 x 16, registers) * b (16 x 256, shared memory, read transposed:
// MN-major), both bfloat16 or both float16 (T), float32 sums; scale_d 0 starts
// the sums afresh
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const unsigned (&a)[4],
                                         unsigned long long desc, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
      WGMMA_RS_OPERANDS);
  else
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      WGMMA_RS_OPERANDS);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared-memory matrix descriptor with the 128-byte swizzle (layout type 1):
// start, leading (LBO) and stride (SBO) byte offsets, each in 16-byte units
__device__ __forceinline__ unsigned long long make_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         ((unsigned long long)(lbo >> 4) << 16) | ((unsigned long long)(sbo >> 4) << 32) |
         (1ull << 62);
}
// The registers stay where they are up to here: the A fragments of a wgmma in
// flight must not be reused for the next chunk's, nor the accumulators read
// before the wait that completes them.
template <int KS>
__device__ __forceinline__ void keep_live(unsigned (&a)[KS][4]) {
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i])::"memory");
}
__device__ __forceinline__ void keep_live(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A quad of lanes (tq = lane % 4) holds words w0 ... w3 of 8-column blocks 4k ...
// 4k + 3, lane tq the columns 2 tq, 2 tq + 1 of each; returns to lane tq the four
// words of block 4k + tq, in column order. Round r: lane tq sends its word of
// block 4k + (tq - r) % 4 and takes lane (tq + r) % 4's word of block 4k + tq.
__device__ __forceinline__ uint4 quad_transpose(unsigned w0, unsigned w1, unsigned w2, unsigned w3,
                                                int tq, int lane) {
  unsigned o0 = 0u, o1 = 0u, o2 = 0u, o3 = 0u;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = (tq - r) & 3, src = (tq + r) & 3;
    const unsigned send = m == 0 ? w0 : m == 1 ? w1 : m == 2 ? w2 : w3;
    const unsigned got = __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
    o0 = src == 0 ? got : o0;
    o1 = src == 1 ? got : o1;
    o2 = src == 2 ? got : o2;
    o3 = src == 3 ? got : o3;
  }
  return make_uint4(o0, o1, o2, o3);
}

template <typename T, int KC>
__global__ void __launch_bounds__(THREADS, 1) tcn_tail_wgmma_kernel(const Args A) {
  using SG = Stage<T, KC>;
  constexpr int KS = KC / 16;                      // k16 steps of a chunk
  extern __shared__ __align__(128) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);   // 1024-byte aligned
  const int d = A.d, S = d < BM ? d : BM, SR = BM + 2 * S, Tn = A.T;
  const long stage_bytes = SG::bytes(SR);
  const int NK = (A.H + KC - 1) / KC;
  const int mine = (int)blockIdx.x < A.ntiles ? (A.ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int nch = mine * NK, PD = A.stages - 1;     // chunks in flight ahead of the one used
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3, rb = warp * 16;

  auto fetch = [&](int j) {
    if (j < nch) {
      int b, t0, n0, k0;
      chunk_at(A, NK, KC, j, b, t0, n0, k0);
      stage_chunk<T, KC>(A, smem + (j % A.stages) * stage_bytes, SR, b, t0, n0, k0);
    }
    cp_async_commit();
  };
  for (int j = 0; j < PD; ++j) fetch(j);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  unsigned af[KS][4];

  for (int j = 0; j < nch; ++j) {
    cp_async_wait_dyn(PD - 1);                     // chunk j (this thread's copies)
    __syncthreads();                               // ... every thread's; chunk j - 1 consumed
    fetch(j + PD);
    int b, t0, n0, k0;
    chunk_at(A, NK, KC, j, b, t0, n0, k0);
    if (k0 == 0) prefetch_x(A, b, t0, rb, 16, 2);
    const char* st = smem + (j % A.stages) * stage_bytes;
    const T* cs = reinterpret_cast<const T*>(st + SG::wbytes());
    const float* ka = reinterpret_cast<const float*>(st + SG::wbytes() + SG::cbytes(SR));
    const T* kw = reinterpret_cast<const T*>(ka + 2 * KC);
    unsigned valid = 0;                            // bit 3 ri + tap: the tap reads a row of [0, T)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        const long long t = (long long)t0 + rb + g + 8 * ri + (long long)(tap - 1) * d;
        valid |= (unsigned)(t >= 0 && t < Tn) << (3 * ri + tap);
      }
    // q of rows rb + g (+ 8), k = 16 s + 8 h + 2 tq (+ 1): the A fragments
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kl = 16 * s + 8 * h + 2 * tq;
        const float2 av = *reinterpret_cast<const float2*>(ka + kl);
        const float2 bv = *reinterpret_cast<const float2*>(ka + KC + kl);
        float2 wv[3];
#pragma unroll
        for (int tap = 0; tap < 3; ++tap)
          wv[tap] = unpack2<T>(kw + tap * KC + kl);
        const float2 bd = unpack2<T>(kw + 3 * KC + kl);
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const int r = rb + g + 8 * ri;
          float sx = 0.0f, sy = 0.0f;
#pragma unroll
          for (int tap = 0; tap < 3; ++tap) {
            if (valid >> (3 * ri + tap) & 1u) {
              const float2 cv = unpack2<T>(cs + (r + tap * S) * SG::CP + kl);
              sx = fmaf(fmaf(cv.x, av.x, bv.x), wv[tap].x, sx);
              sy = fmaf(fmaf(cv.y, av.y, bv.y), wv[tap].y, sy);
            }
          }
          af[s][ri + 2 * h] = pack2<T>(sx + bd.x, sy + bd.y);
        }
      }
    keep_live(af);                                 // every fragment built before the first wgmma
    wgmma_fence();
    const unsigned wbase = smem_u32(st);
    // k16 step s: the k-atoms 2 s and 2 s + 1; B read transposed (MN-major)
#pragma unroll
    for (int s = 0; s < KS; ++s)
      wgmma_rs<T>(acc, af[s], make_desc(wbase + s * 2048, KC / 8 * 1024, 1024),
                  (k0 > 0 || s > 0) ? 1 : 0);
    wgmma_commit();
    // the chunk's products done before the next chunk's fragments are built: a
    // warpgroup does not build into registers that a wgmma in flight reads (which
    // makes ptxas serialize every wgmma); the other warpgroup's products run
    // meanwhile
    wgmma_wait<0>();
    keep_live(acc);
    if (k0 + KC >= A.H) {                          // the tile's last chunk: the epilogue
      const int N2 = 2 * A.Bc, Bc = A.Bc;
      const T* __restrict__ brs = static_cast<const T*>(A.b_rs);
      if (A.vec && !(Bc & 31)) {
        // The C fragments hold two columns of each 8-column block a lane: a quad
        // of lanes turns groups of 4 blocks around (quad_transpose) so that each
        // lane stores 16 bytes, 8 columns of one row, and a quad 64 contiguous
        // bytes (stores of 4 bytes a lane, half a 32-byte sector a row, took 55 %
        // of the kernel's time). e = x + out rounds once, from float32: both
        // halves of the column pairs are turned around in float32. The residual
        // of a row's groups is loaded before its stores.
        const T* __restrict__ x = static_cast<const T*>(A.x);
        T* __restrict__ e = static_cast<T*>(A.e);
        T* __restrict__ so = static_cast<T*>(A.s);
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {                 // a row at a time: 32 registers of x
          const long long t = (long long)t0 + rb + g + 8 * ri;
          const size_t row = (size_t)b * Tn + (t < Tn ? t : 0);
          uint4 xr[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int col = n0 + 32 * k + 8 * tq;       // this lane's block after the turn
            xr[k] = col < Bc && t < Tn ? *reinterpret_cast<const uint4*>(x + row * Bc + col)
                                       : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int gcol = n0 + 32 * k;                // the group's first column
            if (gcol >= N2) break;                       // uniform
            float v0[4], v1[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 bb = unpack2<T>(brs + gcol + 8 * j + 2 * tq);
              v0[j] = acc[4 * (4 * k + j) + 2 * ri] + bb.x;
              v1[j] = acc[4 * (4 * k + j) + 2 * ri + 1] + bb.y;
            }
            const int col = gcol + 8 * tq;
            if (gcol < Bc) {                             // e: the whole group (Bc % 32 == 0)
              const uint4 a = quad_transpose(__float_as_uint(v0[0]), __float_as_uint(v0[1]),
                                             __float_as_uint(v0[2]), __float_as_uint(v0[3]), tq, lane);
              const uint4 c2 = quad_transpose(__float_as_uint(v1[0]), __float_as_uint(v1[1]),
                                              __float_as_uint(v1[2]), __float_as_uint(v1[3]), tq, lane);
              const unsigned av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c2.x, c2.y, c2.z, c2.w};
              const unsigned xv[4] = {xr[k].x, xr[k].y, xr[k].z, xr[k].w};
              unsigned o[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float2 xf = unpack2<T>(&xv[q]);
                o[q] = pack2<T>(xf.x + __uint_as_float(av[q]), xf.y + __uint_as_float(cv[q]));
              }
              if (t < Tn)
                *reinterpret_cast<uint4*>(e + row * Bc + col) = make_uint4(o[0], o[1], o[2], o[3]);
            } else {                                     // skip: rounded before the turn
              unsigned w[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                w[j] = pack2<T>(v0[j], v1[j]);
              }
              const uint4 o = quad_transpose(w[0], w[1], w[2], w[3], tq, lane);
              if (t < Tn) *reinterpret_cast<uint4*>(so + row * Bc + col - Bc) = o;
            }
          }
        }
      } else {                                     // Bc % 32 != 0 or unaligned rows: pairs
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = n0 + 8 * i + 2 * tq;
          if (col < N2) {
            const bool two = col + 1 < N2;
            const float bb0 = to_f<T>(brs[col]), bb1 = two ? to_f<T>(brs[col + 1]) : 0.0f;
#pragma unroll
            for (int ri = 0; ri < 2; ++ri) {
              const long long t = (long long)t0 + rb + g + 8 * ri;
              if (t < Tn)
                store_pair<T>(A, (size_t)b * Tn + t, col, acc[4 * i + 2 * ri] + bb0,
                              acc[4 * i + 2 * ri + 1] + bb1, two);
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs, 8 x 16 outputs a thread
// ---------------------------------------------------------------------------

template <int KC>
__global__ void __launch_bounds__(THREADS, 1) tcn_tail_f32_kernel(const Args A) {
  using SG = Stage<float, KC>;
  extern __shared__ __align__(128) char smem[];
  const int d = A.d, S = d < BM ? d : BM, SR = BM + 2 * S, Tn = A.T, H = A.H;
  const long stage_bytes = SG::bytes(SR);
  float* q_s = reinterpret_cast<float*>(smem + 2 * stage_bytes);     // [KC][QP]
  const int NK = (H + KC - 1) / KC;
  const int mine = (int)blockIdx.x < A.ntiles ? (A.ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int nch = mine * NK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;

  auto fetch = [&](int j) {
    if (j < nch) {
      int b, t0, n0, k0;
      chunk_at(A, NK, KC, j, b, t0, n0, k0);
      stage_chunk<float, KC>(A, smem + (j & 1) * stage_bytes, SR, b, t0, n0, k0);
    }
    cp_async_commit();
  };
  fetch(0);
  float acc[8][16];
  for (int j = 0; j < nch; ++j) {
    cp_async_wait<0>();
    __syncthreads();                               // chunk j landed; chunk j - 1 consumed
    fetch(j + 1);
    int b, t0, n0, k0;
    chunk_at(A, NK, KC, j, b, t0, n0, k0);
    if (k0 == 0) prefetch_x(A, b, t0, warp * 16, 16, 4);
    const char* st = smem + (j & 1) * stage_bytes;
    const float* ws = reinterpret_cast<const float*>(st);
    {                                              // q (KC x BM) into q_s [k][row]
      const float* cs = reinterpret_cast<const float*>(st + SG::wbytes());
      const float* ka = reinterpret_cast<const float*>(st + SG::wbytes() + SG::cbytes(SR));
      const float* kw = ka + 2 * KC;
      const int kl = lane % KC;
      const float av = ka[kl], bv = ka[KC + kl], bd = kw[3 * KC + kl];
      const float wv[3] = {kw[kl], kw[KC + kl], kw[2 * KC + kl]};
      for (int r = warp * 16 + lane / KC; r < warp * 16 + 16; r += 32 / KC) {
        float s = 0.0f;
#pragma unroll
        for (int tap = 0; tap < 3; ++tap) {
          const long long t = (long long)t0 + r + (long long)(tap - 1) * d;
          if (t >= 0 && t < Tn) s = fmaf(fmaf(cs[(r + tap * S) * SG::CP + kl], av, bv), wv[tap], s);
        }
        q_s[kl * QP + r] = s + bd;
      }
    }
    __syncthreads();
    if (k0 == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) acc[i][jj] = 0.0f;
    }
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const float4 qa = *reinterpret_cast<const float4*>(q_s + kk * QP + ty * 4);
      const float4 qb = *reinterpret_cast<const float4*>(q_s + kk * QP + 64 + ty * 4);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      float wv[16];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 w4 = *reinterpret_cast<const float4*>(ws + kk * BN + m * 64 + tx * 4);
        wv[4 * m] = w4.x;
        wv[4 * m + 1] = w4.y;
        wv[4 * m + 2] = w4.z;
        wv[4 * m + 3] = w4.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) acc[i][jj] = fmaf(qv[i], wv[jj], acc[i][jj]);
    }
    if (k0 + KC >= H) {                            // the epilogue
      const int N2 = 2 * A.Bc, Bc = A.Bc;
      const float* __restrict__ brs = static_cast<const float*>(A.b_rs);
      const float* __restrict__ x = static_cast<const float*>(A.x);
      float* __restrict__ e = static_cast<float*>(A.e);
      float* __restrict__ so = static_cast<float*>(A.s);
      if (A.vec && !(Bc & 3)) {
        // four rows at a time: their residuals loaded at once before any store
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float4 xr[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const long long t = (long long)t0 + half * 64 + ty * 4 + i;
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int col = n0 + m * 64 + tx * 4;
              xr[i][m] = col < Bc && t < Tn
                             ? *reinterpret_cast<const float4*>(x + ((size_t)b * Tn + t) * Bc + col)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const long long t = (long long)t0 + half * 64 + ty * 4 + i;
            if (t >= Tn) continue;
            const size_t row = (size_t)b * Tn + t;
            const int ai = 4 * half + i;
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int col = n0 + m * 64 + tx * 4;
              if (col >= N2) continue;
              const float4 bb = *reinterpret_cast<const float4*>(brs + col);
              float4 v = make_float4(acc[ai][4 * m] + bb.x, acc[ai][4 * m + 1] + bb.y,
                                     acc[ai][4 * m + 2] + bb.z, acc[ai][4 * m + 3] + bb.w);
              if (col < Bc) {
                v = make_float4(xr[i][m].x + v.x, xr[i][m].y + v.y, xr[i][m].z + v.z,
                                xr[i][m].w + v.w);
                *reinterpret_cast<float4*>(e + row * Bc + col) = v;
              } else {
                *reinterpret_cast<float4*>(so + row * Bc + col - Bc) = v;
              }
            }
          }
        }
      } else {                                     // element by element
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const long long t = (long long)t0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
          if (t >= Tn) continue;
          const size_t row = (size_t)b * Tn + t;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int col = n0 + m * 64 + tx * 4;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              if (col + jj < N2)
                store_pair<float>(A, row, col + jj, acc[i][4 * m + jj] + brs[col + jj], 0.0f, false);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the gLN statistics
// ---------------------------------------------------------------------------

constexpr int STATS_THREADS = 256;
constexpr int STATS_UNROLL = 4;     // 16-byte loads in flight a thread

// s, ss += the sum and the sum of squares of the 16 / sizeof(T) values of raw, as
// two chains each (even and odd elements) so that the adds overlap
template <typename T>
__device__ __forceinline__ void stats_add16(const uint4 raw, float& s, float& ss) {
  constexpr int E = 16 / sizeof(T);
  const T* v = reinterpret_cast<const T*>(&raw);
  float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    const float f0 = to_f<T>(v[e]), f1 = to_f<T>(v[e + 1]);
    s0 += f0;
    s1 += f1;
    q0 = fmaf(f0, f0, q0);
    q1 = fmaf(f1, f1, q1);
  }
  s += s0 + s1;
  ss += q0 + q1;
}

// v summed over the block's threads in a fixed order (lanes by butterfly, then the
// warps in order by warp 0); the total lands in lane 0 of warp 0
__device__ __forceinline__ float2 stats_block_sum(float2 v, float2* red) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, m);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, m);
  }
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  v = make_float2(0.0f, 0.0f);
  if (tid < 32) {
    v = tid < STATS_THREADS / 32 ? red[tid] : v;
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, m);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, m);
    }
  }
  return v;
}

// One launch. Block (p, b) sums the p-th of P runs of c[b] (T H values) into a
// float32 sum and sum of squares, part[b][p][0, 1]; the last block of batch
// element b to finish (an integer ticket, ticket[b], which it puts back to 0)
// adds the P partials in a fixed order (a warp, lane l taking p = l, l + 32, ...,
// then a butterfly) and writes a[b] and b2[b] from gln_w, gln_b of type W. Which
// block is last changes from run to run; the order of the sums does not.
template <typename T, typename W>
__global__ void __launch_bounds__(STATS_THREADS) tcn_gln_stats_kernel(
    const T* __restrict__ c, const W* __restrict__ gw, const W* __restrict__ gb,
    float* __restrict__ part, unsigned int* __restrict__ ticket, float* __restrict__ a,
    float* __restrict__ b2, long long L, int H, int P, float eps, int vec) {
  constexpr int E = 16 / sizeof(T);
  constexpr int U = STATS_UNROLL;
  const int p = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const T* cb = c + (size_t)b * L;
  float s[U], ss[U];
#pragma unroll
  for (int u = 0; u < U; ++u) s[u] = ss[u] = 0.0f;
  if (vec) {                                   // runs of whole 16-byte vectors
    const uint4* cv = reinterpret_cast<const uint4*>(cb);
    const long long nv = L / E, lo = nv * p / P, hi = nv * (p + 1) / P;
    long long i = lo + tid;
    for (; i + (U - 1) * STATS_THREADS < hi; i += U * STATS_THREADS) {
      uint4 r[U];
#pragma unroll
      for (int u = 0; u < U; ++u) r[u] = __ldg(cv + i + u * STATS_THREADS);
#pragma unroll
      for (int u = 0; u < U; ++u) stats_add16<T>(r[u], s[u], ss[u]);
    }
    for (; i < hi; i += STATS_THREADS) stats_add16<T>(__ldg(cv + i), s[0], ss[0]);
  } else {                                     // element by element
    const long long lo = L * p / P, hi = L * (p + 1) / P;
    long long i = lo + tid;
    for (; i + (U - 1) * STATS_THREADS < hi; i += U * STATS_THREADS) {
      float f[U];
#pragma unroll
      for (int u = 0; u < U; ++u) f[u] = to_f<T>(cb[i + u * STATS_THREADS]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] += f[u];
        ss[u] = fmaf(f[u], f[u], ss[u]);
      }
    }
    for (; i < hi; i += STATS_THREADS) {
      const float f = to_f<T>(cb[i]);
      s[0] += f;
      ss[0] = fmaf(f, f, ss[0]);
    }
  }
#pragma unroll
  for (int u = 1; u < U; ++u) {
    s[0] += s[u];
    ss[0] += ss[u];
  }
  __shared__ float2 red[STATS_THREADS / 32];
  __shared__ int last;
  const float2 tot = stats_block_sum(make_float2(s[0], ss[0]), red);
  if (tid == 0) {
    reinterpret_cast<float2*>(part)[(size_t)b * P + p] = tot;
    __threadfence();                           // the partial before the ticket
    last = atomicAdd(ticket + b, 1u) == (unsigned)(P - 1);
  }
  __syncthreads();
  if (!last) return;
  __shared__ float m1_s, rstd_s;
  if (tid < 32) {
    __threadfence();
    const float2* pb = reinterpret_cast<const float2*>(part) + (size_t)b * P;
    float2 v = make_float2(0.0f, 0.0f);
    for (int q = tid; q < P; q += 32) {        // from L2: other blocks wrote them
      const float2 w = __ldcg(pb + q);
      v.x += w.x;
      v.y += w.y;
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, m);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, m);
    }
    if (tid == 0) {
      const float m1 = v.x / (float)L, m2 = v.y / (float)L;
      m1_s = m1;
      rstd_s = rsqrtf(fmaxf(m2 - m1 * m1, 0.0f) + eps);
      ticket[b] = 0u;                          // every block of b has taken its ticket
    }
  }
  __syncthreads();
  const float m1 = m1_s, rstd = rstd_s;
  for (int k = tid; k < H; k += STATS_THREADS) {
    const float av = to_f<W>(gw[k]) * rstd;
    a[(size_t)b * H + k] = av;
    b2[(size_t)b * H + k] = to_f<W>(gb[k]) - m1 * av;
  }
}

template <typename T>
int launch_gln_stats(int wdtype, const T* c, const void* gw, const void* gb, float* part,
                     unsigned int* ticket, float* a, float* b2, int B, long long L, int H, int P,
                     float eps, int vec, cudaStream_t stream) {
  const dim3 grid(P, B);
  if (wdtype == 0)
    tcn_gln_stats_kernel<T, float><<<grid, STATS_THREADS, 0, stream>>>(
        c, static_cast<const float*>(gw), static_cast<const float*>(gb), part, ticket, a, b2, L,
        H, P, eps, vec);
  else if (wdtype == 1)
    tcn_gln_stats_kernel<T, __nv_bfloat16><<<grid, STATS_THREADS, 0, stream>>>(
        c, static_cast<const __nv_bfloat16*>(gw), static_cast<const __nv_bfloat16*>(gb), part,
        ticket, a, b2, L, H, P, eps, vec);
  else if (wdtype == 2)
    tcn_gln_stats_kernel<T, __half><<<grid, STATS_THREADS, 0, stream>>>(
        c, static_cast<const __half*>(gw), static_cast<const __half*>(gb), part, ticket, a, b2,
        L, H, P, eps, vec);
  else
    return cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T, typename F>
int with_tail16(int kc, F&& f) {
  using std::integral_constant;
  if (kc == 64) return f((T*)nullptr, integral_constant<int, 64>{});
  if (kc == 32) return f((T*)nullptr, integral_constant<int, 32>{});
  if (kc == 16) return f((T*)nullptr, integral_constant<int, 16>{});
  return cudaErrorInvalidValue;
}

template <typename F>
int with_tail(int dtype, int kc, F&& f) {
  using std::integral_constant;
  if (dtype == 1) return with_tail16<__nv_bfloat16>(kc, f);
  if (dtype == 2) return with_tail16<__half>(kc, f);
  if (dtype == 0) {
    if (kc == 32) return f((float*)nullptr, integral_constant<int, 32>{});
    if (kc == 16) return f((float*)nullptr, integral_constant<int, 16>{});
    if (kc == 8) return f((float*)nullptr, integral_constant<int, 8>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. The plan (kc: channels a chunk; stages:
// the ring, 3 in bfloat16 and float16, 2 in float32; blocks: persistent blocks; smem: bytes of
// dynamic shared memory) is ops/tcn.py `tail_plan`'s. vec: every row of c, x, w_rs, w_dw and
// a / b2, and every pointer, 16-byte aligned (16-byte copies). Returns the CUDA
// error of the launch (0 on success).
extern "C" int tcn_tail_launch(int dtype, const void* c, const void* x, const float* a,
                               const float* b2, const void* w_dw, const void* b_dw,
                               const void* w_rs, const void* b_rs, void* e, void* s, int B,
                               int Tn, int H, int Bc, int d, int kc, int stages, int blocks,
                               int smem, int vec, cudaStream_t stream) {
  if (B < 1 || Tn < 1 || H < 1 || Bc < 1 || d < 1 || blocks < 1) return cudaErrorInvalidValue;
  Args A{};
  A.c = c; A.x = x; A.a = a; A.b2 = b2; A.w_dw = w_dw; A.b_dw = b_dw; A.w_rs = w_rs; A.b_rs = b_rs;
  A.e = e; A.s = s;
  A.B = B; A.T = Tn; A.H = H; A.Bc = Bc; A.d = d;
  A.tiles_t = (Tn + BM - 1) / BM;
  A.tiles_n = (2 * Bc + BN - 1) / BN;
  const long long ntiles = (long long)B * A.tiles_t * A.tiles_n;
  if (ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  A.ntiles = (int)ntiles;
  A.stages = stages;
  A.vec = vec;
  return with_tail(dtype, kc, [&](auto* ty, auto kk) {
    using T = std::remove_pointer_t<decltype(ty)>;
    constexpr int KC = decltype(kk)::value;
    constexpr bool BF = sizeof(T) == 2;        // bfloat16 or float16: wgmma
    if ((BF && stages != 3) || (!BF && stages != 2) ||
        smem != smem_bytes<T, KC>(d, stages))
      return (int)cudaErrorInvalidValue;
    void (*kernel)(const Args);
    if constexpr (BF) kernel = tcn_tail_wgmma_kernel<T, KC>;
    else kernel = tcn_tail_f32_kernel<KC>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = blocks < A.ntiles ? blocks : A.ntiles;
    kernel<<<grid, THREADS, smem, stream>>>(A);
    return (int)cudaGetLastError();
  });
}

// The gLN fold of c (B, T, H) in dtype (0 float32, 1 bfloat16, 2 float16) with gln_w /
// gln_b (H) in wdtype, in one launch of (P, B) blocks: part, a float32 (B, P, 2) scratch;
// ticket, B unsigned ints that are 0 before the launch and are 0 again after it; a and b2
// float32 (B, H). vec: c 16-byte aligned with T H a multiple of 16 bytes' elements.
extern "C" int tcn_gln_stats_launch(int dtype, int wdtype, const void* c, const void* gw,
                                    const void* gb, float* part, unsigned int* ticket, float* a,
                                    float* b2, int B, int Tn, int H, int P, float eps, int vec,
                                    cudaStream_t stream) {
  if (B < 1 || Tn < 1 || H < 1 || P < 1 || B > 65535 || P > 0x7fffffff / STATS_THREADS)
    return cudaErrorInvalidValue;
  const long long L = (long long)Tn * H;
  if (dtype == 0)
    return launch_gln_stats(wdtype, static_cast<const float*>(c), gw, gb, part, ticket, a, b2,
                            B, L, H, P, eps, vec, stream);
  if (dtype == 1)
    return launch_gln_stats(wdtype, static_cast<const __nv_bfloat16*>(c), gw, gb, part, ticket,
                            a, b2, B, L, H, P, eps, vec, stream);
  if (dtype == 2)
    return launch_gln_stats(wdtype, static_cast<const __half*>(c), gw, gb, part, ticket, a, b2,
                            B, L, H, P, eps, vec, stream);
  return cudaErrorInvalidValue;
}
