// Layout and row-copy probes for the card (no part of the proving path):
// the counterparts of the eleven TPU probe kernels of
// scripts/probe_mosaic_dma.py (dma_probe) and scripts/probe_mosaic_ops.py
// (t_transpose_big, t_reshape_merge, t_reshape_merge_major, t_squeeze,
// t_roll_dyn_lane, t_roll_dyn_sub3d, t_cond, t_dma_minor, t_fori_dyn,
// t_ref_dynslice).
//
// On the TPU those asked which layout operations Mosaic lowers at all. On
// this card every one of them compiles; the question with the same use is
// what each costs and what the compiler makes of it (a shared-memory round
// trip, a select chain, a register array that turns into local memory), as
// input to the design of the bucket kernels. So each kernel computes
// exactly its TPU counterpart's function on 32-bit words, is held against a
// plain PyTorch version (libsnark_tpu_torch/probes.py), and ptxas -v and
// cuobjdump -sass say what it became. The (8, 128) tiling of the TPU
// kernels means nothing here and is not carried over.
//
// Bound on the card: bytes (each input word read once, each output word
// written once); at the TPU scripts' shapes (4 to 128 KB) a launch is
// launch latency. row_copy also runs over many segments at the row widths
// bucket_reduce gathers, where the bytes count.
//
// Words are uint32_t; the wrappers carry them as int32 tensors.
#include <stdint.h>

#define ROW_COPY_UNROLL 4

// ---- row 10: out[b] = x[s + seg[b] : s + seg[b] + R, :]. s is a kernel
// argument read at run time; seg holds each segment's further row offset,
// or is null for one segment at 0. A segment is R * width contiguous words
// of x and of out, so the copy is flat: thread t moves piece t of the
// output (a 16-byte uint4 where the row width is a multiple of 4 words and
// both arrays are 16-byte aligned, else a word), piece t - b q of segment
// b = t / q, q pieces a segment. A warp thus serves as many segments as
// fit its 32 pieces (8 single-row segments of 16 words), every store of a
// warp is one contiguous 512-byte run and every load a run of 16-byte
// pieces inside a segment. The TPU probe's global -> VMEM -> global DMA
// is not part of the function, and a shared-memory stage in its place
// only adds a round trip and a barrier; the (2, R, width) staging form is
// the same copy. Bound: the bytes, R * width * 4 read and written a segment,
// and seg's 8 bytes.
template <typename T>
__global__ void __launch_bounds__(256)
row_copy_kernel(const T* __restrict__ x, const int64_t* __restrict__ seg,
                T* __restrict__ out, uint32_t q, uint32_t total,
                int64_t first, int64_t row) {
  // ROW_COPY_UNROLL pieces a thread an iteration, loaded before any is
  // stored: that many independent loads (and seg reads) in flight
  constexpr int U = ROW_COPY_UNROLL;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t t0 = blockIdx.x * blockDim.x + threadIdx.x; t0 < total;
       t0 += U * stride) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint32_t t = t0 + u * stride;
      if (t < total) {
        uint32_t b = t / q;
        v[u] = __ldg(x + first + (seg ? __ldg(seg + b) * row : 0) +
                     (t - b * q));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (t0 + u * stride < total) out[t0 + u * stride] = v[u];
  }
}

// The launch floor: a kernel that does nothing, launched as the layout
// kernels are, so that a probe's time can be read against the least time
// any launch takes in the same replayed CUDA graph.
__global__ void empty_kernel() {}

// ---- row 11: out[l, r, b] = x[b, r, l] for x (B, R, L): 32 x 32 tiles of
// the (b, l) plane through shared memory, padded to 33 columns so that the
// transposed read hits 32 different banks. Both the load and the store are
// coalesced along their own minor axis.
__global__ void __launch_bounds__(1024)
transpose_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 int B, int R, int L) {
  __shared__ uint32_t tile[32][33];
  const int r = blockIdx.y;
  const int b0 = blockIdx.z * 32, l0 = blockIdx.x * 32;
  int b = b0 + threadIdx.y, l = l0 + threadIdx.x;
  if (b < B && l < L)
    tile[threadIdx.y][threadIdx.x] = x[((int64_t)b * R + r) * L + l];
  __syncthreads();
  l = l0 + threadIdx.y;
  b = b0 + threadIdx.x;
  if (b < B && l < L)
    out[((int64_t)l * R + r) * B + b] = tile[threadIdx.x][threadIdx.y];
}

// ---- rows 12-14: reshapes of a contiguous (A, Bm, C) array. On linear
// memory each is a copy; the thread decomposes its element number by the
// SOURCE shape, loads from the source's strides and stores at the offset
// the DESTINATION shape gives, so equality checks the index arithmetic.
// At the TPU scripts' shapes (2,048-4,096 words) a launch is one short
// wave, so its time is the launch, one load's latency and the index
// arithmetic on the thread's path. All of that arithmetic is 32-bit (the
// wrapper refuses A Bm C >= 2^31) and it divides by C and Bm without a
// division instruction: n / d == (n m_d) >> s_d for n < 2^31, with the
// multiplier m_d < 2^32 and the shift s_d the host computes for each
// divisor (probes.div_magic; one wide multiply and a shift in place of
// the long sequence of a 64-bit division). A piece is a uint4 of four
// words where C is a multiple of four and both arrays are 16-byte aligned
// (the shape then holds in pieces: C / 4 of them a row), else a word.
// Each thread moves one piece a pass, over blocks of up to
// RESHAPE_THREADS: on an H100, spreading the pieces over that many threads
// ran faster than fewer threads taking several pieces each (one block of
// four warps, four pieces a thread, was the slowest form tried), and the
// index arithmetic cost no measurable time beside a flat copy.
#define RESHAPE_THREADS 256
enum ReshapeMode { MERGE_MINOR = 0, MERGE_MAJOR, SQUEEZE };

struct DivMagic {
  uint32_t m, s;                          // n / d == (n m) >> s, n < 2^31
};

__device__ __forceinline__ uint32_t div_magic(uint32_t n, DivMagic q) {
  return (uint32_t)(((uint64_t)n * q.m) >> q.s);
}

template <int MODE, typename T>
__global__ void __launch_bounds__(RESHAPE_THREADS)
reshape_kernel(const T* __restrict__ x, T* __restrict__ out, uint32_t Bm,
               uint32_t C, uint32_t total, DivMagic byC, DivMagic byB) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    uint32_t row = div_magic(t, byC);           // i Bm + j
    uint32_t k = t - row * C;
    uint32_t i = div_magic(row, byB);
    uint32_t j = row - i * Bm;
    T v = __ldg(x + ((i * Bm + j) * C + k));
    uint32_t o;
    if (MODE == MERGE_MINOR)        // (A, Bm, C) -> (A, Bm * C)
      o = i * (Bm * C) + (j * C + k);
    else if (MODE == MERGE_MAJOR)   // (A, Bm, C) -> (A * Bm, C)
      o = (i * Bm + j) * C + k;
    else                            // (A, 1, C) -> (A, C); j == 0
      o = i * C + k;
    out[o] = v;
  }
}

// ---- row 15: out[i, j] = x[i, (j - s) mod n], s a run-time argument of
// any sign or size. One block per row: the row goes to shared memory and
// every thread reads its rolled position back.
__global__ void __launch_bounds__(256)
roll_minor_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                  int n, int s) {
  extern __shared__ uint32_t row[];
  const uint32_t* src = x + (int64_t)blockIdx.x * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) row[j] = src[j];
  __syncthreads();
  int sh = s % n;
  if (sh < 0) sh += n;
  uint32_t* dst = out + (int64_t)blockIdx.x * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int q = j - sh;
    if (q < 0) q += n;
    dst[j] = row[q];
  }
}

// ---- row 16: out[a, r, l] = x[a, (r - s) mod 8, l] for x (A, 8, L): one
// thread per (a, l) holds the eight r-values in a per-thread array and
// reads it back at a run-time index. What the compiler makes of that
// (selects, or a stack frame in local memory) is the probe's question.
#define ROLL_R 8
__global__ void __launch_bounds__(256)
roll_middle_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                   int A, int L, int s) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)A * L) return;
  int64_t a = t / L, l = t % L;
  const uint32_t* src = x + a * ROLL_R * L + l;
  uint32_t v[ROLL_R];
#pragma unroll
  for (int r = 0; r < ROLL_R; ++r) v[r] = src[(int64_t)r * L];
  int sh = s % ROLL_R;
  if (sh < 0) sh += ROLL_R;
  uint32_t* dst = out + a * ROLL_R * L + l;
#pragma unroll
  for (int r = 0; r < ROLL_R; ++r)
    dst[(int64_t)r * L] = v[(r - sh + ROLL_R) % ROLL_R];
}

// ---- row 17: out = x + 1 (mod 2^32) if any word of the tile is > 7,
// else x. One block owns the tile, so the vote is one __syncthreads_or
// and the branch is uniform. The bound is the launch (16 KB at 3.35 TB/s
// is 5 ns), so the kernel crosses memory once and keeps every load of a
// thread in flight together: each thread issues all the loads of its
// words before it uses one, keeps the words in registers, takes the vote
// and stores from registers. Words move as 16-byte pieces (LDG.E.128 /
// STG.E.128) where both arrays are 16-byte aligned, else one word a load,
// so that any view works; either way neighbouring threads take
// neighbouring pieces. The registers hold the first COND_HELD words (the
// TPU script's (16, 128) tile is 2048: two pieces a thread), rounded down
// to whole pieces, and one more word a thread (the 1-3 words past the last
// whole piece). Only a tile larger than that is read twice, past those
// words: once in a loop to vote and once to store.
#define COND_THREADS 256
#define COND_PIECES 4                        // 4-word pieces held a thread
#define COND_HELD (COND_THREADS * COND_PIECES * 4)
__global__ void __launch_bounds__(COND_THREADS)
cond_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
            uint32_t n, int vec) {
  const uint32_t t = threadIdx.x;
  uint32_t held = min(n, (uint32_t)COND_HELD);
  if (vec) held &= ~3u;
  uint32_t v[COND_PIECES][4] = {};
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
#pragma unroll
    for (int u = 0; u < COND_PIECES; ++u) {
      uint32_t i = u * COND_THREADS + t;
      if (4 * i < held) {
        uint4 q = __ldg(xv + i);
        v[u][0] = q.x; v[u][1] = q.y; v[u][2] = q.z; v[u][3] = q.w;
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < COND_PIECES; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t j = (4 * u + k) * COND_THREADS + t;
        if (j < held) v[u][k] = __ldg(x + j);
      }
  }
  const uint32_t j1 = held + t;              // the thread's word past them
  const uint32_t w1 = j1 < n ? __ldg(x + j1) : 0u;
  int mine = w1 > 7u;
#pragma unroll
  for (int u = 0; u < COND_PIECES; ++u)
#pragma unroll
    for (int k = 0; k < 4; ++k) mine |= v[u][k] > 7u;    // unloaded: 0
  for (uint32_t j = held + COND_THREADS + t; j < n; j += COND_THREADS)
    mine |= __ldg(x + j) > 7u;
  const uint32_t inc = __syncthreads_or(mine) ? 1u : 0u;
  if (vec) {
    uint4* ov = reinterpret_cast<uint4*>(out);
#pragma unroll
    for (int u = 0; u < COND_PIECES; ++u) {
      uint32_t i = u * COND_THREADS + t;
      if (4 * i < held)
        ov[i] = make_uint4(v[u][0] + inc, v[u][1] + inc, v[u][2] + inc,
                           v[u][3] + inc);
    }
  } else {
#pragma unroll
    for (int u = 0; u < COND_PIECES; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t j = (4 * u + k) * COND_THREADS + t;
        if (j < held) out[j] = v[u][k] + inc;
      }
  }
  if (j1 < n) out[j1] = w1 + inc;
  for (uint32_t j = held + COND_THREADS + t; j < n; j += COND_THREADS)
    out[j] = x[j] + inc;
}

// ---- row 18: out[i, :] = x[i, s : s + W] for x (rows, total), s in
// words, read at run time and of any alignment: plain 4-byte loads (a
// 16-byte vector load or cp.async of 16 bytes would need s to be a
// multiple of four). One block per row, global -> shared -> global.
__global__ void __launch_bounds__(128)
window_copy_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                   int total, int W, int s) {
  extern __shared__ uint32_t win[];
  const uint32_t* src = x + (int64_t)blockIdx.x * total + s;
  for (int j = threadIdx.x; j < W; j += blockDim.x) win[j] = src[j];
  __syncthreads();
  uint32_t* dst = out + (int64_t)blockIdx.x * W;
  for (int j = threadIdx.x; j < W; j += blockDim.x) dst[j] = win[j];
}

// ---- row 19: a loop whose trip count comes from the data:
// n = max(x[0, :8]) mod 7, out = x added up n times.
__global__ void __launch_bounds__(256)
loop_dyn_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                int64_t numel) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= numel) return;
  uint32_t mx = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) mx = max(mx, x[k]);
  int n = (int)(mx % 7u);
  uint32_t v = x[t], acc = 0;
  for (int i = 0; i < n; ++i) acc += v;
  out[t] = acc;
}

// ---- row 20: in a loop, index on-chip data by the loop variable:
// out[a, l] = sum over i < n of x[a, 2 i, l] for x (A, 8, L). The eight
// values of a thread sit in a per-thread array; the trip count n (<= 4) is
// a run-time argument, so the index 2 i is not a constant. ptxas -v says
// whether the array got a stack frame.
__global__ void __launch_bounds__(256)
dynslice_sum_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                    int A, int L, int n) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)A * L) return;
  int64_t a = t / L, l = t % L;
  const uint32_t* src = x + a * ROLL_R * L + l;
  uint32_t v[ROLL_R];
#pragma unroll
  for (int r = 0; r < ROLL_R; ++r) v[r] = src[(int64_t)r * L];
  uint32_t acc = 0;
#pragma unroll 1
  for (int i = 0; i < n; ++i) acc += v[2 * i];
  out[t] = acc;
}

// ------------------------------------------------------------- C entries
#define U32(p) ((const uint32_t*)(p))
#define O32(p) ((uint32_t*)(p))

static inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// slots (1 or 2) only sizes the TPU probe's staging buffer, which the
// wrapper checks against 48 KB; the copy is the same
extern "C" int lsn_layout_row_copy(const void* x, const void* seg, void* out,
                                   int width, int R, long long nseg,
                                   long long s, int slots, void* stream) {
  if (width <= 0 || R <= 0 || nseg < 0 || slots < 1)
    return (int)cudaErrorInvalidValue;
  if (slots * (long long)R * width * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  long long words = nseg * R * width;
  if (words >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (words == 0) return (int)cudaGetLastError();
  bool vec = width % 4 == 0 && ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  int per = vec ? 4 : 1;                       // words a piece
  uint32_t q = (uint32_t)(R * width / per);
  uint32_t total = (uint32_t)(words / per);
  int threads = total < 256 ? (int)((total + 31) / 32 * 32) : 256;
  unsigned grid = blocks_for(total, threads * ROW_COPY_UNROLL);
  if (grid > 132 * 16) grid = 132 * 16;        // 16 blocks an SM, then a stride
  int64_t first = s * width / per, row = width / per;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* sg = (const int64_t*)seg;
  if (vec)
    row_copy_kernel<uint4><<<grid, threads, 0, st>>>(
        (const uint4*)x, sg, (uint4*)out, q, total, first, row);
  else
    row_copy_kernel<uint32_t><<<grid, threads, 0, st>>>(
        U32(x), sg, O32(out), q, total, first, row);
  return (int)cudaGetLastError();
}

extern "C" int lsn_layout_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int lsn_layout_transpose(const void* x, void* out, int B, int R,
                                    int L, void* stream) {
  if (B <= 0 || R <= 0 || L <= 0 || R > 65535 || (B + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((L + 31) / 32, R, (B + 31) / 32), block(32, 32);
  transpose_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(U32(x), O32(out),
                                                             B, R, L);
  return (int)cudaGetLastError();
}

// one entry and one launch for each of rows 12-14 over the shared body.
// vec: 16-byte pieces (C % 4 == 0, both arrays 16-byte aligned); (mC, sC)
// and (mB, sB) divide by the row length in pieces (C / 4 or C) and by Bm.
template <int MODE>
static int launch_reshape(const void* x, void* out, int A, int Bm, int C,
                          int vec, unsigned mC, unsigned sC, unsigned mB,
                          unsigned sB, void* stream) {
  if (A <= 0 || Bm <= 0 || C <= 0 || (MODE == SQUEEZE && Bm != 1) ||
      (long long)A * Bm * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (vec && (C % 4 != 0 || ((uintptr_t)x | (uintptr_t)out) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  uint32_t Cq = vec ? C / 4 : C;
  uint32_t total = (uint32_t)A * Bm * Cq;
  int threads = total < RESHAPE_THREADS ? (int)((total + 31) / 32 * 32)
                                        : RESHAPE_THREADS;
  unsigned grid = blocks_for(total, threads);
  if (grid > 132 * 16) grid = 132 * 16;        // 16 blocks an SM, then a stride
  DivMagic byC = {mC, sC}, byB = {mB, sB};
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    reshape_kernel<MODE, uint4><<<grid, threads, 0, st>>>(
        (const uint4*)x, (uint4*)out, (uint32_t)Bm, Cq, total, byC, byB);
  else
    reshape_kernel<MODE, uint32_t><<<grid, threads, 0, st>>>(
        U32(x), O32(out), (uint32_t)Bm, Cq, total, byC, byB);
  return (int)cudaGetLastError();
}

#define RESHAPE_ENTRY(NAME, MODE)                                            \
  extern "C" int NAME(const void* x, void* out, int A, int Bm, int C,        \
                      int vec, unsigned mC, unsigned sC, unsigned mB,        \
                      unsigned sB, void* stream) {                           \
    return launch_reshape<MODE>(x, out, A, Bm, C, vec, mC, sC, mB, sB,       \
                                stream);                                     \
  }
RESHAPE_ENTRY(lsn_layout_reshape_merge_minor, MERGE_MINOR)
RESHAPE_ENTRY(lsn_layout_reshape_merge_major, MERGE_MAJOR)
RESHAPE_ENTRY(lsn_layout_squeeze, SQUEEZE)

extern "C" int lsn_layout_roll_minor(const void* x, void* out, long long rows,
                                     int n, int s, void* stream) {
  if (rows < 0 || n <= 0 || (size_t)n * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (rows > 0)
    roll_minor_kernel<<<(unsigned)rows, 256, (size_t)n * 4,
                        (cudaStream_t)stream>>>(U32(x), O32(out), n, s);
  return (int)cudaGetLastError();
}

extern "C" int lsn_layout_roll_middle(const void* x, void* out, int A, int L,
                                      int s, void* stream) {
  if (A <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  roll_middle_kernel<<<blocks_for((long long)A * L, 256), 256, 0,
                       (cudaStream_t)stream>>>(U32(x), O32(out), A, L, s);
  return (int)cudaGetLastError();
}

extern "C" int lsn_layout_cond(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int vec = ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  cond_kernel<<<1, COND_THREADS, 0, (cudaStream_t)stream>>>(
      U32(x), O32(out), (uint32_t)n, vec);
  return (int)cudaGetLastError();
}

extern "C" int lsn_layout_window_copy(const void* x, void* out, long long rows,
                                      int total, int W, int s, void* stream) {
  if (rows < 0 || W <= 0 || s < 0 || (long long)s + W > total ||
      (size_t)W * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (rows > 0)
    window_copy_kernel<<<(unsigned)rows, 128, (size_t)W * 4,
                         (cudaStream_t)stream>>>(U32(x), O32(out), total, W, s);
  return (int)cudaGetLastError();
}

extern "C" int lsn_layout_loop_dyn(const void* x, void* out, long long numel,
                                   void* stream) {
  if (numel < 8) return (int)cudaErrorInvalidValue;
  loop_dyn_kernel<<<blocks_for(numel, 256), 256, 0, (cudaStream_t)stream>>>(
      U32(x), O32(out), (int64_t)numel);
  return (int)cudaGetLastError();
}

extern "C" int lsn_layout_dynslice_sum(const void* x, void* out, int A, int L,
                                       int n, void* stream) {
  if (A <= 0 || L <= 0 || n < 0 || 2 * n > ROLL_R)
    return (int)cudaErrorInvalidValue;
  dynslice_sum_kernel<<<blocks_for((long long)A * L, 256), 256, 0,
                        (cudaStream_t)stream>>>(U32(x), O32(out), A, L, n);
  return (int)cudaGetLastError();
}
