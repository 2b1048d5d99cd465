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

// ---- row 10: out[b] = x[s + seg[b] : s + seg[b] + R, :], one block per
// segment, global -> shared -> global. s is a kernel argument read at run
// time; seg holds each segment's further row offset. The staging buffer is
// (R, width) or slot 0 of (2, R, width), the TPU probe's two forms: the
// second only asks for twice the shared memory.
__global__ void __launch_bounds__(128)
row_copy_kernel(const uint32_t* __restrict__ x, const int64_t* __restrict__ seg,
                uint32_t* __restrict__ out, int width, int R, int64_t s) {
  extern __shared__ uint32_t stage[];
  const int n = R * width;
  const uint32_t* src = x + (s + seg[blockIdx.x]) * (int64_t)width;
  for (int j = threadIdx.x; j < n; j += blockDim.x) stage[j] = src[j];
  __syncthreads();
  uint32_t* dst = out + (int64_t)blockIdx.x * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) dst[j] = stage[j];
}

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
enum ReshapeMode { MERGE_MINOR = 0, MERGE_MAJOR, SQUEEZE };

template <int MODE>
__global__ void __launch_bounds__(256)
reshape_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               int A, int Bm, int C) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)A * Bm * C) return;
  int k = (int)(t % C);
  int j = (int)((t / C) % Bm);
  int i = (int)(t / ((int64_t)C * Bm));
  uint32_t v = x[((int64_t)i * Bm + j) * C + k];
  int64_t o;
  if (MODE == MERGE_MINOR)        // (A, Bm, C) -> (A, Bm * C)
    o = (int64_t)i * ((int64_t)Bm * C) + ((int64_t)j * C + k);
  else if (MODE == MERGE_MAJOR)   // (A, Bm, C) -> (A * Bm, C)
    o = ((int64_t)i * Bm + j) * C + k;
  else                            // (A, 1, C) -> (A, C); j == 0
    o = (int64_t)i * C + k;
  out[o] = v;
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

// ---- row 17: out = x + 1 if any word of the tile is > 7, else x. One
// block owns the whole tile: one block-wide vote, then a branch that is
// uniform over the block.
__global__ void __launch_bounds__(256)
cond_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
            int n) {
  int mine = 0;
  for (int j = threadIdx.x; j < n; j += blockDim.x) mine |= x[j] > 7u;
  int any = __syncthreads_or(mine);
  if (any) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) out[j] = x[j] + 1u;
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x) out[j] = x[j];
  }
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

extern "C" int lsn_layout_row_copy(const void* x, const void* seg, void* out,
                                   int width, int R, long long nseg,
                                   long long s, int slots, void* stream) {
  if (width <= 0 || R <= 0 || nseg < 0 || slots < 1)
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)slots * R * width * sizeof(uint32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (nseg > 0)
    row_copy_kernel<<<(unsigned)nseg, 128, smem, (cudaStream_t)stream>>>(
        U32(x), (const int64_t*)seg, O32(out), width, R, (int64_t)s);
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

// one entry and one launch for each of rows 12-14 over the shared body
template <int MODE>
static int launch_reshape(const void* x, void* out, int A, int Bm, int C,
                          void* stream) {
  if (A <= 0 || Bm <= 0 || C <= 0 || (MODE == SQUEEZE && Bm != 1))
    return (int)cudaErrorInvalidValue;
  reshape_kernel<MODE><<<blocks_for((long long)A * Bm * C, 256), 256, 0,
                         (cudaStream_t)stream>>>(U32(x), O32(out), A, Bm, C);
  return (int)cudaGetLastError();
}

extern "C" int lsn_layout_reshape_merge_minor(const void* x, void* out, int A,
                                              int Bm, int C, void* stream) {
  return launch_reshape<MERGE_MINOR>(x, out, A, Bm, C, stream);
}

extern "C" int lsn_layout_reshape_merge_major(const void* x, void* out, int A,
                                              int Bm, int C, void* stream) {
  return launch_reshape<MERGE_MAJOR>(x, out, A, Bm, C, stream);
}

extern "C" int lsn_layout_squeeze(const void* x, void* out, int A, int Bm,
                                  int C, void* stream) {
  return launch_reshape<SQUEEZE>(x, out, A, Bm, C, stream);
}

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
  cond_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(U32(x), O32(out), n);
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
