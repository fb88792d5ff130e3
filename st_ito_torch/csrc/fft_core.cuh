// Block-cooperative float32 butterfly FFTs in shared memory, the device code
// under the FFT kernels of mega_fft.cu (K5, K3, K4) and fused_fft.cu (K10),
// and the host helpers that size their tiles.
//
// A block holds `rows` independent power-of-two transforms of one length in
// shared memory, one per row of row_pitch(len) float2 elements. Element i of
// a row sits at offset sw(i) = i + i/16: one pad element after every 16
// keeps a thread's neighbouring elements (the last layers) in other banks
// than the next thread's, and kPad more between rows staggers the rows over
// the banks for the tile loads and stores that walk across them. All
// threads of the block share the work of every step; steps are separated by
// __syncthreads(). The transform (fft_rows_dif_wide) is decimation in
// frequency, natural order in and bit-reversed order out, so each pass
// loads its contiguous global side in natural order and walks the
// bit-reversed side in shared-memory order: radix-2 butterflies, taken up
// to five layers at a time (a thread loads the 2 to 32 elements that those
// layers combine among themselves, runs the layers in registers and stores
// them back in place), so a 512- or 1024-point transform is 2 trips through
// shared memory, with as many barriers.
//
// Twiddles come from a table of W_L^j = exp(-2 pi i j / L), j < L/2, made in
// float64 on the host (L the longer of the two lengths of the four-step
// split); load_twiddles() copies the len/2 entries a block needs into shared
// memory. The inverse transform conjugates them. No fast-math intrinsics.
//
// The four-step split of n = n1*n2 (n1 >= n2, both powers of two) that both
// files use: a pass of transforms over tiles of 2^log_cw adjacent columns,
// a pass over tiles of whole rows, each tile sized by tile_log() to fit
// kTileBytes of shared memory beside the twiddles.

#pragma once

#include <cuda_runtime.h>

namespace fftcore {

constexpr int kPad = 4;  // float2 elements between the rows of a tile

// offset of element i within its row
__host__ __device__ __forceinline__ int sw(int i) { return i + (i >> 4); }

__host__ __device__ __forceinline__ int row_pitch(int len) {
  return sw(len) + kPad;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ int bitrev(int v, int log_len) {
  return static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - log_len));
}

// tw_s[j] = W_len^j for j < half = len/2, from the table of W_L^j with
// stride = L / len.
__device__ __forceinline__ void load_twiddles(float2* tw_s,
                                              const float2* __restrict__ tw_g,
                                              int half, int stride) {
  for (int j = threadIdx.x; j < half; j += blockDim.x)
    tw_s[j] = tw_g[(long long)j * stride];
}

template <bool kInverse>
__device__ __forceinline__ float2 twiddle(const float2* tw_s, int idx) {
  float2 w = tw_s[idx];
  if (kInverse) w.y = -w.y;
  return w;
}

// One decimation-in-frequency step: the L layers whose half sizes are
// 2^lh, 2^(lh-1), ..., 2^(lh-L+1). A thread's R = 2^L elements sit at
// stride 2^(lh+1-L) in one block of 2^(lh+1); register m of layer l is at
// position ((m mod (R >> l)) << ls) + j of its layer's block. With kHalf
// the transform's last layer (half size 1) forms only a + b, the outputs at
// even positions: the bins below len/2.
template <int L, bool kInverse, bool kHalf = false>
__device__ __forceinline__ void dif_step(float2* s, int rows, int pitch,
                                         int log_len, int lh,
                                         const float2* tw_s) {
  constexpr int R = 1 << L;
  const int ls = lh + 1 - L;
  const int log_per_row = log_len - L;
  const int total = rows << log_per_row;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int r = t >> log_per_row;
    const int u = t & ((1 << log_per_row) - 1);
    const int j = u & ((1 << ls) - 1);
    float2* p = s + r * pitch;
    const int e = ((u >> ls) << (lh + 1)) | j;
    float2 v[R];
#pragma unroll
    for (int m = 0; m < R; ++m) v[m] = p[sw(e + (m << ls))];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int dist = R >> (l + 1);
      const int tw_shift = log_len - 1 - lh + l;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if ((m & dist) != 0) continue;
        const int pos = ((m & (2 * dist - 1)) << ls) + j;
        const float2 a = v[m];
        const float2 b = v[m + dist];
        v[m] = make_float2(a.x + b.x, a.y + b.y);
        if (kHalf && lh == l) continue;  // the last layer, pruned
        v[m + dist] = cmul(make_float2(a.x - b.x, a.y - b.y),
                           twiddle<kInverse>(tw_s, pos << tw_shift));
      }
    }
#pragma unroll
    for (int m = 0; m < R; ++m) p[sw(e + (m << ls))] = v[m];
  }
}

// Decimation in frequency in steps of up to kMaxL layers (3 to 5; 5 is 32
// elements a thread in registers): with 5, 2 trips through shared memory
// for a 512- or 1024-point transform, with 3, 3 or 4. With kHalf the last
// layer is pruned to the outputs at even positions (dif_step). Begins and
// ends with a barrier, so the caller may fill the tile right before and
// read it right after.
__device__ __forceinline__ int wide_step_layers(int left, int cap) {
  return left <= cap ? left : min(cap, left - left / 2);
}

template <bool kInverse, bool kHalf, int kMaxL>
__device__ void fft_rows_dif_wide(float2* s, int rows, int pitch,
                                  int log_len, const float2* tw_s) {
  static_assert(kMaxL >= 3 && kMaxL <= 5, "3 to 5 layers a step");
  int lh = log_len - 1;
  while (lh >= 0) {
    const int L = wide_step_layers(lh + 1, kMaxL);
    __syncthreads();
    if constexpr (kMaxL >= 5) {
      if (L == 5) {
        dif_step<5, kInverse, kHalf>(s, rows, pitch, log_len, lh, tw_s);
        lh -= L;
        continue;
      }
    }
    if constexpr (kMaxL >= 4) {
      if (L == 4) {
        dif_step<4, kInverse, kHalf>(s, rows, pitch, log_len, lh, tw_s);
        lh -= L;
        continue;
      }
    }
    if (L == 3) {
      dif_step<3, kInverse, kHalf>(s, rows, pitch, log_len, lh, tw_s);
    } else if (L == 2) {
      dif_step<2, kInverse, kHalf>(s, rows, pitch, log_len, lh, tw_s);
    } else {
      dif_step<1, kInverse, kHalf>(s, rows, pitch, log_len, lh, tw_s);
    }
    lh -= L;
  }
  __syncthreads();
}

constexpr int kThreads = 256;            // threads of every FFT block
constexpr int kMaxTileLog = 4;           // at most 16 rows in a tile
constexpr size_t kTileBytes = 70 * 1024; // 16 rows of 512 or 8 of 1024 float2
constexpr int kMaxLogN = 24;             // k1*j2 stays exact in float32

struct Split {
  int n, n1, n2, log_n1, log_n2;
};

inline int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// log2 of the widest tile (at most 2^kMaxTileLog rows) of transforms of
// length len that fits kTileBytes
inline int tile_log(int len) {
  int lg = kMaxTileLog;
  while (lg > 0 &&
         (((size_t)row_pitch(len) * sizeof(float2)) << lg) > kTileBytes)
    --lg;
  return lg;
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

}  // namespace fftcore
