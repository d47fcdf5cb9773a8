// One pass at each junction between the HiFi-GAN generator's convolutions,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no HiFi-GAN generator. It was
// added because the generator's length masks, LeakyReLUs, residual and
// block sums and its convolutions' bias adds ran as separate PyTorch
// elementwise launches between cuDNN's convolutions, each reading and
// writing a whole activation: 284 of the 536 ms of device time a masked
// call of 128 rows x 480 frames took on an H100 (masks 82, bias adds 81,
// LeakyReLUs 64, residual and block sums 54; one activation of the last
// stage is 2.36 GB).
//
// What bounds it on the H100: bytes. A junction does a few flops per
// element and reads one to three activations and writes one or two, so its
// least time is the bytes it moves over 3.35 TB/s.
//
// What the design does about it: one launch reads the convolution's output
// once and writes only what the next convolution (or the stage's running
// sum) reads. The length mask is computed from `lengths` (int64, one per
// row) and the stage's scale, m = (t < lengths[b] * scale), so no mask
// tensor is read; without `lengths` nothing is masked. The grid indexes
// time chunks, channels and rows (x, y, z); a thread moves one float4 of
// every array, and the first block of a row moves the row's scalar head and
// tail around its 16-byte-aligned body.
//
// The arithmetic is PyTorch's eager sequence on the card, bit for bit: the
// mask is a multiply by 1.0 or 0.0 (signed zeros as `mul_` leaves them),
// LeakyReLU is v > 0 ? v : v * slope, the sums keep PyTorch's order, and
// the mean over the blocks is a multiply by the f32 reciprocal of their
// count, which is what CUDA's `div_` by a Python scalar computes. Multiplies
// and adds are __fmul_rn / __fadd_rn so that nvcc contracts none into an FMA.
//
// Each element passes through
//   c += bias[ch];  v = m * c;  v += res (RES);  v = total + v (ACC);
//   v *= 1/n (SCALE)
// and the flags store v (STORE_V) and LeakyReLU(v) (STORE_A). The bias is
// the convolution's, which PyTorch adds to a cuDNN convolution's output in
// a pass of its own: the generator runs its convolutions without it, so
// cuDNN sees the same calls, and the junction adds it as that pass did. The
// modes, kernels/hifigan.py's names for the flag sets:
//   J0 after a transposed convolution:  c := m*c,          act := lrelu(c)
//   J1 after a convs1 (or input_conv):  c := lrelu(m*c)
//   J2 after a convs2 but the last:     c := m*c + res,    act := lrelu(c)
//   J3 after a block's last convs2:     the block's y = m*c + res folded into
//      the stage's sum: the first block stores y in c, a middle one adds it
//      to total, the last stores lrelu((total + y) / n) (with one block,
//      lrelu(y / n)) in total (or c).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int THREADS = 256;

enum : int {
  RES = 1,
  ACC = 2,
  SCALE = 4,
  STORE_V = 8,
  STORE_A = 16,
};

template <int F>
__device__ __forceinline__ void junction(float c, float bias, float r, float tot, float m,
                                         float slope, float inv, float& v, float& a) {
  v = __fmul_rn(__fadd_rn(c, bias), m);
  if (F & RES) v = __fadd_rn(v, r);
  if (F & ACC) v = __fadd_rn(tot, v);
  if (F & SCALE) v = __fmul_rn(v, inv);
  a = v > 0.f ? v : __fmul_rn(v, slope);
}

template <int F>
__device__ __forceinline__ void one(size_t i, long long t, long long limit, float bias,
                                    const float* c, const float* res, const float* tot,
                                    float* out_v, float* out_a, float slope, float inv) {
  float v, a;
  junction<F>(c[i], bias, (F & RES) ? res[i] : 0.f, (F & ACC) ? tot[i] : 0.f,
              t < limit ? 1.f : 0.f, slope, inv, v, a);
  if (F & STORE_V) out_v[i] = v;
  if (F & STORE_A) out_a[i] = a;
}

// Every pointer is 16-byte aligned (checked by the host), so a row's body
// starts where its offset is a multiple of 4 floats.
template <int F>
__global__ void __launch_bounds__(THREADS)
    hj_kernel(const float* c, const float* bias, const float* res, const float* tot, float* out_v,
              float* out_a, const long long* lengths, int C, int T, long long scale, float slope,
              float inv) {
  const int b = blockIdx.z;
  const size_t row = ((size_t)b * C + blockIdx.y) * (size_t)T;
  const long long limit = lengths != nullptr ? lengths[b] * scale : LLONG_MAX;
  const float bv = bias[blockIdx.y];
  const int head = min((int)((4 - (row & 3)) & 3), T);
  const int n_vec = (T - head) / 4;
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k < n_vec) {
    const int t0 = head + 4 * k;
    const size_t i = row + t0;
    const float4 cv = *reinterpret_cast<const float4*>(c + i);
    float4 rv = make_float4(0.f, 0.f, 0.f, 0.f), tv = rv, vv, av;
    if (F & RES) rv = *reinterpret_cast<const float4*>(res + i);
    if (F & ACC) tv = *reinterpret_cast<const float4*>(tot + i);
    junction<F>(cv.x, bv, rv.x, tv.x, t0 < limit ? 1.f : 0.f, slope, inv, vv.x, av.x);
    junction<F>(cv.y, bv, rv.y, tv.y, t0 + 1 < limit ? 1.f : 0.f, slope, inv, vv.y, av.y);
    junction<F>(cv.z, bv, rv.z, tv.z, t0 + 2 < limit ? 1.f : 0.f, slope, inv, vv.z, av.z);
    junction<F>(cv.w, bv, rv.w, tv.w, t0 + 3 < limit ? 1.f : 0.f, slope, inv, vv.w, av.w);
    if (F & STORE_V) *reinterpret_cast<float4*>(out_v + i) = vv;
    if (F & STORE_A) *reinterpret_cast<float4*>(out_a + i) = av;
  }
  if (blockIdx.x == 0) {
    const int tail = head + 4 * n_vec;
    const int j = threadIdx.x;
    if (j < head) {
      one<F>(row + j, j, limit, bv, c, res, tot, out_v, out_a, slope, inv);
    } else if (j >= 4 && tail + j - 4 < T) {
      one<F>(row + tail + j - 4, tail + j - 4, limit, bv, c, res, tot, out_v, out_a, slope, inv);
    }
  }
}

template <int F>
int launch(const float* c, const float* bias, const float* res, const float* tot, float* out_v,
           float* out_a, const long long* lengths, int B, int C, int T, long long scale,
           float slope, float inv, cudaStream_t stream) {
  const int n_vec = T / 4;
  const dim3 grid(n_vec > 0 ? (n_vec + THREADS - 1) / THREADS : 1, C, B);
  hj_kernel<F><<<grid, THREADS, 0, stream>>>(c, bias, res, tot, out_v, out_a, lengths, C, T,
                                               scale, slope, inv);
  return (int)cudaGetLastError();
}

}  // namespace

// The flag bits, for the Python side to hold its own against: {RES, ACC,
// SCALE, STORE_V, STORE_A}.
extern "C" void hj_flags(int* out) {
  out[0] = RES;
  out[1] = ACC;
  out[2] = SCALE;
  out[3] = STORE_V;
  out[4] = STORE_A;
}

// One junction over c (B, C, T) f32, contiguous, and bias (C,), on
// `stream`. res and tot (c's shape) are read where the flags say (else
// null); out_v and out_a are written where the flags say, and may be c (or
// tot) itself. lengths is (B,) int64 or null (no mask). inv = 1.0f / n_blocks,
// as CUDA's div_ by a scalar takes it. Takes the seven flag sets of J0-J3
// and 16-byte-aligned pointers. Returns
// cudaGetLastError() after the launch; nothing is synchronised.
extern "C" int hj_run(int flags, const float* c, const float* bias, const float* res,
                      const float* tot, float* out_v, float* out_a, const long long* lengths,
                      int B, int C, int T, long long scale, float slope, int n_blocks,
                      void* stream_ptr) {
  if (B <= 0 || B > 65535 || C <= 0 || C > 65535 || T <= 0 || scale <= 0 || n_blocks <= 0 ||
      bias == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t addresses = reinterpret_cast<size_t>(c) | reinterpret_cast<size_t>(res) |
                           reinterpret_cast<size_t>(tot) | reinterpret_cast<size_t>(out_v) |
                           reinterpret_cast<size_t>(out_a);
  if (addresses % 16 != 0) return (int)cudaErrorInvalidValue;
  const float inv = 1.0f / (float)n_blocks;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream_ptr);
#define HJ_CASE(F) \
  case (F):        \
    return launch<(F)>(c, bias, res, tot, out_v, out_a, lengths, B, C, T, scale, slope, inv, s);
  switch (flags) {
    HJ_CASE(STORE_V | STORE_A)                     // J0
    HJ_CASE(STORE_A)                               // J1
    HJ_CASE(RES | STORE_V | STORE_A)               // J2
    HJ_CASE(RES | STORE_V)                         // J3, the first of several blocks
    HJ_CASE(RES | ACC | STORE_V)                   // J3, a middle block
    HJ_CASE(RES | ACC | SCALE | STORE_A)           // J3, the last of several blocks
    HJ_CASE(RES | SCALE | STORE_A)                 // J3, the only block
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HJ_CASE
}
