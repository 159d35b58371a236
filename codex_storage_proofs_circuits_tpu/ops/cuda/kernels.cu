// XLA FFI handlers for the lane kernels of lanes.h.
//
// nvcc builds this file for the GPU: each handler launches one thread per
// lane on the stream XLA hands it, and registers for platform "CUDA".  A
// C++ compiler builds the same file for the CPU (no __CUDACC__): each
// handler then loops over the lanes, which is how the CPU tests run the
// kernels' arithmetic and the Python wrappers around them.
//
// Every array is uint32 limb planes with the lane axis last; the lane count
// B is the last dimension of the first operand.

#include <cstdint>

#include "lanes.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
using U32 = ffi::Buffer<ffi::U32>;
using U32Out = ffi::ResultBuffer<ffi::U32>;

#ifdef __CUDACC__
#define OP_FN __device__ __forceinline__

template <typename Op>
__global__ void run_lanes(Op op, int64_t B) {
  int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) op(b);
}

constexpr int kThreads = 128;

template <typename Op>
static ffi::Error for_lanes(cudaStream_t stream, Op op, int64_t B) {
  if (B > 0) run_lanes<<<(unsigned)((B + kThreads - 1) / kThreads), kThreads, 0, stream>>>(op, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

#define STREAM_PARAM cudaStream_t stream,
#define STREAM stream,
#define BIND() ffi::Ffi::Bind().Ctx<ffi::PlatformStream<cudaStream_t>>()
#else
#define OP_FN inline

template <typename Op>
static ffi::Error for_lanes(Op op, int64_t B) {
  for (int64_t b = 0; b < B; b++) op(b);
  return ffi::Error::Success();
}

#define STREAM_PARAM
#define STREAM
#define BIND() ffi::Ffi::Bind()
#endif

static int64_t lanes(const U32 &x) {
  auto d = x.dimensions();
  return d.size() ? d[d.size() - 1] : 1;
}

struct BnPermute {
  const uint32_t *in;
  uint32_t *out;
  int64_t B;
  OP_FN void operator()(int64_t b) const { bn_permute_lane(in, out, B, b); }
};

struct BnSponge {
  const uint32_t *felts;
  int64_t nf;
  uint32_t *out;
  int64_t B;
  OP_FN void operator()(int64_t b) const { bn_sponge_lane(felts, nf, out, B, b); }
};

struct BnMont {
  const uint32_t *in;
  uint32_t *out;
  int64_t B;
  int to;
  OP_FN void operator()(int64_t b) const { bn_mont_lane(in, out, B, b, to); }
};

struct GlSponge {
  const uint32_t *felts;
  int64_t nf;
  uint32_t *out;
  int64_t B;
  int monolith;
  OP_FN void operator()(int64_t b) const { gl_sponge_lane(felts, nf, out, B, b, monolith); }
};

struct GlCompress {
  const uint32_t *x, *y;
  uint32_t *out;
  int64_t B;
  uint64_t key;
  int monolith;
  OP_FN void operator()(int64_t b) const { gl_compress_lane(x, y, out, B, b, key, monolith); }
};

// (3, 16, B) -> (3, 16, B)
static ffi::Error BnPermuteImpl(STREAM_PARAM U32 x, U32Out y) {
  int64_t B = lanes(x);
  return for_lanes(STREAM BnPermute{x.typed_data(), y->typed_data(), B}, B);
}

// (nf, 16, B) canonical -> (16, B) Montgomery
static ffi::Error BnSpongeImpl(STREAM_PARAM U32 x, U32Out y) {
  int64_t B = lanes(x);
  int64_t nf = x.dimensions()[0];
  return for_lanes(STREAM BnSponge{x.typed_data(), nf, y->typed_data(), B}, B);
}

// (16, B) -> (16, B)
static ffi::Error BnMontImpl(STREAM_PARAM U32 x, U32Out y, int64_t to) {
  int64_t B = lanes(x);
  return for_lanes(STREAM BnMont{x.typed_data(), y->typed_data(), B, (int)to}, B);
}

// (nf, 4, B) -> (4, 4, B)
static ffi::Error GlSpongeImpl(STREAM_PARAM U32 x, U32Out y, int64_t monolith) {
  int64_t B = lanes(x);
  int64_t nf = x.dimensions()[0];
  return for_lanes(STREAM GlSponge{x.typed_data(), nf, y->typed_data(), B, (int)monolith}, B);
}

// (4, 4, B) x (4, 4, B) -> (4, 4, B)
static ffi::Error GlCompressImpl(STREAM_PARAM U32 x, U32 y, U32Out z, int64_t key,
                                 int64_t monolith) {
  int64_t B = lanes(x);
  return for_lanes(STREAM GlCompress{x.typed_data(), y.typed_data(), z->typed_data(), B,
                                     (uint64_t)key, (int)monolith},
                   B);
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(CspcBnPermute, BnPermuteImpl, BIND().Arg<U32>().Ret<U32>());
XLA_FFI_DEFINE_HANDLER_SYMBOL(CspcBnSponge, BnSpongeImpl, BIND().Arg<U32>().Ret<U32>());
XLA_FFI_DEFINE_HANDLER_SYMBOL(CspcBnMont, BnMontImpl,
                              BIND().Arg<U32>().Ret<U32>().Attr<int64_t>("to"));
XLA_FFI_DEFINE_HANDLER_SYMBOL(CspcGlSponge, GlSpongeImpl,
                              BIND().Arg<U32>().Ret<U32>().Attr<int64_t>("monolith"));
XLA_FFI_DEFINE_HANDLER_SYMBOL(CspcGlCompress, GlCompressImpl,
                              BIND().Arg<U32>().Arg<U32>().Ret<U32>().Attr<int64_t>("key").Attr<int64_t>(
                                  "monolith"));
