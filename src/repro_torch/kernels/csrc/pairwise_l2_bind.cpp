// The host half of K1's launch (csrc/pairwise_l2.cu), bound to Python with
// PyTorch's own tensor type.  Compiled by the host compiler against
// PyTorch's headers (no CUDA code here): it allocates K1's output buffer,
// calls the library's C launch function, and returns S0, lo, hi (and rng)
// as views of the buffer.  Made in Python (an allocation, three or four
// strided views and a ctypes call), they took several times the kernel's
// device time at the LM FL path's shape, and more than torch.cdist's call.
//
// Each call takes the addresses of the library's pairwise_l2_dists_stats and
// pairwise_l2_error_string (from ctypes), so the binding keeps no state.

#include <torch/extension.h>

#include <cstdint>
#include <tuple>

namespace {

using Launch = int (*)(const void*, int, int, int, float*, float*, void*, void*);
using ErrorString = const char* (*)(int);

// Launches K1 (the library's function at `launch`) on `stream` of F's
// device with F (C, Q) fp32 or bf16, contiguous; `n` floats of output (S0,
// lo, hi, rng, the tiles' minima and maxima) and `ticket`, the launch's
// counter.  Raises with the error string of a refused launch.
at::Tensor run(const at::Tensor& f, int64_t launch, int64_t error_string, int64_t n, int64_t ticket,
               int64_t stream) {
  const c10::OptionalDeviceGuard guard(f.device());  // switches only for another device
  const int64_t c = f.size(0);
  at::Tensor buf = at::empty({n}, f.options().dtype(at::kFloat));
  float* p = buf.data_ptr<float>();
  const int err = reinterpret_cast<Launch>(launch)(
      f.data_ptr(), f.scalar_type() == at::kBFloat16, static_cast<int>(c), static_cast<int>(f.size(1)), p,
      p + c * c, reinterpret_cast<void*>(ticket), reinterpret_cast<void*>(stream));
  TORCH_CHECK(err == 0, "pairwise_dists_stats launch failed: CUDA error ", err, " (",
              reinterpret_cast<ErrorString>(error_string)(err), ")");
  return buf;
}

}  // namespace

std::tuple<at::Tensor, at::Tensor, at::Tensor> dists_stats(const at::Tensor& f, int64_t launch,
                                                           int64_t error_string, int64_t n, int64_t ticket,
                                                           int64_t stream) {
  const int64_t c = f.size(0);
  const at::Tensor buf = run(f, launch, error_string, n, ticket, stream);
  return {buf.as_strided({c, c}, {c, 1}), buf.as_strided({}, {}, c * c), buf.as_strided({}, {}, c * c + 1)};
}

std::tuple<at::Tensor, at::Tensor, at::Tensor, at::Tensor> dists_range(const at::Tensor& f, int64_t launch,
                                                                       int64_t error_string, int64_t n,
                                                                       int64_t ticket, int64_t stream) {
  const int64_t c = f.size(0);
  const at::Tensor buf = run(f, launch, error_string, n, ticket, stream);
  return {buf.as_strided({c, c}, {c, 1}), buf.as_strided({}, {}, c * c), buf.as_strided({}, {}, c * c + 1),
          buf.as_strided({}, {}, c * c + 2)};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("dists_stats", &dists_stats, "K1: (S0, lo, hi)");
  m.def("dists_range", &dists_range, "K1: (S0, lo, hi, rng)");
}
