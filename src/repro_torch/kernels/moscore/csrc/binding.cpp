// Python binding of the moscore launchers in moscore.cu. The only source
// that includes PyTorch's headers, so nvcc never compiles them. The Python
// wrappers (moscore.py) check devices, dtypes, shapes and contiguity and
// allocate the outputs; this file takes the pointers, launches on PyTorch's
// current stream and checks the launch.

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/extension.h>

void moscore_hoisted_launch(const float* Tt, const float* Ent, const uint8_t* Ft,
                            const int32_t* gs, const float* q0, int32_t* choices,
                            float* q_final, int P, int W, float g, float omg,
                            cudaStream_t stream);

void moscore_launch(const float* Tt, const float* Et, const float* Mt,
                    const int32_t* gs, const float* q0, int32_t* choices,
                    float* q_final, int P, int W, float delta, float g, float omg,
                    cudaStream_t stream);

namespace {

void moscore_hoisted(const torch::Tensor& Tt, const torch::Tensor& Ent,
                     const torch::Tensor& Ft, const torch::Tensor& gs,
                     const torch::Tensor& q0, torch::Tensor& choices,
                     torch::Tensor& q_final, double gamma, double omg) {
  const c10::cuda::CUDAGuard guard(Tt.device());
  moscore_hoisted_launch(
      Tt.data_ptr<float>(), Ent.data_ptr<float>(),
      static_cast<const uint8_t*>(Ft.data_ptr()), gs.data_ptr<int32_t>(),
      q0.data_ptr<float>(), choices.data_ptr<int32_t>(),
      q_final.data_ptr<float>(), static_cast<int>(Tt.size(1)),
      static_cast<int>(gs.size(0)), static_cast<float>(gamma),
      static_cast<float>(omg), c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void moscore(const torch::Tensor& Tt, const torch::Tensor& Et,
             const torch::Tensor& Mt, const torch::Tensor& gs,
             const torch::Tensor& q0, torch::Tensor& choices,
             torch::Tensor& q_final, double delta, double gamma, double omg) {
  const c10::cuda::CUDAGuard guard(Tt.device());
  moscore_launch(Tt.data_ptr<float>(), Et.data_ptr<float>(),
                 Mt.data_ptr<float>(), gs.data_ptr<int32_t>(),
                 q0.data_ptr<float>(), choices.data_ptr<int32_t>(),
                 q_final.data_ptr<float>(), static_cast<int>(Tt.size(1)),
                 static_cast<int>(gs.size(0)), static_cast<float>(delta),
                 static_cast<float>(gamma), static_cast<float>(omg),
                 c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("moscore_hoisted", &moscore_hoisted,
        "hoisted Algorithm 1 window scan (CUDA)");
  m.def("moscore", &moscore, "unhoisted Algorithm 1 window scan (CUDA)");
}
