// LC103 fixture kernel source (never built): marks bad_kernel_pkg/ as a
// kernel package of the port.
__global__ void scale_kernel(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = 2.0f * x[i];
}
