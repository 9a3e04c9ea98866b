// Layer markers of the program's spans: one empty one-thread kernel a layer,
// extern "C" so that a profiler's trace prints mvae_span_<layer> as it is.
// A marker launched on a stream marks where its layer starts on the device;
// the layer runs until the next marker. The layers are
// mvae_torch/utils/profiling.py's LAYERS, which the build passes in as
// -DMVAE_SPAN_LAYERS=MVAE_SPAN(<first>)MVAE_SPAN(<second>)...
// (kernels/_build.py), so the list is written once.
#include <cuda_runtime.h>

#ifndef MVAE_SPAN_LAYERS
#error "MVAE_SPAN_LAYERS is given by kernels/_build.py from profiling.LAYERS"
#endif

#define MVAE_SPAN(layer) \
    extern "C" __global__ void mvae_span_##layer() {}
MVAE_SPAN_LAYERS
#undef MVAE_SPAN

#define MVAE_SPAN(layer) reinterpret_cast<const void*>(&mvae_span_##layer),
static const void* const kMarkers[] = {MVAE_SPAN_LAYERS};
#undef MVAE_SPAN

static const int kCount = sizeof(kMarkers) / sizeof(kMarkers[0]);

extern "C" int mvae_span_count() { return kCount; }

// Launch the marker of LAYERS[layer] on `stream`; returns a cudaError_t.
extern "C" int mvae_span_launch(int layer, void* stream) {
  if (layer < 0 || layer >= kCount) return cudaErrorInvalidValue;
  return cudaLaunchKernel(kMarkers[layer], dim3(1), dim3(1), nullptr, 0,
                          static_cast<cudaStream_t>(stream));
}
