// The two-step 3D body (fused_pair_stream.cuh) at stencil order 3.

#include "fused_pair_stream.cuh"

GCM_PAIR_STREAM_ENTRY(3) {
    return (int)pair_stream<3>(u, mstack, out, *params, mat_bf16, device,
                                 (cudaStream_t)stream, occ);
}
