"""Host<->device transfer and the build of the hand-written CUDA
kernels under csrc/."""
