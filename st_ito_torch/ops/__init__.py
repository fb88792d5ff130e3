"""Population-rendering DSP: biquad design, compressor helpers, the fused-LTI
FFT glue and the hand-written kernels' wrappers (``ops/kernels``)."""
