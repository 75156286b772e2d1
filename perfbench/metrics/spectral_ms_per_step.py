"""spectral_ms_per_step (fields): ms a step of the cuFFT and cuBLAS GEMM
kernel classes (the z FFTs and the radial DHT), their union on the
card."""
from perfbench.trace import class_pred


def read(ctx):
    if ctx.trace is None:
        return None
    pred = class_pred("FFT (cuFFT)", "GEMM / batched matmul (cuBLAS)")
    if ctx.trace.kernel_s(ctx.card, pred)[1] == 0:
        return None
    return ctx.per_step_ms(ctx.trace.union_s(ctx.card, pred))
