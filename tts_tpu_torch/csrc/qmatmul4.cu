// x @ dequant(wq4, scales) on Hopper for packed int4 (Q4_0) weights: wq4
// int8 [K/2, N] holds row i of the [K, N] weight in the low nibble and row
// i + K/2 in the high nibble of packed[i, n], both signed 4-bit; one f16
// scale per 32-row block and column, scales [K/32, N]; f32 out [M, N].
// K % 64 == 0, so packed block b (packed rows 32b .. 32b+31) holds scale
// block b in its low nibbles and scale block b + K/64 in its high ones.
//
// qgemv_int4 replaces tts_tpu/ops/qmatmul.py::_qmv4_kernel (M == 1, every
// decode step and the prefill's lm_head).  Bound: device-memory bytes,
// K/2 * N weight bytes + K/32 * N * 2 scale bytes over 3.35 TB/s: half the
// int8 weight bytes, the same scale bytes; about one multiply-add per
// weight, so tensor cores buy nothing.  It is qgemv_int8's kernel
// (qmatmul.cuh's qgemv_kernel) on the packed layout: a lane's 32-bit word
// of a packed row is 4 columns x rows i and i + K/2, unpacked to exact
// floats (PRMT + FADD), summed against x[i] and x[i + K/2] into one
// partial sum per plane, and at the end of each 32-row packed block each
// plane's f16 scale multiplies its sum (low plane first), the TPU
// kernel's per-block order.  What it does about the three causes that
// held the first GEMV at a ~15 us floor (72 CTAs at `o`):
//   - too few CTAs, too little in flight: 256-column CTAs (256-byte runs
//     of each packed row), K split by gemv_plan so one wave covers the
//     card at most one CTA per SM; each warp keeps two packed blocks
//     (2 x 4.5 KB) in flight through a cp.async ring and adds each
//     quarter block as it lands;
//   - dependent loads: both planes' slices of x are staged in shared
//     memory once, while the first blocks fly; both planes' scales are
//     copied with their block;
//   - two kernels per call: the splits add in a thread-block cluster
//     through distributed shared memory, in split order, and f32 or bf16
//     x is rounded to bf16 as it is staged: one launch per call.
// Small calls (Parler-TTS mini v1's 0.6-2.4 MB) take the kernel's
// small-call instance instead (qmatmul.cu, qmatmul.cuh gemv_small).
// The TPU kernel's block-diagonal expansion of x feeds its MXU and has no
// purpose here.
//
// qgemm_int4 replaces ::_qmm4_kernel (M > 1: prefill; later speculative
// verify at M = 8 and Dia's batch-2 steps).  Bound: the weight bytes over
// 3.35 TB/s at every M up to a few hundred (2*M*K*N over 989 TFLOP/s only
// past that), so the kernel has to keep the whole card streaming weights.
// It is qmatmul.cuh's qgemm_kernel, shared with qgemm_int8:
//   - tensor cores: mma.sync m16n8k16, bf16 in, f32 accumulate.  Weight
//     columns sit on the MMA's 16-row side and tokens on its 8-wide side, so
//     M = 8 fills a fragment.  Nibbles become their exact integers -8..7 in
//     bf16 (bits 0x4300 | (u ^ 8) are 136 + q; one bf16x2 FMA takes 136
//     off).  bf16 x (what the prefill passes) runs one product; f32 x is
//     split into hi = bf16(x) and lo = bf16(x - hi) and both products run,
//     so the sum keeps ~16 bits of x (the f32 plain version's 1e-4 holds;
//     bf16(x) alone would not).  Each 32-row block's f16 scale multiplies
//     that block's f32 partial sum, the order of _qmv4_kernel.
//   - split-K: a CTA takes 128 or 256 columns, up to 64 tokens and a range
//     of whole packed blocks (a packed row pairs x columns k and K/2 + k, so
//     a block is never cut); the host plan (ops/qmatmul.py::gemm_plan)
//     picks the tile and the split so every Orpheus-3B shape launches >= 132
//     CTAs, and a second pass adds the splits in order (no atomics:
//     identical bits every run).  256 columns read each weight row in
//     256-byte runs, which the 8- and 16-token tiles, bound by the weight
//     stream, run faster on where there are CTAs enough.
//   - a ring of TTS_G4_STAGES stages of cp.async copies (weights, both
//     planes' scales, the x slices of both planes) keeps three packed
//     blocks in flight while the tensor cores work on the fourth.
// The TPU kernel's block-diagonal expansion of x has no purpose here.
#include "qmatmul.cuh"

// x [K] bf16 (x_f32: f32); the geometry of ops/qmatmul.py::gemv_plan: rows 0,
// the cluster instance (K split into `splits` ranges of `per` packed blocks, the
// splits of a column tile one cluster); rows > 0, the small-call instance
// (rows weight rows a thread, tile_n columns a CTA)
extern "C" int qgemv_int4(const void* x, int x_f32, const void* wq4, const void* scales, void* out,
                          int K, int N, int tile_n, int splits, int per, int rows, void* stream) {
  return tts::launch_qgemv<true>(x, x_f32, wq4, scales, out, K, N, tile_n, splits, per, rows,
                                  stream);
}

// x [M, K] bf16 (x_f32: f32); geometry from ops/qmatmul.py::gemm_plan, per
// in packed blocks (qmatmul.cuh launch_qgemm)
extern "C" int qgemm_int4(const void* x, int x_f32, const void* wq4, const void* scales,
                          void* partial, void* out, int M, int K, int N, int m_tile, int tile_n,
                          int splits, int per, void* stream) {
  return tts::launch_qgemm<true>(x, x_f32, wq4, scales, partial, out, M, K, N, m_tile, tile_n,
                                 splits, per, stream);
}
