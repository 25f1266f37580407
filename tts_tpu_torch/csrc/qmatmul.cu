// x @ dequant(wq, scales) on Hopper: int8 weights wq [K, N] with one f16
// scale per 32-row block and column, scales [K/32, N]; f32 out [M, N].
//
// qgemv_int8 replaces tts_tpu/ops/qmatmul.py::_qmv_kernel (M == 1, every
// decode step and the prefill's lm_head).  Bound: device-memory bytes,
// K * N weight bytes + K/32 * N * 2 scale bytes over 3.35 TB/s.  At M = 1
// each weight byte feeds one multiply-add, far below the ~295 operations
// per byte at which the H100 stops waiting on memory: tensor cores buy
// nothing, and the design is about bytes in flight and fixed cost.  It is
// qmatmul.cuh's qgemv_kernel, shared with qgemv_int4.  What it does about
// the three causes that held the first GEMV at a ~15 us floor:
//   - too few CTAs, too little in flight: a CTA takes 256 columns (two
//     warps side by side, so each weight row is read in 256-byte runs)
//     and the host plan (ops/qmatmul.py::gemv_plan) splits K so that one
//     wave covers the card, at most one CTA per SM; each warp streams its
//     own 32-row blocks, two in flight through a cp.async ring, and adds
//     each quarter block as it lands;
//   - dependent loads: the CTA's slice of x is staged in shared memory
//     once, while the first blocks fly, and a block's scales are copied
//     with its rows;
//   - two kernels per call: the splits of a column tile are one
//     thread-block cluster and add their sums through distributed shared
//     memory in split order (identical bits every run, no global state),
//     and x is read as bf16 or f32 and rounded to bf16 as it is staged,
//     so a call is one launch with no cast kernel.
// That plan was tuned on Orpheus-3B.  A call of a few hundred KB to a few
// MB (Parler-TTS mini v1's linears) got 32 CTAs from it, half their warps
// idle, behind two cluster barriers: so gemv_plan gives such calls a second
// instance of the kernel (qmatmul.cuh gemv_small), whose narrow column
// tiles alone cover the card and whose CTAs each take all of K, split
// among their threads, with every weight load issued first and no cluster.
//
// qgemm_int8 replaces ::_qmm_kernel (M > 1: prefill; later Dia's cross-KV
// at M up to 2048).  Bound: the weight bytes over 3.35 TB/s at every M up
// to a few hundred (2*M*K*N over 989 TFLOP/s only past that).  It is
// qmatmul.cuh's qgemm_kernel, shared with qgemm_int4 (see qmatmul4.cu for
// the int4 layout).  What it does about the three causes that held the
// first qgemm_int8 (f32 FMA over a dequantized shared-memory tile, N/128 x
// M/64 CTAs, no split-K, no asynchronous copies) 30-100x over its bound:
//   - the CUDA cores: mma.sync m16n8k16, bf16 in, f32 accumulate, weight
//     columns on the MMA's 16-row side and tokens on its 8-wide side.  An
//     int8 byte becomes its exact float (PRMT + FADD, byte_minus) and two
//     of them one bf16x2 (a PRMT of the floats' upper halves): about 2.75
//     CUDA-core instructions per weight for each CTA that reads it, well
//     under the time the weight bytes take at M <= 64.  bf16 x (what the
//     prefill passes) runs one product per k16 step with no cast kernel;
//     f32 x is split into bf16 hi + lo and runs two.  Each 32-row block's
//     f16 scale multiplies that block's f32 partial sum, as _qmm_kernel's
//     f32 dot over exactly dequantized weights would within sum order;
//   - too few CTAs: a CTA takes 128 or 256 columns, up to 64 tokens and a
//     range of whole 32-row blocks; the host plan (ops/qmatmul.py::
//     gemm_plan) splits K so one wave of resident CTAs covers the card at
//     every Orpheus-3B shape, and a second kernel adds the splits in order
//     (no atomics: identical bits every run);
//   - nothing overlapping: a ring of TTS_G8_STAGES stages of cp.async
//     copies (one 32-row block, its scales, the x columns it meets) keeps
//     blocks in flight while the tensor cores work on the oldest.
#include "qmatmul.cuh"

// x [K] bf16 (x_f32: f32); the geometry of ops/qmatmul.py::gemv_plan: rows 0,
// the cluster instance (K split into `splits` ranges of `per` 32-row blocks, the
// splits of a column tile one cluster); rows > 0, the small-call instance
// (rows weight rows a thread, tile_n columns a CTA)
extern "C" int qgemv_int8(const void* x, int x_f32, const void* wq, const void* scales, void* out,
                          int K, int N, int tile_n, int splits, int per, int rows, void* stream) {
  return tts::launch_qgemv<false>(x, x_f32, wq, scales, out, K, N, tile_n, splits, per, rows,
                                  stream);
}

// x [M, K] bf16 (x_f32: f32); geometry from ops/qmatmul.py::gemm_plan
// (qmatmul.cuh launch_qgemm)
extern "C" int qgemm_int8(const void* x, int x_f32, const void* wq, const void* scales,
                          void* partial, void* out, int M, int K, int N, int m_tile, int tile_n,
                          int splits, int per, void* stream) {
  return tts::launch_qgemm<false>(x, x_f32, wq, scales, partial, out, M, K, N, m_tile, tile_n,
                                  splits, per, stream);
}
