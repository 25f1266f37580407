"""The port's Hopper kernels against their plain PyTorch versions, on the card,
at the Orpheus-3B shapes and at Parler-TTS mini v1's and Dia-1.6B's.  Every
test here needs a CUDA device and skips without one; the file imports no
jax, so it runs where only the port does:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(tests/conftest.py pins JAX to the CPU, hence --noconftest there.)"""

import pytest
import torch

from tts_tpu_torch.ops import _ext
from tts_tpu_torch.ops import attention as ta
from tts_tpu_torch.ops import qmatmul as tq

# Orpheus-3B linears (K, N): qkv, o, gateup, down, padded lm_head
ORPHEUS_SHAPES = [(3072, 5120), (3072, 3072), (3072, 16384), (8192, 3072), (3072, 157696)]
# Parler-TTS mini v1 linears (K, N): q/k/v/o and the cross-attention's
# (hidden 1024, a 1024-wide encoding), fc1, fc2
PARLER_SHAPES = [(1024, 1024), (1024, 4096), (4096, 1024)]
# Parler's GEMM rows: the verify window (8), a prompt ("hello world" and
# its EOS: 13 tokens), the 32-row encoding of the cross-KV precompute
PARLER_GEMM_M = [8, 13, 32]
# Dia-1.6B decoder linears (K, N): self q/o and cross q/o (2048, 2048), self
# k/v (2048, 512), gate/up (2048, 8192), wo (8192, 2048); each runs at M = 2
# (the CFG pair of a decode step) and 16 (an 8-row verify); the cross-KV's
# k/v (1024, 2048) at M = 2 x 1024 (the encoder's full context)
DIA_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
DIA_CROSS = (2048, 1024, 2048)
# Orpheus-3B attention: Hq, Hkv, padded cache length
HQ, HKV, S, HS = 24, 8, 3584, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    return torch.device("cuda")


def rand_q8(K, N, device, seed):
    """int8 weights [K, N] and f16 block scales [K/32, N] of a Q8_0 linear."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    wq = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8).to(device)
    sc = (torch.rand((K // 32, N), generator=g) * 2e-3 + 1e-4).half().to(device)
    return wq, sc


def rand_q4(K, N, device, seed):
    """Packed int4 weights [K/2, N] (every byte value: two random signed
    nibbles) and f16 block scales [K/32, N] of a Q4_0 linear."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    wq4 = torch.randint(-128, 128, (K // 2, N), generator=g, dtype=torch.int8).to(device)
    sc = (torch.rand((K // 32, N), generator=g) * 2e-2 + 1e-3).half().to(device)
    return wq4, sc


def rand_weight(packed, K, N, device, seed):
    return rand_q4(K, N, device, seed) if packed else rand_q8(K, N, device, seed)


def rand_attention(pos, quant, device):
    """q [24, 128] f32 and a [8, 3584, 128] cache (bf16, or int8 + scales)
    whose rows past pos hold NaN, as a reused cache may."""
    g = torch.Generator(device="cpu").manual_seed(pos + 7 * quant)
    q = torch.randn((HQ, HS), generator=g)
    if quant:
        k = torch.randint(-127, 128, (HKV, S, HS), generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, (HKV, S, HS), generator=g, dtype=torch.int8)
        ks = torch.rand((HKV, S), generator=g) * 0.02 + 1e-3
        vs = torch.rand((HKV, S), generator=g) * 0.02 + 1e-3
        ks[:, pos + 1:] = float("nan")
        vs[:, pos + 1:] = float("nan")
    else:
        k = torch.randn((HKV, S, HS), generator=g).bfloat16()
        v = torch.randn((HKV, S, HS), generator=g).bfloat16()
        k[:, pos + 1:] = float("nan")
        v[:, pos + 1:] = float("nan")
        ks = vs = None
    move = (lambda t: None if t is None else t.to(device))
    return move(q), move(k), move(v), move(ks), move(vs)


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("K,N", ORPHEUS_SHAPES)
def test_qgemv_int8_matches_plain(cuda, K, N, xdtype):
    """Both sum the same exact bf16(x) * int8 products in f32, in another
    order (split-K, per-block scaling): relative error bound 1e-4.  x comes
    in bf16, as the decode layers pass it, or f32, as the head passes it
    (the kernel rounds it to bf16)."""
    wq, sc = rand_q8(K, N, cuda, K + N)
    x = torch.randn((1, K), device=cuda).to(xdtype)
    n = tq.qgemv_int8.launches
    got = tq.qgemv_int8(x, wq, sc)
    torch.cuda.synchronize()
    assert tq.qgemv_int8.launches == n + 1
    assert rel_err(got, tq.qgemv_int8_plain(x, wq, sc)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("K,N", ORPHEUS_SHAPES)
def test_qgemv_is_one_kernel_with_the_planned_grid(cuda, K, N, packed, xdtype):
    """One device kernel per call, with no cast and no split-K pass, for
    bf16 and f32 x; its grid is gemv_plan's (splits, column tiles), at
    most one CTA per SM where the column tiles leave SMs free."""
    w, sc = rand_weight(packed, K, N, cuda, 3)
    x = torch.randn((1, K), device=cuda).to(xdtype)
    fn = tq.qgemv_int4 if packed else tq.qgemv_int8
    tile_n, splits, _ = tq.gemv_plan(K, N, _ext.sm_count(cuda.index or 0), packed)
    acts = _ext.device_activity(lambda: fn(x, w, sc))
    assert len(acts) == 1 and "qgemv_kernel" in acts[0]["name"], acts
    assert acts[0]["grid"] == [splits, -(-N // tile_n), 1], acts
    sms, tiles = _ext.sm_count(cuda.index or 0), -(-N // tile_n)
    assert tiles >= sms or tiles * splits <= sms


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("K,N", [ORPHEUS_SHAPES[1], ORPHEUS_SHAPES[3]])
def test_qgemv_is_deterministic(cuda, K, N, packed):
    """The splits add in split order inside the cluster (no atomics): two
    calls give identical bits, at o and down (the most splits)."""
    assert tq.gemv_plan(K, N, _ext.sm_count(cuda.index or 0), packed)[1] > 1
    w, sc = rand_weight(packed, K, N, cuda, 4)
    x = torch.randn((1, K), device=cuda).bfloat16()
    fn = tq.qgemv_int4 if packed else tq.qgemv_int8
    a, b = fn(x, w, sc), fn(x, w, sc)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
def test_qgemv_on_two_streams(cuda, packed):
    """The cross-split sum keeps no global state: calls on two streams at
    once (each stream first sleeps on the device while the host queues all
    of them) each match the plain version."""
    K, N = ORPHEUS_SHAPES[3]
    fn = tq.qgemv_int4 if packed else tq.qgemv_int8
    plain = tq.qgemv_int4_plain if packed else tq.qgemv_int8_plain
    runs = []
    for seed in (5, 6):
        w, sc = rand_weight(packed, K, N, cuda, seed)
        x = torch.randn((1, K), device=cuda).bfloat16()
        runs.append((torch.cuda.Stream(), (x, w, sc), plain(x, w, sc), []))
    torch.cuda.synchronize()
    for stream, *_ in runs:
        with torch.cuda.stream(stream):
            torch.cuda._sleep(100_000_000)             # ~50 ms of device time
    for _ in range(50):
        for stream, args, _, outs in runs:
            with torch.cuda.stream(stream):
                outs.append(fn(*args))
    torch.cuda.synchronize()
    for _, _, want, outs in runs:
        assert max(rel_err(o, want) for o in outs) < 1e-4


# prompt lengths: every M tile (8-64), ragged M (17, 77), 1024 (the longest
# prompt, max_context_length) and 2048 (Dia's cross-KV)
GEMM_M = [2, 8, 16, 17, 52, 64, 77, 1024, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("M", GEMM_M)
@pytest.mark.parametrize("K,N", ORPHEUS_SHAPES)
def test_qgemm_int8_matches_plain(cuda, K, N, M, xdtype):
    """Tensor cores on exact integer weights (int8 -> f32 -> bf16, exact),
    block scales on the f32 partial sums, split-K: relative error bound
    1e-4 against the f32 plain version, on bf16 x (one product: the bf16
    values are summed exactly, in another order) and on f32 x (bf16 hi +
    lo, about 16 bits of x)."""
    wq, sc = rand_q8(K, N, cuda, K + N + M)
    x = torch.randn((M, K), device=cuda).to(xdtype)
    n = tq.qgemm_int8.launches
    got = tq.qgemm_int8(x, wq, sc)
    torch.cuda.synchronize()
    assert tq.qgemm_int8.launches == n + 1
    assert rel_err(got, tq.qgemm_int8_plain(x, wq, sc)) < 1e-4


@pytest.mark.cuda
def test_qgemm_int8_takes_every_byte_value(cuda):
    """Weights holding every byte -128..127 (the port's int8 layout can hold
    -128, which Q8_0 never writes) against the plain version."""
    K, N = 3072, 3072
    wq = (torch.arange(K * N, dtype=torch.int64) * 7919 % 256 - 128).to(torch.int8)
    wq = wq.view(K, N).to(cuda)
    sc = (torch.rand((K // 32, N)) * 2e-3 + 1e-4).half().to(cuda)
    x = torch.randn((64, K), device=cuda).bfloat16()
    assert rel_err(tq.qgemm_int8(x, wq, sc), tq.qgemm_int8_plain(x, wq, sc)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("K,N", ORPHEUS_SHAPES)
def test_qgemv_int4_matches_plain(cuda, K, N, xdtype):
    """Both sum the same exact bf16(x) * int4 products in f32, in another
    order (split-K, two nibble planes, per-block scaling): bound 1e-4; x in
    bf16 or f32, as for qgemv_int8."""
    wq4, sc = rand_q4(K, N, cuda, K + N)
    x = torch.randn((1, K), device=cuda).to(xdtype)
    n = tq.qgemv_int4.launches
    got = tq.qgemv_int4(x, wq4, sc)
    torch.cuda.synchronize()
    assert tq.qgemv_int4.launches == n + 1
    assert rel_err(got, tq.qgemv_int4_plain(x, wq4, sc)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("M", GEMM_M)
@pytest.mark.parametrize("K,N", ORPHEUS_SHAPES)
def test_qgemm_int4_matches_plain(cuda, M, K, N, xdtype):
    """Tensor cores on exact integer weights, block scales on the f32
    partial sums, split-K: relative error bound 1e-4 against the f32 plain
    version, on bf16 x (one product) and on f32 x (split into bf16 hi + lo,
    about 16 bits of x)."""
    wq4, sc = rand_q4(K, N, cuda, K + N + M)
    x = torch.randn((M, K), device=cuda).to(xdtype)
    n = tq.qgemm_int4.launches
    got = tq.qgemm_int4(x, wq4, sc)
    torch.cuda.synchronize()
    assert tq.qgemm_int4.launches == n + 1
    assert rel_err(got, tq.qgemm_int4_plain(x, wq4, sc)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 64])
def test_qgemm_int4_is_deterministic(cuda, M):
    """Split-K partials are added in split order (no atomics): two calls
    give identical bits, at down (K = 8192, the most splits)."""
    K, N = ORPHEUS_SHAPES[3]
    assert tq.gemm_plan(M, K, N, _ext.sm_count(cuda.index or 0), True)[2] > 1
    wq4, sc = rand_q4(K, N, cuda, M)
    x = torch.randn((M, K), device=cuda)
    a, b = tq.qgemm_int4(x, wq4, sc), tq.qgemm_int4(x, wq4, sc)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("M", [8, 64])
def test_qgemm_int8_is_deterministic(cuda, M, xdtype):
    """The same for qgemm_int8, at down and o (the most splits)."""
    for K, N in (ORPHEUS_SHAPES[3], ORPHEUS_SHAPES[1]):
        assert tq.gemm_plan(M, K, N, _ext.sm_count(cuda.index or 0), False)[2] > 1
        wq, sc = rand_q8(K, N, cuda, M)
        x = torch.randn((M, K), device=cuda).to(xdtype)
        a, b = tq.qgemm_int8(x, wq, sc), tq.qgemm_int8(x, wq, sc)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("pos", [0, 1, 62, 63, 64, 65, 127, 128, 511, 512, 2047, 3583])
def test_flash_decode_matches_plain(cuda, quant, pos):
    """The kernel takes each chunk's p against that chunk's max, the plain
    version against the running max, so bf16(p) rounds differently past the
    first chunk: each term moves by at most 2^-9 of itself, the output by at
    most 2^-9 max|v|; stated bound 4e-3 of max|out|.  NaN rows past pos must
    not reach the kernel's output (the plain version masks them too)."""
    q, k, v, ks, vs = rand_attention(pos, quant, cuda)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    got = ta.flash_decode(q, k, v, pos_t, ks, vs, ta.arrival_counters(HKV, cuda))
    torch.cuda.synchronize()
    want = ta.flash_decode_plain(q, k, v, pos, ks, vs)
    assert torch.isfinite(got).all()
    assert rel_err(got, want) < 4e-3


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("pos", [0, 700])
def test_flash_decode_is_one_kernel(cuda, quant, pos):
    """The combine runs in the last CTA of each head: one launch per call."""
    q, k, v, ks, vs = rand_attention(pos, quant, cuda)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    counters = ta.arrival_counters(HKV, cuda)
    acts = _ext.device_activity(lambda: ta.flash_decode(q, k, v, pos_t, ks, vs, counters))
    assert len(acts) == 1 and "flash_decode" in acts[0]["name"], acts
    assert acts[0]["grid"] == [HKV, S // ta.KERNEL_CHUNK, 1], acts


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 64])
def test_qgemm_int4_launches_the_planned_grid(cuda, M):
    """The launch shows the grid gemm_plan chose, and the split-K pass
    after it."""
    K, N = ORPHEUS_SHAPES[3]
    m_tile, tile_n, splits, _ = tq.gemm_plan(M, K, N, _ext.sm_count(cuda.index or 0), True)
    wq4, sc = rand_q4(K, N, cuda, M)
    x = torch.randn((M, K), device=cuda)
    acts = _ext.device_activity(lambda: tq.qgemm_int4(x, wq4, sc))
    assert [a["grid"] for a in acts if "qgemm_kernel" in a["name"]] == [
        [-(-N // tile_n), -(-M // m_tile), splits]], acts
    assert len(acts) == 2 and "splitk_sum" in acts[1]["name"], acts


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("M", [8, 52, 64, 1024])
@pytest.mark.parametrize("K,N", ORPHEUS_SHAPES[:4])
def test_qgemm_launches_the_planned_grid(cuda, K, N, M, packed, xdtype):
    """Each GEMM call is the shared kernel with gemm_plan's grid, then the
    split-K pass where K splits, and nothing else: no cast of x, bf16 or
    f32; on the prefill's shapes (M <= 64) at least one CTA per SM."""
    sms = _ext.sm_count(cuda.index or 0)
    m_tile, tile_n, splits, _ = tq.gemm_plan(M, K, N, sms, packed)
    w, sc = rand_weight(packed, K, N, cuda, M)
    x = torch.randn((M, K), device=cuda).to(xdtype)
    fn = tq.qgemm_int4 if packed else tq.qgemm_int8
    acts = _ext.device_activity(lambda: fn(x, w, sc))
    grid = [-(-N // tile_n), -(-M // m_tile), splits]
    assert len(acts) == 1 + (splits > 1), acts
    assert "qgemm_kernel" in acts[0]["name"] and acts[0]["grid"] == grid, acts
    assert splits == 1 or "splitk_sum" in acts[1]["name"], acts
    assert M > 64 or grid[0] * grid[1] * grid[2] >= sms


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_flash_decode_graph_replays_as_pos_advances(cuda, quant):
    """One capture, replayed with pos moved on the device between replays,
    matches the plain version every time: the launch does not depend on pos,
    and the arrival counters are back at zero after every replay."""
    q, k, v, ks, vs = rand_attention(S - 1, quant, cuda)
    pos_t = torch.tensor([0], dtype=torch.int32, device=cuda)
    counters = ta.arrival_counters(HKV, cuda)
    ta.flash_decode(q, k, v, pos_t, ks, vs, counters)   # warm, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ta.flash_decode(q, k, v, pos_t, ks, vs, counters)
    for pos in (0, 63, 64, 700, 3583, 5, 130, 3583):
        pos_t.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        assert rel_err(out, ta.flash_decode_plain(q, k, v, pos, ks, vs)) < 4e-3, pos
    assert not counters.any()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_flash_decode_on_two_streams_with_their_own_counters(cuda, quant):
    """Two caches, each with its own counters, decoded on two streams at
    once (as two models served side by side would be): every call matches
    the plain version, and both sets of counters end at zero.  Each stream
    first sleeps on the device while the host queues all the calls, so
    the two streams' launches run concurrently."""
    runs = []
    for pos in (3583, 2000):
        q, k, v, ks, vs = rand_attention(pos, quant, cuda)
        pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
        runs.append((torch.cuda.Stream(), (q, k, v, pos_t, ks, vs, ta.arrival_counters(HKV, cuda)),
                     ta.flash_decode_plain(q, k, v, pos, ks, vs), []))
    torch.cuda.synchronize()
    for stream, *_ in runs:
        with torch.cuda.stream(stream):
            torch.cuda._sleep(100_000_000)             # ~50 ms of device time
    for _ in range(50):
        for stream, args, _, outs in runs:
            with torch.cuda.stream(stream):
                outs.append(ta.flash_decode(*args))
    torch.cuda.synchronize()
    for _, args, want, outs in runs:
        assert max(rel_err(o, want) for o in outs) < 4e-3
        assert not args[-1].any()


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_cannot_take(cuda):
    """Misaligned or mis-shaped inputs raise before any launch."""
    K, N = 256, 512
    wq, sc = rand_q8(K, N, cuda, 0)
    x = torch.randn((1, K), device=cuda)
    shifted = torch.empty(K * N + 1, dtype=torch.int8, device=cuda)[1:].view(K, N)
    n = tq.qgemv_int8.launches
    with pytest.raises(ValueError):
        tq.qgemv_int8(x, shifted, sc)
    with pytest.raises(ValueError):
        tq.qgemm_int8(x.repeat(2, 1), wq[:, :500].contiguous(), sc[:, :500].contiguous())
    assert tq.qgemv_int8.launches == n
    wq4, sc4 = rand_q4(K, N, cuda, 0)
    n = tq.qgemv_int4.launches
    with pytest.raises(ValueError):
        tq.qgemv_int4(x, wq4, sc4[:-1].contiguous())                  # scales not [K/32, N]
    with pytest.raises(ValueError):
        tq.qgemv_int4(x[:, :160], wq4[:80].contiguous(), sc4[:5].contiguous())  # K % 64
    with pytest.raises(ValueError):
        tq.qgemm_int4(x.repeat(2, 1), wq4, sc4.float())                # scales not f16
    with pytest.raises(ValueError):
        tq.qgemv_int4(torch.empty(K + 1, device=cuda)[1:][None], wq4, sc4)  # x misaligned
    assert tq.qgemv_int4.launches == n
    q, k, v, _, _ = rand_attention(5, False, cuda)
    counters = ta.arrival_counters(HKV, cuda)
    with pytest.raises(ValueError):
        ta.flash_decode(q, k, v, torch.tensor([5], device=cuda), counters=counters)  # int32 pos
    with pytest.raises(ValueError):
        ta.flash_decode(q, k, v, torch.tensor([5], dtype=torch.int32, device=cuda))  # counters


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("K,N", PARLER_SHAPES)
def test_parler_gemv_matches_plain_in_one_kernel(cuda, K, N, packed):
    """Parler's decode step passes the GEMVs f32 x (rounded to bf16 by the
    kernel): against the plain version within 1e-4, one launch counted,
    one device kernel with gemv_plan's grid."""
    w, sc = rand_weight(packed, K, N, cuda, K + 3 * N)
    x = torch.randn((1, K), device=cuda)
    fn = tq.qgemv_int4 if packed else tq.qgemv_int8
    plain = tq.qgemv_int4_plain if packed else tq.qgemv_int8_plain
    n = fn.launches
    got = fn(x, w, sc)
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    assert rel_err(got, plain(x, w, sc)) < 1e-4
    tile_n, splits, _ = tq.gemv_plan(K, N, _ext.sm_count(cuda.index or 0), packed)
    acts = _ext.device_activity(lambda: fn(x, w, sc))
    assert len(acts) == 1 and "qgemv_kernel" in acts[0]["name"], acts
    assert acts[0]["grid"] == [splits, -(-N // tile_n), 1], acts


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("M", PARLER_GEMM_M)
@pytest.mark.parametrize("K,N", PARLER_SHAPES)
def test_parler_gemm_matches_plain(cuda, K, N, M, packed):
    """Parler's prefill, verify and cross-KV pass the GEMMs f32 x (hi + lo):
    against the plain version within 1e-4, one launch counted, the shared
    kernel with gemm_plan's grid and the split-K pass where K splits."""
    w, sc = rand_weight(packed, K, N, cuda, K + 5 * N + M)
    x = torch.randn((M, K), device=cuda)
    fn = tq.qgemm_int4 if packed else tq.qgemm_int8
    plain = tq.qgemm_int4_plain if packed else tq.qgemm_int8_plain
    n = fn.launches
    got = fn(x, w, sc)
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    assert rel_err(got, plain(x, w, sc)) < 1e-4
    m_tile, tile_n, splits, _ = tq.gemm_plan(M, K, N, _ext.sm_count(cuda.index or 0), packed)
    acts = _ext.device_activity(lambda: fn(x, w, sc))
    assert len(acts) == 1 + (splits > 1), acts
    assert acts[0]["grid"] == [-(-N // tile_n), -(-M // m_tile), splits], acts


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("M,K,N", [(M, K, N) for K, N in DIA_SHAPES for M in (2, 16)]
                         + [DIA_CROSS])
def test_dia_gemm_matches_plain(cuda, M, K, N, packed):
    """Dia's decode step, verify and cross-KV pass the GEMMs f32 x (hi +
    lo): against the plain version within 1e-4, one launch counted, the
    shared kernel with gemm_plan's grid and the split-K pass where K
    splits."""
    w, sc = rand_weight(packed, K, N, cuda, K + 7 * N + M)
    x = torch.randn((M, K), device=cuda)
    fn = tq.qgemm_int4 if packed else tq.qgemm_int8
    plain = tq.qgemm_int4_plain if packed else tq.qgemm_int8_plain
    n = fn.launches
    got = fn(x, w, sc)
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    assert rel_err(got, plain(x, w, sc)) < 1e-4
    m_tile, tile_n, splits, _ = tq.gemm_plan(M, K, N, _ext.sm_count(cuda.index or 0), packed)
    acts = _ext.device_activity(lambda: fn(x, w, sc))
    assert len(acts) == 1 + (splits > 1), acts
    assert acts[0]["grid"] == [-(-N // tile_n), -(-M // m_tile), splits], acts
