"""The port's Hopper kernels against their plain PyTorch versions, on the card,
at the Orpheus-3B shapes and at Parler-TTS mini v1's and Dia-1.6B's (Parler's
decode-step self-attention among them), and Orpheus's decode step captured
as one CUDA graph against its eager steps (tokens, other sampling values on
one graph, launch counts).  Every
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


# ---------------------------------------------------------------------------
# Parler's decode-step self-attention (ops/attention.py prefix_attention,
# csrc/prefix_attention.cu) at Parler-TTS mini v1's shapes: 16 heads of 64
# over a position-major 4,096-slot cache, f32 against the plain masked read.
# Only the order of summation differs (per 64-slot chunk, then across
# chunks), so the stated bound is 1e-5 of max|out|.
PA_H, PA_HS, PA_S = 16, 64, 4096
PA_TOL = 1e-5
PA_POSITIONS = [0, 63, 64, 511, 1000, 2047, 4095]


def rand_prefix(pos, device, dtype=torch.bfloat16, past=None):
    """q [1, 16, 64] f32 and a cache layer [4096, 16, 64] in `dtype`;
    slots past pos hold `past` (NaN, say) if given."""
    g = torch.Generator(device="cpu").manual_seed(1000 + pos)
    q = torch.randn((1, PA_H, PA_HS), generator=g)
    k = torch.randn((PA_S, PA_H, PA_HS), generator=g)
    v = torch.randn((PA_S, PA_H, PA_HS), generator=g)
    if past is not None:
        k[pos + 1:] = past
        v[pos + 1:] = past
    pos_t = torch.tensor([pos], dtype=torch.int32)
    return q.to(device), k.to(dtype).to(device), v.to(dtype).to(device), pos_t.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("pos", PA_POSITIONS)
def test_prefix_attention_matches_plain(cuda, pos, dtype):
    """One launch per call against the masked read of the whole cache (the
    plain version, here on the card's f32 products, TF32 off)."""
    q, k, v, pos_t = rand_prefix(pos, cuda, dtype)
    counters = ta.arrival_counters(PA_H, cuda)
    n = ta.prefix_attention.launches
    got = ta.prefix_attention(q, k, v, pos_t, counters)
    torch.cuda.synchronize()
    assert ta.prefix_attention.launches == n + 1
    assert got.shape == (1, PA_H * PA_HS) and got.dtype == torch.float32
    assert rel_err(got, ta.prefix_attention_plain(q, k, v, pos_t)) < PA_TOL
    assert not counters.any()


@pytest.mark.cuda
@pytest.mark.parametrize("pos", PA_POSITIONS)
def test_prefix_attention_reads_nothing_past_pos(cuda, pos):
    """NaN in every slot past pos leaves the output finite and bit for bit
    the output without it; two launches at one pos give equal bits."""
    counters = ta.arrival_counters(PA_H, cuda)
    clean = rand_prefix(pos, cuda)
    poisoned = rand_prefix(pos, cuda, past=float("nan"))
    a = ta.prefix_attention(*clean, counters)
    b = ta.prefix_attention(*poisoned, counters)
    c = ta.prefix_attention(*poisoned, counters)
    torch.cuda.synchronize()
    assert torch.isfinite(b).all()
    assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 1000])
def test_prefix_attention_is_one_kernel(cuda, pos):
    """One device kernel per call, named apart from the matmul kernels that
    qmatmul_roofline counts, on a grid of (heads, 64-slot chunks)."""
    q, k, v, pos_t = rand_prefix(pos, cuda)
    counters = ta.arrival_counters(PA_H, cuda)
    acts = _ext.device_activity(lambda: ta.prefix_attention(q, k, v, pos_t, counters))
    assert len(acts) == 1 and "prefix_attention_kernel" in acts[0]["name"], acts
    assert not any(m in acts[0]["name"] for m in ("qgemv_kernel", "qgemm_kernel", "splitk_sum"))
    assert acts[0]["grid"] == [PA_H, PA_S // ta.PA_CHUNK, 1], acts


@pytest.mark.cuda
def test_prefix_attention_graph_replays_equal_eager_calls(cuda):
    """One capture replayed at three positions (pos moved on the device
    between replays) gives the bits of an eager call at each, and the
    arrival counters are back at zero after every replay."""
    q, k, v, pos_t = rand_prefix(PA_S - 1, cuda)
    counters = ta.arrival_counters(PA_H, cuda)
    ta.prefix_attention(q, k, v, pos_t, counters)     # warm, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ta.prefix_attention(q, k, v, pos_t, counters)
    for pos in (1000, 63, 4095):
        pos_t.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        replayed = out.clone()
        eager = ta.prefix_attention(q, k, v, pos_t, counters)
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager), pos
        assert not counters.any(), pos


# SHA-256 of the output bytes of the Parler instance (bf16 and f32 caches,
# rand_prefix's inputs, PA_POSITIONS in order), as the kernel gave them
# before Dia's instances were added (H100, the kernel of the tree before):
# the Parler instance keeps its grid, chunk and order of summation
PA_PARLER_DIGESTS = {"bf16": "2d1ec86a67330ba073bb27b29ae485f578d7b9db8063a78f29f3144832b351ae",
                     "f32": "988fbf33ffcc7d9403241bfbf37c9023f46444f025f531572a4bd84834c11a4b"}


def prefix_digest(outputs) -> str:
    import hashlib

    h = hashlib.sha256()
    for o in outputs:
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_prefix_attention_parler_bits_are_unchanged(cuda, dtype):
    """At every position of PA_POSITIONS, Parler's instance gives the bits
    the kernel gave before it was shared with Dia's."""
    counters = ta.arrival_counters(PA_H, cuda)
    outs = [ta.prefix_attention(*rand_prefix(pos, cuda, dtype), counters)
            for pos in PA_POSITIONS]
    torch.cuda.synchronize()
    key = "bf16" if dtype == torch.bfloat16 else "f32"
    assert prefix_digest(outs) == PA_PARLER_DIGESTS[key]


# Dia's decode-step self-attention (the same kernel's head-major GQA
# instances) at Dia-1.6B's shapes: the CFG pair of 16 query heads over 4 KV
# heads of 128, a head-major 3,072-slot cache, unscaled logits (Dia's
# softmax has no 1/sqrt(hs)); against the plain masked read, to 1e-5 of
# max|out| (the order of summation alone differs)
DIA_B, DIA_HKV, DIA_G, DIA_HS, DIA_S = 2, 4, 4, 128, 3072
DIA_POSITIONS = [0, 63, 64, 511, 1023, 2047, 3071]


def rand_dia_prefix(pos, device, dtype=torch.bfloat16, past=None, hkv=DIA_HKV, g=DIA_G,
                    s=DIA_S):
    """q [2, hkv * g, 128] f32 and a head-major cache layer [2, hkv, s, 128]
    in `dtype` (K at 0.3: Dia's unscaled logits several units wide); slots
    past pos hold `past` (NaN, say) if given."""
    gen = torch.Generator(device="cpu").manual_seed(2000 + pos)
    q = torch.randn((DIA_B, hkv * g, DIA_HS), generator=gen)
    k = torch.randn((DIA_B, hkv, s, DIA_HS), generator=gen) * 0.3
    v = torch.randn((DIA_B, hkv, s, DIA_HS), generator=gen)
    if past is not None:
        k[:, :, pos + 1:] = past
        v[:, :, pos + 1:] = past
    pos_t = torch.tensor([pos], dtype=torch.int32)
    return q.to(device), k.to(dtype).to(device), v.to(dtype).to(device), pos_t.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("pos", DIA_POSITIONS)
def test_prefix_attention_dia_matches_plain(cuda, pos, dtype):
    """One launch per call against Dia's masked read of the whole cache (the
    plain version on the card's f32 products, TF32 off), counters left at
    zero."""
    q, k, v, pos_t = rand_dia_prefix(pos, cuda, dtype)
    counters = ta.arrival_counters(DIA_B * DIA_HKV, cuda)
    n = ta.prefix_attention.launches
    got = ta.prefix_attention(q, k, v, pos_t, counters, scale=1.0)
    torch.cuda.synchronize()
    assert ta.prefix_attention.launches == n + 1
    assert got.shape == (DIA_B, DIA_HKV * DIA_G * DIA_HS) and got.dtype == torch.float32
    assert rel_err(got, ta.prefix_attention_plain(q, k, v, pos_t, 1.0)) < PA_TOL
    assert not counters.any()


@pytest.mark.cuda
@pytest.mark.parametrize("past", [1e5, float("nan")], ids=["1e5", "nan"])
@pytest.mark.parametrize("pos", DIA_POSITIONS)
def test_prefix_attention_dia_reads_nothing_past_pos(cuda, pos, past):
    """1e5 or NaN in every slot past pos leaves the output finite and bit
    for bit the output without it; two launches at one pos give equal bits
    (the combine's order is fixed by pos alone)."""
    counters = ta.arrival_counters(DIA_B * DIA_HKV, cuda)
    a = ta.prefix_attention(*rand_dia_prefix(pos, cuda), counters, scale=1.0)
    poisoned = rand_dia_prefix(pos, cuda, past=past)
    b = ta.prefix_attention(*poisoned, counters, scale=1.0)
    c = ta.prefix_attention(*poisoned, counters, scale=1.0)
    torch.cuda.synchronize()
    assert torch.isfinite(b).all()
    assert torch.equal(a, b) and torch.equal(b, c)
    assert not counters.any()


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 1023, 3071])
def test_prefix_attention_dia_is_one_kernel(cuda, pos):
    """One device kernel per call, on a grid of (2 x 4 KV heads, 64-slot
    chunks): each KV head's rows are read by one CTA per chunk for all 4 of
    its query heads."""
    q, k, v, pos_t = rand_dia_prefix(pos, cuda)
    counters = ta.arrival_counters(DIA_B * DIA_HKV, cuda)
    acts = _ext.device_activity(
        lambda: ta.prefix_attention(q, k, v, pos_t, counters, scale=1.0))
    assert len(acts) == 1 and "prefix_attention_kernel" in acts[0]["name"], acts
    assert acts[0]["grid"] == [DIA_B * DIA_HKV, DIA_S // ta.PA_CHUNK, 1], acts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_prefix_attention_dia_graph_replays_equal_eager_calls(cuda, dtype):
    """One capture replayed as pos advances on the device (one chunk, a
    chunk's edges, many chunks, the last slot) gives the bits of an eager
    call at each, the counters back at zero after every replay."""
    q, k, v, pos_t = rand_dia_prefix(DIA_S - 1, cuda, dtype)
    counters = ta.arrival_counters(DIA_B * DIA_HKV, cuda)
    ta.prefix_attention(q, k, v, pos_t, counters, scale=1.0)     # warm, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ta.prefix_attention(q, k, v, pos_t, counters, scale=1.0)
    for pos in (0, 63, 64, 511, 1023, 2047, 3071):
        pos_t.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        replayed = out.clone()
        eager = ta.prefix_attention(q, k, v, pos_t, counters, scale=1.0)
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager), pos
        assert not counters.any(), pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_prefix_attention_tiny_dia_instance_matches_plain(cuda, dtype):
    """The tests' tiny Dia (2 query heads per KV head, 64 slots) takes the
    kernel's G = 2 instance."""
    counters = ta.arrival_counters(DIA_B * 2, cuda)
    for pos in (0, 31, 63):
        q, k, v, pos_t = rand_dia_prefix(pos, cuda, dtype, hkv=2, g=2, s=64)
        got = ta.prefix_attention(q, k, v, pos_t, counters, scale=1.0)
        torch.cuda.synchronize()
        assert rel_err(got, ta.prefix_attention_plain(q, k, v, pos_t, 1.0)) < PA_TOL
    assert not counters.any()


@pytest.mark.cuda
def test_prefix_attention_refuses_what_the_kernel_cannot_take(cuda):
    """A head size other than 64 position-major, a head-major layer with
    head size 64 or 8 query heads per KV head, a cache that is no whole
    number of chunks, missing or too few counters or tensors on two devices
    raise before any launch."""
    q, k, v, pos_t = rand_prefix(5, cuda)
    counters = ta.arrival_counters(PA_H, cuda)
    n = ta.prefix_attention.launches
    wide = torch.zeros((256, PA_H, 128), dtype=torch.bfloat16, device=cuda)
    dq, dk, dv, _ = rand_dia_prefix(5, cuda, s=256)
    dia_counters = ta.arrival_counters(DIA_B * DIA_HKV, cuda)
    for args in ((q.repeat(1, 1, 2), wide, wide, pos_t, counters),
                 (q, k[:100], v[:100], pos_t, counters),
                 (q, k, v, pos_t, None),
                 (q, k, v, pos_t.cpu(), counters),
                 (dq[..., :64].contiguous(), dk[..., :64].contiguous(),
                  dv[..., :64].contiguous(), pos_t, dia_counters),
                 (dq.repeat(1, 2, 1), dk, dv, pos_t, dia_counters),
                 (dq, dk, dv, pos_t, dia_counters[:DIA_HKV])):
        with pytest.raises(ValueError, match="prefix_attention"):
            ta.prefix_attention(*args)
    assert ta.prefix_attention.launches == n


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


# ---------------------------------------------------------------------------
# Orpheus's decode step captured as one CUDA graph (models/orpheus.py
# DecodeGraph) against the same step run eagerly, on a tiny random model
# written by the port's own builder (2 layers, hidden 256, head size 128,
# the real 156,940-row vocabulary)
ORPHEUS_TINY = dict(n_layers=2, hidden=256, heads=4, kv_heads=2, head_dim=128, ffn=512,
                    vocab=156940, snac_embd=96, snac_channels=(48, 24, 12, 6))
GRAPH_TEXT = "graph or eager"


@pytest.fixture(scope="module")
def tiny_orpheus(tmp_path_factory):
    """tiny_orpheus(qtype) -> the tiny model's path (written once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    from tts_tpu_torch.convert.builder_orpheus import write_random_orpheus

    built = {}

    def get(qtype):
        if qtype not in built:
            path = tmp_path_factory.mktemp("orpheus") / f"tiny_{qtype}.gguf"
            built[qtype] = str(write_random_orpheus(path, seed=0, qtype=qtype, **ORPHEUS_TINY))
        return built[qtype]
    return get


def _decode(runner, route: str, config):
    """One request's prefill and sequential decode on `route` (as generate
    runs them): (tokens, sampler state at the end, the DecodeGraph)."""
    from tts_tpu_torch.models import orpheus as tor

    runner.decode_route = route
    ids = runner._prompt_ids(GRAPH_TEXT, config)
    with torch.inference_mode():
        _, first, generator, state, max_steps = runner._prefill(ids, config)
        step = runner._decode_step(config)
        got, state = tor.orpheus_decode_loop(runner.params, runner.cfg, first, len(ids),
                                             max_steps - 1, runner._cache, generator, state,
                                             step=step, **runner._sample_kw(config))
    torch.cuda.synchronize()
    return [int(first[0])] + got, {k: v.tolist() for k, v in state.items()}, step


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", ["Q8_0", "Q4_0"])
@pytest.mark.parametrize("sample", [True, False], ids=["sampled", "greedy"])
def test_orpheus_graph_route_gives_the_eager_tokens(cuda, tiny_orpheus, qtype, sample):
    """At one seed the captured step (its first request, which captures, and
    a second, which only replays) emits the eager steps' tokens and ends in
    their sampler state, sampled (top-k 50, the runner's generator
    registered with the graph) and greedy-sequential."""
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.api import GenerationConfig

    runner = runner_from_file(tiny_orpheus(qtype), device="cuda")
    config = GenerationConfig(seed=4, top_k=50, max_tokens=120, sample=sample)
    eager = _decode(runner, "eager", config)
    first = _decode(runner, "graph", config)
    second = _decode(runner, "graph", config)
    assert first[2] is second[2] and first[2].graph is not None
    assert eager[2].graph is None and eager[2] is not first[2]
    assert first[:2] == second[:2] == eager[:2]


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", ["Q8_0", "Q4_0"])
def test_orpheus_graph_takes_each_requests_values(cuda, tiny_orpheus, qtype):
    """A second request with another temperature, top_p and repetition
    penalty (the same static key: top-k 50, top-p on) replays the graph the
    first captured and equals its own eager run; with the first request's
    values baked in it would give the first request's tokens."""
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.api import GenerationConfig

    runner = runner_from_file(tiny_orpheus(qtype), device="cuda")
    a = GenerationConfig(seed=3, top_k=50, top_p=0.95, max_tokens=100)
    b = GenerationConfig(seed=3, top_k=50, top_p=0.7, temperature=0.6, repetition_penalty=1.4,
                         max_tokens=100)
    first = _decode(runner, "graph", a)
    second = _decode(runner, "graph", b)
    assert second[2] is first[2]
    assert second[:2] == _decode(runner, "eager", b)[:2]
    assert second[0] != first[0]


@pytest.mark.cuda
def test_orpheus_graph_launch_counts_are_exact(cuda, tiny_orpheus, monkeypatch):
    """Launch counters count what the card ran: over a first graph request
    (one eager step, the capture, replays) and a second (replays only),
    9 GEMVs (4 per layer and the head) and 2 flash_decode per decode step,
    8 GEMMs and one GEMV per prefill; the capture itself adds nothing."""
    from tts_tpu_torch.models import orpheus as tor
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.api import GenerationConfig

    steps = []
    run = tor.DecodeGraph.run
    monkeypatch.setattr(tor.DecodeGraph, "run", lambda self: steps.append(1) or run(self))
    runner = runner_from_file(tiny_orpheus("Q8_0"), device="cuda")
    config = GenerationConfig(seed=1, top_k=50, max_tokens=60)
    for request in range(2):
        for k in (tq.qgemv_int8, tq.qgemm_int8, tq.qgemv_int4, tq.qgemm_int4, ta.flash_decode):
            k.launches = 0
        steps.clear()
        resp = runner.generate(GRAPH_TEXT, config)
        torch.cuda.synchronize()
        assert resp.timings["decode_route"] == "graph"
        n = len(steps)
        assert n >= resp.timings["decode_steps"] - 1 > 0
        assert (tq.qgemv_int8.launches, tq.qgemm_int8.launches, ta.flash_decode.launches,
                tq.qgemv_int4.launches, tq.qgemm_int4.launches) == (9 * n + 1, 8, 2 * n, 0, 0)


@pytest.mark.cuda
def test_orpheus_graph_replays_leave_the_counters_at_zero(cuda, tiny_orpheus):
    """A sampled request of 700 tokens replays flash_decode across eleven
    64-position chunks: its tokens are the eager steps' and the cache's
    arrival counters end at zero."""
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.api import GenerationConfig

    runner = runner_from_file(tiny_orpheus("Q4_0"), device="cuda")
    config = GenerationConfig(seed=8, top_k=50, max_tokens=700)
    graph = _decode(runner, "graph", config)
    assert len(graph[0]) == 700
    assert not runner._cache["counters"].any()
    assert graph[:2] == _decode(runner, "eager", config)[:2]


# ---------------------------------------------------------------------------
# Parler's and Dia's decode steps captured as one CUDA graph each
# (models/parler.py ParlerStep, models/dia.py DiaStep) against the same steps
# run eagerly, on tiny random models written by the port's own builders
# (tests/torch_tiny.py's widths, every decoder linear quantized, a tiny DAC)
PARLER_TINY = dict(n_layers=2, hidden=256, heads=4, ffn=512, prompt_vocab=64, enc_len=12,
                   enc_hidden=64, max_ctx=512, max_gen=64)
DIA_TINY = dict(enc_layers=2, dec_layers=2, enc_hidden=256, dec_hidden=256, enc_heads=4,
                dec_heads=4, query_heads=2, enc_ffn=512, ffn=512, enc_ctx=128, max_gen=64)
TINY_DAC = dict(latent=96, decoder_dim=48, channels=(48, 24, 12, 6))
AR_TEXT = {"parler": "graph or eager", "dia": "[S1] Graph or eager. [S2] Both."}


@pytest.fixture(scope="module")
def tiny_ar(tmp_path_factory):
    """tiny_ar(model, qtype) -> the tiny Parler's or Dia's path (written
    once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    from tts_tpu_torch.convert.builder_codecs import DAC_44KHZ
    from tts_tpu_torch.convert.builder_dia import DIA_1_6B, write_random_dia
    from tts_tpu_torch.convert.builder_parler import PARLER_MINI_V1, write_random_parler

    built = {}

    def get(model, qtype):
        if (model, qtype) not in built:
            path = tmp_path_factory.mktemp(model) / f"tiny_{qtype}.gguf"
            write, dims = ((write_random_parler, dict(PARLER_MINI_V1, **PARLER_TINY))
                           if model == "parler" else (write_random_dia, dict(DIA_1_6B, **DIA_TINY)))
            built[model, qtype] = str(write(path, seed=0, qtype=qtype,
                                            dac=dict(DAC_44KHZ, **TINY_DAC), **dims))
        return built[model, qtype]
    return get


def _ar_decode(runner, route: str, config):
    """One request's prefill (Parler) or encode (Dia) and sequential decode
    on `route`, as generate runs them: (rows, sampler state at the end, the
    step)."""
    from tts_tpu_torch.models import dia as td
    from tts_tpu_torch.models import parler as tp

    runner.decode_route = route
    kw = runner._sample_kw(config)
    with torch.inference_mode():
        if runner.architecture == "dia":
            ids = runner._prompt_ids(AR_TEXT["dia"], config)
            cross, generator, state = runner._encode(ids, config)
            step = runner._decode_step(config)
            rows, state, _ = td.dia_decode_loop(
                runner.params, runner.cfg, config.max_tokens, runner.cfg.max_generation_size,
                runner._cache, cross, generator, state, td.dia_init_loop_state(runner.cfg),
                step=step, **kw)
        else:
            ids = runner._prompt_ids(AR_TEXT["parler"])
            cross, generator, state, max_steps = runner._prefill(ids, config)
            step = runner._decode_step(config, cross)
            rows, state, _ = tp.parler_decode_loop(
                runner.params, runner.cfg, len(ids), max_steps, runner._cache, cross, generator,
                state, tp.init_loop_state(runner.cfg), step=step, **kw)
    torch.cuda.synchronize()
    return rows.tolist(), {k: v.tolist() for k, v in state.items()}, step


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["parler", "dia"])
@pytest.mark.parametrize("qtype", ["Q8_0", "Q4_0"])
@pytest.mark.parametrize("sample", [True, False], ids=["sampled", "greedy"])
def test_ar_graph_route_gives_the_eager_rows(cuda, tiny_ar, model, qtype, sample):
    """At one seed the captured step (its first request, which captures, and
    a second, which only replays) emits the eager steps' rows and ends in
    their sampler state, sampled (top-k 50, the runner's generator
    registered with the graph) and greedy-sequential."""
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.api import GenerationConfig

    runner = runner_from_file(tiny_ar(model, qtype), device="cuda")
    assert runner.decode_route == "graph"
    config = GenerationConfig(seed=4, top_k=50, max_tokens=48, sample=sample)
    eager = _ar_decode(runner, "eager", config)
    first = _ar_decode(runner, "graph", config)
    second = _ar_decode(runner, "graph", config)
    assert first[2] is second[2] and first[2].graph is not None
    assert eager[2].graph is None and eager[2] is not first[2]
    assert len(first[0]) >= 40
    assert first[:2] == second[:2] == eager[:2]


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["parler", "dia"])
@pytest.mark.parametrize("qtype", ["Q8_0", "Q4_0"])
def test_ar_graph_takes_each_requests_values(cuda, tiny_ar, model, qtype):
    """A second request with another temperature, top_p and repetition
    penalty (the same static key: top-k 50, top-p on) replays the graph the
    first captured and equals its own eager run; with the first request's
    values baked in it would give the first request's rows."""
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.api import GenerationConfig

    runner = runner_from_file(tiny_ar(model, qtype), device="cuda")
    a = GenerationConfig(seed=3, top_k=50, top_p=0.95, max_tokens=40)
    b = GenerationConfig(seed=3, top_k=50, top_p=0.7, temperature=0.6, repetition_penalty=1.4,
                         max_tokens=40)
    first = _ar_decode(runner, "graph", a)
    second = _ar_decode(runner, "graph", b)
    assert second[2] is first[2]
    assert second[:2] == _ar_decode(runner, "eager", b)[:2]
    assert second[0] != first[0]


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["parler", "dia"])
@pytest.mark.parametrize("qtype", ["Q8_0", "Q4_0"])
def test_ar_graph_launch_counts_are_exact(cuda, tiny_ar, model, qtype, monkeypatch):
    """Launch counters count what the card ran: over a first graph request
    (one eager step, the capture, replays) and a second (replays only),
    Parler 16 GEMVs and 2 prefix_attention per row (8 linears and one
    self-attention in each of 2 layers; 192 and 24 at 24 layers) and 16
    GEMMs per prefill; Dia 18 GEMMs and 2 prefix_attention per step (9
    linears and one self-attention in each of 2 layers; 162 and 18 at 18)
    and 4 GEMMs per request (the cross-KV); the capture itself adds
    nothing, and flash_decode and the other format's kernels stay at 0."""
    from tts_tpu_torch.models import dia as td
    from tts_tpu_torch.models import parler as tp
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.api import GenerationConfig

    cls = tp.ParlerStep if model == "parler" else td.DiaStep
    steps = []
    run = cls.run
    monkeypatch.setattr(cls, "run", lambda self: steps.append(1) or run(self))
    runner = runner_from_file(tiny_ar(model, qtype), device="cuda")
    gemv, gemm = ((tq.qgemv_int8, tq.qgemm_int8) if qtype == "Q8_0"
                  else (tq.qgemv_int4, tq.qgemm_int4))
    kernels = (tq.qgemv_int8, tq.qgemm_int8, tq.qgemv_int4, tq.qgemm_int4, ta.flash_decode,
               ta.prefix_attention)
    config = GenerationConfig(seed=1, top_k=50, max_tokens=40)
    for request in range(2):
        for k in kernels:
            k.launches = 0
        steps.clear()
        resp = runner.generate(AR_TEXT[model], config)
        torch.cuda.synchronize()
        assert resp.timings["decode_route"] == "graph"
        n = len(steps)
        assert n >= resp.timings["decode_steps"] > 30
        want = {k: 0 for k in kernels}
        if model == "parler":
            want[gemv], want[gemm], want[ta.prefix_attention] = 16 * n, 16, 2 * n
        else:
            want[gemm], want[ta.prefix_attention] = 18 * n + 4, 2 * n
        assert {k: k.launches for k in kernels} == want


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", ["Q8_0", "Q4_0"])
def test_parler_step_reads_no_cache_slot_past_the_position(cuda, tiny_ar, qtype):
    """The kernels, copies and memsets of one Parler decode step, read
    from a CUDA graph captured around it: 2 prefix_attention launches (one
    a layer) on a grid of (heads, 64-slot chunks) and 16 GEMVs, and
    nothing else changes between a 512-slot and a 4,096-slot cache: no f32
    copy of the cache, no mask and no cuBLAS product over it."""
    import dataclasses

    from tts_tpu_torch.models import parler as tp
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.ops.sampling import init_state

    runner = runner_from_file(tiny_ar("parler", qtype), device="cuda")
    acts = {}
    for S in (512, 4096):
        cfg = dataclasses.replace(runner.cfg, max_ctx_length=S)
        cache = tp.init_kv_cache(cfg, cuda)
        step = tp.ParlerStep(runner.params, cfg, cache, runner.cross_kv, None, cuda, top_k=0,
                             do_sample=False, use_top_p=False)
        with torch.inference_mode():
            step.load(tp.init_loop_state(cfg), 20, init_state(cfg.n_output_heads, cuda))
            acts[S] = [(a["name"], a["grid"]) for a in _ext.device_activity(step._step)]
        grids = [g for name, g in acts[S] if "prefix_attention_kernel" in name]
        assert grids == [[cfg.n_attn_heads, S // ta.PA_CHUNK, 1]] * cfg.n_layers, acts[S]
        assert sum("qgemv_kernel" in name for name, _ in acts[S]) == 16, acts[S]
        assert not cache["counters"].any()
    rest = {S: [a for a in acts[S] if "prefix_attention_kernel" not in a[0]] for S in acts}
    assert rest[512] == rest[4096]


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", ["Q8_0", "Q4_0"])
def test_dia_step_reads_no_cache_slot_past_the_position(cuda, tiny_ar, qtype):
    """The kernels, copies and memsets of one Dia decode step, read from a
    CUDA graph captured around it: 2 prefix_attention launches (one a
    layer) on a grid of (2 x KV heads, 64-slot chunks), and nothing else
    changes between a 512-slot and a 3,072-slot cache: no f32 copy of the
    cache, no mask, softmax or cuBLAS product over it."""
    import dataclasses

    from tts_tpu_torch.models import dia as td
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.ops.sampling import init_state
    from tts_tpu_torch.runtime.api import GenerationConfig

    runner = runner_from_file(tiny_ar("dia", qtype), device="cuda")
    config = GenerationConfig()
    with torch.inference_mode():
        cross, _, _ = runner._encode(runner._prompt_ids(AR_TEXT["dia"], config), config)
    acts = {}
    for S in (512, 3072):
        cfg = dataclasses.replace(runner.cfg, max_generation_size=S)
        cache = td.init_dia_cache(cfg, cuda)
        step = td.DiaStep(runner.params, cfg, cache, cross, None, cuda, top_k=0,
                          do_sample=False, use_top_p=False)
        with torch.inference_mode():
            step.load(td.dia_init_loop_state(cfg), 20, init_state(cfg.n_output_heads, cuda))
            acts[S] = [(a["name"], a["grid"]) for a in _ext.device_activity(step._step)]
        grids = [g for name, g in acts[S] if "prefix_attention_kernel" in name]
        assert grids == [[2 * cfg.kv_heads, S // ta.PA_CHUNK, 1]] * cfg.n_decoder_layers, acts[S]
        assert not cache["counters"].any()
    rest = {S: [a for a in acts[S] if "prefix_attention_kernel" not in a[0]] for S in acts}
    assert rest[512] == rest[3072]


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["parler", "dia"])
def test_the_decode_span_counts_the_attention_launches(cuda, tiny_ar, model):
    """A served request's decode spans carry `attn_launches`: one
    prefix_attention launch a layer for every step the loops ran (2 a row
    or step at the tiny models' 2 layers; Parler-TTS mini v1 24, Dia-1.6B
    18)."""
    from tts_tpu_torch.models import dia as td
    from tts_tpu_torch.models import parler as tp
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.api import GenerationConfig
    from tts_tpu_torch.utils import trace

    runner = runner_from_file(tiny_ar(model, "Q4_0"), device="cuda")
    config = GenerationConfig(seed=2, top_k=50, max_tokens=40)
    runner.generate(AR_TEXT[model], config)                      # the capture
    cls = tp.ParlerStep if model == "parler" else td.DiaStep
    runs = []
    run = cls.run
    cls.run = lambda self: runs.append(1) or run(self)
    trace.enable()
    try:
        runner.generate(AR_TEXT[model], config)
        torch.cuda.synchronize()
    finally:
        cls.run = run
        trace.disable()
    decodes = [s for s in trace.drain()["spans"] if s["name"] == "decode"]
    assert decodes and sum(d["counters"]["rows"] for d in decodes) > 30
    assert sum(d["counters"]["attn_launches"] for d in decodes) == 2 * len(runs)


@pytest.mark.cuda
def test_a_failed_capture_raises_ttserror(cuda):
    """A step that synchronizes with the host cannot be captured: the first
    run's eager step runs, the capture raises TTSError naming the step, and
    no launch is counted for it."""
    from tts_tpu_torch.runtime.api import TTSError
    from tts_tpu_torch.runtime.step_graph import CapturedStep

    class HostRead(CapturedStep):
        label = "test"
        key = ("host read",)

        def _step(self):
            self.seen = int(torch.ones(1, device=self.device).sum().item())

    step = HostRead(cuda, None, capture=True)
    with pytest.raises(TTSError, match="test: capturing the decode step"):
        step.run()
    assert step.graph is None and step.seen == 1
    torch.cuda.synchronize()
