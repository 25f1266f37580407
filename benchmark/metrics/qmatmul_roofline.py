"""The quantized matmuls' share of their roofline in the traced slice: the
least time of every call the slice holds (each from its M, K, N and the
Q4_0 format: models/<m>.py `qmatmul_bound_s`, from the decode rows and
prefills the server counted inside the slice) over the device time of the
port's qgemv / qgemm kernels and their split-K sums in the trace (%).
The trace's launch counts must equal what those rows and prefills call
for (models/<m>.py `qmatmul_expected`), or the reading fails.  No such
kernel in the trace: no reading."""

# the port's quantized-matmul kernels (csrc/qmatmul.cuh), by the name the trace gives
KERNELS = {"qgemv_kernel": "gemv", "qgemm_kernel": "gemm", "splitk_sum_kernel": "sum"}


def read(ctx):
    tr, sl = ctx["trace"], ctx.get("slice")
    if tr is None or sl is None:
        return None
    model, cfg = ctx["model"], ctx["cfg"]
    count = {k: 0 for k in set(KERNELS.values())}
    dev_us = 0.0
    for cat, name, _, dur in tr["ops"]:
        if cat != "kernel":
            continue
        for key, kind in KERNELS.items():
            if key in name:
                count[kind] += 1
                dev_us += dur
                break
    if not dev_us:
        return None
    want = model.qmatmul_expected(cfg, sl["rows"], sl["prompts"])
    got = {k: count.get(k, 0) for k in want}
    if got != want:
        segs, n = [], 0
        for cat, name, _, _ in sorted(tr["ops"], key=lambda o: o[2]):
            if cat == "gpu_memcpy":
                segs.append(n)
                n = 0
            elif cat == "kernel" and ("qgemm_kernel" in name or "qgemv_kernel" in name):
                n += 1
        segs.append(n)
        hist = {k: segs.count(k) for k in sorted(set(segs))}
        raise ValueError(f"qmatmul_roofline: the trace holds {got} launches, the slice's "
                         f"{sl['rows']} rows and {len(sl['prompts'])} prefills call for {want} "
                         f"(launches between device copies: {hist})")
    return 100.0 * model.qmatmul_bound_s(cfg, sl["rows"], sl["prompts"]) / (dev_us * 1e-6)
