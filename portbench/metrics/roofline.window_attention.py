"""Least seconds of the windowed attention's work (4 N^2 d operations per window and head; q, k, v, out and the additive mask in bf16; at 989 TFLOP/s and 3.35 TB/s) over the device seconds of the kernels launched inside the program's swin.window_attention ranges; None where the harness's count of windows differs from the program's swin.windows counter."""
from portbench import flops, spans, swin_flops


def read(run):
    secs = (run.get("range_kernel_s") or {}).get("swin.window_attention")
    taken = spans.taken(run)
    if not secs or taken is None:
        return None
    bs, least, windows = run["batch"], 0.0, 0
    for boxes in run["boxes"]:
        for b in [bs] * (boxes // bs) + ([boxes % bs] if boxes % bs else []):
            for call in run["attention_calls"]:
                ops, nbytes = swin_flops.attention_work(call, b, run["head_dim"])
                least += flops.least_seconds(ops, nbytes, run["peak"])
                windows += b * call[2]
    if windows != taken.counters.get("swin.windows"):
        return None
    return 100.0 * least / secs
