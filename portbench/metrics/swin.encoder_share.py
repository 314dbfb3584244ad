"""Share of the traced call's device busy seconds spent in the kernels launched inside the program's swin.encoder ranges (patch embedding through the last stage)."""


def read(run):
    secs = (run.get("range_kernel_s") or {}).get("swin.encoder")
    tr = run.get("trace")
    if not secs or tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * secs / tr.busy_s
