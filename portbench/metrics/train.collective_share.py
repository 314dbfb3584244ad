"""Share of rank 0's device busy seconds in the traced train() call spent in NCCL kernels (the gradient all-reduce and the BatchNorm statistics over the ranks)."""


def read(run):
    tr = run.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * sum(tr.kernels(lambda name: "nccl" in name.lower())) / tr.busy_s
