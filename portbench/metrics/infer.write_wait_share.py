"""Share of the traced call (its infer.call span) that the case loop waited for the write-behind: handing a case on (infer.write_wait) and draining it at the end (infer.drain)."""
from portbench import spans


def read(run):
    return spans.share(run, ["infer.write_wait", "infer.drain"], "infer.call")
