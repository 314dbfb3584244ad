"""Share of the traced call (its infer.call span) that the case loop waited for the read-ahead's next case (infer.read_wait spans)."""
from portbench import spans


def read(run):
    return spans.share(run, ["infer.read_wait"], "infer.call")
