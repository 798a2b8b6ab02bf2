"""Host ms of the port's D-FINE post-process (its ``dfine.post_process``
span), the mean over the traced window's batches."""

from portbench.core import spans

LAYER = "serving entry: serve/throughput.py, serve/yolo_predict.py"
UNIT = "ms"
MOVES = "frames_per_s.dfine"


def read(rec):
    return spans.host_ms(("dfine.post_process",))
