"""Host ms of the port's YOLO post-process a batch: its ``yolo.decode``,
``yolo.nms`` and ``yolo.masks`` spans summed within each predict call, the
mean over the traced window's calls."""

from portbench.core import spans

LAYER = "serving entry: serve/throughput.py, serve/yolo_predict.py"
UNIT = "ms"
MOVES = "frames_per_s"


def read(rec):
    return spans.host_ms(("yolo.decode", "yolo.nms", "yolo.masks"))
