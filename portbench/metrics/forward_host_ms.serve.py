"""Host ms of the port's YOLO forward (its ``yolo.forward`` span), the mean
over the traced window's batches."""

from portbench.core import spans

LAYER = "model: models/vision/dfine.py, hgnet.py, models/vision/yolo.py"
UNIT = "ms"
MOVES = "frames_per_s"


def read(rec):
    return spans.host_ms(("yolo.forward",))
