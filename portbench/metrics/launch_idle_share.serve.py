"""Share of the traced window with the card idle while the host was inside
the port's ``yolo.predict`` span, in the YOLO serving cells."""

from portbench.core import spans

LAYER = "device"
UNIT = "%"
MOVES = "frames_per_s"


def read(rec):
    return spans.launch_idle_share(rec, ("yolo.predict",))
