"""Share of the traced window with the card idle, in the YOLO serving cells."""

from portbench.core import readers

LAYER = "device"
UNIT = "%"
MOVES = "frames_per_s"
read = readers.idle_share
