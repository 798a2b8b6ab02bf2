"""The whole served forward's share of the card's peak, in the YOLO serving
cells."""

from portbench.core import readers

LAYER = "model: models/vision/dfine.py, hgnet.py, models/vision/yolo.py"
UNIT = "%"
MOVES = "frames_per_s"
read = readers.mfu
