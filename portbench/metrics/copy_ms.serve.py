"""Device ms of the host-card copies a batch, in the YOLO serving cells."""

from portbench.core import readers

LAYER = "data in and out: the harness's host-card copies"
UNIT = "ms"
MOVES = "frames_per_s"
read = readers.copy_ms
