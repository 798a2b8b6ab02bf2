"""Share of the traced window with the card idle, in the D-FINE serving
cells."""

from portbench.core import readers

LAYER = "device"
UNIT = "%"
MOVES = "frames_per_s.dfine"
read = readers.idle_share
