"""Host wall ms a batch inside the port's call, in the D-FINE serving cells."""

from portbench.core import readers

LAYER = "serving entry: serve/throughput.py, serve/yolo_predict.py"
UNIT = "ms"
MOVES = "frames_per_s.dfine"
read = readers.host_ms
