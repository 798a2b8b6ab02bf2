"""Share of the traced window with the card idle while the host was inside
one of the port's top-level D-FINE serving spans, in the D-FINE cells."""

from portbench.core import spans

LAYER = "device"
UNIT = "%"
MOVES = "frames_per_s.dfine"


def read(rec):
    return spans.launch_idle_share(
        rec, ("dfine.prepatchify", "dfine.forward", "dfine.post_process"))
