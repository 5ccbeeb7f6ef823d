"""mfu.geomatch (%): required products of each request (portbench/geotransformer_work.py) over wall time over the dense peak."""

from portbench import geotransformer_work

NAME = "mfu.geomatch"
UNIT = "%"


def read(run):
    return geotransformer_work.mfu_pct(run)
