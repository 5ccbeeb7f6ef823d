"""sinkhorn_roofline.geomatch (%): the sinkhorn kernel's bound at the configured patches over its device time, GeoTransformer serving."""

from portbench import geotransformer_work

NAME = "sinkhorn_roofline.geomatch"
UNIT = "%"


def read(run):
    return geotransformer_work.kernel_roofline_pct(run, "sinkhorn")
